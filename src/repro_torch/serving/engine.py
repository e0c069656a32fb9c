"""Continuous-batching inference engine over a paged KV cache (mirrors
``repro/serving/engine.py``).

Per step, every *active* slot decodes one token at its own position
(``decode_step`` takes the ``(B,)`` position vector to the decode kernel's
per-row lengths); finished slots free their pages and the queue refills
them in flight, without touching any other slot's cache.

Decode routes (``decode_route``):

* ``"paged"`` (default) — the page table rides into ``LM.decode_step``:
  each attention layer writes its one new K/V row into the slot's physical
  page and ``kernels.flash_decode_paged`` attends the pool through the
  table, in the kernel.  No dense view is built.
* ``"gather"`` — the oracle: gather pages into the dense view, decode
  against it (``kernels.flash_decode``), scatter the one new row back.
  Kept for differential testing, not as a serving configuration.

Admission and memory pressure: a request is admitted with only its prompt
pages (``blocks_for(prompt_len)``).  Decode growth allocates one page on
demand whenever a slot's next position crosses a page boundary; if the
pool is exhausted the engine preempts the youngest active request
(possibly the requester itself), evicts its pages and re-queues it at the
queue front.  Victims recompute from scratch on re-admission — greedy
decoding and the seeded sampler are pure functions of (request, token
index), so the re-run reproduces the identical stream.  ``submit`` rejects
requests whose worst-case footprint exceeds the total capacity, so the
oldest active request can always make progress.

Prefill is batched: the requests admitted in one step are grouped by exact
prompt length and prefilled in one forward per group, the batch padded to
a power-of-two bucket with duplicate rows (the reference does so to bound
its jit cache; the port keeps the same batches so that the two engines
compute the same rows).  Each row is then written into its own slot's
pages.

Termination: a cache of ``max_len`` yields exactly ``max_len`` usable
positions — a prompt of ``Tp`` tokens can emit up to ``max_len - Tp + 1``
tokens.  ``run`` reports, never drops, requests still in flight or queued
when ``max_steps`` is hit.

The slot-serial reference engine (``serial_engine``) runs the identical
compute path one request at a time; under greedy decoding the batched
engine must match it token for token, also under eviction pressure.

Not ported yet: the Laplace uncertainty head (``laplace=``) and the
``repro.obs`` telemetry.  The counters ``RunReport`` needs are plain ints;
the latency fields come from the host clock (``time.perf_counter``): TTFT
from submission to first token, and the time of each prefill call and of
each batched decode step, both of which end in the host copy of their
logits and so include the device's work.  Each step copies its ``(B, vocab)`` float32 logits to the host for
sampling, as the reference does.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving import sampling
from repro_torch.serving.allocator import PageAllocator
from repro_torch.serving.cache import PagedKVCache
from repro_torch.serving.scheduler import Request, Scheduler

DECODE_ROUTES = ("paged", "gather")


def _pct(xs, q):
    return float(np.percentile(xs, q)) if xs else None


@dataclass
class RunReport:
    """What ``Engine.run`` did.  ``unfinished`` (in flight) and
    ``unserved`` (never admitted) are non-empty only when ``max_steps`` cut
    the run short.  ``preemptions`` and ``evictions`` are this run's
    counts.  ``decode_steps`` counts batched decode forwards (each runs
    every attention layer once), ``decode_step_ms`` their host-clock
    times and ``prefill_ms`` those of the prefill calls (one per group of
    equal prompt length); ``ttft_*`` is submission to first token,
    ``decode_*`` the gap between a request's consecutive tokens
    (milliseconds, None when empty)."""
    steps: int = 0
    completed: List[Request] = field(default_factory=list)
    unfinished: List[Request] = field(default_factory=list)
    unserved: List[Request] = field(default_factory=list)
    failed: List[Request] = field(default_factory=list)
    preemptions: int = 0
    evictions: int = 0                # pages evicted under pressure
    decode_steps: int = 0
    decode_step_ms: List[float] = field(default_factory=list)
    prefill_ms: List[float] = field(default_factory=list)
    ttft_p50_ms: Optional[float] = None
    ttft_p99_ms: Optional[float] = None
    decode_p50_ms: Optional[float] = None
    decode_p99_ms: Optional[float] = None

    @property
    def truncated(self) -> bool:
        return bool(self.unfinished or self.unserved)


class Engine:
    """Continuous-batching engine: FIFO admission into ``batch_slots``
    in-flight rows, paged KV cache with free-list reuse and
    eviction/preemption under pressure, grouped batched prefill, and paged
    decode steps.  It runs on the model's device.  ``gumbel`` is the noise
    source of seeded sampling (``serving/sampling.py``)."""

    def __init__(self, model, params, *, batch_slots: int, max_len: int,
                 page_size: int = 8, num_pages: int = None,
                 decode_route: str = "paged",
                 gumbel: sampling.GumbelSource = sampling.torch_gumbel):
        if decode_route not in DECODE_ROUTES:
            raise ValueError(f"decode_route={decode_route!r} not in "
                             f"{DECODE_ROUTES}")
        self.model = model
        self.params = params
        self.device = model.device
        self.b = batch_slots
        self.max_len = max_len
        self.decode_route = decode_route
        self.gumbel = gumbel
        self.kv = PagedKVCache(model, batch_slots=batch_slots,
                               max_len=max_len, page_size=page_size,
                               num_pages=num_pages)
        self.alloc = PageAllocator(self.kv.num_pages)
        self.sched = Scheduler(batch_slots)
        self.pools = self.kv.init_pools()
        self.pos = np.zeros(batch_slots, np.int32)       # per-slot next pos
        self.page_table = np.zeros((batch_slots, self.kv.max_blocks),
                                   np.int32)
        self.last_tok = np.zeros((batch_slots, 1), np.int32)
        self.slot_pages: List[List[int]] = [[] for _ in range(batch_slots)]
        self.slot_seq = np.zeros(batch_slots, np.int64)  # admission order
        self._seq = 0
        self.rng = torch.Generator().manual_seed(0)
        self._failed: List[Request] = []
        # plain-int counters (the reference keeps them in repro.obs)
        self.n_decode_steps = 0
        self.n_rejected = 0
        self.n_preemptions = 0
        self.n_evicted = 0
        self.n_sampled = {"greedy": 0, "seeded": 0, "shared_rng": 0}
        self._reset_latency()

    # ------------------------------------------------------------------
    @property
    def cache(self):
        """The paged KV pools (zero at construction)."""
        return self.pools

    def _reset_latency(self) -> None:
        self._t_submit, self._t_last = {}, {}
        self._ttft, self._gaps = [], []
        self._step_ms, self._prefill_ms = [], []

    # ------------------------------------------------------------------
    def _device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _decode(self, page_table, pos, toks):
        """One batched decode step on the engine's route; returns the
        last-position logits (B, vocab)."""
        if self.decode_route == "paged":
            logits, self.pools = self.model.decode_step(
                self.params, self.pools, toks, pos, page_table=page_table)
        else:
            dense = self.kv.gather(self.pools, page_table)
            logits, dense = self.model.decode_step(self.params, dense, toks,
                                                   pos)
            self.pools = self.kv.scatter_token(self.pools, dense, page_table,
                                               pos)
        return logits[:, -1]

    def _sample(self, req: Request, logits_row) -> int:
        """One token for ``req``: greedy argmax; a seeded request draws
        token ``len(req.out)`` of its own stream; an unseeded stochastic
        request draws from the engine-shared generator (seed 0)."""
        if req.temperature <= 0:
            self.n_sampled["greedy"] += 1
            return int(np.argmax(logits_row))
        if req.seed is None:
            self.n_sampled["shared_rng"] += 1
            row = np.asarray(logits_row, np.float32) / req.temperature
            noise = sampling.gumbel_from_generator(self.rng, row.size)
            return sampling.gumbel_argmax(row, noise)
        self.n_sampled["seeded"] += 1
        return sampling.sample_token(
            logits_row, temperature=req.temperature, top_k=req.top_k,
            top_p=req.top_p, seed=req.seed, index=len(req.out),
            gumbel=self.gumbel)

    def _emit(self, req: Request, tok: int, ems) -> None:
        req.out.append(tok)
        now = time.perf_counter()
        last = self._t_last.get(req.uid)
        if last is None:
            self._ttft.append((now - self._t_submit.get(req.uid, now)) * 1e3)
        else:
            self._gaps.append((now - last) * 1e3)
        self._t_last[req.uid] = now
        ems.append((req, tok))

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Queue a request; invalid ones are rejected with ``req.error``
        set (returned ``False``).  The capacity check is against the total
        pool (a request must be able to run alone) — admission itself
        reserves only prompt pages."""
        tp = len(req.prompt)
        if tp == 0:
            self.sched.reject(req, "empty prompt")
        elif tp > self.max_len:
            self.sched.reject(
                req, f"prompt length {tp} exceeds cache max_len "
                     f"{self.max_len}")
        elif (self.kv.blocks_for(min(tp + req.max_new - 1, self.max_len))
              > self.alloc.capacity):
            self.sched.reject(
                req, "page reservation exceeds total cache capacity")
        else:
            self.sched.submit(req)
            self._t_submit[req.uid] = time.perf_counter()
            return True
        self.n_rejected += 1
        self._failed.append(req)
        return False

    def _finish(self, slot: int) -> None:
        self.sched.release(slot, done=True)
        self.alloc.free(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.page_table[slot] = 0     # back to the null page
        self.pos[slot] = 0
        self.last_tok[slot] = 0

    def _maybe_finish(self, slot: int) -> None:
        req = self.sched.slots[slot]
        # pos == max_len -> no room to write the last sampled token's KV
        if len(req.out) >= req.max_new or self.pos[slot] >= self.max_len:
            self._finish(slot)

    def _preempt(self, slot: int) -> None:
        """Evict ``slot``'s request: pages back to the free list, request
        to the queue front, emitted tokens discarded."""
        self.sched.preempt(slot)
        self.n_preemptions += 1
        self.n_evicted += len(self.slot_pages[slot])
        self.alloc.evict(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.page_table[slot] = 0
        self.pos[slot] = 0
        self.last_tok[slot] = 0

    def _grow(self) -> None:
        """Page on demand: before the decode step, every active slot must
        own the page backing the position it is about to write.  Oldest
        slots grow first; under exhaustion the youngest active request is
        preempted (possibly the requester itself)."""
        order = sorted(self.sched.active, key=lambda s: self.slot_seq[s])
        for slot in order:
            while (self.sched.slots[slot] is not None
                   and len(self.slot_pages[slot])
                   < self.kv.blocks_for(int(self.pos[slot]) + 1)):
                got = self.alloc.alloc(1)
                if got is not None:
                    self.page_table[slot, len(self.slot_pages[slot])] = got[0]
                    self.slot_pages[slot].append(got[0])
                    continue
                victim = max(self.sched.active,
                             key=lambda s: self.slot_seq[s])
                self._preempt(victim)
                if victim == slot:
                    break             # self-preempted: sit out this step

    def _admit(self, ems) -> None:
        """Fill free slots from the queue (strict FIFO), then prefill all
        admissions of this step in batched groups of equal prompt length;
        each emits its first token from its prefill logits row."""
        admitted: List[Tuple[Request, int]] = []
        while True:
            req = self.sched.next_queued()
            if req is None:
                break
            slot = self.sched.free_slot()
            if slot is None:
                break
            pages = self.alloc.alloc(self.kv.blocks_for(len(req.prompt)))
            if pages is None:        # wait for active slots to free pages
                break
            self.sched.bind(slot, req)
            self._seq += 1
            self.slot_seq[slot] = self._seq
            self.slot_pages[slot] = pages
            self.page_table[slot] = 0
            self.page_table[slot, :len(pages)] = pages
            admitted.append((req, slot))

        by_len = {}
        for req, slot in admitted:
            by_len.setdefault(len(req.prompt), []).append((req, slot))
        for tp in sorted(by_len):
            group = by_len[tp]
            bucket = 1                # pad to a power of two
            while bucket < len(group):
                bucket *= 2
            toks = [r.prompt for r, _ in group]
            toks += [toks[0]] * (bucket - len(group))   # rows discarded
            feed = {"tokens": self._device(np.asarray(toks, np.int32))}
            t0 = time.perf_counter()
            logits, cache = self.model.prefill(self.params, feed)
            logits = logits.cpu().numpy()
            self._prefill_ms.append((time.perf_counter() - t0) * 1e3)
            for row, (req, slot) in enumerate(group):
                self.pools = self.kv.write_prefill(
                    self.pools, self.slot_pages[slot], cache, tp, row=row)
                self.pos[slot] = tp
                tok = self._sample(req, logits[row, -1])
                self.last_tok[slot, 0] = tok
                self._emit(req, tok, ems)
                self._maybe_finish(slot)

    def step_once(self) -> List[Tuple[Request, int]]:
        """Admit what fits, grow pages (evicting under pressure), then run
        one batched decode step.  Returns the ``(request, token)``
        emissions of this call."""
        ems: List[Tuple[Request, int]] = []
        self._admit(ems)
        self._grow()
        active = self.sched.active
        if not active:
            return ems
        t0 = time.perf_counter()
        logits = self._decode(self._device(self.page_table),
                              self._device(self.pos),
                              self._device(self.last_tok))
        logits = logits.cpu().numpy()            # (B, vocab) float32
        self._step_ms.append((time.perf_counter() - t0) * 1e3)
        self.n_decode_steps += 1
        for s in active:
            self.pos[s] += 1                     # each wrote its last token
        for s in active:
            req = self.sched.slots[s]
            tok = self._sample(req, logits[s])
            self.last_tok[s, 0] = tok
            self._emit(req, tok, ems)
            self._maybe_finish(s)
        return ems

    # ------------------------------------------------------------------
    def run(self, requests: List[Request], max_steps: int = 1000
            ) -> RunReport:
        """Serve ``requests`` to completion (or ``max_steps``).  The report
        lists completed, in-flight-unfinished, never-admitted and rejected
        requests — nothing is silently dropped."""
        p0, e0, d0 = self.n_preemptions, self.n_evicted, self.n_decode_steps
        self._reset_latency()
        for r in requests:
            self.submit(r)
        steps = 0
        while self.sched.n_active or self.sched.queue:
            if steps >= max_steps:
                break
            self.step_once()
            steps += 1
        report = RunReport(
            steps=steps,
            completed=[r for r in requests if r.done],
            unfinished=[self.sched.slots[s] for s in self.sched.active],
            unserved=self.sched.queued,
            failed=list(self._failed),
            preemptions=self.n_preemptions - p0,
            evictions=self.n_evicted - e0,
            decode_steps=self.n_decode_steps - d0,
            decode_step_ms=list(self._step_ms),
            prefill_ms=list(self._prefill_ms),
            ttft_p50_ms=_pct(self._ttft, 50), ttft_p99_ms=_pct(self._ttft, 99),
            decode_p50_ms=_pct(self._gaps, 50),
            decode_p99_ms=_pct(self._gaps, 99))
        if report.truncated:
            print(f"[serve] max_steps={max_steps} hit: "
                  f"{len(report.unfinished)} in flight, "
                  f"{len(report.unserved)} still queued "
                  f"(uids {[r.uid for r in report.unfinished + report.unserved]})")
        return report


def serial_engine(model, params, *, max_len: int, page_size: int = 8,
                  decode_route: str = "paged",
                  gumbel: sampling.GumbelSource = sampling.torch_gumbel
                  ) -> Engine:
    """The slot-serial reference: one slot, so requests are served strictly
    one at a time through the identical compute path."""
    return Engine(model, params, batch_slots=1, max_len=max_len,
                  page_size=page_size, decode_route=decode_route,
                  gumbel=gumbel)
