"""Request model + slot scheduler for the continuous-batching engine (a copy
of ``repro/serving/scheduler.py``, which is pure Python, without the
Laplace-uncertainty fields, whose slice has not been ported).

Request lifecycle::

    QUEUED --admit--> ACTIVE --finish--> DONE
    QUEUED --reject (invalid / exceeds cache capacity)--> FAILED
    ACTIVE --preempt (page pressure)--> QUEUED (front; out cleared)

Admission is strict FIFO: the head of the queue is admitted as soon as a
batch slot is free *and* the allocator covers its *prompt* pages
(``blocks_for(prompt_len)`` — no worst-case ``max_new`` reservation; decode
growth allocates pages on demand and preempts a victim under pressure).
No head-of-line bypass keeps the schedule deterministic, which is what
lets the batched engine be compared token-for-token against the
slot-serial reference.

Preemption re-queues the victim at the *front* of the queue.  Every queued
request was submitted after every active one (actives were admitted from
the queue head), and victims are chosen youngest-first, so front re-queue
restores the global FIFO order exactly.  The victim's generated tokens are
discarded and recomputed from scratch on re-admission — greedy decoding
and the seeded sampler are both pure functions of (request, token index),
so the re-run reproduces the identical stream.

Sampling parameters ride on the request: ``temperature`` / ``top_k`` /
``top_p`` / ``seed`` (see ``serving/sampling.py`` for the determinism
contract).

The scheduler is pure bookkeeping (queue + slot binding + states); the
engine owns all compute and cache state.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

QUEUED, ACTIVE, DONE, FAILED = "queued", "active", "done", "failed"


@dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new: int = 16
    temperature: float = 0.0
    top_k: int = 0                 # 0 = no top-k filter
    top_p: float = 1.0             # 1.0 = no nucleus filter
    seed: Optional[int] = None     # None = legacy engine-shared RNG
    out: List[int] = field(default_factory=list)
    done: bool = False
    error: Optional[str] = None
    state: str = QUEUED
    preemptions: int = 0           # times evicted + re-queued mid-decode


class Scheduler:
    """FIFO queue + slot table.  ``admissible``/``bind``/``release`` are the
    only mutations; the engine polls ``next_queued`` each step."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.queue: deque = deque()
        self.slots: List[Optional[Request]] = [None] * n_slots

    def submit(self, req: Request) -> None:
        req.state = QUEUED
        self.queue.append(req)

    def reject(self, req: Request, reason: str) -> None:
        req.state = FAILED
        req.error = reason
        req.done = False

    def next_queued(self) -> Optional[Request]:
        return self.queue[0] if self.queue else None

    def free_slot(self) -> Optional[int]:
        for s, r in enumerate(self.slots):
            if r is None:
                return s
        return None

    def bind(self, slot: int, req: Request) -> None:
        assert self.slots[slot] is None and req is self.queue[0]
        self.queue.popleft()
        req.state = ACTIVE
        self.slots[slot] = req

    def release(self, slot: int, *, done: bool = True) -> Request:
        req = self.slots[slot]
        assert req is not None
        self.slots[slot] = None
        req.state = DONE if done else QUEUED
        req.done = done
        return req

    def preempt(self, slot: int) -> Request:
        """Evict the request in ``slot`` back to the *front* of the queue
        (FIFO-preserving: every queued request is younger than any active
        one).  Its emitted tokens are discarded — the re-run recomputes the
        identical stream from scratch."""
        req = self.release(slot, done=False)
        req.out.clear()
        req.preemptions += 1
        self.queue.appendleft(req)
        return req

    @property
    def active(self) -> List[int]:
        return [s for s, r in enumerate(self.slots) if r is not None]

    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def queued(self) -> List[Request]:
        return list(self.queue)
