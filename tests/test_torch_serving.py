"""The port's serving path on the CPU: allocator, scheduler and sampler
units (mirroring ``tests/test_serving.py``), the engine's invariants, and
its token streams against the JAX package's ``Engine`` on the reduced
smollm-135m, llama3.2-1b and gemma2-2b with JAX's weights carried across.
gemma2's requests (``SPEC_LONG``) have prompts and positions past its
reduced window of 16, so its local layers mask in prefill and in decode.

Streams are compared token for token.  The logits of the two packages
differ by ~1e-6 (float32 sums in another order; ``test_torch_lm_parity``
holds them to 1e-5), so a token could flip where JAX's top two scores lie
closer than that.  Where a stream differs, the test fails unless it proves
such a near tie at the first differing token: both packages' logits there,
recomputed from the same tokens, agree to 1e-5 · max|logits|, and JAX's
top-2 margin is below that same tolerance.  The engine's per-step logits
are also held to JAX's directly: the port teacher-forced on the tokens
JAX's ``Engine`` emitted, step by step.  Seeded streams are compared with
JAX's own Gumbel noise injected into the port's sampler.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as j_reduced
from repro.models.lm import LM as JLM
from repro.serving.server import Engine as JEngine
from repro.serving.server import Request as JRequest
from repro_torch.configs import get_reduced_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import lm as tlm
from repro_torch.models.lm import LM
from repro_torch.serving import sampling
from repro_torch.serving.allocator import NULL_PAGE, PageAllocator
from repro_torch.serving.scheduler import ACTIVE, DONE, QUEUED, Scheduler
from repro_torch.serving.server import (Engine, PagedKVCache, Request,
                                        serial_engine)

TOL = 1e-5
# A decode step's new K/V rows, rounded to bf16 by each package from its
# own float32 values: entries one bf16 ulp apart per step, at most.  The
# requests below flip at most one entry in a step (llama3.2-1b once,
# gemma2-2b twice); a rounding mode other than round-to-nearest-even
# would flip about half of them.
MAX_FLIPS = 1
SPEC = [(0, 3, 4), (1, 6, 9), (2, 4, 2), (3, 8, 5), (4, 3, 7), (5, 6, 3),
        (6, 4, 6)]
SPEC_LONG = [(0, 18, 4), (1, 6, 14), (2, 20, 3), (3, 9, 9), (4, 17, 6),
             (5, 4, 5), (6, 12, 8)]
ARCHS = ["smollm-135m", "llama3.2-1b", "gemma2-2b"]


def _spec(arch):
    return SPEC_LONG if arch == "gemma2-2b" else SPEC


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jl = JLM(j_reduced(arch))
    jp = jl.init_params(jax.random.PRNGKey(0))
    tl = LM(get_reduced_config(arch), device="cpu")
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jl, jp, tl, tp


def _prompt(cfg, u, tp):
    return [(7 * u + j) % cfg.vocab_size for j in range(tp)]


def _reqs(cfg, spec, cls=Request, **kw):
    """spec: list of (uid, prompt_len, max_new)."""
    return [cls(uid=u, prompt=_prompt(cfg, u, tp), max_new=mn, **kw)
            for u, tp, mn in spec]


# ---------------------------------------------------------------------------
# allocator
# ---------------------------------------------------------------------------

def test_allocator_basics():
    a = PageAllocator(5)
    assert a.capacity == 4 and NULL_PAGE not in a.free_pages
    pages = a.alloc(4)
    assert sorted(pages) == [1, 2, 3, 4]
    assert a.alloc(1) is None and a.n_free == 0
    with pytest.raises(ValueError):
        a.free([NULL_PAGE])
    a.free(pages)
    with pytest.raises(ValueError):
        a.free([pages[0]])          # double free
    assert a.n_free == 4
    with pytest.raises(ValueError):
        PageAllocator(1)            # nothing allocatable beyond page 0


def test_allocator_fifo_reuse_and_eviction_count():
    a = PageAllocator(6)
    first = a.alloc(2)
    second = a.alloc(2)
    a.evict(first)
    assert a.n_evicted == 2
    assert a.free_pages == [5] + first   # freed pages go to the back
    with pytest.raises(ValueError):
        a.evict(first)
    a.free(second)
    assert a.held_pages == [] and a.n_free == a.capacity


@pytest.mark.parametrize("seed", range(4))
def test_allocator_never_double_assigns_or_leaks(seed):
    """Seeded alloc/free/evict interleavings: no page is in two live
    allocations, free + held partitions the capacity, the null page is
    never handed out, and the eviction count is exact."""
    rng = np.random.default_rng(seed)
    num_pages = int(rng.integers(2, 13))
    a, live, evicted = PageAllocator(num_pages), [], 0
    for _ in range(80):
        kind, n = int(rng.integers(3)), int(rng.integers(7))
        if kind == 0 or not live:
            got = a.alloc(n)
            if got is None:
                assert n > a.n_free
                continue
            assert len(got) == n and NULL_PAGE not in got
            live.append(got)
        elif kind == 1:
            a.free(live.pop(n % len(live)))
        else:
            pages = live.pop(n % len(live))
            a.evict(pages)
            evicted += len(pages)
        held = [p for pages in live for p in pages]
        assert len(held) == len(set(held))
        assert sorted(held + a.free_pages) == list(range(1, num_pages))
        assert a.n_evicted == evicted
    with pytest.raises(ValueError):
        a.evict([NULL_PAGE])


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

def test_scheduler_fifo_bind_release_and_preempt():
    s = Scheduler(2)
    reqs = [Request(uid=i, prompt=[1]) for i in range(4)]
    for r in reqs:
        s.submit(r)
    assert s.next_queued() is reqs[0] and s.free_slot() == 0
    s.bind(0, reqs[0])
    s.bind(1, reqs[1])
    assert s.free_slot() is None and s.active == [0, 1]
    assert reqs[0].state == ACTIVE and reqs[2].state == QUEUED
    reqs[1].out.extend([5, 6])
    victim = s.preempt(1)
    assert victim is reqs[1] and victim.out == [] and victim.preemptions == 1
    assert s.queued == [reqs[1], reqs[2], reqs[3]]   # front re-queue
    done = s.release(0)
    assert done.done and done.state == DONE and s.n_active == 0
    with pytest.raises(AssertionError):
        s.bind(0, reqs[3])          # only the queue head binds
    s.reject(reqs[3], "bad")
    assert reqs[3].error == "bad" and reqs[3].state == "failed"


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_sampling_filters_and_greedy():
    row = np.asarray([1.0, 3.0, 3.0, 2.0, -1.0])
    assert sampling.sample_token(row) == int(np.argmax(row)) == 1
    f = sampling.filter_logits(row, top_k=2)
    assert np.isfinite(f[[1, 2]]).all() and not np.isfinite(f[[0, 3, 4]]).any()
    f = sampling.filter_logits(np.asarray([10.0, 0.0, 0.0]), top_p=0.5)
    assert np.isfinite(f[0]) and not np.isfinite(f[1:]).any()
    f = sampling.filter_logits(np.asarray([0.0, 0.0]), top_p=1e-9)
    assert np.isfinite(f).sum() == 1
    row2 = np.random.RandomState(0).randn(32)
    a = [sampling.sample_token(row2, temperature=0.8, seed=5, index=i)
         for i in range(8)]
    assert a == [sampling.sample_token(row2, temperature=0.8, seed=5,
                                       index=i) for i in range(8)]
    assert a != [sampling.sample_token(row2, temperature=0.8, seed=6,
                                       index=i) for i in range(8)]


def test_filter_logits_matches_reference():
    from repro.serving.sampling import filter_logits as j_filter
    rng = np.random.default_rng(1)
    for _ in range(20):
        row = np.round(rng.standard_normal(40), 1)   # ties included
        for k, p in ((0, 1.0), (5, 1.0), (0, 0.7), (7, 0.9), (1, 0.3)):
            np.testing.assert_array_equal(
                sampling.filter_logits(row, top_k=k, top_p=p),
                j_filter(row, top_k=k, top_p=p))


def _jax_gumbel(seed, index, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), index)
    return np.asarray(jax.random.gumbel(key, (n,), jnp.float32))


def test_injected_jax_gumbel_reproduces_jax_categorical():
    """With JAX's Gumbel noise injected, the port's draw is the reference's
    ``sample_token`` (``jax.random.categorical``) token for token."""
    from repro.serving.sampling import sample_token as j_sample
    rng = np.random.default_rng(2)
    for i in range(40):
        row = rng.standard_normal(64).astype(np.float32) * 3
        kw = dict(temperature=0.7 + 0.01 * i, top_k=(0, 10)[i % 2],
                  top_p=(1.0, 0.9)[i % 3 == 0], seed=11 + i % 5, index=i)
        assert sampling.sample_token(row, gumbel=_jax_gumbel, **kw) == (
            j_sample(row, **kw))


def test_torch_gumbel_is_a_gumbel_source():
    a = sampling.torch_gumbel(3, 4, 100_000)
    assert a.dtype == np.float32 and np.array_equal(
        a, sampling.torch_gumbel(3, 4, 100_000))
    assert not np.array_equal(a, sampling.torch_gumbel(3, 5, 100_000))
    assert abs(a.mean() - np.euler_gamma) < 0.02          # Gumbel(0, 1)
    assert abs(a.var() - np.pi ** 2 / 6) < 0.05


# ---------------------------------------------------------------------------
# engine invariants (the port alone)
# ---------------------------------------------------------------------------

def _port(arch):
    _, _, tl, tp = _pair(arch)
    return tl, tp, tl.cfg


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_matches_serial_token_for_token(arch):
    tl, tp, cfg = _port(arch)
    spec = _spec(arch)
    eng = Engine(tl, tp, batch_slots=3, max_len=32)
    batched = _reqs(cfg, spec)
    rep = eng.run(batched)
    assert all(r.done for r in batched)
    assert rep.steps < sum(mn for _, _, mn in spec)   # actually batched
    serial = _reqs(cfg, spec)
    serial_engine(tl, tp, max_len=32).run(serial)
    for b, s in zip(batched, serial):
        assert b.out == s.out, (arch, b.uid, b.out, s.out)


def test_batched_matches_serial_under_eviction_pressure():
    tl, tp, cfg = _port("smollm-135m")
    spec = SPEC[:5]
    tight = Engine(tl, tp, batch_slots=3, max_len=32, page_size=4,
                   num_pages=7)
    pressured = _reqs(cfg, spec)
    rep = tight.run(pressured, max_steps=500)
    assert all(r.done for r in pressured)
    assert rep.preemptions > 0 and rep.evictions > 0
    assert tight.alloc.n_evicted == rep.evictions
    assert any(r.preemptions > 0 for r in pressured)
    serial = _reqs(cfg, spec)
    serial_engine(tl, tp, max_len=32, page_size=4).run(serial)
    for a, b in zip(pressured, serial):
        assert a.out == b.out, (a.uid, a.preemptions, a.out, b.out)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_route_is_default_and_matches_gather(arch):
    tl, tp, cfg = _port(arch)
    eng = Engine(tl, tp, batch_slots=3, max_len=32)
    assert eng.decode_route == "paged"
    paged = _reqs(cfg, _spec(arch)[:5])
    rep_p = eng.run(paged)
    gather = _reqs(cfg, _spec(arch)[:5])
    rep_g = Engine(tl, tp, batch_slots=3, max_len=32,
                   decode_route="gather").run(gather)
    assert rep_p.decode_steps == rep_g.decode_steps > 0
    for a, b in zip(paged, gather):
        assert a.out == b.out, (a.uid, a.out, b.out)


def test_refill_does_not_disturb_active_slots():
    tl, tp, cfg = _port("smollm-135m")
    disturbed = _reqs(cfg, [(0, 3, 2), (1, 4, 10), (2, 5, 4)])
    rep = Engine(tl, tp, batch_slots=2, max_len=32).run(disturbed)
    assert all(r.done for r in disturbed) and rep.steps > 2
    undisturbed = _reqs(cfg, [(0, 3, 2), (1, 4, 10)])
    Engine(tl, tp, batch_slots=2, max_len=32).run(undisturbed)
    assert disturbed[1].out == undisturbed[1].out
    assert disturbed[0].out == undisturbed[0].out


def test_termination_uses_full_cache_and_max_steps_reports():
    tl, tp, cfg = _port("smollm-135m")
    eng = Engine(tl, tp, batch_slots=1, max_len=8)
    reqs = _reqs(cfg, [(0, 5, 100)])
    eng.run(reqs)
    assert reqs[0].done and len(reqs[0].out) == 8 - 5 + 1
    eng2 = Engine(tl, tp, batch_slots=1, max_len=32)
    pending = _reqs(cfg, [(0, 3, 10), (1, 3, 10)])
    rep = eng2.run(pending, max_steps=3)
    assert rep.truncated and [r.uid for r in rep.unfinished] == [0]
    assert [r.uid for r in rep.unserved] == [1]


def test_submit_rejects_invalid_requests():
    tl, tp, cfg = _port("smollm-135m")
    eng = Engine(tl, tp, batch_slots=1, max_len=16, page_size=4,
                 num_pages=3)
    empty = Request(uid=0, prompt=[])
    long = Request(uid=1, prompt=[1] * 17)
    huge = Request(uid=2, prompt=[1] * 4, max_new=12)   # needs 4 pages > 2
    for r in (empty, long, huge):
        assert not eng.submit(r) and r.error and r.state == "failed"
    rep = eng.run([])
    assert rep.failed == [empty, long, huge] and eng.n_rejected == 3


def test_admission_reserves_prompt_pages_only():
    tl, tp, cfg = _port("smollm-135m")
    eng = Engine(tl, tp, batch_slots=2, max_len=16, page_size=4,
                 num_pages=6)
    reqs = _reqs(cfg, [(0, 4, 12), (1, 4, 12)])
    for r in reqs:
        assert eng.submit(r)
    eng.step_once()
    assert eng.sched.n_active == 2
    eng.run([], max_steps=500)
    assert all(r.done for r in reqs)


def test_page_reuse_fully_overwritten_before_attended():
    """Free pages are poisoned between requests; a reused page attended
    before being fully overwritten would change the tokens."""
    tl, tp, cfg = _port("smollm-135m")
    eng = Engine(tl, tp, batch_slots=1, max_len=16, page_size=4)
    first = _reqs(cfg, [(0, 6, 5)])
    eng.run(first)
    free = torch.as_tensor(eng.alloc.free_pages + [NULL_PAGE])
    for p in eng.pools.values():
        for kv in ("k", "v"):
            p[kv][:, free] = 7777.0
    second = _reqs(cfg, [(1, 5, 6)])
    eng.run(second)
    clean = _reqs(cfg, [(1, 5, 6)])
    Engine(tl, tp, batch_slots=1, max_len=16, page_size=4).run(clean)
    assert second[0].out == clean[0].out


def test_cache_pools_zero_bf16_and_unsupported_arch_rejected():
    tl, tp, cfg = _port("llama3.2-1b")
    eng = Engine(tl, tp, batch_slots=2, max_len=16)
    for pool in eng.cache.values():
        for leaf in pool.values():
            assert leaf.dtype == torch.bfloat16
            assert leaf.shape == (tl.n_groups, eng.kv.num_pages, 8,
                                  cfg.n_kv_heads, cfg.hd)
            assert float(leaf.abs().max()) == 0.0

    def model(kinds):
        class Model:
            cfg = get_reduced_config("smollm-135m")
            pattern = [type("S", (), {"attn": kind, "cross": False})()
                       for kind in kinds]
            n_groups = 1
        return Model

    for kind in ("mamba", "rwkv"):    # no attention cache: not served
        with pytest.raises(NotImplementedError):
            PagedKVCache(model(["global", kind]), batch_slots=1, max_len=16)
    # sliding-window layers share the pools, as in the reference
    kv = PagedKVCache(model(["local", "global"]), batch_slots=1, max_len=16)
    assert kv.layer_names == ["pos0", "pos1"]


def test_seeded_streams_independent_of_batch_composition():
    tl, tp, cfg = _port("smollm-135m")
    spec = [(0, 4, 6), (1, 6, 6), (2, 4, 5)]
    kw = dict(temperature=0.9, top_k=20, top_p=0.95)
    batched = [Request(uid=u, prompt=_prompt(cfg, u, t), max_new=m,
                       seed=100 + u, **kw) for u, t, m in spec]
    Engine(tl, tp, batch_slots=3, max_len=32).run(batched)
    for (u, t, m), b in zip(spec, batched):
        solo = [Request(uid=u, prompt=_prompt(cfg, u, t), max_new=m,
                        seed=100 + u, **kw)]
        serial_engine(tl, tp, max_len=32).run(solo)
        assert b.done and b.out == solo[0].out, (u, b.out, solo[0].out)


# ---------------------------------------------------------------------------
# the port's streams against JAX's Engine
# ---------------------------------------------------------------------------

def _scores(lm_logits, req, index, gumbel):
    """The scores the sampler maximizes at ``index``: the logits (greedy),
    or filtered logits / T plus the Gumbel draw (seeded)."""
    row = np.asarray(lm_logits, np.float64)
    if req.temperature <= 0:
        return row
    f = sampling.filter_logits(row / req.temperature, top_k=req.top_k,
                               top_p=req.top_p)
    return (gumbel(req.seed, index, row.size).astype(np.float32)
            + f.astype(np.float32)).astype(np.float64)


def _assert_streams_agree(arch, jreqs, treqs, gumbel=None):
    jl, jp, tl, tp = _pair(arch)
    for jr, tr in zip(jreqs, treqs):
        assert jr.done and tr.done, (jr.uid, jr.state, tr.state)
        if jr.out == tr.out:
            continue
        i = next(n for n, (a, b) in enumerate(zip(jr.out, tr.out)) if a != b)
        toks = np.asarray([jr.prompt + jr.out[:i]], np.int32)
        jlog = np.asarray(jl.prefill(jp, {"tokens": jnp.asarray(toks)})[0])
        tlog = tl.prefill(tp, {"tokens": torch.from_numpy(toks)})[0].numpy()
        scale = np.abs(jlog).max()
        assert np.abs(tlog - jlog).max() <= TOL * scale, (
            "logits disagree before the differing token", arch, jr.uid, i)
        s = np.sort(_scores(jlog[0, -1], jr, i, gumbel))[-2:]
        margin = s[1] - s[0]
        assert margin < TOL * scale, (
            "token differs away from a near tie", arch, jr.uid, i, margin)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_match_jax_engine(arch):
    jl, jp, tl, tp = _pair(arch)
    jreqs = _reqs(jl.cfg, _spec(arch), cls=JRequest)
    JEngine(jl, jp, batch_slots=3, max_len=32).run(jreqs)
    treqs = _reqs(tl.cfg, _spec(arch))
    Engine(tl, tp, batch_slots=3, max_len=32).run(treqs)
    _assert_streams_agree(arch, jreqs, treqs)


def test_greedy_streams_match_jax_engine_under_eviction():
    arch = "llama3.2-1b"
    jl, jp, tl, tp = _pair(arch)
    kw = dict(batch_slots=3, max_len=32, page_size=4, num_pages=7)
    jreqs = _reqs(jl.cfg, SPEC[:5], cls=JRequest)
    jrep = JEngine(jl, jp, **kw).run(jreqs, max_steps=500)
    treqs = _reqs(tl.cfg, SPEC[:5])
    trep = Engine(tl, tp, **kw).run(treqs, max_steps=500)
    assert trep.preemptions == jrep.preemptions > 0
    assert trep.evictions == jrep.evictions
    _assert_streams_agree(arch, jreqs, treqs)


def test_gemma2_streams_match_jax_engine_under_eviction():
    """gemma2's long requests through 12 pages of 4: preemption replays
    prompts past the window."""
    arch = "gemma2-2b"
    jl, jp, tl, tp = _pair(arch)
    kw = dict(batch_slots=3, max_len=32, page_size=4, num_pages=13)
    jreqs = _reqs(jl.cfg, SPEC_LONG[:5], cls=JRequest)
    jrep = JEngine(jl, jp, **kw).run(jreqs, max_steps=500)
    treqs = _reqs(tl.cfg, SPEC_LONG[:5])
    trep = Engine(tl, tp, **kw).run(treqs, max_steps=500)
    assert trep.preemptions == jrep.preemptions > 0
    assert trep.evictions == jrep.evictions
    _assert_streams_agree(arch, jreqs, treqs)


def test_seeded_streams_match_jax_with_its_gumbel_injected():
    arch = "smollm-135m"
    jl, jp, tl, tp = _pair(arch)
    kw = dict(temperature=0.9, top_k=20, top_p=0.95)
    spec = [(0, 4, 6), (1, 6, 6), (2, 4, 5), (3, 5, 4)]
    jreqs = [JRequest(uid=u, prompt=_prompt(jl.cfg, u, t), max_new=m,
                      seed=100 + u, **kw) for u, t, m in spec]
    JEngine(jl, jp, batch_slots=2, max_len=32).run(jreqs)
    treqs = [Request(uid=u, prompt=_prompt(tl.cfg, u, t), max_new=m,
                     seed=100 + u, **kw) for u, t, m in spec]
    Engine(tl, tp, batch_slots=2, max_len=32, gumbel=_jax_gumbel).run(treqs)
    _assert_streams_agree(arch, jreqs, treqs, gumbel=_jax_gumbel)


def _bf16_pools(pools):
    return {name: {kv: torch.from_numpy(x).to(torch.bfloat16)
                   for kv, x in c.items()} for name, c in pools.items()}


def _one_ulp_flips(got, want) -> int:
    """Pools each side wrote itself: every entry equal, or one bf16 ulp
    apart (the two packages' float32 K/V rounded the other way).  Returns
    the number of entries that differ."""
    flips = 0
    for name in want:
        for kv in ("k", "v"):
            a = got[name][kv].float().numpy()
            b = np.asarray(want[name][kv], np.float32)
            mag = np.maximum(np.abs(a), np.abs(b))
            diff = np.abs(a - b)
            ulp = 2.0 ** (np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
            assert (diff <= ulp).all(), (name, kv, float(diff.max()))
            flips += int((diff > 0).sum())
    return flips


def _attend_given_pools(monkeypatch, teng, pools, page_table):
    """Make each decode kernel call of the port's next step read ``pools``
    (JAX's pools after its step) instead of the rows the port wrote: the
    calls go layer by layer, group g then pattern position i."""
    period = teng.model.period
    dense = teng.kv.gather(pools, page_table)
    count = iter(range(10 ** 6))

    def patch(name, src):
        real = getattr(tlm, name)

        def kernel(q, k, v, *args, **kw):
            g, i = divmod(next(count), period)
            leaf = src[f"pos{i}"]
            if name == "flash_decode":        # (B, Hkv, S, hd) views
                k.copy_(leaf["k"][g].transpose(1, 2))
                v.copy_(leaf["v"][g].transpose(1, 2))
            else:
                k.copy_(leaf["k"][g])
                v.copy_(leaf["v"][g])
            return real(q, k, v, *args, **kw)

        monkeypatch.setattr(tlm, name, kernel)

    patch("flash_decode_paged", pools)
    patch("flash_decode", dense)


@pytest.mark.parametrize("route", ["paged", "gather"])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_logits_teacher_forced_on_jax_engine_tokens(arch, route,
                                                         monkeypatch):
    """Every prefill call and decode step of JAX's ``Engine`` serving its
    requests, replayed by the port on JAX's inputs: the prompts it
    prefilled, and for each decode step its tokens, positions, page table
    and bf16 pools (one shared cache per step: the two packages' float32
    K/V may round to bf16 differently, so caches each side wrote itself are
    not compared).  The port's logits rows within 1e-5 · max|logits| of
    JAX's.  The step's own new K/V row is still rounded by each side: where
    the pools the two steps wrote differ, at most ``MAX_FLIPS`` entries may,
    each one bf16 ulp apart, and the port's step is held to JAX's logits
    with its kernels reading JAX's written pools (a flip moves reduced
    gemma2's logits by ~4e-5 of their scale)."""
    jl, jp, tl, tp = _pair(arch)
    kw = dict(batch_slots=3, max_len=32, decode_route=route)
    jeng = JEngine(jl, jp, **kw)
    calls = []
    j_step, j_prefill = jeng._step, jeng._prefill

    def step(params, pools, page_table, pos, toks):
        # copies now: the engine updates its numpy state in place
        inputs = [np.array(a) for a in (page_table, pos, toks)]
        f32 = lambda tree: jax.tree.map(lambda x: np.array(x, np.float32),
                                        tree)
        before = f32(pools)
        logits, pools = j_step(params, pools, page_table, pos, toks)
        calls.append(("decode", before, f32(pools), *inputs,
                      np.array(logits)))
        return logits, pools

    def prefill(params, feed):
        logits, cache = j_prefill(params, feed)
        calls.append(("prefill", np.array(feed["tokens"]), np.array(logits)))
        return logits, cache

    jeng._step, jeng._prefill = step, prefill
    jreqs = _reqs(jl.cfg, _spec(arch), cls=JRequest)
    jeng.run(jreqs)
    assert all(r.done for r in jreqs)
    assert {c[0] for c in calls} == {"prefill", "decode"}
    teng = Engine(tl, tp, **kw)
    for kind, *inputs, want in calls:
        if kind == "prefill":
            got = tl.prefill(tp, {"tokens": torch.from_numpy(inputs[0])})[0]
        else:
            before, after, page_table, pos, toks = inputs
            args = [torch.from_numpy(x) for x in (page_table, pos, toks)]
            teng.pools = _bf16_pools(before)
            got = teng._decode(*args)
            flips = _one_ulp_flips(teng.pools, after)
            assert flips <= MAX_FLIPS, (kind, flips)
            if flips:
                with monkeypatch.context() as m:
                    _attend_given_pools(m, teng, _bf16_pools(after), args[0])
                    teng.pools = _bf16_pools(before)
                    got = teng._decode(*args)
        got = got.numpy()
        assert got.shape == want.shape, (kind, got.shape, want.shape)
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        assert np.isfinite(err) and err <= TOL * scale, (kind, err, scale)


def test_whisper_serving_refused():
    """Serving the encoder-decoder waits for its slice (the port trains
    whisper): the engine refuses it when it builds its pools."""
    cfg = get_reduced_config("whisper-small")
    tl = LM(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder"):
        Engine(tl, tl.init_params(), batch_slots=1, max_len=16)
