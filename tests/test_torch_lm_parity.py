"""The port's LM against the JAX package's ``LM``, on the reduced
smollm-135m, llama3.2-1b and gemma2-2b (local layers with a window of 16 on
even pattern positions, attention softcap 50, logit softcap 30), with JAX's
``LM.init_params`` carried across by
``repro_torch.convert.lm_params_from_numpy``; and the prefill ``attention``
(the plain version of ``kernels.flash_attention`` on the CPU, with a window
and a softcap) against the reference's ``models.layers.attention``.

Tolerances (float32 weights and activations, sums in another order):
* logits: max|port − JAX| ≤ 1e-5 · max|JAX| over the batch (normwise;
  logits near zero make an elementwise relative bound meaningless);
* caches: the bf16 roundings of the two float32 caches lie within one bf16
  ulp of each other, entry by entry — the ulp of the entry, or of
  2⁻¹²·max|cache| for entries below that (their float32 values differ by
  about 1e-6, more than a bf16 ulp of a value near zero).

Decode runs from one shared bf16 cache (JAX's prefill rounded once), at
per-row positions, for several steps on both routes: dense (the JAX
``flash_decode`` oracle route) and paged (``flash_decode_paged``).  The
prefill's 21 tokens and the decode's last position, 18, lie past gemma2's
reduced window, so the local layers mask in both.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as j_reduced
from repro.models.lm import LM as JLM
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import lm as tlm
from repro_torch.models.lm import LM

ARCHS = ["smollm-135m", "llama3.2-1b", "gemma2-2b"]
TOL = 1e-5
PROMPTS = (5, 9, 14)          # per-row prompt lengths
STEPS = 5                     # decode steps: row 2 ends at position 18
S_LEN, PAGE = 32, 4


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jl = JLM(j_reduced(arch))
    jp = jl.init_params(jax.random.PRNGKey(0))
    tl = LM(get_reduced_config(arch), device="cpu")
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jl, jp, tl, tp


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert np.isfinite(err) and err <= tol * scale, (err, scale)


def _bf16(x):
    """float32 values rounded to bfloat16 (round to nearest even)."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _within_one_bf16_ulp(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ra, rb = _bf16(a), _bf16(b)
    floor = np.abs(a).max() * 2.0 ** -12
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), floor)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    bad = np.abs(ra - rb) > ulp
    assert not bad.any(), (int(bad.sum()), np.abs(ra - rb).max())


def _tokens(cfg, seed, *shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def test_pattern_and_param_tree_match_jax():
    for arch in ARCHS:
        jl, jp, tl, tp = _pair(arch)
        assert [(s.pos, s.attn, s.mlp) for s in tl.pattern] == [
            (s.pos, s.attn, s.mlp) for s in jl.pattern]
        jleaves = jax.tree_util.tree_leaves_with_path(jp)
        shapes = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in jleaves}
        assert tl.n_params() == jl.n_params()
        for path, d in tlm.PM.leaves(tl.defs):
            key = "".join(f"[{p!r}]" for p in path)
            assert shapes[key] == d.shape, (arch, key)


@pytest.mark.parametrize("kw", [
    {"n_experts": 4, "top_k": 2}, {"attn_free": True}, {"attn_every": 2},
    {"encoder_layers": 2},
    {"frontend": "patch", "image_size": 32, "patch_size": 8}])
def test_unported_families_raise(kw):
    """MoE, RWKV, Mamba, the encoder and the frontends wait for their
    slices."""
    cfg = get_reduced_config("smollm-135m")
    with pytest.raises(NotImplementedError):
        LM(cfg.replace(**kw), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch):
    jl, jp, tl, tp = _pair(arch)
    toks = _tokens(jl.cfg, 0, 2, 21)
    jlog, jc = jl.prefill(jp, {"tokens": jnp.asarray(toks)})
    tlog, tc = tl.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tlog.shape == (2, 1, jl.cfg.vocab_size)
    _close(tlog.numpy(), jlog)
    assert sorted(tc) == sorted(jc)
    for name in jc:
        for kv in ("k", "v"):
            assert tuple(tc[name][kv].shape) == jc[name][kv].shape
            _within_one_bf16_ulp(tc[name][kv].numpy(), jc[name][kv])


def test_prefill_of_a_long_prompt_uses_chunks():
    """More than one 256-query chunk (a prime length, which the reference
    splits into chunks of one): the port's ragged chunks give the same
    logits."""
    jl, jp, tl, tp = _pair("llama3.2-1b")
    toks = _tokens(jl.cfg, 1, 1, 263)
    jlog, _ = jl.prefill(jp, {"tokens": jnp.asarray(toks)})
    tlog, _ = tl.prefill(tp, {"tokens": torch.from_numpy(toks)})
    _close(tlog.numpy(), jlog)


def test_gemma2_pattern_windows_and_caps():
    """Even pattern positions are local (``repro/models/lm.py:66``), with
    the reduced window and both softcaps; the full-width parameter count
    (2,614,222,080, built as definitions only).  That the window reaches
    local layers only and the softcaps every layer and the head is what the
    prefill and decode parity tests hold."""
    tl = _pair("gemma2-2b")[2]
    assert [s.attn for s in tl.pattern] == ["local", "global"]
    cfg = tl.cfg
    assert (cfg.sliding_window, cfg.attn_softcap, cfg.logit_softcap) == (
        16, 50.0, 30.0)
    full = LM(get_config("gemma2-2b"), device="cpu")   # defs, no tensors
    assert (full.period, full.n_groups) == (2, 13)
    assert full.n_params() == 2_614_222_080


def test_gemma2_prefill_past_the_window_in_chunks():
    """A 263-token prompt (two query chunks of the plain attention, 16
    times the reduced window): logits equal JAX's."""
    jl, jp, tl, tp = _pair("gemma2-2b")
    toks = _tokens(jl.cfg, 2, 1, 263)
    jlog, _ = jl.prefill(jp, {"tokens": jnp.asarray(toks)})
    tlog, _ = tl.prefill(tp, {"tokens": torch.from_numpy(toks)})
    _close(tlog.numpy(), jlog)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (7, 0.0), (0, 20.0),
                                        (7, 20.0)])
@pytest.mark.parametrize("tq", [12, 300])
def test_attention_matches_reference(tq, window, cap):
    """The port's prefill attention (GQA 3:1, causal, with a window and a
    softcap) against ``repro.models.layers.attention``, one chunk (12
    queries) and ragged chunks (300 = 256 + 44 in the port, 3 × 100 in
    the reference)."""
    from repro.models.layers import attention as j_attention
    from repro_torch.models.layers import attention
    rng = np.random.default_rng(tq + window)
    q = rng.standard_normal((2, tq, 6, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, tq, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=True, window=window, cap=cap)
    got = attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), causal=True, window=window, cap=cap)
    _close(got.numpy(), want)


def _shared_cache(jl, jp):
    """Each row prefilled alone; the f32 caches rounded to bf16 once into a
    dense (ng, B, S, hkv, hd) cache both sides start from."""
    cfg = jl.cfg
    dense = {f"pos{i}": {kv: np.zeros((jl.n_groups, len(PROMPTS), S_LEN,
                                       cfg.n_kv_heads, cfg.hd), np.float32)
                         for kv in ("k", "v")} for i in range(jl.period)}
    for b, tp in enumerate(PROMPTS):
        _, c = jl.prefill(jp, {"tokens": jnp.asarray(
            _tokens(cfg, 10 + b, 1, tp))})
        for name in dense:
            for kv in ("k", "v"):
                dense[name][kv][:, b, :tp] = _bf16(c[name][kv][:, 0])
    return dense


def _pages(dense, n_rows):
    """The dense cache laid into shuffled physical pages (page 0 is the
    null page), and the page table."""
    nb = S_LEN // PAGE
    perm = np.random.default_rng(3).permutation(np.arange(1, 1 + n_rows * nb))
    table = perm.reshape(n_rows, nb).astype(np.int32)
    pools = {}
    for name, c in dense.items():
        pools[name] = {}
        for kv, x in c.items():
            ng = x.shape[0]
            pool = np.zeros((ng, 1 + n_rows * nb, PAGE) + x.shape[3:],
                            np.float32)
            pool[:, table.reshape(-1)] = x.reshape(
                (ng, n_rows * nb, PAGE) + x.shape[3:])
            pools[name][kv] = pool
    return pools, table


@pytest.mark.parametrize("route", ["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch, route):
    jl, jp, tl, tp = _pair(arch)
    dense = _shared_cache(jl, jp)
    table = None
    if route == "paged":
        dense, table = _pages(dense, len(PROMPTS))
    jcache = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), dense)
    tcache = {n: {kv: torch.from_numpy(x).to(torch.bfloat16)
                  for kv, x in c.items()} for n, c in dense.items()}
    kw_j = {} if table is None else {"page_table": jnp.asarray(table)}
    kw_t = {} if table is None else {"page_table": torch.from_numpy(table)}
    pos = np.asarray(PROMPTS, np.int32)
    for step in range(STEPS):
        toks = _tokens(jl.cfg, 100 + step, len(PROMPTS), 1)
        jlog, jcache = jl.decode_step(jp, jcache, jnp.asarray(toks),
                                      jnp.asarray(pos), **kw_j)
        tlog, tcache = tl.decode_step(tp, tcache, torch.from_numpy(toks),
                                      torch.from_numpy(pos), **kw_t)
        assert tlog.shape == (len(PROMPTS), 1, jl.cfg.vocab_size)
        _close(tlog.numpy(), jlog)
        pos = pos + 1
    for name in jcache:
        for kv in ("k", "v"):
            _within_one_bf16_ulp(tcache[name][kv].float().numpy(),
                                 np.asarray(jcache[name][kv], np.float32))


def test_decode_with_a_scalar_position():
    """A scalar position broadcasts over the rows, as in the reference."""
    jl, jp, tl, tp = _pair("llama3.2-1b")
    dense = _shared_cache(jl, jp)
    jcache = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), dense)
    tcache = {n: {kv: torch.from_numpy(x).to(torch.bfloat16)
                  for kv, x in c.items()} for n, c in dense.items()}
    toks = _tokens(jl.cfg, 7, len(PROMPTS), 1)
    jlog, _ = jl.decode_step(jp, jcache, jnp.asarray(toks), 14)
    tlog, _ = tl.decode_step(tp, tcache, torch.from_numpy(toks), 14)
    _close(tlog.numpy(), jlog)


def test_port_init_uses_the_reference_scales():
    """The port's own initialization: embed N(0, 0.02²), matmul weights
    N(0, 1/fan_in), norm scales zero; float32, from an explicit
    generator (same seed, same values)."""
    cfg = get_reduced_config("llama3.2-1b").replace(vocab_size=4096,
                                                     d_model=128, d_ff=512)
    tl = LM(cfg, device="cpu")
    p = tl.init_params(torch.Generator().manual_seed(5))
    q = tl.init_params(torch.Generator().manual_seed(5))
    assert torch.equal(p["embed"], q["embed"])
    assert p["embed"].dtype == torch.float32
    assert abs(p["embed"].std().item() - 0.02) < 1e-3
    wd = p["blocks"][0]["mlp"]["wd"]
    assert wd.shape == (cfg.n_layers, cfg.d_ff, cfg.d_model)
    assert abs(wd.std().item() * np.sqrt(cfg.d_ff) - 1.0) < 0.02
    assert float(p["blocks"][0]["ln1"].abs().max()) == 0.0
    assert float(p["final_ln"].abs().max()) == 0.0
