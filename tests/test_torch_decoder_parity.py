"""The port's K-FAC training of the dense decoders (smollm-135m,
llama3.2-1b) against the JAX reference, module by module, on the reduced
configs (2 layers; smollm d 48, 3 query heads over 1 KV head, d_ff 96;
llama d 64, 4 over 2, d_ff 128; head dim 16, vocab 256, tied embeddings;
batch 8, seq 64) on the CPU, in float32 as the reference launcher builds
its LM.

JAX's ``LM.init_params(PRNGKey(0))`` is carried across, the data are the
reference's numpy token stream (bitwise), and the head's sampling noise is
JAX's (``test_torch_whisper_parity._head_uniforms``).  Held here: the
data, metas and probe shapes, the plain loss, ``hidden`` and the
gradients, the collect-mode records and probe cotangents, the factors
after two statistics passes (``embed``'s diagonal Ā from token counts
and full Ḡ on d_model among them) and ``quad_lm``, all through RoPE,
grouped-query attention and the tied head (no ``lm_head`` block; the
head's gradient reaches ``embed`` through ``head_weight``, and
``quad_lm`` takes its tangent from ``t["embed"].T``).

Tolerances: per operation rtol 1e-5 with an atol of 1e-5 of the array's
largest magnitude.  The layers alone are held in
``test_torch_decoder_layers.py``; the refresh, the preconditioned update,
the quadratic model and the λ/γ rules step for step, and ``Trainer.fit``
as a whole, in ``test_torch_decoder_trajectory.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as j_reduced
from repro.configs.base import KFACConfig as JKFACConfig
from repro.core import fisher as jfisher
from repro.data.pipeline import SyntheticLMData as JLMData
from repro.models.lm import LM as JLM
from repro.optimizers.kfac import KFACEngine as JEngine
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import KFACConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import factors, fisher
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch import train as tlaunch
from repro_torch.models.lm import LM
from repro_torch.optimizers.kfac import KFACEngine
from repro_torch.utils import tree as T
from test_torch_whisper_parity import (_close, _close_tree, _head_uniforms,
                                       _key, _np)

torch.set_num_threads(1)

ARCHS = ("smollm-135m", "llama3.2-1b")
BATCH, SEQ = 8, 64


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = j_reduced(arch)
    jl = JLM(jcfg)
    jp = jl.init_params(jax.random.PRNGKey(0))
    cfg = get_reduced_config(arch)
    lm = LM(cfg, device="cpu")
    params = lm_params_from_numpy(_np(jp), device="cpu")
    # the reference launcher's _ArchData is its token stream for a decoder
    data = tlaunch._ArchData(cfg, SyntheticLMData(cfg.vocab_size, SEQ, BATCH,
                                                  device="cpu"))
    return dict(jl=jl, jp=jp, jdata=JLMData(jcfg.vocab_size, SEQ, BATCH),
                lm=lm, params=params, data=data)


def _vjp1(f, x):
    """(f(x), its cotangent for a seed of 1, aux) of a scalar ``f``
    returning ``(value, aux)``."""
    y, vjp_fn, aux = jax.vjp(f, x, has_aux=True)
    return y, vjp_fn(jnp.float32(1.0))[0], aux


def _grad_leaves(lm, params, batch):
    p1 = T.tree_map(lambda v: v.detach().requires_grad_(True), params)
    (lt, _), _ = lm.loss(p1, None, batch, None, mode="plain")
    return lt, T.tree_unflatten_like(params, torch.autograd.grad(
        lt, T.tree_leaves(p1)))


# ---------------------------------------------------------------------------
# setup, layers and the tied head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_data_metas_and_param_tree_are_the_reference(arch):
    s = _setup(arch)
    cfg = s["lm"].cfg
    assert cfg.tie_embeddings and cfg.n_kv_heads < cfg.n_heads
    for step in (0, 3):
        jb, b = s["jdata"].batch(step), s["data"].batch(step)
        assert set(b) == set(jb) == {"tokens", "labels"}
        for k in jb:
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
    assert s["lm"].n_params() == s["jl"].n_params()
    assert sorted(s["lm"].metas) == sorted(s["jl"].metas)
    assert "lm_head" not in s["lm"].metas and "head" not in s["params"]
    for name, jm in s["jl"].metas.items():
        m = s["lm"].metas[name]
        for f in ("param_path", "d_in", "d_out", "kind", "n_stack", "a_kind",
                  "g_kind", "has_bias"):
            assert getattr(m, f) == getattr(jm, f), (name, f)
    assert s["lm"].probe_shapes(s["data"].batch(0)) == {
        k: v.shape for k, v in s["jl"].probe_shapes(
            s["jdata"].batch(0)).items()}


# ---------------------------------------------------------------------------
# the model and the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_plain_loss_hidden_and_grads(arch):
    s = _setup(arch)
    jb, b = s["jdata"].batch(0), s["data"].batch(0)
    jloss = lambda p: s["jl"].loss(p, None, jb, _key(0))[0][0]
    jlt, jgrads = jax.jit(jax.value_and_grad(jloss))(s["jp"])
    (lt, ls), _ = s["lm"].loss(s["params"], None, b, None, mode="plain")
    _close(lt, jlt)
    assert float(ls) == 0.0           # no draw in the plain pass
    jh = jax.jit(lambda p: s["jl"].hidden(p, jb)[0])(s["jp"])
    h, _, _ = s["lm"].hidden(s["params"], b)
    _close(h, jh)
    _close_tree(_grad_leaves(s["lm"], s["params"], b)[1], _np(jgrads))


@pytest.mark.parametrize("arch", ARCHS)
def test_collect_records_and_probe_cotangents(arch):
    s = _setup(arch)
    jl, lm = s["jl"], s["lm"]
    jb, b = s["jdata"].batch(1), s["data"].batch(1)
    jprobes = jl.make_probes(jl.probe_shapes(jb))
    rng2 = jax.random.fold_in(_key(1), 1)

    def f(pr):
        (_, ls), aux = jl.loss(s["jp"], pr, jb, rng2, mode="collect")
        return ls, aux

    jls, jg, jaux = jax.jit(lambda pr: _vjp1(f, pr))(jprobes)
    probes = lm.make_probes(b)
    (_, ls), aux = lm.loss(s["params"], probes, b,
                           lambda shape: _head_uniforms(0, 1, shape),
                           mode="collect")
    g = dict(zip(probes, torch.autograd.grad(ls, list(probes.values()))))
    _close(ls, jls)
    _close_tree(g, _np(jg))
    jrecs, recs = _np(jaux["recs"]), aux["recs"]
    assert sorted(recs) == sorted(jrecs)
    assert "embed" in recs and "lm_head" not in recs
    for name, jr in jrecs.items():
        r = recs[name]
        if "aa" in jr:                 # contracted in JAX's scan
            _close(factors.outer_sum(r["a"], stacked=True), jr["aa"])
        else:
            for k in jr:
                _close(r[k], jr[k])


def _engines(arch):
    s = _setup(arch)
    return (JEngine(s["jl"], JKFACConfig(lambda_init=10.0, t3=5)),
            KFACEngine(s["lm"], KFACConfig(lambda_init=10.0, t3=5),
                       device="cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_factors_after_two_stats_passes(arch):
    """Two stats passes (the second blends with eps = 1/2): every block's
    factors (``embed``'s diagonal Ā from token counts and full Ḡ on
    d_model among them), the untagged params' diagonal curvature, the
    gradients and the sampled loss; N = B·T."""
    s = _setup(arch)
    jeng, eng = _engines(arch)
    jb, b = s["jdata"].batch(0), s["data"].batch(0)
    assert eng.n_tokens(b) == BATCH * SEQ
    jstate = jeng.init(s["jp"], jb)
    state = eng.init(s["params"], b)
    jstats = jax.jit(jeng.stats_grads)
    for step in range(2):
        jstate, jgrads, jm = jstats(jstate, s["jp"], jb, _key(step))
        state, grads, m = eng.stats_grads(
            state, s["params"], b,
            lambda shape, step=step: _head_uniforms(0, step, shape))
    d, v = s["lm"].cfg.d_model, s["lm"].cfg.vocab_size
    emb = state.factors["embed"]
    assert emb["a"].shape == (v,) and emb["g"].shape == (d, d)
    _close_tree(state.factors, _np(jstate.factors))
    _close_tree(state.diag, _np(jstate.diag))
    _close_tree(grads, _np(jgrads))
    _close(m["loss_sampled"], jm["loss_sampled"])
    assert int(state.k_stats) == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_quad_lm(arch):
    """The exact-Fisher quadratic through RoPE, GQA and the tied head's
    ``embed`` tangent, two tangents."""
    s = _setup(arch)
    jb, b = s["jdata"].batch(0), s["data"].batch(0)
    rng = np.random.default_rng(3)
    tans = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-2
                                    ).astype(np.float32), _np(s["jp"]))
            for _ in range(2)]
    jquad = jax.jit(lambda p, t: jfisher.quad_lm(s["jl"], p, jb, t))
    want = jquad(s["jp"], tans)
    got = fisher.quad_lm(s["lm"], s["params"], b,
                         [lm_params_from_numpy(t, "cpu") for t in tans])
    _close(got, want)
    # the head's share: a tangent on embed alone reaches the logits through
    # both the input embedding and the tied head
    only = [jax.tree.map(np.zeros_like, t) for t in tans]
    for o, t in zip(only, tans):
        o["embed"] = t["embed"]
    _close(fisher.quad_lm(s["lm"], s["params"], b,
                          [lm_params_from_numpy(t, "cpu") for t in only]),
           jquad(s["jp"], only))
