"""The port's K-FAC training of whisper against a live run of the JAX
reference, module by module and as a whole, on the reduced whisper-small
(2 + 2 layers, d 48, 3 heads of 16, d_ff 96, vocab 256, 8 mels, 32 frames;
batch 8, seq 64) on the CPU.

JAX's ``LM.init_params(PRNGKey(0))`` is carried across, the data are the
reference's numpy streams (bitwise), and the head's sampling noise is
JAX's: step s draws chunk c's labels from ``split(fold_in(fold_in(
PRNGKey(seed), s), 1), n_chunks)[c]`` (``training/trainer.py:88``,
``optimizers/kfac.py:287``) as ``argmax(logits + gumbel)``, so the test
hands the port the uniforms behind those Gumbel draws.

Tolerances: per operation rtol 1e-5 with an atol of 1e-5 of the array's
largest magnitude (float32 sums in another order).  The conv factors are
held against JAX with ``kernel_backend="pallas"``: at these shapes
(conv1 t_out 32, C 8; conv2 t_out 16, C 48) its interpret-mode
``patch_factor`` runs.  ``Trainer.fit`` as a whole is held in
``test_torch_whisper_trajectory.py``.
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
from repro.data.pipeline import make_audio_batch as j_audio
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

torch.set_num_threads(1)

ARCH = "whisper-small"
BATCH, SEQ = 8, 64
_TINY = float(np.finfo(np.float32).tiny)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(scale, 1e-30))


def _close_tree(got, want, rtol=1e-5):
    if want is None:                 # an eigen state's diagonal side
        assert got is None
    elif isinstance(want, dict):
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            _close_tree(got[k], want[k], rtol)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_tree(g, w, rtol)
    else:
        _close(got, want, rtol)


def _head_uniforms(seed, step, shape):
    """The uniforms behind the Gumbel noise of step ``step``'s sampled
    labels in the reference, for every chunk: shape (n_chunks, B, c, V)."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                step), 1)
    keys = jax.random.split(key, shape[0])
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
        k, shape[1:], jnp.float32, minval=_TINY, maxval=1.0))
        for k in keys]))


class _JData:
    """The reference launcher's ``_ArchData`` for whisper."""

    def __init__(self, cfg):
        self.cfg, self.base = cfg, JLMData(cfg.vocab_size, SEQ, BATCH)

    def batch(self, step):
        return j_audio(self.base.batch(step), self.cfg.n_mels,
                       2 * self.cfg.encoder_seq, None, step)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = j_reduced(ARCH)
    jl = JLM(jcfg)
    jp = jl.init_params(jax.random.PRNGKey(0))
    cfg = get_reduced_config(ARCH)
    lm = LM(cfg, device="cpu")
    params = lm_params_from_numpy(_np(jp), device="cpu")
    data = tlaunch._ArchData(cfg, SyntheticLMData(cfg.vocab_size, SEQ, BATCH,
                                                  device="cpu"))
    return dict(jl=jl, jp=jp, jdata=_JData(jcfg), lm=lm, params=params,
                data=data)


def _key(step, seed=0):
    return jax.random.fold_in(jax.random.PRNGKey(seed), step)


def _grad_leaves(lm, params, batch):
    p1 = T.tree_map(lambda v: v.detach().requires_grad_(True), params)
    (lt, _), _ = lm.loss(p1, None, batch, None, mode="plain")
    return lt, T.tree_unflatten_like(params, torch.autograd.grad(
        lt, T.tree_leaves(p1)))


# ---------------------------------------------------------------------------
# module by module
# ---------------------------------------------------------------------------

def test_data_and_param_tree_are_the_reference():
    s = _setup()
    for step in (0, 3):
        jb, b = s["jdata"].batch(step), s["data"].batch(step)
        assert set(b) == set(jb) == {"tokens", "labels", "mels"}
        for k in jb:
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
    assert s["lm"].n_params() == s["jl"].n_params()
    assert sorted(s["lm"].metas) == sorted(s["jl"].metas)
    for name, jm in s["jl"].metas.items():
        m = s["lm"].metas[name]
        for f in ("param_path", "d_in", "d_out", "kind", "n_stack", "a_kind",
                  "g_kind", "has_bias", "conv_spatial", "conv_stride",
                  "conv_in", "conv_pad"):
            assert getattr(m, f) == getattr(jm, f), (name, f)
    assert s["lm"].probe_shapes(s["data"].batch(0)) == {
        k: v.shape for k, v in s["jl"].probe_shapes(
            s["jdata"].batch(0)).items()}


def test_sampling_is_jax_categorical():
    """argmax(logits + gumbel(u)) on the injected uniforms draws what
    ``jax.random.categorical`` draws from their key."""
    logits = np.random.default_rng(0).standard_normal((8, 64, 256)).astype(
        np.float32) * 3.0
    key = jax.random.fold_in(_key(2), 1)
    want = np.asarray(jax.random.categorical(jax.random.split(key, 1)[0],
                                             jnp.asarray(logits), axis=-1))
    u = _head_uniforms(0, 2, (1, 8, 64, 256))[0]
    got = torch.argmax(torch.from_numpy(logits)
                       - torch.log(-torch.log(u)), dim=-1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_loss_hidden_and_grads():
    s = _setup()
    jb, b = s["jdata"].batch(0), s["data"].batch(0)
    (jlt, _), _ = s["jl"].loss(s["jp"], None, jb, _key(0), mode="plain")
    (lt, ls), _ = s["lm"].loss(s["params"], None, b, None, mode="plain")
    _close(lt, jlt)
    assert float(ls) == 0.0           # no draw in the plain pass
    jh, _, _ = s["jl"].hidden(s["jp"], jb)
    h, _, _ = s["lm"].hidden(s["params"], b)
    _close(h, jh)
    jgrads = jax.grad(lambda p: s["jl"].loss(p, None, jb, _key(0))[0][0])(
        s["jp"])
    _close_tree(_grad_leaves(s["lm"], s["params"], b)[1], _np(jgrads))


def test_collect_records_and_probe_cotangents():
    s = _setup()
    jl, lm = s["jl"], s["lm"]
    jb, b = s["jdata"].batch(1), s["data"].batch(1)
    jprobes = jl.make_probes(jl.probe_shapes(jb))
    rng2 = jax.random.fold_in(_key(1), 1)

    def f(pr):
        (_, ls), aux = jl.loss(s["jp"], pr, jb, rng2, mode="collect")
        return ls, aux

    jls, vjp_fn, jaux = jax.vjp(f, jprobes, has_aux=True)
    (jg,) = vjp_fn(jnp.float32(1.0))
    probes = lm.make_probes(b)
    (_, ls), aux = lm.loss(s["params"], probes, b,
                           lambda shape: _head_uniforms(0, 1, shape),
                           mode="collect")
    g = dict(zip(probes, torch.autograd.grad(ls, list(probes.values()))))
    _close(ls, jls)
    _close_tree(g, _np(jg))
    jrecs, recs = _np(jaux["recs"]), aux["recs"]
    assert sorted(recs) == sorted(jrecs)
    for name, jr in jrecs.items():
        r = recs[name]
        if "aa" in jr and name != "lm_head":    # contracted in JAX's scan
            _close(factors.outer_sum(r["a"], stacked=True), jr["aa"])
        else:
            for k in jr:
                _close(r[k], jr[k])


def _engines(backend="xla"):
    s = _setup()
    jcfg = JKFACConfig(lambda_init=10.0, t3=5, kernel_backend=backend)
    cfg = KFACConfig(lambda_init=10.0, t3=5)
    return (JEngine(s["jl"], jcfg),
            KFACEngine(s["lm"], cfg, device="cpu"))


def test_factors_after_two_stats_passes():
    """Two stats passes (the second blends with eps = 1/2): every block's
    factors, the conv stems' against JAX's Pallas patch_factor route, and
    the untagged params' diagonal curvature; the gradients."""
    s = _setup()
    jeng, eng = _engines("pallas")
    jb, b = s["jdata"].batch(0), s["data"].batch(0)
    jstate = jeng.init(s["jp"], jb)
    state = eng.init(s["params"], b)
    jstats = jax.jit(jeng.stats_grads)
    for step in range(2):
        jstate, jgrads, jm = jstats(jstate, s["jp"], jb, _key(step))
        state, grads, m = eng.stats_grads(
            state, s["params"], b,
            lambda shape, step=step: _head_uniforms(0, step, shape))
    _close_tree(state.factors, _np(jstate.factors))
    _close_tree(state.diag, _np(jstate.diag))
    _close_tree(grads, _np(jgrads))
    _close(m["loss_sampled"], jm["loss_sampled"])
    assert int(state.k_stats) == 2


def test_quad_lm():
    s = _setup()
    jb, b = s["jdata"].batch(0), s["data"].batch(0)
    rng = np.random.default_rng(3)
    tans = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-2
                                    ).astype(np.float32), _np(s["jp"]))
            for _ in range(3)]
    want = jfisher.quad_lm(s["jl"], s["jp"], jb, tans)
    got = fisher.quad_lm(s["lm"], s["params"], b,
                         [lm_params_from_numpy(t, "cpu") for t in tans])
    _close(got, want)


@pytest.mark.parametrize("a_kind,g_kind", [("full", "diag"),
                                           ("diag", "full")])
def test_diag_factor_block_matches_jax(a_kind, g_kind):
    """The diag branch of the factor statistics, the damped inverse (pi
    from the diagonal's trace) and the apply, on a stacked dense layer with
    a diagonal side (``DiagFactor``; no dense layer of whisper-small has
    one)."""
    from repro.core.blocks import DiagFactor as JDiagFactor
    from repro.core.tags import LayerMeta as JMeta
    from repro_torch.core.blocks import DiagFactor, resolve
    from repro_torch.core.tags import LayerMeta
    kw = dict(name="w", param_path=("w",), d_in=6, d_out=5, kind="dense",
              n_stack=2, a_kind=a_kind, g_kind=g_kind)
    jmeta, meta = JMeta(**kw), LayerMeta(**kw)
    assert resolve(meta) is DiagFactor
    jblk = JDiagFactor(jmeta, JKFACConfig())
    blk = DiagFactor(meta, KFACConfig(), "cpu")
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, 3, 7, 6)).astype(np.float32)
    cot = rng.standard_normal((2, 3, 7, 5)).astype(np.float32) / 21
    old = _np(jblk.init_factors())
    old = {k: v + 0.1 for k, v in old.items()}
    eps = np.float32(0.6)
    # the reference's stacked layers contract Ā per group in the forward
    # (its LM's contract map); the port records the raw inputs
    from repro.core import factors as jfactors
    aa = jax.vmap(lambda x: jfactors.outer_sum(x, a_kind, 1))(a)
    want = jblk.update_factors(old, {"aa": aa}, cot, None, 21, eps)
    t = torch.from_numpy
    got = blk.update_factors({k: t(v) for k, v in old.items()},
                             {"a": t(a)}, t(cot), 21, torch.tensor(eps))
    _close_tree(got, _np(want))
    for gamma in (np.float32(0.7), np.array([0.5, 0.7, 0.9], np.float32)):
        jinv = _np(jax.vmap(lambda g: jblk.damped_inverse(
            want, g, method="ns", iters=12))(gamma) if gamma.ndim else
            jblk.damped_inverse(want, gamma, method="ns", iters=12))
        inv = blk.damped_inverse(got, torch.from_numpy(np.asarray(gamma)),
                                 method="ns", iters=12)
        _close_tree(inv, jinv)
    v = rng.standard_normal((2, 6, 5)).astype(np.float32)
    jinv = jblk.damped_inverse(want, np.float32(0.7), method="ns", iters=12)
    inv = blk.damped_inverse(got, torch.tensor(0.7), method="ns", iters=12)
    _close(blk.precondition(inv, t(v)), jblk.precondition(jinv, v))


@pytest.mark.parametrize("kw", [{"inv_mode": "eigen"},
                                {"use_rescale": False}])
def test_lm_refuses_eigen_and_fused(kw):
    """Eigen mode and the fused fixed-lr chain on the LM: the engine builds
    and ``init`` gives the reference's initial state, held as values (the
    eigen mode's identity bases, no basis on a diagonal side, unit ``s``
    and zero ``damp``; the blkdiag identities under the chain)."""
    s = _setup()
    b, jb = s["data"].batch(0), s["jdata"].batch(0)
    cfg = dict(lambda_init=10.0, t3=5, **kw)
    jstate = JEngine(s["jl"], JKFACConfig(**cfg)).init(s["jp"], jb)
    state = KFACEngine(s["lm"], KFACConfig(**cfg), device="cpu").init(
        s["params"], b)
    _close_tree(state.inv, _np(jstate.inv))
    _close_tree(state.factors, _np(jstate.factors))
