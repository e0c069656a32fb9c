"""The port's first-order optimizer API (``repro_torch/core/transform.py``,
``repro_torch/optimizers``) against a live run of the JAX reference's, on
the CPU.

Inputs: a parameter tree with the shapes the port handles (the MLP's flat
dict and an LM-like nested dict with a ``blocks`` tuple), its values and
four steps of fake gradients drawn by numpy from fixed seeds, the same
arrays in both.  Each transform is driven for 4 steps, the parameters moved
by its updates, in each implementation on its own.

Tolerance: every update and every state leaf within rtol 1e-6 of the
reference's, with an atol of 1e-6 of the array's largest magnitude (the
same float32 operations in the same order; XLA may fuse them, which moves
a result by an ulp or two); Adam's ``count`` exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optimizers as joptimizers
from repro.configs.base import KFACConfig as JKFACConfig
from repro.core import transform as JT
from repro.models.mlp import MLP as JMLP
from repro.optimizers import baselines as JB
from repro_torch import optimizers
from repro_torch.configs.base import KFACConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import transform as TT
from repro_torch.models.mlp import MLP
from repro_torch.optimizers import baselines as TB
from repro_torch.utils import tree as T

torch.set_num_threads(1)

STEPS = 4
RTOL = 1e-6


def _np_tree(seed, scale=1.0):
    """A parameter-shaped tree of float32 numpy arrays, keys sorted (the
    reference's leaf order)."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: (rng.standard_normal(sh) * scale).astype(np.float32)
    return {"W0": f(7, 5), "W1": f(6, 3),
            "blocks": ({"attn": f(2, 4, 4), "ln": f(2, 4)},
                       {"attn": f(2, 4, 4), "ln": f(2, 4)}),
            "final_ln": f(4)}


def _torch(tree):
    return lm_params_from_numpy(tree, "cpu")


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _close_tree(got, want, rtol=RTOL):
    if isinstance(want, dict):
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            _close_tree(got[k], want[k], rtol)
    elif isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _close_tree(g, w, rtol)
    else:
        _close(got, want, rtol)


# name -> constructor over (transform module, baselines module): the port's
# and the reference's take the same arguments
CASES = {
    "scale": lambda t, b: t.scale(-0.1),
    "add_decayed_weights": lambda t, b: t.add_decayed_weights(1e-2),
    "clip_by_global_norm": lambda t, b: t.clip_by_global_norm(8.0),
    "momentum_global_clip": lambda t, b: t.momentum_global_clip(0.9, 10.0),
    "with_momentum": lambda t, b: t.with_momentum(0.9),
    "scale_by_adam": lambda t, b: t.scale_by_adam(),
    "with_kl_clip": lambda t, b: t.with_kl_clip(
        t.chain(t.scale(-0.1), t.with_momentum(0.9)), 1.0, lr=0.5),
    "sgd_momentum_transform": lambda t, b: b.sgd_momentum_transform(
        0.1, 0.9, weight_decay=1e-3),
    "adam_transform": lambda t, b: b.adam_transform(1e-2, weight_decay=1e-2),
}


def _pair(name):
    return CASES[name](TT, TB), CASES[name](JT, JB)


@pytest.mark.parametrize("name", list(CASES))
def test_transform_matches_jax(name):
    """Four steps of each transform: emitted updates, states and the moved
    parameters equal the reference's.  The gradients' scale grows step by
    step, so that the clips act on some steps and not on others."""
    tx, jtx = _pair(name)
    p0 = _np_tree(0)
    params, jparams = _torch(p0), _jax(p0)
    state, jstate = tx.init(params), jtx.init(jparams)
    _close_tree(state, jax.tree.map(np.asarray, jstate))
    for step in range(STEPS):
        g = _np_tree(10 + step, scale=0.5 * (step + 1))
        u, state = tx.update(_torch(g), state, params)
        ju, jstate = jax.jit(jtx.update)(_jax(g), jstate, jparams)
        _close_tree(u, jax.tree.map(np.asarray, ju))
        _close_tree(state, jax.tree.map(np.asarray, jstate))
        params = TT.apply_updates(params, u)
        jparams = JT.apply_updates(jparams, ju)
        _close_tree(params, jax.tree.map(np.asarray, jparams))


def test_clips_act_on_some_steps_only():
    """The clip cases above take both branches: the first step's gradient
    norm is under clip_by_global_norm's limit, the others over it, and the
    KL clip's nu is 1 on the first step and below it on the last."""
    norms = [float(torch.sqrt(T.tree_sqnorm(_torch(
        _np_tree(10 + step, 0.5 * (step + 1)))))) for step in range(STEPS)]
    assert norms[0] < 8.0 < min(norms[1:])
    tx = TT.clip_by_global_norm(8.0)
    u, _ = tx.update(_torch(_np_tree(11, 1.0)), (), None)
    assert float(torch.sqrt(T.tree_sqnorm(u))) == pytest.approx(8.0)
    inner = TT.scale(-0.1)
    kl = TT.with_kl_clip(inner, 1.0, lr=0.5)
    for step, clipped in ((0, False), (STEPS - 1, True)):
        g = _torch(_np_tree(10 + step, 0.5 * (step + 1)))
        nu = (T.tree_sqnorm(kl.update(g, (), None)[0])
              / T.tree_sqnorm(inner.update(g, (), None)[0])).sqrt()
        assert (float(nu) < 1.0 - 1e-6) == clipped, (step, float(nu))


def test_chain_threads_its_states():
    """``chain`` keeps one state per transform, and each transform takes the
    output of the one before it: v1 <- 0.5 v1 + g, then v2 <- 0.25 v2 +
    2 v1."""
    tx = TT.chain(TT.with_momentum(0.5), TT.scale(2.0),
                  TT.with_momentum(0.25))
    jtx = JT.chain(JT.with_momentum(0.5), JT.scale(2.0),
                   JT.with_momentum(0.25))
    p = _torch(_np_tree(0))
    state = tx.init(p)
    assert len(state) == 3 and state[1] == ()
    v1 = v2 = 0.0
    jstate = jtx.init(_jax(_np_tree(0)))
    for step in range(3):
        g = _np_tree(20 + step)
        u, state = tx.update(_torch(g), state, p)
        ju, jstate = jtx.update(_jax(g), jstate, None)
        v1 = 0.5 * v1 + g["W0"]
        v2 = 0.25 * v2 + 2.0 * v1
        _close(state[0]["W0"], v1)
        _close(state[2]["W0"], v2)
        _close(u["W0"], v2)
        _close_tree(state, jax.tree.map(np.asarray, jstate))


def test_adam_weight_decay_is_decoupled():
    """With ``weight_decay`` Adam's update is the plain Adam update minus
    lr·wd·p: the decay is added after the moment rescaling, so sqrt(nu)
    does not normalize it."""
    lr, wd = 1e-2, 0.1
    p = _torch(_np_tree(0))
    plain, decayed = TB.adam_transform(lr), TB.adam_transform(lr,
                                                              weight_decay=wd)
    s0, s1 = plain.init(p), decayed.init(p)
    for step in range(3):
        g = _torch(_np_tree(30 + step))
        u0, s0 = plain.update(g, s0, p)
        u1, s1 = decayed.update(g, s1, p)
        diff = T.tree_map(lambda a, b: (a - b).numpy(), u1, u0)
        want = T.tree_map(lambda x: -lr * wd * x.numpy(), p)
        _close_tree(diff, want, rtol=1e-4)
    # the moments never see the decay
    _close_tree(s1[0], s0[0], rtol=0.0)


def test_from_transform_without_a_model_needs_grads():
    """Without a model ``update(None, ...)`` raises, as the reference's
    does; with grads it applies the transform and reports both norms."""
    opt = TT.from_transform(TB.sgd_momentum_transform(0.1), name="sgd")
    jopt = JT.from_transform(JB.sgd_momentum_transform(0.1), name="sgd")
    p0 = _np_tree(0)
    params, jparams = _torch(p0), _jax(p0)
    state, jstate = opt.init(params), jopt.init(jparams)
    with pytest.raises(ValueError, match="no model bound"):
        opt.update(None, state, params)
    with pytest.raises(ValueError, match="no model bound"):
        jopt.update(None, jstate, jparams)
    g = _np_tree(40)
    new, state, m = opt.update(_torch(g), state, params)
    jnew, jstate, jm = jopt.update(_jax(g), jstate, jparams)
    _close_tree(new, jax.tree.map(np.asarray, jnew))
    _close_tree(state.inner, jax.tree.map(np.asarray, jstate.inner))
    assert state.step.dtype == torch.int32 and int(state.step) == 1
    assert set(m) == set(jm) == {"grad_norm", "delta_norm"}
    for k in m:
        assert m[k].dim() == 0
        _close(m[k], jm[k])
    assert opt.transform is not None and opt.name == jopt.name == "sgd"


DIMS = [8, 4, 8]


@pytest.mark.parametrize("name,kw", [
    ("kfac", {}), ("sgd", {"lr": 0.05}), ("sgd_momentum", {"momentum": 0.5}),
    ("adam", {"lr": 1e-2})])
def test_get_builds_what_jax_builds(name, kw):
    """``get`` names, wraps and configures each optimizer as the
    reference's registry does."""
    mlp, jmlp = MLP(DIMS, device="cpu"), JMLP(DIMS, loss="bernoulli")
    if name == "kfac":
        opt = optimizers.get(name, mlp, kfac_cfg=KFACConfig(),
                             family="bernoulli", device="cpu")
        jopt = joptimizers.get(name, jmlp, kfac_cfg=JKFACConfig(),
                               family="bernoulli")
        assert isinstance(opt.engine, optimizers.KFACEngine)
        assert opt.transform is None and jopt.transform is None
    else:
        opt = optimizers.get(name, mlp, **kw)
        jopt = joptimizers.get(name, jmlp, **kw)
        assert opt.engine is None and opt.transform is not None
        p0 = {"W0": np.ones((9, 4), np.float32),
              "W1": np.ones((5, 8), np.float32)}
        g = {"W0": np.full((9, 4), 0.5, np.float32),
             "W1": np.full((5, 8), -2.0, np.float32)}
        u, _ = opt.transform.update(_torch(g), opt.transform.init(
            _torch(p0)), _torch(p0))
        ju, _ = jopt.transform.update(_jax(g), jopt.transform.init(
            _jax(p0)), _jax(p0))
        _close_tree(u, jax.tree.map(np.asarray, ju))
    assert opt.name == jopt.name


def test_get_and_as_optimizer_refuse_what_jax_refuses():
    mlp = MLP(DIMS, device="cpu")
    with pytest.raises(KeyError, match="unknown optimizer"):
        optimizers.get("rmsprop", mlp)
    with pytest.raises(KeyError, match="unknown optimizer"):
        joptimizers.get("rmsprop", JMLP(DIMS, loss="bernoulli"))
    with pytest.raises(TypeError, match="not an optimizer"):
        optimizers.as_optimizer(object())
    with pytest.raises(TypeError, match="not an optimizer"):
        joptimizers.as_optimizer(object())


def test_as_optimizer_wraps_an_engine():
    """An Optimizer passes through unchanged; a KFACEngine becomes the
    staged pipeline around that same engine."""
    mlp = MLP(DIMS, device="cpu")
    opt = optimizers.adam(mlp)
    assert optimizers.as_optimizer(opt) is opt
    eng = optimizers.KFACEngine(mlp, KFACConfig(), "bernoulli", "cpu")
    wrapped = optimizers.as_optimizer(eng)
    assert isinstance(wrapped, TT.Optimizer) and wrapped.engine is eng
    assert wrapped.name == "kfac_blkdiag"
