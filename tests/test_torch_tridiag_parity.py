"""The port's block-tridiagonal K-FAC (``inv_mode="tridiag"``, paper S4.3)
against live runs of the JAX reference, stage by stage and as a whole, on
the CPU.

The golden setup (``tests/test_golden.py::golden_run``: the reduced
autoencoder 64-32-16-8 mirrored, JAX's sparse-init weights, N 256 from data
seed 7, lambda_init 3, T3 5, eta 1e-5), with the uniforms behind JAX's
sampled targets handed to the port.  Each engine stage starts from JAX's
state carried across by ``convert.state_from_numpy`` (its Ψ/Σ cache
included, so the eigh basis of the cache is JAX's); a cache the port
computes itself is held as ``tests/test_torch_tridiag.py`` holds it: Ψ, s₁,
s₂ and the last inverses directly, k₁/k₂ through the Σ⁻¹ apply of a fixed
X (ROADMAP queue C: the eigh basis is not unique).

Tolerances: per operation rtol 1e-5 with an atol of 1e-5 of the array's
largest magnitude; 1e-4 where an eigendecomposition is involved; the Σ⁻¹
apply 2e-4.  Step for step from JAX's state: loss, lambda, gamma, alpha,
mu and rho within rtol 1e-3 at every step (eigh and ns).  Free-running
against a live ``golden_run("tridiag")``: queue C's limit (lambda and
gamma exactly, the loss within 5e-3 through step 19 and 2% at steps 29,
39 and 49, alpha, mu and rho within 1e-3 through step 4, the same gamma at
the step-20 sweep).  The race config (``bench_optimizer_race.py``): the
tridiag and blkdiag rows' final losses within queue C's 2% of JAX's, in
JAX's order.  Reduced whisper: tridiag is the block-diagonal path (no
``layer_order``), equal to the port's blkdiag run bit for bit and held to
JAX's tridiag run at ``test_torch_whisper_trajectory.py``'s bands.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optimizers as joptimizers
from repro.configs.base import KFACConfig as JKFACConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.optimizers.kfac import KFACEngine as JEngine
from repro.training.trainer import Trainer as JTrainer
from repro_torch.configs.base import KFACConfig, TrainConfig
from repro_torch.convert import (lm_params_from_numpy, params_from_numpy,
                                 state_from_numpy)
from repro_torch.core import tridiag as TRI
from repro_torch.core.blocks import TridiagChain
from repro_torch.launch import train as tlaunch
from repro_torch.optimizers.kfac import KFACEngine, kfac
from repro_torch.training.trainer import Trainer
from test_golden import golden_run
from test_torch_tridiag import (_close, _close_tree, _close_tri, _np, _setup,
                                _t, _tt, _vs)
from test_torch_whisper_parity import _head_uniforms
from test_torch_whisper_parity import _setup as _whisper_setup

torch.set_num_threads(1)

BASE = dict(inv_mode="tridiag", lambda_init=3.0, t3=5, eta=1e-5)
EIGH = dict(BASE, inverse_method="eigh")
TRI_KEY, CROSS = TridiagChain.TRI, TridiagChain.CROSS


def _uniforms(seed, step, shape):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                step), 1)
    return torch.from_numpy(np.array(
        jax.random.uniform(key, shape, jnp.float32)))


def _step_key(step, seed=0):
    return jax.random.fold_in(jax.random.PRNGKey(seed), step)


@functools.lru_cache(maxsize=None)
def _golden():
    """The golden setup in both packages: models, JAX's weights, data."""
    from repro.data.pipeline import SyntheticAutoencoderData as JData
    from repro_torch.data.pipeline import SyntheticAutoencoderData
    s = _setup()
    jparams = s["jmlp"].init_params(jax.random.PRNGKey(0), sparse=True)
    dims = s["mlp"].dims
    return dict(s, jparams=jparams,
                params=params_from_numpy(_np(jparams), "cpu"),
                jdata=JData(dims[0], 8, 256, seed=7),
                data=SyntheticAutoencoderData(dims[0], 8, 256, seed=7,
                                              device="cpu"))


def _engines(**kw):
    g = _golden()
    return (JEngine(g["jmlp"], JKFACConfig(**kw), family="bernoulli"),
            KFACEngine(g["mlp"], KFACConfig(**kw), family="bernoulli",
                       device="cpu"))


def _port_state(jstate):
    return state_from_numpy(vars(_np(jstate)), "cpu")


def _jax_state(jeng):
    """One stats pass + refresh, then a nonzero momentum tangent and a
    quadratic-model value, so every term of the update is exercised."""
    g = _golden()
    jb = g["jdata"].batch(0)
    jstate = jeng.init(g["jparams"], jb)
    jstate, jgrads, _ = jax.jit(jeng.stats_grads)(jstate, g["jparams"], jb,
                                                  _step_key(0))
    jstate = jax.jit(jeng.refresh_inverses)(jstate)
    rng = np.random.default_rng(3)
    delta0 = {k: jnp.asarray((rng.standard_normal(p.shape) * 1e-2).astype(
        np.float32)) for k, p in _np(g["jparams"]).items()}
    return jstate.replace(delta0=delta0, m_delta=jnp.float32(-2.5)), jgrads


def _close_inv(got, want, rtol):
    """Per-layer inverses directly, the chain's cache as ``_close_tri``."""
    assert set(got) == set(want)
    for name in want:
        if name == TRI_KEY:
            _close_tri(got[name], want[name])
        else:
            _close_tree(got[name], want[name], rtol)


# ---------------------------------------------------------------------------
# the engine, stage by stage, from JAX's state
# ---------------------------------------------------------------------------

def test_stats_grads_two_steps():
    """Two stats passes (the second blends with eps = 1/2): per-layer
    factors and the chain's cross moments."""
    g = _golden()
    jeng, eng = _engines(**EIGH)
    jb, b = g["jdata"].batch(0), g["data"].batch(0)
    jstate = jeng.init(g["jparams"], jb)
    state = eng.init(g["params"], b)
    assert state.inv[TRI_KEY] is None and jstate.inv[TRI_KEY] is None
    jstats = jax.jit(jeng.stats_grads)
    for step in range(2):
        jstate, jgrads, _ = jstats(jstate, g["jparams"], jb, _step_key(step))
        state, grads, _ = eng.stats_grads(
            state, g["params"], b, lambda shape: _uniforms(0, step, shape))
    _close_tree(grads, _np(jgrads))
    assert sorted(state.factors[CROSS]) == sorted(jstate.factors[CROSS])
    _close_tree(state.factors, _np(jstate.factors))


@pytest.mark.parametrize("method", ["eigh", "ns"])
def test_refresh_inverses(method):
    """The per-layer inverses (the reference keeps computing them in
    tridiag mode) and the chain's Ψ/Σ cache, from JAX's factors."""
    jeng, eng = _engines(**dict(BASE, inverse_method=method))
    jstate, _ = _jax_state(jeng)
    want = _np(jax.jit(jeng.refresh_inverses)(jstate).inv)
    got = eng.refresh_inverses(_port_state(jstate), hot=True).inv
    _close_inv(got, want, 1e-4 if method == "eigh" else 1e-5)


def test_refresh_multi():
    """The gamma sweep's candidates, stacked on a leading 3 (JAX vmaps)."""
    jeng, eng = _engines(**EIGH)
    jstate, _ = _jax_state(jeng)
    jgs, ji3 = jax.jit(jeng.refresh_multi)(jstate)
    gs, i3 = eng.refresh_multi(_port_state(jstate))
    _close(gs, jgs)
    ji3 = _np(ji3)
    assert tuple(i3[TRI_KEY]["appb"][0]["k1"].shape) == tuple(
        ji3[TRI_KEY]["appb"][0]["k1"].shape)
    for c in range(3):
        _close_inv(jax.tree.map(lambda x: x[c], i3),
                   jax.tree.map(lambda x: x[c], ji3), 1e-4)


def _candidates(i3):
    return [jax.tree.map(lambda x, c=c: x[c], i3) for c in range(3)]


@pytest.mark.parametrize("n_cand", [1, 3])
def test_apply_update(n_cand):
    """The tridiag precondition inside the exact-F quadratic model, from
    JAX's state and cache; with 3 candidates the winner's delta, cache and
    gamma are picked on the device (``_take`` over the cache's lists and
    dicts)."""
    g = _golden()
    jeng, eng = _engines(**EIGH)
    jb, b = g["jdata"].batch(0), g["data"].batch(0)
    jstate, jgrads = _jax_state(jeng)
    state = _port_state(jstate)
    grads = params_from_numpy(_np(jgrads), "cpu")
    japply = jax.jit(jeng.apply_update)
    if n_cand == 1:
        jp, js, jm = japply(jstate, g["jparams"], jgrads, jb, None)
        p, st, m = eng.apply_update(state, g["params"], grads, b, None)
    else:
        jgs, ji3 = jax.jit(jeng.refresh_multi)(jstate)
        jp, js, jm = japply(jstate, g["jparams"], jgrads, jb, None,
                            cand_inv=_candidates(ji3), gammas=jgs)
        p, st, m = eng.apply_update(state, g["params"], grads, b, None,
                                    cand_inv=_candidates(_tt(ji3)),
                                    gammas=_t(np.asarray(jgs)))
        assert float(m["gamma"]) == pytest.approx(float(jm["gamma"]),
                                                  rel=1e-6)
    for k in ("alpha", "mu", "m_delta", "gamma", "grad_norm", "delta_norm"):
        _close(m[k], jm[k], rtol=1e-4)
    _close_tree(p, _np(jp), rtol=1e-4)
    _close_tree(st.delta0, _np(js.delta0), rtol=1e-4)
    _close_tree(st.inv, _np(js.inv), rtol=1e-4)


def test_precondition_is_the_chain_apply():
    """The tagged layers' preconditioned gradient is −Ξᵀ Λ Ξ V of the
    regularized gradient, from the chain's cache alone: the per-layer
    inverses in the state are not read."""
    g = _golden()
    jeng, eng = _engines(**EIGH)
    jstate, jgrads = _jax_state(jeng)
    state = _port_state(jstate)
    vs = {k: _t(v) for k, v in _vs(7, g["mlp"].metas).items()}
    grads = {g["mlp"].metas[n].param_path[0]: v for n, v in vs.items()}
    inv = dict(state.inv, **{n: None for n in g["mlp"].metas})
    out = eng._precondition(grads, inv, state)
    want = TRI.apply(g["mlp"], state.inv[TRI_KEY], vs)
    for n, u in want.items():
        _close(out[g["mlp"].metas[n].param_path[0]], -u, 1e-6)


@pytest.mark.parametrize("mom", [0.0, 0.9])
@pytest.mark.parametrize("clip", [dict(), dict(kl_clip=1e-3)],
                         ids=["none", "kl"])
def test_apply_update_fused(clip, mom):
    """The fused fixed-lr chain's tridiag branch: α·U + μ·M elementwise
    with ΣD² per leaf, then the clip."""
    g = _golden()
    kw = dict(BASE, inverse_method="ns", use_rescale=False, fixed_lr=0.02,
              fixed_momentum=mom, **clip)
    jeng, eng = _engines(**kw)
    jb, b = g["jdata"].batch(0), g["data"].batch(0)
    jstate, jgrads = _jax_state(jeng)
    jp, js, jm = jax.jit(jeng.apply_update_fused)(jstate, g["jparams"],
                                                  jgrads, jb, None)
    p, st, m = eng.apply_update_fused(_port_state(jstate), g["params"],
                                      params_from_numpy(_np(jgrads), "cpu"),
                                      b, None)
    assert set(m) == set(jm)
    for k in m:
        _close(m[k], jm[k])
    if clip:
        assert float(m["nu"]) < 1.0
    _close_tree(p, _np(jp))
    _close_tree(st.delta0, _np(js.delta0))


def test_state_from_numpy_round_trips_a_tridiag_state():
    """``convert.state_from_numpy`` carries a JAX tridiag ``KFACState``
    across: ``__cross__`` a dict, ``__tri__`` lists of tensors and of dicts
    (stacked candidates with their leading 3), or None before the first
    refresh; back to numpy it is JAX's, bit for bit."""
    g = _golden()
    jeng, _ = _engines(**EIGH)
    jinit = jeng.init(g["jparams"], g["jdata"].batch(0))
    assert _port_state(jinit).inv[TRI_KEY] is None
    jstate, _ = _jax_state(jeng)
    _, ji3 = jax.jit(jeng.refresh_multi)(jstate)
    for want in (_np(jstate), _np(jstate.replace(inv=ji3))):
        st = state_from_numpy(vars(want), "cpu")
        tri = st.inv[TRI_KEY]
        assert isinstance(st.factors[CROSS], dict)
        assert isinstance(tri["psi_a"], list) and isinstance(
            tri["appb"][0], dict)
        assert all(x.dtype == torch.float32 for x in tri["psi_g"])
        back = jax.tree.map(lambda x: x.numpy(), (st.factors, st.inv))
        _close_tree(back, (want.factors, want.inv), rtol=0)


def test_pipeline_stages():
    """tridiag runs blkdiag's stages: no eigen rescale."""
    for kw, update in ((EIGH, "precondition+quadratic_model_lr_momentum"),
                       (dict(BASE, use_rescale=False),
                        "fused_precondition_momentum_clip")):
        opt = kfac(_golden()["mlp"], KFACConfig(**kw), family="bernoulli",
                   device="cpu")
        assert opt.name == "kfac_tridiag"
        assert [st.name for st in opt.update.__self__.stages] == [
            "estimate_stats", "scheduled_inverse_refresh", update,
            "adapt_lambda"]


# ---------------------------------------------------------------------------
# the slice as a whole: Trainer.fit against a live JAX Trainer.fit
# ---------------------------------------------------------------------------

STEPS = 25            # warmup and T3 refreshes, T1 lambda steps, the sweep
KEYS = ("loss", "lam", "gamma", "alpha", "mu", "rho")


@functools.lru_cache(maxsize=None)
def _jax_run(method):
    """A live JAX ``Trainer.fit`` of the golden setup in tridiag mode,
    recording every optimizer step's inputs and outputs."""
    g = _golden()
    opt = joptimizers.kfac(g["jmlp"], JKFACConfig(**dict(
        BASE, inverse_method=method)), family="bernoulli")
    record = []

    def update(grads, state, params, batch, rng):
        out = opt.update(grads, state, params, batch, rng)
        record.append(_np((state, params, out[0], out[1])))
        return out

    tr = JTrainer(g["jmlp"], dataclasses.replace(opt, update=update),
                  JTrainConfig(steps=STEPS, seed=0, log_every=10_000),
                  None, None)
    hist = tr.fit(g["jparams"], g["jdata"], steps=STEPS,
                  log=lambda *_: None)["history"]
    return hist, record


def _port_opt(method):
    return kfac(_golden()["mlp"], KFACConfig(**dict(
        BASE, inverse_method=method)), family="bernoulli", device="cpu")


@pytest.mark.parametrize("method", ["eigh", "ns"])
def test_each_step_matches_jax_from_its_state(method):
    """Step for step: every optimizer step of the port, started from the
    reference's state (its Ψ/Σ cache included) and parameters at that step
    with the same uniforms, gives the reference's step — the warmup / T3
    refreshes, the step-20 gamma sweep and the T1 lambda rule included."""
    g = _golden()
    want, record = _jax_run(method)
    opt = _port_opt(method)
    for step, (jstate, jparams, jnew, jout) in enumerate(record):
        params = params_from_numpy(jparams, "cpu")
        if step == 0:
            opt.init(params, g["data"].batch(0))
        new, state, m = opt.update(
            None, state_from_numpy(vars(jstate), "cpu"), params,
            g["data"].batch(step),
            lambda shape, step=step: _uniforms(0, step, shape))
        for k in KEYS:
            assert (k in m) == (k in want[step]), (step, k)
            if k in m:
                assert float(m[k]) == pytest.approx(want[step][k],
                                                    rel=1e-3), (step, k)
        _close_tree(new, jnew, rtol=1e-4)
        _close_tree(state.factors, jout.factors, rtol=1e-4)
        assert int(state.step) == int(jout.step) == step + 1


@functools.lru_cache(maxsize=None)
def _golden_history():
    return golden_run("tridiag", return_history=True)


def test_trajectory_matches_live_golden_run():
    """Free-running: the port's ``Trainer.fit`` from JAX's weights with
    JAX's uniforms against a live ``golden_run("tridiag")`` (eigh, 50
    steps), held to queue C's limit."""
    want = _golden_history()
    g = _golden()
    steps = len(want)
    tr = Trainer(g["mlp"], _port_opt("eigh"),
                 TrainConfig(steps=steps, seed=0, log_every=10_000),
                 noise=lambda step, shape: _uniforms(0, step, shape),
                 device="cpu")
    got = tr.fit(g["params"], g["data"], steps=steps,
                 log=lambda *_: None)["history"]
    assert len(got) == steps == 50
    for step in range(20):
        for k in KEYS:
            assert (k in got[step]) == (k in want[step]), (step, k)
        for k in ("lam", "gamma"):
            assert got[step][k] == pytest.approx(want[step][k], rel=1e-6)
        assert got[step]["loss"] == pytest.approx(want[step]["loss"],
                                                  rel=5e-3), step
        if step <= 4:
            for k in ("loss", "alpha", "mu", "rho"):
                if k in want[step]:
                    assert got[step][k] == pytest.approx(
                        want[step][k], rel=1e-3), (step, k)
    assert got[20]["gamma"] == pytest.approx(want[20]["gamma"], rel=1e-6)
    assert want[20]["gamma"] != pytest.approx(want[19]["gamma"], rel=1e-3)
    for step in (29, 39, 49):
        assert got[step]["loss"] == pytest.approx(want[step]["loss"],
                                                  rel=0.02), step
    assert got[-1]["loss"] < 0.5 * got[0]["loss"]


# ---------------------------------------------------------------------------
# the race config: tridiag against blkdiag
# ---------------------------------------------------------------------------

RACE_DIMS = [64, 48, 24, 12, 24, 48, 64]
RACE_STEPS = 30


@functools.lru_cache(maxsize=None)
def _race(inv_mode, where):
    """One K-FAC row of ``benchmarks/bench_optimizer_race.py`` (dense-init
    weights, N 1024, ns inverses, 30 steps) in JAX or in the port from
    JAX's weights with JAX's uniforms: the losses."""
    from repro.data.pipeline import SyntheticAutoencoderData as JData
    from repro.models.mlp import MLP as JMLP
    from repro_torch.data.pipeline import SyntheticAutoencoderData
    from repro_torch.models.mlp import MLP
    jmlp = JMLP(RACE_DIMS, nonlin="tanh", loss="bernoulli")
    jparams = jmlp.init_params(jax.random.PRNGKey(0), sparse=False)
    kw = dict(inv_mode=inv_mode, lambda_init=3.0, t3=5, fixed_lr=0.02,
              eta=1e-5)
    cfg = TrainConfig(steps=RACE_STEPS, seed=0, log_every=10_000_000)
    if where == "jax":
        tr = JTrainer(jmlp, joptimizers.kfac(jmlp, JKFACConfig(**kw),
                                             family="bernoulli"),
                      JTrainConfig(steps=RACE_STEPS, seed=0,
                                   log_every=10_000_000), None, None)
        out = tr.fit(jparams, JData(RACE_DIMS[0], 8, 1024, seed=7),
                     steps=RACE_STEPS, log=lambda *_: None)
    else:
        mlp = MLP(RACE_DIMS, device="cpu")
        tr = Trainer(mlp, kfac(mlp, KFACConfig(**kw), family="bernoulli",
                               device="cpu"), cfg,
                     noise=lambda step, shape: _uniforms(0, step, shape),
                     device="cpu")
        out = tr.fit(params_from_numpy(_np(jparams), "cpu"),
                     SyntheticAutoencoderData(RACE_DIMS[0], 8, 1024, seed=7,
                                              device="cpu"),
                     steps=RACE_STEPS, log=lambda *_: None)
    return [h["loss"] for h in out["history"]]


@pytest.mark.parametrize("inv_mode", ["tridiag", "blkdiag"])
def test_race_final_loss_matches_jax(inv_mode):
    got, want = _race(inv_mode, "port"), _race(inv_mode, "jax")
    assert len(got) == len(want) == RACE_STEPS
    assert np.isfinite(got).all()
    assert got[-1] == pytest.approx(want[-1], rel=0.02)


def test_race_keeps_jax_tridiag_blkdiag_ordering():
    """The claim of ``examples/autoencoder_kfac.py``, tridiag at or below
    blkdiag per iteration: the port orders the two rows' final losses as
    JAX's race does."""
    want = {m: _race(m, "jax")[-1] for m in ("tridiag", "blkdiag")}
    got = {m: _race(m, "port")[-1] for m in ("tridiag", "blkdiag")}
    assert (got["tridiag"] <= got["blkdiag"]) == (
        want["tridiag"] <= want["blkdiag"]), (got, want)


# ---------------------------------------------------------------------------
# an LM: tridiag is the block-diagonal path
# ---------------------------------------------------------------------------

WHISPER_STEPS = 6     # warmup refreshes 0-2, the lambda step at 4, T3 at 5


@functools.lru_cache(maxsize=None)
def _whisper_jax_tridiag():
    s = _whisper_setup()
    tr = JTrainer(s["jl"], joptimizers.kfac(s["jl"], JKFACConfig(
        inv_mode="tridiag", lambda_init=10.0, t3=5)),
        JTrainConfig(steps=WHISPER_STEPS, seed=0, log_every=10_000),
        None, None)
    return tr.fit(s["jp"], s["jdata"], steps=WHISPER_STEPS,
                  log=lambda *_: None)["history"]


def _whisper_port(inv_mode):
    s = _whisper_setup()
    opt = kfac(s["lm"], KFACConfig(inv_mode=inv_mode, lambda_init=10.0,
                                   t3=5), device="cpu")
    tr = Trainer(s["lm"], opt, TrainConfig(steps=WHISPER_STEPS, seed=0,
                                           log_every=10_000),
                 noise=lambda step, shape: _head_uniforms(0, step, shape),
                 device="cpu")
    params = lm_params_from_numpy(_np(s["jp"]), "cpu")
    return tr.fit(params, s["data"], steps=WHISPER_STEPS,
                  log=lambda *_: None)["history"]


def test_reduced_whisper_tridiag_is_blkdiag_and_jax():
    """Reduced whisper from JAX's weights: tridiag equals the port's
    blkdiag run bit for bit, and JAX's tridiag run within the whisper
    trajectory test's bands."""
    got = _whisper_port("tridiag")
    assert got == _whisper_port("blkdiag")
    want = _whisper_jax_tridiag()
    assert len(got) == len(want) == WHISPER_STEPS
    for step in range(WHISPER_STEPS):
        for k in KEYS:
            assert (k in got[step]) == (k in want[step]), (step, k)
        for k in ("lam", "gamma"):
            assert got[step][k] == pytest.approx(want[step][k], rel=1e-6)
        assert got[step]["loss"] == pytest.approx(want[step]["loss"],
                                                  rel=5e-3), step
        if step <= 4:
            for k in ("loss", "alpha", "mu", "rho"):
                if k in want[step]:
                    assert got[step][k] == pytest.approx(
                        want[step][k], rel=1e-3), (step, k)


def test_train_launcher_inv_mode():
    """``launch/train.py --inv_mode``: tridiag on reduced whisper is the
    blkdiag run; eigen on an LM runs (EKFAC), and is another run."""
    def run(mode):
        return tlaunch.main(["--arch", "whisper-small", "--reduced",
                             "--steps", "2", "--inv_mode", mode,
                             "--device", "cpu"],
                            log=lambda *_: None)["history"]

    assert run("tridiag") == run("blkdiag")
    eig = run("eigen")
    assert all(math.isfinite(h["loss"]) for h in eig)
    assert [h["alpha"] for h in eig] != [h["alpha"]
                                         for h in run("blkdiag")]
