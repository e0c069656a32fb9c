"""The port's EKFAC eigen mode and fused fixed-lr chain against a live run of
the JAX reference, module by module and as a whole, on the reduced
autoencoder (64-32-16-8 mirrored) on the CPU.

Inputs come from numpy seeds and JAX's own draws (parameters and the
uniforms behind the sampled targets), handed to the port as numpy, as in
``tests/test_torch_kfac_parity.py``.

The eigh basis is not unique: LAPACK behind JAX and behind PyTorch may
return other column signs, and inside a near-degenerate eigenspace another
rotation.  So a state the port computes itself is compared through
basis-invariant quantities only (``s``/``damp``, which come from the
eigenvalues, and the preconditioned ``U`` of a fixed ``V``), and the
step-for-step tests carry JAX's ``qa``/``qg`` across through
``convert.state_from_numpy``.

Tolerances: per operation rtol 1e-5 with an atol of 1e-5 of the array's
largest magnitude; 1e-4 where an eigendecomposition is involved.  The eigen
apply against the eigh inverse apply gets rtol 5e-6·κ (κ the condition
number of the damped Kronecker product), since small γ amplifies rounding
(the reference's own ``test_eigen_matches_eigh_path_property`` fails at
γ = 1/64 with a fixed 1e-4).  Trajectory bands are stated on each test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optimizers as joptimizers
from repro.configs.autoencoder import reduced as j_reduced
from repro.configs.base import KFACConfig as JKFACConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import inverse as jinverse
from repro.core.blocks.kron import DenseKronecker as JDense
from repro.data.pipeline import SyntheticAutoencoderData as JData
from repro.models.mlp import MLP as JMLP
from repro.optimizers.kfac import KFACEngine as JEngine
from repro.training.trainer import Trainer as JTrainer
from repro_torch.configs.autoencoder import reduced
from repro_torch.configs.base import KFACConfig, TrainConfig
from repro_torch.convert import params_from_numpy, state_from_numpy
from repro_torch.core import inverse
from repro_torch.core.blocks import DenseKronecker
from repro_torch.data.pipeline import SyntheticAutoencoderData
from repro_torch.models.mlp import MLP, autoencoder_dims
from repro_torch.optimizers.kfac import KFACEngine, kfac
from repro_torch.training.trainer import Trainer

torch.set_num_threads(1)

DIMS = autoencoder_dims(reduced())
N, LATENT, DATA_SEED = 256, 8, 7
BASE = dict(lambda_init=3.0, t3=5, eta=1e-5)
EIGEN = dict(BASE, inv_mode="eigen")
FUSED = dict(BASE, inv_mode="blkdiag", inverse_method="ns", use_rescale=False,
             fixed_lr=0.02, fixed_momentum=0.9, kl_clip=1e-3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _close_tree(got, want, rtol=1e-5):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close_tree(got[k], want[k], rtol)
    else:
        _close(got, want, rtol)


def _uniforms(seed, step, shape):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                step), 1)
    return torch.from_numpy(np.array(
        jax.random.uniform(key, shape, jnp.float32)))


def _step_key(step, seed=0):
    return jax.random.fold_in(jax.random.PRNGKey(seed), step)


@pytest.fixture(scope="module")
def setup():
    assert autoencoder_dims(j_reduced()) == DIMS
    jmlp = JMLP(DIMS, nonlin="tanh", loss="bernoulli")
    jparams = jmlp.init_params(jax.random.PRNGKey(0), sparse=True)
    mlp = MLP(DIMS, device="cpu")
    return dict(jmlp=jmlp, jparams=jparams,
                jdata=JData(DIMS[0], LATENT, N, seed=DATA_SEED), mlp=mlp,
                params=params_from_numpy(_np(jparams), "cpu"),
                data=SyntheticAutoencoderData(DIMS[0], LATENT, N,
                                              seed=DATA_SEED, device="cpu"))


def _factor_pair(seed, a_dim, g_dim):
    rng = np.random.default_rng(seed)
    xa = rng.standard_normal((N, a_dim)).astype(np.float32)
    xg = rng.standard_normal((N, g_dim)).astype(np.float32) * 1e-2
    return (xa.T @ xa / N).astype(np.float32), (xg.T @ xg / N).astype(
        np.float32)


def _metas(setup, layer="layer0"):
    return setup["jmlp"].metas[layer], setup["mlp"].metas[layer]


def _t(x):
    return torch.from_numpy(np.array(x))


def _tt(tree):
    return {k: _tt(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# core/inverse: the eigen-state functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gamma", [1.7, 0.05])
def test_eigen_pair_state(setup, gamma):
    jmeta, meta = _metas(setup)
    a, g = _factor_pair(1, meta.a_dim, meta.g_dim)
    want = _np(jinverse.eigen_pair_state(jmeta, a, g, np.float32(gamma)))
    got = inverse.eigen_pair_state(meta, _t(a), _t(g),
                                   torch.tensor(gamma, dtype=torch.float32))
    # s and damp come from the (ascending) eigenvalues: basis-invariant
    _close(got["s"], want["s"], rtol=1e-4)
    _close(got["damp"], want["damp"], rtol=1e-4)
    v = np.random.default_rng(2).standard_normal(
        (meta.a_dim, meta.g_dim)).astype(np.float32)
    _close(inverse.apply_eigen(meta, got, _t(v)),
           jinverse.apply_eigen(jmeta, want, v), rtol=1e-4)
    # carried across, JAX's own basis gives JAX's apply at rtol 1e-5
    _close(inverse.apply_eigen(meta, _tt(want), _t(v)),
           jinverse.apply_eigen(jmeta, want, v))


def test_eigen_pair_multi_shares_one_eigh(setup):
    jmeta, meta = _metas(setup, "layer1")
    a, g = _factor_pair(3, meta.a_dim, meta.g_dim)
    gammas = np.array([1.7, 1.2, 2.4], np.float32)
    want = _np(jinverse.eigen_pair_multi(jmeta, a, g, jnp.asarray(gammas)))
    got = inverse.eigen_pair_multi(meta, _t(a), _t(g), _t(gammas))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    _close(got["s"], want["s"], rtol=1e-4)
    _close(got["damp"], want["damp"], rtol=1e-4)
    v = np.random.default_rng(4).standard_normal(
        (meta.a_dim, meta.g_dim)).astype(np.float32)
    for c in range(3):
        one = inverse.eigen_pair_state(meta, _t(a), _t(g), _t(gammas[c]))
        pick = {k: x[c] for k, x in got.items()}
        # the shared eigh gives each candidate's own state
        for k in one:
            assert torch.equal(pick[k], one[k]), k
        _close(inverse.apply_eigen(meta, pick, _t(v)),
               jinverse.apply_eigen(jmeta, {k: x[c] for k, x in
                                            want.items()}, v), rtol=1e-4)


def test_eigen_rescale_from_carried_basis(setup):
    jmeta, meta = _metas(setup)
    a, g = _factor_pair(5, meta.a_dim, meta.g_dim)
    eig = _np(jinverse.eigen_pair_state(jmeta, a, g, np.float32(1.7)))
    grad = np.random.default_rng(6).standard_normal(
        (meta.a_dim, meta.g_dim)).astype(np.float32)
    eps = np.float32(0.95)
    want = _np(jinverse.eigen_rescale(jmeta, eig, grad, eps))
    got = inverse.eigen_rescale(meta, _tt(eig), _t(grad),
                                 torch.tensor(eps))
    _close_tree(got, want)
    # the squares make s independent of the basis's column signs
    flip = np.where(np.arange(meta.a_dim) % 2 == 0, -1.0, 1.0).astype(
        np.float32)
    flipped = dict(_tt(eig), qa=_t(eig["qa"] * flip[None, :]))
    _close(inverse.eigen_rescale(meta, flipped, _t(grad),
                                 torch.tensor(eps))["s"],
           want["s"])


@pytest.mark.parametrize("gamma", [1.0 / 256, 1.0 / 64, 0.25, 4.0])
def test_eigen_apply_matches_eigh_inverse_apply(setup, gamma):
    """Right after a refresh, the eigen apply is the damped eigh inverse
    apply (the reference's eigen≡eigh invariant), within 5e-6·κ.  The
    factors' spectra span three decades, so small γ raises κ (to about 13
    at γ = 1/256); measured: at most 2.3e-6 normwise for κ from 1 to 13,
    where the reference's own eigen apply differs from its eigh apply by up
    to 2.5e-6."""
    jmeta, meta = _metas(setup, "layer1")
    rng = np.random.default_rng(7)
    xa = rng.standard_normal((N, meta.a_dim)) * np.logspace(0, -3, meta.a_dim)
    xg = rng.standard_normal((N, meta.g_dim)) * np.logspace(-2, -5, meta.g_dim)
    a = (xa.T @ xa / N).astype(np.float32)
    g = (xg.T @ xg / N).astype(np.float32)
    v = np.random.default_rng(8).standard_normal(
        (meta.a_dim, meta.g_dim)).astype(np.float32)
    inv = jinverse.damped_pair_inverse(jmeta, a, g, np.float32(gamma),
                                       method="eigh")
    want = np.asarray(jinverse.apply_block_inverse(jmeta, inv, v))
    eig = inverse.eigen_pair_state(meta, _t(a), _t(g),
                                   torch.tensor(gamma, dtype=torch.float32))
    sd = (eig["s"] + eig["damp"]).numpy()
    kappa = float(sd.max() / sd.min())
    _close(inverse.apply_eigen(meta, eig, _t(v)), want, rtol=5e-6 * kappa)


# ---------------------------------------------------------------------------
# DenseKronecker: the eigen and fused methods against the JAX block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layer", ["layer0", "layer3"])
def test_dense_kronecker_eigen_methods(setup, layer):
    jmeta, meta = _metas(setup, layer)
    jblk = JDense(jmeta, JKFACConfig(**EIGEN))
    blk = DenseKronecker(meta, KFACConfig(**EIGEN), "cpu")
    _close_tree(blk.eigen_identity(), _np(jblk.eigen_identity()))
    a, g = _factor_pair(9, meta.a_dim, meta.g_dim)
    fac = {"a": a, "g": g}
    jeig = _np(jblk.eigen_state(fac, np.float32(1.3)))
    eig = blk.eigen_state(_tt(fac), torch.tensor(1.3))
    _close(eig["s"] + eig["damp"], jeig["s"] + jeig["damp"], rtol=1e-4)
    rng = np.random.default_rng(10)
    v = rng.standard_normal((meta.a_dim, meta.g_dim)).astype(np.float32)
    # the kernel route on the block's own basis, against JAX's apply
    _close(blk.precondition_eigen(eig, _t(v)),
           jblk.precondition_eigen(jeig, v), rtol=1e-4)
    # from JAX's basis: rescale_step, then the apply
    eps = np.float32(0.95)
    jeig2 = _np(jblk.rescale_step(jeig, v, eps))
    eig2 = blk.rescale_step(_tt(jeig), _t(v), torch.tensor(eps))
    _close_tree(eig2, jeig2)
    _close(blk.precondition_eigen(eig2, _t(v)),
           jblk.precondition_eigen(jeig2, v))
    gammas = np.array([1.3, 1.1, 1.5], np.float32)
    jm = _np(jblk.eigen_state_multi(fac, jnp.asarray(gammas)))
    m = blk.eigen_state_multi(_tt(fac), _t(gammas))
    _close(m["s"] + m["damp"], jm["s"] + jm["damp"], rtol=1e-4)


@pytest.mark.parametrize("eigen", [False, True])
def test_dense_kronecker_precond_momentum(setup, eigen):
    jmeta, meta = _metas(setup, "layer2")
    jblk = JDense(jmeta, JKFACConfig())
    blk = DenseKronecker(meta, KFACConfig(), "cpu")
    rng = np.random.default_rng(11)
    a, g = _factor_pair(12, meta.a_dim, meta.g_dim)
    if eigen:
        inv = _np(jinverse.eigen_pair_state(jmeta, a, g, np.float32(1.3)))
    else:
        inv = _np(jinverse.damped_pair_inverse(jmeta, a, g, np.float32(1.3),
                                               method="ns", iters=12))
    v, mom = (rng.standard_normal((meta.a_dim, meta.g_dim)).astype(
        np.float32) for _ in range(2))
    alpha, mu = np.float32(-0.02), np.float32(0.9)
    want_d, want_sq = jblk.precond_momentum(inv, v, mom, alpha, mu,
                                            eigen=eigen)
    d, sq = blk.precond_momentum(_tt(inv), _t(v), _t(mom),
                                 torch.tensor(alpha), torch.tensor(mu),
                                 eigen=eigen)
    _close(d, want_d)
    _close(sq, want_sq)


# ---------------------------------------------------------------------------
# the engine: eigen-mode stages and apply_update_fused from one state
# ---------------------------------------------------------------------------

def _engines(setup, **kw):
    return (JEngine(setup["jmlp"], JKFACConfig(**kw), family="bernoulli"),
            KFACEngine(setup["mlp"], KFACConfig(**kw), family="bernoulli",
                       device="cpu"))


def _jax_state(setup, jeng, *, rescale=False):
    """One stats pass + refresh (+ the eigen rescale), then a nonzero
    momentum tangent, so every term of the update is exercised."""
    s = setup
    jb = s["jdata"].batch(0)
    jstate = jeng.init(s["jparams"], jb)
    jstate, jgrads, _ = jax.jit(jeng.stats_grads)(jstate, s["jparams"], jb,
                                                  _step_key(0))
    jstate = jax.jit(jeng.refresh_inverses)(jstate)
    if rescale:
        jstate = jax.jit(jeng.rescale_step)(jstate, jgrads)
    rng = np.random.default_rng(3)
    delta0 = {k: jnp.asarray((rng.standard_normal(p.shape) * 1e-2).astype(
        np.float32)) for k, p in _np(s["jparams"]).items()}
    return jstate.replace(delta0=delta0, m_delta=jnp.float32(-2.5)), jgrads


def _port_state(jstate):
    return state_from_numpy(vars(_np(jstate)), "cpu")


def test_state_from_numpy_carries_an_eigen_state(setup):
    jeng, eng = _engines(setup, **EIGEN)
    jstate, _ = _jax_state(setup, jeng)
    state = _port_state(jstate)
    for name, blk in eng.blocks.items():
        m = blk.meta
        assert {k: tuple(v.shape) for k, v in state.inv[name].items()} == {
            "qa": (m.a_dim, m.a_dim), "qg": (m.g_dim, m.g_dim),
            "s": (m.a_dim, m.g_dim), "damp": (m.a_dim, m.g_dim)}
        assert all(v.dtype == torch.float32 for v in state.inv[name].values())
    _close_tree(state.inv, _np(jstate.inv), rtol=0)
    # the sweep's candidate states carry their leading 3
    _, ji3 = jax.jit(jeng.refresh_multi)(jstate)
    i3 = state_from_numpy(dict(vars(_np(jstate)), inv=_np(ji3)), "cpu").inv
    assert tuple(i3["layer0"]["qa"].shape) == (3, DIMS[0] + 1, DIMS[0] + 1)
    _close_tree(i3, _np(ji3), rtol=0)


def test_rescale_step(setup):
    s = setup
    jeng, eng = _engines(s, **EIGEN)
    jstate, jgrads = _jax_state(s, jeng)
    want = jax.jit(jeng.rescale_step)(jstate, jgrads)
    got = eng.rescale_step(_port_state(jstate),
                           params_from_numpy(_np(jgrads), "cpu"))
    _close_tree(got.inv, _np(want.inv))
    # blkdiag: a no-op
    jeng_b, eng_b = _engines(s, **BASE)
    st = _port_state(_jax_state(s, jeng_b)[0])
    assert eng_b.rescale_step(st, None) is st


@pytest.mark.parametrize("kw, rescale, update", [
    (BASE, False, "precondition+quadratic_model_lr_momentum"),
    (EIGEN, True, "precondition+quadratic_model_lr_momentum"),
    (FUSED, False, "fused_precondition_momentum_clip"),
])
def test_pipeline_stages(setup, kw, rescale, update):
    """Each path runs only its own stages: the EKFAC rescale in eigen mode
    alone, the fused chain in place of the quadratic model."""
    opt = kfac(setup["mlp"], KFACConfig(**kw), family="bernoulli",
               device="cpu")
    names = [st.name for st in opt.update.__self__.stages]
    assert names == ["estimate_stats", "scheduled_inverse_refresh",
                     *(["eigen_rescale"] if rescale else []), update,
                     "adapt_lambda"]


@pytest.mark.parametrize("n_cand", [1, 3])
def test_eigen_apply_update(setup, n_cand):
    s = setup
    jeng, eng = _engines(s, **EIGEN)
    jb, b = s["jdata"].batch(0), s["data"].batch(0)
    jstate, jgrads = _jax_state(s, jeng, rescale=True)
    state = _port_state(jstate)
    grads = params_from_numpy(_np(jgrads), "cpu")
    japply = jax.jit(jeng.apply_update)
    if n_cand == 1:
        jp, js, jm = japply(jstate, s["jparams"], jgrads, jb, None)
        p, st, m = eng.apply_update(state, s["params"], grads, b, None)
    else:
        jgs, ji3 = jax.jit(jeng.refresh_multi)(jstate)
        jp, js, jm = japply(
            jstate, s["jparams"], jgrads, jb, None,
            cand_inv=[jax.tree.map(lambda x: x[c], ji3) for c in range(3)],
            gammas=jgs)
        i3 = _tt(_np(ji3))
        p, st, m = eng.apply_update(
            state, s["params"], grads, b, None,
            cand_inv=[{k: {kk: vv[c] for kk, vv in v.items()}
                       for k, v in i3.items()} for c in range(3)],
            gammas=_t(np.asarray(jgs)))
        assert float(m["gamma"]) == pytest.approx(float(jm["gamma"]),
                                                  rel=1e-6)
    for k in ("alpha", "mu", "m_delta", "gamma", "grad_norm", "delta_norm"):
        _close(m[k], jm[k], rtol=1e-4)
    _close_tree(p, _np(jp), rtol=1e-4)
    _close_tree(st.delta0, _np(js.delta0), rtol=1e-4)
    _close_tree(st.inv, _np(js.inv), rtol=1e-4)


CLIPS = [dict(), dict(clip_delta_norm=1e-3), dict(kl_clip=1e-3)]


@pytest.mark.parametrize("mom", [0.0, 0.9])
@pytest.mark.parametrize("clip", CLIPS, ids=["none", "norm", "kl"])
@pytest.mark.parametrize("inv_mode", ["blkdiag", "eigen"])
def test_apply_update_fused(setup, inv_mode, clip, mom):
    s = setup
    kw = dict(BASE, inv_mode=inv_mode, use_rescale=False, fixed_lr=0.02,
              fixed_momentum=mom, **clip)
    jeng, eng = _engines(s, **kw)
    jb, b = s["jdata"].batch(0), s["data"].batch(0)
    jstate, jgrads = _jax_state(s, jeng, rescale=inv_mode == "eigen")
    jp, js, jm = jax.jit(jeng.apply_update_fused)(jstate, s["jparams"],
                                                  jgrads, jb, None)
    p, st, m = eng.apply_update_fused(_port_state(jstate), s["params"],
                                      params_from_numpy(_np(jgrads), "cpu"),
                                      b, None)
    assert set(m) == set(jm)
    assert ("nu" in m) == bool(clip)
    for k in m:
        assert m[k].dim() == 0 and isinstance(m[k], torch.Tensor), k
        _close(m[k], jm[k])
    if clip:
        assert float(m["nu"]) < 1.0          # the clip bites
    _close_tree(p, _np(jp))
    _close_tree(st.delta0, _np(js.delta0))   # the pre-clip velocity
    assert float(st.m_delta) == -1.0 and int(st.step) == int(js.step)


# ---------------------------------------------------------------------------
# the slice as a whole: Trainer.fit against a live JAX Trainer.fit
# ---------------------------------------------------------------------------

STEPS = 25            # warmup and T3 refreshes, T1 lambda steps, the sweep
_JAX_RUNS = {}


def _jax_run(setup, path):
    """A live JAX ``Trainer.fit`` of the golden setup on ``path``,
    recording every optimizer step's inputs and outputs."""
    if path in _JAX_RUNS:
        return _JAX_RUNS[path]
    s = setup
    opt = joptimizers.kfac(s["jmlp"], JKFACConfig(**PATHS[path]),
                           family="bernoulli")
    record = []

    def update(grads, state, params, batch, rng):
        out = opt.update(grads, state, params, batch, rng)
        record.append(_np((state, params, out[0], out[1])))
        return out

    tr = JTrainer(s["jmlp"], dataclasses.replace(opt, update=update),
                  JTrainConfig(steps=STEPS, seed=0, log_every=10_000),
                  None, None)
    hist = tr.fit(s["jparams"], s["jdata"], steps=STEPS,
                  log=lambda *_: None)["history"]
    _JAX_RUNS[path] = (hist, record)
    return hist, record


PATHS = {"eigen": EIGEN, "fused": FUSED}
KEYS = ("loss", "lam", "gamma", "alpha", "mu", "rho", "nu", "m_delta")


def _port_opt(setup, path):
    return kfac(setup["mlp"], KFACConfig(**PATHS[path]), family="bernoulli",
                device="cpu")


def _same_keys(got, want):
    assert {k for k in KEYS if k in got} == {k for k in KEYS if k in want}


@pytest.mark.parametrize("path", ["eigen", "fused"])
def test_each_step_matches_jax_from_its_state(setup, path):
    """Step for step from the reference's state (JAX's eigenbases carried
    across): the metrics within rtol 1e-3 at every step and the new
    parameters within 1e-4 (eigen; its refresh steps recompute the bases
    with the port's eigh) or 1e-5 (fused)."""
    want, record = _jax_run(setup, path)
    opt = _port_opt(setup, path)
    v = {name: torch.from_numpy(np.random.default_rng(13).standard_normal(
        (m.a_dim, m.g_dim)).astype(np.float32))
        for name, m in setup["mlp"].metas.items()}
    eng = opt.engine
    for step, (jstate, jparams, jnew, jout) in enumerate(record):
        params = params_from_numpy(jparams, "cpu")
        if step == 0:
            opt.init(params, setup["data"].batch(0))
        new, state, m = opt.update(
            None, state_from_numpy(vars(jstate), "cpu"), params,
            setup["data"].batch(step),
            lambda shape, step=step: _uniforms(0, step, shape))
        _same_keys(m, want[step])
        for k in KEYS:
            if k in m:
                assert float(m[k]) == pytest.approx(want[step][k],
                                                    rel=1e-3), (step, k)
        _close_tree(new, jnew, rtol=1e-4 if path == "eigen" else 1e-5)
        jinv = _tt(jout.inv)
        for name, blk in eng.blocks.items():
            if path == "eigen":      # compared through their apply
                _close(blk.precondition_eigen(state.inv[name], v[name]),
                       blk.precondition_eigen(jinv[name], v[name]),
                       rtol=1e-3)
            else:
                _close_tree(state.inv[name], jinv[name], rtol=1e-3)
        assert int(state.step) == int(jout.step) == step + 1


@pytest.mark.parametrize("path", ["eigen", "fused"])
def test_trajectory_matches_live_jax(setup, path):
    """Free-running, both trainers from one start with JAX's uniforms.

    Bands, each about 10x the largest difference measured on this setup:
    eigen mode keeps the 2x2 momentum solve, but it is far better
    conditioned here than the blkdiag path's (``test_torch_kfac_parity``):
    loss within 1e-4 at every step (measured 1.1e-5), λ and γ within 1e-6
    (measured equal), α/μ/ρ/M(δ) within 1e-4 through step 4 (measured
    7.6e-5) and 1e-2 through step 24 (measured 3.4e-3, α at step 21), the
    same γ at the step-20 sweep.  The fused path has no solve (α, μ and
    M(δ) are constants): loss within 1e-5 (measured 3.4e-7), λ 1e-6, ν 1e-5
    (measured 1.8e-7); ρ is there the difference of two losses near 90, so
    it is held to an absolute 1e-6 of the loss (measured 2.3e-5 against
    9e-5)."""
    want, _ = _jax_run(setup, path)
    tr = Trainer(setup["mlp"], _port_opt(setup, path),
                 TrainConfig(steps=STEPS, seed=0, log_every=10_000),
                 noise=lambda step, shape: _uniforms(0, step, shape),
                 device="cpu")
    got = tr.fit(setup["params"], setup["data"], steps=STEPS,
                 log=lambda *_: None)["history"]
    assert len(got) == len(want) == STEPS
    if path == "fused":
        bands = {"loss": 1e-5, "lam": 1e-6, "gamma": 1e-6, "nu": 1e-5,
                 "alpha": 0.0, "mu": 0.0, "m_delta": 0.0}
    else:
        bands = {"loss": 1e-4, "lam": 1e-6, "gamma": 1e-6}
    for step in range(STEPS):
        g, w = got[step], want[step]
        _same_keys(g, w)
        for k, rel in bands.items():
            if k in w:
                assert g[k] == pytest.approx(w[k], rel=rel), (step, k)
        if path == "fused":
            if "rho" in w:
                assert g["rho"] == pytest.approx(w["rho"],
                                                 abs=1e-6 * w["loss"]), step
            continue
        for k in ("alpha", "mu", "rho", "m_delta"):
            if k in w:
                assert g[k] == pytest.approx(
                    w[k], rel=1e-4 if step <= 4 else 1e-2), (step, k)
    assert got[20]["gamma"] == pytest.approx(want[20]["gamma"], rel=1e-6)
    assert got[-1]["loss"] < got[0]["loss"]
