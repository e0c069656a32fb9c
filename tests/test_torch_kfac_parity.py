"""The port against a live run of the JAX reference, module by module and as
a whole, on the reduced autoencoder (64-32-16-8 mirrored) on the CPU.

Inputs come from numpy seeds and JAX's own draws: the parameters of
``MLP.init_params(PRNGKey(0), sparse=True)`` and the uniforms behind the
sampled targets (``jax.random.bernoulli`` is ``uniform(key) < p``) are
handed to the port as numpy.  Nothing is pinned bitwise, and the stored
``GOLDEN`` constants of ``tests/test_golden.py`` are not used.

Tolerances: per operation rtol 1e-5 with an atol of 1e-5 of the array's
largest magnitude (entries far below the array's scale carry the rounding
of the large ones).  Eigh-based inverses, and the updates built on them,
get 1e-4: the two LAPACK eigensolvers round differently where eigenvalues
lie close together.
Trajectories (with momentum, and without: ``use_momentum=False``): step
for step from the reference's state, loss, lambda, gamma, alpha, mu and rho
within rtol 1e-3 at every step; free-running, the bands of
``test_trajectory_matches_live_jax`` (its docstring says why alpha and mu
cannot be held to 1e-3 past the first steps there).
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
from repro.core import factors as jfactors
from repro.core import fisher as jfisher
from repro.core import inverse as jinverse
from repro.data.pipeline import SyntheticAutoencoderData as JData
from repro.models.mlp import MLP as JMLP
from repro.models.mlp import autoencoder_dims as j_dims
from repro.optimizers.kfac import KFACEngine as JEngine
from repro.training.trainer import Trainer as JTrainer
from repro_torch.configs.autoencoder import reduced
from repro_torch.configs.base import KFACConfig, TrainConfig
from repro_torch.convert import params_from_numpy, state_from_numpy
from repro_torch.core import factors, fisher
from repro_torch.core import inverse
from repro_torch.core.blocks import DenseKronecker
from repro_torch.data.pipeline import SyntheticAutoencoderData
from repro_torch.models.mlp import MLP, autoencoder_dims
from repro_torch.optimizers.kfac import KFACEngine, kfac
from repro_torch.training.trainer import Trainer

torch.set_num_threads(1)

DIMS = autoencoder_dims(reduced())
N, LATENT, DATA_SEED = 256, 8, 7


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
    """The uniforms behind step ``step``'s sampled targets in the
    reference: key fold_in(fold_in(PRNGKey(seed), step), 1)."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                step), 1)
    return torch.from_numpy(np.array(
        jax.random.uniform(key, shape, jnp.float32)))


def _jax_noise(seed):
    return lambda step, shape: _uniforms(seed, step, shape)


@pytest.fixture(scope="module")
def setup():
    """Both models, both datasets, JAX's parameters in both."""
    assert j_dims(j_reduced()) == DIMS
    jmlp = JMLP(DIMS, nonlin="tanh", loss="bernoulli")
    jparams = jmlp.init_params(jax.random.PRNGKey(0), sparse=True)
    jdata = JData(DIMS[0], LATENT, N, seed=DATA_SEED)
    mlp = MLP(DIMS, device="cpu")
    params = params_from_numpy(_np(jparams), "cpu")
    data = SyntheticAutoencoderData(DIMS[0], LATENT, N, seed=DATA_SEED,
                                    device="cpu")
    return dict(jmlp=jmlp, jparams=jparams, jdata=jdata, mlp=mlp,
                params=params, data=data)


def _step_key(step, seed=0):
    return jax.random.fold_in(jax.random.PRNGKey(seed), step)


# ---------------------------------------------------------------------------
# module by module
# ---------------------------------------------------------------------------

def test_data_is_bitwise_the_reference(setup):
    np.testing.assert_array_equal(setup["data"].x, setup["jdata"].x)
    np.testing.assert_array_equal(setup["data"].batch(3)["x"].numpy(),
                                  np.asarray(setup["jdata"].batch(3)["x"]))


def test_logits_and_loss(setup):
    s = setup
    jb, b = s["jdata"].batch(0), s["data"].batch(0)
    _close(s["mlp"].logits(s["params"], b["x"]),
           s["jmlp"].logits(s["jparams"], jb["x"]))
    key = jax.random.fold_in(_step_key(0), 1)
    (jlt, jls), _ = s["jmlp"].loss(s["jparams"], None, jb, key)
    (lt, ls), _ = s["mlp"].loss(s["params"], None, b,
                                lambda shape: _uniforms(0, 0, shape))
    _close(lt, jlt)
    _close(ls, jls)


def test_probe_gradients(setup):
    s = setup
    jb, b = s["jdata"].batch(0), s["data"].batch(0)
    jmlp = s["jmlp"]
    key = jax.random.fold_in(_step_key(0), 1)
    jprobes = jmlp.make_probes(jmlp.probe_shapes(jb))

    def f(pr):
        (_, ls), aux = jmlp.loss(s["jparams"], pr, jb, key, mode="collect")
        return ls, aux

    _, vjp_fn, jaux = jax.vjp(f, jprobes, has_aux=True)
    (jg,) = vjp_fn(jnp.float32(1.0))

    probes = s["mlp"].make_probes(b)
    (_, ls), aux = s["mlp"].loss(s["params"], probes, b,
                                 lambda shape: _uniforms(0, 0, shape),
                                 mode="collect")
    g = dict(zip(probes, torch.autograd.grad(ls, list(probes.values()))))
    _close_tree(g, _np(jg))
    _close_tree({k: v["a"] for k, v in aux["recs"].items()},
                {k: v["a"] for k, v in _np(jaux["recs"]).items()})


def _engines(setup, **kw):
    jcfg = JKFACConfig(lambda_init=3.0, t3=5, eta=1e-5, **kw)
    cfg = KFACConfig(lambda_init=3.0, t3=5, eta=1e-5, **kw)
    return (JEngine(setup["jmlp"], jcfg, family="bernoulli"),
            KFACEngine(setup["mlp"], cfg, family="bernoulli", device="cpu"))


def _port_state(jstate):
    return state_from_numpy(vars(_np(jstate)), "cpu")


def test_stats_grads_two_steps(setup):
    """Two stats passes, so the second blends with eps = 1/2."""
    s = setup
    jeng, eng = _engines(s, inverse_method="eigh")
    jb, b = s["jdata"].batch(0), s["data"].batch(0)
    jstate = jeng.init(s["jparams"], jb)
    state = eng.init(s["params"], b)
    jstats = jax.jit(jeng.stats_grads)
    for step in range(2):
        jstate, jgrads, jm = jstats(jstate, s["jparams"], jb, _step_key(step))
        state, grads, m = eng.stats_grads(
            state, s["params"], b, lambda shape: _uniforms(0, step, shape))
    _close_tree(grads, _np(jgrads))
    _close_tree(state.factors, _np(jstate.factors))
    assert int(state.k_stats) == int(jstate.k_stats) == 2
    _close(state.loss_prev, jstate.loss_prev)
    _close(m["loss_sampled"], jm["loss_sampled"])


def _factor_pair(seed, meta):
    rng = np.random.default_rng(seed)
    xa = rng.standard_normal((N, meta.a_dim)).astype(np.float32)
    xg = rng.standard_normal((N, meta.g_dim)).astype(np.float32) * 1e-2
    return (xa.T @ xa / N).astype(np.float32), (xg.T @ xg / N).astype(
        np.float32)


@pytest.mark.parametrize("case", ["eigh", "ns-cold", "ns-hot",
                                  "ns-fallback"])
def test_damped_pair_inverse(setup, case):
    jmeta = setup["jmlp"].metas["layer0"]
    meta = setup["mlp"].metas["layer0"]
    a, g = _factor_pair(1, meta)
    gamma = np.float32(1.7)
    method = "eigh" if case == "eigh" else "ns"
    prev = None
    if case == "ns-hot":       # a nearby inverse: the safeguard accepts it
        prev = _np(jinverse.damped_pair_inverse(jmeta, a, g, 1.5,
                                                method="eigh"))
    elif case == "ns-fallback":  # far off: ||I - M x0|| >= 1, cold restart
        prev = {"a_inv": 10.0 * np.eye(meta.a_dim, dtype=np.float32),
                "g_inv": 10.0 * np.eye(meta.g_dim, dtype=np.float32)}
    want = jinverse.damped_pair_inverse(jmeta, a, g, gamma, method=method,
                                        iters=12, prev=prev)
    got = inverse.damped_pair_inverse(
        meta, torch.from_numpy(a), torch.from_numpy(g), torch.tensor(gamma),
        method=method, iters=12,
        prev=None if prev is None else {k: torch.from_numpy(v)
                                        for k, v in prev.items()})
    _close_tree(got, _np(want), rtol=1e-4 if method == "eigh" else 1e-5)
    if case == "ns-fallback":
        cold = inverse.damped_pair_inverse(
            meta, torch.from_numpy(a), torch.from_numpy(g),
            torch.tensor(gamma), method="ns", iters=12)
        _close_tree(got, {k: v.numpy() for k, v in cold.items()}, rtol=1e-7)


def _tangents(seed, params, k):
    rng = np.random.default_rng(seed)
    return [{n: (rng.standard_normal(p.shape) * 1e-2).astype(np.float32)
             for n, p in params.items()} for _ in range(k)]


@pytest.mark.parametrize("family", ["bernoulli", "categorical"])
def test_quad_logits(setup, family):
    s = setup
    jb, b = s["jdata"].batch(0), s["data"].batch(0)
    tans = _tangents(2, _np(s["jparams"]), 3)
    want = jfisher.quad_logits(lambda p: s["jmlp"].logits(p, jb["x"]),
                               s["jparams"], jb, tans, family)
    got = fisher.quad_logits(lambda p: s["mlp"].logits(p, b["x"]),
                             s["params"], b,
                             [params_from_numpy(t, "cpu") for t in tans],
                             family)
    _close(got, want)


def test_factor_statistics_and_apply(setup):
    """DenseKronecker's kernel route (factor_update on both sides,
    precondition) and the plain reference route it replaces (outer_sum /
    g_from_cotangent / blend, apply_block_inverse) against JAX's."""
    meta = setup["mlp"].metas["layer1"]
    jmeta = setup["jmlp"].metas["layer1"]
    rng = np.random.default_rng(5)
    f32 = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    a, cot = f32(N, meta.a_dim), f32(N, meta.g_dim) / N
    old = {"a": _factor_pair(6, meta)[0], "g": _factor_pair(6, meta)[1]}
    eps = np.float32(0.75)
    want = jfactors.blend(old, {"a": jfactors.outer_sum(a, "full", 1) / N,
                                "g": jfactors.g_from_cotangent(cot, jmeta, N)},
                          eps)
    blk = DenseKronecker(meta, KFACConfig(), "cpu")
    t = torch.from_numpy
    old_t = {k: t(v) for k, v in old.items()}
    args = (old_t, {"a": t(a)}, t(cot), N, torch.tensor(eps))
    _close_tree(blk.update_factors(*args), _np(want))
    plain = factors.blend(old_t, {"a": factors.outer_sum(t(a)) / N,
                                  "g": factors.g_from_cotangent(t(cot), meta,
                                                                N)},
                          args[-1])
    _close_tree(plain, _np(want))
    for k in (1, 2, 7, 100):
        _close(factors.decay_eps(torch.tensor(k, dtype=torch.int32), 0.95),
               jfactors.decay_eps(jnp.int32(k), 0.95))
    inv = {"a_inv": old["a"], "g_inv": old["g"]}
    v = f32(meta.a_dim, meta.g_dim)
    want = jinverse.apply_block_inverse(jmeta, inv, v)
    inv_t = {k: t(x) for k, x in inv.items()}
    _close(blk.precondition(inv_t, t(v)), want)
    _close(inverse.apply_block_inverse(meta, inv_t, t(v)), want)


def _jax_state_after_stats(setup, jeng):
    """One stats pass + refresh, then a nonzero momentum tangent and a
    quadratic-model value, so every term of the update is exercised."""
    s = setup
    jb = s["jdata"].batch(0)
    jstate = jeng.init(s["jparams"], jb)
    jstate, jgrads, _ = jax.jit(jeng.stats_grads)(jstate, s["jparams"], jb,
                                                  _step_key(0))
    jstate = jax.jit(jeng.refresh_inverses)(jstate)
    delta0 = jax.tree.map(jnp.asarray, _tangents(3, _np(s["jparams"]), 1)[0])
    jstate = jstate.replace(delta0=delta0, m_delta=jnp.float32(-2.5))
    return jstate, jgrads


@pytest.mark.parametrize("n_cand", [1, 3])
def test_apply_update(setup, n_cand):
    s = setup
    jeng, eng = _engines(s, inverse_method="eigh")
    jb, b = s["jdata"].batch(0), s["data"].batch(0)
    jstate, jgrads = _jax_state_after_stats(s, jeng)
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
        gs = torch.from_numpy(np.asarray(jgs))
        i3 = {k: {kk: torch.from_numpy(np.asarray(vv)) for kk, vv in v.items()}
              for k, v in ji3.items()}
        p, st, m = eng.apply_update(
            state, s["params"], grads, b, None,
            cand_inv=[{k: {kk: vv[c] for kk, vv in v.items()}
                       for k, v in i3.items()} for c in range(3)],
            gammas=gs)
        assert float(m["gamma"]) == pytest.approx(float(jm["gamma"]),
                                                  rel=1e-6)
    for k in ("alpha", "mu", "m_delta", "gamma", "grad_norm", "delta_norm"):
        _close(m[k], jm[k], rtol=1e-4)
    _close_tree(p, _np(jp), rtol=1e-4)
    _close_tree(st.delta0, _np(js.delta0), rtol=1e-4)
    _close_tree(st.inv, _np(js.inv), rtol=1e-4)
    assert int(st.step) == int(js.step)


def test_lambda_step(setup):
    s = setup
    jeng, eng = _engines(s, inverse_method="eigh")
    jb, b = s["jdata"].batch(0), s["data"].batch(0)
    jstate, jgrads = _jax_state_after_stats(s, jeng)
    jp, jstate, _ = jax.jit(jeng.apply_update)(jstate, s["jparams"], jgrads,
                                               jb, None)
    js, jrho = jax.jit(jeng.lambda_step)(jstate, jp, jb, _step_key(0))
    st, rho = eng.lambda_step(_port_state(jstate),
                              params_from_numpy(_np(jp), "cpu"), b, None)
    _close(rho, jrho)
    _close(st.lam, js.lam)


# ---------------------------------------------------------------------------
# the slice as a whole: Trainer.fit against a live JAX Trainer.fit
# ---------------------------------------------------------------------------

# (inverse method, steps, use_momentum); the ids are the first two
TRAJECTORIES = [pytest.param("eigh", 50, True, id="eigh-50"),
                pytest.param("ns", 25, True, id="ns-25"),
                pytest.param("eigh", 25, False, id="eigh-25-no_momentum")]
_JAX_RUNS = {}


def _jax_run(setup, method, steps, momentum=True):
    """A live JAX ``Trainer.fit`` of the golden setup (tests/test_golden.py
    ``golden_run``: eigh or ns, lambda_init=3, t3=5, eta=1e-5, N=256,
    seed 7), with or without momentum, recording every optimizer step's
    inputs and outputs."""
    if (method, steps, momentum) in _JAX_RUNS:
        return _JAX_RUNS[(method, steps, momentum)]
    s = setup
    cfg = JKFACConfig(inv_mode="blkdiag", inverse_method=method,
                      lambda_init=3.0, t3=5, eta=1e-5,
                      use_momentum=momentum)
    opt = joptimizers.kfac(s["jmlp"], cfg, family="bernoulli")
    record = []

    def update(grads, state, params, batch, rng):
        out = opt.update(grads, state, params, batch, rng)
        record.append(_np((state, params, out[0], out[1])))
        return out

    tr = JTrainer(s["jmlp"], dataclasses.replace(opt, update=update),
                  JTrainConfig(steps=steps, seed=0, log_every=10_000),
                  None, None)
    hist = tr.fit(s["jparams"], s["jdata"], steps=steps,
                  log=lambda *_: None)["history"]
    _JAX_RUNS[(method, steps, momentum)] = (hist, record)
    return hist, record


def _port_opt(setup, method, momentum=True):
    cfg = KFACConfig(inv_mode="blkdiag", inverse_method=method,
                     lambda_init=3.0, t3=5, eta=1e-5, use_momentum=momentum)
    return kfac(setup["mlp"], cfg, family="bernoulli", device="cpu")


@pytest.mark.parametrize("method,steps,momentum", TRAJECTORIES)
def test_each_step_matches_jax_from_its_state(setup, method, steps,
                                              momentum):
    """Step for step: every optimizer step of the port, started from the
    reference's state and parameters at that step with the same uniforms,
    gives the reference's step — stats, the warmup / T3 refreshes, the
    step-20 gamma sweep and the T1 lambda rule included, with momentum and
    without (mu then 0)."""
    want, record = _jax_run(setup, method, steps, momentum)
    opt = _port_opt(setup, method, momentum)
    for step, (jstate, jparams, jnew, jout) in enumerate(record):
        params = params_from_numpy(jparams, "cpu")
        if step == 0:
            opt.init(params, setup["data"].batch(0))
        new, state, m = opt.update(
            None, state_from_numpy(vars(jstate), "cpu"), params,
            setup["data"].batch(step),
            lambda shape, step=step: _uniforms(0, step, shape))
        for k in ("loss", "lam", "gamma", "alpha", "mu", "rho"):
            assert (k in m) == (k in want[step]), (step, k)
            if k in m:
                assert float(m[k]) == pytest.approx(want[step][k],
                                                    rel=1e-3), (step, k)
        _close_tree(new, jnew, rtol=1e-4)
        _close_tree(state.inv, jout.inv, rtol=1e-3)
        assert int(state.step) == int(jout.step) == step + 1


@pytest.mark.parametrize("method,steps,momentum", TRAJECTORIES)
def test_trajectory_matches_live_jax(setup, method, steps, momentum):
    """Free-running: both trainers from the same start, JAX's uniforms
    injected every step.  alpha and mu are held only through step 4: the
    2x2 momentum solve amplifies rounding about tenfold per step (the
    reference against itself, parameters perturbed by 1e-7, differs by
    1e-2 in alpha from step 12), and one target drawn at step 3 lands on
    the other side of sigmoid(z) in the two implementations.  Without
    momentum there is no 2x2 solve, and the loss is held to 1e-4 at every
    step, alpha to 1e-3 through step 11."""
    want, _ = _jax_run(setup, method, steps, momentum)
    opt = _port_opt(setup, method, momentum)
    tr = Trainer(setup["mlp"], opt, TrainConfig(steps=steps, seed=0,
                                                log_every=10_000),
                 noise=_jax_noise(0), device="cpu")
    got = tr.fit(setup["params"], setup["data"], steps=steps,
                 log=lambda *_: None)["history"]
    assert len(got) == len(want) == steps
    for step in range(20):
        for k in ("loss", "lam", "gamma", "alpha", "mu", "rho"):
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
    if not momentum:
        # no 2x2 solve to amplify rounding: over 25 steps the loss stayed
        # within 1.6e-5 of the reference's, alpha within 1e-4 through step
        # 11 (7e-4 at step 12, 6e-3 at step 24)
        for step in range(steps):
            assert got[step]["loss"] == pytest.approx(want[step]["loss"],
                                                      rel=1e-4), step
        for step in range(12):
            assert got[step]["alpha"] == pytest.approx(want[step]["alpha"],
                                                       rel=1e-3), step
    # the step-20 gamma sweep picks the same candidate
    assert got[20]["gamma"] == pytest.approx(want[20]["gamma"], rel=1e-6)
    assert want[20]["gamma"] != pytest.approx(want[19]["gamma"], rel=1e-3)
    for step in (29, 39, 49):
        if step < steps:
            assert got[step]["loss"] == pytest.approx(want[step]["loss"],
                                                      rel=0.02), step
    assert got[-1]["loss"] < 0.5 * got[0]["loss"]
