"""The port's optimizer modes, module by module, against the JAX reference
on the CPU: the config fields and ``LayerMeta``'s planner fields, the
refresh planner (``repro_torch/distributed/plan.py``), the τ1 sub-batch,
and the Gaussian autoencoder loss (its NLL, its sampled targets, its
exact-Fisher quadratic and Theorem 1's invariance to an affine transform
of the inputs).

The planner is pure Python in both packages: its costs, bins and groups
must be equal, not close, for every metas set tested (the golden, race
and full-width autoencoders and reduced whisper-small) at n ∈ {1, 3, 5,
20}.  The sub-batch is a strided view of every batch leaf: equal bitwise.
Tolerances: per operation rtol 1e-5 with an atol of 1e-5 of the array's
largest magnitude; the normals from JAX's uniforms within 3e-5 absolute
(``torch.erfinv`` against XLA's ``erf_inv``: 2.2e-5 seen at |n| ≤ 5.4 on
a (1024, 784) draw); Theorem 1's check at the reference test's own
tolerance (rtol 5e-2, atol 5e-4: tiny damping of near-singular factors).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as j_reduced
from repro.configs.autoencoder import CONFIG as J_AE_CONFIG
from repro.configs.base import KFACConfig as JKFACConfig
from repro.core import fisher as jfisher
from repro.core.tags import LayerMeta as JLayerMeta
from repro.data.pipeline import SyntheticAutoencoderData as JData
from repro.distributed import plan as jplan
from repro.models.lm import LM as JLM
from repro.models.mlp import MLP as JMLP
from repro.optimizers.kfac import KFACEngine as JEngine
from repro_torch.configs import get_reduced_config
from repro_torch.configs.autoencoder import CONFIG
from repro_torch.configs.base import KFACConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import factors as F
from repro_torch.core import fisher
from repro_torch.core import inverse
from repro_torch.core.tags import LayerMeta
from repro_torch.data.pipeline import SyntheticAutoencoderData
from repro_torch.distributed import plan
from repro_torch.models.lm import LM
from repro_torch.models.mlp import MLP, autoencoder_dims, normal_from_uniforms
from repro_torch.optimizers.kfac import KFACEngine
from test_torch_tridiag import _close, _np, _t

torch.set_num_threads(1)

GOLDEN_DIMS = [64, 32, 16, 8, 16, 32, 64]
RACE_DIMS = [64, 48, 24, 12, 24, 48, 64]
NORMAL_TOL = 3e-5


# ---------------------------------------------------------------------------
# the config and the metas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(tau1=0.125), dict(tau2=0.25),
                                dict(stats_period=2),
                                dict(refresh_mode="staggered"),
                                dict(staggered_inverse=True),
                                dict(ns_hot_iters=2)])
def test_config_accepts_the_modes(kw):
    cfg = KFACConfig(**kw)
    for k, v in kw.items():
        assert getattr(cfg, k) == v


@pytest.mark.parametrize("kw", [dict(refresh_mode="sharded"),
                                dict(refresh_mode="overlap"),
                                dict(refresh_mode="sharded",
                                     fused_stats=True)])
def test_config_still_refuses_the_distributed_modes(kw):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        KFACConfig(**kw)


def test_config_fields_are_the_reference():
    """Every field of the port's ``KFACConfig`` is the reference's, with
    the reference's default; ``ns_hot_iters`` and ``staggered_inverse``
    among them."""
    mine = {f.name: f.default for f in dataclasses.fields(KFACConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JKFACConfig)}
    assert {"ns_hot_iters", "staggered_inverse"} <= set(mine)
    for name, default in mine.items():
        assert ref[name] == default, name


def test_layer_meta_has_the_planner_fields():
    mine = {f.name: f.default for f in dataclasses.fields(LayerMeta)}
    ref = {f.name: f.default for f in dataclasses.fields(JLayerMeta)}
    for name in ("n_expert", "a_blocks", "g_blocks"):
        assert mine[name] == ref[name], name


@pytest.mark.parametrize("kw, mode", [
    (dict(), "serial"), (dict(refresh_mode="staggered"), "staggered"),
    (dict(staggered_inverse=True), "staggered"),
    (dict(refresh_mode="staggered", staggered_inverse=True), "staggered")])
def test_engine_resolves_refresh_mode(kw, mode):
    """The legacy ``staggered_inverse=True`` is ``refresh_mode=
    "staggered"``, as the reference resolves it."""
    mlp = MLP(GOLDEN_DIMS, device="cpu")
    eng = KFACEngine(mlp, KFACConfig(**kw), family="bernoulli", device="cpu")
    jeng = JEngine(JMLP(GOLDEN_DIMS), JKFACConfig(**kw), family="bernoulli")
    assert eng.refresh_mode == jeng.refresh_mode == mode


def test_engine_refuses_an_unknown_refresh_mode():
    cfg = KFACConfig()
    object.__setattr__(cfg, "refresh_mode", "round_robin")
    with pytest.raises(ValueError, match="unknown refresh_mode"):
        KFACEngine(MLP(GOLDEN_DIMS, device="cpu"), cfg, device="cpu")


# ---------------------------------------------------------------------------
# the refresh planner
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _blocks(name):
    """(port blocks, JAX blocks) of one metas set."""
    if name == "whisper":
        lm, jl = (LM(get_reduced_config("whisper-small"), device="cpu"),
                  JLM(j_reduced("whisper-small")))
        return (KFACEngine(lm, KFACConfig(), device="cpu").blocks,
                JEngine(jl, JKFACConfig()).blocks)
    dims = {"golden": GOLDEN_DIMS, "race": RACE_DIMS,
            "full": autoencoder_dims(CONFIG)}[name]
    if name == "full":
        assert autoencoder_dims(J_AE_CONFIG) == dims
    return (KFACEngine(MLP(dims, device="cpu"), KFACConfig(),
                       device="cpu").blocks,
            JEngine(JMLP(dims), JKFACConfig()).blocks)


METAS = ["golden", "race", "full", "whisper"]


@pytest.mark.parametrize("name", METAS)
def test_block_cost_matches_jax(name):
    blocks, jblocks = _blocks(name)
    assert sorted(blocks) == sorted(jblocks)
    for n in blocks:
        assert plan.block_cost(blocks[n].meta) == jplan.block_cost(
            jblocks[n].meta), n


@pytest.mark.parametrize("n", [1, 3, 5, 20])
@pytest.mark.parametrize("name", METAS)
@pytest.mark.parametrize("chain", [False, True])
def test_build_plan_matches_jax(name, n, chain):
    """Groups, owners and costs equal JAX's; the LPT bound
    ``max_load − max_cost ≤ min_load`` holds."""
    blocks, jblocks = _blocks(name)
    got = plan.build_plan(blocks, n, chain=chain)
    want = jplan.build_plan(jblocks, n, chain=chain)
    assert got.n_shards == want.n_shards == n
    assert got.groups() == want.groups()
    assert dict(got.owners) == dict(want.owners)
    assert dict(got.costs) == dict(want.costs)
    loads = [sum(got.costs[b] for b in grp) for grp in got.groups()]
    assert max(loads) - max(got.costs.values()) <= min(loads)
    assert sorted(x for g in got.groups() for x in g) == sorted(got.costs)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7])
def test_bin_pack_matches_jax_on_ties_and_kinds(n):
    """Equal costs (ties broken by name, then bin index), diag and block
    factor kinds, stacked and expert lead dims."""
    def metas(M):
        return [M(name="a", param_path=("a",), d_in=64, d_out=32),
                M(name="b", param_path=("b",), d_in=64, d_out=32),
                M(name="c", param_path=("c",), d_in=4096, d_out=48,
                  a_kind="block", a_blocks=4),
                M(name="d", param_path=("d",), d_in=50000, d_out=64,
                  a_kind="diag"),
                M(name="e", param_path=("e",), d_in=96, d_out=96,
                  n_stack=3, n_expert=4, has_bias=True),
                M(name="f", param_path=("f",), d_in=16, d_out=8)]
    costs = {m.name: plan.block_cost(m) for m in metas(LayerMeta)}
    jcosts = {m.name: jplan.block_cost(m) for m in metas(JLayerMeta)}
    assert costs == jcosts
    assert plan.bin_pack(costs, n) == jplan.bin_pack(jcosts, n)
    assert plan.matrix_inverse_cost(100, "block", 0, 2) == \
        jplan.matrix_inverse_cost(100, "block", 0, 2)
    with pytest.raises(ValueError, match="n_bins"):
        plan.bin_pack(costs, 0)


@pytest.mark.parametrize("t3", [1, 3, 5, 20])
@pytest.mark.parametrize("name", ["golden", "full"])
def test_stagger_groups_match_jax(name, t3):
    dims = GOLDEN_DIMS if name == "golden" else autoencoder_dims(CONFIG)
    kw = dict(t3=t3, refresh_mode="staggered")
    got = KFACEngine(MLP(dims, device="cpu"), KFACConfig(**kw),
                     device="cpu").stagger_groups()
    want = JEngine(JMLP(dims), JKFACConfig(**kw)).stagger_groups()
    assert got == want
    assert len(got) == t3


def test_full_width_groups():
    """The full-width autoencoder at T3 = 5: the four 785- to 1001-wide
    layers alone, the four narrow ones together (the d³ bins)."""
    eng = KFACEngine(MLP(autoencoder_dims(CONFIG), device="cpu"),
                     KFACConfig(t3=5), device="cpu")
    assert eng.stagger_groups() == [["layer7"], ["layer0"], ["layer1"],
                                    ["layer6"],
                                    ["layer2", "layer3", "layer4", "layer5"]]


# ---------------------------------------------------------------------------
# the τ1 sub-batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau1", [1.0, 0.5, 0.3, 0.25, 0.125])
def test_sub_batch_mlp_matches_jax(tau1):
    eng = KFACEngine(MLP(GOLDEN_DIMS, device="cpu"), KFACConfig(tau1=tau1),
                     device="cpu")
    jeng = JEngine(JMLP(GOLDEN_DIMS), JKFACConfig(tau1=tau1))
    b = SyntheticAutoencoderData(64, 8, 256, seed=7, device="cpu").batch(2)
    jb = JData(64, 8, 256, seed=7).batch(2)
    sub, jsub = eng._sub_batch(b), _np(jeng._sub_batch(jb))
    assert set(sub) == set(jsub)
    for k in jsub:
        np.testing.assert_array_equal(sub[k].numpy(), jsub[k])
    assert eng.n_tokens(sub) == jeng.n_tokens(jsub)
    if tau1 == 1.0:
        assert sub is b


@pytest.mark.parametrize("tau1", [0.5, 0.25])
def test_sub_batch_whisper_matches_jax(tau1):
    from test_torch_whisper_parity import _setup
    s = _setup()
    eng = KFACEngine(s["lm"], KFACConfig(tau1=tau1), device="cpu")
    jeng = JEngine(s["jl"], JKFACConfig(tau1=tau1))
    b, jb = s["data"].batch(1), s["jdata"].batch(1)
    sub, jsub = eng._sub_batch(b), _np(jeng._sub_batch(jb))
    assert set(sub) == set(jsub) == {"tokens", "labels", "mels"}
    for k in jsub:
        np.testing.assert_array_equal(sub[k].numpy(), jsub[k])
    assert sub["tokens"].shape[0] == 8 * tau1
    assert eng.n_tokens(sub) == jeng.n_tokens(jsub)
    assert s["lm"].probe_shapes(sub) == {
        k: v.shape for k, v in s["jl"].probe_shapes(jsub).items()}


# ---------------------------------------------------------------------------
# the Gaussian loss
# ---------------------------------------------------------------------------

def test_normals_from_jax_uniforms():
    """``jax.random.normal(key)`` from the uniforms of ``key``."""
    for seed, shape in ((3, (1024, 784)), (4, (7, 5)), (5, (256, 64))):
        key = jax.random.PRNGKey(seed)
        u = np.asarray(jax.random.uniform(key, shape, jnp.float32))
        want = np.asarray(jax.random.normal(key, shape, jnp.float32))
        got = normal_from_uniforms(torch.from_numpy(u.copy()))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=NORMAL_TOL)
    # the edge: u = 0 maps to lo = nextafter(-1, 0), not to -1, so the
    # normal is finite (about -5.42)
    edge = normal_from_uniforms(torch.tensor([0.0]))
    assert torch.isfinite(edge).all() and -5.5 < float(edge) < -5.3


def _gauss_pair(dims=(6, 5, 4), n=32, seed=0):
    mlp, jmlp = (MLP(list(dims), loss="gaussian", device="cpu"),
                 JMLP(list(dims), loss="gaussian"))
    jp = jmlp.init_params(jax.random.PRNGKey(seed), sparse=False)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dims[0])).astype(np.float32)
    y = rng.standard_normal((n, dims[-1])).astype(np.float32)
    return mlp, jmlp, jp, params_from_numpy(_np(jp), "cpu"), x, y


def test_gaussian_nll_and_loss_match_jax():
    mlp, jmlp, jp, p, x, y = _gauss_pair()
    z = np.random.default_rng(1).standard_normal(y.shape).astype(np.float32)
    _close(mlp._nll(_t(z), _t(y)), jmlp._nll(z, y))
    key = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    (jlt, jls), _ = jmlp.loss(jp, None, {"x": x, "y": y}, key)
    (lt, ls), _ = mlp.loss(p, None, {"x": _t(x), "y": _t(y)},
                           lambda shape: torch.from_numpy(np.array(
                               jax.random.uniform(key, shape, jnp.float32))))
    _close(lt, jlt)
    _close(ls, jls, rtol=1e-4)


def test_gaussian_sample_targets_from_jax_uniforms():
    """z + n with n the normals of JAX's key, from that key's uniforms."""
    mlp, jmlp, *_ = _gauss_pair()
    z = np.random.default_rng(2).standard_normal((64, 4)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jmlp.sample_targets(jnp.asarray(z), key))
    got = mlp.sample_targets(_t(z), lambda shape: torch.from_numpy(np.array(
        jax.random.uniform(key, shape, jnp.float32))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2 * NORMAL_TOL)


def test_mlp_refuses_an_unknown_loss():
    with pytest.raises(ValueError, match="unknown loss"):
        MLP([4, 3, 4], loss="poisson", device="cpu")


def test_quad_logits_gaussian_matches_jax():
    mlp, jmlp, jp, p, x, y = _gauss_pair(dims=(6, 5, 4), n=48)
    rng = np.random.default_rng(4)
    tangents = [{k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in _np(jp).items()} for _ in range(3)]
    want = jfisher.quad_logits(lambda q: jmlp.logits(q, x), jp,
                               {"x": x, "y": y}, tangents, "gaussian")
    got = fisher.quad_logits(lambda q: mlp.logits(q, _t(x)), p,
                             {"x": _t(x), "y": _t(y)},
                             [params_from_numpy(t, "cpu") for t in tangents],
                             "gaussian")
    _close(got, want)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        fisher.quad_logits(lambda q: mlp.logits(q, _t(x)), p,
                           {"x": _t(x)}, [p], "poisson")


def test_invariance_to_input_transform():
    """Theorem 1 (S10) on the port, ``tests/test_kfac_math.py``'s check:
    K-FAC's update for the Gaussian MLP is invariant to an invertible
    affine transform of the inputs.  JAX's weights, inputs, transform and
    sampling key are carried across."""
    dims = [4, 6, 3]
    omega = np.asarray(jax.random.normal(jax.random.PRNGKey(42), (4, 4))
                       * 0.5 + jnp.eye(4))
    jmlp = JMLP(dims, loss="gaussian")
    jparams = _np(jmlp.init_params(jax.random.PRNGKey(0), sparse=False))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (512, 4)))
    y = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (512, 3)))
    key = jax.random.PRNGKey(3)
    uniforms = lambda shape: torch.from_numpy(np.array(
        jax.random.uniform(key, shape, jnp.float32)))

    def run(transform):
        mlp = MLP(dims, loss="gaussian", device="cpu")
        params = params_from_numpy(jparams, "cpu")
        if transform:   # x' = x Omegaᵀ  =>  W0' = [Omega^{-T} W0w ; b0]
            w0 = params["W0"]
            w0w = torch.linalg.solve(_t(omega).T, w0[:-1])
            params = dict(params, W0=torch.cat([w0w, w0[-1:]], 0))
        xin = x @ omega.T if transform else x
        batch = {"x": _t(xin), "y": _t(y)}
        p1 = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        probes = mlp.make_probes(batch)
        (lt, ls), aux = mlp.loss(p1, probes, batch, uniforms, mode="collect")
        grads = dict(zip(p1, torch.autograd.grad(lt, list(p1.values()),
                                                 retain_graph=True)))
        gp = dict(zip(probes, torch.autograd.grad(ls,
                                                  list(probes.values()))))
        n = 512
        out = {}
        for name, m in mlp.metas.items():
            a = F.outer_sum(aux["recs"][name]["a"], "full") / n
            g = F.g_from_cotangent(gp[name], m, n)
            inv = {"a_inv": torch.linalg.inv(a + 1e-6 * torch.eye(m.a_dim)),
                   "g_inv": torch.linalg.inv(g + 1e-6 * torch.eye(m.g_dim))}
            out[name] = inverse.apply_block_inverse(m, inv,
                                                    grads[m.param_path[0]])
        return out

    u_base, u_tr = run(False), run(True)
    got = torch.cat([torch.linalg.solve(_t(omega).T, u_base["layer0"][:-1]),
                     u_base["layer0"][-1:]], 0)
    np.testing.assert_allclose(u_tr["layer0"].numpy(), got.numpy(),
                               rtol=5e-2, atol=5e-4)
    np.testing.assert_allclose(u_tr["layer1"].numpy(),
                               u_base["layer1"].numpy(), rtol=5e-2,
                               atol=5e-4)
