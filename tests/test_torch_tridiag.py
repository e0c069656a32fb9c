"""The port's block-tridiagonal inverse (paper S4.3, Appendix B;
``repro_torch/core/tridiag.py``, ``core/blocks/chain.py``) against the JAX
reference's, module by module, on the CPU.

Inputs: the golden setup's (``tests/test_golden.py``: the reduced
autoencoder 64-32-16-8 mirrored, JAX's sparse-init weights, N 256 from data
seed 7) records and probe cotangents from JAX's statistics pass, its
factors after two stats passes, and numpy-seeded matrices, handed to both
packages as numpy.

The eigh basis is not unique (ROADMAP queue C), so the Appendix-B
eigenvector products ``k1``/``k2`` are compared only through
``_sigma_inv_apply`` of a fixed X; Ψ^Ā, Ψ^G, the eigenvalues ``s1``/``s2``
and the last layer's inverses are compared directly.

Tolerances: rtol 1e-5 with an atol of 1e-5 of the array's largest
magnitude for products alone (``cross_contrib``, ``apply`` from one
carried cache); 1e-4 where an eigendecomposition is involved (the two
LAPACK eigensolvers round differently where eigenvalues lie close
together; the largest seen: 6.3e-5, s₁ at γ 0.05); the Σ⁻¹ apply and the
whole apply of each package's own cache 2e-4, since 1/(1 − s₂s₁)
amplifies the rounding of s₁ and s₂ (the largest seen: 1.4e-5 and 3.4e-5,
γ 0.05); the dense construction 1e-5 (float32 against float64; seen
2.5e-7).  The
stacked γ candidates against three single precomputes: 1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import KFACConfig as JKFACConfig
from repro.core import inverse as jinverse
from repro.core import tridiag as JTRI
from repro.data.pipeline import SyntheticAutoencoderData as JData
from repro.models.mlp import MLP as JMLP
from repro.optimizers.kfac import KFACEngine as JEngine
from repro_torch.configs import get_reduced_config
from repro_torch.configs.autoencoder import reduced
from repro_torch.configs.base import KFACConfig
from repro_torch.core import factors as F
from repro_torch.core import inverse
from repro_torch.core import tridiag as TRI
from repro_torch.core.blocks import TridiagChain
from repro_torch.core.blocks import base as blocks_base
from repro_torch.models.lm import LM
from repro_torch.models.mlp import MLP, autoencoder_dims
from repro_torch.optimizers.kfac import KFACEngine

torch.set_num_threads(1)

DIMS = autoencoder_dims(reduced())
N, LATENT, DATA_SEED = 256, 8, 7
CFG = dict(inv_mode="tridiag", inverse_method="eigh", lambda_init=3.0, t3=5,
           eta=1e-5)
SIGMA_TOL = 2e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tt(tree):
    return jax.tree.map(_t, _np(tree))


def _close(got, want, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _close_tree(got, want, rtol=1e-5):
    if isinstance(want, dict):
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            _close_tree(got[k], want[k], rtol)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_tree(g, w, rtol)
    else:
        _close(got, want, rtol)


@functools.lru_cache(maxsize=None)
def _setup():
    """Both models, JAX's weights, JAX's records / cotangents of one stats
    pass, and JAX's factors after two."""
    jmlp = JMLP(DIMS, nonlin="tanh", loss="bernoulli")
    jparams = jmlp.init_params(jax.random.PRNGKey(0), sparse=True)
    jdata = JData(DIMS[0], LATENT, N, seed=DATA_SEED)
    jb = jdata.batch(0)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 0), 1)
    probes = jmlp.make_probes(jmlp.probe_shapes(jb))

    def f(pr):
        (_, ls), aux = jmlp.loss(jparams, pr, jb, key, mode="collect")
        return ls, aux

    _, vjp_fn, aux = jax.vjp(f, probes, has_aux=True)
    (gprobes,) = vjp_fn(jnp.float32(1.0))
    jeng = JEngine(jmlp, JKFACConfig(**CFG), family="bernoulli")
    jstate = jeng.init(jparams, jb)
    for step in range(2):
        jstate, _, _ = jax.jit(jeng.stats_grads)(
            jstate, jparams, jb,
            jax.random.fold_in(jax.random.PRNGKey(0), step))
    return dict(jmlp=jmlp, mlp=MLP(DIMS, device="cpu"),
                recs=_np(aux["recs"]), gprobes=_np(gprobes),
                factors=_np(jstate.factors), gamma=np.float32(jstate.gamma))


@pytest.fixture
def setup():
    return _setup()


def _sigma_x(seed, cache):
    """A fixed X in the (B-side, A-side) layout of one Σ cache."""
    k1, k2 = cache["k1"], cache["k2"]
    return np.random.default_rng(seed).standard_normal(
        (k2.shape[-1], k1.shape[-1])).astype(np.float32)


def _close_tri(got, want, rtol=1e-4, sigma_tol=SIGMA_TOL):
    """A port Ψ/Σ cache against JAX's: directly where the eigh basis does
    not enter, through the Σ⁻¹ apply of a fixed X where it does."""
    _close_tree(got["psi_a"], want["psi_a"], rtol)
    _close_tree(got["psi_g"], want["psi_g"], rtol)
    _close_tree(got["last"], want["last"], rtol)
    assert len(got["appb"]) == len(want["appb"])
    for i, (g, w) in enumerate(zip(got["appb"], want["appb"])):
        _close(g["s1"], w["s1"], rtol)
        _close(g["s2"], w["s2"], rtol)
        x = _sigma_x(i, w)
        _close(TRI._sigma_inv_apply(g, _t(x)),
               JTRI._sigma_inv_apply(w, x), sigma_tol)


# ---------------------------------------------------------------------------
# eigh, as the reference calls it
# ---------------------------------------------------------------------------

def _unsymmetric(seed, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4 * d, d)).astype(np.float32)
    m = x.T @ x / (4 * d) + 0.1 * np.eye(d, dtype=np.float32)
    return (m + 1e-2 * rng.standard_normal((d, d))).astype(np.float32)


def test_eigh_symmetrizes_as_jax_does():
    """``jnp.linalg.eigh`` symmetrizes its input; ``inverse.eigh`` does
    too, where ``torch.linalg.eigh`` alone reads the lower triangle."""
    m = _unsymmetric(0, 33)
    w, v = inverse.eigh(_t(m))
    jw, _ = jnp.linalg.eigh(m)
    _close(w, jw, 1e-5)
    sym = 0.5 * (m + m.T)
    _close(v @ torch.diag(w) @ v.T, sym, 1e-5)
    _close(inverse.eigh_inverse(_t(m)), jinverse.eigh_inverse(m), 1e-4)
    q, wc = inverse.eigh_basis(_t(m), "full")
    _close(q @ torch.diag(wc) @ q.T, sym, 1e-5)
    # the lower triangle alone is another matrix
    lower = torch.linalg.eigh(_t(m))[0]
    assert not np.allclose(lower.numpy(), np.asarray(jw), rtol=1e-3)


# ---------------------------------------------------------------------------
# _inv_sqrt: the polished branch and the clamped seed
# ---------------------------------------------------------------------------

def _indefinite(seed, d):
    """A symmetric matrix with two eigenvalues below the clamp floor (both
    negative, far enough below it that rounding cannot lift either above
    it): the polish would diverge, so the clamped seed stands."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    w = np.linspace(0.5, 2.0, d)
    w[0], w[1] = -0.5, -1e-3
    return ((q * w) @ q.T).astype(np.float32)


@pytest.mark.parametrize("branch", ["polished", "clamped"])
def test_inv_sqrt(setup, branch):
    if branch == "polished":
        a = setup["factors"]["layer1"]["a"]
        m = (a + 0.3 * np.eye(a.shape[0], dtype=np.float32)).astype(
            np.float32)
    else:
        m = _indefinite(1, 12)
    got = TRI._inv_sqrt(_t(m))
    _close(got, JTRI._inv_sqrt(m), 1e-4)
    w, v = inverse.eigh(_t(m))
    seed = (v * torch.rsqrt(torch.clamp(w, min=1e-10))) @ v.T
    if branch == "polished":
        # M^{-1/2} M M^{-1/2} = I, closer than the seed alone
        eye = torch.eye(m.shape[0])
        res = (got @ _t(m) @ got - eye).abs().max()
        assert res < 1e-5, float(res)
        assert res <= (seed @ _t(m) @ seed - eye).abs().max()
    else:
        torch.testing.assert_close(got, seed, rtol=0, atol=0)


def test_inv_sqrt_gate_is_per_matrix(setup):
    """Stacked, each matrix takes its own branch of the gate."""
    a = setup["factors"]["layer2"]["a"]
    good = (a + 0.3 * np.eye(a.shape[0], dtype=np.float32)).astype(
        np.float32)
    bad = _indefinite(2, good.shape[0])
    got = TRI._inv_sqrt(_t(np.stack([good, bad, good])))
    for i, m in enumerate((good, bad, good)):
        _close(got[i], TRI._inv_sqrt(_t(m)), 1e-6)


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def test_cross_contrib_on_the_golden_records(setup):
    s = setup
    want = JTRI.cross_contrib(s["jmlp"], s["recs"], s["gprobes"], N)
    got = TRI.cross_contrib(
        s["mlp"], {k: {"a": _t(v["a"])} for k, v in s["recs"].items()},
        {k: _t(v) for k, v in s["gprobes"].items()}, N)
    assert sorted(got) == sorted(want) == sorted(
        [f"a{i}" for i in range(5)] + [f"g{i}" for i in range(5)])
    _close_tree(got, _np(want))


def test_init_cross_state(setup):
    want = _np(JTRI.init_cross_state(setup["jmlp"]))
    got = TRI.init_cross_state(setup["mlp"], "cpu")
    _close_tree(got, want, rtol=0)
    assert all(v.device.type == "cpu" for v in got.values())


# ---------------------------------------------------------------------------
# precompute
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gamma", ["state", 0.05])
def test_precompute_matches_jax(setup, gamma):
    """Ψ, s₁, s₂ and the last inverses directly; k₁/k₂ through Σ⁻¹."""
    g = setup["gamma"] if gamma == "state" else np.float32(gamma)
    want = _np(JTRI.precompute(setup["jmlp"], setup["factors"], g, 1e-5))
    got = TRI.precompute(setup["mlp"], _tt(setup["factors"]),
                         torch.tensor(g), 1e-5)
    _close_tri(got, want)


def test_precompute_stacks_gamma_candidates(setup):
    """A (3,) gamma equals three single precomputes, and JAX's vmap."""
    gammas = np.array([0.7, 1.7, 3.0], np.float32)
    fac = _tt(setup["factors"])
    got = TRI.precompute(setup["mlp"], fac, torch.from_numpy(gammas), 1e-5)
    assert tuple(got["psi_a"][0].shape) == (3, DIMS[0] + 1, DIMS[1] + 1)
    assert tuple(got["appb"][0]["s2"].shape) == (3, DIMS[1])
    for c in range(3):
        one = TRI.precompute(setup["mlp"], fac, torch.tensor(gammas[c]),
                             1e-5)
        pick = jax.tree.map(lambda x: x[c], got)
        _close_tri(pick, jax.tree.map(lambda x: x.numpy(), one), rtol=1e-6,
                   sigma_tol=1e-6)
    want = _np(jax.vmap(lambda gm: JTRI.precompute(
        setup["jmlp"], setup["factors"], gm, 1e-5))(gammas))
    for c in range(3):
        _close_tri(jax.tree.map(lambda x: x[c], got),
                   jax.tree.map(lambda x: x[c], want))


# ---------------------------------------------------------------------------
# apply: U = Ξᵀ Λ Ξ V
# ---------------------------------------------------------------------------

def _vs(seed, metas):
    rng = np.random.default_rng(seed)
    return {name: rng.standard_normal((m.a_dim, m.g_dim)).astype(np.float32)
            for name, m in metas.items()}


def test_sigma_inv_apply_guard_is_the_reference(setup):
    """A denominator 1 − s₂s₁ under 1e-8 in magnitude becomes +1e-8
    whatever its sign; a negative one above it stays."""
    rng = np.random.default_rng(4)
    q1, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    q2, _ = np.linalg.qr(rng.standard_normal((2, 2)))
    cache = {"k1": q1.astype(np.float32), "k2": q2.astype(np.float32),
             "s1": np.array([0.25, 1.0, 2.0], np.float32),
             "s2": np.array([0.5, 1.0], np.float32)}   # 1·1 and 0.5·2 hit 0
    x = rng.standard_normal((2, 3)).astype(np.float32)
    want = JTRI._sigma_inv_apply(cache, x)
    got = TRI._sigma_inv_apply({k: _t(v) for k, v in cache.items()}, _t(x))
    _close(got, want, 1e-6)
    assert np.abs(np.asarray(want)).max() > 1e6      # the guard's 1/1e-8


def test_apply_from_jax_cache(setup):
    """One cache (JAX's, carried across): the apply's products alone."""
    want_tri = JTRI.precompute(setup["jmlp"], setup["factors"],
                               setup["gamma"], 1e-5)
    vs = _vs(5, setup["mlp"].metas)
    want = JTRI.apply(setup["jmlp"], want_tri, vs)
    got = TRI.apply(setup["mlp"], _tt(want_tri),
                    {k: _t(v) for k, v in vs.items()})
    _close_tree(got, _np(want))
    # each package's own cache: basis-invariant, so held as Σ⁻¹ is
    own = TRI.apply(setup["mlp"], TRI.precompute(
        setup["mlp"], _tt(setup["factors"]), torch.tensor(setup["gamma"]),
        1e-5), {k: _t(v) for k, v in vs.items()})
    _close_tree(own, _np(want), SIGMA_TOL)


def _dense_tridiag_inverse(a_d, g_d, cross_a, cross_g):
    """F̂⁻¹ = Ξᵀ Λ Ξ built densely in float64 from the same damped factors
    (a torch copy of ``tests/test_kfac_math.py::_dense_tridiag_inverse``,
    Kronecker products in (A ⊗ G) order, vec of the (a, g) weight)."""
    ell = len(a_d)
    blocks = [a.shape[0] * g.shape[0] for a, g in zip(a_d, g_d)]
    psi = [torch.kron(cross_a[i] @ torch.linalg.inv(a_d[i + 1]),
                      cross_g[i] @ torch.linalg.inv(g_d[i + 1]))
           for i in range(ell - 1)]
    sig = [torch.kron(a_d[i], g_d[i])
           - psi[i] @ torch.kron(a_d[i + 1], g_d[i + 1]) @ psi[i].T
           for i in range(ell - 1)]
    sig.append(torch.kron(a_d[-1], g_d[-1]))
    n = sum(blocks)
    off = np.cumsum([0] + blocks)
    xi = torch.eye(n, dtype=torch.float64)
    lam = torch.zeros(n, n, dtype=torch.float64)
    for i in range(ell - 1):
        xi[off[i]:off[i + 1], off[i + 1]:off[i + 2]] = -psi[i]
    for i in range(ell):
        lam[off[i]:off[i + 1], off[i]:off[i + 1]] = torch.linalg.inv(sig[i])
    return xi.T @ lam @ xi


def test_apply_matches_dense_construction():
    """dims [3, 4, 2, 3]: the port's own statistics (numpy-seeded weights
    and inputs, seeded uniforms), precompute and apply against the dense
    Ξᵀ Λ Ξ of the same damped factors."""
    dims = [3, 4, 2, 3]
    mlp = MLP(dims, device="cpu")
    rng = np.random.default_rng(0)
    params = {f"W{i}": torch.from_numpy(
        (rng.standard_normal((dims[i] + 1, dims[i + 1]))
         / np.sqrt(dims[i])).astype(np.float32)) for i in range(3)}
    x = torch.from_numpy((rng.random((64, dims[0])) < 0.5).astype(
        np.float32))
    batch = {"x": x, "y": x}
    probes = mlp.make_probes(batch)
    u = torch.from_numpy(rng.random((64, dims[-1])).astype(np.float32))
    (_, ls), aux = mlp.loss(params, probes, batch, lambda shape: u,
                            mode="collect")
    gp = dict(zip(probes, torch.autograd.grad(ls, list(probes.values()))))
    recs = aux["recs"]
    n = x.shape[0]
    factors = {name: {"a": F.outer_sum(recs[name]["a"]) / n,
                      "g": F.g_from_cotangent(gp[name], m, n)}
               for name, m in mlp.metas.items()}
    factors["__cross__"] = TRI.cross_contrib(mlp, recs, gp, n)
    gamma = 0.7
    tri = TRI.precompute(mlp, factors, torch.tensor(gamma), 0.0)
    vs = {name: torch.from_numpy(rng.standard_normal(
        (m.a_dim, m.g_dim)).astype(np.float32))
        for name, m in mlp.metas.items()}
    got = TRI.apply(mlp, tri, vs)

    a_d, g_d = [], []
    for name in mlp.layer_order:
        m = mlp.metas[name]
        a, g = (factors[name][k].double() for k in ("a", "g"))
        pi = inverse.pi_trace(a, "full", m.a_dim, g, "full", m.g_dim)
        a_d.append(a + pi * gamma * torch.eye(m.a_dim, dtype=torch.float64))
        g_d.append(g + gamma / pi * torch.eye(m.g_dim, dtype=torch.float64))
    cross = factors["__cross__"]
    f_inv = _dense_tridiag_inverse(
        a_d, g_d, [cross[f"a{i}"].double() for i in range(2)],
        [cross[f"g{i}"].double() for i in range(2)])
    want = f_inv @ torch.cat([vs[nm].double().reshape(-1)
                              for nm in mlp.layer_order])
    off = 0
    for name in mlp.layer_order:
        m = mlp.metas[name]
        sz = m.a_dim * m.g_dim
        _close(got[name], want[off:off + sz].reshape(m.a_dim,
                                                      m.g_dim).numpy(),
               1e-5)
        off += sz


# ---------------------------------------------------------------------------
# the chain block, the config, an LM
# ---------------------------------------------------------------------------

def test_tridiag_chain_block(setup):
    cfg = KFACConfig(**CFG)
    blk = TridiagChain(setup["mlp"], cfg, "cpu")
    assert blk.identity_inverse() is None
    assert (TridiagChain.CROSS, TridiagChain.TRI) == ("__cross__", "__tri__")
    _close_tree(blk.init_factors(),
                _np(JTRI.init_cross_state(setup["jmlp"])), rtol=0)
    # a per-layer meta, as build_blocks() would hand it: refused
    with pytest.raises(TypeError, match="layer_order"):
        TridiagChain(setup["mlp"].metas["layer0"], cfg, "cpu")
    # no LayerMeta is of kind "tridiag": build_blocks never builds one
    assert blocks_base.resolve(setup["mlp"].metas["layer0"]) is not \
        TridiagChain


def test_config_accepts_tridiag():
    assert KFACConfig(inv_mode="tridiag").inv_mode == "tridiag"
    with pytest.raises(NotImplementedError, match="inv_mode"):
        KFACConfig(inv_mode="kron3")


def test_lm_tridiag_is_the_block_diagonal_engine():
    """An LM has no layer_order: tridiag builds no chain and keeps no cross
    moments (the reference's ``self.tridiag``), with or without the fused
    chain."""
    lm = LM(get_reduced_config("whisper-small"), device="cpu")
    eng = KFACEngine(lm, KFACConfig(inv_mode="tridiag", lambda_init=10.0),
                     device="cpu")
    assert eng.chain is None and not eng.tridiag
    eng = KFACEngine(lm, KFACConfig(inv_mode="tridiag", use_rescale=False),
                     device="cpu")
    assert eng.chain is None and not eng.tridiag and not eng.eigen


def test_engine_builds_the_chain_on_an_mlp(setup):
    eng = KFACEngine(setup["mlp"], KFACConfig(**CFG), family="bernoulli",
                     device="cpu")
    assert eng.tridiag and isinstance(eng.chain, TridiagChain)
    state = eng.init(setup["mlp"].init_params(torch.Generator()),
                     {"x": torch.zeros(4, DIMS[0])})
    assert state.inv[TridiagChain.TRI] is None
    assert sorted(state.factors[TridiagChain.CROSS]) == sorted(
        setup["factors"]["__cross__"])
