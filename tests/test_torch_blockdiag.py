"""The ``block`` factor layout and ``BlockDiagKronecker`` against the JAX
reference on the CPU, module by module.

A factor side above ``KFACConfig.max_factor_dim`` keeps nb diagonal
(db, db) blocks, stored (*lead, nb, db, db).  Held here:

* ``factor_layout`` equals the reference's over dims 1-20,000 at several
  ``max_dim``s; ``factor_shape``;
* ``outer_sum`` and ``g_from_cotangent`` on blocks, plain and stacked;
* the three functions that took a block stack for a full one without an
  error: ``_add_damp`` (a damp of the lead dims broadcast against the
  block axis when S == nb), ``identity_inverse`` (an identity of the whole
  side) and ``factor_trace`` (no sum over the blocks, so π was wrong);
* ``damped_pair_inverse`` in eigh and NS (hot-started from the identity
  views), with one γ and with the sweep's (3,) candidates;
* the block apply of a fixed V with inverses at γ = 1e-4, where the block
  layout's answer is far from the full layout's (asserted, so that the
  check can fail), and ``BlockDiagKronecker`` against the dense
  ``(Ā_blockdiag ⊗ G)⁻¹ vec(V)``;
* the registry's choice for each pair of side kinds, and the block's
  kernel route: one ``factor_update`` and one ``matmul`` call a side,
  the block axis in the call's batch; eigen mode, the fused chain and
  ``fused_stats`` on a block side refused by name.

Tolerances: rtol 1e-5 with an atol of 1e-5 of the array's largest
magnitude (the dense Kronecker solve, in float64, to 1e-5 of the float32
answer's largest magnitude).  The model's block layers are held in
``test_torch_gemma2_parity.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import KFACConfig as JKFACConfig
from repro.core import blocks as JB
from repro.core import factors as jfactors
from repro.core import inverse as jinverse
from repro.core.tags import LayerMeta as JLayerMeta
from repro_torch.configs.base import KFACConfig
from repro_torch.core import blocks as B
from repro_torch.core import factors, inverse
from repro_torch.core.blocks import kron
from repro_torch.core.tags import LayerMeta
from test_torch_whisper_parity import _close, _close_tree, _np

torch.set_num_threads(1)

S, N = 2, 96          # stacked groups; rows of a statistics pass
TOL = 1e-5


def _meta(M=LayerMeta, a_kind="block", g_kind="full", a_blocks=2,
          g_blocks=1, d_in=8, d_out=12, n_stack=S, **kw):
    return M(name="l", param_path=("w",), d_in=d_in, d_out=d_out,
             kind=kw.pop("kind", "dense"), n_stack=n_stack, a_kind=a_kind,
             g_kind=g_kind, a_blocks=a_blocks, g_blocks=g_blocks, **kw)


def _pair(**kw):
    return _meta(**kw), _meta(JLayerMeta, **kw)


def _rows(seed, shape, mix=True):
    """Correlated rows: off-diagonal blocks of XᵀX are not small, so a
    block layout and the full one give different answers."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if mix:
        d = shape[-1]
        m = (np.eye(d) + 0.6 * rng.standard_normal((d, d)) / np.sqrt(d))
        x = (x @ m.astype(np.float32)).astype(np.float32)
    return x


# pairs of side layouts: (a_kind, a_blocks, g_kind, g_blocks)
LAYOUTS = [("block", 2, "full", 1), ("full", 1, "block", 3),
           ("block", 4, "block", 2)]


def _layout_kw(layout):
    a_kind, a_blocks, g_kind, g_blocks = layout
    return dict(a_kind=a_kind, a_blocks=a_blocks, g_kind=g_kind,
                g_blocks=g_blocks)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_dim", [8192, 4608, 1000, 64, 48, 7])
def test_factor_layout_is_the_reference(max_dim):
    for dim in range(1, 20_001):
        assert factors.factor_layout(dim, False, 1, max_dim) == \
            jfactors.factor_layout(dim, False, 1, max_dim), dim
    for dim in (96, 4096, 9216, 10_000, 20_000):
        for tp in (2, 4, 8):
            assert factors.factor_layout(dim, True, tp, max_dim) == \
                jfactors.factor_layout(dim, True, tp, max_dim), (dim, tp)
    assert factors.factor_layout(9216, False, 1, 8192) == ("block", 2)


@pytest.mark.parametrize("kind,blocks", [("full", 1), ("diag", 1),
                                         ("block", 2), ("block", 4)])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_factor_shape_is_the_reference(kind, blocks, lead):
    assert factors.factor_shape(16, kind, blocks, lead) == \
        jfactors.factor_shape(16, kind, blocks, lead)


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blocks", [2, 4])
def test_outer_sum_on_blocks(blocks):
    """(..., d) -> (nb, db, db), the reference's ``"nbd,nbe->bde"``; and
    stacked, (S, ..., d) -> (S, nb, db, db), as its vmap over the stack."""
    x = _rows(0, (4, 24, 16))
    _close(factors.outer_sum(torch.from_numpy(x), "block", blocks=blocks),
           jfactors.outer_sum(jnp.asarray(x), "block", blocks))
    xs = _rows(1, (S, 4, 24, 16))
    want = jax.vmap(lambda v: jfactors.outer_sum(v, "block", blocks))(
        jnp.asarray(xs))
    got = factors.outer_sum(torch.from_numpy(xs), "block", stacked=True,
                            blocks=blocks)
    assert got.shape == (S, blocks, 16 // blocks, 16 // blocks)
    _close(got, want)


@pytest.mark.parametrize("n_stack", [0, S])
def test_g_from_cotangent_on_blocks(n_stack):
    meta, jmeta = _pair(a_kind="full", a_blocks=1, g_kind="block",
                        g_blocks=3, n_stack=n_stack)
    cot = _rows(2, ((S,) if n_stack else ()) + (4, 24, 12))
    _close(factors.g_from_cotangent(torch.from_numpy(cot), meta, 96),
           jfactors.g_from_cotangent(jnp.asarray(cot), jmeta, 96))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_update_factors_through_the_kernel_route(layout):
    """The block's decayed update, through the ``factor_update`` wrapper
    on folded block rows, against the reference's plain statistics and
    blend, from zero factors (ε = 0) and then at ε = 1/2."""
    meta, jmeta = _pair(**_layout_kw(layout))
    blk = B.resolve(meta)(meta, KFACConfig(), "cpu")
    jblk = JB.resolve(jmeta)(jmeta, JKFACConfig())
    old, jold = blk.init_factors(), jblk.init_factors()
    for step, eps in enumerate((0.0, 0.5)):
        a = _rows(3 + step, (S, 4, 24, meta.a_dim))
        cot = _rows(5 + step, (S, 4, 24, meta.g_dim))
        old = blk.update_factors(old, {"a": torch.from_numpy(a)},
                                 torch.from_numpy(cot), N,
                                 torch.tensor(eps))
        # the reference's LM contracts a stacked layer's Ā in its scan
        aa = jax.vmap(lambda x: jfactors.outer_sum(
            x, jmeta.a_kind, jmeta.a_blocks))(jnp.asarray(a))
        jold = jblk.update_factors(jold, {"aa": aa}, jnp.asarray(cot), None,
                                   N, jnp.float32(eps))
        _close_tree(old, _np(jold))


# ---------------------------------------------------------------------------
# the three functions that took a block stack for a full one
# ---------------------------------------------------------------------------

def test_add_damp_adds_to_every_block():
    """A damp of the lead dims (S,) on an (S, nb, db, db) stack with S ==
    nb: each stacked group's blocks all get that group's damp; the γ
    sweep's (c, S) damp gives (c, S, nb, db, db)."""
    arr = _rows(7, (S, 2, 3, 3), mix=False)
    damp = np.array([0.5, 2.0], np.float32)
    got = inverse._add_damp(torch.from_numpy(arr), "block",
                            torch.from_numpy(damp))
    want = arr + damp[:, None, None, None] * np.eye(3, dtype=np.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    _close(got, jinverse._add_damp(jnp.asarray(arr), "block",
                                   jnp.asarray(damp)))
    damp3 = np.array([[0.5, 2.0], [1.0, 3.0], [4.0, 0.25]], np.float32)
    got3 = inverse._add_damp(torch.from_numpy(arr), "block",
                             torch.from_numpy(damp3))
    assert got3.shape == (3, S, 2, 3, 3)
    _close(got3, jinverse._add_damp(jnp.asarray(arr), "block",
                                    jnp.asarray(damp3)))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_identity_inverse_and_zero_factors_on_blocks(layout):
    """``init`` state of a block side: zeros (S, nb, db, db) and eye(db)
    on every block, views of one tensor, equal to the reference's."""
    meta, jmeta = _pair(**_layout_kw(layout))
    blk = B.resolve(meta)(meta, KFACConfig(), "cpu")
    jblk = JB.resolve(jmeta)(jmeta, JKFACConfig())
    z, jz = blk.init_factors(), jblk.init_factors()
    inv, jinv = blk.identity_inverse(), jblk.identity_inverse()
    _close_tree(z, _np(jz))
    _close_tree(inv, _np(jinv))
    for side, kind, nb in (("a", meta.a_kind, meta.a_blocks),
                           ("g", meta.g_kind, meta.g_blocks)):
        if kind == "block":
            assert inv[f"{side}_inv"].stride()[:2] == (0, 0)
            assert z[side].shape[:2] == (S, nb)


def test_identity_inverse_is_an_identity_of_each_block():
    """The base class's layout code (``CurvatureBlock.identity_inverse``,
    which every Kronecker block inherits) gives eye(db) on every block of
    a block side, not an identity of the whole side."""
    meta = _meta(a_kind="block", a_blocks=2, g_kind="full")
    inv = B.DenseKronecker(meta, KFACConfig(), "cpu").identity_inverse()
    assert inv["a_inv"].shape == (S, 2, 4, 4)
    np.testing.assert_array_equal(
        inv["a_inv"].numpy(), np.broadcast_to(np.eye(4, dtype=np.float32),
                                              (S, 2, 4, 4)))
    np.testing.assert_array_equal(inv["g_inv"].numpy(), np.broadcast_to(
        np.eye(12, dtype=np.float32), (S, 12, 12)))


def test_factor_trace_sums_the_blocks():
    arr = _rows(8, (S, 4, 3, 3), mix=False)
    got = inverse.factor_trace(torch.from_numpy(arr), "block")
    assert got.shape == (S,)
    np.testing.assert_allclose(got.numpy(), np.trace(
        arr, axis1=-2, axis2=-1).sum(-1), rtol=1e-6)
    _close(got, jinverse.factor_trace(jnp.asarray(arr), "block"))
    a = _rows(9, (S, 2, 4, 4), mix=False)
    g = _rows(10, (S, 12, 12), mix=False)
    _close(inverse.pi_trace(torch.from_numpy(a), "block", 8,
                            torch.from_numpy(g), "full", 12),
           jinverse.pi_trace(jnp.asarray(a), "block", 8, jnp.asarray(g),
                             "full", 12))


# ---------------------------------------------------------------------------
# inverses and the apply
# ---------------------------------------------------------------------------

def _factors(meta, seed):
    """Block (or full) factors of correlated rows, as a statistics pass
    makes them: (S, nb, db, db) or (S, d, d)."""
    a = _rows(seed, (S, N, meta.a_dim))
    g = _rows(seed + 1, (S, N, meta.g_dim))
    f = lambda x, kind, nb: factors.outer_sum(torch.from_numpy(x), kind,
                                              stacked=True, blocks=nb) / N
    return {"a": f(a, meta.a_kind, meta.a_blocks),
            "g": f(g, meta.g_kind, meta.g_blocks)}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("method", ["eigh", "ns"])
@pytest.mark.parametrize("gamma", ["one", "sweep"])
def test_damped_pair_inverse_on_blocks(layout, method, gamma):
    """Both inverses of a block pair, as the reference computes them; NS
    hot-started from the identity views (the first refresh), 12
    iterations; the sweep's (3,) candidates stack in front, (3, S, nb,
    db, db), with no hot start, as ``refresh_multi`` runs it (the
    reference vmaps over them)."""
    meta, jmeta = _pair(**_layout_kw(layout))
    blk = B.resolve(meta)(meta, KFACConfig(), "cpu")
    jblk = JB.resolve(jmeta)(jmeta, JKFACConfig())
    fac = _factors(meta, 11)
    jfac = {k: jnp.asarray(v.numpy()) for k, v in fac.items()}
    if gamma == "one":
        gm, prev, jprev = 0.3, blk.identity_inverse(), jblk.identity_inverse()
    else:
        gm, prev, jprev = np.array([0.3, 0.1, 0.9], np.float32), None, None
    got = blk.damped_inverse(fac, torch.as_tensor(gm), method=method,
                             iters=12, prev=None if method == "eigh"
                             else prev)
    jinv = lambda g: jblk.damped_inverse(
        jfac, g, method=method, iters=12,
        prev=None if method == "eigh" else jprev)
    # the reference vmaps its sweep over the candidates
    want = jinv(gm) if gamma == "one" else jax.vmap(jinv)(jnp.asarray(gm))
    if gamma == "sweep" and meta.a_kind == "block":
        assert got["a_inv"].shape == (3, S, meta.a_blocks,
                                      meta.a_dim // meta.a_blocks,
                                      meta.a_dim // meta.a_blocks)
    _close_tree(got, _np(want))


def _carried_inverses(meta, jmeta, gamma):
    """JAX's eigh inverses of one set of factors (block or full), carried
    across: the apply is held on its own."""
    fac = _factors(meta, 21)
    jfac = {k: jnp.asarray(v.numpy()) for k, v in fac.items()}
    jinv = jinverse.damped_pair_inverse(jmeta, jfac["a"], jfac["g"], gamma,
                                        method="eigh")
    return {k: torch.from_numpy(np.array(v)) for k, v in jinv.items()}, \
        jinv


@pytest.mark.parametrize("layout", LAYOUTS)
def test_block_apply_at_small_gamma(layout):
    """``U = Ā⁻¹ V Ḡ⁻¹`` of a fixed V through the block's matmul route,
    with the reference's inverses at γ = 1e-4, against the reference's
    apply; the full layout's answer from the same rows differs from it by
    far more than the tolerance."""
    gamma = 1e-4
    meta, jmeta = _pair(**_layout_kw(layout))
    blk = B.resolve(meta)(meta, KFACConfig(), "cpu")
    assert isinstance(blk, B.BlockDiagKronecker)
    inv, jinv = _carried_inverses(meta, jmeta, gamma)
    v = _rows(30, (S, meta.a_dim, meta.g_dim), mix=False)
    got = blk.precondition(inv, torch.from_numpy(v))
    _close(got, jinverse.apply_block_inverse(jmeta, jinv, jnp.asarray(v)))
    full, jfull = _pair(a_kind="full", a_blocks=1, g_kind="full",
                        g_blocks=1)
    finv, _ = _carried_inverses(full, jfull, gamma)
    u_full = B.resolve(full)(full, KFACConfig(), "cpu").precondition(
        finv, torch.from_numpy(v))
    scale = got.abs().max()
    assert (got - u_full).abs().max() > 100 * TOL * scale


@pytest.mark.parametrize("layout", LAYOUTS)
def test_block_diag_kron_matches_dense_reference(layout):
    """One (unstacked) block pair's apply against the dense
    ``(Ā_blockdiag ⊗ Ḡ_blockdiag)⁻¹ vec(V)`` of the same damped factors
    (π from the blocks' traces), solved in float64."""
    gamma = 0.5
    meta = _meta(n_stack=0, **_layout_kw(layout))
    blk = B.resolve(meta)(meta, KFACConfig(), "cpu")
    fac = {k: v[0] for k, v in _factors(_meta(**_layout_kw(layout)),
                                        41).items()}
    inv = blk.damped_inverse(fac, gamma, method="eigh")
    v = _rows(42, (meta.a_dim, meta.g_dim), mix=False)
    got = blk.precondition(inv, torch.from_numpy(v))

    def dense(x, kind):
        x = x.double().numpy()
        if kind == "full":
            return x
        out = np.zeros((x.shape[0] * x.shape[1],) * 2)
        db = x.shape[1]
        for b in range(x.shape[0]):
            out[b * db:(b + 1) * db, b * db:(b + 1) * db] = x[b]
        return out

    a_d, g_d = dense(fac["a"], meta.a_kind), dense(fac["g"], meta.g_kind)
    pi = np.sqrt((np.trace(a_d) / meta.a_dim) / (np.trace(g_d) / meta.g_dim))
    a_d = a_d + pi * gamma * np.eye(meta.a_dim)
    g_d = g_d + gamma / pi * np.eye(meta.g_dim)
    want = np.linalg.solve(np.kron(a_d, g_d), v.reshape(-1).astype(
        np.float64)).reshape(meta.a_dim, meta.g_dim)
    _close(got.double(), want)


# ---------------------------------------------------------------------------
# registry and kernel route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kinds,cls", [
    (("full", "full"), "DenseKronecker"),
    (("block", "full"), "BlockDiagKronecker"),
    (("full", "block"), "BlockDiagKronecker"),
    (("block", "block"), "BlockDiagKronecker"),
    (("diag", "full"), "DiagFactor"),
    (("diag", "block"), "DiagFactor"),
    (("block", "diag"), "DiagFactor"),
])
def test_registry_picks_the_reference_class(kinds, cls):
    kw = dict(a_kind=kinds[0], g_kind=kinds[1],
              a_blocks=2 if kinds[0] == "block" else 1,
              g_blocks=2 if kinds[1] == "block" else 1)
    meta, jmeta = _pair(**kw)
    assert B.resolve(meta).__name__ == JB.resolve(jmeta).__name__ == cls
    assert B.BlockDiagKronecker.priority == 20


@pytest.mark.parametrize("layout", LAYOUTS)
def test_block_route_calls_one_kernel_a_side(layout, monkeypatch):
    """One ``factor_update`` call a side, a block side's with its blocks
    in the batch, (S·nb, N, db) rows into (S·nb, db, db); one ``matmul``
    call a side for the apply, a block side's batch S·nb."""
    meta = _meta(**_layout_kw(layout))
    blk = B.resolve(meta)(meta, KFACConfig(), "cpu")
    calls = []

    def counted(name, fn):
        def wrapper(x, y, *args, **kw):
            calls.append((name, tuple(x.shape), tuple(y.shape)))
            return fn(x, y, *args, **kw)
        return wrapper

    monkeypatch.setattr(kron, "factor_update",
                        counted("factor_update", kron.factor_update))
    monkeypatch.setattr(kron, "matmul", counted("matmul", kron.matmul))
    a = torch.from_numpy(_rows(50, (S, 4, 24, meta.a_dim)))
    cot = torch.from_numpy(_rows(51, (S, 4, 24, meta.g_dim)))
    fac = blk.update_factors(blk.init_factors(), {"a": a}, cot, N,
                             torch.tensor(0.0))
    inv = blk.damped_inverse(fac, 0.3, method="eigh")
    blk.precondition(inv, torch.from_numpy(
        _rows(52, (S, meta.a_dim, meta.g_dim))))
    want = []
    for side, d, kind, nb in (("a", meta.a_dim, meta.a_kind, meta.a_blocks),
                              ("g", meta.g_dim, meta.g_kind,
                               meta.g_blocks)):
        want.append(("factor_update", (S * nb, N, d // nb),
                      (S * nb, d // nb, d // nb)) if kind == "block" else
                     ("factor_update", (S, N, d), (S, d, d)))
    a_nb, g_nb = meta.a_blocks, meta.g_blocks
    da, dg = meta.a_dim // a_nb, meta.g_dim // g_nb
    want.append(("matmul", (S * a_nb, da, da), (S * a_nb, da, meta.g_dim)))
    want.append(("matmul", (S * g_nb, meta.a_dim, dg), (S * g_nb, dg, dg)))
    assert calls == want


@pytest.mark.parametrize("kw,what", [
    (dict(inv_mode="eigen"), "eigen mode"),
    (dict(use_rescale=False), "the fused fixed-lr chain"),
    (dict(fused_stats=True), "fused_stats")])
def test_block_side_refuses_unported_paths_by_name(kw, what):
    meta = _meta()
    with pytest.raises(NotImplementedError, match=f"{what} on a block side"):
        B.BlockDiagKronecker(meta, KFACConfig(**kw), "cpu")
