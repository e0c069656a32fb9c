"""The plain versions of the port's EKFAC-apply and update-chain kernels
against the JAX package's.

``matmul_rescale_ref`` / ``rotate_rescale_ref`` and ``axpy_momentum_ref`` /
``precond_momentum_ref`` (``repro_torch.kernels.rotate_rescale`` and
``.update_chain``, taken by the wrappers for CPU tensors) are held against
the Pallas kernels run in interpret mode at shapes that tile (256×128), and
at ragged path shapes against the jnp routes the JAX package takes there:
``core.inverse.apply_eigen`` and ``CurvatureBlock.precond_momentum``.  The
CUDA kernels are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  λ, α and μ are passed as
0-d tensors, as the engine passes them.

Tolerance: rtol 1e-5, atol 1e-6 in float32 (ΣD²: rtol 1e-5).  Operands
are non-negative or orthonormal with a well-conditioned diagonal, so no
output entry is a cancellation far below the array's scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import KFACConfig as JKFACConfig
from repro.core import inverse as jinverse
from repro.core.blocks.kron import DenseKronecker as JDense
from repro.core.tags import LayerMeta as JMeta
from repro.kernels.rotate_rescale import matmul_rescale as j_matmul_rescale
from repro.kernels.rotate_rescale import rotate_rescale as j_rotate_rescale
from repro.kernels.update_chain import axpy_momentum as j_axpy_momentum
from repro.kernels.update_chain import precond_momentum as j_precond_momentum
from repro_torch import kernels as K
from repro_torch.kernels import rotate_rescale as RR
from repro_torch.kernels import update_chain as UC

RTOL, ATOL = 1e-5, 1e-6


def _u(seed, *shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _orth(seed, d):
    """An orthonormal basis, as eigh returns."""
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((d, d)))
    return q.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# shapes that tile: against the interpret-mode Pallas kernels
# ---------------------------------------------------------------------------

def test_matmul_rescale_ref_matches_pallas():
    a, b, s = _u(0, 256, 128), _u(1, 128, 256), _u(2, 256, 256) + 0.5
    lam = np.float32(0.25)
    want = j_matmul_rescale(jnp.asarray(a), jnp.asarray(b), jnp.asarray(s),
                            jnp.asarray(lam), interpret=True)
    _close(RR.matmul_rescale_ref(_t(a), _t(b), _t(s), torch.tensor(lam)),
           want)


def test_rotate_rescale_ref_matches_pallas():
    qa, qg = _orth(3, 256), _orth(4, 128)
    v, s = _u(5, 256, 128), _u(6, 256, 128) + 0.5
    want = j_rotate_rescale(jnp.asarray(qa), jnp.asarray(v), jnp.asarray(qg),
                            jnp.asarray(s), jnp.float32(1e-12),
                            interpret=True)
    got = RR.rotate_rescale_ref(_t(qa), _t(v), _t(qg), _t(s),
                                torch.tensor(1e-12))
    _close(got, want, atol=ATOL * np.abs(np.asarray(want)).max())


def test_axpy_momentum_ref_matches_pallas():
    a_inv, t, mom = _u(7, 256, 256), _u(8, 256, 128), _u(9, 256, 128)
    alpha, mu = np.float32(-0.02), np.float32(0.9)
    want_d, want_sq = j_axpy_momentum(jnp.asarray(a_inv), jnp.asarray(t),
                                      jnp.asarray(mom), alpha, mu,
                                      interpret=True)
    d, sq = UC.axpy_momentum_ref(_t(a_inv), _t(t), _t(mom),
                                 torch.tensor(alpha), torch.tensor(mu))
    _close(d, want_d, atol=ATOL * np.abs(np.asarray(want_d)).max())
    assert np.asarray(want_sq).shape == (2, 1)
    _close(sq, np.asarray(want_sq).sum(), atol=0)


def test_precond_momentum_ref_matches_pallas():
    a_inv, v, g_inv = _u(10, 256, 256), _u(11, 256, 128), _u(12, 128, 128)
    mom = _u(13, 256, 128)
    alpha, mu = np.float32(-0.05), np.float32(0.5)
    want_d, want_sq = j_precond_momentum(
        jnp.asarray(a_inv), jnp.asarray(v), jnp.asarray(g_inv),
        jnp.asarray(mom), alpha=alpha, mu=mu, interpret=True)
    d, sq = UC.precond_momentum_ref(_t(a_inv), _t(v), _t(g_inv), _t(mom),
                                    alpha=torch.tensor(alpha),
                                    mu=torch.tensor(mu))
    _close(d, want_d, atol=ATOL * np.abs(np.asarray(want_d)).max())
    _close(sq, want_sq, atol=0)


# ---------------------------------------------------------------------------
# ragged path shapes: against the jnp routes
# ---------------------------------------------------------------------------

RAGGED = [(31, 30), (251, 30), (65, 32)]   # full-width path; reduced layer 0


def _meta(a, g):
    return JMeta(name="w", param_path=("w",), d_in=a - 1, d_out=g,
                 has_bias=True)


@pytest.mark.parametrize("a,g", RAGGED)
def test_rotate_rescale_ref_matches_apply_eigen(a, g):
    eig = {"qa": _orth(20 + a, a), "qg": _orth(21 + g, g),
           "s": _u(22, a, g), "damp": _u(23, a, g) + 0.1}
    v = _u(24, a, g) - 0.5
    want = np.asarray(jinverse.apply_eigen(_meta(a, g), eig, v))
    got = RR.rotate_rescale_ref(_t(eig["qa"]), _t(v), _t(eig["qg"]),
                                _t(eig["s"] + eig["damp"]), lam=1e-12)
    _close(got, want, atol=ATOL * np.abs(want).max())


@pytest.mark.parametrize("a,g", RAGGED)
def test_precond_momentum_ref_matches_block(a, g):
    a_inv, g_inv = _u(40, a, a), _u(41, g, g)
    v, mom = _u(42, a, g) - 0.5, _u(43, a, g) - 0.5
    alpha, mu = np.float32(-0.02), np.float32(0.9)
    blk = JDense(_meta(a, g), JKFACConfig())
    want_d, want_sq = blk.precond_momentum({"a_inv": a_inv, "g_inv": g_inv},
                                           v, mom, alpha, mu)
    d, sq = UC.precond_momentum_ref(_t(a_inv), _t(v), _t(g_inv), _t(mom),
                                    alpha=torch.tensor(alpha),
                                    mu=torch.tensor(mu))
    want_d = np.asarray(want_d)
    _close(d, want_d, atol=ATOL * np.abs(want_d).max())
    _close(sq, want_sq, atol=0)


# ---------------------------------------------------------------------------
# routing: CPU tensors take the plain version and launch nothing
# ---------------------------------------------------------------------------

def test_new_wrappers_route_cpu_tensors_to_plain_versions():
    K.reset_launches()
    a, b, s = _t(_u(50, 31, 17)), _t(_u(51, 17, 30)), _t(_u(52, 31, 30))
    lam = torch.tensor(0.5)
    assert torch.equal(RR.matmul_rescale(a, b, s, lam),
                       RR.matmul_rescale_ref(a, b, s, lam))
    qa, qg, v = _t(_orth(53, 31)), _t(_orth(54, 30)), _t(_u(55, 31, 30))
    assert torch.equal(RR.rotate_rescale(qa, v, qg, s + 1.0, 1e-12),
                       RR.rotate_rescale_ref(qa, v, qg, s + 1.0, 1e-12))
    al, mu = torch.tensor(-0.02), torch.tensor(0.9)
    ai, gi = _t(_u(56, 31, 31)), _t(_u(57, 30, 30))
    for got, want in ((UC.axpy_momentum(ai, v, s, al, mu),
                       UC.axpy_momentum_ref(ai, v, s, al, mu)),
                      (UC.precond_momentum(ai, v, gi, s, alpha=al, mu=mu),
                       UC.precond_momentum_ref(ai, v, gi, s, alpha=al,
                                               mu=mu))):
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert set(K.launches().values()) == {0}
