"""The port's plain kernel versions against the JAX package's kernels.

Every ``repro_torch.kernels`` wrapper takes its plain PyTorch version
(``*_ref``) for CPU tensors; those versions are held here against the Pallas
kernels run in interpret mode (as ``tests/test_kernels.py`` runs them) at
shapes that tile, and against ``repro.kernels.ref``/jnp at ragged shapes,
which the Pallas kernels do not take.  The CUDA kernels themselves are held
against these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerance: rtol 1e-5, atol 1e-6 in float32.  Inputs are non-negative (or
well-conditioned SPD) so no output entry is a cancellation near zero, where
a relative bound says nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.factor_update import factor_update as j_factor_update
from repro.kernels.matmul import matmul as j_matmul
from repro.kernels.ns_step import ns_inverse as j_ns_inverse
from repro.kernels.ns_step import ns_step as j_ns_step
from repro.kernels.precond import precondition as j_precondition
from repro_torch import kernels as K
from repro_torch.kernels import factor_update as FU
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import matmul as MM
from repro_torch.kernels import ns_step as NS
from repro_torch.kernels import patch_factor as PF
from repro_torch.kernels import precond as PC

RTOL, ATOL = 1e-5, 1e-6


def _u(seed, *shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _spd(seed, d):
    """Well-conditioned SPD matrix (eigenvalues in about [1, 2])."""
    r = np.random.default_rng(seed).standard_normal((d, d)) / np.sqrt(4 * d)
    return (np.eye(d) + r @ r.T).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# shapes that tile: against the interpret-mode Pallas kernels
# ---------------------------------------------------------------------------

def test_matmul_ref_matches_pallas():
    a, b, c = _u(0, 256, 128), _u(1, 128, 256), _u(2, 256, 256)
    want = j_matmul(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                    alpha=0.7, beta=0.3, interpret=True)
    _close(MM.matmul_ref(_t(a), _t(b), _t(c), alpha=0.7, beta=0.3), want)


def test_factor_update_ref_matches_pallas():
    x, c = _u(3, 256, 128), _u(4, 128, 128)
    want = j_factor_update(jnp.asarray(x), jnp.asarray(c), alpha=0.05,
                           beta=0.95, interpret=True)
    # alpha/beta as 0-d tensors, as the engine passes them
    got = FU.factor_update_ref(_t(x), _t(c), alpha=torch.tensor(0.05),
                               beta=torch.tensor(0.95))
    _close(got, want)


def test_precondition_ref_matches_pallas():
    a_inv, v, g_inv = _u(5, 256, 256), _u(6, 256, 128), _u(7, 128, 128)
    want = j_precondition(jnp.asarray(a_inv), jnp.asarray(v),
                          jnp.asarray(g_inv), interpret=True)
    _close(PC.precondition_ref(_t(a_inv), _t(v), _t(g_inv)), want)


def test_ns_step_ref_matches_pallas():
    m = _spd(8, 128)
    x = _u(9, 128, 128) / 128.0
    want = j_ns_step(jnp.asarray(m), jnp.asarray(x), interpret=True)
    np.testing.assert_allclose(NS.ns_step_ref(_t(m), _t(x)).numpy(),
                               np.asarray(want), rtol=RTOL,
                               atol=ATOL * np.abs(np.asarray(want)).max())


def test_ns_inverse_ref_matches_pallas():
    m = _spd(10, 128)
    want = j_ns_inverse(jnp.asarray(m), iters=12, interpret=True)
    _close(NS.ns_inverse_ref(_t(m), 12), want)


# ---------------------------------------------------------------------------
# ragged shapes: against the jnp oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(65, 33, 17), (17, 1001, 33),
                                   (1001, 17, 65)])
def test_matmul_ref_ragged(m, k, n):
    a, b, c = _u(11, m, k), _u(12, k, n), _u(13, m, n)
    want = jref.matmul_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                           alpha=-1.0, beta=2.0)
    _close(MM.matmul_ref(_t(a), _t(b), _t(c), alpha=-1.0, beta=2.0), want)


def test_matmul_ref_batched():
    a, b = _u(14, 3, 33, 17), _u(15, 17, 65)
    want = np.stack([np.asarray(jref.matmul_ref(jnp.asarray(a[i]),
                                                jnp.asarray(b)))
                     for i in range(3)])
    _close(MM.matmul_ref(_t(a), _t(b)), want)


@pytest.mark.parametrize("n,d", [(65, 33), (33, 1001), (256, 17)])
def test_factor_update_ref_ragged(n, d):
    x, c = _u(16, n, d), _u(17, d, d)
    want = jref.factor_update_ref(jnp.asarray(x), jnp.asarray(c),
                                  alpha=1.0 / n, beta=0.5)
    _close(FU.factor_update_ref(_t(x), _t(c), alpha=1.0 / n, beta=0.5), want)


@pytest.mark.parametrize("a,g", [(65, 33), (17, 1001)])
def test_precondition_ref_ragged(a, g):
    a_inv, v, g_inv = _u(18, a, a), _u(19, a, g), _u(20, g, g)
    want = jref.precondition_ref(jnp.asarray(a_inv), jnp.asarray(v),
                                 jnp.asarray(g_inv))
    _close(PC.precondition_ref(_t(a_inv), _t(v), _t(g_inv)), want)


@pytest.mark.parametrize("d", [17, 33, 65])
def test_ns_inverse_ref_ragged(d):
    m = _spd(21 + d, d)
    want = jref.ns_inverse_ref(jnp.asarray(m), 12)
    _close(NS.ns_inverse_ref(_t(m), 12), want)
    # batched over a leading dim: each slice is the unbatched inverse
    mb = np.stack([m, 2.0 * m])
    got = NS.ns_inverse_ref(_t(mb), 12)
    _close(got[0], want)


# ---------------------------------------------------------------------------
# routing: CPU tensors take the plain version and launch nothing
# ---------------------------------------------------------------------------

def test_wrappers_route_cpu_tensors_to_plain_versions():
    K.reset_launches()
    a, b, c = _t(_u(30, 33, 17)), _t(_u(31, 17, 65)), _t(_u(32, 33, 65))
    assert torch.equal(MM.matmul(a, b, c, alpha=0.5, beta=2.0),
                       MM.matmul_ref(a, b, c, alpha=0.5, beta=2.0))
    x, f = _t(_u(33, 40, 31)), _t(_u(34, 31, 31))
    eps = torch.tensor(0.9)
    assert torch.equal(FU.factor_update(x, f, alpha=1 - eps, beta=eps),
                       FU.factor_update_ref(x, f, alpha=1 - eps, beta=eps))
    ai, v, gi = _t(_u(35, 31, 31)), _t(_u(36, 31, 30)), _t(_u(37, 30, 30))
    assert torch.equal(PC.precondition(ai, v, gi),
                       PC.precondition_ref(ai, v, gi))
    m = _t(_spd(38, 31))
    assert torch.equal(NS.ns_step(m, ai), NS.ns_step_ref(m, ai))
    assert torch.equal(NS.ns_inverse(m, 3), NS.ns_inverse_ref(m, 3))
    q, kv = _t(_u(39, 1, 4, 9, 16)), _t(_u(40, 1, 2, 9, 16))
    assert torch.equal(FA.flash_attention(q, kv, kv, window=4, cap=5.0),
                       FA.flash_attention_ref(q, kv, kv, window=4, cap=5.0))
    xc, fc = _t(_u(41, 2, 9, 5)), _t(_u(42, 16, 16))
    kw = dict(taps=3, stride=2, padding="SAME", has_bias=True,
              alpha=1 - eps, beta=eps)
    assert torch.equal(PF.patch_factor_update(xc, fc, **kw),
                       PF.patch_factor_update_ref(xc, fc, **kw))
    assert K.launches() == {"matmul": 0, "factor_update": 0,
                            "precondition": 0, "ns_step": 0,
                            "matmul_rescale": 0, "rotate_rescale": 0,
                            "axpy_momentum": 0, "precond_momentum": 0,
                            "flash_decode": 0, "flash_decode_paged": 0,
                            "flash_attention": 0, "patch_factor": 0}

