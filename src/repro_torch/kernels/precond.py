"""Two-sided K-FAC preconditioning (paper S4.2):

    U = Ā⁻¹ (V Ḡ⁻¹)

Replaces ``repro/kernels/precond.py::precondition``, which is two launches
of the Pallas matmul; here it is two launches of the CUDA :func:`matmul`,
in the TPU kernel's order (``T = V Ḡ⁻¹`` first).  The reference's jnp path
(``core/inverse.py::apply_block_inverse``) computes ``Ā⁻¹ V`` first, so the
two agree to rounding, not bitwise.

Bound on this card: ``2·a·g·(a + g)`` fp32 operations for an (a, g) weight —
9.0 GFLOP (0.134 ms at 67 TFLOP/s) for the 8 layers of the full-width
autoencoder.  Nothing is fused across the two products yet.
"""
from __future__ import annotations

from repro_torch.kernels.matmul import matmul


def precondition_ref(a_inv, v, g_inv):
    """Plain PyTorch version, in the kernel's order."""
    return a_inv.float() @ (v.float() @ g_inv.float())


def precondition(a_inv, v, g_inv):
    """a_inv: (a, a); v: (a, g); g_inv: (g, g).  CPU tensors take
    :func:`precondition_ref`; CUDA tensors launch two matmul kernels."""
    if v.device.type == "cpu":
        return precondition_ref(a_inv, v, g_inv)
    u = matmul(a_inv, matmul(v, g_inv))
    precondition.launches += 1
    return u


precondition.launches = 0
