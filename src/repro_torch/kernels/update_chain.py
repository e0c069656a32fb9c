"""The fused fixed-learning-rate update chain (paper S4.2 + S7):

    D = α·(Ā⁻¹ V Ḡ⁻¹) + μ·M,      ΣD² as a by-product

Replaces ``repro/kernels/update_chain.py::axpy_momentum`` (``pallas_call``
at line 73) and ``precond_momentum`` (line 99).  Every operand may carry
one leading batch dim (the LM's stacked layers, grid z of both launches;
the reference sends a stacked layer to a plain composition instead).
``precond_momentum`` is two launches: ``T = V Ḡ⁻¹`` through :func:`matmul`, then ``axpy_momentum``
(``csrc/update_chain.cu``): the pipelined fp32 main loop of
``csrc/gemm_pipeline.cuh`` on 64×64 tiles (4×4 register patches, a
``cp.async`` ring of K slices), whose epilogue forms ``α·(Ā⁻¹T) + μ·M`` in
registers and sums D² over each tile's valid entries into one float per
tile (:func:`partials_grid`), in a fixed order, with no atomics.  The
wrapper sums those partials on the device, so the global-norm and KL clips
never re-read D.  K stays whole (a split of it lost at the autoencoder's 8
layers); B's rows are copied 16 bytes at a time and A staged as rows where
:func:`gemm_plan.dense_vec16` and :func:`gemm_plan.dense_rows16` allow.  α
and μ are read from a 2-float device buffer (no host read).  The TPU kernel's
partials grid was ``(M//128, N//128)``; this one follows the 64-tiles, so
only the sum is comparable.

Bound on this card: fp32 FMA throughput, ``2·a²·g`` operations for
``axpy_momentum`` on an (a, g) weight — 4.50 GFLOP (0.0673 ms at 67
TFLOP/s) for the 8 layers of the full-width autoencoder — and
``2·a·g·(a + g)`` for the chain, 9.0 GFLOP (0.134 ms).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, gemm_plan
from repro_torch.kernels.matmul import matmul, operands


def partials_grid(m: int, n: int) -> tuple:
    """The shape of ``axpy_momentum``'s ΣD² partials for an (m, n) D: one
    float per output tile of :data:`gemm_plan.DENSE_TILE`."""
    tile = gemm_plan.DENSE_TILE
    return -(-m // tile), -(-n // tile)


def axpy_momentum_ref(a_inv, t, mom, alpha, mu):
    """Plain PyTorch version: ``(D, ΣD²)``."""
    d = alpha * (a_inv.float() @ t.float()) + mu * mom.float()
    return d, torch.sum(d * d)


def axpy_momentum(a_inv, t, mom, alpha, mu):
    """``D = alpha·(a_inv @ t) + mu·mom`` and ``ΣD²`` (a 0-d tensor).

    a_inv: ([B,] M, K); t: ([B,] K, N); mom: ([B,] M, N), the batch a
    stack of layers (grid z; ΣD² over all of them); ``alpha``/``mu``
    Python numbers or 0-d tensors.  CPU tensors take
    :func:`axpy_momentum_ref`; CUDA tensors launch the kernel or raise."""
    if t.device.type == "cpu":
        return axpy_momentum_ref(a_inv, t, mom, alpha, mu)
    op = operands("axpy_momentum", a_inv, t, mom)
    am = _build.scalar_pair(alpha, mu, op.a.device)
    batch = max(op.batch, 1)
    # one grid of tile partials per batch item, summed in a fixed order
    partials = torch.empty((batch, *partials_grid(op.m, op.n)),
                           device=op.a.device, dtype=torch.float32)
    status = _build.load().lib.repro_axpy_momentum_f32(
        op.a.data_ptr(), op.b.data_ptr(), op.epi[0].data_ptr(),
        op.out.data_ptr(), partials.data_ptr(), batch, op.m, op.n, op.k,
        *op.strides, am.data_ptr(), int(gemm_plan.dense_vec16(op)),
        int(gemm_plan.dense_rows16(op, gemm_plan.DENSE_TILE)),
        _build.stream_of(op.a))
    _build.check(status, "axpy_momentum")
    axpy_momentum.launches += 1
    return op.out, partials.sum()


axpy_momentum.launches = 0


def precond_momentum_ref(a_inv, v, g_inv, mom, *, alpha, mu):
    """Plain PyTorch version, in the kernel's order (``T = V Ḡ⁻¹`` first)."""
    return axpy_momentum_ref(a_inv, v.float() @ g_inv.float(), mom, alpha, mu)


def precond_momentum(a_inv, v, g_inv, mom, *, alpha, mu):
    """a_inv: ([B,] a, a); v: ([B,] a, g); g_inv: ([B,] g, g); mom: ([B,]
    a, g).  Returns
    ``(D, ΣD²)``.  CPU tensors take :func:`precond_momentum_ref`; CUDA
    tensors launch ``matmul`` and ``axpy_momentum``."""
    if v.device.type == "cpu":
        return precond_momentum_ref(a_inv, v, g_inv, mom, alpha=alpha, mu=mu)
    out = axpy_momentum(a_inv, matmul(v, g_inv), mom, alpha, mu)
    precond_momentum.launches += 1
    return out


precond_momentum.launches = 0
