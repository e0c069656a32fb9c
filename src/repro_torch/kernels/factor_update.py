"""Fused decayed Kronecker-factor accumulation (paper S5):

    C_new = beta * C_old + alpha * XᵀX

Replaces the Pallas TPU kernel ``repro/kernels/factor_update.py::
factor_update`` (``pallas_call`` at line 56), which streamed X twice through
VMEM and took alpha/beta by scalar prefetch.  The CUDA kernel
(``csrc/factor_update.cu``) runs the pipelined fp32 main loop of
``csrc/gemm_pipeline.cuh`` (128×128 or 64×64 tiles, a ``cp.async`` ring of
K slices) with a loader that stages both operand tiles of XᵀX as they lie
in X (both are k-major), so Xᵀ is never materialized; it copies 16 bytes at
a time when d % 4 == 0 and X is 16-byte aligned (:func:`vec16`), else 4.
XᵀX is symmetric, so only the tiles (i, j) with i ≤ j are launched and each
off-diagonal tile also writes its mirror (with C's own mirrored entries: C
need not be symmetric).  alpha/beta come from a 2-float device buffer: the
decay ε = min(1 − 1/k, cap) is computed on the device each step and is
never read on the host.

Bound on this card: one triangle of the symmetric product, ``N·d·(d+1)``
fp32 operations, against ``4·(N·d + 2·d²)`` bytes — compute-bound at the
path's widths (8.2 GFLOP and 0.123 ms at N = 8192, d = 1001, against 67
TFLOP/s).  The diagonal tiles compute both of their halves.  The launch plan
(``kernels/gemm_plan.py::triangle_plan``) picks the tile and, where the
triangle cannot fill the card (narrow factors against a long N), splits N
over the grid and sums the partials in a second pass.  The LM's stacked
layers pass (S, N, d) with (S, d, d) factors: one launch, grid z over S (no
split: S times the triangle fills the card).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, gemm_plan


def vec16(x) -> bool:
    """Whether the loader may copy x 16 bytes at a time: d % 4 == 0 (every
    row, and every batch slice, starts on a 16-byte boundary) and x 16-byte
    aligned."""
    return x.shape[-1] % 4 == 0 and gemm_plan.aligned16(x)


def factor_update_ref(x, c, *, alpha, beta):
    """Plain PyTorch version (the CPU path and the card's oracle)."""
    x = x.float()
    return alpha * (x.transpose(-1, -2) @ x) + beta * c.float()


def factor_update(x, c, *, alpha, beta):
    """x: ([S,] N, d) activations or cotangents; c: ([S,] d, d) running
    factor(s).  A leading S (the LM's stacked layers) runs as grid z of one
    launch.

    ``alpha``/``beta`` may be Python numbers or 0-d tensors; on the card
    they are packed into one device buffer the kernel reads by pointer.
    CPU tensors take :func:`factor_update_ref`; CUDA tensors launch the
    kernel or raise.
    """
    if x.device.type == "cpu":
        return factor_update_ref(x, c, alpha=alpha, beta=beta)
    _build.require_cuda_f32("factor_update", x, c)
    n, d = x.shape[-2:]
    if x.dim() not in (2, 3) or tuple(c.shape) != (*x.shape[:-2], d, d):
        raise ValueError(f"factor_update: x {tuple(x.shape)}, "
                         f"c {tuple(c.shape)}")
    batch = x.shape[0] if x.dim() == 3 else 1
    x, c = x.contiguous(), c.contiguous()
    ab = _build.scalar_pair(alpha, beta, x.device)
    out = torch.empty_like(c)
    plan = gemm_plan.triangle_plan(d, d, False, n,
                                   gemm_plan.sm_count(x.device.index or 0),
                                   batch)
    ws = (torch.empty(plan.splits, d, d, device=x.device,
                      dtype=torch.float32) if plan.splits > 1 else None)
    status = _build.load().lib.repro_factor_update_f32(
        x.data_ptr(), c.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), batch, n, d, plan.tile,
        plan.tiles, plan.chunk, plan.splits, int(vec16(x)), ab.data_ptr(),
        _build.stream_of(x))
    _build.check(status, "factor_update")
    factor_update.launches += 1
    return out


factor_update.launches = 0
