"""Fused im2col + decayed KFC patch-factor accumulation (1602.01407 §3):

    Ā_new = beta * Ā_old + alpha * P̂ᵀP̂,    P̂ = [im2col(x); 1]

for a 1-D convolution, read from the raw ``(B, T, C)`` input.

Replaces the Pallas TPU kernel ``repro/kernels/patch_factor.py::
patch_factor`` (line 83, ``pallas_call`` at line 106) with its caller
``patch_factor_update`` (line 128).  The TPU kernel grids over tap pairs,
streams the padded input once per pair through VMEM with a halo block, and
splices the homogeneous bias border on in jnp; it declines (returns None)
unless ``C <= 128``, ``C % 8 == 0`` and ``t_out`` tiles, which whisper-small
at full width never meets (t_out 3000, conv2's C 768).  The CUDA kernel
(``csrc/patch_factor.cu``) runs the pipelined fp32 main loop of
``csrc/gemm_pipeline.cuh`` (128×128 or 64×64 tiles, a ``cp.async`` ring of
K slices) with an im2col loader that fills both operand
tiles straight from x: zero padding, stride, ragged edges and the constant
1 of the bias feature are masked copies, so the ``(B·t_out, K·C)`` patch
matrix never exists and every shape runs.  P̂ᵀP̂ is symmetric, so only the
tiles (i, j) with i ≤ j are launched and each off-diagonal tile also writes
its mirror (with C's own mirrored entries: C need not be symmetric).  The
launch plan (``kernels/gemm_plan.py::triangle_plan``) picks the tile, splits
the rows over the grid where the triangle cannot fill the card (whisper's
conv1, d = 241), and folds the bias feature into the last tile column when
the core features fill whole tiles (conv2, d = 2305 = 18·128 + 1); x is
copied 16 bytes at a time when C % 4 == 0 and x is 16-byte aligned.

Bound on this card: one triangle of the symmetric product, ``N·d·(d+1)``
fp32 operations for ``N = B·t_out`` rows, against x, the old factor and the
new one moved once: compute-bound (both whisper-small stems, 65.2 GFLOP,
0.973 ms at 67 TFLOP/s, against 124 MB, 0.037 ms at 3.35 TB/s).  The
diagonal tiles compute both of their halves.
"""
from __future__ import annotations

import torch

from repro_torch.core.patches import (conv_out_len, conv_pad_amounts,
                                      patch_rows)
from repro_torch.kernels import _build, gemm_plan


def patch_geometry(x_shape, taps: int, stride: int, padding: str):
    """(lo, t_out) of a 1-D conv over x of shape (B, T, C)."""
    t = x_shape[1]
    return (conv_pad_amounts(t, taps, stride, padding)[0],
            conv_out_len(t, taps, stride, padding))


def vec16(x) -> bool:
    """Whether the im2col loader may copy x 16 bytes at a time: C % 4 == 0
    (a 4-channel chunk never straddles a tap) and x 16-byte aligned."""
    return x.shape[-1] % 4 == 0 and gemm_plan.aligned16(x)


def patch_factor_update_ref(x, c, *, taps: int, stride: int, padding: str,
                            has_bias: bool, alpha, beta):
    """Plain PyTorch version: explicit patches, ``append_homog``, then
    ``beta·C + alpha·P̂ᵀP̂`` (the CPU path and the card's oracle)."""
    p = patch_rows(x.float(), (taps,), (stride,), padding, has_bias)
    return alpha * (p.T @ p) + beta * c.float()


def patch_factor_update(x, c, *, taps: int, stride: int, padding: str,
                        has_bias: bool, alpha, beta):
    """x: (B, T, C) raw conv input; c: (d, d) running factor with
    ``d = taps·C + has_bias`` (the homogeneous row and column last).

    ``alpha``/``beta`` may be Python numbers or 0-d tensors (read by device
    pointer on the card).  CPU tensors take :func:`patch_factor_update_ref`;
    CUDA tensors launch the kernel or raise.
    """
    if x.device.type == "cpu":
        return patch_factor_update_ref(x, c, taps=taps, stride=stride,
                                       padding=padding, has_bias=has_bias,
                                       alpha=alpha, beta=beta)
    _build.require_cuda_f32("patch_factor_update", x, c)
    if x.dim() != 3:
        raise ValueError(f"patch_factor_update: x must be (B, T, C), got "
                         f"{tuple(x.shape)}")
    b, t, ch = x.shape
    d = taps * ch + (1 if has_bias else 0)
    if tuple(c.shape) != (d, d):
        raise ValueError(f"patch_factor_update: c {tuple(c.shape)}, "
                         f"expected ({d}, {d})")
    lo, t_out = patch_geometry(x.shape, taps, stride, padding)
    x, c = x.contiguous(), c.contiguous()
    ab = _build.scalar_pair(alpha, beta, x.device)
    out = torch.empty_like(c)
    core = taps * ch
    plan = gemm_plan.triangle_plan(d, core, bool(has_bias), b * t_out,
                                   gemm_plan.sm_count(x.device.index or 0))
    ws = (torch.empty(plan.splits, d, d, device=x.device,
                      dtype=torch.float32) if plan.splits > 1 else None)
    status = _build.load().lib.repro_patch_factor_f32(
        x.data_ptr(), c.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), b, t, ch, taps, stride, lo,
        t_out, int(has_bias), plan.tile, plan.tiles, int(plan.fold),
        plan.chunk, plan.splits, int(vec16(x)), ab.data_ptr(),
        _build.stream_of(x))
    _build.check(status, "patch_factor")
    patch_factor_update.launches += 1
    return out


patch_factor_update.launches = 0
