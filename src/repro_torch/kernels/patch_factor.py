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
(``csrc/patch_factor.cu``) cuts the (d, d) output into the masked 64×64
tiles of ``csrc/gemm_tile.cuh`` and fills their K slices with an im2col
loader straight from x: zero padding, stride, ragged edges and the constant
1 of the bias feature are all masked reads, so the ``(B·t_out, K·C)`` patch
matrix never exists and every shape runs.  Narrow factors (whisper's conv1,
d = 241) split the rows over the grid as ``factor_update`` does.

Bound on this card: ``2·n·d²`` fp32 operations for ``n = B·t_out`` rows,
the product the kernel computes, against x, the old factor and the new one
moved once: compute-bound (conv2 of whisper-small, 127.5 GFLOP, 1.90 ms at
67 TFLOP/s, against 116 MB, 0.035 ms at 3.35 TB/s).  P̂ᵀP̂ is symmetric:
computing one triangle and mirroring it would halve that, later work as for
``factor_update``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.factor_update import _sm_count, splits


def patch_geometry(x_shape, taps: int, stride: int, padding: str):
    """(lo, t_out) of a 1-D conv over x of shape (B, T, C)."""
    from repro_torch.models.conv import conv_out_len, conv_pad_amounts
    t = x_shape[1]
    return (conv_pad_amounts(t, taps, stride, padding)[0],
            conv_out_len(t, taps, stride, padding))


def patch_factor_update_ref(x, c, *, taps: int, stride: int, padding: str,
                            has_bias: bool, alpha, beta):
    """Plain PyTorch version: explicit patches, ``append_homog``, then
    ``beta·C + alpha·P̂ᵀP̂`` (the CPU path and the card's oracle)."""
    from repro_torch.models.conv import append_homog, extract_patches
    p = extract_patches(x.float(), (taps,), (stride,), padding)
    p = p.reshape(-1, p.shape[-1])
    if has_bias:
        p = append_homog(p)
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
    s = splits(b * t_out, d, _sm_count(x.device.index or 0))
    ws = (torch.empty(s, d, d, device=x.device, dtype=torch.float32)
          if s > 1 else None)
    status = _build.load().lib.repro_patch_factor_f32(
        x.data_ptr(), c.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), b, t, ch, taps, stride, lo,
        t_out, int(has_bias), s, ab.data_ptr(), _build.stream_of(x))
    _build.check(status, "patch_factor")
    patch_factor_update.launches += 1
    return out


patch_factor_update.launches = 0
