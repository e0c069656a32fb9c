"""Tiled fp32 matmul with a fused scale/accumulate epilogue:

    out = alpha * (A @ B) + beta * C

Replaces the Pallas TPU kernel ``repro/kernels/matmul.py::matmul``
(``pallas_call`` at line 60).  The TPU kernel walked K as a sequential grid
axis with a VMEM accumulator; Hopper blocks run in no order, so the CUDA
kernel (``csrc/matmul.cu`` over ``csrc/gemm_tile.cuh``) loops over K inside
each block and masks ragged edges instead of requiring 128-multiples.  An
optional leading batch dim rides ``gridDim.z`` (the gamma sweep's 3
candidates, the batched Newton–Schulz refresh).

Bound on this card: fp32 FMA throughput (67 TFLOP/s, no TF32) for every
product on the K-FAC path — ``2·M·N·K`` operations against at most
``4·(MK + KN + 2MN)`` bytes.  The design answers it only with register
blocking (4×4 outputs per thread, 64×64 tiles); tensor cores are later work.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def matmul_ref(a, b, c=None, *, alpha=1.0, beta=0.0):
    """Plain PyTorch version (the CPU path and the card's oracle)."""
    out = alpha * (a.float() @ b.float())
    if c is not None and not (isinstance(beta, (int, float)) and beta == 0):
        out = out + beta * c.float()
    return out


def _batch_stride(t, batch, name):
    if t.dim() == 2:
        return 0
    if t.shape[0] not in (1, batch):
        raise ValueError(f"matmul: batch dim of {name} is {t.shape[0]}, "
                         f"expected 1 or {batch}")
    return 0 if t.shape[0] == 1 else t.shape[1] * t.shape[2]


def matmul(a, b, c=None, *, alpha=1.0, beta=0.0):
    """a: ([B,] M, K); b: ([B,] K, N); c: optional ([B,] M, N).

    ``alpha``/``beta`` may be Python numbers or 0-d tensors.  CPU tensors
    take :func:`matmul_ref`; CUDA tensors launch the kernel or raise.
    """
    if a.device.type == "cpu":
        return matmul_ref(a, b, c, alpha=alpha, beta=beta)
    ops = [a, b] + ([c] if c is not None else [])
    _build.require_cuda_f32("matmul", *ops)
    if not all(t.dim() in (2, 3) for t in ops):
        raise ValueError("matmul: operands must be 2-D or 3-D (one batch dim)")
    m, k = a.shape[-2:]
    k2, n = b.shape[-2:]
    if k != k2 or (c is not None and tuple(c.shape[-2:]) != (m, n)):
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}"
                         f" + {None if c is None else tuple(c.shape)}")
    batch = max([t.shape[0] for t in ops if t.dim() == 3], default=0)
    a, b = a.contiguous(), b.contiguous()
    sa, sb = _batch_stride(a, batch, "a"), _batch_stride(b, batch, "b")
    use_c = c is not None and not (isinstance(beta, (int, float)) and beta == 0)
    if use_c:
        c = c.contiguous()
        sc = _batch_stride(c, batch, "c")
    out = torch.empty(((batch,) if batch else ()) + (m, n), device=a.device,
                      dtype=torch.float32)
    ab = None
    if isinstance(alpha, torch.Tensor) or isinstance(beta, torch.Tensor):
        ab = _build.scalar_pair(alpha, beta, a.device)
    status = _build.load().lib.repro_matmul_f32(
        a.data_ptr(), b.data_ptr(), c.data_ptr() if use_c else None,
        out.data_ptr(), max(batch, 1), m, n, k, sa, sb,
        sc if use_c else 0, m * n if batch else 0,
        None if ab is None else ab.data_ptr(),
        0.0 if ab is not None else float(alpha),
        0.0 if ab is not None else float(beta), _build.stream_of(a))
    _build.check(status, "matmul")
    matmul.launches += 1
    return out


matmul.launches = 0
