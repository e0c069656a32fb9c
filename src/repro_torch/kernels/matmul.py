"""Tiled fp32 matmul with a fused scale/accumulate epilogue:

    out = alpha * (A @ B) + beta * C

Replaces the Pallas TPU kernel ``repro/kernels/matmul.py::matmul``
(``pallas_call`` at line 60).  The TPU kernel walked K as a sequential grid
axis with a VMEM accumulator; Hopper blocks run in no order, so the CUDA
kernel (``csrc/matmul.cu``) runs the pipelined fp32 main loop of
``csrc/gemm_pipeline.cuh`` over K inside each block (a ``cp.async`` ring of
16-row slices) and masks ragged edges instead of requiring 128-multiples.
An optional leading batch dim rides grid z (the gamma sweep's 3
candidates, the batched Newton–Schulz refresh, whisper's stacked layers);
C may be absent or broadcast over the batch.

Bound on this card: fp32 FMA throughput (67 TFLOP/s, no TF32) for every
product on the K-FAC path — ``2·M·N·K`` operations against at most
``4·(MK + KN + 2MN)`` bytes.  The launch plan
(``kernels/gemm_plan.py::dense_plan`` over :data:`gemm_plan.MATMUL_TILES`)
picks a 128×128 tile (8×8 register patches) where the output's tiles fill
the card, else a 64×64 one (4×4), and where even those cannot fill it, a
split of K whose partial sums a second pass adds in a fixed order.  B's
rows are copied 16 bytes at a time where :func:`gemm_plan.dense_vec16`
allows (the 128 tile takes no other B: :func:`gemm_plan.matmul_tiles`); A
is staged as rows by 16-byte copies where :func:`gemm_plan.dense_rows16`
allows (the 64 tile, K % 4 == 0), else k-major by 4-byte copies.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from repro_torch.kernels import _build, gemm_plan


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
        raise ValueError(f"batch dim of {name} is {t.shape[0]}, expected 1 "
                         f"or {batch}")
    return 0 if t.shape[0] == 1 else t.shape[1] * t.shape[2]


class Operands(NamedTuple):
    a: torch.Tensor         # row-major copies (views when already so)
    b: torch.Tensor
    epi: List[torch.Tensor]  # epilogue operands
    batch: int              # 0: no batch dim
    m: int
    n: int
    k: int
    strides: List[int]      # batch strides of a, b, *epi (0 broadcasts)
    out: torch.Tensor       # ([batch,] m, n), uninitialized


def operands(name, a, b, *epi) -> Operands:
    """The checks and layout every wrapper of the shared tile needs:
    a ([B,] M, K) @ b ([B,] K, N) with epilogue operands ([B,] M, N), all
    float32 on one CUDA device, at most one batch dim; raises otherwise.
    Every operand is made row-major (``.contiguous()``): a transposed view
    such as ``q.T`` is copied."""
    ops = [a, b, *epi]
    _build.require_cuda_f32(name, *ops)
    if not all(t.dim() in (2, 3) for t in ops):
        raise ValueError(f"{name}: operands must be 2-D or 3-D (one batch "
                         f"dim)")
    m, k = a.shape[-2:]
    k2, n = b.shape[-2:]
    if k != k2 or any(tuple(t.shape[-2:]) != (m, n) for t in epi):
        raise ValueError(f"{name}: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} with "
                         f"{[tuple(t.shape) for t in epi]}")
    batch = max([t.shape[0] for t in ops if t.dim() == 3], default=0)
    a, b, epi = a.contiguous(), b.contiguous(), [t.contiguous() for t in epi]
    strides = [_batch_stride(t, batch, f"{name} operand {i}")
               for i, t in enumerate((a, b, *epi))]
    out = torch.empty(((batch,) if batch else ()) + (m, n), device=a.device,
                      dtype=torch.float32)
    return Operands(a, b, epi, batch, m, n, k, strides, out)


def matmul(a, b, c=None, *, alpha=1.0, beta=0.0):
    """a: ([B,] M, K); b: ([B,] K, N); c: optional ([B,] M, N).

    ``alpha``/``beta`` may be Python numbers or 0-d tensors.  CPU tensors
    take :func:`matmul_ref`; CUDA tensors launch the kernel or raise.
    """
    if a.device.type == "cpu":
        return matmul_ref(a, b, c, alpha=alpha, beta=beta)
    op = operands("matmul", a, b, *([] if c is None else [c]))
    use_c = c is not None and not (isinstance(beta, (int, float)) and beta == 0)
    ab = None
    if isinstance(alpha, torch.Tensor) or isinstance(beta, torch.Tensor):
        ab = _build.scalar_pair(alpha, beta, op.a.device)
    batch = max(op.batch, 1)
    plan = gemm_plan.dense_plan(batch, op.m, op.n, op.k,
                                gemm_plan.sm_count(op.a.device.index or 0),
                                gemm_plan.matmul_tiles(op))
    ws = (torch.empty(plan.splits, batch * op.m * op.n, device=op.a.device,
                      dtype=torch.float32) if plan.splits > 1 else None)
    status = _build.load().lib.repro_matmul_f32(
        op.a.data_ptr(), op.b.data_ptr(),
        op.epi[0].data_ptr() if use_c else None, op.out.data_ptr(),
        None if ws is None else ws.data_ptr(), batch, op.m, op.n, op.k,
        op.strides[0], op.strides[1], op.strides[2] if use_c else 0,
        op.m * op.n if op.batch else 0,
        None if ab is None else ab.data_ptr(),
        0.0 if ab is not None else float(alpha),
        0.0 if ab is not None else float(beta), plan.tile, plan.chunk,
        plan.splits, int(gemm_plan.dense_vec16(op)),
        int(gemm_plan.dense_rows16(op, plan.tile)), _build.stream_of(op.a))
    _build.check(status, "matmul")
    matmul.launches += 1
    return op.out


matmul.launches = 0
