"""EKFAC eigenbasis apply (George et al. 2018), paper S4.2 in the
Kronecker eigenbasis:

    U = Q_A [ (Q_Aᵀ V Q_G) / (S + λ) ] Q_Gᵀ

Replaces ``repro/kernels/rotate_rescale.py::matmul_rescale`` (``pallas_call``
at line 66) and ``rotate_rescale`` (line 86).  ``matmul_rescale`` is its own
CUDA kernel (``csrc/rotate_rescale.cu``): the pipelined fp32 main loop of
``csrc/gemm_pipeline.cuh`` (64×64 tiles, 4×4 register patches, a
``cp.async`` ring of K slices) with the division by ``S + λ`` as its
epilogue, so the rotated gradient is divided while it is still in
registers.  The launch plan (``kernels/gemm_plan.py::dense_plan``) picks,
where the output's tiles cannot fill the card, a split of K whose partial
sums a second pass adds in a fixed order and divides; B's rows are copied
16 bytes at a time when its width and address allow it, and A is staged
as rows by 16-byte copies where K % 4 == 0 (:func:`gemm_plan.dense_rows16`),
else k-major by 4-byte copies.  λ comes by
value or, as a 0-d tensor, by device pointer (no host read).
``rotate_rescale`` is four launches, in the TPU kernel's order:
``matmul(Q_Aᵀ, V)``, ``matmul_rescale(·, Q_G, S, λ)``, ``matmul(Q_A, ·)``,
``matmul(·, Q_Gᵀ)``, each over an optional leading batch dim (the LM's
stacked layers: one launch of each for all of them).  The tile reads
row-major operands only, so the two transposes are copies (``B·(a² + g²)``
floats read and written, counted in the bound's bytes).

Bound on this card: fp32 FMA throughput, ``2·a·g·(a + g)`` operations for
each of the two rotations of an (a, g) weight — 18.0 GFLOP (0.269 ms at
67 TFLOP/s) for the 8 layers of the full-width autoencoder, of which the
8 ``matmul_rescale`` products are 4.49 GFLOP (0.067 ms).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, gemm_plan
from repro_torch.kernels.matmul import matmul, operands


def matmul_rescale_ref(a, b, s, lam=0.0):
    """Plain PyTorch version (the CPU path and the card's oracle)."""
    return (a.float() @ b.float()) / (s.float() + lam)


def matmul_rescale(a, b, s, lam=0.0):
    """``(a @ b) / (s + lam)``; a: ([B,] M, K); b: ([B,] K, N);
    s: ([B,] M, N).  ``lam`` is a Python number or a 0-d tensor.  CPU
    tensors take :func:`matmul_rescale_ref`; CUDA tensors launch the kernel
    or raise."""
    if a.device.type == "cpu":
        return matmul_rescale_ref(a, b, s, lam)
    op = operands("matmul_rescale", a, b, s)
    # a tensor lam is read on the device, by pointer (no host read)
    lam_dev = (lam.to(device=op.a.device, dtype=torch.float32).reshape(())
               if isinstance(lam, torch.Tensor) else None)
    batch = max(op.batch, 1)
    plan = gemm_plan.dense_plan(batch, op.m, op.n, op.k,
                                gemm_plan.sm_count(op.a.device.index or 0))
    ws = (torch.empty(plan.splits, batch * op.m * op.n, device=op.a.device,
                      dtype=torch.float32) if plan.splits > 1 else None)
    status = _build.load().lib.repro_matmul_rescale_f32(
        op.a.data_ptr(), op.b.data_ptr(), op.epi[0].data_ptr(),
        op.out.data_ptr(), None if ws is None else ws.data_ptr(), batch,
        op.m, op.n, op.k, *op.strides, op.m * op.n if op.batch else 0,
        None if lam_dev is None else lam_dev.data_ptr(),
        0.0 if lam_dev is not None else float(lam), plan.chunk, plan.splits,
        int(gemm_plan.dense_vec16(op)),
        int(gemm_plan.dense_rows16(op, plan.tile)), _build.stream_of(op.a))
    _build.check(status, "matmul_rescale")
    matmul_rescale.launches += 1
    return op.out


matmul_rescale.launches = 0


def rotate_rescale_ref(qa, v, qg, s, lam=0.0):
    """Plain PyTorch version, in the kernel's order of products."""
    qa, qg = qa.float(), qg.float()
    t = qa.transpose(-1, -2) @ v.float()
    t = matmul_rescale_ref(t, qg, s, lam)
    return (qa @ t) @ qg.transpose(-1, -2)


def rotate_rescale(qa, v, qg, s, lam=0.0):
    """qa: ([B,] a, a); v: ([B,] a, g); qg: ([B,] g, g); s: ([B,] a, g),
    the batch a stack of layers (the reference vmaps its kernel over it).
    CPU tensors take :func:`rotate_rescale_ref`; CUDA tensors launch the
    four kernels, each over the whole batch."""
    if v.device.type == "cpu":
        return rotate_rescale_ref(qa, v, qg, s, lam)
    t = matmul(qa.transpose(-1, -2).contiguous(), v)     # Q_Aᵀ V
    t = matmul_rescale(t, qg, s, lam)                    # (· Q_G) / (S + λ)
    t = matmul(qa, t)                                    # Q_A ·
    u = matmul(t, qg.transpose(-1, -2).contiguous())     # · Q_Gᵀ
    rotate_rescale.launches += 1
    return u


rotate_rescale.launches = 0
