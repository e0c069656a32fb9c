"""Newton–Schulz inverse iteration as two CUDA matmul launches:

    X' = X (2I − M X)  =  2 X − X (M X)

Replaces ``repro/kernels/ns_step.py::ns_step`` and ``ns_inverse``, two
launches of the Pallas matmul.  Step 1 computes ``Z = M X``; step 2 uses the
matmul epilogue (alpha = −1, beta = 2, C = X) so the identity never
materializes.  Both take an optional leading batch dim (the gamma sweep
stacks 3 candidates).

Bound on this card: ``4·d³`` fp32 operations per step per matrix — a full
refresh of the 16 factors of the full-width autoencoder at 12 iterations is
265.7 GFLOP, 3.97 ms at 67 TFLOP/s.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.matmul import matmul


def ns_step_ref(m, x):
    """Plain PyTorch version of one step, in the kernel's arithmetic."""
    m, x = m.float(), x.float()
    return 2.0 * x - x @ (m @ x)


def ns_step(m, x):
    """One Newton–Schulz iteration for M⁻¹; m, x: ([B,] d, d).  CPU tensors
    take :func:`ns_step_ref`; CUDA tensors launch two matmul kernels."""
    if m.device.type == "cpu":
        return ns_step_ref(m, x)
    out = matmul(x, matmul(m, x), x, alpha=-1.0, beta=2.0)
    ns_step.launches += 1
    return out


ns_step.launches = 0


def cold_start(m):
    """X0 = I / ‖M‖_inf, batched over leading dims."""
    lam = torch.amax(torch.sum(torch.abs(m), dim=-1), dim=-1)
    eye = torch.eye(m.shape[-1], dtype=torch.float32, device=m.device)
    return eye / lam[..., None, None]


def _ns_inverse(step, m, iters):
    x = cold_start(m)
    for _ in range(iters):
        x = step(m, x)
    return 0.5 * (x + x.transpose(-1, -2))


def ns_inverse_ref(m, iters: int):
    """Cold-started inversion through :func:`ns_step_ref`."""
    return _ns_inverse(ns_step_ref, m, iters)


def ns_inverse(m, iters: int):
    """Full inversion: cold start X0 = I/‖M‖_inf, ``iters`` steps of
    :func:`ns_step`, then symmetrize."""
    return _ns_inverse(ns_step, m, iters)
