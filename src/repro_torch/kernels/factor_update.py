"""Fused decayed Kronecker-factor accumulation (paper S5):

    C_new = beta * C_old + alpha * XᵀX

Replaces the Pallas TPU kernel ``repro/kernels/factor_update.py::
factor_update`` (``pallas_call`` at line 56), which streamed X twice through
VMEM and took alpha/beta by scalar prefetch.  The CUDA kernel
(``csrc/factor_update.cu``) reads X as both operands and folds the
transpose into its tile load, so Xᵀ is never materialized, and it reads
alpha/beta from a 2-float device buffer: the decay ε = min(1 − 1/k, cap) is
computed on the device each step and is never read on the host.

Bound on this card: XᵀX is symmetric, so the function needs only its
d(d+1)/2 distinct entries, ``N·d·(d+1)`` fp32 operations, against
``4·(N·d + 2·d²)`` bytes — compute-bound at the path's widths (8.2 GFLOP
and 0.123 ms at N = 8192, d = 1001, against 67 TFLOP/s).  A (d, d) output
has few 64×64 tiles (one at d = 30) against a long N, so narrow factors
split N over the grid (:func:`splits`) and sum the partials in a second
pass.  The LM's stacked layers pass (S, N, d) with (S, d, d) factors: one
launch, grid z over S (no split: S times the tiles fill the card).  The
kernel computes the whole (d, d) product, twice the work the bound counts;
computing one triangle and mirroring it is later work.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build

_TILE = 64              # output tile edge of csrc/gemm_tile.cuh
_MIN_ROWS = 64          # fewest rows of X one split sums


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits(n: int, d: int, sms: int) -> int:
    """How many chunks the N rows of X are cut into: enough output tiles
    times chunks to fill two blocks per SM, each chunk at least 64 rows."""
    tiles = (-(-d // _TILE)) ** 2
    return max(1, min((2 * sms) // tiles, n // _MIN_ROWS))


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
    CPU tensors take :func:`factor_update_ref`.
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
    s = splits(n, d, _sm_count(x.device.index or 0)) if batch == 1 else 1
    ws = (torch.empty(s, d, d, device=x.device, dtype=torch.float32)
          if s > 1 else None)
    status = _build.load().lib.repro_factor_update_f32(
        x.data_ptr(), c.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), batch, n, d, s, ab.data_ptr(),
        _build.stream_of(x))
    _build.check(status, "factor_update")
    factor_update.launches += 1
    return out


factor_update.launches = 0
