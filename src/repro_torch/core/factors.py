"""Kronecker factor statistics (paper S3, S5); mirrors ``repro/core/factors.py``.

Per tagged layer the optimizer keeps running estimates of ``Ā = E[ā āᵀ]``
and ``G = E[g gᵀ]``, blended with the paper's exponentially-decayed scheme
``ε = min(1 − 1/k, ε_max)``.  Every contribution is a raw outer-product sum
divided by the step's token count N.  Only the ``full`` layout is ported.
"""
from __future__ import annotations

import torch

from repro_torch.core.tags import LayerMeta


def outer_sum(x):
    """Σ over every batch-ish dim of x xᵀ; x: (..., d) -> (d, d)."""
    xf = x.reshape(-1, x.shape[-1]).float()
    return xf.T @ xf


def decay_eps(k, cap: float):
    """Paper S5: ε = min(1 − 1/k, cap); k is the 1-based stats update count
    (a device tensor, so ε stays on the device)."""
    kf = torch.clamp(k.float(), min=1.0)
    return torch.clamp(1.0 - 1.0 / kf, max=cap)


def blend(old, new, eps):
    return {k: eps * old[k] + (1.0 - eps) * new[k] for k in old}


def g_from_cotangent(cot, meta: LayerMeta, n_norm: int):
    """G contribution from probe cotangents of the (1/N)-normalized sampled
    loss: per-token g = N * cot, and G = (1/N) Σ g gᵀ = N Σ cot cotᵀ."""
    return outer_sum(cot.detach()) * float(n_norm)
