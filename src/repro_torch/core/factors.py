"""Kronecker factor statistics (paper S3, S5); mirrors ``repro/core/factors.py``.

Per tagged layer the optimizer keeps running estimates of ``Ā = E[ā āᵀ]``
and ``G = E[g gᵀ]``, blended with the paper's exponentially-decayed scheme
``ε = min(1 − 1/k, ε_max)``.  Every contribution is a raw outer-product sum
divided by the step's *global* token count N.

Factor storage layouts by kind (``lead`` = (n_stack,) for stacked layers):
  full : (*lead, d, d)
  diag : (*lead, d)         the vocab-sized sides (embed A, head G)
A dense or conv side above ``MAX_FACTOR_DIM`` is of kind ``block`` (the
reference's TP / block-diagonal factors), which no curvature block handles
yet: the optimizer refuses such a layer (gemma2's d_ff of 9216 is the
first); every side of whisper-small is at most 3072.
"""
from __future__ import annotations

import torch

from repro_torch.core.tags import LayerMeta

# the reference's ``KFACConfig.max_factor_dim`` default
MAX_FACTOR_DIM = 8_192


def factor_layout(dim: int) -> str:
    """The kind of a dense or conv factor side of width ``dim``."""
    return "full" if dim <= MAX_FACTOR_DIM else "block"


def factor_shape(dim: int, kind: str, lead=()):
    return (*lead, dim) if kind == "diag" else (*lead, dim, dim)


def outer_sum(x, kind: str = "full", stacked: bool = False):
    """Sum of outer products over every batch-ish dim of x (..., d): a
    (d, d) matrix (``full``) or its diagonal (``diag``).  ``stacked`` keeps
    x's leading dim: (S, ..., d) -> (S, d, d) or (S, d)."""
    xf = x.float()
    xf = (xf.reshape(xf.shape[0], -1, xf.shape[-1]) if stacked
          else xf.reshape(-1, xf.shape[-1]))
    if kind == "diag":
        return (xf * xf).sum(-2)
    if kind != "full":
        raise NotImplementedError(f"factor kind {kind!r} is not ported yet")
    return xf.transpose(-1, -2) @ xf


def embed_diag_counts(ids, mask, vocab: int):
    """Diagonal Ā for an embedding: token frequencies (sum, not
    normalized)."""
    out = torch.zeros(vocab, dtype=torch.float32, device=ids.device)
    return out.index_add_(0, ids.reshape(-1).long(),
                          mask.reshape(-1).float())


def decay_eps(k, cap: float):
    """Paper S5: ε = min(1 − 1/k, cap); k is the 1-based stats update count
    (a device tensor, so ε stays on the device)."""
    kf = torch.clamp(k.float(), min=1.0)
    return torch.clamp(1.0 - 1.0 / kf, max=cap)


def blend(old, new, eps):
    return {k: eps * old[k] + (1.0 - eps) * new[k] for k in old}


def g_from_cotangent(cot, meta: LayerMeta, n_norm: int):
    """G contribution from probe cotangents of the (1/N)-normalized sampled
    loss: per-token g = N * cot, and G = (1/N) Σ g gᵀ = N Σ cot cotᵀ
    (per group for a stacked layer)."""
    return outer_sum(cot.detach(), meta.g_kind,
                     stacked=meta.n_stack > 0) * float(n_norm)
