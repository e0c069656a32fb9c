"""Kronecker factor statistics (paper S3, S5); mirrors ``repro/core/factors.py``.

Per tagged layer the optimizer keeps running estimates of ``Ā = E[ā āᵀ]``
and ``G = E[g gᵀ]``, blended with the paper's exponentially-decayed scheme
``ε = min(1 − 1/k, ε_max)``.  Every contribution is a raw outer-product sum
divided by the step's *global* token count N.

Factor storage layouts by kind (``lead`` = (n_stack,) for stacked layers):
  full : (*lead, d, d)
  block: (*lead, nb, db, db)  a side above ``KFACConfig.max_factor_dim``,
                              halved until each diagonal block fits
                              (gemma2's d_ff of 9216: two blocks of 4608)
  diag : (*lead, d)           the vocab-sized sides (embed A, head G)
"""
from __future__ import annotations

import torch

from repro_torch.core.tags import LayerMeta

def factor_layout(dim: int, sharded: bool, tp: int, max_dim: int):
    """``(kind, blocks)`` for a factor side of width ``dim``: the side is
    halved (or cut at the next divisor) until each block is at most
    ``max_dim``; ``diag`` where no divisor does.  The port passes
    ``sharded=False, tp=1`` (no tensor-parallel mesh yet)."""
    blocks = 1
    if sharded and tp > 1 and dim % tp == 0:
        blocks = tp
    while dim // blocks > max_dim:
        nxt = blocks * 2
        while dim % nxt and nxt <= dim:
            nxt += blocks
        if nxt > dim:
            return "diag", 1
        blocks = nxt
    return ("block", blocks) if blocks > 1 else ("full", 1)


def factor_shape(dim: int, kind: str, blocks: int = 1, lead=()):
    if kind == "diag":
        return (*lead, dim)
    if kind == "block":
        return (*lead, blocks, dim // blocks, dim // blocks)
    return (*lead, dim, dim)


def outer_sum(x, kind: str = "full", stacked: bool = False,
              blocks: int = 1):
    """Sum of outer products over every batch-ish dim of x (..., d): a
    (d, d) matrix (``full``), its diagonal (``diag``) or the ``blocks``
    diagonal (db, db) blocks of it (``block``: (nb, db, db), the
    reference's ``"nbd,nbe->bde"``).  ``stacked`` keeps x's leading dim:
    (S, ..., d) -> (S, d, d), (S, d) or (S, nb, db, db)."""
    xf = x.float()
    xf = (xf.reshape(xf.shape[0], -1, xf.shape[-1]) if stacked
          else xf.reshape(-1, xf.shape[-1]))
    if kind == "diag":
        return (xf * xf).sum(-2)
    if kind == "block":
        d = xf.shape[-1]
        xr = xf.reshape(*xf.shape[:-1], blocks, d // blocks)
        return torch.einsum("...nbd,...nbe->...bde", xr, xr)
    if kind != "full":
        raise ValueError(f"unknown factor kind {kind!r}")
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
    return outer_sum(cot.detach(), meta.g_kind, stacked=meta.n_stack > 0,
                     blocks=meta.g_blocks) * float(n_norm)
