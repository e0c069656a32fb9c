"""Exact Fisher quadratic forms via J-products (paper S6.4, S7, Appendix C).

Mirrors ``repro/core/fisher.py::quad_logits``.  The re-scaling / momentum
coefficients need ``δᵢᵀ F δⱼ`` with the exact minibatch Fisher
``F = E[Jᵀ F_R J]``: compute ``J δ`` once per direction and contract through
``F_R`` analytically:

  categorical:  vᵀFv = Σ_tok [ Σ_c p_c ż_c² − (Σ_c p_c ż_c)² ]
  bernoulli:    vᵀFv = Σ     p(1−p) ż²

``jax.linearize`` becomes one ``torch.func.jvp`` per tangent (forward-mode,
each repeating the forward pass).  ``quad_lm`` waits for the LM slice.
"""
from __future__ import annotations

from typing import List

import torch
from torch.func import jvp


def quad_logits(logits_fn, params, batch, tangents: List, family: str):
    """(m, m) quadratic for small-output models (MLP autoencoders)."""
    z = None
    zds = []
    for t in tangents:
        z, zd = jvp(logits_fn, (params,), (t,))
        zds.append(zd)
    zds = torch.stack(zds).float()                            # (m, B, O)
    z = z.float()
    n = z.shape[0]
    if family == "categorical":
        p = torch.softmax(z, dim=-1)
        pz = torch.einsum("no,mno->mn", p, zds)
        q = torch.einsum("no,mno,kno->mk", p, zds, zds) - torch.einsum(
            "mn,kn->mk", pz, pz)
    elif family == "bernoulli":
        p = torch.sigmoid(z)
        r = p * (1.0 - p)
        q = torch.einsum("no,mno,kno->mk", r, zds, zds)
    else:
        raise NotImplementedError(f"family {family!r} is not ported yet")
    return q / n
