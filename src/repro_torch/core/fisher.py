"""Exact Fisher quadratic forms via J-products (paper S6.4, S7, Appendix C).

Mirrors ``repro/core/fisher.py`` (``quad_logits``, ``quad_lm``).  The re-scaling / momentum
coefficients need ``δᵢᵀ F δⱼ`` with the exact minibatch Fisher
``F = E[Jᵀ F_R J]``: compute ``J δ`` once per direction and contract through
``F_R`` analytically:

  categorical:  vᵀFv = Σ_tok [ Σ_c p_c ż_c² − (Σ_c p_c ż_c)² ]
  bernoulli:    vᵀFv = Σ     p(1−p) ż²
  gaussian:     vᵀFv = Σ     ż²            (unit variance: F_R = I)

``jax.linearize`` becomes one ``torch.func.jvp`` per tangent (forward-mode,
each repeating the forward pass); :func:`quad_lm` contracts an LM's
J-products through its head in chunks of the sequence.
"""
from __future__ import annotations

from typing import List

import torch
from torch.func import jvp

from repro_torch.models.head import _pick_chunk


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
    elif family == "gaussian":
        q = torch.einsum("mno,kno->mk", zds, zds)
    else:
        raise NotImplementedError(f"family {family!r} is not ported yet")
    return q / n


def quad_lm(model, params, batch, tangents: List, chunk_target: int = 128):
    """(m, m) matrix of δᵢᵀ F δⱼ for an LM, normalized like the mean loss:
    one ``jvp`` of ``model.hidden`` per tangent, then the categorical
    contraction over the vocab in chunks of the sequence (the reference's
    ``quad_lm``), so no (N, V) J-product is materialized."""
    hdots = []
    h = None
    for t in tangents:
        h, hd = jvp(lambda p: model.hidden(p, batch)[0], (params,), (t,))
        hdots.append(hd)
    w = model.head_weight(params).float()
    if model.cfg.tie_embeddings:
        wdots = [t["embed"].T.float() for t in tangents]
    else:
        wdots = [t["head"].float() for t in tangents]
    bsz, t_len, d = h.shape
    n = bsz * t_len
    mask = batch.get("mask")
    mask = (torch.ones(bsz, t_len, device=h.device) if mask is None
            else mask.float())
    chunk = _pick_chunk(t_len, chunk_target)
    cap = model.cfg.logit_softcap
    hdf = torch.stack(hdots).float()                       # (m, B, T, d)
    wdf = torch.stack(wdots)                               # (m, d, V)
    acc = torch.zeros(len(tangents), len(tangents), device=h.device)
    for c0 in range(0, t_len, chunk):
        hc = h[:, c0:c0 + chunk].float()
        hdc = hdf[:, :, c0:c0 + chunk]
        mc = mask[:, c0:c0 + chunk]
        z = hc @ w                                         # (B, c, V)
        zd = (torch.einsum("mbcd,dv->mbcv", hdc, w)
              + torch.einsum("bcd,mdv->mbcv", hc, wdf))
        if cap:
            zd = zd * (1.0 - torch.tanh(z / cap) ** 2)[None]
            z = cap * torch.tanh(z / cap)
        p = torch.softmax(z, dim=-1)
        pz = torch.einsum("bcv,mbcv->mbc", p, zd)          # Σ p ż
        pzz = torch.einsum("bcv,mbcv,kbcv->mkbc", p, zd, zd)
        acc = acc + (torch.einsum("mkbc,bc->mk", pzz, mc)
                     - torch.einsum("mbc,kbc,bc->mk", pz, pz, mc))
    return acc / n
