"""Chunked LM head (mirrors ``repro/models/head.py``): the training loss
with predictive-distribution sampling and the head's curvature statistics
(:func:`lm_head_loss`), and the serving logits (:func:`head_logits`).

In training the logits are never materialized for the whole sequence: a
loop over chunks of the *sequence axis* computes, per (B, c) tile,

* the true-label CE (the objective),
* a sampled label ``ŷ ~ softmax(logits)`` and its CE — the
  *model-distribution* loss whose backward gives the g statistics K-FAC
  needs (S5; never the empirical Fisher),
* in collect mode, the analytic head pre-activation gradient
  ``g = softmax − onehot(ŷ)``, whose squared sum is the head's diagonal G
  factor, and the head input's ``Σ h hᵀ`` (its Ā).

Sampling is ``argmax(logits + gumbel)``, ``jax.random.categorical``'s
arithmetic: the caller's ``rng(shape)`` gives uniforms in (0, 1) for all
chunks at once, shape (n_chunks, B, c, V), and the Gumbel noise is
``−log(−log(u))``.  (The reference draws chunk c's from
``jax.random.split(rng, n_chunks)[c]``; tests hand those draws over.)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.tags import Tagger
from repro_torch.models.layers import softcap

_TINY = torch.finfo(torch.float32).tiny


def _pick_chunk(n: int, target: int) -> int:
    c = max(1, min(n, target))
    while n % c:
        c -= 1
    return c


def sample_targets(logits, u):
    """``argmax(logits + gumbel(u))``: the draw ``jax.random.categorical``
    makes from the key behind the uniforms ``u`` (logits' shape)."""
    gumbel = -torch.log(-torch.log(torch.clamp(u.float(), min=_TINY)))
    return torch.argmax(logits.detach() + gumbel, dim=-1)


def lm_head_loss(tg: Tagger, h, w_head, labels, mask, rng, *,
                 logit_cap: float = 0.0, name: str = "lm_head",
                 chunk_target: int = 128):
    """h: (B, T, d) final hidden; labels/mask: (B, T).

    Returns ``(loss_true, loss_sampled)``, normalized by the token count
    B·T.  ``rng`` None draws no sample (the sampled loss is 0): the
    gradient and lambda passes read only the true loss.  In collect mode
    with a ``name`` (an untied head) it records ``{"aa", "gdiag"}`` (gdiag
    already divided by B·T) on the tagger.
    """
    b, t, d = h.shape
    v = w_head.shape[-1]
    n = b * t
    chunk = _pick_chunk(t, chunk_target)
    nc = t // chunk
    collect = tg.mode == "collect" and name is not None
    u = None if rng is None else rng((nc, b, chunk, v))
    loss_t = h.new_zeros((), dtype=torch.float32)
    loss_s = h.new_zeros((), dtype=torch.float32)
    gsq = h.new_zeros(v, dtype=torch.float32) if collect else None
    aa = h.new_zeros(d, d, dtype=torch.float32) if collect else None
    mask = mask.float()
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        hc, yc, mc = h[:, sl], labels[:, sl].long(), mask[:, sl]
        logits = softcap((hc @ w_head).float(), logit_cap)
        logp = torch.log_softmax(logits, dim=-1)
        loss_t = loss_t - (logp.gather(-1, yc[..., None])[..., 0]
                           * mc).sum()
        if u is None:
            continue
        ys = sample_targets(logits, u[c])
        loss_s = loss_s - (logp.gather(-1, ys[..., None])[..., 0]
                           * mc).sum()
        if collect:
            with torch.no_grad():
                g = (torch.exp(logp) - F.one_hot(ys, v).float()) * mc[..., None]
                gsq += (g * g).sum((0, 1))
                hs = hc.reshape(-1, d).float()
                aa += hs.T @ hs
    if collect:
        tg.records[name] = {"aa": aa, "gdiag": gsq / n}
    return loss_t / n, loss_s / n


def head_logits(h, w_head, logit_cap: float = 0.0):
    """Unchunked logits for serving (decode steps have tiny N)."""
    logits = torch.matmul(h, w_head)
    return softcap(logits.float(), logit_cap)
