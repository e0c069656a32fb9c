"""Shared LM layers: norm, dense, softcap, RoPE, attention (mirrors
``repro/models/layers.py``).

Attention is computed in query chunks with a plain per-chunk softmax (each
chunk sees the full key range), which bounds the score buffer to
``(B, Hkv, G, chunk, Tk)``.  Prefill attention is plain PyTorch here as it
is jnp in the reference: no TPU kernel ran on that path.  The reference
chunks at the largest divisor of ``Tq`` not above 256 (a prime ``Tq`` gives
chunks of one query); the port takes chunks of 256 and a shorter last one.
Every query row is computed from the same keys either way, so the chunking
changes no result beyond the order of float32 sums.
"""
from __future__ import annotations

import functools
import math

import torch

DEFAULT_Q_CHUNK = 256
NEG_INF = -1e30


def rms_norm(x, scale, eps: float):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def dense(w, x):
    """Linear map s = x @ w (no bias; LLM convention).  The reference's
    K-FAC tag is a no-op in its plain mode, the only mode serving uses."""
    return torch.matmul(x, w)


def softcap(x, cap: float):
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

# cached per (hd, theta, device): one small host-to-device copy, not one in
# every layer of every decode step
@functools.lru_cache(maxsize=None)
def rope_freqs(head_dim: int, theta: float, device: torch.device):
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    return torch.pow(torch.tensor(theta, dtype=torch.float32), exps).to(device)


def apply_rope(x, positions, theta: float):
    """x: (B, T, H, hd); positions: (B, T) or (T,).  The rotation pairs
    dimension i with i + hd/2 (the reference's split-halves layout)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, float(theta), x.device)
    angles = positions.float()[..., None] * freqs    # (B, T, hd/2) or (T, ..)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA + causal + sliding window + softcap), query-chunked
# ---------------------------------------------------------------------------

def _attn_chunk(q, k, v, q_pos, k_pos, *, causal, window, cap):
    """q: (B, Cq, Hq, hd); k/v: (B, Tk, Hkv, hd); q_pos (Cq,), k_pos (Tk,)."""
    b, cq, hq, hd = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, cq, hkv, group, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / math.sqrt(hd)
    scores = softcap(scores, cap)
    dq, dk = q_pos[:, None], k_pos[None, :]
    mask = torch.ones(dq.shape[0], dk.shape[1], dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= dq >= dk
    if window:
        mask &= dq - dk < window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, cq, hq, hd)


def attention(q, k, v, *, causal=True, window=0, cap=0.0,
              q_chunk: int = DEFAULT_Q_CHUNK):
    """Multi-head attention with GQA over aligned positions (prefill:
    q_pos = arange(Tq), k_pos = arange(Tk)).

    q: (B, Tq, Hq, hd);  k, v: (B, Tk, Hkv, hd).  The reference's
    ``q_offset``/``kv_valid`` arguments served multi-token decode against a
    cache, which its ``decode_step`` (one token per row) never makes.
    """
    tq = q.shape[1]
    k_pos = torch.arange(k.shape[1], device=q.device)
    q_pos = torch.arange(tq, device=q.device)
    outs = [_attn_chunk(q[:, c0:c0 + q_chunk], k, v, q_pos[c0:c0 + q_chunk],
                        k_pos, causal=causal, window=window, cap=cap)
            for c0 in range(0, tq, q_chunk)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
