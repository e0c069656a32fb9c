"""Shared LM layers: norm, dense, softcap, RoPE, attention (mirrors
``repro/models/layers.py``), and training's K-FAC-tagged dense map and
differentiable attention.

The prefill's attention (GQA, causal, a sliding window, a score softcap,
over aligned positions) goes through ``kernels.flash_attention``: the
hand-written CUDA kernel on the card, and on the CPU its plain version,
the query-chunked attention of the reference's ``attention``
(``kernels.flash_attention.flash_attention_ref``).  The JAX prefill runs
that chunked jnp attention; its Pallas ``flash_attention`` computes the
same function and is what the port's kernel replaces.  That Pallas kernel
and the port's CUDA kernel are forward-only, so they stay on the prefill.

Training (``LM.loss`` / ``LM.hidden``) runs through :func:`tagged_dense`
and :func:`attention_train`, the reference's own training path: its
``attention`` is the query-chunked jnp function (chunks of 256 queries, or
the largest divisor of Tq below that: 250 at whisper's 1500 encoder
frames), which JAX differentiates, and through which the exact-Fisher
quadratic (``core/fisher.py::quad_lm``) takes forward-mode JVPs.  The port
trains through the same chunked function under autograd; the score buffer
stays (B, H, chunk, Tk).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels.flash_attention import flash_attention


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
# Attention (GQA + causal + sliding window + softcap)
# ---------------------------------------------------------------------------

def attention(q, k, v, *, causal=True, window=0, cap=0.0):
    """Multi-head attention with GQA over aligned positions (prefill:
    q_pos = arange(Tq), k_pos = arange(Tk)).

    q: (B, Tq, Hq, hd);  k, v: (B, Tk, Hkv, hd) -> (B, Tq, Hq, hd).  The
    operands pass to ``kernels.flash_attention`` in its (B, H, T, hd)
    layout as views; on the card the result's view back is contiguous.
    The reference's ``q_offset``/``kv_valid`` arguments served multi-token
    decode against a cache, which its ``decode_step`` (one token per row)
    never makes.
    """
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        cap=cap)
    return o.transpose(1, 2)


# ---------------------------------------------------------------------------
# Training: the K-FAC-tagged dense map and the differentiable attention
# ---------------------------------------------------------------------------

DEFAULT_Q_CHUNK = 256
_NEG_INF = -1e30


def tagged_dense(tg, name: str, w, x):
    """K-FAC-tagged linear map s = x @ w (the reference's ``dense``); the
    tag is a no-op in plain mode (the gradient pass)."""
    return tg.tag(name, x, torch.matmul(x, w))


def _attend_chunk(q, k, v, q0: int, *, causal, window, cap):
    """Float32 attention of the query rows at positions q0, q0 + 1, ...
    against all of k, v: q (B, Cq, Hq, hd); k, v (B, Tk, Hkv, hd)."""
    b, cq, hq, hd = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, cq, hkv, hq // hkv, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(hd)
    if cap:
        s = cap * torch.tanh(s / cap)
    q_pos = torch.arange(q0, q0 + cq, device=q.device)[:, None]
    k_pos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones(cq, tk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= q_pos - k_pos < window
    p = torch.softmax(torch.where(mask, s, _NEG_INF), dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, cq, hq, hd)


def attention_train(q, k, v, *, causal=True, window=0, cap=0.0,
                    q_chunk: int = DEFAULT_Q_CHUNK):
    """Differentiable multi-head attention with GQA over aligned positions
    (q_pos = arange(Tq), k_pos = arange(Tk)), in query chunks of the largest
    divisor of Tq not above ``q_chunk``: the reference's ``attention``.

    q: (B, Tq, Hq, hd);  k, v: (B, Tk, Hkv, hd) -> (B, Tq, Hq, hd)."""
    tq = q.shape[1]
    if tq <= q_chunk:
        return _attend_chunk(q, k, v, 0, causal=causal, window=window,
                             cap=cap)
    while tq % q_chunk:
        q_chunk -= 1
    return torch.cat([_attend_chunk(q[:, c0:c0 + q_chunk], k, v, c0,
                                    causal=causal, window=window, cap=cap)
                      for c0 in range(0, tq, q_chunk)], dim=1)
