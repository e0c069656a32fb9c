"""Flash attention: the serving prefill's attention over aligned positions.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` (line 67, ``pallas_call`` at line 81) and its oracle
``repro/kernels/ref.py::flash_attention_ref`` (line 41).  For q
(B, Hq, Tq, hd) and k, v (B, Hkv, Tk, hd) (GQA: Hq = G·Hkv), query i at
position i and key j at position j,

    out[b, h, i] = softmax_j(cap·tanh(q_i·k_j/√hd / cap)) · v_j

over the keys with ``(i >= j if causal) & (i − j < window if window)`` (no
softcap when ``cap`` is 0), in float32.  A row with no valid key (a window
with Tk < Tq) gets the uniform softmax over all Tk keys, the mean of V, as
the reference's all −1e30 scores give.

:func:`flash_attention_ref` is the one plain version: the query-chunked
attention of ``repro/models/layers.py::attention`` (the JAX prefill's
function), with chunks of 256 queries and a shorter last one, which bounds
the score buffer to (B, Hkv, G, 256, Tk).  The reference chunks at the
largest divisor of Tq not above 256; every query row is computed from the
same keys either way, so the chunking changes no result beyond the order of
float32 sums.

The CUDA kernel (``csrc/flash_attention.cu``) gives one block to each (row,
KV head, tile of 64 / G queries), holding all G query heads of the group so
each K/V tile in shared memory serves 64 (query, head) rows, and visits only
the key tiles the tile's queries can see; an online softmax (m, l, acc) per
row in float32 on the CUDA cores.  Tiles of 64 keys at every head dim, K
and V staged apart by ``cp.async`` (V of tile t lands while QKᵀ of tile t
is multiplied, K of tile t + 1 while PV of tile t is), two barriers a tile,
4 rows × 4 keys a thread (at hd 128 and 256 scored as 8 × 8 patches over a
quarter of the dims, the partial sums met by shuffles), exp2 with log₂e
folded into the scale, the mask only on the tiles that cross the diagonal,
the window's edge or Tk, and the query tiles longest first over a
one-dimensional grid.  Shared memory a block: 219,136 B at hd 256 and
120,832 B at hd 128 (one block an SM), 71,680 B at hd 64 (two);
:func:`blocks_per_sm` reads the count on the card.
Bound on this card: operations, 4·hd·Hq·Σᵢnᵢ (nᵢ the keys row i sees) at
67 TFLOP/s, far above q, k, v and the output moved once at 3.35 TB/s.

The kernel reads q, k and v through their strides (unit along hd), so the
LM's (B, T, H, hd) projections pass as ``.transpose(1, 2)`` views without a
copy, and writes its output into (B, Tq, Hq, hd) storage returned as the
(B, Hq, Tq, hd) view, whose ``.transpose(1, 2)`` is contiguous.  On CPU
tensors the wrapper takes :func:`flash_attention_ref`; on CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
Q_CHUNK = 256
HEAD_DIMS = (16, 32, 64, 128, 256)   # csrc/flash_attention.cu builds these
MAX_GROUP = 64                       # a block holds 64 (query, head) rows


def flash_attention_ref(q, k, v, *, causal=True, window=0, cap=0.0):
    """Plain version: q (B, Hq, Tq, hd); k, v (B, Hkv, Tk, hd) -> (B, Hq,
    Tq, hd), in query chunks of :data:`Q_CHUNK`."""
    b, hq, tq, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    g = hq // hkv
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(tk, device=q.device)
    outs = []
    for c0 in range(0, tq, Q_CHUNK):
        qc = q[:, :, c0:c0 + Q_CHUNK]
        cq = qc.shape[2]
        qg = qc.reshape(b, hkv, g, cq, hd).float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) / math.sqrt(hd)
        if cap:
            s = cap * torch.tanh(s / cap)
        dq = torch.arange(c0, c0 + cq, device=q.device)[:, None]
        mask = torch.ones(cq, tk, dtype=torch.bool, device=q.device)
        if causal:
            mask &= dq >= k_pos[None, :]
        if window:
            mask &= dq - k_pos[None, :] < window
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
        outs.append(o.reshape(b, hq, cq, hd))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return out.to(q.dtype)


def _check(q, k, v, window, cap):
    """Operands the kernel takes; raises otherwise."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: every operand must be on one CUDA "
                         f"device, got q {q.device}, k {k.device}, v "
                         f"{v.device}")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError(f"flash_attention: float32 operands only, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or (
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; expected "
                         f"(B, Hq, Tq, hd) and (B, Hkv, Tk, hd)")
    hq, hd = q.shape[1], q.shape[3]
    hkv, tk = k.shape[1], k.shape[2]
    if hkv < 1 or hq % hkv or not 1 <= hq // hkv <= MAX_GROUP:
        raise ValueError(f"flash_attention: Hq={hq} must be 1..{MAX_GROUP} "
                         f"times Hkv={hkv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim must be one of "
                         f"{HEAD_DIMS}, got {hd}")
    if tk < 1:
        raise ValueError("flash_attention: no keys (Tk = 0)")
    if k.stride() != v.stride():
        raise ValueError(f"flash_attention: k and v strides differ, "
                         f"{k.stride()} vs {v.stride()}")
    for name, t in (("q", q), ("k", k)):
        if t.stride(-1) != 1 or any(st % 4 for st, n in zip(t.stride()[:3],
                                                          t.shape[:3])
                                    if n > 1):
            raise ValueError(f"flash_attention: {name} must be unit-stride "
                             f"along hd with strides in multiples of 4 "
                             f"elements (16-byte rows), got {t.stride()}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: operands must be 16-byte aligned")
    if window < 0 or cap < 0:
        raise ValueError(f"flash_attention: window={window} and cap={cap} "
                         f"must be >= 0")


def flash_attention(q, k, v, *, causal=True, window=0, cap=0.0):
    """q (B, Hq, Tq, hd); k, v (B, Hkv, Tk, hd), float32, any strides with
    a unit last one (k and v alike).  Returns (B, Hq, Tq, hd) float32.  CPU
    tensors take :func:`flash_attention_ref`."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   cap=cap)
    _check(q, k, v, window, cap)
    b, hq, tq, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    out = torch.empty(b, tq, hq, hd, device=q.device,
                      dtype=torch.float32).transpose(1, 2)
    if out.numel() == 0:
        return out
    status = _build.load().lib.repro_flash_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        tq, tk, hd, *q.stride()[:3], *k.stride()[:3], *out.stride()[:3],
        int(bool(causal)), int(window), float(cap), float(1.0 / math.sqrt(hd)),
        _build.stream_of(q))
    _build.check(status, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def blocks_per_sm(hd: int) -> int:
    """Blocks of the kernel's ``hd`` instantiation that an SM of the current
    card holds: CUDA's occupancy calculator on its registers and shared
    memory (the card only)."""
    n = ctypes.c_int(0)
    status = _build.load().lib.repro_flash_attention_blocks_per_sm(
        int(hd), ctypes.addressof(n))
    _build.check(status, "flash_attention")
    return n.value
