"""Flash decode: one query token per row against a long bf16 KV cache.

Replaces the Pallas TPU kernels ``repro/kernels/flash_decode.py::
flash_decode`` (line 82, ``pallas_call`` at line 107) and
``flash_decode_paged`` (line 178, at line 211).  Both compute, for each
row b and query head h of a GQA group (Hq = G·Hkv),

    out[b, h] = softmax_j(cap·tanh(q·k_j/√hd / cap)) · v_j

over the valid keys ``j ∈ [max(0, len_b − window), len_b)`` (no window when
``window`` ≤ 0, no softcap when ``cap`` is 0), with q and the output in
float32 and K/V in bfloat16, widened to float32 in registers.  The dense
kernel reads K/V as (B, Hkv, S, hd) through strides, so the LM's
(B, S, Hkv, hd) cache is read as it lies; the paged kernel reads the pools
(num_pages, page, Hkv, hd) through the (B, max_blocks) page table, in the
kernel, and touches only the pages the row's valid keys lie on.

A row with no valid key (``len_b < 1``, or a window past the end) attends
every key it walks with equal weight, as the reference does (its masked
scores are all −1e30, and softmax makes them uniform): the output is the
mean of V over all S positions (dense) or over all ``max_blocks·page``
positions of the row's page-table row (paged).  The serving engine never
makes such a row: its lengths are ``pos + 1 ≥ 1``.

The CUDA kernels (``csrc/flash_decode.cu``) give one block to each (row,
KV head), holding all G query heads of the group, so each K/V row is read
from device memory once per group (the amortization the TPU kernel's
q-head block ``bh`` buys).  Eight warps split the keys; within a warp,
``hd/8`` lanes share a key, each holding 8 of its dimensions, so a warp
takes ``256/hd`` keys at a time; each lane group keeps an online softmax
(m, l, acc) per query head in float32, merged across the warp with
shuffles and across warps in shared memory.  The TPU kernels walk every
block of the cache and mask; these visit only the valid keys, which gives
the same function.  The scores are multiplied by 1/√hd where the plain
versions divide (the same float for the powers of two hd takes here); the
softcap is ``cap·tanhf(s/cap)`` in IEEE float32.

Bound on this card: bytes — each call must read the valid keys' K and V
rows once (``2·Σ_b n_b·Hkv·hd·2`` bytes for n_b valid keys of row b) at
3.35 TB/s, against ``4·Σ_b n_b·Hq·hd`` operations.

On CPU tensors the wrappers take the plain versions (``*_ref``, which
mirror ``repro/kernels/ops.py:65-149``); on CUDA tensors they launch the
kernels or raise.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_GROUP = 4   # query heads per KV head: csrc/flash_decode.cu builds G = 1..4


def _lengths(lengths, b, device):
    """(B,) int32 lengths; a scalar broadcasts."""
    t = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    return t.reshape(-1).expand(b)


def flash_decode_ref(q, k, v, lengths, *, window=0, cap=0.0):
    """Plain version, the masked einsum of ``repro/kernels/ops.py:65``:
    q (B, Hq, hd); k, v (B, Hkv, S, hd); lengths (B,) or a scalar."""
    b, hq, hd = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    lengths = _lengths(lengths, b, q.device)
    g = hq // hkv
    qg = q.reshape(b, hkv, g, hd).float()
    sc = torch.einsum("bhgd,bhsd->bhgs", qg, k.float())
    sc = sc / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    if cap:
        sc = cap * torch.tanh(sc / cap)
    k_pos = torch.arange(s_len, device=q.device)
    valid = k_pos[None, :] < lengths[:, None]            # (B, S) per-row mask
    if window:
        valid &= k_pos[None, :] >= lengths[:, None] - window
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v.float())
    return out.reshape(b, hq, hd).to(q.dtype)


def paged_gather(k_pool, v_pool, page_table):
    """The dense (B, Hkv, max_blocks·page, hd) view of the pools through
    the page table (``repro/kernels/ops.py:107``)."""
    b, nb = page_table.shape
    _, page, hkv, hd = k_pool.shape
    idx = page_table.long()

    def one(pool):
        return pool[idx].reshape(b, nb * page, hkv, hd).transpose(1, 2)

    return one(k_pool), one(v_pool)


def flash_decode_paged_ref(q, k_pool, v_pool, lengths, page_table, *,
                           window=0, cap=0.0):
    """Plain version: :func:`paged_gather`, then :func:`flash_decode_ref`."""
    kd, vd = paged_gather(k_pool, v_pool, page_table)
    return flash_decode_ref(q, kd, vd, lengths, window=window, cap=cap)


def _check(name, q, k, v, lengths, hkv):
    """Operands the kernels take; raises otherwise.  Returns the contiguous
    (B,) int32 lengths."""
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in (k, v, lengths)):
        raise ValueError(f"{name}: every operand must be on one CUDA device, "
                         f"got q {q.device}, k {k.device}, v {v.device}, "
                         f"lengths {lengths.device}")
    if q.dtype != torch.float32:
        raise TypeError(f"{name}: q must be float32, got {q.dtype}")
    if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"{name}: k and v must be bfloat16, got {k.dtype}, "
                        f"{v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"{name}: lengths must be int32, got {lengths.dtype}")
    b, hq, hd = q.shape
    if hq % hkv or not 1 <= hq // hkv <= MAX_GROUP:
        raise ValueError(f"{name}: Hq={hq} must be 1..{MAX_GROUP} times "
                         f"Hkv={hkv}")
    if hd not in (16, 32, 64, 128, 256) or k.stride(-1) != 1 or (
            v.stride(-1) != 1):
        raise ValueError(f"{name}: head dim must be 16, 32, 64, 128 or 256 "
                         f"and unit-stride, got {hd}, strides {k.stride()}")
    if lengths.shape != (b,):
        raise ValueError(f"{name}: lengths {tuple(lengths.shape)}, expected "
                         f"({b},)")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")
    return lengths.contiguous()


def flash_decode(q, k, v, lengths, *, window=0, cap=0.0):
    """q (B, Hq, hd) float32; k, v (B, Hkv, S, hd) bfloat16, any strides
    with a unit last one (k and v alike); lengths (B,) int32, or a Python
    int.  Returns (B, Hq, hd) float32.  CPU tensors take
    :func:`flash_decode_ref`."""
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, lengths, window=window, cap=cap)
    if not isinstance(lengths, torch.Tensor):
        lengths = _lengths(lengths, q.shape[0], q.device)
    lengths = _check("flash_decode", q, k, v, lengths, k.shape[1])
    b, hq, hd = q.shape
    if k.shape != v.shape or k.stride() != v.stride() or k.shape[0] != b or (
            k.shape[3] != hd):
        raise ValueError(f"flash_decode: k {tuple(k.shape)} {k.stride()}, "
                         f"v {tuple(v.shape)} {v.stride()}, q {tuple(q.shape)}")
    if any(s % 8 for s in k.stride()[:3]):
        raise ValueError(f"flash_decode: k/v strides {k.stride()} must be "
                         f"multiples of 8 elements (16-byte rows)")
    q = q.contiguous()
    out = torch.empty_like(q)
    status = _build.load().lib.repro_flash_decode_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, hq, k.shape[1], hd, k.shape[2], k.stride(0),
        k.stride(1), k.stride(2), int(window), float(cap),
        float(1.0 / math.sqrt(hd)), _build.stream_of(q))
    _build.check(status, "flash_decode")
    flash_decode.launches += 1
    return out


def flash_decode_paged(q, k_pool, v_pool, lengths, page_table, *, window=0,
                       cap=0.0):
    """q (B, Hq, hd) float32; k_pool, v_pool (num_pages, page, Hkv, hd)
    bfloat16, contiguous; lengths (B,) int32, or a Python int; page_table
    (B, max_blocks) int32, contiguous, on the same device: row b's logical
    page i lies in physical page ``page_table[b, i]`` (unused entries must
    point at a page that exists, e.g. the allocator's null page 0).  Returns
    (B, Hq, hd) float32.  CPU tensors take :func:`flash_decode_paged_ref`."""
    if q.device.type == "cpu":
        return flash_decode_paged_ref(q, k_pool, v_pool, lengths, page_table,
                                      window=window, cap=cap)
    if not isinstance(lengths, torch.Tensor):
        lengths = _lengths(lengths, q.shape[0], q.device)
    lengths = _check("flash_decode_paged", q, k_pool, v_pool, lengths,
                     k_pool.shape[2])
    b, hq, hd = q.shape
    if page_table.device != q.device:
        raise ValueError(f"flash_decode_paged: page_table must be on "
                         f"{q.device}, got {page_table.device}")
    if page_table.dtype != torch.int32:
        raise TypeError(f"flash_decode_paged: page_table must be int32, got "
                        f"{page_table.dtype}")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"flash_decode_paged: page_table "
                         f"{tuple(page_table.shape)}, expected ({b}, blocks)")
    if (k_pool.shape != v_pool.shape or k_pool.dim() != 4
            or k_pool.shape[3] != hd or not k_pool.is_contiguous()
            or not v_pool.is_contiguous()):
        raise ValueError(f"flash_decode_paged: pools {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)} must be contiguous "
                         f"(num_pages, page, Hkv, {hd})")
    q, page_table = q.contiguous(), page_table.contiguous()
    num_pages, page, hkv, _ = k_pool.shape
    out = torch.empty_like(q)
    status = _build.load().lib.repro_flash_decode_paged_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        lengths.data_ptr(), page_table.data_ptr(), out.data_ptr(), b, hq,
        hkv, hd, page, page_table.shape[1], int(window), float(cap),
        float(1.0 / math.sqrt(hd)), _build.stream_of(q))
    _build.check(status, "flash_decode_paged")
    flash_decode_paged.launches += 1
    return out


flash_decode.launches = 0
flash_decode_paged.launches = 0
