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

The CUDA kernels (``csrc/flash_decode.cu``) are one kernel body for both
routes, flash decoding: the keys of each (row, KV head) are split into
``n_split`` chunks, a block each, grid (n_split, Hkv, B).  A block holds
all G query heads of the group, so each K/V row is read from device
memory once per group (the amortization the TPU kernel's q-head block
``bh`` buys).  :func:`decode_splits` picks ``n_split`` on the host from
B·Hkv against the SM count, the cache's S and the window, never from the
lengths (they stay on the device: reading them would synchronize every
decode step); each block finds its chunk of the row's span on the device
from ``lengths[b]``, chunks of ``max(⌈n/n_split⌉, MIN_CHUNK)`` keys, so a
short row leaves its last chunks empty.  Each wrapper keeps the n_split
of its latest launch as ``last_split``.  With one split the block writes
the output; otherwise each block writes a partial (m, l, acc) per query
head to a float32 workspace (one a stream, from ``torch.empty``, kept
for the later calls on that stream), and a second launch merges the
partials of each (row, query head) in split order (an empty chunk's
(−1e30, 0) weighs nothing), so two calls give the same bits.  In a
block, four warps take turns over the chunk; within a warp ``hd/8``
lanes share a key, each holding 8 of its dimensions, and each lane group
loads up to 8 keys (4 at G = 3, 4) before scoring them; one max and one
rescale of (l, acc) per tile of keys, lane groups merged with shuffles,
warps in shared memory.  The paged route reads each page's
table entry once per tile of keys, not once per key.  The TPU kernels
walk every block of the cache and mask; these visit only the valid keys,
which gives the same function.  The scores are multiplied by 1/√hd where
the plain versions divide (the same float for the powers of two hd takes
here); the softcap is ``cap·tanhf(s/cap)`` in IEEE float32.

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
from repro_torch.kernels.gemm_plan import sm_count

NEG_INF = -1e30
MAX_GROUP = 4   # query heads per KV head: csrc/flash_decode.cu builds G = 1..4
# The split aims the grid at FILL blocks an SM, about two waves of the
# three or four blocks of 128 threads an SM holds (119-168 registers a
# thread): ragged rows free their slots early.  MIN_CHUNK is the kernel's
# shortest chunk (kMinChunk in csrc/flash_decode.cu), which the rule plans
# with: a chunk of that many keys outweighs a block's fixed cost.
FILL = 8
MIN_CHUNK = 256


def key_span(s_len: int, window: int) -> int:
    """The most keys a row with a valid key can have: S, or the window."""
    return min(s_len, window) if window > 0 else s_len


def decode_splits(pairs: int, span: int, sms: int) -> int:
    """Chunks the keys of each of the ``pairs`` = B·Hkv (row, KV head)
    blocks are split into: one where the pairs alone give each SM ``FILL``
    blocks, else enough for that, but no more than ``span`` (the longest
    row's keys) fills with ``MIN_CHUNK``-key chunks."""
    if pairs < 1 or pairs >= FILL * sms:
        return 1
    return max(1, min(-(-FILL * sms // pairs), span // MIN_CHUNK))


# The partials' workspace of each (device, stream), from torch.empty on
# that stream: the calls on one stream run in order, so each call may
# overwrite what the one before it merged, and a decode step pays for no
# allocation.  It grows by doubling; the buffers it outgrows stay
# allocated, so a CUDA graph that captured one never replays into memory
# that was handed on.
_WORKSPACES: dict = {}


def _split(q, hkv, s_len, window, stream):
    """This call's n_split and the address of its float32 workspace on the
    call's stream: (m, l) and acc of each split and (row, query head); no
    workspace for one split."""
    b, hq, hd = q.shape
    dev = q.get_device()
    n_split = decode_splits(b * hkv, key_span(s_len, window), sm_count(dev))
    if n_split == 1:
        return 1, None
    need = n_split * b * hq * (hd + 2)
    bufs = _WORKSPACES.setdefault((dev, stream), [])
    if not bufs or bufs[-1].numel() < need:
        size = max(need, 2 * bufs[-1].numel()) if bufs else need
        bufs.append(torch.empty(size, dtype=torch.float32, device=q.device))
    return n_split, bufs[-1].data_ptr()


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
    stream = _build.stream_of(q)
    n_split, ws = _split(q, k.shape[1], k.shape[2], window, stream)
    status = _build.load().lib.repro_flash_decode_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), ws, b, hq, k.shape[1], hd, k.shape[2], k.stride(0),
        k.stride(1), k.stride(2), int(window), float(cap),
        float(1.0 / math.sqrt(hd)), n_split, stream)
    _build.check(status, "flash_decode")
    flash_decode.launches += 1
    flash_decode.last_split = n_split
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
    _, page, hkv, _ = k_pool.shape
    blocks = page_table.shape[1]
    out = torch.empty_like(q)
    stream = _build.stream_of(q)
    n_split, ws = _split(q, hkv, blocks * page, window, stream)
    status = _build.load().lib.repro_flash_decode_paged_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        lengths.data_ptr(), page_table.data_ptr(), out.data_ptr(), ws, b, hq,
        hkv, hd, page, blocks, int(window), float(cap),
        float(1.0 / math.sqrt(hd)), n_split, stream)
    _build.check(status, "flash_decode_paged")
    flash_decode_paged.launches += 1
    flash_decode_paged.last_split = n_split
    return out


flash_decode.launches = 0
flash_decode_paged.launches = 0
# the n_split of each wrapper's latest launch (0 before its first)
flash_decode.last_split = 0
flash_decode_paged.last_split = 0
