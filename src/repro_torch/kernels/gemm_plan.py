"""Launch plans for the pipelined fp32 GEMM of ``csrc/gemm_pipeline.cuh``.

A plan fixes, per call, the output tile and the split of the summed
dimension K over blocks (rows of P̂ for ``patch_factor``, of X for
``factor_update``); the wrappers add the copy widths of the loader, which
depend on the operands' addresses (:func:`dense_vec16`,
:func:`dense_rows16`).
The kernels take the plan as it is; the choices live here, in Python, where
the CPU tests reach them.  Dense products weigh the tile edges their kernel
has: ``matmul`` the 128 and the 64 tile (:data:`MATMUL_TILES`; the 128 tile
pays off on whisper's stacked 3072-wide Newton–Schulz products),
``matmul_rescale`` the 64 tile only (:data:`DENSE_TILE`, which
``axpy_momentum`` also runs, with K whole and no plan).  Symmetric products
(``patch_factor``, ``factor_update``) weigh the 128 and the 64 tile.

The choice follows a small cost model: the busiest SM runs
``ceil(blocks / SMs)`` blocks, each of ``2·T²·chunk`` operations, at the
rate an SM sustains on that tile once it holds ``_FILL`` blocks (with fewer,
an SM is slower: it takes as long as ``_FILL`` blocks would); a split adds
its partial sums' round trip through device memory and, on the host, a
workspace allocation and a second launch (``_SPLIT_S``, from eager calls:
the port's training paths call the wrappers eagerly).  The weights are
fitted to the times of forced plans on an H100 at 700 W, which
``tools/plan_sweep.py`` prints beside the model's: a 128-tile block alone on
its SM keeps about 90% of the SM's rate, a 64-tile block (4×4 register
patches, twice the shared-memory reads per FMA) about 70%.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

BK = 16                         # K rows per slice (gemm_pipeline.cuh kBK)
TILES = (128, 64)               # symmetric products' tile edges, preferred
DENSE_TILE = 64                 # matmul_rescale's, axpy_momentum's tile
MATMUL_TILES = (128, 64)        # matmul's tile edges, preferred
_SM_FLOPS = {128: 2.6e11, 64: 2.4e11}   # fp32 FMA rate of one busy SM
_FILL = {128: 1.1, 64: 1.4}     # blocks an SM holds to reach that rate
_HBM = 3.35e12                  # bytes/s
_LAUNCH_S = 3e-6                # one kernel launch
_SPLIT_S = 5e-6                 # a split's host cost: workspace, 2nd launch
_MIN_CHUNK = 2 * BK             # fewest K rows one split sums
_MAX_SPLITS = 128


class Plan(NamedTuple):
    tile: int      # output tile edge
    tiles: int     # tiles per side (triangle plans) or in all (dense)
    blocks: int    # output tiles launched per K chunk (all batches)
    chunk: int     # K rows one block sums, a multiple of BK
    splits: int    # K chunks launched; > 1 adds partial sums in a 2nd pass
    fold: bool = False  # triangle plans: the bias feature folded in


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def chunks(k: int, s: int):
    """(chunk, used): k cut into s chunks rounded up to BK rows; the last
    may be short and fewer than s may be needed."""
    chunk = max(BK, _cdiv(_cdiv(k, s), BK) * BK)
    return chunk, max(1, _cdiv(k, chunk))


def max_splits(k: int) -> int:
    """The most K chunks a plan weighs for K = k."""
    return max(1, min(_MAX_SPLITS, k // _MIN_CHUNK))


def cost(tile: int, blocks: int, chunk: int, used: int, sms: int,
         out_floats: int) -> float:
    """Modelled seconds of ``blocks`` output tiles times ``used`` chunks of
    ``chunk`` K rows on ``sms`` SMs."""
    per_sm = max(_cdiv(blocks * used, sms), _FILL[tile])
    t = _LAUNCH_S + per_sm * 2.0 * tile * tile * chunk / _SM_FLOPS[tile]
    if used > 1:   # partials written and read, the epilogue's operands
        t += (2 * used + 2) * out_floats * 4.0 / _HBM + _SPLIT_S
    return t


def _best(options, k: int, sms: int, out_floats: int,
          most: int | None = None) -> Plan:
    """The cheapest (tile, split) over ``options`` = [(tile, tiles, blocks,
    fold)], at most ``most`` splits (default :func:`max_splits`); ties go
    to the earlier tile and the smaller split."""
    best = None
    for tile, tiles, blocks, fold in options:
        for s in range(1, (most or max_splits(k)) + 1):
            chunk, used = chunks(k, s)
            t = cost(tile, blocks, chunk, used, sms, out_floats)
            if best is None or t < best[0]:
                best = (t, Plan(tile, tiles, blocks, chunk, used, fold))
    return best[1]


def dense_options(batch: int, m: int, n: int, tiles=(DENSE_TILE,)):
    """[(tile, tiles, blocks, fold)] a dense product may take, one for each
    tile edge in ``tiles`` (those its kernel has)."""
    out = []
    for tile in tiles:
        count = _cdiv(m, tile) * _cdiv(n, tile)
        out.append((tile, count, batch * count, False))
    return out


@functools.lru_cache(maxsize=None)
def dense_plan(batch: int, m: int, n: int, k: int, sms: int,
               tiles=(DENSE_TILE,)) -> Plan:
    """``out[b] = A[b] (m, k) @ B[b] (k, n)``: square tiles over (m, n) of
    one edge in ``tiles``, grid z over batch × splits."""
    return _best(dense_options(batch, m, n, tiles), k, sms, batch * m * n)


def triangle_tiles(d: int, core: int, has_bias: bool, tile: int):
    """(tiles per side, triangle blocks, fold) of a symmetric (d, d) product
    cut into ``tile``-square tiles.  fold: the core features fill whole
    tiles and the bias feature (the last) comes from the last tile column's
    staged sums instead of a tile one feature wide."""
    fold = has_bias and core > 0 and core % tile == 0
    tiles = core // tile if fold else _cdiv(d, tile)
    return tiles, tiles * (tiles + 1) // 2, fold


def triangle_options(d: int, core: int, has_bias: bool):
    """[(tile, tiles per side, triangle blocks, fold)] a symmetric product
    may take."""
    return [(tile, *triangle_tiles(d, core, has_bias, tile))
            for tile in TILES]


@functools.lru_cache(maxsize=None)
def triangle_plan(d: int, core: int, has_bias: bool, rows: int, sms: int,
                  batch: int = 1) -> Plan:
    """``α·P̂ᵀP̂ + β·C`` for P̂ of ``rows`` rows and d = core + has_bias
    features: tiles (i, j), i <= j, grid z over splits of the rows.  A
    batch of ``batch`` such products (``factor_update``'s stacked layers)
    launches batch × the triangle's blocks, grid z over the batch, and
    takes no split."""
    options = [(tile, tiles, batch * blocks, fold)
               for tile, tiles, blocks, fold in triangle_options(
                   d, core, has_bias)]
    return _best(options, rows, sms, batch * d * d,
                 most=1 if batch > 1 else None)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index`` (read once per process)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def aligned16(t) -> bool:
    """Whether a tensor's first element lies on a 16-byte boundary."""
    return t.data_ptr() % 16 == 0


def dense_vec16(op) -> bool:
    """Whether the dense loader may copy B's rows 16 bytes at a time: its
    width and batch stride are multiples of 4 floats and it starts on a
    16-byte boundary (``op``: :class:`kernels.matmul.Operands`)."""
    return op.n % 4 == 0 and op.strides[1] % 4 == 0 and aligned16(op.b)


def matmul_tiles(op) -> tuple:
    """The tile edges ``matmul``'s kernel offers for ``op``: the 128 tile
    copies B 16 bytes at a time only (its 4-byte loader does not fit 128
    registers), so a B that :func:`dense_vec16` refuses takes the 64."""
    return MATMUL_TILES if dense_vec16(op) else (DENSE_TILE,)


def dense_rows16(op, tile: int) -> bool:
    """Whether the dense loader (``matmul``, ``matmul_rescale``,
    ``axpy_momentum``) stages A as rows by 16-byte copies: on the 64 tile
    (the rows' reads do not fit the 128 tile's 128 registers), where K and
    A's batch stride are
    multiples of 4 floats and A starts on a 16-byte boundary.  Else A is
    staged k-major by 4-byte copies, each to its transposed place (ragged
    K: 1001, 785, 501, 251, 31)."""
    return (tile == DENSE_TILE and op.k % 4 == 0 and op.strides[0] % 4 == 0
            and aligned16(op.a))
