"""Launch plans for the pipelined fp32 GEMM of ``csrc/gemm_pipeline.cuh``.

A plan fixes, per call, the output tile and the split of the summed
dimension K over blocks (rows of P̂ for ``patch_factor``, of X for
``factor_update``); the wrappers add the copy width of the loader, which
depends on the operands' addresses.
The kernels take the plan as it is; the choices live here, in Python, where
the CPU tests reach them.  Dense products (``matmul_rescale``) take the
64×64 tile: no shape of the main path fills the card with 128-tiles.
Symmetric products (``patch_factor``, ``factor_update``) weigh the 128 and
the 64 tile.

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
DENSE_TILE = 64                 # dense products' tile edge
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


def dense_options(batch: int, m: int, n: int):
    """[(tile, tiles, blocks, fold)] a dense product may take."""
    tiles = _cdiv(m, DENSE_TILE) * _cdiv(n, DENSE_TILE)
    return [(DENSE_TILE, tiles, batch * tiles, False)]


@functools.lru_cache(maxsize=None)
def dense_plan(batch: int, m: int, n: int, k: int, sms: int) -> Plan:
    """``out[b] = A[b] (m, k) @ B[b] (k, n)``: square tiles over (m, n),
    grid z over batch × splits."""
    return _best(dense_options(batch, m, n), k, sms, batch * m * n)


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
