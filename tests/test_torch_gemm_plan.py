"""The host-side launch plans of the pipelined fp32 GEMM
(``repro_torch/kernels/gemm_plan.py``) that ``matmul``, ``matmul_rescale``,
``axpy_momentum``, ``patch_factor`` and ``factor_update`` hand to their CUDA
kernels, checked on the CPU: the tiles
cover the output (one triangle of tiles for the symmetric product), the K
chunks are whole slices and sum every row once, the plan is the cost
model's cheapest, ``matmul`` weighs its two tiles and ``matmul_rescale``
its one, ``axpy_momentum``'s ΣD² partials follow its 64 tiles, and the
16-byte copies are chosen only where the strides and the address allow
them.  Whether the kernels walk a plan's
grid as planned is the card tests' to show (``tests/test_torch_cuda.py``).
"""
import pytest
import torch

from repro_torch.kernels import gemm_plan
from repro_torch.kernels.factor_update import vec16 as factor_vec16
from repro_torch.kernels.matmul import Operands
from repro_torch.kernels.patch_factor import patch_geometry
from repro_torch.kernels.patch_factor import vec16 as patch_vec16
from repro_torch.kernels.update_chain import partials_grid

SMS = 132   # an H100's SMs

# (batch, m, n, k): the autoencoder's 8 eigen-path products (a, g) @ (g, g),
# the batched x3 check, and ragged ones
DENSE = [(1, 785, 1000, 1000), (1, 1001, 500, 500), (1, 501, 250, 250),
         (1, 251, 30, 30), (1, 31, 250, 250), (1, 251, 500, 500),
         (1, 501, 1000, 1000), (1, 1001, 784, 784), (3, 785, 1000, 1000),
         (3, 1001, 500, 500), (1, 7, 5, 3), (2, 129, 65, 17), (1, 5, 7, 0)]

# (b, t, c, taps, stride, padding, bias): chip_smoke.py's cases (whisper's
# two conv stems last) and ones whose d is one more than a tile multiple
PATCH = [(2, 21, 13, 3, 1, "SAME", True), (1, 131, 8, 4, 1, "VALID", False),
         (2, 31, 8, 3, 2, "SAME", True), (2, 8, 8, 9, 1, "SAME", True),
         (2, 2, 8, 3, 1, "VALID", True), (3, 100, 136, 3, 2, "SAME", True),
         (2, 40, 16, 4, 1, "SAME", True), (1, 50, 32, 4, 2, "SAME", True),
         (8, 3000, 80, 3, 1, "SAME", True), (8, 3000, 768, 3, 2, "SAME", True)]

# (batch, n, d) of factor_update: the autoencoder's factor sides at the full
# batch (N = 8192), ragged ones, whisper-small's three stacked shapes (one
# launch, grid z over the 12 layers) and small batched ones
AE_SIDES = [785, 1000, 1001, 500, 501, 250, 251, 30, 31, 250, 251, 500, 501,
            1000, 1001, 784]
WHISPER_FU = [(12, 12000, 768), (12, 512, 3072), (12, 12000, 3072)]
FACTOR = ([(1, 8192, d) for d in sorted(set(AE_SIDES))]
          + [(1, 1000, 30), (1, 777, 251)] + WHISPER_FU
          + [(2, 64, 48), (3, 100, 33)])


def _chunks_cover(plan, k):
    assert plan.chunk % gemm_plan.BK == 0 and plan.chunk >= gemm_plan.BK
    assert plan.splits >= 1
    # chunk z sums rows [z * chunk, min((z + 1) * chunk, k)): every row of
    # [0, k) once, and no chunk launched empty
    rows = [r for z in range(plan.splits)
            for r in range(z * plan.chunk, min((z + 1) * plan.chunk, k))]
    assert rows == list(range(k))
    assert plan.splits == 1 or (plan.splits - 1) * plan.chunk < k


@pytest.mark.parametrize("batch,m,n,k", DENSE)
def test_dense_plan_covers_output_and_k(batch, m, n, k):
    plan = gemm_plan.dense_plan(batch, m, n, k, SMS)
    assert plan.tile == gemm_plan.DENSE_TILE and not plan.fold
    rows, cols = -(-m // plan.tile), -(-n // plan.tile)
    assert plan.tiles == rows * cols and plan.blocks == batch * plan.tiles
    assert (rows - 1) * plan.tile < m <= rows * plan.tile
    assert (cols - 1) * plan.tile < n <= cols * plan.tile
    _chunks_cover(plan, k)


@pytest.mark.parametrize("batch,m,n,k", DENSE)
def test_dense_plan_takes_the_cheapest_modelled_split(batch, m, n, k):
    """No split the planner weighs is cheaper by its model, and of equal
    costs the smallest split is taken."""
    plan = gemm_plan.dense_plan(batch, m, n, k, SMS)
    cost = lambda chunk, used: gemm_plan.cost(
        plan.tile, plan.blocks, chunk, used, SMS, batch * m * n)
    best = cost(plan.chunk, plan.splits)
    for s in range(1, gemm_plan.max_splits(k) + 1):
        chunk, used = gemm_plan.chunks(k, s)
        assert best <= cost(chunk, used)
        if cost(chunk, used) == best:
            assert plan.splits <= used


def test_dense_plan_splits_where_tiles_cannot_fill_the_card():
    """(251, 500) @ (500, 500) has 32 tiles for 132 SMs: the plan spreads it
    over the card with a split of K; (1001, 784) @ (784, 784) has 208 and
    takes K whole."""
    narrow = gemm_plan.dense_plan(1, 251, 500, 500, SMS)
    assert narrow.splits > 1 and narrow.blocks * narrow.splits <= 8 * SMS
    assert gemm_plan.dense_plan(1, 1001, 784, 784, SMS).splits == 1


# (batch, m, n, k) of matmul: the autoencoder's Newton–Schulz products
# (d, d) @ (d, d) at its 16 factor sides and the gamma sweep's batch of 3,
# its precondition products (a, a) @ (a, g) and (a, g) @ (g, g), whisper's
# stacked NS products, and ragged ones
AE_NS = [(b, d, d, d) for d in sorted(set(AE_SIDES)) for b in (1, 3)]
AE_LAYERS = [(785, 1000), (1001, 500), (501, 250), (251, 30), (31, 250),
             (251, 500), (501, 1000), (1001, 784)]
AE_PRECOND = ([(1, a, g, a) for a, g in AE_LAYERS]
              + [(1, a, g, g) for a, g in AE_LAYERS])
WHISPER_NS = [(12, 3072, 3072, 3072), (12, 768, 768, 768)]
MATMUL = AE_NS + AE_PRECOND + WHISPER_NS + DENSE


@pytest.mark.parametrize("batch,m,n,k", MATMUL)
def test_matmul_plan_covers_output_and_k(batch, m, n, k):
    """matmul's plan: one of its kernel's tiles over (m, n), every batch's
    tiles launched once per K chunk, the chunks summing every row of K
    once."""
    plan = gemm_plan.dense_plan(batch, m, n, k, SMS, gemm_plan.MATMUL_TILES)
    assert plan.tile in gemm_plan.MATMUL_TILES and not plan.fold
    rows, cols = -(-m // plan.tile), -(-n // plan.tile)
    assert plan.tiles == rows * cols and plan.blocks == batch * plan.tiles
    assert (rows - 1) * plan.tile < m <= rows * plan.tile
    assert (cols - 1) * plan.tile < n <= cols * plan.tile
    _chunks_cover(plan, k)


@pytest.mark.parametrize("batch,m,n,k", MATMUL)
def test_matmul_plan_takes_the_cheapest_modelled_plan(batch, m, n, k):
    """No tile of matmul's and no split the planner weighs is cheaper by its
    model; of equal costs the earlier tile and the smaller split win."""
    plan = gemm_plan.dense_plan(batch, m, n, k, SMS, gemm_plan.MATMUL_TILES)
    best = gemm_plan.cost(plan.tile, plan.blocks, plan.chunk, plan.splits,
                          SMS, batch * m * n)
    options = gemm_plan.dense_options(batch, m, n, gemm_plan.MATMUL_TILES)
    assert [o[0] for o in options] == list(gemm_plan.MATMUL_TILES)
    for tile, tiles, blocks, _ in options:
        for s in range(1, gemm_plan.max_splits(k) + 1):
            chunk, used = gemm_plan.chunks(k, s)
            t = gemm_plan.cost(tile, blocks, chunk, used, SMS, batch * m * n)
            assert best <= t
            if t == best and tile == plan.tile:
                assert plan.splits <= used


@pytest.mark.parametrize("batch,m,n,k,tile", [
    (12, 3072, 3072, 3072, 128), (3, 1001, 1001, 1001, 64)])
def test_matmul_plan_tile_at_whisper_and_the_gamma_sweep(batch, m, n, k,
                                                         tile):
    """whisper's stacked (12, 3072, 3072) NS products (6912 blocks of 128)
    take the 128 tile whole; the gamma sweep's (3, 1001, 1001) (192 tiles
    of 128 against the card's 264 two-block slots) the 64 tile."""
    plan = gemm_plan.dense_plan(batch, m, n, k, SMS, gemm_plan.MATMUL_TILES)
    assert (plan.tile, plan.splits) == (tile, 1)
    if tile == 128:
        assert plan.blocks == 6912


def test_matmul_rescale_plans_unchanged():
    """matmul_rescale keeps its one 64 tile: its picks at the autoencoder's
    8 eigen-path products (a, g) @ (g, g) are the ones it launched before
    matmul's kernel learnt the 128 tile."""
    want = [(64, 208, 1008, 1), (64, 128, 512, 1), (64, 32, 64, 4),
            (64, 4, 32, 1), (64, 4, 48, 6), (64, 32, 64, 8),
            (64, 128, 512, 2), (64, 208, 784, 1)]
    got = [gemm_plan.dense_plan(1, a, g, g, SMS) for a, g in AE_LAYERS]
    assert [(p.tile, p.blocks, p.chunk, p.splits) for p in got] == want
    assert gemm_plan.dense_options(1, 785, 1000) == [(64, 208, 208, False)]


# (m, n, k) of axpy_momentum, a_inv (m, k) @ T (k, n): the autoencoder's 8
# layers (a, g) at K = a, then ragged and small ones
AXPY = ([(a, g, a) for a, g in AE_LAYERS]
        + [(31, 30, 31), (251, 1000, 251), (1001, 250, 1001), (77, 5, 3),
           (64, 64, 64), (65, 129, 1000), (5, 7, 0)])


@pytest.mark.parametrize("m,n,k", AXPY)
def test_axpy_momentum_launch(m, n, k):
    """What axpy_momentum's wrapper hands its kernel, row-major and aligned
    operands: one block per 64×64 output tile, K whole, and ΣD² partials of
    one float per tile, (ceil(m/64), ceil(n/64)), covering (m, n) with no
    empty row or column of tiles; T's rows copied 16 bytes at a time
    exactly where n % 4 == 0 (the autoencoder's g = 1000, 500, 784), a_inv
    staged as rows exactly where k % 4 == 0 (never at its ragged K = a)."""
    rows, cols = partials_grid(m, n)
    assert gemm_plan.DENSE_TILE == 64
    assert (rows - 1) * 64 < m <= rows * 64
    assert (cols - 1) * 64 < n <= cols * 64
    a, b = torch.zeros(m, k), torch.zeros(k, n)
    op = Operands(a, b, [torch.zeros(m, n)], 0, m, n, k, [0, 0, 0], None)
    assert gemm_plan.dense_vec16(op) is (n % 4 == 0)
    assert gemm_plan.dense_rows16(op, gemm_plan.DENSE_TILE) is (k % 4 == 0)


@pytest.mark.parametrize("case", PATCH)
def test_triangle_plan_covers_the_symmetric_output(case):
    b, t, c, taps, stride, padding, bias = case
    core = taps * c
    d = core + int(bias)
    t_out = patch_geometry((b, t, c), taps, stride, padding)[1]
    plan = gemm_plan.triangle_plan(d, core, bias, b * t_out, SMS)
    assert plan.tile in gemm_plan.TILES
    assert (plan.tiles, plan.blocks, plan.fold) == gemm_plan.triangle_tiles(
        d, core, bias, plan.tile)
    assert plan.blocks == plan.tiles * (plan.tiles + 1) // 2
    if plan.fold:   # the core fills whole tiles; the bias is the last entry
        assert bias and plan.tiles * plan.tile == core and d == core + 1
    else:
        assert (plan.tiles - 1) * plan.tile < d <= plan.tiles * plan.tile
    _chunks_cover(plan, b * t_out)


def test_triangle_plan_at_whisper_small_stems():
    """conv2 (d = 2305 = 18·128 + 1) folds its bias feature into the last
    tile column (171 blocks, not 190); conv1 (d = 241, three triangle tiles
    of 128) splits its 24,000 rows over the grid."""
    conv2 = gemm_plan.triangle_plan(2305, 2304, True, 8 * 1500, SMS)
    assert (conv2.tile, conv2.tiles, conv2.fold, conv2.blocks) == (
        128, 18, True, 171)
    conv1 = gemm_plan.triangle_plan(241, 240, True, 8 * 3000, SMS)
    assert not conv1.fold and conv1.splits > 1
    assert conv1.blocks * conv1.splits >= SMS // 2


def _op(b, n, sb, a=None, sa=0):
    a = torch.zeros(2, 2) if a is None else a
    return Operands(a, b, [a], 0, 2, n, a.shape[-1], [sa, sb, 0], a)


@pytest.mark.parametrize("n,offset,sb,want", [
    (1000, 0, 0, True), (784, 0, 784 * 784, True), (250, 0, 0, False),
    (30, 0, 0, False), (1000, 1, 0, False), (1000, 4, 0, True),
    (1000, 0, 6, False)])
def test_dense_copy_width(n, offset, sb, want):
    """16-byte copies of B only for a width and batch stride that are
    multiples of 4 floats and a 16-byte aligned start."""
    base = torch.zeros(8 + 4 * n)
    assert base.data_ptr() % 16 == 0
    b = base[offset:offset + 4 * n].view(4, n)
    assert gemm_plan.dense_vec16(_op(b, n, sb)) is want


@pytest.mark.parametrize("k,offset,sa,want", [
    (1000, 0, 0, True), (3072, 0, 3072 * 3072, True), (768, 0, 0, True),
    (1001, 0, 0, False), (785, 0, 0, False), (31, 0, 0, False),
    (1000, 1, 0, False), (1000, 2, 0, False), (1000, 4, 0, True),
    (1000, 0, 6, False)])
def test_dense_rows_copy_width(k, offset, sa, want):
    """A staged as rows by 16-byte copies only on the 64 tile, for a K and
    a batch stride that are multiples of 4 floats and a 16-byte aligned
    start; ragged K, and the 128 tile, keep the k-major 4-byte copies."""
    base = torch.zeros(8 + 2 * k)
    assert base.data_ptr() % 16 == 0
    a = base[offset:offset + 2 * k].view(2, k)
    op = _op(torch.zeros(k, 4), 4, 0, a, sa)
    assert gemm_plan.dense_rows16(op, 64) is want
    assert gemm_plan.dense_rows16(op, 128) is False


@pytest.mark.parametrize("n,offset,tiles", [
    (3072, 0, (128, 64)), (1000, 0, (128, 64)), (1001, 0, (64,)),
    (30, 0, (64,)), (1000, 1, (64,))])
def test_matmul_tiles_need_16_byte_copies_of_b_at_128(n, offset, tiles):
    """matmul offers its 128 tile only where B's rows are copied 16 bytes
    at a time; else the 64 tile, whose 4-byte loader fits its registers."""
    base = torch.zeros(8 + 4 * n)
    b = base[offset:offset + 4 * n].view(4, n)
    assert gemm_plan.matmul_tiles(_op(b, n, 0)) == tiles


@pytest.mark.parametrize("c,offset,want", [
    (768, 0, True), (80, 0, True), (13, 0, False), (136, 0, True),
    (8, 2, False), (8, 4, True)])
def test_patch_copy_width(c, offset, want):
    """16-byte copies of x only for C % 4 == 0 and a 16-byte aligned x."""
    base = torch.zeros(8 + 2 * 3 * c)
    assert base.data_ptr() % 16 == 0
    x = base[offset:offset + 2 * 3 * c].view(2, 3, c)
    assert patch_vec16(x) is want


@pytest.mark.parametrize("batch,n,d", FACTOR)
def test_factor_update_plan_covers_the_triangle(batch, n, d):
    """XᵀX of every slice: one triangle of tiles over (d, d), each slice's
    blocks launched once per K chunk, the chunks summing every row of X
    once, and a batch never split (grid z runs over the slices)."""
    plan = gemm_plan.triangle_plan(d, d, False, n, SMS, batch)
    assert plan.tile in gemm_plan.TILES and not plan.fold
    assert (plan.tiles - 1) * plan.tile < d <= plan.tiles * plan.tile
    assert plan.blocks == batch * plan.tiles * (plan.tiles + 1) // 2
    _chunks_cover(plan, n)
    if batch > 1:
        assert plan.splits == 1
    if (batch, n, d) in WHISPER_FU:
        assert plan.tile == 128


@pytest.mark.parametrize("batch,n,d", FACTOR)
def test_factor_update_plan_takes_the_cheapest_modelled_plan(batch, n, d):
    """No tile and split the planner weighs (a batch: no split) is cheaper
    by its model."""
    plan = gemm_plan.triangle_plan(d, d, False, n, SMS, batch)
    best = gemm_plan.cost(plan.tile, plan.blocks, plan.chunk, plan.splits,
                          SMS, batch * d * d)
    for tile, tiles, blocks, _ in gemm_plan.triangle_options(d, d, False):
        for s in range(1, (1 if batch > 1 else gemm_plan.max_splits(n)) + 1):
            chunk, used = gemm_plan.chunks(n, s)
            assert best <= gemm_plan.cost(tile, batch * blocks, chunk, used,
                                          SMS, batch * d * d)


@pytest.mark.parametrize("shape,offset,want", [
    ((4, 1000), 0, True), ((4, 768), 0, True), ((2, 4, 768), 0, True),
    ((4, 1001), 0, False), ((4, 785), 0, False), ((4, 30), 0, False),
    ((4, 1000), 1, False), ((4, 1000), 2, False), ((4, 1000), 4, True),
    ((2, 4, 33), 0, False)])
def test_factor_update_copy_width(shape, offset, want):
    """16-byte copies of X only for d % 4 == 0 (each row and each batch
    slice then starts on a 16-byte boundary) and a 16-byte aligned X."""
    n = 1
    for s in shape:
        n *= s
    base = torch.zeros(8 + n)
    assert base.data_ptr() % 16 == 0
    assert factor_vec16(base[offset:offset + n].view(shape)) is want
