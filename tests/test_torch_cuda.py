"""The port's CUDA kernels on the card, against their plain versions,
three full-width trainer steps on each path (blkdiag, eigen, fused,
tridiag with the exact-F re-scaling and on the fused chain; the
staggered refresh's three steps after its warmup), a full-width blkdiag
resume from a checkpoint with exact launches, checkpoints written from the
card restored on the CPU bitwise, the eigen path's bundle bitwise its
state, a reduced llama serving run on each decode route and a reduced
gemma2 one; factor_update at the conv classifier's factor sides, a fused
statistics pass against a two-pass one (conv classifier and autoencoder),
the fused G probe and a fused 1-D conv's patch_factor contraction, and 6
reduced conv classifier steps cuda vs cpu.
No JAX: the machine with the card has none.

Every test is marked ``cuda`` and skips, inside its body, when
``torch.cuda.is_available()`` is false.  On the card (``--noconftest``:
``tests/conftest.py`` imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Tolerance: max|kernel - plain| <= 1e-4 * max|plain| (fp32 sums over
K <= 8192 in another order), 1e-4 * max|alpha * XᵀX| for factor_update,
relative 1e-4 for the update chain's ΣD², and 1e-5 * max|plain| for the
decode kernels (fp32 sums over <= 8192 keys) and flash_attention; the
first-order baselines', tridiag's and the modes' (τ1, stats_period, the
staggered refresh, the Gaussian loss) losses over 6 reduced-autoencoder
steps within rtol 1e-3 of the CPU's (``chip_smoke.py``'s phases 4 and
"modes"); TF32 is off.
"""
import math

import pytest
import torch

from repro_torch import kernels as K
from repro_torch import optimizers
from repro_torch.configs import get_reduced_config
from repro_torch.configs.autoencoder import CONFIG, reduced
from repro_torch.configs.base import KFACConfig, TrainConfig
from repro_torch.data.pipeline import SyntheticAutoencoderData
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels.factor_update import factor_update, factor_update_ref
from repro_torch.kernels.gemm_plan import sm_count
from repro_torch.kernels.matmul import matmul, matmul_ref, operands
from repro_torch.kernels.ns_step import (ns_inverse, ns_inverse_ref, ns_step,
                                         ns_step_ref)
from repro_torch.kernels.precond import precondition, precondition_ref
from repro_torch.kernels.rotate_rescale import (matmul_rescale,
                                                matmul_rescale_ref,
                                                rotate_rescale,
                                                rotate_rescale_ref)
from repro_torch.kernels.update_chain import (axpy_momentum,
                                              axpy_momentum_ref,
                                              precond_momentum,
                                              precond_momentum_ref)
from repro_torch.models.lm import LM
from repro_torch.models.mlp import MLP, autoencoder_dims
from repro_torch.optimizers.kfac import kfac
from repro_torch.serving.server import Engine, Request
from repro_torch.training.trainer import Trainer
from repro_torch.utils.tree import tree_map

pytestmark = pytest.mark.cuda

DIMS = autoencoder_dims(CONFIG)
LAYERS = [(DIMS[i] + 1, DIMS[i + 1]) for i in range(len(DIMS) - 1)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, scale=None, tol=1e-4):
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item() if scale is None else scale
    assert math.isfinite(err) and err <= tol * scale, (err, scale)


def _spd(g, d, n=512):
    x = torch.tanh(torch.randn(n, d, generator=g, device="cuda"))
    return x.T @ x / n + 0.1 * torch.eye(d, device="cuda")


@pytest.mark.parametrize("n,d", [(8192, 785), (8192, 1001), (8192, 1000),
                                 (8192, 784), (8192, 501), (8192, 251),
                                 (8192, 31), (8192, 30), (1000, 30),
                                 (777, 251)])
def test_factor_update_on_card(n, d):
    """At beta = 0 (the first step) and beta = 0.95, held to the scale of
    alpha * XᵀX alone, which beta * C would otherwise dwarf; with a C that
    is bitwise symmetric the output is too (one triangle plus its mirror),
    and a second call gives the same bits."""
    g = _card()
    x = torch.tanh(torch.randn(n, d, generator=g, device="cuda"))
    c = _spd(g, d)
    c = 0.5 * (c + c.T)   # bitwise symmetric
    for e in (0.0, 0.95):
        eps = torch.tensor(e, device="cuda")
        a = (1 - eps) / n
        before = factor_update.launches
        got = factor_update(x, c, alpha=a, beta=eps)
        assert factor_update.launches == before + 1
        prod = factor_update_ref(x, c, alpha=a, beta=0.0)
        _close(got, factor_update_ref(x, c, alpha=a, beta=eps),
               scale=prod.abs().max().item())
        assert torch.equal(got, got.T)
        assert torch.equal(got, factor_update(x, c, alpha=a, beta=eps))


def _factor_close(x, c, a, b):
    prod = factor_update_ref(x, c, alpha=a, beta=0.0)
    got = factor_update(x, c, alpha=a, beta=b)
    _close(got, factor_update_ref(x, c, alpha=a, beta=b),
           scale=prod.abs().max().item())
    return got


@pytest.mark.parametrize("shape", [(8192, 1001), (8192, 1000), (1000, 30),
                                   (777, 251), (3, 100, 33), (2, 512, 768)])
def test_factor_update_nonsymmetric_c_on_card(shape):
    """One triangle plus a mirror: each mirrored entry takes its own entry
    of a C that is not symmetric (alpha = 1 - eps, so that an entry read
    from the wrong side of C stands far above the tolerance)."""
    g = _card()
    x = torch.tanh(torch.randn(*shape, generator=g, device="cuda"))
    d = shape[-1]
    c = torch.randn(*shape[:-2], d, d, generator=g, device="cuda")
    eps = torch.tensor(0.95, device="cuda")
    _factor_close(x, c, 1 - eps, eps)


@pytest.mark.parametrize("tile", [128, 64])
@pytest.mark.parametrize("splits", [1, 4])
def test_factor_update_forced_plans_on_card(tile, splits, monkeypatch):
    """Each tile, the rows whole and split (a short last chunk), at a
    ragged shape with a C that is not symmetric; a symmetric C gives a
    bitwise symmetric output, and a second call the same bits."""
    from repro_torch.kernels import gemm_plan
    g = _card()
    n, d = 777, 251
    chunk, used = gemm_plan.chunks(n, splits)
    assert used == splits and n % chunk != 0
    plan = gemm_plan.Plan(tile, -(-d // tile), 0, chunk, used)
    monkeypatch.setattr(gemm_plan, "triangle_plan", lambda *_: plan)
    x = torch.tanh(torch.randn(n, d, generator=g, device="cuda"))
    eps = torch.tensor(0.95, device="cuda")
    _factor_close(x, torch.randn(d, d, generator=g, device="cuda"), 1 - eps,
                  eps)
    c = _spd(g, d)
    c = 0.5 * (c + c.T)
    got = _factor_close(x, c, (1 - eps) / n, eps)
    assert torch.equal(got, got.T)
    assert torch.equal(got, factor_update(x, c, alpha=(1 - eps) / n,
                                          beta=eps))


@pytest.mark.parametrize("n,d,offset,vec", [
    (1000, 1000, 0, True), (1000, 1000, 1, False), (1000, 1001, 0, False),
    (300, 768, 0, True), (300, 768, 2, False), (300, 30, 0, False)])
def test_factor_update_copy_widths_on_card(n, d, offset, vec):
    """The 16-byte loader (d % 4 == 0, x 16-byte aligned) and the 4-byte
    one (d % 4 != 0, or x off a 16-byte boundary)."""
    from repro_torch.kernels.factor_update import vec16
    g = _card()
    base = torch.tanh(torch.randn(n * d + 4, generator=g, device="cuda"))
    x = base[offset:offset + n * d].view(n, d)
    assert vec16(x) is vec
    eps = torch.tensor(0.95, device="cuda")
    _factor_close(x, torch.randn(d, d, generator=g, device="cuda"), 1 - eps,
                  eps)


@pytest.mark.parametrize("a,gd", LAYERS)
def test_precondition_on_card(a, gd):
    g = _card()
    ai, gi = _spd(g, a), _spd(g, gd)
    v = torch.randn(a, gd, generator=g, device="cuda")
    _close(precondition(ai, v, gi), precondition_ref(ai, v, gi))


def test_matmul_batched_and_device_scalars_on_card():
    g = _card()
    a = torch.randn(3, 65, 33, generator=g, device="cuda")
    b = torch.randn(33, 17, generator=g, device="cuda")
    c = torch.randn(3, 65, 17, generator=g, device="cuda")
    al, be = torch.tensor(0.3, device="cuda"), torch.tensor(-2.0, device="cuda")
    _close(matmul(a, b, c, alpha=al, beta=be),
           matmul_ref(a, b, c, alpha=al, beta=be))
    _close(matmul(a, b, c, alpha=-1.0, beta=2.0),
           matmul_ref(a, b, c, alpha=-1.0, beta=2.0))


@pytest.mark.parametrize("d", [1001, 785, 31])
def test_ns_on_card(d):
    g = _card()
    m = _spd(g, d, 8192)
    x0 = torch.eye(d, device="cuda") / m.abs().sum(-1).max()
    _close(ns_step(m, x0), ns_step_ref(m, x0))
    _close(ns_inverse(m, 12), ns_inverse_ref(m, 12))
    m3 = torch.stack([m, m + 0.1 * torch.eye(d, device="cuda"),
                      m + 0.2 * torch.eye(d, device="cuda")])
    _close(ns_inverse(m3, 12), ns_inverse_ref(m3, 12))


def test_three_full_width_trainer_steps():
    _card()
    mlp = MLP(DIMS, device="cuda")
    params = mlp.init_params(torch.Generator().manual_seed(0))
    data = SyntheticAutoencoderData(DIMS[0], 8, 8192, seed=7, device="cuda")
    opt = kfac(mlp, KFACConfig(inverse_method="ns", lambda_init=3.0, t3=5,
                               eta=1e-5), family="bernoulli", device="cuda")
    K.reset_launches()
    out = Trainer(mlp, opt, TrainConfig(seed=0), device="cuda").fit(
        params, data, steps=3, log=lambda *_: None)
    losses = [h["loss"] for h in out["history"]]
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
    assert K.launches() == {"factor_update": 48, "precondition": 24,
                            "ns_step": 3 * 16 * 12,
                            "matmul": 2 * (24 + 3 * 16 * 12),
                            "matmul_rescale": 0, "rotate_rescale": 0,
                            "axpy_momentum": 0, "precond_momentum": 0,
                            "flash_decode": 0, "flash_decode_paged": 0,
                            "flash_attention": 0, "patch_factor": 0}


def test_matmul_transposed_views_on_card():
    """A transposed (non-row-major) view is copied row-major before the
    launch and gives the plain product."""
    g = _card()
    q = torch.randn(251, 251, generator=g, device="cuda")
    v = torch.randn(251, 30, generator=g, device="cuda")
    w = torch.randn(30, 30, generator=g, device="cuda")
    _close(matmul(q.T, v), matmul_ref(q.T, v))
    _close(matmul(v, w.T), matmul_ref(v, w.T))
    _close(matmul(v.T, q.T), matmul_ref(v.T, q.T))
    b = torch.randn(3, 31, 65, generator=g, device="cuda")
    _close(matmul(b.transpose(1, 2), b), matmul_ref(b.transpose(1, 2), b))


# (batch, m, k, n) of matmul's forced plans: the ragged sides 31, 251, 785
# and 1001 as M, K and N (4-byte copies of A and B), one K % 4 == 0 case
# (A staged by 16-byte copies), and a batch of 3; the 128 tile copies B 16
# bytes at a time only, so it takes the cases whose N % 4 == 0 and refuses
# the others
MM_CASES = [(1, 31, 251, 785), (1, 1001, 785, 31), (1, 251, 1001, 252),
            (1, 785, 1000, 251), (3, 251, 65, 1000)]


def _matmul_case(g, batch, m, k, n, c_mode):
    lead = (batch,) if batch > 1 else ()
    a = torch.randn(*lead, m, k, generator=g, device="cuda")
    b = torch.randn(k, n, generator=g, device="cuda")
    c = {"absent": None,
         "present": torch.randn(*lead, m, n, generator=g, device="cuda"),
         "broadcast": torch.randn(1, m, n, generator=g, device="cuda")
         }[c_mode]
    return a, b, c


@pytest.mark.parametrize("c_mode", ["absent", "present", "broadcast"])
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("tile", [128, 64])
def test_matmul_forced_plans_on_card(tile, splits, c_mode, monkeypatch):
    """Each tile, K whole and split (a short last chunk), at ragged shapes,
    with C absent, present and broadcast over the batch, alpha/beta by value
    and on the device; one launch a call, split or not.  A 128 tile forced
    on a B it cannot copy 16 bytes at a time raises."""
    from repro_torch.kernels import gemm_plan
    g = _card()
    scalars = [(-0.7, 1.9), (torch.tensor(-0.7, device="cuda"),
                            torch.tensor(1.9, device="cuda"))]
    for batch, m, k, n in MM_CASES:
        chunk, used = gemm_plan.chunks(k, splits)
        assert used == splits
        tiles = -(-m // tile) * -(-n // tile)
        plan = gemm_plan.Plan(tile, tiles, batch * tiles, chunk, used)
        monkeypatch.setattr(gemm_plan, "dense_plan", lambda *_, p=plan: p)
        a, b, c = _matmul_case(g, batch, m, k, n, c_mode)
        if tile not in gemm_plan.matmul_tiles(operands("matmul", a, b)):
            with pytest.raises(RuntimeError):
                matmul(a, b, c)
            continue
        for al, be in scalars:
            before = matmul.launches
            got = matmul(a, b, c, alpha=al, beta=be)
            assert matmul.launches == before + 1
            _close(got, matmul_ref(a, b, c, alpha=al, beta=be))


@pytest.mark.parametrize("tile", [128, 64])
def test_matmul_split_and_staging_bitwise_on_card(tile, monkeypatch):
    """A split K gives the same bits on a second call (the partials are
    added in a fixed order), and on the 64 tile A staged as rows by 16-byte
    copies gives the bits of A staged k-major (the same FMA chains)."""
    from repro_torch.kernels import gemm_plan
    g = _card()
    batch, m, k, n = 3, 251, 1000, 132
    tiles = -(-m // tile) * -(-n // tile)
    a, b, c = _matmul_case(g, batch, m, k, n, "broadcast")
    assert gemm_plan.dense_rows16(operands("matmul", a, b), tile) is (
        tile == 64)
    keep = gemm_plan.dense_rows16
    for splits in (1, 4):
        chunk, used = gemm_plan.chunks(k, splits)
        plan = gemm_plan.Plan(tile, tiles, batch * tiles, chunk, used)
        monkeypatch.setattr(gemm_plan, "dense_plan", lambda *_, p=plan: p)
        monkeypatch.setattr(gemm_plan, "dense_rows16", keep)
        got = matmul(a, b, c, alpha=0.3, beta=-1.0)
        assert torch.equal(got, matmul(a, b, c, alpha=0.3, beta=-1.0))
        _close(got, matmul_ref(a, b, c, alpha=0.3, beta=-1.0))
        monkeypatch.setattr(gemm_plan, "dense_rows16", lambda op, t: False)
        assert torch.equal(got, matmul(a, b, c, alpha=0.3, beta=-1.0))


def test_matmul_whisper_stacked_ns_step_on_card():
    """whisper-small's stacked (12, 3072, 3072) Newton–Schulz step, both of
    its products on the 128 tile by the planner's own pick."""
    from repro_torch.kernels import gemm_plan
    g = _card()
    s, d = 12, 3072
    plan = gemm_plan.dense_plan(s, d, d, d, sm_count(0),
                                gemm_plan.MATMUL_TILES)
    assert (plan.tile, plan.splits) == (128, 1)
    m = torch.stack([_spd(g, d, 1024) for _ in range(2)]).repeat(6, 1, 1)
    x = (torch.eye(d, device="cuda") / m.abs().sum(-1).amax(-1)[:, None, None]
         + 1e-4 * torch.randn(s, d, d, generator=g, device="cuda"))
    _close(matmul(m, x), matmul_ref(m, x))
    _close(ns_step(m, x), ns_step_ref(m, x))


def _eig_operands(g, a, gd):
    qa = torch.linalg.eigh(_spd(g, a))[1]
    qg = torch.linalg.eigh(_spd(g, gd))[1]
    v = torch.randn(a, gd, generator=g, device="cuda")
    s = torch.rand(a, gd, generator=g, device="cuda") + 0.05
    return qa, v, qg, s


@pytest.mark.parametrize("a,gd", LAYERS)
def test_rotate_rescale_on_card(a, gd):
    g = _card()
    qa, v, qg, s = _eig_operands(g, a, gd)
    lam = torch.tensor(1e-12, device="cuda")
    before = (rotate_rescale.launches, matmul_rescale.launches,
              matmul.launches)
    got = rotate_rescale(qa, v, qg, s, lam)
    assert (rotate_rescale.launches, matmul_rescale.launches,
            matmul.launches) == (before[0] + 1, before[1] + 1, before[2] + 3)
    _close(got, rotate_rescale_ref(qa, v, qg, s, lam))
    t = qa.T @ v
    _close(matmul_rescale(t, qg, s, lam), matmul_rescale_ref(t, qg, s, lam))
    _close(matmul_rescale(t, qg, s, 0.5), matmul_rescale_ref(t, qg, s, 0.5))


def test_matmul_rescale_batched_on_card():
    g = _card()
    t = torch.randn(3, 1001, 500, generator=g, device="cuda")
    q = torch.randn(500, 500, generator=g, device="cuda")
    s = torch.rand(3, 1001, 500, generator=g, device="cuda") + 0.05
    lam = torch.tensor(0.1, device="cuda")
    _close(matmul_rescale(t, q, s, lam), matmul_rescale_ref(t, q, s, lam))


# (batch, m, k, n, b offset in floats): the 8 layers' (a, g) @ (g, g), then
# the copy-width and split edges of the pipelined main loop: K = N = 30 and
# 250 (4-byte copies of B), a B one float off a 16-byte boundary, a
# batch of 3 with a broadcast B
MR_CASES = [(1, a, gd, gd, 0) for a, gd in LAYERS] + [
    (1, 77, 30, 30, 0), (1, 300, 250, 250, 0), (1, 785, 1000, 1000, 1),
    (3, 785, 1000, 1000, 0), (3, 131, 52, 52, 1)]


@pytest.mark.parametrize("case", MR_CASES)
def test_matmul_rescale_plans_on_card(case):
    """matmul_rescale against its plain version on every plan the
    autoencoder's shapes and the edges reach (K whole and split, 16- and
    4-byte copies, a broadcast B), lam as a number and as a device
    scalar."""
    from repro_torch.kernels import gemm_plan
    batch, m, k, n, off = case
    g = _card()
    lead = (batch,) if batch > 1 else ()
    t = torch.randn(*lead, m, k, generator=g, device="cuda")
    b = torch.randn(k * n + off, generator=g, device="cuda")[off:].view(k, n)
    s = torch.rand(*lead, m, n, generator=g, device="cuda") + 0.05
    plan = gemm_plan.dense_plan(batch, m, n, k, gemm_plan.sm_count(0))
    if (batch, m, k, n) == (1, 251, 500, 500):
        assert plan.splits > 1
    for lam in (torch.tensor(1e-3, device="cuda"), 0.5):
        before = matmul_rescale.launches
        got = matmul_rescale(t, b, s, lam)
        assert matmul_rescale.launches == before + 1
        _close(got, matmul_rescale_ref(t, b, s, lam))


@pytest.mark.parametrize("k", [1000, 52])
def test_matmul_rescale_staging_bitwise_on_card(k, monkeypatch):
    """A staged as rows by 16-byte copies (K % 4 == 0) gives the bits of A
    staged k-major, K whole and split."""
    from repro_torch.kernels import gemm_plan
    g = _card()
    t = torch.randn(3, 131, k, generator=g, device="cuda")
    q = torch.randn(k, 68, generator=g, device="cuda")
    s = torch.rand(3, 131, 68, generator=g, device="cuda") + 0.05
    assert gemm_plan.dense_rows16(operands("matmul_rescale", t, q, s), 64)
    rows16 = gemm_plan.dense_rows16
    for splits in (1, 3):
        chunk, used = gemm_plan.chunks(k, splits)
        plan = gemm_plan.Plan(64, 6, 18, chunk, used)
        monkeypatch.setattr(gemm_plan, "dense_plan", lambda *_, p=plan: p)
        monkeypatch.setattr(gemm_plan, "dense_rows16", rows16)
        got = matmul_rescale(t, q, s, 0.1)
        _close(got, matmul_rescale_ref(t, q, s, 0.1))
        monkeypatch.setattr(gemm_plan, "dense_rows16", lambda op, tile: False)
        assert torch.equal(got, matmul_rescale(t, q, s, 0.1))


@pytest.mark.parametrize("a,gd", LAYERS)
def test_update_chain_on_card(a, gd):
    g = _card()
    ai, gi = _spd(g, a), _spd(g, gd)
    v, mom = (torch.randn(a, gd, generator=g, device="cuda")
              for _ in range(2))
    al, mu = torch.tensor(-0.02, device="cuda"), torch.tensor(0.9,
                                                              device="cuda")
    before = (precond_momentum.launches, axpy_momentum.launches)
    d, sq = precond_momentum(ai, v, gi, mom, alpha=al, mu=mu)
    assert (precond_momentum.launches, axpy_momentum.launches) == (
        before[0] + 1, before[1] + 1)
    d_ref, sq_ref = precond_momentum_ref(ai, v, gi, mom, alpha=al, mu=mu)
    _close(d, d_ref)
    assert sq.dim() == 0 and sq.device.type == "cuda"
    assert abs(sq.item() - sq_ref.item()) <= 1e-4 * sq_ref.item()
    t = v @ gi
    d2, sq2 = axpy_momentum(ai, t, mom, -0.05, 0.0)
    d2_ref, sq2_ref = axpy_momentum_ref(ai, t, mom, -0.05, 0.0)
    _close(d2, d2_ref)
    assert abs(sq2.item() - sq2_ref.item()) <= 1e-4 * sq2_ref.item()
    # no atomics: the sum is the same on every run
    assert torch.equal(precond_momentum(ai, v, gi, mom, alpha=al, mu=mu)[1],
                       sq)


def _close_sq(got, want):
    assert got.dim() == 0 and got.device.type == "cuda"
    assert abs(got.item() - want.item()) <= 1e-4 * want.item(), (got, want)


# (a, g): a_inv (a, a) @ T (a, g) with ragged a (A staged k-major) against
# g = 30 and 250 (4-byte copies of T) and 1000 (16-byte copies)
AXPY_CASES = [(a, gd) for a in (31, 251, 501, 1001) for gd in (30, 250, 1000)]


@pytest.mark.parametrize("a,gd", AXPY_CASES)
def test_axpy_momentum_ragged_on_card(a, gd):
    """axpy_momentum against its plain version at ragged shapes, alpha and
    mu on the device and as Python numbers, and mu = 0: D within TOL, ΣD²
    within relative 1e-4, one launch a call, and two calls bitwise equal."""
    from repro_torch.kernels import gemm_plan
    g = _card()
    ai = _spd(g, a)
    t, mom = (torch.randn(a, gd, generator=g, device="cuda")
              for _ in range(2))
    op = operands("axpy_momentum", ai, t, mom)
    assert gemm_plan.dense_vec16(op) is (gd % 4 == 0)
    assert not gemm_plan.dense_rows16(op, gemm_plan.DENSE_TILE)
    al, mu = torch.tensor(-0.02, device="cuda"), torch.tensor(0.9,
                                                              device="cuda")
    for alpha, m_ in ((al, mu), (-0.02, 0.9), (al, 0.0), (-0.05, 0.0)):
        before = axpy_momentum.launches
        d, sq = axpy_momentum(ai, t, mom, alpha, m_)
        assert axpy_momentum.launches == before + 1
        d_ref, sq_ref = axpy_momentum_ref(ai, t, mom, alpha, m_)
        _close(d, d_ref)
        _close_sq(sq, sq_ref)
        d2, sq2 = axpy_momentum(ai, t, mom, alpha, m_)
        assert torch.equal(d2, d) and torch.equal(sq2, sq)


@pytest.mark.parametrize("k", [1000, 52])
def test_axpy_momentum_staging_bitwise_on_card(k, monkeypatch):
    """A staged as rows by 16-byte copies (K % 4 == 0) gives the bits of A
    staged k-major, D and ΣD² alike."""
    from repro_torch.kernels import gemm_plan
    g = _card()
    ai = torch.randn(131, k, generator=g, device="cuda")
    t = torch.randn(k, 68, generator=g, device="cuda")
    mom = torch.randn(131, 68, generator=g, device="cuda")
    assert gemm_plan.dense_rows16(operands("axpy_momentum", ai, t, mom), 64)
    d, sq = axpy_momentum(ai, t, mom, 0.3, 0.9)
    d_ref, sq_ref = axpy_momentum_ref(ai, t, mom, 0.3, 0.9)
    _close(d, d_ref)
    _close_sq(sq, sq_ref)
    monkeypatch.setattr(gemm_plan, "dense_rows16", lambda op, tile: False)
    d2, sq2 = axpy_momentum(ai, t, mom, 0.3, 0.9)
    assert torch.equal(d2, d) and torch.equal(sq2, sq)


def test_new_wrappers_raise_on_bad_operands():
    """A non-f32 or mixed-device call raises; nothing falls back."""
    g = _card()
    qa, v, qg, s = _eig_operands(g, 31, 30)
    al, mu = torch.tensor(-0.02, device="cuda"), torch.tensor(0.9,
                                                              device="cuda")
    f64 = lambda t: t.double()
    cpu = lambda t: t.cpu()
    for bad in (f64, cpu):
        with pytest.raises((TypeError, ValueError, RuntimeError)):
            matmul_rescale(qa, bad(v), s, 0.1)
        with pytest.raises((TypeError, ValueError, RuntimeError)):
            rotate_rescale(qa, v, bad(qg), s, 1e-12)
        with pytest.raises((TypeError, ValueError, RuntimeError)):
            axpy_momentum(qa, v, bad(s), al, mu)
        with pytest.raises((TypeError, ValueError, RuntimeError)):
            precond_momentum(qa, v, qg, bad(s), alpha=al, mu=mu)


PATHS = {
    "eigen": dict(inv_mode="eigen", lambda_init=3.0, t3=5, eta=1e-5),
    "fused": dict(inv_mode="blkdiag", inverse_method="ns", use_rescale=False,
                  fixed_lr=0.02, fixed_momentum=0.9, kl_clip=1e-3,
                  lambda_init=3.0, t3=5, eta=1e-5),
}
# 3 steps, every one a warmup refresh: eigen runs rotate_rescale on the 8
# layers each step; fused runs 16 NS refreshes of 12 steps and the chain
LAUNCHES = {
    "eigen": {"factor_update": 48, "precondition": 0, "ns_step": 0,
              "matmul": 3 * 24, "matmul_rescale": 24, "rotate_rescale": 24,
              "axpy_momentum": 0, "precond_momentum": 0,
              "flash_decode": 0, "flash_decode_paged": 0,
              "flash_attention": 0, "patch_factor": 0},
    "fused": {"factor_update": 48, "precondition": 0,
              "ns_step": 3 * 16 * 12, "matmul": 2 * 3 * 16 * 12 + 24,
              "matmul_rescale": 0, "rotate_rescale": 0,
              "axpy_momentum": 24, "precond_momentum": 24,
              "flash_decode": 0, "flash_decode_paged": 0,
              "flash_attention": 0, "patch_factor": 0},
}


@pytest.mark.parametrize("path", ["eigen", "fused"])
def test_three_full_width_steps_eigen_and_fused(path):
    _card()
    mlp = MLP(DIMS, device="cuda")
    params = mlp.init_params(torch.Generator().manual_seed(0))
    data = SyntheticAutoencoderData(DIMS[0], 8, 8192, seed=7, device="cuda")
    opt = kfac(mlp, KFACConfig(**PATHS[path]), family="bernoulli",
               device="cuda")
    K.reset_launches()
    out = Trainer(mlp, opt, TrainConfig(seed=0), device="cuda").fit(
        params, data, steps=3, log=lambda *_: None)
    losses = [h["loss"] for h in out["history"]]
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
    assert K.launches() == LAUNCHES[path]


TRIDIAG = {
    "rescale": dict(inv_mode="tridiag", inverse_method="ns",
                    lambda_init=3.0, t3=5, eta=1e-5),
    "fused": dict(inv_mode="tridiag", inverse_method="ns", use_rescale=False,
                  fixed_lr=0.02, fixed_momentum=0.9, kl_clip=1e-3,
                  lambda_init=3.0, t3=5, eta=1e-5),
}


@pytest.mark.parametrize("path", list(TRIDIAG))
def test_three_full_width_tridiag_steps(path):
    """tridiag (S4.3) at full width: every step a warmup refresh, whose
    per-layer NS inverses run ns_step; the chain's Ξᵀ Λ Ξ apply and its
    fused branch are plain products, so neither precondition nor the
    update chain launches."""
    _card()
    mlp = MLP(DIMS, device="cuda")
    params = mlp.init_params(torch.Generator().manual_seed(0))
    data = SyntheticAutoencoderData(DIMS[0], 8, 8192, seed=7, device="cuda")
    opt = kfac(mlp, KFACConfig(**TRIDIAG[path]), family="bernoulli",
               device="cuda")
    K.reset_launches()
    out = Trainer(mlp, opt, TrainConfig(seed=0), device="cuda").fit(
        params, data, steps=3, log=lambda *_: None)
    losses = [h["loss"] for h in out["history"]]
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
    assert K.launches() == dict({k: 0 for k in K.WRAPPERS},
                                factor_update=48, ns_step=3 * 16 * 12,
                                matmul=2 * 3 * 16 * 12)


@pytest.mark.parametrize("path", list(TRIDIAG))
def test_tridiag_steps_on_card_match_cpu(path):
    """6 tridiag steps of the reduced autoencoder on the card and on the
    CPU from the same weights and uniforms: losses within rtol 1e-3
    (``chip_smoke.py``'s phase 4)."""
    _card()
    dims = autoencoder_dims(reduced())
    hist = {}
    for where in ("cuda", "cpu"):
        mlp = MLP(dims, device=where)
        params = mlp.init_params(torch.Generator().manual_seed(0))
        data = SyntheticAutoencoderData(dims[0], 8, 256, seed=7,
                                        device=where)
        noise = lambda step, shape, where=where: torch.rand(
            shape, generator=torch.Generator().manual_seed(step)).to(where)
        out = Trainer(mlp, kfac(mlp, KFACConfig(**TRIDIAG[path]),
                                family="bernoulli", device=where),
                      TrainConfig(seed=0), noise=noise, device=where).fit(
            params, data, steps=6, log=lambda *_: None)
        hist[where] = [h["loss"] for h in out["history"]]
    assert all(math.isfinite(v) for v in hist["cuda"])
    assert hist["cuda"][-1] < hist["cuda"][0]
    for a, b in zip(hist["cuda"], hist["cpu"]):
        assert abs(a - b) <= 1e-3 * abs(b), (hist["cuda"], hist["cpu"])


@pytest.mark.parametrize("d", [785, 1001])
def test_factor_update_tau1_rows_on_card(d):
    """τ1 = 1/8 of the full batch: 1024 rows, as a contiguous block and as
    the strided view ``x[::8]`` the sub-batch's records are (the wrapper
    copies it), at beta 0 and 0.95."""
    g = _card()
    full = torch.tanh(torch.randn(8192, d, generator=g, device="cuda"))
    c = _spd(g, d)
    assert not full[::8].is_contiguous()
    for x in (full[:1024], full[::8]):
        for e in (0.0, 0.95):
            eps = torch.tensor(e, device="cuda")
            _factor_close(x, c, (1 - eps) / 1024, eps)


def _staggered_launches(opt, steps):
    """blkdiag's launches over ``steps`` staggered steps: full refreshes
    in the warmup (steps 0-2), then one group of ``stagger_groups()`` a
    step at ``ns_hot_iters``, two sides a layer."""
    cfg, groups = opt.engine.cfg, opt.engine.stagger_groups()
    ns = sum(16 * cfg.ns_iters if i < 3 else
             2 * len(groups[i % cfg.t3]) * cfg.ns_hot_iters
             for i in range(steps))
    return dict({k: 0 for k in K.WRAPPERS}, factor_update=16 * steps,
                precondition=8 * steps, ns_step=ns,
                matmul=2 * (8 * steps + ns))


def test_three_full_width_staggered_steps():
    """The staggered refresh at full width: three warmup steps, then three
    steps each refreshing one group (steps 3, 4, 5: groups 3, 4 and 0 of
    the d³ bins) with NS hot at 4 iterations; exact launch counts."""
    _card()
    mlp = MLP(DIMS, device="cuda")
    params = mlp.init_params(torch.Generator().manual_seed(0))
    data = SyntheticAutoencoderData(DIMS[0], 8, 8192, seed=7, device="cuda")
    opt = kfac(mlp, KFACConfig(inverse_method="ns", lambda_init=3.0, t3=5,
                               eta=1e-5, refresh_mode="staggered"),
               family="bernoulli", device="cuda")
    K.reset_launches()
    out = Trainer(mlp, opt, TrainConfig(seed=0), device="cuda").fit(
        params, data, steps=6, log=lambda *_: None)
    losses = [h["loss"] for h in out["history"]]
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
    want = _staggered_launches(opt, 6)
    assert want["ns_step"] == 3 * 16 * 12 + (2 + 8 + 2) * 4
    assert K.launches() == want


MODES = {
    "tau1": (dict(inverse_method="ns", tau1=0.125), "bernoulli"),
    "stats_period2": (dict(inverse_method="ns", stats_period=2),
                      "bernoulli"),
    "staggered": (dict(inverse_method="ns", refresh_mode="staggered"),
                  "bernoulli"),
    "gaussian": (dict(inverse_method="ns"), "gaussian"),
}


@pytest.mark.parametrize("path", list(MODES))
def test_mode_steps_on_card_match_cpu(path):
    """6 reduced-autoencoder steps of each mode on the card and on the CPU
    from the same weights and uniforms: losses within rtol 1e-3
    (``chip_smoke.py``'s modes phase)."""
    _card()
    kw, loss = MODES[path]
    cfg = KFACConfig(lambda_init=3.0, t3=5, eta=1e-5, **kw)
    dims = autoencoder_dims(reduced())
    hist = {}
    for where in ("cuda", "cpu"):
        mlp = MLP(dims, loss=loss, device=where)
        params = mlp.init_params(torch.Generator().manual_seed(0))
        data = SyntheticAutoencoderData(dims[0], 8, 256, seed=7,
                                        device=where)
        noise = lambda step, shape, where=where: torch.rand(
            shape, generator=torch.Generator().manual_seed(step)).to(where)
        out = Trainer(mlp, kfac(mlp, cfg, family=loss, device=where),
                      TrainConfig(seed=0), noise=noise, device=where).fit(
            params, data, steps=6, log=lambda *_: None)
        hist[where] = [h["loss"] for h in out["history"]]
    assert all(math.isfinite(v) for v in hist["cuda"])
    assert hist["cuda"][-1] < hist["cuda"][0]
    for a, b in zip(hist["cuda"], hist["cpu"]):
        assert abs(a - b) <= 1e-3 * abs(b), (hist["cuda"], hist["cpu"])


@pytest.mark.parametrize("name,lr", [("sgd_momentum", 0.1), ("adam", 1e-2)])
def test_first_order_steps_on_card_match_cpu(name, lr):
    """6 steps of a first-order baseline on the reduced autoencoder on the
    card and on the CPU from the same weights: the same losses, and no
    kernel of ``repro_torch.kernels`` launched on the card."""
    _card()
    dims = autoencoder_dims(reduced())
    hist = {}
    for where in ("cuda", "cpu"):
        mlp = MLP(dims, device=where)
        params = mlp.init_params(torch.Generator().manual_seed(0))
        data = SyntheticAutoencoderData(dims[0], 8, 256, seed=7,
                                        device=where)
        K.reset_launches()
        out = Trainer(mlp, optimizers.get(name, mlp, lr=lr),
                      TrainConfig(seed=0), device=where).fit(
            params, data, steps=6, log=lambda *_: None)
        if where == "cuda":
            torch.cuda.synchronize()
            assert K.launches() == {k: 0 for k in K.WRAPPERS}
        hist[where] = [h["loss"] for h in out["history"]]
    assert all(math.isfinite(v) for v in hist["cuda"])
    assert hist["cuda"][-1] < hist["cuda"][0]
    for a, b in zip(hist["cuda"], hist["cpu"]):
        assert abs(a - b) <= 1e-3 * abs(b), (hist["cuda"], hist["cpu"])


# ---------------------------------------------------------------------------
# serving: the flash-decode kernels and a reduced serving run
# ---------------------------------------------------------------------------

DECODE_TOL = 1e-5
# (B, Hq, Hkv, hd, S, window, cap): reduced smollm-135m and llama3.2-1b,
# full llama3.2-1b and smollm-135m, and a window and softcap at hd 256
DECODE_SHAPES = [(3, 3, 1, 16, 40, 0, 0.0), (3, 4, 2, 16, 40, 16, 50.0),
                 (16, 32, 8, 64, 4096, 0, 0.0), (4, 9, 3, 64, 300, 0, 0.0),
                 (4, 8, 4, 256, 2048, 700, 50.0)]


def _decode_case(g, b, hq, hkv, hd, s_len):
    q = torch.randn(b, hq, hd, generator=g, device="cuda")
    k, v = (torch.randn(b, s_len, hkv, hd, generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    lengths = torch.randint(1, s_len + 1, (b,), generator=g, device="cuda",
                            dtype=torch.int32)
    lengths[0] = 1
    lengths[-1] = s_len
    return q, k, v, lengths


@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_flash_decode_on_card(shape):
    """The dense kernel reads the (B, S, Hkv, hd) cache through strides."""
    b, hq, hkv, hd, s_len, window, cap = shape
    g = _card()
    q, k, v, lengths = _decode_case(g, b, hq, hkv, hd, s_len)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    before = FD.flash_decode.launches
    got = FD.flash_decode(q, kt, vt, lengths, window=window, cap=cap)
    assert FD.flash_decode.launches == before + 1
    _close(got, FD.flash_decode_ref(q, kt, vt, lengths, window=window,
                                    cap=cap), tol=DECODE_TOL)
    # rows with no valid key mirror the reference's uniform weights
    bad = torch.zeros_like(lengths)
    _close(FD.flash_decode(q, kt, vt, bad),
           FD.flash_decode_ref(q, kt, vt, bad), tol=DECODE_TOL)


@pytest.mark.parametrize("page", [4, 8, 16])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_flash_decode_paged_on_card(shape, page):
    b, hq, hkv, hd, s_len, window, cap = shape
    g = _card()
    nb = -(-s_len // page)
    num_pages = 1 + b * nb
    q = torch.randn(b, hq, hd, generator=g, device="cuda")
    kp, vp = (torch.randn(num_pages, page, hkv, hd, generator=g,
                          device="cuda").to(torch.bfloat16) for _ in range(2))
    table = (torch.randperm(num_pages - 1, generator=g, device="cuda")
             + 1).reshape(b, nb).to(torch.int32)
    lengths = torch.randint(1, nb * page + 1, (b,), generator=g,
                            device="cuda", dtype=torch.int32)
    lengths[0] = page + 1
    # an idle row: null page 0 everywhere, length 1
    table[-1] = 0
    lengths[-1] = 1
    before = FD.flash_decode_paged.launches
    got = FD.flash_decode_paged(q, kp, vp, lengths, table, window=window,
                                cap=cap)
    assert FD.flash_decode_paged.launches == before + 1
    _close(got, FD.flash_decode_paged_ref(q, kp, vp, lengths, table,
                                          window=window, cap=cap),
           tol=DECODE_TOL)


@pytest.mark.parametrize("group", range(1, 1 + FD.MAX_GROUP))
def test_decode_kernels_every_group_size_on_card(group):
    """Every query-heads-per-KV-head instantiation G = 1..4 of both kernels
    (hd 32 and 128), with a window and a softcap."""
    g = _card()
    for hd in (32, 128):
        b, hkv, s_len, page = 3, 2, 72, 8
        q, k, v, lengths = _decode_case(g, b, group * hkv, hkv, hd, s_len)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        kw = dict(window=20, cap=30.0)
        _close(FD.flash_decode(q, kt, vt, lengths, **kw),
               FD.flash_decode_ref(q, kt, vt, lengths, **kw), tol=DECODE_TOL)
        pool_k = k.reshape(b * s_len // page, page, hkv, hd)
        pool_v = v.reshape(b * s_len // page, page, hkv, hd)
        table = torch.arange(b * s_len // page, device="cuda",
                             dtype=torch.int32).reshape(b, -1).flip(1)
        _close(FD.flash_decode_paged(q, pool_k, pool_v, lengths, table, **kw),
               FD.flash_decode_paged_ref(q, pool_k, pool_v, lengths, table,
                                         **kw), tol=DECODE_TOL)


def _shuffled_pages(g, k, v, page):
    """Pools of ``page``-key pages holding the (B, S, Hkv, hd) caches k and
    v, in shuffled physical pages (page 0 is the allocator's null page),
    and the (B, S / page) table that maps them back."""
    b, s_len, hkv, hd = k.shape
    nb = s_len // page
    perm = torch.randperm(b * nb, generator=g, device="cuda") + 1
    pools = []
    for x in (k, v):
        pool = torch.zeros(1 + b * nb, page, hkv, hd, dtype=x.dtype,
                           device="cuda")
        pool[perm] = x.reshape(b * nb, page, hkv, hd)
        pools.append(pool)
    return pools[0], pools[1], perm.reshape(b, nb).to(torch.int32)


def _route_calls(g, route, q, k, v):
    """The kernel and its plain version on one route, as functions of
    (lengths, window, cap), and the kernel's wrapper (its ``last_split``
    is the n_split the kernel was launched with)."""
    if route == "dense":
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        return (lambda n, **kw: FD.flash_decode(q, kt, vt, n, **kw),
                lambda n, **kw: FD.flash_decode_ref(q, kt, vt, n, **kw),
                FD.flash_decode)
    pk, pv, table = _shuffled_pages(g, k, v, int(route[len("paged"):]))
    return (lambda n, **kw: FD.flash_decode_paged(q, pk, pv, n, table, **kw),
            lambda n, **kw: FD.flash_decode_paged_ref(q, pk, pv, n, table,
                                                      **kw),
            FD.flash_decode_paged)


# (B, Hq, Hkv, hd, S, window, cap, lengths): shapes that reach each regime
# of decode_splits.  most-splits: one row, one KV head, S 8192; ragged:
# 8151 keys, which the chunks do not divide; empty: rows of 3 and 1 keys
# against S / MIN_CHUNK splits; window: the window and softcap at hd 256
SPLIT_CASES = {
    "most-splits": (1, 2, 1, 256, 8192, 0, 0.0, [8192]),
    "ragged": (2, 2, 1, 256, 8192, 0, 50.0, [8192, 8151]),
    "empty": (3, 4, 1, 64, 8192, 0, 0.0, [8192, 3, 1]),
    "window": (2, 8, 4, 256, 8192, 4096, 50.0, [8192, 5000]),
}


@pytest.mark.parametrize("route", ["dense", "paged8", "paged16"])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_decode_split_regimes_on_card(case, route):
    """Both kernels at shapes the split rule gives many splits, each within
    DECODE_TOL of the plain version, the rows with no valid key as well,
    and the same bits from two calls."""
    b, hq, hkv, hd, s_len, window, cap, lens = SPLIT_CASES[case]
    g = _card()
    q, k, v, _ = _decode_case(g, b, hq, hkv, hd, s_len)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kernel, plain, wrapper = _route_calls(g, route, q, k, v)
    kw = dict(window=window, cap=cap)
    got = kernel(lengths, **kw)
    # the span's most chunks: S / MIN_CHUNK, or the window's
    span = min(s_len, window) if window else s_len
    assert wrapper.last_split == span // FD.MIN_CHUNK > 1, wrapper.last_split
    if case == "empty":
        assert wrapper.last_split > 3
    _close(got, plain(lengths, **kw), tol=DECODE_TOL)
    assert torch.equal(got, kernel(lengths, **kw))
    bad = torch.zeros_like(lengths)
    _close(kernel(bad, **kw), plain(bad, **kw), tol=DECODE_TOL)


@pytest.mark.parametrize("route", ["dense", "paged8", "paged16"])
def test_decode_one_split_where_the_rows_fill_the_card(route):
    """B·Hkv of at least FILL blocks an SM: one split, no merge."""
    g = _card()
    hq, hkv, hd, s_len = 32, 8, 64, 256
    b = -(-FD.FILL * sm_count(0) // hkv)
    q, k, v, lengths = _decode_case(g, b, hq, hkv, hd, s_len)
    kernel, plain, wrapper = _route_calls(g, route, q, k, v)
    got = kernel(lengths)
    assert wrapper.last_split == 1
    _close(got, plain(lengths), tol=DECODE_TOL)
    assert torch.equal(got, kernel(lengths))


@pytest.mark.parametrize("group", range(1, 1 + FD.MAX_GROUP))
def test_decode_split_every_group_size_on_card(group):
    """G = 1..4 at a shape that splits (hd 64 and 256, a window and a
    softcap), on both routes, pages of 8 and 16."""
    g = _card()
    b, hkv, s_len, window = 2, 2, 2048, 700
    for hd in (64, 256):
        q, k, v, lengths = _decode_case(g, b, group * hkv, hkv, hd, s_len)
        for route in ("dense", "paged8", "paged16"):
            kernel, plain, wrapper = _route_calls(g, route, q, k, v)
            for window_, cap in ((0, 0.0), (window, 30.0)):
                kw = dict(window=window_, cap=cap)
                got = kernel(lengths, **kw)
                assert wrapper.last_split > 1
                _close(got, plain(lengths, **kw), tol=DECODE_TOL)


@pytest.mark.parametrize("route", ["dense", "paged8"])
def test_decode_split_on_two_streams_at_once_on_card(route):
    """Calls that split, three in a row on each of two streams with no sync
    between the streams, each within DECODE_TOL of the plain version: a
    stream's calls share its workspace in order, the streams do not."""
    g = _card()
    b, hq, hkv, hd, s_len = 2, 8, 4, 256, 8192
    calls = []
    for _ in range(2):
        q, k, v, lengths = _decode_case(g, b, hq, hkv, hd, s_len)
        calls.append((_route_calls(g, route, q, k, v), lengths))
    kw = dict(window=4096, cap=50.0)
    torch.cuda.synchronize()
    outs = []
    for (kernel, _, _), lengths in calls:
        with torch.cuda.stream(torch.cuda.Stream()):
            outs.append([kernel(lengths, **kw) for _ in range(3)])
    torch.cuda.synchronize()
    assert calls[0][0][2].last_split > 1
    for ((_, plain, _), lengths), got in zip(calls, outs):
        want = plain(lengths, **kw)
        for x in got:
            _close(x, want, tol=DECODE_TOL)


def test_decode_wrappers_raise_on_bad_operands():
    g = _card()
    q, k, v, lengths = _decode_case(g, 2, 4, 2, 16, 32)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    pool = k.reshape(8, 8, 2, 16)
    table = torch.arange(8, device="cuda", dtype=torch.int32).reshape(2, 4)
    bad_calls = [
        lambda: FD.flash_decode(q.double(), kt, vt, lengths),
        lambda: FD.flash_decode(q, kt.float(), vt.float(), lengths),
        lambda: FD.flash_decode(q, kt, vt, lengths.long()),
        lambda: FD.flash_decode(q, kt.cpu(), vt.cpu(), lengths),
        lambda: FD.flash_decode(q[:, :3], kt, vt, lengths),   # group 1.5
        lambda: FD.flash_decode(q.repeat(1, 3, 1), kt, vt, lengths),  # 6
        lambda: FD.flash_decode_paged(q, pool, pool, lengths, table.cpu()),
        lambda: FD.flash_decode_paged(q, pool, pool, lengths, table.long()),
        lambda: FD.flash_decode_paged(q, pool.float(), pool.float(), lengths,
                                      table),
        lambda: FD.flash_decode_paged(q, pool.transpose(0, 1),
                                      pool.transpose(0, 1), lengths, table),
    ]
    before = (FD.flash_decode.launches, FD.flash_decode_paged.launches)
    for call in bad_calls:
        with pytest.raises((TypeError, ValueError)):
            call()
    assert (FD.flash_decode.launches, FD.flash_decode_paged.launches) == before


# (arch, requests as (uid, prompt length, max_new)): gemma2-2b's prompts
# and positions pass its reduced window of 16
SERVE_SPECS = [("llama3.2-1b", [(0, 3, 4), (1, 20, 9), (2, 4, 2), (3, 8, 5),
                                (4, 3, 7)]),
               ("gemma2-2b", [(0, 18, 4), (1, 6, 14), (2, 20, 3), (3, 9, 9),
                              (4, 17, 6)])]


@pytest.mark.parametrize("route", ["paged", "gather"])
@pytest.mark.parametrize("arch,spec", SERVE_SPECS,
                         ids=[arch for arch, _ in SERVE_SPECS])
def test_reduced_serving_run_on_card(arch, spec, route):
    """Reduced ``arch`` served on the card through a small page pool
    (preemptions happen): every decode step launches its route's kernel
    once per layer, every prefill call (replays included) flash_attention
    once per layer, and nothing else launches; the tokens equal the CPU
    run's from the same weights."""
    _card()
    cfg = get_reduced_config(arch)
    cpu_lm = LM(cfg, device="cpu")
    params = cpu_lm.init_params(torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cuda", "cpu"):
        lm = LM(cfg, device=dev)
        p = tree_map(lambda t: t.to(dev), params)
        reqs = [Request(uid=u, prompt=[(7 * u + j) % cfg.vocab_size
                                       for j in range(tp)], max_new=mn)
                for u, tp, mn in spec]
        eng = Engine(lm, p, batch_slots=3, max_len=32, page_size=4,
                     num_pages=9, decode_route=route)
        K.reset_launches()
        rep = eng.run(reqs, max_steps=500)
        launches = K.launches()
        assert all(r.done for r in reqs) and rep.decode_steps > 0
        if dev == "cuda":
            want = {name: 0 for name in K.WRAPPERS}
            want["flash_decode_paged" if route == "paged"
                 else "flash_decode"] = cfg.n_layers * rep.decode_steps
            want["flash_attention"] = cfg.n_layers * len(rep.prefill_ms)
            assert launches == want, (launches, rep.decode_steps)
            assert rep.preemptions > 0
        out[dev] = [r.out for r in reqs]
    assert out["cuda"] == out["cpu"]


# ---------------------------------------------------------------------------
# prefill: the flash-attention kernel
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, hd, Tq, Tk, causal, window, cap): every head dim, G = 1..4,
# ragged lengths, Tk < Tq with a window (rows with no valid key), Tk > Tq;
# then every head dim at every G on lengths no 64-key tile divides, with
# the causal diagonal crossing key and query tiles, a window whose edge
# falls inside a key tile (20) or spans one (70), and a softcap
ATTN_SHAPES = [(2, 4, 2, 16, 21, 21, True, 16, 50.0),
               (1, 3, 3, 32, 70, 70, False, 0, 0.0),
               (2, 9, 3, 64, 130, 130, True, 0, 0.0),
               (1, 8, 2, 128, 77, 77, True, 20, 30.0),
               (1, 8, 4, 256, 300, 300, True, 64, 50.0),
               (1, 8, 4, 256, 257, 257, False, 0, 50.0),
               (2, 4, 1, 64, 90, 30, True, 8, 0.0),
               (2, 4, 2, 16, 25, 60, True, 0, 20.0)]
ATTN_SHAPES += [(1, 2 * group, 2, hd, 197, 197, True, window, cap)
                for hd in FA.HEAD_DIMS for group in (1, 2, 3, 4)
                for window, cap in ((0, 0.0), (20, 50.0), (70, 0.0))]
ATTN_SHAPES += [(1, 2 * group, 2, hd, tq, tk, causal, window, 30.0)
                for group, hd in zip((1, 2, 3, 4), (32, 128, 256, 64))
                for tq, tk, causal, window in ((150, 70, True, 30),
                                               (45, 130, False, 0),
                                               (45, 130, True, 0))]


def _attn_case(g, b, hq, hkv, hd, tq, tk):
    """q, k, v as the LM passes them: (B, T, H, hd) projections viewed as
    (B, H, T, hd)."""
    q = torch.randn(b, tq, hq, hd, generator=g, device="cuda")
    k, v = (torch.randn(b, tk, hkv, hd, generator=g, device="cuda")
            for _ in range(2))
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_flash_attention_on_card(shape):
    b, hq, hkv, hd, tq, tk, causal, window, cap = shape
    g = _card()
    q, k, v = _attn_case(g, b, hq, hkv, hd, tq, tk)
    kw = dict(causal=causal, window=window, cap=cap)
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, **kw)
    assert FA.flash_attention.launches == before + 1
    assert got.shape == (b, hq, tq, hd) and got.transpose(1, 2).is_contiguous()
    _close(got, FA.flash_attention_ref(q, k, v, **kw), tol=1e-5)
    # contiguous (B, H, T, hd) operands give the same result
    _close(FA.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              **kw), got, tol=1e-6)


@pytest.mark.parametrize("hd,tq,tk", [(64, 1024, 1024), (256, 333, 333),
                                      (256, 150, 70)])
def test_flash_attention_repeats_bitwise(hd, tq, tk):
    """Two calls on the same inputs give the same bits: every block sums
    its keys in one fixed order."""
    g = _card()
    q, k, v = _attn_case(g, 1, 8, 2, hd, tq, tk)
    kw = dict(causal=True, window=40 if tk < tq else 0, cap=50.0)
    assert torch.equal(FA.flash_attention(q, k, v, **kw),
                       FA.flash_attention(q, k, v, **kw))


def test_flash_attention_blocks_per_sm():
    """Every instantiation fits an SM: one block at hd 128 and 256 (shared
    memory), at least two at hd 64 and below."""
    _card()
    got = {hd: FA.blocks_per_sm(hd) for hd in FA.HEAD_DIMS}
    assert got[256] == got[128] == 1, got
    assert min(got[hd] for hd in (16, 32, 64)) >= 2, got


def test_flash_attention_wrapper_raises_on_bad_operands():
    g = _card()
    q, k, v = _attn_case(g, 1, 4, 2, 64, 40, 40)
    bad_calls = [
        lambda: FA.flash_attention(q.double(), k, v),
        lambda: FA.flash_attention(q, k.to(torch.bfloat16), v),
        lambda: FA.flash_attention(q, k.cpu(), v.cpu()),
        lambda: FA.flash_attention(q[:, :3], k, v),              # group 1.5
        lambda: FA.flash_attention(q[..., :48], k[..., :48], v[..., :48]),
        lambda: FA.flash_attention(q[..., ::2], k[..., ::2], v[..., ::2]),
        lambda: FA.flash_attention(q, k, v.contiguous()),        # strides
        lambda: FA.flash_attention(q, k[:, :, :0], v[:, :, :0]),  # Tk = 0
        lambda: FA.flash_attention(q, k, v, window=-1),
    ]
    before = FA.flash_attention.launches
    for call in bad_calls:
        with pytest.raises((TypeError, ValueError)):
            call()
    assert FA.flash_attention.launches == before


# ---------------------------------------------------------------------------
# whisper's K-FAC training: patch_factor, the batched factor_update, and a
# reduced run on the card against the same run on the CPU
# ---------------------------------------------------------------------------

PATCH_CASES = [  # b, t, c, k, stride, padding, bias
    (2, 21, 13, 3, 1, "SAME", True), (1, 131, 8, 4, 1, "VALID", False),
    (2, 31, 8, 3, 2, "SAME", True), (2, 8, 8, 9, 1, "SAME", True),
    (2, 2, 8, 3, 1, "VALID", True), (3, 100, 136, 3, 2, "SAME", True),
    (8, 3000, 80, 3, 1, "SAME", True),      # whisper-small conv1
    (8, 3000, 768, 3, 2, "SAME", True)]     # whisper-small conv2


@pytest.mark.parametrize("case", PATCH_CASES)
def test_patch_factor_on_card(case):
    """Ragged cases and whisper-small's two conv shapes, at beta = 0 and
    0.95, held to the scale of alpha * P̂ᵀP̂ alone."""
    from repro_torch.kernels.patch_factor import (patch_factor_update,
                                                  patch_factor_update_ref)
    b, t, c, k, s, pad, bias = case
    g = _card()
    x = torch.randn(b, t, c, generator=g, device="cuda")
    d = k * c + int(bias)
    old = _spd(g, d)
    kw = dict(taps=k, stride=s, padding=pad, has_bias=bias)
    for e in (0.0, 0.95):
        eps = torch.tensor(e, device="cuda")
        a = (1 - eps) / 512
        before = patch_factor_update.launches
        got = patch_factor_update(x, old, alpha=a, beta=eps, **kw)
        assert patch_factor_update.launches == before + 1
        prod = patch_factor_update_ref(x, old, alpha=a, beta=0.0, **kw)
        _close(got, patch_factor_update_ref(x, old, alpha=a, beta=eps, **kw),
               scale=max(prod.abs().max().item(), 1e-30))


@pytest.mark.parametrize("case", PATCH_CASES + [
    (2, 40, 16, 4, 1, "SAME", True),       # d = 65 = 64 + 1
    (1, 50, 32, 4, 2, "SAME", True)])      # d = 129 = 128 + 1
def test_patch_factor_nonsymmetric_c_on_card(case):
    """One triangle plus a mirror: each mirrored entry takes its own entry
    of a C that is not symmetric; d one more than a tile multiple folds the
    bias feature into the last tile column."""
    from repro_torch.kernels.patch_factor import (patch_factor_update,
                                                  patch_factor_update_ref)
    b, t, c, k, s, pad, bias = case
    g = _card()
    x = torch.randn(b, t, c, generator=g, device="cuda")
    d = k * c + int(bias)
    old = torch.randn(d, d, generator=g, device="cuda")
    kw = dict(taps=k, stride=s, padding=pad, has_bias=bias)
    # alpha = 1 - eps, so that a mirrored entry read from the wrong side of
    # C (an error of order |C|) stands far above the tolerance
    eps = torch.tensor(0.95, device="cuda")
    a = 1 - eps
    prod = patch_factor_update_ref(x, old, alpha=a, beta=0.0, **kw)
    _close(patch_factor_update(x, old, alpha=a, beta=eps, **kw),
           patch_factor_update_ref(x, old, alpha=a, beta=eps, **kw),
           scale=max(prod.abs().max().item(), 1e-30))


@pytest.mark.parametrize("s,n,d", [(12, 12000, 768), (12, 512, 3072),
                                   (2, 64, 48), (3, 100, 33)])
def test_factor_update_batched_on_card(s, n, d):
    """The stacked layers' (S, N, d) records in one launch; symmetric
    slices of C give bitwise symmetric slices, and a second call the same
    bits."""
    g = _card()
    x = torch.tanh(torch.randn(s, n, d, generator=g, device="cuda"))
    c = torch.stack([_spd(g, d) for _ in range(s)])
    c = 0.5 * (c + c.mT)   # bitwise symmetric
    eps = torch.tensor(0.75, device="cuda")
    a = (1 - eps) / n
    before = factor_update.launches
    got = factor_update(x, c, alpha=a, beta=eps)
    assert factor_update.launches == before + 1
    prod = factor_update_ref(x, c, alpha=a, beta=0.0)
    _close(got, factor_update_ref(x, c, alpha=a, beta=eps),
           scale=prod.abs().max().item())
    assert torch.equal(got, got.mT)
    assert torch.equal(got, factor_update(x, c, alpha=a, beta=eps))


def test_reduced_whisper_training_cuda_vs_cpu():
    """Four K-FAC steps of reduced whisper through the launcher's pieces on
    the card and on the CPU, same weights and noise: losses within rtol
    1e-3, and every kernel of the path launched (patch_factor twice a
    step)."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.train import _ArchData
    _card()
    cfg = get_reduced_config("whisper-small")
    kcfg = KFACConfig(lambda_init=10.0, t3=5)
    hist = {}
    for where in ("cuda", "cpu"):
        lm = LM(cfg, device=where)
        params = tree_map(lambda p: p.to(where), LM(cfg, device="cpu").
                          init_params(torch.Generator().manual_seed(0)))
        data = _ArchData(cfg, SyntheticLMData(cfg.vocab_size, 64, 8,
                                              device=where))
        noise = lambda step, shape, where=where: torch.rand(
            shape, generator=torch.Generator().manual_seed(step)).to(where)
        tr = Trainer(lm, kfac(lm, kcfg, device=where), TrainConfig(),
                     noise=noise, device=where)
        K.reset_launches()
        hist[where] = [h["loss"] for h in tr.fit(
            params, data, steps=4, log=lambda *_: None)["history"]]
        if where == "cuda":
            n = K.launches()
            assert n["patch_factor"] == 2 * 4, n
            for name in ("factor_update", "precondition", "ns_step",
                         "matmul"):
                assert n[name] > 0, (name, n)
    for a, b in zip(hist["cuda"], hist["cpu"]):
        assert a == pytest.approx(b, rel=1e-3), hist


# ---------------------------------------------------------------------------
# checkpoints and bundles written from the card
# ---------------------------------------------------------------------------

def test_full_width_blkdiag_resume_launches(tmp_path):
    """Full-width blkdiag: 7 steps with a checkpoint at step 7, then a new
    optimizer and trainer resume there for steps 7 and 8, both warmup
    refreshes (re-armed at the restore): exact launches, finite losses."""
    from repro_torch.training.checkpoint import Checkpointer
    _card()
    mlp = MLP(DIMS, device="cuda")
    params = mlp.init_params(torch.Generator().manual_seed(0))
    data = SyntheticAutoencoderData(DIMS[0], 8, 8192, seed=7, device="cuda")
    cfg = KFACConfig(inverse_method="ns", lambda_init=3.0, t3=5, eta=1e-5)
    tcfg = TrainConfig(seed=0, checkpoint_every=7)
    ck = Checkpointer(str(tmp_path))
    Trainer(mlp, kfac(mlp, cfg, family="bernoulli", device="cuda"), tcfg,
            device="cuda", checkpointer=ck).fit(params, data, steps=7,
                                                log=lambda *_: None)
    assert ck.all_steps() == [7]
    logs = []
    K.reset_launches()
    out = Trainer(mlp, kfac(mlp, cfg, family="bernoulli", device="cuda"),
                  tcfg, device="cuda", checkpointer=Checkpointer(
                      str(tmp_path))).fit(params, data, steps=9,
                                          log=logs.append)
    assert "[trainer] restored checkpoint at step 7" in logs
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    ns = 2 * 16 * 12
    assert K.launches() == {"factor_update": 32, "precondition": 16,
                            "ns_step": ns, "matmul": 2 * (16 + ns),
                            "matmul_rescale": 0, "rotate_rescale": 0,
                            "axpy_momentum": 0, "precond_momentum": 0,
                            "flash_decode": 0, "flash_decode_paged": 0,
                            "flash_attention": 0, "patch_factor": 0}


def _reduced_run(inv_mode, tmp_path, **tkw):
    from repro_torch.training.checkpoint import Checkpointer
    small = autoencoder_dims(reduced())
    mlp = MLP(small, device="cuda")
    params = mlp.init_params(torch.Generator().manual_seed(0))
    data = SyntheticAutoencoderData(small[0], 8, 256, seed=7, device="cuda")
    opt = kfac(mlp, KFACConfig(inv_mode=inv_mode, lambda_init=3.0, t3=5,
                               eta=1e-5), family="bernoulli", device="cuda")
    ck = Checkpointer(str(tmp_path))
    out = Trainer(mlp, opt, TrainConfig(seed=0, checkpoint_every=3, **tkw),
                  device="cuda", checkpointer=ck).fit(
        params, data, steps=3, log=lambda *_: None)
    return mlp, params, data, opt, ck, out


@pytest.mark.parametrize("inv_mode", ["blkdiag", "tridiag"])
def test_card_checkpoint_restores_on_cpu_bitwise(inv_mode, tmp_path):
    """A checkpoint written from the card restores into a CPU template
    (and with ``device="cpu"`` from a card template) bit for bit."""
    from repro_torch.training.checkpoint import Checkpointer
    from repro_torch.utils.tree import flatten_with_keys, unflatten_with_keys
    _card()
    mlp, params, data, opt, ck, out = _reduced_run(inv_mode, tmp_path)
    saved = flatten_with_keys({"params": out["params"],
                               "state": out["state"]})
    template = {"params": params, "state": opt.init(params, data.batch(0))}
    cpu = unflatten_with_keys(template, flatten_with_keys(template),
                              lambda _, t: t.cpu())
    for tmpl, kw in ((cpu, {}), (template, {"device": "cpu"})):
        step, got = Checkpointer(str(tmp_path)).restore(tmpl, **kw)
        assert step == 3
        flat = flatten_with_keys(got)
        assert set(flat) <= set(saved)
        for k, v in flat.items():
            assert v.device.type == "cpu"
            assert v.dtype == saved[k].dtype
            assert torch.equal(v, saved[k].cpu()), k
        if inv_mode == "tridiag":
            assert got["state"].inv["__tri__"] is None


def test_eigen_bundle_from_the_card_is_the_state(tmp_path):
    """The eigen path's bundle at its checkpoint step holds the state's
    qa / qg / s / damp bit for bit, loaded on the card."""
    from repro_torch.curvature import load_bundle
    _card()
    _, _, _, _, ck, out = _reduced_run("eigen", tmp_path, curvature_every=3)
    bundle = load_bundle(ck.bundle_path(3), device="cuda")
    assert bundle.step == 3
    for name, eig in out["state"].inv.items():
        for k in ("qa", "qg", "s", "damp"):
            assert torch.equal(bundle.eigen[name][k], eig[k]), (name, k)


# ---------------------------------------------------------------------------
# KFC convolutions and the backward-pass fused statistics
# ---------------------------------------------------------------------------

# one full-width conv classifier step's factor sides at N = 512 images:
# the im2col rows of conv0, conv1 and conv2, each layer's G side, the head
CONV_SIDES = [(524288, 28), (524288, 32), (131072, 289), (131072, 32),
              (32768, 289), (32768, 64), (512, 65), (512, 10)]


@pytest.mark.parametrize("n,d", CONV_SIDES)
def test_factor_update_conv_shapes_on_card(n, d):
    """Deep K over an output of one or a few tiles, at beta = 0 and 0.95,
    and the fused contraction's alpha = 1, beta = 0 into a zero."""
    g = _card()
    x = torch.tanh(torch.randn(n, d, generator=g, device="cuda"))
    c = _spd(g, d)
    for e in (0.0, 0.95):
        eps = torch.tensor(e, device="cuda")
        _factor_close(x, c, (1 - eps) / n, eps)
    _factor_close(x, torch.zeros(d, d, device="cuda"), 1.0, 0.0)


def _stats_pass(model, inv_mode, fused):
    """One statistics pass from the initial state on the card: the
    full-width conv classifier at 64 images or the full-width autoencoder
    at 1024 rows; the factors and the launch counts."""
    from repro_torch.configs.conv_classifier import CONFIG as CONV
    from repro_torch.data.pipeline import SyntheticImageData
    from repro_torch.models.convnet import ConvNet
    from repro_torch.optimizers.kfac import KFACEngine
    cfg = KFACConfig(inv_mode=inv_mode, fused_stats=fused)
    if model == "conv":
        net = ConvNet(CONV, device="cuda")
        family = "categorical"
        batch = SyntheticImageData(CONV.image_size, CONV.channels,
                                   CONV.n_classes, 64, seed=7,
                                   device="cuda").batch(0)
    else:
        net = MLP(DIMS, device="cuda")
        family = "bernoulli"
        batch = SyntheticAutoencoderData(DIMS[0], 8, 1024, seed=7,
                                         device="cuda").batch(0)
    params = net.init_params(torch.Generator().manual_seed(0))
    eng = KFACEngine(net, cfg, family=family, device="cuda")
    assert eng.fused_names == (set(net.metas) if fused else set())
    state = eng.init(params, batch)
    K.reset_launches()
    state, _, _ = eng.stats_grads(
        state, params, batch, lambda shape: torch.rand(
            shape, generator=torch.Generator().manual_seed(1)).cuda())
    torch.cuda.synchronize()
    return state.factors, K.launches(), len(net.metas)


@pytest.mark.parametrize("inv_mode", ["blkdiag", "eigen"])
@pytest.mark.parametrize("model", ["conv", "mlp"])
def test_fused_stats_pass_matches_two_pass_on_card(model, inv_mode):
    """The fused statistics pass against the two-pass one on the card:
    every factor within 1e-5 of its scale (the same kernel sums the same
    rows), and the same launches: one factor_update a factor side."""
    _card()
    two, n_two, layers = _stats_pass(model, inv_mode, False)
    one, n_one, _ = _stats_pass(model, inv_mode, True)
    assert n_one == n_two == dict({k: 0 for k in K.WRAPPERS},
                                  factor_update=2 * layers)
    for name in two:
        for side in ("a", "g"):
            _close(one[name][side], two[name][side], tol=1e-5)


def test_apply_gprobe_on_card():
    """The fused G probe on CUDA tensors: the probe's gradient, through
    the factor_update kernel, against Σ cot cotᵀ of the raw cotangent."""
    from repro_torch.core import fused as FU
    from repro_torch.models.conv import conv_meta
    g = _card()
    s0 = torch.randn(64, 1024, 32, generator=g, device="cuda")
    w = torch.randn(32, 10, generator=g, device="cuda")
    loss = lambda t: torch.tanh(t @ w).pow(2).mean()
    zero = torch.zeros_like(s0, requires_grad=True)
    (cot,) = torch.autograd.grad(loss(s0 + zero), [zero])
    meta = conv_meta("c", ("c",), spatial=(3, 3), stride=(1, 1), c_in=3,
                     d_out=32)
    probe = FU.gg_probe(meta, "cuda")
    before = K.launches()["factor_update"]
    out = FU.apply_gprobe(s0, probe["gg"], FU.g_contract(meta))
    assert out is not s0 and torch.equal(out, s0)
    (gg,) = torch.autograd.grad(loss(out), [probe["gg"]])
    assert K.launches()["factor_update"] == before + 1
    c2 = cot.reshape(-1, 32)
    _close(gg, c2.T @ c2)


def test_patch_factor_fused_contraction_on_card():
    """A fused 1-D conv's A contraction (patch_factor at alpha = 1, beta =
    0 into a zero) against its plain version."""
    from repro_torch.core import fused as FU
    from repro_torch.models.conv import conv_meta
    g = _card()
    x = torch.randn(4, 300, 80, generator=g, device="cuda")
    meta = conv_meta("c", ("c",), spatial=(3,), stride=(1,), c_in=80,
                     d_out=64, padding="SAME")
    before = K.launches()["patch_factor"]
    got = FU.conv_a_contract(meta)(x)
    assert K.launches()["patch_factor"] == before + 1
    _close(got, FU.conv_a_contract(meta)(x.cpu()).cuda())


@pytest.mark.parametrize("path", ["blkdiag", "blkdiag_fs", "eigen_fs"])
def test_conv_steps_on_card_match_cpu(path):
    """6 K-FAC steps of the reduced conv classifier on the card and on the
    CPU from the same weights and uniforms: losses within rtol 1e-3
    (``chip_smoke.py``'s "conv" phase)."""
    from repro_torch.configs.conv_classifier import reduced as conv_reduced
    from repro_torch.data.pipeline import SyntheticImageData
    from repro_torch.models.convnet import ConvNet
    _card()
    cfg = conv_reduced()
    kw = dict(inv_mode=path.split("_")[0], lambda_init=3.0, t3=5, eta=1e-5,
              fused_stats=path.endswith("_fs"))
    hist = {}
    for where in ("cuda", "cpu"):
        net = ConvNet(cfg, device=where)
        params = net.init_params(torch.Generator().manual_seed(0))
        data = SyntheticImageData(cfg.image_size, cfg.channels,
                                  cfg.n_classes, 128, seed=7, device=where)
        noise = lambda step, shape, where=where: torch.rand(
            shape, generator=torch.Generator().manual_seed(step)).to(where)
        out = Trainer(net, kfac(net, KFACConfig(**kw), family="categorical",
                                device=where),
                      TrainConfig(seed=0), noise=noise, device=where).fit(
            params, data, steps=6, log=lambda *_: None)
        hist[where] = [h["loss"] for h in out["history"]]
    assert all(math.isfinite(v) for v in hist["cuda"])
    assert hist["cuda"][-1] < hist["cuda"][0]
    for a, b in zip(hist["cuda"], hist["cpu"]):
        assert abs(a - b) <= 1e-3 * abs(b), (hist["cuda"], hist["cpu"])
