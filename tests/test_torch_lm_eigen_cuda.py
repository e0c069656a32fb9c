"""The LM's eigen mode, fused fixed-lr chain and ``fused_stats`` on the
card against the same code on the CPU (the wrappers' plain versions): the
batched ``rotate_rescale`` and update chain, the block eigen apply, and
reduced LMs' ``Trainer.fit`` on each path.  No JAX: the machine with the
card has none.

Every test is marked ``cuda`` and skips, inside its body, when
``torch.cuda.is_available()`` is false.  On the card (``--noconftest``:
``tests/conftest.py`` imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_lm_eigen_cuda.py

Tolerance: max|card - cpu| <= 1e-4 * max|cpu| (fp32 sums in another
order), ΣD² to relative 1e-4, as ``tests/test_torch_cuda.py`` holds the
kernels; the losses of 4 reduced steps within rtol 1e-3; TF32 is off.
"""
import math

import pytest
import torch

from repro_torch import kernels as K
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import KFACConfig, TrainConfig
from repro_torch.core import blocks as B
from repro_torch.core import inverse
from repro_torch.core.tags import LayerMeta
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.kernels.rotate_rescale import (rotate_rescale,
                                                rotate_rescale_ref)
from repro_torch.kernels.update_chain import (axpy_momentum,
                                              axpy_momentum_ref,
                                              precond_momentum,
                                              precond_momentum_ref)
from repro_torch.launch.train import _ArchData
from repro_torch.models.lm import LM
from repro_torch.optimizers.kfac import kfac
from repro_torch.training.trainer import Trainer
from repro_torch.utils.tree import tree_map

pytestmark = pytest.mark.cuda

S = 3
# (a, g): ragged widths, one that tiles, and the reduced decoders' shapes
SHAPES = [(97, 130), (64, 64), (48, 96), (200, 33)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _close(got, want, tol=1e-4):
    torch.cuda.synchronize()
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert math.isfinite(err) and err <= tol * scale, (err, scale)


def _orth(gen, s, d):
    return torch.linalg.qr(torch.randn(s, d, d, generator=gen))[0]


@pytest.mark.parametrize("a,g", SHAPES)
def test_batched_rotate_rescale_on_card(a, g):
    """One call over S stacked layers: four launches (three matmul, one
    matmul_rescale), each over the whole batch; λ as a device scalar."""
    _card()
    gen = torch.Generator().manual_seed(a * g)
    qa, qg = _orth(gen, S, a), _orth(gen, S, g)
    v = torch.randn(S, a, g, generator=gen)
    s = torch.rand(S, a, g, generator=gen) + 0.05
    dev = [t.cuda() for t in (qa, v, qg, s)]
    K.reset_launches()
    u = rotate_rescale(*dev, torch.tensor(1e-12, device="cuda"))
    launches = K.launches()
    _close(u, rotate_rescale_ref(qa, v, qg, s, 1e-12))
    assert (launches["rotate_rescale"], launches["matmul"],
            launches["matmul_rescale"]) == (1, 3, 1)
    assert torch.equal(u, rotate_rescale(*dev, 1e-12))


@pytest.mark.parametrize("a,g", SHAPES)
def test_batched_chain_on_card(a, g):
    """The batched chain: D normwise and ΣD² (over every layer) to
    relative 1e-4, two launches, two calls bitwise equal; axpy_momentum
    alone also with one a_inv broadcast over the batch."""
    _card()
    gen = torch.Generator().manual_seed(a + g)
    a_inv = torch.randn(S, a, a, generator=gen) / a
    g_inv = torch.randn(S, g, g, generator=gen) / g
    v, mom = torch.randn(S, a, g, generator=gen), torch.randn(S, a, g,
                                                              generator=gen)
    al, mu = torch.tensor(-0.05), torch.tensor(0.9)
    dev = lambda *ts: [t.cuda() for t in ts]
    K.reset_launches()
    d, sq = precond_momentum(*dev(a_inv, v, g_inv, mom), alpha=al.cuda(),
                             mu=mu.cuda())
    launches = K.launches()
    d_ref, sq_ref = precond_momentum_ref(a_inv, v, g_inv, mom, alpha=al,
                                         mu=mu)
    _close(d, d_ref)
    assert abs(sq.item() - sq_ref.item()) <= 1e-4 * sq_ref.item()
    assert (launches["precond_momentum"], launches["axpy_momentum"],
            launches["matmul"]) == (1, 1, 1)
    d2, sq2 = precond_momentum(*dev(a_inv, v, g_inv, mom), alpha=al.cuda(),
                               mu=mu.cuda())
    assert torch.equal(d, d2) and torch.equal(sq, sq2)
    t = torch.randn(S, a, g, generator=gen)
    d, sq = axpy_momentum(*dev(a_inv[:1], t, mom), 0.3, 0.0)
    d_ref, sq_ref = axpy_momentum_ref(a_inv[:1], t, mom, 0.3, 0.0)
    _close(d, d_ref)
    assert abs(sq.item() - sq_ref.item()) <= 1e-4 * sq_ref.item()


@pytest.mark.parametrize("layout", [("full", 1, "block", 4, 200, 384),
                                    ("block", 3, "full", 1, 387, 200),
                                    ("block", 3, "block", 4, 387, 384)])
def test_block_eigen_apply_on_card(layout):
    """``BlockDiagKronecker``'s eigen apply from one eigen state (computed
    on the CPU, carried to the card, so both rotate with one basis): four
    matmul launches, the blocks in their batch; and its fused chain, the
    base class's composition over that apply."""
    _card()
    a_kind, a_nb, g_kind, g_nb, a, gd = layout
    meta = LayerMeta(name="l", param_path=("w",), d_in=a, d_out=gd,
                     n_stack=S, a_kind=a_kind, g_kind=g_kind, a_blocks=a_nb,
                     g_blocks=g_nb)
    gen = torch.Generator().manual_seed(a)
    blk = B.BlockDiagKronecker(meta, KFACConfig(inv_mode="eigen"), "cpu")
    fac = blk.init_factors()
    x = torch.tanh(torch.randn(S, 512, a, generator=gen))
    cot = torch.randn(S, 512, gd, generator=gen) / 512
    fac = blk.update_factors(fac, {"a": x}, cot, 512, torch.tensor(0.0))
    eig = blk.eigen_state(fac, torch.tensor(0.01))
    v, mom = torch.randn(S, a, gd, generator=gen), torch.randn(
        S, a, gd, generator=gen)
    want = blk.precondition_eigen(eig, v)
    cblk = B.BlockDiagKronecker(meta, KFACConfig(inv_mode="eigen"), "cuda")
    ceig = {k: t.cuda() for k, t in eig.items()}
    K.reset_launches()
    _close(cblk.precondition_eigen(ceig, v.cuda()), want)
    assert K.launches()["matmul"] == 4
    d, sq = cblk.precond_momentum(ceig, v.cuda(), mom.cuda(), -0.05, 0.9,
                                  eigen=True)
    d_ref, sq_ref = blk.precond_momentum(eig, v, mom, -0.05, 0.9,
                                         eigen=True)
    _close(d, d_ref)
    assert abs(sq.item() - sq_ref.item()) <= 1e-4 * sq_ref.item()
    _close(inverse.apply_eigen(meta, ceig, v.cuda()), want)


PATHS = {"smollm_eigen": ("smollm-135m", 8192, dict(inv_mode="eigen")),
         "smollm_chain": ("smollm-135m", 8192,
                          dict(use_rescale=False, fixed_momentum=0.9,
                               kl_clip=1e-3)),
         "gemma2_64_eigen": ("gemma2-2b", 64, dict(inv_mode="eigen")),
         "gemma2_64_eigen_chain": ("gemma2-2b", 64,
                                   dict(inv_mode="eigen", use_rescale=False)),
         "whisper_eigen_fs": ("whisper-small", 8192,
                              dict(inv_mode="eigen", fused_stats=True))}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_reduced_lm_paths_on_card(path):
    """Reduced LMs, 4 K-FAC steps of the launcher's setup on each new path
    on the card and on the CPU from the same weights and uniforms: losses
    within rtol 1e-3; the eigen paths launch rotate_rescale (full/full
    layers) and no precondition, the chain precond_momentum, fused_stats
    patch_factor in the passes."""
    _card()
    arch, mfd, kw = PATHS[path]
    cfg = get_reduced_config(arch)
    kcfg = KFACConfig(lambda_init=10.0, t3=5, max_factor_dim=mfd, **kw)
    params = LM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    hist = {}
    for dev in ("cuda", "cpu"):
        lm = LM(cfg, kcfg, device=dev)
        data = _ArchData(cfg, SyntheticLMData(cfg.vocab_size, 64, 8,
                                              device=dev))
        noise = lambda step, shape, dev=dev: torch.rand(
            shape, generator=torch.Generator().manual_seed(step)).to(dev)
        K.reset_launches()
        tr = Trainer(lm, kfac(lm, kcfg, device=dev),
                     TrainConfig(seed=0, log_every=10 ** 9), noise=noise,
                     device=dev)
        hist[dev] = [h["loss"] for h in tr.fit(
            tree_map(lambda p: p.to(dev), params), data, steps=4,
            log=lambda *_: None)["history"]]
        if dev == "cuda":
            launches = K.launches()
    for got, want in zip(hist["cuda"], hist["cpu"]):
        assert got == pytest.approx(want, rel=1e-3)
    if kw.get("inv_mode") == "eigen":
        assert launches["precondition"] == 0 and launches["ns_step"] == 0
        assert launches["rotate_rescale"] > 0
    if not kw.get("use_rescale", True) and "inv_mode" not in kw:
        assert launches["precond_momentum"] == launches["axpy_momentum"] > 0
    if kw.get("fused_stats"):
        assert launches["patch_factor"] == 2 * 4     # two stems a step


@pytest.mark.parametrize("d", [30, 192, 500, 576])
def test_eigh_bases_are_orthonormal_on_card(d):
    """``inverse.eigh`` of a rank-deficient float32 factor stack (512 rows,
    as an LM's statistics give) on the card: bases orthonormal and
    eigenvalues within 1e-5 of the float64 ones (relative to the
    largest), at widths on both sides of the 32-512 range PyTorch sends
    to cuSOLVER's Jacobi solver (decomposed in float64 there)."""
    _card()
    gen = torch.Generator().manual_seed(d)
    x = torch.randn(S, 512, d, generator=gen) * torch.logspace(0, -3, d)
    f = x.transpose(1, 2) @ x / 512
    w, q = inverse.eigh(f.cuda())
    eye = torch.eye(d, device="cuda")
    assert (q.transpose(-1, -2) @ q - eye).abs().max().item() <= 1e-5
    w64 = torch.linalg.eigvalsh(f.double())
    err = (w.cpu().double() - w64).abs().amax(-1) / w64.abs().amax(-1)
    assert err.max().item() <= 1e-5
