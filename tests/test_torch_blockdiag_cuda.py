"""``BlockDiagKronecker`` on the card against the same block on the CPU
(the wrappers' plain versions), and reduced gemma2-2b's ``Trainer.fit``
with block sides on the card against the CPU.  No JAX: the machine with
the card has none.

Every test is marked ``cuda`` and skips, inside its body, when
``torch.cuda.is_available()`` is false.  On the card (``--noconftest``:
``tests/conftest.py`` imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_blockdiag_cuda.py

Tolerance: max|card - cpu| <= 1e-4 * max|cpu| (fp32 sums in another
order), as ``tests/test_torch_cuda.py`` holds the kernels; the losses of
4 reduced steps within rtol 1e-3; TF32 is off.
"""
import math

import pytest
import torch

from repro_torch import kernels as K
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import KFACConfig, TrainConfig
from repro_torch.core import blocks as B
from repro_torch.core.tags import LayerMeta
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.lm import LM
from repro_torch.optimizers.kfac import kfac
from repro_torch.training.trainer import Trainer
from repro_torch.utils.tree import tree_map

pytestmark = pytest.mark.cuda

S, N = 3, 512
# (a_kind, a_blocks, g_kind, g_blocks) at widths (a, g) the kernels tile
# raggedly: a block side's db 129 and 96, a full side's 200 and 384
LAYOUTS = [("block", 2, "full", 1, 258, 200),
           ("full", 1, "block", 4, 200, 384),
           ("block", 3, "block", 4, 387, 384)]


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


@pytest.mark.parametrize("layout", LAYOUTS)
def test_block_route_on_card(layout):
    """The statistics (twice: ε = 0, then 1/2), the NS inverses hot from
    the identity views and the apply of one stacked block layer on the
    card against the CPU, with the launches the route makes: one
    factor_update a side a pass, one ns_step a side an iteration, one
    matmul a side of the apply."""
    _card()
    a_kind, a_nb, g_kind, g_nb, a, gd = layout
    meta = LayerMeta(name="l", param_path=("w",), d_in=a, d_out=gd,
                     n_stack=S, a_kind=a_kind, g_kind=g_kind, a_blocks=a_nb,
                     g_blocks=g_nb)
    gen = torch.Generator().manual_seed(0)
    recs = [(torch.tanh(torch.randn(S, 4, N // 4, a, generator=gen)),
             torch.randn(S, 4, N // 4, gd, generator=gen) / N)
            for _ in range(2)]
    v = torch.randn(S, a, gd, generator=gen)
    out = {}
    for dev in ("cuda", "cpu"):
        blk = B.resolve(meta)(meta, KFACConfig(), dev)
        assert isinstance(blk, B.BlockDiagKronecker)
        K.reset_launches()
        fac = blk.init_factors()
        for eps, (x, cot) in zip((0.0, 0.5), recs):
            fac = blk.update_factors(fac, {"a": x.to(dev)}, cot.to(dev), N,
                                     torch.tensor(eps, device=dev))
        inv = blk.damped_inverse(fac, torch.tensor(0.01, device=dev),
                                 method="ns", iters=12,
                                 prev=blk.identity_inverse())
        u = blk.precondition(inv, v.to(dev))
        out[dev] = (fac, inv, u, K.launches())
    fac, inv, u, launches = out["cuda"]
    for side in ("a", "g"):
        _close(fac[side], out["cpu"][0][side])
        _close(inv[f"{side}_inv"], out["cpu"][1][f"{side}_inv"])
    _close(u, out["cpu"][2])
    assert launches["factor_update"] == 4
    assert launches["ns_step"] == 2 * 12
    assert launches["matmul"] == 2 * 2 * 12 + 2
    assert launches["precondition"] == 0


@pytest.mark.parametrize("mfd", [64, 48])
def test_reduced_gemma2_blocks_on_card(mfd):
    """Reduced gemma2-2b (block sides at ``max_factor_dim`` 64 and 48), 4
    K-FAC steps of the launcher's setup on the card and on the CPU from
    the same weights and uniforms: losses within rtol 1e-3, and block
    layers launch matmul for their apply."""
    _card()
    cfg = get_reduced_config("gemma2-2b")
    kcfg = KFACConfig(lambda_init=10.0, t3=5, max_factor_dim=mfd)
    params = LM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    hist = {}
    for dev in ("cuda", "cpu"):
        lm = LM(cfg, kcfg, device=dev)
        data = SyntheticLMData(cfg.vocab_size, 64, 8, device=dev)
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
    assert launches["factor_update"] == 2 * 14 * 4
    assert launches["matmul"] > 2 * launches["precondition"] + \
        2 * launches["ns_step"]
