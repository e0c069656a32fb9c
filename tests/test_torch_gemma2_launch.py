"""``launch/train.py`` on reduced gemma2-2b on the CPU, with
block-diagonal factors: every option the launcher offers.

The launcher builds its ``KFACConfig`` before the LM and gives it to it,
as the reference's does; no command-line option sets ``max_factor_dim``,
so these runs set it (64: the MLP's d_ff sides in 2 blocks; 48: d_model
in 2 and d_ff in 4) through the ``KFACConfig`` the launcher builds.

* blkdiag; ``--inv_mode tridiag``, which is the blkdiag run bit for bit
  (an LM has no chain of layers); ``--inv_mode eigen``, which runs;
* ``--tau1 0.5`` and ``--refresh_mode staggered``;
* ``--optimizer adam`` and ``sgd_momentum``;
* ``--ckpt_dir``: a relaunch resumes from the checkpoint at step 10, and
  its first loss equals the uninterrupted run's at step 10, bit for bit.

Every case checks that each step's loss is finite.  Also the launch at
the default ``max_factor_dim`` (no block at the reduced widths), the
``cfg`` keyword (a depth cut must keep the arch's name), and the kernel
wrappers' calls of the blkdiag run, which on the card are its launches:
one ``factor_update`` a side, one ``matmul`` a side of the apply on a
layer with a block side and one ``precondition`` on a full/full one, one
``ns_step`` a full or block side each Newton–Schulz iteration.  The
numbers are held against the reference in ``test_torch_gemma2_*.py``.
"""
import functools
import math

import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import KFACConfig
from repro_torch.core import inverse
from repro_torch.core.blocks import kron
from repro_torch.launch import train as tlaunch
from repro_torch.models.lm import LM
from repro_torch.training.checkpoint import Checkpointer

torch.set_num_threads(1)

ARCH = "gemma2-2b"


@pytest.fixture(params=[64, 48])
def mfd(request, monkeypatch):
    """The launcher's ``KFACConfig`` with this ``max_factor_dim``."""
    monkeypatch.setattr(tlaunch, "KFACConfig", functools.partial(
        KFACConfig, max_factor_dim=request.param))
    return request.param


def _run(*argv, steps=3, cfg=None):
    """Train reduced gemma2 through ``main``; returns (history, the
    optimizer, the log lines)."""
    held = {}

    def wrap_opt(opt):
        held["opt"] = opt
        return opt

    logs = []
    res = tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--steps", str(steps), *argv], log=logs.append,
                       wrap_opt=wrap_opt, cfg=cfg)
    hist = res["history"]
    assert hist and all(math.isfinite(h["loss"]) for h in hist), hist
    return hist, held["opt"], logs


def _blocks_in(opt):
    return [n for n, b in opt.engine.blocks.items()
            if type(b).__name__ == "BlockDiagKronecker"]


def _blkdiag(mfd, tmp_path):
    hist, opt, _ = _run(steps=6)
    assert opt.engine.cfg.max_factor_dim == mfd
    assert "blk0.mlp.up" in _blocks_in(opt)
    assert hist[-1]["loss"] < hist[0]["loss"]


def _tridiag(mfd, tmp_path):
    hist, opt, _ = _run("--inv_mode", "tridiag")
    assert opt.engine.cfg.inv_mode == "tridiag" and opt.engine.chain is None
    assert hist == _run("--inv_mode", "blkdiag")[0]
    # eigen runs, block sides included: their bases are block stacks
    eig_hist, eig_opt, _ = _run("--inv_mode", "eigen")
    assert eig_opt.engine.eigen and _blocks_in(eig_opt)
    # λ₀ 10 swamps the curvature: the losses may agree to the last bit,
    # the step sizes do not
    assert [h["alpha"] for h in eig_hist] != [h["alpha"] for h in hist]


def _tau1(mfd, tmp_path):
    _, opt, _ = _run("--tau1", "0.5")
    cfg = opt.engine.cfg
    assert (cfg.tau1, cfg.t3, cfg.lambda_init) == (0.5, 5, 10.0)


def _staggered(mfd, tmp_path):
    hist, opt, _ = _run("--refresh_mode", "staggered", steps=7)
    assert opt.engine.refresh_mode == "staggered"
    assert sorted(n for g in opt.engine.stagger_groups() for n in g) == \
        sorted(opt.engine.blocks)
    assert hist[-1]["loss"] < hist[0]["loss"]


def _first_order(name):
    def case(mfd, tmp_path):
        hist, opt, _ = _run("--optimizer", name, "--lr", "1e-2", steps=4)
        assert opt.engine is None and opt.transform is not None
    return case


def _ckpt(mfd, tmp_path):
    d = str(tmp_path / "ckpt")
    whole, _, _ = _run(steps=12)
    first, _, _ = _run("--ckpt_dir", d, steps=10)
    assert Checkpointer(d).all_steps() == [10]
    assert first == whole[:10]
    second, _, logs = _run("--ckpt_dir", d, steps=12)
    assert "[trainer] restored checkpoint at step 10" in logs
    assert len(second) == 2
    assert second[0]["loss"] == whole[10]["loss"]


CASES = {"blkdiag": _blkdiag, "tridiag": _tridiag, "tau1": _tau1,
         "staggered": _staggered, "adam": _first_order("adam"),
         "sgd_momentum": _first_order("sgd_momentum"), "ckpt": _ckpt}


@pytest.mark.parametrize("case", sorted(CASES))
def test_launcher_option_with_blocks(mfd, case, tmp_path):
    CASES[case](mfd, tmp_path)


def test_launcher_default_layout_and_depth_cut():
    """At the default ``max_factor_dim`` reduced gemma2 has no block side;
    ``cfg`` trains the arch cut in depth (4 layers: two local/global
    pairs), and a config of another arch is refused."""
    hist, opt, logs = _run(steps=2)
    assert not _blocks_in(opt)
    assert logs[0].startswith("[train] arch=gemma2-2b-reduced ")
    cut = get_reduced_config(ARCH).replace(n_layers=4)
    _, opt, _ = _run(steps=2, cfg=cut)
    assert opt.engine.model.cfg.n_layers == 4
    assert opt.engine.metas["blk0.mlp.up"].n_stack == 2
    with pytest.raises(ValueError, match="is not --arch's"):
        _run(steps=1, cfg=get_reduced_config("llama3.2-1b"))


def expected_calls(metas, steps: int, cfg=KFACConfig(lambda_init=10.0,
                                                      t3=5)):
    """The wrappers' calls of ``steps`` launcher steps of an LM with these
    metas (one statistics pass a step, the warmup refreshes, every T3 and
    the γ sweep at every T2 step): what ``chip_smoke.py`` holds the card's
    launches to."""
    dense = [m for m in metas.values() if m.kind == "dense"]
    blocked = [m for m in dense if "block" in (m.a_kind, m.g_kind)]
    sides = sum((m.a_kind != "diag") + (m.g_kind != "diag")
                for m in metas.values())
    sweeps = [s for s in range(steps) if s and s % cfg.t2 == 0]
    passes = [s for s in range(steps)
              if s < 3 or s % cfg.t3 == 0 or s in sweeps]
    applies = steps + 2 * len(sweeps)        # 3 candidates at a sweep
    return {"factor_update": 2 * len(dense) * steps,
            "precondition": (len(dense) - len(blocked)) * applies,
            "matmul": 2 * len(blocked) * applies,
            "ns_step": sides * cfg.ns_iters * len(passes)}


@pytest.mark.parametrize("steps", [6, 21])
def test_launcher_calls_each_wrapper_as_the_card_counts(mfd, steps,
                                                        monkeypatch):
    """The calls of the blkdiag run (21 steps: through the γ sweep at 20)
    equal ``expected_calls`` from the metas."""
    calls = {}

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return wrapper

    for mod, attr, name in ((kron, "factor_update", "factor_update"),
                            (kron, "precond_kernel", "precondition"),
                            (kron, "matmul", "matmul"),
                            (inverse.NS, "ns_step", "ns_step")):
        monkeypatch.setattr(mod, attr, counted(name, getattr(mod, attr)))
    _run(steps=steps)
    metas = LM(get_reduced_config(ARCH), KFACConfig(max_factor_dim=mfd),
               device="cpu").metas
    want = expected_calls(metas, steps)
    assert want["matmul"] > 0
    assert calls == {k: n for k, n in want.items() if n}
