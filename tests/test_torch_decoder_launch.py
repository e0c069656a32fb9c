"""``launch/train.py`` on the reduced dense decoders (smollm-135m,
llama3.2-1b) on the CPU: every option the launcher offers, on each arch.

* ``--inv_mode tridiag`` is the blkdiag run bit for bit (an LM has no
  chain of layers), and ``--inv_mode eigen`` raises "not ported yet";
* ``--tau1 0.5`` and ``--refresh_mode staggered`` build the reference
  launcher's config (λ₀ 10, T3 5) with that mode;
* ``--optimizer adam`` and ``sgd_momentum`` train with the first-order
  baselines;
* ``--ckpt_dir``: a relaunch resumes from the checkpoint at step 10, and
  its first loss equals the uninterrupted run's at step 10, bit for bit.

Every case checks that each step's loss is finite.  The launcher's
weights are the port's own seed-0 initialization; the decoders' numbers
are held against the reference in ``test_torch_decoder_parity.py`` and
``test_torch_decoder_trajectory.py``.

Also the engine's in-place writes, which let full-width llama3.2-1b fit
one card: a statistics pass or a refresh writes its factors or inverses
over a set the engine wrote before (``Written``), and leaves ``init``'s
state (zero and identity views) as it was.  And the kernel wrappers'
calls in the launcher's runs, which on the card are its launches: the
counts ``chip_smoke.py`` holds the full-width runs to, from the same
stacked layers.
"""
import math

import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import KFACConfig
from repro_torch.core import inverse
from repro_torch.core.blocks import kron
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch import train as tlaunch
from repro_torch.models.lm import LM
from repro_torch.optimizers.kfac import KFACEngine, Written
from repro_torch.training.checkpoint import Checkpointer

torch.set_num_threads(1)

ARCHS = ("smollm-135m", "llama3.2-1b")


def _run(arch, *argv, steps=3):
    """Train reduced ``arch`` through ``main``; returns (history, the
    optimizer, the log lines)."""
    held = {}

    def wrap_opt(opt):
        held["opt"] = opt
        return opt

    logs = []
    res = tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--steps", str(steps), *argv], log=logs.append,
                       wrap_opt=wrap_opt)
    hist = res["history"]
    assert hist and all(math.isfinite(h["loss"]) for h in hist), hist
    return hist, held["opt"], logs


def _tridiag(arch, tmp_path):
    hist, opt, _ = _run(arch, "--inv_mode", "tridiag")
    assert opt.engine.cfg.inv_mode == "tridiag" and opt.engine.chain is None
    assert hist == _run(arch, "--inv_mode", "blkdiag")[0]
    with pytest.raises(NotImplementedError, match="not ported yet"):
        _run(arch, "--inv_mode", "eigen")


def _tau1(arch, tmp_path):
    _, opt, _ = _run(arch, "--tau1", "0.5")
    cfg = opt.engine.cfg
    assert (cfg.tau1, cfg.t3, cfg.lambda_init) == (0.5, 5, 10.0)


def _staggered(arch, tmp_path):
    hist, opt, _ = _run(arch, "--refresh_mode", "staggered", steps=7)
    assert opt.engine.refresh_mode == "staggered"
    assert hist[-1]["loss"] < hist[0]["loss"]


def _first_order(name):
    def case(arch, tmp_path):
        hist, opt, _ = _run(arch, "--optimizer", name, "--lr", "1e-2",
                            steps=4)
        assert opt.engine is None and opt.transform is not None
    return case


def _ckpt(arch, tmp_path):
    d = str(tmp_path / "ckpt")
    whole, _, _ = _run(arch, steps=12)
    first, _, _ = _run(arch, "--ckpt_dir", d, steps=10)
    assert Checkpointer(d).all_steps() == [10]
    assert first == whole[:10]
    second, _, logs = _run(arch, "--ckpt_dir", d, steps=12)
    assert "[trainer] restored checkpoint at step 10" in logs
    assert len(second) == 2
    assert second[0]["loss"] == whole[10]["loss"]


CASES = {"tridiag": _tridiag, "tau1": _tau1, "staggered": _staggered,
         "adam": _first_order("adam"),
         "sgd_momentum": _first_order("sgd_momentum"), "ckpt": _ckpt}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_option_on_decoder(arch, case, tmp_path):
    CASES[case](arch, tmp_path)


def test_launcher_defaults_to_llama():
    """``--arch`` defaults to llama3.2-1b, as the reference launcher's
    does; the decoders (gemma2-2b among them) and whisper-small are the
    archs it trains."""
    logs = []
    tlaunch.main(["--reduced", "--device", "cpu", "--steps", "1"],
                 log=logs.append)
    assert logs[0].startswith("[train] arch=llama3.2-1b-reduced ")
    assert tlaunch.TRAINED_ARCHS == ("llama3.2-1b", "smollm-135m",
                                     "gemma2-2b", "whisper-small")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_writes_over_its_own_sets(arch):
    """The first statistics pass and the first refresh leave ``init``'s
    state as it was (zero and identity views) and make ``Written`` sets;
    the next ones write over those sets, so the earlier state sees the
    new values; a state's own dict is never replaced by a copy."""
    cfg = get_reduced_config(arch)
    lm = LM(cfg, device="cpu")
    eng = KFACEngine(lm, KFACConfig(lambda_init=10.0, t3=5), device="cpu")
    params = lm.init_params(torch.Generator().manual_seed(0))
    data = SyntheticLMData(cfg.vocab_size, 64, 8, device="cpu")
    uniforms = lambda shape: torch.rand(
        shape, generator=torch.Generator().manual_seed(1))
    s0 = eng.init(params, data.batch(0))
    a0 = s0.factors["blk0.mlp.down"]["a"]
    assert a0.stride(0) == 0 and not a0.any()
    assert s0.inv["blk0.mlp.down"]["a_inv"].stride(0) == 0
    s1, _, _ = eng.stats_grads(s0, params, data.batch(0), uniforms)
    s1 = eng.refresh_inverses(s1, hot=True)
    assert type(s1.factors) is Written and type(s1.inv) is Written
    assert s0.factors["blk0.mlp.down"]["a"] is a0 and not a0.any()
    assert type(s0.inv) is dict and type(s0.factors) is dict
    inv1 = dict(s1.inv)
    s2, _, _ = eng.stats_grads(s1, params, data.batch(1), uniforms)
    s2 = eng.refresh_inverses(s2, hot=True)
    assert s2.factors is s1.factors and s2.inv is s1.inv
    assert all(s2.inv[k] is not inv1[k] for k in inv1)
    assert all(torch.isfinite(v).all() for blk in s2.inv.values()
               for v in blk.values())


@pytest.mark.parametrize("arch,steps", [("smollm-135m", 25),
                                        ("llama3.2-1b", 6)])
def test_launcher_calls_each_wrapper_as_the_card_counts(arch, steps,
                                                        monkeypatch):
    """One batched call a side (the stacked layers'): factor_update on
    both sides of the 7 layer types every step, precondition on each
    every step and on 3 candidates at the γ sweep (step 20), ns_step on
    the 15 full sides (the 14 and the tied embedding's Ḡ) 12 times at each
    refresh (steps 0, 1, 2 and every T3) and at the sweep."""
    calls = {}

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(kron, "factor_update",
                        counted("factor_update", kron.factor_update))
    monkeypatch.setattr(kron, "precond_kernel",
                        counted("precondition", kron.precond_kernel))
    monkeypatch.setattr(inverse.NS, "ns_step",
                        counted("ns_step", inverse.NS.ns_step))
    _run(arch, steps=steps)
    sweeps = [s for s in range(steps) if s and s % 20 == 0]
    passes = [s for s in range(steps) if s < 3 or s % 5 == 0]
    assert calls == {"factor_update": 14 * steps,
                     "precondition": 7 * steps + 14 * len(sweeps),
                     "ns_step": 15 * 12 * len(passes)}
