"""``KFACConfig.fused_stats`` on the LMs against the JAX reference, on the
CPU.  Only unstacked full/full dense or conv layers contract in the passes
(``core/fused.py::fused_eligible``): on whisper its two conv stems, whose
A side is ``patch_factor`` at α = 1, β = 0 and whose G side is
``factor_update`` inside the backward, as in the reference; the decoders
have no eligible layer.  Held here:

* the engine's ``fused_names`` equal JAX's on whisper and on the decoders
  (empty);
* the factors after two statistics passes against JAX's fused run (1e-5;
  the stems' contracted in the passes) and the stems' against the port's
  own two-pass engine (rtol 1e-5);
* reduced whisper, 6 steps step for step from JAX's state, in eigen mode
  and in blkdiag, with the harness and bands of
  ``test_torch_lm_eigen_trajectory.py``;
* on smollm-135m the ``fused_stats`` run is the two-pass run bit for bit.

A fused JAX engine puts its hooks on its model's maps for good, so each
gets a model of its own here.
"""
import jax
import pytest
import torch

from repro.configs.base import KFACConfig as JKFACConfig
from repro.optimizers.kfac import KFACEngine as JEngine
from repro_torch.configs.base import KFACConfig, TrainConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.optimizers.kfac import KFACEngine, kfac
from repro_torch.training.trainer import Trainer
from test_torch_lm_eigen_trajectory import (KFAC, jax_run, launcher_run,
                                           setup, step_for_step)
from test_torch_whisper_parity import _close, _head_uniforms

torch.set_num_threads(1)

STEMS = {"enc.conv1", "enc.conv2"}
EIGEN_FS = ("whisper-small", 8192, (("inv_mode", "eigen"),
                                    ("fused_stats", True)))
BLKDIAG_FS = ("whisper-small", 8192, (("fused_stats", True),))


def _jax_engine(arch, **kw):
    jl = setup(arch)["jl"]
    return JEngine(type(jl)(jl.cfg, jl.kfac), JKFACConfig(**KFAC, **kw))


@pytest.mark.parametrize("arch", ["whisper-small", "smollm-135m",
                                  "llama3.2-1b"])
def test_fused_names_are_jaxs(arch):
    eng = KFACEngine(setup(arch)["lm"], KFACConfig(**KFAC, fused_stats=True),
                     device="cpu")
    assert eng.fused_names == _jax_engine(arch, fused_stats=True).fused_names
    assert eng.fused_names == (STEMS if arch == "whisper-small" else set())


def test_stem_factors_after_two_fused_passes():
    """Two statistics passes (the second blends at ε = 1/2) at the
    parameters and with the noise of the fused JAX run's steps 0 and 1:
    every block's factors against that run's after step 1 (the stems'
    contracted in the passes in both), and the stems' against the port's
    own two-pass engine."""
    s = setup("whisper-small")
    _, record = jax_run(*EIGEN_FS, 6)
    eng = KFACEngine(s["lm"], KFACConfig(**KFAC, fused_stats=True),
                     device="cpu")
    two = KFACEngine(s["lm"], KFACConfig(**KFAC), device="cpu")
    b = s["data"].batch(0)
    state, tstate = eng.init(s["params"], b), two.init(s["params"], b)
    for step in range(2):
        params = lm_params_from_numpy(record[step][1], "cpu")
        b = s["data"].batch(step)
        uni = lambda shape, step=step: _head_uniforms(0, step, shape)
        state, _, _ = eng.stats_grads(state, params, b, uni)
        tstate, _, _ = two.stats_grads(tstate, params, b, uni)
    want = record[1][3].factors
    for name in want:
        for side in ("a", "g"):
            _close(state.factors[name][side], want[name][side])
    for name in STEMS:
        for side in ("a", "g"):
            torch.testing.assert_close(state.factors[name][side],
                                       tstate.factors[name][side],
                                       rtol=1e-5, atol=1e-5 * float(
                                           tstate.factors[name][side]
                                           .abs().max()))
    assert s["lm"].contract_map == {} and s["lm"].gcontract_map == {}


@pytest.mark.parametrize("run", ["eigen", "blkdiag"])
def test_each_step_matches_jax_from_its_state(run):
    step_for_step(*(EIGEN_FS if run == "eigen" else BLKDIAG_FS), 6)


def test_decoder_fused_run_is_the_two_pass_run_bitwise():
    """smollm-135m has no eligible layer: 3 steps with ``fused_stats``
    give the two-pass run's losses and parameters bit for bit."""
    s = setup("smollm-135m")
    out = []
    for fused in (True, False):
        tr = Trainer(s["lm"], kfac(s["lm"], KFACConfig(
            **KFAC, inv_mode="eigen", fused_stats=fused), device="cpu"),
            TrainConfig(steps=3, seed=0, log_every=10_000),
            noise=lambda step, shape: _head_uniforms(0, step, shape),
            device="cpu")
        res = tr.fit(s["params"], s["data"], steps=3, log=lambda *_: None)
        out.append(res)
    assert [h["loss"] for h in out[0]["history"]] == \
        [h["loss"] for h in out[1]["history"]]
    for a, b in zip(jax.tree.leaves(out[0]["params"]),
                    jax.tree.leaves(out[1]["params"])):
        assert torch.equal(a, b)


def test_eigen_launcher_matches_jax(monkeypatch):
    """``launch/train.py --inv_mode eigen`` on whisper, ``fused_stats``
    through the launcher's ``KFACConfig``, against the fused JAX run."""
    eng = launcher_run(*EIGEN_FS, 6, monkeypatch)
    assert eng.fused_names == STEMS
