"""The reduced dense decoders' (smollm-135m, llama3.2-1b) ``Trainer.fit``
in the port against a live JAX ``Trainer.fit`` of the reference
launcher's setup (lambda_init 10, T3 5, blkdiag with Newton–Schulz
inverses; batch 8, seq 64), on the CPU: 11 steps, through the warmup
refreshes, the T3 refreshes at steps 5 and 10 and the lambda steps at 4
and 9.  Models, data, weights and the head's sampling noise as in
``test_torch_decoder_parity.py``.

Step for step from the reference's state: loss, lambda, gamma, alpha, mu
and rho within rtol 1e-3 at every step, parameters and factors within
1e-4.  Free-running: the bands of ROADMAP queue C (lambda and gamma
exactly, the loss within 5e-3, alpha, mu and rho within 1e-3 through
step 4).
"""
import dataclasses
import functools

import pytest
import torch

from repro import optimizers as joptimizers
from repro.configs.base import KFACConfig as JKFACConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.training.trainer import Trainer as JTrainer
from repro_torch.configs.base import KFACConfig, TrainConfig
from repro_torch.convert import lm_params_from_numpy, state_from_numpy
from repro_torch.optimizers.kfac import kfac
from repro_torch.training.trainer import Trainer
from test_torch_decoder_parity import ARCHS, _setup
from test_torch_whisper_parity import _close_tree, _head_uniforms, _np

torch.set_num_threads(1)

STEPS = 11


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """A live JAX ``Trainer.fit`` of the reference launcher's setup,
    recording every step's inputs and outputs."""
    s = _setup(arch)
    opt = joptimizers.kfac(s["jl"], JKFACConfig(lambda_init=10.0, t3=5))
    record = []

    def update(grads, state, params, batch, rng):
        out = opt.update(grads, state, params, batch, rng)
        record.append(_np((state, params, out[0], out[1])))
        return out

    tr = JTrainer(s["jl"], dataclasses.replace(opt, update=update),
                  JTrainConfig(steps=STEPS, seed=0, log_every=10_000),
                  None, None)
    hist = tr.fit(s["jp"], s["jdata"], steps=STEPS,
                  log=lambda *_: None)["history"]
    return hist, record


def _port_opt(arch):
    return kfac(_setup(arch)["lm"], KFACConfig(lambda_init=10.0, t3=5),
                device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_each_step_matches_jax_from_its_state(arch):
    """Step for step: every optimizer step of the port, started from the
    reference's state and parameters at that step with the same noise,
    gives the reference's step: stats, the warmup and T3 refreshes, the
    preconditioned update with its 2×2 quadratic model and the T1 lambda
    rule."""
    want, record = _jax_run(arch)
    s = _setup(arch)
    opt = _port_opt(arch)
    for step, (jstate, jparams, jnew, jout) in enumerate(record):
        params = lm_params_from_numpy(jparams, "cpu")
        if step == 0:
            opt.init(params, s["data"].batch(0))
        new, state, m = opt.update(
            None, state_from_numpy(vars(jstate), "cpu"), params,
            s["data"].batch(step),
            lambda shape, step=step: _head_uniforms(0, step, shape))
        for k in ("loss", "lam", "gamma", "alpha", "mu", "rho"):
            assert (k in m) == (k in want[step]), (step, k)
            if k in m:
                assert float(m[k]) == pytest.approx(want[step][k],
                                                    rel=1e-3), (step, k)
        _close_tree(new, jnew, rtol=1e-4)
        _close_tree(state.factors, jout.factors, rtol=1e-4)
        _close_tree(state.inv, jout.inv, rtol=1e-4)
        assert int(state.step) == int(jout.step) == step + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_trajectory_matches_live_jax(arch):
    """Free-running: both trainers from the same start, JAX's noise
    injected every step, held to queue C's bands."""
    want, _ = _jax_run(arch)
    s = _setup(arch)
    tr = Trainer(s["lm"], _port_opt(arch),
                 TrainConfig(steps=STEPS, seed=0, log_every=10_000),
                 noise=lambda step, shape: _head_uniforms(0, step, shape),
                 device="cpu")
    got = tr.fit(s["params"], s["data"], steps=STEPS,
                 log=lambda *_: None)["history"]
    assert len(got) == len(want) == STEPS
    for step in range(STEPS):
        for k in ("loss", "lam", "gamma", "alpha", "mu", "rho"):
            assert (k in got[step]) == (k in want[step]), (step, k)
        for k in ("lam", "gamma"):
            assert got[step][k] == pytest.approx(want[step][k], rel=1e-6)
        assert got[step]["loss"] == pytest.approx(want[step]["loss"],
                                                  rel=5e-3), step
        if step <= 4:
            for k in ("loss", "alpha", "mu", "rho"):
                if k in want[step]:
                    assert got[step][k] == pytest.approx(
                        want[step][k], rel=1e-3), (step, k)
    assert got[-1]["loss"] < got[0]["loss"]
