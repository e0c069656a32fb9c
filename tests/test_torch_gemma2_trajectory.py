"""Reduced gemma2-2b's ``Trainer.fit`` in the port against a live JAX
``Trainer.fit`` of the reference launcher's setup (lambda_init 10, T3 5,
blkdiag with Newton–Schulz inverses; batch 8, seq 64), on the CPU, with
block-diagonal factors from ``max_factor_dim`` 64 and 48 (see
``test_torch_gemma2_parity.py``).  Models, data, weights and the head's
sampling noise as there.

A loss alone cannot tell a wrong block layout from the full one here
(damping swamps the small factors), so the step-for-step runs hold the
block-shaped factors and inverses too.

* Step for step from the reference's state, 11 steps (the warmup
  refreshes, the T3 refreshes at 5 and 10, the λ steps at 4 and 9): loss,
  λ, γ, α, μ and ρ within rtol 1e-3 at every step; parameters, factors and
  inverses within 1e-4, their shapes equal.
* At step 3 μ is near zero (about 3e-6, against 3e-4 to 2e-3 at the
  steps around it), and the 2×2 solve gives it to about the same
  absolute error as at any step, 1e-8 to 2e-8: a few 1e-3 of it.  JAX
  against itself moves it as far (6.7e-3 at 64 when the step is re-run
  from its own state with the parameters scaled by 1 + 1e-7, 5.5e-3
  without blocks; 2.5e-3 between XLA on one core and on several).  So μ
  is held within rtol 1e-3 or within 1e-3 of the run's median |μ|
  (``_mu_floor``, about 7e-7), in both kinds of run.
* Free-running: the bands of ROADMAP queue C (λ and γ within 1e-6, the
  loss within 5e-3, α, μ and ρ within 1e-3 through step 4), 11 steps at
  64 and at 48.  The 21-step run through the step-20 γ sweep is in
  ``test_torch_gemma2_sweep.py``, the staggered refresh and ``tau1`` in
  ``test_torch_gemma2_modes.py`` (each file under 90 s on one core).
"""
import dataclasses
import functools

import numpy as np
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
from test_torch_gemma2_parity import KFAC, _setup
from test_torch_whisper_parity import _close_tree, _head_uniforms, _np

torch.set_num_threads(1)

STEPS = 11
KEYS = ("loss", "lam", "gamma", "alpha", "mu", "rho")
# the free-running runs: (max_factor_dim, steps, mode)
RUNS = {"64": (64, STEPS, ()), "48": (48, STEPS, ())}


def _kcfg(mfd, mode=()):
    return dict(**KFAC, max_factor_dim=mfd, **dict(mode))


@functools.lru_cache(maxsize=None)
def _jax_run(mfd, steps, mode=()):
    """A live JAX ``Trainer.fit`` of the reference launcher's setup,
    recording every step's inputs and outputs."""
    s = _setup(mfd)
    opt = joptimizers.kfac(s["jl"], JKFACConfig(**_kcfg(mfd, mode)))
    record = []

    def update(grads, state, params, batch, rng):
        out = opt.update(grads, state, params, batch, rng)
        record.append(_np((state, params, out[0], out[1])))
        return out

    tr = JTrainer(s["jl"], dataclasses.replace(opt, update=update),
                  JTrainConfig(steps=steps, seed=0, log_every=10_000),
                  None, None)
    hist = tr.fit(s["jp"], s["jdata"], steps=steps,
                  log=lambda *_: None)["history"]
    return hist, record


def _mu_floor(want):
    """The absolute floor of μ's band: 1e-3 of the run's median |μ| (the
    steps after the first, whose μ is 0)."""
    return 1e-3 * float(np.median([abs(h["mu"]) for h in want[1:]]))


def _near(got, want, key, floor, rtol=1e-3):
    """``got`` within ``rtol`` of ``want``; μ, a coefficient the 2×2 solve
    gives to an absolute error about the same at every step, also within
    ``floor``."""
    err = abs(got - want)
    return err <= rtol * abs(want) or (key == "mu" and err <= floor)


def _port_opt(mfd, mode=()):
    return kfac(_setup(mfd)["lm"], KFACConfig(**_kcfg(mfd, mode)),
                device="cpu")


def _shapes(tree):
    return {k: {s: tuple(v.shape) for s, v in d.items()}
            for k, d in tree.items()}


@pytest.mark.parametrize("mfd", [64, 48])
def test_each_step_matches_jax_from_its_state(mfd):
    """Step for step: every optimizer step of the port, started from the
    reference's state and parameters at that step with the same noise,
    gives the reference's step, block-shaped factors and inverses
    included."""
    want, record = _jax_run(mfd, STEPS, ())
    s = _setup(mfd)
    opt = _port_opt(mfd)
    for step, (jstate, jparams, jnew, jout) in enumerate(record):
        params = lm_params_from_numpy(jparams, "cpu")
        if step == 0:
            opt.init(params, s["data"].batch(0))
        new, state, m = opt.update(
            None, state_from_numpy(vars(jstate), "cpu"), params,
            s["data"].batch(step),
            lambda shape, step=step: _head_uniforms(0, step, shape))
        for k in KEYS:
            assert (k in m) == (k in want[step]), (step, k)
            if k in m:
                assert _near(float(m[k]), want[step][k], k,
                             _mu_floor(want)), (step, k, float(m[k]),
                                                want[step][k])
        _close_tree(new, jnew, rtol=1e-4)
        assert _shapes(state.factors) == _shapes(jout.factors)
        assert _shapes(state.inv) == _shapes(jout.inv)
        _close_tree(state.factors, jout.factors, rtol=1e-4)
        _close_tree(state.inv, jout.inv, rtol=1e-4)
        assert int(state.step) == int(jout.step) == step + 1
    blocks = [v for d in _shapes(state.inv).values() for v in d.values()
              if len(v) == 4]
    assert blocks, "no block-shaped inverse"


def free_run_matches_live_jax(mfd, steps, mode=()):
    """Free-running: both trainers from the same start, JAX's noise
    injected every step, held to queue C's bands."""
    want, _ = _jax_run(mfd, steps, mode)
    s = _setup(mfd)
    opt = _port_opt(mfd, mode)
    tr = Trainer(s["lm"], opt,
                 TrainConfig(steps=steps, seed=0, log_every=10_000),
                 noise=lambda step, shape: _head_uniforms(0, step, shape),
                 device="cpu")
    got = tr.fit(s["params"], s["data"], steps=steps,
                 log=lambda *_: None)["history"]
    assert len(got) == len(want) == steps
    for step in range(steps):
        for k in KEYS:
            assert (k in got[step]) == (k in want[step]), (step, k)
        for k in ("lam", "gamma"):
            assert got[step][k] == pytest.approx(want[step][k], rel=1e-6)
        assert got[step]["loss"] == pytest.approx(want[step]["loss"],
                                                  rel=5e-3), step
        if step <= 4:
            for k in ("loss", "alpha", "mu", "rho"):
                if k in want[step]:
                    assert _near(got[step][k], want[step][k], k,
                                 _mu_floor(want)), (
                        step, k, got[step][k], want[step][k])
    if steps > 20:
        # the sweep moved γ, and both picked the same candidate
        assert got[20]["gamma"] != got[19]["gamma"]
    assert got[-1]["loss"] < got[0]["loss"]


@pytest.mark.parametrize("run", sorted(RUNS))
def test_trajectory_matches_live_jax(run):
    free_run_matches_live_jax(*RUNS[run])
