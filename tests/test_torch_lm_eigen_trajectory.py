"""EKFAC (``inv_mode="eigen"``) on reduced smollm-135m: the port's
``Trainer.fit`` against a live JAX ``Trainer.fit`` of the reference
launcher's setup (λ₀ 10, T3 5; batch 8, seq 64), on the CPU, with JAX's
weights and the head's sampling noise injected as in
``test_torch_decoder_parity.py``.  One 21-step JAX run serves both tests:
its first 11 steps (the warmup refreshes, the T3 refreshes at 5 and 10,
the λ steps at 4 and 9, the per-step rescale in between) step for step,
and all 21 free-running, through the γ sweep at step 20 (three candidates
from one eigh a factor).

The eigh basis is not unique (column signs, rotations inside a
near-degenerate eigenspace), so a state the port refreshes itself is held
through its eigenvalue diagonals ``s`` and ``damp`` only, and the
step-for-step runs start each step from JAX's state with JAX's bases
carried across (``convert.state_from_numpy``): the rescale between
refreshes then rotates with JAX's own bases.

Bands (ROADMAP queue C): step for step, loss, λ, γ, α, μ and ρ within
rtol 1e-3, parameters and factors within 1e-4, ``s`` and ``damp`` within
1e-3 (a rescaled ``s`` squares the rotated gradient, so an entry far
below the array's scale carries the gradient's rounding twice; seen up to
2 of 4608 entries of reduced whisper's beyond 1e-4); free-running, λ and γ
within 1e-6, the loss within 5e-3, α, μ and ρ within 1e-3 through step 4,
and the same γ picked at the sweep.

``launch/train.py --inv_mode eigen`` is held the same way (free-running,
6 steps): the JAX launcher runs exactly this ``Trainer.fit``
(``repro/launch/train.py``: λ₀ 10, T3 5, seed 0, weights from
``PRNGKey(0)``, batch 8, seq 64), so the port's launcher, given JAX's
weights and JAX's head noise, is held to its losses without a second JAX
run.

This file also holds the harness the other LM trajectory files use
(``test_torch_lm_eigen_blocks.py``, ``test_torch_lm_chain.py``,
``test_torch_lm_fused.py``).
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
import test_torch_decoder_parity as DP
import test_torch_gemma2_parity as GP
import test_torch_whisper_parity as WP
from test_torch_whisper_parity import _close, _close_tree, _head_uniforms, _np

torch.set_num_threads(1)

KFAC = dict(lambda_init=10.0, t3=5)     # the reference launcher's
KEYS = ("loss", "lam", "gamma", "alpha", "mu", "rho")
SMOLLM = ("smollm-135m", 8192, (("inv_mode", "eigen"),))


def setup(arch, mfd=8192):
    """The reduced LM's models, weights and data, as its parity file
    builds them (gemma2 with ``max_factor_dim`` ``mfd``)."""
    if arch == "gemma2-2b":
        return GP._setup(mfd)
    if arch == "whisper-small":
        return WP._setup()
    return DP._setup(arch)


def kfac_cfg(mfd, kw):
    return dict(**KFAC, max_factor_dim=mfd, **dict(kw))


@functools.lru_cache(maxsize=None)
def jax_run(arch, mfd, kw, steps):
    """A live JAX ``Trainer.fit`` (``kw``: KFACConfig fields as a tuple of
    items), recording every step's inputs and outputs."""
    s = setup(arch, mfd)
    jl = s["jl"]
    if dict(kw).get("fused_stats"):
        # a fused JAX engine puts its hooks on its model's maps for good:
        # give it a model of its own
        jl = type(jl)(jl.cfg, jl.kfac)
    opt = joptimizers.kfac(jl, JKFACConfig(**kfac_cfg(mfd, kw)))
    record = []

    def update(grads, state, params, batch, rng):
        out = opt.update(grads, state, params, batch, rng)
        record.append(_np((state, params, out[0], out[1])))
        return out

    tr = JTrainer(jl, dataclasses.replace(opt, update=update),
                  JTrainConfig(steps=steps, seed=0, log_every=10_000),
                  None, None)
    hist = tr.fit(s["jp"], s["jdata"], steps=steps,
                  log=lambda *_: None)["history"]
    return hist, record


def port_opt(arch, mfd, kw):
    return kfac(setup(arch, mfd)["lm"], KFACConfig(**kfac_cfg(mfd, kw)),
                device="cpu")


def mu_floor(arch, want):
    """μ's absolute floor: 1e-3 of the run's median |μ| on gemma2, whose μ
    passes near zero (ROADMAP queue C); none elsewhere."""
    if arch != "gemma2-2b":
        return 0.0
    return 1e-3 * float(np.median([abs(h["mu"]) for h in want[1:]]))


def near(got, want, key, hist_loss, floor, chain):
    """``got`` within rtol 1e-3 of ``want``; μ also within ``floor``; on
    the fixed-lr chain ρ, the loss difference itself (m_delta is -1),
    also within 1e-6 of the loss (ROADMAP queue C's band of the fixed-lr paths)."""
    err = abs(got - want)
    return (err <= 1e-3 * abs(want) or (key == "mu" and err <= floor)
            or (chain and key == "rho" and err <= 1e-6 * abs(hist_loss)))


def _inv_close(got, want, eigen):
    """Inverses within 1e-4; eigen states through ``s`` and ``damp``
    (1e-3), their bases' presence and shapes."""
    if not eigen:
        _close_tree(got, want, rtol=1e-4)
        return
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        for k in ("qa", "qg"):
            assert (g[k] is None) == (w[k] is None), (name, k)
            if w[k] is not None:
                assert tuple(g[k].shape) == w[k].shape, (name, k)
        _close(g["s"], w["s"], rtol=1e-3)
        _close(g["damp"], w["damp"], rtol=1e-3)


def step_for_step(arch, mfd, kw, steps, jax_steps=None):
    """Every optimizer step of the port from the reference's state and
    parameters at that step with the same noise gives the reference's
    step (the first ``steps`` of a ``jax_steps``-step JAX run).  Returns
    the port's last state."""
    cfg = KFACConfig(**kfac_cfg(mfd, kw))
    want, record = jax_run(arch, mfd, kw, jax_steps or steps)
    s = setup(arch, mfd)
    opt = port_opt(arch, mfd, kw)
    floor = mu_floor(arch, want)
    for step, (jstate, jparams, jnew, jout) in enumerate(record[:steps]):
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
                assert near(float(m[k]), want[step][k], k,
                            want[step]["loss"], floor,
                            not cfg.use_rescale), (step, k, float(m[k]),
                                                   want[step][k])
        _close_tree(new, jnew, rtol=1e-4)
        _close_tree(state.factors, jout.factors, rtol=1e-4)
        _inv_close(state.inv, jout.inv, cfg.inv_mode == "eigen")
        assert int(state.step) == int(jout.step) == step + 1
    return state


def free_run(arch, mfd, kw, steps, jax_steps=None):
    """Both trainers from the same start, JAX's noise injected every step,
    held to queue C's bands (``jax_steps``: a longer JAX run whose first
    ``steps`` are compared)."""
    cfg = KFACConfig(**kfac_cfg(mfd, kw))
    want, _ = jax_run(arch, mfd, kw, jax_steps or steps)
    s = setup(arch, mfd)
    tr = Trainer(s["lm"], port_opt(arch, mfd, kw),
                 TrainConfig(steps=steps, seed=0, log_every=10_000),
                 noise=lambda step, shape: _head_uniforms(0, step, shape),
                 device="cpu")
    got = tr.fit(s["params"], s["data"], steps=steps,
                 log=lambda *_: None)["history"]
    floor = mu_floor(arch, want)
    assert len(got) == steps
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
                    assert near(got[step][k], want[step][k], k,
                                want[step]["loss"], floor,
                                not cfg.use_rescale), (
                        step, k, got[step][k], want[step][k])
    if steps > 20 and cfg.use_rescale:
        # the sweep moved γ, and both picked the same candidate
        assert got[20]["gamma"] != got[19]["gamma"]
    return got, want


def launcher_run(arch, mfd, kw, steps, monkeypatch, jax_steps=None):
    """``launch/train.py --inv_mode <kw's> --reduced`` on the CPU with JAX's
    weights (``LM.init_params``) and JAX's head noise (the ``Trainer``'s
    ``noise``), the other ``kw`` fields and ``max_factor_dim`` through the
    launcher's ``KFACConfig``, held to the JAX run of the same setup with
    queue C's free-running bands."""
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.lm import LM
    want, _ = jax_run(arch, mfd, kw, jax_steps or steps)
    kw = dict(kw)
    mode = kw.pop("inv_mode", "blkdiag")
    s = setup(arch, mfd)
    monkeypatch.setattr(tlaunch, "KFACConfig", functools.partial(
        KFACConfig, max_factor_dim=mfd))
    monkeypatch.setattr(LM, "init_params",
                        lambda self, gen=None: s["params"])
    monkeypatch.setattr(tlaunch, "Trainer", functools.partial(
        tlaunch.Trainer,
        noise=lambda step, shape: _head_uniforms(0, step, shape)))
    held = {}

    def wrap_opt(opt):
        held["opt"] = opt
        return opt

    got = tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--steps", str(steps), "--inv_mode", mode],
                       log=lambda *_: None, wrap_opt=wrap_opt,
                       kfac_kw=kw)["history"]
    eng = held["opt"].engine
    assert eng.cfg.inv_mode == mode and eng.cfg.max_factor_dim == mfd
    for step in range(steps):
        for k in ("lam", "gamma"):
            assert got[step][k] == pytest.approx(want[step][k], rel=1e-6)
        assert got[step]["loss"] == pytest.approx(
            want[step]["loss"], rel=1e-3 if step <= 4 else 5e-3), step
    return eng


def test_each_step_matches_jax_from_its_state():
    """11 steps of reduced smollm-135m in eigen mode, step for step."""
    state = step_for_step(*SMOLLM, 11, jax_steps=21)
    # a diag side (the tied embedding's Ā) keeps no basis
    assert state.inv["embed"]["qa"] is None
    assert tuple(state.inv["blk0.mlp.down"]["qa"].shape) == (2, 96, 96)


def test_trajectory_matches_live_jax_through_the_sweep():
    """21 steps free-running, through the γ sweep at step 20."""
    got, want = free_run(*SMOLLM, 21)
    assert got[-1]["loss"] < got[0]["loss"]


def test_eigen_launcher_matches_jax(monkeypatch):
    launcher_run(*SMOLLM, 6, monkeypatch, jax_steps=21)
