"""The port's KFC conv classifier as a whole against live runs of the JAX
reference, on the CPU (its path with ``fused_stats``, and the fused
autoencoder, in ``tests/test_torch_fused_parity.py``).

The conv setup is ``tests/test_golden.py::conv_golden_run``'s, built here
in both packages: the reduced conv classifier (8×8×2 images, convs (8, 3,
1) and (8, 3, 2), 4 classes), JAX's weights from ``PRNGKey(0)``, N = 128
images from data seed 7, ``lambda_init`` 3, T3 5, eta 1e-5, eigh inverses
unless named, with the uniforms behind JAX's ``jax.random.categorical``
handed to the port.  It is held against a live JAX run, never against the
``GOLDEN_CONV`` constants, which the reference itself fails on this tree
(ROADMAP queue C).

Step for step from JAX's state: loss, lambda, gamma, alpha, mu and rho
within rtol 1e-3, parameters and factors within 1e-4; eigen states only
through ``s``/``damp``-invariant quantities, the preconditioned U of a
fixed V (queue C: the eigh basis is not unique).  A step on which a
sampled class flips at a proven near tie (JAX's top-2 margin of
``z + gumbel`` below 1e-5) skips only that step's factor comparison.
Free-running: queue C's limit (``test_torch_modes_parity._hold_to_queue_c``).
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optimizers as joptimizers
from repro.configs.base import KFACConfig as JKFACConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.training.trainer import Trainer as JTrainer
from repro_torch.configs.base import KFACConfig, TrainConfig
from repro_torch.configs.conv_classifier import reduced
from repro_torch.convert import params_from_numpy, state_from_numpy
from repro_torch.models.convnet import ConvNet
from repro_torch.optimizers.kfac import kfac
from repro_torch.training.trainer import Trainer
from test_torch_conv import _cat_uniforms, _convnet_setup
from test_torch_modes_parity import _hold_to_queue_c
from test_torch_tridiag import _close, _close_tree, _np, _tt

torch.set_num_threads(1)

BASE = dict(lambda_init=3.0, t3=5, eta=1e-5)
EIGH = dict(BASE, inverse_method="eigh")
PATHS = {                      # path -> (KFACConfig fields, steps)
    "eigh": (EIGH, 25),
    "eigen": (dict(EIGH, inv_mode="eigen"), 25),
    "ns": (dict(BASE, inverse_method="ns"), 15),
}
FUSED_PATHS = {"eigh_fused_stats": (dict(EIGH, fused_stats=True), 25)}
ALL_PATHS = {**PATHS, **FUSED_PATHS}
KEYS = ("loss", "lam", "gamma", "alpha", "mu", "rho")
TIE = 1e-5


@functools.lru_cache(maxsize=None)
def _setup():
    return _convnet_setup()


@functools.lru_cache(maxsize=None)
def _jax_run(path):
    """A live JAX ``Trainer.fit`` of the conv setup on ``path``, recording
    every optimizer step's inputs and outputs."""
    kw, steps = ALL_PATHS[path]
    s = _setup()
    opt = joptimizers.kfac(s["jnet"], JKFACConfig(**kw),
                           family="categorical")
    record = []

    def update(grads, state, params, batch, rng):
        out = opt.update(grads, state, params, batch, rng)
        record.append(_np((state, params, out[0], out[1])))
        return out

    tr = JTrainer(s["jnet"], dataclasses.replace(opt, update=update),
                  JTrainConfig(steps=steps, seed=0, log_every=10_000),
                  None, None)
    hist = tr.fit(s["jparams"], s["jdata"], steps=steps,
                  log=lambda *_: None)["history"]
    return hist, record


def _port_opt(path, **over):
    kw = dict(ALL_PATHS[path][0], **over)
    # a model of its own: a fused engine installs hooks on its model
    return kfac(ConvNet(reduced(), device="cpu"), KFACConfig(**kw),
                family="categorical", device="cpu")


def _port_fit(path, **over):
    s, steps = _setup(), ALL_PATHS[path][1]
    opt = _port_opt(path, **over)
    tr = Trainer(opt.engine.model, opt,
                 TrainConfig(steps=steps, seed=0, log_every=10_000),
                 noise=lambda step, shape: _cat_uniforms(0, step, shape),
                 device="cpu")
    return tr.fit(s["params"], s["data"], steps=steps, log=lambda *_: None)


def _flipped_classes(jparams, step):
    """JAX's top-2 margins of ``z + gumbel`` on the rows whose sampled
    class the port draws otherwise (the logits of the two packages differ
    by float32 rounding)."""
    s = _setup()
    b = s["data"].batch(step)
    z = s["net"].logits(params_from_numpy(jparams, "cpu"), b["x"])
    u = _cat_uniforms(0, step, tuple(z.shape))
    got = s["net"].sample_targets(z, lambda shape: u).numpy()
    jz = np.asarray(s["jnet"].logits(jparams, jnp.asarray(b["x"].numpy())))
    noisy = jz + np.asarray(-jnp.log(-jnp.log(jnp.asarray(u.numpy()))))
    want = noisy.argmax(-1)
    top2 = np.sort(noisy, axis=-1)[:, -2:]
    return (top2[:, 1] - top2[:, 0])[got != want]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_each_step_matches_jax_from_its_state(path):
    """Step for step: every optimizer step of the port, started from the
    reference's state and parameters at that step with the same uniforms,
    gives the reference's step (the warmup and T3 refreshes, the T1 lambda
    rule, the step-20 sweep where the run reaches it)."""
    check_each_step(path)


def check_each_step(path):
    want, record = _jax_run(path)
    s = _setup()
    opt = _port_opt(path)
    eng = opt.engine
    rng = np.random.default_rng(13)
    v = {n: torch.from_numpy(rng.standard_normal((m.a_dim, m.g_dim)).astype(
        np.float32)) for n, m in s["net"].metas.items()}
    for step, (jstate, jparams, jnew, jout) in enumerate(record):
        params = params_from_numpy(jparams, "cpu")
        if step == 0:
            opt.init(params, s["data"].batch(0))
        new, state, m = opt.update(
            None, state_from_numpy(vars(jstate), "cpu"), params,
            s["data"].batch(step),
            lambda shape, step=step: _cat_uniforms(0, step, shape))
        for k in (*KEYS, "loss_sampled", "accuracy"):
            assert (k in m) == (k in want[step]), (step, k)
        for k in KEYS:
            if k in m:
                assert float(m[k]) == pytest.approx(want[step][k],
                                                    rel=1e-3), (step, k)
        assert float(m["accuracy"]) == want[step]["accuracy"], step
        _close_tree(new, jnew, rtol=1e-4)
        flipped = _flipped_classes(jparams, step)
        assert (flipped < TIE).all(), (step, flipped)
        if not flipped.size:
            _close_tree(state.factors, jout.factors, rtol=1e-4)
        if eng.eigen:
            jinv = _tt(jout.inv)
            for name, blk in eng.blocks.items():
                _close(blk.precondition_eigen(state.inv[name], v[name]),
                       blk.precondition_eigen(jinv[name], v[name]),
                       rtol=1e-3)
        assert int(state.step) == int(jout.step) == step + 1


@pytest.mark.parametrize("path", sorted(PATHS))
def test_trajectory_matches_live_jax(path):
    """Free-running: the port's ``Trainer.fit`` from JAX's weights with
    JAX's uniforms against the live JAX run, held to queue C's limit."""
    check_trajectory(path)


def check_trajectory(path):
    want, _ = _jax_run(path)
    got = _port_fit(path)["history"]
    _hold_to_queue_c(got, want)
    if len(want) > 20:
        assert got[20]["gamma"] == pytest.approx(want[20]["gamma"],
                                                 rel=1e-6)


def test_tridiag_is_blkdiag_on_the_convnet():
    """The ConvNet has no ``layer_order``: tridiag runs the block-diagonal
    path, bit for bit the blkdiag run (the reference's own fallback)."""
    a = _port_fit("eigh")
    b = _port_fit("eigh", inv_mode="tridiag")
    assert a["history"] == b["history"]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k])
