"""The paper's first-order baselines in the port (SGD with momentum, Adam;
``repro_torch/optimizers/baselines.py``) against live runs of the JAX
reference, on the CPU, and the optimizer race of
``benchmarks/bench_optimizer_race.py`` run by both.

The race config is the reference's (``bench_optimizer_race.py:21``):
64-48-24-12 mirrored, tanh, Bernoulli loss, JAX's dense-init weights
(``init_params(PRNGKey(0), sparse=False)``), N 1024 from data seed 7, 30
steps of ``Trainer.fit`` (trainer seed 0; the K-FAC rows get JAX's
uniforms).  Rows: SGD with momentum 0.9 at lr 0.03, 0.1 and 0.3, Adam at
lr 1e-2, blkdiag K-FAC (lambda_init 3, T3 5, eta 1e-5, NS inverses) with
and without momentum.

Tolerances:
- step for step from the reference's state and parameters: the loss and
  both norms within rtol 1e-5, the new parameters and the optimizer state
  within 1e-4 (atol 1e-4 of each array's largest magnitude);
- free-running: SGD at lr 0.03 and 0.1 and Adam within rtol 1e-5 of the
  loss at every step (the largest deviation seen was 1.8e-6, SGD lr 0.1,
  step 15).  SGD at lr 0.3 is unstable (its loss climbs from 44.9 to
  56-71): within 1e-4 through step 11 (1.3e-5 at step 12), then within 30%
  (the largest seen: 20%, step 28; JAX against itself with its weights
  scaled by 1 + 1e-7 differs by 18% at step 28);
- the race's final losses: the stable first-order rows 1e-5, the lr 0.3
  row 30% as above, the K-FAC rows queue C's 2% (seen: 7.4e-6); every
  ordering of two rows' final losses that JAX's run shows holds in the
  port's.
- reduced whisper-small, 3 Adam steps from JAX's weights: the loss and
  both norms within rtol 1e-5 at each step; after them each leaf's update
  (new minus initial parameters) within 1e-3 of its norm (seen: 3.0e-4,
  the head) and each parameter within 2e-4 of its leaf's largest
  magnitude (seen: 1.4e-4, one entry of the head).  Adam divides each
  entry's first moment by its own RMS, so an entry whose gradient is small
  against its leaf's carries the leaf's rounding into its update (that
  head entry moved 1.198e-3 in the port, 1.271e-3 in the reference).
"""
import dataclasses
import functools
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optimizers as joptimizers
from repro.configs.base import KFACConfig as JKFACConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.pipeline import SyntheticAutoencoderData as JData
from repro.models.mlp import MLP as JMLP
from repro.training.trainer import Trainer as JTrainer
from repro_torch import optimizers
from repro_torch.configs.base import KFACConfig, TrainConfig
from repro_torch.convert import params_from_numpy, transform_state_from_numpy
from repro_torch.data.pipeline import SyntheticAutoencoderData
from repro_torch.launch import train
from repro_torch.models.lm import LM
from repro_torch.models.mlp import MLP
from repro_torch.training.trainer import Trainer
from repro_torch.utils import tree as T
from test_torch_whisper_parity import _setup as _whisper_setup

torch.set_num_threads(1)

DIMS = [64, 48, 24, 12, 24, 48, 64]
N, LATENT, DATA_SEED, STEPS = 1024, 8, 7, 30

# row -> (optimizer, its arguments); the K-FAC rows' config is
# bench_optimizer_race.py::run_kfac's
ROWS = {
    "sgd_momentum_lr0.03": ("sgd_momentum", {"lr": 0.03}),
    "sgd_momentum_lr0.1": ("sgd_momentum", {"lr": 0.1}),
    "sgd_momentum_lr0.3": ("sgd_momentum", {"lr": 0.3}),
    "adam_lr0.01": ("adam", {"lr": 1e-2}),
    "kfac_blkdiag": ("kfac", {"use_momentum": True}),
    "kfac_no_momentum": ("kfac", {"use_momentum": False}),
}
FIRST_ORDER = [r for r, (kind, _) in ROWS.items() if kind != "kfac"]
UNSTABLE = {"sgd_momentum_lr0.3": 11}     # row -> last step held to 1e-4
KFAC_BAND, UNSTABLE_BAND, STABLE_BAND = 0.02, 0.30, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _close_tree(got, want, rtol):
    if isinstance(want, dict):
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            _close_tree(got[k], want[k], rtol)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_tree(g, w, rtol)
    else:
        _close(got, want, rtol)


def _uniforms(seed, step, shape):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                step), 1)
    return torch.from_numpy(np.array(
        jax.random.uniform(key, shape, jnp.float32)))


@functools.lru_cache(maxsize=None)
def _setup():
    jmlp = JMLP(DIMS, nonlin="tanh", loss="bernoulli")
    jparams = jmlp.init_params(jax.random.PRNGKey(0), sparse=False)
    mlp = MLP(DIMS, device="cpu")
    return dict(jmlp=jmlp, jparams=jparams,
                jdata=JData(DIMS[0], LATENT, N, seed=DATA_SEED), mlp=mlp,
                params=params_from_numpy(_np(jparams), "cpu"),
                data=SyntheticAutoencoderData(DIMS[0], LATENT, N,
                                              seed=DATA_SEED, device="cpu"))


def _kfac_cfg(cls, **kw):
    return cls(inv_mode="blkdiag", lambda_init=3.0, t3=5, fixed_lr=0.02,
               eta=1e-5, **kw)


@functools.lru_cache(maxsize=None)
def _jax_run(row):
    """A live JAX ``Trainer.fit`` of one race row, recording every
    optimizer step's inputs and outputs."""
    s = _setup()
    kind, kw = ROWS[row]
    opt = (joptimizers.kfac(s["jmlp"], _kfac_cfg(JKFACConfig, **kw),
                            family="bernoulli") if kind == "kfac"
           else joptimizers.get(kind, s["jmlp"], **kw))
    record = []

    def update(grads, state, params, batch, rng):
        out = opt.update(grads, state, params, batch, rng)
        record.append(_np((state, params, out[0], out[1])))
        return out

    tr = JTrainer(s["jmlp"], dataclasses.replace(opt, update=update),
                  JTrainConfig(steps=STEPS, seed=0, log_every=10_000_000),
                  None, None)
    hist = tr.fit(s["jparams"], s["jdata"], steps=STEPS,
                  log=lambda *_: None)["history"]
    return hist, record


def _port_opt(row):
    s = _setup()
    kind, kw = ROWS[row]
    if kind == "kfac":
        return optimizers.kfac(s["mlp"], _kfac_cfg(KFACConfig, **kw),
                               family="bernoulli", device="cpu")
    return optimizers.get(kind, s["mlp"], **kw)


@functools.lru_cache(maxsize=None)
def _port_run(row):
    s = _setup()
    tr = Trainer(s["mlp"], _port_opt(row),
                 TrainConfig(steps=STEPS, seed=0, log_every=10_000_000),
                 noise=lambda step, shape: _uniforms(0, step, shape),
                 device="cpu")
    return tr.fit(s["params"], s["data"], steps=STEPS,
                  log=lambda *_: None)["history"]


def test_race_problem_is_the_reference():
    s = _setup()
    np.testing.assert_array_equal(s["data"].x, s["jdata"].x)
    assert [h["loss"] for h in _port_run("adam_lr0.01")][0] == pytest.approx(
        _jax_run("adam_lr0.01")[0][0]["loss"], rel=1e-6)


@pytest.mark.parametrize("row", FIRST_ORDER)
def test_each_step_matches_jax_from_its_state(row):
    """Every optimizer step of the port, started from the reference's
    state (carried across by ``transform_state_from_numpy``) and
    parameters at that step, gives the reference's step."""
    want, record = _jax_run(row)
    s = _setup()
    opt = _port_opt(row)
    for step, (jstate, jparams, jnew, jout) in enumerate(record):
        params = params_from_numpy(jparams, "cpu")
        state = transform_state_from_numpy(vars(jstate), "cpu")
        if step == 0:
            _close_tree(opt.init(params, s["data"].batch(0)).inner,
                        jstate.inner, rtol=0.0)
        new, st, m = opt.update(None, state, params, s["data"].batch(step))
        assert set(m) >= {"loss", "grad_norm", "delta_norm"}
        for k in ("loss", "grad_norm", "delta_norm"):
            assert float(m[k]) == pytest.approx(want[step][k],
                                                rel=1e-5), (step, k)
        _close_tree(new, jnew, rtol=1e-4)
        _close_tree(st.inner, jout.inner, rtol=1e-4)
        assert st.step.dtype == torch.int32
        assert int(st.step) == int(jout.step) == step + 1


@pytest.mark.parametrize("row", FIRST_ORDER)
def test_trajectory_matches_live_jax(row):
    """Free-running: both trainers from the same weights, held to the
    bands of the module's docstring."""
    want, _ = _jax_run(row)
    got = _port_run(row)
    assert len(got) == len(want) == STEPS
    held = UNSTABLE.get(row, STEPS - 1)
    for step in range(STEPS):
        assert set(got[step]) == set(want[step]) - {"aux_loss"}, step
        band = (STABLE_BAND if row not in UNSTABLE
                else 1e-4 if step <= held else UNSTABLE_BAND)
        assert got[step]["loss"] == pytest.approx(want[step]["loss"],
                                                  rel=band), step


@pytest.mark.parametrize("row", list(ROWS))
def test_race_final_loss_matches_jax(row):
    want = _jax_run(row)[0][-1]["loss"]
    got = _port_run(row)[-1]["loss"]
    band = (KFAC_BAND if ROWS[row][0] == "kfac"
            else UNSTABLE_BAND if row in UNSTABLE else STABLE_BAND)
    assert math.isfinite(got)
    assert got == pytest.approx(want, rel=band)


def test_race_keeps_every_jax_ordering():
    """Every pair of rows whose final losses JAX's race orders keeps that
    order in the port's (JAX: K-FAC < K-FAC without momentum < Adam < the
    best SGD, the paper's claims on this config)."""
    want = {r: _jax_run(r)[0][-1]["loss"] for r in ROWS}
    got = {r: _port_run(r)[-1]["loss"] for r in ROWS}
    pairs = [(a, b) for a, b in itertools.permutations(ROWS, 2)
             if want[a] < want[b]]
    assert len(pairs) == len(ROWS) * (len(ROWS) - 1) // 2
    for a, b in pairs:
        assert got[a] < got[b], (a, got[a], b, got[b], want)


FULL_DIMS = [784, 1000, 500, 250, 30, 250, 500, 1000, 784]


@pytest.mark.parametrize("lr,climbs", [(0.03, True), (0.003, False)],
                         ids=["lr0.03-climbs", "lr0.003-falls"])
def test_full_width_sgd_rates(lr, climbs):
    """At the autoencoder's full width (784-1000-500-250-30 mirrored) the
    race's SGD rates are too large: the loss sums 784 outputs an example,
    not 64.  At lr 0.03 the reference and the port both climb, at 0.003
    both fall (N 256, JAX's sparse init, 12 steps): the first three losses
    within rtol 1e-4, then both above 1.5 times the first by step 11, or
    both below 0.75 times it."""
    jmlp = JMLP(FULL_DIMS, nonlin="tanh", loss="bernoulli")
    jparams = jmlp.init_params(jax.random.PRNGKey(0), sparse=True)
    jdata = JData(FULL_DIMS[0], LATENT, 256, seed=DATA_SEED)
    want = [h["loss"] for h in JTrainer(
        jmlp, joptimizers.sgd_momentum(jmlp, lr=lr),
        JTrainConfig(steps=12, seed=0, log_every=10_000), None, None).fit(
        jparams, jdata, steps=12, log=lambda *_: None)["history"]]
    mlp = MLP(FULL_DIMS, device="cpu")
    data = SyntheticAutoencoderData(FULL_DIMS[0], LATENT, 256,
                                    seed=DATA_SEED, device="cpu")
    got = [h["loss"] for h in Trainer(
        mlp, optimizers.sgd_momentum(mlp, lr=lr),
        TrainConfig(steps=12, seed=0), device="cpu").fit(
        params_from_numpy(_np(jparams), "cpu"), data, steps=12,
        log=lambda *_: None)["history"]]
    for step in range(3):
        assert got[step] == pytest.approx(want[step], rel=1e-4), step
    for losses in (want, got):
        if climbs:
            assert losses[-1] > 1.5 * losses[0], losses
        else:
            assert losses[-1] < 0.75 * losses[0], losses


# ---------------------------------------------------------------------------
# reduced whisper-small: Adam on the LM
# ---------------------------------------------------------------------------

WHISPER_STEPS = 3


@functools.lru_cache(maxsize=None)
def _whisper_jax_adam():
    s = _whisper_setup()
    tr = JTrainer(s["jl"], joptimizers.adam(s["jl"], lr=1e-3),
                  JTrainConfig(steps=WHISPER_STEPS, seed=0,
                               log_every=10_000), None, None)
    out = tr.fit(s["jp"], s["jdata"], steps=WHISPER_STEPS,
                 log=lambda *_: None)
    return out["history"], _np(out["params"])


def test_reduced_whisper_adam_matches_jax():
    """3 Adam steps of reduced whisper-small from JAX's weights (carried
    across by ``lm_params_from_numpy``), the launcher's batch 8 and seq
    64: the loss at every step and the parameters after them."""
    want, jparams = _whisper_jax_adam()
    s = _whisper_setup()
    out = Trainer(s["lm"], optimizers.adam(s["lm"], lr=1e-3),
                  TrainConfig(steps=WHISPER_STEPS, seed=0,
                              log_every=10_000), device="cpu").fit(
        s["params"], s["data"], steps=WHISPER_STEPS, log=lambda *_: None)
    got = out["history"]
    assert len(got) == len(want) == WHISPER_STEPS
    for step in range(WHISPER_STEPS):
        for k in ("loss", "grad_norm", "delta_norm"):
            assert got[step][k] == pytest.approx(want[step][k],
                                                 rel=1e-5), (step, k)
    _close_tree(out["params"], jparams, rtol=2e-4)

    def update_close(path, new, old):
        du = new - old
        dw = torch.as_tensor(np.array(T.get_path(jparams, path))) - old
        assert torch.linalg.norm(du - dw) <= 1e-3 * torch.linalg.norm(dw), \
            path

    T.tree_map_with_path(update_close, out["params"], s["params"])
    assert got[-1]["loss"] < got[0]["loss"]


def test_train_launcher_runs_adam_on_cpu():
    """``launch/train.py --optimizer adam --lr`` trains reduced whisper
    with Adam at that rate: the same history as ``Trainer.fit`` of
    ``optimizers.adam`` from the launcher's weights (seed 0)."""
    lines = []
    res = train.main(["--arch", "whisper-small", "--reduced", "--steps", "3",
                      "--optimizer", "adam", "--lr", "3e-3", "--device",
                      "cpu"], log=lines.append)
    assert any("optimizer=adam" in line for line in lines), lines
    hist = res["history"]
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]

    base = _whisper_setup()
    lm = LM(base["lm"].cfg, device="cpu")
    params = lm.init_params(torch.Generator().manual_seed(0))
    want = Trainer(lm, optimizers.adam(lm, lr=3e-3),
                   TrainConfig(steps=3), device="cpu").fit(
        params, base["data"], 3, log=lambda *_: None)["history"]
    assert [h["loss"] for h in hist] == [h["loss"] for h in want]
    assert [h["delta_norm"] for h in hist] == [h["delta_norm"]
                                               for h in want]
