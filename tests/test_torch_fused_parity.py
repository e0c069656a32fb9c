"""The backward-pass fused statistics (``KFACConfig.fused_stats``,
``core/fused.py``) as a whole against live runs of the JAX reference, on
the CPU: the reduced conv classifier with ``fused_stats`` (the setup of
``tests/test_torch_conv_parity.py``, step for step and free-running), and
the reduced autoencoder against a live ``golden_run(inv_mode,
fused_stats=True)`` of ``tests/test_golden.py`` (JAX's weights and
uniforms), each held to ROADMAP queue C's limit
(``test_torch_modes_parity._hold_to_queue_c``).
"""
import pytest
import torch

from repro_torch.configs.base import KFACConfig, TrainConfig
from repro_torch.models.mlp import MLP
from repro_torch.optimizers.kfac import kfac
from repro_torch.training.trainer import Trainer
from test_golden import golden_run
from test_torch_conv_parity import (EIGH, FUSED_PATHS, check_each_step,
                                    check_trajectory)
from test_torch_modes_parity import _golden, _hold_to_queue_c
from test_torch_tridiag_parity import _uniforms

torch.set_num_threads(1)


@pytest.mark.parametrize("path", sorted(FUSED_PATHS))
def test_conv_each_step_matches_jax_from_its_state(path):
    """The conv classifier with ``fused_stats``, step for step from JAX's
    state (queue C's rtol 1e-3; parameters and factors 1e-4)."""
    check_each_step(path)


@pytest.mark.parametrize("path", sorted(FUSED_PATHS))
def test_conv_trajectory_matches_live_jax(path):
    """The conv classifier with ``fused_stats``, free-running against the
    live JAX run with ``fused_stats``."""
    check_trajectory(path)


@pytest.mark.parametrize("inv_mode", ["blkdiag", "eigen"])
def test_fused_autoencoder_matches_live_golden_run(inv_mode):
    """``golden_run(inv_mode, fused_stats=True)`` itself (eigh, 25 steps),
    live, against the port's fused run of the same setup (JAX's weights
    and uniforms), held to queue C's limit."""
    want = golden_run(inv_mode, steps=25, fused_stats=True,
                      return_history=True)
    g = _golden()
    mlp = MLP(g["mlp"].dims, device="cpu")
    opt = kfac(mlp, KFACConfig(**dict(EIGH, inv_mode=inv_mode,
                                      fused_stats=True)),
               family="bernoulli", device="cpu")
    assert opt.engine.fused_names == set(mlp.metas)
    got = Trainer(mlp, opt, TrainConfig(steps=25, seed=0, log_every=10_000),
                  noise=lambda step, shape: _uniforms(0, step, shape),
                  device="cpu").fit(g["params"], g["data"], steps=25,
                                    log=lambda *_: None)["history"]
    _hold_to_queue_c(got, want)
    assert got[20]["gamma"] == pytest.approx(want[20]["gamma"], rel=1e-6)
