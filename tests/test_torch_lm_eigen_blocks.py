"""EKFAC with block sides: reduced gemma2-2b at ``max_factor_dim`` 64
(the MLP's d_ff sides of 128 in 2 blocks: gate and up full/block, down
block/full) against a live JAX ``Trainer.fit`` of the reference
launcher's setup, on the CPU, with the harness and bands of
``test_torch_lm_eigen_trajectory.py`` (μ also within 1e-3 of the run's
median |μ|, queue C's band for gemma2).  One 11-step JAX run serves the
step-for-step, the free-running and the launcher's test; a second runs
the staggered refresh in eigen mode (``refresh_mode="staggered"``: after
the three warmup refreshes, one cost-balanced group of blocks
re-decomposed a step: steps 3 and 4), free-running for 5 steps.
"""
import torch

from test_torch_lm_eigen_trajectory import (free_run, launcher_run,
                                           step_for_step)

torch.set_num_threads(1)

EIGEN = ("gemma2-2b", 64, (("inv_mode", "eigen"),))
STAGGERED = ("gemma2-2b", 64, (("inv_mode", "eigen"),
                               ("refresh_mode", "staggered")))


def test_each_step_matches_jax_from_its_state():
    state = step_for_step(*EIGEN, 11)
    # block bases: (S, nb, db, db) on the d_ff sides
    assert tuple(state.inv["blk0.mlp.gate"]["qg"].shape) == (1, 2, 64, 64)
    assert tuple(state.inv["blk0.mlp.down"]["qa"].shape) == (1, 2, 64, 64)
    assert tuple(state.inv["blk0.mlp.down"]["s"].shape) == (1, 128, 64)


def test_trajectory_matches_live_jax():
    got, _ = free_run(*EIGEN, 11)
    assert got[-1]["loss"] < got[0]["loss"]


def test_staggered_eigen_trajectory_matches_live_jax():
    got, _ = free_run(*STAGGERED, 5)
    assert got[-1]["loss"] < got[0]["loss"]


def test_eigen_launcher_matches_jax(monkeypatch):
    """``launch/train.py --inv_mode eigen`` with ``max_factor_dim`` 64."""
    eng = launcher_run(*EIGEN, 6, monkeypatch, jax_steps=11)
    assert type(eng.blocks["blk0.mlp.down"]).__name__ == "BlockDiagKronecker"
