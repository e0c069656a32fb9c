"""Reduced gemma2-2b with block-diagonal factors (``max_factor_dim`` 48),
21 steps of ``Trainer.fit`` free-running in the port against a live JAX
``Trainer.fit`` on the CPU, through the step-20 γ sweep: the three
candidates' block-shaped inverses stacked (3, S, nb, db, db) and the same
γ picked; held to ROADMAP queue C's bands as
``test_torch_gemma2_trajectory.py`` holds its runs.
"""
import torch

from test_torch_gemma2_trajectory import free_run_matches_live_jax

torch.set_num_threads(1)


def test_sweep_run_matches_live_jax():
    free_run_matches_live_jax(48, 21, ())
