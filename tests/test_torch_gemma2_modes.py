"""Reduced gemma2-2b with block-diagonal factors (``max_factor_dim`` 48)
in the modes the launcher offers, 6 steps of ``Trainer.fit`` free-running
in the port against a live JAX ``Trainer.fit`` on the CPU, held to
ROADMAP queue C's bands as ``test_torch_gemma2_trajectory.py`` holds its
runs:

* ``refresh_mode="staggered"``: the T3 refresh spread over T3 steps in
  the planner's cost-balanced groups (a block side costs nb·db³);
* ``tau1=0.5``: the statistics of every second sequence.
"""
import pytest
import torch

from test_torch_gemma2_trajectory import free_run_matches_live_jax

torch.set_num_threads(1)

MODES = {"staggered": (("refresh_mode", "staggered"),),
         "tau1": (("tau1", 0.5),)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_matches_live_jax(mode):
    free_run_matches_live_jax(48, 6, MODES[mode])
