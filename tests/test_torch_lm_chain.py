"""The fused fixed-lr chain (``use_rescale=False``: D = −lr·Ā⁻¹VḠ⁻¹ + μ·M
with ΣD², then the KL and norm clips) on the LMs, against live JAX
``Trainer.fit`` runs of the reference launcher's setup on the CPU, with
the harness and bands of ``test_torch_lm_eigen_trajectory.py``: 11 steps
step for step and free-running on

* reduced smollm-135m, blkdiag (NS inverses), with momentum 0.9 and a KL
  clip of 1e-3: every stacked layer through the batched chain;
* reduced gemma2-2b at ``max_factor_dim`` 64 in eigen mode (the
  ``eigen=True`` chain: the eigen apply, then α·U + μ·M): the full/full
  layers through the batched ``rotate_rescale``, the block layers through
  matmul, the base class's composition on both.

ρ on the chain is a difference of two losses near 5.5 (m_delta is −1),
held to rtol 1e-3 or 1e-6 of the loss (ROADMAP queue C's band of the
fixed-lr paths).
"""
import math

import torch

from test_torch_lm_eigen_trajectory import free_run, step_for_step

torch.set_num_threads(1)

SMOLLM = ("smollm-135m", 8192, (("use_rescale", False),
                                ("fixed_momentum", 0.9),
                                ("kl_clip", 1e-3)))
GEMMA2 = ("gemma2-2b", 64, (("inv_mode", "eigen"), ("use_rescale", False)))


def test_each_step_matches_jax_from_its_state_blkdiag_clipped():
    step_for_step(*SMOLLM, 11)


def test_trajectory_matches_live_jax_blkdiag_clipped():
    got, _ = free_run(*SMOLLM, 11)
    assert all(0.0 < h["nu"] <= 1.0 for h in got)
    assert all(math.isfinite(h["delta_norm"]) and h["delta_norm"] > 0
               for h in got)


def test_each_step_matches_jax_from_its_state_eigen_blocks():
    step_for_step(*GEMMA2, 11)


def test_trajectory_matches_live_jax_eigen_blocks():
    free_run(*GEMMA2, 11)
