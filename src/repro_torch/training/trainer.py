"""Optimizer-agnostic training loop; mirrors ``repro/training/trainer.py``.

Per step it calls ``opt.update(None, state, params, batch, rng)`` and lets
the optimizer run its own schedule (for K-FAC, paper Algorithm 2 driven off
the step counter by ``KFACPipeline``).  A non-finite update is skipped
(params untouched, ``opt.reject`` applied) rather than poisoning the run.
Checkpoints, telemetry and curvature-bundle export wait for later slices.

Random numbers: the reference draws the sampled targets of step ``s`` from
``fold_in(fold_in(PRNGKey(seed), s), 1)``.  The port takes a
``noise(step, shape) -> uniforms`` callable instead; the default draws from
a ``torch.Generator`` on the device seeded from ``(seed, step)``, and tests
pass JAX's uniforms to follow the reference step for step.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.utils import tree as T
from repro_torch.utils.device import resolve_device

Noise = Callable[[int, tuple], torch.Tensor]


def seeded_noise(seed: int, device) -> Noise:
    """Uniforms in [0, 1) from a device generator seeded by (seed, step)."""
    device = torch.device(device)

    def noise(step: int, shape: tuple) -> torch.Tensor:
        s = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
        g = torch.Generator(device=device).manual_seed(s)
        return torch.rand(shape, generator=g, device=device)

    return noise


class Trainer:
    def __init__(self, model, opt, train_cfg: TrainConfig,
                 noise: Optional[Noise] = None, device="cuda"):
        self.model = model
        self.opt = opt
        self.tc = train_cfg
        self.device = resolve_device(device)
        self.noise = noise or seeded_noise(train_cfg.seed, self.device)

    def fit(self, params, data, steps: int, start_step: int = 0,
            log=print) -> Dict[str, Any]:
        batch0 = data.batch(start_step)
        state = self.opt.init(params, batch0)

        history = []
        t_start = time.time()
        for step in range(start_step, steps):
            batch = data.batch(step)
            rng = lambda shape, step=step: self.noise(step, shape)
            new_params, state, metrics = self.opt.update(
                None, state, params, batch, rng)

            # non-finite guard: skip poisoned updates, let the optimizer
            # react (K-FAC: 4x damping + momentum reset)
            finite = T.tree_isfinite(new_params)
            if "delta_norm" in metrics:
                finite = finite & torch.isfinite(metrics["delta_norm"])
            if bool(finite):
                params = new_params
            else:
                state = self.opt.reject(state)
                log(f"[trainer] step {step}: non-finite update SKIPPED "
                    f"(rejected by {self.opt.name})")

            # one host read for all scalar metrics of the step
            keys = [k for k, v in metrics.items() if v.dim() == 0]
            vals = torch.stack([metrics[k].float() for k in keys]).tolist()
            history.append(dict(zip(keys, vals)))
            if step % self.tc.log_every == 0:
                extras = " ".join(
                    f"{k}={history[-1][k]:.2e}" for k in ("alpha", "lam")
                    if k in history[-1])
                log(f"[trainer] step {step}: "
                    f"loss={history[-1]['loss']:.4f} {extras}".rstrip())

        return {"params": params, "state": state, "history": history,
                "seconds": time.time() - t_start}
