"""Optimizer-agnostic training loop; mirrors ``repro/training/trainer.py``.

Per step it calls ``opt.update(None, state, params, batch, rng)`` and lets
the optimizer run its own schedule (for K-FAC, paper Algorithm 2 driven off
the step counter by ``KFACPipeline``).

Fault tolerance, as in the reference:
  * atomic async checkpoints every ``checkpoint_every`` steps (params and
    the whole optimizer state), restored at the start of ``fit``; a
    restored K-FAC run re-arms its three warmup refreshes at the restored
    step (``KFACPipeline.init``), as the reference's does;
  * a curvature bundle beside the checkpoint at steps divisible by
    ``curvature_every`` (``repro_torch.curvature``);
  * SIGTERM preemption: a blocking checkpoint at the next step, then a
    clean exit.  The reference installs its handler when the trainer is
    built and never removes it; here it is installed only when there is a
    checkpointer to save to, for the duration of ``fit``, and the previous
    handler is put back when ``fit`` returns, so that a run with nothing
    to save, and a process that goes on after training, stay killable;
  * a non-finite update is skipped (params untouched, ``opt.reject``
    applied) rather than poisoning the run.
Telemetry waits for its slice.

Random numbers: the reference draws the sampled targets of step ``s`` from
``fold_in(fold_in(PRNGKey(seed), s), 1)``.  The port takes a
``noise(step, shape) -> uniforms`` callable instead; the default draws from
a ``torch.Generator`` on the device seeded from ``(seed, step)``, and tests
pass JAX's uniforms to follow the reference step for step.  Both are keyed
by the step, so a resumed run draws what an uninterrupted one does.
"""
from __future__ import annotations

import os
import signal
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.curvature.bundle import BundleWriter, snapshot_bundle
from repro_torch.training.checkpoint import Checkpointer
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
                 noise: Optional[Noise] = None, device="cuda",
                 checkpointer: Optional[Checkpointer] = None):
        self.model = model
        self.opt = opt
        self.tc = train_cfg
        self.device = resolve_device(device)
        self.noise = noise or seeded_noise(train_cfg.seed, self.device)
        self.ckpt = checkpointer
        self._preempted = False
        self._bundle_writer = None

    # ------------------------------------------------------------------
    def _install_handler(self):
        """Set the SIGTERM handler that flags a preemption.  Returns
        ``(installed, previous handler)``; nothing is installed without a
        checkpointer or off the main thread."""
        def handler(signum, frame):
            self._preempted = True
        if self.ckpt is None:
            return False, None
        try:
            return True, signal.signal(signal.SIGTERM, handler)
        except ValueError:
            return False, None      # not on the main thread

    def fit(self, params, data, steps: int, start_step: int = 0,
            log=print) -> Dict[str, Any]:
        self._preempted = False
        installed, previous = self._install_handler()
        try:
            return self._fit(params, data, steps, start_step, log)
        finally:
            if installed:
                # None: the previous handler was not set from Python
                signal.signal(signal.SIGTERM, signal.SIG_DFL
                              if previous is None else previous)

    def _fit(self, params, data, steps, start_step, log) -> Dict[str, Any]:
        batch0 = data.batch(start_step)
        state = self.opt.init(params, batch0)

        # auto-restore
        if self.ckpt is not None:
            got_step, got = self.ckpt.restore({"params": params,
                                               "state": state})
            if got_step is not None:
                params, state = got["params"], got["state"]
                start_step = got_step
                log(f"[trainer] restored checkpoint at step {got_step}")

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

            if self.ckpt is not None and (
                    (step + 1) % self.tc.checkpoint_every == 0):
                bundle_ref = self._export_bundle(step + 1, state, log)
                self.ckpt.save(step + 1, {"params": params, "state": state},
                               curvature_bundle=bundle_ref)

            if self._preempted:
                log(f"[trainer] preempted at step {step}; checkpointing")
                self.ckpt.save(step + 1, {"params": params, "state": state},
                               block=True)
                break

        if self.ckpt is not None:
            self.ckpt.wait()
        if self._bundle_writer is not None:
            self._bundle_writer.wait()
        return {"params": params, "state": state, "history": history,
                "seconds": time.time() - t_start}

    # ------------------------------------------------------------------
    def _export_bundle(self, step: int, state, log) -> Optional[str]:
        """Curvature-bundle export at checkpoint steps
        (``TrainConfig.curvature_every``; 0 = off), without blocking the
        step: the snapshot keeps references to the state's tensors, and the
        :class:`~repro_torch.curvature.bundle.BundleWriter` thread copies
        and writes them.  Returns the manifest-relative bundle path, or
        None (also for first-order optimizers, which carry no curvature)."""
        if (not self.tc.curvature_every
                or step % self.tc.curvature_every != 0):
            return None
        bundle = snapshot_bundle(getattr(self.opt, "engine", None), state)
        if bundle is None:
            return None
        if self._bundle_writer is None:
            self._bundle_writer = BundleWriter()
        rel = os.path.join("curvature", f"step_{step:08d}")
        self._bundle_writer.write_async(
            os.path.join(self.ckpt.dir, rel), bundle)
        log(f"[trainer] step {step - 1}: curvature bundle -> {rel}")
        return rel
