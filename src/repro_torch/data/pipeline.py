"""Deterministic synthetic data (mirrors ``repro/data/pipeline.py``).

The arrays are made with the reference's numpy code, so they are bitwise
equal to the JAX package's; they then live on the device as float32 tensors.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.utils.device import resolve_device


class SyntheticAutoencoderData:
    """Binary patterns from a low-dim latent — the autoencoder benchmark's
    stand-in for MNIST/CURVES/FACES in an offline setting."""

    def __init__(self, dim: int, latent: int, n: int, seed: int = 0,
                 device="cuda"):
        rng = np.random.default_rng(seed)
        z = rng.standard_normal((n, latent))
        w = rng.standard_normal((latent, dim)) * 1.5
        probs = 1.0 / (1.0 + np.exp(-(z @ w)))
        self.x = (rng.random((n, dim)) < probs).astype(np.float32)
        self.n = n
        self.device = resolve_device(device)
        self._x = torch.from_numpy(self.x).to(self.device)

    def batch(self, step: int, batch_size: Optional[int] = None):
        bs = batch_size or self.n
        idx = (torch.arange(bs, device=self.device) + step * bs) % self.n
        x = self._x.index_select(0, idx)
        return {"x": x, "y": x}
