"""Deterministic synthetic data (mirrors ``repro/data/pipeline.py``).

The arrays are made with the reference's numpy code, so they are bitwise
equal to the JAX package's; they then live on the device (float32 data,
int32 tokens).  Every batch is a pure function of (seed, step).
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


class SyntheticLMData:
    """Markov-chain token stream: learnable (next token is a noisy affine
    function of the current), deterministic per (seed, step); the
    reference's numpy draws, bitwise."""

    def __init__(self, vocab: int, seq: int, global_batch: int, seed: int = 0,
                 noise: float = 0.1, device="cuda"):
        self.vocab, self.seq, self.gb = vocab, seq, global_batch
        self.seed, self.noise = seed, noise
        self.a = 6364136223846793005 % max(vocab - 1, 1) + 1
        self.c = 1442695040888963407 % vocab
        self.device = resolve_device(device)

    def numpy_batch(self, step: int):
        rng = np.random.default_rng((self.seed, step))
        t0 = rng.integers(0, self.vocab, size=(self.gb, 1))
        toks = [t0]
        for _ in range(self.seq):
            nxt = (toks[-1] * self.a + self.c) % self.vocab
            flip = rng.random((self.gb, 1)) < self.noise
            rand = rng.integers(0, self.vocab, size=(self.gb, 1))
            toks.append(np.where(flip, rand, nxt))
        stream = np.concatenate(toks, axis=1).astype(np.int32)
        return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}

    def batch(self, step: int):
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.numpy_batch(step).items()}


class SyntheticImageData:
    """Class-template images for the conv classifier: ``y`` picks one of
    ``n_classes`` fixed random templates, ``x`` is that template plus pixel
    noise — learnable, deterministic per (seed, step); the reference's
    numpy draws, bitwise.  Each batch is drawn on the host, as in the
    reference, then moved to the device: x ``(B, H, W, C)`` float32, y
    ``(B,)`` int32."""

    def __init__(self, image_size: int, channels: int, n_classes: int,
                 n: int, seed: int = 0, noise: float = 0.3, device="cuda"):
        rng = np.random.default_rng(seed)
        self.templates = rng.standard_normal(
            (n_classes, image_size, image_size, channels)).astype(np.float32)
        self.n_classes, self.n, self.noise = n_classes, n, noise
        self.seed = seed
        self.device = resolve_device(device)

    def numpy_batch(self, step: int, batch_size: Optional[int] = None):
        bs = batch_size or self.n
        rng = np.random.default_rng((self.seed, step))
        y = rng.integers(0, self.n_classes, size=(bs,)).astype(np.int32)
        x = (self.templates[y]
             + self.noise * rng.standard_normal(
                 self.templates[y].shape).astype(np.float32))
        return {"x": x, "y": y}

    def batch(self, step: int, batch_size: Optional[int] = None):
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.numpy_batch(step, batch_size).items()}


def make_audio_batch(base, n_mels: int, n_frames: int, step: int = 0):
    """Raw log-mel frames (B, n_frames, n_mels) for the audio frontend,
    drawn from ``default_rng((11, step))`` as the reference draws them, on
    the device of ``base``'s tokens."""
    b = base["tokens"].shape[0]
    rng = np.random.default_rng((11, step))
    mels = rng.standard_normal((b, n_frames, n_mels)).astype(np.float32)
    return dict(base, mels=torch.from_numpy(mels).to(base["tokens"].device))
