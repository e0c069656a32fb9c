"""Sampling layer for the serving engine: greedy / top-k / top-p with
per-request seeds (mirrors ``repro/serving/sampling.py``).

Determinism contract
--------------------
A request's token stream is a pure function of ``(its logits, its sampling
params, its seed, the token index within its own stream)``:

* greedy (``temperature <= 0``) is exactly ``int(np.argmax(row))`` — the
  first index on ties;
* seeded sampling draws token ``i`` from a Gumbel source keyed on
  ``(seed, i)`` only, so the stream does not depend on batch composition,
  admission order or preemption replays;
* top-k keeps the ``k`` highest logits (ties broken by lowest token id,
  stable); top-p keeps the smallest prefix of the descending-probability
  ordering whose mass reaches ``p`` (always at least one token).

Filtering runs in float64 numpy on the host, one row per sampled token.
The draw is the Gumbel-max trick in float32, ``argmax(filtered + g)``, which
is what the reference's ``jax.random.categorical`` computes.  The JAX PRNG
cannot be reproduced in torch, so the noise comes from a *Gumbel source*
``gumbel(seed, index, n) -> (n,) float32``: by default
:func:`torch_gumbel`, a ``torch.Generator`` seeded from ``(seed, index)``;
a test injects the reference's ``jax.random.gumbel(fold_in(PRNGKey(seed),
index), (n,))`` and gets the reference's tokens.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

NEG_INF = float("-inf")

# (seed, token index, vocab size) -> (vocab,) float32 Gumbel(0, 1) draws
GumbelSource = Callable[[int, int, int], np.ndarray]


def gumbel_from_generator(gen: torch.Generator, n: int) -> np.ndarray:
    """``n`` float32 Gumbel(0, 1) draws, ``-log(-log(u))`` with u uniform
    in [tiny, 1), from ``gen``."""
    u = torch.rand(n, generator=gen, dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).numpy()


def torch_gumbel(seed: int, index: int, n: int) -> np.ndarray:
    """The port's own Gumbel source: a CPU ``torch.Generator`` seeded from
    ``(seed, index)`` through ``numpy.random.SeedSequence``."""
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)
    gen = torch.Generator().manual_seed(int(state[0]))
    return gumbel_from_generator(gen, n)


def filter_logits(row: np.ndarray, *, top_k: int = 0,
                  top_p: float = 1.0) -> np.ndarray:
    """Mask ``row`` down to the top-k / nucleus-p support (float64 copy;
    masked entries are ``-inf``).  ``top_k=0`` / ``top_p>=1`` disable the
    respective filter.  At least one token always survives."""
    row = np.asarray(row, np.float64).copy()
    if top_k and top_k < row.size:
        # stable order: descending value, ascending token id on ties
        order = np.lexsort((np.arange(row.size), -row))
        row[order[top_k:]] = NEG_INF
    if 0.0 < top_p < 1.0:
        order = np.lexsort((np.arange(row.size), -row))
        sorted_row = row[order]
        probs = np.exp(sorted_row - sorted_row.max())
        probs /= probs.sum()
        keep = np.cumsum(probs) - probs < top_p   # first token always kept
        row[order[~keep]] = NEG_INF
    return row


def gumbel_argmax(filtered: np.ndarray, noise: np.ndarray) -> int:
    """The categorical draw: ``argmax(noise + logits)`` in float32."""
    return int(np.argmax(np.asarray(noise, np.float32)
                         + np.asarray(filtered, np.float32)))


def sample_token(row, *, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: Optional[int] = None,
                 index: int = 0, gumbel: GumbelSource = torch_gumbel) -> int:
    """One token from one logits row.  Greedy when ``temperature <= 0``;
    otherwise a seeded temperature/top-k/top-p draw keyed on
    ``(seed, index)`` only (seed ``None`` keys as 0, as in the reference)."""
    row = np.asarray(row)
    if temperature <= 0:
        return int(np.argmax(row))
    filtered = filter_logits(row.astype(np.float64) / float(temperature),
                             top_k=top_k, top_p=top_p)
    noise = gumbel(0 if seed is None else seed, index, filtered.size)
    return gumbel_argmax(filtered, noise)
