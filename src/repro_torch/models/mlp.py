"""MLP / deep-autoencoder models — the paper's own experimental family (S13).

Mirrors ``repro/models/mlp.py``: homogeneous coordinates (``ā = [a; 1]`` so
the bias is the last row of each W), tanh units, Bernoulli (cross-entropy)
or Gaussian (squared-error) reconstruction loss.  Parameters are a plain
dict ``{"W0": (d_in+1, d_out), ...}`` exactly as in JAX, so
``torch.func.jvp`` works on them directly and the tests compare like with
like.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.autoencoder import AutoencoderConfig
from repro_torch.core.tags import LayerMeta, Tagger
from repro_torch.utils.device import resolve_device

# (shape) -> float32 uniforms in [0, 1) on the model's device
Uniforms = Callable[[tuple], torch.Tensor]

LOSSES = ("bernoulli", "gaussian")
# jax.random.normal's lower bound: the float32 next to -1 toward 0
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal_from_uniforms(u: torch.Tensor) -> torch.Tensor:
    """Standard normals from uniforms in [0, 1), mapped as
    ``jax.random.normal`` maps the uniforms it draws: ``u`` onto [lo, 1)
    with lo = nextafter(−1, 0) in float32, then ``√2 · erfinv``.  So JAX's
    uniforms of a key give (to erfinv's rounding) its normals of that
    key."""
    v = torch.clamp(u.float() * (1.0 - _NORMAL_LO) + _NORMAL_LO,
                    min=_NORMAL_LO)
    return math.sqrt(2.0) * torch.erfinv(v)


def autoencoder_dims(cfg: AutoencoderConfig) -> List[int]:
    enc = list(cfg.encoder)
    return enc + enc[-2::-1]          # mirror decoder


class MLP:
    """Feed-forward net with K-FAC tags.  dims = [d0, d1, ..., dL]."""

    def __init__(self, dims: List[int], nonlin: str = "tanh",
                 loss: str = "bernoulli", device="cuda"):
        if loss not in LOSSES:
            raise ValueError(f"unknown loss {loss!r} (expected "
                             f"{' or '.join(LOSSES)})")
        self.dims = list(dims)
        self.n_layers = len(dims) - 1
        self.nonlin = {"tanh": torch.tanh, "relu": torch.relu}[nonlin]
        self.loss_kind = loss
        self.device = resolve_device(device)
        self.metas: Dict[str, LayerMeta] = {
            f"layer{i}": LayerMeta(
                name=f"layer{i}", param_path=(f"W{i}",),
                d_in=dims[i], d_out=dims[i + 1], kind="dense",
                has_bias=True)
            for i in range(self.n_layers)
        }
        self.layer_order = [f"layer{i}" for i in range(self.n_layers)]
        self.contract_map = {}            # fused_stats hooks (core/fused)
        self.gcontract_map = {}

    # -- params ---------------------------------------------------------
    def init_params(self, generator: Optional[torch.Generator] = None,
                    scale: float = None, sparse: bool = True):
        """Paper-style "sparse initialization" (Martens, 2010): each unit
        gets 15 nonzero incoming weights.  Drawn on the CPU from
        ``generator`` (so a seed gives the same weights on every device),
        then moved to the model's device.  The draws differ from JAX's
        ``init_params``; tests inject JAX's parameters instead."""
        g = generator if generator is not None else torch.Generator()
        params = {}
        for i in range(self.n_layers):
            d_in, d_out = self.dims[i], self.dims[i + 1]
            w = torch.randn(d_in, d_out, generator=g) * (scale or 1.0)
            if sparse and d_in > 15:
                # keep 15 random connections per output unit
                rank = torch.rand(d_out, d_in, generator=g).argsort(dim=1)
                w = torch.where(rank.T < 15, w, torch.zeros(()))
            else:
                w = w / d_in ** 0.5
            b = torch.zeros(1, d_out)
            params[f"W{i}"] = torch.cat([w, b], dim=0).to(self.device)
        return params

    # -- forward --------------------------------------------------------
    def logits(self, params, x, tg: Optional[Tagger] = None):
        tg = tg or Tagger("plain")
        a = x
        for i in range(self.n_layers):
            ab = torch.cat([a, a.new_ones(*a.shape[:-1], 1)], dim=-1)
            s = ab @ params[f"W{i}"]
            s = tg.tag(f"layer{i}", ab, s)
            a = s if i == self.n_layers - 1 else self.nonlin(s)
        return a

    def _nll(self, z, y):
        if self.loss_kind == "bernoulli":
            # - sum_j [ y log sigmoid(z) + (1-y) log(1 - sigmoid(z)) ]
            return torch.sum(torch.logaddexp(torch.zeros_like(z), z) - y * z,
                             dim=-1)
        return 0.5 * torch.sum((z - y) ** 2, dim=-1)      # gaussian

    def sample_targets(self, z, uniforms: Uniforms):
        """Bernoulli draws ``u < sigmoid(z)`` (``jax.random.bernoulli`` is
        ``uniform(key) < p``), or Gaussian ones ``z + n`` with ``n`` the
        normals of the same uniforms (:func:`normal_from_uniforms`); so
        feeding JAX's uniforms reproduces its samples."""
        u = uniforms(tuple(z.shape))
        if self.loss_kind == "bernoulli":
            return (u < torch.sigmoid(z)).to(z.dtype)
        return z + normal_from_uniforms(u).to(z.dtype)

    def loss(self, params, probes, batch, rng: Optional[Uniforms],
             mode: str = "plain"):
        """Returns ((loss_true, loss_sampled), aux) — the reference's
        contract.  ``rng`` supplies the uniforms behind the sampled targets;
        with ``rng=None`` no targets are drawn and ``loss_sampled`` is None
        (the reference draws them and discards the result)."""
        tg = Tagger(mode, probes, self.contract_map, self.gcontract_map)
        z = self.logits(params, batch["x"], tg)
        lt = torch.mean(self._nll(z, batch["y"]))
        ls = None
        if rng is not None:
            ys = self.sample_targets(z.detach(), rng)
            ls = torch.mean(self._nll(z, ys))
        return (lt, ls), {"recs": tg.out(), "metrics": {"loss": lt}}

    def make_probes(self, batch):
        """Zero probes ``(N, d_out)`` per layer, requiring grad."""
        n = batch["x"].shape[0]
        return {name: torch.zeros(n, m.d_out, device=batch["x"].device,
                                  requires_grad=True)
                for name, m in self.metas.items()}
