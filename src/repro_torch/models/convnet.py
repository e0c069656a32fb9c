"""Small conv classifier — the KFC experimental family (1602.01407 §5);
mirrors ``repro/models/convnet.py``.

Strided KFC-tagged 2-D convolutions (no pooling: every parameter sits in a
Kronecker block), the nonlinearity, a global average pool and one dense
softmax head with a homogeneous bias row.  Same model contract as
:class:`repro_torch.models.mlp.MLP`: ``metas``, ``loss`` returning
``((loss_true, loss_sampled), aux)``, ``make_probes`` and ``logits`` for
the exact-Fisher quadratic (``family="categorical"``), plus the
``contract_map`` / ``gcontract_map`` hooks that ``fused_stats`` installs.
Parameters are a plain dict ``{"conv0": (k·k·C_in + 1, C_out), ...,
"head": (C + 1, n_classes)}``, the reference's layout.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.conv_classifier import ConvClassifierConfig
from repro_torch.core.tags import LayerMeta, Tagger
from repro_torch.models import params as PM
from repro_torch.models.conv import conv, conv_meta, conv_out_len
from repro_torch.models.mlp import Uniforms
from repro_torch.utils.device import resolve_device

_TINY = torch.finfo(torch.float32).tiny


class ConvNet:
    """KFC-tagged CNN classifier.  Input x: (B, H, W, C) images."""

    def __init__(self, cfg: ConvClassifierConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.nonlin = {"tanh": torch.tanh, "relu": torch.relu}[cfg.nonlin]
        self.defs: Dict[str, PM.ParamDef] = {}
        self.metas: Dict[str, LayerMeta] = {}
        c_in, side = cfg.channels, cfg.image_size
        self._stages = []
        self._sides = []                 # output side of each conv
        for i, (c_out, k, stride) in enumerate(cfg.conv):
            name = f"conv{i}"
            self.defs[name] = PM.ParamDef((k * k * c_in + 1, c_out))
            self.metas[name] = conv_meta(
                name, (name,), spatial=(k, k), stride=(stride, stride),
                c_in=c_in, d_out=c_out, padding="SAME", bias=True)
            self._stages.append((name, c_in, (k, k), (stride, stride)))
            side = conv_out_len(side, k, stride, "SAME")
            self._sides.append(side)
            c_in = c_out
        self.defs["head"] = PM.ParamDef((c_in + 1, cfg.n_classes))
        self.metas["head"] = LayerMeta(
            name="head", param_path=("head",), d_in=c_in,
            d_out=cfg.n_classes, kind="dense", has_bias=True)
        self.contract_map = {}
        self.gcontract_map = {}           # fused_stats hooks (core/fused)

    # -- params ---------------------------------------------------------
    def init_params(self, generator: Optional[torch.Generator] = None):
        """The reference's initializer (normal, 1/sqrt(fan_in)) drawn on
        the CPU from ``generator``, the homogeneous bias rows zeroed, then
        moved to the model's device.  The draws differ from JAX's; tests
        carry JAX's ``init_params`` across instead."""
        g = generator if generator is not None else torch.Generator()
        params = PM.materialize(g, self.defs, device="cpu")
        for w in params.values():
            w[-1] = 0.0
        return {k: v.to(self.device) for k, v in params.items()}

    def n_params(self) -> int:
        return PM.count(self.defs)

    # -- forward --------------------------------------------------------
    def logits(self, params, x, tg: Optional[Tagger] = None):
        tg = tg or Tagger("plain")
        h = x
        side = self.cfg.image_size
        for (name, c_in, spatial, stride), out in zip(self._stages,
                                                     self._sides):
            b = h.shape[0]
            s = conv(tg, name, params[name], h.reshape(b, side, side, c_in),
                     spatial=spatial, stride=stride, padding="SAME")
            side = out
            h = self.nonlin(s)                      # (B, side², c_out)
        h = torch.mean(h, dim=1)                    # global average pool
        hb = torch.cat([h, h.new_ones(h.shape[0], 1)], dim=-1)
        z = hb @ params["head"]
        return tg.tag("head", hb, z)

    def sample_targets(self, z, uniforms: Uniforms):
        """``jax.random.categorical``'s Gumbel-max: ``argmax(z + gumbel)``
        with ``gumbel = −log(−log(max(u, tiny)))`` of uniforms ``u`` of z's
        shape, so feeding JAX's uniforms reproduces its samples."""
        u = torch.clamp(uniforms(tuple(z.shape)).float(), min=_TINY)
        return torch.argmax(z + (-torch.log(-torch.log(u))), dim=-1)

    def loss(self, params, probes, batch, rng: Optional[Uniforms],
             mode: str = "plain"):
        """((loss_true, loss_sampled), aux) — the reference's contract;
        ``aux["metrics"]`` holds the loss and the accuracy.  With
        ``rng=None`` no target is drawn and ``loss_sampled`` is None."""
        tg = Tagger(mode, probes, self.contract_map, self.gcontract_map)
        z = self.logits(params, batch["x"], tg)
        logp = torch.log_softmax(z, dim=-1)
        y = batch["y"].long()
        lt = -torch.mean(logp.gather(-1, y[:, None]))
        ls = None
        if rng is not None:
            ys = self.sample_targets(z.detach(), rng)
            ls = -torch.mean(logp.gather(-1, ys[:, None]))
        acc = torch.mean((torch.argmax(z.detach(), -1) == y).float())
        return (lt, ls), {"recs": tg.out(),
                          "metrics": {"loss": lt, "accuracy": acc}}

    # -- probes ---------------------------------------------------------
    def make_probes(self, batch):
        """Zero probes requiring grad, shaped like each tag's outputs:
        ``(B, side², C_out)`` per conv, ``(B, n_classes)`` for the head."""
        b = batch["x"].shape[0]
        dev = batch["x"].device
        shapes = {name: (b, side * side, self.metas[name].d_out)
                  for (name, *_), side in zip(self._stages, self._sides)}
        shapes["head"] = (b, self.cfg.n_classes)
        return {name: torch.zeros(shape, device=dev, requires_grad=True)
                for name, shape in shapes.items()}
