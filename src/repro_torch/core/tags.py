"""Curvature tagging: how models expose per-layer (ā, g) pairs to K-FAC.

Mirrors ``repro/core/tags.py``.  For every layer ``s = ā W`` the paper needs
the inputs ``ā`` and the pre-activation gradients ``g = dL/ds`` per example
(S3, S5).  The zero-probe trick carries over to autograd directly: in collect
mode the forward computes ``s = ā W + p`` with ``p`` a zero tensor that
requires grad, so ``torch.autograd.grad(loss, p)`` is ``dL/ds`` per example.

The LM's layers are stacked over ``n_stack`` groups (the reference scans
over them): a stacked layer's probe carries a leading ``n_stack`` dim, of
which group ``i`` adds ``probe[i]`` (an ``unbind`` view, so the probe's
gradient comes back stacked), and the model stacks the group records.

Where the reference contracts ``aa = Σ a aᵀ`` inside its scanned forward
(``repro/models/lm.py::_contract_map``), the port records the raw ``a`` and
contracts it in the factor update (``kernels.factor_update`` over the
stacked (S, N, d) records): the same factors, one launch per stacked layer.
The ``contract`` / ``gcontract`` maps serve ``KFACConfig.fused_stats``
(``core/fused.py``) on the unstacked models (the MLP, the conv classifier).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class LayerMeta:
    """Static description of one K-FAC-tagged linear map."""

    name: str
    param_path: Tuple[Any, ...]     # path into the params tree -> weight
    d_in: int
    d_out: int
    kind: str = "dense"             # dense | conv | embed | head
    n_stack: int = 0                # >0: leading stack dim on weight/factors
    n_expert: int = 0               # >0: per-expert factors (not ported)
    a_kind: str = "full"            # full | diag | block
    g_kind: str = "full"
    a_blocks: int = 1               # block count when a_kind == "block"
    g_blocks: int = 1               # (core/factors.py::factor_layout)
    has_bias: bool = False          # homogeneous coordinate appended to ā
    probe_tshard: bool = False      # the reference's context-parallel probe
                                    # flag, set on the LM's self-attention
                                    # q/k/v as there; read by no code of
                                    # the port, carried by a bundle
    # convolution layers (kind == "conv", KFC — 1602.01407): the weight is a
    # (prod(conv_spatial)*conv_in [+1], d_out) matrix over tap-major patch
    # features [k, c]; d_in is the flattened patch width
    conv_spatial: Tuple[int, ...] = ()   # kernel spatial shape (K,) / (Kh, Kw)
    conv_stride: Tuple[int, ...] = ()    # window strides, same rank
    conv_in: int = 0                     # input channels C
    conv_pad: str = "VALID"              # lax padding ("SAME" | "VALID")

    @property
    def a_dim(self) -> int:
        return self.d_in + (1 if self.has_bias else 0)

    @property
    def g_dim(self) -> int:
        return self.d_out


class Tagger:
    """Forward-pass context. Modes:

    * ``plain``   — inference and the gradient pass; tags are no-ops (no
      contraction runs).
    * ``collect`` — add probes, record activations (the stats pass).

    ``contract``: name -> fn(a) giving the A side's ``Σ ā āᵀ``; a tag with
    an entry records ``{"aa": fn(a)}`` instead of the raw input.
    ``gcontract``: name -> fn(ds) giving ``Σ ds dsᵀ``, used where the
    layer's probe is the fused ``{"gg": ...}`` form (``core/fused.py``).
    """

    def __init__(self, mode: str = "plain",
                 probes: Optional[Dict[str, Any]] = None,
                 contract: Optional[Dict[str, Any]] = None,
                 gcontract: Optional[Dict[str, Any]] = None):
        if mode not in ("plain", "collect"):
            raise ValueError(f"unknown Tagger mode {mode!r}")
        self.mode = mode
        self.probes = probes or {}
        self.contract = contract or {}
        self.gcontract = gcontract or {}
        self.records: Dict[str, Any] = {}

    def _add_probe(self, name: str, s):
        """Add the layer's zero probe to ``s``, or for a fused ``{"gg"}``
        probe, route ``s`` through ``fused.apply_gprobe``."""
        if name not in self.probes:
            return s
        p = self.probes[name]
        if isinstance(p, dict):
            if name not in self.gcontract:
                raise KeyError(f"tag {name!r}: a fused {{'gg'}} probe needs "
                               "a gcontract entry (core/fused.g_contract)")
            from repro_torch.core import fused
            return fused.apply_gprobe(s, p["gg"], self.gcontract[name])
        return s + p

    def _record(self, name: str, key: str, x):
        fn = self.contract.get(name)
        x = x.detach()
        self.records[name] = {"aa": fn(x)} if fn is not None else {key: x}

    def tag(self, name: str, a, s):
        """Tag a dense map: ``a`` inputs (..., d_in), ``s`` outputs
        (..., d_out).  Returns ``s`` (plus probe in collect mode)."""
        if self.mode == "plain":
            return s
        self._record(name, "a", a)
        return self._add_probe(name, s)

    def tag_conv(self, name: str, x, s):
        """Tag a convolution: ``x`` the RAW (pre-im2col) input (B, *S, C),
        ``s`` the outputs (B, T_out, d_out).  Only the raw input is recorded
        (or its contraction): ``ConvKronecker`` reads the patches from it
        (a 1-D conv's through the ``patch_factor`` kernel on the card), so
        the record holds no im2col buffer."""
        if self.mode == "plain":
            return s
        self._record(name, "cx", x)
        return self._add_probe(name, s)

    def tag_embed(self, name: str, ids, s, mask):
        """Tag an embedding lookup: ``ids`` int tokens, ``s`` embeddings,
        ``mask`` the tokens' loss mask (the reference's Embed block reads it
        from the batch)."""
        if self.mode == "plain":
            return s
        self.records[name] = {"ids": ids, "mask": mask}
        return self._add_probe(name, s)

    def out(self) -> Dict[str, Any]:
        return self.records


def merge_records(*records: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for r in records:
        for k, v in r.items():
            if k in out:
                raise ValueError(f"duplicate K-FAC tag {k!r}")
            out[k] = v
    return out
