"""Curvature tagging: how models expose per-layer (ā, g) pairs to K-FAC.

Mirrors ``repro/core/tags.py``.  For every layer ``s = ā W`` the paper needs
the inputs ``ā`` and the pre-activation gradients ``g = dL/ds`` per example
(S3, S5).  The zero-probe trick carries over to autograd directly: in collect
mode the forward computes ``s = ā W + p`` with ``p`` a zero tensor that
requires grad, so ``torch.autograd.grad(loss, p)`` is ``dL/ds`` per example.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class LayerMeta:
    """Static description of one K-FAC-tagged linear map."""

    name: str
    param_path: Tuple[Any, ...]     # path into the params dict -> weight
    d_in: int
    d_out: int
    kind: str = "dense"             # dense (the only kind ported so far)
    a_kind: str = "full"            # full (diag / block: later slices)
    g_kind: str = "full"
    has_bias: bool = False          # homogeneous coordinate appended to ā

    @property
    def a_dim(self) -> int:
        return self.d_in + (1 if self.has_bias else 0)

    @property
    def g_dim(self) -> int:
        return self.d_out


class Tagger:
    """Forward-pass context. Modes:

    * ``plain``   — inference; tags are no-ops.
    * ``collect`` — add probes, record activations (the stats pass).
    """

    def __init__(self, mode: str = "plain",
                 probes: Optional[Dict[str, Any]] = None):
        if mode not in ("plain", "collect"):
            raise ValueError(f"unknown Tagger mode {mode!r}")
        self.mode = mode
        self.probes = probes or {}
        self.records: Dict[str, Any] = {}

    def tag(self, name: str, a, s):
        """Tag a dense map: ``a`` inputs (..., d_in), ``s`` outputs
        (..., d_out).  Returns ``s`` (plus probe in collect mode)."""
        if self.mode == "plain":
            return s
        self.records[name] = {"a": a.detach()}
        if name in self.probes:
            s = s + self.probes[name]
        return s

    def out(self) -> Dict[str, Any]:
        return self.records
