"""Block-tridiagonal chain block (paper S4.3, Appendix B).

Mirrors ``repro/core/blocks/chain.py``.  Chain models (the paper's
MLP/autoencoder family) support the richer tridiagonal inverse
approximation ``F̂⁻¹ = Ξᵀ Λ Ξ``, which couples consecutive layers through
cross moments ``Ā_{i,i+1}``, ``G_{i,i+1}``.  That coupling does not fit the
one-layer :class:`CurvatureBlock` contract exactly, so :class:`TridiagChain`
is the chain-level analogue: its "factor" state is the cross-moment dict
stored under the ``__cross__`` key, its "inverse" is the precomputed Ψ/Σ
cache stored under ``__tri__``, and its apply preconditions *all* chain
layers at once (the per-layer blocks still own the diagonal factors it
reads).  Numerics live in ``core.tridiag``; no kernel of
``repro_torch.kernels`` runs here.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core import factors as F
from repro_torch.core import tridiag as TRI
from repro_torch.core.blocks.base import CurvatureBlock, register


@register
class TridiagChain(CurvatureBlock):
    """Chain-spanning tridiagonal block; list- and dict-valued where the
    per-layer blocks are tensor-valued (see module docstring)."""

    kinds = ("tridiag",)

    CROSS = "__cross__"   # factors-dict key for the cross moments
    TRI = "__tri__"       # inverse-dict key for the Ψ/Σ cache

    def __init__(self, model, cfg, device):
        if not hasattr(model, "layer_order"):
            # registry dispatch hands per-layer blocks a LayerMeta; this
            # block spans a chain and must be built with the model itself
            raise TypeError(
                "TridiagChain needs a chain model with .layer_order; it is "
                "not a per-layer block — construct it as "
                "TridiagChain(model, cfg, device), not through "
                "build_blocks()")
        super().__init__(meta=None, cfg=cfg, device=device)
        self.model = model

    # -- layout ---------------------------------------------------------
    def init_factors(self) -> Dict:
        return TRI.init_cross_state(self.model, self.device)

    def identity_inverse(self):
        return None          # populated at the first refresh

    # -- statistics -----------------------------------------------------
    def stats_contrib(self, recs, gprobes, n):
        """Cross-moment contribution; takes the *full* record/probe dicts."""
        return TRI.cross_contrib(self.model, recs, gprobes, n)

    def update_factors(self, old, recs, gprobes, n, eps):
        return F.blend(old, self.stats_contrib(recs, gprobes, n), eps)

    # -- inverses -------------------------------------------------------
    def damped_inverse(self, factors, gamma, **_):
        """Ψ/Σ precomputation over the whole factors dict (diagonal blocks
        plus this block's cross moments under CROSS); a (c,) gamma stacks
        the candidates on a leading c."""
        return TRI.precompute(self.model, factors, gamma, self.cfg.eta)

    # -- preconditioning ------------------------------------------------
    def precondition(self, tri, vs: Dict):
        """``U = F̂⁻¹ V`` for every chain layer; vs keyed by layer name."""
        return TRI.apply(self.model, tri, vs)
