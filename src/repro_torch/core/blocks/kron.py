"""Kronecker-pair curvature blocks for dense linear maps (paper S3–S4.2).

Mirrors the ``full``/``full`` layout of ``repro/core/blocks/kron.py``.
:class:`DenseKronecker` runs its hot operations through the kernels on every
layer, with no tiling gate (the CUDA kernels mask ragged edges):

  * the decayed factor accumulation through ``kernels.factor_update`` on
    both sides, ``C ← ε C + α XᵀX`` with α = (1−ε)/n for Ā and (1−ε)·n for
    G (per-token g = n·cot, so G = (1/n) Σ g gᵀ = n Σ cot cotᵀ);
  * the two-sided apply through ``kernels.precond.precondition``.

On CPU tensors both wrappers take their plain PyTorch versions.  The
``diag`` and ``block`` layouts and the TP / expert / conv blocks wait for
later slices.
"""
from __future__ import annotations

from repro_torch.core.blocks.base import CurvatureBlock, register
from repro_torch.kernels.factor_update import factor_update
from repro_torch.kernels.precond import precondition as precond_kernel


@register
class DenseKronecker(CurvatureBlock):
    """Dense ``full``/``full`` Kronecker pair — the kernels' hot path."""

    kinds = ("dense",)
    priority = 10

    @classmethod
    def handles(cls, meta):
        return meta.a_kind == "full" and meta.g_kind == "full"

    def update_factors(self, old, rec, gprobe, n, eps):
        one_m = 1.0 - eps
        x_a = rec["a"].reshape(-1, rec["a"].shape[-1])
        cot = gprobe.detach().reshape(-1, gprobe.shape[-1])
        return {"a": factor_update(x_a, old["a"], alpha=one_m / n, beta=eps),
                "g": factor_update(cot, old["g"], alpha=one_m * n, beta=eps)}

    def precondition(self, inv, v):
        return precond_kernel(inv["a_inv"], v.float(), inv["g_inv"])
