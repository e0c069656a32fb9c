"""Kronecker-pair curvature blocks for dense linear maps (paper S3–S4.2).

Mirrors the ``full``/``full`` layout of ``repro/core/blocks/kron.py``.
:class:`DenseKronecker` runs its hot operations through the kernels on every
layer, with no tiling gate (the CUDA kernels mask ragged edges):

  * the decayed factor accumulation through ``kernels.factor_update`` on
    both sides, ``C ← ε C + α XᵀX`` with α = (1−ε)/n for Ā and (1−ε)·n for
    G (per-token g = n·cot, so G = (1/n) Σ g gᵀ = n Σ cot cotᵀ);
  * the two-sided apply through ``kernels.precond.precondition``;
  * the EKFAC eigenbasis apply through ``kernels.rotate_rescale``;
  * the fixed-lr update chain ``α·Ā⁻¹VḠ⁻¹ + μ·M`` with its ``ΣD²`` through
    ``kernels.update_chain.precond_momentum`` (blkdiag inverses only: the
    eigen apply composed with momentum takes the base class's plain
    composition, as in the reference).

On CPU tensors the wrappers take their plain PyTorch versions.  The
``diag`` and ``block`` layouts and the TP / expert / conv blocks wait for
later slices.
"""
from __future__ import annotations

from repro_torch.core.blocks.base import CurvatureBlock, register
from repro_torch.kernels.factor_update import factor_update
from repro_torch.kernels.precond import precondition as precond_kernel
from repro_torch.kernels.rotate_rescale import rotate_rescale
from repro_torch.kernels.update_chain import precond_momentum as chain_kernel


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

    def precond_momentum(self, inv, v, mom, alpha, mu, eigen: bool = False):
        if eigen:
            return super().precond_momentum(inv, v, mom, alpha, mu, eigen)
        return chain_kernel(inv["a_inv"], v.float(), inv["g_inv"], mom,
                            alpha=alpha, mu=mu)

    def precondition_eigen(self, eig, v):
        return rotate_rescale(eig["qa"], v.float(), eig["qg"],
                              eig["s"] + eig["damp"], lam=1e-12)
