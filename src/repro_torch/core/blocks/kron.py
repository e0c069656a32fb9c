"""Kronecker-pair curvature blocks for dense linear maps (paper S3–S4.2).

Mirrors the ``full`` and ``diag`` layouts of ``repro/core/blocks/kron.py``:

  * :class:`DenseKronecker` — both factors dense (``full``/``full``), on
    plain and stacked (``n_stack``) layers alike.  Its hot operations run
    through the kernels on every layer, with no tiling gate (the CUDA
    kernels mask ragged edges):
      - the decayed factor accumulation through ``kernels.factor_update``
        on both sides, ``C ← ε C + α XᵀX`` with α = (1−ε)/n for Ā and
        (1−ε)·n for G (per-token g = n·cot, so G = (1/n) Σ g gᵀ =
        n Σ cot cotᵀ); a stacked layer's (S, N, d) records go in one
        launch, grid z over S.  Under ``fused_stats`` the sums arrive
        contracted (``{"aa"}`` records, ``{"gg"}`` gprobes: the same
        kernel ran in the passes, ``core/fused.py``) and take the base
        class's blend of the shared ``stats_contrib``;
      - the two-sided apply through ``kernels.precond.precondition``
        (stacked: the matmul kernel's batch dim);
      - the EKFAC eigenbasis apply through ``kernels.rotate_rescale``;
      - the fixed-lr update chain ``α·Ā⁻¹VḠ⁻¹ + μ·M`` with its ``ΣD²``
        through ``kernels.update_chain.precond_momentum`` (blkdiag inverses
        only: the eigen apply composed with momentum takes the base class's
        plain composition, as in the reference).
  * :class:`DiagFactor` — a diagonal factor on at least one side
    (vocab-scale dims); the reference sends it to no kernel, and neither
    does the port.

On CPU tensors the wrappers take their plain PyTorch versions.  The
``block`` layout (``BlockDiagKronecker``) waits for a model with a dense
side above ``core.factors.MAX_FACTOR_DIM``.
"""
from __future__ import annotations

from repro_torch.core import factors as F
from repro_torch.core.blocks.base import CurvatureBlock, register
from repro_torch.kernels.factor_update import factor_update
from repro_torch.kernels.precond import precondition as precond_kernel
from repro_torch.kernels.rotate_rescale import rotate_rescale
from repro_torch.kernels.update_chain import precond_momentum as chain_kernel


class KroneckerPair(CurvatureBlock):
    """The per-side statistics both layouts share (the reference's
    ``KroneckerPair.stats_contrib``): a record's raw ``a`` or its in-forward
    contraction ``{"aa"}`` (``fused_stats``), and a probe cotangent or the
    backward's ``{"gg"}`` contraction."""

    def stats_contrib(self, rec, gprobe, n):
        m = self.meta
        if "aa" in rec:
            a_c = rec["aa"] / n
        else:
            a_c = F.outer_sum(rec["a"], m.a_kind,
                              stacked=m.n_stack > 0) / n
        if isinstance(gprobe, dict):
            g_c = gprobe["gg"] * float(n)
        else:
            g_c = F.g_from_cotangent(gprobe, m, n)
        return {"a": a_c, "g": g_c}


@register
class DiagFactor(KroneckerPair):
    """A diagonal factor on at least one side (vocab-scale dims); the
    reference's plain per-side statistics."""

    kinds = ("dense",)
    priority = 30

    @classmethod
    def handles(cls, meta):
        return "diag" in (meta.a_kind, meta.g_kind)


def _rows(x, stacked: bool):
    """Records (..., d) as the kernel's ([S,] N, d) rows."""
    return (x.reshape(x.shape[0], -1, x.shape[-1]) if stacked
            else x.reshape(-1, x.shape[-1]))


@register
class DenseKronecker(KroneckerPair):
    """Dense ``full``/``full`` Kronecker pair — the kernels' hot path."""

    kinds = ("dense",)
    priority = 10

    @classmethod
    def handles(cls, meta):
        return meta.a_kind == "full" and meta.g_kind == "full"

    def _g_side(self, old_g, gprobe, n, eps):
        """G side of the decayed blend: per-token g = n·cot, so G =
        n Σ cot cotᵀ."""
        cot = _rows(gprobe.detach(), self.meta.n_stack > 0)
        return factor_update(cot, old_g, alpha=(1.0 - eps) * n, beta=eps)

    def _fused(self, rec, gprobe) -> bool:
        """Whether the layer's statistics came contracted in the passes
        (``fused_stats``): an ``{"aa"}`` record and a ``{"gg"}`` gprobe
        always come together, so a mixed pair is refused."""
        fused_a, fused_g = "aa" in rec, isinstance(gprobe, dict)
        if fused_a != fused_g:
            raise ValueError(f"{self.meta.name}: an {{'aa'}} record and a "
                             "{'gg'} gprobe come together (fused_stats)")
        return fused_a

    def update_factors(self, old, rec, gprobe, n, eps):
        if self._fused(rec, gprobe):     # the base class's plain blend
            return super().update_factors(old, rec, gprobe, n, eps)
        x_a = _rows(rec["a"], self.meta.n_stack > 0)
        a_new = factor_update(x_a, old["a"], alpha=(1.0 - eps) / n,
                              beta=eps)
        return {"a": a_new, "g": self._g_side(old["g"], gprobe, n, eps)}

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
