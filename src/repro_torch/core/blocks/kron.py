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
  * :class:`BlockDiagKronecker` — a ``block`` side on at least one side
    and no ``diag`` one: a side above ``KFACConfig.max_factor_dim``
    (gemma2's d_ff of 9216) keeps nb diagonal (db, db) blocks,
    (*lead, nb, db, db).  The reference runs it on the base class's plain
    code; the port routes its hot operations through the same kernels as
    :class:`DenseKronecker`, the block axis folded into the kernels' batch:
      - the decayed factor update through ``kernels.factor_update``, one
        launch a side: a block side's rows (S, N, nb·db) are copied
        block-major to (S·nb, N, db) for that launch (grid z over S·nb),
        and its factor is viewed as (S·nb, db, db);
      - the apply ``Ā⁻¹ V Ḡ⁻¹`` (the reference's order, Ā⁻¹ V first) as
        one ``kernels.matmul`` launch a side: on a block Ā side V
        (S, nb·db, g) is already (S·nb, db, g) as a view; on a block Ḡ
        side the product is copied block-major, (S·nb, a, db), and back;
        a full side is one batched matmul.
    Eigen mode, the fused fixed-lr chain and ``fused_stats`` on a block
    side are not ported yet and raise when the block is built.
  * :class:`DiagFactor` — a diagonal factor on at least one side
    (vocab-scale dims); the reference sends it to no kernel, and neither
    does the port.

On CPU tensors the wrappers take their plain PyTorch versions.
"""
from __future__ import annotations

from repro_torch.core import factors as F
from repro_torch.core.blocks.base import CurvatureBlock, register
from repro_torch.kernels.factor_update import factor_update
from repro_torch.kernels.matmul import matmul
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
            a_c = F.outer_sum(rec["a"], m.a_kind, stacked=m.n_stack > 0,
                              blocks=m.a_blocks) / n
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


def _block_rows(x, stacked: bool, nb: int):
    """Records (..., nb·db) of a block side as the kernel's (lead·nb, N,
    db) rows: a block-major copy, which lives only for its launch."""
    rows = _rows(x, stacked)
    n, d = rows.shape[-2:]
    rows = rows.reshape(*rows.shape[:-1], nb, d // nb).transpose(-3, -2)
    return rows.reshape(-1, n, d // nb)


def _side_update(x, old, kind: str, nb: int, stacked: bool, alpha, beta):
    """One side's ``C ← β C + α XᵀX`` in one factor_update launch: a full
    side as ``DenseKronecker`` launches it, a block side with its blocks in
    the launch's batch."""
    if kind != "block":
        return factor_update(_rows(x, stacked), old, alpha=alpha, beta=beta)
    db = old.shape[-1]
    out = factor_update(_block_rows(x, stacked, nb), old.reshape(-1, db, db),
                        alpha=alpha, beta=beta)
    return out.reshape(old.shape)


def _apply_left(inv, kind: str, v):
    """``Ā⁻¹ V`` in one matmul launch; v ([S,] a, g) contiguous, so a block
    side's (S·nb, db, g) is a view of it."""
    if kind != "block":
        return matmul(inv, v)
    db = inv.shape[-1]
    return matmul(inv.reshape(-1, db, db),
                  v.reshape(-1, db, v.shape[-1])).reshape(v.shape)


def _apply_right(inv, kind: str, u):
    """``U Ḡ⁻¹`` in one matmul launch; a block side's product runs on a
    block-major copy of U, (S·nb, a, db), and is copied back."""
    if kind != "block":
        return matmul(u, inv)
    nb, db = inv.shape[-3], inv.shape[-1]
    a = u.shape[-2]
    ub = u.reshape(*u.shape[:-1], nb, db).transpose(-3, -2)
    out = matmul(ub.reshape(-1, a, db), inv.reshape(-1, db, db))
    out = out.reshape(*u.shape[:-2], nb, a, db).transpose(-3, -2)
    return out.reshape(u.shape)


@register
class BlockDiagKronecker(KroneckerPair):
    """A ``block`` side (diagonal (db, db) blocks) on at least one side and
    no diagonal side; the kernels' route, as :class:`DenseKronecker`'s."""

    kinds = ("dense",)
    priority = 20

    @classmethod
    def handles(cls, meta):
        kinds = (meta.a_kind, meta.g_kind)
        return "block" in kinds and "diag" not in kinds

    def __init__(self, meta, cfg, device):
        super().__init__(meta, cfg, device)
        refused = [what for what, on in (
            ("eigen mode", getattr(cfg, "inv_mode", "") == "eigen"),
            ("the fused fixed-lr chain",
             not getattr(cfg, "use_rescale", True)),
            ("fused_stats", getattr(cfg, "fused_stats", False))) if on]
        if refused:
            raise NotImplementedError(
                f"{meta.name}: {' and '.join(refused)} on a block side "
                "(BlockDiagKronecker) is not ported yet")

    def update_factors(self, old, rec, gprobe, n, eps):
        m = self.meta
        stacked = m.n_stack > 0
        return {"a": _side_update(rec["a"], old["a"], m.a_kind, m.a_blocks,
                                  stacked, (1.0 - eps) / n, eps),
                "g": _side_update(gprobe.detach(), old["g"], m.g_kind,
                                  m.g_blocks, stacked, (1.0 - eps) * n,
                                  eps)}

    def precondition(self, inv, v):
        m = self.meta
        u = _apply_left(inv["a_inv"], m.a_kind, v.float().contiguous())
        return _apply_right(inv["g_inv"], m.g_kind, u)
