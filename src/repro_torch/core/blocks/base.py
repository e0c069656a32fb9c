"""Curvature-block abstraction (paper S3–S4): one object per Fisher block.

Mirrors ``repro/core/blocks/base.py``.  The block-diagonal Fisher
approximation gives every tagged layer its own Kronecker-factored block
``F_i ≈ Ā_i ⊗ G_i``; a :class:`CurvatureBlock` owns that layer's factor
layout, statistics, damped inverses and preconditioner apply.  Classes
self-register against the ``LayerMeta.kind`` values they serve, and
:func:`build_blocks` resolves one block per tagged layer.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Type

import torch

from repro_torch.core import factors as F
from repro_torch.core import inverse as INV
from repro_torch.core.tags import LayerMeta


class CurvatureBlock:
    """One layer's Fisher block: layout, statistics, inverse, apply."""

    kinds: tuple = ()   # LayerMeta.kind values this class can serve
    priority: int = 0   # higher wins when several classes claim a kind

    def __init__(self, meta: LayerMeta, cfg, device):
        self.meta = meta
        self.cfg = cfg
        self.device = device

    @classmethod
    def handles(cls, meta: LayerMeta) -> bool:
        """Refine registry dispatch beyond `kind` (e.g. on factor layout)."""
        return True

    # -- layout ---------------------------------------------------------
    def init_factors(self) -> Dict[str, Any]:
        """Zero factors as views of one zero: the first statistics pass
        weighs them by ε = 0 and writes new tensors, so a stack of S
        (d, d) factors costs nothing before it."""
        m = self.meta
        lead = (m.n_stack,) if m.n_stack else ()
        zero = torch.zeros((), device=self.device)
        z = lambda d, kind, nb: zero.expand(F.factor_shape(d, kind, nb, lead))
        return {"a": z(m.a_dim, m.a_kind, m.a_blocks),
                "g": z(m.g_dim, m.g_kind, m.g_blocks)}

    def identity_inverse(self) -> Dict[str, Any]:
        """The inverses before the first refresh: ones on a diagonal side,
        else one (d, d) identity (a block side: one (db, db)) viewed across
        the stacked layers and the blocks (the first refresh reads it as
        its NS hot start), so that a stack of S costs d² floats rather
        than S·d²."""
        m = self.meta
        lead = (m.n_stack,) if m.n_stack else ()

        def one(d, kind, nb):
            shape = F.factor_shape(d, kind, nb, lead)
            if kind == "diag":
                return torch.ones(shape, device=self.device)
            return torch.eye(shape[-1], device=self.device).expand(shape)

        return {"a_inv": one(m.a_dim, m.a_kind, m.a_blocks),
                "g_inv": one(m.g_dim, m.g_kind, m.g_blocks)}

    # -- statistics (S5) ------------------------------------------------
    def stats_contrib(self, rec, gprobe, n: int) -> Dict[str, Any]:
        """This step's (1/N-normalized) factor contribution {"a", "g"}."""
        raise NotImplementedError(type(self).__name__)

    def update_factors(self, old, rec, gprobe, n: int, eps):
        """Decayed blend ``C ← ε C + (1−ε) contrib``; ε is a device tensor.
        Blocks with a kernel route override this."""
        return F.blend(old, self.stats_contrib(rec, gprobe, n), eps)

    # -- inverses (S4.2 / S6.3) -----------------------------------------
    def damped_inverse(self, fac, gamma, *, method: str = "eigh",
                       iters: int = 12, prev: Optional[Dict] = None):
        return INV.damped_pair_inverse(self.meta, fac["a"], fac["g"], gamma,
                                       method=method, iters=iters, prev=prev)

    # -- preconditioning ------------------------------------------------
    def precondition(self, inv, v):
        """``U = Ā⁻¹ V G⁻¹`` with this block's structure; v shaped like W."""
        return INV.apply_block_inverse(self.meta, inv, v)

    def precond_momentum(self, inv, v, mom, alpha, mu, eigen: bool = False):
        """Fused update chain of the fixed-lr path (S4.2 + S7):
        ``D = alpha·precondition(v) + mu·mom`` plus ``Σ D²``, so the
        global-norm clip never re-reads the update.  Subclasses may serve
        this with one kernel."""
        u = (self.precondition_eigen(inv, v) if eigen
             else self.precondition(inv, v))
        d = alpha * u.float() + mu * mom
        return d, torch.sum(d * d)

    # -- eigenbasis (EKFAC) path, George et al. 1806.03884 --------------
    def eigen_state(self, fac, gamma):
        """Amortized refresh: factor eigenbases + eigenbasis diagonals
        ``{"qa", "qg", "s", "damp"}``."""
        return INV.eigen_pair_state(self.meta, fac["a"], fac["g"], gamma)

    def eigen_identity(self):
        """Pre-refresh placeholder with the post-refresh structure: identity
        bases shaped like the factors (None on a diagonal side) and a unit
        diagonal ``s`` with a zero ``damp``, (*lead, a_dim, g_dim): an
        identity preconditioner.  Every tensor is a view of one identity
        or one scalar, as :meth:`identity_inverse`'s are; the first refresh
        or rescale writes new tensors."""
        m = self.meta
        lead = (m.n_stack,) if m.n_stack else ()
        ident = self.identity_inverse()

        def basis(key, kind):
            return None if kind == "diag" else ident[key]

        diag_shape = (*lead, m.a_dim, m.g_dim)
        one = lambda v: torch.full((), v, device=self.device).expand(
            diag_shape)
        return {"qa": basis("a_inv", m.a_kind), "qg": basis("g_inv", m.g_kind),
                "s": one(1.0), "damp": one(0.0)}

    def eigen_state_multi(self, fac, gammas):
        """Candidate-stacked eigen states (gamma sweep) from one eigh."""
        return INV.eigen_pair_multi(self.meta, fac["a"], fac["g"], gammas)

    def rescale_step(self, eig, grad, eps):
        """Per-step second-moment update ``s ← εs + (1−ε)(Q_Aᵀ ∇ Q_G)²``."""
        return INV.eigen_rescale(self.meta, eig, grad, eps)

    def precondition_eigen(self, eig, v):
        """``U = Q_A [ (Q_Aᵀ V Q_G) / (s + damp) ] Q_Gᵀ``; v shaped like W."""
        return INV.apply_eigen(self.meta, eig, v)


_REGISTRY: Dict[str, List[Type[CurvatureBlock]]] = {}


def register(cls: Type[CurvatureBlock]) -> Type[CurvatureBlock]:
    """Class decorator: file ``cls`` under every kind it serves."""
    for kind in cls.kinds:
        lst = _REGISTRY.setdefault(kind, [])
        lst.append(cls)
        lst.sort(key=lambda c: -c.priority)
    return cls


def resolve(meta: LayerMeta) -> Type[CurvatureBlock]:
    for cls in _REGISTRY.get(meta.kind, ()):
        if cls.handles(meta):
            return cls
    raise KeyError(f"no curvature block registered for kind={meta.kind!r} "
                   f"(layer {meta.name!r}); known kinds: {sorted(_REGISTRY)}")


def build_blocks(metas: Dict[str, LayerMeta], cfg,
                 device) -> Dict[str, CurvatureBlock]:
    """One resolved block instance per tagged layer."""
    return {name: resolve(m)(m, cfg, device) for name, m in metas.items()}
