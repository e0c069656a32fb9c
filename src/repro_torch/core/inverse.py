"""Damped factor inverses + factored Tikhonov damping (S4.2, S6.3).

Mirrors the ``full``, ``block`` and ``diag`` layouts of
``repro/core/inverse.py`` (the eigen path: ``full`` only).  A ``block``
side is a stack of diagonal blocks (*lead, nb, db, db): its trace sums the
blocks, its damping adds to every block, and its inverse is the blocks'
inverses (one batch of lead·nb matrices).  Each block's
factors are damped as ``(Ā + π γ I) ⊗ (G + γ/π I)`` with the trace-norm
``π = sqrt( (tr Ā / d_A) / (tr G / d_G) )``.  Methods: ``eigh`` (exact),
``ns`` (Newton–Schulz, hot-startable; its iteration body is the
``kernels.ns_step`` kernel on the card) and ``solve`` (dense inverse).

Eigenbasis (EKFAC) state, George et al. 1806.03884: instead of damped
factor inverses, :func:`eigen_pair_state` keeps the eigenbases ``Q_A, Q_G``
on the T3 schedule plus a per-entry diagonal in that basis, split into
``s`` (second moments, re-estimated every step from the rotated gradient by
:func:`eigen_rescale`) and ``damp`` (the factored-Tikhonov diagonal
``(γ/π)λ_A + πγλ_G + γ²``).  Right after a refresh
``s + damp = (λ_A + πγ)(λ_G + γ/π)``, so :func:`apply_eigen` is the ``eigh``
inverse apply.  Every eigendecomposition goes through :func:`eigh`, which
symmetrizes its input as ``jnp.linalg.eigh`` does by default
(``torch.linalg.eigh`` reads only the lower triangle); the basis is unique
only up to column signs (and rotations inside near-degenerate
eigenspaces).

Everything is batched over leading dims (the LM's stacked layers): ``gamma``
may be a (c,) tensor of candidates (the S6.6 sweep), which stacks the
inverses along a leading c in front of them.
No function here reads a device value on the host.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.tags import LayerMeta
from repro_torch.kernels import ns_step as NS

_TINY = 1e-20


def factor_trace(arr, kind: str):
    """Total trace per lead index (stack, candidate): shape = lead dims."""
    if kind == "diag":
        return arr.sum(-1)
    tr = torch.diagonal(arr, dim1=-2, dim2=-1).sum(-1)
    if kind == "block":
        tr = tr.sum(-1)                    # over the block axis
    return tr


def pi_trace(a, a_kind, a_dim, g, g_kind, g_dim):
    """Paper S6.3 trace-norm pi, batched over lead dims."""
    a_tr = factor_trace(a, a_kind) / a_dim
    g_tr = factor_trace(g, g_kind) / g_dim
    return torch.sqrt(torch.clamp(a_tr, min=_TINY)
                      / torch.clamp(g_tr, min=_TINY))


def _outer(gamma, pi):
    """gamma as a tensor that broadcasts against pi's lead dims from the
    left: a (c,) candidate set on a stacked (S,) pi gives (c, S)."""
    gamma = torch.as_tensor(gamma, dtype=torch.float32, device=pi.device)
    return gamma.reshape(gamma.shape + (1,) * pi.dim())


def _add_damp(arr, kind: str, damp):
    """arr + damp·I (diag: + damp); damp has the lead-dims shape (no block
    axis) and broadcasts over arr's (a (c,) damp on a (d, d) factor gives
    (c, d, d); a (c, S) one on (S, nb, db, db) blocks (c, S, nb, db, db))."""
    if kind == "diag":
        return arr + damp[..., None]
    eye = torch.eye(arr.shape[-1], dtype=arr.dtype, device=arr.device)
    if kind == "block":
        return arr + damp[..., None, None, None] * eye
    return arr + damp[..., None, None] * eye


def eigh(m):
    """``torch.linalg.eigh`` of ``½(M + Mᵀ)``: the reference's
    ``jnp.linalg.eigh`` symmetrizes its input (``symmetrize_input=True``),
    while ``torch.linalg.eigh`` would read M's lower triangle alone."""
    return torch.linalg.eigh((m + m.transpose(-1, -2)) / 2)


def eigh_inverse(m, floor: float = 1e-12):
    w, v = eigh(m)
    wi = 1.0 / torch.clamp(w, min=floor)
    return (v * wi[..., None, :]) @ v.transpose(-1, -2)


def ns_inverse(m, iters: int, x0=None):
    """Newton–Schulz: X <- 2X − X M X.  m: (..., d, d) SPD (damped).

    With ``x0`` the iteration is hot-started, under the safeguard
    ``‖I − M x0‖_inf < 1``; where that fails, that matrix cold-starts at
    ``I/‖M‖_inf``.  The choice is a ``torch.where`` on the device.  The
    iteration runs on every lead dim (gamma candidates, stacked layers)
    flattened into the kernels' one batch dim."""
    shape = m.shape
    if m.dim() > 3:
        m = m.reshape(-1, *shape[-2:])
        if x0 is not None:
            x0 = x0.expand(shape).reshape(-1, *shape[-2:])
    if x0 is None:
        x = NS.cold_start(m)
    else:
        # the safeguard first and no temporary kept past its use: at
        # llama3.2-1b's (16, 8192, 8192) stacks each (d, d) stack is 4 GiB
        eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
        bad = torch.amax(torch.sum(torch.abs(eye - m @ x0), dim=-1),
                         dim=-1) >= 1.0
        x = torch.where(bad[..., None, None], NS.cold_start(m), x0)
    for _ in range(iters):
        x = NS.ns_step(m, x)
    return (0.5 * (x + x.transpose(-1, -2))).reshape(shape)


def factor_inverse(arr, kind: str, damp, *, method: str = "eigh",
                   iters: int = 12, prev=None):
    """Inverse of (factor + damp·I); the diag kind returns the reciprocal."""
    arr = _add_damp(arr.float(), kind, torch.as_tensor(
        damp, dtype=torch.float32, device=arr.device))
    if kind == "diag":
        return 1.0 / torch.clamp(arr, min=_TINY)
    if method == "eigh":
        return eigh_inverse(arr)
    if method == "ns":
        return ns_inverse(arr, iters, prev)
    return torch.linalg.inv(arr)


def damped_pair_inverse(meta: LayerMeta, a, g, gamma, *, method="eigh",
                        iters=12, prev: Optional[Dict] = None):
    """Both inverses of one layer block under factored Tikhonov damping;
    a (c,) ``gamma`` stacks the c candidates' inverses in front."""
    pi = pi_trace(a, meta.a_kind, meta.a_dim, g, meta.g_kind, meta.g_dim)
    gm = _outer(gamma, pi)
    a_inv = factor_inverse(a, meta.a_kind, pi * gm, method=method,
                           iters=iters,
                           prev=None if prev is None else prev.get("a_inv"))
    g_inv = factor_inverse(g, meta.g_kind, gm / pi, method=method,
                           iters=iters,
                           prev=None if prev is None else prev.get("g_inv"))
    return {"a_inv": a_inv, "g_inv": g_inv}


# ---------------------------------------------------------------------------
# eigenbasis (EKFAC) state:  F ≈ (Q_A ⊗ Q_G) diag(s + damp) (Q_A ⊗ Q_G)ᵀ
# ---------------------------------------------------------------------------

def eigh_basis(arr):
    """``(q, w)``: the eigenbasis of one factor and its eigenvalues, with
    eigh's tiny negatives clipped to 0 (the factor is PSD)."""
    w, q = eigh(arr)
    return q, torch.clamp(w, min=0.0)


def rotate_eigen(qa, qg, v, *, adjoint: bool):
    """``Q_Aᵀ V Q_G`` (adjoint: into the eigenbasis) or ``Q_A V Q_Gᵀ``."""
    if adjoint:
        return (qa.transpose(-1, -2) @ v) @ qg
    return (qa @ v) @ qg.transpose(-1, -2)


def _eigen_parts(meta: LayerMeta, a, g):
    """The gamma-independent pieces: bases, eigenvalue column/row, pi."""
    qa, wa = eigh_basis(a)
    qg, wg = eigh_basis(g)
    pi = pi_trace(a, meta.a_kind, meta.a_dim, g, meta.g_kind, meta.g_dim)
    return qa, qg, wa[..., :, None], wg[..., None, :], pi


def _eigen_damp(wa_col, wg_row, pi, gamma):
    """Factored-Tikhonov diagonal ``(γ/π)λ_A + πγλ_G + γ²``; a (c,) gamma
    stacks the candidates on a leading dim."""
    gamma = torch.as_tensor(gamma, dtype=torch.float32, device=wa_col.device)
    return ((gamma / pi)[..., None, None] * wa_col
            + (pi * gamma)[..., None, None] * wg_row
            + torch.square(gamma)[..., None, None])


def eigen_pair_state(meta: LayerMeta, a, g, gamma):
    """Amortized EKFAC state of one block: ``{"qa", "qg", "s", "damp"}``,
    ``s`` the Kronecker eigenvalue products ``λ_A,i λ_G,j`` and ``damp`` the
    factored-Tikhonov cross terms."""
    qa, qg, wa_col, wg_row, pi = _eigen_parts(meta, a, g)
    s = wa_col * wg_row
    damp = _eigen_damp(wa_col, wg_row, pi, gamma).expand(s.shape)
    return {"qa": qa, "qg": qg, "s": s, "damp": damp.contiguous()}


def eigen_pair_multi(meta: LayerMeta, a, g, gammas):
    """Candidate-stacked eigen states for the S6.6 gamma sweep from ONE
    eigendecomposition per factor: only ``damp`` depends on gamma, so the
    bases and ``s`` are broadcast (views) over the leading candidate dim."""
    qa, qg, wa_col, wg_row, pi = _eigen_parts(meta, a, g)
    s = wa_col * wg_row
    n = gammas.shape[0]
    damp = _eigen_damp(wa_col, wg_row, pi, gammas).expand(n, *s.shape)
    tile = lambda x: x.expand(n, *x.shape)
    return {"qa": tile(qa), "qg": tile(qg), "s": tile(s),
            "damp": damp.contiguous()}


def eigen_rescale(eig, grad, eps):
    """Per-step EKFAC diagonal update ``s ← εs + (1−ε)(Q_Aᵀ ∇ Q_G)²``."""
    t = rotate_eigen(eig["qa"], eig["qg"], grad.float(), adjoint=True)
    return dict(eig, s=eps * eig["s"] + (1.0 - eps) * torch.square(t))


def apply_eigen(eig, v, floor: float = 1e-12):
    """``U = Q_A [ (Q_Aᵀ V Q_G) / (s + damp) ] Q_Gᵀ``; v shaped like W."""
    t = rotate_eigen(eig["qa"], eig["qg"], v.float(), adjoint=True)
    t = t / (eig["s"] + eig["damp"] + floor)
    return rotate_eigen(eig["qa"], eig["qg"], t, adjoint=False)


def _mul_left(inv, kind: str, v):
    """Multiply along the d_in (second-to-last) axis of v."""
    if kind == "diag":
        return v * inv[..., :, None]
    if kind == "block":
        nb, db = inv.shape[-3], inv.shape[-1]
        lead = v.shape[:-2]
        vr = v.reshape(*lead, nb, db, v.shape[-1])
        return (inv @ vr).reshape(*lead, nb * db, v.shape[-1])
    return inv @ v


def _mul_right(inv, kind: str, v):
    """Multiply along the d_out (last) axis of v."""
    if kind == "diag":
        return v * inv[..., None, :]
    if kind == "block":
        nb, db = inv.shape[-3], inv.shape[-1]
        vr = v.reshape(*v.shape[:-1], nb, db).transpose(-3, -2)
        return (vr @ inv).transpose(-3, -2).reshape(v.shape)
    return v @ inv


def apply_block_inverse(meta: LayerMeta, inv: Dict, v):
    """U = Ā⁻¹ V G⁻¹ (jnp order: Ā⁻¹ V first) with per-kind structure; v
    shaped like the weight (a leading n_stack on stacked layers)."""
    u = _mul_left(inv["a_inv"], meta.a_kind, v.float())
    return _mul_right(inv["g_inv"], meta.g_kind, u)
