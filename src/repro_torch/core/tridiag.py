"""Block-tridiagonal inverse approximation F̂⁻¹ = Ξᵀ Λ Ξ (paper S4.3, App B).

Mirrors ``repro/core/tridiag.py``.  Defined for *chain* models (the MLP
autoencoders, ``models/mlp.py``, which list their layers in
``layer_order``); an LM has no ``layer_order`` and keeps the block-diagonal
approximation, as in the reference.

Needs cross moments between consecutive layers:
  Ā_{i,i+1} = E[ā_i ā_{i+1}ᵀ]   (inputs of consecutive tagged layers)
  G_{i,i+1} = E[g_i g_{i+1}ᵀ]

and per-layer damped diagonal factors.  Matrix layout note: the Fisher block
acts on vec(DW) with DW = g āᵀ of shape (d_out, d_in+1); internally we work
in that layout and transpose to/from the (d_in+1, d_out) weight layout.

Every product here is a plain ``torch.matmul`` and every decomposition
``inverse.eigh`` (cuSOLVER on the card), as the reference computes them
outside any Pallas kernel.  :func:`precompute` takes a (c,) ``gamma`` of
candidates (the S6.6 sweep, which the reference vmaps) and stacks every
cached quantity on a leading c; nothing reads a device value on the host.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.inverse import _outer, eigh, eigh_inverse, pi_trace

_EPS = 1e-8


def _inv_sqrt(m, floor=1e-10, polish: int = 2):
    """Symmetric inverse square root M^{-1/2}, batched over lead dims.

    The f32 eigh seed alone leaves a ~cond(M)·eps residual that the App-B
    Σ⁻¹ identity amplifies past usable tolerance, so the seed is polished
    with Newton–Schulz steps Y ← ½ Y (3I − M Y²) (quadratic convergence:
    each step squares the relative residual).  The polish iterates against
    M itself, which diverges explosively on eigenvalues below the clamp
    floor (roundoff-indefinite factors), so it is kept only where M's
    spectrum is safely positive — otherwise the clamped seed stands, chosen
    per matrix on the device.
    """
    w, v = eigh(m)
    wi = torch.rsqrt(torch.clamp(w, min=floor))
    y0 = (v * wi[..., None, :]) @ v.transpose(-1, -2)
    eye = torch.eye(m.shape[-1], dtype=y0.dtype, device=y0.device)
    y = y0
    for _ in range(polish):
        y = 0.5 * y @ (3.0 * eye - (m @ y) @ y)
        y = 0.5 * (y + y.transpose(-1, -2))
    ok = w[..., 0] > floor        # eigh sorts ascending: min eigenvalue
    return torch.where(ok[..., None, None], y, y0)


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def init_cross_state(model, device) -> Dict[str, torch.Tensor]:
    order = model.layer_order
    metas = model.metas
    out = {}
    for i in range(len(order) - 1):
        mi, mj = metas[order[i]], metas[order[i + 1]]
        out[f"a{i}"] = torch.zeros(mi.a_dim, mj.a_dim, device=device)
        out[f"g{i}"] = torch.zeros(mi.g_dim, mj.g_dim, device=device)
    return out


def cross_contrib(model, recs, gprobes, n: int) -> Dict[str, torch.Tensor]:
    order = model.layer_order
    out = {}
    for i in range(len(order) - 1):
        ai = recs[order[i]]["a"].float()
        aj = recs[order[i + 1]]["a"].float()
        out[f"a{i}"] = ai.transpose(-1, -2) @ aj / n
        gi = gprobes[order[i]].detach().float()
        gj = gprobes[order[i + 1]].detach().float()
        # per-token g = n * cot  =>  E[g_i g_jᵀ] = n Σ cot_i cot_jᵀ
        out[f"g{i}"] = gi.transpose(-1, -2) @ gj * n
    return out


# ---------------------------------------------------------------------------
# inverse precomputation (every T3 steps)
# ---------------------------------------------------------------------------

def precompute(model, factors, gamma, eta) -> Dict:
    """Damped Ψ / Σ cached quantities (paper S4.3 with S6.3 damping).  A
    (c,) ``gamma`` stacks each of them on a leading c."""
    order = model.layer_order
    metas = model.metas
    ell = len(order)
    cross = factors["__cross__"]

    a_d, g_d = [], []
    for name in order:
        m = metas[name]
        a = factors[name]["a"].float()
        g = factors[name]["g"].float()
        pi = pi_trace(a, m.a_kind, m.a_dim, g, m.g_kind, m.g_dim)
        gm = _outer(gamma, pi)
        eye_a = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        eye_g = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
        a_d.append(a + (pi * gm)[..., None, None] * eye_a)
        g_d.append(g + (gm / pi)[..., None, None] * eye_g)

    psi_a, psi_g, appb = [], [], []
    for i in range(ell - 1):
        pa = cross[f"a{i}"] @ eigh_inverse(a_d[i + 1])     # Ψ^Ā_{i,i+1}
        pg = cross[f"g{i}"] @ eigh_inverse(g_d[i + 1])     # Ψ^G_{i,i+1}
        psi_a.append(pa)
        psi_g.append(pg)
        # Σ_{i|i+1} = A_i ⊗ B_i − C ⊗ D  (A-side=Ā, B-side=G)
        c_mat = pa @ a_d[i + 1] @ pa.transpose(-1, -2)
        d_mat = pg @ g_d[i + 1] @ pg.transpose(-1, -2)
        a_is = _inv_sqrt(a_d[i])
        b_is = _inv_sqrt(g_d[i])
        s1, e1 = eigh(a_is @ c_mat @ a_is)
        s2, e2 = eigh(b_is @ d_mat @ b_is)
        appb.append({"k1": a_is @ e1, "k2": b_is @ e2, "s1": s1, "s2": s2})
    last = {"a_inv": eigh_inverse(a_d[-1]), "g_inv": eigh_inverse(g_d[-1])}
    return {"psi_a": psi_a, "psi_g": psi_g, "appb": appb, "last": last}


# ---------------------------------------------------------------------------
# application: U = F̂⁻¹ V  (paper S4.3)
# ---------------------------------------------------------------------------

def _sigma_inv_apply(cache, x):
    """(A⊗B − C⊗D)⁻¹ vec(X) per Appendix B; X in (B-side, A-side) layout.
    A |denominator| under 1e-8 becomes +1e-8 whatever its sign, as in the
    reference."""
    k1, k2, s1, s2 = cache["k1"], cache["k2"], cache["s1"], cache["s2"]
    inner = k2.transpose(-1, -2) @ x @ k1
    denom = 1.0 - s2[..., :, None] * s1[..., None, :]
    denom = torch.where(torch.abs(denom) < _EPS,
                        torch.full_like(denom, _EPS), denom)
    return k2 @ (inner / denom) @ k1.transpose(-1, -2)


def apply(model, tri, vs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    order = model.layer_order
    ell = len(order)
    # to Fisher layout: X_i = V_iᵀ  (d_out, d_in+1)
    xs = [vs[name].float().transpose(-1, -2) for name in order]

    # u = Ξ v   (U_i = X_i − Ψ^G_i X_{i+1} Ψ^Āᵢᵀ ; U_{ℓ-1} = X_{ℓ-1})
    us = list(xs)
    for i in range(ell - 1):
        us[i] = xs[i] - (tri["psi_g"][i] @ xs[i + 1]
                         @ tri["psi_a"][i].transpose(-1, -2))

    # y = Λ u
    ys = [_sigma_inv_apply(tri["appb"][i], us[i]) for i in range(ell - 1)]
    ys.append(tri["last"]["g_inv"] @ us[-1] @ tri["last"]["a_inv"])

    # z = Ξᵀ y  (Z_i = Y_i − Ψ^G_{i-1}ᵀ Y_{i-1} Ψ^Ā_{i-1} ; Z_0 = Y_0)
    zs = list(ys)
    for i in range(1, ell):
        zs[i] = ys[i] - (tri["psi_g"][i - 1].transpose(-1, -2) @ ys[i - 1]
                         @ tri["psi_a"][i - 1])

    return {name: zs[i].transpose(-1, -2) for i, name in enumerate(order)}
