"""Damped factor inverses + factored Tikhonov damping (S4.2, S6.3).

Mirrors the ``full``-layout part of ``repro/core/inverse.py``.  Each block's
factors are damped as ``(Ā + π γ I) ⊗ (G + γ/π I)`` with the trace-norm
``π = sqrt( (tr Ā / d_A) / (tr G / d_G) )``.  Methods: ``eigh`` (exact),
``ns`` (Newton–Schulz, hot-startable; its iteration body is the
``kernels.ns_step`` kernel on the card) and ``solve`` (dense inverse).

Everything is batched over leading dims: ``gamma`` may be a (c,) tensor of
candidates (the S6.6 sweep), which stacks the inverses along a leading c.
No function here reads a device value on the host.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.tags import LayerMeta
from repro_torch.kernels import ns_step as NS

_TINY = 1e-20


def pi_trace(a, a_dim, g, g_dim):
    """Paper S6.3 trace-norm pi, batched over lead dims."""
    a_tr = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1) / a_dim
    g_tr = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1) / g_dim
    return torch.sqrt(torch.clamp(a_tr, min=_TINY)
                      / torch.clamp(g_tr, min=_TINY))


def _add_damp(arr, damp):
    """arr + damp·I; damp has the lead-dims shape and broadcasts over arr's
    (a (c,) damp on a (d, d) factor gives (c, d, d))."""
    eye = torch.eye(arr.shape[-1], dtype=arr.dtype, device=arr.device)
    return arr + damp[..., None, None] * eye


def eigh_inverse(m, floor: float = 1e-12):
    w, v = torch.linalg.eigh(m)
    wi = 1.0 / torch.clamp(w, min=floor)
    return (v * wi[..., None, :]) @ v.transpose(-1, -2)


def ns_inverse(m, iters: int, x0=None):
    """Newton–Schulz: X <- 2X − X M X.  m: (..., d, d) SPD (damped).

    With ``x0`` the iteration is hot-started, under the safeguard
    ``‖I − M x0‖_inf < 1``; where that fails, that matrix cold-starts at
    ``I/‖M‖_inf``.  The choice is a ``torch.where`` on the device."""
    cold = NS.cold_start(m)
    if x0 is None:
        x = cold
    else:
        eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
        r = eye - m @ x0
        bad = torch.amax(torch.sum(torch.abs(r), dim=-1), dim=-1) >= 1.0
        x = torch.where(bad[..., None, None], cold, x0)
    for _ in range(iters):
        x = NS.ns_step(m, x)
    return 0.5 * (x + x.transpose(-1, -2))


def factor_inverse(arr, damp, *, method: str = "eigh", iters: int = 12,
                   prev=None):
    """Inverse of (factor + damp·I)."""
    arr = _add_damp(arr.float(), torch.as_tensor(damp, dtype=torch.float32,
                                                 device=arr.device))
    if method == "eigh":
        return eigh_inverse(arr)
    if method == "ns":
        return ns_inverse(arr, iters, prev)
    return torch.linalg.inv(arr)


def damped_pair_inverse(meta: LayerMeta, a, g, gamma, *, method="eigh",
                        iters=12, prev: Optional[Dict] = None):
    """Both inverses of one layer block under factored Tikhonov damping."""
    pi = pi_trace(a, meta.a_dim, g, meta.g_dim)
    a_inv = factor_inverse(a, pi * gamma, method=method, iters=iters,
                           prev=None if prev is None else prev.get("a_inv"))
    g_inv = factor_inverse(g, gamma / pi, method=method, iters=iters,
                           prev=None if prev is None else prev.get("g_inv"))
    return {"a_inv": a_inv, "g_inv": g_inv}


def apply_block_inverse(meta: LayerMeta, inv: Dict, v):
    """U = Ā⁻¹ V G⁻¹ (jnp order: Ā⁻¹ V first); v shaped like the weight."""
    return (inv["a_inv"] @ v.float()) @ inv["g_inv"]
