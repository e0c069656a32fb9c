"""Adaptive damping rules (paper S6.5, S6.6); mirrors ``repro/core/damping.py``."""
from __future__ import annotations

import torch

LAM_MIN, LAM_MAX = 1e-8, 1e8
GAMMA_MIN, GAMMA_MAX = 1e-6, 1e4


def lambda_update(lam, rho, omega1: float):
    """Levenberg–Marquardt rule: shrink when the quadratic model predicts
    well (rho > 3/4), grow when it doesn't (rho < 1/4)."""
    lam = torch.where(rho > 0.75, lam * omega1, lam)
    lam = torch.where(rho < 0.25, lam / omega1, lam)
    return torch.clamp(lam, LAM_MIN, LAM_MAX)


def gamma_candidates(gamma, omega2: float):
    """The greedy T2-periodic sweep: {γ, ω γ, γ/ω}."""
    return torch.stack([gamma,
                        torch.clamp(gamma * omega2, GAMMA_MIN, GAMMA_MAX),
                        torch.clamp(gamma / omega2, GAMMA_MIN, GAMMA_MAX)])
