"""Typed optimizer state and the trainer-facing optimizer bundle.

Mirrors ``KFACState`` and ``Optimizer`` of ``repro/core/transform.py``.  The
state is a dataclass of tensors and dicts of tensors with the reference's
field names, so a JAX state converts field by field
(``repro_torch.convert.state_from_numpy``).  The first-order transforms and
``state_shardings`` wait for later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class KFACState:
    """K-FAC optimizer state (paper Algorithm 2), one field per concern.

    ``factors``  per-block running Kronecker factors {"a", "g"} (S5);
    ``inv``      per-block damped inverses {"a_inv", "g_inv"};
    ``diag``     per param: the running diagonal curvature (squared
                 gradients) of an untagged param such as a norm scale, an
                 empty tensor for a tagged one;
    ``delta0``   previous update (the S7 momentum tangent);
    ``lam`` / ``gamma``  LM damping (S6.5) and factored damping (S6.6);
    ``m_delta`` / ``loss_prev``  quadratic-model value and last loss, the
                 inputs to the rho reduction ratio;
    ``staleness`` / ``inv_pending``  the overlap refresh mode's fields;
                 0 and None in the serial mode, the only one ported.
    Scalars are 0-d device tensors.
    """

    step: torch.Tensor
    k_stats: torch.Tensor
    lam: torch.Tensor
    gamma: torch.Tensor
    factors: Any
    inv: Any
    diag: Any
    delta0: Any
    m_delta: torch.Tensor
    loss_prev: torch.Tensor
    staleness: Optional[torch.Tensor] = None
    inv_pending: Any = None

    def replace(self, **kw) -> "KFACState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Trainer-facing optimizer bundle (plain callables).

    ``update(grads, state, params, batch, rng)`` returns
    ``(new_params, state, metrics)``; ``grads=None`` asks the optimizer to
    run its own gradient pass.  ``reject(state)`` is the non-finite-update
    hook the trainer calls instead of applying a poisoned step.
    """

    init: Callable[[Any, Any], Any]
    update: Callable[..., tuple]
    reject: Callable[[Any], Any] = lambda state: state
    engine: Any = None
    name: str = "optimizer"
