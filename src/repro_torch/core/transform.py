"""Functional optimizer API; mirrors ``repro/core/transform.py``.

Two protocols:

``Transform(init, update)``
    A pure gradient transformation, optax's contract::

        state           = tx.init(params)
        updates, state  = tx.update(updates, state, params)

    Transforms compose with :func:`chain`.  :func:`scale`,
    :func:`with_momentum`, :func:`scale_by_adam`,
    :func:`add_decayed_weights` and :func:`clip_by_global_norm` express the
    paper's baselines, SGD with momentum and Adam
    (``repro_torch/optimizers/baselines.py``).

``Optimizer(init, update, reject, ...)``
    The trainer-facing bundle::

        state = opt.init(params, batch)
        new_params, state, metrics = opt.update(grads, state, params,
                                                batch, rng)

    ``grads=None`` asks the optimizer to run its own gradient pass (K-FAC
    must be driven this way).  ``reject(state)`` is the non-finite-update
    hook.

The states are dataclasses of tensors, dicts and tuples with the
reference's field names, so a JAX state converts field by field
(``repro_torch.convert.state_from_numpy``,
``transform_state_from_numpy``).  Scalars are 0-d tensors on the
parameters' device: no transform reads one on the host.
``Optimizer.state_shardings`` and ``poll`` wait for the distributed slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.utils import tree as T


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
                 0 and None in the serial and staggered modes, the
                 ones ported.
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
class TransformState:
    """State of a first-order :class:`Optimizer` built from a Transform:
    the step counter (0-d int32) plus the chained transform's own state
    tuple."""

    step: torch.Tensor
    inner: Any

    def replace(self, **kw) -> "TransformState":
        return dataclasses.replace(self, **kw)


class Transform(NamedTuple):
    """Pure gradient transformation: ``init(params)``,
    ``update(updates, state, params) -> (updates, state)``."""

    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Trainer-facing optimizer bundle (plain callables).

    ``update(grads, state, params, batch, rng)`` returns
    ``(new_params, state, metrics)``; ``grads=None`` asks the optimizer to
    run its own gradient pass.  ``reject(state)`` is the non-finite-update
    hook the trainer calls instead of applying a poisoned step.
    ``engine`` is K-FAC's stage engine; ``transform`` the pure Transform of
    a first-order method.
    """

    init: Callable[[Any, Any], Any]
    update: Callable[..., tuple]
    reject: Callable[[Any], Any] = lambda state: state
    engine: Any = None
    transform: Optional[Transform] = None
    name: str = "optimizer"


# ---------------------------------------------------------------------------
# generic transforms (the paper's first-order baselines live on these)
# ---------------------------------------------------------------------------

def _clip_factor(norm, max_norm):
    """min(1, max_norm / max(norm, 1e-20)) as a 0-d tensor."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-20), max=1.0)


def chain(*transforms: Transform) -> Transform:
    """Compose transforms left to right over the update tree."""

    def init(params):
        return tuple(tx.init(params) for tx in transforms)

    def update(updates, state, params):
        new_state = []
        for tx, s in zip(transforms, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return Transform(init, update)


def identity() -> Transform:
    return Transform(lambda params: (), lambda u, s, p: (u, s))


def scale(factor: float) -> Transform:
    """``u <- factor * u`` (e.g. ``scale(-lr)``)."""
    return Transform(lambda params: (),
                     lambda u, s, p: (T.tree_scale(u, factor), s))


def add_decayed_weights(weight_decay: float) -> Transform:
    """``u <- u + wd * p``.  Before the momentum or Adam rescaling this is
    L2 regularization; after it (as the adam chain places it), decoupled
    AdamW-style decay."""
    return Transform(
        lambda params: (),
        lambda u, s, p: (T.tree_map(
            lambda ui, pi: ui + weight_decay * pi.to(ui.dtype), u, p), s))


def clip_by_global_norm(max_norm: float) -> Transform:
    """Rescale ``u`` so that its global l2 norm is at most ``max_norm``."""

    def update(u, s, p):
        gn = torch.sqrt(T.tree_sqnorm(u))
        return T.tree_scale(u, _clip_factor(gn, max_norm)), s

    return Transform(lambda params: (), update)


def momentum_global_clip(momentum: float, max_norm: float) -> Transform:
    """``chain(with_momentum(momentum), clip_by_global_norm(max_norm))`` in
    one traversal.  The state is the velocity alone; the clip applies to
    the emitted value only (the stored velocity stays unclipped)."""

    def update(u, vel, p):
        vel = T.tree_map(lambda v, ui: momentum * v + ui, vel, u)
        gn = torch.sqrt(T.tree_sqnorm(vel))
        return T.tree_scale(vel, _clip_factor(gn, max_norm)), vel

    return Transform(T.tree_zeros_like, update)


def with_kl_clip(inner: Transform, max_kl: float, lr: float = 1.0) -> Transform:
    """Norm constraint ("KL clip") around ``inner``: with ``Δ = inner(g)``
    the emitted update is ``ν·Δ``, ``ν = min(1, sqrt(max_kl / (lr²·|Δᵀg|)))``,
    so that the step moves the predictive distribution by at most
    ``max_kl`` nats to second order.  The incoming update is the gradient
    proxy ``g``; the inner state passes through unscaled."""

    def update(u, s, p):
        u2, s = inner.update(u, s, p)
        quad = torch.abs(T.tree_dot(u2, u))
        nu = torch.clamp(torch.sqrt(
            max_kl / torch.clamp(lr * lr * quad, min=1e-20)), max=1.0)
        return T.tree_scale(u2, nu), s

    return Transform(inner.init, update)


def with_momentum(momentum: float) -> Transform:
    """Heavy ball: ``v <- momentum * v + u``; emits ``v``.  After
    ``scale(-lr)`` this is the ``v <- m v - lr g; p <- p + v`` recursion the
    paper tunes SGD with."""

    def update(u, vel, p):
        vel = T.tree_map(lambda v, ui: momentum * v + ui, vel, u)
        return vel, vel

    return Transform(T.tree_zeros_like, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Transform:
    """Adam's bias-corrected first and second moments (without -lr).
    ``count`` is a 0-d int32 tensor; the bias corrections are float32
    powers of it, as in the reference."""

    def init(params):
        dev = T.tree_leaves(params)[0].device
        return {"mu": T.tree_zeros_like(params),
                "nu": T.tree_zeros_like(params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(u, s, p):
        count = s["count"] + 1
        mu = T.tree_map(lambda m, g: b1 * m + (1 - b1) * g, s["mu"], u)
        nu = T.tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, s["nu"], u)
        c = count.float()
        bc1 = 1.0 - torch.pow(torch.tensor(b1, device=c.device), c)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, device=c.device), c)
        out = T.tree_map(
            lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + eps), mu, nu)
        return out, {"mu": mu, "nu": nu, "count": count}

    return Transform(init, update)


# ---------------------------------------------------------------------------
# Transform -> Optimizer
# ---------------------------------------------------------------------------

def apply_updates(params, updates):
    """``p <- p + u`` in the parameter dtype."""
    return T.tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def model_value_and_grad(model):
    """Generic gradient pass over the port's model protocol
    (``model.loss(params, None, batch, None, mode="plain")``, whose aux
    carries ``"metrics"``): ``(grads, metrics)``, the metrics detached.
    The reference passes its key and discards the sampled loss; the port
    passes no noise, so that nothing is drawn."""

    def f(params, batch):
        p1 = T.tree_map(lambda v: v.detach().requires_grad_(True), params)
        (lt, _), aux = model.loss(p1, None, batch, None, mode="plain")
        grads = T.tree_unflatten_like(params, torch.autograd.grad(
            lt, T.tree_leaves(p1)))
        return grads, {k: v.detach() for k, v in aux["metrics"].items()}

    return f


def from_transform(transform: Transform, model=None,
                   name: str = "transform") -> Optimizer:
    """Lift a pure Transform into a trainer-facing :class:`Optimizer`.

    With ``model`` given, ``update(None, state, params, batch, rng)`` runs
    the gradient pass, the transform and the apply; without one, callers
    pass ``grads``.  The metrics are the model's (``loss``) plus
    ``grad_norm`` and ``delta_norm``, 0-d tensors: the trainer's guard
    reads ``delta_norm`` with its one host read of the step."""
    gradfn = model_value_and_grad(model) if model is not None else None

    def init(params, batch=None):
        dev = T.tree_leaves(params)[0].device
        return TransformState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            inner=transform.init(params))

    def _apply(grads, state, params):
        updates, inner = transform.update(grads, state.inner, params)
        new_params = apply_updates(params, updates)
        metrics = {"grad_norm": torch.sqrt(T.tree_sqnorm(grads)),
                   "delta_norm": torch.sqrt(T.tree_sqnorm(updates))}
        return new_params, TransformState(state.step + 1, inner), metrics

    def update(grads, state, params, batch=None, rng=None):
        if grads is not None:
            return _apply(grads, state, params)
        if gradfn is None:
            raise ValueError(f"{name}: no model bound — pass explicit grads")
        grads, metrics = gradfn(params, batch)
        new_params, state, m2 = _apply(grads, state, params)
        return new_params, state, {**metrics, **m2}

    return Optimizer(init=init, update=update, transform=transform,
                     name=name)
