"""First-order baselines in the same Optimizer API as K-FAC; mirrors
``repro/optimizers/baselines.py``.

The paper's baselines (SGD with momentum, Fig. 10/11; Adam as the modern
diagonal reference) as chained generic transforms, so that they race K-FAC
through the same ``Trainer.fit`` loop.  Neither launches a kernel of
``repro_torch.kernels``: a step is the model's forward and backward plus
elementwise PyTorch.
"""
from __future__ import annotations

from repro_torch.core.transform import (Optimizer, Transform,
                                        add_decayed_weights, chain,
                                        from_transform, scale, scale_by_adam,
                                        with_momentum)


def sgd_momentum_transform(lr: float = 0.1, momentum: float = 0.9,
                           weight_decay: float = 0.0) -> Transform:
    """Classical heavy ball: ``v <- m v - lr g; p <- p + v``."""
    parts = []
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    parts += [scale(-lr), with_momentum(momentum)]
    return chain(*parts)


def adam_transform(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8, weight_decay: float = 0.0) -> Transform:
    """Adam; with ``weight_decay`` the decay is decoupled (AdamW): it is
    added after the moment rescaling, so that ``sqrt(nu)`` does not
    normalize it."""
    parts = [scale_by_adam(b1, b2, eps)]
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    parts.append(scale(-lr))
    return chain(*parts)


def sgd_momentum(model=None, lr: float = 0.1, momentum: float = 0.9,
                 weight_decay: float = 0.0) -> Optimizer:
    return from_transform(
        sgd_momentum_transform(lr, momentum, weight_decay), model,
        name="sgd_momentum")


def adam(model=None, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    return from_transform(
        adam_transform(lr, b1, b2, eps, weight_decay), model, name="adam")
