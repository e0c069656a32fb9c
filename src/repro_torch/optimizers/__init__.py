"""Swappable optimizers behind one functional API; mirrors
``repro/optimizers/__init__.py``.

Every optimizer here is a :class:`repro_torch.core.transform.Optimizer`,
``(init, update, reject)``, so that the trainer and the launcher treat
K-FAC and the first-order baselines alike::

    from repro_torch import optimizers
    opt = optimizers.get("adam", model, lr=1e-3)
    state = opt.init(params, batch)
    new_params, state, metrics = opt.update(None, state, params, batch, rng)
"""
from __future__ import annotations

from repro_torch.core.transform import Optimizer, Transform, TransformState
from repro_torch.optimizers.baselines import (adam, adam_transform,
                                              sgd_momentum,
                                              sgd_momentum_transform)
from repro_torch.optimizers.kfac import KFACEngine, KFACPipeline, kfac

__all__ = ["Optimizer", "Transform", "TransformState", "KFACEngine",
           "KFACPipeline", "kfac", "sgd_momentum", "sgd_momentum_transform",
           "adam", "adam_transform", "as_optimizer", "get"]


def as_optimizer(opt) -> Optimizer:
    """An :class:`Optimizer` as it is; a :class:`KFACEngine` wrapped into
    the staged pipeline."""
    if isinstance(opt, Optimizer):
        return opt
    if isinstance(opt, KFACEngine):
        return kfac(engine=opt)
    raise TypeError(f"not an optimizer: {type(opt).__name__} (expected an "
                    "Optimizer from repro_torch.optimizers, or a KFACEngine)")


def get(name: str, model=None, *, kfac_cfg=None,
        family: str = "categorical", device="cuda", **kw) -> Optimizer:
    """Optimizer registry for launchers: kfac | sgd | sgd_momentum | adam.
    ``kfac_cfg``, ``family`` and ``device`` are K-FAC's, ``kw`` the
    baseline's (K-FAC ignores them, as in the reference); a baseline's
    state lies where the parameters do."""
    if name == "kfac":
        return kfac(model, kfac_cfg, family, device=device)
    if name in ("sgd", "sgd_momentum"):
        return sgd_momentum(model, **kw)
    if name == "adam":
        return adam(model, **kw)
    raise KeyError(f"unknown optimizer {name!r} "
                   "(expected kfac | sgd_momentum | adam)")
