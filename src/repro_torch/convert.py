"""Carry parameters and optimizer state across from numpy.

The JAX reference's pytrees cross into the port as numpy (in a test:
``jax.tree.map(np.asarray, tree)``), so the two implementations can start
from one state and be compared step by step.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.transform import KFACState, TransformState
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map


def _tensor(x, device):
    return torch.as_tensor(np.array(x), device=device)


def _tree(x, device):
    return tree_map(lambda a: _tensor(a, device), x)


def params_from_numpy(params: Dict[str, np.ndarray],
                      device="cuda") -> Dict[str, torch.Tensor]:
    """``{"W0": array, ...}`` -> the same dict of float32 tensors."""
    device = resolve_device(device)
    return {k: _tensor(v, device).float() for k, v in params.items()}


def lm_params_from_numpy(params, device="cuda"):
    """The reference's ``LM.init_params`` tree as numpy (``jax.tree.map(
    np.asarray, params)``: dicts, the ``blocks`` tuple with its leading
    ``n_groups`` dim on every leaf; whisper's ``enc_blocks`` stacked over
    the encoder layers, ``enc_conv1``/``enc_conv2`` and ``head``) -> the
    same tree of float32 tensors, the layout ``repro_torch.models.lm.LM``
    reads (and the layout of an LM's K-FAC ``delta0`` and ``diag``)."""
    device = resolve_device(device)
    return tree_map(lambda x: _tensor(x, device).float(), params)


def state_from_numpy(state: Mapping[str, Any], device="cuda") -> KFACState:
    """A K-FAC state given field by field as numpy (nested dicts for
    factors / inv, and for diag / delta0 the parameters' own tree, an LM's
    with its stacked ``blocks`` tuple; ``vars(jax_state)`` after
    ``jax.tree.map(np.asarray, ...)``) -> the port's :class:`KFACState`.
    A tridiag state's ``factors["__cross__"]`` (a dict) and
    ``inv["__tri__"]`` (lists of tensors and of dicts, or ``None`` before
    the first refresh) keep their structure.  ``staleness`` and
    ``inv_pending`` default to 0 and None."""
    device = resolve_device(device)
    fields = {k: _tree(state[k], device)
              for k in ("step", "k_stats", "lam", "gamma", "factors", "inv",
                        "diag", "delta0", "m_delta", "loss_prev")}
    staleness = state.get("staleness")
    fields["staleness"] = (_tensor(staleness, device) if staleness is not None
                           else torch.zeros((), dtype=torch.int32,
                                            device=device))
    return KFACState(**fields, inv_pending=_tree(state.get("inv_pending"),
                                                 device))


def transform_state_from_numpy(state: Mapping[str, Any],
                               device="cuda") -> TransformState:
    """A first-order optimizer's state given as numpy (``vars(jax_state)``
    after ``jax.tree.map(np.asarray, ...)``): ``step``, and ``inner``, the
    chain's tuple of per-transform states, each ``()``, a velocity tree in
    the parameters' layout, or Adam's ``{"mu", "nu", "count"}`` -> the
    port's :class:`TransformState`, dtypes kept (``step`` and ``count``
    int32)."""
    device = resolve_device(device)
    return TransformState(step=_tensor(state["step"], device),
                          inner=_tree(state["inner"], device))
