"""Parameter descriptors (mirrors ``repro/models/params.py``).

A model describes its parameters as a tree (dicts and tuples) of
:class:`ParamDef` leaves, a pure function of the config; :func:`materialize`
turns the tree into tensors.  The reference's sharding specs, abstract
shapes and shardings are TPU-mesh machinery and are not carried over.

The port draws its own initial values from an explicit ``torch.Generator``
(the JAX PRNG cannot be reproduced in torch): the same initializers and
scales as the reference, not the same numbers.  Tests that compare the two
packages carry JAX's ``init_params`` across instead
(``repro_torch.convert.lm_params_from_numpy``).  The reference's ``scale``
and ``dtype`` fields and its ``ones`` initializer serve families the port
has not ported yet (Mamba, RWKV); they come with them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"      # normal (1/sqrt(fan_in)) | zeros | embed (0.02)

    @property
    def fan_in(self) -> int:
        # last-but-one dim is fan-in for matmul weights; 1-d params use size
        if len(self.shape) >= 2:
            return self.shape[-2]
        return max(1, self.shape[0])


def leaves(tree):
    """The ``ParamDef`` leaves in the reference's tree order (dict keys
    sorted, tuples in order), with their paths."""
    if isinstance(tree, ParamDef):
        return [((), tree)]
    items = (sorted(tree.items()) if isinstance(tree, dict)
             else enumerate(tree))
    return [((k,) + path, leaf) for k, sub in items
            for path, leaf in leaves(sub)]


def materialize(generator: torch.Generator, tree, device=None):
    """float32 tensors for every ``ParamDef`` of ``tree``, drawn in tree
    order from ``generator`` on ``device`` (the generator's by default)."""
    device = torch.device(device if device is not None else generator.device)
    made = {}
    for path, d in leaves(tree):
        if d.init == "zeros":
            made[path] = torch.zeros(d.shape, device=device)
            continue
        scale = 0.02 if d.init == "embed" else 1.0 / math.sqrt(d.fan_in)
        made[path] = torch.randn(d.shape, generator=generator,
                                 device=device).mul_(scale)

    def build(sub, path=()):
        if isinstance(sub, ParamDef):
            return made[path]
        if isinstance(sub, dict):
            return {k: build(v, path + (k,)) for k, v in sub.items()}
        return tuple(build(v, path + (i,)) for i, v in enumerate(sub))

    return build(tree)


def count(tree) -> int:
    return sum(math.prod(d.shape) for _, d in leaves(tree))
