"""RefreshPlan: cost-model bin-packing of curvature blocks (mirrors
``repro/distributed/plan.py``, the part the staggered refresh reads).

Every curvature block gets a scalar inversion-cost estimate from its factor
layout (the ``LayerMeta`` shape metadata), and :func:`bin_pack` spreads the
blocks over ``n_shards`` bins with the longest-processing-time greedy rule.
``KFACEngine.stagger_groups`` packs them into T3 bins, one refresh group a
step, so the per-step d³ work is even instead of whatever layer-declaration
order would give.

Greedy LPT guarantees ``max_load − max_single_cost ≤ min_load``: no bin
exceeds the ideal by more than one block.  Pure Python: the groups are
fixed before the first step, and no device value is read.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping

# pseudo-block key for the tridiagonal chain's Ψ/Σ precompute, costed like
# a full serial pass over the layer blocks (it needs every layer's factors)
CHAIN = "__chain__"


def matrix_inverse_cost(dim: int, kind: str, blocks: int, lead: int) -> float:
    """O(d³)-model cost of inverting or eigendecomposing one factor side.

    ``diag`` factors cost d (an elementwise reciprocal); ``block`` factors
    invert ``blocks`` independent (d/blocks)² matrices; full factors d³.
    ``lead`` multiplies in the stacked / expert batch dims.
    """
    if kind == "diag":
        return float(lead * dim)
    if kind == "block":
        blocks = max(1, blocks)
        return float(lead * blocks * (dim // blocks) ** 3)
    return float(lead * dim ** 3)


def block_cost(meta) -> float:
    """d³ refresh cost of one curvature block (both factor sides)."""
    lead = max(1, meta.n_stack) * max(1, meta.n_expert)
    return (matrix_inverse_cost(meta.a_dim, meta.a_kind, meta.a_blocks, lead)
            + matrix_inverse_cost(meta.g_dim, meta.g_kind, meta.g_blocks,
                                  lead))


def bin_pack(costs: Mapping[str, float], n_bins: int) -> Dict[str, int]:
    """Deterministic LPT greedy: heaviest item first, into the least-loaded
    bin (ties by bin index; item ties by name).  Guarantees
    ``max_load - max(costs) <= min_load``."""
    if n_bins < 1:
        raise ValueError(f"n_bins must be >= 1, got {n_bins}")
    loads = [0.0] * n_bins
    owners: Dict[str, int] = {}
    for name in sorted(costs, key=lambda k: (-costs[k], str(k))):
        b = min(range(n_bins), key=lambda i: (loads[i], i))
        owners[name] = b
        loads[b] += costs[name]
    return owners


@dataclasses.dataclass(frozen=True)
class RefreshPlan:
    """Assignment of curvature blocks to refresh shards (here: the T3
    steps of the staggered refresh).  ``owners[name]`` is the shard that
    refreshes block ``name``; ``costs[name]`` the d³ cost it was packed
    by."""

    n_shards: int
    owners: Mapping[str, int]
    costs: Mapping[str, float]

    def groups(self) -> List[List[str]]:
        """Per-shard block-name lists (deterministic order)."""
        out: List[List[str]] = [[] for _ in range(self.n_shards)]
        for name in sorted(self.owners):
            out[self.owners[name]].append(name)
        return out


def build_plan(blocks: Mapping[str, object], n_shards: int, *,
               chain: bool = False) -> RefreshPlan:
    """Bin-pack the registry's blocks over ``n_shards`` by d³ cost.
    ``chain=True`` adds the tridiagonal chain's precompute (:data:`CHAIN`)
    as one more unit, costed like a full serial pass over the blocks."""
    costs = {name: block_cost(blk.meta) for name, blk in blocks.items()}
    if chain:
        costs[CHAIN] = max(sum(costs.values()), 1.0)
    owners = bin_pack(costs, n_shards)
    return RefreshPlan(n_shards=n_shards, owners=owners, costs=costs)
