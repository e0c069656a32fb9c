"""Dict-of-tensor helpers (the port's counterpart of ``repro/utils/tree.py``).

A "tree" here is a tensor, ``None``, or a dict, tuple or list of trees —
the shapes the port handles: parameter dicts ``{"W0": ...}``, per-block
inverse dicts ``{"layer0": {"a_inv": ..., "g_inv": ...}}`` and the LM's
parameters with their ``blocks`` tuple.  A leaf's *path* is the tuple of
dict keys and sequence indices that leads to it (``("blocks", 0, "attn",
"wq")``), the reference's ``param_path``.
"""
from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` leafwise."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      path=path + (k,)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, x, *(r[i] for r in rest),
                                             path=path + (i,))
                          for i, x in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree, *rest)


def get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def set_path(tree, path, value):
    """A copy of ``tree`` (its containers only) with the leaf at ``path``
    replaced."""
    if not path:
        return value
    k, rest = path[0], path[1:]
    if isinstance(tree, dict):
        return {**tree, k: set_path(tree[k], rest, value)}
    items = list(tree)
    items[k] = set_path(items[k], rest, value)
    return type(tree)(items)


def tree_unflatten_like(tree, leaves):
    """The leaves (in :func:`tree_leaves` order) put back in ``tree``'s
    structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for sub in tree for x in tree_leaves(sub)]
    return [] if tree is None else [tree]


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x, y):
    """alpha * x + y."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_dot(a, b):
    """Sum of elementwise products across the whole tree (float32 accum)."""
    parts = [torch.sum(x.float() * y.float())
             for x, y in zip(tree_leaves(a), tree_leaves(b))]
    return torch.stack(parts).sum()


def tree_sqnorm(a):
    return tree_dot(a, a)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_isfinite(a):
    """0-d bool tensor: every element of every leaf is finite."""
    return torch.stack([torch.isfinite(x).all() for x in tree_leaves(a)]).all()
