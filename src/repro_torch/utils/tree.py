"""Dict-of-tensor helpers (the port's counterpart of ``repro/utils/tree.py``).

A "tree" here is a tensor, ``None``, or a dict, tuple or list of trees —
the shapes the port handles: parameter dicts ``{"W0": ...}``, per-block
inverse dicts ``{"layer0": {"a_inv": ..., "g_inv": ...}}`` and the LM's
parameters with their ``blocks`` tuple.  A leaf's *path* is the tuple of
dict keys and sequence indices that leads to it (``("blocks", 0, "attn",
"wq")``), the reference's ``param_path``.  :func:`flatten_with_keys` also
walks the optimizer states' dataclasses (a field name is a path part) and
gives each leaf the reference's checkpoint key, the parts joined by
``"::"``.
"""
from __future__ import annotations

import dataclasses

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


# ---------------------------------------------------------------------------
# flat "::"-joined keys: the on-disk names of checkpoint and bundle leaves
# ---------------------------------------------------------------------------

SEP = "::"


def _children(tree):
    """``(key, child)`` pairs of a container, in the reference's flattening
    order (``jax.tree_util``): a dict's keys sorted, a dataclass's fields
    in declaration order, a sequence's indices; None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    return None


def flatten_with_keys(tree, prefix=()) -> dict:
    """``{key: leaf}`` with the reference's checkpoint keys: the path's
    parts (dict key, dataclass field name, sequence index) joined by
    ``"::"``.  None contributes no leaf; an empty tuple contributes no leaf
    but still takes its index (a chain's stateless ``scale`` is ``()``)."""
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        return {SEP.join(map(str, prefix)): tree}
    out = {}
    for k, child in kids:
        out.update(flatten_with_keys(child, prefix + (k,)))
    return out


def unflatten_with_keys(template, flat: dict, convert=lambda tmpl, v: v,
                        defaultable: tuple = (), prefix=()):
    """The inverse of :func:`flatten_with_keys`: ``template``'s structure
    with each leaf ``convert(template_leaf, flat[key])``.  A key missing
    from ``flat`` keeps the template's leaf when one of its path parts is
    in ``defaultable`` and raises ``KeyError`` otherwise; keys of ``flat``
    that the template lacks are ignored.  None stays None."""
    if template is None:
        return None
    rec = lambda child, k: unflatten_with_keys(child, flat, convert,
                                               defaultable, prefix + (k,))
    if isinstance(template, dict):
        return {k: rec(v, k) for k, v in template.items()}
    if dataclasses.is_dataclass(template) and not isinstance(template,
                                                             type):
        return dataclasses.replace(template, **{
            f.name: rec(getattr(template, f.name), f.name)
            for f in dataclasses.fields(template)})
    if isinstance(template, (tuple, list)):
        return type(template)(rec(v, i) for i, v in enumerate(template))
    parts = [str(p) for p in prefix]
    key = SEP.join(parts)
    if key not in flat:
        if any(p in defaultable for p in parts):
            return template      # schema migration: the template's value
        raise KeyError(f"checkpoint missing leaf {key!r}")
    return convert(template, flat[key])
