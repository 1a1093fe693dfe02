"""Parameter trees: nested dicts and lists (and tuples) of tensors, the
port's form of the reference's pytrees.

:func:`tree_leaves` walks a dict in sorted key order, as
``jax.tree_util.tree_leaves`` does, so a sum over leaves (the global
gradient norm) adds its terms in the reference's order.
"""
from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves of ``tree``: dicts in sorted key order, lists and tuples
    in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); returns a tree of that
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
