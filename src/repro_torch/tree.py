"""Parameter trees: nested dicts and lists (and tuples, named tuples
among them) of tensors, the port's form of the reference's pytrees.

:func:`tree_leaves` walks a dict in sorted key order, as
``jax.tree_util.tree_leaves`` does, so a sum over leaves (the global
gradient norm) adds its terms in the reference's order.
"""
from __future__ import annotations


def rebuild(tree, children):
    """A list, tuple or named tuple of ``tree``'s type holding
    ``children`` (an iterable)."""
    if hasattr(type(tree), '_fields'):
        return type(tree)(*children)
    return type(tree)(children)


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
        return rebuild(tree, (tree_map(fn, v, *(r[i] for r in rest))
                              for i, v in enumerate(tree)))
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over the leaves of ``tree``:
    ``path`` is the tuple of dict keys and list indices from the root, the
    port's form of a JAX key path."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return rebuild(tree, (tree_map_with_path(fn, v, *(r[i] for r in rest),
                                                 path=path + (i,))
                              for i, v in enumerate(tree)))
    return fn(path, tree, *rest)
