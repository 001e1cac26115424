"""Nested-dict trees of tensors: the port's stand-in for ``jax.tree``.

A tree is a dict whose values are trees, lists of trees, or leaves
(anything else: a tensor, a shape stand-in, a spec tuple).  Leaves are
visited in sorted key order, the order ``jax.tree.leaves`` gives a dict,
so a sum over leaves adds in the reference's order.
"""
from __future__ import annotations

__all__ = ["tree_map", "map_with_path", "leaves", "flatten"]


def _is_node(x) -> bool:
    return isinstance(x, (dict, list))


def tree_map(fn, tree, *rest):
    """``fn(leaf, *leaves)`` over matching leaves of ``tree`` and ``rest``
    (which share its structure), in the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree, in the same structure; paths as
    ``flatten`` writes them."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def flatten(tree, prefix: str = "") -> list:
    """[(path, leaf)] in sorted key order; a path joins keys (and list
    indices) with ``/``, as the reference's partition rules read them."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, list):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        out.extend(flatten(v, path) if _is_node(v) else [(path, v)])
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]
