"""Minimal pytrees for the port: nested dicts, lists and tuples of
tensors.

The JAX package passes parameters, gradients and optimizer state around
as pytrees. The port keeps that shape at its functional entry points, and
flattens in the order JAX does: dict keys sorted, lists and tuples in
order. Anything that is not a plain dict, list or tuple is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)`` with dict keys in sorted order."""
    leaves: List[Any] = []

    def walk(t):
        if type(t) is dict:
            keys = sorted(t)
            return (dict, tuple(keys), tuple(walk(t[k]) for k in keys))
        if type(t) in (list, tuple):
            return (type(t), len(t), tuple(walk(x) for x in t))
        leaves.append(t)
        return None

    return leaves, walk(tree)


def tree_unflatten(treedef: Any, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, meta, kids = d
        if kind is dict:
            return {k: build(c) for k, c in zip(meta, kids)}
        return kind(build(c) for c in kids)

    return build(treedef)


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of trees of the same
    structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in
                                    zip(leaves, *others)])
