"""Minimal pytrees for the port: nested dicts, lists and tuples of
tensors.

The JAX package passes parameters, gradients and optimizer state around
as pytrees. The port keeps that shape at its functional entry points, and
flattens in the order JAX does: dict keys sorted, lists and tuples in
order. Anything that is not a plain dict, list or tuple is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _flatten(t: Any, leaves: List[Any]) -> Any:
    if type(t) is dict:
        keys = sorted(t)
        return (dict, tuple(keys), tuple(_flatten(t[k], leaves)
                                         for k in keys))
    if type(t) in (list, tuple):
        return (type(t), len(t), tuple(_flatten(x, leaves) for x in t))
    leaves.append(t)
    return None


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)`` with dict keys in sorted order. The recursion
    is a module function, not a closure that calls itself: such a closure
    is a reference cycle holding the leaves, which only the garbage
    collector frees (a train step's flat gradient copies stayed allocated
    on the card until it ran)."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


def _build(d: Any, it: Iterator[Any]) -> Any:
    if d is None:
        return next(it)
    kind, meta, kids = d
    if kind is dict:
        return {k: _build(c, it) for k, c in zip(meta, kids)}
    return kind(_build(c, it) for c in kids)


def tree_unflatten(treedef: Any, leaves) -> Any:
    return _build(treedef, iter(leaves))


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of trees of the same
    structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in
                                    zip(leaves, *others)])
