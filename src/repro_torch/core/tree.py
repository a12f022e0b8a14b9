"""Param trees: nested dicts, lists and tuples of tensors (the port's
stand-in for ``jax.tree_util`` over the reference's trees).

Leaves come in ``jax.tree_util``'s flatten order: dict keys sorted, lists
and tuples in order. ``None`` is an empty subtree, as in JAX: it has no
leaves and maps to ``None``.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_map_up_to(fn: Callable, structure: Any, *trees: Any) -> Any:
    """``fn`` over the leaves of ``structure`` and, in ``trees``, the whole
    subtree at each such leaf's place (``flatten_up_to``: an optimizer
    state that holds a dict per parameter)."""
    if structure is None:
        return None
    if isinstance(structure, dict):
        return {k: tree_map_up_to(fn, structure[k], *(t[k] for t in trees)) for k in structure}
    if isinstance(structure, (list, tuple)):
        return type(structure)(tree_map_up_to(fn, *xs) for xs in zip(structure, *trees))
    return fn(structure, *trees)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in ``jax.tree_util.tree_leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(structure: Any, leaves) -> Any:
    """``structure``'s shape over ``leaves`` taken in flatten order (the
    inverse of :func:`tree_leaves`; ``structure``'s own leaves are
    ignored)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(structure)
