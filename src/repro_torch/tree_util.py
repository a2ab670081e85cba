"""Nested-container trees of tensors, flattened as ``jax.tree_util`` does.

The training modules keep the reference's pytrees as plain containers: dicts
(parameters, optimizer state), tuples and lists (``(params, opt_state)``),
leaves anything else (tensors, numpy arrays, numbers).  Flattening visits a
dict's keys in sorted order and a tuple's or list's items by index, and a
leaf's path name joins its keys and indices with ``/`` — exactly
``jax.tree_util.tree_flatten_with_path`` and the name the reference's
checkpoint gives it (``0/group0/wq``, ``1/m/embed``), so a tree flattens to
the same leaves in the same order, under the same names, in both packages.
``None`` is an empty subtree, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable


def flatten_with_paths(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf)]`` in JAX's order: dict keys sorted, sequences by
    index."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in flatten_with_paths(tree[key], prefix + (key,))]
    if isinstance(tree, (tuple, list)):
        return [item for i, sub in enumerate(tree)
                for item in flatten_with_paths(sub, prefix + (i,))]
    return [(prefix, tree)]


def path_name(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like, values) -> Any:
    """A tree of ``like``'s structure with ``values`` (in flatten order) as
    its leaves."""
    it = iter(values)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            # fill in sorted order, keep the container's own key order
            filled = {key: build(t[key]) for key in sorted(t)}
            return {key: filled[key] for key in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(sub) for sub in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn: Callable, tree) -> Any:
    """``fn`` over the leaves of ``tree``, in its structure."""
    return unflatten(tree, [fn(leaf) for leaf in leaves(tree)])
