"""Nested-dict trees of tensors — the port's one tree helper.

Params, gradients and optimizer traces are nested ``dict``s in the flax
layout, of any depth: ``Conv_0/kernel`` for the CNN,
``TransformerBlock_0/LayerNorm_0/scale`` for the transformer. Leaves are
whatever is not a mapping (tensors, numpy arrays); flax's
``FrozenDict`` is walked like a ``dict`` and comes out as one. Iteration follows
the dicts' insertion order, so :func:`tree_leaves` and :func:`tree_map`
visit leaves in the same order.

The protocol layer also needs JAX's own pytree order, which its byte
formats and flat leaf lists follow: :func:`canonical_leaves` and
:func:`canonical_map` walk dicts in sorted key order, lists and tuples in
order, and treat ``None`` as an empty subtree, as ``jax.tree_util`` does;
:func:`canonical_map` builds its dicts with sorted keys, as JAX's
``tree_map`` does.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable, Iterator, Union

import torch

Tree = dict[str, Union["Tree", torch.Tensor]]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf-wise over ``tree`` and the trees in ``rest``,
    which must have ``tree``'s keys at every level; the result has
    ``tree``'s structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_items(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` pairs, paths joined with ``/`` as flax prints
    them."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def tree_leaves(tree: Any) -> list[Any]:
    """The leaves in :func:`tree_map` order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(like: Any, leaves: Any) -> Any:
    """``like``'s structure over ``leaves`` given in :func:`tree_leaves`
    order."""
    it = iter(leaves)
    return tree_map(lambda _v: next(it), like)


def canonical_leaves(tree: Any) -> list[Any]:
    """Leaves in ``jax.tree_util.tree_leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in canonical_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in canonical_leaves(v)]
    return [tree]


def canonical_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``jax.tree_util.tree_map``: ``fn`` over the leaves of ``tree`` and
    the same-structured ``rest``; dicts come out with sorted keys."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: canonical_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [canonical_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def canonical_unflatten(like: Any, leaves: list[Any]) -> Any:
    """``tree_unflatten(tree_structure(like), leaves)``: ``like``'s
    structure (dicts sorted) with ``leaves`` in canonical order."""
    it = iter(leaves)
    return canonical_map(lambda _v: next(it), like)


__all__ = ["Tree", "canonical_leaves", "canonical_map", "canonical_unflatten", "tree_items",
           "tree_leaves", "tree_map", "tree_unflatten"]
