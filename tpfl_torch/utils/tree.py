"""Nested-dict trees of tensors — the port's one tree helper.

Params, gradients and optimizer traces are nested ``dict``s in the flax
layout, of any depth: ``Conv_0/kernel`` for the CNN,
``TransformerBlock_0/LayerNorm_0/scale`` for the transformer. Leaves are
whatever is not a mapping (tensors, numpy arrays); flax's
``FrozenDict`` is walked like a ``dict`` and comes out as one. Iteration follows
the dicts' insertion order, so :func:`tree_leaves` and :func:`tree_map`
visit leaves in the same order.
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


__all__ = ["Tree", "tree_items", "tree_leaves", "tree_map"]
