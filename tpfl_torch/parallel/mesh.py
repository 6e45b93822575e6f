"""Node-axis padding helpers — the single-device subset of
:mod:`tpfl.parallel.mesh` (``padded_node_count``, ``pad_node_axis``,
``pad_node_weights``, ``valid_node_mask``).

Without a mesh the stacked node axis needs no padding, so
``padded_node_count`` is the identity; the other helpers keep the
reference's semantics for a caller that pads all the same: pad rows
clone row 0 (valid rows, trained like any other) and carry zero fold
weight, and the ``valid`` mask keeps them out of the uniform-fallback
denominator.
"""

from __future__ import annotations

from typing import Any

import torch

from tpfl_torch.utils.tree import tree_map


def padded_node_count(n_nodes: int) -> int:
    """Stacked node-axis length for ``n_nodes`` on one device: no pad
    rows (the reference rounds up to the mesh's node shards)."""
    return int(n_nodes)


def pad_node_axis(tree: Any, n_padded: int) -> Any:
    """Pad every tensor's leading (node) axis of a nested dict to
    ``n_padded`` by cloning row 0. No-op when already there."""
    def pad(t: torch.Tensor) -> torch.Tensor:
        extra = n_padded - t.shape[0]
        if extra <= 0:
            return t
        return torch.cat([t, t[:1].expand(extra, *t.shape[1:])], dim=0)

    return tree_map(pad, tree)


def pad_node_weights(weights: torch.Tensor, n_padded: int) -> torch.Tensor:
    """Pad a [N] (or per-round [R, N]) weight tensor with ZEROS on the
    node axis: the masked fold ignores w=0 entries."""
    w = weights.to(torch.float32)
    extra = n_padded - w.shape[-1]
    if extra <= 0:
        return w
    return torch.nn.functional.pad(w, (0, extra))


def valid_node_mask(
    n_nodes: int, n_padded: int, device: torch.device
) -> torch.Tensor:
    """[n_padded] f32: 1.0 for real nodes, 0.0 for pad rows."""
    return (torch.arange(n_padded, device=device) < n_nodes).to(torch.float32)
