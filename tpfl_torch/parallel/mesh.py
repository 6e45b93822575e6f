"""Device meshes and the node-axis helpers — counterpart of
:mod:`tpfl.parallel.mesh`.

:func:`create_mesh` lays named axes over the ranks of a
``torch.distributed`` world (one device a rank) and returns a
``DeviceMesh``; ``mesh.get_group(axis)`` is the axis' ``ProcessGroup``,
which the SPMD planes (:mod:`~tpfl_torch.parallel.ring_attention`,
:mod:`~tpfl_torch.parallel.pipeline`, :mod:`~tpfl_torch.parallel.moe`)
take where the reference's code inside ``shard_map`` names an axis. A
lone process asking for a one-rank mesh gets a one-rank group over an
in-process ``HashStore`` (no socket); any larger mesh needs a world that
:func:`~tpfl_torch.parallel.distributed.ensure_distributed` started.

:class:`SpecLayout` is the reference's per-leaf model-axis policy for
the 2D ``nodes x model`` mesh: the dims it names, over the port's
nested-dict param paths. Turning them into placements
(``leaf_spec``, ``stacked_model_shardings``, ``global_model_shardings``)
waits for the engine's mesh (``ROADMAP.md`` §1 item 7).

The node-axis padding helpers are the single-device subset
(``padded_node_count``, ``capacity_tier``, ``pad_node_axis``,
``pad_node_weights``, ``valid_node_mask``). Without a mesh the stacked
node axis needs no padding, so ``padded_node_count`` is the identity;
the other helpers keep the reference's semantics for a caller that pads
all the same: pad rows clone row 0 (valid rows, trained like any other)
and carry zero fold weight, and the ``valid`` mask keeps them out of the
uniform-fallback denominator.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from tpfl_torch import DeviceLike, resolve_device
from tpfl_torch.utils.tree import tree_map

#: Canonical name of the federation axis.
NODE_AXIS = "nodes"

#: Canonical name of the model-parallel axis of the engine's 2D mesh.
MODEL_AXIS = "model"

#: Canonical name of the cross-host axis of the engine's 3D
#: ``hosts x nodes x model`` mesh.
HOST_AXIS = "hosts"

#: Axis names for standalone FSDP / tensor-parallel meshes.
FSDP_AXIS = "fsdp"
TP_AXIS = "tp"


def create_mesh(axes: Optional[dict[str, int]] = None, device: DeviceLike = None) -> DeviceMesh:
    """A ``DeviceMesh`` from an axis-name -> size dict over the world's
    ranks (one device a rank; ``device=None`` means ``cuda``).

    Defaults to one ``nodes`` axis over every rank. Sizes must multiply to
    the world size; a single -1 size is inferred. A process that is in no
    world asking for sizes that multiply to 1 starts a one-rank group over
    an in-process ``HashStore`` (``nccl`` on the card, ``gloo`` on the
    CPU)."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    axes = dict(axes or {NODE_AXIS: world})
    sizes = list(axes.values())
    if sizes.count(-1) == 1:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = world // known
        axes = dict(zip(axes.keys(), sizes))
    total = math.prod(axes.values())
    if total != world:
        raise ValueError(f"Mesh axes {axes} need {total} devices, have {world}")
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(dev.type, tuple(axes.values()), mesh_dim_names=tuple(axes))


def mesh_axis_size(mesh: Optional[DeviceMesh], axis: str = NODE_AXIS) -> int:
    """Size of ``axis`` on ``mesh`` (1 for no mesh / a missing axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def padded_node_count(n_nodes: int) -> int:
    """Stacked node-axis length for ``n_nodes`` on one device: no pad
    rows (the reference rounds up to the mesh's node shards)."""
    return int(n_nodes)


def capacity_tier(n_live: int, floor: int = 1) -> int:
    """Smallest power of two ≥ ``max(n_live, floor, 1)``: the elastic
    engine's capacity buckets (:mod:`tpfl_torch.parallel.membership`).
    The engine's node-stacked state is shaped for the tier, not the live
    count, so churn inside a tier edits the weight mask only."""
    n = max(int(n_live), int(floor), 1)
    tier = 1
    while tier < n:
        tier *= 2
    return tier


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


# --- per-leaf model-axis policy (SpecLayout) ----------------------------------


@dataclass(frozen=True)
class SpecLayout:
    """Per-leaf model-axis dims (``tpfl/parallel/mesh.py:222-267``).

    Rules are ``(path regex, dims)``, ``dims`` a tuple of ``MODEL_AXIS`` /
    None per dimension of ONE node's (unstacked) leaf, matched against
    paths such as ``TransformerBlock_0/Dense_2/kernel``. The first rule
    whose regex matches, whose dims length equals the leaf's rank and
    whose named dims divide the model-axis size wins; every other leaf
    (and every leaf of the default empty layout) rides replicated."""

    name: str = "replicated"
    rules: tuple = ()
    model_axis: str = MODEL_AXIS

    def leaf_dims(self, path: str, shape: Sequence[int], axis_size: int) -> tuple:
        """Model-axis dims for one unstacked leaf at ``path``;
        ``(None, ...)`` is replicated on the model axis."""
        ndim = len(shape)
        if axis_size > 1:
            for pattern, dims in self.rules:
                if len(dims) != ndim or not re.search(pattern, path):
                    continue
                if all(d is None or shape[i] % axis_size == 0 for i, d in enumerate(dims)):
                    return tuple(dims)
        return (None,) * ndim


def transformer_layout() -> SpecLayout:
    """The TransformerLM layout: embeddings sharded over their row dim;
    QKV and FFN-up kernels column-parallel, attention-out and FFN-down
    kernels row-parallel (the Megatron pairing); the logits head
    column-parallel over the vocab; biases of column-parallel kernels with
    their out-features; LayerNorms and the rest replicated."""
    m = MODEL_AXIS
    return SpecLayout(
        name="transformer",
        rules=(
            (r"embedding$", (m, None)),
            (r"TransformerBlock_\d+/Dense_[02]/kernel$", (None, m)),
            (r"TransformerBlock_\d+/Dense_[13]/kernel$", (m, None)),
            (r"TransformerBlock_\d+/Dense_[02]/bias$", (m,)),
            (r"^Dense_\d+/kernel$", (None, m)),
            (r"^Dense_\d+/bias$", (m,)),
        ),
    )


#: Named layouts a ``policy`` selects.
LAYOUTS = {
    "replicated": SpecLayout,
    "transformer": transformer_layout,
}


def layout_for_module(module: Any, policy: str = "auto") -> SpecLayout:
    """The model-axis layout for a zoo module: ``policy`` names one of
    :data:`LAYOUTS`, or is ``"auto"``: the module's own ``spec_layout``
    (``TransformerLM`` declares ``"transformer"``), else
    ``"replicated"``."""
    if policy == "auto":
        policy = getattr(module, "spec_layout", "replicated") or "replicated"
    factory = LAYOUTS.get(policy)
    if factory is None:
        raise ValueError(f"unknown model-axis layout {policy!r}; have "
                         f"{sorted(LAYOUTS)} (or 'auto')")
    return factory()


def _path_str(path: Sequence[Any]) -> str:
    """``TransformerBlock_0/Dense_1/kernel`` from a param path's keys (a
    path of :func:`tpfl_torch.utils.tree.tree_items` is that string
    already)."""
    return path if isinstance(path, str) else "/".join(str(k) for k in path)
