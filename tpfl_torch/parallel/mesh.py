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

**Placements.** A :class:`Sharding` is a ``DeviceMesh`` and one
``Shard`` / ``Replicate`` per mesh dim, the counterpart of the
reference's ``NamedSharding``; its :meth:`~Sharding.spec` reads back as
the reference's ``PartitionSpec`` entries. The stacked node axis is
``Shard(0)`` over :func:`node_shard_dims` (``hosts`` and ``nodes``
together, hosts outer: each host's ranks hold a contiguous run of
logical nodes); on the 2D ``nodes x model`` mesh each node's leaf is
also split over ``model`` per a :class:`SpecLayout`
(:func:`stacked_model_shardings`, :func:`global_model_shardings`).
:func:`shard_stacked` pads and places a node-stacked tree through
:func:`~tpfl_torch.parallel.distributed.global_put`.

Node counts that do not divide the node shards are padded, as the
reference's: :func:`padded_node_count` rounds up to
:func:`node_shard_size` (never the model axis; the identity without a
mesh), pad rows clone row 0 (valid rows, trained like any other) and
carry zero fold weight, and the ``valid`` mask keeps them out of the
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
from torch.distributed.tensor import Replicate, Shard

from tpfl_torch import DeviceLike, resolve_device
from tpfl_torch.utils.tree import tree_items, tree_map, tree_unflatten

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


def create_mesh(axes: Optional[dict[str, int]] = None, device: DeviceLike = None,
                ranks: Optional[int] = None) -> DeviceMesh:
    """A ``DeviceMesh`` from an axis-name -> size dict over the world's
    ranks (one device a rank; ``device=None`` means ``cuda``).

    Defaults to one ``nodes`` axis over every rank. Sizes must multiply to
    the world size, or to ``ranks`` (the mesh then spans the first
    ``ranks`` ranks; every rank of the world must still call this); a
    single -1 size is inferred. A process that is in no world asking for
    sizes that multiply to 1 starts a one-rank group over an in-process
    ``HashStore`` (``nccl`` on the card, ``gloo`` on the CPU)."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if ranks is not None:
        if not 1 <= int(ranks) <= world:
            raise ValueError(f"a mesh over {ranks} ranks in a world of {world}")
        world, full = int(ranks), world
    else:
        full = world
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
    if world == full:
        return init_device_mesh(dev.type, tuple(axes.values()), mesh_dim_names=tuple(axes))
    return DeviceMesh(dev.type, torch.arange(world).reshape(tuple(axes.values())),
                      mesh_dim_names=tuple(axes))


def mesh_axis_size(mesh: Optional[DeviceMesh], axis: str = NODE_AXIS) -> int:
    """Size of ``axis`` on ``mesh`` (1 for no mesh / a missing axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def node_shard_dims(mesh: Optional[DeviceMesh], axis: str = NODE_AXIS) -> tuple[str, ...]:
    """The mesh dims the stacked node axis shards over: ``(hosts,
    nodes)`` on a mesh whose ``hosts`` axis is larger than 1, ``(nodes,)``
    otherwise (``tpfl/parallel/mesh.py:82-89``)."""
    if mesh is not None and mesh_axis_size(mesh, HOST_AXIS) > 1:
        return (HOST_AXIS, axis)
    return (axis,)


def node_shard_size(mesh: Optional[DeviceMesh], axis: str = NODE_AXIS) -> int:
    """Combined size of the node-sharding dims (``hosts x nodes`` on a 3D
    mesh): the multiple stacked node counts pad up to."""
    return math.prod(mesh_axis_size(mesh, a) for a in node_shard_dims(mesh, axis))


def padded_node_count(n_nodes: int, mesh: Optional[DeviceMesh] = None,
                      axis: str = NODE_AXIS) -> int:
    """``n_nodes`` rounded up to a multiple of :func:`node_shard_size`:
    the stacked leading dimension that shards evenly. Only the node dims
    enter (a ``nodes 4 x model 2`` mesh pads to multiples of 4); without a
    mesh it is ``n_nodes``."""
    d = node_shard_size(mesh, axis)
    return ((int(n_nodes) + d - 1) // d) * d


@dataclass(frozen=True)
class Sharding:
    """A placement: a ``DeviceMesh`` and one ``Shard(d)`` / ``Replicate()``
    per mesh dim (the reference's ``NamedSharding``)."""

    mesh: DeviceMesh
    placements: tuple

    def spec(self, ndim: int) -> tuple:
        """The reference's ``PartitionSpec`` entries for a tensor of
        ``ndim`` dims: per dim None, one mesh-dim name, or a tuple of names
        (outer first) when several mesh dims split it."""
        names = self.mesh.mesh_dim_names
        by_dim: dict[int, list[str]] = {}
        for i, p in enumerate(self.placements):
            if p.is_shard():
                by_dim.setdefault(p.dim, []).append(names[i])
        return tuple(None if d not in by_dim else by_dim[d][0] if len(by_dim[d]) == 1
                     else tuple(by_dim[d]) for d in range(ndim))


def _sharding(mesh: DeviceMesh, shard_dims: dict[str, int]) -> Sharding:
    """``Shard(shard_dims[name])`` on the named mesh dims, ``Replicate``
    elsewhere."""
    return Sharding(mesh, tuple(Shard(shard_dims[n]) if n in shard_dims else Replicate()
                                for n in mesh.mesh_dim_names))


def federation_sharding(mesh: DeviceMesh, axis: str = NODE_AXIS) -> Sharding:
    """Node-stacked trees: the leading axis over :func:`node_shard_dims`,
    every other mesh dim replicated (``tpfl/parallel/mesh.py:101-112``).
    The leading dimension must divide :func:`node_shard_size` (pad with
    :func:`padded_node_count` + :func:`pad_node_axis` first)."""
    return _sharding(mesh, dict.fromkeys(node_shard_dims(mesh, axis), 0))


def round_node_sharding(mesh: DeviceMesh, axis: str = NODE_AXIS) -> Sharding:
    """Per-round per-node ``[n_rounds, nodes]`` arrays (weights, attack
    scales, fedbuff masks, the carry's node rows): rounds replicated, the
    node axis placed like the stacked state."""
    return _sharding(mesh, dict.fromkeys(node_shard_dims(mesh, axis), 1))


def replicated(mesh: DeviceMesh) -> Sharding:
    return _sharding(mesh, {})


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


def shard_stacked(mesh: Optional[DeviceMesh], tree: Any, n_nodes: Optional[int] = None,
                  axis: str = NODE_AXIS) -> Any:
    """Place a node-stacked tree on the mesh, padding the leading axis to
    :func:`padded_node_count` first (``n_nodes`` defaults to the first
    leaf's leading size; ``tpfl/parallel/mesh.py:195-219``). No mesh: the
    tree unchanged. On a 2D mesh only the node axis is padded and split;
    leaves ride replicated over ``model`` (:func:`stacked_model_shardings`
    gives the per-leaf layout)."""
    from tpfl_torch.parallel.distributed import global_put

    if mesh is None:
        return tree
    leaves = [leaf for _, leaf in tree_items(tree)]
    if not leaves:
        return tree
    n = int(n_nodes if n_nodes is not None else leaves[0].shape[0])
    tree = tree_map(torch.as_tensor, tree)
    return global_put(pad_node_axis(tree, padded_node_count(n, mesh, axis)),
                      federation_sharding(mesh, axis))


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

    def leaf_spec(self, path: str, shape: Sequence[int], axis_size: int) -> tuple:
        """The unstacked leaf's ``PartitionSpec`` entries (model-axis dims
        only): :meth:`leaf_dims`."""
        return self.leaf_dims(path, shape, axis_size)


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


def _layout_sharding(mesh: DeviceMesh, lead: tuple, dims: tuple, offset: int,
                     model_axis: str) -> Sharding:
    shard = dict.fromkeys(lead, 0)
    if model_axis in dims and model_axis in mesh.mesh_dim_names:
        shard[model_axis] = offset + dims.index(model_axis)
    return _sharding(mesh, shard)


def stacked_model_shardings(mesh: DeviceMesh, tree: Any, layout: SpecLayout) -> Any:
    """Per-leaf :class:`Sharding` of a node-stacked state tree: the node
    axis over :func:`node_shard_dims`, each node's leaf over ``model`` per
    ``layout`` (``tpfl/parallel/mesh.py:332-348``)."""
    axis_size = mesh_axis_size(mesh, layout.model_axis)
    lead = node_shard_dims(mesh)
    items = [(path, leaf) for path, leaf in tree_items(tree)]
    return tree_unflatten(tree, [
        _layout_sharding(mesh, lead, layout.leaf_dims(_path_str(path), tuple(leaf.shape)[1:],
                                                      axis_size), 1, layout.model_axis)
        for path, leaf in items])


def global_model_shardings(mesh: DeviceMesh, tree: Any, layout: SpecLayout) -> Any:
    """Per-leaf :class:`Sharding` of an unstacked, node-replicated model
    tree (SCAFFOLD's ``c_global``): replicated over the node dims, split
    over ``model`` per ``layout`` (``tpfl/parallel/mesh.py:351-363``)."""
    axis_size = mesh_axis_size(mesh, layout.model_axis)
    items = [(path, leaf) for path, leaf in tree_items(tree)]
    return tree_unflatten(tree, [
        _layout_sharding(mesh, (), layout.leaf_dims(_path_str(path), tuple(leaf.shape),
                                                    axis_size), 0, layout.model_axis)
        for path, leaf in items])
