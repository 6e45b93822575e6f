"""ShardedTrainer — data-parallel (+ FSDP) training of ONE model over a
mesh, the port of :mod:`tpfl.parallel.sharded`.

The batch is split over the mesh's ``dp`` axis: each rank runs the step
on its shard, and the global loss is the ranks' mean. With ``fsdp=True``
the params and the optimizer state are stored sharded (:func:`fsdp_spec`:
the last dim that divides): the step all-gathers each sharded leaf for
compute (ZeRO-3's gather-for-compute) and its gradient comes back
reduce-scattered to the shard
(:func:`~tpfl_torch.parallel.distributed.fsdp_gather`); leaves that stay
replicated have their gradients all-reduced. Without FSDP every gradient
is all-reduced. The optimizer then steps each rank's shard, as the
reference's ``opt.update`` steps a sharded state.

Params are one model's tree in flax's layout (HWIO kernels, ``[in,
out]`` dense kernels), so :func:`fsdp_spec` picks the dims the JAX
function picks; the zoo modules run it at a node axis of 1. BatchNorm
trains on the moments of the whole split batch (sync BatchNorm: the
step hands :func:`~tpfl_torch.models.zoo.apply` a ``reduce`` of
:func:`~tpfl_torch.parallel.distributed.sync_mean`), the reference's
semantics, and its running stats stay replicated. Params, optimizer
state and the batch come back as ``DTensor`` s placed on the mesh; the
loss is a plain tensor, the same on every rank.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from tpfl_torch.learning.torch_learner import cross_entropy_loss, default_optimizer
from tpfl_torch.models.zoo import apply, init_state
from tpfl_torch.parallel import distributed as spmd
from tpfl_torch.parallel.mesh import Sharding
from tpfl_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["ShardedTrainer", "fsdp_spec"]


def fsdp_spec(leaf: Any, axis: str, axis_size: int) -> tuple:
    """The FSDP ``PartitionSpec`` entries of one leaf: the LAST dim that
    divides ``axis_size`` (and is at least that large) over ``axis``,
    replicated when none does (``tpfl/parallel/sharded.py:25-46``). Any
    dim gives the same 1/axis_size storage; the last one keeps kernels'
    ``out`` dim sharded, as the reference explains."""
    shape = tuple(np.shape(leaf))
    if not shape:
        return ()
    for i in reversed(range(len(shape))):
        if shape[i] % axis_size == 0 and shape[i] >= axis_size:
            spec: list = [None] * len(shape)
            spec[i] = axis
            return tuple(spec)
    return ()


class ShardedTrainer:
    """Data-parallel (+ optional FSDP) single-model training.

    Args:
        module: a zoo module.
        mesh: a ``DeviceMesh`` with a ``dp`` axis (one rank a device).
        fsdp: store params and optimizer state sharded over ``dp``.
        learning_rate / optimizer_factory / loss_fn / seed: as
            ``TorchLearner``'s (SGD + momentum 0.9 by default).
    """

    def __init__(self, module: Any, mesh: DeviceMesh, fsdp: bool = False,
                 learning_rate: float = 0.1, optimizer_factory: Optional[Callable] = None,
                 loss_fn: Optional[Callable] = None, seed: int = 0) -> None:
        self.module = module
        self.mesh = mesh
        self.fsdp = fsdp
        self.axis = "dp"
        self._dim = mesh.mesh_dim_names.index(self.axis)
        self._group = mesh.get_group(self.axis)
        self._n = int(mesh.size(self._dim))
        self._opt = (optimizer_factory or default_optimizer)(learning_rate)
        self._loss_fn = loss_fn or cross_entropy_loss
        self.seed = seed
        self.device = torch.device(mesh.device_type) if mesh.device_type == "cpu" else \
            torch.device("cuda", torch.cuda.current_device())

    # --- setup ---

    def _sharding(self, dim: Optional[int]) -> Sharding:
        return Sharding(self.mesh, tuple(
            Shard(dim) if (i == self._dim and dim is not None) else Replicate()
            for i in range(self.mesh.ndim)))

    def _param_sharding(self, params: Any) -> Any:
        """Per-leaf placement: :func:`fsdp_spec`'s dim over ``dp`` under
        FSDP, replicated otherwise."""
        def one(p: Any) -> Sharding:
            spec = fsdp_spec(p, self.axis, self._n) if self.fsdp else ()
            return self._sharding(spec.index(self.axis) if self.axis in spec else None)

        return tree_map(one, params)

    def init(self, input_shape: tuple[int, ...]) -> tuple[Any, Any]:
        """(params, opt_state) placed on the mesh (aux-free modules;
        BatchNorm'd models use :meth:`init_with_aux`)."""
        params, aux, opt_state = self.init_with_aux(input_shape)
        if aux:
            raise ValueError(
                f"Module has mutable collections {sorted(aux)} — use "
                f"init_with_aux() and train_step_with_aux()."
            )
        return params, opt_state

    def init_with_aux(self, input_shape: tuple[int, ...]) -> tuple[Any, Any, Any]:
        """(params, aux, opt_state) placed on the mesh: params (and the
        optimizer's trace, like them) per :meth:`_param_sharding`, aux
        (BatchNorm's ``batch_stats``) replicated."""
        params, aux = init_state(self.module, input_shape, self.seed, self.device)
        params = spmd.global_put(params, self._param_sharding(params))
        aux = spmd.global_put(aux, self._sharding(None)) if aux else aux
        opt_state = tree_map(lambda p: spmd.place_like(torch.zeros_like(p.to_local()), p),
                             self._opt.init(params))
        return params, aux, opt_state

    def shard_batch(self, x: Any, y: Any) -> tuple[DTensor, DTensor]:
        """The batch dimension split over ``dp``."""
        sh = self._sharding(0)
        y = torch.as_tensor(np.asarray(y)).to(torch.long)
        return spmd.global_put(torch.as_tensor(np.asarray(x)), sh), spmd.global_put(y, sh)

    # --- step ---

    def _whole(self, leaves: list[torch.Tensor], placed: list[DTensor]) -> list[torch.Tensor]:
        """Each sharded leaf gathered for compute (its gradient
        reduce-scattered back), the replicated ones as they are."""
        out = []
        for t, like in zip(leaves, placed):
            p = like.placements[self._dim]
            out.append(spmd.fsdp_gather(t, p.dim, self._group) if p.is_shard() else t)
        return out

    def _step(self, params: Any, aux: Any, opt_state: Any, x: Any, y: Any,
              with_aux: bool) -> tuple:
        placed = tree_leaves(params)
        local = [t.to_local().detach().requires_grad_(True) for t in placed]
        whole = tree_unflatten(params, self._whole(local, placed))
        xs, ys = _local(x), _local(y)
        a = tree_map(_local, aux) if with_aux else {}
        stacked = tree_map(lambda p: p[None], whole)
        if with_aux:
            reduce = None
            if self._n > 1:  # sync BatchNorm: the moments of the whole batch
                reduce = functools.partial(spmd.sync_mean, group=self._group)
            logits, new_a = apply(self.module, stacked, tree_map(lambda v: v[None], a),
                                  xs[None], train=True, reduce=reduce)
            new_a = tree_map(lambda v: v[0].detach(), new_a)
        else:
            logits, new_a = apply(self.module, stacked, {}, xs[None], train=False)
        loss = self._loss_fn(logits[0], ys).mean()
        grads = list(torch.autograd.grad(loss, local))
        # Leaves that stay replicated: the mean of the ranks' gradients
        # (the sharded ones came back reduce-scattered and averaged).
        for i, like in enumerate(placed):
            if not like.placements[self._dim].is_shard():
                grads[i] = spmd.all_reduce(grads[i], self._group) / self._n
        trace = tree_map(_local, opt_state)
        new_p, new_t = self._opt.step(tree_unflatten(params, [t.detach() for t in local]),
                                      tree_unflatten(params, grads), trace)
        params = tree_map(spmd.place_like, new_p, params)
        opt_state = tree_map(spmd.place_like, new_t, opt_state)
        loss = spmd.all_reduce(loss.detach(), self._group) / self._n
        if with_aux:
            return params, tree_map(spmd.place_like, new_a, aux), opt_state, loss
        return params, opt_state, loss

    def train_step(self, params: Any, opt_state: Any, x: Any, y: Any) -> tuple[Any, Any, Any]:
        """One dp/FSDP step: (params, opt_state, loss)."""
        return self._step(params, {}, opt_state, x, y, with_aux=False)

    def train_step_with_aux(self, params: Any, aux: Any, opt_state: Any, x: Any,
                            y: Any) -> tuple[Any, Any, Any, Any]:
        """One dp/FSDP step threading mutable collections: (params, aux,
        opt_state, loss). BatchNorm trains on the moments of the whole
        split batch (sync BatchNorm), as the reference's logical-batch
        program does, so the updated stats stay replicated."""
        return self._step(params, aux, opt_state, x, y, with_aux=True)


def _local(t: Any) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t

