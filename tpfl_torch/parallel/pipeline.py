"""Pipeline parallelism — a GPipe-style microbatch schedule over a ``pp``
mesh axis, trainable end to end — counterpart of
:mod:`tpfl.parallel.pipeline` (``pipeline.py:41-202``).

The model is a stack of L identical blocks; each of the n stages (one a
rank) holds L/n consecutive blocks of the stacked params. At each of
``n_micro + n - 1`` ticks every stage applies its blocks to the
activation it holds and hands the result to the next stage
(:func:`~tpfl_torch.parallel.distributed.shift`, forward shifts only:
stage n−1 sends nothing and stage 0 receives nothing); stage 0 takes a
fresh microbatch each tick and every stage banks its results, of which
the last stage's are the finished microbatches. Bubble fraction
(n−1)/(n_micro + n − 1).

Every stage computes at every tick, as the reference's SPMD program does,
so every rank's autograd graph holds every shift and its backward runs
the GPipe backward schedule: cotangents go stage i+1 -> i through the
shifts' transposes, in reverse tick order on every rank. Gradients are
the sequential stack's. The microbatches are data: no gradient flows to
them.

``make_pipeline`` / ``make_pipeline_trainer`` take the GLOBAL stacked
params (the same on every rank) and return the last stage's bank on
every rank. On a one-rank axis (the card's machine) there is no shift.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpfl_torch.learning.torch_learner import SGDMomentum
from tpfl_torch.parallel import distributed as spmd
from tpfl_torch.utils.tree import Tree, tree_leaves, tree_map, tree_unflatten

__all__ = ["make_pipeline", "make_pipeline_trainer", "pipeline_forward"]


def _stage_apply(block_fn: Callable, stage_params: Tree, x: torch.Tensor) -> torch.Tensor:
    """This stage's chunk of blocks over the local layer axis (params
    stacked ``[layers_per_stage, ...]``); the activation keeps x's dtype
    (a promoting ``block_fn`` — bf16 activations, f32 params — is cast
    back, as the reference pins its scan carry)."""
    n_local = tree_leaves(stage_params)[0].shape[0]
    h = x
    for i in range(n_local):
        h = block_fn(tree_map(lambda p: p[i], stage_params), h).to(x.dtype)
    return h


def pipeline_forward(block_fn: Callable, stage_params: Tree, microbatches: torch.Tensor,
                     group: dist.ProcessGroup) -> torch.Tensor:
    """This rank's stage of the pipeline over the axis whose group is
    ``group``: ``stage_params`` are this stage's stacked blocks
    ``[L/n, ...]``, ``microbatches`` ``[n_micro, mb, ...]`` (every stage
    holds them; stage 0 consumes them). Returns this stage's bank
    ``[1, n_micro, mb, ...]``: the finished microbatches on the LAST
    stage, values of the same shape elsewhere. Every rank of the group
    must call it together."""
    n, stage = dist.get_world_size(group), dist.get_rank(group)
    microbatches = microbatches.detach()
    n_micro = microbatches.shape[0]
    first = torch.tensor(stage == 0, device=microbatches.device)
    held = torch.zeros_like(microbatches[0])
    slots: list[Optional[torch.Tensor]] = [None] * n_micro
    ticks = n_micro + n - 1
    for t in range(ticks):
        # Stage 0 takes microbatch t (the last again once they run out);
        # the others keep what the previous stage sent them.
        x = torch.where(first, microbatches[min(t, n_micro - 1)], held)
        y = _stage_apply(block_fn, stage_params, x)
        if t >= n - 1:  # the last stage's microbatch t - (n - 1) is done
            slots[t - (n - 1)] = y
        if t < ticks - 1:
            held = spmd.shift([y], group, wrap=False)[0]
    return torch.stack(slots)[None]


def _check_split(n_layers: int, n: int) -> None:
    if n_layers % n:
        raise ValueError(f"{n_layers} layers do not split over {n} stages")


def make_pipeline(mesh: DeviceMesh, block_fn: Callable, n_layers: int,
                  axis_name: str = "pp") -> Callable:
    """A pipelined forward over ``mesh[axis_name]``:
    ``apply(stacked_params, microbatches)`` with params stacked
    ``[n_layers, ...]`` (the same on every rank; each stage takes its
    ``[n_layers/n, ...]`` slice) returns the last stage's bank
    ``[n_micro, mb, ...]`` on every rank. ``block_fn(layer_params, x) ->
    x`` applies ONE block."""
    group = mesh.get_group(axis_name)
    _check_split(n_layers, dist.get_world_size(group))

    def apply(stacked_params: Tree, microbatches: torch.Tensor) -> torch.Tensor:
        return _pipeline_apply(block_fn, group, stacked_params, microbatches)

    return apply


def _pipeline_apply(block_fn: Callable, group, stacked_params: Tree,
                    microbatches: torch.Tensor) -> torch.Tensor:
    stage_params = tree_unflatten(stacked_params, spmd.shard(tree_leaves(stacked_params), 0, group))
    bank = pipeline_forward(block_fn, stage_params, microbatches, group)
    return spmd.gather(bank, 0, group)[-1]  # the last stage's bank


def make_pipeline_trainer(mesh: DeviceMesh, block_fn: Callable, n_layers: int,
                          loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                          optimizer: Optional[SGDMomentum] = None,
                          learning_rate: float = 0.01, axis_name: str = "pp"
                          ) -> tuple[Callable, Callable]:
    """A trainable pipeline: ``(init, step)``.

    ``loss_fn(outputs, targets) -> scalar`` reads the last stage's bank
    ``[n_micro, mb, ...]``. ``init(stacked_params) -> (params, opt_state)``;
    ``step(params, opt_state, microbatches, targets) -> (params,
    opt_state, loss)`` is one forward, backward and update. The params
    stay global and the same on every rank: each stage's gradients are
    all-gathered, so every rank applies the same update. ``optimizer``
    defaults to ``SGDMomentum(learning_rate, momentum=0.0)``, which is
    ``optax.sgd(learning_rate)``."""
    group = mesh.get_group(axis_name)
    _check_split(n_layers, dist.get_world_size(group))
    opt = optimizer or SGDMomentum(learning_rate, momentum=0.0)

    def init(stacked_params: Tree) -> tuple[Tree, Tree]:
        return stacked_params, opt.init(stacked_params)

    def step(params: Tree, opt_state: Tree, microbatches: torch.Tensor,
             targets: torch.Tensor) -> tuple[Tree, Tree, torch.Tensor]:
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(_pipeline_apply(block_fn, group, live, microbatches), targets)
        grads = torch.autograd.grad(loss, tree_leaves(live))
        params, opt_state = opt.step(params, tree_unflatten(params, grads), opt_state)
        return params, opt_state, loss.detach()

    return init, step
