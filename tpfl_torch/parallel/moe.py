"""Expert parallelism — MoE dispatch with ``all_to_all`` over an ``ep``
mesh axis: top-1 serving dispatch (:func:`make_moe_layer`) and a
trainable top-k layer (:func:`make_moe_train_layer`) — counterpart of
:mod:`tpfl.parallel.moe` (``moe.py:36-282``).

One expert a rank. Each rank routes its local tokens, packs up to
``capacity`` tokens per destination expert into a static ``[n, C, D]``
buffer, an ``all_to_all`` swaps the buffers so that every rank receives
its expert's tokens from all ranks, the local expert runs, and a second
``all_to_all`` returns the results to the owning ranks, which scatter
them back into token order. Over-capacity tokens pass through on the
residual path (Switch-style dropping); router ids outside ``[0, n)``
pass through too, never clamped onto an expert.

Training: a softmax router picks the top k experts; the combine is
weighted by the renormalised top-k probabilities, so the router gets
gradients, the unprocessed mass falls back to the residual, and the
Switch-Transformer auxiliary loss keeps the experts' load even. The
exchange is :func:`~tpfl_torch.parallel.distributed.all_to_all`, whose
backward is the inverse exchange; the replicated router enters through
:func:`~tpfl_torch.parallel.distributed.replicate` and the tokens and
experts through :func:`~tpfl_torch.parallel.distributed.shard`, so a
replicated loss differentiates to the single-process gradients. On a
one-rank axis (the card's machine) no exchange is made.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from tpfl_torch.parallel import distributed as spmd
from tpfl_torch.utils.tree import Tree, tree_leaves, tree_map, tree_unflatten

__all__ = ["make_moe_layer", "make_moe_train_layer", "moe_dispatch", "moe_forward_topk"]


def _dispatch(x: torch.Tensor, expert_of: torch.Tensor, expert_fn: Callable,
              capacity: int, group: dist.ProcessGroup) -> tuple[torch.Tensor, torch.Tensor]:
    """One all_to_all dispatch and return (``moe.py:36-87``). ``x`` local
    tokens ``[T, D]``; ``expert_of`` ``[T]`` ints, ids in ``[0, n)``
    dispatch and anything else drops. Returns ``(out [T, D], keep [T]
    bool)``: expert outputs where kept, zero rows for dropped or
    over-capacity tokens."""
    n = dist.get_world_size(group)
    t, d = x.shape
    expert_of = expert_of.long()
    valid = (expert_of >= 0) & (expert_of < n)
    expert_of = torch.where(valid, expert_of, torch.zeros_like(expert_of))
    # Position of each token in its expert's queue (stable order);
    # invalid tokens take no slot.
    onehot = F.one_hot(expert_of, n) * valid[:, None]
    pos = (torch.cumsum(onehot, 0) * onehot).sum(1) - 1  # 0-based; invalid -> -1
    keep = valid & (pos < capacity)
    slot_e = torch.where(keep, expert_of, torch.zeros_like(expert_of))
    slot_c = torch.where(keep, pos, torch.zeros_like(pos))
    contrib = torch.where(keep[:, None], x, torch.zeros_like(x))
    buf = torch.zeros((n, capacity, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((slot_e, slot_c), contrib, accumulate=True)
    # Rank i's buf[e] goes to rank e, which receives its expert's tokens
    # from every rank: [n_src, C, D].
    received = spmd.all_to_all(buf, group)
    out = expert_fn(received.reshape(n * capacity, d)).reshape(n, capacity, d)
    returned = spmd.all_to_all(out, group)  # results back to their owners
    gathered = returned[slot_e, slot_c]
    return torch.where(keep[:, None], gathered, torch.zeros_like(gathered)), keep


def moe_dispatch(x: torch.Tensor, expert_of: torch.Tensor, expert_fn: Callable,
                 capacity: int, group: dist.ProcessGroup) -> torch.Tensor:
    """Top-1 dispatch with residual passthrough on this rank's tokens:
    expert outputs for dispatched tokens, the token itself for dropped
    and over-capacity ones. Every rank of the group must call it
    together."""
    out, keep = _dispatch(x, expert_of, expert_fn, capacity, group)
    return torch.where(keep[:, None], out, x)


def moe_forward_topk(router_w: torch.Tensor, expert_params: Any, x: torch.Tensor,
                     expert_fn: Callable, capacity: int, k: int = 2,
                     group: dist.ProcessGroup = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable top-k MoE on this rank's tokens (``moe.py:104-160``):
    ``router_w [D, n]``, ``expert_params`` this rank's expert stacked at
    index 0, ``x [T, D]``. Returns ``(y [T, D], aux_loss)``: routing by
    softmax and top k, combine weights the renormalised top-k
    probabilities, the unprocessed mass on the residual path, and the
    Switch load-balance loss ``n · Σ_e f_e · p̄_e`` over the axis
    (minimal, 1, at a uniform load). Capacity is per choice rank (k
    buffers of ``capacity``). ``group`` None is the whole world."""
    n = dist.get_world_size(group)
    my_params = tree_map(lambda p: p[0], expert_params)
    probs = torch.softmax((x @ router_w).to(torch.float32), dim=-1)
    top_p, top_e = torch.topk(probs, k)
    gate = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    y = torch.zeros_like(x)
    kept_mass = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
    for j in range(k):
        out_j, keep_j = _dispatch(x, top_e[:, j], lambda toks: expert_fn(my_params, toks),
                                  capacity, group)
        w_j = gate[:, j].to(x.dtype) * keep_j.to(x.dtype)
        y = y + w_j[:, None] * out_j
        kept_mass = kept_mass + w_j
    y = y + (1.0 - kept_mass)[:, None] * x

    # Load balance: the share of tokens whose top choice is e, times the
    # mean router probability of e, both averaged over the axis.
    f = spmd.pmean(F.one_hot(top_e[:, 0], n).to(torch.float32).mean(0), group)
    p_mean = spmd.pmean(probs.mean(0), group)
    return y, n * torch.sum(f * p_mean)


def _check_experts(experts: Any, n: int, axis_name: str, extra: str = "") -> None:
    for leaf in tree_leaves(experts):
        if leaf.shape[0] != n:
            raise ValueError(f"Expert param leading dim {leaf.shape[0]} != mesh axis "
                             f"{axis_name}={n} (one expert per device{extra})")


def _local(tokens: torch.Tensor, experts: Tree, group) -> tuple[torch.Tensor, Tree]:
    """This rank's tokens, and its expert stacked at index 0
    (``p[rank:rank+1]``), in one :func:`~tpfl_torch.parallel.distributed.shard`."""
    x, *leaves = spmd.shard([tokens, *tree_leaves(experts)], 0, group)
    return x, tree_unflatten(experts, leaves)


def make_moe_train_layer(mesh: DeviceMesh, expert_fn: Callable, capacity: int, k: int = 2,
                         axis_name: str = "ep") -> Callable:
    """Trainable expert-parallel layer over ``mesh[axis_name]``:
    ``apply(params, tokens) -> (y, aux_loss)`` with ``params = {"router":
    [D, n_experts], "experts": stacked expert params [n_experts, ...]}``
    and tokens ``[T_global, D]``, the same on every rank; y is global on
    every rank. Add ``aux_loss`` to the task loss (scaled by ~1e-2)."""
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)

    def apply(params: dict, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        _check_experts(params["experts"], n, axis_name)
        router = params["router"]
        if router.shape[-1] != n:
            raise ValueError(f"Router output dim {router.shape[-1]} != n_experts {n}")
        x, experts = _local(tokens, params["experts"], group)
        y, aux = moe_forward_topk(spmd.replicate(router, group), experts, x, expert_fn,
                                  capacity, k, group)
        return spmd.gather(y, 0, group), aux

    return apply


def make_moe_layer(mesh: DeviceMesh, expert_fn: Callable, router_fn: Callable,
                   capacity: int, axis_name: str = "ep") -> Callable:
    """Expert-parallel layer over ``mesh[axis_name]``:
    ``apply(stacked_expert_params, tokens)`` with expert params stacked
    ``[n_experts, ...]`` (one expert a rank) and tokens ``[T_global, D]``,
    the same on every rank; ``router_fn(tokens) -> [T]`` ints picks each
    token's expert. Returns the global output on every rank."""
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)

    def apply(stacked_expert_params: Tree, tokens: torch.Tensor) -> torch.Tensor:
        _check_experts(stacked_expert_params, n, axis_name,
                       "; p[0] would silently drop the rest")
        x, experts = _local(tokens, stacked_expert_params, group)
        my_params = tree_map(lambda p: p[0], experts)
        out = moe_dispatch(x, router_fn(x), lambda toks: expert_fn(my_params, toks),
                           capacity, group)
        return spmd.gather(out, 0, group)

    return apply
