"""Ring attention — sequence parallelism over a mesh axis, and blockwise
attention in plain PyTorch — counterpart of
:mod:`tpfl.parallel.ring_attention`.

:func:`blockwise_attention` (``ring_attention.py:30-140``) is XLA-level
code in the reference, not a Pallas kernel, so plain torch is its port.
It is ``TransformerBlock``'s attention when no ``attention_fn`` is given.
Differentiable through plain autograd (the reference's recompute VJP is a
memory measure of the XLA program, with the same values).

:func:`ring_attention` (``ring_attention.py:253-501``) runs on one
rank's block of a sequence sharded over a mesh axis: every rank holds
one block of Q, K and V; K/V rotate around the ring (one hop a step,
``batch_isend_irecv``) while each rank folds its Q block's attention
with a numerically stable online softmax (Liu et al. 2023). Two inners:

- ``"flash"``: each step is :func:`~tpfl_torch.parallel.flash_kernel.flash_block_fwd`
  (the ``flash_fwd`` kernel, f32 out) and the steps merge by logsumexp;
  a ``torch.autograd.Function`` banks only (q, k, v, out, lse) and its
  backward recomputes each step with
  :func:`~tpfl_torch.parallel.flash_kernel.flash_block_bwd` (``flash_dq``
  / ``flash_dkv``) fed the GLOBAL lse and delta, rotating K/V with dK/dV
  accumulators that travel with their block, so each block's gradient is
  home after n steps;
- ``"xla"``: the reference's einsum inner, plain torch under autograd
  through a differentiable shift (:func:`~tpfl_torch.parallel.distributed.shift`).

``impl="auto"`` takes the flash inner for CUDA tensors and the einsum
inner for CPU tensors (the reference: flash on a TPU, einsum elsewhere).
A causal ring attends its diagonal step causally and earlier blocks
fully, and skips future blocks while K/V still rotate, so every rank
makes the same calls each step. On a one-rank axis the rotation is the
identity, as the reference's ``ppermute`` over one device moves nothing:
the card's machine runs the ring at axis size 1 (the kernels still run),
and the multi-rank exchange is held to the reference on the CPU over
``gloo``. :func:`make_ring_attention` takes the global ``[B, S, H, D]``
that every rank holds and returns the global output on every rank.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpfl_torch.parallel import distributed as spmd
from tpfl_torch.parallel.flash_kernel import flash_block_bwd, flash_block_fwd

IMPLS = ("auto", "flash", "xla")


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    block_size: Optional[int] = None,
) -> torch.Tensor:
    """Attention blocked over queries and keys with an online softmax:
    q/k/v ``[B, S, H, D]`` -> ``[B, S, H, D]`` in q's dtype. Scores are
    the operands' dtype product cast to f32 (the reference's
    ``einsum(...).astype(f32)``); P·V runs in f32. Causal key blocks
    above the diagonal are never computed; keys past S are masked."""
    b, s, h, d = q.shape
    block = block_size or min(s, 512)
    n_blocks = -(-s // block)
    pad = n_blocks * block - s
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    scale = 1.0 / math.sqrt(d)
    idx = torch.arange(block, device=q.device)
    outs = []
    for i in range(n_blocks):
        q_i = q[:, i * block:(i + 1) * block]
        acc = row_max = denom = None
        # Every row sees a key in block 0 and in each block it attends,
        # so the running max is finite from the first block on.
        for j in range(i + 1 if causal else n_blocks):
            k_pos = j * block + idx
            scores = torch.einsum("bqhd,bkhd->bhqk", q_i, k[:, j * block:(j + 1) * block])
            scores = scores.to(torch.float32) * scale
            mask = (k_pos < s)[None, :]
            if causal:
                mask = mask & ((i * block + idx)[:, None] >= k_pos[None, :])
            scores = scores.masked_fill(~mask, float("-inf"))
            new_max = scores.amax(-1)
            if row_max is not None:
                new_max = torch.maximum(row_max, new_max)
            p = torch.exp(scores - new_max[..., None])
            pv = torch.einsum("bhqk,bkhd->bhqd", p,
                              v[:, j * block:(j + 1) * block].to(torch.float32))
            if acc is None:
                acc, denom = pv, p.sum(-1)
            else:
                corr = torch.exp(row_max - new_max)
                acc = acc * corr[..., None] + pv
                denom = denom * corr + p.sum(-1)
            row_max = new_max
        outs.append(acc / torch.clamp(denom, min=1e-30)[..., None])
    out = torch.cat(outs, dim=2).permute(0, 2, 1, 3)  # [B, S_pad, H, D]
    return out[:, :s].to(q.dtype)


# ---- the ring ----------------------------------------------------------------


def _block_attend(q, k, v, acc, row_max, denom, mask):
    """Fold one K/V block into the running (acc, row_max, denom)
    (``ring_attention.py:30-53``). q ``[B, Lq, H, D]``, k/v
    ``[B, Lk, H, D]``; acc ``[B, H, Lq, D]`` f32; mask ``[Lq, Lk]`` bool or
    None. Scores are the operands' dtype product cast to f32, P·V in f32;
    rows with no visible key yet keep -inf."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    new_max = torch.maximum(row_max, scores.amax(-1))
    correction = torch.exp(torch.where(row_max == float("-inf"),
                                       torch.full_like(row_max, float("-inf")),
                                       row_max - new_max))
    p = torch.exp(scores - new_max[..., None])
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    acc = acc * correction[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                     v.to(torch.float32))
    denom = denom * correction + p.sum(-1)
    return acc, new_max, denom


class _Tie(torch.autograd.Function):
    """``out`` unchanged; the other inputs get zero gradients. Joins a
    rank's last rotated K/V to its output, so that every rank's backward
    runs every rotation's transpose (ranks whose last blocks are causally
    skipped would otherwise leave their neighbours' sends unanswered)."""

    @staticmethod
    def forward(ctx, out, *rest):
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in rest]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.shapes))


def _ring_xla(q, k, v, group, causal: bool = False) -> torch.Tensor:
    """The einsum inner (``ring_attention.py:253-305``), differentiated by
    autograd through :func:`~tpfl_torch.parallel.distributed.shift`."""
    n, my = dist.get_world_size(group), dist.get_rank(group)
    b, lq, h, d = q.shape
    idx = torch.arange(lq, device=q.device)
    acc = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
    row_max = torch.full((b, h, lq), float("-inf"), dtype=torch.float32, device=q.device)
    denom = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    kt, vt = k, v
    for t in range(n):
        src = (my - t) % n  # this step holds the block that started on rank src
        if not causal:
            acc, row_max, denom = _block_attend(q, kt, vt, acc, row_max, denom, None)
        elif src <= my:  # future blocks are fully masked: skipped
            mask = (my * lq + idx)[:, None] >= (src * lq + idx)[None, :]
            acc, row_max, denom = _block_attend(q, kt, vt, acc, row_max, denom, mask)
        if t < n - 1:
            kt, vt = spmd.shift([kt, vt], group)
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    out = out.permute(0, 2, 1, 3).to(q.dtype)  # [B, Lq, H, D]
    return _Tie.apply(out, kt, vt) if n > 1 else out


def _ring_merge(o, lse, o_t, lse_t):
    """Fold one step's ``(o_t, lse_t)`` into the running ``(o, lse)``
    (``ring_attention.py:330-336``): o / o_t ``[B, Lq, H, D]`` (o f32),
    lse / lse_t ``[B, H, Lq]`` f32."""
    new = torch.logaddexp(lse, lse_t)
    a = torch.exp(lse - new).transpose(1, 2)[..., None]
    b = torch.exp(lse_t - new).transpose(1, 2)[..., None]
    return o * a + o_t.to(torch.float32) * b, new


def _ring_steps(n: int, my: int, causal: bool):
    """``(t, diagonal)`` of each step that attends; future blocks of a
    causal ring are skipped (their K/V still rotate)."""
    for t in range(n):
        src = (my - t) % n
        if not causal or src <= my:
            yield t, causal and src == my


def _ring_flash_fwd(q, k, v, group, causal: bool, block: int):
    """The flash ring's forward (``ring_attention.py:339-381``):
    ``(out in q's dtype, lse [B, H, Lq] f32)``."""
    n, my = dist.get_world_size(group), dist.get_rank(group)
    b, lq, h, d = q.shape
    o = torch.zeros((b, lq, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, lq), float("-inf"), dtype=torch.float32, device=q.device)
    steps = dict(_ring_steps(n, my, causal))
    kt, vt = k, v
    for t in range(n):
        if t in steps:
            o, lse = _ring_merge(o, lse, *flash_block_fwd(q, kt, vt, steps[t], block))
        if t < n - 1:
            kt, vt = spmd.send_recv([kt, vt], group)
    return o.to(q.dtype), lse


class _RingFlash(torch.autograd.Function):
    """The flash ring with its ring-level recompute backward
    (``ring_attention.py:384-461``)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal: bool, block: int):
        out, lse = _ring_flash_fwd(q, k, v, group, causal, block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.block = group, causal, block
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        n, my = dist.get_world_size(group), dist.get_rank(group)
        g = g.to(q.dtype)
        # delta from the cotangent and the ROUNDED output the forward
        # returned (out in q's dtype), as the reference takes it.
        delta = (g.to(torch.float32) * out.to(torch.float32)).sum(-1).transpose(1, 2)
        steps = dict(_ring_steps(n, my, ctx.causal))
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkt = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvt = torch.zeros_like(dkt)
        kt, vt = k, v
        for t in range(n):
            if t in steps:
                dq_c, dk_c, dv_c = flash_block_bwd(q, kt, vt, g, lse, delta, steps[t], ctx.block)
                dq, dkt, dvt = dq + dq_c, dkt + dk_c, dvt + dv_c
            # dK / dV accumulators rotate WITH their block: after n hops
            # each block's gradient is back at its owner.
            if t < n - 1:
                kt, vt, dkt, dvt = spmd.send_recv([kt, vt, dkt, dvt], group)
            else:
                dkt, dvt = spmd.send_recv([dkt, dvt], group)
        return dq.to(q.dtype), dkt.to(k.dtype), dvt.to(v.dtype), None, None, None


def _check_impl(impl: str, what: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"{what} impl must be one of 'auto', 'flash', 'xla'; got {impl!r}")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: dist.ProcessGroup, causal: bool = False, impl: str = "auto",
                   block: int = 1024) -> torch.Tensor:
    """Sequence-parallel attention on this rank's blocks ``[B, S/n, H, D]``
    of a sequence sharded over the axis whose ``ProcessGroup`` is
    ``group`` (the reference's ``axis_name`` inside ``shard_map``); K/V
    rotate around the ring. Returns this rank's output block.

    ``impl="auto"`` is ``"flash"`` for CUDA tensors and ``"xla"`` for CPU
    tensors; ``"flash"`` on CPU tensors runs the kernels' plain versions.
    Every rank of the group must call it together."""
    _check_impl(impl, "ring_attention")
    if impl == "auto":
        impl = "flash" if q.is_cuda else "xla"
    if impl == "xla":
        return _ring_xla(q, k, v, group, causal)
    return _RingFlash.apply(q, k, v, group, bool(causal), int(block))


def make_ring_attention(mesh: DeviceMesh, axis_name: str = "sp", causal: bool = False,
                        impl: str = "auto", block: int = 1024) -> Callable:
    """Ring attention over ``mesh[axis_name]`` (``ring_attention.py:504-559``):
    returns ``apply(q, k, v, causal=None)``, which takes the GLOBAL
    ``[B, S, H, D]`` (the same on every rank), shards the sequence over
    the axis, runs :func:`ring_attention` and returns the global output on
    every rank. Differentiable under a replicated loss: the gradients are
    the single-process ones (:func:`~tpfl_torch.parallel.distributed.shard`
    / :func:`~tpfl_torch.parallel.distributed.gather`).

    ``causal`` is fixed at build time; ``apply`` accepts the kwarg
    ``TransformerBlock`` passes and raises if it disagrees. S must divide
    by the axis size."""
    _check_impl(impl, "make_ring_attention")
    group = mesh.get_group(axis_name)
    baked_causal = causal

    def apply(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: Optional[bool] = None) -> torch.Tensor:
        if causal is not None and causal != baked_causal:
            raise ValueError(f"make_ring_attention was built with causal={baked_causal}, "
                             f"called with causal={causal}")
        n = dist.get_world_size(group)
        if q.shape[1] % n:
            raise ValueError(f"sequence length {q.shape[1]} does not split over the "
                             f"{axis_name!r} axis of size {n}")
        local = spmd.shard([q, k, v], 1, group)
        out = ring_attention(*local, group, causal=baked_causal, impl=impl, block=block)
        return spmd.gather(out, 1, group)

    return apply


__all__ = ["blockwise_attention", "make_ring_attention", "ring_attention"]
