"""Blockwise attention in plain PyTorch — counterpart of
:func:`tpfl.parallel.ring_attention.blockwise_attention`
(``ring_attention.py:30-140``).

The reference is XLA-level code, not a Pallas kernel, so plain torch is
its port. It is ``TransformerBlock``'s attention when no
``attention_fn`` is given; the flash path never calls it. Differentiable
through plain autograd (the reference's recompute VJP is a memory
measure of the XLA program, with the same values).

The ring over ``torch.distributed`` is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


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


__all__ = ["blockwise_attention"]
