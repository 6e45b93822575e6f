"""Wire codecs on tensors — the device half of
:mod:`tpfl.learning.compression` (``compression.py:64-287``).

Codec ids are a bitmask (``QUANT8 | TOPK | ZLIB | ZSTD | DELTA``);
named specs ("quant8+zlib") are parsed and validated by
:func:`resolve_codec`, with the reference's messages.

- **int8 symmetric per-leaf quantization** (``quant8``):
  ``scale = max|x| · f32(1/127)`` per leaf (a reciprocal multiply, as
  the reference writes it), guarded to 1 when not positive and finite;
  values ``clip(round(x / scale), ±127)`` as int8, rounded half to even.
- **top-k sparsification** (``topk``): the ``k = max(1, ceil(size ·
  frac))`` largest magnitudes of the raveled leaf, ties lowest index
  first (a stable sort of ``−|x|``: ``torch.topk`` promises no tie
  order), kept at their indices, the rest zero.

The numpy oracles (:func:`q8_encode_np`, :func:`q8_decode_np`,
:func:`topk_encode_np`) are copies of the reference's; the tensor
functions match them bit for bit on the CPU and on the card.

The engine runs the codec inside its round (``Settings.ENGINE_WIRE_CODEC``):
:func:`engine_codec_roundtrip_nodes` round-trips every node's leaf at
once, each row with its own scale and its own top-k, which is what one
node's :func:`engine_codec_roundtrip` does per node. Only tensor
transforms lower there; the host payload path (envelopes, entropy
coders, delta bases) is not ported yet.
"""

from __future__ import annotations

import importlib.util
import math
from typing import Any, Callable

import numpy as np
import torch

from tpfl_torch.utils.tree import tree_leaves

# Codec-id bits (the byte negotiated in the reference's envelope).
QUANT8 = 0x01
TOPK = 0x02
ZLIB = 0x04
ZSTD = 0x08
DELTA = 0x10

_PRIMITIVES = {
    "dense": 0,
    "quant8": QUANT8,
    "topk": TOPK,
    "zlib": ZLIB,
    "zstd": ZSTD,
}

#: ``np.float32(1/127)``: the quantization scale is ``max|x|`` times this.
_INV127 = float(np.float32(1.0 / 127.0))


def _zstd_available() -> bool:
    """Whether the optional ``zstandard`` package is installed (asked
    without importing it: the port imports torch and numpy only)."""
    return importlib.util.find_spec("zstandard") is not None


def resolve_codec(spec: "str | int") -> int:
    """Codec-id byte from a named spec ("dense", "quant8+zlib",
    "topk+quant8+zstd") or a raw bitmask. Raises ``ValueError`` on
    unknown names or an unavailable entropy backend (``zstd`` without
    the ``zstandard`` package installed)."""
    if isinstance(spec, int):
        bits = spec
    else:
        bits = 0
        for part in str(spec).replace(".", "+").split("+"):
            part = part.strip().lower()
            if part not in _PRIMITIVES:
                raise ValueError(
                    f"Unknown wire codec {part!r}; known: "
                    f"{sorted(_PRIMITIVES)} (composed with '+')"
                )
            bits |= _PRIMITIVES[part]
    if bits & ZSTD and not _zstd_available():
        raise ValueError(
            "wire codec requests zstd but the 'zstandard' package is "
            "not installed; use 'zlib' instead"
        )
    if bits & ZLIB and bits & ZSTD:
        raise ValueError("pick one entropy coder: zlib or zstd, not both")
    return bits


def codec_name(bits: int) -> str:
    """Human-readable name for a codec-id byte."""
    parts = [n for n, b in _PRIMITIVES.items() if b and bits & b]
    if bits & DELTA:
        parts.append("delta")
    return "+".join(parts) if parts else "dense"


def is_dense(spec: "str | int") -> bool:
    return resolve_codec(spec) == 0


# --- tensor codecs ----------------------------------------------------------
#
# The row forms work on [n, m] f32 (m > 0): each row is one leaf, with its
# own scale and its own top-k. One leaf is one row.


def _q8_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[n, m] f32 -> (int8 [n, m], f32 scale [n, 1])."""
    scale = x.abs().amax(dim=1, keepdim=True) * _INV127
    scale = torch.where((scale > 0) & torch.isfinite(scale), scale,
                        torch.ones_like(scale))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _topk_rows(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[n, m] f32 -> (int64 indices [n, k], f32 values [n, k]), largest
    magnitudes first, ties lowest index first."""
    idx = torch.sort(-x.abs(), dim=1, stable=True).indices[:, :k]
    return idx, torch.gather(x, 1, idx)


def q8_encode(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 symmetric per-leaf quantization: (int8 values of x's shape,
    0-d f32 scale). Empty leaves quantize to themselves at scale 1."""
    x = x.to(torch.float32)
    if x.numel() == 0:
        return x.to(torch.int8), torch.ones((), dtype=torch.float32, device=x.device)
    q, scale = _q8_rows(x.reshape(1, -1))
    return q.reshape(x.shape), scale.reshape(())


def q8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def topk_encode(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k by magnitude over the raveled leaf: (uint32 indices, f32
    values), ties lowest index first."""
    flat = x.to(torch.float32).reshape(1, -1)
    if flat.numel() == 0:
        return torch.zeros((0,), dtype=torch.uint32, device=x.device), flat.reshape(0)
    idx, vals = _topk_rows(flat, k)
    return idx[0].to(torch.uint32), vals[0]


# --- host-side numpy reference (the semantics the tensor codecs match) -----


def q8_encode_np(x) -> "tuple[np.ndarray, np.float32]":
    """Pure-numpy reference for :func:`q8_encode`."""
    x = np.asarray(x).astype(np.float32)
    if x.size == 0:
        return x.astype(np.int8), np.float32(1.0)
    scale = np.float32(np.max(np.abs(x)) * np.float32(1.0 / 127.0))
    if not (scale > 0 and np.isfinite(scale)):
        scale = np.float32(1.0)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


def q8_decode_np(q, scale) -> np.ndarray:
    return np.asarray(q).astype(np.float32) * np.float32(scale)


def topk_encode_np(x, k) -> "tuple[np.ndarray, np.ndarray]":
    """Pure-numpy reference for :func:`topk_encode` (stable argsort:
    lowest-index-first tie order)."""
    flat = np.asarray(x).astype(np.float32).ravel()
    if flat.size == 0:
        return np.zeros((0,), np.uint32), flat
    order = np.argsort(-np.abs(flat), kind="stable")[:k]
    return order.astype(np.uint32), flat[order]


# --- engine (in-round) codecs -----------------------------------------------

#: Codec bits the engine's round can run: tensor -> tensor transforms
#: only. Entropy coders (zlib/zstd) and residuals (delta) are HOST byte
#: transforms with no in-round meaning.
ENGINE_CODEC_BITS = QUANT8 | TOPK


def resolve_engine_codec(spec: "str | int") -> int:
    """Codec-id byte for ``Settings.ENGINE_WIRE_CODEC`` ("dense",
    "quant8", "topk", "topk+quant8"). Raises ``ValueError`` for byte
    transforms (zlib/zstd/delta) that cannot run inside a round — at
    knob-read time, not mid-window."""
    bits = resolve_codec(spec)
    if bits & ~ENGINE_CODEC_BITS:
        raise ValueError(
            f"engine wire codec {codec_name(bits)!r} includes host-side "
            "byte transforms; the in-program codec composes only "
            "'quant8' and 'topk'"
        )
    return bits


def _topk_k(size: int, topk_frac: float) -> int:
    return max(1, int(math.ceil(size * float(topk_frac))))


def _roundtrip_rows(x: torch.Tensor, bits: int, topk_frac: float) -> torch.Tensor:
    """What a receiver decodes from each row of [n, m] f32 (m > 0)."""
    m = x.shape[1]
    if bits & TOPK and m > 1:
        idx, vals = _topk_rows(x, _topk_k(m, topk_frac))
        if bits & QUANT8:
            vals = q8_decode(*_q8_rows(vals))
        return torch.zeros_like(x).scatter_(1, idx, vals)
    if bits & QUANT8:
        return q8_decode(*_q8_rows(x))
    return x


def engine_codec_roundtrip_nodes(bits: int, topk_frac: float) -> Callable:
    """Every node's per-leaf wire round trip at once: a node-stacked leaf
    ``[N, ...]`` -> what each node's receiver would decode from its row
    (the reference's ``vmap`` of :func:`engine_codec_roundtrip` over the
    node axis), in the leaf's dtype. The per-leaf policy is the
    reference's: non-float and empty leaves ride dense, top-k needs more
    than one element (a one-element leaf falls back to quant8)."""
    if not bits & (QUANT8 | TOPK):
        return lambda x: x

    def leaf_roundtrip(x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if x[0].numel() == 0 or not x.is_floating_point():
            return x
        rows = x.reshape(n, -1).to(torch.float32)
        return _roundtrip_rows(rows, bits, topk_frac).reshape(x.shape).to(x.dtype)

    return leaf_roundtrip


def engine_codec_roundtrip(bits: int, topk_frac: float) -> Callable:
    """ONE node's per-leaf wire round trip (``compression.py:227``): a
    leaf -> the leaf a RECEIVER would decode, in its own dtype. Same
    leaf policy as :func:`engine_codec_roundtrip_nodes`."""
    if not bits & (QUANT8 | TOPK):
        return lambda x: x
    nodes = engine_codec_roundtrip_nodes(bits, topk_frac)
    return lambda x: nodes(x[None])[0]


def wire_bytes_per_model(tree: Any, bits: int, topk_frac: float = 0.05) -> int:
    """Tensor payload bytes ONE node's model ships per exchange under a
    codec — values plus scales / indices, not envelope or framing
    overhead — with the per-leaf policy of the round trip. Leaves are
    tensors (a ``meta`` tensor gives the shape and dtype alone)."""
    total = 0
    for leaf in tree_leaves(tree):
        size = leaf.numel()
        if size == 0:
            continue
        if not leaf.is_floating_point() or not bits & (QUANT8 | TOPK):
            total += size * leaf.element_size()
        elif bits & TOPK and size > 1:
            k = _topk_k(size, topk_frac)
            total += k * 4  # uint32 indices
            total += (k * 1 + 4) if bits & QUANT8 else k * 4
        elif bits & QUANT8:
            total += size * 1 + 4  # int8 values + f32 scale
        else:
            total += size * leaf.element_size()
    return total


__all__ = [
    "DELTA", "ENGINE_CODEC_BITS", "QUANT8", "TOPK", "ZLIB", "ZSTD",
    "codec_name", "engine_codec_roundtrip", "engine_codec_roundtrip_nodes",
    "is_dense", "q8_decode", "q8_decode_np", "q8_encode", "q8_encode_np",
    "resolve_codec", "resolve_engine_codec", "topk_encode", "topk_encode_np",
    "wire_bytes_per_model",
]
