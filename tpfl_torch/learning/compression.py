"""Wire codecs — the port of :mod:`tpfl.learning.compression`: the codecs
on tensors (``compression.py:64-287``) and the host payload path on top of
them (``compression.py:290-615``).

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
transforms lower there.

The host payload path builds the v2 envelope, byte-equal to the
reference's::

    b"\\x02" + bytes([codec_id]) + msgpack({
        "contributors": [str, ...], "num_samples": int, "info": ...,
        "base_r": int, "base_fp": bytes,   # delta payloads only
        "body": <entropy-wrapped msgpack of the encoded params tree>,
        "crc":  crc32(body)})

Each float leaf becomes a ``__q8__`` (int8 values + f32 scale) or
``__tk__`` (uint32 indices + values, int8 with quant8) record, computed
by the tensor codecs on the leaf's own device; the records' arrays of
every leaf reach the host through one transfer. Non-float, empty and
(for top-k) one-element leaves ride dense. Residual (delta) payloads
carry ``params - base`` against a :class:`BaseCache` base named by
round and :func:`pytree_fingerprint`. The entropy stage is zlib; zstd,
whose package the port never imports, behaves as the reference does
without it (encode leaves the body as is, decode raises
``DecodingParamsError``). Decoding gives numpy leaves (torch-only dtypes
as CPU tensors), like :mod:`tpfl_torch.learning.serialization`.
"""

from __future__ import annotations

import hashlib
import importlib.util
import math
import threading
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch

from tpfl_torch.exceptions import DecodingParamsError, DeltaBaseMismatchError
from tpfl_torch.learning import _msgpack, serialization
from tpfl_torch.utils.tree import canonical_leaves, canonical_map, tree_leaves

WIRE_VERSION_2 = 2
_V2_PREFIX = bytes([WIRE_VERSION_2])

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

_Q8_KEY = "__q8__"
_TK_KEY = "__tk__"

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


# --- host payload path: fingerprints and delta bases -----------------------


def pytree_fingerprint(tree: Any) -> bytes:
    """Order-, shape- and dtype-sensitive sha256 of a params tree (leaves
    in JAX's pytree order, card tensors through one transfer) — the
    identity a delta payload's base is matched on. Both sides compute it
    over the full model they hold; any bit difference makes the receiver
    refuse the delta."""
    leaves = [serialization._Leaf(x, np.ascontiguousarray) for x in canonical_leaves(tree)]
    serialization._fetch(leaves)
    h = hashlib.sha256()
    for leaf in leaves:
        h.update(leaf.name.encode())
        h.update(str(tuple(leaf.shape)).encode())
        h.update(leaf.bytes_view())
    return h.digest()


def _own(x: Any) -> Any:
    return np.array(x) if isinstance(x, np.ndarray) else x


class BaseCache:
    """Thread-safe round -> (fingerprint, host params) cache of adopted
    full models — the delta-gossip bases. Bounded to the last few
    rounds (a delta only ever references ``round - 1``)."""

    KEEP = 3

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._bases: dict[int, tuple[bytes, Any]] = {}

    def put(self, round: int, params: Any) -> None:
        host = canonical_map(_own, serialization.to_host(params))
        fp = pytree_fingerprint(host)
        with self._lock:
            self._bases[int(round)] = (fp, host)
            for r in sorted(self._bases):
                if len(self._bases) <= self.KEEP:
                    break
                del self._bases[r]

    def get(self, round: int) -> Optional[tuple[bytes, Any]]:
        with self._lock:
            return self._bases.get(int(round))

    def lookup(self, round: int, fingerprint: bytes) -> Optional[Any]:
        hit = self.get(round)
        if hit is None or hit[0] != fingerprint:
            return None
        return hit[1]

    def clear(self) -> None:
        with self._lock:
            self._bases.clear()


# --- tree encode/decode ---


def _codec_record(x: Any, bits: int, topk_frac: float, fetch: list) -> dict:
    """One array leaf -> its codec record (the reference's
    ``_encode_leaf``), with the arrays still to bring to the host listed
    in ``fetch`` as ``(record, key, array)``. Non-float, empty and tiny
    leaves stay dense (quantizing a 2-element bias saves nothing and a
    scalar has no top-k). The codec runs on the leaf's own device: the
    tensor functions for tensors, the numpy oracles (bit-equal to them)
    for numpy leaves."""
    name = serialization.dtype_name(x)
    shape = list(x.shape) if isinstance(x, torch.Tensor) else list(np.shape(x))
    size = math.prod(shape)
    sparse = bits & TOPK and size > 1
    if (sparse or bits & QUANT8) and size and serialization.is_float_leaf(x):
        tensor = isinstance(x, torch.Tensor)
        q8 = q8_encode if tensor else q8_encode_np
        rec: dict = {"d": name, "s": shape}
        if sparse:
            idx, vals = (topk_encode if tensor else topk_encode_np)(x, _topk_k(size, topk_frac))
            rec[_TK_KEY] = 1
            fetch.append((rec, "i", idx))
            if not bits & QUANT8:
                fetch.append((rec, "v", vals))
                return rec
            x = vals
        else:
            rec[_Q8_KEY] = 1
        q, scale = q8(x)
        fetch.append((rec, "q", q))
        fetch.append((rec, "sc", scale))
        return rec
    rec = {serialization._ND_KEY: 1, "d": name, "s": shape, "b": None}
    fetch.append((rec, "b", x))
    return rec


def _encode_tree(obj: Any, bits: int, topk_frac: float) -> Any:
    """The params tree in the v2 body encoding, msgpack-ready; every
    record array reaches the host through one transfer."""
    fetch: list = []

    def walk(o: Any) -> Any:
        if serialization.is_array(o):
            return _codec_record(o, bits, topk_frac, fetch)
        if isinstance(o, dict):
            return {k: walk(v) for k, v in o.items()}
        if isinstance(o, tuple):
            return {serialization._TUPLE_KEY: [walk(v) for v in o]}
        if isinstance(o, list):
            return [walk(v) for v in o]
        if o is None or isinstance(o, (bool, int, float, str, bytes)):
            return o
        raise TypeError(f"Cannot serialize object of type {type(o)}")

    tree = walk(obj)
    leaves = [serialization._Leaf(a, np.ascontiguousarray) for _, _, a in fetch]
    serialization._fetch(leaves)
    for (rec, key, _), leaf in zip(fetch, leaves):
        if key == "sc":
            rec[key] = float(serialization.host_value(leaf))
        else:
            rec[key] = leaf.bytes_view()
    return tree


def _as_dtype(a: np.ndarray, dtype: Any) -> Any:
    """``a.astype(dtype)``; a torch-only dtype gives a CPU tensor (torch
    rounds to nearest even, as ``ml_dtypes`` does)."""
    if isinstance(dtype, torch.dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return a.astype(dtype)


def _decode_leaf(rec: dict) -> Any:
    shape = tuple(rec["s"])
    dtype = serialization._resolve_dtype(rec["d"])
    if rec.get(_Q8_KEY) == 1:
        q = np.frombuffer(rec["q"], np.int8).reshape(shape)
        return _as_dtype(q8_decode_np(q, rec["sc"]), dtype)
    # top-k: scatter values back into a zero leaf (vectorized)
    idx = np.frombuffer(rec["i"], np.uint32).astype(np.int64)
    if "q" in rec:
        vals = np.frombuffer(rec["q"], np.int8).astype(np.float32) * rec["sc"]
    else:
        vals = np.frombuffer(rec["v"], np.float32)
    size = int(np.prod(shape)) if shape else 1
    if idx.size and (idx.max() >= size):
        raise DecodingParamsError(
            f"top-k index {int(idx.max())} out of bounds for leaf {shape}"
        )
    flat = np.zeros(size, np.float32)
    flat[idx] = vals
    return _as_dtype(flat.reshape(shape), dtype)


def _decode_tree(obj: Any) -> Any:
    if isinstance(obj, dict):
        if obj.get(_Q8_KEY) == 1 or obj.get(_TK_KEY) == 1:
            return _decode_leaf(obj)
        if obj.get(serialization._ND_KEY) == 1:
            return serialization.decode_tree_v1(obj)
        if serialization._TUPLE_KEY in obj and len(obj) == 1:
            return tuple(_decode_tree(v) for v in obj[serialization._TUPLE_KEY])
        return {k: _decode_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode_tree(v) for v in obj]
    return obj


# --- residuals ---


def _f32(a: Any) -> np.ndarray:
    """A host leaf widened to f32 (exact for every float dtype)."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _residual_tree(params: Any, base: Any) -> Any:
    """``params - base``, float leaves only (in f32; the record keeps the
    original dtype name so decode restores it). Non-float leaves ride
    dense at full value. Dicts in sorted key order, as the reference's
    ``tree_map`` builds them."""
    host = serialization.to_host(params)

    def sub(p: Any, b: Any) -> Any:
        if math.prod(p.shape) and serialization.is_float_leaf(p):
            return _f32(p) - _f32(b)
        return p

    return canonical_map(sub, host, base)


def _apply_residual(residual: Any, base: Any) -> Any:
    """``base + residual``; float leaves come back in the BASE's dtype."""
    def add(r: Any, b: Any) -> Any:
        if math.prod(np.shape(r)) and serialization.is_float_leaf(r):
            bt = b.dtype if isinstance(b, torch.Tensor) else np.asarray(b).dtype
            return _as_dtype(_f32(b) + _f32(r), bt)
        return r

    return canonical_map(add, residual, base)


# --- entropy ---


def _entropy_encode(body: bytes, bits: int, level: int) -> bytes:
    """zlib when asked; zstd needs the ``zstandard`` package, which the
    port never imports, so a zstd body is left as is (as the reference
    does without the package)."""
    if bits & ZLIB:
        return zlib.compress(body, level)
    return body


def _entropy_decode(body: bytes, bits: int) -> bytes:
    if bits & ZSTD:
        raise DecodingParamsError(
            "zstd payload received but the 'zstandard' package is not installed"
        )
    if bits & ZLIB:
        try:
            return zlib.decompress(body)
        except zlib.error as e:
            raise DecodingParamsError(f"zlib decode failed: {e}") from e
    return body


# --- envelope ---


def payload_version(data: Any) -> int:
    """1 for legacy dense payloads, 2 for codec envelopes, 3 for the
    zero-copy header+payload layout, 0 for an in-process by-reference
    payload. O(1)."""
    return serialization.payload_wire_version(data)


def payload_codec(data: Any) -> int:
    """The envelope's codec-id byte (0 = dense v1/v3/by-reference). O(1)."""
    return data[1] if payload_version(data) == WIRE_VERSION_2 else 0


def payload_is_delta(data: Any) -> bool:
    """True when ``data`` is a residual payload that needs a base to
    decode. O(1): reads the codec-id byte only."""
    return bool(payload_codec(data) & DELTA)


def encode_model_payload(
    params: Any,
    contributors: list[str],
    num_samples: int,
    additional_info: dict[str, Any],
    codec: "str | int",
    delta_base: Optional[tuple[int, bytes, Any]] = None,
    topk_frac: float = 0.05,
    level: int = 1,
    trace_id: Optional[str] = None,
) -> bytes:
    """v2 wire envelope. ``delta_base`` is ``(round, fingerprint,
    base_params)`` — when given, the body carries ``params - base`` and
    the envelope names the base so the receiver can refuse a base it
    does not hold. ``trace_id``: hop-tracing id carried as an outer-map
    ``tid`` key."""
    bits = resolve_codec(codec)
    env: dict[str, Any] = {
        "contributors": list(contributors),
        "num_samples": int(num_samples),
        "info": serialization.encode_tree_v1(additional_info),
    }
    if trace_id:
        env["tid"] = str(trace_id)
    tree = params
    if delta_base is not None:
        base_round, base_fp, base_params = delta_base
        tree = _residual_tree(params, serialization.to_host(base_params))
        bits |= DELTA
        env["base_r"] = int(base_round)
        env["base_fp"] = bytes(base_fp)
    body = _msgpack.packb(_encode_tree(tree, bits, topk_frac))
    body = _entropy_encode(body, bits, level)
    env["body"] = body
    env["crc"] = zlib.crc32(body)
    return _V2_PREFIX + bytes([bits]) + _msgpack.packb(env)


def decode_model_payload(
    data: bytes,
    bases: Optional[BaseCache] = None,
) -> tuple[Any, list[str], int, dict[str, Any]]:
    """Decode a v2 envelope. ``bases`` resolves delta payloads; a delta
    without a matching base raises :class:`DeltaBaseMismatchError`."""
    if payload_version(data) != WIRE_VERSION_2:
        raise DecodingParamsError("Not a v2 codec payload")
    bits = data[1]
    try:
        env = _msgpack.unpackb(memoryview(data)[2:])
        body = env["body"]
        if zlib.crc32(body) != env["crc"]:
            raise DecodingParamsError("Payload body CRC mismatch")
        tree = _decode_tree(_msgpack.unpackb(_entropy_decode(body, bits)))
        if bits & DELTA:
            base_round, base_fp = int(env["base_r"]), env["base_fp"]
            base = bases.lookup(base_round, base_fp) if bases else None
            if base is None:
                raise DeltaBaseMismatchError(
                    f"Delta payload needs base round {base_round} "
                    f"(fp {base_fp[:8].hex()}…) which this node does not hold"
                )
            tree = _apply_residual(tree, base)
        return (
            tree,
            list(env["contributors"]),
            int(env["num_samples"]),
            serialization.decode_tree_v1(env["info"]),
        )
    except DecodingParamsError:
        raise
    except (ValueError, KeyError, TypeError, AttributeError, IndexError) as e:
        raise DecodingParamsError(f"Corrupt codec payload: {e}") from e


__all__ = [
    "BaseCache", "DELTA", "ENGINE_CODEC_BITS", "QUANT8", "TOPK", "WIRE_VERSION_2", "ZLIB",
    "ZSTD", "codec_name", "decode_model_payload", "encode_model_payload",
    "engine_codec_roundtrip", "engine_codec_roundtrip_nodes", "is_dense", "payload_codec",
    "payload_is_delta", "payload_version", "pytree_fingerprint", "q8_decode", "q8_decode_np",
    "q8_encode", "q8_encode_np", "resolve_codec", "resolve_engine_codec", "topk_encode",
    "topk_encode_np", "wire_bytes_per_model",
]
