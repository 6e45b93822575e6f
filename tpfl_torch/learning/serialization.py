"""Dtype-preserving, pickle-free model serialization — the port of
:mod:`tpfl.learning.serialization`, byte for byte.

Every array leaf is encoded as dtype/shape-tagged raw bytes and the
tree structure rides as plain msgpack maps/lists (packed by
:mod:`tpfl_torch.learning._msgpack`); decoding never executes code.

Wire envelope (version 1)::

    {"v": 1, "params": <encoded tree>, "contributors": [str, ...],
     "num_samples": int, "info": <encoded tree>}

with a leaf ``{"__nd__": 1, "d": dtype name, "s": shape, "b": bytes}``
and a tuple ``{"__tp__": [...]}``. Version 2 envelopes (codecs, leading
``0x02`` byte) live in :mod:`tpfl_torch.learning.compression`. Version 3
(leading ``0x03``) is the zero-copy layout::

    b"\\x03" | uint32-LE header length | msgpack header | payload

    header = {"params": <tree of leaf descriptors>, "contributors": [...],
              "num_samples": int, "info": <tree of leaf descriptors>,
              "psz": payload bytes}
    leaf descriptor = {"__nd__": 3, "d": dtype, "s": shape, "o": offset,
                       "n": nbytes}

with every leaf in ONE payload region at 64-byte aligned offsets and
zero bytes in the gaps.

Leaves are torch tensors on any device, numpy arrays or numpy scalars.
Tensors on the card reach the host through ONE device-to-host copy per
encode: their bytes are gathered on the card into one buffer first, so
an encode costs one transfer and one synchronisation, not one per leaf.
dtype names are numpy's; ``torch.bfloat16`` (and the float8 types) go
by the names the reference gives them through ``ml_dtypes``
("bfloat16", ...), their bytes read through an integer view of the
same width.

Decoding gives read-only numpy views into the received bytes (no
per-leaf copy); a "bfloat16" (or float8) leaf, which numpy cannot hold
without ``ml_dtypes``, comes back as a CPU tensor of that dtype. The
receiving :class:`~tpfl_torch.learning.model.TpflModel` moves leaves to
its device.
"""

from __future__ import annotations

import math
import struct
from typing import Any, Callable, Optional

import numpy as np
import torch

from tpfl_torch.exceptions import DecodingParamsError
from tpfl_torch.learning import _msgpack
from tpfl_torch.utils.tree import canonical_map

_ND_KEY = "__nd__"
_TUPLE_KEY = "__tp__"

WIRE_VERSION = 1
WIRE_VERSION_3 = 3
_V3_PREFIX = bytes([WIRE_VERSION_3])
_V3_ALIGN = 64
_PAD = bytes(_V3_ALIGN)

#: torch dtypes numpy has no type for: wire name and the integer dtype
#: of the same width their bytes are read through.
_TORCH_ONLY = {
    torch.bfloat16: ("bfloat16", torch.int16),
    torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8),
    torch.float8_e5m2: ("float8_e5m2", torch.uint8),
}
_TORCH_ONLY_BY_NAME = {name: (dt, carrier) for dt, (name, carrier) in _TORCH_ONLY.items()}
_NP_CARRIER = {torch.int16: np.int16, torch.uint8: np.uint8}


def is_array(obj: Any) -> bool:
    """An array leaf: a tensor, a numpy array or a numpy scalar."""
    return isinstance(obj, (torch.Tensor, np.ndarray, np.generic))


def dtype_name(a: Any) -> str:
    """The wire name of a leaf's dtype (numpy's ``dtype.name``)."""
    if isinstance(a, torch.Tensor):
        hit = _TORCH_ONLY.get(a.dtype)
        return hit[0] if hit else str(a.dtype).removeprefix("torch.")
    return np.asarray(a).dtype.name


def is_float_leaf(a: Any) -> bool:
    """A floating-point leaf (``jnp.issubdtype(dtype, jnp.floating)``)."""
    if isinstance(a, torch.Tensor):
        return a.is_floating_point()
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _resolve_dtype(name: str) -> Any:
    """numpy dtype from a wire name, or the torch dtype for the names
    numpy lacks; unknown names raise ``TypeError``."""
    hit = _TORCH_ONLY_BY_NAME.get(name)
    return hit[0] if hit else np.dtype(name)


def host_array(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's numpy view (torch-only dtypes as their integer
    carrier), strides kept."""
    t = t.detach()
    hit = _TORCH_ONLY.get(t.dtype)
    return (t.view(hit[1]) if hit else t).numpy()


def _as_contiguous(a: np.ndarray) -> np.ndarray:
    return a if a.flags.c_contiguous else np.ascontiguousarray(a)


def leaf_bytes(a: np.ndarray) -> "memoryview | bytes":
    """Raw bytes of a contiguous host leaf as a borrowed memoryview (no
    copy), the reference's helper of the same name."""
    a = _as_contiguous(np.asarray(a))
    flat = a.reshape(-1)
    try:
        return memoryview(flat).cast("B")
    except (TypeError, ValueError):
        return memoryview(flat.view(np.uint8))


class _Leaf:
    """One array leaf of a tree being encoded: its wire dtype name and
    shape, and where its bytes are — a contiguous host array, or a card
    tensor until :func:`_fetch` brings every card leaf over at once."""

    __slots__ = ("name", "shape", "host", "dev", "nbytes")

    def __init__(self, obj: Any, gather: Callable[[np.ndarray], np.ndarray]) -> None:
        self.name = dtype_name(obj)
        self.dev: Optional[torch.Tensor] = None
        self.host: Optional[np.ndarray] = None
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            self.dev = obj.detach()
            self.shape = list(obj.shape)
            self.nbytes = obj.numel() * obj.element_size()
            return
        a = host_array(obj) if isinstance(obj, torch.Tensor) else np.asarray(obj)
        self.host = a if a.flags.c_contiguous else gather(a)
        self.shape = list(a.shape)
        self.nbytes = a.nbytes

    def bytes_view(self) -> Any:
        return leaf_bytes(self.host)


def _fetch(leaves: list[_Leaf]) -> None:
    """Bring every card leaf's bytes to the host in ONE transfer: the
    leaves' bytes are concatenated on their device, copied over once,
    and each leaf gets its slice (a uint8 view) of that host buffer."""
    dev = [leaf for leaf in leaves if leaf.dev is not None]
    if not dev:
        return
    flat = torch.cat([leaf.dev.contiguous().reshape(-1).view(torch.uint8) for leaf in dev])
    host = flat.cpu().numpy()
    off = 0
    for leaf in dev:
        leaf.host = host[off:off + leaf.nbytes]
        off += leaf.nbytes
        leaf.dev = None


def host_value(leaf: _Leaf) -> Any:
    """A fetched leaf's values on the host: a numpy array of its dtype
    (a view of the leaf's bytes), or a CPU tensor for torch-only dtypes."""
    dt = _resolve_dtype(leaf.name)
    raw = leaf.host.reshape(-1).view(np.uint8)
    if isinstance(dt, torch.dtype):
        return torch.from_numpy(raw.copy()).view(dt).reshape(leaf.shape)
    return raw.view(dt).reshape(leaf.shape)


def to_host(tree: Any) -> Any:
    """``jax.tree_util.tree_map(np.asarray, tree)``: every leaf on the
    host (numpy, or CPU tensors for torch-only dtypes), card tensors
    through one transfer, dicts in sorted key order."""
    leaves: list = []
    planned = canonical_map(lambda x: leaves.append(_Leaf(x, np.ascontiguousarray))
                            or leaves[-1], tree)
    _fetch(leaves)
    return canonical_map(host_value, planned)


class _Scratch:
    """Pooled contiguation scratch for one encode: a non-C-contiguous
    host leaf (transposed/sliced view) is gathered into a lease of the
    node's :class:`~tpfl_torch.learning.bufferpool.BufferPool` before
    its bytes can be borrowed. Context-managed — error paths release
    every lease."""

    __slots__ = ("_pool", "_leases")

    def __init__(self, pool: Any) -> None:
        self._pool = pool
        self._leases: list = []

    def gather(self, a: np.ndarray) -> np.ndarray:
        if self._pool is None:
            from tpfl_torch.learning.bufferpool import default_pool

            self._pool = default_pool()
        lease = self._pool.acquire(a.nbytes)
        self._leases.append(lease)
        out = np.frombuffer(lease.view(), dtype=a.dtype, count=a.size).reshape(a.shape)
        np.copyto(out, a)
        return out

    def __enter__(self) -> "_Scratch":
        return self

    def __exit__(self, *exc) -> None:
        for lease in self._leases:
            lease.release()
        self._leases.clear()


def plan_tree(obj: Any, leaves: list, gather: Callable[[np.ndarray], np.ndarray]) -> Any:
    """The tree with each array leaf replaced by a :class:`_Leaf`
    (appended to ``leaves`` in walk order) and tuples tagged; scalars,
    strings and bytes pass through."""
    if is_array(obj):
        leaf = _Leaf(obj, gather)
        leaves.append(leaf)
        return leaf
    if isinstance(obj, dict):
        return {k: plan_tree(v, leaves, gather) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return {_TUPLE_KEY: [plan_tree(v, leaves, gather) for v in obj]}
    if isinstance(obj, list):
        return [plan_tree(v, leaves, gather) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return obj
    raise TypeError(f"Cannot serialize object of type {type(obj)}")


def fill_tree(obj: Any, record: Callable[[_Leaf], Any]) -> Any:
    """A planned tree with each :class:`_Leaf` replaced by
    ``record(leaf)``, in walk order."""
    if isinstance(obj, _Leaf):
        return record(obj)
    if isinstance(obj, dict):
        return {k: fill_tree(v, record) for k, v in obj.items()}
    if isinstance(obj, list):
        return [fill_tree(v, record) for v in obj]
    return obj


def _v1_record(leaf: _Leaf) -> dict:
    return {_ND_KEY: 1, "d": leaf.name, "s": leaf.shape, "b": leaf.bytes_view()}


def encode_tree_v1(obj: Any) -> Any:
    """A tree in the v1 leaf encoding (msgpack-ready)."""
    leaves: list = []
    planned = plan_tree(obj, leaves, np.ascontiguousarray)
    _fetch(leaves)
    return fill_tree(planned, _v1_record)


def _leaf_view(buf: Any, dtype: Any, shape: tuple, offset: int, nbytes: int) -> Any:
    """Read-only array view over ``buf[offset:offset+nbytes]`` (0-d and
    empty leaves take the same path); torch-only dtypes come back as a
    CPU tensor copy."""
    count = math.prod(shape) if shape else 1
    if isinstance(dtype, torch.dtype):
        carrier = _NP_CARRIER[_TORCH_ONLY[dtype][1]]
        raw = np.frombuffer(buf, dtype=carrier, count=count, offset=offset) if count else \
            np.empty(0, carrier)
        return torch.from_numpy(raw.copy()).view(dtype).reshape(shape)
    if count == 0:
        a = np.empty(shape, dtype)
        a.flags.writeable = False
        return a
    a = np.frombuffer(buf, dtype=dtype, count=count, offset=offset).reshape(shape)
    if a.flags.writeable:
        a.flags.writeable = False
    return a


def decode_tree_v1(obj: Any) -> Any:
    if isinstance(obj, dict):
        if obj.get(_ND_KEY) == 1:
            raw = obj["b"]
            return _leaf_view(raw, _resolve_dtype(obj["d"]), tuple(obj["s"]), 0, len(raw))
        if _TUPLE_KEY in obj and len(obj) == 1:
            return tuple(decode_tree_v1(v) for v in obj[_TUPLE_KEY])
        return {k: decode_tree_v1(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode_tree_v1(v) for v in obj]
    return obj


def encode_pytree(tree: Any) -> bytes:
    """Serialize a bare tree of arrays (no envelope)."""
    return _msgpack.packb(encode_tree_v1(tree))


def decode_pytree(data: bytes) -> Any:
    try:
        return decode_tree_v1(_msgpack.unpackb(data))
    except (ValueError, KeyError, TypeError, AttributeError) as e:
        raise DecodingParamsError(f"Corrupt pytree payload: {e}") from e


def encode_model_payload(
    params: Any,
    contributors: list[str],
    num_samples: int,
    additional_info: dict[str, Any],
    trace_id: Optional[str] = None,
) -> bytes:
    """v1 wire envelope (the legacy dense msgpack map). ``trace_id``:
    optional hop-tracing id carried as an extra ``tid`` key (decoders
    ignore unknown keys)."""
    leaves: list = []
    p = plan_tree(params, leaves, np.ascontiguousarray)
    i = plan_tree(additional_info, leaves, np.ascontiguousarray)
    _fetch(leaves)
    env = {
        "v": WIRE_VERSION,
        "params": fill_tree(p, _v1_record),
        "contributors": list(contributors),
        "num_samples": int(num_samples),
        "info": fill_tree(i, _v1_record),
    }
    if trace_id:
        env["tid"] = str(trace_id)
    return _msgpack.packb(env)


def encode_model_payload_v3(
    params: Any,
    contributors: list[str],
    num_samples: int,
    additional_info: dict[str, Any],
    pool: Any = None,
    trace_id: Optional[str] = None,
) -> bytes:
    """v3 wire envelope: msgpack header (dtype/shape/offset table) + ONE
    contiguous payload, assembled by a single ``bytes.join`` over
    borrowed leaf views (card leaves arrive through one transfer).
    ``pool``: the :class:`~tpfl_torch.learning.bufferpool.BufferPool`
    backing the contiguation scratch for strided host leaves (default:
    the process pool; contiguous leaves never touch it)."""
    leaves: list = []
    with _Scratch(pool) as scratch:
        p = plan_tree(params, leaves, scratch.gather)
        i = plan_tree(additional_info, leaves, scratch.gather)
        _fetch(leaves)
        offsets: list[int] = []
        end = [0]

        def descriptor(leaf: _Leaf) -> dict:
            off = (end[0] + _V3_ALIGN - 1) & ~(_V3_ALIGN - 1)
            end[0] = off + leaf.nbytes
            offsets.append(off)
            return {_ND_KEY: 3, "d": leaf.name, "s": leaf.shape, "o": off, "n": leaf.nbytes}

        header_tree = {
            "params": fill_tree(p, descriptor),
            "contributors": list(contributors),
            "num_samples": int(num_samples),
            "info": fill_tree(i, descriptor),
            "psz": 0,
        }
        header_tree["psz"] = end[0]
        if trace_id:
            header_tree["tid"] = str(trace_id)
        header = _msgpack.packb(header_tree)
        parts: list = [_V3_PREFIX, struct.pack("<I", len(header)), header]
        pos = 0
        for leaf, off in zip(leaves, offsets):
            if off > pos:
                parts.append(_PAD[: off - pos])
            if leaf.nbytes:
                parts.append(leaf.bytes_view())
            pos = off + leaf.nbytes
        return b"".join(parts)


def _decode_v3_tree(obj: Any, data: Any, base: int, end: int) -> Any:
    if isinstance(obj, dict):
        if obj.get(_ND_KEY) == 3:
            off, nbytes = int(obj["o"]), int(obj["n"])
            if off < 0 or base + off + nbytes > end:
                raise DecodingParamsError(f"v3 leaf [{off}:{off + nbytes}] outside payload")
            return _leaf_view(data, _resolve_dtype(obj["d"]), tuple(obj["s"]), base + off, nbytes)
        if _TUPLE_KEY in obj and len(obj) == 1:
            return tuple(_decode_v3_tree(v, data, base, end) for v in obj[_TUPLE_KEY])
        return {k: _decode_v3_tree(v, data, base, end) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode_v3_tree(v, data, base, end) for v in obj]
    return obj


def _decode_model_payload_v3(data: bytes) -> tuple[Any, list[str], int, dict[str, Any]]:
    try:
        if len(data) < 5:
            raise DecodingParamsError("v3 payload shorter than its preamble")
        (hlen,) = struct.unpack_from("<I", data, 1)
        base = 5 + hlen
        if base > len(data):
            raise DecodingParamsError("v3 header truncated")
        env = _msgpack.unpackb(memoryview(data)[5:base])
        end = base + int(env["psz"])
        if end > len(data):
            raise DecodingParamsError(
                f"v3 payload truncated: need {end} bytes, have {len(data)}"
            )
        return (
            _decode_v3_tree(env["params"], data, base, end),
            list(env["contributors"]),
            int(env["num_samples"]),
            _decode_v3_tree(env["info"], data, base, end),
        )
    except DecodingParamsError:
        raise
    except (struct.error, ValueError, KeyError, TypeError, AttributeError) as e:
        raise DecodingParamsError(f"Corrupt v3 payload: {e}") from e


# --- by-reference payloads (co-located nodes) -----------------------------


def _freeze_leaf(x: Any) -> Any:
    """numpy leaves become read-only views (a write at the receiver
    raises); tensors pass by reference — the port never writes into a
    model's parameter tensors in place, every update builds new ones."""
    if isinstance(x, np.ndarray):
        v = x.view()
        v.flags.writeable = False
        return v
    return x


def freeze_tree(tree: Any) -> Any:
    return canonical_map(_freeze_leaf, tree)


class InprocModelRef:
    """A model payload passed BY REFERENCE between co-located nodes: the
    decoded parameter tree plus copied contributor metadata — no encode,
    no decode, no bytes. numpy leaves are frozen, metadata is copied so
    neither side can mutate the other's lists."""

    __slots__ = ("params", "contributors", "num_samples", "info", "trace")

    def __init__(
        self,
        params: Any,
        contributors: list[str],
        num_samples: int,
        info: dict[str, Any],
        trace: str = "",
    ) -> None:
        self.params = freeze_tree(params)
        self.contributors = list(contributors)
        self.num_samples = int(num_samples)
        self.info = {k: _freeze_leaf(v) for k, v in dict(info).items()}
        self.trace = str(trace)

    def __len__(self) -> int:
        return 0

    def __repr__(self) -> str:
        return (
            f"InprocModelRef(contributors={self.contributors}, "
            f"num_samples={self.num_samples})"
        )


def is_byref(payload: Any) -> bool:
    return isinstance(payload, InprocModelRef)


# --- versioned decode dispatch --------------------------------------------


def payload_wire_version(data: Any) -> int:
    """1 / 2 / 3 from the leading byte; 0 for a by-reference payload."""
    if is_byref(data):
        return 0
    lead = bytes(data[:1])
    if lead == b"\x02":
        return 2
    if lead == _V3_PREFIX:
        return WIRE_VERSION_3
    return WIRE_VERSION


def decode_model_payload(
    data: Any, bases: Any = None
) -> tuple[Any, list[str], int, dict[str, Any]]:
    """Decode any wire version (or an :class:`InprocModelRef`). v2 codec
    envelopes dispatch to :mod:`tpfl_torch.learning.compression`, with
    ``bases`` resolving residual (delta) payloads to their base model."""
    if is_byref(data):
        return (data.params, list(data.contributors), data.num_samples, dict(data.info))
    if data[:1] == b"\x02":
        from tpfl_torch.learning import compression

        return compression.decode_model_payload(data, bases=bases)
    if data[:1] == _V3_PREFIX:
        return _decode_model_payload_v3(data)
    try:
        env = _msgpack.unpackb(data)
        if env.get("v") != WIRE_VERSION:
            raise DecodingParamsError(f"Unknown wire version {env.get('v')}")
        return (
            decode_tree_v1(env["params"]),
            list(env["contributors"]),
            int(env["num_samples"]),
            decode_tree_v1(env["info"]),
        )
    except DecodingParamsError:
        raise
    except (ValueError, KeyError, TypeError, AttributeError) as e:
        raise DecodingParamsError(f"Corrupt model payload: {e}") from e


__all__ = [
    "InprocModelRef", "WIRE_VERSION", "WIRE_VERSION_3", "decode_model_payload",
    "decode_pytree", "dtype_name", "encode_model_payload", "encode_model_payload_v3",
    "encode_pytree", "freeze_tree", "host_array", "host_value", "to_host", "is_array", "is_byref", "is_float_leaf",
    "leaf_bytes", "payload_wire_version",
]
