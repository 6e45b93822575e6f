"""The subset of MessagePack that the wire envelopes use, in pure Python.

The reference packs its envelopes with the ``msgpack`` package
(``msgpack.packb(obj, use_bin_type=True)`` /
``msgpack.unpackb(data, raw=False, strict_map_key=False)``); the port
imports torch and numpy only, so it writes the format itself. For the
types below :func:`packb` gives the same bytes as that call and
:func:`unpackb` the same objects:

- nil, bool;
- integers in the smallest form: positive fixint, uint8/16/32/64,
  negative fixint, int8/16/32/64;
- Python floats as float64 (float32 is decoded too);
- ``str`` as fixstr / str8 / str16 / str32 (UTF-8);
- ``bytes`` / ``bytearray`` / ``memoryview`` as bin8 / bin16 / bin32
  (decoded as ``bytes``);
- lists and tuples as arrays, dicts as maps, in fix / 16 / 32 forms,
  maps in insertion order.

Anything else raises ``TypeError`` on pack; malformed, truncated or
trailing input raises ``ValueError`` on unpack (extension types are
not part of the envelopes' subset).

:func:`packb_ext` / :func:`unpackb_ext` are ``flax.serialization``'s
``msgpack_serialize`` / ``msgpack_restore`` for host trees, the engine
checkpoint's byte format (``management/checkpoint.py``): two extension
types, an array (ext 1) and a numpy scalar (ext 3), each carried as
``packb((shape, dtype name, C-order bytes))``; dicts packed with sorted
keys (flax maps the tree through ``jax.tree_util`` first); exact types
only (flax packs with ``strict_types=True``, so a tuple, a subclass of
``float`` such as ``np.float64`` and any other type are not the plain
type: tuples raise, numpy scalars take ext 3). A CPU torch tensor packs
as an array of its dtype's name, so bf16 leaves, which numpy cannot
hold, round-trip as ``torch.bfloat16`` tensors. Leaves above
``MAX_LEAF_BYTES`` raise: flax splits them into chunk dicts, which the
port neither writes nor reads.
"""

from __future__ import annotations

import struct
from typing import Any, Optional

import numpy as np
import torch

_F64 = struct.Struct(">d")
_F32 = struct.Struct(">f")


def _pack_len(out: bytearray, n: int, fix_base: int, fix_max: int, codes: tuple) -> None:
    """Header of a str / bin / array / map of length ``n``: the fix form
    when there is one and ``n`` fits, else the smallest of the 8 / 16 /
    32-bit forms in ``codes`` (``None`` where the family has none)."""
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
    elif codes[0] is not None and n <= 0xFF:
        out += bytes((codes[0], n))
    elif n <= 0xFFFF:
        out.append(codes[1])
        out += n.to_bytes(2, "big")
    elif n <= 0xFFFFFFFF:
        out.append(codes[2])
        out += n.to_bytes(4, "big")
    else:
        raise ValueError(f"msgpack: length {n} exceeds 2**32 - 1")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v > 0:
        for code, size in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
            if v < 1 << (8 * size):
                out.append(code)
                out += v.to_bytes(size, "big")
                return
        raise OverflowError(f"msgpack: integer {v} out of range")
    else:
        for code, size in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
            if v >= -(1 << (8 * size - 1)):
                out.append(code)
                out += v.to_bytes(size, "big", signed=True)
                return
        raise OverflowError(f"msgpack: integer {v} out of range")


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(out, int(obj))
    elif isinstance(obj, float):
        out.append(0xCB)
        out += _F64.pack(obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        view = memoryview(obj).cast("B") if isinstance(obj, memoryview) else obj
        _pack_len(out, len(view), None, -1, (0xC4, 0xC5, 0xC6))
        out += view
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the subset."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    __slots__ = ("data", "pos", "ext")

    def __init__(self, data: Any, ext: Optional[Any] = None) -> None:
        self.data = memoryview(data).cast("B") if not isinstance(data, bytes) else data
        self.pos = 0
        # ext(code, data) -> object decodes extension types; None refuses them.
        self.ext = ext

    def take(self, n: int) -> Any:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("msgpack: incomplete input")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def read(self) -> Any:
        code = self.uint(1)
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self.map(code & 0x0F)
        if 0x90 <= code <= 0x9F:
            return self.array(code & 0x0F)
        if 0xA0 <= code <= 0xBF:
            return self.str(code & 0x1F)
        if code == 0xC0:
            return None
        if code == 0xC2:
            return False
        if code == 0xC3:
            return True
        if 0xC4 <= code <= 0xC6:
            return bytes(self.take(self.uint(1 << (code - 0xC4))))
        if code == 0xCA:
            return _F32.unpack(self.take(4))[0]
        if code == 0xCB:
            return _F64.unpack(self.take(8))[0]
        if 0xCC <= code <= 0xCF:
            return self.uint(1 << (code - 0xCC))
        if 0xD0 <= code <= 0xD3:
            return int.from_bytes(self.take(1 << (code - 0xD0)), "big", signed=True)
        if 0xD9 <= code <= 0xDB:
            return self.str(self.uint(1 << (code - 0xD9)))
        if code in (0xDC, 0xDD):
            return self.array(self.uint(2 if code == 0xDC else 4))
        if code in (0xDE, 0xDF):
            return self.map(self.uint(2 if code == 0xDE else 4))
        if self.ext is not None and (0xD4 <= code <= 0xD8 or 0xC7 <= code <= 0xC9):
            n = 1 << (code - 0xD4) if code >= 0xD4 else self.uint(1 << (code - 0xC7))
            kind = int.from_bytes(self.take(1), "big", signed=True)
            return self.ext(kind, self.take(n))
        raise ValueError(f"msgpack: unsupported type code 0x{code:02x}")

    def str(self, n: int) -> str:
        try:
            return bytes(self.take(n)).decode("utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"msgpack: invalid UTF-8 in str: {e}") from e

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            if self.ext is not None and not isinstance(k, (str, bytes)):
                # msgpack.unpackb's strict_map_key, on in flax's restore.
                raise ValueError(f"msgpack: {type(k).__name__} map key {k!r} is not allowed")
            try:
                out[k] = self.read()
            except TypeError as e:  # unhashable key
                raise ValueError(f"msgpack: unhashable map key {k!r}") from e
        return out


def unpackb(data: Any) -> Any:
    """``msgpack.unpackb(data, raw=False, strict_map_key=False)`` for the
    subset; ``ValueError`` on malformed, truncated or trailing bytes."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes of extra data")
    return obj


# --- flax.serialization's extension types --------------------------------

#: flax's ``_MsgpackExtType``: ``ndarray`` and ``npscalar``.
EXT_NDARRAY = 1
EXT_NPSCALAR = 3

#: flax's ``MAX_CHUNK_SIZE``: a larger leaf is split into chunk dicts.
MAX_LEAF_BYTES = 2**30

#: numpy's dtype names of the torch dtypes a leaf may have; bfloat16 is
#: the name flax's ``_dtype_from_name`` maps to JAX's bfloat16.
_TORCH_NAMES = {
    "torch.float64": "float64", "torch.float32": "float32", "torch.float16": "float16",
    "torch.bfloat16": "bfloat16", "torch.int64": "int64", "torch.int32": "int32",
    "torch.int16": "int16", "torch.int8": "int8", "torch.uint8": "uint8", "torch.bool": "bool",
}


def _array_record(shape: tuple, name: str, buf: Any, nbytes: int) -> bytearray:
    """flax's ``_ndarray_to_bytes``: ``packb((shape, dtype name, bytes))``
    of the C-order bytes in ``buf``."""
    if nbytes > MAX_LEAF_BYTES:
        raise ValueError(
            f"msgpack: a {name} leaf of shape {tuple(shape)} holds {nbytes} bytes, above "
            f"{MAX_LEAF_BYTES}; flax would split it into chunks, which this format does not "
            "carry")
    out = bytearray()
    _pack(out, [list(shape), name, buf])
    return out


def _raw(arr: np.ndarray) -> memoryview:
    """The C-order bytes of an array, without a copy when it is contiguous."""
    return memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _ext(out: bytearray, kind: int, data: bytearray) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
    if fixed is not None:
        out.append(fixed)
    elif n <= 0xFF:
        out += bytes((0xC7, n))
    elif n <= 0xFFFF:
        out.append(0xC8)
        out += n.to_bytes(2, "big")
    else:
        out.append(0xC9)
        out += n.to_bytes(4, "big")
    out.append(kind)
    out += data


def _pack_ext(out: bytearray, obj: Any) -> None:
    kind = type(obj)
    if obj is None or kind in (bool, int, float, str, bytes):
        _pack(out, obj)
    elif kind is list:
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack_ext(out, v)
    elif kind is dict:
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k in sorted(obj):
            _pack_ext(out, k)
            _pack_ext(out, obj[k])
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject or obj.dtype.isalignedstruct:
            raise ValueError("msgpack: object and structured dtypes are not serializable")
        _ext(out, EXT_NDARRAY, _array_record(obj.shape, obj.dtype.name, _raw(obj), obj.nbytes))
    elif isinstance(obj, np.generic):
        arr = np.asarray(obj)
        _ext(out, EXT_NPSCALAR, _array_record((), arr.dtype.name, _raw(arr), arr.nbytes))
    elif isinstance(obj, torch.Tensor):
        name = _TORCH_NAMES.get(str(obj.dtype))
        if name is None or obj.device.type != "cpu":
            raise TypeError(f"can not serialize a {obj.dtype} tensor on {obj.device}")
        t = obj.detach().contiguous().reshape(-1)
        raw = _raw(t.view(torch.uint8).numpy()) if t.numel() else b""
        _ext(out, EXT_NDARRAY, _array_record(tuple(obj.shape), name, raw, len(raw)))
    else:
        raise TypeError(f"can not serialize {kind.__name__!r} object")


def packb_ext(obj: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(obj)`` for a host tree
    (dicts, lists, scalars, numpy arrays and scalars, CPU tensors)."""
    out = bytearray()
    _pack_ext(out, obj)
    return bytes(out)


def _array_from_record(data: Any) -> Any:
    """flax's ``_ndarray_from_bytes``: a writable numpy array, or a
    ``torch.bfloat16`` tensor over the same bytes for bfloat16."""
    rec = _Reader(data).read()
    if not (isinstance(rec, list) and len(rec) == 3):
        raise ValueError("msgpack: malformed array record")
    shape, name, buf = rec
    name = name.decode() if isinstance(name, bytes) else name
    raw = bytearray(buf)
    if name == "bfloat16":
        flat = (torch.frombuffer(raw, dtype=torch.bfloat16) if raw
                else torch.empty((0,), dtype=torch.bfloat16))
        return flat.reshape(tuple(shape))
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(tuple(shape))


def _ext_hook(kind: int, data: Any) -> Any:
    if kind == EXT_NDARRAY:
        return _array_from_record(data)
    if kind == EXT_NPSCALAR:
        arr = _array_from_record(data)
        return arr if not isinstance(arr, np.ndarray) else arr[()]
    raise ValueError(f"msgpack: unsupported extension type {kind}")


def unpackb_ext(data: Any) -> Any:
    """``flax.serialization.msgpack_restore(data)`` (no chunked leaves):
    arrays come back as numpy arrays (``torch.bfloat16`` tensors for
    bfloat16), numpy scalars as numpy scalars, tuples as lists."""
    r = _Reader(data, ext=_ext_hook)
    obj = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes of extra data")
    return obj


__all__ = ["MAX_LEAF_BYTES", "packb", "packb_ext", "unpackb", "unpackb_ext"]
