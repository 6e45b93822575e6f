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
not part of the subset).
"""

from __future__ import annotations

import struct
from typing import Any

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
    __slots__ = ("data", "pos")

    def __init__(self, data: Any) -> None:
        self.data = memoryview(data).cast("B") if not isinstance(data, bytes) else data
        self.pos = 0

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


__all__ = ["packb", "unpackb"]
