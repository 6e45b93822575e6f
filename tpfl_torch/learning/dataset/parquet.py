"""A Parquet reader in numpy and the standard library — what
``load_dataset("parquet", ...)`` gives the reference, without pyarrow.

- **Footer:** ``PAR1``, then the Thrift compact-protocol ``FileMetaData``
  (:class:`_Thrift`): schema tree, row groups, column chunks, key-value
  metadata.
- **Pages:** dictionary pages, data pages v1 and v2, row groups and
  files concatenated in order. Codecs: UNCOMPRESSED, SNAPPY
  (:mod:`snappy`), GZIP (``zlib``); the others raise
  ``NotImplementedError``.
- **Encodings:** PLAIN, PLAIN_DICTIONARY / RLE_DICTIONARY, the RLE /
  bit-packed hybrid (levels, indices, booleans), DELTA_BINARY_PACKED,
  DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY, BYTE_STREAM_SPLIT. Bit
  unpacking, dictionary gathers and byte-array offsets run in numpy a
  page at a time.
- **Types:** every physical type (INT96 as pyarrow's ``timestamp[ns]``),
  the logical / converted types (strings, sized and unsigned ints, DATE,
  TIME, TIMESTAMP, DECIMAL, FLOAT16, JSON), and from the ``ARROW:schema``
  metadata the Arrow types whose values differ from the Parquet ones
  (durations, zone names, ``arrow.json``); other Arrow-only types the
  reference would read differently raise ``NotImplementedError``.
- **Nesting:** definition / repetition levels, optional values, LIST
  (three-level and pyarrow's legacy two-level forms), STRUCT. A MAP, or a
  fixed-size binary, has no ``datasets`` type: the reference raises
  ``ValueError`` on it, and so does this reader.

:func:`read_table` returns plain columns in the schema's order. A flat
column without a missing value is a typed array; with one, a numeric or
boolean column is a masked array (``tolist()`` gives None), a datetime
one holds NaT, and an object column None. Nested values are Python
lists and dicts in object arrays; a list column whose rows all hold the
same number of numbers is stacked into one array. Naive nanosecond
timestamps stay ``datetime64[ns]`` (the reference's ``pandas.Timestamp``).
"""

from __future__ import annotations

import base64
import datetime
import decimal
import json
import struct
import zlib
from typing import Any, Optional

import numpy as np

from tpfl_torch.learning.dataset import snappy

_CODEC_ITEM = "ROADMAP.md §1, the Parquet codecs not ported (ZSTD, BROTLI, LZ4, LZO)"
_VALUE_ITEM = "ROADMAP.md §1, values only pandas or Arrow holds"
_CODECS = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI", 5: "LZ4",
           6: "ZSTD", 7: "LZ4_RAW"}
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FLBA = range(8)
REQUIRED, OPTIONAL, REPEATED = range(3)
_PLAIN_DTYPES = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}
#: The Julian day of 1970-01-01 (INT96 timestamps).
_JULIAN_EPOCH = 2440588


class ParquetError(ValueError):
    """A file that is no valid Parquet (or a corrupt page)."""


# --- Thrift compact protocol ----------------------------------------------------


class _Thrift:
    """Reads Thrift compact-protocol structs as ``{field id: value}``."""

    def __init__(self, buf: bytes, pos: int = 0) -> None:
        self.buf, self.pos = buf, pos

    def _byte(self) -> int:
        if self.pos >= len(self.buf):
            raise ParquetError("thrift: truncated")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self._byte()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 70:
                raise ParquetError("thrift: varint too long")

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def _value(self, kind: int) -> Any:
        if kind in (1, 2):
            return kind == 1
        if kind == 3:
            return struct.unpack("b", bytes([self._byte()]))[0]
        if kind in (4, 5, 6):
            return self.zigzag()
        if kind == 7:
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if kind == 8:
            n = self.varint()
            if self.pos + n > len(self.buf):
                raise ParquetError("thrift: binary runs past the buffer")
            v = self.buf[self.pos:self.pos + n]
            self.pos += n
            return bytes(v)
        if kind in (9, 10):
            head = self._byte()
            n, elem = head >> 4, head & 0x0F
            if n == 15:
                n = self.varint()
            if elem in (1, 2):  # booleans in a list are one byte each
                return [self._byte() == 1 for _ in range(n)]
            return [self._value(elem) for _ in range(n)]
        if kind == 11:
            n = self.varint()
            if n == 0:
                return {}
            types = self._byte()
            return {self._value(types >> 4): self._value(types & 0x0F) for _ in range(n)}
        if kind == 12:
            return self.struct()
        raise ParquetError(f"thrift: unknown type {kind}")

    def struct(self) -> dict[int, Any]:
        out: dict[int, Any] = {}
        last = 0
        while True:
            head = self._byte()
            if head == 0:
                return out
            delta, kind = head >> 4, head & 0x0F
            fid = last + delta if delta else self.zigzag()
            out[fid] = self._value(kind)
            last = fid


# --- the Arrow schema (a flatbuffer) --------------------------------------------


class _Flat:
    """Just enough of flatbuffers to read an Arrow ``Schema`` message."""

    def __init__(self, buf: bytes) -> None:
        self.buf = buf

    def u32(self, p: int) -> int:
        return struct.unpack_from("<I", self.buf, p)[0]

    def field(self, table: int, i: int) -> Optional[int]:
        vt = table - struct.unpack_from("<i", self.buf, table)[0]
        size = struct.unpack_from("<H", self.buf, vt)[0]
        if 4 + 2 * i >= size:
            return None
        off = struct.unpack_from("<H", self.buf, vt + 4 + 2 * i)[0]
        return table + off if off else None

    def scalar(self, table: int, i: int, fmt: str, default: Any = 0) -> Any:
        p = self.field(table, i)
        return default if p is None else struct.unpack_from(fmt, self.buf, p)[0]

    def ref(self, table: int, i: int) -> Optional[int]:
        p = self.field(table, i)
        return None if p is None else p + self.u32(p)

    def string(self, table: int, i: int) -> Optional[str]:
        p = self.ref(table, i)
        return None if p is None else self.buf[p + 4:p + 4 + self.u32(p)].decode()

    def tables(self, table: int, i: int) -> list[int]:
        p = self.ref(table, i)
        if p is None:
            return []
        return [p + 4 + 4 * k + self.u32(p + 4 + 4 * k) for k in range(self.u32(p))]


#: Arrow's ``Type`` union members this reader names.
_ARROW_TYPES = {1: "null", 2: "int", 3: "float", 4: "binary", 5: "utf8", 6: "bool",
                7: "decimal", 8: "date", 9: "time", 10: "timestamp", 11: "interval",
                12: "list", 13: "struct", 14: "union", 15: "fixed_size_binary",
                16: "fixed_size_list", 17: "map", 18: "duration", 19: "large_binary",
                20: "large_utf8", 21: "large_list", 22: "run_end_encoded",
                23: "binary_view", 24: "utf8_view", 25: "list_view", 26: "large_list_view"}
_ARROW_UNITS = ("s", "ms", "us", "ns")


def _arrow_field(fb: _Flat, t: int) -> dict[str, Any]:
    type_id = fb.scalar(t, 2, "<B")
    kind = _ARROW_TYPES.get(type_id, f"type {type_id}")
    info: dict[str, Any] = {"name": fb.string(t, 0) or "", "type": kind}
    body = fb.ref(t, 3)
    if body is not None and kind in ("timestamp", "duration"):
        info["unit"] = _ARROW_UNITS[fb.scalar(body, 0, "<h")]
        if kind == "timestamp":
            info["tz"] = fb.string(body, 1)
    meta = {fb.string(kv, 0): fb.string(kv, 1) for kv in fb.tables(t, 6)}
    if "ARROW:extension:name" in meta:
        info["extension"] = meta["ARROW:extension:name"]
    info["children"] = [_arrow_field(fb, c) for c in fb.tables(t, 5)]
    return info


def arrow_schema(encoded: bytes) -> list[dict[str, Any]]:
    """The top-level fields of a base64 ``ARROW:schema`` value: name,
    Arrow type, unit / zone where they matter, extension name, children."""
    buf = base64.b64decode(encoded)
    if buf[:4] == b"\xff\xff\xff\xff":
        buf = buf[8:]
    fb = _Flat(buf)
    message = fb.u32(0)
    schema = fb.ref(message, 2)
    if schema is None:
        return []
    return [_arrow_field(fb, f) for f in fb.tables(schema, 1)]


# --- schema ---------------------------------------------------------------------


class Node:
    """A schema element: ``children`` for a group; ``max_def`` /
    ``max_rep`` are the levels at which this node is defined / repeats."""

    def __init__(self, el: dict[int, Any], parent: Optional["Node"]) -> None:
        self.name = el.get(4, b"").decode()
        self.type = el.get(1)
        self.type_length = el.get(2, 0)
        self.repetition = el.get(3, REQUIRED) if parent is not None else REQUIRED
        self.converted = el.get(6)
        self.scale = el.get(7, 0)
        self.precision = el.get(8, 0)
        self.logical = el.get(10) or {}
        self.num_children = el.get(5, 0)
        self.children: list[Node] = []
        self.parent = parent
        up_def = parent.max_def if parent is not None else 0
        up_rep = parent.max_rep if parent is not None else 0
        self.max_def = up_def + (self.repetition != REQUIRED and parent is not None)
        self.max_rep = up_rep + (self.repetition == REPEATED and parent is not None)
        self.path: tuple[str, ...] = () if parent is None else parent.path + (self.name,)
        self.arrow: dict[str, Any] = {}

    @property
    def is_leaf(self) -> bool:
        return self.type is not None and not self.num_children

    def leaves(self) -> list["Node"]:
        return [self] if self.is_leaf else [x for c in self.children for x in c.leaves()]

    @property
    def is_list(self) -> bool:
        return 3 in self.logical or self.converted == 3

    @property
    def is_map(self) -> bool:
        return 2 in self.logical or self.converted in (1, 2)


def _schema(elements: list[dict[int, Any]]) -> Node:
    root = Node(elements[0], None)
    stack = [(root, root.num_children)]
    for el in elements[1:]:
        if not stack:
            raise ParquetError("schema: more elements than the tree holds")
        parent, left = stack[-1]
        node = Node(el, parent)
        parent.children.append(node)
        stack[-1] = (parent, left - 1)
        if stack[-1][1] == 0:
            stack.pop()
        if node.num_children:
            stack.append((node, node.num_children))
        while stack and stack[-1][1] == 0:
            stack.pop()
    return root


# --- levels and encodings -------------------------------------------------------


def _uvarint(buf: memoryview, pos: int) -> tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise ParquetError("varint runs past the page")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7


def _unpack_bits(buf: memoryview, pos: int, count: int, width: int) -> np.ndarray:
    """``count`` little-endian ``width``-bit integers from byte ``pos``,
    all at once."""
    if width == 0:
        return np.zeros(count, np.uint64)
    nbytes = (count * width + 7) // 8
    if pos + nbytes > len(buf):
        raise ParquetError("bit-packed run past the page")
    bits = np.unpackbits(np.frombuffer(buf, np.uint8, nbytes, pos), bitorder="little")
    bits = bits[:count * width].reshape(count, width).astype(np.uint64)
    return (bits << np.arange(width, dtype=np.uint64)).sum(axis=1, dtype=np.uint64)


def _hybrid(buf: memoryview, pos: int, end: int, width: int, count: int) -> np.ndarray:
    """The RLE / bit-packed hybrid: ``count`` values of ``width`` bits
    from ``buf[pos:end]``."""
    runs, got = [], 0
    byte_width = (width + 7) // 8
    while got < count:
        if pos >= end:
            raise ParquetError("RLE / bit-packed data ends early")
        head, pos = _uvarint(buf, pos)
        if head & 1:
            n = (head >> 1) * 8
            vals = _unpack_bits(buf[:end], pos, n, width)
            pos += (n * width + 7) // 8
        else:
            n = min(head >> 1, count - got)  # a run past the page's values is corrupt
            if pos + byte_width > end:
                raise ParquetError("RLE run past the page")
            v = int.from_bytes(buf[pos:pos + byte_width], "little")
            pos += byte_width
            vals = np.full(n, v, np.uint64)
        runs.append(vals)
        got += len(vals)
    out = np.concatenate(runs)[:count] if runs else np.zeros(0, np.uint64)
    return out.astype(np.int64)


def _levels(buf: memoryview, pos: int, max_level: int, count: int,
            length: Optional[int] = None) -> tuple[np.ndarray, int]:
    """Levels of a data page: a 4-byte length then the hybrid (v1), or
    ``length`` bytes of hybrid (v2)."""
    if max_level == 0:
        return np.zeros(count, np.int64), pos
    if length is None:
        length = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
    width = int(max_level).bit_length()
    levels = _hybrid(buf, pos, pos + length, width, count)
    if levels.size and levels.max() > max_level:
        raise ParquetError("a level above the column's maximum")
    return levels, pos + length


def _delta_binary(buf: memoryview, pos: int) -> tuple[np.ndarray, int]:
    """DELTA_BINARY_PACKED: the values (int64, wrapping as the writer's
    type) and the position after them."""
    block, pos = _uvarint(buf, pos)
    mini, pos = _uvarint(buf, pos)
    total, pos = _uvarint(buf, pos)
    first, pos = _uvarint(buf, pos)
    first = (first >> 1) ^ -(first & 1)
    if total == 0:
        return np.zeros(0, np.int64), pos
    if mini == 0 or block % mini or (block // mini) % 32:
        raise ParquetError("DELTA_BINARY_PACKED: bad block sizes")
    per_mini = block // mini
    deltas, need = [], total - 1
    while need > 0:
        min_delta, pos = _uvarint(buf, pos)
        min_delta = (min_delta >> 1) ^ -(min_delta & 1)
        if pos + mini > len(buf):
            raise ParquetError("DELTA_BINARY_PACKED: bit widths past the page")
        widths = bytes(buf[pos:pos + mini])
        pos += mini
        for w in widths:
            if need <= 0:
                break
            if w > 64:
                raise ParquetError("DELTA_BINARY_PACKED: bit width above 64")
            vals = _unpack_bits(buf, pos, per_mini, w)
            pos += per_mini * w // 8
            take = min(need, per_mini)
            deltas.append(vals[:take] + np.uint64(min_delta & (2**64 - 1)))
            need -= take
    steps = np.concatenate(deltas) if deltas else np.zeros(0, np.uint64)
    out = np.empty(total, np.uint64)
    out[0] = np.uint64(first & (2**64 - 1))
    with np.errstate(over="ignore"):
        out[1:] = out[0] + np.cumsum(steps, dtype=np.uint64)
    return out.view(np.int64), pos


def _byte_arrays(blob: bytes, lengths: np.ndarray) -> np.ndarray:
    """Byte strings of ``lengths`` laid end to end in ``blob``: the
    offsets by a cumulative sum, the slices in one pass."""
    ends = np.cumsum(lengths, dtype=np.int64)
    if len(ends) and (ends[-1] > len(blob) or lengths.min() < 0):
        raise ParquetError("byte arrays run past the page")
    starts = ends - lengths
    out = np.empty(len(lengths), object)
    out[:] = [blob[s:e] for s, e in zip(starts.tolist(), ends.tolist())]
    return out


def _plain(buf: memoryview, pos: int, end: int, ptype: int, count: int,
           type_length: int) -> np.ndarray:
    if ptype == BOOLEAN:
        if pos + (count + 7) // 8 > end:
            raise ParquetError("PLAIN booleans past the page")
        bits = np.unpackbits(np.frombuffer(buf, np.uint8, (count + 7) // 8, pos),
                             bitorder="little")
        return bits[:count].astype(bool)
    if ptype in _PLAIN_DTYPES:
        width = np.dtype(_PLAIN_DTYPES[ptype]).itemsize
        if pos + count * width > end:
            raise ParquetError("PLAIN values past the page")
        return np.frombuffer(buf, _PLAIN_DTYPES[ptype], count, pos).copy()
    if ptype in (INT96, FLBA):
        width = 12 if ptype == INT96 else type_length
        if pos + count * width > end:
            raise ParquetError("PLAIN fixed-length values past the page")
        return np.frombuffer(buf, np.uint8, count * width, pos).reshape(count, width).copy()
    # BYTE_ARRAY: each value after its 4-byte length
    data = bytes(buf[pos:end])
    lengths = np.empty(count, np.int64)
    p = 0
    for i in range(count):
        if p + 4 > len(data):
            raise ParquetError("PLAIN byte array past the page")
        n = int.from_bytes(data[p:p + 4], "little")
        lengths[i] = n
        p += 4 + n
    if p > len(data):
        raise ParquetError("PLAIN byte array past the page")
    out = np.empty(count, object)
    starts = np.cumsum(lengths + 4) - lengths
    out[:] = [data[s:s + n] for s, n in zip(starts.tolist(), lengths.tolist())]
    return out


def _values(buf: memoryview, pos: int, end: int, encoding: int, leaf: Node, count: int,
            dictionary: Optional[np.ndarray]) -> np.ndarray:
    ptype = leaf.type
    if encoding in (2, 8):  # PLAIN_DICTIONARY, RLE_DICTIONARY
        if dictionary is None:
            raise ParquetError("dictionary-encoded page without a dictionary")
        if count == 0:
            return dictionary[:0]
        width = buf[pos]
        idx = _hybrid(buf, pos + 1, end, width, count)
        if idx.size and (idx.max() >= len(dictionary) or idx.min() < 0):
            raise ParquetError("dictionary index out of range")
        return dictionary[idx]
    if encoding == 0:
        return _plain(buf, pos, end, ptype, count, leaf.type_length)
    if encoding == 3 and ptype == BOOLEAN:
        length = struct.unpack_from("<I", buf, pos)[0]
        return _hybrid(buf, pos + 4, pos + 4 + length, 1, count).astype(bool)
    if encoding == 5 and ptype in (INT32, INT64):
        vals, _ = _delta_binary(buf[:end], pos)
        if len(vals) < count:
            raise ParquetError("DELTA_BINARY_PACKED: too few values")
        return vals[:count].astype(_PLAIN_DTYPES[ptype])
    if encoding == 6 and ptype == BYTE_ARRAY:
        lengths, p = _delta_binary(buf[:end], pos)
        return _byte_arrays(bytes(buf[p:end]), lengths[:count])
    if encoding == 7 and ptype in (BYTE_ARRAY, FLBA):
        prefix, p = _delta_binary(buf[:end], pos)
        lengths, p = _delta_binary(buf[:end], p)
        suffixes = _byte_arrays(bytes(buf[p:end]), lengths[:count])
        out, prev = np.empty(count, object), b""
        for i in range(count):
            if prefix[i] > len(prev):
                raise ParquetError("DELTA_BYTE_ARRAY: prefix longer than the last value")
            prev = prev[:prefix[i]] + suffixes[i]
            out[i] = prev
        if ptype == FLBA:
            return np.frombuffer(b"".join(out), np.uint8).reshape(count, leaf.type_length)
        return out
    if encoding == 9 and ptype in (FLOAT, DOUBLE, INT32, INT64, FLBA):
        width = leaf.type_length if ptype == FLBA else np.dtype(_PLAIN_DTYPES[ptype]).itemsize
        if pos + count * width > end:
            raise ParquetError("BYTE_STREAM_SPLIT past the page")
        planes = np.frombuffer(buf, np.uint8, count * width, pos).reshape(width, count)
        raw = np.ascontiguousarray(planes.T)
        return raw if ptype == FLBA else raw.reshape(-1).view(_PLAIN_DTYPES[ptype])
    raise ParquetError(f"encoding {encoding} is not valid for physical type {ptype}")


def _decompress(codec: int, data: bytes, size: int) -> bytes:
    if codec == 0:
        out = data
    elif codec == 1:
        out = snappy.decompress(data)
    elif codec == 2:
        try:
            out = zlib.decompress(data, 47)
        except zlib.error as e:
            raise ParquetError(f"GZIP page: {e}") from e
    else:
        raise NotImplementedError(f"Parquet codec {_CODECS.get(codec, codec)} is not ported "
                                  f"({_CODEC_ITEM})")
    if len(out) != size:
        raise ParquetError(f"page decompressed to {len(out)} bytes, {size} stated")
    return out


def _read_chunk(data: bytes, meta: dict[int, Any], leaf: Node
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One column chunk: its repetition levels, definition levels and
    the dense defined values."""
    codec, total = meta.get(4, 0), meta.get(5, 0)
    start = meta.get(11) or meta.get(9)
    if start is None or not 0 <= start < len(data):
        raise ParquetError("column chunk offset outside the file")
    pos, seen = start, 0
    dictionary = None
    reps, defs, vals = [], [], []
    while seen < total:
        th = _Thrift(data, pos)
        header = th.struct()
        pos = th.pos
        kind, size, csize = header.get(1), header.get(2, 0), header.get(3, 0)
        if csize < 0 or pos + csize > len(data):
            raise ParquetError("page runs past the file")
        body = data[pos:pos + csize]
        pos += csize
        if kind == 2:  # dictionary page
            dh = header.get(7, {})
            page = memoryview(_decompress(codec, body, size))
            dictionary = _plain(page, 0, len(page), leaf.type, dh.get(1, 0), leaf.type_length)
            continue
        if kind == 0:
            dh = header[5]
            n, encoding = dh[1], dh[2]
            if 4 in (dh.get(3), dh.get(4)) and (leaf.max_def or leaf.max_rep):
                raise NotImplementedError("BIT_PACKED levels (deprecated) are not ported "
                                          f"({_VALUE_ITEM})")
            page = memoryview(_decompress(codec, body, size))
            rep, p = _levels(page, 0, leaf.max_rep, n)
            dfn, p = _levels(page, p, leaf.max_def, n)
        elif kind == 3:
            dh = header[8]
            n, encoding = dh[1], dh[4]
            dlen, rlen = dh.get(5, 0), dh.get(6, 0)
            if rlen + dlen > len(body):
                raise ParquetError("v2 levels past the page")
            levels = memoryview(body)
            rep, _ = _levels(levels, 0, leaf.max_rep, n, rlen)
            dfn, _ = _levels(levels, rlen, leaf.max_def, n, dlen)
            rest = body[rlen + dlen:]
            if dh.get(7, True):
                rest = _decompress(codec, rest, size - rlen - dlen)
            page, p = memoryview(rest), 0
        else:
            continue  # index pages
        if not 0 <= n <= total - seen:
            raise ParquetError("a page holds more values than its column chunk")
        present = int((dfn == leaf.max_def).sum())
        vals.append(_values(page, p, len(page), encoding, leaf, present, dictionary))
        reps.append(rep)
        defs.append(dfn)
        seen += n
    if seen != total:
        raise ParquetError("column chunk holds more values than its metadata says")
    if not vals:
        empty = np.zeros(0, np.int64)
        return empty, empty, _plain(memoryview(b""), 0, 0, leaf.type, 0, leaf.type_length)
    return np.concatenate(reps), np.concatenate(defs), np.concatenate(vals)


# --- leaf values as the reference's ---------------------------------------------


def _tz(name: str) -> datetime.tzinfo:
    if name in ("UTC", "utc", "Z", "+00:00"):
        return datetime.timezone.utc
    if len(name) == 6 and name[0] in "+-" and name[3] == ":":
        sign = -1 if name[0] == "-" else 1
        return datetime.timezone(sign * datetime.timedelta(hours=int(name[1:3]),
                                                           minutes=int(name[4:6])))
    try:
        import zoneinfo

        return zoneinfo.ZoneInfo(name)
    except Exception as e:
        raise NotImplementedError(f"time zone {name!r}: no zone database here "
                                  f"({_VALUE_ITEM})") from e


def _decimal(unscaled: list[int], scale: int) -> np.ndarray:
    out = np.empty(len(unscaled), object)
    out[:] = [decimal.Decimal((0 if u >= 0 else 1, tuple(int(c) for c in str(abs(u))),
                               -scale)) for u in unscaled]
    return out


def _big_endian(rows: Any) -> list[int]:
    return [int.from_bytes(bytes(r), "big", signed=True) for r in rows]


def _unit_of(logical: dict[int, Any], converted: Optional[int], key: int) -> Optional[str]:
    if key in logical:
        unit = logical[key].get(2, {})
        return {1: "ms", 2: "us", 3: "ns"}[next(iter(unit))] if unit else None
    return None


def _ticks_column(raw: np.ndarray, unit: str) -> np.ndarray:
    return raw.astype(np.int64).view(f"datetime64[{unit}]")


def convert(leaf: Node, raw: np.ndarray) -> np.ndarray:
    """Dense physical values as the reference's column values."""
    lg, ct, ptype = leaf.logical, leaf.converted, leaf.type
    arrow = leaf.arrow
    where = f"column {'.'.join(leaf.path)!r}"
    ext = arrow.get("extension")
    if ext is not None and ext != "arrow.json" and not ext.startswith("datasets."):
        raise NotImplementedError(f"{where}: the Arrow extension type {ext!r} is not ported "
                                  f"({_VALUE_ITEM})")
    if arrow.get("type") in ("interval", "union", "run_end_encoded") or ct == 21:
        raise NotImplementedError(f"{where}: the Arrow type {arrow.get('type', 'interval')} "
                                  f"is not ported ({_VALUE_ITEM})")
    if 5 in lg or ct == 5:  # DECIMAL
        scale = lg.get(5, {}).get(1, leaf.scale) if 5 in lg else leaf.scale
        if ptype in (INT32, INT64):
            return _decimal(raw.astype(np.int64).tolist(), scale)
        return _decimal(_big_endian(raw), scale)
    if ptype == BOOLEAN or ptype in (FLOAT, DOUBLE):
        return raw
    if ptype == INT96:
        r = np.ascontiguousarray(raw)
        nanos = r[:, :8].copy().view("<i8").reshape(-1)
        days = r[:, 8:].copy().view("<i4").reshape(-1).astype(np.int64)
        return ((days - _JULIAN_EPOCH) * 86_400_000_000_000 + nanos).view("datetime64[ns]")
    if ptype in (INT32, INT64):
        if arrow.get("type") == "duration":
            unit = arrow["unit"]
            if unit == "ns":
                raise NotImplementedError(f"{where}: duration[ns] (the reference's "
                                          f"pandas.Timedelta) is not ported ({_VALUE_ITEM})")
            return raw.astype(np.int64).view(f"timedelta64[{unit}]")
        if 6 in lg or ct == 6:  # DATE
            return raw.astype(np.int64).view("datetime64[D]")
        if 7 in lg or ct in (7, 8):  # TIME, truncated to microseconds
            unit = _unit_of(lg, ct, 7) or ("ms" if ct == 7 else "us")
            ticks = raw.astype(np.int64)
            us = ticks * 1000 if unit == "ms" else ticks // 1000 if unit == "ns" else ticks
            out = np.empty(len(raw), object)
            out[:] = [(datetime.datetime.min + datetime.timedelta(microseconds=v)).time()
                      for v in us.tolist()]
            return out
        if 8 in lg or ct in (9, 10):  # TIMESTAMP
            unit = _unit_of(lg, ct, 8) or ("ms" if ct == 9 else "us")
            utc = lg[8].get(1, False) if 8 in lg else True
            if arrow.get("type") == "timestamp":
                tz = arrow.get("tz")
            else:
                tz = "UTC" if utc else None
            stamps = _ticks_column(raw, unit)
            if tz is None:
                return stamps
            if unit == "ns":
                raise NotImplementedError(f"{where}: nanosecond timestamps in a zone (the "
                                          "reference's pandas.Timestamp) are not ported "
                                          f"({_VALUE_ITEM})")
            zone = _tz(tz)
            epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
            us = stamps.astype("datetime64[us]").astype(np.int64).tolist()
            out = np.empty(len(raw), object)
            out[:] = [(epoch + datetime.timedelta(microseconds=v)).astimezone(zone) for v in us]
            return out
        if 11 in lg:  # UNKNOWN: the null type, no value to convert
            return raw
        if 10 in lg:
            bits, signed = lg[10].get(1, 32), lg[10].get(2, True)
            return raw.astype(f"{'i' if signed else 'u'}{bits // 8}")
        sized = {11: "u1", 12: "u2", 13: "u4", 14: "u8", 15: "i1", 16: "i2", 17: "i4",
                 18: "i8"}
        if ct in sized:
            return raw.astype(sized[ct])
        return raw
    if ptype == FLBA:
        if 15 in lg:  # FLOAT16
            return np.ascontiguousarray(raw).view("<f2").reshape(-1)
        raise ValueError(f"{where}: fixed_size_binary[{leaf.type_length}] does not have a "
                         "datasets dtype equivalent (the reference raises too)")
    # BYTE_ARRAY
    text = (1 in lg or 4 in lg or 12 in lg or ct in (0, 4, 19)
            or arrow.get("type") in ("utf8", "large_utf8", "utf8_view"))
    if text or ext == "arrow.json":
        out = np.empty(len(raw), object)
        try:
            out[:] = [bytes(v).decode("utf-8") for v in raw]
        except UnicodeDecodeError as e:
            raise ParquetError(f"{where}: invalid UTF-8") from e
        if ext == "arrow.json":
            out[:] = [json.loads(v) for v in out]
        return out
    return raw


# --- assembly -------------------------------------------------------------------


class _Leaf:
    def __init__(self, rep: np.ndarray, dfn: np.ndarray, values: list, max_def: int) -> None:
        self.rep, self.dfn, self.values = rep, dfn, values
        self.vidx = np.cumsum(dfn == max_def) - 1


def _list_child(node: Node) -> tuple[Node, bool]:
    """The repeated child of a LIST group, and whether it is the
    three-level form (the element is its one child) rather than one of
    the legacy two-level forms pyarrow reads."""
    if len(node.children) != 1 or node.children[0].repetition != REPEATED:
        raise ParquetError(f"LIST {node.name!r} without one repeated child")
    rep = node.children[0]
    three = (not rep.is_leaf and len(rep.children) == 1
             and rep.name not in ("array", node.name + "_tuple"))
    return rep, three


class _Assembler:
    """Dremel record assembly over index ranges of each leaf's entries."""

    def __init__(self, leaves: dict[int, _Leaf]) -> None:
        self.leaves = leaves

    def _def(self, sl: dict[int, tuple[int, int]]) -> int:
        k, (lo, _) = next(iter(sl.items()))
        return int(self.leaves[k].dfn[lo])

    def _sub(self, node: Node, sl: dict) -> dict:
        ids = {id(x) for x in node.leaves()}
        return {k: v for k, v in sl.items() if k in ids}

    def items(self, rep_node: Node, sl: dict) -> list[dict]:
        """The elements of one instance of a repeated node."""
        if self._def(sl) < rep_node.max_def:
            return []
        cuts = {}
        for k, (lo, hi) in sl.items():
            r = self.leaves[k].rep[lo + 1:hi]
            starts = [lo] + (np.flatnonzero(r == rep_node.max_rep) + lo + 1).tolist()
            cuts[k] = list(zip(starts, starts[1:] + [hi]))
        n = {len(v) for v in cuts.values()}
        if len(n) != 1:
            raise ParquetError(f"leaves of {rep_node.name!r} disagree on list lengths")
        return [{k: cuts[k][i] for k in cuts} for i in range(n.pop())]

    def element(self, node: Node, sl: dict) -> Any:
        """A node's value where it is known to be present."""
        if node.is_leaf:
            k, (lo, _) = next(iter(sl.items()))
            leaf = self.leaves[k]
            if leaf.dfn[lo] < node.max_def:
                return None
            return leaf.values[int(leaf.vidx[lo])]
        if node.is_map:
            raise ValueError(f"column {node.name!r}: a MAP does not have a datasets dtype "
                             "equivalent (the reference raises too)")
        if node.is_list:
            rep, three = _list_child(node)
            elems = self.items(rep, self._sub(rep, sl))
            if three:
                return [self.value(rep.children[0], e) for e in elems]
            return [self.element(rep, e) for e in elems]
        out = {}
        for c in node.children:
            csl = self._sub(c, sl)
            if c.repetition == REPEATED:
                out[c.name] = [self.element(c, e) for e in self.items(c, csl)]
            else:
                out[c.name] = self.value(c, csl)
        return out

    def value(self, node: Node, sl: dict) -> Any:
        if node.repetition == OPTIONAL and self._def(sl) < node.max_def:
            return None
        return self.element(node, sl)


def _finish_flat(leaf: Node, values: np.ndarray, dfn: np.ndarray) -> np.ndarray:
    """A flat column: the dense values spread over the rows, a missing
    value masked (numbers, booleans), NaT (datetimes) or None (objects)."""
    present = dfn == leaf.max_def
    if present.all():
        return values
    if values.dtype.kind in "Mm":
        out = np.full(len(dfn), np.datetime64("NaT") if values.dtype.kind == "M"
                      else np.timedelta64("NaT"), values.dtype)
        out[present] = values
        return out
    if values.dtype == object or values.ndim > 1:
        out = np.empty(len(dfn), object)
        out[present] = list(values)
        return out
    filled = np.zeros(len(dfn), values.dtype)
    filled[present] = values
    return np.ma.masked_array(filled, mask=~present)


def _stack(rows: list, dtype: Optional[np.dtype]) -> Optional[np.ndarray]:
    """Rows of equal-length lists of numbers (no None at any depth) as one
    array of the leaf dtype, else None."""
    if dtype is None or dtype.kind not in "biuf" or not rows:
        return None
    try:
        out = np.asarray(rows, dtype=dtype)
    except (TypeError, ValueError):
        return None
    return out if out.dtype == dtype and out.ndim > 1 else None


def _concat(parts: list[np.ndarray]) -> np.ndarray:
    """Row groups or files of one column, in order: one array where they
    share a dtype and row shape (masked where any part is), else an object
    column of their values."""
    if not parts:
        return np.zeros(0, object)
    if len({(p.dtype, p.shape[1:]) for p in parts}) == 1:
        masked = any(isinstance(p, np.ma.MaskedArray) for p in parts)
        return np.ma.concatenate(parts) if masked else np.concatenate(parts)
    col = np.empty(sum(len(p) for p in parts), object)
    col[:] = [v for p in parts for v in (list(p) if p.dtype == object else p.tolist())]
    return col


def _column(node: Node, chunks: list[dict[int, tuple]]) -> np.ndarray:
    """One top-level column from its leaves' chunks, in row-group order."""
    leaves = node.leaves()
    parts, leaf_dtype = [], None
    for chunk in chunks:
        got = {id(leaf): chunk[id(leaf)] for leaf in leaves}
        if node.is_leaf and node.repetition != REPEATED:
            rep, dfn, vals = got[id(node)]
            parts.append(_finish_flat(node, convert(node, vals), dfn))
            continue
        state = {}
        for leaf in leaves:
            rep, dfn, vals = got[id(leaf)]
            values = convert(leaf, vals)
            leaf_dtype = values.dtype
            state[id(leaf)] = _Leaf(rep, dfn, values.tolist(), leaf.max_def)
        asm = _Assembler(state)
        bounds = {k: np.append(np.flatnonzero(s.rep == 0), len(s.rep))
                  for k, s in state.items()}
        n = {len(b) - 1 for b in bounds.values()}
        if len(n) != 1:
            raise ParquetError(f"leaves of {node.name!r} disagree on the row count")
        rows = []
        for i in range(n.pop()):
            sl = {k: (int(b[i]), int(b[i + 1])) for k, b in bounds.items()}
            if node.repetition == REPEATED:
                rows.append([asm.element(node, e) for e in asm.items(node, sl)])
            else:
                rows.append(asm.value(node, sl))
        out = np.empty(len(rows), object)
        out[:] = rows
        parts.append(out)
    col = _concat(parts)
    if col.dtype == object and len(leaves) == 1 and (node.is_list
                                                     or node.repetition == REPEATED):
        stacked = _stack(col.tolist(), leaf_dtype)
        if stacked is not None:
            return stacked
    return col


# --- files ----------------------------------------------------------------------


def read_metadata(data: bytes) -> tuple[Node, dict[int, Any], dict[str, str]]:
    """The schema tree, the raw ``FileMetaData`` and its key-value
    metadata of a whole Parquet file's bytes."""
    if len(data) < 12 or data[:4] != b"PAR1" or data[-4:] != b"PAR1":
        raise ParquetError("not a Parquet file (no PAR1 magic)")
    n = struct.unpack_from("<I", data, len(data) - 8)[0]
    if n + 12 > len(data):
        raise ParquetError("footer length past the file")
    try:
        meta = _Thrift(data, len(data) - 8 - n).struct()
    except (IndexError, struct.error) as e:
        raise ParquetError(f"corrupt footer: {e}") from e
    if 2 not in meta or not meta[2]:
        raise ParquetError("footer without a schema")
    root = _schema(meta[2])
    kv = {}
    for item in meta.get(5, []):
        key = item.get(1, b"").decode()
        kv[key] = item.get(2, b"").decode() if item.get(2) is not None else None
    if kv.get("ARROW:schema"):
        fields = {f["name"]: f for f in arrow_schema(kv["ARROW:schema"].encode())}

        def attach(node: Node, info: Optional[dict]) -> None:
            node.arrow = info or {}
            kids = {c["name"]: c for c in (info or {}).get("children", [])}
            for c in node.children:
                sub = kids.get(c.name)
                if sub is None and len(kids) == 1:
                    sub = next(iter(kids.values()))  # a list's element
                attach(c, sub)

        for c in root.children:
            attach(c, fields.get(c.name))
    return root, meta, kv


def read_table(paths: list[str]) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """Columns of one or more Parquet files (same schema), rows in file
    order, and the first file's key-value metadata."""
    columns: dict[str, list] = {}
    first_kv: dict[str, str] = {}
    names: Optional[list[str]] = None
    for p in paths:
        with open(p, "rb") as f:
            data = f.read()
        root, meta, kv = read_metadata(data)
        top = [c.name for c in root.children]
        if names is None:
            names, first_kv = top, kv
            columns = {n: [] for n in names}
        elif top != names:
            raise ValueError(f"{p}: columns {top} differ from the first file's {names}")
        leaves = root.leaves()
        chunks = []
        for rg in meta.get(4, []):
            cols = rg.get(1, [])
            if len(cols) != len(leaves):
                raise ParquetError("row group column count differs from the schema")
            got = {}
            for leaf, cc in zip(leaves, cols):
                if cc.get(1):
                    raise NotImplementedError("column chunks in other files are not "
                                              f"ported ({_VALUE_ITEM})")
                try:
                    got[id(leaf)] = _read_chunk(data, cc[3], leaf)
                except (IndexError, KeyError, struct.error) as e:
                    raise ParquetError(f"corrupt column chunk {'.'.join(leaf.path)}: "
                                       f"{e!r}") from e
            chunks.append(got)
        for node in root.children:
            columns[node.name].append(_column(node, chunks))
    return {name: _concat(parts) for name, parts in columns.items()}, first_kv


__all__ = ["Node", "ParquetError", "arrow_schema", "convert", "read_metadata", "read_table"]
