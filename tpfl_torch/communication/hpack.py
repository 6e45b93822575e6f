"""HPACK, the header compression of HTTP/2 (RFC 7541), in the standard
library: the wire under :mod:`tpfl_torch.communication.grpc_transport`.

- Integers with an N-bit prefix (section 5.1) and string literals, raw or
  Huffman-coded (section 5.2).
- The static table (Appendix A, 61 entries) and the dynamic table
  (section 4): an entry's size is its name's and value's octets plus 32,
  the oldest entries are evicted to make room, and a dynamic table size
  update (section 6.3) may not exceed the limit the decoder's owner
  advertised (``SETTINGS_HEADER_TABLE_SIZE``).
- The Huffman code of Appendix B, stored as its 257 code lengths: the
  code is canonical (codes of one length are consecutive and follow
  symbol order), so the codes are rebuilt from the lengths, and the
  module checks at import that they fill the code space exactly (Kraft
  sum 1) and that EOS is the all-ones 30-bit code.

The :class:`Decoder` takes every representation of section 6: indexed,
literal with incremental indexing, without indexing and never indexed,
and the size update. The :class:`Encoder` keeps no dynamic table: it
emits a size update to 0 at the start of the first block (and again
after the peer changes its table size), then every field as a literal
without indexing, the name indexed where the static table holds it.
That is legal for any peer and keeps the encoder stateless.
"""

from __future__ import annotations

from typing import Iterable, Optional


class HPACKError(ValueError):
    """A header block that RFC 7541 does not allow (a COMPRESSION_ERROR
    in HTTP/2)."""


# --- Appendix A: the static table ---------------------------------------------

STATIC_TABLE: tuple[tuple[bytes, bytes], ...] = tuple(
    (n.encode(), v.encode()) for n, v in (
        (":authority", ""), (":method", "GET"), (":method", "POST"), (":path", "/"),
        (":path", "/index.html"), (":scheme", "http"), (":scheme", "https"),
        (":status", "200"), (":status", "204"), (":status", "206"), (":status", "304"),
        (":status", "400"), (":status", "404"), (":status", "500"), ("accept-charset", ""),
        ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
        ("accept-ranges", ""), ("accept", ""), ("access-control-allow-origin", ""),
        ("age", ""), ("allow", ""), ("authorization", ""), ("cache-control", ""),
        ("content-disposition", ""), ("content-encoding", ""), ("content-language", ""),
        ("content-length", ""), ("content-location", ""), ("content-range", ""),
        ("content-type", ""), ("cookie", ""), ("date", ""), ("etag", ""), ("expect", ""),
        ("expires", ""), ("from", ""), ("host", ""), ("if-match", ""),
        ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
        ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""),
        ("location", ""), ("max-forwards", ""), ("proxy-authenticate", ""),
        ("proxy-authorization", ""), ("range", ""), ("referer", ""), ("refresh", ""),
        ("retry-after", ""), ("server", ""), ("set-cookie", ""),
        ("strict-transport-security", ""), ("transfer-encoding", ""), ("user-agent", ""),
        ("vary", ""), ("via", ""), ("www-authenticate", "")))
assert len(STATIC_TABLE) == 61
# A name's first index in the static table.
_STATIC_NAME: dict[bytes, int] = {
    n: i for i, (n, _) in reversed(list(enumerate(STATIC_TABLE, 1)))}

# --- Appendix B: the Huffman code, as code lengths ------------------------------


def _huffman_lengths() -> list[int]:
    lengths = [28] * 257
    spans = {
        5: "012aceiost",
        6: " %-./3456789=A_bdfghlmnpru",
        7: ":BCDEFGHIJKLMNOPQRSTUVWYjkqvwxyz",
        8: "&*,;XZ", 10: "!\"()?", 11: "'+|", 12: "#>", 13: "$@[]~", 14: "^}",
        15: "<`{", 19: "\\",
    }
    for n, chars in spans.items():
        for c in chars:
            lengths[ord(c)] = n
    by_symbol = {
        13: [0], 19: [195, 208], 23: [1, 135, 137, 138, 139, 140, 141, 143, 147, 149, 150,
                                      151, 152, 155, 157, 158, 165, 166, 168, 174, 175,
                                      180, 182, 183, 188, 191, 197, 231, 239],
        24: [9, 142, 144, 145, 148, 159, 171, 206, 215, 225, 236, 237],
        30: [10, 13, 22, 256],
        20: [128, 130, 131, 162, 184, 194, 224, 226],
        21: [153, 161, 167, 172, 176, 177, 179, 209, 216, 217, 227, 229, 230],
        22: [129, 132, 133, 134, 136, 146, 154, 156, 160, 163, 164, 169, 170, 173, 178,
             181, 185, 186, 187, 189, 190, 196, 198, 228, 232, 233],
        25: [199, 207, 234, 235],
        26: [192, 193, 200, 201, 202, 205, 210, 213, 218, 219, 238, 240, 242, 243, 255],
        27: [203, 204, 211, 212, 214, 221, 222, 223, 241, 244, 245, 246, 247, 248, 250,
             251, 252, 253, 254],
    }
    for n, symbols in by_symbol.items():
        for s in symbols:
            lengths[s] = n
    return lengths


HUFFMAN_LENGTHS: tuple[int, ...] = tuple(_huffman_lengths())
EOS = 256


def canonical_codes(lengths: Iterable[int]) -> list[int]:
    """The canonical prefix code of ``lengths``: codes assigned in order of
    (length, symbol), each one more than the last, shifted left as the
    length grows."""
    lengths = list(lengths)
    codes = [0] * len(lengths)
    code, prev = 0, 0
    for sym in sorted(range(len(lengths)), key=lambda s: (lengths[s], s)):
        code <<= lengths[sym] - prev
        prev = lengths[sym]
        codes[sym] = code
        code += 1
    return codes


HUFFMAN_CODES: tuple[int, ...] = tuple(canonical_codes(HUFFMAN_LENGTHS))
# The code is complete (Kraft sum exactly 1) and EOS is 30 ones.
assert sum(1 << (30 - n) for n in HUFFMAN_LENGTHS) == 1 << 30
assert HUFFMAN_LENGTHS[EOS] == 30 and HUFFMAN_CODES[EOS] == (1 << 30) - 1

# (length, code) -> symbol: the decoder walks a string bit by bit and looks
# up the bits read so far at their length.
_DECODE: dict[tuple[int, int], int] = {
    (n, c): s for s, (n, c) in enumerate(zip(HUFFMAN_LENGTHS, HUFFMAN_CODES))}
_MIN_LEN = min(HUFFMAN_LENGTHS)


def huffman_encode(data: bytes) -> bytes:
    """``data`` Huffman-coded, padded to a whole octet with the most
    significant bits of EOS (ones)."""
    acc, nbits = 0, 0
    for b in data:
        acc = (acc << HUFFMAN_LENGTHS[b]) | HUFFMAN_CODES[b]
        nbits += HUFFMAN_LENGTHS[b]
    pad = -nbits % 8
    acc = (acc << pad) | ((1 << pad) - 1)
    return acc.to_bytes((nbits + pad) // 8, "big")


def huffman_decode(data: bytes) -> bytes:
    """Decode a Huffman-coded string. Raises :class:`HPACKError` on an EOS
    symbol inside the string, on padding longer than 7 bits and on
    padding that is not the most significant bits of EOS (all ones)."""
    out = bytearray()
    code, n = 0, 0
    for byte in data:
        for shift in range(7, -1, -1):
            code = (code << 1) | ((byte >> shift) & 1)
            n += 1
            if n < _MIN_LEN:
                continue
            sym = _DECODE.get((n, code))
            if sym is None:
                if n >= 30:
                    raise HPACKError("invalid Huffman code")
                continue
            if sym == EOS:
                raise HPACKError("EOS symbol inside a Huffman-coded string")
            out.append(sym)
            code, n = 0, 0
    if n > 7:
        raise HPACKError(f"Huffman padding of {n} bits (at most 7 allowed)")
    if code != (1 << n) - 1:
        raise HPACKError("Huffman padding is not the most significant bits of EOS")
    return bytes(out)


# --- primitives -----------------------------------------------------------------


def encode_integer(value: int, prefix_bits: int, first: int = 0) -> bytes:
    """``value`` with an N-bit prefix (section 5.1); ``first`` holds the
    bits above the prefix in the first octet."""
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes([first | value])
    out = bytearray([first | limit])
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_integer(data: bytes, pos: int, prefix_bits: int) -> tuple[int, int]:
    """(value, position after it) of the integer at ``data[pos]``."""
    if pos >= len(data):
        raise HPACKError("truncated integer")
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HPACKError("truncated integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos
        if shift > 62:
            raise HPACKError("integer overflow")


def encode_string(value: bytes, huffman: bool = False) -> bytes:
    if huffman:
        value = huffman_encode(value)
    return encode_integer(len(value), 7, 0x80 if huffman else 0) + value


def decode_string(data: bytes, pos: int) -> tuple[bytes, int]:
    if pos >= len(data):
        raise HPACKError("truncated string")
    huffman = bool(data[pos] & 0x80)
    n, pos = decode_integer(data, pos, 7)
    if pos + n > len(data):
        raise HPACKError("truncated string")
    raw = bytes(data[pos:pos + n])
    return (huffman_decode(raw) if huffman else raw), pos + n


# --- tables -----------------------------------------------------------------------


def entry_size(name: bytes, value: bytes) -> int:
    return len(name) + len(value) + 32


class _DynamicTable:
    def __init__(self, max_size: int) -> None:
        self.entries: list[tuple[bytes, bytes]] = []  # newest first
        self.size = 0
        self.max_size = max_size

    def add(self, name: bytes, value: bytes) -> None:
        need = entry_size(name, value)
        while self.entries and self.size + need > self.max_size:
            self._evict()
        if need <= self.max_size:  # an entry larger than the table empties it
            self.entries.insert(0, (name, value))
            self.size += need

    def resize(self, max_size: int) -> None:
        self.max_size = max_size
        while self.size > max_size:
            self._evict()

    def _evict(self) -> None:
        name, value = self.entries.pop()
        self.size -= entry_size(name, value)


class Decoder:
    """Decodes header blocks in the order they were sent on one
    connection. ``max_table_size`` is the ``SETTINGS_HEADER_TABLE_SIZE``
    this side advertised: the encoder's size updates may not exceed it."""

    def __init__(self, max_table_size: int = 4096) -> None:
        self.max_table_size = max_table_size
        self.table = _DynamicTable(max_table_size)

    def _lookup(self, index: int) -> tuple[bytes, bytes]:
        if index == 0:
            raise HPACKError("index 0")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        k = index - len(STATIC_TABLE) - 1
        if k >= len(self.table.entries):
            raise HPACKError(f"index {index} beyond the tables")
        return self.table.entries[k]

    def decode(self, block: bytes) -> list[tuple[bytes, bytes]]:
        """The (name, value) fields of one complete header block."""
        fields: list[tuple[bytes, bytes]] = []
        pos, n = 0, len(block)
        while pos < n:
            b = block[pos]
            if b & 0x80:  # 6.1 indexed
                index, pos = decode_integer(block, pos, 7)
                fields.append(self._lookup(index))
            elif b & 0xE0 == 0x20:  # 6.3 dynamic table size update
                if fields:
                    raise HPACKError("table size update after a header field")
                size, pos = decode_integer(block, pos, 5)
                if size > self.max_table_size:
                    raise HPACKError(f"table size update to {size} above the "
                                     f"limit {self.max_table_size}")
                self.table.resize(size)
            else:  # 6.2 literals: incremental (01), without (0000), never (0001)
                incremental = bool(b & 0x40)
                index, pos = decode_integer(block, pos, 6 if incremental else 4)
                if index:
                    name = self._lookup(index)[0]
                else:
                    name, pos = decode_string(block, pos)
                value, pos = decode_string(block, pos)
                if incremental:
                    self.table.add(name, value)
                fields.append((name, value))
        return fields


class Encoder:
    """Stateless encoder: literals without indexing, raw strings.
    :meth:`table_size_changed` records a new ``SETTINGS_HEADER_TABLE_SIZE``
    of the peer; the next block then starts with a size update to 0."""

    def __init__(self) -> None:
        self._update_pending = True

    def table_size_changed(self) -> None:
        self._update_pending = True

    def encode(self, fields: Iterable[tuple[bytes, bytes]]) -> bytes:
        out = bytearray()
        if self._update_pending:
            out += encode_integer(0, 5, 0x20)
            self._update_pending = False
        for name, value in fields:
            index: Optional[int] = _STATIC_NAME.get(name)
            if index is not None:
                out += encode_integer(index, 4, 0x00)
            else:
                out += b"\x00" + encode_string(name)
            out += encode_string(value)
        return bytes(out)
