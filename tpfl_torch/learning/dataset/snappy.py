"""Raw Snappy decompression — the default codec of pyarrow's Parquet
writer, so the Hugging Face Hub's shards use it. The standard library
has no Snappy; this reads the format's one stream kind (the raw format,
no framing): a varint of the output length, then literals and copies
with 1-, 2- and 4-byte offsets. Every bound is checked: a corrupt stream
raises ``ValueError``, never gives a wrong result."""

from __future__ import annotations


def _varint(data: bytes, pos: int) -> tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(data) or shift > 28:
            raise ValueError("snappy: truncated or oversized length varint")
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7


def decompress(data: bytes) -> bytes:
    """The bytes a raw Snappy stream holds."""
    n, pos = _varint(data, 0)
    out = bytearray()
    end = len(data)
    while pos < end:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = tag >> 2
            if length >= 60:
                width = length - 59
                if pos + width > end:
                    raise ValueError("snappy: truncated literal length")
                length = int.from_bytes(data[pos:pos + width], "little")
                pos += width
            length += 1
            if pos + length > end:
                raise ValueError("snappy: literal runs past the stream")
            out += data[pos:pos + length]
            pos += length
            continue
        if kind == 1:
            if pos >= end:
                raise ValueError("snappy: truncated copy")
            length = 4 + ((tag >> 2) & 7)
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        else:
            width = 2 if kind == 2 else 4
            if pos + width > end:
                raise ValueError("snappy: truncated copy")
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + width], "little")
            pos += width
        if offset == 0 or offset > len(out):
            raise ValueError("snappy: copy offset outside the output")
        start = len(out) - offset
        if offset >= length:
            out += out[start:start + length]
        else:  # an overlapping copy repeats the last `offset` bytes
            chunk = bytes(out[start:])
            out += (chunk * (length // offset + 1))[:length]
        if len(out) > n:
            raise ValueError("snappy: output longer than its stated length")
    if len(out) != n:
        raise ValueError(f"snappy: {len(out)} bytes decoded, {n} stated")
    return bytes(out)


__all__ = ["decompress"]
