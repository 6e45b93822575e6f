"""PNG decoding equal to ``np.asarray(PIL.Image.open(f))`` — what the
reference's ``Image()`` feature gives its export — with numpy and
``zlib`` only.

- **Format:** the chunks with their CRCs, IHDR, PLTE, tRNS and IDAT
  through ``zlib``, the five filters, Adam7 interlacing.
- **Every colour type and bit depth PIL opens**, as the arrays PIL's
  modes give: grey at 1 bit (mode ``1``: bool), 2 and 4 bits (``L``,
  scaled by 85 / 17), 8 (``L``) and 16 (``I;16``: uint16); RGB at 8 and
  16 bits (PIL keeps the high byte); palette at 1-8 bits (mode ``P``: the
  indices); grey + alpha at 8 bits (``LA``) and 16 (``RGBA`` from the high
  bytes, grey in R, G and B); RGBA at 8 and 16 bits.
- **Batched unfiltering:** :func:`decode_many` decodes the images of one
  shape together. Sub is a cumulative sum and Up an addition over a whole
  row of the batch; Average and Paeth take one numpy step per pixel
  column for the whole batch.
- **Refusals:** JPEG and every other format raise ``NotImplementedError``
  naming it; a corrupt PNG (bad signature, CRC, length or filter) raises
  ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_IMAGE_ITEM = "ROADMAP.md §1, image formats other than PNG"

#: Samples per pixel of each colour type.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
#: Adam7: (x0, y0, dx, dy) of the seven passes.
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))
_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"BM", "BMP"),
          (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"\x00\x00\x01\x00", "ICO"))


class Header(NamedTuple):
    width: int
    height: int
    depth: int
    colour: int
    interlace: int
    idat: bytes


def _format_name(data: bytes) -> str:
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WEBP"
    for magic, name in _MAGIC:
        if data.startswith(magic):
            return name
    return "an unknown image format"


def read_header(data: bytes) -> Header:
    """The IHDR fields and the joined IDAT data, every chunk's CRC checked."""
    if not data.startswith(SIGNATURE):
        raise NotImplementedError(f"image decoding: {_format_name(data)} is not ported, only "
                                  f"PNG ({_IMAGE_ITEM})")
    pos, ihdr, idat = 8, None, []
    palette_len: Optional[int] = None
    while True:
        if pos + 8 > len(data):
            raise ValueError("PNG: truncated before IEND")
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        if length > 2**31 - 1 or len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"PNG: chunk {kind!r} runs past the file")
        crc = struct.unpack_from(">I", data, pos + 8 + length)[0]
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG: bad CRC in chunk {kind!r}")
        pos += 12 + length
        if ihdr is None and kind != b"IHDR":
            raise ValueError("PNG: the first chunk is not IHDR")
        if kind == b"IHDR":
            if length != 13 or ihdr is not None:
                raise ValueError("PNG: bad IHDR")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if length % 3 or not 0 < length <= 768:
                raise ValueError("PNG: bad PLTE length")
            palette_len = length // 3
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind == b"tRNS":
            colour = ihdr[3]
            if (colour == 0 and length != 2) or (colour == 2 and length != 6) or \
                    colour in (4, 6):
                raise ValueError("PNG: bad tRNS chunk")
        elif not kind[0] & 0x20:
            raise ValueError(f"PNG: unknown critical chunk {kind!r}")
    width, height, depth, colour, method, filt, interlace = ihdr
    if colour not in _CHANNELS or depth not in _DEPTHS[colour]:
        raise ValueError(f"PNG: colour type {colour} at bit depth {depth}")
    if method or filt or interlace > 1 or not width or not height:
        raise ValueError("PNG: bad IHDR fields")
    if colour == 3 and palette_len is None:
        raise ValueError("PNG: a palette image without PLTE")
    if not idat:
        raise ValueError("PNG: no IDAT")
    return Header(width, height, depth, colour, interlace, b"".join(idat))


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Scanlines ``[batch, rows, 1 + row bytes]`` (filter byte first) to
    their bytes ``[batch, rows, row bytes]``; ``bpp`` is the filters' byte
    distance."""
    batch, rows, width = raw.shape[0], raw.shape[1], raw.shape[2] - 1
    out = np.empty((batch, rows, width), np.uint8)
    prior = np.zeros((batch, width), np.uint8)
    for y in range(rows):
        kinds, line = raw[:, y, 0], raw[:, y, 1:]
        if kinds.max(initial=0) > 4:
            raise ValueError(f"PNG: filter type {int(kinds.max())}")
        cur = line.copy()
        for f in np.unique(kinds).tolist():
            sel = kinds == f
            if f == 1:  # Sub: a running sum at distance bpp
                pix = line[sel].reshape(-1, width // bpp, bpp)
                cur[sel] = np.cumsum(pix, axis=1, dtype=np.uint8).reshape(-1, width)
            elif f == 2:  # Up
                cur[sel] = line[sel] + prior[sel]
            elif f in (3, 4):  # Average, Paeth: one step per pixel column
                src, up = line[sel].astype(np.int16), prior[sel].astype(np.int16)
                rec = np.zeros_like(src)
                for x in range(0, width, bpp):
                    b = up[:, x:x + bpp]
                    if x:
                        a, c = rec[:, x - bpp:x], up[:, x - bpp:x]
                    else:
                        a = c = np.zeros_like(b)
                    if f == 3:
                        pred = (a + b) >> 1
                    else:
                        p = a + b - c
                        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                    rec[:, x:x + bpp] = (src[:, x:x + bpp] + pred) & 0xFF
                cur[sel] = rec.astype(np.uint8)
        out[:, y] = cur
        prior = cur
    return out


def _samples(rows: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered bytes ``[batch, rows, row bytes]`` as integer samples
    ``[batch, rows, width, channels]``."""
    batch, h = rows.shape[:2]
    if depth == 8:
        return rows.reshape(batch, h, width, channels)
    if depth == 16:
        return rows.reshape(batch, h, -1).view(">u2").reshape(batch, h, width, channels)
    bits = np.unpackbits(rows, axis=-1).reshape(batch, h, -1, depth)
    values = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(
        axis=-1, dtype=np.uint8)
    return values[:, :, :width * channels].reshape(batch, h, width, channels)


def _pass_samples(data: np.ndarray, offset: int, w: int, h: int, hd: Header
                  ) -> tuple[np.ndarray, int]:
    channels = _CHANNELS[hd.colour]
    row_bytes = (w * channels * hd.depth + 7) // 8
    size = h * (row_bytes + 1)
    if offset + size > data.shape[1]:
        raise ValueError("PNG: image data shorter than its size")
    raw = data[:, offset:offset + size].reshape(len(data), h, row_bytes + 1)
    bpp = max(1, channels * hd.depth // 8)
    return _samples(_unfilter(raw, bpp), w, hd.depth, channels), offset + size


def _as_pil(samples: np.ndarray, hd: Header) -> np.ndarray:
    """Integer samples as ``np.asarray`` of the image PIL opens."""
    depth, colour = hd.depth, hd.colour
    if colour in (0, 3):
        s = samples[..., 0]
        if colour == 3:
            return s.astype(np.uint8)
        if depth == 1:
            return s.astype(bool)
        if depth in (2, 4):
            return (s * (85 if depth == 2 else 17)).astype(np.uint8)
        return s.astype(np.uint8 if depth == 8 else np.uint16)
    if depth == 16:
        samples = (samples >> 8).astype(np.uint8)
        if colour == 4:  # PIL reads 16-bit grey + alpha as RGBA
            g, a = samples[..., :1], samples[..., 1:]
            return np.concatenate([g, g, g, a], axis=-1)
    return samples.astype(np.uint8)


def _decode_group(headers: list[Header]) -> np.ndarray:
    """Images of one size, colour type, depth and interlace, together."""
    hd = headers[0]
    channels = _CHANNELS[hd.colour]
    if hd.interlace:
        passes = [((hd.width - x0 + dx - 1) // dx, (hd.height - y0 + dy - 1) // dy)
                  for x0, y0, dx, dy in _ADAM7]
    else:
        passes = [(hd.width, hd.height)]
    need = sum(h * ((w * channels * hd.depth + 7) // 8 + 1) for w, h in passes if w and h)
    rows = []
    for h in headers:
        try:
            pixels = zlib.decompress(h.idat)
        except zlib.error as e:
            raise ValueError(f"PNG: corrupt image data ({e})") from e
        if len(pixels) < need:
            raise ValueError("PNG: image data shorter than its size")
        rows.append(np.frombuffer(pixels, np.uint8, need))
    data = np.stack(rows)
    if not hd.interlace:
        samples, _ = _pass_samples(data, 0, hd.width, hd.height, hd)
        return _as_pil(samples, hd)
    full = np.zeros((len(headers), hd.height, hd.width, channels),
                    np.uint16 if hd.depth == 16 else np.uint8)
    offset = 0
    for (x0, y0, dx, dy), (w, h) in zip(_ADAM7, passes):
        if w and h:
            samples, offset = _pass_samples(data, offset, w, h, hd)
            full[:, y0::dy, x0::dx] = samples
    return _as_pil(full, hd)


def decode_many(blobs: list[bytes]) -> list[np.ndarray]:
    """Each PNG's pixels as ``np.asarray(PIL.Image.open(...))`` gives
    them, the images of one shape decoded as one batch."""
    headers = [read_header(bytes(b)) for b in blobs]
    groups: dict[tuple, list[int]] = {}
    for i, h in enumerate(headers):
        groups.setdefault(h[:5], []).append(i)
    out: list[Optional[np.ndarray]] = [None] * len(blobs)
    for idx in groups.values():
        arrays = _decode_group([headers[i] for i in idx])
        for k, i in enumerate(idx):
            out[i] = arrays[k]
    return out  # type: ignore[return-value]


def decode(data: bytes) -> np.ndarray:
    """One PNG's pixels (:func:`decode_many`)."""
    return decode_many([data])[0]


__all__ = ["Header", "SIGNATURE", "decode", "decode_many", "read_header"]
