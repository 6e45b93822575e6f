"""The images of an ``Image()`` column as the reference's
``datasets.Image.decode_example`` gives them, with numpy and the
standard library.

:func:`decode_many` sniffs each blob's format by its magic bytes and
decodes the PNGs through :mod:`png` and the JPEGs through :mod:`jpeg`,
each format in one batch. It then applies the EXIF orientation as
``decode_example`` applies it: ``PIL.ImageOps.exif_transpose`` whenever
``image.getexif()`` holds an Orientation tag (0x0112).

:func:`orientation` reads that tag where ``PIL.Image.getexif`` reads it,
in its order:

1. the ``exif`` info: a PNG ``eXIf`` chunk or ``tEXt`` keyed ``exif``, or
   a JPEG's ``Exif`` APP1 (PIL appends the payload of each later ``Exif``
   APP1 to the first one's bytes), parsed as TIFF IFD0 in either byte
   order as ``TiffImagePlugin.ImageFileDirectory_v2`` parses it;
2. for PNG without it, the hex of a ``Raw profile type exif`` text chunk
   (``tEXt``, ``zTXt`` or ``iTXt``);
3. failing both, ``tiff:Orientation(="|>)([0-9])`` in the XMP: a PNG's
   ``XML:com.adobe.xmp`` text, else its raw iTXt bytes; a JPEG's last
   ``http://ns.adobe.com/xap/1.0/`` APP1.

A JPEG's EXIF is first read when PIL opens it, where no JFIF density in
dots gave a ``dpi``; an EXIF PIL cannot parse then leaves no tag at all.
Where PIL's ``getexif`` itself raises (and so the reference's loader),
this module raises ``ValueError``. Other formats (GIF, BMP, WEBP, TIFF,
ICO) raise ``NotImplementedError`` naming them.
"""

from __future__ import annotations

import re
import struct
import zlib
from fractions import Fraction
from typing import Any, Optional

import numpy as np

from tpfl_torch.learning.dataset import jpeg, png

ORIENTATION = 0x0112
_XMP_ORIENTATION = re.compile(rb'tiff:Orientation(="|>)([0-9])')
_XMP_APP1 = b"http://ns.adobe.com/xap/1.0/\x00"
#: TIFF field type → (bytes per value, struct code); None: not a number
#: (BYTE and UNDEFINED load as bytes, ASCII as str), "r" / "R": rationals.
_TIFF_TYPES = {1: (1, None), 2: (1, None), 3: (2, "H"), 4: (4, "L"), 5: (8, "R"),
               6: (1, "b"), 7: (1, None), 8: (2, "h"), 9: (4, "l"), 10: (8, "r"),
               11: (4, "f"), 12: (8, "d"), 13: (4, "L"), 16: (8, "Q")}
_TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b",
                  b"II\x2b\x00")


class ExifError(ValueError):
    """EXIF data that ``PIL.Image.Exif.load`` raises on."""


def _refuse(data: bytes) -> NotImplementedError:
    return NotImplementedError(f"image decoding: {png._format_name(data)} is not ported, "
                               f"only PNG and JPEG ({png._IMAGE_ITEM})")


def _ifd0_orientation(data: Any) -> tuple[bool, Any]:
    """(present, value) of IFD0's Orientation in ``exif`` info ``data``,
    as ``Exif.load`` then ``Exif.get`` read it."""
    if isinstance(data, str):
        if data:  # PIL's bytes prefix test on a str raises TypeError
            raise ExifError("EXIF text where bytes belong")
        return False, None
    while data.startswith(b"Exif\x00\x00"):
        data = data[6:]
    if not data:
        return False, None
    head = data[:8]
    if not head.startswith(_TIFF_PREFIXES) or len(head) < 8 or head[2] == 0x2B:
        raise ExifError("not a TIFF header")
    endian = "<" if head[:2] == b"II" else ">"
    offset = struct.unpack(endian + "L", head[4:8])[0]
    found: Optional[tuple[int, bytes]] = None
    if offset + 2 <= len(data):
        count = struct.unpack_from(endian + "H", data, offset)[0]
        for k in range(count):
            at = offset + 2 + 12 * k
            if at + 12 > len(data):
                break
            tag, typ, n, raw = struct.unpack_from(endian + "HHL4s", data, at)
            if typ not in _TIFF_TYPES:
                continue
            size = n * _TIFF_TYPES[typ][0]
            if size > 4:
                start = struct.unpack(endian + "L", raw)[0]
                raw = data[start:start + size]
                if len(raw) != size:
                    break  # PIL stops the directory at a truncated read
            else:
                raw = raw[:size]
            if raw and tag == ORIENTATION:
                found = (typ, raw)
    if found is None:
        return False, None
    typ, raw = found
    size, code = _TIFF_TYPES[typ]
    if code is None:
        return True, raw  # bytes or str: no orientation PIL transposes by
    if code in "rR":
        num, den = struct.unpack_from(endian + ("ll" if code == "r" else "LL"), raw)
        return True, Fraction(num, den) if den else float("nan")
    return True, struct.unpack_from(endian + code, raw)[0]


def _png_info(data: bytes) -> dict[str, Any]:
    """The keys of ``PngImageFile.info`` that ``getexif`` reads, set chunk
    by chunk as PIL's chunk handlers set them."""
    info: dict[str, Any] = {}
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            break
        if kind == b"eXIf":
            info["exif"] = b"Exif\x00\x00" + body
        elif kind in (b"tEXt", b"zTXt"):
            key, _, value = body.partition(b"\x00")
            if kind == b"zTXt":
                if value and value[0]:
                    raise ValueError(f"PNG: zTXt compression method {value[0]}")
                try:
                    value = zlib.decompress(value[1:])
                except zlib.error:
                    value = b""
            if key:
                info[key.decode("latin-1")] = (value if key == b"exif" and kind == b"tEXt"
                                               else value.decode("latin-1"))
        elif kind == b"iTXt":
            key, sep, rest = body.partition(b"\x00")
            if not sep or len(rest) < 2:
                continue
            compressed, method, rest = rest[0], rest[1], rest[2:]
            fields = rest.split(b"\x00", 2)
            if len(fields) < 3:
                continue
            value = fields[2]
            if compressed:
                if method:
                    continue
                try:
                    value = zlib.decompress(value)
                except zlib.error:
                    continue
            if key == b"XML:com.adobe.xmp":
                info["xmp"] = value
            try:
                fields[0].decode("utf-8"), fields[1].decode("utf-8")
                text = value.decode("utf-8")
            except UnicodeError:
                continue
            info[key.decode("latin-1")] = text
    return info


def _jpeg_info(data: bytes) -> dict[str, Any]:
    """The keys of ``JpegImageFile.info`` that orientation depends on,
    from the APP segments before the first SOS, as PIL's ``APP`` handler
    sets them."""
    info: dict[str, Any] = {}
    for code, body in jpeg.app_segments(data):
        if code == 0xE0 and body.startswith(b"JFIF") and len(body) >= 12 and body[7] in (1, 2):
            info["dpi"] = True
        elif code == 0xE1 and body.startswith(b"Exif\x00\x00"):
            info["exif"] = info["exif"] + body[6:] if "exif" in info else body
        elif code == 0xE1 and body.startswith(_XMP_APP1):
            info["xmp"] = body[len(_XMP_APP1):]
    return info


def _xmp_orientation(info: dict[str, Any]) -> Optional[int]:
    text = info.get("XML:com.adobe.xmp")
    raw = text.encode("utf-8") if text else info.get("xmp")
    match = _XMP_ORIENTATION.search(raw) if raw else None
    return int(match[2]) if match else None


def orientation(data: bytes) -> Optional[Any]:
    """The Orientation value ``getexif()`` gives for an image's bytes
    (None where it holds no such tag)."""
    data = bytes(data)
    if data.startswith(png.SIGNATURE):
        info = _png_info(data)
        exif = info.get("exif")
        if exif is None and "Raw profile type exif" in info:
            try:
                exif = bytes.fromhex("".join(info["Raw profile type exif"].split("\n")[3:]))
            except ValueError as e:
                raise ExifError(f"PNG: the raw exif profile is not hex ({e})") from e
        present, value = _ifd0_orientation(exif) if exif is not None else (False, None)
    elif data.startswith(jpeg.SOI):
        info = _jpeg_info(data)
        try:
            present, value = _ifd0_orientation(info["exif"]) if "exif" in info else (
                False, None)
        except (ExifError, struct.error):
            if "dpi" in info:
                raise  # PIL raises when datasets asks
            return None  # PIL swallowed it at open and keeps an empty EXIF
    else:
        raise _refuse(data)
    return value if present else _xmp_orientation(info)


def transpose(image: np.ndarray, value: Any) -> np.ndarray:
    """``ImageOps.exif_transpose``'s transposition for Orientation
    ``value`` on an array ``[H, W(, C)]`` (none for other values)."""
    method = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
              5: lambda a: a.swapaxes(0, 1), 6: lambda a: np.rot90(a, -1),
              7: lambda a: a[::-1, ::-1].swapaxes(0, 1), 8: lambda a: np.rot90(a, 1)}
    for k, fn in method.items():
        if value == k:
            return np.ascontiguousarray(fn(image))
    return image


def decode_many(blobs: list[bytes]) -> list[np.ndarray]:
    """Each image's pixels as the reference's ``Image()`` feature gives
    them: PNG and JPEG each decoded as a batch, then oriented."""
    blobs = [bytes(b) for b in blobs]
    by_format: dict[str, list[int]] = {"png": [], "jpeg": []}
    for i, b in enumerate(blobs):
        if b.startswith(png.SIGNATURE):
            by_format["png"].append(i)
        elif b.startswith(jpeg.SOI):
            by_format["jpeg"].append(i)
        else:
            raise _refuse(b)
    out: list[Optional[np.ndarray]] = [None] * len(blobs)
    for name, decoder in (("png", png.decode_many), ("jpeg", jpeg.decode_many)):
        idx = by_format[name]
        for i, a in zip(idx, decoder([blobs[i] for i in idx]) if idx else []):
            out[i] = transpose(a, orientation(blobs[i]))
    return out  # type: ignore[return-value]


__all__ = ["ExifError", "ORIENTATION", "decode_many", "orientation", "transpose"]
