"""A small baseline JPEG writer for the tests of the port's decoder: it
writes seeded random quantised coefficients straight into the entropy
coder, with the sampling factors, scan layouts and colour markers PIL's
encoder cannot produce (4:4:0, luma 2×2 beside a chroma component at 2×1,
one scan per component, YCCK, no JFIF or Adobe marker). PIL decodes
what it writes, as the reference.

The coefficients stay within what an 8-bit encoder produces (every
dequantised DC within ±1,000 and at most 12 AC terms within ±80 a block),
the range in which libjpeg-turbo's SIMD IDCT and its C IDCT agree.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
          41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15,
          23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)

#: ITU T.81 K.3: (bits per code length, symbols) of the luma / chroma tables.
STD_DC = [((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
          ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12)))]
STD_AC = [((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f024336272820"
    "90a161718191a25262728292a3435363738393a434445464748494a535455565758595a6364"
    "65666768696a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8"
    "a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9"
    "eaf1f2f3f4f5f6f7f8f9fa")),
    ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a16"
        "2434e125f11718191a262728292a35363738393a434445464748494a535455565758595a6364"
        "65666768696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7"
        "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9"
        "eaf2f3f4f5f6f7f8f9fa"))]

JFIF = b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def adobe(transform: int) -> bytes:
    """An Adobe APP14 segment with ``transform``."""
    return b"\xff\xee" + struct.pack(">H", 14) + b"Adobe\x00\x64\x00\x00\x00\x00" + bytes(
        [transform])


def _codes(table: tuple) -> dict[int, tuple[int, int]]:
    """symbol → (code, length) of a canonical Huffman table."""
    bits, values = table
    out, code, p = {}, 0, 0
    for length, n in enumerate(bits, start=1):
        for _ in range(n):
            out[values[p]] = (code, length)
            code += 1
            p += 1
        code <<= 1
    return out


class _BitWriter:
    def __init__(self) -> None:
        self.out = bytearray()
        self.acc = self.n = 0

    def put(self, value: int, length: int) -> None:
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)  # pad with 1-bits
        data, self.out = bytes(self.out), bytearray()
        return data


def _category(v: int) -> int:
    return abs(v).bit_length()


def _encode_block(w: _BitWriter, block: np.ndarray, pred: int, dc: dict, ac: dict) -> int:
    diff = int(block[0]) - pred
    s = _category(diff)
    w.put(*dc[s])
    if s:
        w.put(diff if diff > 0 else diff - 1, s)
    run = 0
    for k in range(1, 64):
        v = int(block[ZIGZAG[k]])
        if not v:
            run += 1
            continue
        while run > 15:
            w.put(*ac[0xF0])
            run -= 16
        s = _category(v)
        w.put(*ac[run << 4 | s])
        w.put(v if v > 0 else v - 1, s)
        run = 0
    if run:
        w.put(*ac[0x00])
    return int(block[0])


def random_coefficients(rng: np.random.Generator, blocks: tuple[int, int],
                        q: np.ndarray) -> np.ndarray:
    """Quantised blocks ``[rows, cols, 64]`` (natural order) whose
    dequantised values stay in the 8-bit encoder's range."""
    rows, cols = blocks
    out = np.zeros((rows, cols, 64), np.int64)
    out[..., 0] = rng.integers(-1000, 1001, (rows, cols)) // int(q[0])
    for r in range(rows):
        for c in range(cols):
            n = int(rng.integers(0, 13))
            pos = rng.choice(np.arange(1, 64), n, replace=False)
            for p in pos:
                lim = 80 // int(q[p])
                if lim:
                    out[r, c, p] = int(rng.integers(-lim, lim + 1))
    return out


def write(width: int, height: int, comps: list[tuple[int, int, int, int]],
          coefs: list[np.ndarray], qtables: dict[int, np.ndarray],
          scans: Optional[list[list[int]]] = None, restart: int = 0,
          markers: bytes = JFIF, dht: bool = True) -> bytes:
    """A baseline JPEG: ``comps`` are (id, h, v, quant table), ``coefs``
    each component's quantised blocks ``[bh, bw, 64]`` over the MCU grid,
    ``scans`` the component indices of each scan (one interleaved scan by
    default), ``restart`` the restart interval in MCUs, ``markers`` the
    segments after SOI, ``dht=False`` leaves the Huffman tables out (the
    decoder's standard tables then apply). Component 0 codes with the
    luma tables, the others with the chroma tables."""
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    out = bytearray(b"\xff\xd8" + markers)
    for slot, q in qtables.items():
        body = bytes([slot]) + bytes(int(q[ZIGZAG[k]]) for k in range(64))
        out += b"\xff\xdb" + struct.pack(">H", 2 + len(body)) + body
    body = struct.pack(">BHHB", 8, height, width, len(comps)) + b"".join(
        bytes([cid, h << 4 | v, tq]) for cid, h, v, tq in comps)
    out += b"\xff\xc0" + struct.pack(">H", 2 + len(body)) + body
    if dht:
        for cls, tables in ((0x00, STD_DC), (0x10, STD_AC)):
            for slot, (bits, values) in enumerate(tables):
                body = bytes([cls | slot]) + bytes(bits) + values
                out += b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body
    if restart:
        out += b"\xff\xdd\x00\x04" + struct.pack(">H", restart)
    codes = {k: (_codes(STD_DC[min(k, 1)]), _codes(STD_AC[min(k, 1)]))
             for k in range(len(comps))}
    for members in scans or [list(range(len(comps)))]:
        body = bytes([len(members)]) + b"".join(
            bytes([comps[k][0], min(k, 1) << 4 | min(k, 1)]) for k in members) + b"\x00\x3f\x00"
        out += b"\xff\xda" + struct.pack(">H", 2 + len(body)) + body
        if len(members) == 1:
            k = members[0]
            cid, h, v, _ = comps[k]
            dw, dh = -(-width * h // hmax), -(-height * v // vmax)
            units = [[(k, r, c)] for r in range(-(-dh // 8)) for c in range(-(-dw // 8))]
        else:
            units = [[(k, my * comps[k][2] + y, mx * comps[k][1] + x) for k in members
                      for y in range(comps[k][2]) for x in range(comps[k][1])]
                     for my in range(mcuy) for mx in range(mcux)]
        w, preds = _BitWriter(), dict.fromkeys(members, 0)
        for i, unit in enumerate(units):
            if restart and i and i % restart == 0:
                out += w.flush() + bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
                preds = dict.fromkeys(members, 0)
            for k, r, c in unit:
                preds[k] = _encode_block(w, coefs[k][r, c], preds[k], *codes[k])
        out += w.flush()
    return bytes(out + b"\xff\xd9")


def random_jpeg(rng: np.random.Generator, width: int, height: int,
                sampling: list[tuple[int, int]], ids: Optional[list[int]] = None,
                **kw) -> bytes:
    """:func:`write` of random coefficients for components with
    ``sampling`` factors (quant tables with steps 1-12 in slots 0 and 1)."""
    qtables = {0: rng.integers(1, 13, 64), 1: rng.integers(1, 13, 64)}
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    ids = ids or list(range(1, len(sampling) + 1))
    comps = [(ids[k], h, v, min(k, 1)) for k, (h, v) in enumerate(sampling)]
    coefs = [random_coefficients(rng, (mcuy * v, mcux * h), qtables[min(k, 1)])
             for k, (h, v) in enumerate(sampling)]
    return write(width, height, comps, coefs, qtables, **kw)
