"""JPEG decoding equal to ``np.asarray(PIL.Image.open(f))`` — what the
reference's ``Image()`` feature gives its export through PIL and its
libjpeg-turbo — with numpy only.

- **Format:** SOI, APPn (JFIF, the Adobe APP14 and its transform; Exif,
  XMP and MPF are skipped here and read by :mod:`images`), DQT at 8 and
  16 bits, DHT (libjpeg-turbo's standard tables stand in table slots 0
  and 1 until a file defines them), DRI, SOF0 / SOF1 / SOF2 at 8-bit
  precision, SOS, COM and EOI; tables redefined between scans; fill
  bytes ``0xFF`` before a marker. Decoding stops at the first EOI, so an
  MPO file gives its first frame, as PIL opens it.
- **Entropy decoding:** baseline and extended sequential Huffman scans,
  interleaved or of one component (a one-component scan covers the
  component's own blocks, not the MCU grid), restart intervals, and
  progressive scans: DC first and refinement, AC first with EOBRUN, AC
  refinement with its correction bits. One Python loop per scan over a
  9-bit lookahead table, with a canonical slow path for longer codes;
  every per-pixel stage stays out of that loop.
- **Reconstruction, vectorised over every block of a batch of images of
  one geometry:** dequantisation by the table each component latched at
  its first scan; libjpeg-turbo's ISLOW IDCT (``jidctint.c``:
  ``CONST_BITS`` 13, ``PASS1_BITS`` 2, its roundings and its
  ``range_limit`` table); upsampling as ``jdsample.c`` does it
  (``h2v1`` / ``h2v2`` fancy upsampling with their alternating biases
  where the component is wider than 2 samples, ``h1v2`` fancy, and box
  replication otherwise), the last real column and row replicated at the
  edges as the main controller replicates them; the colour space chosen
  as ``default_decompress_parms`` chooses it (JFIF, the Adobe transform,
  component ids 1-2-3 or R-G-B) and converted as ``jdcolor.c`` converts
  it (``SCALEBITS`` 16 tables for YCbCr→RGB and YCCK→CMYK), CMYK then
  inverted as PIL's ``CMYK;I`` raw mode inverts it. Mode ``L`` gives
  ``uint8 [H, W]``, ``RGB`` ``[H, W, 3]`` and ``CMYK`` ``[H, W, 4]``.
- **Range:** libjpeg-turbo's SIMD IDCT (what PIL runs on x86-64) and its
  C IDCT agree only while the dequantised coefficients stay within what
  an 8-bit encoder produces, about ±1,024. This module computes the C
  IDCT, so it equals PIL inside that range; a file beyond it may differ.
- **Refusals:** arithmetic coding (SOF9-SOF15), lossless (SOF3),
  hierarchical (SOF5-SOF7, DHP, EXP), a precision other than 8 bits,
  DNL, and a progressive file whose last scans leave a low AC
  coefficient unrefined (libjpeg then smooths blocks) raise
  ``NotImplementedError`` naming the ROADMAP heading; a file PIL cannot
  open, and corrupt data libjpeg only warns about (a lost restart
  marker, a bad Huffman code, a bogus progression, data running past its
  segment), raise ``ValueError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tpfl_torch.learning.dataset.png import _IMAGE_ITEM

SOI = b"\xff\xd8\xff"

#: Zigzag position → natural (row-major) position, with the 16 guard
#: entries libjpeg keeps past the end.
_NATURAL = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
            41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15,
            23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)

#: libjpeg-turbo's standard tables (ITU T.81 K.3), which it installs in
#: slots 0 and 1 where a file defines none (Motion-JPEG frames).
_STD_DC = {
    0: (bytes((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)), bytes(range(12))),
    1: (bytes((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0)), bytes(range(12))),
}
_STD_AC = {
    0: (bytes((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125)), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f024336272820"
        "90a161718191a25262728292a3435363738393a434445464748494a535455565758595a6364"
        "65666768696a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8"
        "a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9"
        "eaf1f2f3f4f5f6f7f8f9fa")),
    1: (bytes((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119)), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a16"
        "2434e125f11718191a262728292a35363738393a434445464748494a535455565758595a6364"
        "65666768696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7"
        "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9"
        "eaf2f3f4f5f6f7f8f9fa")),
}

_LOOK = 9  # lookahead bits of the fast Huffman table
_M32 = 0xFFFFFFFF
#: Natural positions whose quantizers libjpeg's block smoothing divides by.
_SMOOTH_Q = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)
_REFUSED_SOF = {0xC3: "lossless (SOF3)", 0xC5: "hierarchical (SOF5)",
                0xC6: "hierarchical (SOF6)", 0xC7: "hierarchical (SOF7)",
                0xC9: "arithmetic coding (SOF9)", 0xCA: "arithmetic coding (SOF10)",
                0xCB: "arithmetic coding (SOF11)", 0xCD: "arithmetic coding (SOF13)",
                0xCE: "arithmetic coding (SOF14)", 0xCF: "arithmetic coding (SOF15)",
                0xDE: "hierarchical (DHP)", 0xDF: "hierarchical (EXP)",
                0xDC: "a DNL marker (the height given after the first scan)"}


def _refuse(what: str) -> NotImplementedError:
    return NotImplementedError(f"JPEG: {what} is not ported ({_IMAGE_ITEM})")


class _Huffman:
    """A Huffman table as ``jpeg_make_d_derived_tbl`` builds it: ``look``
    maps the next 9 bits to ``length << 8 | symbol`` (0: a longer code),
    ``maxcode`` / ``offset`` / ``values`` decode the longer codes."""

    __slots__ = ("look", "maxcode", "offset", "values")

    def __init__(self, bits: bytes, values: bytes, dc: bool) -> None:
        if sum(bits) > 256 or len(values) != sum(bits):
            raise ValueError("JPEG: bad Huffman table")
        if dc and any(v > 15 for v in values):
            raise ValueError("JPEG: bad Huffman table (a DC symbol above 15)")
        self.values = values
        self.look = [0] * (1 << _LOOK)
        self.maxcode = [-1] * 18
        self.offset = [0] * 18
        code = p = 0
        for length in range(1, 17):
            n = bits[length - 1]
            if n:
                self.offset[length] = p - code
                for i in range(n):
                    if length <= _LOOK:
                        shift = _LOOK - length
                        entry = length << 8 | values[p + i]
                        base = (code + i) << shift
                        self.look[base:base + (1 << shift)] = [entry] * (1 << shift)
                code += n
                p += n
                self.maxcode[length] = code - 1
            if code >= 1 << length:  # no code may be all ones
                raise ValueError("JPEG: bad Huffman table")
            code <<= 1

    def slow(self, window: int) -> tuple[int, int]:
        """(length, symbol) of a code longer than the lookahead, from the
        32 bits at the read position."""
        for length in range(_LOOK + 1, 17):
            code = window >> (32 - length)
            if code <= self.maxcode[length]:
                return length, self.values[self.offset[length] + code]
        raise ValueError("JPEG: corrupt data (a Huffman code not in its table)")


class _Component:
    __slots__ = ("id", "h", "v", "tq", "dw", "dh", "wib", "hib", "bw", "bh", "coefs", "qt",
                 "bits")

    def __init__(self, cid: int, h: int, v: int, tq: int) -> None:
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.qt: Optional[tuple] = None  # latched at the component's first scan
        self.bits = [-1] * 64  # progressive: the last Al of each coefficient


class Frame:
    """A parsed and entropy-decoded JPEG: its geometry, colour space and
    each component's quantised coefficients."""

    def __init__(self, width: int, height: int, comps: list[_Component], progressive: bool
                 ) -> None:
        self.width, self.height, self.comps = width, height, comps
        self.progressive = progressive
        self.hmax = max(c.h for c in comps)
        self.vmax = max(c.v for c in comps)
        self.mcux = -(-width // (8 * self.hmax))
        self.mcuy = -(-height // (8 * self.vmax))
        for c in comps:
            c.dw = -(-width * c.h // self.hmax)
            c.dh = -(-height * c.v // self.vmax)
            c.wib, c.hib = -(-c.dw // 8), -(-c.dh // 8)
            c.bw, c.bh = self.mcux * c.h, self.mcuy * c.v
            c.coefs = [0] * (c.bw * c.bh * 64)
        self.jfif = False
        self.adobe: Optional[int] = None
        self.space = ""

    def key(self) -> tuple:
        return (self.width, self.height, self.space,
                tuple((c.h, c.v) for c in self.comps))


def _next_marker(data: bytes, pos: int) -> tuple[int, int]:
    """The next marker's code and the position after it, skipping what
    libjpeg's ``next_marker`` skips (stray bytes, fill bytes, FF 00)."""
    n = len(data)
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0:
            raise ValueError("JPEG: truncated (no EOI)")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise ValueError("JPEG: truncated (no EOI)")
        if data[pos]:
            return data[pos], pos + 1
        pos += 1


def _entropy_data(data: bytes, pos: int) -> tuple[list[bytes], list[int], int]:
    """A scan's entropy-coded data from ``pos``: each restart interval's
    bytes unstuffed, the RSTn numbers between them, and the position of
    the code byte of the marker that ends the scan."""
    n = len(data)
    intervals, rst, parts = [], [], []
    start = pos
    while True:
        i = data.find(b"\xff", pos)
        if i < 0:
            raise ValueError("JPEG: truncated entropy-coded data")
        j = i + 1
        while j < n and data[j] == 0xFF:
            j += 1
        if j >= n:
            raise ValueError("JPEG: truncated entropy-coded data")
        code = data[j]
        if code == 0:  # FF (FF...) 00: one FF data byte
            parts.append(data[start:i + 1])
        else:
            parts.append(data[start:i])
            intervals.append(b"".join(parts))
            parts = []
            if not 0xD0 <= code <= 0xD7:
                return intervals, rst, j
            rst.append(code - 0xD0)
        start = pos = j + 1


class _Bits:
    """The unstuffed intervals of one scan as one buffer read through
    40-bit windows: ``window(p)`` is the 32 bits from bit ``p`` on."""

    def __init__(self, intervals: list[bytes], rst: list[int]) -> None:
        for k, r in enumerate(rst):
            if r != k % 8:
                raise ValueError(f"JPEG: restart marker RST{r} where RST{k % 8} belongs")
        self.starts = [0]
        for part in intervals:
            self.starts.append(self.starts[-1] + len(part))
        buf = np.frombuffer(b"".join(intervals) + bytes(8), np.uint8).astype(np.int64)
        m = len(buf) - 4
        w = buf[:m] << 32
        for k in range(1, 5):
            w |= buf[k:m + k] << (32 - 8 * k)
        self.words = w.tolist()
        self.interval = 0

    def end(self) -> int:
        """The bit where the current interval's data ends."""
        return self.starts[self.interval + 1] * 8

    def restart(self, pos: int) -> int:
        """Check the interval just decoded stayed inside its data and move
        to the next one (libjpeg's ``process_restart``)."""
        if pos > self.end():
            raise ValueError("JPEG: corrupt data (a restart interval runs past its data)")
        self.interval += 1
        if self.interval + 1 >= len(self.starts):
            raise ValueError("JPEG: corrupt data (a restart marker is missing)")
        return self.starts[self.interval] * 8

    def finish(self, pos: int) -> None:
        if pos > self.end():
            raise ValueError("JPEG: corrupt data (the scan runs past its data)")


class _Scan:
    __slots__ = ("comps", "ss", "se", "ah", "al", "dc", "ac", "ri")


def _blocks_of(frame: Frame, scan: _Scan) -> tuple[int, int, list[tuple]]:
    """The scan's MCU grid and, per block of an MCU, its component index,
    offset within the MCU and tables."""
    comps = scan.comps
    if len(comps) == 1:
        c = comps[0]
        return c.wib, c.hib, [(0, 0, scan.dc[0], scan.ac[0])]
    if sum(c.h * c.v for c in comps) > 10:
        raise ValueError("JPEG: more than 10 blocks in an MCU")
    blocks = []
    for k, c in enumerate(comps):
        for y in range(c.v):
            for x in range(c.h):
                blocks.append((k, (y * c.bw + x) * 64, scan.dc[k], scan.ac[k]))
    return frame.mcux, frame.mcuy, blocks


def _mcu_bases(frame: Frame, scan: _Scan, mx: int, my: int) -> list[int]:
    if len(scan.comps) == 1:
        c = scan.comps[0]
        return [(my * c.bw + mx) * 64]
    return [(my * c.v * c.bw + mx * c.h) * 64 for c in scan.comps]


def _decode_sequential(frame: Frame, scan: _Scan, bits: _Bits) -> None:
    """A baseline / extended sequential scan (``jdhuff.c``'s ``decode_mcu``)."""
    words, nat, m32 = bits.words, _NATURAL, _M32
    nx, ny, blocks = _blocks_of(frame, scan)
    coefs = [c.coefs for c in scan.comps]
    preds = [0] * len(scan.comps)
    ri, togo, pos = scan.ri, scan.ri, 0
    for my in range(ny):
        for mx in range(nx):
            if ri:
                if not togo:
                    pos = bits.restart(pos)
                    preds = [0] * len(scan.comps)
                    togo = ri
                togo -= 1
            bases = _mcu_bases(frame, scan, mx, my)
            for k, off, dct, act in blocks:
                co = coefs[k]
                base = bases[k] + off
                window = (words[pos >> 3] >> (8 - (pos & 7))) & m32
                e = dct.look[window >> 23]
                if e:
                    length, s = e >> 8, e & 255
                else:
                    length, s = dct.slow(window)
                if s:
                    r = (window >> (32 - length - s)) & ((1 << s) - 1)
                    if r < 1 << (s - 1):
                        r += 1 - (1 << s)
                    preds[k] += r
                pos += length + s
                co[base] = preds[k]
                look, slow = act.look, act.slow
                i = 1
                while i < 64:
                    window = (words[pos >> 3] >> (8 - (pos & 7))) & m32
                    e = look[window >> 23]
                    if e:
                        length, rs = e >> 8, e & 255
                    else:
                        length, rs = slow(window)
                    s = rs & 15
                    if s:
                        i += rs >> 4
                        r = (window >> (32 - length - s)) & ((1 << s) - 1)
                        if r < 1 << (s - 1):
                            r += 1 - (1 << s)
                        pos += length + s
                        if i > 63:
                            raise ValueError("JPEG: corrupt data (a run past the block)")
                        co[base + nat[i]] = r
                        i += 1
                    else:
                        pos += length
                        if rs != 0xF0:
                            break
                        i += 16
    bits.finish(pos)


def _decode_dc(frame: Frame, scan: _Scan, bits: _Bits) -> None:
    """A progressive DC scan, first (``decode_mcu_DC_first``) or
    refinement (``decode_mcu_DC_refine``)."""
    words, m32 = bits.words, _M32
    nx, ny, blocks = _blocks_of(frame, scan)
    coefs = [c.coefs for c in scan.comps]
    preds = [0] * len(scan.comps)
    ri, togo, pos, al = scan.ri, scan.ri, 0, scan.al
    first, p1 = scan.ah == 0, 1 << scan.al
    for my in range(ny):
        for mx in range(nx):
            if ri:
                if not togo:
                    pos = bits.restart(pos)
                    preds = [0] * len(scan.comps)
                    togo = ri
                togo -= 1
            bases = _mcu_bases(frame, scan, mx, my)
            for k, off, dct, _ in blocks:
                co = coefs[k]
                base = bases[k] + off
                window = (words[pos >> 3] >> (8 - (pos & 7))) & m32
                if not first:
                    if window >> 31:
                        co[base] |= p1
                    pos += 1
                    continue
                e = dct.look[window >> 23]
                if e:
                    length, s = e >> 8, e & 255
                else:
                    length, s = dct.slow(window)
                if s:
                    r = (window >> (32 - length - s)) & ((1 << s) - 1)
                    if r < 1 << (s - 1):
                        r += 1 - (1 << s)
                    preds[k] += r
                pos += length + s
                co[base] = preds[k] << al
    bits.finish(pos)


def _decode_ac_first(frame: Frame, scan: _Scan, bits: _Bits) -> None:
    """A progressive AC first scan (``decode_mcu_AC_first``)."""
    words, nat, m32 = bits.words, _NATURAL, _M32
    c = scan.comps[0]
    co, look, slow = c.coefs, scan.ac[0].look, scan.ac[0].slow
    ri, togo, pos, al, ss, se = scan.ri, scan.ri, 0, scan.al, scan.ss, scan.se
    eobrun = 0
    for my in range(c.hib):
        for mx in range(c.wib):
            if ri:
                if not togo:
                    pos = bits.restart(pos)
                    eobrun = 0
                    togo = ri
                togo -= 1
            if eobrun:
                eobrun -= 1
                continue
            base = (my * c.bw + mx) * 64
            i = ss
            while i <= se:
                window = (words[pos >> 3] >> (8 - (pos & 7))) & m32
                e = look[window >> 23]
                if e:
                    length, rs = e >> 8, e & 255
                else:
                    length, rs = slow(window)
                r, s = rs >> 4, rs & 15
                if s:
                    i += r
                    v = (window >> (32 - length - s)) & ((1 << s) - 1)
                    if v < 1 << (s - 1):
                        v += 1 - (1 << s)
                    pos += length + s
                    if i > se:
                        raise ValueError("JPEG: corrupt data (a run past the band)")
                    co[base + nat[i]] = v << al
                elif r == 15:
                    pos += length
                    i += 15
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += (window >> (32 - length - r)) & ((1 << r) - 1)
                    pos += length + r
                    eobrun -= 1
                    break
                i += 1
    bits.finish(pos)


def _decode_ac_refine(frame: Frame, scan: _Scan, bits: _Bits) -> None:
    """A progressive AC refinement scan (``decode_mcu_AC_refine``)."""
    words, nat, m32 = bits.words, _NATURAL, _M32
    c = scan.comps[0]
    co, look, slow = c.coefs, scan.ac[0].look, scan.ac[0].slow
    ri, togo, pos, ss, se = scan.ri, scan.ri, 0, scan.ss, scan.se
    p1, m1 = 1 << scan.al, -1 << scan.al
    eobrun = 0
    for my in range(c.hib):
        for mx in range(c.wib):
            if ri:
                if not togo:
                    pos = bits.restart(pos)
                    eobrun = 0
                    togo = ri
                togo -= 1
            base = (my * c.bw + mx) * 64
            i = ss
            if not eobrun:
                while i <= se:
                    window = (words[pos >> 3] >> (8 - (pos & 7))) & m32
                    e = look[window >> 23]
                    if e:
                        length, rs = e >> 8, e & 255
                    else:
                        length, rs = slow(window)
                    r, s = rs >> 4, rs & 15
                    pos += length
                    if s:
                        if s != 1:
                            raise ValueError("JPEG: corrupt data (a refinement of size "
                                             f"{s})")
                        s = p1 if (window >> (31 - length)) & 1 else m1
                        pos += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += (window >> (32 - length - r)) & ((1 << r) - 1)
                            pos += r
                        break
                    while i <= se:
                        at = base + nat[i]
                        z = co[at]
                        if z:
                            if (words[pos >> 3] >> (39 - (pos & 7))) & 1 and not z & p1:
                                co[at] = z + (p1 if z >= 0 else m1)
                            pos += 1
                        else:
                            if r == 0:
                                break
                            r -= 1
                        i += 1
                    if s:
                        if i > se:
                            raise ValueError("JPEG: corrupt data (a run past the band)")
                        co[base + nat[i]] = s
                    i += 1
            if eobrun:
                while i <= se:
                    at = base + nat[i]
                    z = co[at]
                    if z:
                        if (words[pos >> 3] >> (39 - (pos & 7))) & 1 and not z & p1:
                            co[at] = z + (p1 if z >= 0 else m1)
                        pos += 1
                    i += 1
                eobrun -= 1
    bits.finish(pos)


def _progression(frame: Frame, scan: _Scan) -> None:
    """``start_pass_phuff_decoder``'s checks; the coefficients' bit
    history (``coef_bits``) updated."""
    dc = scan.ss == 0
    bad = (scan.se != 0) if dc else (scan.ss > scan.se or scan.se > 63 or len(scan.comps) != 1)
    if (scan.ah and scan.al != scan.ah - 1) or scan.al > 13 or bad:
        raise ValueError(f"JPEG: bad progression (Ss {scan.ss} Se {scan.se} Ah {scan.ah} "
                         f"Al {scan.al})")
    for c in scan.comps:
        if not dc and c.bits[0] < 0:
            raise ValueError("JPEG: corrupt data (an AC scan before the DC scan)")
        for i in range(scan.ss, scan.se + 1):
            if scan.ah != max(c.bits[i], 0):
                raise ValueError("JPEG: corrupt data (a bogus progression)")
            c.bits[i] = scan.al


def _smoothing(frame: Frame) -> bool:
    """libjpeg's ``smoothing_ok``: whether its output pass would smooth
    the blocks of this progressive file."""
    useful = False
    for c in frame.comps:
        if c.qt is None or any(c.qt[i] == 0 for i in _SMOOTH_Q) or c.bits[0] < 0:
            return False
        useful = useful or any(c.bits[i] != 0 for i in range(1, 10))
    return useful


def _huffman(tables: dict, cache: dict, slot: int, dc: bool) -> _Huffman:
    if slot not in tables:
        raise ValueError(f"JPEG: Huffman table {slot} used but not defined")
    spec = tables[slot]
    if (spec, dc) not in cache:
        cache[spec, dc] = _Huffman(spec[0], spec[1], dc)
    return cache[spec, dc]


def _colour_space(frame: Frame) -> str:
    """``jdapimin.c``'s ``default_decompress_parms``."""
    n = len(frame.comps)
    if n == 1:
        return "L"
    if n == 3:
        if frame.jfif:
            return "YCbCr"
        if frame.adobe is not None:
            return "RGB" if frame.adobe == 0 else "YCbCr"
        ids = tuple(c.id for c in frame.comps)
        return "RGB" if ids == (82, 71, 66) else "YCbCr"
    if frame.adobe is not None:
        return "CMYK" if frame.adobe == 0 else "YCCK"
    return "CMYK"


def parse(data: bytes) -> Frame:
    """The file's markers read and every scan entropy-decoded: a
    :class:`Frame` with each component's quantised coefficients."""
    data = bytes(data)
    if not data.startswith(SOI):
        raise ValueError("JPEG: no SOI marker")
    pos = 2
    frame: Optional[Frame] = None
    quant: dict[int, tuple] = {}
    dc_tables, ac_tables = dict(_STD_DC), dict(_STD_AC)
    cache: dict = {}
    ri, jfif, adobe, scans, single = 0, False, None, 0, False
    while True:
        code, pos = _next_marker(data, pos)
        if code == 0xD9:
            break
        if 0xD0 <= code <= 0xD7 or code == 0x01:
            continue
        if code == 0xD8:
            raise ValueError("JPEG: a second SOI marker")
        if code in _REFUSED_SOF:
            raise _refuse(_REFUSED_SOF[code])
        if pos + 2 > len(data):
            raise ValueError("JPEG: truncated marker")
        length = data[pos] << 8 | data[pos + 1]
        body = data[pos + 2:pos + length]
        if length < 2 or len(body) != length - 2:
            raise ValueError(f"JPEG: marker 0xFF{code:02X} runs past the file")
        pos += length
        if code in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError("JPEG: a second SOF marker")
            if len(body) < 6:
                raise ValueError("JPEG: bad SOF length")
            if body[0] != 8:
                raise _refuse(f"{body[0]}-bit precision")
            height, width, n = body[1] << 8 | body[2], body[3] << 8 | body[4], body[5]
            if len(body) != 6 + 3 * n:
                raise ValueError("JPEG: bad SOF length")
            if n not in (1, 3, 4):
                raise ValueError(f"JPEG: {n} components (PIL reads 1, 3 or 4)")
            if not height:
                raise _refuse("a DNL marker (the height given after the first scan)")
            if not width:
                raise ValueError("JPEG: an empty image")
            comps = []
            for k in range(n):
                cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
                if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4) or tq > 3:
                    raise ValueError("JPEG: bad sampling factors or table number")
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
            frame = Frame(width, height, comps, code == 0xC2)
        elif code == 0xC4:
            p = 0
            while p < len(body):
                if p + 17 > len(body):
                    raise ValueError("JPEG: bad DHT length")
                index, bits = body[p], body[p + 1:p + 17]
                values = body[p + 17:p + 17 + sum(bits)]
                if sum(bits) > 256 or len(values) != sum(bits) or index & 0xEC:
                    raise ValueError("JPEG: bad DHT marker")
                (ac_tables if index & 0x10 else dc_tables)[index & 3] = (bytes(bits), values)
                p += 17 + len(values)
        elif code == 0xDB:
            p = 0
            while p < len(body):
                prec, slot = body[p] >> 4, body[p] & 15
                size = 64 * (prec + 1)
                if prec > 1 or slot > 3 or p + 1 + size > len(body):
                    raise ValueError("JPEG: bad DQT marker")
                raw = body[p + 1:p + 1 + size]
                zz = raw if not prec else [raw[2 * i] << 8 | raw[2 * i + 1] for i in range(64)]
                q = [0] * 64
                for i in range(64):
                    q[_NATURAL[i]] = zz[i]
                quant[slot] = tuple(q)
                p += 1 + size
        elif code == 0xDD:
            if len(body) != 2:
                raise ValueError("JPEG: bad DRI length")
            ri = body[0] << 8 | body[1]
        elif code in (0xE0, 0xEE) and not scans:  # the colour space is chosen at the first SOS
            if body.startswith(b"JFIF" if code == 0xE0 else b"Adobe") and len(body) < 7:
                raise ValueError("JPEG: a truncated JFIF or Adobe segment")  # PIL's APP
            if code == 0xE0:
                jfif = jfif or (len(body) >= 14 and body.startswith(b"JFIF\0"))
            elif len(body) >= 12 and body.startswith(b"Adobe"):
                adobe = body[11]
        elif code == 0xDA:
            if frame is None:
                raise ValueError("JPEG: a scan before the frame header")
            if single:
                raise ValueError("JPEG: a second scan after a complete sequential scan")
            n = body[0] if body else 0
            if not 1 <= n <= 4 or len(body) != 4 + 2 * n:
                raise ValueError("JPEG: bad SOS length")
            scan = _Scan()
            scan.comps, slots = [], []
            for k in range(n):
                cid, tables = body[1 + 2 * k], body[2 + 2 * k]
                match = [c for c in frame.comps if c.id == cid and c not in scan.comps]
                if not match:
                    raise ValueError("JPEG: bad component or table in SOS")
                scan.comps.append(match[0])
                slots.append((tables >> 4, tables & 15))
            scan.ss, scan.se = body[1 + 2 * n], body[2 + 2 * n]
            scan.ah, scan.al = body[3 + 2 * n] >> 4, body[3 + 2 * n] & 15
            scan.ri = ri
            for c in scan.comps:
                if c.qt is None:
                    if c.tq not in quant:
                        raise ValueError(f"JPEG: quantization table {c.tq} not defined")
                    c.qt = quant[c.tq]
            intervals, rst, end = _entropy_data(data, pos)
            bits = _Bits(intervals, rst)
            try:
                _decode_scan(frame, scan, slots, bits, dc_tables, ac_tables, cache)
            except IndexError as e:  # read past the padding: far past the data
                raise ValueError("JPEG: corrupt data (the scan runs past its data)") from e
            if not frame.progressive:
                single = scans == 0 and n == len(frame.comps)
            scans += 1
            pos = end - 1  # back on the FF of the marker that ended the scan
        elif 0xE0 <= code <= 0xEF or code in (0xFE, 0xCC):
            pass
        else:
            raise ValueError(f"JPEG: unknown marker 0xFF{code:02X}")
    if frame is None or not scans:
        raise ValueError("JPEG: no image before EOI")
    frame.jfif, frame.adobe = jfif, adobe
    frame.space = _colour_space(frame)
    if frame.progressive and _smoothing(frame):
        raise _refuse("a progressive file whose scans leave low AC coefficients unrefined "
                      "(libjpeg's block smoothing)")
    return frame


def _decode_scan(frame: Frame, scan: _Scan, slots: list, bits: _Bits, dc_tables: dict,
                 ac_tables: dict, cache: dict) -> None:
    """One scan's tables built and its data decoded by its kind."""
    if not frame.progressive:
        if scan.ss != 0 or scan.se != 63 or scan.ah or scan.al:
            raise ValueError("JPEG: a sequential scan with a spectral band")
        scan.dc = [_huffman(dc_tables, cache, d, True) for d, _ in slots]
        scan.ac = [_huffman(ac_tables, cache, a, False) for _, a in slots]
        _decode_sequential(frame, scan, bits)
        return
    _progression(frame, scan)
    if scan.ss == 0:
        scan.dc = [None if scan.ah else _huffman(dc_tables, cache, d, True) for d, _ in slots]
        scan.ac = [None] * len(slots)
        _decode_dc(frame, scan, bits)
    else:
        scan.dc, scan.ac = [None], [_huffman(ac_tables, cache, slots[0][1], False)]
        (_decode_ac_refine if scan.ah else _decode_ac_first)(frame, scan, bits)


def app_segments(data: bytes) -> list[tuple[int, bytes]]:
    """The APPn segments before the first SOS (those PIL's parser reads),
    as (marker code, body) in file order."""
    data = bytes(data)
    out, pos = [], 2
    while True:
        code, pos = _next_marker(data, pos)
        if code in (0xDA, 0xD9):
            return out
        if 0xD0 <= code <= 0xD7 or code == 0x01:
            continue
        length = int.from_bytes(data[pos:pos + 2], "big")
        if 0xE0 <= code <= 0xEF:
            out.append((code, data[pos + 2:pos + length]))
        pos += max(length, 2)


# ---- reconstruction, vectorised -------------------------------------------------------

def _idct_pass(d: list, shift: int) -> list:
    """One 1-D pass of ``jpeg_idct_islow`` over eight int64 arrays (the
    rows or columns of many blocks), descaled by ``shift`` bits."""
    z1 = (d[2] + d[6]) * 4433
    t2 = z1 + d[6] * -15137
    t3 = z1 + d[2] * 6270
    t0 = (d[0] + d[4]) << 13
    t1 = (d[0] - d[4]) << 13
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    o0, o1, o2, o3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * 9633
    o0, o1, o2, o3 = o0 * 2446, o1 * 16819, o2 * 25172, o3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    o0 += z1 + z3
    o1 += z2 + z4
    o2 += z2 + z3
    o3 += z1 + z4
    half = 1 << (shift - 1)
    out = [t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3]
    return [(x + half) >> shift for x in out]


def _range_limit() -> np.ndarray:
    """``IDCT_range_limit``'s table over the 10 bits ``& RANGE_MASK`` keeps."""
    v = np.arange(1024)
    return np.clip(np.where(v < 512, v, v - 1024) + 128, 0, 255).astype(np.uint8)


_RANGE_LIMIT = _range_limit()


def idct_islow(blocks: np.ndarray) -> np.ndarray:
    """Dequantised coefficients ``[n, 8, 8]`` (row = vertical frequency)
    to samples ``uint8 [n, 8, 8]``, as ``jpeg_idct_islow``."""
    x = blocks.astype(np.int64)
    cols = _idct_pass([x[:, k, :] for k in range(8)], 11)  # CONST_BITS - PASS1_BITS
    work = np.stack(cols, axis=1)
    rows = _idct_pass([work[:, :, k] for k in range(8)], 18)  # CONST_BITS + PASS1_BITS + 3
    return _RANGE_LIMIT[np.stack(rows, axis=2) & 1023]


def _near(plane: np.ndarray, axis: int, step: int) -> np.ndarray:
    """The neighbour at ``step`` (±1) along ``axis``, the edge replicated."""
    n = plane.shape[axis]
    idx = np.clip(np.arange(n) + step, 0, n - 1)
    return np.take(plane, idx, axis=axis)


def _interleave(even: np.ndarray, odd: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _upsample(plane: np.ndarray, h: int, v: int, hmax: int, vmax: int) -> np.ndarray:
    """``jdsample.c`` on a batch of component planes ``[B, dh, dw]``."""
    if (h, v) == (hmax, vmax):
        return plane
    dw = plane.shape[2]
    p = plane.astype(np.int32)
    if h * 2 == hmax and v == vmax and dw > 2:  # h2v1_fancy_upsample
        left, right = _near(p, 2, -1), _near(p, 2, 1)
        out = _interleave((3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2, 2)
    elif h == hmax and v * 2 == vmax:  # h1v2_fancy_upsample
        up, down = _near(p, 1, -1), _near(p, 1, 1)
        out = _interleave((3 * p + up + 1) >> 2, (3 * p + down + 2) >> 2, 1)
    elif h * 2 == hmax and v * 2 == vmax and dw > 2:  # h2v2_fancy_upsample
        rows = []
        for far in (_near(p, 1, -1), _near(p, 1, 1)):
            s = 3 * p + far
            left, right = _near(s, 2, -1), _near(s, 2, 1)
            rows.append(_interleave((3 * s + left + 8) >> 4, (3 * s + right + 7) >> 4, 2))
        out = _interleave(rows[0], rows[1], 1)
    elif hmax % h == 0 and vmax % v == 0:  # h2v1 / h2v2 / int_upsample: replication
        return plane.repeat(vmax // v, axis=1).repeat(hmax // h, axis=2)
    else:
        raise ValueError("JPEG: fractional sampling ratios")
    return out.astype(np.uint8)


def _ycc_tables() -> tuple[np.ndarray, ...]:
    """``build_ycc_rgb_table``'s four tables (``SCALEBITS`` 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    return ((91881 * x + half) >> 16, (116130 * x + half) >> 16, -46802 * x,
            -22554 * x + half)


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def _ycc_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> list[np.ndarray]:
    """``ycc_rgb_convert`` before its range limit."""
    y = y.astype(np.int64)
    return [y + _CR_R[cr], y + ((_CB_G[cb] + _CR_G[cr]) >> 16), y + _CB_B[cb]]


def _reconstruct(frames: list[Frame]) -> np.ndarray:
    """Frames of one geometry and colour space as PIL's arrays
    ``[B, H, W(, C)]``."""
    f0 = frames[0]
    planes = []
    for k, c in enumerate(f0.comps):
        co = np.array([f.comps[k].coefs for f in frames], np.int64).astype(np.int16)
        q = np.array([f.comps[k].qt or (0,) * 64 for f in frames], np.int64).astype(np.int16)
        x = co.reshape(len(frames), -1, 64).astype(np.int64) * q[:, None, :].astype(np.int64)
        px = idct_islow(x.reshape(-1, 8, 8)).reshape(len(frames), c.bh, c.bw, 8, 8)
        plane = px.transpose(0, 1, 3, 2, 4).reshape(len(frames), c.bh * 8, c.bw * 8)
        plane = _upsample(plane[:, :c.dh, :c.dw], c.h, c.v, f0.hmax, f0.vmax)
        planes.append(plane[:, :f0.height, :f0.width])
    if f0.space == "L":
        return planes[0]
    if f0.space in ("RGB", "CMYK"):
        out = np.stack(planes, axis=-1)
        return 255 - out if f0.space == "CMYK" else out
    rgb = _ycc_rgb(*planes[:3])
    if f0.space == "YCbCr":
        return np.stack([np.clip(v, 0, 255) for v in rgb], axis=-1).astype(np.uint8)
    # YCCK: ycck_cmyk_convert gives 255 - RGB (range-limited) and K; CMYK;I inverts
    cmy = [255 - np.clip(255 - v, 0, 255) for v in rgb]
    return np.stack(cmy + [255 - planes[3].astype(np.int64)], axis=-1).astype(np.uint8)


def decode_many(blobs: list[bytes]) -> list[np.ndarray]:
    """Each JPEG's pixels as ``np.asarray(PIL.Image.open(...))`` gives
    them; the images of one geometry reconstructed as one batch."""
    frames = [parse(b) for b in blobs]
    groups: dict[tuple, list[int]] = {}
    for i, f in enumerate(frames):
        groups.setdefault(f.key(), []).append(i)
    out: list[Optional[np.ndarray]] = [None] * len(blobs)
    for idx in groups.values():
        arrays = _reconstruct([frames[i] for i in idx])
        for k, i in enumerate(idx):
            out[i] = arrays[k]
    return out  # type: ignore[return-value]


def decode(data: bytes) -> np.ndarray:
    """One JPEG's pixels (:func:`decode_many`)."""
    return decode_many([data])[0]


__all__ = ["Frame", "SOI", "app_segments", "decode", "decode_many", "idct_islow", "parse"]
