"""The port's PNG decoder (``tpfl_torch.learning.dataset.png``) against
``np.asarray(PIL.Image.open(...))``, the array the reference's ``Image()``
feature gives its export: every colour type and bit depth PIL opens, each
of the five filters (a small encoder here writes rows with chosen filter
types), Adam7 interlacing, tRNS and palettes; PNGs PIL writes itself; a
batch of mixed shapes decoded in one call; corrupt files and other
formats refused."""

import io
import struct
import zlib

import numpy as np
import pytest

from tpfl_torch.learning.dataset import png

Image = pytest.importorskip("PIL.Image")

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))
_COMBOS = [(c, d) for c, ds in {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
                                 4: (8, 16), 6: (8, 16)}.items() for d in ds]


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def _filter_row(line: np.ndarray, prior: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    """The filter ``kind`` applied to one row of bytes (the spec's forward
    direction, one byte at a time)."""
    x = line.astype(np.int64)
    b = prior.astype(np.int64)
    out = np.zeros_like(x)
    for i in range(len(x)):
        a = x[i - bpp] if i >= bpp else 0
        c = b[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b[i]
        elif kind == 3:
            pred = (a + b[i]) // 2
        else:
            p = a + b[i] - c
            pa, pb, pc = abs(p - a), abs(p - b[i]), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b[i] if pb <= pc else c)
        out[i] = (x[i] - pred) % 256
    return out.astype(np.uint8)


def _rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """Samples ``[h, w, channels]`` packed into row bytes."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, -1)
    return np.packbits(bits.astype(np.uint8), axis=1)


def _encode(samples: np.ndarray, colour: int, depth: int, filters, interlace: bool = False,
            palette: int = 0, trns: bytes = b"", rng=None) -> bytes:
    h, w = samples.shape[:2]
    bpp = max(1, _CHANNELS[colour] * depth // 8)
    passes = ([(x0, y0, dx, dy) for x0, y0, dx, dy in _ADAM7] if interlace
              else [(0, 0, 1, 1)])
    raw = bytearray()
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _rows(sub, depth)
        prior = np.zeros(rows.shape[1], np.uint8)
        for y, line in enumerate(rows):
            kind = int(rng.choice(filters)) if rng is not None else filters[y % len(filters)]
            raw.append(kind)
            raw += _filter_row(line, prior, kind, bpp).tobytes()
            prior = line
    out = png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0,
                                                      int(interlace)))
    if palette:
        out += _chunk(b"PLTE", bytes(range(palette * 3)))
    if trns:
        out += _chunk(b"tRNS", trns)
    data = zlib.compress(bytes(raw), 6)
    out += _chunk(b"IDAT", data[:len(data) // 2]) + _chunk(b"IDAT", data[len(data) // 2:])
    return out + _chunk(b"IEND", b"")


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _random_samples(rng, h, w, colour, depth):
    top = 2 ** depth if colour != 3 else min(2 ** depth, 7)
    return rng.integers(0, top, (h, w, _CHANNELS[colour]), dtype=np.int64)


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("colour,depth", _COMBOS)
def test_colour_types_depths_and_filters_match_pil(colour, depth, interlace):
    rng = np.random.default_rng(colour * 100 + depth)
    samples = _random_samples(rng, 13, 11, colour, depth)
    trns = {0: struct.pack(">H", 1), 2: struct.pack(">HHH", 1, 2, 3), 3: b"\x00\x80"}.get(
        colour, b"")
    data = _encode(samples, colour, depth, [0, 1, 2, 3, 4], interlace,
                   palette=7 if colour == 3 else 0, trns=trns, rng=rng)
    want = _pil(data)
    got = png.decode(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_each_filter_alone_matches_pil(kind):
    rng = np.random.default_rng(kind)
    for colour, depth in ((2, 8), (6, 16), (0, 4)):
        data = _encode(_random_samples(rng, 9, 17, colour, depth), colour, depth, [kind])
        np.testing.assert_array_equal(png.decode(data), _pil(data))


@pytest.mark.parametrize("mode", ["1", "L", "I;16", "RGB", "RGBA", "LA", "P", "P4"])
def test_files_pil_writes_decode_to_pil_arrays(mode):
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (21, 19, 3), dtype=np.uint8)
    base = Image.fromarray(rgb)
    img = {"1": lambda: base.convert("1"), "L": lambda: base.convert("L"),
           "I;16": lambda: Image.fromarray((rgb[..., 0].astype(np.uint16) * 257)),
           "RGB": lambda: base, "RGBA": lambda: base.convert("RGBA"),
           "LA": lambda: base.convert("LA"), "P": lambda: base.convert("P"),
           "P4": lambda: base.quantize(16)}[mode]()
    buf = io.BytesIO()
    img.save(buf, "PNG", **({"bits": 4} if mode == "P4" else {}))
    data = buf.getvalue()
    np.testing.assert_array_equal(png.decode(data), _pil(data))


def test_batch_of_mixed_shapes_in_one_call():
    """Images of several shapes and types in one call: each equals PIL's,
    in the order given."""
    rng = np.random.default_rng(11)
    blobs = []
    for k in range(30):
        colour, depth = _COMBOS[k % len(_COMBOS)]
        h, w = 5 + k % 3, 4 + k % 4
        blobs.append(_encode(_random_samples(rng, h, w, colour, depth), colour, depth,
                             [0, 1, 2, 3, 4], interlace=bool(k % 2),
                             palette=7 if colour == 3 else 0, rng=rng))
    for got, data in zip(png.decode_many(blobs), blobs, strict=True):
        np.testing.assert_array_equal(got, _pil(data))


def test_other_formats_refused_naming_them():
    for data, name in ((b"\xff\xd8\xff\xe0" + bytes(20), "JPEG"), (b"GIF89a" + bytes(10), "GIF"),
                       (b"BM" + bytes(30), "BMP"), (b"RIFF\0\0\0\0WEBPVP8 ", "WEBP")):
        with pytest.raises(NotImplementedError, match=f"{name}.*ROADMAP.md"):
            png.decode(data)


def test_corrupt_pngs_raise():
    rng = np.random.default_rng(3)
    good = _encode(_random_samples(rng, 6, 6, 2, 8), 2, 8, [4])
    bad_crc = bytearray(good)
    bad_crc[20] ^= 1
    bad_filter = _encode(_random_samples(rng, 6, 6, 2, 8), 2, 8, [0])
    raw = bytearray(zlib.decompress(png.read_header(bad_filter).idat))
    raw[0] = 9
    bad_filter = (png.SIGNATURE + good[8:33] + _chunk(b"IDAT", zlib.compress(bytes(raw)))
                  + _chunk(b"IEND", b""))
    for data in (bytes(bad_crc), good[:-20], bad_filter, good[:8] + good[33:]):
        with pytest.raises(ValueError):
            png.decode(data)
