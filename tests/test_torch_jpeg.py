"""The port's JPEG decoder (``tpfl_torch.learning.dataset.jpeg``) against
``np.asarray(PIL.Image.open(...))`` — PIL 12.1.0 with its libjpeg-turbo,
the decoder behind the reference's ``Image()`` feature — bit for bit:

- files PIL writes across modes ``L`` / ``RGB`` / ``CMYK`` / ``keep_rgb``,
  subsampling 4:4:4 / 4:2:2 / 4:2:0, baseline and progressive with
  ``optimize`` off and on, qualities 1-100 and custom tables, restart
  markers by blocks and by rows, sizes 1×1 to 33×65, and a Hypothesis
  property over random sizes and options;
- files ``tests/torch_jpeg_writer.py`` writes from random quantised
  coefficients, with what PIL's encoder cannot write: 4:4:0, luma 2×2
  beside a chroma component at 2×1, 4:1:1 and other integral ratios, a
  chroma plane larger than luma, one scan per component, YCCK, the colour
  space from component ids or the Adobe transform, no DHT;
- byte-edited files: fill bytes before markers, MPO's first frame, the
  refused variants (arithmetic, lossless, hierarchical, 12-bit, DNL, a
  progression libjpeg would smooth) naming the ROADMAP heading, and
  truncated or corrupt data raising ``ValueError``."""

import io
import struct

import numpy as np
import pytest

import torch_jpeg_writer as jw
from tpfl_torch.learning.dataset import jpeg

Image = pytest.importorskip("PIL.Image")

HEADING = "ROADMAP.md §1, image formats other than PNG"
SIZES = [(1, 1), (2, 3), (7, 13), (8, 8), (17, 33), (32, 32), (33, 65)]  # (height, width)
QUALITIES = [1, 50, 75, 95, 100]


def _image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A smooth gradient with noise: both flat and busy blocks."""
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 7 + yy, yy * 5, (xx + yy) * 3], axis=-1)
    return ((base + rng.integers(0, 64, (h, w, 3))) % 256).astype(np.uint8)


def _pil_jpeg(a: np.ndarray, mode: str, **options) -> bytes:
    buf = io.BytesIO()
    if mode == "keep_rgb":
        Image.fromarray(a).save(buf, "JPEG", keep_rgb=True, **options)
    else:
        Image.fromarray(a).convert(mode).save(buf, "JPEG", **options)
    return buf.getvalue()


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _assert_equal(got: np.ndarray, data: bytes) -> None:
    want = _pil(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _check(data: bytes) -> None:
    _assert_equal(jpeg.decode(data), data)


CODINGS = {"baseline": {}, "baseline_optimize": {"optimize": True},
           "progressive": {"progressive": True},
           "progressive_optimize": {"progressive": True, "optimize": True}}
GRID = [(m, s, c) for m in ("L", "RGB", "CMYK", "keep_rgb")
        for s in ("4:4:4", "4:2:2", "4:2:0") for c in CODINGS
        if not (m == "keep_rgb" and s != "4:4:4")]  # PIL keeps RGB at 4:4:4 only


@pytest.mark.parametrize("mode,subsampling,coding", GRID)
def test_pil_files_across_sizes_and_qualities(mode, subsampling, coding):
    rng = np.random.default_rng(GRID.index((mode, subsampling, coding)))
    blobs = [_pil_jpeg(_image(rng, h, w), mode, subsampling=subsampling,
                       quality=QUALITIES[k % len(QUALITIES)], **CODINGS[coding])
             for k, (h, w) in enumerate(SIZES)]
    for got, data in zip(jpeg.decode_many(blobs), blobs, strict=True):
        _assert_equal(got, data)


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("progressive", [False, True])
def test_every_quality_on_a_busy_image(quality, progressive):
    rng = np.random.default_rng(quality)
    noise = rng.integers(0, 256, (33, 65, 3), dtype=np.uint8)
    _check(_pil_jpeg(noise, "RGB", quality=quality, progressive=progressive,
                     subsampling="4:2:0"))


@pytest.mark.parametrize("tables", [
    [[1] * 64, [2] * 64], [list(range(1, 65)), [255] * 64], [[17] * 64],
    [[int(v) for v in np.random.default_rng(4).integers(1, 100, 64)]] * 2])
def test_custom_quantization_tables(tables):
    a = np.random.default_rng(9).integers(0, 256, (17, 33, 3), dtype=np.uint8)
    for progressive in (False, True):
        _check(_pil_jpeg(a, "RGB", qtables=tables, progressive=progressive, subsampling=0))


@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 1},
                                     {"restart_marker_blocks": 3},
                                     {"restart_marker_rows": 1},
                                     {"restart_marker_rows": 2}])
@pytest.mark.parametrize("coding", ["baseline", "progressive_optimize"])
def test_restart_markers(restart, coding):
    rng = np.random.default_rng(5)
    for mode, sub in (("RGB", "4:2:0"), ("RGB", "4:2:2"), ("L", "4:4:4"), ("CMYK", "4:4:4")):
        _check(_pil_jpeg(_image(rng, 33, 65), mode, subsampling=sub, **restart,
                         **CODINGS[coding]))


def test_hypothesis_random_sizes_and_options():
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    @settings(max_examples=30, deadline=None,
              suppress_health_check=[HealthCheck.function_scoped_fixture])
    @given(h=st.integers(1, 40), w=st.integers(1, 40), mode=st.sampled_from(["L", "RGB", "CMYK"]),
           subsampling=st.sampled_from(["4:4:4", "4:2:2", "4:2:0"]),
           progressive=st.booleans(), optimize=st.booleans(), quality=st.integers(1, 100),
           restart=st.integers(0, 3), seed=st.integers(0, 2**16))
    def prop(h, w, mode, subsampling, progressive, optimize, quality, restart, seed):
        options = {"restart_marker_blocks": restart} if restart else {}
        _check(_pil_jpeg(_image(np.random.default_rng(seed), h, w), mode,
                         subsampling=subsampling, progressive=progressive, optimize=optimize,
                         quality=quality, **options))

    prop()


LAYOUTS = {
    "4:4:0 (h1v2 fancy)": [(1, 2), (1, 1), (1, 1)],
    "luma 2x2, chroma 2x1 and 1x1": [(2, 2), (2, 1), (1, 1)],
    "4:2:0": [(2, 2), (1, 1), (1, 1)],
    "4:1:1 (int upsampling)": [(4, 1), (1, 1), (1, 1)],
    "luma 1x4": [(1, 4), (1, 1), (1, 1)],
    "luma 3x1": [(3, 1), (1, 1), (1, 1)],
    "luma 4x2": [(4, 2), (1, 1), (1, 1)],
    "chroma larger than luma": [(1, 1), (2, 2), (1, 1)],
    "grey at 2x2": [(2, 2)],
    "YCCK, K at 2x2": [(2, 2), (1, 1), (1, 1), (2, 2)],
}
WRITER_SIZES = [(1, 1), (2, 3), (3, 2), (7, 13), (17, 33), (40, 9)]  # (width, height)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("scans", ["interleaved", "one scan per component"])
def test_writer_sampling_layouts(layout, scans):
    rng = np.random.default_rng(list(LAYOUTS).index(layout) * 2 + (scans == "interleaved"))
    sampling = LAYOUTS[layout]
    markers = jw.adobe(2) if len(sampling) == 4 else (jw.JFIF if len(sampling) == 3 else b"")
    layout_scans = None if scans == "interleaved" else [[k] for k in range(len(sampling))]
    for k, (w, h) in enumerate(WRITER_SIZES):
        _check(jw.random_jpeg(rng, w, h, sampling, markers=markers, scans=layout_scans,
                              restart=k % 3))


@pytest.mark.parametrize("markers,ids", [
    (b"", [1, 2, 3]), (b"", [82, 71, 66]), (b"", [5, 6, 7]), (jw.adobe(0), None),
    (jw.adobe(1), None), (jw.adobe(5), None), (jw.JFIF + jw.adobe(0), None),
    (jw.adobe(0), [82, 71, 66])])
def test_colour_space_from_markers_and_ids(markers, ids):
    rng = np.random.default_rng(11)
    _check(jw.random_jpeg(rng, 9, 11, [(2, 2), (1, 1), (1, 1)], ids=ids, markers=markers))


@pytest.mark.parametrize("markers", [jw.adobe(0), jw.adobe(2), jw.adobe(1), b""])
def test_four_components_cmyk_and_ycck(markers):
    _check(jw.random_jpeg(np.random.default_rng(12), 9, 11, [(1, 1)] * 4, markers=markers))


def test_standard_tables_stand_in_without_dht():
    rng = np.random.default_rng(13)
    for sampling in ([(2, 2), (1, 1), (1, 1)], [(1, 1)]):
        _check(jw.random_jpeg(rng, 17, 9, sampling, dht=False))


def test_a_batch_of_mixed_files_equals_each_alone():
    rng = np.random.default_rng(14)
    blobs = [_pil_jpeg(_image(rng, 8 + k % 3, 9), ("L", "RGB", "CMYK")[k % 3],
                       progressive=bool(k % 2)) for k in range(12)]
    blobs += [jw.random_jpeg(rng, 9, 8 + k % 3, [(2, 2), (1, 1), (1, 1)]) for k in range(4)]
    for got, data in zip(jpeg.decode_many(blobs), blobs, strict=True):
        _assert_equal(got, data)
        np.testing.assert_array_equal(got, jpeg.decode(data))


# ---- byte-edited files -------------------------------------------------------------------

def _segments(data: bytes) -> list[tuple[int, bytes]]:
    """(marker code, its bytes from FF through its entropy-coded data)
    of every marker after SOI, in order."""
    out, pos = [], 2
    while pos < len(data):
        assert data[pos] == 0xFF
        code = data[pos + 1]
        if code == 0xD9:
            out.append((code, data[pos:pos + 2]))
            return out
        end = pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if code == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0, *range(0xD0, 0xD8))):
                end += 1
        out.append((code, data[pos:end]))
        pos = end
    raise AssertionError("no EOI")


def _join(segments: list[tuple[int, bytes]]) -> bytes:
    return b"\xff\xd8" + b"".join(s for _, s in segments)


def _baseline(**options) -> bytes:
    return _pil_jpeg(_image(np.random.default_rng(21), 17, 33), "RGB", **options)


def test_fill_bytes_before_markers_decode():
    for options in ({}, {"progressive": True, "restart_marker_blocks": 2}):
        data = _baseline(**options)
        filled = b"\xff\xd8" + b"".join(b"\xff\xff" + s for _, s in _segments(data))
        filled = filled.replace(b"\xff\xd0", b"\xff\xff\xff\xd0")  # before RST0 too
        assert filled != data
        _assert_equal(jpeg.decode(filled), filled)
        np.testing.assert_array_equal(jpeg.decode(filled), _pil(data))


def test_mpo_decodes_its_first_frame():
    rng = np.random.default_rng(22)
    first, second = (Image.fromarray(_image(rng, 16, 24)) for _ in range(2))
    buf = io.BytesIO()
    first.save(buf, "MPO", save_all=True, append_images=[second])
    data = buf.getvalue()
    im = Image.open(io.BytesIO(data))
    assert im.format == "MPO" and im.n_frames == 2
    np.testing.assert_array_equal(jpeg.decode(data), np.asarray(im))


def _with_sof(data: bytes, code: int, precision: int = 8, height=None) -> bytes:
    segs = _segments(data)
    out = []
    for c, s in segs:
        if c in (0xC0, 0xC2):
            body = bytearray(s)
            body[1], body[4] = code, precision
            if height is not None:
                body[5:7] = struct.pack(">H", height)
            s = bytes(body)
        out.append((c, s))
    return _join(out)


@pytest.mark.parametrize("code,what", [(0xC3, "lossless"), (0xC5, "hierarchical"),
                                       (0xC6, "hierarchical"), (0xC7, "hierarchical"),
                                       (0xC9, "arithmetic"), (0xCA, "arithmetic"),
                                       (0xCB, "arithmetic"), (0xCD, "arithmetic")])
def test_refused_frames_name_the_heading(code, what):
    with pytest.raises(NotImplementedError, match=f"{what}.*{HEADING}"):
        jpeg.decode(_with_sof(_baseline(), code))


def test_twelve_bit_and_dnl_refused():
    with pytest.raises(NotImplementedError, match=f"12-bit.*{HEADING}"):
        jpeg.decode(_with_sof(_baseline(), 0xC1, precision=12))
    segs = _segments(_baseline())
    k = max(i for i, (c, _) in enumerate(segs) if c == 0xDA)
    dnl = (0xDC, b"\xff\xdc\x00\x04" + struct.pack(">H", 17))
    with pytest.raises(NotImplementedError, match=f"DNL.*{HEADING}"):
        jpeg.decode(_with_sof(_join(segs[:k + 1] + [dnl] + segs[k + 1:]), 0xC0, height=0))


def test_a_progression_libjpeg_would_smooth_is_refused():
    """Only the first scans of a progressive file (the DC scan alone, or
    with the first AC bands): libjpeg smooths the blocks whose low AC
    terms stay unrefined or unknown, so the port refuses."""
    segs = _segments(_baseline(progressive=True))
    sos = [i for i, (c, _) in enumerate(segs) if c == 0xDA]
    for last in (sos[0], sos[2], sos[-2]):
        cut = _join(segs[:last + 1] + [segs[-1]])
        _pil(cut)  # PIL decodes it (smoothed)
        with pytest.raises(NotImplementedError, match=f"smoothing.*{HEADING}"):
            jpeg.decode(cut)


@pytest.mark.parametrize("options", [{}, {"progressive": True}])
def test_truncated_files_raise_value_error(options):
    data = _baseline(**options)
    for cut in (len(data) - 1, len(data) - 2, len(data) - 40, len(data) // 2, 200, 60, 4):
        with pytest.raises(OSError):
            _pil(data[:cut])
        with pytest.raises(ValueError):
            jpeg.decode(data[:cut])


def test_corrupt_data_raises_value_error():
    data = _baseline(restart_marker_blocks=1)
    lost = data.replace(b"\xff\xd1", b"\xff\xd3", 1)  # libjpeg resyncs with a warning
    with pytest.raises(ValueError, match="restart"):
        jpeg.decode(lost)
    for bad in (b"\xff\xd8\xff\xd9", b"not a jpeg", data[:2] + b"\xff\x01" + data[2:4]):
        with pytest.raises(ValueError):
            jpeg.decode(bad)
    segs = _segments(_baseline())
    sos = next(i for i, (c, _) in enumerate(segs) if c == 0xDA)
    header_len = 2 + struct.unpack(">H", segs[sos][1][2:4])[0]
    garbage = segs[sos][1][:header_len] + b"\xff\x00" * 8 + b"\xfe" * 4
    with pytest.raises(ValueError):
        jpeg.decode(_join(segs[:sos] + [(0xDA, garbage)] + segs[sos + 1:]))


def test_idct_matches_the_reference_formula_on_dc_blocks():
    """A DC-only block is flat at DC/8 + 128, rounded as libjpeg rounds."""
    blocks = np.zeros((5, 8, 8), np.int64)
    blocks[:, 0, 0] = [-1024, -4, 0, 4, 1016]
    out = jpeg.idct_islow(blocks)
    for k, dc in enumerate([-1024, -4, 0, 4, 1016]):
        want = min(255, max(0, ((dc << 2) + 16 >> 5) + 128))
        assert (out[k] == want).all(), (dc, out[k, 0, 0], want)
