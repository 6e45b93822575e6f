"""JPEG images and the EXIF orientation in the port's ``Image()`` feature
(``tpfl_torch.learning.dataset.images``) against the reference's loader
(``tpfl``'s ``TpflDataset``, through ``datasets`` and PIL 12.1.0):

- the committed JPEG fixture (``tests/data/torch_hf_jpeg_digits``, made
  by ``tests/make_torch_parquet_fixture.py --format jpeg``: a baseline
  train split and a progressive, restart-marked test split) with its
  sha256 pins, ``from_parquet``, the export and ``generate_partitions``;
- JPEG images by path, and a column that mixes PNG and JPEG rows;
- the orientation ``datasets`` applies (``ImageOps.exif_transpose``),
  values 0-9 from each source PIL reads: for PNG an ``eXIf`` chunk before
  or after IDAT in both TIFF byte orders, a ``tEXt`` keyed ``exif``, the
  ``Raw profile type exif`` text (tEXt / zTXt / iTXt) and the XMP (iTXt
  or tEXt); for JPEG the Exif APP1 in both byte orders, two Exif APP1
  (PIL joins them), the XMP APP1 (the last one wins), and Exif beside
  XMP; then odd tags and broken EXIF held to ``decode_example`` itself.
"""

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest

from test_torch_hf_local import _assert_same_dataset
from tpfl.learning.dataset import TpflDataset as JaxDataset
from tpfl_torch.learning.dataset import RandomIIDPartitionStrategy, TpflDataset, images, jpeg

Image = pytest.importorskip("PIL.Image")

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "torch_hf_jpeg_digits")
TRAIN_FILE = os.path.join(FIXTURE, "data", "train-00000-of-00001.parquet")
#: sha256 of the reference loader's arrays of the fixture (printed by
#: ``tests/make_torch_parquet_fixture.py --format jpeg``; ``chip_smoke.py``
#: holds the same).
PINS = {
    "train_image": "7f455c12dfdfc21cccdc7ec47e3d7a3c90589650fbced6ef120ac206ff5d6318",
    "train_label": "a4df373816e684a2b5cc86a3f8eba12007a3f1ca429b2c012c2a5e80a5e7f6b8",
    "test_image": "4e2d456cbc9adae5ff7ebf2b01159fb438b8a30dd7d5af21020d264d0d2d6505",
    "test_label": "be09058cb53e757f788f7a5242d2331709c45a485f8ccb65f00a760b0d3bdcca",
}


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_fixture_pins_and_reference_equal():
    got = TpflDataset.from_huggingface(FIXTURE)
    _assert_same_dataset(got, JaxDataset.from_huggingface(FIXTURE))
    for split, train in (("train", True), ("test", False)):
        part = got.get_split(train)
        assert part["image"].dtype == np.uint8 and part["image"].shape[1:] == (32, 32, 3)
        assert _sha(part["image"]) == PINS[f"{split}_image"]
        assert _sha(part["label"].astype(np.int64)) == PINS[f"{split}_label"]


def test_fixture_is_what_its_script_writes():
    """Each split's JPEG bytes are PIL's of the port's rendered digits
    under the script's options: baseline 4:2:0 for train, progressive
    4:2:2 with restart markers for test."""
    import pyarrow.parquet as pq
    from make_torch_parquet_fixture import JPEG, jpeg_bytes, quantised_digits

    digits = quantised_digits()
    for split in ("train", "test"):
        path = os.path.join(FIXTURE, "data", f"{split}-00000-of-00001.parquet")
        blobs = [row["bytes"] for row in pq.read_table(path).column("image").to_pylist()]
        x, _ = digits[split]
        assert len(blobs) == len(x)
        for k in (0, 1, len(x) - 1):
            assert blobs[k] == jpeg_bytes(x[k], JPEG[split])["bytes"]
        frame = jpeg.parse(blobs[0])
        assert frame.progressive == (split == "test")
        assert [(c.h, c.v) for c in frame.comps] == (
            [(2, 2), (1, 1), (1, 1)] if split == "train" else [(2, 1), (1, 1), (1, 1)])
        assert (b"\xff\xdd" in blobs[0]) == (split == "test")


def test_from_parquet_of_the_fixtures_train_file():
    got = TpflDataset.from_parquet(TRAIN_FILE)
    _assert_same_dataset(got, JaxDataset.from_parquet(TRAIN_FILE))
    np.testing.assert_array_equal(got.get_split(True)["image"],
                                  TpflDataset.from_huggingface(FIXTURE).get_split(True)["image"])


@pytest.mark.parametrize("kw", [{"scale": 1 / 255.0}, {}, {"flatten": True}])
def test_export_of_the_fixture_equals_the_references(kw):
    got = TpflDataset.from_huggingface(FIXTURE)
    want = JaxDataset.from_huggingface(FIXTURE)
    for train in (True, False):
        tb = got.export(batch_size=32, train=train, **kw)
        jb = want.export(batch_size=32, train=train, **kw)
        assert tb.x.dtype == jb.x.dtype and tb.y.dtype == jb.y.dtype
        np.testing.assert_array_equal(tb.x, np.asarray(jb.x))
        np.testing.assert_array_equal(tb.y, np.asarray(jb.y))


def test_partitions_of_the_fixture_equal_the_references():
    from tpfl.learning.dataset import RandomIIDPartitionStrategy as JaxIID

    got = TpflDataset.from_huggingface(FIXTURE).generate_partitions(4, RandomIIDPartitionStrategy)
    want = JaxDataset.from_huggingface(FIXTURE).generate_partitions(4, JaxIID)
    for g, w in zip(got, want, strict=True):
        for train in (True, False):
            np.testing.assert_array_equal(g.get_split(train)["label"], np.asarray(
                w.get_split(train)["label"]))
            np.testing.assert_array_equal(g.get_split(train)["image"], np.asarray(
                w.get_split(train)["image"]))


def _encode(a: np.ndarray, fmt: str, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, fmt, **options)
    return buf.getvalue()


def _write_table(path: str, rows: list) -> None:
    import pyarrow as pa
    import pyarrow.parquet as pq

    meta = {"info": {"features": {"image": {"_type": "Image"},
                                  "label": {"dtype": "int64", "_type": "Value"}}}}
    schema = pa.schema([("image", pa.struct([("bytes", pa.binary()), ("path", pa.string())])),
                        ("label", pa.int64())], metadata={"huggingface": json.dumps(meta)})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pq.write_table(pa.Table.from_pylist(rows, schema=schema), path)


def test_jpeg_images_by_path(tmp_path, monkeypatch):
    root = tmp_path / "paths"
    (root / "data" / "img").mkdir(parents=True)
    rng = np.random.default_rng(5)
    rows = []
    for i in range(4):
        data = _encode(rng.integers(0, 256, (6, 9, 3), dtype=np.uint8), "JPEG",
                       progressive=bool(i % 2))
        (root / "data" / "img" / f"{i}.jpg").write_bytes(data)
        rows.append({"image": {"bytes": None if i % 2 else data, "path": f"img/{i}.jpg"},
                     "label": i})
    path = str(root / "data" / "train-00000-of-00001.parquet")
    _write_table(path, rows)
    monkeypatch.chdir(root / "data")
    got = TpflDataset.from_parquet(path)
    _assert_same_dataset(got, JaxDataset.from_parquet(path))
    assert got.get_split(True)["image"].shape == (4, 6, 9, 3)


def test_a_column_mixing_png_and_jpeg_rows(tmp_path):
    rng = np.random.default_rng(6)
    rows = []
    for i in range(6):
        a = rng.integers(0, 256, (7, 5, 3), dtype=np.uint8)
        rows.append({"image": {"bytes": _encode(a, "PNG" if i % 2 else "JPEG"), "path": None},
                     "label": i})
    rows.append({"image": {"bytes": _encode(rng.integers(0, 256, (7, 5), dtype=np.uint8),
                                            "JPEG"), "path": None}, "label": 6})
    path = str(tmp_path / "mixed" / "data" / "train-00000-of-00001.parquet")
    _write_table(path, rows[:6])
    got = TpflDataset.from_parquet(path)
    _assert_same_dataset(got, JaxDataset.from_parquet(path))
    assert got.get_split(True)["image"].dtype == np.uint8  # one shape: stacked
    _write_table(path, rows)
    got = TpflDataset.from_parquet(path)
    _assert_same_dataset(got, JaxDataset.from_parquet(path))
    assert got.get_split(True)["image"].dtype == object  # a grey row: one array each


# ---- orientation ----------------------------------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I",
                                                                     zlib.crc32(kind + body))


def _tiff(value, endian: str = "<", typ: int = 3, count: int = 1) -> bytes:
    """A TIFF header and IFD0 holding only Orientation (``typ`` its field
    type; out-of-line values follow the IFD)."""
    head = (b"II*\x00" if endian == "<" else b"MM\x00*") + struct.pack(endian + "L", 8)
    fmt = {1: "B", 3: "H", 4: "L", 5: "LL", 7: "B", 11: "f", 12: "d"}[typ]
    payload = struct.pack(endian + fmt, *(value if isinstance(value, tuple) else (value,)))
    payload *= count
    if len(payload) <= 4:
        field, extra = payload.ljust(4, b"\x00"), b""
    else:
        field, extra = struct.pack(endian + "L", 8 + 2 + 12 + 4), payload
    return (head + struct.pack(endian + "H", 1) + struct.pack(endian + "HHL", 0x0112, typ, count)
            + field + struct.pack(endian + "L", 0) + extra)


def _xmp(value: int, element: bool = False) -> bytes:
    if element:
        return b"<x:xmpmeta><tiff:Orientation>%d</tiff:Orientation></x:xmpmeta>" % value
    return (b'<x:xmpmeta xmlns:x="adobe:ns:meta/"><rdf:RDF><rdf:Description '
            b'tiff:Orientation="%d"/></rdf:RDF></x:xmpmeta>' % value)


def _raw_profile(tiff: bytes) -> bytes:
    return b"\nexif\n" + str(len(tiff)).encode() + b"\n" + tiff.hex().encode()


def _png(a: np.ndarray, before: bytes = b"", after: bytes = b"") -> bytes:
    """PIL's PNG of ``a`` with chunks spliced in before IDAT and before IEND."""
    data = _encode(a, "PNG")
    idat, iend = data.index(b"IDAT") - 4, data.index(b"IEND") - 4
    return data[:idat] + before + data[idat:iend] + after + data[iend:]


def _jpeg(a: np.ndarray, *segments: bytes, **options) -> bytes:
    """PIL's JPEG of ``a`` with APP segments spliced in after SOI."""
    data = _encode(a, "JPEG", **options)
    return data[:2] + b"".join(segments) + data[2:]


def _app(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", 2 + len(body)) + body


_XAPP = b"http://ns.adobe.com/xap/1.0/\x00"
_EXIF = b"Exif\x00\x00"
SOURCES = {
    "png eXIf before IDAT, II": lambda a, o: _png(a, _chunk(b"eXIf", _tiff(o))),
    "png eXIf after IDAT, MM": lambda a, o: _png(a, after=_chunk(b"eXIf", _tiff(o, ">"))),
    "png tEXt exif": lambda a, o: _png(a, _chunk(b"tEXt", b"exif\x00Exif\x00\x00" + _tiff(o))),
    "png raw profile tEXt": lambda a, o: _png(a, _chunk(
        b"tEXt", b"Raw profile type exif\x00" + _raw_profile(_tiff(o, ">")))),
    "png raw profile zTXt after IDAT": lambda a, o: _png(a, after=_chunk(
        b"zTXt", b"Raw profile type exif\x00\x00" + zlib.compress(_raw_profile(_tiff(o))))),
    "png raw profile iTXt": lambda a, o: _png(a, _chunk(
        b"iTXt", b"Raw profile type exif\x00\x00\x00\x00\x00" + _raw_profile(_tiff(o)))),
    "png XMP iTXt": lambda a, o: _png(a, _chunk(
        b"iTXt", b"XML:com.adobe.xmp\x00\x00\x00\x00\x00" + _xmp(o))),
    "png XMP iTXt compressed, after IDAT": lambda a, o: _png(a, after=_chunk(
        b"iTXt", b"XML:com.adobe.xmp\x00\x01\x00\x00\x00" + zlib.compress(_xmp(o, True)))),
    "png XMP tEXt": lambda a, o: _png(a, _chunk(b"tEXt", b"XML:com.adobe.xmp\x00" + _xmp(o))),
    "jpeg Exif II": lambda a, o: _jpeg(a, exif=_EXIF + _tiff(o)),
    "jpeg Exif MM, progressive": lambda a, o: _jpeg(a, exif=_EXIF + _tiff(o, ">"),
                                                    progressive=True),
    "jpeg two Exif APP1": lambda a, o: _jpeg(
        a, _app(0xE1, b"Exif\x00\x00" + _tiff(o)[:10]),
        _app(0xE1, b"Exif\x00\x00" + _tiff(o)[10:])),
    "jpeg XMP, the last wins": lambda a, o: _jpeg(
        a, _app(0xE1, _XAPP + _xmp(9 - o if o else 5)), _app(0xE1, _XAPP + _xmp(o, True))),
    "jpeg Exif beside XMP": lambda a, o: _jpeg(a, _app(0xE1, _XAPP + _xmp(3)),
                                               exif=_EXIF + _tiff(o)),
    "jpeg grey XMP": lambda a, o: _jpeg(a[..., 0], xmp=_xmp(o)),
}


def _directory(tmp_path, blobs: list[bytes]) -> str:
    from datasets import Dataset, Features, Value
    from datasets import Image as HFImage

    root = tmp_path / "oriented"
    Dataset.from_dict({"image": [{"bytes": b, "path": None} for b in blobs],
                       "label": list(range(len(blobs)))},
                      features=Features({"image": HFImage(), "label": Value("int64")})
                      ).to_parquet(str(root / "data" / "train-00000-of-00001.parquet"))
    return str(root)


@pytest.mark.parametrize("source", list(SOURCES))
def test_orientation_from_each_source_matches_the_reference(source, tmp_path):
    """Orientations 0-9 of a 6×10 image (1-8 are PIL's, 0 and 9 none),
    through ``from_huggingface`` of a directory ``datasets`` wrote."""
    a = np.random.default_rng(7).integers(0, 256, (6, 10, 3), dtype=np.uint8)
    blobs = [SOURCES[source](a, o) for o in range(10)]
    root = _directory(tmp_path, blobs)
    got = TpflDataset.from_huggingface(root)
    _assert_same_dataset(got, JaxDataset.from_huggingface(root))
    shapes = [im.shape[:2] for im in got.get_split(True)["image"]]
    assert shapes[6] == shapes[8] == (10, 6) and shapes[1] == shapes[3] == (6, 10)


def _reference(data: bytes):
    from datasets import Image as HFImage

    try:
        return np.asarray(HFImage().decode_example({"bytes": data, "path": None}))
    except Exception as e:  # noqa: BLE001 - the reference's failure, of any type
        return type(e)


EDGES = {
    "SHORT count 2": lambda a: _png(a, _chunk(b"eXIf", _tiff(6, count=2))),
    "LONG": lambda a: _png(a, _chunk(b"eXIf", _tiff(8, typ=4))),
    "RATIONAL 12/2": lambda a: _png(a, _chunk(b"eXIf", _tiff((12, 2), typ=5))),
    "RATIONAL 7/2": lambda a: _png(a, _chunk(b"eXIf", _tiff((7, 2), typ=5))),
    "RATIONAL x/0": lambda a: _png(a, _chunk(b"eXIf", _tiff((6, 0), typ=5))),
    "FLOAT 6.0": lambda a: _png(a, _chunk(b"eXIf", _tiff(6.0, typ=11))),
    "DOUBLE 5.5": lambda a: _png(a, _chunk(b"eXIf", _tiff(5.5, typ=12))),
    "BYTE": lambda a: _png(a, _chunk(b"eXIf", _tiff(6, typ=1))),
    "UNDEFINED beside XMP": lambda a: _png(a, _chunk(b"eXIf", _tiff(6, typ=7)) + _chunk(
        b"iTXt", b"XML:com.adobe.xmp\x00\x00\x00\x00\x00" + _xmp(8))),
    "EXIF without the tag, XMP": lambda a: _png(a, _chunk(b"eXIf", _tiff(6)[:8] + b"\x00\x00")
                                                + _chunk(b"tEXt", b"XML:com.adobe.xmp\x00"
                                                         + _xmp(3))),
    "truncated IFD": lambda a: _png(a, _chunk(b"eXIf", _tiff(6)[:16])),
    "png bad TIFF header": lambda a: _png(a, _chunk(b"eXIf", b"XX*\x00\x08\x00\x00\x00")),
    "png raw profile not hex": lambda a: _png(a, _chunk(
        b"tEXt", b"Raw profile type exif\x00\nexif\n4\nzz")),
    "png zTXt exif": lambda a: _png(a, _chunk(b"zTXt", b"exif\x00\x00" + zlib.compress(b"x"))),
    "png empty XMP text, iTXt bytes": lambda a: _png(a, _chunk(
        b"iTXt", b"XML:com.adobe.xmp\x00\x00\x00\x00\x00" + _xmp(6) + b"\xff") + _chunk(
        b"tEXt", b"XML:com.adobe.xmp\x00")),
    "jpeg bad TIFF header, no dpi": lambda a: _jpeg(a, _app(0xE1, b"Exif\x00\x00XX*\x00"),
                                                    _app(0xE1, _XAPP + _xmp(6))),
    "jpeg bad TIFF header, JFIF dpi": lambda a: _jpeg(
        a, _app(0xE1, b"Exif\x00\x00XX*\x00"), dpi=(72, 72)),
    "jpeg Exif in dpi file": lambda a: _jpeg(a, exif=_EXIF + _tiff(5), dpi=(300, 300)),
}


@pytest.mark.parametrize("case", list(EDGES))
def test_orientation_edge_cases_against_decode_example(case):
    a = np.random.default_rng(8).integers(0, 256, (4, 7, 3), dtype=np.uint8)
    data = EDGES[case](a)
    want = _reference(data)
    if isinstance(want, type):
        with pytest.raises(ValueError):
            images.decode_many([data])
        return
    got = images.decode_many([data])[0]
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_other_formats_refused_naming_them():
    a = np.zeros((4, 4, 3), np.uint8)
    for fmt in ("GIF", "BMP", "WEBP", "TIFF", "ICO"):
        with pytest.raises(NotImplementedError, match=f"{fmt}.*only PNG and JPEG.*ROADMAP.md"):
            images.decode_many([_encode(a, fmt)])
