"""``TpflDataset.from_huggingface`` on local dataset directories against
the reference's ``load_dataset(directory)``: the committed Parquet
fixture (``tests/data/torch_hf_digits``, made by
``tests/make_torch_parquet_fixture.py``) with its sha256 pins and the
export's ``x`` / ``y``; each split layout ``datasets`` resolves (sharded
``data/{split}-NNNNN-of-NNNNN`` names, split keywords in file and
directory names, everything ``"train"``) with each loader (Parquet, CSV,
TSV, JSON Lines); the Hugging Face features (``ClassLabel``, sequences,
``Array2D`` / ``Array3D``, nested dicts, ``Image`` by bytes and by path);
and the refusals (Hub names, image folders, mixed loaders, features not
ported)."""

import hashlib
import json
import os

import numpy as np
import pytest

from tpfl.learning.dataset import TpflDataset as JaxDataset
from tpfl_torch.learning.dataset import RandomIIDPartitionStrategy, TpflDataset

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "torch_hf_digits")
#: sha256 of the reference loader's arrays of the fixture (printed by
#: ``tests/make_torch_parquet_fixture.py``; ``chip_smoke.py`` holds the same).
PINS = {
    "train_image": "7e1fbaba3c48c14f40b2af3a8aa1e301c10c36bda0fb11e4697da61e7e77cd69",
    "train_label": "a4df373816e684a2b5cc86a3f8eba12007a3f1ca429b2c012c2a5e80a5e7f6b8",
    "test_image": "c4d8b530f0864f97ec10ed7efca3e99b192fec41166b167dfde1e0aae0891a00",
    "test_label": "be09058cb53e757f788f7a5242d2331709c45a485f8ccb65f00a760b0d3bdcca",
}


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _assert_same_dataset(got: TpflDataset, want: JaxDataset) -> None:
    """Split names in order, column names, and every value with its type
    (images as ``np.asarray`` of the reference's decoded image)."""
    ref = want._data
    assert list(got._splits) == list(ref)
    for split in ref:
        g, w = got._splits[split], ref[split]
        assert g.column_names == list(w.column_names), split
        for name in w.column_names:
            feature = w.features[name]
            values = list(w[name])
            if type(feature).__name__ == "Image":
                for a, b in zip(g[name], values, strict=True):
                    want_px = np.asarray(b)
                    assert a.dtype == want_px.dtype and np.array_equal(a, want_px), name
                continue
            mine = g[name].tolist()
            assert len(mine) == len(values)
            for a, b in zip(mine, values):
                assert a == b and type(a) is type(b), (split, name, a, b)


def test_fixture_pins_and_reference_equal():
    got = TpflDataset.from_huggingface(FIXTURE)
    _assert_same_dataset(got, JaxDataset.from_huggingface(FIXTURE))
    for split, train in (("train", True), ("test", False)):
        part = got.get_split(train)
        assert part["image"].dtype == np.uint8 and part["image"].shape[1:] == (32, 32, 3)
        assert _sha(part["image"]) == PINS[f"{split}_image"]
        assert _sha(part["label"].astype(np.int64)) == PINS[f"{split}_label"]


def test_fixture_is_the_ports_rendered_digits():
    from make_torch_parquet_fixture import N_TEST, N_TRAIN, SEED
    from tpfl_torch.learning.dataset import rendered_color_digits

    ds = rendered_color_digits(N_TRAIN, N_TEST, seed=SEED)
    got = TpflDataset.from_huggingface(FIXTURE)
    for train in (True, False):
        x = np.rint(np.asarray(ds.get_split(train)["image"]) * 255).astype(np.uint8)
        np.testing.assert_array_equal(got.get_split(train)["image"], x)
        np.testing.assert_array_equal(got.get_split(train)["label"],
                                      ds.get_split(train)["label"])


def test_from_parquet_of_the_fixtures_train_file():
    path = os.path.join(FIXTURE, "data", "train-00000-of-00001.parquet")
    got = TpflDataset.from_parquet(path)
    _assert_same_dataset(got, JaxDataset.from_parquet(path))
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
        np.testing.assert_array_equal(g.get_split(True)["label"], np.asarray(
            w.get_split(True)["label"]))
        np.testing.assert_array_equal(g.get_split(True)["image"], np.asarray(
            w.get_split(True)["image"]))


def _write_rows(path: str, rows: list, fmt: str) -> None:
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(os.path.dirname(path), exist_ok=True)
    if fmt == "parquet":
        pq.write_table(pa.Table.from_pylist(rows), path)
    elif fmt in ("csv", "tsv"):
        sep = "," if fmt == "csv" else "\t"
        keys = list(rows[0])
        with open(path, "w") as f:
            f.write(sep.join(keys) + "\n")
            f.writelines(sep.join(str(r[k]) for k in keys) + "\n" for r in rows)
    else:
        with open(path, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)


#: Layouts: each one's files, relative to the directory (``{e}``: the format).
_LAYOUTS = {
    "sharded": ["data/train-00000-of-00002.{e}", "data/train-00001-of-00002.{e}",
                "data/validation-00000-of-00001.{e}", "data/test-00000-of-00001.{e}",
                "data/extra-00000-of-00001.{e}"],
    "names": ["train.{e}", "test.{e}", "dev.{e}", "README.md"],
    "name_keywords": ["my_train_1.{e}", "my_train_0.{e}", "set-testing.{e}", "eval_2.{e}"],
    "dirs": ["data/train/b.{e}", "data/train/a.{e}", "data/test/s0.{e}",
             "valid-2/x.{e}"],
    "flat": ["dataset.{e}", "more/part.{e}", ".hidden.{e}", "__pycache__/x.{e}",
             "dataset_infos.json"],
}


@pytest.mark.parametrize("fmt", ["parquet", "csv", "tsv", "jsonl"])
@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_split_layouts_and_loaders_match_the_reference(layout, fmt, tmp_path):
    root = tmp_path / "ds"
    for k, name in enumerate(_LAYOUTS[layout]):
        path = str(root / name.format(e=fmt))
        if name.endswith((".md", ".json")) and "{e}" not in name:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.write("# not data\n" if name.endswith(".md") else "{}")
            continue
        rows = [{"x": 10 * k + i, "s": f"r{k}-{i}", "f": (k + i) / 4} for i in range(3)]
        _write_rows(path, rows, fmt)
    got = TpflDataset.from_huggingface(str(root))
    want = JaxDataset.from_huggingface(str(root))
    _assert_same_dataset(got, want)


def test_features_of_a_dataset_directory_match_the_reference(tmp_path):
    from datasets import Array2D, Array3D, ClassLabel, Dataset, Features, Image, List, Value

    rng = np.random.default_rng(2)
    n = 6
    images = [rng.integers(0, 256, (5, 4, 3), dtype=np.uint8) for _ in range(n)]
    images[2] = rng.integers(0, 256, (3, 4, 3), dtype=np.uint8)  # ragged shapes
    feats = Features({
        "image": Image(), "label": ClassLabel(names=["a", "b", "c"]),
        "seq": List(Value("float32")), "fixed": List(Value("int64"), length=2),
        "a2": Array2D((2, 3), "int16"), "a3": Array3D((1, 2, 2), "float32"),
        "nested": {"k": Value("int64"), "tags": List(Value("string"))},
        "text": Value("string"),
    })
    data = {
        "image": images, "label": [i % 3 for i in range(n)],
        "seq": [[float(j) for j in range(i % 3)] for i in range(n)],
        "fixed": [[i, i + 1] for i in range(n)],
        "a2": [np.arange(6).reshape(2, 3) + i for i in range(n)],
        "a3": [np.full((1, 2, 2), i / 2) for i in range(n)],
        "nested": [{"k": i, "tags": ["t"] * i} for i in range(n)],
        "text": [None if i == 3 else f"w{i}" for i in range(n)],
    }
    root = tmp_path / "feat"
    Dataset.from_dict(data, features=feats).to_parquet(
        str(root / "data" / "train-00000-of-00001.parquet"))
    got = TpflDataset.from_huggingface(str(root))
    _assert_same_dataset(got, JaxDataset.from_huggingface(str(root)))
    part = got.get_split(True)
    assert part["a2"].dtype == np.int16 and part["a2"].shape == (n, 2, 3)
    assert part["image"].dtype == object  # ragged images stay one array each


def test_images_by_path_relative_to_the_file(tmp_path, monkeypatch):
    """An image stored as a relative ``path`` (no bytes) opens from the
    working directory, as the reference's ``Image`` feature opens it:
    found there, both give the same pixels; not found, both raise."""
    import io

    import pyarrow as pa
    import pyarrow.parquet as pq
    from PIL import Image

    root = tmp_path / "paths"
    (root / "data" / "img").mkdir(parents=True)
    rng = np.random.default_rng(5)
    rows = []
    for i in range(4):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (6, 6), dtype=np.uint8)).save(buf, "PNG")
        (root / "data" / "img" / f"{i}.png").write_bytes(buf.getvalue())
        rows.append({"image": {"bytes": None if i % 2 else buf.getvalue(),
                               "path": f"img/{i}.png"}, "label": i})
    meta = {"info": {"features": {"image": {"_type": "Image"},
                                  "label": {"dtype": "int64", "_type": "Value"}}}}
    table = pa.Table.from_pylist(rows).replace_schema_metadata(
        {"huggingface": json.dumps(meta)})
    path = str(root / "data" / "train-00000-of-00001.parquet")
    pq.write_table(table, path)
    monkeypatch.chdir(root / "data")
    got = TpflDataset.from_parquet(path)
    _assert_same_dataset(got, JaxDataset.from_parquet(path))
    for i in range(4):
        want = np.asarray(Image.open(root / "data" / "img" / f"{i}.png"))
        np.testing.assert_array_equal(got.get_split(True)["image"][i], want)
    monkeypatch.chdir(root)
    with pytest.raises(FileNotFoundError):
        TpflDataset.from_parquet(path)
    with pytest.raises(FileNotFoundError):
        [np.asarray(im) for im in JaxDataset.from_parquet(path)._data["train"]["image"]]


def test_refusals_name_their_roadmap_item(tmp_path):
    with pytest.raises(NotImplementedError, match="Hub download.*ROADMAP.md"):
        TpflDataset.from_huggingface("p2pfl/MNIST")
    folder = tmp_path / "folder"
    (folder / "cat").mkdir(parents=True)
    (folder / "cat" / "0.png").write_bytes(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(NotImplementedError, match="image folder.*ROADMAP.md"):
        TpflDataset.from_huggingface(str(folder))
    mixed = tmp_path / "mixed"
    _write_rows(str(mixed / "train.csv"), [{"x": 1}], "csv")
    _write_rows(str(mixed / "test.jsonl"), [{"x": 1}], "jsonl")
    with pytest.raises(NotImplementedError, match="mix loaders.*ROADMAP.md"):
        TpflDataset.from_huggingface(str(mixed))
    one = tmp_path / "one.csv"
    _write_rows(str(one), [{"x": 1}], "csv")
    with pytest.raises(FileNotFoundError):
        JaxDataset.from_huggingface(str(one))
    with pytest.raises(FileNotFoundError):
        TpflDataset.from_huggingface(str(one))
    with pytest.raises(TypeError, match="split"):
        TpflDataset.from_huggingface(str(mixed), split="train")


def test_features_not_ported_raise(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    meta = {"info": {"features": {"audio": {"sampling_rate": 16000, "_type": "Audio"}}}}
    table = pa.table({"audio": pa.array([{"bytes": b"", "path": "a.wav"}])}
                     ).replace_schema_metadata({"huggingface": json.dumps(meta)})
    path = str(tmp_path / "a.parquet")
    pq.write_table(table, path)
    with pytest.raises(NotImplementedError, match="Audio.*ROADMAP.md"):
        TpflDataset.from_parquet(path)
