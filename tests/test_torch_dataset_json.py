"""``TpflDataset.from_json`` against the reference's loader
(``load_dataset("json", ...)``), floats bit for bit: a top-level array and
the records under ``field`` go through pandas' ujson at 10 decimals, JSON
Lines parse exactly."""

import json
import math

import numpy as np
import pytest

from tpfl.learning.dataset.tpfl_dataset import TpflDataset as JaxDataset
from tpfl_torch.learning.dataset.tpfl_dataset import (
    TpflDataset,
    _ujson_dumps_float,
    _ujson_float,
)


def _seeded_floats(seed: int = 0) -> list[float]:
    """Floats across magnitudes 1e-12 to 1e15 with their negatives (each
    with more than 10 decimals in its repr), ints written as floats, and
    the encoder's edges: halves at the 10th decimal, the thresholds of
    its exponent form, subnormals and the largest doubles."""
    rng = np.random.default_rng(seed)
    vals = []
    for e in range(-12, 16):
        m = rng.uniform(1.0, 10.0, 40) * 10.0 ** e
        vals += [float(v) for v in m] + [-float(v) for v in m]
    vals += [float(v) for v in rng.integers(-10**9, 10**9, 40)]
    vals += [0.1 + 0.2, 2.5e-10, 5e-11, 1.5e-10, 0.99999999995, 1e-15, 1.5e-16, 1e16, 3e16,
             9999999999999998.0, 123456789.123456789, -0.0, 0.0, 5e-324, 2.2250738585072014e-308,
             1.7976931348623157e308, -1.5e308]
    return vals


def _bits(col) -> np.ndarray:
    return np.asarray(col, dtype=np.float64).view(np.int64)


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("layout", ["array", "field", "jsonl"])
def test_floats_bit_equal_to_the_reference_loader(layout, tmp_path):
    vals = _seeded_floats()
    rows = [{"f": v, "n": [v, 1.0], "i": k} for k, v in enumerate(vals)]
    text, kwargs = {
        "array": (json.dumps(rows), {}),
        "field": (json.dumps({"meta": 1, "data": rows}), {"field": "data"}),
        "jsonl": ("".join(json.dumps(r) + "\n" for r in rows), {}),
    }[layout]
    path = _write(tmp_path, "d.json", text)
    want = JaxDataset.from_json(path, **kwargs).get_split(True)
    got = TpflDataset.from_json(path, **kwargs).get_split(True)
    assert got.column_names == want.column_names == ["f", "n", "i"]
    np.testing.assert_array_equal(_bits(got["f"]), _bits(want["f"]))
    np.testing.assert_array_equal(_bits(np.stack(got["n"])), _bits(np.asarray(want["n"])))
    assert got["i"].dtype == np.int64 and got["i"].tolist() == list(want["i"])
    rounded = int((_bits(got["f"]) != _bits(vals)).sum())
    if layout == "jsonl":
        assert rounded == 0  # exact
    else:
        assert rounded > len(vals) // 2  # the 10-decimal rounding is real


@pytest.mark.parametrize("layout", ["array", "field"])
def test_ints_written_as_floats_typed_as_the_reference(layout, tmp_path):
    """Whole floats stay float64 in an array (pyarrow) and become int64
    under ``field`` (pandas' ``read_json``); a column mixing ints and
    whole floats too; a fraction, or a whole float beyond int64, keeps
    float64. (A missing value is not held here: the reference types an
    int column with a missing value int64 with None, which a numpy
    column cannot hold; ``ROADMAP.md`` §3.)"""
    rows = [{"w": float(k), "m": k if k % 2 else float(k), "h": k + 0.5,
             "b": 2.0 ** 62 * (k + 1)} for k in range(6)]
    text = json.dumps({"data": rows}) if layout == "field" else json.dumps(rows)
    kwargs = {"field": "data"} if layout == "field" else {}
    path = _write(tmp_path, "w.json", text)
    want = JaxDataset.from_json(path, **kwargs).get_split(True)
    got = TpflDataset.from_json(path, **kwargs).get_split(True)
    for name, feature in want.features.items():
        assert str(got[name].dtype) == feature.dtype, (name, got[name].dtype, feature)
        for a, b in zip(got[name].tolist(), list(want[name]), strict=True):
            assert a == b and type(a) is type(b), (name, a, b)


def test_array_after_blanks_raises_as_the_reference(tmp_path):
    path = _write(tmp_path, "b.json", "\n  " + json.dumps([{"f": 0.5}]))
    with pytest.raises(Exception):
        JaxDataset.from_json(path)
    with pytest.raises(ValueError, match="must start the file"):
        TpflDataset.from_json(path)


def test_ujson_number_helpers_match_pandas():
    """The two helpers alone against pandas' own ``ujson_loads`` /
    ``ujson_dumps`` on the seeded set and its reprs."""
    import pandas as pd

    for v in _seeded_floats(seed=1):
        text = repr(v) if "e" in repr(v) or "." in repr(v) else repr(v) + ".0"
        assert _ujson_dumps_float(v) == pd.io.json.ujson_dumps(v), v
        got, want = _ujson_float(text), pd.io.json.ujson_loads(text)
        assert math.copysign(1.0, got) == math.copysign(1.0, want) and got == want, text
