"""``TpflDataset.from_json`` against the reference's loader
(``load_dataset("json", ...)``), floats bit for bit: a top-level array and
the records under ``field`` go through pandas' ujson at 10 decimals, JSON
Lines parse exactly. Column types as the loader's two readers give them:
a number column with a missing value (int64 or float64 with ``None``) and
ISO 8601 strings as timestamps (pyarrow's ``timestamp[s]`` in JSON Lines
and arrays, pandas' ``timestamp[us]`` under ``field`` in a date-like
column name), each value with its Python type."""

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
    float64."""
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


#: The port's numpy dtype of each Hugging Face feature dtype.
_FEATURE_DTYPES = {"timestamp[s]": "datetime64[s]", "timestamp[ms]": "datetime64[ms]",
                   "timestamp[us]": "datetime64[us]", "int64": "int64", "float64": "float64"}


def _assert_typed_as_the_reference(got, want):
    """Every column: the feature's dtype (a string column as str, or
    object beside a missing value) and every value with its Python type."""
    assert got.column_names == want.column_names
    for name, feature in want.features.items():
        col = got[name]
        if feature.dtype == "string":
            assert col.dtype.kind in "UO", (name, col.dtype)
        else:
            assert str(col.dtype) == _FEATURE_DTYPES[feature.dtype], (name, col.dtype, feature)
        for a, b in zip(col.tolist(), list(want[name]), strict=True):
            assert a == b and type(a) is type(b), (name, a, b)


def _write_rows(tmp_path, layout, columns):
    n = len(next(iter(columns.values())))
    rows = [{k: v[i] for k, v in columns.items()} for i in range(n)]
    text, kwargs = {
        "array": (json.dumps(rows), {}),
        "field": (json.dumps({"meta": 1, "data": rows}), {"field": "data"}),
        "jsonl": ("".join(json.dumps(r) + "\n" for r in rows), {}),
    }[layout]
    return _write(tmp_path, f"{layout}.json", text), kwargs


@pytest.mark.parametrize("layout", ["array", "field", "jsonl"])
def test_missing_numbers_typed_as_the_reference(layout, tmp_path):
    """An int column with a missing value is int64 with ``None`` in every
    layout; a float column float64 with ``None``; whole floats beside a
    missing value int64 under ``field`` only; a date-like name under
    ``field`` reads integers all above a year of seconds as epoch times,
    in the first unit that fits, and an all-missing column as
    ``timestamp[s]``."""
    columns = {"i": [1, None, 3], "j": [None, 2, -7], "f": [1.5, None, 0.25],
               "w": [1.0, None, 2.0], "m": [1, 2.5, None], "n": [2**62, None, 1],
               "seen_at": [1700000000, None, 1700000001], "t_time": [1700000000000, 1, None],
               "timestamp_ms": [1700000000123, 1700000000000, None],
               "small_at": [1, None, 5]}
    if layout == "field":
        columns["updated_at"] = [None, None, None]  # elsewhere the reference's "null" type
    path, kwargs = _write_rows(tmp_path, layout, columns)
    want = JaxDataset.from_json(path, **kwargs).get_split(True)
    got = TpflDataset.from_json(path, **kwargs).get_split(True)
    assert want.features["i"].dtype == "int64" and list(want["i"]) == [1, None, 3]
    _assert_typed_as_the_reference(got, want)


#: ISO 8601 and near-miss strings. The reference's pyarrow reader (JSON
#: Lines, arrays) takes second-precision forms with an optional zone and
#: leaves the rest strings; pandas' reader (``field``) takes, in a
#: date-like column only, forms with one-digit fields, blanks, a ``t``,
#: compact times and up to six fraction digits.
_STAMP_FORMS = [
    "2024-01-02", "2024-01-02 03:04:05", "2024-01-02T03:04:05", "2024-01-02T03:04",
    "2024-01-02T03", "2024-01-02 03:04", "2024-01-02 03", "2024-02-29", "1970-01-01",
    "1900-01-01", "9999-12-31", "0001-01-01", "2024-01-02T03:04:05.123",
    "2024-01-02 03:04:05.5", "2024-01-02T03:04:05.000", "2024-01-02T03:04:05,5",
    "2024-01-02T03:04:05.123456", "2024-1-2", "2024-01", " 2024-01-02",
    "2024-01-02t03:04:05", "2024-01-02T0304", "2024-13-01", "2024-02-30", "2023-02-29",
    "2024-01-02T24:00:00", "2024-01-02T03:04:60", "+2024-01-02", "2024-001", "2024-W01-1",
    "2024-01-02Z", "hello",
]

#: Forms with a zone: pyarrow moves them to UTC; under ``field`` they
#: stay out of date-like columns (pandas makes them zone-aware).
_ZONED_FORMS = ["2024-01-02T03:04:05Z", "2024-01-02T03:04:05+01:00",
                "2024-01-02T03:04:05-0100", "2024-01-02T03:04:05+01"]


@pytest.mark.parametrize("layout", ["array", "field", "jsonl"])
def test_timestamps_typed_as_the_reference(layout, tmp_path):
    """Each string form in a column of its own beside a missing value,
    under a plain name and a date-like one (``_at``), plus columns that
    mix forms, or a date and a non-date: ``timestamp[s]`` in JSON Lines
    and arrays, ``timestamp[us]`` under ``field`` in date-like names
    only, strings where the reference leaves strings."""
    columns = {}
    for k, form in enumerate(_STAMP_FORMS + (_ZONED_FORMS if layout != "field" else [])):
        columns[f"c{k}"] = [form, None, form]
        columns[f"c{k}_at"] = [None, form, form]
    for k, form in enumerate(_ZONED_FORMS if layout == "field" else []):
        columns[f"z{k}"] = [form, None, form]
    columns.update({"mixed": ["2024-01-02", "2024-01-02 03:04:05", "2024-01-02T03:04:06"],
                    "mixed_at": ["2024-01-02", None, "2024-01-02 03:04:05.25"],
                    "hello_at": ["2024-01-02", "hello", None], "date": ["2024-01-02"] * 3,
                    "epoch_time": ["1700000000", "1700000001", "1700000002"]})
    path, kwargs = _write_rows(tmp_path, layout, columns)
    want = JaxDataset.from_json(path, **kwargs).get_split(True)
    got = TpflDataset.from_json(path, **kwargs).get_split(True)
    kinds = {f.dtype for f in want.features.values()}
    assert {"timestamp[s]" if layout != "field" else "timestamp[us]", "string"} <= kinds
    _assert_typed_as_the_reference(got, want)


#: Values of a date-like column under ``field`` that pandas' ``read_json``
#: converts through ``to_datetime``'s three formats (a guessed one, ISO
#: 8601, each value alone), or leaves as strings where all three fail.
_FIELD_DATE_CASES = {
    "month_names": ["Jan 2 2024", "Feb 3 2024"],
    "month_first": ["02/01/2024", "03/01/2024"],
    "day_first_past_12": ["13/01/2024", "14/01/2024"],
    "guess_then_each_value": ["02/01/2024", "13/01/2024"],
    "year_beside_missing": ["2024", None],
    "years_only": ["2024", "2025"],
    "zone_offset": ["2024-01-02T03:04:05+02:00", "2024-01-02T04:05:06+02:00"],
    "zone_utc": ["2024-01-02T03:04:05Z", None],
    "zone_utc_name": ["2024-01-02T03:04:05 UTC", None],
    "zone_gmt_literal": ["2024-01-02T03:04:05 GMT", None],
    "zone_guessed_offset": ["Jan 2 2024 10:00 +0200", "Feb 2 2024 11:00 +0200"],
    "mixed_offsets": ["2024-01-02T03:04:05+02:00", "2024-01-02T03:04:05+03:00"],
    "naive_and_zoned": ["2024-01-02T03:04:05", "2024-01-02T03:04:05+01:00"],
    "nanoseconds": ["2024-01-02T03:04:05.123456789", "2024-01-02T03:04:05.1"],
    "epoch_floats": [1.7e9, 1.8e9],
    "epoch_float_missing": [1.7e12, None],
    "epoch_fractions": [1700000000.5, 1800000000.0],
    "epoch_ns_range": [1e18, 2e18],
    "float_below_a_year": [1.5, 1.8e9],
    "iso_then_words": ["2024-01-02", "Jan 3 2024"],
    "unparseable_first": ["hello", "2024-01-02"],
    "unparseable_later": ["2024-01-02", "hello"],
    "weekday_words": ["Tuesday, January 2, 2024", None],
    "compact_digits": ["20240102", None],
    "small_number": ["12", None],
    "epoch_text_beside_missing": ["1700000000", None],
    "nat_strings": ["NaT", "2024-01-02"],
    "empty_string": ["", None],
    "two_digit_year": ["01/02/24", None],
    "meridiem": ["2024-01-02 3pm", "5 May 2024 10:11:12.5 PM"],
    "quarters": ["1Q24", "2Q2024"],
    "invalid_day": ["2024-02-30", None],
}


@pytest.mark.parametrize("case", sorted(_FIELD_DATE_CASES))
def test_field_dates_typed_as_pandas_read_json(case, tmp_path):
    """Each case in a date-like column (``created_at``) beside an int
    column, under ``field``: the reference's feature and every value with
    its Python type, a zone-aware value with its offset. The reference's
    nanosecond ``pandas.Timestamp`` cannot be made without pandas: the
    port keeps ``datetime64[ns]``, held here to the instant."""
    values = _FIELD_DATE_CASES[case]
    rows = [{"created_at": v, "n": i} for i, v in enumerate(values)]
    path = _write(tmp_path, "d.json", json.dumps({"data": rows}))
    want = JaxDataset.from_json(path, field="data").get_split(True)
    got = TpflDataset.from_json(path, field="data").get_split(True)
    assert got.column_names == want.column_names
    feature = want.features["created_at"].dtype
    col = got["created_at"]
    if feature.startswith("timestamp[ns"):
        assert str(col.dtype) == "datetime64[ns]"
        for a, b in zip(col.tolist(), list(want["created_at"]), strict=True):
            assert (a is None and b is None) or a == b.value, (a, b)
        return
    for a, b in zip(col.tolist(), list(want["created_at"]), strict=True):
        assert a == b and type(a) is type(b), (case, a, b)
        if b is not None and hasattr(b, "utcoffset"):
            assert a.utcoffset() == b.utcoffset(), (case, a, b)
    if feature == "string":
        assert col.dtype.kind in "UO"
    elif "tz=" not in feature:
        assert str(col.dtype) == _FEATURE_DTYPES.get(feature, feature), (feature, col.dtype)


def test_field_dates_in_a_zone_at_nanoseconds_refused(tmp_path):
    """The reference gives zone-aware nanosecond ``pandas.Timestamp``s,
    which have no counterpart without pandas: the port raises."""
    rows = [{"created_at": "2024-01-02T03:04:05.123456789Z", "n": 0}]
    path = _write(tmp_path, "d.json", json.dumps({"data": rows}))
    assert str(JaxDataset.from_json(path, field="data").get_split(True)
               .features["created_at"].dtype) == "timestamp[ns, tz=UTC]"
    with pytest.raises(NotImplementedError, match="nanosecond times in a zone"):
        TpflDataset.from_json(path, field="data")
