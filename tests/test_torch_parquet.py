"""``TpflDataset.from_parquet`` (the port's numpy Parquet reader) against
the reference's ``load_dataset("parquet", ...)``, value by value with
Python types, on tables pyarrow writes here at run time: every physical
and logical type with missing values, nesting (lists, structs, lists of
structs), the codecs (none, Snappy, gzip), the encodings (dictionary,
delta, byte stream split), data pages v1 and v2, several pages, row
groups and files, and a hypothesis strategy of flat tables. A corrupt
file and each codec the port lacks raise; a MAP and a fixed-size binary
raise as the reference does.

The reference's nanosecond ``pandas.Timestamp`` has no counterpart
without pandas: the port keeps ``datetime64[ns]``, held here to the
instant (``Timestamp.value``)."""

import datetime
import decimal
import math

import numpy as np
import pytest

from tpfl.learning.dataset.tpfl_dataset import TpflDataset as JaxDataset
from tpfl_torch.learning.dataset import parquet as port_parquet
from tpfl_torch.learning.dataset.tpfl_dataset import TpflDataset

pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")


def _same(a, b) -> bool:
    """One value of the port against the reference's, with its type."""
    if type(b).__name__ == "Timestamp":
        return b.tzinfo is None and isinstance(a, int) and a == b.value
    if isinstance(b, list):
        return isinstance(a, list) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(b, dict):
        return isinstance(a, dict) and list(a) == list(b) and all(
            _same(a[k], b[k]) for k in b)
    if isinstance(b, float) and math.isnan(b):
        return isinstance(a, float) and math.isnan(a)
    if type(a) is not type(b) or a != b:
        return False
    if isinstance(b, (datetime.datetime, datetime.time)):
        return a.utcoffset() == b.utcoffset()
    if isinstance(b, decimal.Decimal):
        return a.as_tuple() == b.as_tuple()
    return True


def _assert_split_equal(got, want):
    assert got.column_names == list(want.column_names)
    assert len(got) == len(want)
    for name in want.column_names:
        ref = list(want[name])
        mine = got[name].tolist()
        bad = [(i, a, b) for i, (a, b) in enumerate(zip(mine, ref, strict=True))
               if not _same(a, b)]
        assert not bad, (name, bad[:3])


def _load_both(paths, **kwargs):
    want = JaxDataset.from_parquet(paths, **kwargs).get_split(True)
    got = TpflDataset.from_parquet(paths).get_split(True)
    return got, want


def _typed_table(n: int = 7, seed: int = 0):
    """Each type in a column of its own, with a missing value in every
    third row."""
    rng = np.random.default_rng(seed)
    mask = np.arange(n) % 3 == 1

    def arr(values, typ):
        return pa.array([None if m else v for v, m in zip(values, mask)], typ)

    ints = rng.integers(-100, 100, n).tolist()
    return pa.table({
        "bool": arr(rng.integers(0, 2, n).astype(bool).tolist(), pa.bool_()),
        "i8": arr(ints, pa.int8()), "i16": arr(ints, pa.int16()),
        "i32": arr(ints, pa.int32()), "i64": arr([v * 10**12 for v in ints], pa.int64()),
        "u8": arr([abs(v) for v in ints], pa.uint8()),
        "u16": arr([abs(v) * 300 for v in ints], pa.uint16()),
        "u32": arr([abs(v) * 10**7 for v in ints], pa.uint32()),
        "u64": arr([2**63 + abs(v) for v in ints], pa.uint64()),
        "f16": arr(rng.normal(size=n).astype(np.float16).tolist(), pa.float16()),
        "f32": arr(rng.normal(size=n).astype(np.float32).tolist(), pa.float32()),
        "f64": arr(rng.normal(size=n).tolist() + [], pa.float64()),
        "nan": pa.array([math.nan, 1.0] * (n // 2) + [math.inf] * (n % 2)),
        "str": arr([f"s{v}é" for v in ints], pa.string()),
        "lstr": arr([f"l{v}" for v in ints], pa.large_string()),
        "bin": arr([bytes([abs(v)]) * 3 for v in ints], pa.binary()),
        "date": arr([datetime.date(2000, 1, 1) + datetime.timedelta(days=v) for v in ints],
                    pa.date32()),
        "date64": arr([datetime.date(2001, 1, 1) + datetime.timedelta(days=v) for v in ints],
                      pa.date64()),
        "t_s": arr([abs(v) * 37 for v in ints], pa.time32("s")),
        "t_ms": arr([abs(v) * 37001 for v in ints], pa.time32("ms")),
        "t_us": arr([abs(v) * 37000001 for v in ints], pa.time64("us")),
        "t_ns": arr([abs(v) * 37000000001 for v in ints], pa.time64("ns")),
        "ts_s": arr([1.7e9 + v * 1e5 for v in ints], pa.float64()).cast(pa.int64()).cast(
            pa.timestamp("s")),
        "ts_ms": arr([1700000000123 + v for v in ints], pa.timestamp("ms")),
        "ts_us": arr([1700000000123456 + v for v in ints], pa.timestamp("us")),
        "ts_ns": arr([1700000000123456789 + v for v in ints], pa.timestamp("ns")),
        "ts_utc": arr([1700000000123456 + v for v in ints], pa.timestamp("us", tz="UTC")),
        "ts_off": arr([1700000000123 + v for v in ints], pa.timestamp("ms", tz="+05:30")),
        "dur_s": arr(ints, pa.duration("s")), "dur_us": arr(ints, pa.duration("us")),
        "dec_i32": arr([decimal.Decimal(v).scaleb(-2) for v in ints], pa.decimal128(5, 2)),
        "dec_i64": arr([decimal.Decimal(v * 10**9).scaleb(-3) for v in ints],
                       pa.decimal128(15, 3)),
        "dec_big": arr([decimal.Decimal(v * 10**20).scaleb(-4) for v in ints],
                       pa.decimal128(38, 4)),
        "dict": pa.array([f"k{abs(v) % 3}" for v in ints]).dictionary_encode(),
        "null": pa.array([None] * n, pa.null()),
    })


def _nested_table(n: int = 9, seed: int = 1):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        k = int(rng.integers(0, 4))
        rows.append({
            "list": None if i % 4 == 3 else [int(x) for x in rng.integers(0, 9, k)],
            "list_nulls": [None if j == 1 else f"v{j}" for j in range(k)],
            "fixed": [float(x) for x in rng.normal(size=3)],
            "nested": [[int(j)] * j for j in range(k)] if i % 5 else None,
            "struct": None if i % 3 == 2 else {"a": i, "b": None if i % 2 else f"b{i}",
                                               "c": {"d": float(i)}},
            "list_struct": [{"x": j, "y": [j] * j} for j in range(k)],
            "struct_list": {"xs": [i] * k, "name": f"n{i}"},
        })
    return pa.Table.from_pylist(rows)


def _write(tmp_path, table, name="t.parquet", **kwargs):
    path = str(tmp_path / name)
    pq.write_table(table, path, **kwargs)
    return path


@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("codec", ["NONE", "SNAPPY", "GZIP"])
@pytest.mark.parametrize("dictionary", [True, False])
def test_types_codecs_and_pages_match_the_reference(codec, dictionary, version, tmp_path):
    path = _write(tmp_path, _typed_table(), compression=codec, use_dictionary=dictionary,
                  data_page_version=version)
    _assert_split_equal(*_load_both(path))


@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_nesting_matches_the_reference(version, tmp_path):
    path = _write(tmp_path, _nested_table(), data_page_version=version)
    _assert_split_equal(*_load_both(path))


def test_fixed_length_lists_stack_into_one_array(tmp_path):
    """A list column of equal-length numbers is one float64 array, as the
    export needs it; its values are the reference's lists."""
    path = _write(tmp_path, _nested_table())
    got, want = _load_both(path)
    assert got["fixed"].dtype == np.float64 and got["fixed"].shape == (len(want), 3)
    _assert_split_equal(got, want)


@pytest.mark.parametrize("encoding", ["DELTA_BINARY_PACKED", "DELTA_LENGTH_BYTE_ARRAY",
                                      "DELTA_BYTE_ARRAY", "BYTE_STREAM_SPLIT", "PLAIN"])
@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_encodings_match_the_reference(encoding, version, tmp_path):
    rng = np.random.default_rng(3)
    n = 1000
    cols = {
        "i32": pa.array(rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)),
        "i64": pa.array(np.cumsum(rng.integers(-5, 1000, n)).astype(np.int64)),
        "f32": pa.array(rng.normal(size=n).astype(np.float32)),
        "f64": pa.array(rng.normal(size=n)),
        "s": pa.array([None if i % 7 == 0 else f"prefix-{i // 10}-{i}" for i in range(n)]),
        "b": pa.array([bytes(rng.integers(0, 256, i % 5, dtype=np.uint8)) for i in range(n)]),
    }
    fits = {"DELTA_BINARY_PACKED": ("i32", "i64"), "DELTA_LENGTH_BYTE_ARRAY": ("s", "b"),
            "DELTA_BYTE_ARRAY": ("s", "b"), "BYTE_STREAM_SPLIT": ("f32", "f64", "i32", "i64"),
            "PLAIN": tuple(cols)}[encoding]
    path = _write(tmp_path, pa.table(cols), use_dictionary=False, data_page_version=version,
                  column_encoding={c: encoding for c in fits}, data_page_size=2048)
    chunks = pq.ParquetFile(path).metadata.row_group(0)
    assert any(encoding in chunks.column(i).encodings for i in range(chunks.num_columns))
    _assert_split_equal(*_load_both(path))


def test_row_groups_pages_and_files_in_order(tmp_path):
    table = _typed_table(n=60, seed=4)
    first = _write(tmp_path, table, "a.parquet", row_group_size=7, data_page_size=64,
                   compression="SNAPPY")
    second = _write(tmp_path, _typed_table(n=11, seed=5), "b.parquet", row_group_size=4,
                    compression="GZIP", data_page_version="2.0")
    assert pq.ParquetFile(first).metadata.num_row_groups == 9
    got, want = _load_both([first, second])
    assert len(got) == 71
    _assert_split_equal(got, want)


def test_boolean_rle_and_dictionary_indices_wider_than_a_byte(tmp_path):
    rng = np.random.default_rng(6)
    n = 5000
    table = pa.table({"b": pa.array(rng.integers(0, 2, n).astype(bool)),
                      "d": pa.array([f"w{v}" for v in rng.integers(0, 700, n)]),
                      "runs": pa.array(np.repeat(np.arange(50), 100))})
    path = _write(tmp_path, table, data_page_version="2.0",
                  column_encoding=None, use_dictionary=["d", "runs"])
    _assert_split_equal(*_load_both(path))


def test_int96_timestamps_read_as_nanoseconds(tmp_path):
    stamps = pa.array([1700000000123456789, None, -86400 * 10**9], pa.timestamp("ns"))
    path = _write(tmp_path, pa.table({"t": stamps}), use_deprecated_int96_timestamps=True)
    assert pq.ParquetFile(path).schema.column(0).physical_type == "INT96"
    got, want = _load_both(path)
    assert got["t"].dtype == np.dtype("datetime64[ns]")
    _assert_split_equal(got, want)


def test_json_extension_and_zone_names_from_the_arrow_schema(tmp_path):
    table = pa.table({
        "js": pa.array(['{"a": [1, 2]}', None, "3"], pa.json_(pa.string())),
        "paris": pa.array([1700000000123456, None, 0], pa.timestamp("us", tz="Europe/Paris")),
    })
    _assert_split_equal(*_load_both(_write(tmp_path, table)))


@pytest.mark.parametrize("column", ["map", "fixed_binary"])
def test_types_without_a_datasets_dtype_raise_as_the_reference(column, tmp_path):
    arr = {"map": pa.array([[("k", 1)], None], pa.map_(pa.string(), pa.int64())),
           "fixed_binary": pa.array([b"abc", None], pa.binary(3))}[column]
    path = _write(tmp_path, pa.table({column: arr}))
    with pytest.raises(ValueError, match="datasets dtype"):
        JaxDataset.from_parquet(path)
    with pytest.raises(ValueError, match="datasets dtype"):
        TpflDataset.from_parquet(path)


@pytest.mark.parametrize("codec", ["ZSTD", "BROTLI", "LZ4"])
def test_codecs_not_ported_raise_naming_the_codec(codec, tmp_path):
    path = _write(tmp_path, pa.table({"x": [1, 2, 3]}), compression=codec)
    assert list(JaxDataset.from_parquet(path).get_split(True)["x"]) == [1, 2, 3]
    name = "LZ4_RAW" if codec == "LZ4" else codec
    with pytest.raises(NotImplementedError, match=f"{name}.*ROADMAP.md"):
        TpflDataset.from_parquet(path)


def test_corrupt_files_raise(tmp_path):
    path = _write(tmp_path, _typed_table(), compression="SNAPPY")
    data = bytearray(open(path, "rb").read())
    for cut in (b"", bytes(data[:100]), bytes(data[:-9]) + b"PAR1"):
        bad = tmp_path / "cut.parquet"
        bad.write_bytes(cut)
        with pytest.raises(ValueError):
            TpflDataset.from_parquet(str(bad))
    meta = pq.ParquetFile(path).metadata.row_group(0).column(4)
    start = meta.dictionary_page_offset or meta.data_page_offset
    flipped = bytearray(data)
    for k in range(start + 8, start + 24):
        flipped[k] ^= 0xFF
    bad = tmp_path / "flip.parquet"
    bad.write_bytes(bytes(flipped))
    with pytest.raises(ValueError):
        TpflDataset.from_parquet(str(bad))


def test_unknown_keywords_refused(tmp_path):
    path = _write(tmp_path, pa.table({"x": [1]}))
    with pytest.raises(TypeError, match="columns"):
        TpflDataset.from_parquet(path, columns=["x"])


def test_arrow_schema_fields_decoded(tmp_path):
    path = _write(tmp_path, _typed_table())
    kv = pq.ParquetFile(path).metadata.metadata
    fields = {f["name"]: f for f in port_parquet.arrow_schema(kv[b"ARROW:schema"])}
    assert fields["dur_s"]["type"] == "duration" and fields["dur_s"]["unit"] == "s"
    assert fields["ts_off"]["tz"] == "+05:30" and fields["ts_ns"]["unit"] == "ns"
    assert list(fields) == _typed_table().column_names


def _flat_tables():
    from hypothesis import strategies as st

    kinds = {
        "int64": (st.integers(-2**63, 2**63 - 1), pa.int64()),
        "int32": (st.integers(-2**31, 2**31 - 1), pa.int32()),
        "float64": (st.floats(allow_nan=False, width=64), pa.float64()),
        "bool": (st.booleans(), pa.bool_()),
        "string": (st.text(max_size=8), pa.string()),
        "binary": (st.binary(max_size=8), pa.binary()),
    }

    @st.composite
    def tables(draw):
        n = draw(st.integers(1, 40))
        names = draw(st.lists(st.sampled_from(sorted(kinds)), min_size=1, max_size=4))
        cols = {}
        for k, kind in enumerate(names):
            values, typ = kinds[kind]
            cols[f"c{k}_{kind}"] = pa.array(
                draw(st.lists(st.none() | values, min_size=n, max_size=n)), typ)
        options = {"compression": draw(st.sampled_from(["NONE", "SNAPPY", "GZIP"])),
                   "use_dictionary": draw(st.booleans()),
                   "data_page_version": draw(st.sampled_from(["1.0", "2.0"])),
                   "row_group_size": draw(st.integers(1, 50))}
        return pa.table(cols), options

    return tables()


def test_flat_tables_match_the_reference(tmp_path):
    from hypothesis import HealthCheck, given, settings

    counter = iter(range(10**6))

    @settings(max_examples=25, deadline=None, database=None,
              suppress_health_check=list(HealthCheck))
    @given(_flat_tables())
    def check(case):
        table, options = case
        path = _write(tmp_path, table, f"h{next(counter)}.parquet", **options)
        _assert_split_equal(*_load_both(path))

    check()
