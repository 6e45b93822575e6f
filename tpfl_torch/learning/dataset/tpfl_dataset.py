"""Framework-neutral dataset container — the port of
:class:`tpfl.learning.dataset.tpfl_dataset.TpflDataset`, backed by numpy
columns instead of a Hugging Face ``Dataset`` (the port does not import
``datasets``).

A dataset is either flat (one dict of columns, split on first use) or
split (``{"train": {...}, "test": {...}}``). :meth:`TpflDataset.set_split`
picks the same rows as ``Dataset.train_test_split(test_size=1 -
train_fraction, seed=seed)``: ``n_test = ceil(test_size · n)``, a
permutation from ``np.random.default_rng(seed)``, its first ``n_test``
rows the test split and the rest the train split, each in permutation
order. :meth:`TpflDataset.generate_partitions` splits through the
partition strategies (:mod:`tpfl_torch.learning.dataset.partition_strategies`),
index lists bit-equal to the reference's.

The file constructors read with the standard library and give what the
reference's Hugging Face loaders give: ``from_csv`` / ``from_json`` one
``"train"`` split, ``from_generator`` / ``from_pandas`` one flat dataset;
the columns in the same order, integers as int64, floats as float64,
strings as str. ``from_json`` types as its two readers do: a missing
number is a masked entry of an int64 or float64 column (``tolist()``
gives ``None``), and date strings become ``datetime64`` columns, or
``datetime`` objects in a zone (:func:`_json_column`); ``from_csv`` keeps pandas' float64 with NaN for
an integer column with a missing value.
``from_parquet`` reads Parquet with numpy (:mod:`parquet`) and applies
the Hugging Face features stored in the file (:mod:`hf_features`: class
labels, arrays, PNG and JPEG images through :mod:`images`); ``from_huggingface``
reads a local dataset directory as ``load_dataset`` resolves it, and
refuses a Hub name (a download).
"""

from __future__ import annotations

import csv
import datetime
import json
import math
import os
import re
from collections.abc import Callable, Iterable, Mapping
from typing import Any, Optional, Union

import numpy as np

from tpfl_torch.learning.dataset import dates, hf_features, parquet

_HUB_ITEM = "ROADMAP.md §1, Hub downloads (they need the network)"


class ColumnSplit:
    """One split: named numpy columns of equal length. ``split[name]``
    gives a column, ``split[i]`` row ``i`` as a dict."""

    def __init__(self, columns: Mapping[str, Any]) -> None:
        self._columns = {k: np.asanyarray(v) for k, v in columns.items()}
        lengths = {len(v) for v in self._columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of different lengths: {sorted(lengths)}")

    @property
    def column_names(self) -> list[str]:
        return list(self._columns)

    def __len__(self) -> int:
        return len(next(iter(self._columns.values()))) if self._columns else 0

    def __getitem__(self, key: Any) -> Any:
        if isinstance(key, str):
            return self._columns[key]
        return {k: v[key] for k, v in self._columns.items()}

    def select(self, indices: Any) -> "ColumnSplit":
        idx = np.asarray(indices, dtype=np.int64)
        return ColumnSplit({k: v[idx] for k, v in self._columns.items()})


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"tpfl_torch TpflDataset: {what} is not ported yet ({item})")


def _refuse_kwargs(where: str, kwargs: Mapping[str, Any]) -> None:
    """The reference forwards keyword arguments to Hugging Face; the port
    implements only the ones in its signatures and never drops one."""
    if kwargs:
        raise TypeError(f"TpflDataset.{where}: the port does not implement keyword "
                        f"argument(s) {', '.join(sorted(kwargs))}")


def _kind(v: Any) -> str:
    for kind, types in (("bool", (bool, np.bool_)), ("int", (int, np.integer)),
                        ("float", (float, np.floating)), ("str", (str,)),
                        ("list", (list, tuple, np.ndarray))):
        if isinstance(v, types):
            return kind
    return "other"


def _column(values: list, coerce_ints: bool = False) -> np.ndarray:
    """One column as the reference's loaders type it: integers -> int64,
    numbers with a float or a missing value among them -> float64 (NaN
    for missing), strings -> str, booleans -> bool, lists -> a stacked
    array; anything else an object array. ``coerce_ints``: a number
    column without a missing value whose floats are all whole and within
    int64 becomes int64, as pandas' ``read_json`` coerces it."""
    kinds = {_kind(v) for v in values if v is not None}
    missing = any(v is None for v in values)
    if kinds and kinds <= {"int", "float"}:
        if not missing and (kinds == {"int"} or (coerce_ints and _whole(values))):
            return np.asarray([int(v) for v in values], dtype=np.int64)
        return np.asarray([np.nan if v is None else v for v in values], dtype=np.float64)
    dtypes = {"bool": bool, "str": str, "list": None}
    if len(kinds) == 1 and not missing and next(iter(kinds)) in dtypes:
        return np.asarray(values, dtype=dtypes[next(iter(kinds))])
    return np.asarray(values, dtype=object)


def _records_to_columns(records: Iterable[Mapping[str, Any]],
                        json_reader: Optional[str] = None) -> dict[str, np.ndarray]:
    """Rows of dicts to typed columns, keys in first-appearance order and
    a missing key as a missing value; ``json_reader`` ("arrow" or
    "pandas") types them as that reader of ``from_json`` does."""
    rows = list(records)
    names: dict[str, None] = {}
    for row in rows:
        names.update(dict.fromkeys(row))
    if json_reader is None:
        return {k: _column([row.get(k) for row in rows]) for k in names}
    return {k: _json_column(k, [row.get(k) for row in rows], json_reader) for k in names}


# --- from_json's column types: the two readers of the reference's loader ----

#: The strings pyarrow's JSON reader infers as ``timestamp[s]`` (arrow's
#: ``ParseTimestampISO8601`` at second precision): a date, then optionally
#: ``T`` or a blank and ``hh``, ``hh:mm`` or ``hh:mm:ss``, then optionally
#: ``Z`` or an offset ``±hh``, ``±hhmm``, ``±hh:mm`` (the time moves to UTC).
_ARROW_TIMESTAMP = re.compile(
    r"(\d{4})-(\d{2})-(\d{2})(?:[T ](\d{2})(?::(\d{2})(?::(\d{2}))?)?"
    r"(Z|[+-]\d{2}(?::?\d{2})?)?)?")

_INT_TEXT = re.compile(r"\s*[+-]?\d+\s*")

#: pandas reads numbers in a date-like column as epoch times only when
#: every one is above a year of seconds (``Parser._MIN_STAMPS["s"]``).
_MIN_STAMP = 31536000


def _date_like(name: str) -> bool:
    """The column names whose values pandas' ``read_json`` tries as dates
    (``keep_default_dates``)."""
    low = name.lower()
    return (low.endswith(("_at", "_time")) or low in {"modified", "date", "datetime"}
            or low.startswith("timestamp"))


def _stamps(values: list, unit: str) -> np.ndarray:
    """``datetime`` values (None: NaT) as a ``datetime64[unit]`` column."""
    return np.asarray([np.datetime64("NaT") if v is None else np.datetime64(v, unit)
                       for v in values], dtype=f"datetime64[{unit}]")


def _arrow_timestamp(text: str) -> Optional[datetime.datetime]:
    m = _ARROW_TIMESTAMP.fullmatch(text)
    if m is None:
        return None
    y, mo, d, h, mi, s, zone = m.groups()
    try:
        t = datetime.datetime(int(y), int(mo), int(d), int(h or 0), int(mi or 0), int(s or 0))
    except ValueError:
        return None
    if zone and zone != "Z":
        hours, minutes = int(zone[1:3]), int(zone[3:].lstrip(":") or 0)
        if hours > 23 or minutes > 59:
            return None
        sign = 1 if zone[0] == "+" else -1
        t -= sign * datetime.timedelta(hours=hours, minutes=minutes)
    return t


#: Nanoseconds of one epoch unit, in the order pandas tries them
#: (``Parser._STAMP_UNITS``), and the decimals its float cast keeps.
_EPOCH_UNITS = (("s", 10**9, 9), ("ms", 10**6, 6), ("us", 10**3, 3), ("ns", 1, 0))


def _pandas_epochs(values: list) -> Optional[np.ndarray]:
    """Numbers (None: missing) as pandas reads them in a date-like
    column: epoch times, when every one is above :data:`_MIN_STAMP`, in
    the first unit whose nanoseconds fit int64; ``datetime64`` of that
    unit where all are whole, else ``datetime64[ns]`` through pandas'
    float cast (``cast_from_unit_vectorized``: the whole part, plus the
    fraction rounded to the unit's decimals); None where it keeps them."""
    present = [v for v in values if v is not None]
    if any(v <= _MIN_STAMP for v in present):
        return None
    whole = all(isinstance(v, int) or float(v).is_integer() for v in present)
    nat = np.iinfo(np.int64).min
    for unit, scale, decimals in _EPOCH_UNITS:
        if whole:
            ticks = [None if v is None else int(v) for v in values]
            if all(v is None or v * scale < 2**63 for v in ticks):
                return np.asarray([nat if v is None else v for v in ticks],
                                  np.int64).view(f"datetime64[{unit}]")
            continue
        ticks = []
        for v in values:
            if v is None:
                ticks.append(nat)
                continue
            base = int(v)
            frac = np.round(np.float64(v) - base, decimals) if decimals else v - base
            ticks.append(base * scale + int(frac * scale))
        if all(t < 2**63 for t in ticks):
            return np.asarray(ticks, np.int64).view("datetime64[ns]")
    return None


def _stamp_column(stamps: list) -> np.ndarray:
    """Parsed date strings (:mod:`dates`, None: missing) as the
    reference's column: no value -> ``datetime64[s]`` of NaT; naive ->
    ``datetime64[us]``, or ``[ns]`` where a value has more than six
    fraction digits; in a zone -> ``datetime`` objects in it (UTC, or a
    fixed offset)."""
    present = [s for s in stamps if s is not None]
    if not present:
        return _stamps([None] * len(stamps), "s")
    zone = present[0].zone
    ns = any(s.ns_digits for s in present)
    if zone is None:
        if not ns:
            return _stamps([None if s is None else s.wall for s in stamps], "us")
        return np.asarray([np.datetime64("NaT") if s is None else
                           np.datetime64(s.wall, "ns") + np.timedelta64(s.nanos, "ns")
                           for s in stamps], dtype="datetime64[ns]")
    if ns:
        raise NotImplementedError("from_json: nanosecond times in a zone (the reference's "
                                  "pandas.Timestamp with a zone) are not ported "
                                  f"({dates.VALUE_ITEM})")
    tz = (datetime.timezone.utc if zone == "UTC"
          else datetime.timezone(datetime.timedelta(seconds=zone)))
    return np.asarray([None if s is None else s.wall.replace(tzinfo=tz) for s in stamps],
                      dtype=object)


def _pandas_dates(values: list, kinds: set) -> Optional[np.ndarray]:
    """A date-like column as pandas' ``read_json`` converts it
    (``Parser._try_convert_to_date``), or None where it leaves it: all
    missing -> ``datetime64[s]``; integer strings without a missing value
    as integers; numbers -> epoch times (:func:`_pandas_epochs`); other
    strings through ``to_datetime``'s three formats
    (:func:`dates.parse_strings`, :func:`_stamp_column`)."""
    present = [v for v in values if v is not None]
    if not present:
        return _stamps(values, "s")
    if kinds == {"str"}:
        if len(present) == len(values) and all(_INT_TEXT.fullmatch(v) for v in present):
            ints = [int(v) for v in values]
            if not all(-2**63 <= v < 2**63 for v in ints):
                return None  # pandas' int64 cast overflows
            return _pandas_epochs(ints)
        stamps = dates.parse_strings(values)
        return None if stamps is None else _stamp_column(stamps)
    if kinds and kinds <= {"int", "float"}:
        return _pandas_epochs(values)
    return None


def _whole(values: list) -> bool:
    """Numbers that are all whole and within int64 (pandas' int coercion)."""
    return all(math.isfinite(v) and v == int(v) and -2**63 <= v < 2**63 for v in values)


def _json_column(name: str, values: list, reader: str) -> np.ndarray:
    """One column of ``from_json`` as the reference's reader types it:

    - ``"arrow"`` (JSON Lines and arrays, pyarrow's reader): strings that
      all parse as :data:`_ARROW_TIMESTAMP` -> ``datetime64[s]``;
    - ``"pandas"`` (records under ``field``, pandas' ``read_json``): in a
      date-like column name (:func:`_date_like`) the dates of
      :func:`_pandas_dates`; whole numbers -> int64;
    - both: a number column with a missing value is masked there, int64
      or float64 (``tolist()`` gives ``None``, as the reference's null);
      a missing timestamp is NaT (``None``). Otherwise :func:`_column`."""
    present = [v for v in values if v is not None]
    kinds = {_kind(v) for v in present}
    pandas = reader == "pandas"
    if pandas and _date_like(name):
        stamps = _pandas_dates(values, kinds)
        if stamps is not None:
            return stamps
    elif not pandas and present and kinds == {"str"}:
        parsed = [None if v is None else _arrow_timestamp(v) for v in values]
        if all(t is not None for t, v in zip(parsed, values) if v is not None):
            return _stamps(parsed, "s")
    if len(present) < len(values) and kinds and kinds <= {"int", "float"}:
        mask = [v is None for v in values]
        filled = [0 if v is None else v for v in values]
        if kinds == {"int"} or (pandas and _whole(present)):
            return np.ma.masked_array(np.asarray([int(v) for v in filled], np.int64), mask=mask)
        return np.ma.masked_array(np.asarray(filled, np.float64), mask=mask)
    return _column(values, coerce_ints=pandas)


# --- pandas' ujson float path (the reference's JSON loader) -------------------

#: ``g_pow10`` of the ujson decoder pandas vendors: the fraction's scale.
_FRACTION_POW10 = (1.0, 0.1, 0.01, 0.001, 0.0001, 0.00001, 0.000001, 0.0000001, 0.00000001,
                   0.000000001, 0.0000000001, 0.00000000001, 0.000000000001,
                   0.0000000000001, 0.00000000000001, 0.000000000000001)


def _ujson_float(text: str) -> float:
    """A JSON number with a fraction or an exponent as pandas' ujson
    decoder reads it at ``precise_float=False`` (``ujson_loads``, and
    ``read_json``'s default): the integer digits as an integer, at most
    15 fraction digits as a float ``f``, ``(int + f · 10^−digits) · sign``,
    times ``pow(10, exponent)``. Not correctly rounded: the same
    operations in the same order give the same bits."""
    i, sign = 0, 1.0
    if text[0] == "-":
        i, sign = 1, -1.0
    whole = 0
    while i < len(text) and text[i].isdigit():
        whole = whole * 10 + ord(text[i]) - 48
        i += 1
    frac, digits = 0.0, 0
    if i < len(text) and text[i] == ".":
        i += 1
        while i < len(text) and text[i].isdigit():
            if digits < 15:
                frac = frac * 10.0 + float(ord(text[i]) - 48)
                digits += 1
            i += 1
    value = (float(whole) + frac * _FRACTION_POW10[digits]) * sign
    if i < len(text) and text[i] in "eE":
        i += 1
        exp_sign = 1.0
        if text[i] in "+-":
            exp_sign = -1.0 if text[i] == "-" else 1.0
            i += 1
        exp = 0.0
        while i < len(text) and text[i].isdigit():
            exp = exp * 10.0 + float(ord(text[i]) - 48)
            i += 1
        try:
            scale = math.pow(10.0, exp * exp_sign)
        except OverflowError:  # C's pow gives inf
            scale = math.inf
        value = value * scale
    return value


def _ujson_dumps_float(x: float) -> str:
    """``x`` as pandas' ``ujson_dumps`` writes it at its default
    ``double_precision=10``: ``%.10g`` above 1e16 or below 1e-15 in
    magnitude, else the whole part and the fraction times 1e10 truncated,
    then rounded up past one half (and at exactly one half when odd or
    zero), trailing zeros dropped; −0.0 writes as ``0.0``."""
    a = -x if x < 0 else x
    if a > 1e16 or (a != 0.0 and a < 1e-15):
        return "%.10g" % x
    whole = int(a)
    scaled = (a - float(whole)) * 1e10
    frac = int(scaled)
    diff = scaled - frac
    if diff > 0.5 or (diff == 0.5 and (frac == 0 or frac & 1)):
        frac += 1
    if frac >= 10**10:
        frac, whole = 0, whole + 1
    text = f"{whole}." + (f"{frac:010d}".rstrip("0") if frac else "0")
    return "-" + text if x < 0 else text


def _map_floats(tree: Any, fn: Callable[[float], float]) -> Any:
    """``fn`` over every float of a parsed JSON value."""
    if isinstance(tree, float):
        return fn(tree)
    if isinstance(tree, list):
        return [_map_floats(v, fn) for v in tree]
    if isinstance(tree, dict):
        return {k: _map_floats(v, fn) for k, v in tree.items()}
    return tree


def _csv_value(text: str) -> Any:
    """A CSV field as pandas' reader types it: int, then float, else str;
    an empty field is missing."""
    if text == "":
        return None
    for parse in (int, float):
        try:
            return parse(text)
        except ValueError:
            continue
    return text


def _paths(path: Union[str, list[str]]) -> list[str]:
    return [os.fspath(path)] if isinstance(path, (str, os.PathLike)) else list(path)


class TpflDataset:
    """Train/test dataset of numpy columns.

    Args:
        data: a dict of column -> array (one flat dataset, split on first
            use), a dict of split name -> columns (``train_split_name`` /
            ``test_split_name``), or a :class:`ColumnSplit`.
        train_split_name: split key holding training data.
        test_split_name: split key holding test data.
        batch_size: default export batch size.
    """

    def __init__(
        self,
        data: Any,
        train_split_name: str = "train",
        test_split_name: str = "test",
        batch_size: int = 64,
    ) -> None:
        if isinstance(data, Mapping) and data and all(
            isinstance(v, (Mapping, ColumnSplit)) for v in data.values()
        ):
            self._splits: Optional[dict[str, ColumnSplit]] = {
                k: v if isinstance(v, ColumnSplit) else ColumnSplit(v) for k, v in data.items()
            }
            self._flat: Optional[ColumnSplit] = None
        else:
            self._splits = None
            self._flat = data if isinstance(data, ColumnSplit) else ColumnSplit(data)
        self._train_split_name = train_split_name
        self._test_split_name = test_split_name
        self.batch_size = batch_size

    # --- constructors ---

    @classmethod
    def from_arrays(
        cls,
        x_train: np.ndarray,
        y_train: np.ndarray,
        x_test: np.ndarray,
        y_test: np.ndarray,
        x_name: str = "image",
        y_name: str = "label",
    ) -> "TpflDataset":
        """In-memory constructor — the normal path for synthetic and
        benchmark data."""
        return cls({"train": {x_name: x_train, y_name: y_train},
                    "test": {x_name: x_test, y_name: y_test}})

    @classmethod
    def from_huggingface(cls, dataset_name: str, **kwargs: Any) -> "TpflDataset":
        """Every split of a local dataset directory, as
        ``load_dataset(dataset_name)`` reads it
        (:func:`hf_features.data_files`: split names from the file and
        directory names, each split's files read in order by the loader
        their extension names). A name that is no local directory is a
        Hub download, which the port does not do."""
        _refuse_kwargs("from_huggingface", kwargs)
        if not os.path.isdir(dataset_name):
            if os.path.isfile(dataset_name):
                raise FileNotFoundError(f"Couldn't find any data file at {dataset_name}.")
            raise _not_ported(f"from_huggingface({dataset_name!r}): a Hub download (no local "
                              "directory of that name)", _HUB_ITEM)
        splits, loader, options = hf_features.data_files(dataset_name)
        read = {"parquet": cls.from_parquet, "csv": cls.from_csv, "json": cls.from_json}[loader]
        return cls({split: read(files, **options).get_split(True)
                    for split, files in splits.items()})

    @classmethod
    def from_csv(cls, path: Union[str, list[str]], sep: str = ",", **kwargs: Any
                 ) -> "TpflDataset":
        """One ``"train"`` split from CSV file(s) with a header row (rows of
        several files concatenated), as ``load_dataset("csv",
        data_files=path)``."""
        _refuse_kwargs("from_csv", kwargs)
        records = []
        for p in _paths(path):
            with open(p, newline="") as f:
                for row in csv.DictReader(f, delimiter=sep):
                    records.append({k: _csv_value(v) for k, v in row.items()})
        return cls({"train": _records_to_columns(records)})

    @classmethod
    def from_json(cls, path: Union[str, list[str]], field: Optional[str] = None,
                  **kwargs: Any) -> "TpflDataset":
        """One ``"train"`` split from JSON Lines file(s), or from files
        holding one array of records (``field`` names the key of a
        top-level object that holds it), as ``load_dataset("json",
        data_files=path, field=field)`` gives it, floats bit for bit:

        - JSON Lines: floats parse exactly (pyarrow's reader);
        - a file starting with ``[``: the loader reads it with pandas'
          ujson (:func:`_ujson_float`), writes each record back with
          ``ujson_dumps`` (10 decimals, :func:`_ujson_dumps_float`) and
          parses that exactly;
        - under ``field``: the same read and write, then pandas'
          ``read_json`` reads the records with ujson again, and a number
          column whose values are all whole becomes int64.

        Column types follow the two readers (:func:`_json_column`): ISO
        8601 strings become ``datetime64[s]`` in JSON Lines and arrays
        (pyarrow's inference); under ``field``, in a date-like column name
        only, dates as pandas' ``convert_dates`` reads them
        (:func:`_pandas_dates`: strings through ``to_datetime``'s three
        formats, numbers as epoch times); a missing number is masked in an
        int64 or float64 column.

        An array after leading blanks raises ``ValueError``, as the
        reference's loader fails on it."""
        _refuse_kwargs("from_json", kwargs)
        records = []
        for p in _paths(path):
            with open(p) as f:
                text = f.read()
            if field is None and not text.startswith("["):
                if text.lstrip().startswith("["):
                    raise ValueError(f"{p}: a JSON array must start the file (the reference's "
                                     "loader reads it as JSON Lines and fails)")
                records.extend(json.loads(line) for line in text.splitlines() if line.strip())
                continue
            data = json.loads(text, parse_float=_ujson_float)
            if field is not None:
                data = _map_floats(data[field], lambda x: _ujson_float(_ujson_dumps_float(x)))
            else:
                data = _map_floats(data, lambda x: float(_ujson_dumps_float(x)))
            records.extend(data)
        return cls({"train": _records_to_columns(
            records, json_reader="arrow" if field is None else "pandas")})

    @classmethod
    def from_parquet(cls, path: Union[str, list[str]], **kwargs: Any) -> "TpflDataset":
        """One ``"train"`` split from Parquet file(s), rows of several
        files concatenated in order, as ``load_dataset("parquet",
        data_files=path)``: the columns :func:`parquet.read_table` gives,
        then the Hugging Face features stored in the file
        (:func:`hf_features.apply`: class labels, sequences, images)."""
        _refuse_kwargs("from_parquet", kwargs)
        paths = _paths(path)
        columns, kv = parquet.read_table(paths)
        return cls({"train": hf_features.apply(columns, kv.get("huggingface"))})

    @classmethod
    def from_pandas(cls, df: Any, **kwargs: Any) -> "TpflDataset":
        """A flat dataset (split on first use) from a DataFrame, read
        through ``.columns`` and ``.to_numpy()``, as
        ``Dataset.from_pandas(df)``: an index other than a ``RangeIndex``
        becomes a last column named after it, or ``__index_level_0__``."""
        _refuse_kwargs("from_pandas", kwargs)
        columns = {}
        for name in df.columns:
            values = df[name].to_numpy()
            columns[str(name)] = (_column(values.tolist()) if values.dtype == object
                                  else np.asarray(values))
        index = getattr(df, "index", None)
        if index is not None and type(index).__name__ != "RangeIndex":
            name = index.name if index.name is not None else "__index_level_0__"
            values = index.to_numpy()
            columns[str(name)] = (_column(values.tolist()) if values.dtype == object
                                  else np.asarray(values))
        return cls(columns)

    @classmethod
    def from_generator(cls, generator: Callable[..., Iterable[Mapping[str, Any]]],
                       gen_kwargs: Optional[Mapping[str, Any]] = None, **kwargs: Any
                       ) -> "TpflDataset":
        """A flat dataset (split on first use) from a generator function
        of row dicts, as ``Dataset.from_generator(generator,
        gen_kwargs=gen_kwargs)``."""
        _refuse_kwargs("from_generator", kwargs)
        return cls(_records_to_columns(generator(**dict(gen_kwargs or {}))))

    # --- split handling ---

    def set_split(self, train_fraction: float = 0.8, seed: int = 666) -> None:
        """Split a flat dataset into train/test, picking the rows of HF's
        ``train_test_split(test_size=1 - train_fraction, seed=seed)``."""
        if self._splits is not None:
            return
        flat = self._flat
        n = len(flat)
        if n == 0:
            self._splits = {self._train_split_name: flat, self._test_split_name: flat}
            return
        test_size = 1.0 - train_fraction
        if not 0 < test_size < 1:
            raise ValueError(
                f"test_size={test_size} should be either positive and smaller than the "
                f"number of samples {n} or a float in the (0, 1) range"
            )
        n_test = math.ceil(test_size * n)
        n_train = n - n_test
        if n_train == 0:
            raise ValueError(
                f"With n_samples={n}, test_size={test_size} and train_size=None, the "
                "resulting train set will be empty."
            )
        perm = np.random.default_rng(seed).permutation(n)
        self._splits = {
            self._train_split_name: flat.select(perm[n_test:n_test + n_train]),
            self._test_split_name: flat.select(perm[:n_test]),
        }

    def get_split(self, train: bool = True) -> ColumnSplit:
        if self._splits is None:
            self.set_split()
        name = self._train_split_name if train else self._test_split_name
        if name not in self._splits:
            raise KeyError(f"Split {name!r} not in dataset (has {list(self._splits)})")
        return self._splits[name]

    def num_samples(self, train: bool = True) -> int:
        return len(self.get_split(train))

    def get(self, idx: int, train: bool = True) -> dict[str, Any]:
        """Single-example access: ``{column: value}``."""
        return self.get_split(train)[idx]

    # --- partitioning ---

    def generate_partitions(self, num_partitions: int, strategy: Any, seed: int = 666,
                            label_tag: str = "label", **kwargs: Any) -> list["TpflDataset"]:
        """Split into ``num_partitions`` datasets by index selection.
        ``strategy`` is a :class:`DataPartitionStrategy` subclass (or
        instance); both splits are partitioned with the same strategy and
        seed."""
        train, test = self.get_split(True), self.get_split(False)
        train_idx, test_idx = strategy.generate_partitions(
            train, test, num_partitions, seed=seed, label_tag=label_tag, **kwargs)
        return [TpflDataset({self._train_split_name: train.select(train_idx[i]),
                             self._test_split_name: test.select(test_idx[i])},
                            train_split_name=self._train_split_name,
                            test_split_name=self._test_split_name,
                            batch_size=self.batch_size)
                for i in range(num_partitions)]

    # --- export ---

    def export(self, strategy: Optional[Any] = None, train: bool = True, **kwargs: Any) -> Any:
        """Export via a DataExportStrategy (default: numpy batches)."""
        from tpfl_torch.learning.dataset.export import TorchExportStrategy

        strategy = strategy or TorchExportStrategy
        return strategy.export(
            self.get_split(train),
            batch_size=kwargs.pop("batch_size", self.batch_size),
            **kwargs,
        )

    def __repr__(self) -> str:
        if self._splits is None:
            return f"TpflDataset(unsplit, n={len(self._flat)})"
        try:
            return f"TpflDataset(train={self.num_samples(True)}, test={self.num_samples(False)})"
        except KeyError:
            return f"TpflDataset(splits={list(self._splits)})"


__all__ = ["ColumnSplit", "TpflDataset"]
