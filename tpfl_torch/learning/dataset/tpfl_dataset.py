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
index lists bit-equal to the reference's. The HF-hub / file
constructors are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np

_HUB_ITEM = "ROADMAP.md §1 item 7, the node runtime: the HF-hub and file constructors"


class ColumnSplit:
    """One split: named numpy columns of equal length. ``split[name]``
    gives a column, ``split[i]`` row ``i`` as a dict."""

    def __init__(self, columns: Mapping[str, Any]) -> None:
        self._columns = {k: np.asarray(v) for k, v in columns.items()}
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
        raise _not_ported("from_huggingface", _HUB_ITEM)

    @classmethod
    def from_csv(cls, path: str, **kwargs: Any) -> "TpflDataset":
        raise _not_ported("from_csv", _HUB_ITEM)

    @classmethod
    def from_json(cls, path: str, **kwargs: Any) -> "TpflDataset":
        raise _not_ported("from_json", _HUB_ITEM)

    @classmethod
    def from_parquet(cls, path: str, **kwargs: Any) -> "TpflDataset":
        raise _not_ported("from_parquet", _HUB_ITEM)

    @classmethod
    def from_pandas(cls, df: Any, **kwargs: Any) -> "TpflDataset":
        raise _not_ported("from_pandas", _HUB_ITEM)

    @classmethod
    def from_generator(cls, generator: Any, **kwargs: Any) -> "TpflDataset":
        raise _not_ported("from_generator", _HUB_ITEM)

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
