"""Data export strategies — dataset → batches of numpy arrays, the port of
:mod:`tpfl.learning.dataset.export`.

:class:`Batches` is the reference's, as is: static shapes (the ragged
tail batch dropped by default), a seeded shuffle per epoch, and
:meth:`Batches.stacked` giving ``[n_batches, batch_size, ...]`` arrays.
:class:`TorchExportStrategy` applies the reference's column and dtype
rules to a split of numpy columns; the learner moves the arrays to its
device.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Iterator, Optional

import numpy as np


class Batches:
    """Materialized (x, y) arrays + an iterator of fixed-shape batches.

    ``x`` is float32 scaled by ``scale`` (e.g. 1/255 for images), ``y``
    is int32. Batches have static shape [batch_size, ...]; the ragged
    tail is dropped when ``drop_remainder`` (default) so jit sees one
    shape. Shuffling is seeded per epoch for reproducibility.
    """

    def __init__(
        self,
        x: np.ndarray,
        y: np.ndarray,
        batch_size: int,
        drop_remainder: bool = True,
        seed: int = 0,
    ) -> None:
        self.x = x
        self.y = y
        self.batch_size = min(batch_size, len(x)) if len(x) else batch_size
        self.drop_remainder = drop_remainder
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        if self.batch_size == 0:
            return 0
        n = len(self.x) // self.batch_size
        if not self.drop_remainder and len(self.x) % self.batch_size:
            n += 1
        return n

    @property
    def num_samples(self) -> int:
        return len(self.x)

    def shuffled_epoch(self, epoch: Optional[int] = None) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Seeded shuffle + fixed-shape batch iterator."""
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        rng = np.random.default_rng(np.uint32(self.seed) + np.uint32(epoch))
        order = rng.permutation(len(self.x))
        yield from self._iter(order)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        yield from self._iter(np.arange(len(self.x)))

    def _iter(self, order: np.ndarray) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        bs = self.batch_size
        n_full = len(order) // bs if bs else 0
        for i in range(n_full):
            sel = order[i * bs : (i + 1) * bs]
            yield self.x[sel], self.y[sel]
        if not self.drop_remainder and bs and len(order) % bs:
            sel = order[n_full * bs :]
            yield self.x[sel], self.y[sel]

    def stacked(self, num_batches: Optional[int] = None, epoch: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """All batches stacked on a leading axis — the shape
        ``lax.scan`` wants: [n_batches, batch_size, ...]."""
        rng = np.random.default_rng(np.uint32(self.seed) + np.uint32(epoch))
        order = rng.permutation(len(self.x))
        bs = self.batch_size
        n = len(order) // bs if bs else 0
        if num_batches is not None:
            n = min(n, num_batches)
        if n == 0:
            raise ValueError("Not enough samples for a single batch")
        sel = order[: n * bs]
        return (
            self.x[sel].reshape(n, bs, *self.x.shape[1:]),
            self.y[sel].reshape(n, bs, *self.y.shape[1:]),
        )


class DataExportStrategy(ABC):
    """Export seam (reference p2pfl_dataset.py:34-52)."""

    @staticmethod
    @abstractmethod
    def export(ds: Any, batch_size: int = 64, **kwargs: Any) -> Any: ...


class TorchExportStrategy(DataExportStrategy):
    """A split of numpy columns → :class:`Batches` (``export.py:103-150``
    of the reference, its column and dtype rules)."""

    @staticmethod
    def export(
        ds: Any,
        batch_size: int = 64,
        x_tag: str = "image",
        y_tag: str = "label",
        scale: float = 1.0,
        flatten: bool = False,
        drop_remainder: bool = True,
        seed: int = 0,
        x_dtype: Any = None,
        **kwargs: Any,
    ) -> Batches:
        """``ds``: a split with ``column_names`` and ``ds[column]``.
        ``x_dtype``: feature dtype; None infers it from the column:
        integer features (token ids) stay int32, everything else becomes
        float32. ``scale`` only applies to float features."""
        cols = ds.column_names
        if x_tag not in cols:
            # Fall back to the first non-label column.
            candidates = [c for c in cols if c not in (y_tag, "targets")]
            if not candidates:
                raise KeyError(f"No feature column found in {cols}")
            x_tag = candidates[0]
        if y_tag not in cols:
            # Token datasets name their labels "targets"; else take the
            # last column that isn't the feature.
            y_candidates = [c for c in cols if c != x_tag]
            if not y_candidates:
                raise KeyError(f"No label column found in {cols}")
            y_tag = "targets" if "targets" in y_candidates else y_candidates[-1]
        raw = np.asarray(ds[x_tag])
        if x_dtype is None:
            x_dtype = np.int32 if np.issubdtype(raw.dtype, np.integer) else np.float32
        x = raw.astype(x_dtype)
        if scale != 1.0 and np.issubdtype(np.dtype(x_dtype), np.floating):
            x = x * scale
        if flatten and x.ndim > 2:
            x = x.reshape(len(x), -1)
        y = np.asarray(ds[y_tag], dtype=np.int32)
        return Batches(x, y, batch_size, drop_remainder=drop_remainder, seed=seed)


__all__ = ["Batches", "DataExportStrategy", "TorchExportStrategy"]
