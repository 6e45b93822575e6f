"""Data partition strategies (IID and non-IID) — the port's copy of
:mod:`tpfl.learning.dataset.partition_strategies` (numpy only, no
framework): RandomIID, Dirichlet, LabelSkewed and PercentageBasedNonIID.

All strategies are pure, seeded functions from (labels, num_partitions)
to index lists, drawing from ``np.random.default_rng(seed)`` in the
reference's order, so the index lists are the reference's bit for bit.
A dataset argument is anything with ``len()`` and ``ds[label_tag]`` (a
:class:`~tpfl_torch.learning.dataset.tpfl_dataset.ColumnSplit`).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any

import numpy as np

IndexLists = list[list[int]]


def _labels(ds: Any, label_tag: str) -> np.ndarray:
    return np.asarray(ds[label_tag])


class DataPartitionStrategy(ABC):
    """Maps a train+test dataset to per-node index lists."""

    @classmethod
    @abstractmethod
    def generate_partitions(
        cls,
        train_ds: Any,
        test_ds: Any,
        num_partitions: int,
        seed: int = 666,
        label_tag: str = "label",
        **kwargs: Any,
    ) -> tuple[IndexLists, IndexLists]:
        """Return (train_index_lists, test_index_lists)."""


class RandomIIDPartitionStrategy(DataPartitionStrategy):
    """Uniform random shuffle, contiguous equal slices (reference :60-104)."""

    @classmethod
    def generate_partitions(
        cls,
        train_ds: Any,
        test_ds: Any,
        num_partitions: int,
        seed: int = 666,
        label_tag: str = "label",
        **kwargs: Any,
    ) -> tuple[IndexLists, IndexLists]:
        rng = np.random.default_rng(seed)
        return (
            cls._split(len(train_ds), num_partitions, rng),
            cls._split(len(test_ds), num_partitions, rng),
        )

    @staticmethod
    def _split(n: int, parts: int, rng: np.random.Generator) -> IndexLists:
        idx = rng.permutation(n)
        return [chunk.tolist() for chunk in np.array_split(idx, parts)]


class LabelSkewedPartitionStrategy(DataPartitionStrategy):
    """Each partition sees only ``classes_per_partition`` labels.

    The reference declares this strategy but raises NotImplementedError
    (partition_strategies.py:107,142); implemented here with the standard
    shard construction (McMahan et al. 2016 §3): sort by label, cut into
    ``num_partitions * classes_per_partition`` shards, deal each node
    ``classes_per_partition`` shards at random.
    """

    @classmethod
    def generate_partitions(
        cls,
        train_ds: Any,
        test_ds: Any,
        num_partitions: int,
        seed: int = 666,
        label_tag: str = "label",
        classes_per_partition: int = 2,
        **kwargs: Any,
    ) -> tuple[IndexLists, IndexLists]:
        rng = np.random.default_rng(seed)
        return (
            cls._shard(_labels(train_ds, label_tag), num_partitions, classes_per_partition, rng),
            cls._shard(_labels(test_ds, label_tag), num_partitions, classes_per_partition, rng),
        )

    @staticmethod
    def _shard(
        labels: np.ndarray,
        parts: int,
        classes_per_partition: int,
        rng: np.random.Generator,
    ) -> IndexLists:
        # Sort by label with a seeded shuffle inside equal labels.
        order = rng.permutation(len(labels))
        order = order[np.argsort(labels[order], kind="stable")]
        n_shards = parts * classes_per_partition
        shards = np.array_split(order, n_shards)
        deal = rng.permutation(n_shards)
        out: IndexLists = []
        for p in range(parts):
            take = deal[p * classes_per_partition : (p + 1) * classes_per_partition]
            out.append(np.concatenate([shards[s] for s in take]).tolist())
        return out


class DirichletPartitionStrategy(DataPartitionStrategy):
    """Dirichlet(alpha) label-proportion split (reference :161-430,
    itself ported from Flower). Self-balancing: partitions that already
    exceed their fair share are zeroed out of the draw; resamples until
    every partition has ``min_partition_size`` examples.
    """

    @classmethod
    def generate_partitions(
        cls,
        train_ds: Any,
        test_ds: Any,
        num_partitions: int,
        seed: int = 666,
        label_tag: str = "label",
        alpha: float = 0.5,
        min_partition_size: int = 2,
        self_balancing: bool = True,
        max_retries: int = 10,
        **kwargs: Any,
    ) -> tuple[IndexLists, IndexLists]:
        rng = np.random.default_rng(seed)
        return (
            cls._dirichlet(
                _labels(train_ds, label_tag), num_partitions, alpha,
                min_partition_size, self_balancing, max_retries, rng,
            ),
            cls._dirichlet(
                _labels(test_ds, label_tag), num_partitions, alpha,
                min_partition_size, self_balancing, max_retries, rng,
            ),
        )

    @staticmethod
    def _dirichlet(
        labels: np.ndarray,
        parts: int,
        alpha: float,
        min_size: int,
        balance: bool,
        max_retries: int,
        rng: np.random.Generator,
    ) -> IndexLists:
        classes = np.unique(labels)
        n = len(labels)
        avg = n / parts
        for attempt in range(max_retries):
            out: list[list[int]] = [[] for _ in range(parts)]
            for c in classes:
                c_idx = np.where(labels == c)[0]
                rng.shuffle(c_idx)
                props = rng.dirichlet([alpha] * parts)
                if balance:
                    # Zero out partitions already at their fair share
                    # (reference's self-balancing refinement).
                    sizes = np.array([len(p) for p in out])
                    props = np.where(sizes >= avg, 0.0, props)
                    total = props.sum()
                    if total == 0:
                        props = np.full(parts, 1.0 / parts)
                    else:
                        props = props / total
                cuts = (np.cumsum(props) * len(c_idx)).astype(int)[:-1]
                for p, chunk in enumerate(np.split(c_idx, cuts)):
                    out[p].extend(chunk.tolist())
            if min(len(p) for p in out) >= min(min_size, n // parts):
                for p in out:
                    rng.shuffle(p)
                return out
        raise ValueError(
            f"Dirichlet split failed to satisfy min_partition_size={min_size}"
            f" after {max_retries} retries (alpha={alpha}, n={n}, parts={parts})"
        )


class PercentageBasedNonIIDPartitionStrategy(DataPartitionStrategy):
    """Each partition gets ``percentage`` of its data from one dominant
    class and the rest uniformly. Empty stub in the reference
    (partition_strategies.py:433-436); implemented here.
    """

    @classmethod
    def generate_partitions(
        cls,
        train_ds: Any,
        test_ds: Any,
        num_partitions: int,
        seed: int = 666,
        label_tag: str = "label",
        percentage: float = 0.8,
        **kwargs: Any,
    ) -> tuple[IndexLists, IndexLists]:
        if not 0.0 <= percentage <= 1.0:
            raise ValueError("percentage must be in [0, 1]")
        rng = np.random.default_rng(seed)
        return (
            cls._pct(_labels(train_ds, label_tag), num_partitions, percentage, rng),
            cls._pct(_labels(test_ds, label_tag), num_partitions, percentage, rng),
        )

    @staticmethod
    def _pct(
        labels: np.ndarray, parts: int, pct: float, rng: np.random.Generator
    ) -> IndexLists:
        classes = np.unique(labels)
        per_part = len(labels) // parts
        n_dom = int(per_part * pct)
        # Pools of unused indices per class, plus a global uniform pool.
        pools = {c: list(rng.permutation(np.where(labels == c)[0])) for c in classes}
        out: IndexLists = []
        for p in range(parts):
            dom = classes[p % len(classes)]
            take = [pools[dom].pop() for _ in range(min(n_dom, len(pools[dom])))]
            # Fill the remainder round-robin from the other classes.
            rest = per_part - len(take)
            others = [c for c in classes if c != dom and pools[c]]
            while rest > 0 and others:
                for c in list(others):
                    if not pools[c]:
                        others.remove(c)
                        continue
                    take.append(pools[c].pop())
                    rest -= 1
                    if rest == 0:
                        break
            rng.shuffle(take)
            out.append([int(i) for i in take])
        return out
