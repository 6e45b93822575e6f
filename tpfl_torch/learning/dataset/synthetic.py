"""Seeded synthetic classification data, numpy only — a copy of the
generators in :mod:`tpfl.learning.dataset.synthetic`: the classification
generators return plain arrays, :func:`synthetic_mnist` a
``TpflDataset`` as the reference's does.

Each class has a fixed random prototype; samples are prototype plus
Gaussian noise, clipped to [0, 1]. A small model separates them
quickly, and the same seed gives the same arrays as the reference.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from tpfl_torch.learning.dataset.tpfl_dataset import TpflDataset

Arrays = tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def synthetic_classification(
    shape: tuple[int, ...],
    n_classes: int = 10,
    n_train: int = 1000,
    n_test: int = 200,
    noise: float = 0.8,
    seed: int = 0,
) -> Arrays:
    """(x_train f32, y_train int32, x_test, y_test), images in [0, 1]."""
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0.0, 1.0, size=(n_classes, *shape)).astype(np.float32)

    def make(n: int) -> tuple[np.ndarray, np.ndarray]:
        y = rng.integers(0, n_classes, size=n).astype(np.int32)
        x = protos[y] + rng.normal(0.0, noise, size=(n, *shape)).astype(np.float32)
        return np.clip(x, 0.0, 1.0), y

    x_tr, y_tr = make(n_train)
    x_te, y_te = make(n_test)
    return x_tr, y_tr, x_te, y_te


def synthetic_cifar10(
    n_train: int = 1000, n_test: int = 200, seed: int = 0, noise: float = 0.8
) -> Arrays:
    """32×32×3, 10 classes — CIFAR-10-shaped."""
    return synthetic_classification(
        (32, 32, 3), n_classes=10, n_train=n_train, n_test=n_test, seed=seed,
        noise=noise,
    )


def synthetic_mnist(
    n_train: int = 1000, n_test: int = 200, seed: int = 0, noise: float = 0.8
) -> "TpflDataset":
    """28×28 grayscale, 10 classes — MNIST-shaped, as a
    :class:`~tpfl_torch.learning.dataset.TpflDataset` (columns ``image``
    / ``label``), the reference's ``synthetic_mnist``."""
    from tpfl_torch.learning.dataset.tpfl_dataset import TpflDataset

    return TpflDataset.from_arrays(*synthetic_classification(
        (28, 28), n_classes=10, n_train=n_train, n_test=n_test, seed=seed, noise=noise))
