"""The port's partition strategies
(tpfl_torch.learning.dataset.partition_strategies) against the JAX
package's, on the CPU: the same labels, node counts and seeds give the
same index lists, bit for bit, for RandomIID, Dirichlet, LabelSkewed and
PercentageBasedNonIID; ``TpflDataset.generate_partitions`` splits both
datasets into the same rows.
"""

import numpy as np
import pytest

from tpfl.learning.dataset import TpflDataset as JaxDataset
from tpfl.learning.dataset import partition_strategies as jps
from tpfl_torch.learning.dataset import TpflDataset
from tpfl_torch.learning.dataset import partition_strategies as tps
from tpfl_torch.learning.dataset.tpfl_dataset import ColumnSplit

STRATEGIES = {
    "iid": ("RandomIIDPartitionStrategy", {}),
    "dirichlet": ("DirichletPartitionStrategy", {"alpha": 0.5}),
    "dirichlet_unbalanced": ("DirichletPartitionStrategy",
                             {"alpha": 0.3, "self_balancing": False, "min_partition_size": 1}),
    "label_skew": ("LabelSkewedPartitionStrategy", {"classes_per_partition": 2}),
    "percentage": ("PercentageBasedNonIIDPartitionStrategy", {"percentage": 0.7}),
}


def _labels(seed, n, classes=10):
    return np.random.default_rng(seed).integers(0, classes, n).astype(np.int64)


@pytest.mark.parametrize("nodes", [2, 5, 7])
@pytest.mark.parametrize("seed", [0, 666, 12345])
@pytest.mark.parametrize("kind", list(STRATEGIES))
def test_index_lists_bit_equal(kind, seed, nodes):
    name, kw = STRATEGIES[kind]
    # Both take any dataset with len() and ds["label"].
    train = ColumnSplit({"label": _labels(seed, 301)})
    test = ColumnSplit({"label": _labels(seed + 1, 97)})
    want = getattr(jps, name).generate_partitions(train, test, nodes, seed=seed, **kw)
    got = getattr(tps, name).generate_partitions(train, test, nodes, seed=seed, **kw)
    assert got == want


def test_percentage_rejects_out_of_range():
    with pytest.raises(ValueError, match="percentage"):
        tps.PercentageBasedNonIIDPartitionStrategy.generate_partitions(
            ColumnSplit({"label": _labels(0, 10)}), ColumnSplit({"label": _labels(1, 5)}), 2,
            percentage=1.5)


@pytest.mark.parametrize("kind", ["iid", "dirichlet"])
def test_generate_partitions_selects_the_same_rows(kind):
    name, kw = STRATEGIES[kind]
    rng = np.random.default_rng(4)
    x, xt = rng.uniform(size=(120, 3)).astype(np.float32), rng.uniform(size=(40, 3))
    y, yt = _labels(2, 120), _labels(3, 40)
    jparts = JaxDataset.from_arrays(x, y, xt.astype(np.float32), yt).generate_partitions(
        4, getattr(jps, name), seed=9, **kw)
    tparts = TpflDataset.from_arrays(x, y, xt.astype(np.float32), yt).generate_partitions(
        4, getattr(tps, name), seed=9, **kw)
    assert len(tparts) == len(jparts) == 4
    for jp, tp in zip(jparts, tparts):
        for train in (True, False):
            assert tp.num_samples(train) == jp.num_samples(train)
            np.testing.assert_array_equal(tp.get_split(train)["image"],
                                          np.asarray(jp.get_split(train)["image"]))
            np.testing.assert_array_equal(tp.get_split(train)["label"],
                                          np.asarray(jp.get_split(train)["label"]))
