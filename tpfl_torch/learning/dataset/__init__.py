"""The port's dataset layer: the numpy-backed :class:`TpflDataset`, the
export to batches, the partition strategies, seeded synthetic data and
the rendered digit images (numpy only)."""

from tpfl_torch.learning.dataset.export import Batches, DataExportStrategy, TorchExportStrategy
from tpfl_torch.learning.dataset.partition_strategies import (
    DataPartitionStrategy,
    DirichletPartitionStrategy,
    LabelSkewedPartitionStrategy,
    PercentageBasedNonIIDPartitionStrategy,
    RandomIIDPartitionStrategy,
)
from tpfl_torch.learning.dataset.rendered import rendered_color_digits, rendered_digits
from tpfl_torch.learning.dataset.tpfl_dataset import ColumnSplit, TpflDataset

__all__ = ["Batches", "ColumnSplit", "DataExportStrategy", "DataPartitionStrategy",
           "DirichletPartitionStrategy", "LabelSkewedPartitionStrategy",
           "PercentageBasedNonIIDPartitionStrategy", "RandomIIDPartitionStrategy",
           "TorchExportStrategy", "TpflDataset", "rendered_color_digits", "rendered_digits"]
