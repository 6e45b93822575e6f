"""The port's dataset layer: the numpy-backed :class:`TpflDataset`, the
export to batches, and seeded synthetic data (numpy only)."""

from tpfl_torch.learning.dataset.export import Batches, DataExportStrategy, TorchExportStrategy
from tpfl_torch.learning.dataset.tpfl_dataset import ColumnSplit, TpflDataset

__all__ = ["Batches", "ColumnSplit", "DataExportStrategy", "TorchExportStrategy", "TpflDataset"]
