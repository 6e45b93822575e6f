"""Aggregators: thread-safe per-round aggregation state machines whose
folds run as torch ops on the aggregator's device — the port of
:mod:`tpfl.learning.aggregators`, the robust family (Krum / MultiKrum /
TrimmedMean) included."""

from tpfl_torch.learning.aggregators.aggregator import Aggregator, NoModelsToAggregateError
from tpfl_torch.learning.aggregators.fedavg import FedAvg
from tpfl_torch.learning.aggregators.fedmedian import FedMedian
from tpfl_torch.learning.aggregators.fedprox import FedProx
from tpfl_torch.learning.aggregators.robust import Krum, MultiKrum, TrimmedMean
from tpfl_torch.learning.aggregators.scaffold import Scaffold

__all__ = ["Aggregator", "FedAvg", "FedMedian", "FedProx", "Krum", "MultiKrum",
           "NoModelsToAggregateError", "Scaffold", "TrimmedMean"]
