"""User-facing utilities — the port of :mod:`tpfl.utils`: topologies,
convergence waits, model checks, and the tree and threefry helpers the
port's modules share, and the mTLS certificate helpers of the TCP
transport (:mod:`tpfl_torch.utils.certificates`)."""

from tpfl_torch.utils.topologies import TopologyFactory, TopologyType
from tpfl_torch.utils.utils import (
    check_equal_models,
    full_connection,
    wait_convergence,
    wait_to_finish,
)

__all__ = [
    "TopologyFactory",
    "TopologyType",
    "wait_convergence",
    "wait_to_finish",
    "full_connection",
    "check_equal_models",
]
