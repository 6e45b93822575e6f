"""FedProx — FedAvg aggregation + client-side proximal regularization
(Li et al. 2018), the port of :mod:`tpfl.learning.aggregators.fedprox`.

Server-side FedProx is FedAvg; the ``mu/2 · ||w − w_global||²`` term is
added to each client's local loss by the ``fedprox`` learner callback
(:class:`~tpfl_torch.learning.callbacks.FedProxCallback`).
"""

from __future__ import annotations

from tpfl_torch import DeviceLike
from tpfl_torch.learning.aggregators.fedavg import FedAvg
from tpfl_torch.learning.model import TpflModel


class FedProx(FedAvg):
    """FedAvg + required 'fedprox' callback injecting the proximal term."""

    REQUIRED_CALLBACKS = ["fedprox"]

    def __init__(self, node_name: str = "unknown", proximal_mu: float = 0.01,
                 device: DeviceLike = None) -> None:
        super().__init__(node_name, device=device)
        self.proximal_mu = float(proximal_mu)

    def initial_callback_info(self, name: str) -> dict:
        # Round 1 runs before any aggregate ships mu — seed it at learner
        # construction so the configured coefficient applies at once.
        return {"mu": self.proximal_mu} if name == "fedprox" else {}

    def finalize(self, state) -> TpflModel:
        # Every result path (batch, eager, partial) closes through
        # finalize, so mu rides on every aggregate.
        out = super().finalize(state)
        out.add_info("fedprox", {"mu": self.proximal_mu})
        return out
