"""VmapFederation — the high-level federation API over the engine,
counterpart of :class:`tpfl.parallel.federation.VmapFederation`.

All N homogeneous nodes' parameters are stacked on a leading node axis;
one round trains every node and folds them with FedAvg in one pass over
the stacked tensors — no Python loop over nodes.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from tpfl_torch import DeviceLike
from tpfl_torch.learning.torch_learner import OptimizerFactory, cross_entropy_loss
from tpfl_torch.models.zoo import Params
from tpfl_torch.parallel.engine import FederationEngine


class VmapFederation:
    """N-node federated training, vectorised over a node axis.

    Args:
        module: the model (same architecture on every node).
        n_nodes: federation size N.
        learning_rate / optimizer_factory: local optimizer (default
            SGD + momentum 0.9).
        loss_fn: (logits, labels) -> per-sample losses.
        seed: init seed (all nodes share the initial model).
        device: ``None`` = the card; ``"cpu"`` for the plain path.
    """

    def __init__(
        self,
        module: Any,
        n_nodes: int,
        mesh: Any = None,
        learning_rate: float = 0.1,
        optimizer_factory: Optional[OptimizerFactory] = None,
        loss_fn: Callable = cross_entropy_loss,
        seed: int = 0,
        algorithm: str = "fedavg",
        device: DeviceLike = None,
    ) -> None:
        self.engine = FederationEngine(
            module, n_nodes, mesh=mesh, learning_rate=learning_rate,
            optimizer_factory=optimizer_factory, loss_fn=loss_fn, seed=seed,
            algorithm=algorithm, device=device,
        )
        self.module = module
        self.n_nodes = int(n_nodes)
        self.device = self.engine.device

    def init_params(self, input_shape: tuple[int, ...]) -> Params:
        """Stacked [N, ...] params, identical across nodes."""
        return self.engine.init_params(input_shape)

    def shard_data(self, xs: Any, ys: Any) -> tuple[torch.Tensor, torch.Tensor]:
        """Node-stacked batches [N, n_batches, b, ...] on the device."""
        return self.engine.shard_data(xs, ys)

    def round(self, params: Params, xs: Any, ys: Any,
              weights: Optional[Any] = None, epochs: int = 1) -> tuple[Params, torch.Tensor]:
        """One federated round -> (new stacked params, per-node losses)."""
        return self.engine.round(params, xs, ys, weights=weights, epochs=epochs)

    def run_rounds(self, params: Params, xs: Any, ys: Any,
                   weights: Optional[Any] = None, epochs: int = 1,
                   n_rounds: int = 1) -> tuple[Params, torch.Tensor]:
        """``n_rounds`` federated rounds; returns like :meth:`round`."""
        return self.engine.run_rounds(
            params, xs, ys, weights=weights, epochs=epochs, n_rounds=n_rounds
        )

    def evaluate(self, params: Params, xs: Any, ys: Any) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-node (loss, accuracy) over node-stacked eval data."""
        return self.engine.evaluate(params, xs, ys)
