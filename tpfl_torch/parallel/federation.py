"""VmapFederation — the high-level federation API over the engine,
counterpart of :class:`tpfl.parallel.federation.VmapFederation`.

All N homogeneous nodes' parameters are stacked on a leading node axis;
one round trains every node and folds them in one pass over the stacked
tensors — no Python loop over nodes.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from tpfl_torch import DeviceLike
from tpfl_torch.learning.torch_learner import OptimizerFactory, cross_entropy_loss
from tpfl_torch.management import profiling
from tpfl_torch.models.zoo import Params
from tpfl_torch.parallel.engine import DENSE, FederationEngine


class VmapFederation:
    """N-node federated training, vectorised over a node axis.

    Args:
        module: the model (same architecture on every node).
        n_nodes: federation size N.
        mesh: None (one device), a ``DeviceMesh`` or ``"auto"``: the
            engine's (:class:`~tpfl_torch.parallel.engine.FederationEngine`).
        learning_rate / optimizer_factory: local optimizer (default
            SGD + momentum 0.9).
        loss_fn: (logits, labels) -> per-sample losses.
        seed: init seed (all nodes share the initial model).
        aux_mode: how BatchNorm stats fold — "mean" (with the params'
            weights) or "local" (FedBN: each node that took part keeps
            its own).
        algorithm: "fedavg", "fedprox" (a proximal pull
            ``mu/2·||w − w_round_start||²`` on every local loss) or
            "scaffold" (control-variate-corrected local steps; carry
            the state from :meth:`init_scaffold_state` through
            ``round(..., scaffold_state=...)``, option II).
        prox_mu: FedProx's proximal coefficient.
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
        aux_mode: str = "mean",
        algorithm: str = "fedavg",
        prox_mu: float = 0.01,
        device: DeviceLike = None,
    ) -> None:
        self.engine = FederationEngine(
            module, n_nodes, mesh=mesh, learning_rate=learning_rate,
            optimizer_factory=optimizer_factory, loss_fn=loss_fn, seed=seed,
            aux_mode=aux_mode, algorithm=algorithm, prox_mu=prox_mu, device=device,
        )
        self.module = module
        self.n_nodes = int(n_nodes)
        self.device = self.engine.device
        self.learning_rate = float(learning_rate)
        self.seed = seed
        self.aux_mode = aux_mode
        self.algorithm = algorithm
        self.prox_mu = float(prox_mu)
        # The round function per variant ("", "_aux", "_scaffold") behind
        # the compile observatory, as the reference wraps its jitted ones.
        self._round_fns: dict[str, Callable] = {}

    def init_state(self, input_shape: tuple[int, ...]) -> tuple[Params, Params]:
        """(stacked params, stacked aux) — aux is ``{}`` for modules
        without mutable collections, else ``{"batch_stats": ...}``
        (ResNet-18)."""
        return self.engine.init_state(input_shape)

    def init_params(self, input_shape: tuple[int, ...]) -> Params:
        """Stacked [N, ...] params, identical across nodes (aux-free
        modules)."""
        return self.engine.init_params(input_shape)

    def init_scaffold_state(self, params: Params) -> tuple[Params, Params]:
        """(c_locals [N, ...], c_global [...]) — zero control variates."""
        return self.engine.init_scaffold_state(params)

    def shard_data(self, xs: Any, ys: Any) -> tuple[torch.Tensor, torch.Tensor]:
        """Node-stacked batches [N, n_batches, b, ...] on the device."""
        return self.engine.shard_data(xs, ys)

    def round(self, params: Params, xs: Any, ys: Any, weights: Optional[Any] = None,
              epochs: int = 1, aux: Optional[Any] = None,
              scaffold_state: Optional[tuple[Any, Any]] = None) -> tuple:
        """One federated round, with no wire codec (the reference's
        round program, whatever ``ENGINE_WIRE_CODEC`` says), donating its
        state as the reference's round programs do: a caller tensor that
        already is window state holds the outputs afterwards. Returns
        ``(params, losses)``; with ``aux`` (possibly ``{}``) ``(params,
        aux, losses)``; with algorithm="scaffold" ``(params, aux,
        (c_locals, c_global), losses)`` (``aux`` is ``{}`` for aux-free
        modules)."""
        variant = ("_scaffold" if self.algorithm == "scaffold"
                   else "_aux" if aux is not None else "")
        fn = self._round_fns.get(variant)
        if fn is None:
            fn = self._round_fns[variant] = profiling.observatory.wrap(
                self.engine._window, f"vmap_round{variant}:{profiling.module_tag(self.module)}")
        return fn(params, xs, ys, weights, epochs, 1, aux, scaffold_state, DENSE)

    def run_rounds(self, params: Params, xs: Any, ys: Any, weights: Optional[Any] = None,
                   epochs: int = 1, n_rounds: int = 1, aux: Optional[Any] = None,
                   scaffold_state: Optional[tuple[Any, Any]] = None,
                   donate: Optional[bool] = None, schedule: Optional[Any] = None) -> tuple:
        """``n_rounds`` federated rounds through the engine (the wire codec
        as ``Settings.ENGINE_WIRE_CODEC`` says, ``donate`` as
        :meth:`FederationEngine.run_rounds` takes it); returns like
        :meth:`round`."""
        return self.engine.run_rounds(
            params, xs, ys, weights=weights, epochs=epochs, n_rounds=n_rounds, aux=aux,
            scaffold_state=scaffold_state, donate=donate, schedule=schedule,
        )

    def evaluate(self, params: Params, xs: Any, ys: Any,
                 aux: Optional[Any] = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-node (loss, accuracy) over node-stacked eval data."""
        return self.engine.evaluate(params, xs, ys, aux=aux)
