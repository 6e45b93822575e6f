"""Federation engine — N nodes' FedAvg rounds on one device, counterpart
of :class:`tpfl.parallel.engine.FederationEngine` (``fedavg``, plain
kind, no mesh).

One round (``engine.py:1452-1584`` of the reference):

1. Local training on every node at once: ``epochs × batches`` of
   SGD+momentum over node-stacked params, the momentum trace fresh each
   round. Node ``i``'s loss depends on node ``i``'s params only, so one
   backward of the summed per-node losses gives every node its own
   gradient — the ``vmap`` of the reference, written out.
2. The masked FedAvg fold: weights normalised with a uniform-over-valid
   fallback when all are zero; rows with normalised weight 0 are zeroed
   before the f32 weighted sum.
3. The broadcast of the aggregate to every node.

``run_rounds`` is a Python loop over rounds where the reference has a
device-side ``fori_loop``. FedProx, SCAFFOLD, aux state (BatchNorm /
FedBN), meshes, in-program telemetry, wire codecs, FedBuff schedules and
attack scales are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from tpfl_torch import DeviceLike, resolve_device
from tpfl_torch.learning.torch_learner import (
    OptimizerFactory,
    cross_entropy_loss,
    default_optimizer,
)
from tpfl_torch.models.zoo import Params, init_params, stack_params
from tpfl_torch.parallel.mesh import (
    pad_node_axis,
    pad_node_weights,
    padded_node_count,
    valid_node_mask,
)
from tpfl_torch.utils.tree import tree_leaves, tree_map


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"tpfl_torch FederationEngine: {what} is not ported yet")


def _per_node_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over every axis but the leading node axis: [n, ...] -> [n]
    (``loss_fn(logits, y).mean()`` per node, ``engine.py:1131,2415``)."""
    return x.reshape(x.shape[0], -1).mean(dim=1)


class FederationEngine:
    """N-node federated training on one device.

    Args mirror the reference. ``device=None`` means the card; pass
    ``device="cpu"`` for the plain PyTorch path. Node-stacked state
    rides the padded node axis (``padded_nodes == n_nodes`` on one
    device)."""

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
        if mesh is not None:
            raise _not_ported("a device mesh")
        if algorithm != "fedavg":
            raise _not_ported(f"algorithm={algorithm!r}")
        self.device = resolve_device(device)
        self.module = module
        self.n_nodes = int(n_nodes)
        self.learning_rate = float(learning_rate)
        self._opt = (optimizer_factory or default_optimizer)(learning_rate)
        self._loss_fn = loss_fn
        self.seed = seed
        self.padded_nodes = padded_node_count(self.n_nodes)
        self.valid = valid_node_mask(self.n_nodes, self.padded_nodes, self.device)

    # --- state / data placement ---

    def init_params(self, input_shape: tuple[int, ...]) -> Params:
        """Stacked [padded_nodes, ...] params, identical across nodes.
        ``input_shape`` is one sample's: ``(H, W, C)`` for the CNN,
        ``(S,)`` for a token model."""
        one = init_params(self.module, input_shape, self.seed, self.device)
        return self.broadcast_params(one)

    def broadcast_params(self, tree: Params) -> Params:
        """One model's params broadcast onto the padded node axis."""
        return stack_params(tree, self.padded_nodes, self.device)

    def pad_stacked(self, tree: Any) -> Any:
        return pad_node_axis(tree, self.padded_nodes)

    def pad_weights(self, weights: Optional[Any]) -> torch.Tensor:
        """[n] (or per-round [R, n]) weights -> padded f32 on the device;
        None -> uniform full participation."""
        if weights is None:
            weights = torch.ones((self.n_nodes,), dtype=torch.float32)
        w = torch.as_tensor(weights, dtype=torch.float32).to(self.device)
        return pad_node_weights(w, self.padded_nodes)

    def shard_data(self, xs: Any, ys: Any) -> tuple[torch.Tensor, torch.Tensor]:
        """Node-stacked data [N, n_batches, b, ...] on the device (the
        dtype of ``xs`` is kept: feed bf16 to halve its reads; integer
        tokens stay integer)."""
        xs = torch.as_tensor(xs).to(self.device)
        ys = torch.as_tensor(ys).to(self.device, torch.long)
        return self.pad_stacked(xs), self.pad_stacked(ys)

    # --- the round ---

    def _node_losses(self, params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Per-node mean loss [n] of x [n, b, ...], y [n, b, ...]: the
        mean over every sample (and token) of a node."""
        logits = self.module(params, x)
        return _per_node_mean(self._loss_fn(logits, y))

    def _local_train(self, params: Params, xs: torch.Tensor, ys: torch.Tensor,
                     epochs: int) -> tuple[Params, torch.Tensor]:
        """Every node's local fit (``engine.py:1103-1189``, plain kind):
        returns (trained params, last epoch's mean batch loss [n])."""
        if epochs <= 0:  # aggregation-only round
            with torch.no_grad():
                return params, self._node_losses(params, xs[:, 0], ys[:, 0])
        opt = self._opt
        trace = opt.init(params)
        loss = torch.zeros((xs.shape[0],), dtype=torch.float32, device=xs.device)
        for _ in range(epochs):
            losses = []
            for bi in range(xs.shape[1]):
                leaves = tree_map(lambda v: v.detach().requires_grad_(True), params)
                per_node = self._node_losses(leaves, xs[:, bi], ys[:, bi])
                grads_flat = torch.autograd.grad(per_node.sum(), tree_leaves(leaves))
                it = iter(grads_flat)
                grads = tree_map(lambda _v: next(it), leaves)
                params, trace = opt.step(params, grads, trace)
                losses.append(per_node.detach())
            loss = torch.stack(losses).mean(dim=0)
        return params, loss

    @staticmethod
    def _fold_weights(weights: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """``weights / Σweights``, uniform over real nodes when all-zero
        (``engine.py:1192-1211``)."""
        total = weights.sum()
        fallback = valid / torch.clamp(valid.sum(), min=1.0)
        return torch.where(total > 0, weights / torch.clamp(total, min=1e-9), fallback)

    def _fold(self, trained: Params, weights: torch.Tensor) -> Params:
        """Masked FedAvg fold + broadcast (``engine.py:1237-1273``)."""
        wnorm = self._fold_weights(weights, self.valid).to(torch.float32)
        n_local = weights.shape[0]

        def leaf_mean(p: torch.Tensor) -> torch.Tensor:
            sel = (wnorm > 0).reshape((-1,) + (1,) * (p.dim() - 1))
            # w=0 rows are zeroed BEFORE the sum: 0 · inf would be NaN.
            clean = torch.where(sel, p.to(torch.float32), torch.zeros((), device=p.device))
            agg = torch.tensordot(wnorm, clean, dims=1).to(p.dtype)
            return agg[None].expand(n_local, *agg.shape).clone()

        with torch.no_grad():
            return tree_map(leaf_mean, trained)

    def _round(self, params: Params, xs: torch.Tensor, ys: torch.Tensor,
               w: torch.Tensor, epochs: int) -> tuple[Params, torch.Tensor]:
        trained, losses = self._local_train(params, xs, ys, epochs)
        return self._fold(trained, w), losses

    def round(self, params: Params, xs: Any, ys: Any,
              weights: Optional[Any] = None, epochs: int = 1,
              **unported: Any) -> tuple[Params, torch.Tensor]:
        """One federated round: ``run_rounds`` with ``n_rounds=1``."""
        return self.run_rounds(params, xs, ys, weights=weights, epochs=epochs,
                               n_rounds=1, **unported)

    def run_rounds(
        self,
        params: Params,
        xs: Any,
        ys: Any,
        weights: Optional[Any] = None,
        epochs: int = 1,
        n_rounds: int = 1,
        aux: Optional[Any] = None,
        scaffold_state: Optional[Any] = None,
        attack_scales: Optional[Any] = None,
        schedule: Optional[Any] = None,
    ) -> tuple[Params, torch.Tensor]:
        """``n_rounds`` federation rounds over the same node-stacked data.

        ``weights``: [n] per-node FedAvg weight (0 = not elected), or
        [n_rounds, n] per round; None = uniform. Returns
        ``(params, losses)`` — ``losses`` is the LAST round's per-node
        loss vector (padded length)."""
        for name, val in (("aux state", aux), ("scaffold_state", scaffold_state),
                          ("attack_scales", attack_scales), ("a FedBuff schedule", schedule)):
            if val is not None:
                raise _not_ported(name)
        w = self.pad_weights(weights)
        if w.dim() == 2 and w.shape[0] != n_rounds:
            raise ValueError(
                f"per-round weights have {w.shape[0]} rows for {n_rounds} rounds"
            )
        params = self.pad_stacked(params)
        xs, ys = self.shard_data(xs, ys)
        losses = torch.zeros((self.padded_nodes,), dtype=torch.float32, device=self.device)
        for r in range(n_rounds):
            params, losses = self._round(
                params, xs, ys, w if w.dim() == 1 else w[r], epochs
            )
        return params, losses

    # --- evaluation ---

    @torch.no_grad()
    def evaluate(self, params: Params, xs: Any, ys: Any) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-node (loss, accuracy) over node-stacked eval data
        [n, n_batches, b, ...]: means over batches of each batch's mean
        over samples (and tokens: a token model's accuracy is per
        token)."""
        params = self.pad_stacked(params)
        xs, ys = self.shard_data(xs, ys)
        losses, accs = [], []
        for bi in range(xs.shape[1]):
            logits = self.module(params, xs[:, bi])
            losses.append(_per_node_mean(self._loss_fn(logits, ys[:, bi])))
            accs.append(_per_node_mean((logits.argmax(-1) == ys[:, bi]).to(torch.float32)))
        return torch.stack(losses).mean(0), torch.stack(accs).mean(0)
