"""Federation engine — N nodes' federated rounds on one device, counterpart
of :class:`tpfl.parallel.engine.FederationEngine` (no mesh).

One round (``engine.py:1452-1584`` of the reference):

1. Local training on every node at once: ``epochs × batches`` of
   SGD+momentum over node-stacked params, the momentum trace fresh each
   round. Node ``i``'s loss depends on node ``i``'s params only, so one
   backward of the summed per-node losses gives every node its own
   gradient — the ``vmap`` of the reference, written out.
2. With ``attack_scales`` (an ``AttackPlan``'s sign-flip schedule,
   ``AttackPlan.engine_scales``), every node's trained params are
   multiplied by its scale, cast to the leaf's dtype. Then, with
   ``Settings.ENGINE_WIRE_CODEC`` other than "dense", every node's
   trained params pass the wire codec's round trip (params only).
3. The masked FedAvg fold: weights normalised with a uniform-over-valid
   fallback when all are zero; rows with normalised weight 0 are zeroed
   before the f32 weighted sum. Then the broadcast of the aggregate to
   every node.

The three algorithms and three kinds of the reference (``_kind``,
``engine.py:1080``):

- ``fedavg``; ``fedprox`` adds ``mu/2·||p − p0||²`` to each node's loss
  (``p0`` the node's round-start params);
- the **plain** kind trains with ``train=False`` and threads no state;
- the **aux** kind (``aux`` passed: BatchNorm ``batch_stats``) trains
  with ``train=True`` and threads the new stats, which the fold averages
  with the params' weights (``aux_mode="mean"``) or keeps on each node
  that took part (``"local"``, FedBN);
- the **scaffold** kind (``algorithm="scaffold"``) adds the fixed
  correction ``c_g − c_i`` to every gradient, updates ``c_i`` by option
  II and ``c_g`` by the server rule in the fold.

``run_rounds`` is a Python loop over rounds where the reference has a
device-side ``fori_loop``. Meshes and FedBuff schedules are not ported
yet and raise ``NotImplementedError``, as do the in-program telemetry
carry and the other switches of ``settings.UNPORTED_SWITCHES`` at
construction.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from tpfl_torch import DeviceLike, resolve_device
from tpfl_torch.learning import compression
from tpfl_torch.learning.torch_learner import (
    OptimizerFactory,
    cross_entropy_loss,
    default_optimizer,
)
from tpfl_torch.models.zoo import Params, apply, init_state, stack_params
from tpfl_torch.parallel.mesh import (
    pad_node_axis,
    pad_node_weights,
    padded_node_count,
    valid_node_mask,
)
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import tree_leaves, tree_map

_ALGORITHMS = ("fedavg", "fedprox", "scaffold")

#: (codec bits, top-k fraction) of a round without a wire codec.
DENSE = (0, 0.05)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"tpfl_torch FederationEngine: {what} is not ported yet")


def _per_node_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over every axis but the leading node axis: [n, ...] -> [n]
    (``loss_fn(logits, y).mean()`` per node, ``engine.py:1131,2415``)."""
    return x.reshape(x.shape[0], -1).mean(dim=1)


def _rows(sel: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A [n] mask shaped to broadcast over a node-stacked leaf."""
    return sel.reshape((-1,) + (1,) * (like.dim() - 1))


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
        aux_mode: str = "mean",
        algorithm: str = "fedavg",
        prox_mu: float = 0.01,
        device: DeviceLike = None,
    ) -> None:
        if aux_mode not in ("mean", "local"):
            raise ValueError(f"aux_mode must be 'mean' or 'local', got {aux_mode!r}")
        if algorithm not in _ALGORITHMS:
            raise ValueError(
                f"algorithm must be one of {_ALGORITHMS}, got {algorithm!r}"
            )
        if mesh is not None:
            raise _not_ported("a device mesh")
        Settings.refuse_unported("engine")
        self.device = resolve_device(device)
        self.module = module
        self.n_nodes = int(n_nodes)
        self.learning_rate = float(learning_rate)
        self._opt = (optimizer_factory or default_optimizer)(learning_rate)
        self._loss_fn = loss_fn
        self.seed = seed
        self.aux_mode = aux_mode
        self.algorithm = algorithm
        self.prox_mu = float(prox_mu)
        self.padded_nodes = padded_node_count(self.n_nodes)
        self.valid = valid_node_mask(self.n_nodes, self.padded_nodes, self.device)

    # --- state / data placement ---

    def init_state(self, input_shape: tuple[int, ...]) -> tuple[Params, Params]:
        """(stacked params, stacked aux), identical across nodes — aux is
        ``{}`` for modules without mutable collections. ``input_shape``
        is one sample's: ``(H, W, C)`` for images, ``(S,)`` for a token
        model."""
        params, aux = init_state(self.module, input_shape, self.seed, self.device)
        return self.broadcast_params(params), self.broadcast_params(aux)

    def init_params(self, input_shape: tuple[int, ...]) -> Params:
        """Stacked [padded_nodes, ...] params (aux-free modules)."""
        params, aux = self.init_state(input_shape)
        if aux:
            raise ValueError(
                f"Module has mutable collections {sorted(aux)} — use "
                f"init_state() and pass aux to round()/evaluate()."
            )
        return params

    def init_scaffold_state(self, params: Params) -> tuple[Params, Params]:
        """(c_locals [padded, ...], c_global [...]): zero control
        variates; ``c_global`` is one unstacked tree."""
        c_locals = tree_map(torch.zeros_like, params)
        c_global = tree_map(lambda p: torch.zeros(p.shape[1:], dtype=p.dtype, device=p.device),
                            params)
        return c_locals, c_global

    def broadcast_params(self, tree: Params) -> Params:
        """One model's tree broadcast onto the padded node axis."""
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

    def pad_attack_scales(self, scales: Any) -> torch.Tensor:
        """[n] (or per-round [R, n]) per-node attack multipliers -> padded
        f32 on the device, pad entries one (a pad row's params ride
        untouched: its fold weight is already zero)."""
        s = torch.as_tensor(scales, dtype=torch.float32).to(self.device)
        if s.shape[-1] != self.n_nodes:
            raise ValueError(
                f"attack_scales last axis is {s.shape[-1]} for {self.n_nodes} nodes")
        extra = self.padded_nodes - self.n_nodes
        if extra == 0:
            return s
        pad = torch.ones(s.shape[:-1] + (extra,), dtype=torch.float32, device=self.device)
        return torch.cat([s, pad], dim=-1)

    def shard_data(self, xs: Any, ys: Any) -> tuple[torch.Tensor, torch.Tensor]:
        """Node-stacked data [N, n_batches, b, ...] on the device (the
        dtype of ``xs`` is kept: feed bf16 to halve its reads; integer
        tokens stay integer)."""
        xs = torch.as_tensor(xs).to(self.device)
        ys = torch.as_tensor(ys).to(self.device, torch.long)
        return self.pad_stacked(xs), self.pad_stacked(ys)

    # --- the round ---

    def _kind(self, aux: Optional[Any]) -> str:
        if self.algorithm == "scaffold":
            return "scaffold"
        return "aux" if aux is not None else "plain"

    def _prox(self, p: Params, p0: Params) -> torch.Tensor:
        """FedProx's ``mu/2·||p − p0||²`` per node [n], in f32
        (``engine.py:1084-1101``)."""
        sq = sum(((a.to(torch.float32) - b.to(torch.float32)) ** 2).reshape(a.shape[0], -1).sum(1)
                 for a, b in zip(tree_leaves(p), tree_leaves(p0)))
        return 0.5 * self.prox_mu * sq

    def _local_train(self, kind: str, params: Params, c_i: Params, c_g: Params, aux: Params,
                     xs: torch.Tensor, ys: torch.Tensor,
                     epochs: int) -> tuple[Params, Params, Params, torch.Tensor]:
        """Every node's local fit (``engine.py:1103-1189``): returns
        (trained params, new c_i, new aux, last epoch's mean batch loss
        [n]). ``c_i`` / ``c_g`` / ``aux`` are ``{}`` for kinds that do
        not thread them."""
        module, loss_fn = self.module, self._loss_fn
        if epochs <= 0:  # aggregation-only round
            with torch.no_grad():
                logits, _ = apply(module, params, aux, xs[:, 0], train=False)
                return params, c_i, aux, _per_node_mean(loss_fn(logits, ys[:, 0]))
        p0 = params  # round-start weights (FedProx anchor, SCAFFOLD's x)
        train = kind != "plain"
        prox = self.algorithm == "fedprox"
        corr = {}
        if kind == "scaffold":  # fixed for the round
            corr = tree_map(lambda c, ci: (c - ci).to(c.dtype), c_g, c_i)
        opt = self._opt
        trace = opt.init(params)
        loss = torch.zeros((xs.shape[0],), dtype=torch.float32, device=xs.device)
        for _ in range(epochs):
            losses = []
            for bi in range(xs.shape[1]):
                leaves = tree_map(lambda v: v.detach().requires_grad_(True), params)
                logits, new_aux = apply(module, leaves, aux, xs[:, bi], train=train)
                per_node = _per_node_mean(loss_fn(logits, ys[:, bi]))
                if prox:
                    per_node = per_node + self._prox(leaves, p0)
                grads_flat = torch.autograd.grad(per_node.sum(), tree_leaves(leaves))
                it = iter(grads_flat)
                grads = tree_map(lambda _v: next(it), leaves)
                if kind == "scaffold":
                    grads = tree_map(lambda g, c: g + c.to(g.dtype), grads, corr)
                params, trace = opt.step(params, grads, trace)
                aux = new_aux
                losses.append(per_node.detach())
            loss = torch.stack(losses).mean(dim=0)
        if kind == "scaffold":
            # Option II: c_i+ = c_i − c + (x − y)/(K·lr), in f32.
            scale = 1.0 / max(epochs * xs.shape[1] * self.learning_rate, 1e-12)
            f32 = torch.float32
            with torch.no_grad():
                c_i = tree_map(
                    lambda ci, cg, x0, y: (ci.to(f32) - cg.to(f32)
                                           + scale * (x0.to(f32) - y.to(f32))).to(ci.dtype),
                    c_i, c_g, p0, params)
        return params, c_i, aux, loss

    @staticmethod
    def _fold_weights(weights: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """``weights / Σweights``, uniform over real nodes when all-zero
        (``engine.py:1192-1211``)."""
        total = weights.sum()
        fallback = valid / torch.clamp(valid.sum(), min=1.0)
        return torch.where(total > 0, weights / torch.clamp(total, min=1e-9), fallback)

    @staticmethod
    def _leaf_mean(wnorm: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """Σ_n wnorm[n]·p[n] in f32, cast back to p's dtype; w=0 rows are
        zeroed BEFORE the sum: 0 · inf would be NaN."""
        w = wnorm.to(torch.float32)
        clean = torch.where(_rows(w > 0, p), p.to(torch.float32),
                            torch.zeros((), device=p.device))
        return torch.tensordot(w, clean, dims=1).to(p.dtype)

    def _diffuse(self, tree: Params, wnorm: torch.Tensor) -> Params:
        """The weighted mean of every leaf, broadcast back to every node."""
        n = wnorm.shape[0]

        def leaf(p: torch.Tensor) -> torch.Tensor:
            agg = self._leaf_mean(wnorm, p)
            return agg[None].expand(n, *agg.shape).clone()

        return tree_map(leaf, tree)

    @torch.no_grad()
    def _fold(self, kind: str, trained: Params, new_c: Params, new_aux: Params,
              c_locals: Params, c_global: Params, aux: Params,
              weights: torch.Tensor) -> tuple[Params, Params, Params, Params]:
        """Masked FedAvg fold + broadcast, the SCAFFOLD server update and
        the aux aggregation (``engine.py:1237-1319``): (params, c_locals,
        c_global, aux)."""
        wnorm = self._fold_weights(weights, self.valid)
        out_params = self._diffuse(trained, wnorm)
        sel = weights > 0

        def keep_elected(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
            return torch.where(_rows(sel, new), new, old)

        out_c, out_cg = c_locals, c_global
        if kind == "scaffold":
            out_c = tree_map(keep_elected, new_c, c_locals)
            # c += (|S|/N) · uniform mean over ELECTED of delta_c, N the
            # LOGICAL federation size (pad rows are never elected).
            mask = sel.to(torch.float32)
            um = self._fold_weights(mask, self.valid)
            frac = mask.sum() / self.n_nodes
            f32 = torch.float32
            out_cg = tree_map(
                lambda cg, n, o: (cg.to(f32) + frac * self._leaf_mean(
                    um, n.to(f32) - o.to(f32))).to(cg.dtype),
                c_global, new_c, c_locals)
        if kind == "plain":
            out_aux = aux
        elif self.aux_mode == "local":
            # FedBN: stats stay per node — a w=0 node did not take part,
            # so its private stats do not advance.
            out_aux = tree_map(keep_elected, new_aux, aux)
        else:
            out_aux = self._diffuse(new_aux, wnorm)
        return out_params, out_c, out_cg, out_aux

    def _round(self, kind: str, state: tuple, xs: torch.Tensor, ys: torch.Tensor,
               w: torch.Tensor, epochs: int, codec: Callable,
               scale: Optional[torch.Tensor] = None) -> tuple[tuple, torch.Tensor]:
        params, c_locals, c_global, aux = state
        trained, new_c, new_aux, losses = self._local_train(
            kind, params, c_locals, c_global, aux, xs, ys, epochs)
        with torch.no_grad():  # the exchange leg: params only
            if scale is not None:  # the seeded adversary (engine.py:1467-1475)
                trained = tree_map(lambda t: _rows(scale, t).to(t.dtype) * t, trained)
            trained = tree_map(codec, trained)
        return self._fold(kind, trained, new_c, new_aux, c_locals, c_global, aux, w), losses

    def round(self, params: Params, xs: Any, ys: Any, weights: Optional[Any] = None,
              epochs: int = 1, aux: Optional[Any] = None,
              scaffold_state: Optional[tuple[Any, Any]] = None) -> tuple:
        """One federated round: ``run_rounds`` with ``n_rounds=1``."""
        return self.run_rounds(params, xs, ys, weights=weights, epochs=epochs, n_rounds=1,
                               aux=aux, scaffold_state=scaffold_state)

    def run_rounds(
        self,
        params: Params,
        xs: Any,
        ys: Any,
        weights: Optional[Any] = None,
        epochs: int = 1,
        n_rounds: int = 1,
        aux: Optional[Any] = None,
        scaffold_state: Optional[tuple[Any, Any]] = None,
        attack_scales: Optional[Any] = None,
        schedule: Optional[Any] = None,
    ) -> tuple:
        """``n_rounds`` federation rounds over the same node-stacked data.

        ``weights``: [n] per-node FedAvg weight (0 = not elected), or
        [n_rounds, n] per round; None = uniform. The wire codec is read
        from ``Settings.ENGINE_WIRE_CODEC`` / ``WIRE_TOPK_FRAC`` on each
        call. ``attack_scales`` ([n] or [n_rounds, n]): per-node
        multipliers of each node's trained params before the codec leg
        and the fold — ``AttackPlan.engine_scales``'s seeded sign-flip
        adversary; None runs no attack op at all.

        Returns (params, losses) — with ``aux`` (possibly ``{}``)
        (params, aux, losses) — and for algorithm="scaffold"
        (params, aux, (c_locals, c_global), losses). ``losses`` is the
        LAST round's per-node loss vector (padded length)."""
        codec = (compression.resolve_engine_codec(Settings.ENGINE_WIRE_CODEC),
                 float(Settings.WIRE_TOPK_FRAC))
        return self._window(params, xs, ys, weights, epochs, n_rounds, aux, scaffold_state,
                           codec, attack_scales, schedule)

    def _window(self, params: Params, xs: Any, ys: Any, weights: Optional[Any], epochs: int,
               n_rounds: int, aux: Optional[Any], scaffold_state: Optional[tuple[Any, Any]],
               codec: tuple[int, float], attack_scales: Optional[Any] = None,
               schedule: Optional[Any] = None) -> tuple:
        """:meth:`run_rounds` with the codec given as (bits, top-k
        fraction) instead of read from the knobs."""
        if schedule is not None:
            raise _not_ported("a FedBuff schedule")
        kind = self._kind(aux)
        if kind == "scaffold" and scaffold_state is None:
            raise ValueError(
                "algorithm='scaffold' requires scaffold_state "
                "(init_scaffold_state(params))"
            )
        w = self.pad_weights(weights)
        if w.dim() == 2 and w.shape[0] != n_rounds:
            raise ValueError(
                f"per-round weights have {w.shape[0]} rows for {n_rounds} rounds"
            )
        scales = None
        if attack_scales is not None:
            scales = self.pad_attack_scales(attack_scales)
            if scales.dim() == 2 and scales.shape[0] != n_rounds:
                raise ValueError(
                    f"per-round attack_scales have {scales.shape[0]} rows for {n_rounds} rounds"
                )
        c_locals, c_global = {}, {}
        if kind == "scaffold":
            c_locals, c_global = scaffold_state
            c_locals = self.pad_stacked(c_locals)
        state = (self.pad_stacked(params), c_locals, c_global,
                 {} if aux is None else self.pad_stacked(aux))
        xs, ys = self.shard_data(xs, ys)
        roundtrip = compression.engine_codec_roundtrip_nodes(*codec)
        losses = torch.zeros((self.padded_nodes,), dtype=torch.float32, device=self.device)
        for r in range(n_rounds):
            scale = None if scales is None else scales if scales.dim() == 1 else scales[r]
            state, losses = self._round(
                kind, state, xs, ys, w if w.dim() == 1 else w[r], epochs, roundtrip, scale)
        params, c_locals, c_global, aux_out = state
        if kind == "scaffold":
            return params, aux_out, (c_locals, c_global), losses
        if aux is not None:
            return params, aux_out, losses
        return params, losses

    # --- evaluation ---

    @torch.no_grad()
    def evaluate(self, params: Params, xs: Any, ys: Any,
                 aux: Optional[Any] = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-node (loss, accuracy) over node-stacked eval data
        [n, n_batches, b, ...]: means over batches of each batch's mean
        over samples (and tokens: a token model's accuracy is per
        token). With ``aux``, BatchNorm uses the running averages."""
        params = self.pad_stacked(params)
        aux = {} if aux is None else self.pad_stacked(aux)
        xs, ys = self.shard_data(xs, ys)
        losses, accs = [], []
        for bi in range(xs.shape[1]):
            logits, _ = apply(self.module, params, aux, xs[:, bi], train=False)
            losses.append(_per_node_mean(self._loss_fn(logits, ys[:, bi])))
            accs.append(_per_node_mean((logits.argmax(-1) == ys[:, bi]).to(torch.float32)))
        return torch.stack(losses).mean(0), torch.stack(accs).mean(0)
