"""FederationLearner — one protocol Node wrapping a whole federation on the
card, the port of :mod:`tpfl.parallel.federation_learner`.

Within a host, nodes are rows of a
:class:`~tpfl_torch.parallel.federation.VmapFederation`: local training
and the exact FedAvg fold run node-stacked on the device. Between hosts,
each host takes part in the gossip protocol as ONE Node (votes,
heartbeats, model gossip), contributing its locally aggregated model
weighted by its sample count. A 2-host × 8-local-node deployment runs the
wire protocol of a 2-node federation while training 16 logical nodes.

``fit`` runs ``local_rounds`` rounds in windows of
``Settings.SHARD_ROUNDS_PER_DISPATCH`` — through the
:class:`~tpfl_torch.parallel.window_pipeline.WindowPipeline` under
``Settings.ENGINE_PREFETCH``, else a sequential chain — each window on
its own seeded batch order (:meth:`FederationLearner._window_data`), so
the two drivers give the same bytes. An attached
:class:`~tpfl_torch.parallel.membership.MembershipView`
(:meth:`~FederationLearner.set_membership`) sets every window's fold
weights; a change of its capacity tier restacks the local federation.
``Settings.CHECKPOINT_DIR`` / ``CHECKPOINT_EVERY_WINDOWS`` /
``CHECKPOINT_ON_SIGTERM`` save the engine's state through
:class:`~tpfl_torch.management.checkpoint.EngineCheckpointer`.

``mesh`` (a ``DeviceMesh`` with a ``nodes`` axis, or ``"auto"``, the
default when None: :func:`~tpfl_torch.parallel.engine.auto_mesh`, which
is no mesh for a lone process) spreads the local node axis over the
ranks of a ``torch.distributed`` world. Every rank of the mesh then
drives this learner in step — the same data, the same calls in the same
order, the SPMD contract that :mod:`~tpfl_torch.parallel.crosshost` sets
out — and each fit's model, the fold's aggregate, is the same on every
rank.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np
import torch

from tpfl_torch import DeviceLike, resolve_device
from tpfl_torch.learning.dataset.partition_strategies import RandomIIDPartitionStrategy
from tpfl_torch.learning.dataset.tpfl_dataset import TpflDataset
from tpfl_torch.learning.learner import Learner
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.parallel.distributed import full_tensor
from tpfl_torch.parallel.federation import VmapFederation
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import tree_map


class FederationLearner(Learner):
    """A Learner whose local fit is a whole node-stacked sub-federation.

    Args:
        model: template TpflModel (the architecture of every local node;
            its params seed the sub-federation each fit).
        data: this host's shard, partitioned across the local nodes.
        n_local_nodes: rows of the local federation.
        local_rounds: sub-federation rounds per ``fit`` (each of
            ``self.epochs`` local epochs).
        mesh: a ``DeviceMesh`` over the ranks that drive this learner in
            step, ``"auto"``, or None (``"auto"``).
        partition_strategy: how ``data`` splits across the local nodes.
        device: ``None`` = the card; ``"cpu"`` asks for the CPU.
    """

    def __init__(
        self,
        model: Optional[TpflModel] = None,
        data: Optional[TpflDataset] = None,
        addr: str = "unknown-node",
        aggregator: Optional[Any] = None,
        n_local_nodes: int = 8,
        local_rounds: int = 1,
        mesh: Optional[Any] = None,
        learning_rate: float = 0.1,
        batch_size: int = 32,
        partition_strategy: Any = RandomIIDPartitionStrategy,
        seed: int = 0,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        super().__init__(model, data, addr, aggregator)
        self.n_local_nodes = int(n_local_nodes)
        self.local_rounds = int(local_rounds)
        self.mesh = mesh
        self.learning_rate = float(learning_rate)
        self.batch_size = int(batch_size)
        self.partition_strategy = partition_strategy
        self.seed = int(seed)
        self._interrupt = threading.Event()
        # Elastic membership over the local rows (set_membership): every
        # window's weights come from it; None = all rows live.
        self.membership: Optional[Any] = None
        # Latest cadence snapshot (host state) — what the SIGTERM handler
        # publishes; never a tensor in flight.
        self._last_snapshot: "Optional[dict]" = None
        self._fed: Optional[VmapFederation] = None
        self._train_xs: Optional[torch.Tensor] = None
        self._train_ys: Optional[torch.Tensor] = None
        self._eval_xs: Optional[torch.Tensor] = None
        self._eval_ys: Optional[torch.Tensor] = None
        # Host stacked train batches, kept so per-window reshuffles do not
        # partition the dataset again (_window_data).
        self._host_train: "Optional[tuple[np.ndarray, np.ndarray]]" = None

    # --- lazy setup ---

    def set_data(self, data: TpflDataset) -> None:
        super().set_data(data)
        self._train_xs = self._eval_xs = None
        self._host_train = None

    def set_membership(self, view: Any) -> None:
        """Attach a MembershipView over the local rows: while attached,
        each window's fold weights come from the view (joins, leaves,
        crashes and quarantine verdicts are weight edits); a capacity
        tier change restacks the local federation at the next fit."""
        self.membership = view

    def _window_weights(self, widx: int) -> "Optional[np.ndarray]":
        """Window ``widx``'s fold weights from the attached view (None =
        unmasked)."""
        del widx  # churn is wall-clock, not window-indexed
        if self.membership is None:
            return None
        return self.membership.weights()

    def _ensure_fed(self) -> VmapFederation:
        if self._fed is None:
            # No pinned mesh -> "auto": the SHARD_* knobs spread the local
            # node axis over the world's ranks (no mesh for a lone process).
            self._fed = VmapFederation(self.get_model().module, self.n_local_nodes,
                                       mesh=self.mesh if self.mesh is not None else "auto",
                                       learning_rate=self.learning_rate, seed=self.seed,
                                       device=self.device)
        return self._fed

    def _host_stack(self, train: bool) -> tuple[np.ndarray, np.ndarray]:
        """Node-stacked [N, n_batches, b, ...] host arrays of this host's
        shard, every node cut to the smallest partition's batch count."""
        parts = self.get_data().generate_partitions(self.n_local_nodes, self.partition_strategy,
                                                    seed=self.seed)
        xs, ys = [], []
        for p in parts:
            x, y = p.export(batch_size=self.batch_size, train=train).stacked()
            xs.append(x)
            ys.append(y)
        n_batches = min(x.shape[0] for x in xs)
        if n_batches == 0:
            raise ValueError(
                f"Partitioning {self.get_data().num_samples(train)} samples across "
                f"{self.n_local_nodes} local nodes left an empty batch set; lower batch_size "
                f"or n_local_nodes")
        return (np.stack([x[:n_batches] for x in xs]), np.stack([y[:n_batches] for y in ys]))

    def _train_data(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._train_xs is None:
            if self._host_train is None:
                self._host_train = self._host_stack(train=True)
            self._train_xs, self._train_ys = self._ensure_fed().shard_data(*self._host_train)
        return self._train_xs, self._train_ys

    def _window_data(self, widx: int, start_round: int,
                     n_rounds: int) -> "Optional[tuple[torch.Tensor, torch.Tensor]]":
        """Window ``widx``'s batches on the device: the kept host stack in
        a seeded per-window batch order (window 0 keeps the export order).
        A pure function of (seed, widx), so both drivers, and the inline
        and prefetch-thread stagings, give the same bytes."""
        if widx == 0:
            return self._train_data()
        if self._host_train is None:
            self._host_train = self._host_stack(train=True)
        xs, ys = self._host_train
        order = np.random.default_rng((self.seed * 1_000_003 + widx) & 0x7FFFFFFF).permutation(
            xs.shape[1])
        return self._ensure_fed().shard_data(xs[:, order], ys[:, order])

    def _eval_data(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._eval_xs is None:
            self._eval_xs, self._eval_ys = self._ensure_fed().shard_data(
                *self._host_stack(train=False))
        return self._eval_xs, self._eval_ys

    # --- Learner contract ---

    def _stack(self, tree: Any) -> Any:
        """One model's tree broadcast onto the local node axis."""
        return self._ensure_fed().engine.broadcast_params(tree)

    def fit(self) -> TpflModel:
        self._interrupt.clear()
        model = self.get_model()
        if self.membership is not None:
            cap = int(self.membership.capacity)
            if cap != self.n_local_nodes:
                # A capacity tier boundary: restack the local federation
                # at the new tier. Within a tier, fit only re-masks.
                self.n_local_nodes = cap
                self._fed = None
                self._train_xs = self._eval_xs = None
                self._host_train = None
        fed = self._ensure_fed()
        if self.membership is not None:
            fed.engine.attach_membership(self.membership)
        xs, ys = self._train_data()
        params = self._stack(model.get_parameters())
        aux = self._stack(model.aux_state) if model.aux_state else None
        window = max(1, int(Settings.SHARD_ROUNDS_PER_DISPATCH))
        # Cadence snapshots every CHECKPOINT_EVERY_WINDOWS windows into
        # CHECKPOINT_DIR and, under CHECKPOINT_ON_SIGTERM on the main
        # thread, a SIGTERM handler publishing the latest one.
        ckpt = None
        snap_every = 0
        snapshot_to = None
        if Settings.CHECKPOINT_DIR and int(Settings.CHECKPOINT_EVERY_WINDOWS) > 0:
            from tpfl_torch.management.checkpoint import EngineCheckpointer

            ckpt = EngineCheckpointer(Settings.CHECKPOINT_DIR, node=self._addr)
            snap_every = int(Settings.CHECKPOINT_EVERY_WINDOWS)

            def snapshot_to(rounds_at: int, state: dict) -> None:
                self._last_snapshot = state
                ckpt.save(state, step=int(rounds_at))

        prev_sigterm: Any = None
        sigterm_armed = False
        if (Settings.CHECKPOINT_ON_SIGTERM and Settings.CHECKPOINT_DIR
                and threading.current_thread() is threading.main_thread()):
            from tpfl_torch.management.checkpoint import (
                EngineCheckpointer,
                install_sigterm_checkpoint,
            )

            if ckpt is None:
                ckpt = EngineCheckpointer(Settings.CHECKPOINT_DIR, node=self._addr)
            prev_sigterm = install_sigterm_checkpoint(ckpt, lambda: self._last_snapshot,
                                                      node=self._addr)
            sigterm_armed = True
        try:
            if Settings.ENGINE_PREFETCH:
                from tpfl_torch.parallel.window_pipeline import WindowPipeline

                result, rounds_run = WindowPipeline(fed.engine).run(
                    params, xs, ys, epochs=self.epochs, n_rounds=self.local_rounds,
                    window=window, aux=aux, data_for=self._window_data,
                    should_stop=self._interrupt.is_set,
                    weights_for=self._window_weights if self.membership is not None else None,
                    snapshot_every=snap_every, snapshot_to=snapshot_to, owner=self._addr)
                if rounds_run and result is None:
                    # Interrupted (window_pipeline.interrupt_for): the window
                    # in flight was abandoned; keep the pre-fit model.
                    return self.skip_fit(model)
                if rounds_run:
                    params, aux = (result[0], result[1]) if aux is not None else (result[0], None)
            else:
                rounds_run = 0
                widx = 0
                while rounds_run < self.local_rounds:
                    if self._interrupt.is_set():
                        break
                    k = min(window, self.local_rounds - rounds_run)
                    staged = self._window_data(widx, rounds_run, k)
                    if staged is not None:
                        xs, ys = staged
                    w = self._window_weights(widx)
                    if aux is not None:
                        params, aux, _ = fed.run_rounds(params, xs, ys, weights=w,
                                                        epochs=self.epochs, aux=aux, n_rounds=k)
                    else:
                        params, _ = fed.run_rounds(params, xs, ys, weights=w,
                                                   epochs=self.epochs, n_rounds=k)
                    rounds_run += k
                    widx += 1
                    if snap_every and widx % snap_every == 0:
                        snapshot_to(rounds_run, fed.engine.export_state(params, aux=aux))
        finally:
            if sigterm_armed and prev_sigterm is not None:
                import signal

                signal.signal(signal.SIGTERM, prev_sigterm)
        if rounds_run == 0:
            return self.skip_fit(model)

        # After the fold every row holds the local aggregate: take row 0
        # (on a mesh, every rank's first row).
        model.set_parameters(tree_map(lambda p: p.clone(), fed.engine.first_row(params)))
        if aux is not None:
            model.aux_state = tree_map(lambda a: a.clone(), fed.engine.first_row(aux))
        # The shard's raw sample count, as TorchLearner's finish_fit, so
        # hosts with different local_rounds / epochs weigh fairly.
        model.set_contribution([self._addr], self.get_data().num_samples(True))
        self.add_callback_info_to_model(model)
        self._last_fit_model = model
        return model

    def skip_fit(self, model: Optional[TpflModel] = None) -> TpflModel:
        model = model if model is not None else self.get_model()
        model.set_contribution([self._addr], 0)
        self._last_fit_model = model
        return model

    def interrupt_fit(self) -> None:
        self._interrupt.set()

    def evaluate(self) -> dict[str, float]:
        model = self.get_model()
        fed = self._ensure_fed()
        xs, ys = self._eval_data()
        aux = self._stack(model.aux_state) if model.aux_state else None
        losses, accs = fed.evaluate(self._stack(model.get_parameters()), xs, ys, aux=aux)
        losses, accs = full_tensor(losses), full_tensor(accs)
        # Evaluation's consumption boundary: one fetch each.
        return {"test_loss": float(losses.mean()), "test_metric": float(accs.mean())}


__all__ = ["FederationLearner"]
