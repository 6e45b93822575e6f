"""Seeded experiment harness — reproducibility + attack comparison; the
port of :mod:`tpfl.attacks.harness`.

One entry point runs a seeded federation of ``Node``s (optionally with
adversaries, network faults and skewed trainers), returns the
experiment's name, and records its ground truth (who poisoned), its
final-model digests and its global metric table; helpers flatten and
compare tables numerically. The default data is the reference's:
``rendered_digits`` at the experiment's seed, bit-equal to it.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Optional

import numpy as np

from tpfl_torch import DeviceLike, resolve_device
from tpfl_torch.attacks.attacks import AttackFn, make_adversary
from tpfl_torch.learning.dataset import RandomIIDPartitionStrategy, rendered_digits
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.learning.serialization import host_array, leaf_bytes
from tpfl_torch.management.logger import logger
from tpfl_torch.models import create_model
from tpfl_torch.node import Node
from tpfl_torch.settings import Settings
from tpfl_torch.utils import TopologyFactory, TopologyType, wait_convergence, wait_to_finish
from tpfl_torch.utils.tree import canonical_leaves

#: Ground-truth adversary registry: ``exp_name -> {addr: attack name}``
#: recorded by :func:`run_seeded_experiment` for every adversarial run —
#: what detection is scored against.
_ADVERSARIES: dict[str, dict[str, str]] = {}

#: Final-model digests per experiment: ``exp_name -> {addr: sha256}``.
_FINAL_DIGESTS: dict[str, dict[str, str]] = {}

#: Per-experiment controller trajectories: ``exp_name -> {addr: []}``.
_CTL_TRAJECTORIES: dict[str, dict[str, list]] = {}


def adversary_map(exp_name: str) -> dict[str, str]:
    """``{node addr: attack name}`` for a harness-run experiment
    (empty for fault-free runs / unknown experiments)."""
    return dict(_ADVERSARIES.get(exp_name, {}))


def final_model_digests(exp_name: str) -> dict[str, str]:
    """``{addr: sha256(params)}`` captured at experiment finish, before
    the nodes stop."""
    return dict(_FINAL_DIGESTS.get(exp_name, {}))


def controller_trajectories(exp_name: str) -> dict[str, list]:
    """``{addr: per-round controller decisions}`` captured at experiment
    finish (empty lists for runs without ``ASYNC_ADAPTIVE``)."""
    return {k: [dict(r) for r in v] for k, v in _CTL_TRAJECTORIES.get(exp_name, {}).items()}


def params_digest(params: Any) -> str:
    """sha256 over the raw bytes of every leaf in JAX's pytree order —
    the reference's digest of the same params."""
    h = hashlib.sha256()
    for leaf in canonical_leaves(params):
        h.update(leaf_bytes(host_array(leaf.detach().cpu())))
    return h.hexdigest()


def run_seeded_experiment(
    seed: int,
    n: int,
    rounds: int,
    *,
    epochs: int = 1,
    adversaries: Optional[dict[int, AttackFn]] = None,
    attack_plan: Optional[Any] = None,
    fault_plan: Optional[Any] = None,
    speed_plan: Optional[Any] = None,
    aggregator_factory: Optional[Callable[[], Any]] = None,
    topology: TopologyType = TopologyType.STAR,
    model_fn: Optional[Callable[[int], Any]] = None,
    data_fn: Optional[Callable[[int], Any]] = None,
    samples_per_node: int = 300,
    learning_rate: float = 0.1,
    batch_size: int = 50,
    timeout: float = 240.0,
    device: DeviceLike = None,
) -> str:
    """Run one seeded federation; returns the experiment name.

    ``adversaries`` maps node index -> attack (persistent, applied to
    every fit — see :class:`tpfl_torch.attacks.AdversarialLearner`).
    ``attack_plan`` is the declarative alternative
    (:class:`tpfl_torch.attacks.plan.AttackPlan`), ``fault_plan``
    (:class:`tpfl_torch.communication.faults.FaultPlan`) composes network
    chaos and ``speed_plan`` trainer-speed skew into the same run; the
    plans' ground truth lands in :func:`adversary_map`. ``model_fn(seed)``
    returns a :class:`TpflModel` (default: the MLP on 28×28 inputs);
    ``data_fn(seed)`` a :class:`TpflDataset` to split IID over the nodes
    (default: ``rendered_digits`` of ``samples_per_node`` images a node and
    a fifth as many test images, at least 100). ``device`` goes to every ``Node`` (``None`` means the
    card). Star topology, pinned addresses ``seed{seed}-n{i}``, seeded
    settings, long vote and aggregation timeouts.
    """
    dev = resolve_device(device)
    prev_seed = Settings.SEED
    Settings.SEED = seed
    # Reproducibility beats latency here: a vote/aggregation timeout
    # firing under host load would truncate the tally and elect a
    # different train set in one run but not the other.
    prev_vote, prev_agg = Settings.VOTE_TIMEOUT, Settings.AGGREGATION_TIMEOUT
    Settings.VOTE_TIMEOUT = max(prev_vote, 300.0)
    Settings.AGGREGATION_TIMEOUT = max(prev_agg, 300.0)
    nodes: list[Node] = []
    try:
        data = (data_fn(seed) if data_fn is not None else rendered_digits(
            n_train=samples_per_node * n, n_test=max(100, samples_per_node * n // 5), seed=seed))
        parts = data.generate_partitions(n, RandomIIDPartitionStrategy, seed=seed)
        for i in range(n):
            if model_fn is not None:
                model = model_fn(seed)
            else:
                model = TpflModel(*create_model("mlp", (28, 28), seed=seed, device=dev),
                                  device=dev)
            # Pinned addresses: per-node shuffle/vote seeds derive from
            # the address, and table comparison aligns by node name.
            node = Node(
                model,
                parts[i],
                addr=f"seed{seed}-n{i}",
                aggregator=aggregator_factory() if aggregator_factory else None,
                device=dev,
                learning_rate=learning_rate,
                batch_size=batch_size,
            )
            if adversaries and i in adversaries:
                make_adversary(node, adversaries[i])
            nodes.append(node)

        # Declarative chaos: scheduled adversaries + network faults +
        # trainer speeds in one spec, wired BEFORE start.
        plan_truth: dict[str, str] = {}
        if attack_plan is not None or fault_plan is not None or speed_plan is not None:
            from tpfl_torch.attacks.plan import apply_chaos

            plan_truth, _ = apply_chaos(nodes, attack_plan=attack_plan, fault_plan=fault_plan,
                                        speed_plan=speed_plan, seed=seed)
        for node in nodes:
            node.start()

        TopologyFactory.connect_nodes(TopologyFactory.generate_matrix(topology, n), nodes)
        wait_convergence(nodes, n - 1, only_direct=False, wait=30)
        exp_name = nodes[0].set_start_learning(rounds=rounds, epochs=epochs)
        if adversaries or plan_truth:
            truth = dict(plan_truth)
            for i, fn in (adversaries or {}).items():
                truth[nodes[i].addr] = str(getattr(fn, "name", getattr(fn, "__name__", "attack")))
            _ADVERSARIES[exp_name] = truth
        wait_to_finish(nodes, timeout=timeout)
        # Byte-determinism receipt: digest every node's final params
        # BEFORE stop() tears anything down.
        _FINAL_DIGESTS[exp_name] = {
            node.addr: params_digest(node.learner.get_model().get_parameters())
            for node in nodes}
        # The controllers' receipts: experiment teardown (RoundFinishedStage
        # -> state.clear) has reset a node's controller by the time the
        # last node finishes, so read the archived log when the live one
        # is gone.
        _CTL_TRAJECTORIES[exp_name] = {
            node.addr: (node.state.async_controller.trajectory()
                        or node.state.async_controller.last_trajectory())
            for node in nodes}
        return exp_name
    finally:
        for node in nodes:
            node.stop()
        Settings.SEED = prev_seed
        Settings.VOTE_TIMEOUT = prev_vote
        Settings.AGGREGATION_TIMEOUT = prev_agg


def metric_table(exp_name: str) -> dict[str, dict[str, list]]:
    """The experiment's global metric table:
    ``{node: {metric: [(round, value), ...]}}``."""
    return logger.get_global_logs().get(exp_name, {})


def flatten_table(table: dict[str, dict[str, list]]) -> np.ndarray:
    """Deterministic numeric flattening: sort by node, then metric, then
    round."""
    out: list[float] = []
    for node in sorted(table):
        for metric in sorted(table[node]):
            for _, value in sorted(table[node][metric]):
                out.append(float(value))
    return np.asarray(out, dtype=np.float64)


def _series_maps(table: dict[str, dict[str, list]]) -> dict[tuple[str, str], dict[int, float]]:
    return {
        (node, metric): {int(r): float(v) for r, v in series}
        for node, metrics in table.items()
        for metric, series in metrics.items()
        if series
    }


def assert_tables_allclose(
    a: dict[str, dict[str, list]],
    b: dict[str, dict[str, list]],
    atol: float = 1e-3,
) -> None:
    """Two seeded runs must produce numerically identical metric tables
    up to float-reduction noise, compared per (node, metric) at every
    COMMON round (metric gossip is best-effort: one run may miss a
    round's entry). The default ``atol`` (1e-3) covers the drift of
    partial-aggregation merge order across same-seed runs."""
    ma, mb = _series_maps(a), _series_maps(b)
    if set(ma) != set(mb):
        raise AssertionError(
            f"Metric tables differ in keys: only-in-a={sorted(set(ma) - set(mb))}, "
            f"only-in-b={sorted(set(mb) - set(ma))}")
    got, want, labels = [], [], []
    for key in sorted(ma):
        common = set(ma[key]) & set(mb[key])
        if not common:
            raise AssertionError(f"No common rounds for {key}")
        for r in sorted(common):  # EVERY shared round must agree
            got.append(ma[key][r])
            want.append(mb[key][r])
            labels.append((key, r))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               err_msg=f"compared (key, round): {labels}")


__all__ = ["adversary_map", "assert_tables_allclose", "controller_trajectories",
           "final_model_digests", "flatten_table", "metric_table", "params_digest",
           "run_seeded_experiment"]
