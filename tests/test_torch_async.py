"""The port's asynchronous buffered rounds against the JAX package's, on
the CPU — the 21 cases of ``tests/test_async.py``, each run on both
packages with the same inputs (params made from a seed with numpy):

- ``staleness_weight``: exact;
- the staleness-weighted fold (fresh, one version behind, a hundred
  behind, untagged): the port's aggregate within rtol 1e-6 of JAX's, and
  both equal to the closed-form weighted mean;
- buffer-full, K = 1, the K clamp and an unknown contributor: the same
  close reasons and covered lists, exactly;
- the deadline on an empty buffer (fails open, counted) and on a held
  one, the sync no-op, ``remove_dead_nodes``' async no-op;
- quarantine in the buffer: an excluded contribution fills a slot but
  never folds; an all-quarantined buffer fails open;
- the ledger entry's staleness ordinal and version;
- ``TrainerSpeedPlan.skewed`` and ``AsyncSchedule.fork`` orders equal to
  JAX's; the reorder buffer admitting in schedule order, and a held
  contribution admitting into the next round;
- two intake races where the port holds what the JAX package misplaces
  (``ROADMAP.md`` §3): a contribution arriving after a node advanced its
  round but before it opened it is stashed for that round (JAX: the one
  after), and a scheduled contribution arriving before the first round
  opens waits in the reorder buffer (JAX: stashed for round 1);
- federations through ``run_seeded_experiment`` (3 MLP Nodes, the same
  addresses, seeds and data in both packages): a free-running one that
  learns and whose trainer threads stop, and a serialized one
  byte-identical across two port runs and across its nodes, its final
  params within rtol 1e-4, atol 1e-5 of the JAX federation's.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpfl.attacks.harness as jax_harness
from tpfl.attacks import metric_table as jax_metric_table
from tpfl.attacks import run_seeded_experiment as jax_run
from tpfl.attacks.harness import final_model_digests as jax_digests
from tpfl.communication.faults import AsyncSchedule as JaxSchedule
from tpfl.communication.faults import TrainerSpeedPlan as JaxSpeedPlan
from tpfl.communication.memory import clear_registry as jax_clear_registry
from tpfl.learning.aggregators import FedAvg as JaxFedAvg
from tpfl.learning.aggregators.aggregator import staleness_weight as jax_staleness_weight
from tpfl.learning.dataset import synthetic_mnist as jax_synthetic_mnist
from tpfl.learning.model import TpflModel as JaxModel
from tpfl.management import ledger as jax_ledger
from tpfl.management.logger import logger as jax_logger
from tpfl.management.quarantine import QuarantineEngine as JaxQuarantine
from tpfl.models import create_model as jax_create_model
from tpfl.settings import Settings as JaxSettings
import tpfl_torch.attacks.harness as harness
from tpfl_torch.attacks import metric_table, run_seeded_experiment
from tpfl_torch.attacks.harness import final_model_digests
from tpfl_torch.communication.faults import AsyncSchedule, TrainerSpeedPlan
from tpfl_torch.communication.memory import clear_registry
from tpfl_torch.interop import model_state_from_jax
from tpfl_torch.learning.aggregators import FedAvg
from tpfl_torch.learning.aggregators.aggregator import staleness_weight
from tpfl_torch.learning.dataset.synthetic import synthetic_mnist
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.management import ledger
from tpfl_torch.management.logger import logger
from tpfl_torch.management.quarantine import QuarantineEngine
from tpfl_torch.models import MLP
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import tree_items

RTOL, ATOL = 1e-6, 1e-7
FED_RTOL, FED_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _settings():
    snaps = (Settings.snapshot(), JaxSettings.snapshot())
    for s in (Settings, JaxSettings):
        s.set_test_settings()
        s.DISABLE_SIMULATION = True
        s.ELECTION = "hash"
    levels = logger.get_level(), jax_logger.get_level()
    logger.set_level("ERROR")
    jax_logger.set_level("ERROR")
    clear_registry()
    jax_clear_registry()
    ledger.contrib.reset()
    jax_ledger.contrib.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    clear_registry()
    jax_clear_registry()
    ledger.contrib.reset()
    jax_ledger.contrib.reset()
    logger.set_level(levels[0])
    jax_logger.set_level(levels[1])
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])


def _set_both(**knobs):
    for s in (Settings, JaxSettings):
        for k, v in knobs.items():
            setattr(s, k, v)


def mk(value, n_samples, contributors, seed=0):
    """(JAX model, port model) with the same params: seeded noise around
    ``value`` (leaf ``w[0, 0]`` is exactly ``value``)."""
    rng = np.random.default_rng(seed)
    w = (value + 0.01 * rng.normal(size=(3, 3))).astype(np.float32)
    w[0, 0] = value
    tree = {"w": w, "b": np.full((3,), value, np.float32)}
    return (JaxModel(params=jax.tree_util.tree_map(jnp.asarray, tree), num_samples=n_samples,
                     contributors=contributors),
            TpflModel(params=tree, num_samples=n_samples, contributors=contributors,
                      device="cpu"))


class Both:
    """A JAX FedAvg and a port FedAvg driven with the same calls; each call
    asserts both return the same."""

    def __init__(self, node="n"):
        self.j, self.t = JaxFedAvg(node), FedAvg(node, device="cpu")

    def __getattr__(self, name):
        def call(*args, **kw):
            want = getattr(self.j, name)(*args, **kw)
            got = getattr(self.t, name)(*args, **kw)
            assert got == want, (name, got, want)
            return got
        return call

    def add(self, pair, **kw):
        want = self.j.add_model(pair[0], **kw)
        got = self.t.add_model(pair[1], **kw)
        assert got == want, (got, want)
        return got

    def result(self):
        """Both aggregates, the port's held to JAX's; the port's."""
        jout = self.j.wait_and_get_aggregation(timeout=1.0)
        tout = self.t.wait_and_get_aggregation(timeout=1.0)
        want = {k: np.asarray(v) for k, v in jout.get_parameters().items()}
        for k, v in tout.get_parameters().items():
            np.testing.assert_allclose(v.numpy(), want[k], rtol=RTOL, atol=ATOL, err_msg=k)
        assert tout.get_contributors() == jout.get_contributors()
        assert tout.get_num_samples() == jout.get_num_samples()
        return tout

    def clear(self):
        self.j.clear()
        self.t.clear()


def leaf(model):
    return float(model.get_parameters()["w"][0, 0])


# --- staleness weight math -------------------------------------------------


def test_staleness_weight_curve():
    for exp in (0.5, 0.0, 1.5):
        _set_both(ASYNC_STALENESS_EXP=exp)
        for tau in (-3, 0, 1, 3, 100):
            assert staleness_weight(tau) == jax_staleness_weight(tau)
    _set_both(ASYNC_STALENESS_EXP=0.5)
    assert staleness_weight(3) == pytest.approx((1 + 3) ** -0.5)
    assert staleness_weight(-3) == 1.0


def test_version_zero_contribution_against_far_advanced_model():
    _set_both(ASYNC_STALENESS_EXP=0.5)
    agg = Both()
    agg.set_nodes_to_aggregate(["a", "b"], async_k=2, round_ordinal=100)
    agg.add(mk(0.0, 100, ["a"], 1), start_version=100)
    agg.add(mk(10.0, 100, ["b"], 2), start_version=0)
    out = agg.result()
    w = staleness_weight(100)
    assert leaf(out) == pytest.approx(10.0 * w / (1.0 + w), rel=1e-5)
    assert 0.0 < leaf(out) < 1.0
    agg.clear()


def test_staleness_weighted_fold_exact():
    _set_both(ASYNC_STALENESS_EXP=0.5)
    agg = Both()
    agg.set_nodes_to_aggregate(["a", "b"], async_k=2, round_ordinal=5)
    agg.add(mk(2.0, 50, ["a"], 1), start_version=5)
    agg.add(mk(4.0, 50, ["b"], 2), start_version=4)
    out = agg.result()
    w1, w2 = 50 * staleness_weight(0), 50 * staleness_weight(1)
    assert leaf(out) == pytest.approx((2.0 * w1 + 4.0 * w2) / (w1 + w2), rel=1e-5)
    agg.clear()


def test_untagged_contribution_is_fresh():
    agg = Both()
    agg.set_nodes_to_aggregate(["a", "b"], async_k=2, round_ordinal=50)
    agg.add(mk(1.0, 10, ["a"], 1))
    agg.add(mk(3.0, 10, ["b"], 2), start_version=50)
    assert leaf(agg.result()) == pytest.approx(2.0, rel=1e-5)
    agg.clear()


# --- buffer close semantics ------------------------------------------------


def test_buffer_full_closes_without_full_coverage():
    agg = Both()
    agg.set_nodes_to_aggregate([f"p{i}" for i in range(10)], async_k=3, round_ordinal=0)
    agg.add(mk(1.0, 10, ["p0"]), start_version=0)
    agg.add(mk(1.0, 10, ["p1"]), start_version=0)
    assert agg.is_open() is True
    agg.add(mk(1.0, 10, ["p2"]), start_version=0)
    assert agg.is_open() is False
    assert agg.close_reason() == "buffer_full"
    agg.clear()


def test_buffer_k1_degenerate():
    agg = Both()
    agg.set_nodes_to_aggregate(["a", "b"], async_k=1, round_ordinal=0)
    assert agg.add(mk(7.0, 10, ["b"]), start_version=0) == ["b"]
    assert agg.is_open() is False
    out = agg.result()
    assert leaf(out) == pytest.approx(7.0) and out.get_contributors() == ["b"]
    agg.clear()


def test_async_k_clamped_to_train_set():
    agg = Both()
    agg.set_nodes_to_aggregate(["a", "b"], async_k=64, round_ordinal=0)
    agg.add(mk(1.0, 10, ["a"]), start_version=0)
    assert agg.is_open() is True
    agg.add(mk(1.0, 10, ["b"]), start_version=0)
    assert agg.is_open() is False
    agg.clear()


def test_unknown_contributor_grows_async_train_set():
    agg = Both()
    agg.set_nodes_to_aggregate(["a", "b"], async_k=2, round_ordinal=0)
    assert agg.add(mk(1.0, 10, ["z"]), start_version=0) == ["z"]
    assert agg.is_async() is True
    agg.clear()


def _deadline_count(log, node):
    return sum(v for (name, labels), v in log.metrics.fold()["counters"].items()
               if name == "tpfl_agg_deadline_total" and dict(labels).get("node") == node)


def test_deadline_with_empty_buffer_fails_open_loudly():
    agg = Both("dl-n")
    agg.set_nodes_to_aggregate(["a", "b", "c"], async_k=3, round_ordinal=0)
    before = (_deadline_count(logger, "dl-n"), _deadline_count(jax_logger, "dl-n"))
    assert agg.async_deadline_close() is False
    assert agg.is_open() is True and agg.close_reason() is None
    assert _deadline_count(logger, "dl-n") == before[0] + 1
    assert _deadline_count(jax_logger, "dl-n") == before[1] + 1
    agg.add(mk(3.0, 10, ["a"]), start_version=0)
    assert agg.async_deadline_close() is True
    assert agg.close_reason() == "deadline"
    assert leaf(agg.result()) == pytest.approx(3.0)
    agg.clear()


def test_deadline_close_is_noop_for_sync_rounds():
    agg = Both()
    agg.set_nodes_to_aggregate(["a", "b"])
    assert agg.async_deadline_close() is False
    assert agg.is_open() is True and agg.is_async() is False
    agg.clear()


def test_remove_dead_nodes_noop_in_async():
    agg = Both()
    agg.set_nodes_to_aggregate(["a", "b", "c"], async_k=2, round_ordinal=0)
    assert agg.remove_dead_nodes(["b"]) is False
    assert agg.add(mk(1.0, 10, ["b"]), start_version=0) == ["b"]
    agg.clear()


# --- quarantine x buffer accounting ---------------------------------------


def _defended(node="n"):
    agg = Both(node)
    agg.j.set_quarantine(JaxQuarantine(node))
    agg.t.set_quarantine(QuarantineEngine(node))
    return agg


def _open_ledger_round(node, rnd, value=1.0):
    jm, tm = mk(value, 1, ["ref"])
    jax_ledger.contrib.open_round(node, rnd, jm.get_parameters())
    ledger.contrib.open_round(node, rnd, tm.get_parameters())


def _close_ledger_round(node):
    jax_ledger.contrib.close_round(node)
    ledger.contrib.close_round(node)


def test_quarantined_contribution_fills_buffer_but_not_fold():
    _set_both(QUARANTINE_ENABLED=True, LEDGER_ENABLED=True)
    agg = _defended()
    agg.set_nodes_to_aggregate(["good", "evil", "late"], async_k=2, round_ordinal=0)
    _open_ledger_round("n", 0)
    agg.add(mk(1.0, 10, ["good"], 1), start_version=0)
    agg.add(mk(-1.0, 10, ["evil"], 2), start_version=0)
    assert agg.is_open() is False and agg.close_reason() == "buffer_full"
    out = agg.result()
    assert leaf(out) == pytest.approx(1.0)
    assert sorted(out.get_contributors()) == ["evil", "good"]
    assert out.get_num_samples() == 10
    agg.clear()
    _close_ledger_round("n")


def test_all_quarantined_buffer_fails_open():
    _set_both(QUARANTINE_ENABLED=True, LEDGER_ENABLED=True)
    agg = _defended()
    agg.set_nodes_to_aggregate(["e1", "e2"], async_k=2, round_ordinal=0)
    _open_ledger_round("n", 0)
    agg.add(mk(-1.0, 10, ["e1"], 1), start_version=0)
    agg.add(mk(-2.0, 10, ["e2"], 2), start_version=0)
    assert agg.is_open() is False
    assert leaf(agg.result()) == pytest.approx(-1.5)
    agg.clear()
    _close_ledger_round("n")


def test_ledger_entry_carries_staleness_ordinal():
    _set_both(LEDGER_ENABLED=True)
    agg = Both()
    agg.set_nodes_to_aggregate(["a"], async_k=1, round_ordinal=7)
    _open_ledger_round("n", 7)
    agg.add(mk(2.0, 10, ["a"]), start_version=4)
    got = [e for e in ledger.contrib.entries("n") if e["peer"] == "a"]
    want = [e for e in jax_ledger.contrib.entries("n") if e["peer"] == "a"]
    assert got and [(e["staleness"], e["version"]) for e in got] == [
        (e["staleness"], e["version"]) for e in want] == [(3, 4)]
    agg.clear()
    _close_ledger_round("n")


# --- the seeded scheduler discipline --------------------------------------


def test_speed_plan_skewed_deterministic():
    addrs = [f"n{i}" for i in range(10)]
    p1 = TrainerSpeedPlan.skewed(addrs, slow_frac=0.2, seed=7)
    assert p1.delays == TrainerSpeedPlan.skewed(addrs, slow_frac=0.2, seed=7).delays
    assert p1.delays == JaxSpeedPlan.skewed(addrs, slow_frac=0.2, seed=7).delays
    assert sum(d > min(p1.delays.values()) for d in p1.delays.values()) == 2
    assert TrainerSpeedPlan.skewed(addrs, slow_frac=0.2, seed=8).delays != p1.delays


def test_async_schedule_fork_identical_order():
    addrs = [f"n{i}" for i in range(5)]
    plan = TrainerSpeedPlan.skewed(addrs, slow_frac=0.2, seed=11)
    s1, js1 = AsyncSchedule.for_plan(plan), JaxSchedule.for_plan(JaxSpeedPlan.skewed(
        addrs, slow_frac=0.2, seed=11))
    s2, js2 = s1.fork(), js1.fork()
    seqs = [[], [], [], []]
    for _ in range(50):
        for seq, sched in zip(seqs, (s1, s2, js1, js2)):
            seq.append(sched.expected())
            sched.advance()
    assert seqs[0] == seqs[1] == seqs[2] == seqs[3]
    slow = max(plan.delays, key=plan.delays.get)
    fast = min(plan.delays, key=plan.delays.get)
    assert seqs[0].count(slow) < seqs[0].count(fast)


def test_schedule_reorder_buffer_admits_in_schedule_order():
    periods = {"a": 1.0, "b": 1.0, "c": 1.0}
    agg = Both()
    agg.j.set_async_schedule(JaxSchedule(periods, seed=3))
    agg.t.set_async_schedule(AsyncSchedule(periods, seed=3))
    agg.set_nodes_to_aggregate(["a", "b", "c"], async_k=3, round_ordinal=0)
    probe = AsyncSchedule(periods, seed=3)
    order = []
    for _ in range(3):
        order.append(probe.expected())
        probe.advance()
    for i, name in enumerate(reversed(order)):
        agg.add(mk(1.0 + i, 10, [name], i), start_version=0)
        if i < 2:
            assert agg.get_aggregated_models() == []
    assert agg.get_aggregated_models() == order  # admitted in schedule order
    assert agg.is_open() is False
    agg.result()
    agg.clear()


def test_schedule_hold_survives_round_boundary():
    periods = {"a": 1.0, "b": 1.0}
    agg = Both()
    agg.j.set_async_schedule(JaxSchedule(periods, seed=5))
    agg.t.set_async_schedule(AsyncSchedule(periods, seed=5))
    agg.set_nodes_to_aggregate(["a", "b"], async_k=1, round_ordinal=0)
    head = AsyncSchedule(periods, seed=5).expected()
    other = "b" if head == "a" else "a"
    agg.add(mk(2.0, 10, [other], 1), start_version=0)
    agg.add(mk(1.0, 10, [head], 2), start_version=0)
    assert agg.is_open() is False
    assert leaf(agg.result()) == pytest.approx(1.0)
    agg.clear()
    agg.set_nodes_to_aggregate(["a", "b"], async_k=1, round_ordinal=1)
    assert agg.get_aggregated_models() == [other]
    assert agg.is_open() is False
    # Held since round 0: it folds at τ = 1.
    assert leaf(agg.result()) == pytest.approx(2.0)
    agg.clear()


def test_sync_round_with_a_schedule_closes_on_coverage():
    """A schedule attached and ``ASYNC_ROUNDS`` off: a synchronous round
    takes the schedule's second trainer first and closes on coverage, as
    the JAX one does; nothing waits in the reorder buffer."""
    periods = {"a": 1.0, "b": 1.0}
    agg = Both()
    agg.j.set_async_schedule(JaxSchedule(periods, seed=5))
    agg.t.set_async_schedule(AsyncSchedule(periods, seed=5))
    agg.set_nodes_to_aggregate(["a", "b"])
    head = AsyncSchedule(periods, seed=5).expected()
    other = "b" if head == "a" else "a"
    assert agg.add(mk(2.0, 10, [other], 1)) == [other]
    assert agg.is_open() is True
    assert agg.add(mk(1.0, 30, [head], 2)) == ["a", "b"]
    assert agg.is_open() is False
    assert agg.close_reason() == "coverage"
    assert leaf(agg.result()) == pytest.approx(1.25)
    agg.clear()


# --- the intake between rounds --------------------------------------------


def _nodes(prefix):
    """A JAX Node and a port Node of one MLP, not started."""
    jax_node_cls = jax_harness.Node
    data = port_data_fn(0)
    jdata = jax_data_fn(0)
    return (jax_node_cls(jax_model_fn(0), jdata, addr=f"{prefix}-j"),
            harness.Node(port_model_fn(0), data, addr=f"{prefix}-t", device="cpu"))


def _deliver(node, rnd, version, trace=""):
    """A peer's async contribution through the partial_model command."""
    from tpfl.communication.commands import PartialModelCommand as JaxPartial
    from tpfl_torch.communication.commands import PartialModelCommand

    cmd = (PartialModelCommand if isinstance(node, harness.Node) else JaxPartial)(node)
    model = node.learner.get_model()
    payload = model.build_copy(params=model.get_parameters(), contributors=["peer"],
                               num_samples=10).encode_parameters()
    cmd.execute("peer", rnd, weights=payload, contributors=["peer"], num_samples=10,
                version=version, trace=trace)


def _pending(node):
    with node.state.pending_partials_lock:
        return [r for r, _ in node.state.pending_partials]


def test_contribution_after_the_round_advanced_is_stashed_for_it():
    """Round 0 closed, the round advanced to 1, round 1 not open yet: the
    port keeps the contribution for round 1, which folds it at its open;
    the JAX package keeps it for round 2."""
    from tpfl.experiment import Experiment as JaxExperiment
    from tpfl_torch.experiment import Experiment

    _set_both(ASYNC_ROUNDS=True)
    jnode, tnode = _nodes("adv")
    for node, exp in ((jnode, JaxExperiment("e", 4)), (tnode, Experiment("e", 4))):
        node.state.set_experiment(exp)
        node.aggregator.set_nodes_to_aggregate(["peer", node.addr], async_k=2, round_ordinal=0)
        node.aggregator.clear()
        node.state.increase_round()
        _deliver(node, 1, 1, trace="peer-trace")
    assert _pending(jnode) == [2] and _pending(tnode) == [1]
    tnode.aggregator.set_nodes_to_aggregate(["peer", tnode.addr], async_k=2, round_ordinal=1)
    for args in tnode.state.drain_pending_partials(1):
        assert args[6] == "peer-trace"  # the replay keeps the contribution's trace
        _deliver(tnode, args[1], args[5], trace=args[6])
    assert tnode.aggregator.get_aggregated_models() == ["peer"]


def test_scheduled_contribution_before_the_first_round_is_held():
    """With a schedule attached and no round opened yet, the port's reorder
    buffer holds the contribution and admits it at round 0's open; the
    JAX package stashes it for round 1."""
    from tpfl.experiment import Experiment as JaxExperiment
    from tpfl_torch.experiment import Experiment

    _set_both(ASYNC_ROUNDS=True)
    jnode, tnode = _nodes("first")
    periods = {"peer": 1.0, "first-j": 2.0, "first-t": 2.0}
    jnode.aggregator.set_async_schedule(JaxSchedule(periods, seed=1))
    tnode.aggregator.set_async_schedule(AsyncSchedule(periods, seed=1))
    for node, exp in ((jnode, JaxExperiment("e", 4)), (tnode, Experiment("e", 4))):
        node.state.set_experiment(exp)
        _deliver(node, 0, 0)
    assert _pending(jnode) == [1] and _pending(tnode) == []
    tnode.aggregator.set_nodes_to_aggregate(["peer", tnode.addr], async_k=2, round_ordinal=0)
    assert tnode.aggregator.get_aggregated_models() == ["peer"]


# --- lifecycle e2e ---------------------------------------------------------


def jax_model_fn(seed):
    return jax_create_model("mlp", (28, 28), seed=seed, hidden_sizes=(32,),
                            compute_dtype=jnp.float32)


def port_model_fn(seed):
    return TpflModel(MLP(hidden_sizes=(32,), out_channels=10, compute_dtype=torch.float32),
                     **model_state_from_jax(jax_model_fn(seed), device="cpu"))


def jax_data_fn(seed):
    return jax_synthetic_mnist(n_train=360, n_test=120, seed=seed, noise=0.4)


def port_data_fn(seed):
    return synthetic_mnist(n_train=360, n_test=120, seed=seed, noise=0.4)


def _finals(module, base):
    """Swap ``module.Node`` for a subclass keeping each node's final
    params as numpy at stop; returns (the dict, a restore function)."""
    finals = {}

    class Keeping(base):
        def stop(self):
            if self.addr not in finals:
                finals[self.addr] = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
                                     for k, v in tree_items(self.learner.get_model()
                                                            .get_parameters())}
            super().stop()

    saved, module.Node = module.Node, Keeping
    return finals, lambda: setattr(module, "Node", saved)


def _plan(cls, seed, n):
    return cls.skewed([f"seed{seed}-n{i}" for i in range(n)], slow_frac=0.34, base_delay=0.05,
                      skew=5.0, seed=seed)


def _trainer_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("async-trainer-") and t.is_alive()]


def test_async_federation_e2e_learns():
    """Free-running (a trainer thread per node, eager folds): every node
    finishes, the model beats the 0.1 chance floor, and no trainer thread
    outlives the experiment."""
    _set_both(ASYNC_ROUNDS=True, ASYNC_BUFFER_K=2, ASYNC_SERIALIZED=False, TRAIN_SET_SIZE=3)
    exp = run_seeded_experiment(97, 3, 4, epochs=2, data_fn=port_data_fn,
                                model_fn=port_model_fn, samples_per_node=120, batch_size=20,
                                timeout=60.0, device="cpu")
    tbl = metric_table(exp)
    assert sorted(tbl) == [f"seed97-n{i}" for i in range(3)]
    accs = [tbl[n]["test_metric"][-1][1] for n in sorted(tbl)]
    assert sum(accs) / len(accs) > 0.25
    assert not _trainer_threads()


def test_async_serialized_same_seed_byte_identical():
    """Serialized with the plan's schedule forked into every aggregator:
    two port runs end byte-identical, and every node on one model; that
    model within rtol 1e-4, atol 1e-5 of the JAX federation's, which
    ends on one model too."""
    _set_both(ASYNC_ROUNDS=True, ASYNC_BUFFER_K=2, ASYNC_SERIALIZED=True, TRAIN_SET_SIZE=3)
    kw = dict(epochs=1, samples_per_node=120, batch_size=20, timeout=60.0)
    finals, restore = _finals(harness, harness.Node)
    try:
        runs = [final_model_digests(run_seeded_experiment(
            131, 3, 3, speed_plan=_plan(TrainerSpeedPlan, 131, 3), data_fn=port_data_fn,
            model_fn=port_model_fn, device="cpu", **kw)) for _ in range(2)]
    finally:
        restore()
    assert runs[0] == runs[1] and len(set(runs[0].values())) == 1
    jfinals, jrestore = _finals(jax_harness, jax_harness.Node)
    try:
        jexp = jax_run(131, 3, 3, speed_plan=_plan(JaxSpeedPlan, 131, 3), data_fn=jax_data_fn,
                       model_fn=jax_model_fn, **kw)
    finally:
        jrestore()
    assert len(set(jax_digests(jexp).values())) == 1
    assert sorted(finals) == sorted(jfinals)
    for addr in finals:
        for k, want in jfinals[addr].items():
            np.testing.assert_allclose(finals[addr][k], want, rtol=FED_RTOL, atol=FED_ATOL,
                                       err_msg=f"{addr} {k}")
    assert jax_metric_table(jexp)


def test_async_free_running_trainer_loop_shuts_down():
    """Free-running, K = 1: the trainer threads drain at experiment end
    (each node's stop interrupts and joins its own)."""
    _set_both(ASYNC_ROUNDS=True, ASYNC_BUFFER_K=1, ASYNC_SERIALIZED=False, TRAIN_SET_SIZE=3)
    seen = []
    finals, restore = _finals(harness, harness.Node)
    try:
        stop = harness.Node.stop

        def stop_and_look(self):
            seen.append(self._async_trainer_thread)
            stop(self)

        harness.Node.stop = stop_and_look
        run_seeded_experiment(53, 3, 3, epochs=1, data_fn=port_data_fn,
                              model_fn=port_model_fn, samples_per_node=120, batch_size=20,
                              timeout=60.0, device="cpu")
    finally:
        restore()
    assert len(seen) == 3 and all(t is not None for t in seen)
    deadline = time.monotonic() + 10.0
    while _trainer_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _trainer_threads() and not any(t.is_alive() for t in seen)
