"""The port's seeded-experiment harness (``tpfl_torch.attacks.harness``)
and the chaos wiring of ``tpfl_torch.attacks`` against the JAX
package's, on the CPU:

- ``run_seeded_experiment`` on 3 MLP Nodes (clean) and on 4 MLP Nodes
  under an ``AttackPlan`` with quarantine, in both packages with the same
  ``data_fn`` (the same numpy-made arrays), the same params (the JAX
  model's, carried across) and the same pinned addresses: the metric
  tables pass ``assert_tables_allclose`` at atol 1e-5 (its rtol is
  numpy's 1e-7; f32 compute; compared at every common round, since
  metric gossip is best-effort); ``adversary_map`` and
  ``replay_decisions()`` are equal,
  and the quarantined set is the plan's adversaries;
- ``final_model_digests``: the port's digest of the JAX package's params
  is the reference's hex (f32 and bf16 leaves);
- ``flatten_table`` equal on the same table; ``controller_trajectories``
  empty lists per node;
- ``apply_chaos`` composes an attack plan and a fault plan
  (``tests/test_attacks.py:189-218``) and wires a speed plan;
  ``make_adversary`` poisons every fit (``:65-97``), and ``once=True``
  only the first.

Each test sets the harness's long vote and aggregation timeouts (the
harness does), ``ELECTION = "hash"`` and ``TRAIN_SET_SIZE = n``.
"""

import hashlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.attacks import AttackPlan as JaxPlan
from tpfl.attacks import AttackSpec as JaxSpec
from tpfl.attacks import adversary_map as jax_adversary_map
from tpfl.attacks import apply_chaos as jax_apply_chaos
from tpfl.attacks import assert_tables_allclose as jax_assert_tables_allclose
from tpfl.attacks import flatten_table as jax_flatten_table
from tpfl.attacks import metric_table as jax_metric_table
from tpfl.attacks import run_seeded_experiment as jax_run
from tpfl.communication.faults import FaultPlan as JaxFaultPlan
from tpfl.communication.faults import TrainerSpeedPlan as JaxTrainerSpeedPlan
from tpfl.communication.memory import clear_registry as jax_clear_registry
from tpfl.learning.dataset import RandomIIDPartitionStrategy as JaxRandomIID
from tpfl.learning.dataset import synthetic_mnist as jax_synthetic_mnist
from tpfl.learning.serialization import leaf_bytes as jax_leaf_bytes
from tpfl.management import ledger as jax_ledger
from tpfl.management import quarantine as jax_quarantine
from tpfl.management.logger import logger as jax_logger
from tpfl.models import create_model as jax_create_model
from tpfl.node import Node as JaxNode
from tpfl.settings import Settings as JaxSettings
from tpfl_torch.attacks import (
    AdversarialLearner,
    AttackPlan,
    AttackSpec,
    adversary_map,
    apply_chaos,
    assert_tables_allclose,
    controller_trajectories,
    final_model_digests,
    flatten_table,
    make_adversary,
    metric_table,
    run_seeded_experiment,
    sign_flip,
)
from tpfl_torch.attacks.harness import params_digest
from tpfl_torch.attacks.plan import PlannedAdversary, SlowLearner
from tpfl_torch.communication.faults import FaultPlan, TrainerSpeedPlan
from tpfl_torch.communication.memory import clear_registry
from tpfl_torch.interop import model_state_from_jax
from tpfl_torch.learning.dataset import RandomIIDPartitionStrategy
from tpfl_torch.learning.dataset.synthetic import synthetic_mnist
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.management import ledger, quarantine
from tpfl_torch.management.logger import logger
from tpfl_torch.models import MLP
from tpfl_torch.node import Node
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import tree_items

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _runtime_settings():
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


def _both(**knobs):
    for s in (Settings, JaxSettings):
        for k, v in knobs.items():
            setattr(s, k, v)


def jax_model_fn(seed):
    return jax_create_model("mlp", (28, 28), seed=seed, hidden_sizes=(32,),
                            compute_dtype=jnp.float32)


def port_model_fn(seed):
    return TpflModel(MLP(hidden_sizes=(32,), out_channels=10, compute_dtype=torch.float32),
                     **model_state_from_jax(jax_model_fn(seed), device="cpu"))


def jax_data_fn(seed):
    return jax_synthetic_mnist(n_train=600, n_test=120, seed=seed, noise=0.4)


def port_data_fn(seed):
    return synthetic_mnist(n_train=600, n_test=120, seed=seed, noise=0.4)


def both_runs(seed, n, rounds, **kw):
    """The same seeded experiment on both packages: (JAX name, port name).
    Both run at a 30 s ``HEARTBEAT_TIMEOUT``: no node of these runs is
    lost, and on a loaded host a heartbeat held up past the test
    profile's 2 s evicted a live peer from one package's train set."""
    _both(HEARTBEAT_TIMEOUT=30.0)
    port_kw = {k: v for k, v in kw.items() if k != "jax_attack_plan"}
    jax_kw = {k: v for k, v in kw.items() if k != "jax_attack_plan"}
    if "jax_attack_plan" in kw:
        jax_kw["attack_plan"] = kw["jax_attack_plan"]
    je = jax_run(seed, n, rounds, data_fn=jax_data_fn, model_fn=jax_model_fn,
                 samples_per_node=200, **jax_kw)
    pe = run_seeded_experiment(seed, n, rounds, data_fn=port_data_fn, model_fn=port_model_fn,
                               samples_per_node=200, device="cpu", **port_kw)
    return je, pe


def test_clean_seeded_experiment_matches_jax():
    _both(TRAIN_SET_SIZE=3)
    je, pe = both_runs(666, 3, 2)
    got, want = metric_table(pe), jax_metric_table(je)
    assert sorted(got) == sorted(want) == [f"seed666-n{i}" for i in range(3)]
    assert_tables_allclose(got, want, atol=ATOL)
    jax_assert_tables_allclose(got, want)
    np.testing.assert_array_equal(flatten_table(got), jax_flatten_table(got))
    assert flatten_table(got).size > 0
    digests = final_model_digests(pe)
    assert sorted(digests) == sorted(got) and len(set(digests.values())) == 1
    assert controller_trajectories(pe) == {a: [] for a in got}
    assert adversary_map(pe) == jax_adversary_map(je) == {}
    with pytest.raises(AssertionError):
        assert_tables_allclose(got, {a: {"test_metric": [(0, 9.0)]} for a in got})


def test_attacked_seeded_experiment_with_quarantine_matches_jax():
    _both(TRAIN_SET_SIZE=4, QUARANTINE_ENABLED=True, LEDGER_ENABLED=True)
    je, pe = both_runs(7, 4, 3, attack_plan=AttackPlan({1: AttackSpec("sign_flip")}, seed=5),
                       jax_attack_plan=JaxPlan({1: JaxSpec("sign_flip")}, seed=5))
    assert adversary_map(pe) == jax_adversary_map(je) == {"seed7-n1": "sign_flip"}
    replay = quarantine.replay_decisions()
    assert replay == jax_quarantine.replay_decisions()
    assert quarantine.quarantined_from_replay(replay) == {"seed7-n1"}
    got, want = metric_table(pe), jax_metric_table(je)
    assert_tables_allclose(got, want, atol=ATOL)


def test_harness_runs_on_the_card_unless_asked_for_the_cpu():
    """``device=None`` means the card: without one the harness raises,
    naming ``device="cpu"``, before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None would run there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_seeded_experiment(1, 2, 1, data_fn=port_data_fn)


def test_default_model_runs_and_digests_agree():
    _both(TRAIN_SET_SIZE=2)
    pe = run_seeded_experiment(3, 2, 1, data_fn=port_data_fn, samples_per_node=200,
                               device="cpu")
    digests = final_model_digests(pe)
    assert len(digests) == 2 and len(set(digests.values())) == 1
    assert metric_table(pe)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_digest_of_the_same_params_is_the_reference_hex(dtype):
    model = jax_create_model("mlp", (28, 28), seed=4, hidden_sizes=(16,))
    params = jax.tree_util.tree_map(lambda x: x.astype(dtype), model.get_parameters())
    h = hashlib.sha256()  # the reference harness's digest, leaf by leaf
    for leaf in jax.tree_util.tree_leaves(params):
        h.update(jax_leaf_bytes(np.asarray(leaf)))
    state = model_state_from_jax(model.build_copy(params=params), device="cpu")
    assert params_digest(state["params"]) == h.hexdigest()


def test_flatten_table_equals_the_reference():
    table = {"b": {"loss": [(1, 0.5), (0, 0.7)], "acc": [(0, 0.1)]},
             "a": {"acc": [(2, 0.9), (1, 0.8)]}}
    np.testing.assert_array_equal(flatten_table(table), jax_flatten_table(table))
    assert flatten_table(table).tolist() == [0.8, 0.9, 0.1, 0.7, 0.5]


def test_apply_chaos_composes_attack_and_fault_plans():
    parts = port_data_fn(0).generate_partitions(2, RandomIIDPartitionStrategy, seed=0)
    jparts = jax_data_fn(0).generate_partitions(2, JaxRandomIID, seed=0)
    nodes = [Node(port_model_fn(0), parts[i], addr=f"chaos-n{i}", device="cpu")
             for i in range(2)]
    jnodes = [JaxNode(jax_model_fn(0), jparts[i], addr=f"chaos-n{i}") for i in range(2)]
    try:
        truth, injector = apply_chaos(
            nodes, attack_plan=AttackPlan({1: AttackSpec("sign_flip")}, seed=5),
            fault_plan=FaultPlan.from_dict({"links": {"*->*": {"drop": 0.1}}}), seed=5)
        jtruth, jinjector = jax_apply_chaos(
            jnodes, attack_plan=JaxPlan({1: JaxSpec("sign_flip")}, seed=5),
            fault_plan=JaxFaultPlan.from_dict({"links": {"*->*": {"drop": 0.1}}}), seed=5)
        assert truth == jtruth == {"chaos-n1": "sign_flip"}
        assert isinstance(nodes[1].learner, PlannedAdversary)
        assert not isinstance(nodes[0].learner, PlannedAdversary)
        assert all(nd.communication._fault_injector is injector for nd in nodes)
        assert [injector.decide("chaos-n0", "chaos-n1").action for _ in range(30)] == [
            jinjector.decide("chaos-n0", "chaos-n1").action for _ in range(30)]
        assert apply_chaos(nodes) == ({}, None)
    finally:
        for nd in nodes + jnodes:
            nd.stop()


def _fit_params(learner):
    learner.set_epochs(1)
    return {p: v.clone() for p, v in tree_items(learner.fit().get_parameters())}


def test_make_adversary_poisons_every_fit():
    data = port_data_fn(0)
    # One address for all three (never started): the learners' batch
    # shuffles derive from it, so the honest fit is the adversary's.
    nodes = [Node(port_model_fn(0), data, addr="adv", device="cpu", batch_size=50)
             for _ in range(3)]
    honest, adv, once = nodes
    assert make_adversary(adv, sign_flip()) is adv
    make_adversary(once, sign_flip(), once=True)
    assert isinstance(adv.learner, AdversarialLearner)
    want = _fit_params(honest.learner)
    got = _fit_params(adv.learner)
    assert all(torch.equal(got[p], -want[p]) for p in want)  # the honest fit, negated
    assert adv.learner.get_num_samples() == data.num_samples()
    again = _fit_params(adv.learner)  # poisoned again: the flip of a fit from -w
    assert sum(float((again[p] + got[p]).abs().mean()) for p in got) < sum(
        float((again[p] - got[p]).abs().mean()) for p in got)
    first = _fit_params(once.learner)
    honest_again = _fit_params(once.learner)  # second fit: no attack, stays near -w
    assert sum(float((honest_again[p] - first[p]).abs().mean()) for p in first) < sum(
        float((honest_again[p] + first[p]).abs().mean()) for p in first)


def test_apply_speed_plan_slows_the_planned_trainers():
    """A ``TrainerSpeedPlan`` through ``apply_chaos`` wraps exactly the
    planned nodes' learners in ``SlowLearner``, as the reference's does;
    the slow fit returns the inner learner's fit after the planned
    delay."""
    parts = port_data_fn(0).generate_partitions(2, RandomIIDPartitionStrategy, seed=0)
    jparts = jax_data_fn(0).generate_partitions(2, JaxRandomIID, seed=0)
    nodes = [Node(port_model_fn(0), parts[i], addr=f"slow-n{i}", device="cpu", batch_size=100)
             for i in range(2)]
    jnodes = [JaxNode(jax_model_fn(0), jparts[i], addr=f"slow-n{i}") for i in range(2)]
    assert apply_chaos(nodes, speed_plan=TrainerSpeedPlan({"slow-n1": 0.05})) == ({}, None)
    jax_apply_chaos(jnodes, speed_plan=JaxTrainerSpeedPlan({"slow-n1": 0.05}))
    assert [isinstance(nd.learner, SlowLearner) for nd in nodes] == [
        type(nd.learner).__name__ == "SlowLearner" for nd in jnodes] == [False, True]
    slow = nodes[1].learner
    slow.set_epochs(1)
    t0 = time.monotonic()
    model = slow.fit()
    assert time.monotonic() - t0 >= 0.05 and model.get_num_samples() == parts[1].num_samples()
