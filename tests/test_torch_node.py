"""Federations of the port's ``Node`` (tpfl_torch.node) against the JAX
package's, on the CPU: the ports of ``tests/test_node.py``'s convergence
scenarios, each run first as a JAX federation and then as a port
federation with the same explicit addresses (learner shuffles and vote
draws derive from them), seeds, data and carried-across initial params.

- the MLP (28×28, hidden 32) on ``synthetic_mnist``, LINE topology with 2
  and 4 nodes, 2 rounds of 2 epochs, and a 3-node STAR started from a
  leaf;
- six nodes with ``TRAIN_SET_SIZE = 4`` on a FULL topology: two nodes a
  round take ``WaitAggregatedModelsStage`` and the FullModel diffusion,
  and the vote elects the same train sets in both packages;
- a 2-node federation of a narrow CNN (8×8×3, channels 4 / 8) with
  ``conv_impl="pallas"``: the plain conv versions on the port's side,
  the Pallas kernels in interpret mode on the JAX side.

Checks: every node's stage history (``1 + 4 × rounds`` entries in the
reference pattern), every port node's final params allclose to the same
node's in the JAX federation (rtol 1e-4, atol 1e-5: f32 compute; the
test profile folds in canonical order, ``AGG_STREAM_EAGER`` off), the
port's nodes agreeing among themselves within atol 1e-5 (tighter than
``check_equal_models``'s 0.1), and test accuracy above 0.5. Both packages
run at a ``HEARTBEAT_TIMEOUT`` of 30 s, so that a heartbeat delayed by a
loaded host evicts no live peer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpfl.node as jax_node
from tpfl.communication.memory import clear_registry as jax_clear_registry
from tpfl.learning.dataset import RandomIIDPartitionStrategy as JaxRandomIID
from tpfl.learning.dataset import TpflDataset as JaxDataset
from tpfl.learning.dataset import synthetic_mnist as jax_synthetic_mnist
from tpfl.models import CNN as JaxCNN
from tpfl.models import create_model as jax_create_model
from tpfl.settings import Settings as JaxSettings
from tpfl.utils import TopologyFactory as JaxTopologyFactory
from tpfl.utils import TopologyType as JaxTopologyType
from tpfl.utils import wait_convergence as jax_wait_convergence
from tpfl.utils import wait_to_finish as jax_wait_to_finish
from tpfl_torch.communication.memory import clear_registry
from tpfl_torch.interop import model_state_from_jax
from tpfl_torch.learning.dataset import RandomIIDPartitionStrategy, TpflDataset
from tpfl_torch.learning.dataset.synthetic import synthetic_classification, synthetic_mnist
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.models import CNN, MLP
from tpfl_torch.node import Node
from tpfl_torch.settings import Settings
from tpfl_torch.utils import (
    TopologyFactory,
    TopologyType,
    check_equal_models,
    wait_convergence,
    wait_to_finish,
)
from tpfl_torch.utils.tree import tree_items

RTOL, ATOL = 1e-4, 1e-5
HEARTBEAT_TIMEOUT = 30.0


@pytest.fixture(autouse=True)
def _runtime_settings():
    snaps = (Settings.snapshot(), JaxSettings.snapshot())
    Settings.set_test_settings()
    Settings.DISABLE_SIMULATION = JaxSettings.DISABLE_SIMULATION = True
    # No federation here loses a node, so no eviction is wanted: a JAX
    # node's first fit (its interpret-mode Pallas kernels compiling)
    # starves its heartbeater on a loaded host, and past the test
    # profile's 2 s the peers evicted each other and trained alone.
    Settings.HEARTBEAT_TIMEOUT = JaxSettings.HEARTBEAT_TIMEOUT = HEARTBEAT_TIMEOUT
    clear_registry()
    jax_clear_registry()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # one intra-op thread per node thread
    yield
    torch.set_num_threads(threads)
    clear_registry()
    jax_clear_registry()
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])


def assert_stage_history(node, rounds):
    h = node.learning_workflow.history
    assert h[0] == "StartLearningStage", h
    rest = h[1:]
    assert len(rest) == 4 * rounds, f"history: {h}"
    for r in range(rounds):
        chunk = rest[4 * r: 4 * r + 4]
        assert chunk[0] == "VoteTrainSetStage", h
        assert chunk[1] in ("TrainStage", "WaitAggregatedModelsStage"), h
        assert chunk[2] == "GossipModelStage", h
        assert chunk[3] == "RoundFinishedStage", h


MODELS = {
    "mlp": ((28, 28),
            lambda: dict(module="mlp", hidden_sizes=(32,), compute_dtype=jnp.float32),
            lambda: MLP(hidden_sizes=(32,), out_channels=10, compute_dtype=torch.float32)),
    "cnn": ((8, 8, 3),
            lambda: dict(module=JaxCNN(channels=(4, 8), dense=16, out_channels=10,
                                       compute_dtype=jnp.float32, conv_impl="pallas")),
            lambda: CNN(channels=(4, 8), dense=16, out_channels=10,
                        compute_dtype=torch.float32, conv_impl="pallas")),
}


def datasets(kind, n):
    """(JAX partitions, port partitions) of the same arrays."""
    if kind == "mlp":
        jds = jax_synthetic_mnist(n_train=200 * n, n_test=40 * n, seed=0, noise=0.4)
        pds = synthetic_mnist(n_train=200 * n, n_test=40 * n, seed=0, noise=0.4)
    else:
        arrays = synthetic_classification((8, 8, 3), n_train=128 * n, n_test=32 * n, seed=3,
                                          noise=0.15)
        jds, pds = JaxDataset.from_arrays(*arrays), TpflDataset.from_arrays(*arrays)
    return (jds.generate_partitions(n, JaxRandomIID, seed=1),
            pds.generate_partitions(n, RandomIIDPartitionStrategy, seed=1))


def federate(kind, n, topology, rounds, epochs, initiator=0, prefix="fed"):
    """The same federation on both packages; returns (JAX nodes' final
    params by path, port nodes), port nodes still running (stopped by
    the caller), JAX nodes stopped."""
    shape, jax_kwargs, port_module = MODELS[kind]
    addrs = [f"{prefix}-{i}" for i in range(n)]
    jparts, pparts = datasets(kind, n)
    train_kw = dict(learning_rate=0.1, batch_size=32 if kind == "mlp" else 16)

    kw = jax_kwargs()
    jnodes = [jax_node.Node(jax_create_model(kw.pop("module") if i == 0 else jax_kwargs()["module"],
                                             shape, seed=7, **kw), jparts[i], addr=addrs[i],
                            **train_kw) for i in range(n)]
    try:
        for nd in jnodes:
            nd.start()
        JaxTopologyFactory.connect_nodes(
            JaxTopologyFactory.generate_matrix(JaxTopologyType[topology], n), jnodes)
        jax_wait_convergence(jnodes, n - 1, only_direct=False, wait=10)
        jnodes[initiator].set_start_learning(rounds=rounds, epochs=epochs)
        jax_wait_to_finish(jnodes, timeout=120)
        for nd in jnodes:
            assert_stage_history(nd, rounds)
        jax_params = [{p: np.asarray(v) for p, v in
                       tree_items(nd.learner.get_model().get_parameters())} for nd in jnodes]
        jax_histories = [list(nd.learning_workflow.history) for nd in jnodes]
    finally:
        for nd in jnodes:
            nd.stop()

    kw = jax_kwargs()
    init = jax_create_model(kw.pop("module"), shape, seed=7, **kw)
    module = port_module()
    nodes = [Node(TpflModel(module, **model_state_from_jax(init, device="cpu")), pparts[i],
                  addr=addrs[i], device="cpu", **train_kw) for i in range(n)]
    for nd in nodes:
        nd.start()
    TopologyFactory.connect_nodes(TopologyFactory.generate_matrix(TopologyType[topology], n),
                                  nodes)
    wait_convergence(nodes, n - 1, only_direct=False, wait=10)
    nodes[initiator].set_start_learning(rounds=rounds, epochs=epochs)
    wait_to_finish(nodes, timeout=120)
    return jax_params, jax_histories, nodes


def check_against_jax(jax_params, jax_histories, nodes, rounds, min_acc=0.5):
    for nd, want, jh in zip(nodes, jax_params, jax_histories):
        assert_stage_history(nd, rounds)
        assert nd.learning_workflow.history == jh  # the same elections
        got = {p: v.numpy() for p, v in tree_items(nd.learner.get_model().get_parameters())}
        assert got.keys() == want.keys()
        for path in want:
            np.testing.assert_allclose(got[path], want[path], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{nd.addr} {path}")
    check_equal_models(nodes, atol=ATOL)
    accs = [nd.learner.evaluate()["test_metric"] for nd in nodes]
    assert all(a > min_acc for a in accs), accs


@pytest.mark.parametrize("n,rounds", [(2, 2), (4, 2)])
def test_line_federation_matches_jax(n, rounds):
    jp, jh, nodes = federate("mlp", n, "LINE", rounds, epochs=2, prefix=f"line{n}")
    try:
        check_against_jax(jp, jh, nodes, rounds)
    finally:
        for nd in nodes:
            nd.stop()


def test_star_federation_matches_jax():
    jp, jh, nodes = federate("mlp", 3, "STAR", 2, epochs=2, initiator=1, prefix="star")
    try:
        check_against_jax(jp, jh, nodes, 2)
    finally:
        for nd in nodes:
            nd.stop()


def test_six_nodes_non_elected_path_matches_jax():
    n, rounds = 6, 2
    assert Settings.TRAIN_SET_SIZE == JaxSettings.TRAIN_SET_SIZE == 4
    jp, jh, nodes = federate("mlp", n, "FULL", rounds, epochs=1, prefix="six")
    try:
        check_against_jax(jp, jh, nodes, rounds)
        waited = sum(nd.learning_workflow.history.count("WaitAggregatedModelsStage")
                     for nd in nodes)
        assert waited == (n - Settings.TRAIN_SET_SIZE) * rounds
    finally:
        for nd in nodes:
            nd.stop()


def test_cnn_pallas_federation_matches_jax():
    jp, jh, nodes = federate("cnn", 2, "LINE", 2, epochs=2, prefix="cnn")
    try:
        check_against_jax(jp, jh, nodes, 2)
    finally:
        for nd in nodes:
            nd.stop()
