"""Residual (delta) full-model gossip under ``Settings.WIRE_DELTA``, the
port against the JAX package, on the CPU:

- ``TpflModel.encode_parameters`` with ``WIRE_DELTA`` on and no
  ``delta_base``: the JAX package's bytes (dense v3 / v1, bf16 on the
  wire, a compressed codec);
- a 3-node FULL federation of MLP Nodes (hash election, one trainer a
  round, the same experiment name, addresses, seeds and data in both
  packages): the same trainers; in both, dense payloads only in round 0
  and residuals from each later round's trainer (``_kinds_hold``); the
  final params within rtol 1e-4, atol 1e-5 of the JAX federation's. Each
  package's delta-on run ends within ``DELTA_ATOL`` of its delta-off run,
  and the port's nodes within it of one another (the card's
  residual-gossip phase holds the port's two arms to the same bound);
- a peer that holds no base nacks each residual and gets the dense form
  in the same round, in both packages alike.
"""

import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpfl.node as jax_node
from tpfl.communication.memory import clear_registry as jax_clear_registry
from tpfl.learning.dataset import RandomIIDPartitionStrategy as JaxRandomIID
from tpfl.learning.dataset import synthetic_mnist as jax_synthetic_mnist
from tpfl.management.logger import logger as jax_logger
from tpfl.models import create_model as jax_create_model
from tpfl.settings import Settings as JaxSettings
from tpfl.utils import TopologyFactory as JaxTopologyFactory
from tpfl.utils import TopologyType as JaxTopologyType
from tpfl.utils import wait_convergence as jax_wait_convergence
from tpfl.utils import wait_to_finish as jax_wait_to_finish
from tpfl_torch.communication.memory import clear_registry
from tpfl_torch.interop import model_state_from_jax
from tpfl_torch.learning.dataset import RandomIIDPartitionStrategy
from tpfl_torch.learning.dataset.synthetic import synthetic_mnist
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.management.logger import logger
from tpfl_torch.models import MLP
from tpfl_torch.node import Node
from tpfl_torch.settings import Settings
from tpfl_torch.utils import TopologyFactory, TopologyType, wait_convergence, wait_to_finish
from tpfl_torch.utils.tree import tree_items

FED_RTOL, FED_ATOL = 1e-4, 1e-5
#: Delta-on against delta-off final params, absolute: a residual decodes
#: as ``(x − base) + base`` in f32, so an adopted model may move by an
#: ulp, and the fits after it move with it. Measured: the JAX package's
#: two runs end 0 apart, the port's nodes at most 6e-8 apart on the CPU
#: and its two arms 9.3e-10 apart on the card (``chip_smoke.py``'s
#: residual-gossip phase, which holds them to this bound); a residual
#: decoded against a wrong base moves the params by a whole update.
DELTA_ATOL = 1e-6
ROUNDS = 3


@pytest.fixture(autouse=True)
def _settings(monkeypatch):
    snaps = (Settings.snapshot(), JaxSettings.snapshot())
    for s in (Settings, JaxSettings):
        s.set_test_settings()
        s.DISABLE_SIMULATION = True
        s.ELECTION = "hash"
        s.TRAIN_SET_SIZE = 1
    levels = logger.get_level(), jax_logger.get_level()
    logger.set_level("ERROR")
    jax_logger.set_level("ERROR")
    clear_registry()
    jax_clear_registry()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    fixed = uuid.UUID(int=0x5EED_0000_0000_0000_0000_0000_0000_0D17)
    monkeypatch.setattr(uuid, "uuid4", lambda: fixed)
    yield
    torch.set_num_threads(threads)
    clear_registry()
    jax_clear_registry()
    logger.set_level(levels[0])
    jax_logger.set_level(levels[1])
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])


def _set_both(**knobs):
    for s in (Settings, JaxSettings):
        for k, v in knobs.items():
            setattr(s, k, v)


def jax_mlp():
    return jax_create_model("mlp", (28, 28), seed=7, hidden_sizes=(32,),
                            compute_dtype=jnp.float32)


def port_mlp():
    return TpflModel(MLP(hidden_sizes=(32,), out_channels=10, compute_dtype=torch.float32),
                     **model_state_from_jax(jax_mlp(), device="cpu"))


@pytest.mark.parametrize("codec,fmt,wire_dtype", [
    ("dense", 3, None), ("dense", 1, None), ("dense", 3, "bfloat16"), ("quant8+zlib", 3, None)])
def test_encode_without_a_base_is_the_jax_bytes(codec, fmt, wire_dtype):
    jm = jax_mlp()
    tm = TpflModel(MLP(hidden_sizes=(32,), out_channels=10, compute_dtype=torch.float32),
                   **model_state_from_jax(jm, device="cpu"))
    _set_both(WIRE_DELTA=True, WIRE_CODEC=codec, WIRE_FORMAT=fmt, WIRE_DTYPE=wire_dtype)
    assert tm.encode_parameters() == jm.encode_parameters()


def _record_kinds(nodes, sent):
    """Wrap each node's ``model_payload``: ``sent[(addr, round)]`` collects
    "delta" / "dense" per encode."""
    for nd in nodes:
        orig = nd.communication.model_payload

        def payload(model, delta_base=None, nd=nd, orig=orig):
            sent.setdefault((nd.addr, nd.state.round), set()).add(
                "dense" if delta_base is None else "delta")
            return orig(model, delta_base=delta_base) if delta_base is not None else orig(model)

        nd.communication.model_payload = payload


def _params(node):
    return {p: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for p, v in tree_items(node.learner.get_model().get_parameters())}


def _run(jax_side, n, prefix, no_base=(), delta=True):
    """One federation: n MLP Nodes on FULL, TRAIN_SET_SIZE 1, ROUNDS
    rounds. ``no_base``: indices whose base cache keeps nothing. Returns
    (payload kinds by (addr, round), final params by addr, trainers by
    round)."""
    (Settings if not jax_side else JaxSettings).WIRE_DELTA = delta
    if jax_side:
        ds = jax_synthetic_mnist(n_train=150 * n, n_test=30 * n, seed=0, noise=0.4)
        parts = ds.generate_partitions(n, JaxRandomIID, seed=1)
        nodes = [jax_node.Node(jax_mlp(), parts[i], addr=f"{prefix}-{i}", learning_rate=0.1,
                               batch_size=30) for i in range(n)]
        topo, conv, finish, log = JaxTopologyFactory, jax_wait_convergence, jax_wait_to_finish, \
            jax_logger
        matrix = JaxTopologyFactory.generate_matrix(JaxTopologyType.FULL, n)
    else:
        ds = synthetic_mnist(n_train=150 * n, n_test=30 * n, seed=0, noise=0.4)
        parts = ds.generate_partitions(n, RandomIIDPartitionStrategy, seed=1)
        nodes = [Node(port_mlp(), parts[i], addr=f"{prefix}-{i}", device="cpu",
                      learning_rate=0.1, batch_size=30) for i in range(n)]
        topo, conv, finish, log = TopologyFactory, wait_convergence, wait_to_finish, logger
        matrix = TopologyFactory.generate_matrix(TopologyType.FULL, n)
    for i in no_base:
        nodes[i].state.wire_bases.put = lambda *a, **k: None
    sent: dict = {}
    _record_kinds(nodes, sent)
    try:
        for nd in nodes:
            nd.start()
        topo.connect_nodes(matrix, nodes)
        conv(nodes, n - 1, only_direct=False, wait=10)
        exp = nodes[0].set_start_learning(rounds=ROUNDS, epochs=1)
        finish(nodes, timeout=60)
        finals = {nd.addr: _params(nd) for nd in nodes}
        logs = log.get_local_logs()[exp]
        # (The patched uuid gives every run one experiment name: keep
        # this run's nodes.)
        trainers = [sorted(a for a, m in logs[r].items()
                           if "train_loss" in m and a.startswith(f"{prefix}-"))
                    for r in range(ROUNDS)]
        nacked = [sorted(nd.state.delta_nack_peers) for nd in nodes]
    finally:
        for nd in nodes:
            nd.stop()
    return sent, finals, trainers, nacked


def _kinds_hold(sent, trainers):
    """What holds in every run of either package: round 0 sends only
    dense payloads, and from round 1 on each round's trainer sends
    residuals (every peer announced the previous round before it pushes).
    Which other pushes happen, and so where a peer that adopted a
    residual nacks the next one (its base then differs from the
    trainer's by the residual's rounding), depends on thread timing in
    both packages."""
    assert {k for (_, r), kinds in sent.items() if r == 0 for k in kinds} == {"dense"}
    for r in range(1, ROUNDS):
        assert "delta" in sent.get((trainers[r][0], r), set()), (r, sent)


def _max_diff(a, b):
    return max(float(np.max(np.abs(a[n][k] - b[n][k]))) for n in a for k in a[n])


def _within_delta_tol(a, b):
    for n in a:
        for k in a[n]:
            np.testing.assert_allclose(a[n][k], b[n][k], rtol=0, atol=DELTA_ATOL,
                                       err_msg=f"{n} {k}")


def test_delta_federation_matches_jax():
    jsent, jfinals, jtrainers, _ = _run(True, 3, "wd")
    _, joff, _, _ = _run(True, 3, "wd", delta=False)
    sent, finals, trainers, _ = _run(False, 3, "wd")
    _, off, _, _ = _run(False, 3, "wd", delta=False)
    assert trainers == jtrainers and all(len(t) == 1 for t in trainers)
    _kinds_hold(sent, trainers)
    _kinds_hold(jsent, jtrainers)
    for addr in jfinals:
        for k, want in jfinals[addr].items():
            np.testing.assert_allclose(finals[addr][k], want, rtol=FED_RTOL, atol=FED_ATOL,
                                       err_msg=f"{addr} {k}")
    _within_delta_tol(jfinals, joff)
    _within_delta_tol(finals, off)
    _within_delta_tol(finals, {a: finals[trainers[-1][0]] for a in finals})


def test_peer_without_the_base_nacks_and_gets_dense():
    """Node 0 keeps no base: every residual pushed to it is nacked, and
    the pusher (node 1, the trainer of every round under this experiment
    name) sends it the dense form in the same round; node 0 never sends a
    residual. Both packages send the same kinds (with two nodes each
    knows the other announced the previous round), and the federation
    ends on one model."""
    jsent, jfinals, jtrainers, _ = _run(True, 2, "nb", no_base=(0,))
    sent, finals, trainers, _ = _run(False, 2, "nb", no_base=(0,))
    assert trainers == jtrainers
    kinds = {r: sent.get(("nb-1", r)) for r in range(1, ROUNDS) if trainers[r] == ["nb-1"]}
    assert kinds, "node 1 must train in a round after the first"
    assert kinds == {r: jsent.get(("nb-1", r)) for r in kinds}
    assert all(k == {"delta", "dense"} for k in kinds.values())
    assert all(sent.get(("nb-0", r)) in (None, {"dense"}) for r in range(ROUNDS))
    assert _max_diff(finals, {a: finals["nb-1"] for a in finals}) == 0.0
    for addr in jfinals:
        for k, want in jfinals[addr].items():
            np.testing.assert_allclose(finals[addr][k], want, rtol=FED_RTOL, atol=FED_ATOL,
                                       err_msg=f"{addr} {k}")
