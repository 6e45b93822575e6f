"""A defended federation round of the port against the JAX package's, on
the CPU: six narrow-CNN learners per package (``TorchLearner`` /
``JaxLearner``, the same seed-0 params carried across, the same seeded
data split by ``RandomIIDPartitionStrategy``), an ``AttackPlan`` sign
flip on one of them and additive noise on another (through
``apply_attack_plan``), node 0's FedAvg with a ``QuarantineEngine`` at
its intake, the ledger's round opened on the round-start params. Two
rounds: the same quarantine set, live actions and ``replay_decisions``
in both packages, the aggregates within the training tolerance (rtol
1e-4, atol 1e-5), and the deterministic detections flag exactly the
planned adversaries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.attacks import AttackPlan as JaxPlan
from tpfl.attacks import apply_attack_plan as jax_apply_attack_plan
from tpfl.learning.aggregators import FedAvg as JaxFedAvg
from tpfl.learning.dataset import TpflDataset as JaxDataset
from tpfl.learning.dataset.partition_strategies import RandomIIDPartitionStrategy as JaxIID
from tpfl.learning.jax_learner import JaxLearner
from tpfl.management import ledger as jledger
from tpfl.management import quarantine as jquarantine
from tpfl.models import CNN as JaxCNN
from tpfl.models import create_model as jax_create_model
from tpfl.settings import Settings as JaxSettings
from tpfl_torch.attacks import AttackPlan, apply_attack_plan
from tpfl_torch.interop import model_state_from_jax, params_to_numpy
from tpfl_torch.learning.aggregators import FedAvg
from tpfl_torch.learning.dataset import RandomIIDPartitionStrategy, TpflDataset
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.learning.torch_learner import TorchLearner
from tpfl_torch.management import ledger, quarantine
from tpfl_torch.models import CNN
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import tree_items

RTOL, ATOL = 1e-4, 1e-5
N = 6
ADDRS = [f"node-{i}" for i in range(N)]
PLAN = {1: {"attack": "sign_flip"}, 4: {"attack": "additive_noise", "std": 0.5}}


@pytest.fixture(autouse=True)
def _isolated():
    snap, jsnap = Settings.snapshot(), JaxSettings.snapshot()
    for mod in (ledger, jledger):
        mod.contrib.reset()
        mod.convergence.reset()
    yield
    Settings.restore(snap)
    JaxSettings.restore(jsnap)
    for mod in (ledger, jledger):
        mod.contrib.reset()
        mod.convergence.reset()


class Node:
    def __init__(self, addr, learner):
        self.addr, self.learner = addr, learner


def _federation():
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(96, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, 96).astype(np.int32)
    xt = rng.uniform(size=(24, 8, 8, 3)).astype(np.float32)
    yt = rng.integers(0, 10, 24).astype(np.int32)
    jparts = JaxDataset.from_arrays(x, y, xt, yt).generate_partitions(N, JaxIID, seed=5)
    tparts = TpflDataset.from_arrays(x, y, xt, yt).generate_partitions(
        N, RandomIIDPartitionStrategy, seed=5)
    jm = jax_create_model(JaxCNN(channels=(4, 8), dense=16, out_channels=10,
                                 compute_dtype=jnp.float32, conv_impl="pallas"), (8, 8, 3), seed=0)
    state = model_state_from_jax(jm, device="cpu")
    jnodes, tnodes = [], []
    for i, addr in enumerate(ADDRS):
        jnodes.append(Node(addr, JaxLearner(jm.build_copy(params=jm.get_parameters()), jparts[i],
                                            addr=addr, learning_rate=0.1, batch_size=8)))
        tm = TpflModel(module=CNN(channels=(4, 8), dense=16, out_channels=10,
                                  compute_dtype=torch.float32, conv_impl="pallas"), **state)
        tnodes.append(Node(addr, TorchLearner(tm, tparts[i], addr=addr, learning_rate=0.1,
                                              batch_size=8, device="cpu")))
    jtruth = jax_apply_attack_plan(jnodes, JaxPlan.from_dict({"seed": 11, "peers": PLAN}))
    ttruth = apply_attack_plan(tnodes, AttackPlan.from_dict({"seed": 11, "peers": PLAN}))
    assert ttruth == jtruth == {"node-1": "sign_flip", "node-4": "additive_noise(std=0.5)"}
    return jnodes, tnodes


def _round(nodes, agg, rnd, to_host):
    start = to_host(nodes[0].learner.get_model().get_parameters())
    (jledger if agg.__module__.startswith("tpfl.") else ledger).contrib.open_round(
        "node-0", rnd, start)
    agg.set_nodes_to_aggregate(ADDRS)
    for node in nodes:
        agg.add_model(node.learner.fit())
    out = agg.wait_and_get_aggregation(timeout=30)
    agg.clear()
    for node in nodes:
        node.learner.set_model(out.get_parameters())
    return out


def test_defended_rounds_match_jax():
    for s in (Settings, JaxSettings):
        s.QUARANTINE_ENABLED = True
        s.AGG_STREAM_EAGER = False
        s.SEED = 0
    jnodes, tnodes = _federation()
    jeng, teng = jquarantine.QuarantineEngine("node-0"), quarantine.QuarantineEngine("node-0")
    jagg, tagg = JaxFedAvg("node-0"), FedAvg("node-0", device="cpu")
    jagg.set_quarantine(jeng)
    tagg.set_quarantine(teng)
    for rnd in range(2):
        jout = _round(jnodes, jagg, rnd,
                      lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)), t))
        tout = _round(tnodes, tagg, rnd, lambda t: {k: {n: v.clone() for n, v in layer.items()}
                                                    for k, layer in t.items()})
        # Live: the sign flip needs no history; the noise's norm test
        # needs LEDGER_ANOMALY_MIN_N clean entries of earlier rounds.
        want = {"node-1"} if rnd == 0 else {"node-1", "node-4"}
        assert teng.quarantined() == jeng.quarantined() == want
        assert teng.actions() == jeng.actions()
        assert tout.get_contributors() == jout.get_contributors() == ADDRS
        assert tout.get_num_samples() == jout.get_num_samples()
        got = dict(tree_items(params_to_numpy(tout.get_parameters())))
        for path, w in tree_items(jax.tree_util.tree_map(np.asarray, jout.get_parameters())):
            np.testing.assert_allclose(got[path], w, rtol=RTOL, atol=ATOL, err_msg=path)
    assert quarantine.replay_decisions() == jquarantine.replay_decisions()
    assert quarantine.quarantined_from_replay() == jquarantine.quarantined_from_replay()
    # The deduped verdict scores every entry against all rounds'
    # baseline: both planned adversaries, nothing else.
    flagged = set(ledger.contrib.detections()["flagged"])
    assert flagged == set(jledger.contrib.detections()["flagged"]) == {"node-1", "node-4"}
