"""The port's FederationLearner (tpfl_torch.parallel.federation_learner)
against the JAX package's, on the CPU: the scenarios of
``tests/test_parallel.py::test_federation_learner_hierarchical`` and
``tests/test_elastic.py``'s learner-level tests, each on both packages
from the same params and data (f32 MLP, dense engine exchange; rtol
1e-4, atol 1e-5).

- one fit of 2 local rounds in windows of 1 (the seeded per-window batch
  order) allclose to the JAX learner's, and the same bytes with
  ``ENGINE_PREFETCH`` on and off;
- the hierarchical federation: 2 gossiping Nodes, each a
  FederationLearner of 4 local rows, the pool on, allclose to the JAX
  federation's and agreeing;
- a membership mask within a tier (no restack) and a tier change
  (restack), against the JAX learner;
- ``interrupt_for`` mid-fit: the skip keeps the pre-fit model;
- ``CHECKPOINT_DIR`` cadence snapshots, resumed byte-identical;
- ``evaluate`` against JAX's, and a one-rank mesh's fit equal to no mesh's.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpfl.node as jax_node
from tpfl.communication.memory import clear_registry as jax_clear_registry
from tpfl.learning.dataset import RandomIIDPartitionStrategy as JaxRandomIID
from tpfl.learning.dataset import synthetic_mnist as jax_synthetic_mnist
from tpfl.models import create_model as jax_create_model
from tpfl.parallel import FederationLearner as JaxFederationLearner
from tpfl.parallel.membership import MembershipView as JaxView
from tpfl.settings import Settings as JaxSettings
from tpfl.simulation import SuperLearnerPool as JaxPool
from tpfl.utils import wait_convergence as jax_wait_convergence
from tpfl.utils import wait_to_finish as jax_wait_to_finish
from tpfl_torch.communication.memory import clear_registry
from tpfl_torch.interop import model_state_from_jax
from tpfl_torch.learning.dataset import RandomIIDPartitionStrategy
from tpfl_torch.learning.dataset.synthetic import synthetic_mnist
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.management.checkpoint import EngineCheckpointer
from tpfl_torch.models import MLP
from tpfl_torch.node import Node
from tpfl_torch.parallel import FederationLearner, VmapFederation
from tpfl_torch.parallel.membership import MembershipView
from tpfl_torch.settings import Settings
from tpfl_torch.simulation import SuperLearnerPool
from tpfl_torch.utils import check_equal_models, wait_convergence, wait_to_finish
from tpfl_torch.utils.tree import tree_items

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _settings():
    snaps = (Settings.snapshot(), JaxSettings.snapshot())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for s in (Settings, JaxSettings):
        s.set_test_settings()
        s.ENGINE_WIRE_CODEC = "dense"
        s.SHARD_ROUNDS_PER_DISPATCH = 1
    yield
    SuperLearnerPool.reset()
    JaxPool.reset(clear_compiled=False)
    torch.set_num_threads(threads)
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])


def _jax_model(hidden=(8,)):
    return jax_create_model("mlp", (28, 28), seed=7, hidden_sizes=hidden,
                            compute_dtype=jnp.float32)


def _port_model(hidden=(8,)):
    return TpflModel(MLP(hidden_sizes=hidden, out_channels=10, compute_dtype=torch.float32),
                     **model_state_from_jax(_jax_model(hidden), device="cpu"))


def _pair(n_local=4, hidden=(8,), **kw):
    """(JAX learner, port learner) over the same params and data."""
    args = dict(addr="host-0", n_local_nodes=n_local, local_rounds=2, learning_rate=0.1,
                batch_size=8, seed=0, **kw)
    jl = JaxFederationLearner(model=_jax_model(hidden), data=jax_synthetic_mnist(
        n_train=256, n_test=64, seed=0, noise=0.4), **args)
    tl = FederationLearner(model=_port_model(hidden), data=synthetic_mnist(
        n_train=256, n_test=64, seed=0, noise=0.4), device="cpu", **args)
    return jl, tl


def _params(model):
    return {p: np.asarray(v) for p, v in tree_items(model.get_parameters())}


def _close(got, want, tol=TOL):
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=path, **tol)


def test_fit_matches_jax_and_prefetch_keeps_bytes():
    Settings.ENGINE_PREFETCH = JaxSettings.ENGINE_PREFETCH = False
    jl, tl = _pair()
    want = _params(jl.fit())
    got = _params(tl.fit())
    _close(got, want)
    Settings.ENGINE_PREFETCH = True
    _, piped = _pair()
    _close(_params(piped.fit()), got, dict(rtol=0, atol=0))
    assert not [t for t in threading.enumerate() if t.name.startswith("tpfl-window-prefetch")]
    assert tl.get_model().get_num_samples() == 256


def test_federation_learner_hierarchical():
    """2 protocol hosts x 4 local rows: the outer gossip runs 2 Nodes while
    8 logical nodes train; the hosts agree and match the JAX federation."""
    clear_registry()
    jax_clear_registry()
    jds = jax_synthetic_mnist(n_train=1600, n_test=320, seed=0, noise=0.4)
    pds = synthetic_mnist(n_train=1600, n_test=320, seed=0, noise=0.4)
    jshards = jds.generate_partitions(2, JaxRandomIID, seed=0)
    pshards = pds.generate_partitions(2, RandomIIDPartitionStrategy, seed=0)
    kw = dict(n_local_nodes=4, local_rounds=2, learning_rate=0.1, batch_size=25)
    jnodes = [jax_node.Node(_jax_model((32,)), jshards[i], addr=f"slice-{i}",
                            learner=JaxFederationLearner(seed=i, **kw)) for i in range(2)]
    try:
        for nd in jnodes:
            nd.start()
        jnodes[0].connect(jnodes[1].addr)
        jax_wait_convergence(jnodes, 1, wait=10)
        jnodes[0].set_start_learning(rounds=2, epochs=1)
        jax_wait_to_finish(jnodes, timeout=240)
        want = [_params(nd.learner.get_model()) for nd in jnodes]
    finally:
        for nd in jnodes:
            nd.stop()
    nodes = [Node(_port_model((32,)), pshards[i], addr=f"slice-{i}", device="cpu",
                  learner=FederationLearner(seed=i, device="cpu", **kw)) for i in range(2)]
    try:
        for nd in nodes:
            nd.start()
        nodes[0].connect(nodes[1].addr)
        wait_convergence(nodes, 1, wait=10)
        nodes[0].set_start_learning(rounds=2, epochs=1)
        wait_to_finish(nodes, timeout=240)
        check_equal_models(nodes, atol=1e-5)
        for nd, w in zip(nodes, want):
            _close(_params(nd.learner.get_model()), w)
        assert nodes[0].learner.evaluate()["test_metric"] > 0.5
    finally:
        for nd in nodes:
            nd.stop()
        clear_registry()
        jax_clear_registry()


def test_learner_fit_with_membership_mask():
    jl, tl = _pair(n_local=4)
    for learner, cls in ((jl, JaxView), (tl, MembershipView)):
        view = cls([f"n{i}" for i in range(4)], capacity_min=4)
        view.quarantine("n3")
        learner.set_membership(view)
    want = _params(jl.fit())
    model = tl.fit()
    assert model.get_contributors() == ["host-0"] and tl.n_local_nodes == 4
    _close(_params(model), want)


def test_learner_fit_restacks_on_tier_change():
    jl, tl = _pair(n_local=4)
    views = []
    for learner, cls in ((jl, JaxView), (tl, MembershipView)):
        view = cls([f"n{i}" for i in range(4)], capacity_min=4)
        learner.set_membership(view)
        learner.fit()
        views.append(view)
    fed_before = tl._fed
    for view in views:
        for i in range(4, 6):
            view.join(f"n{i}")
    assert views[1].capacity == 8
    want = _params(jl.fit())
    model = tl.fit()
    assert tl.n_local_nodes == 8 and tl._fed is not fed_before
    assert tl._fed.engine.membership is views[1]
    assert model.get_contributors() == ["host-0"]
    _close(_params(model), want)


def test_learner_interrupt_via_registry_skips_fit():
    from tpfl_torch.parallel.window_pipeline import interrupt_for

    Settings.ENGINE_PREFETCH = True
    _, learner = _pair(n_local=4)
    learner.local_rounds = 6
    learner.set_membership(MembershipView([f"n{i}" for i in range(4)], capacity_min=4))
    before = {p: v.clone() for p, v in tree_items(learner.get_model().get_parameters())}
    fired = threading.Event()
    orig = learner._window_weights

    def tap(widx):
        if widx == 2 and not fired.is_set():
            fired.set()
            assert interrupt_for("host-0")
        return orig(widx)

    learner._window_weights = tap
    model = learner.fit()
    assert fired.is_set() and model.get_num_samples() == 0
    for path, v in tree_items(model.get_parameters()):
        assert torch.equal(v, before[path]), path


@pytest.mark.parametrize("prefetch", [False, True])
def test_checkpoint_cadence_resumes_byte_identical(tmp_path, prefetch):
    """CHECKPOINT_DIR / CHECKPOINT_EVERY_WINDOWS: a fit "killed" after 2
    windows leaves its snapshot; a fresh engine resumed from it runs
    windows 2 and 3 on the learner's data stream and ends on the bytes of
    an uninterrupted 4-window fit."""
    Settings.ENGINE_PREFETCH = prefetch
    Settings.CHECKPOINT_DIR = str(tmp_path)
    Settings.CHECKPOINT_EVERY_WINDOWS = 2
    _, killed = _pair(n_local=4)
    killed.fit()
    state, meta = EngineCheckpointer(str(tmp_path)).restore()
    assert meta["step"] == state["rounds_done"] == 2
    Settings.CHECKPOINT_DIR = ""
    _, whole = _pair(n_local=4)
    whole.local_rounds = 4
    final = _params(whole.fit())
    resumed = VmapFederation(whole.get_model().module, 4, learning_rate=0.1, seed=0,
                             device="cpu")
    p = resumed.engine.import_state(state)["params"]
    for widx in (2, 3):
        xs, ys = whole._window_data(widx, widx, 1)
        p, _ = resumed.run_rounds(p, xs, ys, n_rounds=1)
    _close({path: v[0].numpy() for path, v in tree_items(p)}, final, dict(rtol=0, atol=0))


def test_evaluate_matches_jax():
    jl, tl = _pair(n_local=4)
    got, want = tl.evaluate(), jl.evaluate()
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], **TOL)


def test_mesh_is_refused_naming_item_7():
    """No longer refused (item 7's mesh is ported, and the pool's chunk
    shards over ranks too: tests/test_torch_sharded_pool.py): a learner on
    a one-rank ``nodes`` mesh fits the bytes of the learner without one,
    its model the JAX learner's, and ``"auto"`` resolves to no mesh in a
    lone process."""
    import torch.distributed as dist

    from tpfl_torch.parallel import create_mesh

    assert FederationLearner(model=_port_model(), mesh="auto", device="cpu").mesh == "auto"
    jl, plain = _pair(n_local=4)
    mesh = create_mesh({"nodes": 1}, device="cpu")
    try:
        _, meshed = _pair(n_local=4, mesh=None)
        meshed.mesh = mesh
        got, base, want = meshed.fit(), plain.fit(), jl.fit()
        assert meshed._fed.engine.mesh is mesh and plain._fed.engine.mesh is None
    finally:
        dist.destroy_process_group()
    got = {p: v.numpy() for p, v in tree_items(got.get_parameters())}
    _close(got, {p: v.numpy() for p, v in tree_items(base.get_parameters())},
           dict(rtol=0, atol=0))
    _close(got, {p: np.asarray(v) for p, v in tree_items(want.get_parameters())}, TOL)
