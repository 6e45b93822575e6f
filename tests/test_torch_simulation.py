"""The port's simulation layer (tpfl_torch.simulation) against the JAX
package's, on the CPU: the scenarios of ``tests/test_simulation.py``, each
on both packages where it computes.

- the pool's singleton, the activation hook, the virtual learner's
  delegation;
- concurrent fits batching into one program, and the pooled fits allclose
  to the JAX pool's from the same params and data (rtol 1e-4, atol 1e-5,
  the learner tests' tolerance: f32, reduction order only);
- batched == inline inside the port at the reference's rtol 2e-5, atol
  2e-6: twins, unequal partitions (padding), chunking (SIM_MAX_BATCH_NODES
  = 3 gives chunks [2, 3]), the CNN through the conv kernels' plain
  versions, FedProx and SCAFFOLD callbacks;
- the heterogeneous fallback, a failed chunk falling back (counted), a
  device error reaching the node, an interrupt before dispatch skipping;
- process isolation: allclose to the inline fit, a crash contained, an
  innocent bystander surviving, the scope gates;
- ``reset`` dropping the programs and a refit giving the same bytes;
- a 4-node in-memory federation with the pool on (one batched dispatch of
  the 4 fits a round), allclose to a JAX pooled federation from the same
  addresses, seeds and data.
"""

import pickle
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpfl.node as jax_node
import tpfl.simulation.pool as jax_pool_mod
from tpfl.communication.memory import clear_registry as jax_clear_registry
from tpfl.learning.dataset import RandomIIDPartitionStrategy as JaxRandomIID
from tpfl.learning.dataset import synthetic_mnist as jax_synthetic_mnist
from tpfl.learning.jax_learner import JaxLearner
from tpfl.models import create_model as jax_create_model
from tpfl.settings import Settings as JaxSettings
from tpfl.simulation import SuperLearnerPool as JaxPool
from tpfl.simulation import VirtualNodeLearner as JaxVirtual
from tpfl.utils import TopologyFactory as JaxTopologyFactory
from tpfl.utils import TopologyType as JaxTopologyType
from tpfl.utils import wait_convergence as jax_wait_convergence
from tpfl.utils import wait_to_finish as jax_wait_to_finish
from tpfl_torch.communication.memory import clear_registry
from tpfl_torch.interop import model_state_from_jax
from tpfl_torch.learning.aggregators import FedProx, Scaffold
from tpfl_torch.learning.dataset import RandomIIDPartitionStrategy, TpflDataset
from tpfl_torch.learning.dataset.synthetic import synthetic_classification, synthetic_mnist
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.learning.torch_learner import SGDMomentum, TorchLearner
from tpfl_torch.models import CNN, MLP
from tpfl_torch.node import Node
from tpfl_torch.parallel.engine import maybe_nodes_mesh
from tpfl_torch.settings import Settings
from tpfl_torch.simulation import (
    SuperLearnerPool,
    VirtualNodeLearner,
    batched_fit,
    isolated,
    try_init_learner_with_simulation,
)
from tpfl_torch.simulation import pool as pool_mod
from tpfl_torch.utils import TopologyFactory, TopologyType, wait_convergence, wait_to_finish
from tpfl_torch.utils.tree import tree_items

EXACT = dict(rtol=2e-5, atol=2e-6)  # batched vs inline, the reference's bound
PARITY = dict(rtol=1e-4, atol=1e-5)  # port vs JAX, test_torch_learner.py's


@pytest.fixture(autouse=True)
def _fresh():
    snaps = (Settings.snapshot(), JaxSettings.snapshot())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    SuperLearnerPool.reset()
    JaxPool.reset(clear_compiled=False)
    yield
    SuperLearnerPool.reset()
    JaxPool.reset(clear_compiled=False)
    torch.set_num_threads(threads)
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])


def _jax_model(hidden=(16,)):
    return jax_create_model("mlp", (28, 28), seed=3, hidden_sizes=hidden,
                            compute_dtype=jnp.float32)


def make_pair(addr, n=128, seed=0, hidden=(16,), aggs=(None, None)):
    """A JaxLearner and a TorchLearner over the same params and data."""
    jm = _jax_model(hidden)
    tm = TpflModel(MLP(hidden_sizes=hidden, out_channels=10, compute_dtype=torch.float32),
                   **model_state_from_jax(jm, device="cpu"))
    jl = JaxLearner(model=jm, data=jax_synthetic_mnist(n_train=n, n_test=32, seed=seed),
                    addr=addr, aggregator=aggs[0], learning_rate=0.1, batch_size=32)
    tl = TorchLearner(tm, synthetic_mnist(n_train=n, n_test=32, seed=seed), addr=addr,
                      aggregator=aggs[1], learning_rate=0.1, batch_size=32, device="cpu")
    return jl, tl


def make_learner(addr, n=128, seed=0, hidden=(16,)):
    return make_pair(addr, n, seed, hidden)[1]


def fit_together(learners, virtual=VirtualNodeLearner, timeout=120):
    """Each learner's fit through the pool, all at once."""
    wrapped = [virtual(ln) for ln in learners]
    threads = [threading.Thread(target=w.fit) for w in wrapped]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads)


def params(learner):
    return {p: np.asarray(v) for p, v in tree_items(learner.get_model().get_parameters())}


def assert_close(got, want, tol, what=""):
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=f"{what} {path}", **tol)


def test_singleton_semantics():
    a = SuperLearnerPool.instance()
    assert SuperLearnerPool.instance() is a
    SuperLearnerPool.reset()
    assert SuperLearnerPool.instance() is not a


def test_activation_hook():
    ln = make_learner("hook-node")
    wrapped = try_init_learner_with_simulation(ln)
    assert isinstance(wrapped, VirtualNodeLearner)
    assert try_init_learner_with_simulation(wrapped) is wrapped
    Settings.DISABLE_SIMULATION = True
    assert try_init_learner_with_simulation(ln) is ln
    import tpfl.simulation as jax_sim
    import tpfl_torch.simulation as port_sim

    assert port_sim.__all__ == jax_sim.__all__


def test_virtual_learner_delegates():
    jl, ln = make_pair("deleg-node")
    v, jv = VirtualNodeLearner(ln), JaxVirtual(jl)
    assert v.get_addr() == "deleg-node"
    assert v.get_model() is ln.get_model()
    v.set_epochs(3)
    assert ln.epochs == 3 and v.epochs == 3
    assert v.get_num_samples() == ln.get_num_samples() == jv.get_num_samples()
    got, want = v.evaluate(), jv.evaluate()
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], **PARITY)


def test_concurrent_fits_batch_into_one_program(monkeypatch):
    """4 concurrent fits of one signature -> one batched call, in both
    packages; the port's pooled fits allclose to the JAX pool's."""
    calls, jcalls = [], []
    real, jreal = pool_mod.run_batched_fits, jax_pool_mod.run_batched_fits
    monkeypatch.setattr(pool_mod, "run_batched_fits",
                        lambda sig, lns, *a: calls.append(len(lns)) or real(sig, lns, *a))
    monkeypatch.setattr(jax_pool_mod, "run_batched_fits",
                        lambda sig, lns: jcalls.append(len(lns)) or jreal(sig, lns))
    pairs = [make_pair(f"bn-{i}", seed=i) for i in range(4)]
    before = [params(tl) for _, tl in pairs]
    fit_together([jl for jl, _ in pairs], JaxVirtual)
    fit_together([tl for _, tl in pairs])
    assert calls == jcalls == [4]
    pool = SuperLearnerPool.instance()
    assert (pool.batched_dispatches, pool.group_sizes, pool.fallbacks) == (1, [4], 0)
    for (jl, tl), b4 in zip(pairs, before):
        got = params(tl)
        assert any(not np.allclose(got[p], b4[p]) for p in got)
        assert tl.get_model().get_num_samples() == 128
        assert tl.get_model().get_contributors() == [tl.get_addr()]
        want = {p: np.asarray(v) for p, v in tree_items(jl.get_model().get_parameters())}
        assert_close(got, want, PARITY, tl.get_addr())


def test_batched_matches_inline_exactly():
    """The same node trained batched (a group of 2 clones) and inline."""
    a, b, inline = (make_learner("twin", n=96, seed=5) for _ in range(3))
    for ln in (a, b, inline):
        ln.set_epochs(1)
    want = {p: np.asarray(v) for p, v in tree_items(inline.fit().get_parameters())}
    fit_together([a, b])
    for ln in (a, b):
        assert_close(params(ln), want, EXACT)


def test_unequal_partition_sizes_batch_with_padding():
    """Different batch counts batch together; padded batches are no-ops."""
    big = make_learner("pad-big", n=160, seed=1)
    small = make_learner("pad-small", n=64, seed=2)
    solo = make_learner("pad-small", n=64, seed=2)
    want = {p: np.asarray(v) for p, v in tree_items(solo.fit().get_parameters())}
    fit_together([big, small])
    assert_close(params(small), want, EXACT)
    assert small.get_model().get_num_samples() == 64
    assert big.get_model().get_num_samples() == 160


def test_heterogeneous_jobs_fall_back():
    """Different architectures cannot batch; both still train, alone."""
    a = make_learner("het-a", hidden=(16,))
    b = make_learner("het-b", hidden=(24,))
    fit_together([a, b])
    pool = SuperLearnerPool.instance()
    assert (pool.singles, pool.batched_dispatches, pool.fallbacks) == (2, 0, 0)
    for ln in (a, b):
        assert ln.get_model().get_num_samples() == 128


def test_chunking_respects_max_batch_nodes(monkeypatch):
    chunks = []
    real = batched_fit._run_chunk
    monkeypatch.setattr(batched_fit, "_run_chunk",
                        lambda prog, lns: chunks.append(len(lns)) or real(prog, lns))
    Settings.SIM_MAX_BATCH_NODES = 3
    fit_together([make_learner(f"ch-{i}", seed=i) for i in range(5)], timeout=180)
    assert sorted(chunks) == [2, 3]
    assert sorted(SuperLearnerPool.instance().group_sizes) == [2, 3]
    assert maybe_nodes_mesh(4) is None  # one device: the chunk is not sharded


def test_failed_chunk_falls_back_and_is_counted(monkeypatch):
    """A chunk that fails before training falls back to the learners' own
    fits (the same numbers as inline), counted as fallbacks."""
    monkeypatch.setattr(batched_fit, "_run_chunk",
                        lambda prog, lns: (_ for _ in ()).throw(ValueError("no chunk")))
    lns = [make_learner(f"fb-{i}", n=96, seed=i) for i in range(2)]
    twins = [make_learner(f"fb-{i}", n=96, seed=i) for i in range(2)]
    fit_together(lns)
    pool = SuperLearnerPool.instance()
    assert (pool.fallbacks, pool.batched_dispatches) == (2, 0)
    for ln, twin in zip(lns, twins):
        want = {p: np.asarray(v) for p, v in tree_items(twin.fit().get_parameters())}
        assert_close(params(ln), want, EXACT)


def test_device_error_is_not_a_fallback(monkeypatch):
    """A CUDA error in a batched chunk reaches every fitting node: the
    pool never hides a device or kernel fault behind a fallback fit."""
    monkeypatch.setattr(batched_fit, "_run_chunk", lambda prog, lns: (_ for _ in ()).throw(
        RuntimeError("CUDA error: an illegal instruction was encountered")))
    wrapped = [VirtualNodeLearner(make_learner(f"dev-{i}", seed=i)) for i in range(2)]
    with ThreadPoolExecutor(2) as tp:
        futs = [tp.submit(w.fit) for w in wrapped]
        for f in futs:
            with pytest.raises(RuntimeError, match="CUDA error"):
                f.result(timeout=60)
    assert SuperLearnerPool.instance().fallbacks == 0


def test_interrupt_before_dispatch_skips_the_fit():
    a, b = make_learner("int-a", seed=1), make_learner("int-b", seed=2)
    before = params(b)
    prog = batched_fit.BatchedFitProgram(a)
    b.interrupt_fit()
    assert batched_fit._run_chunk(prog, [a, b]) == 1
    assert b._last_fit_model.get_num_samples() == 0
    assert_close(params(b), before, dict(rtol=0, atol=0))


@pytest.mark.parametrize("kind", ["cnn", "fedprox", "scaffold"])
def test_batched_kinds_match_inline(kind):
    """The CNN through the conv kernels' plain versions, FedProx's pull and
    SCAFFOLD's correction and averaged gradient: batched == inline, and
    the shipped callback info the same."""
    def learner(addr):
        if kind == "cnn":
            module = CNN(channels=(4, 8), dense=16, out_channels=10,
                         compute_dtype=torch.float32, conv_impl="pallas")
            arrays = synthetic_classification((8, 8, 3), n_train=48, n_test=8, seed=3)
            from tpfl_torch.models.zoo import init_params

            model = TpflModel(module, init_params(module, (8, 8, 3), seed=4, device="cpu"),
                              device="cpu")
            return TorchLearner(model, TpflDataset.from_arrays(*arrays), addr=addr,
                                learning_rate=0.1, batch_size=16, device="cpu")
        agg = FedProx(device="cpu") if kind == "fedprox" else Scaffold(device="cpu")
        jl, tl = make_pair(addr, n=96, seed=7, aggs=(None, agg))
        return tl

    a, b, inline = (learner("kind-twin") for _ in range(3))
    for ln in (a, b, inline):
        ln.set_epochs(1)
    model = inline.fit()
    want = {p: np.asarray(v) for p, v in tree_items(model.get_parameters())}
    fit_together([a, b])
    for ln in (a, b):
        assert_close(params(ln), want, EXACT, kind)
        info = ln._last_fit_model.get_info()
        for name, value in model.get_info().items():
            if isinstance(value, dict):
                for k, v in value.items():
                    if isinstance(v, dict):
                        assert_close({p: np.asarray(x) for p, x in tree_items(info[name][k])},
                                     {p: np.asarray(x) for p, x in tree_items(v)}, EXACT,
                                     f"{name}/{k}")


def test_isolated_fit_matches_inline():
    iso = make_learner("iso-twin", n=96, seed=5)
    inline = make_learner("iso-twin", n=96, seed=5)
    for ln in (iso, inline):
        ln.set_epochs(1)
    want_model = inline.fit()
    try:
        fitted = isolated.isolated_fit(iso)
    finally:
        isolated.shutdown()
    got = {p: np.asarray(v) for p, v in tree_items(fitted.get_parameters())}
    assert_close(got, {p: np.asarray(v) for p, v in tree_items(want_model.get_parameters())},
                 EXACT)
    assert fitted.get_contributors() == ["iso-twin"]
    assert fitted.get_num_samples() == want_model.get_num_samples()


def test_isolated_fit_contains_worker_crash():
    ln = make_learner("iso-crash", n=96, seed=6)
    ln.set_epochs(1)
    job = pickle.loads(isolated.extract_job(ln))
    job["_test_crash"] = True
    try:
        with pytest.raises(RuntimeError, match="worker died"):
            isolated.isolated_fit(ln, pickle.dumps(job))
        assert isolated.isolated_fit(ln) is not None
    finally:
        isolated.shutdown()


def test_isolated_fit_innocent_bystander_survives_pool_break():
    innocent = make_learner("iso-innocent", n=96, seed=7)
    crasher = make_learner("iso-crasher", n=96, seed=8)
    for ln in (innocent, crasher):
        ln.set_epochs(1)
    job = pickle.loads(isolated.extract_job(crasher))
    job["_test_crash"] = True
    try:
        with ThreadPoolExecutor(2) as tp:
            f_inn = tp.submit(isolated.isolated_fit, innocent)
            time.sleep(0.3)
            f_crash = tp.submit(isolated.isolated_fit, crasher, pickle.dumps(job))
            with pytest.raises(RuntimeError, match="worker died"):
                f_crash.result(timeout=180)
            assert f_inn.result(timeout=180).get_contributors() == ["iso-innocent"]
    finally:
        isolated.shutdown()


def test_isolation_scope_gates():
    ln = make_learner("iso-scope", n=64)
    assert isolated.extract_job(ln) is not None
    custom = TorchLearner(ln.get_model(), synthetic_mnist(n_train=64, n_test=32, seed=0),
                          addr="iso-scope-2", device="cpu",
                          optimizer_factory=lambda lr: SGDMomentum(lr, momentum=0.0))
    assert isolated.extract_job(custom) is None
    scaffold = make_pair("iso-scope-3", aggs=(None, Scaffold(device="cpu")))[1]
    assert isolated.extract_job(scaffold) is None


def test_clear_compiled_caches_recompiles_identically():
    """reset() drops the per-signature programs; a fresh identical pooled
    fit builds them again and gives the same bytes."""
    def pooled():
        lns = [make_learner(f"cache-{i}", n=96, seed=11) for i in range(2)]
        for ln in lns:
            ln.set_epochs(1)
        fit_together(lns)
        return params(lns[0])

    first = pooled()
    assert batched_fit._programs
    SuperLearnerPool.reset()
    assert not batched_fit._programs
    assert_close(pooled(), first, dict(rtol=0, atol=0))


def _jax_federation(addrs, parts, rounds, epochs):
    nodes = [jax_node.Node(_jax_model((32,)), parts[i], addr=a, learning_rate=0.1, batch_size=32)
             for i, a in enumerate(addrs)]
    try:
        for nd in nodes:
            nd.start()
        JaxTopologyFactory.connect_nodes(
            JaxTopologyFactory.generate_matrix(JaxTopologyType.LINE, len(nodes)), nodes)
        jax_wait_convergence(nodes, len(nodes) - 1, only_direct=False, wait=10)
        nodes[0].set_start_learning(rounds=rounds, epochs=epochs)
        jax_wait_to_finish(nodes, timeout=120)
        return ([{p: np.asarray(v) for p, v in tree_items(nd.learner.get_model().get_parameters())}
                 for nd in nodes], [list(nd.learning_workflow.history) for nd in nodes])
    finally:
        for nd in nodes:
            nd.stop()


def test_pooled_federation_matches_jax():
    """Four Nodes on a LINE with the pool on (the default) in both
    packages, the whole train set co-batched each round (its hint, and a
    wait cap far above a fit): one batched dispatch of 4 fits a round,
    and every node allclose to the JAX pooled federation's."""
    n, rounds = 4, 2
    for s in (Settings, JaxSettings):
        s.set_test_settings()
        s.DISABLE_SIMULATION = False
        s.SIM_BATCH_MAX_WAIT = 60.0
    clear_registry()
    jax_clear_registry()
    addrs = [f"pooled-{i}" for i in range(n)]
    jds = jax_synthetic_mnist(n_train=200 * n, n_test=40 * n, seed=0, noise=0.4)
    pds = synthetic_mnist(n_train=200 * n, n_test=40 * n, seed=0, noise=0.4)
    jparts = jds.generate_partitions(n, JaxRandomIID, seed=1)
    pparts = pds.generate_partitions(n, RandomIIDPartitionStrategy, seed=1)
    jax_params, jax_histories = _jax_federation(addrs, jparts, rounds, epochs=2)
    state = model_state_from_jax(_jax_model((32,)), device="cpu")
    module = MLP(hidden_sizes=(32,), out_channels=10, compute_dtype=torch.float32)
    nodes = [Node(TpflModel(module, **state), pparts[i], addr=a, device="cpu",
                  learning_rate=0.1, batch_size=32) for i, a in enumerate(addrs)]
    try:
        assert all(isinstance(nd.learner, VirtualNodeLearner) for nd in nodes)
        for nd in nodes:
            nd.start()
        TopologyFactory.connect_nodes(TopologyFactory.generate_matrix(TopologyType.LINE, n),
                                      nodes)
        wait_convergence(nodes, n - 1, only_direct=False, wait=10)
        nodes[0].set_start_learning(rounds=rounds, epochs=2)
        wait_to_finish(nodes, timeout=120)
        pool = SuperLearnerPool.instance()
        assert (pool.group_sizes, pool.fallbacks, pool.singles) == ([n] * rounds, 0, 0)
        for nd, want, jh in zip(nodes, jax_params, jax_histories):
            assert nd.learning_workflow.history == jh
            assert_close(params(nd.learner), want, PARITY, nd.addr)
    finally:
        for nd in nodes:
            nd.stop()
        clear_registry()
        jax_clear_registry()
