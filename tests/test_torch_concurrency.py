"""The port's lock tracing (tpfl_torch.concurrency), buffer pool
(tpfl_torch.learning.bufferpool) and logger subset
(tpfl_torch.management.logger) against the JAX package's copies, on the
CPU: the same acquisition orders give the same graph and the same
cycle witness; ``make_lock`` follows ``Settings.LOCK_TRACING`` at
creation time (the aggregator's lock included); the pool's leases stay
balanced on error paths; metrics read back what was counted.
"""

import threading

import pytest

from tpfl.concurrency import LockOrderError as JaxLockOrderError
from tpfl.concurrency import TracedLock as JaxTracedLock
from tpfl.concurrency import lock_graph as jax_lock_graph
from tpfl.learning.bufferpool import BufferPool as JaxBufferPool
from tpfl_torch.concurrency import LockOrderError, TracedLock, lock_graph, make_lock
from tpfl_torch.learning.bufferpool import BufferPool, default_pool
from tpfl_torch.learning.aggregators import FedAvg
from tpfl_torch.management.logger import TpflLogger
from tpfl_torch.management.telemetry import MetricsRegistry
from tpfl_torch.settings import Settings


@pytest.fixture
def graphs():
    lock_graph.clear()
    jax_lock_graph.clear()
    yield
    lock_graph.clear()
    jax_lock_graph.clear()


def _acquire(traced, order, name):
    """Acquire ``order`` (nested) on a named thread."""
    def run():
        held = []
        for key in order:
            traced[key].acquire()
            held.append(traced[key])
        for lock in reversed(held):
            lock.release()

    t = threading.Thread(target=run, name=name)
    t.start()
    t.join(timeout=5)
    assert not t.is_alive()


@pytest.mark.parametrize("orders", [
    [("A", "B"), ("B", "C")],
    [("A", "B"), ("B", "A")],
    [("A", "B", "C"), ("C", "A")],
])
def test_lock_graph_matches_reference(graphs, orders):
    ours = {k: TracedLock(f"t.{k}") for k in "ABC"}
    ref = {k: JaxTracedLock(f"t.{k}") for k in "ABC"}
    for i, order in enumerate(orders):
        _acquire(ours, order, f"worker-{i}")
        _acquire(ref, order, f"worker-{i}")
    assert lock_graph.edges() == jax_lock_graph.edges()
    assert lock_graph.find_cycle() == jax_lock_graph.find_cycle()
    assert lock_graph.thread_names() == jax_lock_graph.thread_names()
    if jax_lock_graph.find_cycle() is None:
        lock_graph.assert_acyclic()
    else:
        with pytest.raises(JaxLockOrderError) as want:
            jax_lock_graph.assert_acyclic()
        with pytest.raises(LockOrderError) as got:
            lock_graph.assert_acyclic()
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("tracing", [False, True])
def test_make_lock_reads_the_knob_at_creation(tracing):
    saved = Settings.LOCK_TRACING
    try:
        Settings.LOCK_TRACING = tracing
        lock = make_lock("x._lock")
        agg = FedAvg("n", device="cpu")
    finally:
        Settings.LOCK_TRACING = saved
    assert isinstance(lock, TracedLock) == tracing
    assert isinstance(agg._lock, TracedLock) == tracing
    with lock:
        assert lock.locked()
    assert not lock.locked()


@pytest.mark.parametrize("sizes", [[100], [5000, 100, 9000], [4096, 4097, 1]])
def test_buffer_pool_matches_reference(sizes):
    ours, ref = BufferPool(max_buffers=2), JaxBufferPool(max_buffers=2)
    for pool in (ours, ref):
        leases = [pool.acquire(n) for n in sizes]
        for lease, n in zip(leases, sizes):
            assert len(lease.view()) == n
        for lease in leases:
            lease.release()
        with pool.acquire(sizes[0]):
            pass
    assert (ours.hits, ours.misses, ours.pooled_buffers, ours.pooled_bytes, ours.outstanding) == (
        ref.hits, ref.misses, ref.pooled_buffers, ref.pooled_bytes, ref.outstanding)


def test_buffer_pool_error_paths_release():
    pool = BufferPool()
    with pytest.raises(RuntimeError):
        with pool.acquire(10):
            raise RuntimeError("encode failed")
    lease = pool.acquire(10)
    del lease  # the GC backstop returns it
    assert pool.outstanding == 0
    released = pool.acquire(8)
    released.release()
    with pytest.raises(ValueError):
        released.view()
    assert default_pool() is default_pool()


def test_metrics_registry_reads_back():
    reg = MetricsRegistry()
    reg.counter("c", labels={"node": "a"})
    reg.counter("c", 2.0, labels={"node": "a"})
    reg.gauge("g", 3.5)
    reg.observe("h", 0.25, labels={"node": "a"})
    reg.observe("h", 0.75, labels={"node": "a"})
    assert reg.value("c", {"node": "a"}) == 3.0 and reg.value("c", {"node": "b"}) == 0.0
    assert reg.value("g") == 3.5
    hist = reg.fold()["histograms"][("h", (("node", "a"),))]
    assert (hist[-1], hist[-2]) == (2, 1.0)  # count, sum
    assert len(reg.fold()["counters"]) == 1
    reg.reset()
    assert reg.value("c", {"node": "a"}) == 0.0


def test_logger_routes_metrics_by_step():
    log = TpflLogger()
    log.register_node("n0")
    with pytest.raises(Exception, match="already registered"):
        log.register_node("n0")
    with pytest.raises(ValueError, match="round"):
        log.log_metric("n0", "loss", 1.0)

    class Exp:
        exp_name, round = "exp", 2

    log.experiment_started("n0", Exp())
    log.log_metric("n0", "loss", 1.5, step=0)
    log.log_metric("n0", "test_metric", 0.5)
    # The reference's layouts (tpfl.management.metric_storage): local
    # exp -> round -> node -> metric -> [(step, value)], global
    # exp -> node -> metric -> [(round, value)].
    assert log.get_local_logs() == {"exp": {2: {"n0": {"loss": [(0, 1.5)]}}}}
    assert log.get_global_logs() == {"exp": {"n0": {"test_metric": [(2, 0.5)]}}}
    assert log.get_nodes()["n0"]["experiment"] is not None
    log.unregister_node("n0")
    assert "n0" not in log.get_nodes()
