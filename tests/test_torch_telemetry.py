"""The port's telemetry plane (``tpfl_torch.management.telemetry`` and
``tracing``) against the JAX package's, on the CPU:

- the metrics registry: the same sequence of operations (cross-thread
  counters, histogram bucket edges, the label-set cap, gauge last-write,
  a collector and the JSON dump, ``merge`` with a histogram bucket
  mismatch) on both packages' registries gives equal ``fold()``, equal
  ``render_prometheus()`` text and equal JSON documents (the wall-clock
  anchor aside), and the reference tests' own assertions hold;
- tracing: ``mint`` sequences string-equal to the reference's for the
  same ``SEED`` and node; ``payload_trace_id`` reads the id back from
  v1, v2 and v3 payloads that both packages encode, with the same answer
  for the same bytes; spans gated by ``TELEMETRY_ENABLED`` into a
  bounded ring;
- flight dumps: the document has the reference's keys, and
  ``tools/traceview.py`` builds a timeline from a traced 3-node port
  federation with the hop kinds of the JAX federation's and, per node,
  the same counts of stage spans, fits and round events (the counts
  that do not depend on gossip timing).
"""

import collections
import glob
import json
import pathlib
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))  # `tools` package import

from tools.traceview import build_timeline, load, summarize, trace_complete  # noqa: E402
from tpfl.attacks import run_seeded_experiment as jax_run  # noqa: E402
from tpfl.communication.memory import clear_registry as jax_clear_registry  # noqa: E402
from tpfl.learning import compression as jax_compression  # noqa: E402
from tpfl.learning import serialization as jax_serialization  # noqa: E402
from tpfl.learning.dataset import synthetic_mnist as jax_synthetic_mnist  # noqa: E402
from tpfl.management import telemetry as jax_telemetry  # noqa: E402
from tpfl.management import tracing as jax_tracing  # noqa: E402
from tpfl.management.logger import logger as jax_logger  # noqa: E402
from tpfl.models import create_model as jax_create_model  # noqa: E402
from tpfl.settings import Settings as JaxSettings  # noqa: E402
from tpfl_torch.attacks import run_seeded_experiment  # noqa: E402
from tpfl_torch.communication.memory import clear_registry  # noqa: E402
from tpfl_torch.interop import model_state_from_jax  # noqa: E402
from tpfl_torch.learning import compression, serialization  # noqa: E402
from tpfl_torch.learning.dataset.synthetic import synthetic_mnist  # noqa: E402
from tpfl_torch.learning.model import TpflModel  # noqa: E402
from tpfl_torch.management import telemetry, tracing  # noqa: E402
from tpfl_torch.management.logger import logger  # noqa: E402
from tpfl_torch.models import MLP  # noqa: E402
from tpfl_torch.settings import Settings  # noqa: E402


@pytest.fixture(autouse=True)
def _settings():
    snaps = (Settings.snapshot(), JaxSettings.snapshot())
    yield
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])
    tracing.reset()
    jax_tracing.reset()


def _both(**knobs):
    for s in (Settings, JaxSettings):
        for k, v in knobs.items():
            setattr(s, k, v)


# --- the registry: the same operations on both packages' registries -------


def _threads(reg):
    def work(n):
        for _ in range(n):
            reg.counter("t_ops_total", labels={"node": "a"})

    threads = [threading.Thread(target=work, args=(100,), daemon=True) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    reg.counter("t_ops_total", 5, labels={"node": "a"})
    assert reg.fold()["counters"][("t_ops_total", (("node", "a"),))] == 405.0
    return reg


def _buckets(reg):
    for v in (0.1, 0.5, 0.50001, 2.0, 99.0):
        reg.observe("t_lat", v, buckets=(0.5, 1.0, 10.0))
    reg.observe("t_default", 0.003, labels={"node": "n"})
    h = reg.fold()["histograms"][("t_lat", ())]
    assert h[:4] == [2, 1, 1, 1] and h[-1] == 5
    text = reg.render_prometheus()
    assert 't_lat_bucket{le="+Inf"} 5' in text and 't_lat_bucket{le="0.5"} 2' in text
    return reg


def _label_cap(reg):
    _both(TELEMETRY_MAX_LABELSETS=4)
    for i in range(10):
        reg.counter("t_card_total", labels={"peer": f"p{i}"})
    folded = reg.fold()
    assert len([k for k in folded["counters"] if k[0] == "t_card_total"]) == 5
    assert folded["counters"][("t_card_total", (("overflow", "true"),))] == 6.0
    return reg


def _gauges(reg):
    reg.gauge("t_g", 1.0)
    t = threading.Thread(target=lambda: reg.gauge("t_g", 2.0), daemon=True)
    t.start()
    t.join()
    assert reg.fold()["gauges"][("t_g", ())] == 2.0
    reg.gauge("t_g", 3.0, labels={"node": "x"})
    return reg


def _collector(reg):
    reg.register_collector(lambda r: r.gauge("t_pool_bytes", 4096.0, labels={"node": "n"}))
    assert json.loads(reg.dump_json())["gauges"]["t_pool_bytes{node=n}"] == 4096.0
    return reg


def _merge(reg):
    cls = type(reg)
    a, b, c = reg, cls(), cls()
    a.observe("t_m_edges", 1.5, buckets=(1.0, 2.0, 4.0))
    b.observe("t_m_edges", 1.5, buckets=(1.0, 8.0))  # incompatible edges
    a.counter("t_m_total", 3, labels={"node": "x"})
    b.counter("t_m_total", 4, labels={"node": "x"})
    c.observe("t_m_edges", 2.5, buckets=(1.0, 2.0, 4.0))
    merged = cls.merge(a, b, c, names=["n0", "n1", "n2"])
    folded = merged.fold()
    assert folded["histograms"][("t_m_edges", (("origin", "n0"),))][-1] == 1
    assert ("t_m_edges", (("origin", "n1"),)) not in folded["histograms"]
    with pytest.raises(ValueError, match="names"):
        cls.merge(a, b, names=["only-one"])
    return merged


SCENARIOS = {"counter folds across threads": _threads, "histogram bucket edges": _buckets,
             "label cap": _label_cap, "gauge last write": _gauges,
             "collector and json dump": _collector, "merge, bucket mismatch": _merge}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_registry_matches_the_reference(scenario):
    got = SCENARIOS[scenario](telemetry.MetricsRegistry())
    want = SCENARIOS[scenario](jax_telemetry.MetricsRegistry())
    assert got.fold() == want.fold()
    assert got.render_prometheus() == want.render_prometheus()
    doc, ref = json.loads(got.dump_json()), json.loads(want.dump_json())
    doc.pop("wall_anchor"), ref.pop("wall_anchor")
    assert doc == ref


def test_registry_value_reads_back_and_reset():
    reg = telemetry.MetricsRegistry()
    reg.counter("c", 2.0, labels={"node": "a"})
    reg.gauge("g", 1.5)
    assert reg.value("c", {"node": "a"}) == 2.0 and reg.value("g") == 1.5
    assert reg.value("c", {"node": "b"}) == 0.0
    reg.reset()
    assert reg.fold() == {"counters": {}, "gauges": {}, "histograms": {}}


def test_transport_counters_mirror_into_the_process_registry():
    logger.metrics.reset()
    logger.transport_metrics.record_send("fa-node", "fa-peer", ok=True, attempts=2)
    logger.transport_metrics.record_breaker("fa-node", "fa-peer", "open")
    assert logger.metrics is telemetry.metrics
    folded = telemetry.metrics.fold()
    assert folded["counters"][("tpfl_transport_sends_total",
                               (("node", "fa-node"), ("ok", "1")))] == 1.0
    assert folded["counters"][("tpfl_transport_retries_total", (("node", "fa-node"),))] == 1.0
    assert folded["counters"][("tpfl_breaker_opens_total", (("node", "fa-node"),))] == 1.0


# --- tracing ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [None, 0, 99])
def test_mint_sequences_equal_the_reference(seed):
    _both(SEED=seed)
    tracing.reset()
    jax_tracing.reset()
    for node in ("node-x", "seed4242-n3"):
        got = [tracing.mint(node) for _ in range(6)]
        assert got == [jax_tracing.mint(node) for _ in range(6)]
        assert len(set(got)) == 6 and all(len(t) == 32 for t in got)


def _payloads():
    """(label, JAX-encoded bytes, port-encoded bytes) of the same params
    and trace id, for v1, v3 and v2 (zlib), and the untagged v3."""
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    jp, pp = {"w": arr}, {"w": torch.from_numpy(arr.copy())}
    return [
        ("v1", jax_serialization.encode_model_payload(jp, ["a"], 3, {}, trace_id="aa" * 16),
         serialization.encode_model_payload(pp, ["a"], 3, {}, trace_id="aa" * 16)),
        ("v3", jax_serialization.encode_model_payload_v3(jp, ["a"], 3, {}, trace_id="bb" * 16),
         serialization.encode_model_payload_v3(pp, ["a"], 3, {}, trace_id="bb" * 16)),
        ("v2", jax_compression.encode_model_payload(jp, ["a"], 3, {}, "zlib",
                                                    trace_id="cc" * 16),
         compression.encode_model_payload(pp, ["a"], 3, {}, "zlib", trace_id="cc" * 16)),
        ("v3 untagged", jax_serialization.encode_model_payload_v3(jp, ["a"], 3, {}),
         serialization.encode_model_payload_v3(pp, ["a"], 3, {})),
    ]


@pytest.mark.parametrize("case", range(4))
def test_payload_trace_id_reads_both_packages_payloads(case):
    label, jax_bytes, port_bytes = _payloads()[case]
    want = {"v1": "aa" * 16, "v3": "bb" * 16, "v2": "cc" * 16, "v3 untagged": ""}[label]
    for blob in (jax_bytes, port_bytes):
        assert tracing.payload_trace_id(blob) == jax_tracing.payload_trace_id(blob) == want
        assert tracing.payload_trace_id(memoryview(blob)) == want
    assert tracing.payload_trace_id(b"\x03\xff") == jax_tracing.payload_trace_id(b"\x03\xff")


def test_payload_trace_id_of_a_ref_and_of_nothing():
    ref = serialization.InprocModelRef({"w": torch.zeros(2)}, ["a"], 3, {}, trace="dd" * 16)
    assert tracing.payload_trace_id(ref) == "dd" * 16
    assert tracing.payload_trace_id(None) == "" and tracing.payload_trace_id(3) == ""


def test_span_gating_and_ring_bound():
    telemetry.flight.clear("gate-n")
    Settings.TELEMETRY_ENABLED = False
    with tracing.maybe_span("encode", "gate-n"):
        pass
    assert telemetry.flight.snapshot("gate-n") == []
    Settings.TELEMETRY_ENABLED = True
    Settings.TELEMETRY_RING = 8
    for i in range(20):
        tracing.event("tick", "gate-n", i=i)
    events = telemetry.flight.snapshot("gate-n")
    assert [e["i"] for e in events] == list(range(12, 20))
    with pytest.raises(RuntimeError):
        with tracing.maybe_span("decode", "gate-n", trace="t"):
            raise RuntimeError("boom")
    assert tracing.export("gate-n")[-1]["error"] == "RuntimeError: boom"
    telemetry.flight.clear("gate-n")


# --- flight dumps and traceview ---------------------------------------------


def test_flight_dump_document_has_the_reference_keys(tmp_path):
    docs = []
    for rec_cls, settings, sub in ((telemetry.FlightRecorder, Settings, "port"),
                                   (jax_telemetry.FlightRecorder, JaxSettings, "jax")):
        rec = rec_cls()
        settings.TELEMETRY_DUMP_DIR = ""
        rec.record("n-x", {"kind": "event", "name": "e", "node": "n-x", "t": 0.0})
        assert rec.dump("n-x", "stop") is None  # no dir: no file
        rec.clear("n-x")
        settings.TELEMETRY_DUMP_DIR = str(tmp_path / sub)
        for node, name in (("n/a", "encode"), ("n-b", "decode")):
            rec.record(node, {"kind": "span", "name": name, "node": node, "trace": "t1",
                              "t0": 1.0, "t1": 1.01})
        paths = rec.dump_all("crash")
        assert [pathlib.Path(p).name for p in paths] == ["flight-n-b-crash.json",
                                                         "flight-n_a-crash.json"]
        docs.append([json.loads(pathlib.Path(p).read_text()) for p in paths])
        timeline = build_timeline(load(paths))
        assert trace_complete(timeline["t1"])
    for got, want in zip(*docs):
        assert sorted(got) == sorted(want) == ["events", "node", "reason", "wall_anchor"]
        assert (got["node"], got["reason"], got["events"]) == (
            want["node"], want["reason"], want["events"])


def _traced_federation(run, model_fn, data_fn, dump_dir):
    run(31, 3, 2, data_fn=data_fn, model_fn=model_fn, samples_per_node=200)
    paths = sorted(glob.glob(str(dump_dir / "flight-*.json")))
    return build_timeline(load(paths)), [pathlib.Path(p).name for p in paths]


def test_traceview_timeline_of_a_port_federation_matches_the_jax_one(tmp_path):
    _both(DISABLE_SIMULATION=True, ELECTION="hash", TELEMETRY_ENABLED=True, TRAIN_SET_SIZE=3)
    Settings.set_test_settings()
    JaxSettings.set_test_settings()
    _both(DISABLE_SIMULATION=True, ELECTION="hash", TELEMETRY_ENABLED=True, TRAIN_SET_SIZE=3)
    Settings.TELEMETRY_DUMP_DIR = str(tmp_path / "port")
    JaxSettings.TELEMETRY_DUMP_DIR = str(tmp_path / "jax")
    # Under a loaded machine a node's heartbeater can starve past the test
    # profile's 2 s, its peers evict it and dump "quorum_degraded" flights
    # (reproduce with JaxSettings.HEARTBEAT_TIMEOUT = 0.55); this test
    # compares fault-free federations, as tests/test_torch_node.py does.
    Settings.HEARTBEAT_TIMEOUT = JaxSettings.HEARTBEAT_TIMEOUT = 30.0
    levels = logger.get_level(), jax_logger.get_level()
    logger.set_level("ERROR")
    jax_logger.set_level("ERROR")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    clear_registry()
    jax_clear_registry()

    def jax_model(s):
        return jax_create_model("mlp", (28, 28), seed=s, hidden_sizes=(32,),
                                compute_dtype=jnp.float32)

    def port_model(s):
        return TpflModel(MLP(hidden_sizes=(32,), out_channels=10, compute_dtype=torch.float32),
                         **model_state_from_jax(jax_model(s), device="cpu"))

    try:
        jax_tl, jax_files = _traced_federation(
            jax_run, jax_model, lambda s: jax_synthetic_mnist(n_train=600, n_test=120, seed=s,
                                                               noise=0.4), tmp_path / "jax")
        port_tl, port_files = _traced_federation(
            lambda *a, **k: run_seeded_experiment(*a, device="cpu", **k), port_model,
            lambda s: synthetic_mnist(n_train=600, n_test=120, seed=s, noise=0.4),
            tmp_path / "port")
    finally:
        torch.set_num_threads(threads)
        logger.set_level(levels[0])
        jax_logger.set_level(levels[1])
        clear_registry()
        jax_clear_registry()
        telemetry.flight.clear()
        jax_telemetry.flight.clear()
    assert port_files == jax_files == [f"flight-seed31-n{i}-stop.json" for i in range(3)]
    port_sum, jax_sum = summarize(port_tl), summarize(jax_tl)
    assert port_sum["nodes"] == jax_sum["nodes"]
    assert port_sum["complete_traces"] > 0 and jax_sum["complete_traces"] > 0

    def kinds(tl):
        per = collections.defaultdict(collections.Counter)
        for chain in tl.values():
            for e in chain:
                per[e["node"]][e["name"]] += 1
        return per

    port_kinds, jax_kinds = kinds(port_tl), kinds(jax_tl)
    # Which node closes an aggregate itself and which adopts a peer's
    # depends on gossip timing in both packages: hop kinds are compared
    # over the federation, counts only where the protocol fixes them.
    assert set().union(*port_kinds.values()) == set().union(*jax_kinds.values())
    for node in jax_sum["nodes"]:
        fixed = {k for k in jax_kinds[node] if k.startswith("stage:")
                 or k in ("train_fit", "round_finished")}
        assert {k: port_kinds[node][k] for k in fixed} == {k: jax_kinds[node][k] for k in fixed}
    # Every weights hop chain the port reconstructs names a real path.
    chains = [c for t, c in port_tl.items() if t and trace_complete(c)]
    assert chains and all({"encode", "send", "recv", "decode"} <= {e["name"] for e in c}
                          for c in chains)
