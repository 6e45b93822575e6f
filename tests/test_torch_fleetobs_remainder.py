"""The fleet observatory's remainder, the node monitor and the web services
(tpfl_torch.management.fleetobs / node_monitor / web_services / logger)
against the JAX package's, on the CPU: the ports of
``tests/test_fleetobs.py``'s federation, publisher, watchdog and endpoint
scenarios and of ``tests/test_management.py``'s web client.

- the same registry operations through ``snapshot`` → ``fold`` /
  ``fold_receipts`` / ``load_fleet_dir`` / ``fleet_from_dir``: equal
  snapshot dicts and byte-equal ``render_prometheus``, in either order;
- ``parse_targets`` and ``SLOWatchdog`` over the same injected series: the
  same targets, errors, verdicts, breach events and counters;
- ``MetricsHTTPServer`` (``/metrics``, ``/metrics.json``, ``/fleet.json``,
  ``/healthz`` 200 then 503) and ``TpflWebServices`` against a local
  server: byte-equal bodies and headers;
- ``NodeMonitor``: the reference's metric names, values in range, the
  fleet gauges; the logger starts one a node once a dashboard is
  connected, and none before.
"""

import json
import re
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from tpfl.management import fleetobs as jax_fleetobs
from tpfl.management.telemetry import MetricsRegistry as JaxRegistry
from tpfl.management.telemetry import flight as jax_flight
from tpfl.management.telemetry import metrics as jax_metrics
from tpfl.management.web_services import MetricsHTTPServer as JaxHTTPServer
from tpfl.management.web_services import TpflWebServices as JaxWebServices
from tpfl.settings import Settings as JaxSettings
from tpfl_torch.management import fleetobs
from tpfl_torch.management.logger import logger
from tpfl_torch.management.node_monitor import NodeMonitor
from tpfl_torch.management.telemetry import MetricsRegistry, flight, metrics
from tpfl_torch.management.web_services import MetricsHTTPServer, TpflWebServices
from tpfl_torch.settings import Settings

SIDES = ((fleetobs, MetricsRegistry, metrics, flight, Settings),
         (jax_fleetobs, JaxRegistry, jax_metrics, jax_flight, JaxSettings))


@pytest.fixture(autouse=True)
def _clean():
    snaps = (Settings.snapshot(), JaxSettings.snapshot())
    for _, _, reg, ring, _ in SIDES:
        reg.reset()
        ring.clear()
    yield
    for _, _, reg, ring, _ in SIDES:
        reg.reset()
        ring.clear()
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])


def _sample(registry_cls, mod, scale=1.0):
    """The reference test's registry: deterministic series and one
    wall-clock gauge outside the filter."""
    reg = registry_cls()
    reg.counter("tpfl_engine_rounds_total", 3 * scale, labels={"model": "m"})
    reg.gauge("tpfl_engine_loss", 0.25 * scale, labels={"model": "m"})
    reg.observe("tpfl_pop_staleness", 2.0 * scale, buckets=mod.POP_STALENESS_BUCKETS)
    reg.observe("tpfl_pop_staleness", 5.0, buckets=mod.POP_STALENESS_BUCKETS)
    reg.counter("tpfl_slo_breach_total", labels={"target": "rate(a)>=1"})
    reg.gauge("tpfl_system_cpu_percent", 50.0, labels={"node": "n0"})
    return reg


def _strip(snap):
    return {k: v for k, v in snap.items() if k != "wall_anchor"}


@pytest.mark.parametrize("prefixes", [None, "deterministic"])
def test_snapshot_equals_the_reference(prefixes):
    docs = []
    for mod, reg_cls, *_ in SIDES:
        pref = mod.DETERMINISTIC_PREFIXES if prefixes else None
        snap = mod.snapshot(_sample(reg_cls, mod), origin="r0", prefixes=pref)
        docs.append(json.loads(json.dumps(snap)))
    assert _strip(docs[0]) == _strip(docs[1])
    assert ("tpfl_system_cpu_percent{node=n0}" in docs[0]["gauges"]) is (prefixes is None)
    assert docs[0]["buckets"]["tpfl_pop_staleness"] == list(fleetobs.POP_STALENESS_BUCKETS)
    back = fleetobs.registry_from_snapshot(docs[0]).fold()
    assert back == jax_fleetobs.registry_from_snapshot(docs[1]).fold()
    assert back["histograms"][("tpfl_pop_staleness", ())][-1] == 2


def _two_snaps(side):
    mod, reg_cls, *_ = side
    return [mod.snapshot(_sample(reg_cls, mod, s), origin=o) for o, s in (("0", 1.0), ("1", 2.0))]


def test_fold_renders_the_reference_bytes_in_either_order():
    texts = []
    for side in SIDES:
        s0, s1 = _two_snaps(side)
        text = side[0].fold([s0, s1]).render_prometheus()
        assert side[0].fold([s1, s0]).render_prometheus() == text
        texts.append(text)
    assert texts[0] == texts[1]
    assert 'tpfl_engine_rounds_total{model="m",origin="1"} 6' in texts[0]


def test_fold_of_json_round_tripped_snapshots_is_byte_identical():
    for mod, *_ in SIDES:
        s0, s1 = _two_snaps(SIDES[0] if mod is fleetobs else SIDES[1])
        again = [json.loads(json.dumps(s)) for s in (s0, s1)]
        assert mod.fold(again).render_prometheus() == mod.fold([s0, s1]).render_prometheus()
    mine = fleetobs.fold([json.loads(json.dumps(s)) for s in _two_snaps(SIDES[1])])
    assert mine.render_prometheus() == jax_fleetobs.fold(_two_snaps(SIDES[1])).render_prometheus()


def test_fold_receipts_equal_the_reference():
    texts = []
    for side in SIDES:
        s0, _ = _two_snaps(side)
        receipts = [{"metrics_snapshot": s0}, {"loss_mean": 1.0}, {}]
        texts.append(side[0].fold_receipts(receipts).render_prometheus())
    assert texts[0] == texts[1] and 'origin="0"' in texts[0]


def test_publisher_fleet_dir_and_its_fold_equal_the_reference(tmp_path):
    texts, loaded = [], []
    for i, side in enumerate(SIDES):
        mod, reg_cls = side[0], side[1]
        d = tmp_path / f"side{i}"
        for origin, scale in (("0", 1.0), ("1", 2.0)):
            pub = mod.FleetPublisher(origin, directory=str(d), registry=_sample(reg_cls, mod, scale),
                                     prefixes=mod.DETERMINISTIC_PREFIXES)
            assert pub.publish_once().endswith(f"fleetsnap-{origin}.json")
        (d / "fleetsnap-torn.json").write_text("{not json")
        loaded.append([_strip(s) for s in mod.load_fleet_dir(str(d))])
        texts.append(mod.fleet_from_dir(str(d)).render_prometheus())
    assert loaded[0] == loaded[1] and [s["origin"] for s in loaded[0]] == ["0", "1"]
    assert texts[0] == texts[1]
    assert fleetobs.load_fleet_dir(str(tmp_path / "nope")) == []
    assert fleetobs.fleet_from_dir(str(tmp_path / "nope")).fold()["counters"] == {}


def test_publisher_thread_publishes_once_with_period_zero(tmp_path):
    Settings.FLEETOBS_DIR = str(tmp_path)
    Settings.FLEETOBS_SNAPSHOT_PERIOD = 0.0
    pub = fleetobs.FleetPublisher("rank 0/x", registry=_sample(MetricsRegistry, fleetobs))
    pub.start()
    pub.join(timeout=5)
    assert not pub.is_alive() and pub.name == "fleet-publisher-rank_0_x"
    (snap,) = fleetobs.load_fleet_dir(str(tmp_path))
    assert snap["origin"] == "rank 0/x"
    assert fleetobs.fleet_from_dir().render_prometheus() == fleetobs.fold([snap]).render_prometheus()
    Settings.FLEETOBS_DIR = ""
    assert fleetobs.FleetPublisher("x", registry=MetricsRegistry()).publish_once() is None


CLAUSES = {
    "three kinds": "rate(tpfl_engine_rounds_total) >= 2.0; gauge(tpfl_engine_idle_gap_seconds)"
                   " <= 0.5;ratio(tpfl_engine_wire_bytes_total, tpfl_engine_rounds_total) < 1e6",
    "empty": "",
    "no kind": "rounds_per_sec >= 2",
    "ratio of one": "ratio(tpfl_a_total) < 1",
    "gauge of two": "gauge(tpfl_a, tpfl_b) < 1",
}


@pytest.mark.parametrize("clause", sorted(CLAUSES))
def test_parse_targets_equals_the_reference(clause):
    results = []
    for mod, *_ in SIDES:
        try:
            results.append([(t.kind, t.metric, t.metric_b, t.op, t.threshold, t.key)
                            for t in mod.parse_targets(CLAUSES[clause])])
        except ValueError as e:
            results.append(("ValueError", str(e)))
    assert results[0] == results[1]
    assert isinstance(results[0], tuple) is (clause not in ("three kinds", "empty"))


def _events(ring, node):
    return [{k: v for k, v in e.items()} for e in ring.snapshot(node)
            if e.get("name") == "slo_breach"]


def _drive_rates(side, rates, node):
    """bench.py's watchdog drive on each side: windows at t = 1, 2, ...;
    returns the verdict list of every window."""
    mod, reg_cls, *_ = side
    reg = reg_cls()
    wd = mod.SLOWatchdog("rate(tpfl_engine_rounds_total) >= 2.4", registry=reg, node=node)
    out = [wd.evaluate(now=0.0)]
    for i, rate in enumerate(rates):
        reg.counter("tpfl_engine_rounds_total", rate)
        out.append(wd.evaluate(now=float(i + 1)))
    return out, wd


@pytest.mark.parametrize("arm", ["uninjected", "injected", "recovery"])
def test_watchdog_verdicts_equal_the_reference(arm):
    rates = {"uninjected": [2.5] * 8, "injected": [2.5] * 4 + [2.0] * 6,
             "recovery": [2.5] * 4 + [2.0] * 4 + [3.5] * 8 + [1.0] * 6}[arm]
    runs = [_drive_rates(side, rates, "wd-test") for side in SIDES]
    assert runs[0][0] == runs[1][0]
    assert _events(flight, "wd-test") == _events(jax_flight, "wd-test")
    names = ("tpfl_slo_breach_total",)
    assert ({k: v for k, v in metrics.fold()["counters"].items() if k[0] in names}
            == {k: v for k, v in jax_metrics.fold()["counters"].items() if k[0] in names})
    breaches = len(_events(flight, "wd-test"))
    assert breaches == {"uninjected": 0, "injected": 1, "recovery": 2}[arm]
    if arm == "injected":
        # Flagged within 2 windows of the 20% regression.
        first_bad = next(i for i, v in enumerate(runs[0][0]) if not v[0]["healthy"])
        flagged = next(i for i, v in enumerate(runs[0][0]) if v[0]["breached"])
        assert flagged - 4 <= 2 and first_bad <= flagged


def test_watchdog_gauge_and_ratio_signals_equal_the_reference():
    verdicts = []
    for mod, reg_cls, *_ in SIDES:
        reg = reg_cls()
        wd = mod.SLOWatchdog("gauge(tpfl_engine_idle_gap_seconds) <= 0.5; "
                             "ratio(tpfl_engine_wire_bytes_total, tpfl_engine_rounds_total) <= 100",
                             registry=reg)
        reg.gauge("tpfl_engine_idle_gap_seconds", 0.1, labels={"driver": "p"})
        reg.counter("tpfl_engine_rounds_total", 2)
        reg.counter("tpfl_engine_wire_bytes_total", 100)
        got = [wd.evaluate(now=0.0)]
        reg.counter("tpfl_engine_rounds_total", 2)
        reg.counter("tpfl_engine_wire_bytes_total", 120)
        got.append(wd.evaluate(now=1.0))
        reg.gauge("tpfl_engine_idle_gap_seconds", 2.0, labels={"driver": "p"})
        got += [wd.evaluate(now=2.0), wd.evaluate(now=3.0)]
        missing = mod.SLOWatchdog("gauge(tpfl_never_emitted) <= 1", registry=reg)
        got.append(missing.evaluate(now=0.0))
        verdicts.append((got, wd.healthy(), missing.healthy()))
    assert verdicts[0] == verdicts[1]
    assert verdicts[0][1] is False and verdicts[0][2] is True


def test_watchdog_reads_the_settings_targets_and_runs_on_a_thread():
    for mod, reg_cls, reg, ring, settings in SIDES:
        settings.SLO_TARGETS = "gauge(tpfl_engine_loss) <= 10"
        settings.SLO_EWMA = 0.5
        settings.SLO_BREACH_WINDOWS = 3
    wds = [mod.SLOWatchdog(registry=reg_cls()) for mod, reg_cls, *_ in SIDES]
    assert [t.key for t in wds[0]._targets] == [t.key for t in wds[1]._targets]
    wd = wds[0]
    wd._registry.gauge("tpfl_engine_loss", 20.0)
    wd.start(period=0.05)
    try:
        deadline = time.monotonic() + 5
        while wd.healthy() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not wd.healthy() and wd.verdicts()[0]["evaluations"] >= 3
    finally:
        wd.stop()
    assert wd._thread is None


# --- HTTP endpoints ----------------------------------------------------------------


def _get(url):
    """(status, content type, body); a JSON dump's ``wall_anchor`` (this
    process' clock offset) reads 0."""
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            got = resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        got = e.code, e.headers.get("Content-Type"), e.read()
    return got[0], got[1], re.sub(rb'"wall_anchor": [-0-9.e+]+', b'"wall_anchor": 0', got[2])


def test_metrics_server_endpoints_equal_the_reference(tmp_path):
    """Each package's server over its registry, watchdog and fleet
    directory: the same status, content type and bytes at every path;
    ``/healthz`` turns 503 once the watchdog breaches."""
    bodies = []
    servers = []
    try:
        for i, (mod, reg_cls, _, _, settings) in enumerate(SIDES):
            reg = _sample(reg_cls, mod)
            reg.gauge("tpfl_engine_idle_gap_seconds", 2.0)
            wd = mod.SLOWatchdog("gauge(tpfl_engine_idle_gap_seconds) <= 0.5", registry=reg)
            d = tmp_path / f"fleet{i}"
            mod.FleetPublisher("r0", directory=str(d), registry=_sample(reg_cls, mod)).publish_once()
            srv = (MetricsHTTPServer if mod is fleetobs else JaxHTTPServer)(
                registry=reg, watchdog=wd, fleet_dir=str(d))
            servers.append(srv)
            base = f"http://127.0.0.1:{srv.start()}"
            got = [_get(f"{base}{p}") for p in ("/metrics", "/metrics.json", "/fleet.json",
                                                 "/healthz", "/nope")]
            for t in range(settings.SLO_BREACH_WINDOWS + 1):
                wd.evaluate(now=float(t))
            got.append(_get(f"{base}/healthz"))
            bodies.append(got)
    finally:
        for srv in servers:
            srv.stop()
    assert bodies[0] == bodies[1]
    status = [b[0] for b in bodies[0]]
    assert status == [200, 200, 200, 200, 404, 503]
    fleet = json.loads(bodies[0][2][2])
    assert fleet["counters"]["tpfl_engine_rounds_total{model=m,origin=r0}"] == 3.0
    assert json.loads(bodies[0][5][2])["healthy"] is False


def test_web_services_client_posts_the_reference_requests():
    """Both packages' REST clients against one local dashboard: the same
    paths, headers and JSON bodies; a dead endpoint is swallowed."""
    received = []

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            received.append((self.path, self.headers.get("x-api-key"),
                             self.headers.get("Content-Type"), body))
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(b'{"session_id": "s-1"}')

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    per_side = []
    try:
        for cls in (TpflWebServices, JaxWebServices):
            received.clear()
            ws = cls(f"http://127.0.0.1:{srv.server_port}/", "sekret")
            ws.register_node("node-w", is_simulated=True)
            ws.send_log("t0", "node-w", "INFO", "hello")
            ws.send_local_metric("node-w", "loss", 1.5, step=3, round=0)
            ws.send_global_metric("node-w", "acc", 0.9, round=1)
            ws.send_system_metric("node-w", "cpu", 0.5, "t1")
            ws.unregister_node("node-w")
            per_side.append((list(received), dict(ws._node_sessions)))
    finally:
        srv.shutdown()
        srv.server_close()
    assert per_side[0] == per_side[1]
    assert len(per_side[0][0]) == 6 and per_side[0][1] == {"node-w": "s-1"}
    assert all(key == "sekret" for _, key, _, _ in per_side[0][0])
    dead = TpflWebServices("http://127.0.0.1:9", "k")
    dead.register_node("n", False)
    dead.send_log("t", "n", "INFO", "m")


# --- the node monitor -------------------------------------------------------------


def test_node_monitor_emits_the_reference_names_in_range():
    from tpfl.management.node_monitor import NodeMonitor as JaxMonitor

    class FakeView:
        capacity = 16

        def live(self):
            return 9

        def quarantined(self):
            return set()

    view = FakeView()
    for mod in (fleetobs, jax_fleetobs):
        with mod._meta_lock:
            mod._views.clear()
            mod._populations.clear()
        mod.register_view(view)
    reports = []
    mine = NodeMonitor("mon-a", lambda *a: reports.append(a))
    ref = JaxMonitor("mon-a")
    sum(i * i for i in range(200_000))  # some CPU time between the samples
    mine._sample()
    ref._sample()
    labels = (("node", "mon-a"),)
    got = {k[0]: v for k, v in metrics.fold()["gauges"].items() if k[1] == labels}
    want = {k[0]: v for k, v in jax_metrics.fold()["gauges"].items() if k[1] == labels}
    assert set(got) == set(want)
    assert {"tpfl_system_cpu_percent", "tpfl_system_ram_percent",
            "tpfl_system_net_in_bytes_per_s", "tpfl_system_net_out_bytes_per_s",
            "tpfl_membership_capacity"} <= set(got)
    assert 0.0 <= got["tpfl_system_cpu_percent"] <= 100.0
    assert 0.0 < got["tpfl_system_ram_percent"] < 100.0
    assert got["tpfl_system_net_in_bytes_per_s"] >= 0.0
    assert got["tpfl_membership_live"] == want["tpfl_membership_live"] == 9.0
    assert [r[1] for r in reports] == ["cpu_percent", "ram_percent", "net_in_bytes_per_s",
                                       "net_out_bytes_per_s"]
    del view


def test_node_monitor_thread_samples_each_period_and_stops():
    Settings.RESOURCE_MONITOR_PERIOD = 0.05
    mon = NodeMonitor("mon-t")
    mon.start()
    try:
        deadline = time.monotonic() + 5
        while metrics.value("tpfl_system_ram_percent", {"node": "mon-t"}) == 0.0:
            assert time.monotonic() < deadline
            time.sleep(0.02)
    finally:
        mon.stop()
        mon.join(timeout=2)
    assert not mon.is_alive() and mon.name == "node-monitor-mon-t"


def test_logger_runs_monitors_only_once_a_dashboard_is_connected():
    posted = []

    class FakeWeb:
        def __getattr__(self, name):
            return lambda *a, **k: posted.append((name, a))

    Settings.RESOURCE_MONITOR_PERIOD = 0.05
    logger.register_node("web-off")
    try:
        assert logger._monitors == {} and logger._web is None
    finally:
        logger.unregister_node("web-off")
    logger.connect_web("http://127.0.0.1:9", "k")
    assert isinstance(logger._web, TpflWebServices)
    logger._web = FakeWeb()
    try:
        logger.register_node("web-on", simulation=True)
        mon = logger._monitors["web-on"]
        assert mon.is_alive()
        logger.info("web-on", "hello")
        deadline = time.monotonic() + 5
        while not any(n == "send_system_metric" for n, _ in posted):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        logger.unregister_node("web-on")
        mon.join(timeout=2)
        assert not mon.is_alive() and "web-on" not in logger._monitors
    finally:
        logger._web = None
    names = [n for n, _ in posted]
    assert names[0] == "register_node" and names[-1] == "unregister_node"
    assert ("send_log", (posted[names.index("send_log")][1][1:])) == (
        "send_log", ("web-on", "INFO", "hello"))
