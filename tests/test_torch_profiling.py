"""The device-plane observatory (tpfl_torch.management.profiling) against
the JAX package's, on the CPU: the ports of ``tests/test_profiling.py``'s
observatory, cost-model, tracker and gate scenarios.

- ``CostModel.analytic_fwd_mults`` / ``analytic_train_flops`` for the
  CNN, MLP and TransformerLM configurations ``chip_smoke.py`` runs and for
  narrow ones: exactly the JAX package's integers;
- ``mfu`` / ``record_round`` gauges for a stated peak: the same MFU and
  series as the JAX package's at the same fraction of its peak;
- ``HbmTracker.observe`` over the same stats dicts: the same peaks and
  gauges; ``sample`` never initialises CUDA;
- ``CompileObservatory``: the same signature counts, hits and storm event
  over the same call sequences, and the same counts at the seams (the
  engine through a membership storm, ``VmapFederation``, the learner's
  shared programs, the pool's batched programs);
- ``compare_to_baseline`` over ``BENCH_BASELINE*.json`` and results
  documents: equal verdict dicts;
- the timing helpers on the CPU, the ``COMPILE_CACHE_DIR`` build
  directory and its warm counter.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.management import profiling as jax_profiling
from tpfl.management.telemetry import flight as jax_flight
from tpfl.management.telemetry import metrics as jax_metrics
from tpfl.models import CNN as JaxCNN
from tpfl.models import MLP as JaxMLP
from tpfl.models import ResNet18 as JaxResNet18
from tpfl.models import TransformerLM as JaxLM
from tpfl.settings import Settings as JaxSettings
from tpfl_torch.management import profiling
from tpfl_torch.management.telemetry import flight, metrics
from tpfl_torch.models import CNN, MLP, ResNet18, TransformerLM
from tpfl_torch.parallel import _build
from tpfl_torch.settings import Settings

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean():
    snaps = (Settings.snapshot(), JaxSettings.snapshot())
    for mod in (profiling, jax_profiling):
        mod.observatory.reset()
    for reg in (metrics, jax_metrics):
        reg.reset()
    yield
    # Nothing of these runs stays behind: no engine:<tag> ring, series or
    # round record (a later file reads the first engine ring it finds).
    for ring in (flight, jax_flight):
        for node in ring.nodes():
            if node == profiling.PROFILING_RING or node.startswith("engine:"):
                ring.clear(node)
    for mod in (profiling, jax_profiling):
        mod.observatory.reset()
        mod.rounds.reset()
    for reg in (metrics, jax_metrics):
        reg.reset()
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])


def _profiling_on(warn=8):
    for s in (Settings, JaxSettings):
        s.PROFILING_ENABLED = True
        s.PROFILING_RECOMPILE_WARN = warn


def _series(folded, names):
    return {kind: {k: v for k, v in folded[kind].items() if k[0] in names}
            for kind in ("counters", "gauges", "histograms")}


# --- CostModel -----------------------------------------------------------------

# (label, port module, JAX module, per-sample input shape): chip_smoke.py's
# CNN cell, federation CNN, MLPs (the profiling tier's, sim1m's, the
# fleet overhead loop's) and TransformerLM, and narrow ones.
CONFIGS = {
    "cnn-cell": (lambda: CNN(out_channels=10), lambda: JaxCNN(out_channels=10), (32, 32, 3)),
    "cnn-narrow": (lambda: CNN(channels=(4, 8), dense=16, out_channels=10),
                   lambda: JaxCNN(channels=(4, 8), dense=16, out_channels=10), (8, 8, 3)),
    "mlp-digits": (lambda: MLP(hidden_sizes=(32,), out_channels=10),
                   lambda: JaxMLP(hidden_sizes=(32,), out_channels=10), (28, 28)),
    "mlp-sim1m": (lambda: MLP(hidden_sizes=(16,), out_channels=10),
                  lambda: JaxMLP(hidden_sizes=(16,), out_channels=10), (8, 8)),
    "mlp-fleet": (lambda: MLP(hidden_sizes=(256, 256), out_channels=10),
                  lambda: JaxMLP(hidden_sizes=(256, 256), out_channels=10), (8, 8)),
    "lm-cell": (lambda: TransformerLM(vocab=256, dim=512, heads=8, n_layers=4, max_len=4096),
                lambda: JaxLM(vocab=256, dim=512, heads=8, n_layers=4, max_len=4096), (2048,)),
    "lm-narrow": (lambda: TransformerLM(vocab=32, dim=32, heads=2, n_layers=2, max_len=64),
                  lambda: JaxLM(vocab=32, dim=32, heads=2, n_layers=2, max_len=64), (16,)),
    "resnet18": (lambda: ResNet18(out_channels=100), lambda: JaxResNet18(out_channels=100),
                 (32, 32, 3)),
}


@pytest.mark.parametrize("label", sorted(CONFIGS))
def test_analytic_flops_equal_the_reference(label):
    port, ref, shape = CONFIGS[label]
    got = profiling.cost_model.analytic_fwd_mults(port(), shape)
    want = jax_profiling.cost_model.analytic_fwd_mults(ref(), shape)
    assert got == want and type(got) is type(want)
    for samples in (1, 51_200):
        assert profiling.cost_model.analytic_train_flops(port(), shape, samples) == (
            jax_profiling.cost_model.analytic_train_flops(ref(), shape, samples))
    if label == "cnn-cell":
        assert got == 6_128_896  # PERF.md's prediction for the live MFU
    if label == "resnet18":
        assert got is None


def test_analytic_mults_refuse_a_wrong_rank_input():
    for port, ref, shape in (CONFIGS["cnn-cell"], CONFIGS["lm-narrow"]):
        bad = shape + (1,)
        assert profiling.cost_model.analytic_fwd_mults(port(), bad) is None
        assert jax_profiling.cost_model.analytic_fwd_mults(ref(), bad) is None


class FakeDev:
    def __init__(self, kind):
        self.device_kind = kind


@pytest.mark.parametrize("kind,peak", [("NVIDIA H100 80GB HBM3", 989e12),
                                       ("NVIDIA H100 PCIe", 756e12),
                                       ("NVIDIA H100 NVL", 835e12)])
def test_mfu_and_live_gauges_at_a_stated_peak(kind, peak):
    """At 10% of each package's stated peak: the same MFU and the same
    ``tpfl_mfu`` / ``tpfl_round_compute_seconds`` series."""
    dev, jdev = FakeDev(kind), FakeDev("TPU v5e")
    assert profiling.peak_flops(dev) == peak
    assert profiling.cost_model.mfu(0.1 * peak, dev) == pytest.approx(0.1)
    assert profiling.cost_model.mfu(0.1 * peak, dev, n_chips=4) == pytest.approx(0.025)
    assert jax_profiling.cost_model.mfu(0.1 * 197e12, jdev) == pytest.approx(0.1)
    got = profiling.cost_model.record_round("cnn", 0.1 * peak * 0.25, 0.25, device=dev)
    want = jax_profiling.cost_model.record_round("cnn", 0.1 * 197e12 * 0.25, 0.25, device=jdev)
    assert got == pytest.approx(want)
    names = {"tpfl_mfu", "tpfl_round_compute_seconds"}
    mine, ref = _series(metrics.fold(), names), _series(jax_metrics.fold(), names)
    assert mine["histograms"] == ref["histograms"]
    assert mine["gauges"].keys() == ref["gauges"].keys()
    key = ("tpfl_mfu", (("program", "cnn"),))
    assert mine["gauges"][key] == pytest.approx(ref["gauges"][key])
    assert metrics.value("tpfl_round_flops", {"program": "cnn"}) == 0.1 * peak * 0.25


def test_no_peak_means_no_mfu_gauge():
    """The CPU and an unknown card have no peak: no MFU, no gauge, as the
    reference's CPU runs."""
    assert profiling.peak_flops(torch.device("cpu")) is None
    assert profiling.peak_flops("cpu") is None
    assert profiling.cost_model.mfu(1e12, "cpu") is None
    assert profiling.cost_model.mfu(1.0, object()) is None
    assert jax_profiling.cost_model.mfu(1.0, object()) is None
    assert profiling.cost_model.record_round("x", 1.0, 1.0, device="cpu") is None
    assert ("tpfl_mfu", (("program", "x"),)) not in metrics.fold()["gauges"]
    assert metrics.value("tpfl_round_flops", {"program": "x"}) == 1.0


def test_xla_cost_analysis_is_refused_naming_item_8():
    """No longer refused: the seam counts one run of a callable (the port
    has no compiled executable, and a non-callable is a TypeError). A
    [4, 8] @ [8, 3] product is 2·4·8·3 FLOPs; a call with no arithmetic
    counts none, which ``xla_flops`` reports as None."""
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    assert profiling.cost_model.cost_analysis(lambda: a @ b) == {"flops": 2.0 * 4 * 8 * 3}
    assert profiling.cost_model.xla_flops(lambda: a @ b) == 2.0 * 4 * 8 * 3
    assert profiling.cost_model.xla_flops(lambda: a.clone()) is None
    for fn in (profiling.cost_model.xla_flops, profiling.cost_model.cost_analysis):
        with pytest.raises(TypeError, match="callable"):
            fn(object())


# --- HbmTracker ----------------------------------------------------------------

STATS = [{"bytes_in_use": 100}, {"bytes_in_use": 50, "peak_bytes_in_use": 300},
         {"bytes_in_use": 10}, {"bytes_in_use": 400, "peak_bytes_in_use": 350}]


def test_hbm_tracker_high_water_mark_equals_the_reference():
    mine, ref = profiling.HbmTracker(), jax_profiling.HbmTracker()
    for stats in STATS:
        assert mine.observe("7", stats) == ref.observe("7", stats)
    assert mine.peaks() == ref.peaks() == {"7": 400.0}
    names = {"tpfl_hbm_bytes_in_use", "tpfl_hbm_peak_bytes"}
    assert _series(metrics.fold(), names) == _series(jax_metrics.fold(), names)
    mine.reset()
    assert mine.peaks() == {}


def test_hbm_sample_never_initialises_cuda():
    metrics.fold()  # runs the collectors
    assert profiling.hbm.sample() == []
    assert not torch.cuda.is_initialized()
    assert ("tpfl_hbm_bytes_in_use", (("device", "0"),)) not in metrics.fold()["gauges"]


# --- CompileObservatory ----------------------------------------------------------


def _probe_both(name, calls):
    """Run the same call sequence through a port probe and a JAX probe."""
    import jax

    mine = profiling.observatory.wrap(lambda x, n=2: (x * n).sum(), name)
    ref = jax_profiling.observatory.wrap(jax.jit(lambda x, n=2: (x * n).sum(),
                                                 static_argnums=1), name)
    for shape, dtype, extra in calls:
        mine(torch.zeros(shape, dtype=getattr(torch, dtype)), *extra)
        ref(jnp.zeros(shape, getattr(jnp, dtype)), *extra)


def _storms(ring):
    return [{k: v for k, v in e.items() if k != "t"}
            for e in ring.snapshot(profiling.PROFILING_RING) if e.get("name") == "recompile_storm"]


def test_shape_churn_probe_counts_and_storm_equal_the_reference():
    """The profiling tier's probe (8, 8, 16, 32, 64 at a threshold of 3):
    4 signatures, one hit, one storm event, in both packages."""
    _profiling_on(warn=3)
    _probe_both("probe", [((n,), "float32", ()) for n in (8, 8, 16, 32, 64)])
    assert profiling.observatory.signature_counts() == {"probe": 4}
    assert jax_profiling.observatory.signature_counts() == {"probe": 4}
    storms = _storms(flight)
    assert storms == _storms(jax_flight) and storms[-1]["signatures"] == 3
    names = {"tpfl_compile_signature_hits_total", "tpfl_recompiles_total",
             "tpfl_compile_signatures"}
    assert _series(metrics.fold(), names) == _series(jax_metrics.fold(), names)
    assert metrics.value("tpfl_compile_signature_hits_total", {"fn": "probe"}) == 1.0


def test_dtype_and_static_changes_count_as_signatures():
    _profiling_on()
    _probe_both("sig", [((4,), "float32", ()), ((4,), "int32", ()), ((4,), "float32", (3,)),
                        ((4,), "float32", (3,))])
    assert profiling.observatory.signature_counts() == (
        jax_profiling.observatory.signature_counts()) == {"sig": 3}


def test_observatory_off_is_a_passthrough():
    calls = []
    w = profiling.observatory.wrap(lambda x: calls.append(x) or x, "off")
    assert w(7) == 7 and calls == [7]
    assert "off" not in profiling.observatory.signature_counts()
    assert w.__wrapped__ is not None


def test_cache_events_and_clears_equal_the_reference():
    for obs in (profiling.observatory, jax_profiling.observatory):
        obs.cache_event("shared_programs", hit=False)
        obs.cache_event("shared_programs", hit=True)
        obs.cache_event("shared_programs", hit=True)
        obs.cache_cleared(3)
    names = {"tpfl_compiled_cache_requests_total", "tpfl_compiled_cache_clears_total",
             "tpfl_compiled_cache_dropped_total"}
    assert _series(metrics.fold(), names) == _series(jax_metrics.fold(), names)


def _storm(engine_cls, view_cls, data_dev):
    """bench.py's elastic storm (20 membership events over 30 rounds of
    one engine): the engine programs' signature counts and the view's
    promotions."""
    events = [("leave", "n1"), ("join", "n1"), ("crash", "n2"), ("join", "n2"),
              ("quarantine", "n3"), ("readmit", "n3"), ("leave", "n0"), ("join", "n0"),
              ("quarantine", "n1"), ("readmit", "n1"), ("crash", "n3"), ("join", "n3"),
              ("leave", "n2"), ("join", "n2"), ("quarantine", "n0"), ("readmit", "n0"),
              ("join", "n4"), ("leave", "n4"), ("join", "n4"), ("quarantine", "n4")]
    rng = np.random.default_rng(13)
    xs = rng.random((8, 1, 8, 8, 8), np.float32)
    ys = rng.integers(0, 10, (8, 1, 8)).astype(np.int32)
    view = view_cls([f"n{i}" for i in range(4)], capacity_min=4)
    eng = engine_cls(4)
    eng.attach_membership(view)
    p = eng.init_params((8, 8))
    dx, dy = eng.shard_data(*data_dev(xs[:4], ys[:4]))
    for r in range(24):
        if r < len(events):
            getattr(view, events[r][0])(events[r][1])
        u = eng.unpad(p)
        if eng.sync_membership():
            p = eng.pad_stacked(u)
            dx, dy = eng.shard_data(*data_dev(xs[:eng.n_nodes], ys[:eng.n_nodes]))
        p, _ = eng.run_rounds(p, dx, dy, weights=view.weights(), n_rounds=1, donate=False)
    return view.promotions()


def test_engine_programs_under_a_membership_storm_equal_the_reference():
    """Churn inside a tier re-dispatches one program with one signature;
    each tier promotion adds one program (recompiles == promotions), in
    both packages, with the same program names up to the module tag."""
    from tpfl.models import MLP as JMLP
    from tpfl.parallel import FederationEngine as JaxEngine
    from tpfl.parallel.membership import MembershipView as JaxView
    from tpfl_torch.parallel import FederationEngine
    from tpfl_torch.parallel.membership import MembershipView

    _profiling_on()
    mine = _storm(lambda n: FederationEngine(MLP(hidden_sizes=(8,), out_channels=10), n,
                                             seed=0, device="cpu"),
                  MembershipView, lambda x, y: (torch.from_numpy(x), torch.from_numpy(y)))
    ref = _storm(lambda n: JaxEngine(JMLP(hidden_sizes=(8,)), n, seed=0), JaxView,
                 lambda x, y: (x, y))
    assert mine == ref == 1

    def engine_counts(obs):
        return sorted((k.rsplit(":", 1)[0], v) for k, v in obs.signature_counts().items()
                      if k.startswith("engine_round"))

    counts = engine_counts(profiling.observatory)
    assert counts == engine_counts(jax_profiling.observatory)
    assert all(v == 1 for _, v in counts) and sum(v for _, v in counts) - 1 == mine
    engine_cache = {"tpfl_compiled_cache_requests_total"}
    got = {k: v for k, v in _series(metrics.fold(), engine_cache)["counters"].items()
           if ("cache", "engine_programs") in k[1]}
    assert got == {k: v for k, v in _series(jax_metrics.fold(), engine_cache)["counters"].items()
                   if ("cache", "engine_programs") in k[1]}


def test_vmap_federation_round_signatures_equal_the_reference():
    from tpfl.models import MLP as JMLP
    from tpfl.parallel import VmapFederation as JaxFed
    from tpfl_torch.parallel import VmapFederation

    _profiling_on()
    rng = np.random.default_rng(3)
    xs = rng.random((2, 1, 8, 8, 8), np.float32)
    ys = rng.integers(0, 10, (2, 1, 8)).astype(np.int32)
    fed = VmapFederation(MLP(hidden_sizes=(8,), out_channels=10), 2, seed=0, device="cpu")
    jfed = JaxFed(JMLP(hidden_sizes=(8,)), 2, seed=0)
    for f, data in ((fed, (torch.from_numpy(xs), torch.from_numpy(ys))), (jfed, (xs, ys))):
        p = f.init_params((8, 8))
        dx, dy = f.shard_data(*data)
        for _ in range(2):
            p, _ = f.round(p, dx, dy)

    def counts(obs):
        return {k.split(":")[0]: v for k, v in obs.signature_counts().items()
                if k.startswith("vmap_round")}

    assert counts(profiling.observatory) == counts(jax_profiling.observatory) == {
        "vmap_round": 1}


def test_learner_shared_programs_equal_the_reference():
    """Two learners of one configuration share one train-epoch and one
    eval program: the same cache traffic and signatures as the JAX
    package's."""
    from tpfl.learning.dataset import synthetic_mnist as jax_synthetic_mnist
    from tpfl.learning.jax_learner import JaxLearner
    from tpfl.learning.jax_learner import _SHARED_PROGRAMS as JAX_SHARED
    from tpfl.models import create_model as jax_create_model
    from tpfl_torch.interop import model_state_from_jax
    from tpfl_torch.learning import torch_learner
    from tpfl_torch.learning.dataset.synthetic import synthetic_mnist
    from tpfl_torch.learning.model import TpflModel
    from tpfl_torch.learning.torch_learner import TorchLearner

    _profiling_on()
    JAX_SHARED.clear()
    torch_learner._SHARED_PROGRAMS.clear()
    jds = jax_synthetic_mnist(n_train=64, n_test=16, seed=0)
    pds = synthetic_mnist(n_train=64, n_test=16, seed=0)
    init = jax_create_model("mlp", (28, 28), seed=7, hidden_sizes=(8,))
    for i in range(2):
        jl = JaxLearner(jax_create_model("mlp", (28, 28), seed=7, hidden_sizes=(8,)), jds,
                        addr=f"shared-{i}", batch_size=32)
        pl = TorchLearner(TpflModel(MLP(hidden_sizes=(8,), out_channels=10),
                                    **model_state_from_jax(init, device="cpu")), pds,
                          addr=f"shared-{i}", batch_size=32, device="cpu")
        for learner in (jl, pl):
            learner.set_epochs(1)
            learner.fit()
            learner.evaluate()

    def counts(obs):
        return {k.split(":")[0]: v for k, v in obs.signature_counts().items()
                if k.startswith(("train_epoch", "eval"))}

    assert counts(profiling.observatory) == counts(jax_profiling.observatory) == {
        "train_epoch": 1, "eval": 1}
    key = "tpfl_compiled_cache_requests_total"
    mine = {k: v for k, v in metrics.fold()["counters"].items()
            if k[0] == key and ("cache", "shared_programs") in k[1]}
    assert mine == {k: v for k, v in jax_metrics.fold()["counters"].items()
                    if k[0] == key and ("cache", "shared_programs") in k[1]}
    assert metrics.value("tpfl_compiled_cache_entries", {"cache": "shared_programs"}) == 2.0
    torch_learner.clear_compiled_caches()
    assert torch_learner._SHARED_PROGRAMS == {}
    assert metrics.value("tpfl_compiled_cache_clears_total") == 1.0
    JAX_SHARED.clear()


def test_pool_batched_programs_count_their_shapes():
    """The pool's per-signature program and per-shape fits: one miss
    each, then hits, one ``batched_fit`` signature, as the reference
    counts them."""
    from tpfl_torch.learning.dataset import RandomIIDPartitionStrategy
    from tpfl_torch.learning.dataset.synthetic import synthetic_mnist
    from tpfl_torch.learning.model import TpflModel
    from tpfl_torch.learning.torch_learner import TorchLearner
    from tpfl_torch.models import init_params
    from tpfl_torch.simulation import batched_fit

    _profiling_on()
    batched_fit.clear_programs()
    parts = synthetic_mnist(n_train=128, n_test=8, seed=0).generate_partitions(
        2, RandomIIDPartitionStrategy, seed=1)
    module = MLP(hidden_sizes=(8,), out_channels=10)
    learners = [TorchLearner(TpflModel(module, init_params(module, (28, 28), seed=0, device="cpu"), device="cpu"), parts[i],
                             addr=f"pooled-{i}", batch_size=32, device="cpu") for i in range(2)]
    for ln in learners:
        ln.set_epochs(1)
    sig = batched_fit.job_signature(learners[0])
    for _ in range(2):
        assert batched_fit.run_batched_fits(sig, learners) == []
    requests = {k[1]: v for k, v in metrics.fold()["counters"].items()
                if k[0] == "tpfl_compiled_cache_requests_total"}
    assert requests[(("cache", "batched_programs"), ("result", "miss"))] == 1.0
    assert requests[(("cache", "batched_programs"), ("result", "hit"))] == 1.0
    assert requests[(("cache", "batched_shape_fns"), ("result", "miss"))] == 1.0
    assert {k.split(":")[0]: v for k, v in profiling.observatory.signature_counts().items()} == {
        "batched_fit": 1}
    assert metrics.value("tpfl_compiled_cache_entries", {"cache": "batched_shape_fns"}) == 1.0
    batched_fit.clear_programs()


# --- the regression gate ------------------------------------------------------------


def _gate_baseline():
    return {"metrics": {
        "thr": {"path": "value", "baseline": 100.0, "tolerance": 0.2},
        "bytes": {"path": "extra.bytes", "baseline": 1000, "direction": "lower",
                  "tolerance": 0.2},
        "flag": {"path": "extra.ok", "baseline": True, "tolerance": 0.0, "required": True},
        "optional": {"path": "extra.absent", "baseline": 5.0},
        "bad": {"path": "extra.bad", "baseline": 0.0},
    }}


GATE_RUNS = {
    "within tolerance": {"value": 85.0, "extra": {"bytes": 1150, "ok": True, "bad": 1.0}},
    "20% throughput regression": {"value": 79.9, "extra": {"bytes": 1000, "ok": True}},
    "bytes past tolerance": {"value": 100.0, "extra": {"bytes": 1300, "ok": True}},
    "required missing": {"value": 100.0, "extra": {"bytes": 900}},
    "false flag": {"value": 100.0, "extra": {"bytes": 900, "ok": False}},
}


@pytest.mark.parametrize("run", sorted(GATE_RUNS))
def test_gate_verdicts_equal_the_reference(run):
    got = profiling.compare_to_baseline(GATE_RUNS[run], _gate_baseline())
    assert got == jax_profiling.compare_to_baseline(GATE_RUNS[run], _gate_baseline())
    assert got["pass"] is (run == "within tolerance")


def _synthesize(baseline, scale):
    doc = {"extra": {}}
    for spec in baseline["metrics"].values():
        cur = doc
        parts = spec["path"].split(".")
        for part in parts[:-1]:
            cur = cur.setdefault(part, {})
        base = spec["baseline"]
        if scale != 1.0 and isinstance(base, (int, float)) and not isinstance(base, bool):
            lower = spec.get("direction", "higher") == "lower"
            base = base * (1 + (spec.get("tolerance", 0.2) + 0.05) * (1 if lower else -1))
        cur[parts[-1]] = base
    return doc


@pytest.mark.parametrize("name", ["BENCH_BASELINE.json", "BENCH_BASELINE_CPU.json"])
@pytest.mark.parametrize("scale", [1.0, 0.75])
def test_gate_over_the_committed_baselines_equals_the_reference(name, scale):
    baseline = json.loads((REPO / name).read_text())
    results = _synthesize(baseline, scale)
    got = profiling.compare_to_baseline(results, baseline)
    assert got == jax_profiling.compare_to_baseline(results, baseline)
    assert got["pass"] is (scale == 1.0) and got["checked"]
    assert profiling.resolve_path(results, "extra.nope") is None


# --- timing helpers, traces, the build directory ------------------------------------


def test_timing_helpers_on_the_cpu():
    x = torch.ones((4, 4))
    best, out = profiling.best_of_wall(lambda a: a @ a, (x,), n=2)
    assert best > 0 and torch.equal(out, x @ x)
    best, out = profiling.best_of_wall_donated(lambda a: a + 1, (x,),
                                               rebind=lambda o, a: (o,), n=3)
    assert best > 0 and torch.equal(out, x + 4)  # warm-up + 3 rebinds
    rtt = profiling.measure_dispatch_rtt(device="cpu")
    assert rtt > 0
    per_iter, scalar = profiling.timed_loop(lambda c, d: {"w": c["w"] + d}, {"w": x},
                                            (torch.ones(()),), n_iters=5, device="cpu")
    assert per_iter > 0 and float(scalar) == 6.0  # 1 + 5 steps
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if not torch.cuda.is_available():
            profiling.measure_dispatch_rtt()


def test_maybe_trace_is_a_no_op_without_a_directory():
    for d in (None, ""):
        with profiling.maybe_trace(d):
            pass
    assert profiling.stop_trace() is False


def test_compile_cache_dir_is_the_kernel_build_directory(tmp_path, monkeypatch):
    """A library already built in the directory loads without nvcc and
    counts one warm hit."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    assert profiling.ensure_compile_cache(str(tmp_path / "cache")) is True
    assert _build.BUILD_DIR == tmp_path / "cache"
    target = _build._target("conv_bwd")
    assert target.parent == tmp_path / "cache"
    target.parent.mkdir(parents=True)
    target.write_bytes(b"")
    monkeypatch.setattr(_build, "nvcc_path", lambda: pytest.fail("nvcc ran"))
    assert _build.build(["conv_bwd"]) == {"conv_bwd": target}
    assert metrics.value("tpfl_compile_cache_warm_total") == 1.0
