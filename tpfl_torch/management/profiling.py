"""Device-plane performance observatory — the port of
:mod:`tpfl.management.profiling`.

- :class:`CompileObservatory` — program-cache hit / miss counters and
  distinct-signature detection at the seams where the reference jits a
  program: the engine's round program per key, ``VmapFederation``'s
  round functions, the learner's shared train / eval programs and the
  pool's batched programs. The port compiles nothing there (its
  programs are eager PyTorch and hand-written kernels built once by
  ``nvcc``), but a new argument signature is the same event: a new
  node-axis width, batch shape or dtype, which the reference pays as a
  fresh XLA compile. The counts are the reference's, so the ``elastic``
  tier's "recompiles == promotions" receipt reads the same in both
  packages. The reference's ``jax.monitoring`` listeners have no
  counterpart and are not ported; ``tpfl_compile_cache_warm_total``
  counts a kernel library found already built in the build directory
  (:func:`ensure_compile_cache`, ``Settings.COMPILE_CACHE_DIR``).
- :class:`RoundProfiler` — per-round wall-clock attribution. A round
  window opens in the vote stage (``begin_round``) and closes in the
  round-finished stage (``end_round``); instrumented sites accumulate
  seconds into ``vote`` (an addition of the port: the reference leaves
  the election in the residual), ``train``, ``fold`` and ``gossip``;
  ``host_other`` is the residual. Components may overlap in wall time,
  so coverage is reported, not clamped. :meth:`RoundProfiler.record_external`
  appends the engine fan-out's per-round rows.
- The device timing helpers :func:`measure_dispatch_rtt`,
  :func:`best_of_wall`, :func:`best_of_wall_donated` and
  :func:`timed_loop`, over CUDA synchronisation.
- :class:`CostModel` — analytic model FLOPs of the zoo architectures,
  peak FLOP/s per card (:data:`PEAK_FLOPS`) and the live MFU gauges.
  :meth:`CostModel.cost_analysis` / :meth:`CostModel.xla_flops`, the
  reference's reading of a compiled program's cost, count the FLOPs of
  one run of a callable (``torch.utils.flop_counter``): the one path
  ``parallel.scaling`` reads.
- :class:`HbmTracker` — per-card memory gauges with a high-water mark,
  read from ``torch.cuda.memory_stats``.
- the regression gate :func:`compare_to_baseline`, and
  :func:`start_trace` / :func:`stop_trace` / :func:`maybe_trace` over
  ``torch.profiler``.

Gating, as in the reference: the registry side (cache counters, cache
and memory gauges) always records; per-call work (signature
extraction, round spans) is gated by ``Settings.PROFILING_ENABLED`` and
collapses to one attribute read when off. A metrics scrape never
initialises CUDA: :meth:`HbmTracker.sample` reads only when
``torch.cuda.is_initialized()``.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpfl_torch import resolve_device
from tpfl_torch.concurrency import make_lock
from tpfl_torch.management.logger import logger
from tpfl_torch.management.telemetry import flight, metrics
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import canonical_leaves

#: Round attribution components; ``host_other`` is the residual.
COMPONENTS = ("vote", "train", "fold", "gossip", "host_other")

#: builtin alias — the profiler's API takes a ``round`` kwarg.
_round = round

#: The flight ring and logger tag of the observatory's own events (a
#: pseudo-node: compile storms and the trace are process-wide).
PROFILING_RING = "_profiling"

#: Peak dense bf16 FLOP/s per card, keyed by a prefix of
#: ``torch.cuda.get_device_name`` (NVIDIA's published H100 figures).
PEAK_FLOPS: dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989e12,  # SXM
    "NVIDIA H100 PCIe": 756e12,
    "NVIDIA H100 NVL": 835e12,
}

#: Compile wall-time buckets: a first dispatch takes ms to minutes.
COMPILE_BUCKETS: tuple[float, ...] = (
    0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 30.0, 60.0, 120.0, 300.0,
)

#: Round buckets of the live MFU's per-round seconds histogram.
ROUND_BUCKETS: tuple[float, ...] = (
    0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


def device_kind(device: Any) -> str:
    """The card's name for a ``torch.device`` (or a device string), ""
    for the CPU; an object with a ``device_kind`` attribute names
    itself."""
    if isinstance(device, str):
        device = torch.device(device)
    if isinstance(device, torch.device):
        return torch.cuda.get_device_name(device) if device.type == "cuda" else ""
    return getattr(device, "device_kind", "") or ""


def peak_flops(device: Any) -> "float | None":
    """Peak dense FLOP/s of ``device``, or None (the CPU, an unknown
    card)."""
    kind = device_kind(device)
    for k, v in PEAK_FLOPS.items():
        if kind.startswith(k):
            return v
    return None


# --- compile observatory ---------------------------------------------------


def _walk(tree: Any) -> list:
    """Leaves in ``jax.tree_util`` order; an object with ``__slots__``
    (``TrainState``) is walked like the flax struct it stands for."""
    out = []
    for leaf in canonical_leaves(tree):
        slots = getattr(type(leaf), "__slots__", None)
        if slots and not isinstance(leaf, torch.Tensor):
            out.extend(_walk([getattr(leaf, s) for s in slots]))
        else:
            out.append(leaf)
    return out


def _abstract_signature(args: tuple, kwargs: dict) -> tuple:
    """Hashable abstraction of a call's arguments, as the reference
    keys jit's cache: (shape, dtype) per tensor, values for ints /
    bools / strs, the type only for anything else."""
    out = []
    for leaf in _walk((args, kwargs)):
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is not None and dtype is not None:
            out.append(("a", tuple(shape), str(dtype)))
        elif isinstance(leaf, (int, bool, str)):
            out.append(("s", leaf))
        else:
            out.append(("t", type(leaf).__name__))
    return tuple(out)


def module_tag(module: Any) -> str:
    """Short stable tag of an architecture: the CRC-32 of its ``repr``,
    four hex digits (the reference's ``module_tag``)."""
    return f"{zlib.crc32(repr(module).encode()) & 0xFFFF:04x}"


class CompileObservatory:
    """Program-cache accounting and distinct-signature detection keyed
    by (fn, abstract shapes / dtypes).

    - Always on: :meth:`cache_event` / :meth:`cache_cleared` count the
      process program caches' traffic.
    - Gated by ``Settings.PROFILING_ENABLED``: :meth:`wrap` puts a
      signature probe in front of a program; a never-seen (fn,
      signature) is timed into ``tpfl_compile_seconds`` (its first
      dispatch) and counted, and when one fn reaches
      ``Settings.PROFILING_RECOMPILE_WARN`` signatures a
      ``recompile_storm`` event lands in the ``_profiling`` flight ring
      and the log.
    """

    def __init__(self) -> None:
        self._lock = make_lock("CompileObservatory._lock")
        # guarded-by: _lock
        self._signatures: dict[str, set] = {}
        # guarded-by: _lock
        self._warned: set[str] = set()

    def cache_event(self, cache: str, hit: bool) -> None:
        """One lookup against a process program cache."""
        metrics.counter("tpfl_compiled_cache_requests_total",
                        labels={"cache": cache, "result": "hit" if hit else "miss"})

    def cache_cleared(self, dropped: int) -> None:
        """``clear_compiled_caches`` ran; ``dropped`` programs freed."""
        metrics.counter("tpfl_compiled_cache_clears_total")
        metrics.counter("tpfl_compiled_cache_dropped_total", float(dropped))

    def wrap(self, fn: Callable, name: str) -> Callable:
        """Signature-probe wrapper around a program. Off, one attribute
        read and a passthrough; on, each call abstracts its arguments
        and a fresh signature counts (and times) as a compilation."""

        def observed(*args: Any, **kwargs: Any) -> Any:
            if not Settings.PROFILING_ENABLED:
                return fn(*args, **kwargs)
            fresh, n_sigs = self._note(name, _abstract_signature(args, kwargs))
            if not fresh:
                metrics.counter("tpfl_compile_signature_hits_total", labels={"fn": name})
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            metrics.observe("tpfl_compile_seconds", time.perf_counter() - t0,
                            labels={"fn": name}, buckets=COMPILE_BUCKETS)
            metrics.gauge("tpfl_compile_signatures", float(n_sigs), labels={"fn": name})
            if n_sigs > 1:
                metrics.counter("tpfl_recompiles_total", labels={"fn": name})
            self._maybe_warn_storm(name, n_sigs)
            return out

        observed.__wrapped__ = fn  # type: ignore[attr-defined]
        return observed

    def _note(self, name: str, sig: tuple) -> tuple[bool, int]:
        with self._lock:
            seen = self._signatures.setdefault(name, set())
            if sig in seen:
                return False, len(seen)
            seen.add(sig)
            return True, len(seen)

    def _maybe_warn_storm(self, name: str, n_sigs: int) -> None:
        warn_at = max(2, int(Settings.PROFILING_RECOMPILE_WARN))
        if n_sigs < warn_at:
            return
        with self._lock:
            if name in self._warned:
                return
            self._warned.add(name)
        # Outside _lock: the ring and the logger take their own locks.
        flight.record(PROFILING_RING, {
            "kind": "event", "name": "recompile_storm", "node": PROFILING_RING, "trace": "",
            "t": time.monotonic(), "fn": name, "signatures": n_sigs,
        })
        logger.warning(PROFILING_RING,
                       f"Recompile storm: '{name}' dispatched with {n_sigs} distinct argument "
                       f"signatures (threshold {warn_at}) — shape/dtype churn")

    def signature_counts(self) -> dict[str, int]:
        """fn name -> distinct abstract signatures seen."""
        with self._lock:
            return {k: len(v) for k, v in self._signatures.items()}

    def reset(self) -> None:
        with self._lock:
            self._signatures.clear()
            self._warned.clear()


# --- round profiler ----------------------------------------------------------


class _RoundSpan:
    """Accumulating component timer (``with rounds.span(node, comp):``)."""

    __slots__ = ("_profiler", "_node", "_component", "_t0")

    def __init__(self, profiler: "RoundProfiler", node: str, component: str) -> None:
        self._profiler = profiler
        self._node = node
        self._component = component
        self._t0 = 0.0

    def __enter__(self) -> "_RoundSpan":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc: object) -> None:
        self._profiler.add(self._node, self._component, time.monotonic() - self._t0)


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        pass


_NULL_SPAN = _NullSpan()


class RoundProfiler:
    """Per-round wall-clock attribution: ``begin_round`` opens a node's
    window, :meth:`add` / :meth:`span` accumulate component seconds into
    it, ``end_round`` closes it, computes ``host_other`` and keeps the
    record for :meth:`attribution`; the per-component seconds also land
    in ``logger.metrics`` as ``tpfl_round_attr_seconds{node,component}``
    and the wall as ``tpfl_round_wall_seconds{node}``."""

    def __init__(self) -> None:
        self._lock = make_lock("RoundProfiler._lock")
        # guarded-by: _lock. Per node a stack of open round windows.
        self._active: dict[str, list[dict]] = {}
        # guarded-by: _lock
        self._done: deque = deque(maxlen=1024)

    def enabled(self) -> bool:
        return bool(Settings.PROFILING_ENABLED)

    def begin_round(self, node: str, round: "int | None") -> None:
        if not Settings.PROFILING_ENABLED:
            return
        with self._lock:
            self._active.setdefault(node, []).append({
                "node": node,
                "round": round if round is not None else -1,
                "t0": time.monotonic(),
                "parts": dict.fromkeys(COMPONENTS[:-1], 0.0),
            })

    def _open_record(self, node: str, round: "int | None") -> "dict | None":
        """The node's open record for ``round`` — the most recent one
        when ``round`` is None or unmatched. Caller holds ``_lock``."""
        recs = self._active.get(node)
        if not recs:
            return None
        if round is not None:
            for rec in recs:
                if rec["round"] == round:
                    return rec
        return recs[-1]

    def add(self, node: str, component: str, seconds: float,
            round: "int | None" = None) -> None:
        """Accumulate measured seconds into the node's open round (a
        no-op outside a round window: bare learner fits need no
        federation round)."""
        if not Settings.PROFILING_ENABLED or seconds <= 0:
            return
        with self._lock:
            rec = self._open_record(node, round)
            if rec is not None:
                parts = rec["parts"]
                parts[component] = parts.get(component, 0.0) + seconds

    def span(self, node: str, component: str) -> "_RoundSpan | _NullSpan":
        if not Settings.PROFILING_ENABLED:
            return _NULL_SPAN
        return _RoundSpan(self, node, component)

    def end_round(self, node: str, round: "int | None") -> "dict | None":
        if not Settings.PROFILING_ENABLED:
            return None
        now = time.monotonic()
        with self._lock:
            rec = self._open_record(node, round)
            if rec is not None:
                self._active[node].remove(rec)
                if not self._active[node]:
                    del self._active[node]
        if rec is None:
            return None
        wall = max(now - rec["t0"], 1e-9)
        parts = rec["parts"]
        measured = sum(parts.values())
        parts["host_other"] = max(0.0, wall - measured)
        record = {
            "node": node,
            "round": rec["round"],
            "wall": wall,
            "parts": parts,
            "coverage": (measured + parts["host_other"]) / wall,
            "measured_frac": measured / wall,
        }
        with self._lock:
            self._done.append(record)
        for comp, secs in parts.items():
            logger.metrics.observe("tpfl_round_attr_seconds", secs,
                                   labels={"node": node, "component": comp})
        logger.metrics.observe("tpfl_round_wall_seconds", wall, labels={"node": node})
        return record

    def record_external(self, node: str, round: "int | None", parts: dict,
                        wall: float) -> "dict | None":
        """Append one completed round record whose component seconds were
        measured elsewhere (the engine fan-out's per-round rows, marked
        ``external``): the same ``tpfl_round_*`` series as
        :meth:`end_round`, ``host_other`` the residual, and a ``round``
        span in the node's flight ring."""
        if not Settings.PROFILING_ENABLED:
            return None
        wall = max(float(wall), 1e-9)
        parts = {k: float(v) for k, v in parts.items()}
        measured = sum(parts.values())
        parts.setdefault("host_other", max(0.0, wall - measured))
        record = {
            "node": node,
            "round": int(round) if round is not None else -1,
            "wall": wall,
            "parts": parts,
            "coverage": sum(parts.values()) / wall,
            "measured_frac": measured / wall,
            "external": True,
        }
        with self._lock:
            self._done.append(record)
        for comp, secs in parts.items():
            logger.metrics.observe("tpfl_round_attr_seconds", secs,
                                   labels={"node": node, "component": comp})
        logger.metrics.observe("tpfl_round_wall_seconds", wall, labels={"node": node})
        now = time.monotonic()
        flight.record(node, {
            "kind": "span", "name": "round", "node": node, "trace": "", "t0": now - wall,
            "t1": now, "round": record["round"],
            **{f"s_{k}": _round(v, 6) for k, v in parts.items()},
        })
        return record

    def attribution(self, node: "str | None" = None) -> list[dict]:
        """Completed round records (optionally one node's), oldest first."""
        with self._lock:
            records = list(self._done)
        if node is not None:
            records = [r for r in records if r["node"] == node]
        return records

    def reset(self) -> None:
        with self._lock:
            self._active.clear()
            self._done.clear()


# --- torch.profiler trace wrap (any run) -------------------------------------

_trace_lock = make_lock("profiling._trace_lock")
# guarded-by: _trace_lock — 0 or 1 (directory, stop event, owner thread,
# outcome) entries
_trace: "list[tuple[str, threading.Event, threading.Thread, dict]]" = []


def _own_trace(directory: str, started: threading.Event, halt: threading.Event,
               outcome: dict) -> None:
    """The trace's owner thread: starts ``torch.profiler`` (every thread's
    ops, and the card's kernels when there is one), waits for
    :func:`stop_trace`, then stops it and writes ``trace.json``. The
    profiler is started and stopped on this one thread: stopped from
    another thread than the one that started it, torch's profiler
    crashes the process."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities,
                       experimental_config=_ExperimentalConfig(profile_all_threads=True))
        prof.start()
    except Exception as e:
        outcome["error"] = e
        started.set()
        return
    started.set()
    halt.wait()
    try:
        prof.stop()
        os.makedirs(directory, exist_ok=True)
        outcome["path"] = os.path.join(directory, "trace.json")
        prof.export_chrome_trace(outcome["path"])
    except Exception as e:
        outcome["error"] = e


def start_trace(directory: str) -> bool:
    """Start a process-wide ``torch.profiler`` trace (CPU ops of every
    thread, and CUDA when a card is present) that :func:`stop_trace`
    writes into ``directory`` (idempotent: a second start while one is
    active is a no-op — in-process nodes share one profiler). Returns
    True when this call started it."""
    if not directory:
        return False
    with _trace_lock:
        if _trace:
            return False
        started, halt, outcome = threading.Event(), threading.Event(), {}
        owner = threading.Thread(target=_own_trace, args=(directory, started, halt, outcome),
                                 name="tpfl-profiler-trace", daemon=True)
        owner.start()
        started.wait()
        if "error" in outcome:
            owner.join()
            logger.warning(PROFILING_RING, f"torch.profiler trace failed: {outcome['error']}")
            return False
        _trace.append((directory, halt, owner, outcome))
    return True


def stop_trace() -> bool:
    """Stop the active trace, if any, and write it as
    ``<directory>/trace.json`` (Chrome trace format; idempotent; any
    thread may call it)."""
    with _trace_lock:
        if not _trace:
            return False
        _, halt, owner, outcome = _trace.pop()
    halt.set()
    owner.join()
    if "error" in outcome:
        logger.warning(PROFILING_RING, f"torch.profiler trace failed: {outcome['error']}")
        return False
    logger.info(PROFILING_RING, f"torch.profiler trace written to {outcome['path']}")
    return True


@contextlib.contextmanager
def maybe_trace(directory: "str | None") -> Iterator[None]:
    """Wrap a block in a :func:`start_trace` trace when ``directory`` is
    set; a shared no-op otherwise."""
    started = start_trace(directory) if directory else False
    try:
        yield
    finally:
        if started:
            stop_trace()


# --- device timing (the bench methodology, as an API) ------------------------


def _sync_all(tree: Any) -> None:
    """Wait for every card that holds a tensor of ``tree``."""
    for dev in {leaf.device for leaf in _walk(tree)
                if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def _sync_scalar(out: Any) -> None:
    """The one host sync both wall timers share: one scalar ``.item()``
    of the last output leaf (copying a whole carry would time the copy,
    not the card)."""
    leaf = [x for x in _walk(out) if isinstance(x, torch.Tensor)][-1]
    leaf.reshape(-1)[0].item()


def best_of_wall(fn: Callable, args: tuple, n: int = 3) -> tuple[float, Any]:
    """Best-of-``n`` wall time of ``fn(*args)`` with a scalar host sync
    on the last output leaf; returns ``(best_seconds, last_outputs)``.
    The first call is a discarded warm-up. ``fn`` must leave its inputs
    intact (for a program that consumes them use
    :func:`best_of_wall_donated`)."""
    out = fn(*args)
    _sync_scalar(out)
    best = float("inf")
    for _ in range(max(1, n)):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync_scalar(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def best_of_wall_donated(fn: Callable, args: tuple, rebind: Callable[[Any, tuple], tuple],
                         n: int = 3) -> tuple[float, Any]:
    """:func:`best_of_wall` for a program whose next call feeds on its
    last outputs: ``rebind(last_outputs, prev_args) -> args`` builds each
    iteration's arguments (e.g. ``lambda out, a: (out[0], *a[1:])``: the
    next window trains from this window's fold). The rebinding and the
    arguments' device work finish before the clock starts."""
    out = fn(*args)
    _sync_scalar(out)
    best = float("inf")
    for _ in range(max(1, n)):
        args = rebind(out, args)
        _sync_all(args)
        t0 = time.perf_counter()
        out = fn(*args)
        _sync_scalar(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def measure_dispatch_rtt(best_of: int = 3, device: Any = None) -> float:
    """Seconds for one launch + sync round trip of a one-element op on
    ``device`` (``None``: the card) — the empty-call baseline
    :func:`timed_loop` subtracts."""
    x = torch.ones((1,), dtype=torch.float32, device=resolve_device(device))
    rtt, _ = best_of_wall(lambda a: a + 1.0, (x,), best_of)
    return rtt


def timed_loop(step: Callable, carry: Any, data: tuple, n_iters: int,
               rtt: "float | None" = None, best_of: int = 3,
               device: Any = None) -> tuple[float, Any]:
    """Seconds per iteration of ``step(carry, *data) -> carry``: the
    bench methodology as an API. ``n_iters`` step calls run in a host
    loop (the port has no device-side ``fori_loop``: each call enqueues
    its kernels and returns), reduced to one f32 scalar from every carry
    leaf (every output observed, one 4-byte sync); a measured launch +
    sync round trip on ``device`` is subtracted (pass ``rtt`` to share
    one measurement); best of ``best_of`` runs. Returns
    ``(seconds_per_iter, the scalar)``."""
    if rtt is None:
        rtt = measure_dispatch_rtt(best_of, device)

    def run(c: Any, *d: Any) -> torch.Tensor:
        for _ in range(n_iters):
            c = step(c, *d)
        leaves = [x for x in _walk(c) if isinstance(x, torch.Tensor)]
        return sum(x.reshape(-1)[0].to(torch.float32) for x in leaves)

    total, out = best_of_wall(run, (carry, *data), best_of)
    return max(total - rtt, 1e-9) / n_iters, out


# --- cost model ----------------------------------------------------------------


class _FlopCount(TorchDispatchMode):
    """Sums ``torch.utils.flop_counter.flop_registry``'s count of every
    aten op dispatched while it is active (matmuls, convolutions,
    attention; elementwise ops count none, as XLA's cost analysis barely
    weighs them)."""

    def __init__(self) -> None:
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func: Any, types: Any, args: tuple = (),
                           kwargs: Any = None) -> Any:
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.total += int(count(*args, **kwargs, out_val=out))
        return out


class CostModel:
    """FLOPs and MFU accounting: analytic model FLOPs of the zoo
    architectures, the card's peak, and the live per-round MFU gauges
    that the benchmark's analytic MFU column is held against."""

    @staticmethod
    def cost_analysis(compiled: Callable[[], Any]) -> dict:
        """The cost of one run of ``compiled``, a zero-argument callable
        (the port compiles no XLA executable; the program is the call):
        ``{"flops": ...}``, the aten ops the call dispatches counted by
        ``torch.utils.flop_counter``'s formulas (its ``flop_registry``,
        under a dispatch mode of our own: ``FlopCounterMode``'s module
        tracker refuses the engine's ``autograd.grad``). A kernel launched
        through ``ctypes`` is invisible to it: on CUDA tensors the conv
        and flash kernels' work is not counted, on CPU tensors their
        plain versions run and are."""
        if not callable(compiled):
            raise TypeError(f"cost_analysis takes a zero-argument callable, got "
                            f"{type(compiled).__name__}: the port has no compiled executable")
        counter = _FlopCount()
        with counter:
            compiled()
        return {"flops": float(counter.total)}

    @classmethod
    def xla_flops(cls, compiled: Callable[[], Any]) -> "float | None":
        """The FLOPs of one run of ``compiled`` (:meth:`cost_analysis`),
        None when it counted none — the reference's contract."""
        flops = cls.cost_analysis(compiled)["flops"]
        return flops if flops > 0 else None

    @staticmethod
    def analytic_fwd_mults(module: Any, input_shape: tuple[int, ...]) -> "int | None":
        """Per-sample forward multiply count of the zoo ``CNN`` (3x3 SAME
        convs, 2x2 max-pools, dense head), ``MLP`` (dense stack) and
        ``TransformerLM`` (per token and layer QKV 3d² + attention-out
        d² + FFN 2·ratio·d², causal attention ≈ S·d, and the d·V logits
        head), read from the module's configuration; None for other
        architectures."""
        vocab = getattr(module, "vocab", None)
        t_dim = getattr(module, "dim", None)
        t_layers = getattr(module, "n_layers", None)
        if vocab is not None and t_dim is not None and t_layers is not None:
            if len(input_shape) != 1:
                return None
            s = int(input_shape[0])
            ratio = int(getattr(module, "mlp_ratio", 4))
            per_token = t_layers * ((4 + 2 * ratio) * t_dim * t_dim + s * t_dim) + t_dim * vocab
            return int(s * per_token)
        channels = getattr(module, "channels", None)
        dense = getattr(module, "dense", None)
        out_channels = getattr(module, "out_channels", None)
        hidden = getattr(module, "hidden_sizes", None)
        if channels is not None and dense is not None and out_channels is not None:
            if len(input_shape) != 3:
                return None
            h, w, cin = input_shape
            mults = 0
            for c in channels:
                mults += h * w * 9 * cin * c  # 3x3 SAME conv
                cin = c
                h //= 2
                w //= 2  # 2x2 max-pool
            mults += (h * w * cin) * dense
            mults += dense * out_channels
            return int(mults)
        if hidden is not None and out_channels is not None:
            features = 1
            for d in input_shape:
                features *= d
            mults = 0
            for width in tuple(hidden) + (out_channels,):
                mults += features * width
                features = width
            return int(mults)
        return None

    @classmethod
    def analytic_train_flops(cls, module: Any, input_shape: tuple[int, ...],
                             samples: int) -> "float | None":
        """Model FLOPs of training on ``samples`` samples: 2 FLOPs a
        multiply, x3 for forward and backward."""
        mults = cls.analytic_fwd_mults(module, input_shape)
        if mults is None:
            return None
        return 3.0 * 2.0 * mults * samples

    @staticmethod
    def mfu(flops_per_sec: float, device: Any = None, n_chips: int = 1) -> "float | None":
        """Model-FLOPs utilisation against ``device``'s peak (``None``:
        the card); None when the device has no published peak."""
        if device is None:
            device = resolve_device(None)
        peak = peak_flops(device)
        if not peak:
            return None
        return flops_per_sec / (peak * max(1, n_chips))

    @classmethod
    def record_round(cls, program: str, flops: float, seconds: float, device: Any = None,
                     n_chips: int = 1) -> "float | None":
        """Publish one round's live MFU: the ``tpfl_mfu{program}`` and
        ``tpfl_round_flops{program}`` gauges and the
        ``tpfl_round_compute_seconds`` histogram. Returns the MFU (None
        without a published peak)."""
        seconds = max(seconds, 1e-12)
        value = cls.mfu(flops / seconds, device=device, n_chips=n_chips)
        metrics.gauge("tpfl_round_flops", float(flops), labels={"program": program})
        metrics.observe("tpfl_round_compute_seconds", seconds, labels={"program": program},
                        buckets=ROUND_BUCKETS)
        if value is not None:
            metrics.gauge("tpfl_mfu", float(value), labels={"program": program})
        return value


# --- device memory high-water marks --------------------------------------------


class HbmTracker:
    """Per-card memory gauges with a process-lifetime high-water mark:
    ``tpfl_hbm_bytes_in_use`` / ``tpfl_hbm_peak_bytes{device}``. A
    registry collector, so a scrape sees fresh values without a
    monitor; :class:`~tpfl_torch.management.node_monitor.NodeMonitor`
    samples it on its period too."""

    def __init__(self) -> None:
        self._lock = make_lock("HbmTracker._lock")
        # guarded-by: _lock
        self._peaks: dict[str, float] = {}

    def sample(self) -> list[tuple[str, float, float]]:
        """[(device index, bytes allocated, peak bytes)] of every card,
        from ``torch.cuda.memory_stats``: in use is
        ``allocated_bytes.all.current``, the reported peak
        ``allocated_bytes.all.peak``. Reads nothing until CUDA is
        initialised (a scrape never initialises it); host reads only."""
        if not torch.cuda.is_initialized():
            return []
        out: list[tuple[str, float, float]] = []
        for i in range(torch.cuda.device_count()):
            try:
                stats = torch.cuda.memory_stats(i)
            except Exception:
                continue
            if "allocated_bytes.all.current" not in stats:
                continue
            out.append(self._record(str(i), {
                "bytes_in_use": stats["allocated_bytes.all.current"],
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            }))
        return out

    def _record(self, dev: str, stats: dict) -> tuple[str, float, float]:
        in_use = float(stats["bytes_in_use"])
        reported_peak = float(stats.get("peak_bytes_in_use", 0.0))
        with self._lock:
            peak = max(self._peaks.get(dev, 0.0), in_use, reported_peak)
            self._peaks[dev] = peak
        labels = {"device": dev}
        metrics.gauge("tpfl_hbm_bytes_in_use", in_use, labels=labels)
        metrics.gauge("tpfl_hbm_peak_bytes", peak, labels=labels)
        return dev, in_use, peak

    def observe(self, dev: str, stats: dict) -> tuple[str, float, float]:
        """Fold one externally sampled stats dict (the reference's keys
        ``bytes_in_use`` / ``peak_bytes_in_use``) through the same peak
        tracking."""
        return self._record(dev, stats)

    def peaks(self) -> dict[str, float]:
        with self._lock:
            return dict(self._peaks)

    def reset(self) -> None:
        with self._lock:
            self._peaks.clear()


# --- registry collectors ----------------------------------------------------------


def _compiled_cache_collector(registry: Any) -> None:
    """Sizes of the process program caches: the learner's shared
    programs, the pool's batched programs and their per-shape fits.
    Reads only modules already imported (a scrape imports nothing)."""
    tl = sys.modules.get("tpfl_torch.learning.torch_learner")
    if tl is not None:
        registry.gauge("tpfl_compiled_cache_entries", float(len(tl._SHARED_PROGRAMS)),
                       labels={"cache": "shared_programs"})
    bf = sys.modules.get("tpfl_torch.simulation.batched_fit")
    if bf is not None:
        programs = list(bf._programs.values())
        registry.gauge("tpfl_compiled_cache_entries", float(len(programs)),
                       labels={"cache": "batched_programs"})
        registry.gauge("tpfl_compiled_cache_entries",
                       float(sum(len(p._fns) for p in programs)),
                       labels={"cache": "batched_shape_fns"})


def _hbm_collector(registry: Any) -> None:
    hbm.sample()


# --- perf regression gate ------------------------------------------------------

#: Default per-metric relative tolerance of the regression gate.
DEFAULT_TOLERANCE = 0.2


def resolve_path(doc: Any, path: str) -> Any:
    """Dotted-path lookup into a result document (``"extra.mfu"`` →
    ``doc["extra"]["mfu"]``); None when missing."""
    cur = doc
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def compare_to_baseline(results: dict, baseline: dict) -> dict:
    """The perf regression gate: a run's metrics against a baseline
    document ``{"metrics": {name: {"path", "baseline", "direction"
    ("higher" / "lower"), "tolerance", "required"}}}``. A higher-is-better
    metric regresses below ``baseline * (1 - tolerance)``, a
    lower-is-better one above ``baseline * (1 + tolerance)``; booleans
    count as 1.0 / 0.0; a metric missing from the run is skipped unless
    ``required``. Returns ``{"pass", "checked", "skipped"}``."""
    checked: list[dict] = []
    skipped: list[dict] = []
    ok_all = True
    for name, spec in sorted(baseline.get("metrics", {}).items()):
        path = spec.get("path", name)
        base = spec.get("baseline")
        value = resolve_path(results, path)
        if isinstance(value, bool):
            value = 1.0 if value else 0.0
        if isinstance(base, bool):
            base = 1.0 if base else 0.0
        if value is None or not isinstance(value, (int, float)):
            entry = {"metric": name, "path": path, "status": "missing"}
            if spec.get("required", False):
                entry["ok"] = False
                checked.append(entry)
                ok_all = False
            else:
                skipped.append(entry)
            continue
        if not isinstance(base, (int, float)) or base == 0:
            skipped.append({"metric": name, "path": path, "status": "bad_baseline"})
            continue
        tolerance = float(spec.get("tolerance", DEFAULT_TOLERANCE))
        direction = spec.get("direction", "higher")
        ratio = float(value) / float(base)
        ok = ratio <= 1.0 + tolerance if direction == "lower" else ratio >= 1.0 - tolerance
        checked.append({"metric": name, "path": path, "value": value, "baseline": base,
                        "ratio": _round(ratio, 4), "direction": direction,
                        "tolerance": tolerance, "ok": ok})
        ok_all = ok_all and ok
    return {"pass": bool(ok_all), "checked": checked, "skipped": skipped}


# --- the kernel build directory as the compile cache -------------------------------


def ensure_compile_cache(directory: str) -> bool:
    """Point the kernel build (``tpfl_torch.parallel._build``: ``nvcc``
    outputs named by a hash of their sources and flags) at ``directory``
    (``Settings.COMPILE_CACHE_DIR``; ``FederationEngine`` calls this when
    the knob is set). A later process finds its libraries there instead
    of compiling them; each one found counts
    ``tpfl_compile_cache_warm_total``. Libraries this process already
    loaded stay loaded. Returns True."""
    from tpfl_torch.parallel import _build

    _build.use_build_dir(os.path.abspath(directory))
    return True


#: Process-wide singletons (one federation per process).
observatory = CompileObservatory()
rounds = RoundProfiler()
cost_model = CostModel()
hbm = HbmTracker()

metrics.register_collector(_compiled_cache_collector)
metrics.register_collector(_hbm_collector)

__all__ = ["COMPILE_BUCKETS", "COMPONENTS", "CompileObservatory", "CostModel",
           "DEFAULT_TOLERANCE", "HbmTracker", "PEAK_FLOPS", "PROFILING_RING", "RoundProfiler",
           "best_of_wall", "best_of_wall_donated", "compare_to_baseline", "cost_model",
           "ensure_compile_cache", "hbm", "maybe_trace", "measure_dispatch_rtt",
           "module_tag", "observatory", "peak_flops", "resolve_path", "rounds",
           "start_trace", "stop_trace", "timed_loop"]
