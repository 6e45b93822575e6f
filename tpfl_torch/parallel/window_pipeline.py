"""WindowPipeline — the free-running engine driver, the port of
:mod:`tpfl.parallel.window_pipeline` (Podracer's Sebulba split).

A sequential driver pays, between windows, host costs the device never
waits for in a pipeline: the telemetry fan-out (``engine_obs.replay_window``),
profiler rows, the next window's data staging and the enqueue itself.
:meth:`FederationEngine.dispatch_window` enqueues a window's work and
returns without a host sync, so this driver keeps one window in flight
ahead of the host::

    device |  win N  ||  win N+1  ||  win N+2  | ...
    host   | dispatch N+1 ; finalize N (telemetry replay, profiler)
           | stage N+2's data on the prefetch thread ; dispatch N+2 ...

Window N+1 is dispatched with window N's output tensors before window N
is finalized; a donating window N+1 writes them in place, behind window
N's work on the same stream, so a cadence snapshot's host copy of window
N's state is enqueued before window N+1 is. The measured device-idle gap before each dispatch
(:attr:`WindowPipeline.idle_gaps`, probed with the previous window's
CUDA event) shrinks to the argument preparation.

Determinism: the pipeline reorders host work only — the device runs the
same rounds on the same tensors in the same order, so runs equal a chain
of ``run_rounds`` calls over the same per-window data, byte for byte.

Streams: the prefetcher stages a window's data on its own thread and,
on the card, on its own CUDA stream; :meth:`WindowPrefetcher.take` makes
the consuming stream wait for it (``wait_stream``) and marks the staged
tensors as used there (``record_stream``), so the caching allocator does
not hand their memory out while the window reads them. The thread is
joined at every take and on shutdown: no thread outlives :meth:`run`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

import torch

from tpfl_torch import concurrency
from tpfl_torch.management.telemetry import metrics
from tpfl_torch.parallel.engine import (
    EngineWindow,
    FedBuffSchedule,
    FederationEngine,
    HostCopy,
    _map_tensors,
    start_host_copy,
)
from tpfl_torch.parallel.distributed import full_tensor
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import tree_map

# data_for(window_index, start_round, n_rounds) -> (xs, ys) or None
# (None = reuse the current window's arrays).
DataSupplier = Callable[[int, int, int], "Optional[tuple[Any, Any]]"]

# Live pipelines by owner addr — the shutdown seam (interrupt_for).
# guarded-by: _ACTIVE_LOCK
_ACTIVE: "dict[str, WindowPipeline]" = {}
_ACTIVE_LOCK = concurrency.make_lock("window_pipeline._ACTIVE_LOCK")


def interrupt_for(addr: str) -> bool:
    """Interrupt the pipeline running for ``addr`` (False when none is
    registered): the run stops at its next window boundary and abandons
    its in-flight window."""
    with _ACTIVE_LOCK:
        pipe = _ACTIVE.get(addr)
    if pipe is None:
        return False
    pipe.interrupt()
    return True


class WindowPrefetcher:
    """Single-slot background stager of the next window's data.

    :meth:`start` runs the supplier on a named thread — on a CUDA device
    under the prefetcher's own stream; :meth:`take` joins it and hands
    the staged data over, ordered before the consuming stream's later
    work. A thread is always joined before the next starts and on
    :meth:`close`."""

    def __init__(self, fn: DataSupplier, device: Optional[torch.device] = None,
                 name: str = "tpfl-window-prefetch") -> None:
        self._fn = fn
        self._name = name
        self._device = device
        self._stream = (torch.cuda.Stream(device) if device is not None
                        and device.type == "cuda" else None)
        self._lock = concurrency.make_lock("WindowPrefetcher._lock")
        self._thread: Optional[threading.Thread] = None
        # guarded-by: _lock — (window_index, staged_data, error)
        self._slot: Optional[tuple] = None

    def start(self, widx: int, start_round: int, n_rounds: int) -> None:
        """Stage window ``widx``'s data in the background (joins any
        previous stage first — one in flight)."""
        self.close()

        def work() -> None:
            out, err = None, None
            try:
                if self._stream is None:
                    out = self._fn(widx, start_round, n_rounds)
                else:
                    with torch.cuda.stream(self._stream):
                        out = self._fn(widx, start_round, n_rounds)
            except BaseException as e:  # surfaced at take()
                err = e
            with self._lock:
                self._slot = (widx, out, err)

        self._thread = threading.Thread(target=work, name=f"{self._name}[{widx}]", daemon=True)
        self._thread.start()

    def take(self, widx: int) -> "Optional[tuple[Any, Any]]":
        """Join the stage and return window ``widx``'s staged data (None
        when nothing was staged for it); re-raises a supplier error on
        the caller's thread."""
        self.close()
        with self._lock:
            slot, self._slot = self._slot, None
        if slot is None:
            return None
        staged_widx, out, err = slot
        if err is not None:
            raise err
        if staged_widx != widx:
            return None
        if self._stream is not None and out is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_stream(self._stream)

            def used_here(t: torch.Tensor) -> torch.Tensor:
                if t.device.type == "cuda":
                    t.record_stream(consumer)
                return t

            _map_tensors(used_here, out)
        return out

    def close(self) -> None:
        """Join any in-flight stage (idempotent)."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()


class WindowPipeline:
    """Free-running multi-window driver over one engine.

    :meth:`run` covers ``n_rounds`` rounds in windows of ``window``
    rounds, dispatching window N+1 before finalizing window N. Results,
    side effects and bytes match a sequential chain of
    :meth:`FederationEngine.run_rounds` calls over the same per-window
    data.

    Attributes:
        idle_gaps: the device-idle gap (seconds) measured before each
            dispatch after the first: the host's preparation time when
            the previous window had already finished before it began,
            else 0.
        windows_run: dispatched window count of the last :meth:`run`.
    """

    def __init__(self, engine: FederationEngine) -> None:
        self.engine = engine
        self.idle_gaps: list[float] = []
        self.windows_run = 0
        self._abort = threading.Event()

    def interrupt(self) -> None:
        """Stop the current :meth:`run` at the next window boundary
        (thread-safe; sticky until the next run starts)."""
        self._abort.set()

    def _materialize_snapshot(self, snap: tuple,
                              snapshot_to: Callable[[int, dict], None]) -> None:
        """Hand a cadence snapshot to ``snapshot_to``: its host copy was
        started at dispatch and had a window's device time to land."""
        rounds_at, copy = snap
        p, a, ss = copy.wait()
        state = self.engine.export_state(p, aux=a, scaffold_state=ss)
        state["rounds_done"] = int(rounds_at)
        snapshot_to(int(rounds_at), state)

    def run(
        self,
        params: Any,
        xs: Any,
        ys: Any,
        weights: Optional[Any] = None,
        epochs: int = 1,
        n_rounds: int = 1,
        window: Optional[int] = None,
        aux: Optional[Any] = None,
        scaffold_state: Optional[tuple[Any, Any]] = None,
        donate: Optional[bool] = None,
        schedule: Optional[FedBuffSchedule] = None,
        data_for: Optional[DataSupplier] = None,
        prefetch: Optional[bool] = None,
        should_stop: Optional[Callable[[], bool]] = None,
        weights_for: Optional[Callable[[int], Any]] = None,
        snapshot_every: int = 0,
        snapshot_to: Optional[Callable[[int, dict], None]] = None,
        owner: Optional[str] = None,
    ) -> tuple[Optional[tuple], int]:
        """Run ``n_rounds`` rounds free-running; returns ``(result,
        rounds_done)``, ``result`` in ``run_rounds``' convention for the
        LAST window (None if nothing was dispatched or the run was
        interrupted).

        ``window`` (rounds per dispatch) defaults to
        ``Settings.SHARD_ROUNDS_PER_DISPATCH``. ``schedule`` spans the
        whole run and is cut into per-window slices; per-round
        ``weights`` ``[n_rounds, n]`` are sliced the same way.
        ``data_for(widx, start_round, k)`` supplies each window's data —
        staged on the :class:`WindowPrefetcher` thread when ``prefetch``
        (default ``Settings.ENGINE_PREFETCH``) is on, inline otherwise:
        the same function of the window index either way, so the knob
        never changes bytes. ``should_stop`` is polled before each
        dispatch. ``weights_for(widx)`` supplies each window's fold
        weights (the membership re-mask seam), overriding ``weights``.
        ``snapshot_every`` / ``snapshot_to``: every K-th window's output
        state is copied to the host behind the window and handed to
        ``snapshot_to(rounds_done, export_state(...))`` at the next loop
        top. ``owner`` registers the run for :func:`interrupt_for`.
        ``donate`` is passed on to every dispatch: donating, each window
        writes the state it was given — window N+1 the outputs of window
        N, in stream order after them — and only the first window's may
        be the caller's tensors."""
        eng = self.engine
        window = max(1, int(window if window is not None
                            else Settings.SHARD_ROUNDS_PER_DISPATCH))
        if prefetch is None:
            prefetch = bool(Settings.ENGINE_PREFETCH)
        if schedule is not None and schedule.n_rounds != int(n_rounds):
            raise ValueError(
                f"schedule covers {schedule.n_rounds} rounds for a {n_rounds}-round run"
            )
        w = weights
        per_round_w = getattr(w, "ndim", 1) == 2
        scaffold = scaffold_state is not None
        has_aux = aux is not None

        prefetcher = (WindowPrefetcher(data_for, eng.device)
                      if (prefetch and data_for is not None) else None)
        self.idle_gaps = []
        self.windows_run = 0
        self._abort.clear()
        if owner is not None:
            with _ACTIVE_LOCK:
                _ACTIVE[owner] = self
        snap_every = max(0, int(snapshot_every)) if snapshot_to else 0
        # (rounds done after the window, its state's host copy), handed
        # over at the next loop top.
        snap_pending: Optional[tuple[int, HostCopy]] = None
        pending: Optional[EngineWindow] = None
        result: Optional[tuple] = None
        done = 0
        widx = 0
        cur_xs, cur_ys = xs, ys
        try:
            while done < int(n_rounds):
                if snap_pending is not None:
                    self._materialize_snapshot(snap_pending, snapshot_to)
                    snap_pending = None
                if self._abort.is_set() or (should_stop is not None and should_stop()):
                    break
                k = min(window, int(n_rounds) - done)
                if weights_for is not None:
                    w = weights_for(widx)
                    per_round_w = getattr(w, "ndim", 1) == 2
                if data_for is not None:
                    staged = (prefetcher.take(widx) if (prefetcher is not None and widx > 0)
                              else data_for(widx, done, k))
                    if staged is not None:
                        cur_xs, cur_ys = staged
                idle_probe = pending is not None and pending.ready()
                t_probe = time.monotonic()
                handle = eng.dispatch_window(
                    params, cur_xs, cur_ys,
                    weights=(w[done:done + k] if per_round_w else w),
                    epochs=epochs, n_rounds=k, aux=aux, scaffold_state=scaffold_state,
                    donate=donate,
                    schedule=None if schedule is None else schedule.window(done, k),
                )
                t_disp = time.monotonic()
                if pending is not None:
                    # The device sat idle for the preparation just measured
                    # when the previous window had already finished.
                    self.idle_gaps.append((t_disp - t_probe) if idle_probe else 0.0)
                nxt = done + k
                if prefetcher is not None and nxt < int(n_rounds):
                    prefetcher.start(widx + 1, nxt, min(window, int(n_rounds) - nxt))
                if pending is not None:
                    # Window N's host leg overlaps window N+1's device leg.
                    result = pending.finalize()
                params = handle.params
                if scaffold:
                    aux = handle.aux
                    scaffold_state = handle.scaffold_state
                elif has_aux:
                    aux = handle.aux
                pending = handle
                done += k
                widx += 1
                self.windows_run += 1
                if snap_every and widx % snap_every == 0:
                    # unpad gathers a mesh window's leaves whole (on this,
                    # the dispatching thread: every rank in the same order).
                    snap_pending = (done, start_host_copy(
                        (eng.unpad(params), None if aux is None else eng.unpad(aux),
                         (eng.unpad(scaffold_state[0]),
                          tree_map(full_tensor, scaffold_state[1])) if scaffold else None)))
        finally:
            if owner is not None:
                with _ACTIVE_LOCK:
                    if _ACTIVE.get(owner) is self:
                        del _ACTIVE[owner]
            if prefetcher is not None:
                prefetcher.close()
            if pending is not None:
                if self._abort.is_set():
                    pending.abandon()
                    result = None
                else:
                    result = pending.finalize()
        if snap_pending is not None and not self._abort.is_set():
            self._materialize_snapshot(snap_pending, snapshot_to)
        if self.idle_gaps:
            metrics.gauge("tpfl_engine_idle_gap_seconds",
                          float(sum(self.idle_gaps) / len(self.idle_gaps)),
                          labels={"driver": "pipeline"})
        return result, done
