"""SuperLearnerPool — the shared fit-batching executor, the port of
:mod:`tpfl.simulation.pool`.

A dispatcher thread collects concurrent fit submissions for a short
window (``Settings.SIM_BATCH_WINDOW``, or until a hinted group is full,
``SIM_BATCH_MAX_WAIT``), groups them by homogeneity signature, and runs
each group as one batched program (:mod:`tpfl_torch.simulation.batched_fit`).
Jobs that cannot batch (a unique signature, a learner that is not a
``TorchLearner``) run on a thread pool of ``Settings.SIM_WORKERS``
threads, and so do the jobs of a batched chunk that failed — their
``TorchLearner.fit`` runs on the same device through the same kernels.
A CUDA error is never such a failure: it reaches the fitting node.

The pool counts what it does: :attr:`SuperLearnerPool.batched_dispatches`
(chunks dispatched), :attr:`~SuperLearnerPool.batched_fits`,
:attr:`~SuperLearnerPool.singles` (jobs that could not batch) and
:attr:`~SuperLearnerPool.fallbacks` (jobs of failed batched paths), with
the metrics registry's ``tpfl_sim_batched_dispatch_total`` and
``tpfl_sim_fallback_total``.

A chunk that ``Settings.SHARD_NODES`` spreads over the ranks of a
``torch.distributed`` world runs with this process as rank 0, the leader:
the other ranks call :func:`~tpfl_torch.simulation.batched_fit.serve_pool_shards`
and train their row shards (:mod:`~tpfl_torch.simulation.batched_fit`)
until rank 0 calls :func:`~tpfl_torch.simulation.batched_fit.stop_pool_servants`.
The dispatcher and the counters are the same; a sharded chunk's failure
reaches the fitting nodes and is no fallback.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

from tpfl_torch.learning.learner import Learner
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.learning.torch_learner import TorchLearner, clear_compiled_caches
from tpfl_torch.management.logger import logger
from tpfl_torch.management.telemetry import metrics
from tpfl_torch.settings import Settings
from tpfl_torch.simulation.batched_fit import job_signature, must_propagate, run_batched_fits


class _FitJob:
    __slots__ = ("learner", "done", "error", "group_hint")

    def __init__(self, learner: Learner, group_hint: int = 0) -> None:
        self.learner = learner
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.group_hint = group_hint


class SuperLearnerPool:
    """Process-wide singleton batching executor (the reference's
    ``SuperActorPool`` singleton semantics)."""

    _instance: Optional["SuperLearnerPool"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._queue: list[_FitJob] = []
        self._queue_lock = threading.Condition()
        self._dispatcher: Optional[threading.Thread] = None
        self._stop = False
        workers = int(Settings.SIM_WORKERS) or (os.cpu_count() or 4)
        self._fallback = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="tpfl-sim")
        self._stats_lock = threading.Lock()
        #: Batched chunks dispatched, and the fits they ran.
        self.batched_dispatches = 0
        self.batched_fits = 0
        #: Each dispatched chunk's number of fits, in order.
        self.group_sizes: list[int] = []
        #: Jobs that could not batch (alone in their signature, or not a
        #: TorchLearner) and ran on their own.
        self.singles = 0
        #: Jobs of a failed batched path that fell back to their own fit.
        self.fallbacks = 0

    @classmethod
    def instance(cls) -> "SuperLearnerPool":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = SuperLearnerPool()
            return cls._instance

    @classmethod
    def reset(cls, clear_compiled: bool = True) -> None:
        """Tear down the singleton (tests / reconfiguration).
        ``clear_compiled`` also drops the process program caches
        (``torch_learner.clear_compiled_caches``)."""
        with cls._instance_lock:
            inst, cls._instance = cls._instance, None
        if inst is not None:
            with inst._queue_lock:
                inst._stop = True
                inst._queue_lock.notify_all()
            if inst._dispatcher is not None:
                inst._dispatcher.join(timeout=5)
            inst._fallback.shutdown(wait=False)
        if clear_compiled:
            clear_compiled_caches()

    # --- submission (each node's learning thread) ---

    def submit_fit(self, learner: Learner, group_hint: int = 0) -> TpflModel:
        """Block until the pool has trained ``learner``; returns the model
        its fit produced. ``group_hint`` is the number of concurrent fits
        expected (the round's local train set): the dispatcher holds the
        batch until that many arrived or ``SIM_BATCH_MAX_WAIT`` elapsed."""
        job = _FitJob(learner, group_hint=group_hint)
        # Submission is fit entry: drop a stale interrupt (the inline fit
        # clears on entry; the batched path honours interrupts set later).
        reset = getattr(learner, "reset_interrupt", None)
        if reset is not None:
            reset()
        with self._queue_lock:
            if self._stop:
                raise RuntimeError("SuperLearnerPool is shut down")
            self._queue.append(job)
            if self._dispatcher is None or not self._dispatcher.is_alive():
                self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                                    name="tpfl-sim-dispatcher", daemon=True)
                self._dispatcher.start()
            self._queue_lock.notify_all()
        job.done.wait()
        if job.error is not None:
            raise job.error
        # The model finish_fit produced — not learner.get_model(), which a
        # concurrent full-model delivery may have rebound to the aggregate.
        fitted = learner._last_fit_model
        return fitted if fitted is not None else learner.get_model()

    # --- dispatcher ---

    def _dispatch_loop(self) -> None:
        from tpfl_torch.simulation.virtual_learner import VirtualNodeLearner

        while True:
            with self._queue_lock:
                while not self._queue and not self._stop:
                    self._queue_lock.wait(timeout=1.0)
                if self._stop:
                    for j in self._queue:
                        j.error = RuntimeError("pool shut down")
                        j.done.set()
                    self._queue.clear()
                    return
            # Batching window: let the rest of the train set arrive. With
            # hints, hold until the group is full or SIM_BATCH_MAX_WAIT —
            # capped by the in-process learners, so a process never waits
            # for peers that live elsewhere.
            deadline = time.monotonic() + float(Settings.SIM_BATCH_MAX_WAIT)
            window_end = time.monotonic() + float(Settings.SIM_BATCH_WINDOW)
            while True:
                with self._queue_lock:
                    jobs = list(self._queue)
                hints = [j.group_hint for j in jobs if j.group_hint > 0]
                target = (min(max(hints), max(VirtualNodeLearner.live_count(), 1))
                          if hints else 0)
                now = time.monotonic()
                if hints and (len(jobs) >= target or now >= deadline):
                    break
                if not hints and now >= window_end:
                    break
                time.sleep(0.02)
            with self._queue_lock:
                batch, self._queue = self._queue, []
            try:
                self._run_batch(batch)
            except BaseException as e:  # the dispatcher must survive anything
                for j in batch:
                    if not j.done.is_set():
                        j.error = e
                        j.done.set()

    def _count(self, attr: str, n: int = 1) -> None:
        with self._stats_lock:
            setattr(self, attr, getattr(self, attr) + n)

    def _dispatched(self, n: int) -> None:
        with self._stats_lock:
            self.batched_dispatches += 1
            self.batched_fits += n
            self.group_sizes.append(n)

    def _fall_back(self, jobs: list, singles: list, why: str) -> None:
        logger.info("simulation", f"{why}; {len(jobs)} nodes fall back to their own fits")
        self._count("fallbacks", len(jobs))
        metrics.counter("tpfl_sim_fallback_total", float(len(jobs)))
        singles.extend(jobs)

    def _run_batch(self, batch: list[_FitJob]) -> None:
        groups: dict[Any, list[_FitJob]] = {}
        singles: list[_FitJob] = []
        for job in batch:
            if isinstance(job.learner, TorchLearner):
                try:
                    groups.setdefault(job_signature(job.learner), []).append(job)
                    continue
                except Exception:
                    pass
            singles.append(job)
        for jobs in groups.values():
            if len(jobs) == 1:
                singles.append(jobs[0])
        self._count("singles", len(singles))
        for sig, jobs in groups.items():
            if len(jobs) == 1:
                continue
            try:
                failed = run_batched_fits(sig, [j.learner for j in jobs], self._dispatched)
            except Exception as e:
                if must_propagate(e):
                    for j in jobs:
                        j.error = e
                        j.done.set()
                    continue
                # Signature-level failure (nothing trained): everyone
                # falls back. Chunk failures come back as ``failed``:
                # re-fitting a trained chunk would double its epochs.
                self._fall_back(jobs, singles, f"Batched fit of {len(jobs)} nodes failed ({e})")
                continue
            failed_ids = {id(ln) for ln in failed}
            if failed_ids:
                self._fall_back([j for j in jobs if id(j.learner) in failed_ids], singles,
                                "A batched chunk failed")
            for j in jobs:
                if id(j.learner) not in failed_ids:
                    j.done.set()

        def run_single(learner: Learner) -> Any:
            if Settings.SIM_PROCESS_ISOLATION:
                from tpfl_torch.simulation import isolated

                payload = isolated.extract_job(learner)
                if payload is not None:
                    return isolated.isolated_fit(learner, payload)
                logger.debug("simulation", "fit outside isolation scope; running in-process")
            return learner.fit()

        futures = [(j, self._fallback.submit(run_single, j.learner)) for j in singles]
        for j, fut in futures:
            try:
                fut.result()
            except BaseException as e:
                j.error = e
            j.done.set()


__all__ = ["SuperLearnerPool"]
