"""Opt-in process isolation for the simulation pool's unbatched fits, the
port of :mod:`tpfl.simulation.isolated`.

With ``Settings.SIM_PROCESS_ISOLATION`` the pool runs each fit that does
not batch in a spawned worker process, so a crashing fit (a native
crash) kills one worker, not every node of the process. Workers share
one pool, and CPython marks the whole pool broken when any worker dies:
:func:`isolated_fit` rebuilds the pool and retries each affected job
once (retries serialized), so the job that crashed its worker fails
both attempts while a concurrent innocent completes on the rebuilt pool.

Scope: plain ``TorchLearner`` fits — no aggregator callbacks (SCAFFOLD /
FedProx state lives in the parent), no aux state, the default optimizer
and loss, a picklable module. The child rebuilds a ``TorchLearner`` on
the learner's own device from the shipped params and the parent's
exported batches (same export seed, same round counter), so its fit is
the inline fit. A child asked for ``cuda`` without a card raises; it
never moves to the CPU.
"""

from __future__ import annotations

import pickle
import threading
from typing import Any, Optional

import numpy as np

from tpfl_torch.management.logger import logger
from tpfl_torch.settings import Settings

_executor = None
_executor_lock = threading.Lock()
# Serializes retries after a pool break: a crashing job's retry can then
# only break a pool it holds alone.
_retry_lock = threading.Lock()


def _get_executor():
    """The spawn-context ProcessPoolExecutor, built on first use and
    again after a crash."""
    global _executor
    with _executor_lock:
        if _executor is None:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            workers = int(Settings.SIM_WORKERS) or 4
            _executor = ProcessPoolExecutor(max_workers=workers,
                                            mp_context=mp.get_context("spawn"))
        return _executor


def _discard_executor(only: Any = None) -> None:
    """Tear down the current executor; with ``only``, only if it still is
    the current one (a late failure handler must not shut down the fresh
    pool other jobs retry on)."""
    global _executor
    with _executor_lock:
        if only is not None and _executor is not only:
            ex = None
        else:
            ex, _executor = _executor, None
    if ex is not None:
        ex.shutdown(wait=False, cancel_futures=True)


def shutdown() -> None:
    """Tear down the worker pool (tests / reconfiguration)."""
    _discard_executor()


def _child_fit(payload: bytes) -> bytes:
    """Worker entry: rebuild a TorchLearner and run the real fit. Returns
    the fitted model's dense v3 payload (never a pickle back into the
    parent)."""
    job = pickle.loads(payload)
    if job.get("_test_crash"):  # test hook: a native crash
        import os

        os._exit(42)

    from tpfl_torch.learning.dataset.export import Batches
    from tpfl_torch.learning.dataset.tpfl_dataset import TpflDataset
    from tpfl_torch.learning.model import TpflModel
    from tpfl_torch.learning.torch_learner import TorchLearner

    device = job["device"]  # resolve_device raises for cuda without a card
    model = TpflModel(module=pickle.loads(job["module"]), device=device)
    model.set_parameters(job["params"])
    x, y = job["x"], job["y"]
    learner = TorchLearner(model, TpflDataset.from_arrays(x, y, x[:1], y[:1]), addr=job["addr"],
                           learning_rate=job["learning_rate"], batch_size=job["batch_size"],
                           device=device)
    # The parent's exported batches verbatim (same export seed, same round
    # counter): the per-epoch shuffles are the inline fit's.
    learner._train_batches = Batches(x, y, job["batch_size"], seed=job["export_seed"])
    learner._round_counter = job["round_counter"]
    learner.set_epochs(job["epochs"])
    fitted = learner.fit()
    # Dense: a same-host process hand-off, not the gossip wire.
    return fitted.encode_parameters(codec="dense")


def extract_job(learner: Any) -> Optional[bytes]:
    """A child-process payload of ``learner``'s fit, or None when the job
    is outside the isolation scope: callbacks, aux state, a custom
    optimizer or loss, or a module that does not pickle."""
    from tpfl_torch.learning.torch_learner import (
        TorchLearner,
        _addr_seed,
        cross_entropy_loss,
        default_optimizer,
    )

    if not isinstance(learner, TorchLearner):
        return None
    if learner.callbacks:
        return None
    if learner._optimizer_factory is not default_optimizer:
        return None
    if learner._loss_fn is not cross_entropy_loss:
        return None
    model = learner.get_model()
    if model.aux_state:
        return None
    try:
        module_bytes = pickle.dumps(model.module)
        params = model.encode_parameters(codec="dense")
    except Exception:
        return None
    batches = learner._train_data((Settings.SEED or 0) + _addr_seed(learner.get_addr()))
    return pickle.dumps({
        "module": module_bytes,
        "params": params,
        "device": str(learner.device),
        "x": np.asarray(batches.x),
        "y": np.asarray(batches.y),
        "export_seed": batches.seed,
        "addr": learner.get_addr(),
        "learning_rate": learner.learning_rate,
        "batch_size": learner.batch_size,
        "epochs": learner.epochs,
        "round_counter": learner._round_counter,
    })


def isolated_fit(learner: Any, payload: Optional[bytes] = None) -> Any:
    """Run one fit in a worker process and apply the result to
    ``learner``. A pool broken by a worker's death is rebuilt and the job
    retried once; a job whose payload kills its worker both times raises
    ``RuntimeError``."""
    from concurrent.futures.process import BrokenProcessPool

    if payload is None:
        payload = extract_job(learner)
    if payload is None:
        raise ValueError("learner is outside the isolation scope")
    ex = _get_executor()
    try:
        result = ex.submit(_child_fit, payload).result()
    except BrokenProcessPool:
        _discard_executor(only=ex)
        with _retry_lock:
            ex2 = _get_executor()
            try:
                result = ex2.submit(_child_fit, payload).result()
            except BrokenProcessPool as e:
                _discard_executor(only=ex2)
                raise RuntimeError(f"isolated fit worker died (both attempts): {e}") from e
    # build_copy(params=bytes) restores the child's contributors and
    # sample count from the payload.
    fitted = learner.get_model().build_copy(params=result)
    learner.set_model(fitted)
    learner._round_counter += 1
    learner._last_fit_model = fitted
    logger.debug(learner.get_addr(), "isolated fit complete")
    return fitted


__all__ = ["extract_job", "isolated_fit", "shutdown"]
