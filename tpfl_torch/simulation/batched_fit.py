"""Batched local training — many learners' fits as one node-stacked
program, the port of :mod:`tpfl.simulation.batched_fit`.

A group of homogeneous fit jobs (equal :func:`job_signature`) is stacked
on a leading node axis and trained by the engine's masked local fit
(:func:`tpfl_torch.parallel.engine.build_masked_local_fit`): every step
runs every learner of the chunk in one launch of each op, so the CNN's
conv backward runs its kernels (``conv_dw`` / ``conv_dx``) at N = the
chunk's bucket, where inline fits run them at N = 1.

Semantics against ``TorchLearner.fit``: the same train step, optimizer,
loss, correction and callback lifecycle (``prepare_fit`` /
``finish_fit``); the one divergence is the reference's own — the batch
order is shuffled once per round, not once per epoch. Nodes with fewer
batches than the chunk's largest count are padded with masked no-op
batches, and the node axis is bucketed to a power of two with dummy rows
that replicate node 0 under an all-zero mask, so partitions of unequal
size batch together exactly.

On the card the chunk's data, masks and proximal coefficients go to the
device as one pinned host→device copy; the chunk's losses come back in
one host sync. A chunk that ``Settings.SHARD_NODES`` would spread over
the ranks of a ``torch.distributed`` world
(:func:`~tpfl_torch.parallel.engine.nodes_mesh_axes`) is refused (``ROADMAP.md`` §1
item 7): the reference shards it over one process's devices, and a
pool's chunk lives in one rank.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from tpfl_torch.management import ledger, profiling
from tpfl_torch.management.logger import logger
from tpfl_torch.management.telemetry import metrics
from tpfl_torch.learning.torch_learner import module_key
from tpfl_torch.exceptions import MULTI_DEVICE_ITEM, not_ported
from tpfl_torch.parallel.engine import build_batched_fit_program, nodes_mesh_axes
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import tree_items, tree_map

#: Host→device copies of stacked chunks since the process started (one a
#: chunk on the card).
h2d_copies = 0


def job_signature(learner: Any) -> tuple:
    """Hashable homogeneity key: jobs with equal signatures share one
    batched program. Read from the leaves' shapes and dtypes on the
    device — no host copy."""
    model = learner.get_model()
    params = model.get_parameters()
    # Sorted by path: a model decoded from the wire holds its dicts in
    # JAX's key order, a freshly built one in the zoo's.
    shapes = tuple(sorted((path, tuple(v.shape), str(v.dtype))
                          for path, v in tree_items(params)))
    aux = tuple(sorted((path, tuple(v.shape), str(v.dtype))
                       for path, v in tree_items(model.aux_state or {})))
    return (
        module_key(model.module),
        shapes,
        aux,
        str(learner.device),
        learner.batch_size,
        learner.epochs,
        learner.learning_rate,
        learner._optimizer_factory,
        learner._loss_fn,
        tuple(sorted(cb.get_name() for cb in learner.callbacks)),
    )


class _Hints:
    """Host facts of a chunk that pick the fit's eager code path and are
    no part of its program signature (the reference's jitted fit takes
    neither): whether any row pulls towards its anchor, and which
    batches every row trains."""

    def __init__(self, prox: bool, full: Optional[list]) -> None:
        self.prox, self.full = prox, full


class BatchedFitProgram:
    """The batched local fit of one job signature
    (:func:`~tpfl_torch.parallel.engine.build_batched_fit_program`), one
    fit per (batches per node, epochs) behind the compile observatory."""

    def __init__(self, learner: Any) -> None:
        self._module = learner._module()
        self._opt = learner._optimizer_factory(learner.learning_rate)
        self._loss_fn = learner._loss_fn
        self._has_aux = bool(learner.get_model().aux_state)
        # Gradient-tracking programs (SCAFFOLD: a callback wants_avg_grad)
        # also sum the raw per-step gradients; job_signature holds the
        # callback names, so tracking and plain jobs never share one.
        self._track = any(getattr(cb, "wants_avg_grad", False) for cb in learner.callbacks)
        self._fns: dict[tuple[int, int], Callable] = {}

    def run(self, params: Any, aux: Any, corr: Any, anchor: Any, mus: torch.Tensor,
            xs: torch.Tensor, ys: torch.Tensor, bmask: torch.Tensor, epochs: int,
            full: Optional[list] = None, prox: bool = True) -> tuple:
        """The chunk's fit; ``mus`` applies only when ``prox``."""
        key = (int(xs.shape[1]), int(epochs))
        fn = self._fns.get(key)
        profiling.observatory.cache_event("batched_shape_fns", hit=fn is not None)
        if fn is None:
            fit = build_batched_fit_program(self._module, self._opt, self._loss_fn,
                                            self._has_aux, self._track, int(epochs))

            def program(params: Any, aux: Any, corr: Any, anchor: Any, mus: torch.Tensor,
                        xs: torch.Tensor, ys: torch.Tensor, bmask: torch.Tensor,
                        hints: _Hints) -> tuple:
                return fit(params, aux, corr, anchor, mus if hints.prox else None, xs, ys,
                           bmask, hints.full)

            fn = self._fns[key] = profiling.observatory.wrap(
                program, f"batched_fit:{profiling.module_tag(self._module)}")
        return fn(params, aux, corr, anchor, mus, xs, ys, bmask, _Hints(prox, full))


_programs: dict[tuple, BatchedFitProgram] = {}


def clear_programs() -> None:
    """Drop the per-signature programs (``SuperLearnerPool.reset``)."""
    _programs.clear()


def _stack(trees: list) -> Any:
    return tree_map(lambda *vs: torch.stack(vs), trees[0], *trees[1:])


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _to_device(arrays: list, device: torch.device) -> list:
    """Host arrays on ``device``. On the card: packed into one pinned
    buffer (64-byte aligned slots) and copied with one non-blocking
    host→device copy, then viewed back into their dtypes and shapes."""
    global h2d_copies
    if device.type != "cuda":
        return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]
    offsets, total = [], 0
    for a in arrays:
        total = -(-total // 64) * 64
        offsets.append(total)
        total += a.nbytes
    host = torch.empty((max(total, 1),), dtype=torch.uint8, pin_memory=True)
    view = host.numpy()
    for a, off in zip(arrays, offsets):
        view[off:off + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    dev = host.to(device, non_blocking=True)
    h2d_copies += 1
    return [dev[off:off + a.nbytes].view(_torch_dtype(a.dtype)).view(a.shape)
            for a, off in zip(arrays, offsets)]


def run_batched_fits(signature: tuple, learners: list,
                     on_dispatch: Optional[Callable[[int], None]] = None) -> list:
    """Train every learner of ``learners`` (all of ``signature``) through
    one batched program per chunk of ``Settings.SIM_MAX_BATCH_NODES``.

    Mutates each learner's model through the learner's own lifecycle
    (``prepare_fit`` / ``finish_fit``). ``on_dispatch(n)`` is called for
    each chunk dispatched with its ``n`` fits. Returns the learners of
    FAILED chunks only (already-trained chunks are final: the caller must
    not fit them again). A CUDA error or a refusal is not a chunk failure:
    it propagates (:func:`must_propagate`)."""
    prog = _programs.get(signature)
    profiling.observatory.cache_event("batched_programs", hit=prog is not None)
    if prog is None:
        prog = _programs[signature] = BatchedFitProgram(learners[0])
    chunk = max(int(Settings.SIM_MAX_BATCH_NODES), 1)
    failed: list = []
    for i in range(0, len(learners), chunk):
        part = learners[i:i + chunk]
        try:
            n = _run_chunk(prog, part)
        except Exception as e:
            if must_propagate(e):
                raise
            logger.info("simulation", f"Batched chunk of {len(part)} nodes failed ({e}); "
                                      "those nodes fall back to inline fits")
            failed.extend(part)
            continue
        if n:
            metrics.counter("tpfl_sim_batched_dispatch_total")
            if on_dispatch is not None:
                on_dispatch(n)
    return failed


def is_device_error(e: BaseException) -> bool:
    """True for a CUDA error (a fault of the card or a kernel, which no
    fallback may hide)."""
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    return "CUDA" in str(e) or "cuda" in type(e).__name__.lower()


def must_propagate(e: BaseException) -> bool:
    """True for an error no fallback fit may hide: a CUDA error, or a
    plane the port refuses (``NotImplementedError`` naming its item)."""
    return is_device_error(e) or isinstance(e, NotImplementedError)


def _run_chunk(prog: BatchedFitProgram, learners: list) -> int:
    """One chunk's batched fit; returns the number of fits it ran."""
    # Interrupts delivered before dispatch get TorchLearner's skip
    # treatment (model unchanged, zero FL weight); once the chunk is
    # dispatched it runs to its end.
    active = []
    for ln in learners:
        if ln._interrupt.is_set():
            ln._interrupt.clear()
            logger.info(ln.get_addr(), "Fit skipped: interrupted before batch")
            ln.skip_fit()
        else:
            active.append(ln)
    learners = active
    if not learners:
        return 0

    epochs = learners[0].epochs
    device = learners[0].device
    jobs = []
    for ln in learners:
        model, initial, correction, mu, batches = ln.prepare_fit()
        xs, ys = batches.stacked(epoch=ln._round_counter * 10_000)
        ln._round_counter += 1
        jobs.append({"learner": ln, "model": model, "initial": initial,
                     "correction": correction, "mu": float(mu), "xs": xs, "ys": ys,
                     "num_samples": batches.num_samples})

    # Pad every node's data to the chunk's largest batch count; the mask
    # turns padding batches into exact no-ops.
    max_b = max(j["xs"].shape[0] for j in jobs)
    xs_l, ys_l, mask_l = [], [], []
    for j in jobs:
        nb = j["xs"].shape[0]
        pad = max_b - nb
        x, y = j["xs"], j["ys"]
        if pad:
            x = np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)])
            y = np.concatenate([y, np.zeros((pad, *y.shape[1:]), y.dtype)])
        xs_l.append(x)
        ys_l.append(y)
        mask_l.append(np.concatenate([np.ones(nb, np.float32), np.zeros(pad, np.float32)]))

    # Bucket the node axis to the next power of two (the reference's
    # compile-cache discipline, kept so a chunk's launch shapes repeat
    # round to round): dummy rows replicate node 0 under an all-zero
    # mask and their outputs are dropped. Rows never mix, so a batch every
    # real row trains skips the mask's select whatever the dummy rows do.
    bucket = 1
    while bucket < len(jobs):
        bucket *= 2
    for _ in range(bucket - len(jobs)):
        xs_l.append(xs_l[0])
        ys_l.append(ys_l[0])
        mask_l.append(np.zeros_like(mask_l[0]))
    rows = [j["initial"] for j in jobs] + [jobs[0]["initial"]] * (bucket - len(jobs))
    mus = np.asarray([j["mu"] for j in jobs] + [0.0] * (bucket - len(jobs)), np.float32)
    masks = np.stack(mask_l)
    full = [bool(c) for c in (masks[:len(jobs)] > 0).all(0)]
    # The reference spreads a chunk over the local devices of its one
    # process (Settings.SHARD_NODES). The port runs one rank a device, and
    # a pool's chunk lives in one process.
    if nodes_mesh_axes(bucket) is not None:
        raise not_ported("the simulation pool's fits sharded over ranks "
                         "(Settings.SHARD_NODES in a multi-rank world)", MULTI_DEVICE_ITEM)
    xs_d, ys_d, mask_d, mus_d = _to_device([np.stack(xs_l), np.stack(ys_l), masks, mus], device)

    stacked_params = _stack(rows)
    aux_rows = [tree_map(lambda v: v.to(device), j["model"].aux_state or {}) for j in jobs]
    stacked_aux = _stack(aux_rows + [aux_rows[0]] * (bucket - len(jobs)))
    corrs = [j["correction"] for j in jobs]
    stacked_corr = None
    if any(c is not None for c in corrs):
        zero = tree_map(torch.zeros_like, jobs[0]["initial"])
        filled = [zero if c is None else c for c in corrs]
        stacked_corr = _stack(filled + [zero] * (bucket - len(jobs)))

    # Round attribution: the chunk's dispatch gap and device time are
    # charged to every participating node — each node's round waited on
    # this one program for its whole length.
    prof = profiling.rounds.enabled()
    t0 = time.monotonic() if prof else 0.0
    # The pull anchors are the round-start rows themselves: the fit never
    # writes its inputs.
    new_params, new_aux, losses, gsums = prog.run(
        stacked_params, stacked_aux, stacked_corr, stacked_params, mus_d, xs_d, ys_d, mask_d,
        epochs, full, prox=bool(mus.any()))
    if prof:
        t1 = time.monotonic()
        if losses.device.type == "cuda":
            torch.cuda.synchronize(losses.device)
        t2 = time.monotonic()
        for j in jobs:
            addr = j["learner"].get_addr()
            profiling.rounds.add(addr, "dispatch", t1 - t0)
            profiling.rounds.add(addr, "train", t2 - t1)
    # The one host sync of the chunk: every finish_fit below reads the
    # losses on the host.
    losses_h = losses.cpu().numpy()

    for i, j in enumerate(jobs):
        ln, model = j["learner"], j["model"]
        n_steps = j["xs"].shape[0] * epochs
        avg_grad = None
        if gsums is not None:
            # The masked sum covers REAL batches only: divide by the
            # node's own step count, not the padded chunk's.
            inv = float(np.float32(1.0 / max(n_steps, 1)))
            avg_grad = tree_map(lambda g: g[i] * inv, gsums)
        ln.finish_fit(model, j["initial"], tree_map(lambda v: v[i], new_params),
                      tree_map(lambda v: v[i], new_aux) if model.aux_state else None,
                      n_steps, j["num_samples"], avg_grad=avg_grad)
        loss = float(losses_h[i])
        if ln._in_experiment():
            logger.log_metric(ln.get_addr(), "train_loss", loss, step=epochs - 1)
        # The fit seam's loss tap, as TorchLearner.fit's (no added sync).
        if Settings.LEDGER_ENABLED:
            ledger.convergence.observe_loss(
                ln.get_addr(), (ln._round_counter - 1) * 10_000 + epochs - 1, loss)
        logger.debug(ln.get_addr(), f"batched fit ({len(jobs)} nodes): loss={loss:.4f}")
    return len(jobs)


__all__ = ["BatchedFitProgram", "clear_programs", "is_device_error", "job_signature",
           "must_propagate",
           "run_batched_fits"]
