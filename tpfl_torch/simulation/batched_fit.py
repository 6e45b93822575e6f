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
one host sync.

**Sharded over ranks.** A chunk that ``Settings.SHARD_NODES`` spreads over
the ranks of a ``torch.distributed`` world
(:func:`~tpfl_torch.parallel.engine.nodes_mesh_axes` not None, the
reference's ``maybe_nodes_mesh``) trains as ``hosts × nodes`` equal row
shards, hosts first, as the reference's ``federation_sharding`` places
them over its devices. The port runs one rank a device and the pool in
one process, so rank 0 leads: it keeps shard 0 and sends every other
shard to the first rank of that shard's ``model`` group (shard ``s`` to
rank ``s · SHARD_MODEL``; the other ranks of a ``model`` group compute
nothing), which runs :func:`serve_pool_shards`. Rank 0 sends the
program's spec once per servant (module, optimizer factory and learning
rate, loss, ``has_aux``, ``track``), then per chunk a header (the
program, ``epochs``, the chunk's ``full`` / ``prox`` hints unchanged, the
tensors' dtypes and shapes) and one buffer of the shard's rows of
params, aux, correction, data, mask and ``mus`` (the round-start params
are the anchors, as unsharded). The ranks of a world trust each other:
headers are pickles. It trains
shard 0 meanwhile and gathers new params, aux, losses and gradient sums
back in row order; from there the chunk ends as unsharded. Each shard is
sliced on the host and packed into one buffer on
:func:`~tpfl_torch.parallel.distributed.wire_device`: the host under
``gloo`` (a servant on the card then takes its shard in one pinned
host→device copy), the card under ``nccl`` (untested: one card holds no
two nccl ranks). A sharded chunk never falls back: a failure on any rank,
or of the transport, raises :class:`ShardedChunkError` naming the rank,
after every servant's reply is drained; a dead servant fails the
exchange through the group's timeout. Rank 0 stops the servants with
:func:`stop_pool_servants` when its run is over.
"""

from __future__ import annotations

import datetime
import itertools
import pickle
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpfl_torch import DeviceLike, resolve_device
from tpfl_torch.management import ledger, profiling
from tpfl_torch.management.logger import logger
from tpfl_torch.management.telemetry import metrics
from tpfl_torch.learning.torch_learner import module_key
from tpfl_torch.parallel import distributed as spmd
from tpfl_torch.parallel.engine import (
    build_batched_fit_program,
    nodes_mesh_axes,
    shard_device_count,
)
from tpfl_torch.parallel.mesh import HOST_AXIS, MODEL_AXIS, NODE_AXIS
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import tree_items, tree_leaves, tree_map, tree_unflatten

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


def program_spec(learner: Any) -> dict:
    """What a :class:`BatchedFitProgram` is built from: the module, the
    optimizer factory and learning rate, the loss, whether the model has
    aux state, and whether a callback tracks the averaged gradient
    (SCAFFOLD's ``wants_avg_grad``; :func:`job_signature` holds the
    callback names, so tracking and plain jobs never share a program)."""
    return {"module": learner._module(), "optimizer_factory": learner._optimizer_factory,
            "learning_rate": learner.learning_rate, "loss_fn": learner._loss_fn,
            "has_aux": bool(learner.get_model().aux_state),
            "track": any(getattr(cb, "wants_avg_grad", False) for cb in learner.callbacks)}


_program_ids = itertools.count()


class BatchedFitProgram:
    """The batched local fit of one job signature
    (:func:`~tpfl_torch.parallel.engine.build_batched_fit_program`), one
    fit per (batches per node, epochs) behind the compile observatory.
    Built from a learner, or from its :func:`program_spec` (a servant)."""

    def __init__(self, learner: Any = None, spec: Optional[dict] = None) -> None:
        self.spec = program_spec(learner) if spec is None else spec
        self.uid = next(_program_ids)
        self._module = self.spec["module"]
        self._opt = self.spec["optimizer_factory"](self.spec["learning_rate"])
        self._loss_fn = self.spec["loss_fn"]
        self._has_aux = self.spec["has_aux"]
        self._track = self.spec["track"]
        self._fns: dict[tuple[int, int], Callable] = {}
        self._spec_bytes: Optional[bytes] = None

    def spec_bytes(self) -> bytes:
        """The pickled spec, for the servants; raises
        :class:`ShardedChunkError` when it does not pickle."""
        if self._spec_bytes is None:
            try:
                self._spec_bytes = pickle.dumps(self.spec)
            except Exception as e:
                raise ShardedChunkError(
                    "the batched program's spec (module, optimizer factory, loss) does not "
                    f"pickle, so no shard can leave rank 0: {type(e).__name__}: {e}") from e
        return self._spec_bytes

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


def _meta(t: torch.Tensor) -> tuple[str, tuple]:
    return str(t.dtype).removeprefix("torch."), tuple(t.shape)


def _offsets(metas: list) -> tuple[list[int], int]:
    """64-byte aligned slots of tensors of ``metas`` ((dtype, shape)) in
    one buffer, and its length."""
    offsets, total = [], 0
    for dtype, shape in metas:
        total = -(-total // 64) * 64
        offsets.append(total)
        total += int(np.prod(shape, dtype=np.int64)) * getattr(torch, dtype).itemsize
    return offsets, total


def _pack(tensors: list, device: Any, pin: bool = False) -> torch.Tensor:
    """``tensors`` (any devices) as one uint8 buffer on ``device``, in the
    slots of :func:`_offsets`."""
    offsets, total = _offsets([_meta(t) for t in tensors])
    buf = torch.empty((max(total, 1),), dtype=torch.uint8, device=device, pin_memory=pin)
    for t, off in zip(tensors, offsets):
        n = t.numel() * t.element_size()
        if n:
            buf[off:off + n].copy_(t.detach().contiguous().reshape(-1).view(torch.uint8))
    return buf


def _unpack(buf: torch.Tensor, metas: list) -> list:
    """Views of ``buf`` in the dtypes and shapes of ``metas``."""
    offsets, _ = _offsets(metas)
    out = []
    for (dtype, shape), off in zip(metas, offsets):
        dt = getattr(torch, dtype)
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        out.append(buf[off:off + n].view(dt).view(shape))
    return out


def _pinned_to(buf: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host buffer on ``device`` in one non-blocking copy (counted)."""
    global h2d_copies
    if device.type != "cuda" or buf.device.type == "cuda":
        return buf
    h2d_copies += 1
    return buf.to(device, non_blocking=True)


def _to_device(arrays: list, device: torch.device) -> list:
    """Host arrays on ``device``. On the card: packed into one pinned
    buffer (64-byte aligned slots) and copied with one non-blocking
    host→device copy, then viewed back into their dtypes and shapes."""
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if device.type != "cuda":
        return [t.to(device) for t in tensors]
    return _unpack(_pinned_to(_pack(tensors, "cpu", pin=True), device),
                   [_meta(t) for t in tensors])


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


class ShardedChunkError(RuntimeError):
    """A chunk sharded over ranks failed: on rank ``rank`` (its fit, or
    the transport to or from it), or before any shard left rank 0
    (``rank`` None). Never hidden by a fallback fit."""

    def __init__(self, message: str, rank: Optional[int] = None) -> None:
        super().__init__(message if rank is None else f"pool shard on rank {rank}: {message}")
        self.rank = rank


def must_propagate(e: BaseException) -> bool:
    """True for an error no fallback fit may hide: a CUDA error, a plane
    the port refuses (``NotImplementedError`` naming its item), a
    ``torch.distributed`` error, or a sharded chunk's failure."""
    return (is_device_error(e) or isinstance(e, (NotImplementedError, ShardedChunkError))
            or isinstance(e, getattr(dist, "DistError", ())))


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
    host = [np.stack(xs_l), np.stack(ys_l), masks, mus]

    aux_rows = [tree_map(lambda v: v.to(device), j["model"].aux_state or {}) for j in jobs]
    aux_rows += [aux_rows[0]] * (bucket - len(jobs))
    corrs = [j["correction"] for j in jobs]
    corr_rows = None
    if any(c is not None for c in corrs):
        zero = tree_map(torch.zeros_like, jobs[0]["initial"])
        corr_rows = [zero if c is None else c for c in corrs] + [zero] * (bucket - len(jobs))

    # Round attribution: the chunk's dispatch gap and device time are
    # charged to every participating node — each node's round waited on
    # this one program for its whole length.
    prof = profiling.rounds.enabled()
    t0 = time.monotonic() if prof else 0.0
    axes = nodes_mesh_axes(bucket)
    if axes is None:
        xs_d, ys_d, mask_d, mus_d = _to_device(host, device)
        stacked_params = _stack(rows)
        # The pull anchors are the round-start rows themselves: the fit
        # never writes its inputs.
        new_params, new_aux, losses, gsums = prog.run(
            stacked_params, _stack(aux_rows), None if corr_rows is None else _stack(corr_rows),
            stacked_params, mus_d, xs_d, ys_d, mask_d, epochs, full, prox=bool(mus.any()))
    else:
        new_params, new_aux, losses, gsums = _run_sharded(
            prog, _shard_ranks(axes), rows, aux_rows, corr_rows, host, epochs, full,
            bool(mus.any()), device)
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


# --- the chunk sharded over ranks (Settings.SHARD_NODES) ----------------------

#: How long a servant waits for rank 0's next chunk or stop: the pool may
#: sit idle between rounds far longer than a collective's timeout.
SERVANT_IDLE_TIMEOUT = datetime.timedelta(days=7)

# Rank 0's record of its servants in the current world: the programs
# whose spec each holds, and whether they were stopped. The exchange
# lock keeps a stop out of a chunk in flight.
_servants: dict[str, Any] = {"world": None, "specs": set(), "stopped": False}
_exchange_lock = threading.Lock()


def _servant_state() -> dict:
    world = dist.group.WORLD
    if _servants["world"] is not world:
        _servants.update(world=world, specs=set(), stopped=False)
    return _servants


def _shard_ranks(axes: dict) -> list[int]:
    """The rank that trains each row shard of a chunk on a mesh of
    ``axes``, in row order: the ``hosts × nodes`` shards hosts first (the
    reference's ``federation_sharding``), each trained by the first rank
    of its ``model`` group (the mesh holds the world's first ranks in row
    order, so shard ``s`` is rank ``s · model``)."""
    model = axes.get(MODEL_AXIS, 1)
    return [s * model for s in range(axes.get(HOST_AXIS, 1) * axes[NODE_AXIS])]


def _shard_payload(trees: tuple, data: list) -> tuple[list, list, tuple]:
    """A shard's tensors in wire order (the trees' leaves, then the data),
    their (dtype, shape) and the trees' skeletons."""
    tensors = [leaf for tree in trees if tree is not None for leaf in tree_leaves(tree)]
    tensors += data
    skeletons = tuple(None if t is None else tree_map(lambda _v: None, t) for t in trees)
    return tensors, [_meta(t) for t in tensors], skeletons


def _from_payload(views: list, skeletons: tuple) -> list:
    """The trees of :func:`_shard_payload` over ``views``, then the rest."""
    out, it = [], iter(views)
    for sk in skeletons:
        out.append(None if sk is None else tree_unflatten(sk, [next(it) for _ in tree_leaves(sk)]))
    return out + list(it)


def _run_sharded(prog: BatchedFitProgram, ranks: list, rows: list, aux_rows: list,
                 corr_rows: Optional[list], host: list, epochs: int, full: list, prox: bool,
                 device: torch.device) -> tuple:
    """Rank 0's part of a sharded chunk: shard ``s`` (rows ``s·k`` to
    ``(s+1)·k``) to ``ranks[s]``, shard 0 here, the results back in row
    order as ``prog.run`` gives them."""
    with _exchange_lock:
        state = _servant_state()
        if state["stopped"]:
            raise ShardedChunkError("the pool's servants were stopped (SuperLearnerPool.reset)")
        spec = prog.spec_bytes()
        wire = spmd.wire_device()
        k = len(rows) // len(ranks)
        data = [torch.from_numpy(np.ascontiguousarray(a)) for a in host]

        def shard(s: int) -> tuple:
            lo, hi = s * k, (s + 1) * k
            corr = None if corr_rows is None else _stack(corr_rows[lo:hi])
            return (_stack(rows[lo:hi]), _stack(aux_rows[lo:hi]), corr), [a[lo:hi] for a in data]

        # rank -> (what failed, the exception behind it on this rank)
        failures: dict[int, tuple[str, Optional[BaseException]]] = {}
        for s, r in enumerate(ranks[1:], 1):
            trees, shard_data = shard(s)
            tensors, metas, skeletons = _shard_payload(trees, shard_data)
            header = {"op": "chunk", "program": prog.uid,
                      "spec": None if (r, prog.uid) in state["specs"] else spec,
                      "epochs": int(epochs), "full": full, "prox": prox, "metas": metas,
                      "skeletons": skeletons}
            try:
                spmd.send_bytes(pickle.dumps(header), r)
                dist.send(_pack(tensors, wire), r)
                state["specs"].add((r, prog.uid))
            except Exception as e:
                failures[r] = (f"{type(e).__name__}: {e}", e)
        own: Optional[tuple] = None
        try:
            (params, aux, corr), shard_data = shard(0)
            xs, ys, mask, mus = _to_device([a.numpy() for a in shard_data], device)
            own = prog.run(params, aux, corr, params, mus, xs, ys, mask, epochs, full, prox)
        except Exception as e:
            failures[ranks[0]] = (f"{type(e).__name__}: {e}", e)
        outs = [own]
        for r in ranks[1:]:
            if r in failures:
                continue
            try:
                reply = pickle.loads(spmd.recv_bytes(r))
                if "error" in reply:
                    failures[r] = (reply["error"], None)
                    state["specs"].discard((r, prog.uid))  # the next chunk sends it again
                    continue
                _, total = _offsets(reply["metas"])
                buf = torch.empty((max(total, 1),), dtype=torch.uint8, device=wire,
                                  pin_memory=wire.type == "cpu" and device.type == "cuda")
                dist.recv(buf, r)
                params, aux, gsums, losses = _from_payload(
                    _unpack(_pinned_to(buf, device), reply["metas"]), reply["skeletons"])
                outs.append((params, aux, losses, gsums))
            except Exception as e:
                failures[r] = (f"{type(e).__name__}: {e}", e)
        if failures:
            r = min(failures)
            raise ShardedChunkError(failures[r][0], rank=r) from failures[r][1]

    def cat(i: int) -> Any:
        if outs[0][i] is None:
            return None
        return tree_map(lambda *vs: torch.cat(vs), outs[0][i], *(o[i] for o in outs[1:]))

    return cat(0), cat(1), torch.cat([o[2] for o in outs]), cat(3)


def _serve_chunk(header: dict, buf: torch.Tensor, programs: dict,
                 device: torch.device) -> tuple[list, dict]:
    """A servant's shard: the program (built from the header's spec when
    it carries one), its fit, and the reply's tensors and header."""
    if header["spec"] is not None:
        programs[header["program"]] = BatchedFitProgram(spec=pickle.loads(header["spec"]))
    prog = programs[header["program"]]
    params, aux, corr, xs, ys, mask, mus = _from_payload(
        _unpack(_pinned_to(buf, device), header["metas"]), header["skeletons"])
    new_params, new_aux, losses, gsums = prog.run(
        params, aux, corr, params, mus, xs, ys, mask, header["epochs"], header["full"],
        header["prox"])
    tensors, metas, skeletons = _shard_payload((new_params, new_aux, gsums), [losses])
    return tensors, {"metas": metas, "skeletons": skeletons}


def serve_pool_shards(device: DeviceLike = None) -> int:
    """Train the pool's sharded chunks that rank 0 sends this rank, until
    rank 0's stop (:func:`stop_pool_servants`); returns the chunks
    served. Every rank of the shard mesh other than 0 runs it while rank
    0 runs the simulation. ``device=None`` is the card. A shard's failure
    goes back to rank 0, which raises it naming this rank, and the loop
    serves on; a lost rank 0 ends it with the transport's error."""
    dev = resolve_device(device)
    if not spmd.is_multiprocess() or dist.get_rank() == 0:
        raise ValueError("serve_pool_shards runs on a rank other than 0 of a "
                         "torch.distributed world")
    wire = spmd.wire_device()
    programs: dict[int, BatchedFitProgram] = {}
    served = 0
    while True:
        header = pickle.loads(spmd.recv_bytes(0, timeout=SERVANT_IDLE_TIMEOUT))
        if header["op"] == "stop":
            return served
        served += 1
        _, total = _offsets(header["metas"])
        buf = torch.empty((max(total, 1),), dtype=torch.uint8, device=wire,
                          pin_memory=wire.type == "cpu" and dev.type == "cuda")
        dist.recv(buf, 0)
        try:
            tensors, reply = _serve_chunk(header, buf, programs, dev)
        except Exception as e:
            logger.info("simulation", f"pool shard failed on rank {dist.get_rank()}: {e}")
            spmd.send_bytes(pickle.dumps({"error": f"{type(e).__name__}: {e}"}), 0)
            continue
        spmd.send_bytes(pickle.dumps(reply), 0)
        dist.send(_pack(tensors, wire), 0)


def stop_pool_servants() -> int:
    """Rank 0 of a world that ``Settings.SHARD_NODES`` shards: send the
    stop to the other ranks of the shard mesh, once per world; returns how
    many were sent the stop (0 anywhere else). A chunk in flight ends
    first."""
    if not (Settings.SHARD_NODES and spmd.is_multiprocess() and dist.get_rank() == 0):
        return 0
    n = shard_device_count()
    with _exchange_lock:
        state = _servant_state()
        if n <= 1 or state["stopped"]:
            return 0
        state["stopped"] = True
        for r in range(1, n):
            try:
                spmd.send_bytes(pickle.dumps({"op": "stop"}), r)
            except Exception as e:  # a lost servant has nothing to stop
                logger.info("simulation", f"stop for the pool servant on rank {r} failed: {e}")
    return n - 1


__all__ = ["BatchedFitProgram", "ShardedChunkError", "clear_programs", "is_device_error",
           "job_signature", "must_propagate", "program_spec", "run_batched_fits",
           "serve_pool_shards", "stop_pool_servants"]
