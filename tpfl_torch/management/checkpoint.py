"""Checkpoint / resume — the port of :mod:`tpfl.management.checkpoint`.

Two tiers:

- :func:`save_node_checkpoint` / :func:`load_node_checkpoint` — one
  node's durable state (model params, aux, contributors and info, round
  metadata) in the v1 wire format of
  :mod:`tpfl_torch.learning.serialization`, byte-equal to the JAX
  package's, so a checkpoint written by either package loads in the
  other. A restarted node loads the model and rejoins; gossip catches it
  up.
- :class:`EngineCheckpointer` / :func:`install_sigterm_checkpoint` —
  the engine's run state from ``FederationEngine.export_state`` (the
  unpadded rows, the schedule position, controller, membership and
  quarantine state, the seed) as flax msgpack bytes
  (:func:`tpfl_torch.learning._msgpack.packb_ext`, byte-equal to
  ``flax.serialization.msgpack_serialize``); the SIGTERM hook turns a
  preemption into a resumable event. With ``Settings.STATE_CONTRACTS``
  a save re-reads its own bytes before publishing them.

Every save writes a fresh ``ckpt_*`` subdir and publishes it with one
``os.replace`` of the ``LATEST`` pointer: a crash at any point leaves the
previous complete checkpoint readable.

:class:`SliceCheckpointer` (the reference's orbax checkpointer of
mesh-sharded trees) saves a tree of placed tensors — the engine's
node-sharded state, ``ShardedTrainer``'s FSDP params and optimizer state
— through ``torch.distributed.checkpoint``: every rank writes its own
shards, and a restore onto another mesh (or none) reshards from them.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import signal
import time
import uuid
from typing import Any, Optional

from tpfl_torch.learning import _msgpack, serialization
from tpfl_torch.learning.model import place
from tpfl_torch.settings import Settings

_MODEL_FILE = "model.tpfl"
_AUX_FILE = "aux.tpfl"
_META_FILE = "meta.json"
_ENGINE_FILE = "engine.tpfl"
_LATEST = "LATEST"


def _new_subdir(directory: str) -> tuple[str, str]:
    sub = f"ckpt_{uuid.uuid4().hex[:8]}"
    path = os.path.join(directory, sub)
    os.makedirs(path)
    return sub, path


def save_node_checkpoint(directory: str, model: Any, round: Optional[int] = None,
                         exp_name: Optional[str] = None,
                         extra: Optional[dict[str, Any]] = None) -> None:
    """Persist a node's model + round metadata into ``directory``, atomic
    as a unit (subdir, then the ``LATEST`` pointer). The params are
    encoded as they are, without ``Settings.WIRE_DTYPE``'s downcast:
    a checkpoint is storage, not wire traffic."""
    os.makedirs(directory, exist_ok=True)
    sub, path = _new_subdir(directory)
    with open(os.path.join(path, _MODEL_FILE), "wb") as f:
        f.write(serialization.encode_model_payload(
            model.get_parameters(), model._contributors, model.get_num_samples(),
            model.get_info()))
    if model.aux_state:
        with open(os.path.join(path, _AUX_FILE), "wb") as f:
            f.write(serialization.encode_model_payload(model.aux_state, [], 0, {}))
    meta = {"round": round, "exp_name": exp_name, **(extra or {})}
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f)
    _publish(directory, sub)


def _publish(directory: str, sub: str) -> None:
    """Point ``LATEST`` at ``sub`` with one ``os.replace`` (the
    publication event: ``sub`` is complete by then) and retire the rest."""
    pointer_tmp = os.path.join(directory, _LATEST + ".tmp")
    old = _read_latest(directory)
    with open(pointer_tmp, "w") as f:
        f.write(sub)
    os.replace(pointer_tmp, os.path.join(directory, _LATEST))
    if old and old != sub:
        # The sweep's grace window starts at supersession, not creation.
        try:
            os.utime(os.path.join(directory, old))
        except OSError:
            pass
    _sweep_unpublished(directory, keep=sub)


def _sweep_unpublished(directory: str, keep: str, grace_seconds: float = 60.0) -> None:
    """Prune ``ckpt_*`` dirs other than the published one — superseded
    checkpoints and orphans of a crash mid-save — once they are older
    than ``grace_seconds`` (a reader that resolved ``LATEST`` just before
    a publish keeps its dir)."""
    now = time.time()
    published = _read_latest(directory)
    for name in os.listdir(directory):
        if not name.startswith("ckpt_") or name in (keep, published):
            continue
        path = os.path.join(directory, name)
        try:
            if now - os.path.getmtime(path) > grace_seconds:
                shutil.rmtree(path, ignore_errors=True)
        except OSError:
            pass


def _read_latest(directory: str) -> Optional[str]:
    try:
        with open(os.path.join(directory, _LATEST)) as f:
            return f.read().strip()
    except FileNotFoundError:
        return None


def load_node_checkpoint(directory: str, template: Any) -> tuple[Any, dict[str, Any]]:
    """Restore ``(model, meta)`` saved by :func:`save_node_checkpoint`
    (by either package): ``template`` supplies the architecture; the
    checkpointed params and info are loaded into a copy."""
    sub = _read_latest(directory)
    if sub is None:
        raise FileNotFoundError(f"No checkpoint published in {directory}")
    path = os.path.join(directory, sub)
    with open(os.path.join(path, _MODEL_FILE), "rb") as f:
        model = template.build_copy(params=f.read())
    aux_path = os.path.join(path, _AUX_FILE)
    if os.path.exists(aux_path):
        with open(aux_path, "rb") as f:
            aux, _, _, _ = serialization.decode_model_payload(f.read())
        model.aux_state = place(aux, model.device)
    else:
        model.aux_state = None
    with open(os.path.join(path, _META_FILE)) as f:
        meta = json.load(f)
    return model, meta


class StateContractError(RuntimeError):
    """A saved engine snapshot failed its own re-read: a key the export
    wrote did not survive the serialize → restore round trip, or changed
    bytes doing so. Names the first offending field
    (``Settings.STATE_CONTRACTS``)."""


def _shadow_verify(state: dict[str, Any], payload: bytes) -> None:
    """Re-read ``payload`` and compare it key by key with ``state``: a
    field whose value does not survive msgpack (a dropped key, a coerced
    leaf, dtype drift) raises :class:`StateContractError` naming it."""
    shadow = _msgpack.unpackb_ext(payload)
    missing = sorted(set(state) - set(shadow))
    extra = sorted(set(shadow) - set(state))
    if missing or extra:
        field = (missing or extra)[0]
        raise StateContractError(
            f"engine snapshot key {field!r} "
            + ("was exported but did not survive the serialize/restore round-trip"
               if missing else "appeared in the restored snapshot without being exported")
            + f" (missing={missing}, extra={extra}) — the resume would silently diverge "
            "from the saved run")
    for key in sorted(state):
        a = hashlib.sha256(_msgpack.packb_ext({key: state[key]})).hexdigest()
        b = hashlib.sha256(_msgpack.packb_ext({key: shadow[key]})).hexdigest()
        if a != b:
            raise StateContractError(
                f"engine snapshot key {key!r} changed bytes across the serialize/restore "
                f"round-trip (exported digest {a[:16]}, shadow digest {b[:16]}) — the "
                "resume would silently diverge from the saved run")


class EngineCheckpointer:
    """Durable engine-state checkpoints: the host state dict of
    ``FederationEngine.export_state`` as one flax msgpack blob, published
    like :func:`save_node_checkpoint`. The payload holds no device or
    padding, so :meth:`restore`'s dict imports into any engine of the
    model (``FederationEngine.import_state``), the JAX package's
    included, and a JAX-written checkpoint restores here."""

    def __init__(self, directory: str, node: str = "engine") -> None:
        self._dir = os.path.abspath(directory)
        self.node = node
        os.makedirs(self._dir, exist_ok=True)

    def save(self, state: dict[str, Any], step: int,
             extra: Optional[dict[str, Any]] = None) -> str:
        """Write ``state`` as checkpoint ``step``; returns the subdir
        name. Serializes on the caller's thread."""
        sub, path = _new_subdir(self._dir)
        payload = _msgpack.packb_ext(state)
        with open(os.path.join(path, _ENGINE_FILE), "wb") as f:
            f.write(payload)
        meta = {"step": int(step), "node": self.node, **(extra or {})}
        with open(os.path.join(path, _META_FILE), "w") as f:
            json.dump(meta, f)
        if Settings.STATE_CONTRACTS:
            # Before publication: a snapshot that cannot restore faithfully
            # never becomes LATEST (its subdir is swept like an orphan).
            _shadow_verify(state, payload)
        _publish(self._dir, sub)
        return sub

    def restore(self) -> Optional[tuple[dict[str, Any], dict[str, Any]]]:
        """``(state, meta)`` of the published checkpoint, or None."""
        sub = _read_latest(self._dir)
        if sub is None:
            return None
        path = os.path.join(self._dir, sub)
        with open(os.path.join(path, _ENGINE_FILE), "rb") as f:
            state = _msgpack.unpackb_ext(f.read())
        with open(os.path.join(path, _META_FILE)) as f:
            meta = json.load(f)
        return state, meta

    def latest_step(self) -> Optional[int]:
        sub = _read_latest(self._dir)
        if sub is None:
            return None
        try:
            with open(os.path.join(self._dir, sub, _META_FILE)) as f:
                step = json.load(f).get("step")
        except (OSError, ValueError):
            return None
        return int(step) if step is not None else None


def install_sigterm_checkpoint(checkpointer: EngineCheckpointer, state_fn: Any,
                               node: str = "engine") -> Any:
    """On SIGTERM, dump the node's flight ring and publish a final
    checkpoint from ``state_fn()`` (an already-materialized host state,
    or None for nothing), then chain to the previous handler. Returns
    that handler so the caller can restore it. Main thread only."""
    prev = signal.getsignal(signal.SIGTERM)

    def _handler(signum: int, frame: Any) -> None:
        from tpfl_torch.management.telemetry import flight

        try:
            flight.dump(node, "sigterm")
        except Exception:
            pass
        try:
            state = state_fn()
            if state is not None:
                step = int(state.get("rounds_done", 0) or 0)
                checkpointer.save(state, step, extra={"reason": "sigterm"})
        except Exception:
            pass  # a failed final checkpoint must not mask the shutdown
        if callable(prev):
            prev(signum, frame)

    signal.signal(signal.SIGTERM, _handler)
    return prev


__all__ = ["EngineCheckpointer", "StateContractError", "install_sigterm_checkpoint",
           "load_node_checkpoint", "save_node_checkpoint"]


class SliceCheckpointer:
    """Checkpoints of mesh-placed trees (``tpfl/management/checkpoint.py:
    354-395``) over ``torch.distributed.checkpoint``, in ``step_<n>``
    directories.

    A tree is nested dicts (lists and tuples too) whose leaves are
    tensors — ``DTensor`` s keep their placement: each rank writes its
    own shards — or JSON values (ints, floats, strings, None), kept in
    ``tree.json``. :meth:`restore` with ``abstract_target`` (a tree of the
    same paths whose tensors carry the wanted placement, dtype and
    device, e.g. a freshly initialised state on another mesh) loads into
    copies of them: a state saved at one world size restores onto
    another. Without a target every tensor comes back whole, on the
    CPU. Every rank of the saving (restoring) world must call
    :meth:`save` (:meth:`restore`) together."""

    _TREE = "tree.json"

    def __init__(self, directory: str) -> None:
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{int(step)}")

    @staticmethod
    def _flatten(tree: Any, prefix: str = "") -> tuple[dict, Any]:
        """({path: tensor}, the tree's skeleton for ``tree.json``: every
        tensor leaf replaced by ``{"__tensor__": path}``)."""
        import torch

        tensors: dict = {}

        def walk(node: Any, path: str) -> Any:
            if isinstance(node, dict):
                return {"__dict__": {k: walk(v, f"{path}{k}/") for k, v in node.items()}}
            if isinstance(node, (list, tuple)):
                return {"__list__": [walk(v, f"{path}{i}/") for i, v in enumerate(node)],
                        "tuple": isinstance(node, tuple)}
            if isinstance(node, torch.Tensor):
                key = path.rstrip("/") or "_"
                tensors[key] = node
                return {"__tensor__": key}
            return {"__value__": node}

        return tensors, walk(tree, prefix)

    @staticmethod
    def _build(skeleton: Any, tensors: dict) -> Any:
        if "__dict__" in skeleton:
            return {k: SliceCheckpointer._build(v, tensors) for k, v in skeleton["__dict__"].items()}
        if "__list__" in skeleton:
            items = [SliceCheckpointer._build(v, tensors) for v in skeleton["__list__"]]
            return tuple(items) if skeleton.get("tuple") else items
        if "__tensor__" in skeleton:
            return tensors[skeleton["__tensor__"]]
        return skeleton["__value__"]

    def save(self, step: int, tree: Any) -> None:
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        path = self._path(step)
        tensors, skeleton = self._flatten(tree)
        if os.path.isdir(path) and (not dist.is_initialized() or dist.get_rank() == 0):
            shutil.rmtree(path)  # force=True, as the reference saves
        if dist.is_initialized():
            dist.barrier()
        dcp.save(tensors, checkpoint_id=path)
        if not dist.is_initialized() or dist.get_rank() == 0:
            tmp = os.path.join(path, self._TREE + ".tmp")
            with open(tmp, "w") as f:
                json.dump(skeleton, f)
            os.replace(tmp, os.path.join(path, self._TREE))
        if dist.is_initialized():
            dist.barrier()

    def restore(self, step: int, abstract_target: Optional[Any] = None) -> Any:
        import torch
        import torch.distributed.checkpoint as dcp
        from torch.distributed.tensor import DTensor

        path = self._path(step)
        with open(os.path.join(path, self._TREE)) as f:
            skeleton = json.load(f)
        if abstract_target is not None:
            target, _ = self._flatten(abstract_target)
            dest = {k: (DTensor.from_local(torch.empty_like(t.to_local()), t.device_mesh,
                                           t.placements, run_check=False, shape=t.shape,
                                           stride=t.stride())
                        if isinstance(t, DTensor) else torch.empty_like(t))
                    for k, t in target.items()}
        else:
            meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
            dest = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
                    for k, m in meta.items()}
        dcp.load(dest, checkpoint_id=path)
        return self._build(skeleton, dest)

    def latest_step(self) -> Optional[int]:
        steps = [int(d.split("_", 1)[1]) for d in os.listdir(self._dir)
                 if d.startswith("step_") and d.split("_", 1)[1].isdigit()]
        return max(steps) if steps else None
