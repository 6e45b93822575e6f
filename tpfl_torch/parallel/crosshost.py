"""Cross-host parity harness: multi-process engine runs over
``torch.distributed`` — the port of :mod:`tpfl.parallel.crosshost`.

A multi-rank run of the same logical federation must land allclose to
the one-rank run (same topology and seed: the same bytes). This module
is both sides of that check:

- :func:`demo_run` — the shared payload: a small seeded MLP federation
  through :class:`~tpfl_torch.parallel.engine.FederationEngine` on
  whatever mesh :func:`~tpfl_torch.parallel.engine.auto_mesh` resolves
  under the ``SHARD_*`` knobs. Every process computes the same host-side
  inputs (seeded numpy) — the single-controller contract the port keeps:
  every rank builds the same host arrays and keeps its own shard — so
  the run is reproducible across any topology. The result is the folded
  global model (row 0 of the unpadded stack), the last round's per-node
  losses, a byte digest of the whole stack, the ``RANK_CONTRACTS``
  receipt and a snapshot of the deterministic metric series.
- :func:`worker_main` — the subprocess entry point
  (``python -m tpfl_torch.parallel.crosshost``): joins the world through
  :func:`~tpfl_torch.parallel.distributed.ensure_distributed` (the
  ``TPFL_COORDINATOR`` / ``TPFL_NUM_PROCESSES`` / ``TPFL_PROCESS_ID``
  environment contract), applies the knob overrides of
  ``TPFL_CROSSHOST_CFG`` (a closed set, :data:`_KNOBS`), runs
  :func:`demo_run` and writes ``<TPFL_CROSSHOST_OUT>.<rank>.json``.
- :func:`launch` — the orchestrator: starts N ranks on a free localhost
  port with a world timeout, waits, compares their ``RANK_CONTRACTS``
  receipts (:func:`~tpfl_torch.parallel.ranksafe.compare_receipts`) and
  returns their results. The parent joins no world and runs no engine.

``launch`` runs the ranks on the cards by default (``device=None``
means ``cuda``: ``nccl``, one process per card, rank r on card
``r % cards``; without a card it raises and names ``device="cpu"``,
which runs ``gloo`` ranks on the CPU). The same environment contract
starts such a world by hand: each process with
``TPFL_COORDINATOR=host:port``, ``TPFL_NUM_PROCESSES=N`` and its
``TPFL_PROCESS_ID``.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
from typing import Any, Optional

import numpy as np

__all__ = ["demo_run", "free_port", "launch", "worker_main"]

#: Knobs a harness config may override in the worker before the run — a
#: closed set, so a config cannot reach arbitrary settings.
_KNOBS = (
    "SHARD_NODES",
    "SHARD_DEVICES",
    "SHARD_MODEL",
    "SHARD_HOSTS",
    "ENGINE_WIRE_CODEC",
    "WIRE_TOPK_FRAC",
    "ENGINE_TELEMETRY",
    "ENGINE_DONATE",
    "RANK_CONTRACTS",
)


def free_port() -> int:
    """An OS-assigned free TCP port for the coordinator."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _apply_knobs(knobs: Optional[dict]) -> None:
    from tpfl_torch.settings import Settings

    for name, value in (knobs or {}).items():
        if name not in _KNOBS:
            raise ValueError(f"crosshost config knob {name!r} not allowed")
        setattr(Settings, name, value)


def _load_init(path: str) -> dict:
    """A nested param tree from an ``.npz`` whose keys are ``/``-joined
    paths (``Dense_0/kernel``): the initial model a parity check hands
    both packages."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = np.array(z[key])
    return tree


def demo_run(nodes: int = 8, rounds: int = 2, seed: int = 0, algorithm: str = "fedavg",
             fork_rank: Optional[int] = None, init: Optional[str] = None,
             device: Any = None) -> dict:
    """One deterministic engine federation under the current knobs.

    Same ``(nodes, rounds, seed, algorithm, init)`` ⇒ the same logical run
    on any topology (1 rank, 2 ranks, forced ``SHARD_HOSTS``): allclose
    across topologies, byte-equal within one. ``init`` (an ``.npz`` of
    the MLP's params, ``/``-joined keys) replaces the seeded init, so a
    run can start from the JAX package's initial model. ``fork_rank``:
    that rank alone dispatches one extra rank-local program (a
    ``mesh=None`` engine: no collectives, it cannot hang the world)
    after the shared run, so its ``RANK_CONTRACTS`` receipt forks and
    :func:`launch`'s comparison must fail with a (rank, ordinal, key)
    witness. ``device`` None means the card."""
    import torch
    import torch.distributed as dist

    from tpfl_torch.learning import compression
    from tpfl_torch.management import fleetobs
    from tpfl_torch.management.telemetry import metrics
    from tpfl_torch.models import MLP
    from tpfl_torch.parallel import distributed as spmd
    from tpfl_torch.parallel import ranksafe
    from tpfl_torch.parallel.engine import FederationEngine, auto_mesh
    from tpfl_torch.parallel.mesh import HOST_AXIS, mesh_axis_size
    from tpfl_torch.settings import Settings
    from tpfl_torch.utils.tree import canonical_leaves, tree_map

    # One receipt per run: dispatches recorded before the harness entered
    # must not ride this run's receipt.
    ranksafe.clear()
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1

    rng = np.random.default_rng(seed)
    xs = rng.random((nodes, 1, 8, 8, 8), np.float32)
    ys = rng.integers(0, 10, (nodes, 1, 8)).astype(np.int32)
    w = np.ones((nodes,), np.float32)
    w[:: max(nodes // 2, 1)] = 0.0  # partial participation, seeded shape
    if not w.any():
        w[:] = 1.0

    mesh = auto_mesh(device)
    eng = FederationEngine(MLP(hidden_sizes=(8,)), nodes, mesh=mesh, seed=seed,
                           algorithm=algorithm, learning_rate=0.1, device=device)
    if init is not None:
        p = eng.broadcast_params(tree_map(lambda a: torch.as_tensor(a, device=eng.device),
                                          _load_init(init)))
    else:
        p = eng.init_params((8, 8))
    dx, dy = eng.shard_data(xs, ys)
    p, losses = eng.run_rounds(p, dx, dy, weights=w, n_rounds=rounds, donate=False)

    # rank-dependent: the deliberate divergence harness (see above).
    if fork_rank is not None and rank == int(fork_rank):
        probe = FederationEngine(MLP(hidden_sizes=(8,)), 2, mesh=None, seed=seed,
                                 algorithm=algorithm, learning_rate=0.1, device=device)
        probe.run_rounds(probe.init_params((8, 8)), *probe.shard_data(xs[:2], ys[:2]),
                         n_rounds=1, donate=False)

    stack = eng.unpad(p)  # every leaf whole on every rank
    leaves = [t.detach().cpu() for t in canonical_leaves(stack)]
    global_row = np.concatenate([leaf[0].to(torch.float64).numpy().ravel() for leaf in leaves])
    h = hashlib.sha256()
    for leaf in leaves:
        h.update(leaf.contiguous().view(torch.uint8).numpy().tobytes())
    loss_rows = spmd.full_tensor(losses)[:nodes].detach().cpu().to(torch.float64).numpy()

    # The fleet-observatory leg: a snapshot of this rank's registry,
    # restricted to the deterministic series. A window over several ranks
    # fans nothing out (EngineWindow.finalize), so under ENGINE_TELEMETRY
    # each rank emits its engine series here, from the run's outputs.
    if Settings.ENGINE_TELEMETRY:
        rank_labels = {"node": f"rank{rank}"}
        metrics.counter("tpfl_engine_rounds_total", float(rounds), labels=rank_labels)
        metrics.gauge("tpfl_engine_loss", float(np.mean(loss_rows)), labels=rank_labels)
        metrics.gauge("tpfl_engine_model_norm", float(np.linalg.norm(global_row)),
                      labels=rank_labels)
    snap = fleetobs.snapshot(origin=str(rank), prefixes=fleetobs.DETERMINISTIC_PREFIXES)

    hosts = mesh_axis_size(mesh, HOST_AXIS)
    dcn_bytes = 0
    if hosts > 1:
        bits = compression.resolve_engine_codec(Settings.ENGINE_WIRE_CODEC)
        dcn_bytes = hosts * compression.wire_bytes_per_model(
            tree_map(lambda t: torch.empty(t.shape[1:], dtype=t.dtype, device="meta"), p),
            bits, float(Settings.WIRE_TOPK_FRAC))
    return {
        "loss_mean": float(np.mean(loss_rows)),
        # Ordered (cache key, program fingerprint) digests of every program
        # this rank dispatched — empty unless Settings.RANK_CONTRACTS.
        "program_digests": ranksafe.receipt(),
        "dcn_bytes_per_round": int(dcn_bytes),
        "metrics_snapshot": snap,
        "global": global_row.tolist(),
        "losses": loss_rows.tolist(),
        "digest": h.hexdigest(),
        "devices": world,
        "local_devices": 1,
        "processes": world,
        "process_id": rank,
        "hosts_axis": hosts,
        "mesh": None if mesh is None else dict(
            zip(mesh.mesh_dim_names, (int(s) for s in mesh.mesh.shape))),
    }


def worker_main() -> int:
    """Subprocess body: join the world, run the demo, write JSON."""
    import torch.distributed as dist

    from tpfl_torch.parallel.distributed import ensure_distributed

    cfg = json.loads(os.environ.get("TPFL_CROSSHOST_CFG", "{}") or "{}")
    device = cfg.get("device")
    timeout = cfg.get("timeout")
    kwargs = {} if timeout is None else {"timeout": datetime.timedelta(seconds=float(timeout))}
    ensure_distributed(device=device, **kwargs)
    try:
        _apply_knobs(cfg.get("knobs"))
        fork = cfg.get("fork_rank")
        result = demo_run(
            nodes=int(cfg.get("nodes", 8)),
            rounds=int(cfg.get("rounds", 2)),
            seed=int(cfg.get("seed", 0)),
            algorithm=str(cfg.get("algorithm", "fedavg")),
            fork_rank=int(fork) if fork is not None else None,
            init=cfg.get("init"),
            device=device,
        )
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    out = os.environ.get("TPFL_CROSSHOST_OUT")
    if out:
        with open(f"{out}.{result['process_id']}.json", "w") as f:
            json.dump(result, f)
    else:  # a manual run
        print(json.dumps(result))
    return 0


def launch(num_processes: int = 2, nodes: int = 8, rounds: int = 2, seed: int = 0,
           algorithm: str = "fedavg", knobs: Optional[dict] = None, timeout: float = 420.0,
           fork_rank: Optional[int] = None, init: Optional[str] = None,
           device: Any = None, world_timeout: float = 120.0) -> list[dict]:
    """Start ``num_processes`` ranks of :func:`worker_main` and return
    their results in rank order.

    Each rank joins a fresh coordinator on a free localhost port
    (``device`` None or ``"cuda"``: ``nccl``, one card a rank; ``"cpu"``:
    ``gloo``)
    with ``world_timeout`` seconds for each collective; the parent joins
    no world itself. Raises on any rank's failure with its stderr tail.
    When the ranks ran with ``RANK_CONTRACTS`` (through ``knobs``), their
    receipts must be one program sequence
    (:func:`~tpfl_torch.parallel.ranksafe.compare_receipts`): a divergence
    raises with the first (rank, ordinal, key) witness. ``fork_rank``
    breaks one rank's sequence on purpose (:func:`demo_run`)."""
    from tpfl_torch import resolve_device

    device = resolve_device(device).type  # every rank picks its own card
    port = free_port()
    out_dir = tempfile.mkdtemp(prefix="tpfl_crosshost_")
    out_prefix = os.path.join(out_dir, "result")
    cfg = json.dumps({
        "nodes": nodes, "rounds": rounds, "seed": seed, "algorithm": algorithm,
        "knobs": dict(knobs or {}), "fork_rank": fork_rank, "init": init, "device": device,
        "timeout": world_timeout,
    })
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = []
    for pid in range(num_processes):
        env = dict(
            os.environ,
            PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p),
            TPFL_COORDINATOR=f"127.0.0.1:{port}",
            TPFL_NUM_PROCESSES=str(num_processes),
            TPFL_PROCESS_ID=str(pid),
            TPFL_CROSSHOST_OUT=out_prefix,
            TPFL_CROSSHOST_CFG=cfg,
            OMP_NUM_THREADS="1",
        )
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpfl_torch.parallel.crosshost"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failures = []
    for pid, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
            failures.append(f"rank {pid}: timeout\n{err[-2000:]}")
            continue
        if proc.returncode != 0:
            failures.append(f"rank {pid}: exit {proc.returncode}\n{err[-2000:]}")
    try:
        if failures:
            raise RuntimeError("crosshost workers failed:\n" + "\n---\n".join(failures))
        results = []
        for pid in range(num_processes):
            with open(f"{out_prefix}.{pid}.json") as f:
                results.append(json.load(f))
    finally:
        import shutil

        shutil.rmtree(out_dir, ignore_errors=True)
    receipts = [r.get("program_digests") or [] for r in results]
    if any(receipts):
        from tpfl_torch.parallel.ranksafe import compare_receipts

        compare_receipts(receipts)
    return results


if __name__ == "__main__":  # the subprocess entry
    sys.exit(worker_main())
