"""Multi-host / multi-slice deployment — BASELINE config 5 (the port of
the reference's ``multislice.py``).

Two ways to span hosts, one entry point:

**Engine mode** — every process joins ONE ``torch.distributed`` world
(:func:`~tpfl_torch.parallel.distributed.ensure_distributed`, the
``TPFL_COORDINATOR`` / ``TPFL_NUM_PROCESSES`` / ``TPFL_PROCESS_ID``
contract of :mod:`tpfl_torch.parallel.crosshost`) and the
:class:`~tpfl_torch.parallel.FederationEngine` lays a ``hosts x nodes``
mesh over the ranks (``SHARD_HOSTS=0`` resolves to the process count).
The whole federation folds in one SPMD program. Rank 0 reports.

Terminal 1:  python -m tpfl_torch.examples.multislice --coordinator 127.0.0.1:8476 \
    --num-processes 2 --process-id 0 --rounds 2
Terminal 2:  python -m tpfl_torch.examples.multislice --coordinator 127.0.0.1:8476 \
    --num-processes 2 --process-id 1 --rounds 2

**Slice mode (``--mode grpc``)** — each process is ONE protocol Node whose
learner is a :class:`~tpfl_torch.parallel.FederationLearner`: local
nodes train as one node-stacked program, and only the slice-level
aggregate crosses hosts, over the reference's gRPC wire.

Terminal 1 (passive slice):   python -m tpfl_torch.examples.multislice --port 6700
Terminal 2 (driving slice):   python -m tpfl_torch.examples.multislice \
    --port 6701 --connect-to 127.0.0.1:6700 --rounds 2

``--mode auto`` (default) picks engine when a coordinator is configured
(flag or ``TPFL_COORDINATOR``), else grpc. Deliberate differences from
the reference: ``torch.distributed`` in place of ``jax.distributed``;
a Python caller may pass
``data_fn(n_train, n_test, seed)`` in place of the reference's
``rendered_digits`` (the default); ``--device`` picks
the torch device (default: the card). SIGTERM stops a passive slice like
Ctrl-C.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Callable, Optional

import numpy as np

from tpfl_torch.examples._common import (add_device_argument, default_data, make_model,
                                         wait_until_stopped)
from tpfl_torch.settings import Settings


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="tpfl_torch multi-slice quickstart.")
    p.add_argument("--mode", choices=("auto", "engine", "grpc"), default="auto",
                   help="engine = one torch.distributed SPMD world (hosts x nodes mesh); "
                   "grpc = per-slice protocol Nodes; auto = engine iff a coordinator is "
                   "configured.")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of the torch.distributed rendezvous (engine mode; "
                   "TPFL_COORDINATOR env works too).")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--port", type=int, default=None, help="gRPC bind port (grpc mode only).")
    p.add_argument("--host", type=str, default="127.0.0.1",
                   help="Bind address (0.0.0.0 inside containers so published ports "
                   "are reachable).")
    p.add_argument("--connect-to", type=str, default=None,
                   help="host:port of a running slice (driving role, grpc mode)")
    p.add_argument("--local-nodes", type=int, default=8)
    p.add_argument("--local-rounds", type=int, default=1)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--samples", type=int, default=2000)
    p.add_argument("--seed", type=int, default=666)
    add_device_argument(p)
    return p.parse_args(argv)


def _node_stack(ds: Any, n_nodes: int, seed: int, batch_size: int = 32) -> tuple:
    """[n, n_batches, b, ...] host stacks from IID partitions."""
    from tpfl_torch.learning.dataset import RandomIIDPartitionStrategy

    parts = ds.generate_partitions(n_nodes, RandomIIDPartitionStrategy, seed=seed)
    xs, ys = [], []
    for part in parts:
        x, y = part.export(batch_size=batch_size, train=True).stacked()
        xs.append(x)
        ys.append(y)
    n_batches = min(x.shape[0] for x in xs)
    return (np.stack([x[:n_batches] for x in xs]), np.stack([y[:n_batches] for y in ys]))


def run_engine(args: argparse.Namespace, data_fn: Optional[Callable[..., Any]] = None) -> dict:
    """One SPMD federation over every process's rank, hosts leg across
    processes. Identical host inputs on every rank (seeded). Returns rank
    0's report (every rank returns its own)."""
    import torch.distributed as dist

    from tpfl_torch.parallel.distributed import ensure_distributed, local_data

    ensure_distributed(args.coordinator, args.num_processes, args.process_id,
                       device=args.device)
    Settings.set_standalone_settings()
    Settings.from_env()  # TPFL_* overrides (the CLI's --profile rides these)
    Settings.SHARD_NODES = True
    Settings.SHARD_HOSTS = 0  # auto: one hosts-row per process

    from tpfl_torch.models import MLP
    from tpfl_torch.parallel.engine import FederationEngine, auto_mesh
    from tpfl_torch.parallel.mesh import HOST_AXIS, mesh_axis_size

    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = args.local_nodes * world
    ds = (data_fn or default_data)(args.samples, 400, args.seed)
    xs, ys = _node_stack(ds, n, seed=args.seed)
    mesh = auto_mesh(args.device)
    eng = FederationEngine(MLP(), n, mesh=mesh, seed=args.seed, device=args.device)
    p = eng.init_params((28, 28))
    dx, dy = eng.shard_data(xs, ys)
    t0 = time.monotonic()
    p, losses = eng.run_rounds(p, dx, dy, n_rounds=args.rounds, epochs=args.epochs,
                               donate=False)
    wall = time.monotonic() - t0
    report = {"nodes": n, "processes": world,
              "hosts_axis": mesh_axis_size(mesh, HOST_AXIS) if mesh is not None else 1,
              "mesh": ({k: int(s) for k, s in zip(mesh.mesh_dim_names, mesh.mesh.shape)}
                       if mesh is not None
                       else {"devices": 1}),
              "rounds": args.rounds, "wall_s": wall,
              "last_round_mean_loss": float(np.mean(local_data(losses)))}
    if rank == 0:
        print(f"engine mode: {n} nodes over mesh {report['mesh']} ({world} processes, "
              f"hosts axis {report['hosts_axis']})")
        print(f"{args.rounds} rounds in {wall:.2f}s — last-round mean loss "
              f"{report['last_round_mean_loss']:.4f}", flush=True)
    return report


def run_grpc(args: argparse.Namespace, data_fn: Optional[Callable[..., Any]] = None) -> Any:
    """Per-slice protocol Nodes, slice aggregates over gRPC. The driving
    slice returns its final metrics; the passive one None."""
    from tpfl_torch.communication import GrpcCommunicationProtocol
    from tpfl_torch.node import Node
    from tpfl_torch.parallel import FederationLearner
    from tpfl_torch.utils import wait_to_finish

    if args.port is None:
        raise SystemExit("grpc mode needs --port")
    Settings.set_standalone_settings()
    Settings.from_env()  # TPFL_* overrides (the CLI's --profile rides these)
    node = Node(
        make_model("mlp", args.seed, args.device),
        (data_fn or default_data)(args.samples, 400, args.seed + args.port),
        protocol=GrpcCommunicationProtocol(f"{args.host}:{args.port}"),
        learner=FederationLearner(n_local_nodes=args.local_nodes,
                                  local_rounds=args.local_rounds, seed=args.seed,
                                  device=args.device),
        device=args.device,
    )
    node.start()
    try:
        if args.connect_to is None:
            print(f"Slice listening on {node.addr} ({args.local_nodes} local nodes); "
                  "Ctrl-C to stop", flush=True)
            wait_until_stopped()
            return None
        if not node.connect(args.connect_to):
            raise SystemExit(f"Could not connect to {args.connect_to}")
        time.sleep(2)
        node.set_start_learning(rounds=args.rounds, epochs=args.epochs)
        wait_to_finish([node], timeout=3600)
        metrics = node.learner.evaluate()
        print("Slice-level metrics:", metrics, flush=True)
        return metrics
    finally:
        node.stop()


def main(argv: Optional[list[str]] = None) -> Any:
    args = parse_args(argv)
    mode = args.mode
    if mode == "auto":
        mode = "engine" if (args.coordinator or os.environ.get("TPFL_COORDINATOR")) else "grpc"
    return run_engine(args) if mode == "engine" else run_grpc(args)


if __name__ == "__main__":
    main()
