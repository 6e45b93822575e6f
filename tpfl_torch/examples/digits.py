"""Configurable multi-node federated experiment on rendered digit images.

The port of the reference's flagship example (``digits.py``, itself the
parity of p2pfl's ``mnist.py``): pick node count, rounds, epochs,
topology, transport, aggregator and model from the command line, run a
full in-process federation, then print the recorded local / global
metric tables. Deliberate differences from the reference:

- ``--protocol`` is ``memory``, ``grpc`` (the reference's wire,
  :class:`~tpfl_torch.communication.GrpcCommunicationProtocol`) or
  ``tcp`` (:class:`~tpfl_torch.communication.TcpCommunicationProtocol`,
  the same routes over length-prefixed TCP).
- The data is the reference's: ``rendered_digits`` at its sample counts
  and seed (:mod:`tpfl_torch.learning.dataset.rendered`, bit-equal
  without PIL); a Python caller may pass any
  ``data_fn(n_train, n_test, seed)`` and any ``model_fn(seed)``.
- ``--profile DIR`` writes a ``torch.profiler`` trace
  (``DIR/trace.json``) through the port's profiling path; ``--device``
  picks the torch device (default: the card).

Run directly (``python -m tpfl_torch.examples.digits --nodes 4``) or
through the CLI (``tpfl-torch experiment run digits -- --nodes 4``).
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Optional

from tpfl_torch.communication.grpc_transport import GrpcCommunicationProtocol
from tpfl_torch.communication.memory import InMemoryCommunicationProtocol
from tpfl_torch.communication.tcp_transport import TcpCommunicationProtocol
from tpfl_torch.examples._common import add_device_argument, default_data, make_model
from tpfl_torch.learning.aggregators import (FedAvg, FedMedian, FedProx, Krum, Scaffold,
                                             TrimmedMean)
from tpfl_torch.learning.dataset import (DirichletPartitionStrategy,
                                         RandomIIDPartitionStrategy)
from tpfl_torch.management import profiling
from tpfl_torch.management.logger import logger
from tpfl_torch.node import Node
from tpfl_torch.settings import Settings
from tpfl_torch.utils import TopologyFactory, TopologyType, wait_convergence, wait_to_finish

AGGREGATORS = {
    "fedavg": FedAvg,
    "fedmedian": FedMedian,
    "scaffold": Scaffold,
    "fedprox": FedProx,
    "krum": Krum,
    "trimmedmean": TrimmedMean,
}
PROTOCOLS = {
    "memory": InMemoryCommunicationProtocol,
    "grpc": GrpcCommunicationProtocol,
    "tcp": TcpCommunicationProtocol,
}


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="tpfl_torch digits experiment (reference digits.py parity).")
    p.add_argument("--nodes", type=int, default=2)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--protocol", choices=sorted(PROTOCOLS), default="memory")
    p.add_argument("--aggregator", choices=sorted(AGGREGATORS), default="fedavg")
    p.add_argument("--topology", choices=[t.value for t in TopologyType], default="line")
    p.add_argument("--model", choices=["mlp", "cnn"], default="mlp")
    p.add_argument("--partitioning", choices=["iid", "dirichlet"], default="iid")
    p.add_argument("--samples-per-node", type=int, default=800)
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--learning-rate", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=666)
    p.add_argument("--simulation", action="store_true",
                   help="Mark the nodes as simulated (their fits batch through the "
                   "simulation pool unless Settings.DISABLE_SIMULATION).")
    p.add_argument("--show-metrics", action="store_true", default=True)
    p.add_argument("--no-show-metrics", dest="show_metrics", action="store_false")
    p.add_argument("--measure-time", action="store_true")
    p.add_argument("--profiling", action="store_true",
                   help="cProfile the experiment; writes digits.prof and prints the top "
                   "cumulative entries.")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the whole experiment to "
                   "DIR/trace.json (--profiling covers host-side Python instead).")
    add_device_argument(p)
    args = p.parse_args(argv)
    args.topology = TopologyType(args.topology)
    return args


def _print_metric_tables() -> None:
    """Text rendition of the reference's metric plots."""
    local = logger.get_local_logs()
    if local:
        print("\n=== Local metrics (per round / node / metric) ===")
        for exp, rounds in local.items():
            for rnd, nodes in sorted(rounds.items()):
                for node, metrics in sorted(nodes.items()):
                    for metric, values in sorted(metrics.items()):
                        last = values[-1][1] if values else float("nan")
                        print(f"  [{exp}] round={rnd} {node} {metric}: {last:.4f} "
                              f"({len(values)} points)")
    global_logs = logger.get_global_logs()
    if global_logs:
        print("\n=== Global metrics (per node / metric) ===")
        for exp, nodes in global_logs.items():
            for node, metrics in sorted(nodes.items()):
                for metric, values in sorted(metrics.items()):
                    series = ", ".join(f"{r}:{v:.4f}" for r, v in values)
                    print(f"  [{exp}] {node} {metric}: {series}")


def digits(args: argparse.Namespace, data_fn: Optional[Callable[..., Any]] = None,
           model_fn: Optional[Callable[[int], Any]] = None) -> list[Node]:
    """Build, connect, run and tear down the federation. Returns the
    (stopped) nodes so callers can inspect final models and metrics.
    ``data_fn(n_train, n_test, seed)`` gives the dataset (default:
    ``rendered_digits``), ``model_fn(seed)`` each node's model."""
    if getattr(args, "profile", None):
        profiling.start_trace(args.profile)
        try:
            return digits(argparse.Namespace(**{**vars(args), "profile": None}),
                          data_fn, model_fn)
        finally:
            profiling.stop_trace()
            print(f"torch.profiler trace written to {args.profile}")
    start = time.monotonic()
    Settings.set_standalone_settings()
    # TPFL_* environment overrides apply AFTER the profile, so the CLI can
    # steer any knob.
    Settings.from_env()

    n = args.nodes
    ds = (data_fn or default_data)(args.samples_per_node * n,
                                   max(100, args.samples_per_node * n // 5), args.seed)
    strategy = (RandomIIDPartitionStrategy if args.partitioning == "iid"
                else DirichletPartitionStrategy)
    parts = ds.generate_partitions(n, strategy, seed=args.seed)
    nodes = []
    for i in range(n):
        model = model_fn(args.seed) if model_fn else make_model(args.model, args.seed,
                                                                args.device)
        nodes.append(Node(model, parts[i], protocol=PROTOCOLS[args.protocol],
                          aggregator=AGGREGATORS[args.aggregator](device=args.device),
                          simulation=args.simulation, device=args.device,
                          learning_rate=args.learning_rate, batch_size=args.batch_size))
    for nd in nodes:
        nd.start()
    try:
        matrix = TopologyFactory.generate_matrix(args.topology, n)
        TopologyFactory.connect_nodes(matrix, nodes)
        wait_convergence(nodes, n - 1, only_direct=False, wait=60)
        if args.rounds < 1:
            raise ValueError("rounds must be >= 1")
        nodes[0].set_start_learning(rounds=args.rounds, epochs=args.epochs)
        wait_to_finish(nodes, timeout=3600)
        if args.show_metrics:
            _print_metric_tables()
        accs = {nd.addr: nd.learner.evaluate()["test_metric"] for nd in nodes}
        print("\nFinal test accuracy per node:")
        for addr, acc in accs.items():
            print(f"  {addr}: {acc:.4f}")
    finally:
        for nd in nodes:
            nd.stop()
        if args.measure_time:
            print(f"--- {time.monotonic() - start:.1f} seconds ---")
    return nodes


def main(argv: Optional[list[str]] = None) -> None:
    args = parse_args(argv)
    if args.profiling:
        import cProfile
        import pstats

        prof = cProfile.Profile()
        prof.enable()
        try:
            digits(args)
        finally:
            prof.disable()
            prof.dump_stats("digits.prof")
            pstats.Stats(prof).sort_stats("cumulative").print_stats(20)
    else:
        digits(args)


if __name__ == "__main__":
    main()
