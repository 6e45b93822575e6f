"""Large-scale in-process federation — BASELINE config 4 on the protocol
path (the port of the reference's ``scale.py``).

Every node is a real protocol participant (vote, gossip, heartbeats),
and concurrent ``fit()`` calls batch into node-stacked programs through
:mod:`tpfl_torch.simulation`. Partial participation falls out of the
protocol itself: the election takes ``Settings.TRAIN_SET_SIZE`` nodes a
round.

Run: ``tpfl-torch experiment run scale -- --nodes 100 --rounds 2`` (or
``python -m tpfl_torch.examples.scale``). Prints rounds/s and the share
of nodes that hold the majority final model at the end.

The data is the reference's ``rendered_digits`` at its sample counts and
seed. Deliberate differences from the reference: a Python caller may pass
``data_fn(n_train, n_test, seed)`` and ``model_fn(seed)``; ``--device``
picks the torch device (default: the card).
"""

from __future__ import annotations

import argparse
import hashlib
import time
from collections import Counter
from typing import Any, Callable, Optional

import torch

from tpfl_torch.examples._common import add_device_argument, default_data, make_model
from tpfl_torch.learning.dataset import RandomIIDPartitionStrategy
from tpfl_torch.node import Node
from tpfl_torch.settings import Settings
from tpfl_torch.utils import TopologyFactory, TopologyType, wait_convergence, wait_to_finish


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Large-scale in-process federation "
                                "(config 4 tier).")
    p.add_argument("--nodes", type=int, default=100)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--train-set-size", type=int, default=10,
                   help="Elected trainers per round (partial participation).")
    p.add_argument("--samples-per-node", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--seed", type=int, default=666)
    p.add_argument("--topology", choices=["star", "tree"], default="tree",
                   help="star = single hub (reference-style, ~200-node ceiling); "
                   "tree = sqrt(N) meshed hubs (default, 500+ nodes).")
    p.add_argument("--heartbeat-period", type=float, default=10.0,
                   help="Digest heartbeat cadence (s); lower it for small, quick runs.")
    p.add_argument("--election", choices=["vote", "hash"], default="hash",
                   help="vote = reference protocol (O(N^2) vote flood + timeout waits); "
                   "hash = deterministic sortition (zero election traffic).")
    add_device_argument(p)
    return p.parse_args(argv)


def model_digest(node: Node) -> str:
    """sha256 of a node's final params as f32 bytes (first 12 hex)."""
    h = hashlib.sha256()
    for leaf in node.learner.get_model().get_parameters_list():
        h.update(torch.as_tensor(leaf).detach().to("cpu", torch.float32).numpy().tobytes())
    return h.hexdigest()[:12]


def scale(args: argparse.Namespace, data_fn: Optional[Callable[..., Any]] = None,
          model_fn: Optional[Callable[[int], Any]] = None) -> dict:
    Settings.set_scale_settings()
    Settings.from_env()  # TPFL_* overrides (the CLI's --profile rides these)
    Settings.TRAIN_SET_SIZE = args.train_set_size
    Settings.ELECTION = args.election
    # The reference's reasoning holds here: a relaxed beat, a timeout
    # that grows with N (the formation phase can hold the GIL for tens of
    # seconds at a thousand nodes), and an aggregation budget of 0.3 s a
    # node.
    Settings.HEARTBEAT_PERIOD = args.heartbeat_period
    Settings.HEARTBEAT_TIMEOUT = max(120.0, 12 * args.heartbeat_period, 0.6 * args.nodes)
    Settings.AGGREGATION_TIMEOUT = max(120.0, 0.3 * args.nodes)

    n = args.nodes
    ds = (data_fn or default_data)(args.samples_per_node * n, 200, args.seed)
    parts = ds.generate_partitions(n, RandomIIDPartitionStrategy, seed=args.seed)
    print(f"Building {n} nodes...")
    nodes = [Node(model_fn(args.seed) if model_fn else
                  make_model("mlp", args.seed, args.device, hidden_sizes=(64,)),
                  parts[i], simulation=True, device=args.device, batch_size=args.batch_size)
             for i in range(n)]
    t_start = time.monotonic()
    for nd in nodes:
        nd.start()
    try:
        topo = TopologyType.TREE if args.topology == "tree" else TopologyType.STAR
        TopologyFactory.connect_nodes(TopologyFactory.generate_matrix(topo, n), nodes)
        wait_convergence(nodes, n - 1, only_direct=False, wait=max(120, n))
        t_ready = time.monotonic()
        print(f"Topology converged in {t_ready - t_start:.1f}s; starting...")
        nodes[0].set_start_learning(rounds=args.rounds, epochs=args.epochs)
        wait_to_finish(nodes, timeout=3600)
        t_done = time.monotonic()
        # "All nodes finished" alone can hide nodes that timed out of the
        # aggregation wait: report how many hold the majority model.
        tally = Counter(model_digest(nd) for nd in nodes)
        stats = {
            "nodes": n,
            "rounds": args.rounds,
            "election": args.election,
            "train_set_size": args.train_set_size,
            "setup_s": round(t_ready - t_start, 1),
            "learn_s": round(t_done - t_ready, 1),
            "rounds_per_sec": round(args.rounds / (t_done - t_ready), 4),
            "model_agreement": round(tally.most_common(1)[0][1] / n, 3),
        }
        print("RESULT:", stats)
        return stats
    finally:
        for nd in nodes:
            nd.stop()


def main(argv: Optional[list[str]] = None) -> None:
    scale(parse_args(argv))


if __name__ == "__main__":
    main()
