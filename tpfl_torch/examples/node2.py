"""Two-process gRPC quickstart — the driving half.

The port of the reference's ``node2.py``: start a second node, connect to
a running node1 over gRPC, kick off learning, and exit when the
experiment finishes. See node1.py for the recipe and the deliberate
difference (``--device``).
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Optional

from tpfl_torch.examples._common import add_device_argument
from tpfl_torch.examples.node1 import build_node
from tpfl_torch.settings import Settings
from tpfl_torch.utils import wait_to_finish


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="tpfl_torch gRPC quickstart (driving node).")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--host", type=str, default="127.0.0.1",
                   help="Bind address (0.0.0.0 inside containers so published ports "
                   "are reachable).")
    p.add_argument("--connect-to", type=str, required=True, help="host:port of node1")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--samples", type=int, default=800)
    p.add_argument("--seed", type=int, default=667)
    add_device_argument(p)
    return p.parse_args(argv)


def main(argv: Optional[list[str]] = None, data_fn: Optional[Callable[..., Any]] = None,
         model_fn: Optional[Callable[[int], Any]] = None) -> dict:
    """Returns the final metrics (``learner.evaluate()``)."""
    args = parse_args(argv)
    Settings.set_standalone_settings()
    Settings.from_env()  # TPFL_* overrides (the CLI's --profile rides these)
    node = build_node(args, data_fn, model_fn)
    node.start()
    if not node.connect(args.connect_to):
        node.stop()
        raise SystemExit(f"Could not connect to {args.connect_to}")
    time.sleep(2)  # let the handshake / gossip settle (the reference sleeps too)
    node.set_start_learning(rounds=args.rounds, epochs=args.epochs)
    try:
        wait_to_finish([node], timeout=3600)
        metrics = node.learner.evaluate()
        print("Final metrics:", metrics, flush=True)
        return metrics
    finally:
        node.stop()


if __name__ == "__main__":
    main()
