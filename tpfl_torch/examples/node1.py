"""Two-process gRPC quickstart — the passive half.

The port of the reference's ``node1.py``: start one node on a real gRPC
port and wait for a peer (node2) to connect and drive the experiment.
Run in two terminals::

    python -m tpfl_torch.examples.node1 --port 6666
    python -m tpfl_torch.examples.node2 --port 6661 --connect-to 127.0.0.1:6666

The transport is the reference's gRPC wire
(:class:`~tpfl_torch.communication.GrpcCommunicationProtocol`), so either
half may be the JAX package's ``tpfl.examples.node1`` / ``node2``.
Deliberate differences from the reference: ``--device`` picks the torch
device (default: the card). The data is the reference's
``rendered_digits``. SIGTERM stops the node like Ctrl-C.
"""

from __future__ import annotations

import argparse
from typing import Any, Callable, Optional

from tpfl_torch.communication.grpc_transport import GrpcCommunicationProtocol
from tpfl_torch.examples._common import (add_device_argument, default_data, make_model,
                                         wait_until_stopped)
from tpfl_torch.node import Node
from tpfl_torch.settings import Settings


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="tpfl_torch gRPC quickstart (passive node).")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--host", type=str, default="127.0.0.1",
                   help="Bind address (0.0.0.0 inside containers so published ports "
                   "are reachable).")
    p.add_argument("--samples", type=int, default=800)
    p.add_argument("--seed", type=int, default=666)
    add_device_argument(p)
    return p.parse_args(argv)


def build_node(args: argparse.Namespace, data_fn: Optional[Callable[..., Any]] = None,
               model_fn: Optional[Callable[[int], Any]] = None) -> Node:
    """The node of one half of the quickstart (node1 and node2 build
    theirs alike). ``data_fn(n_train, n_test, seed)`` gives its dataset
    and ``model_fn(seed)`` its model."""
    data = (data_fn or default_data)(args.samples, 200, args.seed)
    model = model_fn(args.seed) if model_fn else make_model("mlp", args.seed, args.device)
    return Node(model, data, protocol=GrpcCommunicationProtocol(f"{args.host}:{args.port}"),
                device=args.device)


def main(argv: Optional[list[str]] = None) -> None:
    args = parse_args(argv)
    Settings.set_standalone_settings()
    Settings.from_env()  # TPFL_* overrides (the CLI's --profile rides these)
    node = build_node(args)
    node.start()
    print(f"Node listening on {node.addr}; waiting for peers (Ctrl-C to stop)", flush=True)
    try:
        wait_until_stopped()
    finally:
        node.stop()


if __name__ == "__main__":
    main()
