"""Sync and assert helpers — the port of :mod:`tpfl.utils.utils` (reference
``p2pfl/utils/utils.py:39-145``), with the model check written in torch."""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np

from tpfl_torch.utils.tree import canonical_leaves


def wait_convergence(
    nodes: Sequence,
    n_neighbors: int,
    only_direct: bool = False,
    wait: float = 5.0,
) -> None:
    """Poll until every node sees ``n_neighbors`` peers (reference
    utils.py:60-84)."""
    deadline = time.monotonic() + wait
    while time.monotonic() < deadline:
        if all(
            len(n.get_neighbors(only_direct=only_direct)) == n_neighbors
            for n in nodes
        ):
            return
        time.sleep(0.1)
    raise TimeoutError(
        f"Convergence to {n_neighbors} neighbors not reached in {wait}s: "
        + str([len(n.get_neighbors(only_direct=only_direct)) for n in nodes])
    )


def full_connection(node, peers: Sequence) -> None:
    """Connect one node to every peer (reference utils.py:87-97)."""
    for p in peers:
        node.connect(p.addr)


def wait_to_finish(nodes: Sequence, timeout: float = 3600.0) -> None:
    """Block until every node's workflow finished (reference
    utils.py:100-116)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(n.learning_finished() for n in nodes):
            return
        time.sleep(0.1)
    raise TimeoutError(f"Nodes did not finish within {timeout}s")


def check_equal_models(nodes: Sequence, atol: float = 1e-1) -> None:
    """Assert model agreement across nodes (reference utils.py:119-145):
    every leaf, in the reference's leaf order, within ``atol``."""
    ref = None
    for node in nodes:
        params = [
            x.detach().float().cpu().numpy()
            for x in canonical_leaves(node.learner.get_model().get_parameters())
        ]
        if ref is None:
            ref = params
            continue
        assert len(ref) == len(params)
        for a, b in zip(ref, params):
            np.testing.assert_allclose(a, b, atol=atol)
