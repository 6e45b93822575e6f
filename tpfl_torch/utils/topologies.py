"""Network topologies — a copy of :mod:`tpfl.utils.topologies` (reference
``p2pfl/utils/topologies.py:30-93``):
STAR/FULL/LINE/RING adjacency matrices + connection walker, plus TREE —
a tpfl addition for large federations.

TREE is a two-level star-of-stars: ~sqrt(n) hub nodes are fully
connected to each other, every other node attaches to one hub. A
single-hub STAR makes the hub relay every flooded message to all n-1
peers (O(n²) handler work per round at one node — the protocol-path
scale ceiling); TREE splits that across k hubs, each relaying to n/k
leaves + k-1 hubs, so per-node relay work drops to O(n·sqrt(n)/k) ≈
O(n) and the ceiling rises by ~sqrt(n)."""

from __future__ import annotations

import math
from enum import Enum
from typing import Sequence

import numpy as np


class TopologyType(Enum):
    STAR = "star"
    FULL = "full"
    LINE = "line"
    RING = "ring"
    TREE = "tree"


class TopologyFactory:
    @staticmethod
    def generate_matrix(topology: TopologyType, n: int) -> np.ndarray:
        m = np.zeros((n, n), dtype=int)
        if topology == TopologyType.STAR:
            m[0, 1:] = 1
            m[1:, 0] = 1
        elif topology == TopologyType.FULL:
            m[:] = 1
            np.fill_diagonal(m, 0)
        elif topology == TopologyType.LINE:
            idx = np.arange(n - 1)
            m[idx, idx + 1] = 1
            m[idx + 1, idx] = 1
        elif topology == TopologyType.RING:
            idx = np.arange(n)
            m[idx, (idx + 1) % n] = 1
            m[(idx + 1) % n, idx] = 1
        elif topology == TopologyType.TREE:
            # k = ceil(sqrt(n)) hubs (nodes 0..k-1), fully meshed; node
            # i >= k attaches to hub i % k (leaves spread evenly).
            k = max(1, math.ceil(math.sqrt(n)))
            m[:k, :k] = 1
            leaves = np.arange(k, n)
            hubs = leaves % k
            m[leaves, hubs] = 1
            m[hubs, leaves] = 1
            np.fill_diagonal(m, 0)
        else:
            raise ValueError(f"Unknown topology {topology}")
        return m

    @staticmethod
    def connect_nodes(matrix: np.ndarray, nodes: Sequence) -> None:
        """Walk the upper triangle and connect (reference
        topologies.py:74-93)."""
        n = len(nodes)
        for i in range(n):
            for j in range(i + 1, n):
                if matrix[i, j]:
                    nodes[i].connect(nodes[j].addr)
