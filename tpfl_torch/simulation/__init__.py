"""Scale-out simulation layer — the port of :mod:`tpfl.simulation`.

When several protocol nodes of one process (the round's train set) call
``fit()`` within the batching window, :class:`SuperLearnerPool` stacks
their parameters, corrections and data on a leading node axis and
trains them with one node-stacked program: the CNN's conv backward runs
its kernels once for the chunk, not once a node. Heterogeneous jobs, and
the jobs of a batched chunk that failed, fit on their own on a thread
pool (``SIM_PROCESS_ISOLATION`` runs those in spawned worker processes).

Activation: :func:`try_init_learner_with_simulation` wraps a learner in
:class:`VirtualNodeLearner` unless ``Settings.DISABLE_SIMULATION`` —
every ``Node`` does, so a port ``Node`` fits through the pool by
default, as the reference's does.

Sharded over ranks (``Settings.SHARD_NODES`` in a ``torch.distributed``
world): rank 0 runs the simulation and its pool leads; every other rank
of the shard mesh calls :func:`serve_pool_shards` (importable from here,
outside ``__all__``, which stays the reference's) and trains the row
shards of the chunks rank 0 sends it, until rank 0's
``SuperLearnerPool.reset()``.
"""

from tpfl_torch.simulation.batched_fit import serve_pool_shards
from tpfl_torch.simulation.pool import SuperLearnerPool
from tpfl_torch.simulation.virtual_learner import (
    VirtualNodeLearner,
    try_init_learner_with_simulation,
)

__all__ = [
    "SuperLearnerPool",
    "VirtualNodeLearner",
    "try_init_learner_with_simulation",
]
