"""The simulation layer's activation hook — the port of
:func:`tpfl.simulation.try_init_learner_with_simulation`.

The reference wraps every node's learner in a ``VirtualNodeLearner`` that
batches concurrent fits of in-process nodes into one vmapped program
unless ``Settings.DISABLE_SIMULATION``. The pooled learner is not ported
(``ROADMAP.md`` §1 item 5): with the knob off the hook raises, and a
federation of the port's nodes runs with ``DISABLE_SIMULATION = True``,
each node fitting on its own, as the reference's unpooled path does.
"""

from __future__ import annotations

from typing import Any

from tpfl_torch.exceptions import SIMULATION_ITEM, not_ported
from tpfl_torch.settings import Settings


def try_init_learner_with_simulation(learner: Any) -> Any:
    """``learner`` unchanged under ``Settings.DISABLE_SIMULATION``; the
    pooled simulation learner otherwise, which is not ported."""
    if Settings.DISABLE_SIMULATION:
        return learner
    raise not_ported(
        "the pooled simulation learner (VirtualNodeLearner; set "
        "Settings.DISABLE_SIMULATION = True to run each node's learner on its own)",
        SIMULATION_ITEM)


__all__ = ["try_init_learner_with_simulation"]
