"""VirtualNodeLearner — the learner decorator that routes fits to the
pool, the port of :mod:`tpfl.simulation.virtual_learner`.

It wraps any :class:`~tpfl_torch.learning.learner.Learner` and delegates
everything, but ``fit()`` goes through the shared
:class:`~tpfl_torch.simulation.pool.SuperLearnerPool`, so concurrent fits
of the process's nodes batch into one node-stacked program.
``interrupt_fit`` reaches the inner learner: an interrupt delivered
before the chunk is dispatched skips that node's training (zero
contribution); a dispatched chunk runs to its end.
:func:`try_init_learner_with_simulation` wraps a learner unless
``Settings.DISABLE_SIMULATION``, as the reference's activation hook does.
"""

from __future__ import annotations

import weakref
from typing import Optional, Union

from tpfl_torch.learning.dataset.tpfl_dataset import TpflDataset
from tpfl_torch.learning.learner import Learner
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.settings import Settings
from tpfl_torch.simulation.pool import SuperLearnerPool

_live_learners: "weakref.WeakSet[VirtualNodeLearner]" = weakref.WeakSet()


class VirtualNodeLearner(Learner):
    """Decorator: the same Learner surface, pooled execution."""

    def __init__(self, learner: Learner) -> None:
        # No super().__init__: all state lives in the wrapped learner.
        self.learner = learner
        self._group_hint: "int | list[str]" = 0
        self._last_fit_model = None
        _live_learners.add(self)

    @staticmethod
    def live_count() -> int:
        """Upper bound on the in-process simulated nodes: caps how long
        the pool waits for a hinted fit group to fill."""
        return len(_live_learners)

    # --- pooled execution ---

    def set_fit_group_hint(self, peers: "int | list[str]") -> None:
        self._group_hint = peers

    def fit(self) -> TpflModel:
        hint = self._group_hint
        if not isinstance(hint, int):
            # Exact local group size: only the train-set members hosted in
            # THIS process submit fits here.
            local = {ln.get_addr() for ln in _live_learners}
            hint = len(set(hint) & local)
        return SuperLearnerPool.instance().submit_fit(self.learner, group_hint=hint)

    def interrupt_fit(self) -> None:
        self.learner.interrupt_fit()

    def evaluate(self) -> dict[str, float]:
        return self.learner.evaluate()

    # --- pure delegation ---

    @property  # type: ignore[override]
    def callbacks(self):
        return self.learner.callbacks

    @property  # type: ignore[override]
    def epochs(self) -> int:
        return self.learner.epochs

    def set_addr(self, addr: str) -> None:
        self.learner.set_addr(addr)

    def get_addr(self) -> str:
        return self.learner.get_addr()

    def set_model(self, model: Union[TpflModel, list, bytes]) -> None:
        self.learner.set_model(model)

    def get_model(self) -> TpflModel:
        return self.learner.get_model()

    def set_data(self, data: TpflDataset) -> None:
        self.learner.set_data(data)

    def get_data(self) -> TpflDataset:
        return self.learner.get_data()

    def set_epochs(self, epochs: int) -> None:
        self.learner.set_epochs(epochs)

    def update_callbacks_with_model_info(self) -> None:
        self.learner.update_callbacks_with_model_info()

    def add_callback_info_to_model(self, model: Optional[TpflModel] = None) -> None:
        self.learner.add_callback_info_to_model(model)

    def get_framework(self) -> str:
        return self.learner.get_framework()

    def get_num_samples(self) -> int:
        return self.learner.get_num_samples()


def try_init_learner_with_simulation(learner: Learner) -> Learner:
    """Wrap ``learner`` for pooled simulation unless
    ``Settings.DISABLE_SIMULATION`` (or it is wrapped already)."""
    if Settings.DISABLE_SIMULATION or isinstance(learner, VirtualNodeLearner):
        return learner
    return VirtualNodeLearner(learner)
