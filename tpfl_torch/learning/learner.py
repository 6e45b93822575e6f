"""Learner ABC — the local train/eval seam, the port of
:mod:`tpfl.learning.learner`.

Parity with the reference ``p2pfl/learning/frameworks/learner.py:33``:

- ``set_model`` accepting model / flat list / wire bytes  (learner.py:66-80)
- callback info sync to/from the model                    (learner.py:122-135)
- abstract ``fit`` / ``interrupt_fit`` / ``evaluate`` /
  ``get_framework``                                       (learner.py:137-167)

Aggregators declare which callbacks a learner must run.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Optional, Union

from tpfl_torch.learning import serialization
from tpfl_torch.learning.callbacks import CallbackFactory, TpflCallback
from tpfl_torch.learning.dataset.tpfl_dataset import TpflDataset
from tpfl_torch.learning.model import TpflModel


class Learner(ABC):
    """Template for local training/evaluation on one node."""

    def __init__(
        self,
        model: Optional[TpflModel] = None,
        data: Optional[TpflDataset] = None,
        addr: str = "unknown-node",
        aggregator: Optional[Any] = None,
    ) -> None:
        self._model = model
        self._data = data
        self._addr = addr
        self.epochs: int = 1
        # The model the most recent fit produced — what fit callers must
        # consume (learner._model may be rebound by a concurrent
        # full-model delivery; see TorchLearner.finish_fit).
        self._last_fit_model: Optional[TpflModel] = None
        # Build the callbacks the aggregator requires (reference
        # learner.py:52-53 via CallbackFactory).
        names = aggregator.get_required_callbacks() if aggregator else []
        self.callbacks: list[TpflCallback] = CallbackFactory.create(names)
        for cb in self.callbacks:
            info = aggregator.initial_callback_info(cb.get_name())
            if info:
                cb.set_info(info)

    # --- wiring ---

    def set_addr(self, addr: str) -> None:
        self._addr = addr

    def get_addr(self) -> str:
        return self._addr

    def set_model(self, model: Union[TpflModel, list, bytes]) -> None:
        """Accept a full model, flat param list, or wire bytes
        (reference learner.py:66-80)."""
        if isinstance(model, TpflModel):
            self._model = model
        else:
            if self._model is None:
                raise ValueError("No base model to set parameters into")
            if isinstance(model, bytes) or serialization.is_byref(model):
                # REBIND, don't mutate: wire payloads (encoded bytes OR
                # a zero-copy InprocModelRef) carry contributors +
                # info, and the current object may be mid-fit on the
                # training thread (a lapped trainer receiving the round's
                # full model). Overwriting it in place would poison the
                # fit's returned contribution with the aggregate's
                # metadata (contributors = whole train set).
                self._model = self._model.build_copy(params=model)
            else:
                self._model.set_parameters(model)
        self.update_callbacks_with_model_info()

    def get_model(self) -> TpflModel:
        if self._model is None:
            raise ValueError("Learner has no model")
        return self._model

    def set_data(self, data: TpflDataset) -> None:
        self._data = data

    def get_data(self) -> TpflDataset:
        if self._data is None:
            raise ValueError("Learner has no data")
        return self._data

    def set_epochs(self, epochs: int) -> None:
        self.epochs = int(epochs)

    def set_fit_group_hint(self, peers: "int | list[str]") -> None:
        """Hint which peers (the round's train set, as addresses) — or
        how many — will call ``fit`` around the same time. Default:
        ignored; the simulation layer's ``VirtualNodeLearner`` hands it
        to the pool, which batches such groups."""

    # --- callback info transport (reference learner.py:122-135) ---

    def update_callbacks_with_model_info(self) -> None:
        """Push aggregator-sent state (model.additional_info) into the
        matching callbacks."""
        if self._model is None:
            return
        for cb in self.callbacks:
            info = self._model.get_info().get(cb.get_name())
            if info is not None:
                cb.set_info(info)

    def add_callback_info_to_model(self, model: "Optional[TpflModel]" = None) -> None:
        """Collect callback state into the model for the aggregator.

        ``model`` defaults to the learner's current model, but fit paths
        must pass the model they actually trained — the learner's may
        have been rebound to the round aggregate by a concurrent
        FullModelCommand (lapped trainer)."""
        model = model if model is not None else self._model
        if model is None:
            return
        for cb in self.callbacks:
            model.add_info(cb.get_name(), cb.get_info())

    # --- abstract (reference learner.py:137-167) ---

    @abstractmethod
    def fit(self) -> TpflModel:
        """Train locally for ``self.epochs``; returns the updated model."""

    @abstractmethod
    def interrupt_fit(self) -> None:
        """Request an early stop of a running fit."""

    @abstractmethod
    def evaluate(self) -> dict[str, float]:
        """Compute eval metrics on the local test split."""

    def get_framework(self) -> str:
        return "torch"

    def get_num_samples(self) -> int:
        return self.get_data().num_samples(True)


__all__ = ["Learner"]
