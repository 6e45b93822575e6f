"""Learner callbacks + factory — the port of :mod:`tpfl.learning.callbacks`.

Aggregators declare required callbacks by name
(``Aggregator.get_required_callbacks``), the factory instantiates them,
and callback state rides between learner and aggregator inside
``TpflModel.additional_info``. A callback contributes a
gradient-correction tree that the learner's train step adds to every
gradient, and a proximal coefficient for the FedProx pull.

Trees are walked in JAX's pytree order (:func:`canonical_map`), so the
info a callback ships encodes to the reference's bytes. Info that
arrived over the wire holds numpy leaves; the callbacks bring them to
the device of the tensors they meet.
"""

from __future__ import annotations

from abc import ABC
from typing import Any, Optional

import torch

from tpfl_torch.learning.model import to_device
from tpfl_torch.utils.tree import canonical_map


def _like(x: Any, ref: torch.Tensor) -> torch.Tensor:
    """``x`` (a tensor or a wire-decoded array) as a tensor on ``ref``'s
    device, in its own dtype."""
    return to_device([x], ref.device)[0]


class TpflCallback(ABC):
    """Base callback. Subclasses override the hooks they need; all state
    they want shipped to the aggregator goes through
    ``get_info``/``set_info``."""

    name: str = "base"

    #: Subclasses that need ``avg_grad`` in ``on_fit_end`` set this.
    wants_avg_grad: bool = False

    def __init__(self) -> None:
        self._info: dict[str, Any] = {}

    def get_name(self) -> str:
        return self.name

    def get_info(self) -> dict[str, Any]:
        # Shallow copy: the returned dict is stored into models that may
        # sit in aggregator queues or serialize on other threads while
        # the next round's on_fit_end rebinds these keys.
        return dict(self._info)

    def set_info(self, info: dict[str, Any]) -> None:
        self._info = dict(info)

    # --- learner hooks ---

    def on_fit_start(self, params: Any, learning_rate: float) -> None:
        """Called with round-start parameters before the first step."""

    def grad_correction(self, params: Any) -> Optional[Any]:
        """Tree added to every gradient by the train step, or None."""
        return None

    def prox_mu(self) -> float:
        """Proximal coefficient: the train step adds ``mu * (w_t -
        w_round_start)`` to every gradient (FedProx); 0 disables it."""
        return 0.0

    def on_fit_end(
        self,
        initial_params: Any,
        final_params: Any,
        num_steps: int,
        learning_rate: float,
        avg_grad: Any = None,
    ) -> None:
        """Called after the last step with start/end parameters.
        ``avg_grad``: the mean RAW mini-batch gradient over the fit —
        given only when the class sets ``wants_avg_grad``."""


class ScaffoldCallback(TpflCallback):
    """Client-side SCAFFOLD (Karimireddy et al. 2019).

    Receives the global control variate ``c`` from the aggregator via
    ``set_info({"global_c": ...})``; corrects every gradient by ``c -
    c_i``; after local training sets its own variate by option II from
    the average raw gradient the learner measured (exact under any
    optimizer, momentum included) and ships ``delta_y_i`` / ``delta_c_i``.
    """

    name = "scaffold"
    wants_avg_grad = True

    def __init__(self) -> None:
        super().__init__()
        self.c_i: Optional[Any] = None  # local control variate

    def on_fit_start(self, params: Any, learning_rate: float) -> None:
        if self.c_i is None:
            self.c_i = canonical_map(torch.zeros_like, params)
        if self._info.get("global_c") is None:
            self._info["global_c"] = canonical_map(torch.zeros_like, params)

    def grad_correction(self, params: Any) -> Any:
        def corr(c: Any, ci: torch.Tensor) -> torch.Tensor:
            c = _like(c, ci)
            return (c - ci).to(c.dtype)

        return canonical_map(corr, self._info["global_c"], self.c_i)

    def on_fit_end(
        self,
        initial_params: Any,
        final_params: Any,
        num_steps: int,
        learning_rate: float,
        avg_grad: Any = None,
    ) -> None:
        c = self._info["global_c"]
        delta_y = canonical_map(lambda y, x: y - x, final_params, initial_params)
        if avg_grad is not None:
            # Option II with exact accounting: the average raw mini-batch
            # gradient along the local trajectory.
            new_c_i = canonical_map(lambda g, ci: g.to(ci.dtype), avg_grad, self.c_i)
        else:
            # Displacement fallback (exact only for vanilla SGD):
            # c_i+ = c_i - c + (x - y_i) / (K * lr)
            scale = 1.0 / max(num_steps * learning_rate, 1e-12)
            new_c_i = canonical_map(
                lambda ci, cg, dy: ci - _like(cg, ci) - scale * dy, self.c_i, c, delta_y
            )
        delta_c = canonical_map(lambda n, o: n - o, new_c_i, self.c_i)
        self.c_i = new_c_i
        self._info["delta_y_i"] = delta_y
        self._info["delta_c_i"] = delta_c


class FedProxCallback(TpflCallback):
    """Client-side FedProx (Li et al. 2018): ``mu * (w_t -
    w_round_start)`` added to every gradient. The FedProx aggregator
    ships its ``proximal_mu`` inside the aggregated model's info
    (``{"mu": ...}``); until the first aggregate arrives the default
    below applies."""

    name = "fedprox"
    DEFAULT_MU = 0.01

    def prox_mu(self) -> float:
        return float(self._info.get("mu", self.DEFAULT_MU))


class CallbackFactory:
    """Name → callback class registry."""

    _registry: dict[str, type[TpflCallback]] = {}

    @classmethod
    def register(cls, callback_cls: type[TpflCallback]) -> type[TpflCallback]:
        cls._registry[callback_cls.name] = callback_cls
        return callback_cls

    @classmethod
    def create(cls, names: list[str]) -> list[TpflCallback]:
        missing = [n for n in names if n not in cls._registry]
        if missing:
            raise KeyError(
                f"Unknown callbacks {missing}; registered: {sorted(cls._registry)}"
            )
        return [cls._registry[n]() for n in names]


CallbackFactory.register(ScaffoldCallback)
CallbackFactory.register(FedProxCallback)

__all__ = ["CallbackFactory", "FedProxCallback", "ScaffoldCallback", "TpflCallback"]
