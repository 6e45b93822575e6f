"""SCAFFOLD — stochastic controlled averaging (Karimireddy et al. 2019),
the port of :mod:`tpfl.learning.aggregators.scaffold`.

No partial aggregation; the aggregator keeps the global control variate
``c`` and a simulated global model; it consumes ``delta_y_i`` /
``delta_c_i`` from each model's ``additional_info`` (shipped by the
required ``scaffold`` learner callback) and emits ``global_c`` back.
The variate means are running sums on the aggregator's device (in
place, f32-promoted). Update rule (option II, as the reference)::

    x <- x + eta_g * mean_i(delta_y_i)
    c <- c + mean_i(delta_c_i)
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from tpfl_torch import DeviceLike
from tpfl_torch.learning.aggregators.aggregator import Aggregator, AggStream, on_device
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.utils.tree import canonical_map

INFO_KEY = "scaffold"


def _axpy(a: float, x: Any, y: Any) -> Any:
    """``y + a * x`` over trees, in y's dtypes."""
    return canonical_map(lambda xi, yi: (yi + a * xi).to(yi.dtype), x, y)


def _promoted(t: Any) -> Any:
    return canonical_map(
        lambda x: x.to(torch.promote_types(x.dtype, torch.float32), copy=True), t)


class Scaffold(Aggregator):
    """Controlled averaging with global/local control variates."""

    SUPPORTS_PARTIAL_AGGREGATION = False
    SUPPORTS_STREAMING = True
    REQUIRED_CALLBACKS = ["scaffold"]

    def __init__(self, node_name: str = "unknown", global_lr: float = 1.0,
                 device: DeviceLike = None) -> None:
        super().__init__(node_name, device=device)
        self.global_lr = float(global_lr)
        self._global_params: Optional[Any] = None
        self._c: Optional[Any] = None

    def _client_deltas(self, m: TpflModel) -> tuple[Any, Any]:
        info = m.get_info().get(INFO_KEY)
        if not info or "delta_y_i" not in info or "delta_c_i" not in info:
            raise ValueError(
                "SCAFFOLD requires delta_y_i/delta_c_i in model info "
                "(is the 'scaffold' callback registered on the learner?) "
                f"— offending model contributors={m.get_contributors()}, "
                f"info keys={sorted(m.get_info() or {})}"
            )
        return on_device(info["delta_y_i"], self.device), on_device(info["delta_c_i"],
                                                                    self.device)

    def acc_init(self, template: TpflModel) -> AggStream:
        return AggStream(template)

    @torch.no_grad()
    def accumulate(self, state: AggStream, model: TpflModel, weight: "float | None" = None,
                   staleness: int = 0) -> AggStream:
        state.offered += 1
        # Skipped fits (num_samples == 0) carry no fresh deltas and must
        # not pull the control variates toward zero: ignore them.
        if model.get_num_samples() <= 0:
            return state
        dy, dc = self._client_deltas(model)
        if state.acc is None:
            state.acc = (_promoted(dy), _promoted(dc))
            # The common round-start point x from any client:
            # y_i = x + delta_y_i  =>  x = y_0 - delta_y_0.
            if self._global_params is None:
                state.extra["x0"] = canonical_map(
                    lambda y, d: y - d.to(y.dtype),
                    on_device(model.get_parameters(), self.device), dy)
            state.template = model
        else:
            for s, x in ((state.acc[0], dy), (state.acc[1], dc)):
                canonical_map(lambda a, b: a.add_(b.to(a.dtype)), s, x)
        state.contributors.update(model.get_contributors())
        state.num_samples += model.get_num_samples()
        state.count += 1
        return state

    @torch.no_grad()
    def finalize(self, state: AggStream) -> TpflModel:
        if state.count == 0 or state.acc is None:
            raise ValueError(
                "No trained models to aggregate (all contributions have num_samples == 0)"
            )
        n = float(np.float32(state.count))
        mean_dy, mean_dc = (canonical_map(lambda x: x / n, t) for t in state.acc)
        state.acc = None  # single use

        if self._global_params is None:
            self._global_params = state.extra["x0"]
        self._global_params = _axpy(self.global_lr, mean_dy, self._global_params)
        if self._c is None:
            self._c = canonical_map(torch.zeros_like, mean_dc)
        self._c = _axpy(1.0, mean_dc, self._c)

        out = state.template.build_copy(
            params=self._global_params,
            contributors=sorted(state.contributors),
            num_samples=int(state.num_samples),
        )
        out.add_info(INFO_KEY, {"global_c": self._c})
        return out

    def clear(self) -> None:
        # Keep the control variates across rounds; only the per-round
        # intake state resets.
        super().clear()
