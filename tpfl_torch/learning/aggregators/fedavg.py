"""FedAvg — sample-weighted parameter mean (McMahan et al. 2016), the port
of :mod:`tpfl.learning.aggregators.fedavg`.

Contributions fold into a running ``(Σ w_i·x_i, Σ x_i, Σ w_i, n)``
accumulator on the aggregator's device, updated in place — peak memory
is one model's accumulator whatever the contributor count. Sums are in
``promote(dtype, f32)``; each fold rounds the product and then the sum,
as the reference writes it. All-zero sample counts finalize to the
uniform mean (the unweighted sum rides along), never NaN.
"""

from __future__ import annotations

import numpy as np
import torch

from tpfl_torch.learning.aggregators.aggregator import Aggregator, AggStream, on_device
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.utils.tree import canonical_map


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


class FedAvg(Aggregator):
    """Weighted average of models (partial aggregation supported)."""

    SUPPORTS_PARTIAL_AGGREGATION = True
    SUPPORTS_STREAMING = True

    def acc_init(self, template: TpflModel) -> AggStream:
        return AggStream(template)

    def accumulate(self, state: AggStream, model: TpflModel, weight: "float | None" = None,
                   staleness: int = 0) -> AggStream:
        w = np.float32(model.get_num_samples() if weight is None else weight)
        params = on_device(model.get_parameters(), self.device)
        with torch.no_grad():
            if state.acc is None:
                swx = canonical_map(lambda x: x.to(_acc_dtype(x)) * float(w), params)
                sx = canonical_map(lambda x: x.to(_acc_dtype(x), copy=True), params)
                state.acc = [swx, sx, w, np.float32(1.0)]
            else:
                swx, sx, total, n = state.acc
                canonical_map(lambda s, x: s.add_(x.to(s.dtype) * float(w)), swx, params)
                canonical_map(lambda s, x: s.add_(x.to(s.dtype)), sx, params)
                state.acc[2:] = [np.float32(total + w), np.float32(n + np.float32(1.0))]
        state.contributors.update(model.get_contributors())
        state.num_samples += model.get_num_samples()
        state.count += 1
        state.offered += 1
        return state

    def finalize(self, state: AggStream) -> TpflModel:
        if state.acc is None:
            raise ValueError("No models to aggregate")
        swx, sx, total, n = state.acc
        state.acc = None  # single use
        template = on_device(state.template.get_parameters(), self.device)
        if total > 0:
            num, den = swx, float(max(total, np.float32(1.0)))
        else:
            num, den = sx, float(max(n, np.float32(1.0)))
        with torch.no_grad():
            avg = canonical_map(lambda s, t: (s / den).to(t.dtype), num, template)
        return state.template.build_copy(
            params=avg,
            contributors=sorted(state.contributors),
            num_samples=int(state.num_samples),
        )
