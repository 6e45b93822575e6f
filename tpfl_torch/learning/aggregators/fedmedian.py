"""FedMedian — element-wise median across models (Yin et al. 2018), the
port of :mod:`tpfl.learning.aggregators.fedmedian`.

The streaming state keeps a **bounded reservoir**
(``Settings.AGG_MEDIAN_RESERVOIR``, seeded reservoir sampling beyond the
cap, seed ``(Settings.SEED or 0) ^ crc32(node_name)``); the median is
exact up to the cap. The median is ``jnp.median``'s: in f32, the mean
of the two middle values for an even count (``torch.median`` would give
the lower one), cast back to the leaf's dtype.
"""

from __future__ import annotations

import random
import zlib

import torch

from tpfl_torch.learning.aggregators.aggregator import Aggregator, AggStream, on_device
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import canonical_map


def median(stacked: torch.Tensor) -> torch.Tensor:
    """``jnp.median(x.astype(f32), axis=0).astype(x.dtype)``: the
    midpoint ``(lo + hi) · 0.5`` of the two middle order statistics (one
    and the same for an odd count)."""
    n = stacked.shape[0]
    s = torch.sort(stacked.to(torch.float32), dim=0).values
    lo, hi = s[(n - 1) // 2], s[n // 2]
    return ((lo + hi) * 0.5).to(stacked.dtype)


class FedMedian(Aggregator):
    """Element-wise median (unweighted; robust to outliers)."""

    SUPPORTS_PARTIAL_AGGREGATION = False
    SUPPORTS_STREAMING = True

    def acc_init(self, template: TpflModel) -> AggStream:
        st = AggStream(template)
        st.extra["reservoir"] = []
        st.extra["rng"] = random.Random((Settings.SEED or 0) ^ zlib.crc32(self.node_name.encode()))
        return st

    def accumulate(self, state: AggStream, model: TpflModel, weight: "float | None" = None,
                   staleness: int = 0) -> AggStream:
        reservoir: list = state.extra["reservoir"]
        cap = max(1, int(Settings.AGG_MEDIAN_RESERVOIR))
        if len(reservoir) < cap:
            reservoir.append(model.get_parameters())
        else:
            # Vitter's algorithm R: every contribution seen so far has
            # equal probability of being in the reservoir.
            j = state.extra["rng"].randint(0, state.count)
            if j < cap:
                reservoir[j] = model.get_parameters()
        state.contributors.update(model.get_contributors())
        state.num_samples += model.get_num_samples()
        state.count += 1
        state.offered += 1
        return state

    @torch.no_grad()
    def finalize(self, state: AggStream) -> TpflModel:
        reservoir = state.extra.get("reservoir") or []
        if not reservoir:
            raise ValueError("No models to aggregate")
        trees = [on_device(p, self.device) for p in reservoir]
        med = canonical_map(lambda *xs: median(torch.stack(xs)), *trees)
        return state.template.build_copy(
            params=med,
            contributors=sorted(state.contributors),
            num_samples=int(state.num_samples),
        )
