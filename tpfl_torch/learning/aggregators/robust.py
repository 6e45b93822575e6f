"""Byzantine-robust aggregators — Krum, Multi-Krum, trimmed mean — the
port of :mod:`tpfl.learning.aggregators.robust`: streaming over a bounded
per-round candidate buffer and quarantine-aware, as torch ops on the
aggregator's device.

- Krum / Multi-Krum keep each arrival as one row of a ``(cap, p)`` f32
  matrix on the device (plus the candidate's parameter tree for the final
  selection); the scores come from one Gram product,
  ``d²(i, j) = |x_i|² + |x_j|² − 2·x_i·x_j``, run with TF32 off — the
  cancellation in that sum needs every f32 bit, or the pick drifts from
  the reference's and from a plain f64 scoring.
- Trimmed mean keeps a per-leaf ``(cap, *leaf.shape)`` reservoir in the
  leaves' own dtypes and sorts it in f32 at finalize.

Past ``Settings.AGG_ROBUST_BUFFER`` candidates both use seeded Vitter
reservoir replacement (Python ``random`` seeded with ``(Settings.SEED or
0) ^ crc32(node_name)``, the reference's stream), so the kept peers are
the reference's. When a quarantine engine is attached (and
``Settings.QUARANTINE_ENABLED``), peers quarantined after their
contribution was buffered are dropped before scoring / the trimmed sort;
a shrink that would empty the set fails open.

Preconditions are validated, not clamped: Krum with ``n < 2f + 3``
warns and bumps ``tpfl_agg_krum_underprovisioned_total``; a trimmed mean
with ``n ≤ 2·trim`` cannot trim, warns and counts
``tpfl_agg_trimmed_no_trim_total``; the ``tpfl_agg_effective_trim``
gauge carries the trim applied.

Staleness-aware (async buffered rounds): every buffered candidate
carries its version distance τ (``accumulate(..., staleness=)``). At
finalize, candidates past ``Settings.ASYNC_STALENESS_MAX`` are rejected
before any scoring (τ == max is kept; an all-stale buffer fails open),
Krum / Multi-Krum scores are multiplied by ``(1+τ)^ASYNC_STALENESS_EXP``,
and Multi-Krum's average discounts each selected model's sample weight by
``staleness_weight(τ)``. Synchronous rounds see τ = 0 everywhere, where
all three are the identity.

- Krum / Multi-Krum: Blanchard et al. 2017.
- Trimmed mean: Yin et al. 2018.
"""

from __future__ import annotations

import contextlib
import random
import time
import zlib
from typing import Any, Iterator

import numpy as np
import torch

from tpfl_torch import DeviceLike
from tpfl_torch.learning.aggregators.aggregator import (
    Aggregator,
    AggStream,
    on_device,
    staleness_weight,
)
from tpfl_torch.learning.aggregators.fedavg import acc_finalize, acc_first, acc_update
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.management.logger import logger
from tpfl_torch.management.telemetry import flight
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import canonical_leaves, canonical_map


@contextlib.contextmanager
def _no_tf32() -> Iterator[None]:
    """f32 matmuls in full f32 inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def flatten_one(params: Any, device: torch.device) -> torch.Tensor:
    """One tree as a ``(total_params,)`` f32 vector, leaves in JAX's
    pytree order."""
    return torch.cat([x.reshape(-1).to(torch.float32)
                      for x in canonical_leaves(on_device(params, device))])


@torch.no_grad()
def krum_scores(flat: torch.Tensor, n_byzantine: int) -> torch.Tensor:
    """Krum score per row: the sum of squared distances to its
    ``n − f − 2`` closest other rows (at least 1), distances from the
    Gram matrix."""
    with _no_tf32():
        sq = torch.sum(flat * flat, dim=1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (flat @ flat.T)
    n = flat.shape[0]
    d2.fill_diagonal_(float("inf"))
    k = max(n - n_byzantine - 2, 1)
    nearest = torch.sort(d2, dim=1).values[:, :k]
    return torch.sum(nearest, dim=1)


@torch.no_grad()
def trimmed_mean(x: torch.Tensor, trim: int) -> torch.Tensor:
    """Coordinate-wise mean over the leading axis after dropping the
    ``trim`` smallest and largest values (none when ``n ≤ 2·trim``), in
    f32, cast back to ``x``'s dtype."""
    xs = torch.sort(x.to(torch.float32), dim=0).values
    n = xs.shape[0]
    kept = xs[trim:n - trim] if n > 2 * trim else xs
    return torch.mean(kept, dim=0).to(x.dtype)


def krum_requirement_met(n: int, n_byzantine: int) -> bool:
    """Blanchard et al.'s Krum precondition: ``n >= 2f + 3``."""
    return n >= 2 * n_byzantine + 3


class _RobustStream(Aggregator):
    """The robust family's bounded-candidate streaming: seeded reservoir
    slotting, per-candidate contributor / weight bookkeeping, the
    quarantine shrink at finalize. Subclasses implement ``_buffer_write``
    and ``_finalize_kept``."""

    SUPPORTS_PARTIAL_AGGREGATION = False
    SUPPORTS_STREAMING = True

    def acc_init(self, template: TpflModel) -> AggStream:
        st = AggStream(template)
        st.extra["peers"] = []  # contributor tuple per slot
        st.extra["weights"] = []  # num_samples per slot
        st.extra["params"] = []  # parameter tree per slot
        st.extra["taus"] = []  # staleness ordinal per slot (async τ)
        st.extra["rng"] = random.Random((Settings.SEED or 0) ^ zlib.crc32(self.node_name.encode()))
        return st

    def accumulate(self, state: AggStream, model: TpflModel, weight: "float | None" = None,
                   staleness: int = 0) -> AggStream:
        cap = max(1, int(Settings.AGG_ROBUST_BUFFER))
        peers = state.extra["peers"]
        if len(peers) < cap:
            slot = len(peers)
            peers.append(tuple(sorted(model.get_contributors())))
            state.extra["weights"].append(int(model.get_num_samples()))
            state.extra["params"].append(model.get_parameters())
            state.extra["taus"].append(int(staleness))
        else:
            # Vitter's algorithm R: every candidate seen so far has equal
            # probability of holding a slot; deterministic under SEED.
            j = state.extra["rng"].randint(0, state.count)
            slot = j if j < cap else None
            if slot is not None:
                peers[slot] = tuple(sorted(model.get_contributors()))
                state.extra["weights"][slot] = int(model.get_num_samples())
                state.extra["params"][slot] = model.get_parameters()
                state.extra["taus"][slot] = int(staleness)
        if slot is not None:
            self._buffer_write(state, model, slot, cap)
        state.contributors.update(model.get_contributors())
        state.num_samples += model.get_num_samples()
        state.count += 1
        state.offered += 1
        return state

    def _buffer_write(self, state: AggStream, model: TpflModel, slot: int, cap: int) -> None:
        raise NotImplementedError

    def _kept_slots(self, state: AggStream) -> list[int]:
        """Candidate slots surviving the finalize-time shrinks, in order:
        quarantine verdicts that landed after a contribution was
        buffered, then candidates whose τ exceeds
        ``Settings.ASYNC_STALENESS_MAX`` (negative disables it). Each
        fails open (its input slots kept, a warning) when it would empty
        the set."""
        peers = state.extra["peers"]
        kept = list(range(len(peers)))
        quarantined = self.quarantined_peers()
        if quarantined:
            clean = [i for i in kept if not (set(peers[i]) & quarantined)]
            if not clean and kept:
                logger.warning(self.node_name,
                               f"Quarantine would drop every {type(self).__name__} "
                               "candidate; failing open to the full buffer")
            else:
                if len(clean) < len(kept):
                    logger.metrics.counter("tpfl_agg_candidates_shrunk_total",
                                           value=len(kept) - len(clean),
                                           labels={"node": self.node_name})
                kept = clean
        max_tau = int(Settings.ASYNC_STALENESS_MAX)
        taus = state.extra["taus"]
        if max_tau >= 0 and any(taus[i] > max_tau for i in kept):
            fresh = [i for i in kept if taus[i] <= max_tau]
            if not fresh:
                logger.warning(self.node_name,
                               f"Every {type(self).__name__} candidate is past "
                               f"ASYNC_STALENESS_MAX ({max_tau}); failing open to the "
                               "quarantine-kept buffer")
            else:
                logger.metrics.counter("tpfl_agg_stale_rejected_total",
                                       value=len(kept) - len(fresh),
                                       labels={"node": self.node_name})
                kept = fresh
        return kept

    def finalize(self, state: AggStream) -> TpflModel:
        if not state.extra.get("peers"):
            raise ValueError("No models to aggregate")
        return self._finalize_kept(state, self._kept_slots(state))

    def _finalize_kept(self, state: AggStream, kept: list[int]) -> TpflModel:
        raise NotImplementedError


class Krum(_RobustStream):
    """Select the single model closest to its peers, over the bounded
    streaming candidate buffer."""

    def __init__(self, node_name: str = "unknown", n_byzantine: int = 1,
                 device: DeviceLike = None) -> None:
        super().__init__(node_name, device=device)
        self.n_byzantine = int(n_byzantine)

    def _buffer_write(self, state: AggStream, model: TpflModel, slot: int, cap: int) -> None:
        row = flatten_one(model.get_parameters(), self.device)
        buf = state.extra.get("flat")
        if buf is None:
            buf = state.extra["flat"] = torch.zeros((cap, row.shape[0]), dtype=torch.float32,
                                                    device=self.device)
        buf[slot].copy_(row)

    def _check_preconditions(self, n: int) -> None:
        if not krum_requirement_met(n, self.n_byzantine):
            logger.warning(
                self.node_name,
                f"Krum under-provisioned: {n} candidates < 2*{self.n_byzantine}+3 "
                "(Blanchard's n >= 2f+3) — the n-f-2 neighborhood degenerates and the "
                "selection guarantee does not hold; lower n_byzantine or widen the train set",
            )
            logger.metrics.counter("tpfl_agg_krum_underprovisioned_total",
                                   labels={"node": self.node_name})

    def _scores(self, state: AggStream, kept: list[int]) -> torch.Tensor:
        """Krum scores over the kept candidate rows, each multiplied by
        ``(1+τ)^ASYNC_STALENESS_EXP`` (distance alone is blind to a
        replayed old model inside the honest cluster of its own
        version); τ = 0 everywhere multiplies by exactly 1."""
        flat = state.extra["flat"][:len(state.extra["peers"])]
        if len(kept) < flat.shape[0]:
            flat = flat[torch.tensor(kept, dtype=torch.long, device=flat.device)]
        scores = krum_scores(flat, self.n_byzantine)
        taus = [state.extra["taus"][i] for i in kept]
        if any(taus):
            exp = float(Settings.ASYNC_STALENESS_EXP)
            scores = scores * torch.tensor([(1.0 + float(t)) ** exp for t in taus],
                                           dtype=torch.float32, device=scores.device)
        return scores

    def _finalize_kept(self, state: AggStream, kept: list[int]) -> TpflModel:
        self._check_preconditions(len(kept))
        best = kept[0] if len(kept) == 1 else kept[int(torch.argmin(self._scores(state, kept)))]
        return state.template.build_copy(
            params=state.extra["params"][best],
            contributors=sorted(state.contributors),
            num_samples=state.extra["weights"][best],
        )


class MultiKrum(Krum):
    """Sample-weighted average of the ``m`` best-scored models (FedAvg's
    fold steps over the selected candidates, in slot order). The
    aggregate's metadata keeps the full input picture: contributors =
    every input's union, num_samples = every input's total."""

    def __init__(self, node_name: str = "unknown", n_byzantine: int = 1, m: int = 2,
                 device: DeviceLike = None) -> None:
        super().__init__(node_name, n_byzantine, device=device)
        self.m = int(m)

    def _finalize_kept(self, state: AggStream, kept: list[int]) -> TpflModel:
        self._check_preconditions(len(kept))
        if len(kept) <= self.m:
            selected = kept
        else:
            order = torch.argsort(self._scores(state, kept), stable=True)[:self.m]
            selected = [kept[int(i)] for i in order]
        acc = None
        for i in sorted(selected):  # canonical fold order
            w = np.float32(state.extra["weights"][i] * staleness_weight(state.extra["taus"][i]))
            p = on_device(state.extra["params"][i], self.device)
            acc = acc_first(p, w) if acc is None else acc_update(acc, p, w)
        avg = acc_finalize(acc, on_device(state.template.get_parameters(), self.device))
        return state.template.build_copy(
            params=avg,
            contributors=sorted(state.contributors),
            num_samples=int(state.num_samples),
        )


class TrimmedMean(_RobustStream):
    """Coordinate-wise mean after trimming the ``trim`` extremes per
    side, over a bounded per-leaf streaming reservoir."""

    def __init__(self, node_name: str = "unknown", trim: int = 1,
                 device: DeviceLike = None) -> None:
        super().__init__(node_name, device=device)
        self.trim = int(trim)

    @torch.no_grad()
    def _buffer_write(self, state: AggStream, model: TpflModel, slot: int, cap: int) -> None:
        params = on_device(model.get_parameters(), self.device)
        bufs = state.extra.get("leaf_bufs")
        if bufs is None:
            bufs = state.extra["leaf_bufs"] = canonical_map(
                lambda x: torch.zeros((cap,) + tuple(x.shape), dtype=x.dtype, device=self.device),
                params)
        canonical_map(lambda b, x: b[slot].copy_(x.to(b.dtype)), bufs, params)

    def _finalize_kept(self, state: AggStream, kept: list[int]) -> TpflModel:
        n = len(state.extra["peers"])
        effective = self.trim if len(kept) > 2 * self.trim else 0
        labels = {"node": self.node_name}
        logger.metrics.gauge("tpfl_agg_effective_trim", float(effective), labels=labels)
        if effective == 0 and self.trim > 0:
            logger.warning(
                self.node_name,
                f"TrimmedMean cannot trim: {len(kept)} candidates <= 2*trim ({self.trim}) — "
                "aggregating the PLAIN mean with no byzantine tolerance; widen the train set "
                "or lower trim",
            )
            logger.metrics.counter("tpfl_agg_trimmed_no_trim_total", labels=labels)
            flight.record(
                self.node_name,
                {
                    "kind": "event",
                    "name": "no_trim",
                    "node": self.node_name,
                    "trace": "",
                    "t": time.monotonic(),
                    "candidates": len(kept),
                    "trim": self.trim,
                },
            )
        idx = torch.tensor(kept, dtype=torch.long, device=self.device)
        out = canonical_map(lambda b: trimmed_mean(b[:n][idx], self.trim),
                            state.extra["leaf_bufs"])
        return state.template.build_copy(
            params=out,
            contributors=sorted(state.contributors),
            num_samples=int(state.num_samples),
        )


__all__ = ["Krum", "MultiKrum", "TrimmedMean", "krum_requirement_met", "krum_scores",
           "trimmed_mean"]
