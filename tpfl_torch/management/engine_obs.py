"""Engine plane: fan the engine's telemetry carry out into the
observatory planes — the port of :mod:`tpfl.management.engine_obs`.

``Settings.ENGINE_TELEMETRY`` makes :class:`~tpfl_torch.parallel.engine.FederationEngine`
thread a fixed-shape ``[n_rounds, ...]`` carry through a window — per
round and node: train loss, update L2 norm, cosine against the
round-start params; per round: the global model's delta norm and norm,
participation, fold weight mass and wire bytes; a fedbuff window adds
each arrival's staleness. :func:`replay_window` is the host half: it
takes the carry (host numpy, copied at dispatch, read at the window's
finalize) and replays it, honoring each plane's own knob:

- ``tpfl_engine_*`` registry series — always;
- per-round :class:`~tpfl_torch.management.profiling.RoundProfiler`
  rows under the ``engine:<model>`` node — the window's measured
  dispatch / train split divided over its rounds (``PROFILING_ENABLED``);
- :class:`~tpfl_torch.management.ledger.ConvergenceMonitor` divergence /
  plateau events from the per-round delta norms;
- :class:`~tpfl_torch.management.ledger.ContributionLedger` entries —
  each elected (and, under a schedule, arriving) node's update norm and
  cosine scored by the protocol tier's thresholds (``LEDGER_ENABLED`` or
  ``QUARANTINE_ENABLED``);
- an attached ``AsyncController``'s arrival observations, one
  ``observe_round`` per fedbuff round.

The carry is read-only over the round, and every verdict is a pure
function of its values. This module holds no state and adds no device
work.
"""

from __future__ import annotations

import time
from typing import Any, Optional, Sequence

import numpy as np

from tpfl_torch.management.ledger import (
    COSINE_BUCKETS,
    NORM_BUCKETS,
    contrib,
    convergence,
)
from tpfl_torch.management.profiling import rounds
from tpfl_torch.management.telemetry import flight, metrics
from tpfl_torch.settings import Settings


def enabled() -> bool:
    return bool(Settings.ENGINE_TELEMETRY)


def peer_names(n: int) -> list[str]:
    """Default engine-tier peer addresses: the engine's nodes are
    positional (no gRPC addresses), so ledger entries and AttackPlan
    ground truth key on these synthetic names."""
    return [f"engine-node-{i}" for i in range(n)]


def replay_window(
    node: str,
    model: str,
    start_round: int,
    telemetry: dict,
    n_nodes: int,
    weights: Optional[Any] = None,
    peers: Optional[Sequence[str]] = None,
    wall_seconds: float = 0.0,
    dispatch_seconds: float = 0.0,
    controller: Optional[Any] = None,
) -> dict:
    """Replay one window's telemetry carry into the observatory planes.

    ``telemetry``: the engine's carry as host numpy arrays
    (:data:`tpfl_torch.parallel.engine.TELEMETRY_FIELDS` — per-node
    buffers ``[R, padded_nodes]``, per-round scalars ``[R]``; pad columns
    are sliced off here), copied to the host behind the window at
    dispatch and read here at the window's finalize.
    ``weights``: the window's PADDED fold weights ([padded] or
    [R, padded]); only elected (weight > 0) nodes become ledger
    entries — matching the gRPC tier, where only contributors reach
    an aggregator's intake.

    FedBuff windows additionally carry a per-node ``staleness`` row
    (τ on arrival rounds, −1 in flight): election is further gated on
    ARRIVAL, each ledger entry records its staleness ordinal (the
    quarantine judge sees engine-tier arrivals exactly like gRPC-tier
    ones), and — when a ``controller``
    (:class:`~tpfl_torch.learning.async_control.AsyncController`) is wired —
    every round's ``(τ, stamp)`` arrival list is folded into the
    controller's EWMA state under the serialized virtual-clock
    discipline (stamps are round ordinals). Returns a summary
    ``{"rounds", "recorded", "flagged", "events"}``.
    """
    loss = np.asarray(telemetry["loss"], np.float64)[:, :n_nodes]
    upd = np.asarray(telemetry["update_norm"], np.float64)[:, :n_nodes]
    cos = np.asarray(telemetry["cos_ref"], np.float64)[:, :n_nodes]
    stale = telemetry.get("staleness")
    stale = None if stale is None else np.asarray(stale, np.float64)[:, :n_nodes]
    delta = np.asarray(telemetry["delta_norm"], np.float64)
    mnorm = np.asarray(telemetry["model_norm"], np.float64)
    part = np.asarray(telemetry["participation"], np.float64)
    wmass = np.asarray(telemetry["weight_mass"], np.float64)
    # Device-side exchange bytes (the ENGINE_WIRE_CODEC accounting);
    # absent from pre-codec carries.
    wire = telemetry.get("wire_bytes")
    wire = None if wire is None else np.asarray(wire, np.float64)
    # Cross-host DCN bytes (the 3D-mesh hosts-leg accounting); absent
    # from single-host carries.
    dcn = telemetry.get("dcn_bytes")
    dcn = None if dcn is None else np.asarray(dcn, np.float64)
    n_rounds = int(loss.shape[0])
    names = list(peers) if peers is not None else peer_names(n_nodes)
    w = None if weights is None else np.asarray(weights, np.float64)

    ledger_on = bool(
        Settings.LEDGER_ENABLED or Settings.QUARANTINE_ENABLED
    )
    labels = {"model": model}
    recorded = flagged = 0
    events: list[dict] = []
    per_round_wall = max(wall_seconds, 1e-9) / max(n_rounds, 1)
    per_round_dispatch = max(dispatch_seconds, 0.0) / max(n_rounds, 1)
    per_round_train = max(
        0.0, (wall_seconds - dispatch_seconds) / max(n_rounds, 1)
    )
    for r in range(n_rounds):
        rnd = start_round + r
        if w is None:
            elected = np.ones((n_nodes,), bool)
            w_r = np.ones((n_nodes,), np.float64)
        else:
            w_r = (w if w.ndim == 1 else w[r])[:n_nodes]
            elected = w_r > 0
            if not elected.any():
                # All-zero round weights fall back to a uniform fold
                # over real nodes (the engine's masked-mean fallback):
                # everyone contributed.
                elected = np.ones((n_nodes,), bool)
                w_r = np.ones((n_nodes,), np.float64)
        if stale is not None:
            # FedBuff window: a node contributes this round only if it
            # ARRIVED (τ >= 0; in-flight rounds carry the −1 sentinel).
            # The schedule guarantees every round has >= 1 arrival, so
            # no uniform fallback is needed here.
            elected = elected & (stale[r] >= 0)
        metrics.counter("tpfl_engine_rounds_total", labels=labels)
        for i in np.flatnonzero(elected):
            metrics.observe(
                "tpfl_engine_update_norm", float(upd[r, i]),
                labels=labels, buckets=NORM_BUCKETS,
            )
            metrics.observe(
                "tpfl_engine_cos_ref", float(cos[r, i]),
                labels=labels, buckets=COSINE_BUCKETS,
            )
        rounds.record_external(
            node, rnd,
            {"dispatch": per_round_dispatch, "train": per_round_train},
            per_round_wall,
        )
        out = convergence.observe_delta(
            node, rnd, float(delta[r]), float(mnorm[r])
        )
        if out is not None and out.get("event"):
            events.append(out)
        if ledger_on:
            for i in np.flatnonzero(elected):
                entry = contrib.record_external(
                    node, names[i], rnd,
                    float(upd[r, i]), float(cos[r, i]),
                    num_samples=max(1, int(round(float(w_r[i])))),
                    staleness=(
                        0 if stale is None
                        else max(0, int(round(float(stale[r, i]))))
                    ),
                )
                if entry is not None:
                    recorded += 1
                    if entry["flagged"]:
                        flagged += 1
        if stale is not None:
            arrived = np.flatnonzero(elected)
            taus = [max(0, int(round(float(stale[r, i])))) for i in arrived]
            if taus:
                metrics.gauge(
                    "tpfl_engine_staleness",
                    float(np.mean(taus)), labels=labels,
                )
            if controller is not None and taus:
                # Feed the AsyncController exactly as the gRPC
                # aggregator does on buffer flush: one observe_round
                # per engine round, arrivals as (τ, stamp). Stamps are
                # deterministic round-ordinal fractions — the engine's
                # rounds are a virtual clock (no wall time exists for
                # device-side arrivals), and observe_round only sorts
                # and differences them, so the spread is what matters.
                n_arr = len(taus)
                arrivals = [
                    (taus[k], float(rnd) + (k + 1) / (n_arr + 1))
                    for k in range(n_arr)
                ]
                controller.observe_round(
                    rnd, arrivals, "buffer_full",
                    float(Settings.ASYNC_ROUND_DEADLINE),
                )
    last = n_rounds - 1
    metrics.gauge(
        "tpfl_engine_loss", float(np.mean(loss[last])), labels=labels
    )
    metrics.gauge("tpfl_engine_delta_norm", float(delta[last]), labels=labels)
    metrics.gauge("tpfl_engine_model_norm", float(mnorm[last]), labels=labels)
    metrics.gauge(
        "tpfl_engine_participation", float(part[last]), labels=labels
    )
    metrics.gauge("tpfl_engine_weight_mass", float(wmass[last]), labels=labels)
    if wire is not None:
        # Gauge = last round's bytes (what a scrape reads as "the
        # exchange currently costs"); counter = the window's total, so
        # the multichip tier can gate cumulative bytes/round ratios.
        metrics.gauge(
            "tpfl_engine_wire_bytes", float(wire[last]), labels=labels
        )
        metrics.counter(
            "tpfl_engine_wire_bytes_total", float(wire.sum()), labels=labels
        )
    if dcn is not None:
        metrics.gauge(
            "tpfl_engine_dcn_bytes", float(dcn[last]), labels=labels
        )
        metrics.counter(
            "tpfl_engine_dcn_bytes_total", float(dcn.sum()), labels=labels
        )
    if flagged:
        metrics.counter(
            "tpfl_engine_flagged_total", float(flagged), labels=labels
        )
    flight.record(
        node,
        {
            "kind": "event",
            "name": "engine_window",
            "node": node,
            "trace": "",
            "t": time.monotonic(),
            "model": model,
            "start_round": int(start_round),
            "rounds": n_rounds,
            "loss": round(float(np.mean(loss[last])), 6),
            "delta_norm": round(float(delta[last]), 6),
            "flagged": flagged,
        },
    )
    return {
        "rounds": n_rounds,
        "recorded": recorded,
        "flagged": flagged,
        "events": events,
    }
