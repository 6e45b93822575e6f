"""Learning-plane observatory: contribution ledger, convergence monitor,
attack-signature anomaly scoring — the port of
:mod:`tpfl.management.ledger`'s contribution plane.

Per contribution folded into an aggregator the ledger records the
update's L2 norm and per-leaf norms (``contribution − round-start
reference``), its cosine to the reference and to the running sum of this
round's earlier updates, its sample count and round. The statistics are
f32 torch ops on the device of the contribution's leaves (the
aggregator's), with an in-place running-sum accumulator: O(1) memory in
the contribution count.

- :meth:`ContributionLedger.record` (the passive tap, ``LEDGER_ENABLED``)
  only parks the contribution at intake; :meth:`~ContributionLedger.flush`
  (at ``close_round`` or any query) computes and scores the parked
  entries in ring order.
- :meth:`ContributionLedger.score_now` (the active defense's path,
  ``QUARANTINE_ENABLED``) computes and scores at intake, once per
  (peer, round) process-wide, against the observer's prior rounds'
  clean entries.
- :meth:`ContributionLedger.detections` is the deterministic verdict:
  entries deduped by (peer, round), each scored against the deduped
  baseline.
- :class:`AnomalyScorer` flags ``cos_ref ≤ LEDGER_ANOMALY_COS``
  (sign-flip), a robust z of the update norm ``≥ LEDGER_ANOMALY_Z``
  (additive noise), and implausible staleness or a version regression
  (``stale_flood``; never on synchronous rounds).
- :class:`ConvergenceMonitor`: global-model delta norms and the
  loss-trajectory slope.

The ``tpfl_contrib_*`` / ``tpfl_convergence_*`` series go to the process
registry (:data:`tpfl_torch.management.telemetry.metrics`), with the
``tpfl_ledger_entries`` / ``tpfl_ledger_flagged`` occupancy gauges from
a pull-style collector; ``contrib`` / ``anomaly`` / ``divergence`` /
``plateau`` records go to the flight recorder's ring.
:meth:`ContributionLedger.record_external` records the entries of the
engine's telemetry carry (:mod:`tpfl_torch.management.engine_obs`).

Gating: every entry point checks ``Settings.LEDGER_ENABLED`` (or, for
the round state and ``score_now``, ``QUARANTINE_ENABLED``) first; with
both off a call adds no tensor op.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from tpfl_torch.concurrency import make_lock
from tpfl_torch.learning.model import to_device
from tpfl_torch.management.logger import logger
from tpfl_torch.management.telemetry import flight, metrics
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import canonical_leaves

#: Update L2 norms span tiny fine-tune deltas to whole-model-scale
#: poison; log-ish buckets keep the histogram readable at both ends.
NORM_BUCKETS: tuple[float, ...] = (
    0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0, 300.0, 1000.0,
)

#: Cosine similarity buckets over [-1, 1].
COSINE_BUCKETS: tuple[float, ...] = (
    -0.8, -0.6, -0.4, -0.2, 0.0, 0.2, 0.4, 0.6, 0.8, 1.0,
)

#: MAD floor as a fraction of the median: a perfectly tight honest
#: cluster must not make every later entry an infinite-z outlier.
_MAD_REL_FLOOR = 0.05
_EPS = 1e-12

#: builtin alias — the query APIs take a ``round`` kwarg.
_round = round


def active() -> bool:
    """True when the ledger's round state must be kept: the
    observational knob or the active defense (quarantine verdicts are
    ledger scores)."""
    return bool(Settings.LEDGER_ENABLED or Settings.QUARANTINE_ENABLED)


# --- contribution stats ------------------------------------------------------


def _device_of(tree: Any) -> torch.device:
    first = canonical_leaves(tree)[0]
    return first.device if isinstance(first, torch.Tensor) else torch.device("cpu")


def _f32_leaves(tree: Any, device: torch.device) -> list[torch.Tensor]:
    """A tree's (or a leaf list's) leaves in JAX's pytree order, f32 on
    ``device``."""
    return [x.to(torch.float32) for x in to_device(canonical_leaves(tree), device)]


@torch.no_grad()
def _stats(params: Any, ref: Any, acc: "list[torch.Tensor] | None", n: int
           ) -> tuple[torch.Tensor, torch.Tensor, list[torch.Tensor]]:
    """(scalars [update norm, reference norm, cos_ref, cos_mean], per-leaf
    update norms, new running-sum accumulator), f32 on the params'
    device; ``acc`` is updated in place. Leaves in JAX's pytree order
    (``ref`` may be the reference's f32 leaf list)."""
    dev = _device_of(params)
    ps, rs = _f32_leaves(params, dev), _f32_leaves(ref, dev)
    upd = [p - r for p, r in zip(ps, rs)]
    leaf_sq = torch.stack([torch.sum(u * u) for u in upd])
    upd_sq = torch.sum(leaf_sq)
    p_sq = sum(torch.sum(p * p) for p in ps)
    r_sq = sum(torch.sum(r * r) for r in rs)
    pr_dot = sum(torch.sum(p * r) for p, r in zip(ps, rs))
    cos_ref = pr_dot / torch.sqrt(torch.clamp(p_sq * r_sq, min=_EPS))
    if acc is None or n <= 0:
        cos_mean = torch.zeros((), dtype=torch.float32, device=dev)
        acc = [u.clone() for u in upd]
    else:
        # Cosine vs the running MEAN of prior updates: cosine is
        # scale-invariant, so the sum stands in for the mean.
        um_dot = sum(torch.sum(u * a) for u, a in zip(upd, acc))
        m_sq = sum(torch.sum(a * a) for a in acc)
        cos_mean = um_dot / torch.sqrt(torch.clamp(upd_sq * m_sq, min=_EPS))
        for a, u in zip(acc, upd):
            a.add_(u)
    scalars = torch.stack([torch.sqrt(upd_sq), torch.sqrt(torch.clamp(r_sq, min=0.0)),
                           cos_ref, cos_mean])
    return scalars, torch.sqrt(leaf_sq), acc


# --- anomaly scoring ---------------------------------------------------------


def robust_z(value: float, window: "list[float]") -> float:
    """Robust z-score of ``value`` against ``window``'s median/MAD
    (1.4826·MAD ≈ sigma for normal data; MAD floored at
    ``_MAD_REL_FLOOR``·median)."""
    if not window:
        return 0.0
    xs = sorted(window)
    mid = len(xs) // 2
    med = xs[mid] if len(xs) % 2 else 0.5 * (xs[mid - 1] + xs[mid])
    mad = sorted(abs(x - med) for x in xs)
    madv = mad[mid] if len(mad) % 2 else 0.5 * (mad[mid - 1] + mad[mid])
    sigma = max(1.4826 * madv, _MAD_REL_FLOOR * abs(med), _EPS)
    return (value - med) / sigma


class AnomalyScorer:
    """Attack-signature scoring — a pure function of (entry features,
    norm baseline window):

    - **sign-flip**: ``cos_ref ≤ Settings.LEDGER_ANOMALY_COS``;
    - **norm outlier** (additive noise): robust z of the update norm
      ``≥ Settings.LEDGER_ANOMALY_Z`` once the window holds
      ``Settings.LEDGER_ANOMALY_MIN_N`` samples;
    - **stale flood**: staleness above ``Settings.ASYNC_STALENESS_MAX``
      or a version regression (disabled when the bound is negative).
    """

    @staticmethod
    def score(update_norm: float, cos_ref: float, window: "list[float]", staleness: int = 0,
              version_regressed: bool = False) -> "tuple[bool, list[str], float]":
        """(flagged, reasons, z_norm)."""
        reasons: list[str] = []
        if cos_ref <= float(Settings.LEDGER_ANOMALY_COS):
            reasons.append("sign_flip")
        z = robust_z(update_norm, window)
        if (len(window) >= max(1, int(Settings.LEDGER_ANOMALY_MIN_N))
                and z >= float(Settings.LEDGER_ANOMALY_Z)):
            reasons.append("norm_outlier")
        max_tau = int(Settings.ASYNC_STALENESS_MAX)
        if max_tau >= 0 and (int(staleness) > max_tau or version_regressed):
            reasons.append("stale_flood")
        return bool(reasons), reasons, z


# --- contribution ledger -----------------------------------------------------


class ContributionLedger:
    """Bounded per-node ring of contribution records + per-round
    running-sum accumulators.

    Lifecycle: ``open_round(node, round, ref_params)`` pins the round and
    its reference; ``record`` (passive) or ``score_now`` (defense) at the
    aggregator's intake; ``close_round(node)`` (``Aggregator.clear``)
    materializes pending entries and drops the reference (the ring
    persists: it is the anomaly baseline).
    """

    def __init__(self) -> None:
        self._lock = make_lock("ContributionLedger._lock")
        # guarded-by: _lock
        self._rings: dict[str, deque] = {}
        # Per-node open-round state: {"round", "ref", "acc", "n"}.
        # guarded-by: _lock
        self._open: dict[str, dict] = {}
        # Cross-observer verdict cache of score_now: stats are a pure
        # function of (params, round-start reference), so the reduction
        # runs once per (peer, round) process-wide. Bounded FIFO.
        # guarded-by: _lock
        self._score_cache: dict[tuple, dict] = {}
        # guarded-by: _lock
        self._score_keys: deque = deque()
        # Per-node last-opened round: re-opening a round already seen
        # means a new experiment — the verdict cache must drop.
        # guarded-by: _lock
        self._last_open: dict[str, int] = {}
        # Per-(observer, peer) max version seen (the regression half of
        # the stale_flood signature).
        # guarded-by: _lock
        self._peer_version: dict[tuple, int] = {}

    def _ring(self, node: str) -> deque:
        """Caller holds ``_lock``."""
        ring = self._rings.get(node)
        if ring is None:
            ring = self._rings[node] = deque(maxlen=max(1, int(Settings.LEDGER_RING)))
        return ring

    # --- lifecycle ---

    def open_round(self, node: str, round: "int | None", ref_params: Any) -> None:
        if not active():
            return
        with self._lock:
            rnd = int(round) if round is not None else -1
            if rnd <= self._last_open.get(node, -1):
                self._score_cache.clear()
                self._score_keys.clear()
                self._last_open.clear()
                self._peer_version.clear()
            self._last_open[node] = rnd
            self._open[node] = {"round": rnd, "ref": ref_params, "acc": None, "n": 0}

    def close_round(self, node: str) -> None:
        # Unconditional: a round opened while enabled must release its
        # pinned params even if the knob was flipped off mid-round.
        self.flush(node)
        with self._lock:
            self._open.pop(node, None)

    def _run_stats(self, st: dict, params: Any) -> tuple[np.ndarray, np.ndarray, bool]:
        """Caller holds ``_lock``: the stats of one contribution against
        the open round ``st`` (advancing its accumulator), on the host in
        f64."""
        dev = _device_of(params)
        ref = st.get("ref_f32")
        if ref is None or ref[0].device != dev:  # the reference goes up once a round
            ref = st["ref_f32"] = _f32_leaves(st["ref"], dev)
        scalars, leaf, st["acc"] = _stats(params, ref, st["acc"], st["n"])
        had_prior = st["n"] > 0
        st["n"] += 1
        both = torch.cat([scalars, leaf]).cpu().numpy().astype(np.float64)
        return both[:4], both[4:], had_prior

    def record(self, node: str, model: Any, trace: str = "",
               staleness: int = 0) -> "dict | None":
        """Record one accepted contribution; returns the ledger entry (or
        None when disabled / no round is open on ``node``). Intake only
        parks the parameters; the stats run at :meth:`flush`.
        Multi-contributor partial aggregates get a metadata-only entry."""
        if not Settings.LEDGER_ENABLED:
            return None
        try:
            contributors = sorted(model.get_contributors())
        except Exception:
            return None
        if len(contributors) > 1:
            return self._record_partial(node, model, contributors, trace)
        with self._lock:
            st = self._open.get(node)
            if st is None:
                return None
            entry = {
                "node": node,
                "peer": "+".join(contributors),
                "contributors": contributors,
                "single": True,
                "round": st["round"],
                "staleness": int(staleness),
                "version": st["round"] - int(staleness),
                "num_samples": int(model.get_num_samples()),
                "update_norm": None,
                "ref_norm": None,
                "cos_ref": None,
                "cos_mean": None,
                "leaf_norms": [],
                "trace": trace,
                "t": time.monotonic(),
                "z_norm": 0.0,
                "flagged": False,
                "reasons": [],
                "quarantined": False,
                "_params": model.get_parameters(),
            }
            self._ring(node).append(entry)
        return entry

    def score_now(self, node: str, model: Any, trace: str = "",
                  staleness: int = 0) -> "dict | None":
        """Record AND score one single-contributor contribution at intake
        — the active defense's path. Deduped by (peer, round) per
        observer; the norm window is the observer's prior versions'
        clean single entries. Returns the scored entry, or None when no
        round is open / the model is not single-contributor / defenses
        are off."""
        if not active():
            return None
        try:
            contributors = sorted(model.get_contributors())
        except Exception:
            return None
        if len(contributors) != 1:
            return None
        peer = contributors[0]
        with self._lock:
            st = self._open.get(node)
            if st is None:
                return None
            ring = self._ring(node)
            for e in reversed(ring):
                if (e["single"] and e["peer"] == peer and e["round"] == st["round"]
                        and e["update_norm"] is not None):
                    return e  # re-push of an already-scored contribution
            version = st["round"] - int(staleness)
            vkey = (node, peer)
            prev_version = self._peer_version.get(vkey)
            regressed = prev_version is not None and version < prev_version
            self._peer_version[vkey] = (version if prev_version is None
                                        else max(prev_version, version))
            cached = self._score_cache.get((peer, st["round"]))
            if cached is not None:
                scored = dict(cached)
            else:
                window = [x["update_norm"] for x in ring
                          if x["single"] and x["update_norm"] is not None
                          and x.get("version", x["round"]) < version and not x["flagged"]]
                scalars, leaf, had_prior = self._run_stats(st, model.get_parameters())
                update_norm = float(scalars[0])
                flagged, reasons, z_norm = AnomalyScorer.score(
                    update_norm, float(scalars[2]), window,
                    staleness=staleness, version_regressed=regressed)
                scored = {
                    "update_norm": update_norm,
                    "ref_norm": float(scalars[1]),
                    "cos_ref": float(scalars[2]),
                    "cos_mean": float(scalars[3]) if had_prior else None,
                    "leaf_norms": [_round(float(x), 6) for x in leaf],
                    "z_norm": _round(z_norm, 4),
                    "flagged": flagged,
                    "reasons": list(reasons),
                }
                self._score_cache[(peer, st["round"])] = dict(scored)
                self._score_keys.append((peer, st["round"]))
                while len(self._score_keys) > 2048:
                    self._score_cache.pop(self._score_keys.popleft(), None)
            entry = {
                "node": node,
                "peer": peer,
                "contributors": contributors,
                "single": True,
                "round": st["round"],
                "staleness": int(staleness),
                "version": st["round"] - int(staleness),
                "num_samples": int(model.get_num_samples()),
                "trace": trace,
                "t": time.monotonic(),
                "quarantined": False,
                **scored,
            }
            entry["reasons"] = list(entry["reasons"])
            ring.append(entry)
        self._emit(entry)  # OUTSIDE _lock
        return entry

    def record_external(self, node: str, peer: str, round: "int | None", update_norm: float,
                        cos_ref: float, num_samples: int = 1, trace: str = "",
                        staleness: int = 0) -> "dict | None":
        """Score and record one contribution whose statistics the
        engine's telemetry carry already computed
        (:mod:`tpfl_torch.management.engine_obs`): no open round, no
        reference params, no tensor op. Scored against the observer's
        prior clean window with :class:`AnomalyScorer`'s thresholds and
        emitted like an intake entry, so :meth:`detections` and the
        quarantine replay judge engine-tier contributions as protocol-tier
        ones. Deduped by (peer, round) per observer: a replayed window
        returns the existing entry."""
        if not active():
            return None
        rnd = int(round) if round is not None else -1
        version = rnd - int(staleness)
        with self._lock:
            ring = self._ring(node)
            for e in reversed(ring):
                if (e["single"] and e["peer"] == peer and e["round"] == rnd
                        and e["update_norm"] is not None):
                    return e
            vkey = (node, peer)
            prev_version = self._peer_version.get(vkey)
            regressed = prev_version is not None and version < prev_version
            self._peer_version[vkey] = (version if prev_version is None
                                        else max(prev_version, version))
            window = [x["update_norm"] for x in ring
                      if x["single"] and x["update_norm"] is not None
                      and x.get("version", x["round"]) < version and not x["flagged"]]
            flagged, reasons, z_norm = AnomalyScorer.score(
                float(update_norm), float(cos_ref), window, staleness=staleness,
                version_regressed=regressed)
            entry = {
                "node": node,
                "peer": peer,
                "contributors": [peer],
                "single": True,
                "round": rnd,
                "staleness": int(staleness),
                "version": version,
                "num_samples": int(num_samples),
                "update_norm": float(update_norm),
                "ref_norm": None,
                "cos_ref": float(cos_ref),
                "cos_mean": None,
                "leaf_norms": [],
                "trace": trace,
                "t": time.monotonic(),
                "z_norm": _round(z_norm, 4),
                "flagged": flagged,
                "reasons": list(reasons),
                "quarantined": False,
            }
            ring.append(entry)
        self._emit(entry)  # OUTSIDE _lock
        return entry

    def flush(self, node: Optional[str] = None) -> None:
        """Materialize pending entries: each parked contribution's stats
        (in ring order — the running-sum chain is sequential per node),
        scored against the preceding window. Idempotent."""
        to_emit: list[dict] = []
        with self._lock:
            rings = ([self._rings[node]] if node is not None and node in self._rings
                     else list(self._rings.values()))
            for ring in rings:
                window: "list[float] | None" = None
                seen_version: dict[str, int] = {}
                for e in ring:
                    params = e.pop("_params", None)
                    version = e.get("version")
                    prev_v = seen_version.get(e["peer"]) if e.get("single") else None
                    if e.get("single") and version is not None:
                        seen_version[e["peer"]] = (version if prev_v is None
                                                   else max(prev_v, version))
                    if params is None:
                        continue
                    st = self._open.get(e["node"])
                    if st is None or st["round"] != e["round"]:
                        # Round state already gone: keep the metadata.
                        continue
                    if window is None:
                        window = [x["update_norm"] for x in ring
                                  if x["single"] and x["update_norm"] is not None]
                    scalars, leaf, had_prior = self._run_stats(st, params)
                    e["update_norm"] = float(scalars[0])
                    e["ref_norm"] = float(scalars[1])
                    e["cos_ref"] = float(scalars[2])
                    e["cos_mean"] = float(scalars[3]) if had_prior else None
                    e["leaf_norms"] = [_round(float(x), 6) for x in leaf]
                    flagged, reasons, z_norm = AnomalyScorer.score(
                        e["update_norm"], e["cos_ref"], window,
                        staleness=e.get("staleness", 0),
                        version_regressed=bool(prev_v is not None and version is not None
                                               and version < prev_v))
                    e["z_norm"] = _round(z_norm, 4)
                    e["flagged"] = flagged
                    e["reasons"] = reasons
                    window.append(e["update_norm"])
                    to_emit.append(e)
        for e in to_emit:  # OUTSIDE _lock, in ring order
            self._emit(e)

    def _record_partial(self, node: str, model: Any, contributors: list[str],
                        trace: str) -> "dict | None":
        """Metadata-only entry for a multi-contributor partial aggregate:
        no tensor op, never scored."""
        with self._lock:
            st = self._open.get(node)
            if st is None:
                return None
            entry = {
                "node": node,
                "peer": "+".join(contributors),
                "contributors": contributors,
                "single": False,
                "round": st["round"],
                "num_samples": int(model.get_num_samples()),
                "update_norm": None,
                "ref_norm": None,
                "cos_ref": None,
                "cos_mean": None,
                "leaf_norms": [],
                "trace": trace,
                "t": time.monotonic(),
                "z_norm": 0.0,
                "flagged": False,
                "reasons": [],
                "quarantined": False,
            }
            self._ring(node).append(entry)
        metrics.counter("tpfl_contrib_total", labels={"node": node})
        flight.record(
            node,
            {
                "kind": "event",
                "name": "contrib",
                "node": node,
                "trace": trace,
                "t": entry["t"],
                "peer": entry["peer"],
                "round": entry["round"],
                "num_samples": entry["num_samples"],
                "flagged": False,
            },
        )
        return entry

    def _emit(self, entry: dict) -> None:
        """Registry + flight emission — OUTSIDE ``_lock``."""
        node = entry["node"]
        labels = {"node": node}
        metrics.counter("tpfl_contrib_total", labels=labels)
        metrics.observe("tpfl_contrib_update_norm", entry["update_norm"], labels=labels,
                        buckets=NORM_BUCKETS)
        metrics.observe("tpfl_contrib_cosine", entry["cos_ref"], labels=labels,
                        buckets=COSINE_BUCKETS)
        metrics.gauge("tpfl_contrib_last_z", entry["z_norm"], labels=labels)
        flight.record(
            node,
            {
                "kind": "event",
                "name": "contrib",
                "node": node,
                "trace": entry["trace"],
                "t": entry["t"],
                "peer": entry["peer"],
                "round": entry["round"],
                "update_norm": round(entry["update_norm"], 6),
                "cos_ref": round(entry["cos_ref"], 6),
                "num_samples": entry["num_samples"],
                "flagged": entry["flagged"],
            },
        )
        if entry["flagged"]:
            for reason in entry["reasons"]:
                metrics.counter("tpfl_contrib_flagged_total",
                                labels={"node": node, "reason": reason})
            flight.record(
                node,
                {
                    "kind": "event",
                    "name": "anomaly",
                    "node": node,
                    "trace": entry["trace"],
                    "t": entry["t"],
                    "peer": entry["peer"],
                    "round": entry["round"],
                    "reasons": ",".join(entry["reasons"]),
                    "z_norm": entry["z_norm"],
                    "cos_ref": round(entry["cos_ref"], 6),
                },
            )
            logger.warning(
                node,
                f"Anomalous contribution from {entry['peer']} (round "
                f"{entry['round']}): {','.join(entry['reasons'])} "
                f"(|u|={entry['update_norm']:.3g}, z={entry['z_norm']:.1f}, "
                f"cos_ref={entry['cos_ref']:.3f})",
            )

    # --- query surface ---

    def entries(self, node: Optional[str] = None) -> list[dict]:
        self.flush(node)
        with self._lock:
            if node is not None:
                return [dict(e) for e in self._rings.get(node, ())]
            return [dict(e) for n in sorted(self._rings) for e in self._rings[n]]

    def stats_for(self, node: str) -> dict:
        """{entries, flagged} of one node's ring."""
        self.flush(node)
        with self._lock:
            ring = self._rings.get(node, ())
            return {"entries": len(ring), "flagged": sum(1 for e in ring if e["flagged"])}

    def detections(self) -> dict:
        """Deterministic global verdict: single-contributor entries
        deduped by (peer, round), each scored against the deduped norm
        baseline. Returns ``{"entries": [...sorted...], "flagged": {peer:
        {"rounds", "reasons"}}, "peers": [...]}``."""
        self.flush()
        with self._lock:
            all_entries = [e for ring in self._rings.values() for e in ring
                           if e["single"] and e["update_norm"] is not None]
        dedup: dict[tuple, dict] = {}
        for e in all_entries:
            dedup.setdefault((e["peer"], e["round"]), e)
        baseline = [e["update_norm"] for e in dedup.values()]
        flagged: dict[str, dict] = {}
        scored = []
        max_version: dict[str, int] = {}
        for (peer, rnd) in sorted(dedup):
            e = dedup[(peer, rnd)]
            version = e.get("version", rnd)
            prev_v = max_version.get(peer)
            max_version[peer] = version if prev_v is None else max(prev_v, version)
            is_flagged, reasons, z = AnomalyScorer.score(
                e["update_norm"], e["cos_ref"], list(baseline),
                staleness=e.get("staleness", 0),
                version_regressed=bool(prev_v is not None and version < prev_v))
            scored.append({
                "peer": peer,
                "round": rnd,
                "update_norm": _round(e["update_norm"], 6),
                "cos_ref": _round(e["cos_ref"], 6),
                "staleness": int(e.get("staleness", 0)),
                "version": int(version),
                "z_norm": _round(z, 4),
                "flagged": is_flagged,
                "reasons": reasons,
            })
            if is_flagged:
                rec = flagged.setdefault(peer, {"rounds": [], "reasons": []})
                rec["rounds"].append(rnd)
                for r in reasons:
                    if r not in rec["reasons"]:
                        rec["reasons"].append(r)
        return {"entries": scored, "flagged": {k: flagged[k] for k in sorted(flagged)},
                "peers": sorted({e["peer"] for e in dedup.values()})}

    def reset(self) -> None:
        with self._lock:
            self._rings.clear()
            self._open.clear()
            self._score_cache.clear()
            self._score_keys.clear()
            self._last_open.clear()
            self._peer_version.clear()


# --- convergence monitor -----------------------------------------------------


@torch.no_grad()
def _delta_norm(params: Any, prev: Any) -> "tuple[float, float]":
    """(||params − prev||₂, ||params||₂), f32 on the params' device."""
    dev = _device_of(params)
    ps, qs = _f32_leaves(params, dev), _f32_leaves(prev, dev)
    if len(ps) != len(qs):
        raise ValueError("tree structure changed")
    d_sq = sum(torch.sum((a - b) ** 2) for a, b in zip(ps, qs))
    p_sq = sum(torch.sum(a ** 2) for a in ps)
    out = torch.stack([torch.sqrt(d_sq), torch.sqrt(p_sq)]).cpu().numpy().astype(np.float64)
    return float(out[0]), float(out[1])


class ConvergenceMonitor:
    """Is the federation converging? Two per-round signals: the global
    model's delta norm ``||x_r − x_{r−1}||`` (a plateau or a divergence
    over ``Settings.LEDGER_CONVERGENCE_WINDOW`` rounds bumps a counter)
    and the least-squares slope of the trailing per-fit train losses
    (the learner's fit tap)."""

    #: Relative delta below which a round counts toward a plateau.
    PLATEAU_REL = 1e-4

    def __init__(self) -> None:
        self._lock = make_lock("ConvergenceMonitor._lock")
        # guarded-by: _lock
        self._prev: dict[str, Any] = {}
        # guarded-by: _lock
        self._deltas: dict[str, deque] = {}
        # guarded-by: _lock
        self._losses: dict[str, deque] = {}

    def _window(self) -> int:
        return max(2, int(Settings.LEDGER_CONVERGENCE_WINDOW))

    def observe_global(self, node: str, round: "int | None", params: Any) -> "dict | None":
        if not Settings.LEDGER_ENABLED:
            return None
        with self._lock:
            prev = self._prev.get(node)
            self._prev[node] = params
        if prev is None:
            return None
        try:
            delta, norm = _delta_norm(params, prev)
        except Exception:
            # Structure changed mid-run (model swap): restart the series.
            return None
        return self.observe_delta(node, round, delta, norm)

    def observe_delta(self, node: str, round: "int | None", delta: float,
                      norm: float) -> "dict | None":
        """The plateau / divergence logic over a precomputed
        ``(||x_r − x_{r−1}||, ||x_r||)`` pair."""
        if not Settings.LEDGER_ENABLED:
            return None
        rnd = int(round) if round is not None else -1
        delta, norm = float(delta), float(norm)
        rel = delta / max(norm, _EPS)
        w = self._window()
        with self._lock:
            dq = self._deltas.setdefault(node, deque(maxlen=w))
            dq.append(delta)
            deltas = list(dq)
        labels = {"node": node}
        metrics.gauge("tpfl_convergence_delta_norm", delta, labels=labels)
        metrics.gauge("tpfl_convergence_rel_delta", rel, labels=labels)
        out = {"node": node, "round": rnd, "delta": delta, "rel": rel}
        event = None
        if len(deltas) == w and all(deltas[i] < deltas[i + 1] for i in range(w - 1)):
            event = "divergence"
        elif len(deltas) == w and all(d / max(norm, _EPS) < self.PLATEAU_REL for d in deltas):
            event = "plateau"
        if event:
            metrics.counter(f"tpfl_convergence_{event}_total", labels=labels)
            flight.record(
                node,
                {
                    "kind": "event",
                    "name": event,
                    "node": node,
                    "trace": "",
                    "t": time.monotonic(),
                    "round": rnd,
                    "delta_norm": _round(delta, 6),
                    "rel_delta": _round(rel, 8),
                },
            )
            out["event"] = event
        return out

    def observe_loss(self, node: str, ordinal: int, loss: float) -> "float | None":
        """Record one fit's train loss; returns the current slope once
        the window holds two points (loss units per fit)."""
        if not Settings.LEDGER_ENABLED:
            return None
        w = self._window()
        with self._lock:
            dq = self._losses.setdefault(node, deque(maxlen=w))
            dq.append((int(ordinal), float(loss)))
            points = list(dq)
        if len(points) < 2:
            return None
        xs = [p[0] for p in points]
        ys = [p[1] for p in points]
        n = len(xs)
        mx = sum(xs) / n
        my = sum(ys) / n
        den = sum((x - mx) ** 2 for x in xs)
        slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / den if den > 0 else 0.0
        metrics.gauge("tpfl_convergence_loss_slope", slope, labels={"node": node})
        if len(points) == w and all(ys[i] < ys[i + 1] for i in range(n - 1)):
            metrics.counter("tpfl_convergence_divergence_total", labels={"node": node})
            flight.record(
                node,
                {
                    "kind": "event",
                    "name": "divergence",
                    "node": node,
                    "trace": "",
                    "t": time.monotonic(),
                    "loss_slope": round(slope, 6),
                    "window": n,
                },
            )
        return slope

    def reset(self) -> None:
        with self._lock:
            self._prev.clear()
            self._deltas.clear()
            self._losses.clear()


# --- registry collector (pull-style occupancy gauges) ---------------------


def _ledger_collector(registry: Any) -> None:
    """Per-node ledger occupancy/flag gauges at scrape time — no
    instrumentation on the record path. Flushes first so a scrape
    observes scored entries, not pending ones."""
    contrib.flush()
    with contrib._lock:
        per_node = {
            n: (len(ring), sum(1 for e in ring if e["flagged"]))
            for n, ring in contrib._rings.items()
        }
    for node, (n_entries, n_flagged) in per_node.items():
        labels = {"node": node}
        registry.gauge("tpfl_ledger_entries", float(n_entries), labels=labels)
        registry.gauge("tpfl_ledger_flagged", float(n_flagged), labels=labels)


#: Process-wide singletons (one federation per process).
contrib = ContributionLedger()
convergence = ConvergenceMonitor()
scorer = AnomalyScorer()

metrics.register_collector(_ledger_collector)

__all__ = ["AnomalyScorer", "ContributionLedger", "ConvergenceMonitor", "active", "contrib",
           "convergence", "robust_z", "scorer"]
