"""Active Byzantine defense: the quarantine engine — the port of
:mod:`tpfl.management.quarantine`.

A :class:`QuarantineEngine` (one per node, attached to its aggregator
with ``Aggregator.set_quarantine``) composes the ledger's
:class:`~tpfl_torch.management.ledger.AnomalyScorer` verdicts with
aggregation at the ``Aggregator.add_model`` intake:

- every single-contributor model is scored by
  :meth:`ContributionLedger.score_now` BEFORE it can fold;
- a flagged contribution is excluded from the fold but kept as a
  coverage-only passenger (its contributor still counts toward round
  coverage), its ledger entry is marked ``quarantined``, and the peer
  enters quarantine;
- a quarantined peer's later contributions are still scored (they earn
  the probation streak) but stay excluded until
  ``Settings.QUARANTINE_PROBATION_ROUNDS`` have passed since its last
  flagged round with clean scores — then a ``readmit``;
- multi-contributor partials whose contributors are ALL quarantined are
  rejected outright; mixtures with a clean contributor are admitted.

The verdict is a pure function of (contribution params, round-start
reference, prior rounds' clean norm window), so every observer reaches
the same one. :func:`replay_decisions` replays the state machine over
the ledger's deduped :meth:`detections` view: the byte-stable receipt.

``tpfl_quarantine_*`` series go to the port's ``logger.metrics``; the
flight-recorder ``quarantine`` / ``readmit`` events wait for
``telemetry.py`` (``ROADMAP.md`` §1 item 7).
"""

from __future__ import annotations

from typing import Any

from tpfl_torch.concurrency import make_lock
from tpfl_torch.management import ledger
from tpfl_torch.management.logger import logger
from tpfl_torch.settings import Settings

metrics = logger.metrics

#: Bound on the per-engine action log (quarantine/reject/readmit
#: records) — diagnostics, not state; oldest dropped past the cap.
_ACTION_LOG_CAP = 4096


class QuarantineEngine:
    """Per-node quarantine state machine at the aggregation intake.

    One engine per node, consulted by ``Aggregator.add_model`` before
    every fold. All mutable state sits
    under one ``make_lock`` leaf lock; the ledger scoring call runs
    outside it (the ledger has its own lock — no nesting, no
    lock-order edges).
    """

    def __init__(self, node: str) -> None:
        self.node = node
        self._lock = make_lock("QuarantineEngine._lock")
        # peer -> {"active", "since_round", "last_flag_round",
        #          "reasons", "readmissions"}.
        # guarded-by: _lock
        self._state: dict[str, dict] = {}
        # Bounded diagnostics log of {"peer","round","action","reasons"}.
        # guarded-by: _lock
        self._actions: list[dict] = []
        # Verdict cache: peer -> (round, verdict). Gossip re-pushes of
        # the same (peer, round) contribution (the ledger dedups their
        # scoring) must not re-log actions or re-emit events — one
        # decision per contribution per round.
        # guarded-by: _lock
        self._last: dict[str, tuple] = {}

    # --- the decision point (Aggregator.add_model) ---

    def assess(
        self,
        model: Any,
        contributors: list[str],
        trace: str = "",
        staleness: int = 0,
    ) -> "dict | None":
        """Verdict for one intake: ``{"exclude", "recorded", "reasons"}``
        or None when the defense is off. ``recorded`` tells the
        aggregator the ledger entry already exists (so the passive
        record tap must not double-record). ``staleness``: async
        rounds' version-distance ordinal — threaded into the ledger
        entry so the scorer's norm window stays keyed to MODEL VERSION,
        not wall-clock arrival (a stale honest update's norm belongs
        with its own version's population, not the current round's)."""
        if not Settings.QUARANTINE_ENABLED:
            return None
        if len(contributors) != 1:
            return self._assess_partial(contributors)
        peer = contributors[0]
        entry = ledger.contrib.score_now(
            self.node, model, trace=trace, staleness=staleness
        )
        if entry is None:
            # No open round on this node (round not started / defense
            # raced a round boundary): nothing to judge against.
            return {"exclude": False, "recorded": False, "reasons": []}
        rnd = int(entry["round"])
        probation = max(0, int(Settings.QUARANTINE_PROBATION_ROUNDS))
        emit: "list[tuple[str, dict]]" = []
        with self._lock:
            cached = self._last.get(peer)
            if cached is not None and cached[0] == rnd:
                # Re-push of an already-judged contribution: same
                # verdict, no new action.
                return dict(cached[1])
            rec = self._state.get(peer)
            if entry["flagged"]:
                if rec is None or not rec["active"]:
                    rec = self._state[peer] = {
                        "active": True,
                        "since_round": rnd,
                        "last_flag_round": rnd,
                        "reasons": list(entry["reasons"]),
                        "readmissions": (rec or {}).get("readmissions", 0),
                    }
                    action = "quarantine"
                else:
                    rec["last_flag_round"] = max(rec["last_flag_round"], rnd)
                    for r in entry["reasons"]:
                        if r not in rec["reasons"]:
                            rec["reasons"].append(r)
                    action = "reject"
                verdict = {
                    "exclude": True,
                    "recorded": True,
                    "reasons": list(entry["reasons"]),
                }
                self._log(peer, rnd, action, entry["reasons"])
                emit.append((action, dict(rec)))
            elif rec is not None and rec["active"]:
                if rnd - rec["last_flag_round"] > probation:
                    rec["active"] = False
                    rec["readmissions"] += 1
                    verdict = {
                        "exclude": False,
                        "recorded": True,
                        "reasons": [],
                    }
                    self._log(peer, rnd, "readmit", [])
                    emit.append(("readmit", dict(rec)))
                else:
                    verdict = {
                        "exclude": True,
                        "recorded": True,
                        "reasons": ["probation"],
                    }
                    self._log(peer, rnd, "reject", ["probation"])
                    emit.append(("reject", dict(rec)))
            else:
                verdict = {"exclude": False, "recorded": True, "reasons": []}
            self._last[peer] = (rnd, dict(verdict))
            active_n = sum(1 for r in self._state.values() if r["active"])
        if verdict["exclude"]:
            entry["quarantined"] = True  # entry dicts mutate in place
        for action, rec_snap in emit:
            self._emit(action, peer, rnd, rec_snap, trace, active_n)
        return verdict

    def _assess_partial(self, contributors: list[str]) -> dict:
        """Mixtures are never scored (diluted params carry no clean
        signature). All-quarantined mixtures are pure poison — reject;
        mixtures with at least one clean contributor are the honest
        fold under uniform verdicts, admitted with the quarantined
        names as coverage passengers."""
        with self._lock:
            quarantined = {
                p for p, r in self._state.items() if r["active"]
            }
        if contributors and set(contributors) <= quarantined:
            metrics.counter(
                "tpfl_quarantine_rejected_total",
                labels={"node": self.node, "kind": "mixture"},
            )
            return {
                "exclude": True,
                "recorded": False,
                "reasons": ["quarantined_mixture"],
            }
        return {"exclude": False, "recorded": False, "reasons": []}

    # --- bookkeeping / emission ---

    def _log(self, peer: str, rnd: int, action: str, reasons: list) -> None:
        """Caller holds ``self._lock``."""
        self._actions.append(
            {
                "peer": peer,
                "round": rnd,
                "action": action,
                "reasons": list(reasons),
            }
        )
        if len(self._actions) > _ACTION_LOG_CAP:
            del self._actions[: len(self._actions) - _ACTION_LOG_CAP]

    def _emit(
        self,
        action: str,
        peer: str,
        rnd: int,
        rec: dict,
        trace: str,
        active_n: int,
    ) -> None:
        """Registry + log emission — OUTSIDE ``_lock``."""
        labels = {"node": self.node}
        if action == "quarantine":
            metrics.counter("tpfl_quarantine_total", labels=labels)
        elif action == "readmit":
            metrics.counter("tpfl_quarantine_readmitted_total", labels=labels)
        else:
            metrics.counter(
                "tpfl_quarantine_rejected_total",
                labels={"node": self.node, "kind": "contribution"},
            )
        metrics.gauge("tpfl_quarantine_active", float(active_n), labels=labels)
        if action == "quarantine":
            logger.warning(
                self.node,
                f"QUARANTINE {peer} (round {rnd}): "
                f"{','.join(rec.get('reasons', [])) or 'flagged'} — "
                "contributions excluded from the fold until "
                f"{Settings.QUARANTINE_PROBATION_ROUNDS} clean rounds",
            )
        elif action == "readmit":
            logger.info(self.node, f"READMIT {peer} (round {rnd}): clean past probation")

    # --- query surface ---

    def quarantined(self) -> set[str]:
        """Peers currently excluded from this node's folds."""
        with self._lock:
            return {p for p, r in self._state.items() if r["active"]}

    def record_for(self, peer: str) -> "dict | None":
        with self._lock:
            rec = self._state.get(peer)
            return dict(rec) if rec is not None else None

    def actions(self) -> list[dict]:
        """This observer's action log (diagnostics; arrival-ordered —
        the deterministic cross-run surface is
        :func:`replay_decisions`)."""
        with self._lock:
            return [dict(a) for a in self._actions]

    def reset(self) -> None:
        with self._lock:
            self._state.clear()
            self._actions.clear()
            self._last.clear()

    # --- checkpoint ---

    def state_export(self) -> dict:
        """Checkpointable snapshot — per-peer quarantine/probation
        records, the action log and the verdict cache, as plain
        scalars/lists (tuples flattened) so it rides a msgpack blob. A
        resumed node keeps its verdicts:
        a quarantined peer stays masked across preemption instead of
        getting a fresh probation clock."""
        with self._lock:
            return {
                "state": {
                    p: {**r, "reasons": list(r.get("reasons", []))}
                    for p, r in self._state.items()
                },
                "actions": [dict(a) for a in self._actions],
                "last": {p: [v[0], dict(v[1])] for p, v in self._last.items()},
            }

    def state_import(self, state: dict) -> None:
        """Restore a :meth:`state_export` snapshot in place (the verdict
        cache's ``(round, verdict)`` tuples are rebuilt from the
        msgpack-flattened lists)."""
        with self._lock:
            self._state = {
                str(p): dict(r) for p, r in state.get("state", {}).items()
            }
            self._actions = [dict(a) for a in state.get("actions", [])][
                -_ACTION_LOG_CAP:
            ]
            self._last = {
                str(p): (int(v[0]), dict(v[1]))
                for p, v in state.get("last", {}).items()
            }


# --- deterministic verdict surface ----------------------------------------


def replay_decisions(
    detections: "dict | None" = None,
    probation: "int | None" = None,
) -> list[dict]:
    """Replay the quarantine state machine over the ledger's
    deterministic :meth:`ContributionLedger.detections` view.

    ``detections()`` dedups single-contributor entries by (peer, round)
    — pure functions of seed-deterministic state — so this replay is
    **byte-identical across same-seed runs** regardless of gossip
    arrival order or which observers happened to score which
    contribution (every contribution is scored at least at its own
    trainer's intake). Live engines enforce; this view is the receipt
    a run is judged by. Returns the ordered action list
    ``[{"peer", "round", "action", "reasons"}, ...]``.
    """
    if detections is None:
        detections = ledger.contrib.detections()
    if probation is None:
        probation = max(0, int(Settings.QUARANTINE_PROBATION_ROUNDS))
    entries = sorted(
        detections.get("entries", []),
        key=lambda e: (int(e["round"]), str(e["peer"])),
    )
    state: dict[str, dict] = {}
    actions: list[dict] = []
    for e in entries:
        peer, rnd = str(e["peer"]), int(e["round"])
        rec = state.get(peer)
        if e["flagged"]:
            if rec is None or not rec["active"]:
                state[peer] = {"active": True, "last_flag_round": rnd}
                actions.append(
                    {
                        "peer": peer,
                        "round": rnd,
                        "action": "quarantine",
                        "reasons": list(e["reasons"]),
                    }
                )
            else:
                rec["last_flag_round"] = max(rec["last_flag_round"], rnd)
                actions.append(
                    {
                        "peer": peer,
                        "round": rnd,
                        "action": "reject",
                        "reasons": list(e["reasons"]),
                    }
                )
        elif rec is not None and rec["active"]:
            if rnd - rec["last_flag_round"] > probation:
                rec["active"] = False
                actions.append(
                    {
                        "peer": peer,
                        "round": rnd,
                        "action": "readmit",
                        "reasons": [],
                    }
                )
            else:
                actions.append(
                    {
                        "peer": peer,
                        "round": rnd,
                        "action": "reject",
                        "reasons": ["probation"],
                    }
                )
    return actions


def quarantined_from_replay(actions: "list[dict] | None" = None) -> set[str]:
    """Final quarantined set implied by a :func:`replay_decisions` run."""
    if actions is None:
        actions = replay_decisions()
    active: set[str] = set()
    for a in actions:
        if a["action"] == "quarantine":
            active.add(a["peer"])
        elif a["action"] == "readmit":
            active.discard(a["peer"])
    return active


__all__ = ["QuarantineEngine", "quarantined_from_replay", "replay_decisions"]
