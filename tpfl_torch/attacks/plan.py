"""Declarative, seeded per-peer attack schedules — the port of
:mod:`tpfl.attacks.plan`.

An :class:`AttackPlan` names which peers attack, with which attack, over
which rounds, at what intensity (``always`` / ``once`` / ``ramp``); every
noise draw derives from ``(seed, crc32(peer), round, leaf)`` through the
port's copy of ``jax.random`` (:mod:`tpfl_torch.utils.threefry`), so two
same-(seed, plan) runs poison identically, and as the reference's plan
does. The plan is also the ground truth: :meth:`AttackPlan.adversary_map`
is what detection and quarantine are scored against, and
:meth:`AttackPlan.engine_scales` lowers its sign-flip schedule into the
engine's ``attack_scales``.

Schema (:meth:`AttackPlan.from_dict`)::

    {"seed": 7,
     "peers": {"node-3": {"attack": "sign_flip"},
               "node-6": {"attack": "additive_noise", "std": 0.1,
                           "mode": "ramp", "start": 2, "ramp_rounds": 3},
               "1":      {"attack": "sign_flip", "mode": "once", "start": 0}}}

Peer keys are addresses, or integer indices resolved against the node
list at :func:`apply_attack_plan` time. A "node" here is anything with
``addr`` and ``learner`` attributes. The async replay modes
(``stale_flood`` / ``withhold_replay``) parse and cache their first
contribution (:meth:`PlannedAdversary.shape_contribution`) as the
reference's do. :func:`apply_speed_plan` wraps a
:class:`~tpfl_torch.communication.faults.TrainerSpeedPlan`'s slow
trainers in :class:`SlowLearner`, and :func:`apply_chaos` wires an
attack plan, a fault plan and a speed plan into one federation.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass
from typing import Any, Iterable, Optional, Sequence

import numpy as np
import torch

from tpfl_torch.attacks.attacks import AdversarialLearner, add_noise
from tpfl_torch.settings import Settings
from tpfl_torch.utils import threefry
from tpfl_torch.utils.tree import canonical_map

ATTACKS = ("sign_flip", "additive_noise", "stale_flood", "withhold_replay")
MODES = ("always", "once", "ramp")

#: Async buffer-stuffing attacks: the adversary caches its FIRST
#: contribution and, while the schedule is active, replays it instead of
#: fitting. Parameters are never numerically poisoned.
REPLAY_ATTACKS = ("stale_flood", "withhold_replay")


@dataclass
class AttackSpec:
    """One peer's attack schedule.

    ``mode``: ``"always"`` poisons every fit in ``[start, end)``;
    ``"once"`` exactly the ``start`` fit; ``"ramp"`` scales the attack
    linearly from ``1/ramp_rounds`` at ``start`` to full strength over
    ``ramp_rounds`` fits (then holds until ``end``). ``std`` of None
    reads ``Settings.ATTACK_NOISE_STD`` at poison time.
    """

    attack: str = "sign_flip"
    mode: str = "always"
    start: int = 0
    end: Optional[int] = None
    std: Optional[float] = None
    ramp_rounds: int = 1

    def __post_init__(self) -> None:
        if self.attack not in ATTACKS:
            raise ValueError(f"Unknown attack {self.attack!r}: expected one of {ATTACKS}")
        if self.mode not in MODES:
            raise ValueError(f"Unknown mode {self.mode!r}: expected one of {MODES}")

    def strength(self, round: int) -> float:
        """Attack intensity in [0, 1] for one fit ordinal; 0 = honest."""
        if round < self.start:
            return 0.0
        if self.mode == "once":
            return 1.0 if round == self.start else 0.0
        if self.end is not None and round >= self.end:
            return 0.0
        if self.mode == "ramp":
            ramp = max(1, int(self.ramp_rounds))
            return min(1.0, (round - self.start + 1) / ramp)
        return 1.0

    @property
    def name(self) -> str:
        if self.attack == "additive_noise":
            std = self.std if self.std is not None else Settings.ATTACK_NOISE_STD
            return f"additive_noise(std={std})"
        return self.attack


class AttackPlan:
    """Seeded per-peer attack schedules, keyed by address (or node
    index, resolved when the plan is applied)."""

    def __init__(self, peers: "dict[Any, AttackSpec] | None" = None,
                 seed: Optional[int] = None) -> None:
        # unguarded: plan config — built once, read-only after.
        self.peers: dict[Any, AttackSpec] = dict(peers or {})
        self._seed = seed

    @property
    def seed(self) -> int:
        """Plan seed (falls back to Settings.SEED at use time)."""
        return (Settings.SEED or 0) if self._seed is None else self._seed

    @classmethod
    def from_dict(cls, spec: dict[str, Any]) -> "AttackPlan":
        peers: dict[Any, AttackSpec] = {}
        for key, s in (spec.get("peers") or {}).items():
            peers[key] = AttackSpec(**s)
        return cls(peers=peers, seed=spec.get("seed"))

    def spec_for(self, addr: str, index: Optional[int] = None) -> Optional[AttackSpec]:
        """The spec targeting ``addr`` (exact address key first, then the
        positional index as int or string)."""
        hit = self.peers.get(addr)
        if hit is None and index is not None:
            hit = self.peers.get(index)
            if hit is None:
                hit = self.peers.get(str(index))
        return hit

    # --- the poison itself (pure function of (seed, peer, round)) ---

    def poison(self, addr: str, round: int, spec: AttackSpec, params: Any) -> Any:
        """Apply ``spec`` at ``strength(round)`` to a parameter tree, on
        the leaves' device. Deterministic per (plan seed, addr, round,
        leaf index)."""
        alpha = spec.strength(round)
        if alpha <= 0.0 or spec.attack in REPLAY_ATTACKS:
            return params
        if spec.attack == "sign_flip":
            # alpha=1 is the negation; a ramped flip walks the params
            # through zero toward the mirror image. The scale is rounded
            # to the leaf's dtype first, as JAX's weak-typed scalar is.
            scale = 1.0 - 2.0 * alpha
            with torch.no_grad():
                return canonical_map(
                    lambda x: torch.tensor(scale, dtype=x.dtype, device=x.device) * x, params)
        std = spec.std if spec.std is not None else Settings.ATTACK_NOISE_STD
        base = threefry.fold_in(threefry.PRNGKey(self.seed), zlib.crc32(addr.encode()) & 0x7FFFFFFF)
        return add_noise(params, threefry.fold_in(base, int(round)), float(std) * alpha)

    def engine_scales(self, addrs: "Sequence[str]", n_rounds: int,
                      start_round: int = 0) -> np.ndarray:
        """This plan's sign-flip schedule as a ``[n_rounds, n]`` per-node
        multiplier array for ``FederationEngine.run_rounds(attack_scales=)``:
        ``1 − 2α`` at each round's ``strength()``. Other attack families
        have no multiplicative lowering and raise ``ValueError``."""
        out = np.ones((int(n_rounds), len(addrs)), np.float32)
        for i, addr in enumerate(addrs):
            spec = self.spec_for(addr, i)
            if spec is None:
                continue
            if spec.attack != "sign_flip":
                raise ValueError(
                    "engine_scales lowers sign_flip schedules only, "
                    f"got {spec.attack!r} for {addr!r}"
                )
            for r in range(int(n_rounds)):
                out[r, i] = 1.0 - 2.0 * spec.strength(start_round + r)
        return out

    def adversary_map(self, addrs: "Iterable[str] | None" = None) -> dict[str, str]:
        """Ground truth ``{addr: attack name}``. With ``addrs`` (the
        federation's addresses in index order) index keys resolve to
        their address; without, only address-keyed peers are returned."""
        resolved: dict[str, str] = {}
        addr_list = list(addrs) if addrs is not None else []
        for i, addr in enumerate(addr_list):
            spec = self.spec_for(addr, i)
            if spec is not None:
                resolved[addr] = spec.name
        if addrs is None:
            for key, spec in self.peers.items():
                if isinstance(key, str) and not key.isdigit():
                    resolved[key] = spec.name
        return resolved


class PlannedAdversary(AdversarialLearner):
    """Round-aware adversary driven by an :class:`AttackPlan`: every
    ``fit()`` trains honestly, then applies the plan's scheduled attack
    for this peer at this fit ordinal. The replay modes skip the real
    fit while active and rewrite the contribution through
    :meth:`shape_contribution`."""

    def __init__(self, inner: Any, plan: AttackPlan, index: Optional[int] = None) -> None:
        super().__init__(inner, attack=lambda p: p)
        self._plan = plan
        self._index = index
        # unguarded: only the learning thread calls fit().
        self._round = 0
        # (params, contributors, num_samples, version) of this peer's
        # FIRST contribution — what the replay modes re-send.
        # unguarded: only the learning thread fits/contributes.
        self._replay_cache: "tuple | None" = None

    def _spec(self) -> Optional[AttackSpec]:
        return self._plan.spec_for(self.get_addr(), self._index)

    def fit(self):
        spec = self._spec()
        if (spec is not None and spec.attack in REPLAY_ATTACKS
                and spec.strength(self._round) > 0.0 and self._replay_cache is not None):
            self._round += 1
            params, contributors, num_samples, _v = self._replay_cache
            model = self._inner.get_model().build_copy(
                params=params, contributors=list(contributors), num_samples=num_samples)
            self._last_fit_model = model
            return model
        model = self._inner.fit()
        rnd, self._round = self._round, self._round + 1
        if spec is not None and spec.strength(rnd) > 0.0:
            model.set_parameters(self._plan.poison(self.get_addr(), rnd, spec,
                                                   model.get_parameters()))
        self._last_fit_model = model
        return model

    def shape_contribution(self, model: Any, version: int) -> "tuple[Any, int]":
        """Async contribution seam: the replay modes substitute the cached
        first contribution and its original version tag; everything else
        passes through, caching the first one seen."""
        spec = self._spec()
        if spec is None or spec.attack not in REPLAY_ATTACKS:
            return model, version
        rnd = max(0, self._round - 1)
        if spec.strength(rnd) > 0.0 and self._replay_cache is not None:
            params, contributors, num_samples, v0 = self._replay_cache
            return (model.build_copy(params=params, contributors=list(contributors),
                                     num_samples=num_samples), int(v0))
        if self._replay_cache is None:
            try:
                contributors = model.get_contributors()
            except ValueError:
                contributors = [self.get_addr()]
            self._replay_cache = (model.get_parameters(), list(contributors),
                                  model.get_num_samples(), int(version))
        return model, version


def apply_attack_plan(nodes: "list[Any]", plan: AttackPlan) -> dict[str, str]:
    """Wrap every planned peer's learner in a :class:`PlannedAdversary`
    (``node.addr`` / ``node.learner``). Returns the resolved ground-truth
    adversary map."""
    truth: dict[str, str] = {}
    for i, node in enumerate(nodes):
        spec = plan.spec_for(node.addr, i)
        if spec is None:
            continue
        node.learner = PlannedAdversary(node.learner, plan, index=i)
        truth[node.addr] = spec.name
    return truth


class SlowLearner(AdversarialLearner):
    """Trainer-speed chaos: delegates every fit, then sleeps ``delay``
    seconds — the fitted parameters are the undelayed learner's."""

    def __init__(self, inner: Any, delay: float) -> None:
        super().__init__(inner, attack=lambda p: p)
        self._delay = float(delay)

    def fit(self):
        model = self._inner.fit()
        if self._delay > 0:
            time.sleep(self._delay)
        self._last_fit_model = model
        return model


def apply_speed_plan(nodes: "list[Any]", plan: Any) -> None:
    """Wire a :class:`tpfl_torch.communication.faults.TrainerSpeedPlan`
    into a federation (nodes must not be started yet): every planned
    node's learner is wrapped in a :class:`SlowLearner`, and under the
    async serialized discipline (``Settings.ASYNC_ROUNDS`` +
    ``ASYNC_SERIALIZED``) every node's aggregator gets its own fork of
    the plan-seeded :class:`~tpfl_torch.communication.faults
    .AsyncSchedule`, so arrival order serializes identically at every
    node and across same-seed runs."""
    from tpfl_torch.communication.faults import AsyncSchedule

    for node in nodes:
        delay = plan.delay_for(node.addr)
        if delay > 0:
            node.learner = SlowLearner(node.learner, delay)
    if Settings.ASYNC_ROUNDS and Settings.ASYNC_SERIALIZED:
        schedule = AsyncSchedule.for_plan(plan)
        for node in nodes:
            node.aggregator.set_async_schedule(schedule.fork())


def apply_chaos(
    nodes: "list[Any]",
    attack_plan: Optional[AttackPlan] = None,
    fault_plan: Optional[Any] = None,
    speed_plan: Optional[Any] = None,
    seed: Optional[int] = None,
) -> "tuple[dict[str, str], Any]":
    """One chaos spec for one federation: malicious peers (attack
    plan), drops/crashes/partitions (fault plan), and skewed trainer
    speeds (speed plan) in one wiring call, before the nodes start.
    Returns ``(adversary_map, fault_injector)`` — the injector (or None)
    is attached to every node's protocol and its schedule clock started.
    """
    truth: dict[str, str] = {}
    if attack_plan is not None:
        truth = apply_attack_plan(nodes, attack_plan)
    if speed_plan is not None:
        apply_speed_plan(nodes, speed_plan)
    injector = None
    if fault_plan is not None:
        from tpfl_torch.communication.faults import FaultInjector

        injector = FaultInjector(fault_plan, seed=seed)
        for node in nodes:
            injector.attach(node.communication)
        injector.start()
    return truth, injector


__all__ = ["ATTACKS", "AttackPlan", "AttackSpec", "MODES", "PlannedAdversary",
           "REPLAY_ATTACKS", "SlowLearner", "apply_attack_plan", "apply_chaos",
           "apply_speed_plan"]
