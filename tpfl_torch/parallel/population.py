"""Cross-device population tier — the port of
:mod:`tpfl.parallel.population`: a large census of registered, mostly
offline clients, of which ``sample`` take part in any round.

:class:`ClientPopulation` holds O(touched) state only: the persistent
model lives in the engine, and a client record exists once that client
has folded. The engine's node rows serve as edge aggregators
(:meth:`~ClientPopulation.edge_assignment`); :meth:`~ClientPopulation.round_weights`
zeroes a seeded straggler fraction and
:meth:`~ClientPopulation.straggler_schedule` lowers the same skew to a
:class:`~tpfl_torch.parallel.engine.FedBuffSchedule`. The draws are the
reference's numpy draws, so cohorts, weights and schedules are the JAX
package's bit for bit; :meth:`~ClientPopulation.state_export` rides
``FederationEngine.export_state`` into ``EngineCheckpointer``, and a
snapshot written by either package restores in the other.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from tpfl_torch.learning.serialization import leaf_bytes
from tpfl_torch.management import fleetobs
from tpfl_torch.parallel.engine import FedBuffSchedule, sample_participants
from tpfl_torch.settings import Settings

__all__ = ["ClientPopulation"]


class ClientPopulation:
    """A registered cross-device census sampling K participants/round.

    ``registered`` / ``sample`` default to
    ``Settings.POPULATION_CLIENTS`` / ``Settings.POPULATION_SAMPLE``;
    ``seed`` keys every draw — same census, same seed, same round ⇒
    the same cohort, byte for byte (the engine's determinism
    discipline extended over sampling). ``self.round`` is the
    population's own round cursor, advanced by
    :meth:`complete_round` and restored by checkpoints.
    """

    def __init__(
        self,
        registered: Optional[int] = None,
        sample: Optional[int] = None,
        seed: int = 0,
    ) -> None:
        self.registered = int(
            registered
            if registered is not None
            else Settings.POPULATION_CLIENTS
        )
        self.sample = int(
            sample if sample is not None else Settings.POPULATION_SAMPLE
        )
        if self.registered <= 0:
            raise ValueError(
                f"population needs registered > 0, got {self.registered} "
                f"(set Settings.POPULATION_CLIENTS or pass registered=)"
            )
        if not (0 < self.sample <= self.registered):
            raise ValueError(
                f"cannot sample {self.sample} of {self.registered} "
                f"registered clients"
            )
        self.seed = int(seed)
        self.round = 0
        # O(touched), never O(registered): a record exists only once a
        # client has folded. int keys in memory; stringified for the
        # msgpack checkpoint (state_export).
        self.clients: dict[int, dict] = {}
        # The ONE allowed O(census) structure: a coverage
        # BITSET — one bit per registered client, set the first time
        # the sampler reaches it. 1M census = 125 KB; everything else
        # in the observatory stays O(1)/O(touched).
        self._coverage = np.zeros((self.registered + 7) // 8, np.uint8)
        # ephemeral: derived sketch — the coverage bitset's popcount,
        # recomputed exactly from the exported bitset on import.
        self._sampled_count = 0
        # ephemeral: derived sketch — Jain-fairness Σ rounds over
        # touched clients, recomputed from the clients dict on import.
        self._part_sum = 0
        # ephemeral: derived sketch — Jain-fairness Σ rounds² over
        # touched clients, recomputed from the clients dict on import.
        self._part_sumsq = 0
        # ephemeral: runtime binding — re-established by bind() when
        # the restored population re-attaches (import_state calls it).
        self._engine: Optional[Any] = None

    # --- engine binding ---------------------------------------------------

    def bind(self, engine: Any) -> None:
        """Called by ``FederationEngine.attach_population``: remember
        the engine whose resident nodes serve as this population's
        edge aggregators. The engine's node axis is the round's
        working set — it must hold the sampled cohort."""
        if engine is not None and self.sample > int(engine.n_nodes):
            raise ValueError(
                f"sampled cohort of {self.sample} does not fit the "
                f"engine's {engine.n_nodes} node rows"
            )
        self._engine = engine

    # --- the per-round cycle ----------------------------------------------

    def begin_round(self, round: Optional[int] = None) -> np.ndarray:
        """The round's cohort: ``sample`` distinct client ids drawn
        from the census, seeded by ``(seed, round)`` — recomputable at
        any time (resume re-draws the same cohort from the restored
        round cursor)."""
        r = self.round if round is None else int(round)
        return sample_participants(self.registered, self.sample, self.seed, r)

    def edge_assignment(
        self, ids: Any, n_edges: Optional[int] = None
    ) -> np.ndarray:
        """Edge-aggregator index per sampled client — the two-level
        topology's attach step. Round-robin over the cohort's sorted
        order: deterministic, and balanced to within one client per
        edge. ``n_edges`` defaults to the bound engine's logical node
        count (every resident node serves as an edge)."""
        if n_edges is None:
            if self._engine is None:
                raise ValueError(
                    "edge_assignment needs n_edges= or a bound engine"
                )
            n_edges = int(self._engine.n_nodes)
        ids = np.asarray(ids)
        return np.arange(ids.shape[0]) % max(1, int(n_edges))

    def round_weights(
        self,
        ids: Any,
        cutoff_frac: float = 0.0,
        round: Optional[int] = None,
    ) -> np.ndarray:
        """[K] fold weights for the cohort with a seeded
        ``cutoff_frac`` of stragglers ZEROED — the quorum-degradation
        reuse: a cut client's row rides the dispatch untouched and the
        masked fold ignores it exactly, so the straggler cutoff costs
        no recompile and no shape change. At least one client always
        survives (an all-zero round would re-enter the uniform
        fallback with semantics no cross-device tier wants)."""
        ids = np.asarray(ids)
        k = int(ids.shape[0])
        w = np.ones((k,), np.float32)
        frac = float(cutoff_frac)
        if frac <= 0.0:
            return w
        r = self.round if round is None else int(round)
        n_cut = min(int(frac * k), k - 1)
        if n_cut > 0:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, r, 1])
            )
            w[rng.choice(k, size=n_cut, replace=False)] = 0.0
        return w

    def straggler_schedule(
        self,
        n_rounds: int,
        straggler_frac: float = 0.25,
        max_staleness: int = 2,
        start_round: Optional[int] = None,
    ) -> FedBuffSchedule:
        """The FedBuff path for the cohort: a seeded
        ``straggler_frac`` of the K participants run on longer arrival
        periods (up to ``max_staleness + 1`` rounds), so their
        contributions fold late and staleness-weighted instead of
        dropping — :meth:`FedBuffSchedule.from_periods` over the
        sampled cohort, with the population's seed/round keying the
        draw."""
        r0 = self.round if start_round is None else int(start_round)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, r0, 2])
        )
        periods = np.ones((self.sample,), np.int64)
        n_slow = min(int(float(straggler_frac) * self.sample),
                     self.sample - 1)
        if n_slow > 0:
            slow = rng.choice(self.sample, size=n_slow, replace=False)
            periods[slow] = rng.integers(
                2, max(2, int(max_staleness) + 1) + 1, size=n_slow
            )
        return FedBuffSchedule.from_periods(
            periods, int(n_rounds), start_round=r0
        )

    def complete_round(
        self,
        ids: Any,
        weights: Optional[Any] = None,
        losses: Optional[Any] = None,
    ) -> None:
        """Commit one round: advance the round cursor and the folded
        clients' records (stragglers — w=0 rows — do not advance:
        their contribution never folded). ``losses`` (optional,
        positionally aligned with ``ids``) lands in each record as
        the client's last observed loss.

        The commit walk doubles as the population observatory's
        sampling point: every sampled id — cut or not —
        sets its coverage bit (the sampler REACHED it), each folding
        client's staleness gap (rounds since it last folded, 0 for a
        first participation) is captured before its record advances,
        and the Jain-fairness partial sums track the fold-count bump
        in O(1). The round's sketch then fans out through
        :func:`tpfl_torch.management.fleetobs.population_round` as
        ``tpfl_pop_*`` series + one ``population_round`` flight event
        — all O(touched) work the walk was already paying for."""
        ids = np.asarray(ids, np.int64)
        w = (
            np.ones((ids.shape[0],), np.float32)
            if weights is None
            else np.asarray(weights, np.float32)
        )
        # Coverage: vectorized bitset update. Sampled ids are distinct
        # (sample without replacement) so distinct (byte, bit) pairs —
        # the pre-update gather counts newly-reached clients exactly;
        # bitwise_or.at accumulates correctly when ids share a byte.
        if ids.size:
            byte_idx = ids >> 3
            bit = (np.uint8(1) << (ids & 7).astype(np.uint8))
            old = self._coverage[byte_idx]
            self._sampled_count += int(np.count_nonzero((old & bit) == 0))
            np.bitwise_or.at(self._coverage, byte_idx, bit)
        staleness: list[float] = []
        folded = 0
        for pos, cid in enumerate(ids):
            if w[pos] <= 0:
                continue
            folded += 1
            rec = self.clients.setdefault(
                int(cid), {"rounds": 0, "last_round": -1, "loss": 0.0}
            )
            prior = int(rec["rounds"])
            staleness.append(
                float(self.round - int(rec["last_round"])) if prior else 0.0
            )
            # Fairness partial sums: rounds c -> c+1 moves Σc by 1 and
            # Σc² by 2c+1 — Jain's index stays an O(1) read.
            self._part_sum += 1
            self._part_sumsq += 2 * prior + 1
            rec["rounds"] = prior + 1
            rec["last_round"] = int(self.round)
            if losses is not None:
                rec["loss"] = float(np.asarray(losses)[pos])
        committed = int(self.round)
        self.round += 1
        fleetobs.population_round(
            "population",
            round=committed,
            census=self.registered,
            sampled=int(ids.shape[0]),
            folded=folded,
            cut=int(ids.shape[0]) - folded,
            touched=len(self.clients),
            coverage=self.coverage,
            fairness=self.fairness,
            staleness=staleness,
        )

    @property
    def touched(self) -> int:
        """Clients that have ever folded — the snapshot's size."""
        return len(self.clients)

    @property
    def coverage(self) -> float:
        """Fraction of the census the sampler has EVER reached (the
        coverage bitset's popcount over ``registered``) — cut clients
        count: they were drawn, only their fold was dropped."""
        return self._sampled_count / float(self.registered)

    @property
    def fairness(self) -> float:
        """Jain's index over touched clients' participation counts:
        ``(Σc)² / (touched · Σc²)`` — 1.0 is perfectly even service,
        →1/touched is one client hoarding every fold. 1.0 for an
        untouched census (no service yet = no unfairness yet)."""
        if not self.clients or self._part_sumsq == 0:
            return 1.0
        return (self._part_sum * self._part_sum) / (
            len(self.clients) * float(self._part_sumsq)
        )

    # --- checkpoint state -------------------------------------------------

    def state_export(self) -> dict:
        """O(touched) snapshot (msgpack-safe: client ids stringify —
        flax's serializer requires str keys)."""
        return {
            "registered": int(self.registered),
            "sample": int(self.sample),
            "seed": int(self.seed),
            "round": int(self.round),
            # The coverage bitset rides as raw bytes (msgpack bin,
            # 125 KB at a 1M census) — bytes, not ndarray, so the
            # snapshot dict stays ==-comparable for contract checks.
            "coverage": bytes(leaf_bytes(self._coverage)),
            "clients": {
                str(cid): {
                    "rounds": int(rec["rounds"]),
                    "last_round": int(rec["last_round"]),
                    "loss": float(rec["loss"]),
                }
                for cid, rec in self.clients.items()
            },
        }

    def state_import(self, state: dict) -> None:
        self.registered = int(state["registered"])
        self.sample = int(state["sample"])
        self.seed = int(state["seed"])
        self.round = int(state["round"])
        self.clients = {
            int(cid): {
                "rounds": int(rec["rounds"]),
                "last_round": int(rec["last_round"]),
                "loss": float(rec["loss"]),
            }
            for cid, rec in dict(state.get("clients", {})).items()
        }
        n_bytes = (self.registered + 7) // 8
        cov = state.get("coverage")
        if cov is not None:
            self._coverage = np.zeros(n_bytes, np.uint8)
            arr = (
                np.frombuffer(cov, np.uint8)
                if isinstance(cov, (bytes, bytearray))
                else np.asarray(cov, np.uint8).ravel()
            )
            self._coverage[: min(arr.size, n_bytes)] = arr[:n_bytes]
        else:
            # A checkpoint without the bitset: best-effort rebuild — folded
            # clients were certainly sampled; cut-only clients are
            # unrecoverable, so coverage restores as a lower bound.
            self._coverage = np.zeros(n_bytes, np.uint8)
            for cid in self.clients:
                self._coverage[cid >> 3] |= np.uint8(1 << (cid & 7))
        # Derived sketches recompute exactly from the restored state.
        self._sampled_count = int(np.unpackbits(self._coverage).sum())
        self._part_sum = sum(
            int(rec["rounds"]) for rec in self.clients.values()
        )
        self._part_sumsq = sum(
            int(rec["rounds"]) ** 2 for rec in self.clients.values()
        )

    @classmethod
    def from_state(cls, state: dict) -> "ClientPopulation":
        pop = cls(
            registered=int(state["registered"]),
            sample=int(state["sample"]),
            seed=int(state["seed"]),
        )
        pop.state_import(state)
        return pop
