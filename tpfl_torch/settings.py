"""The port's configuration knobs — the subset of :class:`tpfl.settings.Settings`
that the ported modules read, with the reference's names, defaults and
docs.

Values are read at use time (per ``run_rounds`` call, per encode, per
aggregation intake), so assigning ``Settings.X`` takes effect on the next
use; ``LOCK_TRACING`` is read when a lock is built. Knobs are added here
as the modules that read them are ported. The flags of planes the port
does not have yet (``ASYNC_ROUNDS``, ``WIRE_DELTA``) keep their reference
defaults; the aggregator, or the encoder for ``WIRE_DELTA``, raises
``NotImplementedError`` when one is on.
"""

from __future__ import annotations

from typing import Any


class Settings:
    """Class-level configuration constants, mutable at run time."""

    # --- wire codec (model payload compression) ---
    WIRE_DTYPE: str | None = None
    """Downcast float parameters on the wire ("bfloat16"/"float16"; None
    = exact). Halves model-gossip bytes; receivers restore their model's
    own dtype on set. Lossy (~3 decimal digits for bf16) — FedAvg
    tolerates it, leave None for exact-repro runs. Applies to the DENSE
    codec only; WIRE_CODEC supersedes it."""

    WIRE_CODEC: str = "dense"
    """Model-payload wire codec (tpfl_torch.learning.compression):
    "dense" (v1/v3 envelope, exact, what old peers decode), or a
    '+'-composed stack of "quant8" (int8 symmetric per-leaf
    quantization), "topk" (top-k magnitude sparsification, index+value
    packing) and one entropy coder ("zlib", or "zstd" when the optional
    zstandard package is installed). E.g. "quant8+zlib". Validated at
    use time — unknown names raise ValueError."""

    WIRE_TOPK_FRAC: float = 0.05
    """Fraction of entries per leaf the "topk" codec keeps (by
    magnitude). Only read when the codec includes "topk"."""

    WIRE_ENTROPY_LEVEL: int = 1
    """Compression level for the entropy stage (zlib/zstd). 1 favors
    encode throughput — the gossip hot path encodes once per model
    version but at a 1000-node hub every CPU cycle is contended."""

    WIRE_DELTA: bool = False
    """Residual (delta) gossip: once a round's aggregate is adopted it
    becomes a BASE (tpfl_torch.learning.compression.BaseCache); the next
    round's full-model pushes to peers that acknowledged that base carry
    only ``current - base``, which quantizes/compresses far smaller than
    the full weights. A peer without the base refuses the payload
    (``DeltaBaseMismatchError``) and the sender falls back to dense.
    Choosing the base is the node runtime's, which is not ported:
    ``encode_parameters`` raises ``NotImplementedError`` while this is on
    and no ``delta_base=`` is passed."""

    WIRE_FORMAT: int = 3
    """Dense model-payload envelope version. 3 (default): the zero-copy
    layout — msgpack header (dtype/shape/offset table) + ONE contiguous
    payload; encode writes each leaf's bytes exactly once (card tensors
    through one device-to-host copy), decode returns read-only array
    views with zero per-leaf copies. 1: the legacy dense msgpack map,
    for federations that still contain pre-v3 peers (every node decodes
    v1, v2 AND v3 regardless of this setting — it only selects what WE
    emit). Compressed codecs (WIRE_CODEC) emit v2 envelopes
    independently of this knob."""

    # --- FL round protocol ---
    AGGREGATION_TIMEOUT: float = 300.0
    """Seconds ``Aggregator.wait_and_get_aggregation`` waits for the
    train set's contributions when no timeout is passed."""

    ASYNC_ROUNDS: bool = False
    """Master gate for the asynchronous (FedBuff-style buffered) round
    lifecycle of the reference. Not ported: the aggregator raises
    ``NotImplementedError`` while it is on."""

    # --- aggregation (streaming accumulators) ---
    AGG_STREAM_EAGER: bool = True
    """Fold contributions into the aggregator's on-device running
    accumulator AS THEY ARRIVE (Aggregator.accumulate/finalize) instead
    of reducing everything at round close. Peak memory for mean-style
    aggregators (FedAvg/FedProx/SCAFFOLD) is O(1 model) either way, but
    the eager path moves the reduce off the round's critical tail: by
    the time coverage completes, the aggregate is one finalize away.
    Trade-off: the fold runs in ARRIVAL order, so bit-exact run-to-run
    reproducibility of the aggregate (float addition is not associative)
    requires False, which folds the held models in canonical sorted
    order at close instead."""

    AGG_MEDIAN_RESERVOIR: int = 64
    """FedMedian's streaming state keeps at most this many contributions
    (seeded reservoir sampling beyond it) — an exact median up to the
    cap, an unbiased sampled median past it, and bounded memory at any
    federation size."""

    ROUND_QUORUM: float = 1.0
    """Fraction of the *live* train set whose contributions close a
    round's aggregation. 1.0 (default) = reference behavior: every
    expected contributor must report (or the timeout fires). When
    heartbeat loss evicts a train-set member mid-round the expected set
    shrinks to the live members (Aggregator.remove_dead_nodes);
    ROUND_QUORUM < 1.0 additionally lets aggregation close before
    slow-but-alive members report."""

    ASYNC_STALENESS_MAX: int = 16
    """Staleness plausibility bound of the ledger's anomaly scorer: a
    contribution past it (or whose version regresses) is flagged
    ``stale_flood``. Negative disables the test. Synchronous rounds
    (τ = 0) never trip it."""

    AGG_ROBUST_BUFFER: int = 64
    """Candidate-buffer budget of the robust aggregators (Krum /
    MultiKrum / TrimmedMean): at most this many per-round candidates on
    the device, with seeded reservoir sampling past the cap (exact up to
    the cap, an unbiased sample beyond it)."""

    # --- learning-plane observatory (contribution ledger) ---
    LEDGER_ENABLED: bool = False
    """Master gate for the learning-plane observatory
    (tpfl_torch.management.ledger): per-contribution update statistics
    (L2 norm, per-leaf norms, cosine vs the round-start reference and vs
    the running update mean — f32 torch ops on the aggregator's device),
    the bounded per-node ContributionLedger ring, the ConvergenceMonitor
    and the AnomalyScorer's sign-flip / norm-outlier detection. Off,
    every tap is one attribute read and adds no tensor op. Detection is
    observational: flags never change aggregation results."""

    LEDGER_RING: int = 1024
    """Contribution-ledger capacity: the last N records retained per
    node (also the anomaly scorer's running baseline window)."""

    LEDGER_ANOMALY_Z: float = 6.0
    """Robust z-score (vs the window's median / 1.4826·MAD) of a
    contribution's update L2 norm at or above which it is flagged a norm
    outlier (additive noise). Only applied once LEDGER_ANOMALY_MIN_N
    samples exist."""

    LEDGER_ANOMALY_COS: float = 0.0
    """Cosine against the round-start reference at or below which a
    contribution is flagged sign-flipped (a negated model sits at ≈ -1,
    honest ones at ≈ +1; no history needed)."""

    LEDGER_ANOMALY_MIN_N: int = 4
    """Minimum samples in the scorer's window before the norm-outlier
    z-test applies (the cosine test is exempt)."""

    LEDGER_CONVERGENCE_WINDOW: int = 5
    """Trailing window (rounds / fits) of the ConvergenceMonitor's
    plateau / divergence tests and the loss-trajectory slope."""

    # --- active Byzantine defense (quarantine) ---
    QUARANTINE_ENABLED: bool = False
    """Master gate for the active defense (tpfl_torch.management
    .quarantine): every single-contributor model at the aggregation
    intake is scored by the ledger's AnomalyScorer BEFORE it can fold;
    flagged contributions are excluded from the aggregate (kept as
    coverage-only passengers so the round still closes), the peer enters
    quarantine, and clean contributions earn re-admission after
    QUARANTINE_PROBATION_ROUNDS. Turns on the ledger's round state even
    when LEDGER_ENABLED is off. Unlike the ledger, verdicts change what
    aggregates."""

    QUARANTINE_PROBATION_ROUNDS: int = 2
    """Rounds a quarantined peer's contributions must score clean
    (strictly more than this many rounds past its last flagged round)
    before it is re-admitted. A flag during probation re-arms the
    window."""

    ATTACK_NOISE_STD: float = 0.1
    """Default standard deviation of the additive-noise attack when an
    AttackPlan rule does not set one (tpfl_torch.attacks.plan)."""

    # --- engine (device-side) wire codec ---
    ENGINE_WIRE_CODEC: str = "dense"
    """Device-side wire codec for the engine's gossip exchange
    (tpfl_torch.parallel.engine + tpfl_torch.learning.compression):
    "dense" (default), "quant8", "topk", or "topk+quant8". Non-dense
    runs the payload codec inside the round — each node's trained
    params pass the per-leaf int8-quantize→dequantize (or top-k mask)
    round trip before the fold, so every node folds what a receiver
    would decode. Lossy, like the host-side codec it mirrors (same
    arithmetic, same per-leaf policy); "dense" runs the round with no
    codec op at all. Entropy coders (zlib/zstd) and delta are host byte
    transforms and are rejected here at knob-read time. Read per
    ``run_rounds`` call; the top-k fraction rides ``WIRE_TOPK_FRAC``."""

    # --- concurrency ---
    LOCK_TRACING: bool = False
    """Opt-in runtime lock-order tracing (tpfl_torch.concurrency): every
    lock built through ``make_lock`` becomes a ``TracedLock`` that
    records the acquisition graph (lock A held while acquiring lock B ⇒
    edge A→B, witnessed by the acquiring thread's name); a cycle is a
    latent deadlock, and ``lock_graph.assert_acyclic()`` raises with the
    witness chain. Read at lock CREATION time, so it must be set before
    aggregators and pools are built. Off by default."""

    # --- determinism ---
    SEED: int | None = None
    """Global seed for reproducible experiments: a learner's batch
    order derives from ``(SEED or 0) + crc32(addr)``, FedMedian's
    reservoir from ``(SEED or 0) ^ crc32(node_name)``."""

    @classmethod
    def snapshot(cls) -> dict[str, Any]:
        """Capture all settings (for restoring after tests)."""
        return {k: getattr(cls, k) for k in dir(cls) if k.isupper() and not k.startswith("_")}

    @classmethod
    def restore(cls, snap: dict[str, Any]) -> None:
        for k, v in snap.items():
            setattr(cls, k, v)


__all__ = ["Settings"]
