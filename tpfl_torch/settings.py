"""The port's configuration knobs — a copy of :class:`tpfl.settings.Settings`:
all of its knobs with the reference's names and defaults, its profiles
(``set_test_settings``, ``set_standalone_settings``,
``set_scale_settings``), ``snapshot`` / ``restore`` and ``from_env``
(``TPFL_<NAME>`` environment overrides).

Values are read at use time (per ``run_rounds`` call, per encode, per
aggregation intake, per stage), so assigning ``Settings.X`` takes effect
on the next use; ``LOCK_TRACING`` is read when a lock is built and
``ASYNC_LOGGER`` when the logger is.

Knobs of planes the port has not ported keep the reference's defaults so
that a configuration moves between the packages unchanged. Two tables
say what becomes of them. ``UNPORTED_SWITCHES`` holds the knobs that
turn such a plane on by themselves: :meth:`Settings.refuse_unported`
raises ``NotImplementedError`` naming the ``ROADMAP.md`` item while one
of them is on, and ``Node`` and ``FederationEngine`` call it where they
start. ``UNPORTED_KNOBS`` holds the knobs that only tune such a plane,
each with the entry point through which the reference enters it; the
port refuses that entry point, or does not have it.
"""

from __future__ import annotations

import os
from typing import Any

from tpfl_torch.exceptions import (
    ENGINE_ITEM,
    MULTI_DEVICE_ITEM,
    REST_ITEM,
    SIMULATION_ITEM,
    not_ported,
)


class Settings:
    """Class-level configuration constants, mutable before node start."""

    # --- gRPC / transport ---
    GRPC_TIMEOUT: float = 10.0
    """Timeout (s) of the reference's gRPC unary calls. Carried for parity;
    the port does not read it (``UNPORTED_KNOBS``)."""

    MAX_MESSAGE_SIZE: int = 1024 * 1024 * 1024
    """Largest gRPC message (1 GiB) of the reference's transport. Carried for
    parity; the port does not read it (``UNPORTED_KNOBS``)."""

    ELECTION: str = "vote"
    """Train-set election mode. "vote" (default): the reference's
    random-weight vote — every node floods a vote and tallies; O(N²)
    messages per round plus a VOTE_TIMEOUT wait whenever any vote is
    missing. "hash": deterministic sortition — rank candidates by
    H(beacon, exp_name, round, addr) and take the top TRAIN_SET_SIZE;
    zero messages, zero wait, and all nodes agree whenever their
    membership views agree. The per-round set still rotates
    pseudo-randomly with the round number.

    Adversarial model: the rank mixes in a per-experiment beacon (the
    sha256 of the initiator's init-model bytes, carried by the
    StartLearning broadcast — ``stages.base_node.election_rank``), so an
    address committed before the experiment starts cannot be ground to
    rank top-K. An adversary that joins after seeing the beacon, or an
    initiator grinding its init weights, still can: deployments that
    cannot pre-commit membership keep "vote" and pair hash election with
    a robust aggregator (``tpfl_torch.learning.aggregators.robust``)."""

    INIT_GOSSIP_STATIC_EXIT_S: float = 30.0
    """Wall-clock quiet window before the init-weights diffusion stops
    pushing to silent neighbors (StartLearningStage). Iteration-count
    exits proved too aggressive at 500-node scale, where the
    StartLearning flood itself takes tens of seconds to spread."""

    GRPC_SERVER_WORKERS: int = 16
    """Handler threads of the reference's gRPC server. Carried for parity; the
    port does not read it (``UNPORTED_KNOBS``)."""

    # --- transport resilience (retry / circuit breaker) ---
    RETRY_MAX_ATTEMPTS: int = 3
    """Total attempts per outbound send (unary and streamed): 1 = the
    reference's fire-once behavior. Retries are safe — control messages
    dedup by hash at the receiver, weight payloads by round/contributor
    bookkeeping — so a duplicate delivery from a retried send that
    actually arrived is absorbed."""

    RETRY_BASE_DELAY: float = 0.05
    """Backoff before retry k is ``min(RETRY_MAX_DELAY,
    RETRY_BASE_DELAY * 2**k)`` scaled by equal jitter in [0.5, 1.5)
    drawn from a per-node seeded RNG (deterministic under
    Settings.SEED)."""

    RETRY_MAX_DELAY: float = 2.0
    """Cap on a single backoff sleep (seconds)."""

    BREAKER_THRESHOLD: int = 3
    """Consecutive *failed sends* (each already retried
    RETRY_MAX_ATTEMPTS times) to a neighbor before its circuit opens:
    the peer is marked suspect, evicted from the table, and no longer
    costs send budget. The reference evicts on the FIRST failed send
    (grpc_client.py:176-183), which a single lost packet can trigger."""

    BREAKER_PROBE_PERIOD: float = 10.0
    """Seconds between half-open reconnect probes to a suspect peer
    (rides the heartbeater cadence, so the effective period is
    ``max(BREAKER_PROBE_PERIOD, HEARTBEAT_PERIOD)``). A successful
    probe handshake — or an incoming beat from the peer — closes the
    circuit and re-admits it."""

    # --- logging ---
    LOG_LEVEL: str = "INFO"
    """Level of the port's logger, read when the logger is built."""
    FILE_LOGGER: bool = True
    """Also write every log record to a rotating file in ``LOG_DIR``
    (created at the first record). Read per record."""
    LOG_DIR: str = "logs"
    """Directory of the rotating log file, relative to the working directory."""
    LOG_FILE_MAX_BYTES: int = 10_000_000
    """Size (bytes) at which the log file rotates."""
    LOG_FILE_BACKUP_COUNT: int = 3
    """Rotated log files kept beside the current one."""
    ASYNC_LOGGER: bool = True
    """Hand log records to a queue drained by a listener thread, so a
    node's threads never wait on handler I/O. Read when the logger is
    built (at import)."""

    # --- simulation ---
    DISABLE_SIMULATION: bool = False
    """When True, a node's learner runs inline. That is the port's only
    path: a ``Node`` refuses False (the reference's pooled simulation
    learner, ``ROADMAP.md`` §1 item 5)."""

    SIM_WORKERS: int = 0
    """Fallback threads of the reference's simulation pool. Carried for
    parity; the port does not read it (``UNPORTED_KNOBS``)."""

    SIM_BATCH_WINDOW: float = 0.2
    """Seconds the reference's simulation pool gathers a train set's fits.
    Carried for parity; the port does not read it (``UNPORTED_KNOBS``)."""

    SIM_BATCH_MAX_WAIT: float = 5.0
    """Cap (s) on the reference's pool holding a fit group open. Carried for
    parity; the port does not read it (``UNPORTED_KNOBS``)."""

    SIM_MAX_BATCH_NODES: int = 128
    """Chunk size of the reference's batched fit. Carried for parity; the port
    does not read it (``UNPORTED_KNOBS``)."""

    SIM_PROCESS_ISOLATION: bool = False
    """Process isolation of the reference's pool fallback fits. Carried for
    parity; the port does not read it (``UNPORTED_KNOBS``)."""

    # --- heartbeat ---
    HEARTBEAT_PERIOD: float = 2.0
    HEARTBEAT_TIMEOUT: float = 5.0

    # --- gossip (control plane) ---
    GOSSIP_PERIOD: float = 0.1
    TTL: int = 10
    GOSSIP_MESSAGES_PER_PERIOD: int = 100
    AMOUNT_LAST_MESSAGES_SAVED: int = 100

    # --- gossip (model data plane) ---
    GOSSIP_MODELS_PERIOD: float = 1.0
    GOSSIP_MODELS_PER_ROUND: int = 2
    GOSSIP_EXIT_ON_X_EQUAL_ROUNDS: int = 10
    # Downcast float parameters on the wire ("bfloat16"/"float16"; None
    # = exact). Halves model-gossip bytes over DCN; receivers restore
    # their model's own dtype on set. Lossy (~3 decimal digits for
    # bf16) — FedAvg tolerates it, leave None for exact-repro runs.
    # Applies to the DENSE codec only; WIRE_CODEC supersedes it.
    WIRE_DTYPE: str | None = None
    """Downcast float parameters on the wire ("bfloat16"/"float16"; None
    = exact). Halves model-gossip bytes; receivers restore their model's
    own dtype on set. Lossy (~3 decimal digits for bf16) — FedAvg
    tolerates it, leave None for exact-repro runs. Applies to the DENSE
    codec only; WIRE_CODEC supersedes it."""

    # --- wire codec (model payload compression) ---
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
    becomes a base (``tpfl_torch.learning.compression.BaseCache``) and
    ``GossipModelStage``'s full-model pushes to a peer that announced
    that round carry ``current - base``; a peer missing the base nacks
    (``codec_nack``) and gets the dense payload."""

    WIRE_CHUNK_SIZE: int = 256 * 1024
    """Chunk size (bytes) of the reference's gRPC payload streaming. Carried
    for parity; the port does not read it (``UNPORTED_KNOBS``)."""

    # --- zero-copy model plane ---
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

    INPROC_ZERO_COPY: bool = False
    """In-memory transport fast path: hand model payloads between
    co-located nodes by reference
    (``tpfl_torch.learning.serialization.InprocModelRef``) — no encode,
    no decode, no bytes. Contributor metadata is copied, so neither
    side can mutate the other's. Off by default for reference parity;
    the scale profile enables it."""

    BUFFER_POOL_BUFFERS: int = 8
    """Max reusable serialization buffers a BufferPool retains
    (tpfl.learning.bufferpool). The steady state is one buffer per
    node, reused every encode; extras cover concurrent encode paths
    (gossiper + relay + init diffusion)."""

    BUFFER_POOL_MAX_BYTES: int = 256 * 1024 * 1024
    """Cap on the total bytes a BufferPool may keep pooled. Returned
    buffers that would exceed it are freed instead of pooled."""

    # --- SSL / mTLS ---
    USE_SSL: bool = False
    """mTLS of the reference's gRPC transport. Carried for parity; the port
    does not read it (``UNPORTED_KNOBS``)."""
    CA_CRT: str = ""
    """CA certificate of the reference's gRPC mTLS. Carried for parity; the
    port does not read it (``UNPORTED_KNOBS``)."""
    SERVER_CRT: str = ""
    """Server certificate of the reference's gRPC mTLS. Carried for parity;
    the port does not read it (``UNPORTED_KNOBS``)."""
    SERVER_KEY: str = ""
    """Server key of the reference's gRPC mTLS. Carried for parity; the port
    does not read it (``UNPORTED_KNOBS``)."""
    CLIENT_CRT: str = ""
    """Client certificate of the reference's gRPC mTLS. Carried for parity;
    the port does not read it (``UNPORTED_KNOBS``)."""
    CLIENT_KEY: str = ""
    """Client key of the reference's gRPC mTLS. Carried for parity; the port
    does not read it (``UNPORTED_KNOBS``)."""

    # --- FL round protocol ---
    TRAIN_SET_SIZE: int = 4
    VOTE_TIMEOUT: float = 60.0
    AGGREGATION_TIMEOUT: float = 300.0
    """Seconds ``Aggregator.wait_and_get_aggregation`` waits for the
    train set's contributions when no timeout is passed."""
    WAIT_HEARTBEATS_CONVERGENCE: float = 0.2

    # --- asynchronous buffered rounds (FedBuff-style) ---
    ASYNC_ROUNDS: bool = False
    """Master gate for the asynchronous round lifecycle
    (``stages.base_node.AsyncRoundStage``): every live peer trains
    continuously and contributes whenever its fit finishes — no vote
    election and no slowest-trainer barrier. Each node's aggregator
    folds arrivals as a buffered FedBuff-style round
    (``Aggregator.set_nodes_to_aggregate(async_k=...)``): a
    contribution trained from model-version ordinal ``v`` folding into
    round ``r`` carries staleness ``τ = r - v`` and weight
    ``num_samples / (1 + τ)**ASYNC_STALENESS_EXP``; the round closes on
    buffer-full (``ASYNC_BUFFER_K`` distinct contributors) or the
    ``ASYNC_ROUND_DEADLINE`` failsafe. Off (default): the synchronous
    vote/train/wait lifecycle."""

    ASYNC_BUFFER_K: int = 4
    """Contributions (distinct contributors) that close an async
    round's buffer — FedBuff's K. Clamped per round to the live peer
    count; 1 is the degenerate fully-sequential buffer (every single
    contribution makes a round)."""

    ASYNC_STALENESS_EXP: float = 0.5
    """Staleness-decay exponent: a contribution ``τ`` versions stale
    folds at weight ``w(τ) = 1/(1+τ)**exp`` times its sample count.
    0 disables staleness discounting (pure buffered FedAvg); 0.5 is
    FedBuff's ``1/sqrt(1+τ)``."""

    ASYNC_ROUND_DEADLINE: float = 30.0
    """Failsafe (s) on an async round staying open short of
    ASYNC_BUFFER_K contributions: at the deadline the round closes
    with whatever the buffer holds (``round_deadline`` flight event +
    ``tpfl_agg_deadline_total``). An EMPTY buffer at the deadline
    fails open loudly — the round stays open and the stage re-arms the
    deadline."""

    ASYNC_SERIALIZED: bool = True
    """Deterministic async discipline (test/standalone profiles):
    arrivals buffer without folding and the round-close fold runs in a
    deterministic order — schedule order when a seeded
    :class:`tpfl_torch.communication.faults.AsyncSchedule` is attached
    to the aggregator (the reorder buffer that makes same-seed runs
    byte-identical), else canonical (contributor-sorted) order, each fit
    inline on the learning thread. False (scale profile): free-running —
    a trainer thread per node, contributions fold eagerly in arrival
    order, no reproducibility guarantee."""

    ASYNC_ADAPTIVE: bool = False
    """Adaptive async control plane
    (:class:`tpfl_torch.learning.async_control.AsyncController`): when
    on, each node tunes its effective buffer K and round deadline per
    round from the observed inter-arrival and staleness distributions,
    bounded by [ASYNC_K_MIN, ASYNC_K_MAX] and (0, ASYNC_ROUND_DEADLINE].
    In serialized mode the observations derive from the seeded
    AsyncSchedule's virtual clock (arrival ordinals without one), so
    same-seed runs keep identical trajectories at every node. Off
    (default): the static knobs."""

    ASYNC_K_MIN: int = 2
    """Lower bound on the adaptive controller's effective buffer K
    (ASYNC_ADAPTIVE)."""

    ASYNC_K_MAX: int = 16
    """Upper bound on the adaptive controller's effective buffer K
    (further clamped per round to the live fleet size)."""

    ASYNC_CTL_EWMA: float = 0.3
    """EWMA smoothing factor of the controller's per-round observation
    summaries: ``s <- (1-a)*s + a*x``. Only read when ASYNC_ADAPTIVE."""

    ASYNC_CTL_QUANTILE: float = 0.9
    """Inter-arrival quantile the controller's deadline targets: the
    effective deadline covers ``K`` arrivals at this quantile (x a fixed
    4x margin), clamped to ASYNC_ROUND_DEADLINE. Only read when
    ASYNC_ADAPTIVE."""

    ASYNC_STALENESS_MAX: int = 16
    """Staleness plausibility bound, two consumers: the robust
    aggregators (Krum/MultiKrum/TrimmedMean) reject buffered candidates
    whose ``τ`` exceeds it at finalize (boundary τ == max is kept; an
    all-rejected buffer fails open), and the ledger's anomaly scorer
    flags a contribution past it — or whose version regresses — as
    ``stale_flood``. Negative disables both."""

    ASYNC_UNTAGGED_POLICY: str = "fresh"
    """Staleness of an UNTAGGED async contribution (``Message.version ==
    -1``): "fresh" — τ=0, full weight; "max-stale" — τ =
    ASYNC_STALENESS_MAX; "reject" — refused at intake
    (``tpfl_agg_untagged_rejected_total``). Sync rounds ignore it."""

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

    # --- observability ---
    RESOURCE_MONITOR_PERIOD: float = 1.0
    """Period (s) of the reference's per-node resource monitor. Carried for
    parity; the port does not read it (``UNPORTED_KNOBS``)."""

    TELEMETRY_ENABLED: bool = False
    """Master gate for hop-level tracing (``tpfl_torch.management.tracing``):
    when on, payload encodes mint deterministic trace ids and every hop
    (encode / send / recv / decode / fold, stages, retries, breaker
    trips, quorum degradation, ledger and quarantine records) lands in
    the per-node flight recorder ring, which ``Node.stop``, injected
    crashes and quorum degradation dump. Off: one attribute read per
    instrumented call. The metrics registry (``logger.metrics``) records
    regardless."""

    TELEMETRY_RING: int = 512
    """Flight-recorder capacity per node (spans + events, oldest evicted
    first), read when a node's ring is created."""

    TELEMETRY_MAX_LABELSETS: int = 64
    """Label-set cap per metric of the process metrics registry: further
    label sets of a metric collapse into one ``overflow="true"`` series."""

    TELEMETRY_DUMP_DIR: str = ""
    """Directory for flight-recorder dumps (``flight-<node>-<reason>.json``,
    the document ``tools/traceview.py`` reads); empty writes none. A
    node's dumps (stop, injected crash, quorum degradation) honour it;
    ``FederationEngine`` refuses a non-empty value, since the engine's
    telemetry fan-out is not ported (``UNPORTED_SWITCHES``, ``ROADMAP.md``
    §1 item 4)."""

    METRIC_MAX_POINTS: int = 4096
    """Per-series point cap in the local / global metric stores
    (``tpfl_torch.management.metric_storage``): a series keeps the most
    recent N points, evicting oldest-first."""

    FLEETOBS_SNAPSHOT_PERIOD: float = 0.0
    """Cadence (s) of the reference's fleet snapshot publisher. Carried for
    parity; the port does not read it (``UNPORTED_KNOBS``)."""

    FLEETOBS_DIR: str = ""
    """Directory of the reference's fleet snapshots. Carried for parity; the
    port does not read it (``UNPORTED_KNOBS``)."""

    SLO_TARGETS: str = ""
    """Service-level objectives of the reference's SLO watchdog. Carried for
    parity; the port does not read it (``UNPORTED_KNOBS``)."""

    SLO_EWMA: float = 0.3
    """EWMA factor of the reference's SLO watchdog. Carried for parity; the
    port does not read it (``UNPORTED_KNOBS``)."""

    SLO_BREACH_WINDOWS: int = 2
    """Violating evaluations before the reference's SLO watchdog fires.
    Carried for parity; the port does not read it (``UNPORTED_KNOBS``)."""

    GOSSIP_METRICS: bool = True
    """Broadcast eval metrics to the federation after each round
    (reference MetricsCommand behavior). At N nodes each broadcast
    TTL-floods through every node — O(N²) handler work per round for
    observability only — so the scale profile turns it off (metrics
    still log locally; the experiment result does not depend on it)."""

    AGGREGATION_STALL: float | None = None
    """When set, a trainer whose aggregation intake has gone quiet for
    this many seconds (holding at least one contribution, full coverage
    not reached) proceeds with the partial aggregate instead of waiting
    out AGGREGATION_TIMEOUT. None (default) = reference behavior: wait
    the full timeout. The window must exceed the worst single-payload
    delivery time (encode + wire + decode + ``add_model``), or the
    stall fires mid-exchange and fractures the aggregate. Timed on the
    monotonic clock."""

    ROUND_WAIT_POLL: float = 0.5
    """Upper bound (s) on the round-result wait's poll interval. A
    FullModel arrival wakes waiters at once through the event; this
    bounds only how fast early-stop / local-coverage conditions are
    noticed."""

    # --- device-plane profiling ---
    PROFILING_ENABLED: bool = False
    """Master gate for the round profiler
    (``tpfl_torch.management.profiling.rounds``): per-round wall-clock
    attribution into vote / train / fold / gossip / host_other. Off, a
    span is one attribute read and nothing is recorded. Read at use
    time."""

    PROFILING_RECOMPILE_WARN: int = 8
    """Signatures per jit program before the reference's compile observatory
    warns. Carried for parity; the port does not read it
    (``UNPORTED_KNOBS``)."""

    PROFILING_TRACE_DIR: str = ""
    """When set, a node's experiment (StartLearning through finish) runs
    inside a process-wide ``torch.profiler`` trace written here
    (``profiling.start_trace``). Empty (default) disables."""

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

    AGG_ROBUST_BUFFER: int = 64
    """Candidate-buffer budget of the robust aggregators (Krum /
    MultiKrum / TrimmedMean): at most this many per-round candidates on
    the device, with seeded reservoir sampling past the cap (exact up to
    the cap, an unbiased sample beyond it)."""

    ATTACK_NOISE_STD: float = 0.1
    """Default standard deviation of the additive-noise attack when an
    AttackPlan rule does not set one (tpfl_torch.attacks.plan)."""

    # --- pod-scale federation engine (node-axis sharding) ---
    SHARD_NODES: bool = False
    """Node-axis sharding of the reference engine's auto mesh. Carried for
    parity; the port does not read it (``UNPORTED_KNOBS``)."""

    SHARD_DEVICES: int = 0
    """Device cap of the reference engine's auto mesh. Carried for parity; the
    port does not read it (``UNPORTED_KNOBS``)."""

    SHARD_MODEL: int = 1
    """Model-axis size of the reference engine's auto mesh. Carried for
    parity; the port does not read it (``UNPORTED_KNOBS``)."""

    SHARD_LAYOUT: str = "auto"
    """Per-leaf model-axis layout of the reference engine's 2D mesh. Carried
    for parity; the port does not read it (``UNPORTED_KNOBS``)."""

    SHARD_HOSTS: int = 1
    """Cross-host axis of the reference engine's auto mesh. Carried for
    parity; the port does not read it (``UNPORTED_KNOBS``)."""

    POPULATION_CLIENTS: int = 0
    """Registered clients of the reference's cross-device population tier.
    Carried for parity; the port does not read it (``UNPORTED_KNOBS``)."""

    POPULATION_SAMPLE: int = 100
    """Clients sampled per round from the reference's population tier. Carried
    for parity; the port does not read it (``UNPORTED_KNOBS``)."""

    SHARD_ROUNDS_PER_DISPATCH: int = 1
    """Rounds per dispatch of the reference's ``FederationLearner``. Carried
    for parity; the port does not read it (``UNPORTED_KNOBS``)."""

    ENGINE_TELEMETRY: bool = False
    """The reference engine's in-program telemetry carry. The port's
    ``FederationEngine`` refuses True at construction
    (``UNPORTED_SWITCHES``)."""

    ENGINE_WIRE_CODEC: str = "dense"
    """Device-side wire codec of the engine's exchange
    (``tpfl_torch.parallel.engine`` + ``learning.compression``):
    "dense" (default), "quant8", "topk", or "topk+quant8". Non-dense
    runs each node's trained params through the per-leaf int8
    quantize→dequantize (or top-k mask) round trip before the fold, so
    every node folds what a receiver would decode. Entropy coders and
    delta are host byte transforms and are rejected here. Read per
    ``run_rounds`` call; the top-k fraction rides ``WIRE_TOPK_FRAC``."""

    ENGINE_PREFETCH: bool = False
    """Free-running windows of the reference's ``FederationLearner``. Carried
    for parity; the port does not read it (``UNPORTED_KNOBS``)."""

    ENGINE_DONATE: bool = True
    """Buffer donation of the reference engine's dispatch. The port's
    ``run_rounds`` takes no ``donate=`` and never consumes its inputs.
    Carried for parity; the port does not read it (``UNPORTED_KNOBS``)."""

    ELASTIC_CAPACITY_MIN: int = 2
    """Floor of the reference's elastic capacity tiers. Carried for parity;
    the port does not read it (``UNPORTED_KNOBS``)."""

    COMPILE_CACHE_DIR: str = ""
    """JAX's persistent compilation cache directory. The port compiles
    no programs: ``FederationEngine`` refuses a non-empty value
    (``UNPORTED_SWITCHES``)."""

    CHECKPOINT_DIR: str = ""
    """Engine-state checkpoints of the reference's ``FederationLearner``.
    Carried for parity; the port does not read it (``UNPORTED_KNOBS``)."""

    CHECKPOINT_EVERY_WINDOWS: int = 0
    """Cadence of the reference's engine checkpoints. Carried for parity; the
    port does not read it (``UNPORTED_KNOBS``)."""

    CHECKPOINT_ON_SIGTERM: bool = False
    """SIGTERM checkpoint of the reference's ``FederationLearner``. Carried
    for parity; the port does not read it (``UNPORTED_KNOBS``)."""

    # --- concurrency diagnostics ---
    TRACE_CONTRACTS: bool = False
    """The reference's stamps on cached compiled programs. The port
    caches no programs: ``FederationEngine`` and ``Node.start`` refuse
    True (``UNPORTED_SWITCHES``)."""

    STATE_CONTRACTS: bool = False
    """Self-verification of the reference's engine checkpoints. Carried for
    parity; the port does not read it (``UNPORTED_KNOBS``)."""

    RANK_CONTRACTS: bool = False
    """Cross-rank dispatch receipts of the reference's multi-host engine.
    Carried for parity; the port does not read it (``UNPORTED_KNOBS``)."""

    LOCK_TRACING: bool = False
    """Opt-in runtime lock-order tracing (tpfl_torch.concurrency): every
    lock built through ``make_lock`` becomes a ``TracedLock`` that
    records the acquisition graph (lock A held while acquiring lock B ⇒
    edge A→B, witnessed by the acquiring thread's name); a cycle is a
    latent deadlock, and ``lock_graph.assert_acyclic()`` raises with the
    witness chain. Read at lock CREATION time, so it must be set before
    aggregators and pools are built. Off by default."""

    # --- determinism / TPU ---
    SEED: int | None = None
    """Global seed for reproducible experiments: a learner's batch
    order derives from ``(SEED or 0) + crc32(addr)``, FedMedian's
    reservoir from ``(SEED or 0) ^ crc32(node_name)``."""

    DEFAULT_DTYPE: str = "float32"
    """Parameter dtype. The reference reads it nowhere either."""

    EXACT_AGGREGATION: bool = True
    """Exact in-process mean. The reference reads it nowhere either."""

    @classmethod
    def set_test_settings(cls) -> None:
        """Short timings for tests: the reference's test profile, knob for
        knob (every profile assigns every knob it tunes, so switching
        profiles leaves nothing of the previous one behind). Exactness
        first: dense payloads, no residual gossip, by-reference handoff
        off and canonical-order folds at round close
        (``AGG_STREAM_EAGER`` off), so seeded runs are bit-reproducible.
        Knobs in ``UNPORTED_KNOBS`` are carried for parity only."""
        cls.GRPC_TIMEOUT = 0.5
        cls.HEARTBEAT_PERIOD = 0.5
        cls.HEARTBEAT_TIMEOUT = 2.0
        cls.ELECTION = "vote"
        cls.GOSSIP_PERIOD = 0.0
        cls.TTL = 10
        cls.GOSSIP_MESSAGES_PER_PERIOD = 100
        cls.AMOUNT_LAST_MESSAGES_SAVED = 100
        cls.GOSSIP_MODELS_PERIOD = 0.1
        cls.GOSSIP_MODELS_PER_ROUND = 4
        cls.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS = 10
        cls.TRAIN_SET_SIZE = 4
        cls.SIM_BATCH_WINDOW = 0.05
        cls.VOTE_TIMEOUT = 30.0
        cls.AGGREGATION_TIMEOUT = 30.0
        cls.AGGREGATION_STALL = None
        cls.ROUND_WAIT_POLL = 0.1
        cls.WAIT_HEARTBEATS_CONVERGENCE = 0.2
        cls.GOSSIP_METRICS = True
        cls.LOG_LEVEL = "DEBUG"
        cls.ASYNC_LOGGER = False
        cls.FILE_LOGGER = False
        cls.LOCK_TRACING = False
        cls.TRACE_CONTRACTS = False
        cls.STATE_CONTRACTS = True
        cls.RANK_CONTRACTS = True
        cls.WIRE_CODEC = "dense"
        cls.WIRE_DELTA = False
        cls.WIRE_FORMAT = 3
        cls.WIRE_CHUNK_SIZE = 256 * 1024
        cls.INPROC_ZERO_COPY = False
        cls.AGG_STREAM_EAGER = False
        cls.AGG_MEDIAN_RESERVOIR = 64
        cls.BUFFER_POOL_BUFFERS = 8
        cls.BUFFER_POOL_MAX_BYTES = 256 * 1024 * 1024
        cls.RETRY_MAX_ATTEMPTS = 2
        cls.RETRY_BASE_DELAY = 0.05
        cls.RETRY_MAX_DELAY = 0.25
        cls.BREAKER_THRESHOLD = 3
        cls.BREAKER_PROBE_PERIOD = 1.0
        cls.ROUND_QUORUM = 1.0
        cls.ASYNC_ROUNDS = False
        cls.ASYNC_BUFFER_K = 4
        cls.ASYNC_STALENESS_EXP = 0.5
        cls.ASYNC_ROUND_DEADLINE = 15.0
        cls.ASYNC_SERIALIZED = True
        cls.ASYNC_ADAPTIVE = False
        cls.ASYNC_K_MIN = 2
        cls.ASYNC_K_MAX = 16
        cls.ASYNC_CTL_EWMA = 0.3
        cls.ASYNC_CTL_QUANTILE = 0.9
        cls.ASYNC_STALENESS_MAX = 16
        cls.ASYNC_UNTAGGED_POLICY = "fresh"
        cls.TELEMETRY_ENABLED = False
        cls.TELEMETRY_RING = 512
        cls.TELEMETRY_MAX_LABELSETS = 64
        cls.TELEMETRY_DUMP_DIR = ""
        cls.METRIC_MAX_POINTS = 4096
        cls.FLEETOBS_SNAPSHOT_PERIOD = 0.0
        cls.FLEETOBS_DIR = ""
        cls.SLO_TARGETS = ""
        cls.SLO_EWMA = 0.3
        cls.SLO_BREACH_WINDOWS = 2
        cls.PROFILING_ENABLED = False
        cls.PROFILING_RECOMPILE_WARN = 8
        cls.PROFILING_TRACE_DIR = ""
        cls.LEDGER_ENABLED = False
        cls.LEDGER_RING = 1024
        cls.LEDGER_ANOMALY_Z = 6.0
        cls.LEDGER_ANOMALY_COS = 0.0
        cls.LEDGER_ANOMALY_MIN_N = 4
        cls.LEDGER_CONVERGENCE_WINDOW = 5
        cls.QUARANTINE_ENABLED = False
        cls.QUARANTINE_PROBATION_ROUNDS = 2
        cls.AGG_ROBUST_BUFFER = 64
        cls.ATTACK_NOISE_STD = 0.1
        cls.SHARD_NODES = False
        cls.SHARD_DEVICES = 0
        cls.SHARD_MODEL = 1
        cls.SHARD_LAYOUT = "auto"
        cls.SHARD_HOSTS = 1
        cls.POPULATION_CLIENTS = 0
        cls.POPULATION_SAMPLE = 100
        cls.SHARD_ROUNDS_PER_DISPATCH = 1
        cls.ENGINE_TELEMETRY = False
        cls.ENGINE_WIRE_CODEC = "dense"
        cls.ENGINE_DONATE = True
        cls.ENGINE_PREFETCH = False
        cls.ELASTIC_CAPACITY_MIN = 2
        cls.COMPILE_CACHE_DIR = ""
        cls.CHECKPOINT_DIR = ""
        cls.CHECKPOINT_EVERY_WINDOWS = 0
        cls.CHECKPOINT_ON_SIGTERM = False

    @classmethod
    def set_standalone_settings(cls) -> None:
        """A handful of nodes on one host with patient protocol timeouts:
        the reference's standalone profile, knob for knob."""
        cls.GRPC_TIMEOUT = 2.0
        cls.HEARTBEAT_PERIOD = 10.0
        cls.HEARTBEAT_TIMEOUT = 45.0
        cls.ELECTION = "vote"
        cls.GOSSIP_PERIOD = 1.0
        cls.TTL = 40
        cls.GOSSIP_MESSAGES_PER_PERIOD = 9999999
        cls.AMOUNT_LAST_MESSAGES_SAVED = 9999999
        cls.GOSSIP_MODELS_PERIOD = 1.0
        cls.GOSSIP_MODELS_PER_ROUND = 4
        cls.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS = 30
        cls.TRAIN_SET_SIZE = 4
        cls.SIM_BATCH_WINDOW = 0.2
        cls.VOTE_TIMEOUT = 1200.0
        cls.AGGREGATION_TIMEOUT = 1200.0
        cls.AGGREGATION_STALL = None
        cls.ROUND_WAIT_POLL = 0.5
        cls.WAIT_HEARTBEATS_CONVERGENCE = 4.0
        cls.GOSSIP_METRICS = True
        cls.LOG_LEVEL = "INFO"
        cls.ASYNC_LOGGER = True
        cls.FILE_LOGGER = True
        cls.WIRE_CHUNK_SIZE = 256 * 1024
        cls.LOCK_TRACING = False
        cls.TRACE_CONTRACTS = False
        cls.STATE_CONTRACTS = False
        cls.RANK_CONTRACTS = False
        cls.WIRE_CODEC = "dense"
        cls.WIRE_DELTA = False
        cls.WIRE_FORMAT = 3
        cls.INPROC_ZERO_COPY = False
        cls.AGG_STREAM_EAGER = False
        cls.AGG_MEDIAN_RESERVOIR = 64
        cls.BUFFER_POOL_BUFFERS = 8
        cls.BUFFER_POOL_MAX_BYTES = 256 * 1024 * 1024
        cls.RETRY_MAX_ATTEMPTS = 3
        cls.RETRY_BASE_DELAY = 0.2
        cls.RETRY_MAX_DELAY = 2.0
        cls.BREAKER_THRESHOLD = 3
        cls.BREAKER_PROBE_PERIOD = 15.0
        cls.ROUND_QUORUM = 1.0
        cls.ASYNC_ROUNDS = False
        cls.ASYNC_BUFFER_K = 4
        cls.ASYNC_STALENESS_EXP = 0.5
        cls.ASYNC_ROUND_DEADLINE = 120.0
        cls.ASYNC_SERIALIZED = True
        cls.ASYNC_ADAPTIVE = False
        cls.ASYNC_K_MIN = 2
        cls.ASYNC_K_MAX = 16
        cls.ASYNC_CTL_EWMA = 0.3
        cls.ASYNC_CTL_QUANTILE = 0.9
        cls.ASYNC_STALENESS_MAX = 16
        cls.ASYNC_UNTAGGED_POLICY = "fresh"
        cls.TELEMETRY_ENABLED = False
        cls.TELEMETRY_RING = 512
        cls.TELEMETRY_MAX_LABELSETS = 64
        cls.TELEMETRY_DUMP_DIR = ""
        cls.METRIC_MAX_POINTS = 4096
        cls.FLEETOBS_SNAPSHOT_PERIOD = 0.0
        cls.FLEETOBS_DIR = ""
        cls.SLO_TARGETS = ""
        cls.SLO_EWMA = 0.3
        cls.SLO_BREACH_WINDOWS = 2
        cls.PROFILING_ENABLED = False
        cls.PROFILING_RECOMPILE_WARN = 8
        cls.PROFILING_TRACE_DIR = ""
        cls.LEDGER_ENABLED = False
        cls.LEDGER_RING = 1024
        cls.LEDGER_ANOMALY_Z = 6.0
        cls.LEDGER_ANOMALY_COS = 0.0
        cls.LEDGER_ANOMALY_MIN_N = 4
        cls.LEDGER_CONVERGENCE_WINDOW = 5
        cls.QUARANTINE_ENABLED = False
        cls.QUARANTINE_PROBATION_ROUNDS = 2
        cls.AGG_ROBUST_BUFFER = 64
        cls.ATTACK_NOISE_STD = 0.1
        cls.SHARD_NODES = False
        cls.SHARD_DEVICES = 0
        cls.SHARD_MODEL = 1
        cls.SHARD_LAYOUT = "auto"
        cls.SHARD_HOSTS = 1
        cls.POPULATION_CLIENTS = 0
        cls.POPULATION_SAMPLE = 100
        cls.SHARD_ROUNDS_PER_DISPATCH = 1
        cls.ENGINE_TELEMETRY = False
        cls.ENGINE_WIRE_CODEC = "dense"
        cls.ENGINE_DONATE = True
        cls.ENGINE_PREFETCH = False
        cls.ELASTIC_CAPACITY_MIN = 2
        cls.COMPILE_CACHE_DIR = ""
        cls.CHECKPOINT_DIR = ""
        cls.CHECKPOINT_EVERY_WINDOWS = 0
        cls.CHECKPOINT_ON_SIGTERM = False

    @classmethod
    def set_scale_settings(cls) -> None:
        """Single-host simulation at 100+ nodes: the reference's scale
        profile, knob for knob — hash election, throttles and timeouts
        sized for large federations, the quant8 wire codec with residual
        gossip, by-reference handoff and eager folds."""
        cls.ELECTION = "hash"
        cls.GRPC_TIMEOUT = 10.0
        cls.GOSSIP_PERIOD = 0.0
        cls.TTL = 10
        cls.GOSSIP_MESSAGES_PER_PERIOD = 100_000
        cls.AMOUNT_LAST_MESSAGES_SAVED = 100_000
        cls.GOSSIP_MODELS_PERIOD = 0.25
        cls.GOSSIP_MODELS_PER_ROUND = 20
        cls.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS = 20
        cls.AGGREGATION_STALL = 60.0
        cls.HEARTBEAT_PERIOD = 10.0
        cls.HEARTBEAT_TIMEOUT = 45.0
        cls.TRAIN_SET_SIZE = 4
        cls.SIM_BATCH_WINDOW = 0.2
        cls.VOTE_TIMEOUT = 120.0
        cls.AGGREGATION_TIMEOUT = 120.0
        cls.WAIT_HEARTBEATS_CONVERGENCE = 0.5
        cls.LOG_LEVEL = "INFO"
        cls.ASYNC_LOGGER = False
        cls.FILE_LOGGER = False
        cls.GOSSIP_METRICS = False
        cls.WIRE_CHUNK_SIZE = 256 * 1024
        cls.LOCK_TRACING = False
        cls.TRACE_CONTRACTS = False
        cls.STATE_CONTRACTS = False
        cls.RANK_CONTRACTS = False
        cls.ROUND_WAIT_POLL = 2.0
        cls.WIRE_CODEC = "quant8+zlib"
        cls.WIRE_DELTA = True
        cls.WIRE_FORMAT = 3
        cls.INPROC_ZERO_COPY = True
        cls.AGG_STREAM_EAGER = True
        cls.AGG_MEDIAN_RESERVOIR = 64
        cls.BUFFER_POOL_BUFFERS = 8
        cls.BUFFER_POOL_MAX_BYTES = 256 * 1024 * 1024
        cls.RETRY_MAX_ATTEMPTS = 2
        cls.RETRY_BASE_DELAY = 0.1
        cls.RETRY_MAX_DELAY = 1.0
        cls.BREAKER_THRESHOLD = 3
        cls.BREAKER_PROBE_PERIOD = 30.0
        cls.ROUND_QUORUM = 1.0
        cls.ASYNC_ROUNDS = False
        cls.ASYNC_BUFFER_K = 8
        cls.ASYNC_STALENESS_EXP = 0.5
        cls.ASYNC_ROUND_DEADLINE = 60.0
        cls.ASYNC_SERIALIZED = False
        cls.ASYNC_ADAPTIVE = True
        cls.ASYNC_K_MIN = 2
        cls.ASYNC_K_MAX = 32
        cls.ASYNC_CTL_EWMA = 0.3
        cls.ASYNC_CTL_QUANTILE = 0.9
        cls.ASYNC_STALENESS_MAX = 16
        cls.ASYNC_UNTAGGED_POLICY = "max-stale"
        cls.TELEMETRY_ENABLED = False
        cls.TELEMETRY_RING = 128
        cls.TELEMETRY_MAX_LABELSETS = 64
        cls.TELEMETRY_DUMP_DIR = ""
        cls.METRIC_MAX_POINTS = 4096
        cls.FLEETOBS_SNAPSHOT_PERIOD = 30.0
        cls.FLEETOBS_DIR = ""
        cls.SLO_TARGETS = ""
        cls.SLO_EWMA = 0.3
        cls.SLO_BREACH_WINDOWS = 2
        cls.PROFILING_ENABLED = False
        cls.PROFILING_RECOMPILE_WARN = 16
        cls.PROFILING_TRACE_DIR = ""
        cls.LEDGER_ENABLED = False
        cls.LEDGER_RING = 256
        cls.LEDGER_ANOMALY_Z = 6.0
        cls.LEDGER_ANOMALY_COS = 0.0
        cls.LEDGER_ANOMALY_MIN_N = 4
        cls.LEDGER_CONVERGENCE_WINDOW = 5
        cls.QUARANTINE_ENABLED = False
        cls.QUARANTINE_PROBATION_ROUNDS = 2
        cls.AGG_ROBUST_BUFFER = 64
        cls.ATTACK_NOISE_STD = 0.1
        cls.SHARD_NODES = True
        cls.SHARD_DEVICES = 0
        cls.SHARD_MODEL = 1
        cls.SHARD_LAYOUT = "auto"
        cls.SHARD_HOSTS = 0
        cls.POPULATION_CLIENTS = 0
        cls.POPULATION_SAMPLE = 100
        cls.SHARD_ROUNDS_PER_DISPATCH = 8
        cls.ENGINE_TELEMETRY = False
        cls.ENGINE_WIRE_CODEC = "quant8"
        cls.ENGINE_DONATE = True
        cls.ENGINE_PREFETCH = True
        cls.ELASTIC_CAPACITY_MIN = 2
        cls.COMPILE_CACHE_DIR = ""
        cls.CHECKPOINT_DIR = ""
        cls.CHECKPOINT_EVERY_WINDOWS = 0
        cls.CHECKPOINT_ON_SIGTERM = True

    @classmethod
    def refuse_unported(cls, where: str) -> None:
        """Raise ``NotImplementedError`` for a switch of ``UNPORTED_SWITCHES``
        that is on at ``where``: "node" (a ``Node`` starting, or joining
        an experiment) or "engine" (``FederationEngine`` construction)."""
        for name, (item, off, sites) in UNPORTED_SWITCHES.items():
            value = getattr(cls, name)
            if where in sites and value != off:
                raise not_ported(f"Settings.{name}={value!r}", item)

    @classmethod
    def snapshot(cls) -> dict[str, Any]:
        """Capture all settings (for restoring after tests)."""
        return {
            k: getattr(cls, k)
            for k in dir(cls)
            if k.isupper() and not k.startswith("_")
        }

    @classmethod
    def restore(cls, snap: dict[str, Any]) -> None:
        for k, v in snap.items():
            setattr(cls, k, v)

    @classmethod
    def from_env(cls) -> None:
        """Override any setting from a ``TPFL_<NAME>`` environment variable."""
        for k in list(cls.snapshot()):
            env = os.environ.get(f"TPFL_{k}")
            if env is None:
                continue
            cur = getattr(cls, k)
            if isinstance(cur, bool):
                setattr(cls, k, env.lower() in ("1", "true", "yes"))
            elif isinstance(cur, int):
                setattr(cls, k, int(env))
            elif isinstance(cur, float):
                setattr(cls, k, float(env))
            elif cur is None:
                # None-default settings (e.g. SEED): parse numerically when
                # possible so TPFL_SEED=42 yields an int, not a string.
                for parse in (int, float):
                    try:
                        setattr(cls, k, parse(env))
                        break
                    except ValueError:
                        continue
                else:
                    setattr(cls, k, env)
            else:
                setattr(cls, k, env)


#: Switches of planes the port has not ported: knob -> (``ROADMAP.md``
#: item, the value at which the plane is off, where
#: :meth:`Settings.refuse_unported` checks it).
UNPORTED_SWITCHES: dict[str, tuple[str, Any, tuple[str, ...]]] = {
    "TELEMETRY_DUMP_DIR": (ENGINE_ITEM, "", ("engine",)),
    "TRACE_CONTRACTS": (ENGINE_ITEM, False, ("node", "engine")),
    "ENGINE_TELEMETRY": (ENGINE_ITEM, False, ("engine",)),
    "COMPILE_CACHE_DIR": (SIMULATION_ITEM, "", ("engine",)),
}

_SIM = ("Settings.DISABLE_SIMULATION", SIMULATION_ITEM)
_GRPC = ("communication.GrpcCommunicationProtocol", REST_ITEM)
_MESH = ("parallel.FederationEngine(mesh=)", MULTI_DEVICE_ITEM)
_FED_LEARNER = ("parallel.federation_learner", SIMULATION_ITEM)
_FLEETOBS = ("management.fleetobs", SIMULATION_ITEM)

#: Knobs that only tune a plane the port has not ported: knob -> (the
#: reference's entry point into that plane, ``ROADMAP.md`` item). The
#: entry point is a refused switch (``Settings.<NAME>``), a refused call,
#: or a module of the reference that ``tpfl_torch`` does not have. None
#: marks a knob that the reference reads nowhere either.
UNPORTED_KNOBS: dict[str, "tuple[str, str] | None"] = {
    **dict.fromkeys(("SIM_WORKERS", "SIM_BATCH_WINDOW", "SIM_BATCH_MAX_WAIT",
                     "SIM_MAX_BATCH_NODES", "SIM_PROCESS_ISOLATION"), _SIM),
    **dict.fromkeys(("GRPC_TIMEOUT", "MAX_MESSAGE_SIZE", "GRPC_SERVER_WORKERS",
                     "WIRE_CHUNK_SIZE", "USE_SSL", "CA_CRT", "SERVER_CRT", "SERVER_KEY",
                     "CLIENT_CRT", "CLIENT_KEY"), _GRPC),
    **dict.fromkeys(("SHARD_NODES", "SHARD_DEVICES", "SHARD_MODEL", "SHARD_LAYOUT",
                     "SHARD_HOSTS"), _MESH),
    **dict.fromkeys(("SHARD_ROUNDS_PER_DISPATCH", "ENGINE_PREFETCH", "CHECKPOINT_DIR",
                     "CHECKPOINT_EVERY_WINDOWS", "CHECKPOINT_ON_SIGTERM"), _FED_LEARNER),
    **dict.fromkeys(("FLEETOBS_SNAPSHOT_PERIOD", "FLEETOBS_DIR", "SLO_TARGETS", "SLO_EWMA",
                     "SLO_BREACH_WINDOWS"), _FLEETOBS),
    "STATE_CONTRACTS": ("management.checkpoint", ENGINE_ITEM),
    "POPULATION_CLIENTS": ("parallel.population", ENGINE_ITEM),
    "POPULATION_SAMPLE": ("parallel.population", ENGINE_ITEM),
    "ELASTIC_CAPACITY_MIN": ("parallel.membership", ENGINE_ITEM),
    "ENGINE_DONATE": ("parallel.FederationEngine.run_rounds(donate=)", ENGINE_ITEM),
    "RANK_CONTRACTS": ("parallel.ranksafe", MULTI_DEVICE_ITEM),
    "RESOURCE_MONITOR_PERIOD": ("management.node_monitor", SIMULATION_ITEM),
    "PROFILING_RECOMPILE_WARN": ("management.profiling.CompileObservatory", SIMULATION_ITEM),
    "DEFAULT_DTYPE": None,
    "EXACT_AGGREGATION": None,
}
