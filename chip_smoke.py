"""Chip smoke test of the PyTorch / CUDA port (tpfl_torch) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   port's CUDA kernels from ``tpfl_torch/parallel/csrc`` (one ``nvcc``
   per source, started together).
2. Conv kernel phase: runs each conv kernel at the shapes of the
   100-node CNN round (N=100 nodes, B=128, bf16; the Conv_0 and Conv_1
   layers), holds it against its plain PyTorch version on the same
   inputs, and times the kernel, the plain version and PyTorch's own
   conv backward (``aten.convolution_backward``, a yardstick the port
   never calls). The bf16 ``conv_dw`` and ``conv_dx`` must take their
   Hopper (wgmma + TMA) kernels there, ``conv_dw`` with the same bits on
   a second run; so must 64 ``conv_dx`` edge cases (Cin 8 / 32 / 40 / 64,
   Cout 64 / 128, images from 1×1 to the largest the kernel's ring holds,
   B 1 / 3, ~200 images so the persistent blocks' ranges cross nodes) and
   72 ``conv_dw`` ones (Cin 3 / 8 / 32, Cout 32 / 64 / 128, odd images, B
   1 / 3), each held against the plain version at the main shapes'
   tolerance. Both kernels also run at 65,537 nodes (bf16 and f32).
3. CNN reference phase: small f32 federation rounds with the kernels
   (``conv_impl="pallas"``) and with the forward-style backward
   (``"fwd_bwd"``) against plain autograd (``conv_impl="xla"``), cuDNN's
   TF32 off.
4. CNN main path: ``VmapFederation(CNN(out_channels=10,
   conv_impl="pallas"), n_nodes=100)`` runs FedAvg rounds on seeded
   synthetic CIFAR-shaped data (4 batches of 128 per node, 1 epoch);
   every kernel must have launched (8 conv_dw and 4 conv_dx launches per
   round, every one on its wgmma kernel), every loss must be finite
   and every node must hold the same aggregate. Then the same round with
   the reference's default ``conv_impl="fwd_bwd"`` (library
   convolutions, no kernel of the port) gives the round's yardstick.
5. Flash kernel phase: ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` at
   the transformer main path's shape (B·H = 64·8, S = 2048, D = 64,
   causal, bf16), at the long-context one (B·H = 1·8, S = 32768) and at
   the attention tier's two (B·H = 1·8, D = 128, S = 8192 and 32768), each
   held against its plain version (bf16 outputs as the main path uses
   them, and f32 outputs of the same kernels, which show that P and dS
   are rounded as the reference rounds them), bf16 cases at the edges of
   the wgmma kernels' tiles (S = 100 non-causal D = 32, S = 130 causal
   D = 128, S = 127 and 129 causal D = 64, S = 191 / 192 / 193 with
   D = 8 / 24 / 64 / 128 causal and not, and D = 20, whose rows TMA
   cannot address, on the WMMA kernels), and one f32 non-causal case with
   an unaligned S (100) that exercises the key mask. Every launch must
   take the kernel the dispatch rule names (wgmma for bf16 with D a
   multiple of 8 up to 128), and ``flash_dq`` must give the same bits
   twice. Times the kernels, their plain versions and PyTorch's
   flash-backend ``scaled_dot_product_attention`` (a yardstick the port
   never calls). The build step prints ptxas's registers and spills for
   every kernel (and any ptxas warning about wgmma) and, from
   ``cuobjdump -sass``, the count of ``HGMMA`` (wgmma), ``UTMALDG`` (TMA
   load) and ``LDGSTS`` (``cp.async``) instructions in each kernel; the
   main path's ``flash_fwd``, ``flash_dq``, ``flash_dkv`` and both
   ``conv_dw`` instantiations must have HGMMA and UTMALDG, its
   ``conv_dx`` HGMMA and UTMALDG or LDGSTS.
   Limit cases, bf16 and f32, forward and both gradients: B·H = 65,537
   and head dims 136, 200, 256 and 320.
6. Transformer reference phase: a small f32 federated ``TransformerLM``
   round with ``attention_fn=flash_attention`` against the same round
   with ``blockwise_attention``.
7. Transformer main path: ``VmapFederation(TransformerLM(vocab=256,
   dim=512, heads=8, n_layers=4, max_len=4096,
   attention_fn=flash_attention), n_nodes=8, learning_rate=0.05)`` runs
   FedAvg rounds on seeded tokens (1 batch of 8 sequences of 2,048 per
   node, 1 epoch); 4 launches of each flash kernel per round, every one
   on its wgmma kernel, finite losses and one aggregate on every node.

8. Kinds reference phase: small f32 windows of the engine's other kinds
   on the card against the same windows on the CPU — ResNet-18
   (stage sizes (1, 1), 8×8 inputs) under SCAFFOLD with FedBN
   ``aux_mode="local"`` and under FedProx, the CNN through the kernels
   under SCAFFOLD — and the CNN's wire-codec fold on an aggregation round
   (one node elected), bit for bit. The codec itself at the CNN round's
   leaf shapes (100 nodes): every node's ``quant8`` / ``topk+quant8``
   round trip on the card against the numpy oracles, timed.
9. ResNet-18, config 3 (``bench.py:3480-3507``):
   ``VmapFederation(ResNet18(out_channels=100), n_nodes=16,
   learning_rate=0.1)`` with BatchNorm state, 2 batches of 128 seeded
   synthetic CIFAR-shaped samples per node (100 classes), bf16 compute, a
   warm-up round and a 3-round window each under FedAvg, SCAFFOLD and
   FedProx (mu 0.01): finite losses, one aggregate (params and batch
   stats) on every node, no kernel of the port launched (the reference's
   ResNet runs plain convolutions).
10. CNN main path under the new variants: the 100-node round through the
   kernels with ``ENGINE_WIRE_CODEC="quant8"``, with ``"topk+quant8"``
   and with ``algorithm="scaffold"`` (at lr 0.02, where the reference's
   SCAFFOLD stays finite on this CNN), each a 3-round window asserting
   every ``conv_dw`` / ``conv_dx`` launch on its wgmma kernel, finite
   losses and one aggregate on every node.
11. Protocol phase (the learning layer of ``tpfl_torch.learning``): a
   narrow f32 ``TorchLearner`` fit through the conv kernels on the card
   against the same fit on the CPU; then four ``TorchLearner`` objects of the
   full-width CNN (``conv_impl="pallas"``, bf16 compute, one model each:
   the kernels at N = 1), 512 seeded synthetic CIFAR-shaped samples (4
   batches of 128) and 256 test samples each, 1 epoch. A round: every
   learner fits (32 ``conv_dw`` + 16 ``conv_dx`` launches, every one on
   its wgmma kernel), its model is wire-encoded (v3 dense, 2,180,392
   bytes of params), node 0 rebuilds each model from the bytes and folds
   them (``set_nodes_to_aggregate`` → ``add_model`` ×4 →
   ``wait_and_get_aggregation``), the aggregate, held to a plain f64
   mean of the decoded params (rtol 1e-6), goes back to every learner
   as bytes and each evaluates it. A warm-up round and a timed one
   under FedAvg, ``WIRE_CODEC="quant8"`` (every leaf bit-equal to the q8
   oracle), SCAFFOLD (lr 0.02) and FedProx; fit, encode, decode, fold
   and round times, and encode / decode of one payload as v1, v3 and
   v2 ``quant8``.
12. Byzantine phase (the robustness slice): ten full-width CNN
   ``TorchLearner`` objects (the kernels at N = 1, 512 seeded samples
   each, split by ``RandomIIDPartitionStrategy`` through
   ``TpflDataset.generate_partitions``) under one seeded ``AttackPlan``
   (sign flips on nodes 1 and 4, additive noise std 0.1 on nodes 6 and
   8, through ``apply_attack_plan``); node 0 opens the ledger round on
   the round-start params and folds the v3-decoded models. Arms: FedAvg
   undefended, FedAvg with ``QUARANTINE_ENABLED`` (twice: the same
   replayed verdicts), Krum (f = 3), MultiKrum (f = 3, m = 6) and
   TrimmedMean (trim 2) with quarantine; a warm-up and 4 timed rounds
   each. Every round: 80 ``conv_dw`` + 40 ``conv_dx`` launches, all on
   wgmma; Krum's pick equal to a plain f64 scoring's, every other
   aggregate within rtol 1e-6, atol 1e-7 of its plain f64 version over
   the models the defense kept. Every defended arm: the ledger's
   detections at precision = recall = 1.0 and the replayed quarantine
   set exactly the planned adversaries. Timed: rounds, ``score_now`` per
   contribution, each robust ``finalize`` over 10 models,
   ``AttackPlan.poison`` of one noisy model. Then ``attack_scales``
   (``AttackPlan.engine_scales``, [R, n]) in the small f32 CNN window on
   the card against the CPU (dense trained, ``quant8`` aggregation-only),
   and the 100-node CNN window under a sign flip on every fifth node:
   all-ones scales bit-identical to no scales, then a timed window.

13. Federation phases (the node runtime: ``Node`` over the in-memory
   transport, the stage workflow, FedAvg; ``Settings.set_test_settings()``
   with the pooled simulation learner off and the logger at ERROR). A
   reference phase: a 2-node LINE federation of a narrow f32 CNN through
   the kernels, 2 rounds, on the card and on the CPU with the same
   addresses, seeds and data (rtol 1e-3, atol 1e-4; every launch counted,
   none on wgmma, which takes bf16 only). Then four Nodes of the CNN
   cell's model (bf16, the kernels at N = 1, 512 seeded samples and 256
   test samples each) on a LINE: a 1-round warm-up experiment, then a
   3-round one; and six Nodes on a FULL topology with ``TRAIN_SET_SIZE =
   4``, 2 rounds, so two nodes a round take the wait path. Each: complete
   stage histories, every node's params finite and byte-equal to an
   aggregate some node closed in the last round (trainers fold partial
   aggregates as they arrive, so two closed aggregates may differ in
   their last bits: all within rtol 1e-6 of each other), finite losses,
   exactly ``rounds × 4 × 8`` ``conv_dw`` and ``× 4`` ``conv_dx`` launches,
   all on wgmma, every aggregate a node closed within rtol 1e-6, atol
   1e-7 of a plain f64 mean of that round's fitted models (recorded by a
   learner and an aggregator subclass); experiment wall time, rounds/s
   and the round profiler's vote / train / fold / gossip split.

14. Byzantine federation (the bench's ``byzantine`` tier,
   ``bench.py:2725-3066``, as gossiping ``Node``s through the port's
   harness, ``tpfl_torch.attacks.run_seeded_experiment``): first
   ``conv_dw`` / ``conv_dx`` at the federations' own shapes (both CNN
   layers at one node of 25 and of 32 bf16 images), wgmma asserted, held
   to the plain versions and timed; then ten Nodes of the CNN cell's model
   (bf16, the kernels at N = 1) on a STAR, seed 4242, 3 rounds (2 in the
   ten-node arms without a defense) of 4
   epochs over 200 samples each in batches of 25 (lr 0.1), sign flips on
   nodes 1 and 4 and additive noise (std 0.1) on nodes 6 and 8. Arms:
   FedAvg fault-free, the six honest nodes alone, FedAvg attacked, FedAvg
   + quarantine (twice, the second traced: ``TELEMETRY_ENABLED``, a dump
   directory, a 200,000-entry ring), Krum (f = 3) fault-free and
   attacked, MultiKrum (f = 3, m = 6) and TrimmedMean (trim 2) with
   quarantine. Each: complete stage histories, exactly rounds × n × 4 × 8
   steps' launches (1,920 ``conv_dw`` + 960 ``conv_dx`` at n = 10 and 3
   rounds),
   all wgmma, every node's final params finite and, without quarantine,
   within rtol 1e-6 of node 0's; with quarantine, the two sign flips in
   the ledger's detections, in the replayed quarantine set and flagged
   at intake, and their decisions the same in the two FedAvg +
   quarantine runs. The rest of the verdicts varies from run to run, as
   the reference's does (each node scores against its own ring; see
   ``BF_DETECTED``): precision, recall, each adversary's z, every peer
   flagged at intake, whether all decisions are byte-identical and the
   nodes' spread are reported; traced, a
   ``quarantine`` event for each peer flagged at intake and
   ``contrib`` events in the flight dumps, and complete
   encode → send → recv → decode hop chains from ``tracing.export()``.
   Reports walls, rounds/s, the round split, quorum degradations, honest
   accuracy and the bench's ratios (not gated: synthetic data).
15. Chaos federation (the bench's ``chaos`` tier, ``bench.py:410-573``):
   (a) its fixed schedule twice through ``FaultInjector`` (20% drop on
   every link, seed 1234), identical per-round counts; (b) four CNN
   Nodes (200 samples each, batch 32, lr 0.05, 6 rounds) run fault-free
   (exactly 288 ``conv_dw`` + 144 ``conv_dx`` launches, all wgmma), then
   under that plan with the last node crashed (``fi.crash``) as it enters
   the final round's train set: the survivors finish every round, each
   round under ``AGGREGATION_TIMEOUT``, ``dropped > 0``, no
   ``corrupt_accepted``, every launch on wgmma; walls, per-round times,
   the loss difference (the bench's 5% target, reported) and the
   injector's totals.

16. Async federation (node runtime C, the asynchronous buffered rounds,
   and residual gossip), as gossiping Nodes of the CNN cell's model
   through the harness (16a-c) or built directly (16d), on seeded
   synthetic CIFAR-shaped data: (a) the bench's ``async`` tier
   (``bench.py:3100-3180``): seed 3131, ten Nodes, hash election, a
   ``TrainerSpeedPlan`` sleeping 2 trainers 2.5 s a fit and 8 of them
   0.25 s, 2 epochs over 100 samples in batches of 25; a 2-round warm
   async arm, then 3 synchronous rounds (exactly 240 steps' launches),
   then 6 free-running async rounds with ``ASYNC_BUFFER_K`` 5; each arm's
   rounds/s and steady loss, the speedup and loss ratio (reported, not
   gated). (b) Its determinism arm (``:3182-3219``): two serialized runs
   of 3 rounds, K 8, the adaptive controller on, the plan's schedule
   forked into every aggregator: the final digests equal across runs, one
   across the ten nodes, the controller trajectories equal and non-empty
   at every node (each run exactly 240 steps' launches). (c) The
   ``byzantine`` tier's async arm (``:2939-3033``): seed 4243, 4 rounds
   × 4 epochs × 200 samples, serialized, K = n, ``ASYNC_STALENESS_MAX`` 2,
   ``stale_flood`` on n1 and ``withhold_replay`` from round 2 on n4;
   adversary-free at n = 8, staleness-blind (exp 0) and defended
   (quarantine + ledger) at n = 10 (exact launch counts): in the defended
   arm only n1 and n4 have ``stale_flood`` decisions, and from the first
   one on each is excluded for it every round; whether the quarantined
   set is exactly {n1, n4} (the z-score classes may add honest peers, as
   in phase 14), the honest quarantines, honest accuracies and ratios
   reported. (d) Four Nodes on a STAR, train set 2, dense codec, 3
   rounds, ``WIRE_DELTA`` off then on: residual sends from round 1 on
   (none with it off), no residual to a peer after its nack in that
   round, every node's final params within rtol 1e-3, atol 1e-4 of the
   delta-off arm's; bytes per payload reported. Every arm: complete stage
   histories, finite final params and losses, every conv launch on
   wgmma.
17. Engine variants phase (phase 17): FedBuff windows and the window
   pipeline, the telemetry carry, elastic membership and kill-and-resume
   on the CNN cell.
18. Simulation plane phase (phase 18): the reference's default fit path,
   every Node's fits batched by ``SuperLearnerPool`` into node-stacked
   programs. (a) Phase 14's FedAvg fault-free and attacked arms with the
   pool on (2 rounds, as those arms): one batched dispatch of all ten
   fits a round, no fallback, exactly 64 node-batched steps' launches
   (128 ``conv_dw`` + 64 ``conv_dx``, all wgmma, all at N = 16), final
   models within rtol 1e-6,
   rounds/s beside phase 14's inline arm; a pooled fit held to the same
   learner's inline fit on the card at the bound stated beside
   ``SP_TWIN_RTOL``. (b) Phase 16a's three arms with the pool on
   (``SIM_BATCH_MAX_WAIT`` 0.6): batched dispatches in each, no
   fallback, every launch wgmma. (c) Two gossiping Nodes, each a
   ``FederationLearner`` of 8 local CNN rows (the multislice example's
   defaults): each fit one window at N = 8 with exact launch counts, the
   two models within rtol 1e-6; a capacity-tier restack (N = 16) and a
   byte-identical kill-and-resume through ``CHECKPOINT_DIR``. (d) The
   ``sim1m`` cell (1,000,000 clients, K 100, its checkpoint exact, RSS
   growth under 256 MB) and the ``sim1000`` cell (1,000 nodes, ~10%
   elected) on the MLP; one isolated fit (``SIM_PROCESS_ISOLATION``) on
   the card within rtol 1e-6 of the inline fit; ``conv_dw`` / ``conv_dx``
   at N 16 B 25, N 8 B 25 (phase 25's shard) and N 8 B 32 against their
   plain versions, timed.
19. Observatory phase (phase 19, the bench's ``profiling`` and
   ``fleetobs`` tiers): (a) the compile probe on the card — 8, 8, 16,
   32, 64 elements at a storm threshold of 3: 4 signatures, one hit, a
   ``recompile_storm`` event; (b) the tier's 4-Node MLP federation
   (seed 2626, hash election) with profiling off and on after a warm-up,
   run last: every round attributed, coverage at least 0.95; (c) CNN and
   LM windows (a warm one and the best of 2, as the reference's bench
   times its live MFU) through ``CostModel.record_round``: the live MFU gauge
   within 5% of the analytic column (the path's rounds/s × the same
   FLOPs over the card's peak), every launch on wgmma; (d) the HBM
   tracker's peak over a CNN window equal to
   ``torch.cuda.max_memory_allocated()``; (e) the fleet folds of two
   launches of two ranks (``--fleet-rank``, four subprocesses on the
   card, started together) byte-identical, the SLO watchdog flagging a 20% regression within 2
   windows and silent without it, the fleet plane's overhead, the
   census sweep's bitsets; (f) ``MetricsHTTPServer`` on loopback (200,
   then 503 once the watchdog breaches) and one ``NodeMonitor`` period.
20. SPMD planes phase (phase 20: sequence, pipeline and expert
   parallelism, on one-rank meshes over an NCCL group in an in-process
   store): (a) the flash ring's arithmetic on one card — an 8k sequence
   (B 1, H 8, D 128, bf16) split into 4 emulated ranks, each rank's
   forward steps through ``flash_block_fwd`` and ``_ring_merge`` and its
   backward steps through ``flash_block_bwd`` with the rank's global lse /
   delta, causal and not, against ``flash_attention`` over the whole
   sequence at the kernel phase's bf16 tolerance, and one off-diagonal
   (non-causal, f32 out) step against the plain versions; (b)
   ``make_ring_attention`` on a one-rank ``sp`` mesh at S 8k and 32k, its
   output and gradients against ``flash_attention`` (max abs difference
   reported), ``impl="auto"`` taking the flash inner; (c) the bench's
   ``attention`` tier (``bench.py:3554-3640``): causal fwd + bwd steps timed
   by ``profiling.timed_loop`` at its iteration counts —
   ``flash_fwdbwd_{8,32}k``, ``blockwise_fwdbwd_8k``,
   ``ring_sp_flash_fwdbwd_{8,32}k``, ``ring_sp_xla_fwdbwd_8k`` tokens/s and
   the flash SDPA backend's beside them; (d) the ``transformer`` tier
   (``bench.py:3642-3685``): ``TransformerLM(vocab 256, dim 512, heads 8,
   n_layers 4, max_len 32768)`` at one node, B 1, S 32,768, through
   ``flash_attention``, 5 SGD steps (lr 1e-2, momentum 0.9) a timed loop,
   ``transformer_32k_train_toks_per_sec``; its first step's loss and
   gradient norm against the same step through the plain versions, 4
   launches of each flash kernel a step; (e) a 1-stage
   ``make_pipeline_trainer`` over the tier's 4 ``TransformerBlock``s (4
   microbatches of [1, 2048, 512], 2 steps) against the blocks in sequence,
   and one ``make_moe_train_layer`` step of the LM's FFN width (512 -> 2048
   -> 512) against its plain single expert. Every flash launch of the
   phase takes the kernel the dispatch rule names.
21. Mesh phase (phase 21: the engine on a device mesh, every mesh a
   one-rank ``nccl`` group in an in-process store, as the card's machine
   has one card): (a) the 100-node CNN window of step 4 under
   ``mesh=None``, ``create_mesh({"nodes": 1})`` and ``create_mesh({"hosts":
   1, "nodes": 1, "model": 1})``, each timed as step 4 (best of
   ``MAIN_WINDOWS``) with ``RANK_CONTRACTS`` on: the final params
   bit-identical to ``mesh=None``'s (max abs difference reported), 8
   ``conv_dw`` + 4 ``conv_dx`` launches a round, all wgmma, one receipt a
   window, no ``dcn_bytes`` row in a telemetry window at ``hosts`` 1;
   (b) the 8-node TransformerLM of step 7 under ``{"nodes": 1, "model":
   1}`` with its attention pinned to ``make_ring_attention`` on the
   ``model`` axis (the engine itself rings only a ``model`` axis over 1),
   whose steps launch the flash kernels through ``flash_block_fwd``
   / ``flash_block_bwd`` (all wgmma), bit-identical to step 7's
   ``flash_attention`` window; the CNN under the same mesh bit-identical
   to (a)'s; (c) ``ShardedTrainer`` on a one-rank ``dp`` mesh: FSDP on
   the CNN at B 128 (5 steps, through the conv kernels) and
   ``train_step_with_aux`` on ResNet-18 at config 3's shape (5 steps),
   the first two losses against the plain single-device steps (rtol
   1e-3, atol 1e-4), steps/s over steps 2-5; (d) ``scaling.analyze`` of one (a) window
   (the collective ledger's bytes: the fold's one-rank legs) and a
   ``SliceCheckpointer`` round trip of (a)'s placed state, the window
   after it bit-identical to running on (save and restore seconds).

22. Network phase (phase 22: the TCP transport, the entry points and the
   converters). (a) Four Nodes of the CNN cell's model (bf16, the kernels
   at N = 1, 512 seeded samples each in batches of 128) on a LINE of
   loopback addresses, train set 2 by hash election, 3 rounds, over the
   in-memory transport and over ``TcpCommunicationProtocol`` with the
   same addresses, seeds, data and experiment id (chosen so that every
   round elects one node of each of (b)'s processes), after an untimed
   1-round warm-up federation, each transport twice, alternating: every
   run's final params bit-identical, one digest across the nodes,
   exactly ``2 × 3 × 4`` steps' launches (48 ``conv_dw`` + 24
   ``conv_dx``) a run, all wgmma, ``tpfl_wire_bytes_total`` positive
   over TCP only; rounds/s of each run (the best of two reported per
   transport) and the round profiler's split. (b) The same federation with nodes 2 and 3 in a child
   process on the card (``chip_smoke.py --net-child SPEC``) that first
   runs the warm-up federation of its own: each process's exact
   launches, all wgmma, every node's final digest equal to (a)'s. (c)
   The ResNet-18 state (config 3's model, 44.9 MB) as one SendStream at
   ``WIRE_CHUNK_SIZE``, reassembled byte-equal, MB/s, and the CNN cell's
   payload (one of (a)'s pushes) the same way; a fault-injected
   corrupted stream rejected by the chunk CRC and the retry delivered;
   with ``openssl`` present, mTLS from ``generate_certificates`` (the
   stream again, and a TLS client without a certificate refused). (d)
   ``python -m tpfl_torch.cli experiment list``, ``run node1`` beside
   ``run node2``, ``run --profile DIR digits -- --nodes 2 --rounds 1
   --protocol tcp`` (a ``torch.profiler`` trace in ``DIR/trace.json``)
   and the multislice slice-mode pair, as subprocesses on the card, each
   exiting 0 (the passive halves on SIGTERM). (e) A torch ``state_dict``
   on the card through ``from_torch_state_dict`` / ``to_torch_state_dict``
   exactly, and the ``nn.Sequential`` MLP's logits against the port's MLP
   with the imported params (f32, TF32 off, atol 1e-4).
23. Rendered data phase (phase 23: the reference's digit images without
   PIL). (a) The ``primary`` tier's ``rendered_color_digits(n_train=51,200,
   n_test=10, seed=0)`` and ``rendered_digits(2,000, 400, seed=0)``
   rendered on the host from the glyph atlas, each one's four arrays held
   to a sha256 pinned from the JAX package's renderer; seconds and
   images/s of the host CPU. (b) The primary tier's window on that data:
   ``VmapFederation(CNN(out_channels=10, conv_impl="pallas"), 100 nodes,
   lr 0.1, seed 0)``, bf16 images, 4 × 128 samples a node, a first round,
   then ``MAIN_WINDOWS`` 3-round windows (best reported): exactly 8
   ``conv_dw`` + 4 ``conv_dx`` launches a round, all wgmma, one finite
   aggregate on every node, the last round's mean loss below the first
   round's; rounds/s, samples/s, the window's mean loss (the bench's
   ``steady_loss``) and node 0's accuracy on ``rendered_color_digits(
   n_train=10, n_test=2,000, seed=1)``'s test split (reported only). (c)
   The reference's accuracy contract on the card: three MLP Nodes, FULL,
   2 rounds × 2 epochs on ``rendered_digits(3,000, 450, seed=5)``: equal
   models and test accuracy > 0.5 on every node. (d) ``TRACE_CONTRACTS``
   on: a fresh engine of (b)'s seed, every cached program stamped, its
   first window bit-identical to (b)'s, rounds/s on against off; a
   donate=True cache slot re-pointed at the donate=False program raises
   ``TraceContractError`` naming ``ENGINE_DONATE`` before any launch.
24. Donation phase (phase 24: buffer donation in the engine window). The
   100-node CNN window of step 4 (FedAvg), the same under SCAFFOLD (lr
   0.02) and the 8-node TransformerLM window of step 9: a warm round, then
   3-round windows from fresh copies of one seeded state, donate False,
   True, True, False. Gated: every window's outputs byte-equal; a
   donating window returns its input tensors, a non-donating one new
   ones; the donating windows' peak of requested bytes (the allocator's
   ``requested_bytes.all``, above what was requested before each) below
   the non-donating ones' by at least the params state's bytes (the
   ``max_memory_allocated`` peaks are printed beside them: they count
   whole cached blocks); ``donation_report`` clean with one
   donated leaf per state leaf; exactly 8 ``conv_dw`` + 4 ``conv_dx`` (or
   4 of each flash kernel) launches a round, all wgmma. Both peaks, their
   difference, the state's bytes and rounds/s both ways are printed (the
   rounds/s are not gated).

25. Pool sharded phase (phase 25: the simulation pool's chunk over the
   ranks of a ``torch.distributed`` world). Two ranks on the one card, in
   child processes (``--pool-rank``), a gloo world (nccl refuses two ranks
   on one device; both compute on ``cuda:0``), ``SHARD_NODES`` on: rank 0
   runs phase 18a's pooled train stage (ten learners of the cell, 4 epochs
   × 8 batches of 25, bucket 16), a warm one and a timed one, and trains
   rows 0-7 while rank 1 serves rows 8-15 (``serve_pool_shards``), then
   one step of 16 rows, and stops rank 1 (``stop_pool_servants``). The
   parent first runs the same stage unsharded with the card to itself,
   again as chunks of 8 (rows 0-7, rows 8-9 beside six fillers), the
   1-step chunk, and the node-count witness: the stage at 16 and 8 rows
   with every conv launch held to its plain version, through the plain
   versions, from a start scaled by 1 + 2^-20, and in f32. Gated: each
   rank's conv launches exactly 2 ``conv_dw`` + 1 ``conv_dx`` a step at
   N = 8, all wgmma; one batched dispatch of 10 fits a stage and no
   fallback on rank 0; every learner's gathered params bit-equal to its
   chunk of 8 here; the sharded step within rtol 1e-3 / atol 1e-4 of the
   16-row chunk; every witness launch within its kernel's bound, the
   plain versions' stage bit-equal at 8 and 16 rows, and the 32-step
   distance from the 16-row stage no larger than the nudged start's
   (``PS_ROWS``'s comment). Both walls are printed beside the card (the
   two ranks share its SMs: a record, not a scaling figure).

26. Parquet path (phase 26: the data plane). (a) The committed Hugging
   Face directory ``tests/data/torch_hf_digits`` (PNG images in an
   ``Image()`` column and ``ClassLabel`` labels, in Parquet) read on the
   host by ``TpflDataset.from_huggingface`` and its train file by
   ``from_parquet``, with the port's numpy reader (no pyarrow, datasets
   or PIL): the two give the same arrays, every split's arrays equal the
   reference loader's sha256 pins (``PQ_PINS``), and the images equal
   the port's ``rendered_color_digits`` (512 + 128, seed 7) quantised to
   uint8; the seconds and images/s of the decode are printed. (b) Both
   conv kernels at the window's shape (both CNN layers, N 4 B 32, bf16):
   wgmma asserted, held to the plain versions and timed. Then the CNN at
   full width on 4 nodes, each 128 of those train images from
   ``generate_partitions(4, RandomIIDPartitionStrategy)`` through the
   export (bf16, scaled by 1/255): a warm round with every conv launch
   held to its plain version on the same inputs, then a 3-round window.
   Gated: exactly 8 ``conv_dw`` + 4 ``conv_dx`` launches a round in both,
   all wgmma, none beyond its bound; finite losses and one aggregate on
   every node; one f32 round through the kernels (8 + 4 launches, the
   CUDA-core f32 kernels) within rtol 1e-3 / atol 1e-4 of the same round
   through their plain versions on the card (no launch). Rounds/s, node 0's accuracy
   on the fixture's test split and the f32 round's distance from the CPU
   are printed beside the card (not gated).

27. gRPC path (phase 27: the reference's wire, ``GrpcCommunicationProtocol``
   on HTTP/2 and HPACK of the standard library; port against port, since
   the card's machine has no JAX and no ``grpcio``: the JAX interop is held
   on the CPU by ``tests/test_torch_grpc_transport.py``). (a) Phase 22a's
   four CNN Nodes (its builder, addresses, seeds, data and experiment id)
   over gRPC, twice: every run's final params bit-identical to 22a's
   in-memory and TCP runs, one digest across the nodes, exactly 48
   ``conv_dw`` + 24 ``conv_dx`` launches a run, all wgmma,
   ``tpfl_wire_bytes_total`` positive; rounds/s (the better run) beside
   22a's and the round profiler's split. (b) The ResNet-18 state (44.9 MB)
   as one gRPC SendStream at ``WIRE_CHUNK_SIZE``, reassembled byte-equal
   (MB/s); a heartbeat-sized Send on the same connection while that
   stream is in flight, finished before the stream (its latency); a
   corrupted stream rejected by the chunk CRC and the retry delivered;
   with ``openssl`` present, the stream under mTLS and a TLS client
   without a certificate refused. (c) ``_dial`` to a closed loopback port
   raises ``ConnectionTimeoutError`` after the ready wait, not before.

28. JPEG path (phase 28: the data plane's JPEG decoder, phase 26 on JPEG
   bytes). (a) The committed Hugging Face directory
   ``tests/data/torch_hf_jpeg_digits`` (the same 512 + 128 rendered digits
   as JPEG bytes PIL wrote: the train split baseline at quality 90 and
   4:2:0, the test split progressive with ``optimize``, 4:2:2 and a
   restart marker every MCU row) read on the host by
   ``TpflDataset.from_huggingface`` and its train file by
   ``from_parquet``, decoded by the port's numpy JPEG decoder (no PIL):
   the two give the same arrays and every split's arrays equal the
   reference loader's sha256 pins (``JPEG_PINS``: PIL's libjpeg-turbo
   bit for bit); the seconds and images/s of the decode are printed.
   (b) 26b's window on those images, without timing the kernels again
   (the shape is 26b's): a warm round with every conv launch held to its
   plain version, then a 3-round window, each with exactly 8 ``conv_dw``
   + 4 ``conv_dx`` launches a round, all wgmma, none beyond its bound;
   finite losses and one aggregate on every node; one f32 round through
   the kernels within rtol 1e-3 / atol 1e-4 of the same round through
   their plain versions on the card. Rounds/s and node 0's accuracy on
   the fixture's test split are printed beside the card (not gated).

``--profile`` adds one round of each main path (the CNN, the
transformer, ResNet-18 under FedAvg), one protocol-phase learner fit,
one defended FedAvg round of the Byzantine phase, one 3-round
experiment of the 4-node federation, one pooled train stage and one
pooled 1-round experiment under ``torch.profiler``: device time by
kernel, and the device's idle share from the union of its kernel
intervals.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, when there is no card or any phase fails.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import math
import os
import queue
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from tpfl_torch.attacks import (AttackPlan, AttackSpec, adversary_map, apply_attack_plan,
                                final_model_digests, harness, metric_table,
                                run_seeded_experiment)
from tpfl_torch.communication import (FaultInjector, FaultPlan, GrpcCommunicationProtocol,
                                      InMemoryCommunicationProtocol, TcpCommunicationProtocol,
                                      TrainerSpeedPlan)
from tpfl_torch.communication import grpc_transport
from tpfl_torch.concurrency import ContractedProgram, TraceContractError
from tpfl_torch.exceptions import ConnectionTimeoutError
from tpfl_torch.interop import from_torch_state_dict, to_torch_state_dict
from tpfl_torch.learning import _msgpack, compression
from tpfl_torch.learning.async_control import AsyncController
from tpfl_torch.learning.aggregators import (FedAvg, FedProx, Krum, MultiKrum, Scaffold,
                                             TrimmedMean)
from tpfl_torch.learning.dataset import (RandomIIDPartitionStrategy, TpflDataset,
                                         rendered_color_digits, rendered_digits)
from tpfl_torch.learning.dataset.synthetic import (synthetic_cifar10, synthetic_classification,
                                                   synthetic_mnist)
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.learning.torch_learner import SGDMomentum, TorchLearner
from tpfl_torch.management import engine_obs, ledger, profiling, quarantine, telemetry, tracing
from tpfl_torch.management.checkpoint import EngineCheckpointer
from tpfl_torch.management.quarantine import QuarantineEngine
from tpfl_torch.management.logger import logger
from tpfl_torch.models import (CNN, MLP, ResNet18, TransformerBlock, TransformerLM,
                               create_model, init_params, init_state)
from tpfl_torch.models.zoo import stack_params
from tpfl_torch.node import Node
from tpfl_torch.parallel import (ClientPopulation, FedBuffSchedule, FederationEngine,
                                 FederationLearner, MembershipView, VmapFederation,
                                 WindowPipeline, _build)
from tpfl_torch.parallel import conv_kernel as ck
from tpfl_torch.parallel import flash_kernel as fk
from tpfl_torch.parallel.engine import DENSE
from tpfl_torch.parallel.ring_attention import blockwise_attention
from tpfl_torch.settings import Settings
from tpfl_torch.simulation import SuperLearnerPool, VirtualNodeLearner, batched_fit, isolated
from tpfl_torch.stages.base_node import election_rank
from tpfl_torch.utils import (TopologyFactory, TopologyType, check_equal_models,
                              wait_convergence, wait_to_finish)
from tpfl_torch.utils.certificates import enable_mtls
from tpfl_torch.utils.tree import tree_items, tree_leaves, tree_map, tree_unflatten

# H100 SXM published peaks (dense): HBM3 bytes/s and bf16 tensor-core FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_BF16_FLOPS = 989e12

N_NODES, N_BATCHES, BATCH, EPOCHS, N_ROUNDS = 100, 4, 128, 1, 3
# The CNN and transformer main paths are timed as the best of this many
# windows: phase 19c holds their rounds/s against a best-of-2 timing, and
# one window alone once read 39% slow on the card.
MAIN_WINDOWS = 2
# (name, H, W, Cin, Cout, input needs grad) of the CNN's convs at 32×32×3.
LAYERS = [("Conv_0", 32, 32, 3, 32, False), ("Conv_1", 16, 16, 32, 64, True)]
SOURCE = "tpfl_torch/parallel/csrc/conv_bwd.cu"
REPLACES = {
    "conv_dw": "tpfl/parallel/conv_kernel.py:82",
    "conv_dx": "tpfl/parallel/conv_kernel.py:103",
    "flash_fwd": "tpfl/parallel/flash_kernel.py:60",
    "flash_dq": "tpfl/parallel/flash_kernel.py:112",
    "flash_dkv": "tpfl/parallel/flash_kernel.py:149",
}
FLASH_SOURCE = "tpfl_torch/parallel/csrc/flash_attn.cu"
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")

# The transformer main path: bench.py's transformer_fed tier shape.
LM_KW = dict(vocab=256, dim=512, heads=8, n_layers=4, max_len=4096)
T_NODES, T_BATCHES, T_BATCH, T_SEQ, T_LR = 8, 1, 8, 2048, 0.05
# (label, B, S, H, D) of the flash kernel phase: the main path's
# attention (nodes fold into the batch: 8 nodes x 8 sequences), the
# transformer tier's long context (bench.py:3651-3655) and the attention
# tier's two shapes (bench.py:3566-3610: B 1, H 8, D 128, causal).
FLASH_SHAPES = [("main", T_NODES * T_BATCH, T_SEQ, 8, 64), ("long", 1, 32768, 8, 64),
                ("attention 8k", 1, 8192, 8, 128), ("attention 32k", 1, 32768, 8, 128)]


def log(msg: str) -> None:
    print(msg, flush=True)


def _cuda_tool(name: str) -> str:
    return shutil.which(name) or str(Path(_build.nvcc_path()).parent / name)


def _demangle(names: list[str]) -> dict[str, str]:
    """Mangled -> readable kernel names (``cu++filt``; as they are if the
    tool is missing)."""
    try:
        out = subprocess.run([_cuda_tool("cu++filt")], input="\n".join(names),
                             capture_output=True, text=True, timeout=60, check=True)
        readable = out.stdout.splitlines()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        readable = names
    return {n: r.replace("(anonymous namespace)::", "").replace("<unnamed>::", "")
            for n, r in zip(names, readable)}


def ptxas_report(src: str) -> dict[str, dict]:
    """Registers and spill bytes of every kernel in ``csrc/<src>.cu`` from
    the build's ``-Xptxas -v`` output, keyed by mangled name."""
    per, cur = {}, None
    for line in _build.build_log(src).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = per.setdefault(m.group(1), {"registers": None, "spill_bytes": 0})
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            cur["registers"] = int(m.group(1))
        elif cur is not None and (m := re.search(r"(\d+) bytes spill stores", line)):
            cur["spill_bytes"] = int(m.group(1))
    return per


SASS_OPS = ("HGMMA", "UTMALDG", "LDGSTS")


def sass_counts(src: str) -> dict[str, dict]:
    """Per kernel of ``csrc/<src>.cu``'s built library (mangled name): the
    count of HGMMA (wgmma), UTMALDG (TMA tile load) and LDGSTS
    (``cp.async``) instructions in its SASS."""
    out = subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(_build._target(src))],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    per = {}
    for body in re.split(r"\n\s*Function : ", out)[1:]:
        per[body.split("\n", 1)[0].strip()] = {
            op: len(re.findall(rf"\b{op}\b", body)) for op in SASS_OPS}
    return per


# The main path's instantiations of the redesigned kernels (bf16; D = 64
# for flash; conv_dw's 3-D view with 32-channel chunks at Conv_0 and 4-D
# view with 64-channel chunks at Conv_1), as parts of their mangled names:
# (source, name part, the SASS instructions of which each needs at least
# one of every group).
_TMA_WGMMA = (("HGMMA",), ("UTMALDG",))
WGMMA_KERNELS = {
    "flash_fwd": [("flash_attn", "flash_fwd_wgmmaILi64E13__nv_bfloat16", _TMA_WGMMA)],
    "flash_dq": [("flash_attn", "flash_dq_wgmmaILi64E13__nv_bfloat16", _TMA_WGMMA)],
    "flash_dkv": [("flash_attn", "flash_dkv_wgmmaILi64E13__nv_bfloat16", _TMA_WGMMA)],
    "conv_dx": [("conv_bwd", "conv_dx_wgmma", (("HGMMA",), ("UTMALDG", "LDGSTS")))],
    "conv_dw": [("conv_bwd", "conv_dw_wgmmaILb1ELi32E", _TMA_WGMMA),
                ("conv_bwd", "conv_dw_wgmmaILb0ELi64E", _TMA_WGMMA)],
}


def build_report() -> dict[str, dict]:
    """Logs ptxas's registers / spills of every kernel, any ptxas note that
    it serialised wgmma, and the SASS counts of every kernel of a source
    with a wgmma kernel; returns {kernel: {...}} for the main path's wgmma
    kernels and fails unless each has HGMMA and a TMA (or cp.async) load."""
    reports = {src: ptxas_report(src) for src in _build.all_sources()}
    for src, rep in reports.items():
        names = _demangle(list(rep))
        for name, r in rep.items():
            log(f"ptxas[{src}] {names[name][:110]}: {r['registers']} registers, "
                f"{r['spill_bytes']} bytes spill stores")
        for line in _build.build_log(src).splitlines():
            if "wgmma" in line.lower() and "warning" in line.lower():
                log(f"ptxas[{src}] {line.strip()[:300]}")
    sources = sorted({src for parts in WGMMA_KERNELS.values() for src, _, _ in parts})
    sass = {src: sass_counts(src) for src in sources}
    for src in sources:
        names = _demangle(list(sass[src]))
        for name, counts in sass[src].items():
            log(f"sass[{src}] {names[name][:110]}: "
                + ", ".join(f"{op} {n}" for op, n in counts.items()))
    out = {}
    for kernel, parts in WGMMA_KERNELS.items():
        found = []
        for src, part, needs in parts:
            key = next((n for n in sass[src] if part in n), None)
            if key is None or not all(any(sass[src][key][op] for op in group) for group in needs):
                raise AssertionError(f"{kernel}: no {part} with {needs} in the build's SASS")
            found.append({"kernel": _demangle([key])[key].split("(CUtensorMap")[0],
                          **sass[src][key], **reports[src].get(key, {})})
        out[kernel] = found[0] if len(found) == 1 else found
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 7) -> float:
    """Median CUDA-event time of ``fn()`` over ``iters`` runs, after one
    warm-up run."""
    fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> dict:
    """The least time for the work: bytes (each input read once, each
    output written once) at peak bandwidth vs operations at the bf16
    tensor-core peak, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return {"bytes_ms": t_bytes, "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def grouped_nchw(a: torch.Tensor) -> torch.Tensor:
    """[N, B, H, W, C] -> the grouped conv's [B, N·C, H, W], channels-last."""
    n, b, h, w, c = a.shape
    return a.permute(1, 0, 4, 2, 3).reshape(b, n * c, h, w).contiguous(
        memory_format=torch.channels_last)


def library_backward(x, g, w, mask):
    """PyTorch's own grouped conv backward on the same operands."""
    n, k, cin, cout = w.shape[0], w.shape[1], w.shape[3], w.shape[4]
    xg, gg = grouped_nchw(x), grouped_nchw(g)
    wg = w.permute(0, 4, 3, 1, 2).reshape(n * cout, cin, k, k).contiguous()
    return lambda: torch.ops.aten.convolution_backward(
        gg, xg, wg, None, [1, 1], [k // 2, k // 2], [1, 1], False, [0, 0], n, mask)


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor,
                rtol: float, atol_rel: float) -> float:
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    scale = ref.abs().max().item()
    limit = rtol * ref.abs() + atol_rel * scale
    if not torch.isfinite(got).all() or bool((err > limit).any()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version "
            f"(max |err| {err.max().item():.3e}, max |ref| {scale:.3e})")
    return err.max().item()


# (rtol, atol relative to max |plain|) of a conv kernel against its plain
# version. conv_dw: f32 sums of the same bf16 products in another order.
# conv_dx: bf16 outputs of f32 sums; one bf16 rounding (2^-8 relative)
# apart at most, plus the f32 order near zero.
CONV_DW_BOUND, CONV_DX_BOUND = (1e-4, 1e-4), (2.0 ** -7, 1e-3)


def conv_layer_rows(n: int, batch: int, gen) -> dict:
    """Both conv kernels at the CNN's two layers, ``n`` nodes of ``batch``
    bf16 images each: each must take its wgmma kernel (``conv_dw`` with
    the same bits on a second run), is held against its plain version
    and timed beside the plain version and the library's backward, with
    its bound. Returns {kernel: [per-layer row]}."""
    bf16 = torch.bfloat16
    per = {"conv_dw": [], "conv_dx": []}
    for name, h, w, cin, cout, dx_needed in LAYERS:
        x = torch.randn(n, batch, h, w, cin, device="cuda", generator=gen).to(bf16)
        g = torch.randn(n, batch, h, w, cout, device="cuda", generator=gen).to(bf16)
        wk = (0.1 * torch.randn(n, 3, 3, cin, cout, device="cuda", generator=gen)).to(bf16)
        m = n * batch * h * w
        label = f"{name} B={batch} N={n}"
        # conv_dw: the same bits run to run (no float atomics).
        wgmma = ck.conv_dw.wgmma_launches
        dw = ck.conv_dw(x, g, 3)
        if ck.conv_dw.wgmma_launches != wgmma + 1:
            raise AssertionError(f"conv_dw[{label}]: did not take the wgmma kernel")
        if not torch.equal(ck.conv_dw(x, g, 3), dw):
            raise AssertionError(f"conv_dw[{label}]: two runs differ")
        err = check_close(f"conv_dw[{label}]", dw, ck.conv_dw_plain(x, g, 3), *CONV_DW_BOUND)
        nbytes = (x.numel() + g.numel()) * 2 + dw.numel() * 4
        per["conv_dw"].append({
            **bound(nbytes, 2.0 * m * 9 * cin * cout),
            "layer": name, "batch": batch, "nodes": n, "max_abs_err": err,
            "ms": time_ms(lambda: ck.conv_dw(x, g, 3)),
            "plain_ms": time_ms(lambda: ck.conv_dw_plain(x, g, 3), 3),
            "library_ms": time_ms(library_backward(x, g, wk, [False, True, False])),
        })
        if not dx_needed:
            continue
        wgmma = ck.conv_dx.wgmma_launches
        dx = ck.conv_dx(g, wk)
        if ck.conv_dx.wgmma_launches != wgmma + 1:
            raise AssertionError(f"conv_dx[{label}]: did not take the wgmma kernel")
        err = check_close(f"conv_dx[{label}]", dx, ck.conv_dx_plain(g, wk), *CONV_DX_BOUND)
        nbytes = (g.numel() + wk.numel() + dx.numel()) * 2
        per["conv_dx"].append({
            **bound(nbytes, 2.0 * m * 9 * cout * cin),
            "layer": name, "batch": batch, "nodes": n, "max_abs_err": err,
            "ms": time_ms(lambda: ck.conv_dx(g, wk)),
            "plain_ms": time_ms(lambda: ck.conv_dx_plain(g, wk), 3),
            "library_ms": time_ms(library_backward(x, g, wk, [True, False, False])),
        })
        del x, g, wk, dw, dx
        torch.cuda.empty_cache()
    return per


def kernel_phase() -> list[dict]:
    """Both conv kernels at the main-path shapes against their plain
    versions."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    per = conv_layer_rows(N_NODES, BATCH, gen)
    rows = []
    for kname, layers in per.items():
        tot = {key: sum(r[key] for r in layers)
               for key in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")}
        rows.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[kname], "launches": 0,
            "max_abs_err": max(r["max_abs_err"] for r in layers),
            **tot, "bound_ms": max(tot["bytes_ms"], tot["ops_ms"]),
            "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
            "per_step_of": [r["layer"] for r in layers],
            "layers": layers,
        })
    return rows


def check_dw_case(cin: int, cout: int, hw: tuple, b: int, n: int, gen) -> float:
    """One bf16 conv_dw shape against the plain version at the main
    shapes' tolerance and against itself run again (the same bits); fails
    unless it took the wgmma kernel. Returns max |err| / max |ref|."""
    h, w = hw
    x = torch.randn(n, b, h, w, cin, device="cuda", generator=gen).to(torch.bfloat16)
    g = torch.randn(n, b, h, w, cout, device="cuda", generator=gen).to(torch.bfloat16)
    wgmma = ck.conv_dw.wgmma_launches
    dw = ck.conv_dw(x, g, 3)
    label = f"conv_dw[Cin={cin} Cout={cout} {h}x{w} B={b} N={n}]"
    if ck.conv_dw.wgmma_launches != wgmma + 1:
        raise AssertionError(f"{label}: did not take the wgmma kernel")
    if not torch.equal(ck.conv_dw(x, g, 3), dw):
        raise AssertionError(f"{label}: two runs differ")
    ref = ck.conv_dw_plain(x, g, 3)
    return check_close(label, dw, ref, 1e-4, 1e-4) / ref.abs().max().item()


def check_dx_case(cin: int, cout: int, hw: tuple, b: int, n: int, gen) -> float:
    """One bf16 conv_dx shape against the plain version at the main
    shape's tolerance; fails unless it took the wgmma kernel. Returns
    max |err| / max |ref|."""
    h, w = hw
    g = torch.randn(n, b, h, w, cout, device="cuda", generator=gen).to(torch.bfloat16)
    wk = torch.randn(n, 3, 3, cin, cout, device="cuda", generator=gen).to(torch.bfloat16)
    wgmma = ck.conv_dx.wgmma_launches
    dx = ck.conv_dx(g, wk)
    label = f"conv_dx[Cin={cin} Cout={cout} {h}x{w} B={b} N={n}]"
    if ck.conv_dx.wgmma_launches != wgmma + 1:
        raise AssertionError(f"{label}: did not take the wgmma kernel")
    ref = ck.conv_dx_plain(g, wk)
    return check_close(label, dx, ref, 2.0 ** -7, 1e-3) / ref.float().abs().max().item()


def conv_dw_edge_cases() -> float:
    """Each bf16 edge case of the wgmma conv_dw (``ck.WGMMA_DW_EDGES``, the
    card tests' shapes) through :func:`check_dw_case`. Returns the worst
    max |err| relative to the case's largest value."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    return max(check_dw_case(*case, gen) for case in ck.WGMMA_DW_EDGES)


def conv_node_limit_cases() -> dict:
    """conv_dw and conv_dx at 65,537 nodes (more than a grid's y or z axis
    holds), B = 1, 4×8 images: bf16 conv_dw on the wgmma kernel (the 4-D
    view at Cin 8 -> Cout 64, the 3-D view at Cin 3 -> Cout 32, W·Cin a
    multiple of 8), bf16 conv_dx on it at Cin 8 -> Cout 64 (WMMA at
    Cout 32), and f32 on the CUDA-core kernels, each against its plain
    version at the main shapes' tolerances; fails if a launch took another
    kernel than its rule says. Returns {case: max |err|}."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    out = {}
    for dtype, cin, cout in ((torch.bfloat16, 8, 64), (torch.bfloat16, 3, 32),
                             (torch.float32, 3, 5)):
        n = 65537
        x = torch.randn(n, 1, 4, 8, cin, device="cuda", generator=gen).to(dtype)
        g = torch.randn(n, 1, 4, 8, cout, device="cuda", generator=gen).to(dtype)
        wk = torch.randn(n, 3, 3, cin, cout, device="cuda", generator=gen).to(dtype)
        label = f"N={n} {str(dtype)[6:]} {cin}->{cout}"
        wgmma = (ck.conv_dw.wgmma_launches, ck.conv_dx.wgmma_launches)
        err = check_close(f"conv_dw[{label}]", ck.conv_dw(x, g, 3), ck.conv_dw_plain(x, g, 3),
                          1e-4, 1e-4)
        rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
        err = max(err, check_close(f"conv_dx[{label}]", ck.conv_dx(g, wk),
                                   ck.conv_dx_plain(g, wk), rtol, 1e-3))
        bf16 = dtype == torch.bfloat16
        took = (ck.conv_dw.wgmma_launches - wgmma[0], ck.conv_dx.wgmma_launches - wgmma[1])
        if took != (bf16, bf16 and cout % 64 == 0):
            raise AssertionError(f"conv[{label}]: wgmma launches (conv_dw, conv_dx) {took}")
        out[label] = err
        del x, g, wk
    torch.cuda.empty_cache()
    return out


def conv_edge_cases() -> float:
    """Each bf16 edge case of the wgmma conv_dx (``ck.WGMMA_DX_EDGES``, the
    card tests' shapes) through :func:`check_dx_case`. Returns the worst
    max |err| relative to the case's largest value."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    return max(check_dx_case(*case, gen) for case in ck.WGMMA_DX_EDGES)


def reference_phase() -> None:
    """Small f32 rounds on the card: the kernels (``conv_impl="pallas"``)
    and the forward-style backward (``"fwd_bwd"``, the default) each
    against plain autograd (``"xla"``). cuDNN's TF32 is off
    (``torch.backends.cudnn.allow_tf32 = False``, as ``kernel_phase`` set
    it), so every convolution sums in f32. Tolerance: f32 sums in other
    orders over 2 SGD steps."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1)
    xs = rng.uniform(size=(4, 2, 16, 32, 32, 3)).astype(np.float32)
    ys = rng.integers(0, 10, size=(4, 2, 16)).astype(np.int32)
    out = {}
    for impl in ("pallas", "fwd_bwd", "xla"):
        fed = VmapFederation(CNN(out_channels=10, compute_dtype=torch.float32,
                                 conv_impl=impl), n_nodes=4, seed=0)
        out[impl] = fed.round(fed.init_params((32, 32, 3)), xs, ys,
                              weights=[1.0, 0.0, 2.0, 1.0])
    assert_trees_close(out["pallas"], out["xla"])
    assert_trees_close(out["fwd_bwd"], out["xla"])


def assert_trees_close(got: tuple, want: tuple) -> None:
    """(params, losses) of two rounds at rtol 1e-3, atol 1e-4."""
    want_params = dict(tree_items(want[0]))
    for path, v in tree_items(got[0]):
        torch.testing.assert_close(v, want_params[path], rtol=1e-3, atol=1e-4, msg=path)
    torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=1e-4)


def check_main_path(params: dict, losses: torch.Tensor, launches: dict, want: dict) -> None:
    """Every kernel of the path launched as often as expected, finite
    losses, and one finite aggregate on every node."""
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite losses {losses}")
    for path, v in tree_items(params):
        if not torch.isfinite(v).all() or not torch.equal(v, v[:1].expand_as(v)):
            raise AssertionError(f"{path}: aggregate not finite or not identical on every node")


WRAPPERS = {"conv_dw": ck.conv_dw, "conv_dx": ck.conv_dx, "flash_fwd": fk.flash_fwd,
            "flash_dq": fk.flash_dq, "flash_dkv": fk.flash_dkv}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = fn.wgmma_launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def read_wgmma_launches(names) -> dict:
    return {name: WRAPPERS[name].wgmma_launches for name in names}


def check_all_wgmma(path: str, launches: dict, wgmma: dict) -> None:
    """Every launch of each kernel in ``wgmma`` took its wgmma kernel."""
    for name, took in wgmma.items():
        if took != launches[name]:
            raise AssertionError(f"{took} of {launches[name]} {name} launches of the {path} "
                                 "took the wgmma kernel; expected all")


def carry(out: tuple) -> tuple[dict, dict, torch.Tensor]:
    """(params, the state to pass to the next window, losses) of a
    ``run_rounds`` result: ``(params, losses)``, ``(params, aux, losses)``
    or ``(params, aux, (c_locals, c_global), losses)``."""
    if len(out) == 2:
        return out[0], {}, out[1]
    if len(out) == 3:
        return out[0], {"aux": out[1]}, out[2]
    return out[0], {"aux": out[1], "scaffold_state": out[2]}, out[3]


def timed_window(fed, params: dict, state: dict, xs, ys, windows: int = 1) -> tuple:
    """One warm-up round, then ``windows`` timed N_ROUNDS windows, each
    training from the last one's fold, with every launch count set to 0
    just before the first. Returns (the best window's wall seconds, params,
    state, the last window's losses, launches, wgmma launches, (fed, params,
    xs, ys, state) for a profiled round)."""
    params, state, _ = carry(fed.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=1,
                                            **state))  # warm-up
    torch.cuda.synchronize()

    reset_launches()
    wall = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        out = fed.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=N_ROUNDS, **state)
        torch.cuda.synchronize()
        wall = min(wall, time.perf_counter() - t0)
        params, state, losses = carry(out)
    launches, wgmma = read_launches(), read_wgmma_launches(WRAPPERS)
    return wall, params, state, losses, launches, wgmma, (fed, params, xs, ys, state)


def cnn_data(fed) -> tuple[torch.Tensor, torch.Tensor]:
    """The CNN round's seeded synthetic CIFAR-shaped batches, node-stacked
    on the card ([N_NODES, N_BATCHES, BATCH, ...], bf16 images)."""
    x, y, _, _ = synthetic_cifar10(n_train=N_NODES * N_BATCHES * BATCH, n_test=10, seed=0)
    xs = torch.from_numpy(x.reshape(N_NODES, N_BATCHES, BATCH, 32, 32, 3)).to(
        "cuda", torch.bfloat16)
    return fed.shard_data(xs, y.reshape(N_NODES, N_BATCHES, BATCH))


def cnn_rounds(conv_impl: str, algorithm: str = "fedavg", lr: float = 0.1,
               windows: int = 1) -> tuple:
    """The 100-node CNN round with ``conv_impl``, ``algorithm`` and
    learning rate ``lr`` (the wire codec as ``Settings.ENGINE_WIRE_CODEC``
    says): a
    :func:`timed_window` of ``windows`` windows. Returns (window wall seconds, params, losses,
    launches, wgmma launches of the conv kernels, profile arguments)."""
    fed = VmapFederation(CNN(out_channels=10, conv_impl=conv_impl), n_nodes=N_NODES,
                         learning_rate=lr, seed=0, algorithm=algorithm)
    xs, ys = cnn_data(fed)
    params = fed.init_params((32, 32, 3))
    state = ({"scaffold_state": fed.init_scaffold_state(params)}
             if algorithm == "scaffold" else {})
    wall, params, state, losses, launches, wgmma, fed_args = timed_window(
        fed, params, state, xs, ys, windows)
    for tree in state.get("scaffold_state", ()):
        for path, v in tree_items(tree):
            if not torch.isfinite(v).all():
                raise AssertionError(f"{path}: control variate not finite")
    return (wall, params, losses, launches,
            {k: wgmma[k] for k in ("conv_dw", "conv_dx")}, fed_args)


def cnn_result(card: str, conv_impl: str, wall: float, losses: torch.Tensor) -> dict:
    rounds_s = N_ROUNDS / wall
    return {"card": card, "conv_impl": conv_impl, "n_nodes": N_NODES, "batches": N_BATCHES,
            "batch": BATCH, "rounds": N_ROUNDS, "wall_s": wall, "rounds_per_s": rounds_s,
            "samples_per_s": rounds_s * N_NODES * N_BATCHES * BATCH,
            "mean_loss": losses.mean().item()}


def main_path(card: str) -> tuple[dict, tuple]:
    """The round through the kernels (``conv_impl="pallas"``): 8 conv_dw
    and 4 conv_dx launches a round, every one on its wgmma kernel. Its
    rounds/s is the best of ``MAIN_WINDOWS`` windows, as phase 19c times
    the windows it is held against."""
    wall, params, losses, launches, wgmma, fed_args = cnn_rounds("pallas",
                                                                 windows=MAIN_WINDOWS)
    steps = N_BATCHES * EPOCHS * N_ROUNDS * MAIN_WINDOWS
    check_main_path(params, losses, launches, {
        **dict.fromkeys(WRAPPERS, 0), "conv_dw": 2 * steps, "conv_dx": steps})
    check_all_wgmma("CNN round", launches, wgmma)
    return ({**cnn_result(card, "pallas", wall, losses), "launches": launches,
             "wgmma_launches": wgmma}, fed_args)


def fwd_bwd_round(card: str) -> dict:
    """The same round with the reference's default ``conv_impl="fwd_bwd"``:
    both conv gradients as forward-style grouped cuDNN convolutions, no
    kernel of the port. The round's own yardstick beside the kernels'
    round: finite losses, one aggregate on every node, no conv kernel
    launched."""
    wall, params, losses, launches, _, _ = cnn_rounds("fwd_bwd")
    check_main_path(params, losses, launches, dict.fromkeys(WRAPPERS, 0))
    return cnn_result(card, "fwd_bwd", wall, losses)


# ---- the transformer slice ---------------------------------------------------


def check_rms(name: str, got: torch.Tensor, ref: torch.Tensor, rel: float) -> float:
    """f32 outputs of a kernel against its plain version: the root mean
    square of the difference within ``rel`` of the reference's, and no
    element off by more than 2^-7 of the largest entry (one flipped bf16
    rounding of a P or dS element)."""
    got, ref = got.float(), ref.float()
    err = got - ref
    rms, ref_rms = err.pow(2).mean().sqrt().item(), ref.pow(2).mean().sqrt().item()
    worst = err.abs().max().item()
    if not torch.isfinite(got).all() or rms > rel * ref_rms or (
            worst > 2.0 ** -7 * ref.abs().max().item()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version (rms err "
                             f"{rms:.3e} vs rms ref {ref_rms:.3e}, max err {worst:.3e})")
    return rms / ref_rms


def flash_work(bh: int, s: int, d: int, causal: bool) -> dict:
    """FLOPs and bytes of each flash kernel at these shapes: 2·D FLOPs per
    (query, key) pair and product; the pairs a causal mask leaves
    (S(S+1)/2). flash_fwd: QKᵀ, PV; flash_dq: QKᵀ, dO·Vᵀ, dS·K; flash_dkv:
    QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q. Bytes: bf16 operands read once, f32 lse and
    delta rows, bf16 outputs written once."""
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    mat, rows = bh * s * d * 2, bh * s * 4
    return {
        "flash_fwd": (2 * d * pairs * 2, 3 * mat + mat + rows),
        "flash_dq": (3 * d * pairs * 2, 4 * mat + 2 * rows + mat),
        "flash_dkv": (4 * d * pairs * 2, 4 * mat + 2 * rows + 2 * mat),
    }


def library_flash(q, k, v, do, b: int, h: int) -> tuple:
    """PyTorch's flash-backend SDPA on the same bf16 causal operands
    ([B, H, S, D] views of the folded [B·H, S, D]): (forward, backward)
    thunks. The port never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    s, d = q.shape[1], q.shape[2]
    q4, k4, v4 = (t.view(b, h, s, d).detach().requires_grad_(True) for t in (q, k, v))
    do4 = do.view(b, h, s, d)

    def fwd():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True)

    out = fwd()
    return (lambda: fwd(),
            lambda: torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True))


def flash_takes_wgmma(dtype: torch.dtype, d: int) -> bool:
    """The dispatch rule of ``csrc/flash_attn.cu``: bf16 operands whose rows
    TMA can address (D a multiple of 8 up to 128) take the wgmma kernels."""
    return dtype == torch.bfloat16 and d % 8 == 0 and d <= 128


@contextlib.contextmanager
def taking_wgmma(label: str, wgmma: bool):
    """Every flash launch inside the block took its wgmma kernel (with
    ``wgmma`` False: none did), as each launch reported it."""
    before = {n: (WRAPPERS[n].launches, WRAPPERS[n].wgmma_launches) for n in FLASH_KERNELS}
    yield
    for name in FLASH_KERNELS:
        launched = WRAPPERS[name].launches - before[name][0]
        took = WRAPPERS[name].wgmma_launches - before[name][1]
        if took != (launched if wgmma else 0):
            raise AssertionError(f"{name}[{label}]: {took} of {launched} launches took the "
                                 f"wgmma kernel; expected {'all' if wgmma else 'none'}")


def check_flash(label: str, q, k, v, do, causal: bool) -> tuple[dict, dict, tuple]:
    """All three flash kernels on bf16 operands against their plain
    versions, with bf16 outputs and with f32 outputs (tolerances as
    ``flash_shape_phase`` states them), each launch on the kernel the
    dispatch rule names and ``flash_dq`` the same bits twice: ({kernel: max
    |err|}, {kernel: relative rms err of the f32 outputs}, the backward's
    arguments)."""
    with taking_wgmma(label, flash_takes_wgmma(q.dtype, q.shape[-1])):
        errs, rms = {}, {}
        o, lse = fk.flash_fwd(q, k, v, causal)
        o_ref, lse_ref = fk.flash_fwd_plain(q, k, v, causal)
        errs["flash_fwd"] = check_close(f"flash_fwd[{label}] o", o, o_ref, 2.0 ** -7, 2.0 ** -7)
        check_close(f"flash_fwd[{label}] lse", lse, lse_ref, 1e-5, 1e-6)
        o32, _ = fk.flash_fwd(q, k, v, causal, out_dtype=torch.float32)
        o32_ref, _ = fk.flash_fwd_plain(q, k, v, causal, out_dtype=torch.float32)
        rms["flash_fwd"] = check_rms(f"flash_fwd[{label}] o (f32 out)", o32, o32_ref, 2.0 ** -12)
        del o, o32, o32_ref
        delta = (do.float() * o_ref.float()).sum(-1)
        args = (q, k, v, do, lse_ref, delta, causal)
        dq, dq_ref = fk.flash_dq(*args), fk.flash_dq_plain(*args)
        errs["flash_dq"] = check_close(f"flash_dq[{label}]", dq, dq_ref, 2.0 ** -7, 2.0 ** -7)
        if not torch.equal(fk.flash_dq(*args), dq):  # each block owns its dQ rows: no atomics
            raise AssertionError(f"flash_dq[{label}]: two runs differ")
        rms["flash_dq"] = check_rms(f"flash_dq[{label}] (f32 out)",
                                    fk.flash_dq(*args, out_dtype=torch.float32),
                                    fk.flash_dq_plain(*args, out_dtype=torch.float32), 2.0 ** -12)
        del dq, dq_ref
        (dk, dv), (dk_ref, dv_ref) = fk.flash_dkv(*args), fk.flash_dkv_plain(*args)
        errs["flash_dkv"] = max(
            check_close(f"flash_dkv[{label}] dk", dk, dk_ref, 2.0 ** -7, 2.0 ** -7),
            check_close(f"flash_dkv[{label}] dv", dv, dv_ref, 2.0 ** -7, 2.0 ** -7))
        del dk, dv, dk_ref, dv_ref
        (dk32, dv32) = fk.flash_dkv(*args, out_dtype=torch.float32)
        (dk32_ref, dv32_ref) = fk.flash_dkv_plain(*args, out_dtype=torch.float32)
        rms["flash_dkv"] = max(
            check_rms(f"flash_dkv[{label}] dk (f32 out)", dk32, dk32_ref, 2.0 ** -12),
            check_rms(f"flash_dkv[{label}] dv (f32 out)", dv32, dv32_ref, 2.0 ** -12))
    return errs, rms, args


def flash_shape_phase(label: str, b: int, s: int, h: int, d: int) -> dict:
    """All three flash kernels at one bf16 causal shape against their plain
    versions, with times. P and dS are rounded to bf16 at the same values
    on both sides (the plain forward walks the kernel's KEY_TILE-key
    tiles), so the two differ by f32 summation order, which may flip the
    rounding of an output (2^-7 of it) or of a few P / dS elements (each
    moves an output by at most 2^-8 of the operand it weighs, within 2^-7
    of the output's largest entry). bf16 outputs (the main path's): rtol 2^-7
    plus 2^-7 of the largest value. f32 outputs of the same kernels: an
    rms difference within 2^-12 of the output's rms. Flipped P / dS
    roundings add about sqrt(flip rate)·2^-8 ≈ 2^-14 of it (6.4e-5
    measured for dK at S = 32768); a kernel that skipped the bf16
    rounding of P or dS would sit 2^-9/√3 ≈ 1.1e-3 away, 4.6x over the
    limit. A kernel that skipped the causal mask fails both by orders of
    magnitude."""
    bf16, bh = torch.bfloat16, b * h
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=gen).to(bf16)
                   for _ in range(4))
    errs, rms, args = check_flash(label, q, k, v, do, True)
    torch.cuda.empty_cache()

    rows = {}
    lib_fwd, lib_bwd = library_flash(q, k, v, do, b, h)
    library = {"flash_fwd": time_ms(lib_fwd), "flash_dq": time_ms(lib_bwd)}
    library["flash_dkv"] = library["flash_dq"]  # one library call computes both
    timed = {
        "flash_fwd": (lambda: fk.flash_fwd(q, k, v, True),
                      lambda: fk.flash_fwd_plain(q, k, v, True)),
        "flash_dq": (lambda: fk.flash_dq(*args), lambda: fk.flash_dq_plain(*args)),
        "flash_dkv": (lambda: fk.flash_dkv(*args), lambda: fk.flash_dkv_plain(*args)),
    }
    for name, (flops, nbytes) in flash_work(bh, s, d, True).items():
        kernel, plain = timed[name]
        rows[name] = {
            **bound(nbytes, flops), "shape": label, "B": b, "S": s, "H": h, "D": d,
            "wgmma": flash_takes_wgmma(bf16, d),  # check_flash held every launch to it
            "max_abs_err": errs[name], "f32_out_rel_rms_err": rms[name],
            "ms": time_ms(kernel), "plain_ms": time_ms(plain, 3),
            "library_ms": library[name],
        }
    rows["flash_dkv"]["library_covers"] = rows["flash_dq"]["library_covers"] = [
        "flash_dq", "flash_dkv"]
    return rows


# (label, BH, S, D, causal) of the bf16 edge cases: the wgmma kernels'
# tiles (64-key ring stages, 128/192-row blocks, D padded to 64 or 128)
# cut by S and D, and a D whose rows TMA cannot address (D * 2 bytes not a
# multiple of 16), which dispatch gives to the WMMA kernels.
FLASH_EDGES = [("S=100 D=32", 3, 100, 32, False), ("S=130 causal D=128", 3, 130, 128, True),
               ("S=127 causal D=64", 3, 127, 64, True), ("S=129 causal D=64", 3, 129, 64, True),
               ("S=129 causal D=20 (WMMA)", 3, 129, 20, True)] + [
    # flash_dq's 128-row blocks and the forward's 192-row ones, cut by S
    (f"S={s} {'causal ' if causal else ''}D={d}", 3, s, d, causal)
    for s in (191, 192, 193) for d in (8, 24, 64, 128) for causal in (False, True)]


def flash_edge_cases() -> dict:
    """The bf16 edge cases, each held to ``flash_shape_phase``'s
    tolerances: {label: {kernel: max |err|}}."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for label, bh, s, d, causal in FLASH_EDGES:
        q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=gen).to(torch.bfloat16)
                       for _ in range(4))
        errs, rms, _ = check_flash(label, q, k, v, do, causal)
        out[label] = {"max_abs_err": errs, "f32_out_rel_rms_err": rms}
    return out


def flash_mask_case() -> float:
    """f32, non-causal, S = 100 (keys past S in the last 64-key tile are
    masked in the kernel): f32 sums in another order, 1e-5 relative; no
    launch on a wgmma kernel."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, do = (torch.randn(2, 100, 32, device="cuda", generator=gen) for _ in range(4))
    with taking_wgmma("S=100, f32", False):
        o, lse = fk.flash_fwd(q, k, v, False)
        o_ref, lse_ref = fk.flash_fwd_plain(q, k, v, False)
        err = check_close("flash_fwd[S=100, f32]", o, o_ref, 1e-5, 1e-5)
        check_close("flash_fwd[S=100, f32] lse", lse, lse_ref, 1e-5, 1e-6)
        delta = (do * o_ref).sum(-1)
        args = (q, k, v, do, lse_ref, delta, False)
        err = max(err, check_close("flash_dq[S=100, f32]", fk.flash_dq(*args),
                                   fk.flash_dq_plain(*args), 1e-5, 1e-5))
        for name, got, ref in zip(("dk", "dv"), fk.flash_dkv(*args), fk.flash_dkv_plain(*args)):
            err = max(err, check_close(f"flash_dkv[S=100, f32] {name}", got, ref, 1e-5, 1e-5))
    return err


# (label, BH, S, D) of the limit cases: B·H past the 65535 of a grid's y
# axis (wgmma and generic kernels), and head dims past 128, which the
# generic kernels walk in 128-column chunks. Each in bf16 and f32, causal.
FLASH_LIMITS = [("BH=65537 D=16", 65537, 16, 16), ("BH=65537 D=64", 65537, 16, 64)] + [
    (f"D={d}", 3, 130, d) for d in (136, 200, 256, 320)]


def flash_limit_cases() -> dict:
    """The limit cases, forward and both gradients, against the plain
    versions: bf16 outputs at rtol 2^-7 plus 2^-7 of the largest value (as
    ``flash_shape_phase``), f32 at 1e-4 (sums in another order), lse at
    1e-5 relative; each launch on the kernel the dispatch rule names.
    Returns {label: max |err|}."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for label, bh, s, d in FLASH_LIMITS:
        for dtype in (torch.bfloat16, torch.float32):
            tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
            name = f"{label} {str(dtype)[6:]}"
            q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=gen).to(dtype)
                           for _ in range(4))
            with taking_wgmma(name, flash_takes_wgmma(dtype, d)):
                o, lse = fk.flash_fwd(q, k, v, True)
                o_ref, lse_ref = fk.flash_fwd_plain(q, k, v, True)
                err = check_close(f"flash_fwd[{name}] o", o, o_ref, tol, tol)
                check_close(f"flash_fwd[{name}] lse", lse, lse_ref, 1e-5, 1e-6)
                delta = (do.float() * o_ref.float()).sum(-1)
                args = (q, k, v, do, lse_ref, delta, True)
                err = max(err, check_close(f"flash_dq[{name}]", fk.flash_dq(*args),
                                           fk.flash_dq_plain(*args), tol, tol))
                for g, got, ref in zip(("dk", "dv"), fk.flash_dkv(*args),
                                       fk.flash_dkv_plain(*args)):
                    err = max(err, check_close(f"flash_dkv[{name}] {g}", got, ref, tol, tol))
            out[name] = err
            del q, k, v, do, o, o_ref
    torch.cuda.empty_cache()
    return out


def flash_kernel_phase() -> list[dict]:
    per = {name: [] for name in FLASH_KERNELS}
    for label, b, s, h, d in FLASH_SHAPES:
        for name, row in flash_shape_phase(label, b, s, h, d).items():
            per[name].append(row)
        log(f"flash kernel phase [{label}]: ok")
    edges = flash_edge_cases()
    log("flash kernel phase [bf16 edge cases]: ok " + json.dumps(edges))
    limits = flash_limit_cases()
    log("flash kernel phase [limit cases: B·H 65537, D past 128]: ok " + json.dumps(limits))
    mask_err = flash_mask_case()
    out = []
    for name, shapes in per.items():
        main = shapes[0]
        out.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            **{key: main[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                          "bound_by", "bytes_ms", "ops_ms")},
            "per_launch_at": "main", "f32_mask_case_max_abs_err": mask_err,
            "bf16_edge_max_abs_err": max(e["max_abs_err"][name] for e in edges.values()),
            "limit_max_abs_err": max(limits.values()),
            "shapes": shapes,
        })
    return out


def lm_tokens(n: int, nb: int, b: int, s: int, vocab: int, seed: int) -> tuple:
    """Seeded integer tokens and targets [n, nb, b, s], drawn one after the
    other as bench.py's transformer_fed tier draws them."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, vocab, (n, nb, b, s)).astype(np.int32)
    ys = rng.integers(0, vocab, (n, nb, b, s)).astype(np.int32)
    return xs, ys


def transformer_reference_phase() -> None:
    """A small f32 federated TransformerLM round on the card with the
    flash kernels against the same round with blockwise attention.
    Tolerance: f32 sums in other orders over one SGD step."""
    kw = dict(vocab=64, dim=64, heads=4, n_layers=2, max_len=128,
              compute_dtype=torch.float32)
    xs, ys = lm_tokens(4, 1, 2, 128, 64, seed=3)
    out = {}
    for name, attention in (("flash", fk.flash_attention), ("blockwise", blockwise_attention)):
        fed = VmapFederation(TransformerLM(**kw, attention_fn=attention), n_nodes=4,
                             learning_rate=0.05, seed=0)
        out[name] = fed.round(fed.init_params((128,)), xs, ys, weights=[1.0, 0.0, 2.0, 1.0])
    assert_trees_close(out["flash"], out["blockwise"])


def transformer_main_path(card: str) -> tuple[dict, tuple]:
    """The 8-node TransformerLM round through the flash kernels: a
    :func:`timed_window` of ``MAIN_WINDOWS`` windows, 4 launches of each
    flash kernel a round, every one on its wgmma kernel."""
    fed = VmapFederation(TransformerLM(**LM_KW, attention_fn=fk.flash_attention),
                         n_nodes=T_NODES, learning_rate=T_LR, seed=0)
    xs, ys = lm_tokens(T_NODES, T_BATCHES, T_BATCH, T_SEQ, LM_KW["vocab"], seed=5)
    xs, ys = fed.shard_data(xs, ys)
    params = fed.init_params((T_SEQ,))
    wall, params, _, losses, launches, _, _ = timed_window(fed, params, {}, xs, ys,
                                                           MAIN_WINDOWS)
    wgmma = read_wgmma_launches(FLASH_KERNELS)

    per_window = LM_KW["n_layers"] * T_BATCHES * EPOCHS * N_ROUNDS * MAIN_WINDOWS
    check_main_path(params, losses, launches, {
        **dict.fromkeys(WRAPPERS, 0), **dict.fromkeys(FLASH_KERNELS, per_window)})
    check_all_wgmma("transformer round", launches, wgmma)
    tokens = T_NODES * T_BATCHES * T_BATCH * T_SEQ
    rounds_s = N_ROUNDS / wall
    return ({
        "card": card, "model": {**LM_KW, "attention_fn": "flash_attention"},
        "n_nodes": T_NODES, "batches": T_BATCHES, "batch": T_BATCH, "seq": T_SEQ,
        "rounds": N_ROUNDS, "wall_s": wall, "rounds_per_s": rounds_s,
        "tokens_per_round": tokens, "tokens_per_s": rounds_s * tokens,
        "launches": launches, "wgmma_launches": wgmma, "mean_loss": losses.mean().item(),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }, (fed, params, xs, ys, {}))


# ---- the engine's other kinds and the wire codec -----------------------------

# ResNet-18, config 3 (bench.py:3480-3507): 16 nodes, 2 batches of 128,
# 100 classes, lr 0.1; FedProx at the reference's default mu.
RN_NODES, RN_BATCHES, RN_BATCH, RN_CLASSES, RN_LR = 16, 2, 128, 100, 0.1
RN_ALGORITHMS = {"fedavg": {}, "scaffold": {}, "fedprox": {"prox_mu": 0.01}}
# The CNN main path's other variants: (label, ENGINE_WIRE_CODEC, algorithm,
# learning rate). SCAFFOLD runs at lr 0.02: its option-II variate divides
# by K·lr as for plain SGD, and with momentum 0.9 each node's deviation
# from c_global grows each round; at lr 0.1 and 0.05 the reference's
# engine diverges on this CNN (non-finite by the third or fourth round,
# as the port does), at 0.02 both stay finite.
CNN_VARIANTS = [("quant8", "quant8", "fedavg", 0.1),
                ("topk+quant8", "topk+quant8", "fedavg", 0.1),
                ("scaffold", "dense", "scaffold", 0.02)]


@contextlib.contextmanager
def setting(name: str, value):
    """``Settings.<name>`` set to ``value`` inside the block."""
    saved = getattr(Settings, name)
    setattr(Settings, name, value)
    try:
        yield
    finally:
        setattr(Settings, name, saved)


def flat_result(out: tuple) -> dict:
    """Every tensor of a ``run_rounds`` result, by path, on the CPU."""
    params, state, losses = carry(out)
    trees = {"params": params, "aux": state.get("aux", {})}
    if "scaffold_state" in state:
        trees["c_locals"], trees["c_global"] = state["scaffold_state"]
    flat = {path: v.cpu() for path, v in tree_items(trees)}
    flat["losses"] = losses.cpu()
    return flat


def small_window(device: str, model: str, algorithm: str = "fedavg", aux_mode: str = "mean",
                 epochs: int = 1, weights: tuple = (1.0, 0.0, 2.0), n_rounds: int = 2,
                 attack_scales=None) -> dict:
    """A small f32 window on ``device`` (3 nodes, 2 batches of 4 per node,
    8×8×3 inputs, node i's initial params scaled by 1 + i/4 so that the
    nodes differ): ResNet-18 with stage sizes (1, 1), or the CNN through
    the kernels; ``attack_scales`` as ``run_rounds`` takes them. Returns
    :func:`flat_result`."""
    rng = np.random.default_rng(0)
    xs = rng.uniform(size=(3, 2, 4, 8, 8, 3)).astype(np.float32)
    ys = rng.integers(0, 10, size=(3, 2, 4)).astype(np.int32)
    module = (ResNet18(stage_sizes=(1, 1), out_channels=10, compute_dtype=torch.float32)
              if model == "resnet" else
              CNN(channels=(4, 8), dense=16, compute_dtype=torch.float32, conv_impl="pallas"))
    eng = FederationEngine(module, 3, algorithm=algorithm, aux_mode=aux_mode, prox_mu=0.1,
                           seed=0, device=device)
    params, aux = eng.init_state((8, 8, 3))
    scale = 1.0 + torch.arange(3, device=eng.device, dtype=torch.float32) / 4
    params = tree_map(lambda v: v * scale.reshape((-1,) + (1,) * (v.dim() - 1)), params)
    kw = {"aux": aux} if aux else {}
    if algorithm == "scaffold":
        kw["scaffold_state"] = eng.init_scaffold_state(params)
    if attack_scales is not None:
        kw["attack_scales"] = attack_scales
    return flat_result(eng.run_rounds(params, xs, ys, weights=list(weights), epochs=epochs,
                                      n_rounds=n_rounds, **kw))


def kinds_reference_phase() -> dict:
    """Small f32 windows of the engine's other kinds on the card against
    the same windows on the CPU (f32 sums in other orders over 2 rounds:
    rtol 1e-3, atol 1e-4; TF32 off), then the CNN's wire-codec fold on an
    aggregation round with one node elected, which is that node's decoded
    params: the same bits on the card as on the CPU. Returns {case: max
    |err|}."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for case in (dict(model="resnet", algorithm="scaffold", aux_mode="local"),
                 dict(model="resnet", algorithm="fedprox"),
                 dict(model="cnn", algorithm="scaffold")):
        label = "/".join(case.values())
        card, cpu = small_window("cuda", **case), small_window("cpu", **case)
        if sorted(card) != sorted(cpu):
            raise AssertionError(f"{label}: results differ in structure")
        for path in cpu:
            torch.testing.assert_close(card[path], cpu[path], rtol=1e-3, atol=1e-4,
                                       msg=lambda m, p=path: f"{label}: {p}: {m}")
        out[label] = max((card[p] - cpu[p]).abs().max().item() for p in cpu)
    for codec in ("quant8", "topk+quant8"):
        with setting("ENGINE_WIRE_CODEC", codec):
            card, cpu = (small_window(dev, "cnn", epochs=0, weights=(0.0, 1.0, 0.0), n_rounds=1)
                         for dev in ("cuda", "cpu"))
        for path in cpu:
            if path != "losses" and not torch.equal(card[path], cpu[path]):
                raise AssertionError(f"codec {codec}: {path} differs between the card and the CPU")
        out[f"{codec} fold"] = 0.0
    return out


def codec_oracle(row: np.ndarray, bits: int, frac: float) -> np.ndarray:
    """One node's leaf round trip composed from the numpy oracles (f32)."""
    if bits & compression.TOPK and row.size > 1:
        k = max(1, int(np.ceil(row.size * frac)))
        idx, vals = compression.topk_encode_np(row, k)
        if bits & compression.QUANT8:
            vals = compression.q8_decode_np(*compression.q8_encode_np(vals))
        out = np.zeros(row.size, np.float32)
        out[idx.astype(np.int64)] = vals
        return out.reshape(row.shape)
    return np.asarray(compression.q8_decode_np(*compression.q8_encode_np(row)))


def codec_phase() -> dict:
    """Every node's wire round trip at the CNN round's leaf shapes (100
    nodes, f32, seeded normal values) under quant8 and topk+quant8: rows
    0, 50 and 99 of every leaf bit-equal to the numpy oracles; the time
    of the whole tree's round trip (what the round adds), and the bytes
    one node's model ships."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    shapes = CNN(out_channels=10).param_shapes((32, 32, 3))
    tree = {name: {leaf: torch.randn(N_NODES, *shape, device="cuda", generator=gen)
                   for leaf, shape in layer.items()} for name, layer in shapes.items()}
    frac = float(Settings.WIRE_TOPK_FRAC)
    out = {}
    for codec in ("quant8", "topk+quant8"):
        bits = compression.resolve_engine_codec(codec)
        roundtrip = compression.engine_codec_roundtrip_nodes(bits, frac)
        got = dict(tree_items({name: {leaf: roundtrip(v) for leaf, v in layer.items()}
                               for name, layer in tree.items()}))
        for path, x in tree_items(tree):
            for r in (0, N_NODES // 2, N_NODES - 1):
                want = codec_oracle(x[r].cpu().numpy(), bits, frac)
                if got[path][r].cpu().numpy().tobytes() != want.tobytes():
                    raise AssertionError(f"codec {codec}: {path} row {r} differs from the oracle")
        one_node = {name: {leaf: v[0] for leaf, v in layer.items()} for name, layer in tree.items()}
        out[codec] = {
            "ms": time_ms(lambda: [roundtrip(v) for _, v in tree_items(tree)]),
            "wire_bytes_per_model": compression.wire_bytes_per_model(one_node, bits, frac),
            "dense_bytes_per_model": compression.wire_bytes_per_model(one_node, 0),
        }
    return out


def cnn_variant_paths(card: str) -> dict:
    """The 100-node CNN round through the kernels under each of
    ``CNN_VARIANTS``: a 3-round window each, 8 conv_dw and 4 conv_dx
    launches a round, every one on its wgmma kernel."""
    steps = N_BATCHES * EPOCHS * N_ROUNDS
    out = {}
    for label, codec, algorithm, lr in CNN_VARIANTS:
        with setting("ENGINE_WIRE_CODEC", codec):
            wall, params, losses, launches, wgmma, _ = cnn_rounds("pallas", algorithm, lr)
        check_main_path(params, losses, launches, {
            **dict.fromkeys(WRAPPERS, 0), "conv_dw": 2 * steps, "conv_dx": steps})
        check_all_wgmma(f"CNN round ({label})", launches, wgmma)
        out[label] = {**cnn_result(card, "pallas", wall, losses), "wire_codec": codec,
                      "algorithm": algorithm, "learning_rate": lr, "launches": launches,
                      "wgmma_launches": wgmma}
    return out


def resnet_path(card: str) -> tuple[dict, tuple]:
    """ResNet-18 at config 3 under FedAvg (aux kind, aux_mode "mean"),
    SCAFFOLD and FedProx: a :func:`timed_window` each; finite losses, the
    same params and batch stats on every node, finite control variates,
    no kernel of the port launched."""
    per_node = RN_BATCHES * RN_BATCH
    x, y, _, _ = synthetic_classification((32, 32, 3), n_classes=RN_CLASSES,
                                          n_train=RN_NODES * per_node, n_test=10, seed=0)
    x = torch.from_numpy(x.reshape(RN_NODES, RN_BATCHES, RN_BATCH, 32, 32, 3))
    y = y.reshape(RN_NODES, RN_BATCHES, RN_BATCH)
    out, profile_args = {}, None
    for algorithm, kw in RN_ALGORITHMS.items():
        fed = VmapFederation(ResNet18(out_channels=RN_CLASSES), n_nodes=RN_NODES,
                             learning_rate=RN_LR, seed=0, algorithm=algorithm, **kw)
        xs, ys = fed.shard_data(x.to("cuda", torch.bfloat16), y)
        params, aux = fed.init_state((32, 32, 3))
        state = {"aux": aux}
        if algorithm == "scaffold":
            state["scaffold_state"] = fed.init_scaffold_state(params)
        torch.cuda.reset_peak_memory_stats()
        wall, params, state, losses, launches, _, fed_args = timed_window(
            fed, params, state, xs, ys)
        check_main_path({"params": params, "aux": state["aux"]}, losses, launches,
                        dict.fromkeys(WRAPPERS, 0))
        for tree in state.get("scaffold_state", ()):
            for path, v in tree_items(tree):
                if not torch.isfinite(v).all():
                    raise AssertionError(f"{path}: control variate not finite")
        rounds_s = N_ROUNDS / wall
        out[algorithm] = {
            "card": card, "model": "ResNet18(out_channels=100)", "algorithm": algorithm, **kw,
            "n_nodes": RN_NODES, "batches": RN_BATCHES, "batch": RN_BATCH, "rounds": N_ROUNDS,
            "wall_s": wall, "rounds_per_s": rounds_s,
            "samples_per_s": rounds_s * RN_NODES * per_node,
            "mean_loss": losses.mean().item(),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        profile_args = profile_args or fed_args
        del fed, params, state, xs, ys, fed_args
        torch.cuda.empty_cache()
    return out, profile_args


# ---- the protocol learning layer ---------------------------------------------

# Four TorchLearners of the full-width zoo CNN (through the conv kernels,
# at one node each), 512 seeded synthetic CIFAR-shaped training samples
# (4 batches of 128) and 256 test samples each, 1 epoch; node 0 folds the
# four wire-decoded models. (label, WIRE_CODEC, aggregator, learning rate):
# SCAFFOLD at lr 0.02, as the engine's SCAFFOLD window (§6 of PERF.md).
P_NODES, P_TRAIN, P_TEST, P_BATCH = 4, 512, 256, 128
P_ROUNDS = [("fedavg", "dense", "fedavg", 0.1), ("quant8", "quant8", "fedavg", 0.1),
            ("scaffold", "dense", "scaffold", 0.02), ("fedprox", "dense", "fedprox", 0.1)]
P_AGGREGATORS = {"fedavg": FedAvg, "scaffold": Scaffold, "fedprox": FedProx}
CNN_PARAM_BYTES = 2_180_392  # 545,098 f32 params


def protocol_learners(aggregator: str, lr: float) -> tuple[list, object, dict]:
    """``P_NODES`` learners on the card from the same seed-0 params, each
    with its own data and the callbacks the aggregator kind names, node
    0's aggregator, and the seed-0 params by path in f64."""
    module = CNN(out_channels=10, conv_impl="pallas")
    params = init_params(module, (32, 32, 3), seed=0, device="cuda")
    aggs = [P_AGGREGATORS[aggregator](f"node-{i}", device="cuda") for i in range(P_NODES)]
    learners = []
    for i, agg in enumerate(aggs):
        x, y, xt, yt = synthetic_cifar10(n_train=P_TRAIN, n_test=P_TEST, seed=100 + i)
        learners.append(TorchLearner(TpflModel(module, params, device="cuda"),
                                     TpflDataset.from_arrays(x, y, xt, yt), addr=f"node-{i}",
                                     aggregator=agg, learning_rate=lr, batch_size=P_BATCH,
                                     device="cuda"))
    return learners, aggs[0], {p: v.double() for p, v in tree_items(params)}


def check_q8_leaves(payload: bytes, model) -> None:
    """Each leaf of a quant8 payload decodes bit-equal to the q8 oracle
    of the model's own leaf."""
    decoded, _, _, _ = compression.decode_model_payload(payload)
    want = dict(tree_items(tree_map(lambda v: v.float().cpu().numpy(), model.get_parameters())))
    for path, leaf in tree_items(decoded):
        oracle = compression.q8_decode_np(*compression.q8_encode_np(want[path]))
        if np.asarray(leaf).tobytes() != oracle.astype(np.float32).tobytes():
            raise AssertionError(f"quant8 payload: {path} differs from the q8 oracle")


def plain_aggregate(label: str, decoded: list, prev: tuple) -> tuple[dict, dict | None]:
    """The aggregate from the decoded models by plain torch in f64, as
    (params by path, SCAFFOLD's global variate by path or None): the
    sample-weighted mean; or SCAFFOLD's x + mean(delta_y_i) and
    c + mean(delta_c_i), with (x, c) = ``prev``: the seed-0 params every
    learner starts from and no variate (zeros) in the first round, this
    function's own result after."""
    trees = [dict(tree_items(m.get_parameters())) for m in decoded]
    dev = next(iter(trees[0].values())).device
    if label != "scaffold":
        w = torch.tensor([float(m.get_num_samples()) for m in decoded], dtype=torch.float64,
                         device=dev)
        return {p: torch.tensordot(w, torch.stack([t[p].double() for t in trees]), dims=1)
                / w.sum() for p in trees[0]}, None

    def mean_of(key: str) -> dict:
        # The deltas ride in the wire info: numpy leaves after a decode.
        per = [dict(tree_items(m.get_info("scaffold")[key])) for m in decoded]
        return {p: torch.stack([torch.as_tensor(np.array(d[p]), dtype=torch.float64,
                                                device=dev) for d in per]).mean(0)
                for p in per[0]}

    x, c = prev
    dy, dc = mean_of("delta_y_i"), mean_of("delta_c_i")
    return ({p: x[p] + dy[p] for p in trees[0]},
            {p: (c[p] if c else 0.0) + dc[p] for p in dc})


def protocol_round(label: str, learners: list, agg, prev: tuple) -> tuple[dict, tuple]:
    """One round: every learner fits, its model is wire-encoded (the
    codec of ``Settings.WIRE_CODEC``), node 0 rebuilds each model from
    the bytes (``build_copy(params=bytes)``) and folds them
    (``set_nodes_to_aggregate`` -> ``add_model`` ×4 ->
    ``wait_and_get_aggregation``), and every learner ``set_model``s the
    aggregate's wire bytes and evaluates it. The conv launch counts are
    set to 0 just before the fits and read after them. ``prev``: the
    plain reference's state at the round's start (:func:`plain_aggregate`).
    Returns (timings and checks, the plain reference's state after it)."""
    addrs = [ln.get_addr() for ln in learners]
    torch.cuda.synchronize()
    reset_launches()
    t_round = time.perf_counter()
    fit_ms, models = [], []
    for ln in learners:
        t0 = time.perf_counter()
        models.append(ln.fit())
        torch.cuda.synchronize()
        fit_ms.append((time.perf_counter() - t0) * 1e3)
    launches, wgmma = read_launches(), read_wgmma_launches(("conv_dw", "conv_dx"))
    t0 = time.perf_counter()
    payloads = [m.encode_parameters() for m in models]
    encode_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    decoded = [learners[0].get_model().build_copy(params=p) for p in payloads]
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    agg.set_nodes_to_aggregate(addrs)
    for m in decoded:
        agg.add_model(m)
    out = agg.wait_and_get_aggregation(timeout=60)
    torch.cuda.synchronize()
    fold_ms = (time.perf_counter() - t0) * 1e3
    agg.clear()
    metrics = []
    broadcast = out.encode_parameters()
    for ln in learners:
        ln.set_model(broadcast)
        metrics.append(ln.evaluate())
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t_round) * 1e3

    steps = P_NODES * (P_TRAIN // P_BATCH)
    want = {**dict.fromkeys(WRAPPERS, 0), "conv_dw": 2 * steps, "conv_dx": steps}
    if launches != want:
        raise AssertionError(f"protocol {label}: kernel launches {launches}, expected {want}")
    check_all_wgmma(f"protocol round ({label})", launches, wgmma)
    if out.get_contributors() != addrs or out.get_num_samples() != P_NODES * P_TRAIN:
        raise AssertionError(f"protocol {label}: contributors {out.get_contributors()}, "
                             f"num_samples {out.get_num_samples()}")
    if any(not np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"protocol {label}: non-finite metrics {metrics}")
    if Settings.WIRE_CODEC == "quant8":
        for p, m in zip(payloads, models):
            check_q8_leaves(p, m)
    elif min(len(p) for p in payloads) < CNN_PARAM_BYTES or payloads[0][:1] != b"\x03":
        raise AssertionError(f"protocol {label}: not a dense v3 payload")
    plain, plain_c = plain_aggregate(label, decoded, prev)
    got = dict(tree_items(out.get_parameters()))
    for path, ref in plain.items():
        torch.testing.assert_close(got[path].double(), ref, rtol=1e-6, atol=1e-7,
                                   msg=lambda m, p=path: f"protocol {label}: {p}: {m}")
    if plain_c is not None:
        # f32 sums of four deltas: a few roundings of the largest term.
        got_c = dict(tree_items(out.get_info("scaffold")["global_c"]))
        if got_c.keys() != plain_c.keys():
            raise AssertionError(f"protocol scaffold: global_c leaves {sorted(got_c)}")
        for path, ref in plain_c.items():
            torch.testing.assert_close(
                got_c[path].double(), ref, rtol=1e-6, atol=1e-6 * ref.abs().max().item(),
                msg=lambda m, p=path: f"protocol scaffold: global_c {p}: {m}")
    return {"fit_ms": fit_ms,
            "fit_samples_per_s": [P_TRAIN / ms * 1e3 for ms in fit_ms],
            "encode_ms_4": encode_ms, "decode_ms_4": decode_ms, "fold_ms_4": fold_ms,
            "round_wall_ms": wall_ms, "payload_bytes": len(payloads[0]),
            "launches": {k: launches[k] for k in ("conv_dw", "conv_dx")},
            "wgmma_launches": wgmma,
            "mean_test_loss": float(np.mean([m["test_loss"] for m in metrics])),
            "mean_test_acc": float(np.mean([m["test_metric"] for m in metrics]))}, (plain, plain_c)


def host_ms(fn, iters: int = 7) -> float:
    """Median host-clock time of ``fn()`` (ending in a synchronize) over
    ``iters`` runs, after one warm-up run."""
    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def wire_timings(model) -> dict:
    """Encode and decode of one CNN model's payload (params on the card;
    a decode is ``build_copy(params=bytes)``, the upload included):
    ms and MB/s of the params' 2,180,392 bytes."""
    out = {}
    for label, fmt, codec in (("v1", 1, "dense"), ("v3", 3, "dense"), ("v2 quant8", 3, "quant8")):
        with setting("WIRE_FORMAT", fmt), setting("WIRE_CODEC", codec):
            payload = model.encode_parameters()
            enc = host_ms(model.encode_parameters)
        dec = host_ms(lambda p=payload: model.build_copy(params=p))
        out[label] = {"bytes": len(payload), "encode_ms": enc, "decode_ms": dec,
                      "encode_mb_s": CNN_PARAM_BYTES / enc / 1e3,
                      "decode_mb_s": CNN_PARAM_BYTES / dec / 1e3}
    return out


def protocol_reference_phase() -> float:
    """One small f32 learner fit (narrow CNN through the kernels, two
    fits) on the card against the same fit on the CPU: rtol 1e-3, atol
    1e-4, TF32 off. Returns max |err|."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y, xt, yt = synthetic_classification((8, 8, 3), n_train=40, n_test=13, seed=3)
    out = {}
    for dev in ("cuda", "cpu"):
        module = CNN(channels=(4, 8), dense=16, compute_dtype=torch.float32, conv_impl="pallas")
        model = TpflModel(module, init_params(module, (8, 8, 3), seed=0, device=dev), device=dev)
        learner = TorchLearner(model, TpflDataset.from_arrays(x, y, xt, yt), addr="node-0",
                               learning_rate=0.05, batch_size=8, device=dev)
        for _ in range(2):
            model = learner.fit()
        out[dev] = {p: v.cpu() for p, v in tree_items(model.get_parameters())}
    for path, want in out["cpu"].items():
        torch.testing.assert_close(out["cuda"][path], want, rtol=1e-3, atol=1e-4,
                                   msg=lambda m, p=path: f"protocol reference: {p}: {m}")
    return max((out["cuda"][p] - out["cpu"][p]).abs().max().item() for p in out["cpu"])


def protocol_kernel_check() -> dict:
    """conv_dw and conv_dx at the protocol learners' shapes (both CNN
    layers at one node of ``P_BATCH`` bf16 images: fewer images than the
    card has SMs) through :func:`check_dw_case` / :func:`check_dx_case`:
    each on its wgmma kernel, at the kernel phase's tolerances. Returns
    {case: max |err| / max |ref|}."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for name, h, w, cin, cout, dx_needed in LAYERS:
        case = (cin, cout, (h, w), P_BATCH, 1)
        out[f"conv_dw[{name} B={P_BATCH} N=1]"] = check_dw_case(*case, gen)
        if dx_needed:
            out[f"conv_dx[{name} B={P_BATCH} N=1]"] = check_dx_case(*case, gen)
    return out


def protocol_path(card: str) -> tuple[dict, object]:
    """The FedAvg round (a warm-up round, then the timed one), the same
    round under ``WIRE_CODEC="quant8"``, under SCAFFOLD (lr 0.02) and
    under FedProx; the wire timings of one fitted model; before them,
    the conv kernels at the learners' shapes against their plain
    versions. Returns the results and a FedAvg learner (for a profiled
    fit)."""
    out = {"kernels at one node (max |err| / max |ref|)": protocol_kernel_check()}
    for label, codec, aggregator, lr in P_ROUNDS:
        learners, agg, params = protocol_learners(aggregator, lr)
        with setting("WIRE_CODEC", codec):
            _, state = protocol_round(label, learners, agg, (params, None))  # warm-up, checked
            result, _ = protocol_round(label, learners, agg, state)
        out[label] = {"card": card, "wire_codec": codec, "aggregator": aggregator,
                      "learning_rate": lr, "nodes": P_NODES, "samples_per_fit": P_TRAIN,
                      **result}
        if label == "fedavg":
            out["wire"] = {"card": card, **wire_timings(learners[1].get_model())}
            profile_learner = learners[1]
    return out, profile_learner


# ---- the Byzantine robustness slice -------------------------------------------

# The bench's byzantine tier recipe (bench.py:2780-2870) at the CNN cell's
# width, without the node runtime: 10 TorchLearners (the full-width CNN
# through the conv kernels at N = 1, bf16 compute), 512 seeded synthetic
# CIFAR-shaped samples each (4 batches of 128) and 256 test samples, lr
# 0.1, 1 epoch, split by RandomIIDPartitionStrategy; 20% sign-flip + 20%
# additive-noise adversaries from one seeded AttackPlan. Node 0 opens the
# ledger round on the round-start params and folds the wire-decoded
# models. A warm-up round, then B_ROUNDS timed ones.
B_NODES, B_TRAIN, B_TEST, B_ROUNDS, B_SEED = 10, 512, 256, 4, 4242
B_ADDRS = [f"node-{i}" for i in range(B_NODES)]
# (label, aggregator factory, QUARANTINE_ENABLED and LEDGER_ENABLED)
B_ARMS = [
    ("fedavg", lambda: FedAvg("node-0", device="cuda"), False),
    ("fedavg+quarantine", lambda: FedAvg("node-0", device="cuda"), True),
    ("fedavg+quarantine (again)", lambda: FedAvg("node-0", device="cuda"), True),
    ("krum", lambda: Krum("node-0", n_byzantine=3, device="cuda"), False),
    ("multikrum+quarantine", lambda: MultiKrum("node-0", n_byzantine=3, m=6, device="cuda"),
     True),
    ("trimmedmean+quarantine", lambda: TrimmedMean("node-0", trim=2, device="cuda"), True),
]


def byzantine_plan() -> AttackPlan:
    return AttackPlan({1: AttackSpec("sign_flip"), 4: AttackSpec("sign_flip"),
                       6: AttackSpec("additive_noise", std=0.1),
                       8: AttackSpec("additive_noise", std=0.1)}, seed=B_SEED)


class Peer:
    """What ``apply_attack_plan`` wraps: an address and a learner."""

    def __init__(self, addr: str, learner) -> None:
        self.addr, self.learner = addr, learner


def byzantine_peers(parts: list) -> list:
    """``B_NODES`` learners on the card from the same seed-0 params, the
    plan's adversaries wrapped by ``apply_attack_plan``."""
    module = CNN(out_channels=10, conv_impl="pallas")
    params = init_params(module, (32, 32, 3), seed=0, device="cuda")
    peers = [Peer(addr, TorchLearner(TpflModel(module, params, device="cuda"), parts[i],
                                     addr=addr, learning_rate=0.1, batch_size=P_BATCH,
                                     device="cuda"))
             for i, addr in enumerate(B_ADDRS)]
    truth = apply_attack_plan(peers, byzantine_plan())
    if truth != byzantine_plan().adversary_map(B_ADDRS) or len(truth) != 4:
        raise AssertionError(f"byzantine: adversary map {truth}")
    return peers


def plain_robust(label: str, kept: list) -> tuple[dict, "int | None"]:
    """The aggregate of the decoded models ``kept`` (in intake order) by
    plain torch in f64 on the card: Krum's pick (an index into ``kept``),
    MultiKrum's sample-weighted mean of the 6 best, the trimmed mean, or
    FedAvg's sample-weighted mean. Returns (params by path, {} for Krum;
    Krum's index or None)."""
    trees = [dict(tree_items(m.get_parameters())) for m in kept]
    paths = sorted(trees[0])
    w = torch.tensor([float(m.get_num_samples()) for m in kept], dtype=torch.float64,
                     device="cuda")
    if label.startswith(("krum", "multikrum")):
        flat = torch.stack([torch.cat([t[p].double().reshape(-1) for p in paths])
                            for t in trees])
        d2 = ((flat[:, None, :] - flat[None, :, :]) ** 2).sum(-1)
        d2.fill_diagonal_(float("inf"))
        scores = torch.sort(d2, dim=1).values[:, :max(len(kept) - 3 - 2, 1)].sum(1)
        if label == "krum":
            return {}, int(torch.argmin(scores))
        sel = sorted(int(i) for i in torch.argsort(scores, stable=True)[:6])
        w, trees = w[sel], [trees[i] for i in sel]
    if label.startswith("trimmedmean"):
        trim = 2 if len(kept) > 4 else 0
        return {p: torch.sort(torch.stack([t[p].double() for t in trees]), dim=0).values[
            trim:len(kept) - trim].mean(0) for p in paths}, None
    return {p: torch.tensordot(w, torch.stack([t[p].double() for t in trees]), dims=1) / w.sum()
            for p in paths}, None


def check_plain_robust(what: str, label: str, kept: list, out) -> None:
    """Hold the aggregate ``out`` of the decoded models ``kept`` to
    :func:`plain_robust`: Krum's aggregate must be the plain pick bit
    for bit, the others within rtol 1e-6, atol 1e-7; all finite."""
    plain, best = plain_robust(label, kept)
    got = dict(tree_items(out.get_parameters()))
    if best is not None:
        pick = dict(tree_items(kept[best].get_parameters()))
        if any(not torch.equal(got[p], pick[p]) for p in pick):
            raise AssertionError(f"byzantine {what}: the aggregate is not candidate {best}, "
                                 "the plain f64 scoring's pick")
    for path, ref in plain.items():
        torch.testing.assert_close(got[path].double(), ref, rtol=1e-6, atol=1e-7,
                                   msg=lambda m, p=path: f"byzantine {what}: {p}: {m}")
    if not all(torch.isfinite(v).all() for v in got.values()):
        raise AssertionError(f"byzantine {what}: aggregate not finite")


def byzantine_round(label: str, peers: list, agg, rnd: int) -> dict:
    """One round: node 0 opens the ledger round on the round-start
    params, every learner fits (an adversary poisons after its fit), each
    model is v3-encoded and rebuilt from the bytes at node 0, which folds
    them; the aggregate, held to :func:`plain_robust` over the models the
    defense kept, goes back to every learner as bytes. The conv launch
    counts are set to 0 just before the fits and read after them."""
    node0 = peers[0].learner
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start = tree_map(lambda v: v.clone(), node0.get_model().get_parameters())
    ledger.contrib.open_round("node-0", rnd, start)
    reset_launches()
    models = [p.learner.fit() for p in peers]
    launches, wgmma = read_launches(), read_wgmma_launches(("conv_dw", "conv_dx"))
    decoded = [node0.get_model().build_copy(params=m.encode_parameters()) for m in models]
    agg.set_nodes_to_aggregate(B_ADDRS)
    for m in decoded:
        agg.add_model(m)
    out = agg.wait_and_get_aggregation(timeout=60)
    excluded = agg.quarantined_peers()
    agg.clear()
    broadcast = out.encode_parameters()
    for p in peers:
        p.learner.set_model(broadcast)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    steps = B_NODES * (B_TRAIN // P_BATCH)
    want = {**dict.fromkeys(WRAPPERS, 0), "conv_dw": 2 * steps, "conv_dx": steps}
    if launches != want:
        raise AssertionError(f"byzantine {label}: kernel launches {launches}, expected {want}")
    check_all_wgmma(f"byzantine round ({label})", launches, wgmma)
    if out.get_contributors() != B_ADDRS:
        raise AssertionError(f"byzantine {label}: contributors {out.get_contributors()}")
    kept = [m for m in decoded if m.get_contributors()[0] not in excluded]
    check_plain_robust(label, label, kept, out)
    return {"wall_ms": wall_ms, "kept": len(kept), "launches": launches, "wgmma": wgmma,
            "decoded": decoded, "start": start}


def byzantine_arm(label: str, make_agg, defend: bool, parts: list) -> dict:
    """A warm-up round and ``B_ROUNDS`` timed ones of one arm; the
    honest learners' mean test accuracy after them; for a defended arm
    the ledger's detections and the replayed quarantine set, both held
    to the plan's adversaries."""
    ledger.contrib.reset()
    with setting("QUARANTINE_ENABLED", defend), setting("LEDGER_ENABLED", defend):
        peers = byzantine_peers(parts)
        agg = make_agg()
        agg.set_quarantine(quarantine.QuarantineEngine("node-0"))
        rounds = [byzantine_round(label, peers, agg, r) for r in range(1 + B_ROUNDS)]
        truth = set(byzantine_plan().adversary_map(B_ADDRS))
        honest = [p.learner.evaluate()["test_metric"] for p in peers if p.addr not in truth]
        out = {"round_ms": statistics.mean(r["wall_ms"] for r in rounds[1:]),
               "round_ms_each": [r["wall_ms"] for r in rounds[1:]],
               "kept_per_round": [r["kept"] for r in rounds],
               "honest_mean_test_acc": float(np.mean(honest)),
               "launches_per_round": {k: rounds[-1]["launches"][k]
                                      for k in ("conv_dw", "conv_dx")},
               "wgmma_launches_per_round": rounds[-1]["wgmma"]}
        if defend:
            det = ledger.contrib.detections()
            flagged = set(det["flagged"])
            hits = len(flagged & truth)
            out["precision"] = hits / max(len(flagged), 1)
            out["recall"] = hits / len(truth)
            replay = quarantine.replay_decisions()
            quarantined = quarantine.quarantined_from_replay(replay)
            if out["precision"] != 1.0 or out["recall"] != 1.0 or quarantined != truth:
                raise AssertionError(f"byzantine {label}: flagged {sorted(flagged)}, "
                                     f"quarantined {sorted(quarantined)}, planned {sorted(truth)}")
            out["_replay"] = [(a["peer"], a["round"], a["action"], tuple(a["reasons"]))
                              for a in replay]
            out["_entries"] = json.dumps(det["entries"], sort_keys=True)
        out["_last"] = rounds[-1]

    def one_more_round() -> dict:
        with setting("QUARANTINE_ENABLED", defend), setting("LEDGER_ENABLED", defend):
            return byzantine_round(label, peers, agg, 1 + B_ROUNDS)

    out["_one_more_round"] = one_more_round
    return out


def byzantine_timings(last: dict) -> dict:
    """On one round's decoded CNN models: ``score_now`` per contribution
    (a fresh ledger round each time, so that it computes), ``finalize`` of
    each robust aggregator over the 10 models (the streams filled
    untimed; every aggregate held to :func:`plain_robust` over all 10,
    adversaries included, so that Krum's and MultiKrum's selection runs
    here even where quarantine leaves them nothing to select), and
    ``AttackPlan.poison`` of one additive-noise model."""
    decoded, start = last["decoded"], last["start"]

    def score_all():
        ledger.contrib.reset()
        ledger.contrib.open_round("timing", 0, start)
        for m in decoded:
            ledger.contrib.score_now("timing", m)

    with setting("QUARANTINE_ENABLED", True):
        score_ms = host_ms(score_all) / len(decoded)
    ledger.contrib.reset()
    finalize_ms = {}
    for name, agg in (("krum", Krum("t", n_byzantine=3, device="cuda")),
                      ("multikrum", MultiKrum("t", n_byzantine=3, m=6, device="cuda")),
                      ("trimmedmean", TrimmedMean("t", trim=2, device="cuda"))):
        times = []
        for _ in range(6):
            st = agg.acc_init(decoded[0])
            for m in decoded:
                st = agg.accumulate(st, m)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = agg.finalize(st)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        finalize_ms[name] = statistics.median(times[1:])
        check_plain_robust(f"{name} over all {len(decoded)} models", name, decoded, out)
    plan = byzantine_plan()
    spec = plan.spec_for(B_ADDRS[6], 6)
    params = decoded[6].get_parameters()
    poison_ms = host_ms(lambda: plan.poison(B_ADDRS[6], 3, spec, params))
    return {"score_now_ms_per_contribution": score_ms,
            "finalize_ms_over_10_models": finalize_ms,
            "poison_ms_additive_noise_one_model": poison_ms}


def byzantine_protocol_path(card: str) -> tuple[dict, object]:
    """Every arm of ``B_ARMS``; the two defended FedAvg runs must give the
    same (peer, round, action, reasons) replay. Returns the results and
    a function that runs one more round of the defended FedAvg arm (for
    a profiled round)."""
    x, y, xt, yt = synthetic_cifar10(n_train=B_NODES * B_TRAIN, n_test=B_NODES * B_TEST,
                                     seed=B_SEED)
    parts = TpflDataset.from_arrays(x, y, xt, yt).generate_partitions(
        B_NODES, RandomIIDPartitionStrategy, seed=B_SEED)
    if any(p.num_samples() != B_TRAIN or p.num_samples(False) != B_TEST for p in parts):
        raise AssertionError("byzantine: partitions of the wrong size")
    out = {label: byzantine_arm(label, make_agg, defend, parts)
           for label, make_agg, defend in B_ARMS}
    first, again = out["fedavg+quarantine"], out["fedavg+quarantine (again)"]
    if first["_replay"] != again["_replay"]:
        raise AssertionError("byzantine: the two defended FedAvg runs replay differently")
    result = {"card": card, "nodes": B_NODES, "samples_per_fit": B_TRAIN,
              "timed_rounds": B_ROUNDS,
              "adversaries": byzantine_plan().adversary_map(B_ADDRS),
              "defended_replays_equal": True,
              "defended_float_fields_byte_equal": first["_entries"] == again["_entries"],
              **byzantine_timings(out["trimmedmean+quarantine"]["_last"])}
    for label, arm in out.items():
        result[label] = {k: v for k, v in arm.items() if not k.startswith("_")}
    return result, again["_one_more_round"]


def byzantine_engine_reference_phase() -> dict:
    """``attack_scales`` ([R, n] from a plan's ``engine_scales``) in the
    small f32 CNN window through the kernels, on the card against the
    CPU: a trained dense window and a ``quant8`` aggregation-only one,
    rtol 1e-3, atol 1e-4 (TF32 off). Returns {case: max |err|}."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    plan = AttackPlan({1: AttackSpec("sign_flip"),
                       2: AttackSpec("sign_flip", mode="ramp", ramp_rounds=2)}, seed=B_SEED)
    scales = plan.engine_scales(["node-0", "node-1", "node-2"], 2)
    out = {}
    for codec, epochs in (("dense", 1), ("quant8", 0)):
        with setting("ENGINE_WIRE_CODEC", codec):
            card, cpu = (small_window(dev, "cnn", epochs=epochs, attack_scales=scales)
                         for dev in ("cuda", "cpu"))
        for path in cpu:
            torch.testing.assert_close(card[path], cpu[path], rtol=1e-3, atol=1e-4,
                                       msg=lambda m, p=path: f"attack_scales {codec}: {p}: {m}")
        out[codec] = max((card[p] - cpu[p]).abs().max().item() for p in cpu)
    return out


def attacked_cnn_path(card: str) -> dict:
    """The 100-node CNN window through the kernels under a sign-flip plan
    on every fifth node (``engine_scales`` → ``attack_scales``): first
    all-ones scales against no scales over a 3-round window from the
    same params (bit for bit), then a warm-up round and a timed 3-round
    window: 8 conv_dw and 4 conv_dx launches a round, all on wgmma,
    finite losses, one aggregate on every node."""
    eng = FederationEngine(CNN(out_channels=10, conv_impl="pallas"), N_NODES,
                           learning_rate=0.1, seed=0, device="cuda")
    xs, ys = cnn_data(eng)
    params = eng.init_params((32, 32, 3))
    plan = AttackPlan({i: AttackSpec("sign_flip") for i in range(0, N_NODES, 5)}, seed=B_SEED)
    scales = plan.engine_scales([f"node-{i}" for i in range(N_NODES)], N_ROUNDS)
    # Both windows and the warm-up start from ``params``: neither donates it.
    plain, _ = eng.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=N_ROUNDS, donate=False)
    ones, _ = eng.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=N_ROUNDS,
                             attack_scales=np.ones_like(scales), donate=False)
    if not all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(plain),
                                                           tree_items(ones))):
        raise AssertionError("attacked CNN: all-ones scales changed the window's params")
    params, _ = eng.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=1,
                               attack_scales=scales[0])  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    params, losses = eng.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=N_ROUNDS,
                                    attack_scales=scales)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, wgmma = read_launches(), read_wgmma_launches(("conv_dw", "conv_dx"))
    steps = N_BATCHES * EPOCHS * N_ROUNDS
    check_main_path(params, losses, launches, {
        **dict.fromkeys(WRAPPERS, 0), "conv_dw": 2 * steps, "conv_dx": steps})
    check_all_wgmma("attacked CNN round", launches, wgmma)
    return {**cnn_result(card, "pallas", wall, losses), "adversaries": len(plan.peers),
            "ones_bit_identical": True, "launches": launches, "wgmma_launches": wgmma}


# ---- the node runtime: a federation of Nodes over the in-memory transport ----

# The CNN cell's model (channels 32/64, dense 128, 10 classes, 32×32×3, bf16,
# the kernels at N = 1) in FedAvg federations of Nodes on the card:
# InMemoryCommunicationProtocol, Settings.set_test_settings() with the
# pooled simulation learner off, each node 512 seeded synthetic
# CIFAR-shaped samples (4 batches of 128) and 256 test samples, 1 epoch.
# (label, nodes, topology, rounds, TRAIN_SET_SIZE, warm-up experiment)
F_TRAIN, F_TEST, F_BATCH = 512, 256, 128
F_RUNS = [("4 nodes, LINE", 4, "LINE", 3, 4, True),
          ("6 nodes, FULL, train set 4", 6, "FULL", 2, 4, False)]


def _experiment_round(addr: str) -> int:
    """The round a node's running experiment is in (its logger record)."""
    return logger.get_nodes()[addr]["experiment"].round


class RecordingLearner(TorchLearner):
    """A ``TorchLearner`` that keeps, by experiment round, a device copy of
    each fit's params and its sample count (the plain reference's inputs,
    widened to f64 only when checked, after the timed window), and counts
    the wire payloads it adopts (init and full models)."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.fits: dict[int, tuple[dict, int]] = {}
        self.decodes = 0

    def set_model(self, model) -> None:
        self.decodes += isinstance(model, bytes)
        super().set_model(model)

    def fit(self):
        model = super().fit()
        self.fits[_experiment_round(self.get_addr())] = (
            {p: v.detach().clone() for p, v in tree_items(model.get_parameters())},
            model.get_num_samples())
        return model


class RecordingFedAvg(FedAvg):
    """FedAvg that keeps, by experiment round, each aggregate it closes,
    and counts the peers' models it takes in (each decoded from a wire
    payload)."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.closed: dict[int, dict] = {}
        self.decodes = 0

    def add_model(self, model, trace: str = "", start_version=None) -> list:
        self.decodes += model.get_contributors() != [self.node_name]
        return super().add_model(model, trace=trace, start_version=start_version)

    def wait_and_get_aggregation(self, timeout=None):
        out = super().wait_and_get_aggregation(timeout=timeout)
        self.closed[_experiment_round(self.node_name)] = {
            p: v.clone() for p, v in tree_items(out.get_parameters())}
        return out


class TimedNode(Node):
    """A ``Node`` that stamps ``perf_counter`` when its stage workflow
    returns, so an experiment's wall ends when its last workflow does
    (not at ``wait_to_finish``'s next 0.1 s poll)."""

    finished_at = 0.0

    def _run_workflow(self) -> None:
        super()._run_workflow()
        self.finished_at = time.perf_counter()


@contextlib.contextmanager
def runtime_settings(**knobs):
    """The test profile, the pooled simulation learner off, the logger at
    ERROR, and ``knobs``; every setting restored after. Inline fits are
    the default here because phases 11-17 are the N = 1 cells: each
    Node's learner fits on its own, the conv kernels at one node. Phase 18
    passes ``DISABLE_SIMULATION=False``: the reference's default, pooled
    path."""
    snap = Settings.snapshot()
    level = logger.get_level()
    Settings.set_test_settings()
    Settings.DISABLE_SIMULATION = True
    for name, value in knobs.items():
        setattr(Settings, name, value)
    logger.set_level("ERROR")
    try:
        yield
    finally:
        Settings.restore(snap)
        logger.set_level(level)


def start_federation(nodes: list, topology: str) -> None:
    for nd in nodes:
        nd.start()
    matrix = TopologyFactory.generate_matrix(TopologyType[topology], len(nodes))
    TopologyFactory.connect_nodes(matrix, nodes)
    wait_convergence(nodes, len(nodes) - 1, only_direct=False, wait=30)


def check_history(label: str, nodes: list, rounds: int) -> None:
    """Every node's complete stage history: ``1 + 4 × rounds`` stages in
    the reference's pattern (a crashed stage ends a workflow early)."""
    for nd in nodes:
        h = nd.learning_workflow.history
        ok = len(h) == 1 + 4 * rounds and h[0] == "StartLearningStage" and all(
            h[1 + 4 * r:5 + 4 * r][0] == "VoteTrainSetStage"
            and h[1 + 4 * r:5 + 4 * r][1] in ("TrainStage", "WaitAggregatedModelsStage")
            and h[1 + 4 * r:5 + 4 * r][2:] == ["GossipModelStage", "RoundFinishedStage"]
            for r in range(rounds))
        if not ok:
            raise AssertionError(f"federation {label}: {nd.addr} stage history {h}")


def run_experiment(nodes: list, rounds: int) -> tuple[str, float]:
    """One experiment started at node 0, to its end; (name, wall s). The
    wall of :class:`TimedNode`s ends when the last workflow returned."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp = nodes[0].set_start_learning(rounds=rounds, epochs=1)
    wait_to_finish(nodes, timeout=600)
    torch.cuda.synchronize()
    end = max((getattr(nd, "finished_at", 0.0) for nd in nodes), default=0.0)
    return exp, (end if end > t0 else time.perf_counter()) - t0


def federation_reference_phase() -> float:
    """A 2-node LINE federation of a narrow f32 CNN through the conv
    kernels (``conv_impl="pallas"``, TF32 off), 2 rounds, on the card and
    then on the CPU with the same addresses, seeds and data: final params
    within rtol 1e-3, atol 1e-4; every card launch counted (2 rounds × 2
    trainers × 4 steps: 32 ``conv_dw``, 16 ``conv_dx``, none on wgmma: the
    rule takes bf16 only), none on the CPU. Returns max |err|."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y, xt, yt = synthetic_classification((8, 8, 3), n_train=128, n_test=32, seed=3)
    parts = TpflDataset.from_arrays(x, y, xt, yt).generate_partitions(
        2, RandomIIDPartitionStrategy, seed=1)
    out = {}
    for dev in ("cuda", "cpu"):
        module = CNN(channels=(4, 8), dense=16, compute_dtype=torch.float32, conv_impl="pallas")
        params = init_params(module, (8, 8, 3), seed=0, device=dev)
        with runtime_settings():
            nodes = [Node(TpflModel(module, params, device=dev), parts[i], addr=f"fref-{i}",
                          device=dev, learning_rate=0.05, batch_size=16) for i in range(2)]
            try:
                start_federation(nodes, "LINE")
                reset_launches()
                run_experiment(nodes, 2)
                launches = read_launches()
                wgmma = read_wgmma_launches(("conv_dw", "conv_dx"))
                check_history("reference", nodes, 2)
            finally:
                for nd in nodes:
                    nd.stop()
        want = {**dict.fromkeys(WRAPPERS, 0),
                **({"conv_dw": 32, "conv_dx": 16} if dev == "cuda" else {})}
        if launches != want or any(wgmma.values()):
            raise AssertionError(f"federation reference ({dev}): launches {launches}, "
                                 f"wgmma {wgmma}, expected {want} and no wgmma")
        out[dev] = [{p: v.cpu() for p, v in tree_items(nd.learner.get_model().get_parameters())}
                    for nd in nodes]
    for i, want in enumerate(out["cpu"]):
        for path, ref in want.items():
            torch.testing.assert_close(out["cuda"][i][path], ref, rtol=1e-3, atol=1e-4,
                                       msg=lambda m, p=path: f"federation reference: {p}: {m}")
    return max((a[p] - b[p]).abs().max().item()
               for a, b in zip(out["cuda"], out["cpu"]) for p in b)


def check_round_aggregates(label: str, nodes: list, rounds: int) -> float:
    """Each aggregate a node closed, per round, within rtol 1e-6, atol
    1e-7 of the plain f64 sample-weighted mean of that round's fitted
    models; at least one node closes every round. Returns the worst
    max |err|."""
    worst = 0.0
    for r in range(rounds):
        fits = [({p: v.double() for p, v in f.items()}, n)
                for f, n in (nd.learner.fits[r] for nd in nodes if r in nd.learner.fits)]
        w = torch.tensor([float(n) for _, n in fits], dtype=torch.float64, device="cuda")
        plain = {p: torch.tensordot(w, torch.stack([f[p] for f, _ in fits]), dims=1) / w.sum()
                 for p in fits[0][0]}
        closed = [nd.aggregator.closed[r] for nd in nodes if r in nd.aggregator.closed]
        if not closed or len(fits) != Settings.TRAIN_SET_SIZE:
            raise AssertionError(f"federation {label} round {r}: {len(fits)} fits, "
                                 f"{len(closed)} aggregates closed")
        for agg in closed:
            for path, ref in plain.items():
                torch.testing.assert_close(
                    agg[path].double(), ref, rtol=1e-6, atol=1e-7,
                    msg=lambda m, p=path: f"federation {label} round {r}: {p}: {m}")
                worst = max(worst, (agg[path].double() - ref).abs().max().item())
    return worst


def check_final_models(label: str, nodes: list, rounds: int) -> tuple[float, int]:
    """Every node's final params finite and byte-equal to an aggregate
    that some node closed in the last round (its own, or one it adopted
    as a FullModel), and all within rtol 1e-6, atol 1e-7 of node 0's: the
    trainers fold partial aggregates, grouped as they arrived, so two
    closed aggregates may differ in their last bits. Returns (max |diff|
    from node 0's, the count of distinct final models)."""
    finals = [dict(tree_items(nd.learner.get_model().get_parameters())) for nd in nodes]
    closed = [nd.aggregator.closed[rounds - 1] for nd in nodes
              if rounds - 1 in nd.aggregator.closed]
    distinct: list[dict] = []
    for nd, final in zip(nodes, finals):
        if not all(torch.isfinite(v).all() for v in final.values()):
            raise AssertionError(f"federation {label}: {nd.addr} holds non-finite params")
        if not any(all(torch.equal(final[p], agg[p]) for p in agg) for agg in closed):
            raise AssertionError(f"federation {label}: {nd.addr} holds no closed aggregate")
        if not any(all(torch.equal(final[p], d[p]) for p in d) for d in distinct):
            distinct.append(final)
        for path, v in final.items():
            torch.testing.assert_close(v, finals[0][path], rtol=1e-6, atol=1e-7,
                                       msg=lambda m, p=path: f"federation {label}: {p}: {m}")
    spread = max((f[p] - finals[0][p]).abs().max().item() for f in finals for p in f)
    return spread, len(distinct)


def payload_bytes(nodes: list) -> float:
    """Wire payload bytes the nodes' transports encoded so far."""
    return sum(logger.metrics.value("tpfl_payload_bytes_total", {"node": nd.addr})
               for nd in nodes)


def round_split(nodes: list) -> dict:
    """Mean seconds a round per component of the round profiler, over
    every node and round of the experiment."""
    recs = [r for nd in nodes for r in profiling.rounds.attribution(nd.addr)]
    # The pool's batched fits add a "dispatch" part (enqueue) beside "train".
    parts = list(profiling.COMPONENTS) + sorted(
        {c for r in recs for c in r["parts"]} - set(profiling.COMPONENTS))
    split = {c: statistics.mean(r["parts"].get(c, 0.0) for r in recs) for c in parts}
    return {"records": len(recs), "wall_s": statistics.mean(r["wall"] for r in recs),
            **{f"{c}_s": v for c, v in split.items()}}


def federation_run(card: str, label: str, n: int, topology: str, rounds: int,
                   train_set: int, warm_up: bool) -> tuple[dict, object]:
    """One timed experiment of ``n`` Nodes (after a 1-round warm-up
    experiment when ``warm_up``): complete stage histories, each node's
    params one of the last round's closed aggregates
    (:func:`check_final_models`), finite losses, exactly ``rounds ×
    train_set × 8`` ``conv_dw`` and ``× 4`` ``conv_dx`` launches, all on
    wgmma, and each round's aggregates held to plain f64. Returns the
    results and (a function that runs one more experiment, for a
    profiled one; a function that stops the nodes)."""
    x, y, xt, yt = synthetic_cifar10(n_train=n * F_TRAIN, n_test=n * F_TEST, seed=1100 + n)
    parts = TpflDataset.from_arrays(x, y, xt, yt).generate_partitions(
        n, RandomIIDPartitionStrategy, seed=1)
    module = CNN(out_channels=10, conv_impl="pallas")
    params = init_params(module, (32, 32, 3), seed=0, device="cuda")
    with runtime_settings(TRAIN_SET_SIZE=train_set):
        nodes = [TimedNode(TpflModel(module, params, device="cuda"), parts[i],
                           addr=f"fed{n}-{i}", learner=RecordingLearner,
                           aggregator=RecordingFedAvg(device="cuda"), device="cuda",
                           learning_rate=0.1, batch_size=F_BATCH) for i in range(n)]
        try:
            start_federation(nodes, topology)
            if warm_up:
                run_experiment(nodes, 1)
            for nd in nodes:
                nd.learner.fits.clear()
                nd.aggregator.closed.clear()
                nd.learner.decodes = nd.aggregator.decodes = 0
            sent_bytes = payload_bytes(nodes)
            profiling.rounds.reset()
            reset_launches()
            with setting("PROFILING_ENABLED", True):
                exp, wall = run_experiment(nodes, rounds)
            launches = read_launches()
            wgmma = read_wgmma_launches(("conv_dw", "conv_dx"))
            check_history(label, nodes, rounds)
            steps = rounds * train_set * (F_TRAIN // F_BATCH)
            want = {**dict.fromkeys(WRAPPERS, 0), "conv_dw": 2 * steps, "conv_dx": steps}
            if launches != want:
                raise AssertionError(f"federation {label}: launches {launches}, expected {want}")
            check_all_wgmma(f"federation ({label})", launches, wgmma)
            spread, distinct = check_final_models(label, nodes, rounds)
            local = logger.get_local_logs()[exp]
            losses = [v for r in local.values() for m in r.values()
                      for v in (s for _, s in m.get("train_loss", []))]
            waited = sum(nd.learning_workflow.history.count("WaitAggregatedModelsStage")
                         for nd in nodes)
            if (len(losses) != rounds * train_set or not np.all(np.isfinite(losses))
                    or waited != (n - train_set) * rounds):
                raise AssertionError(f"federation {label}: losses {losses}, waited {waited}")
            agg_err = check_round_aggregates(label, nodes, rounds)
            accs = [nd.learner.evaluate()["test_metric"] for nd in nodes]
            model = nodes[0].learner.get_model()
            payload = model.encode_parameters()
            wire = {"payload_bytes": len(payload),
                    "payload_bytes_encoded": payload_bytes(nodes) - sent_bytes,
                    "payloads_encoded": round((payload_bytes(nodes) - sent_bytes) / len(payload)),
                    "payloads_decoded": sum(nd.learner.decodes + nd.aggregator.decodes
                                            for nd in nodes),
                    "encode_ms": host_ms(model.encode_parameters),
                    "decode_ms": host_ms(lambda: model.build_copy(params=payload))}
            result = {"card": card, "nodes": n, "topology": topology, "rounds": rounds,
                      "train_set_size": train_set, "samples_per_fit": F_TRAIN,
                      "experiment_wall_s": wall, "rounds_per_s": rounds / wall,
                      "launches": {k: launches[k] for k in ("conv_dw", "conv_dx")},
                      "wgmma_launches": wgmma, "waited_stages": waited,
                      "distinct_final_models": distinct, "final_models_max_abs_diff": spread,
                      "aggregate_max_abs_err_vs_f64": agg_err,
                      "mean_train_loss_last_round": float(np.mean(
                          [s for m in local[rounds - 1].values()
                           for _, s in m.get("train_loss", [])])),
                      "mean_test_acc": float(np.mean(accs)),
                      "round_split": round_split(nodes), "wire": wire}
        except BaseException:
            for nd in nodes:
                nd.stop()
            raise

    def one_more_experiment() -> None:
        with runtime_settings(TRAIN_SET_SIZE=train_set):
            run_experiment(nodes, rounds)

    def stop() -> None:
        with runtime_settings():
            for nd in nodes:
                nd.stop()

    return result, (one_more_experiment, stop)


def federation_path(card: str) -> tuple[dict, list]:
    """Every run of ``F_RUNS``. Returns the results and, per run, (one
    more experiment, stop) for a profiled experiment."""
    out, handles = {}, []
    for label, *args in F_RUNS:
        out[label], h = federation_run(card, label, *args)
        handles.append(h)
    return out, handles


# --- phase 14: the Byzantine federation ----------------------------------
#
# The bench's byzantine tier (bench.py:2725-3066) at its own recipe, as
# federations of gossiping Nodes of the CNN cell's model through the
# port's harness: run_seeded_experiment(4242, n, 6, epochs=4,
# samples_per_node=200, batch_size=25, learning_rate=0.1, timeout=300),
# STAR, TRAIN_SET_SIZE = n, ELECTION = "hash", seeded synthetic
# CIFAR-shaped data (200 × n training and 1,200 test samples; no PIL on
# the card's machine), sign flips on nodes 1 and 4 and additive noise (std
# 0.1) on nodes 6 and 8. PHASE_DEVICE and PHASE_CNN name the device and
# the model the two phases run.
PHASE_DEVICE = "cuda"
PHASE_CNN = dict(out_channels=10, conv_impl="pallas")
# Phases 25 and 26 bought their time here too: 3 rounds (from 6 before
# phase 25, 4 before phase 26) in the arms that defend and in the ideal
# one they are compared with; 2 (BF_PLAIN_ROUNDS) in the ten-node arms
# that do not defend and in their pooled twins of phase 18a, whose gates
# (histories, launches, the nodes agreeing, the adversary map) do not
# depend on depth.
BF_SEED, BF_ROUNDS, BF_EPOCHS, BF_SAMPLES, BF_BATCH, BF_TEST = 4242, 3, 4, 200, 25, 1200
BF_PLAIN_ROUNDS = 2
BF_ADVERSARIES = (1, 4, 6, 8)
# The adversaries the defense flags at this cell in every run: the sign
# flips, by their cosine to the round's reference, whatever the window.
# The noise's update-norm z stays near 3, under LEDGER_ANOMALY_Z = 6, in
# the JAX package as in the port (byzantine_reference.py, on the CPU):
# the tier's std 0.1 was sized for its digits MLP. Beyond the sign flips
# the verdicts vary from run to run, as the reference's do: each node
# scores a contribution against its own ring (the first to score it, its
# trainer, sets the verdict for the process) and moves its own engine on
# what it assessed, so which singles a node happened to receive decides
# whether a noisy or an honest contribution crosses 6 at intake; nodes
# that excluded different sets end apart, their later contributions
# differ, and the deduped detections (scored against every round's
# entries) move with them. Gated: the sign flips detected, replayed and
# flagged at intake, with the same decisions with telemetry off and on;
# reported: every peer flagged, the decisions' byte equality and the
# nodes' spread (ROADMAP.md §3).
BF_DETECTED = (1, 4)
# The traced arm's flight ring: large enough that no node's ring evicts.
BF_RING = 200_000
# (label, attack, defend, aggregator factory, nodes, traced, rounds)
BF_ARMS = [
    ("fedavg, fault-free", False, False, None, 10, False, BF_PLAIN_ROUNDS),
    ("fedavg, adversary-free (6 honest nodes)", False, False, None, 6, False, BF_ROUNDS),
    ("fedavg, attacked", True, False, None, 10, False, BF_PLAIN_ROUNDS),
    ("fedavg+quarantine", True, True, None, 10, False, BF_ROUNDS),
    ("fedavg+quarantine, traced", True, True, None, 10, True, BF_ROUNDS),
    ("krum, fault-free", False, False,
     lambda: Krum(n_byzantine=3, device=PHASE_DEVICE), 10, False, BF_PLAIN_ROUNDS),
    ("krum, attacked", True, False, lambda: Krum(n_byzantine=3, device=PHASE_DEVICE), 10, False,
     BF_PLAIN_ROUNDS),
    ("multikrum+quarantine", True, True,
     lambda: MultiKrum(n_byzantine=3, m=6, device=PHASE_DEVICE), 10, False, BF_ROUNDS),
    ("trimmedmean+quarantine", True, True,
     lambda: TrimmedMean(trim=2, device=PHASE_DEVICE), 10, False, BF_ROUNDS),
]


def bf_plan() -> AttackPlan:
    return AttackPlan({1: AttackSpec("sign_flip"), 4: AttackSpec("sign_flip"),
                       6: AttackSpec("additive_noise", std=0.1),
                       8: AttackSpec("additive_noise", std=0.1)}, seed=BF_SEED)


def phase_model(seed: int) -> TpflModel:
    """The CNN cell's model (``PHASE_CNN``) from ``seed`` on the card."""
    module = CNN(**PHASE_CNN)
    return TpflModel(module, init_params(module, (32, 32, 3), seed=seed, device=PHASE_DEVICE),
                     device=PHASE_DEVICE)


def check_conv_launches(label: str, launches: dict, wgmma: dict, steps: "int | None") -> None:
    """Every conv launch on its wgmma kernel and, where ``steps`` is
    given, exactly 2 ``conv_dw`` and 1 ``conv_dx`` launches a step and no
    other kernel of the port."""
    if steps is not None:
        want = {**dict.fromkeys(WRAPPERS, 0), "conv_dw": 2 * steps, "conv_dx": steps}
        if launches != want:
            raise AssertionError(f"{label}: kernel launches {launches}, expected {want}")
    elif not launches["conv_dw"]:
        raise AssertionError(f"{label}: no conv_dw launch")
    check_all_wgmma(label, launches, wgmma)


class HarnessNode(TimedNode):
    """The Node the harness builds while a phase runs (swapped into
    ``tpfl_torch.attacks.harness`` by :func:`harness_nodes`): it registers
    itself, stamps the experiment's start, and keeps a device copy of
    its final params when it stops."""

    made: list = []
    started_at = 0.0
    final: "dict | None" = None

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        HarnessNode.made.append(self)

    def set_start_learning(self, *args, **kwargs):
        torch.cuda.synchronize()
        self.started_at = time.perf_counter()
        return super().set_start_learning(*args, **kwargs)

    def stop(self) -> None:
        if self.final is None:
            self.final = {p: v.detach().clone()
                          for p, v in tree_items(self.learner.get_model().get_parameters())}
        super().stop()


@contextlib.contextmanager
def harness_nodes():
    """The harness builds :class:`HarnessNode`s while this is open; yields
    the list they register in."""
    HarnessNode.made = []
    saved, harness.Node = harness.Node, HarnessNode
    try:
        yield HarnessNode.made
    finally:
        harness.Node = saved


def check_node_finals(label: str, nodes: list, agree: bool) -> float:
    """Every node's final params finite and, where ``agree``, within rtol
    1e-6, atol 1e-7 of node 0's. Returns the largest |difference| from
    node 0's."""
    finals = [nd.final for nd in nodes]
    for nd, final in zip(nodes, finals):
        if not all(torch.isfinite(v).all() for v in final.values()):
            raise AssertionError(f"{label}: {nd.addr} holds non-finite params")
        for path, v in final.items():
            if agree:
                torch.testing.assert_close(v, finals[0][path], rtol=1e-6, atol=1e-7,
                                           msg=lambda m, p=path: f"{label}: {p}: {m}")
    return max((f[p] - finals[0][p]).abs().max().item() for f in finals for p in f)


def hop_chains(entries: list) -> tuple[int, int]:
    """(traces with an encode, complete weights-hop chains) among flight
    entries: a chain is complete when its trace holds encode, send, recv
    and decode, and the decode is on another node than the encode."""
    by_trace: dict[str, list] = {}
    for e in entries:
        if e.get("trace"):
            by_trace.setdefault(e["trace"], []).append(e)
    encoded = complete = 0
    for chain in by_trace.values():
        names = {e["name"] for e in chain}
        enc = {e["node"] for e in chain if e["name"] == "encode"}
        dec = {e["node"] for e in chain if e["name"] == "decode"}
        encoded += bool(enc)
        complete += bool({"encode", "send", "recv", "decode"} <= names and dec - enc)
    return encoded, complete


def honest_acc(exp: str, adversaries) -> float:
    """The bench's honest accuracy: mean test accuracy over the honest
    nodes across the last two rounds."""
    table = metric_table(exp)
    vals = [v for node in sorted(table) if int(node.rsplit("n", 1)[1]) not in adversaries
            for _, v in table[node].get("test_metric", [])[-2:]]
    return float(sum(vals) / max(len(vals), 1))


def quorum_degradations() -> float:
    """Quorum degradations (live train-set members dropped as dead) the
    process registry has counted, over every node."""
    return sum(v for (name, _), v in logger.metrics.fold()["counters"].items()
               if name == "tpfl_agg_quorum_degraded_total")


def bf_arm(card: str, label: str, attack: bool, defend: bool, agg, n: int,
           dump_dir: "str | None", rounds: int) -> dict:
    """One arm: a seeded experiment of ``n`` Nodes and ``rounds`` rounds
    through the harness. Checks that the harness built ``n`` HarnessNodes,
    complete stage histories, exactly rounds × n × 4 × 8 steps' conv
    launches, all on wgmma,
    every node's final params finite and, without quarantine, within
    rtol 1e-6 of node 0's; with quarantine the sign flips
    (``BF_DETECTED``) in the ledger's detections, in the replayed
    quarantine set and flagged at intake (precision, recall, each
    adversary's z, every peer flagged and the nodes' spread reported);
    traced, a quarantine event in the dumps for each peer flagged at
    intake, contrib events and complete weights-hop chains."""
    ledger.contrib.reset()
    knobs = dict(QUARANTINE_ENABLED=defend, LEDGER_ENABLED=defend, TRAIN_SET_SIZE=n,
                 ELECTION="hash", PROFILING_ENABLED=True)
    if dump_dir is not None:
        knobs.update(TELEMETRY_ENABLED=True, TELEMETRY_DUMP_DIR=dump_dir,
                     TELEMETRY_RING=BF_RING)
    with runtime_settings(**knobs), harness_nodes() as nodes:
        profiling.rounds.reset()
        tracing.reset()
        telemetry.flight.clear()
        degraded = quorum_degradations()
        reset_launches()
        t0 = time.perf_counter()
        exp = run_seeded_experiment(
            BF_SEED, n, rounds, epochs=BF_EPOCHS, attack_plan=bf_plan() if attack else None,
            aggregator_factory=agg, model_fn=phase_model,
            data_fn=lambda s: TpflDataset.from_arrays(*synthetic_cifar10(
                n_train=BF_SAMPLES * n, n_test=BF_TEST, seed=s)),
            samples_per_node=BF_SAMPLES, batch_size=BF_BATCH, learning_rate=0.1,
            timeout=300.0, device=PHASE_DEVICE)
        torch.cuda.synchronize()
        call_wall = time.perf_counter() - t0
        launches = read_launches()
        wgmma = read_wgmma_launches(("conv_dw", "conv_dx"))
        split = round_split(nodes)
        degraded = quorum_degradations() - degraded
        replay = quarantine.replay_decisions() if defend else []
        detections = ledger.contrib.detections() if defend else {"flagged": {}, "entries": []}
        flagged = set(detections["flagged"])
        live = {e["peer"]: [e["round"], e["reasons"]]
                for e in sorted(ledger.contrib.entries(), key=lambda e: -e["round"])
                if defend and e["single"] and e["flagged"]}
        entries = tracing.export() if dump_dir is not None else []
        ring_max = max((len(telemetry.flight.snapshot(nd.addr)) for nd in nodes), default=0)
    tag = f"byzantine federation ({label})"
    if len(nodes) != n:
        raise AssertionError(f"{tag}: the harness built {len(nodes)} HarnessNodes, expected {n}")
    check_history(tag, nodes, rounds)
    check_conv_launches(tag, launches, wgmma,
                        rounds * n * BF_EPOCHS * (BF_SAMPLES // BF_BATCH))
    try:
        # With quarantine each node folds what its own engine admitted
        # (BF_DETECTED's comment): the spread is reported, not gated.
        spread = check_node_finals(tag, nodes, agree=not defend)
    except AssertionError as e:
        raise AssertionError(f"{e}\n({degraded:g} quorum degradations in the arm)") from None
    wall = max(nd.finished_at for nd in nodes) - nodes[0].started_at
    truth = set(adversary_map(exp))
    if truth != ({f"seed{BF_SEED}-n{i}" for i in BF_ADVERSARIES} if attack else set()):
        raise AssertionError(f"{tag}: adversary map {sorted(truth)}")
    out = {"card": card, "nodes": n, "rounds": rounds, "experiment_wall_s": wall,
           "rounds_per_s": rounds / wall, "harness_call_wall_s": call_wall,
           "honest_acc": honest_acc(exp, BF_ADVERSARIES),
           "launches": {k: launches[k] for k in ("conv_dw", "conv_dx")},
           "wgmma_launches": wgmma, "final_models_max_abs_diff": spread,
           "distinct_final_digests": len(set(final_model_digests(exp).values())),
           "quorum_degradations": degraded, "round_split": split}
    if defend:
        hits = len(flagged & truth)
        out["precision"] = hits / max(len(flagged), 1)
        out["recall"] = hits / max(len(truth), 1)
        quarantined = quarantine.quarantined_from_replay(replay)
        want = {f"seed{BF_SEED}-n{i}" for i in BF_DETECTED}
        if not want <= flagged & quarantined & set(live):
            raise AssertionError(f"{tag}: flagged {sorted(flagged)}, quarantined "
                                 f"{sorted(quarantined)}, flagged at intake {sorted(live)}, "
                                 f"planned {sorted(truth)}, the sign flips {sorted(want)}")
        z = {}
        for e in detections["entries"]:
            if e["peer"] in truth:
                z.setdefault(e["peer"], []).append(float(e["z_norm"]))
        out["adversary_z_range"] = {p: [min(v), max(v)] for p, v in sorted(z.items())}
        out["flagged"] = sorted(flagged)
        out["quarantined"] = sorted(quarantined)
        out["honest_flagged"] = sorted(flagged - truth)
        out["flagged_at_intake"] = {p: live[p] for p in sorted(live)}
        out["honest_flagged_at_intake"] = sorted(set(live) - truth)
        out["decisions"] = len(replay)
        out["_replay"] = json.dumps(replay, sort_keys=True)
        out["_sign_flip_replay"] = [(a["peer"], a["round"], a["action"])
                                    for a in replay if a["peer"] in want]
    if dump_dir is not None:
        dumped = [json.loads(p.read_text()) for p in sorted(Path(dump_dir).glob("flight-*.json"))]
        events = [e for doc in dumped for e in doc["events"]]
        in_dumps = {e["peer"] for e in events if e["name"] == "quarantine"}
        contribs = sum(e["name"] == "contrib" for e in events)
        encoded, complete = hop_chains(entries)
        if in_dumps != set(live) or not contribs or not complete or ring_max >= BF_RING:
            raise AssertionError(f"{tag}: quarantine events for {sorted(in_dumps)}, {contribs} "
                                 f"contrib events, {complete} complete hop chains, "
                                 f"largest ring {ring_max}")
        out["trace"] = {"dumps": len(dumped), "dumped_events": len(events),
                        "contrib_events": contribs, "traces_encoded": encoded,
                        "complete_hop_chains": complete, "largest_ring": ring_max,
                        "ring": BF_RING}
    return out


def one_node_kernel_rows() -> dict:
    """Both conv kernels at the federations' own shapes (both CNN layers
    at one node of 25 and of 32 bf16 images) through
    :func:`conv_layer_rows`: wgmma, the plain versions, timed. Returns
    {"B=25": {kernel: rows}, "B=32": ...}."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    return {f"B={b}": conv_layer_rows(1, b, gen) for b in (BF_BATCH, CH_BATCH)}


def byzantine_federation_path(card: str) -> dict:
    """Every arm of ``BF_ARMS`` (the traced arm's dumps in a temporary
    directory); the two FedAvg + quarantine runs' decisions on the sign
    flips identical with telemetry off and on (whether all their
    decisions are byte-identical, reported); the bench's accuracy ratios
    (reported, not gated: synthetic data)."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, attack, defend, agg, n, traced, rounds in BF_ARMS:
            out[label] = bf_arm(card, label, attack, defend, agg, n,
                                tmp if traced else None, rounds)
    off, on = out["fedavg+quarantine"], out["fedavg+quarantine, traced"]
    if off["_sign_flip_replay"] != on["_sign_flip_replay"]:
        raise AssertionError("byzantine federation: the sign flips' decisions differ with "
                             "telemetry off and on")
    same = off["_replay"] == on["_replay"]
    for arm in out.values():
        arm.pop("_replay", None)
        arm.pop("_sign_flip_replay", None)

    def ratio(a: str, b: str) -> float:
        return out[a]["honest_acc"] / max(out[b]["honest_acc"], 1e-9)

    ideal = "fedavg, adversary-free (6 honest nodes)"
    return {"arms": out, "sign_flip_decisions_identical_telemetry_off_on": True,
            "decisions_byte_identical_telemetry_off_on": same,
            "plain_ratio": ratio("fedavg, attacked", "fedavg, fault-free"),
            "quarantined_ratio": ratio("fedavg+quarantine", ideal),
            "krum_ratio": ratio("krum, attacked", "krum, fault-free"),
            "multikrum_ratio": ratio("multikrum+quarantine", ideal),
            "trimmedmean_ratio": ratio("trimmedmean+quarantine", ideal)}


# --- phase 15: the chaos federation ---------------------------------------
#
# The bench's chaos tier (bench.py:410-573): (a) its fixed round-structured
# schedule twice through FaultInjector(20% drop on every link, seed 1234);
# (b) four CNN Nodes chaos-0..3 (200 samples each, batch 32, lr 0.05, 6
# rounds, star through nodes[0].connect, ELECTION = "hash", SEED = 1234)
# run fault-free, then under that plan with the last node crashed
# (fi.crash) as it enters the final round's train set.
CH_SEED, CH_NODES, CH_ROUNDS, CH_SAMPLES, CH_BATCH = 1234, 4, 6, 200, 32
CH_PLAN = {"links": {"*->*": {"drop": 0.2}}}


def chaos_determinism() -> dict:
    """The tier's fixed schedule (3 links each way, 5 rounds × 40
    messages a link) twice; the per-round delivered / dropped counts must
    be identical."""
    def drive() -> list:
        fi = FaultInjector(FaultPlan.from_dict(CH_PLAN), seed=CH_SEED)
        links = [(f"n{i}", f"n{j}") for i in range(3) for j in range(3) if i != j]
        per_round = []
        for _ in range(5):
            delivered = dropped = 0
            for _ in range(40):
                for link in links:
                    d = fi.decide(*link)
                    if d.action == "drop":
                        dropped += 1
                    else:
                        delivered += d.copies
            per_round.append([delivered, dropped])
        return per_round

    first, second = drive(), drive()
    if first != second:
        raise AssertionError(f"chaos determinism: {first} != {second}")
    return {"seed": CH_SEED, "per_round_delivered_dropped": first, "identical": True}


def chaos_run(card: str, inject: bool) -> dict:
    """One live run. Checks the survivors' complete stage histories, each
    round's wall under ``AGGREGATION_TIMEOUT``, every conv launch on
    wgmma (fault-free: exactly 6 × 4 × 6 steps); under the plan,
    ``dropped > 0`` and no ``corrupt_accepted``."""
    x, y, xt, yt = synthetic_cifar10(n_train=CH_SAMPLES * CH_NODES, n_test=60, seed=0)
    parts = TpflDataset.from_arrays(x, y, xt, yt).generate_partitions(
        CH_NODES, RandomIIDPartitionStrategy, seed=1)
    with runtime_settings(ELECTION="hash", SEED=CH_SEED, PROFILING_ENABLED=True):
        nodes = [TimedNode(phase_model(7), parts[i], addr=f"chaos-{i}", device=PHASE_DEVICE,
                           learning_rate=0.05, batch_size=CH_BATCH) for i in range(CH_NODES)]
        fi = FaultInjector(FaultPlan.from_dict(CH_PLAN), seed=CH_SEED) if inject else None
        try:
            if fi is not None:
                for nd in nodes:
                    fi.attach(nd.communication)
            for nd in nodes:
                nd.start()
            for nd in nodes[1:]:
                nodes[0].connect(nd.addr)
            wait_convergence(nodes, CH_NODES - 1, only_direct=False, wait=10)
            profiling.rounds.reset()
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nodes[0].set_start_learning(rounds=CH_ROUNDS, epochs=1)
            if fi is not None:
                victim = nodes[-1]
                deadline = time.monotonic() + 120
                while time.monotonic() < deadline and not (
                        (victim.state.round or 0) == CH_ROUNDS - 1 and victim.state.train_set):
                    time.sleep(0.02)
                fi.crash(victim.addr)
            survivors = nodes[:-1] if fi is not None else nodes
            wait_to_finish(survivors, timeout=240)
            torch.cuda.synchronize()
            wall = max(nd.finished_at for nd in survivors) - t0
            launches = read_launches()
            wgmma = read_wgmma_launches(("conv_dw", "conv_dx"))
            loss = float(survivors[0].learner.evaluate()["test_loss"])
            per_round = [max(r["wall"] for nd in survivors
                             for r in profiling.rounds.attribution(nd.addr) if r["round"] == rnd)
                         for rnd in range(CH_ROUNDS)]
            stats = fi.stats() if fi is not None else {}
        finally:
            for nd in nodes:
                nd.stop()
    tag = f"chaos federation ({'20% drop, one crash' if inject else 'fault-free'})"
    check_history(tag, survivors, CH_ROUNDS)
    check_conv_launches(tag, launches, wgmma, None if inject else
                        CH_ROUNDS * CH_NODES * (CH_SAMPLES // CH_BATCH))
    if max(per_round) >= Settings.AGGREGATION_TIMEOUT:
        raise AssertionError(f"{tag}: a round took {max(per_round)} s")
    totals = {k: sum(s.get(k, 0) for s in stats.values())
              for k in ("delivered", "dropped", "blocked", "corrupt_accepted")}
    if inject and (not totals["dropped"] or totals["corrupt_accepted"]):
        raise AssertionError(f"{tag}: injector totals {totals}")
    return {"card": card, "rounds": CH_ROUNDS, "experiment_wall_s": wall,
            "rounds_per_s": CH_ROUNDS / wall, "per_round_s": per_round, "final_loss": loss,
            "launches": {k: launches[k] for k in ("conv_dw", "conv_dx")},
            "wgmma_launches": wgmma, "injector_totals": totals}


def chaos_federation_path(card: str) -> dict:
    """15(a), then 15(b) fault-free and under the plan; the loss
    difference against the bench's 5% target is reported, not gated."""
    det = chaos_determinism()
    ff, ch = chaos_run(card, False), chaos_run(card, True)
    rel = abs(ch["final_loss"] - ff["final_loss"]) / max(abs(ff["final_loss"]), 1e-9)
    return {"determinism": det, "fault_free": ff, "chaos": ch, "loss_rel_diff": rel,
            "loss_within_5pct": rel <= 0.05,
            "no_timeout_burn": max(ch["per_round_s"]) < Settings.AGGREGATION_TIMEOUT}


# --- phase 16: the async federation ---------------------------------------
#
# The bench's async tier (bench.py:3067-3222), the Byzantine tier's async
# arm (bench.py:2939-3033) and residual gossip, as gossiping Nodes of the
# CNN cell's model (PHASE_CNN, bf16, the kernels at N = 1) through the
# port's harness (16a-c) or built directly (16d), on seeded synthetic
# CIFAR-shaped data: the tiers' digits MLP needs PIL's rendered digits,
# which the card's machine lacks.
AS_SEED, AS_NODES, AS_SAMPLES, AS_BATCH, AS_EPOCHS, AS_K = 3131, 10, 100, 25, 2, 5
# Phase 25 bought its time here: 3 sync rounds (from 5) and 6 async rounds
# (from 10) in 16a and 18b, 3 rounds (from 4) in 16b, 5 (from 8) in 16c;
# phase 26: 4 rounds in 16c.
AS_WARM, AS_SYNC_ROUNDS, AS_ASYNC_ROUNDS, AS_DET_ROUNDS, AS_DET_K = 2, 3, 6, 3, 8
BA_SEED, BA_ROUNDS, BA_EPOCHS, BA_SAMPLES, BA_BATCH, BA_TEST = 4243, 4, 4, 200, 25, 1200
BA_ADVERSARIES, BA_WITHHOLD_START = (1, 4), 2
# (label, attack, defend, staleness-blind, nodes)
BA_ARMS = [("adversary-free", False, False, False, 8),
           ("staleness-blind", True, False, True, 10),
           ("defended", True, True, False, 10)]
RG_NODES, RG_ROUNDS, RG_SAMPLES, RG_BATCH, RG_TRAIN_SET = 4, 3, 200, 25, 2
# Delta-on against delta-off final params, absolute: the bound
# tests/test_torch_wire_delta.py holds both packages' two runs to on the
# CPU (JAX 0 apart, the port at most 6e-8; a residual decodes as
# (x − base) + base in f32). A residual decoded against a wrong base
# moves the params by a whole update.
RG_ATOL = 1e-6
RG_EXPERIMENT = uuid.UUID(int=0x5EED_0000_0000_0000_0000_0000_0000_0D16)


def as_speed_plan() -> TrainerSpeedPlan:
    """The tier's fleet: 2 of 10 trainers sleep 2.5 s a fit, 8 sleep 0.25 s."""
    return TrainerSpeedPlan.skewed([f"seed{AS_SEED}-n{i}" for i in range(AS_NODES)],
                                   slow_frac=0.2, base_delay=0.25, skew=10.0, seed=AS_SEED)


def cifar_data_fn(samples: int, n: int, n_test: int):
    return lambda s: TpflDataset.from_arrays(*synthetic_cifar10(
        n_train=samples * n, n_test=n_test, seed=s))


def check_async_history(label: str, nodes: list, rounds: int) -> None:
    """Every node's complete async stage history: StartLearningStage, then
    AsyncRoundStage and RoundFinishedStage each round."""
    want = ["StartLearningStage"] + ["AsyncRoundStage", "RoundFinishedStage"] * rounds
    for nd in nodes:
        if nd.learning_workflow.history != want:
            raise AssertionError(f"{label}: {nd.addr} stage history "
                                 f"{nd.learning_workflow.history}")


def final_losses(exp: str, n: int) -> list:
    """Every node's last test loss, finite, one per node."""
    table = metric_table(exp)
    vals = [table[nd]["test_loss"][-1][1] for nd in sorted(table) if table[nd].get("test_loss")]
    if len(vals) != n or not all(np.isfinite(vals)):
        raise AssertionError(f"final test losses {vals} for {n} nodes")
    return vals


class HeldKernel:
    """Stands in for a conv kernel's wrapper while a path runs: each call
    launches the kernel, runs its plain version on the same inputs and
    holds the kernel's output to it at ``bound`` (the path goes on with
    the kernel's output). The kernel counts its launches on the module's
    name for it, which is this object while it stands in, so
    ``launches`` and ``wgmma_launches`` read and write the kernel's own."""

    launches = property(lambda self: self.kernel.launches,
                        lambda self, v: setattr(self.kernel, "launches", v))
    wgmma_launches = property(lambda self: self.kernel.wgmma_launches,
                              lambda self, v: setattr(self.kernel, "wgmma_launches", v))

    def __init__(self, kernel, plain, bound: tuple) -> None:
        self.kernel, self.plain, self.bound = kernel, plain, bound
        self.lock = threading.Lock()
        self.stats = {"held": 0, "beyond_bound": 0, "max_abs_err": 0.0, "max_rel_err": 0.0}

    def __call__(self, *args):
        out = self.kernel(*args)
        got, ref = out.float(), self.plain(*args).float()
        err = (got - ref).abs()
        scale = ref.abs().max()
        beyond = bool(((err > self.bound[0] * ref.abs() + self.bound[1] * scale)
                       | ~torch.isfinite(got)).any())
        worst, scale = err.max().item(), scale.item()
        with self.lock:
            st = self.stats
            st["held"] += 1
            st["beyond_bound"] += beyond
            st["max_abs_err"] = max(st["max_abs_err"], worst)
            st["max_rel_err"] = max(st["max_rel_err"], worst / max(scale, 1e-30))
        return out


@contextlib.contextmanager
def held_convs():
    """While open, every conv kernel launch is held to its plain version
    (:class:`HeldKernel`, the kernel phase's bounds); yields each
    kernel's running stats by name."""
    held = {"conv_dw": HeldKernel(ck.conv_dw, ck.conv_dw_plain, CONV_DW_BOUND),
            "conv_dx": HeldKernel(ck.conv_dx, ck.conv_dx_plain, CONV_DX_BOUND)}
    ck.conv_dw, ck.conv_dx = held["conv_dw"], held["conv_dx"]
    try:
        yield {name: h.stats for name, h in held.items()}
    finally:
        ck.conv_dw, ck.conv_dx = held["conv_dw"].kernel, held["conv_dx"].kernel


def async_run(card: str, label: str, rounds: int, knobs: dict, steps: "int | None",
              n: int = AS_NODES, seed: int = AS_SEED, samples: int = AS_SAMPLES,
              epochs: int = AS_EPOCHS, n_test: int = 200, speed: bool = True,
              attack_plan=None, lr: float = 0.1, inside=None) -> tuple[dict, str, list]:
    """One seeded experiment through the harness: every node's complete
    history (sync or async), finite final params and test losses, the
    conv launches all on wgmma (exactly ``steps`` steps' worth where
    given). ``inside(exp)`` runs before the knobs are restored (the
    quarantine replay reads them); its value is the result's "_inside".
    Returns (result, experiment name, the HarnessNodes)."""
    async_mode = bool(knobs.get("ASYNC_ROUNDS"))
    with runtime_settings(ELECTION="hash", TRAIN_SET_SIZE=n, PROFILING_ENABLED=True, **knobs), \
            harness_nodes() as nodes:
        profiling.rounds.reset()
        reset_launches()
        t0 = time.perf_counter()
        exp = run_seeded_experiment(
            seed, n, rounds, epochs=epochs, speed_plan=as_speed_plan() if speed else None,
            attack_plan=attack_plan, model_fn=phase_model,
            data_fn=cifar_data_fn(samples, n, n_test), samples_per_node=samples,
            batch_size=AS_BATCH, learning_rate=lr, timeout=600.0, device=PHASE_DEVICE)
        torch.cuda.synchronize()
        call_wall = time.perf_counter() - t0
        launches = read_launches()
        wgmma = read_wgmma_launches(("conv_dw", "conv_dx"))
        split = round_split(nodes)
        seen = inside(exp) if inside is not None else None
    tag = f"async federation ({label})"
    if len(nodes) != n:
        raise AssertionError(f"{tag}: the harness built {len(nodes)} HarnessNodes, expected {n}")
    (check_async_history if async_mode else check_history)(tag, nodes, rounds)
    check_conv_launches(tag, launches, wgmma, steps)
    check_node_finals(tag, nodes, agree=False)
    losses = final_losses(exp, n)
    wall = max(nd.finished_at for nd in nodes) - nodes[0].started_at
    out = {"card": card, "nodes": n, "rounds": rounds, "experiment_wall_s": wall,
           "rounds_per_s": rounds / wall, "harness_call_wall_s": call_wall,
           "steady_loss": float(np.mean(losses)),
           "launches": {k: launches[k] for k in ("conv_dw", "conv_dx")},
           "wgmma_launches": wgmma, "round_split": split}
    if inside is not None:
        out["_inside"] = seen
    return out, exp, nodes


def async_ab(card: str) -> dict:
    """16a: a warm async arm, then sync and free-running async (K = 5) over
    the 10x-skewed fleet; both finish every round with finite losses.
    Speedup and loss ratio are reported, not gated (fits run inline on one
    interpreter here; the reference gates 1.5x on its pooled learner)."""
    free = dict(ASYNC_ROUNDS=True, ASYNC_BUFFER_K=AS_K, ASYNC_SERIALIZED=False)
    warm, _, _ = async_run(card, "warm, async", AS_WARM, free, None)
    sync_steps = AS_SYNC_ROUNDS * AS_NODES * AS_EPOCHS * (AS_SAMPLES // AS_BATCH)
    sync, _, _ = async_run(card, "sync", AS_SYNC_ROUNDS, {}, sync_steps)
    asyn, _, _ = async_run(card, "async", AS_ASYNC_ROUNDS, free, None)
    return {"seed": AS_SEED, "nodes": AS_NODES, "buffer_k": AS_K,
            "skew": "2 of 10 trainers 10x slower (2.5 s against 0.25 s a fit)",
            "warm": warm, "sync": sync, "async": asyn,
            "speedup": asyn["rounds_per_s"] / sync["rounds_per_s"],
            "loss_ratio": asyn["steady_loss"] / sync["steady_loss"]}


def async_determinism(card: str) -> dict:
    """16b: two serialized same-seed runs (K = 8, the adaptive controller
    on, the plan's schedule forked into every aggregator): byte-identical
    final digests across the runs, one digest across the ten nodes, and
    identical, non-empty controller trajectories at every node."""
    knobs = dict(ASYNC_ROUNDS=True, ASYNC_BUFFER_K=AS_DET_K, ASYNC_SERIALIZED=True,
                 ASYNC_ADAPTIVE=True)
    steps = AS_DET_ROUNDS * AS_NODES * AS_EPOCHS * (AS_SAMPLES // AS_BATCH)
    runs = []
    for i in range(2):
        result, exp, _ = async_run(card, f"determinism, run {i + 1}", AS_DET_ROUNDS, knobs,
                                   steps)
        runs.append((result, final_model_digests(exp), harness.controller_trajectories(exp)))
    (r1, d1, t1), (r2, d2, t2) = runs
    distinct = len(set(d1.values()))
    if d1 != d2 or distinct != 1:
        raise AssertionError(f"async determinism: digests differ (runs equal: {d1 == d2}, "
                             f"{distinct} distinct in run 1, {len(set(d2.values()))} in run 2)")
    if t1 != t2 or sorted(t1) != sorted(d1) or not all(t1.values()):
        raise AssertionError(f"async determinism: controller trajectories {t1} / {t2}")
    return {"runs": [r1, r2], "byte_identical": True, "digest": sorted(set(d1.values())),
            "controller_records_per_node": sorted({len(v) for v in t1.values()}),
            "controller_trajectories_identical": True}


def byzantine_async(card: str) -> dict:
    """16c: the replay adversaries (stale_flood on n1, withhold_replay from
    round 2 on n4) under serialized buffered rounds with K = n and
    ASYNC_STALENESS_MAX 2: adversary-free at n = 8, staleness-blind
    (exp 0, no defense) and defended (quarantine + ledger, exp 0.5) at
    n = 10. Gated, in the defended arm: the version-tag signature (the
    peers with a ``stale_flood`` decision are exactly {n1, n4}, and from
    its first such decision on, each of them is excluded for
    ``stale_flood`` in every round), and every conv launch held to its
    plain version at the kernel phase's bounds (:func:`held_convs`), so
    the verdicts are those of the kernels' own trajectory. Reported:
    whether the quarantined set is exactly {n1, n4} (``quarantine_exact``).
    It need not be: the ledger's z-score class scores each update norm
    against every round's, and this cell's fits (the CNN at lr 0.1 on
    synthetic data) swing by 30x from round to round, so which honest
    update stands out depends on the trajectory's roundings. From the same
    initial params the JAX package quarantined honest n3 for
    ``norm_outlier`` on the CPU, and the card's trajectory through the
    kernels quarantines honest n5-n8 (``byzantine_reference.py --async``,
    PERF.md §6). Also reported: each honest quarantine with its round and
    reasons, the largest honest update-norm z, the held launches' worst
    errors, honest accuracies and the bench's ratios (synthetic data)."""
    out = {}
    truth_want = {f"seed{BA_SEED}-n{i}" for i in BA_ADVERSARIES}
    for label, attack, defend, blind, n in BA_ARMS:
        ledger.contrib.reset()
        knobs = dict(ASYNC_ROUNDS=True, ASYNC_SERIALIZED=True, ASYNC_ADAPTIVE=False,
                     ASYNC_BUFFER_K=n, ASYNC_STALENESS_MAX=2,
                     ASYNC_STALENESS_EXP=0.0 if blind else 0.5,
                     QUARANTINE_ENABLED=defend, LEDGER_ENABLED=defend)
        plan = AttackPlan({1: AttackSpec("stale_flood"),
                           4: AttackSpec("withhold_replay", start=BA_WITHHOLD_START)},
                          seed=BA_SEED) if attack else None
        # Each node fits once a round; a replay adversary fits until its
        # window opens (stale_flood: round 0 only; withhold_replay: rounds
        # 0 to start − 1) and replays after.
        fits = BA_ROUNDS * (n - len(BA_ADVERSARIES)) + 1 + BA_WITHHOLD_START if attack \
            else BA_ROUNDS * n
        steps = fits * BA_EPOCHS * (BA_SAMPLES // BA_BATCH)
        with held_convs() if defend else contextlib.nullcontext() as held:
            result, exp, _ = async_run(card, f"byzantine, {label}", BA_ROUNDS, knobs, steps,
                                       n=n, seed=BA_SEED, samples=BA_SAMPLES, epochs=BA_EPOCHS,
                                       n_test=BA_TEST, speed=False, attack_plan=plan,
                                       inside=lambda _: (quarantine.replay_decisions(),
                                                         ledger.contrib.detections()["entries"]))
        if held is not None:
            for name, st in held.items():
                if st["held"] != result["launches"][name] or st["beyond_bound"]:
                    raise AssertionError(f"byzantine async ({label}): {name} held to its plain "
                                         f"version: {st}, {result['launches'][name]} launches")
            result["kernels_held_to_plain"] = held
        replay, entries = result.pop("_inside")
        truth = set(adversary_map(exp))
        if truth != (truth_want if attack else set()):
            raise AssertionError(f"byzantine async ({label}): adversary map {sorted(truth)}")
        result["honest_acc"] = honest_acc(exp, BA_ADVERSARIES)
        if defend:
            stale = {a["peer"]: a["round"] for a in reversed(replay)
                     if "stale_flood" in a["reasons"]}  # peer -> first stale_flood round
            excluded = {(a["peer"], a["round"]) for a in replay
                        if "stale_flood" in a["reasons"] and a["action"] in ("quarantine", "reject")}
            if set(stale) != truth or not all((p, r) in excluded for p, r0 in stale.items()
                                              for r in range(r0, BA_ROUNDS)):
                raise AssertionError(f"byzantine async (defended): stale_flood decisions from "
                                     f"{stale}, planned {sorted(truth)}, decisions "
                                     f"{[(a['round'], a['peer'], a['action'], a['reasons']) for a in replay]}")
            quarantines = [a for a in replay if a["action"] == "quarantine"]
            flagged = {a["peer"] for a in quarantines}
            result.update(
                stale_flood_from_round=stale, stale_flood_excluded_every_round=True,
                quarantine_exact=flagged == truth, decisions=len(replay),
                honest_quarantined=[[a["round"], a["peer"], a["reasons"]] for a in quarantines
                                    if a["peer"] not in truth],
                max_honest_z=max((float(e["z_norm"]) for e in entries
                                  if e["peer"] not in truth), default=None))
        out[label] = result
    ideal, blind, defended = (out[a[0]]["honest_acc"] for a in BA_ARMS)
    ledger.contrib.reset()
    return {"arms": out, "blind_ratio": blind / max(ideal, 1e-9),
            "defended_ratio": defended / max(ideal, 1e-9),
            "stale_degrades": bool(blind <= 0.98 * defended),
            "defended_recovers": bool(defended >= 0.95 * ideal)}


def residual_run(card: str, delta: bool) -> dict:
    """16d, one arm: RG_NODES CNN Nodes on a STAR, TRAIN_SET_SIZE
    RG_TRAIN_SET (hash election, so waiters take the round's model over
    the wire), dense codec, ``WIRE_DELTA`` as given. Records every payload
    encoded (kind, bytes), every full-model send (peer, round, kind) and
    every nack; checks complete histories and exactly the elected fits'
    conv launches, all on wgmma."""
    x, y, xt, yt = synthetic_cifar10(n_train=RG_SAMPLES * RG_NODES, n_test=100, seed=5)
    parts = TpflDataset.from_arrays(x, y, xt, yt).generate_partitions(
        RG_NODES, RandomIIDPartitionStrategy, seed=5)
    encodes, sends, nacks = [], [], []
    # One experiment name for both arms: the hash election ranks on it, so
    # the two arms elect the same trainers.
    saved_uuid4, uuid.uuid4 = uuid.uuid4, lambda: RG_EXPERIMENT
    with runtime_settings(ELECTION="hash", TRAIN_SET_SIZE=RG_TRAIN_SET, WIRE_CODEC="dense",
                          WIRE_DELTA=delta, SEED=AS_SEED):
        nodes = [TimedNode(phase_model(11), parts[i], addr=f"resid-{i}", device=PHASE_DEVICE,
                           learning_rate=0.05, batch_size=RG_BATCH) for i in range(RG_NODES)]
        for nd in nodes:
            payload_fn, send_fn = nd.communication.model_payload, nd.communication.send
            nack_fn = nd.communication._commands["codec_nack"]

            def model_payload(model, delta_base=None, nd=nd, f=payload_fn):
                out = f(model, delta_base=delta_base) if delta_base is not None else f(model)
                encodes.append(("delta" if delta_base is not None else "dense", len(out)))
                return out

            def send(nei, msg, create_connection=False, nd=nd, f=send_fn):
                if msg.cmd == "full_model":
                    kind = "delta" if compression.payload_is_delta(msg.payload) else "dense"
                    sends.append((nd.addr, nei, msg.round, kind))
                return f(nei, msg, create_connection=create_connection)

            def codec_nack(source, round, nd=nd, f=nack_fn, **kw):
                nacks.append((len(sends), nd.addr, source, round))
                return f(source, round, **kw)

            nd.communication.model_payload = model_payload
            nd.communication.send = send
            nd.communication.add_command("codec_nack", codec_nack)
        try:
            start_federation(nodes, "STAR")
            reset_launches()
            exp, wall = run_experiment(nodes, RG_ROUNDS)
            launches = read_launches()
            wgmma = read_wgmma_launches(("conv_dw", "conv_dx"))
            finals = [{p: v.detach().clone()
                       for p, v in tree_items(nd.learner.get_model().get_parameters())}
                      for nd in nodes]
        finally:
            for nd in nodes:
                nd.stop()
            uuid.uuid4 = saved_uuid4
    tag = f"residual gossip (WIRE_DELTA {'on' if delta else 'off'})"
    check_history(tag, nodes, RG_ROUNDS)
    check_conv_launches(tag, launches, wgmma,
                        RG_ROUNDS * RG_TRAIN_SET * (RG_SAMPLES // RG_BATCH))
    for nd, final in zip(nodes, finals):
        if not all(torch.isfinite(v).all() for v in final.values()):
            raise AssertionError(f"{tag}: {nd.addr} holds non-finite params")
    by_kind = {k: [b for kk, b in encodes if kk == k] for k in ("dense", "delta")}
    return {"card": card, "experiment_wall_s": wall, "rounds_per_s": RG_ROUNDS / wall,
            "_finals": finals, "_sends": sends, "_nacks": nacks,
            "launches": {k: launches[k] for k in ("conv_dw", "conv_dx")},
            "wgmma_launches": wgmma,
            "payloads": {k: {"count": len(v), "mean_bytes": float(np.mean(v)) if v else None}
                         for k, v in by_kind.items()},
            "full_model_sends": {k: sum(s[3] == k for s in sends) for k in ("dense", "delta")},
            "nacks": len(nacks)}


def residual_gossip(card: str) -> dict:
    """16d: WIRE_DELTA off, then on. Gated: residual full-model sends from
    round 1 on (none before), none with it off; after a nack, its sender
    sends that peer only dense payloads for the round; every node's final
    params within RG_ATOL of the delta-off arm's."""
    off, on = residual_run(card, False), residual_run(card, True)
    delta_sends = [s for s in on["_sends"] if s[3] == "delta"]
    if not delta_sends or any(r < 1 for _, _, r, _ in delta_sends):
        raise AssertionError(f"residual gossip: delta sends {delta_sends}")
    if any(s[3] == "delta" for s in off["_sends"]):
        raise AssertionError("residual gossip: a delta sent with WIRE_DELTA off")
    for at, node, peer, rnd in on["_nacks"]:
        late = [s for s in on["_sends"][at:] if s[:3] == (node, peer, rnd) and s[3] == "delta"]
        if late:
            raise AssertionError(f"residual gossip: {node} sent {peer} a delta after its nack "
                                 f"in round {rnd}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(on["_finals"], off["_finals"])):
        for path, v in a.items():
            torch.testing.assert_close(v, b[path], rtol=0, atol=RG_ATOL,
                                       msg=lambda m, p=path: f"residual gossip node {i} {p}: {m}")
            worst = max(worst, (v - b[path]).abs().max().item())
    for arm in (off, on):
        for k in ("_finals", "_sends", "_nacks"):
            arm.pop(k)
    return {"nodes": RG_NODES, "rounds": RG_ROUNDS, "train_set": RG_TRAIN_SET,
            "delta_off": off, "delta_on": on,
            "delta_on_vs_off_max_abs_diff": worst,
            "payload_bytes_delta_over_dense": (on["payloads"]["delta"]["mean_bytes"]
                                               / on["payloads"]["dense"]["mean_bytes"])}


def async_federation_path(card: str) -> dict:
    """Phase 16: 16a-16d, each logged as it passes."""
    out = {}
    for part, run in (("async_ab", async_ab), ("async_determinism", async_determinism),
                      ("byzantine_async", byzantine_async), ("residual_gossip", residual_gossip)):
        out[part] = run(card)
        log(f"async federation ({part}; every check passed): " + json.dumps(out[part]))
    return out


def async_launches(fed: dict, name: str) -> dict:
    """Phase 16's launches of one conv kernel, by part and arm."""
    ab, det = fed["async_ab"], fed["async_determinism"]
    out = {f"16a {arm}": ab[arm]["launches"][name] for arm in ("warm", "sync", "async")}
    out.update({f"16b run {i + 1}": r["launches"][name] for i, r in enumerate(det["runs"])})
    out.update({f"16c {arm}": r["launches"][name]
                for arm, r in fed["byzantine_async"]["arms"].items()})
    out.update({f"16d delta {arm[6:]}": fed["residual_gossip"][arm]["launches"][name]
                for arm in ("delta_off", "delta_on")})
    return out


# --- phase 17: the engine's variants ---------------------------------------------
#
# The CNN cell of the main path (N_NODES nodes × N_BATCHES × BATCH, bf16,
# conv_impl="pallas", lr 0.1, seed 0) through FedBuff windows and the window
# pipeline (17a, the engine_async tier's recipe, bench.py:2010-2130), the
# telemetry carry (17b), elastic membership (17c, the elastic tier's storm,
# bench.py:2296-2330) and kill-and-resume (17d). Every arm counts its conv
# launches exactly (8 conv_dw + 4 conv_dx a round), every one on wgmma.

EV_ROUNDS, EV_WINDOW, EV_HOST_LEG = 12, 3, 0.02
EV_ADDRS = engine_obs.peer_names(N_NODES)
# The elastic tier's 20 events over 30 rounds (bench.py:2296-2330).
EV_STORM = [("leave", "n1"), ("join", "n1"), ("crash", "n2"), ("join", "n2"),
            ("quarantine", "n3"), ("readmit", "n3"), ("leave", "n0"), ("join", "n0"),
            ("quarantine", "n1"), ("readmit", "n1"), ("crash", "n3"), ("join", "n3"),
            ("leave", "n2"), ("join", "n2"), ("quarantine", "n0"), ("readmit", "n0"),
            ("join", "n4"), ("leave", "n4"), ("join", "n4"), ("quarantine", "n4")]
EV_STORM_ROUNDS = 30


def ev_plan(rounds: int) -> tuple[TrainerSpeedPlan, FedBuffSchedule]:
    """The tier's skewed fleet (20% of trainers 10x slower) lowered to a
    FedBuff schedule of ``rounds`` rounds."""
    plan = TrainerSpeedPlan.skewed(EV_ADDRS, slow_frac=0.2, base_delay=0.05, skew=10.0, seed=7)
    return plan, FedBuffSchedule.from_plan(plan, EV_ADDRS, rounds)


def ev_engine(n: int = N_NODES) -> FederationEngine:
    return FederationEngine(CNN(out_channels=10, conv_impl="pallas"), n, learning_rate=0.1,
                            seed=0)


_EV_DATA: list = []


def ev_data(eng: FederationEngine) -> tuple[torch.Tensor, torch.Tensor]:
    """The cell's data on the card (made once), on ``eng``'s node axis
    (pad rows clone row 0)."""
    if not _EV_DATA:
        _EV_DATA.extend(cnn_data(ev_engine()))
    return eng.shard_data(*_EV_DATA)


def ev_start() -> tuple:
    """(engine, initial params, xs, ys) of the cell, warmed by one round.
    Windows donate their input: each run from the initial params takes an
    :func:`ev_copy` of them."""
    eng = ev_engine()
    xs, ys = ev_data(eng)
    params = eng.init_params((32, 32, 3))
    eng.run_rounds(params, xs, ys, n_rounds=1, donate=False)
    torch.cuda.synchronize()
    return eng, params, xs, ys


def ev_counted(label: str, rounds: int, run) -> tuple:
    """``run()`` with the launch counts set to 0 just before it: exactly
    ``rounds`` rounds' conv launches, all on wgmma. Returns (its value,
    the launches)."""
    reset_launches()
    out = run()
    torch.cuda.synchronize()
    launches = read_launches()
    check_conv_launches(label, launches, read_wgmma_launches(("conv_dw", "conv_dx")),
                        rounds * N_BATCHES * EPOCHS)
    return out, launches


def ev_copy(p: dict) -> dict:
    """An own copy of a start state, for a donating run from it."""
    return tree_map(torch.clone, p)


def ev_equal(a: dict, b: dict) -> bool:
    """Byte equality of two param trees (leaves matched by path)."""
    other = dict(tree_items(b))
    return all(torch.equal(v, other[path]) for path, v in tree_items(a))


def ev_chain(eng, p, xs, ys, rounds: int, schedule=None, start: int = 0) -> tuple:
    """Sequential windows of EV_WINDOW through ``run_rounds``: (params,
    wall seconds)."""
    t0 = time.perf_counter()
    for done in range(0, rounds, EV_WINDOW):
        k = min(EV_WINDOW, rounds - done)
        sub = None if schedule is None else schedule.window(start + done, k)
        p, _ = eng.run_rounds(p, xs, ys, n_rounds=k, schedule=sub)
    torch.cuda.synchronize()
    return p, time.perf_counter() - t0


def ev_fedbuff_pipeline(card: str) -> dict:
    """17a: sync and FedBuff chains, two same-seed pipelined FedBuff runs,
    τ-0 against sync, the stragglers' rows; the virtual-clock composition;
    the sequential and pipelined drivers' idle gaps with a 20 ms host leg,
    and the host's enqueue time per window beside its device time."""
    plan, sched = ev_plan(EV_ROUNDS)
    eng, p0, xs, ys = ev_start()
    launches = {}
    (sync_p, sync_wall), launches["sync chain"] = ev_counted(
        "17a sync chain", EV_ROUNDS, lambda: ev_chain(eng, ev_copy(p0), xs, ys, EV_ROUNDS))
    (fb_p, fb_wall), launches["fedbuff chain"] = ev_counted(
        "17a fedbuff chain", EV_ROUNDS,
        lambda: ev_chain(eng, ev_copy(p0), xs, ys, EV_ROUNDS, sched))

    def piped():
        (p, _), done = WindowPipeline(eng).run(ev_copy(p0), xs, ys, n_rounds=EV_ROUNDS,
                                               window=EV_WINDOW, schedule=sched)
        assert done == EV_ROUNDS
        return p

    runs = []
    for i in (1, 2):
        p, launches[f"fedbuff pipeline {i}"] = ev_counted(f"17a fedbuff pipeline {i}",
                                                          EV_ROUNDS, piped)
        runs.append(p)
    if not ev_equal(runs[0], fb_p):
        raise AssertionError("17a: pipelined FedBuff bytes differ from the sequential chain's")
    if not ev_equal(runs[0], runs[1]):
        raise AssertionError("17a: two same-seed pipelined FedBuff runs differ")
    tau0 = FedBuffSchedule.from_periods([1] * N_NODES, EV_WINDOW)
    (fb0, _), launches["tau-0 fedbuff"] = ev_counted("17a tau-0", EV_WINDOW, lambda: eng.run_rounds(
        ev_copy(p0), xs, ys, n_rounds=EV_WINDOW, schedule=tau0))
    (sync3, _), launches["sync window"] = ev_counted(
        "17a sync window", EV_WINDOW, lambda: eng.run_rounds(ev_copy(p0), xs, ys,
                                                             n_rounds=EV_WINDOW))
    if not ev_equal(fb0, sync3):
        raise AssertionError("17a: an all-arrive τ-0 schedule differs from the sync window")
    # After the last round, arrivals hold its aggregate; the in-flight
    # nodes hold their own trained rows, none of them the aggregate.
    last = sched.arrivals[-1] > 0
    arrived, flight_rows = np.flatnonzero(last), np.flatnonzero(~last)
    for path, v in tree_items(fb_p):
        agg = v[int(arrived[0])]
        if not torch.equal(v[torch.as_tensor(arrived, device=v.device)],
                           agg.expand(len(arrived), *agg.shape)):
            raise AssertionError(f"17a: {path}: the arrivals do not hold one aggregate")
        if any(torch.equal(v[int(i)], agg) for i in flight_rows):
            raise AssertionError(f"17a: {path}: an in-flight node holds the aggregate")

    # The tier's virtual clock: a sync round waits for the slowest
    # trainer, a FedBuff round ticks at the fastest cadence.
    delays = [plan.delay_for(a) for a in EV_ADDRS]
    c_sync, c_fb = sync_wall / EV_ROUNDS, fb_wall / EV_ROUNDS
    tick, slowest = min(d for d in delays if d > 0), max(delays)
    unskewed = 1.0 / (0.05 + c_sync)
    clock = {"program_s_per_round_sync": c_sync, "program_s_per_round_fedbuff": c_fb,
             "virtual_rps_unskewed": unskewed, "virtual_rps_sync_skewed": 1.0 / (slowest + c_sync),
             "virtual_rps_fedbuff_skewed": 1.0 / (tick + c_fb),
             "fedbuff_vs_unskewed": (1.0 / (tick + c_fb)) / unskewed,
             "sync_vs_unskewed": (1.0 / (slowest + c_sync)) / unskewed}

    def staged(widx, start, k):
        time.sleep(EV_HOST_LEG)  # the tier's data staging stand-in
        return None

    def sequential():
        p, gaps, enq, dev, t_ready = ev_copy(p0), [], [], [], None
        for done in range(0, EV_ROUNDS, EV_WINDOW):
            staged(done // EV_WINDOW, done, EV_WINDOW)
            t_disp = time.monotonic()
            if t_ready is not None:
                gaps.append(t_disp - t_ready)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            handle = eng.dispatch_window(p, xs, ys, n_rounds=EV_WINDOW)
            enq.append((time.monotonic() - t_disp) * 1e3)
            b.record()
            b.synchronize()
            t_ready = time.monotonic()
            p = handle.finalize()[0]
            dev.append(a.elapsed_time(b))
        return p, gaps, enq, dev

    (seq_p, seq_gaps, enq, dev), launches["sequential driver"] = ev_counted(
        "17a sequential driver", EV_ROUNDS, sequential)
    pipe = WindowPipeline(eng)

    def pipelined():
        (p, _), _ = pipe.run(ev_copy(p0), xs, ys, n_rounds=EV_ROUNDS, window=EV_WINDOW,
                             data_for=staged, prefetch=True)
        return p

    pipe_p, launches["pipelined driver"] = ev_counted("17a pipelined driver", EV_ROUNDS,
                                                      pipelined)
    if not ev_equal(seq_p, pipe_p) or not ev_equal(seq_p, sync_p):
        raise AssertionError("17a: the drivers' bytes differ from the sync chain's")
    return {"card": card, "nodes": N_NODES, "rounds": EV_ROUNDS, "window": EV_WINDOW,
            "sync_rounds_per_s": EV_ROUNDS / sync_wall, "fedbuff_rounds_per_s": EV_ROUNDS / fb_wall,
            "slow_nodes": int((sched.arrivals.sum(0) < EV_ROUNDS).sum()),
            "arrivals_per_round": sched.arrivals.sum(1).tolist(),
            "pipelined_equals_sequential": True, "same_seed_pipelines_identical": True,
            "tau0_equals_sync": True, "virtual_clock": clock,
            "host_leg_s_per_window": EV_HOST_LEG,
            "seq_idle_gaps_s": seq_gaps, "pipeline_idle_gaps_s": pipe.idle_gaps,
            "seq_idle_gap_mean_s": statistics.mean(seq_gaps),
            "pipeline_idle_gap_mean_s": statistics.mean(pipe.idle_gaps),
            "enqueue_ms_per_window": enq, "device_ms_per_window": dev, "launches": launches}


def ev_telemetry(card: str) -> dict:
    """17b: a 3-round window with the carry off and on (params byte-identical,
    every carry field finite, participation N_NODES), walls of each; then a
    sign flip on every fifth node with the ledger on: the detections'
    sign-flip class holds exactly the flippers, each in every round; the
    honest nodes the norm class flags are reported, with the window's
    carry."""
    eng, p0, xs, ys = ev_start()
    launches, walls, outs = {}, {}, {}
    snap = Settings.snapshot()
    try:
        for on in (False, True, False, True):
            Settings.ENGINE_TELEMETRY = on
            label = "telemetry on" if on else "telemetry off"

            def window():
                p = ev_copy(p0)
                t0 = time.perf_counter()
                handle = eng.dispatch_window(p, xs, ys, n_rounds=EV_WINDOW)
                tele = handle.telemetry()
                p = handle.finalize()[0]
                torch.cuda.synchronize()
                return p, tele, time.perf_counter() - t0

            (outs[on], tele, wall), launches[label] = ev_counted(f"17b {label}", EV_WINDOW, window)
            walls.setdefault(label, []).append(wall)
            if on:
                bad = [k for k, v in tele.items() if not np.isfinite(v).all()]
                if bad or not (tele["participation"] == N_NODES).all():
                    raise AssertionError(f"17b: carry fields {bad} not finite or participation "
                                         f"{tele['participation']}")
                carry = {k: v.tolist() for k, v in tele.items()
                         if k in ("delta_norm", "model_norm", "participation", "wire_bytes")}
        if not ev_equal(outs[False], outs[True]):
            raise AssertionError("17b: params differ with the telemetry carry on and off")
        plan = AttackPlan({i: AttackSpec("sign_flip") for i in range(0, N_NODES, 5)}, seed=7)
        truth = set(plan.adversary_map(EV_ADDRS))
        Settings.ENGINE_TELEMETRY, Settings.LEDGER_ENABLED = True, True
        ledger.contrib.reset()
        def attacked():
            handle = eng.dispatch_window(ev_copy(p0), xs, ys, n_rounds=EV_WINDOW,
                                         attack_scales=plan.engine_scales(EV_ADDRS, EV_WINDOW))
            tele = handle.telemetry()
            handle.finalize()
            return tele

        tele, launches["sign flip"] = ev_counted("17b sign flip", EV_WINDOW, attacked)
        det = ledger.contrib.detections()
        flagged = set(det["flagged"])
        # The sign-flip class (cos_ref at the threshold) is the attack's
        # signature: exactly the flippers, every round. The norm class
        # scores each norm against every round's norms, so which honest
        # update stands out depends on the trajectory (ROADMAP.md §3):
        # reported.
        flips = {e["peer"] for e in det["entries"] if "sign_flip" in e["reasons"]}
        every_round = all(len(det["flagged"].get(p, {}).get("rounds", [])) == EV_WINDOW
                          for p in truth)
        if flips != truth or not every_round:
            raise AssertionError(f"17b: sign_flip flags on {sorted(flips ^ truth)} beside the "
                                 f"{len(truth)} flippers, or a flipper missed a round")
        honest = {p: v for p, v in det["flagged"].items() if p not in truth}
    finally:
        Settings.restore(snap)
        ledger.contrib.reset()
    return {"card": card, "wall_s": walls, "params_identical_on_off": True, "carry": carry,
            "sign_flips": len(truth), "sign_flip_flags_exact": True,
            "flagged_exactly_the_flippers": flagged == truth, "honest_flagged": len(honest),
            "honest_flag_rounds": sorted({r for v in honest.values() for r in v["rounds"]}),
            "honest_flag_reasons": sorted({r for v in honest.values() for r in v["reasons"]}),
            # The window's carry, for byzantine_reference.py --engine-carry
            # (both packages' verdict code over the card's values).
            "sign_flip_carry": {k: v.tolist() for k, v in tele.items()},
            "launches": launches}


def ev_elastic(card: str) -> dict:
    """17c: a MembershipView over N_NODES live addresses (capacity 128)
    through the tier's storm over 30 rounds: resize_nodes calls equal the
    view's tier moves; the masked capacity-128 window against an exact
    n = N_NODES one after 2 rounds (rtol 1e-3, atol 1e-4); one window's
    conv launches at N = 128 held to their plain versions."""
    view = MembershipView([f"n{i}" for i in range(N_NODES)])
    eng = ev_engine()
    eng.attach_membership(view)
    resizes = []
    real_resize = eng.resize_nodes

    def resize(n):
        resizes.append(n)
        real_resize(n)

    eng.resize_nodes = resize
    xs, ys = ev_data(eng)
    p = eng.init_params((32, 32, 3))
    shapes = [v.shape for _, v in tree_items(p)]
    eng.run_rounds(p, xs, ys, weights=view.weights(), n_rounds=1)

    def storm():
        nonlocal p, xs, ys
        t0 = time.perf_counter()
        for r in range(EV_STORM_ROUNDS):
            if r < len(EV_STORM):
                getattr(view, EV_STORM[r][0])(EV_STORM[r][1])
            if eng.sync_membership():  # a tier move: the one resize of the state
                p, xs, ys = (eng.pad_stacked(tree_map(lambda t: t[:eng.n_nodes], tree))
                             for tree in (p, xs, ys))
            p, _ = eng.run_rounds(p, xs, ys, weights=view.weights(), n_rounds=1)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    launches = {}
    wall, launches["storm"] = ev_counted("17c storm", EV_STORM_ROUNDS, storm)
    moves = view.tier_events()
    if len(resizes) != len(moves) or (not moves and [v.shape for _, v in tree_items(p)] != shapes):
        raise AssertionError(f"17c: {len(resizes)} resizes for {len(moves)} tier moves")
    # Masked capacity-128 against exact n = N_NODES, from the same params.
    exact, p0, xs0, ys0 = ev_start()
    masked = ev_engine()
    masked.attach_membership(MembershipView([f"n{i}" for i in range(N_NODES)]))
    mw = masked.membership.weights()
    p128, (x128, y128) = masked.pad_stacked(p0), masked.shard_data(xs0, ys0)
    (want, _), launches[f"exact n={N_NODES}"] = ev_counted("17c exact", 2, lambda: exact.run_rounds(
        p0, xs0, ys0, n_rounds=2))
    (got, _), launches[f"masked {masked.n_nodes}"] = ev_counted("17c masked", 2, lambda: masked.run_rounds(
        p128, x128, y128, weights=mw, n_rounds=2))
    worst = 0.0
    want_by = dict(tree_items(want))
    for path, v in tree_items(got):
        torch.testing.assert_close(v[:N_NODES], want_by[path], rtol=1e-3, atol=1e-4, msg=path)
        worst = max(worst, (v[:N_NODES] - want_by[path]).abs().max().item())
    with held_convs() as held:
        masked.run_rounds(p128, x128, y128, weights=mw, n_rounds=1)
        torch.cuda.synchronize()
    steps = N_BATCHES * EPOCHS
    if (held["conv_dw"]["held"], held["conv_dx"]["held"]) != (2 * steps, steps) or any(
            h["beyond_bound"] for h in held.values()):
        raise AssertionError(f"17c: conv launches at N = 128 against their plain versions: {held}")
    return {"card": card, "live": N_NODES, "capacity": int(view.capacity),
            "storm_events": len(EV_STORM), "storm_rounds": EV_STORM_ROUNDS,
            "storm_rounds_per_s": EV_STORM_ROUNDS / wall, "tier_moves": moves,
            "resize_calls": len(resizes), "masked_vs_exact_max_abs_diff": worst,
            "held_at_capacity": held, "launches": launches}


def ev_resume(card: str) -> dict:
    """17d: 3 rounds, export_state (controller and quarantine attached),
    EngineCheckpointer through a temporary directory, import_state on a
    fresh engine, 3 more rounds: byte-identical to 6 uninterrupted rounds,
    sync and FedBuff; then the pipeline with a snapshot every window
    against none (walls reported)."""
    eng, p0, xs, ys = ev_start()
    _, sched = ev_plan(6)
    launches, out = {}, {}
    for label, schedule in (("sync", None), ("fedbuff", sched)):
        full, launches[f"{label} uninterrupted"] = ev_counted(
            f"17d {label} uninterrupted", 6,
            lambda: ev_chain(eng, ev_copy(p0), xs, ys, 6, schedule)[0])

        def killed_and_resumed():
            first = ev_engine()
            first.controller = AsyncController("engine")
            q = QuarantineEngine("engine")
            pb, _ = ev_chain(first, ev_copy(p0), xs, ys, 3, schedule)
            with tempfile.TemporaryDirectory() as tmp:
                ck = EngineCheckpointer(tmp, node="engine")
                t0 = time.perf_counter()
                ck.save(first.export_state(pb, quarantine=q), step=3)
                state, meta = ck.restore()
                io = time.perf_counter() - t0
            resumed = ev_engine()
            resumed.controller = AsyncController("engine")
            back = resumed.import_state(state, quarantine=QuarantineEngine("engine"))
            if resumed._rounds_done != 3 or meta["step"] != 3:
                raise AssertionError(f"17d: resumed at {resumed._rounds_done}, step {meta}")
            pc, _ = ev_chain(resumed, back["params"], xs, ys, 3, schedule,
                             start=resumed._rounds_done)
            return pc, io

        (resumed, io), launches[f"{label} killed + resumed"] = ev_counted(
            f"17d {label} resume", 6, killed_and_resumed)
        if not ev_equal(resumed, full):
            raise AssertionError(f"17d: the resumed {label} run differs from the uninterrupted")
        out[label] = {"byte_identical": True, "save_restore_s": io}

    from concurrent.futures import ThreadPoolExecutor

    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(max_workers=1) as pool:
        ck = EngineCheckpointer(tmp, node="engine")
        pending = []

        def run(snapshots: bool) -> float:
            pipe = WindowPipeline(eng)
            p = ev_copy(p0)
            t0 = time.perf_counter()
            result, done = pipe.run(
                p, xs, ys, n_rounds=EV_ROUNDS, window=EV_WINDOW,
                snapshot_every=1 if snapshots else 0,
                snapshot_to=lambda r, s: pending.append(pool.submit(ck.save, s, step=r)))
            torch.cuda.synchronize()
            for f in pending:
                f.result()
            pending.clear()
            return time.perf_counter() - t0

        walls = {"plain": [], "snapshots": []}
        for snapshots in (False, True, True, False):
            wall, _ = ev_counted("17d snapshot cadence", EV_ROUNDS, lambda: run(snapshots))
            walls["snapshots" if snapshots else "plain"].append(wall)
        published = ck.latest_step()
    overhead = min(walls["snapshots"]) / min(walls["plain"]) - 1.0
    return {"card": card, **out, "snapshot_walls_s": walls, "snapshot_overhead": overhead,
            "snapshots_published_to_round": published, "launches": launches}


def engine_variants_path(card: str) -> dict:
    """Phase 17: 17a-17d, each logged as it passes."""
    out = {}
    for part, run in (("fedbuff_pipeline", ev_fedbuff_pipeline), ("telemetry", ev_telemetry),
                      ("elastic", ev_elastic), ("resume", ev_resume)):
        t0 = time.perf_counter()
        out[part] = run(card)
        out[part]["phase_s"] = time.perf_counter() - t0
        log(f"engine variants ({part}; every check passed): " + json.dumps(out[part]))
    return out


def ev_launches(ev: dict, name: str) -> dict:
    """Phase 17's launches of one conv kernel, by part and arm."""
    return {f"17{tag} {arm}": counts[name]
            for tag, part in zip("abcd", ("fedbuff_pipeline", "telemetry", "elastic", "resume"))
            for arm, counts in ev[part]["launches"].items()}


# --- phase 18: the simulation plane ------------------------------------------------
#
# The reference's default fit path (Settings.DISABLE_SIMULATION off): every
# Node's learner wrapped in a VirtualNodeLearner, and the concurrent fits of
# a round's train set batched by the SuperLearnerPool into one node-stacked
# program, so the CNN's conv kernels run at N = the chunk's power-of-two
# bucket where phases 14-17 ran them at N = 1 (those phases keep
# runtime_settings' inline fits: they are the N = 1 cells). 18a the
# byzantine tier's FedAvg arms pooled (phase 14's recipe), 18b the async
# tier's speed arms pooled (phase 16a's recipe, SIM_BATCH_MAX_WAIT 0.6 as
# bench.py:3112), 18c FederationLearner at the multislice example's
# defaults (tpfl/examples/multislice.py:77-82), 18d the population cells
# sim1m (bench.py:946-1017) and sim1000 (bench.py:3689-3722) on the MLP,
# one isolated fit (SIM_PROCESS_ISOLATION), and the conv kernels at the
# pooled shapes.
SP_ARMS = [("fedavg, fault-free", False), ("fedavg, attacked", True)]
SP_NODES = 10
SP_BUCKET = 16  # the pool's power-of-two bucket of the 10-node train set
SP_STEPS = BF_PLAIN_ROUNDS * BF_EPOCHS * (BF_SAMPLES // BF_BATCH)  # node-batched steps an arm
# Pooled against inline fits of one learner on the card: the same bf16 ops
# at another node count, where a library kernel may round an element
# another way and the conv kernels stay within their bounds. Elementwise
# CONV_DX_BOUND's one bf16 rounding (2^-7 relative), plus, per step of the
# fit, its absolute term (1e-3 of the leaf's largest |param|).
SP_TWIN_RTOL = CONV_DX_BOUND[0]
SP_TWIN_ATOL_PER_STEP = CONV_DX_BOUND[1]
FL_LOCAL, FL_SAMPLES, FL_BATCH, FL_ROUNDS, FL_SEED = 8, 2000, 32, 2, 666
FL_STEPS = (FL_SAMPLES // FL_LOCAL) // FL_BATCH  # steps of one local round
POP_CENSUS, POP_K, POP_ROUNDS = 1_000_000, 100, 3
S1K_NODES, S1K_BATCH, S1K_ROUNDS = 1000, 32, 30


class CountingKernel:
    """Stands in for a conv kernel's wrapper: records each launch's node
    count (the first argument's leading axis) and launches the kernel. The
    kernel counts its launches on the module's name for it, this object
    while it stands in, so the counters pass through to the kernel's."""

    launches = property(lambda self: self.kernel.launches,
                        lambda self, v: setattr(self.kernel, "launches", v))
    wgmma_launches = property(lambda self: self.kernel.wgmma_launches,
                              lambda self, v: setattr(self.kernel, "wgmma_launches", v))

    def __init__(self, kernel) -> None:
        self.kernel = kernel
        self.lock = threading.Lock()
        self.nodes: dict[int, int] = {}

    def __call__(self, *args):
        with self.lock:
            n = int(args[0].shape[0])
            self.nodes[n] = self.nodes.get(n, 0) + 1
        return self.kernel(*args)


@contextlib.contextmanager
def conv_node_counts():
    """While open, each conv launch's node count is recorded; yields
    {kernel: {N: launches}}."""
    spies = {"conv_dw": CountingKernel(ck.conv_dw), "conv_dx": CountingKernel(ck.conv_dx)}
    ck.conv_dw, ck.conv_dx = spies["conv_dw"], spies["conv_dx"]
    try:
        yield {name: s.nodes for name, s in spies.items()}
    finally:
        ck.conv_dw, ck.conv_dx = spies["conv_dw"].kernel, spies["conv_dx"].kernel


def pool_stats() -> dict:
    p = SuperLearnerPool.instance()
    return {"batched_dispatches": p.batched_dispatches, "batched_fits": p.batched_fits,
            "group_sizes": list(p.group_sizes), "singles": p.singles, "fallbacks": p.fallbacks}


def check_at_nodes(label: str, counts: dict, want: dict) -> None:
    """Every conv launch at the node counts ``want`` ({kernel: {N: n}})."""
    got = {k: dict(v) for k, v in counts.items()}
    if got != want:
        raise AssertionError(f"{label}: conv launches by node count {got}, expected {want}")


def pooled_bf_arm(card: str, label: str, attack: bool, inline: dict) -> dict:
    """18a, one arm: phase 14's seeded experiment of ten Nodes with the
    pool on. Checks complete histories, one batched dispatch of all ten
    fits a round with no fallback and no single, exactly SP_STEPS
    node-batched steps' conv launches (2 conv_dw + 1 conv_dx a step), all
    on wgmma and all at N = SP_BUCKET, finite test losses, and every
    node's final params within rtol 1e-6 of node 0's. Reports rounds/s
    beside the inline arm of phase 14, the round split, host→device
    copies a round and the pad rows' share of the work."""
    SuperLearnerPool.reset()
    h2d = batched_fit.h2d_copies
    with runtime_settings(DISABLE_SIMULATION=False, TRAIN_SET_SIZE=SP_NODES, ELECTION="hash",
                          PROFILING_ENABLED=True), harness_nodes() as nodes, \
            conv_node_counts() as by_n:
        profiling.rounds.reset()
        reset_launches()
        t0 = time.perf_counter()
        exp = run_seeded_experiment(
            BF_SEED, SP_NODES, BF_PLAIN_ROUNDS, epochs=BF_EPOCHS,
            attack_plan=bf_plan() if attack else None, model_fn=phase_model,
            data_fn=cifar_data_fn(BF_SAMPLES, SP_NODES, BF_TEST), samples_per_node=BF_SAMPLES,
            batch_size=BF_BATCH, learning_rate=0.1, timeout=300.0, device=PHASE_DEVICE)
        torch.cuda.synchronize()
        call_wall = time.perf_counter() - t0
        launches = read_launches()
        wgmma = read_wgmma_launches(("conv_dw", "conv_dx"))
        split = round_split(nodes)
        stats = pool_stats()
        losses = final_losses(exp, SP_NODES)
    tag = f"simulation plane, pooled byzantine ({label})"
    if len(nodes) != SP_NODES:
        raise AssertionError(f"{tag}: the harness built {len(nodes)} HarnessNodes")
    check_history(tag, nodes, BF_PLAIN_ROUNDS)
    check_conv_launches(tag, launches, wgmma, SP_STEPS)
    check_at_nodes(tag, by_n, {"conv_dw": {SP_BUCKET: 2 * SP_STEPS},
                               "conv_dx": {SP_BUCKET: SP_STEPS}})
    if (stats["group_sizes"] != [SP_NODES] * BF_PLAIN_ROUNDS or stats["fallbacks"]
            or stats["singles"]):
        raise AssertionError(f"{tag}: pool {stats}, expected one dispatch of {SP_NODES} fits "
                             f"a round")
    spread = check_node_finals(tag, nodes, agree=True)
    wall = max(nd.finished_at for nd in nodes) - nodes[0].started_at
    rps = BF_PLAIN_ROUNDS / wall
    return {"card": card, "nodes": SP_NODES, "rounds": BF_PLAIN_ROUNDS, "experiment_wall_s": wall,
            "rounds_per_s": rps, "inline_rounds_per_s": inline["rounds_per_s"],
            "speedup_over_inline": rps / inline["rounds_per_s"],
            "harness_call_wall_s": call_wall, "mean_test_loss": float(np.mean(losses)),
            "launches": {k: launches[k] for k in ("conv_dw", "conv_dx")},
            "inline_launches": inline["launches"], "wgmma_launches": wgmma,
            "launches_by_node_count": {k: {str(n): c for n, c in v.items()}
                                       for k, v in by_n.items()},
            "pool": stats, "h2d_copies_per_round": (batched_fit.h2d_copies - h2d) / BF_PLAIN_ROUNDS,
            "pad_row_share": (SP_BUCKET - SP_NODES) / SP_BUCKET,
            "final_models_max_abs_diff": spread, "round_split": split,
            "inline_round_split": inline["round_split"]}


def sp_learner(seed: int, addr: str) -> TorchLearner:
    """A learner of the cell: 200 seeded CIFAR-shaped samples, B 25, lr 0.1."""
    data = TpflDataset.from_arrays(*synthetic_cifar10(n_train=BF_SAMPLES, n_test=BF_BATCH,
                                                      seed=seed))
    return TorchLearner(phase_model(BF_SEED), data, addr=addr, learning_rate=0.1,
                        batch_size=BF_BATCH, device=PHASE_DEVICE)


def fit_together(learners: list) -> None:
    """Each learner's fit through the pool, all at once."""
    threads = [threading.Thread(target=VirtualNodeLearner(ln).fit) for ln in learners]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a pooled fit did not return")


def twin_check(label: str, got: dict, want: dict, start: dict, steps: int) -> dict:
    """``got`` within SP_TWIN_RTOL · |want| + steps · SP_TWIN_ATOL_PER_STEP
    · max|want leaf| of ``want``; returns the largest error over the
    largest update the fit made, both relative to the leaf's scale."""
    err = upd = 0.0
    for path, w in want.items():
        scale = w.abs().max().item()
        diff = (got[path].float() - w.float()).abs()
        limit = SP_TWIN_RTOL * w.float().abs() + steps * SP_TWIN_ATOL_PER_STEP * scale
        if not torch.isfinite(got[path]).all() or bool((diff > limit).any()):
            raise AssertionError(f"{label}: {path} max |err| {diff.max().item():.3e} beyond "
                                 f"the bound (max |param| {scale:.3e})")
        err = max(err, diff.max().item() / max(scale, 1e-30))
        upd = max(upd, (w.float() - start[path].float()).abs().max().item() / max(scale, 1e-30))
    return {"max_rel_err": err, "max_rel_update": upd}


def pooled_vs_inline_fit() -> dict:
    """One learner of the cell fitted inline (1 epoch: 8 steps at N = 1)
    and two clones of it fitted as twins through the pool (the same
    address, so the same batch order; N = 2): each twin within the
    stated bound of the inline fit."""
    inline = sp_learner(BF_SEED, "sp-twin")
    inline.set_epochs(1)
    start = {p: v.clone() for p, v in tree_items(inline.get_model().get_parameters())}
    inline.fit()
    want = {p: v.clone() for p, v in tree_items(inline.get_model().get_parameters())}
    twins = [sp_learner(BF_SEED, "sp-twin") for _ in range(2)]
    for ln in twins:
        ln.set_epochs(1)
    SuperLearnerPool.reset()
    fit_together(twins)
    stats = pool_stats()
    if stats["group_sizes"] != [2] or stats["fallbacks"] or stats["singles"]:
        raise AssertionError(f"pooled twins: pool {stats}")
    steps = BF_SAMPLES // BF_BATCH
    out = {}
    for i, ln in enumerate(twins):
        got = dict(tree_items(ln.get_model().get_parameters()))
        out[f"twin {i}"] = twin_check(f"pooled twin {i}", got, want, start, steps)
    return {"steps": steps, "rtol": SP_TWIN_RTOL, "atol_per_step_rel": SP_TWIN_ATOL_PER_STEP,
            **out}


def stage_learners(n: int = SP_NODES, prefix: str = "sp-round") -> list:
    """The pooled stage's learners (seeds BF_SEED + i), BF_EPOCHS epochs each."""
    learners = [sp_learner(BF_SEED + i, f"{prefix}-{i}") for i in range(n)]
    for ln in learners:
        ln.set_epochs(BF_EPOCHS)
    return learners


def pooled_round_fn(n: int = SP_NODES):
    """One pooled train stage of a round as a function: ``n`` learners of
    the cell fit BF_EPOCHS epochs through the pool, hinted as one group,
    so one batched dispatch."""
    learners = stage_learners(n)
    wrapped = [VirtualNodeLearner(ln) for ln in learners]
    for v in wrapped:
        v.set_fit_group_hint(n)

    def run() -> None:
        threads = [threading.Thread(target=v.fit) for v in wrapped]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a pooled fit did not return")

    run.learners = learners
    return run


def pooled_byzantine(card: str, byzantine_fed: dict) -> dict:
    """18a: both pooled arms beside phase 14's inline ones, the pooled fit
    held to the inline fit on the card, and one pooled train stage timed
    alone (wall and device time, CUDA events)."""
    arms = {label: pooled_bf_arm(card, label, attack, byzantine_fed["arms"][label])
            for label, attack in SP_ARMS}
    twins = pooled_vs_inline_fit()
    run = pooled_round_fn()
    SuperLearnerPool.reset()
    run()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    stage = time.perf_counter() - t0
    return {"arms": arms, "pooled_vs_inline_fit": twins,
            "train_stage_alone_s": stage, "train_stage_steps": BF_EPOCHS * 8,
            "pool_after_stage": pool_stats()}


def pooled_async(card: str, async_fed: dict) -> dict:
    """18b: phase 16a's three arms with the pool on (SIM_BATCH_MAX_WAIT
    0.6): completion, finite params, every launch on wgmma, batched
    dispatches > 0 and no fallback in each arm. Group sizes follow the
    fits' timing, so launch counts are reported, not gated; rounds/s and
    the speedup beside 16a's inline ones."""
    free = dict(ASYNC_ROUNDS=True, ASYNC_BUFFER_K=AS_K, ASYNC_SERIALIZED=False)
    pooled = dict(DISABLE_SIMULATION=False, SIM_BATCH_MAX_WAIT=0.6)
    arms = {}
    for label, rounds, knobs in (("warm", AS_WARM, free), ("sync", AS_SYNC_ROUNDS, {}),
                                 ("async", AS_ASYNC_ROUNDS, free)):
        SuperLearnerPool.reset()
        result, _, _ = async_run(card, f"pooled {label}", rounds, {**knobs, **pooled}, None)
        stats = pool_stats()
        if not stats["batched_dispatches"] or stats["fallbacks"]:
            raise AssertionError(f"pooled async ({label}): pool {stats}")
        result["pool"] = stats
        arms[label] = result
    ab = async_fed["async_ab"]
    return {**arms, "speedup": arms["async"]["rounds_per_s"] / arms["sync"]["rounds_per_s"],
            "inline_sync_rounds_per_s": ab["sync"]["rounds_per_s"],
            "inline_async_rounds_per_s": ab["async"]["rounds_per_s"],
            "inline_speedup": ab["speedup"],
            "sync_over_inline": arms["sync"]["rounds_per_s"] / ab["sync"]["rounds_per_s"],
            "async_over_inline": arms["async"]["rounds_per_s"] / ab["async"]["rounds_per_s"]}


def fl_learner(seed: int, **kw) -> FederationLearner:
    return FederationLearner(n_local_nodes=FL_LOCAL, local_rounds=1, learning_rate=0.1,
                             batch_size=FL_BATCH, seed=seed, device=PHASE_DEVICE, **kw)


def fl_shards() -> list:
    data = TpflDataset.from_arrays(*synthetic_cifar10(n_train=2 * FL_SAMPLES, n_test=400,
                                                      seed=FL_SEED))
    return data.generate_partitions(2, RandomIIDPartitionStrategy, seed=FL_SEED)


def fl_federation(card: str) -> dict:
    """18c, the federation: two gossiping Nodes, each a FederationLearner
    of FL_LOCAL local CNN rows (2,000 samples, B 32, local_rounds 1), 2
    rounds: complete histories, each fit one window at N = FL_LOCAL
    (exactly 4 fits × FL_STEPS steps' launches, all wgmma), the two
    Nodes' final models within rtol 1e-6."""
    shards = fl_shards()
    with runtime_settings(DISABLE_SIMULATION=False, SHARD_ROUNDS_PER_DISPATCH=1,
                          PROFILING_ENABLED=True), conv_node_counts() as by_n:
        profiling.rounds.reset()
        nodes = [TimedNode(phase_model(FL_SEED), shards[i], addr=f"slice-{i}",
                           learner=fl_learner(i), device=PHASE_DEVICE) for i in range(2)]
        try:
            start_federation(nodes, "LINE")
            reset_launches()
            _, wall = run_experiment(nodes, FL_ROUNDS)
            launches = read_launches()
            wgmma = read_wgmma_launches(("conv_dw", "conv_dx"))
            evals = [nd.learner.evaluate() for nd in nodes]
            finals = [{p: v.clone() for p, v in tree_items(nd.learner.get_model().get_parameters())}
                      for nd in nodes]
            split = round_split(nodes)
            check_history("simulation plane (FederationLearner)", nodes, FL_ROUNDS)
        finally:
            for nd in nodes:
                nd.stop()
    tag = "simulation plane (FederationLearner)"
    fits = 2 * FL_ROUNDS
    check_conv_launches(tag, launches, wgmma, fits * FL_STEPS)
    check_at_nodes(tag, by_n, {"conv_dw": {FL_LOCAL: 2 * fits * FL_STEPS},
                               "conv_dx": {FL_LOCAL: fits * FL_STEPS}})
    for path, v in finals[0].items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"{tag}: non-finite {path}")
        torch.testing.assert_close(finals[1][path], v, rtol=1e-6, atol=1e-7,
                                   msg=lambda m, p=path: f"{tag}: {p}: {m}")
    return {"card": card, "nodes": 2, "local_rows": FL_LOCAL, "logical_nodes": 2 * FL_LOCAL,
            "rounds": FL_ROUNDS, "experiment_wall_s": wall, "rounds_per_s": FL_ROUNDS / wall,
            "launches": {k: launches[k] for k in ("conv_dw", "conv_dx")},
            "wgmma_launches": wgmma, "test_metric": [e["test_metric"] for e in evals],
            "round_split": split}


def fl_restack_and_resume(card: str) -> dict:
    """18c, the learner: one capacity-tier restack through set_membership
    (8 live rows, then 2 joins: tier 16, the next fit at N = 16), and one
    kill-and-resume through CHECKPOINT_DIR (a fit killed after 2 windows
    leaves its snapshot; a fresh engine resumed from it runs windows 2-3
    on the learner's data stream and ends on the bytes of an
    uninterrupted 4-window fit)."""
    shard = fl_shards()[0]
    tag = "simulation plane (FederationLearner restack)"
    with runtime_settings(SHARD_ROUNDS_PER_DISPATCH=1, ENGINE_PREFETCH=True), \
            conv_node_counts() as by_n:
        learner = fl_learner(0)
        learner.set_model(phase_model(FL_SEED))
        learner.set_data(shard)
        view = MembershipView([f"r{i}" for i in range(FL_LOCAL)])
        learner.set_membership(view)
        learner.fit()
        fed_before = learner._fed
        for i in range(FL_LOCAL, FL_LOCAL + 2):
            view.join(f"r{i}")
        learner.fit()
        torch.cuda.synchronize()
        restack_counts = {k: dict(v) for k, v in by_n.items()}
    finite = all(torch.isfinite(v).all() for _, v in tree_items(
        learner.get_model().get_parameters()))
    if (learner.n_local_nodes != 2 * FL_LOCAL or learner._fed is fed_before
            or learner._fed.engine.membership is not view or not finite
            or set(restack_counts["conv_dw"]) != {FL_LOCAL, 2 * FL_LOCAL}):
        raise AssertionError(f"{tag}: n_local_nodes {learner.n_local_nodes}, capacity "
                             f"{view.capacity}, launches by node count {restack_counts}, "
                             f"finite {finite}")
    tag = "simulation plane (FederationLearner kill-and-resume)"
    with tempfile.TemporaryDirectory() as tmp:
        with runtime_settings(SHARD_ROUNDS_PER_DISPATCH=1, ENGINE_PREFETCH=True,
                              CHECKPOINT_DIR=tmp, CHECKPOINT_EVERY_WINDOWS=2):
            killed = fl_learner(0)
            killed.set_model(phase_model(FL_SEED))
            killed.set_data(shard)
            killed.local_rounds = 2
            killed.fit()
            state, meta = EngineCheckpointer(tmp).restore()
        if meta["step"] != 2 or state["rounds_done"] != 2:
            raise AssertionError(f"{tag}: checkpoint at step {meta['step']}")
        with runtime_settings(SHARD_ROUNDS_PER_DISPATCH=1, ENGINE_PREFETCH=True):
            whole = fl_learner(0)
            whole.set_model(phase_model(FL_SEED))
            whole.set_data(shard)
            whole.local_rounds = 4
            final = dict(tree_items(whole.fit().get_parameters()))
            resumed = VmapFederation(whole.get_model().module, FL_LOCAL, learning_rate=0.1,
                                     seed=0, device=PHASE_DEVICE)
            p = resumed.engine.import_state(state)["params"]
            for widx in (2, 3):
                xs, ys = whole._window_data(widx, widx, 1)
                p, _ = resumed.run_rounds(p, xs, ys, n_rounds=1)
            torch.cuda.synchronize()
    same = all(torch.equal(v[0], final[path]) for path, v in tree_items(p))
    if not same:
        raise AssertionError(f"{tag}: the resumed run's bytes differ from the uninterrupted run's")
    return {"restack": {"tier": [FL_LOCAL, 2 * FL_LOCAL],
                        "launches_by_node_count": {k: {str(n): c for n, c in v.items()}
                                                   for k, v in restack_counts.items()}},
            "resume": {"byte_identical": True, "checkpoint_step": meta["step"]}}


def sim1m(card: str) -> dict:
    """18d, sim1m (bench.py:946-1017): a census of 1,000,000 clients, K 100
    sampled a round as the engine's rows (MLP(16) on 8×8 inputs, 10% of
    the cohort cut as stragglers), 3 timed rounds after a warm-up, each
    round checkpointed through EngineCheckpointer; the restore gives the
    population back exactly; RSS growth under 256 MB; no port kernel."""
    import resource

    eng = FederationEngine(MLP(hidden_sizes=(16,), out_channels=10), POP_K, seed=0,
                           learning_rate=0.1, device=PHASE_DEVICE)
    pop = ClientPopulation(registered=POP_CENSUS, sample=POP_K, seed=0)
    eng.attach_population(pop)
    glob = tree_map(lambda leaf: leaf[0].clone(), eng.unpad(eng.init_params((8, 8))))
    bpm = compression.wire_bytes_per_model(glob, *DENSE)
    rng = np.random.default_rng(0)
    xs = rng.random((POP_K, 1, 16, 8, 8), np.float32)
    ys = rng.integers(0, 10, (POP_K, 1, 16)).astype(np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = EngineCheckpointer(tmp)

        def one_round(g):
            ids = pop.begin_round()
            w = pop.round_weights(ids, cutoff_frac=0.1)
            p = eng.broadcast_params(g)
            dx, dy = eng.shard_data(xs, ys)
            p, losses = eng.run_rounds(p, dx, dy, weights=w, donate=False)
            pop.complete_round(ids, w, losses.cpu().numpy()[:POP_K])
            ckpt.save(eng.export_state(p), step=pop.round)
            return tree_map(lambda leaf: leaf[0].clone(), eng.unpad(p))

        rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        reset_launches()
        glob = one_round(glob)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(POP_ROUNDS):
            glob = one_round(glob)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        state, _ = ckpt.restore()
    launches = read_launches()
    eng2 = FederationEngine(MLP(hidden_sizes=(16,), out_channels=10), POP_K, seed=0,
                            learning_rate=0.1, device=PHASE_DEVICE)
    eng2.import_state(state)
    got = eng2.population
    exact = (got is not None and got.clients == pop.clients and got.round == pop.round
             and got.state_export() == pop.state_export())
    delta_mb = max(0.0, (rss1 - rss0) / 1024.0)
    if not exact or delta_mb >= 256.0 or any(launches.values()):
        raise AssertionError(f"sim1m: checkpoint exact {exact}, RSS +{delta_mb:.1f} MB, "
                             f"launches {launches}")
    if not all(torch.isfinite(v).all() for _, v in tree_items(glob)):
        raise AssertionError("sim1m: non-finite global model")
    return {"card": card, "registered": POP_CENSUS, "sampled": POP_K, "rounds": POP_ROUNDS,
            "rounds_per_s": POP_ROUNDS / wall, "exchange_bytes_per_round": int(POP_K * bpm),
            "touched": pop.touched, "coverage": pop.coverage, "fairness": pop.fairness,
            "rss_delta_mb": delta_mb, "ckpt_roundtrip_exact": True}


def sim1000(card: str) -> dict:
    """18d, sim1000 (bench.py:3689-3722): VmapFederation(MLP(64)) over 1,000
    nodes of one batch of 32 (28×28), about 10% elected a round; rounds/s
    over S1K_ROUNDS rounds after 2 warm-up rounds; no port kernel."""
    fed = VmapFederation(MLP(hidden_sizes=(64,), out_channels=10), S1K_NODES,
                         learning_rate=0.1, seed=0, device=PHASE_DEVICE)
    p = fed.init_params((28, 28))
    rng = np.random.default_rng(0)
    xs, ys = fed.shard_data(rng.random((S1K_NODES, 1, S1K_BATCH, 28, 28), np.float32),
                            rng.integers(0, 10, (S1K_NODES, 1, S1K_BATCH)).astype(np.int32))
    w = (rng.random(S1K_NODES) < 0.1).astype(np.float32)
    reset_launches()
    for _ in range(2):
        p, losses = fed.round(p, xs, ys, weights=w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(S1K_ROUNDS):
        p, losses = fed.round(p, xs, ys, weights=w)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if any(launches.values()) or not torch.isfinite(losses).all():
        raise AssertionError(f"sim1000: launches {launches}, losses finite "
                             f"{bool(torch.isfinite(losses).all())}")
    return {"card": card, "nodes": S1K_NODES, "elected": int(w.sum()), "rounds": S1K_ROUNDS,
            "rounds_per_s": S1K_ROUNDS / wall}


def isolated_card_fit(card: str) -> dict:
    """One fit of a learner of the cell through the pool's isolation path
    (SIM_PROCESS_ISOLATION: a spawned worker process that fits on the
    card), within rtol 1e-6 of the same learner's inline fit in this
    process; every leaf it returns on the card."""
    inline = sp_learner(BF_SEED, "sp-iso")
    iso = sp_learner(BF_SEED, "sp-iso")
    for ln in (inline, iso):
        ln.set_epochs(1)
    inline.fit()
    SuperLearnerPool.reset()
    t0 = time.perf_counter()
    with runtime_settings(DISABLE_SIMULATION=False, SIM_PROCESS_ISOLATION=True):
        try:
            VirtualNodeLearner(iso).fit()
            stats = pool_stats()
        finally:
            isolated.shutdown()
    wall = time.perf_counter() - t0
    want = dict(tree_items(inline.get_model().get_parameters()))
    err = 0.0
    for path, v in tree_items(iso.get_model().get_parameters()):
        if v.device.type != torch.device(PHASE_DEVICE).type:
            raise AssertionError(f"isolated fit: {path} on {v.device}")
        torch.testing.assert_close(v, want[path], rtol=1e-6, atol=1e-7,
                                   msg=lambda m, p=path: f"isolated fit: {p}: {m}")
        err = max(err, (v - want[path]).abs().max().item())
    if stats["singles"] != 1 or stats["batched_dispatches"]:
        raise AssertionError(f"isolated fit: pool {stats}")
    return {"card": card, "max_abs_diff": err, "wall_s": wall, "pool": stats}


def pooled_experiment() -> None:
    """A 1-round seeded experiment of ten CNN Nodes with the pool on
    (phase 14's recipe): the profiled pooled round."""
    SuperLearnerPool.reset()
    with runtime_settings(DISABLE_SIMULATION=False, TRAIN_SET_SIZE=SP_NODES, ELECTION="hash"):
        run_seeded_experiment(BF_SEED, SP_NODES, 1, epochs=BF_EPOCHS, model_fn=phase_model,
                              data_fn=cifar_data_fn(BF_SAMPLES, SP_NODES, BF_TEST),
                              samples_per_node=BF_SAMPLES, batch_size=BF_BATCH,
                              learning_rate=0.1, timeout=300.0, device=PHASE_DEVICE)


def simulation_kernel_rows() -> dict:
    """Both conv kernels at the simulation plane's shapes (both CNN layers,
    N 16 B 25: the pooled ten-node train set; N 8 B 25: a rank's shard of
    it in phase 25; N 8 B 32: FederationLearner) through
    :func:`conv_layer_rows`: wgmma, the plain versions, timed."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    return {f"N={n} B={b}": conv_layer_rows(n, b, gen)
            for n, b in ((SP_BUCKET, BF_BATCH), (PS_ROWS, BF_BATCH), (FL_LOCAL, FL_BATCH))}


def simulation_plane_path(card: str, byzantine_fed: dict, async_fed: dict) -> dict:
    """Phase 18: 18a-18d, the isolated fit and the kernel rows, each logged
    as it passes."""
    out = {}
    parts = (("kernel_rows", lambda c: simulation_kernel_rows()),
             ("pooled_byzantine", lambda c: pooled_byzantine(c, byzantine_fed)),
             ("pooled_async", lambda c: pooled_async(c, async_fed)),
             ("federation_learner", fl_federation), ("fl_restack_resume", fl_restack_and_resume),
             ("sim1m", sim1m), ("sim1000", sim1000), ("isolated_fit", isolated_card_fit))
    for part, run in parts:
        t0 = time.perf_counter()
        out[part] = run(card)
        out[part]["phase_s"] = time.perf_counter() - t0
        log(f"simulation plane ({part}; every check passed): " + json.dumps(out[part]))
    return out


def simulation_launches(sp: dict, name: str) -> dict:
    """Phase 18's launches of one conv kernel, by arm."""
    out = {f"18a {arm}": r["launches"][name] for arm, r in sp["pooled_byzantine"]["arms"].items()}
    out.update({f"18b {arm}": sp["pooled_async"][arm]["launches"][name]
                for arm in ("warm", "sync", "async")})
    out["18c federation"] = sp["federation_learner"]["launches"][name]
    return out


# ---- the observatory (phase 19) ----------------------------------------------

# The profiling tier's federation (bench.py:1291-1349): 4 Nodes of the
# digits MLP (hidden 32) on synthetic_mnist, 5 rounds, hash election, seed
# 2626, the pool on as in the reference's test profile.
OBS_NODES, OBS_ROUNDS, OBS_SEED = 4, 5, 2626
# The fleetobs tier's overhead loop (bench.py:1094-1155): K 64 of a 100k
# census, MLP (256, 256) on 8×8, 10 rounds a median; its census sweep.
OBS_K, OBS_CENSUS, OBS_R = 64, 100_000, 10
OBS_SWEEP = (100_000, 1_000_000)
# bench.py's watchdog drive: a healthy run at 2.5 rounds/s and a 20%
# regression after four windows, against rate >= 2.4.
WD_TARGET = "rate(tpfl_engine_rounds_total) >= 2.4"
WD_HEALTHY, WD_INJECTED = [2.5] * 8, [2.5] * 4 + [2.0] * 6
# Live against analytic MFU, and the HBM peak, must agree within this.
MFU_RTOL = 0.05


def compile_probe() -> dict:
    """19a: the profiling tier's shape-churn probe on the card (8, 8, 16,
    32, 64 elements at a storm threshold of 3): 4 signatures, one
    signature hit, a ``recompile_storm`` event in ``_profiling``'s ring."""
    profiling.observatory.reset()
    telemetry.flight.clear(profiling.PROFILING_RING)
    with setting("PROFILING_ENABLED", True), setting("PROFILING_RECOMPILE_WARN", 3):
        probe = profiling.observatory.wrap(lambda x: (x * 2.0).sum(), "chip_probe")
        for n in (8, 8, 16, 32, 64):
            probe(torch.zeros((n,), dtype=torch.float32, device="cuda")).item()
    sigs = profiling.observatory.signature_counts().get("chip_probe", 0)
    storms = [e for e in telemetry.flight.snapshot(profiling.PROFILING_RING)
              if e.get("name") == "recompile_storm" and e.get("fn") == "chip_probe"]
    hits = telemetry.metrics.value("tpfl_compile_signature_hits_total", {"fn": "chip_probe"})
    profiling.observatory.reset()
    if sigs != 4 or len(storms) != 1 or storms[0]["signatures"] != 3 or hits != 1.0:
        raise AssertionError(f"compile probe: {sigs} signatures, storms {storms}, {hits} hits")
    return {"probe_signatures": sigs, "storm_detected": True, "signature_hits": hits}


def obs_federation(profiled: bool, tag: str) -> dict:
    """One run of 19b's federation; the round records when profiled."""
    Settings.PROFILING_ENABLED = profiled
    profiling.rounds.reset()
    ds = synthetic_mnist(n_train=150 * OBS_NODES, n_test=30, seed=0, noise=0.6)
    parts = ds.generate_partitions(OBS_NODES, RandomIIDPartitionStrategy, seed=1)
    module = MLP(hidden_sizes=(32,), out_channels=10)
    nodes = [Node(TpflModel(module, init_params(module, (28, 28), seed=7)), parts[i],
                  addr=f"{tag}-{i}-{uuid.uuid4().hex[:6]}", learning_rate=0.05, batch_size=32)
             for i in range(OBS_NODES)]
    try:
        start_federation(nodes, "STAR")
        t0 = time.monotonic()
        nodes[0].set_start_learning(rounds=OBS_ROUNDS, epochs=1)
        wait_to_finish(nodes, timeout=240)
        elapsed = time.monotonic() - t0
        check_history(tag, nodes, OBS_ROUNDS)
    finally:
        for nd in nodes:
            nd.stop()
    out = {"rounds": OBS_ROUNDS, "elapsed_s": elapsed, "rounds_per_s": OBS_ROUNDS / elapsed}
    if profiled:
        out["attribution"] = profiling.rounds.attribution()
    return out


def profiling_ab() -> dict:
    """19b: the profiling tier's A/B — one discarded warm-up run, then the
    federation with ``PROFILING_ENABLED`` off and on. Gated: every round
    attributed, each round's coverage at least 0.95. Reported: the
    profiled run's cost and the component fractions."""
    SuperLearnerPool.reset()
    try:
        with runtime_settings(DISABLE_SIMULATION=False, ELECTION="hash", SEED=OBS_SEED):
            obs_federation(False, "prof-warm")
            off = obs_federation(False, "prof-off")
            on = obs_federation(True, "prof-on")
    finally:
        SuperLearnerPool.reset()
        profiling.rounds.reset()
    recs = on.pop("attribution")
    if len(recs) != OBS_NODES * OBS_ROUNDS:
        raise AssertionError(f"profiling A/B: {len(recs)} round records, expected "
                             f"{OBS_NODES * OBS_ROUNDS}")
    wall = sum(r["wall"] for r in recs)
    comps = sorted({c for r in recs for c in r["parts"]})
    coverage_min = min(r["coverage"] for r in recs)
    if coverage_min < 0.95:
        raise AssertionError(f"profiling A/B: a round's coverage is {coverage_min}")
    return {"seed": OBS_SEED, "unprofiled": off, "profiled": on,
            "overhead_frac": 1.0 - on["rounds_per_s"] / off["rounds_per_s"],
            "rounds_attributed": len(recs), "coverage_min": coverage_min,
            "component_fracs": {c: sum(r["parts"].get(c, 0.0) for r in recs) / wall
                                for c in comps}}


def live_mfu(label: str, fed_args: tuple, analytic_rounds_s: float, input_shape: tuple,
             samples: int, kernels: dict) -> dict:
    """19c: more 3-round windows of a main path, timed as the reference's
    bench times its live MFU (``profiling.best_of_wall_donated``: a warm
    window, then the best of 2, each training from the last one's fold),
    with every launch count set to 0 just before them; the best per-round
    seconds and the analytic FLOPs go through ``CostModel.record_round``.
    Gated: the ``tpfl_mfu`` gauge within ``MFU_RTOL`` of the analytic
    column (the path's measured rounds/s × the same FLOPs over the
    card's peak), and the windows' launches, each on its wgmma kernel."""
    fed, params, xs, ys, state = fed_args
    flops = profiling.cost_model.analytic_train_flops(fed.module, input_shape, samples)
    peak = profiling.peak_flops(torch.device("cuda"))
    if flops is None or peak is None:
        raise AssertionError(f"live MFU ({label}): no analytic FLOPs or no peak for "
                             f"{torch.cuda.get_device_name(0)}")

    def window(p: dict) -> tuple:
        return fed.run_rounds(p, xs, ys, epochs=EPOCHS, n_rounds=N_ROUNDS, **state)

    torch.cuda.synchronize()
    reset_launches()
    wall, out = profiling.best_of_wall_donated(window, (params,),
                                               rebind=lambda o, a: (carry(o)[0],), n=2)
    torch.cuda.synchronize()
    launches, wgmma = read_launches(), read_wgmma_launches(kernels)
    check_main_path(carry(out)[0], carry(out)[2], launches,
                    {**dict.fromkeys(WRAPPERS, 0), **{k: 3 * v for k, v in kernels.items()}})
    check_all_wgmma(f"live MFU ({label})", launches, wgmma)
    live = profiling.cost_model.record_round(label, flops, wall / N_ROUNDS)
    gauge = telemetry.metrics.value("tpfl_mfu", {"program": label})
    analytic = analytic_rounds_s * flops / peak
    rel = abs(gauge - analytic) / analytic
    if live is None or gauge != live or rel > MFU_RTOL:
        raise AssertionError(f"live MFU ({label}): gauge {gauge}, analytic {analytic}, "
                             f"rel {rel}")
    return {"round_tflop": flops / 1e12, "peak_tflops": peak / 1e12,
            "analytic_rounds_per_s": analytic_rounds_s, "live_rounds_per_s": N_ROUNDS / wall,
            "analytic_mfu": analytic, "live_mfu": gauge, "rel_diff": rel,
            "launches": launches, "wgmma_launches": wgmma}


def hbm_peak(fed_args: tuple) -> dict:
    """19d: the tracker and the allocator's peak reset, one CNN window,
    then a sample. Gated: the tracker's peak equals
    ``torch.cuda.max_memory_allocated()`` and its gauges are in the
    registry."""
    fed, params, xs, ys, state = fed_args
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiling.hbm.reset()
    reset_launches()
    fed.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=N_ROUNDS, **state)
    torch.cuda.synchronize()
    launches = read_launches()
    samples = profiling.hbm.sample()
    want = torch.cuda.max_memory_allocated()
    dev = str(torch.cuda.current_device())
    peak = profiling.hbm.peaks().get(dev)
    gauges = telemetry.metrics.fold()["gauges"]
    keys = [(name, (("device", dev),)) for name in ("tpfl_hbm_bytes_in_use",
                                                    "tpfl_hbm_peak_bytes")]
    if peak != float(want) or not all(k in gauges for k in keys):
        raise AssertionError(f"HBM tracker: peak {peak} against max_memory_allocated {want}, "
                             f"gauges {[k in gauges for k in keys]}")
    return {"peak_mb": peak / 1e6, "in_use_mb": dict((d, u / 1e6) for d, u, _ in samples),
            "max_memory_allocated_mb": want / 1e6, "launches": launches}


def fleet_rank(rank: int) -> None:
    """19e's worker (``chip_smoke.py --fleet-rank R``): a seeded 2-round
    engine window of 8 MLP nodes on the card with the telemetry carry on;
    prints its receipt, the deterministic series of its registry as a
    fleet snapshot, as its last line."""
    from tpfl_torch.management import fleetobs

    with setting("ENGINE_TELEMETRY", True):
        rng = np.random.default_rng(rank)
        xs = rng.random((8, 1, 8, 8, 8), np.float32)
        ys = rng.integers(0, 10, (8, 1, 8)).astype(np.int32)
        w = np.ones((8,), np.float32)
        w[::4] = 0.0
        eng = FederationEngine(MLP(hidden_sizes=(8,), out_channels=10), 8, seed=rank)
        p = eng.init_params((8, 8))
        dx, dy = eng.shard_data(xs, ys)
        eng.run_rounds(p, dx, dy, weights=w, n_rounds=2)
        torch.cuda.synchronize()
    snap = fleetobs.snapshot(origin=str(rank), prefixes=fleetobs.DETERMINISTIC_PREFIXES)
    print(json.dumps({"metrics_snapshot": snap}))


def fleet_launches(launches: int) -> list[str]:
    """``launches`` launches of two ranks, every rank a subprocess on the
    card and all of them started together; the Prometheus text of each
    launch's receipts' fold."""
    from tpfl_torch.management import fleetobs

    procs = [[subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--fleet-rank",
                                str(r)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True) for r in (0, 1)] for _ in range(launches)]
    texts = []
    try:
        for i, launch in enumerate(procs):
            receipts = []
            for r, proc in enumerate(launch):
                out, err = proc.communicate(timeout=300)
                if proc.returncode != 0:
                    raise AssertionError(f"fleet launch {i} rank {r} exited {proc.returncode}: "
                                         f"{err[-2000:]}")
                receipts.append(json.loads(out.strip().splitlines()[-1]))
            texts.append(fleetobs.fold_receipts(receipts).render_prometheus())
    finally:
        for proc in (p for launch in procs for p in launch):
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    return texts


def watchdog_drive(rates: list) -> "int | None":
    """bench.py's drive: windows after the first below the target until
    the watchdog breaches, None when it never does."""
    from tpfl_torch.management import fleetobs

    reg = telemetry.MetricsRegistry()
    wd = fleetobs.SLOWatchdog(WD_TARGET, registry=reg, node="chip-watchdog")
    wd.evaluate(now=0.0)
    t, after = 0.0, None
    for rate in rates:
        t += 1.0
        reg.counter("tpfl_engine_rounds_total", rate)
        wd.evaluate(now=t)
        if rate < 2.4 and after is None:
            after = 0
        if after is not None:
            after += 1
            if not wd.healthy():
                return after
    return None


def fleet_overhead() -> dict:
    """The observatory's cost in a sampled-population round loop on the
    card (the fleet plane: population fan-out, fleet gauges, a watchdog
    window, a snapshot every 10 rounds), as median round seconds without
    and with it; reported against the reference's 5% budget."""
    from tpfl_torch.management import fleetobs

    eng = FederationEngine(MLP(hidden_sizes=(256, 256), out_channels=10), OBS_K, seed=0)
    pop = ClientPopulation(registered=OBS_CENSUS, sample=OBS_K, seed=0)
    eng.attach_population(pop)
    rng = np.random.default_rng(0)
    xs = rng.random((OBS_K, 1, 64, 8, 8), np.float32)
    ys = rng.integers(0, 10, (OBS_K, 1, 64)).astype(np.int32)
    state = {"p": eng.init_params((8, 8))}
    dx, dy = eng.shard_data(xs, ys)
    with tempfile.TemporaryDirectory() as d:
        pub = fleetobs.FleetPublisher("chip", directory=d)
        wd = fleetobs.SLOWatchdog("rate(tpfl_pop_folded_total) >= 0.0", node="chip-overhead")

        def one_round(fleet_plane: bool, r: int) -> None:
            ids = pop.begin_round()
            w = pop.round_weights(ids, cutoff_frac=0.1)
            state["p"], _ = eng.run_rounds(state["p"], dx, dy, weights=w)
            torch.cuda.synchronize()
            pop.complete_round(ids, w)
            if fleet_plane:
                fleetobs.emit_fleet_gauges("chip")
                wd.evaluate()
                if r % 10 == 0:
                    pub.publish_once()

        def median_round_s(fleet_plane: bool) -> float:
            times = []
            for r in range(OBS_R):
                t0 = time.monotonic()
                one_round(fleet_plane, r + 1)
                times.append(time.monotonic() - t0)
            return sorted(times)[len(times) // 2]

        one_round(True, 0)
        base_s = median_round_s(False)
        fleet_s = median_round_s(True)
    overhead = max(0.0, fleet_s - base_s) / base_s
    # What a watchdog window folds: every series of the process registry.
    folded = telemetry.metrics.fold()
    return {"base_round_s": base_s, "fleet_round_s": fleet_s, "rounds_per_s": 1.0 / fleet_s,
            "overhead_frac": overhead, "within_5pct_budget": overhead <= 0.05,
            "registry_series": sum(len(folded[k]) for k in ("counters", "gauges", "histograms"))}


def population_sketch() -> dict:
    """The census sweep at K 100, three rounds each. Gated: the coverage
    bitset holds exactly ``(census + 7) // 8`` bytes. Reported: the
    peak-RSS growth."""
    import resource

    def sweep(census: int) -> ClientPopulation:
        pop = ClientPopulation(registered=census, sample=100, seed=5)
        for _ in range(3):
            ids = pop.begin_round()
            pop.complete_round(ids, pop.round_weights(ids, 0.1))
        return pop

    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    pops = [sweep(c) for c in OBS_SWEEP]
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    sizes = [p._coverage.nbytes for p in pops]
    if sizes != [(c + 7) // 8 for c in OBS_SWEEP]:
        raise AssertionError(f"population sketch: bitsets of {sizes} bytes for {OBS_SWEEP}")
    return {"census_sweep": list(OBS_SWEEP), "bitset_bytes": sizes,
            "rss_delta_mb": max(0.0, (rss1 - rss0) / 1024.0),
            "coverage_1m": pops[-1].coverage, "fairness_1m": pops[-1].fairness}


def fleet_observatory() -> dict:
    """19e: fleet folds byte-identical across two launches of two ranks
    (with both origin labels and engine series), the watchdog flagging a
    20% rounds/s regression within 2 windows and silent without it, the
    overhead, the population sketch."""
    texts = fleet_launches(2)
    if texts[0] != texts[1]:
        raise AssertionError("fleet fold: the two launches' Prometheus texts differ")
    if not ('origin="0"' in texts[0] and 'origin="1"' in texts[0]
            and "tpfl_engine_rounds_total" in texts[0]):
        raise AssertionError("fleet fold: origin labels or engine series missing")
    silent, caught = watchdog_drive(WD_HEALTHY), watchdog_drive(WD_INJECTED)
    if silent is not None or caught is None or caught > 2:
        raise AssertionError(f"watchdog: uninjected {silent}, injected {caught}")
    return {"merged_byte_identical": True, "fold_bytes": len(texts[0].encode()),
            "fold_series": sum(1 for ln in texts[0].splitlines() if not ln.startswith("#")),
            "uninjected_silent": True, "windows_to_breach": caught,
            "overhead": fleet_overhead(), "pop_sketch": population_sketch()}


def web_and_monitor() -> dict:
    """19f: ``MetricsHTTPServer`` on loopback — ``/metrics``,
    ``/metrics.json``, ``/fleet.json`` (a published snapshot folded) and
    ``/healthz``, 200 and then 503 once the watchdog breaches — and one
    ``NodeMonitor`` period emitting the CPU, RAM, network and
    device-memory metrics."""
    import urllib.error
    import urllib.request

    from tpfl_torch.management import fleetobs
    from tpfl_torch.management.node_monitor import NodeMonitor
    from tpfl_torch.management.web_services import MetricsHTTPServer

    def get(url: str) -> tuple[int, bytes]:
        try:
            with urllib.request.urlopen(url, timeout=5) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    reg = telemetry.MetricsRegistry()
    reg.gauge("tpfl_engine_idle_gap_seconds", 2.0)
    wd = fleetobs.SLOWatchdog("gauge(tpfl_engine_idle_gap_seconds) <= 0.5", registry=reg)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        fleetobs.FleetPublisher("chip", directory=d).publish_once()
        srv = MetricsHTTPServer(registry=reg, watchdog=wd, fleet_dir=d)
        base = f"http://127.0.0.1:{srv.start()}"
        try:
            for path in ("/metrics", "/metrics.json", "/fleet.json", "/healthz"):
                status, body = get(base + path)
                out[path] = {"status": status, "bytes": len(body)}
            for t in range(int(Settings.SLO_BREACH_WINDOWS) + 1):
                wd.evaluate(now=float(t))
            status, body = get(base + "/healthz")
            out["/healthz after breach"] = {"status": status, "bytes": len(body)}
        finally:
            srv.stop()
    if [v["status"] for v in out.values()] != [200, 200, 200, 200, 503]:
        raise AssertionError(f"metrics server: {out}")
    node = f"chip-monitor-{uuid.uuid4().hex[:6]}"
    dev = torch.cuda.current_device()
    want = {f"tpfl_system_{m}" for m in ("cpu_percent", "ram_percent", "net_in_bytes_per_s",
                                         "net_out_bytes_per_s", f"hbm_bytes_in_use_dev{dev}",
                                         f"hbm_peak_bytes_dev{dev}")}
    with setting("RESOURCE_MONITOR_PERIOD", 0.2):
        mon = NodeMonitor(node)
        mon.start()
        try:
            deadline = time.monotonic() + 10
            while True:
                got = {k[0]: v for k, v in telemetry.metrics.fold()["gauges"].items()
                       if k[1] == (("node", node),)}
                if want <= set(got) or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            mon.stop()
            mon.join(timeout=5)
    if not want <= set(got) or not 0.0 <= got["tpfl_system_cpu_percent"] <= 100.0:
        raise AssertionError(f"node monitor: {sorted(got)}")
    out["node_monitor"] = {k.removeprefix("tpfl_system_"): v for k, v in sorted(got.items())}
    return out


def observatory_path(card: str, cnn: dict, cnn_args: tuple, lm: dict, lm_args: tuple) -> dict:
    """Phase 19: 19a-19f, each logged as it passes."""
    out = {}
    samples = N_NODES * N_BATCHES * BATCH * EPOCHS
    sequences = T_NODES * T_BATCHES * T_BATCH * EPOCHS
    steps = N_BATCHES * EPOCHS * N_ROUNDS
    # The profiled federation (19b) runs last: the LM window, nearly
    # host-bound, once read 22% slow when timed right after it.
    parts = (
        ("compile", compile_probe),
        ("mfu_cnn", lambda: live_mfu("cnn_main_path", cnn_args, cnn["rounds_per_s"],
                                     (32, 32, 3), samples,
                                     {"conv_dw": 2 * steps, "conv_dx": steps})),
        ("mfu_lm", lambda: live_mfu("transformer_main_path", lm_args, lm["rounds_per_s"],
                                    (T_SEQ,), sequences,
                                    dict.fromkeys(FLASH_KERNELS, LM_KW["n_layers"] * T_BATCHES
                                                  * EPOCHS * N_ROUNDS))),
        ("hbm", lambda: hbm_peak(cnn_args)),
        ("fleet", fleet_observatory),
        ("web_and_monitor", web_and_monitor),
        ("profiling_ab", profiling_ab),
    )
    for part, run in parts:
        t0 = time.perf_counter()
        out[part] = run()
        out[part]["phase_s"] = time.perf_counter() - t0
        log(f"observatory ({part}; every check passed): {card}: " + json.dumps(out[part]))
    return out


# ---- phase 20: sequence, pipeline and expert parallelism ---------------------------

# The bench's attention and transformer tiers (bench.py:3554-3685): B 1,
# H 8, D 128 attention at S 8,192 and 32,768, causal, fwd + bwd; the
# reference's iteration counts (8k: 192, 32k: 16).
AT_B, AT_H, AT_D = 1, 8, 128
AT_ITERS = {8192: 192, 32768: 16}
# The plain arms (blockwise, the einsum ring) at 8k: 24 steps a loop, not the
# reference's 192 (at 47-243 ms a step they took ~110 s of the phase).
AT_PLAIN_ITERS = 24
AT_SHORT, AT_LONG = AT_ITERS
RING_BLOCKS = 4  # 20a: emulated ranks of the 8k sequence
LM32_KW = dict(vocab=256, dim=512, heads=8, n_layers=4, max_len=32768)
LM32_SEQ, LM32_STEPS, LM32_LR, LM32_MOMENTUM = 32768, 5, 1e-2, 0.9
PIPE_MICRO, PIPE_SEQ = 4, 2048  # 20e: microbatches of [1, 2048, 512]
MOE_TOKENS, MOE_HIDDEN = 4096, 2048
BF16_TOL = 2.0 ** -7  # the flash kernel phase's bf16 tolerance (rtol and of max |ref|)


def attention_inputs(s: int, seed: int) -> tuple:
    """q, k, v and a cotangent [B, S, H, D] bf16 from a seeded generator."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(AT_B, s, AT_H, AT_D, device="cuda", generator=gen)
                 .to(torch.bfloat16) for _ in range(4))


def flash_grads(attn, q, k, v, do) -> tuple:
    """attn(q, k, v) and the gradients of <attn(q, k, v), do>."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = attn(*leaves)
    out.backward(do)
    return (out.detach(), *(t.grad for t in leaves))


def ring_arithmetic(causal: bool) -> dict:
    """20a: the flash ring's steps over RING_BLOCKS emulated ranks of an
    8k sequence on one card — each rank's forward steps through
    ``flash_block_fwd`` and ``_ring_merge``, then its backward steps
    through ``flash_block_bwd`` with the rank's global lse / delta, dK / dV
    summed into the block they belong to — against ``flash_attention`` over
    the whole sequence at the kernel phase's bf16 tolerance. One
    off-diagonal (non-causal, f32 out) step is held to the plain versions
    too (``check_rms``, 2^-12)."""
    from tpfl_torch.parallel.ring_attention import _ring_merge, _ring_steps

    s, n = AT_SHORT, RING_BLOCKS
    q, k, v, do = attention_inputs(s, 20)
    size = s // n
    blk = [lambda t, r=r: t[:, r * size:(r + 1) * size].contiguous() for r in range(n)]
    qb, kb, vb, dob = ([b(t) for b in blk] for t in (q, k, v, do))
    outs, lses = [], []
    for my in range(n):
        o = torch.zeros((AT_B, size, AT_H, AT_D), dtype=torch.float32, device="cuda")
        lse = torch.full((AT_B, AT_H, size), float("-inf"), device="cuda")
        for t, diag in _ring_steps(n, my, causal):
            src = (my - t) % n
            o, lse = _ring_merge(o, lse, *fk.flash_block_fwd(qb[my], kb[src], vb[src], diag))
        outs.append(o.to(torch.bfloat16))
        lses.append(lse)
    dq = [torch.zeros_like(b, dtype=torch.float32) for b in qb]
    dk = [torch.zeros_like(b, dtype=torch.float32) for b in kb]
    dv = [torch.zeros_like(b, dtype=torch.float32) for b in vb]
    for my in range(n):
        delta = (dob[my].float() * outs[my].float()).sum(-1).transpose(1, 2)
        for t, diag in _ring_steps(n, my, causal):
            src = (my - t) % n
            dq_c, dk_c, dv_c = fk.flash_block_bwd(qb[my], kb[src], vb[src], dob[my], lses[my],
                                                  delta, diag)
            dq[my] += dq_c
            dk[src] += dk_c
            dv[src] += dv_c
    want = flash_grads(lambda a, b, c: fk.flash_attention(a, b, c, causal=causal), q, k, v, do)
    got = [torch.cat(parts, dim=1).to(torch.bfloat16) for parts in (outs, dq, dk, dv)]
    errs = {name: check_close(f"ring arithmetic (causal={causal}) {name}", g, w, BF16_TOL,
                              BF16_TOL)
            for name, g, w in zip(("out", "dq", "dk", "dv"), got, want)}
    # One off-diagonal step (rank 3 attending block 1 fully), f32 outputs,
    # against the plain versions with the rank's global lse / delta.
    my, src = n - 1, 1
    fold = [fk._fold_heads(t) for t in (qb[my], kb[src], vb[src], dob[my])]
    rows = (lses[my].reshape(AT_B * AT_H, size),
            (dob[my].float() * outs[my].float()).sum(-1).transpose(1, 2)
            .reshape(AT_B * AT_H, size).contiguous())
    o32, _ = fk.flash_fwd(*fold[:3], False, out_dtype=torch.float32)
    o32_ref, _ = fk.flash_fwd_plain(*fold[:3], False, out_dtype=torch.float32)
    args = (*fold, *rows, False)
    step = {"flash_fwd": check_rms("ring step flash_fwd (f32 out)", o32, o32_ref, 2.0 ** -12),
            "flash_dq": check_rms("ring step flash_dq (f32 out)",
                                  fk.flash_dq(*args, out_dtype=torch.float32),
                                  fk.flash_dq_plain(*args, out_dtype=torch.float32), 2.0 ** -12)}
    step["flash_dkv"] = max(check_rms(f"ring step flash_dkv {name} (f32 out)", g, w, 2.0 ** -12)
                            for name, g, w in zip(
                                ("dk", "dv"), fk.flash_dkv(*args, out_dtype=torch.float32),
                                fk.flash_dkv_plain(*args, out_dtype=torch.float32)))
    return {"max_abs_err": errs, "off_diagonal_step_f32_rel_rms_err": step}


def ring_on_mesh(mesh) -> dict:
    """20b: ``make_ring_attention`` on the one-rank ``sp`` mesh, as the
    bench builds it, at S 8k and 32k: output and gradients against
    ``flash_attention`` (expected equal: the one-rank ring is its forward
    and backward through the ring's f32 merge); ``impl="auto"`` on CUDA
    tensors takes the flash inner."""
    from tpfl_torch.parallel.ring_attention import make_ring_attention

    out = {}
    for s in AT_ITERS:
        q, k, v, do = attention_inputs(s, 21)
        ring = make_ring_attention(mesh, causal=True, impl="flash")
        got = flash_grads(ring, q, k, v, do)
        want = flash_grads(lambda a, b, c: fk.flash_attention(a, b, c, causal=True),
                           q, k, v, do)
        out[f"{s // 1024}k_max_abs_diff"] = {
            name: check_close(f"ring on the sp mesh S={s} {name}", g, w, BF16_TOL, BF16_TOL)
            for name, g, w in zip(("out", "dq", "dk", "dv"), got, want)}
        del q, k, v, do, got, want
    before = fk.flash_fwd.launches
    q, k, v, _ = attention_inputs(512, 22)
    make_ring_attention(mesh, causal=True)(q, k, v)
    if fk.flash_fwd.launches != before + 1:
        raise AssertionError("impl='auto' on CUDA tensors did not take the flash inner")
    torch.cuda.empty_cache()
    return out


def attention_tier(mesh) -> dict:
    """20c: the bench's attention tier — causal fwd + bwd steps (each
    step's gradients fed back at 1e-6, bench.py:3566-3592) timed by
    ``profiling.timed_loop`` at the reference's iteration counts (the
    plain arms at AT_PLAIN_ITERS): the
    flash kernels, the plain blockwise attention (8k only: its autograd
    residuals at 32k would fill the card), the ring on the one-rank ``sp``
    mesh with the flash inner (8k, 32k) and the einsum inner (8k), and
    the flash-backend SDPA as the yardstick (the port never calls it)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from tpfl_torch.parallel.ring_attention import make_ring_attention

    def sdpa(q, k, v, causal):
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal).transpose(1, 2)

    def step_of(fn):
        def step(c):
            leaves = [t.detach().requires_grad_(True) for t in c]
            loss = fn(*leaves, causal=True).float().pow(2).sum()
            grads = torch.autograd.grad(loss, leaves)
            return tuple((t - 1e-6 * g.to(t.dtype)).detach() for t, g in zip(c, grads))
        return step

    rings = {impl: make_ring_attention(mesh, causal=True, impl=impl) for impl in ("flash", "xla")}
    # (name, fn, sequence lengths, best of, steps a loop): the plain arms'
    # loops take seconds each, so they run once after the warm-up, and
    # AT_PLAIN_ITERS steps long.
    plain = {AT_SHORT: AT_PLAIN_ITERS}
    arms = [("flash", fk.flash_attention, (AT_SHORT, AT_LONG), 3, AT_ITERS),
            ("blockwise", blockwise_attention, (AT_SHORT,), 1, plain),
            ("ring_sp_flash", rings["flash"], (AT_SHORT, AT_LONG), 3, AT_ITERS),
            ("ring_sp_xla", rings["xla"], (AT_SHORT,), 1, plain),
            ("library_sdpa", sdpa, (AT_SHORT, AT_LONG), 3, AT_ITERS)]
    rtt = profiling.measure_dispatch_rtt()
    out, launches = {}, {}
    for name, fn, seqs, best_of, iters in arms:
        for s in seqs:
            carry_in = attention_inputs(s, 23)[:3]
            before = read_launches()
            per_iter, scalar = profiling.timed_loop(step_of(fn), carry_in, (), iters[s],
                                                    rtt=rtt, best_of=best_of)
            if not math.isfinite(float(scalar)):
                raise AssertionError(f"attention tier {name} {s}: non-finite carry")
            key = f"{name}_fwdbwd_{s // 1024}k"
            out[f"{key}_toks_per_sec"] = AT_B * s / per_iter
            out[f"{key}_ms_per_step"] = per_iter * 1e3
            launches[key] = {k: read_launches()[k] - before[k] for k in FLASH_KERNELS}
            del carry_in
            torch.cuda.empty_cache()
    out["launches"] = launches
    return out


class PlainFlashAttention(torch.autograd.Function):
    """``FlashAttention`` with the kernels' plain versions in their place,
    on the card: the yardstick that 20d holds the transformer tier's first
    step to."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        b, _, h, _ = q.shape
        qp, kp, vp = fk._fold_heads(q), fk._fold_heads(k), fk._fold_heads(v)
        o, lse = fk.flash_fwd_plain(qp, kp, vp, causal)
        ctx.save_for_backward(qp, kp, vp, o, lse)
        ctx.causal, ctx.bh = causal, (b, h)
        return fk._unfold_heads(o, b, h)

    @staticmethod
    def backward(ctx, dout):
        qp, kp, vp, o, lse = ctx.saved_tensors
        b, h = ctx.bh
        do = fk._fold_heads(dout.to(qp.dtype))
        delta = (do.float() * o.float()).sum(-1)
        dq = fk.flash_dq_plain(qp, kp, vp, do, lse, delta, ctx.causal)
        dk, dv = fk.flash_dkv_plain(qp, kp, vp, do, lse, delta, ctx.causal)
        return (fk._unfold_heads(dq, b, h), fk._unfold_heads(dk, b, h),
                fk._unfold_heads(dv, b, h), None)


def lm32_step(module, opt):
    """One next-token SGD + momentum step of a one-node TransformerLM:
    ``step((params, trace, loss), tokens) -> (params, trace, loss)``."""
    def step(c, tokens):
        params, trace, _ = c
        live = tree_map(lambda a: a.detach().requires_grad_(True), params)
        logits = module(live, tokens)
        loss = torch.nn.functional.cross_entropy(
            logits[0, :, :-1].reshape(-1, LM32_KW["vocab"]),
            tokens[0, :, 1:].reshape(-1).long())
        grads = torch.autograd.grad(loss, tree_leaves(live))
        params, trace = opt.step(params, tree_unflatten(params, grads), trace)
        return params, trace, loss.detach()
    return step


def transformer_tier(card: str) -> dict:
    """20d: the bench's transformer tier (bench.py:3642-3685) —
    ``TransformerLM(vocab 256, dim 512, heads 8, n_layers 4, max_len
    32768)`` through ``flash_attention`` at one node, B 1, S 32,768, SGD
    lr 1e-2 momentum 0.9 on next-token cross entropy, 5 steps a timed
    loop. The first step's loss and gradient norm against the same step
    through the plain versions (``PlainFlashAttention``); 4 launches of
    each flash kernel a step, all wgmma."""
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (1, 1, LM32_SEQ)).astype(np.int32)).cuda()
    params = stack_params(init_params(TransformerLM(**LM32_KW), (LM32_SEQ,), seed=0,
                                      device="cuda"), 1)
    opt = SGDMomentum(LM32_LR, LM32_MOMENTUM)

    def first_step(attention):
        module = TransformerLM(**LM32_KW, attention_fn=attention)
        live = tree_map(lambda a: a.detach().requires_grad_(True), params)
        logits = module(live, tokens)
        loss = torch.nn.functional.cross_entropy(
            logits[0, :, :-1].reshape(-1, LM32_KW["vocab"]), tokens[0, :, 1:].reshape(-1).long())
        grads = torch.autograd.grad(loss, tree_leaves(live))
        return loss.item(), torch.sqrt(sum(g.float().pow(2).sum() for g in grads)).item()

    plain_loss, plain_norm = first_step(
        lambda q, k, v, causal: PlainFlashAttention.apply(q, k, v, causal))
    before = read_launches()
    loss, norm = first_step(fk.flash_attention)
    one = {k: read_launches()[k] - before[k] for k in WRAPPERS}
    if one != {**dict.fromkeys(WRAPPERS, 0), **dict.fromkeys(FLASH_KERNELS, LM32_KW["n_layers"])}:
        raise AssertionError(f"transformer tier: one step launched {one}")
    # bf16 model: one flipped rounding of an attention output moves every
    # later op, so the kernel and plain steps agree to bf16 resolution.
    if abs(loss - plain_loss) > 1e-3 * abs(plain_loss) or abs(norm - plain_norm) > (
            BF16_TOL * abs(plain_norm)):
        raise AssertionError(f"transformer tier: first step loss / grad norm {loss} / {norm}, "
                             f"plain versions {plain_loss} / {plain_norm}")
    module = TransformerLM(**LM32_KW, attention_fn=fk.flash_attention)
    best_of = 3
    before = read_launches()
    per_step, scalar = profiling.timed_loop(
        lm32_step(module, opt), (params, opt.init(params), torch.zeros((), device="cuda")),
        (tokens,), LM32_STEPS, best_of=best_of)
    launches = {k: read_launches()[k] - before[k] for k in WRAPPERS}
    steps = (best_of + 1) * LM32_STEPS  # timed_loop: a warm-up loop, then best of 3
    want = {**dict.fromkeys(WRAPPERS, 0),
            **dict.fromkeys(FLASH_KERNELS, LM32_KW["n_layers"] * steps)}
    if launches != want:
        raise AssertionError(f"transformer tier: {launches} over {steps} steps")
    if not math.isfinite(float(scalar)):
        raise AssertionError("transformer tier: non-finite carry")
    return {"card": card, "model": {**LM32_KW, "attention_fn": "flash_attention"},
            "seq": LM32_SEQ, "steps_per_loop": LM32_STEPS,
            "transformer_32k_train_toks_per_sec": LM32_SEQ / per_step,
            "ms_per_step": per_step * 1e3, "first_step": {
                "loss": loss, "plain_loss": plain_loss, "grad_norm": norm,
                "plain_grad_norm": plain_norm},
            "launches": {k: launches[k] for k in FLASH_KERNELS}, "steps": steps,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def pipeline_and_moe(meshes: dict) -> dict:
    """20e at axis size 1: (a) a 1-stage ``make_pipeline_trainer`` over
    the LM tier's 4 ``TransformerBlock``s (dim 512, 8 heads, bf16,
    ``flash_attention``), 4 microbatches of [1, 2048, 512], 2 steps,
    against the blocks applied in sequence with the same SGD (losses
    and params at rtol 1e-5, atol 1e-6: gradient sums in another order);
    (b) one ``make_moe_train_layer`` step (k 1, capacity = the tokens) of
    the LM's FFN width, 512 -> 2048 -> 512, f32, against its plain
    single-expert computation (outputs, loss, updated params)."""
    from tpfl_torch.parallel.moe import make_moe_train_layer
    from tpfl_torch.parallel.pipeline import make_pipeline_trainer

    gen = torch.Generator(device="cpu").manual_seed(24)
    block = TransformerBlock(LM32_KW["dim"], LM32_KW["heads"], attention_fn=fk.flash_attention)
    layers = [block.init_params(gen, torch.device("cuda")) for _ in range(LM32_KW["n_layers"])]
    stacked = tree_map(lambda *a: torch.stack(a), *layers)
    dgen = torch.Generator(device="cuda").manual_seed(25)
    micro = torch.randn(PIPE_MICRO, 1, PIPE_SEQ, LM32_KW["dim"], device="cuda",
                        generator=dgen).to(torch.bfloat16)
    targets = torch.randn(micro.shape, device="cuda", generator=dgen)

    def block_fn(p, x):
        return block(tree_map(lambda a: a[None], p), x[None])[0]

    def loss_fn(o, t):
        return torch.mean((o.float() - t) ** 2)

    init, step = make_pipeline_trainer(meshes["pp"], block_fn, LM32_KW["n_layers"], loss_fn)
    lr = 0.01  # the trainer's default SGD
    p_pipe, opt_state = init(stacked)
    p_seq, out = stacked, {"pipeline": {"losses": [], "seq_losses": []}}
    before = read_launches()
    for _ in range(2):
        p_pipe, opt_state, loss = step(p_pipe, opt_state, micro, targets)
        live = tree_map(lambda a: a.detach().requires_grad_(True), p_seq)
        outs = []
        for x in micro:
            for i in range(LM32_KW["n_layers"]):
                x = block_fn(tree_map(lambda a: a[i], live), x)
            outs.append(x)
        seq_loss = loss_fn(torch.stack(outs), targets)
        grads = tree_unflatten(p_seq, torch.autograd.grad(seq_loss, tree_leaves(live)))
        p_seq = tree_map(lambda a, g: a + g * -lr, p_seq, grads)
        out["pipeline"]["losses"].append(loss.item())
        out["pipeline"]["seq_losses"].append(seq_loss.item())
    launches = {k: read_launches()[k] - before[k] for k in FLASH_KERNELS}
    # 2 steps of the pipeline and of its sequential twin, 4 microbatches x 4 blocks each
    want = dict.fromkeys(FLASH_KERNELS, 2 * 2 * PIPE_MICRO * LM32_KW["n_layers"])
    if launches != want:
        raise AssertionError(f"pipeline: flash launches {launches}, expected {want}")
    torch.testing.assert_close(torch.tensor(out["pipeline"]["losses"]),
                               torch.tensor(out["pipeline"]["seq_losses"]), rtol=1e-5, atol=0)
    seq_leaves = dict(tree_items(p_seq))
    out["pipeline"]["max_abs_param_diff"] = max(
        (v - seq_leaves[path]).abs().max().item() for path, v in tree_items(p_pipe))
    for path, v in tree_items(p_pipe):
        torch.testing.assert_close(v, seq_leaves[path], rtol=1e-5, atol=1e-6, msg=path)
    out["pipeline"]["launches"] = launches
    del micro, targets, p_pipe, p_seq, opt_state

    d, hidden = LM32_KW["dim"], MOE_HIDDEN
    mgen = torch.Generator(device="cuda").manual_seed(26)
    experts = {"w1": 0.02 * torch.randn(1, d, hidden, device="cuda", generator=mgen),
               "b1": torch.zeros(1, hidden, device="cuda"),
               "w2": 0.02 * torch.randn(1, hidden, d, device="cuda", generator=mgen),
               "b2": torch.zeros(1, d, device="cuda")}
    router = 0.02 * torch.randn(d, 1, device="cuda", generator=mgen)
    x = torch.randn(MOE_TOKENS, d, device="cuda", generator=mgen)
    y_true = torch.randn(MOE_TOKENS, d, device="cuda", generator=mgen)

    def ffn(p, toks):
        return torch.nn.functional.gelu(toks @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    layer = make_moe_train_layer(meshes["ep"], ffn, capacity=MOE_TOKENS, k=1)
    live = {"router": router.clone().requires_grad_(True),
            "experts": tree_map(lambda a: a.clone().requires_grad_(True), experts)}
    y, aux = layer(live, x)
    loss = torch.mean((y - y_true) ** 2) + 0.01 * aux
    grads = dict(zip(("router", *experts), torch.autograd.grad(
        loss, [live["router"], *live["experts"].values()])))
    plain = tree_map(lambda a: a[0].clone().requires_grad_(True), experts)
    y_plain = ffn(plain, x)
    loss_plain = torch.mean((y_plain - y_true) ** 2) + 0.01 * 1.0
    plain_grads = dict(zip(plain, torch.autograd.grad(loss_plain, list(plain.values()))))
    errs = {"y": (y - y_plain).abs().max().item(), "aux": abs(aux.item() - 1.0),
            "loss": abs(loss.item() - loss_plain.item()),
            "router_grad": grads["router"].abs().max().item()}
    for name in experts:  # the SGD update of each expert leaf
        errs[name] = ((experts[name] - 0.01 * grads[name])[0]
                      - (experts[name][0] - 0.01 * plain_grads[name])).abs().max().item()
    if max(errs.values()) > 1e-6:
        raise AssertionError(f"moe layer against its plain single expert: {errs}")
    out["moe"] = {"tokens": MOE_TOKENS, "width": [d, hidden, d], "max_abs_err": errs}
    return out


def spmd_planes(card: str) -> dict:
    """Phase 20: 20a-20e, each logged as it passes; the one-rank meshes'
    group (NCCL over an in-process store) is torn down after."""
    import torch.distributed as dist

    from tpfl_torch.parallel.mesh import create_mesh

    out = {}
    meshes = {axis: create_mesh({axis: 1}) for axis in ("sp", "pp", "ep")}
    try:
        parts = (
            ("20a ring arithmetic, 4 emulated ranks, S 8k", lambda: {
                f"causal={c}": ring_arithmetic(c) for c in (False, True)}),
            ("20b make_ring_attention on a one-rank sp mesh", lambda: ring_on_mesh(meshes["sp"])),
            ("20c attention tier", lambda: attention_tier(meshes["sp"])),
            ("20d transformer tier, S 32k", lambda: transformer_tier(card)),
            ("20e pipeline and MoE at axis size 1", lambda: pipeline_and_moe(meshes)),
        )
        for label, run in parts:
            t0 = time.perf_counter()
            launched = read_launches()
            with taking_wgmma(label, True):
                out[label] = run()
            out[label]["phase_s"] = time.perf_counter() - t0
            out[label]["flash_launches"] = {
                k: read_launches()[k] - launched[k] for k in FLASH_KERNELS}
            log(f"spmd planes ({label}; every check passed): {card}: " + json.dumps(out[label]))
    finally:
        dist.destroy_process_group()
    return out


# ---- phase 21: the engine on a device mesh -------------------------------------------

#: Phase 21's meshes (one rank each on the card).
MESH_AXES = {"1d": {"nodes": 1}, "3d": {"hosts": 1, "nodes": 1, "model": 1},
             "2d": {"nodes": 1, "model": 1}}


def local(tree):
    """A tree's ``DTensor`` leaves as this rank's local tensors."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t, tree)


def max_abs_diff(a: dict, b: dict) -> float:
    b = dict(tree_items(local(b)))
    return max(float((v.float() - b[p].float()).abs().max()) for p, v in tree_items(local(a)))


def bit_equal(label: str, a: dict, b: dict) -> None:
    b = dict(tree_items(local(b)))
    for path, v in tree_items(local(a)):
        if not torch.equal(v, b[path]):
            raise AssertionError(f"{label}: {path} differs from the reference "
                                 f"(max abs {float((v.float() - b[path].float()).abs().max())})")


def mesh_cnn_window(card: str, mesh, label: str) -> tuple[dict, tuple]:
    """Step 4's CNN window on ``mesh`` (None: no mesh), ``RANK_CONTRACTS``
    on: the result row and (fed, params, xs, ys)."""
    from tpfl_torch.parallel import ranksafe

    fed = VmapFederation(CNN(out_channels=10, conv_impl="pallas"), n_nodes=N_NODES,
                         learning_rate=0.1, seed=0, mesh=mesh)
    xs, ys = cnn_data(fed)
    params = fed.init_params((32, 32, 3))
    ranksafe.clear()
    with setting("RANK_CONTRACTS", True):
        wall, params, _, losses, launches, wgmma, _ = timed_window(fed, params, {}, xs, ys,
                                                                   MAIN_WINDOWS)
    receipt = ranksafe.receipt()
    ranksafe.clear()
    steps = N_BATCHES * EPOCHS * N_ROUNDS * MAIN_WINDOWS
    check_main_path(local(params), local(losses), launches, {
        **dict.fromkeys(WRAPPERS, 0), "conv_dw": 2 * steps, "conv_dx": steps})
    check_all_wgmma(f"CNN window ({label})", launches, {k: wgmma[k] for k in ("conv_dw",
                                                                             "conv_dx")})
    if len(receipt) != 1 + MAIN_WINDOWS:  # the warm-up window and the timed ones
        raise AssertionError(f"{label}: {len(receipt)} RANK_CONTRACTS receipts for "
                             f"{1 + MAIN_WINDOWS} windows")
    return ({**cnn_result(card, "pallas", wall, local(losses)), "mesh": label,
             "launches": launches, "receipts": len(receipt),
             "receipt_digest": receipt[-1]["digest"]}, (fed, params, xs, ys))


def mesh_lm_window(card: str, mesh, attention) -> tuple[dict, dict]:
    """Step 7's LM window with ``attention`` pinned, counting the ring's
    calls of the flash block functions."""
    from tpfl_torch.parallel import ring_attention as ra

    calls = {"flash_block_fwd": 0, "flash_block_bwd": 0}
    real = {name: getattr(ra, name) for name in calls}

    def counted(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return real[name](*args, **kwargs)
        return call

    fed = VmapFederation(TransformerLM(**LM_KW, attention_fn=attention), n_nodes=T_NODES,
                         learning_rate=T_LR, seed=0, mesh=mesh)
    xs, ys = lm_tokens(T_NODES, T_BATCHES, T_BATCH, T_SEQ, LM_KW["vocab"], seed=5)
    xs, ys = fed.shard_data(xs, ys)
    params = fed.init_params((T_SEQ,))
    for name in calls:
        setattr(ra, name, counted(name))
    try:
        with taking_wgmma("21b LM window", True):
            wall, params, _, losses, launches, _, _ = timed_window(fed, params, {}, xs, ys,
                                                                   MAIN_WINDOWS)
    finally:
        for name, fn in real.items():
            setattr(ra, name, fn)
    per_window = LM_KW["n_layers"] * T_BATCHES * EPOCHS * N_ROUNDS * MAIN_WINDOWS
    check_main_path(local(params), local(losses), launches, {
        **dict.fromkeys(WRAPPERS, 0), **dict.fromkeys(FLASH_KERNELS, per_window)})
    rounds_s = N_ROUNDS / wall
    return ({"card": card, "attention": "model ring" if mesh is not None else "flash_attention",
             "rounds_per_s": rounds_s, "wall_s": wall, "launches": launches,
             "flash_block_calls": dict(calls), "mean_loss": local(losses).mean().item()},
            params)


def sharded_trainer_path(card: str, mesh) -> dict:
    """21c: ``ShardedTrainer`` at ``dp`` 1: FSDP on the CNN (B 128, through
    the conv kernels) and ``train_step_with_aux`` on ResNet-18 at config
    3's shape, 5 steps each; the first two losses against plain
    single-device steps (the same SGD + momentum, library convolutions)."""
    from tpfl_torch.learning.torch_learner import cross_entropy_loss, default_optimizer
    from tpfl_torch.models import apply, init_state
    from tpfl_torch.parallel.sharded import ShardedTrainer

    out = {}
    cases = (("cnn_fsdp", lambda impl: CNN(out_channels=10, conv_impl=impl), True, 10),
             ("resnet18_aux", lambda impl: ResNet18(out_channels=RN_CLASSES), False,
              RN_CLASSES))
    for label, make, fsdp, classes in cases:
        x, y, _, _ = synthetic_classification((32, 32, 3), n_classes=classes, n_train=128,
                                              n_test=10, seed=0)
        tr = ShardedTrainer(make("pallas"), mesh, fsdp=fsdp, learning_rate=0.05)
        if label == "resnet18_aux":
            params, aux, opt = tr.init_with_aux((32, 32, 3))
        else:
            (params, opt), aux = tr.init((32, 32, 3)), None
        sx, sy = tr.shard_batch(x, y)
        plain = make("fwd_bwd")
        p_ref, a_ref = init_state(plain, (32, 32, 3), seed=0, device="cuda")
        sgd, xs, ys = default_optimizer(0.05), torch.from_numpy(x).cuda(), torch.from_numpy(
            y).cuda().long()
        trace = sgd.init(p_ref)
        reset_launches()
        losses, plain_losses = [], []
        for step in range(5):  # steps/s over steps 2-5: the first is the warm-up
            if step == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if aux is not None:
                params, aux, opt, loss = tr.train_step_with_aux(params, aux, opt, sx, sy)
            else:
                params, opt, loss = tr.train_step(params, opt, sx, sy)
            losses.append(loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        for step in range(2):  # the plain single-device steps
            live = tree_map(lambda v: v.detach().requires_grad_(True), p_ref)
            stats = tree_map(lambda v: v[None], a_ref) if a_ref else {}
            logits, new = apply(plain, tree_map(lambda v: v[None], live), stats, xs[None],
                                train=bool(a_ref))
            loss = cross_entropy_loss(logits[0], ys).mean()
            grads = torch.autograd.grad(loss, tree_leaves(live))
            p_ref, trace = sgd.step(p_ref, tree_unflatten(p_ref, grads), trace)
            a_ref = tree_map(lambda v: v[0].detach(), new) if a_ref else a_ref
            plain_losses.append(loss.detach())
        for got, want in zip(losses[:2], plain_losses):
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4, msg=label)
        if not all(torch.isfinite(v).all() for v in losses):
            raise AssertionError(f"{label}: non-finite losses {losses}")
        out[label] = {"card": card, "fsdp": fsdp, "batch": 128, "steps": 5,
                      "steps_per_s": 4 / wall, "samples_per_s": 4 * 128 / wall, "losses": [float(v) for v in losses],
                      "plain_losses": [float(v) for v in plain_losses], "launches": launches}
    return out


def mesh_scaling_and_checkpoint(card: str, fed_args: tuple) -> dict:
    """21d: ``scaling.analyze`` of one 21a window, and a ``SliceCheckpointer``
    round trip of its placed state against running on."""
    from tpfl_torch.management.checkpoint import SliceCheckpointer
    from tpfl_torch.parallel.scaling import analyze, params_bytes

    fed, params, xs, ys = fed_args
    rec = analyze(fed.run_rounds, params, xs, ys, epochs=EPOCHS, n_rounds=N_ROUNDS)
    one_model = params_bytes(params) // fed.engine.padded_nodes
    out = {"collectives": rec["collectives"], "collective_bytes": rec["collective_bytes"],
           "one_model_bytes": one_model, "flops_seen": rec["flops"]}
    if not 0 < rec["collective_bytes"] <= 4 * N_ROUNDS * one_model:
        raise AssertionError(f"21d: collective bytes {rec['collective_bytes']} not O(params)")
    after, _ = rec["result"]
    with tempfile.TemporaryDirectory() as d:
        ck = SliceCheckpointer(d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(1, {"params": after, "rounds_done": fed.engine._rounds_done})
        t1 = time.perf_counter()
        back = ck.restore(1, abstract_target={"params": after, "rounds_done": 0})
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    resumed, _ = fed.run_rounds(back["params"], xs, ys, epochs=EPOCHS, n_rounds=1)
    onward, _ = fed.run_rounds(after, xs, ys, epochs=EPOCHS, n_rounds=1)
    bit_equal("21d resumed window", resumed, onward)
    out.update({"save_s": t1 - t0, "restore_s": t2 - t1,
                "state_mb": params_bytes(after) / 1e6, "rounds_done": back["rounds_done"]})
    return out


def mesh_phase(card: str) -> dict:
    """Phase 21, each part logged as it passes; the one-rank meshes'
    group is torn down after."""
    import torch.distributed as dist

    from tpfl_torch.parallel.mesh import MODEL_AXIS, create_mesh
    from tpfl_torch.parallel.ring_attention import make_ring_attention

    out = {}
    t0 = time.perf_counter()
    meshes = {name: create_mesh(axes) for name, axes in MESH_AXES.items()}
    try:
        rows, args = {}, {}
        for name, mesh in (("none", None), ("1d", meshes["1d"]), ("3d", meshes["3d"])):
            rows[name], args[name] = mesh_cnn_window(card, mesh, name)
        for name in ("1d", "3d"):
            bit_equal(f"21a CNN {name}", args[name][1], args["none"][1])
            rows[name]["max_abs_diff_vs_none"] = max_abs_diff(args[name][1], args["none"][1])
        fed, params, xs, ys = args["3d"]
        with setting("ENGINE_TELEMETRY", True):
            tele = fed.engine.dispatch_window(params, xs, ys, n_rounds=1)
            carried = tele.telemetry()
            tele.finalize()
        if "dcn_bytes" in carried:
            raise AssertionError("21a: a dcn_bytes row at hosts 1")
        out["21a"] = {**rows, "carry_rows": sorted(carried)}
        log(f"mesh phase (21a CNN window on meshes; every check passed): {card}: "
            + json.dumps(out["21a"]))

        lm_1d, p_1d = mesh_lm_window(card, None, fk.flash_attention)
        ring = make_ring_attention(meshes["2d"], MODEL_AXIS, causal=True)
        lm_2d, p_2d = mesh_lm_window(card, meshes["2d"], ring)
        bit_equal("21b LM on nodes x model", p_2d, p_1d)
        calls = lm_2d["flash_block_calls"]
        # Every attention of the warm-up round and the timed windows: one
        # ring step forward and one backward (a one-rank causal ring).
        steps = LM_KW["n_layers"] * T_BATCHES * EPOCHS * (1 + N_ROUNDS * MAIN_WINDOWS)
        if calls != {"flash_block_fwd": steps, "flash_block_bwd": steps}:
            raise AssertionError(f"21b: the model ring called {calls}; expected {steps} each")
        cnn_2d, args_2d = mesh_cnn_window(card, meshes["2d"], "2d")
        bit_equal("21b CNN on nodes x model", args_2d[1], args["none"][1])
        out["21b"] = {"lm_flash_attention_1d": lm_1d, "lm_model_ring_2d": lm_2d,
                      "cnn_2d": cnn_2d}
        log(f"mesh phase (21b the 2D route; every check passed): {card}: "
            + json.dumps(out["21b"]))

        out["21c"] = sharded_trainer_path(card, create_mesh({"dp": 1}))
        log(f"mesh phase (21c ShardedTrainer at dp 1; every check passed): {card}: "
            + json.dumps(out["21c"]))
        out["21d"] = mesh_scaling_and_checkpoint(card, args["1d"])
        log(f"mesh phase (21d scaling.analyze and SliceCheckpointer; every check passed): "
            f"{card}: " + json.dumps(out["21d"]))
    finally:
        dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t0
    out["mesh_window_launches"] = {
        **{k: out["21a"]["1d"]["launches"][k] for k in ("conv_dw", "conv_dx")},
        **{k: out["21b"]["lm_model_ring_2d"]["launches"][k] for k in FLASH_KERNELS}}
    out["sharded_trainer_launches"] = {
        k: sum(r["launches"][k] for r in out["21c"].values()) for k in WRAPPERS}
    return out


# --- phase 22: the network path ------------------------------------------
#
# Four Nodes of the CNN cell's model (PHASE_CNN: bf16, the conv kernels at
# N = 1) on a LINE of loopback addresses, F_TRAIN seeded synthetic
# CIFAR-shaped samples each in batches of F_BATCH, 1 epoch a round,
# NET_ROUNDS rounds, a train set of NET_TRAIN_SET by hash election. With
# two trainers each round's aggregate folds two single models in canonical
# order, whatever order they arrived in, so two runs of the same
# experiment id end on the same bits: the in-memory and the TCP federation
# (22a) and the federation split over two processes (22b) are held bit for
# bit. The experiment id is chosen so that every round elects one node of
# each process of 22b.
NET_NODES, NET_ROUNDS, NET_TRAIN_SET, NET_SEED = 4, 3, 2, 2222
NET_CHILD = (2, 3)  # the nodes 22b's child process hosts
NET_STEPS_PER_FIT = F_TRAIN // F_BATCH
# Standalone-profile waits the entry points of 22d may shorten through
# the TPFL_* environment (timing only).
NET_FAST_ENV = {"TPFL_WAIT_HEARTBEATS_CONVERGENCE": "0.5",
                "TPFL_GOSSIP_EXIT_ON_X_EQUAL_ROUNDS": "3", "TPFL_GOSSIP_MODELS_PERIOD": "0.2"}


def free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def net_nodes(protocol, addrs: list, which) -> list:
    x, y, xt, yt = synthetic_cifar10(n_train=NET_NODES * F_TRAIN, n_test=NET_NODES * F_TEST,
                                     seed=NET_SEED)
    parts = TpflDataset.from_arrays(x, y, xt, yt).generate_partitions(
        NET_NODES, RandomIIDPartitionStrategy, seed=1)
    return [TimedNode(phase_model(0), parts[i], addr=addrs[i], protocol=protocol,
                      device=PHASE_DEVICE, learning_rate=0.1, batch_size=F_BATCH)
            for i in which]


def net_experiment(initiator, addrs: list) -> tuple[uuid.UUID, list]:
    """An experiment id (what ``uuid.uuid4`` gives the initiator) whose
    hash elections put one node of each of 22b's processes into every
    round's train set, and those train sets (node indices)."""
    beacon = hashlib.sha256(initiator.learner.get_model().encode_parameters()).hexdigest()
    for k in range(1, 1 << 16):
        exp_id = uuid.UUID(int=(0x5EED0000 + k) << 96)
        name = f"experiment_{exp_id.hex[:8]}"
        sets = [sorted(range(NET_NODES), key=lambda i: election_rank(name, beacon, r, addrs[i]))
                [:NET_TRAIN_SET] for r in range(NET_ROUNDS)]
        if all(len({i in NET_CHILD for i in s}) == 2 for s in sets):
            return exp_id, sets
    raise AssertionError("network path: no experiment id splits every train set")


def net_expected(sets: list, hosted) -> dict:
    """Exact conv launches of the fits ``hosted`` nodes make."""
    fits = sum(i in hosted for s in sets for i in s)
    return {**dict.fromkeys(WRAPPERS, 0), "conv_dw": 2 * fits * NET_STEPS_PER_FIT,
            "conv_dx": fits * NET_STEPS_PER_FIT}


def params_digest(node) -> str:
    h = hashlib.sha256()
    for path, v in sorted(tree_items(node.learner.get_model().get_parameters())):
        h.update(path.encode())
        h.update(v.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def wire_bytes(addrs) -> float:
    return sum(logger.metrics.value("tpfl_wire_bytes_total", {"node": a}) for a in addrs)


def net_federation(card: str, label: str, protocol, addrs: list,
                   rounds: int = NET_ROUNDS) -> dict:
    """22a: the four Nodes in this process over ``protocol``."""
    with runtime_settings(TRAIN_SET_SIZE=NET_TRAIN_SET, ELECTION="hash"):
        nodes = net_nodes(protocol, addrs, range(NET_NODES))
        try:
            start_federation(nodes, "LINE")
            exp_id, sets = net_experiment(nodes[0], addrs)
            sets = sets[:rounds]
            wire0 = wire_bytes(addrs)
            profiling.rounds.reset()
            reset_launches()
            saved, uuid.uuid4 = uuid.uuid4, lambda: exp_id
            try:
                with setting("PROFILING_ENABLED", True):
                    exp, wall = run_experiment(nodes, rounds)
            finally:
                uuid.uuid4 = saved
            launches = read_launches()
            wgmma = read_wgmma_launches(("conv_dw", "conv_dx"))
            check_history(label, nodes, rounds)
            want = net_expected(sets, range(NET_NODES))
            if launches != want:
                raise AssertionError(f"network {label}: launches {launches}, expected {want}")
            check_all_wgmma(f"network {label}", launches, wgmma)
            digests = {nd.addr: params_digest(nd) for nd in nodes}
            if len(set(digests.values())) != 1:
                raise AssertionError(f"network {label}: the nodes end on different params")
            split = round_split(nodes)
            accs = [nd.learner.evaluate()["test_metric"] for nd in nodes]
        finally:
            for nd in nodes:
                nd.stop()
    return {"card": card, "nodes": NET_NODES, "topology": "LINE", "rounds": rounds,
            "train_sets": [[addrs[i] for i in s] for s in sets], "experiment": exp,
            "experiment_wall_s": wall, "rounds_per_s": rounds / wall,
            "launches": {k: launches[k] for k in ("conv_dw", "conv_dx")},
            "wgmma_launches": wgmma, "wire_bytes": wire_bytes(addrs) - wire0,
            "round_split": split, "digest": next(iter(digests.values())),
            "mean_test_acc": float(np.mean(accs))}


def net_child(spec: dict) -> None:
    """22b's child (``chip_smoke.py --net-child SPEC``): hosts nodes
    ``NET_CHILD`` over TCP, prints ``listening`` and then ``converged``
    lines, runs the parent's experiment, and prints its launches and
    final digests as its last line."""
    _build.build(_build.all_sources())
    addrs = spec["addrs"]
    # The parent's warm-up, in this process too (untimed).
    net_federation("", "child warm-up", InMemoryCommunicationProtocol,
                   [f"net-child-warm-{i}" for i in range(NET_NODES)], rounds=1)
    with runtime_settings(TRAIN_SET_SIZE=NET_TRAIN_SET, ELECTION="hash"):
        nodes = net_nodes(TcpCommunicationProtocol, addrs, NET_CHILD)
        try:
            for nd in nodes:
                nd.start()
            nodes[0].connect(nodes[1].addr)
            reset_launches()
            print(json.dumps({"listening": [nd.addr for nd in nodes]}), flush=True)
            wait_convergence(nodes, NET_NODES - 1, only_direct=False, wait=60)
            print(json.dumps({"converged": True}), flush=True)
            deadline = time.monotonic() + 300
            while not all(len(nd.learning_workflow.history) == 1 + 4 * NET_ROUNDS
                          and nd.learning_finished() for nd in nodes):
                if time.monotonic() > deadline:
                    raise AssertionError("network child: the experiment did not finish")
                time.sleep(0.05)
            torch.cuda.synchronize()
            check_history("two processes, child", nodes, NET_ROUNDS)
            out = {"launches": read_launches(),
                   "wgmma": read_wgmma_launches(("conv_dw", "conv_dx")),
                   "digests": {nd.addr: params_digest(nd) for nd in nodes},
                   "wire_bytes": wire_bytes(nd.addr for nd in nodes)}
        finally:
            for nd in nodes:
                nd.stop()
    print(json.dumps({"net_child": out}), flush=True)


def net_two_processes(card: str, addrs: list, want_digest: str) -> dict:
    """22b: nodes 0 and 1 here, ``NET_CHILD`` in a child process on the
    card, one federation over TCP."""
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--net-child",
                             json.dumps({"addrs": addrs})], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                              name="net-child-stdout", daemon=True)
    reader.start()

    def expect(key: str, timeout: float) -> dict:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                line = lines.get(timeout=0.2)
            except queue.Empty:
                if proc.poll() is not None:
                    break
                continue
            if line.startswith("{") and key in (obj := json.loads(line)):
                return obj
        proc.kill()
        raise AssertionError(f"network child: no {key!r} line (rc {proc.poll()}): "
                             f"{proc.stderr.read()[-2000:]}")

    try:
        with runtime_settings(TRAIN_SET_SIZE=NET_TRAIN_SET, ELECTION="hash"):
            expect("listening", 120)
            nodes = net_nodes(TcpCommunicationProtocol, addrs, (0, 1))
            try:
                for nd in nodes:
                    nd.start()
                nodes[0].connect(nodes[1].addr)
                nodes[1].connect(addrs[2])
                wait_convergence(nodes, NET_NODES - 1, only_direct=False, wait=60)
                expect("converged", 60)
                exp_id, sets = net_experiment(nodes[0], addrs)
                reset_launches()
                saved, uuid.uuid4 = uuid.uuid4, lambda: exp_id
                try:
                    exp, wall = run_experiment(nodes, NET_ROUNDS)
                finally:
                    uuid.uuid4 = saved
                launches = read_launches()
                wgmma = read_wgmma_launches(("conv_dw", "conv_dx"))
                check_history("two processes", nodes, NET_ROUNDS)
                digests = {nd.addr: params_digest(nd) for nd in nodes}
            finally:
                for nd in nodes:
                    nd.stop()
        child = expect("net_child", 300)["net_child"]
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    if proc.returncode != 0:
        raise AssertionError(f"network child exited {proc.returncode}")
    for who, got, hosted in (("parent", (launches, wgmma), (0, 1)),
                             ("child", (child["launches"], child["wgmma"]), NET_CHILD)):
        want = net_expected(sets, hosted)
        if got[0] != want or not want["conv_dw"]:
            raise AssertionError(f"network two processes ({who}): launches {got[0]}, "
                                 f"expected {want}")
        check_all_wgmma(f"network two processes ({who})", got[0], got[1])
    digests.update(child["digests"])
    if set(digests.values()) != {want_digest}:
        raise AssertionError(f"network two processes: final digests {digests}, expected "
                             f"{want_digest} (22a's) on every node")
    return {"card": card, "rounds": NET_ROUNDS, "experiment_wall_s": wall,
            "rounds_per_s": NET_ROUNDS / wall,
            "train_sets": [[addrs[i] for i in s] for s in sets],
            "launches": {"parent": {k: launches[k] for k in ("conv_dw", "conv_dx")},
                         "child": {k: child["launches"][k] for k in ("conv_dw", "conv_dx")}},
            "wgmma_launches": {"parent": wgmma, "child": child["wgmma"]},
            "child_wire_bytes": child["wire_bytes"], "digest": want_digest,
            "digests_equal_22a": True}


def stream_pair(payload: bytes, sends: int = 3, protocol=TcpCommunicationProtocol) -> dict:
    """One SendStream of ``payload`` as a weights message between two
    endpoints of ``protocol`` (under the current TLS settings), ``sends``
    times: each reassembled byte-equal; the best send's MB/s."""
    a, b = protocol(), protocol()
    got: list = []
    b.add_command("stream_probe", lambda source, round, weights, **kw: got.append(weights))
    a.start()
    b.start()
    try:
        if not a.connect(b.get_address()):
            raise AssertionError("network stream: connect refused")
        msg = a.build_weights("stream_probe", 0, payload, [a.get_address()], 1)
        wire = len(msg.to_bytes())
        times = []
        for _ in range(sends):
            t0 = time.perf_counter()
            a.send(b.get_address(), msg, raise_error=True)
            times.append(time.perf_counter() - t0)
        if len(got) != sends or any(g != payload for g in got):
            raise AssertionError("network stream: a reassembled payload differs")
    finally:
        a.stop()
        b.stop()
    return {"payload_bytes": len(payload), "wire_bytes": wire,
            "chunks": -(-wire // Settings.WIRE_CHUNK_SIZE),
            "chunk_size": Settings.WIRE_CHUNK_SIZE, "send_s": times,
            "mb_per_s": wire / min(times) / 1e6}


def corrupted_stream(protocol=TcpCommunicationProtocol) -> dict:
    """A fault-injected corrupted stream rejected by the receiver's chunk
    CRC, then the retry delivers the payload intact, once."""
    a, b = protocol(), protocol()
    got: list = []
    b.add_command("crc_probe", lambda source, round, weights, **kw: got.append(weights))
    a.start()
    b.start()
    try:
        a.connect(b.get_address())
        fi = FaultInjector(FaultPlan.from_dict({"links": {"*->*": {"corrupt": 1.0,
                                                                   "corrupt_limit": 1}}}),
                           seed=5)
        fi.attach(a)
        payload = bytes(range(256)) * 4096
        a.send(b.get_address(), a.build_weights("crc_probe", 1, payload, ["a"], 1),
               raise_error=True)
        stats = fi.stats()[f"{a.get_address()}->{b.get_address()}"]
    finally:
        a.stop()
        b.stop()
    if got != [payload] or stats.get("corrupt_rejected") != 1 or "corrupt_accepted" in stats:
        raise AssertionError(f"network corrupted stream: {len(got)} deliveries, {stats}")
    return {"corrupted": stats["corrupted"], "corrupt_rejected": stats["corrupt_rejected"],
            "delivered": stats["delivered"]}


def mtls_checks(cert_dir: str, payload: bytes) -> dict:
    """mTLS with certificates from ``generate_certificates``: two Nodes'
    transports handshake and carry the stream; a TLS client that trusts
    the CA but shows no certificate gets no reply and does not register."""
    import ssl

    t0 = time.perf_counter()
    enable_mtls(cert_dir)
    certs_s = time.perf_counter() - t0
    stream = stream_pair(payload)
    (server,) = [TcpCommunicationProtocol()]
    server.start()
    try:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_verify_locations(Settings.CA_CRT)
        host, port = server.get_address().rsplit(":", 1)
        refused = ""
        try:
            with socket.create_connection((host, int(port)), timeout=5) as raw:
                with ctx.wrap_socket(raw, server_hostname=host) as s:
                    body = _msgpack.packb({"addr": "mallory"})
                    s.sendall(b"H" + len(body).to_bytes(8, "big") + body)
                    if len(s.recv(8)) == 8:
                        raise AssertionError("network mTLS: a client without a certificate "
                                             "got a reply")
                    refused = "closed without a reply"
        except (ssl.SSLError, ConnectionError) as e:
            refused = type(e).__name__ + ": " + str(e)[:120]
        if "mallory" in server.get_neighbors():
            raise AssertionError("network mTLS: an unauthenticated client registered")
    finally:
        server.stop()
    return {"certificates_s": certs_s, "stream": stream, "unauthenticated_refused": refused}


def net_streams(card: str) -> dict:
    """22c: the 44 MB ResNet-18 state as one SendStream (plain TCP and
    mTLS) and the CNN cell's payload (one 22a push), a corrupted stream,
    mTLS refusing a client without a certificate."""
    module = ResNet18(out_channels=100)
    params, aux = init_state(module, (32, 32, 3), seed=0, device=PHASE_DEVICE)
    payload = TpflModel(module, params, aux_state=aux, device=PHASE_DEVICE).encode_parameters()
    out = {"card": card}
    with runtime_settings():
        out["resnet18_stream"] = stream_pair(payload)
        out["cnn_stream"] = stream_pair(phase_model(0).encode_parameters(), sends=7)
        out["corrupted_stream"] = corrupted_stream()
        openssl = shutil.which("openssl")
        out["openssl"] = openssl
        if openssl is None:
            log(f"network path (22c): {card}: no openssl on this machine, so the mTLS half "
                "is held on the CPU only (tests/test_torch_tcp_transport.py)")
        else:
            with tempfile.TemporaryDirectory() as d:
                out["mtls"] = mtls_checks(d, payload)
    return out


def wait_for_line(path: Path, text: str, proc, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and proc.poll() is None:
        if text in path.read_text():
            return
        time.sleep(0.2)
    raise AssertionError(f"entry point: no {text!r} within {timeout} s: "
                         f"{path.read_text()[-2000:]}")


def net_entry_points(card: str) -> dict:
    """22d: the CLI and the examples as subprocesses on the card: ``list``;
    ``run node1`` beside ``run node2``; ``run digits`` over TCP; the
    multislice slice-mode pair. Each exits 0 (the passive halves on
    SIGTERM)."""
    cli = [sys.executable, "-m", "tpfl_torch.cli", "experiment"]
    env = {**os.environ, **NET_FAST_ENV}
    p1, p2, p3, p4 = free_ports(4)
    logs = Path(tempfile.mkdtemp(prefix="tpfl-entry-"))
    procs: dict = {}
    started: dict = {}

    def start(name: str, args: list) -> None:
        with open(logs / f"{name}.log", "w") as f:
            started[name] = time.perf_counter()
            procs[name] = (subprocess.Popen(cli + [*args], stdout=f, stderr=subprocess.STDOUT,
                                            env=env), logs / f"{name}.log")

    t0 = time.perf_counter()
    try:
        start("list", ["list"])
        start("node1", ["run", "node1", "--", "--port", str(p1), "--samples", "200"])
        start("multislice passive", ["run", "multislice", "--", "--port", str(p3),
                                     "--local-nodes", "4", "--samples", "400"])
        start("digits", ["run", "--profile", str(logs / "trace"), "digits", "--", "--nodes", "2",
                         "--rounds", "1", "--protocol", "tcp"])
        wait_for_line(procs["node1"][1], "listening", procs["node1"][0], 120)
        start("node2", ["run", "node2", "--", "--port", str(p2), "--connect-to",
                        f"127.0.0.1:{p1}", "--rounds", "1", "--samples", "200"])
        wait_for_line(procs["multislice passive"][1], "listening",
                      procs["multislice passive"][0], 120)
        start("multislice driving", ["run", "multislice", "--", "--port", str(p4),
                                     "--connect-to", f"127.0.0.1:{p3}", "--local-nodes", "4",
                                     "--rounds", "1", "--samples", "400"])
        rcs, elapsed = {}, {}
        for name, passive in (("list", None), ("node2", "node1"),
                              ("multislice driving", "multislice passive"), ("digits", None)):
            rcs[name] = procs[name][0].wait(timeout=300)
            elapsed[name] = time.perf_counter() - started[name]
            if passive is not None:
                procs[passive][0].send_signal(signal.SIGTERM)
        for name in ("node1", "multislice passive"):
            rcs[name] = procs[name][0].wait(timeout=60)
            elapsed[name] = time.perf_counter() - started[name]
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    wall = time.perf_counter() - t0
    texts = {name: path.read_text() for name, (_, path) in procs.items()}
    names = texts["list"].split()
    if names != ["digits", "multislice", "node1", "node2", "scale"]:
        raise AssertionError(f"cli list: {names}")
    trace = logs / "trace" / "trace.json"
    trace_bytes = trace.stat().st_size if trace.exists() else 0
    shutil.rmtree(logs, ignore_errors=True)
    bad = {n: rc for n, rc in rcs.items() if rc != 0}
    if bad:
        raise AssertionError(f"entry points exited non-zero: {bad}: "
                             + json.dumps({n: texts[n][-1500:] for n in bad}))
    for name, text in (("node2", "Final metrics"), ("digits", "Final test accuracy per node"),
                       ("multislice driving", "Slice-level metrics")):
        if text not in texts[name]:
            raise AssertionError(f"entry point {name}: no {text!r} line")
    if not trace_bytes:
        raise AssertionError("entry point digits: run --profile wrote no trace.json")
    return {"card": card, "cli_list": names, "exit_codes": rcs, "elapsed_s": elapsed,
            "wall_s": wall, "digits_profile_trace_bytes": trace_bytes}


def net_interop(card: str) -> dict:
    """22e: a torch ``state_dict`` on the card through
    ``from_torch_state_dict`` / ``to_torch_state_dict`` (exact), and the
    ``nn.Sequential`` MLP's logits against the port's MLP with the
    imported params (f32, TF32 off; atol 1e-4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    tm = torch.nn.Sequential(torch.nn.Linear(784, 256), torch.nn.ReLU(),
                             torch.nn.Linear(256, 128), torch.nn.ReLU(),
                             torch.nn.Linear(128, 10)).to(PHASE_DEVICE)
    sd = tm.state_dict()
    module = MLP(hidden_sizes=(256, 128), out_channels=10, compute_dtype=torch.float32)
    params = from_torch_state_dict(init_params(module, (28, 28), seed=0, device=PHASE_DEVICE),
                                   sd, device=PHASE_DEVICE)
    back = to_torch_state_dict(params, sd)
    if list(back) != list(sd) or not all(
            torch.equal(back[k], sd[k]) and back[k].device == sd[k].device for k in sd):
        raise AssertionError("interop: the state_dict round trip is not exact on the card")
    x = torch.randn(64, 784, device=PHASE_DEVICE, generator=torch.Generator(
        PHASE_DEVICE).manual_seed(1))
    with torch.no_grad():
        want = tm(x)
        got = module(stack_params(params, 1), x.reshape(1, 64, 28, 28))[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4,
                               msg=lambda m: f"interop logits: {m}")
    return {"card": card, "round_trip_exact": True,
            "logits_max_abs_diff": (got - want).abs().max().item()}


def network_path(card: str) -> dict:
    """Phase 22: (a) the four CNN Nodes over the in-memory transport and
    over TCP on loopback, the same addresses, seeds, data and experiment
    id: the final params bit-identical, exact launch counts, wire bytes
    only over TCP; (b) the same federation split over two processes; (c)
    streams and mTLS; (d) the entry points as subprocesses; (e) interop.
    Returns the results and, per conv kernel, the launches of each run."""
    t0 = time.perf_counter()
    # A 1-round warm-up federation of its own (the first federation of a
    # process pays its threads' first card calls), untimed.
    net_federation(card, "warm-up", InMemoryCommunicationProtocol,
                   [f"net-warm-{i}" for i in range(NET_NODES)], rounds=1)
    addrs = [f"127.0.0.1:{p}" for p in free_ports(NET_NODES)]
    # Each transport twice, alternating (one experiment a run reads
    # ±40% between calls): every run's final params bit-identical.
    transports = (("in-memory", InMemoryCommunicationProtocol), ("tcp", TcpCommunicationProtocol))
    runs = [(label, net_federation(card, label, protocol, addrs))
            for _ in range(2) for label, protocol in transports]
    digests = {r["digest"] for _, r in runs}
    if len(digests) != 1:
        raise AssertionError(f"network path: the four runs end on {len(digests)} different "
                             "final params (TCP against in-memory)")
    for label, r in runs:
        if (r["wire_bytes"] > 0) != (label == "tcp"):
            raise AssertionError(f"network path: {r['wire_bytes']} wire bytes in {label}")
    out: dict = {}
    for key, label in (("22a memory", "in-memory"), ("22a tcp", "tcp")):
        mine = [r for lb, r in runs if lb == label]
        out[key] = {**max(mine, key=lambda r: r["rounds_per_s"]),
                    "rounds_per_s_runs": [r["rounds_per_s"] for r in mine],
                    "wire_bytes_runs": [r["wire_bytes"] for r in mine]}
    mem, tcp = out["22a memory"], out["22a tcp"]
    tcp["addrs"] = addrs
    tcp["bit_identical_to_memory"] = True
    tcp["rounds_per_s_over_memory"] = tcp["rounds_per_s"] / mem["rounds_per_s"]
    out["22b"] = net_two_processes(card, addrs, tcp["digest"])
    out["22c"] = net_streams(card)
    out["22d"] = net_entry_points(card)
    out["22e"] = net_interop(card)
    out["phase_s"] = time.perf_counter() - t0
    out["launches"] = {k: {"22a memory": mem["launches"][k], "22a tcp": tcp["launches"][k],
                           **{f"22b {who}": out["22b"]["launches"][who][k]
                              for who in ("parent", "child")}}
                       for k in ("conv_dw", "conv_dx")}
    return out


# --- phase 27: the gRPC wire -------------------------------------------------
#
# Port against port (the card's machine has no JAX and no grpcio). 27a is
# 22a's federation over GrpcCommunicationProtocol: the same builder,
# addresses, seeds, data and experiment id, so its final params must be
# 22a's bits.
GRPC_RUNS = 2


def grpc_heartbeat_during_stream(payload: bytes) -> dict:
    """A heartbeat-sized Send on the connection of a SendStream of
    ``payload`` that is in flight (a quarter of its chunks handed over):
    the Send must finish before the stream does."""
    a, b = GrpcCommunicationProtocol(), GrpcCommunicationProtocol()
    got: list = []
    b.add_command("stream_probe", lambda source, round, weights, **kw: got.append(weights))
    b.add_command("beat_probe", lambda source, round, args: got.append("beat"))
    a.start()
    b.start()
    try:
        if not a.connect(b.get_address()):
            raise AssertionError("grpc heartbeat: connect refused")
        channel = a.get_neighbors()[b.get_address()].conn
        data = a.build_weights("stream_probe", 0, payload, [a.get_address()], 1).to_bytes()
        frames = list(grpc_transport.chunk_frames(data, Settings.WIRE_CHUNK_SIZE))
        quarter, done = threading.Event(), {}

        def frames_in_flight():
            for i, f in enumerate(frames):
                if i == len(frames) // 4:
                    quarter.set()
                yield f

        def stream() -> None:
            try:
                done["reply"] = channel.stream_unary("/tpfl.NodeServices/SendStream",
                                                     frames_in_flight(), 60.0)
            finally:
                done["t"] = time.perf_counter()

        streamer = threading.Thread(target=stream, name="grpc-heartbeat-stream")
        streamer.start()
        if not quarter.wait(60):
            raise AssertionError("grpc heartbeat: the stream never started")
        t0 = time.perf_counter()
        a.send(b.get_address(), a.build_msg("beat_probe", ttl=1), raise_error=True)
        beat_end = time.perf_counter()
        streamer.join(120)
        if "reply" not in done or not _msgpack.unpackb(done["reply"]).get("ok"):
            raise AssertionError("grpc heartbeat: the stream failed")
    finally:
        a.stop()
        b.stop()
    if got != ["beat", payload]:
        raise AssertionError("grpc heartbeat: the beat did not arrive before the stream's end "
                             f"({[g if isinstance(g, str) else len(g) for g in got]})")
    if beat_end >= done["t"]:
        raise AssertionError("grpc heartbeat: the Send finished after the stream")
    return {"beat_latency_ms": (beat_end - t0) * 1e3,
            "stream_left_ms": (done["t"] - beat_end) * 1e3, "chunks": len(frames)}


def grpc_mtls_checks(cert_dir: str, payload: bytes) -> dict:
    """mTLS with certificates from ``generate_certificates``: the stream
    over gRPC, and a TLS client (ALPN h2) that trusts the CA but shows no
    certificate gets no HTTP/2 SETTINGS and does not register."""
    import ssl

    enable_mtls(cert_dir)
    stream = stream_pair(payload, protocol=GrpcCommunicationProtocol)
    server = GrpcCommunicationProtocol()
    server.start()
    try:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_verify_locations(Settings.CA_CRT)
        ctx.set_alpn_protocols(["h2"])
        host, port = server.get_address().rsplit(":", 1)
        try:
            with socket.create_connection((host, int(port)), timeout=5) as raw:
                with ctx.wrap_socket(raw, server_hostname=host) as s:
                    s.sendall(b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n")
                    if s.recv(9):
                        raise AssertionError("grpc mTLS: a client without a certificate got "
                                             "HTTP/2 frames")
                    refused = "closed without SETTINGS"
        except (ssl.SSLError, ConnectionError) as e:
            refused = type(e).__name__ + ": " + str(e)[:120]
        if "mallory" in server.get_neighbors():
            raise AssertionError("grpc mTLS: an unauthenticated client registered")
    finally:
        server.stop()
    return {"stream": stream, "unauthenticated_refused": refused}


def grpc_streams(card: str) -> dict:
    """27b: the 44.9 MB ResNet-18 state as one gRPC SendStream (plain and
    mTLS), a heartbeat during it, a corrupted stream."""
    module = ResNet18(out_channels=100)
    params, aux = init_state(module, (32, 32, 3), seed=0, device=PHASE_DEVICE)
    payload = TpflModel(module, params, aux_state=aux, device=PHASE_DEVICE).encode_parameters()
    out = {"card": card}
    with runtime_settings():
        out["resnet18_stream"] = stream_pair(payload, protocol=GrpcCommunicationProtocol)
        out["heartbeat_during_stream"] = grpc_heartbeat_during_stream(payload)
        out["corrupted_stream"] = corrupted_stream(GrpcCommunicationProtocol)
        out["openssl"] = shutil.which("openssl")
        if out["openssl"] is None:
            log(f"grpc path (27b): {card}: no openssl on this machine, so the mTLS half is "
                "held on the CPU only (tests/test_torch_grpc_transport.py)")
        else:
            with tempfile.TemporaryDirectory() as d:
                out["mtls"] = grpc_mtls_checks(d, payload)
    return out


def grpc_dial_timeout() -> dict:
    """27c: a dial to a closed loopback port re-tries until the ready wait
    ends, then raises ConnectionTimeoutError."""
    with runtime_settings():
        wait = max(Settings.GRPC_TIMEOUT * 4, 2.0)
        t0 = time.perf_counter()
        try:
            GrpcCommunicationProtocol()._dial(f"127.0.0.1:{free_ports(1)[0]}")
        except ConnectionTimeoutError:
            elapsed = time.perf_counter() - t0
        else:
            raise AssertionError("grpc dial: a closed port answered")
    if not wait - 0.05 <= elapsed < wait + 2:
        raise AssertionError(f"grpc dial: ConnectionTimeoutError after {elapsed:.2f} s, the "
                             f"ready wait is {wait} s")
    return {"ready_wait_s": wait, "raised_after_s": elapsed}


def grpc_path(card: str, network: dict) -> dict:
    """Phase 27: (a) 22a's federation over gRPC, (b) streams, (c) the dial.
    Returns the results and, per conv kernel, each run's launches."""
    t0 = time.perf_counter()
    tcp, mem = network["22a tcp"], network["22a memory"]
    runs = [net_federation(card, "grpc", GrpcCommunicationProtocol, tcp["addrs"])
            for _ in range(GRPC_RUNS)]
    for r in runs:
        if r["digest"] != tcp["digest"] or r["digest"] != mem["digest"]:
            raise AssertionError("grpc path: the final params differ from 22a's in-memory and "
                                 "TCP runs")
        if not r["wire_bytes"] > 0:
            raise AssertionError("grpc path: no wire bytes counted")
    best = max(runs, key=lambda r: r["rounds_per_s"])
    out = {"27a": {**best, "rounds_per_s_runs": [r["rounds_per_s"] for r in runs],
                   "wire_bytes_runs": [r["wire_bytes"] for r in runs],
                   "bit_identical_to_22a": True,
                   "tcp_rounds_per_s": tcp["rounds_per_s"],
                   "memory_rounds_per_s": mem["rounds_per_s"],
                   "rounds_per_s_over_tcp": best["rounds_per_s"] / tcp["rounds_per_s"]}}
    out["27b"] = grpc_streams(card)
    out["27c"] = grpc_dial_timeout()
    out["phase_s"] = time.perf_counter() - t0
    out["launches"] = {k: [r["launches"][k] for r in runs] for k in ("conv_dw", "conv_dx")}
    return out


# --- phase 23: the rendered digit data ----------------------------------------

# sha256 (:func:`rendered_digest`) of the four arrays of the ``primary``
# tier's call, ``rendered_color_digits(n_train=51,200, n_test=10, seed=0)``,
# and of ``rendered_digits(n_train=2,000, n_test=400, seed=0)``, computed
# from the JAX package's renderer (PIL: Pillow 12.1.0, FreeType 2.14.1,
# matplotlib 3.10.8's DejaVu fonts; other versions may rasterise otherwise).
RENDERED_PRIMARY_SHA256 = "6d254bda40494927a38b2105210b7943f18257858e24c70f511a7fdfdf01136f"
RENDERED_DIGITS_SHA256 = "72811adad964efdbf25f3c47454fb93d3530ae2a974d2319f897b3f83ee6efd0"
RD_EVAL = 2000  # test images of rendered_color_digits(seed 1) the aggregate is scored on
RD_ACC_NODES, RD_ACC_ROUNDS = 3, 2  # the accuracy contract (tests/test_node.py:544-577)


def rendered_digest(arrays) -> str:
    """sha256 over each array's dtype, shape and bytes, in order."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def split_arrays(ds: TpflDataset) -> tuple:
    """(x_train, y_train, x_test, y_test) of a port dataset."""
    return tuple(ds.get_split(train)[name] for train in (True, False)
                 for name in ("image", "label"))


def rendered_data() -> tuple[dict, tuple]:
    """23a: the primary tier's 51,200 colour images and 2,000 + 400 digits
    rendered on the host, each held to its pinned digest (the JAX
    package's bytes). Returns the timings (host CPU seconds, not a card
    number) and the primary tier's arrays."""
    n = N_NODES * N_BATCHES * BATCH
    t0 = time.perf_counter()
    primary = split_arrays(rendered_color_digits(n_train=n, n_test=10, seed=0))
    t1 = time.perf_counter()
    digits = split_arrays(rendered_digits(n_train=2000, n_test=400, seed=0))
    t2 = time.perf_counter()
    for label, arrays, pin in (("primary", primary, RENDERED_PRIMARY_SHA256),
                               ("digits", digits, RENDERED_DIGITS_SHA256)):
        got = rendered_digest(arrays)
        if got != pin:
            raise AssertionError(f"rendered {label} data: sha256 {got}, pinned {pin} (the "
                                 "JAX package's renderer)")
    return ({"primary_images": n + 10, "primary_host_s": t1 - t0,
             "primary_images_per_s": (n + 10) / (t1 - t0), "digits_images": 2400,
             "digits_host_s": t2 - t1, "digits_images_per_s": 2400 / (t2 - t1),
             "digests_equal_pins": True, "clock": "host CPU of the card's machine"}, primary)


def rendered_fed() -> VmapFederation:
    return VmapFederation(CNN(out_channels=10, conv_impl="pallas"), n_nodes=N_NODES,
                          learning_rate=0.1, seed=0)


def rendered_windows(fed: VmapFederation, xs, ys) -> dict:
    """A first (warm-up) round from the seed's params, then
    ``MAIN_WINDOWS`` timed windows of N_ROUNDS rounds, the launch counts
    set to 0 just before the first. Returns the best wall, each window's
    (params cloned, losses), the first round's mean loss and the launches."""
    params, first = fed.run_rounds(fed.init_params((32, 32, 3)), xs, ys, epochs=EPOCHS,
                                   n_rounds=1)
    torch.cuda.synchronize()
    reset_launches()
    wall, windows = float("inf"), []
    for _ in range(MAIN_WINDOWS):
        t0 = time.perf_counter()
        params, losses = fed.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=N_ROUNDS)
        torch.cuda.synchronize()
        wall = min(wall, time.perf_counter() - t0)
        windows.append((tree_map(torch.clone, params), losses))
    return {"wall": wall, "windows": windows, "first_loss": first.mean().item(),
            "launches": read_launches(), "wgmma": read_wgmma_launches(("conv_dw", "conv_dx"))}


def rendered_accuracy(params: dict) -> float:
    """Node 0's aggregate scored on ``rendered_color_digits(n_train=10,
    n_test=RD_EVAL, seed=1)``'s test split (forward only: no conv kernel
    of the port launches)."""
    _, _, xt, yt = split_arrays(rendered_color_digits(n_train=10, n_test=RD_EVAL, seed=1))
    ev = FederationEngine(CNN(out_channels=10, conv_impl="pallas"), 1, seed=0)
    _, acc = ev.evaluate(tree_map(lambda v: v[:1], params),
                         torch.from_numpy(xt.reshape(1, RD_EVAL // 100, 100, 32, 32, 3)).to(
                             "cuda", torch.bfloat16), yt.reshape(1, RD_EVAL // 100, 100))
    return acc.item()


def rendered_window(card: str, cnn: dict, primary: tuple) -> tuple[dict, dict]:
    """23b: the primary tier's window on its own data, through the
    kernels: exactly 8 ``conv_dw`` + 4 ``conv_dx`` launches a round, all
    wgmma; finite params, one aggregate on every node; the last round's
    mean loss below the first's. Returns the results and what 23d needs."""
    x, y = primary[0], primary[1]
    fed = rendered_fed()
    xs, ys = fed.shard_data(torch.from_numpy(x.reshape(N_NODES, N_BATCHES, BATCH, 32, 32, 3)).to(
        "cuda", torch.bfloat16), y.reshape(N_NODES, N_BATCHES, BATCH))
    run = rendered_windows(fed, xs, ys)
    params, losses = run["windows"][-1]
    steps = N_BATCHES * EPOCHS * N_ROUNDS * MAIN_WINDOWS
    check_main_path(params, losses, run["launches"], {
        **dict.fromkeys(WRAPPERS, 0), "conv_dw": 2 * steps, "conv_dx": steps})
    check_all_wgmma("rendered CNN window", run["launches"], run["wgmma"])
    last = losses[-1].item()
    if not last < run["first_loss"]:
        raise AssertionError(f"rendered CNN window: last round's mean loss {last} not below "
                             f"the first's {run['first_loss']}")
    rounds_s = N_ROUNDS / run["wall"]
    return ({"card": card, "n_nodes": N_NODES, "batches": N_BATCHES, "batch": BATCH,
             "rounds": N_ROUNDS, "wall_s": run["wall"], "rounds_per_s": rounds_s,
             "samples_per_s": rounds_s * N_NODES * N_BATCHES * BATCH,
             "steady_loss": losses.mean().item(), "first_round_loss": run["first_loss"],
             "last_round_loss": last, "rounds_per_s_over_phase_1": rounds_s / cnn["rounds_per_s"],
             "accuracy_rendered_seed1_test": rendered_accuracy(params),
             "launches": run["launches"], "wgmma_launches": run["wgmma"]},
            {"xs": xs, "ys": ys, "first_window": run["windows"][0][0]})


def rendered_accuracy_contract(card: str) -> dict:
    """23c: the reference's accuracy contract (``tests/test_node.py:544-577``)
    on the card: three MLP Nodes (64 hidden, seed 7) on
    ``rendered_digits(3,000, 450, seed 5)`` split IID with seed 2, FULL,
    2 rounds × 2 epochs, lr 0.1, batch 50, the reference's test profile
    (the pool on): equal models, accuracy > 0.5 on every node."""
    parts = rendered_digits(n_train=1000 * RD_ACC_NODES, n_test=150 * RD_ACC_NODES,
                            seed=5).generate_partitions(RD_ACC_NODES, RandomIIDPartitionStrategy,
                                                        seed=2)
    SuperLearnerPool.reset()
    with runtime_settings(DISABLE_SIMULATION=False):
        nodes = [Node(TpflModel(*create_model("mlp", (28, 28), seed=7, hidden_sizes=(64,),
                                              device="cuda"), device="cuda"),
                      parts[i], addr=f"rendered-e2e-{i}", learning_rate=0.1, batch_size=50,
                      device="cuda") for i in range(RD_ACC_NODES)]
        try:
            start_federation(nodes, "FULL")
            t0 = time.perf_counter()
            nodes[0].set_start_learning(rounds=RD_ACC_ROUNDS, epochs=2)
            wait_to_finish(nodes, timeout=240)
            wall = time.perf_counter() - t0
            check_history("rendered accuracy contract", nodes, RD_ACC_ROUNDS)
            check_equal_models(nodes)
            accs = [nd.learner.evaluate()["test_metric"] for nd in nodes]
        finally:
            for nd in nodes:
                nd.stop()
            SuperLearnerPool.reset()
    if not all(a > 0.5 for a in accs):
        raise AssertionError(f"rendered accuracy contract: test accuracies {accs}, expected "
                             "> 0.5 on every node")
    return {"card": card, "nodes": RD_ACC_NODES, "rounds": RD_ACC_ROUNDS, "epochs": 2,
            "experiment_s": wall, "test_accuracy": accs, "models_equal": True}


def rendered_contracts(card: str, window: dict, handles: dict) -> dict:
    """23d: a fresh engine of 23b's seed under ``TRACE_CONTRACTS``: every
    cached program stamped, the first window's params bit-identical to
    23b's, rounds/s on against off; then a donate=True cache slot
    re-pointed at the donate=False program must raise
    ``TraceContractError`` naming ``ENGINE_DONATE`` before it launches."""
    xs, ys = handles["xs"], handles["ys"]
    steps = N_BATCHES * EPOCHS * (N_ROUNDS * MAIN_WINDOWS + 1)  # the windows, one donate=False round
    with setting("TRACE_CONTRACTS", True):
        fed = rendered_fed()
        run = rendered_windows(fed, xs, ys)
        programs = fed.engine._programs
        if not programs or not all(isinstance(fn, ContractedProgram) for fn in programs.values()):
            raise AssertionError("TRACE_CONTRACTS: a cached window program is not stamped")
        bit_equal("23d first window under TRACE_CONTRACTS", run["windows"][0][0],
                  handles["first_window"])
        params = run["windows"][-1][0]
        fed.engine.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=1, donate=False)
        key_false = next(k for k in programs if k[4] is False)
        key_true = key_false[:4] + (True,) + key_false[5:]
        programs[key_true] = programs[key_false]
        before = read_launches()
        try:
            fed.engine.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=1, donate=True)
        except TraceContractError as e:
            witness = str(e)
        else:
            raise AssertionError("TRACE_CONTRACTS: a donate=True dispatch ran the donate=False "
                                 "program")
        if "ENGINE_DONATE" not in witness or read_launches() != before:
            raise AssertionError(f"TRACE_CONTRACTS: witness {witness!r}, launches "
                                 f"{before} -> {read_launches()}")
    launches = read_launches()
    if launches != {**dict.fromkeys(WRAPPERS, 0), "conv_dw": 2 * steps, "conv_dx": steps}:
        raise AssertionError(f"TRACE_CONTRACTS windows: kernel launches {launches}, expected "
                             f"{2 * steps} conv_dw and {steps} conv_dx")
    check_all_wgmma("TRACE_CONTRACTS windows", launches,
                    read_wgmma_launches(("conv_dw", "conv_dx")))
    rounds_s = N_ROUNDS / run["wall"]
    return {"card": card, "rounds_per_s_contracts_on": rounds_s,
            "rounds_per_s_contracts_off": window["rounds_per_s"],
            "on_over_off": rounds_s / window["rounds_per_s"], "first_window_bit_identical": True,
            "programs_stamped": len(programs), "witness": witness, "launches": launches}


def rendered_path(card: str, cnn: dict) -> dict:
    """Phase 23: (a) the rendered data and its digests, (b) the primary
    tier's window on it through the kernels, (c) the reference's accuracy
    contract on the card, (d) ``TRACE_CONTRACTS`` on. Returns the results
    and, per conv kernel, the launches of 23b and 23d."""
    t0 = time.perf_counter()
    out: dict = {}
    out["23a data"], primary = rendered_data()
    out["23b window"], handles = rendered_window(card, cnn, primary)
    del primary
    out["23c accuracy contract"] = rendered_accuracy_contract(card)
    out["23d trace contracts"] = rendered_contracts(card, out["23b window"], handles)
    out["phase_s"] = time.perf_counter() - t0
    out["launches"] = {k: {"23b": out["23b window"]["launches"][k],
                           "23d": out["23d trace contracts"]["launches"][k]}
                       for k in ("conv_dw", "conv_dx")}
    return out


# --- phase 24: buffer donation in the engine window -----------------------
#
# The windows a default engine runs donate their state (Settings.ENGINE_DONATE):
# each round writes params, SCAFFOLD's variates and aux in place. Three arms:
# the CNN cell (phase 1's configuration through the conv kernels) under FedAvg
# and under SCAFFOLD (lr 0.02, as CNN_VARIANTS), and the 8-node TransformerLM
# through the flash kernels. Each: a warm round, then N_ROUNDS-round windows
# from fresh copies of one seeded state in the order donate False, True, True,
# False, each window's peak above what was allocated before it; then the
# engine's donation report. Two peaks: the bytes the window requested
# (``requested_bytes.all`` of ``torch.cuda.memory_stats``, gated) and
# ``max_memory_allocated`` (reported): the caching allocator counts a whole
# cached block when it hands one out unsplit, so the allocated peak moves
# by a block's slack between otherwise equal windows. Python's cycle
# collector runs before each window and pauses during it: a collection
# inside a window frees a cycle's tensors at a point that varies from run
# to run (a 400-byte loss vector moved the peak once).
DONATION_ORDER = (False, True, True, False)


def requested_bytes(stat: str) -> int:
    """``requested_bytes.all.<stat>`` of the card's allocator: the bytes the
    program asked for, before the allocator rounds them to its blocks."""
    return int(torch.cuda.memory_stats()[f"requested_bytes.all.{stat}"])


def tree_bytes(*trees) -> int:
    return sum(t.numel() * t.element_size() for tree in trees for _, t in tree_items(tree))


def flat_outputs(out: tuple) -> list:
    """Every tensor of a ``run_rounds`` result, in order."""
    params, state, losses = carry(out)
    trees = [params, state.get("aux", {}), *state.get("scaffold_state", ())]
    return [t for tree in trees for _, t in tree_items(tree)] + [losses]


def donation_arm(card: str, label: str, fed, fresh, xs, ys, per_round: dict) -> dict:
    """One arm of phase 24 (``fresh()`` -> (params, run_rounds' state
    keywords), a new seeded state on the card). Gated: every window's
    outputs byte-equal to the first non-donating window's; each donating
    window returns its input tensors; the donating windows' peaks below the
    non-donating ones' by at least the params state's bytes; the report
    clean, one donated leaf per state leaf; the arm's launches exactly
    ``per_round`` a round, all wgmma. Rounds/s and the allocated peaks
    both ways, not gated."""
    eng = fed.engine
    reset_launches()
    p, st = fresh()
    fed.run_rounds(p, xs, ys, epochs=EPOCHS, n_rounds=1, **st)  # warm-up
    params_bytes = tree_bytes(p)
    state_bytes = tree_bytes(p, st.get("aux", {}), *st.get("scaffold_state", ()))
    del p, st
    peaks, allocated = {False: [], True: []}, {False: [], True: []}
    walls, ref = {False: [], True: []}, None
    for donate in DONATION_ORDER:
        p, st = fresh()
        gc.collect()
        gc.disable()
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base, base_allocated = requested_bytes("current"), torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = fed.run_rounds(p, xs, ys, epochs=EPOCHS, n_rounds=N_ROUNDS, donate=donate,
                                 **st)
            torch.cuda.synchronize()
        finally:
            gc.enable()
        walls[donate].append(time.perf_counter() - t0)
        peaks[donate].append(requested_bytes("peak") - base)
        allocated[donate].append(torch.cuda.max_memory_allocated() - base_allocated)
        written = all(a is b for (_, a), (_, b) in zip(tree_items(out[0]), tree_items(p)))
        if written != donate:
            raise AssertionError(f"24 {label}: a donate={donate} window "
                                 f"{'returned new' if donate else 'wrote its input'} params")
        got = flat_outputs(out)
        if ref is None:
            ref = got
        elif not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"24 {label}: the donate={donate} window's outputs differ "
                                 "from the non-donating window's")
        del p, st, out, got
    saved = min(peaks[False]) - max(peaks[True])
    if saved < params_bytes:
        raise AssertionError(f"24 {label}: peaks {peaks} save {saved} bytes, less than the "
                             f"params state's {params_bytes}")
    p, st = fresh()
    report = eng.donation_report(p, xs, ys, epochs=EPOCHS, n_rounds=N_ROUNDS, **st)
    leaves = len(tree_leaves(p)) * (3 if "scaffold_state" in st else 1) + len(
        tree_leaves(st.get("aux", {})))
    if not report["clean"] or report["donated_leaves"] != leaves:
        raise AssertionError(f"24 {label}: donation report {report}, {leaves} state leaves")
    torch.cuda.synchronize()
    del p, st
    launches = read_launches()
    rounds = 1 + N_ROUNDS * (len(DONATION_ORDER) + 1)  # warm-up, windows, report
    want = {**dict.fromkeys(WRAPPERS, 0), **{k: v * rounds for k, v in per_round.items()}}
    if launches != want:
        raise AssertionError(f"24 {label}: kernel launches {launches}, expected {want}")
    check_all_wgmma(f"24 {label}", launches, read_wgmma_launches(per_round))
    best = {d: N_ROUNDS / min(w) for d, w in walls.items()}
    return {"card": card, "params_bytes": params_bytes, "state_bytes": state_bytes,
            "peak_requested_bytes_no_donate": peaks[False],
            "peak_requested_bytes_donate": peaks[True], "peak_saved_bytes": saved,
            "saved_over_state": saved / state_bytes,
            "max_memory_allocated_no_donate": allocated[False],
            "max_memory_allocated_donate": allocated[True],
            "allocated_saved_bytes": min(allocated[False]) - max(allocated[True]),
            "rounds_per_s_no_donate": best[False], "rounds_per_s_donate": best[True],
            "donate_over_no_donate": best[True] / best[False], "report": report,
            "outputs_byte_equal": True, "launches": launches}


def donation_path(card: str) -> dict:
    """Phase 24: the three arms, each logged as it passes."""
    t0 = time.perf_counter()
    out = {}
    steps = N_BATCHES * EPOCHS
    for label, algorithm, lr in (("cnn fedavg", "fedavg", 0.1), ("cnn scaffold", "scaffold", 0.02)):
        fed = VmapFederation(CNN(out_channels=10, conv_impl="pallas"), n_nodes=N_NODES,
                             learning_rate=lr, seed=0, algorithm=algorithm)
        xs, ys = cnn_data(fed)

        def fresh(fed=fed, algorithm=algorithm) -> tuple:
            p = fed.init_params((32, 32, 3))
            return p, ({"scaffold_state": fed.init_scaffold_state(p)}
                       if algorithm == "scaffold" else {})

        out[label] = donation_arm(card, label, fed, fresh, xs, ys,
                                  {"conv_dw": 2 * steps, "conv_dx": steps})
        log(f"donation ({label}; every check passed): " + json.dumps(out[label]))
        del fed, xs, ys
    fed = VmapFederation(TransformerLM(**LM_KW, attention_fn=fk.flash_attention),
                         n_nodes=T_NODES, learning_rate=T_LR, seed=0)
    xs, ys = fed.shard_data(*lm_tokens(T_NODES, T_BATCHES, T_BATCH, T_SEQ, LM_KW["vocab"],
                                       seed=5))
    out["transformer"] = donation_arm(
        card, "transformer", fed, lambda: (fed.init_params((T_SEQ,)), {}), xs, ys,
        dict.fromkeys(FLASH_KERNELS, LM_KW["n_layers"] * T_BATCHES * EPOCHS))
    log("donation (transformer; every check passed): " + json.dumps(out["transformer"]))
    out["phase_s"] = time.perf_counter() - t0
    return out


# ---- the pool's chunk sharded over ranks (phase 25) -----------------------------

# Phase 18a's pooled train stage (SP_NODES learners of the cell, BF_EPOCHS
# epochs of 8 batches of 25, bucket SP_BUCKET) in a world of PS_WORLD ranks
# on the one card: gloo, because nccl refuses two ranks on one device, and
# both ranks compute on cuda:0. Rank 0 leads and trains rows 0-7, rank 1
# serves rows 8-15.
PS_WORLD = 2
PS_STEPS = BF_EPOCHS * (BF_SAMPLES // BF_BATCH)  # node-batched steps of the stage
# A shard's node count. A shard trains at another node count than the
# unsharded chunk, which changes only conv_dw's f32 sum order (its blocks
# split the chunk's images), within the kernel's bound. The stage's 32
# bf16 steps at lr 0.1 amplify any such change: a start scaled by
# 1 + 2^-20 ends 5.45 leaf scales away, a shard's rows 0.378 (PERF.md
# §6). So the sharded stage is held bit-equal to unsharded chunks of
# PS_ROWS, one sharded step to the 16-row chunk at the card tolerances
# (rtol 1e-3, atol 1e-4), and the 32-step distance from the 16-row stage
# to :func:`node_count_witness`.
PS_ROWS = SP_BUCKET // PS_WORLD
PS_TIMEOUT_S = 300


def pooled_stage(n: int = SP_NODES) -> tuple:
    """One pooled train stage (:func:`pooled_round_fn`): the run, timed to
    the card's end (s), and its learners."""
    run = pooled_round_fn(n)

    def timed() -> float:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    return timed, run.learners


def host_params(learners: list) -> list:
    return [{p: v.detach().float().cpu() for p, v in tree_items(ln.get_model().get_parameters())}
            for ln in learners]


def pool_shard_rank(rank: int, port: int, out: str) -> None:
    """Phase 25's rank (``chip_smoke.py --pool-rank R PORT OUT``): joins the
    gloo world on the card with SHARD_NODES on. Rank 0 runs a warm stage
    and a timed one (its conv launches counted) through the pool, saves
    the timed stage's params, fits the 1-step rows (:func:`witness_rows`)
    and saves theirs, then stops rank 1 (``stop_pool_servants``), which
    served the three chunks. Each writes its conv launches (all and
    wgmma, by node count) to ``OUT.json``."""
    import datetime

    from tpfl_torch.parallel import distributed as spmd
    from tpfl_torch.simulation import serve_pool_shards

    spmd.ensure_distributed(f"127.0.0.1:{port}", PS_WORLD, rank, device="cpu",
                            timeout=datetime.timedelta(seconds=PS_TIMEOUT_S))
    torch.cuda.set_device(0)
    # TF32 off, as the parent runs from its kernel phase on.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res: dict = {"rank": rank}

    def counted(by_n: dict) -> None:
        res["launches"] = {k: read_launches()[k] for k in ("conv_dw", "conv_dx")}
        res["wgmma_launches"] = read_wgmma_launches(("conv_dw", "conv_dx"))
        res["by_node_count"] = {k: {str(n): c for n, c in v.items()} for k, v in by_n.items()}

    with runtime_settings(SHARD_NODES=True, SHARD_DEVICES=0, SHARD_HOSTS=1, SHARD_MODEL=1):
        reset_launches()
        with conv_node_counts() as by_n:
            if rank:
                res["served"] = serve_pool_shards()
                res["h2d_copies"] = batched_fit.h2d_copies
                counted(by_n)
            else:
                warm, _ = pooled_stage()
                res["warm_wall_s"] = warm()
                reset_launches()
                for counts in by_n.values():
                    counts.clear()
                timed, learners = pooled_stage()
                res["wall_s"] = timed()
                counted(by_n)
                res["pool"] = pool_stats()
                torch.save(host_params(learners), out + ".pt")
                torch.save(fit_rows(witness_rows(steps=1, prefix="sp-step"), SP_BUCKET),
                           out + "-step.pt")
                SuperLearnerPool.reset()
                batched_fit.stop_pool_servants()
    Path(out + ".json").write_text(json.dumps(res))
    torch.distributed.destroy_process_group()


def pool_unsharded(card: str) -> dict:
    """Phase 25's stage here, in the ranks' settings, unsharded: at N =
    SP_BUCKET (warm, then timed with its launches gated), and the same
    learners as chunks of PS_ROWS (rows 0-7, then 8-9 beside six fillers:
    rows never mix, so each learner trains as on its rank)."""
    with runtime_settings():
        SuperLearnerPool.reset()
        warm, _ = pooled_stage()
        warm()
        SuperLearnerPool.reset()
        reset_launches()
        with conv_node_counts() as by_n:
            timed, learners = pooled_stage()
            wall = timed()
        launches, wgmma = read_launches(), read_wgmma_launches(("conv_dw", "conv_dx"))
        stats = pool_stats()
        tag = "pool sharded (the unsharded stage)"
        check_conv_launches(tag, launches, wgmma, PS_STEPS)
        check_at_nodes(tag, by_n, {"conv_dw": {SP_BUCKET: 2 * PS_STEPS},
                                   "conv_dx": {SP_BUCKET: PS_STEPS}})
        out = {"wall_s": wall, "pool": stats, "n16": host_params(learners)}
        SuperLearnerPool.reset()
        out["n8"] = fit_rows(witness_rows(), PS_ROWS)
        SuperLearnerPool.reset()
    return out


class CheckedKernel(CountingKernel):
    """Stands in for a conv kernel's wrapper: launches the kernel and holds
    each launch's output to the plain version on the same inputs within
    ``bound``, recording the largest |err| / max |plain| under ``name`` in
    ``worst`` and each launch beyond the bound in ``worst["beyond"]``."""

    def __init__(self, kernel, plain, bound: tuple, name: str, worst: dict) -> None:
        super().__init__(kernel)
        self.plain, self.bound, self.name, self.worst = plain, bound, name, worst

    def __call__(self, *args):
        out = self.kernel(*args)
        w = self.worst
        w["launches"] += 1
        try:
            ref = self.plain(*args)
            check_close(f"{self.name} launch {w['launches']} {tuple(args[0].shape)}", out, ref,
                        *self.bound)
            err = (out.float() - ref.float()).abs().max().item()
            w[self.name] = max(w[self.name], err / max(ref.abs().max().item(), 1e-30))
        except AssertionError as e:
            w["beyond"].append(str(e))
        return out


@contextlib.contextmanager
def convs_as(mode: str):
    """While open, the conv backward runs ``mode``: ``"kernels"`` as
    always, ``"plain"`` the kernels' plain versions, ``"checked"`` the
    kernels through :class:`CheckedKernel` (yields what it records)."""
    saved = ck.conv_dw, ck.conv_dx
    worst: dict = {"conv_dw": 0.0, "conv_dx": 0.0, "launches": 0, "beyond": []}
    if mode == "plain":
        ck.conv_dw, ck.conv_dx = ck.conv_dw_plain, ck.conv_dx_plain
    elif mode == "checked":
        ck.conv_dw = CheckedKernel(saved[0], ck.conv_dw_plain, CONV_DW_BOUND, "conv_dw", worst)
        ck.conv_dx = CheckedKernel(saved[1], ck.conv_dx_plain, CONV_DX_BOUND, "conv_dx", worst)
    try:
        yield worst
    finally:
        ck.conv_dw, ck.conv_dx = saved


def witness_rows(steps: int = PS_STEPS, dtype: torch.dtype = torch.bfloat16,
                 nudge: float = 0.0, prefix: str = "sp-round") -> list:
    """Phase 25's SP_BUCKET rows as learners: the stage's SP_NODES
    (seeds BF_SEED + i) and the fillers of its chunks of PS_ROWS (seeds
    BF_SEED + j, ``sp-fill-j``), compute ``dtype``, each fitting
    ``steps`` node-batched steps (1: one batch of 25; else epochs of the
    8 batches), every start param scaled by 1 + ``nudge``."""
    samples = BF_BATCH if steps == 1 else BF_SAMPLES
    rows = []
    for i in range(SP_BUCKET):
        seed, addr = ((BF_SEED + i, f"{prefix}-{i}") if i < SP_NODES
                      else (BF_SEED + i - SP_NODES, f"sp-fill-{i - SP_NODES}"))
        module = CNN(**{**PHASE_CNN, "compute_dtype": dtype})
        start = init_params(module, (32, 32, 3), seed=BF_SEED, device=PHASE_DEVICE)
        if nudge:
            start = tree_map(lambda v: v * (1.0 + nudge), start)
        data = TpflDataset.from_arrays(*synthetic_cifar10(n_train=samples, n_test=BF_BATCH,
                                                          seed=seed))
        ln = TorchLearner(TpflModel(module, start, device=PHASE_DEVICE), data, addr=addr,
                          learning_rate=0.1, batch_size=BF_BATCH, device=PHASE_DEVICE)
        ln.set_epochs(max(steps // (samples // BF_BATCH), 1))
        rows.append(ln)
    return rows


def fit_rows(rows: list, chunk: int) -> list:
    """``rows`` through ``run_batched_fits`` in chunks of ``chunk``; the
    first SP_NODES learners' params on the host."""
    with setting("SIM_MAX_BATCH_NODES", chunk):
        if batched_fit.run_batched_fits(batched_fit.job_signature(rows[0]), rows):
            raise AssertionError(f"a chunk of {chunk} failed")
    torch.cuda.synchronize()
    return host_params(rows[:SP_NODES])


def witness_stage(chunk: int, mode: str = "kernels", **rows) -> tuple[list, dict]:
    """:func:`fit_rows` of :func:`witness_rows` (``rows``) with the conv
    backward as :func:`convs_as` ``mode``: the params and the checked
    launches' worst relative error."""
    with convs_as(mode) as worst:
        return fit_rows(witness_rows(**rows), chunk), worst


def leaf_gap(got: list, want: list) -> dict:
    """The largest |got − want| over the leaf's largest |want|, over
    learners and leaves, and where it is."""
    worst = {"rel": 0.0, "abs": 0.0, "leaf": None}
    for i, (g, w) in enumerate(zip(got, want)):
        for path, ref in w.items():
            e = (g[path] - ref).abs().max().item()
            rel = e / max(ref.abs().max().item(), 1e-30)
            if not math.isfinite(e) or rel > worst["rel"]:
                worst = {"rel": rel, "abs": e, "leaf": f"learner {i} {path}"}
    return worst


def op_node_invariance() -> dict:
    """Each conv op of the CNN's two layers at B 25 on SP_BUCKET nodes
    and on their first PS_ROWS: max |difference| of those nodes' outputs
    (0: the op's rounding does not depend on the node count)."""
    gen = torch.Generator(device="cuda").manual_seed(25)
    out = {}
    for name, h, w, cin, cout, _ in LAYERS:
        x = torch.randn(SP_BUCKET, BF_BATCH, h, w, cin, device="cuda", generator=gen).bfloat16()
        g = torch.randn(SP_BUCKET, BF_BATCH, h, w, cout, device="cuda", generator=gen).bfloat16()
        wk = (0.1 * torch.randn(SP_BUCKET, 3, 3, cin, cout, device="cuda",
                                generator=gen)).bfloat16()
        ops = {"forward (grouped F.conv2d)": lambda a, b, c: ck.conv_forward(a, c),
               "conv_dw": lambda a, b, c: ck.conv_dw(a, b, 3),
               "conv_dx": lambda a, b, c: ck.conv_dx(b, c),
               "conv_dw_plain": lambda a, b, c: ck.conv_dw_plain(a, b, 3),
               "conv_dx_plain": lambda a, b, c: ck.conv_dx_plain(b, c)}
        for op, f in ops.items():
            full = f(x, g, wk)[:PS_ROWS].float()
            part = f(x[:PS_ROWS], g[:PS_ROWS], wk[:PS_ROWS]).float()
            out[f"{name} {op}"] = (full - part).abs().max().item()
    return out


def node_count_witness(want: dict) -> dict:
    """Why the stage trained in chunks of PS_ROWS ends apart from the
    SP_BUCKET-row stage on the card (``want``: :func:`pool_unsharded`).
    Gated (``failures``): the same rows as one chunk of SP_BUCKET give
    the pool's bits (its pad rows are no-ops) and as chunks of PS_ROWS
    the bits of ``want``; at both chunk sizes every conv launch of the
    stage agrees with its plain version on the same inputs within the
    kernel's bound; through the plain versions the two chunk sizes give
    the same bits (the node count changes only conv_dw's f32 sum order);
    and the node count moves the params no further than a start scaled
    by 1 + 2^-20 does at one node count (the stage's own sensitivity to
    a rounding-size change). Reported: each op's node-count invariance,
    the kernels against the plain versions at one node count, and the
    same node-count gap in f32."""
    out: dict = {"ops_n8_vs_n16_max_abs": op_node_invariance(), "failures": []}
    k16, out["checked_n16"] = witness_stage(SP_BUCKET, "checked")
    k8, out["checked_n8"] = witness_stage(PS_ROWS, "checked")
    for n in ("n16", "n8"):
        out["failures"] += [f"the stage at {n}: {e}" for e in out[f"checked_{n}"]["beyond"][:4]]
    for label, got, ref in (("n16 rows vs the pool's stage", k16, want["n16"]),
                            ("n8 rows vs the chunks of 8", k8, want["n8"])):
        gap = leaf_gap(got, ref)
        if gap["abs"] != 0.0:
            out["failures"].append(f"{label} differ: {gap}")
    p16, _ = witness_stage(SP_BUCKET, "plain")
    p8, _ = witness_stage(PS_ROWS, "plain")
    out["plain n8 vs n16"] = leaf_gap(p8, p16)
    if out["plain n8 vs n16"]["abs"] != 0.0:
        out["failures"].append(f"the plain versions' stage depends on the node count: "
                               f"{out['plain n8 vs n16']}")
    nudged, _ = witness_stage(SP_BUCKET, nudge=2.0 ** -20)
    out["update"] = leaf_gap(host_params(witness_rows()[:SP_NODES]), k16)["rel"]
    out["kernels n8 vs n16"] = leaf_gap(k8, k16)
    out["nudged 2^-20 vs n16"] = leaf_gap(nudged, k16)
    out["kernels vs plain at n16"] = leaf_gap(k16, p16)
    f16, _ = witness_stage(SP_BUCKET, dtype=torch.float32)
    f8, _ = witness_stage(PS_ROWS, dtype=torch.float32)
    out["f32 kernels n8 vs n16"] = leaf_gap(f8, f16)
    if out["kernels n8 vs n16"]["rel"] > out["nudged 2^-20 vs n16"]["rel"]:
        out["failures"].append(f"the node count moves the params {out['kernels n8 vs n16']}, "
                               f"further than a nudged start "
                               f"{out['nudged 2^-20 vs n16']}")
    return out


def pool_sharded_path(card: str) -> dict:
    """Phase 25: the pooled stage sharded over two ranks of a gloo world
    on the card, against the same stage unsharded here, run first with
    the card to itself. Gated: each rank's conv launches exactly 2
    conv_dw + 1 conv_dx a step at N = PS_ROWS, all wgmma; rank 1 served
    three chunks; one batched dispatch of SP_NODES fits a stage and no
    fallback; the gathered params bit-equal to the unsharded chunks at N
    = PS_ROWS; one sharded step within rtol 1e-3 / atol 1e-4 of the
    unsharded N = SP_BUCKET chunk; the 32-step distance from the N =
    SP_BUCKET stage held by :func:`node_count_witness`. Both walls are
    reported beside the card."""
    t0 = time.perf_counter()
    # The unsharded stages first, with the card to themselves.
    want = pool_unsharded(card)
    with runtime_settings():
        witness = node_count_witness(want)
        if witness["failures"]:
            raise AssertionError("node-count witness: " + "; ".join(witness["failures"]))
        want_step = fit_rows(witness_rows(steps=1, prefix="sp-step"), SP_BUCKET)
    port = free_ports(1)[0]
    with tempfile.TemporaryDirectory() as tmp:
        outs = [str(Path(tmp) / f"rank{r}") for r in range(PS_WORLD)]
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--pool-rank",
                                   str(r), str(port), outs[r]], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for r in range(PS_WORLD)]
        try:
            for r, proc in enumerate(procs):
                _, err = proc.communicate(timeout=PS_TIMEOUT_S)
                if proc.returncode != 0:
                    raise AssertionError(f"pool shard rank {r} exited {proc.returncode}: "
                                         f"{err[-3000:]}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        ranks = [json.loads(Path(o + ".json").read_text()) for o in outs]
        got = torch.load(outs[0] + ".pt")
        got_step = torch.load(outs[0] + "-step.pt")
    # Rank 0 counts its timed stage, rank 1 every chunk it served: the
    # warm and the timed stage and the 1-step one.
    for res, steps in ((ranks[0], PS_STEPS), (ranks[1], 2 * PS_STEPS + 1)):
        r = res["rank"]
        want_n = {"conv_dw": {str(PS_ROWS): 2 * steps}, "conv_dx": {str(PS_ROWS): steps}}
        if res["by_node_count"] != want_n:
            raise AssertionError(f"pool sharded rank {r}: conv launches by node count "
                                 f"{res['by_node_count']}, expected {want_n}")
        check_all_wgmma(f"pool sharded rank {r}", res["launches"], res["wgmma_launches"])
    if ranks[1]["served"] != 3:
        raise AssertionError(f"pool sharded: rank 1 served {ranks[1]['served']} chunks, expected 3")
    # One step, before training has grown the rounding: the sharded chunk
    # at the card tolerances of the unsharded SP_BUCKET-row chunk.
    step_err = 0.0
    for i, g in enumerate(got_step):
        for path, ref in want_step[i].items():
            torch.testing.assert_close(g[path], ref, rtol=1e-3, atol=1e-4,
                                       msg=lambda m, p=path, i=i: f"pool sharded, 1 step: "
                                       f"learner {i} {p}: {m}")
            step_err = max(step_err, (g[path] - ref).abs().max().item())
    pool = ranks[0]["pool"]
    if pool["group_sizes"] != [SP_NODES] * 2 or pool["fallbacks"] or pool["singles"]:
        raise AssertionError(f"pool sharded: rank 0's pool {pool}, expected one dispatch of "
                             f"{SP_NODES} fits a stage")
    err16 = rel16 = 0.0
    for i, g in enumerate(got):
        for path, ref in want["n8"][i].items():
            if not torch.equal(g[path], ref):
                raise AssertionError(f"pool sharded: learner {i} {path} differs from the "
                                     f"unsharded chunk of {PS_ROWS} by "
                                     f"{(g[path] - ref).abs().max().item():.3e}")
            n16 = want["n16"][i][path]
            e = (g[path] - n16).abs().max().item()
            err16, rel16 = max(err16, e), max(rel16, e / max(n16.abs().max().item(), 1e-30))
    return {"card": card, "world": PS_WORLD, "backend": "gloo", "nodes": SP_NODES,
            "bucket": SP_BUCKET, "rows_per_rank": PS_ROWS, "steps": PS_STEPS,
            "sharded_wall_s": ranks[0]["wall_s"], "sharded_warm_wall_s": ranks[0]["warm_wall_s"],
            "unsharded_wall_s": want["wall_s"], "sharded_over_unsharded_wall":
                ranks[0]["wall_s"] / want["wall_s"],
            "bit_equal_to_unsharded_at_n8": True, "max_abs_err_vs_unsharded_n16": err16,
            "max_err_over_leaf_scale_vs_n16": rel16,
            "one_step_max_abs_err_vs_unsharded_n16": step_err, "node_count_witness": witness,
            "unsharded_pool": want["pool"],
            "rank0_pool": pool,
            "launches": {f"rank {res['rank']}": res["launches"] for res in ranks},
            "wgmma_launches": {f"rank {res['rank']}": res["wgmma_launches"] for res in ranks},
            "served": ranks[1]["served"], "servant_h2d_copies": ranks[1]["h2d_copies"],
            "phase_s": time.perf_counter() - t0}


def _union_ms(spans: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals, in ms (from µs)."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def profile_round(fed_args: tuple) -> dict:
    """One more round of a main path under :func:`profile_call`."""
    fed, params, xs, ys, state = fed_args
    return profile_call(lambda: fed.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=1,
                                               **state))


def profile_call(run) -> dict:
    """``run()`` under ``torch.profiler``: device time by kernel,
    and the share of the call's wall time in which the card ran no
    kernel. Device intervals are read from the trace's device events.
    Kernels that run at once (on different streams) overlap, so their
    summed time exceeds the time the card was busy: the busy time is
    the union of the intervals, and the overlap is reported beside it,
    with the device time of each stream. User-annotation ranges
    projected onto the device timeline are kept apart.
    ``busy_over_wall`` is reported as measured, not clamped."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kernels, annotations, per_stream = [], [], {}
    for ev in prof.events():
        if ev.device_type != cuda:
            continue
        span = (ev.time_range.start, ev.time_range.end)
        (annotations if ev.is_user_annotation else kernels).append(span)
        if not ev.is_user_annotation:
            sid = int(ev.device_resource_id)
            per_stream[sid] = per_stream.get(sid, 0.0) + (span[1] - span[0]) / 1e3
    sum_ms = sum(b - a for a, b in kernels) / 1e3
    union_ms = _union_ms(kernels)
    span_ms = (max(b for _, b in kernels) - min(a for a, _ in kernels)) / 1e3
    rows = []
    for ev in prof.key_averages():
        if (ev.device_type == cuda and not ev.is_user_annotation
                and ev.self_device_time_total > 0):
            rows.append((ev.self_device_time_total / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    return {
        "wall_ms": wall_ms, "device_events": len(kernels),
        "device_sum_ms": sum_ms, "device_union_ms": union_ms,
        "device_overlap_ms": sum_ms - union_ms, "device_span_ms": span_ms,
        "device_ms_by_stream": per_stream,
        "annotation_events": len(annotations),
        "annotation_sum_ms": sum(b - a for a, b in annotations) / 1e3,
        "busy_over_wall": union_ms / wall_ms,
        "idle_share": 1.0 - union_ms / wall_ms,
        "top": [{"ms": ms, "calls": n, "kernel": k[:90]} for ms, n, k in rows[:16]],
    }


# ---- the Parquet data plane (phase 26) -------------------------------------------
#
# The committed Hugging Face directory tests/data/torch_hf_digits (written by
# tests/make_torch_parquet_fixture.py through `datasets`): the port's
# rendered_color_digits(512, 128, seed 7) quantised to uint8, as PNG bytes in an
# Image() column beside ClassLabel(10) labels, in Parquet. The card's machine has
# no pyarrow, datasets or PIL: the port's own reader decodes it on the host.
PQ_DIR = Path(__file__).resolve().parent / "tests" / "data" / "torch_hf_digits"
PQ_N_TRAIN, PQ_N_TEST, PQ_SEED = 512, 128, 7
# sha256 of the reference loader's arrays (printed by the fixture's script).
PQ_PINS = {
    "train_image": "7e1fbaba3c48c14f40b2af3a8aa1e301c10c36bda0fb11e4697da61e7e77cd69",
    "train_label": "a4df373816e684a2b5cc86a3f8eba12007a3f1ca429b2c012c2a5e80a5e7f6b8",
    "test_image": "c4d8b530f0864f97ec10ed7efca3e99b192fec41166b167dfde1e0aae0891a00",
    "test_label": "be09058cb53e757f788f7a5242d2331709c45a485f8ccb65f00a760b0d3bdcca",
}
PQ_NODES, PQ_BATCHES, PQ_BATCH = 4, 4, 32  # 128 train images a node: 8 + 4 launches a round
PQ_RTOL, PQ_ATOL = 1e-3, 1e-4  # the f32 round, kernels vs their plain versions on the card
# Phase 28: the same digits as JPEG bytes PIL wrote (tests/make_torch_parquet_fixture.py
# --format jpeg), decoded by the port's numpy JPEG decoder; the pins are the reference
# loader's arrays, i.e. PIL's libjpeg-turbo decode.
JPEG_DIR = Path(__file__).resolve().parent / "tests" / "data" / "torch_hf_jpeg_digits"
JPEG_PINS = {
    "train_image": "7f455c12dfdfc21cccdc7ec47e3d7a3c90589650fbced6ef120ac206ff5d6318",
    "train_label": "a4df373816e684a2b5cc86a3f8eba12007a3f1ca429b2c012c2a5e80a5e7f6b8",
    "test_image": "4e2d456cbc9adae5ff7ebf2b01159fb438b8a30dd7d5af21020d264d0d2d6505",
    "test_label": "be09058cb53e757f788f7a5242d2331709c45a485f8ccb65f00a760b0d3bdcca",
}


class PqFixture(NamedTuple):
    """A Hugging Face directory phases 26 and 28 decode: its phase label,
    directory, pins, and whether its images are the renderer's exactly
    (PNG is lossless, JPEG is not)."""
    phase: str
    directory: Path
    pins: dict
    rendered: bool

    @property
    def train_file(self) -> Path:
        return self.directory / "data" / "train-00000-of-00001.parquet"


PNG_FIXTURE = PqFixture("26", PQ_DIR, PQ_PINS, True)
JPEG_FIXTURE = PqFixture("28", JPEG_DIR, JPEG_PINS, False)


def sha256_of(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def parquet_decode(fx: PqFixture = PNG_FIXTURE) -> tuple[dict, TpflDataset]:
    """26a / 28a: the fixture through ``from_huggingface`` and its train
    file through ``from_parquet`` on the host. Gated: the two give the
    same train arrays; every split's arrays equal the reference loader's
    pins; for the PNG fixture, the images equal the port's renderer
    quantised as the fixture's script does. The seconds and images/s of
    each decode are host numbers."""
    label = f"{fx.phase}a"
    t0 = time.perf_counter()
    ds = TpflDataset.from_huggingface(str(fx.directory))
    hf_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    flat = TpflDataset.from_parquet(str(fx.train_file)).get_split(True)
    pq_s = time.perf_counter() - t0
    train = ds.get_split(True)
    if flat.column_names != train.column_names or not all(
            np.array_equal(flat[c], train[c]) for c in train.column_names):
        raise AssertionError(f"{label}: from_parquet of the train file differs from "
                             "from_huggingface's train split")
    rendered = rendered_color_digits(PQ_N_TRAIN, PQ_N_TEST, seed=PQ_SEED) if fx.rendered else None
    for split, is_train in (("train", True), ("test", False)):
        part = ds.get_split(is_train)
        x, y = part["image"], np.asarray(part["label"], np.int64)
        if x.dtype != np.uint8 or x.shape[1:] != (32, 32, 3):
            raise AssertionError(f"{label}: {split} images {x.dtype} {x.shape}")
        got = {f"{split}_image": sha256_of(x), f"{split}_label": sha256_of(y)}
        for key, digest in got.items():
            if digest != fx.pins[key]:
                raise AssertionError(f"{label}: {key} sha256 {digest}, pinned {fx.pins[key]}")
        if rendered is not None:
            want = np.rint(np.asarray(rendered.get_split(is_train)["image"], np.float32) * 255
                           ).astype(np.uint8)
            if not np.array_equal(x, want):
                raise AssertionError(f"{label}: the {split} images differ from the port's "
                                     "renderer")
    n = PQ_N_TRAIN + PQ_N_TEST
    return ({"from_huggingface_s": hf_s, "images_per_s": n / hf_s,
             "from_parquet_train_s": pq_s, "from_parquet_images_per_s": PQ_N_TRAIN / pq_s,
             "images": n, "pins": "equal"} | ({"rendered": "equal"} if fx.rendered else {}), ds)


def parquet_node_data(ds: TpflDataset) -> tuple[np.ndarray, np.ndarray]:
    """Each node's 128 train images of ``generate_partitions(PQ_NODES,
    RandomIIDPartitionStrategy)`` through the export (float32 scaled by
    1/255: the export keeps an integer column integer unless asked, as
    the reference's does; the seed-0 epoch's shuffle), stacked [node,
    batch, ...]."""
    parts = ds.generate_partitions(PQ_NODES, RandomIIDPartitionStrategy)
    stacked = [p.export(batch_size=PQ_BATCH, scale=1 / 255.0, x_dtype=np.float32).stacked()
               for p in parts]
    return np.stack([x for x, _ in stacked]), np.stack([y for _, y in stacked])


def parquet_f32_round(xs: np.ndarray, ys: np.ndarray, device) -> dict:
    """One f32 round of the full-width CNN on ``device`` from the seed's
    params: the card's kernels, or the CPU's plain versions."""
    fed = VmapFederation(CNN(out_channels=10, conv_impl="pallas", compute_dtype=torch.float32),
                         n_nodes=PQ_NODES, learning_rate=0.1, seed=0, device=device)
    params, losses = fed.run_rounds(fed.init_params((32, 32, 3)), xs, ys, epochs=EPOCHS,
                                    n_rounds=1)
    return {path: v.detach().float().cpu() for path, v in tree_items(params)} | {
        "losses": losses.detach().float().cpu()}


def parquet_window(card: str, ds: TpflDataset, fx: PqFixture = PNG_FIXTURE) -> dict:
    """26b / 28b: the CNN at full width on 4 nodes of the decoded data, bf16:
    a warm round with every conv launch held to its plain version on the
    same inputs (:func:`convs_as` ``"checked"``), then one N_ROUNDS
    window. Gated: exactly 8 conv_dw + 4 conv_dx launches a round in the
    warm round and in the window, all wgmma, none beyond its bound;
    finite losses and one finite aggregate on every node; one f32 round
    through the kernels (8 + 4 launches, the CUDA-core f32 kernels)
    within rtol 1e-3 / atol 1e-4 of the same round through their plain
    versions on the card (no launch). Reported: rounds/s, node 0's
    accuracy on the fixture's test split, and the same round on the CPU
    (every op there rounds differently, and 4 steps at lr 0.1 on these
    images grow that to ~3e-4: not a kernel's error, the card's plain
    versions are as far)."""
    x, y = parquet_node_data(ds)
    label = f"{fx.phase}b"
    fed = VmapFederation(CNN(out_channels=10, conv_impl="pallas"), n_nodes=PQ_NODES,
                         learning_rate=0.1, seed=0)
    xs, ys = fed.shard_data(torch.from_numpy(x).to("cuda", torch.bfloat16), y)
    per_round = PQ_BATCHES * EPOCHS
    want_round = {**dict.fromkeys(WRAPPERS, 0), "conv_dw": 2 * per_round, "conv_dx": per_round}
    reset_launches()
    with convs_as("checked") as worst:
        params, losses = fed.run_rounds(fed.init_params((32, 32, 3)), xs, ys, epochs=EPOCHS,
                                        n_rounds=1)
        torch.cuda.synchronize()
    check_main_path(params, losses, read_launches(), want_round)
    check_all_wgmma(f"{label} checked round", read_launches(),
                    read_wgmma_launches(("conv_dw", "conv_dx")))
    if worst["beyond"] or worst["launches"] != 3 * per_round:
        raise AssertionError(f"{label} checked round: {worst['launches']} launches, beyond their "
                             f"bounds: {worst['beyond'][:4]}")
    checked = {k: worst[k] for k in ("conv_dw", "conv_dx", "launches")}
    reset_launches()
    t0 = time.perf_counter()
    params, losses = fed.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=N_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    wgmma = read_wgmma_launches(("conv_dw", "conv_dx"))
    check_main_path(params, losses, launches, {
        k: v * N_ROUNDS for k, v in want_round.items()})
    check_all_wgmma(f"{label} window", launches, wgmma)
    test = ds.get_split(False)
    xt = torch.from_numpy(test["image"].astype(np.float32) * np.float32(1 / 255.0)).to(
        "cuda", torch.bfloat16).reshape(1, 1, PQ_N_TEST, 32, 32, 3)
    ev = FederationEngine(CNN(out_channels=10, conv_impl="pallas"), 1, seed=0)
    _, acc = ev.evaluate(tree_map(lambda v: v[:1], params), xt,
                         np.asarray(test["label"], np.int32).reshape(1, 1, PQ_N_TEST))
    torch.backends.cudnn.allow_tf32 = False  # as every card-vs-CPU phase: f32 is f32
    torch.backends.cuda.matmul.allow_tf32 = False
    f32_launches = {}
    reset_launches()
    card_f32 = parquet_f32_round(x, y, None)
    f32_launches["kernels"] = read_launches()
    reset_launches()
    with convs_as("plain"):
        plain_f32 = parquet_f32_round(x, y, None)
    f32_launches["plain"] = read_launches()
    if f32_launches != {"kernels": want_round, "plain": dict.fromkeys(WRAPPERS, 0)}:
        raise AssertionError(f"{label} f32 rounds: launches {f32_launches}, expected {want_round} "
                             "through the kernels and none through the plain versions")
    cpu_f32 = parquet_f32_round(x, y, "cpu")
    worst = {"plain": 0.0, "cpu": 0.0}
    for path, want in plain_f32.items():
        got = card_f32[path]
        torch.testing.assert_close(got, want, rtol=PQ_RTOL, atol=PQ_ATOL,
                                   msg=lambda m, p=path: f"{label} f32 round, {p}: {m}")
        worst["plain"] = max(worst["plain"], (got - want).abs().max().item())
        worst["cpu"] = max(worst["cpu"], (got - cpu_f32[path]).abs().max().item())
    return {"card": card, "nodes": PQ_NODES, "batches": PQ_BATCHES, "batch": PQ_BATCH,
            "rounds": N_ROUNDS, "wall_s": wall, "rounds_per_s": N_ROUNDS / wall,
            "steady_loss": losses.mean().item(), "node0_test_accuracy": acc.item(),
            "checked_round_max_rel_err": checked,
            "f32_round_launches": f32_launches["kernels"],
            "f32_round_kernels_vs_plain_max_abs": worst["plain"],
            "f32_round_card_vs_cpu_max_abs": worst["cpu"], "launches": launches,
            "wgmma_launches": wgmma}


def parquet_path(card: str) -> dict:
    """Phase 26: (a) the Parquet fixture decoded on the host and held to
    its pins; (b) both conv kernels at the window's shape (both CNN
    layers, N 4 B 32, bf16) through :func:`conv_layer_rows` (wgmma, held
    to the plain versions, timed), then the CNN window on the decoded
    data through the kernels."""
    t0 = time.perf_counter()
    out: dict = {}
    out["26a decode"], ds = parquet_decode()
    gen = torch.Generator(device="cuda").manual_seed(26)
    out["26b kernel rows"] = {f"N={PQ_NODES} B={PQ_BATCH}": conv_layer_rows(PQ_NODES, PQ_BATCH,
                                                                              gen)}
    out["26b window"] = parquet_window(card, ds)
    out["phase_s"] = time.perf_counter() - t0
    out["launches"] = {k: out["26b window"]["launches"][k] for k in ("conv_dw", "conv_dx")}
    return out


def jpeg_path(card: str) -> dict:
    """Phase 28: (a) the JPEG fixture decoded on the host by the port's
    JPEG decoder and held to the reference loader's pins; (b) 26b's window
    on those images through the kernels (the kernel shape is 26b's, timed
    there)."""
    t0 = time.perf_counter()
    out: dict = {}
    out["28a decode"], ds = parquet_decode(JPEG_FIXTURE)
    out["28b window"] = parquet_window(card, ds, JPEG_FIXTURE)
    out["phase_s"] = time.perf_counter() - t0
    out["launches"] = {k: out["28b window"]["launches"][k] for k in ("conv_dw", "conv_dx")}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if "--fleet-rank" in sys.argv[1:]:
        fleet_rank(int(sys.argv[sys.argv.index("--fleet-rank") + 1]))
        return 0
    if "--net-child" in sys.argv[1:]:
        net_child(json.loads(sys.argv[sys.argv.index("--net-child") + 1]))
        return 0
    if "--pool-rank" in sys.argv[1:]:
        i = sys.argv.index("--pool-rank")
        pool_shard_rank(int(sys.argv[i + 1]), int(sys.argv[i + 2]), sys.argv[i + 3])
        return 0
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch.cuda.get_device_name: {kind} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build(_build.all_sources())
    log(f"build: {time.perf_counter() - t0:.1f} s")
    built = build_report()

    rows = kernel_phase()
    log("conv kernel phase: ok")
    by_name = {r["name"]: r for r in rows}
    edge_err = conv_edge_cases()
    by_name["conv_dx"]["bf16_edge_max_rel_err"] = edge_err
    log(f"conv kernel phase [{len(ck.WGMMA_DX_EDGES)} bf16 conv_dx edge cases, wgmma]: ok, "
        f"worst max |err| / max |ref| {edge_err:.3e}")
    edge_err = conv_dw_edge_cases()
    by_name["conv_dw"]["bf16_edge_max_rel_err"] = edge_err
    log(f"conv kernel phase [{len(ck.WGMMA_DW_EDGES)} bf16 conv_dw edge cases, wgmma]: ok, "
        f"worst max |err| / max |ref| {edge_err:.3e}")
    limits = conv_node_limit_cases()
    log("conv kernel phase [65537 nodes]: ok " + json.dumps(limits))
    reference_phase()
    log("CNN reference phase (pallas and fwd_bwd vs xla, f32, small, TF32 off): ok")
    cnn, cnn_args = main_path(card)
    log("CNN main path: " + json.dumps(cnn))
    log("CNN round with conv_impl='fwd_bwd' (library convolutions, no port kernel): "
        + json.dumps(fwd_bwd_round(card)))
    log("kinds reference phase (ResNet-18 scaffold/local and fedprox, CNN scaffold, f32, "
        "small, card vs CPU; codec fold bit-equal): ok " + json.dumps(kinds_reference_phase()))
    log("codec phase (CNN leaf shapes, 100 nodes, bit-equal to the numpy oracles): ok "
        + json.dumps(codec_phase()))
    for label, result in cnn_variant_paths(card).items():
        log(f"CNN main path ({label}): " + json.dumps(result))
    log("protocol reference phase (TorchLearner fit, narrow f32 CNN through the kernels, "
        f"card vs CPU): ok, max |err| {protocol_reference_phase():.3e}")
    protocol, protocol_learner = protocol_path(card)
    for label, result in protocol.items():
        log(f"protocol path ({label}): " + json.dumps(result))
    byzantine, byzantine_round_fn = byzantine_protocol_path(card)
    log("byzantine path (10 CNN learners, 20% sign-flip + 20% noise; detections, quarantine, "
        "robust aggregates held to plain f64): ok " + json.dumps(byzantine))
    log("byzantine engine reference phase (attack_scales [R, n], small CNN, card vs CPU, "
        "dense and quant8): ok " + json.dumps(byzantine_engine_reference_phase()))
    attacked = attacked_cnn_path(card)
    log("CNN main path (sign-flip attack_scales on every fifth node): " + json.dumps(attacked))
    log("federation reference phase (2 Nodes, narrow f32 CNN through the kernels, card vs "
        f"CPU): ok, max |err| {federation_reference_phase():.3e}")
    federation, fed_handles = federation_path(card)
    try:
        for label, result in federation.items():
            log(f"federation path ({label}): " + json.dumps(result))
        if "--profile" in sys.argv[1:]:
            log("profile (one federation experiment, 4 nodes, LINE, 3 rounds): "
                + json.dumps(profile_call(fed_handles[0][0])))
    finally:
        for _, stop in fed_handles:
            stop()
    one_node = one_node_kernel_rows()
    log("conv kernel phase [N = 1, B = 25 and 32, the federations' shapes, wgmma]: ok "
        + json.dumps(one_node))
    byzantine_fed = byzantine_federation_path(card)
    for label, result in byzantine_fed["arms"].items():
        log(f"byzantine federation ({label}): " + json.dumps(result))
    log("byzantine federation (10 CNN Nodes through the harness; every check passed): "
        + json.dumps({k: v for k, v in byzantine_fed.items() if k != "arms"}))
    chaos_fed = chaos_federation_path(card)
    log("chaos federation (4 CNN Nodes, 20% drop and one crash; every check passed): "
        + json.dumps(chaos_fed))
    async_fed = async_federation_path(card)
    variants = engine_variants_path(card)
    simulation = simulation_plane_path(card, byzantine_fed, async_fed)
    if "--profile" in sys.argv[1:]:
        log("profile (one pooled train stage: 10 learners of the cell, 4 epochs × 8 batches "
            "of 25, one batched dispatch at N = 16): " + json.dumps(profile_call(pooled_round_fn())))
        log("profile (one pooled round: a 1-round seeded experiment of 10 CNN Nodes, the pool "
            "on, set-up included): " + json.dumps(profile_call(pooled_experiment)))
    rows += flash_kernel_phase()
    log("flash kernel phase: ok")
    transformer_reference_phase()
    log("transformer reference phase (flash vs blockwise, f32, small): ok")
    lm, lm_args = transformer_main_path(card)
    log("transformer main path: " + json.dumps(lm))
    resnet, rn_args = resnet_path(card)
    for algorithm, result in resnet.items():
        log(f"ResNet-18 config 3 ({algorithm}): " + json.dumps(result))
    observatory = observatory_path(card, cnn, cnn_args, lm, lm_args)
    spmd = spmd_planes(card)
    mesh = mesh_phase(card)
    log(f"mesh phase: {mesh['phase_s']:.1f} s")
    network = network_path(card)
    for label, result in network.items():
        if label not in ("launches", "phase_s"):
            log(f"network path ({label}): " + json.dumps(result))
    log(f"network path: {network['phase_s']:.1f} s")
    rendered = rendered_path(card, cnn)
    for label, result in rendered.items():
        if label not in ("launches", "phase_s"):
            log(f"rendered path ({label}): " + json.dumps(result))
    log(f"rendered path: {rendered['phase_s']:.1f} s")
    donation = donation_path(card)
    log(f"donation: {donation['phase_s']:.1f} s")
    pool_sharded = pool_sharded_path(card)
    log("pool sharded (phase 18a's pooled stage over 2 gloo ranks on the card; every check "
        "passed): " + json.dumps(pool_sharded))
    log(f"pool sharded: {pool_sharded['phase_s']:.1f} s")
    parquet = parquet_path(card)
    for label, result in parquet.items():
        if label not in ("launches", "phase_s"):
            log(f"parquet path ({label}): " + json.dumps(result))
    log(f"parquet path: {parquet['phase_s']:.1f} s")
    grpc = grpc_path(card, network)
    for label, result in grpc.items():
        if label not in ("launches", "phase_s"):
            log(f"grpc path ({label}): " + json.dumps(result))
    log(f"grpc path: {grpc['phase_s']:.1f} s")
    jpeg_phase = jpeg_path(card)
    for label, result in jpeg_phase.items():
        if label not in ("launches", "phase_s"):
            log(f"jpeg path ({label}): " + json.dumps(result))
    log(f"jpeg path: {jpeg_phase['phase_s']:.1f} s")
    if "--profile" in sys.argv[1:]:
        log("profile (one CNN round): " + json.dumps(profile_round(cnn_args)))
        log("profile (one transformer round): " + json.dumps(profile_round(lm_args)))
        log("profile (one ResNet-18 round, fedavg): " + json.dumps(profile_round(rn_args)))
        log("profile (one protocol-phase learner fit, CNN at N = 1): "
            + json.dumps(profile_call(protocol_learner.fit)))
        log("profile (one byzantine round, fedavg+quarantine, 10 learners): "
            + json.dumps(profile_call(byzantine_round_fn)))
    for row in rows:
        path = cnn if row["name"] in ("conv_dw", "conv_dx") else lm
        row["launches"] = path["launches"][row["name"]]
        row["wgmma_launches"] = path["wgmma_launches"][row["name"]]
        if row["name"] in ("conv_dw", "conv_dx"):
            row["protocol_round_launches"] = protocol["fedavg"]["launches"][row["name"]]
            row["byzantine_round_launches"] = byzantine["fedavg"]["launches_per_round"][
                row["name"]]
            row["federation_experiment_launches"] = {
                label: r["launches"][row["name"]] for label, r in federation.items()}
            row["byzantine_federation_launches"] = {
                label: r["launches"][row["name"]] for label, r in byzantine_fed["arms"].items()}
            row["chaos_federation_launches"] = {
                label: chaos_fed[label]["launches"][row["name"]]
                for label in ("fault_free", "chaos")}
            row["async_federation_launches"] = async_launches(async_fed, row["name"])
            row["engine_variant_launches"] = ev_launches(variants, row["name"])
            row["simulation_plane_launches"] = simulation_launches(simulation, row["name"])
            row["simulation_plane_layers"] = {
                shape: per[row["name"]] for shape, per in simulation["kernel_rows"].items()
                if shape != "phase_s"}
            row["one_node_layers"] = {b: per[row["name"]] for b, per in one_node.items()}
            row["network_launches"] = network["launches"][row["name"]]
            row["rendered_launches"] = rendered["launches"][row["name"]]
            row["pool_sharded_launches"] = {
                rank: n[row["name"]] for rank, n in pool_sharded["launches"].items()}
            row["parquet_launches"] = parquet["launches"][row["name"]]
            row["grpc_launches"] = grpc["launches"][row["name"]]
            row["jpeg_launches"] = jpeg_phase["launches"][row["name"]]
            row["parquet_layers"] = {shape: per[row["name"]]
                                     for shape, per in parquet["26b kernel rows"].items()}
        if row["name"] in FLASH_KERNELS:
            launched = {label.split()[0]: part["flash_launches"][row["name"]]
                        for label, part in spmd.items()}
            row["ring_launches"] = launched["20a"] + launched["20b"]
            row["attention_tier_launches"] = launched["20c"]
            row["transformer_tier_launches"] = launched["20d"]
            row["pipeline_moe_launches"] = launched["20e"]
        row["donation_launches"] = {label: donation[label]["launches"][row["name"]]
                                    for label in ("cnn fedavg", "cnn scaffold", "transformer")}
        row["mesh_window_launches"] = mesh["mesh_window_launches"][row["name"]]
        row["sharded_trainer_launches"] = mesh["sharded_trainer_launches"][row["name"]]
        row["observatory_launches"] = observatory[
            "mfu_cnn" if row["name"] in ("conv_dw", "conv_dx") else "mfu_lm"]["launches"][row["name"]]
        if row["name"] in built:
            row["build"] = built[row["name"]]
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
