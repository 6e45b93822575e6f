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
   causal, bf16) and at the long-context one (B·H = 1·8, S = 32768), each
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
   (bf16, the kernels at N = 1) on a STAR, seed 4242, 6 rounds of 4
   epochs over 200 samples each in batches of 25 (lr 0.1), sign flips on
   nodes 1 and 4 and additive noise (std 0.1) on nodes 6 and 8. Arms:
   FedAvg fault-free, the six honest nodes alone, FedAvg attacked, FedAvg
   + quarantine (twice, the second traced: ``TELEMETRY_ENABLED``, a dump
   directory, a 200,000-entry ring), Krum (f = 3) fault-free and
   attacked, MultiKrum (f = 3, m = 6) and TrimmedMean (trim 2) with
   quarantine. Each: complete stage histories, exactly 6 × n × 4 × 8
   steps' launches (3,840 ``conv_dw`` + 1,920 ``conv_dx`` at n = 10),
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
   async arm, then 5 synchronous rounds (exactly 400 steps' launches),
   then 10 free-running async rounds with ``ASYNC_BUFFER_K`` 5; each arm's
   rounds/s and steady loss, the speedup and loss ratio (reported, not
   gated). (b) Its determinism arm (``:3182-3219``): two serialized runs
   of 4 rounds, K 8, the adaptive controller on, the plan's schedule
   forked into every aggregator: the final digests equal across runs, one
   across the ten nodes, the controller trajectories equal and non-empty
   at every node (each run exactly 320 steps' launches). (c) The
   ``byzantine`` tier's async arm (``:2939-3033``): seed 4243, 8 rounds
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

``--profile`` adds one round of each main path (the CNN, the
transformer, ResNet-18 under FedAvg), one protocol-phase learner fit,
one defended FedAvg round of the Byzantine phase and one 3-round
experiment of the 4-node federation under ``torch.profiler``: device
time by kernel, and the device's idle share from the union of its
kernel intervals.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, when there is no card or any phase fails.
"""

from __future__ import annotations

import contextlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from pathlib import Path

import numpy as np
import torch

from tpfl_torch.attacks import (AttackPlan, AttackSpec, adversary_map, apply_attack_plan,
                                final_model_digests, harness, metric_table,
                                run_seeded_experiment)
from tpfl_torch.communication import FaultInjector, FaultPlan, TrainerSpeedPlan
from tpfl_torch.learning import compression
from tpfl_torch.learning.aggregators import (FedAvg, FedProx, Krum, MultiKrum, Scaffold,
                                             TrimmedMean)
from tpfl_torch.learning.dataset import RandomIIDPartitionStrategy, TpflDataset
from tpfl_torch.learning.dataset.synthetic import synthetic_cifar10, synthetic_classification
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.learning.torch_learner import TorchLearner
from tpfl_torch.management import ledger, profiling, quarantine, telemetry, tracing
from tpfl_torch.management.logger import logger
from tpfl_torch.models import CNN, ResNet18, TransformerLM, init_params
from tpfl_torch.node import Node
from tpfl_torch.parallel import FederationEngine, VmapFederation, _build
from tpfl_torch.parallel import conv_kernel as ck
from tpfl_torch.parallel import flash_kernel as fk
from tpfl_torch.parallel.ring_attention import blockwise_attention
from tpfl_torch.settings import Settings
from tpfl_torch.utils import TopologyFactory, TopologyType, wait_convergence, wait_to_finish
from tpfl_torch.utils.tree import tree_items, tree_map

# H100 SXM published peaks (dense): HBM3 bytes/s and bf16 tensor-core FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_BF16_FLOPS = 989e12

N_NODES, N_BATCHES, BATCH, EPOCHS, N_ROUNDS = 100, 4, 128, 1, 3
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
# attention (nodes fold into the batch: 8 nodes x 8 sequences) and the
# transformer tier's long context (bench.py:3651-3655).
FLASH_SHAPES = [("main", T_NODES * T_BATCH, T_SEQ, 8, 64), ("long", 1, 32768, 8, 64)]


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


def timed_window(fed, params: dict, state: dict, xs, ys) -> tuple:
    """One warm-up round, then a timed N_ROUNDS window with every launch
    count set to 0 just before it. Returns (window wall seconds, params,
    state, losses, launches, wgmma launches, (fed, params, xs, ys, state)
    for a profiled round)."""
    params, state, _ = carry(fed.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=1,
                                            **state))  # warm-up
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    out = fed.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=N_ROUNDS, **state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, wgmma = read_launches(), read_wgmma_launches(WRAPPERS)
    params, state, losses = carry(out)
    return wall, params, state, losses, launches, wgmma, (fed, params, xs, ys, state)


def cnn_data(fed) -> tuple[torch.Tensor, torch.Tensor]:
    """The CNN round's seeded synthetic CIFAR-shaped batches, node-stacked
    on the card ([N_NODES, N_BATCHES, BATCH, ...], bf16 images)."""
    x, y, _, _ = synthetic_cifar10(n_train=N_NODES * N_BATCHES * BATCH, n_test=10, seed=0)
    xs = torch.from_numpy(x.reshape(N_NODES, N_BATCHES, BATCH, 32, 32, 3)).to(
        "cuda", torch.bfloat16)
    return fed.shard_data(xs, y.reshape(N_NODES, N_BATCHES, BATCH))


def cnn_rounds(conv_impl: str, algorithm: str = "fedavg", lr: float = 0.1) -> tuple:
    """The 100-node CNN round with ``conv_impl``, ``algorithm`` and
    learning rate ``lr`` (the wire codec as ``Settings.ENGINE_WIRE_CODEC``
    says): a
    :func:`timed_window`. Returns (window wall seconds, params, losses,
    launches, wgmma launches of the conv kernels, profile arguments)."""
    fed = VmapFederation(CNN(out_channels=10, conv_impl=conv_impl), n_nodes=N_NODES,
                         learning_rate=lr, seed=0, algorithm=algorithm)
    xs, ys = cnn_data(fed)
    params = fed.init_params((32, 32, 3))
    state = ({"scaffold_state": fed.init_scaffold_state(params)}
             if algorithm == "scaffold" else {})
    wall, params, state, losses, launches, wgmma, fed_args = timed_window(
        fed, params, state, xs, ys)
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
    and 4 conv_dx launches a round, every one on its wgmma kernel."""
    wall, params, losses, launches, wgmma, fed_args = cnn_rounds("pallas")
    steps = N_BATCHES * EPOCHS * N_ROUNDS
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
    fed = VmapFederation(TransformerLM(**LM_KW, attention_fn=fk.flash_attention),
                         n_nodes=T_NODES, learning_rate=T_LR, seed=0)
    xs, ys = lm_tokens(T_NODES, T_BATCHES, T_BATCH, T_SEQ, LM_KW["vocab"], seed=5)
    xs, ys = fed.shard_data(xs, ys)
    params = fed.init_params((T_SEQ,))
    params, _ = fed.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=1)  # warm-up
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    params, losses = fed.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=N_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    wgmma = read_wgmma_launches(FLASH_KERNELS)

    per_window = LM_KW["n_layers"] * T_BATCHES * EPOCHS * N_ROUNDS
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
    plain, _ = eng.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=N_ROUNDS)
    ones, _ = eng.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=N_ROUNDS,
                             attack_scales=np.ones_like(scales))
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
    ERROR, and ``knobs``; every setting restored after."""
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
    split = {c: statistics.mean(r["parts"][c] for r in recs) for c in profiling.COMPONENTS}
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
BF_SEED, BF_ROUNDS, BF_EPOCHS, BF_SAMPLES, BF_BATCH, BF_TEST = 4242, 6, 4, 200, 25, 1200
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
# (label, attack, defend, aggregator factory, nodes, traced)
BF_ARMS = [
    ("fedavg, fault-free", False, False, None, 10, False),
    ("fedavg, adversary-free (6 honest nodes)", False, False, None, 6, False),
    ("fedavg, attacked", True, False, None, 10, False),
    ("fedavg+quarantine", True, True, None, 10, False),
    ("fedavg+quarantine, traced", True, True, None, 10, True),
    ("krum, fault-free", False, False,
     lambda: Krum(n_byzantine=3, device=PHASE_DEVICE), 10, False),
    ("krum, attacked", True, False, lambda: Krum(n_byzantine=3, device=PHASE_DEVICE), 10, False),
    ("multikrum+quarantine", True, True,
     lambda: MultiKrum(n_byzantine=3, m=6, device=PHASE_DEVICE), 10, False),
    ("trimmedmean+quarantine", True, True,
     lambda: TrimmedMean(trim=2, device=PHASE_DEVICE), 10, False),
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
           dump_dir: "str | None") -> dict:
    """One arm: a seeded experiment of ``n`` Nodes through the harness.
    Checks that the harness built ``n`` HarnessNodes, complete stage
    histories, exactly 6 × n × 4 × 8 steps' conv launches, all on wgmma,
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
            BF_SEED, n, BF_ROUNDS, epochs=BF_EPOCHS, attack_plan=bf_plan() if attack else None,
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
    check_history(tag, nodes, BF_ROUNDS)
    check_conv_launches(tag, launches, wgmma,
                        BF_ROUNDS * n * BF_EPOCHS * (BF_SAMPLES // BF_BATCH))
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
    out = {"card": card, "nodes": n, "rounds": BF_ROUNDS, "experiment_wall_s": wall,
           "rounds_per_s": BF_ROUNDS / wall, "harness_call_wall_s": call_wall,
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
        for label, attack, defend, agg, n, traced in BF_ARMS:
            out[label] = bf_arm(card, label, attack, defend, agg, n,
                                tmp if traced else None)
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
AS_WARM, AS_SYNC_ROUNDS, AS_ASYNC_ROUNDS, AS_DET_ROUNDS, AS_DET_K = 2, 5, 10, 4, 8
BA_SEED, BA_ROUNDS, BA_EPOCHS, BA_SAMPLES, BA_BATCH, BA_TEST = 4243, 8, 4, 200, 25, 1200
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
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
    rows += flash_kernel_phase()
    log("flash kernel phase: ok")
    transformer_reference_phase()
    log("transformer reference phase (flash vs blockwise, f32, small): ok")
    lm, lm_args = transformer_main_path(card)
    log("transformer main path: " + json.dumps(lm))
    resnet, rn_args = resnet_path(card)
    for algorithm, result in resnet.items():
        log(f"ResNet-18 config 3 ({algorithm}): " + json.dumps(result))
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
            row["one_node_layers"] = {b: per[row["name"]] for b, per in one_node.items()}
        if row["name"] in built:
            row["build"] = built[row["name"]]
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
