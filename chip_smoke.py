"""Chip smoke test of the PyTorch / CUDA port (tpfl_torch) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   port's CUDA kernels from ``tpfl_torch/parallel/csrc`` (one ``nvcc``
   per source, started together).
2. Kernel phase: runs each kernel at the shapes of the 100-node CNN round
   (N=100 nodes, B=128, bf16; the Conv_0 and Conv_1 layers), holds it
   against its plain PyTorch version on the same inputs, and times the
   kernel, the plain version and PyTorch's own conv backward
   (``aten.convolution_backward``, a yardstick the port never calls).
3. Reference phase: a small f32 federation round with the kernels
   (``conv_impl="pallas"``) against plain autograd (``conv_impl="xla"``).
4. Main path: ``VmapFederation(CNN(out_channels=10, conv_impl="pallas"),
   n_nodes=100)`` runs FedAvg rounds on seeded synthetic CIFAR-shaped data
   (4 batches of 128 per node, 1 epoch); every kernel must have launched
   (8 conv_dw and 4 conv_dx launches per round), every loss must be
   finite and every node must hold the same aggregate.

``--profile`` adds one round under ``torch.profiler``: device time by
kernel, and the device's idle share of the round from the union of its
kernel intervals.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, when there is no card or any phase fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tpfl_torch.learning.dataset.synthetic import synthetic_cifar10
from tpfl_torch.models import CNN
from tpfl_torch.parallel import VmapFederation, _build
from tpfl_torch.parallel import conv_kernel as ck

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
}


def log(msg: str) -> None:
    print(msg, flush=True)


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


def kernel_phase() -> list[dict]:
    """Both kernels at the main-path shapes against their plain versions."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    per = {"conv_dw": [], "conv_dx": []}
    for name, h, w, cin, cout, dx_needed in LAYERS:
        x = torch.randn(N_NODES, BATCH, h, w, cin, device="cuda", generator=gen).to(bf16)
        g = torch.randn(N_NODES, BATCH, h, w, cout, device="cuda", generator=gen).to(bf16)
        wk = (0.1 * torch.randn(N_NODES, 3, 3, cin, cout, device="cuda",
                                generator=gen)).to(bf16)
        m = N_NODES * BATCH * h * w
        # conv_dw: f32 sums of the same bf16 products in another order.
        dw = ck.conv_dw(x, g, 3)
        err = check_close(f"conv_dw[{name}]", dw, ck.conv_dw_plain(x, g, 3), 1e-4, 1e-4)
        nbytes = (x.numel() + g.numel()) * 2 + dw.numel() * 4
        per["conv_dw"].append({
            **bound(nbytes, 2.0 * m * 9 * cin * cout),
            "layer": name, "max_abs_err": err,
            "ms": time_ms(lambda: ck.conv_dw(x, g, 3)),
            "plain_ms": time_ms(lambda: ck.conv_dw_plain(x, g, 3), 3),
            "library_ms": time_ms(library_backward(x, g, wk, [False, True, False])),
        })
        if not dx_needed:
            continue
        # conv_dx: bf16 outputs of f32 sums; one bf16 rounding (2^-8
        # relative) apart at most, plus the f32 order near zero.
        dx = ck.conv_dx(g, wk)
        err = check_close(f"conv_dx[{name}]", dx, ck.conv_dx_plain(g, wk), 2.0 ** -7, 1e-3)
        nbytes = (g.numel() + wk.numel() + dx.numel()) * 2
        per["conv_dx"].append({
            **bound(nbytes, 2.0 * m * 9 * cout * cin),
            "layer": name, "max_abs_err": err,
            "ms": time_ms(lambda: ck.conv_dx(g, wk)),
            "plain_ms": time_ms(lambda: ck.conv_dx_plain(g, wk), 3),
            "library_ms": time_ms(library_backward(x, g, wk, [True, False, False])),
        })
        del x, g, wk, dw, dx
        torch.cuda.empty_cache()
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


def reference_phase() -> None:
    """A small f32 round with the kernels against plain autograd, on
    the card. Tolerance: f32 sums in other orders over 2 SGD steps."""
    rng = np.random.default_rng(1)
    xs = rng.uniform(size=(4, 2, 16, 32, 32, 3)).astype(np.float32)
    ys = rng.integers(0, 10, size=(4, 2, 16)).astype(np.int32)
    out = {}
    for impl in ("pallas", "xla"):
        fed = VmapFederation(CNN(out_channels=10, compute_dtype=torch.float32,
                                 conv_impl=impl), n_nodes=4, seed=0)
        out[impl] = fed.round(fed.init_params((32, 32, 3)), xs, ys,
                              weights=[1.0, 0.0, 2.0, 1.0])
    for layer, leaves in out["pallas"][0].items():
        for leaf, v in leaves.items():
            torch.testing.assert_close(v, out["xla"][0][layer][leaf], rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(out["pallas"][1], out["xla"][1], rtol=1e-3, atol=1e-4)


def main_path(card: str) -> dict:
    fed = VmapFederation(CNN(out_channels=10, conv_impl="pallas"),
                         n_nodes=N_NODES, learning_rate=0.1, seed=0)
    per_node = N_BATCHES * BATCH
    x, y, _, _ = synthetic_cifar10(n_train=N_NODES * per_node, n_test=10, seed=0)
    xs = torch.from_numpy(x.reshape(N_NODES, N_BATCHES, BATCH, 32, 32, 3)).to(
        "cuda", torch.bfloat16)
    xs, ys = fed.shard_data(xs, y.reshape(N_NODES, N_BATCHES, BATCH))
    params = fed.init_params((32, 32, 3))
    params, _ = fed.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=1)  # warm-up
    torch.cuda.synchronize()

    ck.conv_dw.launches = ck.conv_dx.launches = 0
    t0 = time.perf_counter()
    params, losses = fed.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=N_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"conv_dw": ck.conv_dw.launches, "conv_dx": ck.conv_dx.launches}

    steps = N_BATCHES * EPOCHS * N_ROUNDS
    want = {"conv_dw": 2 * steps, "conv_dx": steps}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite losses {losses}")
    for layer, leaves in params.items():
        for leaf, v in leaves.items():
            if not torch.isfinite(v).all() or not torch.equal(v, v[:1].expand_as(v)):
                raise AssertionError(f"{layer}/{leaf}: aggregate not finite or "
                                     "not identical on every node")
    rounds_s = N_ROUNDS / wall
    return ({
        "card": card, "n_nodes": N_NODES, "batches": N_BATCHES, "batch": BATCH,
        "rounds": N_ROUNDS, "wall_s": wall, "rounds_per_s": rounds_s,
        "samples_per_s": rounds_s * N_NODES * per_node, "launches": launches,
        "mean_loss": losses.mean().item(),
    }, (fed, params, xs, ys))


def _union_ms(spans: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals, in ms (from µs)."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def profile_round(fed_args: tuple) -> dict:
    """One more round under ``torch.profiler``: device time by kernel,
    and the share of the round's wall time in which the card ran no
    kernel. Device intervals are read from the trace's device events.
    Kernels that run at once (on different streams) overlap, so their
    summed time exceeds the time the card was busy: the busy time is
    the union of the intervals, and the overlap is reported beside it,
    with the device time of each stream. User-annotation ranges
    projected onto the device timeline are kept apart.
    ``busy_over_wall`` is reported as measured, not clamped."""
    from torch.profiler import ProfilerActivity, profile

    fed, params, xs, ys = fed_args
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fed.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=1)
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
        "top": [{"ms": ms, "calls": n, "kernel": k[:90]} for ms, n, k in rows[:12]],
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
    for src in _build.all_sources():
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas[{src}]: {line.strip()}")

    rows = kernel_phase()
    log("kernel phase: ok")
    reference_phase()
    log("reference phase (pallas vs xla, f32, small): ok")
    main, fed_args = main_path(card)
    log("main path: " + json.dumps(main))
    if "--profile" in sys.argv[1:]:
        log("profile (one round): " + json.dumps(profile_round(fed_args)))
    for row in rows:
        row["launches"] = main["launches"][row["name"]]
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
