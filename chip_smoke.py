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
   D = 128, S = 127 and 129 causal D = 64, and D = 20, whose rows TMA
   cannot address, on the WMMA kernels), and one f32 non-causal case with
   an unaligned S (100) that exercises the key mask. Times the kernels,
   their plain versions and PyTorch's flash-backend
   ``scaled_dot_product_attention`` (a yardstick the port never calls).
   The build step prints ptxas's registers and spills for every kernel
   (and any ptxas warning about wgmma) and, from ``cuobjdump -sass``, the
   count of ``HGMMA`` (wgmma), ``UTMALDG`` (TMA load) and ``LDGSTS``
   (``cp.async``) instructions in each kernel; the main path's
   ``flash_fwd``, ``flash_dkv`` and both ``conv_dw`` instantiations must
   have HGMMA and UTMALDG, its ``conv_dx`` HGMMA and UTMALDG or LDGSTS.
   Limit cases, bf16 and f32, forward and both gradients: B·H = 65,537
   and head dims 136, 200, 256 and 320.
6. Transformer reference phase: a small f32 federated ``TransformerLM``
   round with ``attention_fn=flash_attention`` against the same round
   with ``blockwise_attention``.
7. Transformer main path: ``VmapFederation(TransformerLM(vocab=256,
   dim=512, heads=8, n_layers=4, max_len=4096,
   attention_fn=flash_attention), n_nodes=8, learning_rate=0.05)`` runs
   FedAvg rounds on seeded tokens (1 batch of 8 sequences of 2,048 per
   node, 1 epoch); 4 launches of each flash kernel per round, finite
   losses and one aggregate on every node.

``--profile`` adds one round of each main path under
``torch.profiler``: device time by kernel, and the device's idle share
of the round from the union of its kernel intervals.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, when there is no card or any phase fails.
"""

from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tpfl_torch.learning.dataset.synthetic import synthetic_cifar10
from tpfl_torch.models import CNN, TransformerLM
from tpfl_torch.parallel import VmapFederation, _build
from tpfl_torch.parallel import conv_kernel as ck
from tpfl_torch.parallel import flash_kernel as fk
from tpfl_torch.parallel.ring_attention import blockwise_attention
from tpfl_torch.utils.tree import tree_items

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


def kernel_phase() -> list[dict]:
    """Both conv kernels at the main-path shapes against their plain
    versions."""
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
        # conv_dw: f32 sums of the same bf16 products in another order;
        # the same bits run to run (no float atomics).
        wgmma = ck.conv_dw.wgmma_launches
        dw = ck.conv_dw(x, g, 3)
        if ck.conv_dw.wgmma_launches != wgmma + 1:
            raise AssertionError(f"conv_dw[{name}]: the main shape did not take the wgmma kernel")
        if not torch.equal(ck.conv_dw(x, g, 3), dw):
            raise AssertionError(f"conv_dw[{name}]: two runs differ")
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
        wgmma = ck.conv_dx.wgmma_launches
        dx = ck.conv_dx(g, wk)
        if ck.conv_dx.wgmma_launches != wgmma + 1:
            raise AssertionError(f"conv_dx[{name}]: the main shape did not take the wgmma kernel")
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


def conv_dw_edge_cases() -> float:
    """Each bf16 edge case of the wgmma conv_dw (``ck.WGMMA_DW_EDGES``, the
    card tests' shapes) against the plain version at the main shapes'
    tolerance, and against itself run again (the same bits); fails unless
    each took the wgmma kernel. Returns the worst max |err| relative to the
    case's largest value."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    worst = 0.0
    for cin, cout, (h, w), b, n in ck.WGMMA_DW_EDGES:
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
        err = check_close(label, dw, ref, 1e-4, 1e-4)
        worst = max(worst, err / ref.abs().max().item())
    return worst


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
    card tests' shapes) against the plain version at the main shape's
    tolerance; fails unless each took the wgmma kernel. Returns the worst
    max |err| relative to the case's largest value."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    worst = 0.0
    for cin, cout, (h, w), b, n in ck.WGMMA_DX_EDGES:
        g = torch.randn(n, b, h, w, cout, device="cuda", generator=gen).to(torch.bfloat16)
        wk = torch.randn(n, 3, 3, cin, cout, device="cuda", generator=gen).to(torch.bfloat16)
        wgmma = ck.conv_dx.wgmma_launches
        dx = ck.conv_dx(g, wk)
        label = f"conv_dx[Cin={cin} Cout={cout} {h}x{w} B={b} N={n}]"
        if ck.conv_dx.wgmma_launches != wgmma + 1:
            raise AssertionError(f"{label}: did not take the wgmma kernel")
        ref = ck.conv_dx_plain(g, wk)
        err = check_close(label, dx, ref, 2.0 ** -7, 1e-3)
        worst = max(worst, err / ref.float().abs().max().item())
    return worst


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
        fn.launches = 0
    ck.conv_dw.wgmma_launches = ck.conv_dx.wgmma_launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def cnn_rounds(conv_impl: str) -> tuple:
    """The 100-node CNN FedAvg round with ``conv_impl``: one warm-up round,
    then a timed 3-round window with every launch count set to 0 just
    before it. Returns (window wall seconds, params, losses, launches,
    wgmma launches, (fed, params, xs, ys) for a profiled round)."""
    fed = VmapFederation(CNN(out_channels=10, conv_impl=conv_impl),
                         n_nodes=N_NODES, learning_rate=0.1, seed=0)
    per_node = N_BATCHES * BATCH
    x, y, _, _ = synthetic_cifar10(n_train=N_NODES * per_node, n_test=10, seed=0)
    xs = torch.from_numpy(x.reshape(N_NODES, N_BATCHES, BATCH, 32, 32, 3)).to(
        "cuda", torch.bfloat16)
    xs, ys = fed.shard_data(xs, y.reshape(N_NODES, N_BATCHES, BATCH))
    params = fed.init_params((32, 32, 3))
    params, _ = fed.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=1)  # warm-up
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    params, losses = fed.run_rounds(params, xs, ys, epochs=EPOCHS, n_rounds=N_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wgmma = {"conv_dw": ck.conv_dw.wgmma_launches, "conv_dx": ck.conv_dx.wgmma_launches}
    return wall, params, losses, read_launches(), wgmma, (fed, params, xs, ys)


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
    for name, took in wgmma.items():
        if took != launches[name]:
            raise AssertionError(f"{took} of {launches[name]} {name} launches of the CNN round "
                                 "took the wgmma kernel; expected all")
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


def check_flash(label: str, q, k, v, do, causal: bool) -> tuple[dict, dict, tuple]:
    """All three flash kernels on bf16 operands against their plain
    versions, with bf16 outputs and with f32 outputs (tolerances as
    ``flash_shape_phase`` states them): ({kernel: max |err|}, {kernel:
    relative rms err of the f32 outputs}, the backward's arguments)."""
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
               ("S=129 causal D=20 (WMMA)", 3, 129, 20, True)]


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
    masked in the kernel): f32 sums in another order, 1e-5 relative."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, do = (torch.randn(2, 100, 32, device="cuda", generator=gen) for _ in range(4))
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
    1e-5 relative. Returns {label: max |err|}."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for label, bh, s, d in FLASH_LIMITS:
        for dtype in (torch.bfloat16, torch.float32):
            tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
            name = f"{label} {str(dtype)[6:]}"
            q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=gen).to(dtype)
                           for _ in range(4))
            o, lse = fk.flash_fwd(q, k, v, True)
            o_ref, lse_ref = fk.flash_fwd_plain(q, k, v, True)
            err = check_close(f"flash_fwd[{name}] o", o, o_ref, tol, tol)
            check_close(f"flash_fwd[{name}] lse", lse, lse_ref, 1e-5, 1e-6)
            delta = (do.float() * o_ref.float()).sum(-1)
            args = (q, k, v, do, lse_ref, delta, True)
            err = max(err, check_close(f"flash_dq[{name}]", fk.flash_dq(*args),
                                       fk.flash_dq_plain(*args), tol, tol))
            for g, got, ref in zip(("dk", "dv"), fk.flash_dkv(*args), fk.flash_dkv_plain(*args)):
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

    per_window = LM_KW["n_layers"] * T_BATCHES * EPOCHS * N_ROUNDS
    check_main_path(params, losses, launches, {
        **dict.fromkeys(WRAPPERS, 0), **dict.fromkeys(FLASH_KERNELS, per_window)})
    tokens = T_NODES * T_BATCHES * T_BATCH * T_SEQ
    rounds_s = N_ROUNDS / wall
    return ({
        "card": card, "model": {**LM_KW, "attention_fn": "flash_attention"},
        "n_nodes": T_NODES, "batches": T_BATCHES, "batch": T_BATCH, "seq": T_SEQ,
        "rounds": N_ROUNDS, "wall_s": wall, "rounds_per_s": rounds_s,
        "tokens_per_round": tokens, "tokens_per_s": rounds_s * tokens,
        "launches": launches, "mean_loss": losses.mean().item(),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
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
    rows += flash_kernel_phase()
    log("flash kernel phase: ok")
    transformer_reference_phase()
    log("transformer reference phase (flash vs blockwise, f32, small): ok")
    lm, lm_args = transformer_main_path(card)
    log("transformer main path: " + json.dumps(lm))
    if "--profile" in sys.argv[1:]:
        log("profile (one CNN round): " + json.dumps(profile_round(cnn_args)))
        log("profile (one transformer round): " + json.dumps(profile_round(lm_args)))
    for row in rows:
        path = cnn if row["name"] in ("conv_dw", "conv_dx") else lm
        row["launches"] = path["launches"][row["name"]]
        if row["name"] in built:
            row["build"] = built[row["name"]]
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
