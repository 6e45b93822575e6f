"""A ``gloo`` world of spawned ranks for the port's SPMD tests on the CPU.

:func:`run_world` spawns ``world`` processes (``torch.multiprocessing``,
``spawn`` start method), each of which joins the world through
``tpfl_torch.parallel.distributed.ensure_distributed(device="cpu")``,
computes the results of one function of this module (or of a sibling
worker module such as ``torch_mesh_worker.py``) and saves them; the
parent reads every rank's results back. A child imports this module, so
it imports torch, numpy and ``tpfl_torch`` only: the tests import JAX
inside their functions.

The inputs are made from numpy seeds by the functions below, which the
tests call again to feed the JAX package the same numbers.
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tpfl_torch.parallel import distributed as spmd

WORLD = 4
#: Each collective fails after this, so a hung rank fails the test.
TIMEOUT = datetime.timedelta(seconds=60)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, module: str, fn_name: str, out_dir: str,
           workdir: "str | None") -> None:
    import importlib

    torch.set_num_threads(1)
    spmd.ensure_distributed(f"127.0.0.1:{port}", world, rank, device="cpu", timeout=TIMEOUT)
    try:
        fn = getattr(importlib.import_module(module), fn_name)
        result = fn() if workdir is None else fn(workdir)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable[..., dict], world: int = WORLD,
              workdir: "str | None" = None) -> list[dict]:
    """``fn()`` (a module-level function of this module or of a sibling
    worker module that imports no JAX) on every rank of a fresh ``gloo``
    world of ``world`` processes: the ranks' results in rank order.
    ``workdir`` (a directory that outlives the world) is passed to
    ``fn`` when given. Every child has exited when it returns."""
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_entry, args=(world, _free_port(), fn.__module__, fn.__name__, out_dir,
                               workdir), nprocs=world, join=True)
        return [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


# ---- ring attention -------------------------------------------------------------

RING_SHAPE = (2, 64, 4, 16)  # B, S, H, D: the JAX suite's (tests/test_parallel.py:505)
LM = dict(vocab=32, dim=32, heads=2, n_layers=1, max_len=64)


def ring_qkv(seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.normal(size=RING_SHAPE).astype(np.float32) for _ in range(3)]


def lm_tokens() -> np.ndarray:
    return np.random.default_rng(1).integers(0, 31, (2, 64)).astype(np.int32)


def lm_params() -> dict:
    """The seam's TransformerLM params (one model, numpy, the flax tree)."""
    from tpfl_torch.interop import params_to_numpy
    from tpfl_torch.models import TransformerLM, init_params

    module = TransformerLM(**LM, compute_dtype=torch.float32)
    return params_to_numpy(init_params(module, (64,), seed=0, device="cpu"))


def lm_train(attention_fn, steps: int = 3, lr: float = 0.1) -> dict:
    """``steps`` SGD steps (``optax.sgd(lr)``) of the seam's f32
    TransformerLM on next-token cross entropy, the JAX suite's
    ``test_transformer_lm_trains_with_ring_attention``: the losses, the
    first logits and the final params (numpy)."""
    from tpfl_torch.interop import params_from_flax, params_to_numpy
    from tpfl_torch.learning.torch_learner import SGDMomentum
    from tpfl_torch.models import TransformerLM
    from tpfl_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

    module = TransformerLM(**LM, compute_dtype=torch.float32, attention_fn=attention_fn)
    params = params_from_flax(lm_params(), device="cpu", n_nodes=1)
    tokens = torch.from_numpy(lm_tokens())[None]
    opt = SGDMomentum(lr, momentum=0.0)
    trace = opt.init(params)
    losses, logits0 = [], None
    for _ in range(steps):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        logits = module(live, tokens)
        if logits0 is None:
            logits0 = _np(logits[0])
        loss = torch.nn.functional.cross_entropy(
            logits[0, :, :-1].reshape(-1, LM["vocab"]), tokens[0, :, 1:].reshape(-1).long())
        grads = torch.autograd.grad(loss, tree_leaves(live))
        params, trace = opt.step(params, tree_unflatten(params, grads), trace)
        losses.append(float(loss.detach()))
    return {"losses": losses, "logits": logits0,
            "params": tree_map(lambda a: a[0], params_to_numpy(params))}


def ring_results() -> dict:
    """Every ring case of ``tests/test_torch_ring_attention.py`` on this
    rank: forwards and the gradients of ``sum(out²)`` per (causal, impl)
    in f32, the bf16 flash forward, and the ring-trained TransformerLM."""
    from tpfl_torch.parallel.mesh import create_mesh
    from tpfl_torch.parallel.ring_attention import make_ring_attention

    mesh = create_mesh({"sp": dist.get_world_size()}, device="cpu")
    out = {"rank": dist.get_rank()}
    q, k, v = (torch.from_numpy(a) for a in ring_qkv())
    for causal in (False, True):
        for impl in ("flash", "xla"):
            ring = make_ring_attention(mesh, causal=causal, impl=impl)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o = ring(*leaves)
            (o.pow(2).sum()).backward()
            out[f"fwd_{causal}_{impl}"] = _np(o)
            out[f"grads_{causal}_{impl}"] = [_np(t.grad) for t in leaves]
        ring = make_ring_attention(mesh, causal=causal, impl="flash")
        out[f"bf16_{causal}"] = _np(ring(*(t.to(torch.bfloat16) for t in (q, k, v))))
    # A composed dp x sp mesh: each dp row's ring runs over a subgroup of
    # the world (group ranks are not global ranks on the second row) on
    # its own batch element.
    mesh2 = create_mesh({"dp": 2, "sp": dist.get_world_size() // 2}, device="cpu")
    dp = mesh2.get_local_rank("dp")
    out["dp_sp"] = {"dp": dp}
    for impl in ("flash", "xla"):
        leaves = [t[dp:dp + 1].clone().requires_grad_(True) for t in (q, k, v)]
        o = make_ring_attention(mesh2, axis_name="sp", causal=True, impl=impl)(*leaves)
        o.pow(2).sum().backward()
        out["dp_sp"][impl] = [_np(o)] + [_np(t.grad) for t in leaves]
    out["lm"] = lm_train(make_ring_attention(mesh, causal=True, impl="flash"))
    try:
        ring(q[:, :62], k[:, :62], v[:, :62])
    except ValueError as e:
        out["indivisible_error"] = str(e)
    return out


# ---- pipeline and experts ----------------------------------------------------------

PIPE_L, PIPE_D, PIPE_MICRO, PIPE_MB = 8, 16, 6, 4


def pipe_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The JAX suite's block, ``x + tanh(x @ w1) @ w2``, promoting as JAX
    does (bf16 activations through f32 params compute in f32)."""
    x = x.to(torch.promote_types(x.dtype, p["w1"].dtype))
    return x + torch.tanh(x @ p["w1"]) @ p["w2"]


def pipe_inputs(seed: int) -> tuple[dict, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    params = {"w1": rng.normal(0, 0.3, (PIPE_L, PIPE_D, PIPE_D)).astype(np.float32),
              "w2": rng.normal(0, 0.3, (PIPE_L, PIPE_D, PIPE_D)).astype(np.float32)}
    micro = rng.normal(size=(PIPE_MICRO, PIPE_MB, PIPE_D)).astype(np.float32)
    targets = rng.normal(size=(PIPE_MICRO, PIPE_MB, PIPE_D)).astype(np.float32)
    return params, micro, targets


MOE_T, MOE_DIM = 16, 8  # tokens a rank, width


def moe_route_inputs() -> tuple[np.ndarray, np.ndarray]:
    """Tokens whose feature 0 names their expert, and the wanted ids
    (``tests/test_parallel.py:953-988`` at the world's size)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(WORLD * MOE_T, MOE_DIM)).astype(np.float32)
    want = rng.integers(0, WORLD, WORLD * MOE_T)
    x[:, 0] = want
    return x, want


def moe_train_inputs() -> tuple[dict, np.ndarray, np.ndarray]:
    """The JAX suite's clustered task (``tests/test_parallel.py:991-1054``)
    at 4 experts: params, tokens, targets."""
    n, dim, t_per = WORLD, MOE_DIM, 32
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 4.0, (n, dim)).astype(np.float32)
    maps = rng.normal(0, 1.0, (n, dim, dim)).astype(np.float32)
    cluster = rng.integers(0, n, n * t_per)
    x = (centers[cluster] + rng.normal(0, 0.3, (n * t_per, dim))).astype(np.float32)
    y = np.einsum("td,tdk->tk", x, maps[cluster]).astype(np.float32)
    params = {"router": rng.normal(0, 0.1, (dim, n)).astype(np.float32),
              "experts": {"w": rng.normal(0, 0.3, (n, dim, dim)).astype(np.float32)}}
    return params, x, y


def moe_train_step(layer, params: dict, x: np.ndarray, y: np.ndarray) -> dict:
    """Loss ``mean((out - y)²) + 0.01·aux``, its value, the layer's
    outputs and the gradients (numpy)."""
    from tpfl_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

    live = tree_map(lambda a: torch.from_numpy(a).requires_grad_(True), params)
    out, aux = layer(live, torch.from_numpy(x))
    loss = torch.mean((out - torch.from_numpy(y)) ** 2) + 0.01 * aux
    grads = tree_unflatten(params, torch.autograd.grad(loss, tree_leaves(live)))
    return {"out": _np(out), "aux": float(aux.detach()), "loss": float(loss.detach()),
            "grads": tree_map(_np, grads)}


def planes_results() -> dict:
    """Every world case of ``tests/test_torch_spmd_planes.py`` on this
    rank: the pipeline's forward (f32 and bf16), its refusal of 6 layers
    over 4 stages and 5 training steps; the MoE layer's routing at two
    capacities, its refusal of mismatched experts and its passthrough of
    invalid routes; the top-k layer's outputs and gradients."""
    from tpfl_torch.parallel.mesh import create_mesh
    from tpfl_torch.parallel.moe import make_moe_layer, make_moe_train_layer
    from tpfl_torch.parallel.pipeline import make_pipeline, make_pipeline_trainer
    from tpfl_torch.utils.tree import tree_map

    n = dist.get_world_size()
    out = {"rank": dist.get_rank()}
    pp = create_mesh({"pp": n}, device="cpu")
    params, micro, _ = pipe_inputs(0)
    tparams = tree_map(torch.from_numpy, params)
    pipe = make_pipeline(pp, pipe_block, n_layers=PIPE_L)
    out["pipe_fwd"] = _np(pipe(tparams, torch.from_numpy(micro)))
    bf16 = pipe(tparams, torch.from_numpy(micro).to(torch.bfloat16))
    out["pipe_bf16_dtype"] = str(bf16.dtype)
    try:
        make_pipeline(pp, pipe_block, n_layers=6)
    except ValueError as e:
        out["pipe_split_error"] = str(e)

    params, micro, targets = pipe_inputs(1)
    init, step = make_pipeline_trainer(pp, pipe_block, n_layers=PIPE_L,
                                       loss_fn=lambda o, t: torch.mean((o - t) ** 2),
                                       learning_rate=0.05)
    p, opt = init(tree_map(torch.from_numpy, params))
    losses = []
    for _ in range(5):
        p, opt, loss = step(p, opt, torch.from_numpy(micro), torch.from_numpy(targets))
        losses.append(float(loss.detach()))
    out["pipe_losses"], out["pipe_params"] = losses, tree_map(_np, p)

    ep = create_mesh({"ep": n}, device="cpu")
    x, _ = moe_route_inputs()
    scales = {"scale": torch.arange(1, n + 1, dtype=torch.float32).reshape(n, 1, 1)}
    for capacity in (MOE_T, 1):
        layer = make_moe_layer(ep, expert_fn=lambda q, toks: toks * q["scale"],
                               router_fn=lambda toks: toks[:, 0].to(torch.int32),
                               capacity=capacity)
        out[f"moe_route_c{capacity}"] = _np(layer(scales, torch.from_numpy(x)))
    try:
        layer({"scale": torch.ones((2 * n, 1, 1))}, torch.zeros((4 * n, 4)))
    except ValueError as e:
        out["moe_experts_error"] = str(e)
    bad = np.ones((4 * n, 4), np.float32)
    bad[:, 0] = 99
    out["moe_invalid"] = _np(layer({"scale": 2 * torch.ones((n, 1, 1))}, torch.from_numpy(bad)))

    params, x, y = moe_train_inputs()
    for capacity in (64, 8):  # 8 of ~32 tokens a rank: capacity drops
        layer = make_moe_train_layer(ep, expert_fn=lambda q, toks: toks @ q["w"],
                                     capacity=capacity, k=2)
        out[f"moe_train_c{capacity}"] = moe_train_step(layer, params, x, y)
    return out
