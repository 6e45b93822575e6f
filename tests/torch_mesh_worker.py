"""The port's engine on a device mesh, in a ``gloo`` world of 4 spawned
ranks (``torch_spmd_worker.run_world``): every rank result the mesh test
files need, computed in one launch each.

Like ``torch_spmd_worker`` this module imports torch, numpy and
``tpfl_torch`` only (spawned children import it). The inputs come from
numpy seeds and the port's own initialisers, through functions the tests
call again to feed the JAX package the same numbers.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpfl_torch.parallel import distributed as spmd
from tpfl_torch.utils.tree import canonical_leaves, tree_items, tree_leaves, tree_map

F32 = torch.float32
W6 = np.asarray([1, 1, 0, 1, 1, 0], np.float32)
W8 = np.asarray([1, 1, 0, 1, 0, 1, 1, 0], np.float32)
W5 = np.asarray([1, 1, 0, 1, 1], np.float32)
W4 = np.asarray([1, 0, 1, 1], np.float32)
LM = dict(vocab=64, dim=32, heads=4, n_layers=1, max_len=64)


# ---- models and inputs (the tests build the JAX twins from the same numbers) -------


def module(kind: str) -> Any:
    from tpfl_torch.models import CNN, MLP, ResNet18, TransformerLM

    return {
        "mlp": lambda: MLP(hidden_sizes=(16,), out_channels=10, compute_dtype=F32),
        "cnn": lambda: CNN(channels=(4,), dense=16, out_channels=10, compute_dtype=F32,
                           conv_impl="pallas"),
        "resnet": lambda: ResNet18(stage_sizes=(1,), out_channels=10, compute_dtype=F32),
        "lm": lambda: TransformerLM(**LM, compute_dtype=F32),
    }[kind]()


def input_shape(kind: str) -> tuple:
    return {"mlp": (8, 8), "cnn": (8, 8, 3), "resnet": (8, 8, 3), "lm": (16,)}[kind]


def init(kind: str) -> tuple[dict, dict]:
    """One model's (params, aux) as numpy trees: the port's seed-0 init."""
    from tpfl_torch.interop import params_to_numpy
    from tpfl_torch.models import init_state

    params, aux = init_state(module(kind), input_shape(kind), seed=0, device="cpu")
    return params_to_numpy(params), params_to_numpy(aux) if aux else {}


def data(kind: str, n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Node-stacked ``[n, n_batches, b, ...]`` inputs and labels."""
    rng = np.random.default_rng(seed)
    if kind == "lm":
        return (rng.integers(0, 64, (n, 1, 2, 16)).astype(np.int32),
                rng.integers(0, 64, (n, 1, 2, 16)).astype(np.int32))
    shape = (n, 2, 4, *input_shape(kind)) if kind == "mlp" else (n, 1, 4, *input_shape(kind))
    return (rng.random(shape).astype(np.float32),
            rng.integers(0, 10, shape[:3]).astype(np.int32))


#: case -> (model, n_nodes, mesh name, algorithm, lr, weights, rounds, extra)
CASES = {
    "mlp_fedavg": ("mlp", 6, "nodes4", "fedavg", 0.1, W6, 2, {}),
    "mlp_scaffold": ("mlp", 6, "nodes4", "scaffold", 0.02, W6, 2, {}),
    "mlp_fedprox": ("mlp", 6, "nodes4", "fedprox", 0.1, W6, 2, {}),
    "mlp_zero": ("mlp", 6, "nodes4", "fedavg", 0.1, np.zeros(6, np.float32), 1, {}),
    "mlp_tele": ("mlp", 6, "nodes4", "fedavg", 0.1, W6, 2, {"telemetry": True}),
    "cnn_fedavg": ("cnn", 8, "nodes4", "fedavg", 0.1, W8, 2, {}),
    "resnet_mean": ("resnet", 4, "nodes4", "fedavg", 0.05, W4, 1, {"aux_mode": "mean"}),
    "resnet_local": ("resnet", 4, "nodes4", "fedavg", 0.05, W4, 1, {"aux_mode": "local"}),
    "h_fedavg": ("mlp", 6, "hosts2", "fedavg", 0.1, W6, 2, {}),
    "h_scaffold": ("mlp", 6, "hosts2", "scaffold", 0.02, W6, 2, {}),
    "h_quant8": ("mlp", 8, "hosts2", "fedavg", 0.1, W8, 2,
                 {"codec": "quant8", "telemetry": True}),
    "lm_fedavg": ("lm", 5, "model2", "fedavg", 0.05, W5, 2, {}),
    "lm_scaffold": ("lm", 5, "model2", "scaffold", 0.02, W5, 2, {}),
    "lm_quant8": ("lm", 4, "model2", "fedavg", 0.05, None, 1, {"codec": "quant8"}),
    "mlp_model1": ("mlp", 6, "model1", "fedavg", 0.1, W6, 2, {}),
    "mlp_attack": ("mlp", 6, "nodes4", "fedavg", 0.1, W6, 2,
                   {"attack": np.asarray([1, -1, 1, 1, -1, 1], np.float32)}),
    "mlp_fedbuff": ("mlp", 6, "hosts2", "fedavg", 0.1, None, 3,
                    {"periods": [1, 2, 1, 3, 1, 2], "telemetry": True}),
}


def schedule(extra: dict, n_rounds: int) -> Any:
    """The case's FedBuffSchedule (numpy, host side) or None."""
    from tpfl_torch.parallel.engine import FedBuffSchedule

    periods = extra.get("periods")
    return None if periods is None else FedBuffSchedule.from_periods(periods, n_rounds)

MESHES = {"nodes4": {"nodes": 4}, "hosts2": {"hosts": 2, "nodes": 2},
          "model2": {"nodes": 2, "model": 2}, "model1": {"nodes": 4, "model": 1}}


def _local(t: Any) -> torch.Tensor:
    """A placed tensor's local block (a plain tensor as it is)."""
    return t.to_local() if hasattr(t, "to_local") else t


def _host(t: Any) -> np.ndarray:
    return spmd.full_tensor(t).detach().cpu().numpy()


def _digest(tree: Any) -> str:
    h = hashlib.sha256()
    for leaf in canonical_leaves(tree):
        h.update(spmd.full_tensor(leaf).detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def engine(kind: str, n: int, mesh: Any, algorithm: str = "fedavg", lr: float = 0.1,
           aux_mode: str = "mean") -> Any:
    from tpfl_torch.parallel.engine import FederationEngine

    return FederationEngine(module(kind), n, mesh=mesh, seed=0, algorithm=algorithm,
                            learning_rate=lr, aux_mode=aux_mode, device="cpu")


def start(eng: Any, kind: str) -> tuple[Any, Optional[Any]]:
    """The engine's stacked (params, aux) from :func:`init`'s numbers."""
    p0, a0 = init(kind)
    to = lambda tree: tree_map(torch.from_numpy, tree)  # noqa: E731
    params = eng.broadcast_params(to(p0))
    return params, (eng.broadcast_params(to(a0)) if a0 else None)


def run_case(name: str, meshes: dict, rounds: Optional[int] = None) -> dict:
    """One case of :data:`CASES` on this rank: the whole (unpadded)
    params, aux, variates and losses as numpy, the digest of the padded
    params, the placed params' local bytes, and the telemetry carry."""
    from tpfl_torch.settings import Settings

    kind, n, mesh_name, algorithm, lr, w, n_rounds, extra = CASES[name]
    snap = Settings.snapshot()
    try:
        Settings.ENGINE_WIRE_CODEC = extra.get("codec", "dense")
        Settings.ENGINE_TELEMETRY = bool(extra.get("telemetry", False))
        eng = engine(kind, n, meshes[mesh_name], algorithm, lr, extra.get("aux_mode", "mean"))
        params, aux = start(eng, kind)
        xs, ys = data(kind, n)
        dx, dy = eng.shard_data(xs, ys)
        ss = eng.init_scaffold_state(eng._shard_state(params)) if algorithm == "scaffold" \
            else None
        k = rounds or n_rounds
        win = eng.dispatch_window(params, dx, dy, weights=w, n_rounds=k, aux=aux,
                                  scaffold_state=ss, attack_scales=extra.get("attack"),
                                  schedule=schedule(extra, k))
        tele = win.telemetry()
        out = win.finalize()
    finally:
        Settings.restore(snap)
    p, losses = out[0], out[-1]
    res = {
        "params": tree_map(_host, eng.unpad(p)),
        "losses": _host(losses)[:n],
        "digest": _digest(p),
        "local_bytes": sum(_local(t).numel() * t.element_size() for t in canonical_leaves(p)),
        "global_bytes": sum(t.numel() * t.element_size() for t in canonical_leaves(p)),
        "padded": eng.padded_nodes,
        "telemetry": tele,
    }
    if aux is not None:
        res["aux"] = tree_map(_host, eng.unpad(out[1]))
    if algorithm == "scaffold":
        c_locals, c_global = out[2]
        res["c_locals"] = tree_map(_host, eng.unpad(c_locals))
        res["c_global"] = tree_map(_host, c_global)
    return res


def _auto_meshes() -> dict:
    from tpfl_torch.parallel.engine import auto_mesh
    from tpfl_torch.settings import Settings

    out = {}
    snap = Settings.snapshot()
    try:
        for name, knobs in (("default", {}), ("devices2", {"SHARD_DEVICES": 2}),
                            ("model2", {"SHARD_MODEL": 2}), ("hosts2", {"SHARD_HOSTS": 2}),
                            ("hosts0", {"SHARD_HOSTS": 0}), ("model3", {"SHARD_MODEL": 3}),
                            ("hosts3", {"SHARD_HOSTS": 3})):
            Settings.restore(snap)
            Settings.SHARD_NODES = True
            for k, v in knobs.items():
                setattr(Settings, k, v)
            try:
                mesh = auto_mesh("cpu")
                out[name] = dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.mesh.shape)))
                out[name + "_in_mesh"] = mesh.get_coordinate() is not None
            except ValueError as e:
                out[name] = f"ValueError: {e}"
        Settings.restore(snap)
        out["off"] = auto_mesh("cpu")
    finally:
        Settings.restore(snap)
    return out


def _helpers(meshes: dict) -> dict:
    from tpfl_torch.parallel.mesh import (
        node_shard_dims,
        node_shard_size,
        padded_node_count,
        stacked_model_shardings,
        transformer_layout,
    )

    out = {}
    for name, mesh in meshes.items():
        out[name] = {"dims": node_shard_dims(mesh), "size": node_shard_size(mesh),
                     "padded": [padded_node_count(k, mesh) for k in (1, 4, 5, 6, 8, 9)]}
    p0, _ = init("lm")
    stacked = tree_map(lambda a: torch.zeros((4, *a.shape)), p0)
    specs = stacked_model_shardings(meshes["model2"], stacked, transformer_layout())
    out["lm_specs"] = {path: s.spec(len(p0_leaf.shape) + 1)
                       for (path, s), (_, p0_leaf) in zip(tree_items(specs), tree_items(p0))}
    return out


def _checkpoints(meshes: dict, workdir: str) -> dict:
    """World 1 -> world 4 and back through ``export_state`` /
    ``EngineCheckpointer``, and a ``SliceCheckpointer`` round trip of the
    placed state, each against running on without it."""
    from tpfl_torch.management.checkpoint import EngineCheckpointer, SliceCheckpointer

    rank = dist.get_rank()
    n, kind = 6, "mlp"
    xs, ys = data(kind, n)
    out = {}
    # world 1 -> world 4
    solo = engine(kind, n, None)
    p, _ = start(solo, kind)
    p, _ = solo.run_rounds(p, xs, ys, weights=W6)
    ck = EngineCheckpointer(os.path.join(workdir, f"engine-rank{rank}"))
    ck.save(solo.export_state(p), step=1)
    state, _ = ck.restore()
    mesh_eng = engine(kind, n, meshes["nodes4"])
    q, _ = mesh_eng.run_rounds(mesh_eng.import_state(state)["params"], xs, ys, weights=W6)
    p, _ = solo.run_rounds(p, xs, ys, weights=W6)
    out["to_world4"] = tree_map(_host, mesh_eng.unpad(q))
    out["stay_world1"] = tree_map(_host, solo.unpad(p))
    # world 4 -> world 1
    mesh_eng = engine(kind, n, meshes["nodes4"])
    q, _ = start(mesh_eng, kind)
    q, _ = mesh_eng.run_rounds(q, xs, ys, weights=W6)
    state = mesh_eng.export_state(q)
    solo = engine(kind, n, None)
    p, _ = solo.run_rounds(solo.import_state(state)["params"], xs, ys, weights=W6)
    q2, _ = mesh_eng.run_rounds(q, xs, ys, weights=W6, donate=False)  # q is saved below
    out["to_world1"] = tree_map(_host, solo.unpad(p))
    out["stay_world4"] = tree_map(_host, mesh_eng.unpad(q2))
    out["rounds_done"] = solo._rounds_done
    # SliceCheckpointer: the placed state saved, restored onto a fresh
    # placement, and one more round against running on.
    slc = SliceCheckpointer(os.path.join(workdir, "slice"))
    slc.save(1, {"params": q, "rounds_done": 1})
    fresh = engine(kind, n, meshes["nodes4"])
    target = {"params": fresh.init_params(input_shape(kind)), "rounds_done": 0}
    back = slc.restore(1, abstract_target=target)
    r1, _ = fresh.run_rounds(back["params"], xs, ys, weights=W6)
    out["slice_resumed"] = _digest(r1)
    out["slice_uninterrupted"] = _digest(q2)
    out["slice_rounds_done"] = back["rounds_done"]
    out["slice_saved"] = tree_map(_host, q)
    out["slice_latest"] = slc.latest_step()
    return out


def _pipeline(meshes: dict) -> dict:
    """WindowPipeline (4 rounds in windows of 2, SCAFFOLD) against the
    sequential dispatch chain on the 1D mesh: the same bytes."""
    from tpfl_torch.parallel.window_pipeline import WindowPipeline

    n, kind = 6, "mlp"
    xs, ys = data(kind, n)
    out = {}
    for driver in ("pipeline", "sequential"):
        eng = engine(kind, n, meshes["nodes4"], "scaffold", 0.02)
        p, _ = start(eng, kind)
        ss = eng.init_scaffold_state(eng._shard_state(p))
        if driver == "pipeline":
            res, done = WindowPipeline(eng).run(p, xs, ys, weights=W6, n_rounds=4, window=2,
                                                scaffold_state=ss, prefetch=False)
            p, ss = res[0], res[2]
        else:
            for _ in range(2):
                p, _, ss, _ = eng.run_rounds(p, xs, ys, weights=W6, n_rounds=2,
                                             scaffold_state=ss)
        out[driver] = _digest(p) + _digest(ss[0]) + _digest(ss[1])
    return out


def _membership(meshes: dict) -> dict:
    """A MembershipView of 6 live nodes (capacity tier 8) on the 1D mesh
    against the exact 6-node engine (padded to 8 there too), then a join
    that promotes the tier to 16: the state gathered, re-padded and
    placed again, and one more round."""
    from tpfl_torch.parallel.membership import MembershipView

    xs, ys = data("mlp", 8)
    xs[6:], ys[6:] = xs[:1], ys[:1]  # the exact engine's pad rows clone row 0
    view = MembershipView([f"n{i}" for i in range(6)], capacity_min=1)
    eng = engine("mlp", 6, meshes["nodes4"])
    eng.attach_membership(view)
    p, _ = start(eng, "mlp")
    p, _ = eng.run_rounds(p, xs, ys, weights=view.weights())
    exact = engine("mlp", 6, meshes["nodes4"])
    q, _ = start(exact, "mlp")
    q, _ = exact.run_rounds(q, xs[:6], ys[:6])
    out = {"capacity": int(view.capacity), "padded": eng.padded_nodes,
           "masked": _digest(p), "exact": _digest(q)}
    for i in range(6, 9):
        view.join(f"n{i}")
    out["moved"] = eng.sync_membership()
    p = eng.pad_stacked(p)
    xs16, ys16 = data("mlp", 16)
    p, losses = eng.run_rounds(p, xs16, ys16, weights=view.weights())
    out.update({"capacity_after": int(view.capacity), "padded_after": eng.padded_nodes,
                "local_rows_after": int(next(iter(canonical_leaves(p))).to_local().shape[0]),
                "losses_after": _host(losses)})
    return out


#: Cases whose window donation the mesh test holds: 1D, 3D and 2D.
DONATION_CASES = ("mlp_fedavg", "h_scaffold", "lm_fedavg")


def _donation(meshes: dict) -> dict:
    """Per case of :data:`DONATION_CASES`: the engine's donation report,
    whether it left the caller's placed params as they were, whether a
    donating and a non-donating window from equal states end on the same
    bytes, and whether the donating window wrote each placed input's
    local block in place (its outputs wrap the same storages)."""
    out = {}
    for name in DONATION_CASES:
        kind, n, mesh_name, algorithm, lr, w, n_rounds, _ = CASES[name]
        eng = engine(kind, n, meshes[mesh_name], algorithm, lr)
        dx, dy = eng.shard_data(*data(kind, n))

        def state() -> tuple:
            p = eng._shard_state(start(eng, kind)[0])
            return p, (eng.init_scaffold_state(p) if algorithm == "scaffold" else None)

        def storages(tree: Any) -> list:
            return [_local(t).untyped_storage().data_ptr() for t in canonical_leaves(tree)]

        p, ss = state()
        before = _digest(p)
        report = eng.donation_report(p, dx, dy, weights=w, n_rounds=n_rounds, scaffold_state=ss)
        intact = _digest(p) == before
        kept = eng.run_rounds(*state()[:1], dx, dy, weights=w, n_rounds=n_rounds,
                              scaffold_state=state()[1], donate=False)
        p, ss = state()
        ptrs = storages(p) + (storages(ss[0]) + storages(ss[1]) if ss else [])
        done = eng.run_rounds(p, dx, dy, weights=w, n_rounds=n_rounds, scaffold_state=ss,
                              donate=True)
        outs = storages(done[0]) + (storages(done[2][0]) + storages(done[2][1]) if ss else [])
        trees = (lambda r: [r[0], *r[2]]) if ss else (lambda r: [r[0]])
        out[name] = {"report": report, "caller_intact": intact, "in_place": outs == ptrs,
                     "bytes_equal": [_digest(t) for t in trees(done)]
                     == [_digest(t) for t in trees(kept)]}
    return out


def engine_mesh_results(workdir: str) -> dict:
    """Every rank result of ``tests/test_torch_engine_mesh.py``."""
    from tpfl_torch.parallel.mesh import create_mesh

    out = {"rank": dist.get_rank()}
    meshes = {name: create_mesh(axes, device="cpu") for name, axes in MESHES.items()}
    for name in CASES:
        out[name] = run_case(name, meshes)
    # Same seed, same topology: the same bytes.
    for name in ("mlp_fedavg", "h_fedavg", "lm_fedavg"):
        out[name + "_again"] = run_case(name, meshes)["digest"]
    out["auto"] = _auto_meshes()
    out["helpers"] = _helpers(meshes)
    out["checkpoints"] = _checkpoints(meshes, workdir)
    out["pipeline"] = _pipeline(meshes)
    out["membership"] = _membership(meshes)
    out["donation"] = _donation(meshes)
    return out


# ---- ShardedTrainer ----------------------------------------------------------------------

SHARDED = {
    # name: (model kind, mesh axes, fsdp, with aux, steps, batch, input shape)
    "mlp_dp": ("mlp64", {"dp": 4}, False, False, 5, 64, (28, 28)),
    "mlp_fsdp": ("mlp64", {"dp": 4}, True, False, 5, 64, (28, 28)),
    "resnet_dp": ("resnet", {"dp": 4}, False, True, 2, 16, (16, 16, 3)),
    "resnet_fsdp": ("resnet", {"dp": 4}, True, True, 2, 16, (16, 16, 3)),
    "cnn_fsdp": ("cnn8", {"dp": 4}, True, False, 2, 16, (8, 8, 3)),
}


def sharded_module(kind: str, attention: Any = None) -> Any:
    from tpfl_torch.models import CNN, MLP, ResNet18, TransformerLM

    return {
        "mlp64": lambda: MLP(hidden_sizes=(64,), out_channels=10, compute_dtype=F32),
        "resnet": lambda: ResNet18(stage_sizes=(1,), out_channels=10, compute_dtype=F32),
        "cnn8": lambda: CNN(channels=(8,), dense=32, out_channels=10, compute_dtype=F32,
                            conv_impl="pallas"),
        "lm": lambda: TransformerLM(vocab=32, dim=32, heads=2, n_layers=1, max_len=64,
                                    compute_dtype=F32, attention_fn=attention),
    }[kind]()


def sharded_init(kind: str, shape: tuple) -> tuple[dict, dict]:
    from tpfl_torch.interop import params_to_numpy
    from tpfl_torch.models import init_state

    params, aux = init_state(sharded_module(kind), shape, seed=0, device="cpu")
    return params_to_numpy(params), params_to_numpy(aux) if aux else {}


def sharded_batch(batch: int, shape: tuple, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    return (rng.random((batch, *shape)).astype(np.float32),
            rng.integers(0, 10, batch).astype(np.int32))


def _placed(trainer: Any, tree: dict, sharding: Any) -> Any:
    return spmd.global_put(tree_map(torch.from_numpy, tree), sharding)


def _run_trainer(name: str) -> dict:
    from tpfl_torch.parallel.mesh import create_mesh
    from tpfl_torch.parallel.sharded import ShardedTrainer

    kind, axes, fsdp, with_aux, steps, batch, shape = SHARDED[name]
    mesh = create_mesh(axes, device="cpu")
    tr = ShardedTrainer(sharded_module(kind), mesh, fsdp=fsdp, learning_rate=0.05)
    p0, a0 = sharded_init(kind, shape)
    params = _placed(tr, p0, tr._param_sharding(p0))
    aux = _placed(tr, a0, tr._sharding(None)) if a0 else {}
    opt = tree_map(zero_trace, params)
    x, y = tr.shard_batch(*sharded_batch(batch, shape))
    losses = []
    for _ in range(steps):
        if with_aux:
            params, aux, opt, loss = tr.train_step_with_aux(params, aux, opt, x, y)
        else:
            params, opt, loss = tr.train_step(params, opt, x, y)
        losses.append(float(loss))
    out = {"losses": losses, "params": tree_map(_host, params),
           "local_shapes": {path: tuple(t.to_local().shape) for path, t in tree_items(params)},
           "opt_local_shapes": {path: tuple(t.to_local().shape) for path, t in tree_items(opt)}}
    if with_aux:
        out["aux"] = tree_map(_host, aux)
    return out


def zero_trace(p: Any) -> Any:
    """An optimizer trace of zeros placed like ``p``."""
    return spmd.place_like(torch.zeros_like(p.to_local()), p)


def sharded_results() -> dict:
    """Every rank result of ``tests/test_torch_sharded.py``."""
    from tpfl_torch.parallel import make_ring_attention
    from tpfl_torch.parallel.mesh import create_mesh
    from tpfl_torch.parallel.sharded import ShardedTrainer

    out = {"rank": dist.get_rank()}
    for name in SHARDED:
        out[name] = _run_trainer(name)
    # init() refuses a module with mutable collections.
    mesh = create_mesh({"dp": 4}, device="cpu")
    try:
        ShardedTrainer(sharded_module("resnet"), mesh).init((16, 16, 3))
    except ValueError as e:
        out["bn_refusal"] = str(e)
    # Its own init: placed params and a zero trace like them.
    tr = ShardedTrainer(sharded_module("mlp64"), mesh, fsdp=True)
    p, o = tr.init((28, 28))
    out["init_specs"] = {path: [(pl.is_shard(), getattr(pl, "dim", None)) for pl in t.placements]
                         for path, t in tree_items(p)}
    out["init_opt_zero"] = all(float(t.to_local().abs().sum()) == 0 for t in tree_leaves(o))
    # Composed dp x sp: the batch over dp, ring attention over sp.
    mesh2 = create_mesh({"dp": 2, "sp": 2}, device="cpu")
    lm = sharded_module("lm", make_ring_attention(mesh2, axis_name="sp", causal=True,
                                                  impl="flash"))
    tr = ShardedTrainer(lm, mesh2, learning_rate=0.1, loss_fn=_next_token_loss)
    p0, _ = sharded_init("lm", (32,))
    params = _placed(tr, p0, tr._param_sharding(p0))
    opt = tree_map(zero_trace, params)
    tokens = lm_tokens()
    x, y = tr.shard_batch(tokens, tokens)
    params, opt, loss = tr.train_step(params, opt, x, y)
    out["dp_sp_loss"] = float(loss)
    out["dp_sp_params"] = tree_map(_host, params)
    return out


def lm_tokens() -> np.ndarray:
    return np.random.default_rng(2).integers(0, 31, (4, 32)).astype(np.int32)


def _next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per-token cross entropy of each position's prediction of the next
    token (the reference's composed step)."""
    from tpfl_torch.learning.torch_learner import cross_entropy_loss

    return cross_entropy_loss(logits[:, :-1], tokens[:, 1:])


# ---- static scaling analysis ------------------------------------------------------------

WIDTHS = (1, 2, 4)


def _fed_record(d: int, n_nodes: int) -> Optional[dict]:
    """One 1-round engine window of an 8x8 MLP over ``n_nodes`` nodes on a
    ``nodes`` mesh of the first ``d`` ranks; None outside the mesh. Every
    rank must call it (the mesh's groups)."""
    from tpfl_torch.parallel.engine import FederationEngine
    from tpfl_torch.parallel.mesh import create_mesh
    from tpfl_torch.parallel.scaling import analyze, params_bytes

    mesh = create_mesh({"nodes": d}, device="cpu", ranks=d)
    if mesh.get_coordinate() is None:
        return None
    eng = FederationEngine(module("mlp"), n_nodes, mesh=mesh, seed=0, device="cpu")
    p = eng.init_params((8, 8))
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(n_nodes, 2, 4, 8, 8)).astype(np.float32)
    ys = rng.integers(0, 10, (n_nodes, 2, 4)).astype(np.int32)
    dx, dy = eng.shard_data(xs, ys)
    rec = analyze(eng.run_rounds, p, dx, dy)
    rec.pop("result")
    rec["width"] = d
    rec["params_bytes"] = params_bytes(p) // eng.padded_nodes  # one node's model
    return rec


def _fsdp_record(d: int, per_dev_batch: int, aux: bool = False) -> Optional[dict]:
    from tpfl_torch.models import CNN, ResNet18
    from tpfl_torch.parallel.mesh import create_mesh
    from tpfl_torch.parallel.scaling import analyze, params_bytes
    from tpfl_torch.parallel.sharded import ShardedTrainer

    mesh = create_mesh({"dp": d}, device="cpu", ranks=d)
    if mesh.get_coordinate() is None:
        return None
    module = (ResNet18(out_channels=10, stage_sizes=(1,), compute_dtype=F32) if aux else
              CNN(channels=(8,), dense=32, compute_dtype=F32, conv_impl="pallas"))
    tr = ShardedTrainer(module, mesh, fsdp=True)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(per_dev_batch * d, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, (per_dev_batch * d,)).astype(np.int32)
    sx, sy = tr.shard_batch(x, y)
    if aux:
        p, a, opt = tr.init_with_aux((8, 8, 3))
        rec = analyze(tr.train_step_with_aux, p, a, opt, sx, sy)
    else:
        p, opt = tr.init((8, 8, 3))
        rec = analyze(tr.train_step, p, opt, sx, sy)
    rec.pop("result")
    rec["params_bytes"] = params_bytes(p)
    return rec


def _ring_permute_bytes(d: int) -> Optional[dict]:
    """The flash ring's fwd + bwd over ``sp`` of the first ``d`` ranks
    (the kernels' plain versions on the CPU): the permuted bytes."""
    from tpfl_torch.parallel.mesh import create_mesh
    from tpfl_torch.parallel.ring_attention import make_ring_attention
    from tpfl_torch.parallel.scaling import analyze

    mesh = create_mesh({"sp": d}, device="cpu", ranks=d)
    if mesh.get_coordinate() is None:
        return None
    rng = np.random.default_rng(0)
    qkv = [torch.from_numpy(rng.normal(size=(1, 64, 2, 8)).astype(np.float32))
           .requires_grad_(True) for _ in range(3)]
    ring = make_ring_attention(mesh, causal=True, impl="flash")

    def step():
        torch.autograd.grad(ring(*qkv).pow(2).sum(), qkv)

    return analyze(step)["collectives"]


def _pipeline_permute_bytes(n_micro: int) -> dict:
    from tpfl_torch.parallel.mesh import create_mesh
    from tpfl_torch.parallel.pipeline import make_pipeline_trainer
    from tpfl_torch.parallel.scaling import analyze

    mesh = create_mesh({"pp": 4}, device="cpu")
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(0, 0.3, (8, 8, 8)).astype(np.float32))
    init, step = make_pipeline_trainer(mesh, lambda p, x: x + torch.tanh(x @ p["w"]), n_layers=8,
                                       loss_fn=lambda out, tgt: torch.mean((out - tgt) ** 2))
    params, opt = init({"w": w})
    micro = torch.from_numpy(rng.normal(size=(n_micro, 2, 8)).astype(np.float32))
    return analyze(step, params, opt, micro, micro)["collectives"]


def _moe_all_to_all_bytes(d: int, cap: int = 4, dim: int = 8) -> Optional[dict]:
    from tpfl_torch.parallel.mesh import create_mesh
    from tpfl_torch.parallel.moe import moe_dispatch
    from tpfl_torch.parallel.scaling import analyze

    mesh = create_mesh({"ep": d}, device="cpu", ranks=d)
    if mesh.get_coordinate() is None:
        return None
    rng = np.random.default_rng(dist.get_rank())
    toks = torch.from_numpy(rng.normal(size=(4, dim)).astype(np.float32))
    eo = torch.from_numpy(rng.integers(0, d, size=(4,)).astype(np.int32))
    return analyze(moe_dispatch, toks, eo, lambda t: t * 2.0, cap,
                   mesh.get_group("ep"))["collectives"]


def _learner_payloads(mesh: Any) -> dict:
    """FederationLearners on the ``nodes 4`` mesh with 4 and 8 local nodes:
    the wire payload of each fit's model (its aggregate) — O(params),
    whatever the local node count."""
    from tpfl_torch.learning.dataset import TpflDataset
    from tpfl_torch.learning.model import TpflModel
    from tpfl_torch.models import MLP, init_params
    from tpfl_torch.parallel.federation_learner import FederationLearner

    rng = np.random.default_rng(0)
    x = rng.random((256, 8, 8)).astype(np.float32)
    y = rng.integers(0, 10, 256).astype(np.int32)
    out = {}
    for k in (4, 8):
        mod = MLP(hidden_sizes=(16,), out_channels=10, compute_dtype=F32)
        model = TpflModel(mod, init_params(mod, (8, 8), seed=0, device="cpu"), device="cpu")
        data = TpflDataset.from_arrays(x[:192], y[:192], x[192:], y[192:])
        ln = FederationLearner(model, data, addr=f"host-{k}", n_local_nodes=k, mesh=mesh,
                               batch_size=8, device="cpu")
        ln.set_epochs(1)
        fitted = ln.fit()
        payload = fitted.encode_parameters()
        out[k] = {"payload": len(payload), "digest": hashlib.sha256(payload).hexdigest(),
                  "eval": ln.evaluate()}
    return out


def _ledger_exact() -> dict:
    """Each plain collective under the ledger, beside the bytes of the
    tensor it delivered here."""
    from tpfl_torch.parallel.mesh import create_mesh

    mesh = create_mesh({"x": 4}, device="cpu")
    g = mesh.get_group("x")
    delivered = {}
    with spmd.record_collectives() as ledger:
        t = spmd.all_reduce(torch.ones(3, 5), g)
        delivered["all-reduce"] = t.numel() * t.element_size()
        t = spmd.all_gather(torch.ones(2, 3), 0, g)
        delivered["all-gather"] = t.numel() * t.element_size()
        t = spmd.reduce_scatter(torch.ones(8, 3), 0, g)
        delivered["reduce-scatter"] = t.numel() * t.element_size()
        t = spmd.send_recv([torch.ones(4), torch.ones(2, 2, dtype=torch.float64)], g)
        delivered["collective-permute"] = sum(u.numel() * u.element_size() for u in t)
        t = spmd.all_to_all(torch.ones(4, 2), g)
        delivered["all-to-all"] = t.numel() * t.element_size()
    values = {"all-reduce": float(spmd.all_reduce(torch.ones(()), g)),
              "reduce-scatter": spmd.reduce_scatter(
                  torch.arange(8.0) * (dist.get_rank() + 1), 0, g).tolist()}
    return {"by_kind": ledger.by_kind(), "events": list(ledger.events), "delivered": delivered,
            "values": values}


def scaling_results() -> dict:
    """Every rank result of ``tests/test_torch_scaling.py``."""
    from tpfl_torch.parallel.mesh import create_mesh

    out = {"rank": dist.get_rank()}
    out["fed"] = [_fed_record(d, 8) for d in WIDTHS]
    out["fed_nodes16"] = _fed_record(2, 16)
    out["fsdp"] = [_fsdp_record(d, 4) for d in WIDTHS]
    out["fsdp_batch8"] = _fsdp_record(4, 8)
    out["fsdp_aux"] = [_fsdp_record(4, b, aux=True) for b in (4, 8)]
    out["ring"] = {d: _ring_permute_bytes(d) for d in (2, 4)}
    out["pipeline"] = {m: _pipeline_permute_bytes(m) for m in (4, 8)}
    out["moe"] = {d: _moe_all_to_all_bytes(d) for d in (2, 4)}
    out["learner"] = _learner_payloads(create_mesh({"nodes": 4}, device="cpu"))
    out["ledger"] = _ledger_exact()
    return out
