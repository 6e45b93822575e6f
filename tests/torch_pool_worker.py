"""The simulation pool's chunk sharded over the ranks of a ``gloo`` world
(``torch_spmd_worker.run_world``): rank 0 runs the chunks and the pool,
every other rank serves its row shards through
``tpfl_torch.simulation.serve_pool_shards``.

Like ``torch_spmd_worker`` this module imports torch, numpy and
``tpfl_torch`` only (spawned children import it). The learners come from
numpy seeds and the port's own initialisers, through :func:`learners`,
which the tests call again for the unsharded chunk in one process and to
give the JAX pool the same numbers.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

F32 = torch.float32
N_FITS = 6  # a chunk of 6 learners: bucket 8, the last shard all dummy rows
#: case -> (model kind, aggregator, epochs)
CASES = {"mlp": ("mlp", None, 2), "cnn": ("cnn", None, 1), "fedprox": ("mlp", "fedprox", 2),
         "scaffold": ("mlp", "scaffold", 2)}
#: mesh name -> the SHARD_* knobs over a world of 4
MESHES = {"nodes4": {}, "hosts2": {"SHARD_HOSTS": 2}, "model2": {"SHARD_MODEL": 2}}
#: (mesh, case) pairs the world runs, in order
RUNS = [(m, c) for m in ("nodes4", "hosts2") for c in CASES] + [("model2", "mlp")]
SEED = 11
FAIL_RANK = 2


def module(kind: str) -> Any:
    from tpfl_torch.models import CNN, MLP

    if kind == "cnn":
        return CNN(channels=(4, 8), dense=16, out_channels=10, compute_dtype=F32,
                   conv_impl="pallas")
    return MLP(hidden_sizes=(16,), out_channels=10, compute_dtype=F32)


def input_shape(kind: str) -> tuple:
    return (8, 8, 3) if kind == "cnn" else (8, 8)


def arrays(kind: str, i: int) -> tuple:
    """Learner ``i``'s (x_train, y_train, x_test, y_test): 32, 48 or 64
    samples, so batch counts differ and the chunk pads."""
    from tpfl_torch.learning.dataset.synthetic import synthetic_classification

    return synthetic_classification(input_shape(kind), n_train=32 + 16 * (i % 3), n_test=8,
                                    seed=100 + i)


def init(kind: str) -> dict:
    """The case's seed-0 params as a numpy flax tree (every learner starts
    from them)."""
    from tpfl_torch.interop import params_to_numpy
    from tpfl_torch.models import init_params

    return params_to_numpy(init_params(module(kind), input_shape(kind), seed=0, device="cpu"))


def addr(case: str, i: int) -> str:
    return f"pool-{case}-{i}"


def learners(case: str, n: int = N_FITS, optimizer_factory: Any = None) -> list:
    """The case's ``n`` TorchLearners on the CPU (batch 16, lr 0.1)."""
    from tpfl_torch.interop import params_from_flax
    from tpfl_torch.learning.aggregators import FedProx, Scaffold
    from tpfl_torch.learning.dataset import TpflDataset
    from tpfl_torch.learning.model import TpflModel
    from tpfl_torch.learning.torch_learner import TorchLearner

    kind, agg, epochs = CASES[case]
    p0 = init(kind)
    out = []
    for i in range(n):
        model = TpflModel(module(kind), params_from_flax(p0, device="cpu"), device="cpu")
        aggregator = {None: None, "fedprox": lambda: FedProx(device="cpu"),
                      "scaffold": lambda: Scaffold(device="cpu")}[agg]
        ln = TorchLearner(model, TpflDataset.from_arrays(*arrays(kind, i)), addr=addr(case, i),
                          aggregator=None if aggregator is None else aggregator(),
                          learning_rate=0.1, batch_size=16, device="cpu",
                          optimizer_factory=optimizer_factory)
        ln.set_epochs(epochs)
        out.append(ln)
    return out


def set_knobs(mesh: str = "nodes4") -> None:
    """The test profile, the shuffle seed and the mesh's SHARD_* knobs."""
    from tpfl_torch.settings import Settings

    Settings.set_test_settings()
    Settings.SEED = SEED
    Settings.SHARD_NODES, Settings.SHARD_DEVICES = True, 0
    Settings.SHARD_HOSTS, Settings.SHARD_MODEL = 1, 1
    for k, v in MESHES[mesh].items():
        setattr(Settings, k, v)


def host_params(ln: Any) -> dict:
    from tpfl_torch.utils.tree import tree_items

    return {p: v.detach().cpu().numpy().copy()
            for p, v in tree_items(ln.get_model().get_parameters())}


def fit_info(ln: Any) -> dict:
    """The callbacks' info of the last fit (SCAFFOLD's deltas), numpy."""
    from tpfl_torch.utils.tree import tree_items

    out = {}
    for name, value in (ln._last_fit_model.get_info() or {}).items():
        if isinstance(value, dict):
            for k, v in value.items():
                if isinstance(v, dict):
                    out.update({f"{name}/{k}/{p}": x.detach().cpu().numpy().copy()
                                for p, x in tree_items(v)})
    return out


def run_chunk(case: str) -> dict:
    """The case's chunk through ``run_batched_fits`` (a fresh program):
    every learner's params and fit info."""
    return run_chunk_of(learners(case))


def run_chunk_of(lns: list) -> dict:
    from tpfl_torch.simulation import batched_fit

    batched_fit.clear_programs()
    failed = batched_fit.run_batched_fits(batched_fit.job_signature(lns[0]), lns)
    assert not failed
    return {"params": [host_params(ln) for ln in lns], "info": [fit_info(ln) for ln in lns],
            "samples": [ln.get_model().get_num_samples() for ln in lns]}


def pooled_fits(case: str, n: int) -> dict:
    """``n`` learners' fits through ``SuperLearnerPool`` at once
    (``VirtualNodeLearner``, group hint ``n``): each fit's params or the
    error it raised, what the pool's counters added, and the wall time."""
    from tpfl_torch.management.telemetry import metrics
    from tpfl_torch.simulation import SuperLearnerPool, VirtualNodeLearner

    pool = SuperLearnerPool.instance()
    before = (pool.batched_dispatches, len(pool.group_sizes), pool.fallbacks, pool.singles,
              metrics.value("tpfl_sim_batched_dispatch_total"))
    wrapped = [VirtualNodeLearner(ln) for ln in learners(case, n)]
    errors: list = [None] * n

    def fit(i: int) -> None:
        try:
            wrapped[i].set_fit_group_hint(n)
            wrapped[i].fit()
        except Exception as e:  # recorded for the test
            errors[i] = f"{type(e).__name__}: {e}"

    t0 = time.monotonic()
    threads = [threading.Thread(target=fit, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return {"params": [host_params(w) for w in wrapped], "errors": errors,
            "alive": sum(t.is_alive() for t in threads), "wall": time.monotonic() - t0,
            "dispatches": pool.batched_dispatches - before[0],
            "group_sizes": list(pool.group_sizes[before[1]:]),
            "fallbacks": pool.fallbacks - before[2], "singles": pool.singles - before[3],
            "counter": metrics.value("tpfl_sim_batched_dispatch_total") - before[4]}


def _fail_flag(workdir: str) -> str:
    return os.path.join(workdir, f"fail-rank{FAIL_RANK}")


def _serve(workdir: str) -> dict:
    """A servant rank: serve until rank 0's stop. Rank ``FAIL_RANK``'s
    fit raises once while rank 0's flag file exists."""
    from tpfl_torch.simulation import batched_fit, serve_pool_shards

    if dist.get_rank() == FAIL_RANK:
        real = batched_fit.BatchedFitProgram.run

        def run(self, *args, **kwargs):
            if os.path.exists(_fail_flag(workdir)):
                os.remove(_fail_flag(workdir))
                raise ValueError("injected servant failure")
            return real(self, *args, **kwargs)

        batched_fit.BatchedFitProgram.run = run
    return {"rank": dist.get_rank(), "served": serve_pool_shards(device="cpu"),
            "h2d": batched_fit.h2d_copies}


def sharded_results(workdir: str) -> dict:
    """Rank 0: every case of :data:`RUNS`, the pooled dispatch, a spec
    that does not pickle, a servant that fails mid-chunk, then the stop.
    Other ranks: the servant loop."""
    from tpfl_torch.learning.torch_learner import default_optimizer
    from tpfl_torch.settings import Settings
    from tpfl_torch.simulation import SuperLearnerPool, batched_fit

    set_knobs()
    if dist.get_rank() != 0:
        return _serve(workdir)

    out: dict[str, Any] = {"rank": 0}
    for mesh, case in RUNS:
        set_knobs(mesh)
        out[(mesh, case)] = run_chunk(case)
    set_knobs()
    Settings.SIM_BATCH_MAX_WAIT = 30.0
    out["pooled"] = pooled_fits("mlp", N_FITS)
    SuperLearnerPool.reset()  # between experiments: the servants serve on
    # A spec that will not pickle: nothing leaves rank 0.
    lns = learners("mlp", optimizer_factory=lambda lr: default_optimizer(lr))
    try:
        batched_fit.run_batched_fits(batched_fit.job_signature(lns[0]), lns)
        out["unpicklable"] = None
    except Exception as e:
        out["unpicklable"] = (type(e).__name__, str(e), batched_fit.must_propagate(e))
    with open(_fail_flag(workdir), "w"):
        pass
    out["failing"] = pooled_fits("mlp", N_FITS)
    out["stopped"] = [batched_fit.stop_pool_servants(), batched_fit.stop_pool_servants()]
    SuperLearnerPool.reset()
    return out


def undivided_results(workdir: str) -> dict:
    """Rank 0: a pooled chunk of 2 fits (bucket 2, which 4 shards do not
    divide) on the ``hosts 2 x nodes 2`` knobs, then the stop; the
    servants serve no chunk."""
    from tpfl_torch.settings import Settings
    from tpfl_torch.simulation import SuperLearnerPool, batched_fit

    set_knobs("hosts2")
    if dist.get_rank() != 0:
        return _serve(workdir)
    Settings.SIM_BATCH_MAX_WAIT = 30.0
    out = {"rank": 0, "pooled": pooled_fits("mlp", 2)}
    SuperLearnerPool.reset()
    out["stopped"] = batched_fit.stop_pool_servants()
    return out
