"""The simulation pool's chunk sharded over ranks
(``tpfl_torch.simulation.batched_fit``, ``Settings.SHARD_NODES``) against
the same chunk unsharded and against the JAX pool's sharded chunk, on the
CPU.

The port's side runs in two ``gloo`` worlds of 4 spawned ranks
(``tests/torch_pool_worker.py``, 60 s collective timeout): rank 0 runs the
chunks and the pool, ranks 1-3 serve their row shards
(``serve_pool_shards(device="cpu")``) until rank 0's
``stop_pool_servants()``. Each case is a chunk of 6 learners (bucket 8,
unequal batch counts): the MLP, the CNN with ``conv_impl="pallas"``
(through the conv kernels' plain versions), FedProx's pull and SCAFFOLD's
tracked gradient sums, on ``nodes 4`` and ``hosts 2 x nodes 2``, and the
MLP on ``nodes 2 x model 2``. Each is held against

- the same chunk unsharded in this process (no world): bit-equal, since
  rows never mix and a row's arithmetic does not depend on how many rows
  share its launch;
- the JAX pool's sharded chunk on ``jax.devices()[:4]`` (``SHARD_DEVICES``
  4; ``conftest.py`` forces 8 CPU devices), from the same params, data and
  shuffle seed, at ``test_torch_simulation.py``'s ``PARITY`` (rtol 1e-4,
  atol 1e-5). The JAX CNN convolves through XLA, its plain reference.
"""

import numpy as np
import pytest
import torch

import torch_pool_worker as worker
import torch_spmd_worker as spmd_worker
from tpfl_torch.settings import Settings

EXACT = dict(rtol=0, atol=0)
PARITY = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _settings():
    from tpfl.settings import Settings as JaxSettings

    snaps = (Settings.snapshot(), JaxSettings.snapshot())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Rank results of the sharded world; every child has exited."""
    return spmd_worker.run_world(worker.sharded_results,
                                 workdir=str(tmp_path_factory.mktemp("pool")))


@pytest.fixture(scope="module")
def undivided(tmp_path_factory):
    return spmd_worker.run_world(worker.undivided_results,
                                 workdir=str(tmp_path_factory.mktemp("pool1")))


def _close(got: dict, want: dict, tol: dict, what: str) -> None:
    assert got.keys() == want.keys(), what
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=f"{what} {path}", **tol)


def _unsharded(case: str) -> dict:
    """The case's chunk in this process, where no world shards it."""
    from tpfl_torch.parallel.engine import nodes_mesh_axes
    from tpfl_torch.simulation import SuperLearnerPool

    worker.set_knobs()
    assert nodes_mesh_axes(8) is None
    try:
        return worker.run_chunk(case)
    finally:
        SuperLearnerPool.reset()


def _jax_sharded(mesh: str, case: str) -> dict:
    """The JAX pool's chunk of the same learners, sharded over 4 of the
    8 CPU devices on the mesh's knobs."""
    import jax
    import jax.numpy as jnp

    from tpfl.learning.aggregators import FedProx, Scaffold
    from tpfl.learning.dataset import TpflDataset as JaxDataset
    from tpfl.learning.jax_learner import JaxLearner
    from tpfl.learning.model import TpflModel as JaxModel
    from tpfl.models import CNN, MLP
    from tpfl.parallel.engine import maybe_nodes_mesh
    from tpfl.settings import Settings as JaxSettings
    from tpfl.simulation import batched_fit as jax_batched
    from tpfl_torch.utils.tree import tree_items

    kind, agg, epochs = worker.CASES[case]
    JaxSettings.set_test_settings()
    JaxSettings.SEED = worker.SEED
    JaxSettings.SHARD_NODES, JaxSettings.SHARD_DEVICES = True, 4
    JaxSettings.SHARD_HOSTS, JaxSettings.SHARD_MODEL = 1, 1
    for k, v in worker.MESHES[mesh].items():
        setattr(JaxSettings, k, v)
    assert maybe_nodes_mesh(8) is not None
    p0 = worker.init(kind)
    lns = []
    for i in range(worker.N_FITS):
        module = (CNN(channels=(4, 8), dense=16, out_channels=10, compute_dtype=jnp.float32,
                      conv_impl="xla") if kind == "cnn"
                  else MLP(hidden_sizes=(16,), out_channels=10, compute_dtype=jnp.float32))
        model = JaxModel(module=module, params=jax.tree_util.tree_map(jnp.asarray, p0))
        aggregator = {None: None, "fedprox": FedProx, "scaffold": Scaffold}[agg]
        ln = JaxLearner(model=model, data=JaxDataset.from_arrays(*worker.arrays(kind, i)),
                        addr=worker.addr(case, i),
                        aggregator=None if aggregator is None else aggregator(),
                        learning_rate=0.1, batch_size=16)
        ln.set_epochs(epochs)
        lns.append(ln)
    jax_batched._programs.clear()
    assert not jax_batched.run_batched_fits(jax_batched.job_signature(lns[0]), lns)
    info = []
    for ln in lns:
        got = {}
        for name, value in (ln._last_fit_model.get_info() or {}).items():
            if isinstance(value, dict):
                for k, v in value.items():
                    if isinstance(v, dict):
                        got.update({f"{name}/{k}/{p}": np.asarray(x) for p, x in tree_items(v)})
        info.append(got)
    return {"params": [{p: np.asarray(v) for p, v in tree_items(ln.get_model().get_parameters())}
                       for ln in lns], "info": info}


@pytest.mark.parametrize("mesh,case", worker.RUNS)
def test_sharded_chunk_equals_the_unsharded_chunk(world, mesh, case):
    """Every learner's params, sample count and fit info (SCAFFOLD's
    deltas from the gathered gradient sums) bit-equal to the chunk run
    unsharded in one process."""
    got, want = world[0][(mesh, case)], _unsharded(case)
    assert got["samples"] == want["samples"] == [32, 48, 64] * 2
    for i in range(worker.N_FITS):
        _close(got["params"][i], want["params"][i], EXACT, f"{mesh} {case} {i}")
        _close(got["info"][i], want["info"][i], EXACT, f"{mesh} {case} info {i}")
    if case == "scaffold":
        assert got["info"][0]
    from tpfl_torch.utils.tree import tree_items

    start = dict(tree_items(worker.init(worker.CASES[case][0])))
    for i in range(worker.N_FITS):
        assert all(not np.array_equal(got["params"][i][p], v) for p, v in start.items())


@pytest.mark.parametrize("mesh,case", worker.RUNS)
def test_sharded_chunk_matches_the_jax_pools_sharded_chunk(world, mesh, case):
    got, want = world[0][(mesh, case)], _jax_sharded(mesh, case)
    for i in range(worker.N_FITS):
        _close(got["params"][i], want["params"][i], PARITY, f"{mesh} {case} {i}")
        _close(got["info"][i], want["info"][i], PARITY, f"{mesh} {case} info {i}")


def test_pool_dispatches_the_fits_sharded(world):
    """Six ``VirtualNodeLearner`` fits through ``SuperLearnerPool``: one
    batched dispatch of 6, counted as unsharded, no fallback, and the
    params of the unsharded chunk."""
    got = world[0]["pooled"]
    assert got["errors"] == [None] * worker.N_FITS and got["alive"] == 0
    assert (got["dispatches"], got["group_sizes"], got["fallbacks"], got["singles"],
            got["counter"]) == (1, [6], 0, 0, 1.0)
    want = _unsharded("mlp")
    for i in range(worker.N_FITS):
        _close(got["params"][i], want["params"][i], EXACT, f"pooled {i}")


def test_servant_failure_reaches_every_fit_naming_its_rank(world):
    """A servant's fit that raises mid-chunk reaches every fitting node's
    ``fit()`` as a ``ShardedChunkError`` naming rank 2, with no fallback,
    no dispatch counted and no hang (well inside the 60 s timeout); the
    world serves on (the stop reaches every servant)."""
    got = world[0]["failing"]
    assert got["alive"] == 0 and got["wall"] < 30
    for err in got["errors"]:
        assert err == ("ShardedChunkError: pool shard on rank 2: "
                       "ValueError: injected servant failure")
    assert (got["dispatches"], got["fallbacks"], got["singles"], got["counter"]) == (0, 0, 0, 0)


def test_spec_that_does_not_pickle_raises_before_any_shard_leaves(world):
    name, message, propagates = world[0]["unpicklable"]
    assert name == "ShardedChunkError" and propagates
    assert "does not pickle, so no shard can leave rank 0" in message


def test_servants_count_their_chunks_and_are_stopped_once(world):
    """Each servant served every case that gave it a shard (``model 2``:
    only rank 2, the first of shard 1's model group), the pooled chunk
    and the failing one (a reset of rank 0's pool between them stops
    nothing), and nothing of the unpicklable one; the stop went to 3
    servants once."""
    per_mesh = len(worker.CASES)
    want = {1: 2 * per_mesh + 2, 2: 2 * per_mesh + 1 + 2, 3: 2 * per_mesh + 2}
    assert {r["rank"]: r["served"] for r in world[1:]} == want
    assert world[0]["stopped"] == [3, 0]
    assert all(r["h2d"] == 0 for r in world[1:])  # CPU ranks: no host->device copy


def test_bucket_that_does_not_divide_runs_unsharded_on_rank_0(undivided):
    """Two pooled fits (bucket 2) on ``hosts 2 x nodes 2``: 4 shards do not
    divide the bucket, so rank 0 trains the chunk alone, as the unsharded
    pool does, and the servants serve no chunk."""
    from tpfl_torch.simulation import SuperLearnerPool

    got = undivided[0]["pooled"]
    assert got["errors"] == [None, None]
    assert (got["dispatches"], got["group_sizes"], got["fallbacks"]) == (1, [2], 0)
    assert [r["served"] for r in undivided[1:]] == [0, 0, 0]
    assert undivided[0]["stopped"] == 3
    worker.set_knobs()
    try:
        want = worker.run_chunk_of(worker.learners("mlp", 2))
    finally:
        SuperLearnerPool.reset()
    for i in range(2):
        _close(got["params"][i], want["params"][i], EXACT, f"undivided {i}")


@pytest.mark.parametrize("axes,ranks", [
    ({"nodes": 4}, [0, 1, 2, 3]),
    ({"hosts": 2, "nodes": 2}, [0, 1, 2, 3]),
    ({"nodes": 2, "model": 2}, [0, 2]),
    ({"hosts": 2, "nodes": 2, "model": 2}, [0, 2, 4, 6]),
    ({"nodes": 8}, list(range(8))),
])
def test_shard_ranks_follow_the_reference_row_order(axes, ranks):
    """Shard ``s`` (rows ``s·k`` to ``(s+1)·k``, hosts first as the
    reference's ``federation_sharding`` places the node axis) goes to the
    first rank of its ``model`` group."""
    from tpfl_torch.simulation.batched_fit import _shard_ranks

    assert _shard_ranks(axes) == ranks


def test_shard_payload_round_trips_trees_and_data():
    """A shard's trees (nested, an empty aux, no correction) and data of
    several dtypes (bf16, int32, bool, an empty tensor) through one
    buffer, as a servant unpacks it."""
    from tpfl_torch.simulation.batched_fit import _from_payload, _pack, _shard_payload, _unpack

    g = torch.Generator().manual_seed(0)
    params = {"a": {"k": torch.randn(2, 3, 5, generator=g)},
              "b": torch.randn(2, 7, generator=g).to(torch.bfloat16)}
    data = [torch.randint(0, 9, (2, 3, 4), generator=g, dtype=torch.int32),
            torch.rand(2, 3, generator=g) > 0.5, torch.zeros((2, 0)), torch.ones(2)]
    tensors, metas, skeletons = _shard_payload((params, {}, None), data)
    back = _from_payload(_unpack(_pack(tensors, "cpu"), metas), skeletons)
    assert back[1] == {} and back[2] is None
    assert torch.equal(back[0]["a"]["k"], params["a"]["k"])
    assert back[0]["b"].dtype == torch.bfloat16 and torch.equal(back[0]["b"], params["b"])
    for got, want in zip(back[3:], data, strict=True):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_serve_pool_shards_needs_a_world_and_names_the_cpu():
    """``device=None`` is the card: without one it raises naming
    ``device='cpu'``; on the CPU outside a world (or on rank 0) it
    refuses to serve."""
    from tpfl_torch.simulation import serve_pool_shards

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve_pool_shards()
    with pytest.raises(ValueError, match="rank other than 0"):
        serve_pool_shards(device="cpu")


def test_must_propagate_a_sharded_or_distributed_error():
    import torch.distributed as dist

    from tpfl_torch.simulation.batched_fit import ShardedChunkError, must_propagate

    assert must_propagate(ShardedChunkError("x", rank=3))
    assert str(ShardedChunkError("boom", rank=3)) == "pool shard on rank 3: boom"
    assert must_propagate(dist.DistError("gloo"))
    assert not must_propagate(ValueError("an ordinary chunk failure"))
