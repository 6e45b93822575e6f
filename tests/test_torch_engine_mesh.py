"""The port's engine on a device mesh (tpfl_torch.parallel.engine) against
the JAX engine on the same 4-device mesh, on the CPU.

The port's side runs once, in a ``gloo`` world of 4 spawned ranks
(``tests/torch_mesh_worker.py``): the 1D ``nodes 4`` mesh, the 3D
``hosts 2 x nodes 2`` mesh and the 2D ``nodes 2 x model 2`` mesh, with
node counts that need pad rows and weights with zeros in them. The JAX
side runs in this process on ``jax.devices()[:4]`` (``conftest.py``
forces 8 CPU devices), from the same numpy inputs and the port's own
initial params. Both sides are the counterparts of
``tests/test_engine.py:71-641`` and ``tests/test_crosshost.py:125-207``.

Tolerances: MLP, CNN and ResNet rtol 1e-4, atol 1e-5 (f32 sums in
another order on either side); the 2D TransformerLM atol 5e-4, the JAX
suite's own for its 2D mesh against one device (ring attention's blocks
merge in another order). Under the q8 codec a leaf may land one
quantisation step apart (``max|leaf| / 127``) and the mean loss within
2%, as ``tests/test_crosshost.py:169`` holds the codec'd DCN leg. Same
seed, same topology: the same bytes on every rank and across runs; a
``model`` axis of size 1 gives the 1D mesh's bytes.
"""

import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
import torch_spmd_worker as spmd_worker
from tpfl_torch.learning import compression
from tpfl_torch.utils.tree import tree_items

RTOL, ATOL = 1e-4, 1e-5
LM_ATOL = 5e-4


@pytest.fixture(autouse=True)
def _no_series_behind():
    """No engine series, ledger entry or ``engine:`` ring of the telemetry
    windows stays behind for a later file on the same worker."""
    yield
    from tpfl.management import ledger as jax_ledger
    from tpfl.management.telemetry import flight as jax_flight
    from tpfl.management.telemetry import metrics as jax_metrics
    from tpfl_torch.management import ledger, profiling
    from tpfl_torch.management.telemetry import flight, metrics

    for lg in (ledger, jax_ledger):
        lg.contrib.reset()
        lg.convergence.reset()
    profiling.rounds.reset()
    for reg in (metrics, jax_metrics):
        reg.reset()
    for ring in (flight, jax_flight):
        for node in ring.nodes():
            if node.startswith("engine:"):
                ring.clear(node)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh")


@pytest.fixture(scope="module")
def world(workdir):
    """Every rank's results; the world's children have exited when it
    returns."""
    return spmd_worker.run_world(worker.engine_mesh_results, workdir=str(workdir))


def _jax_module(kind):
    import jax.numpy as jnp

    from tpfl.models import CNN, MLP, ResNet18, TransformerLM

    return {
        "mlp": lambda: MLP(hidden_sizes=(16,), out_channels=10, compute_dtype=jnp.float32),
        "cnn": lambda: CNN(channels=(4,), dense=16, out_channels=10, compute_dtype=jnp.float32,
                           conv_impl="xla"),
        "resnet": lambda: ResNet18(stage_sizes=(1,), out_channels=10,
                                   compute_dtype=jnp.float32),
        "lm": lambda: TransformerLM(**worker.LM, compute_dtype=jnp.float32),
    }[kind]()


def _jax_mesh(name):
    import jax

    from tpfl.parallel import create_mesh

    return create_mesh(worker.MESHES[name], devices=jax.devices()[:4])


_JAX = {}


def _jax_case(name):
    """The JAX engine's run of a worker case on the same mesh shape:
    whole (unpadded) numpy trees and the telemetry carry."""
    if name in _JAX:
        return _JAX[name]
    import jax
    import jax.numpy as jnp

    from tpfl.parallel.engine import FederationEngine
    from tpfl.settings import Settings

    kind, n, mesh_name, algorithm, lr, w, rounds, extra = worker.CASES[name]
    snap = Settings.snapshot()
    try:
        Settings.ENGINE_WIRE_CODEC = extra.get("codec", "dense")
        Settings.ENGINE_TELEMETRY = bool(extra.get("telemetry", False))
        eng = FederationEngine(_jax_module(kind), n, mesh=_jax_mesh(mesh_name), seed=0,
                               algorithm=algorithm, learning_rate=lr,
                               aux_mode=extra.get("aux_mode", "mean"))
        p0, a0 = worker.init(kind)
        params = eng.broadcast_params(jax.tree_util.tree_map(jnp.asarray, p0))
        aux = eng.broadcast_params(jax.tree_util.tree_map(jnp.asarray, a0)) if a0 else None
        xs, ys = worker.data(kind, n)
        dx, dy = eng.shard_data(xs, ys)
        ss = eng.init_scaffold_state(eng._shard_state(params)) if algorithm == "scaffold" \
            else None
        sched = None
        if extra.get("periods") is not None:
            from tpfl.parallel.engine import FedBuffSchedule

            sched = FedBuffSchedule.from_periods(extra["periods"], rounds)
        win = eng.dispatch_window(params, dx, dy, weights=w, n_rounds=rounds, aux=aux,
                                  scaffold_state=ss, donate=False,
                                  attack_scales=extra.get("attack"), schedule=sched)
        tele = None if win._tele is None else {k: np.array(v) for k, v in win._tele.items()}
        out = win.finalize()
    finally:
        Settings.restore(snap)
    host = lambda t: jax.tree_util.tree_map(np.array, eng.unpad(t))  # noqa: E731
    res = {"params": host(out[0]), "losses": np.array(out[-1])[:n], "telemetry": tele}
    if aux is not None:
        res["aux"] = host(out[1])
    if algorithm == "scaffold":
        res["c_locals"] = host(out[2][0])
        res["c_global"] = jax.tree_util.tree_map(np.array, out[2][1])
    _JAX[name] = res
    return res


def _close(got, want, what, **tol):
    got, want = dict(tree_items(got)), dict(tree_items(want))
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, err_msg=f"{what} {path}", **tol)


def _assert_case(world, name, **tol):
    got, want = world[0][name], _jax_case(name)
    for key in ("params", "aux", "c_locals", "c_global"):
        if key in want:
            _close(got[key], want[key], f"{name} {key}", **tol)
    np.testing.assert_allclose(got["losses"], want["losses"], **tol)


# ---- the three meshes against the JAX engine --------------------------------------


@pytest.mark.parametrize("name", ["mlp_fedavg", "mlp_scaffold", "mlp_fedprox", "mlp_zero",
                                  "cnn_fedavg"])
def test_1d_mesh_matches_jax(world, name):
    """``nodes 4``: 6 nodes pad to 8 (the all-zero round falls back to the
    uniform mean over the 6 real nodes), the CNN through the conv
    kernels' plain versions."""
    assert world[0][name]["padded"] == 8 or worker.CASES[name][1] == 8
    _assert_case(world, name, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["resnet_mean", "resnet_local"])
def test_aux_modes_on_the_mesh_match_jax(world, name):
    """BatchNorm's ``batch_stats`` folded (``mean``) or kept per node
    (``local``, FedBN) on the 1D mesh, one node a rank."""
    _assert_case(world, name, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["h_fedavg", "h_scaffold"])
def test_3d_hosts_mesh_matches_jax(world, name):
    """``hosts 2 x nodes 2``: the two-leg fold (``nodes``, then ``hosts``)
    against the JAX engine's forced-hosts mesh, and allclose to the 1D
    mesh's run of the same federation."""
    _assert_case(world, name, rtol=RTOL, atol=ATOL)
    flat = "mlp_" + name.split("_")[1]
    _close(world[0][name]["params"], world[0][flat]["params"], name, rtol=RTOL, atol=ATOL)


def test_2d_model_mesh_matches_jax(world):
    """``nodes 2 x model 2``: 5 nodes pad to 6, each node's TransformerLM
    split over ``model`` by the transformer layout, its attention on the
    ``model`` ring, against the JAX engine's GSPMD program; SCAFFOLD's 2D
    window too (``c_global`` split over ``model``, each model shard
    folding its own slice of the variates)."""
    assert world[0]["lm_fedavg"]["padded"] == 6
    _assert_case(world, "lm_fedavg", atol=LM_ATOL)
    _assert_case(world, "lm_scaffold", atol=LM_ATOL)


@pytest.mark.parametrize("name", ["mlp_attack", "mlp_fedbuff"])
def test_engine_variants_on_the_mesh_match_jax(world, name):
    """The variants run through the same window on a mesh: a seeded sign
    flip's ``attack_scales`` on the 1D mesh (pad rows' scales one), and
    FedBuff rounds (each node's arrival schedule, stragglers keeping
    their local training) on the 3D mesh with the carry's staleness
    rows."""
    _assert_case(world, name, rtol=RTOL, atol=ATOL)
    if name == "mlp_fedbuff":
        want = _jax_case(name)["telemetry"]["staleness"]
        for rank, r in enumerate(world):
            np.testing.assert_array_equal(r[name]["telemetry"]["staleness"],
                                          want[:, 2 * rank:2 * rank + 2])


@pytest.mark.parametrize("name", ["h_quant8", "lm_quant8"])
def test_quant8_codec_on_the_mesh_matches_jax(world, name):
    """The q8 wire codec on the node exchange (and on the 3D mesh's DCN
    leg; on the 2D mesh over each node's whole leaf): every leaf within
    one quantisation step of the JAX engine's, the mean loss within 2%."""
    got, want = world[0][name], _jax_case(name)
    for path, w in tree_items(want["params"]):
        g = dict(tree_items(got["params"]))[path]
        step = float(np.abs(w).max()) / 127.0
        np.testing.assert_allclose(g, w, atol=step + ATOL, err_msg=path)
    assert abs(got["losses"].mean() - want["losses"].mean()) <= 0.02 * want["losses"].mean()


# ---- the telemetry carry and the DCN row --------------------------------------------


def test_dcn_bytes_row_is_hosts_times_the_codec_model_bytes(world):
    """The 3D mesh's carry grows ``dcn_bytes`` = hosts x one model's wire
    bytes under the codec, every round, equal to the JAX carry's; a 1D
    mesh's carry has no such row."""
    p0, _ = worker.init("mlp")
    per_model = compression.wire_bytes_per_model(
        {path: torch.from_numpy(a) for path, a in tree_items(p0)}, compression.QUANT8)
    for r in world:
        row = r["h_quant8"]["telemetry"]["dcn_bytes"]
        np.testing.assert_array_equal(row, np.full(2, 2.0 * per_model, np.float32))
        assert "dcn_bytes" not in r["mlp_tele"]["telemetry"]
    np.testing.assert_array_equal(world[0]["h_quant8"]["telemetry"]["dcn_bytes"],
                                  _jax_case("h_quant8")["telemetry"]["dcn_bytes"])


def test_telemetry_carry_matches_jax(world):
    """Each rank's carry holds its own node rows (2 of the 8 padded) and
    the global round rows; together they are the JAX carry. The carry is
    read-only: the params are the bytes of the run without it."""
    want = _jax_case("mlp_tele")["telemetry"]
    for rank, r in enumerate(world):
        got = r["mlp_tele"]["telemetry"]
        assert got.keys() == want.keys()
        for k, w in want.items():
            w = w[:, 2 * rank:2 * rank + 2] if w.ndim == 2 else w
            np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=ATOL, err_msg=k)
        assert r["mlp_tele"]["digest"] == r["mlp_fedavg"]["digest"]


# ---- determinism, ranks, layout ----------------------------------------------------


def test_every_rank_holds_the_same_whole_results(world):
    for name in worker.CASES:
        for r in world[1:]:
            assert r[name]["digest"] == world[0][name]["digest"], name
            _close(r[name]["params"], world[0][name]["params"], name, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["mlp_fedavg", "h_fedavg", "lm_fedavg"])
def test_same_seed_same_topology_byte_identical(world, name):
    for r in world:
        assert r[name + "_again"] == r[name]["digest"]


def test_model_axis_one_is_byte_identical_to_1d(world):
    """A ``nodes 4 x model 1`` mesh runs the 1D window: the same bytes
    (the counterpart of the reference's HLO pin,
    ``tests/test_engine.py:513``)."""
    assert world[0]["mlp_model1"]["digest"] == world[0]["mlp_fedavg"]["digest"]


def test_per_rank_param_bytes_fall_under_the_model_axis(world):
    """On ``nodes 2 x model 2`` a rank holds its 3 of the 6 node rows and
    about half of each row's leaves (the layout's; LayerNorms and some
    biases ride replicated): well past the node axis' 2x."""
    for r in world:
        got = r["lm_fedavg"]
        assert got["global_bytes"] / got["local_bytes"] > 2 * 1.5
        assert r["mlp_fedavg"]["global_bytes"] / r["mlp_fedavg"]["local_bytes"] == 4


def test_placement_helpers_equal_jax(world):
    """``node_shard_dims``, ``node_shard_size``, ``padded_node_count`` on
    each mesh and ``stacked_model_shardings``' specs over the
    TransformerLM's leaves, exactly the JAX functions'."""
    import jax

    from tpfl.parallel.mesh import node_shard_dims, node_shard_size, padded_node_count
    from tpfl.parallel.mesh import stacked_model_shardings, transformer_layout

    got = world[0]["helpers"]
    for name in worker.MESHES:
        mesh = _jax_mesh(name)
        assert got[name]["dims"] == node_shard_dims(mesh), name
        assert got[name]["size"] == node_shard_size(mesh), name
        assert got[name]["padded"] == [padded_node_count(k, mesh) for k in (1, 4, 5, 6, 8, 9)]
    p0, _ = worker.init("lm")
    stacked = jax.tree_util.tree_map(lambda a: np.zeros((4, *a.shape), a.dtype), p0)
    specs = stacked_model_shardings(_jax_mesh("model2"), stacked, transformer_layout())
    assert got["lm_specs"] == {path: tuple(s.spec) for path, s in tree_items(specs)}


def test_auto_mesh_resolves_the_shard_knobs(world):
    """``SHARD_NODES`` over 4 ranks: ``nodes 4``; ``SHARD_DEVICES`` 2 a
    mesh over ranks 0-1 (the others are outside it); ``SHARD_MODEL`` 2
    and ``SHARD_HOSTS`` 2 the 2D and 3D meshes, hosts first; a
    non-dividing knob raises naming it; ``SHARD_HOSTS`` 0 is one slot a
    process, and the port runs one process a device. Off: no mesh. The
    shapes equal the JAX ``auto_mesh``'s over 4 devices where the
    process model agrees."""
    from tpfl.parallel.engine import auto_mesh
    from tpfl.settings import Settings

    for rank, r in enumerate(world):
        got = r["auto"]
        assert got["default"] == {"nodes": 4} and got["model2"] == {"nodes": 2, "model": 2}
        assert got["hosts2"] == {"hosts": 2, "nodes": 2}
        assert got["hosts0"] == {"hosts": 4, "nodes": 1}
        assert got["devices2"] == {"nodes": 2} and got["devices2_in_mesh"] == (rank < 2)
        assert got["model3"].startswith("ValueError: SHARD_MODEL=3")
        assert "SHARD_HOSTS=3" in got["hosts3"] and got["off"] is None
    snap = Settings.snapshot()
    try:
        Settings.SHARD_NODES, Settings.SHARD_DEVICES = True, 4
        for name, knobs in (("default", {}), ("model2", {"SHARD_MODEL": 2}),
                            ("hosts2", {"SHARD_HOSTS": 2})):
            Settings.SHARD_MODEL, Settings.SHARD_HOSTS = 1, 1
            for k, v in knobs.items():
                setattr(Settings, k, v)
            mesh = auto_mesh()
            assert dict(zip(mesh.axis_names, mesh.devices.shape)) == world[0]["auto"][name]
    finally:
        Settings.restore(snap)


# ---- checkpoints and the window pipeline ---------------------------------------------


def test_checkpoint_world1_restores_at_world4_and_back(world):
    """An ``EngineCheckpointer`` snapshot of a one-device engine resumes
    on the 4-rank mesh, and a mesh snapshot resumes on one device: each
    allclose to running on where it was (``tests/test_checkpoint.py:210,
    235``); the schedule position rides the snapshot."""
    for r in world:
        ck = r["checkpoints"]
        _close(ck["to_world4"], ck["stay_world1"], "1 -> 4", rtol=RTOL, atol=ATOL)
        _close(ck["to_world1"], ck["stay_world4"], "4 -> 1", rtol=RTOL, atol=ATOL)
        assert ck["rounds_done"] == 2


def test_slice_checkpointer_round_trip_and_world1_restore(world, workdir):
    """The placed state saved by 4 ranks and restored onto a fresh
    placement runs on to the bytes of running on; restored here, in one
    process with no world, it is the whole state."""
    from tpfl_torch.management.checkpoint import SliceCheckpointer

    for r in world:
        ck = r["checkpoints"]
        assert ck["slice_resumed"] == ck["slice_uninterrupted"]
        assert ck["slice_rounds_done"] == 1 and ck["slice_latest"] == 1
    back = SliceCheckpointer(str(workdir / "slice")).restore(1)
    assert back["rounds_done"] == 1
    got = {path: t.numpy() for path, t in tree_items(back["params"])}
    _close(got, world[0]["checkpoints"]["slice_saved"], "slice", rtol=0, atol=0)


def test_window_pipeline_on_the_mesh_is_byte_identical_to_sequential(world):
    """``WindowPipeline`` (4 SCAFFOLD rounds in windows of 2) on the 1D
    mesh gives the sequential driver's bytes (``tests/test_engine_async.py:95``)."""
    for r in world:
        assert r["pipeline"]["pipeline"] == r["pipeline"]["sequential"]


def test_membership_capacity_tiers_on_the_mesh(world):
    """A membership view's tier pads like any node count (to the node
    shards): 6 live of capacity 8 give the exact 6-node engine's bytes on
    the same mesh (``tests/test_elastic.py``); a join past the tier
    promotes it to 16, the placed state is gathered and re-placed, and
    each rank holds 4 of the 16 rows."""
    for r in world:
        got = r["membership"]
        assert got["capacity"] == 8 and got["padded"] == 8
        assert got["masked"] == got["exact"]
        assert got["moved"] and got["capacity_after"] == 16 and got["padded_after"] == 16
        assert got["local_rows_after"] == 4
        assert np.isfinite(got["losses_after"]).all()


def test_engine_obs_publishes_the_dcn_series_of_the_carry(world):
    """The 4 ranks' carries of the 3D codec window, node rows joined in
    rank order, replay through the port's ``engine_obs`` into the DCN
    gauge and counter (``tpfl_engine_dcn_bytes{,_total}``) the JAX
    package's ``engine_obs`` publishes from the JAX carry
    (``tests/test_crosshost.py:193``)."""
    from tpfl.management import engine_obs as jax_engine_obs
    from tpfl.management.telemetry import metrics as jax_metrics
    from tpfl_torch.management import engine_obs
    from tpfl_torch.management.telemetry import metrics

    carries = [r["h_quant8"]["telemetry"] for r in world]
    joined = {k: (np.concatenate([c[k] for c in carries], axis=1) if v.ndim == 2 else v)
              for k, v in carries[0].items()}
    want = _jax_case("h_quant8")["telemetry"]
    for k, v in want.items():
        np.testing.assert_allclose(joined[k], v, rtol=RTOL, atol=ATOL, err_msg=k)
    model = "mesh-dcn-parity"
    w = np.asarray(worker.W8, np.float32)
    for obs, carry in ((engine_obs, joined), (jax_engine_obs, want)):
        obs.replay_window("engine:" + model, model, 0, carry, 8, weights=w)
    jax_folded = jax_metrics.fold()
    for kind, name in (("gauges", "tpfl_engine_dcn_bytes"),
                       ("counters", "tpfl_engine_dcn_bytes_total")):
        got = metrics.value(name, {"model": model})
        assert got > 0 and got == jax_folded[kind][(name, (("model", model),))], name


def _jax_donation_report(name):
    """The JAX engine's donation report of a worker case on the same mesh
    shape, from the same inputs."""
    import jax
    import jax.numpy as jnp

    from tpfl.parallel.engine import FederationEngine

    kind, n, mesh_name, algorithm, lr, w, rounds, _ = worker.CASES[name]
    eng = FederationEngine(_jax_module(kind), n, mesh=_jax_mesh(mesh_name), seed=0,
                           algorithm=algorithm, learning_rate=lr)
    p0, _ = worker.init(kind)
    params = eng._shard_state(eng.broadcast_params(jax.tree_util.tree_map(jnp.asarray, p0)))
    ss = eng.init_scaffold_state(params) if algorithm == "scaffold" else None
    dx, dy = eng.shard_data(*worker.data(kind, n))
    return eng.donation_report(params, dx, dy, weights=w, n_rounds=rounds, scaffold_state=ss)


@pytest.mark.parametrize("name", worker.DONATION_CASES)
def test_donation_report_clean_on_the_mesh(world, name):
    """World 4 on gloo: the 1D ``nodes`` window, the 3D SCAFFOLD window and
    the 2D ``nodes 2 x model 2`` TransformerLM window (the counterpart of
    ``tests/test_engine.py:440-452``) donate every state leaf: each rank's
    report is clean and equals the JAX engine's on the same mesh shape;
    the report leaves the caller's placed params as they were; a donating
    window writes each rank's local blocks in place and ends on the
    non-donating window's bytes."""
    want = _jax_donation_report(name)
    assert want["clean"], want
    for rank in world:
        got = rank["donation"][name]
        assert got["report"] == want, (rank["rank"], got["report"])
        assert got["caller_intact"] and got["in_place"] and got["bytes_equal"], got
