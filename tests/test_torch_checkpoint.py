"""The port's checkpoints (``tpfl_torch.management.checkpoint``, the
engine's ``export_state`` / ``import_state``, ``Node.save_checkpoint`` /
``load_checkpoint``) against the JAX package's, on the CPU — the cases of
``tests/test_checkpoint.py`` that exist in the port:

- bytes: ``_msgpack.packb_ext`` equals ``flax.serialization.msgpack_serialize``
  on host trees (arrays of every dtype the state holds, bf16 included,
  numpy and Python scalars, nested dicts and lists), and
  ``unpackb_ext`` restores what ``msgpack_restore`` does; the port's
  ``EngineCheckpointer`` payload equals flax's for the same engine state;
- a checkpoint written by the JAX engine restores into the port's engine
  and continues allclose (rtol 1e-4, atol 1e-5) to the JAX package's
  uninterrupted run, for the tiers' MLP and a narrow f32 CNN through
  ``conv_impl="pallas"``; node checkpoints cross between the packages
  both ways;
- in the port: kill-and-resume byte-identical to the uninterrupted run,
  sync and FedBuff (the schedule resumes at ``rounds_done``), in memory
  and through the checkpointer on disk; controller, membership and
  quarantine state carried; the checkpointed seed wins;
- publication: the ``LATEST`` pointer, a crash mid-write, the SIGTERM
  hook (and its no-op for a ``None`` state), ``STATE_CONTRACTS``
  blocking publication and naming the field.

The reference's ``SliceCheckpointer`` (orbax) has its counterpart over
``torch.distributed.checkpoint``; its cross-mesh restore is held in
``tests/test_torch_engine_mesh.py``.
"""

import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as flax_ser

from tpfl.learning.async_control import AsyncController as JaxController
from tpfl.management import checkpoint as jax_checkpoint
from tpfl.management.quarantine import QuarantineEngine as JaxQuarantine
from tpfl.models import CNN as JaxCNN
from tpfl.models import MLP as JaxMLP
from tpfl.models import create_model as jax_create_model
from tpfl.parallel import FederationEngine as JaxEngine
from tpfl.parallel import FedBuffSchedule as JaxSchedule
from tpfl.parallel.membership import MembershipView as JaxView
from tpfl.settings import Settings as JaxSettings
from tpfl_torch.interop import model_state_from_jax, params_from_flax, params_to_numpy
from tpfl_torch.learning import _msgpack
from tpfl_torch.learning.async_control import AsyncController
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.management import checkpoint
from tpfl_torch.management.checkpoint import (
    EngineCheckpointer,
    StateContractError,
    _shadow_verify,
    install_sigterm_checkpoint,
    load_node_checkpoint,
    save_node_checkpoint,
)
from tpfl_torch.management.quarantine import QuarantineEngine
from tpfl_torch.models import CNN, MLP
from tpfl_torch.parallel import FedBuffSchedule, FederationEngine, MembershipView
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import canonical_leaves, tree_items, tree_map

RTOL, ATOL = 1e-4, 1e-5

MODELS = {
    "mlp": (lambda: JaxMLP(hidden_sizes=(64,), compute_dtype=jnp.float32),
            lambda: MLP(hidden_sizes=(64,), compute_dtype=torch.float32), (28, 28)),
    "cnn": (lambda: JaxCNN(channels=(4, 8), dense=16, out_channels=10,
                           compute_dtype=jnp.float32, conv_impl="pallas"),
            lambda: CNN(channels=(4, 8), dense=16, out_channels=10,
                        compute_dtype=torch.float32, conv_impl="pallas"), (8, 8, 3)),
}

CONTROLLER = {"ia_q": 0.25, "tau_mean": 1.25, "k": 3, "deadline": 2.0,
              "last_reason": "deadline", "last_arrivals": 2, "last_fill_frac": 0.5,
              "trajectory": [{"round": 0, "k": 3, "deadline": 2.0}]}
QUARANTINE = {"state": {"peerX": {"active": True, "since_round": 1, "last_flag_round": 2,
                                  "reasons": ["norm"], "readmissions": 0}},
              "actions": [{"peer": "peerX", "round": 1, "action": "quarantine",
                           "reasons": ["norm"]}],
              "last": {"peerX": [2, {"exclude": True}]}}


@pytest.fixture(autouse=True)
def _settings():
    snaps = Settings.snapshot(), JaxSettings.snapshot()
    Settings.set_test_settings()
    yield
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])


def _data(n, shape=(28, 28), nb=2, bs=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, nb, bs, *shape)).astype(np.float32),
            rng.integers(0, 10, (n, nb, bs)).astype(np.int32))


def _port_engine(n=4, model="mlp", seed=0):
    return FederationEngine(MODELS[model][1](), n, seed=seed, device="cpu")


def _jax_engine(n=4, model="mlp"):
    return JaxEngine(MODELS[model][0](), n, seed=0)


def _start(n=4, model="mlp"):
    """(JAX engine, its params, the same params in the port)."""
    jeng = _jax_engine(n, model)
    jp = jeng.init_params(MODELS[model][2])
    return jeng, jp, params_from_flax(jax.tree_util.tree_map(np.array, dict(jp)), device="cpu")


def _bytes(tree):
    return b"".join(t.contiguous().numpy().tobytes() for t in canonical_leaves(tree))


def _assert_close(port_params, jax_params):
    got = params_to_numpy(port_params)
    want = jax.tree_util.tree_map(np.array, dict(jax_params))
    for layer in want:
        for leaf in want[layer]:
            np.testing.assert_allclose(got[layer][leaf], want[layer][leaf], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{layer}/{leaf}")


# --- the byte format ----------------------------------------------------------


def _trees():
    base = {
        "b": np.arange(6, dtype=np.float32).reshape(2, 3), "a": 1, "neg": -2 ** 40,
        "f64": np.float64(2.5), "py": 2.5, "none": None, "list": [1, "x", {"q": 1, "p": [2]}],
        "nested": {"z": True, "y": np.int64(3), "e": {}}, "empty": np.zeros((0, 4), np.float32),
        "ints": np.arange(300, dtype=np.int32), "u8": np.arange(5, dtype=np.uint8),
        "bools": np.asarray([True, False]), "big": np.ones((70, 40), np.float32),
        "s": "x" * 40, "b16": np.float16(1.5),
    }
    return base


def test_packb_ext_is_flax_msgpack_serialize():
    tree = _trees()
    port = dict(tree, bf=torch.arange(6, dtype=torch.float32).reshape(2, 3).to(torch.bfloat16))
    ref = dict(tree, bf=jnp.arange(6, dtype=jnp.float32).reshape(2, 3).astype(jnp.bfloat16))
    assert _msgpack.packb_ext(port) == flax_ser.msgpack_serialize(ref)
    back = _msgpack.unpackb_ext(flax_ser.msgpack_serialize(ref))
    want = flax_ser.msgpack_restore(flax_ser.msgpack_serialize(ref))
    assert back["bf"].dtype == torch.bfloat16
    assert torch.equal(back["bf"].float(), torch.arange(6, dtype=torch.float32).reshape(2, 3))
    assert list(back) == list(want)
    for k in tree:
        if isinstance(want[k], np.ndarray):
            assert back[k].dtype == want[k].dtype and np.array_equal(back[k], want[k]), k
        else:
            assert back[k] == want[k] and type(back[k]) is type(want[k]), k
    assert _msgpack.packb_ext(back) == flax_ser.msgpack_serialize(want)


def test_packb_ext_refusals_match_flax():
    with pytest.raises(TypeError, match="tuple"):
        _msgpack.packb_ext({"t": (1, 2)})
    with pytest.raises(TypeError, match="tuple"):
        flax_ser.msgpack_serialize({"t": (1, 2)})
    with pytest.raises(ValueError, match="int map key"):
        _msgpack.unpackb_ext(_msgpack.packb({1: 2}))
    with pytest.raises(ValueError):
        _msgpack.unpackb(flax_ser.msgpack_serialize({"a": np.zeros(2)}))
    with pytest.raises(TypeError):
        _msgpack.packb({"a": np.zeros(2)})


def test_packb_ext_refuses_a_leaf_flax_would_chunk(monkeypatch):
    monkeypatch.setattr(_msgpack, "MAX_LEAF_BYTES", 64)
    _msgpack.packb_ext({"ok": np.zeros(16, np.float32)})
    with pytest.raises(ValueError, match="chunks"):
        _msgpack.packb_ext({"w": np.zeros(17, np.float32)})


def test_engine_checkpointer_payload_equals_flax(tmp_path):
    """The same engine state — params, schedule position, controller,
    membership, quarantine — serializes to the same bytes in both
    packages."""
    jeng, jp, tp = _start(4)
    teng = _port_engine(4)
    for eng, ctl, view, q in ((teng, AsyncController("a"), MembershipView, QuarantineEngine),
                              (jeng, JaxController("a"), JaxView, JaxQuarantine)):
        ctl.state_import(CONTROLLER)
        eng.controller = ctl
        eng.attach_membership(view([f"n{i}" for i in range(4)]))
        eng._rounds_done = 5
    q, jq = QuarantineEngine("a"), JaxQuarantine("a")
    q.state_import(QUARANTINE)
    jq.state_import(QUARANTINE)
    state, jstate = teng.export_state(tp, quarantine=q), jeng.export_state(jp, quarantine=jq)
    assert list(state) == list(jstate)
    EngineCheckpointer(str(tmp_path / "port")).save(state, step=5)
    jax_checkpoint.EngineCheckpointer(str(tmp_path / "jax")).save(jstate, step=5)

    def payload(d):
        return (d / (d / "LATEST").read_text().strip() / "engine.tpfl").read_bytes()

    assert payload(tmp_path / "port") == payload(tmp_path / "jax") == \
        flax_ser.msgpack_serialize(jstate)


# --- node tier ------------------------------------------------------------------


def _jax_model(seed=7):
    return jax_create_model("mlp", (28, 28), seed=seed, hidden_sizes=(8,))


def _port_model(seed=7):
    return TpflModel(MLP(hidden_sizes=(8,), out_channels=10, compute_dtype=torch.float32),
                     **model_state_from_jax(_jax_model(seed), device="cpu"))


def _params_equal(a, b):
    got = dict(tree_items(b))
    return all(np.array_equal(np.asarray(v), np.asarray(got[k])) for k, v in tree_items(a))


def test_node_checkpoint_round_trip(tmp_path):
    model = _port_model()
    save_node_checkpoint(str(tmp_path), model, round=3, exp_name="exp0")
    loaded, meta = load_node_checkpoint(str(tmp_path), _port_model(seed=99))
    assert meta["round"] == 3 and meta["exp_name"] == "exp0"
    assert _params_equal(model.get_parameters(), loaded.get_parameters())


def test_node_checkpoints_cross_between_packages(tmp_path):
    """A JAX-written node checkpoint loads into the port's model, and a
    port-written one into the JAX package's, with the same bytes."""
    jmodel, model = _jax_model(seed=1), _port_model(seed=2)
    jax_checkpoint.save_node_checkpoint(str(tmp_path / "j"), jmodel, round=4, exp_name="e")
    save_node_checkpoint(str(tmp_path / "t"), model, round=5, exp_name="e")
    loaded, meta = load_node_checkpoint(str(tmp_path / "j"), _port_model(seed=9))
    assert meta["round"] == 4
    want = jax.tree_util.tree_map(np.array, dict(jmodel.get_parameters()))
    assert _params_equal(want, {k: {kk: v.numpy() for kk, v in d.items()}
                                for k, d in loaded.get_parameters().items()})
    jloaded, jmeta = jax_checkpoint.load_node_checkpoint(str(tmp_path / "t"), _jax_model(seed=9))
    assert jmeta["round"] == 5
    got = jax.tree_util.tree_map(np.array, dict(jloaded.get_parameters()))
    assert _params_equal({k: {kk: v.numpy() for kk, v in d.items()}
                          for k, d in model.get_parameters().items()}, got)
    model_bytes = [(p / (p / "LATEST").read_text().strip() / "model.tpfl").read_bytes()
                   for p in (tmp_path / "t",)]
    jax_checkpoint.save_node_checkpoint(str(tmp_path / "j2"), _jax_model(seed=2), round=5,
                                        exp_name="e")
    p = tmp_path / "j2"
    assert model_bytes[0] == (p / (p / "LATEST").read_text().strip() / "model.tpfl").read_bytes()


def test_node_checkpoint_atomic_pointer_publish(tmp_path):
    m1, m2 = _port_model(seed=1), _port_model(seed=2)
    save_node_checkpoint(str(tmp_path), m1, round=1)
    first = (tmp_path / "LATEST").read_text().strip()
    save_node_checkpoint(str(tmp_path), m2, round=2)
    second = (tmp_path / "LATEST").read_text().strip()
    assert first != second
    assert (tmp_path / second / "model.tpfl").exists() and (tmp_path / second / "meta.json").exists()
    loaded, meta = load_node_checkpoint(str(tmp_path), _port_model(seed=99))
    assert meta["round"] == 2 and _params_equal(m2.get_parameters(), loaded.get_parameters())


def test_node_checkpoint_crash_mid_write_recovery(tmp_path):
    save_node_checkpoint(str(tmp_path), _port_model(), round=1)
    published = (tmp_path / "LATEST").read_text().strip()
    orphan = tmp_path / "ckpt_deadbeef"
    orphan.mkdir()
    (orphan / "model.tpfl").write_bytes(b"torn half-write")
    _, meta = load_node_checkpoint(str(tmp_path), _port_model(seed=99))
    assert meta["round"] == 1
    old = orphan.stat().st_mtime - 3600
    os.utime(orphan, (old, old))
    checkpoint._sweep_unpublished(str(tmp_path), keep=published)
    assert not orphan.exists() and (tmp_path / published).exists()


def test_node_checkpoint_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_node_checkpoint(str(tmp_path), _port_model())


# --- engine tier: the checkpointer --------------------------------------------


def test_engine_checkpointer_round_trip(tmp_path):
    state = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}, "n_nodes": 2,
             "rounds_done": 7, "windows": 3, "seed": 0,
             "controller": {"tau_mean": 1.5, "trajectory": [{"round": 1, "k": 2}]}}
    ck = EngineCheckpointer(str(tmp_path), node="engine-test")
    assert ck.restore() is None and ck.latest_step() is None
    sub = ck.save(state, step=7, extra={"tag": "t"})
    assert (tmp_path / sub / "engine.tpfl").exists()
    restored, meta = ck.restore()
    assert meta == {"step": 7, "node": "engine-test", "tag": "t"} and ck.latest_step() == 7
    assert restored["rounds_done"] == 7
    assert np.array_equal(restored["params"]["w"], state["params"]["w"])
    assert float(restored["controller"]["tau_mean"]) == 1.5
    jrestored, _ = jax_checkpoint.EngineCheckpointer(str(tmp_path)).restore()
    assert np.array_equal(jrestored["params"]["w"], state["params"]["w"])


def test_engine_checkpointer_publish_is_atomic(tmp_path):
    ck = EngineCheckpointer(str(tmp_path))
    ck.save({"params": {}, "rounds_done": 1}, step=1)
    first = (tmp_path / "LATEST").read_text().strip()
    ck.save({"params": {}, "rounds_done": 2}, step=2)
    assert (tmp_path / "LATEST").read_text().strip() != first
    restored, meta = ck.restore()
    assert restored["rounds_done"] == 2 and meta["step"] == 2
    (tmp_path / "LATEST.tmp").write_text("ckpt_bogus")
    assert ck.restore()[1]["step"] == 2


def test_sigterm_checkpoint_handler(tmp_path):
    ck = EngineCheckpointer(str(tmp_path), node="n0")
    chained = threading.Event()

    def prev_handler(signum, frame):
        chained.set()

    old = signal.signal(signal.SIGTERM, prev_handler)
    try:
        snap = {"params": {"w": np.zeros((2,), np.float32)}, "rounds_done": 4}
        prev = install_sigterm_checkpoint(ck, lambda: snap, node="n0")
        os.kill(os.getpid(), signal.SIGTERM)
        assert chained.wait(timeout=5.0)
        restored, meta = ck.restore()
        assert meta["reason"] == "sigterm" and meta["step"] == 4
        assert restored["rounds_done"] == 4
        signal.signal(signal.SIGTERM, prev)
        assert signal.getsignal(signal.SIGTERM) is prev_handler
    finally:
        signal.signal(signal.SIGTERM, old)


def test_sigterm_checkpoint_none_state_is_noop(tmp_path):
    ck = EngineCheckpointer(str(tmp_path))
    old = signal.signal(signal.SIGTERM, lambda s, f: None)
    try:
        prev = install_sigterm_checkpoint(ck, lambda: None)
        os.kill(os.getpid(), signal.SIGTERM)
        assert ck.restore() is None
        signal.signal(signal.SIGTERM, prev)
    finally:
        signal.signal(signal.SIGTERM, old)


# --- engine state: kill and resume -----------------------------------------------


@pytest.mark.parametrize("fedbuff", [False, True])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_engine_state_resume_byte_identical(tmp_path, model, fedbuff):
    """3 rounds, export, the checkpointer through disk, import on a fresh
    engine, 3 more rounds: the bytes of 6 uninterrupted rounds. A FedBuff
    run resumes its schedule at ``rounds_done``."""
    n = 4
    _, _, tp = _start(n, model)
    xs, ys = _data(n, MODELS[model][2])
    sched = FedBuffSchedule.from_periods([1, 2, 1, 3], 6) if fedbuff else None

    def window(eng, p, start, k):
        sub = None if sched is None else sched.window(start, k)
        return eng.run_rounds(p, xs, ys, n_rounds=k, schedule=sub)[0]

    full = window(_port_engine(n, model), tree_map(torch.clone, tp), 0, 6)  # tp runs again
    eng_b = _port_engine(n, model)
    pb = window(eng_b, tp, 0, 3)
    ck = EngineCheckpointer(str(tmp_path))
    ck.save(eng_b.export_state(pb), step=3)
    state, meta = ck.restore()
    eng_c = _port_engine(n, model)
    out = eng_c.import_state(state)
    assert meta["step"] == 3 and eng_c._rounds_done == 3
    resumed = window(eng_c, out["params"], eng_c._rounds_done, 3)
    assert _bytes(resumed) == _bytes(full)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_jax_checkpoint_resumes_in_port(tmp_path, model):
    """A checkpoint the JAX engine wrote after 2 fedbuff rounds restores
    into the port's engine, whose next 2 rounds end allclose to the JAX
    engine's 4 uninterrupted ones."""
    _set = dict(ASYNC_STALENESS_EXP=0.5)
    for s in (Settings, JaxSettings):
        for k, v in _set.items():
            setattr(s, k, v)
    n = 4
    jeng, jp, _ = _start(n, model)
    xs, ys = _data(n, MODELS[model][2])
    jx, jy = jeng.shard_data(xs, ys)
    jsched = JaxSchedule.from_periods([1, 2, 1, 3], 4)
    jfull, _ = jeng.run_rounds(jp, jx, jy, n_rounds=4, schedule=jsched, donate=False)
    jeng_b = _jax_engine(n, model)
    jpb, _ = jeng_b.run_rounds(jp, jx, jy, n_rounds=2, schedule=jsched.window(0, 2),
                               donate=False)
    jax_checkpoint.EngineCheckpointer(str(tmp_path)).save(jeng_b.export_state(jpb), step=2)
    state, meta = EngineCheckpointer(str(tmp_path)).restore()
    teng = _port_engine(n, model, seed=5)
    out = teng.import_state(state)
    assert teng._rounds_done == 2 and teng.seed == 0 and meta["step"] == 2
    sched = FedBuffSchedule.from_periods([1, 2, 1, 3], 4).window(teng._rounds_done, 2)
    resumed, _ = teng.run_rounds(out["params"], xs, ys, n_rounds=2, schedule=sched)
    _assert_close(resumed, jfull)


def test_engine_state_carries_controller_and_quarantine():
    teng = _port_engine(2)
    tp = teng.init_params((28, 28))
    ctl = AsyncController("nodeA")
    ctl.state_import(CONTROLLER)
    teng.controller = ctl
    q = QuarantineEngine("nodeA")
    q.state_import(QUARANTINE)
    state = teng.export_state(tp, quarantine=q)
    assert state["controller"]["tau_mean"] == 1.25
    assert state["quarantine"]["state"]["peerX"]["active"]
    eng2 = _port_engine(2)
    ctl2, q2 = AsyncController("nodeB"), QuarantineEngine("nodeB")
    eng2.controller = ctl2
    eng2.import_state(state, quarantine=q2)
    exp = ctl2.state_export()
    assert exp["tau_mean"] == 1.25 and exp["k"] == 3
    assert exp["trajectory"] == [{"round": 0, "k": 3, "deadline": 2.0}]
    assert q2.quarantined() == {"peerX"}
    assert q2.state_export()["last"]["peerX"] == [2, {"exclude": True}]


def test_export_state_keys_and_rows_match_jax():
    """Keys and host rows of ``export_state`` equal the JAX engine's for
    the same params and attachments (a pad row or two on the port's side
    never reaches the snapshot)."""
    jeng, jp, tp = _start(3)
    teng = _port_engine(3)
    view, jview = MembershipView(["a", "b", "c"]), JaxView(["a", "b", "c"])
    teng.attach_membership(view)
    jeng.attach_membership(jview)
    tp = teng.pad_stacked(tp)
    assert teng.n_nodes == 4 and jeng.n_nodes == 4
    jp4 = jeng.pad_stacked(jp)
    c_t, c_j = teng.init_scaffold_state(tp), jeng.init_scaffold_state(jp4)
    state = teng.export_state(tp, aux={}, scaffold_state=c_t)
    jstate = jeng.export_state(jp4, aux={}, scaffold_state=c_j)
    assert list(state) == list(jstate)
    for key in ("n_nodes", "rounds_done", "windows", "seed", "membership", "aux"):
        assert state[key] == jstate[key], key
    for key in ("params", "c_locals", "c_global"):
        got = dict(tree_items(state[key]))
        for path, v in tree_items(jstate[key]):
            assert got[path].dtype == np.asarray(v).dtype and np.array_equal(got[path], v), path


def test_jax_checkpoint_with_a_population_resumes(tmp_path):
    """A JAX engine checkpoint holding a ``ClientPopulation`` (written by
    the JAX ``EngineCheckpointer``) resumes in the port: the port engine
    builds and binds a population whose records, round cursor and
    coverage equal the JAX one's, and draws the same next cohort."""
    from tpfl.parallel.population import ClientPopulation as JaxPopulation

    jeng, jp, _ = _start(4)
    jpop = JaxPopulation(registered=10_000, sample=4, seed=3)
    jeng.attach_population(jpop)
    for _ in range(3):
        ids = jpop.begin_round()
        jpop.complete_round(ids, jpop.round_weights(ids, cutoff_frac=0.25),
                            np.arange(4, dtype=np.float32))
    jax_checkpoint.EngineCheckpointer(str(tmp_path)).save(jeng.export_state(jp), step=3)
    state, _ = EngineCheckpointer(str(tmp_path)).restore()
    teng = _port_engine(4)
    out = teng.import_state(state)
    pop = teng.population
    assert pop is not None and pop._engine is teng
    assert pop.clients == jpop.clients and pop.round == jpop.round == 3
    assert pop.touched == jpop.touched and pop.coverage == jpop.coverage
    assert pop.fairness == jpop.fairness
    assert np.array_equal(pop.begin_round(), jpop.begin_round())
    assert pop.state_export() == jpop.state_export()
    _assert_close(out["params"], jp)


# --- STATE_CONTRACTS ----------------------------------------------------------------


def test_shadow_verify_names_missing_field():
    state = {"params": {"w": np.zeros((2, 3), np.float32)}, "rounds_done": 7, "seed": 3}
    _shadow_verify(state, _msgpack.packb_ext(state))
    doctored = _msgpack.packb_ext({k: v for k, v in state.items() if k != "seed"})
    with pytest.raises(StateContractError, match="'seed'"):
        _shadow_verify(state, doctored)
    with pytest.raises(StateContractError, match="'rounds_done'"):
        _shadow_verify(state, _msgpack.packb_ext({**state, "rounds_done": 8}))


def test_state_contracts_save_blocks_publication(tmp_path, monkeypatch):
    assert Settings.STATE_CONTRACTS  # the test profile arms it
    ck = EngineCheckpointer(str(tmp_path), node="sc")
    ck.save({"params": {}, "rounds_done": 1, "seed": 0}, step=1)
    assert ck.latest_step() == 1
    real = _msgpack.unpackb_ext

    def lossy(payload):
        out = real(payload)
        out.pop("seed", None)
        return out

    monkeypatch.setattr(_msgpack, "unpackb_ext", lossy)
    with pytest.raises(StateContractError, match="'seed'"):
        ck.save({"params": {}, "rounds_done": 2, "seed": 0}, step=2)
    monkeypatch.setattr(_msgpack, "unpackb_ext", real)
    restored, meta = ck.restore()
    assert meta["step"] == 1 and restored["rounds_done"] == 1


def test_state_contracts_kill_and_resume_full_attach(tmp_path):
    """With STATE_CONTRACTS on, kill-and-resume through the checkpointer
    carries controller, membership, population and quarantine; the
    checkpointed seed wins, and the resumed engine trains on."""
    from tpfl_torch.parallel import ClientPopulation

    n = 2
    xs, ys = _data(n)
    eng = _port_engine(n)
    eng.controller = AsyncController("nodeA")
    eng.controller.state_import(CONTROLLER)
    eng.attach_membership(MembershipView([f"n{i}" for i in range(n)]))
    eng.attach_population(ClientPopulation(registered=64, sample=2, seed=3))
    eng.population.complete_round(eng.population.begin_round())
    q = QuarantineEngine("nodeA")
    q.state_import(QUARANTINE)
    params, _ = eng.run_rounds(eng.init_params((28, 28)), xs, ys, n_rounds=1)
    ck = EngineCheckpointer(str(tmp_path), node="resume")
    ck.save(eng.export_state(params, quarantine=q), step=1)
    state, _ = ck.restore()
    eng2 = _port_engine(n, seed=9)
    eng2.controller = AsyncController("nodeB")
    eng2.attach_membership(MembershipView())
    eng2.attach_population(ClientPopulation(registered=64, sample=2, seed=99))
    q2 = QuarantineEngine("nodeB")
    out = eng2.import_state(state, quarantine=q2)
    assert _bytes(eng2.unpad(out["params"])) == _bytes(eng.unpad(params))
    assert eng2.seed == eng.seed
    assert eng2.controller.state_export()["k"] == eng.controller.state_export()["k"]
    assert eng2.membership.state_export() == eng.membership.state_export()
    assert eng2.population.state_export() == eng.population.state_export()
    assert q2.quarantined() == {"peerX"}
    eng2.run_rounds(out["params"], xs, ys, n_rounds=1)
