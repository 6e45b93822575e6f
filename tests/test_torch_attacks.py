"""The port's attacks (tpfl_torch.attacks) and its copy of ``jax.random``
(tpfl_torch.utils.threefry) against the JAX package and ``jax.random``,
on the CPU.

- threefry: keys, ``fold_in`` chains and uint32 bits bit-equal (odd
  sizes, more than 2¹⁶ elements); normals within 1e-6·max(1, |x|)
  (``log1p`` and the polynomial round differently in the last bits).
- ``sign_flip``, ``AttackSpec.strength`` / ``name``,
  ``AttackPlan.from_dict`` / ``engine_scales`` / ``adversary_map``:
  exact. ``poison`` and ``additive_noise``: at the normals' tolerance.
- ``AdversarialLearner`` / ``PlannedAdversary`` / ``apply_attack_plan``
  poison on schedule; the replay modes cache the first contribution; the
  parts that need the node runtime raise ``NotImplementedError``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.attacks import AttackPlan as JaxPlan
from tpfl.attacks import AttackSpec as JaxSpec
from tpfl.attacks import additive_noise as jax_additive_noise
from tpfl.attacks import sign_flip as jax_sign_flip
from tpfl.settings import Settings as JaxSettings
from tpfl_torch import attacks
from tpfl_torch.attacks import (
    AdversarialLearner,
    AttackPlan,
    AttackSpec,
    PlannedAdversary,
    additive_noise,
    apply_attack_plan,
    poison_model,
    sign_flip,
)
from tpfl_torch.communication.faults import TrainerSpeedPlan
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.settings import Settings
from tpfl_torch.utils import threefry
from tpfl_torch.utils.tree import tree_items


@pytest.fixture(autouse=True)
def both_settings():
    snap, jsnap = Settings.snapshot(), JaxSettings.snapshot()
    yield
    Settings.restore(snap)
    JaxSettings.restore(jsnap)


def _close_normals(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 1e-6 * np.maximum(1.0, np.abs(want)))


def _tree(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"Dense_1": {"kernel": rng.normal(size=(6, 3)).astype(dtype),
                        "bias": rng.normal(size=(3,)).astype(dtype)},
            "Conv_0": {"kernel": rng.normal(size=(3, 3, 2, 5)).astype(dtype),
                       "bias": rng.normal(size=(5,)).astype(dtype)}}


def _torch_tree(tree):
    return {k: {n: torch.from_numpy(v.copy()) for n, v in layer.items()}
            for k, layer in tree.items()}


def _assert_trees(got, want, exact=True):
    got = dict(tree_items(got))
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray, want)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            _close_normals(g, w)


# --- threefry ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 42, 4242, 2**31 - 1, 2**31, 2**32 + 5, -3])
def test_keys_and_fold_in_chains_bit_equal(seed):
    k = jax.random.PRNGKey(seed)
    t = threefry.PRNGKey(seed)
    assert tuple(int(v) for v in np.asarray(k)) == t
    for data in (0, 7, 2**31 - 1, 123456789):
        k, t = jax.random.fold_in(k, data), threefry.fold_in(t, data)
        assert tuple(int(v) for v in np.asarray(k)) == t


@pytest.mark.parametrize("shape", [(1,), (5,), (3, 7), (65537,), (2, 3, 11, 13), (70001,)])
def test_random_bits_bit_equal(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(11), 3)
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    got = threefry.random_bits(threefry.fold_in(threefry.PRNGKey(11), 3), shape, "cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("shape", [(), (5,), (3, 3, 4, 8), (65537,)])
def test_normals_within_tolerance(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(5), 9)
    want = np.asarray(jax.random.normal(key, shape, jnp.float32))
    got = threefry.normal(threefry.fold_in(threefry.PRNGKey(5), 9), shape, "cpu")
    assert got.dtype == torch.float32
    _close_normals(got.numpy(), want)


def test_erfinv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999], dtype=torch.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    got = threefry.erfinv(x).numpy()
    np.testing.assert_array_equal(got[:3], want[:3])
    np.testing.assert_allclose(got[3:], want[3:], rtol=1e-6)


# --- attacks ---------------------------------------------------------------------


def test_sign_flip_exact():
    tree = _tree()
    _assert_trees(sign_flip()(_torch_tree(tree)), jax_sign_flip()(tree))
    assert sign_flip().name == jax_sign_flip().name == "sign_flip"


@pytest.mark.parametrize("std,seed", [(0.1, 0), (0.5, 7)])
def test_additive_noise_counter_chain(std, seed):
    tree = _tree(1)
    t_attack, j_attack = additive_noise(std, seed), jax_additive_noise(std, seed)
    assert t_attack.name == j_attack.name
    t, j = _torch_tree(tree), tree
    for _ in range(3):  # the application counter advances the key
        t, j = t_attack(t), j_attack(j)
        _assert_trees(t, j, exact=False)


def test_additive_noise_keeps_bf16():
    tree = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    out = additive_noise(0.1, 0)(tree)
    assert out["w"].dtype == torch.bfloat16
    want = jax_additive_noise(0.1, 0)({"w": jnp.ones((4, 4), jnp.bfloat16)})
    np.testing.assert_array_equal(out["w"].float().numpy(), np.asarray(want["w"], np.float32))


def test_poison_model():
    tree = _tree(2)
    m = TpflModel(params=_torch_tree(tree), device="cpu")
    poison_model(m, sign_flip())
    _assert_trees(m.get_parameters(), jax_sign_flip()(tree))


@pytest.mark.parametrize("spec", [
    dict(attack="sign_flip"), dict(attack="sign_flip", mode="once", start=2),
    dict(attack="additive_noise", mode="ramp", start=1, ramp_rounds=3, end=6),
    dict(attack="additive_noise", std=0.3, start=1, end=3),
    dict(attack="stale_flood"), dict(attack="withhold_replay", start=2, end=5),
])
def test_attack_spec_strength_and_name(spec):
    t, j = AttackSpec(**spec), JaxSpec(**spec)
    assert [t.strength(r) for r in range(8)] == [j.strength(r) for r in range(8)]
    Settings.ATTACK_NOISE_STD = JaxSettings.ATTACK_NOISE_STD = 0.25
    assert t.name == j.name


def test_attack_spec_rejects_unknowns():
    with pytest.raises(ValueError, match="attack"):
        AttackSpec(attack="nope")
    with pytest.raises(ValueError, match="mode"):
        AttackSpec(mode="sometimes")


PLAN = {"seed": 7, "peers": {
    "node-3": {"attack": "sign_flip"},
    "node-6": {"attack": "additive_noise", "std": 0.1, "mode": "ramp", "start": 2,
               "ramp_rounds": 3},
    "1": {"attack": "sign_flip", "mode": "once", "start": 0},
    4: {"attack": "sign_flip", "mode": "ramp", "ramp_rounds": 4, "start": 1}}}


def test_plan_from_dict_adversary_map_and_seed():
    t, j = AttackPlan.from_dict(PLAN), JaxPlan.from_dict(PLAN)
    addrs = [f"node-{i}" for i in range(8)]
    assert t.adversary_map(addrs) == j.adversary_map(addrs)
    assert t.adversary_map() == j.adversary_map()
    assert t.seed == j.seed == 7
    Settings.SEED = JaxSettings.SEED = 13
    assert AttackPlan().seed == JaxPlan().seed == 13
    assert t.spec_for("x", 1) == AttackSpec(**PLAN["peers"]["1"])


def test_plan_engine_scales_exact():
    peers = {k: v for k, v in PLAN["peers"].items() if v["attack"] == "sign_flip"}
    t, j = AttackPlan.from_dict({"peers": peers}), JaxPlan.from_dict({"peers": peers})
    addrs = [f"node-{i}" for i in range(6)]
    for start in (0, 2):
        got, want = t.engine_scales(addrs, 5, start), j.engine_scales(addrs, 5, start)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="sign_flip"):
        AttackPlan.from_dict(PLAN).engine_scales([f"node-{i}" for i in range(8)], 2)


@pytest.mark.parametrize("peer,rnd", [("node-3", 0), ("node-3", 4), ("node-6", 2),
                                      ("node-6", 3), ("node-6", 9), ("node-4", 2),
                                      ("node-0", 0)])
def test_plan_poison(peer, rnd):
    plan = {**PLAN, "peers": {**PLAN["peers"], "node-4": PLAN["peers"][4]}}
    t, j = AttackPlan.from_dict(plan), JaxPlan.from_dict(plan)
    tree = _tree(3)
    ts, js = t.spec_for(peer), j.spec_for(peer)
    if ts is None:
        ts = js = AttackSpec("additive_noise", std=0.2)
        js = JaxSpec("additive_noise", std=0.2)
    got = t.poison(peer, rnd, ts, _torch_tree(tree))
    want = j.poison(peer, rnd, js, tree)
    _assert_trees(got, want, exact=ts.attack == "sign_flip")


class _Learner:
    """A stand-in learner: each fit returns a fresh model of ``value``."""

    def __init__(self, addr, value=1.0):
        self.addr, self.value, self.fits = addr, value, 0

    def fit(self):
        self.fits += 1
        return TpflModel(params={"w": torch.full((2, 2), self.value)}, contributors=[self.addr],
                         num_samples=3, device="cpu")

    def get_addr(self):
        return self.addr

    def get_model(self):
        return TpflModel(params={"w": torch.zeros(2, 2)}, device="cpu")


def test_adversarial_learner_once_and_always():
    always = AdversarialLearner(_Learner("a"), sign_flip())
    assert [float(always.fit().get_parameters()["w"][0, 0]) for _ in range(3)] == [-1.0] * 3
    once = AdversarialLearner(_Learner("b"), sign_flip(), once=True)
    assert [float(once.fit().get_parameters()["w"][0, 0]) for _ in range(3)] == [-1, 1, 1]
    assert once.get_addr() == "b" and once._last_fit_model is not None


def test_planned_adversaries_fire_on_schedule():
    class Node:
        def __init__(self, addr):
            self.addr, self.learner = addr, _Learner(addr)

    nodes = [Node(f"node-{i}") for i in range(5)]
    plan = AttackPlan.from_dict({"seed": 1, "peers": {
        "1": {"attack": "sign_flip", "mode": "once", "start": 1},
        "node-3": {"attack": "sign_flip", "mode": "ramp", "ramp_rounds": 2},
        "node-4": {"attack": "stale_flood", "start": 1}}})
    truth = apply_attack_plan(nodes, plan)
    assert truth == plan.adversary_map([n.addr for n in nodes]) == {
        "node-1": "sign_flip", "node-3": "sign_flip", "node-4": "stale_flood"}
    assert isinstance(nodes[1].learner, PlannedAdversary) and isinstance(nodes[0].learner, _Learner)
    vals = {i: [float(nodes[i].learner.fit().get_parameters()["w"][0, 0]) for _ in range(3)]
            for i in (1, 3)}
    assert vals[1] == [1.0, -1.0, 1.0]
    assert vals[3] == [0.0, -1.0, -1.0]
    # The replay mode caches the first contribution and its version,
    # then re-sends both without fitting while active.
    flood = nodes[4].learner
    first = flood.fit()
    assert flood.shape_contribution(first, 0) == (first, 0)
    fits = flood._inner.fits
    replayed = flood.fit()
    assert flood._inner.fits == fits
    model, version = flood.shape_contribution(replayed, 5)
    assert version == 0 and model.get_contributors() == ["node-4"]


def test_node_runtime_parts_raise():
    """What of the node-runtime plane still raises: the harness without
    data (its default, ``rendered_digits``, is item 8). The rest of it
    works: the speed plan under the serialized async rounds forks one
    schedule per aggregator, make_adversary wraps, apply_chaos with no
    plan changes nothing, unknown experiments have no adversaries."""
    snap = Settings.snapshot()
    Settings.ASYNC_ROUNDS = True
    Settings.ASYNC_SERIALIZED = True
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 8"):
            attacks.run_seeded_experiment(1, 2, 1, device="cpu")
        attached = []
        peers = [types.SimpleNamespace(addr=a, learner=object(), aggregator=types.SimpleNamespace(
            set_async_schedule=attached.append)) for a in ("a", "b")]
        attacks.apply_speed_plan(peers, TrainerSpeedPlan({"a": 0.5, "b": 0.25}, seed=3))
        assert len(attached) == 2 and attached[0] is not attached[1]
        assert [s.expected() for s in attached] == ["b", "b"]
        assert isinstance(peers[0].learner, attacks.SlowLearner)
    finally:
        Settings.restore(snap)
    node = types.SimpleNamespace(addr="n", learner=object())
    assert attacks.make_adversary(node, sign_flip()) is node
    assert isinstance(node.learner, attacks.AdversarialLearner)
    assert attacks.apply_chaos([]) == ({}, None)
    assert attacks.adversary_map("no-such-experiment") == {}
    assert sorted(attacks.__all__) == sorted(__import__("tpfl.attacks").attacks.__all__)
