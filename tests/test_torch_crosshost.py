"""The port's cross-host harness (tpfl_torch.parallel.crosshost) and the
``RANK_CONTRACTS`` receipts (tpfl_torch.parallel.ranksafe) against the
JAX package's, on the CPU: the counterparts of
``tests/test_crosshost.py:58-316``.

One ``launch`` of 4 ``gloo`` ranks (``python -m
tpfl_torch.parallel.crosshost`` each, the ``TPFL_*`` environment
contract) runs the demo federation on the auto-resolved ``hosts 2 x
nodes 2`` mesh with ``RANK_CONTRACTS`` and ``ENGINE_TELEMETRY`` on, from
the JAX demo's own initial params. The JAX ``demo_run`` runs in this
process on its forced 2-host mesh (8 CPU devices, ``conftest.py``). A
second launch of 2 ranks forks rank 1's program sequence and must fail.

The demo's MLP computes in bf16 (its default, on both sides): the JAX
program's fusions keep f32 between ops where the port rounds every op to
bf16, so the global model is held at atol 2e-3 and the losses at rtol
1e-2 (bf16's step is 2^-8 ≈ 4e-3 relative). Within the port: every rank
the same bytes, and a one-process run of the same federation allclose at
atol 1e-5.
"""

import numpy as np
import pytest

from tpfl_torch.parallel import crosshost

KNOBS = {"SHARD_NODES": True, "SHARD_HOSTS": 2, "RANK_CONTRACTS": True,
         "ENGINE_TELEMETRY": True}


@pytest.fixture(scope="module")
def init_npz(tmp_path_factory):
    """The JAX demo's initial MLP params (``MLP(hidden_sizes=(8,))`` at
    ``PRNGKey(0)``) as an ``.npz`` of ``/``-joined paths."""
    import jax
    import jax.numpy as jnp

    from tpfl.models import MLP
    from tpfl_torch.utils.tree import tree_items

    params = MLP(hidden_sizes=(8,)).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8)),
                                         train=False)["params"]
    path = tmp_path_factory.mktemp("crosshost") / "init.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in tree_items(jax.tree_util.tree_map(
        np.asarray, dict(params)))})
    return str(path)


@pytest.fixture(scope="module")
def world(init_npz):
    """The 4 ranks' results (their receipts already compared by launch)."""
    return crosshost.launch(4, rounds=2, knobs=KNOBS, init=init_npz, device="cpu")


@pytest.fixture(scope="module")
def jax_demo():
    from tpfl.parallel.crosshost import demo_run
    from tpfl.settings import Settings

    snap = Settings.snapshot()
    try:
        Settings.SHARD_NODES, Settings.SHARD_HOSTS = True, 2
        Settings.ENGINE_TELEMETRY = False
        return demo_run(rounds=2)
    finally:
        Settings.restore(snap)


def test_four_rank_launch_matches_the_jax_demo_run(world, jax_demo):
    assert jax_demo["mesh"] == {"hosts": 2, "nodes": 4}
    for r in world:
        assert r["mesh"] == {"hosts": 2, "nodes": 2}
        np.testing.assert_allclose(r["global"], jax_demo["global"], atol=2e-3)
        np.testing.assert_allclose(r["losses"], jax_demo["losses"], rtol=1e-2)
        assert r["dcn_bytes_per_round"] == jax_demo["dcn_bytes_per_round"] > 0


def test_ranks_agree_byte_for_byte(world):
    assert [r["process_id"] for r in world] == [0, 1, 2, 3]
    for r in world:
        assert r["processes"] == r["devices"] == 4 and r["local_devices"] == 1
        assert r["hosts_axis"] == 2
        assert r["digest"] == world[0]["digest"]


def test_one_process_run_is_allclose_to_the_four_rank_run(world, init_npz):
    """The same logical federation in this process (no world: ``mesh="auto"``
    resolves to no mesh) lands allclose to the 4-rank run."""
    from tpfl_torch.settings import Settings

    snap = Settings.snapshot()
    try:
        Settings.SHARD_NODES = True
        solo = crosshost.demo_run(rounds=2, init=init_npz, device="cpu")
    finally:
        Settings.restore(snap)
    assert solo["mesh"] is None and solo["processes"] == 1
    np.testing.assert_allclose(solo["global"], world[0]["global"], atol=1e-5)
    np.testing.assert_allclose(solo["losses"], world[0]["losses"], atol=1e-5)


def test_rank_contracts_receipts_match_across_ranks(world):
    """Armed ranks record one receipt entry a window dispatch (the demo
    runs one window), with ordinals in dispatch order; launch compared
    them and they agree entry for entry."""
    receipts = [r["program_digests"] for r in world]
    assert len(receipts[0]) == 1
    assert all(rec == receipts[0] for rec in receipts)
    assert [e["ordinal"] for e in receipts[0]] == [0]
    assert all(e["digest"] for e in receipts[0])


def test_rank_contracts_forked_run_fails_with_witness():
    """Rank 1 dispatches one extra rank-local program: the launch fails
    with the first divergent (rank, ordinal, key) witness."""
    from tpfl_torch.parallel.ranksafe import RankContractError

    with pytest.raises(RankContractError,
                       match=r"rank 1 diverged from rank 0 at dispatch ordinal 1"):
        crosshost.launch(2, rounds=1, fork_rank=1, device="cpu",
                         knobs={"SHARD_NODES": True, "SHARD_HOSTS": 0, "RANK_CONTRACTS": True})


def test_compare_receipts_equals_the_reference():
    """The pure-stdlib comparison raises the reference's witness for the
    same logs (a missing, an extra and a different program)."""
    from tpfl.parallel import ranksafe as jax_ranksafe
    from tpfl_torch.parallel import ranksafe

    base = [{"ordinal": 0, "key": "a", "digest": "1"}, {"ordinal": 1, "key": "b", "digest": "2"}]
    for other in (base[:1], base + [{"ordinal": 2, "key": "c", "digest": "3"}],
                  [base[0], {"ordinal": 1, "key": "b", "digest": "9"}]):
        msgs = []
        for mod in (ranksafe, jax_ranksafe):
            with pytest.raises(mod.RankContractError) as e:
                mod.compare_receipts([base, other])
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    ranksafe.clear()
    ranksafe.record_dispatch(("k", 1), ranksafe.hlo_fingerprint("text"))
    jax_ranksafe.clear()
    jax_ranksafe.record_dispatch(("k", 1), jax_ranksafe.hlo_fingerprint("text"))
    assert ranksafe.receipt() == jax_ranksafe.receipt()
    ranksafe.clear()
    jax_ranksafe.clear()


def test_apply_knobs_refuses_a_knob_outside_the_closed_set():
    from tpfl_torch.settings import Settings

    snap = Settings.snapshot()
    try:
        with pytest.raises(ValueError, match="'SEED' not allowed"):
            crosshost._apply_knobs({"SEED": 1})
        crosshost._apply_knobs({"SHARD_HOSTS": 2})
        assert Settings.SHARD_HOSTS == 2
    finally:
        Settings.restore(snap)
    from tpfl.parallel import crosshost as jax_crosshost

    assert crosshost._KNOBS == jax_crosshost._KNOBS


def test_fleet_registry_merges_the_ranks(world):
    """Each rank's receipt carries a snapshot of its deterministic series
    (its engine series under ``ENGINE_TELEMETRY``); folded, the fleet
    registry wears ``origin=<rank>`` labels, and the fold is the same in
    any order."""
    from tpfl_torch.management import fleetobs

    for r in world:
        snap = r["metrics_snapshot"]
        assert snap["origin"] == str(r["process_id"])
        assert snap["counters"] or snap["gauges"]
        for kind in ("counters", "gauges"):
            assert all(s.startswith(fleetobs.DETERMINISTIC_PREFIXES) for s in snap[kind])
    text = fleetobs.fold_receipts(world).render_prometheus()
    for rank in range(4):
        assert f'origin="{rank}"' in text
    assert "tpfl_engine_rounds_total" in text
    assert fleetobs.fold_receipts(world[::-1]).render_prometheus() == text
