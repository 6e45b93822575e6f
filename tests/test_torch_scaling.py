"""The port's static scaling analysis (tpfl_torch.parallel.scaling) and its
collective ledger (tpfl_torch.parallel.distributed), on the CPU: the
counterparts of ``tests/test_scaling_model.py:41-315``.

The port reads no HLO: each collective helper records the bytes it
delivers, and the FLOPs come from ``CostModel`` over
``torch.utils.flop_counter`` (the kernels' plain versions run, and are
counted, on CPU tensors). One ``gloo`` world of 4 spawned ranks
(``tests/torch_mesh_worker.py``) analyses one rank's step at each width
on meshes over the first 1, 2 and 4 ranks; the records must pass the
port's ``check_scaling`` and the JAX package's alike, with the JAX
suite's bounds.
"""

import numpy as np
import pytest

import torch_mesh_worker as worker
import torch_spmd_worker as spmd_worker
from tpfl_torch.parallel.scaling import check_scaling, collective_bytes


@pytest.fixture(scope="module")
def world():
    return spmd_worker.run_world(worker.scaling_results)


def _both_pass(records, params_nbytes):
    from tpfl.parallel.scaling import check_scaling as jax_check_scaling

    for check in (check_scaling, jax_check_scaling):
        failures = check(records, params_nbytes)
        assert not failures, "\n".join(failures)


def test_federation_round_scales_statically(world):
    """One engine round of 8 nodes at widths 1, 2, 4: per-rank FLOPs ~1/d,
    the fold's all-reduce O(one node's params) and width-independent."""
    records = world[0]["fed"]
    assert [r["width"] for r in records] == list(worker.WIDTHS)
    for r in records[1:]:
        assert r["collectives"].get("all-reduce", 0) > 0, r
    _both_pass(records, records[0]["params_bytes"])
    # Ranks outside a narrower mesh ran nothing.
    assert world[3]["fed"][:2] == [None, None]


def test_federation_collective_bytes_independent_of_node_count(world):
    at8, at16 = world[0]["fed"][1], world[0]["fed_nodes16"]
    assert at16["collective_bytes"] <= 1.25 * at8["collective_bytes"], (at8, at16)


def test_fsdp_train_step_scales_statically(world):
    """ShardedTrainer (FSDP) with the global batch growing with d:
    per-rank FLOPs constant within [0.7, 1.4] of width 1's, collectives
    (gather + reduce-scatter + the replicated leaves' all-reduce) at most
    6x the params, never O(batch)."""
    records = world[0]["fsdp"]
    f1 = records[0]["flops"]
    assert f1 > 0
    for r in records:
        assert 0.7 * f1 <= r["flops"] <= 1.4 * f1, r
    for r in records[1:]:
        assert 0 < r["collective_bytes"] <= 6 * r["params_bytes"], r
        assert r["collectives"].get("reduce-scatter", 0) > 0
    weak = [dict(r, width=1) for r in records]
    _both_pass(weak, records[0]["params_bytes"])


def test_fsdp_collective_bytes_independent_of_batch(world):
    a, b = world[0]["fsdp"][2], world[0]["fsdp_batch8"]
    assert b["collective_bytes"] <= 1.25 * a["collective_bytes"], (a, b)


def test_fsdp_aux_step_collective_bytes_independent_of_batch(world):
    """The BatchNorm step keeps the same property; its sync moments are
    O(channels) all-reduces."""
    a, b = world[0]["fsdp_aux"]
    assert b["collective_bytes"] <= 1.25 * a["collective_bytes"], (a, b)


def test_ring_attention_permute_bytes_are_local_block_sized(world):
    """The flash ring moves O(local KV block) a hop: d - 1 forward hops of
    k + v, d backward hops of k, v, dk, dv (the last one dk, dv only):
    6d - 4 blocks, never O(S); at fixed S the bytes a hop fall with d."""
    seen = {}
    for d, coll in world[0]["ring"].items():
        pb = coll.get("collective-permute", 0)
        local_block = 1 * (64 // d) * 2 * 8 * 4
        assert 0 < pb <= 6 * d * local_block, (d, pb)
        seen[d] = pb / d  # per hop
    assert seen[4] < seen[2], seen


def test_pipeline_permute_hop_size_independent_of_microbatch_count(world):
    mb_bytes = 2 * 8 * 4
    hops = {}
    for n_micro, coll in world[0]["pipeline"].items():
        ticks = 2 * (n_micro + 4 - 1)  # forward and its transpose
        hops[n_micro] = coll.get("collective-permute", 0) / ticks
        assert 0 < hops[n_micro] <= 2 * mb_bytes, (n_micro, hops)
    assert hops[8] <= 1.5 * hops[4], hops


def test_moe_all_to_all_bytes_are_dispatch_buffer_sized(world):
    cap, dim = 4, 8
    for d, coll in world[0]["moe"].items():
        buf = d * cap * dim * 4
        assert 0 < coll.get("all-to-all", 0) <= 4 * buf, (d, coll)


def test_federation_learner_wire_bytes_independent_of_local_nodes(world):
    """A FederationLearner over the 4-rank mesh puts one O(params) model
    on the wire a fit, whatever its local node count; every rank holds
    the same aggregate."""
    for r in world:
        got = r["learner"]
        assert abs(got[4]["payload"] - got[8]["payload"]) <= 64, got
        for k in (4, 8):
            assert got[k]["digest"] == world[0]["learner"][k]["digest"]
            assert np.isfinite(got[k]["eval"]["test_loss"])


def test_collective_bytes_count_what_the_collectives_deliver(world):
    """Each helper's ledger entry is the bytes of the tensor it delivered
    (a reduce-scatter's shard, an all-gather's whole), and the values are
    the collectives'."""
    for rank, r in enumerate(world):
        led = r["ledger"]
        assert led["by_kind"] == led["delivered"] == collective_bytes(led["events"])
        assert led["by_kind"]["all-gather"] == 4 * 2 * 3 * 4
        assert led["by_kind"]["reduce-scatter"] == 2 * 3 * 4
        assert led["values"]["all-reduce"] == 4.0
        total = np.arange(8.0) * sum(range(1, 5))
        assert led["values"]["reduce-scatter"] == total[2 * rank:2 * rank + 2].tolist()
    with pytest.raises(ValueError, match="unknown collective kind"):
        collective_bytes([("broadcast", 4)])
