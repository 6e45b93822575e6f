"""The engine's ``attack_scales`` (the seeded sign-flip adversary lowered
into the round, ``AttackPlan.engine_scales``) against the JAX engine, on
the CPU, with the narrow f32 CNN through the conv kernels' plain
versions (JAX's Pallas kernels in interpret mode).

- ``[n]`` and ``[n_rounds, n]`` scales from a plan, trained rounds:
  rtol 1e-4, atol 1e-5 (f32 reduction order, as the engine's other
  parity tests);
- pad rows: the JAX engine on a 2-device CPU mesh pads 3 nodes to 4
  with one-valued scales; the port's ``pad_attack_scales`` pads the same
  way;
- under ``ENGINE_WIRE_CODEC="quant8"``: an aggregation-only round folds
  the scaled nodes' decoded params;
- all-ones scales give the unscaled window bit for bit; a wrong row
  count or node count raises ``ValueError`` as the reference's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.attacks import AttackPlan as JaxPlan
from tpfl.models import CNN as JaxCNN
from tpfl.parallel.engine import FederationEngine as JaxEngine
from tpfl.settings import Settings as JaxSettings
from tpfl_torch.attacks import AttackPlan
from tpfl_torch.interop import params_from_flax, params_to_numpy
from tpfl_torch.models import CNN
from tpfl_torch.parallel import FederationEngine
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import tree_items

RTOL, ATOL = 1e-4, 1e-5
N = 3
ADDRS = [f"node-{i}" for i in range(N)]
PLAN = {"seed": 3, "peers": {"1": {"attack": "sign_flip"},
                             "node-2": {"attack": "sign_flip", "mode": "ramp",
                                        "ramp_rounds": 2, "start": 1}}}


@pytest.fixture(autouse=True)
def both_settings():
    snap, jsnap = Settings.snapshot(), JaxSettings.snapshot()
    yield
    Settings.restore(snap)
    JaxSettings.restore(jsnap)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(N, 2, 4, 8, 8, 3)).astype(np.float32),
            rng.integers(0, 10, size=(N, 2, 4)).astype(np.int32))


def _engines(mesh=None):
    jeng = JaxEngine(JaxCNN(channels=(4, 8), dense=16, out_channels=10,
                            compute_dtype=jnp.float32, conv_impl="pallas"),
                     N, learning_rate=0.1, seed=0, mesh=mesh)
    teng = FederationEngine(CNN(channels=(4, 8), dense=16, out_channels=10,
                                compute_dtype=torch.float32, conv_impl="pallas"),
                            N, learning_rate=0.1, seed=0, device="cpu")
    p0 = jax.tree_util.tree_map(lambda a: np.array(a), dict(jeng.init_params((8, 8, 3))))
    # Distinct nodes: node i's params scaled by 1 + i/4.
    p0 = jax.tree_util.tree_map(
        lambda a: (a * (1.0 + np.arange(a.shape[0]) / 4).reshape((-1,) + (1,) * (a.ndim - 1))
                   ).astype(np.float32), p0)
    return jeng, teng, p0


def _run(jeng, teng, p0, scales, n_rounds, epochs=1, weights=None):
    xs, ys = _data()
    jkw = {} if weights is None else {"weights": jnp.asarray(weights, jnp.float32)}
    pj, lj = jeng.run_rounds(jax.tree_util.tree_map(jnp.asarray, p0), jnp.asarray(xs),
                             jnp.asarray(ys), epochs=epochs, n_rounds=n_rounds,
                             attack_scales=jnp.asarray(scales), **jkw)
    pt, lt = teng.run_rounds(params_from_flax({k: {n: v[:N] for n, v in layer.items()}
                                               for k, layer in p0.items()}, device="cpu"),
                             xs, ys, epochs=epochs, n_rounds=n_rounds, attack_scales=scales,
                             weights=weights)
    return pt, lt, pj, lj


def _assert_close(pt, lt, pj, lj):
    got = dict(tree_items(params_to_numpy(pt)))
    for path, w in tree_items(jax.tree_util.tree_map(np.asarray, dict(pj))):
        np.testing.assert_allclose(got[path], w[:N], rtol=RTOL, atol=ATOL, err_msg=path)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj)[:N], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("per_round", [False, True])
def test_scales_match_jax_engine(per_round):
    scales = JaxPlan.from_dict(PLAN).engine_scales(ADDRS, 2)
    assert np.array_equal(AttackPlan.from_dict(PLAN).engine_scales(ADDRS, 2), scales)
    if not per_round:
        scales = scales[0]
    jeng, teng, p0 = _engines()
    _assert_close(*_run(jeng, teng, p0, scales, n_rounds=2))


def test_pad_rows_match_jax_mesh():
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("nodes",))
    jeng, teng, p0 = _engines(mesh=mesh)
    assert jeng.padded_nodes == 4
    scales = AttackPlan.from_dict(PLAN).engine_scales(ADDRS, 2, start_round=1)
    np.testing.assert_array_equal(np.asarray(jeng.pad_attack_scales(scales)),
                                  _padded(teng, scales, jeng.padded_nodes))
    _assert_close(*_run(jeng, teng, {k: {n: v for n, v in layer.items()}
                                     for k, layer in p0.items()}, scales, n_rounds=2))


def _padded(teng, scales, padded):
    saved = teng.padded_nodes
    teng.padded_nodes = padded
    try:
        return teng.pad_attack_scales(scales).numpy()
    finally:
        teng.padded_nodes = saved


def test_quant8_aggregation_round_matches():
    Settings.ENGINE_WIRE_CODEC = JaxSettings.ENGINE_WIRE_CODEC = "quant8"
    jeng, teng, p0 = _engines()
    scales = np.asarray([1.0, -1.0, 0.5], np.float32)
    _assert_close(*_run(jeng, teng, p0, scales, n_rounds=1, epochs=0,
                        weights=[1.0, 2.0, 1.0]))


def test_all_ones_is_the_unscaled_window_and_validation():
    _, teng, p0 = _engines()
    xs, ys = _data()
    params = params_from_flax(p0, device="cpu")
    plain, lp = teng.run_rounds(params, xs, ys, n_rounds=2)
    ones, lo = teng.run_rounds(params, xs, ys, n_rounds=2, attack_scales=np.ones((2, N)))
    for (path, a), (_, b) in zip(tree_items(plain), tree_items(ones)):
        assert torch.equal(a, b), path
    assert torch.equal(lp, lo)
    with pytest.raises(ValueError, match="rows"):
        teng.run_rounds(params, xs, ys, n_rounds=2, attack_scales=np.ones((3, N)))
    with pytest.raises(ValueError, match="nodes"):
        teng.run_rounds(params, xs, ys, attack_scales=np.ones((N + 1,)))
