"""The port's ShardedTrainer and fsdp_spec (tpfl_torch.parallel.sharded)
against the JAX package's, on the CPU: the counterparts of
``tests/test_parallel.py:267, 374, 398, 798``.

The port's side runs once, in a ``gloo`` world of 4 spawned ranks
(``tests/torch_mesh_worker.py``): ``dp`` 4 with and without FSDP on an
MLP (5 steps), a CNN through the conv kernels' plain versions and a
BatchNorm ResNet-18 of one stage (2 steps, ``train_step_with_aux``: sync BatchNorm
over the split batch), and one step of a TransformerLM on a composed
``dp 2 x sp 2`` mesh with ring attention over ``sp``. The JAX
``ShardedTrainer`` runs in this process on ``jax.devices()[:4]`` from the
port's initial params and the same batches. Tolerances: losses rtol
1e-5, params rtol 1e-4 / atol 1e-5 (the ranks' gradients summed in
another order than XLA's).
"""

import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
import torch_spmd_worker as spmd_worker
from tpfl_torch.parallel.sharded import fsdp_spec
from tpfl_torch.utils.tree import tree_items

LOSS_RTOL, RTOL, ATOL = 1e-5, 1e-4, 1e-5


@pytest.fixture(scope="module")
def world():
    return spmd_worker.run_world(worker.sharded_results)


def _jax_kind(kind):
    import jax.numpy as jnp

    from tpfl.models import CNN, MLP, ResNet18

    return {
        "mlp64": lambda: MLP(hidden_sizes=(64,), out_channels=10, compute_dtype=jnp.float32),
        "resnet": lambda: ResNet18(stage_sizes=(1,), out_channels=10,
                                   compute_dtype=jnp.float32),
        "cnn8": lambda: CNN(channels=(8,), dense=32, out_channels=10,
                            compute_dtype=jnp.float32, conv_impl="xla"),
    }[kind]()


def _jax_trainer(name):
    """The JAX ShardedTrainer's run of a worker case: its losses and
    whole params (and batch stats)."""
    import jax
    import jax.numpy as jnp

    from tpfl.parallel import ShardedTrainer, create_mesh

    kind, axes, fsdp, with_aux, steps, batch, shape = worker.SHARDED[name]
    mesh = create_mesh(axes, devices=jax.devices()[:4])
    tr = ShardedTrainer(_jax_kind(kind), mesh, fsdp=fsdp, learning_rate=0.05)
    p0, a0 = worker.sharded_init(kind, shape)
    params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, p0), tr._param_sharding(p0))
    opt = tr._opt.init(params)
    aux = jax.tree_util.tree_map(jnp.asarray, a0)
    x, y = tr.shard_batch(*worker.sharded_batch(batch, shape))
    losses = []
    for _ in range(steps):
        if with_aux:
            params, aux, opt, loss = tr.train_step_with_aux(params, aux, opt, x, y)
        else:
            params, opt, loss = tr.train_step(params, opt, x, y)
        losses.append(float(loss))
    out = {"losses": losses, "params": jax.tree_util.tree_map(np.array, params),
           "local_shapes": {path: tuple(t.addressable_shards[0].data.shape)
                            for path, t in tree_items(params)}}
    if with_aux:
        out["aux"] = jax.tree_util.tree_map(np.array, aux)
    return out


def _close(got, want, what, **tol):
    got, want = dict(tree_items(got)), dict(tree_items(want))
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, err_msg=f"{what} {path}", **tol)


@pytest.mark.parametrize("name", sorted(worker.SHARDED))
def test_sharded_trainer_matches_jax(world, name):
    """dp 4 (and FSDP): the losses, the params and the batch stats after
    the steps; under FSDP each rank holds the JAX shard's shape of every
    leaf (and its optimizer trace likewise), and at least one leaf is
    split."""
    want = _jax_trainer(name)
    for r in world:
        got = r[name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
        _close(got["params"], want["params"], name, rtol=RTOL, atol=ATOL)
        if "aux" in want:
            _close(got["aux"], want["aux"], name + " aux", rtol=RTOL, atol=ATOL)
        assert got["local_shapes"] == want["local_shapes"]
        assert got["opt_local_shapes"] == got["local_shapes"]
    assert world[0][name]["losses"][-1] < world[0][name]["losses"][0]
    fsdp = worker.SHARDED[name][2]
    full = {path: a.shape for path, a in tree_items(world[0][name]["params"])}
    assert any(world[0][name]["local_shapes"][p] != s for p, s in full.items()) == fsdp


def test_init_rejects_a_batchnorm_module_and_places_its_own_state(world):
    for r in world:
        assert "init_with_aux" in r["bn_refusal"]
        assert r["init_opt_zero"]
        specs = r["init_specs"]
        assert specs["Dense_0/kernel"] == [(True, 1)]
        assert specs["Dense_1/bias"] == [(False, None)]  # 10 does not split over 4


def test_composed_dp_sp_step_matches_jax(world):
    """One step of a TransformerLM on ``dp 2 x sp 2``: the batch over
    ``dp``, ring attention (the flash kernels' plain versions) over
    ``sp``: the loss and the updated params of the JAX composed step
    (``tests/test_parallel.py:798``) from the same params and tokens (its
    ring on the einsum inner: the same attention, without compiling the
    Pallas kernels in interpret mode)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec

    from tpfl.models import TransformerLM
    from tpfl.parallel import create_mesh, make_ring_attention

    mesh = create_mesh({"dp": 2, "sp": 2}, devices=jax.devices()[:4])
    mod = TransformerLM(vocab=32, dim=32, heads=2, n_layers=1, max_len=64,
                        compute_dtype=jnp.float32,
                        attention_fn=make_ring_attention(mesh, axis_name="sp", causal=True,
                                                         impl="xla"))
    p0, _ = worker.sharded_init("lm", (32,))
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    tx = optax.sgd(0.1, momentum=0.9)
    opt = tx.init(params)
    tokens = jax.device_put(jnp.asarray(worker.lm_tokens()),
                            NamedSharding(mesh, PartitionSpec("dp", "sp")))

    def loss_of(p):
        logits = mod.apply({"params": p}, tokens, train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], tokens[:, 1:]).mean()

    loss, g = jax.jit(jax.value_and_grad(loss_of))(params)
    u, _ = tx.update(g, opt, params)
    want = jax.tree_util.tree_map(np.array, optax.apply_updates(params, u))
    for r in world:
        np.testing.assert_allclose(r["dp_sp_loss"], float(loss), rtol=LOSS_RTOL)
        _close(r["dp_sp_params"], want, "dp x sp", rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("axis_size", [2, 4, 8])
def test_fsdp_spec_equals_jax_over_the_zoo(axis_size):
    """The port's params are flax's layout (HWIO, ``[in, out]``), so the
    last dividing dim is the JAX function's pick on every leaf of the
    zoo's trees."""
    from tpfl.parallel.sharded import fsdp_spec as jax_fsdp_spec
    from tpfl_torch.models import CNN, MLP, ResNet18, TransformerLM, init_state

    for module, shape in ((MLP(), (28, 28)), (CNN(), (32, 32, 3)),
                          (ResNet18(stage_sizes=(1, 1)), (16, 16, 3)),
                          (TransformerLM(dim=64, n_layers=1, max_len=64), (64,))):
        params, aux = init_state(module, shape, seed=0, device="cpu")
        for path, leaf in (*tree_items(params), *tree_items(aux)):
            got = fsdp_spec(leaf, "dp", axis_size)
            want = tuple(jax_fsdp_spec(np.zeros(tuple(leaf.shape)), "dp", axis_size))
            assert got == want, (type(module).__name__, path)
    assert fsdp_spec(torch.zeros(()), "dp", 2) == ()
