"""Parity of the port's pipeline and expert planes
(tpfl_torch.parallel.pipeline, moe) with the JAX package's, and of its
mesh, layout and distributed helpers, on the CPU.

The multi-rank cases run once, in a ``gloo`` world of 4 spawned ranks
(``tests/torch_spmd_worker.py``), against the JAX functions on a 4-device
mesh, at the JAX suite's tolerances (``tests/test_parallel.py:841-1100``):
pipeline forward atol 1e-6 against the sequential stack (the port's), its
training losses rtol 1e-5 and params atol 1e-5, MoE outputs atol 1e-5.
The pipeline's forward is held to JAX's at rtol 1e-5, atol 1e-5 (f32
sums in two orders, ``X_RTOL``), the top-k MoE's gradients at atol 1e-5. The one-rank cases run in this process over a
``HashStore`` group, which each test tears down.
"""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_spmd_worker as worker
from tpfl_torch.models import CNN, MLP, TransformerLM, init_params
from tpfl_torch.parallel import distributed as spmd
from tpfl_torch.parallel import mesh as port_mesh
from tpfl_torch.parallel.moe import make_moe_layer, make_moe_train_layer
from tpfl_torch.parallel.pipeline import make_pipeline, make_pipeline_trainer
from tpfl_torch.utils.tree import tree_items, tree_map

PIPE_ATOL, LOSS_RTOL, PARAM_ATOL, MOE_ATOL = 1e-6, 1e-5, 1e-5, 1e-5
#: The pipeline's bank against JAX's: eight tanh blocks of f32 sums taken
#: in torch's order and in XLA's, outputs up to ~5 (measured: 3.3e-6 apart
#: at most). atol 1e-6 holds the bank to the port's own sequential stack.
X_RTOL, X_ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def world():
    """Every rank's results of ``worker.planes_results``; the world's
    children have exited when it returns."""
    return worker.run_world(worker.planes_results)


@pytest.fixture
def one_rank():
    """One-rank ``pp`` and ``ep`` meshes over a ``HashStore`` group, torn
    down after."""
    assert not dist.is_initialized()
    meshes = {axis: port_mesh.create_mesh({axis: 1}, device="cpu") for axis in ("pp", "ep")}
    try:
        yield meshes
    finally:
        dist.destroy_process_group()


def _jax_mesh(axis):
    import jax

    from tpfl.parallel import create_mesh as jax_mesh

    return jax_mesh({axis: worker.WORLD}, devices=jax.devices()[:worker.WORLD])


def _jax_block(p, x):
    import jax.numpy as jnp

    return x + jnp.tanh(x @ p["w1"]) @ p["w2"]


def _same_on_every_rank(world, key):
    for r in world[1:]:
        for (path, a), (_, b) in zip(tree_items(world[0][key]), tree_items(r[key])):
            np.testing.assert_array_equal(a, b, err_msg=path)


# ---- pipeline ------------------------------------------------------------------------


def test_pipeline_world4_matches_jax(world):
    """8 blocks over 4 stages, 6 microbatches of [4, 16]: the last stage's
    bank on every rank, against the JAX pipeline and the sequential stack;
    bf16 microbatches through f32 params keep bf16; 6 layers over 4
    stages are refused."""
    import jax.numpy as jnp

    from tpfl.parallel.pipeline import make_pipeline as jax_make_pipeline

    params, micro, _ = worker.pipe_inputs(0)
    want = np.asarray(jax_make_pipeline(_jax_mesh("pp"), _jax_block, n_layers=worker.PIPE_L)(
        tree_map(jnp.asarray, params), jnp.asarray(micro)))
    _same_on_every_rank(world, "pipe_fwd")
    seq = []
    for x in torch.from_numpy(micro):
        for layer in range(worker.PIPE_L):
            x = worker.pipe_block({k: torch.from_numpy(v[layer]) for k, v in params.items()}, x)
        seq.append(x)
    np.testing.assert_allclose(world[0]["pipe_fwd"], torch.stack(seq).numpy(), atol=PIPE_ATOL)
    np.testing.assert_allclose(world[0]["pipe_fwd"], want, rtol=X_RTOL, atol=X_ATOL)
    assert world[0]["pipe_bf16_dtype"] == "torch.bfloat16"
    assert "do not split" in world[0]["pipe_split_error"]


def test_pipeline_world4_trains_like_jax(world):
    """Five SGD(0.05) steps of the pipeline trainer against the JAX
    trainer: the same losses on every rank, the same params."""
    import jax.numpy as jnp

    from tpfl.parallel.pipeline import make_pipeline_trainer as jax_trainer

    params, micro, targets = worker.pipe_inputs(1)
    init, step = jax_trainer(_jax_mesh("pp"), _jax_block, n_layers=worker.PIPE_L,
                             loss_fn=lambda o, t: jnp.mean((o - t) ** 2), learning_rate=0.05)
    p, opt = init(tree_map(jnp.asarray, params))
    losses = []
    for _ in range(5):
        p, opt, loss = step(p, opt, jnp.asarray(micro), jnp.asarray(targets))
        losses.append(float(loss))
    for r in world:
        np.testing.assert_array_equal(r["pipe_losses"], world[0]["pipe_losses"])
    _same_on_every_rank(world, "pipe_params")
    np.testing.assert_allclose(world[0]["pipe_losses"], losses, rtol=LOSS_RTOL)
    assert world[0]["pipe_losses"][-1] < world[0]["pipe_losses"][0]
    for name in ("w1", "w2"):
        np.testing.assert_allclose(world[0]["pipe_params"][name], np.asarray(p[name]),
                                   atol=PARAM_ATOL, err_msg=name)


def test_pipeline_one_rank_is_the_sequential_stack(one_rank):
    """At axis size 1 (the card's machine) the pipeline has no shift: the
    bank and a training step are the sequential stack's, microbatch by
    microbatch."""
    params, micro, targets = worker.pipe_inputs(1)
    tparams = tree_map(torch.from_numpy, params)
    got = make_pipeline(one_rank["pp"], worker.pipe_block, worker.PIPE_L)(
        tparams, torch.from_numpy(micro))

    def seq(p):
        outs = []
        for x in torch.from_numpy(micro):
            for layer in range(worker.PIPE_L):
                x = worker.pipe_block(tree_map(lambda a: a[layer], p), x)
            outs.append(x)
        return torch.stack(outs)

    assert torch.equal(got, seq(tparams))
    init, step = make_pipeline_trainer(one_rank["pp"], worker.pipe_block, worker.PIPE_L,
                                       lambda o, t: torch.mean((o - t) ** 2),
                                       learning_rate=0.05)
    p, _, loss = step(*init(tparams), torch.from_numpy(micro), torch.from_numpy(targets))
    live = tree_map(lambda a: a.clone().requires_grad_(True), tparams)
    want_loss = torch.mean((seq(live) - torch.from_numpy(targets)) ** 2)
    want_loss.backward()
    assert float(loss) == float(want_loss.detach())
    for name in ("w1", "w2"):
        np.testing.assert_allclose(p[name].numpy(),
                                   (tparams[name] - 0.05 * live[name].grad).numpy(),
                                   atol=PIPE_ATOL)


# ---- experts -----------------------------------------------------------------------------


@functools.cache
def _jax_route(capacity: int) -> np.ndarray:
    import jax.numpy as jnp

    from tpfl.parallel.moe import make_moe_layer as jax_moe_layer

    x, _ = worker.moe_route_inputs()
    layer = jax_moe_layer(_jax_mesh("ep"), expert_fn=lambda p, toks: toks * p["scale"],
                          router_fn=lambda toks: toks[:, 0].astype(jnp.int32),
                          capacity=capacity)
    scales = jnp.arange(1, worker.WORLD + 1, dtype=jnp.float32).reshape(worker.WORLD, 1, 1)
    return np.asarray(layer({"scale": scales}, jnp.asarray(x)))


@pytest.mark.parametrize("capacity", [worker.MOE_T, 1])
def test_moe_world4_routes_like_jax(world, capacity):
    """Top-1 routing over 4 experts: every kept token scaled by the expert
    its feature 0 names; at capacity 1 most tokens drop and pass through
    unchanged. Against the JAX layer at atol 1e-5."""
    x, want_expert = worker.moe_route_inputs()
    got = world[0][f"moe_route_c{capacity}"]
    _same_on_every_rank(world, f"moe_route_c{capacity}")
    np.testing.assert_allclose(got, _jax_route(capacity), atol=MOE_ATOL)
    expected = x * (want_expert[:, None] + 1)
    processed = np.isclose(got, expected).all(axis=1)
    passthrough = np.isclose(got, x).all(axis=1)
    assert (processed | passthrough).all()
    if capacity == worker.MOE_T:
        np.testing.assert_allclose(got, expected, atol=MOE_ATOL)
    else:
        assert passthrough.sum() > 0


def test_moe_world4_refusals_and_invalid_routes(world):
    """Mismatched experts raise the reference's ValueError; router ids
    outside [0, n) pass through bit for bit, never clamped onto an
    expert."""
    assert "leading dim" in world[0]["moe_experts_error"]
    bad = np.ones((4 * worker.WORLD, 4), np.float32)
    bad[:, 0] = 99
    for r in world:
        np.testing.assert_array_equal(r["moe_invalid"], bad)


@functools.cache
def _jax_moe_train(capacity: int) -> dict:
    import jax
    import jax.numpy as jnp

    from tpfl.parallel.moe import make_moe_train_layer as jax_train_layer

    params, x, y = worker.moe_train_inputs()
    layer = jax_train_layer(_jax_mesh("ep"), expert_fn=lambda p, toks: toks @ p["w"],
                            capacity=capacity, k=2)
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    def loss_of(p):
        out, aux = layer(p, xj)
        return jnp.mean((out - yj) ** 2) + 0.01 * aux, (out, aux)

    (loss, (out, aux)), grads = jax.value_and_grad(loss_of, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    return {"loss": float(loss), "out": np.asarray(out), "aux": float(aux),
            "grads": jax.tree_util.tree_map(np.asarray, grads)}


@pytest.mark.parametrize("capacity", [64, 8])
def test_moe_train_layer_world4_matches_jax(world, capacity):
    """The top-k (k 2) layer on the JAX suite's clustered task: outputs,
    the aux loss and the gradients of ``mse + 0.01·aux`` (router and
    experts) against JAX; at capacity 8 of ~32 tokens a rank, choices
    drop onto the residual path."""
    want = _jax_moe_train(capacity)
    got = world[0][f"moe_train_c{capacity}"]
    _same_on_every_rank(world, f"moe_train_c{capacity}")
    np.testing.assert_allclose(got["out"], want["out"], atol=MOE_ATOL)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-6)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    for path, g in tree_items(got["grads"]):
        w = dict(tree_items(want["grads"]))[path]
        np.testing.assert_allclose(g, w, atol=MOE_ATOL, err_msg=path)
    if capacity == 8:
        params, x, _ = worker.moe_train_inputs()
        probs = torch.softmax(torch.from_numpy(x @ params["router"]), -1)
        top = torch.topk(probs, 2).indices
        counts = torch.stack([torch.bincount(top[r * 32:(r + 1) * 32, 0], minlength=4)
                              for r in range(worker.WORLD)])
        assert int(counts.max()) > capacity  # the capacity bites


def test_moe_one_rank(one_rank):
    """One expert at axis size 1: every kept token goes through it, and the
    tokens past the capacity or with an invalid id pass through; the top-k
    layer with one expert is the expert, with an aux loss of 1 (a uniform
    load); its refusals."""
    x = torch.arange(12.0).reshape(6, 2)
    layer = make_moe_layer(one_rank["ep"], expert_fn=lambda p, toks: toks * p["s"],
                           router_fn=lambda toks: torch.tensor([0, 0, 0, 5, 0, -1]),
                           capacity=3)
    got = layer({"s": torch.full((1, 1, 1), 3.0)}, x)
    want = x.clone()
    want[[0, 1, 2]] *= 3  # the fifth token is past the capacity
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="leading dim"):
        layer({"s": torch.ones((2, 1, 1))}, x)
    train = make_moe_train_layer(one_rank["ep"], lambda p, toks: toks @ p["w"],
                                 capacity=6, k=1)
    params = {"router": torch.ones((2, 1), requires_grad=True),
              "experts": {"w": torch.eye(2)[None].clone().requires_grad_(True)}}
    y, aux = train(params, x)
    assert torch.equal(y, x) and float(aux.detach()) == 1.0
    with pytest.raises(ValueError, match="Router output dim"):
        train({"router": torch.ones((2, 2)), "experts": params["experts"]}, x)


# ---- meshes, layouts and the runtime ---------------------------------------------------


def test_create_mesh_sizes_and_errors(one_rank):
    """Sizes that do not multiply to the world raise the reference's
    ValueError; a -1 size is inferred; a missing axis has size 1."""
    assert port_mesh.mesh_axis_size(one_rank["pp"], "pp") == 1
    assert port_mesh.mesh_axis_size(one_rank["pp"], "sp") == 1
    assert port_mesh.mesh_axis_size(None) == 1
    assert port_mesh.create_mesh({"dp": -1}, device="cpu").mesh_dim_names == ("dp",)
    assert port_mesh.create_mesh(device="cpu").mesh_dim_names == (port_mesh.NODE_AXIS,)
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        port_mesh.create_mesh({"sp": 4}, device="cpu")
    with pytest.raises(ValueError, match="need 2 devices"):
        port_mesh.create_mesh({"dp": 2, "sp": 1}, device="cpu")


def test_create_mesh_alone_needs_one_rank_and_a_card_by_default():
    """A lone process asking for more than one rank raises before it
    starts a group; ``device=None`` means the card, and without one the
    mesh raises naming the CPU."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        port_mesh.create_mesh({"sp": 4}, device="cpu")
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_mesh.create_mesh({"sp": 1})
    assert not dist.is_initialized()


def test_ensure_distributed_alone(monkeypatch):
    """No coordinator, or a one-process world: False, and nothing
    initialised; the axis constants are the reference's."""
    from tpfl.parallel import mesh as jax_mesh

    for var in ("TPFL_COORDINATOR", "TPFL_NUM_PROCESSES", "TPFL_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert spmd.ensure_distributed() is False
    monkeypatch.setenv("TPFL_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("TPFL_NUM_PROCESSES", "1")
    assert spmd.ensure_distributed() is False
    assert spmd.ensure_distributed("127.0.0.1:1", 1, 0, device="cpu") is False
    assert not dist.is_initialized() and not spmd.is_multiprocess()
    for name in ("NODE_AXIS", "MODEL_AXIS", "HOST_AXIS", "FSDP_AXIS", "TP_AXIS"):
        assert getattr(port_mesh, name) == getattr(jax_mesh, name)


def _lm_paths_and_shapes():
    module = TransformerLM(vocab=48, dim=32, heads=4, n_layers=2, max_len=64,
                           compute_dtype=torch.float32)
    params = init_params(module, (16,), seed=0, device="cpu")
    return [(path, tuple(leaf.shape)) for path, leaf in tree_items(params)]


@pytest.mark.parametrize("axis_size", [1, 2, 4])
def test_spec_layout_leaf_dims_match_jax(axis_size):
    """``transformer_layout().leaf_dims`` over every leaf of the LM's param
    tree equals the JAX layout's, as do the replicated layout's; a leaf
    whose named dim does not divide stays replicated."""
    from tpfl.parallel import mesh as jax_mesh

    for name in ("transformer", "replicated"):
        port_layout, jax_layout = port_mesh.LAYOUTS[name](), jax_mesh.LAYOUTS[name]()
        for path, shape in _lm_paths_and_shapes():
            got = port_layout.leaf_dims(path, shape, axis_size)
            assert got == jax_layout.leaf_dims(path, shape, axis_size), (name, path)
    layout = port_mesh.transformer_layout()
    assert layout.leaf_dims("Embed_0/embedding", (48, 32), 4) == ("model", None)
    assert layout.leaf_dims("Embed_0/embedding", (47, 32), 4) == (None, None)
    assert layout.leaf_dims("TransformerBlock_1/Dense_3/kernel", (128, 32), 2) == ("model", None)
    assert port_mesh._path_str(("TransformerBlock_0", "Dense_1", "kernel")) == \
        "TransformerBlock_0/Dense_1/kernel"


def test_layout_for_module_on_the_zoo():
    """``"auto"`` reads the module's ``spec_layout`` (the transformer's
    ``"transformer"``), the other zoo models ride replicated, a named
    policy wins, an unknown one raises."""
    from tpfl.models import TransformerLM as JaxLM

    assert TransformerLM.spec_layout == JaxLM.spec_layout == "transformer"
    assert port_mesh.layout_for_module(TransformerLM()).name == "transformer"
    assert port_mesh.layout_for_module(MLP()).name == "replicated"
    assert port_mesh.layout_for_module(CNN()).name == "replicated"
    assert port_mesh.layout_for_module(MLP(), "transformer").name == "transformer"
    assert port_mesh.layout_for_module(TransformerLM(), "replicated").rules == ()
    with pytest.raises(ValueError, match="unknown model-axis layout"):
        port_mesh.layout_for_module(MLP(), "fsdp")
