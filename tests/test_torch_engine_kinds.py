"""Parity of the port's engine kinds (tpfl_torch) with the JAX package's
``FederationEngine``, at a small size on the CPU: FedProx and SCAFFOLD,
the BatchNorm aux kind (both ``aux_mode``\\ s) on a small ResNet-18, the
MLP, and the in-round wire codec.

3 nodes, 2 batches of 4 per node, f32 compute, distinct per-node params
drawn by flax and carried across by ``params_from_flax`` (BatchNorm's
``batch_stats`` too). Weights ``[1, 0, 2]`` leave one node out of the
fold, which exercises SCAFFOLD's ``keep_elected``, the uniform-mean
fallback's mask and FedBN's ``"local"``. The JAX ``CNN(conv_impl=
"pallas")`` runs its Pallas conv backward in interpret mode. Float
results: rtol 1e-4, atol 1e-5 (reduction order only). Codec outputs on
identical input are held bit for bit; a trained round under the codec
within one quantisation step of the leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.models import CNN as JaxCNN
from tpfl.models import MLP as JaxMLP
from tpfl.models import ResNet18 as JaxResNet18
from tpfl.parallel.engine import FederationEngine as JaxEngine
from tpfl.parallel.federation import VmapFederation as JaxVmapFederation
from tpfl.settings import Settings as JaxSettings
from tpfl_torch.interop import params_from_flax, params_to_numpy
from tpfl_torch.models import CNN, MLP, ResNet18, apply, init_params
from tpfl_torch.parallel import FederationEngine, VmapFederation
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import tree_items

RTOL, ATOL = 1e-4, 1e-5
N_NODES, N_BATCHES, BATCH = 3, 2, 4
WEIGHTS = [1.0, 0.0, 2.0]

MODELS = {
    "cnn": (lambda: JaxCNN(channels=(4, 8), dense=16, out_channels=10,
                           compute_dtype=jnp.float32, conv_impl="pallas"),
            lambda: CNN(channels=(4, 8), dense=16, out_channels=10,
                        compute_dtype=torch.float32, conv_impl="pallas")),
    "mlp": (lambda: JaxMLP(hidden_sizes=(16, 8), out_channels=10, compute_dtype=jnp.float32),
            lambda: MLP(hidden_sizes=(16, 8), out_channels=10, compute_dtype=torch.float32)),
    # 8×8 inputs and a stride-2 stage: flax pads the 3×3 stride-2 conv
    # (0, 1), not (1, 1).
    "resnet": (lambda: JaxResNet18(stage_sizes=(1, 1), out_channels=10,
                                   compute_dtype=jnp.float32),
               lambda: ResNet18(stage_sizes=(1, 1), out_channels=10,
                                compute_dtype=torch.float32)),
}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(size=(N_NODES, N_BATCHES, BATCH, 8, 8, 3)).astype(np.float32)
    ys = rng.integers(0, 10, size=(N_NODES, N_BATCHES, BATCH)).astype(np.int32)
    return xs, ys


def _host(tree):
    """Owning numpy copies of a JAX tree (donation-safe)."""
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _stacked_state(module):
    """Distinct per-node (params, aux) drawn by flax, one seed per node,
    as numpy trees; aux is ``{}`` for modules without BatchNorm."""
    x0 = jnp.zeros((BATCH, 8, 8, 3), jnp.float32)
    inits = [dict(module.init(jax.random.PRNGKey(s), x0, train=False))
             for s in range(N_NODES)]
    stacked = _host(jax.tree_util.tree_map(lambda *a: jnp.stack(a), *inits))
    params = stacked.pop("params")
    return params, stacked


def _torch_tree(tree):
    return params_from_flax(tree, device="cpu")


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_tree_close(got, want, what, rtol=RTOL, atol=ATOL):
    got = dict(tree_items(params_to_numpy(got)))
    want = dict(tree_items(_host(want)))
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=rtol, atol=atol, err_msg=f"{what} {path}")


def _assert_outputs_close(got: tuple, want: tuple) -> None:
    """``run_rounds`` results of the two engines: the same shape of
    tuple, every tree and the losses close."""
    assert len(got) == len(want)
    names = {2: ("params", "losses"), 3: ("params", "aux", "losses"),
             4: ("params", "aux", "scaffold_state", "losses")}[len(want)]
    for name, g, w in zip(names, got, want):
        if name == "scaffold_state":
            _assert_tree_close(g[0], w[0], "c_locals")
            _assert_tree_close(g[1], w[1], "c_global")
        elif name == "losses":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
        else:
            _assert_tree_close(g, w, name)


def _engines(model, **kw):
    jax_module, torch_module = MODELS[model]
    jeng = JaxEngine(jax_module(), N_NODES, learning_rate=0.1, seed=0, **kw)
    teng = FederationEngine(torch_module(), N_NODES, learning_rate=0.1, seed=0,
                            device="cpu", **kw)
    return jeng, teng


def _run_both(model, epochs=1, n_rounds=2, weights=WEIGHTS, **kw):
    """The same window through both engines from the same per-node state:
    (port's result, JAX's result, port engine, JAX engine, numpy state)."""
    jeng, teng = _engines(model, **kw)
    params, aux = _stacked_state(jeng.module)
    xs, ys = _data()
    jkw, tkw = {}, {}
    if aux:
        jkw["aux"], tkw["aux"] = _jax_tree(aux), _torch_tree(aux)
    if kw.get("algorithm") == "scaffold":
        jkw["scaffold_state"] = jeng.init_scaffold_state(_jax_tree(params))
        tkw["scaffold_state"] = teng.init_scaffold_state(_torch_tree(params))
    want = _host(jeng.run_rounds(_jax_tree(params), jnp.asarray(xs), jnp.asarray(ys),
                                 weights=jnp.asarray(weights, jnp.float32), epochs=epochs,
                                 n_rounds=n_rounds, **jkw))
    got = teng.run_rounds(_torch_tree(params), xs, ys, weights=weights, epochs=epochs,
                          n_rounds=n_rounds, **tkw)
    return got, want, teng, jeng, (params, aux)


CASES = [
    ("cnn", {"algorithm": "fedprox", "prox_mu": 0.1}),
    ("cnn", {"algorithm": "scaffold"}),
    ("mlp", {"algorithm": "fedavg"}),
    ("mlp", {"algorithm": "fedprox", "prox_mu": 0.1}),
    ("mlp", {"algorithm": "scaffold"}),
    ("resnet", {"algorithm": "fedavg", "aux_mode": "mean"}),
    ("resnet", {"algorithm": "fedavg", "aux_mode": "local"}),
    ("resnet", {"algorithm": "fedprox", "prox_mu": 0.1, "aux_mode": "mean"}),
    ("resnet", {"algorithm": "scaffold", "aux_mode": "local"}),
]


@pytest.mark.parametrize("model,kw", CASES,
                         ids=[f"{m}-" + "-".join(str(v) for v in kw.values()) for m, kw in CASES])
def test_engine_kind_matches_jax(model, kw):
    """A 2-round window of each kind: params, aux (the new batch_stats),
    SCAFFOLD's c_locals and c_global, and the last round's losses (which
    carry FedProx's term) — the reference's return tuple, leaf by leaf."""
    got, want, teng, jeng, _ = _run_both(model, **kw)
    _assert_outputs_close(got, want)
    xs, ys = _data(1)
    aux = {} if len(want) == 2 else {"aux": want[1]}
    le_j, acc_j = jeng.evaluate(_jax_tree(want[0]), jnp.asarray(xs), jnp.asarray(ys),
                                **{k: _jax_tree(v) for k, v in aux.items()})
    le_t, acc_t = teng.evaluate(got[0], xs, ys, **({"aux": got[1]} if aux else {}))
    np.testing.assert_allclose(le_t.numpy(), np.asarray(le_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet_forward_and_batch_stats_match_flax(train):
    """Logits and the new batch_stats of the small ResNet-18 per node,
    with training statistics and with the running averages (perturbed
    from their init so that evaluation uses them)."""
    jax_module, torch_module = MODELS["resnet"]
    module = jax_module()
    params, aux = _stacked_state(module)
    rng = np.random.default_rng(5)
    aux = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.1, 0.5, size=a.shape)).astype(np.float32), aux)
    xs = np.random.default_rng(6).normal(size=(N_NODES, BATCH, 8, 8, 3)).astype(np.float32)

    def one(p, a, x):
        if train:
            return module.apply({"params": p, **a}, x, train=True, mutable=["batch_stats"])
        return module.apply({"params": p, **a}, x, train=False), a

    logits_j, aux_j = jax.vmap(one)(_jax_tree(params), _jax_tree(aux), jnp.asarray(xs))
    logits_t, aux_t = apply(torch_module(), _torch_tree(params), _torch_tree(aux),
                            torch.from_numpy(xs), train=train)
    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j),
                               rtol=RTOL, atol=ATOL)
    _assert_tree_close(aux_t, aux_j, "batch_stats")


@pytest.fixture
def wire_codec():
    """Sets ``ENGINE_WIRE_CODEC`` on both packages' Settings; restores
    both afterwards."""
    saved = (JaxSettings.ENGINE_WIRE_CODEC, Settings.ENGINE_WIRE_CODEC)

    def set_codec(codec):
        JaxSettings.ENGINE_WIRE_CODEC = Settings.ENGINE_WIRE_CODEC = codec

    yield set_codec
    JaxSettings.ENGINE_WIRE_CODEC, Settings.ENGINE_WIRE_CODEC = saved


CODECS = ["quant8", "topk+quant8"]


@pytest.mark.parametrize("elected", range(N_NODES))
@pytest.mark.parametrize("codec", CODECS)
def test_codec_fold_bit_equal_on_aggregation_round(wire_codec, codec, elected):
    """An ``epochs=0`` round folds the round trip of the nodes' own
    (distinct) params. With one node elected the fold is that node's
    decoded model, exactly, on every node: both packages' bits agree."""
    wire_codec(codec)
    weights = [1.0 if i == elected else 0.0 for i in range(N_NODES)]
    got, want, _, _, (params, _) = _run_both("cnn", epochs=0, n_rounds=1, weights=weights)
    for path, w in tree_items(want[0]):
        g = dict(tree_items(params_to_numpy(got[0])))[path]
        assert g.tobytes() == np.asarray(w).tobytes(), path
    # ... and the round trip did change the params.
    sent = dict(tree_items(params))
    assert any(not np.array_equal(w[elected], sent[p][elected]) for p, w in tree_items(want[0]))


@pytest.mark.parametrize("codec", CODECS)
def test_codec_trained_round_within_one_quantisation_step(wire_codec, codec):
    """A trained round under the codec: trained params differ between
    the packages at f32 rounding, which may move a quantised value by
    one step. With one node elected the aggregate is that node's decoded
    leaf, whose largest magnitude is exactly 127 steps: every leaf within
    one step (its scale), the losses at RTOL / ATOL."""
    wire_codec(codec)
    got, want, _, _, _ = _run_both("cnn", epochs=1, n_rounds=1, weights=[0.0, 0.0, 1.0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=RTOL, atol=ATOL)
    got_params = dict(tree_items(params_to_numpy(got[0])))
    for path, w in tree_items(want[0]):
        step = float(np.abs(w).max()) / 127.0
        np.testing.assert_allclose(got_params[path], w, rtol=0, atol=step * (1 + 2 ** -10),
                                   err_msg=path)


def test_vmap_federation_round_runs_dense_and_returns_reference_shapes(wire_codec):
    """``VmapFederation.round`` runs the reference's round program, which
    has no codec leg whatever ``ENGINE_WIRE_CODEC`` says; SCAFFOLD with
    BatchNorm returns ``(params, aux, (c_locals, c_global), losses)``.
    ``run_rounds`` through the same API does take the codec."""
    wire_codec("quant8")
    jax_module, torch_module = MODELS["resnet"]
    kw = dict(learning_rate=0.1, seed=0, algorithm="scaffold", aux_mode="local")
    jfed = JaxVmapFederation(jax_module(), N_NODES, **kw)
    tfed = VmapFederation(torch_module(), N_NODES, device="cpu", **kw)
    params, aux = _stacked_state(jfed.module)
    xs, ys = _data(2)
    want = _host(jfed.round(_jax_tree(params), jnp.asarray(xs), jnp.asarray(ys),
                            weights=jnp.asarray(WEIGHTS), aux=_jax_tree(aux),
                            scaffold_state=jfed.init_scaffold_state(_jax_tree(params))))
    # Each window donates its state: each starts from its own tensors.
    tp = _torch_tree(params)
    got = tfed.round(tp, xs, ys, weights=WEIGHTS, aux=_torch_tree(aux),
                     scaffold_state=tfed.init_scaffold_state(tp))
    _assert_outputs_close(got, want)
    tp = _torch_tree(params)
    coded = tfed.run_rounds(tp, xs, ys, weights=WEIGHTS, aux=_torch_tree(aux),
                            scaffold_state=tfed.init_scaffold_state(tp))
    assert not torch.equal(coded[0]["Dense_0"]["kernel"], got[0]["Dense_0"]["kernel"])


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_engine_validation_matches_reference():
    """The reference's ValueErrors, message for message."""
    jm, tm = MODELS["mlp"]
    for kw in ({"algorithm": "fedsgd"}, {"aux_mode": "global"}):
        assert (_error(lambda: FederationEngine(tm(), 2, device="cpu", **kw))
                == _error(lambda: JaxEngine(jm(), 2, **kw)))
    jeng, teng = _engines("mlp", algorithm="scaffold")
    params, _ = _stacked_state(jeng.module)
    xs, ys = _data()
    assert (_error(lambda: teng.run_rounds(_torch_tree(params), xs, ys))
            == _error(lambda: jeng.run_rounds(_jax_tree(params), jnp.asarray(xs),
                                              jnp.asarray(ys))))
    jeng, teng = _engines("mlp")
    w = np.ones((3, N_NODES), np.float32)
    assert (_error(lambda: teng.run_rounds(_torch_tree(params), xs, ys, weights=w,
                                           n_rounds=2))
            == _error(lambda: jeng.run_rounds(_jax_tree(params), jnp.asarray(xs),
                                              jnp.asarray(ys), weights=jnp.asarray(w),
                                              n_rounds=2)))
    jeng, teng = _engines("resnet")
    assert (_error(lambda: teng.init_params((8, 8, 3)))
            == _error(lambda: jeng.init_params((8, 8, 3))))
    with pytest.raises(ValueError, match="init_state"):
        init_params(MODELS["resnet"][1](), (8, 8, 3), device="cpu")


def test_init_state_trees_match_flax():
    """``init_state``'s params and batch_stats have flax's tree paths,
    shapes and dtypes (so ``params_from_flax`` carries both unchanged);
    BatchNorm starts at scale 1 / bias 0, mean 0 / var 1."""
    for name, (jax_module, torch_module) in MODELS.items():
        params_j, aux_j = _stacked_state(jax_module())
        eng = FederationEngine(torch_module(), N_NODES, device="cpu")
        params_t, aux_t = eng.init_state((8, 8, 3))
        for got, want in ((params_t, params_j), (aux_t, aux_j)):
            got, want = dict(tree_items(got)), dict(tree_items(want))
            assert sorted(got) == sorted(want), name
            for path, w in want.items():
                assert tuple(got[path].shape) == w.shape and got[path].dtype == torch.float32
                if "BatchNorm" in path and not path.endswith("kernel"):
                    np.testing.assert_array_equal(got[path].numpy(), w, err_msg=path)
