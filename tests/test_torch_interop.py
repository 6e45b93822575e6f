"""The port's weight converters (tpfl_torch.interop: ``from_torch_state_dict``,
``to_torch_state_dict``, ``from_keras_weights``, ``to_keras_weights``)
against the JAX package's (tpfl.interop), on the CPU.

Every test of ``tests/test_interop.py`` on the port — the reference
MLP's torch ``state_dict`` (Linear 784-256-128-10) imported and run
through the port's ``MLP`` against the torch forward (atol 1e-5, f32),
the exact round trip, a Conv + BatchNorm import (OIHW -> HWIO, running
stats into ``batch_stats``), the mismatch and underrun errors, and the
Keras MLP's weights, round trip, BatchNorm stats round trip on
``ResNet18(stage_sizes=(1,))`` and count errors — and, on the same
inputs, the port's output bit-equal to the JAX converters' output
(imports leaf for leaf, exports array for array) with the same error
messages. Imports land on the ``device`` argument.
"""

import numpy as np
import pytest
import torch

from tpfl.interop import from_keras_weights as jax_from_keras
from tpfl.interop import from_torch_state_dict as jax_from_torch
from tpfl.interop import to_keras_weights as jax_to_keras
from tpfl.interop import to_torch_state_dict as jax_to_torch
from tpfl_torch.interop import (from_keras_weights, from_torch_state_dict, params_from_flax,
                                to_keras_weights, to_torch_state_dict)
from tpfl_torch.models import MLP, ResNet18, init_state
from tpfl_torch.models.zoo import stack_params
from tpfl_torch.utils.tree import tree_items


def _torch_mlp(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(784, 256), torch.nn.ReLU(),
                               torch.nn.Linear(256, 128), torch.nn.ReLU(),
                               torch.nn.Linear(128, 10))


def _jax_mlp_params():
    import jax.numpy as jnp

    from tpfl.models import create_model

    return create_model("mlp", (28, 28), seed=0, hidden_sizes=(256, 128),
                        compute_dtype=jnp.float32).get_parameters()


def _port_mlp():
    module = MLP(hidden_sizes=(256, 128), out_channels=10, compute_dtype=torch.float32)
    params, _ = init_state(module, (28, 28), seed=0, device="cpu")
    return module, params


def _port_forward(module, params, x):
    return module(stack_params(params, 1), torch.as_tensor(x)[None])[0]


def _assert_trees_bit_equal(ours, theirs):
    ours, theirs = dict(tree_items(ours)), dict(tree_items(theirs))
    assert list(ours) == list(theirs)  # same paths, same (module) order
    for path, leaf in ours.items():
        assert leaf.device.type == "cpu"
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(theirs[path]), err_msg=path)
        assert leaf.numpy().dtype == np.asarray(theirs[path]).dtype


def test_torch_mlp_import_forward_parity():
    tm = _torch_mlp()
    module, params = _port_mlp()
    params = from_torch_state_dict(params, tm.state_dict(), device="cpu")
    _assert_trees_bit_equal(params, jax_from_torch(_jax_mlp_params(), tm.state_dict()))
    x = np.random.default_rng(0).normal(size=(4, 784)).astype(np.float32)
    with torch.no_grad():
        want = tm(torch.as_tensor(x)).numpy()
        got = _port_forward(module, params, x.reshape(4, 28, 28)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_torch_state_dict_round_trip():
    tm = _torch_mlp(seed=3)
    sd = tm.state_dict()
    _, params = _port_mlp()
    params = from_torch_state_dict(params, sd, device="cpu")
    back = to_torch_state_dict(params, sd)
    assert list(back) == list(sd)
    jax_back = jax_to_torch(jax_from_torch(_jax_mlp_params(), sd), sd)
    for k in sd:
        assert torch.equal(back[k], sd[k])
        np.testing.assert_array_equal(back[k].numpy(), jax_back[k])
    tm.load_state_dict(back)  # torch takes the export as it is


def _tiny_conv_net():
    torch.manual_seed(1)
    tnet = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, padding=1), torch.nn.BatchNorm2d(8),
                               torch.nn.ReLU())
    tnet.train()
    with torch.no_grad():
        tnet(torch.randn(16, 3, 8, 8))  # non-trivial running stats
    tnet.eval()
    return tnet


def test_torch_conv_bn_import():
    """OIHW -> HWIO and running stats into batch_stats, bit-equal to the
    JAX converter on flax's TinyConvNet; the flax forward with the port's
    import reproduces torch's."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    class TinyConvNet(nn.Module):
        @nn.compact
        def __call__(self, x, train=False):
            x = nn.Conv(8, (3, 3), use_bias=True)(x)
            x = nn.BatchNorm(use_running_average=not train)(x)
            return nn.relu(x)

    tnet = _tiny_conv_net()
    module = TinyConvNet()
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), train=False)
    aux = {k: v for k, v in variables.items() if k != "params"}
    want_p, want_aux = jax_from_torch(variables["params"], tnet.state_dict(), aux=aux)
    params, new_aux = from_torch_state_dict(
        params_from_flax(variables["params"], device="cpu"), tnet.state_dict(),
        aux={"batch_stats": params_from_flax(aux["batch_stats"], device="cpu")}, device="cpu")
    _assert_trees_bit_equal(params, want_p)
    _assert_trees_bit_equal(new_aux["batch_stats"], want_aux["batch_stats"])
    x = np.random.default_rng(1).normal(size=(4, 8, 8, 3)).astype(np.float32)
    with torch.no_grad():
        want = tnet(torch.as_tensor(x.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1).numpy()
    ported = {"params": {m: {k: jnp.asarray(v.numpy()) for k, v in leaves.items()}
                         for m, leaves in params.items()},
              "batch_stats": {m: {k: jnp.asarray(v.numpy()) for k, v in leaves.items()}
                              for m, leaves in new_aux["batch_stats"].items()}}
    got = module.apply(ported, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-4)
    torch.testing.assert_close(new_aux["batch_stats"]["BatchNorm_0"]["mean"],
                               tnet[1].running_mean, rtol=0, atol=1e-6)
    # ...and back: the export is torch's state_dict minus its step counter.
    back = to_torch_state_dict(params, tnet.state_dict(), aux=new_aux)
    assert list(back) == [k for k in tnet.state_dict() if not k.endswith("num_batches_tracked")]
    for k, v in back.items():
        assert torch.equal(v, tnet.state_dict()[k]), k


def port_from_torch(params, state_dict):
    return from_torch_state_dict(params, state_dict, device="cpu")


def test_mismatch_raises():
    _, params = _port_mlp()
    jparams = _jax_mlp_params()
    torch.manual_seed(0)
    bad = torch.nn.Sequential(torch.nn.Linear(784, 64), torch.nn.Linear(64, 10))
    for convert, p in ((jax_from_torch, jparams), (port_from_torch, params)):
        with pytest.raises(ValueError, match="module count|does not map"):
            convert(p, bad.state_dict())
    extra = torch.nn.Sequential(torch.nn.Linear(784, 256), torch.nn.Linear(256, 128),
                                torch.nn.Linear(128, 10), torch.nn.Linear(10, 10))
    for convert, p in ((jax_from_torch, jparams), (port_from_torch, params)):
        with pytest.raises(ValueError, match="module count"):
            convert(p, extra.state_dict())
    wrong_width = torch.nn.Sequential(torch.nn.Linear(784, 256), torch.nn.Linear(256, 64),
                                      torch.nn.Linear(64, 10))
    with pytest.raises(ValueError) as theirs:
        jax_from_torch(jparams, wrong_width.state_dict())
    with pytest.raises(ValueError) as ours:
        from_torch_state_dict(params, wrong_width.state_dict(), device="cpu")
    assert str(ours.value) == str(theirs.value)


def test_export_template_underrun_raises():
    _, params = _port_mlp()
    small = torch.nn.Sequential(torch.nn.Linear(784, 256), torch.nn.Linear(256, 128))
    with pytest.raises(ValueError, match="consumed") as ours:
        to_torch_state_dict(params, small.state_dict())
    with pytest.raises(ValueError, match="consumed") as theirs:
        jax_to_torch(_jax_mlp_params(), small.state_dict())
    assert str(ours.value) == str(theirs.value)


def test_imports_land_on_the_device_argument(monkeypatch):
    _, params = _port_mlp()
    sd = _torch_mlp().state_dict()
    assert all(v.device.type == "cpu" for _, v in
               tree_items(from_torch_state_dict(params, sd, device="cpu")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for convert, arg in ((from_torch_state_dict, sd),
                         (from_keras_weights, to_keras_weights(params))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            convert(params, arg)


# --- Keras (the reference's second framework) ---------------------------------


def _keras():
    try:
        import keras

        return keras
    except Exception as e:  # pragma: no cover - env-dependent
        pytest.skip(f"keras unavailable: {e}")


def _keras_mlp(keras):
    return keras.Sequential([keras.layers.Input((784,)),
                             keras.layers.Dense(256, activation="relu"),
                             keras.layers.Dense(128, activation="relu"),
                             keras.layers.Dense(10)])


def test_keras_mlp_import_forward_parity():
    keras = _keras()
    km = _keras_mlp(keras)
    module, params = _port_mlp()
    params = from_keras_weights(params, km.get_weights(), device="cpu")
    _assert_trees_bit_equal(params, jax_from_keras(_jax_mlp_params(), km.get_weights()))
    x = np.random.default_rng(0).normal(size=(4, 784)).astype(np.float32)
    want = np.asarray(km(x))
    with torch.no_grad():
        got = _port_forward(module, params, x.reshape(4, 28, 28)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_keras_weights_round_trip():
    keras = _keras()
    km = _keras_mlp(keras)
    want = km.get_weights()
    _, params = _port_mlp()
    params = from_keras_weights(params, want, device="cpu")
    got = to_keras_weights(params)
    theirs = jax_to_keras(jax_from_keras(_jax_mlp_params(), want))
    assert len(got) == len(want) == len(theirs)
    for g, w, t in zip(got, want, theirs):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, t)
    km.set_weights(got)  # keras accepts the exported list


def test_keras_batchnorm_stats_roundtrip():
    """ResNet-18 (one stage): BatchNorm exports [gamma, beta, mean, var];
    the port's export of the JAX model's params equals the JAX export, and
    a perturbed list round-trips exactly."""
    import jax.numpy as jnp

    from tpfl.models import create_model

    jm = create_model("resnet18", (8, 8, 3), seed=0, out_channels=10, stage_sizes=(1,),
                      compute_dtype=jnp.float32)
    params = params_from_flax(jm.get_parameters(), device="cpu")
    aux = {"batch_stats": params_from_flax(jm.aux_state["batch_stats"], device="cpu")}
    flat = to_keras_weights(params, aux)
    theirs = jax_to_keras(jm.get_parameters(), jm.aux_state)
    assert len(flat) == len(theirs)
    for g, t in zip(flat, theirs):
        np.testing.assert_array_equal(g, np.asarray(t))
    perturbed = [np.asarray(a) + 1.0 for a in flat]
    new_params, new_aux = from_keras_weights(params, perturbed, aux, device="cpu")
    again = to_keras_weights(new_params, new_aux)
    assert len(again) == len(perturbed)
    for g, w in zip(again, perturbed):
        np.testing.assert_array_equal(g, w)
    jp, jaux = jax_from_keras(jm.get_parameters(), perturbed, jm.aux_state)
    _assert_trees_bit_equal(new_params, jp)
    _assert_trees_bit_equal(new_aux["batch_stats"], jaux["batch_stats"])
    # The port's own ResNet-18 exports as many arrays in the same shapes.
    module = ResNet18(out_channels=10, stage_sizes=(1,), compute_dtype=torch.float32)
    own_p, own_aux = init_state(module, (8, 8, 3), seed=0, device="cpu")
    assert [a.shape for a in to_keras_weights(own_p, own_aux)] == [a.shape for a in flat]


def test_keras_count_mismatch_raises():
    module = MLP(hidden_sizes=(16,), out_channels=10, compute_dtype=torch.float32)
    params, _ = init_state(module, (28, 28), seed=0, device="cpu")
    flat = to_keras_weights(params)
    with pytest.raises(ValueError, match="exhausted"):
        from_keras_weights(params, flat[:-1], device="cpu")
    with pytest.raises(ValueError, match="trailing"):
        from_keras_weights(params, flat + [flat[-1]], device="cpu")
    bad = list(flat)
    bad[0] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="does not map") as ours:
        from_keras_weights(params, bad, device="cpu")
    import jax.numpy as jnp

    from tpfl.models import create_model

    jparams = create_model("mlp", (28, 28), seed=0, hidden_sizes=(16,),
                           compute_dtype=jnp.float32).get_parameters()
    with pytest.raises(ValueError, match="does not map") as theirs:
        jax_from_keras(jparams, bad)
    assert str(ours.value) == str(theirs.value)
