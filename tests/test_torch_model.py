"""The port's TpflModel (tpfl_torch.learning.model) against the JAX
package's, on the CPU, from the same params (a small CNN drawn by flax
and carried across by ``model_state_from_jax``).

Each case runs the same call on both models and holds the results equal:
wire bytes (v1 / v3, ``WIRE_DTYPE`` downcasts), ``build_copy(params=
bytes)`` with its metadata and dtype restore, ``set_parameters`` from a
flat leaf list (JAX's pytree order), flat leaf lists, and the
``ModelNotMatchingError`` cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.exceptions import ModelNotMatchingError as JaxModelNotMatchingError
from tpfl.models import create_model as jax_create_model
from tpfl.settings import Settings as JaxSettings
from tpfl_torch.exceptions import ModelNotMatchingError
from tpfl_torch.interop import model_state_from_jax, params_to_numpy
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.models import CNN
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import tree_items


@pytest.fixture
def models():
    jm = jax_create_model("cnn", (8, 8, 3), seed=0, channels=(4, 8), dense=16)
    jm.set_contribution(["node-0", "node-1"], 12)
    jm.add_info("fedprox", {"mu": 0.25})
    tm = TpflModel(module=CNN(channels=(4, 8), dense=16),
                   **model_state_from_jax(jm, device="cpu"))
    return jm, tm


@pytest.fixture
def wire_settings():
    snap, jsnap = Settings.snapshot(), JaxSettings.snapshot()
    yield
    Settings.restore(snap)
    JaxSettings.restore(jsnap)


def _set_both(**knobs):
    for k, v in knobs.items():
        setattr(Settings, k, v)
        setattr(JaxSettings, k, v)


def _assert_params_equal(tparams, jparams):
    got = dict(tree_items(params_to_numpy(tparams)))
    want = dict(tree_items(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32)
                                                  if a.dtype == jnp.bfloat16 else np.asarray(a),
                                                  jparams)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("wire_format", [1, 3])
@pytest.mark.parametrize("wire_dtype", [None, "bfloat16", "float16"])
def test_encode_parameters_byte_equal(models, wire_settings, wire_format, wire_dtype):
    jm, tm = models
    _set_both(WIRE_FORMAT=wire_format, WIRE_DTYPE=wire_dtype, WIRE_CODEC="dense")
    assert tm.encode_parameters() == jm.encode_parameters()
    # After a set_parameters both hold JAX's pytree order.
    jm.set_parameters(jm.get_parameters())
    tm.set_parameters(tm.get_parameters())
    assert tm.encode_parameters(trace_id="t") == jm.encode_parameters(trace_id="t")


@pytest.mark.parametrize("codec", ["quant8", "topk+quant8+zlib"])
def test_encode_parameters_codec_byte_equal(models, wire_settings, codec):
    jm, tm = models
    _set_both(WIRE_CODEC=codec, WIRE_TOPK_FRAC=0.25)
    assert tm.encode_parameters() == jm.encode_parameters()


def test_wire_delta_refused_without_a_base(models, wire_settings):
    """``WIRE_DELTA`` belongs to the node runtime, which picks the delta
    base: the encoder refuses it rather than send a dense payload, and a
    residual asked for by ``delta_base=`` is byte-equal to the JAX one."""
    jm, tm = models
    _set_both(WIRE_DELTA=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tm.encode_parameters()
    base = (3, b"fp", tm.get_parameters())
    jbase = (3, b"fp", jm.get_parameters())
    assert tm.encode_parameters(delta_base=base) == jm.encode_parameters(delta_base=jbase)


@pytest.mark.parametrize("wire_dtype", [None, "bfloat16"])
def test_build_copy_from_bytes_restores_dtype_and_metadata(models, wire_settings, wire_dtype):
    jm, tm = models
    _set_both(WIRE_DTYPE=wire_dtype)
    payload = jm.encode_parameters()
    jc = jm.build_copy(params=payload)
    tc = tm.build_copy(params=payload)
    assert tc.get_contributors() == jc.get_contributors() == ["node-0", "node-1"]
    assert tc.get_num_samples() == jc.get_num_samples() == 12
    assert float(tc.get_info("fedprox")["mu"]) == 0.25
    for _, leaf in tree_items(tc.get_parameters()):
        assert leaf.dtype == torch.float32 and leaf.device.type == "cpu"
    _assert_params_equal(tc.get_parameters(), jc.get_parameters())
    assert tc.encode_parameters() == jc.encode_parameters()


def test_set_parameters_from_bytes_and_ref(models):
    jm, tm = models
    payload = tm.encode_parameters()
    fresh = tm.build_copy()
    fresh.set_parameters(payload)
    assert fresh.get_contributors() == ["node-0", "node-1"]
    _assert_params_equal(fresh.get_parameters(), jm.get_parameters())
    other = tm.build_copy(params=tm.as_ref())
    _assert_params_equal(other.get_parameters(), jm.get_parameters())


def test_flat_lists_follow_jax_order(models):
    jm, tm = models
    jlist, tlist = jm.get_parameters_list(), tm.get_parameters_list()
    assert len(tlist) == len(jlist)
    for t, j in zip(tlist, jlist):
        np.testing.assert_array_equal(t, j)
    rng = np.random.default_rng(0)
    new = [rng.normal(size=np.shape(x)).astype(np.float32) for x in jlist]
    jm.set_parameters(new)
    tm.set_parameters(new)
    _assert_params_equal(tm.get_parameters(), jm.get_parameters())
    assert tm.encode_parameters() == jm.encode_parameters()


MISMATCHES = {
    "leaf count": lambda p: p[:-1],
    "shape": lambda p: p[:-1] + [np.zeros((3,), np.float32)],
}


@pytest.mark.parametrize("case", list(MISMATCHES))
def test_model_not_matching(models, case):
    jm, tm = models
    bad = MISMATCHES[case](jm.get_parameters_list())
    with pytest.raises(JaxModelNotMatchingError):
        jm.set_parameters(bad)
    with pytest.raises(ModelNotMatchingError):
        tm.set_parameters(bad)


def test_model_not_matching_tree(models):
    jm, tm = models
    small = jax_create_model("cnn", (8, 8, 3), seed=0, channels=(4, 4), dense=16)
    with pytest.raises(JaxModelNotMatchingError):
        jm.set_parameters(small.encode_parameters())
    with pytest.raises(ModelNotMatchingError):
        tm.set_parameters(small.encode_parameters())


def test_metadata_and_copies(models):
    jm, tm = models
    assert tm.num_parameters == jm.num_parameters
    assert tm.get_framework() == "torch"
    with pytest.raises(ValueError):
        TpflModel(device="cpu").get_contributors()
    with pytest.raises(ValueError):
        tm.set_num_samples(-1)
    c = tm.build_copy(params=tm.get_parameters(), contributors=["x"], num_samples=3)
    assert (c.get_contributors(), c.get_num_samples()) == (["x"], 3)
    assert tm.get_contributors() == ["node-0", "node-1"]
    tm.apply_to_params(lambda p: -p)
    jm.apply_to_params(lambda p: -p)
    _assert_params_equal(tm.get_parameters(), jm.get_parameters())
    _assert_params_equal(c.get_parameters(), jax.tree_util.tree_map(lambda p: -p,
                                                                    jm.get_parameters()))
