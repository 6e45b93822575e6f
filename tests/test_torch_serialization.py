"""The port's wire envelopes (tpfl_torch.learning.serialization and its
msgpack subset) against the JAX package's, on the CPU.

- ``_msgpack.packb`` gives ``msgpack.packb(obj, use_bin_type=True)``'s
  bytes at every width boundary of ints, strs, bins, arrays and maps,
  and ``unpackb`` gives ``msgpack.unpackb(raw=False,
  strict_map_key=False)``'s objects; malformed input raises ValueError.
- v1 and v3 payloads of the same tree (f32, bf16, int32, bool, 0-d,
  empty and non-contiguous leaves; tuples and scalars in ``info``) are
  byte-equal across the packages, and each package decodes the other's.
- Corrupt bytes give ``DecodingParamsError``.
"""

import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from tpfl.exceptions import DecodingParamsError as JaxDecodingParamsError
from tpfl.learning import serialization as jser
from tpfl_torch.exceptions import DecodingParamsError
from tpfl_torch.learning import _msgpack
from tpfl_torch.learning import serialization as tser
from tpfl_torch.learning.bufferpool import BufferPool

_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
         -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
_SIZES = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]

MSGPACK_CASES = (
    [("int", v) for v in _INTS]
    + [("float", v) for v in (0.0, 0.5, -1e300, float("inf"), 3.14159)]
    + [("str", "a" * n) for n in _SIZES] + [("str", "é☃ü")]
    + [("bin", b"x" * n) for n in _SIZES]
    + [("array", list(range(n))) for n in (0, 15, 16, 65536)]
    + [("map", {f"k{i}": i for i in range(n)}) for n in (0, 15, 16, 65536)]
    + [("nil", None), ("bool", True), ("bool", False), ("tuple", (1, "x", None)),
       ("memoryview", memoryview(b"abc")), ("mixed keys", {1: "x", b"k": [None, 2.5]}),
       ("leaf", {"__nd__": 3, "d": "float32", "s": [3, 4], "o": 64, "n": 48})]
)


@pytest.mark.parametrize("kind,obj", MSGPACK_CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(MSGPACK_CASES)])
def test_msgpack_subset_matches_msgpack(kind, obj):
    ours = _msgpack.packb(obj)
    assert ours == msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.unpackb(ours) == msgpack.unpackb(ours, raw=False, strict_map_key=False)


@pytest.mark.parametrize("data", [b"", b"\xc1", b"\x92\x01", b"\x01\x02", b"\xd9\x05ab",
                                  b"\xa2\xff\xfe", b"\xc7\x01\x00\x00", b"\x81\x90\x01"])
def test_msgpack_malformed_raises_value_error(data):
    with pytest.raises(ValueError):
        _msgpack.unpackb(data)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "bf16": rng.normal(size=(4, 7)).astype(np.float32),
        "i32": rng.integers(-5, 5, size=(6,)).astype(np.int32),
        "bool": rng.integers(0, 2, size=(3, 2)).astype(bool),
        "scalar": np.float32(3.5),
        "empty": np.zeros((0, 3), np.float32),
        "strided": rng.normal(size=(5, 4)).astype(np.float32),
    }


def _jax_tree(a):
    return {"Dense_0": {"kernel": jnp.asarray(a["f32"]),
                        "bias": jnp.asarray(a["bf16"]).astype(jnp.bfloat16)},
            "i": jnp.asarray(a["i32"]), "b": jnp.asarray(a["bool"]),
            "z": jnp.asarray(a["scalar"]), "e": jnp.asarray(a["empty"]),
            "t": a["strided"].T}


def _torch_tree(a):
    return {"Dense_0": {"kernel": torch.from_numpy(a["f32"]),
                        "bias": torch.from_numpy(a["bf16"]).to(torch.bfloat16)},
            "i": torch.from_numpy(a["i32"]), "b": torch.from_numpy(a["bool"]),
            "z": torch.tensor(a["scalar"]), "e": torch.from_numpy(a["empty"]),
            "t": torch.from_numpy(a["strided"]).T}


INFO = {"mu": 0.01, "t": (1, "x", 2.5), "arr": np.arange(3, dtype=np.int64), "n": None,
        "nested": {"c": np.ones((2, 2), np.float32)}}
ENCODERS = {
    "v1": (jser.encode_model_payload, tser.encode_model_payload),
    "v3": (jser.encode_model_payload_v3, tser.encode_model_payload_v3),
}


@pytest.mark.parametrize("version", list(ENCODERS))
@pytest.mark.parametrize("trace_id", [None, "0123456789abcdef"])
def test_payloads_byte_equal_across_packages(version, trace_id):
    a = _arrays()
    jenc, tenc = ENCODERS[version]
    want = jenc(_jax_tree(a), ["node-0", "node-1"], 7, INFO, trace_id=trace_id)
    got = tenc(_torch_tree(a), ["node-0", "node-1"], 7, INFO, trace_id=trace_id)
    assert got == want
    assert tser.payload_wire_version(got) == jser.payload_wire_version(want)


def _assert_decoded(tree, a, bf16_as):
    np.testing.assert_array_equal(np.asarray(tree["Dense_0"]["kernel"]), a["f32"])
    bias = tree["Dense_0"]["bias"]
    bias = bias.float().numpy() if isinstance(bias, torch.Tensor) else np.asarray(bias, np.float32)
    np.testing.assert_array_equal(bias, a["bf16"].astype(ml_dtypes.bfloat16).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(tree["i"]), a["i32"])
    np.testing.assert_array_equal(np.asarray(tree["b"]), a["bool"])
    assert np.asarray(tree["z"]).shape == () and float(np.asarray(tree["z"])) == 3.5
    assert np.asarray(tree["e"]).shape == (0, 3)
    np.testing.assert_array_equal(np.asarray(tree["t"]), a["strided"].T)
    assert isinstance(tree["Dense_0"]["bias"], bf16_as)


@pytest.mark.parametrize("version", list(ENCODERS))
def test_each_package_decodes_the_others_payload(version):
    a = _arrays(1)
    jenc, tenc = ENCODERS[version]
    from_jax = jenc(_jax_tree(a), ["a"], 3, INFO)
    from_port = tenc(_torch_tree(a), ["a"], 3, INFO)
    params, contribs, n, info = tser.decode_model_payload(from_jax)
    _assert_decoded(params, a, torch.Tensor)
    assert (contribs, n, info["t"], info["mu"]) == (["a"], 3, (1, "x", 2.5), 0.01)
    np.testing.assert_array_equal(info["nested"]["c"], np.ones((2, 2), np.float32))
    params, contribs, n, info = jser.decode_model_payload(from_port)
    _assert_decoded(params, a, np.ndarray)
    assert (contribs, n, info["t"]) == (["a"], 3, (1, "x", 2.5))


def test_decoded_leaves_are_read_only_views():
    payload = tser.encode_model_payload_v3(_torch_tree(_arrays()), ["a"], 1, {})
    params, _, _, _ = tser.decode_model_payload(payload)
    assert not params["Dense_0"]["kernel"].flags.writeable
    with pytest.raises(ValueError):
        params["Dense_0"]["kernel"][0, 0] = 1.0


def test_pytree_roundtrip_and_bytes_match():
    a = _arrays(2)
    want = jser.encode_pytree(_jax_tree(a))
    got = tser.encode_pytree(_torch_tree(a))
    assert got == want
    _assert_decoded(tser.decode_pytree(want), a, torch.Tensor)


def test_strided_leaf_goes_through_the_pool():
    pool = BufferPool()
    t = torch.arange(20, dtype=torch.float32).reshape(4, 5).T
    payload = tser.encode_model_payload_v3({"w": t}, ["a"], 1, {}, pool=pool)
    assert pool.misses == 1 and pool.outstanding == 0
    params, _, _, _ = tser.decode_model_payload(payload)
    np.testing.assert_array_equal(params["w"], t.numpy())


def test_by_reference_payload_freezes_and_copies():
    arr = np.ones(3, np.float32)
    ref = tser.InprocModelRef({"w": arr}, ["a"], 2, {"k": arr})
    assert tser.payload_wire_version(ref) == 0 and tser.is_byref(ref) and len(ref) == 0
    params, contribs, n, info = tser.decode_model_payload(ref)
    assert not params["w"].flags.writeable and not info["k"].flags.writeable
    contribs.append("b")
    assert ref.contributors == ["a"] and n == 2


def _corrupt_payloads():
    good3 = tser.encode_model_payload_v3({"w": torch.ones(4)}, ["a"], 1, {})
    good1 = tser.encode_model_payload({"w": torch.ones(4)}, ["a"], 1, {})
    return {
        "garbage": b"\xff\x00garbage",
        "v1 truncated": good1[:-3],
        "v1 bad version": msgpack.packb({"v": 9, "params": {}}, use_bin_type=True),
        "v1 not a map": msgpack.packb([1, 2], use_bin_type=True),
        "v3 preamble": b"\x03\x01",
        "v3 header truncated": good3[:8],
        "v3 payload truncated": good3[:-10],
        "v3 leaf out of range": good3[:5] + good3[5:].replace(b"\xa1o\x00", b"\xa1o\x7f", 1),
        "unknown dtype": tser._msgpack.packb({"v": 1, "params": {"w": {
            "__nd__": 1, "d": "float99", "s": [1], "b": b"\0" * 4}}, "contributors": [],
            "num_samples": 1, "info": {}}),
    }


@pytest.mark.parametrize("case", list(_corrupt_payloads()))
def test_corrupt_bytes_raise_decoding_error(case):
    data = _corrupt_payloads()[case]
    with pytest.raises(DecodingParamsError):
        tser.decode_model_payload(data)
    if case != "v3 leaf out of range":
        with pytest.raises(JaxDecodingParamsError):
            jser.decode_model_payload(data)
