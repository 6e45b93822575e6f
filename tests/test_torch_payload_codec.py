"""The port's v2 codec envelopes (tpfl_torch.learning.compression's host
payload path) against the JAX package's, on the CPU.

- v2 envelopes are byte-equal under ``quant8``, ``topk``,
  ``topk+quant8`` and with ``+zlib`` (each package decodes the other's,
  leaves bit-equal);
- ``pytree_fingerprint`` and a ``BaseCache``'s fingerprint are
  byte-equal, and so are delta (residual) payloads against the base;
- a base this node does not hold gives ``DeltaBaseMismatchError``;
- zstd behaves as the reference without ``zstandard``: decode refuses.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpfl.learning import compression as jcomp
from tpfl_torch.exceptions import DecodingParamsError, DeltaBaseMismatchError
from tpfl_torch.learning import compression as tcomp


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "conv": rng.normal(size=(3, 3, 3, 8)).astype(np.float32),
        "bias": rng.normal(size=(8,)).astype(np.float32),
        "bf16": rng.normal(size=(6, 5)).astype(np.float32),
        "one": rng.normal(size=(1,)).astype(np.float32),
        "ids": rng.integers(0, 9, size=(7,)).astype(np.int32),
        "empty": np.zeros((0,), np.float32),
        "zero": np.zeros((4,), np.float32),
    }


def _jax(a):
    return {"Conv_0": {"kernel": jnp.asarray(a["conv"]), "bias": jnp.asarray(a["bias"])},
            "h": jnp.asarray(a["bf16"]).astype(jnp.bfloat16), "one": jnp.asarray(a["one"]),
            "ids": jnp.asarray(a["ids"]), "empty": jnp.asarray(a["empty"]),
            "zero": jnp.asarray(a["zero"])}


def _torch(a):
    return {"Conv_0": {"kernel": torch.from_numpy(a["conv"]),
                       "bias": torch.from_numpy(a["bias"])},
            "h": torch.from_numpy(a["bf16"]).to(torch.bfloat16),
            "one": torch.from_numpy(a["one"]), "ids": torch.from_numpy(a["ids"]),
            "empty": torch.from_numpy(a["empty"]), "zero": torch.from_numpy(a["zero"])}


def _host(tree):
    """Decoded leaves of either package as f32-or-int numpy (bf16 widened)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return (tree.float() if tree.dtype == torch.bfloat16 else tree).numpy()
    a = np.asarray(tree)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_trees_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k])
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


INFO = {"scaffold": {"delta": np.ones((2,), np.float32)}, "mu": 0.5, "t": (1, 2)}
CODECS = ["quant8", "topk", "topk+quant8", "quant8+zlib", "topk+zlib", "topk+quant8+zlib",
          "zlib", "dense"]


@pytest.mark.parametrize("codec", CODECS)
def test_v2_envelopes_byte_equal(codec):
    a = _arrays()
    want = jcomp.encode_model_payload(_jax(a), ["n0", "n1"], 11, INFO, codec, topk_frac=0.3,
                                      level=1, trace_id="tid")
    got = tcomp.encode_model_payload(_torch(a), ["n0", "n1"], 11, INFO, codec, topk_frac=0.3,
                                     level=1, trace_id="tid")
    assert got == want
    assert tcomp.payload_version(got) == 2
    assert tcomp.payload_codec(got) == jcomp.payload_codec(want)
    assert not tcomp.payload_is_delta(got)


@pytest.mark.parametrize("codec", ["quant8", "topk+quant8+zlib"])
def test_v2_each_package_decodes_the_other(codec):
    a = _arrays(1)
    jpay = jcomp.encode_model_payload(_jax(a), ["n0"], 3, INFO, codec, topk_frac=0.2)
    tpay = tcomp.encode_model_payload(_torch(a), ["n0"], 3, INFO, codec, topk_frac=0.2)
    jp, jc, jn, ji = jcomp.decode_model_payload(tpay)
    tp, tc, tn, ti = tcomp.decode_model_payload(jpay)
    _assert_trees_equal(_host(tp), _host(jp))
    assert (tc, tn, ti["mu"], ti["t"]) == (jc, jn, ji["mu"], ji["t"])
    assert isinstance(tp["h"], torch.Tensor) and tp["h"].dtype == torch.bfloat16


def _bases(seed):
    a = _arrays(seed)
    jbase = {"Conv_0": {"kernel": a["conv"], "bias": a["bias"]},
             "h": a["bf16"].astype(ml_dtypes.bfloat16), "one": a["one"], "ids": a["ids"],
             "empty": a["empty"], "zero": a["zero"]}
    jcache, tcache = jcomp.BaseCache(), tcomp.BaseCache()
    jcache.put(4, jbase)
    tcache.put(4, _torch(a))
    return jcache, tcache


def test_fingerprints_byte_equal():
    a = _arrays(2)
    assert tcomp.pytree_fingerprint(_torch(a)) == jcomp.pytree_fingerprint(_jax(a))
    jcache, tcache = _bases(2)
    assert tcache.get(4)[0] == jcache.get(4)[0]


@pytest.mark.parametrize("codec", ["quant8", "dense", "topk+zlib"])
def test_delta_payloads_byte_equal_and_decode(codec):
    jcache, tcache = _bases(3)
    fp = jcache.get(4)[0]
    a = _arrays(4)
    want = jcomp.encode_model_payload(_jax(a), ["n0"], 5, {}, codec,
                                      delta_base=(4, fp, jcache.get(4)[1]), topk_frac=0.4)
    got = tcomp.encode_model_payload(_torch(a), ["n0"], 5, {}, codec,
                                     delta_base=(4, fp, tcache.get(4)[1]), topk_frac=0.4)
    assert got == want
    assert tcomp.payload_is_delta(got)
    tp = tcomp.decode_model_payload(want, bases=tcache)[0]
    jp = jcomp.decode_model_payload(got, bases=jcache)[0]
    _assert_trees_equal(_host(tp), _host(jp))


def test_base_mismatch_raises():
    jcache, tcache = _bases(5)
    fp = jcache.get(4)[0]
    payload = tcomp.encode_model_payload(_torch(_arrays(6)), ["n0"], 1, {}, "quant8",
                                         delta_base=(4, fp, tcache.get(4)[1]))
    with pytest.raises(DeltaBaseMismatchError):
        tcomp.decode_model_payload(payload)
    with pytest.raises(DeltaBaseMismatchError):
        tcomp.decode_model_payload(payload, bases=tcomp.BaseCache())
    other = tcomp.BaseCache()
    other.put(4, _torch(_arrays(7)))
    with pytest.raises(DeltaBaseMismatchError):
        tcomp.decode_model_payload(payload, bases=other)


def test_base_cache_keeps_the_last_rounds():
    cache = tcomp.BaseCache()
    for r in range(5):
        cache.put(r, {"w": torch.full((2,), float(r))})
    assert [r for r in range(5) if cache.get(r)] == [2, 3, 4]


def test_zstd_payload_refused_without_the_package():
    body = tcomp._msgpack.packb({"w": None})
    import zlib
    payload = bytes([2, tcomp.ZSTD]) + tcomp._msgpack.packb(
        {"contributors": ["a"], "num_samples": 1, "info": {}, "body": body,
         "crc": zlib.crc32(body)})
    with pytest.raises(DecodingParamsError, match="zstandard"):
        tcomp.decode_model_payload(payload)


@pytest.mark.parametrize("mutate", ["crc", "truncate", "not v2"])
def test_corrupt_v2_raises(mutate):
    payload = tcomp.encode_model_payload(_torch(_arrays()), ["a"], 1, {}, "quant8")
    bad = {"crc": payload[:-2] + bytes([payload[-2] ^ 1]) + payload[-1:],
           "truncate": payload[:40], "not v2": b"\x03" + payload[1:]}[mutate]
    with pytest.raises(DecodingParamsError):
        tcomp.decode_model_payload(bad)
