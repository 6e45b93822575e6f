"""Parity of the port's wire codec (tpfl_torch.learning.compression) with
the JAX package's (tpfl.learning.compression), on the CPU.

Codec outputs are integers and exact decodes, so they are held bit for
bit: the port's tensor codecs against the reference's numpy oracles and
its jitted functions, on seeded leaves in f32, bf16 and f16, 0-d, empty,
size-1, all-zero and magnitude-tied. The byte accounting and the knob's
validation must agree exactly too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.learning import compression as ref
from tpfl.models import zoo as jzoo
from tpfl_torch.learning import compression as port
from tpfl_torch.models import zoo


def _leaf_zoo():
    """(label, numpy array) leaves; bf16 leaves are ml_dtypes arrays."""
    rng = np.random.default_rng(0)
    bf16 = jnp.bfloat16
    return [
        ("f32 16x8", rng.normal(size=(16, 8)).astype(np.float32)),
        ("f32 1000", rng.normal(size=(1000,)).astype(np.float32)),
        ("bf16 9", np.asarray(jnp.asarray(rng.normal(size=(9,)), bf16))),
        ("bf16 32x5", np.asarray(jnp.asarray(rng.normal(size=(32, 5)) * 3, bf16))),
        ("f16 4x3", rng.normal(size=(4, 3)).astype(np.float16)),
        ("f32 0-d", np.float32(2.5)),
        ("f32 0-d zero", np.float32(0.0)),
        ("f32 size-1", np.asarray([-0.75], np.float32)),
        ("f32 empty", np.zeros((0, 4), np.float32)),
        ("f32 all-zero", np.zeros((7, 3), np.float32)),
        ("f32 huge", np.full((4,), 1e30, np.float32)),
        ("f32 ties", np.asarray([2.0, -2.0, 2.0, 1.0, -1.0, 1.0, 0.0, 0.0], np.float32)),
        ("bf16 ties", np.asarray(jnp.asarray([0.5, -0.5, 0.25, 0.5, -0.25, 0.0], bf16))),
        # max 127 gives scale 1: every other value sits half way between
        # two steps, where round-half-to-even and round-half-away differ.
        ("f32 half-steps", np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 126.5],
                                      np.float32)),
    ]


LEAVES = _leaf_zoo()
IDS = [label for label, _ in LEAVES]


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bytes(t: torch.Tensor) -> bytes:
    """Raw bytes of a tensor (bf16 through its int16 view)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.contiguous().numpy().tobytes()


def _ref_bytes(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


@pytest.mark.parametrize("leaf", [a for _, a in LEAVES], ids=IDS)
def test_q8_bit_equal_to_reference(leaf):
    q, s = port.q8_encode(_torch(leaf))
    qn, sn = ref.q8_encode_np(leaf)
    qj, sj = ref._q8_encode(jnp.asarray(leaf))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    assert _bytes(q) == qn.tobytes() == _ref_bytes(qj)
    assert _bytes(s) == np.float32(sn).tobytes() == np.float32(sj).tobytes()
    d = port.q8_decode(q, s)
    assert _bytes(d) == ref.q8_decode_np(qn, sn).tobytes() == _ref_bytes(ref._q8_decode(qj, sj))
    # The port's copies of the oracles are the reference's.
    qp, sp = port.q8_encode_np(leaf)
    assert qp.tobytes() == qn.tobytes() and np.float32(sp) == np.float32(sn)
    assert port.q8_decode_np(qp, sp).tobytes() == ref.q8_decode_np(qn, sn).tobytes()


@pytest.mark.parametrize("leaf", [a for _, a in LEAVES], ids=IDS)
def test_topk_bit_equal_to_reference(leaf):
    size = int(np.size(leaf))
    for k in sorted({1, max(1, min(3, size)), max(1, size // 2), max(1, size)}):
        i, v = port.topk_encode(_torch(leaf), k)
        inp, vn = ref.topk_encode_np(leaf, k)
        assert i.dtype == torch.uint32
        assert np.array_equal(i.numpy(), inp), (size, k)
        assert _bytes(v) == vn.tobytes()
        if size:  # the jitted reference (lax.top_k) refuses an empty leaf
            ij, vj = ref._topk_encode(jnp.asarray(leaf), k)
            assert np.array_equal(i.numpy(), np.asarray(ij)) and _bytes(v) == _ref_bytes(vj)
        ip, vp = port.topk_encode_np(leaf, k)
        assert np.array_equal(ip, inp) and vp.tobytes() == vn.tobytes()


@pytest.mark.parametrize("frac", [0.05, 0.3])
@pytest.mark.parametrize("codec", ["dense", "quant8", "topk", "topk+quant8"])
def test_engine_roundtrip_bit_equal_to_reference(codec, frac):
    """One node's leaf round trip against the reference's jitted
    ``engine_codec_roundtrip``, dtype kept; the node-batched form gives
    each row what the one-node form gives it."""
    bits = port.resolve_engine_codec(codec)
    assert bits == ref.resolve_engine_codec(codec)
    one = port.engine_codec_roundtrip(bits, frac)
    nodes = port.engine_codec_roundtrip_nodes(bits, frac)
    want_fn = jax.jit(ref.engine_codec_roundtrip(bits, frac))
    for label, leaf in LEAVES + [("i32", np.arange(6, dtype=np.int32))]:
        x = _torch(leaf)
        got = one(x)
        want = np.asarray(want_fn(jnp.asarray(leaf)))
        assert got.dtype == x.dtype and tuple(got.shape) == want.shape, label
        assert _bytes(got) == _ref_bytes(want), label
        stacked = torch.stack([x, 2 * x, torch.zeros_like(x)]) if x.numel() else x[None]
        rows = nodes(stacked)
        for r in range(stacked.shape[0]):
            assert _bytes(rows[r]) == _bytes(one(stacked[r])), (label, r)


def _trees():
    """(label, port tree of tensors, reference tree of ShapeDtypeStructs)
    at the modules' default widths."""
    out = []
    for name, torch_module, jax_module, shape in (
        ("mlp", zoo.MLP(), jzoo.MLP(), (28, 28, 1)),
        ("cnn", zoo.CNN(), jzoo.CNN(), (32, 32, 3)),
        ("resnet18", zoo.ResNet18(out_channels=100), jzoo.ResNet18(out_channels=100),
         (32, 32, 3)),
    ):
        params, _ = zoo.init_state(torch_module, shape, seed=0, device="cpu")
        shapes = jax.eval_shape(lambda m=jax_module, s=shape: m.init(
            jax.random.PRNGKey(0), jnp.zeros((1, *s)), train=False))["params"]
        out.append((name, params, shapes))
    return out


def test_wire_bytes_per_model_equals_reference():
    for name, params, shapes in _trees():
        for codec in ("dense", "quant8", "topk", "topk+quant8"):
            bits = port.resolve_engine_codec(codec)
            for frac in (0.05, 0.3):
                got = port.wire_bytes_per_model(params, bits, frac)
                assert got == ref.wire_bytes_per_model(shapes, bits, frac), (name, codec, frac)
    mixed = {"w": torch.zeros(256, 256), "h": torch.zeros(64, dtype=torch.float16),
             "i": torch.zeros(8, dtype=torch.int32), "s": torch.tensor(1.0),
             "e": torch.zeros(0, 4)}
    mixed_ref = {"w": np.zeros((256, 256), np.float32), "h": np.zeros((64,), np.float16),
                 "i": np.zeros((8,), np.int32), "s": np.float32(1.0),
                 "e": np.zeros((0, 4), np.float32)}
    for bits in (0, port.QUANT8, port.TOPK, port.TOPK | port.QUANT8):
        assert port.wire_bytes_per_model(mixed, bits) == ref.wire_bytes_per_model(mixed_ref, bits)


SPECS = ["dense", "quant8", "topk", "topk+quant8", "quant8.topk", " Quant8 ", "quant8+zlib",
         "zlib", "zstd", "topk+zstd", "zlib+zstd", "delta", "quant16", 0, port.QUANT8,
         port.DELTA | port.QUANT8, port.ZLIB]


def _outcome(fn, spec):
    try:
        return ("ok", fn(spec))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", SPECS, ids=[repr(s) for s in SPECS])
def test_codec_resolution_matches_reference(spec):
    """Same bits, or the same ValueError with the same message."""
    assert _outcome(port.resolve_codec, spec) == _outcome(ref.resolve_codec, spec)
    assert _outcome(port.resolve_engine_codec, spec) == _outcome(ref.resolve_engine_codec, spec)
    bits = _outcome(ref.resolve_codec, spec)
    if bits[0] == "ok":
        assert port.codec_name(bits[1]) == ref.codec_name(bits[1])
        assert port.is_dense(spec) == ref.is_dense(spec)
