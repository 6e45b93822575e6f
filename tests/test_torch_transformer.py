"""Parity of the port's TransformerLM and of the engine on a token model
with the JAX package's, at a small size on the CPU.

JAX params reach the port through ``tpfl_torch.interop.params_from_flax``
(a three-level flax tree). The JAX flash kernels run in interpret mode.
f32 cases expect differences from reduction order only: rtol 1e-4,
atol 1e-5 (logits, engine), and atol 3e-5 on gradients (the JAX flash
suite's). One case holds the bf16 compute path at a bf16 tolerance that
the same port computing in f32 fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.models import TransformerLM as JaxLM
from tpfl.parallel.engine import FederationEngine as JaxEngine
from tpfl.parallel.flash_kernel import flash_attention as jax_flash
from tpfl_torch.interop import params_from_flax, params_to_numpy
from tpfl_torch.models import TransformerLM, create_model
from tpfl_torch.parallel import FederationEngine, VmapFederation
from tpfl_torch.parallel import flash_kernel as fk
from tpfl_torch.utils.tree import tree_items, tree_leaves, tree_map

RTOL, ATOL, GRAD_ATOL = 1e-4, 1e-5, 3e-5
LM = dict(vocab=64, dim=32, heads=4, n_layers=2, max_len=64)
N_NODES, BATCH, SEQ = 2, 2, 16


def _jax_lm(dtype=jnp.float32, flash=False):
    return JaxLM(**LM, compute_dtype=dtype, attention_fn=jax_flash if flash else None)


def _torch_lm(dtype=torch.float32, flash=False):
    return TransformerLM(**LM, compute_dtype=dtype,
                         attention_fn=fk.flash_attention if flash else None)


def _host(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _assert_tree_close(got_tree, want_tree, rtol, atol):
    got = dict(tree_items(params_to_numpy(got_tree)))
    want = dict(tree_items(_host(want_tree)))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=rtol, atol=atol, err_msg=path)


def _node_tokens_and_params(module):
    rng = np.random.default_rng(5)
    xs = rng.integers(0, LM["vocab"], (N_NODES, BATCH, SEQ)).astype(np.int32)
    ys = rng.integers(0, LM["vocab"], (N_NODES, BATCH, SEQ)).astype(np.int32)
    trees = [module.init(jax.random.PRNGKey(s), jnp.asarray(xs[0]))["params"]
             for s in range(N_NODES)]
    return xs, ys, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *trees)


def _jax_logits_and_grads(module, stacked, xs, ys):
    def node_loss(p, x, y):
        logits = module.apply({"params": p}, x)
        return jnp.mean(-jnp.take_along_axis(jax.nn.log_softmax(logits), y[..., None], -1))

    logits = jax.jit(jax.vmap(lambda p, x: module.apply({"params": p}, x)))(
        stacked, jnp.asarray(xs))
    grads = jax.jit(jax.vmap(jax.grad(node_loss)))(stacked, jnp.asarray(xs), jnp.asarray(ys))
    return np.asarray(logits), grads


def _jax_eager_logits(module, stacked, xs):
    """Per-node logits run op by op: XLA's CPU fusions may keep f32
    between bf16 ops, so only the eager program rounds at every op as
    the port does."""
    return np.asarray(jax.vmap(lambda p, x: module.apply({"params": p}, x))(
        stacked, jnp.asarray(xs)))


def _torch_logits_and_grads(model, stacked, xs, ys):
    params = params_from_flax(_host(stacked), device="cpu")
    for v in tree_leaves(params):
        v.requires_grad_(True)
    logits = model(params, torch.from_numpy(xs))
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, LM["vocab"]), torch.from_numpy(ys).reshape(-1).long(),
        reduction="none").reshape(N_NODES, -1).mean(1).sum()
    loss.backward()
    return logits.detach().numpy(), tree_map(lambda v: v.grad, params)


@pytest.mark.parametrize("flash", [False, True], ids=["blockwise", "flash"])
def test_lm_logits_and_node_grads_match_jax(flash):
    module = _jax_lm(flash=flash)
    xs, ys, stacked = _node_tokens_and_params(module)
    logits_j, grads_j = _jax_logits_and_grads(module, stacked, xs, ys)
    logits_t, grads_t = _torch_logits_and_grads(_torch_lm(flash=flash), stacked, xs, ys)
    np.testing.assert_allclose(logits_t, logits_j, rtol=RTOL, atol=ATOL)
    _assert_tree_close(grads_t, grads_j, RTOL, GRAD_ATOL)


# bf16 compute, logits held against the JAX model run op by op: the
# port rounds at the same ops (LayerNorm's one cast, the bf16 Dense bias
# add, jax.nn.gelu's per-op bf16, the bf16 residual adds). With blockwise
# attention its logits equal JAX's (1e-6 of the largest logit allows for
# f32 summation order; measured 1e-8). The flash path's P rounding falls
# on another online-softmax max (JAX's 16-key block, the port's 64-key
# tile), so its logits may sit a few bf16 roundings apart: rtol 2^-8 plus
# 2^-8 of the largest logit (measured 1.8e-3). The same port computing in
# f32 misses that by over 2x (8.8e-3). Gradients (against the jitted JAX
# program) run through autograd's and XLA's VJPs, which round their bf16
# sums (embedding scatter-adds, bias reductions) in other orders: 2^-5 of
# each leaf's largest entry (measured 1.9e-2; the f32 port sits as close,
# so the gradients do not tell the two apart).
BF16_LOGIT_TOL, BF16_GRAD_ATOL_REL = 2.0 ** -8, 2.0 ** -5


def _bf16_logits_close(got, want, tol=BF16_LOGIT_TOL):
    return np.allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max()))


def _bf16_grad_close(got, want):
    return np.allclose(got, want, rtol=0.0, atol=BF16_GRAD_ATOL_REL * float(np.abs(want).max()))


def test_bf16_lm_matches_jax_bf16():
    module = _jax_lm(dtype=jnp.bfloat16, flash=True)
    xs, ys, stacked = _node_tokens_and_params(module)
    logits_j = _jax_eager_logits(module, stacked, xs)
    grads_j = dict(tree_items(_host(_jax_logits_and_grads(module, stacked, xs, ys)[1])))
    logits_t, grads_t = _torch_logits_and_grads(
        _torch_lm(dtype=torch.bfloat16, flash=True), stacked, xs, ys)
    assert _bf16_logits_close(logits_t, logits_j)
    for path, got in tree_items(params_to_numpy(grads_t)):
        assert _bf16_grad_close(got, grads_j[path]), path

    logits_f, _ = _torch_logits_and_grads(_torch_lm(flash=True), stacked, xs, ys)
    assert not _bf16_logits_close(logits_f, logits_j)


def test_bf16_lm_blockwise_rounds_as_eager_jax():
    module = _jax_lm(dtype=jnp.bfloat16)
    xs, _, stacked = _node_tokens_and_params(module)
    want = _jax_eager_logits(module, stacked, xs)
    got = _torch_lm(dtype=torch.bfloat16)(params_from_flax(_host(stacked), device="cpu"),
                                          torch.from_numpy(xs))
    assert _bf16_logits_close(got.numpy(), want, tol=1e-6)


def _lm_data(n, nb=1, bs=2, s=16, seed=0):
    """As ``tests/test_engine.py``'s ``_lm_data``."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 64, (n, nb, bs, s)).astype(np.int32)
    ys = rng.integers(0, 64, (n, nb, bs, s)).astype(np.int32)
    return xs, ys


@pytest.fixture(scope="module")
def jax_lm_engine():
    eng = JaxEngine(_jax_lm(), 4, seed=0, learning_rate=0.05)
    return eng, _host(eng.init_params((16,)))


@pytest.mark.parametrize(
    "weights,n_rounds",
    [([1.0, 0.0, 2.0, 1.0], 1), ([1.0, 0.0, 2.0, 1.0], 2), ([0.0, 0.0, 0.0, 0.0], 1)],
    ids=["masked", "two_rounds", "zero_fallback"],
)
def test_lm_engine_rounds_match_jax(jax_lm_engine, weights, n_rounds):
    """The per-node loss is the mean over every token of the node: a
    mean over the batch axis only gives S times the gradient."""
    jeng, p0 = jax_lm_engine
    xs, ys = _lm_data(4)
    pj, lj = jeng.run_rounds(jax.tree_util.tree_map(jnp.asarray, p0), jnp.asarray(xs),
                             jnp.asarray(ys), weights=jnp.asarray(weights, jnp.float32),
                             n_rounds=n_rounds)
    eng = FederationEngine(_torch_lm(), 4, learning_rate=0.05, seed=0, device="cpu")
    pt, lt = eng.run_rounds(params_from_flax(p0, device="cpu"), xs, ys, weights=weights,
                            n_rounds=n_rounds)
    _assert_tree_close(pt, pj, RTOL, ATOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL, atol=ATOL)

    le_j, acc_j = jeng.evaluate(pj, jnp.asarray(xs), jnp.asarray(ys))
    le_t, acc_t = eng.evaluate(pt, xs, ys)
    np.testing.assert_allclose(le_t.numpy(), np.asarray(le_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), rtol=RTOL, atol=ATOL)


def test_flash_federation_round_on_cpu_takes_plain_versions():
    xs, ys = _lm_data(2, s=24)
    fed = VmapFederation(_torch_lm(flash=True), 2, learning_rate=0.05, device="cpu")
    dx, dy = fed.shard_data(xs, ys)
    assert dx.dtype == torch.int32 and dy.dtype == torch.long
    before = (fk.flash_fwd.launches, fk.flash_dq.launches, fk.flash_dkv.launches)
    params, losses = fed.round(fed.init_params((24,)), dx, dy)
    for v in tree_leaves(params):
        assert torch.equal(v, v[:1].expand_as(v))
    assert torch.isfinite(losses).all()
    assert (fk.flash_fwd.launches, fk.flash_dq.launches, fk.flash_dkv.launches) == before


def test_nested_params_round_trip_through_interop():
    module = _jax_lm()
    params = _host(module.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"])
    back = params_to_numpy(params_from_flax(params, device="cpu"))
    want = dict(tree_items(params))
    got = dict(tree_items(back))
    assert set(got) == set(want)
    assert "TransformerBlock_1/LayerNorm_0/scale" in got
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)
    stacked = params_from_flax(params, device="cpu", n_nodes=3)
    assert stacked["TransformerBlock_0"]["Dense_0"]["kernel"].shape == (3, 32, 96)


def test_lm_init_params_flax_initialisers():
    """Paths and shapes equal flax's; Embed untruncated normal with std
    1/sqrt(dim); lecun-normal Dense kernels; LayerNorm ones / zeros; the
    QKV projection has no bias; reproducible from the seed."""
    module, p = create_model("transformer_lm", (16,), seed=0, device="cpu",
                             vocab=256, dim=512, heads=8, n_layers=1, max_len=64)
    _, q = create_model(module, (16,), seed=0, device="cpu")
    flax_p = _host(JaxLM(vocab=256, dim=512, heads=8, n_layers=1, max_len=64).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))["params"])
    shapes = {path: tuple(v.shape) for path, v in tree_items(p)}
    assert shapes == {path: v.shape for path, v in tree_items(flax_p)}
    for a, b in zip(tree_leaves(p), tree_leaves(q)):
        assert torch.equal(a, b)
    emb = p["Embed_0"]["embedding"]
    std = 512 ** -0.5
    assert abs(emb.std().item() - std) / std < 0.02
    assert emb.abs().max().item() > 2.5 * std  # untruncated
    k = p["TransformerBlock_0"]["Dense_2"]["kernel"]
    assert abs(k.std().item() - std) / std < 0.02
    assert k.abs().max().item() <= 2.0 * std / 0.87962566103423978 + 1e-6
    assert "bias" not in p["TransformerBlock_0"]["Dense_0"]
    ln = p["TransformerBlock_0"]["LayerNorm_1"]
    assert torch.equal(ln["scale"], torch.ones(512)) and not ln["bias"].any()
    assert module.input_dtype == torch.int32
    with pytest.raises(ValueError, match="max_len"):
        create_model(module, (65,), device="cpu")
