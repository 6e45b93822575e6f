"""Parity of the port's CNN and FedAvg engine (tpfl_torch) with the JAX
package's, at a small size on the CPU.

The JAX ``CNN(conv_impl="pallas")`` runs its Pallas conv backward in
interpret mode; its params reach the port through
``tpfl_torch.interop.params_from_flax``. The f32 cases expect
differences from reduction order only: rtol=1e-4, atol=1e-5. One case
holds the bf16 compute path of the main path at a bf16 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.models import CNN as JaxCNN
from tpfl.parallel.engine import FederationEngine as JaxEngine
from tpfl_torch.interop import params_from_flax, params_to_numpy
from tpfl_torch.models import CNN, create_model
from tpfl_torch.parallel import FederationEngine, VmapFederation
from tpfl_torch.parallel import conv_kernel as ck

RTOL, ATOL = 1e-4, 1e-5
N_NODES, N_BATCHES, BATCH = 3, 2, 4


def _jax_cnn():
    return JaxCNN(channels=(4, 8), dense=16, out_channels=10,
                  compute_dtype=jnp.float32, conv_impl="pallas")


def _torch_cnn(conv_impl="pallas"):
    return CNN(channels=(4, 8), dense=16, out_channels=10,
               compute_dtype=torch.float32, conv_impl=conv_impl)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(size=(N_NODES, N_BATCHES, BATCH, 8, 8, 3)).astype(np.float32)
    ys = rng.integers(0, 10, size=(N_NODES, N_BATCHES, BATCH)).astype(np.int32)
    return xs, ys


def _host(tree):
    """Owning numpy copies of a JAX param tree (donation-safe)."""
    return jax.tree_util.tree_map(lambda a: np.array(a), dict(tree))


def _assert_tree_close(torch_params, jax_params):
    got = params_to_numpy(torch_params)
    want = _host(jax_params)
    assert set(got) == set(want)
    for layer in want:
        for leaf in want[layer]:
            np.testing.assert_allclose(
                got[layer][leaf], want[layer][leaf], rtol=RTOL, atol=ATOL,
                err_msg=f"{layer}/{leaf}",
            )


@pytest.fixture(scope="module")
def jax_engine_and_params():
    eng = JaxEngine(_jax_cnn(), N_NODES, learning_rate=0.1, seed=0)
    return eng, _host(eng.init_params((8, 8, 3)))


def _node_data_and_params(module):
    """Seeded per-node inputs and distinct per-node flax params (one
    init per seed, stacked)."""
    rng = np.random.default_rng(3)
    xs = rng.uniform(size=(N_NODES, BATCH, 8, 8, 3)).astype(np.float32)
    ys = rng.integers(0, 10, size=(N_NODES, BATCH)).astype(np.int32)
    trees = [module.init(jax.random.PRNGKey(s), jnp.asarray(xs[0]))["params"]
             for s in range(N_NODES)]
    return xs, ys, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *trees)


def _jax_logits_and_grads(module, stacked, xs, ys):
    def node_loss(p, x, y):
        logits = module.apply({"params": p}, x)
        return jnp.mean(-jnp.take_along_axis(
            jax.nn.log_softmax(logits), y[:, None], axis=1))

    logits = jax.jit(jax.vmap(lambda p, x: module.apply({"params": p}, x)))(
        stacked, jnp.asarray(xs))
    grads = jax.jit(jax.vmap(jax.grad(node_loss)))(
        stacked, jnp.asarray(xs), jnp.asarray(ys))
    return np.asarray(logits), _host(grads)


def _torch_logits_and_grads(model, stacked, xs, ys):
    params = params_from_flax(_host(stacked), device="cpu")
    for leaves in params.values():
        for v in leaves.values():
            v.requires_grad_(True)
    logits = model(params, torch.from_numpy(xs))
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 10), torch.from_numpy(ys).reshape(-1).long(),
        reduction="none").reshape(N_NODES, BATCH).mean(1).sum()
    loss.backward()
    grads = {k: {kk: v.grad for kk, v in d.items()} for k, d in params.items()}
    return logits.detach().numpy(), grads


@pytest.mark.parametrize("conv_impl", ["pallas", "xla"])
def test_cnn_logits_and_node_grads_match_jax(conv_impl):
    module = _jax_cnn()
    xs, ys, stacked = _node_data_and_params(module)
    logits_j, grads_j = _jax_logits_and_grads(module, stacked, xs, ys)
    logits_t, grads_t = _torch_logits_and_grads(_torch_cnn(conv_impl), stacked, xs, ys)
    np.testing.assert_allclose(logits_t, logits_j, rtol=RTOL, atol=ATOL)
    _assert_tree_close(grads_t, grads_j)


# bf16 compute: one bf16 rounding is 2^-8 relative. Products and f32
# accumulations agree between the packages, so logits and kernel grads
# may differ by a rounding flip at most: rtol 2^-7, plus 2^-9 of the
# leaf's largest entry for elements near zero. Bias grads are bf16
# reduce-sums of the broadcast bias's gradient over B·H·W terms, which
# XLA's CPU reduction and PyTorch's f32-accumulated sum round
# differently: 2^-5 of the leaf's largest entry.
BF16_RTOL, BF16_ATOL_REL, BF16_BIAS_ATOL_REL = 2.0 ** -7, 2.0 ** -9, 2.0 ** -5


def _bf16_close(got, want, atol_rel):
    return np.allclose(got, want, rtol=BF16_RTOL,
                       atol=atol_rel * float(np.abs(want).max()))


def test_bf16_cnn_logits_and_node_grads_match_jax_bf16():
    """The main path's casts (bf16 compute, promoted conv kernel, bf16
    bias adds, bmm dense layers and max-pool) against the JAX CNN with
    ``compute_dtype=bfloat16, conv_impl="pallas"``. The tolerance is
    tight enough that the same port computing in f32 is rejected."""
    module = JaxCNN(channels=(4, 8), dense=16, out_channels=10,
                    compute_dtype=jnp.bfloat16, conv_impl="pallas")
    xs, ys, stacked = _node_data_and_params(module)
    logits_j, grads_j = _jax_logits_and_grads(module, stacked, xs, ys)
    model = CNN(channels=(4, 8), dense=16, out_channels=10,
                compute_dtype=torch.bfloat16, conv_impl="pallas")
    logits_t, grads_t = _torch_logits_and_grads(model, stacked, xs, ys)
    assert _bf16_close(logits_t, logits_j, BF16_ATOL_REL)
    for layer, leaves in grads_j.items():
        for leaf, want in leaves.items():
            atol_rel = BF16_BIAS_ATOL_REL if leaf == "bias" else BF16_ATOL_REL
            got = grads_t[layer][leaf].numpy()
            assert _bf16_close(got, want, atol_rel), f"{layer}/{leaf}"

    f32_logits, f32_grads = _torch_logits_and_grads(_torch_cnn(), stacked, xs, ys)
    # Computing in f32 moves the logits and the conv kernels' grads (the
    # kernels' path) out of the bf16 tolerance; the dense grads stay in.
    assert not _bf16_close(f32_logits, logits_j, BF16_ATOL_REL)
    for layer in ("Conv_0", "Conv_1"):
        got = f32_grads[layer]["kernel"].numpy()
        assert not _bf16_close(got, grads_j[layer]["kernel"], BF16_ATOL_REL), layer


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_default_cnn_matches_jax_default_cnn(compute):
    """``CNN()`` against the JAX ``CNN()``, each with its default
    ``conv_impl="fwd_bwd"`` (both gradients forward-style convolutions)
    and default widths (channels 32 / 64, dense 128): logits and per-node
    grads through ``params_from_flax``. f32 compute at RTOL / ATOL; bf16
    compute (the default) at the bf16 tolerances above."""
    jax_kw, torch_kw = {}, {}
    if compute == "float32":
        jax_kw, torch_kw = {"compute_dtype": jnp.float32}, {"compute_dtype": torch.float32}
    module = JaxCNN(**jax_kw)
    model = CNN(**torch_kw)
    assert module.conv_impl == model.conv_impl == "fwd_bwd"
    xs, ys, stacked = _node_data_and_params(module)
    logits_j, grads_j = _jax_logits_and_grads(module, stacked, xs, ys)
    logits_t, grads_t = _torch_logits_and_grads(model, stacked, xs, ys)
    if compute == "float32":
        np.testing.assert_allclose(logits_t, logits_j, rtol=RTOL, atol=ATOL)
        _assert_tree_close(grads_t, grads_j)
        return
    assert _bf16_close(logits_t, logits_j, BF16_ATOL_REL)
    for layer, leaves in grads_j.items():
        for leaf, want in leaves.items():
            atol_rel = BF16_BIAS_ATOL_REL if leaf == "bias" else BF16_ATOL_REL
            assert _bf16_close(grads_t[layer][leaf].numpy(), want, atol_rel), f"{layer}/{leaf}"


def test_cnn_rejects_unknown_conv_impl():
    with pytest.raises(ValueError, match="fwd_bwd"):
        CNN(conv_impl="cudnn")


@pytest.mark.parametrize(
    "weights,n_rounds,epochs",
    [
        ([1.0, 0.0, 2.0], 1, 1),
        ([1.0, 0.0, 2.0], 2, 1),
        ([0.0, 0.0, 0.0], 1, 1),  # all-zero: uniform-over-valid fallback
        ([1.0, 1.0, 1.0], 1, 2),
    ],
    ids=["masked", "two_rounds", "zero_fallback", "two_epochs"],
)
def test_engine_rounds_match_jax(jax_engine_and_params, weights, n_rounds, epochs):
    jeng, p0 = jax_engine_and_params
    xs, ys = _data()
    pj, lj = jeng.run_rounds(
        jax.tree_util.tree_map(jnp.asarray, p0), jnp.asarray(xs), jnp.asarray(ys),
        weights=jnp.asarray(weights, jnp.float32), epochs=epochs, n_rounds=n_rounds,
    )
    eng = FederationEngine(_torch_cnn(), N_NODES, learning_rate=0.1, seed=0, device="cpu")
    pt, lt = eng.run_rounds(params_from_flax(p0, device="cpu"), xs, ys,
                            weights=weights, epochs=epochs, n_rounds=n_rounds)
    _assert_tree_close(pt, pj)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL, atol=ATOL)

    le_j, acc_j = jeng.evaluate(pj, jnp.asarray(xs), jnp.asarray(ys))
    le_t, acc_t = eng.evaluate(pt, xs, ys)
    np.testing.assert_allclose(le_t.numpy(), np.asarray(le_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), rtol=RTOL, atol=ATOL)


def test_per_round_weights_and_vmap_federation_api(jax_engine_and_params):
    """[n_rounds, n] weight schedules through the VmapFederation API."""
    jeng, p0 = jax_engine_and_params
    xs, ys = _data(1)
    w = np.asarray([[1.0, 2.0, 0.0], [0.0, 1.0, 1.0]], np.float32)
    pj, lj = jeng.run_rounds(jax.tree_util.tree_map(jnp.asarray, p0),
                             jnp.asarray(xs), jnp.asarray(ys),
                             weights=jnp.asarray(w), n_rounds=2)
    fed = VmapFederation(_torch_cnn(), N_NODES, learning_rate=0.1, device="cpu")
    xt, yt = fed.shard_data(xs, ys)
    pt, lt = fed.run_rounds(params_from_flax(p0, device="cpu"), xt, yt,
                            weights=w, n_rounds=2)
    _assert_tree_close(pt, pj)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL, atol=ATOL)


def test_fold_broadcasts_one_aggregate_and_kernels_stay_idle():
    xs, ys = _data(2)
    fed = VmapFederation(_torch_cnn(), N_NODES, device="cpu")
    before = (ck.conv_dw.launches, ck.conv_dx.launches)
    params, losses = fed.round(fed.init_params((8, 8, 3)), xs, ys)
    for leaves in params.values():
        for v in leaves.values():
            assert torch.equal(v, v[:1].expand_as(v))
    assert torch.isfinite(losses).all()
    assert (ck.conv_dw.launches, ck.conv_dx.launches) == before


def test_init_params_flax_initialisers():
    """lecun-normal kernels (truncated at 2 std, variance 1/fan_in),
    zero biases, reproducible from the seed."""
    module, p = create_model("cnn", (32, 32, 3), seed=0, device="cpu")
    _, q = create_model(module, (32, 32, 3), seed=0, device="cpu")
    k = p["Dense_0"]["kernel"]
    assert tuple(k.shape) == (8 * 8 * 64, 128)
    assert torch.equal(k, q["Dense_0"]["kernel"])
    std = (1.0 / k.shape[0]) ** 0.5
    assert abs(k.std().item() - std) / std < 0.02
    assert k.abs().max().item() <= 2.0 * std / 0.87962566103423978 + 1e-6
    assert all(not v["bias"].any() for v in p.values())


def test_init_params_are_the_same_under_every_torch():
    """A seed draws the same params under every torch release: the CNN at
    seed 4243 is the draw torch 2.11's ``trunc_normal_`` made (sha256 of
    the f32 leaves in JAX's order, as ``final_model_digests`` hashes
    them), which torch 2.13's ``trunc_normal_`` does not reproduce."""
    from tpfl_torch.attacks.harness import params_digest
    from tpfl_torch.models import init_params

    params = init_params(CNN(out_channels=10), (32, 32, 3), seed=4243, device="cpu")
    assert params_digest(params) == (
        "55b37e95481f5bf7dcdd6998db22f35d3262a5a4e2ad426400c7aa852e6d4e89")


def test_unported_options_raise():
    """Meshes and FedBuff schedules are not ported yet (FedProx, SCAFFOLD
    and aux state are: tests/test_torch_engine_kinds.py; attack scales:
    tests/test_torch_engine_attack.py)."""
    with pytest.raises(NotImplementedError, match="mesh"):
        FederationEngine(_torch_cnn(), 2, mesh="auto", device="cpu")
    eng = FederationEngine(_torch_cnn(), 2, device="cpu")
    xs, ys = np.zeros((2, 1, 1, 8, 8, 3), np.float32), np.zeros((2, 1, 1), np.int32)
    with pytest.raises(NotImplementedError, match="FedBuff"):
        eng.run_rounds(eng.init_params((8, 8, 3)), xs, ys, schedule=object())
