"""Parity of the port's ring attention (tpfl_torch.parallel.ring_attention)
and its flash block helpers with the JAX package's, on the CPU.

The multi-rank cases run once, in a ``gloo`` world of 4 spawned ranks
(``tests/torch_spmd_worker.py``), against ``make_ring_attention`` on a
4-device JAX ``sp`` mesh with the flash inner in interpret mode, as
``tests/test_parallel.py`` runs it. Tolerances are the JAX suite's: f32
forward atol 2e-5, gradients 3e-5 (``tests/test_parallel.py:505-560``);
ring-trained TransformerLM losses rtol 1e-4 and params atol 5e-4
(``:735``). The one-rank cases run in this process over a ``HashStore``
group, which each test tears down.
"""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_spmd_worker as worker
from tpfl_torch.interop import params_from_flax
from tpfl_torch.models import TransformerLM
from tpfl_torch.parallel import flash_kernel as fk
from tpfl_torch.parallel.mesh import create_mesh
from tpfl_torch.parallel.ring_attention import (_ring_merge, blockwise_attention,
                                                make_ring_attention, ring_attention)

FWD_ATOL, GRAD_ATOL = 2e-5, 3e-5
LOSS_RTOL, PARAM_ATOL = 1e-4, 5e-4


@pytest.fixture(scope="module")
def world():
    """Every rank's results of ``worker.ring_results``; the world's
    children have exited when it returns."""
    return worker.run_world(worker.ring_results)


@pytest.fixture
def one_rank():
    """A one-rank ``sp`` mesh over a ``HashStore`` group, torn down after."""
    assert not dist.is_initialized()
    mesh = create_mesh({"sp": 1}, device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def _jax_sp_mesh():
    import jax

    from tpfl.parallel import create_mesh as jax_mesh

    return jax_mesh({"sp": worker.WORLD}, devices=jax.devices()[:worker.WORLD])


@functools.cache
def _jax_ring(causal: bool, impl: str, dtype: str = "float32"):
    """The JAX ring's forward and, in f32, the gradients of ``sum(out²)``
    (its VJP at 2·out)."""
    import jax
    import jax.numpy as jnp

    from tpfl.parallel.ring_attention import make_ring_attention as jax_make_ring

    ring = jax_make_ring(_jax_sp_mesh(), causal=causal, impl=impl)
    q, k, v = (jnp.asarray(a, dtype) for a in worker.ring_qkv())
    if dtype != "float32":
        return np.asarray(ring(q, k, v).astype(jnp.float32)), None
    out, vjp = jax.vjp(ring, q, k, v)
    return np.asarray(out), [np.asarray(g) for g in vjp(2.0 * out)]


def _ranks_agree(world, key):
    """Every rank returns the same global result (the output and the
    gradients are replicated), bit for bit."""
    for r in world[1:]:
        for a, b in zip(np.atleast_1d(world[0][key]), np.atleast_1d(r[key])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_world4_matches_jax(world, causal, impl):
    """World 4, S 64 (local blocks of 16): forward and the gradients of
    ``sum(out²)`` against the JAX ring on a 4-device mesh."""
    out_j, grads_j = _jax_ring(causal, impl)
    _ranks_agree(world, f"fwd_{causal}_{impl}")
    _ranks_agree(world, f"grads_{causal}_{impl}")
    np.testing.assert_allclose(world[0][f"fwd_{causal}_{impl}"], out_j, atol=FWD_ATOL)
    for got, want, name in zip(world[0][f"grads_{causal}_{impl}"], grads_j, "qkv"):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_ring_world4_gradients_are_the_single_process_ones(world, causal):
    """A replicated loss at world 4 gives the single-process gradients,
    not n times them: the ring's gradients against ``flash_attention``'s
    in one process (its plain path) and blockwise attention's."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in worker.ring_qkv())
    fk.flash_attention(q, k, v, causal=causal).pow(2).sum().backward()
    flash = [t.grad.numpy() for t in (q, k, v)]
    qb, kb, vb = (torch.from_numpy(a).requires_grad_(True) for a in worker.ring_qkv())
    blockwise_attention(qb, kb, vb, causal=causal, block_size=16).pow(2).sum().backward()
    for impl in ("flash", "xla"):
        for got, a, b, name in zip(world[0][f"grads_{causal}_{impl}"], flash,
                                   [t.grad.numpy() for t in (qb, kb, vb)], "qkv"):
            np.testing.assert_allclose(got, a, atol=GRAD_ATOL, err_msg=f"{impl} d{name}")
            np.testing.assert_allclose(got, b, atol=GRAD_ATOL, err_msg=f"{impl} d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_ring_world4_bf16_forward(world, causal):
    """bf16 operands through the flash ring at world 4 against the JAX
    flash ring in bf16: both round P to bf16 at the same running max (one
    16-key tile a step on both sides) and the merged output once, so they
    differ by f32 summation order. The rms of the difference stays within
    2^-12 of the output's, the bound of ``tests/test_torch_flash_kernel.py``
    for bf16 operands."""
    want, _ = _jax_ring(causal, "flash", "bfloat16")
    _ranks_agree(world, f"bf16_{causal}")
    got = world[0][f"bf16_{causal}"]
    rms_err = np.sqrt(np.mean((got - want) ** 2))
    assert rms_err <= 2.0 ** -12 * np.sqrt(np.mean(want ** 2)), rms_err


def _jax_lm_run(attention):
    """The JAX suite's ring-trained TransformerLM (``:735``) from the
    port's seeded params: first logits, 3 SGD(0.1) losses, final params."""
    import jax
    import jax.numpy as jnp
    import optax

    from tpfl.models import TransformerLM as JaxLM

    module = JaxLM(**worker.LM, compute_dtype=jnp.float32, attention_fn=attention)
    params = jax.tree_util.tree_map(jnp.asarray, worker.lm_params())
    tokens = jnp.asarray(worker.lm_tokens())
    tx = optax.sgd(0.1)
    opt = tx.init(params)

    def loss_of(p):
        logits = module.apply({"params": p}, tokens, train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], tokens[:, 1:]).mean(), logits

    @jax.jit
    def step(p, o):
        (loss, logits), g = jax.value_and_grad(loss_of, has_aux=True)(p)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, loss, logits

    losses, logits0 = [], None
    for _ in range(3):
        params, opt, loss, logits = step(params, opt)
        logits0 = np.asarray(logits) if logits0 is None else logits0
        losses.append(float(loss))
    return logits0, losses, jax.tree_util.tree_map(np.asarray, params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def test_ring_seam_transformer_trains_like_jax_and_blockwise(world):
    """TransformerLM with the ring as ``attention_fn`` (world 4, f32): the
    first logits match the JAX ring seam's (``:695``), and three SGD steps
    match both the JAX ring-trained run and the port's blockwise run."""
    from tpfl.parallel.ring_attention import make_ring_attention as jax_make_ring

    logits_j, losses_j, params_j = _jax_lm_run(
        jax_make_ring(_jax_sp_mesh(), causal=True, impl="flash"))
    blockwise = worker.lm_train(None)
    got = world[0]["lm"]
    for r in world[1:]:
        np.testing.assert_array_equal(r["lm"]["losses"], got["losses"])
    np.testing.assert_allclose(got["logits"], logits_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["losses"], losses_j, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"], blockwise["losses"], rtol=LOSS_RTOL)
    assert got["losses"][-1] < got["losses"][0]
    want_j, want_b, have = _flat(params_j), _flat(blockwise["params"]), _flat(got["params"])
    assert set(have) == set(want_j) == set(want_b)
    for path, value in have.items():
        np.testing.assert_allclose(value, want_j[path], atol=PARAM_ATOL, err_msg=path)
        np.testing.assert_allclose(value, want_b[path], atol=PARAM_ATOL, err_msg=path)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_ring_on_a_dp_sp_mesh_matches_one_process(world, impl):
    """A 2 x 2 ``dp x sp`` mesh: each dp row runs the causal ring over its
    ``sp`` subgroup on its own batch element; output and gradients equal
    ``flash_attention``'s on that element in one process, and the two
    ranks of a row agree bit for bit."""
    for dp in (0, 1):
        rows = [r["dp_sp"][impl] for r in world if r["dp_sp"]["dp"] == dp]
        assert len(rows) == worker.WORLD // 2
        for other in rows[1:]:
            for a, b in zip(rows[0], other):
                np.testing.assert_array_equal(a, b)
        q, k, v = (torch.from_numpy(a[dp:dp + 1]).requires_grad_(True)
                   for a in worker.ring_qkv())
        want = fk.flash_attention(q, k, v, causal=True)
        want.pow(2).sum().backward()
        np.testing.assert_allclose(rows[0][0], want.detach().numpy(), atol=FWD_ATOL)
        for got, t, name in zip(rows[0][1:], (q, k, v), "qkv"):
            np.testing.assert_allclose(got, t.grad.numpy(), atol=GRAD_ATOL, err_msg=f"d{name}")


def test_ring_refuses_a_sequence_that_does_not_split(world):
    assert "does not split" in world[0]["indivisible_error"]


# ---- one rank, in this process ----------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_one_rank_ring_is_flash_attention(one_rank, causal):
    """On a one-rank axis the rotation is the identity (the reference's
    ppermute over one device): the flash ring is ``flash_attention``'s
    plain path bit for bit, forward and gradients, and the einsum inner
    agrees at the f32 tolerances."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in worker.ring_qkv())
    want = fk.flash_attention(q, k, v, causal=causal)
    want.pow(2).sum().backward()
    want_grads = [t.grad.clone() for t in (q, k, v)]
    for impl in ("flash", "xla", "auto"):
        for t in (q, k, v):
            t.grad = None
        got = make_ring_attention(one_rank, causal=causal, impl=impl)(q, k, v)
        got.pow(2).sum().backward()
        if impl == "flash":
            assert torch.equal(got, want)
            for t, g in zip((q, k, v), want_grads):
                assert torch.equal(t.grad, g)
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=FWD_ATOL)
        for t, g in zip((q, k, v), want_grads):
            np.testing.assert_allclose(t.grad.numpy(), g.numpy(), atol=GRAD_ATOL)


def test_one_rank_validation(one_rank):
    """An unknown impl raises at build time and at call time; a causal
    kwarg that disagrees with the built one raises, as the reference's
    seam does; the flash inner takes the kernels' plain versions on CPU
    tensors (no launch counted)."""
    with pytest.raises(ValueError, match="impl"):
        make_ring_attention(one_rank, impl="pallas")
    group = one_rank.get_group("sp")
    q = torch.zeros((1, 8, 1, 8))
    with pytest.raises(ValueError, match="impl"):
        ring_attention(q, q, q, group, impl="pallas")
    with pytest.raises(ValueError, match="causal"):
        make_ring_attention(one_rank, causal=False)(q, q, q, causal=True)
    before = (fk.flash_fwd.launches, fk.flash_dq.launches, fk.flash_dkv.launches)
    make_ring_attention(one_rank, causal=True, impl="flash")(q, q, q, causal=True)
    assert (fk.flash_fwd.launches, fk.flash_dq.launches, fk.flash_dkv.launches) == before


def test_one_rank_transformer_seam(one_rank):
    """TransformerLM's ``attention_fn`` seam at one rank: the ring gives
    the flash model's logits, bit for bit."""
    params = params_from_flax(worker.lm_params(), device="cpu", n_nodes=1)
    tokens = torch.from_numpy(worker.lm_tokens())[None]
    kw = dict(worker.LM, compute_dtype=torch.float32)
    want = TransformerLM(**kw, attention_fn=fk.flash_attention)(params, tokens)
    ring = make_ring_attention(one_rank, causal=True, impl="flash")
    assert torch.equal(TransformerLM(**kw, attention_fn=ring)(params, tokens), want)


# ---- the flash block helpers, exact against the JAX package ------------------------


def test_ring_block_size_matches_jax():
    from tpfl.parallel.flash_kernel import ring_block_size as jax_ring_block_size

    for s in list(range(1, 70)) + [96, 100, 130, 1000, 1023, 1024, 1025, 4096, 8191, 8192]:
        for block in (1, 7, 8, 16, 24, 64, 100, 1024):
            assert fk.ring_block_size(s, block) == jax_ring_block_size(s, block), (s, block)


def _block_inputs(causal: bool, seed: int, dtype: str):
    rng = np.random.default_rng(seed)
    b, s, h, d = 2, 48, 2, 16
    q, k, v, do = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(4))
    if dtype == "bfloat16":  # the values both sides see
        q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                       for a in (q, k, v, do))
    # Global residuals of a row that saw other steps' keys too: lse above
    # this block's own logsumexp, any delta.
    sc = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64)) / np.sqrt(d)
    if causal:
        sc = np.where(np.tril(np.ones((s, s), dtype=bool)), sc, -np.inf)
    m = sc.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(sc - m).sum(-1, keepdims=True)))[..., 0]
    lse = (lse + rng.uniform(0.0, 1.0, lse.shape)).astype(np.float32)
    delta = rng.normal(size=lse.shape).astype(np.float32)
    return q, k, v, do, lse, delta


def _close(got, want, dtype, what):
    """f32 operands: f32 sums in another order. bf16 operands: both round
    P and dS to bf16 before their products; an f32 order that flips one
    rounding moves an output by 2^-8 of one operand, so the rms of the
    difference is held within 2^-12 of the output's (the bound of
    ``tests/test_torch_flash_kernel.py``)."""
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                                   err_msg=what)
    else:
        rms_err = np.sqrt(np.mean((got - want) ** 2))
        assert rms_err <= 2.0 ** -12 * np.sqrt(np.mean(want ** 2)), (what, rms_err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_block_fwd_and_bwd_match_jax(causal, dtype):
    """``flash_block_fwd`` / ``flash_block_bwd`` against the JAX package's
    (interpret mode): f32 outputs, lse ``[B, H, S]``, the caller's global
    lse / delta; the port's merge of two steps against the logsumexp of
    the two halves of the keys."""
    import jax.numpy as jnp

    from tpfl.parallel.flash_kernel import flash_block_bwd as jax_bwd
    from tpfl.parallel.flash_kernel import flash_block_fwd as jax_fwd
    from tpfl.parallel.ring_attention import _ring_merge as jax_merge

    q, k, v, do, lse, delta = _block_inputs(causal, 31, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v, do))
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in (q, k, v, do))
    # One key block on the JAX side: P rounds at the running max of the
    # port's plain forward, which walks KEY_TILE (64) keys a tile.
    out_t, lse_t = fk.flash_block_fwd(tq, tk, tv, causal)
    out_j, lse_j = jax_fwd(jq, jk, jv, causal)
    assert out_t.dtype == lse_t.dtype == torch.float32
    assert tuple(lse_t.shape) == lse_j.shape == (2, 2, 48)
    _close(out_t.numpy(), np.asarray(out_j), dtype, "out")
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=FWD_ATOL)
    got = fk.flash_block_bwd(tq, tk, tv, tdo, torch.from_numpy(lse), torch.from_numpy(delta),
                             causal, block=16)
    want = jax_bwd(jq, jk, jv, jdo, jnp.asarray(lse), jnp.asarray(delta), causal, block=16)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32
        _close(g.numpy(), np.asarray(w), dtype, name)
    if dtype == "float32":
        # Two non-causal steps over the key halves, merged, are the whole.
        parts = [fk.flash_block_fwd(tq, tk[:, sl], tv[:, sl], False)
                 for sl in (slice(0, 24), slice(24, 48))]
        o = torch.zeros_like(out_t)
        lse_m = torch.full_like(lse_t, float("-inf"))
        for o_s, lse_s in parts:
            o, lse_m = _ring_merge(o, lse_m, o_s, lse_s)
        o_j, l_j = jnp.zeros_like(out_j), jnp.full_like(lse_j, -jnp.inf)
        for o_s, lse_s in parts:
            o_j, l_j = jax_merge(o_j, l_j, jnp.asarray(o_s.numpy()), jnp.asarray(lse_s.numpy()))
        np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=1e-6)
        np.testing.assert_allclose(lse_m.numpy(), np.asarray(l_j), atol=1e-6)
        whole, whole_lse = fk.flash_block_fwd(tq, tk, tv, False)
        np.testing.assert_allclose(o.numpy(), whole.numpy(), atol=FWD_ATOL)
        np.testing.assert_allclose(lse_m.numpy(), whole_lse.numpy(), atol=FWD_ATOL)
