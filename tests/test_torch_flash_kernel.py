"""Parity of the port's flash attention (tpfl_torch.parallel.flash_kernel)
and blockwise attention with the JAX package's, on the CPU.

Inputs come from a numpy seed and go through both packages. The JAX
flash kernels run in interpret mode, as ``tests/test_parallel.py`` runs
them; the port's wrappers take their plain versions for CPU tensors.
f32 tolerances are the JAX suite's own for these ops: atol 2e-5 on the
forward, 3e-5 on the gradients.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.parallel.flash_kernel import flash_attention as jax_flash
from tpfl.parallel.flash_kernel import flash_block_bwd as jax_flash_block_bwd
from tpfl.parallel.flash_kernel import flash_block_fwd as jax_flash_block_fwd
from tpfl.parallel.ring_attention import blockwise_attention as jax_blockwise
from tpfl_torch.parallel import flash_kernel as fk
from tpfl_torch.parallel.ring_attention import blockwise_attention

FWD_ATOL, GRAD_ATOL = 2e-5, 3e-5


def _qkv(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


@functools.cache
def _jax_out_and_grads(shape, causal, block, seed, dtype="float32"):
    """JAX flash forward and the q/k/v gradients of <out, cot>."""
    q, k, v, cot = (jnp.asarray(a, dtype) for a in _qkv(shape, seed))
    out = jax_flash(q, k, v, causal=causal, block=block)
    grads = jax.grad(
        lambda a, b, c: jnp.vdot(jax_flash(a, b, c, causal=causal, block=block)
                                 .astype(jnp.float32), cot.astype(jnp.float32)),
        argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out.astype(jnp.float32)), [np.asarray(g.astype(jnp.float32)) for g in grads]


def _torch_out_and_grads(shape, causal, block, seed, dtype=torch.float32):
    q, k, v, cot = (torch.from_numpy(a).to(dtype) for a in _qkv(shape, seed))
    for t in (q, k, v):
        t.requires_grad_(True)
    out = fk.flash_attention(q, k, v, causal=causal, block=block)
    (out.float() * cot.float()).sum().backward()
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in (q, k, v)]


@pytest.mark.parametrize(
    "shape,block,causal",
    [((2, 256, 2, 64), 128, False), ((2, 256, 2, 64), 128, True),
     ((1, 100, 2, 32), 64, True)],
    ids=["aligned", "aligned_causal", "unaligned_causal"],
)
def test_flash_attention_matches_jax(shape, block, causal):
    out_j, grads_j = _jax_out_and_grads(shape, causal, block, seed=3)
    before = (fk.flash_fwd.launches, fk.flash_dq.launches, fk.flash_dkv.launches)
    out_t, grads_t = _torch_out_and_grads(shape, causal, block, seed=3)
    np.testing.assert_allclose(out_t, out_j, atol=FWD_ATOL)
    for got, want, name in zip(grads_t, grads_j, "qkv"):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, err_msg=f"d{name}")
    # CPU tensors take the plain versions: no kernel launch is counted.
    assert (fk.flash_fwd.launches, fk.flash_dq.launches, fk.flash_dkv.launches) == before


@pytest.mark.parametrize("d", [136, 200])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_wide_heads_match_jax(d, causal):
    """Head dims past 128, which the reference pads to a multiple of 128
    and the port's kernels walk in 128-column chunks: forward and
    gradients against the JAX flash (interpret mode) at the f32
    tolerances above."""
    shape, block = (1, 64, 2, d), 32
    out_j, grads_j = _jax_out_and_grads(shape, causal, block, seed=19)
    out_t, grads_t = _torch_out_and_grads(shape, causal, block, seed=19)
    np.testing.assert_allclose(out_t, out_j, atol=FWD_ATOL)
    for got, want, name in zip(grads_t, grads_j, "qkv"):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, err_msg=f"d{name}")


# bf16: both sides round P and dS to bf16 before their products (at the
# same running max: the port's plain forward walks the kernel's 64-key
# tiles, the JAX kernel runs with block=64) and the outputs to bf16, in
# another summation order, so an output may sit one bf16 ulp of the
# tensor's largest entry apart: rtol 2^-9 plus 2^-9 of the largest entry
# (measured: at most 7.7e-4 of it). The same port without the P / dS
# rounding needs 2.4e-3 and is rejected.
BF16_RTOL, BF16_ATOL_REL = 2.0 ** -9, 2.0 ** -9


def _bf16_close(got, want):
    return np.allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL_REL * float(np.abs(want).max()))


def test_flash_attention_bf16_matches_jax_bf16():
    shape, block = (1, 128, 2, 32), 64
    out_j, grads_j = _jax_out_and_grads(shape, True, block, seed=7, dtype="bfloat16")
    out_t, grads_t = _torch_out_and_grads(shape, True, block, seed=7, dtype=torch.bfloat16)
    assert _bf16_close(out_t, out_j)
    for got, want, name in zip(grads_t, grads_j, "qkv"):
        assert _bf16_close(got, want), f"d{name}"
    # The same bf16 inputs through the f32 path (no P / dS rounding),
    # outputs rounded to bf16: every output moves out of the tolerance.
    q, k, v, cot = (torch.from_numpy(a).to(torch.bfloat16).float().requires_grad_(True)
                    for a in _qkv(shape, 7))
    out = fk.flash_attention(q, k, v, causal=True)
    (out * cot).sum().backward()
    for got, want in zip((out.detach(), q.grad, k.grad, v.grad), [out_j, *grads_j]):
        assert not _bf16_close(got.to(torch.bfloat16).float().numpy(), want)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_matches_jax_flash_block_fwd(causal):
    b, s, h, d = 2, 96, 2, 32
    q, k, v = _qkv((b, s, h, d), 11, n=3)
    out_j, lse_j = jax_flash_block_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal, block=32)
    fold = [fk._fold_heads(torch.from_numpy(a)) for a in (q, k, v)]
    o, lse = fk.flash_fwd(*fold, causal, out_dtype=torch.float32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j).reshape(b * h, s), atol=FWD_ATOL)
    np.testing.assert_allclose(fk._unfold_heads(o, b, h).numpy(), np.asarray(out_j),
                               atol=FWD_ATOL)


def _external_residuals(q, k, causal, seed):
    """lse / delta [B, H, S] f32 as a ring step receives them: the
    logsumexp of the whole attention row (this step's keys, plus a
    per-row offset >= 0 for the other steps' keys) and a delta of the
    row."""
    b, s, h, d = q.shape
    sc = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64)) / np.sqrt(d)
    if causal:
        sc = np.where(np.tril(np.ones((s, s), dtype=bool)), sc, -np.inf)
    m = sc.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(sc - m).sum(-1, keepdims=True)))[..., 0]
    rng = np.random.default_rng(seed)
    lse = lse + rng.uniform(0.0, 1.0, lse.shape)
    return lse.astype(np.float32), rng.normal(size=lse.shape).astype(np.float32)


@pytest.mark.parametrize("operands", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape,block", [((1, 64, 2, 16), 1024), ((2, 96, 1, 32), 32),
                                         ((1, 50, 2, 8), 16)],
                         ids=["one_block", "three_blocks", "unaligned"])
def test_backward_kernels_match_jax_flash_block_bwd(shape, block, causal, operands):
    """flash_dq and flash_dkv on CPU tensors (their plain versions, which
    define what the kernels compute) against the JAX package's
    ``flash_block_bwd`` (interpret mode) with the same EXTERNAL lse /
    delta, f32 outputs: a ring step's contribution. f32 operands: f32 sums
    in another order, rtol 1e-5 plus 1e-5 of the largest value. bf16
    operands: both round dS (dq, dk) and P (dv) to bf16 before their
    products, so an f32 order that flips one rounding moves an output by
    2^-8 of one operand; the rms of the difference stays within 2^-12 of
    the output's."""
    q, k, v, do = _qkv(shape, 23)
    if operands == "bfloat16":  # the values both sides see
        q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                       for a in (q, k, v, do))
    lse, delta = _external_residuals(q, k, causal, seed=29)
    want = jax_flash_block_bwd(*(jnp.asarray(a, operands) for a in (q, k, v, do)),
                               jnp.asarray(lse), jnp.asarray(delta), causal, block=block)
    b, s, h, d = shape
    tq, tk, tv, tdo = (fk._fold_heads(torch.from_numpy(a).to(getattr(torch, operands)))
                       for a in (q, k, v, do))
    rows = [torch.from_numpy(a).reshape(b * h, s) for a in (lse, delta)]
    before = (fk.flash_dq.launches, fk.flash_dkv.launches)
    args = (tq, tk, tv, tdo, *rows, causal)
    got = [fk.flash_dq(*args, out_dtype=torch.float32),
           *fk.flash_dkv(*args, out_dtype=torch.float32)]
    assert (fk.flash_dq.launches, fk.flash_dkv.launches) == before  # plain versions
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32
        g, w = fk._unfold_heads(g, b, h).numpy(), np.asarray(w)
        if operands == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                       err_msg=name)
        else:
            rms_err = np.sqrt(np.mean((g - w) ** 2))
            assert rms_err <= 2.0 ** -12 * np.sqrt(np.mean(w ** 2)), (name, rms_err)


@pytest.mark.parametrize(
    "shape,causal,block",
    [((2, 64, 2, 16), False, 32), ((2, 64, 2, 16), True, 32), ((1, 50, 2, 8), True, 16),
     ((1, 50, 2, 8), False, 16)],
    ids=["aligned", "causal", "unaligned_causal", "unaligned"],
)
def test_blockwise_attention_matches_jax(shape, causal, block):
    q, k, v, cot = _qkv(shape, 13)
    jq, jk, jv, jc = (jnp.asarray(a) for a in (q, k, v, cot))
    want = jax_blockwise(jq, jk, jv, causal=causal, block_size=block)
    gj = jax.grad(lambda a, b_, c: jnp.vdot(
        jax_blockwise(a, b_, c, causal=causal, block_size=block), jc), argnums=(0, 1, 2))(
        jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = blockwise_attention(tq, tk, tv, causal=causal, block_size=block)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=FWD_ATOL)
    for t, g, name in zip((tq, tk, tv), gj, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=GRAD_ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_gradcheck_float64(causal):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 6, 2, 4, dtype=torch.float64, generator=g, requires_grad=True)
               for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fk.flash_attention(a, b, c, causal=causal), (q, k, v))


def test_plain_versions_block_rows_like_one_block(monkeypatch):
    """The plain versions' tiling changes no f32 value: many small tiles
    and row blocks equal one of each."""
    q, k, v, do = (torch.from_numpy(a) for a in _qkv((3, 40, 16), 17))
    o1, lse1 = fk.flash_fwd_plain(q, k, v, True)
    delta = (do * o1).sum(-1)
    dq1 = fk.flash_dq_plain(q, k, v, do, lse1, delta, True)
    dk1, dv1 = fk.flash_dkv_plain(q, k, v, do, lse1, delta, True)
    monkeypatch.setattr(fk, "_PLAIN_BLOCK_ELEMS", 3 * 40 * 7)  # 7-row blocks
    monkeypatch.setattr(fk, "KEY_TILE", 6)
    o2, lse2 = fk.flash_fwd_plain(q, k, v, True)
    torch.testing.assert_close(o2, o1)
    torch.testing.assert_close(lse2, lse1)
    torch.testing.assert_close(fk.flash_dq_plain(q, k, v, do, lse1, delta, True), dq1)
    dk2, dv2 = fk.flash_dkv_plain(q, k, v, do, lse1, delta, True)
    torch.testing.assert_close(dk2, dk1)
    torch.testing.assert_close(dv2, dv1)


def test_key_tile_is_the_forward_kernels_key_tile():
    """The plain forward rounds P at the kernels' running max only if it
    walks their key tiles: KEY_TILE equals the key tile of the wgmma
    forward (kFwdKeys) and of the WMMA forward (kTile) in the source."""
    src = (Path(fk.__file__).parent / "csrc" / "flash_attn.cu").read_text()
    for name in ("kFwdKeys", "kTile"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, f"{name} not found in flash_attn.cu"
        assert int(m.group(1)) == fk.KEY_TILE, name
