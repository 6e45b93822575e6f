"""Parity of the port's per-node conv (tpfl_torch.parallel.conv_kernel)
with the JAX package's Pallas ``node_conv`` (interpret mode on the CPU).

Inputs come from a numpy seed and go through both packages. f32
comparisons use the JAX suite's own tolerance for this op
(rtol=1e-4, atol=1e-3, tests/test_parallel.py): the two sides sum the
same products in different orders.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.parallel.conv_kernel import conv_fwd_style as jax_conv_fwd_style
from tpfl.parallel.conv_kernel import node_conv as jax_node_conv
from tpfl_torch.parallel import conv_kernel as ck

RTOL, ATOL = 1e-4, 1e-3
SHAPES = [(4, 8, 8, 3, 5), (2, 16, 16, 32, 8), (2, 6, 10, 7, 3)]


@functools.cache
def _jax_grads(shape):
    """(y, dx, dw, dout) of sum(node_conv(x, w)²) on one node."""
    x, w = _inputs(shape)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    y = jax_node_conv(xj, wj, True)
    gx, gw = jax.grad(
        lambda a, b: jnp.sum(jax_node_conv(a, b, True) ** 2), argnums=(0, 1)
    )(xj, wj)
    return np.asarray(y), np.asarray(gx), np.asarray(gw), 2.0 * np.asarray(y)


def _inputs(shape, seed=1):
    rng = np.random.default_rng(seed)
    b, h, w, cin, cout = shape
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    k = rng.normal(size=(3, 3, cin, cout)).astype(np.float32)
    return x, k


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_pallas(shape):
    x, w = _inputs(shape)
    y, gx, gw, dout = _jax_grads(shape)
    xt = torch.from_numpy(x)[None]
    wt = torch.from_numpy(w)[None]
    gt = torch.from_numpy(dout)[None]
    np.testing.assert_allclose(
        ck.conv_forward(xt, wt)[0].numpy(), y, rtol=RTOL, atol=ATOL
    )
    np.testing.assert_allclose(
        ck.conv_dw_plain(xt, gt, 3)[0].numpy(), gw, rtol=RTOL, atol=ATOL
    )
    np.testing.assert_allclose(
        ck.conv_dx_plain(gt, wt)[0].numpy(), gx, rtol=RTOL, atol=ATOL
    )


@pytest.mark.parametrize("shape", SHAPES)
def test_node_conv_autograd_matches_jax_pallas(shape):
    x, w = _inputs(shape)
    _, gx, gw, _ = _jax_grads(shape)
    xt = torch.from_numpy(x)[None].requires_grad_(True)
    wt = torch.from_numpy(w)[None].requires_grad_(True)
    before = (ck.conv_dw.launches, ck.conv_dx.launches)
    (ck.node_conv(xt, wt) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad[0].numpy(), gx, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(wt.grad[0].numpy(), gw, rtol=RTOL, atol=ATOL)
    # CPU tensors take the plain versions: no kernel launch is counted.
    assert (ck.conv_dw.launches, ck.conv_dx.launches) == before


def test_node_stacked_matches_jax_vmap():
    """Three nodes with distinct weights in one call == jax.vmap."""
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(3, 2, 8, 8, 3)).astype(np.float32)
    ws = rng.normal(size=(3, 3, 3, 3, 4)).astype(np.float32)
    gj = jax.grad(lambda w: jnp.sum(
        jax.vmap(lambda a, b: jax_node_conv(a, b, True))(jnp.asarray(xs), w) ** 2
    ))(jnp.asarray(ws))
    wt = torch.from_numpy(ws).requires_grad_(True)
    (ck.node_conv(torch.from_numpy(xs), wt) ** 2).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gj), rtol=RTOL, atol=ATOL)


def test_bf16_dx_at_main_path_widths_matches_jax_pallas():
    """The main path's Conv_1 widths in its working type (Cin 32, Cout 64,
    16×16, batch 2, 2 nodes; bf16 operands): the JAX Pallas backward's dx
    against ``conv_dx_plain``, the version the card's kernel is held to.
    Both sum in f32 and round to bf16 once, so they agree within one bf16
    rounding (2⁻⁷ relative) plus the f32 order near zero (1e-3 of the
    largest value)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 2, 16, 16, 32)).astype(np.float32)
    w = (0.1 * rng.normal(size=(2, 3, 3, 32, 64))).astype(np.float32)
    g = rng.normal(size=(2, 2, 16, 16, 64)).astype(np.float32)
    bf = jnp.bfloat16
    _, vjp = jax.vjp(
        jax.vmap(lambda a, b: jax_node_conv(a, b, True)),
        jnp.asarray(x, bf), jnp.asarray(w, bf),
    )
    dx_jax, _ = vjp(jnp.asarray(g, bf))
    assert dx_jax.dtype == bf
    to_t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    dx = ck.conv_dx_plain(to_t(g), to_t(w))
    assert dx.dtype == torch.bfloat16
    ref = np.asarray(dx_jax.astype(jnp.float32))
    np.testing.assert_allclose(dx.float().numpy(), ref, rtol=2.0 ** -7,
                               atol=1e-3 * np.abs(ref).max())


def test_wgmma_dx_edges_sit_on_the_kernels_rule():
    """The card's edge cases of the wgmma conv_dx (``ck.WGMMA_DX_EDGES``)
    each pass the static part of its shape rule in the source and together
    reach its edges: one pixel and the pixel cap (kDxWG · kDxTilesPerWG
    64-pixel tiles), Cin 8, a Cin that cuts a 32-channel tile, and
    kDxMaxCin; more images than the H100's 132 SMs, so a block walks
    several."""
    src = (Path(ck.__file__).parent / "csrc" / "conv_bwd.cu").read_text()
    const = {}
    for name in ("kDxWG", "kDxTilesPerWG", "kDxMaxCin"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, f"{name} not found in conv_bwd.cu"
        const[name] = int(m.group(1))
    max_pixels = 64 * const["kDxWG"] * const["kDxTilesPerWG"]
    for cin, cout, (h, w), b, n in ck.WGMMA_DX_EDGES:
        assert cout % 64 == 0 and cin % 8 == 0 and 8 <= cin <= const["kDxMaxCin"]
        assert 1 <= h * w <= max_pixels and h + 2 <= 256 and w + 2 <= 256
        assert n * b > 132
    pixels = {h * w for _, _, (h, w), _, _ in ck.WGMMA_DX_EDGES}
    cins = {cin for cin, *_ in ck.WGMMA_DX_EDGES}
    assert min(pixels) == 1 and max(pixels) == max_pixels
    assert min(cins) == 8 and max(cins) == const["kDxMaxCin"]
    assert any(cin % 32 for cin in cins)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_conv_fwd_style_matches_jax_conv_fwd_style(shape, dtype):
    """The port's ``conv_fwd_style`` (grouped ``F.conv2d`` forward, both
    gradients forward-style grouped convolutions) against the JAX one
    under ``jax.vmap`` over 2 nodes, on one cotangent. f32: rtol 1e-5 and
    1e-5 of the largest value (the two sum up to 512 products per entry
    in different orders). bf16, against eager JAX: one bf16 rounding of
    each output, rtol 2⁻⁷ plus 2⁻⁹ of the largest value."""
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(4)
    xs = rng.normal(size=(2, b, h, w, cin)).astype(np.float32)
    ws = rng.normal(size=(2, 3, 3, cin, cout)).astype(np.float32)
    cot = rng.normal(size=(2, b, h, w, cout)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    with jax.disable_jit():
        y, vjp = jax.vjp(jax.vmap(jax_conv_fwd_style), jnp.asarray(xs, jdt), jnp.asarray(ws, jdt))
        want = [y, *vjp(jnp.asarray(cot, jdt))]
    xt = torch.from_numpy(xs).to(tdt).requires_grad_(True)
    wt = torch.from_numpy(ws).to(tdt).requires_grad_(True)
    before = (ck.conv_dw.launches, ck.conv_dx.launches)
    yt = ck.conv_fwd_style(xt, wt)
    yt.backward(torch.from_numpy(cot).to(tdt))
    assert (ck.conv_dw.launches, ck.conv_dx.launches) == before
    rtol, atol_rel = (1e-5, 1e-5) if dtype == "float32" else (2.0 ** -7, 2.0 ** -9)
    for got, ref, name in zip((yt.detach(), xt.grad, wt.grad), want, ("y", "dx", "dw")):
        assert got.dtype == tdt, name
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=rtol,
                                   atol=atol_rel * np.abs(ref).max(), err_msg=name)


def test_conv_fwd_style_gradcheck_float64():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 2, 4, 5, 2, dtype=torch.float64, generator=g, requires_grad=True)
    w = torch.randn(2, 3, 3, 2, 3, dtype=torch.float64, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(ck.conv_fwd_style, (x, w))


def _dw_wgmma_stages(cin, cout, h, w, smem_limit=232448, max_stages=4):
    """The ring depth ``dw_variant`` in csrc/conv_bwd.cu picks for a bf16
    shape on a card with ``smem_limit`` bytes of shared memory a block
    (the H100's 227 KB), or 0 where the shape stays off the wgmma kernel.
    The 3-D view (Cin < 8) takes exactly three stages, one per consumer
    warpgroup, or none."""
    up = lambda v, m: (v + m - 1) // m * m  # noqa: E731
    flat = cin < 8
    if cout % 32 or h + 3 > 256 or w + 2 > 256:
        return 0
    if flat and ((w * cin) % 8 or up((w + 1) * cin, 8) > 256):
        return 0
    if not flat and cin not in (8, 16, 32):
        return 0
    nc = 64 if not flat and cout % 64 == 0 else 32
    hwpad = up(h * w, 128 if flat else 64)  # dw_pixel_pad
    hb = -(-hwpad // w)
    if hb > 256:
        return 0
    x_bytes = up((h + 3) * up((w + 1) * cin, 8) * 2 if flat else (h + 2) * (w + 2) * cin * 2, 1024)
    stage = x_bytes + up(nc * 2 * w * hb, 1024)
    for stages in (3,) if flat else range(max_stages, 1, -1):
        if 1024 + stages * stage + hwpad * 4 + 16 * stages <= smem_limit:
            return stages
    return 0


def test_wgmma_dw_edges_sit_on_the_kernels_rule():
    """The card's edge cases of the wgmma conv_dw (``ck.WGMMA_DW_EDGES``)
    each pass its shape rule (mirrored from ``dw_variant``) and together
    reach its edges: both views of x (Cin 3; Cin 8 and 32), Cout 32, 64
    and 128, one pixel, odd sizes whose pixels pad to a k-step of 16, the
    largest images whose ring fits (two stages in the 4-D view, three in
    the 3-D one), and more images than the H100's 132 SMs, so blocks cross
    nodes. The main-path shapes take it too, and larger images do not: at
    Cin 3, 32×40 would fit two stages but not the three its warpgroups
    own."""
    src = (Path(ck.__file__).parent / "csrc" / "conv_bwd.cu").read_text()
    m = re.search(r"constexpr int kDwMaxStages = (\d+);", src)
    assert m, "kDwMaxStages not found in conv_bwd.cu"
    max_stages = int(m.group(1))
    assert re.search(r"constexpr int kDwWG3 = 3;", src), "the 3-D view's warpgroups changed"
    for cin, cout, (h, w), b, n in ck.WGMMA_DW_EDGES:
        assert _dw_wgmma_stages(cin, cout, h, w, max_stages=max_stages) >= 2, (cin, cout, h, w)
        assert n * b > 132
    assert _dw_wgmma_stages(3, 32, 32, 32) >= 2 and _dw_wgmma_stages(32, 64, 16, 16) >= 2
    assert not _dw_wgmma_stages(32, 64, 32, 32) and not _dw_wgmma_stages(3, 32, 64, 32)
    assert _dw_wgmma_stages(3, 32, 32, 32) == 3 and not _dw_wgmma_stages(3, 32, 32, 40)
    assert all(_dw_wgmma_stages(c, o, h, w) == 3 for c, o, (h, w), *_ in ck.WGMMA_DW_EDGES
               if c < 8)
    assert {c for c, *_ in ck.WGMMA_DW_EDGES} == {3, 8, 32}
    assert {c for _, c, *_ in ck.WGMMA_DW_EDGES} == {32, 64, 128}
    pixels = {h * w for _, _, (h, w), _, _ in ck.WGMMA_DW_EDGES}
    assert min(pixels) == 1 and any(p % 16 for p in pixels)
    assert {b for *_, b, _ in ck.WGMMA_DW_EDGES} == {1, 3}


def test_input_grad_skipped_when_not_needed():
    """Conv_0's input is data: dx is neither computed nor returned."""
    x = torch.randn(2, 1, 4, 4, 3)
    w = torch.randn(2, 3, 3, 3, 2, requires_grad=True)
    ck.node_conv(x, w).sum().backward()
    assert x.grad is None and w.grad is not None


def test_gradcheck_float64():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 1, 4, 5, 2, dtype=torch.float64, generator=g, requires_grad=True)
    w = torch.randn(2, 3, 3, 2, 3, dtype=torch.float64, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(ck.node_conv, (x, w))


def test_even_kernel_rejected():
    with pytest.raises(AssertionError, match="odd square"):
        ck.node_conv(torch.zeros(1, 1, 4, 4, 2), torch.zeros(1, 2, 2, 2, 2))
