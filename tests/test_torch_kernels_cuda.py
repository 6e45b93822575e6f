"""The port's CUDA kernels (conv backward, flash attention) against their
plain versions, on the card.

Imports torch only, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Without a card every test skips.
"""

import itertools

import pytest
import torch

from tpfl_torch.parallel import conv_kernel as ck

SHAPES = [(4, 8, 8, 3, 5), (2, 16, 16, 32, 8), (2, 6, 10, 7, 3), (3, 8, 8, 3, 32),
          (2, 16, 16, 32, 64)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_on_card(card, shape, dtype):
    """3 nodes. Tolerance: f32 sums in another order (1e-4 of the
    largest value); bf16 dx outputs may round one bf16 ulp apart."""
    b, h, w, cin, cout = shape
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(3, b, h, w, cin, device=card, generator=gen).to(dtype)
    g = torch.randn(3, b, h, w, cout, device=card, generator=gen).to(dtype)
    k = torch.randn(3, 3, 3, cin, cout, device=card, generator=gen).to(dtype)
    launches = (ck.conv_dw.launches, ck.conv_dx.launches)
    dw, dw_ref = ck.conv_dw(x, g, 3), ck.conv_dw_plain(x, g, 3)
    torch.testing.assert_close(dw, dw_ref, rtol=1e-4, atol=1e-4 * dw_ref.abs().max().item())
    wgmma = ck.conv_dx.wgmma_launches
    dx, dx_ref = ck.conv_dx(g, k).float(), ck.conv_dx_plain(g, k).float()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(dx, dx_ref, rtol=tol, atol=1e-3 * dx_ref.abs().max().item())
    assert (ck.conv_dw.launches, ck.conv_dx.launches) == (launches[0] + 1, launches[1] + 1)
    # Only bf16 with Cout a multiple of 64 (here Cin 32 -> Cout 64) takes wgmma.
    takes_wgmma = dtype == torch.bfloat16 and cout % 64 == 0 and cin % 8 == 0
    assert ck.conv_dx.wgmma_launches == wgmma + takes_wgmma


# Shapes the wgmma conv_dx refuses, which stay on the WMMA kernel: a ring
# that does not fit, too many pixels, Cin not a multiple of 8 or above 64,
# Cout not a multiple of 64. (Cin, Cout, (H, W), B, N) as ck.WGMMA_DX_EDGES.
DX_WMMA_CASES = [(32, 128, (16, 32), 3, 67), (32, 64, (17, 32), 3, 67),
                 (12, 64, (16, 16), 3, 67), (72, 64, (16, 16), 3, 67),
                 (32, 96, (16, 16), 3, 67)]


def _dx_case(card, cin, cout, hw, b, n, seed):
    h, w = hw
    gen = torch.Generator(device=card).manual_seed(seed)
    g = torch.randn(n, b, h, w, cout, device=card, generator=gen).to(torch.bfloat16)
    k = torch.randn(n, 3, 3, cin, cout, device=card, generator=gen).to(torch.bfloat16)
    before = (ck.conv_dx.launches, ck.conv_dx.wgmma_launches)
    dx = ck.conv_dx(g, k)
    torch.cuda.synchronize()
    ref = ck.conv_dx_plain(g, k).float()
    torch.testing.assert_close(dx.float(), ref, rtol=2.0 ** -7,
                               atol=1e-3 * ref.abs().max().item())
    return ck.conv_dx.launches - before[0], ck.conv_dx.wgmma_launches - before[1]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ck.WGMMA_DX_EDGES)
def test_conv_dx_wgmma_matches_plain_on_card(card, case):
    """bf16 dx against the plain version: one bf16 rounding apart (2^-7),
    plus the f32 order near zero (1e-3 of the largest value)."""
    assert _dx_case(card, *case, seed=5) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DX_WMMA_CASES)
def test_conv_dx_other_bf16_shapes_take_wmma_on_card(card, case):
    assert _dx_case(card, *case, seed=6) == (1, 0)


@pytest.mark.cuda
def test_node_conv_backward_on_card(card):
    """node_conv's autograd on the card against plain autograd of the
    same grouped conv (f32, TF32 off)."""
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=card).manual_seed(1)
    x = torch.randn(3, 4, 8, 8, 5, device=card, generator=gen, requires_grad=True)
    w = torch.randn(3, 3, 3, 5, 7, device=card, generator=gen, requires_grad=True)
    (ck.node_conv(x, w) ** 2).sum().backward()
    x2, w2 = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    (ck.conv_forward(x2, w2) ** 2).sum().backward()
    torch.testing.assert_close(x.grad, x2.grad, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(w.grad, w2.grad, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(card):
    x = torch.zeros(1, 1, 4, 4, 2, device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="unsupported dtype"):
        ck.conv_dw(x, x, 3)
    y = torch.zeros(1, 1, 4, 4, 2, device=card)
    with pytest.raises(TypeError, match="dtypes differ"):
        ck.conv_dw(y, y.to(torch.bfloat16), 3)


# ---- flash attention ---------------------------------------------------------

FLASH_CASES = [  # (BH, S, D, causal)
    (3, 64, 64, True), (2, 100, 32, False), (2, 100, 32, True), (2, 130, 8, True),
    (2, 77, 8, False), (1, 192, 128, True), (2, 64, 128, False), (1, 250, 64, False),
    (2, 16, 64, True), (1, 1, 16, False), (2, 129, 20, True), (2, 100, 12, False),
] + [  # the edges of the wgmma kernels' tiles: 64-key / 64-query ring stages,
    # 128- and 192-row blocks, D padded to 64 or 128
    (2, s, d, causal) for s, d, causal in itertools.product(
        (127, 128, 129, 255, 256), (32, 64, 96, 128), (False, True))
]


def _flash_inputs(card, bh, s, d, dtype, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    q, k, v, do = (torch.randn(bh, s, d, device=card, generator=gen).to(dtype) for _ in range(4))
    return q, k, v, do


def _close(got, ref, dtype, what):
    """f32: sums in another order (1e-4 of the largest value). bf16: one
    bf16 rounding of P / dS on another running max and of the output,
    2^-7 relative plus 2^-8 of the largest value."""
    got, ref = got.float(), ref.float()
    scale = ref.abs().max().item()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * scale, msg=what)
    else:
        torch.testing.assert_close(got, ref, rtol=2.0 ** -7, atol=2.0 ** -8 * scale, msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_match_plain_on_card(card, case, dtype):
    from tpfl_torch.parallel import flash_kernel as fk

    bh, s, d, causal = case
    q, k, v, do = _flash_inputs(card, bh, s, d, dtype)
    launches = (fk.flash_fwd.launches, fk.flash_dq.launches, fk.flash_dkv.launches)
    o, lse = fk.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = fk.flash_fwd_plain(q, k, v, causal)
    _close(o, o_ref, dtype, "o")
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-4)
    delta = (do.float() * o_ref.float()).sum(-1)
    dq = fk.flash_dq(q, k, v, do, lse_ref, delta, causal)
    dk, dv = fk.flash_dkv(q, k, v, do, lse_ref, delta, causal)
    torch.cuda.synchronize()
    _close(dq, fk.flash_dq_plain(q, k, v, do, lse_ref, delta, causal), dtype, "dq")
    dk_ref, dv_ref = fk.flash_dkv_plain(q, k, v, do, lse_ref, delta, causal)
    _close(dk, dk_ref, dtype, "dk")
    _close(dv, dv_ref, dtype, "dv")
    assert (fk.flash_fwd.launches, fk.flash_dq.launches, fk.flash_dkv.launches) == tuple(
        n + 1 for n in launches)


@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(96, 64), (200, 64), (130, 128), (129, 20)])
def test_flash_f32_outputs_of_bf16_operands_on_card(card, s, d):
    """The ring's per-step mode: bf16 operands, f32 outputs, causal, S not
    a multiple of the kernels' tiles (D = 20 takes the WMMA kernels)."""
    from tpfl_torch.parallel import flash_kernel as fk

    q, k, v, do = _flash_inputs(card, 2, s, d, torch.bfloat16, seed=3)
    o, lse = fk.flash_fwd(q, k, v, True, out_dtype=torch.float32)
    o_ref, _ = fk.flash_fwd_plain(q, k, v, True, out_dtype=torch.float32)
    assert o.dtype == torch.float32
    torch.testing.assert_close(o, o_ref, rtol=2.0 ** -8, atol=2.0 ** -9)
    delta = (do.float() * o).sum(-1)
    dk, dv = fk.flash_dkv(q, k, v, do, lse, delta, True, out_dtype=torch.float32)
    dk_ref, dv_ref = fk.flash_dkv_plain(q, k, v, do, lse, delta, True, out_dtype=torch.float32)
    assert dk.dtype == dv.dtype == torch.float32
    _close(dk, dk_ref, torch.bfloat16, "dk")
    _close(dv, dv_ref, torch.bfloat16, "dv")


@pytest.mark.cuda
def test_flash_attention_autograd_on_card(card):
    """flash_attention's autograd on the card (f32) against plain
    autograd of the same attention."""
    from tpfl_torch.parallel import flash_kernel as fk

    gen = torch.Generator(device=card).manual_seed(2)
    q, k, v = (torch.randn(2, 80, 3, 16, device=card, generator=gen, requires_grad=True)
               for _ in range(3))
    cot = torch.randn(2, 80, 3, 16, device=card, generator=gen)
    (fk.flash_attention(q, k, v, causal=True) * cot).sum().backward()
    q2, k2, v2 = (t.detach().requires_grad_(True) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q2, k2) / 4.0
    s = s.masked_fill(torch.ones(80, 80, device=card, dtype=torch.bool).triu(1), float("-inf"))
    ref = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v2)
    (ref * cot).sum().backward()
    for a, b in ((q, q2), (k, k2), (v, v2)):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_flash_wrappers_reject_what_the_kernels_do_not_take(card):
    from tpfl_torch.parallel import flash_kernel as fk

    x = torch.zeros(1, 8, 16, device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="unsupported dtype"):
        fk.flash_fwd(x, x, x, True)
    y = torch.zeros(1, 8, 160, device=card)
    with pytest.raises(ValueError, match="head dim"):
        fk.flash_fwd(y, y, y, True)
    z = torch.zeros(1, 8, 16, device=card)
    with pytest.raises(TypeError, match="dtypes differ"):
        fk.flash_fwd(z, z.to(torch.bfloat16), z, True)
    with pytest.raises(ValueError, match="contiguous"):
        fk.flash_fwd(z.transpose(1, 2).contiguous().transpose(1, 2), z, z, True)
    with pytest.raises(TypeError, match="output dtype"):
        fk.flash_fwd(z, z, z, True, out_dtype=torch.bfloat16)
    lse = torch.zeros(1, 8, device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="lse / delta"):
        fk.flash_dq(z, z, z, z, lse, lse, True)
