"""The port's CUDA kernels (conv backward, flash attention) against their
plain versions, on the card.

Imports torch only, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Without a card every test skips.
"""

import itertools

import numpy as np
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
    dw_wgmma = ck.conv_dw.wgmma_launches
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
    # conv_dw: bf16, Cout a multiple of 32, Cin 8 / 16 / 32 or W·Cin a multiple of 8.
    dw_takes = dtype == torch.bfloat16 and cout % 32 == 0 and (
        cin in (8, 16, 32) or (cin < 8 and (w * cin) % 8 == 0))
    assert ck.conv_dw.wgmma_launches == dw_wgmma + dw_takes


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


def _dw_case(card, cin, cout, hw, b, n, seed):
    h, w = hw
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(n, b, h, w, cin, device=card, generator=gen).to(torch.bfloat16)
    g = torch.randn(n, b, h, w, cout, device=card, generator=gen).to(torch.bfloat16)
    before = (ck.conv_dw.launches, ck.conv_dw.wgmma_launches)
    dw = ck.conv_dw(x, g, 3)
    counts = (ck.conv_dw.launches - before[0], ck.conv_dw.wgmma_launches - before[1])
    torch.cuda.synchronize()
    ref = ck.conv_dw_plain(x, g, 3)
    torch.testing.assert_close(dw, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())
    assert torch.equal(ck.conv_dw(x, g, 3), dw)  # no float atomics: the same bits again
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("case", ck.WGMMA_DW_EDGES)
def test_conv_dw_wgmma_matches_plain_on_card(card, case):
    """bf16 dW (f32 sums of the same products in another order) against
    the plain version: 1e-4 relative plus 1e-4 of the largest value;
    the shape takes the wgmma kernel."""
    assert _dw_case(card, *case, seed=8) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(3, 32, (8, 5), 3, 67), (24, 64, (8, 8), 3, 67),
                                  (32, 48, (8, 8), 3, 67), (32, 64, (32, 32), 1, 3),
                                  (3, 32, (32, 40), 3, 67)])
def test_conv_dw_other_bf16_shapes_take_wmma_on_card(card, case):
    """W·Cin not a multiple of 8, Cin 24, Cout not a multiple of 32, an
    image whose two ring stages do not fit, and a Cin-3 image whose ring
    fits two stages but not the three the 3-D view needs: the WMMA
    kernel."""
    assert _dw_case(card, *case, seed=9) == (1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cin,cout", [(torch.bfloat16, 8, 64), (torch.bfloat16, 3, 32),
                                            (torch.float32, 3, 5)])
def test_conv_kernels_take_65537_nodes_on_card(card, dtype, cin, cout):
    """More nodes than a grid's y or z axis holds (65535): B = 1, 4×8
    images (W·Cin a multiple of 8, so Cin 3 takes conv_dw's 3-D view). bf16
    conv_dw takes the wgmma kernel; conv_dx does at Cin 8 -> Cout 64."""
    n = 65537
    gen = torch.Generator(device=card).manual_seed(10)
    x = torch.randn(n, 1, 4, 8, cin, device=card, generator=gen).to(dtype)
    g = torch.randn(n, 1, 4, 8, cout, device=card, generator=gen).to(dtype)
    k = torch.randn(n, 3, 3, cin, cout, device=card, generator=gen).to(dtype)
    wgmma = (ck.conv_dw.wgmma_launches, ck.conv_dx.wgmma_launches)
    dw, dw_ref = ck.conv_dw(x, g, 3), ck.conv_dw_plain(x, g, 3)
    torch.testing.assert_close(dw, dw_ref, rtol=1e-4, atol=1e-4 * dw_ref.abs().max().item())
    dx, dx_ref = ck.conv_dx(g, k).float(), ck.conv_dx_plain(g, k).float()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(dx, dx_ref, rtol=tol, atol=1e-3 * dx_ref.abs().max().item())
    bf16 = dtype == torch.bfloat16
    assert (ck.conv_dw.wgmma_launches - wgmma[0], ck.conv_dx.wgmma_launches - wgmma[1]) == (
        bf16, bf16 and cout % 64 == 0)


@pytest.mark.cuda
def test_conv_fwd_style_backward_on_card(card):
    """conv_fwd_style's autograd (forward-style grouped convolutions) on
    the card against plain autograd of the same grouped conv (f32, TF32
    off in both)."""
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=card).manual_seed(11)
    x = torch.randn(3, 4, 8, 8, 5, device=card, generator=gen, requires_grad=True)
    w = torch.randn(3, 3, 3, 5, 7, device=card, generator=gen, requires_grad=True)
    (ck.conv_fwd_style(x, w) ** 2).sum().backward()
    x2, w2 = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    (ck.conv_forward(x2, w2) ** 2).sum().backward()
    torch.testing.assert_close(x.grad, x2.grad, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(w.grad, w2.grad, rtol=1e-4, atol=1e-3)


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
] + [  # flash_dq's 128-row blocks and the forward's 192-row ones, cut by S
    (2, s, d, causal) for s, d, causal in itertools.product(
        (191, 192, 193), (8, 24, 64, 128), (False, True))
]


def _takes_wgmma(dtype, d):
    """The dispatch rule of csrc/flash_attn.cu: bf16 operands whose rows TMA
    can address (D a multiple of 8 up to 128) take the wgmma kernels."""
    return dtype == torch.bfloat16 and d % 8 == 0 and d <= 128


def _flash_counts(fk):
    return [(fn.launches, fn.wgmma_launches) for fn in (fk.flash_fwd, fk.flash_dq, fk.flash_dkv)]


def _assert_took(fk, before, launches, wgmma):
    """Each flash kernel launched ``launches`` times since ``before``, on
    its wgmma kernel every time (``wgmma``) or never."""
    for (n0, w0), (n1, w1) in zip(before, _flash_counts(fk)):
        assert (n1 - n0, w1 - w0) == (launches, launches if wgmma else 0)


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
    before = _flash_counts(fk)
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
    _assert_took(fk, before, 1, _takes_wgmma(dtype, d))


@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(96, 64), (200, 64), (130, 128), (129, 20), (191, 64),
                                 (193, 128), (192, 24), (193, 8)])
def test_flash_f32_outputs_of_bf16_operands_on_card(card, s, d):
    """The ring's per-step mode: bf16 operands, f32 outputs, causal, S not
    a multiple of the kernels' tiles (D = 20 takes the WMMA kernels)."""
    from tpfl_torch.parallel import flash_kernel as fk

    q, k, v, do = _flash_inputs(card, 2, s, d, torch.bfloat16, seed=3)
    before = _flash_counts(fk)
    o, lse = fk.flash_fwd(q, k, v, True, out_dtype=torch.float32)
    o_ref, _ = fk.flash_fwd_plain(q, k, v, True, out_dtype=torch.float32)
    assert o.dtype == torch.float32
    torch.testing.assert_close(o, o_ref, rtol=2.0 ** -8, atol=2.0 ** -9)
    delta = (do.float() * o).sum(-1)
    dq = fk.flash_dq(q, k, v, do, lse, delta, True, out_dtype=torch.float32)
    dq_ref = fk.flash_dq_plain(q, k, v, do, lse, delta, True, out_dtype=torch.float32)
    assert dq.dtype == torch.float32
    _close(dq, dq_ref, torch.bfloat16, "dq")
    dk, dv = fk.flash_dkv(q, k, v, do, lse, delta, True, out_dtype=torch.float32)
    dk_ref, dv_ref = fk.flash_dkv_plain(q, k, v, do, lse, delta, True, out_dtype=torch.float32)
    assert dk.dtype == dv.dtype == torch.float32
    _close(dk, dk_ref, torch.bfloat16, "dk")
    _close(dv, dv_ref, torch.bfloat16, "dv")
    _assert_took(fk, before, 1, _takes_wgmma(torch.bfloat16, d))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bh,s,d,causal", [(4, 1024, 64, True), (3, 193, 128, False),
                                           (2, 129, 20, True)])
def test_flash_dq_repeats_bit_for_bit_on_card(card, bh, s, d, causal, out_dtype):
    """Each block owns its dQ rows (no float atomics): two launches on the
    same inputs give the same bits, on the wgmma kernel and on the WMMA one
    (D = 20)."""
    from tpfl_torch.parallel import flash_kernel as fk

    q, k, v, do = _flash_inputs(card, bh, s, d, torch.bfloat16, seed=14)
    o, lse = fk.flash_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, causal)
    before = fk.flash_dq.wgmma_launches
    first = fk.flash_dq(*args, out_dtype=out_dtype)
    assert torch.equal(fk.flash_dq(*args, out_dtype=out_dtype), first)
    assert fk.flash_dq.wgmma_launches - before == (2 if _takes_wgmma(torch.bfloat16, d) else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [136, 160, 200, 256, 320])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_wide_heads_match_plain_on_card(card, d, causal, dtype):
    """Head dims past 128 (the generic kernels, in 128-column chunks of
    the output) against the plain versions."""
    from tpfl_torch.parallel import flash_kernel as fk

    q, k, v, do = _flash_inputs(card, 2, 130, d, dtype, seed=12)
    before = _flash_counts(fk)
    o, lse = fk.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = fk.flash_fwd_plain(q, k, v, causal)
    _close(o, o_ref, dtype, "o")
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-4)
    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, do, lse_ref, delta, causal)
    _close(fk.flash_dq(*args), fk.flash_dq_plain(*args), dtype, "dq")
    for name, got, ref in zip(("dk", "dv"), fk.flash_dkv(*args), fk.flash_dkv_plain(*args)):
        _close(got, ref, dtype, name)
    _assert_took(fk, before, 1, False)  # past 128: the generic kernels


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 16), (torch.bfloat16, 16),
                                     (torch.bfloat16, 64)])
def test_flash_takes_65537_heads_on_card(card, dtype, d):
    """B·H past 65535 (the grid's y limit): S = 16, causal. bf16 takes the
    wgmma kernels, f32 the CUDA-core ones."""
    from tpfl_torch.parallel import flash_kernel as fk

    q, k, v, do = _flash_inputs(card, 65537, 16, d, dtype, seed=13)
    before = _flash_counts(fk)
    o, lse = fk.flash_fwd(q, k, v, True)
    o_ref, lse_ref = fk.flash_fwd_plain(q, k, v, True)
    _close(o, o_ref, dtype, "o")
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-4)
    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, do, lse_ref, delta, True)
    _close(fk.flash_dq(*args), fk.flash_dq_plain(*args), dtype, "dq")
    for name, got, ref in zip(("dk", "dv"), fk.flash_dkv(*args), fk.flash_dkv_plain(*args)):
        _close(got, ref, dtype, name)
    _assert_took(fk, before, 1, _takes_wgmma(dtype, d))


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


# ---- the wire codec and the engine kinds on the card ------------------------

CODEC_LEAVES = {  # name -> (shape, dtype, values: "normal" | "ties" | "zeros")
    "f32 257x33": ((257, 33), torch.float32, "normal"),
    "bf16 4096": ((4096,), torch.bfloat16, "normal"),
    "f32 0-d": ((), torch.float32, "normal"),
    "f32 size-1": ((1,), torch.float32, "normal"),
    "f32 empty": ((0, 4), torch.float32, "normal"),
    "f32 zeros": ((7, 3), torch.float32, "zeros"),
    "f32 ties": ((3000,), torch.float32, "ties"),
    "bf16 ties": ((999,), torch.bfloat16, "ties"),
}


def _codec_leaf(name, seed=0):
    shape, dtype, kind = CODEC_LEAVES[name]
    gen = torch.Generator().manual_seed(seed)
    if kind == "zeros":
        x = torch.zeros(shape)
    elif kind == "ties":  # few magnitudes, both signs: top-k cuts through ties
        x = torch.randint(-4, 5, shape, generator=gen).float() / 4
    else:
        x = torch.randn(shape, generator=gen)
    return x.to(dtype)


def _roundtrip_np(row, bits, frac):
    """One node's leaf round trip from the port's numpy oracles (f32)."""
    from tpfl_torch.learning import compression as c

    row = np.asarray(row, np.float32)
    if bits & c.TOPK and row.size > 1:
        k = max(1, int(np.ceil(row.size * frac)))
        idx, vals = c.topk_encode_np(row, k)
        if bits & c.QUANT8:
            vals = c.q8_decode_np(*c.q8_encode_np(vals))
        out = np.zeros(row.size, np.float32)
        out[idx.astype(np.int64)] = vals
        return out.reshape(row.shape)
    return np.asarray(c.q8_decode_np(*c.q8_encode_np(row)) if bits & c.QUANT8 else row)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CODEC_LEAVES))
def test_codec_bit_equal_to_numpy_oracle_on_card(card, name):
    """q8 / top-k and every node's engine round trip on CUDA tensors,
    bit for bit against the port's numpy oracles."""
    from tpfl_torch.learning import compression as c

    x = _codec_leaf(name)
    xf = x.float().numpy()
    xc = x.to(card)
    q, s = c.q8_encode(xc)
    qn, sn = c.q8_encode_np(xf)
    assert q.cpu().numpy().tobytes() == qn.tobytes()
    assert s.cpu().numpy().tobytes() == np.float32(sn).tobytes()
    assert c.q8_decode(q, s).cpu().numpy().tobytes() == c.q8_decode_np(qn, sn).tobytes()
    for k in sorted({1, max(1, x.numel() // 20), max(1, x.numel())}):
        i, v = c.topk_encode(xc, k)
        i_np, v_np = c.topk_encode_np(xf, k)
        assert np.array_equal(i.cpu().numpy(), i_np) and v.cpu().numpy().tobytes() == v_np.tobytes()
    nodes = torch.stack([x, -2 * x, x.flip(-1) if x.dim() else x]).to(card)
    for bits in (c.QUANT8, c.TOPK, c.QUANT8 | c.TOPK):
        got = c.engine_codec_roundtrip_nodes(bits, 0.05)(nodes).cpu()
        assert got.dtype == x.dtype
        for r in range(3):
            row = nodes[r].cpu()
            want = row if row.numel() == 0 else torch.from_numpy(
                _roundtrip_np(row.float().numpy(), bits, 0.05)).to(x.dtype)
            assert torch.equal(got[r], want), (bits, r)


ROUND_CASES = [("resnet", "scaffold", "local"), ("resnet", "fedavg", "mean"),
               ("resnet", "fedprox", "mean"), ("cnn", "scaffold", "mean")]


@pytest.mark.cuda
@pytest.mark.parametrize("model,algorithm,aux_mode", ROUND_CASES)
def test_engine_kind_round_on_card_matches_cpu(card, model, algorithm, aux_mode):
    """A small f32 2-round window of each kind on the card (the CNN
    through the conv kernels) against the same window on the CPU: f32
    sums in other orders, rtol 1e-3, atol 1e-4. TF32 off.

    Node i starts from the init scaled by 1 + i/4, so the nodes differ.
    With all three nodes at the same init, one pre-activation of node 2
    at ResidualBlock_0's output ReLU lies within 1e-6 of its largest
    from zero, where f32 rounding on either device may flip the ReLU's
    mask: a kink of the function, which moves that node's stage-0
    gradients by up to 9% (the card's f32 and f64 runs differ there; on
    the same inputs each convolution agrees with f64 to 1e-5)."""
    from tpfl_torch.models import CNN, ResNet18
    from tpfl_torch.parallel import FederationEngine
    from tpfl_torch.utils.tree import tree_items, tree_map

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    xs = rng.uniform(size=(3, 2, 4, 8, 8, 3)).astype(np.float32)
    ys = rng.integers(0, 10, size=(3, 2, 4)).astype(np.int32)
    out = {}
    for dev in ("cpu", card):
        module = (ResNet18(stage_sizes=(1, 1), out_channels=10, compute_dtype=torch.float32)
                  if model == "resnet" else
                  CNN(channels=(4, 8), dense=16, compute_dtype=torch.float32,
                      conv_impl="pallas"))
        eng = FederationEngine(module, 3, algorithm=algorithm, aux_mode=aux_mode,
                               prox_mu=0.1, device=dev)
        params, aux = eng.init_state((8, 8, 3))
        scale = 1.0 + torch.arange(3, device=eng.device, dtype=torch.float32) / 4
        params = tree_map(lambda v: v * scale.reshape((-1,) + (1,) * (v.dim() - 1)), params)
        kw = {"aux": aux} if aux else {}
        if algorithm == "scaffold":
            kw["scaffold_state"] = eng.init_scaffold_state(params)
        res = eng.run_rounds(params, xs, ys, weights=[1.0, 0.0, 2.0], n_rounds=2, **kw)
        out[str(dev)] = [dict(tree_items(t)) if isinstance(t, dict) else t for t in res]
    cpu, gpu = out["cpu"], out[str(card)]
    assert len(cpu) == len(gpu) == (4 if algorithm == "scaffold" else 3 if model == "resnet"
                                    else 2)
    for a, b in zip(gpu, cpu):
        if isinstance(b, tuple):  # (c_locals, c_global)
            a = {**dict(tree_items(a[0])), **{f"g/{k}": v for k, v in tree_items(a[1])}}
            b = {**dict(tree_items(b[0])), **{f"g/{k}": v for k, v in tree_items(b[1])}}
        if isinstance(b, dict):
            assert sorted(a) == sorted(b)
            for path in b:
                torch.testing.assert_close(a[path].cpu(), b[path], rtol=1e-3, atol=1e-4,
                                           msg=lambda m, path=path: f"{path}: {m}")
        else:
            torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-4)


# ---- the protocol learning layer on the card -------------------------------


def _learner(dev, data, agg=None, conv_impl="pallas", dtype=torch.float32, channels=(4, 8),
             dense=16, shape=(8, 8, 3), lr=0.1, addr="node-0"):
    """A TorchLearner of a small CNN on ``dev`` from seed-0 params."""
    from tpfl_torch.learning.dataset import TpflDataset
    from tpfl_torch.learning.model import TpflModel
    from tpfl_torch.learning.torch_learner import TorchLearner
    from tpfl_torch.models import CNN, init_params

    module = CNN(channels=channels, dense=dense, compute_dtype=dtype, conv_impl=conv_impl)
    model = TpflModel(module, init_params(module, shape, seed=0, device="cpu"), device=dev)
    return TorchLearner(model, TpflDataset.from_arrays(*data), addr=addr, aggregator=agg,
                        learning_rate=lr, batch_size=8, device=dev)


def _small_data(n_train=40, n_test=13, shape=(8, 8, 3), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n_train, *shape)).astype(np.float32),
            rng.integers(0, 10, n_train).astype(np.int32),
            rng.uniform(size=(n_test, *shape)).astype(np.float32),
            rng.integers(0, 10, n_test).astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("agg", [None, "fedprox", "scaffold"])
def test_learner_fit_on_card_matches_cpu(card, agg):
    """Two fits of a small f32 CNN through the conv kernels (and its
    evaluate) on the card against the CPU: rtol 1e-3, atol 1e-4, TF32
    off."""
    from tpfl_torch.interop import params_to_numpy
    from tpfl_torch.learning.aggregators import FedProx, Scaffold
    from tpfl_torch.utils.tree import tree_items

    torch.backends.cudnn.allow_tf32 = False
    data = _small_data()
    runs = {}
    for dev in ("cpu", card):
        a = {None: None, "fedprox": FedProx("a", proximal_mu=0.2, device=dev),
             "scaffold": Scaffold("a", device=dev)}[agg]
        learner = _learner(dev, data, agg=a, lr=0.05)
        for _ in range(2):
            model = learner.fit()
        runs[str(dev)] = (dict(tree_items(params_to_numpy(model.get_parameters()))),
                          learner.evaluate())
    (cpu, cpu_m), (gpu, gpu_m) = runs["cpu"], runs[str(card)]
    for path in cpu:
        np.testing.assert_allclose(gpu[path], cpu[path], rtol=1e-3, atol=1e-4, err_msg=path)
    assert gpu_m == pytest.approx(cpu_m, rel=1e-3, abs=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fedavg", "scaffold", "fedmedian"])
def test_aggregator_fold_on_card_matches_cpu(card, kind):
    """The same four models folded on the card and on the CPU (f32
    sums in other orders: rtol 1e-6; the median is exact)."""
    from tpfl_torch.interop import params_to_numpy
    from tpfl_torch.learning.aggregators import FedAvg, FedMedian, Scaffold
    from tpfl_torch.learning.model import TpflModel
    from tpfl_torch.utils.tree import tree_items

    rng = np.random.default_rng(1)

    def tree():
        return {"Dense_0": {"kernel": rng.normal(size=(64, 33)).astype(np.float32),
                            "bias": rng.normal(size=(33,)).astype(np.float32)}}

    specs = [(f"n{i}", tree(), {"scaffold": {"delta_y_i": tree(), "delta_c_i": tree()}},
              n) for i, n in enumerate([3, 1, 4, 2])]
    outs = {}
    for dev in ("cpu", card):
        agg = {"fedavg": FedAvg, "scaffold": Scaffold, "fedmedian": FedMedian}[kind](
            "a", device=dev)
        agg.set_nodes_to_aggregate([s[0] for s in specs])
        for name, params, info, n in specs:
            agg.add_model(TpflModel(params=params, num_samples=n, contributors=[name],
                                    additional_info=info, device=dev))
        out = agg.wait_and_get_aggregation(timeout=10)
        assert out.get_parameters()["Dense_0"]["kernel"].device.type == torch.device(dev).type
        outs[str(dev)] = dict(tree_items(params_to_numpy(out.get_parameters())))
    for path, want in outs["cpu"].items():
        np.testing.assert_allclose(outs[str(card)][path], want, rtol=1e-6, atol=1e-7,
                                   err_msg=path)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["v1", "v3", "quant8", "topk+quant8+zlib"])
def test_encodes_of_card_tensors_equal_cpu_encodes(card, codec):
    """v1 / v3 / v2 envelopes of card tensors (f32, bf16, int32, bool,
    0-d, empty, non-contiguous) byte-equal to the same tensors' CPU
    encodes."""
    from tpfl_torch.learning import compression, serialization

    gen = torch.Generator().manual_seed(0)
    tree = {"a": {"kernel": torch.randn(33, 17, generator=gen),
                  "bias": torch.randn(17, generator=gen).to(torch.bfloat16)},
            "i": torch.arange(-3, 4, dtype=torch.int32), "b": torch.tensor([True, False]),
            "z": torch.tensor(2.5), "e": torch.zeros(0, 3),
            "t": torch.randn(6, 5, generator=gen).T}
    info = {"mu": 0.1, "c": torch.ones(4)}

    def encode(t, i):
        if codec == "v1":
            return serialization.encode_model_payload(t, ["a"], 3, i)
        if codec == "v3":
            return serialization.encode_model_payload_v3(t, ["a"], 3, i)
        return compression.encode_model_payload(t, ["a"], 3, i, codec, topk_frac=0.2)

    on_card = {k: ({kk: vv.to(card) for kk, vv in v.items()} if isinstance(v, dict)
                   else v.to(card)) for k, v in tree.items()}
    assert encode(on_card, {"mu": 0.1, "c": info["c"].to(card)}) == encode(tree, info)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", ck.ONE_NODE_BATCHES)
def test_learner_conv_launches_take_wgmma_at_one_node(card, batch):
    """The full-width bf16 CNN learner at N = 1 and the batch sizes the
    card's learners run (128, and the Byzantine and chaos federations'
    25 and 32): each step's two conv_dw and one conv_dx launches take the
    wgmma kernels."""
    data = _small_data(n_train=256, n_test=8, shape=(32, 32, 3))
    learner = _learner(card, data, dtype=torch.bfloat16, channels=(32, 64), dense=128,
                       shape=(32, 32, 3))
    learner.batch_size = batch
    before = {n: (getattr(ck, n).launches, getattr(ck, n).wgmma_launches)
              for n in ("conv_dw", "conv_dx")}
    learner.fit()
    torch.cuda.synchronize()
    steps = 256 // batch
    for name, per_step in (("conv_dw", 2), ("conv_dx", 1)):
        fn = getattr(ck, name)
        launched = fn.launches - before[name][0]
        assert launched == per_step * steps, name
        assert fn.wgmma_launches - before[name][1] == launched, name


@pytest.mark.cuda
def test_launch_counts_exact_under_concurrent_launches(card):
    """8 threads × 16 launches of each conv kernel at once (every node of
    an in-process federation fits on its own thread): every launch is
    counted, every one on its wgmma kernel (bf16 Conv_1 of the CNN at one
    node), and each result equals the plain version's."""
    import threading

    gen = torch.Generator(device=card).manual_seed(5)
    x = torch.randn(1, 32, 16, 16, 32, device=card, generator=gen).bfloat16()
    g = torch.randn(1, 32, 16, 16, 64, device=card, generator=gen).bfloat16()
    w = torch.randn(1, 3, 3, 32, 64, device=card, generator=gen).bfloat16()
    before = (ck.conv_dw.launches, ck.conv_dw.wgmma_launches,
              ck.conv_dx.launches, ck.conv_dx.wgmma_launches)
    start = threading.Barrier(8)
    outs, errors = [], []

    def launch_many():
        try:
            start.wait()
            for _ in range(16):
                outs.append((ck.conv_dw(x, g, 3), ck.conv_dx(g, w)))
        except Exception as e:  # surfaced below: a thread's failure fails the test
            errors.append(e)

    threads = [threading.Thread(target=launch_many) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not errors, errors
    after = (ck.conv_dw.launches, ck.conv_dw.wgmma_launches,
             ck.conv_dx.launches, ck.conv_dx.wgmma_launches)
    assert tuple(a - b for a, b in zip(after, before)) == (128, 128, 128, 128)
    dw_ref, dx_ref = ck.conv_dw_plain(x, g, 3), ck.conv_dx_plain(g, w).float()
    for dw, dx in outs:
        torch.testing.assert_close(dw, dw_ref, rtol=1e-4, atol=1e-4 * dw_ref.abs().max().item())
        torch.testing.assert_close(dx.float(), dx_ref, rtol=2.0 ** -7,
                                   atol=1e-3 * dx_ref.abs().max().item())
