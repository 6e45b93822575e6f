"""The port's CUDA conv kernels against their plain versions, on the card.

Imports torch only, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Without a card every test skips.
"""

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
    dx, dx_ref = ck.conv_dx(g, k).float(), ck.conv_dx_plain(g, k).float()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(dx, dx_ref, rtol=tol, atol=1e-3 * dx_ref.abs().max().item())
    assert (ck.conv_dw.launches, ck.conv_dx.launches) == (launches[0] + 1, launches[1] + 1)


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
