"""Parity of the port's per-node conv (tpfl_torch.parallel.conv_kernel)
with the JAX package's Pallas ``node_conv`` (interpret mode on the CPU).

Inputs come from a numpy seed and go through both packages. f32
comparisons use the JAX suite's own tolerance for this op
(rtol=1e-4, atol=1e-3, tests/test_parallel.py): the two sides sum the
same products in different orders.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
