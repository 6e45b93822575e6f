"""Per-node 3×3 convolution with a hand-written CUDA backward — the hot
op of the federation round, counterpart of
:mod:`tpfl.parallel.conv_kernel`.

``node_conv`` trains N nodes' DISTINCT conv weights in one call:
operands carry a leading node axis (the ``vmap`` of the JAX package,
written out), ``x [N, B, H, W, Cin]`` and a flax-layout kernel
``w [N, k, k, Cin, Cout]``. The forward is the SAME / stride-1 conv of
``conv_kernel.py:117-120`` as one grouped ``F.conv2d`` (groups = N).
The backward is two kernels from ``csrc/conv_bwd.cu``:

- :func:`conv_dw` — ``dW = im2col(x)ᵀ · dout`` per node, f32
  accumulated (replaces ``_dw_kernel``);
- :func:`conv_dx` — ``dx = im2col(dout) · rot180(w)ᵀ`` per node
  (replaces ``_dx_kernel``), skipped when the input needs no gradient
  (the first conv, whose input is data).

``conv_fwd_style`` is the reference's other backward: both gradients as
forward-style grouped convolutions (``F.conv2d``), no kernel of its own.

Each wrapper runs its kernel's plain im2col version (:func:`conv_dw_plain`,
:func:`conv_dx_plain`) when the tensors lie on the CPU, and only then: on
a CUDA tensor it launches the kernel or raises. ``conv_dw.launches`` /
``conv_dx.launches`` count kernel launches; ``conv_dw.wgmma_launches``
and ``conv_dx.wgmma_launches`` count those of them that took the Hopper
(wgmma + TMA) kernel, which the launcher picks by shape and reports
after the launch.

Restrictions (asserted, as in the reference): odd square kernels,
stride 1, SAME padding.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_kernel(w: torch.Tensor) -> int:
    k, k2 = w.shape[1], w.shape[2]
    assert k == k2 and k % 2 == 1, "node_conv: odd square kernels only"
    return k


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 accumulation (f64 stays f64, for gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def _patches(a: torch.Tensor, k: int) -> torch.Tensor:
    """im2col of a node-stacked NHWC tensor with the zero SAME halo:
    [N, B, H, W, C] -> [N, B·H·W, k²·C], channel (di·k + dj)·C + c —
    the order of ``conv_kernel.py:68-79``."""
    n, b, h, w, c = a.shape
    r = k // 2
    pad = F.pad(a, (0, 0, r, r, r, r))
    cols = [
        pad[:, :, di:di + h, dj:dj + w, :]
        for di in range(k) for dj in range(k)
    ]
    return torch.cat(cols, dim=-1).reshape(n, b * h * w, k * k * c)


def _rot_kernel(w: torch.Tensor) -> torch.Tensor:
    """rot180(w) with in/out swapped, as the [N, k²·Cout, Cin] matrix of
    ``conv_kernel.py:171-173``."""
    n, k, _, cin, cout = w.shape
    return w.flip(1, 2).transpose(3, 4).reshape(n, k * k * cout, cin)


def conv_dw_plain(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of :func:`conv_dw`: [N, k, k, Cin, Cout] in f32
    (f64 for f64 inputs)."""
    n, b, h, w, cin = x.shape
    acc = _acc_dtype(x.dtype)
    p = _patches(x, k).to(acc)
    gm = g.reshape(n, b * h * w, g.shape[-1]).to(acc)
    return torch.bmm(p.transpose(1, 2), gm).reshape(n, k, k, cin, g.shape[-1])


def conv_dx_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`conv_dx`: [N, B, H, W, Cin] in g's dtype."""
    n, b, h, wd, _ = g.shape
    k = _check_kernel(w)
    acc = _acc_dtype(g.dtype)
    dx = torch.bmm(_patches(g, k).to(acc), _rot_kernel(w).to(acc))
    return dx.reshape(n, b, h, wd, w.shape[3]).to(g.dtype)


def _lib() -> ctypes.CDLL:
    from tpfl_torch.parallel import _build

    lib = _build.load("conv_bwd")
    if not getattr(lib, "_tpfl_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.tpfl_conv_dw_partials.argtypes = [vp, vp] + [i] * 8
        lib.tpfl_conv_dw_partials.restype = ctypes.c_long
        lib.tpfl_conv_dw.argtypes = ([vp, vp, vp, vp] + [i] * 7
                                     + [ctypes.c_long, i, vp, ctypes.POINTER(i)])
        lib.tpfl_conv_dw.restype = i
        lib.tpfl_conv_dx.argtypes = [vp, vp, vp] + [i] * 8 + [vp, ctypes.POINTER(i)]
        lib.tpfl_conv_dx.restype = i
        lib._tpfl_typed = True
    return lib


def _check_cuda(*tensors: torch.Tensor) -> int:
    dev = tensors[0].device
    dtype = tensors[0].dtype
    for t in tensors:
        if t.device != dev:
            raise ValueError("conv kernels: operands on different devices")
        if t.dtype != dtype:
            raise TypeError(
                f"conv kernels: operand dtypes differ ({t.dtype} vs {dtype})"
            )
        if not t.is_contiguous():
            raise ValueError("conv kernels: operands must be contiguous")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"conv kernels: unsupported dtype {dtype}")
    return _DTYPE_CODES[dtype]


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def conv_dw(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """Per-node weight gradient, f32 [N, k, k, Cin, Cout], from
    ``x [N, B, H, W, Cin]`` and ``g [N, B, H, W, Cout]`` (same dtype).
    CPU tensors take :func:`conv_dw_plain`; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return conv_dw_plain(x, g, k)
    code = _check_cuda(x, g)
    n, b, h, w, cin = x.shape
    cout = g.shape[-1]
    if g.shape[:4] != x.shape[:4]:
        raise ValueError(f"conv_dw: x {tuple(x.shape)} vs g {tuple(g.shape)}")
    lib = _lib()
    # The launcher picks the kernel and its split, so it sizes the f32
    # scratch of partial sums: a count of [k²·Cin, Cout] slices.
    partials = lib.tpfl_conv_dw_partials(x.data_ptr(), g.data_ptr(), n, b, h, w, cin, cout,
                                         k, code)
    if partials < 0:
        _raise_on(-partials, "conv_dw")
    out = torch.empty((n, k, k, cin, cout), device=x.device, dtype=torch.float32)
    partial = (torch.empty((partials, k * k * cin, cout), device=x.device, dtype=torch.float32)
               if partials else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    took_wgmma = ctypes.c_int(0)
    err = lib.tpfl_conv_dw(
        x.data_ptr(), g.data_ptr(),
        None if partial is None else partial.data_ptr(), out.data_ptr(),
        n, b, h, w, cin, cout, k, partials, code, stream, ctypes.byref(took_wgmma),
    )
    _raise_on(err, "conv_dw")
    conv_dw.launches += 1
    conv_dw.wgmma_launches += took_wgmma.value
    return out


def conv_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-node input gradient [N, B, H, W, Cin] in g's dtype, from
    ``g [N, B, H, W, Cout]`` and ``w [N, k, k, Cin, Cout]``. CPU tensors
    take :func:`conv_dx_plain`; CUDA tensors the kernel."""
    if g.device.type == "cpu":
        return conv_dx_plain(g, w)
    code = _check_cuda(g, w)
    k = _check_kernel(w)
    n, b, h, wd, cout = g.shape
    cin = w.shape[3]
    if w.shape[0] != n or w.shape[4] != cout:
        raise ValueError(f"conv_dx: g {tuple(g.shape)} vs w {tuple(w.shape)}")
    dx = torch.empty((n, b, h, wd, cin), device=g.device, dtype=g.dtype)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    # The launcher picks the kernel by shape and says whether it took wgmma.
    took_wgmma = ctypes.c_int(0)
    _raise_on(_lib().tpfl_conv_dx(g.data_ptr(), w.data_ptr(), dx.data_ptr(), n, b, h, wd,
                                  cin, cout, k, code, stream, ctypes.byref(took_wgmma)),
              "conv_dx")
    conv_dx.launches += 1
    conv_dx.wgmma_launches += took_wgmma.value
    return dx


# bf16 conv_dx shapes at the edges of the wgmma kernel's rule, each of which
# must take it: (Cin, Cout, (H, W), B, N). 32-channel input tiles cut by Cin,
# one or two 64-channel chunks of Cout, images from one pixel to the largest
# whose halo'd chunks fit a 2-stage ring beside the weights on an H100 (512
# pixels at Cout = 64; at Cout = 128 the weights take twice the room). About
# 200 images, so the persistent blocks' image ranges cross node boundaries
# (B = 1: every image is a node of its own).
_DX_EDGE_HW = {64: [(16, 16), (5, 7), (1, 1), (16, 32)],
               128: [(16, 16), (5, 7), (1, 1), (20, 22)]}
WGMMA_DX_EDGES = [(cin, cout, hw, b, 203 if b == 1 else 67)
                  for cin in (8, 32, 40, 64) for cout in (64, 128)
                  for hw in _DX_EDGE_HW[cout] for b in (1, 3)]

# bf16 conv_dw shapes at the edges of the wgmma kernel's rule, each of which
# must take it: (Cin, Cout, (H, W), B, N) as WGMMA_DX_EDGES. Cin 3 takes the
# 3-D view of x (W·Cin a multiple of 8: W a multiple of 8), Cin 8 and 32 the
# 4-D one; Cout 32 (32-channel chunks), 64 (one 64-channel chunk) and 128
# (two on the grid); images from one pixel to the largest whose ring fits
# on an H100 (two stages in the 4-D view, the 3-D view's three: one per
# consumer warpgroup), odd sizes whose pixels pad to a k-step of 16,
# and ~200 images so the persistent blocks' ranges cross nodes.
_DW_EDGE_HW = {3: [(32, 32), (7, 8), (1, 8), (9, 16)],
               8: [(16, 16), (5, 7), (1, 1), (16, 32)],
               32: [(16, 16), (5, 7), (1, 1), (16, 32)]}
WGMMA_DW_EDGES = [(cin, cout, hw, b, 203 if b == 1 else 67)
                  for cin in (3, 8, 32) for cout in (32, 64, 128)
                  for hw in _DW_EDGE_HW[cin] for b in (1, 3)]

conv_dw.launches = 0
conv_dw.wgmma_launches = 0
conv_dx.launches = 0
conv_dx.wgmma_launches = 0


def conv_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME / stride-1 conv per node as one grouped ``F.conv2d``:
    [N, B, H, W, Cin] · [N, k, k, Cin, Cout] -> [N, B, H, W, Cout]."""
    n, b, h, wd, cin = x.shape
    k = _check_kernel(w)
    cout = w.shape[4]
    xg = x.permute(1, 0, 4, 2, 3).reshape(b, n * cin, h, wd)
    wg = w.permute(0, 4, 3, 1, 2).reshape(n * cout, cin, k, k)
    y = F.conv2d(xg, wg, padding=k // 2, groups=n)
    return y.reshape(b, n, cout, h, wd).permute(1, 0, 3, 4, 2).contiguous()


class NodeConv(torch.autograd.Function):
    """Grouped ``F.conv2d`` forward, :func:`conv_dw` / :func:`conv_dx`
    backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        _check_kernel(w)
        ctx.save_for_backward(x, w)
        return conv_forward(x, w)

    @staticmethod
    def backward(ctx, gy: torch.Tensor):
        x, w = ctx.saved_tensors
        g = gy.to(x.dtype).contiguous()
        dx: Optional[torch.Tensor] = None
        if ctx.needs_input_grad[0]:
            dx = conv_dx(g, w.contiguous())
        dw = None
        if ctx.needs_input_grad[1]:
            dw = conv_dw(x.contiguous(), g, w.shape[1]).to(w.dtype)
        return dx, dw


def node_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3×3 / SAME / stride-1 per-node conv with the CUDA backward."""
    return NodeConv.apply(x, w)


def conv_dw_fwd_style(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """The weight gradient as one forward-style grouped convolution
    (``conv_kernel.py:234-237``): per node, Cin is the convolution's batch,
    B its contraction channel and dout its H×W window, ``[Cin, B, H, W] ⋆
    [Cout, B, H, W] -> [Cin, Cout, k, k]`` with padding k//2; returned as
    HWIO ``[N, k, k, Cin, Cout]`` in x's dtype."""
    n, b, h, wd, cin = x.shape
    cout = g.shape[-1]
    xg = x.permute(4, 0, 1, 2, 3).reshape(cin, n * b, h, wd)
    gg = g.permute(0, 4, 1, 2, 3).reshape(n * cout, b, h, wd)
    dw = F.conv2d(xg, gg, padding=k // 2, groups=n)  # [Cin, N·Cout, k, k]
    return dw.reshape(cin, n, cout, k, k).permute(1, 3, 4, 0, 2).contiguous()


class ConvFwdStyle(torch.autograd.Function):
    """Grouped ``F.conv2d`` forward; the reference's ``conv_fwd_style``
    backward (``conv_kernel.py:224-240``), both gradients forward-style
    grouped convolutions: ``dx = conv_SAME(dout, rot180(w) in/out
    swapped)``, ``dW`` by :func:`conv_dw_fwd_style`. XLA-level code in the
    reference, not a Pallas kernel, so it runs through ``F.conv2d``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        _check_kernel(w)
        ctx.save_for_backward(x, w)
        return conv_forward(x, w)

    @staticmethod
    def backward(ctx, gy: torch.Tensor):
        x, w = ctx.saved_tensors
        g = gy.to(x.dtype).contiguous()
        dx = conv_forward(g, w.flip(1, 2).transpose(3, 4)) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = conv_dw_fwd_style(x, g, w.shape[1]).to(w.dtype)
        return dx, dw


def conv_fwd_style(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3×3 / SAME / stride-1 per-node conv whose backward is two
    forward-style convolutions (the reference's ``conv_fwd_style``)."""
    return ConvFwdStyle.apply(x, w)
