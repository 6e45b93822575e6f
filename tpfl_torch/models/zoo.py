"""The model zoo, node-batched — counterparts of :class:`tpfl.models.zoo.MLP`,
:class:`~tpfl.models.zoo.CNN`, :class:`~tpfl.models.zoo.ResNet18` and
:class:`~tpfl.models.zoo.TransformerLM`.

Parameters are nested dicts in the flax layout with a leading node
axis: ``Conv_i/kernel [N, 3, 3, Cin, Cout]`` (HWIO), ``Conv_i/bias
[N, Cout]``, ``Dense_i/kernel [N, in, out]``, ``Dense_i/bias [N, out]``;
the transformer's ``TransformerBlock_i/LayerNorm_0/scale [N, dim]`` and
``Embed_0/embedding [N, vocab, dim]`` sit one level deeper or beside
them. Activations are NHWC and the flatten before ``Dense_0`` is NHWC
order, so params move between the two packages with no transpose.
ResNet-18's BatchNorm state is a second tree of the same kind,
``{"batch_stats": {"BatchNorm_0": {"mean", "var"}, "ResidualBlock_0":
{...}, ...}}`` (flax's mutable collection), threaded through training
by :func:`apply`; :func:`init_state` draws both.

A module holds no parameters itself (like a flax module): ``forward``
takes them, so N nodes' distinct models run in one call. Each module
draws its own initial params (``module.init_params``) with flax's
initialisers.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpfl_torch import DeviceLike, resolve_device
from tpfl_torch.parallel.conv_kernel import conv_forward, conv_fwd_style, node_conv
from tpfl_torch.parallel.ring_attention import blockwise_attention
from tpfl_torch.utils.tree import Tree, tree_map

Params = Tree

#: flax's truncated_normal std correction for variance_scaling: the std
#: of a unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


#: ``CNN.conv_impl`` -> the per-node conv it runs.
_CONVS = {"fwd_bwd": conv_fwd_style, "pallas": node_conv, "xla": conv_forward}


class CNN(nn.Module):
    """Small conv net for 32×32×3 inputs (the CIFAR-10 tier).

    ``conv_impl`` picks the conv backward, with the reference's names
    and default: ``"fwd_bwd"`` (default) runs both gradients as
    forward-style grouped ``F.conv2d`` calls (:func:`conv_fwd_style`);
    ``"pallas"`` runs them through the CUDA kernels ``conv_dw`` /
    ``conv_dx`` of :mod:`tpfl_torch.parallel.conv_kernel` (which replace
    the reference's Pallas kernels); ``"xla"`` is plain autograd through
    the grouped ``F.conv2d``. The forward is the same grouped ``F.conv2d``
    in all three, and so are the params. Compute is ``compute_dtype`` (bf16 by default) with f32
    params and f32 logits, with the casts of ``zoo.py:91-101,134-144``.
    """

    def __init__(
        self,
        channels: Sequence[int] = (32, 64),
        dense: int = 128,
        out_channels: int = 10,
        compute_dtype: torch.dtype = torch.bfloat16,
        conv_impl: str = "fwd_bwd",
    ) -> None:
        super().__init__()
        if conv_impl not in _CONVS:
            raise ValueError(
                f"conv_impl must be one of {sorted(_CONVS)}, got {conv_impl!r}"
            )
        self.channels = tuple(int(c) for c in channels)
        self.dense = int(dense)
        self.out_channels = int(out_channels)
        self.compute_dtype = compute_dtype
        self.conv_impl = conv_impl

    def param_shapes(self, input_shape: Sequence[int]) -> dict[str, dict]:
        """Unstacked flax param shapes for inputs of ``input_shape``
        (H, W, C) or (H, W)."""
        h, w = int(input_shape[0]), int(input_shape[1])
        cin = int(input_shape[2]) if len(input_shape) == 3 else 1
        shapes: dict[str, dict] = {}
        for i, ch in enumerate(self.channels):
            shapes[f"Conv_{i}"] = {"kernel": (3, 3, cin, ch), "bias": (ch,)}
            cin, h, w = ch, h // 2, w // 2
        flat = h * w * cin
        shapes["Dense_0"] = {"kernel": (flat, self.dense), "bias": (self.dense,)}
        shapes["Dense_1"] = {
            "kernel": (self.dense, self.out_channels),
            "bias": (self.out_channels,),
        }
        return shapes

    def init_params(self, gen: torch.Generator, input_shape: Sequence[int],
                    device: torch.device) -> Params:
        """lecun-normal kernels, zero biases."""
        return {
            name: {"kernel": _lecun_normal(sh["kernel"], gen, device),
                   "bias": torch.zeros(sh["bias"], dtype=torch.float32, device=device)}
            for name, sh in self.param_shapes(input_shape).items()
        }

    def _conv(self, x: torch.Tensor, p: dict[str, torch.Tensor]) -> torch.Tensor:
        kernel = p["kernel"].to(self.compute_dtype)  # promote_dtype
        y = _CONVS[self.conv_impl](x, kernel)
        return y + p["bias"].to(self.compute_dtype)[:, None, None, None, :]

    @staticmethod
    def _max_pool(x: torch.Tensor) -> torch.Tensor:
        """2×2 / stride 2 / VALID max-pool of [N, B, H, W, C]."""
        n, b, h, w, c = x.shape
        y = F.max_pool2d(x.reshape(n * b, h, w, c).permute(0, 3, 1, 2), 2)
        return y.permute(0, 2, 3, 1).reshape(n, b, h // 2, w // 2, c)

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """``x [N, B, H, W, C]`` (or ``[N, B, H, W]`` grayscale) ->
        f32 logits ``[N, B, out_channels]``."""
        if x.dim() == 4:
            x = x[..., None]
        x = x.to(self.compute_dtype)
        for i in range(len(self.channels)):
            x = self._max_pool(F.relu(self._conv(x, params[f"Conv_{i}"])))
        x = x.reshape(x.shape[0], x.shape[1], -1)
        x = F.relu(_dense(x, params["Dense_0"], self.compute_dtype))
        return _dense(x, params["Dense_1"], self.compute_dtype).to(torch.float32)


class MLP(nn.Module):
    """MLP (``zoo.py:21-36``), node-batched: flattens each sample, then
    Dense → relu per hidden size and a final Dense, in
    ``compute_dtype``; f32 logits ``[N, B, out_channels]``."""

    def __init__(self, hidden_sizes: Sequence[int] = (256, 128), out_channels: int = 10,
                 compute_dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.hidden_sizes = tuple(int(h) for h in hidden_sizes)
        self.out_channels = int(out_channels)
        self.compute_dtype = compute_dtype

    def init_params(self, gen: torch.Generator, input_shape: Sequence[int],
                    device: torch.device) -> Params:
        """lecun-normal kernels, zero biases."""
        params: Params = {}
        fan_in = math.prod(int(d) for d in input_shape)
        for i, out in enumerate(self.hidden_sizes + (self.out_channels,)):
            params[f"Dense_{i}"] = _dense_params(fan_in, out, gen, device)
            fan_in = out
        return params

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """``x [N, B, ...]`` -> f32 logits ``[N, B, out_channels]``."""
        cd = self.compute_dtype
        x = x.reshape(x.shape[0], x.shape[1], -1).to(cd)
        for i in range(len(self.hidden_sizes)):
            x = F.relu(_dense(x, params[f"Dense_{i}"], cd))
        return _dense(x, params[f"Dense_{len(self.hidden_sizes)}"], cd).to(torch.float32)


def _lecun_normal(shape: Sequence[int], gen: torch.Generator,
                  device: torch.device) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal, variance 1/fan_in, with
    fan_in = prod(shape[:-1]) (receptive field × in for HWIO, in for
    [in, out]), cut at ±2 std. Drawn by inverse CDF from ``gen``'s
    uniforms, spelled out here rather than through
    ``torch.nn.init.trunc_normal_``, whose draws changed between torch
    releases: a seed gives the same params under every torch."""
    fan_in = math.prod(shape[:-1])
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    t = torch.empty(tuple(shape), dtype=torch.float32)
    t.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=gen)
    t.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(min=-2.0 * std, max=2.0 * std)
    return t.to(device)


def _embed_normal(shape: Sequence[int], gen: torch.Generator,
                  device: torch.device) -> torch.Tensor:
    """flax ``default_embed_init``: an untruncated normal with variance
    1/fan_in, fan_in = the feature dim (``out_axis=0``)."""
    std = math.sqrt(1.0 / shape[-1])
    return (torch.randn(tuple(shape), generator=gen, dtype=torch.float32) * std).to(device)


def _dense_params(fan_in: int, out: int, gen: torch.Generator, device: torch.device,
                  bias: bool = True) -> dict[str, torch.Tensor]:
    p = {"kernel": _lecun_normal((fan_in, out), gen, device)}
    if bias:
        p["bias"] = torch.zeros((out,), dtype=torch.float32, device=device)
    return p


def _layer_norm_params(dim: int, device: torch.device) -> dict[str, torch.Tensor]:
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device),
            "bias": torch.zeros((dim,), dtype=torch.float32, device=device)}


def _dense(x: torch.Tensor, p: dict[str, torch.Tensor], cd: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=cd)`` per node: input, kernel and bias promoted
    to ``cd`` (the bias add in ``cd``). ``x [N, ..., in]``."""
    n, out = x.shape[0], p["kernel"].shape[-1]
    y = torch.bmm(x.to(cd).reshape(n, -1, x.shape[-1]), p["kernel"].to(cd))
    if "bias" in p:
        y = y + p["bias"].to(cd)[:, None, :]
    return y.reshape(*x.shape[:-1], out)


def _layer_norm(x: torch.Tensor, p: dict[str, torch.Tensor], cd: torch.dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype=cd)`` per node: epsilon 1e-6, statistics in
    f32 with the fast variance E[x²] − E[x]² (clipped at 0), scale and
    bias applied in f32, one cast to ``cd`` at the end."""
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    mul = torch.rsqrt(var + 1e-6) * p["scale"].reshape(shape)
    return ((xf - mean) * mul + p["bias"].reshape(shape)).to(cd)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``nn.gelu`` (``approximate=True``) as ``jax.nn.gelu`` writes it,
    op by op in x's dtype with its constants in that dtype: in bf16 each
    op rounds, as XLA's do, where ``F.gelu`` rounds once."""
    def c(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    inner = c(math.sqrt(2.0 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


class TransformerBlock(nn.Module):
    """Pre-norm attention + MLP block (``zoo.py:242-276``), node-batched:
    ``forward(params, x [N, B, S, dim])``. ``attention_fn(q, k, v,
    causal)`` on ``[N·B, S, H, D]`` (attention has no params, so nodes
    fold into the batch) defaults to :func:`blockwise_attention`; pass
    :func:`tpfl_torch.parallel.flash_kernel.flash_attention` for the CUDA
    kernels."""

    def __init__(self, dim: int, heads: int = 4, mlp_ratio: int = 4, causal: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 attention_fn: Optional[Callable] = None) -> None:
        super().__init__()
        self.dim, self.heads, self.mlp_ratio = int(dim), int(heads), int(mlp_ratio)
        self.causal = causal
        self.compute_dtype = compute_dtype
        self.attention_fn = attention_fn

    def init_params(self, gen: torch.Generator, device: torch.device) -> Params:
        dim, hidden = self.dim, self.mlp_ratio * self.dim
        return {
            "LayerNorm_0": _layer_norm_params(dim, device),
            "Dense_0": _dense_params(dim, 3 * dim, gen, device, bias=False),
            "Dense_1": _dense_params(dim, dim, gen, device),
            "LayerNorm_1": _layer_norm_params(dim, device),
            "Dense_2": _dense_params(dim, hidden, gen, device),
            "Dense_3": _dense_params(hidden, dim, gen, device),
        }

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        attention = self.attention_fn or blockwise_attention
        n, b, s, _ = x.shape
        h, d = self.heads, self.dim // self.heads
        y = _layer_norm(x, params["LayerNorm_0"], cd)
        qkv = _dense(y, params["Dense_0"], cd)
        # Columns ordered (3, h, d): reshape to 3·h heads, split in three.
        q, k, v = qkv.reshape(n * b, s, 3 * h, d).split(h, dim=2)
        attn = attention(q, k, v, causal=self.causal)
        x = x + _dense(attn.reshape(n, b, s, self.dim), params["Dense_1"], cd)
        y = _layer_norm(x, params["LayerNorm_1"], cd)
        y = _gelu_tanh(_dense(y, params["Dense_2"], cd))
        return x + _dense(y, params["Dense_3"], cd)


class TransformerLM(nn.Module):
    """Small causal language model (``zoo.py:279-329``), node-batched:
    ``forward(params, tokens [N, B, S]) -> f32 logits [N, B, S, vocab]``.
    Embeddings are per-node gathers of the table cast to
    ``compute_dtype``; ``x + pos`` is in ``compute_dtype``."""

    #: Token models take integer ids (the engine keeps them integer).
    input_dtype = torch.int32

    def __init__(self, vocab: int = 256, dim: int = 128, heads: int = 4, n_layers: int = 2,
                 max_len: int = 8192, compute_dtype: torch.dtype = torch.bfloat16,
                 attention_fn: Optional[Callable] = None) -> None:
        super().__init__()
        self.vocab, self.dim, self.heads = int(vocab), int(dim), int(heads)
        self.n_layers, self.max_len = int(n_layers), int(max_len)
        self.compute_dtype = compute_dtype
        self.attention_fn = attention_fn
        self.blocks = [TransformerBlock(self.dim, self.heads, compute_dtype=compute_dtype,
                                        attention_fn=attention_fn)
                       for _ in range(self.n_layers)]

    def init_params(self, gen: torch.Generator, input_shape: Sequence[int],
                    device: torch.device) -> Params:
        """``Embed``: untruncated normal, std 1/sqrt(dim); ``Dense``
        kernels lecun-normal, biases zero; ``LayerNorm`` scale one, bias
        zero. ``input_shape`` is ``(S,)``, checked against ``max_len``."""
        self._check_len(int(input_shape[-1]))
        params: Params = {
            "Embed_0": {"embedding": _embed_normal((self.vocab, self.dim), gen, device)},
            "Embed_1": {"embedding": _embed_normal((self.max_len, self.dim), gen, device)},
        }
        for i, block in enumerate(self.blocks):
            params[f"TransformerBlock_{i}"] = block.init_params(gen, device)
        params["LayerNorm_0"] = _layer_norm_params(self.dim, device)
        params["Dense_0"] = _dense_params(self.dim, self.vocab, gen, device)
        return params

    def _check_len(self, s: int) -> None:
        if s > self.max_len:
            raise ValueError(f"Sequence length {s} exceeds max_len={self.max_len}; "
                             "raise max_len (positional table size)")

    def forward(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        n, _, s = tokens.shape
        self._check_len(s)
        cd = self.compute_dtype
        table = params["Embed_0"]["embedding"].to(cd)
        x = table[torch.arange(n, device=tokens.device)[:, None, None], tokens.long()]
        x = x + params["Embed_1"]["embedding"].to(cd)[:, None, :s]
        for i, block in enumerate(self.blocks):
            x = block(params[f"TransformerBlock_{i}"], x)
        x = _layer_norm(x, params["LayerNorm_0"], cd)
        return _dense(x, params["Dense_0"], cd).to(torch.float32)


# --- ResNet-18 ----------------------------------------------------------------
#
# Inside the network N nodes' activations are one grouped image batch
# ``[B, N·C, H, W]`` (channels-last in memory, i.e. each node's NHWC):
# every conv is one grouped ``F.conv2d`` (groups = N) and a BatchNorm's
# per-channel statistics over (B, H, W) are exactly each node's own.


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """flax / XLA ``SAME`` padding of one spatial axis: the total
    ``(ceil(size/stride) − 1)·stride + k − size`` split low = total // 2,
    high = the rest. A 3×3 stride-2 conv on an even size pads (0, 1),
    not PyTorch's (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _group_conv(x: torch.Tensor, kernel: torch.Tensor, stride: int,
                cd: torch.dtype) -> torch.Tensor:
    """``nn.Conv(use_bias=False, padding="SAME", dtype=cd)`` per node:
    ``x [B, N·Cin, H, W]`` · HWIO ``kernel [N, k, k, Cin, Cout]`` ->
    ``[B, N·Cout, H', W']``."""
    n, k, _, cin, cout = kernel.shape
    wg = kernel.to(cd).permute(0, 4, 3, 1, 2).reshape(n * cout, cin, k, k)
    (h_lo, h_hi), (w_lo, w_hi) = (_same_pads(s, k, stride) for s in x.shape[2:])
    if (h_lo, w_lo) == (h_hi, w_hi):
        return F.conv2d(x.to(cd), wg, stride=stride, padding=(h_lo, w_lo), groups=n)
    return F.conv2d(F.pad(x.to(cd), (w_lo, w_hi, h_lo, h_hi)), wg, stride=stride, groups=n)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=cd)``
    (flax 0.12.3, ``_compute_stats`` / ``_normalize``), per node, on the
    grouped layout ``[B, N·C, H, W]``:

    - training: the batch statistics in f32 over each node's (B, H, W),
      never across nodes, with the fast variance ``E[x²] − E[x]²``
      clipped at 0; the running stats become ``0.9·ra + 0.1·batch``
      (biased variance);
    - evaluation: the running stats;
    - ``y = (x − mean) · (rsqrt(var + 1e-5) · scale) + bias`` in f32,
      then cast to ``cd``.

    Not ``F.batch_norm``, whose running variance is unbiased and whose
    momentum weighs the batch."""

    momentum, epsilon = 0.9, 1e-5

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype

    @staticmethod
    def init_params(features: int, device: torch.device) -> Params:
        return {"scale": torch.ones((features,), dtype=torch.float32, device=device),
                "bias": torch.zeros((features,), dtype=torch.float32, device=device)}

    @staticmethod
    def init_stats(features: int, device: torch.device) -> Params:
        return {"mean": torch.zeros((features,), dtype=torch.float32, device=device),
                "var": torch.ones((features,), dtype=torch.float32, device=device)}

    def forward(self, params: Params, stats: Params, x: torch.Tensor,
                train: bool) -> tuple[torch.Tensor, Params]:
        """(normalised x in ``compute_dtype``, new stats [N, C])."""
        n = params["scale"].shape[0]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # f64 stays f64
        if train:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            m = self.momentum
            stats = {"mean": m * stats["mean"] + (1 - m) * mean.detach().reshape(n, -1),
                     "var": m * stats["var"] + (1 - m) * var.detach().reshape(n, -1)}
        else:
            mean, var = stats["mean"].reshape(-1), stats["var"].reshape(-1)
        mul = torch.rsqrt(var + self.epsilon) * params["scale"].reshape(-1)
        y = (xf - mean[:, None, None]) * mul[:, None, None] + params["bias"].reshape(-1)[
            :, None, None]
        return y.to(self.compute_dtype), stats


class ResidualBlock(nn.Module):
    """Two 3×3 convs with BatchNorm (``zoo.py:147-173``); a 1×1 conv +
    BatchNorm shortcut (``Conv_2`` / ``BatchNorm_2``) when the shape
    changes. Grouped layout ``[B, N·C, H, W]`` in and out."""

    def __init__(self, channels: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.channels, self.stride = int(channels), int(stride)
        self.compute_dtype = compute_dtype
        self.norm = BatchNorm(compute_dtype)

    def has_shortcut(self, cin: int) -> bool:
        return cin != self.channels or self.stride != 1

    def _norms(self, cin: int) -> int:
        return 3 if self.has_shortcut(cin) else 2

    def init_params(self, gen: torch.Generator, cin: int, device: torch.device) -> Params:
        """lecun-normal kernels, BatchNorm scale one / bias zero."""
        ch = self.channels
        convs = [(3, cin), (3, ch), (1, cin)][:self._norms(cin)]
        params: Params = {}
        for i, (k, c) in enumerate(convs):
            params[f"Conv_{i}"] = {"kernel": _lecun_normal((k, k, c, ch), gen, device)}
            params[f"BatchNorm_{i}"] = BatchNorm.init_params(ch, device)
        return params

    def init_stats(self, cin: int, device: torch.device) -> Params:
        return {f"BatchNorm_{i}": BatchNorm.init_stats(self.channels, device)
                for i in range(self._norms(cin))}

    def forward(self, params: Params, stats: Params, x: torch.Tensor,
                train: bool) -> tuple[torch.Tensor, Params]:
        cd, new = self.compute_dtype, {}
        y = _group_conv(x, params["Conv_0"]["kernel"], self.stride, cd)
        y, new["BatchNorm_0"] = self.norm(params["BatchNorm_0"], stats["BatchNorm_0"], y, train)
        y = _group_conv(F.relu(y), params["Conv_1"]["kernel"], 1, cd)
        y, new["BatchNorm_1"] = self.norm(params["BatchNorm_1"], stats["BatchNorm_1"], y, train)
        residual = x
        if "Conv_2" in params:
            residual = _group_conv(x, params["Conv_2"]["kernel"], self.stride, cd)
            residual, new["BatchNorm_2"] = self.norm(params["BatchNorm_2"],
                                                     stats["BatchNorm_2"], residual, train)
        return F.relu(residual + y), new


class ResNet18(nn.Module):
    """ResNet-18, CIFAR variant (``zoo.py:176-208``): a 3×3 stem (64
    channels) with BatchNorm, no max-pool, ``stage_sizes`` residual
    blocks per stage at 64·2^i channels (the first block of each later
    stage strides 2), a global mean pool and a Dense head.

    ``forward(params, x [N, B, H, W, C], aux, train=False) -> (f32
    logits [N, B, out_channels], new aux)``: ``aux`` is
    ``{"batch_stats": ...}`` from :func:`init_state`; with
    ``train=True`` the BatchNorms use the batch's statistics and the new
    running stats come back, else the running stats are used and ``aux``
    comes back as it was."""

    def __init__(self, out_channels: int = 100, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 compute_dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.out_channels = int(out_channels)
        self.stage_sizes = tuple(int(s) for s in stage_sizes)
        self.compute_dtype = compute_dtype
        self.norm = BatchNorm(compute_dtype)
        self.blocks = [
            ResidualBlock(64 * 2 ** i, 2 if i > 0 and b == 0 else 1, compute_dtype)
            for i, n_blocks in enumerate(self.stage_sizes) for b in range(n_blocks)]

    def _block_inputs(self) -> list[int]:
        """Each block's input channels."""
        return [64] + [block.channels for block in self.blocks[:-1]]

    def init_params(self, gen: torch.Generator, input_shape: Sequence[int],
                    device: torch.device) -> Params:
        """lecun-normal kernels, BatchNorm scale one / bias zero, zero
        Dense bias."""
        cin = int(input_shape[2]) if len(input_shape) == 3 else 1
        params: Params = {"Conv_0": {"kernel": _lecun_normal((3, 3, cin, 64), gen, device)},
                          "BatchNorm_0": BatchNorm.init_params(64, device)}
        for i, (block, c) in enumerate(zip(self.blocks, self._block_inputs())):
            params[f"ResidualBlock_{i}"] = block.init_params(gen, c, device)
        params["Dense_0"] = _dense_params(self.blocks[-1].channels, self.out_channels, gen,
                                          device)
        return params

    def init_aux(self, input_shape: Sequence[int], device: torch.device) -> Params:
        """``{"batch_stats": ...}``: means zero, variances one."""
        stats: Params = {"BatchNorm_0": BatchNorm.init_stats(64, device)}
        for i, (block, c) in enumerate(zip(self.blocks, self._block_inputs())):
            stats[f"ResidualBlock_{i}"] = block.init_stats(c, device)
        return {"batch_stats": stats}

    def forward(self, params: Params, x: torch.Tensor, aux: Params,
                train: bool = False) -> tuple[torch.Tensor, Params]:
        cd = self.compute_dtype
        if x.dim() == 4:
            x = x[..., None]
        n, b, h, w, c = x.shape
        stats = aux["batch_stats"]
        new: Params = {}
        # [N, B, H, W, C] -> the grouped [B, N·C, H, W], channels-last.
        x = x.to(cd).permute(1, 2, 3, 0, 4).reshape(b, h, w, n * c).permute(0, 3, 1, 2)
        x = _group_conv(x, params["Conv_0"]["kernel"], 1, cd)
        x, new["BatchNorm_0"] = self.norm(params["BatchNorm_0"], stats["BatchNorm_0"], x, train)
        x = F.relu(x)
        for i, block in enumerate(self.blocks):
            name = f"ResidualBlock_{i}"
            x, new[name] = block(params[name], stats[name], x, train)
        x = x.to(torch.promote_types(cd, torch.float32)).mean(dim=(2, 3)).to(cd)  # [B, N·C]
        x = x.reshape(b, n, -1).transpose(0, 1)
        logits = _dense(x, params["Dense_0"], cd).to(torch.float32)
        return logits, ({"batch_stats": new} if train else aux)


Module = Union[MLP, CNN, ResNet18, TransformerLM]


def apply(module: Module, params: Params, aux: Params, x: torch.Tensor,
          train: bool = False) -> tuple[torch.Tensor, Params]:
    """``module.apply({"params": params, **aux}, x, train=train,
    mutable=list(aux))`` of flax: (logits, new aux). A module without
    mutable collections takes ``aux == {}`` and gives it back."""
    if aux:
        return module(params, x, aux, train=train)
    return module(params, x), aux


def init_state(
    module: Module,
    input_shape: Sequence[int],
    seed: int = 0,
    device: DeviceLike = None,
) -> tuple[Params, Params]:
    """One model's ``(params, aux)`` (unstacked; reference
    ``engine.py:780-805``): ``aux`` is ``{}`` for MLP, CNN and
    TransformerLM, and ``{"batch_stats": {...}}`` for ResNet-18. Params
    are drawn by the module's own ``init_params`` from a
    ``torch.Generator`` seeded with ``seed``; the numbers differ from
    flax's for the same seed, so tests hand both packages the same
    params through :mod:`tpfl_torch.interop`."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    params = module.init_params(gen, input_shape, dev)
    init_aux = getattr(module, "init_aux", None)
    return params, ({} if init_aux is None else init_aux(input_shape, dev))


def init_params(
    module: Module,
    input_shape: Sequence[int],
    seed: int = 0,
    device: DeviceLike = None,
) -> Params:
    """One model's f32 params (unstacked) for a module without mutable
    collections; ResNet-18 raises (use :func:`init_state`)."""
    params, aux = init_state(module, input_shape, seed, device)
    if aux:
        raise ValueError(
            f"Module has mutable collections {sorted(aux)} — use "
            f"init_state() and pass aux to round()/evaluate()."
        )
    return params


def create_model(
    module: "Module | str",
    input_shape: Sequence[int],
    seed: int = 0,
    device: DeviceLike = None,
    **module_kwargs: Any,
) -> tuple:
    """``(module, params)``, or ``(module, params, aux)`` for a module
    with mutable collections (ResNet-18's ``batch_stats``) — ``module``
    may be a module or a zoo name (``"mlp"``, ``"cnn"``, ``"resnet18"``,
    ``"transformer_lm"``), built from ``module_kwargs``."""
    if isinstance(module, str):
        zoo = {"mlp": MLP, "cnn": CNN, "resnet18": ResNet18, "transformer_lm": TransformerLM}
        if module not in zoo:
            raise KeyError(f"Unknown model {module!r}; have {sorted(zoo)}")
        module = zoo[module](**module_kwargs)
    params, aux = init_state(module, input_shape, seed, device)
    return (module, params, aux) if aux else (module, params)


def stack_params(params: Params, n_nodes: int,
                 device: Optional[torch.device] = None) -> Params:
    """One model broadcast onto a leading node axis (contiguous copies)."""
    return tree_map(
        lambda v: v.to(device or v.device)[None].expand(n_nodes, *v.shape).clone(), params)
