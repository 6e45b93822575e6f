"""The model zoo, node-batched — counterparts of :class:`tpfl.models.zoo.CNN`
and :class:`tpfl.models.zoo.TransformerLM`.

Parameters are nested dicts in the flax layout with a leading node
axis: ``Conv_i/kernel [N, 3, 3, Cin, Cout]`` (HWIO), ``Conv_i/bias
[N, Cout]``, ``Dense_i/kernel [N, in, out]``, ``Dense_i/bias [N, out]``;
the transformer's ``TransformerBlock_i/LayerNorm_0/scale [N, dim]`` and
``Embed_0/embedding [N, vocab, dim]`` sit one level deeper or beside
them. Activations are NHWC and the flatten before ``Dense_0`` is NHWC
order, so params move between the two packages with no transpose.

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


def _lecun_normal(shape: Sequence[int], gen: torch.Generator,
                  device: torch.device) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal, variance 1/fan_in, with
    fan_in = prod(shape[:-1]) (receptive field × in for HWIO, in for
    [in, out])."""
    fan_in = math.prod(shape[:-1])
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    t = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
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


Module = Union[CNN, TransformerLM]


def init_params(
    module: Module,
    input_shape: Sequence[int],
    seed: int = 0,
    device: DeviceLike = None,
) -> Params:
    """One model's f32 params (unstacked), drawn by the module's own
    ``init_params`` from a ``torch.Generator`` seeded with ``seed``. The
    numbers differ from flax's for the same seed; tests hand both
    packages the same params through :mod:`tpfl_torch.interop`."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    return module.init_params(gen, input_shape, dev)


def create_model(
    module: "Module | str",
    input_shape: Sequence[int],
    seed: int = 0,
    device: DeviceLike = None,
    **module_kwargs: Any,
) -> tuple[Module, Params]:
    """``(module, params)`` — ``module`` may be a module or a zoo name
    (``"cnn"``, ``"transformer_lm"``), built from ``module_kwargs``."""
    if isinstance(module, str):
        zoo = {"cnn": CNN, "transformer_lm": TransformerLM}
        if module not in zoo:
            raise KeyError(f"Unknown model {module!r}; have {sorted(zoo)}")
        module = zoo[module](**module_kwargs)
    return module, init_params(module, input_shape, seed, device)


def stack_params(params: Params, n_nodes: int,
                 device: Optional[torch.device] = None) -> Params:
    """One model broadcast onto a leading node axis (contiguous copies)."""
    return tree_map(
        lambda v: v.to(device or v.device)[None].expand(n_nodes, *v.shape).clone(), params)
