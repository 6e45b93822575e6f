"""The zoo CNN, node-batched — counterpart of :class:`tpfl.models.zoo.CNN`.

Parameters are a nested dict in the flax layout with a leading node
axis: ``Conv_i/kernel [N, 3, 3, Cin, Cout]`` (HWIO), ``Conv_i/bias
[N, Cout]``, ``Dense_i/kernel [N, in, out]``, ``Dense_i/bias [N, out]``.
Activations are NHWC and the flatten before ``Dense_0`` is NHWC order,
so params move between the two packages with no transpose.

The module holds no parameters itself (like a flax module): ``forward``
takes them, so N nodes' distinct models run in one call.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpfl_torch import DeviceLike, resolve_device
from tpfl_torch.parallel.conv_kernel import conv_forward, node_conv

Params = dict[str, dict[str, torch.Tensor]]

#: flax's truncated_normal std correction for variance_scaling: the std
#: of a unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


class CNN(nn.Module):
    """Small conv net for 32×32×3 inputs (the CIFAR-10 tier).

    ``conv_impl``: ``"pallas"`` runs the conv backward through the CUDA
    kernels of :mod:`tpfl_torch.parallel.conv_kernel` (the name of the
    reference option whose Pallas kernels they replace); ``"xla"`` is
    plain autograd through the grouped ``F.conv2d`` — a yardstick and a
    test oracle. Compute is ``compute_dtype`` (bf16 by default) with f32
    params and f32 logits, with the casts of ``zoo.py:91-101,134-144``.
    """

    def __init__(
        self,
        channels: Sequence[int] = (32, 64),
        dense: int = 128,
        out_channels: int = 10,
        compute_dtype: torch.dtype = torch.bfloat16,
        conv_impl: str = "pallas",
    ) -> None:
        super().__init__()
        if conv_impl not in ("pallas", "xla"):
            raise ValueError(
                f"conv_impl must be 'pallas' or 'xla', got {conv_impl!r}"
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

    def _conv(self, x: torch.Tensor, p: dict[str, torch.Tensor]) -> torch.Tensor:
        kernel = p["kernel"].to(self.compute_dtype)  # promote_dtype
        if self.conv_impl == "pallas":
            y = node_conv(x, kernel)
        else:
            y = conv_forward(x, kernel)
        return y + p["bias"].to(self.compute_dtype)[:, None, None, None, :]

    @staticmethod
    def _max_pool(x: torch.Tensor) -> torch.Tensor:
        """2×2 / stride 2 / VALID max-pool of [N, B, H, W, C]."""
        n, b, h, w, c = x.shape
        y = F.max_pool2d(x.reshape(n * b, h, w, c).permute(0, 3, 1, 2), 2)
        return y.permute(0, 2, 3, 1).reshape(n, b, h // 2, w // 2, c)

    def _dense(self, x: torch.Tensor, p: dict[str, torch.Tensor]) -> torch.Tensor:
        cd = self.compute_dtype
        return torch.bmm(x, p["kernel"].to(cd)) + p["bias"].to(cd)[:, None, :]

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """``x [N, B, H, W, C]`` (or ``[N, B, H, W]`` grayscale) ->
        f32 logits ``[N, B, out_channels]``."""
        if x.dim() == 4:
            x = x[..., None]
        x = x.to(self.compute_dtype)
        for i in range(len(self.channels)):
            x = self._max_pool(F.relu(self._conv(x, params[f"Conv_{i}"])))
        x = x.reshape(x.shape[0], x.shape[1], -1)
        x = F.relu(self._dense(x, params["Dense_0"]))
        return self._dense(x, params["Dense_1"]).to(torch.float32)


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


def init_params(
    module: CNN,
    input_shape: Sequence[int],
    seed: int = 0,
    device: DeviceLike = None,
) -> Params:
    """One model's f32 params (unstacked): lecun-normal kernels, zero
    biases, drawn from a ``torch.Generator`` seeded with ``seed``. The
    numbers differ from flax's for the same seed; tests hand both
    packages the same params through :mod:`tpfl_torch.interop`."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    params: Params = {}
    for name, shapes in module.param_shapes(input_shape).items():
        params[name] = {
            "kernel": _lecun_normal(shapes["kernel"], gen, dev),
            "bias": torch.zeros(shapes["bias"], dtype=torch.float32, device=dev),
        }
    return params


def create_model(
    module: "CNN | str",
    input_shape: Sequence[int],
    seed: int = 0,
    device: DeviceLike = None,
    **module_kwargs: Any,
) -> tuple[CNN, Params]:
    """``(module, params)`` — ``module`` may be a :class:`CNN` or the zoo
    name ``"cnn"`` (built from ``module_kwargs``)."""
    if isinstance(module, str):
        zoo = {"cnn": CNN}
        if module not in zoo:
            raise KeyError(f"Unknown model {module!r}; have {sorted(zoo)}")
        module = zoo[module](**module_kwargs)
    return module, init_params(module, input_shape, seed, device)


def stack_params(params: Params, n_nodes: int,
                 device: Optional[torch.device] = None) -> Params:
    """One model broadcast onto a leading node axis (contiguous copies)."""
    return {
        layer: {
            k: v.to(device or v.device)[None].expand(n_nodes, *v.shape).clone()
            for k, v in leaves.items()
        }
        for layer, leaves in params.items()
    }
