"""Params between the JAX package and the port, through numpy.

Both packages keep the flax layout (HWIO conv kernels, ``[in, out]``
dense kernels, NHWC flatten order), so no leaf is transposed: a flax
param tree of numpy arrays, of any depth, becomes a nested dict of
tensors with the same paths, and back.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from tpfl_torch import DeviceLike, resolve_device
from tpfl_torch.models.zoo import Params, stack_params
from tpfl_torch.utils.tree import tree_map


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: numpy has no bf16 of its own
        return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_flax(tree: Mapping[str, Any], device: DeviceLike = None,
                     n_nodes: Optional[int] = None) -> Params:
    """``{"Conv_0": {"kernel": ..., "bias": ...}, ...}`` (nested to any
    depth) of numpy arrays -> the same dict of tensors on ``device``. With ``n_nodes``, one
    model is broadcast onto a leading node axis; without it the leaves
    keep their shape (already node-stacked or a single model)."""
    dev = resolve_device(device)
    out = tree_map(lambda a: _tensor(a, dev), tree)
    return out if n_nodes is None else stack_params(out, int(n_nodes))


def params_to_numpy(params: Params) -> dict[str, Any]:
    """Nested dict of tensors -> nested dict of numpy arrays (bf16
    leaves widen to f32)."""
    return tree_map(
        lambda v: (v.float() if v.dtype == torch.bfloat16 else v).detach().cpu().numpy(),
        params,
    )
