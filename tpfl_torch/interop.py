"""Params between the JAX package and the port, through numpy.

Both packages keep the flax layout (HWIO conv kernels, ``[in, out]``
dense kernels, NHWC flatten order), so no leaf is transposed: a flax
param tree of numpy arrays, of any depth, becomes a nested dict of
tensors with the same paths, and back. :func:`model_state_from_jax`
carries a whole protocol-layer model's state across (read from the
object's attributes: the port imports nothing of the JAX package).
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


def _numpy_tree(tree: Any) -> Any:
    """Arrays of any kind (jax, numpy) -> owning numpy copies; dicts,
    lists and tuples kept; scalars and strings unchanged."""
    if isinstance(tree, Mapping):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    if hasattr(tree, "__array__") and not isinstance(tree, (bool, int, float, str)):
        return np.array(tree)
    return tree


def model_state_from_jax(model: Any, device: DeviceLike = None) -> dict[str, Any]:
    """The state of a JAX-package ``TpflModel`` as keyword arguments of
    the port's ``TpflModel``: ``params`` and ``aux_state`` as tensors on
    ``device`` (bf16 leaves kept bf16), ``num_samples``,
    ``contributors``, and ``additional_info`` as numpy arrays (as a wire
    decode gives them)."""
    dev = resolve_device(device)
    aux = getattr(model, "aux_state", None)
    return {
        "params": params_from_flax(_numpy_tree(model.get_parameters()), device=dev),
        "aux_state": params_from_flax(_numpy_tree(aux), device=dev) if aux else None,
        "num_samples": int(model.get_num_samples()),
        "contributors": list(getattr(model, "_contributors", [])),
        "additional_info": _numpy_tree(dict(model.additional_info)),
        "device": dev,
    }
