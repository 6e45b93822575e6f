"""Weight interop: the JAX package's params, torch ``state_dict``s and
Keras weight lists onto the port's params, and back.

Both packages keep the flax layout (HWIO conv kernels, ``[in, out]``
dense kernels, NHWC flatten order), so between them no leaf is
transposed: a flax param tree of numpy arrays, of any depth, becomes a
nested dict of tensors with the same paths, and back
(:func:`params_from_flax`, :func:`params_to_numpy`).
:func:`model_state_from_jax` carries a whole protocol-layer model's
state across (read from the object's attributes: the port imports
nothing of the JAX package).

The converters of :mod:`tpfl.interop` work on the port's params (nested
dicts of tensors in the flax layout) with the reference's rules:

- ``Linear.weight`` [out, in]   <-> ``Dense.kernel`` [in, out] (transpose)
- ``Conv2d.weight`` [O, I, H, W] <-> ``Conv.kernel`` [H, W, I, O]
- ``weight``/``bias`` of norm layers <-> ``scale``/``bias`` (1-D, as-is)
- ``running_mean``/``running_var``  <-> ``batch_stats`` ``mean``/``var``
- ``num_batches_tracked`` is dropped (flax keeps no step counter)

Alignment is by MODULE ORDER, not by name: both sides are grouped into
per-module leaf dicts (torch by key prefix in insertion order, the
params by dict iteration order — ``Dense_10`` after ``Dense_9``), then
zipped; any module-count, name or shape mismatch raises. A ``Linear``
that consumes a flattened conv feature map is not mechanically
convertible (torch flattens C,H,W, flax H,W,C). Keras shares the flax
layouts, so :func:`from_keras_weights` / :func:`to_keras_weights` only
align ``model.get_weights()``'s flat list with the tree: Dense/Conv
consume ``[kernel, bias]``, BatchNorm ``[gamma, beta, moving_mean,
moving_var]`` (stats into ``batch_stats``), Embedding ``[embeddings]``.
Imports place every leaf on the ``device`` argument (``None`` is the
card), in the target leaf's dtype; exports keep the params' device
(``to_torch_state_dict``: tensors) or give numpy arrays
(``to_keras_weights``, bf16 widened to f32).
"""

from __future__ import annotations

import re
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


# --- torch state_dict and Keras weights <-> the port's params ------------

_TORCH_SKIP = ("num_batches_tracked",)
_RUNNING = ("running_mean", "running_var")


def _as_tensor(a: Any) -> torch.Tensor:
    """A torch tensor, numpy array or anything array-like -> a CPU tensor
    (no copy of a CPU tensor)."""
    if isinstance(a, torch.Tensor):
        return a.detach()
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _apply_updates_ordered(tree: Any, ups: dict, dev: torch.device, path: tuple = ()) -> Any:
    """Rebuild ``tree`` with ``ups[path]`` replacing matched leaves, on
    ``dev``, keeping dict insertion order (the module order this module
    aligns by)."""
    if isinstance(tree, Mapping):
        return {k: _apply_updates_ordered(v, ups, dev, path + (str(k),))
                for k, v in tree.items()}
    return ups.get(path, tree).to(dev)


def _natural_sorted(keys: list) -> list:
    def key_of(k):
        return [int(tok) if tok.isdigit() else tok
                for tok in re.split(r"(\d+)", str(k)) if tok != ""]

    return sorted(keys, key=key_of)


def _flax_groups(params: Any) -> list[tuple[tuple, dict[str, Any]]]:
    """[(module_path, {leaf_name: tensor})] depth-first in dict iteration
    order (the module definition order of params from ``init_params``);
    a dict whose keys look sorted has its numeric suffixes re-sorted
    naturally, so ``Dense_10`` follows ``Dense_9``."""
    groups: list[tuple[tuple, dict[str, Any]]] = []

    def walk(node: Mapping, path: tuple) -> None:
        keys = list(node.keys())
        if keys == sorted(map(str, keys)):
            keys = _natural_sorted(keys)
        leaf_items = {k: node[k] for k in keys if not isinstance(node[k], Mapping)}
        if leaf_items:
            groups.append((path, leaf_items))
        for k in keys:
            if isinstance(node[k], Mapping):
                walk(node[k], path + (str(k),))

    walk(params, ())
    return groups


def _torch_groups(state_dict: Mapping[str, Any]) -> list[tuple[str, dict[str, torch.Tensor]]]:
    """[(module_prefix, {leaf_name: tensor})] in insertion order, skipping
    bookkeeping entries."""
    groups: dict[str, dict[str, torch.Tensor]] = {}
    for key, val in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf in _TORCH_SKIP:
            continue
        groups.setdefault(prefix, {})[leaf] = _as_tensor(val)
    return list(groups.items())


def _import_leaf(torch_name: str, arr: torch.Tensor, flax_name: str,
                 target: torch.Tensor) -> torch.Tensor:
    want = tuple(target.shape)
    if torch_name == "weight" and flax_name == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:  # OIHW -> HWIO
            arr = arr.permute(2, 3, 1, 0)
        elif arr.ndim == 3:  # Conv1d OIW -> WIO
            arr = arr.permute(2, 1, 0)
    if tuple(arr.shape) != want:
        raise ValueError(f"torch '{torch_name}' {tuple(arr.shape)} does not map onto flax "
                         f"'{flax_name}' {want}")
    return arr.to(target.dtype).contiguous()


def _export_leaf(arr: torch.Tensor) -> torch.Tensor:
    """A flax-layout kernel -> its torch layout."""
    if arr.ndim == 2:
        return arr.T.contiguous()
    if arr.ndim == 4:  # HWIO -> OIHW
        return arr.permute(3, 2, 0, 1).contiguous()
    if arr.ndim == 3:  # WIO -> OIW
        return arr.permute(2, 1, 0).contiguous()
    return arr


def _match_names(torch_leaves: dict, flax_leaves: dict) -> list[tuple[str, str]]:
    """Pair torch leaf names with flax leaf names within one module."""
    pairs = []
    for tname in torch_leaves:
        if tname == "weight":
            fname = "kernel" if "kernel" in flax_leaves else "scale"
        elif tname == "running_mean":
            fname = "mean"
        elif tname == "running_var":
            fname = "var"
        else:
            fname = tname
        if fname not in flax_leaves:
            raise ValueError(f"torch leaf '{tname}' has no flax counterpart among "
                             f"{sorted(flax_leaves)}")
        pairs.append((tname, fname))
    return pairs


def from_torch_state_dict(params: Params, state_dict: Mapping[str, Any],
                          aux: Optional[Params] = None, device: DeviceLike = None) -> Any:
    """Fill the port's params from a torch ``state_dict``.

    ``params`` provides the target structure, shapes and dtypes; values
    are replaced by the converted torch tensors, placed on ``device``.
    With ``aux`` (a ``{"batch_stats": ...}`` collection), BatchNorm
    running stats are imported too and ``(params, aux)`` is returned;
    otherwise just the new params. Raises on any module-count, name or
    shape mismatch — silent misalignment would corrupt every layer after
    it."""
    dev = resolve_device(device)
    stats_target = aux["batch_stats"] if aux is not None else None
    fgroups = _flax_groups(params)
    sgroups = _flax_groups(stats_target) if stats_target is not None else []
    t_param_groups: list[tuple[str, dict]] = []
    t_stat_groups: list[tuple[str, dict]] = []
    for prefix, leaves in _torch_groups(state_dict):
        pleaves = {k: v for k, v in leaves.items() if k not in _RUNNING}
        sleaves = {k: v for k, v in leaves.items() if k in _RUNNING}
        if pleaves:
            t_param_groups.append((prefix, pleaves))
        if sleaves:
            t_stat_groups.append((prefix, sleaves))
    if len(t_param_groups) != len(fgroups):
        raise ValueError(f"module count mismatch: torch has {len(t_param_groups)} "
                         f"parameterized modules, flax params has {len(fgroups)}")
    if stats_target is not None and len(t_stat_groups) != len(sgroups):
        raise ValueError(f"BatchNorm count mismatch: torch has {len(t_stat_groups)} "
                         f"modules with running stats, batch_stats has {len(sgroups)}")

    def fill(target_tree, fg, tg):
        updates: dict[tuple, torch.Tensor] = {}
        for (fpath, fleaves), (_tprefix, tleaves) in zip(fg, tg):
            for tname, fname in _match_names(tleaves, fleaves):
                updates[fpath + (fname,)] = _import_leaf(tname, tleaves[tname], fname,
                                                         fleaves[fname])
        return _apply_updates_ordered(target_tree, updates, dev)

    new_params = fill(params, fgroups, t_param_groups)
    if stats_target is None:
        return new_params
    new_aux = dict(aux)
    new_aux["batch_stats"] = fill(stats_target, sgroups, t_stat_groups)
    return new_params, new_aux


def to_torch_state_dict(params: Params, template: Mapping[str, Any],
                        aux: Optional[Params] = None) -> dict[str, torch.Tensor]:
    """Export the port's params into a torch-shaped ``state_dict``
    (tensors on the params' device, ready for ``module.load_state_dict``).

    ``template`` (an existing state_dict, or any mapping with the same
    keys) fixes the key names and order. The inverse of
    :func:`from_torch_state_dict`; a template with more or fewer modules
    than the params raises."""
    fgroups = _flax_groups(params)
    stats_target = aux["batch_stats"] if aux is not None else None
    sgroups = _flax_groups(stats_target) if stats_target is not None else []
    out: dict[str, torch.Tensor] = {}
    fi = si = 0
    for prefix, tleaves in _torch_groups(template):
        pnames = [n for n in tleaves if n not in _RUNNING]
        snames = [n for n in tleaves if n in _RUNNING]
        if pnames:
            if fi >= len(fgroups):
                raise ValueError("template has more modules than params")
            _, fleaves = fgroups[fi]
            fi += 1
            for tname, fname in _match_names({n: tleaves[n] for n in pnames}, fleaves):
                arr = fleaves[fname].detach()
                if tname == "weight" and fname == "kernel":
                    arr = _export_leaf(arr)
                out[f"{prefix}.{tname}" if prefix else tname] = arr
        if snames:
            if stats_target is None:
                raise ValueError(f"template expects running stats under '{prefix}' but "
                                 f"no aux/batch_stats was given")
            if si >= len(sgroups):
                raise ValueError("template has more stat modules than aux")
            _, sleaves = sgroups[si]
            si += 1
            for tname, fname in _match_names({n: tleaves[n] for n in snames}, sleaves):
                out[f"{prefix}.{tname}" if prefix else tname] = sleaves[fname].detach()
    # Underrun is as corrupting as overrun: a template with FEWER modules
    # than the params would silently drop trailing layers.
    if fi != len(fgroups):
        raise ValueError(f"template consumed {fi} of {len(fgroups)} flax modules — "
                         f"trailing params would be silently dropped")
    if stats_target is not None and si != len(sgroups):
        raise ValueError(f"template consumed {si} of {len(sgroups)} stat modules")
    return out


def _keras_group_spec(fleaves: dict) -> list[str]:
    """Flax leaf names of one module in Keras's get_weights() order."""
    if "scale" in fleaves:  # BatchNorm/LayerNorm: gamma, beta
        return ["scale"] + (["bias"] if "bias" in fleaves else [])
    if "kernel" in fleaves:
        return ["kernel"] + (["bias"] if "bias" in fleaves else [])
    if "embedding" in fleaves:
        return ["embedding"]
    raise ValueError(f"module with leaves {sorted(fleaves)} has no Keras counterpart")


def _numpy(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).detach().cpu().numpy()


def to_keras_weights(params: Params, aux: Optional[Params] = None) -> list[np.ndarray]:
    """Export the port's params (+ optional ``{"batch_stats": ...}`` aux)
    as a ``keras.Model.set_weights``-ready flat list of numpy arrays, in
    module order, BatchNorm emitting gamma, beta, moving_mean, moving_var
    together. Stats pair with their norm layer by module path."""
    stats = aux["batch_stats"] if aux is not None else None
    sgroups = _flax_groups(stats) if stats is not None else []
    stats_by_path = dict(sgroups)
    consumed: set = set()
    out: list[np.ndarray] = []
    for fpath, fleaves in _flax_groups(params):
        out.extend(_numpy(fleaves[name]) for name in _keras_group_spec(fleaves))
        if "scale" in fleaves and stats is not None and fpath in stats_by_path:
            consumed.add(fpath)
            sleaves = stats_by_path[fpath]
            out.extend(_numpy(sleaves[name]) for name in ("mean", "var") if name in sleaves)
    if stats is not None and len(consumed) != len(sgroups):
        missing = sorted(set(stats_by_path) - consumed)
        raise ValueError(f"batch_stats modules with no matching norm layer in params: "
                         f"{missing}")
    return out


def from_keras_weights(params: Params, weights: list, aux: Optional[Params] = None,
                       device: DeviceLike = None) -> Any:
    """Fill the port's params from ``keras.Model.get_weights()``, placed
    on ``device``. With ``aux``, BatchNorm moving stats are consumed into
    ``batch_stats`` and ``(params, aux)`` is returned. Raises on count or
    shape mismatch."""
    dev = resolve_device(device)
    stats = aux["batch_stats"] if aux is not None else None
    sgroups = _flax_groups(stats) if stats is not None else []
    stats_by_path = dict(sgroups)
    consumed: set = set()
    arrays = [_as_tensor(w) for w in weights]
    wi = 0
    updates: dict[tuple, torch.Tensor] = {}
    stat_updates: dict[tuple, torch.Tensor] = {}

    def take(target, fpath, fname, store):
        nonlocal wi
        if wi >= len(arrays):
            raise ValueError(f"keras weights exhausted at flax leaf {fpath + (fname,)}")
        arr = arrays[wi]
        wi += 1
        want = tuple(target.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"keras weight #{wi - 1} {tuple(arr.shape)} does not map onto "
                             f"flax '{'/'.join(fpath + (fname,))}' {want}")
        store[fpath + (fname,)] = arr.to(target.dtype)

    for fpath, fleaves in _flax_groups(params):
        for name in _keras_group_spec(fleaves):
            take(fleaves[name], fpath, name, updates)
        if "scale" in fleaves and stats is not None and fpath in stats_by_path:
            consumed.add(fpath)
            sleaves = stats_by_path[fpath]
            for name in ("mean", "var"):
                if name in sleaves:
                    take(sleaves[name], fpath, name, stat_updates)
    if wi != len(arrays):
        raise ValueError(f"consumed {wi} of {len(arrays)} keras weights — trailing "
                         f"keras layers have no flax counterpart")
    if stats is not None and len(consumed) != len(sgroups):
        missing = sorted(set(stats_by_path) - consumed)
        raise ValueError(f"batch_stats modules with no matching norm layer in params: "
                         f"{missing}")
    new_params = _apply_updates_ordered(params, updates, dev)
    if stats is None:
        return new_params
    new_aux = dict(aux)
    new_aux["batch_stats"] = _apply_updates_ordered(stats, stat_updates, dev)
    return new_params, new_aux
