"""Framework-neutral model container — the port of :class:`tpfl.learning.model.TpflModel`.

A :class:`TpflModel` holds a **nested dict of tensors on its device**
plus the federated-learning metadata the protocol needs
(``contributors``, ``num_samples``, ``additional_info``), the non-trained
``aux_state`` (BatchNorm's ``batch_stats``), and the node's delta-base
resolver and serialization buffer pool.

Parameters set through :meth:`TpflModel.set_parameters` (and every wire
intake) take JAX's pytree order — dicts with sorted keys — as the
reference's ``tree_map`` gives them, so the same model encodes to the
same bytes in both packages; flat leaf lists follow that order too.
Wire leaves (numpy arrays from a decode) reach the device in one upload.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from tpfl_torch import DeviceLike, resolve_device
from tpfl_torch.exceptions import ModelNotMatchingError
from tpfl_torch.learning import serialization
from tpfl_torch.utils.tree import (
    canonical_leaves,
    canonical_map,
    canonical_unflatten,
    tree_map,
)

Pytree = Any

_ALIGN = 64


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dt)).dtype


def to_device(leaves: list[Any], device: torch.device) -> list[torch.Tensor]:
    """Leaves (tensors, numpy arrays, numpy or Python scalars) as tensors
    on ``device``, dtypes kept. Tensors move one by one (a no-op when
    already there); every host array goes up in ONE transfer, packed at
    64-byte offsets into one buffer whose slices become the leaves."""
    out: list[Any] = [None] * len(leaves)
    host: list[tuple[int, np.ndarray, int]] = []
    size = 0
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor):
            out[i] = x.to(device)
            continue
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":  # ml_dtypes leaves from the JAX package
            out[i] = torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
            continue
        host.append((i, a, size))
        size += (a.nbytes + _ALIGN - 1) // _ALIGN * _ALIGN
    if host:
        buf = np.zeros(size, np.uint8)
        for _, a, off in host:
            buf[off:off + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        dev = torch.from_numpy(buf).to(device)
        for i, a, off in host:
            out[i] = dev[off:off + a.nbytes].view(_torch_dtype(a.dtype)).reshape(a.shape)
    return out


def place(tree: Pytree, device: torch.device) -> Pytree:
    """A tree's leaves as tensors on ``device`` (structure and key order
    kept; one upload for the host leaves)."""
    leaves: list = []
    tree_map(leaves.append, tree)
    it = iter(to_device(leaves, device))
    return tree_map(lambda _v: next(it), tree)


def _shape(x: Any) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else tuple(np.shape(x))


class TpflModel:
    """A tree of weights on a device + FL metadata.

    Args:
        module: optional model definition (a zoo module); carried so
            learners can apply the weights. Not serialized.
        params: nested dict of tensors or arrays (the flax layout);
            placed on ``device`` in the given key order.
        num_samples: samples used to train these weights (FedAvg weight).
        contributors: node addresses whose training produced the weights.
        additional_info: arbitrary tree payload for aggregator/callback
            state transport (e.g. SCAFFOLD control variates).
        aux_state: optional non-trained state (e.g. batch-norm stats),
            placed on ``device``.
        device: ``None`` means the card; pass ``"cpu"`` for the CPU.
    """

    def __init__(
        self,
        module: Any = None,
        params: Optional[Pytree] = None,
        num_samples: int = 1,
        contributors: Optional[list[str]] = None,
        additional_info: Optional[dict[str, Any]] = None,
        aux_state: Optional[Pytree] = None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.module = module
        self._params: Pytree = place(params, self.device) if params else {}
        self._num_samples = int(num_samples)
        self._contributors: list[str] = list(contributors or [])
        self.additional_info: dict[str, Any] = dict(additional_info or {})
        self.aux_state = place(aux_state, self.device) if aux_state else aux_state
        # Delta-gossip base resolver (compression.BaseCache), inherited
        # through build_copy: lets residual payloads decode against the
        # round bases this node has adopted. None = deltas are refused.
        self.base_store: Any = None
        # Per-node serialization buffer pool (bufferpool.BufferPool),
        # inherited through build_copy. None = the process default pool.
        self.buffer_pool: Any = None

    # --- parameters ---

    def get_parameters(self) -> Pytree:
        """The parameter tree (tensors on the model's device)."""
        return self._params

    def get_parameters_list(self) -> list[Any]:
        """Flat leaves in JAX's pytree order as host copies (numpy; a CPU
        tensor for bf16), one transfer for all of them."""
        return canonical_leaves(serialization.to_host(self._params))

    def set_parameters(self, params: Union["TpflModel", Pytree, list, bytes]) -> None:
        """Accepts a TpflModel, a tree, a flat leaf list (JAX's pytree
        order), or encoded bytes / an in-process reference."""
        if isinstance(params, TpflModel):
            self._check_and_set(params.get_parameters())
            return
        if isinstance(params, (bytes, serialization.InprocModelRef)):
            decoded, contribs, n, info = serialization.decode_model_payload(
                params, bases=self.base_store
            )
            self._check_and_set(decoded, restore_dtype=True)
            self._contributors = contribs
            self._num_samples = n
            self.additional_info.update(info)
            return
        if isinstance(params, list) and self._params:
            n_leaves = len(canonical_leaves(self._params))
            if n_leaves != len(params):
                raise ModelNotMatchingError(f"Expected {n_leaves} leaves, got {len(params)}")
            self._check_and_set(canonical_unflatten(self._params, list(params)))
            return
        self._check_and_set(params)

    def _check_and_set(self, new_params: Pytree, restore_dtype: bool = False) -> None:
        new_leaves = canonical_leaves(new_params)
        if self._params:
            old_leaves = canonical_leaves(self._params)
            if len(old_leaves) != len(new_leaves):
                raise ModelNotMatchingError(
                    f"Leaf count mismatch: {len(old_leaves)} vs {len(new_leaves)}"
                )
            for o, n in zip(old_leaves, new_leaves):
                if _shape(o) != _shape(n):
                    raise ModelNotMatchingError(f"Shape mismatch: {_shape(o)} vs {_shape(n)}")
            if restore_dtype:
                # Wire payloads may arrive downcast (Settings.WIRE_DTYPE);
                # ONLY wire decodes take this path — a caller setting
                # different-dtype params keeps its dtypes.
                placed = to_device(new_leaves, self.device)
                self._params = canonical_unflatten(
                    self._params, [n.to(o.dtype) for o, n in zip(old_leaves, placed)]
                )
                return
        self._params = canonical_unflatten(new_params, to_device(new_leaves, self.device))

    # --- serialization (msgpack, not pickle) ---

    def encode_parameters(
        self,
        params: Optional[Pytree] = None,
        codec: "str | int | None" = None,
        delta_base: Optional[tuple] = None,
        trace_id: Optional[str] = None,
    ) -> bytes:
        """Wire-encode the parameters through the codec registry.

        ``codec``: codec spec (:mod:`tpfl_torch.learning.compression`);
        None = ``Settings.WIRE_CODEC``. ``delta_base``: ``(round,
        fingerprint, base_params)`` — encode a residual against an
        acknowledged base (a v2 envelope). Dense payloads are v3 under
        ``Settings.WIRE_FORMAT >= 3``, else v1, with float leaves
        downcast to ``Settings.WIRE_DTYPE`` when it is set. ``trace_id``:
        hop-tracing id embedded in whichever envelope is emitted.
        ``Settings.WIRE_DELTA`` alone changes nothing here: the stages
        pick the base and pass ``delta_base``."""
        from tpfl_torch.learning import compression
        from tpfl_torch.settings import Settings

        params = params if params is not None else self._params
        spec = Settings.WIRE_CODEC if codec is None else codec
        if delta_base is not None or not compression.is_dense(spec):
            return compression.encode_model_payload(
                params,
                self._contributors,
                self._num_samples,
                self.additional_info,
                spec,
                delta_base=delta_base,
                topk_frac=Settings.WIRE_TOPK_FRAC,
                level=Settings.WIRE_ENTROPY_LEVEL,
                trace_id=trace_id,
            )
        if Settings.WIRE_DTYPE:
            wire = getattr(torch, Settings.WIRE_DTYPE)
            size = torch.empty((), dtype=wire).element_size()
            params = canonical_map(
                lambda p: p.to(wire)
                if p.is_floating_point() and p.element_size() > size
                else p,
                params,
            )
        if int(Settings.WIRE_FORMAT) >= 3:
            return serialization.encode_model_payload_v3(
                params,
                self._contributors,
                self._num_samples,
                self.additional_info,
                pool=self.buffer_pool,
                trace_id=trace_id,
            )
        return serialization.encode_model_payload(
            params,
            self._contributors,
            self._num_samples,
            self.additional_info,
            trace_id=trace_id,
        )

    def as_ref(self, trace: str = "") -> serialization.InprocModelRef:
        """By-reference payload for co-located nodes: the parameter tree
        handed across with copied metadata, no bytes."""
        return serialization.InprocModelRef(
            self._params,
            self._contributors,
            self._num_samples,
            self.additional_info,
            trace=trace,
        )

    def decode_parameters(self, data: bytes) -> Pytree:
        params, _, _, _ = serialization.decode_model_payload(data, bases=self.base_store)
        return params

    # --- FL metadata ---

    def get_num_samples(self) -> int:
        return self._num_samples

    def set_num_samples(self, n: int) -> None:
        if n < 0:
            raise ValueError("num_samples must be >= 0")
        self._num_samples = int(n)

    def get_contributors(self) -> list[str]:
        if not self._contributors:
            raise ValueError("Contributors not set on this model")
        return self._contributors

    def set_contribution(self, contributors: list[str], num_samples: int) -> None:
        self._contributors = list(contributors)
        self.set_num_samples(num_samples)

    # --- info transport (callback/aggregator state) ---

    def add_info(self, key: str, value: Any) -> None:
        self.additional_info[key] = value

    def get_info(self, key: Optional[str] = None) -> Any:
        if key is None:
            return self.additional_info
        return self.additional_info[key]

    # --- copies ---

    def build_copy(self, **kwargs: Any) -> "TpflModel":
        """New model on the same device sharing the module but with fresh
        params/metadata. Accepts ``params`` as a tree, a flat list, or
        encoded bytes (wire intake restores this model's dtypes)."""
        params = kwargs.pop("params", None)
        m = TpflModel(
            module=self.module,
            num_samples=kwargs.pop("num_samples", 1),
            contributors=kwargs.pop("contributors", []),
            additional_info=copy.copy(kwargs.pop("additional_info", {})),
            device=self.device,
        )
        m._params = self._params
        m.aux_state = self.aux_state
        m.base_store = self.base_store
        m.buffer_pool = self.buffer_pool
        if params is not None:
            if isinstance(params, (bytes, serialization.InprocModelRef)):
                decoded, contribs, n, info = serialization.decode_model_payload(
                    params, bases=self.base_store
                )
                m._check_and_set(decoded, restore_dtype=True)
                m._contributors = contribs
                m._num_samples = n
                m.additional_info.update(info)
            else:
                m.set_parameters(params)
        return m

    def get_framework(self) -> str:
        return "torch"

    # --- convenience ---

    @property
    def num_parameters(self) -> int:
        return sum(int(np.prod(_shape(x))) for x in canonical_leaves(self._params))

    def apply_to_params(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> None:
        """Transform every leaf (attack injection: sign-flip, noise)."""
        self._params = canonical_map(fn, self._params)

    def __repr__(self) -> str:
        return (
            f"TpflModel(leaves={len(canonical_leaves(self._params))}, "
            f"params={self.num_parameters}, samples={self._num_samples}, "
            f"contributors={self._contributors}, device={self.device})"
        )


__all__ = ["TpflModel", "place", "to_device"]
