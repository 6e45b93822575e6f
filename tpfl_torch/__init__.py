"""tpfl_torch — the PyTorch / CUDA port of tpfl.

The port runs the N-node federation round of :mod:`tpfl.parallel.engine`
on an NVIDIA Hopper card (node-stacked parameters, local training on
every node, the fold and the broadcast of the aggregate) and the
protocol learning layer of :mod:`tpfl.learning` (one model per learner,
the wire envelopes, the aggregators). The per-node 3×3 conv backward and
flash attention run through hand-written CUDA kernels
(:mod:`tpfl_torch.parallel.conv_kernel`, ``flash_kernel``).

The package imports torch and numpy only. Every entry point takes
``device=None``, which means the card: without one it raises rather than
falling back to the CPU, so a CPU run is always asked for by name
(``device="cpu"``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``. A CUDA device without a card raises and
    names the CPU escape hatch; the port never runs on the CPU unless
    the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpfl_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path on the CPU"
        )
    return dev


__all__ = ["resolve_device"]
