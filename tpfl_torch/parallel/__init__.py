"""The port's federation engine and its CUDA conv kernels.

``FederationEngine`` and ``VmapFederation`` load on first access: the
model zoo imports ``conv_kernel`` from this package, and the engine
imports the zoo.
"""

from typing import Any

__all__ = ["FederationEngine", "VmapFederation"]


def __getattr__(name: str) -> Any:
    if name == "FederationEngine":
        from tpfl_torch.parallel.engine import FederationEngine

        return FederationEngine
    if name == "VmapFederation":
        from tpfl_torch.parallel.federation import VmapFederation

        return VmapFederation
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
