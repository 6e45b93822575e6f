"""The port's federation engine, its drivers and its CUDA conv kernels.

The exports load on first access: the model zoo imports ``conv_kernel``
from this package, and the engine imports the zoo.
"""

import importlib
from typing import Any

_EXPORTS = {
    "FederationEngine": "engine",
    "FedBuffSchedule": "engine",
    "EngineWindow": "engine",
    "sample_participants": "engine",
    "ClientPopulation": "population",
    "VmapFederation": "federation",
    "FederationLearner": "federation_learner",
    "WindowPipeline": "window_pipeline",
    "MembershipView": "membership",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str) -> Any:
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
