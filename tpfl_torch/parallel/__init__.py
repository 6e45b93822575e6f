"""The port's federation engine, its drivers, its CUDA kernels and its
SPMD planes over ``torch.distributed`` (meshes and placements, the
engine's mesh windows, ring attention, the pipeline, the experts, the
FSDP trainer, the cross-host harness and the static scaling analysis).

The exports load on first access: the model zoo imports ``conv_kernel``
from this package, and the engine imports the zoo. ``crosshost``,
``ranksafe`` and ``scaling`` are exported as modules.
"""

import importlib
from typing import Any

_EXPORTS = {
    "FederationEngine": "engine",
    "FedBuffSchedule": "engine",
    "EngineWindow": "engine",
    "sample_participants": "engine",
    "auto_mesh": "engine",
    "ShardedTrainer": "sharded",
    "fsdp_spec": "sharded",
    "shard_stacked": "mesh",
    "federation_sharding": "mesh",
    "global_put": "distributed",
    "local_data": "distributed",
    "crosshost": "crosshost",
    "ranksafe": "ranksafe",
    "scaling": "scaling",
    "ClientPopulation": "population",
    "VmapFederation": "federation",
    "FederationLearner": "federation_learner",
    "WindowPipeline": "window_pipeline",
    "MembershipView": "membership",
    "create_mesh": "mesh",
    "mesh_axis_size": "mesh",
    "SpecLayout": "mesh",
    "layout_for_module": "mesh",
    "transformer_layout": "mesh",
    "NODE_AXIS": "mesh",
    "MODEL_AXIS": "mesh",
    "HOST_AXIS": "mesh",
    "FSDP_AXIS": "mesh",
    "TP_AXIS": "mesh",
    "ensure_distributed": "distributed",
    "is_multiprocess": "distributed",
    "ring_attention": "ring_attention",
    "make_ring_attention": "ring_attention",
    "blockwise_attention": "ring_attention",
    "flash_attention": "flash_kernel",
    "make_pipeline": "pipeline",
    "pipeline_forward": "pipeline",
    "make_moe_layer": "moe",
    "moe_dispatch": "moe",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str) -> Any:
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    mod = importlib.import_module(f"{__name__}.{module}")
    return mod if module == name else getattr(mod, name)
