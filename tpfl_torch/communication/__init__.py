"""Communication layer: the decentralized control and data plane — the port
of :mod:`tpfl.communication`.

Application-level gossip (TTL-flooded control messages, synchronous
convergence-driven model gossip, heartbeat liveness) behind a pluggable
transport ABC, with the in-memory transport and the chaos harness of
``communication/faults.py`` (``FaultInjector``, ``FaultPlan``,
``LinkFaults``, ``CrashWindow``, ``Partition``, ``TrainerSpeedPlan``).
Not ported, and refused with ``NotImplementedError`` naming the
``ROADMAP.md`` §1 item: the gRPC transport
(``GrpcCommunicationProtocol``; item 8).
"""

from typing import Any

from tpfl_torch.communication.faults import (
    CrashWindow,
    FaultInjector,
    FaultPlan,
    LinkFaults,
    Partition,
    TrainerSpeedPlan,
)
from tpfl_torch.communication.memory import InMemoryCommunicationProtocol
from tpfl_torch.communication.message import Message
from tpfl_torch.communication.protocol import CommunicationProtocol
from tpfl_torch.communication.resilience import CircuitBreaker
from tpfl_torch.exceptions import REST_ITEM, not_ported


def __getattr__(name: str) -> Any:
    if name == "GrpcCommunicationProtocol":
        raise not_ported(f"the gRPC transport ({name})", REST_ITEM)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Message",
    "CommunicationProtocol",
    "InMemoryCommunicationProtocol",
    "FaultInjector",
    "FaultPlan",
    "LinkFaults",
    "CrashWindow",
    "Partition",
    "TrainerSpeedPlan",
    "CircuitBreaker",
]
