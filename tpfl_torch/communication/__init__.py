"""Communication layer: the decentralized control and data plane — the port
of :mod:`tpfl.communication`.

Application-level gossip (TTL-flooded control messages, synchronous
convergence-driven model gossip, heartbeat liveness) behind a pluggable
transport ABC, with the in-memory transport. Not ported, and refused with
``NotImplementedError`` naming the ``ROADMAP.md`` §1 item: the chaos
harness of ``communication/faults.py`` (``FaultInjector``, ``FaultPlan``,
``LinkFaults``, ``CrashWindow``, ``Partition``; item 2) and the gRPC
transport (``GrpcCommunicationProtocol``; item 8).
"""

from typing import Any

from tpfl_torch.communication.memory import InMemoryCommunicationProtocol
from tpfl_torch.communication.message import Message
from tpfl_torch.communication.protocol import CommunicationProtocol
from tpfl_torch.communication.resilience import CircuitBreaker
from tpfl_torch.exceptions import REST_ITEM, RUNTIME_B_ITEM, not_ported

_REFUSED = {
    **dict.fromkeys(("FaultInjector", "FaultPlan", "LinkFaults", "CrashWindow", "Partition"),
                    ("communication/faults.py", RUNTIME_B_ITEM)),
    "GrpcCommunicationProtocol": ("the gRPC transport", REST_ITEM),
}


def __getattr__(name: str) -> Any:
    if name in _REFUSED:
        raise not_ported(f"{_REFUSED[name][0]} ({name})", _REFUSED[name][1])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Message",
    "CommunicationProtocol",
    "InMemoryCommunicationProtocol",
    "CircuitBreaker",
]
