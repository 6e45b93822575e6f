"""Communication layer: the decentralized control and data plane — the port
of :mod:`tpfl.communication`.

Application-level gossip (TTL-flooded control messages, synchronous
convergence-driven model gossip, heartbeat liveness) behind a pluggable
transport ABC, with the in-memory transport and the chaos harness of
``communication/faults.py`` (``FaultInjector``, ``FaultPlan``,
``LinkFaults``, ``CrashWindow``, ``Partition``, ``TrainerSpeedPlan``),
and the real-network transport, :class:`TcpCommunicationProtocol`
(:mod:`tpfl_torch.communication.tcp_transport`). The reference's
``GrpcCommunicationProtocol`` is refused with ``NotImplementedError``
naming that counterpart: the port does not depend on ``grpcio``, and the
TCP transport carries the same routes and bytes without HTTP/2.
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
from tpfl_torch.communication.tcp_transport import TcpCommunicationProtocol


def __getattr__(name: str) -> Any:
    if name == "GrpcCommunicationProtocol":
        raise NotImplementedError(
            "tpfl_torch: GrpcCommunicationProtocol is not ported: the port does not "
            "depend on grpcio. Its counterpart is "
            "tpfl_torch.communication.TcpCommunicationProtocol: the same four routes, "
            "envelope and chunk-frame bytes, knobs and mTLS, over length-prefixed TCP "
            "instead of HTTP/2, so a port node does not talk to a JAX gRPC node.")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Message",
    "CommunicationProtocol",
    "InMemoryCommunicationProtocol",
    "TcpCommunicationProtocol",
    "FaultInjector",
    "FaultPlan",
    "LinkFaults",
    "CrashWindow",
    "Partition",
    "TrainerSpeedPlan",
    "CircuitBreaker",
]
