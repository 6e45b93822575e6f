"""Communication layer: the decentralized control and data plane — the port
of :mod:`tpfl.communication`.

Application-level gossip (TTL-flooded control messages, synchronous
convergence-driven model gossip, heartbeat liveness) behind a pluggable
transport ABC, with the in-memory transport and the chaos harness of
``communication/faults.py`` (``FaultInjector``, ``FaultPlan``,
``LinkFaults``, ``CrashWindow``, ``Partition``, ``TrainerSpeedPlan``),
and the real-network transports: :class:`GrpcCommunicationProtocol`
(:mod:`tpfl_torch.communication.grpc_transport`), the reference's gRPC
wire written on the standard library (HTTP/2 and HPACK in
:mod:`~tpfl_torch.communication.http2` and
:mod:`~tpfl_torch.communication.hpack`), so that port nodes and the JAX
package's nodes federate; and :class:`TcpCommunicationProtocol`
(:mod:`tpfl_torch.communication.tcp_transport`), the same routes and
bytes over length-prefixed TCP, which only port nodes speak.
"""

from tpfl_torch.communication.faults import (
    CrashWindow,
    FaultInjector,
    FaultPlan,
    LinkFaults,
    Partition,
    TrainerSpeedPlan,
)
from tpfl_torch.communication.grpc_transport import GrpcCommunicationProtocol
from tpfl_torch.communication.memory import InMemoryCommunicationProtocol
from tpfl_torch.communication.message import Message
from tpfl_torch.communication.protocol import CommunicationProtocol
from tpfl_torch.communication.resilience import CircuitBreaker
from tpfl_torch.communication.tcp_transport import TcpCommunicationProtocol


__all__ = [
    "Message",
    "CommunicationProtocol",
    "InMemoryCommunicationProtocol",
    "GrpcCommunicationProtocol",
    "TcpCommunicationProtocol",
    "FaultInjector",
    "FaultPlan",
    "LinkFaults",
    "CrashWindow",
    "Partition",
    "TrainerSpeedPlan",
    "CircuitBreaker",
]
