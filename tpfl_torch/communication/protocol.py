"""CommunicationProtocol ABC — the pluggable transport contract, a copy of
:mod:`tpfl.communication.protocol`.

Parity with the reference
``communication/protocols/communication_protocol.py:27-198`` (12
abstract methods, including the closure-driven ``gossip_weights``: the
*stage* supplies candidate selection / early-stop / model serialization,
the protocol only moves bytes).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Optional

from tpfl_torch.communication.message import Message

CommandHandler = Callable[..., Optional[str]]


class CommunicationProtocol(ABC):
    """Contract every transport (in-memory, gRPC) implements."""

    @abstractmethod
    def get_address(self) -> str: ...

    @abstractmethod
    def start(self) -> None:
        """Bind/start server, heartbeater, gossiper."""

    @abstractmethod
    def stop(self) -> None:
        """Stop threads, close server, clear neighbors."""

    @abstractmethod
    def add_command(self, name: str, handler: CommandHandler) -> None:
        """Register an application verb into the dispatch table
        (reference node.py:122-134 / grpc_server.py:223-237)."""

    @abstractmethod
    def connect(self, addr: str, non_direct: bool = False) -> bool:
        """Handshake with a peer; returns success."""

    @abstractmethod
    def disconnect(self, addr: str, disconnect_msg: bool = True) -> None: ...

    @abstractmethod
    def build_msg(
        self,
        cmd: str,
        args: Optional[list[str]] = None,
        round: Optional[int] = None,
        ttl: Optional[int] = None,
    ) -> Message:
        """Control message with fresh dedup hash; ``ttl`` overrides
        Settings.TTL (1 = direct delivery only, no re-flood)."""

    @abstractmethod
    def build_weights(
        self,
        cmd: str,
        round: int,
        serialized_model: bytes,
        contributors: Optional[list[str]] = None,
        num_samples: int = 0,
    ) -> Message: ...

    @abstractmethod
    def send(
        self,
        nei: str,
        msg: Message,
        create_connection: bool = False,
        raise_error: bool = False,
    ) -> None: ...

    @abstractmethod
    def broadcast(self, msg: Message, node_list: Optional[list[str]] = None) -> None:
        """Send to all direct neighbors (or an explicit list)."""

    @abstractmethod
    def get_neighbors(self, only_direct: bool = False) -> dict[str, Any]: ...

    @abstractmethod
    def wait_for_termination(self) -> None: ...

    def gossip_weights(
        self,
        early_stopping_fn: Callable[[], bool],
        get_candidates_fn: Callable[[], list[str]],
        status_fn: Callable[[], Any],
        model_fn: Callable[[str], Optional[Message]],
        period: Optional[float] = None,
        create_connection: bool = False,
        exit_on_static: Optional[int] = None,
    ) -> None:
        """Synchronous convergence-driven model gossip (reference
        gossiper.py:163-239); implemented once over the transport
        primitives by the Gossiper each protocol owns."""
        raise NotImplementedError
