"""In-memory transport — the zero-network protocol implementation, a copy
of :mod:`tpfl.communication.memory` with a registry of its own (separate
from the JAX package's).

Capability parity with the reference's ``communication/protocols/memory/``
(``server_singleton.py`` + ``memory_server.py:137-204``), but NOT its
copy-paste structure: all protocol logic lives in
:class:`ThreadedCommunicationProtocol`; this class only maps "dial" to a
process-global registry lookup and "send" to a direct call into the
peer's handler (caller's thread). Every protocol test runs against both
this and the gRPC transport.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Optional

from tpfl_torch.communication.base import ThreadedCommunicationProtocol
from tpfl_torch.communication.message import Message
from tpfl_torch.exceptions import CommunicationError

_registry: dict[str, "InMemoryCommunicationProtocol"] = {}
_registry_lock = threading.Lock()
_addr_counter = itertools.count(1)


def clear_registry() -> None:
    """Test helper: drop all registered in-memory servers."""
    with _registry_lock:
        _registry.clear()


def _lookup(addr: str) -> Optional["InMemoryCommunicationProtocol"]:
    with _registry_lock:
        return _registry.get(addr)


class InMemoryCommunicationProtocol(ThreadedCommunicationProtocol):
    # Sender and receiver share one address space: under
    # Settings.INPROC_ZERO_COPY, model payloads travel as
    # InprocModelRef (frozen pytree by reference — no encode, decode,
    # or memcpy per hop) through base.model_payload. With the flag off,
    # behavior is byte-identical to the gRPC transport's payload path.
    ZERO_COPY_INPROC = True

    def __init__(self, addr: Optional[str] = None) -> None:
        super().__init__(addr or f"node-{next(_addr_counter)}")

    # --- transport hooks ---

    def _server_start(self) -> None:
        with _registry_lock:
            if self._addr in _registry:
                raise CommunicationError(f"Address {self._addr} already in use")
            _registry[self._addr] = self

    def _server_stop(self) -> None:
        with _registry_lock:
            _registry.pop(self._addr, None)

    def _dial(self, addr: str) -> Any:
        target = _lookup(addr)
        if target is None:
            raise CommunicationError(f"{addr} is not reachable")
        return target

    def _handshake(self, addr: str, conn: Any) -> None:
        # Peer adds us as a direct neighbor with a back-reference
        # (reference grpc_server.py:135-160 equivalent).
        conn._neighbors.add(self._addr, non_direct=False, conn=self)

    def _transport_send(self, addr: str, conn: Any, msg: Message) -> None:
        target = conn if conn is not None else _lookup(addr)
        if target is None or not target._started:
            raise CommunicationError(f"{addr} is unreachable")
        target.handle_message(msg)
