"""Framework exceptions — a copy of :mod:`tpfl.exceptions` (parity with
p2pfl/exceptions.py)."""


class TpflError(Exception):
    """Base class for all tpfl errors."""


class NodeRunningException(TpflError):
    """Operation invalid while the node is (or is not) running."""


class LearnerRunningException(TpflError):
    """Operation invalid while the learner is (or is not) running."""


class ZeroRoundsException(TpflError):
    """An experiment was started with zero rounds."""


class ModelNotMatchingError(TpflError):
    """Incoming parameters do not match the model's structure/shapes."""


class DecodingParamsError(TpflError):
    """Serialized parameters could not be decoded."""


class DeltaBaseMismatchError(DecodingParamsError):
    """A residual (delta) payload referenced a base model this node does
    not hold (or holds with a different fingerprint). Recoverable: the
    receiver nacks and the sender falls back to a dense encode."""


class ChunkIntegrityError(TpflError):
    """A chunked wire stream failed reassembly (CRC mismatch, gap, or
    truncation)."""


class NodeNotRunning(TpflError):
    """A communication operation was attempted on a stopped node."""


class NeighborNotConnectedError(TpflError):
    """Tried to talk to an address that is not a connected neighbor."""


class CommunicationError(TpflError):
    """Transport-level send/connect failure."""


class ConnectionTimeoutError(CommunicationError):
    """A dial or RPC deadline expired: the peer is *slow or silent*, as
    opposed to actively refusing (connection refused / handshake
    rejected, plain :class:`CommunicationError`). The retry layer backs
    off and retries timeouts; tests can assert on the distinction."""


# --- planes the port has not ported yet --------------------------------
# Each seam the reference enters raises ``not_ported(what, ITEM)``, naming
# the ROADMAP.md §1 queue item that ports it.
ENGINE_ITEM = "ROADMAP.md §1 item 4, the engine variants"
SIMULATION_ITEM = "ROADMAP.md §1 item 5, simulation and observatories"
MULTI_DEVICE_ITEM = "ROADMAP.md §1 item 7, multi-GPU and multi-host"
REST_ITEM = "ROADMAP.md §1 item 8, the rest"


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"tpfl_torch: {what} is not ported yet ({item})")
