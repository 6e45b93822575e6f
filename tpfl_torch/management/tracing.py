"""Hop-level distributed tracing — the gate of :mod:`tpfl.management.tracing`.

The reference mints a trace id when a model payload is first encoded and
records spans and events of every hop into a per-node flight recorder,
all behind ``Settings.TELEMETRY_ENABLED`` (off by default). The flight
recorder (``telemetry.py``) and the body of this module are not ported
(``ROADMAP.md`` §1 item 2). The runtime's call sites are kept: while the
knob is off (the reference's default) :func:`maybe_span`, :func:`event`,
:func:`mint` and :func:`payload_trace_id` do nothing, exactly as the
reference's do; with it on they raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

from tpfl_torch.exceptions import RUNTIME_B_ITEM, not_ported
from tpfl_torch.settings import Settings


def _refuse_when_on() -> None:
    if Settings.TELEMETRY_ENABLED:
        raise not_ported("Settings.TELEMETRY_ENABLED (the flight recorder)", RUNTIME_B_ITEM)


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        pass

    def set(self, **attrs: Any) -> None:
        pass


_NULL = _NullSpan()


def maybe_span(name: str, node: str, trace: str = "", **attrs: Any) -> _NullSpan:
    _refuse_when_on()
    return _NULL


def event(name: str, node: str, trace: str = "", **attrs: Any) -> None:
    _refuse_when_on()


def mint(node: str) -> str:
    _refuse_when_on()
    return ""


def payload_trace_id(payload: Any) -> str:
    _refuse_when_on()
    return ""


__all__ = ["event", "maybe_span", "mint", "payload_trace_id"]
