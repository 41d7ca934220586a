"""Request-scoped trace identity across processes.

Port of ``transformer_tpu/obs/trace.py``'s :class:`SpanContext` (standard
library only): the ``(trace_id, span_id)`` pair a span is known by, minted
from ``os.urandom`` and carried between processes in the W3C
``traceparent`` form ``00-<trace>-<span>-01``. The fleet's router mints
one for each request (under an incoming client ``traceparent`` when the
request has one) and forwards it to the replica that serves it, so every
redispatch of a request keeps one trace id. The tracer that records spans
into an event log comes with the port's telemetry.
"""

from __future__ import annotations

import os

_TRACEPARENT_VERSION = "00"


def _hex_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class SpanContext:
    """The serializable identity of one span: ``(trace_id, span_id)``.

    ``trace_id`` is 16 bytes (32 hex chars) shared by every span of one
    request's tree; ``span_id`` is 8 bytes (16 hex chars) unique per span.
    The wire form is the W3C traceparent header: ``00-<trace>-<span>-01``.
    """

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    @classmethod
    def new(cls) -> "SpanContext":
        return cls(_hex_id(16), _hex_id(8))

    def child(self) -> "SpanContext":
        """A fresh span id under the same trace."""
        return SpanContext(self.trace_id, _hex_id(8))

    def to_traceparent(self) -> str:
        return f"{_TRACEPARENT_VERSION}-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_traceparent(cls, header) -> "SpanContext | None":
        """Parse a traceparent header; None (never an exception) on any
        malformation: an invalid incoming header starts a new trace, it
        does not fail the request that carries it (W3C semantics)."""
        if not isinstance(header, str):
            return None
        parts = header.strip().lower().split("-")
        if len(parts) != 4:
            return None
        version, trace_id, span_id, _flags = parts
        if len(version) != 2 or version == "ff":
            return None
        if len(trace_id) != 32 or len(span_id) != 16:
            return None
        try:
            int(trace_id, 16), int(span_id, 16)
        except ValueError:
            return None
        if trace_id == "0" * 32 or span_id == "0" * 16:
            return None
        return cls(trace_id, span_id)
