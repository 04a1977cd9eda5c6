"""Span tracing for the serving path (the port's copy of what
``EnginePool`` uses from ``repro.obs.tracing``).

A :class:`Span` is one timed region of one request: a name, a
``trace_id`` shared by every span of the request, its own ``span_id``,
an optional ``parent_id``, a start timestamp and a duration, all from
``time.perf_counter()``.  The :class:`Tracer` keeps finished spans in a
bounded, thread-safe ring buffer.  It is **disabled by default**:
``tracer.span(...)`` then returns a shared no-op handle without
allocating, so instrumentation left in hot paths costs one attribute
load and one branch.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional


def now_ms() -> float:
    """Current monotonic time in milliseconds (system-wide clock)."""
    return time.perf_counter() * 1e3


def new_id() -> str:
    """8-byte random hex id (used for both trace and span ids)."""
    return os.urandom(8).hex()


@dataclass
class Span:
    """One finished timed region of one request."""

    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    t_start_ms: float = 0.0
    duration_ms: float = 0.0
    attrs: Dict[str, object] = field(default_factory=dict)


class _SpanHandle:
    """Context manager that records a span on exit.

    ``handle.ctx()`` gives the ``{"trace_id", "parent_id"}`` dict to
    hand to child spans.
    """

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def ctx(self) -> dict:
        return {"trace_id": self.span.trace_id,
                "parent_id": self.span.span_id}

    def set(self, key: str, value: object) -> "_SpanHandle":
        self.span.attrs[key] = value
        return self

    def __enter__(self) -> "_SpanHandle":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.span.duration_ms = now_ms() - self.span.t_start_ms
        self._tracer.record(self.span)


class _NoopHandle:
    """Shared do-nothing handle returned when tracing is disabled."""

    __slots__ = ()

    def ctx(self):
        return None

    def set(self, key, value):
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_NOOP = _NoopHandle()


class Tracer:
    """Thread-safe bounded collector of finished spans."""

    def __init__(self, capacity: int = 65536, enabled: bool = False):
        self._buf: deque = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self.enabled = bool(enabled)
        self.dropped = 0

    def configure(self, *, enabled: Optional[bool] = None) -> "Tracer":
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
        return self

    def span(self, name: str, *, ctx: Optional[dict] = None,
             **attrs: object):
        """Open a span; returns a no-op handle when disabled.

        ``ctx`` is a ``{"trace_id", "parent_id"}`` dict from a parent
        handle's ``ctx()``.  Without one, the span starts a fresh trace
        as its root.
        """
        if not self.enabled:
            return _NOOP
        trace_id = parent_id = None
        if ctx:
            trace_id = ctx.get("trace_id")
            parent_id = ctx.get("parent_id")
        return _SpanHandle(self, Span(
            name=name, trace_id=trace_id or new_id(), span_id=new_id(),
            parent_id=parent_id, t_start_ms=now_ms(), attrs=dict(attrs)))

    def record(self, span: Span) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(span)

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0


_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer used by the built-in instrumentation."""
    return _GLOBAL


def configure_tracing(*, enabled: Optional[bool] = None) -> Tracer:
    return _GLOBAL.configure(enabled=enabled)
