"""Lightweight distributed-tracing spans for the control plane.

A copy of `kubeflow_tpu/utils/tracing.py` (a module with no JAX in it),
whole:

- `Tracer.span(name, **attrs)` — context manager; nesting via a
  contextvar gives parent/child links; each top-level span starts a new
  trace id. Thread- and async-safe (contextvars propagate per thread).
- spans record start/end monotonic-derived wall times, duration,
  attributes, and an error flag when the body raises.
- finished spans land in a bounded ring buffer (`export()` drains JSON
  dicts, oldest dropped on overflow) — the in-process collector; ship
  them wherever by draining periodically.
- `trace_header()`/`from_header()` carry the trace id across HTTP hops
  (`x-kftpu-trace-id`, the platform's traceparent analog), so a web
  request's span tree continues into kfam/controllers.

Integration: the controller runtime wraps every reconcile in a span
(controller and key; its outcome is the span's `error`, None when the
reconcile returned) and the WSGI core wraps every request (app, method,
path and status).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import threading
import time
import uuid
from collections import deque
from typing import Any, Iterator

HEADER = "x-kftpu-trace-id"

_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "kftpu_current_span", default=None
)


@dataclasses.dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: str | None
    start: float
    attributes: dict[str, Any]
    end: float | None = None
    error: str | None = None

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "start": self.start,
            "end": self.end,
            "durationMs": (
                None if self.end is None else (self.end - self.start) * 1e3
            ),
            "attributes": dict(self.attributes),
            "error": self.error,
        }


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class Tracer:
    def __init__(self, capacity: int = 2048):
        self._lock = threading.Lock()
        self._finished: deque[dict] = deque(maxlen=capacity)
        self.dropped = 0
        self._capacity = capacity

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        *,
        trace_id: str | None = None,
        **attributes: Any,
    ) -> Iterator[Span]:
        parent = _current.get()
        span = Span(
            name=name,
            trace_id=(
                trace_id
                or (parent.trace_id if parent is not None else _new_id())
            ),
            span_id=_new_id(),
            parent_id=parent.span_id if parent is not None else None,
            start=time.time(),
            attributes=dict(attributes),
        )
        token = _current.set(span)
        try:
            yield span
        except Exception as e:
            span.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            _current.reset(token)
            span.end = time.time()
            with self._lock:
                if len(self._finished) == self._capacity:
                    self.dropped += 1
                self._finished.append(span.to_dict())

    def export(self) -> list[dict]:
        """Drain all finished spans (oldest first)."""
        with self._lock:
            out = list(self._finished)
            self._finished.clear()
            return out

    def pending(self) -> int:
        with self._lock:
            return len(self._finished)


# The process-wide tracer the runtime and web tier report to. Tests may
# instantiate their own.
tracer = Tracer()


def current_trace_id() -> str | None:
    span = _current.get()
    return span.trace_id if span is not None else None


def trace_header() -> dict[str, str]:
    """Headers to propagate the active trace across an HTTP hop."""
    trace_id = current_trace_id()
    return {HEADER: trace_id} if trace_id else {}


def from_header(headers: Any) -> str | None:
    """The inbound trace id, if the caller sent one. `headers` is any
    mapping with a case-insensitive-ish get (WSGI request headers)."""
    if headers is None:
        return None
    get = getattr(headers, "get", None)
    if get is None:
        return None
    return get(HEADER) or get(HEADER.upper()) or None
