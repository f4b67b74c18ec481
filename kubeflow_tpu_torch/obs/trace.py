"""Spans + per-process collector + W3C-traceparent propagation helpers.

A span is (name, t0, t1, attrs, parent) on a wall-clock timeline —
wall-clock, not monotonic, because spans from MANY processes (router,
model server, workers, operator) merge into one trace and only epoch
time is comparable across them. The collector is a lock-fenced ring
buffer: observation must be unconditionally cheap and bounded, so old
closed spans are overwritten (counted) rather than ever growing a list
— the same discipline the CanaryGate histogram fix applies to latencies.

Context propagation uses the W3C traceparent wire format
(``00-<32hex trace>-<16hex span>-01``) carried as an HTTP header AND as
a ``traceparent`` request parameter, so both the stdlib HTTP surfaces
and the in-process backends (router fronting a Model directly) chain
spans the same way.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import uuid
from typing import Optional, Union

TRACEPARENT_HEADER = "traceparent"


def new_trace_id() -> str:
    return uuid.uuid4().hex                       # 32 hex chars


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]                  # 16 hex chars


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(value) -> Optional[tuple[str, str]]:
    """-> (trace_id, span_id), or None for anything malformed. Tolerant:
    propagation must never fail a request over a bad header."""
    if not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    _, trace_id, span_id, _ = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        t, s = int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if t == 0 or s == 0:                          # all-zero ids are invalid
        return None
    return trace_id.lower(), span_id.lower()


@dataclasses.dataclass
class Span:
    """One timed operation. ``t1 is None`` while open; ``attrs`` is free-
    form (counts, replica names, error tags). ``proc``/``tid`` are the
    Perfetto track the exporter places the span on."""

    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    t0: float
    t1: Optional[float] = None
    attrs: dict = dataclasses.field(default_factory=dict)
    proc: str = ""
    tid: int = 0

    def traceparent(self) -> str:
        """The propagation header for children of THIS span."""
        return format_traceparent(self.trace_id, self.span_id)

    def duration(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def to_dict(self) -> dict:
        return {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "t0": self.t0, "t1": self.t1, "attrs": dict(self.attrs),
            "proc": self.proc, "tid": self.tid,
        }


Parent = Union[Span, str, tuple, None]


def span_in_trace(span: dict, trace_id: str) -> bool:
    """THE trace-membership rule (shared by collector and exporter): a
    span belongs to a trace when it owns the id, or carries it in
    ``attrs.trace_ids`` — how engine-level dispatches covering several
    requests advertise every trace they served."""
    return (span.get("trace_id") == trace_id
            or trace_id in (span.get("attrs", {}).get("trace_ids") or ()))


class SpanCollector:
    """Lock-fenced ring buffer of closed spans + the set of open ones.

    ``start`` -> ``end`` (or the ``span(...)`` context manager) is the
    whole API surface instrumented code touches. Memory is O(capacity):
    when the ring wraps, the oldest closed span is overwritten and
    ``dropped`` counts it. ``abort_open`` closes every open span (of one
    trace, or all) with an ``aborted`` attr — the contract that keeps a
    request whose owner died mid-flight from leaking an unclosed span
    into the export.
    """

    def __init__(self, capacity: int = 4096, proc: Optional[str] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.proc = proc or f"pid{os.getpid()}"
        self._lock = threading.Lock()
        self._ring: list[Optional[Span]] = [None] * self.capacity
        self._next = 0                 # total closed spans ever appended
        self.dropped = 0
        self._open: dict[str, Span] = {}

    # ------------------------------------------------------- lifecycle --

    def start(self, name: str, *, parent: Parent = None,
              trace_id: Optional[str] = None,
              attrs: Optional[dict] = None) -> Span:
        """Open a span. ``parent`` may be a Span, a traceparent string,
        or a ``(trace_id, span_id)`` tuple; with no parent and no
        ``trace_id`` the span roots a new trace."""
        parent_id = None
        if isinstance(parent, Span):
            trace_id = trace_id or parent.trace_id
            parent_id = parent.span_id
        elif isinstance(parent, str):
            ctx = parse_traceparent(parent)
            if ctx is not None:
                trace_id = trace_id or ctx[0]
                parent_id = ctx[1]
        elif isinstance(parent, tuple) and len(parent) == 2:
            trace_id = trace_id or parent[0]
            parent_id = parent[1]
        span = Span(name=name, trace_id=trace_id or new_trace_id(),
                    span_id=new_span_id(), parent_id=parent_id,
                    t0=time.time(), attrs=dict(attrs or {}),
                    proc=self.proc, tid=threading.get_ident())
        with self._lock:
            self._open[span.span_id] = span
        return span

    def end(self, span: Span, **attrs) -> Span:
        """Close a span (idempotent, fenced by the collector lock): two
        racing enders — e.g. a client-abort thread and the engine step
        thread both seeing ``t1 is None`` — append exactly ONE ring
        entry; the loser's attrs are dropped with the race, never
        half-merged over the winner's."""
        with self._lock:
            if self._open.pop(span.span_id, None) is None:
                return span              # already ended (or foreign)
            if span.t1 is None:
                span.t1 = time.time()
            span.attrs.update(attrs)
            if self._next >= self.capacity:
                self.dropped += 1
            self._ring[self._next % self.capacity] = span
            self._next += 1
        return span

    @contextlib.contextmanager
    def span(self, name: str, *, parent: Parent = None,
             trace_id: Optional[str] = None, attrs: Optional[dict] = None):
        s = self.start(name, parent=parent, trace_id=trace_id, attrs=attrs)
        try:
            yield s
        except BaseException as e:
            if s.t1 is None:
                self.end(s, error=type(e).__name__)
            raise
        finally:
            if s.t1 is None:
                self.end(s)

    def abort_open(self, trace_id: Optional[str] = None,
                   reason: str = "abort") -> int:
        """Close every open span (of ``trace_id``, or all): the span
        becomes a normal closed span with ``aborted=<reason>`` so traces
        of aborted/failed requests stay coherent. Returns the count."""
        with self._lock:
            victims = [s for s in self._open.values()
                       if trace_id is None or s.trace_id == trace_id]
        for s in victims:
            self.end(s, aborted=reason)
        return len(victims)

    # --------------------------------------------------------- reading --

    @property
    def open_count(self) -> int:
        with self._lock:
            return len(self._open)

    def snapshot(self) -> list[dict]:
        """Closed spans, oldest first (at most ``capacity``)."""
        with self._lock:
            n = min(self._next, self.capacity)
            start = self._next - n
            spans = [self._ring[(start + i) % self.capacity]
                     for i in range(n)]
        return [s.to_dict() for s in spans if s is not None]

    def spans_for(self, trace_id: str) -> list[dict]:
        """Closed spans belonging to one trace (the shared
        ``span_in_trace`` membership rule)."""
        return [s for s in self.snapshot() if span_in_trace(s, trace_id)]

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity
            self._next = 0
            self.dropped = 0
            self._open.clear()


_global = SpanCollector()


def collector() -> SpanCollector:
    """The per-process default collector every instrumented surface
    (engine, server, router) records into unless handed its own."""
    return _global
