"""Low-overhead request tracing: spans, a bounded ring, a no-op path.

A :class:`Span` is one named interval with attributes; a trace is the
set of spans sharing a ``trace_id`` (the scheduler uses the request's
admission sequence number, so every request is its own trace). The
serving pipeline records one trace per request across
admission -> queue -> batch-form -> execute -> deliver, with the
traversal telemetry (``chunks_dispatched``, ``tiles_visited``, ...)
attached to the execute span by ``obs.trace_exec`` — a single exported
trace answers *why* a query was slow: it waited in the queue, it rode a
batch with an expensive batchmate, or its own traversal dispatched many
chunks.

Clock discipline matches the serving health monitor: the tracer holds a
``now`` callable (``time.perf_counter`` by default) and every
``start`` / ``finish`` / ``emit`` accepts an explicit ``now=`` /
timestamp override, so span lifecycles are fully drivable on a
simulated clock — no tracing test sleeps.

Storage is a bounded ring (``collections.deque(maxlen=capacity)``):
finished spans append FIFO and the oldest spans fall off
deterministically once the ring is full. Spans are only *in* the ring
once finished; an abandoned started span costs nothing.

``Tracer.span`` nests: a span opened inside another on the same thread,
with no ``parent`` or ``trace_id`` of its own, becomes the open span's
child. With ``profile=True`` each ``span`` also opens a
``torch.profiler.record_function`` range of the same name, so a profiler
trace places the program's spans on the clock of its host ops and
device kernels (the ring keeps ``now``'s clock). torch is imported only
then: the rest of this module needs the standard library alone.

The disabled path is :data:`NULL_TRACER`, a module-level
:class:`NullTracer` singleton: ``enabled`` is False, ``start`` /
``emit`` return the shared immutable no-op span, ``span`` the shared
no-op context manager that yields it, and nothing allocates. Callers
guard attribute assembly with ``if tracer.enabled:`` so a disabled
pipeline pays a single attribute load per request — the overhead-guard
test pins this.
"""
from __future__ import annotations

import itertools
import math
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext


class Span:
    """One named interval. ``t_end`` is NaN until finished."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t_start",
                 "t_end", "attrs")

    def __init__(self, name: str, trace_id, span_id: int,
                 parent_id: int | None, t_start: float, attrs: dict):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_start = t_start
        self.t_end = math.nan
        self.attrs = attrs

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    @property
    def duration_ms(self) -> float:
        return (self.t_end - self.t_start) * 1e3

    def to_dict(self) -> dict:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "t_start": self.t_start, "t_end": self.t_end,
                "duration_ms": self.duration_ms, "attrs": dict(self.attrs)}

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"{self.duration_ms:.3f}ms, {self.attrs})")


class _NullSpan:
    """The shared no-op span: every mutation is a no-op returning self,
    so disabled-mode call sites keep their shape without branching."""

    __slots__ = ()
    name = ""
    trace_id = None
    span_id = -1
    parent_id = None
    t_start = math.nan
    t_end = math.nan
    duration_ms = math.nan
    attrs: dict = {}

    def set(self, **attrs) -> "_NullSpan":
        return self

    def to_dict(self) -> dict:
        return {}


NULL_SPAN = _NullSpan()

# What the disabled tracer's ``span`` returns, every call: entering it
# yields the no-op span.
_NULL_SPAN_CONTEXT = nullcontext(NULL_SPAN)


class Tracer:
    """Span recorder over a bounded ring buffer.

    ``capacity`` bounds retained *finished* spans (oldest evicted
    first); ``now`` is the clock every unstamped start/finish reads.
    Thread-safe: the scheduler and N executor threads finish spans
    concurrently. ``profile=True`` puts each ``span`` on a profiler's
    timeline too (``torch.profiler.record_function``).
    """

    enabled = True

    def __init__(self, capacity: int = 4096, now=time.perf_counter,
                 profile: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._now = now
        self._ring: deque[Span] = deque(maxlen=capacity)
        self._span_ids = itertools.count()
        self._trace_ids = itertools.count()
        self._lock = threading.Lock()
        self._open = threading.local()   # .stack: this thread's open spans
        self._range = None
        if profile:
            from torch.profiler import record_function
            self._range = record_function

    def now(self) -> float:
        return self._now()

    # -- recording -----------------------------------------------------------

    def start(self, name: str, *, trace_id=None, parent: Span | None = None,
              now: float | None = None, **attrs) -> Span:
        """A live span (not yet in the ring). ``trace_id`` defaults to
        the parent's, else a fresh auto id."""
        if trace_id is None:
            trace_id = (parent.trace_id if parent is not None
                        else next(self._trace_ids))
        return Span(name, trace_id, next(self._span_ids),
                    None if parent is None else parent.span_id,
                    self._now() if now is None else now, attrs)

    def finish(self, span: Span, now: float | None = None) -> Span:
        """Stamp ``t_end`` and commit the span to the ring."""
        if span is NULL_SPAN:
            return span
        span.t_end = self._now() if now is None else now
        with self._lock:
            self._ring.append(span)
        return span

    def emit(self, name: str, t_start: float, t_end: float, *,
             trace_id=None, parent: Span | None = None, **attrs) -> Span:
        """Record an already-elapsed interval in one call — the
        retroactive path the scheduler uses at delivery time, so a
        request in flight holds timestamps, not span objects."""
        span = self.start(name, trace_id=trace_id, parent=parent,
                          now=t_start, **attrs)
        return self.finish(span, now=t_end)

    @contextmanager
    def span(self, name: str, *, trace_id=None, parent: Span | None = None,
             **attrs):
        """A span over the ``with`` block, committed when it ends. Without
        ``parent`` or ``trace_id`` it is the child of this thread's
        innermost open ``span``, if any."""
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        if parent is None and trace_id is None and stack:
            parent = stack[-1]
        s = self.start(name, trace_id=trace_id, parent=parent, **attrs)
        stack.append(s)
        try:
            if self._range is None:
                yield s
            else:
                with self._range(name):
                    yield s
        finally:
            stack.pop()
            self.finish(s)

    # -- reading -------------------------------------------------------------

    def export(self, trace_id=None) -> list[dict]:
        """Finished spans as dicts, ring (finish) order; optionally one
        trace only. This is the interchange format ``obs.cost`` fits
        from."""
        with self._lock:
            spans = list(self._ring)
        return [s.to_dict() for s in spans
                if trace_id is None or s.trace_id == trace_id]

    def trace(self, trace_id) -> list[dict]:
        return self.export(trace_id)

    def slowest(self, name: str = "request"):
        """Trace id of the longest finished span named ``name`` (None if
        absent) — 'show me the worst request' in one call."""
        with self._lock:
            spans = [s for s in self._ring if s.name == name]
        if not spans:
            return None
        return max(spans, key=lambda s: s.duration_ms).trace_id

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


class NullTracer:
    """The zero-cost disabled tracer: same surface as :class:`Tracer`,
    no state, no allocation. ``enabled`` is False so hot paths skip
    attribute assembly entirely."""

    enabled = False
    capacity = 0

    def now(self) -> float:
        return 0.0

    def start(self, name: str, **kwargs) -> _NullSpan:
        return NULL_SPAN

    def finish(self, span, now: float | None = None) -> _NullSpan:
        return NULL_SPAN

    def emit(self, name: str, t_start: float, t_end: float,
             **kwargs) -> _NullSpan:
        return NULL_SPAN

    def span(self, name: str, **kwargs):
        return _NULL_SPAN_CONTEXT

    def export(self, trace_id=None) -> list:
        return []

    def trace(self, trace_id) -> list:
        return []

    def slowest(self, name: str = "request"):
        return None

    def clear(self) -> None:
        pass

    def __len__(self) -> int:
        return 0


NULL_TRACER = NullTracer()
