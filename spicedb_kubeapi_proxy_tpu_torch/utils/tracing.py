"""End-to-end request tracing with per-phase latency attribution
(reference utils/tracing.py, the part the proxy's read path runs).

- `Trace`: one per proxied request, carrying monotonic-clock `Span`s,
  propagated via a contextvar through the handler chain.  Callers that
  hop threads copy the context (`contextvars.copy_context`) so
  `current_trace()` still resolves off the loop.
- Spans marked `phase=True` are the request's latency attribution: they
  tile the request wall time without overlapping (authn, resolve, match,
  upstream, respfilter, ...), feed the
  `authz_request_phase_seconds{phase=...}` histogram and sum to about the
  wall time.  Unmarked spans are forensic detail and may overlap phases.
- `SlowTraceRecorder`: a bounded recorder retaining the N slowest traces.

Left out against the reference: fleet propagation (the cross-process
X-Authz-* headers and hop spans; the port has no fleet), the fused-batch
fan-out of dispatcher spans, and `kernel_span`, which there enters
`jax.profiler.TraceAnnotation` and feeds device-time accounting.  The
port's counterpart, an NVTX range around each kernel phase, comes with
device telemetry.

Thread-safe: spans are recorded from asyncio handlers and executor
threads concurrently.
"""

from __future__ import annotations

import contextlib
import contextvars
import heapq
import threading
import time
import uuid
from typing import Optional

TRACE_ID_HEADER = "X-Trace-Id"

# per-trace span cap: a runaway loop recording spans must not grow a
# request's memory without bound (the slowest traces are retained)
_MAX_SPANS = 512

_current: contextvars.ContextVar = contextvars.ContextVar(
    "authz_request_trace", default=None)


class Span:
    __slots__ = ("name", "start", "end", "phase", "attrs")

    def __init__(self, name: str, start: float, end: float,
                 phase: bool = False, attrs: Optional[dict] = None):
        self.name = name
        self.start = start
        self.end = end
        self.phase = phase
        self.attrs = attrs or {}

    @property
    def duration(self) -> float:
        return self.end - self.start


class Trace:
    """One request's spans, on the monotonic clock (perf_counter)."""

    def __init__(self, trace_id: Optional[str] = None, **attrs):
        self.trace_id = trace_id or uuid.uuid4().hex
        self.attrs: dict = dict(attrs)
        self.wall_start = time.time()
        self.t0 = time.perf_counter()
        self.duration: Optional[float] = None
        self.spans: list = []
        self._lock = threading.Lock()

    def add_span(self, name: str, start: float, end: float,
                 phase: bool = False, **attrs) -> None:
        sp = Span(name, start, end, phase=phase, attrs=attrs or None)
        with self._lock:
            if len(self.spans) < _MAX_SPANS:
                self.spans.append(sp)

    def finish(self) -> float:
        """Freeze the trace duration (idempotent); returns seconds."""
        if self.duration is None:
            self.duration = time.perf_counter() - self.t0
        return self.duration

    def phase_durations(self) -> dict:
        """Summed seconds per phase-marked span name."""
        with self._lock:
            spans = list(self.spans)
        out: dict = {}
        for sp in spans:
            if sp.phase:
                out[sp.name] = out.get(sp.name, 0.0) + sp.duration
        return out

    def to_dict(self) -> dict:
        with self._lock:
            spans = list(self.spans)
        dur = (self.duration if self.duration is not None
               else time.perf_counter() - self.t0)
        out_spans = []
        for sp in spans:
            d = {"name": sp.name,
                 "start_ms": round((sp.start - self.t0) * 1e3, 3),
                 "duration_ms": round(sp.duration * 1e3, 3)}
            if sp.phase:
                d["phase"] = True
            if sp.attrs:
                d["attrs"] = dict(sp.attrs)
            out_spans.append(d)
        return {"trace_id": self.trace_id,
                "start_unix": round(self.wall_start, 6),
                "duration_ms": round(dur * 1e3, 3),
                "attrs": dict(self.attrs),
                "spans": out_spans}


def current_trace() -> Optional[Trace]:
    return _current.get()


def start_trace(trace_id: Optional[str] = None, **attrs):
    """Create + activate a trace; returns (trace, token)."""
    tr = Trace(trace_id=trace_id, **attrs)
    return tr, _current.set(tr)


def end_trace(token) -> None:
    _current.reset(token)


@contextlib.contextmanager
def request_trace(trace_id: Optional[str] = None, **attrs):
    """Trace the enclosed block as one request (finished on exit)."""
    tr, token = start_trace(trace_id=trace_id, **attrs)
    try:
        yield tr
    finally:
        tr.finish()
        _current.reset(token)


@contextlib.contextmanager
def span(name: str, phase: bool = False, **attrs):
    """Record a span into the active trace; no-op (near-zero cost) when
    tracing is inactive.  Yields the attrs dict so callers can enrich it
    before the span closes."""
    tr = _current.get()
    if tr is None:
        yield attrs
        return
    t0 = time.perf_counter()
    try:
        yield attrs
    finally:
        tr.add_span(name, t0, time.perf_counter(), phase=phase, **attrs)


def clean_trace_id(raw: str) -> Optional[str]:
    """Sanitize a caller-supplied trace id (header): short, printable,
    no quotes/whitespace — anything else is replaced by a fresh id."""
    raw = (raw or "").strip()
    if not raw or len(raw) > 64:
        return None
    if any(c.isspace() or c in '"\\' or not c.isprintable() for c in raw):
        return None
    return raw


class SlowTraceRecorder:
    """Bounded min-heap of the N slowest finished traces (as dicts, so
    retention never pins request objects)."""

    def __init__(self, capacity: int = 32):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._heap: list = []  # (duration_s, seq, trace_dict)
        self._seq = 0

    def record(self, trace: Trace) -> None:
        dur = trace.duration if trace.duration is not None else trace.finish()
        with self._lock:
            self._seq += 1
            entry = (dur, self._seq, trace.to_dict())
            if len(self._heap) < self.capacity:
                heapq.heappush(self._heap, entry)
            elif self._heap and dur > self._heap[0][0]:
                heapq.heapreplace(self._heap, entry)

    def _sorted(self) -> list:
        return [d for _, _, d in
                sorted(self._heap, key=lambda e: e[0], reverse=True)]

    def snapshot(self) -> list:
        """Slowest-first list of retained trace dicts (non-destructive)."""
        with self._lock:
            return self._sorted()


RECORDER = SlowTraceRecorder()
