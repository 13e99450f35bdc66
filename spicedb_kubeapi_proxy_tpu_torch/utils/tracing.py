"""End-to-end request tracing with per-phase latency attribution
(reference utils/tracing.py, the part the proxy's read path runs).

- `Trace`: one per proxied request, carrying monotonic-clock `Span`s,
  propagated via a contextvar through the handler chain.  Callers that
  hop threads copy the context (`contextvars.copy_context`) so
  `current_trace()` still resolves off the loop.
- Spans marked `phase=True` are the request's latency attribution: they
  tile the request wall time without overlapping (authn, resolve, match,
  queue_wait, execute, upstream, respfilter, ...), feed the
  `authz_request_phase_seconds{phase=...}` histogram and sum to about the
  wall time.  Unmarked spans are forensic detail and may overlap phases.
- `SlowTraceRecorder`: a bounded recorder retaining the N slowest traces.
- `FanoutTrace` lets the dispatcher record one fused batch's spans
  into every co-batched request's trace.
- `kernel_span` times a kernel phase on the host, opens an NVTX range
  named after it when the endpoint's device is a CUDA card (Nsight
  Systems shows the proxy's phase names on the device timeline), and
  feeds the kernel accounting (utils/devtel.py) and the dispatch
  timeline (utils/timeline.py).  `note_device_window` feeds them a
  batch's device window measured with CUDA events.

- Fleet propagation: every internal hop (router to shard leader,
  follower to leader, replication control calls) carries the
  X-Authz-Trace-Id / X-Authz-Parent-Span / X-Authz-Tier-Path headers
  (`propagation_headers`, `hop_span`), so the receiving proxy joins the
  caller's trace instead of minting its own, and the fleet merge
  (utils/fleet.py) aligns the child inside the caller's hop span.  The
  TIMELINE switch is the killswitch: off, no header is sent and
  receivers mint locally, as a single process does.

Thread-safe: spans are recorded from asyncio handlers and executor
threads concurrently.
"""

from __future__ import annotations

import contextlib
import contextvars
import heapq
import logging
import threading
import time
import uuid
from typing import Iterable, Optional

TRACE_ID_HEADER = "X-Trace-Id"

# fleet-internal trace propagation (see the module docstring)
PROP_TRACE_HEADER = "X-Authz-Trace-Id"
PROP_PARENT_HEADER = "X-Authz-Parent-Span"
PROP_TIER_PATH_HEADER = "X-Authz-Tier-Path"

# tier vocabulary for per-tier latency attribution (authz_tier_seconds)
TIERS = ("router", "leader", "follower", "hub")

_log = logging.getLogger(__name__)

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


class SpanSink:
    """Anything spans can be recorded into (Trace or FanoutTrace)."""

    def add_span(self, name: str, start: float, end: float,
                 phase: bool = False, **attrs) -> None:
        raise NotImplementedError


class Trace(SpanSink):
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


class FanoutTrace(SpanSink):
    """Multiplexes span records to several traces: the dispatcher
    activates one around a fused inner call so kernel spans land in
    every co-batched request's trace."""

    def __init__(self, traces: Iterable[SpanSink]):
        self.traces = tuple(traces)

    def add_span(self, name: str, start: float, end: float,
                 phase: bool = False, **attrs) -> None:
        for tr in self.traces:
            tr.add_span(name, start, end, phase=phase, **attrs)


def current_trace() -> Optional[SpanSink]:
    return _current.get()


def activate(sink: Optional[SpanSink]):
    """Set (or, with None, null out) the active trace; returns a token
    for `deactivate`."""
    return _current.set(sink)


def deactivate(token) -> None:
    _current.reset(token)


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


# -- fleet propagation (cross-process trace continuity) ----------------------


def propagation_enabled() -> bool:
    """True when fleet trace propagation is on: the TIMELINE switch
    (utils/features.py) turns off both the serving-stage spans and the
    cross-process headers, as the reference's Timeline gate does."""
    from . import features
    return features.TIMELINE is True


_TIER_PATH_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyz0123456789_->|,")


def clean_tier_path(raw: str) -> str:
    """Sanitize a caller-supplied tier path header: bounded, lowercase
    tier names joined by `>` — anything else is dropped (the path is
    advisory provenance, not a trust input)."""
    raw = (raw or "").strip().lower()
    if not raw or len(raw) > 128:
        return ""
    if any(c not in _TIER_PATH_OK for c in raw):
        return ""
    return raw


def propagation_headers(default_tier: str = "") -> dict:
    """Headers an outbound fleet-internal hop carries so the receiving
    proxy joins this trace instead of minting its own.  Empty when
    propagation is switched off; without an active trace the tier path
    still travels (background hops such as follower sync keep their
    provenance though they have no request trace)."""
    if not propagation_enabled():
        return {}
    headers = {}
    tr = _current.get()
    trace_id = getattr(tr, "trace_id", "") if tr is not None else ""
    if trace_id:
        headers[PROP_TRACE_HEADER] = trace_id
    path = ""
    if tr is not None:
        attrs = getattr(tr, "attrs", None)
        if isinstance(attrs, dict):
            path = str(attrs.get("tier_path") or "")
    path = path or default_tier
    if path:
        headers[PROP_TIER_PATH_HEADER] = path
    return headers


class _Hop:
    """Yielded by hop_span: `.headers` is what the caller copies onto
    the outbound request; `.span_id` is the client-side span a
    downstream trace names as its parent."""
    __slots__ = ("headers", "span_id")

    def __init__(self, headers: dict, span_id: str = ""):
        self.headers = headers
        self.span_id = span_id


_NULL_HOP = _Hop({})


@contextlib.contextmanager
def hop_span(name: str, tier: str = "", **attrs):
    """Client-side span around ONE outbound internal HTTP hop (router ->
    shard leader, follower -> leader forward, ...).  Yields a `_Hop`
    whose `.headers` carry X-Authz-Trace-Id / X-Authz-Parent-Span /
    X-Authz-Tier-Path for the outbound request.  The recorded span's
    `span_id` attr is what the downstream trace names as its parent, so
    the fleet merge aligns the child trace inside this hop and
    attributes the hop's network time apart from the downstream
    server's.  A no-op with empty headers when propagation is switched
    off or no trace is active."""
    tr = _current.get()
    if tr is None or not propagation_enabled():
        yield _NULL_HOP
        return
    span_id = uuid.uuid4().hex[:16]
    headers = propagation_headers(default_tier=tier)
    headers[PROP_PARENT_HEADER] = span_id
    t0 = time.perf_counter()
    try:
        yield _Hop(headers, span_id)
    finally:
        tr.add_span(name, t0, time.perf_counter(), span_id=span_id,
                    **attrs)


def _note_kernel(name: str, attrs: dict, seconds: float) -> None:
    """Feed one kernel window into the kernel accounting (utils/devtel.py,
    imported at use).  A recording failure is logged and never fails the
    request whose batch it measured."""
    try:
        from .devtel import note_kernel_span
        note_kernel_span(name, attrs, seconds)
    except Exception:
        _log.exception("kernel accounting failed for %s", name)


def _note_timeline(name: str, attrs: dict, start: float, end: float) -> None:
    """Feed one kernel window, with its instants, into the dispatch
    timeline's device track (utils/timeline.py); failures as above."""
    try:
        from .timeline import note_kernel_span
        note_kernel_span(name, attrs, start, end)
    except Exception:
        _log.exception("timeline record failed for %s", name)


def note_device_window(name: str, attrs: dict, start: float,
                       seconds: float) -> None:
    """A batch's device window, measured with CUDA events on the launch
    stream (or, on the CPU, around the synchronous plain kernels) and
    read when its readback completed: into the kernel accounting and the
    workload attribution (`attrs["workload"]`), and onto the timeline's
    device track from `start` (the host instant the window opened)."""
    _note_kernel(name, attrs, seconds)
    _note_timeline(name, attrs, start, start + seconds)


@contextlib.contextmanager
def kernel_span(name: str, phase: bool = False, nvtx: bool = False,
                **attrs):
    """A span timed on the host that also feeds the kernel accounting
    (`authz_kernel_time_seconds{phase=,kind=,bucket=}`) and the timeline,
    whether or not a request trace is active.  `nvtx=True` (an endpoint
    on a CUDA card) opens an NVTX range named `name` around the block;
    an endpoint on the CPU opens none.  Callers may enrich the yielded
    attrs dict (e.g. set `bucket`) before the block closes."""
    a = attrs
    t0 = time.perf_counter()
    if nvtx:
        import torch
        torch.cuda.nvtx.range_push(name)
    try:
        with span(name, phase=phase, **attrs) as a:
            yield a
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
        t1 = time.perf_counter()
        _note_kernel(name, a, t1 - t0)
        _note_timeline(name, a, t0, t1)


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

    def drain(self) -> list:
        """Snapshot and reset: a per-window view."""
        with self._lock:
            out = self._sorted()
            self._heap = []
            return out

    def exemplars(self, k: int = 3,
                  since_unix: Optional[float] = None) -> list:
        """Top-k slowest retained traces as exemplar refs (trace id,
        duration, wall start), optionally only those that STARTED at or
        after `since_unix`: the flight recorder embeds these per window,
        so a burning window at /debug/flight links to /debug/traces."""
        with self._lock:
            dicts = self._sorted()
        out = []
        for d in dicts:
            if (since_unix is not None
                    and d.get("start_unix", 0.0) < since_unix):
                continue
            out.append({"trace_id": d["trace_id"],
                        "duration_ms": d["duration_ms"],
                        "start_unix": d["start_unix"]})
            if len(out) >= k:
                break
        return out


RECORDER = SlowTraceRecorder()
