"""On-demand sampling profiler for the serving tier (the reference's
utils/profiler.py; host only).

A dependency-free wall-clock sampler: a capture thread polls
`sys._current_frames()` at ~100 Hz for a bounded window and aggregates
every thread's stack into collapsed-stack lines (`root;...;leaf count`,
the flamegraph.pl / speedscope input format) plus a Perfetto-compatible
chrome-trace event list.  Served at the authed `/debug/profile?seconds=N`
endpoint (proxy/server.py), which runs the blocking capture on a worker
thread so the event loop — usually the most interesting thread — keeps
running and gets sampled doing real work.

Deliberate properties:

- **Bounded**: requested durations are clamped to `HARD_CAP_S`; a second
  capture while one is running is refused (`ProfilerBusy`) rather than
  queued, so the surface cannot be used to pile up sampler threads.
- **Idle-free**: no background thread exists between captures; when
  nobody asks for a profile the cost is zero.
- **Killswitch**: the `PROFILER` switch (utils/features.py, the
  reference's `Profiler` gate) refuses captures outright
  (`ProfilerDisabled`).

Sampling, not tracing: frames are attributed by wall-clock presence, so
a function with N% of samples spent ~N% of wall time on-stack (including
time blocked on locks/IO — often exactly what you want to see in a
proxy).  Threads waiting in epoll show as `select`/`poll` leaves.
"""

from __future__ import annotations

import os.path
import sys
import threading
import time
from typing import Optional

from . import metrics as m

# ceiling on a single capture window; requests beyond it are clamped
HARD_CAP_S = 30.0
# default / maximum sampling rate (wall-clock Hz; prime-ish to avoid
# beating against 10ms-periodic work)
DEFAULT_HZ = 97.0
# chrome-trace event cap: long high-rate captures keep the collapsed
# aggregate exact but truncate the per-sample event list
MAX_TRACE_EVENTS = 20000


class ProfilerDisabled(RuntimeError):
    """Capture refused: the PROFILER switch is off."""


class ProfilerBusy(RuntimeError):
    """Capture refused: another capture is already running."""


def enabled() -> bool:
    """The PROFILER switch, read at each use."""
    from . import features
    return features.PROFILER is True


def _frame_label(frame) -> str:
    code = frame.f_code
    base = os.path.basename(code.co_filename)
    # ';' is the collapsed-stack separator — keep it out of labels
    return f"{code.co_name} ({base}:{code.co_firstlineno})".replace(";", ",")


def _stack_of(frame) -> list:
    """Root-to-leaf collapsed-stack labels for one thread's frame."""
    rev = []
    while frame is not None:
        rev.append(_frame_label(frame))
        frame = frame.f_back
    rev.reverse()
    return rev


class SamplingProfiler:
    """One-capture-at-a-time wall-clock stack sampler."""

    def __init__(self, registry: Optional[m.Registry] = None):
        registry = registry or m.REGISTRY
        self._busy = threading.Lock()
        self._captures = registry.counter(
            "authz_profile_captures_total",
            "Completed /debug/profile sampling captures")

    def capture(self, seconds: float, hz: float = DEFAULT_HZ) -> dict:
        """Blocking capture of `seconds` of wall-clock samples across
        all threads.  Raises ProfilerDisabled / ProfilerBusy; callers
        (the debug surface) run this on a worker thread."""
        if not enabled():
            raise ProfilerDisabled("Profiler feature gate disabled")
        seconds = min(max(float(seconds), 0.05), HARD_CAP_S)
        hz = min(max(float(hz), 1.0), DEFAULT_HZ)
        if not self._busy.acquire(blocking=False):
            raise ProfilerBusy("a profile capture is already running")
        try:
            return self._run(seconds, hz)
        finally:
            self._busy.release()

    def _run(self, seconds: float, hz: float) -> dict:
        interval = 1.0 / hz
        me = threading.get_ident()
        collapsed: dict = {}
        events: list = []
        samples = 0
        thread_ids: set = set()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        next_tick = t0
        while True:
            now = time.perf_counter()
            if now >= deadline:
                break
            names = {t.ident: t.name for t in threading.enumerate()}
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                stack = _stack_of(frame)
                if not stack:
                    continue
                thread_ids.add(ident)
                key = ";".join(stack)
                collapsed[key] = collapsed.get(key, 0) + 1
                if len(events) < MAX_TRACE_EVENTS:
                    events.append({
                        "name": stack[-1],
                        "cat": "sample",
                        "ph": "X",
                        "ts": int((now - t0) * 1e6),
                        "dur": int(interval * 1e6),
                        "pid": 1,
                        "tid": ident,
                        "args": {"thread": names.get(ident, str(ident)),
                                 "stack": key},
                    })
            samples += 1
            next_tick += interval
            delay = next_tick - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
        self._captures.inc()
        lines = [f"{k} {v}" for k, v in
                 sorted(collapsed.items(), key=lambda kv: -kv[1])]
        return {
            "seconds": round(time.perf_counter() - t0, 3),
            "hz": hz,
            "samples": samples,
            "threads": len(thread_ids),
            "collapsed": lines,
            "chrome_trace": {"traceEvents": events,
                             "displayTimeUnit": "ms"},
            "truncated_events": len(events) >= MAX_TRACE_EVENTS,
        }


PROFILER = SamplingProfiler()


def capture(seconds: float, hz: float = DEFAULT_HZ) -> dict:
    return PROFILER.capture(seconds, hz)
