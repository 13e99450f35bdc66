"""Metrics registry with Prometheus text exposition.

The reference advertises metrics support (README.md:28) but its embedded
SpiceDB explicitly disables them (pkg/spicedb/spicedb.go:41-53); SURVEY.md §5
directs this build to emit check/LookupResources latency and batch-size
metrics at the endpoint boundary from day one.  This module is the minimal
dependency-free implementation: Counter / Gauge / Histogram with labels, a
registry rendering the Prometheus text format, and a callback hook for
gauges sampled at scrape time (e.g. the torch:// device-graph stats).

Thread-safe: endpoint calls run from asyncio handlers and worker threads.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable, Optional

_DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_DEFAULT_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
                         4096, 16384, 65536)


def _fmt_labels(label_names: tuple, label_values: tuple,
                extra: Optional[tuple] = None) -> str:
    pairs = list(zip(label_names, label_values))
    if extra:
        pairs.append(extra)
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
    return "{" + inner + "}"


def _escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class Metric:
    kind = ""

    def __init__(self, name: str, help_text: str = "",
                 labels: Iterable[str] = ()):
        self.name = name
        self.help = help_text
        self.label_names = tuple(labels)
        self._lock = threading.Lock()

    def render(self) -> list:
        raise NotImplementedError


class Counter(Metric):
    kind = "counter"

    def __init__(self, name: str, help_text: str = "",
                 labels: Iterable[str] = ()):
        super().__init__(name, help_text, labels)
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        with self._lock:
            return self._values.get(key, 0.0)

    def snapshot(self) -> dict:
        """Consistent label-key -> value copy (for window-delta readers
        like the flight recorder, utils/devtel.py)."""
        with self._lock:
            return dict(self._values)

    def render(self) -> list:
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{_fmt_labels(self.label_names, k)}"
                f" {_fmt_value(v)}" for k, v in items] or [f"{self.name} 0"]


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, name: str, help_text: str = "",
                 labels: Iterable[str] = (),
                 callback: Optional[Callable[[], float]] = None):
        super().__init__(name, help_text, labels)
        self._values: dict[tuple, float] = {}
        self._callback = callback

    def set(self, value: float, **labels) -> None:
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        with self._lock:
            self._values[key] = float(value)

    def render(self) -> list:
        if self._callback is not None:
            try:
                self.set(float(self._callback()))
            except Exception:
                pass
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{_fmt_labels(self.label_names, k)}"
                f" {_fmt_value(v)}" for k, v in items] or [f"{self.name} 0"]


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, help_text: str = "",
                 labels: Iterable[str] = (),
                 buckets: Iterable[float] = _DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help_text, labels)
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple, list] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}

    def observe(self, value: float, **labels) -> None:
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.buckets) + 1))
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def count(self, **labels) -> int:
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        with self._lock:
            return self._totals.get(key, 0)

    def raw(self) -> dict:
        """Consistent label-key -> (bucket counts, sum, total) copy, for
        readers that diff two of them over a window."""
        with self._lock:
            return {k: (list(v), self._sums.get(k, 0.0),
                        self._totals.get(k, 0))
                    for k, v in self._counts.items()}

    def render(self) -> list:
        out = []
        with self._lock:
            keys = sorted(self._counts)
            for key in keys:
                cumulative = 0
                for i, ub in enumerate(self.buckets):
                    cumulative += self._counts[key][i]
                    out.append(
                        f"{self.name}_bucket"
                        f"{_fmt_labels(self.label_names, key, ('le', _fmt_value(ub)))}"
                        f" {cumulative}")
                cumulative += self._counts[key][-1]
                out.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels(self.label_names, key, ('le', '+Inf'))}"
                    f" {cumulative}")
                out.append(f"{self.name}_sum"
                           f"{_fmt_labels(self.label_names, key)}"
                           f" {_fmt_value(self._sums[key])}")
                out.append(f"{self.name}_count"
                           f"{_fmt_labels(self.label_names, key)}"
                           f" {cumulative}")
        return out


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}

    def register(self, metric: Metric) -> Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                return existing
            self._metrics[metric.name] = metric
            return metric

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def counter(self, name: str, help_text: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return self.register(Counter(name, help_text, labels))  # type: ignore

    def gauge(self, name: str, help_text: str = "",
              labels: Iterable[str] = (),
              callback: Optional[Callable[[], float]] = None) -> Gauge:
        g = self.register(Gauge(name, help_text, labels, callback))
        if callback is not None and g._callback is not callback:
            # re-registration rebinds the sampler (latest endpoint wins)
            g._callback = callback
        return g  # type: ignore

    def histogram(self, name: str, help_text: str = "",
                  labels: Iterable[str] = (),
                  buckets: Iterable[float] = _DEFAULT_LATENCY_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help_text, labels, buckets))  # type: ignore

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()


class Timer:
    """Context manager observing elapsed seconds into a histogram."""

    def __init__(self, histogram: Histogram, **labels):
        self.histogram = histogram
        self.labels = labels

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.histogram.observe(time.perf_counter() - self._t0, **self.labels)
        return False


# -- runtime self-metrics ----------------------------------------------------
# RSS and gc pauses in the proxy's own scrape, so one Prometheus query
# joins them with the request metrics.


def _read_rss_bytes() -> float:
    """Resident set size; /proc on linux, ru_maxrss (high-water mark, the
    closest portable signal) elsewhere."""
    try:
        with open("/proc/self/status", encoding="ascii") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) * 1024.0
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        import sys
        rss = float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
        # ru_maxrss is KB on linux/bsd but BYTES on macOS
        return rss if sys.platform == "darwin" else rss * 1024.0
    except Exception:
        return 0.0


_gc_hook_installed = False


def install_runtime_metrics(registry: Optional[Registry] = None) -> None:
    """Register the process self-metrics (idempotent):

    - `process_resident_memory_bytes` gauge, sampled at scrape time;
    - `proxy_gc_collections_total{generation=}` + `proxy_gc_pause_seconds`
      via gc callbacks (each collection's stop-the-world pause).
    """
    global _gc_hook_installed
    registry = registry or REGISTRY
    registry.gauge("process_resident_memory_bytes",
                   "Resident set size of the proxy process",
                   callback=_read_rss_bytes)
    gc_collections = registry.counter(
        "proxy_gc_collections_total",
        "Garbage collections observed via gc callbacks, by generation",
        labels=("generation",))
    gc_pause = registry.histogram(
        "proxy_gc_pause_seconds",
        "Stop-the-world pause of each observed gc collection")
    if _gc_hook_installed:
        return
    _gc_hook_installed = True
    import gc

    starts: dict = {}

    def _gc_callback(phase, info):
        gen = info.get("generation", -1)
        if phase == "start":
            starts[gen] = time.perf_counter()
        else:
            t0 = starts.pop(gen, None)
            gc_collections.inc(generation=str(gen))
            if t0 is not None:
                gc_pause.observe(time.perf_counter() - t0)

    gc.callbacks.append(_gc_callback)


class EventLoopLagProbe:
    """Event-loop responsiveness via timer drift: sleep(interval) and
    observe how late the wakeup lands.  A multi-second `execute` phase
    blocking the loop (the failure mode the off-loop kernel dispatch
    exists to prevent) shows up here before it shows up as p99."""

    def __init__(self, interval: float = 0.25,
                 registry: Optional[Registry] = None):
        registry = registry or REGISTRY
        self.interval = interval
        self.lag = registry.histogram(
            "proxy_event_loop_lag_seconds",
            "Wakeup drift of a periodic event-loop timer (scheduling lag)")
        self._task = None

    async def start(self) -> None:
        import asyncio
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        import asyncio
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    async def _run(self) -> None:
        import asyncio
        loop = asyncio.get_running_loop()
        while True:
            t0 = loop.time()
            await asyncio.sleep(self.interval)
            self.lag.observe(max(0.0, loop.time() - t0 - self.interval))
