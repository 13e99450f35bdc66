"""Device telemetry and the flight recorder (the reference's
utils/devtel.py, for the torch port).

The `torch://` hot path runs on a card that the host-side surfaces
(tracing phases, endpoint latency histograms, audit events) cannot see
into: how many bytes of device memory the gather tables, arenas and
closure planes hold, how often new lane buckets or table swaps make the
sweep graphs recapture, and how much of each fused batch is padding.
This module makes those legible:

1. **HBM ledger** (`HbmLedger`): every device tensor the endpoint
   materializes (ELL gather tables and aux trees, the caveat table,
   segment edge arrays, state arenas, id views, Leopard planes, mesh
   blocks) is registered with (kind, generation, bytes), the bytes read
   from the tensor's storage.  An install retires the outgoing
   generation wholesale, so a leaked old-generation buffer shows as a
   non-returning `authz_device_bytes{kind=}`; a peak rides along.

2. **Kernel and compile accounting** (`KernelAccounting`): per-batch
   device time by (span, kind, batch bucket), fed by
   `utils/tracing.kernel_span` (host windows) and
   `tracing.note_device_window` (CUDA-event windows read at readback);
   the port's "compiles" are the nvcc build of the kernel library and
   each CUDA-graph capture of a sweep, and a "jit hit" is a replay of a
   captured graph.  A bucket recapturing more than N times per window is
   a recompile storm: a counter and a warning line.

3. **Batch occupancy** (`BatchOccupancy`): useful vs padded lanes for
   every fused batch, and singleflight-collapsed duplicates.

4. **Flight recorder and SLO tracker** (`FlightRecorder`): a bounded
   ring of per-window snapshots (phase-latency quantiles, queue depths,
   cache hit rates, the HBM ledger, occupancy) served at the authed
   `/debug/flight`, with a multi-window burn-rate evaluator over the
   configured latency/error SLOs, exported as
   `authz_slo_burn_rate{slo=,window=}` and surfaced in `/readyz` while
   burning.

Recording is a few dict and lock operations; window capture runs on its
own timer task.  The `DEVICE_TELEMETRY` switch (utils/features.py, the
reference's `DeviceTelemetry` gate) is the killswitch: it stops
recording, never a kernel.  Thread-safe: recording happens from asyncio
handlers and executor threads concurrently.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

from . import metrics as m

_log = logging.getLogger(__name__)

# occupancy = useful_lanes / (useful + padded); 1.0 = a full bucket
_OCCUPANCY_BUCKETS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8,
                      0.9, 0.95, 1.0)

# recompile-storm detection: more than this many compiles of ONE bucket
# inside the window is a storm (steady state compiles each bucket once)
STORM_WINDOW_S = 60.0
STORM_THRESHOLD = 3


def enabled() -> bool:
    """The DEVICE_TELEMETRY switch, read at each use."""
    from . import features
    return features.DEVICE_TELEMETRY is True


# -- 1. HBM ledger -----------------------------------------------------------


class HbmLedger:
    """Byte accounting of device buffers, keyed (generation, kind, name).

    `register` on an existing key replaces its size (delta-accounted), so
    re-registration after an in-place array swap is idempotent.
    `retire_generation` drops every buffer of a graph generation at once
    — the rebuild contract: after a rebuild the total must equal
    (old total − old generation + new generation), which the regression
    test in tests/test_devtel.py asserts byte-exactly."""

    def __init__(self, registry: Optional[m.Registry] = None):
        registry = registry or m.REGISTRY
        self._lock = threading.Lock()
        self._buffers: dict = {}   # (generation, kind, name) -> bytes
        self._by_kind: dict = {}   # kind -> bytes
        self._peak = 0
        # generations whose graphs were gc-collected, awaiting retirement
        # (see defer_retire); reaped under the lock by every public op
        self._dead_gens: collections.deque = collections.deque()
        self._gauge = registry.gauge(
            "authz_device_bytes",
            "Bytes of device buffers registered in the HBM ledger, by kind",
            labels=("kind",))
        registry.gauge(
            "authz_device_bytes_peak",
            "High-water mark of the HBM ledger total",
            callback=lambda: float(self.peak))
        # per-device shard accounting (sharded mesh tables/arenas): only
        # buffers registered with an explicit device= land here, so the
        # label cardinality is bounded by the local device count
        self._dev_gauge = registry.gauge(
            "authz_device_shard_bytes",
            "Bytes of device buffers by kind and owning device shard "
            "(populated by the sharded mesh path)",
            labels=("kind", "device"))
        self._by_dev: dict = {}    # (kind, device id) -> bytes
        self._buf_dev: dict = {}   # buffer key -> device id

    def defer_retire(self, generation: int) -> None:
        """Queue a generation for retirement WITHOUT taking any lock —
        the graph finalizers' entry point.  Finalizers run synchronously
        inside whatever gc a thread's allocation triggered, and that
        thread may already hold this ledger's (or the gauge's)
        non-reentrant lock — retiring inline would self-deadlock.
        deque.append is atomic; the queue is reaped under the lock by
        the next ledger operation."""
        self._dead_gens.append(generation)

    def _reap_locked(self) -> None:
        while True:
            try:
                gen = self._dead_gens.popleft()
            except IndexError:
                return
            self._retire_locked(gen)

    def _dev_delta_locked(self, kind: str, device: int, delta: int) -> None:
        k = (kind, int(device))
        self._by_dev[k] = self._by_dev.get(k, 0) + delta
        self._dev_gauge.set(self._by_dev[k], kind=kind, device=str(k[1]))

    def _retire_locked(self, generation: int) -> int:
        dead = [k for k in self._buffers if k[0] == generation]
        freed = 0
        for key in dead:
            nb = self._buffers.pop(key)
            freed += nb
            self._by_kind[key[1]] = self._by_kind.get(key[1], 0) - nb
            self._gauge.set(self._by_kind[key[1]], kind=key[1])
            dev = self._buf_dev.pop(key, None)
            if dev is not None:
                self._dev_delta_locked(key[1], dev, -nb)
        return freed

    def register(self, kind: str, nbytes: int, generation: int = 0,
                 name: str = "", device: Optional[int] = None) -> None:
        # the DeviceTelemetry gate covers ADDITIONS only: unregister and
        # retire_generation always run, so flipping the gate off never
        # strands entries the gauge can no longer shed
        if not enabled():
            return
        key = (generation, kind, name)
        with self._lock:
            self._reap_locked()
            old = self._buffers.get(key, 0)
            self._buffers[key] = int(nbytes)
            self._by_kind[kind] = self._by_kind.get(kind, 0) - old + int(nbytes)
            self._peak = max(self._peak, sum(self._by_kind.values()))
            self._gauge.set(self._by_kind[kind], kind=kind)
            # device attribution replaces like the byte count does: a
            # re-registration may move the buffer to another shard
            prev_dev = self._buf_dev.pop(key, None)
            if prev_dev is not None:
                self._dev_delta_locked(kind, prev_dev, -old)
            if device is not None:
                self._buf_dev[key] = int(device)
                self._dev_delta_locked(kind, device, int(nbytes))

    def unregister(self, kind: str, generation: int = 0,
                   name: str = "") -> int:
        key = (generation, kind, name)
        with self._lock:
            self._reap_locked()
            freed = self._buffers.pop(key, 0)
            if freed:
                self._by_kind[kind] = self._by_kind.get(kind, 0) - freed
                self._gauge.set(self._by_kind[kind], kind=kind)
            dev = self._buf_dev.pop(key, None)
            if dev is not None and freed:
                self._dev_delta_locked(kind, dev, -freed)
            return freed

    def retire_generation(self, generation: int) -> int:
        """Drop every buffer of one graph generation; returns bytes freed."""
        with self._lock:
            self._reap_locked()
            return self._retire_locked(generation)

    def total(self) -> int:
        with self._lock:
            self._reap_locked()
            return sum(self._by_kind.values())

    def generation_bytes(self, generation: int,
                         kind: Optional[str] = None) -> int:
        """Registered bytes under one generation, optionally narrowed to
        one kind — the generation-scoped view tests use so concurrent
        endpoints (the ledger is process-global) can't skew totals."""
        with self._lock:
            self._reap_locked()
            return sum(v for k, v in self._buffers.items()
                       if k[0] == generation
                       and (kind is None or k[1] == kind))

    def totals(self) -> dict:
        with self._lock:
            self._reap_locked()
            return {k: v for k, v in sorted(self._by_kind.items()) if v}

    @property
    def peak(self) -> int:
        with self._lock:
            return self._peak


# -- 2. kernel & compile accounting ------------------------------------------


class KernelAccounting:
    """Per-bucket device-time, graph-cache and recompile-storm counters.

    `note_kernel_span` is fed for every kernel span: host windows from
    tracing.kernel_span (kernel.launch, kernel.wait, ...) and the
    CUDA-event device window of each batch (kernel.device) through
    tracing.note_device_window, whether or not the request is traced.
    Kernel caches register themselves via `track` (weakly, so a dropped
    generation's cache never pins); the entries gauge sums their `_jits`
    (captured sweep graphs) at scrape."""

    def __init__(self, registry: Optional[m.Registry] = None):
        registry = registry or m.REGISTRY
        self._lock = threading.Lock()
        self._hits = registry.counter(
            "authz_jit_cache_hits_total",
            "Sweep-graph cache hits (replays of a captured CUDA graph), "
            "by batch bucket",
            labels=("bucket",))
        self._misses = registry.counter(
            "authz_jit_cache_misses_total",
            "Kernel compiles: CUDA-graph captures of a sweep, and the "
            "kernel library's build (bucket 0)",
            labels=("bucket",))
        self._storms = registry.counter(
            "authz_jit_cache_recompile_storms_total",
            "Buckets recompiling more than the storm threshold per window",
            labels=("bucket",))
        registry.gauge(
            "authz_jit_cache_entries",
            "Live captured sweep graphs across all kernel caches",
            callback=self._count_entries)
        self._kernel_time = registry.histogram(
            "authz_kernel_time_seconds",
            "Per-batch time by kernel span, verb kind and batch bucket "
            "(kernel.device: CUDA-event windows on the launch stream)",
            labels=("phase", "kind", "bucket"))
        # cumulative counters for snapshot() (the flight recorder's)
        self._tot_hits = 0
        self._tot_misses = 0
        self._tot_storms = 0
        self._time_by_bucket: dict = {}     # bucket -> seconds
        self._compiles: dict = {}   # (owner, bucket) -> deque[timestamps]
        self._caches: list = []             # weakrefs to tracked caches

    # -- jit cache bookkeeping ----------------------------------------------

    def track(self, cache) -> None:
        """Register a kernel cache (anything with a sized `_jits`) for the
        scrape-time entries gauge.  Weak: a rebuilt graph's dropped cache
        disappears from the count on its own."""
        import weakref
        with self._lock:
            self._caches = [r for r in self._caches if r() is not None]
            self._caches.append(weakref.ref(cache))

    def _count_entries(self) -> float:
        with self._lock:
            refs = list(self._caches)
        n = 0
        for r in refs:
            c = r()
            if c is not None:
                n += len(getattr(c, "_jits", ()))
        return float(n)

    def note_jit_hit(self, bucket: int) -> None:
        if not enabled():
            return
        self._hits.inc(bucket=str(bucket))
        with self._lock:
            self._tot_hits += 1

    def note_compile(self, bucket: int, now: Optional[float] = None,
                     owner: Optional[int] = None) -> None:
        """One compile of `bucket` (a sweep-graph capture); storms (more
        than STORM_THRESHOLD compiles of one bucket for one `owner` inside
        STORM_WINDOW_S) raise the storm counter and a slow-log line.
        `owner` is the version of what the graphs were captured for (the
        tables and plan of one kernel cache).  A new generation, another
        endpoint or a flush's new tables must recapture once, and that
        counts apart; what adds up to a storm is graphs of the same
        tables captured over and over (arenas dropped and made again)."""
        if not enabled():
            return
        self._misses.inc(bucket=str(bucket))
        now = time.monotonic() if now is None else now
        with self._lock:
            self._tot_misses += 1
            if len(self._compiles) > 256:
                # the windows of caches that stopped capturing
                self._compiles = {k: q for k, q in self._compiles.items()
                                  if q and q[-1] >= now - STORM_WINDOW_S}
            dq = self._compiles.setdefault((owner, bucket),
                                           collections.deque())
            dq.append(now)
            while dq and dq[0] < now - STORM_WINDOW_S:
                dq.popleft()
            storm = len(dq) == STORM_THRESHOLD + 1
            if storm:
                self._tot_storms += 1
        if storm:
            self._storms.inc(bucket=str(bucket))
            _log.warning(
                "recompile storm: bucket %d captured %d times in the "
                "last %.0fs for the same tables (threshold %d) — its sweep "
                "graphs keep being dropped", bucket, STORM_THRESHOLD + 1,
                STORM_WINDOW_S, STORM_THRESHOLD)

    # -- per-call device time ------------------------------------------------

    def note_kernel_span(self, name: str, attrs: dict,
                         seconds: float) -> None:
        if not enabled():
            return
        kind = str(attrs.get("kind", ""))
        bucket = attrs.get("bucket", "")
        self._kernel_time.observe(seconds, phase=name, kind=kind,
                                  bucket=str(bucket))
        if bucket != "":
            with self._lock:
                self._time_by_bucket[str(bucket)] = (
                    self._time_by_bucket.get(str(bucket), 0.0) + seconds)

    def snapshot(self) -> dict:
        with self._lock:
            return {"hits": self._tot_hits, "misses": self._tot_misses,
                    "storms": self._tot_storms,
                    "entries": int(self._count_entries_locked()),
                    "time_by_bucket_s": dict(self._time_by_bucket)}

    def _count_entries_locked(self) -> int:
        n = 0
        for r in self._caches:
            c = r()
            if c is not None:
                n += len(getattr(c, "_jits", ()))
        return n


# -- 3. batch occupancy ------------------------------------------------------


class BatchOccupancy:
    """Useful vs padded lanes per fused device batch, and singleflight-
    collapsed duplicates per dispatcher drain — the padding waste of the
    power-of-two lane buckets, measured."""

    def __init__(self, registry: Optional[m.Registry] = None):
        registry = registry or m.REGISTRY
        self._lock = threading.Lock()
        self._ratio = registry.histogram(
            "authz_batch_occupancy",
            "Useful-lane fraction of each fused device batch "
            "(1.0 = no padding)", labels=("kind",),
            buckets=_OCCUPANCY_BUCKETS)
        self._useful = registry.histogram(
            "authz_batch_useful_lanes",
            "Useful (non-padding) lanes per fused device batch",
            labels=("kind",), buckets=m._DEFAULT_SIZE_BUCKETS)
        self._padded = registry.histogram(
            "authz_batch_padded_lanes",
            "Padding lanes per fused device batch (bucket minus demand)",
            labels=("kind",), buckets=m._DEFAULT_SIZE_BUCKETS)
        self._collapsed = registry.histogram(
            "authz_batch_collapsed_duplicates",
            "Singleflight-collapsed duplicate queries per fused batch",
            buckets=m._DEFAULT_SIZE_BUCKETS)
        self._sums = {"batches": 0, "useful": 0, "padded": 0, "collapsed": 0}

    def record(self, kind: str, useful: int, padded: int) -> None:
        if not enabled():
            return
        lanes = useful + padded
        if lanes <= 0:
            return
        self._ratio.observe(useful / lanes, kind=kind)
        self._useful.observe(useful, kind=kind)
        self._padded.observe(padded, kind=kind)
        with self._lock:
            self._sums["batches"] += 1
            self._sums["useful"] += useful
            self._sums["padded"] += padded

    def note_collapsed(self, n: int) -> None:
        if not enabled():
            return
        self._collapsed.observe(n)
        with self._lock:
            self._sums["collapsed"] += n

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._sums)
        lanes = out["useful"] + out["padded"]
        out["mean"] = round(out["useful"] / lanes, 4) if lanes else None
        return out


# -- rebuild concurrency accounting ------------------------------------------


class RebuildAccounting:
    """Counts device-graph rebuilds by mode and exposes whether one is
    in flight right now — the observable difference between "a rebuild
    stalled this request" (sync) and "a rebuild ran in the background
    while requests kept serving" (background/preemptive).  Modes:
    sync (built under the endpoint lock), background (delta-forced,
    built off-lock), preemptive (spare-pool low-watermark, built
    off-lock before churn forces one)."""

    def __init__(self, registry: Optional[m.Registry] = None):
        registry = registry or m.REGISTRY
        self._lock = threading.Lock()
        self._counter = registry.counter(
            "authz_rebuilds_total",
            "Device-graph rebuilds by mode (sync = under the endpoint "
            "lock, background = delta-forced off-loop, preemptive = "
            "spare-pool low-watermark off-loop)",
            labels=("mode",))
        self._inflight = 0
        registry.gauge(
            "authz_rebuild_inflight",
            "Background device-graph rebuilds currently in flight",
            callback=lambda: float(self._inflight))
        self._totals: dict = {}

    def note_rebuild(self, mode: str) -> None:
        if not enabled():
            return
        self._counter.inc(mode=mode)
        with self._lock:
            self._totals[mode] = self._totals.get(mode, 0) + 1

    def note_inflight(self, delta: int) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight + delta)

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def snapshot(self) -> dict:
        with self._lock:
            return {"by_mode": dict(self._totals),
                    "inflight": self._inflight}


# -- device tensor bytes ------------------------------------------------------


def tensor_bytes(*tensors) -> int:
    """Bytes of the distinct storages behind `tensors` (None skipped):
    how the ledger counts a device tensor, so two views of one storage
    count once."""
    seen: set = set()
    total = 0
    for t in tensors:
        if t is None:
            continue
        st = t.untyped_storage()
        key = (str(t.device), st.data_ptr())
        if key not in seen:
            seen.add(key)
            total += int(st.nbytes())
    return total


class ArenaLedger:
    """Ledger registration of a kernel cache's pooled state arenas, one
    entry per lane bucket under the cache's graph generation
    (`devtel_generation`, set by the endpoint when it installs the
    generation).  The cache keeps `_arenas` (bucket -> arena) under
    `_arena_lock` and says which tensors an arena holds
    (`_arena_tensors`)."""

    devtel_generation = 0

    def _arena_tensors(self, arena) -> tuple:
        raise NotImplementedError

    def _ledger_arena(self, n_words: int, arena) -> None:
        gen = self.devtel_generation
        if gen:
            LEDGER.register("state_arena",
                            tensor_bytes(*self._arena_tensors(arena)),
                            generation=gen, name=f"arena:{n_words}")

    def _unledger_arena(self, n_words: int) -> None:
        gen = self.devtel_generation
        if gen:
            LEDGER.unregister("state_arena", generation=gen,
                              name=f"arena:{n_words}")

    def set_ledger_generation(self, gen: int) -> int:
        """Adopt graph generation `gen` and register the arenas pooled
        so far (a candidate prewarmed before its install allocated
        some); returns their bytes."""
        self.devtel_generation = gen
        with self._arena_lock:
            pooled = list(self._arenas.items())
        for n_words, arena in pooled:
            self._ledger_arena(n_words, arena)
        return sum(tensor_bytes(*self._arena_tensors(a)) for _, a in pooled)


# -- module singletons -------------------------------------------------------

LEDGER = HbmLedger()
KERNELS = KernelAccounting()
OCCUPANCY = BatchOccupancy()
REBUILDS = RebuildAccounting()

_gen_lock = threading.Lock()
_gen_counter = 0


def next_generation() -> int:
    """Process-globally unique graph generation for the HBM ledger —
    two coexisting endpoints must never share a generation key."""
    global _gen_counter
    with _gen_lock:
        _gen_counter += 1  # noqa: A004(id allocator; unique even gate-off)
        return _gen_counter


def note_kernel_span(name: str, attrs: dict, seconds: float) -> None:
    """Hook target for tracing.kernel_span (lazy-bound there)."""
    KERNELS.note_kernel_span(name, attrs, seconds)
    comp = attrs.get("workload")
    if comp:
        # same wall-clock seconds that feed authz_kernel_time_seconds —
        # /debug/workload reconciles against that cumulative sum by
        # construction (utils/workload.py splits by row share)
        from . import workload
        workload.note_device_time(comp, name, seconds)


# -- 4. flight recorder + SLO tracker ----------------------------------------


@dataclass(frozen=True)
class Slo:
    """One service-level objective.

    kind="latency": `threshold_s` is the latency target; `objective` is
    the allowed fraction of requests slower than it (the error budget).
    kind="error": `objective` is the allowed fraction of 5xx responses.
    Burn rate = (observed bad fraction) / objective — 1.0 consumes the
    budget exactly at the sustainable rate; see docs/observability.md
    for the worked example."""
    name: str
    kind: str                      # "latency" | "error"
    objective: float               # allowed bad fraction (error budget)
    threshold_s: Optional[float] = None


def _quantile_from_counts(buckets: tuple, counts: list,
                          q: float) -> Optional[float]:
    """Quantile estimate from histogram bucket counts (per-window
    deltas), linearly interpolated within the containing bucket."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    for i, ub in enumerate(buckets):
        prev_cum = cum
        cum += counts[i]
        if cum >= rank and counts[i]:
            lo = buckets[i - 1] if i else 0.0
            return lo + (ub - lo) * (rank - prev_cum) / counts[i]
    return buckets[-1]  # +Inf bucket: report the largest finite bound


def _delta_counts(cur: dict, prev: dict) -> dict:
    """Per-key bucket-count deltas of two Histogram.raw() snapshots."""
    out = {}
    for key, (counts, _s, _t) in cur.items():
        pcounts = prev.get(key, ([0] * len(counts), 0.0, 0))[0]
        out[key] = [c - p for c, p in zip(counts, pcounts)]
    return out


class FlightRecorder:
    """Bounded ring of per-window telemetry snapshots + SLO burn rates.

    Each window the recorder captures: per-phase latency quantiles (from
    the existing `authz_request_phase_seconds` deltas), HTTP request/
    error rates and latency quantiles, dispatcher queue depths (via
    `stats_fn`), decision-cache hit rate, the HBM ledger, occupancy, and
    graph-cache counters.  SLO burn rates are evaluated per window over a
    short (one-window) and long (`long_windows`-window) horizon and
    exported as `authz_slo_burn_rate{slo=,window=}`; `burning()` feeds
    `/readyz`.  Served (ring, newest first) at `/debug/flight`."""

    def __init__(self, window_s: float = 10.0, capacity: int = 64,
                 slos: Iterable[Slo] = (), long_windows: int = 12,
                 registry: Optional[m.Registry] = None,
                 stats_fn: Optional[Callable[[], dict]] = None):
        self.window_s = window_s
        self.capacity = capacity
        self.slos = tuple(slos)
        # the long horizon cannot outspan the ring it aggregates over —
        # a small --flight-windows must not silently promise 12 windows
        self.long_windows = max(2, min(long_windows, capacity))
        self._registry = registry or m.REGISTRY
        self._stats_fn = stats_fn
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._burn: dict = {}          # slo name -> {"short": x, "long": y}
        # http stats + SLO tallies fed by observe_request for PROXIED
        # requests only: health probes, /metrics scrapes, and /debug
        # reads must not dilute the latency/error picture (a kubelet
        # probing every few seconds would drown real API traffic in
        # sub-millisecond 200s), and SLO thresholds compare exactly at
        # observation time — no histogram-bucket snapping
        self._live: dict = {s.name: [0, 0] for s in self.slos}
        self._http_count = 0
        self._http_errors = 0
        self._http_lats: list = []     # bounded ring of window latencies
        # prime the delta baseline NOW: metrics are process-cumulative,
        # and diffing the first window against an empty baseline would
        # attribute the whole process history to window 1
        self._prev = self._read_raw()
        # previous capture instants: windows restrict their slow-trace
        # exemplars (wall clock) and dispatch-timeline summaries
        # (perf_counter, the timeline's clock) to the window they cover
        self._prev_wall = time.time()
        self._prev_mono = time.perf_counter()
        self._burn_gauge = self._registry.gauge(
            "authz_slo_burn_rate",
            "Error-budget burn rate per SLO and evaluation window "
            "(1.0 = consuming budget exactly at the sustainable rate)",
            labels=("slo", "window"))
        self._task = None

    # -- raw metric access ---------------------------------------------------

    def _raw_histogram(self, name: str) -> tuple:
        metric = self._registry.get(name)
        if isinstance(metric, m.Histogram):
            return metric.buckets, metric.raw()
        return (), {}

    def _raw_counter(self, name: str) -> dict:
        metric = self._registry.get(name)
        if isinstance(metric, m.Counter):
            return metric.snapshot()
        return {}

    # -- proxied-request intake ----------------------------------------------

    _LAT_RING = 2048  # per-window latency sample bound

    def observe_request(self, seconds: float, status: int) -> None:
        """One proxied request's contribution to the window's http stats
        and SLO tallies — the server calls this for traced (real API)
        requests only, so health probes and introspection scrapes never
        dilute the picture."""
        with self._lock:
            if len(self._http_lats) < self._LAT_RING:
                self._http_lats.append(seconds)
            else:
                # ring overwrite: bounded memory, recent-biased sample
                self._http_lats[self._http_count % self._LAT_RING] = seconds
            self._http_count += 1
            if status >= 500:
                self._http_errors += 1
            for slo in self.slos:
                tally = self._live[slo.name]
                tally[1] += 1
                if slo.kind == "latency":
                    if (slo.threshold_s is not None
                            and seconds > slo.threshold_s):
                        tally[0] += 1
                elif status >= 500:
                    tally[0] += 1

    def _drain_intake(self) -> tuple:
        """(http requests, errors, sorted latency sample, slo tallies)
        for the closing window; resets the accumulators."""
        with self._lock:
            http = (self._http_count, self._http_errors,
                    sorted(self._http_lats))
            tallies = {name: tuple(t) for name, t in self._live.items()}
            self._http_count = self._http_errors = 0
            self._http_lats = []
            self._live = {s.name: [0, 0] for s in self.slos}
        return http[0], http[1], http[2], tallies

    # -- capture -------------------------------------------------------------

    def _read_raw(self) -> dict:
        """Cumulative raw state of the delta-tracked metrics."""
        _buckets, phase_raw = self._raw_histogram(
            "authz_request_phase_seconds")
        return {
            "phase": phase_raw,
            "cache": (sum(self._raw_counter(
                          "authz_decision_cache_hits_total").values()),
                      sum(self._raw_counter(
                          "authz_decision_cache_misses_total").values())),
        }

    def capture(self, now: Optional[float] = None) -> dict:
        """Take one window snapshot (called by the timer task; tests and
        the smoke call it directly)."""
        now = time.time() if now is None else now
        phase_buckets, _ = self._raw_histogram("authz_request_phase_seconds")
        raw = self._read_raw()
        prev, self._prev = self._prev, raw
        window_start_wall, self._prev_wall = self._prev_wall, time.time()
        window_start_mono, self._prev_mono = (self._prev_mono,
                                              time.perf_counter())

        # per-window deltas (phase histograms only record traced
        # requests, so they carry no probe/scrape dilution)
        phase_delta = _delta_counts(raw["phase"], prev.get("phase", {}))
        p_hits, p_misses = prev.get("cache", (0, 0))
        d_hits = raw["cache"][0] - p_hits
        d_misses = raw["cache"][1] - p_misses
        requests, errors, lats, tallies = self._drain_intake()

        phases = {}
        for key, counts in phase_delta.items():
            n = sum(counts)
            if not n:
                continue
            name = key[0] if key else ""
            phases[name] = {
                "count": n,
                "p50_ms": _ms(_quantile_from_counts(phase_buckets, counts,
                                                    0.5)),
                "p99_ms": _ms(_quantile_from_counts(phase_buckets, counts,
                                                    0.99)),
            }

        snap = {
            "ts": round(now, 3),
            "window_s": self.window_s,
            "http": {
                "requests": requests,
                "errors": errors,
                "error_rate": round(errors / requests, 6) if requests else 0.0,
                "latency_p50_ms": _ms(_sample_quantile(lats, 0.5)),
                "latency_p99_ms": _ms(_sample_quantile(lats, 0.99)),
            },
            "phases": phases,
            "queues": self._queue_stats(),
            "cache": {
                "hits": d_hits, "misses": d_misses,
                "hit_rate": (round(d_hits / (d_hits + d_misses), 4)
                             if d_hits + d_misses else None)},
            "hbm": {"by_kind": LEDGER.totals(), "total": LEDGER.total(),
                    "peak": LEDGER.peak},
            "occupancy": OCCUPANCY.snapshot(),
            "jit": {k: v for k, v in KERNELS.snapshot().items()
                    if k != "time_by_bucket_s"},
            # window evidence links: the slowest traces that STARTED in
            # this window (ids resolve at /debug/traces) and the
            # dispatch-timeline condensate for the same interval
            # (slices at /debug/timeline) — a burning window names its
            # own stall without correlating three surfaces by hand
            "slow_traces": self._slow_trace_exemplars(window_start_wall),
            "timeline": self._timeline_summary(window_start_mono),
            # per-window (bad, total) tallies per SLO from
            # observe_request: the long-horizon burn aggregates these
            # over the ring
            "_slo_tallies": tallies,
        }
        snap["slo"] = self._evaluate_slos(snap)
        with self._lock:
            self._ring.append(snap)
        return snap

    def _slow_trace_exemplars(self, since_unix: float) -> list:
        """Top-K slow-trace exemplar refs for the closing window (lazy
        import: the recorder must stay usable with a stripped tree)."""
        try:
            from .tracing import RECORDER
            return RECORDER.exemplars(k=3, since_unix=since_unix)
        except Exception:
            return []

    def _timeline_summary(self, since_mono: float):
        """Dispatch-timeline condensate for the closing window (None
        when the Timeline gate is off or the module is unavailable)."""
        try:
            from . import timeline
            if not timeline.enabled():
                return None
            return timeline.summary(since=since_mono)
        except Exception:
            return None

    def _queue_stats(self) -> dict:
        if self._stats_fn is None:
            return {}
        try:
            stats = self._stats_fn() or {}
        except Exception:
            return {}
        return {k: stats[k] for k in
                ("check_queue_depth", "lr_queue_depth", "inflight_batch")
                if k in stats}

    def _evaluate_slos(self, snap: dict) -> dict:
        with self._lock:
            ring = list(self._ring)[-(self.long_windows - 1):]
        out = {}
        for slo in self.slos:
            bad, total = snap["_slo_tallies"][slo.name]
            short = (bad / total / slo.objective) if total else 0.0
            lbad, ltotal = bad, total
            for old in ring:
                ob, ot = old.get("_slo_tallies", {}).get(slo.name, (0, 0))
                lbad += ob
                ltotal += ot
            long = (lbad / ltotal / slo.objective) if ltotal else 0.0
            out[slo.name] = {"short": round(short, 4),
                             "long": round(long, 4),
                             "burning": short > 1.0 and long > 1.0}
            self._burn_gauge.set(short, slo=slo.name, window="short")
            self._burn_gauge.set(long, slo=slo.name, window="long")
        with self._lock:
            self._burn = out
        return out

    # -- serving -------------------------------------------------------------

    def snapshots(self) -> list:
        """Newest-first window list for /debug/flight (internal SLO
        tallies stripped)."""
        with self._lock:
            ring = list(self._ring)
        return [{k: v for k, v in s.items() if not k.startswith("_")}
                for s in reversed(ring)]

    def burning(self) -> list:
        """SLOs currently burning on BOTH horizons (short = a real spike,
        long = it has persisted), for /readyz."""
        with self._lock:
            burn = dict(self._burn)
        return [{"slo": name, **rates} for name, rates in sorted(burn.items())
                if rates.get("burning")]

    def describe_slos(self) -> list:
        return [{"name": s.name, "kind": s.kind, "objective": s.objective,
                 **({"threshold_ms": round(s.threshold_s * 1e3, 3)}
                    if s.threshold_s is not None else {})}
                for s in self.slos]

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        import asyncio
        if self._task is None or self._task.done():
            # re-prime at the start of the periodic cadence: traffic
            # served between construction and start() (embedded
            # handler-only use, warm-up requests) must not be billed to
            # the first timed window as a spurious one-window spike
            self._prev = self._read_raw()
            self._prev_wall = time.time()
            self._prev_mono = time.perf_counter()
            self._drain_intake()
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
        while True:
            await asyncio.sleep(self.window_s)
            try:
                self.capture()
            except Exception:
                _log.exception("flight-recorder capture failed")


def _ms(seconds: Optional[float]) -> Optional[float]:
    return round(seconds * 1e3, 3) if seconds is not None else None


def _sample_quantile(sorted_vals: list, q: float) -> Optional[float]:
    """Nearest-rank quantile of a sorted sample (None when empty)."""
    if not sorted_vals:
        return None
    import math
    return sorted_vals[max(0, math.ceil(q * len(sorted_vals)) - 1)]
