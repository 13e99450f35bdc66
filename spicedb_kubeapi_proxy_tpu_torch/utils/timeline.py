"""Dispatch timeline (the reference's utils/timeline.py, for the torch
port).

Metrics aggregate, tracing attributes per-request latency and devtel
snapshots per-window state; none of them measures concurrency in time:
whether batch N+1's encode overlaps batch N's readback, what bandwidth a
batch's sweeps reached against the card's memory rate, or which
wall-clock window a rebuild stalled.  This module is that instrument:

- **Event ring**: a bounded ring of monotonic-clock `TimelineEvent`s
  from every stage of the batch pipeline — host pack, the device window
  of a batch's sweeps (measured with CUDA events on the card), the
  readback, host extraction, rebuilds and compiles (sweep-graph captures
  and the kernel library's build) — each with the recording thread id,
  fused-batch id, lane bucket and bytes moved.  Device windows arrive
  through `utils/tracing` (kernel spans and `note_device_window`); host,
  dispatcher and rebuild stages record directly.

- **Derived telemetry** per dispatch: achieved bytes per second per
  stage (`authz_dispatch_bandwidth_bytes_per_sec{stage=}`), the kernel
  stage's bandwidth as a fraction of the card's memory rate
  (`authz_roofline_fraction`; `--device-hbm-peak-gbps`, else the
  detected card's rate), host-stall causes
  (`authz_dispatch_stall_seconds{cause=pack|transpose|transfer|rebuild|compile}`),
  and the transfer/compute overlap ratio — the fraction of readback
  wall time during which a different batch's kernel window was open
  (`authz_dispatch_overlap_ratio`).

- **Chrome trace export**: `chrome_trace()` renders the ring as
  trace-event JSON (Perfetto-loadable; `ph: X` slices on host /
  dispatcher / device / serving tracks, `ph: B/E` pairs on the rebuild
  track), served at the authed `/debug/timeline`.

- **Summaries**: `summary(since=)` condenses a window of the ring into
  {overlap ratio, roofline fraction, stall-cause breakdown, per-stage
  bandwidth, worst-dispatch exemplar}; the flight recorder embeds one
  per window.

The `TIMELINE` switch (utils/features.py, the reference's `Timeline`
gate) is the killswitch: off, `record` is one switch check and `span()`
returns a shared module-level null context.

Kernel-stage bytes are measured when the KERNEL_INTROSPECT switch is on:
the byte tag is the batch's executed sweeps times the modeled bytes of
one sweep (utils/workload.py).  Off, the tag is one sweep's modeled
bytes, a lower bound.  `summary()["kernel_bytes_basis"]` says which
basis (measured/modeled/mixed) a window's roofline number rests on.

Thread-safe: events are recorded from asyncio handlers and executor
threads concurrently.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Iterable, Optional

from . import metrics as m

# host-stall attribution: stage -> stall cause.  compact/warm_start are
# rebuild-family stalls (they hold the same endpoint lock a rebuild
# does); kernel/extract/dispatcher stages are not host stalls.
_STALL_CAUSE = {
    "pack": "pack",
    "transpose": "transpose",
    "transfer": "transfer",
    "rebuild": "rebuild",
    "compact": "rebuild",
    "warm_start": "rebuild",
    "compile": "compile",
}

# overlap accounting: transfer-side stages (host-visible result
# movement: the blocking D2H sync and the host word-transpose) vs
# compute-side stages (the host window holding a kernel execution).
# Prep stages (host query encode) are not data movement — they stay out
# of the overlap RATIO — but time they spend hidden behind a different
# batch's kernel window is still subtracted from stall attribution:
# host encode while the device is busy is not a stall.
_TRANSFER_STAGES = frozenset(("transfer", "transpose"))
_PREP_STAGES = frozenset(("pack",))
_COMPUTE_STAGES = frozenset(("kernel",))

# stages whose bytes/duration is a meaningful data-movement bandwidth;
# other byte-tagged events (e.g. rebuild's registered device footprint)
# keep their bytes in the event/chrome args but never set the gauge —
# "registered bytes / rebuild seconds" is not a bandwidth
_BANDWIDTH_STAGES = frozenset(("pack", "transpose", "transfer", "kernel"))

# serving-tier (non-kernel) stages: the full proxy path a request walks
# outside the dispatch/kernel machinery — authn, rule match, the
# upstream kube round-trip, list JSON decode, filter evaluation,
# re-serialization.  They land on their own "serving" track with the
# same event/overlap accounting the kernel stages get, and export as
# authz_serving_stage_seconds{stage=} (PAPER.md §7: the serving-shim
# escalation is only justified once these spans prove proxy overhead
# dominates).
_SERVING_STAGES = ("authn", "rule_match", "kube_upstream", "decode",
                   "filter", "serialize")

# chrome-trace track layout: one synthetic tid per named track (the
# real recording thread id rides in args.thread)
_TRACK_TIDS = {"host": 1, "dispatcher": 2, "device": 3, "rebuild": 4,
               "serving": 5}

# memory rates (GB/s) of the cards the port is measured on, by
# torch.cuda.get_device_name; `--device-hbm-peak-gbps` overrides.  An
# unknown card leaves the peak unset (bandwidth still exports, the
# roofline fraction reads 0 and summaries None).
_CARD_HBM_PEAK_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}

# tracing.kernel_span name -> timeline stage, as in the reference.  The
# port's endpoint feeds its batches' device windows as kernel.device,
# measured with CUDA events; kernel.dispatch keeps the reference's
# mapping for callers that time a blocking call on the host.  Spans may
# override the stage per call via attrs["timeline_stage"].
_KERNEL_SPAN_STAGES = {
    "kernel.device": "kernel",
    "kernel.dispatch": "kernel",
    "kernel.transfer": "transfer",
}


def enabled() -> bool:
    """The TIMELINE switch, read at each use."""
    from . import features
    return features.TIMELINE is True


def card_hbm_peak_gbps() -> float:
    """The memory rate of CUDA card 0 from `_CARD_HBM_PEAK_GBPS`, 0.0
    for an unknown card or when no card is visible."""
    try:
        import torch
        if not torch.cuda.is_available():
            return 0.0
        return _CARD_HBM_PEAK_GBPS.get(torch.cuda.get_device_name(0), 0.0)
    except Exception:
        return 0.0


def now() -> float:
    return time.perf_counter()


class TimelineEvent:
    __slots__ = ("stage", "track", "start", "end", "thread", "batch",
                 "bucket", "nbytes", "attrs")

    def __init__(self, stage: str, track: str, start: float, end: float,
                 thread: int, batch: Optional[int], bucket: Optional[int],
                 nbytes: int, attrs: Optional[dict]):
        self.stage = stage
        self.track = track
        self.start = start
        self.end = end
        self.thread = thread
        self.batch = batch
        self.bucket = bucket
        self.nbytes = nbytes
        self.attrs = attrs

    @property
    def duration(self) -> float:
        return self.end - self.start


def _merged_length(segs: list) -> float:
    """Total length of a union of (lo, hi) intervals."""
    if not segs:
        return 0.0
    segs.sort()
    total = 0.0
    cur_lo, cur_hi = segs[0]
    for lo, hi in segs[1:]:
        if lo > cur_hi:
            total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    return total + (cur_hi - cur_lo)


def overlap_stats(events: Iterable[TimelineEvent]) -> Optional[dict]:
    """Transfer/compute overlap over a set of events: the fraction of
    transfer-stage wall time during which a compute-stage interval of a
    DIFFERENT fused batch was open.  None when no transfer time exists
    (nothing to overlap).  This is ROADMAP item 1's before/after
    number: a serialized pipeline scores ~0; batch N+1's kernel hiding
    batch N's transfer scores toward 1.

    Cost matters: this runs on the event loop (flight-recorder window
    capture, /debug/timeline).  Computes are sorted once and each
    transfer bisects to its temporal neighborhood (a compute starting
    more than the longest compute duration before the transfer cannot
    overlap it), so a full 4096-event ring stays O((T+C)·log C + local
    candidates) instead of T×C interval checks."""
    import bisect
    transfers = []
    computes = []
    preps = []
    for e in events:
        if e.end <= e.start:
            continue
        if e.stage in _TRANSFER_STAGES:
            transfers.append(e)
        elif e.stage in _PREP_STAGES:
            preps.append(e)
        elif e.stage in _COMPUTE_STAGES:
            computes.append(e)
    total = sum(e.duration for e in transfers)
    if total <= 0.0:
        return None
    computes.sort(key=lambda c: c.start)
    starts = [c.start for c in computes]
    max_dur = max((c.duration for c in computes), default=0.0)
    overlap = 0.0
    hidden: dict = {}  # transfer/prep stage -> seconds PROVABLY hidden
    for t in transfers + preps:
        is_transfer = t.stage in _TRANSFER_STAGES
        segs = []
        segs_strict = []
        lo_bound = t.start - max_dur
        i = bisect.bisect_left(starts, t.end) - 1  # last start < t.end
        while i >= 0 and computes[i].start >= lo_bound:
            c = computes[i]
            i -= 1
            if (c.batch is not None and c.batch == t.batch):
                continue  # same dispatch: that is serialization, not overlap
            lo, hi = max(t.start, c.start), min(t.end, c.end)
            if hi > lo:
                segs.append((lo, hi))
                # strict variant feeding the stall subtraction: only
                # intervals PROVABLY from a different fused batch (both
                # sides tagged) count as hiding — untagged events keep
                # raw stall semantics
                if c.batch is not None and t.batch is not None:
                    segs_strict.append((lo, hi))
        if is_transfer:
            overlap += _merged_length(segs)
        if segs_strict:
            hidden[t.stage] = (hidden.get(t.stage, 0.0)
                               + _merged_length(segs_strict))
    return {
        "transfer_s": round(total, 6),
        "overlap_s": round(overlap, 6),
        "ratio": round(overlap / total, 4),
        "transfers": len(transfers),
        "computes": len(computes),
        # per-stage seconds hidden behind a different batch's kernel
        # window (summary() subtracts these from the pack/transpose/
        # transfer stall causes: a hidden transfer or host encode is
        # not a stall — the device never went idle for it)
        "hidden_s_by_stage": {s: round(v, 6)
                              for s, v in sorted(hidden.items())},
    }


class _NullSpan:
    """Shared no-op context manager returned by span() when the gate is
    off (tests assert the span object's identity — no per-call span or
    generator allocation).  __enter__ yields a FRESH scratch dict: the
    span() contract lets callers enrich the yielded dict, and handing
    every gated-off call site one shared dict would leak enrichments
    across unrelated spans process-wide."""
    __slots__ = ()

    def __enter__(self):
        return {}

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tl", "stage", "track", "kw", "t0")

    def __init__(self, tl: "Timeline", stage: str, track: str, kw: dict):
        self._tl = tl
        self.stage = stage
        self.track = track
        self.kw = kw

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self.kw  # callers may enrich (nbytes discovered inside)

    def __exit__(self, *exc):
        self._tl.record(self.stage, self.track, self.t0, **self.kw)
        return False


_trace_current = None  # resolved lazily; False => tracing unavailable


def _note_trace_span(stage: str, start: float, end: float) -> None:
    """Mirror a serving-stage span into the active request trace (as a
    forensic `serving.<stage>` span, never a phase — the phases already
    tile the wall time).  This is what lets the fleet merge attribute
    serving stages per tier: the timeline ring is process-wide, but the
    trace travels with the request.  Lazy-bound, same discipline as the
    tracing->timeline hook in the other direction."""
    global _trace_current
    if _trace_current is None:
        try:
            from .tracing import current_trace
            _trace_current = current_trace  # noqa: A004(import cache, not gated state)
        except Exception:
            _trace_current = False  # noqa: A004(import cache, not gated state)
    if _trace_current:
        tr = _trace_current()
        if tr is not None:
            try:
                tr.add_span("serving." + stage, start, end)
            except Exception:  # pragma: no cover - defensive
                pass


class _ServingSpan(_Span):  # noqa: A004(built behind gate)
    """Serving-track span: records the timeline event, feeds the
    per-stage serving histogram, and mirrors into the request trace in
    one exit."""
    __slots__ = ()

    def __exit__(self, *exc):
        end = time.perf_counter()
        self._tl.record(self.stage, self.track, self.t0, end, **self.kw)
        self._tl._serving.observe(end - self.t0, stage=self.stage)
        _note_trace_span(self.stage, self.t0, end)
        return False


class Timeline:
    """Bounded event ring + derived dispatch telemetry (module singleton
    `TIMELINE`; an isolated instance is constructible for tests)."""

    def __init__(self, capacity: int = 4096,
                 registry: Optional[m.Registry] = None,
                 hbm_peak_gbps: Optional[float] = None):
        registry = registry or m.REGISTRY
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        # wall/monotonic epoch pair: chrome-trace ts are µs since this
        # epoch; start_unix in summaries maps back to wall clock
        self.epoch_mono = time.perf_counter()
        self.epoch_wall = time.time()
        # lock-free batch-id source (itertools.count.__next__ is atomic
        # in CPython): next_batch() must stay cheap and contention-free
        # even with the gate off — it runs once per dispatch
        import itertools
        self._batch_seq = itertools.count(1)
        self._hbm_peak_gbps = hbm_peak_gbps  # None => detect lazily
        self._hbm_peak_detected: Optional[float] = None
        # card detection is armed only once a device-track event exists:
        # summary()/scrapes on a server that never ran a kernel
        # (embedded://) must not initialize CUDA
        self._device_seen = False
        # cumulative counters (snapshot()/diff for bench artifacts)
        self._stall_s: dict = {}
        self._bytes_by_stage: dict = {}
        self._events_total = 0
        self._stall = registry.counter(
            "authz_dispatch_stall_seconds",
            "Host wall time stalled per dispatch-pipeline cause "
            "(pack, transpose, transfer, rebuild, compile)",
            labels=("cause",))
        self._bw = registry.gauge(
            "authz_dispatch_bandwidth_bytes_per_sec",
            "Achieved bytes/sec of the most recent dispatch-pipeline "
            "event per stage (kernel bytes are measured iterations x "
            "one-sweep traffic with KernelIntrospect on, else a "
            "modeled one-sweep lower bound)",
            labels=("stage",))
        self._roofline = registry.gauge(
            "authz_roofline_fraction",
            "Most recent kernel dispatch's achieved HBM bandwidth as a "
            "fraction of the configured device peak (byte basis: "
            "measured sweep telemetry when KernelIntrospect is on, else "
            "modeled one-sweep floor; 0 = peak unknown or no dispatch)")
        registry.gauge(
            "authz_dispatch_overlap_ratio",
            "Transfer/compute overlap ratio over the recent timeline "
            "ring (0 = fully serialized pipeline, ~1 = transfers hidden "
            "behind another batch's kernel)",
            callback=self._overlap_gauge)
        self._serving = registry.histogram(
            "authz_serving_stage_seconds",
            "Serving-tier (non-kernel) stage latency: authn, rule_match, "
            "kube_upstream, decode, filter, serialize (docs/"
            "observability.md 'Fleet tracing')",
            labels=("stage",))

    # -- configuration -------------------------------------------------------

    def set_hbm_peak(self, gbps: Optional[float]) -> None:
        """Override the card's memory rate (GB/s); None/0 restores the
        detection."""
        self._hbm_peak_gbps = gbps if gbps else None

    def hbm_peak_bytes_per_s(self) -> float:
        """Configured or detected peak in bytes/s; 0.0 when unknown
        (the roofline fraction then reads 0 rather than inventing a
        denominator)."""
        if self._hbm_peak_gbps:
            return self._hbm_peak_gbps * 1e9
        if not self._device_seen:
            # no device-track event yet: a server that never ran a kernel
            # must not initialize CUDA for a scrape
            return 0.0
        if self._hbm_peak_detected is None:
            self._hbm_peak_detected = card_hbm_peak_gbps()
        return self._hbm_peak_detected * 1e9

    # -- recording -----------------------------------------------------------

    def next_batch(self) -> int:
        """Process-unique fused-batch id tying one dispatch's events
        together across host/dispatcher/device tracks (lock-free: runs
        once per dispatch whether or not the gate is on)."""
        return next(self._batch_seq)

    def record(self, stage: str, track: str, start: float,
               end: Optional[float] = None, batch: Optional[int] = None,
               bucket: Optional[int] = None, nbytes: int = 0,
               **attrs) -> None:
        """Record one closed interval; no-op when the gate is off."""
        if not enabled():
            return
        end = time.perf_counter() if end is None else end
        ev = TimelineEvent(stage, track, start, end,
                           threading.get_ident(), batch, bucket,
                           int(nbytes), attrs or None)
        dur = ev.duration
        cause = _STALL_CAUSE.get(stage)
        with self._lock:
            if track == "device":
                self._device_seen = True
            if stage in _COMPUTE_STAGES and self._compile_overlaps(start):
                # a bucket's first batch captures its sweep graphs INSIDE
                # the kernel window: the compile slice (already in the
                # ring — it closed before this window did) names the
                # stall, and this kernel event must not feed
                # bandwidth/roofline with a capture-inflated duration
                ev.attrs = dict(ev.attrs or {})
                ev.attrs["compile"] = True
            self._ring.append(ev)
            self._events_total += 1
            if nbytes:
                self._bytes_by_stage[stage] = (
                    self._bytes_by_stage.get(stage, 0) + int(nbytes))
            if cause is not None and dur > 0:
                self._stall_s[cause] = self._stall_s.get(cause, 0.0) + dur
        if cause is not None and dur > 0:
            self._stall.inc(dur, cause=cause)
        if (nbytes and dur > 0 and stage in _BANDWIDTH_STAGES
                and not (ev.attrs and ev.attrs.get("compile"))):
            bw = nbytes / dur
            self._bw.set(bw, stage=stage)
            if stage in _COMPUTE_STAGES:
                peak = self.hbm_peak_bytes_per_s()
                self._roofline.set(bw / peak if peak else 0.0)

    def _compile_overlaps(self, start: float) -> bool:
        """True when a recently recorded compile slice overlaps a span
        that began at `start` (bounded backward scan, under the lock)."""
        checked = 0
        for prev in reversed(self._ring):
            if prev.stage == "compile" and prev.end >= start:
                return True
            checked += 1
            if checked >= 64:
                return False
        return False

    def span(self, stage: str, track: str, **kw):
        """Context manager recording the enclosed block; yields the
        keyword dict so callers can enrich it (e.g. set nbytes once the
        transfer size is known) before the span closes.  Returns a
        shared null context when the gate is off."""
        if not enabled():
            return _NULL_SPAN
        return _Span(self, stage, track, kw)

    def serving_span(self, stage: str, **kw):
        """Span on the serving track (authn, rule_match, kube_upstream,
        decode, filter, serialize): the timeline event rides the normal
        ring/chrome-trace machinery AND the duration feeds the
        authz_serving_stage_seconds{stage=} histogram.  Same gate-off
        contract as span(): the shared null context, nothing ticks."""
        if not enabled():
            return _NULL_SPAN
        return _ServingSpan(self, stage, "serving", kw)

    # -- views ---------------------------------------------------------------

    def events(self, since: Optional[float] = None) -> list:
        """Events (oldest first) whose END is at/after `since`
        (monotonic); all retained events when None."""
        with self._lock:
            evs = list(self._ring)
        if since is None:
            return evs
        return [e for e in evs if e.end >= since]

    def _overlap_gauge(self) -> float:
        evs = self.events()
        st = overlap_stats(evs[-256:])  # bound scrape-time cost
        return st["ratio"] if st else 0.0

    def snapshot(self) -> dict:
        """Cumulative counters (process lifetime) — bench configs diff
        two of these; the ring-derived views live in summary()."""
        with self._lock:
            return {"events_total": self._events_total,
                    "stall_s": dict(self._stall_s),
                    "bytes_by_stage": dict(self._bytes_by_stage)}

    def summary(self, since: Optional[float] = None) -> dict:
        """Condense the (optionally window-restricted) ring: overlap
        ratio, per-stage bandwidth, modeled roofline fraction,
        stall-cause breakdown, and the worst-dispatch exemplar."""
        evs = self.events(since)
        by_stage: dict = {}   # stage -> [seconds, bytes, count]
        bw_agg: dict = {}     # bandwidth-stage -> [seconds, bytes]
        by_batch: dict = {}   # batch -> {stage: seconds}
        stalls: dict = {}
        basis_bytes = [0, 0]  # [measured, modeled] kernel bytes
        for e in evs:
            agg = by_stage.setdefault(e.stage, [0.0, 0, 0])
            agg[0] += e.duration
            agg[1] += e.nbytes
            agg[2] += 1
            # bandwidth aggregation excludes compile-contaminated kernel
            # windows (the adjacent compile slice carries that stall)
            # and non-movement byte tags like rebuild's footprint
            if (e.stage in _BANDWIDTH_STAGES and e.nbytes
                    and not (e.attrs and e.attrs.get("compile"))):
                b = bw_agg.setdefault(e.stage, [0.0, 0])
                b[0] += e.duration
                b[1] += e.nbytes
                if e.stage in _COMPUTE_STAGES:
                    if e.attrs and e.attrs.get("measured"):
                        basis_bytes[0] += e.nbytes
                    else:
                        basis_bytes[1] += e.nbytes
            cause = _STALL_CAUSE.get(e.stage)
            if cause is not None:
                stalls[cause] = stalls.get(cause, 0.0) + e.duration
            if e.batch is not None:
                by_batch.setdefault(e.batch, {})[e.stage] = (
                    by_batch.get(e.batch, {}).get(e.stage, 0.0) + e.duration)
        bandwidth = {
            stage: round(nbytes / secs, 1)
            for stage, (secs, nbytes) in sorted(bw_agg.items())
            if nbytes and secs > 0}
        k_secs = sum(bw_agg.get(s, [0.0, 0])[0] for s in _COMPUTE_STAGES)
        k_bytes = sum(bw_agg.get(s, [0.0, 0])[1] for s in _COMPUTE_STAGES)
        peak = self.hbm_peak_bytes_per_s()
        # 12-digit rounding: fractions can legitimately sit at 1e-7
        # scale (CPU backend, modeled lower bound) and must not read 0.0
        roofline = (round(k_bytes / k_secs / peak, 12)
                    if k_secs > 0 and k_bytes and peak else None)
        # roofline honesty label: "measured" when every kernel byte tag
        # came from sweep telemetry (iterations x per-sweep bytes),
        # "modeled" when all are the one-sweep lower bound (gate off,
        # sharded path, or pre-readback), "mixed" otherwise
        if basis_bytes[0] and basis_bytes[1]:
            bytes_basis = "mixed"
        elif basis_bytes[0]:
            bytes_basis = "measured"
        elif basis_bytes[1]:
            bytes_basis = "modeled"
        else:
            bytes_basis = None
        worst = None
        if by_batch:
            wid, stages = max(by_batch.items(),
                              key=lambda kv: sum(kv[1].values()))
            worst = {"batch": wid,
                     "total_ms": round(sum(stages.values()) * 1e3, 3),
                     "stages_ms": {s: round(v * 1e3, 3)
                                   for s, v in sorted(stages.items())}}
        ov = overlap_stats(evs)
        if ov:
            # overlap-aware stall attribution (device-resident
            # pipeline): transfer/transpose wall time hidden behind a
            # DIFFERENT batch's kernel window is not a stall — the
            # device never went idle for it.  The cumulative
            # authz_dispatch_stall_seconds counter stays raw wall time
            # (it is incremented at record time, before any overlap is
            # knowable); this window condensate is the judgment number.
            for stage, hid in ov["hidden_s_by_stage"].items():
                cause = _STALL_CAUSE.get(stage)
                if cause in stalls:
                    stalls[cause] = max(0.0, stalls[cause] - hid)
        return {
            "events": len(evs),
            "dispatches": len(by_batch),
            "overlap": ov,
            "overlap_ratio": ov["ratio"] if ov else None,
            "roofline_fraction": roofline,
            "kernel_bytes_basis": bytes_basis,
            "hbm_peak_gbps": round(peak / 1e9, 1) if peak else None,
            "bandwidth_bytes_per_s": bandwidth,
            "stall_s": {c: round(v, 6) for c, v in sorted(stalls.items())},
            "stage_ms": {s: round(a[0] * 1e3, 3)
                         for s, a in sorted(by_stage.items())},
            "worst_dispatch": worst,
        }

    def chrome_trace(self, since: Optional[float] = None) -> dict:
        """Chrome trace-event JSON of the ring (Perfetto-loadable):
        `M` metadata names the process and one row per track, pipeline
        stages are `X` complete slices, rebuild-track spans are `B`/`E`
        pairs (they nest warm-start inside recovery cleanly).  `ts` is
        µs since the timeline epoch; args carry the recording thread,
        fused-batch id, lane bucket, and bytes moved."""
        evs = self.events(since)
        pid = 1
        out = [{"name": "process_name", "ph": "M", "ts": 0, "pid": pid,
                "tid": 0, "args": {"name": "spicedb-kubeapi-proxy-tpu"}}]
        for track, tid in _TRACK_TIDS.items():
            out.append({"name": "thread_name", "ph": "M", "ts": 0,
                        "pid": pid, "tid": tid, "args": {"name": track}})
        for e in evs:
            tid = _TRACK_TIDS.get(e.track, 0)
            ts = (e.start - self.epoch_mono) * 1e6
            dur = max(e.duration, 0.0) * 1e6
            args = {"thread": e.thread}
            if e.batch is not None:
                args["batch"] = e.batch
            if e.bucket is not None:
                args["bucket"] = e.bucket
            if e.nbytes:
                args["bytes"] = e.nbytes
            if e.attrs:
                args.update(e.attrs)
            if e.track == "rebuild":
                out.append({"name": e.stage, "cat": e.track, "ph": "B",
                            "ts": round(ts, 3), "pid": pid, "tid": tid,
                            "args": args})
                out.append({"name": e.stage, "cat": e.track, "ph": "E",
                            "ts": round(ts + dur, 3), "pid": pid,
                            "tid": tid})
            else:
                out.append({"name": e.stage, "cat": e.track, "ph": "X",
                            "ts": round(ts, 3), "dur": round(dur, 3),
                            "pid": pid, "tid": tid, "args": args})
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {
                "epoch_unix": round(self.epoch_wall, 6),
                "capacity": self.capacity,
                "summary": self.summary(since),
            },
        }


# -- module singleton + delegates ---------------------------------------------

TIMELINE = Timeline()


def set_hbm_peak(gbps: Optional[float]) -> None:
    TIMELINE.set_hbm_peak(gbps)


def next_batch() -> int:
    return TIMELINE.next_batch()


def record(stage: str, track: str, start: float,
           end: Optional[float] = None, **kw) -> None:
    TIMELINE.record(stage, track, start, end, **kw)


def span(stage: str, track: str, **kw):
    return TIMELINE.span(stage, track, **kw)


def serving_span(stage: str, **kw):
    return TIMELINE.serving_span(stage, **kw)


def summary(since: Optional[float] = None) -> dict:
    return TIMELINE.summary(since)


def snapshot() -> dict:
    return TIMELINE.snapshot()


def chrome_trace(since: Optional[float] = None) -> dict:
    return TIMELINE.chrome_trace(since)


def note_kernel_span(name: str, attrs: dict, start: float,
                     end: float) -> None:
    """Hook target for tracing.kernel_span (lazy-bound there): device
    kernel spans land on the timeline's device track without the
    endpoint emitting them twice.  Callers may override the stage per
    call via attrs['timeline_stage']."""
    stage = attrs.get("timeline_stage") or _KERNEL_SPAN_STAGES.get(name)
    if stage is None:
        return
    extra = {}
    if attrs.get("measured"):
        # byte tag upgraded from the modeled one-sweep floor to measured
        # iterations x per-sweep bytes (KernelIntrospect sweep telemetry)
        extra["measured"] = True
    TIMELINE.record(stage, "device", start, end,
                    batch=attrs.get("batch_id"),
                    bucket=attrs.get("bucket") or None,
                    nbytes=int(attrs.get("nbytes", 0) or 0), **extra)
