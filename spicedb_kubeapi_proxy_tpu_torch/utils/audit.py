"""Structured authorization decision audit log (kube audit-policy analog;
reference utils/audit.py).

Request traces (utils/tracing.py) make wall time attributable; this
module makes *decisions* attributable: every authorization decision the proxy takes —
check pass/fail, prefilter object groups, watch grants/revocations,
post-checks, dual-write commit/rollback — emits a structured `AuditEvent`
carrying user, groups, verb, GVR, object name(s), the matched rule id,
the backend that evaluated it, the decision, the caveat context, the
trace id (correlating with the request trace), and latency.

Hot-path contract:

- `emit()` NEVER blocks and NEVER raises: the sink is a bounded deque +
  ring buffer; when the writer lags, the new event is dropped and
  `authz_audit_dropped_total{reason="backpressure"}` counts it.
- Level policy mirrors the kube audit stages: `None` (disabled — check
  `sink.enabled` before even building an event), `Metadata` (identity +
  decision, no relationship strings or caveat context), `Request`
  (full event incl. rel strings, caveat context, explain witness).
- Per-user+verb sampling: ALLOWED decisions are sampled 1-in-N per
  (user, verb) key; denials and errors always pass (an audit log that
  samples away denials cannot answer "why was this denied").
- Identities (usernames, object names) live in EVENTS, never in metric
  labels.

The ring buffer is read with `AuditSink.recent()`; the async writer task (started with the server) renders events as one JSON
line each through a pluggable writer (default: the audit logger).

Thread-safe: decisions are emitted from asyncio handlers and executor
threads concurrently.
"""

from __future__ import annotations

import asyncio
import collections
import json
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

logger = logging.getLogger("spicedb_kubeapi_proxy_tpu_torch.audit")

# -- decision outcome enum ---------------------------------------------------
# The single vocabulary shared by request-context (`authz_outcome`),
# metrics, trace attrs, and audit events, so the three surfaces join by
# trace id without value translation (previously `always_allow` vs
# `allowed` vs missing-on-error drifted per surface).

OUTCOME_ALLOWED = "allowed"
OUTCOME_DENIED = "denied"
OUTCOME_ALWAYS_ALLOW = "always_allow"
OUTCOME_CONDITIONAL = "conditional"
OUTCOME_ERROR = "error"
# admission control rejected the request before/while authorizing (429 +
# Retry-After; utils/admission.py) — distinct from `denied` (a policy
# decision) and `error` (a failure): the request was never evaluated
OUTCOME_SHED = "shed"

OUTCOMES = frozenset((OUTCOME_ALLOWED, OUTCOME_DENIED, OUTCOME_ALWAYS_ALLOW,
                      OUTCOME_CONDITIONAL, OUTCOME_ERROR, OUTCOME_SHED))


def normalize_outcome(raw: Optional[str]) -> str:
    """Collapse a context outcome value into the shared enum: unknown or
    missing values (error paths that never set one) become `error`."""
    return raw if raw in OUTCOMES else OUTCOME_ERROR


# -- audit levels ------------------------------------------------------------

LEVEL_NONE = "None"
LEVEL_METADATA = "Metadata"
LEVEL_REQUEST = "Request"

_LEVELS = {LEVEL_NONE: 0, LEVEL_METADATA: 1, LEVEL_REQUEST: 2}


def parse_level(raw: str) -> str:
    """Case-insensitive level parse; raises ValueError on unknown names."""
    for name in _LEVELS:
        if raw.strip().lower() == name.lower():
            return name
    raise ValueError(
        f"unknown audit level {raw!r}; expected one of {sorted(_LEVELS)}")


# bound the per-event identity payload: one event per object-GROUP, with
# a name sample, never one event per object (a 10k-pod list emits 2)
MAX_NAMES_PER_EVENT = 8
# sampling state is keyed (user, verb); cap the key space so an attacker
# minting usernames cannot grow sink memory without bound
_SAMPLE_STATE_CAP = 8192


@dataclass
class AuditEvent:
    """One authorization decision (or one decision group)."""
    stage: str                    # resolve|match|check|postcheck|postfilter|
    #                               respfilter|watch|update|dualwrite
    decision: str                 # OUTCOME_* enum value
    user: str = ""
    groups: tuple = ()
    verb: str = ""
    api_group: str = ""
    api_version: str = ""
    resource: str = ""
    namespace: str = ""
    names: tuple = ()             # object name(s) the decision covers
    count: int = 0                # group size when > len(names) sampled
    rule: str = ""                # matched ProxyRule name
    backend: str = ""             # torch | embedded
    # which evaluator produced the decision: cache (decision cache hit) |
    # kernel (device) | oracle (host evaluator) | mixed; "" when the
    # backend doesn't attribute.  Keeps audit truthful when the decision
    # cache answers without touching the evaluator at all.
    decision_source: str = ""
    trace_id: str = ""
    latency_ms: float = 0.0
    # Request-level payload (dropped at Metadata)
    rel: str = ""                 # the checked relationship string
    caveat_context: Optional[dict] = None
    explain: Optional[dict] = None  # witness dict (authz/explain.py)
    message: str = ""
    ts: float = field(default_factory=time.time)

    def to_dict(self, level: str = LEVEL_REQUEST) -> dict:
        d = {"ts": round(self.ts, 6), "stage": self.stage,
             "decision": self.decision, "user": self.user,
             "groups": list(self.groups), "verb": self.verb,
             "gvr": "/".join((self.api_group, self.api_version,
                              self.resource)),
             "namespace": self.namespace, "names": list(self.names),
             "count": self.count or len(self.names), "rule": self.rule,
             "backend": self.backend, "trace_id": self.trace_id,
             "latency_ms": round(self.latency_ms, 3)}
        if self.decision_source:
            d["decision_source"] = self.decision_source
        if self.explain is not None:
            # witnesses are explicitly requested (--audit-explain or
            # ?explain=1): render them at any level that emits at all
            d["explain"] = self.explain
        if _LEVELS.get(level, 0) >= _LEVELS[LEVEL_REQUEST]:
            if self.rel:
                d["rel"] = self.rel
            if self.caveat_context is not None:
                d["caveat_context"] = self.caveat_context
            if self.message:
                d["message"] = self.message
        return d


def _log_writer(line: str) -> None:
    logger.info("%s", line)


class AuditSink:
    """Bounded, non-blocking decision sink.

    emit() appends to a ring buffer (read by `recent()`) and to a
    bounded writer deque; a writer task started with the server drains
    the deque into one-JSON-line-per-event output.  Backpressure NEVER
    propagates to the caller: a full deque drops the event and counts it.
    """

    def __init__(self, level: str = LEVEL_METADATA, capacity: int = 1024,
                 ring_capacity: int = 256, sample_every: int = 1,
                 explain: bool = False, backend: str = "",
                 writer: Optional[Callable[[str], None]] = None,
                 registry=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if sample_every < 1:
            raise ValueError(
                f"sample_every must be >= 1, got {sample_every}")
        self.level = parse_level(level)
        self.capacity = capacity
        self.ring_capacity = ring_capacity
        self.sample_every = sample_every
        # explained denials: decision sites attach the relation-path
        # witness when this is on (or the request carries ?explain=1)
        self.explain = explain
        # default `backend` for events built from this sink (the
        # endpoint's URL-scheme label: torch | embedded)
        self.backend = backend
        self._writer = writer or _log_writer
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=ring_capacity)
        self._queue: collections.deque = collections.deque()
        self._sample_counts: dict = {}
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        if registry is None:
            from . import metrics as m
            registry = m.REGISTRY
        self.emitted_total = registry.counter(
            "authz_audit_events_total",
            "Authorization audit events emitted, by stage and decision",
            labels=("stage", "decision"))
        self.dropped_total = registry.counter(
            "authz_audit_dropped_total",
            "Audit events dropped before reaching the sink, by reason "
            "(level: auditing disabled; sampled: per-user+verb sampling; "
            "backpressure: writer deque full)",
            labels=("reason",))

    # -- hot path ------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        """False at level None: decision sites skip event construction
        entirely)."""
        return self.level != LEVEL_NONE

    def _sampled_out(self, event: AuditEvent) -> bool:
        """1-in-N per (user, verb) for ALLOWED decisions only; denials,
        errors, and conditionals always pass."""
        if self.sample_every <= 1 or event.decision != OUTCOME_ALLOWED:
            return False
        key = (event.user, event.verb)
        with self._lock:
            if len(self._sample_counts) >= _SAMPLE_STATE_CAP:
                # bounded sampling state: reset rather than grow (a reset
                # re-emits one event per key, never silences one)
                self._sample_counts.clear()
            n = self._sample_counts.get(key, 0)
            self._sample_counts[key] = n + 1
        return n % self.sample_every != 0

    def emit(self, event: AuditEvent) -> bool:
        """Record one decision; returns True when the event was accepted
        (ring + writer deque), False when dropped.  Never blocks, never
        raises."""
        try:
            if not self.enabled:
                self.dropped_total.inc(reason="level")
                return False
            if self._sampled_out(event):
                self.dropped_total.inc(reason="sampled")
                return False
            self.emitted_total.inc(stage=event.stage,
                                   decision=event.decision)
            with self._lock:
                self._ring.append(event)
                if len(self._queue) >= self.capacity:
                    self.dropped_total.inc(reason="backpressure")
                    return False
                self._queue.append(event)
            self._wakeup()
            return True
        except Exception:
            # an audit fault must never fail the request it describes
            logger.exception("audit emit failed")
            return False

    def _wakeup(self) -> None:
        loop, wake = self._loop, self._wake
        if loop is None or wake is None or loop.is_closed():
            return
        try:
            loop.call_soon_threadsafe(wake.set)
        except RuntimeError:
            pass  # loop shut down between the check and the call

    # -- introspection -------------------------------------------------------

    def recent(self, limit: int = 0) -> list:
        """Newest-first ring snapshot as dicts at the sink's level."""
        with self._lock:
            events = list(self._ring)
        events.reverse()
        if limit > 0:
            events = events[:limit]
        return [e.to_dict(self.level) for e in events]

    # -- writer lifecycle ----------------------------------------------------

    async def start(self) -> None:
        """Start the async writer (idempotent); requires a running loop."""
        if self._task is not None and not self._task.done():
            return
        self._loop = asyncio.get_running_loop()
        self._wake = asyncio.Event()
        self._task = self._loop.create_task(self._drain())

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        self._flush()
        self._loop = None
        self._wake = None

    def _flush(self) -> None:
        while True:
            with self._lock:
                if not self._queue:
                    return
                event = self._queue.popleft()
            self._write_one(event)

    def _write_one(self, event: AuditEvent) -> None:
        try:
            self._writer(json.dumps(event.to_dict(self.level),
                                    sort_keys=True))
        except Exception:
            logger.exception("audit writer failed")

    async def _drain(self) -> None:
        while True:
            self._flush()
            self._wake.clear()
            with self._lock:
                pending = bool(self._queue)
            if pending:
                continue
            try:
                # the timeout is a liveness net for emits that raced the
                # clear(); the wake event is the fast path
                await asyncio.wait_for(self._wake.wait(), 0.5)
            except asyncio.TimeoutError:
                pass


class _NullSink(AuditSink):
    """Shared disabled sink: the default wiring when auditing is off, so
    decision sites can call `sink.enabled` unconditionally."""

    def __init__(self):
        super().__init__(level=LEVEL_NONE)

    def emit(self, event: AuditEvent) -> bool:  # pragma: no cover - trivial
        return False


NULL_SINK = _NullSink()
