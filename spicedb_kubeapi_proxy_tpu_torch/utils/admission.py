"""Admission control: bounded dispatcher queues and load shedding
(reference utils/admission.py).

1. Queue bounds: an enqueue that would push a dispatcher queue past its
   bound raises `AdmissionRejectedError(reason="queue_limit")` instead of
   queueing, so overload turns into fast failure with a retry hint.
   Callers that must never be rejected (a dual-write's authorization) run
   under `exempt()`.
2. Load shedder (`LoadShedder`, wired in proxy/server.py): read-only
   verbs are rejected before authorization work starts when the
   dispatcher queues are past a threshold.  Update verbs are never shed.

The `ADMISSION_CONTROL` switch (utils/features.py) is the killswitch:
off, bounds and shedding are inert and nothing counts as rejected.
`REJECTED` counts rejections by reason and `QUEUE_LIMIT["value"]` holds
the configured dispatcher bound (0 = unbounded); both are also exported
as `authz_admission_rejected_total{reason=}` and
`authz_admission_queue_limit`.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Callable, Optional

from . import features
from . import metrics as m

# verbs that may be shed: reads can be retried by any well-behaved kube
# client; update verbs ride the dual-write workflow and are never shed
READ_ONLY_VERBS = frozenset(("get", "list", "watch"))


class AdmissionRejectedError(Exception):
    """A request rejected by admission control (never a correctness
    failure): the caller should answer 429 with Retry-After."""

    def __init__(self, message: str, reason: str = "queue_limit",
                 retry_after_s: float = 1.0):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = retry_after_s


def enabled() -> bool:
    return features.ADMISSION_CONTROL


_EXEMPT: contextvars.ContextVar = contextvars.ContextVar(
    "authz_admission_exempt", default=False)


@contextlib.contextmanager
def exempt():
    """Bypass every queue bound for the enclosed work (the contextvar
    follows tasks and executor hops with the rest of the context)."""
    token = _EXEMPT.set(True)
    try:
        yield
    finally:
        _EXEMPT.reset(token)


def is_exempt() -> bool:
    return _EXEMPT.get()


REJECTED: dict = {}
QUEUE_LIMIT: dict = {"value": 0}

_REJECTED = m.REGISTRY.counter(
    "authz_admission_rejected_total",
    "Requests rejected by admission control, by reason (queue_limit = "
    "dispatcher queue bound, queue_depth / slo_burn / replica_lag = "
    "load shedder)",
    labels=("reason",))
_QUEUE_LIMIT = m.REGISTRY.gauge(
    "authz_admission_queue_limit",
    "Configured dispatcher queue bound (0 = unbounded)")
_QUEUE_LIMIT.set(0.0)


def note_rejected(reason: str) -> None:
    """Count one rejection; nothing counts with the killswitch off."""
    if not enabled():
        return
    REJECTED[reason] = REJECTED.get(reason, 0) + 1
    _REJECTED.inc(reason=reason)


def set_queue_limit(n: int) -> None:
    QUEUE_LIMIT["value"] = int(n)
    _QUEUE_LIMIT.set(float(n))


class LoadShedder:
    """Sheds read-only traffic when the proxy is already saturated, so
    queue depth stays bounded and in-flight requests keep their latency
    (reference utils/admission.py:127-237).

    Three independent signals, any sufficient:
    - `shed_queue_depth` > 0: the total dispatcher queue depth (check +
      LR), read through `depth_fn`, at or over the threshold;
    - `shed_on_burn`: the flight recorder reports an SLO burning on both
      horizons (`burning_fn` non-empty);
    - `shed_lag_s` > 0: the replication follower's staleness (`lag_fn`,
      seconds behind the leader) at or over the threshold, so a stale
      replica sheds reads before serving stale answers.

    `check(verb)` returns the rejection reason (or None to admit);
    callers build the 429 from `retry_after_s`.  `shedding_recently()`
    feeds /readyz: shed decisions within the last window mark the proxy
    degraded (still 200)."""

    RECENT_WINDOW_S = 10.0

    def __init__(self, shed_queue_depth: int = 0, shed_on_burn: bool = False,
                 retry_after_s: float = 1.0,
                 depth_fn: Optional[Callable[[], int]] = None,
                 burning_fn: Optional[Callable[[], list]] = None,
                 shed_lag_s: float = 0.0,
                 lag_fn: Optional[Callable[[], float]] = None):
        self.shed_queue_depth = shed_queue_depth
        self.shed_on_burn = shed_on_burn
        self.shed_lag_s = shed_lag_s
        self.retry_after_s = max(retry_after_s, 0.001)
        self._depth_fn = depth_fn
        self._burning_fn = burning_fn
        self._lag_fn = lag_fn
        self._lock = threading.Lock()
        self._last_shed = 0.0
        self._shed_total = 0

    @property
    def active(self) -> bool:
        return (self.shed_queue_depth > 0 or self.shed_on_burn
                or (self.shed_lag_s > 0 and self._lag_fn is not None))

    def _queue_depth(self) -> int:
        if self._depth_fn is None:
            return 0
        try:
            return int(self._depth_fn())
        except Exception:
            return 0

    def check(self, verb: str) -> Optional[str]:
        """Rejection reason for one request, or None to admit.  Only
        read-only verbs are ever shed."""
        if not self.active or not enabled():
            return None
        if verb not in READ_ONLY_VERBS:
            return None
        reason = None
        if (self.shed_queue_depth > 0
                and self._queue_depth() >= self.shed_queue_depth):
            reason = "queue_depth"
        elif self.shed_on_burn and self._burning_fn is not None:
            try:
                if self._burning_fn():
                    reason = "slo_burn"
            except Exception:
                reason = None
        if (reason is None and self.shed_lag_s > 0
                and self._lag_fn is not None):
            try:
                if self._lag_fn() >= self.shed_lag_s:
                    reason = "replica_lag"
            except Exception:
                reason = None
        if reason is None:
            return None
        note_rejected(reason)
        with self._lock:
            self._last_shed = time.monotonic()
            self._shed_total += 1
        return reason

    def shedding_recently(self) -> bool:
        with self._lock:
            last = self._last_shed
        return bool(last) and time.monotonic() - last <= self.RECENT_WINDOW_S

    def snapshot(self) -> dict:
        with self._lock:
            last = self._last_shed
            total = self._shed_total
        recent = bool(last) and (time.monotonic() - last
                                 <= self.RECENT_WINDOW_S)
        return {"shed_total": total,
                "shedding_recently": recent,
                "shed_queue_depth": self.shed_queue_depth,
                "shed_on_burn": self.shed_on_burn}
