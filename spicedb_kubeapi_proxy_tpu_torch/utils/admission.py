"""Admission control for the dispatcher's queues (reference
utils/admission.py:51-125, the part the dispatcher needs).

An enqueue that would push a dispatcher queue past its bound raises
`AdmissionRejectedError(reason="queue_limit")` instead of queueing, so
overload turns into fast failure with a retry hint.  Callers that must
never be rejected (a dual-write's authorization) run under `exempt()`.
The `ADMISSION_CONTROL` switch (utils/features.py) is the killswitch:
off, bounds are inert and nothing counts as rejected.

The port has no metrics registry yet, so the counters are plain dicts:
`REJECTED` counts rejections by reason and `QUEUE_LIMIT["value"]` holds
the configured bound (0 = unbounded).
"""

from __future__ import annotations

import contextlib
import contextvars

from . import features


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


def note_rejected(reason: str) -> None:
    """Count one rejection; nothing counts with the killswitch off."""
    if not enabled():
        return
    REJECTED[reason] = REJECTED.get(reason, 0) + 1


def set_queue_limit(n: int) -> None:
    QUEUE_LIMIT["value"] = int(n)
