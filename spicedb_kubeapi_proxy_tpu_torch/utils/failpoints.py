"""Fault-injection failpoints (reference pkg/failpoints, trimmed).

Named panic sites with arm counters: `enable_failpoint(name, n)` makes
the next n `fail_point(name)` calls raise FailPointPanic (a simulated
crash at the site).  The port's sites are the dispatcher's drain loop
(`dispatchDrain`, `dispatchDrainBeforeFinish`, spicedb/dispatch.py) and
the start of a candidate generation's build (`rebuildExecutor`,
ops/torch_endpoint.py `_build_candidate`; a background rebuild that
crashes there leaves the old generation serving), and the six
dual-write activity sites of authz/distributedtx/activity.py, where the
reference's activities call them: `panicWriteSpiceDB`,
`panicSpiceDBWriteResp`, `panicReadSpiceDB`, `panicSpiceDBReadResp`,
`panicKubeWrite` and `panicKubeReadResp` (the workflow engine replays
an instance that crashes there from its journal).  The durable store
(spicedb/persist) has `walBeforeAppend` and `walAfterAppend` around a
WAL record's append and `checkpointBeforeRename` and
`manifestBeforeRename` on a checkpoint's two atomic renames; a crash
there loses no committed revision.  Replication (spicedb/replication)
has `replServeManifest` and `replServeSegment` on the leader's routes
and, on the follower, `replLeaderLink` (every request to the leader),
`replManifestPoll`, `replSegmentFetch`, `replCheckpointFetch`,
`replBootstrapAdopt` (before a checkpoint's adoption) and
`replBootstrapFinish` (after it): a follower that crashes there keeps
serving its adopted state and restarts the pass from the manifest.
Failover (spicedb/replication/failover.py) has `replPromote` inside the
promotion's critical section: a promotion that crashes there rolls back
to an intact follower.  The disarmed fast path is one module-global bool
read.

Two failure kinds (`enable_failpoint(name, n, kind=...)`):

- ``KIND_PANIC`` (the default) raises FailPointPanic, a simulated crash
  at the site;
- ``KIND_REFUSE`` raises FailPointRefused, a ConnectionError: a
  simulated network partition at an RPC site, so callers take their
  leader-unreachable paths rather than their crash paths.
"""

from __future__ import annotations

import threading


class FailPointPanic(Exception):
    """A simulated crash at a failpoint site."""

    def __init__(self, name: str):
        self.name = name
        super().__init__(f"failpoint panic: {name}")


class FailPointRefused(ConnectionError):
    """A simulated refused connection (network partition) at a failpoint
    site on an RPC path: callers see an ordinary ConnectionError."""

    def __init__(self, name: str):
        self.name = name
        super().__init__(f"failpoint partition: {name}: connection refused")


KIND_PANIC = "panic"
KIND_REFUSE = "refuse"

_lock = threading.Lock()
_armed: dict = {}  # name -> (remaining, kind)
# False until the first arm, True until disable_all(); read unlocked (a
# site that sees the old value takes at most one extra no-op pass)
_active = False


def enable_failpoint(name: str, times: int, kind: str = KIND_PANIC) -> None:
    if kind not in (KIND_PANIC, KIND_REFUSE):
        raise ValueError(f"unknown failpoint kind {kind!r}")
    global _active
    with _lock:
        _armed[name] = (times, kind)
        _active = True


def disable_all() -> None:
    global _active
    with _lock:
        _armed.clear()
        _active = False


def fail_point(name: str) -> None:
    if not _active:
        return
    with _lock:
        remaining, kind = _armed.get(name, (0, KIND_PANIC))
        if remaining <= 0:
            return
        _armed[name] = (remaining - 1, kind)
    if kind == KIND_REFUSE:
        raise FailPointRefused(name)
    raise FailPointPanic(name)
