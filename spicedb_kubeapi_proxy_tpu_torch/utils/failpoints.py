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
serving its adopted state and restarts the pass from the manifest.  The
disarmed fast path is one module-global bool read.
"""

from __future__ import annotations

import threading


class FailPointPanic(Exception):
    """A simulated crash at a failpoint site."""

    def __init__(self, name: str):
        self.name = name
        super().__init__(f"failpoint panic: {name}")


_lock = threading.Lock()
_armed: dict = {}
# False until the first arm, True until disable_all(); read unlocked (a
# site that sees the old value takes at most one extra no-op pass)
_active = False


def enable_failpoint(name: str, times: int) -> None:
    global _active
    with _lock:
        _armed[name] = times
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
        remaining = _armed.get(name, 0)
        if remaining <= 0:
            return
        _armed[name] = remaining - 1
    raise FailPointPanic(name)
