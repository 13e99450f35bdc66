"""Cross-request batched dispatch, the reference's spicedb/dispatch.py
`BatchingEndpoint` (:148-701) without its telemetry, timeline and tracing
hooks (the port has none of those modules yet).

On the card the batch IS the kernel invocation, so this wrapper coalesces
across concurrent requests: concurrent check/LookupResources callers
enqueue work, and a drain loop issues fused calls to the inner endpoint.

Policy ("natural batching"): when no inner call is in flight, the queue
flushes immediately — single-caller latency is one kernel call, same as
direct dispatch.  While a call is in flight, new arrivals accumulate and
go out together on the next drain, so high concurrency (BASELINE config
5: 256 simultaneous list requests) produces device-sized batches without
a tuning knob.  `max_batch` caps one drain's fused size.

Failure isolation: if a fused inner call raises, each member request is
retried individually so one malformed query (an unknown definition, say)
cannot poison unrelated co-batched callers.

Pipelining (`pipeline_depth`): when the inner endpoint exposes two-phase
start/finish pairs (`torch://`), the drain loop keeps up to depth-1
started fused batches in flight — checks and lookups both — so batch
N+1's encode and sweeps overlap batch N's readback and extraction.  The
`DEVICE_PIPELINE` switch (utils/features.py) is the killswitch.
"""

from __future__ import annotations

import asyncio
import collections
from typing import Iterable, Optional

from ..utils import admission
from ..utils.failpoints import fail_point
from .endpoints import PermissionsEndpoint
from .store import Watcher
from .types import (
    CheckRequest,
    Precondition,
    RelationshipFilter,
    RelationshipUpdate,
    SubjectRef,
)


def _follow(leader: asyncio.Future, loop) -> asyncio.Future:
    """A caller-facing future mirroring an internal singleflight leader.
    The leader is never handed to callers, so one caller's cancellation
    can never poison the co-flighted others; results are shared (the
    fused extract path already hands the SAME id list to every waiter of
    a column)."""
    fut = loop.create_future()

    def _copy(lf: asyncio.Future) -> None:
        if fut.done():
            return
        if lf.cancelled():
            fut.set_exception(
                RuntimeError("singleflight leader cancelled"))
        elif lf.exception() is not None:
            fut.set_exception(lf.exception())
        else:
            fut.set_result(lf.result())

    leader.add_done_callback(_copy)
    return fut


class BatchingEndpoint(PermissionsEndpoint):
    # Retry-After hint on queue-bound rejections: one drain cycle is the
    # natural unit of backoff
    RETRY_AFTER_S = 1.0

    def __init__(self, inner: PermissionsEndpoint, max_batch: int = 4096,
                 pipeline_depth: int = 2, max_queue_depth: int = 0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        if max_queue_depth < 0:
            raise ValueError(
                f"max_queue_depth must be >= 0, got {max_queue_depth}")
        self.inner = inner
        self.max_batch = max_batch
        # bound on EACH of the check and LR queues; an enqueue that would
        # exceed it raises AdmissionRejectedError (0 = unbounded).  Exempt
        # callers and singleflight followers (no queue entry) always admit.
        self.max_queue_depth = max_queue_depth
        if max_queue_depth:
            # only a configured bound publishes the limit: endpoints built
            # later with the default 0 must not reset it to "unbounded"
            admission.set_queue_limit(max_queue_depth)
        # fused batches allowed in flight at once: depth N keeps N-1
        # STARTED batches pending.  1 = fully serial.
        self.pipeline_depth = pipeline_depth
        # waiters are (item, Future) pairs
        self._check_queue: list = []   # [(CheckRequest, Future)]
        self._lr_queue: dict = {}      # (type, perm) -> [(SubjectRef, Future)]
        # fair service order across LR keys: every queued (type, perm)
        # key appears exactly once; the drain serves the head and a key
        # with remaining waiters rejoins at the TAIL, so one hot lookup
        # key cannot monopolize the drain while others starve
        self._lr_rotation: collections.deque = collections.deque()
        # live LR queue depth (all keys), kept incrementally so the
        # admission check stays O(1) per enqueue
        self._lr_depth = 0
        # singleflight index: (type, perm, subject) -> the QUEUED leader
        # future.  Entries go at drain pickup, so arrivals during
        # execution start a fresh query (a write may have committed since
        # the executing batch applied its deltas, and a later arrival must
        # observe it — full consistency).
        self._lr_pending: dict = {}
        self._inflight: list = []      # waiters of the batch being executed
        self._drain_task: Optional[asyncio.Task] = None
        self._stats = {"drains": 0, "fused_checks": 0, "fused_lookups": 0,
                       "max_fused_batch": 0, "explain_bypass": 0,
                       "singleflight_hits": 0, "admission_rejected": 0}

    def queue_depth(self) -> int:
        """Total queued (not in-flight) entries across both queues."""
        return len(self._check_queue) + self._lr_depth

    @property
    def stats(self) -> dict:
        """Own dispatch counters merged over a COPY of the inner
        endpoint's stats, plus live queue gauges.  A write into the
        returned dict is lost: write into `inner.stats`."""
        inner_stats = getattr(self.inner, "stats", None)
        out = dict(inner_stats) if isinstance(inner_stats, dict) else {}
        out.update(self._stats)
        out["check_queue_depth"] = len(self._check_queue)
        out["lr_queue_depth"] = sum(len(v) for v in self._lr_queue.values())
        out["inflight_batch"] = len(self._inflight)
        out["pipeline_depth"] = self.pipeline_depth
        out["queue_limit"] = self.max_queue_depth
        return out

    # -- queue plumbing ------------------------------------------------------

    def _admit(self, queue_depth: int, adding: int, which: str) -> None:
        """Reject an enqueue that would push `which` queue past the
        bound.  The bound limits BACKLOG, not request size: a bulk
        arriving at an empty queue always admits whole, so worst-case
        resident depth is the bound plus one batch."""
        if not self.max_queue_depth:
            return
        if queue_depth == 0 or queue_depth + adding <= self.max_queue_depth:
            return
        if admission.is_exempt() or not admission.enabled():
            return
        self._stats["admission_rejected"] += 1
        admission.note_rejected("queue_limit")
        raise admission.AdmissionRejectedError(
            f"{which} queue at depth {queue_depth} (bound "
            f"{self.max_queue_depth}); retry after "
            f"{self.RETRY_AFTER_S:.1f}s",
            reason="queue_limit", retry_after_s=self.RETRY_AFTER_S)

    def _kick(self) -> None:
        if self._drain_task is None or self._drain_task.done():
            self._drain_task = asyncio.get_running_loop().create_task(
                self._drain())

    async def _drain(self) -> None:
        # `pending` holds up to (pipeline_depth - 1) started batches —
        # checks and lookups share the window, finished strictly FIFO —
        # so snapshot retention is bounded by the depth.  With the
        # pipeline switch off, lookups keep the single-slot two-phase
        # window and checks run serially.
        from ..utils.features import pipeline_enabled
        pending: collections.deque = collections.deque()
        two_lr = (hasattr(self.inner, "lookup_resources_batch_start")
                  and hasattr(self.inner, "lookup_resources_batch_finish"))
        two_ck = (hasattr(self.inner, "check_bulk_permissions_start")
                  and hasattr(self.inner, "check_bulk_permissions_finish"))
        if pipeline_enabled():
            window = self.pipeline_depth - 1
            two_lr = two_lr and window > 0
            two_ck = two_ck and window > 0
        else:
            window = 1 if two_lr else 0
            two_ck = False
        try:
            while self._check_queue or self._lr_queue or pending:
                fail_point("dispatchDrain")
                self._stats["drains"] += 1
                # alternate which queue goes first each iteration so
                # sustained traffic on one verb cannot push the other
                # behind it in every drain cycle
                order = (("ck", "lr") if self._stats["drains"] % 2
                         else ("lr", "ck"))
                for side in order:
                    if side == "ck" and self._check_queue:
                        batch = self._check_queue[: self.max_batch]
                        del self._check_queue[: len(batch)]
                        self._inflight = batch
                        if two_ck:
                            started = await self._start_checks(batch)
                            self._inflight = []
                            if started:
                                pending.append(started)
                        else:
                            await self._run_checks(batch)
                            self._inflight = []
                    elif side == "lr" and self._lr_queue:
                        key, waiters = self._next_lr_key()
                        rest = waiters[self.max_batch:]
                        waiters = waiters[: self.max_batch]
                        if rest:
                            # the remainder rejoins at the BACK of the
                            # rotation: a hot key yields the drain to
                            # every other queued key between its batches
                            self._lr_queue[key] = rest
                            self._lr_rotation.append(key)
                        self._lr_depth -= len(waiters)
                        self._unregister_pending(key, waiters)
                        self._inflight = waiters
                        if two_lr:
                            # `started` joins `pending` BEFORE any
                            # blocking finish, so a drain death during
                            # that await still knows every started batch
                            started = await self._start_lookups(key, waiters)
                            self._inflight = []
                            if started:
                                pending.append(started)
                        else:
                            await self._run_lookups(key, waiters)
                            self._inflight = []
                while pending and (len(pending) > window
                                   or not (self._check_queue
                                           or self._lr_queue)):
                    fail_point("dispatchDrainBeforeFinish")
                    kind, waiters, started = pending.popleft()
                    self._inflight = waiters
                    if kind == "lr":
                        await self._finish_lookups(waiters, started)
                    else:
                        await self._finish_checks(waiters, started)
                    self._inflight = []
        except BaseException as e:
            # A cancelled or dying drain task must FAIL its waiters —
            # queued, in flight, and started but unfinished — or every
            # caller awaiting a future hangs forever.
            failure = (RuntimeError("batch dispatch drain task cancelled")
                       if isinstance(e, asyncio.CancelledError) else e)
            stranded = list(self._inflight)
            self._inflight = []
            for _kind, ws, _started in pending:
                stranded.extend(ws)
            stranded.extend(self._check_queue)
            del self._check_queue[:]
            for ws in self._lr_queue.values():
                stranded.extend(ws)
            self._lr_queue.clear()
            self._lr_rotation.clear()
            self._lr_depth = 0
            self._lr_pending.clear()
            for w in stranded:
                if not w[1].done():
                    w[1].set_exception(failure)
            raise

    def _next_lr_key(self) -> tuple:
        """Pop the next (type, perm) key in fair rotation order and its
        full waiter list.  Invariant: a key is in the rotation exactly
        once iff it has a queue entry, so the loop's guard is defensive."""
        while self._lr_rotation:
            key = self._lr_rotation.popleft()
            waiters = self._lr_queue.pop(key, None)
            if waiters is not None:
                return key, waiters
        key = next(iter(self._lr_queue))
        return key, self._lr_queue.pop(key)

    def _unregister_pending(self, key: tuple, waiters: list) -> None:
        """Close the singleflight window for a batch being picked up:
        identical queries arriving from now on must start fresh (the
        batch applies deltas at pickup, not at their arrival)."""
        resource_type, permission = key
        for w in waiters:
            k = (resource_type, permission, w[0])
            if self._lr_pending.get(k) is w[1]:
                del self._lr_pending[k]

    def _enqueue_lookup(self, resource_type: str, permission: str,
                        subject: SubjectRef,
                        pre_admitted: bool = False) -> asyncio.Future:
        """Queue one lookup, singleflight-deduped: an identical query
        already QUEUED shares its waiter through an internal leader
        future; the returned future is always caller-private (_follow).
        `pre_admitted`: lookup_resources_batch admitted the WHOLE batch,
        and a per-leader check here would reject mid-batch."""
        loop = asyncio.get_running_loop()
        k = (resource_type, permission, subject)
        leader = self._lr_pending.get(k)
        if leader is None:
            # only a NEW leader adds queue depth; followers join an
            # existing column for free, so under overload identical
            # queries collapse instead of rejecting
            if not pre_admitted:
                self._admit(self._lr_depth, 1, "lookup")
            leader = loop.create_future()
            self._lr_pending[k] = leader
            qkey = (resource_type, permission)
            q = self._lr_queue.get(qkey)
            if q is None:
                q = self._lr_queue[qkey] = []
                self._lr_rotation.append(qkey)
            q.append((subject, leader))
            self._lr_depth += 1
        else:
            self._stats["singleflight_hits"] += 1
        return _follow(leader, loop)

    async def _retry_individually(self, waiters: list, single_call) -> None:
        """Per-member fallback after a fused call failed (concurrently: a
        poison request must not serialize the drain loop)."""
        async def retry_one(w):
            item, fut = w
            if fut.done():
                return
            try:
                res = await single_call(item)
            except Exception as e:
                if not fut.done():  # the caller may cancel during the await
                    fut.set_exception(e)
            else:
                if not fut.done():
                    fut.set_result(res)

        await asyncio.gather(*[retry_one(w) for w in waiters])

    @staticmethod
    def _resolve(waiters: list, results: list) -> None:
        for w, res in zip(waiters, results):
            if not w[1].done():
                w[1].set_result(res)

    def _note_fused(self, stat: str, n: int) -> None:
        self._stats[stat] += 1
        self._stats["max_fused_batch"] = max(self._stats["max_fused_batch"],
                                            n)

    async def _run_fused(self, waiters: list, stat: str, fused_call,
                         single_call) -> None:
        """One fused inner call for `waiters` ([(item, Future)]); on
        failure, retry members individually."""
        items = [w[0] for w in waiters]
        self._note_fused(stat, len(items))
        try:
            results = await fused_call(items)
        except Exception:
            await self._retry_individually(waiters, single_call)
            return
        self._resolve(waiters, results)

    async def _run_checks(self, batch: list) -> None:
        await self._run_fused(
            batch, "fused_checks",
            self.inner.check_bulk_permissions,
            self.inner.check_permission)

    async def _run_lookups(self, key: tuple, waiters: list) -> None:
        resource_type, permission = key
        await self._run_fused(
            waiters, "fused_lookups",
            lambda subjects: self.inner.lookup_resources_batch(
                resource_type, permission, subjects),
            lambda subject: self.inner.lookup_resources(
                resource_type, permission, subject))

    async def _start_lookups(self, key: tuple, waiters: list):
        """Phase 1 of a pipelined fused lookup: encode, sweep and start
        the readback.  On failure, degrade to the classic fused call with
        per-member retry; returns None so the drain has nothing to
        finish."""
        resource_type, permission = key
        try:
            ctx = await self.inner.lookup_resources_batch_start(
                resource_type, permission, [w[0] for w in waiters])
        except Exception:
            await self._run_lookups(key, waiters)
            return None
        self._note_fused("fused_lookups", len(waiters))
        return ("lr", waiters, (key, ctx))

    async def _start_checks(self, batch: list):
        """Phase 1 of a pipelined fused check (see _start_lookups)."""
        try:
            ctx = await self.inner.check_bulk_permissions_start(
                [w[0] for w in batch])
        except Exception:
            await self._run_checks(batch)
            return None
        self._note_fused("fused_checks", len(batch))
        return ("ck", batch, ctx)

    async def _finish_checks(self, waiters: list, ctx) -> None:
        """Phase 2: readback wait and result assembly; per-member retry
        on failure (the same isolation contract as _run_fused)."""
        try:
            results = await self.inner.check_bulk_permissions_finish(ctx)
        except Exception:
            await self._retry_individually(waiters,
                                           self.inner.check_permission)
            return
        self._resolve(waiters, results)

    async def _finish_lookups(self, waiters: list, started) -> None:
        """Phase 2: readback wait and extraction; per-member retry on
        failure."""
        key, ctx = started
        resource_type, permission = key
        try:
            results = await self.inner.lookup_resources_batch_finish(ctx)
        except Exception:
            await self._retry_individually(
                waiters, lambda s: self.inner.lookup_resources(
                    resource_type, permission, s))
            return
        self._resolve(waiters, results)

    # -- batched verbs -------------------------------------------------------

    async def check_permission(self, req: CheckRequest):
        self._admit(len(self._check_queue), 1, "check")
        fut = asyncio.get_running_loop().create_future()
        self._check_queue.append((req, fut))
        self._kick()
        return await fut

    async def check_bulk_permissions(self, reqs: list) -> list:
        if not reqs:
            return []
        # admit or reject the bulk WHOLE: half-enqueueing one caller's
        # batch would run checks for an answer the caller never sees
        self._admit(len(self._check_queue), len(reqs), "check")
        loop = asyncio.get_running_loop()
        futs = []
        for r in reqs:
            fut = loop.create_future()
            self._check_queue.append((r, fut))
            futs.append(fut)
        self._kick()
        return list(await asyncio.gather(*futs))

    async def lookup_resources(self, resource_type: str, permission: str,
                               subject: SubjectRef) -> list:
        fut = self._enqueue_lookup(resource_type, permission, subject)
        self._kick()
        return await fut

    async def lookup_resources_batch(self, resource_type: str, permission: str,
                                     subjects: list) -> list:
        if not subjects:
            return []
        # whole-batch admission (duplicates that would collapse into
        # followers still count)
        self._admit(self._lr_depth, len(subjects), "lookup")
        futs = [self._enqueue_lookup(resource_type, permission, s,
                                     pre_admitted=True)
                for s in subjects]
        self._kick()
        return list(await asyncio.gather(*futs))

    # -- passthrough verbs ---------------------------------------------------

    def explain_check(self, resource, permission, subject):
        """Witness capture bypasses the fused queue (reference
        spicedb/dispatch.py:668): an explain is a targeted re-check on a
        rare debug path — co-batching it would make the captured iterate
        depend on whatever requests it fused with, and a queue backlog
        would stall the audit event it feeds."""
        self._stats["explain_bypass"] += 1
        fn = getattr(self.inner, "explain_check", None)
        if fn is not None:
            return fn(resource, permission, subject)
        from ..authz.explain import witness_for
        return witness_for(self.inner, resource, permission, subject)

    async def read_relationships(self, flt: RelationshipFilter) -> list:
        return await self.inner.read_relationships(flt)

    async def write_relationships(self, updates: Iterable[RelationshipUpdate],
                                  preconditions: Iterable[Precondition] = ()) -> int:
        return await self.inner.write_relationships(updates, preconditions)

    async def delete_relationships(self, flt: RelationshipFilter,
                                   preconditions: Iterable[Precondition] = ()) -> int:
        return await self.inner.delete_relationships(flt, preconditions)

    def watch(self, object_types=None) -> Watcher:
        return self.inner.watch(object_types)

    async def close(self) -> None:
        task = self._drain_task
        if task is not None and not task.done():
            await task
        await self.inner.close()

    def __getattr__(self, name):
        return getattr(self.inner, name)
