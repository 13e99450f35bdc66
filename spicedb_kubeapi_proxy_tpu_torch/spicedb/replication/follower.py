"""Follower side of WAL-shipping replication: the ReplicaFollower.

Lifecycle (reference spicedb/replication/follower.py):

1. **Bootstrap** — fetch `/replication/manifest`; adopt the newest
   checkpoint wholesale (`TupleStore.replica_reset`, which fires the
   reset listeners so the device graph / decision cache rebuild from the
   adopted state), position the segment cursor just past the
   checkpoint's watermark.
2. **Tail** — long-poll the manifest for `revision > applied`, fetch new
   segment bytes from the cursor offset, decode complete CRC frames
   (`persist.wal.parse_frames` — the same framing code the leader's own
   recovery uses), and apply each record in revision order through the
   live-store replica path: `apply_replica_batch` for deltas (drives
   watchers + delta listeners), `bulk_load_snapshot`/`bulk_load`/
   `delete_all` for the mass-change kinds (drive the reset listeners).
3. **Re-bootstrap** — a 404 on a segment (reclaimed under a newer
   checkpoint), a revision gap, or a damaged frame all converge on the
   same recovery: re-adopt the newest checkpoint instead of diverging.
   The applied revision may move BACKWARDS across a re-bootstrap after
   the leader lost an unsynced tail — bounded staleness, never
   divergence.

Incarnation fencing: the follower remembers the highest (incarnation,
leader_id) it has ever adopted and echoes it on every poll.  A manifest from a LOWER epoch —
a resurrected ex-leader serving a superseded log — raises
`StaleLeaderError`: the follower refuses to apply it (keeps serving its
adopted state) rather than re-bootstrap backwards into a fenced log.

Fan-out trees (`--serve-replication`): a follower given a `mirror_dir`
spools every artifact byte it consumes — checkpoint, segments, sidecars
— into a data-dir-shaped mirror, which `failover.FanoutHub` serves to
downstream followers with the SAME protocol the leader speaks.  Chain
lag is additive: the upstream's manifest carries its own chain lag, and
this follower's lag gauges report hop + upstream.

The follower never journals: commit listeners do not fire on the
replica-apply paths, so a follower is free to also be configured with
its own (independent) observability but never re-ships the leader's log.

Thread model: everything here runs on the server's event loop (one
`run()` task); `wait_for_revision` is how the serving path parks a
ZedToken-bearing request until the tail catches up.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import time
import uuid
import weakref
from typing import Optional

from ...utils import metrics as m
from ...utils.failpoints import fail_point
from ..store import TupleStore
from ..types import RelationshipUpdate, UpdateOp, parse_relationship
from ..persist.wal import SEGMENT_MAGIC, TornFrameError, parse_frames
from .leader import INCARNATION_HEADER, LEADER_ID_HEADER

logger = logging.getLogger("spicedb_kubeapi_proxy_tpu_torch.replication")

STATE_BOOTSTRAPPING = "bootstrapping"
STATE_STREAMING = "streaming"
STATE_DEGRADED = "degraded"          # leader unreachable; still serving
STATE_AWAITING_CHECKPOINT = "awaiting_checkpoint"

DEFAULT_BACKOFF_CAP_S = 15.0


class ReplicationProtocolError(Exception):
    """The leader's answers cannot be reconciled with the local state
    (revision gap, damaged frame, reclaimed artifact): re-bootstrap."""


class StaleLeaderError(Exception):
    """The upstream served a manifest from a SUPERSEDED incarnation (a
    resurrected ex-leader).  Never re-bootstrap from it: keep serving
    the adopted state and wait for a repoint / the real leader."""


# switch off = no follower exists (the server requires replicate_from
# AND the REPLICATION switch before constructing one)
class ReplicaFollower:
    """Tails one leader's replication API into a live TupleStore."""

    def __init__(self, store: TupleStore, transport,
                 identity: str = "replica",
                 groups: tuple = (),
                 replica_id: str = "",
                 upstream_url: str = "",
                 mirror_dir: str = "",
                 poll_timeout_s: float = 25.0,
                 retry_backoff_s: float = 1.0,
                 retry_backoff_cap_s: float = DEFAULT_BACKOFF_CAP_S,
                 rng: Optional[random.Random] = None,
                 registry: Optional[m.Registry] = None):
        self.store = store
        self.transport = transport
        self.identity = identity
        self.groups = tuple(groups)
        self.replica_id = (replica_id
                           or f"replica-{os.getpid()}"
                              f"-{uuid.uuid4().hex[:8]}")
        self.upstream_url = upstream_url
        # fan-out mirror (failover.FanoutHub serves it): "" = disabled
        self.mirror_dir = mirror_dir
        self.poll_timeout_s = poll_timeout_s
        self.retry_backoff_s = retry_backoff_s
        self.retry_backoff_cap_s = retry_backoff_cap_s
        # jitter source for retry backoff (injectable for deterministic
        # tests): a restarted leader must not be thundering-herded by
        # its whole fleet re-bootstrapping on one synchronized cadence
        self._rng = rng or random.Random()
        self.bootstrapped = False
        # once ANY state has been adopted, readiness never hard-fails
        # again: a re-bootstrap (leader restart, reclaimed tail) keeps
        # serving bounded-staleness reads from the existing store and
        # must report degraded-but-200, not eject every replica at once
        self.ever_bootstrapped = False
        self.state = STATE_BOOTSTRAPPING
        self.leader_id = ""
        self._boot_leader_id = ""  # incarnation the cursor belongs to
        self.leader_revision = 0
        # highest incarnation epoch (and its leader id) ever adopted —
        # the fencing memory; echoed on every poll so a stale leader
        # learns it has been superseded
        self.max_incarnation = 0
        self.max_leader_id = ""
        # upstream-reported chain provenance (manifest "chain"): path of
        # hub ids from the root leader down to the direct upstream, plus
        # the upstream's own cumulative lag — this follower's lag is
        # hop + upstream
        self.upstream_chain: dict = {"path": [], "lag_revisions": 0.0,
                                     "lag_seconds": 0.0}
        self._cursor_seq = 0      # segment currently being tailed
        self._cursor_off = 0      # raw file bytes fully consumed from it
        self._caught_up_at: Optional[float] = None  # monotonic
        self._last_success: Optional[float] = None  # monotonic
        self._clock_skew_s: Optional[float] = None  # upstream - local
        self._task: Optional[asyncio.Task] = None
        self._waiters: list = []  # (min_revision, future)
        self._progress_listeners: list = []
        self.stats = {"applied_records": 0, "applied_updates": 0,
                      "bootstraps": 0, "polls": 0, "poll_errors": 0,
                      "rebootstraps": 0, "fenced_polls": 0, "repoints": 0,
                      "mirrored_bytes": 0}
        registry = registry or m.REGISTRY
        self._applied_bytes = registry.counter(
            "authz_replication_applied_bytes_total",
            "Bytes of leader WAL/checkpoint artifacts fetched and applied "
            "by this follower, by artifact kind", labels=("kind",))
        self._fenced_total = registry.counter(
            "authz_replication_fenced_total",
            "Incarnation-fencing events: stage=leader when this leader "
            "observed a newer incarnation and fenced itself, "
            "stage=follower when a follower rejected a stale leader's "
            "manifest", labels=("stage",))
        ref = weakref.ref(self)
        registry.gauge(
            "authz_replica_lag_revisions",
            "Leader revision minus the follower's applied revision, plus "
            "the upstream chain's reported lag (-1 = leader revision "
            "unknown yet)",
            callback=lambda: (ref().lag_revisions()
                              if ref() is not None else -1.0))
        registry.gauge(
            "authz_replica_lag_seconds",
            "Seconds since this follower last had the leader's newest "
            "revision fully applied, plus the upstream chain's reported "
            "lag, clamped at 0 (0 = caught up, -1 = never synced); "
            "cross-process clock skew is exported separately as "
            "authz_clock_skew_seconds instead of bleeding in here",
            callback=lambda: (ref().lag_seconds()
                              if ref() is not None else -1.0))
        registry.gauge(
            "authz_clock_skew_seconds",
            "Estimated upstream wall clock minus this process's wall "
            "clock (seconds), sampled from the manifest's "
            "server_time_unix at receive time; 0 until the first "
            "manifest lands.  Merged fleet traces never use this — hop "
            "spans align children by the parent's clock",
            callback=lambda: ((ref().clock_skew_s() or 0.0)
                              if ref() is not None else 0.0))
        registry.gauge(
            "authz_replication_incarnation",
            "Current replication incarnation epoch (leader: own epoch; "
            "follower: highest epoch observed)",
            callback=lambda: (float(ref().max_incarnation)
                              if ref() is not None else 0.0))

    # -- lag accounting ------------------------------------------------------

    def lag_revisions(self) -> float:
        if self.leader_revision <= 0 and not self.bootstrapped:
            return -1.0
        hop = float(max(0, self.leader_revision - self.store.revision))
        return hop + float(self.upstream_chain.get("lag_revisions") or 0.0)

    def lag_seconds(self) -> float:
        if self._caught_up_at is None:
            return -1.0
        # chain lag crosses process (and possibly host) boundaries:
        # wall-clock skew between hubs could drive it negative, and a
        # negative "seconds behind" is always a measurement artifact,
        # so it is clamped at 0
        chain = max(0.0,
                    float(self.upstream_chain.get("lag_seconds") or 0.0))
        if self.store.revision >= self.leader_revision:
            return chain
        return max(0.0, time.monotonic() - self._caught_up_at) + chain

    def clock_skew_s(self) -> Optional[float]:
        """Most recent estimate of (upstream wall clock - local wall
        clock), from the manifest's server_time_unix sampled at receive
        time; None until the first manifest lands.  Its bias is bounded
        by the one-way response latency."""
        return self._clock_skew_s

    def seconds_since_success(self) -> float:
        """Monotonic seconds since the last fully-successful sync pass —
        the leader-loss watchdog's FIRST-stage signal (inf = never).
        Note an idle tail legitimately parks in a manifest long-poll for
        tens of seconds, so a stale success alone is not loss: the
        watchdog confirms with `probe_upstream` before electing."""
        if self._last_success is None:
            return float("inf")
        return time.monotonic() - self._last_success

    async def probe_upstream(self) -> None:
        """One cheap no-wait manifest fetch — the watchdog's direct
        liveness check.  Raises on an unreachable, hung (caller bounds
        it), or fenced (StaleLeaderError) upstream; success means the
        leader is alive even while sync_once is parked long-polling, so
        it refreshes the loss clock (one probe per grace window, not
        one per watchdog tick)."""
        await self._fetch_manifest(wait=False)
        self._last_success = time.monotonic()

    def _note_progress(self) -> None:
        if self.store.revision >= self.leader_revision:
            self._caught_up_at = time.monotonic()
        rev = self.store.revision
        pending, self._waiters = self._waiters, []
        for min_rev, fut in pending:
            if rev >= min_rev:
                if not fut.done():
                    fut.set_result(True)
            else:
                self._waiters.append((min_rev, fut))
        for fn in list(self._progress_listeners):
            try:
                fn()
            except Exception:  # pragma: no cover - defensive
                logger.exception("replica progress listener failed")

    def add_progress_listener(self, fn) -> None:
        """fn() after every sync pass that may have advanced the applied
        revision — the fan-out hub's long-poll wakeup."""
        self._progress_listeners.append(fn)

    def remove_progress_listener(self, fn) -> None:
        if fn in self._progress_listeners:
            self._progress_listeners.remove(fn)

    async def wait_for_revision(self, min_revision: int,
                                timeout_s: float) -> bool:
        """Park until the applied revision reaches `min_revision` — the
        ZedToken wait path for a read whose token is ahead of the tail."""
        if self.store.revision >= min_revision:
            return True
        if timeout_s <= 0:
            return False
        fut = asyncio.get_running_loop().create_future()
        self._waiters.append((min_revision, fut))
        try:
            await asyncio.wait_for(fut, timeout_s)
            return True
        except asyncio.TimeoutError:
            return self.store.revision >= min_revision
        finally:
            self._waiters = [(r, f) for r, f in self._waiters if f is not fut]

    # -- HTTP ----------------------------------------------------------------

    async def _request(self, target: str):
        from ...proxy.httpcore import Headers, Request
        fail_point("replLeaderLink")
        h = Headers([("Accept", "application/json"),
                     ("X-Remote-User", self.identity)])
        for g in self.groups:
            h.add("X-Remote-Group", g)
        # fleet tracing: sync and control calls carry provenance headers
        # too (the tier path always; the trace id when a request trace
        # is active, e.g. a rejoin driven from a handler); none when
        # propagation is switched off
        from ...utils import tracing
        for pk, pv in tracing.propagation_headers(
                default_tier="follower").items():
            h.set(pk, pv)
        if self.max_incarnation > 0:
            # fencing exchange: tell the upstream the newest incarnation
            # we have adopted — a resurrected ex-leader seeing a newer
            # epoch here fences itself instead of split-braining
            h.set(INCARNATION_HEADER, str(self.max_incarnation))
            h.set(LEADER_ID_HEADER, self.max_leader_id)
        return await self.transport.round_trip(
            Request(method="GET", target=target, headers=h))

    async def _fetch_manifest(self, wait: bool) -> dict:
        import json
        fail_point("replManifestPoll")
        target = "/replication/manifest"
        if wait:
            target += (f"?wait_revision={self.store.revision}"
                       f"&timeout_ms={int(self.poll_timeout_s * 1e3)}")
        resp = await self._request(target)
        t_recv = time.time()
        if resp.status != 200:
            raise ConnectionError(
                f"manifest fetch failed: HTTP {resp.status}")
        man = json.loads(resp.body)
        server_time = man.get("server_time_unix")
        if server_time is not None:
            # skew sample: the manifest is stamped just before the
            # response is written, so compare against RECEIVE time (a
            # long-poll's park time drops out; bias = one-way latency)
            self._clock_skew_s = float(server_time) - t_recv
        inc = int(man.get("incarnation", 0) or 0)
        lid = man.get("leader_id", "")
        # total order on (incarnation, leader_id): an epoch tie — two
        # sides of a partition promoting simultaneously — breaks
        # deterministically on the LARGER id, so the whole fleet (and
        # the tied leaders themselves) converge on the same winner
        if inc < self.max_incarnation or (
                inc == self.max_incarnation and self.max_leader_id
                and lid and lid < self.max_leader_id):
            # a superseded log: never adopt it, never re-bootstrap
            # backwards into it — keep serving the state we have
            self.stats["fenced_polls"] += 1
            self._fenced_total.inc(stage="follower")
            raise StaleLeaderError(
                f"upstream {lid!r} serves incarnation {inc}, but "
                f"incarnation {self.max_incarnation} "
                f"({self.max_leader_id!r}) has superseded it")
        if (inc, lid) > (self.max_incarnation, self.max_leader_id):
            self.max_incarnation, self.max_leader_id = inc, lid
        self.leader_id = lid
        self.leader_revision = int(man.get("revision", 0))
        self.upstream_chain = (man.get("chain")
                               or {"path": [lid] if lid else [],
                                   "lag_revisions": 0.0,
                                   "lag_seconds": 0.0})
        return man

    async def _fetch_artifact(self, kind: str, name: str,
                              offset: int = 0) -> bytes:
        fail_point("replSegmentFetch" if kind == "segment"
                   else "replCheckpointFetch")
        target = f"/replication/{kind}/{name}"
        if offset:
            target += f"?offset={offset}"
        resp = await self._request(target)
        if resp.status == 404:
            raise ReplicationProtocolError(
                f"{kind} {name!r} gone (reclaimed); re-bootstrap")
        if resp.status not in (200, 206):
            raise ConnectionError(
                f"{kind} {name!r} fetch failed: HTTP {resp.status}")
        return resp.body

    async def _spool_npz(self, body: bytes, prefix: str):
        """Spool fetched artifact bytes to a temp file and parse the
        columnar npz OFF the event loop: a 1M-tuple
        checkpoint or bulk-load sidecar is tens of MB, and this loop is
        also serving every read on the replica — only the store
        adoption (already serialized by the store lock) stays on it.
        Returns (snap, overlay, meta) from load_columnar_file."""
        from ..persist import checkpoint as ckpt

        def _spool_and_parse():
            import tempfile
            import os
            fd, path = tempfile.mkstemp(suffix=".npz", prefix=prefix)
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(body)
                return ckpt.load_columnar_file(path)
            finally:
                try:
                    os.unlink(path)
                except OSError:
                    pass

        return await asyncio.get_running_loop().run_in_executor(
            None, _spool_and_parse)

    # -- fan-out mirror ------------------------------------------------------
    # With a mirror_dir, every artifact byte this follower consumes is
    # spooled into a data-dir-shaped mirror that failover.FanoutHub
    # serves to downstream followers.  Ordering invariant: a segment
    # chunk is appended only AFTER its records (and any sidecars they
    # reference) applied and landed in the mirror, so a downstream
    # tailing the mirror can never fetch a record whose sidecar is
    # missing, and the mirror never exposes bytes past this follower's
    # applied revision.

    async def _mirror_io(self, fn) -> None:
        # file writes stay off the serving loop
        await asyncio.get_running_loop().run_in_executor(None, fn)

    async def _mirror_reset(self, cp: Optional[dict],
                            ckpt_body: Optional[bytes]) -> None:
        if not self.mirror_dir:
            return
        from ..persist import checkpoint as ckpt

        def _reset():
            import shutil
            wal_dir = os.path.join(self.mirror_dir, "wal")
            ck_dir = os.path.join(self.mirror_dir, ckpt.CHECKPOINT_DIR)
            for d in (wal_dir, ck_dir):
                shutil.rmtree(d, ignore_errors=True)
                os.makedirs(d, exist_ok=True)
            man_path = os.path.join(self.mirror_dir, ckpt.MANIFEST_NAME)
            if cp is None:
                try:
                    os.unlink(man_path)
                except OSError:
                    pass
                return
            with open(os.path.join(ck_dir, cp["checkpoint"]), "wb") as f:
                f.write(ckpt_body or b"")
            ckpt.write_manifest(self.mirror_dir, dict(cp))

        await self._mirror_io(_reset)
        if ckpt_body is not None:
            self.stats["mirrored_bytes"] += len(ckpt_body)

    async def _mirror_sidecar(self, name: str, body: bytes) -> None:
        if not self.mirror_dir:
            return
        path = os.path.join(self.mirror_dir, "wal", name)

        def _write():
            with open(path, "wb") as f:
                f.write(body)

        await self._mirror_io(_write)
        self.stats["mirrored_bytes"] += len(body)

    async def _mirror_append_segment(self, name: str, base: int,
                                     chunk: bytes) -> None:
        if not self.mirror_dir or not chunk:
            return
        path = os.path.join(self.mirror_dir, "wal", name)

        def _append():
            mode = "r+b" if os.path.exists(path) else "wb"
            with open(path, mode) as f:
                f.seek(base)
                f.write(chunk)
                f.truncate(base + len(chunk))

        await self._mirror_io(_append)
        self.stats["mirrored_bytes"] += len(chunk)

    # -- bootstrap -----------------------------------------------------------

    async def _bootstrap(self, man: dict) -> None:
        cp = man.get("checkpoint")
        ckpt_body = None
        if cp is None:
            if self.store.revision > 0:
                # local state exists but the leader has no checkpoint to
                # re-anchor on; wait for its periodic checkpoint rather
                # than guessing at divergence
                self.state = STATE_AWAITING_CHECKPOINT
                return
            watermark = 0
        else:
            body = await self._fetch_artifact("checkpoint", cp["checkpoint"])
            self._applied_bytes.inc(len(body), kind="checkpoint")
            snap, overlay, _meta = await self._spool_npz(body,
                                                         "replica-ckpt-")
            ckpt_body = body
            # a crash ANYWHERE in this window must restart cleanly from
            # the manifest: everything before replica_reset leaves the
            # old state serving untouched, and replica_reset itself is
            # atomic under the store lock — there is no observable
            # half-adopted state
            fail_point("replBootstrapAdopt")
            self.store.replica_reset(snap if len(snap) else None, overlay,
                                     int(cp["revision"]))
            watermark = int(cp.get("watermark", 0))
        await self._mirror_reset(cp, ckpt_body)
        fail_point("replBootstrapFinish")
        # position the cursor on the first segment past the watermark
        seqs = sorted(s["seq"] for s in man.get("segments", ()))
        nxt = [s for s in seqs if s > watermark]
        self._cursor_seq = nxt[0] if nxt else 0
        self._cursor_off = 0
        self._boot_leader_id = man.get("leader_id", "")
        self.bootstrapped = True
        self.ever_bootstrapped = True
        self.stats["bootstraps"] += 1
        self.state = STATE_STREAMING
        logger.info(
            "replica bootstrapped from %s at revision %d (watermark seg %d)",
            self.leader_id or "leader", self.store.revision, watermark)

    async def _rebootstrap(self, why: str) -> None:
        logger.warning("replica re-bootstrap (%s)", why)
        self.stats["rebootstraps"] += 1
        self.bootstrapped = False
        self.state = STATE_BOOTSTRAPPING
        await self._bootstrap(await self._fetch_manifest(wait=False))

    def repoint(self, transport, url: str = "") -> None:
        """Point this follower at a different upstream (failover: the
        fleet re-points from the dead leader to the promoted one).  The
        next sync re-bootstraps against the new log; the fencing memory
        (max incarnation) survives, so a stale upstream is still
        rejected."""
        self.transport = transport
        if url:
            self.upstream_url = url
        self.bootstrapped = False
        self.state = STATE_BOOTSTRAPPING
        self._boot_leader_id = ""
        self._cursor_seq = 0
        self._cursor_off = 0
        self.stats["repoints"] += 1
        logger.info("replica repointed to %s", url or "<new transport>")

    # -- record application --------------------------------------------------

    async def _apply_record(self, rec: dict) -> bool:
        """Apply one decoded WAL record; False when it predates the
        local revision (overlap from a re-fetch), True when applied."""
        rev = int(rec["r"])
        if rev <= self.store.revision:
            return False
        if rev != self.store.revision + 1:
            raise ReplicationProtocolError(
                f"revision gap: follower at {self.store.revision}, "
                f"next shipped record {rev}")
        kind = rec["k"]
        if kind == "d":
            updates = [
                RelationshipUpdate(
                    UpdateOp.DELETE if op == "d" else UpdateOp.TOUCH,
                    parse_relationship(s))
                for op, s in rec.get("u", ())]
            self.store.apply_replica_batch(updates)
            self.stats["applied_updates"] += len(updates)
        elif kind == "s":
            body = await self._fetch_artifact("segment", rec["f"])
            self._applied_bytes.inc(len(body), kind="sidecar")
            # the sidecar lands in the mirror BEFORE the segment chunk
            # referencing it is appended (ordering invariant above)
            await self._mirror_sidecar(rec["f"], body)
            snap, _overlay, _meta = await self._spool_npz(body,
                                                          "replica-snap-")
            self.store.bulk_load_snapshot(snap)
        elif kind == "b":
            self.store.bulk_load(
                [parse_relationship(s) for s in rec.get("u", ())])
        elif kind == "c":
            self.store.delete_all()
        else:
            raise ReplicationProtocolError(
                f"unknown shipped record kind {kind!r}")
        if self.store.revision != rev:
            raise ReplicationProtocolError(
                f"replica apply of kind {kind!r} landed at revision "
                f"{self.store.revision}, record says {rev}")
        self.stats["applied_records"] += 1
        return True

    async def _consume_segments(self, man: dict) -> int:
        """Fetch + apply whatever the manifest says is available past the
        cursor; returns records applied."""
        segs = {s["seq"]: s for s in man.get("segments", ())}
        applied = 0
        if self._cursor_seq == 0:
            if not segs:
                return 0
            self._cursor_seq = min(segs)
            self._cursor_off = 0
        while True:
            entry = segs.get(self._cursor_seq)
            if entry is None:
                later = sorted(s for s in segs if s > self._cursor_seq)
                if not later:
                    return applied  # nothing new yet
                if self._cursor_off > 0:
                    # mid-segment and the file vanished: reclaimed under
                    # a newer checkpoint while we were tailing it
                    raise ReplicationProtocolError(
                        f"segment seq {self._cursor_seq} reclaimed "
                        f"mid-tail")
                self._cursor_seq = later[0]
                continue
            if self._cursor_off >= int(entry["size"]):
                later = sorted(s for s in segs if s > self._cursor_seq)
                if entry["sealed"] and later:
                    self._cursor_seq, self._cursor_off = later[0], 0
                    continue
                return applied  # drained the open tail
            name = entry["name"]
            data = await self._fetch_artifact("segment", name,
                                              offset=self._cursor_off)
            if not data:
                return applied
            base = self._cursor_off
            if base == 0:
                if len(data) < len(SEGMENT_MAGIC):
                    return applied  # torn header: wait for more bytes
                if not data.startswith(SEGMENT_MAGIC):
                    raise ReplicationProtocolError(
                        f"segment {name}: bad magic")
                records, consumed = parse_frames(data, len(SEGMENT_MAGIC))
            else:
                records, consumed = parse_frames(data, 0)
            if (not records and entry["sealed"]
                    and base + len(data) >= int(entry["size"])
                    and consumed < len(data)):
                # a sealed segment with undecodable remainder can never
                # grow the missing bytes: damaged, not torn
                raise ReplicationProtocolError(
                    f"segment {name}: damaged frame at offset "
                    f"{base + consumed}")
            for rec in records:
                if await self._apply_record(rec):
                    applied += 1
            # `consumed` is relative to the fetched chunk when resuming
            # mid-file (base > 0) and absolute (incl. the magic) on a
            # fresh segment — `base + consumed` is the new raw offset
            # either way, since base is 0 in the fresh case
            self._applied_bytes.inc(consumed, kind="segment")
            new_off = base + consumed if base else consumed
            # mirror the consumed prefix AFTER applying (and after any
            # sidecar landed), never the torn remainder: the mirror only
            # exposes bytes this follower has fully applied
            await self._mirror_append_segment(name, base,
                                              data[:new_off - base])
            self._cursor_off = new_off
            if not records:
                return applied  # torn tail: wait for the next poll

    # -- sync driver ---------------------------------------------------------

    async def sync_once(self, wait: bool = False) -> int:
        """One manifest poll + apply pass (deterministic unit for tests;
        `run()` loops it).  Returns records applied."""
        self.stats["polls"] += 1
        man = await self._fetch_manifest(wait=wait)
        if (self.bootstrapped
                and man.get("leader_id", "") != self._boot_leader_id):
            # a restarted (or replaced) leader restarts its segment
            # seqs: the byte cursor is meaningless against the new log
            await self._rebootstrap(
                f"leader incarnation changed "
                f"({self._boot_leader_id} -> {man.get('leader_id')})")
            man = await self._fetch_manifest(wait=False)
        if not self.bootstrapped:
            await self._bootstrap(man)
            if not self.bootstrapped:
                return 0  # awaiting a leader checkpoint
            man = await self._fetch_manifest(wait=False)
        try:
            applied = await self._consume_segments(man)
        except (ReplicationProtocolError, TornFrameError) as e:
            await self._rebootstrap(str(e))
            applied = 0
            if self.bootstrapped:
                # catch up in the same pass (a second protocol error
                # propagates to run()'s backoff rather than looping)
                man = await self._fetch_manifest(wait=False)
                applied = await self._consume_segments(man)
        self._note_progress()
        self._last_success = time.monotonic()
        if self.bootstrapped:
            self.state = STATE_STREAMING
        return applied

    def _next_backoff(self, current: float) -> tuple:
        """(jittered sleep, next backoff): the sleep is drawn uniformly
        from [current/2, current) so a restarted leader sees its fleet's
        retries de-correlate instead of thundering back in lockstep;
        the deterministic component doubles up to the cap."""
        sleep_s = current * (0.5 + self._rng.random() * 0.5)
        return sleep_s, min(current * 2.0, self.retry_backoff_cap_s)

    async def run(self) -> None:
        """Tail forever; leader outages degrade (keep serving local
        reads at the last applied revision) and retry with jittered
        exponential backoff."""
        backoff = self.retry_backoff_s
        while True:
            try:
                await self.sync_once(wait=self.bootstrapped)
                backoff = self.retry_backoff_s
                if not self.bootstrapped:
                    # un-bootstrapped polls don't long-poll (there is
                    # no revision to wait past): pace them with jitter,
                    # or an awaiting-checkpoint fleet hammers the leader
                    # in lockstep
                    sleep_s, _ = self._next_backoff(self.retry_backoff_s)
                    await asyncio.sleep(sleep_s)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self.stats["poll_errors"] += 1
                if self.bootstrapped:
                    self.state = STATE_DEGRADED
                sleep_s, backoff = self._next_backoff(backoff)
                logger.warning("replication poll failed (%s); retrying in "
                               "%.1fs", e, sleep_s)
                await asyncio.sleep(sleep_s)

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self.run())

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    def snapshot(self) -> dict:
        """/debug/replication payload (follower role)."""
        return {"role": "follower", "state": self.state,
                "replica_id": self.replica_id,
                "leader_id": self.leader_id,
                "incarnation": self.max_incarnation,
                "upstream": self.upstream_url,
                "upstream_path": list(self.upstream_chain.get("path") or ()),
                "leader_revision": self.leader_revision,
                "applied_revision": self.store.revision,
                "lag_revisions": self.lag_revisions(),
                "lag_seconds": round(self.lag_seconds(), 3),
                "cursor": {"seq": self._cursor_seq,
                           "offset": self._cursor_off},
                "mirror_dir": self.mirror_dir,
                **self.stats}
