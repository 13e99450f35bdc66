"""Leader side of WAL-shipping replication: the ReplicationHub.

Serves the persistence data dir over the proxy's authenticated HTTP
surface (routes wired in proxy/server.py):

    GET /replication/manifest
        {"revision": N, "checkpoint": {...MANIFEST.json...} | null,
         "segments": [{"name", "seq", "size", "sealed"}...],
         "sidecars": ["snap-*.npz"...], "leader_id": "...",
         "incarnation": E, "fenced": {...} | null,
         "chain": {"path": [...], "lag_revisions": 0, "lag_seconds": 0}}
        ?wait_revision=R&timeout_ms=T long-polls until the store's
        revision EXCEEDS R (or the timeout lapses — the caller gets the
        current manifest either way and decides from `revision`).

    GET /replication/segment/<name>[?offset=N]
        Raw bytes of a WAL segment or bulk-load snapshot sidecar from
        byte N (also honors `Range: bytes=N-`).  206 on a partial
        serve, 404 when reclaimed — the follower's signal to
        re-bootstrap from the newest checkpoint.

    GET /replication/checkpoint/<name>
        Raw bytes of a columnar checkpoint file.

Names are validated against the exact artifact patterns before touching
the filesystem (no traversal).  The long-poll is fed by the store's
commit-listener hook: the hub attaches AFTER the PersistenceManager, so
by WAL-before-visibility ordering every revision a waiter is woken for
is already on disk and replayable.

Incarnation fencing: every hub owns a monotonic integer **incarnation
epoch**, persisted in the data dir's INCARNATION file.  A restart in
place mints `persisted + 1`; a promotion (failover.py) mints
`max(persisted, observed) + 2`, so it strictly dominates any later
resurrection mint of the dead leader (which can only reach
`observed + 1`).  Followers reject manifests from a lower epoch than the
highest they have seen, and echo that highest epoch back on every poll
(`X-Replication-Incarnation`): a resurrected ex-leader that receives a
poll carrying a newer epoch marks itself `fenced_by`, and the server
then rejects its update verbs 503 and (with peers configured) demotes
it into a follower of the new leader.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import threading
import time
import uuid
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from ...utils import metrics as m
from ...utils.failpoints import fail_point
from ..store import TupleStore

_SAFE_NAME = re.compile(
    r"^(seg-\d{8}\.wal|snap-\d{12}\.npz|ckpt-\d{12}\.npz)$")

DEFAULT_LONGPOLL_S = 25.0
MAX_LONGPOLL_S = 60.0

# fencing exchange headers: followers echo the highest incarnation (and
# its leader id) they have ever observed on every /replication request
INCARNATION_HEADER = "X-Replication-Incarnation"
LEADER_ID_HEADER = "X-Replication-Leader-Id"

INCARNATION_FILE = "INCARNATION"


def safe_artifact_name(name: str) -> bool:
    """True when `name` is exactly one WAL segment / sidecar / checkpoint
    file name — the only paths the hub will ever read."""
    return bool(_SAFE_NAME.match(name))


# -- incarnation epoch persistence -------------------------------------------


def read_incarnation_state(data_dir: str) -> dict:
    """{"epoch": int, "fenced": {...}|None, "leader_ids": [...]} from
    the data dir's INCARNATION file; zeros when absent/damaged (a
    damaged epoch file only costs an extra re-bootstrap downstream —
    epochs restart conservatively low and fencing rejects them).
    `leader_ids` is the lineage of hub ids this data dir has served
    under — a rejoining ex-leader recognizes "the promotion superseded
    MY log" by the new leader's `fenced.leader_id` appearing here, even
    across its own restarts (each of which mints a fresh id)."""
    try:
        with open(os.path.join(data_dir, INCARNATION_FILE), "rb") as f:
            data = json.loads(f.read())
        if isinstance(data, dict) and isinstance(data.get("epoch"), int):
            return {"epoch": data["epoch"], "fenced": data.get("fenced"),
                    "leader_ids": list(data.get("leader_ids") or ())}
    except (OSError, ValueError):
        pass
    return {"epoch": 0, "fenced": None, "leader_ids": []}


def write_incarnation_state(data_dir: str, epoch: int,
                            fenced: Optional[dict],
                            leader_ids: Optional[list] = None) -> None:
    path = os.path.join(data_dir, INCARNATION_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"epoch": int(epoch), "fenced": fenced,
                   # bounded lineage: old entries can only matter while
                   # a promotion that superseded them is still live
                   "leader_ids": list(leader_ids or ())[-16:]}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def mint_restart_incarnation(data_dir: str, leader_id: str) -> tuple:
    """Restart-in-place mint: persisted + 1.  Returns (epoch, fenced)
    with any previously-recorded fenced info preserved, so a restarted
    promoted leader keeps advertising which log it superseded (rejoining
    ex-leaders bound their tail replay from it)."""
    state = read_incarnation_state(data_dir)
    epoch = state["epoch"] + 1
    write_incarnation_state(data_dir, epoch, state["fenced"],
                            state["leader_ids"] + [leader_id])
    return epoch, state["fenced"]


def mint_promotion_incarnation(data_dir: str, observed: int,
                               fenced: Optional[dict]) -> int:
    """Promotion mint: max(persisted, observed) + 2.  The +2 (against the
    restart path's +1) makes a promotion epoch strictly dominate the
    epoch a later resurrection of the dead leader can mint (its
    persisted value is what this follower `observed`, so it resurrects
    at observed + 1 < observed + 2): no tie, no split brain."""
    state = read_incarnation_state(data_dir)
    epoch = max(state["epoch"], int(observed)) + 2
    write_incarnation_state(data_dir, epoch, fenced,
                            state["leader_ids"])
    return epoch


def append_leader_lineage(data_dir: str, leader_id: str) -> None:
    """Record `leader_id` in the data dir's hub-id lineage (a promotion
    constructs its hub after minting the epoch)."""
    state = read_incarnation_state(data_dir)
    write_incarnation_state(data_dir, state["epoch"], state["fenced"],
                            state["leader_ids"] + [leader_id])


def leader_lineage(data_dir: str) -> list:
    return read_incarnation_state(data_dir)["leader_ids"]


# -- shared artifact byte serving --------------------------------------------


async def serve_artifact_file(req, path: str, kind: str,
                              shipped_counter, stats: dict) -> "Response":
    """Serve one artifact file's bytes with offset/Range semantics:
    shared by the leader hub and the follower fan-out hub (failover.py),
    so a relay serves byte-identical responses to the leader's."""
    from ...proxy.httpcore import Response, json_response
    params = parse_qs(urlsplit(req.target).query)
    offset = 0
    raw_off = (params.get("offset") or ["0"])[0]
    range_hdr = req.headers.get("Range")
    try:
        offset = int(raw_off)
        if range_hdr:
            mm = re.match(r"^bytes=(\d+)-$", range_hdr.strip())
            if mm is None:
                raise ValueError(f"unsupported Range {range_hdr!r}")
            offset = int(mm.group(1))
    except ValueError as e:
        return json_response(400, {
            "kind": "Status", "apiVersion": "v1", "metadata": {},
            "status": "Failure", "code": 400, "message": str(e)})

    def _read():
        # a sealed segment is up to segment_bytes and a checkpoint
        # tens of MB — reading it synchronously would park the
        # serving event loop for the whole disk read, once per
        # follower fetch; the read runs on an executor thread
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            if offset:
                f.seek(offset)
            return size, f.read()

    try:
        size, body = await asyncio.get_running_loop().run_in_executor(
            None, _read)
    except OSError:
        return json_response(404, {
            "kind": "Status", "apiVersion": "v1", "metadata": {},
            "status": "Failure", "reason": "NotFound", "code": 404,
            "message": f"artifact {os.path.basename(path)!r} is gone "
                       f"(reclaimed by a checkpoint?); re-bootstrap "
                       f"from /replication/manifest"})
    shipped_counter.inc(len(body), kind=kind)
    stats[f"{kind}_serves"] = stats.get(f"{kind}_serves", 0) + 1
    resp = Response(status=206 if offset else 200, body=body)
    resp.headers.set("Content-Type", "application/octet-stream")
    resp.headers.set("X-Replication-Offset", str(offset))
    resp.headers.set("X-Replication-Size", str(size))
    return resp


# switch off = no hub exists (the server 503s /replication/* without
# constructing/attaching one), so nothing here can tick
class ReplicationHub:
    """Publishes one PersistenceManager's data dir to followers."""

    def __init__(self, store: TupleStore, persistence,
                 leader_id: str = "",
                 incarnation: int = 0,
                 fenced: Optional[dict] = None,
                 registry: Optional[m.Registry] = None):
        self.store = store
        self.persistence = persistence
        # unique per INCARNATION, not per host: segment seqs restart
        # after a leader restart (reclaim empties the wal dir), so a
        # follower must detect "same name, different log" by the id
        # changing and re-bootstrap rather than resume its byte cursor
        self.leader_id = (leader_id
                          or f"leader-{os.getpid()}-{uuid.uuid4().hex[:8]}")
        # monotonic fencing epoch: a promotion passes its explicit
        # epoch; a plain construction mints restart-in-place from the
        # data dir's INCARNATION file
        data_dir = getattr(persistence, "data_dir", None)
        if incarnation > 0:
            self.incarnation = int(incarnation)
            self.fenced = fenced
            if data_dir:
                append_leader_lineage(data_dir, self.leader_id)
        elif data_dir:
            self.incarnation, persisted_fenced = mint_restart_incarnation(
                data_dir, self.leader_id)
            self.fenced = fenced if fenced is not None else persisted_fenced
        else:  # persistence-less construction (unit tests)
            self.incarnation = 1
            self.fenced = fenced
        # set once a /replication poll proves a newer
        # incarnation exists: {"incarnation": E, "leader_id": id}.  The
        # server refuses update verbs while fenced — a resurrected
        # ex-leader must never take a write the fleet won't see.
        self.fenced_by: Optional[dict] = None
        # (loop, future) pairs parked in wait_for_revision; woken from
        # the commit listener via call_soon_threadsafe (the listener runs
        # under the store lock — it must only schedule, never block)
        self._waiters: list = []
        self._waiters_lock = threading.Lock()
        self._attached = False
        self.stats = {"manifest_serves": 0, "longpoll_waits": 0,
                      "segment_serves": 0, "checkpoint_serves": 0,
                      "fenced_polls": 0}
        registry = registry or m.REGISTRY
        self._shipped = registry.counter(
            "authz_replication_shipped_bytes_total",
            "Bytes of WAL segments / sidecars / checkpoints served to "
            "replication followers, by artifact kind",
            labels=("kind",))
        self._fenced_total = registry.counter(
            "authz_replication_fenced_total",
            "Incarnation-fencing events: stage=leader when this leader "
            "observed a newer incarnation and fenced itself, "
            "stage=follower when a follower rejected a stale leader's "
            "manifest", labels=("stage",))
        import weakref
        ref = weakref.ref(self)
        registry.gauge(
            "authz_replication_incarnation",
            "Current replication incarnation epoch (leader: own epoch; "
            "follower: highest epoch observed)",
            callback=lambda: (float(ref().incarnation)
                              if ref() is not None else 0.0))

    # -- commit hook ---------------------------------------------------------

    def attach(self) -> None:
        """Start waking long-poll waiters on commits.  Call AFTER the
        PersistenceManager attached: listener order is append order, so
        the WAL append precedes the wakeup for every commit."""
        if not self._attached:
            self.store.add_commit_listener(self._on_commit)
            self._attached = True

    def detach(self) -> None:
        if self._attached:
            self.store.remove_commit_listener(self._on_commit)
            self._attached = False

    def _on_commit(self, kind: str, revision: int, payload) -> None:
        # under the store lock — schedule only.  The waiter re-checks the
        # store revision on its own loop, which cannot run before this
        # commit completes and the new revision is reader-visible.
        with self._waiters_lock:
            waiters, self._waiters = self._waiters, []
        for loop, fut in waiters:
            try:
                loop.call_soon_threadsafe(self._resolve, fut)
            except RuntimeError:
                pass  # waiter's loop already closed

    @staticmethod
    def _resolve(fut) -> None:
        if not fut.done():
            fut.set_result(None)

    async def wait_for_revision(self, min_exclusive: int,
                                timeout_s: float) -> bool:
        """Park until store.revision > min_exclusive (True) or the
        timeout lapses (False)."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        loop = asyncio.get_running_loop()
        while self.store.revision <= min_exclusive:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            fut = loop.create_future()
            with self._waiters_lock:
                self._waiters.append((loop, fut))
            # re-check AFTER publishing the waiter: a commit landing
            # between the loop-condition read and the append above has
            # already drained the (then-empty) waiter list — without
            # this, that waiter sleeps the full timeout on a revision
            # that is long since visible
            if self.store.revision > min_exclusive:
                with self._waiters_lock:
                    try:
                        self._waiters.remove((loop, fut))
                    except ValueError:
                        pass
                return True
            try:
                await asyncio.wait_for(fut, remaining)
            except asyncio.TimeoutError:
                return self.store.revision > min_exclusive
            finally:
                with self._waiters_lock:
                    try:
                        self._waiters.remove((loop, fut))
                    except ValueError:
                        pass
        return True

    # -- fencing -------------------------------------------------------------

    def note_fenced(self, incarnation: int, leader_id: str) -> None:
        """Record that a strictly newer incarnation exists.  Idempotent;
        only the first observation (per newer epoch) counts a fencing
        event."""
        cur = self.fenced_by
        if cur is not None and cur["incarnation"] >= incarnation:
            return
        self.fenced_by = {"incarnation": int(incarnation),
                          "leader_id": leader_id}
        self._fenced_total.inc(stage="leader")

    def observe_poll_headers(self, req) -> None:
        """Fencing exchange: a follower's poll echoes the highest
        incarnation it has seen.  Newer than ours — or an epoch tie
        under a LARGER leader id (two sides of a partition promoting
        simultaneously mint the same epoch; the total order on
        (incarnation, leader_id) makes exactly one of them lose) =>
        we are superseded."""
        raw = req.headers.get(INCARNATION_HEADER)
        if not raw:
            return
        try:
            peer_inc = int(raw)
        except ValueError:
            return
        peer_lid = req.headers.get(LEADER_ID_HEADER)
        if peer_inc > self.incarnation or (
                peer_inc == self.incarnation
                and peer_lid and peer_lid > self.leader_id):
            self.stats["fenced_polls"] += 1
            self.note_fenced(peer_inc, peer_lid or "")

    # -- manifest ------------------------------------------------------------

    def manifest(self) -> dict:
        from ..persist import checkpoint as ckpt
        wal = self.persistence.wal
        segments = []
        for seq in wal.segment_seqs():
            path = wal._path(seq)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue  # reclaimed between listdir and stat
            segments.append({
                "name": os.path.basename(path), "seq": seq, "size": size,
                # the open segment keeps growing; anything else is sealed
                "sealed": not (seq == wal._cur_seq
                               and wal._cur_file is not None),
            })
        sidecars = []
        try:
            for name in sorted(os.listdir(wal.dir)):
                if re.match(r"^snap-\d{12}\.npz$", name):
                    sidecars.append(name)
        except OSError:
            pass
        self.stats["manifest_serves"] += 1
        return {
            "leader_id": self.leader_id,
            "incarnation": self.incarnation,
            # which log this incarnation superseded at a promotion (None
            # for a plain leader): a rejoining ex-leader whose id matches
            # bounds its unshipped-tail replay at `revision`
            "fenced": self.fenced,
            "revision": self.store.revision,
            "checkpoint": ckpt.read_manifest(self.persistence.data_dir),
            "segments": segments,
            "sidecars": sidecars,
            # the reference's manifest fields for fan-out chains and its
            # followers' clock-skew estimate, kept so its followers read
            # a port leader as their own: the leader is a chain's root
            # (zero lag), and the stamp is taken as the response is built
            "chain": {"path": [self.leader_id],
                      "lag_revisions": 0.0, "lag_seconds": 0.0},
            "server_time_unix": time.time(),
        }

    async def serve_manifest(self, req) -> "Response":
        from ...proxy.httpcore import json_response
        fail_point("replServeManifest")
        self.observe_poll_headers(req)
        params = parse_qs(urlsplit(req.target).query)
        wait_raw = (params.get("wait_revision") or [""])[0]
        if wait_raw:
            try:
                wait_rev = int(wait_raw)
                timeout_ms = float(
                    (params.get("timeout_ms")
                     or [str(DEFAULT_LONGPOLL_S * 1e3)])[0])
            except ValueError:
                return json_response(400, {
                    "kind": "Status", "apiVersion": "v1", "metadata": {},
                    "status": "Failure", "code": 400,
                    "message": "wait_revision/timeout_ms must be integers"})
            self.stats["longpoll_waits"] += 1
            await self.wait_for_revision(
                wait_rev, min(max(timeout_ms / 1e3, 0.0), MAX_LONGPOLL_S))
        return json_response(200, self.manifest())

    # -- artifact bytes ------------------------------------------------------

    async def serve_segment(self, req, name: str) -> "Response":
        from ...proxy.httpcore import json_response
        fail_point("replServeSegment")
        self.observe_poll_headers(req)
        if not safe_artifact_name(name) or name.startswith("ckpt-"):
            return json_response(400, {
                "kind": "Status", "apiVersion": "v1", "metadata": {},
                "status": "Failure", "code": 400,
                "message": f"invalid segment name {name!r}"})
        return await serve_artifact_file(
            req, os.path.join(self.persistence.wal.dir, name), "segment",
            self._shipped, self.stats)

    async def serve_checkpoint(self, req, name: str) -> "Response":
        from ...proxy.httpcore import json_response
        self.observe_poll_headers(req)
        if not safe_artifact_name(name) or not name.startswith("ckpt-"):
            return json_response(400, {
                "kind": "Status", "apiVersion": "v1", "metadata": {},
                "status": "Failure", "code": 400,
                "message": f"invalid checkpoint name {name!r}"})
        return await serve_artifact_file(
            req, os.path.join(self.persistence.ckpt_dir, name), "checkpoint",
            self._shipped, self.stats)

    def snapshot(self) -> dict:
        """/debug/replication payload (leader role)."""
        with self._waiters_lock:
            waiters = len(self._waiters)
        man = self.manifest()
        return {"role": "leader", "leader_id": self.leader_id,
                "incarnation": self.incarnation,
                "fenced": self.fenced,
                "fenced_by": self.fenced_by,
                "revision": man["revision"],
                "checkpoint_revision": (man["checkpoint"] or {}).get(
                    "revision"),
                "segments": man["segments"],
                "longpoll_waiters": waiters,
                **self.stats}
