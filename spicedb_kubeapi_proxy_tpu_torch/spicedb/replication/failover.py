"""Replication fault tolerance: leader failover, incarnation fencing,
follower fan-out trees (reference spicedb/replication/failover.py).

Three cooperating pieces, all behind the `REPLICATION` switch:

- **Promotion** (`promote_follower`): a bootstrapped follower becomes
  the leader — it mints a promotion incarnation epoch (strictly
  dominating any later resurrection of the dead leader, see
  leader.mint_promotion_incarnation), attaches a fresh
  PersistenceManager over its `--promote-data-dir` (journaling every
  commit from here on), anchors an initial checkpoint at the adopted
  revision so the rest of the fleet (and the rejoining ex-leader) can
  bootstrap, and starts serving `/replication/*` as the new log.
  Promotion adopts exactly the follower's applied revision — the
  highest *durably shipped* revision — never guessing at writes that
  may or may not have survived on the dead leader's disk.

- **Demotion + rejoin** (`demote_and_rejoin`): a resurrected ex-leader
  that learns of a newer incarnation (via a follower's poll headers or
  a `FenceMonitor` peer probe) steps down instead of split-braining:
  it bounds its unshipped WAL tail using the new leader's `fenced`
  manifest marker (records past the revision the promotion adopted),
  re-bootstraps its live store from the new leader as an ordinary
  follower, and replays that tail through `/replication/rejoin` as
  forwarded writes — the dual-write idempotency-key tuples make
  replays converge, and plain TOUCH/DELETE records re-apply
  idempotently.  Acknowledged writes are therefore never lost: either
  they shipped before the crash (the promotion adopted them) or they
  ride the rejoin replay.

- **Election** (`LeaderLossWatchdog`, `--promote-on-leader-loss`): each
  follower watches its own sync health; after `--leader-loss-grace`
  seconds without a successful pass it polls its `--replica-peers` for
  `/replication/status` and applies the decision rule *highest adopted
  revision wins, ties break on smallest replica id*.  The winner
  promotes itself; losers defer, then repoint to whoever shows up as a
  leader with a newer incarnation.  Unreachable peers simply don't
  vote — they are dead or on the wrong side of the partition.

`FanoutHub` is the fan-out tree piece: a follower running with
`--serve-replication` spools every artifact byte it applies into a
data-dir-shaped mirror (follower.py), and this hub serves that mirror
with the exact protocol the leader speaks — manifest long-poll included
— so N leaf followers chain off intermediates instead of NIC-saturating
one leader.  Incarnation and leader id pass through unchanged (it is
the leader's log), and the manifest's `chain` block accumulates hop
lags and the hub-id path down the tree.
"""

from __future__ import annotations

import asyncio
import logging
import os
import re
import time
from typing import Optional

from ...utils import metrics as m
from ...utils.failpoints import fail_point
from .follower import ReplicaFollower
from .leader import (
    ReplicationHub,
    mint_promotion_incarnation,
    serve_artifact_file,
)

logger = logging.getLogger("spicedb_kubeapi_proxy_tpu_torch.replication")

_SEG_NAME = re.compile(r"^seg-(\d{8})\.wal$")
_SNAP_NAME = re.compile(r"^snap-\d{12}\.npz$")

# rejoin replay batch size (well under the store's per-write limit)
REJOIN_BATCH = 500


class PromotionError(Exception):
    """A promotion / demotion precondition failed; carries the HTTP
    status the server should answer with."""

    def __init__(self, message: str, status: int = 503):
        self.status = status
        super().__init__(message)


def _promotions() -> "m.Counter":
    return m.REGISTRY.counter(
        "authz_replication_promotions_total",
        "Leader-failover promotions completed by this process")


def _rejoin_records() -> "m.Counter":
    return m.REGISTRY.counter(
        "authz_replication_rejoin_records_total",
        "Unshipped WAL tail updates an ex-leader replayed into the new "
        "leader while rejoining as a follower")


async def _peer_json(transport, identity: str, method: str, target: str,
                     body: Optional[dict] = None) -> dict:
    """One authenticated JSON round trip to a peer proxy."""
    import json
    from ...proxy.httpcore import Headers, Request
    from ...utils import tracing
    h = Headers([("Accept", "application/json"),
                 ("X-Remote-User", identity)])
    # fleet tracing: election, fence and repoint control calls carry
    # provenance too (none when propagation is switched off)
    for pk, pv in tracing.propagation_headers(
            default_tier="follower").items():
        h.set(pk, pv)
    data = b""
    if body is not None:
        data = json.dumps(body).encode()
        h.set("Content-Type", "application/json")
    resp = await transport.round_trip(Request(
        method=method, target=target, headers=h, body=data))
    if resp.status not in (200, 201):
        raise ConnectionError(
            f"{method} {target} -> HTTP {resp.status}: "
            f"{resp.body[:200]!r}")
    return json.loads(resp.body) if resp.body else {}


# -- promotion ---------------------------------------------------------------


async def promote_follower(server) -> dict:
    """Promote `server` (a bootstrapped follower) to leader.  Atomic
    from the caller's view: any failure inside the critical section
    rolls back to an intact follower (the tail task restarts if it was
    running).  Returns {leader_id, incarnation, revision,
    promoted_from}."""
    from . import enabled as replication_enabled
    if not replication_enabled():
        raise PromotionError("Replication feature gate is disabled", 503)
    async with server._promote_lock:
        repl = server.replication
        if repl is None:
            if server.replication_hub is not None:
                raise PromotionError("already the leader", 409)
            raise PromotionError(
                "not a replication follower (nothing to promote)", 503)
        if not repl.ever_bootstrapped:
            raise PromotionError(
                "no adopted state to promote (still bootstrapping)", 503)
        promote_dir = server.opts.promote_data_dir
        if not promote_dir:
            raise PromotionError(
                "--promote-data-dir is not configured on this follower",
                503)
        was_running = repl._task is not None and not repl._task.done()
        await repl.stop()
        fanout = server.fanout_hub
        if fanout is not None:
            # retire the fan-out relay NOW: its mirror belongs to the
            # superseded upstream log, and parked downstream long-polls
            # must wake immediately — their next poll reaches the
            # successor hub (or a clean 503 during the build) instead of
            # stalling a full poll window on a stopped tail
            server.fanout_hub = None
            fanout.close()
        loop = asyncio.get_running_loop()
        store = repl.store
        old_id = repl.max_leader_id or repl._boot_leader_id or repl.leader_id
        # the fencing marker the new manifest carries: which log this
        # incarnation superseded, and the exact revision the promotion
        # adopted (the highest durably SHIPPED revision) — a rejoining
        # ex-leader bounds its unshipped-tail replay at this revision
        fenced = {"leader_id": old_id,
                  "incarnation": repl.max_incarnation,
                  "revision": store.revision}
        persistence = None
        hub = None
        try:
            def _build():
                import shutil
                from ..persist import PersistenceManager
                from ..persist import checkpoint as ckpt
                # wipe artifacts from any OLDER promotion of this node
                # (they belong to a superseded incarnation); the
                # INCARNATION file stays — it is the epoch source
                os.makedirs(promote_dir, exist_ok=True)
                for sub in ("wal", ckpt.CHECKPOINT_DIR):
                    shutil.rmtree(os.path.join(promote_dir, sub),
                                  ignore_errors=True)
                try:
                    os.unlink(os.path.join(promote_dir, ckpt.MANIFEST_NAME))
                except OSError:
                    pass
                epoch = mint_promotion_incarnation(
                    promote_dir, repl.max_incarnation, fenced)
                p = PersistenceManager(
                    promote_dir, fsync=server.opts.wal_fsync,
                    checkpoint_interval=server.opts.checkpoint_interval)
                return epoch, p

            epoch, persistence = await loop.run_in_executor(None, _build)
            persistence.attach(store)
            fail_point("replPromote")
            # anchor checkpoint at the adopted revision: new followers
            # and the rejoining ex-leader bootstrap from it immediately
            # (a revision-0 promotion skips it; followers then anchor
            # at revision 0 exactly as against a fresh leader)
            await loop.run_in_executor(None, persistence.checkpoint)
            hub = ReplicationHub(store, persistence, incarnation=epoch,
                                 fenced=fenced)
            hub.attach()
        except BaseException:
            # roll back to an intact follower: promotion either
            # completes or changes nothing
            if hub is not None:
                hub.detach()
            if persistence is not None:
                persistence.detach()
                persistence.wal.close()
            if fanout is not None:
                # restore the relay over the same mirror (cheap: a
                # fresh hub just re-registers the progress listener)
                server.fanout_hub = FanoutHub(repl, fanout.mirror_dir)
            if was_running:
                repl.start()
            raise
        server.replication_hub = hub
        server.persistence = persistence
        server.replication = None
        if server._http is not None:
            await persistence.start()
        _promotions().inc()
        logger.warning(
            "promoted to leader: incarnation %d at revision %d "
            "(superseding %s at shipped revision %d)",
            epoch, store.revision, old_id, fenced["revision"])
        return {"leader_id": hub.leader_id, "incarnation": epoch,
                "revision": store.revision, "promoted_from": old_id}


# -- demotion + rejoin -------------------------------------------------------


def collect_unshipped_tail(persistence, store, from_revision: int) -> tuple:
    """(updates, skipped, reclaimed_window): every acknowledged update
    past `from_revision` as [op, rel_string] pairs — the writes the dead
    leader acknowledged but never shipped.

    Normally the live WAL carries the whole stream.  But a pre-crash
    checkpoint may have RECLAIMED segments covering part of the window
    (wal.reclaim deletes sealed segments the checkpoint covers): the
    record stream for (from_revision, checkpoint_revision] is gone from
    disk.  The surviving EFFECTS are still in the recovered `store`, so
    in that case the export is every live tuple written after
    `from_revision` as a TOUCH (store.relationships_since) plus the
    DELETE records the remaining WAL tail still carries.  Deletes whose
    records fell inside the reclaimed window are unrecoverable as a
    stream — `reclaimed_window` is True so the caller logs the bound.
    Mass-change records (snapshot sidecar / delete_all) past the
    watermark cannot be replayed as forwarded writes and are counted in
    `skipped`."""
    from ..persist import checkpoint as ckpt
    man = ckpt.read_manifest(persistence.data_dir) or {}
    ckpt_rev = int(man.get("revision", 0) or 0)
    updates: list = []
    skipped = 0
    if ckpt_rev > from_revision:
        from ..types import parse_relationship
        since = store.relationships_since(from_revision)
        updates.extend(["t", rel.rel_string()] for rel in since)
        live_keys = {rel.key() for rel in since}
        deletes = []
        for rec in persistence.wal.replay():
            if int(rec["r"]) <= from_revision:
                continue
            kind = rec["k"]
            if kind == "d":
                for op, s in rec.get("u", ()):
                    if op != "d":
                        continue
                    # a delete later re-touched is live in the final
                    # state: exporting both (touch set + raw delete)
                    # would wrongly end deleted — final state wins
                    try:
                        if parse_relationship(s).key() in live_keys:
                            continue
                    except ValueError:
                        pass
                    deletes.append(["d", s])
            elif kind not in ("d", "b"):
                skipped += 1
        updates.extend(deletes)  # final-state touches, then tail deletes
        return updates, skipped, True
    for rec in persistence.wal.replay():
        if int(rec["r"]) <= from_revision:
            continue
        kind = rec["k"]
        if kind == "d":
            updates.extend([op, s] for op, s in rec.get("u", ()))
        elif kind == "b":
            updates.extend(["t", s] for s in rec.get("u", ()))
        else:
            skipped += 1
    return updates, skipped, False


async def demote_and_rejoin(server, leader_url: str, transport) -> dict:
    """Step a fenced (or about-to-be-fenced) ex-leader down into a
    follower of the proxy at `leader_url`, replaying its unshipped WAL
    tail through /replication/rejoin so no acknowledged write is lost.
    Returns {replayed, skipped_records, leader, incarnation}."""
    from . import enabled as replication_enabled
    if not replication_enabled():
        raise PromotionError("Replication feature gate is disabled", 503)
    hub = server.replication_hub
    if hub is None:
        raise PromotionError("not a leader (nothing to demote)", 409)
    identity = server.opts.replica_user
    man = await _peer_json(transport, identity, "GET",
                           "/replication/manifest")
    new_inc = int(man.get("incarnation", 0) or 0)
    if new_inc <= hub.incarnation and hub.fenced_by is None:
        raise PromotionError(
            f"refusing demotion: {leader_url} serves incarnation "
            f"{new_inc}, not newer than own {hub.incarnation}", 409)
    fen = man.get("fenced") or {}
    tail: list = []
    skipped = 0
    reclaimed = False
    # "the promotion superseded MY log": the new leader's fenced marker
    # names the hub id the promoting follower was tailing — any id in
    # this data dir's lineage, even across our own restarts (each mints
    # a fresh id)
    from .leader import leader_lineage
    lineage = set(leader_lineage(server.persistence.data_dir)
                  if server.persistence is not None else ())
    lineage.add(hub.leader_id)
    if fen.get("leader_id") in lineage:
        try:
            tail, skipped, reclaimed = \
                await asyncio.get_running_loop().run_in_executor(
                    None, collect_unshipped_tail, server.persistence,
                    hub.store, int(fen.get("revision", 0)))
            if reclaimed:
                logger.warning(
                    "a pre-crash checkpoint reclaimed WAL segments past "
                    "shipped revision %s: replaying the surviving "
                    "EFFECTS (%d touch/delete updates) instead of the "
                    "exact stream; deletes inside the reclaimed window "
                    "cannot be replayed", fen.get("revision"), len(tail))
        except Exception:
            logger.exception(
                "could not read the local WAL tail; rejoining without "
                "replay (writes past shipped revision %s may be lost)",
                fen.get("revision"))
    else:
        logger.warning(
            "new leader %s superseded %r, which is not in this data "
            "dir's lineage: cannot bound the unshipped tail, rejoining "
            "without replay", leader_url, fen.get("leader_id"))
    # step down: stop publishing, stop journaling (the old data dir
    # stays on disk as cold history of the superseded log)
    hub.detach()
    persistence = server.persistence
    if persistence is not None:
        await persistence.stop(final_checkpoint=False)
        server.persistence = None
    server.replication_hub = None
    follower = ReplicaFollower(
        hub.store, transport, identity=identity,
        replica_id=server.replica_id, upstream_url=leader_url)
    server.replication = follower
    server._leader_transport = transport
    server.opts.replicate_from = leader_url
    replayed = 0
    try:
        # bootstrap from the new leader (replica_reset works on the
        # non-empty store and fires the reset listeners: device graph /
        # decision cache rebuild from the adopted state)
        await follower.sync_once()
        for i in range(0, len(tail), REJOIN_BATCH):
            batch = tail[i:i + REJOIN_BATCH]
            for attempt in range(3):
                try:
                    resp = await _peer_json(
                        transport, identity, "POST", "/replication/rejoin",
                        body={"from_leader_id": hub.leader_id,
                              "from_incarnation": hub.incarnation,
                              "updates": batch})
                    replayed += int(resp.get("applied", 0))
                    break
                except asyncio.CancelledError:
                    raise
                except Exception:
                    if attempt == 2:
                        raise
                    await asyncio.sleep(0.2 * (attempt + 1))
        if replayed:
            _rejoin_records().inc(replayed)
            # pull our own replayed writes back through the tail
            await follower.sync_once()
    except BaseException:
        # the step-down is done and cannot be unwound (a fenced leader
        # must not resume writes): leave an ALIVE follower behind —
        # its tail task retries forever, so reads keep serving at
        # bounded staleness.  The unreplayed remainder is logged as
        # at-risk; the old data dir remains on disk as cold history.
        if server._http is not None:
            follower.start()
        logger.exception(
            "rejoin to %s interrupted after step-down: %d/%d tail "
            "update(s) replayed; the remainder is preserved in the old "
            "data dir only", leader_url, replayed, len(tail))
        raise
    if server._http is not None:
        follower.start()
    logger.warning(
        "demoted to follower of %s (incarnation %d): replayed %d "
        "unshipped update(s), %d mass-change record(s) skipped%s",
        leader_url, new_inc, replayed, skipped,
        " (checkpoint-reclaimed window: effects replay)" if reclaimed
        else "")
    return {"replayed": replayed, "skipped_records": skipped,
            "reclaimed_window": reclaimed,
            "leader": leader_url, "incarnation": new_inc}


# -- fan-out hub -------------------------------------------------------------


# switch off = no hub exists (the server requires serve_replication AND
# the REPLICATION switch before constructing one)
class FanoutHub:
    """Serves a follower's artifact mirror with the leader's protocol,
    so downstream followers chain off this intermediate."""

    def __init__(self, follower: ReplicaFollower, mirror_dir: str,
                 registry: Optional[m.Registry] = None):
        self.follower = follower
        self.mirror_dir = mirror_dir
        os.makedirs(os.path.join(mirror_dir, "wal"), exist_ok=True)
        from ..persist import checkpoint as ckpt
        os.makedirs(os.path.join(mirror_dir, ckpt.CHECKPOINT_DIR),
                    exist_ok=True)
        follower.mirror_dir = mirror_dir
        self.stats = {"manifest_serves": 0, "longpoll_waits": 0,
                      "segment_serves": 0, "checkpoint_serves": 0}
        self._waiters: list = []
        self._closed = False
        registry = registry or m.REGISTRY
        self._shipped = registry.counter(
            "authz_replication_shipped_bytes_total",
            "Bytes of WAL segments / sidecars / checkpoints served to "
            "replication followers, by artifact kind",
            labels=("kind",))
        follower.add_progress_listener(self._on_progress)

    def close(self) -> None:
        # retire: wake every parked long-poll NOW and refuse to re-park
        # (the while-loop would otherwise re-enqueue a waiter nothing
        # resolves) — downstream followers get their (stale) manifest
        # immediately, and their NEXT poll reaches the successor hub
        # instead of stalling a full poll timeout
        self._closed = True
        self.follower.remove_progress_listener(self._on_progress)
        self._on_progress()

    def _on_progress(self) -> None:
        # runs on the serving loop (follower sync path): resolve plainly
        waiters, self._waiters = self._waiters, []
        for fut in waiters:
            if not fut.done():
                fut.set_result(None)

    async def wait_for_revision(self, min_exclusive: int,
                                timeout_s: float) -> bool:
        deadline = time.monotonic() + max(0.0, timeout_s)
        loop = asyncio.get_running_loop()
        while (not self._closed
               and self.follower.store.revision <= min_exclusive):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            fut = loop.create_future()
            self._waiters.append(fut)
            try:
                await asyncio.wait_for(fut, remaining)
            except asyncio.TimeoutError:
                return self.follower.store.revision > min_exclusive
            finally:
                if fut in self._waiters:
                    self._waiters.remove(fut)
        return self.follower.store.revision > min_exclusive

    def manifest(self) -> dict:
        from ..persist import checkpoint as ckpt
        f = self.follower
        wal_dir = os.path.join(self.mirror_dir, "wal")
        segments = []
        sidecars = []
        try:
            names = sorted(os.listdir(wal_dir))
        except OSError:
            names = []
        for name in names:
            mm = _SEG_NAME.match(name)
            if mm:
                seq = int(mm.group(1))
                try:
                    size = os.path.getsize(os.path.join(wal_dir, name))
                except OSError:
                    continue
                segments.append({
                    "name": name, "seq": seq, "size": size,
                    # the segment at the cursor may still grow as the
                    # upstream tail is consumed; everything below it is
                    # complete in the mirror
                    "sealed": seq < f._cursor_seq,
                })
            elif _SNAP_NAME.match(name):
                sidecars.append(name)
        chain_path = list(f.upstream_chain.get("path") or ())
        self.stats["manifest_serves"] += 1
        return {
            # the log is the LEADER's log: id and incarnation pass
            # through unchanged, so fencing decisions are identical at
            # every depth of the tree
            "leader_id": f.max_leader_id or f.leader_id,
            "incarnation": f.max_incarnation,
            "fenced": None,
            "revision": f.store.revision,
            "checkpoint": ckpt.read_manifest(self.mirror_dir),
            "segments": segments,
            "sidecars": sidecars,
            # chain lag is additive: this follower's lag gauges already
            # include the upstream's reported chain lag
            "chain": {"path": chain_path + [f.replica_id],
                      "lag_revisions": max(0.0, f.lag_revisions()),
                      "lag_seconds": max(0.0, f.lag_seconds())},
            # THIS hub's wall clock (not the root leader's): the skew a
            # chained follower estimates is per-hop, matching the
            # per-hop chain lag it inherits
            "server_time_unix": time.time(),
        }

    async def serve_manifest(self, req) -> "Response":
        from urllib.parse import parse_qs, urlsplit
        from ...proxy.httpcore import json_response
        params = parse_qs(urlsplit(req.target).query)
        wait_raw = (params.get("wait_revision") or [""])[0]
        if wait_raw:
            from .leader import DEFAULT_LONGPOLL_S, MAX_LONGPOLL_S
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

    async def serve_segment(self, req, name: str) -> "Response":
        from ...proxy.httpcore import json_response
        from .leader import safe_artifact_name
        if not safe_artifact_name(name) or name.startswith("ckpt-"):
            return json_response(400, {
                "kind": "Status", "apiVersion": "v1", "metadata": {},
                "status": "Failure", "code": 400,
                "message": f"invalid segment name {name!r}"})
        return await serve_artifact_file(
            req, os.path.join(self.mirror_dir, "wal", name), "segment",
            self._shipped, self.stats)

    async def serve_checkpoint(self, req, name: str) -> "Response":
        from ...proxy.httpcore import json_response
        from ..persist import checkpoint as ckpt
        from .leader import safe_artifact_name
        if not safe_artifact_name(name) or not name.startswith("ckpt-"):
            return json_response(400, {
                "kind": "Status", "apiVersion": "v1", "metadata": {},
                "status": "Failure", "code": 400,
                "message": f"invalid checkpoint name {name!r}"})
        return await serve_artifact_file(
            req,
            os.path.join(self.mirror_dir, ckpt.CHECKPOINT_DIR, name),
            "checkpoint", self._shipped, self.stats)

    def snapshot(self) -> dict:
        return {"serves_replication": True,
                "mirror_dir": self.mirror_dir,
                "longpoll_waiters": len(self._waiters),
                **self.stats}


# -- leader-loss watchdog (follower side) ------------------------------------


class LeaderLossWatchdog:
    """`--promote-on-leader-loss`: detect a dead upstream and run the
    election (highest adopted revision wins; ties break on the smallest
    replica id)."""

    def __init__(self, server, grace_s: float = 5.0,
                 interval_s: float = 0.0):
        self.server = server
        self.grace_s = grace_s
        self.interval_s = interval_s or max(0.05, grace_s / 4.0)
        self.stats = {"checks": 0, "elections": 0, "deferrals": 0,
                      "repoints": 0, "promotions": 0}
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                if await self.check_once() == "promoted":
                    return  # now the leader: nothing left to watch
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("leader-loss watchdog pass failed")

    async def check_once(self) -> str:
        repl = self.server.replication
        if repl is None:
            return "promoted"
        self.stats["checks"] += 1
        if repl.seconds_since_success() < self.grace_s:
            return "healthy"
        # stale success is NOT loss by itself: an idle tail parks in a
        # manifest long-poll for tens of seconds.  Confirm with a
        # direct bounded probe — only an unreachable, hung, or fenced
        # upstream turns into an election.
        try:
            await asyncio.wait_for(repl.probe_upstream(),
                                   max(0.25, min(self.grace_s, 2.0)))
            self.stats["probes_ok"] = self.stats.get("probes_ok", 0) + 1
            return "healthy"
        except asyncio.CancelledError:
            raise
        except Exception:
            pass
        return await self.run_election()

    async def run_election(self) -> str:
        server = self.server
        repl = server.replication
        self.stats["elections"] += 1
        statuses = []
        for url, tr in server.peer_transports().items():
            try:
                st = await _peer_json(tr, server.opts.replica_user,
                                      "GET", "/replication/status")
            except Exception:
                continue  # dead or across the partition: no vote
            statuses.append((url, st))
        # someone already won a newer incarnation: adopt them
        for url, st in statuses:
            if (st.get("role") == "leader"
                    and int(st.get("incarnation", 0) or 0)
                    > repl.max_incarnation
                    and st.get("fenced_by") is None):
                server.repoint_leader(url)
                self.stats["repoints"] += 1
                logger.warning("leader loss: repointed to promoted peer "
                               "%s", url)
                return "repointed"
        mine = (-repl.store.revision, repl.replica_id)
        for url, st in statuses:
            if st.get("role") != "follower":
                continue
            cand = (-int(st.get("revision", 0) or 0),
                    str(st.get("replica_id") or url))
            if cand < mine:
                # a better candidate exists (higher revision, or equal
                # revision and smaller id): let it promote, repoint on
                # a later pass when it shows up as leader
                self.stats["deferrals"] += 1
                return "deferred"
        await promote_follower(server)
        self.stats["promotions"] += 1
        return "promoted"


# -- fence monitor (leader side) --------------------------------------------


class FenceMonitor:
    """Leader-side peer probe: a (possibly resurrected) leader checks
    its peers for a newer incarnation — at startup BEFORE the listener
    opens, then periodically — and demotes itself into a follower of
    the new leader instead of split-braining.  Header-exchange fencing
    (ReplicationHub.observe_poll_headers) feeds the same `fenced_by`
    state, so a follower's stray poll fences a stale leader even
    between probe ticks; the server refuses update verbs the moment
    `fenced_by` is set, independent of this monitor."""

    def __init__(self, server, interval_s: float = 2.0):
        self.server = server
        self.interval_s = interval_s
        self.stats = {"probes": 0, "demotions": 0}
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                if await self.check_once() in ("demoted", "not_leader"):
                    return
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("fence monitor pass failed")

    async def check_once(self) -> str:
        server = self.server
        hub = server.replication_hub
        if hub is None:
            return "not_leader"
        self.stats["probes"] += 1
        statuses = []
        for url, tr in server.peer_transports().items():
            try:
                st = await _peer_json(tr, server.opts.replica_user,
                                      "GET", "/replication/status")
            except Exception:
                continue
            statuses.append((url, tr, st))
            inc = int(st.get("incarnation", 0) or 0)
            lid = st.get("leader_id", "") or ""
            # epoch ties break on the LARGER leader id ((incarnation,
            # leader_id) total order): of two simultaneously-promoted
            # leaders exactly one fences, never both
            if inc > hub.incarnation or (
                    inc == hub.incarnation and lid
                    and lid > hub.leader_id
                    and st.get("role") == "leader"):
                hub.note_fenced(inc, lid)
        if hub.fenced_by is None:
            return "leading"
        want = hub.fenced_by["incarnation"]
        for url, tr, st in statuses:
            if (st.get("role") == "leader"
                    and int(st.get("incarnation", 0) or 0) >= want
                    and st.get("fenced_by") is None):
                await demote_and_rejoin(server, url, tr)
                self.stats["demotions"] += 1
                return "demoted"
        # fenced but the new leader is not among our peers (or not yet
        # reachable): update verbs stay refused, keep probing
        return "fenced"
