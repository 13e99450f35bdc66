"""In-memory relationship (tuple) store.

The host-side source of truth replacing embedded SpiceDB's memory datastore
(reference pkg/spicedb/spicedb.go:18-71): versioned writes with
create/touch/delete semantics, filter deletes with `$`-wildcards,
preconditions, relationship expiration (`use expiration` /
`with expiration`, used by the dual-write engine's idempotency keys,
reference activity.go:47-102), read filters, and watch subscriptions.

The device tables used by the torch:// backend are a cache built from
this store and kept current from its committed deltas (SURVEY.md §5
checkpoint/resume note).
"""

from __future__ import annotations

import threading
import time

import numpy as np
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

from .columnar import BaseLayer, ColumnarSnapshot
from .types import (
    AlreadyExistsError,
    ObjectRef,
    Precondition,
    PreconditionFailedError,
    PreconditionOp,
    Relationship,
    RelationshipFilter,
    RelationshipUpdate,
    SubjectRef,
    UpdateOp,
    WatchUpdate,
)

# Max mutations / preconditions per write call, mirroring the embedded
# server's limits (reference spicedb.go:35-36).
MAX_UPDATES_PER_WRITE = 1000
MAX_PRECONDITIONS = 1000


class WriteLimitExceededError(Exception):
    pass


class WatchQueue:
    """Thread-safe event drain with BOTH a blocking poll() and an
    asyncio-native next() (no polling thread, no added latency — the
    publisher wakes async consumers through call_soon_threadsafe).
    Publishers may run on any thread; multiple async consumers on
    multiple loops are supported."""

    def __init__(self):
        self._events: list = []
        self._cond = threading.Condition()
        self.closed = False
        self._waiters: list = []  # (loop, future) pairs

    def _push(self, item) -> None:
        with self._cond:
            self._events.append(item)
            self._cond.notify_all()
            self._wake_waiters_locked()

    def _mark_closed(self) -> None:
        with self._cond:
            self.closed = True
            self._cond.notify_all()
            self._wake_waiters_locked()

    def _wake_waiters_locked(self) -> None:
        waiters, self._waiters = self._waiters, []
        for loop, fut in waiters:
            try:
                loop.call_soon_threadsafe(self._resolve, fut)
            except RuntimeError:
                pass  # consumer's loop already closed

    @staticmethod
    def _resolve(fut) -> None:
        if not fut.done():
            fut.set_result(None)

    def poll(self, timeout: Optional[float] = None):
        """Block until the next batch (or timeout/close); None on timeout."""
        with self._cond:
            if not self._events and not self.closed:
                self._cond.wait(timeout)
            if self._events:
                return self._events.pop(0)
            return None

    async def next(self, timeout: Optional[float] = None):
        """Await the next batch without blocking the event loop; None on
        timeout or when the watcher is closed and drained."""
        import asyncio

        loop = asyncio.get_running_loop()
        while True:
            with self._cond:
                if self._events:
                    return self._events.pop(0)
                if self.closed:
                    return None
                fut = loop.create_future()
                self._waiters.append((loop, fut))
            try:
                if timeout is None:
                    await fut
                else:
                    try:
                        await asyncio.wait_for(fut, timeout)
                    except asyncio.TimeoutError:
                        return None
            finally:
                with self._cond:
                    try:
                        self._waiters.remove((loop, fut))
                    except ValueError:
                        pass


class Watcher(WatchQueue):
    """A subscription to relationship updates; drained via poll()/next()."""

    def __init__(self, store: "TupleStore", object_types: Optional[set]):
        super().__init__()
        self._store = store
        self._object_types = object_types

    def _publish(self, update: WatchUpdate) -> None:
        if self._object_types:
            updates = tuple(u for u in update.updates
                            if u.rel.resource.type in self._object_types)
            if not updates:
                return
            update = WatchUpdate(updates=updates, revision=update.revision)
        self._push(update)

    def close(self) -> None:
        self._mark_closed()
        self._store._unsubscribe(self)


@dataclass
class _Entry:
    rel: Relationship
    revision: int


class TupleStore:
    """Thread-safe in-memory tuple store with monotonic revisions."""

    def now(self) -> float:
        """The store's time source — consumers enforcing expiration (the
        device-graph expiry heap) must read THIS clock so tests can drive
        expiry deterministically."""
        return self._clock()

    def __init__(self, clock: Callable[[], float] = time.time):
        self._lock = threading.RLock()
        self._clock = clock
        # (resource_type, relation) -> {resource_id -> {subject_key -> _Entry}}
        self._by_relation: dict = {}
        # optional immutable columnar bootstrap layer (bulk_load_text);
        # overlay writes shadow base rows via its dead mask
        self._base: Optional[BaseLayer] = None
        self._revision = 0
        self._watchers: list[Watcher] = []
        # delta listeners get every committed batch synchronously under the
        # store lock — the torch:// backend queues them as deltas for its
        # device graph.
        self._delta_listeners: list[Callable[[WatchUpdate], None]] = []
        # reset listeners fire on non-delta mass changes (bulk_load,
        # delete_all) that require a full cache rebuild.
        self._reset_listeners: list[Callable[[], None]] = []
        # commit listeners receive EVERY revision-advancing commit with
        # its payload — (kind, revision, payload) where kind is "delta"
        # (payload: applied RelationshipUpdate tuple, possibly empty),
        # "snapshot" (ColumnarSnapshot), "bulk" (Relationship list), or
        # "clear" (None).  They run synchronously under the store lock
        # BEFORE the mutation applies: the WAL (spicedb/persist) must
        # observe a revision before any reader can act on it, and a
        # listener exception (durability failure) aborts the commit —
        # the store stays untouched, the revision is not consumed, and
        # the error propagates to the writer.
        self._commit_listeners: list[Callable] = []

    # -- revision -----------------------------------------------------------

    @property
    def revision(self) -> int:
        with self._lock:
            return self._revision

    @property
    def lock(self):
        """The store's reentrant lock — for callers that must combine
        several reads (e.g. revision + a snapshot) atomically."""
        return self._lock

    # -- reads --------------------------------------------------------------

    def read(self, flt: Optional[RelationshipFilter] = None) -> list:
        """All live (unexpired) relationships matching the filter."""
        now = self._clock()
        out = []
        with self._lock:
            if self._base is not None:
                snap = self._base.snap
                out.extend(snap.relationship(int(i))
                           for i in self._base.matching_rows(flt, now))
            for (rtype, relation), by_id in self._by_relation.items():
                if flt is not None and flt.resource_type and rtype != flt.resource_type:
                    continue
                if flt is not None and flt.relation and relation != flt.relation:
                    continue
                for rid, subjects in by_id.items():
                    if flt is not None and flt.resource_id and rid != flt.resource_id:
                        continue
                    for entry in subjects.values():
                        if entry.rel.expired(now):
                            continue
                        if flt is None or flt.matches(entry.rel):
                            out.append(entry.rel)
        return out

    def subject_entries_for(self, resource: ObjectRef, relation: str) -> list:
        """Live (subject, caveat) pairs of (resource, relation).  The
        columnar base layer never carries caveats (caveated tuples always
        take the object path, see bulk_load_text), so base rows pair with
        None."""
        now = self._clock()
        out = []
        with self._lock:
            base = self._base
            if base is not None:
                snap = base.snap
                pool = snap.pool
                for row in base.rows_for_resource(resource.type, relation,
                                                  resource.id):
                    if base.row_live(int(row), now):
                        out.append((SubjectRef(pool[snap.stype[row]],
                                               pool[snap.sid[row]],
                                               pool[snap.srel[row]]), None))
            by_id = self._by_relation.get((resource.type, relation))
            subjects = by_id.get(resource.id) if by_id else None
            if subjects:
                out.extend((e.rel.subject, e.rel.caveat)
                           for e in subjects.values()
                           if not e.rel.expired(now))
        return out

    def caveated_relation_pairs(self) -> set:
        """(resource_type, relation) pairs currently holding >=1 live
        caveated tuple (torch:// uses this to route affected permissions to
        the host evaluator)."""
        now = self._clock()
        out = set()
        with self._lock:
            for (rtype, relation), by_id in self._by_relation.items():
                if (rtype, relation) in out:
                    continue
                for subjects in by_id.values():
                    if any(e.rel.caveat is not None and not e.rel.expired(now)
                           for e in subjects.values()):
                        out.add((rtype, relation))
                        break
        return out

    def caveated_keys(self) -> set:
        """Identity keys of live caveated tuples (torch:// excludes these from
        the device graph and tracks them across deltas)."""
        now = self._clock()
        out = set()
        with self._lock:
            for by_id in self._by_relation.values():
                for subjects in by_id.values():
                    for e in subjects.values():
                        if e.rel.caveat is not None and not e.rel.expired(now):
                            out.add(e.rel.key())
        return out

    def object_ids_of_type(self, resource_type: str) -> list:
        """All ids appearing as a resource of the given type (live tuples)."""
        now = self._clock()
        ids = set()
        with self._lock:
            base = self._base
            if base is not None:
                snap = base.snap
                t = snap.ordinal(resource_type)
                if t >= 0:
                    live = base.live_mask(now) & (snap.rtype == t)
                    ids.update(snap.pool[o]
                               for o in np.unique(snap.rid[live]))
            for (rtype, _), by_id in self._by_relation.items():
                if rtype != resource_type:
                    continue
                for rid, subjects in by_id.items():
                    if any(not e.rel.expired(now) for e in subjects.values()):
                        ids.add(rid)
        return sorted(ids)

    def expiry_schedule(self) -> list:
        """(expires_at, (resource_type, relation)) for every LIVE tuple
        carrying an expiration — vectorized over the columnar base, object
        scan over the overlay.  Consumers that cache decisions keyed on
        relation state (spicedb/decision_cache.py) seed their expiry heap
        from this so a tuple expiring without a delta event still
        invalidates the relations it touches."""
        now = self._clock()
        out = []
        with self._lock:
            base = self._base
            if base is not None:
                snap = base.snap
                exp = snap.expiry
                rows = np.nonzero(~np.isnan(exp) & ~base.dead
                                  & (exp > now))[0]
                pool = snap.pool
                for i in rows:
                    out.append((float(exp[i]),
                                (pool[snap.rtype[i]], pool[snap.rel[i]])))
            for (rtype, relation), by_id in self._by_relation.items():
                for subjects in by_id.values():
                    for e in subjects.values():
                        if (e.rel.expires_at is not None
                                and not e.rel.expired(now)):
                            out.append((e.rel.expires_at, (rtype, relation)))
        return out

    def relationships_since(self, revision: int) -> list:
        """Live relationships whose last write landed AFTER `revision`.
        Overlay entries carry exact per-tuple revisions; base-layer rows
        all carry the base's adoption revision, so a base adopted above
        `revision` exports wholesale (conservative, and safe for a
        TOUCH-idempotent replay of the effects)."""
        now = self._clock()
        out = []
        with self._lock:
            if self._base is not None and self._base.revision > revision:
                snap = self._base.snap
                out.extend(snap.relationship(int(i))
                           for i in self._base.matching_rows(None, now))
            for by_id in self._by_relation.values():
                for subjects in by_id.values():
                    for entry in subjects.values():
                        if (entry.revision > revision
                                and not entry.rel.expired(now)):
                            out.append(entry.rel)
        return out

    def has_exact(self, rel: Relationship) -> bool:
        now = self._clock()
        with self._lock:
            return self._live_entry(rel, now) is not None

    def count(self) -> int:
        return len(self.read())

    # -- writes -------------------------------------------------------------

    def write(self, updates: Iterable[RelationshipUpdate],
              preconditions: Iterable[Precondition] = ()) -> int:
        """Atomically apply updates after checking preconditions; returns the
        new revision (the zedtoken equivalent)."""
        updates = list(updates)
        preconditions = list(preconditions)
        if len(updates) > MAX_UPDATES_PER_WRITE:
            raise WriteLimitExceededError(
                f"{len(updates)} updates exceeds limit {MAX_UPDATES_PER_WRITE}")
        if len(preconditions) > MAX_PRECONDITIONS:
            raise WriteLimitExceededError(
                f"{len(preconditions)} preconditions exceeds limit {MAX_PRECONDITIONS}")
        with self._lock:
            self._check_preconditions(preconditions)
            # validate CREATEs before mutating (atomicity); duplicates
            # within the batch are also conflicts
            now = self._clock()
            created_in_batch: set = set()
            for u in updates:
                if u.op != UpdateOp.CREATE:
                    continue
                key = u.rel.key()
                if (self._live_entry(u.rel, now) is not None
                        or key in created_in_batch):
                    raise AlreadyExistsError(
                        f"relationship already exists: {u.rel.rel_string()}")
                created_in_batch.add(key)
            # compute the applied set WITHOUT mutating: commit listeners
            # (the WAL) journal the batch before any reader-visible
            # change, so a durability failure aborts the write with the
            # store untouched.  `present` tracks intra-batch ordering
            # (touch-then-delete deletes; double-delete applies once).
            applied = []
            present: dict = {}
            for u in updates:
                key = u.rel.key()
                if u.op in (UpdateOp.CREATE, UpdateOp.TOUCH):
                    applied.append(RelationshipUpdate(UpdateOp.TOUCH, u.rel))
                    present[key] = True
                elif u.op == UpdateOp.DELETE:
                    if present.get(key, self._present(u.rel)):
                        applied.append(
                            RelationshipUpdate(UpdateOp.DELETE, u.rel))
                    present[key] = False
            # journal even effect-free commits: the revision advances,
            # and recovery must reproduce the exact counter
            rev = self._revision + 1
            self._commit("delta", rev, tuple(applied))
            self._revision = rev
            for u in applied:
                if u.op == UpdateOp.TOUCH:
                    self._put(u.rel, rev)
                else:
                    self._remove(u.rel)
            if applied:
                self._broadcast(WatchUpdate(updates=tuple(applied), revision=rev))
            return rev

    def bulk_load(self, rels: Iterable[Relationship]) -> int:
        """Bootstrap/benchmark path: load relationships without the per-call
        API update limit (the reference seeds bootstrap data straight into
        the datastore, not through WriteRelationships — spicedb.go:63-67).
        One revision, no watch events."""
        with self._lock:
            if self._commit_listeners:
                rels = list(rels)  # journaled payload; iterated twice
            rev = self._revision + 1
            self._commit("bulk", rev, rels if isinstance(rels, list) else ())
            self._revision = rev
            for rel in rels:
                self._put(rel, rev)
            for fn in list(self._reset_listeners):
                fn()
            return rev

    def delete_by_filter(self, flt: RelationshipFilter,
                         preconditions: Iterable[Precondition] = ()) -> tuple:
        """Delete all relationships matching the filter; returns
        (revision, deleted relationships)."""
        with self._lock:
            self._check_preconditions(list(preconditions))
            victims = self.read(flt)
            if not victims:
                return self._revision, []
            applied = tuple(RelationshipUpdate(UpdateOp.DELETE, rel)
                            for rel in victims)
            rev = self._revision + 1
            self._commit("delta", rev, applied)
            self._revision = rev
            for rel in victims:
                self._remove(rel)
            self._broadcast(WatchUpdate(updates=applied, revision=rev))
            return rev, victims

    def delete_all(self) -> None:
        """Test helper (mirrors the reference e2e DeleteAllTuples util)."""
        with self._lock:
            rev = self._revision + 1
            self._commit("clear", rev, None)
            self._revision = rev
            self._by_relation.clear()
            self._base = None
            for fn in list(self._reset_listeners):
                fn()

    # -- columnar bulk path -------------------------------------------------

    def bulk_load_snapshot(self, snap: ColumnarSnapshot) -> int:
        """Adopt a columnar snapshot as the store's base layer without
        materializing per-tuple objects (the fast bootstrap path; reference
        seeds bootstrap data straight into the datastore, spicedb.go:63-67).
        Requires an empty store; otherwise falls back to object inserts.
        One revision, no watch events (like bulk_load)."""
        with self._lock:
            if self._by_relation or self._base is not None:
                return self.bulk_load(snap.relationship(i)
                                      for i in range(len(snap)))
            rev = self._revision + 1
            self._commit("snapshot", rev, snap)
            self._revision = rev
            self._base = BaseLayer(snap, rev)
            for fn in list(self._reset_listeners):
                fn()
            return rev

    def bulk_load_text(self, text: str) -> int:
        """Parse + adopt relationship text via the columnar loader.  Caveated
        lines (`[caveat:...]` suffix) are split out and loaded through the
        object path — the columnar base layer stays caveat-free by
        construction (see subject_entries_for)."""
        if "[caveat:" in text:
            from .types import parse_relationship as _parse
            plain_lines = []
            caveat_rels = []
            for line in text.splitlines():
                stripped = line.strip()
                if "[caveat:" in stripped:
                    caveat_rels.append(_parse(stripped))
                else:
                    plain_lines.append(line)
            rev = self.bulk_load_snapshot(
                ColumnarSnapshot.from_text("\n".join(plain_lines)))
            if caveat_rels:
                rev = self.bulk_load(caveat_rels)
            return rev
        return self.bulk_load_snapshot(ColumnarSnapshot.from_text(text))

    def columnar_view(self) -> Optional[tuple]:
        """(snapshot, live base row indices, overlay relationships) for the
        vectorized graph compiler, or None when no base layer exists.  Call
        under no lock; takes the store lock itself."""
        now = self._clock()
        with self._lock:
            if self._base is None:
                return None
            rows = self._base.live_rows(now)
            overlay = []
            for by_id in self._by_relation.values():
                for subjects in by_id.values():
                    overlay.extend(e.rel for e in subjects.values()
                                   if not e.rel.expired(now))
            return self._base.snap, rows, overlay

    # -- watch --------------------------------------------------------------

    def subscribe(self, object_types: Optional[Iterable[str]] = None) -> Watcher:
        w = Watcher(self, set(object_types) if object_types else None)
        with self._lock:
            self._watchers.append(w)
        return w

    def _unsubscribe(self, w: Watcher) -> None:
        with self._lock:
            if w in self._watchers:
                self._watchers.remove(w)

    def add_delta_listener(self, fn: Callable[[WatchUpdate], None]) -> None:
        with self._lock:
            self._delta_listeners.append(fn)

    def add_reset_listener(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._reset_listeners.append(fn)

    def remove_delta_listener(self, fn: Callable[[WatchUpdate], None]) -> None:
        with self._lock:
            if fn in self._delta_listeners:
                self._delta_listeners.remove(fn)

    def remove_reset_listener(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if fn in self._reset_listeners:
                self._reset_listeners.remove(fn)

    def add_commit_listener(self, fn: Callable) -> None:
        """fn(kind, revision, payload) on every revision-advancing
        commit, synchronously under the store lock (see __init__)."""
        with self._lock:
            self._commit_listeners.append(fn)

    def remove_commit_listener(self, fn: Callable) -> None:
        with self._lock:
            if fn in self._commit_listeners:
                self._commit_listeners.remove(fn)

    # -- recovery (spicedb/persist) -----------------------------------------

    def adopt_recovery_state(self, snap: Optional[ColumnarSnapshot],
                             overlay: Iterable[Relationship],
                             revision: int) -> None:
        """Recovery-only: adopt a checkpointed state wholesale at
        EXACTLY `revision` — columnar base plus object overlay
        (caveated tuples), with no intermediate revision bumps (a
        checkpoint taken at revision 1 must not land at 2 because its
        overlay loaded as a second step).  Requires a store with no
        history; fires no listeners (recovery precedes attach)."""
        if revision < 1:
            raise ValueError(f"invalid recovery revision {revision}")
        with self._lock:
            if self._revision != 0 or self._by_relation or self._base is not None:
                raise ValueError(
                    "adopt_recovery_state requires an empty store")
            if snap is not None and len(snap):
                self._base = BaseLayer(snap, revision)
            for rel in overlay:
                self._put(rel, revision)
            self._revision = revision

    def apply_recovery_batch(self, updates: Iterable[RelationshipUpdate]) -> int:
        """Re-apply one journaled committed batch exactly as recorded:
        no limits, preconditions, CREATE validation, or listener
        broadcast (recovery runs before any listener attaches) — the
        batch already committed once, so it re-applies verbatim.  One
        revision bump even for an effect-free batch, mirroring write()."""
        with self._lock:
            self._revision += 1
            rev = self._revision
            for u in updates:
                if u.op == UpdateOp.DELETE:
                    self._remove(u.rel)
                else:
                    self._put(u.rel, rev)
            return rev

    # -- replication (spicedb/replication) ----------------------------------

    def apply_replica_batch(self, updates: Iterable[RelationshipUpdate]) -> int:
        """Replica-apply one journaled committed batch: the exact-replay
        semantics of apply_recovery_batch (no limits / preconditions /
        CREATE validation — the batch already committed on the leader),
        but applied to a LIVE store: watchers and delta listeners fire,
        so the device graph, decision-cache epochs, and watch streams
        follow the leader through the normal delta pipeline.  Commit
        listeners do NOT fire — a follower must never re-journal the
        leader's log."""
        updates = tuple(updates)
        with self._lock:
            self._revision += 1
            rev = self._revision
            for u in updates:
                if u.op == UpdateOp.DELETE:
                    self._remove(u.rel)
                else:
                    self._put(u.rel, rev)
            if updates:
                self._broadcast(WatchUpdate(updates=updates, revision=rev))
            return rev

    def replica_reset(self, snap: Optional[ColumnarSnapshot],
                      overlay: Iterable[Relationship],
                      revision: int) -> None:
        """Replica (re-)bootstrap: discard ALL current state and adopt a
        leader checkpoint wholesale at EXACTLY `revision`.  Unlike
        adopt_recovery_state this works on a non-empty store (a follower
        re-bootstraps after losing the segment tail it was tailing) and
        fires the reset listeners so live consumers rebuild their caches
        from the adopted state.  The revision may move backwards — after
        a leader crash that lost an unsynced WAL tail, the checkpoint is
        the only truthful state left."""
        if revision < 1:
            raise ValueError(f"invalid replica reset revision {revision}")
        with self._lock:
            self._by_relation.clear()
            self._base = None
            if snap is not None and len(snap):
                self._base = BaseLayer(snap, revision)
            for rel in overlay:
                self._put(rel, revision)
            self._revision = revision
            for fn in list(self._reset_listeners):
                fn()

    # -- internals ----------------------------------------------------------

    def _present(self, rel: Relationship) -> bool:
        """Identity-present regardless of expiry — mirrors what
        _remove() can reach, so a pre-commit applied-set computation
        agrees with the mutation it precedes."""
        by_id = self._by_relation.get((rel.resource.type, rel.relation))
        subjects = by_id.get(rel.resource.id) if by_id else None
        if subjects and rel.subject in subjects:
            return True
        base = self._base
        return base is not None and base.find_row(rel.key()) >= 0

    def _live_entry(self, rel: Relationship, now: float) -> Optional[_Entry]:
        by_id = self._by_relation.get((rel.resource.type, rel.relation), {})
        entry = by_id.get(rel.resource.id, {}).get(rel.subject)
        if entry is not None:
            return None if entry.rel.expired(now) else entry
        base = self._base
        if base is not None:
            row = base.find_row(rel.key())
            if row >= 0 and base.row_live(row, now):
                return _Entry(rel=base.snap.relationship(row),
                              revision=base.revision)
        return None

    def _put(self, rel: Relationship, rev: int) -> None:
        base = self._base
        if base is not None:
            # overlay shadows the base copy (keeps iteration duplicate-free)
            row = base.find_row(rel.key())
            if row >= 0:
                base.dead[row] = True
        key = (rel.resource.type, rel.relation)
        by_id = self._by_relation.setdefault(key, {})
        subjects = by_id.setdefault(rel.resource.id, {})
        subjects[rel.subject] = _Entry(rel=rel, revision=rev)

    def _remove(self, rel: Relationship) -> bool:
        key = (rel.resource.type, rel.relation)
        by_id = self._by_relation.get(key)
        subjects = by_id.get(rel.resource.id) if by_id else None
        if subjects and rel.subject in subjects:
            del subjects[rel.subject]
            if not subjects:
                del by_id[rel.resource.id]
            if not by_id:
                del self._by_relation[key]
            return True
        base = self._base
        if base is not None:
            row = base.find_row(rel.key())
            if row >= 0 and not base.dead[row]:
                base.dead[row] = True
                return True
        return False

    def _check_preconditions(self, preconditions: list) -> None:
        for p in preconditions:
            matched = bool(self.read(p.filter))
            if p.op == PreconditionOp.MUST_MATCH and not matched:
                raise PreconditionFailedError(p)
            if p.op == PreconditionOp.MUST_NOT_MATCH and matched:
                raise PreconditionFailedError(p)

    def _broadcast(self, update: WatchUpdate) -> None:
        for fn in list(self._delta_listeners):
            fn(update)
        for w in list(self._watchers):
            w._publish(update)

    def _commit(self, kind: str, revision: int, payload) -> None:
        """Notify commit listeners (under the store lock, before any
        watcher/delta listener — WAL-before-visibility ordering)."""
        for fn in list(self._commit_listeners):
            fn(kind, revision, payload)
