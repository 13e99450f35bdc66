"""Revision-keyed decision cache with relation-scoped invalidation (the
reference's spicedb/decision_cache.py, for the torch port).

Zanzibar-class deployments get their production throughput from
consistency-aware result caching layered over the evaluator: the hot path
is dominated by REPEATED identical queries (the same user re-listing the
same 10k pods), and the kernel — however fast — re-derives an identical
frontier every time.  This module caches two decision shapes in front of
any store-backed endpoint (`torch://`, `embedded://`):

- **LookupResources frontiers**: the allowed-object id list per
  (resource_type, permission, subject) — the warm repeat-list skips
  device dispatch entirely;
- **check verdicts**: the tri-state permissionship per
  (resource, permission, subject).

Consistency model:

- Every entry records, at fill time, the **epoch** of each relation in
  the query's compiled footprint (`ops/graph_compile.relation_footprint`
  — the set of (type, relation) pairs whose tuples can influence the
  result).  A committed store delta bumps the epoch only of the
  relations it touches (the delta listener runs synchronously under the
  store lock, so no query can observe the new store state before the
  epochs reflect it).
- A hit is served only when every footprint epoch is unchanged — in that
  case no tuple that could change the result has been written since the
  fill, so the cached result IS the fully-consistent result at the
  current revision.  Entries whose footprint epochs are unchanged stay
  valid across unrelated writes instead of being flushed wholesale.
- Mass changes (bulk_load / delete_all) and schema-independent events
  bump a global epoch: everything invalidates.
- Tuples with expirations invalidate without a delta: the cache keeps an
  expiry heap ((expires_at, relation)) fed from deltas and — lazily,
  after a reset — from `TupleStore.expiry_schedule()`, and advances it
  against the STORE clock before every probe/fill.
- The fill-time epoch snapshot is captured BEFORE the inner evaluation
  starts, so a write racing the evaluation can only make the new entry
  immediately invalid (a wasted fill), never silently stale.

Bounded: LRU over a bytes-accounted OrderedDict (`max_bytes`,
`max_entries`); evictions and resident bytes are exported as
`authz_decision_cache_*` metrics with bounded labels.

`?explain=1` witnesses bypass the cache entirely (explain_check is a
pass-through), exactly like they bypass the fused dispatch queue — an
explain must re-derive the decision, not quote a cache line.
"""

from __future__ import annotations

import heapq
import threading
from collections import OrderedDict
from typing import Iterable

from ..ops.graph_compile import relation_footprint
from ..utils import tracing, workload
from .endpoints import PermissionsEndpoint
from .store import Watcher
from .types import (
    AnnotatedIds,
    CheckRequest,
    CheckResult,
    Precondition,
    RelationshipFilter,
    RelationshipUpdate,
    SubjectRef,
    WatchUpdate,
)

SOURCE_CACHE = "cache"

DEFAULT_MAX_BYTES = 128 << 20  # 128 MiB of cached frontiers
DEFAULT_MAX_ENTRIES = 65536

_MISS = object()


class _Entry:
    __slots__ = ("value", "global_epoch", "epochs", "nbytes")

    def __init__(self, value, global_epoch: int, epochs: tuple, nbytes: int):
        self.value = value
        self.global_epoch = global_epoch
        self.epochs = epochs  # ((relkey, epoch), ...)
        self.nbytes = nbytes


def _ids_nbytes(ids: list) -> int:
    """Approximate resident cost of a cached frontier: id characters plus
    per-element list overhead plus a fixed entry header."""
    return 96 + 8 * len(ids) + sum(len(s) for s in ids)


class DecisionCache:
    """Bounded bytes-accounted LRU keyed by query, validated by relation
    epochs.  Thread-safe: probes/fills run from executor threads and the
    event loop; epoch bumps run from writer threads under the store lock.
    """

    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES,
                 max_entries: int = DEFAULT_MAX_ENTRIES):
        if max_bytes < 1 or max_entries < 1:
            raise ValueError("decision cache bounds must be >= 1")
        self.max_bytes = max_bytes
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self._epochs: dict = {}  # (type, relation) -> int
        self._global_epoch = 0
        self._bytes = 0
        self._expiry_heap: list = []  # (expires_at, relkey)
        self.stats = {"hits": 0, "misses": 0, "invalidations": 0,
                      "evictions": 0, "fills": 0}

    # -- epoch plumbing (called under the store lock: must stay cheap) -------

    def bump(self, relkeys: Iterable[tuple]) -> None:
        with self._lock:
            for rk in relkeys:
                self._epochs[rk] = self._epochs.get(rk, 0) + 1

    def bump_all(self) -> None:
        """Wholesale invalidation (bulk_load / delete_all / rebuild-class
        events): one global epoch bump; resident entries are dropped
        eagerly so their bytes release immediately."""
        with self._lock:
            self._global_epoch += 1
            self.stats["invalidations"] += len(self._entries)
            self._entries.clear()
            self._bytes = 0

    def schedule_expiry(self, expires_at: float, relkey: tuple) -> None:
        with self._lock:
            heapq.heappush(self._expiry_heap, (expires_at, relkey))

    def _advance_expiry_locked(self, now: float) -> None:
        heap = self._expiry_heap
        while heap and heap[0][0] <= now:
            _, rk = heapq.heappop(heap)
            self._epochs[rk] = self._epochs.get(rk, 0) + 1

    # -- probe / fill --------------------------------------------------------

    def snapshot_epochs(self, footprint: frozenset, now: float) -> tuple:
        """Validation token for a fill: (global_epoch, ((relkey, epoch)...))
        captured BEFORE the inner evaluation reads the store, so a write
        racing the evaluation invalidates the resulting entry instead of
        being silently absorbed into it."""
        with self._lock:
            self._advance_expiry_locked(now)
            return (self._global_epoch,
                    tuple((rk, self._epochs.get(rk, 0))
                          for rk in sorted(footprint)))

    def get(self, key: tuple, now: float):
        with self._lock:
            self._advance_expiry_locked(now)
            e = self._entries.get(key)
            if e is None:
                self.stats["misses"] += 1
                return _MISS
            if (e.global_epoch != self._global_epoch
                    or any(self._epochs.get(rk, 0) != v
                           for rk, v in e.epochs)):
                del self._entries[key]
                self._bytes -= e.nbytes
                self.stats["invalidations"] += 1
                self.stats["misses"] += 1
                return _MISS
            self._entries.move_to_end(key)
            self.stats["hits"] += 1
            return e.value

    def put(self, key: tuple, value, token: tuple, nbytes: int) -> None:
        global_epoch, epochs = token
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = _Entry(value, global_epoch, epochs, nbytes)
            self._bytes += nbytes
            self.stats["fills"] += 1
            while (self._entries and
                   (self._bytes > self.max_bytes
                    or len(self._entries) > self.max_entries)):
                _, victim = self._entries.popitem(last=False)
                self._bytes -= victim.nbytes
                self.stats["evictions"] += 1

    # -- introspection -------------------------------------------------------

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def contains_valid(self, key: tuple) -> bool:
        """Non-LRU-touching, non-stat-counting validity probe (tests and
        introspection only)."""
        with self._lock:
            e = self._entries.get(key)
            return (e is not None
                    and e.global_epoch == self._global_epoch
                    and all(self._epochs.get(rk, 0) == v
                            for rk, v in e.epochs))


# switch off = this wrapper is never constructed (create_endpoint checks
# the DECISION_CACHE switch and the explicit requests), so its call
# sites need no re-check
class DecisionCacheEndpoint(PermissionsEndpoint):
    """Decision-cache layer wrapping a store-backed endpoint (the wrapper
    sits ABOVE the cross-request dispatcher: a hit never enqueues, so a
    warm repeat-list skips device dispatch entirely; misses flow through
    the fused/singleflight path underneath and fill on return)."""

    decision_cache_enabled = True

    def __init__(self, inner: PermissionsEndpoint,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 max_entries: int = DEFAULT_MAX_ENTRIES,
                 registry=None):
        self.inner = inner
        self.schema = inner.schema
        self.store = inner.store
        self.cache = DecisionCache(max_bytes=max_bytes,
                                   max_entries=max_entries)
        self._footprints: dict = {}  # (type, perm) -> frozenset
        # pre-existing bootstrap data may carry expirations the delta
        # listener never saw: seed the heap lazily, outside the store lock
        self._need_expiry_rescan = True
        self.store.add_delta_listener(self._on_delta)
        self.store.add_reset_listener(self._on_reset)
        if registry is None:
            from ..utils import metrics as m
            registry = m.REGISTRY
        self._hits = registry.counter(
            "authz_decision_cache_hits_total",
            "Decision-cache hits (served without touching the backend)",
            labels=("verb",))
        self._misses = registry.counter(
            "authz_decision_cache_misses_total",
            "Decision-cache misses (forwarded to the backend)",
            labels=("verb",))
        self._invalidations = registry.counter(
            "authz_decision_cache_invalidations_total",
            "Cached decisions dropped because a footprint relation epoch "
            "moved (writes, expirations, resets)")
        self._evictions = registry.counter(
            "authz_decision_cache_evictions_total",
            "Cached decisions evicted by the LRU bytes/entry bound")
        # weakref so the registry-held gauge callbacks never pin a
        # replaced/closed cache layer alive (same discipline as
        # InstrumentedEndpoint's backend-stat gauges)
        import weakref
        ref = weakref.ref(self.cache)
        registry.gauge(
            "authz_decision_cache_bytes",
            "Resident bytes of cached decisions",
            callback=lambda: float(getattr(ref(), "resident_bytes", 0) or 0))
        registry.gauge(
            "authz_decision_cache_entries",
            "Resident cached decisions",
            callback=lambda: float(len(ref() or ())))
        self._last_counts = dict(self.cache.stats)

    # -- store listeners (run under the store lock: no cache lock order
    # inversions — DecisionCache uses its own private lock only) ------------

    def _on_delta(self, update: WatchUpdate) -> None:
        relkeys = set()
        for u in update.updates:
            relkeys.add((u.rel.resource.type, u.rel.relation))
            if u.rel.expires_at is not None:
                self.cache.schedule_expiry(
                    u.rel.expires_at, (u.rel.resource.type, u.rel.relation))
        if relkeys:
            self.cache.bump(relkeys)

    def _on_reset(self) -> None:
        self.cache.bump_all()
        self._need_expiry_rescan = True

    def _maybe_rescan_expiry(self) -> None:
        if not self._need_expiry_rescan:
            return
        self._need_expiry_rescan = False
        for exp, relkey in self.store.expiry_schedule():
            self.cache.schedule_expiry(exp, relkey)

    # -- keys / footprints ---------------------------------------------------

    def _footprint(self, resource_type: str, permission: str) -> frozenset:
        fp = self._footprints.get((resource_type, permission))
        if fp is None:
            fp = relation_footprint(self.schema, resource_type, permission)
            self._footprints[(resource_type, permission)] = fp
        return fp

    def _sync_counters(self) -> None:
        """Mirror the cache's int counters into the Prometheus metrics
        (delta-based so concurrent syncs never double-count much; the
        ints remain the source of truth for tests)."""
        cur = dict(self.cache.stats)
        last, self._last_counts = self._last_counts, cur
        d = cur["invalidations"] - last.get("invalidations", 0)
        if d > 0:
            self._invalidations.inc(d)
        d = cur["evictions"] - last.get("evictions", 0)
        if d > 0:
            self._evictions.inc(d)

    # -- check verbs ---------------------------------------------------------

    async def check_permission(self, req: CheckRequest) -> CheckResult:
        return (await self.check_bulk_permissions([req]))[0]

    async def check_bulk_permissions(self, reqs: list) -> list:
        if not reqs:
            return []
        self._maybe_rescan_expiry()
        now = self.store.now()
        results: list = [None] * len(reqs)
        miss_rows: list = []
        tokens: dict = {}  # row -> (key, token)
        hits = 0
        pair_stats: dict = {}  # (type, permission) -> [hits, misses]
        with tracing.span("cache_lookup", phase=True, verb="check") as attrs:
            for i, r in enumerate(reqs):
                key = ("chk", r.resource.type, r.resource.id,
                       r.permission, r.subject)
                st = pair_stats.setdefault(
                    (r.resource.type, r.permission), [0, 0])
                cached = self.cache.get(key, now)
                if cached is not _MISS:
                    perm, at = cached
                    results[i] = CheckResult(permissionship=perm,
                                             checked_at=at,
                                             source=SOURCE_CACHE)
                    hits += 1
                    st[0] += 1
                    continue
                fp = self._footprint(r.resource.type, r.permission)
                tokens[i] = (key, self.cache.snapshot_epochs(fp, now))
                miss_rows.append(i)
                st[1] += 1
            attrs["hits"] = hits
            attrs["misses"] = len(miss_rows)
        for (rt, p), (h, ms) in pair_stats.items():
            workload.WORKLOAD.note_cache(rt, p, h, ms)
        if hits:
            self._hits.inc(hits, verb="check")
        if miss_rows:
            self._misses.inc(len(miss_rows), verb="check")
            inner_res = await self.inner.check_bulk_permissions(
                [reqs[i] for i in miss_rows])
            for i, res in zip(miss_rows, inner_res):
                key, token = tokens[i]
                self.cache.put(key, (res.permissionship, res.checked_at),
                               token, 128)
                results[i] = res
        self._sync_counters()
        return results

    # -- lookup verbs --------------------------------------------------------

    async def lookup_resources(self, resource_type: str, permission: str,
                               subject: SubjectRef) -> list:
        out = await self.lookup_resources_batch(resource_type, permission,
                                                [subject])
        return out[0]

    async def lookup_resources_batch(self, resource_type: str,
                                     permission: str, subjects: list) -> list:
        if not subjects:
            return []
        self._maybe_rescan_expiry()
        now = self.store.now()
        results: list = [None] * len(subjects)
        miss_rows: list = []
        tokens: dict = {}
        hits = 0
        with tracing.span("cache_lookup", phase=True, verb="lookup") as attrs:
            fp = self._footprint(resource_type, permission)
            for i, s in enumerate(subjects):
                key = ("lr", resource_type, permission, s)
                cached = self.cache.get(key, now)
                if cached is not _MISS:
                    results[i] = cached  # AnnotatedIds(source="cache")
                    hits += 1
                    continue
                tokens[i] = (key, self.cache.snapshot_epochs(fp, now))
                miss_rows.append(i)
            attrs["hits"] = hits
            attrs["misses"] = len(miss_rows)
        workload.WORKLOAD.note_cache(resource_type, permission, hits,
                                     len(miss_rows))
        if hits:
            self._hits.inc(hits, verb="lookup")
        if miss_rows:
            self._misses.inc(len(miss_rows), verb="lookup")
            if len(miss_rows) == 1:
                inner_res = [await self.inner.lookup_resources(
                    resource_type, permission, subjects[miss_rows[0]])]
            else:
                inner_res = await self.inner.lookup_resources_batch(
                    resource_type, permission,
                    [subjects[i] for i in miss_rows])
            for i, ids in zip(miss_rows, inner_res):
                key, token = tokens[i]
                # the stored value is a fresh AnnotatedIds pre-marked
                # "cache" so every future hit returns it without a copy;
                # THIS call returns the inner list with its true source
                self.cache.put(key, AnnotatedIds(ids, source=SOURCE_CACHE),
                               token, _ids_nbytes(ids))
                results[i] = ids
        self._sync_counters()
        return results

    # lookup_resources_stream is inherited from PermissionsEndpoint and
    # wraps self.lookup_resources, so streamed consumers hit the cache
    # too.  The dispatcher's two-phase entries (check_bulk_permissions_
    # start/finish, lookup_resources_batch_start/finish) pass through by
    # __getattr__, uncached: they belong to the layer below.

    # -- passthrough verbs ---------------------------------------------------

    def explain_check(self, resource, permission, subject):
        """Witness capture bypasses the cache: an explain must re-derive
        the decision through the real evaluator path, not quote a cache
        line (same contract as the dispatch queue's explain bypass)."""
        fn = getattr(self.inner, "explain_check", None)
        if fn is not None:
            return fn(resource, permission, subject)
        from ..authz.explain import witness_for
        return witness_for(self.inner, resource, permission, subject)

    async def read_relationships(self, flt: RelationshipFilter) -> list:
        return await self.inner.read_relationships(flt)

    async def read_relationships_stream(self, flt: RelationshipFilter):
        async for rel in self.inner.read_relationships_stream(flt):
            yield rel

    async def write_relationships(self, updates: Iterable[RelationshipUpdate],
                                  preconditions: Iterable[Precondition] = ()) -> int:
        return await self.inner.write_relationships(updates, preconditions)

    async def delete_relationships(self, flt: RelationshipFilter,
                                   preconditions: Iterable[Precondition] = ()) -> int:
        return await self.inner.delete_relationships(flt, preconditions)

    def watch(self, object_types=None) -> Watcher:
        return self.inner.watch(object_types)

    async def close(self) -> None:
        self.store.remove_delta_listener(self._on_delta)
        self.store.remove_reset_listener(self._on_reset)
        await self.inner.close()

    def __getattr__(self, name):
        return getattr(self.inner, name)
