"""The thin router and the in-process sharded endpoint (the reference's
spicedb/sharding/router.py).

Two compositions of the same PartitionMap, one per deployment shape:

- **`ShardedEndpoint`** — N independent leaders inside ONE process:
  each shard is a full store-backed PermissionsEndpoint over its own
  TupleStore (and, with a data dir, its own WAL + checkpoint lineage
  under `<data-dir>/shard-<k>`).  Single-type verbs (the hot path —
  checks, LookupResources, typed reads/deletes, every write batch)
  route to exactly one shard; the few cross-shard verbs fan out
  (untyped reads and delete_by_filter, bulk checks split by type, watch
  merged across shards).  Over `torch://` each shard is its own
  `TorchEndpoint` with its own graph on the card, so a filtered list
  over one resource type runs one shard's kernels under one shard's
  store lock.  The shards share the process-wide device state (the
  launch counters, the readback side stream, the caching allocator):
  per-shard attribution comes from each shard's own dispatcher stats
  (`shard_stats()`), never from the global counters.

- **`ShardRouter` / `RouterServer`** — the multi-process shape: N
  shard leaders are unmodified proxies (their own data dirs,
  incarnation epochs, followers and failover), and the router is a thin
  stateless HTTP process in front that (1) maps each kube request to the
  one shard whose types its matched rules touch (the routing table is
  derived from the rule configs and validated against the footprint
  closure at startup), (2) translates revision-vector ZedTokens to
  single components on the way in and merges the serving shard's
  revision into the vector on the way out, and (3) aggregates health.
  The router authenticates nothing and holds no state.  It is the
  fleet's front tier: it starts (or joins) each routed request's trace,
  forwards inside a `hop.shard_forward` hop span whose X-Authz-*
  headers make the shard leader join that trace, and serves the merged
  cross-process view over its `fleet_peers` (the shard leaders, and any
  extra members) at `/debug/fleet` and its tail report at `/debug/tail`.

Killswitch: the SHARDING switch (utils/features.py).  Off,
`ShardedEndpoint` is never constructed (single-shard behavior exactly)
and the router degrades to a transparent pass-through to the default
shard.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Iterable, Optional

from .. import schema as sch
from ..endpoints import PermissionsEndpoint
from ..store import WatchQueue, Watcher
from ..types import (
    CheckRequest,
    Precondition,
    RelationshipFilter,
    RelationshipUpdate,
    SubjectFilter,
    SubjectRef,
    UpdateOp,
    parse_relationship,
)
from . import metrics as shard_metrics
from .partition import INTERNAL_TYPES, CrossShardWriteError, PartitionMap
from .revvec import RevisionVector, RevisionVectorError

logger = logging.getLogger("spicedb_kubeapi_proxy_tpu_torch.sharding")


class RouterConfigError(ValueError):
    """Unroutable router configuration (a rule's types span shards)."""


def _walk_attr(ep, name: str):
    """Find `name` through wrapper layers (instrumentation, decision
    cache, batching dispatcher) — the same `.inner` walk the server
    uses for queue_depth discovery."""
    seen = 0
    while ep is not None and seen < 8:
        fn = getattr(ep, name, None)
        if fn is not None:
            return fn
        ep = getattr(ep, "inner", None)
        seen += 1
    return None


class _ShardedStoreView:
    """Minimal read-only store facade for callers that expect
    `endpoint.store` (the dual-write engine's error path reads
    `.revision`; there is no single revision across shards, so this
    reports the pointwise max — a lower bound on 'everything I could
    have written is visible')."""

    def __init__(self, endpoint: "ShardedEndpoint"):
        self._endpoint = endpoint

    @property
    def revision(self) -> int:
        return max((s.revision for s in self._endpoint.shard_stores()),
                   default=0)

    def now(self) -> float:
        stores = self._endpoint.shard_stores()
        return stores[0].now() if stores else time.time()


class MergedWatcher(WatchQueue):
    """Watch stream merged across shard watchers.  Event batches keep
    their per-shard revisions (there is no global order between shards
    — consumers needing one thread the revision-vector token instead);
    batches from one shard stay in that shard's commit order.  One pump
    thread a child; each ends when its child closes, so `close()` (and
    the sharded endpoint's `close()`) leaves no thread behind."""

    def __init__(self, children: list):
        super().__init__()
        self._children = list(children)
        self._alive = len(self._children)
        self._merge_lock = threading.Lock()
        self._threads = []
        for child in self._children:
            t = threading.Thread(target=self._pump, args=(child,),
                                 name="authz-shard-watch", daemon=True)
            self._threads.append(t)
            t.start()

    def _pump(self, child) -> None:
        while True:
            # a blocking poll: the child's condition variable wakes this
            # thread on every push AND on close, so the pump never spins
            # on a timeout while the stream idles
            batch = child.poll(None)
            if batch is not None:
                self._push(batch)
            elif child.closed:
                break
        with self._merge_lock:
            self._alive -= 1
            if self._alive == 0:
                self._mark_closed()

    def close(self) -> None:
        for child in self._children:
            child.close()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the pump threads to end; True when all did."""
        for t in self._threads:
            t.join(timeout)
        return not any(t.is_alive() for t in self._threads)


class ShardedEndpoint(PermissionsEndpoint):
    """N store-backed leaders behind one PermissionsEndpoint face."""

    def __init__(self, pmap: PartitionMap, shards: list,
                 schema: Optional[sch.Schema] = None):
        if len(shards) != pmap.n_shards:
            raise RouterConfigError(
                f"partition map configures {pmap.n_shards} shard(s) but "
                f"{len(shards)} endpoint(s) were supplied")
        self.pmap = pmap
        self.shards = list(shards)
        self.schema = schema if schema is not None else getattr(
            shards[0], "schema", None)
        self.store = _ShardedStoreView(self)
        self._watchers: list = []

    # -- plumbing ------------------------------------------------------------

    def shard_stores(self) -> list:
        out = []
        for ep in self.shards:
            store = _walk_attr(ep, "store")
            if store is not None:
                out.append(store)
        return out

    def shard_stats(self) -> list:
        """Each shard's own stats (its dispatcher's merged copy over its
        endpoint's): what a shard served, which the process-wide launch
        counters cannot tell apart."""
        return [dict(getattr(ep, "stats", None) or {}) for ep in self.shards]

    def _route(self, resource_type: str, resource_id: str = "") -> int:
        shard = self.pmap.shard_of(resource_type, resource_id)
        shard_metrics.note_routed(shard)
        return shard

    # -- single-shard verbs (the hot path) -----------------------------------

    async def check_permission(self, req: CheckRequest):
        k = self._route(req.resource.type, req.resource.id)
        return await self.shards[k].check_permission(req)

    async def check_bulk_permissions(self, reqs: list) -> list:
        groups: dict = {}
        for i, req in enumerate(reqs):
            k = self.pmap.shard_of(req.resource.type, req.resource.id)
            groups.setdefault(k, []).append(i)
        if len(groups) == 1:
            ((k, _),) = groups.items()
            shard_metrics.note_routed(k)
            return await self.shards[k].check_bulk_permissions(reqs)
        # a bulk spanning types on two shards fans out concurrently and
        # reassembles in request order
        shard_metrics.note_fanout("check_bulk")
        results: list = [None] * len(reqs)

        async def run(k: int, idxs: list):
            sub = await self.shards[k].check_bulk_permissions(
                [reqs[i] for i in idxs])
            for i, r in zip(idxs, sub):
                results[i] = r
        await asyncio.gather(*(run(k, idxs)
                               for k, idxs in groups.items()))
        return results

    async def lookup_resources(self, resource_type: str, permission: str,
                               subject: SubjectRef) -> list:
        k = self._route(resource_type)
        return await self.shards[k].lookup_resources(resource_type,
                                                     permission, subject)

    async def lookup_resources_batch(self, resource_type: str,
                                     permission: str, subjects: list) -> list:
        k = self._route(resource_type)
        return await self.shards[k].lookup_resources_batch(
            resource_type, permission, subjects)

    async def lookup_resources_stream(self, resource_type: str,
                                      permission: str, subject: SubjectRef):
        k = self._route(resource_type)
        async for rid in self.shards[k].lookup_resources_stream(
                resource_type, permission, subject):
            yield rid

    async def write_relationships(self, updates: Iterable[RelationshipUpdate],
                                  preconditions: Iterable[Precondition] = ()) -> int:
        updates = list(updates)
        preconditions = list(preconditions)
        try:
            k = self.pmap.shard_for_updates(updates)
        except CrossShardWriteError:
            shard_metrics.note_cross_write_reject()
            raise
        if updates and all(u.rel.resource.type in INTERNAL_TYPES
                           for u in updates):
            k = await self._locate_internal_shard(updates, fallback=k)
        # preconditions must be checkable on the same leader the batch
        # lands on — a filter naming a foreign shard's type, or an
        # untyped filter that could match a foreign shard's tuples,
        # could never be evaluated atomically with the write
        for p in preconditions:
            if p.filter.resource_type in INTERNAL_TYPES:
                # lock/workflow/activity preconditions guard tuples that
                # ride this batch's shard by design (the pessimistic
                # lock's must_not_match meets its contenders here)
                continue
            shards = self.pmap.shards_for_filter(p.filter)
            if shards != [k]:
                shard_metrics.note_cross_write_reject()
                desc = (f"{p.filter.resource_type!r}"
                        if p.filter.resource_type else "an untyped filter")
                raise CrossShardWriteError(
                    f"write precondition on {desc} (shard(s) {shards}) "
                    f"cannot be checked atomically on shard {k}")
        shard_metrics.note_routed(k)
        return await self.shards[k].write_relationships(updates,
                                                        preconditions)

    async def _locate_internal_shard(self, updates: list,
                                     fallback: int) -> int:
        """Internal bookkeeping tuples ride the shard of the rule batch
        that writes them, so an internal-only batch DELETING one (a
        dual-write's post-success lock release) cannot recover the home
        shard from its own contents: the lock lives wherever the
        acquire batch's rule types routed it.  Locate the first deleted
        tuple across shards (internal-type reads fan out anyway) and
        land the batch there; when nothing is found — already released,
        or a pure-create batch — the deterministic hash fallback keeps
        retries converging."""
        target = next((u for u in updates if u.op == UpdateOp.DELETE), None)
        if target is None:
            return fallback
        flt = RelationshipFilter(
            resource_type=target.rel.resource.type,
            resource_id=target.rel.resource.id,
            relation=target.rel.relation,
            subject=SubjectFilter(type=target.rel.subject.type,
                                  id=target.rel.subject.id))
        hits = await asyncio.gather(
            *(ep.read_relationships(flt) for ep in self.shards))
        for k, rels in enumerate(hits):
            if rels:
                return k
        return fallback

    # -- cross-shard verbs ---------------------------------------------------

    async def read_relationships(self, flt: RelationshipFilter) -> list:
        ks = self.pmap.shards_for_filter(flt)
        if len(ks) == 1:
            shard_metrics.note_routed(ks[0])
            return await self.shards[ks[0]].read_relationships(flt)
        shard_metrics.note_fanout("read")
        parts = await asyncio.gather(
            *(self.shards[k].read_relationships(flt) for k in ks))
        out: list = []
        for part in parts:
            out.extend(part)
        return out

    async def read_relationships_stream(self, flt: RelationshipFilter):
        ks = self.pmap.shards_for_filter(flt)
        if len(ks) == 1:
            # single-shard streams stay lazy; only the cross-shard
            # fan-out materializes (via read_relationships)
            shard_metrics.note_routed(ks[0])
            async for rel in self.shards[ks[0]].read_relationships_stream(
                    flt):
                yield rel
            return
        for rel in await self.read_relationships(flt):
            yield rel

    async def delete_relationships(self, flt: RelationshipFilter,
                                   preconditions: Iterable[Precondition] = ()) -> int:
        ks = self.pmap.shards_for_filter(flt)
        preconditions = list(preconditions)
        if len(ks) == 1:
            shard_metrics.note_routed(ks[0])
            return await self.shards[ks[0]].delete_relationships(
                flt, preconditions)
        if preconditions:
            shard_metrics.note_cross_write_reject()
            raise CrossShardWriteError(
                "cross-shard delete_by_filter cannot carry preconditions "
                "(no single leader checks them atomically); scope the "
                "filter to one resource type")
        shard_metrics.note_fanout("delete_by_filter")
        revs = await asyncio.gather(
            *(self.shards[k].delete_relationships(flt) for k in ks))
        # no single token spans shards; the max component is the
        # conservative bound (HTTP callers get the true vector stamp)
        return max(revs)

    def watch(self, object_types: Optional[Iterable[str]] = None) -> Watcher:
        types = list(object_types) if object_types else None
        ks = self.pmap.shards_for_types(types)
        if len(ks) == 1:
            shard_metrics.note_routed(ks[0])
            return self.shards[ks[0]].watch(types)
        shard_metrics.note_fanout("watch")
        merged = MergedWatcher([self.shards[k].watch(types) for k in ks])
        self._watchers = [w for w in self._watchers if not w.closed]
        self._watchers.append(merged)
        return merged

    # -- lifecycle -----------------------------------------------------------

    def revision_vector(self) -> RevisionVector:
        return RevisionVector({k: store.revision
                               for k, store in
                               enumerate(self.shard_stores())})

    def warm_start(self, prewarm: bool = False) -> None:
        for ep in self.shards:
            warm = _walk_attr(ep, "warm_start")
            if warm is not None:
                warm(prewarm=prewarm)

    def wait_rebuilds(self, timeout: float = 30.0) -> None:
        for ep in self.shards:
            wait = _walk_attr(ep, "wait_rebuilds")
            if wait is not None:
                wait(timeout)

    def queue_depth(self) -> int:
        total = 0
        for ep in self.shards:
            fn = _walk_attr(ep, "queue_depth")
            if fn is not None:
                total += int(fn())
        return total

    def explain_check(self, *args, **kwargs):
        """Route an explain to the owning shard (the resource is the
        first positional argument, a CheckRequest or ObjectRef)."""
        target = args[0]
        resource = getattr(target, "resource", target)
        k = self.pmap.shard_of(resource.type, getattr(resource, "id", ""))
        fn = _walk_attr(self.shards[k], "explain_check")
        if fn is None:
            raise AttributeError("shard endpoint exposes no explain_check")
        return fn(*args, **kwargs)

    @property
    def stats(self) -> dict:
        out: dict = {"shards": self.pmap.n_shards}
        for k, ep in enumerate(self.shards):
            inner_stats = getattr(ep, "stats", None)
            if not isinstance(inner_stats, dict):
                continue
            for key, val in inner_stats.items():
                if isinstance(val, (int, float)):
                    out[key] = out.get(key, 0) + val
        return out

    def close_watches(self) -> None:
        """Close every merged watch stream still open; their pump
        threads end with them."""
        watchers, self._watchers = self._watchers, []
        for w in watchers:
            w.close()

    async def close(self) -> None:
        self.close_watches()
        await asyncio.gather(*(ep.close() for ep in self.shards))


def build_sharded_endpoint(url: str, bootstrap, pmap: PartitionMap,
                           stores: list, rule_configs: Iterable = (),
                           **kwargs) -> ShardedEndpoint:
    """Assemble the in-process composition: parse + validate the schema
    against the partition map (hard error when any footprint closure
    spans shards), split the bootstrap relationships by shard, and
    build one `create_endpoint(url)` per shard over its own store.

    Each shard endpoint carries the FULL schema (validation and
    compiled programs are per-shard identical) but only its own types'
    tuples — the footprint proof is what makes per-shard evaluation
    equal to whole-store evaluation.  The validation runs before any
    endpoint is built, so a refused map allocates no graph."""
    from ..endpoints import (
        Bootstrap,
        DEFAULT_BOOTSTRAP_SCHEMA,
        create_endpoint,
        merge_internal_definitions,
    )
    if len(stores) != pmap.n_shards:
        raise RouterConfigError(
            f"{pmap.n_shards} shard(s) configured but {len(stores)} "
            f"store(s) supplied")
    schema_text = (bootstrap.schema_text
                   if bootstrap is not None and bootstrap.schema_text
                   else DEFAULT_BOOTSTRAP_SCHEMA)
    schema = merge_internal_definitions(sch.parse_schema(schema_text))
    errors, warnings = pmap.validate_schema(schema, rule_configs)
    for where, msg in warnings:
        logger.warning("partition map: [%s] %s", where, msg)
    if errors:
        raise RouterConfigError(
            "partition map fails footprint validation (SL007):\n  "
            + "\n  ".join(f"[{w}] {m}" for w, m in errors))
    # split bootstrap relationships by shard: each shard's endpoint
    # bootstraps exactly its own tuple subset (bootstrap-once semantics
    # per shard store, as on any single leader)
    rel_lines: dict = {k: [] for k in range(pmap.n_shards)}
    if bootstrap is not None and bootstrap.relationships_text:
        for line in bootstrap.relationships_text.splitlines():
            stripped = line.strip()
            if not stripped or stripped.startswith("#"):
                continue
            rel = parse_relationship(stripped)
            k = pmap.shard_of(rel.resource.type, rel.resource.id)
            rel_lines[k].append(line)
    shards = []
    for k in range(pmap.n_shards):
        shard_boot = Bootstrap(
            schema_text=schema_text,
            relationships_text="\n".join(rel_lines[k]))
        shards.append(create_endpoint(url, bootstrap=shard_boot,
                                      store=stores[k], **dict(kwargs)))
    return ShardedEndpoint(pmap, shards, schema=schema)


# -- HTTP-level thin router ---------------------------------------------------


def build_routing_table(pmap: PartitionMap, rule_configs: Iterable,
                        schema: Optional[sch.Schema] = None) -> dict:
    """kube resource name -> shard, derived from the rule configs: a
    request for resource R routes to the one shard owning every type
    R's rules touch (closure-expanded when a schema is supplied).
    Raises RouterConfigError when a rule's types span shards or two
    rules pin one resource to different shards — the SL007 condition,
    enforced at router startup so misrouting is impossible at serve
    time."""
    from ..schema_lint import _iter_rule_templates, _parse_template
    rule_types: dict = {}
    if schema is not None:
        for rule_name, types in pmap._rule_type_sets(schema, rule_configs):
            rule_types[rule_name] = types
    else:
        for rule_name, tpl in _iter_rule_templates(rule_configs or ()):
            parsed = _parse_template(tpl)
            if parsed is None:
                continue
            rtype, _rel, _stype, _srel = parsed
            rule_types.setdefault(rule_name, set()).add(rtype)
    table: dict = {}
    pinned_by: dict = {}
    for cfg in rule_configs or ():
        types = rule_types.get(cfg.name, set())
        shards = sorted({pmap.shard_for_type(t) for t in types
                         if t not in INTERNAL_TYPES
                         and (schema is None or t in schema.definitions)})
        if len(shards) > 1:
            raise RouterConfigError(
                f"rule {cfg.name!r} touches types on shards {shards} "
                f"({sorted(types)}): an unroutable dual-write — "
                f"co-locate these types in the partition map")
        shard = shards[0] if shards else pmap.default_shard
        for m in cfg.spec.matches:
            prev = table.get(m.resource)
            if prev is not None and prev != shard:
                raise RouterConfigError(
                    f"resource {m.resource!r} is pinned to shard {prev} "
                    f"by rule {pinned_by[m.resource]!r} and to shard "
                    f"{shard} by rule {cfg.name!r}; every rule matching "
                    f"one resource must route to one shard")
            table[m.resource] = shard
            pinned_by[m.resource] = cfg.name
    return table


def _status(code: int, message: str, reason: str = "", **extra) -> dict:
    out = {"kind": "Status", "apiVersion": "v1", "metadata": {},
           "status": "Failure"}
    if reason:
        out["reason"] = reason
    out.update(code=code, message=message, **extra)
    return out


class ShardRouter:
    """The thin stateless HTTP router: one async handler, N shard
    transports.  See the module docstring for the contract."""

    def __init__(self, pmap: PartitionMap, transports: list,
                 rule_configs: Iterable = (),
                 schema: Optional[sch.Schema] = None,
                 fleet_peers: Iterable = (),
                 fleet_transports: Optional[dict] = None):
        if len(transports) != pmap.n_shards:
            raise RouterConfigError(
                f"{pmap.n_shards} shard(s) configured but "
                f"{len(transports)} shard-leader transport(s) supplied")
        self.pmap = pmap
        self.transports = list(transports)
        self.table = build_routing_table(pmap, rule_configs, schema)
        self.stats = {"routed": 0, "route_errors": 0, "health_fanouts": 0}
        # fleet tracing: the member base URLs /debug/fleet fans out to
        # (typically the shard leaders plus any --fleet-peers);
        # fleet_transports (url -> Transport) is the test seam, as
        # Options.peer_transports is the server's
        self.fleet_peers = list(fleet_peers)
        self.fleet_transports = dict(fleet_transports or {})

    # the router IS a Handler (proxy/httpcore.py)
    async def __call__(self, req):
        return await self.handle(req)

    def shard_for_request(self, req) -> int:
        from ...proxy.kube import parse_request_info
        try:
            info = parse_request_info(req.method, req.target)
        except Exception:
            return self.pmap.default_shard
        if info is not None and getattr(info, "resource", ""):
            return self.table.get(info.resource, self.pmap.default_shard)
        return self.pmap.default_shard

    async def handle(self, req):
        from ...proxy.httpcore import json_response
        from ...utils import tracing
        from .. import replication as repl
        if not shard_metrics.enabled():
            # killswitch: transparent pass-through to the default shard
            # for EVERY path — health, /metrics, and traffic alike —
            # headers untouched: exactly a single-leader deployment
            return await self._forward(req, self.pmap.default_shard,
                                       rewrite=False)
        if req.path in ("/readyz", "/livez", "/healthz"):
            return await self._aggregate_health(req)
        if req.path == "/metrics":
            from ...proxy.httpcore import Response
            from ...utils.metrics import REGISTRY
            resp = Response(status=200, body=REGISTRY.render().encode())
            resp.headers.set("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            return resp
        if req.path in ("/debug/traces", "/debug/fleet", "/debug/tail"):
            return await self._serve_debug(req)
        shard = self.shard_for_request(req)
        raw_token = req.headers.get(repl.MIN_REVISION_HEADER)
        try:
            vec = RevisionVector.decode(raw_token)
        except RevisionVectorError as e:
            self.stats["route_errors"] += 1
            return json_response(400, _status(
                400, f"invalid {repl.MIN_REVISION_HEADER} "
                     f"revision-vector token: {e}"))
        # fleet tracing: the router is the fleet's front tier — it starts
        # (or joins) the request trace, so the merged view attributes the
        # router's time and the routed hop's network share apart from the
        # shard leader's.  Propagation switched off: no trace and no
        # headers, the forward as it would be without fleet tracing
        tr = token = None
        if tracing.propagation_enabled():
            tr, token = tracing.start_trace(
                trace_id=(tracing.clean_trace_id(
                    req.headers.get(tracing.PROP_TRACE_HEADER))
                    or tracing.clean_trace_id(
                        req.headers.get(tracing.TRACE_ID_HEADER))),
                method=req.method, target=req.target)
            incoming = tracing.clean_tier_path(
                req.headers.get(tracing.PROP_TIER_PATH_HEADER))
            tr.attrs["tier"] = "router"
            tr.attrs["tier_path"] = (incoming + ">router" if incoming
                                     else "router")
            parent = tracing.clean_trace_id(
                req.headers.get(tracing.PROP_PARENT_HEADER))
            if parent and tracing.clean_trace_id(
                    req.headers.get(tracing.PROP_TRACE_HEADER)):
                tr.attrs["parent_span"] = parent
        try:
            resp = await self._forward(req, shard, vector=vec)
        except BaseException:
            if tr is not None:
                tracing.end_trace(token)
                tr.finish()
                tracing.RECORDER.record(tr)
            raise
        if tr is not None:
            tracing.end_trace(token)
            tr.finish()
            tr.attrs["status"] = resp.status
            tracing.RECORDER.record(tr)
            resp.headers.set(tracing.TRACE_ID_HEADER, tr.trace_id)
        return resp

    async def _forward(self, req, shard: int, rewrite: bool = True,
                       vector: Optional[RevisionVector] = None):
        from ...proxy.httpcore import Headers, Request, json_response
        from ...utils import tracing
        from .. import replication as repl
        up = Headers()
        for k, v in req.headers.items():
            lk = k.lower()
            if lk in ("connection", "content-length", "host"):
                continue
            if rewrite and lk == repl.MIN_REVISION_HEADER.lower():
                continue  # replaced by the single component below
            up.add(k, v)
        if rewrite and vector is not None:
            component = vector.component(shard)
            if component > 0:
                # the shard leader sees a plain integer: its existing
                # wait-or-forward gate enforces ONLY its own component
                up.set(repl.MIN_REVISION_HEADER, str(component))
        try:
            # fleet tracing: the shard leader joins this trace, and the
            # hop span isolates network time from the leader's.  With no
            # active trace (switch off, killswitch pass-through) the
            # headers are empty and the forward is unchanged
            with tracing.hop_span("hop.shard_forward", tier="router",
                                  shard=shard) as hop:
                for hk, hv in hop.headers.items():
                    up.set(hk, hv)
                resp = await self.transports[shard].round_trip(Request(
                    method=req.method, target=req.target, headers=up,
                    body=req.body))
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self.stats["route_errors"] += 1
            return json_response(502, _status(
                502, f"shard {shard} leader unreachable: {e}",
                reason="BadGateway", details={"shard": shard}))
        self.stats["routed"] += 1
        shard_metrics.note_routed(shard)
        if rewrite:
            shard_rev = (resp.headers.get(repl.REVISION_HEADER) or "")
            if shard_rev.isdigit():
                merged = (vector or RevisionVector()).merged(
                    shard, int(shard_rev))
                resp.headers.set(repl.REVISION_HEADER, merged.encode())
            resp.headers.set("X-Authz-Shard", str(shard))
        return resp

    async def _serve_debug(self, req):
        """Router-side observability: /debug/traces (this process's
        recorder), /debug/fleet (the merged cross-process view over
        `fleet_peers`) and /debug/tail (its tail report).  At the
        fleet's trust level: the caller must present SOME identity
        (X-Remote-User from a trusted transport path, or an
        Authorization header the shard leaders would verify) — the
        router itself runs no authenticator."""
        from ...proxy.httpcore import json_response
        from ...utils import tracing
        if not (req.headers.get("X-Remote-User")
                or req.headers.get("Authorization")):
            return json_response(401, _status(401, "Unauthorized",
                                              reason="Unauthorized"))
        if req.path == "/debug/traces":
            return json_response(200, {
                "capacity": tracing.RECORDER.capacity,
                "traces": tracing.RECORDER.snapshot()})
        from ...utils import fleet as fleetmod
        peers = self.fleet_peers
        if not peers:
            return json_response(200, {
                "enabled": False, "tier": "router",
                "reason": "no fleet peers configured"})
        # forward the caller's identity and authorization verbatim — the
        # members authenticate it as they would a direct scrape
        fwd = [(k, v) for k, v in req.headers.items()
               if k.lower().startswith("x-remote-")
               or k.lower() == "authorization"]
        members = await fleetmod.collect_fleet(
            peers, headers=fwd, transports=self.fleet_transports)
        local = {"url": "router", "error": None,
                 "traces": tracing.RECORDER.snapshot(),
                 "flight": {}, "skew_s": None, "lag_s": None}
        merged = fleetmod.merge_fleet([local] + members)
        merged["enabled"] = True
        merged["tier"] = "router"
        if req.path == "/debug/tail":
            from ...utils import tailexplain
            if not tailexplain.enabled():
                return json_response(200, {
                    "enabled": False, "tier": "router",
                    "reason": "TailExplain feature gate disabled"})
            report = tailexplain.explain(merged)
            report["tier"] = "router"
            return json_response(200, report)
        return json_response(200, merged)

    async def _aggregate_health(self, req):
        from ...proxy.httpcore import Request, Response
        self.stats["health_fanouts"] += 1
        shard_metrics.note_fanout("health")

        async def probe(k: int):
            try:
                return await self.transports[k].round_trip(
                    Request(method="GET", target=req.path))
            except asyncio.CancelledError:
                raise
            except Exception as e:
                return Response(status=503,
                                body=f"shard {k} unreachable: {e}".encode())

        results = await asyncio.gather(
            *(probe(k) for k in range(self.pmap.n_shards)))
        lines = []
        degraded = False
        for k, r in enumerate(results):
            body = (r.body or b"").decode("utf-8", errors="replace")
            if r.status != 200:
                degraded = True
                lines.append(f"[-] shard {k}: {r.status} "
                             f"{body.splitlines()[0] if body else ''}")
            elif "[!]" in body or "[-]" in body:
                lines.append(f"[!] shard {k}: degraded")
            else:
                lines.append(f"ok shard {k}")
        # readyz contract mirrors the proxy's: any shard DOWN makes the
        # router degraded-but-200 (the healthy shards keep serving their
        # types — ejecting the router would turn a partial outage into a
        # total one); livez follows the router process itself
        return Response(status=200, body="\n".join(lines).encode()
                        if (degraded or len(lines) > 1)
                        else b"ok")


class RouterServer:
    """Process wrapper: HttpServer serving a ShardRouter (the
    `--shard-leaders` CLI mode)."""

    def __init__(self, pmap: PartitionMap, leader_urls: list,
                 rule_configs: Iterable = (),
                 schema: Optional[sch.Schema] = None,
                 transports: Optional[list] = None, ssl_context=None,
                 fleet_peers: Iterable = ()):
        if transports is None:
            from ...proxy.httpcore import H11Transport
            transports = [H11Transport(u) for u in leader_urls]
        self.leader_urls = list(leader_urls)
        # /debug/fleet members: every shard leader plus any extra
        # fleet_peers (e.g. followers behind the leaders); the shard
        # transports are reused, so a test seam carries over to the
        # fleet fan-out
        members = list(leader_urls) + [u for u in fleet_peers
                                       if u not in leader_urls]
        self.router = ShardRouter(
            pmap, transports, rule_configs=rule_configs, schema=schema,
            fleet_peers=members,
            fleet_transports=dict(zip(leader_urls, transports)))
        self._ssl_context = ssl_context
        self._http = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        from ...proxy.httpcore import HttpServer
        self._http = HttpServer(self.router, ssl_context=self._ssl_context)
        return await self._http.start(host, port)

    async def stop(self) -> None:
        if self._http is not None:
            await self._http.stop()
            self._http = None
