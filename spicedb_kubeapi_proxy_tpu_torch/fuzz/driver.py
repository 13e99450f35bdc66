"""Differential replay driver: `torch://` endpoints vs the host oracle,
swept across the gate matrix and the replication-role matrix.

The port's counterpart of the reference's fuzz/driver.py.  One
`FuzzCase` (fully derived from its seed, equal to the reference's for the
same seed and biases) replays against the port's device endpoint built
over the store a REPLICATION ROLE produces:

- `leader`      deltas land via `store.write` / `delete_by_filter` /
                `bulk_load` — the single-node path;
- `follower2`   a plain leader store fans every committed batch through
                TWO `apply_replica_batch` hops (leader -> mid -> leaf);
                leader bulk loads re-bootstrap each hop via
                `replica_reset` — the device graph, decision-cache
                epochs and expiry heaps on the LEAF must follow through
                the replica delta pipeline;
- `promoted`    a 1-hop follower consumes the first half of the stream,
                then promotes: the remaining bursts are written
                DIRECTLY to the promoted store (the post-
                `/replication/promote` serving shape);
- `sharded2`    the stream routes through a schema-derived (and
                footprint-revalidated) partition map into TWO
                partition-leader stores behind a `ShardedEndpoint`
                (spicedb/sharding) while the oracle reads a single
                mirror store of the full stream;
- `mesh`        a single leader store served by a THREE-way
                differential: a 2 x 2 (data x graph) mesh endpoint,
                co-located on the one device and built without the
                Leopard index (so the mesh sweep answers), and a plain
                single-device endpoint answer every query over the same
                store — a mesh-vs-single disagreement fails the replay
                loudly, and the mesh answer is then compared against the
                host oracle like any other cell (ELL only, as the mesh
                path is);
- `leopard`     a single leader store served by another THREE-way
                differential: a Leopard-indexed endpoint
                (`TorchEndpoint(leopard=True)`) and an index-free one
                (`leopard=False`) over the same store; an
                indexed-vs-plain disagreement fails the replay loudly,
                and the indexed answer is compared against the oracle.

After every checkpoint, every query of the case's query stream is
answered by the device endpoint and by a fresh `Evaluator` over the SAME
store, at the same revision (the driver is the only writer).  Any
mismatch is a `Divergence`.  Answers are exact: there is no tolerance.

Gate combos (the reference's killswitch matrix, by its gate names):

- `off`    DecisionCache / DevicePipeline / AsyncRebuild all OFF
           (the bare serial kernel path);
- `cache`  DecisionCache ON, pipeline OFF, AsyncRebuild OFF — cache
           coherence against the oracle;
- `full`   all three ON — the production chain.

The port's gates are module switches (utils/features.py), each read at
its own time: ASYNC_REBUILD at every rebuild, DEVICE_PIPELINE at every
drain of the batching dispatcher, LEOPARD_INDEX at endpoint
construction, DECISION_CACHE only by the endpoint factory.  `gates_set`
sets the switches of a combo for the whole replay and restores them on
every exit.  The endpoints are built here rather than by the factory, so
the combo is also made explicit: the decision cache wraps the endpoint
(`DecisionCacheEndpoint`) when DecisionCache is on, and the dispatcher
(`BatchingEndpoint`, whose drains read DEVICE_PIPELINE) sits under it
when DevicePipeline is on — the production chain of `torch://?cache=1`.
A query's lookups for one target are issued concurrently, so behind the
dispatcher they fuse into one batch.

Every entry point takes a `device`: None means the CUDA card, and on a
machine without one it raises unless `device="cpu"` is asked for (the
tests do, running the kernels' plain-torch twins); nothing falls back.
"""

from __future__ import annotations

import asyncio
import contextlib
import random
from dataclasses import dataclass, field

from ..device import resolve_device
from ..spicedb import schema as sch
from ..spicedb.evaluator import Evaluator
from ..spicedb.store import TupleStore
from ..spicedb.types import (
    CheckRequest,
    ObjectRef,
    RelationshipFilter,
    RelationshipUpdate,
    SubjectRef,
    UpdateOp,
    parse_relationship,
)
from ..utils import features
from . import metrics as fuzz_metrics
from .delta_gen import (
    DEFAULT_DELTA_BIAS,
    FakeClock,
    generate_bursts,
    id_universe,
    initial_rels,
)
from .schema_gen import DEFAULT_BIAS, generate_schema

GATE_COMBOS = {
    "off": {"DecisionCache": False, "DevicePipeline": False,
            "AsyncRebuild": False},
    "cache": {"DecisionCache": True, "DevicePipeline": False,
              "AsyncRebuild": False},
    "full": {"DecisionCache": True, "DevicePipeline": True,
             "AsyncRebuild": True},
}

ROLES = ("leader", "follower2", "promoted")

# partitioned write scale-out (spicedb/sharding): the case replays
# through a ShardedEndpoint routing over TWO partition leaders, with a
# schema-derived co-location-valid partition map; the oracle reads a
# single mirror store receiving the same stream
SHARDED_ROLE = "sharded2"

# mesh execution (parallel/sharding.py): a 2x2 mesh endpoint co-located
# on the device, held against a single-device endpoint over the same
# store, and its answers against the host oracle
MESH_ROLE = "mesh"

# the Leopard closure index (ops/leopard.py): an indexed endpoint held
# against an index-free one over the same store, and its answers against
# the host oracle
LEOPARD_ROLE = "leopard"
ALL_ROLES = ROLES + (SHARDED_ROLE, MESH_ROLE, LEOPARD_ROLE)

SMOKE_KERNELS = ("segment", "ell")

# the gate combos the appended sharded/mesh/leopard smoke cells run
# under (the bare path and the full production chain)
SMOKE_SHARDED_GATES = ("off", "full")

# the co-located mesh of the `mesh` role
MESH_SHAPE = (2, 2)


def smoke_cell_for(seed: int) -> tuple:
    """The fixed (gates, role, kernel) cell a smoke seed lands in:
    seeds 0..24 walk the classic 3x3 gate x role matrix (every cell
    covered >= 2x) with the kernel alternating on top; seeds 25..26 are
    the `sharded2` cells (off/full gates, kernels alternating); seeds
    27..28 are the `mesh` cells (off/full gates, ell kernel only — the
    mesh path requires it); seeds >= 29 are the `leopard` cells (off/full
    gates, kernels alternating, nested-groups schema bias).  Equal to
    the reference's map, so 'the fixed seed set' means one thing in
    both packages."""
    if seed >= 29:
        return (SMOKE_SHARDED_GATES[(seed - 29) % 2], LEOPARD_ROLE,
                SMOKE_KERNELS[seed % 2])
    if seed >= 27:
        return (SMOKE_SHARDED_GATES[(seed - 27) % 2], MESH_ROLE, "ell")
    if seed >= 25:
        return (SMOKE_SHARDED_GATES[(seed - 25) % 2], SHARDED_ROLE,
                SMOKE_KERNELS[seed % 2])
    return (tuple(GATE_COMBOS)[seed % 3], ROLES[(seed // 3) % 3],
            SMOKE_KERNELS[seed % 2])


_P3 = {"NO_PERMISSION": 0, "CONDITIONAL_PERMISSION": 1, "HAS_PERMISSION": 2}


@dataclass
class FuzzCase:
    """Everything a replay needs; serializes to the repro artifact."""
    seed: int
    schema_text: str
    init_rels: list           # rel strings, bulk-loaded at revision 1
    bursts: list              # serialized delta stream (delta_gen format)
    targets: list             # [(resource_type, permission), ...]
    subjects: list            # subject id strings ("user:u1")
    kernel: str = "ell"
    schema: sch.Schema = field(default=None, repr=False, compare=False)

    def parsed_schema(self) -> sch.Schema:
        if self.schema is None:
            self.schema = sch.parse_schema(self.schema_text)
        return self.schema


@dataclass
class Divergence:
    seed: int
    gates: str
    role: str
    kernel: str
    step: int                 # burst index the divergence was seen after
    query: dict               # {"kind": "check"|"lookup", ...}
    got: object               # device-side answer
    want: object              # oracle answer
    revision: int

    def line(self) -> str:
        return (f"DIVERGENCE seed={self.seed} gates={self.gates} "
                f"role={self.role} kernel={self.kernel} step={self.step} "
                f"rev={self.revision} query={self.query} "
                f"torch={self.got!r} oracle={self.want!r}")


def build_case(seed: int, schema_bias=DEFAULT_BIAS,
               delta_bias=DEFAULT_DELTA_BIAS, kernel: str = "ell",
               n_bursts: int = None, smoke: bool = False) -> FuzzCase:
    """Derive the full (schema, deltas, queries) triple from `seed`.

    `smoke=True` is the fixed-set profile: the same generator universe
    but trimmed replay cost (shorter stream, ONE deepest-footprint
    target, 2 subjects + the stranger); the open-ended budgeted search
    runs the full-size profile."""
    rng = random.Random(seed * 2_654_435_761 % (2 ** 31))
    if smoke and schema_bias is DEFAULT_BIAS:
        from .schema_gen import SMOKE_BIAS
        schema_bias = SMOKE_BIAS
    text, schema = generate_schema(seed, bias=schema_bias)
    clock = FakeClock()
    ids = id_universe(schema, rng)
    init = initial_rels(schema, rng, clock, ids, delta_bias,
                        rng.randint(6, 18))
    if n_bursts is None:
        n_bursts = rng.randint(2, 3) if smoke else rng.randint(3, 6)
    bursts = generate_bursts(schema, rng, clock, ids, delta_bias, n_bursts)
    # query targets: every (type, permission) pair, deepest closures
    # first (relation_footprint bias), capped for replay cost
    from ..ops.graph_compile import relation_footprint
    pairs = [(tname, pname)
             for tname, d in schema.definitions.items()
             for pname in d.permissions]
    pairs.sort(key=lambda p: (-len(relation_footprint(schema, *p)), p))
    targets = pairs[:1 if smoke else 3]
    user_ids = ids.get("user", [])
    subjects = [f"user:{u}" for u in
                rng.sample(user_ids, min(2 if smoke else 3, len(user_ids)))]
    subjects.append("user:stranger")
    return FuzzCase(seed=seed, schema_text=text, init_rels=init,
                    bursts=bursts, targets=targets, subjects=subjects,
                    kernel=kernel, schema=schema)


@contextlib.contextmanager
def gates_set(combo: str):
    """Set the switches of a gate combo (by the reference's gate names,
    `features.GATE_SWITCHES`) and restore them on every exit."""
    names = [features.GATE_SWITCHES[k] for k in GATE_COMBOS[combo]]
    prev = {n: getattr(features, n) for n in names}
    try:
        for gate, on in GATE_COMBOS[combo].items():
            setattr(features, features.GATE_SWITCHES[gate], on)
        yield
    finally:
        for n, v in prev.items():
            setattr(features, n, v)


# -- role plumbing ------------------------------------------------------------


class _RoleHarness:
    """Owns the store topology of one replay and routes bursts into it.

    `query_store` is the store the device endpoint and the oracle both
    read — the leaf of whatever replication chain the role builds."""

    def __init__(self, role: str, clock: FakeClock, n_bursts: int,
                 schema: sch.Schema = None):
        self.role = role
        self.clock = clock
        self.leader = TupleStore(clock=clock.now)
        self._recorded: list = []      # captured committed delta batches
        self._leader_reset = False
        self._promote_at = n_bursts // 2 if role == "promoted" else None
        self._promoted = False
        self.pmap = None               # sharded2: the partition map
        self.shard_stores: list = []   # sharded2: per-shard stores
        if role in ("leader", MESH_ROLE, LEOPARD_ROLE):
            # mesh/leopard: the leader's single-store topology; the
            # differential endpoint pair is built later
            self.query_store = self.leader
            self.hops = []
        elif role == "follower2":
            self.hops = [TupleStore(clock=clock.now),
                         TupleStore(clock=clock.now)]
            self.query_store = self.hops[-1]
        elif role == "promoted":
            self.hops = [TupleStore(clock=clock.now)]
            self.query_store = self.hops[-1]
        elif role == SHARDED_ROLE:
            # two partition leaders behind a ShardedEndpoint; the oracle
            # reads `self.leader` as a single mirror of the full stream.
            # The map is DERIVED per schema (co-location classes from
            # the footprint closures) and re-validated: the footprint
            # validator must accept it or the harness fails loudly.
            from ..spicedb.sharding import partition_map_for_schema
            if schema is None:
                raise ValueError("sharded2 role needs the case schema")
            self.hops = []
            self.query_store = self.leader
            self.pmap = partition_map_for_schema(schema, 2)
            errors, _ = self.pmap.validate_schema(schema)
            if errors:
                raise AssertionError(
                    f"derived partition map failed footprint "
                    f"validation: {errors}")
            self.shard_stores = [TupleStore(clock=clock.now)
                                 for _ in range(2)]
        else:
            raise ValueError(f"unknown role {role!r}")
        if self.hops:
            # delta listeners run under the leader store lock; recording
            # is append-only and the driver drains OUTSIDE the lock
            self.leader.add_delta_listener(self._record_delta)
            self.leader.add_reset_listener(self._record_reset)

    def _record_delta(self, update) -> None:
        self._recorded.append(update.updates)

    def _record_reset(self) -> None:
        self._leader_reset = True

    def _drain_into_hops(self) -> None:
        if self._leader_reset:
            # leader bulk-load/clear: each hop re-bootstraps from its
            # upstream exactly like a follower losing its tail does
            self._leader_reset = False
            self._recorded.clear()
            upstream = self.leader
            for hop in self.hops:
                hop.replica_reset(None, upstream.read(None),
                                  upstream.revision)
                upstream = hop
            return
        batches, self._recorded = self._recorded, []
        for updates in batches:
            for hop in self.hops:
                hop.apply_replica_batch(updates)

    def seed_initial(self, rels: list) -> None:
        parsed = [parse_relationship(r) for r in rels]
        self.leader.bulk_load(parsed)
        if self.hops:
            self._drain_into_hops()
        if self.shard_stores:
            self._route_bulk(parsed)

    # -- sharded2 plumbing ---------------------------------------------------

    def _route_bulk(self, rels: list) -> None:
        groups: dict = {}
        for rel in rels:
            k = self.pmap.shard_of(rel.resource.type, rel.resource.id)
            groups.setdefault(k, []).append(rel)
        for k, subset in sorted(groups.items()):
            self.shard_stores[k].bulk_load(subset)

    def _route_burst(self, burst: dict) -> None:
        """Mirror one burst into the partition leaders, routed by the
        partition map — the stream a real router would deliver."""
        kind = burst["kind"]
        if kind == "advance":
            return  # the FakeClock is shared by every store
        if kind == "write":
            groups: dict = {}
            for op in burst["ops"]:
                rel = parse_relationship(op["rel"])
                k = self.pmap.shard_of(rel.resource.type, rel.resource.id)
                groups.setdefault(k, []).append(RelationshipUpdate(
                    UpdateOp.DELETE if op["op"] == "delete"
                    else UpdateOp.TOUCH, rel))
            for k, ups in sorted(groups.items()):
                self.shard_stores[k].write(ups)
        elif kind == "dbf":
            flt = RelationshipFilter(
                resource_type=burst["resource_type"],
                relation=burst["relation"],
                resource_id=burst["resource_id"])
            for k in self.pmap.shards_for_filter(flt):
                self.shard_stores[k].delete_by_filter(flt)
        elif kind == "bulk":
            self._route_bulk([parse_relationship(r)
                              for r in burst["rels"]])

    def _writable_store(self) -> TupleStore:
        if self._promoted:
            return self.hops[-1]
        return self.leader

    def apply_burst(self, i: int, burst: dict) -> None:
        if self._promote_at is not None and i >= self._promote_at:
            if not self._promoted:
                # promotion: stop consuming the old leader; the adopted
                # state keeps serving and the remaining stream lands as
                # DIRECT writes on the promoted store
                self.leader.remove_delta_listener(self._record_delta)
                self._recorded.clear()
                self._promoted = True
        store = self._writable_store()
        kind = burst["kind"]
        if kind == "advance":
            self.clock.advance(burst["dt"])
        elif kind == "write":
            store.write([
                RelationshipUpdate(
                    UpdateOp.DELETE if op["op"] == "delete"
                    else UpdateOp.TOUCH,
                    parse_relationship(op["rel"]))
                for op in burst["ops"]])
        elif kind == "dbf":
            store.delete_by_filter(RelationshipFilter(
                resource_type=burst["resource_type"],
                relation=burst["relation"],
                resource_id=burst["resource_id"]))
        elif kind == "bulk":
            store.bulk_load([parse_relationship(r)
                             for r in burst["rels"]])
        else:
            raise ValueError(f"unknown burst kind {kind!r}")
        if self.hops and not self._promoted:
            self._drain_into_hops()
        if self.shard_stores:
            self._route_burst(burst)

    def build_endpoint(self, schema: sch.Schema, kernel: str, gates: str,
                       device):
        """The device endpoint under test for this role: a
        `TorchEndpoint` over the query store, or (sharded2) a
        `ShardedEndpoint` over one per shard, each wrapped for the gate
        combo (`_wrap`: dispatcher, then decision cache, per shard as a
        sharded deployment runs them).  The mesh and Leopard roles pair
        the endpoint under test with a bare independent checker."""
        from ..ops.torch_endpoint import TorchEndpoint

        def bare(store, **kw):
            return TorchEndpoint(schema, store=store, kernel=kernel,
                                 device=device, **kw)

        if self.role == SHARDED_ROLE:
            from ..spicedb.sharding import ShardedEndpoint
            return ShardedEndpoint(
                self.pmap, [_wrap(bare(s), gates) for s in self.shard_stores],
                schema=schema)
        if self.role == MESH_ROLE:
            from ..parallel.sharding import make_mesh
            data, graph = MESH_SHAPE
            mesh = make_mesh([device] * (data * graph), data=data,
                             graph=graph)
            # the mesh endpoint goes without the Leopard index, so its
            # reads run the mesh sweep (a fuzz-sized graph is otherwise
            # served from the closure plane and no mesh kernel runs);
            # the single-device checker keeps the default
            return _DifferentialEndpoint(
                _wrap(bare(self.query_store, mesh=mesh, leopard=False),
                      gates),
                bare(self.query_store), "mesh", "single-device")
        if self.role == LEOPARD_ROLE:
            # the index is chosen at construction, so an indexed and an
            # index-free endpoint coexist over the same store
            return _DifferentialEndpoint(
                _wrap(bare(self.query_store, leopard=True), gates),
                bare(self.query_store, leopard=False),
                "leopard-indexed", "index-free")
        return _wrap(bare(self.query_store), gates)


def _wrap(ep, gates: str):
    """The gate combo's production chain over a bare endpoint: the
    dispatcher when DevicePipeline is on, the decision cache above it
    when DecisionCache is on."""
    combo = GATE_COMBOS[gates]
    if combo["DevicePipeline"]:
        from ..spicedb.dispatch import BatchingEndpoint
        ep = BatchingEndpoint(ep)
    if combo["DecisionCache"]:
        from ..spicedb.decision_cache import DecisionCacheEndpoint
        ep = DecisionCacheEndpoint(ep)
    return ep


class _DifferentialEndpoint:
    """Three-way differential shim of the `mesh` and `leopard` roles:
    every query runs on the endpoint under test AND a bare independent
    checker over the same store.  A disagreement between the two fails
    the replay loudly; the tested endpoint's answer is what the driver
    then compares against the host oracle, so all three pairwise
    comparisons are covered."""

    def __init__(self, tested, checker, tested_name: str,
                 checker_name: str):
        self._tested = tested
        self._checker = checker
        self._names = (tested_name, checker_name)

    def warm_start(self) -> None:
        self._tested.warm_start()
        self._checker.warm_start()

    def wait_rebuilds(self) -> None:
        for ep in (self._tested, self._checker):
            ep.wait_rebuilds()

    async def lookup_resources(self, rtype, perm, subject):
        got = await self._tested.lookup_resources(rtype, perm, subject)
        ref = await self._checker.lookup_resources(rtype, perm, subject)
        if sorted(got) != sorted(ref):
            raise AssertionError(
                f"{self._names[0]} vs {self._names[1]} lookup divergence "
                f"for {rtype}#{perm}@{subject}: {sorted(got)} against "
                f"{sorted(ref)}")
        return got

    async def check_bulk_permissions(self, reqs):
        got = await self._tested.check_bulk_permissions(reqs)
        ref = await self._checker.check_bulk_permissions(reqs)
        for req, g, s in zip(reqs, got, ref):
            if g.permissionship != s.permissionship:
                raise AssertionError(
                    f"{self._names[0]} vs {self._names[1]} check "
                    f"divergence for {req}: {g.permissionship.name} "
                    f"against {s.permissionship.name}")
        return got


# -- the replay ---------------------------------------------------------------


def _parse_subject(s: str) -> SubjectRef:
    stype, _, rest = s.partition(":")
    sid, _, srel = rest.partition("#")
    return SubjectRef(stype, sid, srel)


async def _compare_queries(case: FuzzCase, ep, oracle, step: int,
                           gates: str, role: str,
                           check_only: dict = None) -> list:
    """Run the query stream; return Divergences.  `check_only` restricts
    to one serialized query (the shrinker's single-query probe)."""
    out = []
    store = oracle.store
    rev = store.revision
    if check_only is not None:
        # single-query probe (the shrinker): evaluate exactly this query
        # against the end state, independent of id enumeration
        q = check_only
        subject = _parse_subject(q["subject"])
        if q["kind"] == "lookup":
            want = sorted(oracle.lookup_resources(q["type"], q["perm"],
                                                  subject))
            got = sorted(await ep.lookup_resources(q["type"], q["perm"],
                                                   subject))
            if got != want:
                out.append(Divergence(case.seed, gates, role, case.kernel,
                                      step, q, got, want, rev))
        else:
            rt, _, oid = q["resource"].partition(":")
            res = await ep.check_bulk_permissions(
                [CheckRequest(ObjectRef(rt, oid), q["perm"], subject)])
            got3 = _P3[res[0].permissionship.name]
            want3 = oracle.check3(ObjectRef(rt, oid), q["perm"], subject)
            if got3 != want3:
                out.append(Divergence(case.seed, gates, role, case.kernel,
                                      step, q, got3, want3, rev))
        return out
    for rtype, perm in case.targets:
        # one lookup a subject, issued together (a fused batch behind the
        # dispatcher), compared in the case's subject order
        gots = await asyncio.gather(*(
            ep.lookup_resources(rtype, perm, _parse_subject(s))
            for s in case.subjects))
        for s, got in zip(case.subjects, gots):
            q = {"kind": "lookup", "type": rtype, "perm": perm,
                 "subject": s}
            want = sorted(oracle.lookup_resources(rtype, perm,
                                                  _parse_subject(s)))
            if sorted(got) != want:
                out.append(Divergence(case.seed, gates, role,
                                      case.kernel, step, q, sorted(got),
                                      want, rev))
        ids = store.object_ids_of_type(rtype)[:12]
        if not ids:
            continue
        subjects = [_parse_subject(s) for s in case.subjects]
        wanted_queries = []
        reqs = []
        for oid in ids:
            for s, subject in zip(case.subjects, subjects):
                q = {"kind": "check", "resource": f"{rtype}:{oid}",
                     "perm": perm, "subject": s}
                wanted_queries.append((q, subject))
                reqs.append(CheckRequest(ObjectRef(rtype, oid), perm,
                                         subject))
        res = await ep.check_bulk_permissions(reqs)
        for (q, subject), r in zip(wanted_queries, res):
            got3 = _P3[r.permissionship.name]
            rt, _, oid = q["resource"].partition(":")
            want3 = oracle.check3(ObjectRef(rt, oid), q["perm"], subject)
            if got3 != want3:
                out.append(Divergence(case.seed, gates, role, case.kernel,
                                      step, q, got3, want3, rev))
    return out


def run_case(case: FuzzCase, gates: str = "off", role: str = "leader",
             stop_on_first: bool = False, check_only: dict = None,
             final_only: bool = False, checkpoints: str = "every",
             record_metrics: bool = True, device=None) -> list:
    """Replay one (case, gate-combo, role) cell on `device` (None: the
    CUDA card); returns Divergences.

    `checkpoints` picks where the query stream runs: "every" compares
    after the initial load and every burst (the budgeted search);
    "ends" compares after the initial load and the final burst only;
    "final" warm-starts the device graph over the initial state (so the
    stream still flows through the live intake/absorb machinery) and
    compares once after the last burst — one graph build per cell, which
    is what keeps the fixed-seed matrix short.

    `final_only` + `check_only` are the shrinker's probe mode: apply the
    whole stream, then evaluate one query once at the end state."""
    device = str(resolve_device(device))
    schema = case.parsed_schema()
    clock = FakeClock()
    harness = _RoleHarness(role, clock, len(case.bursts), schema=schema)
    divergences: list = []

    with gates_set(gates):
        harness.seed_initial(case.init_rels)
        ep = harness.build_endpoint(schema, case.kernel, gates, device)
        oracle = Evaluator(schema, harness.query_store)

        async def replay():
            last = len(case.bursts) - 1
            if final_only or checkpoints == "final":
                # build the device graph over the initial state: the
                # delta stream must flow through a live graph's
                # intake/absorb machinery, not be absorbed into a fresh
                # build at the final query
                ep.warm_start()
            else:
                divergences.extend(await _compare_queries(
                    case, ep, oracle, -1, gates, role,
                    check_only=check_only))
                if divergences and stop_on_first:
                    return
            for i, burst in enumerate(case.bursts):
                harness.apply_burst(i, burst)
                if i < last and (final_only
                                 or checkpoints in ("ends", "final")):
                    continue
                divergences.extend(await _compare_queries(
                    case, ep, oracle, i, gates, role,
                    check_only=check_only))
                if divergences and stop_on_first:
                    return
            if not case.bursts and (final_only or checkpoints == "final"):
                # degenerate empty-stream case (a shrunk repro can be
                # init-rels-only): the end state IS the initial state —
                # compare it rather than vacuously passing
                divergences.extend(await _compare_queries(
                    case, ep, oracle, -1, gates, role,
                    check_only=check_only))

        try:
            asyncio.run(replay())
        finally:
            # background candidates finish under the combo's switches
            ep.wait_rebuilds()
    if record_metrics:
        # shrink probes pass record_metrics=False: a single failing case
        # must count ONE divergence, not one per still-reproducing probe
        fuzz_metrics.note_case(diverged=bool(divergences))
    return divergences


def run_seed(seed: int, gates: str = "off", role: str = "leader",
             kernel: str = "ell", device=None) -> list:
    """Convenience: build + replay one cell for a bare seed."""
    case = build_case(seed, kernel=kernel)
    return run_case(case, gates=gates, role=role, device=device)
