"""Off-loop rebuilds on `torch://` held against `jax://`'s default path.

The reference's AsyncRebuild contract (tests/test_rebuild_async.py), on
the port's ASYNC_REBUILD switch: a delta the live generation cannot
absorb quarantines its (type, permission) closure, whose reads the host
oracle answers exactly; a candidate generation builds on a background
thread while the old one serves everything else; the deltas that arrive
meanwhile replay onto it and it is swapped in under a short lock; a spare
pool under its low watermark is refreshed the same way before it runs
dry.

Each of the reference's eight scenarios runs on four endpoint kinds, each
with the Leopard index on — the ELL graph, the segment graph, the ELL
graph on the caveat (bitplane) path, and a co-located 2 x 2 mesh — as
`torch://?device=cpu` beside `jax://` with its AsyncRebuild gate on (the
default).  Both take the same writes; after both endpoints'
`wait_rebuilds()` they answer the same lookups and tri-state checks as
the oracle, hold the same host tables, and count the same `rebuilds`,
`bg_rebuilds`, `preemptive_rebuilds`, `stale_pair_marks` and
`rebuild_failures`.  The concurrent scenario's rebuild counts depend on
thread timing in each package, so there the final answers compare, and
the tables after a `force_rebuild()` of both.

The reference's HBM-ledger scenario becomes "the outgoing generation's
tensors are freed" (weak references), and its event-loop tick-jitter
scenario a deterministic one: the candidate is held at an Event inside
its build, and reads answer exactly while `rebuild_inflight` stays True.
A candidate crashed at the `rebuildExecutor` fail point leaves the old
generation serving; the two-phase entries, `lookup_resources_stream` and
batched `torch://` route a quarantined pair as the one-shot reads do;
`warm_start(prewarm=True)` pools every bucket's arena and changes no
answer.  Tolerance is zero everywhere.
"""

import asyncio
import gc
import threading
import time
import weakref

import numpy as np
import pytest

from spicedb_kubeapi_proxy_tpu.ops import jax_endpoint as ref_je
from spicedb_kubeapi_proxy_tpu.ops.jax_endpoint import JaxEndpoint
from spicedb_kubeapi_proxy_tpu.spicedb import schema as ref_sch
from spicedb_kubeapi_proxy_tpu.spicedb.endpoints import (
    Bootstrap as RefBootstrap,
    create_endpoint as ref_create_endpoint)
from spicedb_kubeapi_proxy_tpu.spicedb.evaluator import Evaluator
from spicedb_kubeapi_proxy_tpu.spicedb.store import TupleStore as RefStore
from spicedb_kubeapi_proxy_tpu.spicedb.types import (
    CheckRequest as RefCheckRequest,
    ObjectRef as RefObjectRef,
    Permissionship as RefPermissionship,
    RelationshipUpdate as RefUpdate,
    SubjectRef as RefSubjectRef,
    UpdateOp as RefOp,
    parse_relationship as ref_parse)
from spicedb_kubeapi_proxy_tpu.utils import failpoints as ref_failpoints
from spicedb_kubeapi_proxy_tpu.utils import workload as ref_workload
from spicedb_kubeapi_proxy_tpu.utils.features import GATES
from spicedb_kubeapi_proxy_tpu_torch.ops import torch_endpoint as port_te
from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import TorchEndpoint
from spicedb_kubeapi_proxy_tpu_torch.spicedb import schema as port_sch
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
    Bootstrap, create_endpoint)
from spicedb_kubeapi_proxy_tpu_torch.spicedb.store import TupleStore
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
    CheckRequest,
    ObjectRef,
    Permissionship,
    RelationshipUpdate,
    SubjectRef,
    UpdateOp,
    parse_relationship)
from spicedb_kubeapi_proxy_tpu_torch.utils import failpoints
from spicedb_kubeapi_proxy_tpu_torch.utils import features as port_features
from spicedb_kubeapi_proxy_tpu_torch.utils import workload as port_workload

# the reference scenario's doc schema, with a wildcard-capable and a
# caveated viewer, and nested groups behind editor for the Leopard index
SCHEMA = """
caveat flag(on bool) { on }
definition user {}
definition group {
  relation member: user | group#member
}
definition doc {
  relation viewer: user | user:* | user with flag
  relation editor: user | group#member
  permission view = viewer + editor
  permission edit = editor
}
"""
BASE = ["doc:d0#viewer@user:a", "doc:d1#editor@user:b",
        "group:g0#member@group:g1#member", "group:g1#member@user:c",
        "doc:d3#editor@group:g0#member"]
# an undecidable caveat: the ELL graph compiles its MAYBE plane
CAVEATED = ["doc:dc#viewer@user:m[caveat:flag]"]
SUBJECTS = ("a", "b", "c", "m", "zed")
KINDS = ["ell", "segment", "caveated", "mesh"]

TRI = {Permissionship.NO_PERMISSION: 0,
       Permissionship.CONDITIONAL_PERMISSION: 1,
       Permissionship.HAS_PERMISSION: 2}
REF_TRI = {RefPermissionship.NO_PERMISSION: 0,
           RefPermissionship.CONDITIONAL_PERMISSION: 1,
           RefPermissionship.HAS_PERMISSION: 2}
COUNTERS = ("rebuilds", "bg_rebuilds", "preemptive_rebuilds",
            "stale_pair_marks", "rebuild_failures", "spare_assignments",
            "spare_reclaims")


@pytest.fixture(autouse=True)
def default_async_rebuilds(monkeypatch):
    """Both packages on their defaults — the reference's AsyncRebuild gate
    and the port's ASYNC_REBUILD switch on — with both workload planes
    empty at the start: the same traffic drives both, so their background
    candidates order the same measured Leopard pairs first
    (`candidate_order=`)."""
    monkeypatch.setattr(GATES._gates["AsyncRebuild"], "value", True)
    monkeypatch.setattr(GATES._gates["LeopardIndex"], "value", True)
    monkeypatch.setattr(port_features, "ASYNC_REBUILD", True)
    ref_workload.WORKLOAD.reset()
    port_workload.WORKLOAD.reset()
    yield
    failpoints.disable_all()
    ref_failpoints.disable_all()



def _order(candidates) -> list:
    """The Leopard build order a workload plane's candidates give
    (`candidate_order=`)."""
    return [(c["resource_type"], c["permission"]) for c in candidates]

def run(coro):
    return asyncio.run(coro)


class Pair:
    """The port's and the reference's endpoints of one kind on equal
    stores, and the oracle on the reference's store."""

    def __init__(self, kind: str, rels=None):
        self.kind = kind
        if kind == "mesh":
            self.port = create_endpoint(
                "torch://?mesh=2x2&device=cpu&dispatch=direct",
                Bootstrap(schema_text=SCHEMA))
            self.jx = ref_create_endpoint("jax://?mesh=2x2&dispatch=direct",
                                          RefBootstrap(schema_text=SCHEMA))
        else:
            graph = "segment" if kind == "segment" else "ell"
            self.port = TorchEndpoint(port_sch.parse_schema(SCHEMA),
                                      store=TupleStore(), device="cpu",
                                      kernel=graph)
            self.jx = JaxEndpoint(ref_sch.parse_schema(SCHEMA),
                                  store=RefStore(), kernel=graph)
        self.oracle = Evaluator(self.jx.schema, self.jx.store)
        if rels is None:
            rels = BASE + (CAVEATED if kind == "caveated" else [])
        self.touch(*rels)

    @property
    def eps(self):
        return (self.port, self.jx)

    def touch(self, *rels):
        self.write([("touch", r) for r in rels])

    def write(self, ops):
        """One committed write in each store (read by neither yet)."""
        port_ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
        ref_ops = {"touch": RefOp.TOUCH, "delete": RefOp.DELETE}
        self.port.store.write([RelationshipUpdate(port_ops[o],
                                                  parse_relationship(r))
                               for o, r in ops])
        self.jx.store.write([RefUpdate(ref_ops[o], ref_parse(r))
                             for o, r in ops])

    def agree(self, perms=("view", "edit"), subjects=SUBJECTS):
        """Lookups and tri-state checks of every doc, equal across the
        port, the reference and the oracle.  Returns the port's answers'
        sources per permission."""
        subs = [SubjectRef("user", s) for s in subjects]
        refs = [RefSubjectRef("user", s) for s in subjects]
        ids = sorted(self.jx.store.object_ids_of_type("doc")) + ["nope"]
        sources = {}
        for perm in perms:
            got = run(self.port.lookup_resources_batch("doc", perm, subs))
            ref = run(self.jx.lookup_resources_batch("doc", perm, refs))
            for s, g, r in zip(refs, got, ref):
                want = sorted(self.oracle.lookup_resources("doc", perm, s))
                assert sorted(g) == sorted(r) == want, (perm, s)
            reqs = [(o, i) for o in ids for i in range(len(subs))]
            pc = run(self.port.check_bulk_permissions(
                [CheckRequest(ObjectRef("doc", o), perm, subs[i])
                 for o, i in reqs]))
            rc = run(self.jx.check_bulk_permissions(
                [RefCheckRequest(RefObjectRef("doc", o), perm, refs[i])
                 for o, i in reqs]))
            for (o, i), g, r in zip(reqs, pc, rc):
                want = self.oracle.check3(RefObjectRef("doc", o), perm,
                                          refs[i])
                assert TRI[g.permissionship] == REF_TRI[r.permissionship] \
                    == want, (perm, o, subjects[i])
            sources[perm] = ({x.source for x in got}
                             | {c.source for c in pc})
        return sources

    def settle(self):
        """Both endpoints quiescent; then their counters and host tables
        are equal and nothing is quarantined."""
        assert self.port.wait_rebuilds() and self.jx.wait_rebuilds()
        assert not self.port._stale_pairs and not self.jx._stale_pairs
        for k in COUNTERS:
            assert self.port.stats[k] == self.jx.stats[k], k
        assert_same_tables(self.port, self.jx)
        # the same traffic fed both workload planes: the same measured
        # candidates, so the same Leopard build order and statuses
        assert (_order(port_workload.WORKLOAD.leopard_candidates())
                == _order(ref_workload.WORKLOAD.leopard_candidates()))
        pl, rl = self.port._leopard, self.jx._leopard
        if pl is not None and rl is not None:
            assert pl.status_map() == rl.status_map()


def assert_same_tables(port, jx):
    p, r = port._graph, jx._graph
    assert port._graph_revision == jx._graph_revision
    assert p.prog.object_ids == r.prog.object_ids
    assert port._spare_pool == jx._spare_pool
    if isinstance(p, port_te._SegmentGraph):
        assert np.array_equal(p.host_src, np.asarray(r.edge_src))
        assert np.array_equal(p.host_dst, np.asarray(r.edge_dst))
        assert p.free == r.free and p.positions == r.positions
        return
    assert np.array_equal(p.host_main, r.host_main)
    assert np.array_equal(p.host_aux, r.host_aux)
    assert p._spare_aux == r._spare_aux
    assert (p.host_cav is None) == (r.host_cav is None)
    if p.host_cav is not None:
        assert np.array_equal(p.host_cav, r.host_cav)


def hold_builds(ep, gate: threading.Event, first_only: bool = False,
                after: bool = False):
    """Make `ep`'s candidate builds wait for `gate` (before the build, or
    after it with `after`); with `first_only` only the first build
    waits.  Returns the list the builds append to."""
    orig = ep._build_candidate
    builds = []

    def held():
        builds.append(1)
        wait = not first_only or len(builds) == 1
        if wait and not after:
            assert gate.wait(timeout=30)
        st = orig()
        if wait and after:
            assert gate.wait(timeout=30)
        return st

    ep._build_candidate = held
    return builds


def _doc_view(ep, subject="a"):
    """doc#view for `subject` on either package's endpoint."""
    cls = SubjectRef if isinstance(ep, TorchEndpoint) else RefSubjectRef
    return sorted(run(ep.lookup_resources("doc", "view",
                                          cls("user", subject))))


# -- the reference's scenarios ------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_wildcard_write_quarantines_then_swaps(kind):
    p = Pair(kind)
    p.agree()
    rebuilds = p.port.stats["rebuilds"]
    # wildcard tuples are baked into the compiled masks: the live
    # generation cannot absorb this delta
    p.touch("doc:d2#viewer@user:*")
    p.agree()      # exact at once: the quarantined pairs go to the oracle
    assert p.port.stats["stale_pair_marks"] >= 1
    p.settle()
    assert p.port.stats["rebuilds"] == rebuilds + 1
    assert p.port.stats["bg_rebuilds"] >= 1
    # after the swap the kernel serves the wildcard itself
    routed = p.port.stats["stale_routed"]
    p.agree()
    assert p.port.stats["stale_routed"] == routed


@pytest.mark.parametrize("kind", KINDS)
def test_unaffected_pairs_stay_on_the_device_during_quarantine(kind):
    p = Pair(kind)
    p.agree()
    gate = threading.Event()
    for ep in p.eps:
        hold_builds(ep, gate)
    try:
        p.touch("doc:d2#viewer@user:*")
        routed = p.port.stats["stale_routed"]
        # view's closure holds viewer: quarantined, the oracle answers
        src = p.agree(perms=("view",))
        assert src["view"] == {"oracle"}
        assert p.port.stats["stale_routed"] > routed
        assert ("doc", "view") in p.port._stale_pairs
        assert p.port.rebuild_inflight and p.jx.rebuild_inflight
        # edit never reads viewer: it stays on the device
        assert ("doc", "edit") not in p.port._stale_pairs
        routed = p.port.stats["stale_routed"]
        src = p.agree(perms=("edit",))
        assert src["edit"] == {"kernel"}
        assert p.port.stats["stale_routed"] == routed
    finally:
        gate.set()
    p.settle()
    p.agree()


@pytest.mark.parametrize("kind", KINDS)
def test_outgoing_generation_is_freed_after_a_background_swap(kind):
    """The port's form of the reference's HBM-ledger scenario: once the
    swap is done and no batch holds a snapshot, nothing keeps the
    outgoing generation's graph, kernel cache or device tables alive."""
    p = Pair(kind)
    p.agree()
    old = p.port._graph
    refs = [weakref.ref(old), weakref.ref(old.kernel)]
    refs += [weakref.ref(t) for t in _device_tables(old)]
    del old
    p.touch("doc:d1#viewer@user:*")
    p.agree()
    p.settle()
    gc.collect()
    assert all(r() is None for r in refs)
    assert _device_tables(p.port._graph)


def _device_tables(graph) -> list:
    """The generation's device tables (every mesh block)."""
    flat = []

    def walk(x):
        if isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif x is not None:
            flat.append(x)
    walk(tuple(graph.snapshot()))
    return flat


@pytest.mark.parametrize("kind", KINDS)
def test_preemptive_rebuild_refreshes_pool_before_dry(kind, monkeypatch):
    monkeypatch.setattr(ref_je, "_SPARE_FLOOR", 16)
    monkeypatch.setattr(port_te, "_SPARE_FLOOR", 16)
    p = Pair(kind)
    p.agree()
    # 13 brand-new ids: pool 16 -> 3 free, under the 25 % watermark
    for k in range(13):
        p.touch(f"doc:new{k}#viewer@user:a")
    p.agree()
    p.settle()
    assert p.port.stats["preemptive_rebuilds"] >= 1
    # the refreshed pool absorbs the continued churn without quarantine
    marks = p.port.stats["stale_pair_marks"]
    for k in range(13, 20):
        p.touch(f"doc:new{k}#viewer@user:a")
    p.agree()
    p.settle()
    assert p.port.stats["stale_pair_marks"] == marks
    assert _doc_view(p.port) == sorted(["d0"]
                                       + [f"new{k}" for k in range(20)])


@pytest.mark.parametrize("kind", KINDS)
def test_concurrent_traffic_across_rebuilds_pinned_consistency(
        kind, monkeypatch):
    """Oracle referee under churn: with monotone appends every lookup must
    answer {d0..dK} for some K between the last write committed before it
    and the last write started by its end — a stale or torn read fails.  The tiny spare pool
    forces repeated background rebuilds while the reads run, on both
    endpoints, which take the same writes."""
    monkeypatch.setattr(ref_je, "_SPARE_FLOOR", 4)
    monkeypatch.setattr(port_te, "_SPARE_FLOOR", 4)
    n = 40
    p = Pair(kind, rels=["doc:d0#viewer@user:a"])
    for ep in p.eps:
        _doc_view(ep)

    async def scenario():
        # per endpoint: the highest dK committed, and the highest whose
        # write has started (the port commits off the loop, so a read may
        # see a write before the writer coroutine resumes)
        written = {id(ep): 0 for ep in p.eps}
        started = dict(written)
        errors = []

        async def writer():
            for k in range(1, n):
                started[id(p.port)] = k
                await p.port.write_relationships([RelationshipUpdate(
                    UpdateOp.TOUCH,
                    parse_relationship(f"doc:d{k}#viewer@user:a"))])
                written[id(p.port)] = k
                started[id(p.jx)] = k
                await p.jx.write_relationships([RefUpdate(
                    RefOp.TOUCH, ref_parse(f"doc:d{k}#viewer@user:a"))])
                written[id(p.jx)] = k
                await asyncio.sleep(0.002)

        async def reader(ep, sub):
            while written[id(ep)] < n - 1:
                lo = written[id(ep)]
                ids = await ep.lookup_resources("doc", "view", sub)
                hi = started[id(ep)]
                got = sorted(int(x[1:]) for x in ids)
                k = len(got) - 1
                if got != list(range(k + 1)):
                    errors.append(("torn", got))
                if not (lo <= k <= hi):
                    errors.append(("window", lo, k, hi))
                await asyncio.sleep(0.001)

        await asyncio.gather(
            writer(),
            reader(p.port, SubjectRef("user", "a")),
            reader(p.port, SubjectRef("user", "a")),
            reader(p.jx, RefSubjectRef("user", "a")))
        return errors

    errors = run(scenario())
    assert not errors, errors[:5]
    for ep in p.eps:
        _doc_view(ep)          # applies any write no reader applied yet
        assert ep.wait_rebuilds()
        # every rebuild after the first build went to the background
        assert ep.stats["bg_rebuilds"] >= 1
        assert ep.stats["rebuilds"] == 1 + ep.stats["bg_rebuilds"]
        assert _doc_view(ep) == sorted(f"d{k}" for k in range(n))
    p.agree(subjects=("a", "zed"))
    for ep in p.eps:
        ep.force_rebuild()
    assert_same_tables(p.port, p.jx)


@pytest.mark.parametrize("kind", KINDS)
def test_sync_switch_reproduces_the_blocking_rebuild(kind, monkeypatch):
    monkeypatch.setattr(GATES._gates["AsyncRebuild"], "value", False)
    monkeypatch.setattr(port_features, "ASYNC_REBUILD", False)
    p = Pair(kind)
    p.agree()
    rebuilds = p.port.stats["rebuilds"]
    p.touch("doc:d1#viewer@user:*")
    p.agree()
    # switch off: the rebuild happened inside the read, nothing queued
    assert p.port.stats["rebuilds"] == rebuilds + 1
    assert p.port.stats["bg_rebuilds"] == 0 and not p.port.rebuild_inflight
    assert not p.port._stale_pairs
    p.settle()


@pytest.mark.parametrize("kind", KINDS)
def test_force_rebuild_supersedes_a_background_candidate(kind):
    p = Pair(kind)
    p.agree()
    gate = threading.Event()
    held = [hold_builds(ep, gate, first_only=True, after=True)
            for ep in p.eps]
    try:
        p.touch("doc:d1#viewer@user:*")
        for ep in p.eps:
            _doc_view(ep)      # kicks the background rebuild
            assert ep.rebuild_inflight
        # only the first build is held: the background one must have
        # begun before the synchronous one below, or that one is held
        for builds in held:
            deadline = time.monotonic() + 30
            while not builds and time.monotonic() < deadline:
                time.sleep(0.005)
            assert builds
        # a synchronous rebuild installs first: the candidate must abandon
        # itself instead of replacing the newer generation
        installed = []
        for ep in p.eps:
            ep.force_rebuild()
            installed.append(ep._graph)
    finally:
        gate.set()
    p.settle()
    assert p.port._graph is installed[0] and p.jx._graph is installed[1]
    assert p.port.stats["bg_rebuilds"] == 0
    p.agree()


@pytest.mark.parametrize("kind", KINDS)
def test_reads_answer_exactly_while_a_candidate_is_held(kind):
    """The deterministic form of the reference's tick-jitter scenario:
    the candidate waits inside its build, and every read — quarantined
    pairs from the oracle, the rest from the device — answers exactly
    and returns while the build is still held (it does not wait it
    out)."""
    p = Pair(kind)
    p.agree()
    gate = threading.Event()
    for ep in p.eps:
        hold_builds(ep, gate)
    try:
        p.touch("doc:d2#viewer@user:*", "doc:d4#editor@user:b")
        epoch = p.port.rebuild_epoch
        for _ in range(3):
            p.agree()
            assert p.port.rebuild_inflight and p.jx.rebuild_inflight
        # one background start, no install while held
        assert p.port.rebuild_epoch == epoch + 1
        assert p.port.stats["bg_rebuilds"] == 0
    finally:
        gate.set()
    p.settle()
    assert p.port.rebuild_epoch == epoch + 2
    p.agree()


# -- beyond the reference's scenarios ------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_crashed_candidate_leaves_the_old_generation_serving(kind):
    """A background build that crashes at the `rebuildExecutor` fail point
    counts a failure, keeps the old generation serving with its pairs
    quarantined, and backs off; the next attempt installs."""
    p = Pair(kind)
    p.agree()
    old = p.port._graph
    failpoints.enable_failpoint("rebuildExecutor", 1)
    ref_failpoints.enable_failpoint("rebuildExecutor", 1)
    p.touch("doc:d2#viewer@user:*")
    for ep in p.eps:
        _doc_view(ep)           # quarantines and kicks the build
        deadline = time.monotonic() + 30
        while ep.rebuild_inflight and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not ep.rebuild_inflight
        assert ep.stats["rebuild_failures"] == 1
        assert ("doc", "view") in ep._stale_pairs
    assert p.port._graph is old
    routed = p.port.stats["stale_routed"]
    p.agree()
    assert p.port.stats["stale_routed"] > routed
    p.settle()
    assert p.port.stats["bg_rebuilds"] == 1
    p.agree()


@pytest.mark.parametrize("kind", KINDS)
def test_warm_start_prewarm_pools_every_bucket(kind):
    """`warm_start(prewarm=True)` runs a check and the lookups of every
    prewarm bucket: each bucket's arena is pooled and no answer changes;
    with `prewarm_rebuilds` a background candidate comes in warmed."""
    p = Pair(kind)
    p.port.warm_start(prewarm=True)
    p.jx.warm_start()
    g = p.port._graph
    buckets = {g.batch_bucket(n) // 32 for n in TorchEndpoint._PREWARM_LANES}
    assert set(g.kernel._arenas) == buckets
    assert p.port._prewarm_slot_ranges(g)
    p.agree()
    p.port.prewarm_rebuilds = True
    p.touch("doc:d2#viewer@user:*")
    p.agree()
    p.settle()
    g = p.port._graph
    assert set(g.kernel._arenas) >= buckets
    p.agree()


@pytest.mark.parametrize("kind", KINDS)
def test_two_phase_and_stream_entries_route_quarantined_pairs(kind):
    """The entries the dispatcher and the streaming verb build on — the
    two-phase check and lookup, `lookup_resources_stream`, and batched
    `torch://` around the endpoint — route a quarantined pair to the
    oracle exactly as the one-shot reads do, while the candidate is
    held."""
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.dispatch import (
        BatchingEndpoint)
    p = Pair(kind)
    p.agree()
    gate = threading.Event()
    hold_builds(p.port, gate)
    batched = BatchingEndpoint(p.port)
    try:
        p.touch("doc:d2#viewer@user:*")
        subs = [SubjectRef("user", s) for s in SUBJECTS]
        want = [sorted(p.oracle.lookup_resources(
            "doc", "view", RefSubjectRef("user", s))) for s in SUBJECTS]
        reqs = [CheckRequest(ObjectRef("doc", o), "view", subs[0])
                for o in ("d0", "d1", "d2", "d3")]
        want_c = [TRI[r.permissionship] for r in run(
            p.port.check_bulk_permissions(reqs))]

        async def reads():
            ctx = await p.port.lookup_resources_batch_start("doc", "view",
                                                            subs)
            two = await p.port.lookup_resources_batch_finish(ctx)
            ctx = await p.port.check_bulk_permissions_start(reqs)
            checks = await p.port.check_bulk_permissions_finish(ctx)
            streamed = [x async for x in p.port.lookup_resources_stream(
                "doc", "view", subs[3])]
            fused = await asyncio.gather(*(batched.lookup_resources(
                "doc", "view", s) for s in subs))
            return two, checks, streamed, fused

        routed = p.port.stats["stale_routed"]
        two, checks, streamed, fused = run(reads())
        assert p.port.rebuild_inflight
        assert [sorted(x) for x in two] == want
        assert {x.source for x in two} == {"oracle"}
        assert [TRI[c.permissionship] for c in checks] == want_c
        assert {c.source for c in checks} == {"oracle"}
        assert sorted(streamed) == want[3]
        assert [sorted(x) for x in fused] == want
        # one batch each for the two-phase and streamed lookups, one per
        # check row, and at least one fused lookup batch
        assert p.port.stats["stale_routed"] >= routed + 2 + len(reqs) + 1
    finally:
        gate.set()
    p.agree()       # the reference takes the write too
    p.settle()
