"""The torch port's Leopard closure index held against the JAX reference.

The index (ops/leopard.py in both packages) flattens nested-group
(type, permission) pairs into closure planes that answer a check with one
bit gather and a lookup with one word column, instead of one sweep per
nesting level.  The port's planner must give the reference's verdicts on
every workload schema, the group-explosion schema and seeded random
nested-group schemas; its fragments (`local_of`, `col_of`, closure
`state`, `seeds`, the base edges, keyed edges, flags) and its device
plane must equal the reference's after the build and after every delta;
and `torch://?device=cpu` with the index must answer, report statuses and
count `leopard_*` hits exactly as `jax://` does, and as the oracle.

The cases of the reference's tests/test_leopard.py are ported (the mesh
case does not apply: the port has no mesh yet), plus the reference
bench's group-explosion shape at a small size with its tail-user churn.
Both run with their off-loop rebuilds off (the reference's AsyncRebuild
gate, the port's ASYNC_REBUILD switch), and the reference with its
workload plane reset, so both order the candidate pairs alike.  Tolerance is zero everywhere.
"""

import asyncio
import random

import numpy as np
import pytest

from spicedb_kubeapi_proxy_tpu.fuzz import scenarios as ref_scenarios
from spicedb_kubeapi_proxy_tpu.fuzz.schema_gen import generate_schema
from spicedb_kubeapi_proxy_tpu.models import workloads as ref_workloads
from spicedb_kubeapi_proxy_tpu.ops import leopard as ref_leopard
from spicedb_kubeapi_proxy_tpu.ops.jax_endpoint import JaxEndpoint
from spicedb_kubeapi_proxy_tpu.spicedb import schema as ref_sch
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
from spicedb_kubeapi_proxy_tpu.utils import workload as ref_workload
from spicedb_kubeapi_proxy_tpu.utils.features import GATES
from spicedb_kubeapi_proxy_tpu_torch import convert
from spicedb_kubeapi_proxy_tpu_torch.models import workloads as port_workloads
from spicedb_kubeapi_proxy_tpu_torch.utils import workload as port_workload
from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
from spicedb_kubeapi_proxy_tpu_torch.ops import leopard as port_leopard
from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import TorchEndpoint
from spicedb_kubeapi_proxy_tpu_torch.spicedb import schema as port_sch
from spicedb_kubeapi_proxy_tpu_torch.spicedb.store import TupleStore
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
    CheckRequest,
    ObjectRef,
    Permissionship,
    RelationshipUpdate,
    SubjectRef,
    UpdateOp,
    parse_relationship)
from spicedb_kubeapi_proxy_tpu_torch.utils import features as port_features

# the reference's tests/test_leopard.py schema and depth-4 chain
NESTED_SCHEMA = """
definition user {}
definition group {
  relation member: user | group#member
  permission view = member
}
definition doc {
  relation viewer: user | group#member
  permission view = viewer
}
"""

CHAIN = [
    "group:g0#member@group:g1#member",
    "group:g1#member@group:g2#member",
    "group:g2#member@group:g3#member",
    "group:g3#member@user:alice",
    "doc:d0#viewer@group:g0#member",
    "doc:d1#viewer@user:bob",
]

CAVEAT_NESTED_SCHEMA = ("caveat recently(age int) { age < 5 }\n"
                        + NESTED_SCHEMA.replace(
                            "relation viewer: user | group#member",
                            "relation viewer: user | group#member | "
                            "user with recently"))

TRI = {Permissionship.NO_PERMISSION: 0,
       Permissionship.CONDITIONAL_PERMISSION: 1,
       Permissionship.HAS_PERMISSION: 2}
REF_TRI = {RefPermissionship.NO_PERMISSION: 0,
           RefPermissionship.CONDITIONAL_PERMISSION: 1,
           RefPermissionship.HAS_PERMISSION: 2}


@pytest.fixture(autouse=True)
def reference_like_the_port(monkeypatch):
    """Both rebuild synchronously (the reference's AsyncRebuild gate and
    the port's ASYNC_REBUILD switch off), and both workload planes start
    empty: the same traffic then drives both, so each generation's
    Leopard build orders the same measured candidates first
    (`candidate_order=`)."""
    monkeypatch.setattr(GATES._gates["AsyncRebuild"], "value", False)
    monkeypatch.setattr(port_features, "ASYNC_REBUILD", False)
    ref_workload.WORKLOAD.reset()
    port_workload.WORKLOAD.reset()



def _order(candidates) -> list:
    """The Leopard build order a workload plane's candidates give
    (`candidate_order=`)."""
    return [(c["resource_type"], c["permission"]) for c in candidates]

def run(coro):
    return asyncio.run(coro)


# -- the planner -------------------------------------------------------------

SCHEMAS = {
    "namespace_baseline": ref_workloads.NAMESPACE_SCHEMA,
    "nested_groups": ref_workloads.NESTED_GROUPS_SCHEMA,
    "rbac_deny": ref_workloads.RBAC_DENY_SCHEMA,
    "caveated_rbac": ref_workloads.CAVEATED_RBAC_SCHEMA,
    "multitenant_1m": ref_workloads.MULTITENANT_SCHEMA,
    "group_explosion": ref_scenarios.GROUP_EXPLOSION_SCHEMA,
    "leopard_nested": NESTED_SCHEMA,
    "leopard_caveated": CAVEAT_NESTED_SCHEMA,
}


def _assert_same_plan(text: str, seed: int = 0) -> None:
    ref = ref_sch.parse_schema(text)
    port = port_sch.parse_schema(text)
    rp, pp = ref_leopard.plan_schema(ref), port_leopard.plan_schema(port)
    assert list(rp) == list(pp)
    rng = random.Random(seed)
    counts = {t: rng.randrange(0, 5000) for t in ref.definitions}
    for pair, entry in rp.items():
        other = pp[pair]
        assert (entry.eligible, entry.reason, entry.slots,
                entry.subject_types) == (other.eligible, other.reason,
                                         other.slots, other.subject_types)
        assert ref_leopard.fragment_is_nested(ref, *pair) == \
            port_leopard.fragment_is_nested(port, *pair)
        for c in (counts, 1000, 0):
            assert ref_leopard.estimate_fragment_bytes(ref, *pair, c) == \
                port_leopard.estimate_fragment_bytes(port, *pair, c)


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_planner_matches_reference_on_named_schemas(name):
    _assert_same_plan(SCHEMAS[name])


@pytest.mark.parametrize("seed", range(50))
def test_planner_matches_reference_on_random_nested_schemas(seed):
    text, _ = generate_schema(seed, ref_scenarios.NESTED_GROUPS_SMOKE_BIAS)
    _assert_same_plan(text, seed)


def test_group_explosion_generator_is_the_references():
    kw = dict(n_groups=800, n_users=64, n_docs=200)
    ref = ref_scenarios.group_explosion(**kw)
    port = port_workloads.group_explosion(**kw)
    assert port.relationships == ref.relationships
    assert port.schema_text == ref.schema_text
    assert port.subjects == ref.subjects


def test_budget_and_frontier_env(monkeypatch):
    monkeypatch.setenv(port_leopard.BUDGET_ENV, "123")
    monkeypatch.setenv(port_leopard.FRONTIER_ENV, "bad")
    assert port_leopard.budget_bytes() == ref_leopard.budget_bytes() == 123
    assert port_leopard.frontier_passes() == ref_leopard.frontier_passes() \
        == port_leopard.DEFAULT_FRONTIER_PASSES


# -- endpoint pairs -----------------------------------------------------------

def _ref_endpoint(schema_text, leopard, kernel=None, store=None):
    prev = GATES._gates["LeopardIndex"].value
    GATES._gates["LeopardIndex"].value = leopard
    try:
        return JaxEndpoint(ref_sch.parse_schema(schema_text),
                           store=store if store is not None else RefStore(),
                           kernel=kernel)
    finally:
        GATES._gates["LeopardIndex"].value = prev


class Pair:
    """torch://?device=cpu and jax:// on equal stores (the index on or
    off in both), plus the oracle."""

    def __init__(self, schema_text=NESTED_SCHEMA, rels=CHAIN, leopard=True,
                 kernel=None):
        self.port = TorchEndpoint(port_sch.parse_schema(schema_text),
                                  store=TupleStore(), device="cpu",
                                  kernel=kernel, leopard=leopard)
        self.jx = _ref_endpoint(schema_text, leopard, kernel)
        self.oracle = Evaluator(self.jx.schema, self.jx.store)
        if rels:
            self.write([("touch", r) for r in rels])

    def write(self, ops, settle=True):
        """One committed write in each store.  With `settle` both
        endpoints then apply it and finish any re-close it kicked, so the
        next reads (and their counters) do not race a background
        re-close."""
        port_ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
        ref_ops = {"touch": RefOp.TOUCH, "delete": RefOp.DELETE}
        self.port.store.write([RelationshipUpdate(port_ops[o],
                                                  parse_relationship(r))
                               for o, r in ops])
        self.jx.store.write([RefUpdate(ref_ops[o], ref_parse(r))
                             for o, r in ops])
        if settle:
            for ep in (self.port, self.jx):
                with ep._lock:
                    ep._current_graph()
            self.quiesce()

    def quiesce(self):
        assert self.port.wait_rebuilds()
        assert self.jx.wait_rebuilds()

    def agree(self, subjects, docs=None, rtype="doc", perm="view"):
        """Lookups and checks equal across port, reference and oracle;
        then (quiesced) equal counters, statuses and fragments."""
        subs = [SubjectRef("user", s) for s in subjects]
        refs = [RefSubjectRef("user", s) for s in subjects]
        got = run(self.port.lookup_resources_batch(rtype, perm, subs))
        ref = run(self.jx.lookup_resources_batch(rtype, perm, refs))
        for s, g, r in zip(refs, got, ref):
            want = sorted(self.oracle.lookup_resources(rtype, perm, s))
            assert sorted(g) == sorted(r) == want, s
        if docs is None:
            docs = sorted(self.jx.store.object_ids_of_type(rtype))
        reqs = [(d, i) for d in docs for i in range(len(subjects))]
        got = run(self.port.check_bulk_permissions(
            [CheckRequest(ObjectRef(rtype, d), perm, subs[i])
             for d, i in reqs]))
        ref = run(self.jx.check_bulk_permissions(
            [RefCheckRequest(RefObjectRef(rtype, d), perm, refs[i])
             for d, i in reqs]))
        for (d, i), g, r in zip(reqs, got, ref):
            want = self.oracle.check3(RefObjectRef(rtype, d), perm, refs[i])
            assert TRI[g.permissionship] == REF_TRI[r.permissionship] \
                == want, (d, subjects[i])
        self.quiesce()
        assert_same_index(self.port, self.jx)


def assert_same_fragment(pf, rf) -> None:
    assert pf.pair == tuple(rf.pair) and pf.slots == tuple(rf.slots)
    assert pf.subject_types == tuple(rf.subject_types)
    for k in ("local_of", "col_of", "state", "seeds", "base_src",
              "base_dst", "base_alive"):
        a, b = getattr(pf, k), np.asarray(getattr(rf, k))
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in ("n_rows", "n_cols", "words", "perm_ops_local", "perm_lo",
              "plane_rows", "live", "quarantined", "retired", "reason",
              "seq"):
        assert getattr(pf, k) == getattr(rf, k), k
    assert {k: [tuple(e) for e in v] for k, v in pf.key_edges.items()} == \
        {k: [tuple(e) for e in v] for k, v in rf.key_edges.items()}
    if rf.plane is not None and not pf.retired:
        plane = pf.plane[0].numpy().view(np.uint32)
        assert np.array_equal(plane, np.asarray(rf.plane))
        assert pf.view[1] == rf.view[1] and pf.view[0] is pf.plane


def assert_same_index(port, jx) -> None:
    for k in ("leopard_checks", "leopard_lookups", "leopard_recloses",
              "kernel_calls", "rebuilds"):
        assert port.stats[k] == jx.stats[k], k
    assert (_order(port_workload.WORKLOAD.leopard_candidates())
            == _order(ref_workload.WORKLOAD.leopard_candidates()))
    pl, rl = port._leopard, jx._leopard
    assert (pl is None) == (rl is None)
    if pl is None:
        return
    assert pl.status_map() == rl.status_map()
    assert [f.pair for f in pl._frags] == [tuple(f.pair) for f in rl._frags]
    for pf, rf in zip(pl._frags, rl._frags):
        assert_same_fragment(pf, rf)


def touch(*rels):
    return [("touch", r) for r in rels]


def delete(*rels):
    return [("delete", r) for r in rels]


# -- the reference's tests/test_leopard.py cases ------------------------------

@pytest.mark.parametrize("kernel", ["ell", "segment"])
def test_gate_off_means_inert(monkeypatch, kernel):
    def boom(*a, **kw):
        raise AssertionError("LeopardIndex.build called with the index off")

    monkeypatch.setattr(port_leopard.LeopardIndex, "build",
                        classmethod(boom))
    p = Pair(leopard=False, kernel=kernel)
    p.agree(["alice", "bob", "zed"])
    assert p.port._leopard is None
    p.write(touch("group:g3#member@user:zed"))
    p.write(delete(*CHAIN[3:4]))
    p.agree(["alice", "bob", "zed"])
    assert p.port.stats["leopard_checks"] == 0
    assert p.port.stats["leopard_lookups"] == 0


@pytest.mark.parametrize("kernel", ["ell", "segment"])
def test_gate_on_serves_from_plane(kernel):
    p = Pair(kernel=kernel)
    p.agree(["alice", "bob", "zed"])
    assert p.port._leopard.status_map().get("doc#view") == "indexed"
    # depth-4 membership resolved without a single sweep
    assert p.port.stats["leopard_checks"] > 0
    assert p.port.stats["leopard_lookups"] > 0
    assert p.port.stats["kernel_calls"] == 0


def test_plane_reads_launch_nothing_on_the_cpu():
    p = Pair()
    kernels.reset_launches()
    p.agree(["alice"])
    assert not any(kernels.LAUNCHES.values())   # CPU: the twins only


def test_caveat_tuple_retires_fragment():
    """The reference's case: a caveated tuple on the fragment's relation.
    A relation that admits caveats makes the pair ineligible already at
    planning (a trait), so the status is ineligible before and after."""
    p = Pair(CAVEAT_NESTED_SCHEMA)
    p.agree(["alice", "bob"])
    p.write(touch('doc:d1#viewer@user:zed[caveat:recently:{"age": 1}]'))
    p.agree(["alice", "bob", "zed"])
    status = p.port._leopard.status_map().get("doc#view", "")
    assert status.startswith("ineligible("), status
    p.port.force_rebuild()
    p.jx.force_rebuild()
    p.agree(["alice", "bob", "zed"])


def test_retire_relation_retires_the_fragment_for_the_generation():
    """`retire_relation` on an indexed fragment's relation: both indexes
    retire it, and the pair goes back to the sweep."""
    p = Pair()
    p.agree(["alice", "bob"])
    for ep in (p.port, p.jx):
        ep._leopard.retire_relation(("doc", "viewer"))
    assert p.port._leopard.status_map()["doc#view"] == \
        "ineligible(caveat-tuple)"
    calls = p.port.stats["kernel_calls"]
    p.agree(["alice", "bob"])
    assert p.port.stats["kernel_calls"] > calls
    # retired fragments ignore later deltas, in both packages
    p.write(touch("group:g2#member@user:zed"))
    p.agree(["alice", "zed"])


def test_insert_propagates_without_rebuild():
    p = Pair()
    p.agree(["alice", "zed"])
    rebuilds = p.port.stats["rebuilds"]
    p.write(touch("group:g2#member@user:zed"))
    p.agree(["alice", "zed"])
    assert p.port.stats["rebuilds"] == rebuilds
    assert p.port._leopard.status_map().get("doc#view") == "indexed"
    assert p.port.stats["kernel_calls"] == 0


def test_delete_quarantines_then_recloses_to_parity(monkeypatch):
    """Removing alice's membership must revoke at once: the bit cannot be
    proven removable, so the fragment quarantines and the sweep answers
    until the background re-close reinstates the plane.  The re-closes
    of both packages are held back until the quarantined reads are
    done."""
    import threading
    release = threading.Event()
    for mod in (port_leopard, ref_leopard):
        orig = mod.LeopardIndex.reclose

        def held(self, frag, attempts=3, _orig=orig):
            release.wait(30)
            return _orig(self, frag, attempts)
        monkeypatch.setattr(mod.LeopardIndex, "reclose", held)
    p = Pair()
    p.agree(["alice"])
    uploads = p.port._leopard.uploads
    p.write(delete("group:g3#member@user:alice"), settle=False)
    try:
        ctx = p.port._lookup_batch_capture(
            "doc", "view", [SubjectRef("user", "alice")])
        ref_ctx = p.jx._lookup_batch_capture(
            "doc", "view", [RefSubjectRef("user", "alice")])
        assert "leopard" not in ctx and "leopard" not in ref_ctx
        assert p.port._leopard.status_map()["doc#view"] == \
            "indexed(quarantined)" == p.jx._leopard.status_map()["doc#view"]
        assert p.port._lookup_batch_extract(ctx) == [[]]
        assert list(p.jx._lookup_batch_finish_sync(ref_ctx)[0]) == []
        # group#view and doc#view both quarantined: one re-close each
        assert p.port.stats["leopard_recloses"] == \
            p.jx.stats["leopard_recloses"] == 2
    finally:
        release.set()
    p.quiesce()
    p.agree(["alice", "bob"])
    assert p.port._leopard.status_map().get("doc#view") == "indexed"
    assert p.port._leopard.uploads > uploads   # a NEW plane was uploaded
    checks = p.port.stats["leopard_checks"]
    p.agree(["alice", "bob"])
    assert p.port.stats["leopard_checks"] > checks


@pytest.mark.parametrize("kernel", ["ell", "segment"])
def test_churn_parity_vs_oracle(kernel):
    p = Pair(kernel=kernel)
    rng = random.Random(7)
    users = ["alice", "bob", "carol", "dave"]
    live = set()
    for _ in range(10):
        g = rng.randrange(4)
        u = rng.choice(users)
        if (g, u) in live and rng.random() < 0.5:
            p.write(delete(f"group:g{g}#member@user:{u}"))
            live.discard((g, u))
        else:
            p.write(touch(f"group:g{g}#member@user:{u}"))
            live.add((g, u))
        p.agree(users + ["zed"])
    assert p.port._leopard.status_map().get("doc#view") == "indexed"


def test_plane_snapshot_survives_maintenance():
    """A batch's captured view keeps its plane: maintenance uploads a new
    one and never writes the old."""
    p = Pair()
    p.agree(["alice", "zed"])
    frag = p.port._leopard.lookup_frag("doc", "view")
    plane0 = frag.plane[0]
    copy0 = plane0.clone()
    p.write(touch("group:g1#member@user:zed"))
    p.agree(["alice", "zed"])
    assert frag.plane[0] is not plane0 and bool((plane0 == copy0).all())


def test_index_converted_from_the_reference_maintains_alike():
    """`convert.leopard_from_reference` carries a reference index into the
    port; the same inserts and deletes then leave both equal."""
    p = Pair(leopard=True)
    p.agree(["alice"])
    port_idx = convert.leopard_from_reference(p.jx._leopard,
                                              p.port._graph.prog,
                                              device="cpu")
    assert port_idx.status_map() == p.jx._leopard.status_map()
    for pf, rf in zip(port_idx._frags, p.jx._leopard._frags):
        assert_same_fragment(pf, rf)
    prog = p.jx._graph.prog
    sidx = prog.subject_index("user", "alice", "")
    for d in ("d0", "d1"):
        st = prog.state_index("doc", "view", d)
        frag, off = port_idx.check_fragment("doc", "view")
        ref = p.jx._leopard.check_coords("doc", "view", sidx, st)
        assert (st - off, int(frag.col_of[sidx])) == ref[1:]
        assert frag.view[1] == ref[0][1]
    for op, rel in (("insert", "group:g1#member@user:zed"),
                    ("remove", "group:g3#member@user:alice")):
        r = ref_parse(rel)
        ends = p.jx._edge_endpoints(prog, r)
        getattr(p.jx._leopard, f"apply_{op}")(r.key(), ends)
        getattr(port_idx, f"apply_{op}")(r.key(), ends)
        for pf, rf in zip(port_idx._frags, p.jx._leopard._frags):
            assert_same_fragment(pf, rf)
    for frag in port_idx.reclose_pending():
        assert port_idx.reclose(frag)
    for frag in p.jx._leopard.reclose_pending():
        assert p.jx._leopard.reclose(frag)
    for pf, rf in zip(port_idx._frags, p.jx._leopard._frags):
        assert_same_fragment(pf, rf)


def test_over_budget_pairs_stay_on_the_sweep(monkeypatch):
    monkeypatch.setenv(port_leopard.BUDGET_ENV, "16")
    p = Pair()
    p.agree(["alice", "bob"])
    assert p.port._leopard.status_map()["doc#view"] == \
        "ineligible(over-budget)"
    assert p.port.stats["leopard_checks"] == 0
    assert p.port.stats["kernel_calls"] > 0


# -- group-explosion, small ---------------------------------------------------

@pytest.mark.parametrize("kernel", ["ell", "segment"])
def test_small_group_explosion_with_bench_churn(kernel):
    """The reference bench's Leopard deployment at 800 groups in depth-8
    chains, 64 users (more than 32: bit 31 of a closure word is live) and
    200 docs; A (index on) against B (index off) against jax:// against
    the oracle, through the bench's tail-user moves."""
    depth, n_users = 8, 64
    w = port_workloads.group_explosion(n_groups=800, n_users=n_users,
                                       n_docs=200)
    p = Pair(w.schema_text, w.relationships, kernel=kernel)
    b = TorchEndpoint(port_sch.parse_schema(w.schema_text),
                      store=p.port.store, device="cpu", kernel=kernel,
                      leopard=False)
    # B's reads go to the reference's B too, so that both workload planes
    # measure the same traffic (and order the same Leopard candidates)
    b_ref = _ref_endpoint(w.schema_text, False, kernel, store=p.jx.store)
    rng = random.Random(199)
    n_chains = 800 // depth
    docs = sorted(p.jx.store.object_ids_of_type("doc"))
    users = [f"u{i}" for i in range(n_users)]

    def compare(subjects):
        """A against B on a lookup batch and every doc for 4 subjects,
        then A against jax:// and the oracle (p.agree)."""
        subs = [SubjectRef("user", s) for s in subjects]
        a_l = run(p.port.lookup_resources_batch("doc", "view", subs))
        b_l = run(b.lookup_resources_batch("doc", "view", subs))
        assert [sorted(x) for x in a_l] == [sorted(x) for x in b_l]
        reqs = [CheckRequest(ObjectRef("doc", d), "view", s)
                for d in docs for s in subs[:4]]
        a_c = run(p.port.check_bulk_permissions(reqs))
        b_c = run(b.check_bulk_permissions(reqs))
        assert [c.allowed for c in a_c] == [c.allowed for c in b_c]
        # the same reads on jax://, so the counters stay comparable
        refs = [RefSubjectRef("user", s) for s in subjects]
        run(b_ref.lookup_resources_batch("doc", "view", refs))
        run(b_ref.check_bulk_permissions(
            [RefCheckRequest(RefObjectRef("doc", d), "view", s)
             for d in docs for s in refs[:4]]))
        run(p.jx.lookup_resources_batch("doc", "view", refs))
        run(p.jx.check_bulk_permissions(
            [RefCheckRequest(RefObjectRef("doc", d), "view", s)
             for d in docs for s in refs[:4]]))
        p.agree(subjects, docs=rng.sample(docs, 40))
        return sum(c.allowed for c in a_c)

    allowed = compare(users[:40])
    assert allowed > 0
    assert p.port._leopard.status_map()["doc#view"] == "indexed"
    frag = p.port._leopard.lookup_frag("doc", "view")
    assert bool((frag.plane[0] < 0).any())   # a column with bit 31 set
    assert int(b.graph().last_trace[0]) > 2   # B sweeps the chains
    for _ in range(3):
        ops = []
        for _ in range(4):
            c = rng.randrange(n_chains)
            tail = c * depth + depth - 1
            ops.append(("delete", f"group:g{tail}#member@user:u{c % n_users}"))
            ops.append(("touch", f"group:g{tail}#member"
                                 f"@user:u{rng.randrange(n_users)}"))
        p.write(ops)
        compare(rng.sample(users, 24))
    assert p.port.stats["leopard_recloses"] >= 1
    assert p.port._leopard.status_map()["doc#view"] == "indexed"
    assert b.stats["leopard_checks"] == b.stats["leopard_lookups"] == 0
