"""The port's tuple-space sharding held against the reference's.

Every scenario of tests/test_tuple_sharding.py runs on the port and on
the reference, and returns its observations — routes, encoded vectors,
answers, statuses, headers, bodies, revisions, error messages — which
must be equal between them:

- the partition map (parsing and its errors, routing of tuples, batches
  and filters, the footprint validation's errors and warnings,
  `describe()`) and the revision vectors (every token encoded, decoded,
  merged, refused), as pure functions of their inputs;
- the in-process `ShardedEndpoint` (bootstrap split, answers against the
  whole-store oracle, ordered bulk reassembly, refused spanning batches
  and preconditions, fan-out reads and deletes, internal-type reads, the
  merged watch, the revision vector) and the dual-write seam (a retried
  write converging on one shard, a lock released where it lives): on the
  port's `embedded://` and `torch://?device=cpu` shards against the
  reference's `jax://` shards, the answers also against the oracle;
- the thin router over two in-process shard leaders (`HandlerTransport`)
  and the `ProxyServer` in sharded mode (vector stamps and the vector
  gate, per-shard WAL lineages and their recovery, the refused spanning
  map, the SHARDING switch off, `/debug/sharding`): the port's leaders
  and proxies on both URLs against the reference's on `embedded://`;
- `partition_map_for_schema` on 50 of the reference fuzz's generated
  schemas; sharded data dirs written by one package and recovered by the
  other; the CLI's sharding flags validated as the reference validates
  them; and chip_smoke.py's phase 21 rehearsed on the CPU.
"""

import asyncio
import importlib
import json
import os
import shutil
import tempfile

import pytest
from hypothesis import given, settings, strategies as st

from test_tuple_sharding import PMAP_SPEC, RULES, SCHEMA

PORT_URLS = ["embedded://", "torch://?device=cpu"]


class SPkg:
    """The modules of one package that a sharding scenario needs."""

    def __init__(self, root: str):
        def mod(name):
            return importlib.import_module(f"{root}.{name}")
        self.root = root
        self.proxyrule = mod("config.proxyrule")
        self.kubefake = mod("kubefake.apiserver")
        self.httpcore = mod("proxy.httpcore")
        self.server = mod("proxy.server")
        self.sch = mod("spicedb.schema")
        self.endpoints = mod("spicedb.endpoints")
        self.evaluator = mod("spicedb.evaluator")
        self.types = mod("spicedb.types")
        self.store = mod("spicedb.store")
        self.repl = mod("spicedb.replication")
        self.lint = mod("spicedb.schema_lint")
        self.sharding = mod("spicedb.sharding")
        self.partition = mod("spicedb.sharding.partition")
        self.metrics = mod("spicedb.sharding.metrics")
        self.activity = mod("authz.distributedtx.activity")
        self.features = mod("utils.features")
        self.tracing = mod("utils.tracing")
        self.cli = mod("cli")

    def set_sharding(self, on: bool) -> None:
        if self.root.endswith("_torch"):
            self.features.SHARDING = on
        else:
            self.features.GATES.set("Sharding", on)

    def rel(self, s):
        return self.types.parse_relationship(s)

    def up(self, op: str, s):
        t = self.types
        rel = s if isinstance(s, t.Relationship) else t.parse_relationship(s)
        return t.RelationshipUpdate(getattr(t.UpdateOp, op), rel)

    def schema(self, text=SCHEMA):
        return self.endpoints.merge_internal_definitions(
            self.sch.parse_schema(text))


REF = SPkg("spicedb_kubeapi_proxy_tpu")
PORT = SPkg("spicedb_kubeapi_proxy_tpu_torch")


@pytest.fixture(autouse=True)
def reset_switches():
    yield
    PORT.features.SHARDING = True
    REF.features.GATES.reset()


@pytest.fixture
def tmp():
    d = tempfile.mkdtemp(prefix="torch-shard-test-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _err(fn):
    """(exception type name, message) of `fn()`, or ("ok", result)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the observation is the error
        return (type(e).__name__, str(e))


# -- the partition map, as pure functions ------------------------------------

def pm_parse(P):
    out = []
    for spec, n in (("pod=1, podns=1", 2), ("a=0,b=3", None), ("", 2),
                    (" pod = 1 ,", 2), ("pod", 2), ("pod=x", 2),
                    ("pod=2", 2), ("pod=0,pod=1", 2), ("pod=0,pod=0", 2),
                    ("=1", 2), ("pod=-1", 2), ("pod=1", 0)):
        def parse(spec=spec, n=n):
            pm = P.sharding.PartitionMap.parse(spec, n_shards=n)
            return (pm.describe(), [pm.shard_for_type(t) for t in
                                    ("pod", "namespace", "a", "b")])
        out.append(_err(parse))
    out.append(_err(lambda: P.sharding.PartitionMap(0)))
    out.append(_err(lambda: P.sharding.PartitionMap(2, {"x": 5})))
    out.append(_err(lambda: P.sharding.PartitionMap(2, default_shard=3)))
    return out


def pm_internal_hash(P):
    pm = P.sharding.PartitionMap.parse(PMAP_SPEC, n_shards=2)
    pm3 = P.sharding.PartitionMap.parse("pod=2", n_shards=3)
    return ([pm.shard_of("workflow", f"wf-{i}") for i in range(64)]
            + [pm.shard_of("lock", f"l{i}") for i in range(16)]
            + [pm3.shard_of("activity", f"h{i}") for i in range(16)]
            + [pm.shard_of("workflow", ""), pm.shard_of("pod", "x")],
            sorted(P.sharding.INTERNAL_TYPES))


def pm_batches(P):
    pm = P.sharding.PartitionMap.parse(PMAP_SPEC, n_shards=2)
    pod = P.up("TOUCH", "pod:a/p#creator@user:u")
    ns = P.up("TOUCH", "namespace:a#creator@user:u")
    key = P.up("CREATE", "workflow:wf1#idempotency_key@activity:h1")
    lock = P.up("CREATE", "lock:the-lock#workflow@workflow:wf1")
    out = [_err(lambda b=b: pm.shard_for_updates(b)) for b in
           ([pod], [pod, key], [ns, key], [lock], [], [key, lock],
            [pod, ns], [ns, pod, key])]
    F = P.types.RelationshipFilter
    out += [pm.shards_for_filter(f) for f in (
        None, F(resource_type="pod"), F(resource_type="namespace"),
        F(resource_type="lock"), F(relation="creator"))]
    out += [pm.shards_for_types(t) for t in (
        None, [], ["pod"], ["pod", "namespace"], ["podns", "pod"],
        ["workflow"], ["namespace"])]
    return out


def pm_validate(P):
    arrow = P.schema("""
definition user {}
definition namespace {
  relation viewer: user
  permission view = viewer
}
definition pod {
  relation namespace: namespace
  permission view = namespace->view
}
""")
    rules = P.proxyrule.parse(RULES)
    out = []
    for spec, schema, rc in (("pod=1", arrow, ()),
                             ("pod=1,namespace=1", arrow, ()),
                             ("pod=1", P.schema(), rules),
                             (PMAP_SPEC, P.schema(), rules),
                             ("no_such_type=1", P.schema(), ()),
                             ("mystery=1,pod=1", P.schema(), rules),
                             ("pod=0", P.schema(), rules)):
        pm = P.sharding.PartitionMap.parse(spec, n_shards=2)
        out.append((pm.validate_schema(schema, rc),
                    pm.closure_shards(schema, "pod", "view"),
                    sorted(pm.closure_types(schema, "pod", "view"))))
    single = P.sharding.PartitionMap.parse("ghost=0", n_shards=1)
    out.append(single.validate_schema(P.schema(), rules))
    return out


def pm_for_schema(P):
    schema = P.schema("""
definition user {}
definition group { relation member: user | group#member }
definition doc {
  relation org: org
  relation viewer: user | group#member
  permission view = viewer + org->admin
}
definition org {
  relation admin: user
}
definition island {
  relation owner: user
  permission own = owner
}
""")
    out = []
    for n in (1, 2, 3):
        pm = P.sharding.partition_map_for_schema(schema, n)
        out.append((pm.describe(), pm.validate_schema(schema)))
    return out


def routing_table(P):
    rules = P.proxyrule.parse(RULES)
    conflicting = P.proxyrule.parse(RULES + """
---
apiVersion: authzed.com/v1alpha1
kind: ProxyRule
metadata: {name: pods-as-namespace}
match: [{apiVersion: v1, resource: pods, verbs: [delete]}]
check: [{tpl: "namespace:{{namespace}}#view@user:{{user.name}}"}]
""")
    out = []
    for spec, rc, schema in ((PMAP_SPEC, rules, P.schema()),
                             (PMAP_SPEC, rules, None),
                             ("pod=1", rules, P.schema()),
                             ("pod=1", rules, None),
                             (PMAP_SPEC, conflicting, P.schema())):
        pm = P.sharding.PartitionMap.parse(spec, n_shards=2)
        out.append(_err(lambda pm=pm, rc=rc, schema=schema:
                        P.sharding.build_routing_table(pm, rc, schema)))
    out.append(_err(lambda: P.sharding.ShardRouter(
        P.sharding.PartitionMap.parse(PMAP_SPEC, n_shards=2), [None])))
    return out


def sharding_lint(P):
    out = []
    for spec, rules in (("pod=1", RULES), ("mystery=1", ""),
                        (PMAP_SPEC, RULES), (None, RULES)):
        pm = (P.sharding.PartitionMap.parse(spec, n_shards=2)
              if spec else None)
        found = P.lint.lint_schema(
            P.schema(), P.proxyrule.parse(rules) if rules else (),
            partition_map=pm)
        out.append([(f.code, f.severity, f.where, f.message)
                    for f in found])
    return out


PURE = {"parse": pm_parse, "internal_hash": pm_internal_hash,
        "batches": pm_batches, "validate": pm_validate,
        "for_schema": pm_for_schema, "routing_table": routing_table,
        "sharding_lint": sharding_lint}


@pytest.mark.parametrize("name", sorted(PURE))
def test_partition_map_matches_the_reference(name):
    got, want = PURE[name](PORT), PURE[name](REF)
    assert got == want


def test_partition_map_observations_hold_the_reference_tests_asserts():
    got = dict((k, f(PORT)) for k, f in PURE.items())
    assert got["parse"][0] == ("ok", ({"n_shards": 2, "default_shard": 0,
                                       "assignments": {"pod": 1,
                                                       "podns": 1}},
                                      [1, 0, 0, 0]))
    assert got["parse"][1][1][0]["n_shards"] == 4
    assert set(got["internal_hash"][0][:64]) == {0, 1}
    assert got["batches"][:3] == [("ok", 1), ("ok", 1), ("ok", 0)]
    assert got["batches"][6][0] == "CrossShardWriteError"
    assert got["validate"][1][0] == ([], [])
    assert got["routing_table"][0] == ("ok", {"namespaces": 0, "pods": 1})
    assert got["routing_table"][2][0] == "RouterConfigError"
    assert got["routing_table"][4][0] == "RouterConfigError"


# -- revision vectors ----------------------------------------------------------

TOKENS = ["", None, "0:12,2:7", "9", "*:3,1:8", "0:5", "0", " 1:2 , 0:1 ",
          "1:2,1:5", "*:4,*:9,3:1", "x", "0:abc", "a:1", "-1:2", "0:", ":1",
          "0:1,,1:2", "*:0", "007", "1:-2", "bogus:::", "5:0"]


def vec_obs(P, token):
    def go():
        v = P.sharding.RevisionVector.decode(token)
        return (v.encode(), dict(v.parts), v.floor, v.is_empty,
                [v.component(k) for k in range(5)],
                v.merged(1, 7).encode(), v.merged(0, 3).encode(),
                v.merged_with(P.sharding.RevisionVector.decode(
                    "0:5,1:1")).encode())
    return _err(go)


@pytest.mark.parametrize("token", TOKENS)
def test_revision_vector_token_matches_the_reference(token):
    assert vec_obs(PORT, token) == vec_obs(REF, token)


@settings(max_examples=200, deadline=None)
@given(parts=st.dictionaries(st.integers(0, 7), st.integers(0, 10**6),
                             max_size=5),
       floor=st.integers(0, 10**6),
       raw=st.text(alphabet="0123456789:,* ab-", max_size=16))
def test_revision_vectors_encode_and_decode_as_the_reference(parts, floor,
                                                             raw):
    got = PORT.sharding.RevisionVector(parts, floor=floor)
    want = REF.sharding.RevisionVector(parts, floor=floor)
    assert got.encode() == want.encode()
    assert (PORT.sharding.RevisionVector.decode(got.encode())
            == got)
    assert vec_obs(PORT, raw) == vec_obs(REF, raw)


# -- the in-process sharded endpoint -------------------------------------------

def make_sharded(P, url, rels_text=""):
    pm = P.sharding.PartitionMap.parse(PMAP_SPEC, n_shards=2)
    stores = [P.store.TupleStore(), P.store.TupleStore()]
    ep = P.sharding.build_sharded_endpoint(
        url, P.endpoints.Bootstrap(schema_text=SCHEMA,
                                   relationships_text=rels_text),
        pm, stores, rule_configs=P.proxyrule.parse(RULES))
    return ep, stores, pm


def _types(store):
    return sorted({r.resource.type for r in store.read(None)})


async def ep_bootstrap_splits(P, url):
    _, stores, _ = make_sharded(P, url, "namespace:a#creator@user:alice\n"
                                        "pod:a/p#creator@user:alice\n"
                                        "# a comment\n\n"
                                        "podns:a#creator@user:alice")
    return [_types(s) for s in stores], [s.revision for s in stores]


PARITY_RELS = ("namespace:a#creator@user:alice\n"
               "namespace:b#viewer@user:bob\n"
               "pod:a/p#creator@user:alice\n"
               "pod:a/q#viewer@user:bob\n"
               "pod:b/r#viewer@user:alice\n"
               "podns:a#creator@user:alice\n"
               "podns:b#creator@user:carol")


async def ep_parity_with_oracle(P, url):
    ep, stores, _ = make_sharded(P, url, PARITY_RELS)
    mirror = P.store.TupleStore()
    mirror.bulk_load([P.rel(line) for line in PARITY_RELS.splitlines()])
    oracle = P.evaluator.Evaluator(P.schema(), mirror)
    T = P.types
    out = []
    for rtype in ("namespace", "pod", "podns"):
        subjects = [T.SubjectRef("user", u)
                    for u in ("alice", "bob", "carol", "nobody")]
        batch = await ep.lookup_resources_batch(rtype, "view", subjects)
        for subject, ids in zip(subjects, batch):
            want = sorted(oracle.lookup_resources(rtype, "view", subject))
            got = sorted(await ep.lookup_resources(rtype, "view", subject))
            assert got == want == sorted(ids), (rtype, subject)
            streamed = sorted([i async for i in ep.lookup_resources_stream(
                rtype, "view", subject)])
            assert streamed == want
            reqs = [T.CheckRequest(T.ObjectRef(rtype, oid), "view", subject)
                    for oid in mirror.object_ids_of_type(rtype)]
            res = await ep.check_bulk_permissions(reqs)
            single = [await ep.check_permission(r) for r in reqs]
            tri = [r.permissionship.name for r in res]
            assert tri == [r.permissionship.name for r in single]
            want3 = [oracle.check3(r.resource, "view", subject)
                     for r in reqs]
            assert [{"NO_PERMISSION": 0, "CONDITIONAL_PERMISSION": 1,
                     "HAS_PERMISSION": 2}[t] for t in tri] == want3
            out.append((rtype, subject.id, got, tri))
    return out


async def ep_bulk_check_in_order(P, url):
    ep, _, _ = make_sharded(P, url, "namespace:a#creator@user:alice\n"
                                    "pod:a/p#creator@user:alice")
    T = P.types
    reqs = [T.CheckRequest(T.ObjectRef(rt, oid), "view",
                           T.SubjectRef("user", u))
            for rt, oid, u in (("pod", "a/p", "alice"),
                               ("namespace", "a", "alice"),
                               ("pod", "a/p", "bob"),
                               ("podns", "a", "alice"),
                               ("namespace", "a", "bob"),
                               ("pod", "a/p", "alice"))]
    fan0 = P.metrics._fanout.snapshot().get(("check_bulk",), 0)
    res = await ep.check_bulk_permissions(reqs)
    one = await ep.check_bulk_permissions(reqs[:1])
    fanned = P.metrics._fanout.snapshot().get(("check_bulk",), 0) - fan0
    return [r.permissionship.name for r in res + one], fanned


async def ep_cross_shard_write(P, url):
    ep, stores, _ = make_sharded(P, url)
    ups = [P.up("TOUCH", s) for s in ("pod:a/p#creator@user:u",
                                      "namespace:a#creator@user:u")]
    rej0 = P.metrics._cross_rejects.snapshot().get((), 0)
    try:
        await ep.write_relationships(ups)
        got = "written"
    except P.sharding.CrossShardWriteError as e:
        got = str(e)
    rej = P.metrics._cross_rejects.snapshot().get((), 0) - rej0
    return got, rej, [s.revision for s in stores]


async def ep_preconditions(P, url):
    T = P.types
    ep, stores, _ = make_sharded(P, url)
    pod = [P.up("TOUCH", "pod:a/p#creator@user:u")]
    out = []
    for flt in (T.RelationshipFilter(relation="creator"),
                T.RelationshipFilter(resource_type="namespace"),
                T.RelationshipFilter(resource_type="pod",
                                     resource_id="a/other"),
                T.RelationshipFilter(resource_type="lock",
                                     resource_id="nope")):
        pre = T.Precondition(op=T.PreconditionOp.MUST_NOT_MATCH, filter=flt)
        try:
            out.append(await ep.write_relationships(pod, [pre]))
        except P.sharding.CrossShardWriteError as e:
            out.append(str(e))
    return out, [s.revision for s in stores]


async def ep_fan_out(P, url):
    ep, stores, _ = make_sharded(P, url, "namespace:a#viewer@user:u\n"
                                         "pod:a/p#viewer@user:u\n"
                                         "podns:a#creator@user:u")
    T = P.types
    read0 = P.metrics._fanout.snapshot().get(("read",), 0)
    rels = await ep.read_relationships(None)
    streamed = [r async for r in ep.read_relationships_stream(
        T.RelationshipFilter(relation="viewer"))]
    typed = [r async for r in ep.read_relationships_stream(
        T.RelationshipFilter(resource_type="pod"))]
    fanned = P.metrics._fanout.snapshot().get(("read",), 0) - read0
    try:
        await ep.delete_relationships(
            T.RelationshipFilter(relation="viewer"),
            [T.Precondition(op=T.PreconditionOp.MUST_MATCH,
                            filter=T.RelationshipFilter(
                                resource_type="pod"))])
        refused = "deleted"
    except P.sharding.CrossShardWriteError as e:
        refused = str(e)
    rev = await ep.delete_relationships(T.RelationshipFilter(
        subject=None, resource_type="", relation="viewer"))
    left = await ep.read_relationships(None)
    return (sorted(r.rel_string() for r in rels),
            sorted(r.rel_string() for r in streamed),
            [r.rel_string() for r in typed], fanned, refused, rev,
            sorted(r.rel_string() for r in left),
            [s.revision for s in stores])


async def ep_internal_reads(P, url):
    import time as _time
    T = P.types
    ep, stores, _ = make_sharded(P, url)
    key_rel = T.Relationship(
        resource=T.ObjectRef("workflow", "wf-1"),
        relation="idempotency_key",
        subject=T.SubjectRef("activity", "h1"),
        expires_at=_time.time() + 3600)
    await ep.write_relationships([P.up("TOUCH", "pod:a/p#creator@user:u"),
                                  P.up("CREATE", key_rel)])
    found = await ep.read_relationships(T.RelationshipFilter(
        resource_type="workflow", resource_id="wf-1",
        relation="idempotency_key"))
    return [_types(s) for s in stores], len(found), ep.store.revision


async def ep_merged_watch(P, url):
    ep, _, _ = make_sharded(P, url)
    w = ep.watch(["pod", "namespace"])
    merged = isinstance(w, P.sharding.MergedWatcher)
    await ep.write_relationships([P.up("TOUCH", "pod:a/p#viewer@user:u")])
    await ep.write_relationships([P.up("TOUCH",
                                       "namespace:a#viewer@user:u")])
    seen = []
    for _ in range(2):
        batch = await w.next(timeout=5.0)
        assert batch is not None
        seen.append(sorted(u.rel.rel_string() for u in batch.updates))
    w.close()
    after = await w.next(timeout=1.0)
    single = ep.watch(["pod"])
    one = isinstance(single, P.sharding.MergedWatcher)
    single.close()
    everything = ep.watch()
    every = isinstance(everything, P.sharding.MergedWatcher)
    everything.close()
    return merged, sorted(seen), after, one, every


async def ep_revision_vector(P, url):
    ep, stores, _ = make_sharded(P, url)
    for _ in range(3):
        await ep.write_relationships([P.up("TOUCH",
                                           "pod:a/p#viewer@user:u")])
    await ep.write_relationships([P.up("TOUCH", "namespace:a#viewer@user:u")])
    stats = ep.stats
    return (ep.revision_vector().encode(), ep.store.revision,
            [s.revision for s in stores], stats["shards"],
            ep.queue_depth())


def _stable_lock_id(P, shard):
    return next(f"lk{i}" for i in range(64)
                if P.partition._stable_shard(f"lk{i}", 2) == shard)


class _NullTransport:
    async def round_trip(self, req):  # pragma: no cover - never called
        raise AssertionError("no kube traffic expected")


async def ep_retried_dual_write(P, url):
    ep, stores, _ = make_sharded(P, url, "podns:a#creator@user:alice")
    handler = P.activity.ActivityHandler(ep, _NullTransport())
    req = {"updates": [{"op": "create", "rel": "pod:a/p#creator@user:alice"}],
           "preconditions": []}
    first = await handler.write_to_spicedb(req, "wf-77")
    second = await handler.write_to_spicedb(req, "wf-77")
    pods = await ep.read_relationships(P.types.RelationshipFilter(
        resource_type="pod", resource_id="a/p"))
    assert second["written_at"] >= first["written_at"] >= 1
    return first, second, len(pods), [_types(s) for s in stores]


async def ep_lock_release(P, url):
    ep, stores, _ = make_sharded(P, url, "podns:a#creator@user:alice")
    handler = P.activity.ActivityHandler(ep, _NullTransport())
    lock_id = _stable_lock_id(P, 0)
    lock_rel = f"lock:{lock_id}#workflow@workflow:wf-9"
    pre = {"op": "must_not_match",
           "filter": {"resource_type": "lock", "resource_id": lock_id,
                      "relation": "workflow",
                      "subject": {"type": "workflow", "id": "",
                                  "relation": None}}}
    out = [await handler.write_to_spicedb(
        {"updates": [{"op": "create", "rel": "pod:a/p#creator@user:alice"},
                     {"op": "create", "rel": lock_rel}],
         "preconditions": [pre]}, "wf-9")]
    out.append([_types(s) for s in stores])
    out.append(await handler.write_to_spicedb(
        {"updates": [{"op": "delete", "rel": lock_rel}],
         "preconditions": []}, "wf-9-cleanup"))
    out.append([_types(s) for s in stores])
    out.append(await handler.write_to_spicedb(
        {"updates": [{"op": "touch", "rel": "pod:a/p#creator@user:alice"},
                     {"op": "create", "rel": lock_rel}],
         "preconditions": [pre]}, "wf-10"))
    assert not any("lock" in t for t in out[3])
    return out


ENDPOINT_SCENARIOS = {
    "bootstrap_splits": ep_bootstrap_splits,
    "parity_with_oracle": ep_parity_with_oracle,
    "bulk_check_in_order": ep_bulk_check_in_order,
    "cross_shard_write": ep_cross_shard_write,
    "preconditions": ep_preconditions,
    "fan_out": ep_fan_out,
    "internal_reads": ep_internal_reads,
    "merged_watch": ep_merged_watch,
    "revision_vector": ep_revision_vector,
    "retried_dual_write": ep_retried_dual_write,
    "lock_release": ep_lock_release,
}

_REF_EP_OBS: dict = {}


@pytest.mark.parametrize("url", PORT_URLS)
@pytest.mark.parametrize("name", sorted(ENDPOINT_SCENARIOS))
def test_sharded_endpoint_matches_the_reference_on_jax(name, url):
    if name not in _REF_EP_OBS:
        _REF_EP_OBS[name] = asyncio.run(ENDPOINT_SCENARIOS[name](
            REF, "jax://"))
    got = asyncio.run(ENDPOINT_SCENARIOS[name](PORT, url))
    assert got == _REF_EP_OBS[name]


def test_sharded_endpoint_walks_the_wrappers_to_each_shard():
    """Over batched `torch://?device=cpu` with the decision cache, each
    shard's store, stats, waits and explain are found through its
    wrappers, each shard's cache holds its own answers only, and close()
    ends every merged watch's threads."""
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        TorchEndpoint)
    T = PORT.types
    ep, stores, _ = make_sharded(PORT, "torch://?device=cpu&cache=1",
                                 PARITY_RELS)
    assert [type(s).__name__ for s in ep.shards] == [
        "DecisionCacheEndpoint"] * 2
    assert ep.shard_stores() == stores
    alice = T.SubjectRef("user", "alice")

    async def go():
        await ep.lookup_resources("pod", "view", alice)
        await ep.lookup_resources("pod", "view", alice)
        await ep.lookup_resources("namespace", "view", alice)
        w = ep.watch(["pod", "namespace"])
        await ep.close()
        return w

    w = asyncio.run(go())
    assert w.join(5.0) and w.closed
    caches = [s.cache.stats for s in ep.shards]
    assert (caches[0]["hits"], caches[0]["misses"]) == (0, 1)
    assert (caches[1]["hits"], caches[1]["misses"]) == (1, 1)
    ep.warm_start(prewarm=False)
    ep.wait_rebuilds(5.0)
    stats = ep.shard_stats()
    assert len(stats) == 2 and all(s["rebuilds"] == 1 for s in stats)
    inner = ep.shards[1]
    while not isinstance(inner, TorchEndpoint):
        inner = inner.inner
    witness = ep.explain_check(T.ObjectRef("pod", "a/p"), "view", alice)
    assert witness.decision == "allowed"
    assert inner.stats["explain_checks"] == 1


# -- the proxy in sharded mode --------------------------------------------------

def make_sharded_proxy(P, url, tmp=None, rules=RULES, pods=(), **opt_kw):
    kube = P.kubefake.FakeKubeApiServer()
    kube.seed("", "v1", "namespaces", {"metadata": {"name": "team-a"}})
    for name in pods:
        kube.seed("", "v1", "pods", {"metadata": {"name": name,
                                                  "namespace": "team-a"}})
    proxy = P.server.ProxyServer(P.server.Options(
        spicedb_endpoint=url,
        bootstrap=P.endpoints.Bootstrap(
            schema_text=SCHEMA,
            relationships_text=("namespace:team-a#creator@user:alice\n"
                                "podns:team-a#creator@user:alice")),
        rules_yaml=rules,
        upstream_transport=P.httpcore.HandlerTransport(kube),
        shards=2, partition_map=PMAP_SPEC,
        **({"data_dir": tmp, "wal_fsync": "never"} if tmp else {}),
        **opt_kw))
    proxy.enable_dual_writes()
    return proxy


def _resp(P, resp, names=False):
    """(status, revision stamp, body) of a response; a list body as its
    sorted item names."""
    body = resp.body
    try:
        body = json.loads(body)
    except ValueError:
        body = body.decode()
    if names and resp.status == 200:
        body = sorted(i["metadata"]["name"] for i in body.get("items", []))
    return (resp.status, resp.headers.get(P.repl.REVISION_HEADER), body)


def _pod(name):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "team-a"}}


async def px_dual_write_lands(P, url, tmp):
    proxy = make_sharded_proxy(P, url, tmp)
    client = proxy.get_embedded_client("alice")
    out = [_resp(P, await client.post("/api/v1/namespaces/team-a/pods",
                                      _pod("p1")))[:2]]
    stores = proxy.endpoint.shard_stores()
    rel = P.rel("pod:team-a/p1#creator@user:alice")
    out.append([s.has_exact(rel) for s in stores])
    out.append(_resp(P, await client.get("/api/v1/namespaces/team-a/pods"),
                     names=True))
    out.append(_resp(P, await client.get("/api/v1/namespaces/team-a")))
    return out


async def px_vector_gate(P, url, tmp):
    proxy = make_sharded_proxy(P, url, tmp)
    client = proxy.get_embedded_client("alice")
    H = P.repl.MIN_REVISION_HEADER
    out = []
    for tok in ("0:999", "0:1", "junk:", "5:9", "5:0", "1:1", "*:1", "2",
                "1:9,0:1"):
        out.append(_resp(P, await client.get("/api/v1/namespaces/team-a",
                                             headers=[(H, tok)])))
    return out


async def px_lock_release(P, url, tmp):
    proxy = make_sharded_proxy(P, url, tmp, rules=RULES.replace(
        "lock: Optimistic", "lock: Pessimistic"))
    client = proxy.get_embedded_client("alice")
    out = []
    for name in ("p1", "p2", "p3", "p4"):
        out.append(_resp(P, await client.post(
            "/api/v1/namespaces/team-a/pods", _pod(name)))[:2])
    out.append([[r.rel_string() for r in s.read(None)
                 if r.resource.type == "lock"]
                for s in proxy.endpoint.shard_stores()])
    return out


async def px_recovery(P, url, tmp):
    proxy = make_sharded_proxy(P, url, tmp)
    client = proxy.get_embedded_client("alice")
    out = [_resp(P, await client.post("/api/v1/namespaces/team-a/pods",
                                      _pod("p1")))[:2]]
    out.append([s.revision for s in proxy.endpoint.shard_stores()])
    out.append(sorted(os.listdir(tmp)))
    proxy2 = make_sharded_proxy(P, url, tmp)
    stores = proxy2.endpoint.shard_stores()
    out.append([s.revision for s in stores])
    out.append([sorted(r.rel_string() for r in s.read(None)
                       if r.resource.type not in ("workflow", "activity"))
                for s in stores])
    out.append([m.recovered for m in proxy2._shard_persistence])
    if P is PORT:
        await proxy2.warm_start()
    out.append(_resp(P, await proxy2.get_embedded_client("alice").get(
        "/api/v1/namespaces/team-a/pods"), names=True))
    return out


async def px_spanning_map(P, url, tmp):
    kube = P.kubefake.FakeKubeApiServer()
    out = []
    for spec, rules in (("pod=1", RULES), ("pod=1,podns=1", RULES.replace(
            "podns:{{namespace}}", "namespace:{{namespace}}"))):
        out.append(_err(lambda spec=spec, rules=rules: P.server.ProxyServer(
            P.server.Options(
                spicedb_endpoint=url,
                bootstrap=P.endpoints.Bootstrap(schema_text=SCHEMA),
                rules_yaml=rules,
                upstream_transport=P.httpcore.HandlerTransport(kube),
                shards=2, partition_map=spec)) and None))
    for bad in ({"spicedb_endpoint": "mystery://"},
                {"replicate_from": "http://leader"}):
        opts = dict(spicedb_endpoint=url, shards=2, partition_map=PMAP_SPEC,
                    upstream_transport=P.httpcore.HandlerTransport(kube))
        opts.update(bad)
        out.append(_err(lambda opts=opts: P.server.ProxyServer(
            P.server.Options(**opts)) and None))
    out.append(_err(lambda: P.server.ProxyServer(P.server.Options(
        spicedb_endpoint=url, shards=2, partition_map="pod=5",
        upstream_transport=P.httpcore.HandlerTransport(kube))) and None))
    return out


async def px_switch_off(P, url, tmp):
    P.set_sharding(False)
    before = dict(P.metrics._routed.snapshot())
    proxy = make_sharded_proxy(P, url)
    client = proxy.get_embedded_client("alice")
    out = [proxy.sharding is None,
           hasattr(proxy.endpoint.inner, "shards"),
           _resp(P, await client.get("/api/v1/namespaces/team-a")),
           _resp(P, await client.post("/api/v1/namespaces/team-a/pods",
                                      _pod("p9")))[:2],
           _resp(P, await client.get("/debug/sharding"))]
    assert dict(P.metrics._routed.snapshot()) == before
    return out


async def px_debug_sharding(P, url, tmp):
    proxy = make_sharded_proxy(P, url, tmp)
    client = proxy.get_embedded_client("alice")
    out = [_resp(P, await client.get("/debug/sharding"))]
    await client.post("/api/v1/namespaces/team-a/pods", _pod("p1"))
    out.append(_resp(P, await client.get("/debug/sharding")))
    out.append((await proxy.get_embedded_client().get(
        "/debug/sharding")).status)
    return out


PROXY_SCENARIOS = {
    "dual_write_lands": px_dual_write_lands,
    "vector_gate": px_vector_gate,
    "lock_release": px_lock_release,
    "recovery": px_recovery,
    "spanning_map": px_spanning_map,
    "switch_off": px_switch_off,
    "debug_sharding": px_debug_sharding,
}


# -- the router over two in-process shard leaders ------------------------------

def make_shard_leader(P, url, tmp, subdir, seed_rels):
    kube = P.kubefake.FakeKubeApiServer()
    kube.seed("", "v1", "namespaces", {"metadata": {"name": "team-a"}})
    proxy = P.server.ProxyServer(P.server.Options(
        spicedb_endpoint=url,
        bootstrap=P.endpoints.Bootstrap(schema_text=SCHEMA),
        rules_yaml=RULES,
        upstream_transport=P.httpcore.HandlerTransport(kube),
        data_dir=os.path.join(tmp, subdir), wal_fsync="never",
        replica_wait_ms=50.0))
    if seed_rels and proxy.endpoint.store.revision == 0:
        proxy.endpoint.store.bulk_load([P.rel(r) for r in seed_rels])
    proxy.enable_dual_writes()
    return proxy


def make_router(P, url, tmp):
    shard0 = make_shard_leader(P, url, tmp, "s0",
                               ["namespace:team-a#creator@user:alice"])
    shard1 = make_shard_leader(P, url, tmp, "s1",
                               ["podns:team-a#creator@user:alice"])
    pm = P.sharding.PartitionMap.parse(PMAP_SPEC, n_shards=2)
    router = P.sharding.ShardRouter(
        pm, [P.httpcore.HandlerTransport(shard0.handler),
             P.httpcore.HandlerTransport(shard1.handler)],
        rule_configs=P.proxyrule.parse(RULES), schema=P.schema())
    return router, shard0, shard1


async def router_req(P, router, method, target, user="alice", body=None,
                     headers=()):
    h = P.httpcore.Headers(list(headers))
    if user:
        h.set("X-Remote-User", user)
    h.set("Accept", "application/json")
    data = b""
    if body is not None:
        data = json.dumps(body).encode()
        h.set("Content-Type", "application/json")
    return await router.handle(P.httpcore.Request(
        method=method, target=target, headers=h, body=data))


def _rresp(P, resp, names=False):
    return _resp(P, resp, names) + (resp.headers.get("X-Authz-Shard"),)


async def rt_dual_write_routes(P, url, tmp):
    router, shard0, shard1 = make_router(P, url, tmp)
    out = [_rresp(P, await router_req(P, router, "POST",
                                      "/api/v1/namespaces/team-a/pods",
                                      body=_pod("p1")))[:2]]
    rel = P.rel("pod:team-a/p1#creator@user:alice")
    out.append((shard0.endpoint.store.has_exact(rel),
                shard1.endpoint.store.has_exact(rel)))
    out.append(_rresp(P, await router_req(P, router, "GET",
                                          "/api/v1/namespaces/team-a")))
    out.append(_rresp(P, await router_req(
        P, router, "GET", "/api/v1/namespaces/team-a/pods"), names=True))
    out.append(_rresp(P, await router_req(P, router, "GET",
                                          "/api/v1/namespaces"), names=True))
    out.append(router.stats)
    return out


async def rt_vector_tokens(P, url, tmp):
    router, shard0, shard1 = make_router(P, url, tmp)
    H = P.repl.MIN_REVISION_HEADER
    future = shard1.endpoint.store.revision + 100
    out = []
    for target, tok in (("/api/v1/namespaces/team-a", f"1:{future}"),
                        ("/api/v1/namespaces/team-a/pods", f"1:{future}"),
                        ("/api/v1/namespaces/team-a/pods",
                         f"1:{shard1.endpoint.store.revision}"),
                        ("/api/v1/namespaces/team-a",
                         str(shard0.endpoint.store.revision + 100)),
                        ("/api/v1/namespaces/team-a", "bogus:::"),
                        ("/api/v1/namespaces/team-a", "0:1,1:1"),
                        ("/api/v1/namespaces/team-a/pods", "*:1")):
        out.append(_rresp(P, await router_req(P, router, "GET", target,
                                              headers=[(H, tok)])))
    return out


async def rt_dead_shard(P, url, tmp):
    router, _, _ = make_router(P, url, tmp)

    class Dead:
        async def round_trip(self, req):
            raise ConnectionError("kill -9")

    router.transports[1] = Dead()
    out = [_rresp(P, await router_req(P, router, "GET",
                                      "/api/v1/namespaces/team-a/pods")),
           _rresp(P, await router_req(P, router, "GET",
                                      "/api/v1/namespaces/team-a"))]
    for path in ("/readyz", "/livez", "/healthz"):
        out.append(_rresp(P, await router_req(P, router, "GET", path)))
    out.append(router.stats)
    return out


async def rt_health_and_metrics(P, url, tmp):
    router, _, _ = make_router(P, url, tmp)
    out = [_rresp(P, await router_req(P, router, "GET", "/readyz"))]
    resp = await router_req(P, router, "GET", "/metrics", user="")
    out.append((resp.status, resp.headers.get("Content-Type"),
                "authz_shard_fanout_total" in resp.body.decode()))
    resp = await router_req(P, router, "GET", "/debug/traces", user="")
    out.append(_rresp(P, resp))
    return out


async def rt_switch_off(P, url, tmp):
    router, _, _ = make_router(P, url, tmp)
    P.set_sharding(False)
    out = [_rresp(P, await router_req(P, router, "POST",
                                      "/api/v1/namespaces/team-a/pods",
                                      body=_pod("p9")))[:2]
           + (None,),
           _rresp(P, await router_req(P, router, "GET", "/readyz")),
           _rresp(P, await router_req(
               P, router, "GET", "/api/v1/namespaces/team-a",
               headers=[(P.repl.MIN_REVISION_HEADER, "0:1,1:1")]))]
    return out


ROUTER_SCENARIOS = {
    "dual_write_routes": rt_dual_write_routes,
    "vector_tokens": rt_vector_tokens,
    "dead_shard": rt_dead_shard,
    "health_and_metrics": rt_health_and_metrics,
    "switch_off": rt_switch_off,
}

SERVER_SCENARIOS = {**{f"proxy_{k}": v for k, v in PROXY_SCENARIOS.items()},
                    **{f"router_{k}": v for k, v in ROUTER_SCENARIOS.items()}}
_REF_SRV_OBS: dict = {}


_VOLATILE = {"traces", "uid", "creationTimestamp"}


def _scrub(obs):
    """Trace ids, the fake's object uids and timestamps are minted per
    run: mask them wherever a body carries them."""
    if isinstance(obs, dict):
        return {k: (f"<{k}>" if k in _VOLATILE else _scrub(v))
                for k, v in obs.items()}
    if isinstance(obs, (list, tuple)):
        return type(obs)(_scrub(x) for x in obs)
    if isinstance(obs, str):
        # a message naming the store-backed schemes names each
        # package's own device scheme
        return obs.replace("jax://", "torch://")
    return obs


def srv_ref_obs(name):
    if name not in _REF_SRV_OBS:
        d = tempfile.mkdtemp(prefix="ref-shard-test-")
        try:
            _REF_SRV_OBS[name] = _scrub(asyncio.run(
                SERVER_SCENARIOS[name](REF, "embedded://", d)))
        finally:
            REF.features.GATES.reset()
            shutil.rmtree(d, ignore_errors=True)
    return _REF_SRV_OBS[name]


@pytest.mark.parametrize("url", PORT_URLS)
@pytest.mark.parametrize("name", sorted(SERVER_SCENARIOS))
def test_sharded_server_and_router_match_the_reference(name, url, tmp):
    got = _scrub(asyncio.run(SERVER_SCENARIOS[name](PORT, url, tmp)))
    assert got == srv_ref_obs(name)


def test_router_holds_the_reference_tests_asserts(tmp):
    """The reference test's assertions, on the port's router over the
    port's `torch://?device=cpu` leaders."""
    url = "torch://?device=cpu"
    routes = asyncio.run(rt_dual_write_routes(PORT, url, tmp + "/a"))
    assert routes[0][0] in (200, 201) and routes[0][1]
    vec = PORT.sharding.RevisionVector.decode(routes[0][1])
    assert vec.component(1) > 0 and vec.component(0) == 0
    assert routes[1] == (False, True) and routes[2][3] == "0"
    assert routes[3][2] == ["p1"] and routes[3][3] == "1"
    tokens = asyncio.run(rt_vector_tokens(PORT, url, tmp + "/b"))
    assert [t[0] for t in tokens][:5] == [200, 503, 200, 503, 400]
    dead = asyncio.run(rt_dead_shard(PORT, url, tmp + "/c"))
    assert dead[0][0] == 502 and dead[0][2]["details"]["shard"] == 1
    assert dead[1][0] == 200 and "[-] shard 1" in dead[2][2]
    off = asyncio.run(rt_switch_off(PORT, url, tmp + "/d"))
    assert off[0][1] and ":" not in off[0][1]
    assert "shard 1" not in off[1][2]


def test_router_refuses_the_fleet_plane(tmp):
    """The router's fleet plane, refused while it was unported (a
    TypeError for `fleet_peers=`, 404 at /debug/fleet and /debug/tail),
    answers as the reference router's: `fleet_peers=` is taken, the
    RouterServer adds its shard leaders as implicit members, both
    surfaces want an identity (401), and a router without peers says so
    at both; with the shard leaders as peers /debug/fleet merges one
    routed request's trace across the router and its leader."""
    def observe(P, url, sub):
        P.tracing.RECORDER.drain()
        pm = P.sharding.PartitionMap.parse(PMAP_SPEC, n_shards=2)
        server = P.sharding.RouterServer(pm, ["http://a", "http://b"],
                                         fleet_peers=["http://x",
                                                      "http://a"])
        members = server.router.fleet_peers
        bare, shard0, shard1 = make_router(P, url, os.path.join(tmp, sub))
        fleet = P.sharding.ShardRouter(
            pm, bare.transports, rule_configs=P.proxyrule.parse(RULES),
            schema=P.schema(), fleet_peers=["http://s0", "http://s1"],
            fleet_transports={
                "http://s0": P.httpcore.HandlerTransport(shard0.handler),
                "http://s1": P.httpcore.HandlerTransport(shard1.handler)})

        async def go():
            out = []
            for path in ("/debug/fleet", "/debug/tail"):
                r = await router_req(P, bare, "GET", path, user="")
                out.append((r.status, json.loads(r.body)["reason"]))
                r = await router_req(P, bare, "GET", path)
                out.append((r.status, json.loads(r.body)))
            r = await router_req(P, fleet, "GET",
                                 "/api/v1/namespaces/team-a")
            out.append(r.status)
            r = await router_req(P, fleet, "GET", "/debug/fleet")
            merged = json.loads(r.body)
            out.append((r.status, merged["enabled"], merged["tier"],
                        [(m["url"], m["error"]) for m in merged["members"]],
                        [(sorted(t["tiers"]), t["tier_count"],
                          t["aligned_by_wall"]) for t in merged["traces"]]))
            return out
        return members, asyncio.run(go())

    got = observe(PORT, "embedded://", "port")
    assert got == observe(REF, "embedded://", "ref")
    members, out = got
    assert members == ["http://a", "http://b", "http://x"]
    assert out[0] == out[2] == (401, "Unauthorized")
    assert out[1] == (200, {"enabled": False, "tier": "router",
                            "reason": "no fleet peers configured"})
    assert out[3] == out[1]
    assert out[4] == 200
    assert out[5] == (200, True, "router",
                      [("router", None), ("http://s0", None),
                       ("http://s1", None)],
                      [(["leader", "router"], 2, False)])


def test_sharded_construction_refuses_before_any_graph(monkeypatch):
    """A spanning map raises RouterConfigError before any endpoint is
    built: the port's factory is never called."""
    from spicedb_kubeapi_proxy_tpu_torch.spicedb import endpoints
    built = []
    real = endpoints.create_endpoint
    monkeypatch.setattr(endpoints, "create_endpoint",
                        lambda *a, **k: built.append(a) or real(*a, **k))
    with pytest.raises(PORT.sharding.RouterConfigError, match="SL007"):
        PORT.server.ProxyServer(
            PORT.server.Options(
                spicedb_endpoint="torch://?device=cpu",
                bootstrap=PORT.endpoints.Bootstrap(schema_text=SCHEMA),
                rules_yaml=RULES, shards=2, partition_map="pod=1",
                upstream_transport=PORT.httpcore.HandlerTransport(
                    PORT.kubefake.FakeKubeApiServer())))
    assert built == []
    make_sharded_proxy(PORT, "torch://?device=cpu")
    assert len(built) == 2


# -- partition maps of generated schemas -----------------------------------------

@pytest.mark.parametrize("seed", range(50))
def test_partition_map_for_generated_schema_matches_the_reference(seed):
    from spicedb_kubeapi_proxy_tpu.fuzz.driver import build_case
    case = build_case(seed)
    ref_schema = case.parsed_schema()
    schema = PORT.sch.parse_schema(case.schema_text)
    for n in (2, 3):
        got = PORT.sharding.partition_map_for_schema(schema, n)
        want = REF.sharding.partition_map_for_schema(ref_schema, n)
        assert got.describe() == want.describe()
        assert got.validate_schema(schema) == want.validate_schema(
            ref_schema) == ([], [])


# -- sharded data dirs across the packages --------------------------------------

@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref")])
def test_sharded_data_dir_recovers_in_the_other_package(writer, reader, tmp):
    """One package's `shards=2` data dir (shard 0 checkpointed, shard 1 a
    WAL tail only) recovers in the other: every shard's revision and
    tuples, and the answers through the proxy, equal."""
    W, R = {"ref": (REF, "embedded://"),
            "port": (PORT, "torch://?device=cpu")}[writer], {
        "ref": (REF, "jax://"), "port": (PORT, "torch://?device=cpu")}[
        reader]

    async def write():
        proxy = make_sharded_proxy(W[0], W[1], tmp)
        client = proxy.get_embedded_client("alice")
        for name in ("p1", "p2"):
            resp = await client.post("/api/v1/namespaces/team-a/pods",
                                     _pod(name))
            assert resp.status == 201
        await proxy.endpoint.write_relationships([W[0].up(
            "TOUCH", "namespace:team-a#viewer@user:bob")])
        proxy._shard_persistence[0].checkpoint()
        await proxy.endpoint.write_relationships([W[0].up(
            "TOUCH", "pod:team-a/p1#viewer@user:bob")])
        state = [(s.revision, sorted(r.rel_string() for r in s.read(None)))
                 for s in proxy.endpoint.shard_stores()]
        for m in proxy._shard_persistence:
            m.close()
        return state

    async def read():
        proxy = make_sharded_proxy(R[0], R[1], tmp, pods=("p1", "p2"))
        state = [(s.revision, sorted(r.rel_string() for r in s.read(None)))
                 for s in proxy.endpoint.shard_stores()]
        if R[0] is PORT:
            await proxy.warm_start()
        out = []
        for user in ("alice", "bob"):
            c = proxy.get_embedded_client(user)
            out.append(_resp(R[0], await c.get(
                "/api/v1/namespaces/team-a/pods"), names=True)[::2])
            out.append((await c.get("/api/v1/namespaces/team-a")).status)
        info = [m.recovery_info["checkpoint_revision"] > 0
                for m in proxy._shard_persistence]
        return state, out, info

    written = asyncio.run(write())
    recovered, answers, ckpt = asyncio.run(read())
    assert recovered == written
    assert ckpt == [True, False]
    assert answers == [(200, ["p1", "p2"]), 200, (200, ["p1"]), 200]


# -- the CLI's sharding flags ----------------------------------------------------

_BASE = ["--rule-config", "R", "--use-in-cluster-config"]


@pytest.mark.parametrize("argv", [
    ["--shards", "2", "--partition-map", "pod=1"],
    ["--shards", "0"],
    ["--shards", "2", "--partition-map", "pod=2"],
    ["--shards", "2", "--replicate-from", "http://l:1"],
    ["--partition-map", "pod"],
    ["--partition-map", "pod=3"],
    ["--shard-leaders", "http://a:1,http://b:2", "--partition-map",
     "pod=1", "--secure-port", "0"],
    ["--shard-leaders", "http://a:1,ftp://b", "--shards", "2",
     "--data-dir", "D", "--replicate-from", "http://l"],
    ["--shard-leaders", "http://a:1", "--partition-map", "pod=1"],
    ["--shard-leaders", "http://a:1,http://b:2", "--embedded-mode"],
    ["--lint-schema", "--shards", "-3", "--partition-map", "bad"],
])
def test_sharding_flags_validate_as_the_reference(argv):
    args = PORT.cli.build_parser().parse_args(_BASE + argv)
    ref_args = REF.cli.build_parser().parse_args(_BASE + argv)
    errs, ref_errs = PORT.cli.validate(args), REF.cli.validate(ref_args)
    # the reference names its own device scheme where the port names
    # torch://
    assert errs == [e.replace("jax://", "torch://") for e in ref_errs]


@pytest.mark.parametrize("endpoint,ok", [
    ("torch://", True), ("torch://?device=cpu", True), ("embedded://", True),
    ("jax://", False), ("grpc.example:50051", False), ("mystery://", False)])
def test_shards_need_a_store_backed_port_endpoint(endpoint, ok):
    errs = PORT.cli.validate(PORT.cli.build_parser().parse_args(
        _BASE + ["--shards", "2", "--spicedb-endpoint", endpoint]))
    want = "--shards requires a store-backed endpoint (embedded:// or torch://)"
    assert (want not in errs) == ok
    assert (errs == []) == ok


def test_router_cli_malformed_bootstrap_is_a_clean_error(tmp, capsys):
    bad = os.path.join(tmp, "bad.yaml")
    with open(bad, "w") as f:
        f.write("schema: [unclosed\n")
    out = []
    for P in (PORT, REF):
        rc = P.cli.main(["--shard-leaders",
                         "http://127.0.0.1:1,http://127.0.0.1:2",
                         "--embedded-mode", "--spicedb-bootstrap", bad])
        err = capsys.readouterr().err
        out.append((rc, err.startswith("error:")))
    assert out == [(1, True), (1, True)]


def test_router_cli_refuses_a_spanning_rule_like_the_reference(tmp, capsys):
    rules = os.path.join(tmp, "rules.yaml")
    with open(rules, "w") as f:
        f.write(RULES)
    out = []
    for P in (PORT, REF):
        rc = P.cli.main(["--shard-leaders",
                         "http://127.0.0.1:1,http://127.0.0.1:2",
                         "--embedded-mode", "--partition-map", "pod=1",
                         "--rule-config", rules])
        out.append((rc, capsys.readouterr().err))
    assert out[0] == out[1] and out[0][0] == 1
    assert "create-pods" in out[0][1]


# -- chip_smoke.py's phase 21 on the CPU, at a small size ------------------------

def test_chip_smoke_phase21_rehearsal_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 21 (the two-shard proxy over a small
    multitenant-1m and shard 1's configmap and secret classes, (a)-(f),
    and the shard leaders, the router and the lint as processes, (g))
    runs on `device="cpu"`, the kernels' twins counting launches as the
    card's wrappers do: every check of the phase holds here too (the
    ledger against the card's allocator apart), and every read kernel
    and `scatter_rows` launched."""
    import functools
    import importlib.util
    import pathlib

    from spicedb_kubeapi_proxy_tpu_torch.models import workloads
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.utils import features

    pytest.importorskip("h11")
    pytest.importorskip("yaml")
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setenv("SPICEDB_TPU_LEOPARD_BUDGET_BYTES", "0")
    monkeypatch.setattr(features, "ASYNC_REBUILD", features.ASYNC_REBUILD)
    for name in kernels.KERNEL_NAMES:
        fn = getattr(reference, name, None)
        if fn is None:
            continue

        def counted(*a, _fn=fn, _name=name, **k):
            kernels._count(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(reference, name, functools.wraps(fn)(counted))
    for const, value in (("SHARD_CONFIGMAPS", 4_000), ("SHARD_SECRETS", 4_000),
                         ("SHARD_NAMESPACES", 200),
                         ("SHARD_KUBE_CONFIGMAPS", 1_000),
                         ("PROXY_NAMESPACES", 200), ("PROXY_PODS", 1_000),
                         ("PROXY_EVENTS", 10), ("SHARD_LISTS", 16),
                         ("SHARD_CREATES", 8), ("SHARD_BULK_CHECKS", 1_000),
                         ("SHARD_ISOLATION_LISTS", 16)):
        monkeypatch.setattr(smoke, const, value)
    w = workloads.multitenant_1m(n_pods=8_000, n_tuples=30_000,
                                 n_users=500, n_namespaces=200)
    out = smoke.shard_path(w, "cpu", device="cpu")
    assert all(out["launches"][k] > 0
               for k in smoke.READ_KERNELS + ("scatter_rows",))
    assert out["rebuilds"][1]["bg_rebuilds"] == 1
    assert smoke.shard_cli("cpu", device="cpu")["s"] > 0
