"""Crash recovery of the port's durable store, held against the oracle
and the reference.

tests/test_persist_recovery.py's crash matrix runs on the port's
`PersistenceManager`: a crash at each WAL fail point (`walBeforeAppend`,
`walAfterAppend`) armed at two points of a write stream, and at each
checkpoint fail point (`checkpointBeforeRename`,
`manifestBeforeRename`); every restart recovers exactly a prefix of the
uninterrupted host oracle's stream, and the same crash in the
reference's package recovers the same revision and read-set.  Then the
device side: `torch://?device=cpu` warm-started (with the prewarm) on
the store recovered after a crash answers every check and lookup as
`jax://` recovered from the same stream and as the oracle.  Last, the
dual-write idempotency key that lets a replayed activity detect an
already-applied write after a crash, and expirations written before a
crash firing after the restart — through the decision cache's heap and
through the `torch://` graph's.
"""

import asyncio
import importlib
import json
import os
import tempfile

import pytest

from test_persist_recovery import BOOT, SCHEMA, stream_batch

WAL_FAILPOINTS = ["walBeforeAppend", "walAfterAppend"]
CKPT_FAILPOINTS = ["checkpointBeforeRename", "manifestBeforeRename"]


class RPkg:
    def __init__(self, root: str):
        def mod(name):
            return importlib.import_module(f"{root}.{name}")
        self.root = root
        self.persist = mod("spicedb.persist")
        self.store = mod("spicedb.store")
        self.types = mod("spicedb.types")
        self.schema = mod("spicedb.schema")
        self.endpoints = mod("spicedb.endpoints")
        self.decision_cache = mod("spicedb.decision_cache")
        self.failpoints = mod("utils.failpoints")
        self.kubefake = mod("kubefake.apiserver")
        self.httpcore = mod("proxy.httpcore")
        self.client = mod("authz.distributedtx.client")
        self.workflow = mod("authz.distributedtx.workflow")

    def batch(self, i):
        """The reference test's batch i, in this package's types."""
        t = self.types
        return [t.RelationshipUpdate(
            t.UpdateOp[u.op.name], t.parse_relationship(u.rel.rel_string()))
            for u in stream_batch(i)]

    def oracle_at(self, revision):
        store = self.store.TupleStore()
        store.bulk_load_text(BOOT)
        for i in range(1, revision):
            store.write(self.batch(i))
        assert store.revision == revision
        return store


REF = RPkg("spicedb_kubeapi_proxy_tpu")
PORT = RPkg("spicedb_kubeapi_proxy_tpu_torch")
BOTH = [PORT, REF]


@pytest.fixture(autouse=True)
def reset_failpoints():
    for P in BOTH:
        P.failpoints.disable_all()
    yield
    for P in BOTH:
        P.failpoints.disable_all()


@pytest.fixture()
def tmpdir():
    with tempfile.TemporaryDirectory() as d:
        yield d


def rels_of(store):
    return sorted(r.rel_string() for r in store.read(None))


def crash_mid_stream(P, d, failpoint, arm_at, n=13):
    """Journal BOOT then batches 1.. with `failpoint` armed before batch
    `arm_at`; returns the batch index that crashed (None if none did)."""
    mgr = P.persist.PersistenceManager(d, fsync="always")
    store = mgr.recover()
    mgr.attach(store)
    store.bulk_load_text(BOOT)
    for i in range(1, n):
        if i == arm_at:
            P.failpoints.enable_failpoint(failpoint, 1)
        try:
            store.write(P.batch(i))
        except P.failpoints.FailPointPanic:
            P.failpoints.disable_all()
            return i
    P.failpoints.disable_all()
    return None


@pytest.mark.parametrize("failpoint", WAL_FAILPOINTS)
@pytest.mark.parametrize("arm_at", [3, 9])
def test_crash_mid_write_stream(tmpdir, failpoint, arm_at):
    got = []
    for P in BOTH:
        d = os.path.join(tmpdir, P.root)
        assert crash_mid_stream(P, d, failpoint, arm_at) == arm_at
        s2 = P.persist.PersistenceManager(d).recover()
        # before the append nothing of the crashed batch is on disk;
        # after it the whole record is, and replays
        want_rev = arm_at + (failpoint == "walAfterAppend")
        assert s2.revision == want_rev
        assert rels_of(s2) == rels_of(P.oracle_at(s2.revision))
        got.append((s2.revision, rels_of(s2)))
    assert got[0] == got[1]


@pytest.mark.parametrize("failpoint", CKPT_FAILPOINTS)
def test_crash_mid_checkpoint_loses_nothing(tmpdir, failpoint):
    got = []
    for P in BOTH:
        d = os.path.join(tmpdir, P.root)
        mgr = P.persist.PersistenceManager(d, fsync="always")
        store = mgr.recover()
        mgr.attach(store)
        store.bulk_load_text(BOOT)
        for i in range(1, 6):
            store.write(P.batch(i))
        P.failpoints.enable_failpoint(failpoint, 1)
        with pytest.raises(P.failpoints.FailPointPanic):
            mgr.checkpoint()
        P.failpoints.disable_all()
        mgr2 = P.persist.PersistenceManager(d)
        s2 = mgr2.recover()
        assert s2.revision == store.revision
        assert rels_of(s2) == rels_of(P.oracle_at(s2.revision))
        got.append((s2.revision, rels_of(s2),
                    mgr2.recovery_info["checkpoint_revision"]))
    assert got[0] == got[1]


def _recovered_after_crash(P, d):
    crash_mid_stream(P, d, "walAfterAppend", 5, n=8)
    return P.persist.PersistenceManager(d).recover()


@pytest.mark.parametrize("prewarm", [False, True])
def test_recovered_torch_answers_match_jax_and_oracle(tmpdir, prewarm):
    """After a crash and a restart, `torch://?device=cpu` warm-started on
    the recovered store (one rebuild, none lazily at the first query)
    answers every check and lookup as `jax://` on the reference's
    recovery of the same crash and as the oracle, at the recovered
    revision."""
    from spicedb_kubeapi_proxy_tpu.ops.jax_endpoint import JaxEndpoint
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        TorchEndpoint)

    s_port = _recovered_after_crash(PORT, os.path.join(tmpdir, "p"))
    s_ref = _recovered_after_crash(REF, os.path.join(tmpdir, "r"))
    assert (s_port.revision, rels_of(s_port)) == \
        (s_ref.revision, rels_of(s_ref))

    def schema(P):
        return P.endpoints.merge_internal_definitions(
            P.schema.parse_schema(SCHEMA))

    torch_ep = TorchEndpoint(schema(PORT), store=s_port, device="cpu")
    torch_ep.warm_start(prewarm=prewarm)
    assert torch_ep.stats["rebuilds"] == 1
    jax_ep = JaxEndpoint(schema(REF), store=s_ref)
    jax_ep.warm_start()
    oracle_ep = PORT.endpoints.EmbeddedEndpoint(
        schema(PORT), store=PORT.oracle_at(s_port.revision))

    async def answers(P, ep):
        t = P.types
        subjects = [t.SubjectRef("user", f"u{k}") for k in range(5)]
        reqs = [t.CheckRequest(t.ObjectRef("doc", f"d{n}"), "view", s)
                for n in range(0, 50, 3) for s in subjects]
        checks = await ep.check_bulk_permissions(reqs)
        lookups = [sorted(await ep.lookup_resources("doc", "view", s))
                   for s in subjects]
        return ([(c.permissionship.name, c.checked_at) for c in checks],
                lookups)

    got = asyncio.run(answers(PORT, torch_ep))
    assert got == asyncio.run(answers(REF, jax_ep))
    o_checks, o_lookups = asyncio.run(answers(PORT, oracle_ep))
    assert [p for p, _ in got[0]] == [p for p, _ in o_checks]
    assert got[1] == o_lookups
    assert {rev for _, rev in got[0]} == {s_port.revision}
    assert torch_ep.stats["rebuilds"] == 1


def _write_input():
    return {
        "verb": "create", "request_uri": "/api/v1/namespaces",
        "request_path": "/api/v1/namespaces", "request_name": "",
        "api_group": "", "resource": "namespaces", "headers": {},
        "user_name": "alice", "object_name": "revived",
        "body": json.dumps({"metadata": {"name": "revived"}}),
        "probe_uri": "/api/v1/namespaces/revived",
        "creates": ["namespace:revived#creator@user:alice"],
        "touches": [], "deletes": [], "preconditions": [],
        "delete_by_filter": [],
    }


def _dual_write_crash_and_restart(P, tmpdir, url):
    """The reference test's crash inside `write_to_spicedb` (the write
    and its idempotency key committed and journaled, the activity's
    completion not), then a restart whose pending instance replays
    against the recovered store."""
    kube = P.kubefake.FakeKubeApiServer()
    db = os.path.join(tmpdir, "dtx.sqlite")
    data_dir = os.path.join(tmpdir, "store")
    boot = P.endpoints.Bootstrap()
    write_input = _write_input()

    async def crashed_process():
        mgr = P.persist.PersistenceManager(data_dir, fsync="always")
        store = mgr.recover()
        mgr.attach(store)
        ep = P.endpoints.create_endpoint(url, bootstrap=boot, store=store)
        engine, _ = P.client.setup_workflow_engine(
            ep, P.httpcore.HandlerTransport(kube), db)
        engine.journal.create_instance(
            "inst-1", P.workflow.STRATEGY_PESSIMISTIC, write_input)
        lock_rel, lock_pre = P.workflow._lock_update(write_input, "inst-1")
        handler_fn = engine._activities["write_to_spicedb"]
        P.failpoints.enable_failpoint("panicSpiceDBWriteResp", 1)
        with pytest.raises(P.failpoints.FailPointPanic):
            await handler_fn(
                {"updates": P.workflow._collect_updates(write_input)
                 + [lock_rel], "preconditions": [lock_pre]}, "inst-1")
        P.failpoints.disable_all()
        assert "namespace:revived#creator@user:alice" in rels_of(store)
    asyncio.run(crashed_process())

    async def restarted_process():
        mgr = P.persist.PersistenceManager(data_dir, fsync="always")
        store = mgr.recover()
        assert mgr.recovery_info["idempotency_keys"] == 1
        mgr.attach(store)
        ep = P.endpoints.create_endpoint(url, bootstrap=boot, store=store)
        engine, _ = P.client.setup_workflow_engine(
            ep, P.httpcore.HandlerTransport(kube), db)
        assert await engine.run_pending_once() == 1
        rec = engine.journal.get_instance("inst-1")
        assert rec.status == "completed", rec.error
        assert rec.result["status_code"] == 201
        assert "revived" in kube.objects[("", "v1", "namespaces")][""]
        rels = [r.rel_string() for r in store.read(None)]
        assert rels.count("namespace:revived#creator@user:alice") == 1
        assert not any(r.startswith("lock:") for r in rels)
        assert await engine.run_pending_once() == 0
        return (rec.status, rec.result["status_code"],
                sorted(r for r in rels if not r.startswith("workflow:")),
                sum(r.startswith("workflow:") for r in rels),
                mgr.recovery_info["idempotency_keys"])
    return asyncio.run(restarted_process())


@pytest.mark.parametrize("url", ["embedded://", "torch://?device=cpu"])
def test_replayed_activity_detects_applied_write(tmpdir, url):
    got = _dual_write_crash_and_restart(PORT, os.path.join(tmpdir, "p"), url)
    want = _dual_write_crash_and_restart(REF, os.path.join(tmpdir, "r"),
                                         "embedded://")
    assert got == want


def test_pre_crash_expiration_fires_after_recovery(tmpdir):
    """An expiring tuple written before the crash expires on time after
    the restart: the recovered store's expiry_schedule() seeds the
    decision cache's heap, whose invalidation fires at the instant."""
    P = PORT
    clk = [1000.0]
    mgr = P.persist.PersistenceManager(tmpdir, fsync="always",
                                       clock=lambda: clk[0])
    store = mgr.recover()
    mgr.attach(store)
    store.bulk_load_text("doc:keep#viewer@user:u1")
    store.write([P.types.RelationshipUpdate(
        P.types.UpdateOp.TOUCH, P.types.parse_relationship(
            "doc:fleeting#viewer@user:u1[expiration:1500]"))])
    s2 = P.persist.PersistenceManager(tmpdir, clock=lambda: clk[0]).recover()
    assert list(s2.expiry_schedule()) == [(1500.0, ("doc", "viewer"))]
    ep = P.decision_cache.DecisionCacheEndpoint(P.endpoints.EmbeddedEndpoint(
        P.endpoints.merge_internal_definitions(
            P.schema.parse_schema(SCHEMA)), store=s2))

    async def go():
        subject = P.types.SubjectRef("user", "u1")
        got = sorted(await ep.lookup_resources("doc", "view", subject))
        assert got == ["fleeting", "keep"]
        assert sorted(await ep.lookup_resources(
            "doc", "view", subject)) == got
        assert ep.cache.stats["hits"] >= 1
        clk[0] = 1600.0
        assert sorted(await ep.lookup_resources(
            "doc", "view", subject)) == ["keep"]
        assert ep.cache.stats["invalidations"] >= 1
    asyncio.run(go())


@pytest.mark.parametrize("via_checkpoint", [False, True])
def test_expiry_survives_restart_on_the_device_graph(tmpdir, via_checkpoint):
    """The same on `torch://?device=cpu`: recovered from the WAL alone or
    from a checkpoint, the warm-started graph's expiry heap (reseeded
    from the recovered store) drops the tuple at its instant, as
    `jax://` does on the reference's recovery."""
    from spicedb_kubeapi_proxy_tpu.ops.jax_endpoint import JaxEndpoint
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        TorchEndpoint)

    def run(P, d, make_ep):
        clk = [1000.0]
        mgr = P.persist.PersistenceManager(d, fsync="never",
                                           clock=lambda: clk[0])
        store = mgr.recover()
        mgr.attach(store)
        store.bulk_load_text("doc:keep#viewer@user:u1\n"
                             "doc:fleeting#viewer@user:u1[expiration:1500]")
        store.write([P.types.RelationshipUpdate(
            P.types.UpdateOp.TOUCH, P.types.parse_relationship(
                "doc:brief#viewer@user:u1[expiration:1200]"))])
        if via_checkpoint:
            mgr.checkpoint()
        s2 = P.persist.PersistenceManager(d, clock=lambda: clk[0]).recover()
        ep = make_ep(P.endpoints.merge_internal_definitions(
            P.schema.parse_schema(SCHEMA)), s2)
        ep.warm_start()
        subject = P.types.SubjectRef("user", "u1")
        out = []
        for now in (1000.0, 1300.0, 1600.0):
            clk[0] = now
            out.append(sorted(asyncio.run(
                ep.lookup_resources("doc", "view", subject))))
        return out

    got = run(PORT, os.path.join(tmpdir, "p"),
              lambda s, st: TorchEndpoint(s, store=st, device="cpu"))
    want = run(REF, os.path.join(tmpdir, "r"),
               lambda s, st: JaxEndpoint(s, store=st))
    assert got == want == [["brief", "fleeting", "keep"],
                           ["fleeting", "keep"], ["keep"]]
