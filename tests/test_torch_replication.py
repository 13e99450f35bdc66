"""The port's WAL-shipping replication held against the reference's.

Every scenario of tests/test_replication.py (the parity referee under
churn, a late follower bootstrapping from a checkpoint plus the tail,
readiness before the first adoption, a reclaimed segment forcing a
re-bootstrap, a leader restart mid-tail, the min-revision wait, forward
and 503 paths, write forwarding and rejection, a leader outage, replica
lag shedding, the switch-off tripwire, the replication API's auth and
safe names, the manifest long-poll and the follower's watch stream) runs
on the port's `ProxyServer` over `embedded://` and
`torch://?device=cpu`, and on the reference's over `embedded://` (what
its test runs).  Each scenario holds the reference test's assertions on
both packages and returns its observations — statuses, listed names,
revision stamps, forwarding headers, follower counters — which must be
equal between them.  So must the passes of a follower with each
replication fail point armed once, in a bootstrap and in a tail pass.

Across packages: a port follower tails a reference leader and a
reference follower tails a port leader (the data dir, the manifest and
the segment bytes are one format); after each batch of writes the port
follower on `torch://?device=cpu` and a reference follower on `jax://`
of the same leader answer every list equally.  Last, the reference's
replica expiry seams (`apply_replica_batch` and `replica_reset` feeding
the decision cache's and the device graph's expiry heaps) on the port's
cache and on `TorchEndpoint(device="cpu")`.
"""

import asyncio
import importlib
import json
import shutil
import tempfile

import pytest

from test_replication import EXPIRY_SCHEMA, N_NS, RULES, SCHEMA

PORT_URLS = ["embedded://", "torch://?device=cpu"]


class RPkg:
    """The modules of one package that a replication scenario needs."""

    def __init__(self, root: str):
        def mod(name):
            return importlib.import_module(f"{root}.{name}")
        self.root = root
        self.kubefake = mod("kubefake.apiserver")
        self.httpcore = mod("proxy.httpcore")
        self.server = mod("proxy.server")
        self.endpoints = mod("spicedb.endpoints")
        self.types = mod("spicedb.types")
        self.store = mod("spicedb.store")
        self.schema = mod("spicedb.schema")
        self.decision_cache = mod("spicedb.decision_cache")
        self.wal = mod("spicedb.persist.wal")
        self.repl = mod("spicedb.replication")
        self.features = mod("utils.features")

    def set_replication(self, on: bool) -> None:
        if self.root.endswith("_torch"):
            self.features.REPLICATION = on
        else:
            self.features.GATES.set("Replication", on)

    def touch(self, s):
        t = self.types
        return t.RelationshipUpdate(t.UpdateOp.TOUCH, t.parse_relationship(s))

    def delete(self, s):
        t = self.types
        return t.RelationshipUpdate(t.UpdateOp.DELETE,
                                    t.parse_relationship(s))


REF = RPkg("spicedb_kubeapi_proxy_tpu")
PORT = RPkg("spicedb_kubeapi_proxy_tpu_torch")


@pytest.fixture(autouse=True)
def reset_switches():
    yield
    PORT.features.REPLICATION = True
    REF.features.GATES.reset()


@pytest.fixture
def tmp():
    d = tempfile.mkdtemp(prefix="torch-repl-test-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


class LeaderLink:
    """In-process leader transport resolving the proxy's CURRENT handler
    on every call (enable_dual_writes rebuilds the chain), swappable to a
    new incarnation for the leader-restart scenario."""

    def __init__(self, proxy):
        self.proxy = proxy

    async def round_trip(self, req):
        return await self.proxy.handler(req)

    def set_leader(self, proxy):
        self.proxy = proxy


class CrossLink:
    """A follower of one package talking to a leader of the other: the
    request and response are rebuilt in each package's own types, as an
    HTTP hop would carry them."""

    def __init__(self, proxy, follower_pkg, leader_pkg):
        self.proxy = proxy
        self.fpkg, self.lpkg = follower_pkg, leader_pkg

    async def round_trip(self, req):
        lh = self.lpkg.httpcore
        lreq = lh.Request(method=req.method, target=req.target,
                          headers=lh.Headers(list(req.headers.items())),
                          body=req.body)
        resp = await self.proxy.handler(lreq)
        fh = self.fpkg.httpcore
        return fh.Response(status=resp.status,
                           headers=fh.Headers(list(resp.headers.items())),
                           body=resp.body)


def make_leader(P, url, tmp, seed_ns=True, **opt_kw):
    kube = P.kubefake.FakeKubeApiServer()
    for i in range(N_NS):
        kube.seed("", "v1", "namespaces", {"metadata": {"name": f"ns{i}"}})
    leader = P.server.ProxyServer(P.server.Options(
        spicedb_endpoint=url,
        bootstrap=P.endpoints.Bootstrap(schema_text=SCHEMA),
        rules_yaml=RULES,
        upstream_transport=P.httpcore.HandlerTransport(kube),
        data_dir=tmp, wal_fsync="never", **opt_kw))
    if seed_ns:
        leader.endpoint.store.bulk_load([
            P.types.parse_relationship(
                f"namespace:ns{i}#creator@user:alice")
            for i in range(0, N_NS, 2)])
    return leader, kube


def make_follower(P, url, leader, kube=None, transport=None, **opt_kw):
    transport = transport or LeaderLink(leader)
    follower = P.server.ProxyServer(P.server.Options(
        spicedb_endpoint=url,
        bootstrap=P.endpoints.Bootstrap(schema_text=SCHEMA),
        rules_yaml=RULES,
        upstream_transport=P.httpcore.HandlerTransport(
            kube or P.kubefake.FakeKubeApiServer()),
        replicate_from="http://leader.test",
        leader_transport=transport, **opt_kw))
    return follower, transport


def churn(P, leader, i):
    rel = f"namespace:ns{i % N_NS}#viewer@user:u{i % 5}"
    up = P.delete(rel) if i % 3 == 2 else P.touch(rel)
    return leader.endpoint.write_relationships([up])


async def list_ns(proxy, user, headers=None):
    client = proxy.get_embedded_client(user)
    resp = await client.get("/api/v1/namespaces", headers=headers or [])
    return resp, (sorted(i["metadata"]["name"]
                         for i in json.loads(resp.body).get("items", []))
                  if resp.status == 200 else None)


# -- the reference's scenarios: async fn(P, url, tmp) -> observations -----

async def sc_parity_referee_under_churn(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    follower, _ = make_follower(P, url, leader, kube)
    repl = follower.replication
    users = ["alice", "u0", "u1", "u2", "u3", "u4", "nobody"]
    obs = []
    await repl.sync_once()
    for round_i in range(8):
        for j in range(5):
            await churn(P, leader, round_i * 5 + j)
        pinned = leader.endpoint.store.revision
        await repl.sync_once()
        assert repl.store.revision == pinned
        for user in users:
            lr, l_items = await list_ns(leader, user)
            fr, f_items = await list_ns(follower, user)
            assert lr.status == fr.status == 200
            assert f_items == l_items, (pinned, user, f_items, l_items)
            stamp = int(fr.headers.get(P.repl.REVISION_HEADER))
            assert stamp == pinned
            obs.append((pinned, user, f_items, stamp))
    return obs


async def sc_bootstrap_from_checkpoint_plus_tail(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    for i in range(6):
        await churn(P, leader, i)
    leader.persistence.checkpoint()
    for i in range(6, 10):
        await churn(P, leader, i)
    follower, _ = make_follower(P, url, leader, kube)
    repl = follower.replication
    await repl.sync_once()
    assert repl.store.revision == leader.endpoint.store.revision
    assert repl.bootstrapped
    _, l_items = await list_ns(leader, "u1")
    _, f_items = await list_ns(follower, "u1")
    assert f_items == l_items
    resp = await follower.get_embedded_client("alice").get("/readyz")
    assert resp.status == 200
    return [repl.store.revision, f_items, resp.status,
            repl.stats["applied_records"], repl.stats["bootstraps"]]


async def sc_readyz_not_ready_before_bootstrap(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    follower, _ = make_follower(P, url, leader, kube)
    client = follower.get_embedded_client("alice")
    before = await client.get("/readyz")
    assert before.status == 503 and b"bootstrapping" in before.body
    await follower.replication.sync_once()
    after = await client.get("/readyz")
    assert after.status == 200
    return [before.status, before.body, after.status, after.body]


async def sc_reclaimed_segment_triggers_rebootstrap(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    follower, _ = make_follower(P, url, leader, kube)
    repl = follower.replication
    await repl.sync_once()
    for i in range(10):
        await churn(P, leader, i)
    leader.persistence.checkpoint()
    for i in range(10, 14):
        await churn(P, leader, i)
    await repl.sync_once()
    assert repl.stats["rebootstraps"] == 1
    assert repl.store.revision == leader.endpoint.store.revision
    _, l_items = await list_ns(leader, "u2")
    _, f_items = await list_ns(follower, "u2")
    assert f_items == l_items
    assert repl.ever_bootstrapped
    repl.bootstrapped = False  # as during an in-flight re-bootstrap
    resp = await follower.get_embedded_client("x").get("/readyz")
    assert resp.status == 200 and b"re-bootstrapping" in resp.body
    repl.bootstrapped = True
    return [repl.store.revision, f_items, resp.body,
            repl.stats["rebootstraps"], repl.stats["bootstraps"]]


async def sc_leader_restart_mid_tail(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    follower, transport = make_follower(P, url, leader, kube)
    repl = follower.replication
    for i in range(7):
        await churn(P, leader, i)
    await repl.sync_once()
    await leader.persistence.stop()
    leader2, _ = make_leader(P, url, tmp, seed_ns=False)
    transport.set_leader(leader2)
    for i in range(7, 12):
        await churn(P, leader2, i)
    await repl.sync_once()
    assert repl.store.revision == leader2.endpoint.store.revision
    _, l_items = await list_ns(leader2, "u1")
    _, f_items = await list_ns(follower, "u1")
    assert f_items == l_items
    return [repl.store.revision, f_items, repl.stats["rebootstraps"],
            leader2.replication_hub.incarnation]


async def sc_zedtoken_wait_path(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    follower, _ = make_follower(P, url, leader, kube)
    repl = follower.replication
    await repl.sync_once()
    rev = await leader.endpoint.write_relationships([
        P.touch("namespace:ns1#viewer@user:zed")])

    async def late_sync():
        await asyncio.sleep(0.05)
        await repl.sync_once()

    sync_task = asyncio.ensure_future(late_sync())
    resp, items = await list_ns(
        follower, "zed", headers=[(P.repl.MIN_REVISION_HEADER, str(rev))])
    await sync_task
    assert resp.status == 200
    assert resp.headers.get("X-Authz-Forwarded-To") == ""
    assert items == ["ns1"]
    assert int(resp.headers.get(P.repl.REVISION_HEADER)) >= rev
    return [rev, resp.status, items]


async def sc_zedtoken_forward_and_503_paths(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    follower, _ = make_follower(P, url, leader, kube, replica_wait_ms=30.0)
    await follower.replication.sync_once()
    rev = await leader.endpoint.write_relationships([
        P.touch("namespace:ns3#viewer@user:zed2")])
    resp, items = await list_ns(
        follower, "zed2", headers=[(P.repl.MIN_REVISION_HEADER, str(rev))])
    assert resp.status == 200
    assert resp.headers.get("X-Authz-Forwarded-To") == "leader"
    assert items == ["ns3"]
    obs = [rev, items, resp.headers.get("X-Authz-Forwarded-To"),
           follower.replication.stats.get("forwarded")]
    f2, _ = make_follower(P, url, leader, kube, replica_wait_ms=30.0,
                          replica_forward=False)
    await f2.replication.sync_once()
    rev2 = await leader.endpoint.write_relationships([
        P.touch("namespace:ns4#viewer@user:zed2")])
    resp, _ = await list_ns(
        f2, "zed2", headers=[(P.repl.MIN_REVISION_HEADER, str(rev2))])
    assert resp.status == 503
    body = json.loads(resp.body)
    assert body["reason"] == "ServiceUnavailable"
    assert body["details"]["leader"] == "http://leader.test"
    obs.append([resp.status, body["reason"], body["details"]["leader"]])
    resp, _ = await list_ns(
        follower, "zed2", headers=[(P.repl.MIN_REVISION_HEADER, "banana")])
    assert resp.status == 400
    obs.append([resp.status, json.loads(resp.body)["message"]])
    return obs


async def sc_follower_write_forwarding_and_rejection(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    follower, _ = make_follower(P, url, leader, kube)
    repl = follower.replication
    await repl.sync_once()
    leader.enable_dual_writes()
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": "p1", "namespace": "ns0"}}
    resp = await follower.get_embedded_client("alice").post(
        "/api/v1/namespaces/ns0/pods", pod)
    assert resp.status in (200, 201), resp.body
    assert resp.headers.get("X-Authz-Forwarded-To") == "leader"
    rel = P.types.parse_relationship("pod:ns0/p1#creator@user:alice")
    assert leader.endpoint.store.has_exact(rel)
    await repl.sync_once()
    assert follower.replication.store.has_exact(rel)
    obs = [resp.status, resp.headers.get("X-Authz-Forwarded-To"),
           repl.store.revision]
    f2, _ = make_follower(P, url, leader, kube, replica_forward=False)
    await f2.replication.sync_once()
    resp = await f2.get_embedded_client("alice").post(
        "/api/v1/namespaces/ns0/pods", dict(
            pod, metadata={"name": "p2", "namespace": "ns0"}))
    assert resp.status == 503
    assert json.loads(resp.body)["details"]["leader"] == "http://leader.test"
    obs.append([resp.status, json.loads(resp.body)["message"]])
    return obs


async def sc_leader_outage_degrades_but_serves(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    follower, _ = make_follower(P, url, leader, kube)
    repl = follower.replication

    class DeadTransport:
        async def round_trip(self, req):
            raise ConnectionError("leader is gone")

    for i in range(4):
        await churn(P, leader, i)
    await repl.sync_once()
    pinned = repl.store.revision
    _, before = await list_ns(follower, "u1")
    follower._leader_transport = DeadTransport()
    repl.transport = follower._leader_transport
    with pytest.raises(Exception):
        await repl.sync_once()
    repl.state = "degraded"  # run() would set this; sync_once raises
    resp, after = await list_ns(follower, "u1")
    assert resp.status == 200 and after == before
    assert int(resp.headers.get(P.repl.REVISION_HEADER)) == pinned
    ready = await follower.get_embedded_client("x").get("/readyz")
    assert ready.status == 200 and b"degraded" in ready.body
    resp2 = await follower.get_embedded_client("alice").post(
        "/api/v1/namespaces/ns0/pods",
        {"metadata": {"name": "px", "namespace": "ns0"}})
    assert resp2.status == 503
    return [pinned, after, ready.body, resp2.status,
            json.loads(resp2.body)["message"]]


async def sc_replica_lag_shedding(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    follower, _ = make_follower(P, url, leader, kube,
                                shed_replica_lag_s=0.05)
    repl = follower.replication
    await repl.sync_once()
    resp, _ = await list_ns(follower, "u1")
    assert resp.status == 200
    await churn(P, leader, 0)
    await repl._fetch_manifest(wait=False)
    repl._caught_up_at -= 10.0  # stale for "10 seconds"
    assert repl.lag_seconds() > 0.05
    shed, _ = await list_ns(follower, "u1")
    assert shed.status == 429
    assert "replica_lag" in json.loads(shed.body)["message"]
    return [resp.status, shed.status, json.loads(shed.body)["message"],
            repl.lag_revisions()]


async def sc_gate_off_is_single_node_exactly(P, url, tmp):
    P.set_replication(False)
    leader, kube = make_leader(P, url, tmp)
    follower, _ = make_follower(P, url, leader, kube)
    assert follower.replication is None
    assert leader.replication_hub is None
    resp = await leader.get_embedded_client("alice").get(
        "/replication/manifest")
    assert resp.status == 503
    lresp, l_items = await list_ns(leader, "alice")
    assert lresp.status == 200
    assert lresp.headers.get(P.repl.REVISION_HEADER) == ""
    fresp, f_items = await list_ns(follower, "alice")
    assert fresp.status == 200 and f_items == []
    return [resp.status, l_items, f_items,
            lresp.headers.get(P.repl.REVISION_HEADER)]


async def sc_replication_api_requires_auth_and_safe_names(P, url, tmp):
    leader, _ = make_leader(P, url, tmp)
    obs = []
    anon = leader.get_embedded_client("")
    resp = await anon.get("/replication/manifest")
    assert resp.status == 401
    obs.append(resp.status)
    client = leader.get_embedded_client("alice")
    for name in ("../MANIFEST.json", "..%2fMANIFEST.json",
                 "seg-1.wal", "ckpt-1.npz", "etc/passwd"):
        resp = await client.get(f"/replication/segment/{name}")
        assert resp.status == 400, name
        obs.append(resp.status)
    man = json.loads((await client.get("/replication/manifest")).body)
    assert man["revision"] == leader.endpoint.store.revision
    assert man["segments"], "live segment should be listed"
    obs.append([man["revision"], [(s["name"], s["sealed"])
                                  for s in man["segments"]],
                man["checkpoint"], man["sidecars"]])
    return obs


async def sc_longpoll_manifest_wakes_on_commit(P, url, tmp):
    leader, _ = make_leader(P, url, tmp)
    hub = leader.replication_hub
    rev = leader.endpoint.store.revision

    async def poke():
        await asyncio.sleep(0.05)
        await churn(P, leader, 99)

    task = asyncio.ensure_future(poke())
    ok = await hub.wait_for_revision(rev, timeout_s=5.0)
    await task
    assert ok and leader.endpoint.store.revision > rev
    assert await hub.wait_for_revision(rev, timeout_s=0.0)
    return [rev, ok, leader.endpoint.store.revision]


async def sc_follower_drives_watch_and_delta_pipeline(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    follower, _ = make_follower(P, url, leader, kube)
    repl = follower.replication
    await repl.sync_once()
    watcher = follower.replication.store.subscribe(["namespace"])
    rel = "namespace:ns7#viewer@user:watched"
    await leader.endpoint.write_relationships([P.touch(rel)])
    await repl.sync_once()
    upd = await watcher.next(timeout=2.0)
    assert upd is not None
    assert [u.rel.rel_string() for u in upd.updates] == [rel]
    assert upd.revision == repl.store.revision
    watcher.close()
    _, items = await list_ns(follower, "watched")
    return [upd.revision, [u.rel.rel_string() for u in upd.updates], items]


SCENARIOS = {
    "parity_referee_under_churn": sc_parity_referee_under_churn,
    "bootstrap_from_checkpoint_plus_tail":
        sc_bootstrap_from_checkpoint_plus_tail,
    "readyz_not_ready_before_bootstrap": sc_readyz_not_ready_before_bootstrap,
    "reclaimed_segment_triggers_rebootstrap":
        sc_reclaimed_segment_triggers_rebootstrap,
    "leader_restart_mid_tail": sc_leader_restart_mid_tail,
    "zedtoken_wait_path": sc_zedtoken_wait_path,
    "zedtoken_forward_and_503_paths": sc_zedtoken_forward_and_503_paths,
    "follower_write_forwarding_and_rejection":
        sc_follower_write_forwarding_and_rejection,
    "leader_outage_degrades_but_serves": sc_leader_outage_degrades_but_serves,
    "replica_lag_shedding": sc_replica_lag_shedding,
    "gate_off_is_single_node_exactly": sc_gate_off_is_single_node_exactly,
    "replication_api_requires_auth_and_safe_names":
        sc_replication_api_requires_auth_and_safe_names,
    "longpoll_manifest_wakes_on_commit": sc_longpoll_manifest_wakes_on_commit,
    "follower_drives_watch_and_delta_pipeline":
        sc_follower_drives_watch_and_delta_pipeline,
}

_REF_OBS: dict = {}


def ref_obs(name):
    """The reference's observations of a scenario, computed once."""
    if name not in _REF_OBS:
        d = tempfile.mkdtemp(prefix="ref-repl-test-")
        try:
            _REF_OBS[name] = asyncio.run(
                SCENARIOS[name](REF, "embedded://", d))
        finally:
            REF.features.GATES.reset()
            shutil.rmtree(d, ignore_errors=True)
    return _REF_OBS[name]


@pytest.mark.parametrize("url", PORT_URLS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_the_reference(name, url, tmp):
    got = asyncio.run(SCENARIOS[name](PORT, url, tmp))
    assert got == ref_obs(name)


REPL_FAILPOINTS = ["replLeaderLink", "replManifestPoll", "replSegmentFetch",
                   "replCheckpointFetch", "replBootstrapAdopt",
                   "replBootstrapFinish", "replServeManifest",
                   "replServeSegment"]


async def sc_failpoint_pass(P, url, tmp, failpoint):
    """A sync pass that crashes at `failpoint` (a follower-side panic, or
    a leader route answering 500), then one that catches up."""
    fp = importlib.import_module(f"{P.root}.utils.failpoints")
    leader, kube = make_leader(P, url, tmp)
    follower, _ = make_follower(P, url, leader, kube)
    repl = follower.replication
    obs = []
    for stage in ("bootstrap", "tail"):
        for i in range(4):
            await churn(P, leader, i + (10 if stage == "tail" else 0))
        leader.persistence.checkpoint()
        await churn(P, leader, 20 if stage == "tail" else 21)
        before = (repl.store.revision, repl.bootstrapped)
        fp.enable_failpoint(failpoint, 1)
        try:
            await repl.sync_once()
            failed = ""
        except Exception as e:
            failed = type(e).__name__
        finally:
            fp.disable_all()
        mid = (repl.store.revision, repl.bootstrapped)
        await repl.sync_once()
        assert repl.store.revision == leader.endpoint.store.revision
        _, l_items = await list_ns(leader, "u1")
        _, f_items = await list_ns(follower, "u1")
        assert f_items == l_items
        obs.append([stage, failed, before, mid, repl.store.revision,
                    f_items])
    return obs


@pytest.mark.parametrize("failpoint", REPL_FAILPOINTS)
def test_replication_failpoint_leaves_state_and_recovers(failpoint, tmp):
    """Each replication fail point armed once, during the bootstrap pass
    and during a tail pass past a reclaimed segment: the failed pass
    leaves the follower at a revision it adopted whole (its old one, or
    the checkpoint's when the crash comes after the adoption), the next
    pass reaches the leader, and the reference does the same."""
    got = asyncio.run(sc_failpoint_pass(PORT, "torch://?device=cpu", tmp,
                                        failpoint))
    d = tempfile.mkdtemp(prefix="ref-repl-fp-")
    try:
        want = asyncio.run(sc_failpoint_pass(REF, "embedded://", d,
                                             failpoint))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    assert got == want
    fired = [o[1] for o in got]
    assert any(fired), f"{failpoint} never fired"


def test_parse_frames_torn_and_damaged():
    """The shared frame decoder tolerates a torn tail and refuses a
    damaged mid-stream frame, as the reference's does on the same
    bytes."""
    import struct
    import zlib

    def frame(rec):
        payload = json.dumps(rec).encode()
        return struct.pack("<II", len(payload),
                           zlib.crc32(payload)) + payload

    a, b = frame({"k": "d", "r": 1}), frame({"k": "d", "r": 2})
    bad = bytearray(a)
    bad[-1] ^= 0xFF
    for P in (PORT, REF):
        recs, consumed = P.wal.parse_frames(a + b)
        assert [r["r"] for r in recs] == [1, 2] and consumed == len(a + b)
        recs, consumed = P.wal.parse_frames(a + b[:-3])
        assert [r["r"] for r in recs] == [1] and consumed == len(a)
        with pytest.raises(P.wal.TornFrameError):
            P.wal.parse_frames(bytes(bad) + b)
        magic = P.wal.SEGMENT_MAGIC
        recs, consumed = P.wal.parse_frames(magic + a, len(magic))
        assert [r["r"] for r in recs] == [1]
        assert consumed == len(magic) + len(a)
    assert PORT.wal.SEGMENT_MAGIC == REF.wal.SEGMENT_MAGIC


# -- across packages --------------------------------------------------------

FOLLOWER_USERS = ["alice", "u0", "u1", "u2", "u3", "u4", "nobody"]


@pytest.mark.parametrize("leader_pkg", ["reference", "port"])
def test_followers_of_both_packages_tail_one_leader(leader_pkg, tmp):
    """One leader (the reference's over `embedded://`, or the port's
    over `torch://?device=cpu`) and two followers of it: the port's on
    `torch://?device=cpu` and the reference's on `jax://`.  After the
    bootstrap and after each of 6 batches of churn (a checkpoint after
    the third, so one batch arrives past a reclaimed tail), both
    followers sit at the leader's revision and list for every user what
    the leader lists; the reclaimed tail made each re-bootstrap once."""
    L = REF if leader_pkg == "reference" else PORT
    url = "embedded://" if L is REF else "torch://?device=cpu"
    leader, kube = make_leader(L, url, tmp)
    followers = []
    for F, furl in ((PORT, "torch://?device=cpu"), (REF, "jax://")):
        link = (LeaderLink(leader) if F is L else CrossLink(leader, F, L))
        fkube = F.kubefake.FakeKubeApiServer()
        for i in range(N_NS):
            fkube.seed("", "v1", "namespaces",
                       {"metadata": {"name": f"ns{i}"}})
        f, _ = make_follower(F, furl, leader, fkube, transport=link)
        followers.append(f)

    async def go():
        seen = []
        for batch in range(7):
            for j in range(6 if batch else 0):
                await churn(L, leader, batch * 6 + j)
                if batch == 3 and j == 2:
                    # reclaims the segment the followers are tailing
                    leader.persistence.checkpoint()
            want_rev = leader.endpoint.store.revision
            answers = []
            for f in followers:
                await f.replication.sync_once()
                assert f.replication.store.revision == want_rev
                answers.append([(await list_ns(f, u))[1]
                                for u in FOLLOWER_USERS])
            want = [(await list_ns(leader, u))[1] for u in FOLLOWER_USERS]
            assert answers[0] == answers[1] == want, batch
            seen.append(want_rev)
        return seen

    revs = asyncio.run(go())
    assert revs == sorted(set(revs))
    for f in followers:
        assert f.replication.stats["applied_records"] > 0
        assert f.replication.stats["rebootstraps"] == 1


# -- replica expiry seams (the reference's :682 tests) ----------------------

def _expiring(P, ns, user, at):
    return P.touch(f"namespace:{ns}#viewer@user:{user}[expiration:{at}]")


def test_replica_expiry_invalidates_cached_frontier_apply_batch():
    P = PORT
    t = [1_700_000_000.0]
    leaf = P.store.TupleStore(clock=lambda: t[0])
    ep = P.decision_cache.DecisionCacheEndpoint(P.endpoints.EmbeddedEndpoint(
        P.schema.parse_schema(EXPIRY_SCHEMA), store=leaf))
    alice = P.types.SubjectRef("user", "alice")

    async def go():
        leaf.apply_replica_batch([
            _expiring(P, "ns1", "alice", t[0] + 10.0),
            P.touch("namespace:ns2#creator@user:alice")])
        assert sorted(await ep.lookup_resources(
            "namespace", "view", alice)) == ["ns1", "ns2"]
        again = await ep.lookup_resources("namespace", "view", alice)
        assert getattr(again, "source", "") == "cache"
        t[0] += 20.0
        assert sorted(await ep.lookup_resources(
            "namespace", "view", alice)) == ["ns2"]
        assert ep.cache.stats["invalidations"] >= 1

    asyncio.run(go())


def test_replica_expiry_invalidates_cached_frontier_after_rebootstrap():
    P = PORT
    t = [1_700_000_000.0]
    leaf = P.store.TupleStore(clock=lambda: t[0])
    ep = P.decision_cache.DecisionCacheEndpoint(P.endpoints.EmbeddedEndpoint(
        P.schema.parse_schema(EXPIRY_SCHEMA), store=leaf))
    alice = P.types.SubjectRef("user", "alice")
    parse = P.types.parse_relationship

    async def go():
        leaf.apply_replica_batch([P.touch("namespace:ns9#creator@user:alice")])
        assert sorted(await ep.lookup_resources(
            "namespace", "view", alice)) == ["ns9"]
        leaf.replica_reset(
            None,
            [parse(f"namespace:ns1#viewer@user:alice"
                   f"[expiration:{t[0] + 10.0}]"),
             parse("namespace:ns2#creator@user:alice")],
            revision=50)
        assert sorted(await ep.lookup_resources(
            "namespace", "view", alice)) == ["ns1", "ns2"]
        t[0] += 20.0
        assert sorted(await ep.lookup_resources(
            "namespace", "view", alice)) == ["ns2"]

    asyncio.run(go())


def test_replica_expiry_reseeds_device_graph_heap():
    """A `torch://` endpoint on the CPU serving a follower store expires
    tuples that arrived through `apply_replica_batch` and through
    `replica_reset` at their instants, as the reference's `jax://` does
    on the same sequence."""
    from spicedb_kubeapi_proxy_tpu.ops.jax_endpoint import JaxEndpoint
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        TorchEndpoint)

    def run(P, make_ep):
        t = [1_700_000_000.0]
        leaf = P.store.TupleStore(clock=lambda: t[0])
        ep = make_ep(P.schema.parse_schema(EXPIRY_SCHEMA), leaf)
        alice = P.types.SubjectRef("user", "alice")
        parse = P.types.parse_relationship

        async def go():
            out = []
            leaf.apply_replica_batch([
                _expiring(P, "ns1", "alice", t[0] + 10.0),
                P.touch("namespace:ns2#creator@user:alice")])
            out.append(sorted(await ep.lookup_resources(
                "namespace", "view", alice)))
            t[0] += 20.0
            out.append(sorted(await ep.lookup_resources(
                "namespace", "view", alice)))
            leaf.replica_reset(
                None,
                [parse(f"namespace:ns3#viewer@user:alice"
                       f"[expiration:{t[0] + 10.0}]")],
                revision=90)
            out.append(sorted(await ep.lookup_resources(
                "namespace", "view", alice)))
            t[0] += 20.0
            out.append(sorted(await ep.lookup_resources(
                "namespace", "view", alice)))
            return out

        return asyncio.run(go())

    got = run(PORT, lambda s, st: TorchEndpoint(s, store=st, device="cpu"))
    want = run(REF, lambda s, st: JaxEndpoint(s, store=st))
    assert got == want == [["ns1", "ns2"], ["ns2"], ["ns3"], []]


# -- chip_smoke.py phase 19 on the CPU, at a small size ----------------------

def test_chip_smoke_phase19_rehearsal_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 19 (a durable leader, an in-process crash
    and recovery, a `python -m --data-dir` process killed and restarted,
    a follower tailing the recovered leader, and its re-bootstrap past a
    reclaimed tail) runs on `device="cpu"` over a small multitenant-1m,
    with the kernels' twins counting launches as the card's wrappers
    do: every check of the phase holds here too, and every read kernel
    and `scatter_rows` launched on the follower."""
    import functools
    import importlib.util
    import pathlib

    from spicedb_kubeapi_proxy_tpu_torch.models import workloads
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.utils import features

    pytest.importorskip("h11")
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
    for const, value in (("DURABLE_ROUNDS", 4), ("FOLLOWER_ROUNDS", 4),
                         ("DURABLE_CREATES", 16),
                         ("DURABLE_ORACLE_CHECKS", 50), ("N_CHECKS", 2000),
                         ("LOOKUP_LANES", 64)):
        monkeypatch.setattr(smoke, const, value)
    w = workloads.multitenant_1m(n_pods=8_000, n_tuples=30_000,
                                 n_users=500, n_namespaces=200)
    kube = smoke._seed_proxy_kube(200, 1000, 200)
    out = smoke.durable_path(w, kube, "cpu", device="cpu")
    assert all(out["launches"][k] > 0
               for k in smoke.READ_KERNELS + ("scatter_rows",))
