"""The port's leader failover held against the reference's.

Every scenario of tests/test_failover.py (the manifest's incarnation and
chain, promotion and a promotion that crashes and rolls back, its
preconditions, a rejoin that loses no acknowledged write, with and
without a checkpoint that reclaimed the unshipped window, the healed
partition, the rejoin privilege, the equal-epoch tie, the election and
its tie-break, the watchdog's probe and its flight window, a fan-out
chain's parity and lag, writes forwarded up a chain, min-revision on
forwarded reads and writes, the fault matrix, the torn bootstrap and the
backoff) runs on the port's `ProxyServer` over `embedded://` and
`torch://?device=cpu` (batched and direct), and on the reference's over
`embedded://` (what its test runs).  Each scenario holds the reference
test's assertions on both packages and returns its observations —
statuses, revisions, incarnations, replayed counts, listed names — which
must be equal between them.

Across packages: a follower of one package is promoted over a leader of
the other, and the other package's resurrected ex-leader rejoins it; a
leaf of one package tails a relay of the other, whose mirror holds the
leader's segment and checkpoint bytes.  After each promotion and rejoin
the port's `torch://?device=cpu` answers equal its host oracle's and the
reference's `jax://` on the same tuples, and an ex-leader whose decision
cache held answers at the revisions the rejoin reuses answers as the
reference's does.  Last, the failover flags through the port's CLI, and
chip_smoke.py's phase 20 rehearsed on the CPU.
"""

import asyncio
import importlib
import json
import os
import random
import shutil
import tempfile
import time

import pytest

from test_failover import N_NS, RULES, SCHEMA
from test_torch_replication import CrossLink, RPkg

PORT_URLS = ["embedded://", "torch://?device=cpu",
             "torch://?device=cpu&dispatch=direct"]


class FPkg(RPkg):
    """The modules of one package that a failover scenario needs."""

    def __init__(self, root: str):
        super().__init__(root)

        def mod(name):
            return importlib.import_module(f"{root}.{name}")
        self.failover = mod("spicedb.replication.failover")
        self.leader_mod = mod("spicedb.replication.leader")
        self.follower_mod = mod("spicedb.replication.follower")
        self.fp = mod("utils.failpoints")


REF = FPkg("spicedb_kubeapi_proxy_tpu")
PORT = FPkg("spicedb_kubeapi_proxy_tpu_torch")


@pytest.fixture(autouse=True)
def reset_switches_and_failpoints():
    yield
    PORT.features.REPLICATION = True
    REF.features.GATES.reset()
    PORT.fp.disable_all()
    REF.fp.disable_all()


@pytest.fixture
def tmp():
    d = tempfile.mkdtemp(prefix="torch-failover-test-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


class LeaderLink:
    """In-process transport resolving the target proxy's CURRENT handler
    on every call; swappable for leader-restart scenarios."""

    def __init__(self, proxy=None):
        self.proxy = proxy

    async def round_trip(self, req):
        if self.proxy is None:
            raise ConnectionError("link not bound")
        return await self.proxy.handler(req)

    def set_leader(self, proxy):
        self.proxy = proxy


class DeadTransport:
    async def round_trip(self, req):
        raise ConnectionError("peer is gone")


def seed_kube(P, kube=None):
    kube = kube or P.kubefake.FakeKubeApiServer()
    for i in range(N_NS):
        kube.seed("", "v1", "namespaces", {"metadata": {"name": f"ns{i}"}})
    return kube


def make_leader(P, url, tmp, sub="leader", seed_ns=True, kube=None,
                **opt_kw):
    if kube is None:
        kube = seed_kube(P) if seed_ns else P.kubefake.FakeKubeApiServer()
    leader = P.server.ProxyServer(P.server.Options(
        spicedb_endpoint=url,
        bootstrap=P.endpoints.Bootstrap(schema_text=SCHEMA),
        rules_yaml=RULES,
        upstream_transport=P.httpcore.HandlerTransport(kube),
        data_dir=os.path.join(tmp, sub), wal_fsync="never", **opt_kw))
    if seed_ns:
        leader.endpoint.store.bulk_load([
            P.types.parse_relationship(f"namespace:ns{i}#creator@user:alice")
            for i in range(0, N_NS, 2)])
    return leader, kube


def make_follower(P, url, leader, kube, transport=None, **opt_kw):
    transport = transport or LeaderLink(leader)
    follower = P.server.ProxyServer(P.server.Options(
        spicedb_endpoint=url,
        bootstrap=P.endpoints.Bootstrap(schema_text=SCHEMA),
        rules_yaml=RULES,
        upstream_transport=P.httpcore.HandlerTransport(kube),
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


async def parity(a, b, users=("alice", "u0", "u1", "nobody")):
    """What both proxies list for each user, held equal."""
    out = []
    for user in users:
        ra, ia = await list_ns(a, user)
        rb, ib = await list_ns(b, user)
        assert ra.status == rb.status == 200
        assert ia == ib, f"divergence for {user}: {ia} != {ib}"
        out.append(ia)
    return out


def has(P, proxy, s):
    return proxy.endpoint.store.has_exact(P.types.parse_relationship(s))


def pod(name, ns="ns0"):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": ns}}


def rejoined(P) -> float:
    return P.failover._rejoin_records().value()


# -- the reference's scenarios: async fn(P, url, tmp) -> observations -----

async def sc_manifest_carries_incarnation_and_chain(P, url, tmp):
    leader, _ = make_leader(P, url, tmp)
    client = leader.get_embedded_client("alice")
    man = json.loads((await client.get("/replication/manifest")).body)
    assert man["incarnation"] == 1
    assert man["fenced"] is None
    assert man["chain"] == {"path": [man["leader_id"]],
                            "lag_revisions": 0.0, "lag_seconds": 0.0}
    st = json.loads((await client.get("/replication/status")).body)
    assert st["role"] == "leader"
    assert st["incarnation"] == 1 and st["fenced_by"] is None
    # restart in place bumps the epoch by one and extends the lineage
    leader2, _ = make_leader(P, url, tmp, seed_ns=False)
    hub = leader2.replication_hub
    assert hub.incarnation == 2
    lineage = P.leader_mod.leader_lineage(leader2.persistence.data_dir)
    assert leader.replication_hub.leader_id in lineage
    assert hub.leader_id in lineage
    return [man["incarnation"], man["fenced"], man["revision"], sorted(st),
            st["revision"], hub.incarnation, len(lineage)]


async def sc_promote_follower_becomes_writable_leader(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    fol, _ = make_follower(P, url, leader, kube,
                           promote_data_dir=os.path.join(tmp, "promote"))
    fol.enable_dual_writes()
    for i in range(6):
        await churn(P, leader, i)
    await fol.replication.sync_once()
    shipped = fol.replication.store.revision
    old_inc = fol.replication.max_incarnation
    obs = [shipped, old_inc]
    # promotion is privileged: a plain principal gets 403
    resp = await fol.get_embedded_client("mallory").post(
        "/replication/promote", {})
    assert resp.status == 403
    assert fol.replication is not None
    obs.append(resp.status)
    client = fol.get_embedded_client("admin", groups=["system:masters"])
    resp = await client.post("/replication/promote", {})
    assert resp.status == 200, resp.body
    info = json.loads(resp.body)
    assert info["revision"] == shipped
    assert info["incarnation"] == old_inc + 2  # the promotion mint
    assert fol.replication is None and fol.replication_hub is not None
    assert fol.replication_hub.fenced["revision"] == shipped
    obs.append([info["revision"], info["incarnation"], sorted(info)])
    st = json.loads((await client.get("/replication/status")).body)
    assert st["role"] == "leader" and st["incarnation"] == old_inc + 2
    dbg = json.loads((await client.get("/debug/replication")).body)
    assert dbg["role"] == "leader"
    obs.append([st["role"], st["incarnation"], st["revision"], dbg["role"]])
    # the promoted node takes writes locally
    resp = await fol.get_embedded_client("alice").post(
        "/api/v1/namespaces/ns0/pods", pod("p1"))
    assert resp.status in (200, 201), resp.body
    assert resp.headers.get("X-Authz-Forwarded-To") == ""
    assert has(P, fol, "pod:ns0/p1#creator@user:alice")
    obs.append([resp.status, fol.endpoint.store.revision])
    resp = await client.post("/replication/promote", {})
    assert resp.status == 409
    obs.append(resp.status)
    # the promoted log is bootstrappable by a fresh follower
    g, _ = make_follower(P, url, fol, kube)
    await g.replication.sync_once()
    assert g.replication.store.revision == fol.endpoint.store.revision
    assert g.replication.max_incarnation == old_inc + 2
    obs.append([g.replication.store.revision, await parity(fol, g)])
    return obs


async def sc_promotion_crash_rolls_back_to_intact_follower(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    fol, _ = make_follower(P, url, leader, kube,
                           promote_data_dir=os.path.join(tmp, "promote"))
    for i in range(4):
        await churn(P, leader, i)
    await fol.replication.sync_once()
    _, before = await list_ns(fol, "u1")
    P.fp.enable_failpoint("replPromote", 1)
    with pytest.raises(P.fp.FailPointPanic):
        await P.failover.promote_follower(fol)
    assert fol.replication is not None
    assert fol.replication_hub is None
    resp, after = await list_ns(fol, "u1")
    assert resp.status == 200 and after == before
    await churn(P, leader, 99)
    await fol.replication.sync_once()
    assert fol.replication.store.revision == leader.endpoint.store.revision
    P.fp.disable_all()
    info = await P.failover.promote_follower(fol)
    assert fol.replication_hub is not None
    assert info["revision"] == fol.endpoint.store.revision
    return [before, after, info["revision"], info["incarnation"]]


async def sc_promote_requires_follower_and_gate(P, url, tmp):
    P.set_replication(False)
    leader, kube = make_leader(P, url, tmp)
    fol, _ = make_follower(P, url, leader, kube,
                           promote_data_dir=os.path.join(tmp, "p"),
                           serve_replication=True)
    assert fol.replication is None and fol.fanout_hub is None
    assert leader.replication_hub is None
    r1 = await fol.get_embedded_client(
        "a", groups=["system:masters"]).post("/replication/promote", {})
    assert r1.status == 503
    r2 = await fol.get_embedded_client("a").get("/replication/status")
    assert r2.status == 503
    return [r1.status, r2.status]


async def sc_rejoin_replays_unshipped_tail_zero_lost(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    fol, _ = make_follower(P, url, leader, kube,
                           promote_data_dir=os.path.join(tmp, "promote"))
    for i in range(6):
        await churn(P, leader, i)
    await fol.replication.sync_once()
    shipped = fol.replication.store.revision
    # acknowledged on the leader, never shipped
    await leader.endpoint.write_relationships([
        P.touch("namespace:ns9#viewer@user:lostwrite")])
    info = await P.failover.promote_follower(fol)
    assert info["revision"] == shipped
    assert not has(P, fol, "namespace:ns9#viewer@user:lostwrite")
    await fol.endpoint.write_relationships([
        P.touch("namespace:ns1#viewer@user:afterfail")])
    # the ex-leader resurrects over its data dir, the new leader a peer
    old2, _ = make_leader(P, url, tmp, seed_ns=False, kube=kube,
                          replica_peers=["http://new.test"],
                          peer_transports={"http://new.test":
                                           LeaderLink(fol)})
    assert has(P, old2, "namespace:ns9#viewer@user:lostwrite")
    assert old2.replication_hub.incarnation < info["incarnation"]
    obs = [shipped, info["incarnation"], old2.replication_hub.incarnation,
           old2.endpoint.store.revision]
    before = rejoined(P)
    mon = P.failover.FenceMonitor(old2)
    assert await mon.check_once() == "demoted"
    assert old2.replication_hub is None and old2.replication is not None
    # zero lost: the unshipped write came through the rejoin replay
    assert has(P, fol, "namespace:ns9#viewer@user:lostwrite")
    assert has(P, fol, "namespace:ns1#viewer@user:afterfail")
    assert old2.endpoint.store.revision == fol.endpoint.store.revision
    obs.append([rejoined(P) - before, mon.stats,
                fol.endpoint.store.revision,
                await parity(fol, old2, users=("alice", "u1", "lostwrite",
                                               "afterfail"))])
    # writes on the rejoined ex-leader forward to the new leader
    fol.enable_dual_writes()
    resp = await old2.get_embedded_client("alice").post(
        "/api/v1/namespaces/ns0/pods", pod("p2"))
    assert resp.status in (200, 201), resp.body
    assert resp.headers.get("X-Authz-Forwarded-To") == "leader"
    assert has(P, fol, "pod:ns0/p2#creator@user:alice")
    obs.append([resp.status, fol.endpoint.store.revision])
    return obs


async def sc_healed_partition_converges_to_one_writable_leader(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    fol, _ = make_follower(P, url, leader, kube,
                           promote_data_dir=os.path.join(tmp, "promote"))
    other, _ = make_follower(P, url, leader, kube)
    fol.enable_dual_writes()
    for i in range(5):
        await churn(P, leader, i)
    await fol.replication.sync_once()
    await other.replication.sync_once()
    info = await P.failover.promote_follower(fol)
    new_inc = info["incarnation"]
    other.opts.peer_transports = {"http://new.test": LeaderLink(fol)}
    other.opts.replica_peers = ["http://new.test"]
    other.repoint_leader("http://new.test")
    await other.replication.sync_once()
    assert other.replication.max_incarnation == new_inc
    # the old leader resurrects, knowing nothing of the promotion
    old2, _ = make_leader(P, url, tmp, seed_ns=False, kube=kube)
    assert old2.replication_hub.incarnation < new_inc
    _, before = await list_ns(other, "u1")
    other.replication.repoint(LeaderLink(old2), "http://old.test")
    with pytest.raises(P.repl.StaleLeaderError):
        await other.replication.sync_once()
    assert other.replication.stats["fenced_polls"] == 1
    resp, after = await list_ns(other, "u1")
    assert resp.status == 200 and after == before
    # the stale poll fenced the ex-leader: it refuses update verbs
    assert old2.replication_hub.fenced_by["incarnation"] == new_inc
    r_fenced = await old2.get_embedded_client("alice").post(
        "/api/v1/namespaces/ns0/pods", pod("px"))
    assert r_fenced.status == 503 and b"superseded" in r_fenced.body
    r_read, _ = await list_ns(old2, "u1")
    assert r_read.status == 200
    ready = await old2.get_embedded_client("x").get("/readyz")
    assert ready.status == 200 and b"fenced" in ready.body
    r_new = await fol.get_embedded_client("alice").post(
        "/api/v1/namespaces/ns0/pods", pod("px"))
    assert r_new.status in (200, 201), r_new.body
    old2.opts.peer_transports = {"http://new.test": LeaderLink(fol)}
    old2.opts.replica_peers = ["http://new.test"]
    mon = P.failover.FenceMonitor(old2)
    assert await mon.check_once() == "demoted"
    assert old2.replication_hub is None
    return [new_inc, old2.replication.max_incarnation, before, after,
            r_fenced.status, json.loads(r_fenced.body)["message"],
            r_read.status, ready.body, r_new.status,
            await parity(fol, old2)]


async def sc_rejoin_endpoint_requires_privilege(P, url, tmp):
    leader, _ = make_leader(P, url, tmp)
    rev = leader.endpoint.store.revision
    body = {"from_leader_id": "x", "from_incarnation": 1,
            "updates": [["t", "namespace:ns0#viewer@user:evil"]]}
    r1 = await leader.get_embedded_client("mallory").post(
        "/replication/rejoin", body)
    assert r1.status == 403
    assert leader.endpoint.store.revision == rev
    assert not has(P, leader, "namespace:ns0#viewer@user:evil")
    r2 = await leader.get_embedded_client("system:replica").post(
        "/replication/rejoin", body)
    assert r2.status == 200
    assert json.loads(r2.body)["applied"] == 1
    return [r1.status, json.loads(r1.body)["message"], r2.status,
            json.loads(r2.body)]


async def sc_rejoin_replays_checkpoint_reclaimed_window(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    fol, _ = make_follower(P, url, leader, kube,
                           promote_data_dir=os.path.join(tmp, "promote"))
    for i in range(4):
        await churn(P, leader, i)
    await fol.replication.sync_once()
    shipped = fol.replication.store.revision
    await leader.endpoint.write_relationships([
        P.touch("namespace:ns8#viewer@user:ckptlost")])
    leader.persistence.checkpoint()
    assert leader.persistence._last_ckpt_revision > shipped
    info = await P.failover.promote_follower(fol)
    assert info["revision"] == shipped
    old2, _ = make_leader(P, url, tmp, seed_ns=False, kube=kube,
                          replica_peers=["http://new.test"],
                          peer_transports={"http://new.test":
                                           LeaderLink(fol)})
    before = rejoined(P)
    mon = P.failover.FenceMonitor(old2)
    assert await mon.check_once() == "demoted"
    assert has(P, fol, "namespace:ns8#viewer@user:ckptlost")
    assert old2.endpoint.store.revision == fol.endpoint.store.revision
    return [shipped, rejoined(P) - before, fol.endpoint.store.revision,
            await parity(fol, old2, users=("alice", "ckptlost"))]


async def sc_equal_epoch_tie_breaks_on_larger_leader_id(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    hub = leader.replication_hub
    small_id, big_id = "leader-0000-aaaa", "leader-9999-zzzz"

    class FakeReq:
        def __init__(self, inc, lid):
            self.headers = P.httpcore.Headers([
                ("X-Replication-Incarnation", str(inc)),
                ("X-Replication-Leader-Id", lid)])

    hub.leader_id = big_id
    hub.observe_poll_headers(FakeReq(hub.incarnation, small_id))
    assert hub.fenced_by is None
    hub.observe_poll_headers(FakeReq(hub.incarnation, big_id + "x"))
    assert hub.fenced_by is not None
    obs = [dict(hub.fenced_by)]
    fol, _ = make_follower(P, url, leader, kube)
    fol.replication.max_incarnation = 7
    fol.replication.max_leader_id = big_id

    class FakeTransport:
        def __init__(self, inc, lid):
            self.inc, self.lid = inc, lid

        async def round_trip(self, req):
            return P.httpcore.json_response(200, {
                "leader_id": self.lid, "incarnation": self.inc,
                "revision": 0, "checkpoint": None, "segments": [],
                "sidecars": [], "chain": {"path": [self.lid],
                                          "lag_revisions": 0,
                                          "lag_seconds": 0}})

    fol.replication.transport = FakeTransport(7, small_id)
    with pytest.raises(P.repl.StaleLeaderError):
        await fol.replication._fetch_manifest(wait=False)
    fol.replication.transport = FakeTransport(7, big_id + "x")
    await fol.replication._fetch_manifest(wait=False)
    assert fol.replication.max_leader_id == big_id + "x"
    obs.append([fol.replication.max_incarnation,
                fol.replication.max_leader_id,
                fol.replication.stats["fenced_polls"]])
    return obs


def _make_election_pair(P, url, tmp, kube, leader):
    link_a, link_b = LeaderLink(), LeaderLink()
    fa, _ = make_follower(P, url, leader, kube, replica_id="node-a",
                          promote_data_dir=os.path.join(tmp, "pa"),
                          replica_peers=["http://b.test"],
                          peer_transports={"http://b.test": link_b})
    fb, _ = make_follower(P, url, leader, kube, replica_id="node-b",
                          promote_data_dir=os.path.join(tmp, "pb"),
                          replica_peers=["http://a.test"],
                          peer_transports={"http://a.test": link_a})
    link_a.set_leader(fa)
    link_b.set_leader(fb)
    return fa, fb


async def sc_election_highest_revision_wins_and_loser_repoints(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    fa, fb = _make_election_pair(P, url, tmp, kube, leader)
    for i in range(4):
        await churn(P, leader, i)
    await fb.replication.sync_once()
    for i in range(4, 8):
        await churn(P, leader, i)
    await fa.replication.sync_once()  # A strictly ahead of B
    assert fa.replication.store.revision > fb.replication.store.revision
    wd_a = P.failover.LeaderLossWatchdog(fa, grace_s=0.0)
    wd_b = P.failover.LeaderLossWatchdog(fb, grace_s=0.0)
    votes = [await wd_b.run_election()]
    assert votes[-1] == "deferred" and fb.replication is not None
    votes.append(await wd_a.run_election())
    assert votes[-1] == "promoted" and fa.replication_hub is not None
    votes.append(await wd_b.run_election())
    assert votes[-1] == "repointed"
    assert fb.opts.replicate_from == "http://a.test"
    await fb.replication.sync_once()
    assert fb.replication.store.revision == fa.endpoint.store.revision
    await fa.endpoint.write_relationships([
        P.touch("namespace:ns2#viewer@user:postelect")])
    await fb.replication.sync_once()
    assert fb.replication.store.has_exact(P.types.parse_relationship(
        "namespace:ns2#viewer@user:postelect"))
    return [votes, wd_a.stats, wd_b.stats, fb.replication.store.revision,
            fa.replication_hub.incarnation, await parity(fa, fb)]


async def sc_election_tie_breaks_on_smallest_replica_id(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    fa, fb = _make_election_pair(P, url, tmp, kube, leader)
    for i in range(4):
        await churn(P, leader, i)
    await fa.replication.sync_once()
    await fb.replication.sync_once()
    assert fa.replication.store.revision == fb.replication.store.revision
    wd_a = P.failover.LeaderLossWatchdog(fa, grace_s=0.0)
    wd_b = P.failover.LeaderLossWatchdog(fb, grace_s=0.0)
    votes = [await wd_b.run_election(), await wd_a.run_election()]
    assert votes == ["deferred", "promoted"]
    assert fa.replication_hub is not None
    return [votes, fa.endpoint.store.revision]


async def sc_watchdog_probe_prevents_false_promotion(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    fol, _ = make_follower(P, url, leader, kube,
                           promote_data_dir=os.path.join(tmp, "promote"))
    await fol.replication.sync_once()
    wd = P.failover.LeaderLossWatchdog(fol, grace_s=0.05)
    # a stale success (as in an idle 25 s long-poll), a live leader
    fol.replication._last_success = time.monotonic() - 60.0
    checks = [await wd.check_once()]
    assert checks[-1] == "healthy" and fol.replication_hub is None
    assert wd.stats.get("probes_ok") == 1
    # the probe refreshed the loss clock: no probe on the next tick
    checks.append(await wd.check_once())
    assert checks[-1] == "healthy" and wd.stats.get("probes_ok") == 1
    # the same staleness with the leader gone: the election fires
    fol.replication.transport = DeadTransport()
    fol.replication._last_success = time.monotonic() - 60.0
    checks.append(await wd.check_once())
    assert checks[-1] == "promoted" and fol.replication_hub is not None
    return [checks, wd.stats]


async def sc_watchdog_failover_completes_within_flight_window(P, url, tmp):
    flight_window_s = 5.0
    leader, kube = make_leader(P, url, tmp)
    fol, _ = make_follower(P, url, leader, kube,
                           promote_data_dir=os.path.join(tmp, "promote"),
                           flight_window_s=flight_window_s)
    for i in range(4):
        await churn(P, leader, i)
    await fol.replication.sync_once()
    fol.replication.transport = DeadTransport()
    fol._leader_transport = DeadTransport()
    wd = P.failover.LeaderLossWatchdog(fol, grace_s=0.15, interval_s=0.05)
    t0 = time.monotonic()
    wd.start()
    try:
        while (fol.replication_hub is None
               and time.monotonic() - t0 < flight_window_s):
            await asyncio.sleep(0.02)
        elapsed = time.monotonic() - t0
        assert fol.replication_hub is not None, "promotion did not happen"
        assert elapsed < flight_window_s, \
            f"failover took {elapsed:.2f}s (window {flight_window_s}s)"
        rev = await fol.endpoint.write_relationships([
            P.touch("namespace:ns3#viewer@user:postwd")])
        assert rev > 0
    finally:
        await wd.stop()
    return [rev, wd.stats["promotions"], wd.stats["elections"]]


def _make_chain(P, url, tmp, kube, leader):
    mid, _ = make_follower(P, url, leader, kube, serve_replication=True,
                           mirror_dir=os.path.join(tmp, "mirror"),
                           replica_id="mid")
    leaf, _ = make_follower(P, url, mid, kube, replica_wait_ms=30.0)
    return mid, leaf


async def sc_fanout_chain_parity_and_chain_lag(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    leader.persistence.checkpoint()  # bootstrap via a mirrored checkpoint
    mid, leaf = _make_chain(P, url, tmp, kube, leader)
    for i in range(6):
        await churn(P, leader, i)
    await mid.replication.sync_once()
    await leaf.replication.sync_once()
    assert leaf.replication.store.revision == leader.endpoint.store.revision
    obs = [await parity(leader, leaf)]
    lid = leader.replication_hub.leader_id
    assert leaf.replication.upstream_chain["path"] == [lid, "mid"]
    dbg = json.loads((await leaf.get_embedded_client("a").get(
        "/debug/replication")).body)
    assert dbg["upstream_path"] == [lid, "mid"]
    mid_dbg = json.loads((await mid.get_embedded_client("a").get(
        "/debug/replication")).body)
    assert mid_dbg["fanout"]["serves_replication"]
    assert (leaf.replication.max_incarnation
            == leader.replication_hub.incarnation)
    obs.append([sorted(mid_dbg["fanout"]), leaf.replication.max_incarnation])
    # chain lag is additive
    for i in range(6, 11):
        await churn(P, leader, i)
    await mid.replication._fetch_manifest(wait=False)
    assert mid.replication.lag_revisions() > 0
    await leaf.replication.sync_once()
    assert leaf.replication.lag_revisions() >= mid.replication.lag_revisions()
    obs.append([mid.replication.lag_revisions(),
                leaf.replication.lag_revisions()])
    await mid.replication.sync_once()
    await leaf.replication.sync_once()
    assert leaf.replication.store.revision == leader.endpoint.store.revision
    assert leaf.replication.lag_revisions() == 0.0
    obs.append([leaf.replication.store.revision,
                await parity(leader, leaf)])
    return obs


async def sc_fanout_write_forwards_up_the_chain(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    leader.enable_dual_writes()
    mid, leaf = _make_chain(P, url, tmp, kube, leader)
    await mid.replication.sync_once()
    await leaf.replication.sync_once()
    resp = await leaf.get_embedded_client("alice").post(
        "/api/v1/namespaces/ns0/pods", pod("deep"))
    assert resp.status in (200, 201), resp.body
    assert resp.headers.get("X-Authz-Forwarded-To") == "leader"
    assert has(P, leader, "pod:ns0/deep#creator@user:alice")
    await mid.replication.sync_once()
    await leaf.replication.sync_once()
    assert leaf.replication.store.has_exact(P.types.parse_relationship(
        "pod:ns0/deep#creator@user:alice"))
    return [resp.status, leaf.replication.store.revision]


async def sc_min_revision_propagates_through_forwarded_reads(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    mid, leaf = _make_chain(P, url, tmp, kube, leader)
    mid.opts.replica_wait_ms = 30.0
    await mid.replication.sync_once()
    await leaf.replication.sync_once()
    rev = await leader.endpoint.write_relationships([
        P.touch("namespace:ns5#viewer@user:zed")])
    resp, items = await list_ns(
        leaf, "zed", headers=[(P.repl.MIN_REVISION_HEADER, str(rev))])
    assert resp.status == 200
    assert resp.headers.get("X-Authz-Forwarded-To") == "leader"
    assert items == ["ns5"]
    return [rev, resp.status, items]


async def sc_min_revision_propagates_on_forwarded_writes(P, url, tmp):
    leader, kube = make_leader(P, url, tmp, replica_wait_ms=50.0)
    leader.enable_dual_writes()
    fol, _ = make_follower(P, url, leader, kube)
    await fol.replication.sync_once()
    rev = leader.endpoint.store.revision
    r1 = await fol.get_embedded_client("alice").post(
        "/api/v1/namespaces/ns0/pods", pod("w1"),
        headers=[(P.repl.MIN_REVISION_HEADER, str(rev))])
    assert r1.status in (200, 201), r1.body
    r2 = await fol.get_embedded_client("alice").post(
        "/api/v1/namespaces/ns0/pods", pod("w2"),
        headers=[(P.repl.MIN_REVISION_HEADER,
                  str(leader.endpoint.store.revision + 50))])
    assert r2.status == 503
    assert b"not available on this leader" in r2.body
    return [rev, r1.status, r2.status, json.loads(r2.body)["message"]]


async def sc_leader_honors_min_revision_waits_then_503(P, url, tmp):
    leader, _ = make_leader(P, url, tmp, replica_wait_ms=500.0)
    client = leader.get_embedded_client("u1")
    rev = leader.endpoint.store.revision

    async def poke():
        await asyncio.sleep(0.05)
        await churn(P, leader, 0)

    task = asyncio.ensure_future(poke())
    r1, items = await list_ns(
        leader, "u0", headers=[(P.repl.MIN_REVISION_HEADER, str(rev + 1))])
    await task
    assert r1.status == 200
    leader.opts.replica_wait_ms = 30.0
    r2 = await client.get("/api/v1/namespaces", headers=[
        (P.repl.MIN_REVISION_HEADER,
         str(leader.endpoint.store.revision + 10))])
    assert r2.status == 503
    r3 = await client.get("/api/v1/namespaces",
                          headers=[(P.repl.MIN_REVISION_HEADER, "banana")])
    assert r3.status == 400
    return [rev, r1.status, items, r2.status, r3.status]


async def sc_fault_matrix_no_hang_anywhere(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    leader.persistence.checkpoint()
    rng = random.Random(11)
    obs = []

    async def drive(follower, fault, kind, fresh):
        for _ in range(2):
            await churn(P, leader, rng.randrange(1000))
        if not fresh:
            await follower.replication.sync_once()
            await churn(P, leader, rng.randrange(1000))
        _, before = await list_ns(follower, "u1")
        P.fp.enable_failpoint(fault, 1, kind=kind)
        with pytest.raises(Exception) as e:
            await asyncio.wait_for(follower.replication.sync_once(),
                                   timeout=3.0)
        resp, after = await list_ns(follower, "u1")
        assert resp.status == 200 and after == before
        P.fp.disable_all()
        await follower.replication.sync_once()
        assert (follower.replication.store.revision
                == leader.endpoint.store.revision)
        obs.append([fault, kind, type(e.value).__name__, before,
                    follower.replication.store.revision,
                    await parity(leader, follower)])

    for fault, kind, fresh in [
            ("replManifestPoll", P.fp.KIND_PANIC, False),
            ("replManifestPoll", P.fp.KIND_REFUSE, False),
            ("replLeaderLink", P.fp.KIND_REFUSE, False),
            ("replServeManifest", P.fp.KIND_REFUSE, False),
            ("replSegmentFetch", P.fp.KIND_PANIC, False),
            ("replCheckpointFetch", P.fp.KIND_PANIC, True),
            ("replBootstrapAdopt", P.fp.KIND_PANIC, True),
            ("replBootstrapFinish", P.fp.KIND_PANIC, True)]:
        follower, _ = make_follower(P, url, leader, kube)
        await drive(follower, fault, kind, fresh)
    return obs


async def sc_torn_bootstrap_never_serves_half_adopted_store(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    for i in range(6):
        await churn(P, leader, i)
    leader.persistence.checkpoint()
    f1, _ = make_follower(P, url, leader, kube)
    P.fp.enable_failpoint("replBootstrapAdopt", 1)
    with pytest.raises(P.fp.FailPointPanic):
        await f1.replication.sync_once()
    assert f1.replication.store.revision == 0
    assert not f1.replication.ever_bootstrapped
    ready = await f1.get_embedded_client("x").get("/readyz")
    assert ready.status == 503
    P.fp.disable_all()
    await f1.replication.sync_once()
    assert f1.replication.store.revision == leader.endpoint.store.revision
    obs = [ready.status, await parity(leader, f1)]
    f2, _ = make_follower(P, url, leader, kube)
    P.fp.enable_failpoint("replBootstrapFinish", 1)
    with pytest.raises(P.fp.FailPointPanic):
        await f2.replication.sync_once()
    assert not f2.replication.bootstrapped
    rev_mid = f2.replication.store.revision
    assert rev_mid in (0, leader.persistence._last_ckpt_revision)
    P.fp.disable_all()
    await f2.replication.sync_once()
    assert f2.replication.store.revision == leader.endpoint.store.revision
    obs.append([rev_mid, await parity(leader, f2)])
    return obs


async def sc_backoff_is_jittered_exponential_with_cap(P, url, tmp):
    fol = P.follower_mod.ReplicaFollower(
        P.store.TupleStore(), DeadTransport(), retry_backoff_s=1.0,
        retry_backoff_cap_s=15.0, rng=random.Random(42))
    cur = 1.0
    sleeps = []
    for _ in range(8):
        sleep_s, cur2 = fol._next_backoff(cur)
        assert cur / 2 <= sleep_s < cur, (sleep_s, cur)
        assert cur2 == min(cur * 2.0, 15.0)
        sleeps.append(sleep_s)
        cur = cur2
    assert cur == 15.0
    ratios = {round(s / b, 4)
              for s, b in zip(sleeps, [1, 2, 4, 8, 15, 15, 15, 15])}
    assert len(ratios) > 1
    return sleeps


async def sc_run_loop_backoff_jitters_between_retries(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    fol, _ = make_follower(P, url, leader, kube)
    fol.replication._rng = random.Random(7)
    await fol.replication.sync_once()
    fol.replication.transport = DeadTransport()
    sleeps = []
    real_sleep = asyncio.sleep

    async def fake_sleep(s, *a, **kw):
        sleeps.append(s)
        if len(sleeps) >= 6:
            raise asyncio.CancelledError
        await real_sleep(0)

    asyncio.sleep = fake_sleep
    try:
        with pytest.raises(asyncio.CancelledError):
            await fol.replication.run()
    finally:
        asyncio.sleep = real_sleep
    assert len(sleeps) == 6
    bands = [1, 2, 4, 8, 15, 15]
    for s, b in zip(sleeps, bands):
        assert b / 2 <= s < b, (s, b)
    assert len({round(s / b, 4) for s, b in zip(sleeps, bands)}) > 1
    assert fol.replication.stats["poll_errors"] >= 6
    return [sleeps, fol.replication.stats["poll_errors"]]


SCENARIOS = {name[3:]: fn for name, fn in globals().items()
             if name.startswith("sc_")}

_REF_OBS: dict = {}


def ref_obs(name):
    """The reference's observations of a scenario, computed once."""
    if name not in _REF_OBS:
        d = tempfile.mkdtemp(prefix="ref-failover-test-")
        try:
            _REF_OBS[name] = asyncio.run(
                SCENARIOS[name](REF, "embedded://", d))
        finally:
            REF.features.GATES.reset()
            REF.fp.disable_all()
            shutil.rmtree(d, ignore_errors=True)
    return _REF_OBS[name]


def test_every_reference_scenario_is_here():
    import test_failover
    ref_tests = sorted(n[5:] for n in dir(test_failover)
                       if n.startswith("test_"))
    assert ref_tests == sorted(SCENARIOS)
    assert len(SCENARIOS) == 22


@pytest.mark.parametrize("url", PORT_URLS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_the_reference(name, url, tmp):
    got = asyncio.run(SCENARIOS[name](PORT, url, tmp))
    assert got == ref_obs(name)


# -- across packages --------------------------------------------------------

def _url(P):
    return "torch://?device=cpu" if P is PORT else "embedded://"


def _link(proxy, follower_pkg, proxy_pkg):
    return (LeaderLink(proxy) if follower_pkg is proxy_pkg
            else CrossLink(proxy, follower_pkg, proxy_pkg))


def _oracle_and_jax_agree(P, proxy, users=("alice", "u0", "u1", "u2",
                                            "lostwrite", "afterfail",
                                            "nobody")):
    """The port node's `torch://?device=cpu` lookups equal its host
    oracle's on the same store and the reference's `jax://` over the same
    tuples; returns the answers."""
    from spicedb_kubeapi_proxy_tpu.ops.jax_endpoint import JaxEndpoint
    store = proxy.endpoint.store
    rels = [r.rel_string() for r in store.read(None)]
    ref_store = REF.store.TupleStore()
    ref_store.bulk_load([REF.types.parse_relationship(s) for s in rels])
    jax_ep = JaxEndpoint(REF.schema.parse_schema(SCHEMA), store=ref_store)
    oracle = PORT.endpoints.EmbeddedEndpoint(
        PORT.schema.parse_schema(SCHEMA), store=store)

    async def go():
        out = []
        for u in users:
            got = sorted(await proxy.endpoint.lookup_resources(
                "namespace", "view", PORT.types.SubjectRef("user", u)))
            want = sorted(await oracle.lookup_resources(
                "namespace", "view", PORT.types.SubjectRef("user", u)))
            ref = sorted(await jax_ep.lookup_resources(
                "namespace", "view", REF.types.SubjectRef("user", u)))
            assert got == want == ref, (u, got, want, ref)
            out.append(got)
        return out
    return go()


@pytest.mark.parametrize("promoted_pkg", ["port", "reference"])
def test_promotion_and_rejoin_across_packages(promoted_pkg, tmp):
    """A follower of one package promoted over the other package's
    leader; that leader resurrects over its data dir, is fenced and
    rejoins the promoted node, replaying its unshipped write.  Every
    acknowledged write of both is readable on both, and the port's
    `torch://?device=cpu` answers equal its oracle's and `jax://`'s
    after the promotion and after the rejoin."""
    F = PORT if promoted_pkg == "port" else REF
    L = REF if F is PORT else PORT
    port_node = []

    async def go():
        leader, _ = make_leader(L, _url(L), tmp)
        fkube = seed_kube(F)
        fol, _ = make_follower(
            F, _url(F), leader, fkube, transport=_link(leader, F, L),
            promote_data_dir=os.path.join(tmp, "promote"))
        for i in range(6):
            await churn(L, leader, i)
        await fol.replication.sync_once()
        shipped = fol.replication.store.revision
        await leader.endpoint.write_relationships([
            L.touch("namespace:ns9#viewer@user:lostwrite")])
        info = await F.failover.promote_follower(fol)
        assert info["revision"] == shipped
        assert info["incarnation"] == 3  # 1 observed + the promotion's 2
        await fol.endpoint.write_relationships([
            F.touch("namespace:ns1#viewer@user:afterfail")])
        if F is PORT:
            await _oracle_and_jax_agree(PORT, fol)
        old2, _ = make_leader(L, _url(L), tmp, kube=seed_kube(L),
                              seed_ns=False,
                              replica_peers=["http://new.test"],
                              peer_transports={"http://new.test":
                                               _link(fol, L, F)})
        assert old2.replication_hub.incarnation == 2
        before = rejoined(L)
        mon = L.failover.FenceMonitor(old2)
        assert await mon.check_once() == "demoted"
        assert rejoined(L) - before == 1
        for s in ("namespace:ns9#viewer@user:lostwrite",
                  "namespace:ns1#viewer@user:afterfail"):
            assert has(F, fol, s) and has(L, old2, s)
        assert old2.endpoint.store.revision == fol.endpoint.store.revision
        assert old2.replication.max_incarnation == 3
        port_node.append(fol if F is PORT else old2)
        users = ("alice", "u1", "lostwrite", "afterfail", "nobody")
        lists = []
        for proxy in (fol, old2):
            lists.append([(await list_ns(proxy, u))[1] for u in users])
        assert lists[0] == lists[1]
        assert lists[0][2] == ["ns9"] and lists[0][3] == ["ns1"]
        await _oracle_and_jax_agree(PORT, port_node[0])

    asyncio.run(go())


@pytest.mark.parametrize("relay_pkg", ["port", "reference"])
def test_leaf_of_the_other_package_tails_a_relay(relay_pkg, tmp):
    """A relay of one package (a follower with `serve_replication`) over
    a leader of the same package, and a leaf of the other package
    tailing the relay.  The relay's mirror holds the leader's segment and
    checkpoint bytes; the leaf answers as the leader does and reads the
    chain's path through the relay."""
    R = PORT if relay_pkg == "port" else REF
    X = REF if R is PORT else PORT

    async def go():
        leader, kube = make_leader(R, _url(R), tmp)
        for i in range(4):
            await churn(R, leader, i)
        leader.persistence.checkpoint()
        mirror = os.path.join(tmp, "mirror")
        mid, _ = make_follower(R, _url(R), leader, kube,
                               serve_replication=True, mirror_dir=mirror,
                               replica_id="mid")
        leaf, _ = make_follower(X, _url(X), mid, seed_kube(X),
                                transport=CrossLink(mid, X, R))
        for rnd in range(3):
            for i in range(5):
                await churn(R, leader, 10 * rnd + i)
            await mid.replication.sync_once()
            await leaf.replication.sync_once()
            assert (leaf.replication.store.revision
                    == leader.endpoint.store.revision)
            for u in ("alice", "u0", "u1", "u2", "u3", "nobody"):
                assert (await list_ns(leaf, u))[1] == \
                    (await list_ns(leader, u))[1]
        assert leaf.replication.upstream_chain["path"] == [
            leader.replication_hub.leader_id, "mid"]
        assert leaf.replication.max_incarnation == 1
        # the mirror is the leader's artifacts byte for byte
        data = leader.persistence.data_dir
        for sub in ("wal", "checkpoints"):
            names = sorted(os.listdir(os.path.join(mirror, sub)))
            assert names == sorted(os.listdir(os.path.join(data, sub)))
            for n in names:
                with open(os.path.join(mirror, sub, n), "rb") as a, \
                        open(os.path.join(data, sub, n), "rb") as b:
                    assert a.read() == b.read(), (sub, n)
        assert mid.replication.stats["mirrored_bytes"] > 0
        if X is PORT:
            await _oracle_and_jax_agree(PORT, leaf)

    asyncio.run(go())


# -- a rejoin resets an ex-leader that cached answers -------------------------

@pytest.mark.parametrize("url", ["torch://?device=cpu&cache=1",
                                 "torch://?device=cpu&dispatch=direct",
                                 "embedded://?cache=1"])
def test_rejoin_drops_answers_cached_at_reused_revisions(url, tmp):
    """The ex-leader serves (and caches) reads at the revisions of its
    three unshipped writes; the promoted node writes two other tuples, so
    the rejoin's reset and its one replayed batch bring the ex-leader back
    to the very revision of its last cached reads, now naming another
    state.  The rejoined node lists what the promoted node lists, as the
    reference's `jax://?cache=1` does on the same sequence, its device
    graph rebuilt from the adopted state with no read sent to the host
    oracle, and its answers equal the oracle's and `jax://`'s."""
    def run(P, u, d):
        async def go():
            leader, kube = make_leader(P, u, d)
            fol, _ = make_follower(
                P, "embedded://", leader, kube,
                promote_data_dir=os.path.join(d, "promote"))
            for i in range(5):
                await churn(P, leader, i)
            await fol.replication.sync_once()
            out = []
            for k in range(3):
                await leader.endpoint.write_relationships([
                    P.touch(f"namespace:ns{k}#viewer@user:cached{k}")])
                out.append([leader.endpoint.store.revision]
                           + [(await list_ns(leader, f"cached{j}"))[1]
                              for j in range(3)])
            await P.failover.promote_follower(fol)
            for k in range(2):
                await fol.endpoint.write_relationships([
                    P.touch(f"namespace:ns{5 + k}#viewer@user:cached{k}")])
            # the ex-leader, alive with its cache and its graph, finds the
            # new leader among its peers and rejoins it
            leader.opts.replica_peers = ["http://new.test"]
            leader.opts.peer_transports = {"http://new.test":
                                           LeaderLink(fol)}
            assert await P.failover.FenceMonitor(leader).check_once() \
                == "demoted"
            assert leader.endpoint.store.revision == \
                fol.endpoint.store.revision
            out.append([leader.endpoint.store.revision]
                       + [(await list_ns(leader, f"cached{j}"))[1]
                          for j in range(3)])
            out.append([(await list_ns(fol, f"cached{j}"))[1]
                        for j in range(3)])
            return out, leader

        return asyncio.run(go())

    got, node = run(PORT, url, os.path.join(tmp, "port"))
    want, _ = run(REF, "jax://?cache=1", os.path.join(tmp, "ref"))
    assert got == want
    # the revision of the last cached reads came round again, naming a
    # state with two more grants
    assert got[3][0] == got[2][0]
    assert got[2][1:] == [["ns0"], ["ns1"], ["ns2"]]
    assert got[3][1:] == got[4] == [["ns0", "ns5"], ["ns1", "ns6"], ["ns2"]]
    if url.startswith("torch"):
        inner = node.endpoint
        while "stale_routed" not in (getattr(inner, "stats", None) or {}):
            inner = inner.inner
        assert inner.stats["stale_routed"] == 0
    asyncio.run(_oracle_and_jax_agree(PORT, node, users=(
        "cached0", "cached1", "cached2", "alice", "u1")))


# -- the failover flags through the port's CLI --------------------------------

@pytest.mark.parametrize("argv,err", [
    (["--serve-replication"], "--serve-replication only applies"),
    (["--promote-on-leader-loss", "--replicate-from", "http://l:1"],
     "--promote-on-leader-loss needs --promote-data-dir"),
    (["--promote-on-leader-loss"],
     "--promote-on-leader-loss only applies"),
    (["--promote-data-dir", "d"], "--promote-data-dir only applies"),
    (["--leader-loss-grace", "0"], "--leader-loss-grace must be > 0"),
    (["--replica-peers", "ftp://x"], "--replica-peers entry 'ftp://x'"),
])
def test_failover_flags_fail_validate_as_the_reference(argv, err, tmp_path):
    from spicedb_kubeapi_proxy_tpu import cli as ref_cli
    from spicedb_kubeapi_proxy_tpu_torch import cli
    rules = tmp_path / "rules.yaml"
    rules.write_text(RULES)
    base = ["--rule-config", str(rules), "--use-in-cluster-config",
            "--spicedb-endpoint", "embedded://"]
    errs = cli.validate(cli.build_parser().parse_args(
        cli._normalize_argv(base + argv)))
    ref_errs = ref_cli.validate(ref_cli.build_parser().parse_args(
        ref_cli._normalize_argv(base + argv)))
    assert errs == ref_errs
    assert any(e.startswith(err) for e in errs), errs


def test_module_accepts_the_failover_flags(tmp_path):
    """`python -m spicedb_kubeapi_proxy_tpu_torch` parses the six
    failover flags (here one `validate` error: a relay needs
    --replicate-from, exit 2 with the reference's text), and a malformed
    `--partition-map` is a `validate` error (exit 2), as in the
    reference."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    rules = tmp_path / "rules.yaml"
    rules.write_text(RULES)
    argv = ["--rule-config", str(rules), "--use-in-cluster-config",
            "--spicedb-endpoint", "embedded://", "--serve-replication",
            "--replication-mirror-dir", str(tmp_path / "m"),
            "--replica-peers", "http://a:1", "--leader-loss-grace", "2"]
    out = subprocess.run(
        [sys.executable, "-m", "spicedb_kubeapi_proxy_tpu_torch"] + argv,
        cwd=root, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 2
    assert "--serve-replication only applies to a replica" in out.stderr
    assert "unrecognized arguments" not in out.stderr
    out = subprocess.run(
        [sys.executable, "-m", "spicedb_kubeapi_proxy_tpu_torch",
         "--partition-map", "pod"], cwd=root, capture_output=True,
        text=True, timeout=120, env=env)
    assert out.returncode == 2 and "--partition-map" in out.stderr
    assert "unrecognized arguments" not in out.stderr


def test_options_accept_the_failover_fields_and_refuse_sharding():
    from spicedb_kubeapi_proxy_tpu_torch.proxy.server import Options
    opts = Options(serve_replication=True, mirror_dir="m",
                   promote_data_dir="p", promote_on_leader_loss=True,
                   leader_loss_grace_s=1.0, replica_peers=["http://a"],
                   peer_transports={})
    assert opts.replica_peers == ["http://a"]
    opts = Options(shards=2, partition_map="pod=0")
    assert (opts.shards, opts.partition_map) == (2, "pod=0")
    # the fleet plane's field, ported since (it was a TypeError)
    assert Options(fleet_peers=["http://p"]).fleet_peers == ["http://p"]


# -- chip_smoke.py phase 20 on the CPU, at a small size ----------------------

def test_chip_smoke_phase20_rehearsal_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 20 (promotion of phase 19's follower over
    its dead leader, 16 rounds of writes on the promoted node, the old
    leader fenced and rejoined with its unshipped tail, the rejoined node
    relaying to a leaf, and the election) runs after phase 19 on
    `device="cpu"` over a small multitenant-1m, with the kernels' twins
    counting launches as the card's wrappers do: every check of the phase
    holds here too, and every read kernel and `scatter_rows` launched.
    Phase 19's `python -m` process (c), rehearsed by its own test, is
    left out here.  A round's pod creates and deletes are cut with the
    pods (8,000 here against 200,000), so the rounds use the spare pool
    of the graph in the proportion the card's full size does."""
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
                         ("LOOKUP_LANES", 64), ("FAILOVER_ROUNDS", 4),
                         ("LEAF_ROUNDS", 3), ("FAILOVER_ORACLE_CHECKS", 50),
                         ("ELECTION_WRITES", 8), ("ROUND_CREATES", 8),
                         ("ROUND_DELETES", 4), ("DURABLE_ROUND_WRITES", 32),
                         ("FAILOVER_ROUND_WRITES", 32),
                         ("ELECTION_WORKLOAD", {
                             "n_pods": 500, "n_tuples": 3_000,
                             "n_users": 100, "n_namespaces": 100})):
        monkeypatch.setattr(smoke, const, value)
    monkeypatch.setattr(smoke, "cli_crash", lambda *a, **k: None)
    w = workloads.multitenant_1m(n_pods=8_000, n_tuples=30_000,
                                 n_users=500, n_namespaces=200)
    kube = smoke._seed_proxy_kube(200, 1000, 200)
    out = smoke.durable_path(w, kube, "cpu", device="cpu", failover=True)
    assert all(out["failover"]["launches"][k] > 0
               for k in smoke.READ_KERNELS + ("scatter_rows",))
    assert set(out["phase_s"]) == {"19", "20"}
