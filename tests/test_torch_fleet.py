"""The port's fleet plane held against the reference's.

- The pure merge (utils/fleet.py): `merge_fleet`, `assemble_trace`,
  `merged_chrome_trace`, `merge_workload` and `parse_metric` give the
  reference's payloads on tests/test_fleet.py's member dicts and on
  seeded random fleets; `tailexplain.explain` gives the reference's
  report on the same merged views (tests/test_topology.py's cases too).
- Trace continuity over in-process proxies: one client trace id spans
  the router and a shard leader (hop parent/child linkage, the tier
  path, the propagation headers on the wire, serving-stage spans) with
  the port's router and leaders on `embedded://` and on
  `torch://?device=cpu`, and mixed with the reference's (each package's
  router in front of the other's leaders); /debug/fleet over them
  reconciles the tier sums with the root duration.
- Follower continuity (tests/test_fleet.py:524-600): a forwarded dual
  write and a min-revision read join the client's trace on the leader,
  whose audit events name the tier path; a follower's /debug/fleet
  merges its leader.
- With the TIMELINE switch off (the reference's Timeline gate) no
  propagation header leaves the router, receivers mint locally, and the
  response bodies are byte-identical to the reference's.

Tolerance: exact equality of payloads; durations are compared only as
the reference's tests compare them (the attribution within 0.05 ms of
the root).
"""

import asyncio
import copy
import importlib
import json
import os
import shutil
import tempfile

import numpy as np
import pytest

from test_fleet import (HOP_A, HOP_B, PMAP_SPEC, RULES, SCHEMA, TID, TID2,
                        hop, member, seg)
from test_torch_replication import CrossLink


class FPkg:
    def __init__(self, root: str):
        def mod(name):
            return importlib.import_module(f"{root}.{name}")
        self.root = root
        self.fleet = mod("utils.fleet")
        self.tail = mod("utils.tailexplain")
        self.tracing = mod("utils.tracing")
        self.features = mod("utils.features")
        self.kubefake = mod("kubefake.apiserver")
        self.httpcore = mod("proxy.httpcore")
        self.server = mod("proxy.server")
        self.endpoints = mod("spicedb.endpoints")
        self.sch = mod("spicedb.schema")
        self.sharding = mod("spicedb.sharding")
        self.types = mod("spicedb.types")
        self.repl = mod("spicedb.replication")
        self.proxyrule = mod("config.proxyrule")

    def set_timeline(self, on: bool) -> None:
        if self.root.endswith("_torch"):
            self.features.TIMELINE = on
        else:
            self.features.GATES.set("Timeline", on)

    def set_tail(self, on: bool) -> None:
        if self.root.endswith("_torch"):
            self.features.TAIL_EXPLAIN = on
        else:
            self.features.GATES.set("TailExplain", on)

    def rel(self, s):
        return self.types.parse_relationship(s)

    def schema(self):
        return self.endpoints.merge_internal_definitions(
            self.sch.parse_schema(SCHEMA))


PORT = FPkg("spicedb_kubeapi_proxy_tpu_torch")
REF = FPkg("spicedb_kubeapi_proxy_tpu")
CPU = "torch://?device=cpu"


@pytest.fixture(autouse=True)
def clean_state():
    for P in (PORT, REF):
        P.tracing.RECORDER.drain()
    yield
    for P in (PORT, REF):
        P.tracing.RECORDER.drain()
    PORT.set_timeline(True)
    PORT.set_tail(True)
    REF.features.GATES.reset()


@pytest.fixture
def tmp():
    d = tempfile.mkdtemp(prefix="torch-fleet-test-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


# -- the pure merge --------------------------------------------------------------


def _cases() -> dict:
    """tests/test_fleet.py's merge scenarios, as member lists."""
    root = seg(TID, "router", 12.0, spans=[hop(HOP_A, 2.0, 8.0,
                                               "hop.shard_forward")])
    child = seg(TID, "leader", 6.0, parent=HOP_A)
    three = [seg(TID, "router", 12.0, spans=[hop(HOP_A, 1.0, 10.0)]),
             seg(TID, "follower", 8.0, parent=HOP_A,
                 spans=[hop(HOP_B, 2.0, 5.0, "hop.forward_to_leader")]),
             seg(TID, "leader", 4.0, parent=HOP_B)]
    staged = seg(TID, "leader", 6.0, parent=HOP_A, spans=[
        {"name": "serving.decode", "start_ms": 0.5, "duration_ms": 3.0},
        {"name": "serving.filter", "start_ms": 3.5, "duration_ms": 2.0},
        {"name": "match", "start_ms": 0.0, "duration_ms": 1.0,
         "phase": True}])
    out = {
        "two_tier": [member("r", [root]), member("s0", [child])],
        "three_tier": [member("r", [three[0]]), member("f", [three[1]]),
                       member("l", [three[2]])],
        "orphan": [member("r", [seg(TID, "router", 12.0)]),
                   member("s0", [seg(TID, "leader", 6.0, parent="cc" * 8,
                                     start_unix=100.050)])],
        "stages": [member("r", [root]), member("s0", [staged])],
        "dedupe": [member("router", [root, child,
                                     seg(TID2, "leader", 3.0)]),
                   member("http://s0", [child, seg(TID2, "leader", 3.0)])],
        "slo": [member("http://f0", [], skew=0.012, lag=1.5,
                       flight={"burning": [{"slo": "latency_p99"}]}),
                {"url": "http://dead", "error": "GET /metrics: boom",
                 "traces": [], "flight": {}, "skew_s": None,
                 "lag_s": None}],
    }
    for skew in (0.0, 1000.0, -1000.0):
        out[f"skew{skew:+.0f}"] = [
            member("r", [root]),
            member("s0", [seg(TID, "leader", 6.0, parent=HOP_A,
                              start_unix=100.0 + skew)])]
    return out


def _random_fleet(seed: int) -> list:
    """A seeded fleet: a router fanning out to leaders, some via a
    follower, with serving stages, orphans, duplicates and workload
    rows."""
    rng = np.random.default_rng(seed)
    members = {u: [] for u in ("router", "http://l0", "http://l1",
                               "http://f0")}
    stages = ("authn", "rule_match", "kube_upstream", "decode", "filter")
    for t in range(int(rng.integers(3, 12))):
        tid = f"{seed:02x}{t:02x}" * 8
        dur = float(rng.integers(5, 400)) + 0.5
        hop_id = f"{t:04x}" * 4
        hop_start = float(rng.integers(0, 3))
        hop_dur = dur - hop_start - float(rng.integers(0, 2))
        root = seg(tid, "router", dur, start_unix=100.0 + t,
                   spans=[hop(hop_id, hop_start, hop_dur,
                              "hop.shard_forward")])
        members["router"].append(root)
        leader = f"http://l{int(rng.integers(0, 2))}"
        child_dur = max(0.5, hop_dur - float(rng.integers(0, 3)))
        spans = [{"name": f"serving.{s}",
                  "start_ms": float(rng.integers(0, 3)),
                  "duration_ms": float(rng.integers(0, 20)) / 4}
                 for s in stages if rng.integers(0, 2)]
        if rng.integers(0, 3) == 0:
            fhop = f"{t:04x}" * 3 + "ffff"
            members["http://f0"].append(seg(
                tid, "follower", child_dur, parent=hop_id,
                start_unix=100.0 + t + float(rng.integers(-5, 5)),
                spans=spans + [hop(fhop, 0.5, child_dur - 1.0,
                                   "hop.forward_to_leader")]))
            members[leader].append(seg(tid, "leader",
                                       max(0.2, child_dur - 2.0),
                                       parent=fhop))
        elif rng.integers(0, 5):
            members[leader].append(seg(
                tid, "leader", child_dur, parent=hop_id,
                start_unix=100.0 + t + float(rng.integers(-5, 5)),
                spans=spans))
        if rng.integers(0, 4) == 0:
            members[leader].append(seg(tid, "leader", 1.0,
                                       parent="dead" * 4))
    workload = {"rows": [{"resource_type": "pod", "permission": "view",
                          "device_s": float(rng.integers(1, 100)) / 1e3,
                          "kernel_rows": int(rng.integers(1, 50)),
                          "oracle_rows": 0, "cache_hits": 1,
                          "cache_misses": 2}],
                "total_device_s": 0.5, "attributed_device_s": 0.25,
                "leopard_candidates": [{"resource_type": "pod",
                                        "permission": "view",
                                        "mean_sweep_depth": float(seed)}]}
    out = []
    for i, (url, traces) in enumerate(members.items()):
        m = member(url, traces, skew=0.001 * i if i else None,
                   lag=0.5 * i if i else None)
        m["workload"] = workload if i % 2 else {}
        out.append(m)
    # the router's own scrape duplicated (a node listing itself)
    out.append(copy.deepcopy(out[0]))
    return out


def _all_cases() -> dict:
    cases = _cases()
    for seed in range(8):
        cases[f"random{seed}"] = _random_fleet(seed)
    return cases


CASES = _all_cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_merge_fleet_equals_the_reference(name):
    members = CASES[name]
    got = PORT.fleet.merge_fleet(copy.deepcopy(members))
    want = REF.fleet.merge_fleet(copy.deepcopy(members))
    assert got == want
    segs = PORT.fleet._segments_by_trace(copy.deepcopy(members))
    for tid, s in sorted(segs.items()):
        assert PORT.fleet.assemble_trace(s) == REF.fleet.assemble_trace(s)
    assembled = got["traces"]
    assert (PORT.fleet.merged_chrome_trace(assembled)
            == REF.fleet.merged_chrome_trace(assembled))
    assert (PORT.fleet.merge_workload(members)
            == REF.fleet.merge_workload(members))
    assert PORT.tail.explain(got) == REF.tail.explain(want)


def test_reference_merge_assertions_hold_on_the_port():
    """tests/test_fleet.py's own expectations, on the port's merge."""
    F = PORT.fleet
    a = F.merge_fleet(CASES["two_tier"])["traces"][0]
    assert {s["tier"]: s["offset_ms"] for s in a["segments"]} == {
        "router": 0.0, "leader": 2.0}
    assert a["network_ms"] == pytest.approx(2.0)
    assert a["attributed_ms"] == pytest.approx(a["duration_ms"])
    a = F.merge_fleet(CASES["three_tier"])["traces"][0]
    assert a["network_ms"] == pytest.approx(3.0)
    assert a["attributed_ms"] == pytest.approx(12.0)
    for skew in ("+0", "+1000", "-1000"):
        a = F.merge_fleet(CASES[f"skew{skew}"])["traces"][0]
        assert {s["tier"]: s["offset_ms"]
                for s in a["segments"]}["leader"] == 2.0
    orphan = F.merge_fleet(CASES["orphan"])["traces"][0]
    assert orphan["wall_fallbacks"] == 1
    merged = F.merge_fleet(CASES["dedupe"])
    assert [t["trace_id"] for t in merged["traces"]] == [TID]
    assert merged["traces"][0]["tiers"]["leader"]["segments"] == 1
    text = ("authz_clock_skew_seconds -0.025\n"
            "authz_replica_lag_seconds 1.75\n")
    assert F.parse_metric(text, F._SKEW_RE) == REF.fleet.parse_metric(
        text, REF.fleet._SKEW_RE) == -0.025
    assert F.parse_metric(text, F._LAG_RE) == 1.75


def _ttrace(tid, dur, tiers, stages, net=0.0):
    return {"trace_id": tid, "duration_ms": dur,
            "tiers": {t: {"self_ms": ms} for t, ms in tiers.items()},
            "serving_stages_ms": stages, "network_ms": net,
            "attributed_ms": dur, "tier_count": len(tiers)}


def _tail_cases() -> dict:
    """tests/test_topology.py's tail-explainer views, and seeded ones."""
    body = [_ttrace(f"b{i}", 10.0, {"leader": 10.0},
                    {"leader": {"kube_upstream": 2.0, "authn": 1.0}})
            for i in range(20)]
    planted = body + [_ttrace("slow", 100.0, {"leader": 100.0},
                              {"leader": {"kube_upstream": 90.0,
                                          "authn": 1.0}})]
    additive = [_ttrace(f"b{i}", 10.0, {"f": 4.0, "l": 4.0},
                        {"f": {"authn": 1.0}, "l": {"rule_match": 1.0}},
                        net=2.0) for i in range(10)]
    additive.append(_ttrace("slow", 50.0, {"f": 20.0, "l": 20.0},
                            {"f": {"authn": 11.0},
                             "l": {"rule_match": 11.0}}, net=10.0))
    out = {"empty": [], "one": [_ttrace("a", 5.0, {"leader": 5.0}, {})],
           "planted": planted, "additive": additive,
           "zeros": [_ttrace("z", 0.0, {"l": 0.0}, {})] * 5}
    for seed in range(6):
        rng = np.random.default_rng(100 + seed)
        out[f"random{seed}"] = [
            _ttrace(f"t{i}", float(rng.integers(1, 500)),
                    {"router": float(rng.integers(0, 50)),
                     "leader": float(rng.integers(0, 400))},
                    {"leader": {s: float(rng.integers(0, 100))
                                for s in ("authn", "filter", "decode")
                                if rng.integers(0, 2)}},
                    net=float(rng.integers(0, 10)))
            for i in range(int(rng.integers(2, 60)))]
    return out


TAIL_CASES = _tail_cases()


@pytest.mark.parametrize("name", sorted(TAIL_CASES))
def test_tail_explain_equals_the_reference(name):
    merged = {"traces": TAIL_CASES[name]}
    got = PORT.tail.explain(copy.deepcopy(merged))
    assert got == REF.tail.explain(copy.deepcopy(merged))
    if name == "planted":
        assert (got["ranked"][0]["tier"], got["ranked"][0]["stage"]) == (
            "leader", "kube_upstream")
        assert 0.9 < got["explained_fraction"] < 1.1
    if name == "additive":
        # every trace's components cover its duration, so the deltas sum
        # to the measured body->tail gap (means add up)
        assert sum(r["delta_ms"] for r in got["ranked"]) == pytest.approx(
            got["gap_ms"], rel=0.05)


def test_tail_switch_off_as_the_gate_off():
    PORT.set_tail(False)
    REF.set_tail(False)
    assert (PORT.tail.explain({"traces": []})
            == REF.tail.explain({"traces": []})
            == {"enabled": False,
                "reason": "TailExplain feature gate is off"})


# -- a router in front of two shard leaders ---------------------------------------


class Capturing:
    """A transport recording every forwarded request's headers."""

    def __init__(self, inner):
        self.inner = inner
        self.seen = []

    async def round_trip(self, req):
        self.seen.append(dict((k.lower(), v) for k, v in req.headers.items()))
        return await self.inner.round_trip(req)


def make_shard_leader(P, url, tmp, subdir, seed_rels):
    kube = P.kubefake.FakeKubeApiServer()
    kube.seed("", "v1", "namespaces", {"metadata": {"name": "team-a"}})
    proxy = P.server.ProxyServer(P.server.Options(
        spicedb_endpoint=url,
        bootstrap=P.endpoints.Bootstrap(schema_text=SCHEMA),
        rules_yaml=RULES,
        upstream_transport=P.httpcore.HandlerTransport(kube),
        data_dir=os.path.join(tmp, subdir), wal_fsync="never"))
    if seed_rels and proxy.endpoint.store.revision == 0:
        proxy.endpoint.store.bulk_load([P.rel(r) for r in seed_rels])
    proxy.enable_dual_writes()
    return proxy


def link(R, L, proxy):
    """A router of package R reaching a leader of package L."""
    if R is L:
        return R.httpcore.HandlerTransport(proxy.handler)
    return CrossLink(proxy, R, L)


def make_fleet(R, L, url, tmp):
    s0 = make_shard_leader(L, url, tmp, "s0",
                           ["namespace:team-a#creator@user:alice"])
    s1 = make_shard_leader(L, url, tmp, "s1",
                           ["podns:team-a#creator@user:alice"])
    pm = R.sharding.PartitionMap.parse(PMAP_SPEC, n_shards=2)
    cap0, cap1 = Capturing(link(R, L, s0)), Capturing(link(R, L, s1))
    router = R.sharding.ShardRouter(
        pm, [cap0, cap1], rule_configs=R.proxyrule.parse(RULES),
        schema=R.schema(), fleet_peers=["http://s0.test", "http://s1.test"],
        fleet_transports={"http://s0.test": link(R, L, s0),
                          "http://s1.test": link(R, L, s1)})
    return router, s0, s1, cap0, cap1


async def router_req(R, router, method, target, user="alice", body=None,
                     headers=()):
    h = R.httpcore.Headers(list(headers))
    if user:
        h.set("X-Remote-User", user)
    h.set("Accept", "application/json")
    data = b""
    if body is not None:
        data = json.dumps(body).encode()
        h.set("Content-Type", "application/json")
    return await router.handle(R.httpcore.Request(
        method=method, target=target, headers=h, body=data))


def segments(tid):
    return [t for P in (PORT, REF) for t in P.tracing.RECORDER.snapshot()
            if t["trace_id"] == tid]


def continuity(R, L, url, tmp):
    """One traced namespace get and one pod create through the router,
    then /debug/fleet: the package-free observations."""
    router, _s0, _s1, cap0, cap1 = make_fleet(R, L, url, tmp)

    async def go():
        out = {}
        r = await router_req(R, router, "GET", "/api/v1/namespaces/team-a",
                             headers=[("X-Trace-Id", TID)])
        out["get"] = (r.status, r.headers.get("X-Trace-Id") == TID,
                      r.headers.get("X-Authz-Shard"))
        by_tier = {t["attrs"].get("tier"): t for t in segments(TID)}
        hop_sp = next(sp for sp in by_tier["router"]["spans"]
                      if sp["name"] == "hop.shard_forward")
        out["tiers"] = sorted(by_tier)
        out["linked"] = (by_tier["leader"]["attrs"]["parent_span"]
                         == hop_sp["attrs"]["span_id"])
        out["tier_path"] = by_tier["leader"]["attrs"]["tier_path"]
        out["wire"] = (cap0.seen[-1].get("x-authz-trace-id") == TID,
                       cap0.seen[-1].get("x-authz-tier-path"),
                       len(cap0.seen[-1].get("x-authz-parent-span", "")))
        out["stages"] = sorted(sp["name"] for sp in
                               by_tier["leader"]["spans"]
                               if sp["name"].startswith("serving."))
        r = await router_req(
            R, router, "POST", "/api/v1/namespaces/team-a/pods",
            body={"apiVersion": "v1", "kind": "Pod",
                  "metadata": {"name": "p1", "namespace": "team-a"}},
            headers=[("X-Trace-Id", TID2)])
        out["create"] = (r.status, r.headers.get("X-Authz-Shard"))
        r = await router_req(R, router, "GET", "/debug/fleet")
        merged = json.loads(r.body)
        traces = {t["trace_id"]: t for t in merged["traces"]}
        out["fleet"] = (r.status, merged["enabled"], merged["tier"],
                        [(m["url"], m["error"]) for m in merged["members"]],
                        sorted(merged["tiers"]))
        out["traces"] = {}
        for tid in (TID, TID2):
            t = traces[tid]
            out["traces"][tid] = (
                sorted(t["tiers"]), t["tier_count"], t["aligned_by_wall"],
                t["wall_fallbacks"],
                abs(t["attributed_ms"] - t["duration_ms"]) <= 0.05,
                "authn" in t["serving_stages_ms"].get("leader", {}))
        r = await router_req(R, router, "GET", "/debug/tail")
        tail = json.loads(r.body)
        out["tail"] = (r.status, tail["enabled"], tail["tier"],
                       tail["requests"] >= 2)
        return out

    return asyncio.run(asyncio.wait_for(go(), 60))


@pytest.mark.parametrize("combo", ["port-embedded", "port-torch",
                                   "port-router-ref-leaders",
                                   "ref-router-port-leaders"])
def test_one_trace_spans_router_and_shard_leader(combo, tmp):
    R, L, url = {
        "port-embedded": (PORT, PORT, "embedded://"),
        "port-torch": (PORT, PORT, CPU),
        "port-router-ref-leaders": (PORT, REF, "embedded://"),
        "ref-router-port-leaders": (REF, PORT, CPU),
    }[combo]
    got = continuity(R, L, url, tmp)
    for P in (PORT, REF):
        P.tracing.RECORDER.drain()
    want = continuity(REF, REF, "embedded://", os.path.join(tmp, "ref"))
    assert got == want
    assert got["tiers"] == ["leader", "router"] and got["linked"]
    assert got["tier_path"] == "router>leader"
    assert got["wire"] == (True, "router", 16)
    assert "serving.authn" in got["stages"]
    for t in got["traces"].values():
        assert t[:2] == (["leader", "router"], 2) and t[4] and t[5]


def test_fleet_and_traces_need_an_identity(tmp):
    router, *_ = make_fleet(PORT, PORT, "embedded://", tmp)

    async def go():
        return [(await router_req(PORT, router, "GET", p, user="")).status
                for p in ("/debug/fleet", "/debug/tail", "/debug/traces")]

    assert asyncio.run(go()) == [401, 401, 401]


def _masked(body: bytes) -> bytes:
    """The body with the fake apiserver's per-object uid and creation
    time (random and wall-clock) replaced by placeholders."""
    import re
    body = re.sub(rb'"uid": "[^"]*"', b'"uid": "UID"', body)
    return re.sub(rb'"creationTimestamp": "[^"]*"',
                  b'"creationTimestamp": "TS"', body)


def test_switch_off_no_headers_and_byte_identical(tmp):
    """TIMELINE off (the reference's Timeline gate off): the router sends
    no fleet header, a client-injected one passes through untouched and
    is never read, and the bodies equal the reference's byte for byte
    (the fake's random uid and creation time masked) and the switch-on
    run's."""
    def observe(P, sub):
        router, _s0, _s1, cap0, _c1 = make_fleet(P, P, "embedded://",
                                                  os.path.join(tmp, sub))

        async def go():
            on = await router_req(P, router, "GET",
                                  "/api/v1/namespaces/team-a")
            on_hdr = "x-authz-trace-id" in cap0.seen[-1]
            P.set_timeline(False)
            P.tracing.RECORDER.drain()
            off = await router_req(P, router, "GET",
                                   "/api/v1/namespaces/team-a")
            hdrs = {k for k in cap0.seen[-1] if k.startswith("x-authz-")}
            off2 = await router_req(
                P, router, "GET", "/api/v1/namespaces/team-a",
                headers=[("X-Authz-Trace-Id", TID),
                         ("X-Authz-Parent-Span", HOP_A),
                         ("X-Authz-Tier-Path", "router")])
            passed = cap0.seen[-1].get("x-authz-trace-id")
            joined = segments(TID)
            tiered = [t for t in P.tracing.RECORDER.snapshot()
                      if "tier" in t["attrs"]]
            return (on.status, on_hdr, off.status, sorted(hdrs), passed,
                    joined, tiered, _masked(off.body), on.body == off.body,
                    off2.headers.get("X-Trace-Id") != TID)

        try:
            return asyncio.run(asyncio.wait_for(go(), 60))
        finally:
            P.set_timeline(True)

    got, want = observe(PORT, "port"), observe(REF, "ref")
    assert got == want
    assert got[:7] == (200, True, 200, [], TID, [], [])
    assert got[8] and got[9]


# -- a follower forwarding to its leader ---------------------------------------------


class LeaderLink:
    def __init__(self, proxy):
        self.proxy = proxy

    async def round_trip(self, req):
        return await self.proxy.handler(req)


def make_leader(P, url, tmp):
    kube = P.kubefake.FakeKubeApiServer()
    for i in range(4):
        kube.seed("", "v1", "namespaces", {"metadata": {"name": f"ns{i}"}})
    leader = P.server.ProxyServer(P.server.Options(
        spicedb_endpoint=url, bootstrap=P.endpoints.Bootstrap(
            schema_text=SCHEMA),
        rules_yaml=RULES, upstream_transport=P.httpcore.HandlerTransport(kube),
        data_dir=os.path.join(tmp, "leader"), wal_fsync="never"))
    leader.endpoint.store.bulk_load(
        [P.rel(f"namespace:ns{i}#creator@user:alice") for i in range(4)]
        + [P.rel("podns:ns0#creator@user:alice")])
    return leader, kube


def make_follower(P, url, leader, kube, **kw):
    return P.server.ProxyServer(P.server.Options(
        spicedb_endpoint=url, bootstrap=P.endpoints.Bootstrap(
            schema_text=SCHEMA),
        rules_yaml=RULES, upstream_transport=P.httpcore.HandlerTransport(kube),
        replicate_from="http://leader.test",
        leader_transport=LeaderLink(leader), **kw))


def follower_continuity(P, url, tmp):
    leader, kube = make_leader(P, url, tmp)
    follower = make_follower(
        P, url, leader, kube, replica_wait_ms=30.0,
        fleet_peers=["http://leader.test"],
        peer_transports={"http://leader.test": LeaderLink(leader)})

    async def go():
        out = {}
        await follower.replication.sync_once()
        leader.enable_dual_writes()
        client = follower.get_embedded_client("alice")
        resp = await client.post(
            "/api/v1/namespaces/ns0/pods",
            {"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": "p1", "namespace": "ns0"}},
            headers=[("X-Trace-Id", TID)])
        out["create"] = (resp.status, resp.headers.get(
            "X-Authz-Forwarded-To"))
        by_tier = {t["attrs"].get("tier"): t for t in segments(TID)}
        hop_sp = next(sp for sp in by_tier["follower"]["spans"]
                      if sp["name"] == "hop.forward_to_leader")
        out["create_trace"] = (
            sorted(by_tier), by_tier["follower"]["attrs"]["tier_path"],
            by_tier["leader"]["attrs"]["tier_path"],
            by_tier["leader"]["attrs"]["parent_span"]
            == hop_sp["attrs"]["span_id"])
        forwarded = [e for e in leader.audit.recent()
                     if e.get("tier_path") == "follower>leader"]
        out["audit"] = (bool(forwarded),
                        any(e["trace_id"] == TID for e in forwarded))
        rev = await leader.endpoint.write_relationships([
            P.types.RelationshipUpdate(P.types.UpdateOp.TOUCH, P.rel(
                "namespace:ns1#viewer@user:zed"))])
        resp = await follower.get_embedded_client("zed").get(
            "/api/v1/namespaces",
            headers=[(P.repl.MIN_REVISION_HEADER, str(rev)),
                     ("X-Trace-Id", TID2)])
        out["fresh_read"] = (resp.status, resp.headers.get(
            "X-Authz-Forwarded-To"))
        by_tier = {t["attrs"].get("tier"): t for t in segments(TID2)}
        out["fresh_trace"] = (sorted(by_tier),
                              by_tier["leader"]["attrs"]["tier_path"])
        resp = await client.get("/debug/fleet")
        merged = json.loads(resp.body)
        t = {x["trace_id"]: x for x in merged["traces"]}[TID]
        out["fleet"] = (resp.status, merged["enabled"], merged["tier"],
                        sorted(t["tiers"]),
                        abs(t["attributed_ms"] - t["duration_ms"]) <= 0.05,
                        [(m["url"], m["error"], m["traces"] >= 1)
                         for m in merged["members"]])
        resp = await client.get("/debug/tail")
        tail = json.loads(resp.body)
        out["tail"] = (resp.status, tail["enabled"], tail["tier"])
        return out

    return asyncio.run(asyncio.wait_for(go(), 60))


@pytest.mark.parametrize("url", ["embedded://", CPU])
def test_follower_forwards_join_the_trace(url, tmp):
    got = follower_continuity(PORT, url, tmp)
    for P in (PORT, REF):
        P.tracing.RECORDER.drain()
    want = follower_continuity(REF, "embedded://", os.path.join(tmp, "r"))
    assert got == want
    assert got["create"][1] == "leader"
    assert got["create_trace"] == (["follower", "leader"], "follower",
                                   "follower>leader", True)
    assert got["audit"] == (True, True)
    assert got["fresh_trace"] == (["follower", "leader"], "follower>leader")
    assert got["fleet"][:5] == (200, True, "follower",
                                ["follower", "leader"], True)
    assert got["tail"] == (200, True, "follower")


def test_follower_sync_carries_the_tier_path(tmp):
    """A follower's sync calls carry X-Authz-Tier-Path `follower` (no
    trace id outside a request), as the reference's do."""
    def observe(P, sub):
        leader, kube = make_leader(P, "embedded://", os.path.join(tmp, sub))
        cap = Capturing(LeaderLink(leader))
        follower = P.server.ProxyServer(P.server.Options(
            spicedb_endpoint="embedded://", bootstrap=P.endpoints.Bootstrap(
                schema_text=SCHEMA),
            rules_yaml=RULES,
            upstream_transport=P.httpcore.HandlerTransport(kube),
            replicate_from="http://leader.test", leader_transport=cap))
        asyncio.run(asyncio.wait_for(follower.replication.sync_once(), 60))
        return sorted({(k, v) for h in cap.seen for k, v in h.items()
                       if k.startswith("x-authz-")})

    assert observe(PORT, "p") == observe(REF, "r") == [
        ("x-authz-tier-path", "follower")]


# -- chip_smoke.py phase 23 on the CPU, at a small size -------------------------


def test_chip_smoke_phase23_rehearsal_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 23 runs on phase 21's lineages (its (a)-(f)
    at a small size, kept) with the shard leaders and the router as
    processes on `torch://?device=cpu`: the open-loop window through the
    router, the merged traces and the tail report, the oracle sample, the
    killed leader's errored entry and the exit codes all hold (the
    leaders' launch counts apart: the CPU twins count none)."""
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
                         ("SHARD_ISOLATION_LISTS", 16),
                         ("FLEET_WINDOW_S", 5.0), ("FLEET_RATE", 20.0),
                         ("FLEET_KILL_WINDOW_S", 3.0),
                         ("FLEET_KILL_AT_S", 1.0),
                         ("FLEET_ORACLE_LISTS", 2),
                         ("FLEET_ORACLE_GETS", 10)):
        monkeypatch.setattr(smoke, const, value)
    monkeypatch.setenv("PYTHONPATH", str(root))
    w = workloads.multitenant_1m(n_pods=8_000, n_tuples=30_000,
                                 n_users=500, n_namespaces=200)
    out = smoke.shard_path(w, "cpu", device="cpu", keep=True)
    f21 = out.pop("fleet")
    try:
        got = smoke.fleet_path(f21, "cpu", device="cpu")
    finally:
        shutil.rmtree(f21["tmp"], ignore_errors=True)
    assert [m[0] for m in got["members"]] == ["leader-0", "leader-1",
                                              "router"]
    assert all("cpu" in m[2] for m in got["members"][:2])
    assert got["report"]["achieved"] == got["report"]["offered"] > 0
    assert {"router", "leader"} <= set(got["tiers"])
