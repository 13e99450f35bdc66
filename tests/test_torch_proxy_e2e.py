"""The port's proxy read path held against the reference proxy.

Every read scenario of tests/test_proxy_e2e.py (all but
TestSustainedCreates, a dual-write scenario) and the read cases of
tests/test_e2e_parity.py's TestCustomResourceType run through the port's
`ProxyServer` on four endpoints — `torch://?device=cpu` (batched),
`torch://?device=cpu&dispatch=direct`, `torch://?device=cpu&kernel=
segment` and `embedded://` — and through the reference `ProxyServer`
over `jax://`, each on a fake kube-apiserver holding a copy of the same
seeded objects.  Responses must be equal: status, headers and content
type; JSON bodies after decoding, protobuf bodies byte for byte.  One
header is left out of the comparison, `X-Trace-Id` (a fresh id per
request).  A small multitenant cell (`multitenant_1m` at 2,000 pods)
sends 32 users' lists, namespaced lists, 200 gets and postfilter lists
through both.  An Update-rule request gets the same 500 Status from both
packages, and a denied request with `?explain=1` the same witness in its
audit event, `backend` apart ("torch"/"embedded" against "jax").
"""

import asyncio
import copy
import dataclasses
import importlib
import json
import random
from pathlib import Path

import pytest

from test_e2e_parity import CRD_RULES
from test_e2e_parity import SCHEMA as CRD_SCHEMA
from test_proxy_e2e import RULES, SCHEMA
from test_proxy_e2e import make_proxy as ref_make_proxy

ROOT = Path(__file__).resolve().parents[1]
PORT_URLS = ["torch://?device=cpu", "torch://?device=cpu&dispatch=direct",
             "torch://?device=cpu&kernel=segment", "embedded://"]
# response headers whose values are fresh per request
IGNORED_HEADERS = {"x-trace-id"}
PROTO = "application/vnd.kubernetes.protobuf"
TABLE = "as=Table;v=v1;g=meta.k8s.io"


class Pkg:
    """The modules of one package that a proxy scenario needs."""

    def __init__(self, root: str):
        def mod(name):
            return importlib.import_module(f"{root}.{name}")
        self.kubefake = mod("kubefake.apiserver")
        self.httpcore = mod("proxy.httpcore")
        self.server = mod("proxy.server")
        self.endpoints = mod("spicedb.endpoints")
        self.types = mod("spicedb.types")
        self.proxyrule = mod("config.proxyrule")
        self.engine = mod("rules.engine")

    def rels(self, texts):
        return [self.types.parse_relationship(t) for t in texts]

    def touch(self, text):
        return self.types.RelationshipUpdate(
            self.types.UpdateOp.TOUCH, self.types.parse_relationship(text))


REF = Pkg("spicedb_kubeapi_proxy_tpu")
PORT = Pkg("spicedb_kubeapi_proxy_tpu_torch")


def run(coro):
    return asyncio.run(coro)


def clone_kube(src, pkg: Pkg):
    """A `pkg` fake kube-apiserver holding a copy of `src`'s types,
    objects and resource version."""
    kube = pkg.kubefake.FakeKubeApiServer(types=[
        pkg.kubefake.ResourceType(**dataclasses.asdict(t))
        for t in src.types.values()])
    kube.objects = copy.deepcopy(src.objects)
    kube._rv = src._rv
    return kube


def make_port_proxy(url, kube_src, schema=SCHEMA, rules=RULES,
                    rels=(), **opts):
    kube = clone_kube(kube_src, PORT)
    proxy = PORT.server.ProxyServer(PORT.server.Options(
        spicedb_endpoint=url,
        bootstrap=PORT.endpoints.Bootstrap(schema_text=schema),
        rules_yaml=rules,
        upstream_transport=PORT.httpcore.HandlerTransport(kube), **opts))
    proxy.endpoint.store.bulk_load(PORT.rels(rels))
    return proxy, kube


# the relationships tests/test_proxy_e2e.py's make_proxy seeds
E2E_RELS = ["namespace:team-a#creator@user:alice",
            "namespace:team-b#creator@user:bob",
            "pod:team-a/p0#creator@user:alice",
            "pod:team-a/p2#creator@user:alice",
            "pod:team-b/p1#creator@user:bob",
            "pod:team-b/p3#creator@user:bob"]


def snap(resp):
    """(status, headers, body) with the body decoded when it is JSON."""
    headers = sorted((k.lower(), v) for k, v in resp.headers.items()
                     if k.lower() not in IGNORED_HEADERS)
    ct = resp.headers.get("Content-Type", "")
    body = resp.body
    if body and "json" in ct and "protobuf" not in ct:
        body = json.loads(body)
    return resp.status, headers, body


async def send(proxy, reqs, concurrent=False):
    """Each request (user, groups, target, headers) through the embedded
    client; sequential unless `concurrent`."""
    async def one(user, groups, target, headers):
        client = proxy.get_embedded_client(user=user, groups=groups)
        return snap(await client.get(target, headers=headers))
    calls = [one(*r) for r in reqs]
    if concurrent:
        return list(await asyncio.gather(*calls))
    return [await c for c in calls]


def req(user, target, accept=None, groups=None):
    return (user, groups or [], target,
            [("Accept", accept)] if accept else None)


# -- scenarios of tests/test_proxy_e2e.py ------------------------------------
# each: async fn(proxy, kube, pkg) -> list of observations

async def sc_get(proxy, kube, pkg):
    return await send(proxy, [
        req("alice", "/api/v1/namespaces/team-a/pods/p0"),
        req("alice", "/api/v1/namespaces/team-b/pods/p1"),
        req("alice", "/api/v1/namespaces/team-a"),
        req("alice", "/api/v1/namespaces/team-b"),
        req("", "/api/v1/namespaces/team-a/pods/p0"),
        req("alice", "/api/v1/nodes/n1"),
    ])


async def sc_list(proxy, kube, pkg):
    return await send(proxy, [
        req("alice", "/api/v1/pods"), req("bob", "/api/v1/pods"),
        req("mallory", "/api/v1/pods"),
        req("alice", "/api/v1/namespaces"),
        req("alice", "/api/v1/namespaces/team-a/pods"),
        req("alice", "/api/v1/pods", f"application/json;{TABLE}"),
        req("alice", "/api/v1/secrets"),
    ])


async def sc_list_concurrent(proxy, kube, pkg):
    return await send(proxy, [req(u, "/api/v1/pods")
                              for u in ("alice", "bob", "mallory") * 4],
                      concurrent=True)


async def sc_proto(proxy, kube, pkg):
    return await send(proxy, [
        req("alice", "/api/v1/pods", PROTO),
        req("bob", "/api/v1/pods", PROTO),
        req("mallory", "/api/v1/pods", PROTO),
        req("alice", "/api/v1/namespaces/team-a/pods/p0", PROTO),
        req("alice", "/api/v1/namespaces/team-b/pods/p1", PROTO),
        req("alice", "/api/v1/pods", f"{PROTO};{TABLE}"),
    ])


async def sc_garbage_proto(proxy, kube, pkg):
    orig = kube._list

    async def corrupt_list(req_, t, key, ns, query):
        resp = await orig(req_, t, key, ns, query)
        if kube._wants_proto(req_):
            resp.body = resp.body[:-4]  # truncate mid-record
            resp.headers.set("Content-Length", str(len(resp.body)))
        return resp

    kube._list = corrupt_list
    return await send(proxy, [req("alice", "/api/v1/pods", PROTO)])


async def sc_cel(proxy, kube, pkg):
    return await send(proxy, [
        req("root", "/api/v1/namespaces/team-a/configmaps/cm",
            groups=["admins"]),
        req("root", "/api/v1/namespaces/team-a/configmaps/cm",
            groups=["devs"]),
    ])


async def sc_always_allow(proxy, kube, pkg):
    return await send(proxy, [req("nobody", p) for p in
                              ("/api", "/apis", "/openapi/v2")]
                      + [req("", "/readyz"), req("", "/livez")])


async def sc_matcher_swap(proxy, kube, pkg):
    out = await send(proxy, [req("alice", "/api/v1/namespaces/team-a/pods/p0")])
    proxy.matcher = pkg.engine.MapMatcher(pkg.proxyrule.parse("""
apiVersion: authzed.com/v1alpha1
kind: ProxyRule
metadata: {name: deny-all-gets}
match: [{apiVersion: v1, resource: pods, verbs: [get]}]
check: [{tpl: "pod:{{namespacedName}}#view@user:nobody-has-this"}]
"""))
    return out + await send(proxy, [
        req("alice", "/api/v1/namespaces/team-a/pods/p0")])


async def sc_update_rule(proxy, kube, pkg):
    """A create that matches the create-pods Update rule: without a
    dual-write engine both packages answer 500."""
    client = proxy.get_embedded_client(user="alice")
    resp = await client.post("/api/v1/namespaces/team-a/pods", {
        "kind": "Pod", "apiVersion": "v1",
        "metadata": {"name": "web-0", "namespace": "team-a"}})
    return [snap(resp), sorted(kube.objects[("", "v1", "pods")]["team-a"])]


def _explain_events(proxy):
    """The explain payloads of the audit ring's events, oldest first,
    with `backend` (the evaluating package) left out."""
    out = []
    for ev in reversed(proxy.audit.recent()):
        w = ev.get("explain")
        if not w:
            continue
        if "decision" in w:
            w = {k: v for k, v in w.items() if k != "backend"}
        else:
            w = {oid: {k: v for k, v in x.items() if k != "backend"}
                 for oid, x in w.items()}
        out.append((ev["stage"], ev["decision"], ev["rule"], w))
    return out


async def sc_explain(proxy, kube, pkg):
    """Denied get and filtered list with `?explain=1`: the response and
    the denial's witness."""
    out = await send(proxy, [
        req("alice", "/api/v1/namespaces/team-b/pods/p1?explain=1"),
        req("alice", "/api/v1/pods?explain=1"),
        req("bob", "/api/v1/namespaces/team-a?explain=1"),
    ])
    return out + [_explain_events(proxy)]


def _seed(kube, name, ns):
    """A pod with fixed uid and timestamp, so two fakes hold equal
    objects."""
    kube.seed("", "v1", "pods", {"metadata": {
        "name": name, "namespace": ns, "uid": f"uid-{ns}-{name}",
        "creationTimestamp": "2026-01-01T00:00:00Z"}})
    return kube.objects[("", "v1", "pods")][ns][name]


async def sc_watch(proxy, kube, pkg):
    """TestWatch: grant then event -> replayed; an unauthorized event is
    buffered; a late grant flushes it."""
    client = proxy.get_embedded_client(user="alice")
    resp = await client.get("/api/v1/pods?watch=true")
    out = [(resp.status, resp.stream is not None,
            resp.headers.get("Content-Type"))]
    frames: asyncio.Queue = asyncio.Queue()

    async def consume():
        async for frame in resp.stream:
            await frames.put(json.loads(frame))

    task = asyncio.ensure_future(consume())
    key = ("", "v1", "pods")
    try:
        await proxy.endpoint.write_relationships([pkg.touch(
            "pod:team-a/pnew#creator@user:alice")])
        await asyncio.sleep(0.6)  # let the store watch propagate
        await kube._notify(key, "ADDED", _seed(kube, "pnew", "team-a"))
        out.append(await asyncio.wait_for(frames.get(), 5))
        await kube._notify(key, "ADDED", _seed(kube, "phidden", "team-b"))
        try:
            out.append(await asyncio.wait_for(frames.get(), 0.7))
        except asyncio.TimeoutError:
            out.append("buffered")
        await proxy.endpoint.write_relationships([pkg.touch(
            "pod:team-b/phidden#viewer@user:alice")])
        out.append(await asyncio.wait_for(frames.get(), 5))
    finally:
        task.cancel()
    return out


SCENARIOS = {
    "get": sc_get, "list": sc_list, "list_concurrent": sc_list_concurrent,
    "proto": sc_proto, "garbage_proto": sc_garbage_proto, "cel": sc_cel,
    "always_allow": sc_always_allow, "matcher_swap": sc_matcher_swap,
    "update_rule": sc_update_rule, "explain": sc_explain, "watch": sc_watch,
}

_REF_RUNS: dict = {}


def ref_run(name):
    """(kube objects before the run, observations) of scenario `name` on
    the reference proxy over jax://, computed once."""
    if name not in _REF_RUNS:
        proxy, kube = ref_make_proxy("jax://")
        before = clone_kube(kube, REF)
        _REF_RUNS[name] = (before, run(SCENARIOS[name](proxy, kube, REF)))
    return _REF_RUNS[name]


@pytest.mark.parametrize("url", PORT_URLS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name, url):
    kube_src, want = ref_run(name)
    proxy, kube = make_port_proxy(url, kube_src, rels=E2E_RELS)
    got = run(SCENARIOS[name](proxy, kube, PORT))
    assert got == want


def test_scenarios_hold_the_reference_assertions():
    """The reference's own expectations, read off its observations, so a
    parity pass cannot be two equal wrong answers."""
    def names(body):
        return {i["metadata"]["name"] for i in body["items"]}
    get = ref_run("get")[1]
    assert [s for s, _, _ in get] == [200, 403, 200, 403, 401, 403]
    lst = ref_run("list")[1]
    assert [names(b) for _, _, b in lst[:3]] == [
        {"p0", "p2"}, {"p1", "p3"}, set()]
    assert names(lst[3][2]) == {"team-a"}
    assert {r["object"]["metadata"]["name"]
            for r in lst[5][2]["rows"]} == {"p0", "p2"}
    assert names(lst[6][2]) == {"p0", "p2"}
    assert ref_run("garbage_proto")[1][0][0] == 502
    assert [s for s, _, _ in ref_run("cel")[1]] == [200, 403]
    assert [s for s, _, _ in ref_run("matcher_swap")[1]] == [200, 403]
    upd = ref_run("update_rule")[1]
    assert upd[0][0] == 500
    assert upd[0][2]["message"] == "update engine not configured"
    watch = ref_run("watch")[1]
    assert watch[1]["object"]["metadata"]["name"] == "pnew"
    assert watch[2] == "buffered"
    assert watch[3]["object"]["metadata"]["name"] == "phidden"
    stages = [(s, d) for s, d, _, _ in ref_run("explain")[1][-1]]
    assert ("check", "denied") in stages
    assert ("respfilter", "denied") in stages


# -- TestCustomResourceType (tests/test_e2e_parity.py), read cases ------------

def _crd_ref():
    kf = REF.kubefake
    kube = kf.FakeKubeApiServer(types=list(kf.BUILTIN_TYPES) + [
        kf.ResourceType("example.com", "v1", "testresources",
                        "TestResource", namespaced=True,
                        short_names=("tr",))])
    for name, ns in (("alpha", "team-a"), ("beta", "team-b")):
        kube.seed("example.com", "v1", "testresources", {
            "metadata": {"name": name, "namespace": ns},
            "spec": {"message": f"hello {name}"}})
    proxy = REF.server.ProxyServer(REF.server.Options(
        spicedb_endpoint="jax://",
        bootstrap=REF.endpoints.Bootstrap(schema_text=CRD_SCHEMA),
        rules_yaml=CRD_RULES,
        upstream_transport=REF.httpcore.HandlerTransport(kube)))
    proxy.endpoint.store.bulk_load(REF.rels(CRD_RELS))
    return proxy, kube


CRD_RELS = ["testresource:team-a/alpha#viewer@user:alice"]
CRD_BASE = "/apis/example.com/v1"
CRD_REQS = [req("alice", f"{CRD_BASE}/namespaces/team-a/testresources/alpha"),
            req("alice", f"{CRD_BASE}/namespaces/team-b/testresources/beta"),
            req("alice", f"{CRD_BASE}/testresources"),
            req("bob", f"{CRD_BASE}/testresources"),
            req("alice", f"{CRD_BASE}/anothertestresources")]


@pytest.fixture(scope="module")
def crd_ref():
    proxy, kube = _crd_ref()
    before = clone_kube(kube, REF)
    return before, run(send(proxy, CRD_REQS))


@pytest.mark.parametrize("url", PORT_URLS)
def test_custom_resource_type_matches_reference(url, crd_ref):
    kube_src, want = crd_ref
    assert [s for s, _, _ in want] == [200, 403, 200, 200, 403]
    assert {i["metadata"]["name"] for i in want[2][2]["items"]} == {"alpha"}
    proxy, _ = make_port_proxy(url, kube_src, schema=CRD_SCHEMA,
                               rules=CRD_RULES, rels=CRD_RELS)
    assert run(send(proxy, CRD_REQS)) == want


# -- a small multitenant cell --------------------------------------------------

MT_KW = dict(n_pods=2_000, n_tuples=20_000, n_users=500, n_namespaces=200)
MT_EVENTS = 100


def _mt_kube(pkg):
    kube = pkg.kubefake.FakeKubeApiServer()
    stamp = "2026-01-01T00:00:00Z"
    for n in range(MT_KW["n_namespaces"]):
        kube.seed("", "v1", "namespaces", {"metadata": {
            "name": f"ns{n}", "uid": f"uid-ns{n}",
            "creationTimestamp": stamp}})
    for p in range(MT_KW["n_pods"]):
        ns = f"ns{p % MT_KW['n_namespaces']}"
        kube.seed("", "v1", "pods", {"metadata": {
            "name": f"p{p}", "namespace": ns, "uid": f"uid-p{p}",
            "creationTimestamp": stamp}})
    for e in range(MT_EVENTS):
        ns = f"ns{e % MT_KW['n_namespaces']}"
        kube.seed("", "v1", "events", {"metadata": {
            "name": f"ev{e}", "namespace": ns, "uid": f"uid-ev{e}",
            "creationTimestamp": stamp}})
    return kube


def _mt_reqs(users, pods):
    rng = random.Random(14)
    reqs = [req(u, "/api/v1/pods") for u in users]
    reqs += [req(u, f"/api/v1/namespaces/ns{rng.randrange(200)}/pods")
             for u in users[:8]]
    reqs += [req(rng.choice(users), f"/api/v1/namespaces/{p}")
             for p in ("ns0", "ns1", "ns7")]
    reqs += [req(u, "/api/v1/namespaces") for u in users[:4]]
    for _ in range(200):
        ns, name = rng.choice(pods).split("/")
        reqs.append(req(rng.choice(users),
                        f"/api/v1/namespaces/{ns}/pods/{name}"))
    reqs += [req(u, "/api/v1/events") for u in users[:4]]
    return reqs


def _mt_proxy(pkg, url):
    from spicedb_kubeapi_proxy_tpu_torch.models import workloads
    w = workloads.multitenant_1m(**MT_KW)
    proxy = pkg.server.ProxyServer(pkg.server.Options(
        spicedb_endpoint=url,
        bootstrap=pkg.endpoints.Bootstrap(w.schema_text,
                                          "\n".join(w.relationships)),
        rules_yaml=(ROOT / "deploy" / "rules.yaml").read_text(),
        upstream_transport=pkg.httpcore.HandlerTransport(_mt_kube(pkg))))
    pods = [f"ns{p % MT_KW['n_namespaces']}/p{p}"
            for p in range(0, MT_KW["n_pods"], 7)]
    return proxy, _mt_reqs(w.subjects[:32], pods)


async def _mt_traffic(proxy, reqs):
    # the 32 lists concurrently (one fused batch on a batched endpoint),
    # the rest in order
    return (await send(proxy, reqs[:32], concurrent=True)
            + await send(proxy, reqs[32:]))


@pytest.fixture(scope="module")
def mt_ref():
    proxy, reqs = _mt_proxy(REF, "jax://")
    return run(_mt_traffic(proxy, reqs))


@pytest.mark.parametrize("url", PORT_URLS)
def test_multitenant_cell_matches_reference(url, mt_ref):
    statuses = [s for s, _, _ in mt_ref]
    assert statuses[:32] == [200] * 32
    assert {200, 403} <= set(statuses[32:])
    assert sum(len(b["items"]) for _, _, b in mt_ref[:32]) > 0
    proxy, reqs = _mt_proxy(PORT, url)
    assert run(_mt_traffic(proxy, reqs)) == mt_ref
