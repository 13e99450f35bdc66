"""The port's proxy with dual writes, end to end, held against the
reference proxy.

- All 13 cases of tests/test_deploy_demo.py over deploy/rules.yaml and
  deploy/bootstrap.yaml (check-gated gets, prefiltered lists, the
  postfilter, the CEL gate, and the dual-write creates and deletes: the
  tenant binding from a label, its precondition, the shareWith fan-out,
  deleteByFilter teardown): the port on `torch://?device=cpu` and
  `embedded://` against the reference over `jax://`, computed once a
  case.
- tests/test_e2e_parity.py's TestConcurrentDualWriteMutex under both
  lock modes and TestCustomResourceType::test_dual_write_create, against
  the reference over `embedded://` (what those tests run).
- tests/test_proxy_e2e.py's TestSustainedCreates: 25 creates, each read
  back by its creator's list, on `torch://?device=cpu&dispatch=direct`
  with no rebuild and at least 25 spare-row assignments, each list equal
  to the reference's over `jax://`.

Statuses and decoded bodies compare exactly after masking uuids and
wall-clock stamps; store relationships compare without the workflow,
lock and activity tuples, whose counts compare apart
(tests/test_torch_dualwrite.py).
"""

import json
import pathlib

import pytest

from test_e2e_parity import CRD_RULES, NS_CREATE_RULES_TMPL
from test_e2e_parity import SCHEMA as PARITY_SCHEMA
from test_proxy_e2e import RULES as E2E_RULES
from test_proxy_e2e import SCHEMA as E2E_SCHEMA
from test_torch_dualwrite import (
    PORT,
    REF,
    final_state,
    run,
    snap,
    split_rels,
)
from test_torch_proxy_e2e import E2E_RELS

DEPLOY = pathlib.Path(__file__).resolve().parent.parent / "deploy"
PORT_URLS = ["torch://?device=cpu", "embedded://"]


def names(body) -> list:
    return sorted(i["metadata"]["name"] for i in body["items"])


# -- tests/test_deploy_demo.py ---------------------------------------------

def demo_proxy(pkg, url):
    kube = pkg.kubefake.FakeKubeApiServer()
    kube.seed("", "v1", "namespaces", {"metadata": {"name": "acme-prod"}})
    kube.seed("", "v1", "namespaces", {"metadata": {"name": "initech-dev"}})
    for pod in ("api-0", "api-1"):
        kube.seed("", "v1", "pods",
                  {"metadata": {"name": pod, "namespace": "acme-prod"}})
    kube.seed("", "v1", "pods",
              {"metadata": {"name": "tps-report", "namespace": "initech-dev"}})
    kube.seed("", "v1", "events",
              {"metadata": {"name": "ev-a", "namespace": "acme-prod"}})
    kube.seed("", "v1", "events",
              {"metadata": {"name": "ev-i", "namespace": "initech-dev"}})
    kube.seed("", "v1", "configmaps",
              {"metadata": {"name": "cm", "namespace": "acme-prod"}})
    proxy = pkg.server.ProxyServer(pkg.server.Options(
        spicedb_endpoint=url,
        bootstrap=pkg.endpoints.Bootstrap.from_file(
            str(DEPLOY / "bootstrap.yaml")),
        rules_yaml=(DEPLOY / "rules.yaml").read_text(),
        upstream_transport=pkg.httpcore.HandlerTransport(kube),
    ))
    proxy.enable_dual_writes()
    return proxy, kube


async def req(proxy, user, method, target, obj=None, groups=None):
    client = proxy.get_embedded_client(user=user, groups=groups or [])
    body = json.dumps(obj).encode() if obj is not None else b""
    return snap(await client.request(method, target, body=body))


PODS = "/api/v1/pods"
ACME_PODS = "/api/v1/namespaces/acme-prod/pods"


async def demo_admin_arrow(proxy):
    return [await req(proxy, "ada", "GET", PODS),
            await req(proxy, "ada", "GET", f"{ACME_PODS}/api-0"),
            await req(proxy, "ada", "GET",
                      "/api/v1/namespaces/initech-dev/pods/tps-report")]


async def demo_nested_group(proxy):
    return [await req(proxy, "grace", "GET", PODS),
            await req(proxy, "grace", "GET", "/api/v1/namespaces")]


async def demo_banned(proxy):
    return [await req(proxy, "mallory", "GET", PODS),
            await req(proxy, "mallory", "GET", f"{ACME_PODS}/api-1")]


async def demo_direct_viewer(proxy):
    return [await req(proxy, "peek", "GET", PODS)]


async def demo_event_postfilter(proxy):
    return [await req(proxy, "ada", "GET", "/api/v1/events")]


async def demo_operator_cel(proxy):
    cm = "/api/v1/namespaces/acme-prod/configmaps/cm"
    return [await req(proxy, "ops", "GET", cm, groups=["system:operators"]),
            await req(proxy, "ada", "GET", cm)]


def namespace(name, tenant=None):
    meta = {"name": name}
    if tenant:
        meta["labels"] = {"tenant": tenant}
    return {"apiVersion": "v1", "kind": "Namespace", "metadata": meta}


def pod(name, share=()):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "acme-prod"},
            "spec": {"shareWith": list(share)}}


async def demo_ns_create_binds_tenant(proxy):
    return [await req(proxy, "ada", "POST", "/api/v1/namespaces",
                      namespace("acme-stage", "acme")),
            await req(proxy, "ada", "GET", "/api/v1/namespaces/acme-stage")]


async def demo_ns_create_denied(proxy):
    return [await req(proxy, "bill", "POST", "/api/v1/namespaces",
                      namespace("sneaky", "acme"))]


async def demo_ns_create_unlabeled(proxy):
    return [await req(proxy, "ada", "POST", "/api/v1/namespaces",
                      namespace("unlabeled"))]


async def demo_rebind_precondition(proxy):
    return [await req(proxy, "bill", "POST", "/api/v1/namespaces",
                      namespace("acme-prod", "initech"))]


async def demo_pod_launch_fanout(proxy):
    return [await req(proxy, "ada", "POST", ACME_PODS,
                      pod("api-2", ("guest1", "guest2"))),
            await req(proxy, "guest1", "GET", PODS)]


async def demo_pod_retire(proxy):
    return [await req(proxy, "ada", "POST", ACME_PODS,
                      pod("api-3", ("guest9",))),
            await req(proxy, "ada", "DELETE", f"{ACME_PODS}/api-3")]


async def demo_namespace_teardown(proxy):
    return [await req(proxy, "peek", "DELETE",
                      "/api/v1/namespaces/initech-dev")]


DEMO = {
    "admin_reaches_pods_through_tenant_arrow": demo_admin_arrow,
    "nested_group_member_reaches_pods_depth4": demo_nested_group,
    "banned_user_excluded_from_one_pod": demo_banned,
    "direct_viewer_scoped_to_own_namespace": demo_direct_viewer,
    "event_postfilter_by_namespace": demo_event_postfilter,
    "operator_cel_gate": demo_operator_cel,
    "namespace_create_binds_tenant_from_label": demo_ns_create_binds_tenant,
    "namespace_create_denied_without_tenant_access": demo_ns_create_denied,
    "namespace_create_without_label_unmatched": demo_ns_create_unlabeled,
    "rebind_precondition_blocks_second_tenant": demo_rebind_precondition,
    "pod_launch_with_sharewith_fanout": demo_pod_launch_fanout,
    "pod_retire_deletes_all_rels_by_filter": demo_pod_retire,
    "namespace_teardown_sweeps_viewers": demo_namespace_teardown,
}

_DEMO_REF: dict = {}


def demo_observe(pkg, url, name):
    proxy, kube = demo_proxy(pkg, url)
    obs = run(DEMO[name](proxy))
    return obs, final_state(proxy, kube)


def demo_ref(name):
    if name not in _DEMO_REF:
        _DEMO_REF[name] = demo_observe(REF, "jax://", name)
    return _DEMO_REF[name]


@pytest.mark.parametrize("url", PORT_URLS)
@pytest.mark.parametrize("name", list(DEMO))
def test_deploy_demo_matches_reference(name, url):
    got = demo_observe(PORT, url, name)
    want = demo_ref(name)
    assert got[0] == want[0]
    assert got[1] == want[1]


def test_deploy_demo_holds_the_reference_assertions():
    """tests/test_deploy_demo.py's own expectations, read off the
    reference's observations (the port's equal them)."""
    def obs(name):
        return demo_ref(name)[0]

    def rels(name):
        return demo_ref(name)[1]["rels"]
    a = obs("admin_reaches_pods_through_tenant_arrow")
    assert names(a[0][1]) == ["api-0", "api-1"]
    assert [a[1][0], a[2][0]] == [200, 403]
    g = obs("nested_group_member_reaches_pods_depth4")
    assert names(g[0][1]) == ["api-0", "api-1"]
    assert names(g[1][1]) == ["acme-prod"]
    m = obs("banned_user_excluded_from_one_pod")
    assert names(m[0][1]) == ["api-0"] and m[1][0] == 403
    assert names(obs("direct_viewer_scoped_to_own_namespace")[0][1]) == [
        "tps-report"]
    assert names(obs("event_postfilter_by_namespace")[0][1]) == ["ev-a"]
    assert [s for s, _ in obs("operator_cel_gate")] == [200, 403]
    b = obs("namespace_create_binds_tenant_from_label")
    assert b[0][0] in (200, 201) and b[1][0] == 200
    assert "namespace:acme-stage#tenant@tenant:acme" in rels(
        "namespace_create_binds_tenant_from_label")
    assert obs("namespace_create_denied_without_tenant_access")[0][0] == 403
    assert obs("namespace_create_without_label_unmatched")[0][0] == 403
    assert obs("rebind_precondition_blocks_second_tenant")[0][0] == 409
    f = obs("pod_launch_with_sharewith_fanout")
    assert f[0][0] in (200, 201) and names(f[1][1]) == ["api-2"]
    assert {"pod:acme-prod/api-2#creator@user:ada",
            "pod:acme-prod/api-2#namespace@namespace:acme-prod",
            "pod:acme-prod/api-2#viewer@user:guest1",
            "pod:acme-prod/api-2#viewer@user:guest2"} <= set(
        rels("pod_launch_with_sharewith_fanout"))
    r = obs("pod_retire_deletes_all_rels_by_filter")
    assert r[0][0] in (200, 201) and r[1][0] in (200, 202)
    assert not [x for x in rels("pod_retire_deletes_all_rels_by_filter")
                if "pod:acme-prod/api-3#" in x]
    assert obs("namespace_teardown_sweeps_viewers")[0][0] in (200, 202)
    assert not [x for x in rels("namespace_teardown_sweeps_viewers")
                if x.startswith("namespace:initech-dev#")]


# -- tests/test_e2e_parity.py ----------------------------------------------

def mutex_run(pkg, url, lock_mode):
    """Five rounds of two concurrent creates of one namespace: per round
    the responses, sorted, and the winner's get; then the kube objects
    and the store's user relationships of the winners' namespaces."""
    import asyncio
    kube = pkg.kubefake.FakeKubeApiServer()
    proxy = pkg.server.ProxyServer(pkg.server.Options(
        spicedb_endpoint=url,
        bootstrap=pkg.endpoints.Bootstrap(schema_text=PARITY_SCHEMA),
        rules_yaml=NS_CREATE_RULES_TMPL.format(lock_mode=lock_mode),
        upstream_transport=pkg.httpcore.HandlerTransport(kube)))
    proxy.enable_dual_writes()
    paul = proxy.get_embedded_client(user="paul")
    chani = proxy.get_embedded_client(user="chani")

    async def go():
        rounds = []
        for attempt in range(5):
            ns_name = f"contested-{lock_mode.lower()}-{attempt}"
            obj = namespace(ns_name)
            r1, r2 = await asyncio.gather(paul.post("/api/v1/namespaces",
                                                    obj),
                                          chani.post("/api/v1/namespaces",
                                                     obj))
            winner = paul if r1.status in (200, 201) else chani
            got = await winner.get(f"/api/v1/namespaces/{ns_name}")
            rounds.append((sorted([snap(r1), snap(r2)],
                                  key=lambda s: s[0]), snap(got)))
        return rounds
    rounds = run(go())
    return rounds, final_state(proxy, kube)


_MUTEX_REF: dict = {}


@pytest.mark.parametrize("url", PORT_URLS)
@pytest.mark.parametrize("lock_mode", ["Pessimistic", "Optimistic"])
def test_concurrent_dual_write_mutex(url, lock_mode):
    got_rounds, got_state = mutex_run(PORT, url, lock_mode)
    if lock_mode not in _MUTEX_REF:
        _MUTEX_REF[lock_mode] = mutex_run(REF, "embedded://", lock_mode)
    want_rounds, want_state = _MUTEX_REF[lock_mode]
    for (resps, got_get), (want_resps, want_get) in zip(got_rounds,
                                                        want_rounds):
        assert [s for s, _ in resps] == [s for s, _ in want_resps] == [
            201, 409], resps
        assert got_get[0] == want_get[0] == 200
        # which client wins is timing, and so is whether the loser met the
        # winner's lock (Conflict) or its object (AlreadyExists)
        assert resps[0][1] == want_resps[0][1]
        assert got_get[1] == want_get[1]
        assert resps[1][1]["reason"] in ("Conflict", "AlreadyExists")
    assert got_state["kube"] == want_state["kube"]
    # a loser's tuples stay when its 409 came from kube (converged), so
    # the winners' tuples are what must agree: one creator per namespace
    winners = {r.split("#")[0] for r in got_state["rels"]}
    assert winners == {r.split("#")[0] for r in want_state["rels"]}
    assert got_state["internal"]["lock"] == 0
    assert all(i["status"] == "completed" for i in got_state["journal"])


def crd_run(pkg, url):
    kube = pkg.kubefake.FakeKubeApiServer(types=list(
        pkg.kubefake.BUILTIN_TYPES) + [pkg.kubefake.ResourceType(
            "example.com", "v1", "testresources", "TestResource",
            namespaced=True, short_names=("tr",))])
    for name, ns in (("alpha", "team-a"), ("beta", "team-b")):
        kube.seed("example.com", "v1", "testresources", {
            "metadata": {"name": name, "namespace": ns},
            "spec": {"message": f"hello {name}"}})
    proxy = pkg.server.ProxyServer(pkg.server.Options(
        spicedb_endpoint=url,
        bootstrap=pkg.endpoints.Bootstrap(schema_text=PARITY_SCHEMA),
        rules_yaml=CRD_RULES,
        upstream_transport=pkg.httpcore.HandlerTransport(kube)))
    proxy.enable_dual_writes()
    proxy.endpoint.store.bulk_load([pkg.types.parse_relationship(
        "testresource:team-a/alpha#viewer@user:alice")])
    base = "/apis/example.com/v1"
    tr = {"apiVersion": "example.com/v1", "kind": "TestResource",
          "metadata": {"name": "gamma", "namespace": "team-c"},
          "spec": {"message": "hi"}}

    async def go():
        return [await req(proxy, "bob", "POST",
                          f"{base}/namespaces/team-c/testresources", tr),
                await req(proxy, "bob", "GET",
                          f"{base}/namespaces/team-c/testresources/gamma"),
                await req(proxy, "bob", "GET", f"{base}/testresources")]
    return run(go()), final_state(proxy, kube)


@pytest.mark.parametrize("url", PORT_URLS)
def test_custom_resource_dual_write_create(url):
    got = crd_run(PORT, url)
    assert got == crd_run(REF, "embedded://")
    (create, get, lst), state = got
    assert create[0] in (200, 201) and get[0] == 200
    assert names(lst[1]) == ["gamma"]
    assert any(key == ["example.com", "v1", "testresources"]
               and name == "gamma" for key, _, name, _ in state["kube"])


# -- tests/test_proxy_e2e.py TestSustainedCreates --------------------------

N_CREATES = 25


def sustained_run(pkg, url):
    """tests/test_proxy_e2e.py's make_proxy and rules (its create-pods
    rule is the dual write): the creator's list after each of 25 pod
    creates, and the inner endpoint's counters before and after them."""
    kube = pkg.kubefake.FakeKubeApiServer()
    for ns in ("team-a", "team-b"):
        kube.seed("", "v1", "namespaces", {"metadata": {"name": ns}})
    for i in range(4):
        ns = "team-a" if i % 2 == 0 else "team-b"
        for resource in ("pods", "secrets"):
            kube.seed("", "v1", resource, {"metadata": {"name": f"p{i}",
                                                        "namespace": ns}})
    kube.seed("", "v1", "configmaps", {"metadata": {"name": "cm",
                                                    "namespace": "team-a"}})
    proxy = pkg.server.ProxyServer(pkg.server.Options(
        spicedb_endpoint=url,
        bootstrap=pkg.endpoints.Bootstrap(schema_text=E2E_SCHEMA),
        rules_yaml=E2E_RULES,
        upstream_transport=pkg.httpcore.HandlerTransport(kube)))
    proxy.endpoint.store.bulk_load([pkg.types.parse_relationship(r)
                                    for r in E2E_RELS])
    proxy.enable_dual_writes()
    inner = getattr(proxy.endpoint, "inner", proxy.endpoint)
    target = "/api/v1/namespaces/team-a/pods"
    # the first list builds the device graph (counted as a rebuild)
    first = run(req(proxy, "alice", "GET", target))

    async def go():
        out = []
        for k in range(N_CREATES):
            created = await req(proxy, "alice", "POST", target, {
                "kind": "Pod", "apiVersion": "v1",
                "metadata": {"name": f"web-{k}", "namespace": "team-a"}})
            out.append((created, await req(proxy, "alice", "GET", target)))
        return out
    stats0 = dict(getattr(inner, "stats", {}))
    obs = run(go())
    stats1 = dict(getattr(inner, "stats", {}))
    return [first] + obs, split_rels(proxy.endpoint.store), stats0, stats1


def test_sustained_creates_stay_incremental():
    url = "torch://?device=cpu&dispatch=direct"
    obs, rels, stats0, stats1 = sustained_run(PORT, url)
    want_obs, want_rels, _, _ = sustained_run(REF, "jax://")
    assert obs == want_obs
    assert rels == want_rels
    for k, (created, listed) in enumerate(obs[1:]):
        assert created[0] in (200, 201), (k, created)
        assert {f"web-{j}" for j in range(k + 1)} <= set(names(listed[1]))
    assert stats1["rebuilds"] == stats0["rebuilds"], \
        "dual-write creates must ride the spare-row path"
    assert stats1["bg_rebuilds"] == stats0["bg_rebuilds"]
    assert stats1["spare_assignments"] - stats0["spare_assignments"] >= \
        N_CREATES


# -- chip_smoke.py phases 16-17 on the CPU, at a small size ----------------

def test_chip_smoke_phase17_rehearsal_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 17 (dual writes on phase 16's proxy, then
    the command line as a process) runs on `device="cpu"` over a small
    multitenant-1m, with the kernels' twins counting launches as the
    card's wrappers do: every check of the phase holds here too."""
    import functools
    import importlib.util

    from spicedb_kubeapi_proxy_tpu_torch.models import workloads
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.utils import features

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
        monkeypatch.setattr(reference, name,
                            functools.wraps(fn)(counted))
    for const, value in (("PROXY_NAMESPACES", 200), ("PROXY_PODS", 1000),
                         ("PROXY_EVENTS", 200), ("PROXY_LIST_USERS", 32),
                         ("PROXY_GETS", 100)):
        monkeypatch.setattr(smoke, const, value)
    # pods enough that the creates fit the pod pool's spare rows, as
    # multitenant-1m's 200,000 pods do on the card
    w = workloads.multitenant_1m(n_pods=8_000, n_tuples=30_000,
                                 n_users=500, n_namespaces=200)
    p16 = smoke.proxy_path(w, "cpu", device="cpu")
    out = smoke.dualwrite_path(p16, "cpu", device="cpu")
    assert all(out["launches"][k] > 0
               for k in smoke.READ_KERNELS + ("scatter_rows",))
    smoke.cli_process("cpu", device="cpu")
