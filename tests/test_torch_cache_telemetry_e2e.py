"""The decision-cached prefilter and the /debug surfaces through the
port's proxy, held against the reference proxy over `jax://?cache=1`, in
the manner of tests/test_torch_proxy_e2e.py; and a CPU rehearsal of
chip_smoke.py's phase 18.

- The multitenant cell of tests/test_torch_proxy_e2e.py (2,000 pods,
  32 users' concurrent lists, namespaced lists, gets, postfilter lists)
  runs twice through each proxy over a cached endpoint
  (`torch://?device=cpu&cache=1`, batched and direct, and
  `embedded://?cache=1`; the reference on `jax://?cache=1`): both rounds'
  responses equal the reference's, the second round's prefilters are
  cache hits, and the audit ring's decision sources — `kernel`/`oracle`
  on the first round, `cache` on the second — match the reference's.
- A write between rounds invalidates exactly the footprint it touches:
  a namespace grant turns every pod list into a miss that answers the
  new set, a `workflow:` tuple none.
- /debug, its surfaces and /readyz answer as the reference's (status,
  keys), with and without a user.

On `embedded://?cache=1` the lists that the other endpoints take
concurrently go in order: the host evaluator holds the store lock for a
whole lookup, so 32 concurrent prefilters run one after another, ~4.5 s
for the last on an idle CPU (the reference's `embedded://` the same),
and a loaded machine pushes it past the prefilter's 10 s wait
(`PREFILTER_TIMEOUT`), where a list answers 502.  In order, each waits
for its own lookup only; the requests, their answers and the cache's
counts are those of the concurrent burst.
"""

import functools
import importlib.util
import json
import pathlib

import pytest

from test_torch_proxy_e2e import (MT_KW, PORT, REF, ROOT, _mt_proxy,
                                  _mt_traffic, run, send)

CACHED_URLS = ["torch://?device=cpu&cache=1",
               "torch://?device=cpu&dispatch=direct&cache=1",
               "embedded://?cache=1"]


def _cache_of(proxy):
    ep = proxy.endpoint
    while ep is not None and not hasattr(ep, "cache"):
        ep = getattr(ep, "inner", None)
    return ep.cache


def _sources(proxy) -> list:
    """The decision sources of the audited list decisions, oldest first."""
    return [d.get("decision_source", "") for d in
            reversed(proxy.audit.recent())
            if d.get("verb") == "list" and d.get("decision_source")]


def _concurrent(url) -> bool:
    """Whether a burst of lists goes concurrently on `url` (on the host
    evaluator it goes in order; see the module docstring)."""
    return not url.startswith("embedded://")


async def _traffic(proxy, reqs, url):
    if _concurrent(url):
        return await _mt_traffic(proxy, reqs)
    return await send(proxy, reqs)


def _two_rounds(pkg, url):
    proxy, reqs = _mt_proxy(pkg, url)
    first = run(_traffic(proxy, reqs, url))
    c1 = dict(_cache_of(proxy).stats)
    second = run(_traffic(proxy, reqs, url))
    c2 = dict(_cache_of(proxy).stats)
    return proxy, reqs, first, second, c1, c2


@pytest.fixture(scope="module")
def cached_ref():
    return _two_rounds(REF, "jax://?cache=1")


@pytest.mark.parametrize("url", CACHED_URLS)
def test_cached_cell_matches_reference(url, cached_ref):
    _, _, rfirst, rsecond, rc1, rc2 = cached_ref
    proxy, reqs, first, second, c1, c2 = _two_rounds(PORT, url)
    assert first == rfirst and second == rsecond
    assert first == second
    # the prefilters of the second round are hits, none misses; the
    # checks of the gets and postfilters are cached too
    assert c2["hits"] - c1["hits"] == rc2["hits"] - rc1["hits"] > 0
    assert c2["misses"] - c1["misses"] == rc2["misses"] - rc1["misses"]
    assert c1 == rc1


@pytest.mark.parametrize("url", CACHED_URLS)
def test_decision_sources_reach_the_audit_ring(url):
    def rounds(pkg, u):
        proxy, reqs = _mt_proxy(pkg, u)
        lists = reqs[:32]
        out = []
        for _ in range(2):
            statuses = [s for s, _, _ in run(send(
                proxy, lists, concurrent=_concurrent(u)))]
            out.append((statuses, _sources(proxy)))
        return out

    got = rounds(PORT, url)
    want = rounds(REF, "jax://?cache=1")
    # the first round answers from the kernel (embedded: the oracle), the
    # second from the cache, as the reference's
    assert [s for s, _ in got] == [s for s, _ in want] == [[200] * 32] * 2
    n = len(got[0][1])
    assert n == len(want[0][1]) >= 32
    assert len(got[1][1]) == len(want[1][1]) == 2 * n
    assert "cache" not in got[0][1] and "cache" not in want[0][1]
    assert set(got[1][1][n:]) == set(want[1][1][n:]) == {"cache"}


@pytest.mark.parametrize("url", ["torch://?device=cpu&cache=1",
                                 "embedded://?cache=1"])
def test_writes_invalidate_exactly_their_footprint(url):
    out = []
    for pkg, u in ((PORT, url), (REF, "jax://?cache=1")):
        proxy, reqs = _mt_proxy(pkg, u)
        lists = reqs[:32]
        run(_traffic(proxy, reqs, u))
        cache = _cache_of(proxy)
        log = []

        async def go():
            # an internal workflow: tuple touches no pod#view footprint
            await proxy.endpoint.write_relationships([pkg.touch(
                "workflow:w1#idempotency_key@activity:a1"
                "[expiration:4102444800]")])
            c0 = dict(cache.stats)
            r1 = await send(proxy, lists, concurrent=_concurrent(u))
            c1 = dict(cache.stats)
            log.append((c1["hits"] - c0["hits"], c1["misses"] - c0["misses"]))
            # a grant of a namespace to the first user
            user = lists[0][0]
            await proxy.endpoint.write_relationships([pkg.touch(
                f"namespace:ns199#viewer@user:{user}")])
            r2 = await send(proxy, lists, concurrent=_concurrent(u))
            c2 = dict(cache.stats)
            log.append((c2["hits"] - c1["hits"], c2["misses"] - c1["misses"],
                        c2["invalidations"] - c1["invalidations"]))
            before = {i["metadata"]["name"] for i in r1[0][2]["items"]}
            after = {i["metadata"]["name"] for i in r2[0][2]["items"]}
            log.append(sorted(after - before))
            log.append([r[2] for r in r2[1:]] == [r[2] for r in r1[1:]])

        run(go())
        out.append(log)
    assert out[0] == out[1]
    hits, misses = out[0][0]
    assert (hits, misses) == (32, 0)
    assert out[0][1][:2] == (0, 32)
    assert out[0][2] and out[0][3] is True


# -- /debug and /readyz through both proxies -------------------------------------

DEBUG_PATHS = ["/debug", "/debug/traces", "/debug/decisions",
               "/debug/flight", "/debug/timeline", "/debug/workload",
               "/debug/profile?seconds=0.05", "/debug/fleet", "/debug/tail",
               "/debug/nope", "/readyz"]


@pytest.mark.parametrize("url", ["torch://?device=cpu&cache=1",
                                 "torch://?device=cpu"])
def test_debug_surfaces_answer_as_the_reference(url):
    def survey(pkg, u):
        # the recorders are process-wide: a trace another test left would
        # reach /debug/tail's merge
        importlib.import_module(
            pkg.server.__name__.rsplit(".", 2)[0] + ".utils.tracing"
        ).RECORDER.drain()
        proxy, reqs = _mt_proxy(pkg, u)
        run(_mt_traffic(proxy, reqs[:40]))
        proxy.flight.capture()

        async def go():
            out = []
            for user in ("u1", ""):
                client = proxy.get_embedded_client(user=user)
                for path in DEBUG_PATHS:
                    resp = await client.get(path)
                    keys = None
                    if resp.status == 200 and path != "/readyz":
                        body = json.loads(resp.body)
                        keys = sorted(body)
                        if path == "/debug":
                            keys = sorted(body["surfaces"])
                    out.append((user, path, resp.status, keys))
            return out

        return run(go())

    assert survey(PORT, url) == survey(REF, "jax://?cache=1")


def test_cached_workload_rows_count_hits_and_misses():
    from spicedb_kubeapi_proxy_tpu.utils import workload as ref_workload
    from spicedb_kubeapi_proxy_tpu_torch.utils import workload
    out = []
    for pkg, wl, u in ((PORT, workload, "torch://?device=cpu&cache=1"),
                       (REF, ref_workload, "jax://?cache=1")):
        wl.WORKLOAD.reset()
        proxy, reqs = _mt_proxy(pkg, u)
        run(_mt_traffic(proxy, reqs[:32]))
        run(_mt_traffic(proxy, reqs[:32]))
        rows = {(r["resource_type"], r["permission"]): r
                for r in wl.WORKLOAD.payload()["rows"]}
        r = rows[("pod", "view")]
        out.append((r["cache_hits"], r["cache_misses"], r["kernel_rows"],
                    r["mean_sweep_depth"]))
    assert out[0] == out[1]
    assert out[0][:2] == (32, 32)


# -- chip_smoke.py's phase 18, rehearsed on the CPU -----------------------------------

def test_chip_smoke_phase18_rehearsal_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 18 (a second proxy over `torch://?cache=1`
    on phase 16's store and fake apiserver) runs on `device="cpu"` over a
    small multitenant-1m, the kernels' twins counting launches as the
    card's wrappers do: every check of the phase holds here too (the
    ledger against the card's allocator apart)."""
    from spicedb_kubeapi_proxy_tpu_torch.models import workloads
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.utils import features

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(ROOT) / "chip_smoke.py")
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
    for const, value in (("PROXY_NAMESPACES", 200), ("PROXY_PODS", 1000),
                         ("PROXY_EVENTS", 200), ("PROXY_LIST_USERS", 32),
                         ("PROXY_GETS", 100)):
        monkeypatch.setattr(smoke, const, value)
    w = workloads.multitenant_1m(**MT_KW)
    p16 = smoke.proxy_path(w, "cpu", device="cpu")
    out = smoke.cache_telemetry_path(p16, w, "cpu", device="cpu")
    assert all(out["launches"][k] > 0 for k in ("ell_gather_or",
                                                "perm_program", "lookup_T"))
