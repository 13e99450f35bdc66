"""The port's decision cache (spicedb/decision_cache.py) held against the
reference's.

Every scenario of tests/test_decision_cache.py runs on both packages at
once: the port's `DecisionCacheEndpoint` over `torch://?device=cpu` (a
`TorchEndpoint` on the CPU) and over `embedded://`, and the reference's
over `jax://` and `embedded://`, each stack on its own store receiving
the same writes.  A scenario returns a log of what it observed — answers
(sorted ids, tri-state verdicts, decision sources), the cache's hit /
miss / invalidation / eviction / fill counters, resident bytes and entry
validity — and the two logs must be equal: zero tolerance, no wall-clock
field.  The relation footprints, the wiring (URL parameters, keywords,
the switch, the CLI) and the audit plumbing are compared directly.
"""

import asyncio
import random
from types import SimpleNamespace

import pytest

from spicedb_kubeapi_proxy_tpu.ops import graph_compile as ref_gc
from spicedb_kubeapi_proxy_tpu.ops.jax_endpoint import JaxEndpoint
from spicedb_kubeapi_proxy_tpu.spicedb import decision_cache as ref_dc
from spicedb_kubeapi_proxy_tpu.spicedb import endpoints as ref_endpoints
from spicedb_kubeapi_proxy_tpu.spicedb import evaluator as ref_evaluator
from spicedb_kubeapi_proxy_tpu.spicedb import schema as ref_sch
from spicedb_kubeapi_proxy_tpu.spicedb import store as ref_store
from spicedb_kubeapi_proxy_tpu.spicedb import types as ref_types
from spicedb_kubeapi_proxy_tpu.utils.features import GATES
from spicedb_kubeapi_proxy_tpu_torch.ops import graph_compile
from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import TorchEndpoint
from spicedb_kubeapi_proxy_tpu_torch.spicedb import decision_cache
from spicedb_kubeapi_proxy_tpu_torch.spicedb import endpoints
from spicedb_kubeapi_proxy_tpu_torch.spicedb import evaluator
from spicedb_kubeapi_proxy_tpu_torch.spicedb import schema as sch
from spicedb_kubeapi_proxy_tpu_torch.spicedb import store
from spicedb_kubeapi_proxy_tpu_torch.spicedb import types
from spicedb_kubeapi_proxy_tpu_torch.utils import features

SCHEMA = """
definition user {}
definition group {
  relation member: user
}
definition namespace {
  relation creator: user
  relation viewer: user | group#member
  permission view = viewer + creator
}
definition pod {
  relation namespace: namespace
  relation creator: user
  relation viewer: user
  permission edit = creator
  permission view = viewer + creator + namespace->view
}
"""

EXPIRING_SCHEMA = """
use expiration
definition user {}
definition pod {
  relation viewer: user with expiration
  permission view = viewer
}
"""

REF = SimpleNamespace(dc=ref_dc, endpoints=ref_endpoints, sch=ref_sch,
                      store=ref_store, types=ref_types,
                      evaluator=ref_evaluator, kernel=JaxEndpoint,
                      kernel_kw={})
PORT = SimpleNamespace(dc=decision_cache, endpoints=endpoints, sch=sch,
                       store=store, types=types, evaluator=evaluator,
                       kernel=TorchEndpoint, kernel_kw={"device": "cpu"})
# inner endpoint kinds: the device kernel (jax:// / torch://?device=cpu)
# and the host evaluator (embedded:// on both)
KINDS = ["kernel", "embedded"]


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def reference_like_the_port(monkeypatch):
    """Both packages rebuild synchronously (so a write is absorbed before
    the next read on both), and both decision-cache switches are off
    unless a case turns them on."""
    monkeypatch.setattr(GATES._gates["AsyncRebuild"], "value", False)
    monkeypatch.setattr(features, "ASYNC_REBUILD", False)
    monkeypatch.setattr(GATES._gates["DecisionCache"], "value", False)
    monkeypatch.setattr(features, "DECISION_CACHE", False)


def make_cached(pkg, kind, schema_text=SCHEMA, clock=None, **kw):
    schema = pkg.sch.parse_schema(schema_text)
    st = pkg.store.TupleStore(clock=clock) if clock else pkg.store.TupleStore()
    inner = (pkg.kernel(schema, store=st, **pkg.kernel_kw) if kind == "kernel"
             else pkg.endpoints.EmbeddedEndpoint(schema, store=st))
    return pkg.dc.DecisionCacheEndpoint(inner, **kw), inner


def touch(pkg, text):
    return pkg.types.RelationshipUpdate(
        op=pkg.types.UpdateOp.TOUCH,
        rel=pkg.types.parse_relationship(text))


def delete(pkg, text):
    return pkg.types.RelationshipUpdate(
        op=pkg.types.UpdateOp.DELETE,
        rel=pkg.types.parse_relationship(text))


def counters(ep) -> tuple:
    c = ep.cache
    return (dict(c.stats), c.resident_bytes, len(c))


def tri(pkg, res) -> int:
    P = pkg.types.Permissionship
    return {P.NO_PERMISSION: 0, P.CONDITIONAL_PERMISSION: 1,
            P.HAS_PERMISSION: 2}[res.permissionship]


def both(scenario, kind, **kw):
    """Run `scenario(pkg, kind)` on the reference and on the port; their
    logs must be equal.  Returns the port's log."""
    want = scenario(REF, kind, **kw)
    got = scenario(PORT, kind, **kw)
    assert got == want
    return got


# -- relation footprints ------------------------------------------------------

FOOTPRINT_NAMES = [(t, n) for t in ("user", "group", "namespace", "pod",
                                    "nosuch")
                   for n in ("member", "creator", "viewer", "namespace",
                             "view", "edit", "nosuch")]


@pytest.mark.parametrize("rtype,name", FOOTPRINT_NAMES)
def test_relation_footprint_matches_reference(rtype, name):
    got = graph_compile.relation_footprint(sch.parse_schema(SCHEMA), rtype,
                                           name)
    want = ref_gc.relation_footprint(ref_sch.parse_schema(SCHEMA), rtype,
                                     name)
    assert got == want


def test_relation_footprint_reference_cases():
    """tests/test_decision_cache.py TestRelationFootprint's assertions,
    on the port's copy."""
    s = sch.parse_schema(SCHEMA)
    fp = graph_compile.relation_footprint
    assert fp(s, "pod", "creator") == frozenset({("pod", "creator")})
    assert fp(s, "pod", "edit") == frozenset({("pod", "creator")})
    assert fp(s, "pod", "view") == frozenset({
        ("pod", "viewer"), ("pod", "creator"), ("pod", "namespace"),
        ("namespace", "viewer"), ("namespace", "creator"),
        ("group", "member")})
    assert not (fp(s, "pod", "edit") & fp(s, "namespace", "view"))
    assert fp(s, "nosuch", "view") == frozenset()
    assert fp(s, "pod", "nosuch") == frozenset()


# -- relation-scoped invalidation ----------------------------------------------

def _write_invalidates_only_footprint(pkg, kind):
    ep, _ = make_cached(pkg, kind)
    T = pkg.types
    log = []

    async def go():
        await ep.write_relationships([
            touch(pkg, "pod:p1#viewer@user:alice"),
            touch(pkg, "pod:p1#creator@user:bob"),
            touch(pkg, "namespace:ns1#viewer@user:alice")])
        alice = T.SubjectRef("user", "alice")
        for perm in ("view", "edit"):
            out = await ep.lookup_resources("pod", perm, alice)
            log.append((perm, sorted(out), out.source))
        view_key = ("lr", "pod", "view", alice)
        edit_key = ("lr", "pod", "edit", alice)
        log.append((ep.cache.contains_valid(view_key),
                    ep.cache.contains_valid(edit_key), counters(ep)))
        await ep.write_relationships(
            [touch(pkg, "namespace:ns1#viewer@user:carol")])
        log.append((ep.cache.contains_valid(view_key),
                    ep.cache.contains_valid(edit_key), counters(ep)))
        for perm in ("edit", "view"):
            out = await ep.lookup_resources("pod", perm, alice)
            log.append((perm, sorted(out), out.source, counters(ep)))

    run(go())
    assert log[2][:2] == (True, True) and log[3][:2] == (False, True)
    assert log[4][2] == "cache" and log[5][2] != "cache"
    return log


@pytest.mark.parametrize("kind", KINDS)
def test_write_invalidates_only_footprint_entries(kind):
    both(_write_invalidates_only_footprint, kind)


def _check_entries_relation_scoped(pkg, kind):
    ep, _ = make_cached(pkg, kind)
    T = pkg.types
    log = []

    async def go():
        await ep.write_relationships([
            touch(pkg, "pod:p1#creator@user:bob"),
            touch(pkg, "pod:p1#viewer@user:alice")])
        req = T.CheckRequest(resource=T.ObjectRef("pod", "p1"),
                             permission="edit",
                             subject=T.SubjectRef("user", "bob"))
        for write in (None, touch(pkg, "pod:p1#viewer@user:carol"),
                      delete(pkg, "pod:p1#creator@user:bob")):
            if write is not None:
                await ep.write_relationships([write])
            for _ in range(2):
                r = await ep.check_permission(req)
                log.append((tri(pkg, r), r.source == "cache", counters(ep)))

    run(go())
    assert [x[1] for x in log] == [False, True, True, True, False, True]
    assert log[4][0] == 0
    return log


@pytest.mark.parametrize("kind", KINDS)
def test_check_entries_are_relation_scoped_too(kind):
    both(_check_entries_relation_scoped, kind)


def _bulk_load_invalidates(pkg, kind):
    ep, inner = make_cached(pkg, kind)
    T = pkg.types
    log = []

    async def go():
        await ep.write_relationships([touch(pkg, "pod:p1#viewer@user:alice")])
        alice = T.SubjectRef("user", "alice")
        log.append(sorted(await ep.lookup_resources("pod", "view", alice)))
        key = ("lr", "pod", "view", alice)
        log.append(ep.cache.contains_valid(key))
        inner.store.bulk_load(
            [T.parse_relationship("pod:p2#viewer@user:alice")])
        log.append((ep.cache.contains_valid(key), counters(ep)))
        out = await ep.lookup_resources("pod", "view", alice)
        log.append((sorted(out), out.source == "cache", counters(ep)))

    run(go())
    assert log[1] is True and log[2][0] is False
    assert log[3][0] == ["p1", "p2"]
    return log


@pytest.mark.parametrize("kind", KINDS)
def test_bulk_load_invalidates_wholesale(kind):
    both(_bulk_load_invalidates, kind)


def _delete_all_invalidates(pkg, kind):
    ep, inner = make_cached(pkg, kind)
    T = pkg.types
    log = []

    async def go():
        await ep.write_relationships([touch(pkg, "pod:p1#viewer@user:alice")])
        alice = T.SubjectRef("user", "alice")
        req = T.CheckRequest(resource=T.ObjectRef("pod", "p1"),
                             permission="view", subject=alice)
        for _ in range(2):
            r = await ep.check_permission(req)
            log.append((tri(pkg, r), r.source == "cache"))
        inner.store.delete_all()
        r = await ep.check_permission(req)
        log.append((tri(pkg, r), r.source == "cache", counters(ep)))

    run(go())
    assert log[-1][:2] == (0, False)
    return log


@pytest.mark.parametrize("kind", KINDS)
def test_delete_all_invalidates_wholesale(kind):
    both(_delete_all_invalidates, kind)


# -- bounds and expiry ----------------------------------------------------------

def _lru_by_entries(pkg):
    c = pkg.dc.DecisionCache(max_bytes=1 << 30, max_entries=2)
    tok = c.snapshot_epochs(frozenset(), 0.0)
    c.put(("a",), [1], tok, 10)
    c.put(("b",), [2], tok, 10)
    log = [c.get(("a",), 0.0)]
    c.put(("c",), [3], tok, 10)
    log += [dict(c.stats), c.contains_valid(("b",)),
            c.contains_valid(("a",)), c.contains_valid(("c",)),
            c.get(("b",), 0.0) is pkg.dc._MISS, c.resident_bytes, len(c)]
    return log


def test_lru_eviction_by_entry_count():
    log = _lru_by_entries(PORT)
    assert log == _lru_by_entries(REF)
    assert log[1]["evictions"] == 1 and log[2:5] == [False, True, True]


def _bytes_bound(pkg):
    c = pkg.dc.DecisionCache(max_bytes=100, max_entries=1000)
    tok = c.snapshot_epochs(frozenset(), 0.0)
    c.put(("a",), [1], tok, 60)
    c.put(("b",), [2], tok, 60)
    log = [dict(c.stats), c.resident_bytes]
    c.put(("b",), [3], tok, 40)
    log += [c.resident_bytes, dict(c.stats)]
    return log


def test_bytes_bound_and_accounting():
    log = _bytes_bound(PORT)
    assert log == _bytes_bound(REF)
    assert log[1] == 60 and log[2] == 40


@pytest.mark.parametrize("bounds", [(1, 1), (300, 3), (4096, 2),
                                    (1 << 20, 65536)])
def test_bounds_evict_identically_under_a_fill_sequence(bounds):
    """A seeded sequence of fills of varied sizes, probes and epoch bumps:
    the same hits, misses, invalidations and evictions, the same bytes."""
    def go(pkg):
        rng = random.Random(7)
        c = pkg.dc.DecisionCache(max_bytes=bounds[0], max_entries=bounds[1])
        log = []
        for step in range(300):
            key = ("k", rng.randrange(12))
            fp = frozenset({("r", rng.randrange(3))})
            op = rng.random()
            if op < 0.4:
                c.put(key, step, c.snapshot_epochs(fp, float(step)),
                      rng.randrange(1, 200))
            elif op < 0.8:
                v = c.get(key, float(step))
                log.append(None if v is pkg.dc._MISS else v)
            elif op < 0.95:
                c.bump([("r", rng.randrange(3))])
            else:
                c.bump_all()
            log.append((dict(c.stats), c.resident_bytes, len(c)))
        return log

    assert go(PORT) == go(REF)


def test_bounds_must_be_positive():
    for kw in ({"max_bytes": 0}, {"max_entries": 0}):
        with pytest.raises(ValueError):
            decision_cache.DecisionCache(**kw)
        with pytest.raises(ValueError):
            ref_dc.DecisionCache(**kw)


def _expiring_tuple(pkg, kind):
    clock = [1000.0]
    ep, _ = make_cached(pkg, kind, EXPIRING_SCHEMA, clock=lambda: clock[0])
    T = pkg.types
    log = []

    async def go():
        await ep.write_relationships([T.RelationshipUpdate(
            op=T.UpdateOp.TOUCH, rel=T.parse_relationship(
                f"pod:p1#viewer@user:alice[expiration:{clock[0] + 50}]"))])
        alice = T.SubjectRef("user", "alice")
        for _ in range(2):
            out = await ep.lookup_resources("pod", "view", alice)
            log.append((sorted(out), out.source == "cache", counters(ep)))
        clock[0] += 60  # past the expiration: no delta fires
        out = await ep.lookup_resources("pod", "view", alice)
        log.append((sorted(out), out.source == "cache", counters(ep)))

    run(go())
    assert [x[:2] for x in log] == [(["p1"], False), (["p1"], True),
                                    ([], False)]
    return log


@pytest.mark.parametrize("kind", KINDS)
def test_expiring_tuple_invalidates_at_expiry(kind):
    both(_expiring_tuple, kind)


def _bootstrap_expiry_rescan(pkg, kind):
    """Tuples loaded before the cache existed carry expirations that no
    delta told it about: the first probe seeds the heap from the store's
    `expiry_schedule()`."""
    clock = [1000.0]
    schema = pkg.sch.parse_schema(EXPIRING_SCHEMA)
    st = pkg.store.TupleStore(clock=lambda: clock[0])
    st.bulk_load([pkg.types.parse_relationship(
        f"pod:p{i}#viewer@user:alice[expiration:{clock[0] + 10 * (i + 1)}]")
        for i in range(3)])
    inner = (pkg.kernel(schema, store=st, **pkg.kernel_kw) if kind == "kernel"
             else pkg.endpoints.EmbeddedEndpoint(schema, store=st))
    ep = pkg.dc.DecisionCacheEndpoint(inner)
    alice = pkg.types.SubjectRef("user", "alice")
    log = [sorted((e, rk) for e, rk in st.expiry_schedule())]

    async def go():
        for dt in (0, 0, 15, 0, 10, 0, 10):
            clock[0] += dt
            out = await ep.lookup_resources("pod", "view", alice)
            log.append((sorted(out), out.source == "cache", counters(ep)))

    run(go())
    assert log[-1][0] == []
    return log


@pytest.mark.parametrize("kind", KINDS)
def test_bootstrap_expirations_seed_the_heap(kind):
    both(_bootstrap_expiry_rescan, kind)


# -- wiring ----------------------------------------------------------------------

@pytest.mark.parametrize("url,cached,max_bytes", [
    ("torch://?device=cpu&cache=1", True, decision_cache.DEFAULT_MAX_BYTES),
    ("torch://?device=cpu&cache=true&cache_bytes=8192", True, 8192),
    ("torch://?device=cpu&dispatch=direct&cache=yes", True,
     decision_cache.DEFAULT_MAX_BYTES),
    ("torch://?device=cpu&cache=0", False, None),
    ("torch://?device=cpu", False, None),
    ("embedded://?cache=1", True, decision_cache.DEFAULT_MAX_BYTES),
    ("embedded://?cache=1&cache_bytes=4096", True, 4096),
    ("embedded://", False, None),
])
def test_url_param_wires_cache(url, cached, max_bytes):
    ep = endpoints.create_endpoint(url)
    assert isinstance(ep, decision_cache.DecisionCacheEndpoint) == cached
    ref_url = url.replace("torch://?device=cpu&", "jax://?").replace(
        "torch://?device=cpu", "jax://")
    ref = ref_endpoints.create_endpoint(ref_url)
    assert isinstance(ref, ref_dc.DecisionCacheEndpoint) == cached
    if cached:
        assert ep.cache.max_bytes == ref.cache.max_bytes == max_bytes
        # the cache sits above the dispatcher (reference endpoints.py:536)
        assert (type(ep.inner).__name__.replace("Torch", "Jax")
                == type(ref.inner).__name__)


@pytest.mark.parametrize("url", ["torch://?device=cpu&cache=bogus",
                                 "embedded://?cache=2",
                                 "torch://?device=cpu&cache=1&cache_bytes=x",
                                 "embedded://?cache=1&cache_bytes=-5"])
def test_bad_cache_params_raise(url):
    with pytest.raises(endpoints.EndpointConfigError):
        endpoints.create_endpoint(url)


def test_kwarg_and_bytes_override():
    ep = endpoints.create_endpoint("embedded://", decision_cache=True,
                                   decision_cache_bytes=4096)
    assert isinstance(ep, decision_cache.DecisionCacheEndpoint)
    assert ep.cache.max_bytes == 4096
    ep2 = endpoints.create_endpoint(
        "torch://?device=cpu&cache=1&cache_bytes=8192")
    assert ep2.cache.max_bytes == 8192
    # the explicit keyword wins over the URL, as in the reference
    ep3 = endpoints.create_endpoint("torch://?device=cpu&cache=1",
                                    decision_cache=False)
    assert not isinstance(ep3, decision_cache.DecisionCacheEndpoint)


def test_explicit_cache_refused_without_a_store():
    """Both port schemes are store-backed; the refusal the reference gives
    a remote endpoint applies to any endpoint without a store."""
    bare = endpoints.PermissionsEndpoint()
    with pytest.raises(endpoints.EndpointConfigError, match="store-backed"):
        endpoints._wrap_decision_cache(bare, True, True, None, "x://")
    # a switch-derived cache is dropped silently
    assert endpoints._wrap_decision_cache(bare, True, False, None,
                                          "x://") is bare


def test_switch_turns_the_cache_on(monkeypatch):
    monkeypatch.setattr(features, "DECISION_CACHE", True)
    assert isinstance(endpoints.create_endpoint("embedded://"),
                      decision_cache.DecisionCacheEndpoint)
    assert isinstance(endpoints.create_endpoint("torch://?device=cpu"),
                      decision_cache.DecisionCacheEndpoint)
    # an explicit cache=0 still wins
    assert not isinstance(endpoints.create_endpoint("embedded://?cache=0"),
                          decision_cache.DecisionCacheEndpoint)


def _explain_bypass(pkg, kind):
    ep, _ = make_cached(pkg, kind)
    T = pkg.types
    log = []

    async def go():
        await ep.write_relationships([touch(pkg, "pod:p1#viewer@user:alice")])
        alice = T.SubjectRef("user", "alice")
        req = T.CheckRequest(resource=T.ObjectRef("pod", "p1"),
                             permission="view", subject=alice)
        await ep.check_permission(req)
        await ep.check_permission(req)
        before = counters(ep)
        w = ep.explain_check(T.ObjectRef("pod", "p1"), "view", alice)
        log.append((w.decision, before, counters(ep)))

    run(go())
    assert log[0][0] == "allowed" and log[0][1] == log[0][2]
    return log


@pytest.mark.parametrize("kind", KINDS)
def test_explain_bypasses_cache(kind):
    both(_explain_bypass, kind)


def _lookup_source(pkg, kind):
    ep, _ = make_cached(pkg, kind)
    log = [getattr(ep, "decision_cache_enabled", False)]

    async def go():
        await ep.write_relationships([touch(pkg, "pod:p1#viewer@user:alice")])
        alice = pkg.types.SubjectRef("user", "alice")
        for _ in range(2):
            out = await ep.lookup_resources("pod", "view", alice)
            log.append((sorted(out), out.source))

    run(go())
    assert log[0] is True and log[2][1] == "cache"
    return log


@pytest.mark.parametrize("kind", KINDS)
def test_lookup_result_carries_cache_source(kind):
    both(_lookup_source, kind)


def _batches_and_bulks(pkg, kind):
    """lookup_resources_batch and check_bulk_permissions: mixed hits and
    misses in one call, fills per row, per-verb counters."""
    ep, _ = make_cached(pkg, kind)
    T = pkg.types
    log = []
    users = [T.SubjectRef("user", u) for u in ("alice", "bob", "carol")]

    async def go():
        await ep.write_relationships([
            touch(pkg, "pod:p1#viewer@user:alice"),
            touch(pkg, "pod:p2#creator@user:bob"),
            touch(pkg, "pod:p2#namespace@namespace:ns1"),
            touch(pkg, "namespace:ns1#viewer@group:g1#member"),
            touch(pkg, "group:g1#member@user:carol")])
        for subjects in (users[:1], users, users[1:], users):
            out = await ep.lookup_resources_batch("pod", "view", subjects)
            log.append(([sorted(x) for x in out],
                        [x.source == "cache" for x in out], counters(ep)))
        reqs = [T.CheckRequest(resource=T.ObjectRef("pod", p),
                               permission=perm, subject=u)
                for p in ("p1", "p2") for perm in ("view", "edit")
                for u in users]
        for rs in (reqs[:4], reqs, reqs[6:]):
            res = await ep.check_bulk_permissions(rs)
            log.append(([tri(pkg, r) for r in res],
                        [r.source == "cache" for r in res], counters(ep)))
        await ep.write_relationships(
            [delete(pkg, "group:g1#member@user:carol")])
        out = await ep.lookup_resources_batch("pod", "view", users)
        log.append(([sorted(x) for x in out],
                    [x.source == "cache" for x in out], counters(ep)))

    run(go())
    assert log[-1][0][2] == []
    return log


@pytest.mark.parametrize("kind", KINDS)
def test_batches_mix_hits_and_misses(kind):
    both(_batches_and_bulks, kind)


def test_cli_flag_round_trip():
    from spicedb_kubeapi_proxy_tpu_torch.cli import build_parser, validate
    args = build_parser().parse_args([
        "--backend-kubeconfig", "x", "--rule-config", "y",
        "--spicedb-endpoint", "torch://", "--decision-cache",
        "--decision-cache-bytes", "4096"])
    assert args.decision_cache and not validate(args)
    bad = build_parser().parse_args([
        "--backend-kubeconfig", "x", "--rule-config", "y",
        "--decision-cache-bytes", "-1"])
    assert any("--decision-cache-bytes" in e for e in validate(bad))


def test_cache_bytes_flag_applies_without_decision_cache_flag(tmp_path):
    from spicedb_kubeapi_proxy_tpu_torch import cli
    rules = tmp_path / "rules.yaml"
    rules.write_text("apiVersion: authzed.com/v1alpha1\nkind: ProxyRule\n"
                     "metadata: {name: r}\n"
                     "match: [{apiVersion: v1, resource: pods, "
                     "verbs: [get]}]\n"
                     "check: [{tpl: 'pod:{{name}}#view@user:"
                     "{{user.name}}'}]\n")
    args = cli.build_parser().parse_args([
        "--rule-config", str(rules), "--embedded-mode",
        "--spicedb-endpoint", "embedded://?cache=1",
        "--decision-cache-bytes", "4096"])

    class Null:
        async def round_trip(self, req):
            raise AssertionError("no upstream call expected")

    opts = cli.complete(args, upstream_transport=Null()).server_options
    assert opts.endpoint_kwargs["decision_cache_bytes"] == 4096
    assert "decision_cache" not in opts.endpoint_kwargs
    ep = endpoints.create_endpoint(opts.spicedb_endpoint,
                                   **opts.endpoint_kwargs)
    assert ep.cache.max_bytes == 4096


def test_close_unregisters_store_listeners():
    ep, inner = make_cached(PORT, "embedded")
    st = inner.store
    assert ep._on_delta in st._delta_listeners
    assert ep._on_reset in st._reset_listeners
    run(ep.close())
    assert ep._on_delta not in st._delta_listeners
    assert ep._on_reset not in st._reset_listeners


def test_metrics_count_hits_and_misses_by_verb():
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import REGISTRY
    ep, _ = make_cached(PORT, "kernel")
    hits = REGISTRY.get("authz_decision_cache_hits_total")
    misses = REGISTRY.get("authz_decision_cache_misses_total")
    h0, m0 = hits.value(verb="lookup"), misses.value(verb="lookup")

    async def go():
        await ep.write_relationships(
            [touch(PORT, "pod:p1#viewer@user:alice")])
        alice = types.SubjectRef("user", "alice")
        for _ in range(3):
            await ep.lookup_resources("pod", "view", alice)

    run(go())
    assert hits.value(verb="lookup") - h0 == 2
    assert misses.value(verb="lookup") - m0 == 1
    assert "authz_decision_cache_bytes" in REGISTRY.render()


# -- cache-on vs cache-off coherence: the oracle referees --------------------------

SUBJECTS = ("alice", "bob", "carol")
QUERIES = [("pod", "view"), ("pod", "edit"), ("namespace", "view")]


def _random_update(pkg, rng):
    pod = f"p{rng.randrange(4)}"
    ns = f"ns{rng.randrange(2)}"
    user = rng.choice(SUBJECTS)
    group = f"g{rng.randrange(2)}"
    text = rng.choice((
        f"pod:{pod}#viewer@user:{user}",
        f"pod:{pod}#creator@user:{user}",
        f"pod:{pod}#namespace@namespace:{ns}",
        f"namespace:{ns}#viewer@user:{user}",
        f"namespace:{ns}#viewer@group:{group}#member",
        f"namespace:{ns}#creator@user:{user}",
        f"group:{group}#member@user:{user}",
    ))
    return (touch if rng.random() < 0.7 else delete)(pkg, text)


def _coherence(pkg, kind):
    rng = random.Random(1234)
    ep, inner = make_cached(pkg, kind)
    oracle = pkg.evaluator.Evaluator(inner.schema, inner.store)
    T = pkg.types
    log = []

    async def go():
        for step in range(30):
            await ep.write_relationships([_random_update(pkg, rng)])
            for _round in range(2):   # the second round hits the cache
                for rt, perm in QUERIES:
                    for u in SUBJECTS:
                        s = T.SubjectRef("user", u)
                        got = await ep.lookup_resources(rt, perm, s)
                        want = sorted(oracle.lookup_resources(rt, perm, s))
                        assert sorted(got) == want, (step, rt, perm, u)
                        req = T.CheckRequest(
                            resource=T.ObjectRef(
                                rt, f"{'p' if rt == 'pod' else 'ns'}0"),
                            permission=perm, subject=s)
                        res = await ep.check_permission(req)
                        assert tri(pkg, res) == oracle.check3(
                            req.resource, perm, s), (step, req)
                        log.append((sorted(got), got.source == "cache",
                                    tri(pkg, res), res.source == "cache"))
            log.append(counters(ep))

    run(go())
    assert ep.cache.stats["hits"] > 0
    assert ep.cache.stats["invalidations"] > 0
    return log


@pytest.mark.parametrize("kind", KINDS)
def test_cache_coherence_under_random_delta_stream(kind):
    both(_coherence, kind)


def test_coherence_through_the_factory_urls():
    """`torch://?device=cpu&cache=1` (the batched dispatcher under the
    cache) against `jax://?cache=1` on the same write stream: the same
    answers and the same hit/miss/eviction sequence."""
    def go(pkg, url):
        ep = pkg.endpoints.create_endpoint(
            url, pkg.endpoints.Bootstrap(schema_text=SCHEMA))
        rng = random.Random(99)
        T = pkg.types
        log = []

        async def drive():
            for step in range(12):
                await ep.write_relationships([_random_update(pkg, rng)])
                outs = await asyncio.gather(*(
                    ep.lookup_resources(rt, perm, T.SubjectRef("user", u))
                    for rt, perm in QUERIES for u in SUBJECTS))
                log.append([(sorted(o), o.source == "cache") for o in outs])
                log.append(counters(ep))

        run(drive())
        return log

    assert go(PORT, "torch://?device=cpu&cache=1") == go(REF, "jax://?cache=1")


# -- audit plumbing --------------------------------------------------------------

def test_audit_event_carries_decision_source():
    from spicedb_kubeapi_proxy_tpu_torch.authz.middleware import (
        audit_event_for)
    from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import Request
    from spicedb_kubeapi_proxy_tpu_torch.utils.audit import LEVEL_METADATA

    req = Request(method="GET", target="/api/v1/pods")
    req.context["decision_source"] = "cache"
    ev = audit_event_for(req, "check", "allowed")
    assert ev.decision_source == "cache"
    assert ev.to_dict(LEVEL_METADATA)["decision_source"] == "cache"
    req2 = Request(method="GET", target="/api/v1/pods")
    ev2 = audit_event_for(req2, "check", "allowed")
    assert "decision_source" not in ev2.to_dict(LEVEL_METADATA)


def test_decision_source_of_collapses_mixed_results():
    from spicedb_kubeapi_proxy_tpu_torch.authz.check import (
        decision_source_of)

    def res(src):
        return types.CheckResult(
            permissionship=types.Permissionship.HAS_PERMISSION, source=src)

    assert decision_source_of([]) == ""
    assert decision_source_of([res("cache"), res("cache")]) == "cache"
    assert decision_source_of([res("cache"), res("kernel")]) == "mixed"
    assert decision_source_of([res(""), res("oracle")]) == "oracle"
