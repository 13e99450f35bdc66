"""The port's device telemetry (utils/devtel.py) held against the
reference's.

The reference's tests/test_devtel.py cases, each feed sent into the
port's module and the reference's, on isolated registries: the HBM
ledger's totals, peaks and generations; kernel accounting (hits,
compiles, recompile storms, the entries gauge); batch occupancy; the
snapshot diff; the flight recorder's windows, quantiles and SLO burn
rates.  The outputs must be equal (wall-clock fields apart: `ts`, and
the slow-trace and timeline links, which read other process-wide
state).  Then the endpoint's ledger contract on `torch://?device=cpu`
(a rebuild returns the ledger to old − old generation + new generation,
byte-exactly, and its tables count the reference's bytes), the
dispatcher's singleflight collapses, and the proxy's `/debug` surfaces,
`/readyz` and SLO intake beside the reference proxy's.
"""

import asyncio
import gc
import json
import time
from types import SimpleNamespace

import pytest

from spicedb_kubeapi_proxy_tpu.ops.jax_endpoint import JaxEndpoint
from spicedb_kubeapi_proxy_tpu.spicedb import schema as ref_sch
from spicedb_kubeapi_proxy_tpu.spicedb import types as ref_types
from spicedb_kubeapi_proxy_tpu.utils import devtel as ref_devtel
from spicedb_kubeapi_proxy_tpu.utils import metrics as ref_m
from spicedb_kubeapi_proxy_tpu.utils.features import GATES
from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import TorchEndpoint
from spicedb_kubeapi_proxy_tpu_torch.spicedb import schema as sch
from spicedb_kubeapi_proxy_tpu_torch.spicedb import types
from spicedb_kubeapi_proxy_tpu_torch.utils import devtel
from spicedb_kubeapi_proxy_tpu_torch.utils import features
from spicedb_kubeapi_proxy_tpu_torch.utils import metrics as m


def _ref_gate(on):
    GATES.set("DeviceTelemetry", on)


def _port_gate(on):
    features.DEVICE_TELEMETRY = on


REF = SimpleNamespace(devtel=ref_devtel, m=ref_m, gate=_ref_gate)
PORT = SimpleNamespace(devtel=devtel, m=m, gate=_port_gate)

SCHEMA = """
definition user {}

definition doc {
    relation viewer: user
    permission view = viewer
}
"""


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def both_gates_on(monkeypatch):
    monkeypatch.setattr(GATES._gates["DeviceTelemetry"], "value", True)
    monkeypatch.setattr(GATES._gates["AsyncRebuild"], "value", False)
    monkeypatch.setattr(features, "DEVICE_TELEMETRY", True)
    monkeypatch.setattr(features, "ASYNC_REBUILD", False)


# -- feeds into the module classes ------------------------------------------------

def ledger_accounting(ns):
    led = ns.devtel.HbmLedger(registry=ns.m.Registry())
    led.register("tables", 1000, generation=1, name="main")
    led.register("tables", 500, generation=1, name="aux")
    led.register("id_view", 200, generation=1, name="ids:doc")
    out = [led.total(), led.totals(), led.generation_bytes(1)]
    led.register("tables", 800, generation=1, name="main")
    out += [led.total(),
            led.unregister("id_view", generation=1, name="ids:doc"),
            led.total(),
            led.unregister("id_view", generation=9, name="nope")]
    return out


def ledger_defer_retire(ns):
    led = ns.devtel.HbmLedger(registry=ns.m.Registry())
    led.register("tables", 1000, generation=1)
    led.register("tables", 500, generation=2)
    led.defer_retire(1)
    out = [led.total(), led.generation_bytes(1)]
    led.defer_retire(2)
    led.register("tables", 64, generation=3)
    return out + [led.totals()]


def ledger_retire_and_peak(ns):
    led = ns.devtel.HbmLedger(registry=ns.m.Registry())
    led.register("tables", 1000, generation=1)
    led.register("tables", 2000, generation=2)
    out = [led.peak, led.retire_generation(1), led.total(), led.peak,
           led.generation_bytes(1)]
    led.register("tables", 4096, generation=3, name="x")
    led.register("tables", 1024, generation=3, name="x")
    return out + [led.totals(), led.peak]


def ledger_gate_blocks_additions(ns):
    led = ns.devtel.HbmLedger(registry=ns.m.Registry())
    led.register("tables", 1000, generation=1)
    ns.gate(False)
    try:
        led.register("tables", 500, generation=2)
        out = [led.total(), led.retire_generation(1), led.total()]
    finally:
        ns.gate(True)
    return out


def ledger_device_rows(ns):
    reg = ns.m.Registry()
    led = ns.devtel.HbmLedger(registry=reg)
    led.register("ell_main", 300, generation=4, name="b0", device=0)
    led.register("ell_main", 300, generation=4, name="b1", device=1)
    led.register("ell_main", 100, generation=4, name="b1", device=0)
    out = [led.totals(), sorted(
        line for line in reg.render().splitlines()
        if line.startswith("authz_device"))]
    led.retire_generation(4)
    return out + [led.totals(), sorted(
        line for line in reg.render().splitlines()
        if line.startswith("authz_device"))]


def kernel_storms(ns):
    ka = ns.devtel.KernelAccounting(registry=ns.m.Registry())
    t0 = 1000.0
    ka.note_compile(64, now=t0)
    ka.note_jit_hit(64)
    ka.note_jit_hit(64)
    out = [ka.snapshot()]
    for i in range(ns.devtel.STORM_THRESHOLD):
        ka.note_compile(64, now=t0 + i)
    out.append(ka.snapshot()["storms"])
    ka.note_compile(128, now=t0)
    ka.note_compile(128, now=t0 + ns.devtel.STORM_WINDOW_S + 1)
    return out + [ka.snapshot()]


def kernel_entries_gauge(ns):
    ka = ns.devtel.KernelAccounting(registry=ns.m.Registry())

    class FakeCache:
        def __init__(self):
            self._jits = {}

    c = FakeCache()
    ka.track(c)
    out = [ka.snapshot()["entries"]]
    c._jits[8] = object()
    c._jits[16] = object()
    out.append(ka.snapshot()["entries"])
    del c
    gc.collect()
    return out + [ka.snapshot()["entries"]]


def kernel_spans(ns):
    reg = ns.m.Registry()
    ka = ns.devtel.KernelAccounting(registry=reg)
    for phase, kind, bucket, secs in (("kernel.device", "check", 64, 0.5),
                                      ("kernel.device", "lookup_batch", 256,
                                       0.25),
                                      ("kernel.launch", "check", 64, 0.125),
                                      ("kernel.wait", "", "", 1.0)):
        ka.note_kernel_span(phase, {"kind": kind, "bucket": bucket}, secs)
    ns.gate(False)
    try:
        ka.note_kernel_span("kernel.device", {"bucket": 64}, 9.0)
        ka.note_jit_hit(64)
        ka.note_compile(64)
    finally:
        ns.gate(True)
    h = reg.get("authz_kernel_time_seconds")
    return [ka.snapshot(), sorted(h.raw().items())]


def occupancy(ns):
    occ = ns.devtel.BatchOccupancy(registry=ns.m.Registry())
    occ.record("lookup", 3, 29)
    occ.record("lookup", 32, 0)
    occ.record("check", 0, 0)
    occ.note_collapsed(5)
    return [occ.snapshot()]


def rebuild_accounting(ns):
    ra = ns.devtel.RebuildAccounting(registry=ns.m.Registry())
    ra.note_rebuild("sync")
    ra.note_inflight(+1)
    ra.note_rebuild("background")
    out = [ra.snapshot(), ra.inflight]
    ra.note_inflight(-1)
    ra.note_inflight(-1)
    return out + [ra.snapshot()]


def _http_registry(ns):
    reg = ns.m.Registry()
    reg.histogram("proxy_http_request_seconds", "", labels=("verb",),
                  buckets=(0.1, 0.25, 0.5, 1.0))
    reg.counter("proxy_http_requests_total", "", labels=("verb", "code"))
    phases = reg.histogram("authz_request_phase_seconds", "",
                           labels=("phase",), buckets=(0.1, 0.25, 0.5, 1.0))
    return reg, phases


# fields of a window that read other process-wide state or the clock
_WALL = ("ts", "slow_traces", "timeline", "hbm", "occupancy", "jit")


def _window(snap):
    return {k: v for k, v in snap.items() if k not in _WALL}


def flight_windows(ns):
    reg, phases = _http_registry(ns)
    fr = ns.devtel.FlightRecorder(window_s=1.0, capacity=4, registry=reg)
    fr.capture(now=time.time())
    for _ in range(90):
        fr.observe_request(0.05, 200)
        phases.observe(0.05, phase="execute")
    for _ in range(10):
        fr.observe_request(0.4, 200)
        phases.observe(0.4, phase="execute")
    snap = fr.capture(now=time.time())
    out = fr.snapshots()
    return [_window(snap), len(out),
            [sorted(k for k in s if not k.startswith("_")) for s in out]]


def flight_first_window(ns):
    reg, phases = _http_registry(ns)
    for _ in range(500):
        phases.observe(0.05, phase="execute")
    fr = ns.devtel.FlightRecorder(window_s=1.0, capacity=4, registry=reg)
    out = [_window(fr.capture())]
    phases.observe(0.05, phase="execute")
    return out + [_window(fr.capture())]


def flight_burn_rates(ns):
    reg, _ = _http_registry(ns)
    slo = ns.devtel.Slo("latency_p99", "latency", objective=0.01,
                        threshold_s=0.25)
    err = ns.devtel.Slo("error_rate", "error", objective=0.001)
    fr = ns.devtel.FlightRecorder(window_s=1.0, capacity=8,
                                  slos=(slo, err), registry=reg,
                                  long_windows=4)
    fr.capture()
    for _ in range(95):
        fr.observe_request(0.05, 200)
    for _ in range(5):
        fr.observe_request(0.6, 500)
    out = [_window(fr.capture()), fr.burning(), fr.describe_slos(),
           sorted(line for line in reg.render().splitlines()
                  if line.startswith("authz_slo_burn_rate{"))]
    for _ in range(100):
        fr.observe_request(0.05, 200)
    return out + [_window(fr.capture()), fr.burning()]


def flight_cache_and_queues(ns):
    reg, _ = _http_registry(ns)
    hits = reg.counter("authz_decision_cache_hits_total", "",
                       labels=("verb",))
    misses = reg.counter("authz_decision_cache_misses_total", "",
                         labels=("verb",))
    stats = {"check_queue_depth": 3, "lr_queue_depth": 5,
             "inflight_batch": 7, "other": 1}
    fr = ns.devtel.FlightRecorder(window_s=1.0, capacity=3, registry=reg,
                                  stats_fn=lambda: stats)
    hits.inc(4, verb="lookup")
    misses.inc(1, verb="check")
    out = [_window(fr.capture())]
    hits.inc(6, verb="check")
    misses.inc(2, verb="lookup")
    out.append(_window(fr.capture()))
    out.append(_window(fr.capture()))
    # the ring keeps `capacity` windows
    fr.capture()
    return out + [len(fr.snapshots())]


def flight_long_horizon_clamp(ns):
    fr = ns.devtel.FlightRecorder(window_s=1.0, capacity=4, long_windows=12,
                                  registry=ns.m.Registry())
    fr2 = ns.devtel.FlightRecorder(window_s=1.0, capacity=64,
                                   long_windows=1, registry=ns.m.Registry())
    return [fr.long_windows, fr2.long_windows]


def flight_exact_threshold(ns):
    slo = ns.devtel.Slo("latency_p99", "latency", objective=0.5,
                        threshold_s=0.25)
    fr = ns.devtel.FlightRecorder(window_s=1.0, capacity=4, slos=(slo,),
                                  registry=ns.m.Registry())
    fr.observe_request(0.25, 200)
    fr.observe_request(0.2501, 200)
    return [fr.capture()["_slo_tallies"]]


def quantiles(ns):
    q = ns.devtel._quantile_from_counts
    b = (0.1, 0.25, 0.5, 1.0)
    return [q(b, [0, 0, 0, 0, 0], 0.5), q(b, [10, 0, 0, 0, 0], 0.5),
            q(b, [0, 4, 4, 2, 0], 0.99), q(b, [1, 0, 0, 0, 9], 0.99),
            ns.devtel._sample_quantile([], 0.5),
            ns.devtel._sample_quantile([1, 2, 3, 4], 0.5),
            ns.devtel._sample_quantile([1, 2, 3, 4], 0.99)]


FEEDS = [ledger_accounting, ledger_defer_retire, ledger_retire_and_peak,
         ledger_gate_blocks_additions, ledger_device_rows, kernel_storms,
         kernel_entries_gauge, kernel_spans, occupancy, rebuild_accounting,
         flight_windows, flight_first_window,
         flight_burn_rates, flight_cache_and_queues,
         flight_long_horizon_clamp, flight_exact_threshold, quantiles]


@pytest.mark.parametrize("feed", FEEDS, ids=[f.__name__ for f in FEEDS])
def test_feed_matches_reference(feed):
    assert feed(PORT) == feed(REF)


def test_reference_assertions_hold_on_the_port():
    """The reference tests' own assertions on the port's outputs."""
    assert ledger_accounting(PORT) == [1700, {"id_view": 200,
                                              "tables": 1500},
                                       1700, 1500, 200, 1300, 0]
    assert ledger_defer_retire(PORT) == [500, 0, {"tables": 64}]
    assert ledger_retire_and_peak(PORT)[:5] == [3000, 1000, 2000, 3000, 0]
    assert ledger_gate_blocks_additions(PORT) == [1000, 1000, 0]
    snap, storms, last = kernel_storms(PORT)
    assert (snap["hits"], snap["misses"], snap["storms"]) == (2, 1, 0)
    assert storms == 1 and last["storms"] == 1
    assert kernel_entries_gauge(PORT) == [0, 2, 0]
    burn = flight_burn_rates(PORT)
    assert burn[0]["slo"]["latency_p99"]["short"] == pytest.approx(5.0)
    assert burn[0]["slo"]["error_rate"]["short"] == pytest.approx(50.0)
    assert {b["slo"] for b in burn[1]} == {"latency_p99", "error_rate"}
    assert burn[4]["slo"]["latency_p99"]["long"] == pytest.approx(2.5)
    assert burn[5] == []


def test_storms_count_recaptures_of_the_same_tables():
    """Captures for new owners (a new generation's cache, a flush's new
    tables) are no storm however many came before; recapturing the same
    graphs past the threshold inside the window is."""
    ka = PORT.devtel.KernelAccounting(registry=PORT.m.Registry())
    t0 = 1000.0
    for v in range(2 * PORT.devtel.STORM_THRESHOLD):
        ka.note_compile(256, now=t0 + v, owner=v)
    assert ka.snapshot()["storms"] == 0
    for i in range(PORT.devtel.STORM_THRESHOLD + 1):
        ka.note_compile(256, now=t0 + 10 + i, owner=99)
    assert ka.snapshot()["storms"] == 1


def test_tensor_bytes_counts_storage_once():
    import torch
    t = torch.zeros((4, 8), dtype=torch.int32)
    assert devtel.tensor_bytes(t) == 128
    assert devtel.tensor_bytes(t, t[1:], t.view(-1), None) == 128
    assert devtel.tensor_bytes(t, torch.zeros(3, dtype=torch.int64)) == 152
    assert devtel.tensor_bytes() == 0


# -- the endpoint's ledger contract ------------------------------------------------

def _docs(n=6):
    return [f"doc:d{i}#viewer@user:u{i % 3}" for i in range(n)]


def make_pair(n_docs=6):
    port = TorchEndpoint(sch.parse_schema(SCHEMA), device="cpu")
    ref = JaxEndpoint(ref_sch.parse_schema(SCHEMA))
    for ep, T in ((port, types), (ref, ref_types)):
        ep.store.write([T.RelationshipUpdate(T.UpdateOp.TOUCH,
                                             T.parse_relationship(r))
                        for r in _docs(n_docs)])
    return port, ref


def _gen_kinds(led, gen) -> dict:
    return {k: led.generation_bytes(gen, k)
            for k in ("ell_main", "ell_aux", "ell_cav", "segment_edges",
                      "state_arena", "id_view", "leopard_plane")}


def test_rebuild_returns_ledger_to_exact_total():
    port, ref = make_pair()
    s = types.SubjectRef("user", "u0")
    run(port.lookup_resources("doc", "view", s))
    gc.collect()
    gen1 = port._devtel_gen
    g1 = devtel.LEDGER.generation_bytes(gen1)
    assert gen1 >= 1 and g1 > 0
    total_before = devtel.LEDGER.total()
    port.force_rebuild()
    run(port.lookup_resources("doc", "view", s))
    gen2 = port._devtel_gen
    assert gen2 > gen1
    g2 = devtel.LEDGER.generation_bytes(gen2)
    assert devtel.LEDGER.generation_bytes(gen1) == 0
    assert _gen_kinds(devtel.LEDGER, gen1) == dict.fromkeys(
        _gen_kinds(devtel.LEDGER, gen1), 0)
    assert devtel.LEDGER.total() == total_before - g1 + g2
    # the tables count the reference's bytes (same shapes, int32/uint32);
    # the id views, host arrays in the port, are not rows of its ledger
    run(ref.lookup_resources("doc", "view", ref_types.SubjectRef("user",
                                                                 "u0")))
    rk = _gen_kinds(ref_devtel.LEDGER, ref._devtel_gen)
    pk = _gen_kinds(devtel.LEDGER, gen2)
    for kind in ("ell_main", "ell_aux", "ell_cav"):
        assert pk[kind] == rk[kind], kind
    assert rk["id_view"] > 0 and pk["id_view"] == 0
    # the port's arena is its three state buffers (the reference donates
    # one) and its check tail (the gather pairs in, the delta pairs and
    # packed answers out): registered from the tensors' storage
    arena = next(iter(port.graph().kernel._arenas.values()))
    assert pk["state_arena"] == devtel.tensor_bytes(
        arena.x0, arena.a, arena.b, arena.live, arena.tail, arena.out)


def test_warm_start_registers_generation():
    port, _ = make_pair()
    gc.collect()
    before = devtel.LEDGER.total()
    port.warm_start()
    gen = port._devtel_gen
    g = devtel.LEDGER.generation_bytes(gen)
    assert gen >= 1 and g > 0
    assert devtel.LEDGER.total() == before + g
    total = devtel.LEDGER.total()
    port.warm_start()
    assert devtel.LEDGER.total() == total


def test_delta_rebuild_accounts_exactly():
    port, _ = make_pair()
    req = types.CheckRequest(types.ObjectRef("doc", "d0"), "view",
                             types.SubjectRef("user", "u0"))
    run(port.check_permission(req))
    gc.collect()
    gen1 = port._devtel_gen
    g1 = devtel.LEDGER.generation_bytes(gen1)
    total_before = devtel.LEDGER.total()
    port.store.write([types.RelationshipUpdate(
        types.UpdateOp.TOUCH, types.parse_relationship("doc:d0#viewer@user:*"))])
    run(port.check_permission(types.CheckRequest(
        types.ObjectRef("doc", "d0"), "view", types.SubjectRef("user", "zz"))))
    gen2 = port._devtel_gen
    assert gen2 > gen1
    assert devtel.LEDGER.generation_bytes(gen1) == 0
    assert devtel.LEDGER.total() == (
        total_before - g1 + devtel.LEDGER.generation_bytes(gen2))


@pytest.mark.parametrize("kernel", ["ell", "segment"])
def test_ledger_rows_are_the_graph_tensors(kernel):
    port = TorchEndpoint(sch.parse_schema(SCHEMA), device="cpu",
                         kernel=kernel)
    port.store.write([types.RelationshipUpdate(
        types.UpdateOp.TOUCH, types.parse_relationship(r)) for r in _docs()])
    port.warm_start(prewarm=True)
    g = port.graph()
    gen = port._devtel_gen
    rows = ({"ell_main": [g.dev_main], "ell_aux": [g.dev_aux]}
            if kernel == "ell" else {"segment_edges": [g.edge_src,
                                                       g.edge_dst]})
    for kind, tensors in rows.items():
        assert devtel.LEDGER.generation_bytes(gen, kind) == \
            devtel.tensor_bytes(*tensors)
    assert sum(devtel.LEDGER.generation_bytes(gen, k) for k in rows) > 0
    arenas = list(g.kernel._arenas.items())
    assert arenas, "the prewarm pooled no arena"
    want = sum(devtel.tensor_bytes(*g.kernel._arena_tensors(a))
               for _, a in arenas)
    assert devtel.LEDGER.generation_bytes(gen, "state_arena") == want
    # a discarded arena leaves the ledger
    n_words = arenas[0][0]
    before = devtel.LEDGER.generation_bytes(gen, "state_arena")
    g.kernel.discard_arena(n_words)
    assert devtel.LEDGER.generation_bytes(gen, "state_arena") == (
        before - devtel.tensor_bytes(*g.kernel._arena_tensors(arenas[0][1])))


def test_real_batches_record_occupancy_and_device_time():
    port, ref = make_pair()
    before = devtel.OCCUPANCY.snapshot()
    rbefore = ref_devtel.OCCUPANCY.snapshot()
    kbefore = devtel.KERNELS.snapshot()["time_by_bucket_s"]
    for ep, T in ((port, types), (ref, ref_types)):
        run(ep.lookup_resources_batch(
            "doc", "view", [T.SubjectRef("user", f"u{i}") for i in range(3)]))
        run(ep.check_bulk_permissions([T.CheckRequest(
            T.ObjectRef("doc", "d0"), "view", T.SubjectRef("user", "u0"))]))
    after = devtel.OCCUPANCY.snapshot()
    rafter = ref_devtel.OCCUPANCY.snapshot()
    for k in ("batches", "useful", "padded"):
        assert after[k] - before[k] == rafter[k] - rbefore[k], k
    assert after["padded"] > before["padded"]
    # the device windows land by lane bucket
    kafter = devtel.KERNELS.snapshot()["time_by_bucket_s"]
    assert any(kafter.get(b, 0.0) > kbefore.get(b, 0.0) for b in kafter)


def test_singleflight_collapse_counted():
    from spicedb_kubeapi_proxy_tpu.spicedb.dispatch import (
        BatchingEndpoint as RefBatching)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.dispatch import (
        BatchingEndpoint)
    port, ref = make_pair()
    deltas = []
    for dt, wrap, ep, T in ((devtel, BatchingEndpoint, port, types),
                            (ref_devtel, RefBatching, ref, ref_types)):
        before = dt.OCCUPANCY.snapshot()["collapsed"]
        b = wrap(ep)
        s = T.SubjectRef("user", "u0")

        async def go():
            return await asyncio.gather(*[
                b.lookup_resources("doc", "view", s) for _ in range(4)])

        results = run(go())
        assert all(sorted(r) == sorted(results[0]) for r in results)
        deltas.append(dt.OCCUPANCY.snapshot()["collapsed"] - before)
    assert deltas[0] == deltas[1] > 0


# -- the proxy's /debug surfaces, /readyz and SLO intake ---------------------------

SERVER_SCHEMA = """
definition user {}

definition pod {
    relation creator: user
    permission view = creator
}
"""

SERVER_RULES = """
apiVersion: authzed.com/v1alpha1
kind: ProxyRule
metadata: {name: get-pods}
match: [{apiVersion: v1, resource: pods, verbs: [get]}]
check: [{tpl: "pod:{{namespacedName}}#view@user:{{user.name}}"}]
"""

PORT_SURFACES = {"/debug/traces", "/debug/decisions", "/debug/flight",
                 "/debug/timeline", "/debug/workload", "/debug/profile",
                 "/debug/replication", "/debug/sharding", "/debug/fleet",
                 "/debug/tail"}


def make_server(root, url, **extra):
    import importlib
    kubefake = importlib.import_module(f"{root}.kubefake.apiserver")
    httpcore = importlib.import_module(f"{root}.proxy.httpcore")
    server_mod = importlib.import_module(f"{root}.proxy.server")
    eps = importlib.import_module(f"{root}.spicedb.endpoints")
    T = importlib.import_module(f"{root}.spicedb.types")
    kube = kubefake.FakeKubeApiServer()
    kube.seed("", "v1", "pods",
              {"metadata": {"name": "p0", "namespace": "team-a"}})
    server = server_mod.ProxyServer(server_mod.Options(
        spicedb_endpoint=url,
        bootstrap=eps.Bootstrap(schema_text=SERVER_SCHEMA),
        rules_yaml=SERVER_RULES,
        upstream_transport=httpcore.HandlerTransport(kube),
        slo_check_p99_ms=250.0, **extra))
    server.endpoint.store.write([T.RelationshipUpdate(
        T.UpdateOp.TOUCH,
        T.parse_relationship("pod:team-a/p0#creator@user:alice"))])
    return server


def servers(port_url="torch://?device=cpu", **extra):
    return (make_server("spicedb_kubeapi_proxy_tpu_torch", port_url, **extra),
            make_server("spicedb_kubeapi_proxy_tpu", "jax://", **extra))


@pytest.mark.parametrize("url", ["torch://?device=cpu", "embedded://",
                                 "torch://?device=cpu&cache=1"])
def test_index_enumerates_the_ported_surfaces(url):
    port, ref = servers(url)

    async def go(server):
        resp = await server.get_embedded_client(user="alice").get("/debug")
        return resp.status, json.loads(resp.body)["surfaces"]

    (st, got), (rst, want) = run(go(port)), run(go(ref))
    assert st == rst == 200
    assert set(got) == PORT_SURFACES
    # the fleet plane's two surfaces included, the reference's set
    assert set(want) == set(got)
    assert all(isinstance(d, str) and d for d in got.values())


@pytest.mark.parametrize("path", ["/debug/bogus", "/debug/fleet",
                                  "/debug/tail"])
def test_unknown_surface_uniform_404(path):
    """An unknown surface answers 404 NotFound; the fleet plane's two,
    on a proxy without fleet peers, answer as the reference's do (over
    recorders emptied first: they are process-wide)."""
    from spicedb_kubeapi_proxy_tpu.utils import tracing as ref_tracing
    from spicedb_kubeapi_proxy_tpu_torch.utils import tracing
    tracing.RECORDER.drain()
    ref_tracing.RECORDER.drain()
    port, ref = servers()

    async def go(server):
        resp = await server.get_embedded_client(user="alice").get(path)
        return resp.status, json.loads(resp.body)

    got = run(go(port))
    if path == "/debug/bogus":
        assert (got[0], got[1]["reason"]) == (404, "NotFound")
        return
    want = run(go(ref))
    assert got[0] == want[0] == 200
    if path == "/debug/fleet":
        assert got[1] == want[1] == {
            "enabled": False, "reason": "no --fleet-peers configured",
            "tier": "leader"}
    else:
        # no peers: the local traces alone, too few to diff
        assert got[1]["enabled"] is want[1]["enabled"] is True
        assert got[1]["ranked"] == want[1]["ranked"] == []
        assert got[1]["tier"] == want[1]["tier"] == "leader"


def test_replication_surface_without_a_role_matches_the_reference():
    """A proxy with neither a data dir nor a leader reports replication
    as not configured, in the reference's words."""
    port, ref = servers()

    async def go(server):
        resp = await server.get_embedded_client(user="alice").get(
            "/debug/replication")
        return resp.status, json.loads(resp.body)

    got = run(go(port))
    assert got == run(go(ref))
    assert got[0] == 200 and got[1]["enabled"] is False


def test_sharding_surface_without_shards_matches_the_reference():
    """A proxy with one shard reports sharding as not configured, in the
    reference's words; with the SHARDING switch off, as disabled."""
    from spicedb_kubeapi_proxy_tpu.utils.features import GATES
    from spicedb_kubeapi_proxy_tpu_torch.utils import features
    port, ref = servers()

    async def go(server):
        resp = await server.get_embedded_client(user="alice").get(
            "/debug/sharding")
        return resp.status, json.loads(resp.body)

    got = run(go(port))
    assert got == run(go(ref))
    assert got[0] == 200 and got[1]["enabled"] is False
    features.SHARDING = False
    GATES.set("Sharding", False)
    try:
        off = run(go(port))
        assert off == run(go(ref))
        assert off[1]["reason"] == "Sharding feature gate disabled"
    finally:
        features.SHARDING = True
        GATES.reset()


def test_surfaces_unauthenticated_401_like_the_reference():
    port, ref = servers()

    async def go(server):
        anon = server.get_embedded_client()
        return [(p, (await anon.get(p)).status)
                for p in ["/debug", *sorted(PORT_SURFACES)]]

    got = run(go(port))
    assert got == run(go(ref))
    assert {s for _, s in got} == {401}


def test_flight_serves_windows_after_capture():
    out = []
    for server in servers():
        alice = server.get_embedded_client(user="alice")

        async def go():
            resp = await alice.get("/api/v1/namespaces/team-a/pods/p0")
            assert resp.status == 200
            server.flight.capture()
            server.flight.capture()
            resp = await alice.get("/debug/flight")
            return resp.status, json.loads(resp.body)

        st, flight = run(go())
        assert st == 200 and flight["enabled"] is True
        newest = flight["windows"][0]
        http = flight["windows"][1]["http"]
        out.append((len(flight["windows"]), flight["slos"],
                    flight["burning"], sorted(newest),
                    (http["requests"], http["errors"], sorted(http))))
    assert out[0] == out[1]
    assert out[0][0] == 2 and out[0][4][0] == 1


def test_readyz_surfaces_burning_slo():
    out = []
    for server in servers():
        alice = server.get_embedded_client(user="alice")

        async def go():
            first = (await alice.get("/readyz")).body
            server.flight.capture()
            for _ in range(10):
                server.flight.observe_request(0.9, 200)
            server.flight.capture()
            return first, (await alice.get("/readyz")).body

        out.append(run(go()))
    assert out[0] == out[1]
    assert out[0][0] == b"ok" and b"slo latency_p99 burning" in out[0][1]


def test_health_and_introspection_do_not_dilute_slo():
    out = []
    for server in servers():
        alice = server.get_embedded_client(user="alice")

        async def go():
            server.flight.capture()
            for _ in range(5):
                for path in ("/readyz", "/metrics", "/debug/flight",
                             "/debug/"):
                    await alice.get(path)
            resp = await alice.get("/api/v1/namespaces/team-a/pods/p0")
            snap = server.flight.capture()
            return (resp.status, snap["_slo_tallies"]["latency_p99"][1],
                    snap["http"]["requests"])

        out.append(run(go()))
    assert out[0] == out[1] == (200, 1, 1)


def test_flight_reports_gate_state(monkeypatch):
    port, ref = servers()
    monkeypatch.setattr(features, "DEVICE_TELEMETRY", False)
    monkeypatch.setattr(GATES._gates["DeviceTelemetry"], "value", False)
    out = []
    for server in (port, ref):
        async def go():
            resp = await server.get_embedded_client(user="alice").get(
                "/debug/flight")
            return json.loads(resp.body)

        flight = run(go())
        out.append((flight["enabled"], flight["reason"]))
    assert out[0] == out[1] and out[0][0] is False


def test_shed_slo_burn_sheds_reads_while_burning():
    out = []
    for server in servers(shed_slo_burn=True):
        alice = server.get_embedded_client(user="alice")

        async def go():
            got = [(await alice.get(
                "/api/v1/namespaces/team-a/pods/p0")).status]
            server.flight.capture()
            for _ in range(10):
                server.flight.observe_request(0.9, 200)
            server.flight.capture()
            got.append((await alice.get(
                "/api/v1/namespaces/team-a/pods/p0")).status)
            got.append((await alice.get("/readyz")).body.count(b"[!]"))
            return got

        out.append(run(go()))
    assert out[0] == out[1] == [200, 429, 2]
