"""The port's dispatch timeline (utils/timeline.py) held against the
reference's.

The reference's tests/test_timeline.py cases, each event feed recorded
into an isolated `Timeline` of both packages: overlap math on synthetic
interleavings, ring bounds, the chrome-trace export (normalized: the
event list with `ts` relative to the first slice, and the process name
apart), summaries (stalls, bandwidth, roofline, worst dispatch,
compile-contaminated kernels), the kernel-span hook and the switch-off
behavior must be equal.  The memory rate the port detects is the card's
(3,350 GB/s for the NVIDIA H100 80GB HBM3, none for an unknown card or
without one; the reference's TPU figure is not carried over).  End to
end, `torch://?device=cpu` records pack, kernel (the batch's device
window), transfer, extract and rebuild slices tied by batch id, and the
flight recorder links each window to its timeline condensate.
"""

import asyncio
import json
import threading
from types import SimpleNamespace

import pytest

from spicedb_kubeapi_proxy_tpu.utils import metrics as ref_m
from spicedb_kubeapi_proxy_tpu.utils import timeline as ref_timeline
from spicedb_kubeapi_proxy_tpu.utils import tracing as ref_tracing
from spicedb_kubeapi_proxy_tpu.utils.features import GATES
from spicedb_kubeapi_proxy_tpu_torch.utils import features
from spicedb_kubeapi_proxy_tpu_torch.utils import metrics as m
from spicedb_kubeapi_proxy_tpu_torch.utils import timeline, tracing


def _ref_gate(on):
    GATES.set("Timeline", on)


def _port_gate(on):
    features.TIMELINE = on


REF = SimpleNamespace(tl=ref_timeline, m=ref_m, tracing=ref_tracing,
                      gate=_ref_gate)
PORT = SimpleNamespace(tl=timeline, m=m, tracing=tracing, gate=_port_gate)


@pytest.fixture(autouse=True)
def both_gates_on(monkeypatch):
    monkeypatch.setattr(GATES._gates["Timeline"], "value", True)
    monkeypatch.setattr(features, "TIMELINE", True)


def make(ns, **kw):
    kw.setdefault("registry", ns.m.Registry())
    return ns.tl.Timeline(**kw)


def ev(ns, stage, start, end, batch=None, track="device", nbytes=0):
    return ns.tl.TimelineEvent(stage, track, start, end, 0, batch, None,
                               nbytes, None)


def norm_trace(trace):
    """A chrome trace with `ts` relative to the first event's, the
    recording thread ids and the process name left out."""
    evs = [dict(e) for e in trace["traceEvents"]]
    t0 = min((e["ts"] for e in evs if e["ph"] != "M"), default=0.0)
    for e in evs:
        if e["ph"] != "M":
            e["ts"] = round(e["ts"] - t0, 1)
        if "args" in e:
            e["args"] = {k: v for k, v in e["args"].items()
                         if k != "thread"}
        if e["name"] == "process_name":
            e["args"] = {}
    od = dict(trace["otherData"])
    od.pop("epoch_unix", None)
    return {"traceEvents": evs, "displayTimeUnit": trace["displayTimeUnit"],
            "otherData": od}


# -- overlap math ----------------------------------------------------------------

def overlap_cases(ns):
    e = lambda *a, **k: ev(ns, *a, **k)  # noqa: E731
    o = ns.tl.overlap_stats
    db = []
    for n in range(4):
        db += [e("kernel", float(n), n + 0.8, batch=n),
               e("transfer", n + 1.0, n + 1.5, batch=n),
               e("kernel", n + 1.0, n + 1.8, batch=n + 1)]
    return [
        o([]),
        o([e("kernel", 0.0, 1.0, batch=1)]),
        o([e("transfer", 0.0, 10.0, batch=1), e("kernel", 2.0, 6.0,
                                                 batch=2)]),
        o([e("transfer", 0.0, 10.0, batch=1), e("kernel", 0.0, 10.0,
                                                 batch=1)]),
        o([e("transfer", 0.0, 10.0, batch=1), e("kernel", 2.0, 6.0, batch=2),
           e("kernel", 4.0, 8.0, batch=3)]),
        o([e("transpose", 0.0, 4.0, batch=1), e("kernel", 0.0, 4.0,
                                                 batch=2)]),
        o(db),
        o([e("pack", 0.0, 2.0, batch=1), e("transfer", 2.0, 3.0, batch=1),
           e("kernel", 0.5, 2.5, batch=2), e("kernel", 2.5, 3.0)]),
    ]


def test_overlap_math_matches_reference():
    got = overlap_cases(PORT)
    assert got == overlap_cases(REF)
    assert got[0] is None and got[1] is None
    assert got[2]["ratio"] == pytest.approx(0.4)
    assert got[3]["ratio"] == 0.0
    assert got[4]["ratio"] == pytest.approx(0.6)
    assert got[5]["ratio"] == pytest.approx(1.0)
    assert got[6]["ratio"] == pytest.approx(1.0)


# -- feeds into one timeline ---------------------------------------------------------

def ring_since(ns):
    tl = make(ns, capacity=16)
    tl.record("pack", "host", 1.0, 2.0)
    tl.record("pack", "host", 10.0, 11.0)
    return [len(tl.events(since=5.0)), len(tl.events())]


def chrome_schema(ns):
    tl = make(ns, capacity=32)
    t0 = 5.0
    tl.record("pack", "host", t0, t0 + 0.001, batch=7, bucket=64,
              nbytes=256)
    tl.record("kernel", "device", t0, t0 + 0.01, batch=7, bucket=64,
              nbytes=1 << 20)
    tl.record("rebuild", "rebuild", t0, t0 + 0.5, nbytes=1 << 24)
    tl.record("fused", "dispatcher", t0, t0 + 0.02, bucket=8)
    tl.record("authn", "serving", t0, t0 + 0.003)
    trace = tl.chrome_trace()
    json.dumps(trace)
    return [norm_trace(trace)]


def summary_other_data(ns):
    tl = make(ns, capacity=8)
    tl.record("pack", "host", 0.0, 1.0)
    od = tl.chrome_trace()["otherData"]
    return [od["summary"], od["capacity"]]


def stalls(ns):
    reg = ns.m.Registry()
    tl = make(ns, capacity=32, registry=reg)
    tl.record("pack", "host", 0.0, 0.5)
    tl.record("transpose", "device", 0.0, 0.25)
    tl.record("rebuild", "rebuild", 0.0, 2.0)
    tl.record("compact", "rebuild", 0.0, 1.0)
    tl.record("warm_start", "rebuild", 0.0, 4.0)
    tl.record("compile", "device", 0.0, 0.125)
    tl.record("kernel", "device", 0.0, 9.0)
    c = reg.get("authz_dispatch_stall_seconds")
    return [tl.summary()["stall_s"], c.value(cause="rebuild"),
            c.value(cause="pack"), tl.snapshot()]


def bandwidth_roofline(ns):
    tl = make(ns, capacity=32, hbm_peak_gbps=1.0)
    tl.record("kernel", "device", 0.0, 1.0, batch=1, nbytes=500_000_000)
    tl.record("transfer", "device", 1.0, 1.5, batch=1, nbytes=1000)
    return [tl.summary()]


def roofline_basis(ns):
    tl = make(ns, capacity=32, hbm_peak_gbps=2.0)
    tl.record("kernel", "device", 0.0, 1.0, batch=1, nbytes=10**9,
              measured=True)
    s1 = tl.summary()
    tl.record("kernel", "device", 1.0, 2.0, batch=2, nbytes=10**9)
    return [s1, tl.summary()]


def roofline_without_peak(ns):
    tl = make(ns, capacity=8)
    tl._hbm_peak_detected = 0.0
    tl.record("kernel", "device", 0.0, 1.0, nbytes=1000)
    return [tl.summary()["roofline_fraction"]]


def worst_dispatch(ns):
    tl = make(ns, capacity=32)
    tl.record("pack", "host", 0.0, 0.1, batch=1)
    tl.record("kernel", "device", 0.1, 0.2, batch=1)
    tl.record("pack", "host", 0.0, 0.1, batch=2)
    tl.record("kernel", "device", 0.1, 3.0, batch=2)
    return [tl.summary()["worst_dispatch"]]


def compile_contaminated(ns):
    tl = make(ns, capacity=16, hbm_peak_gbps=1.0)
    t0 = 100.0
    tl.record("compile", "device", t0 + 0.1, t0 + 5.0)
    tl.record("kernel", "device", t0, t0 + 6.0, batch=1, nbytes=1_000_000)
    out = [[(e.stage, e.attrs) for e in tl.events()], tl.summary()]
    tl.record("kernel", "device", t0 + 10.0, t0 + 11.0, batch=2,
              nbytes=500_000_000)
    return out + [tl.summary()]


def rebuild_not_a_bandwidth(ns):
    reg = ns.m.Registry()
    tl = make(ns, capacity=8, registry=reg)
    tl.record("rebuild", "rebuild", 0.0, 2.0, nbytes=1 << 30)
    g = reg.get("authz_dispatch_bandwidth_bytes_per_sec")
    return [tl.summary()["bandwidth_bytes_per_s"], g.render()]


def serving_spans(ns):
    reg = ns.m.Registry()
    tl = make(ns, capacity=8, registry=reg)
    with tl.serving_span("authn") as a:
        a["nbytes"] = 3
    with tl.span("pack", "host", batch=4) as a:
        a["nbytes"] = 64
    h = reg.get("authz_serving_stage_seconds")
    return [[(e.stage, e.track, e.batch, e.nbytes) for e in tl.events()],
            sorted((k, v[2]) for k, v in h.raw().items())]


def gate_off(ns):
    tl = make(ns, capacity=8)
    tl.record("pack", "host", 0.0, 1.0)
    ns.gate(False)
    try:
        before = tl.snapshot()
        n = len(tl.events())
        for _ in range(100):
            tl.record("pack", "host", 0.0, 1.0, nbytes=1 << 20)
        s1 = tl.span("pack", "host")
        s2 = tl.span("kernel", "device", nbytes=5)
        with s1 as attrs:
            attrs["x"] = 1
        with s2 as attrs2:
            pass
        out = [s1 is s2, attrs2, len(tl.events()) == n,
               tl.snapshot() == before,
               tl.serving_span("authn") is s1]
        trace = norm_trace(tl.chrome_trace())
    finally:
        ns.gate(True)
    tl.record("pack", "host", 0.0, 1.0)
    return out + [len(tl.events()), trace]


def threaded_churn(ns):
    tl = make(ns, capacity=64)
    errors = []

    def writer(i):
        try:
            for k in range(200):
                t0 = ns.tl.now()
                tl.record("pack", "host", t0, t0 + 1e-6,
                          batch=i * 1000 + k, nbytes=64)
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    def reader():
        try:
            for _ in range(50):
                tl.summary()
                tl.chrome_trace()
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    threads = ([threading.Thread(target=writer, args=(i,))
                for i in range(8)]
               + [threading.Thread(target=reader) for _ in range(2)])
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    batches = sorted(e.batch for e in tl.events())
    return [errors, len(tl.events()), tl.snapshot()["events_total"],
            batches[0] >= 100]


FEEDS = [ring_since, chrome_schema, summary_other_data, stalls,
         bandwidth_roofline, roofline_basis, roofline_without_peak,
         worst_dispatch, compile_contaminated, rebuild_not_a_bandwidth,
         serving_spans, gate_off, threaded_churn]


@pytest.mark.parametrize("feed", FEEDS, ids=[f.__name__ for f in FEEDS])
def test_feed_matches_reference(feed):
    assert feed(PORT) == feed(REF)


def test_reference_assertions_hold_on_the_port():
    s = stalls(PORT)[0]
    assert s["pack"] == pytest.approx(0.5)
    assert s["rebuild"] == pytest.approx(7.0)
    assert "kernel" not in s
    b = bandwidth_roofline(PORT)[0]
    assert b["roofline_fraction"] == pytest.approx(0.5)
    assert b["hbm_peak_gbps"] == pytest.approx(1.0)
    w = worst_dispatch(PORT)[0]
    assert w["batch"] == 2 and w["total_ms"] == pytest.approx(3000.0)
    c = compile_contaminated(PORT)
    assert c[1]["roofline_fraction"] is None
    assert c[2]["roofline_fraction"] == pytest.approx(0.5)
    assert roofline_basis(PORT)[1]["kernel_bytes_basis"] == "mixed"
    g = gate_off(PORT)
    assert g[:5] == [True, {}, True, True, True]
    assert threaded_churn(PORT) == [[], 64, 1600, True]


# -- the card's memory rate --------------------------------------------------------

def test_no_detection_before_any_device_event():
    tl = make(PORT, capacity=8)
    tl.record("pack", "host", 0.0, 1.0, nbytes=64)
    assert tl.hbm_peak_bytes_per_s() == 0.0
    assert tl._hbm_peak_detected is None
    tl.summary()
    tl.chrome_trace()
    assert tl._hbm_peak_detected is None
    tl.record("kernel", "device", 0.0, 1.0, nbytes=64)
    tl.hbm_peak_bytes_per_s()
    # armed by the event; this machine has no card, so no rate
    assert tl._hbm_peak_detected == 0.0
    assert tl.summary()["roofline_fraction"] is None


@pytest.mark.parametrize("name,gbps", [("NVIDIA H100 80GB HBM3", 3350.0),
                                       ("NVIDIA A100-SXM4-40GB", 0.0)])
def test_card_rate_by_device_name(monkeypatch, name, gbps):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: name)
    assert timeline.card_hbm_peak_gbps() == gbps
    tl = make(PORT, capacity=8)
    tl.record("kernel", "device", 0.0, 1.0, nbytes=335 * 10**9)
    s = tl.summary()
    if gbps:
        assert s["hbm_peak_gbps"] == 3350.0
        assert s["roofline_fraction"] == pytest.approx(0.1)
    else:
        assert s["roofline_fraction"] is None


def test_configured_peak_wins_and_zero_restores_detection():
    tl = make(PORT, capacity=8, hbm_peak_gbps=100.0)
    assert tl.hbm_peak_bytes_per_s() == 100e9
    tl.set_hbm_peak(0)
    assert tl.hbm_peak_bytes_per_s() == 0.0   # no device event yet
    tl.set_hbm_peak(3350)
    assert tl.hbm_peak_bytes_per_s() == 3350e9


# -- the kernel-span hook -----------------------------------------------------------

@pytest.mark.parametrize("name,override,want", [
    ("kernel.device", None, ["kernel"]),
    ("kernel.dispatch", None, ["kernel"]),
    ("kernel.transfer", "transpose", ["transpose"]),
    ("kernel.launch", None, []),
    ("kernel.oracle", None, []),
])
def test_kernel_span_hook_matches_reference(name, override, want):
    out = []
    for ns, bid in ((PORT, 525252), (REF, 535353)):
        mark = ns.tl.now()
        with ns.tracing.kernel_span(name, kind="check", bucket=64) as a:
            a["batch_id"] = bid
            a["nbytes"] = 4096
            if override:
                a["timeline_stage"] = override
        evs = [e for e in ns.tl.TIMELINE.events(since=mark)
               if e.batch == bid]
        out.append([(e.stage, e.track, e.nbytes, e.bucket) for e in evs])
    assert out[0] == out[1]
    assert [s for s, *_ in out[0]] == want


def test_device_window_lands_on_the_device_track():
    mark = timeline.now() - 0.5
    tracing.note_device_window(
        "kernel.device", {"kind": "lookup_batch", "bucket": 256,
                          "batch_id": 545454, "nbytes": 1 << 20,
                          "measured": True}, mark, 0.25)
    evs = [e for e in timeline.TIMELINE.events(since=mark)
           if e.batch == 545454]
    assert [(e.stage, e.track, e.bucket, e.nbytes, e.duration,
             e.attrs) for e in evs] == [
        ("kernel", "device", 256, 1 << 20, 0.25, {"measured": True})]


def test_nvtx_range_only_on_a_card(monkeypatch):
    """`kernel_span(nvtx=True)` pushes and pops one NVTX range named after
    the span; an endpoint on the CPU asks for none.  (The range itself
    is recorded only on a card, where Nsight Systems shows it.)"""
    import torch
    calls = []
    monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                        lambda name: calls.append(("push", name)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: calls.append(("pop",)))
    with tracing.kernel_span("kernel.launch", nvtx=True, kind="check"):
        pass
    assert calls == [("push", "kernel.launch"), ("pop",)]
    calls.clear()
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        SubjectRef, parse_relationship)
    ep = create_endpoint("torch://?device=cpu&dispatch=direct",
                         Bootstrap(schema_text=SCHEMA))
    ep.store.bulk_load([parse_relationship("doc:d0#viewer@user:u1")])
    asyncio.run(ep.lookup_resources("doc", "view", SubjectRef("user", "u1")))
    assert calls == []


# -- end to end: torch://?device=cpu emits every stage ---------------------------------

SCHEMA = """
definition user {}
definition doc {
  relation viewer: user
  permission view = viewer
}
"""


def assert_valid_chrome_trace(trace):
    """Every event has ph/ts/pid/tid; X events carry dur; B/E pairs
    balance per (pid, tid)."""
    assert isinstance(trace["traceEvents"], list)
    depth = {}
    for e in trace["traceEvents"]:
        for field in ("ph", "ts", "pid", "tid"):
            assert field in e, f"event missing {field}: {e}"
        if e["ph"] == "X":
            assert "dur" in e and e["dur"] >= 0
        elif e["ph"] == "B":
            depth[(e["pid"], e["tid"])] = depth.get((e["pid"], e["tid"]),
                                                    0) + 1
        elif e["ph"] == "E":
            key = (e["pid"], e["tid"])
            depth[key] = depth.get(key, 0) - 1
            assert depth[key] >= 0, "E without open B"
    assert not any(depth.values()), f"unbalanced B/E: {depth}"


@pytest.mark.parametrize("url", ["torch://?device=cpu&dispatch=direct",
                                 "torch://?device=cpu",
                                 "torch://?device=cpu&kernel=segment"])
def test_lookup_and_check_emit_pipeline_stages(url):
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, SubjectRef, parse_relationship)

    ep = create_endpoint(url, Bootstrap(schema_text=SCHEMA))
    ep.store.bulk_load([parse_relationship(f"doc:d{i}#viewer@user:u1")
                        for i in range(8)])
    mark = timeline.now()

    async def go():
        await ep.check_bulk_permissions([CheckRequest(
            ObjectRef("doc", "d0"), "view", SubjectRef("user", "u1"))])
        return await ep.lookup_resources_batch(
            "doc", "view", [SubjectRef("user", "u1"),
                            SubjectRef("user", "u2")])

    results = asyncio.run(go())
    assert sorted(results[0]) == [f"d{i}" for i in range(8)]
    evs = timeline.TIMELINE.events(since=mark)
    stages = {e.stage for e in evs}
    assert {"pack", "kernel", "transfer", "extract", "rebuild"} <= stages
    kernel_batches = {e.batch for e in evs if e.stage == "kernel"}
    pack_batches = {e.batch for e in evs if e.stage == "pack"}
    assert kernel_batches and kernel_batches <= pack_batches
    # the kernel slices carry measured bytes: executed sweeps x one
    # sweep's modeled bytes
    assert all(e.nbytes > 0 and (e.attrs or {}).get("measured")
               for e in evs if e.stage == "kernel")
    if "dispatch=direct" not in url:
        assert {"fused_start", "fused_finish"} & stages
    trace = timeline.chrome_trace(since=mark)
    assert_valid_chrome_trace(trace)
    assert any(e.get("tid") == 3 and e["ph"] == "X"
               for e in trace["traceEvents"])   # the device track
    s = timeline.summary(since=mark)
    assert s["events"] == len(evs)
    assert s["worst_dispatch"] is not None
    assert s["kernel_bytes_basis"] == "measured"


# -- flight-recorder evidence links ------------------------------------------------------

def test_window_embeds_slow_traces_and_timeline(monkeypatch):
    from spicedb_kubeapi_proxy_tpu_torch.utils import devtel
    monkeypatch.setattr(tracing, "RECORDER",
                        tracing.SlowTraceRecorder(capacity=8))
    fr = devtel.FlightRecorder(window_s=0.05, capacity=4,
                               registry=m.REGISTRY)
    tr = tracing.Trace(op="evidence")
    tr.finish()
    tracing.RECORDER.record(tr)
    timeline.record("pack", "host", timeline.now() - 0.001)
    snap = fr.capture()
    assert any(x["trace_id"] == tr.trace_id for x in snap["slow_traces"])
    assert snap["timeline"] is not None and snap["timeline"]["events"] >= 1
    served = fr.snapshots()[0]
    assert "slow_traces" in served and "timeline" in served


def test_window_timeline_none_when_switched_off(monkeypatch):
    from spicedb_kubeapi_proxy_tpu_torch.utils import devtel
    fr = devtel.FlightRecorder(window_s=0.05, capacity=4,
                               registry=m.REGISTRY)
    monkeypatch.setattr(features, "TIMELINE", False)
    assert fr.capture()["timeline"] is None


def test_exemplars_filter_by_start():
    import time
    out = []
    for tr_mod in (tracing, ref_tracing):
        rec = tr_mod.SlowTraceRecorder(capacity=8)
        t_old = tr_mod.Trace()
        t_old.wall_start -= 1000.0
        t_old.finish()
        rec.record(t_old)
        t_new = tr_mod.Trace()
        t_new.finish()
        rec.record(t_new)
        recent = rec.exemplars(k=5, since_unix=time.time() - 60)
        out.append(([x["trace_id"] == t_new.trace_id for x in recent],
                    len(rec.exemplars(k=5)), len(rec.exemplars(k=1))))
    assert out[0] == out[1] == ([True], 2, 1)
