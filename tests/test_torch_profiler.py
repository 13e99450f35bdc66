"""The port's sampling profiler (utils/profiler.py) held against the
reference's: tests/test_workload.py TestProfiler's cases on both
packages — the collapsed-stack and chrome-trace shapes of a capture, the
one-capture-at-a-time refusal, the switch, the clamp — and the proxy's
`/debug/profile?seconds=N` beside the reference proxy's.
"""

import asyncio
import json
import threading
import time
from types import SimpleNamespace

import pytest

from spicedb_kubeapi_proxy_tpu.utils import profiler as ref_profiler
from spicedb_kubeapi_proxy_tpu.utils.features import GATES
from spicedb_kubeapi_proxy_tpu_torch.utils import features, profiler


def _ref_gate(on):
    GATES.set("Profiler", on)


def _port_gate(on):
    features.PROFILER = on


REF = SimpleNamespace(p=ref_profiler, gate=_ref_gate)
PORT = SimpleNamespace(p=profiler, gate=_port_gate)
BOTH = [pytest.param(PORT, id="port"), pytest.param(REF, id="reference")]


@pytest.fixture(autouse=True)
def both_gates_on(monkeypatch):
    monkeypatch.setattr(GATES._gates["Profiler"], "value", True)
    monkeypatch.setattr(features, "PROFILER", True)


def _spin(stop):
    x = 0
    while not stop.is_set():
        for i in range(1000):
            x = (x * 31 + i) % 1000003
    return x


def capture_shape(ns):
    stop = threading.Event()
    t = threading.Thread(target=_spin, args=(stop,), name="spinner")
    t.start()
    try:
        out = ns.p.capture(0.2)
    finally:
        stop.set()
        t.join()
    assert out["samples"] > 0 and out["threads"] >= 1
    stack, count = out["collapsed"][0].rsplit(" ", 1)
    assert int(count) >= 1
    assert any("_spin" in line for line in out["collapsed"])
    evs = out["chrome_trace"]["traceEvents"]
    ev = evs[0]
    return (sorted(out), out["hz"], out["truncated_events"],
            sorted(out["chrome_trace"]), ev["ph"], ev["cat"],
            sorted(ev), sorted(ev["args"]), ev["dur"])


def test_capture_shape_matches_reference():
    assert capture_shape(PORT) == capture_shape(REF)


@pytest.mark.parametrize("ns", BOTH)
def test_second_concurrent_capture_rejected(ns):
    started = threading.Event()

    def long_capture():
        started.set()
        ns.p.capture(0.5)

    t = threading.Thread(target=long_capture)
    t.start()
    started.wait()
    time.sleep(0.05)
    try:
        with pytest.raises(ns.p.ProfilerBusy):
            ns.p.capture(0.1)
    finally:
        t.join()


@pytest.mark.parametrize("ns", BOTH)
def test_switch_off_raises(ns):
    ns.gate(False)
    try:
        with pytest.raises(ns.p.ProfilerDisabled):
            ns.p.capture(0.1)
    finally:
        ns.gate(True)


@pytest.mark.parametrize("ns", BOTH)
def test_duration_clamped_to_hard_cap(ns, monkeypatch):
    monkeypatch.setattr(ns.p, "HARD_CAP_S", 0.2)
    t0 = time.perf_counter()
    out = ns.p.capture(99.0)
    assert time.perf_counter() - t0 < 2.0
    assert out["seconds"] <= 0.5
    # the rate is clamped to [1, DEFAULT_HZ] and the window from below
    assert ns.p.capture(0.0, hz=1e6)["hz"] == ns.p.DEFAULT_HZ


def test_constants_match_reference():
    assert (profiler.HARD_CAP_S, profiler.DEFAULT_HZ,
            profiler.MAX_TRACE_EVENTS) == (ref_profiler.HARD_CAP_S,
                                           ref_profiler.DEFAULT_HZ,
                                           ref_profiler.MAX_TRACE_EVENTS)


# -- /debug/profile through both proxies -------------------------------------------

def _profile_surface(root, url, query):
    from test_torch_devtel import make_server
    server = make_server(root, url)

    async def go():
        out = []
        for user in ("alice", ""):
            client = server.get_embedded_client(user=user)
            resp = await client.get(f"/debug/profile{query}")
            body = json.loads(resp.body)
            out.append((resp.status, sorted(body) if resp.status == 200
                        else body.get("reason"), body.get("enabled")))
        return out

    return asyncio.run(go())


@pytest.mark.parametrize("query", ["?seconds=0.1", "?seconds=bogus", ""])
def test_profile_surface_matches_reference(query, monkeypatch):
    # a short window either way: the default is one second
    monkeypatch.setattr(profiler, "HARD_CAP_S", 0.1)
    monkeypatch.setattr(ref_profiler, "HARD_CAP_S", 0.1)
    got = _profile_surface("spicedb_kubeapi_proxy_tpu_torch",
                           "torch://?device=cpu", query)
    want = _profile_surface("spicedb_kubeapi_proxy_tpu", "jax://", query)
    assert got == want
    assert got[0][0] == 200 and got[0][2] is True and got[1][0] == 401


def test_profile_surface_reports_the_switch(monkeypatch):
    monkeypatch.setattr(features, "PROFILER", False)
    monkeypatch.setattr(GATES._gates["Profiler"], "value", False)
    got = _profile_surface("spicedb_kubeapi_proxy_tpu_torch", "embedded://",
                           "?seconds=0.1")
    want = _profile_surface("spicedb_kubeapi_proxy_tpu", "embedded://",
                            "?seconds=0.1")
    assert got == want and got[0][2] is False
