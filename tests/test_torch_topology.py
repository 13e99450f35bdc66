"""The port's fleet harness and open-loop workload held against the
reference's (utils/topology.py, utils/loadgen.py).

- `WorkloadSpec.schedule_lines()` is byte-identical to the reference's
  for the same spec and seed; the zipf sampler draws the same ranks;
  `percentile` agrees; `OpenLoopRunner` fires every event and reports
  the reference's shape; `authz_loadgen_lag_seconds` is exported.
- `WorkerFleet` (tests/test_topology.py:158-230): a window round trip,
  a member crashing mid-boot or answering garbage reaps the whole fleet,
  the context manager reaps on an exception.
- `single_thread_env` pins the host thread pools and sets nothing that
  hides the card; `pin_command` wraps as the reference's.
- `ProcessFleet` over the port's role servers on `embedded://`: a fake
  kube-apiserver, two shard leaders and the port's CLI router with
  `--fleet-peers` boot behind readiness gates; a routed request's trace
  assembles across the router and leader processes at the router's
  /debug/fleet; a leader killed with SIGKILL shows as an errored member;
  an orderly stop exits every member 0; a member dying during boot
  reaps the fleet with its log tail.

Every subprocess runs under a time limit.  Tolerance: exact equality.
"""

import asyncio
import json
import os
import random
import re
import subprocess
import sys

import pytest

from spicedb_kubeapi_proxy_tpu.utils import loadgen as ref_loadgen
from spicedb_kubeapi_proxy_tpu.utils import topology as ref_topology
from spicedb_kubeapi_proxy_tpu_torch.utils import loadgen, topology
from spicedb_kubeapi_proxy_tpu_torch.utils.topology import (
    FleetError,
    FleetSpec,
    ProcessFleet,
)

from test_fleet import PMAP_SPEC, RULES, SCHEMA

SPECS = [
    dict(seed=42, duration_s=5.0, rate_per_s=80.0, users=10_000,
         watch_churn_per_s=3.0, grant_burst_per_s=1.0),
    dict(seed=1, duration_s=2.0, rate_per_s=50.0, users=1000),
    dict(seed=20, duration_s=20.0, rate_per_s=50.0, users=50_000,
         verb_mix=(("filter", 0.2), ("check", 0.8))),
    dict(seed=9, duration_s=10.0, rate_per_s=5.0, users=100,
         grant_burst_per_s=1.0, grant_burst_n=3, grant_ttl_s=2.0),
    dict(seed=13, duration_s=1.0, rate_per_s=40.0, users=100,
         namespaces=7, zipf_s=1.05),
]


@pytest.mark.parametrize("kw", SPECS)
def test_schedule_lines_byte_identical_to_the_reference(kw):
    got = loadgen.WorkloadSpec(**kw).schedule_lines()
    assert got == ref_loadgen.WorkloadSpec(**kw).schedule_lines()
    assert got == loadgen.WorkloadSpec(**kw).schedule_lines()
    assert got


def test_zipf_and_percentile_as_the_reference():
    for n, s in ((1000, 1.2), (50, 1.1), (50_000, 1.2)):
        a, b = loadgen._ZipfSampler(n, s), ref_loadgen._ZipfSampler(n, s)
        ra, rb = random.Random(5), random.Random(5)
        assert [a.sample(ra) for _ in range(2000)] == [
            b.sample(rb) for _ in range(2000)]
        assert loadgen._ZipfSampler(n, s).cdf is a.cdf   # cached per shape
    vals = [random.Random(3).random() for _ in range(101)]
    for q in (0.0, 0.5, 0.99, 1.0):
        assert loadgen.percentile(vals, q) == ref_loadgen.percentile(vals, q)
    assert loadgen.percentile([], 0.99) == 0.0


def test_open_loop_runner_reports_as_the_reference():
    """Both runners fire a 0.5 s schedule at an instant `issue`: every
    event is offered and achieved, and the reports have the same keys
    and counts."""
    spec = dict(seed=3, duration_s=0.5, rate_per_s=60.0, users=100,
                verb_mix=(("filter", 0.5), ("check", 0.5)))

    def report(L):
        seen = []

        async def issue(ev):
            seen.append(ev["seq"])
            if ev["seq"] % 7 == 3:
                raise RuntimeError("refused")

        runner = L.OpenLoopRunner(issue, max_inflight=4)
        out = asyncio.run(asyncio.wait_for(
            runner.run(L.WorkloadSpec(**spec).schedule()), 30))
        return out, sorted(seen)

    got, seen = report(loadgen)
    want, ref_seen = report(ref_loadgen)
    assert seen == ref_seen
    assert got.keys() == want.keys()
    for k in ("open_loop", "offered", "achieved", "errors"):
        assert got[k] == want[k], k
    assert {v: (r["count"], r["errors"]) for v, r in got["per_verb"].items()} \
        == {v: (r["count"], r["errors"]) for v, r in want["per_verb"].items()}
    assert got["offered"] == len(seen) and got["errors"] >= 1


def test_loadgen_lag_gauge_exported():
    loadgen.LAG_GAUGE.set(0.25)
    text = loadgen.REGISTRY.render()
    assert "authz_loadgen_lag_seconds 0.25" in text


# -- WorkerFleet ------------------------------------------------------------------

_OK_WORKER = (
    "import sys\n"
    "print('READY', flush=True)\n"
    "for line in sys.stdin:\n"
    "    line = line.strip()\n"
    "    if line == 'EXIT':\n"
    "        break\n"
    "    if line.startswith('RUN'):\n"
    "        payload = line[4:] or '{}'\n"
    "        print('DONE ' + payload, flush=True)\n")


def _spawn_ok(fleet, label):
    fleet.spawn([sys.executable, "-u", "-c", _OK_WORKER], label=label,
                env=None)


@pytest.mark.parametrize("mod", [topology, ref_topology],
                         ids=["port", "reference"])
def test_worker_fleet_window_and_shutdown(mod):
    fleet = mod.WorkerFleet(name="t", taskset="")
    _spawn_ok(fleet, "a")
    _spawn_ok(fleet, "b")
    procs = [w.proc for w in fleet.workers]
    fleet.wait_ready(timeout_s=30)
    assert fleet.run_window(payloads=[{"i": 0}, {"i": 1}]) == [{"i": 0},
                                                               {"i": 1}]
    fleet.shutdown()
    assert all(p.poll() is not None for p in procs)


@pytest.mark.parametrize("case", ["crash", "garbage", "context"])
def test_worker_fleet_reaps_as_the_reference(case):
    def observe(mod):
        fleet = mod.WorkerFleet(name="t", taskset="")
        procs = []
        try:
            if case == "context":
                with pytest.raises(RuntimeError, match="boom"):
                    with mod.WorkerFleet(name="t", taskset="") as inner:
                        _spawn_ok(inner, "a")
                        procs = [w.proc for w in inner.workers]
                        raise RuntimeError("boom")
                msg = "context"
            else:
                if case == "crash":
                    _spawn_ok(fleet, "survivor")
                    fleet.spawn([sys.executable, "-c",
                                 "import sys; sys.exit(3)"],
                                label="crasher", env=None)
                else:
                    fleet.spawn([sys.executable, "-u", "-c",
                                 "print('BANANA', flush=True); import time; "
                                 "time.sleep(60)"], label="chatty", env=None)
                procs = [w.proc for w in fleet.workers]
                with pytest.raises(mod.FleetError) as err:
                    fleet.wait_ready(timeout_s=30)
                msg = str(err.value)
        finally:
            fleet.reap()
        for p in procs:
            p.wait(10)
        return msg, [p.poll() is not None for p in procs]

    got, want = observe(topology), observe(ref_topology)
    # the port waits for a dead member's exit code; the reference polls
    # right after EOF and reads None or 3 by timing: compare with the exit
    # part masked, and hold the port to the code itself
    mask = lambda msg: re.sub(r"\(exit [^)]*\)", "(exit ...)", msg)
    assert (mask(got[0]), got[1]) == (mask(want[0]), want[1])
    assert all(got[1])
    if case != "context":
        assert "reaped" in got[0]
    if case == "crash":
        assert "(exit 3)" in got[0]


def test_single_thread_env_pins_threads_and_keeps_the_card():
    env = topology.single_thread_env()
    assert env["OMP_NUM_THREADS"] == env["OPENBLAS_NUM_THREADS"] == "1"
    assert env["MKL_NUM_THREADS"] == "1"
    for key in ("JAX_PLATFORMS", "XLA_FLAGS", "CUDA_VISIBLE_DEVICES"):
        assert env.get(key) == os.environ.get(key), key
    assert topology.single_thread_env({"X": "y"})["X"] == "y"
    ref = ref_topology.single_thread_env()
    assert ref["JAX_PLATFORMS"] == "cpu"   # the reference's CPU pin


@pytest.mark.parametrize("args", [
    (["python", "-c", "pass"], 3, ""), (["python"], None, "/bin/taskset"),
    (["x"], 1, "/usr/bin/taskset"), (["x"], 7, "/usr/bin/taskset")])
def test_pin_command_as_the_reference(args):
    assert topology.pin_command(*args) == ref_topology.pin_command(*args)


def test_worker_protocol_one_line_each_way():
    p = subprocess.Popen([sys.executable, "-u", "-c", _OK_WORKER],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         text=True, bufsize=1)
    try:
        assert p.stdout.readline().strip() == "READY"
        p.stdin.write('RUN {"x": 1}\n')
        p.stdin.flush()
        assert json.loads(p.stdout.readline()[5:]) == {"x": 1}
        p.stdin.write("EXIT\n")
        p.stdin.flush()
        assert p.wait(10) == 0
    finally:
        if p.poll() is None:
            p.kill()


# -- ProcessFleet over the port's roles ----------------------------------------------


def test_process_fleet_router_over_two_leaders(tmp_path):
    """kube + two `embedded://` shard-leader roles + the port's CLI
    router (`--shard-leaders`, `--fleet-peers`), all separate processes:
    a traced namespace get through the router assembles across the
    router and leader 0 at /debug/fleet; leader 1 killed with SIGKILL is
    an errored member there; an orderly stop exits the rest 0."""
    spec = FleetSpec(schema_text=SCHEMA, rules_yaml=RULES, shard_leaders=2,
                     router=True, partition_map=PMAP_SPEC,
                     seed_rels=("namespace:team-a#creator@user:alice",
                                "podns:team-a#creator@user:alice"),
                     ready_timeout_s=120.0)
    fleet = ProcessFleet(spec, workdir=str(tmp_path))
    try:
        fleet.boot()
        base = fleet.router_url
        tid = "ab" * 16
        status, headers, _ = topology.http(
            "GET", base + "/api/v1/namespaces/team-a", user="alice",
            headers={"X-Trace-Id": tid})
        assert status == 200 and headers.get("X-Authz-Shard") == "0"
        status, _, body = topology.http("GET", base + "/debug/fleet",
                                        user="alice", timeout=30)
        merged = json.loads(body)
        assert status == 200 and merged["enabled"]
        members = {m["url"]: m["error"] for m in merged["members"]}
        assert set(members) == {"router"} | set(fleet.urls("leader"))
        assert not any(members.values())
        trace = {t["trace_id"]: t for t in merged["traces"]}[tid]
        assert sorted(trace["tiers"]) == ["leader", "router"]
        assert not trace["aligned_by_wall"]
        assert abs(trace["attributed_ms"] - trace["duration_ms"]) <= 0.05
        status, _, body = topology.http("GET", base + "/debug/tail",
                                        user="alice", timeout=30)
        assert status == 200 and json.loads(body)["tier"] == "router"
        fleet.kill("leader-1")
        status, _, body = topology.http("GET", base + "/debug/fleet",
                                        user="alice", timeout=30)
        members = {m["url"]: m["error"]
                   for m in json.loads(body)["members"]}
        dead = fleet.members["leader-1"].url
        assert status == 200 and members[dead]
        assert members[fleet.members["leader-0"].url] is None
        rcs = fleet.stop(timeout_s=30)
        assert rcs["leader-1"] == -9
        for name in ("leader-0", "router"):
            assert rcs[name] == 0, fleet.log_text(name)[-2000:]
            assert "Traceback" not in fleet.log_text(name)
    finally:
        fleet.teardown()


def test_process_fleet_reaps_a_member_dying_at_boot(tmp_path):
    spec = FleetSpec(schema_text="definition user {", rules_yaml=RULES,
                     shard_leaders=1, router=False, ready_timeout_s=60.0)
    fleet = ProcessFleet(spec, workdir=str(tmp_path))
    with pytest.raises(FleetError) as err:
        fleet.boot()
    msg = str(err.value)
    assert "leader-0" in msg and "died during boot" in msg
    assert "reaped" in msg
    assert fleet.members == {}
