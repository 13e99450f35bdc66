"""The port's workload attribution (utils/workload.py) held against the
reference's.

The reference's tests/test_workload.py cases (its bench-diff script
apart, which the port does not carry): the same feeds into both
packages' `WorkloadAccounting` must give equal payloads, candidates and
histograms; the switch off records nothing.  Then the measured sweep
telemetry end to end: the same traffic through `torch://?device=cpu`
(ELL and segment kernels, direct and batched, pipeline depth 1 and 3)
and through `jax://` on the same graph must note the same sweep records
— iterations and frontier decay — the same per-pair rows (kernel rows,
oracle rows, measured depth, occupancy) and the same Leopard
candidates; and the endpoint's device windows reconcile with the
kernel-time histogram.
"""

import asyncio
from types import SimpleNamespace

import numpy as np
import pytest

from spicedb_kubeapi_proxy_tpu.ops.jax_endpoint import JaxEndpoint
from spicedb_kubeapi_proxy_tpu.spicedb import schema as ref_sch
from spicedb_kubeapi_proxy_tpu.spicedb import types as ref_types
from spicedb_kubeapi_proxy_tpu.spicedb.dispatch import (
    BatchingEndpoint as RefBatching)
from spicedb_kubeapi_proxy_tpu.utils import devtel as ref_devtel
from spicedb_kubeapi_proxy_tpu.utils import metrics as ref_m
from spicedb_kubeapi_proxy_tpu.utils import workload as ref_workload
from spicedb_kubeapi_proxy_tpu.utils.features import GATES
from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import TorchEndpoint
from spicedb_kubeapi_proxy_tpu_torch.spicedb import schema as sch
from spicedb_kubeapi_proxy_tpu_torch.spicedb import types
from spicedb_kubeapi_proxy_tpu_torch.spicedb.dispatch import BatchingEndpoint
from spicedb_kubeapi_proxy_tpu_torch.utils import devtel
from spicedb_kubeapi_proxy_tpu_torch.utils import features
from spicedb_kubeapi_proxy_tpu_torch.utils import metrics as m
from spicedb_kubeapi_proxy_tpu_torch.utils import workload

NESTED_SCHEMA = """
definition user {}
definition group {
    relation member: user | group#member
}
definition doc {
    relation viewer: user | group#member
    permission view = viewer
}
"""

FLAT_SCHEMA = """
definition user {}
definition doc {
    relation viewer: user
    permission view = viewer
}
"""


def _ref_gate(on):
    GATES.set("KernelIntrospect", on)


def _port_gate(on):
    features.KERNEL_INTROSPECT = on


REF = SimpleNamespace(wl=ref_workload, m=ref_m, sch=ref_sch, types=ref_types,
                      devtel=ref_devtel, gate=_ref_gate)
PORT = SimpleNamespace(wl=workload, m=m, sch=sch, types=types,
                       devtel=devtel, gate=_port_gate)


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def reference_like_the_port(monkeypatch):
    monkeypatch.setattr(GATES._gates["KernelIntrospect"], "value", True)
    monkeypatch.setattr(GATES._gates["AsyncRebuild"], "value", False)
    monkeypatch.setattr(GATES._gates["LeopardIndex"], "value", False)
    monkeypatch.setattr(features, "KERNEL_INTROSPECT", True)
    monkeypatch.setattr(features, "ASYNC_REBUILD", False)


def chain_rels(depth):
    """doc:d0 viewable by user:deep only through `depth` nested groups
    (plus user:flat directly): the fixpoint needs about depth sweeps."""
    rels = ["doc:d0#viewer@group:g0#member", "doc:d0#viewer@user:flat"]
    for i in range(depth - 1):
        rels.append(f"group:g{i}#member@group:g{i + 1}#member")
    rels.append(f"group:g{depth - 1}#member@user:deep")
    return rels


# -- feeds into WorkloadAccounting ---------------------------------------------

def split_by_rows(ns):
    wa = ns.wl.WorkloadAccounting(registry=ns.m.Registry())
    wa.note_device_time([("doc", "view", 3), ("doc", "edit", 1)],
                        "kernel.device", 0.04)
    wa.note_device_time(None, "kernel.device", 0.02)
    wa.note_device_time([("doc", "view", 1)], "h2d.slices", 0.5)
    wa.note_device_time([("doc", "view", 0)], "kernel.dispatch", 0.01)
    return [wa.payload()]


def routing_and_cache(ns):
    wa = ns.wl.WorkloadAccounting(registry=ns.m.Registry())
    wa.note_batch([("doc", "view", 6)], "check", iterations=4,
                  occupancy=0.75)
    wa.note_oracle([("doc", "view", 2)])
    wa.note_cache("doc", "view", 3, 1)
    wa.note_depth([("doc", "view", 2), ("pod", "view", 0)], 7)
    wa.note_batch([("pod", "view", 0), ("pod", "edit", 5)], "lookup")
    wa.note_leopard_status({"doc#view": "indexed"})
    out = [wa.payload()]
    wa.reset()
    return out + [wa.payload()]


def sweeps(ns):
    reg = ns.m.Registry()
    wa = ns.wl.WorkloadAccounting(registry=reg)
    recs = [wa.note_sweep("ell", "check", np.asarray(t, np.int32))
            for t in ([3, 100, 40, 0, 9], [1, 5], [0], [2, 0, 7],
                      [5, 8, 8, 4, 2, 1, 0])]
    recs.append(wa.note_sweep("segment", "lookup", None))
    recs.append(wa.note_sweep("ell", "lookup", [-1, 2]))
    recs.append(wa.note_sweep("ell", "lookup", "bogus"))
    last = wa.take_last_sweep()
    return [[(r.kernel, r.verb, r.iterations, r.deltas) if r else None
             for r in recs],
            (last.iterations, last.deltas) if last else None,
            wa.take_last_sweep(),
            sorted(reg.get("authz_sweep_iterations").raw().items()),
            sorted(reg.get("authz_frontier_decay").raw().items())]


def gate_off(ns):
    reg = ns.m.Registry()
    wa = ns.wl.WorkloadAccounting(registry=reg)
    ns.gate(False)
    try:
        out = [wa.note_sweep("ell", "check", np.asarray([2, 3, 1]))]
        wa.note_batch([("doc", "view", 4)], "check", iterations=3)
        wa.note_depth([("doc", "view", 4)], 3)
        wa.note_device_time([("doc", "view", 4)], "kernel.device", 0.01)
        wa.note_oracle([("doc", "view", 1)])
        wa.note_cache("doc", "view", 2, 1)
        out.append(wa.payload())
    finally:
        ns.gate(True)
    text = reg.render()
    return out + ["authz_sweep_iterations_bucket" in text,
                  "authz_frontier_decay_bucket" in text]


def leopard_detector(ns):
    out = []
    for text, depth in ((NESTED_SCHEMA, 8), (FLAT_SCHEMA, 50),
                        (NESTED_SCHEMA, ns.wl.LEOPARD_DEPTH - 1),
                        (NESTED_SCHEMA, ns.wl.LEOPARD_DEPTH)):
        wa = ns.wl.WorkloadAccounting(registry=ns.m.Registry())
        wa.note_schema(ns.sch.parse_schema(text))
        wa.note_batch([("doc", "view", 4)], "check", iterations=depth,
                      occupancy=0.5)
        wa.note_batch([("group", "member", 2)], "lookup", iterations=depth)
        out.append((wa.leopard_candidates(), wa.payload()))
    # no schema: nothing is nested
    wa = ns.wl.WorkloadAccounting(registry=ns.m.Registry())
    wa.note_batch([("doc", "view", 4)], "check", iterations=9)
    return out + [wa.leopard_candidates()]


def comp_rows(ns):
    T = ns.types
    reqs = [T.CheckRequest(T.ObjectRef(t, f"o{i}"), p,
                           T.SubjectRef("user", "u"))
            for i, (t, p) in enumerate([("doc", "view"), ("doc", "edit"),
                                        ("doc", "view"), ("pod", "view")])]
    return [ns.wl.comp_rows(reqs), ns.wl.comp_rows([])]


def devtel_hook(ns):
    wa = ns.wl.WORKLOAD
    before = wa.payload()["total_device_s"]
    ns.devtel.note_kernel_span(
        "kernel.device", {"workload": [("zz_hook", "view", 2)]}, 0.015)
    row = [r for r in wa.payload()["rows"]
           if r["resource_type"] == "zz_hook"][0]
    return [round(wa.payload()["total_device_s"] - before, 9),
            row["device_s"], row["device_calls"]]


FEEDS = [split_by_rows, routing_and_cache, sweeps, gate_off,
         leopard_detector, comp_rows, devtel_hook]


@pytest.mark.parametrize("feed", FEEDS, ids=[f.__name__ for f in FEEDS])
def test_feed_matches_reference(feed):
    assert feed(PORT) == feed(REF)


def test_reference_assertions_hold_on_the_port():
    p = split_by_rows(PORT)[0]
    rows = {(r["resource_type"], r["permission"]): r for r in p["rows"]}
    assert rows[("doc", "view")]["device_s"] == pytest.approx(0.03)
    assert rows[("doc", "edit")]["device_s"] == pytest.approx(0.01)
    assert p["total_device_s"] == pytest.approx(0.07)
    row = routing_and_cache(PORT)[0]["rows"]
    row = {(r["resource_type"], r["permission"]): r for r in row}
    r = row[("doc", "view")]
    assert r["oracle_fraction"] == pytest.approx(2 / 8)
    assert r["cache_hit_rate"] == pytest.approx(0.75)
    assert r["leopard"] == "indexed"
    g = gate_off(PORT)
    assert g[0] is None and g[1]["rows"] == [] and g[2:] == [False, False]
    det = leopard_detector(PORT)
    assert [c["resource_type"] for c in det[0][0]] == ["doc", "group"]
    assert det[1][0] == [] and det[2][0] == [] and det[3][0] != []
    assert devtel_hook(PORT)[0] == pytest.approx(0.015)


# -- measured sweeps end to end -------------------------------------------------------

def make_pair(depth=7, kernel="ell", schema_text=NESTED_SCHEMA, rels=None):
    rels = chain_rels(depth) if rels is None else rels
    port = TorchEndpoint(sch.parse_schema(schema_text), device="cpu",
                         kernel=kernel, leopard=False)
    ref = JaxEndpoint(ref_sch.parse_schema(schema_text), kernel=kernel)
    for ep, T in ((port, types), (ref, ref_types)):
        ep.store.write([T.RelationshipUpdate(T.UpdateOp.TOUCH,
                                             T.parse_relationship(r))
                        for r in rels])
    return port, ref


def check_reqs(T, n=8):
    subs = [T.SubjectRef("user", "deep"), T.SubjectRef("user", "flat")]
    subs += [T.SubjectRef("user", f"u{i}") for i in range(n - 2)]
    return [T.CheckRequest(T.ObjectRef("doc", "d0"), "view", s)
            for s in subs]


def lookup_subjects(T):
    return [T.SubjectRef("user", u) for u in ("deep", "flat", "nobody")]


def _rows(ns):
    """Payload rows without the wall-clock fields."""
    return sorted(tuple((k, v) for k, v in sorted(r.items())
                        if k not in ("device_s", "device_calls"))
                  for r in ns.wl.WORKLOAD.payload()["rows"])


def _hists(ns):
    return (sorted(ns.wl.WORKLOAD._sweep_iters.raw().items()),
            sorted(ns.wl.WORKLOAD._decay.raw().items()))


def _delta(after, before):
    """Per-key (bucket counts, sum, count) deltas of the keys observed in
    between."""
    out = []
    for ka, (ca, sa, ta) in after:
        b = dict(before).get(ka, ([0] * len(ca), 0.0, 0))
        if ta - b[2]:
            out.append((ka, [x - y for x, y in zip(ca, b[0])],
                        round(sa - b[1], 6), ta - b[2]))
    return out


def drive_both(traffic, **pair_kw):
    """Run `traffic(ep, T)` on both endpoints of a fresh pair, each with a
    reset workload plane; returns both (rows, sweep-histogram deltas,
    Leopard candidates, traffic results)."""
    port, ref = make_pair(**pair_kw)
    out = []
    for ns, ep in ((PORT, port), (REF, ref)):
        ns.wl.WORKLOAD.reset()
        ns.wl.WORKLOAD.note_schema(ep.schema)
        before = _hists(ns)
        res = traffic(ep, ns.types)
        after = _hists(ns)
        out.append((_rows(ns), _delta(after[0], before[0]),
                    _delta(after[1], before[1]),
                    ns.wl.WORKLOAD.leopard_candidates(), res))
    return out


def _tri(results):
    return [r.permissionship.name for r in results]


@pytest.mark.parametrize("kernel", ["ell", "segment"])
@pytest.mark.parametrize("depth", [1, 3, 7])
def test_sweep_records_match_reference(kernel, depth):
    def traffic(ep, T):
        res = run(ep.check_bulk_permissions(check_reqs(T)))
        look = run(ep.lookup_resources_batch("doc", "view",
                                             lookup_subjects(T)))
        look += [run(ep.lookup_resources("group", "member",
                                         T.SubjectRef("user", "deep")))]
        return _tri(res), [sorted(x) for x in look]

    port, ref = drive_both(traffic, depth=depth, kernel=kernel)
    if kernel == "segment":
        # the port's segment sweep packs 32 lanes a word, so its batches
        # pad to 32 lanes where the reference's float lanes pad to 8:
        # the same sweeps, another occupancy
        for side in (port, ref):
            side[0][:] = [tuple(kv for kv in row
                                if kv[0] != "mean_occupancy")
                          for row in side[0]]
    assert port == ref
    # the sweeps were measured: one record per verb, a decay per step
    iters = port[1]
    assert {k for k, *_ in iters} >= {(kernel, "check"), (kernel, "lookup")}


def test_nested_chain_sweeps_deeper_than_flat():
    def traffic(ep, T):
        user = "deep" if "group" in ep.schema.definitions else "flat"
        run(ep.lookup_resources("doc", "view", T.SubjectRef("user", user)))
        return None

    deep = drive_both(traffic, depth=7)[0][0]
    flat = drive_both(traffic, schema_text=FLAT_SCHEMA,
                      rels=["doc:d0#viewer@user:flat"])[0][0]
    depth = lambda rows: dict(rows[0])["mean_sweep_depth"]  # noqa: E731
    assert depth(deep) > depth(flat)


def test_deep_pair_becomes_a_leopard_candidate_on_both():
    def traffic(ep, T):
        for _ in range(3):
            run(ep.check_bulk_permissions(check_reqs(T)))
        return None

    port, ref = drive_both(traffic, depth=7)
    assert port[3] == ref[3]
    assert [(c["resource_type"], c["permission"]) for c in port[3]] == [
        ("doc", "view")]


@pytest.mark.parametrize("depth_a,depth_b", [(1, 3)])
def test_pipeline_depth_does_not_change_the_histogram(depth_a, depth_b):
    def observe(pipeline_depth):
        port, ref = make_pair()
        out = []
        for ns, ep, wrap in ((PORT, port, BatchingEndpoint),
                             (REF, ref, RefBatching)):
            b = wrap(ep, max_batch=4, pipeline_depth=pipeline_depth)
            reqs = check_reqs(ns.types)

            async def go():
                return await asyncio.gather(
                    *[b.check_permission(r) for r in reqs])

            run(go())
            before = _hists(ns)
            res = run(go())
            out.append((_delta(_hists(ns)[0], before[0]), _tri(res)))
        assert out[0] == out[1]
        return out[0]

    assert observe(depth_a) == observe(depth_b)


def test_serial_and_batched_observe_the_same_histogram():
    def observe(batched):
        port, _ = make_pair()
        ep = BatchingEndpoint(port) if batched else port
        run(ep.check_bulk_permissions(check_reqs(types)))
        before = _hists(PORT)
        run(ep.check_bulk_permissions(check_reqs(types)))
        return _delta(_hists(PORT)[0], before[0])

    assert observe(False) == observe(True)


def test_switch_off_records_no_sweep_but_the_kernel_runs(monkeypatch):
    port, _ = make_pair()
    monkeypatch.setattr(features, "KERNEL_INTROSPECT", False)
    before = _hists(PORT)
    res = run(port.check_bulk_permissions(check_reqs(types)))
    assert _hists(PORT) == before
    assert port.stats["kernel_calls"] >= 1
    assert res[0].permissionship == types.Permissionship.HAS_PERMISSION


def test_device_windows_reconcile_with_the_kernel_histogram():
    """The per-pair device time and authz_kernel_time_seconds{phase=
    kernel.device} are fed the same window seconds, batch by batch."""
    port, _ = make_pair()
    h = m.REGISTRY.get("authz_kernel_time_seconds")

    def device_sum():
        return sum(v[1] for k, v in h.raw().items()
                   if k[0] == "kernel.device")

    workload.WORKLOAD.reset()
    s0 = device_sum()
    run(port.check_bulk_permissions(check_reqs(types)))
    run(port.lookup_resources_batch("doc", "view", lookup_subjects(types)))
    p = workload.WORKLOAD.payload()
    assert device_sum() - s0 == pytest.approx(p["total_device_s"],
                                              rel=1e-6, abs=1e-6)
    assert p["attribution_ratio"] == 1.0
    assert p["total_device_s"] > 0
