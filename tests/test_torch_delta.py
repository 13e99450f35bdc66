"""The torch port's write path held against the JAX reference.

`torch://?device=cpu` and `jax://` load the same tuples and take the same
writes, deletes and expirations; after every burst both answer the same
lookups and checks as the host oracle, both rebuilt the same number of
times, and the port's host tables (`host_main`, `host_aux`, the spare aux
pool) equal the reference `_EllGraph`'s bit for bit.  The scenarios mirror
the reference's own delta tests (tests/test_jax_backend.py), then the
parity scenarios of tests/test_torch_ell.py under seeded churn, whose
sweeps must also leave the same state, checks, lookup words and trace at
33 and 256 lanes.  Copy-on-write is checked on the tensors and on the
published id views, and the `scatter_rows` twin against numpy.

Both packages run with their off-loop rebuilds off (the reference's
AsyncRebuild gate, the port's ASYNC_REBUILD switch): a delta they cannot
absorb then rebuilds synchronously inside the read, so rebuild counts
compare after every read.  The scenarios that rebuild (spare exhaustion,
a store reset, force_rebuild, one churn seed) run again as `_async_rebuild`
cases with both on, the defaults: their tables and counters compare after
both endpoints' `wait_rebuilds()`.  Tolerance is zero everywhere: the data
are ids, integers and bitplanes.
"""

import asyncio
import random

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from spicedb_kubeapi_proxy_tpu.models import workloads as ref_workloads
from spicedb_kubeapi_proxy_tpu.ops import jax_endpoint as ref_je
from spicedb_kubeapi_proxy_tpu.ops.jax_endpoint import JaxEndpoint
from spicedb_kubeapi_proxy_tpu.spicedb import schema as ref_sch
from spicedb_kubeapi_proxy_tpu.spicedb.evaluator import Evaluator
from spicedb_kubeapi_proxy_tpu.spicedb.store import TupleStore as RefStore
from spicedb_kubeapi_proxy_tpu.spicedb.types import (
    CheckRequest as RefCheckRequest,
    ObjectRef as RefObjectRef,
    Permissionship as RefPermissionship,
    RelationshipUpdate as RefUpdate,
    SubjectRef as RefSubjectRef,
    UpdateOp as RefOp,
    parse_relationship as ref_parse)
from spicedb_kubeapi_proxy_tpu.utils.features import GATES
from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
from spicedb_kubeapi_proxy_tpu_torch.ops import torch_endpoint as port_te
from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference as twins
from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import TorchEndpoint
from spicedb_kubeapi_proxy_tpu_torch.spicedb import schema as port_sch
from spicedb_kubeapi_proxy_tpu_torch.spicedb.store import TupleStore
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
    CheckRequest,
    ObjectRef,
    RelationshipUpdate,
    SubjectRef,
    UpdateOp,
    parse_relationship)
from spicedb_kubeapi_proxy_tpu_torch.utils import features as port_features

GROUPS_SCHEMA = """
definition user {}
definition group {
  relation member: user | group#member
}
definition team {
  relation member: user | group#member
}
definition namespace {
  relation viewer: user | group#member | team#member
  relation creator: user
  permission view = viewer + creator
}
"""

WILDCARD_SCHEMA = """
definition user {}
definition bot {}
definition doc {
  relation viewer: user | user:* | bot
  relation editor: user
  permission view = viewer + editor
}
"""


@pytest.fixture(autouse=True)
def sync_reference_rebuilds(monkeypatch):
    """Both packages rebuild synchronously: the reference's AsyncRebuild
    gate and the port's ASYNC_REBUILD switch are off."""
    monkeypatch.setattr(GATES._gates["AsyncRebuild"], "value", False)
    monkeypatch.setattr(port_features, "ASYNC_REBUILD", False)


def async_rebuilds(monkeypatch):
    """Both packages on their default off-loop rebuild path."""
    monkeypatch.setattr(GATES._gates["AsyncRebuild"], "value", True)
    monkeypatch.setattr(port_features, "ASYNC_REBUILD", True)


def run(coro):
    return asyncio.run(coro)


class Pair:
    """The port and the reference on equal stores, plus the oracle."""

    def __init__(self, schema_text, rels, clock=None):
        self.port = TorchEndpoint(port_sch.parse_schema(schema_text),
                                  store=TupleStore(clock=clock)
                                  if clock else None, device="cpu")
        self.jx = JaxEndpoint(ref_sch.parse_schema(schema_text),
                              store=RefStore(clock=clock) if clock else None)
        self.oracle = Evaluator(self.jx.schema, self.jx.store)
        if rels:
            self.write([("touch", r) for r in rels])

    @classmethod
    def bootstrap(cls, schema_text, rels):
        """Both endpoints bulk-loaded from the same bootstrap text."""
        from spicedb_kubeapi_proxy_tpu.spicedb.endpoints import (
            Bootstrap as RefBootstrap)
        from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
            Bootstrap, create_endpoint)
        self = cls.__new__(cls)
        text = "\n".join(rels)
        self.port = create_endpoint("torch://?device=cpu",
                                    Bootstrap(schema_text, text))
        self.jx = JaxEndpoint.from_bootstrap(RefBootstrap(schema_text, text))
        self.oracle = Evaluator(self.jx.schema, self.jx.store)
        return self

    def write(self, ops):
        """One committed write of (op, relationship string) pairs in each
        store."""
        port_ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
        ref_ops = {"touch": RefOp.TOUCH, "delete": RefOp.DELETE}
        self.port.store.write([RelationshipUpdate(port_ops[o],
                                                  parse_relationship(r))
                               for o, r in ops])
        self.jx.store.write([RefUpdate(ref_ops[o], ref_parse(r))
                             for o, r in ops])

    def agree(self, rtype, perm, names, objects=None, stype="user"):
        """Lookups and checks equal across port, reference and oracle;
        then the rebuild counts and the host tables are equal."""
        subjects = [SubjectRef(stype, n) for n in names]
        refs = [RefSubjectRef(stype, n) for n in names]
        got = run(self.port.lookup_resources_batch(rtype, perm, subjects))
        ref = run(self.jx.lookup_resources_batch(rtype, perm, refs))
        for s, g, r in zip(refs, got, ref):
            want = sorted(self.oracle.lookup_resources(rtype, perm, s))
            assert sorted(g) == sorted(r) == want, s
        if objects is None:
            objects = sorted(self.jx.store.object_ids_of_type(rtype))
        objects = list(objects) + ["never-created"]
        reqs = [(o, i) for o in objects for i in range(len(names))]
        got = run(self.port.check_bulk_permissions(
            [CheckRequest(ObjectRef(rtype, o), perm, subjects[i])
             for o, i in reqs]))
        ref = run(self.jx.check_bulk_permissions(
            [RefCheckRequest(RefObjectRef(rtype, o), perm, refs[i])
             for o, i in reqs]))
        for (o, i), g, r in zip(reqs, got, ref):
            want = self.oracle.check(RefObjectRef(rtype, o), perm, refs[i])
            assert g.allowed == (r.permissionship
                                 == RefPermissionship.HAS_PERMISSION) \
                == want, (o, names[i])
        if port_features.ASYNC_REBUILD:
            # off-loop rebuilds land in the background: compare the
            # generations once both endpoints are quiescent
            assert self.port.wait_rebuilds() and self.jx.wait_rebuilds()
        self.assert_same_tables()

    def assert_same_tables(self):
        p, r = self.port._graph, self.jx._graph
        assert self.port.stats["rebuilds"] == self.jx.stats["rebuilds"]
        assert self.port._graph_revision == self.jx._graph_revision
        assert np.array_equal(p.host_main, r.host_main)
        assert np.array_equal(p.host_aux, r.host_aux)
        assert p._spare_aux == r._spare_aux
        assert p.prog.object_ids == r.prog.object_ids
        assert self.port._spare_pool == self.jx._spare_pool
        # the device copies carry the host tables after the flush
        assert np.array_equal(p.dev_main.numpy(), p.host_main)
        assert np.array_equal(p.dev_aux.numpy(), p.host_aux)
        for k in ("spare_assignments", "spare_reclaims", "delta_batches",
                  "stale_pair_marks", "bg_rebuilds", "preemptive_rebuilds"):
            assert self.port.stats[k] == self.jx.stats[k], k
        assert (self.port.stats["stage_aux_flips"]
                == self.jx.stats.get("stage_aux_flips", 0))


def users(n, prefix="u"):
    return [f"{prefix}{i}" for i in range(n)]


# -- the reference's delta scenarios (tests/test_jax_backend.py) ------------

def test_write_then_delete():
    p = Pair(GROUPS_SCHEMA, ["namespace:ns1#viewer@user:alice"])
    p.agree("namespace", "view", ["alice", "bob"])
    p.write([("delete", "namespace:ns1#viewer@user:alice")])
    p.agree("namespace", "view", ["alice"])
    p.write([("touch", "namespace:ns1#viewer@user:alice")])
    p.agree("namespace", "view", ["alice"])
    assert p.port.stats["rebuilds"] == 1
    assert p.port.stats["delta_batches"] == 2


def test_full_row_insert_grows_aux_without_rebuild():
    rels = ["namespace:ns#viewer@user:u0"]
    rels += [f"namespace:seed#viewer@user:u{i}" for i in range(1, 40)]
    p = Pair(GROUPS_SCHEMA, rels)
    p.agree("namespace", "view", users(12))
    for i in range(1, 12):
        p.write([("touch", f"namespace:ns#viewer@user:u{i}")])
    p.agree("namespace", "view", users(12))
    assert p.port.stats["rebuilds"] == 1
    assert p.port._graph._grow_extra
    p.write([("delete", "namespace:ns#viewer@user:u3")])
    p.agree("namespace", "view", users(12))


def test_new_object_id_assigns_spare_without_rebuild():
    p = Pair(GROUPS_SCHEMA, ["namespace:ns1#viewer@user:alice"])
    p.agree("namespace", "view", ["alice"])
    p.write([("touch", "namespace:brand-new#viewer@user:newbie")])
    p.agree("namespace", "view", ["alice", "newbie"])
    assert p.port.stats["rebuilds"] == 1
    assert p.port.stats["spare_assignments"] == 2   # object + subject
    assert run(p.port.lookup_resources(
        "namespace", "view", SubjectRef("user", "newbie"))) == ["brand-new"]


def test_spare_pool_exhaustion_rebuilds_and_resizes(monkeypatch):
    _spare_pool_exhaustion(monkeypatch)


def test_spare_pool_exhaustion_rebuilds_and_resizes_async_rebuild(
        monkeypatch):
    """Off-loop: the 6 ids past the pool quarantine namespace#view, the
    reads answer it from the oracle, and the background candidate sized
    for 71 namespaces is the reference's."""
    async_rebuilds(monkeypatch)
    p = _spare_pool_exhaustion(monkeypatch)
    assert p.port.stats["bg_rebuilds"] == p.jx.stats["bg_rebuilds"] >= 1
    assert p.port.stats["stale_routed"] > 0
    assert not p.port._stale_pairs


def _spare_pool_exhaustion(monkeypatch):
    monkeypatch.setattr(ref_je, "_SPARE_DIVISOR", 1)
    monkeypatch.setattr(port_te, "_SPARE_DIVISOR", 1)
    p = Pair(GROUPS_SCHEMA, ["namespace:ns1#viewer@user:alice"])
    p.agree("namespace", "view", ["alice"])
    floor_pool = len(p.port._spare_pool["namespace"])
    for k in range(70):  # more than the 64-row floor pool
        p.write([("touch", f"namespace:n{k}#viewer@user:alice")])
    p.agree("namespace", "view", ["alice"])
    assert p.port.stats["rebuilds"] >= 2
    assert len(p.port._spare_pool["namespace"]) > floor_pool
    got = sorted(run(p.port.lookup_resources(
        "namespace", "view", SubjectRef("user", "alice"))))
    assert got == sorted(["ns1"] + [f"n{k}" for k in range(70)])
    return p


def test_unique_name_churn_reclaims_spares():
    p = Pair(GROUPS_SCHEMA, ["namespace:ns1#viewer@user:alice"])
    p.agree("namespace", "view", ["alice"])
    for k in range(200):
        p.write([("touch", f"namespace:job-{k}#viewer@user:alice")])
        if k % 50 == 0:
            p.agree("namespace", "view", ["alice"])
        p.write([("delete", f"namespace:job-{k}#viewer@user:alice")])
    p.agree("namespace", "view", ["alice"])
    assert p.port.stats["rebuilds"] == 1
    assert p.port.stats["spare_reclaims"] >= 190
    assert run(p.port.lookup_resources(
        "namespace", "view", SubjectRef("user", "alice"))) == ["ns1"]


def test_unmodeled_relation_burns_no_spares():
    p = Pair(GROUPS_SCHEMA, ["namespace:ns1#viewer@user:alice"])
    p.agree("namespace", "view", ["alice"])
    for k in range(10):
        p.write([("touch", f"namespace:brand-{k}#unmodeled@user:nobody")])
    p.agree("namespace", "view", ["alice"])
    assert p.port.stats["spare_assignments"] == 0
    assert p.port.stats["rebuilds"] == 1


def _clock():
    clk = [1_700_000_000.0]
    return clk, (lambda: clk[0])


def test_expiration_respected():
    clk, now = _clock()
    p = Pair(GROUPS_SCHEMA, ["namespace:ns#viewer@user:alice"], clock=now)
    p.write([("touch", "namespace:ns#viewer@user:bob"
              f"[expiration:{clk[0] + 100}]")])
    p.agree("namespace", "view", ["alice", "bob"])
    assert len(p.port._expiry_heap) == 1
    clk[0] += 200
    p.agree("namespace", "view", ["alice", "bob"])
    assert not p.port._expiry_meta
    assert p.port.stats["rebuilds"] == 1


def test_touch_adds_expiry_to_existing_tuple():
    clk, now = _clock()
    p = Pair(GROUPS_SCHEMA, ["namespace:ns#viewer@user:alice"], clock=now)
    p.agree("namespace", "view", ["alice"])
    p.write([("touch", "namespace:ns#viewer@user:alice"
              f"[expiration:{clk[0] + 100}]")])
    clk[0] += 200
    p.agree("namespace", "view", ["alice"])


def test_delete_then_readd_clears_stale_expiry():
    clk, now = _clock()
    p = Pair(GROUPS_SCHEMA, ["namespace:ns0#viewer@user:z"], clock=now)
    p.write([("touch", "namespace:ns#viewer@user:alice"
              f"[expiration:{clk[0] + 100}]")])
    p.agree("namespace", "view", ["alice"])
    p.write([("delete", "namespace:ns#viewer@user:alice")])
    p.write([("touch", "namespace:ns#viewer@user:alice")])   # no expiry
    clk[0] += 200   # the stale heap entry fires and must be skipped
    p.agree("namespace", "view", ["alice"])
    assert run(p.port.lookup_resources(
        "namespace", "view", SubjectRef("user", "alice"))) == ["ns"]


def test_delta_insert_and_remove_in_hub():
    rels = [f"group:eng#member@user:u{i}" for i in range(300)]
    rels += ["namespace:ns#viewer@group:eng#member"]
    p = Pair(GROUPS_SCHEMA, rels)
    p.agree("namespace", "view", ["u5"])
    p.write([("touch", "group:eng#member@user:newcomer")])
    p.agree("namespace", "view", ["newcomer", "u5"])
    p.write([("delete", "group:eng#member@user:u123")])
    p.agree("namespace", "view", ["u123", "u5", "newcomer"])
    assert p.port.stats["rebuilds"] == 1


def test_delta_growth_flips_aux_free_stage_annotation():
    rels = [f"group:hub#member@user:h{i}" for i in range(40)]
    rels += ["namespace:ns#viewer@user:u0"]
    rels += [f"namespace:seed{i}#viewer@user:u{i}" for i in range(1, 12)]
    p = Pair(GROUPS_SCHEMA, rels)
    p.agree("namespace", "view", users(12))
    graph = p.port._graph
    kc = graph.kernel
    row = graph.prog.state_index("namespace", "viewer", "ns")
    i = next(i for i, (ranges, _, _) in enumerate(kc.stages)
             if any(lo <= row < hi for lo, hi in ranges))
    assert not kc.stages[i][2], "the namespace stage must start aux-free"
    old_plan = kc._plan
    for j in range(1, 12):
        p.write([("touch", f"namespace:ns#viewer@user:u{j}")])
    p.agree("namespace", "view", users(12))
    assert p.port.stats["rebuilds"] == 1
    assert p.port.stats["stage_aux_flips"] >= 1
    assert kc.stages[i][2] and kc._plan[i][1]
    assert kc.stages == p.jx._graph.kernel.stages
    # the flip built a new plan: a batch holding the old one is untouched
    assert kc._plan is not old_plan and not old_plan[i][1]


@pytest.mark.parametrize("seed", range(4))
def test_random_delta_churn(seed):
    p = _random_delta_churn(seed)
    assert p.port.stats["rebuilds"] == 1


def test_random_delta_churn_async_rebuild(monkeypatch):
    """Seed 0 off-loop: nothing to rebuild, so nothing moves to the
    background either."""
    async_rebuilds(monkeypatch)
    p = _random_delta_churn(0)
    assert p.port.stats["rebuilds"] == p.jx.stats["rebuilds"]
    assert p.port.stats["bg_rebuilds"] == p.jx.stats["bg_rebuilds"]


def _random_delta_churn(seed):
    rng = random.Random(7000 + seed)
    n_users, n_groups, n_ns = 8, 4, 6
    rels = [f"group:g{g}#member@user:u{u}"
            for g in range(n_groups) for u in range(n_users)]
    rels += [f"namespace:ns{i}#viewer@user:u0" for i in range(n_ns)]
    rels += [f"namespace:ns{i}#viewer@group:g0#member" for i in range(n_ns)]
    p = Pair(GROUPS_SCHEMA, rels)
    p.agree("namespace", "view", users(n_users))

    def any_rel():
        kind = rng.random()
        if kind < 0.4:
            return (f"group:g{rng.randrange(n_groups)}#member"
                    f"@user:u{rng.randrange(n_users)}")
        if kind < 0.6:
            a, b = rng.sample(range(n_groups), 2)
            return f"group:g{a}#member@group:g{b}#member"
        if kind < 0.85:
            return (f"namespace:ns{rng.randrange(n_ns)}#viewer"
                    f"@user:u{rng.randrange(n_users)}")
        return (f"namespace:ns{rng.randrange(n_ns)}#viewer"
                f"@group:g{rng.randrange(n_groups)}#member")

    for _ in range(5):
        p.write([("delete" if rng.random() < 0.4 else "touch", any_rel())
                 for _ in range(rng.randint(3, 10))])
        p.agree("namespace", "view", users(n_users))
    return p


def test_force_rebuild_after_churn_matches_reference():
    """After absorbed churn, force_rebuild() recompiles from the store in
    both packages: the fresh generations are equal again, with a fresh
    spare pool and the same answers."""
    _force_rebuild_after_churn()


def test_force_rebuild_after_churn_matches_reference_async_rebuild(
        monkeypatch):
    """Off-loop: the row overflow goes to the background (one install in
    both packages), and force_rebuild stays synchronous."""
    async_rebuilds(monkeypatch)
    p = _force_rebuild_after_churn()
    assert p.port.stats["bg_rebuilds"] == p.jx.stats["bg_rebuilds"] == 1


def _force_rebuild_after_churn():
    p = Pair(GROUPS_SCHEMA, ["namespace:ns1#viewer@user:alice",
                             "group:eng#member@user:bob",
                             "namespace:ns2#viewer@group:eng#member"])
    p.agree("namespace", "view", ["alice", "bob"])
    for k in range(6):
        p.write([("touch", f"namespace:job-{k}#viewer@user:alice"),
                 ("touch", f"group:eng#member@user:m{k}")])
    p.write([("delete", "namespace:job-2#viewer@user:alice")])
    p.agree("namespace", "view", ["alice", "bob", "m3"])
    assert p.port.stats["spare_assignments"] > 0
    # a hub-free graph has no spare aux rows: the third member of
    # group:eng overflowed its row and rebuilt, in both packages
    rebuilds = p.port.stats["rebuilds"]
    assert rebuilds == 2
    p.port.force_rebuild()
    p.jx.force_rebuild()
    assert not p.port._assigned_refs and p.port._spare_seq == 0
    p.agree("namespace", "view", ["alice", "bob", "m3"])
    assert p.port.stats["rebuilds"] == rebuilds + 1
    return p


def test_store_reset_rebuilds_and_evicts_id_views():
    """delete_all (a reset, not a delta) rebuilds at the next read; the
    outgoing generation's id views are dropped, and no pre-reset id
    reaches a lookup."""
    _store_reset()


def test_store_reset_rebuilds_and_evicts_id_views_async_rebuild(
        monkeypatch):
    """Off-loop: a reset is still the foreground's synchronous rebuild."""
    async_rebuilds(monkeypatch)
    p = _store_reset()
    assert p.port.stats["bg_rebuilds"] == p.jx.stats["bg_rebuilds"] == 0


def _store_reset():
    p = Pair(GROUPS_SCHEMA, ["namespace:old1#viewer@user:alice",
                             "namespace:old2#viewer@user:alice"])
    p.agree("namespace", "view", ["alice"])
    old = p.port._graph
    assert old.ids_np
    p.port.store.delete_all()
    p.jx.store.delete_all()
    p.write([("touch", "namespace:new1#viewer@user:alice")])
    p.agree("namespace", "view", ["alice"])
    assert p.port._graph is not old and not old.ids_np
    assert p.port.stats["rebuilds"] == 2
    assert run(p.port.lookup_resources(
        "namespace", "view", SubjectRef("user", "alice"))) == ["new1"]
    return p


# -- copy-on-write ------------------------------------------------------------

def test_flush_is_copy_on_write_for_tables_and_id_views():
    """A snapshot and a published id view captured before a flush are
    unchanged after it; the live graph moved on."""
    p = Pair(GROUPS_SCHEMA, ["namespace:ns1#viewer@user:alice",
                             "namespace:ns2#viewer@user:bob",
                             "namespace:old#viewer@user:carol"])
    p.agree("namespace", "view", ["alice", "bob", "carol"])
    alice = SubjectRef("user", "alice")
    ctx = p.port._lookup_batch_capture("namespace", "view", [alice])
    g = p.port._graph
    main, aux, _ = g.snapshot()
    main0, aux0 = main.clone(), aux.clone()
    arr, mask = ctx["ids"], ctx["mask"]
    arr0, mask0 = arr.copy(), mask.copy()
    assert "namespace" in g.ids_np_published
    p.write([("touch", "namespace:fresh#viewer@user:alice"),
             ("delete", "namespace:ns1#viewer@user:alice"),
             ("delete", "namespace:old#viewer@user:carol")])
    p.write([("touch", "namespace:newer#viewer@user:alice")])
    assert p.port.graph() is g          # absorbed, not rebuilt
    assert p.port.stats["delta_batches"] == 1
    assert torch.equal(main, main0) and torch.equal(aux, aux0)
    assert g.dev_main is not main and not torch.equal(g.dev_main, main0)
    assert np.array_equal(arr, arr0) and np.array_equal(mask, mask0)
    new_arr, _ = port_te._object_ids_np(g, "namespace")
    assert new_arr is not arr and "fresh" in set(new_arr.tolist())
    # the batch captured before the writes answers as of its capture
    assert [sorted(x) for x in p.port._lookup_batch_extract(ctx)] == \
        [["ns1"]]
    assert sorted(run(p.port.lookup_resources(
        "namespace", "view", alice))) == ["fresh", "newer"]
    p.agree("namespace", "view", ["alice", "bob", "carol"])


def test_lookups_stay_isolated_under_concurrent_churn():
    """Readers run lookup batches while a writer creates and deletes a
    uniquely named namespace for the same subject, so every round renames
    a spare row in and back out.  Each answer must hold the fixed grant
    and at most one job, and no placeholder may reach an extraction (a
    rename patching a captured id view in place would put one there)."""
    import os
    import sys
    import threading
    import time

    port = TorchEndpoint(port_sch.parse_schema(GROUPS_SCHEMA), device="cpu")
    port.store.write([RelationshipUpdate(UpdateOp.TOUCH, parse_relationship(r))
                      for r in ["namespace:base#viewer@user:w"]
                      + [f"group:hub#member@user:h{i}" for i in range(40)]])
    port.graph()
    w = SubjectRef("user", "w")
    stop = threading.Event()
    errors, jobs_seen = [], []
    n_readers = min(16, (os.cpu_count() or 1) + 1)
    rounds = 20

    def writer():
        try:
            for k in range(rounds):
                rel = parse_relationship(f"namespace:job-{k}#viewer@user:w")
                for op in (UpdateOp.TOUCH, UpdateOp.DELETE):
                    port.store.write([RelationshipUpdate(op, rel)])
                    port.graph()   # apply and flush
                    # let every reader finish a batch on this revision
                    n0, t0 = len(jobs_seen), time.monotonic()
                    while (len(jobs_seen) < n0 + n_readers
                           and time.monotonic() - t0 < 2.0):
                        time.sleep(1e-3)
        except Exception as e:   # reported below, never swallowed
            errors.append(repr(e))
        finally:
            stop.set()

    def reader():
        try:
            while not stop.is_set():
                got = set(port._lookup_batch_sync("namespace", "view",
                                                  [w])[0])
                jobs = got - {"base"}
                if ("base" not in got or len(jobs) > 1
                        or not all(j.startswith("job-") for j in jobs)):
                    errors.append(sorted(got))
                jobs_seen.append(len(jobs))
        except Exception as e:
            errors.append(repr(e))

    threads = [threading.Thread(target=writer)]
    threads += [threading.Thread(target=reader) for _ in range(n_readers)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        stop.set()
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]
    assert port.stats["placeholder_suppressed"] == 0
    assert port.stats["rebuilds"] == 1
    assert port.stats["spare_assignments"] == rounds
    assert port.stats["spare_reclaims"] == rounds
    assert any(jobs_seen) and not all(jobs_seen)


def test_unpublished_id_view_is_patched_in_place():
    p = Pair(GROUPS_SCHEMA, ["namespace:ns1#viewer@user:alice"])
    g = p.port.graph()
    arr, _ = port_te._object_ids_np(g, "namespace")
    g.ids_np_published.discard("namespace")   # no lookup holds it
    p.write([("touch", "namespace:fresh#viewer@user:alice")])
    assert p.port.graph() is g
    assert g.ids_np["namespace"][0] is arr and "fresh" in set(arr.tolist())


# -- the parity scenarios of tests/test_torch_ell.py, under churn ------------

def _scenario(name):
    """(schema text, relationship strings, lookup (type, permission))."""
    if name == "graft":
        _, _, store = graft._build_program()
        return (graft._DEMO_SCHEMA,
                sorted(r.rel_string() for r in store.read(None)),
                ("pod", "view"))
    if name == "wildcard":
        rels = ["doc:d1#viewer@user:*", "doc:d2#editor@user:eve",
                "doc:d3#viewer@user:frank", "doc:d4#viewer@bot:b1"]
        rels += [f"doc:x{i}#editor@user:u{i % 7}" for i in range(40)]
        return WILDCARD_SCHEMA, rels, ("doc", "view")
    if name == "nested_groups":
        w = ref_workloads.nested_groups(n_pods=300, n_users=120, n_groups=30,
                                        n_teams=6, n_namespaces=12)
    elif name == "rbac_deny":
        w = ref_workloads.rbac_deny(n_pods=300, n_users=800, n_groups=12)
    else:
        w = ref_workloads.multitenant_1m(n_tenants=10, n_users=2_000,
                                         n_groups=100, n_namespaces=50,
                                         n_pods=5_000, n_tuples=20_000)
    return w.schema_text, list(w.relationships), (w.resource_type,
                                                  w.permission)


def _churn(name, rels, rng):
    """Seeded bursts of writes: deletes of loaded tuples and re-adds,
    tuples re-pointed inside the universe (full rows grow), new object
    ids (spare rows), and for multitenant the pod create/delete
    lifecycle of the dual-write rules."""
    parsed = [ref_parse(r) for r in rels]
    by_subject: dict = {}
    for r in parsed:
        if r.subject.id != "*":
            by_subject.setdefault((r.subject.type, r.subject.relation),
                                  []).append(r.subject.id)
    bursts = []
    created = []
    for b in range(4):
        ops = []
        for r in rng.sample(rels, 6):
            ops.append(("delete", r))
        for r in rng.sample(rels, 8):
            rel = ref_parse(r)
            pool = by_subject.get((rel.subject.type, rel.subject.relation))
            if not pool:
                continue
            sid = rng.choice(pool)
            srel = f"#{rel.subject.relation}" if rel.subject.relation else ""
            ops.append(("touch", f"{rel.resource.type}:{rel.resource.id}"
                                 f"#{rel.relation}@{rel.subject.type}:{sid}"
                                 f"{srel}"))
            ops.append(("touch", f"{rel.resource.type}:new{b}-{len(ops)}"
                                 f"#{rel.relation}@{rel.subject.type}:{sid}"
                                 f"{srel}"))
        ops += [("touch", r) for o, r in bursts[-1] if o == "delete"][:3] \
            if bursts else []
        if name == "multitenant":
            for i in range(6):
                ns, u = rng.randrange(50), rng.randrange(2_000)
                pod = f"ns{ns}/w{b}-{i}"
                created.append((pod, ns, u))
                ops.append(("touch", f"pod:{pod}#namespace@namespace:ns{ns}"))
                ops.append(("touch", f"pod:{pod}#creator@user:u{u}"))
            if b >= 2:
                for pod, ns, u in created[(b - 2) * 6: (b - 2) * 6 + 4]:
                    ops.append(("delete",
                                f"pod:{pod}#namespace@namespace:ns{ns}"))
                    ops.append(("delete", f"pod:{pod}#creator@user:u{u}"))
        bursts.append(ops)
    return bursts


def _queries(prog, lanes, seed):
    """Seeded query columns over every state row, padded with the dead
    index to the word bucket, and a gather list covering every lane."""
    rng = np.random.default_rng(seed)
    w = max(1, -(-lanes // 32))
    w = 1 << (w - 1).bit_length()
    q = np.full(w * 32, prog.dead_index, np.int32)
    q[:lanes] = rng.integers(0, prog.dead_index, lanes)
    g = 4 * lanes
    gi = rng.integers(0, prog.state_size, g).astype(np.int32)
    gc = rng.integers(0, lanes, g).astype(np.int32)
    gc[:lanes] = np.arange(lanes)
    return w, q, gi, gc


@pytest.mark.parametrize("name", ["graft", "wildcard", "nested_groups",
                                  "rbac_deny", "multitenant"])
def test_churned_tables_and_sweeps_match_reference(name):
    schema_text, rels, (rtype, perm) = _scenario(name)
    p = Pair.bootstrap(schema_text, rels)
    rng = random.Random(name)
    stypes = sorted({r.split("@", 1)[1].split(":", 1)[0] for r in rels})
    stype = "user" if "user" in stypes else stypes[0]
    names = sorted({r.split("@", 1)[1].split(":", 1)[1].split("#")[0]
                    for r in rels if r.split("@", 1)[1].startswith(
                        stype + ":")} - {"*"})
    subjects = rng.sample(names, min(4, len(names))) + ["first-contact"]
    objects = rng.sample(sorted(p.jx.store.object_ids_of_type(rtype)), 12)
    p.agree(rtype, perm, subjects, objects, stype=stype)
    kernels.reset_launches()
    for ops in _churn(name, rels, rng):
        p.write(ops)
        p.agree(rtype, perm, subjects, objects, stype=stype)
    assert not any(kernels.LAUNCHES.values())   # CPU: twins only
    assert p.port.stats["delta_batches"] >= 1
    if name != "wildcard":   # wildcard deletes go stale and rebuild
        assert p.port.stats["rebuilds"] == 1
    if name == "multitenant":
        assert p.port.stats["spare_assignments"] > 0
        assert p.port.stats["spare_reclaims"] > 0

    # one batch's sweeps on the churned tables, both packages
    pg, rg = p.port._graph, p.jx._graph
    off, length = pg.prog.slot_range(rtype, perm)
    for lanes in (33, 256):
        w, q, gi, gc = _queries(pg.prog, lanes, seed=lanes)
        ref_out, ref_tel = rg.kernel.checks_device(q, w, gi, gc, rg.dev_main,
                                                   rg.dev_aux)
        ref_state = np.asarray(rg.kernel._arenas[w])
        ref_words, ref_tel_l = rg.kernel.lookup_packed_T_device(
            off, length, q, w, rg.dev_main, rg.dev_aux)
        main, aux, _ = pg.snapshot()
        state, tel = pg.kernel.evaluate(torch.from_numpy(q), w, main, aux,
                                        pg.kernel.take_arena(w))
        out, tel_c = pg.kernel.checks_device(q, w, gi, gc, main, aux)
        words, tel_l = pg.kernel.lookup_packed_T_device(off, length, q, w,
                                                        main, aux)
        assert np.array_equal(state.numpy().view(np.uint32), ref_state)
        assert np.array_equal(tel, np.asarray(ref_tel))
        assert np.array_equal(tel_c, np.asarray(ref_tel))
        assert np.array_equal(tel_l, np.asarray(ref_tel_l))
        assert np.array_equal(out.numpy().view(np.uint32),
                              np.asarray(ref_out))
        assert np.array_equal(words.numpy().view(np.uint32),
                              np.asarray(ref_words))


# -- the scatter_rows twin ----------------------------------------------------

@pytest.mark.parametrize("k", [2, 32])
def test_scatter_rows_twin_matches_numpy_with_duplicates(k):
    rng = np.random.default_rng(k)
    r, b = 500, 64
    src = rng.integers(-2**31, 2**31, (r, k), dtype=np.int64).astype(np.int32)
    rows = rng.integers(0, r, b).astype(np.int32)
    vals = rng.integers(-2**31, 2**31, (b, k), dtype=np.int64).astype(np.int32)
    # pad_scatter's duplicates: repeated rows carry their first values
    rows = np.concatenate([rows, rows[:5], np.repeat(rows[-1:], 7)])
    first = {}
    for i, row in enumerate(rows[:b]):
        first.setdefault(int(row), i)
    vals = np.stack([vals[first[int(row)]] for row in rows])
    want = src.copy()
    want[rows] = vals
    t_src = torch.from_numpy(src.copy())
    got = kernels.scatter_rows(t_src, torch.from_numpy(rows),
                               torch.from_numpy(vals))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(t_src.numpy(), src)        # src untouched
    assert got.data_ptr() != t_src.data_ptr()
    # rows outside [0, R) are skipped
    skip = twins.scatter_rows(t_src, torch.tensor([-1, r], dtype=torch.int32),
                              torch.zeros((2, k), dtype=torch.int32))
    assert torch.equal(skip, t_src)


def test_scatter_rows_refuses_other_devices():
    src = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(kernels.KernelError):
        kernels.scatter_rows(src, torch.zeros(1, dtype=torch.int32,
                                              device="meta"),
                             torch.zeros((1, 2), dtype=torch.int32,
                                         device="meta"))
