"""The torch port's segment kernel held against the JAX reference.

The reference's second kernel kind (`SPICEDB_TPU_KERNEL=segment`) sweeps a
float32 [N, B] state with a gather + `segment_sum` over padded COO edge
arrays; the port sweeps a packed int32 [N, W] state with `edge_or` and the
ELL path's seed, permission and delta kernels (here on the CPU: their
plain-torch twins).  On the same program and edge arrays (carried across
with `convert.segment_from_reference`) the port's pipelined entries must
give the reference's final state (its `> 0`, packed), trace (sweep count
and changed entries per sweep), checks and lookups, at 8, 33 and 256
lanes.  End to end, `TorchEndpoint(kernel="segment", device="cpu")`
answers as `JaxEndpoint(kernel="segment")` and the host oracle do, and
under writes, deletes and expirations both keep equal edge arrays, free
lists, tuple positions and rebuild counts.  Both run with their off-loop
rebuilds off (the reference's AsyncRebuild gate, the port's ASYNC_REBUILD
switch: a delta they cannot absorb rebuilds synchronously) and the
reference's Leopard index as the port's.  Tolerance is zero
everywhere: the data are ids, integers and bitplanes.
"""

import asyncio
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from spicedb_kubeapi_proxy_tpu.models import workloads as ref_workloads
from spicedb_kubeapi_proxy_tpu.ops import spmv as ref_spmv
from spicedb_kubeapi_proxy_tpu.ops.graph_compile import compile_graph
from spicedb_kubeapi_proxy_tpu.ops.jax_endpoint import JaxEndpoint
from spicedb_kubeapi_proxy_tpu.spicedb import schema as ref_sch
from spicedb_kubeapi_proxy_tpu.spicedb.endpoints import (
    Bootstrap as RefBootstrap)
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
from spicedb_kubeapi_proxy_tpu_torch import convert
from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
from spicedb_kubeapi_proxy_tpu_torch.ops import spmv as port_spmv
from spicedb_kubeapi_proxy_tpu_torch.ops import torch_endpoint as port_te
from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference as twins
from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import TorchEndpoint
from spicedb_kubeapi_proxy_tpu_torch.spicedb import schema as port_sch
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
    Bootstrap, create_endpoint)
from spicedb_kubeapi_proxy_tpu_torch.spicedb.store import TupleStore
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
    CheckRequest,
    ObjectRef,
    RelationshipUpdate,
    SubjectRef,
    UpdateOp,
    parse_relationship)
from spicedb_kubeapi_proxy_tpu_torch.utils import features as port_features

WILDCARD_SCHEMA = """
definition user {}
definition bot {}
definition doc {
  relation viewer: user | user:* | bot
  relation editor: user
  permission view = viewer + editor
}
"""

GROUPS_SCHEMA = """
definition user {}
definition group {
  relation member: user | group#member
}
definition namespace {
  relation viewer: user | group#member
  relation creator: user
  permission view = viewer + creator
}
"""

CAVEAT_SCHEMA = """
caveat flag(on bool) { on }
definition user {}
definition group {
  relation member: user | group#member | user with flag
}
definition doc {
  relation reader: user | group#member | user with flag
  relation blocked: user
  permission view = reader - blocked
}
"""


@pytest.fixture(autouse=True)
def sync_reference_rebuilds(monkeypatch):
    """Both packages rebuild synchronously: the reference's AsyncRebuild
    gate and the port's ASYNC_REBUILD switch are off."""
    monkeypatch.setattr(GATES._gates["AsyncRebuild"], "value", False)
    monkeypatch.setattr(port_features, "ASYNC_REBUILD", False)


def run(coro):
    return asyncio.run(coro)


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
    elif name == "multitenant":
        w = ref_workloads.multitenant_1m(n_tenants=10, n_users=2_000,
                                         n_groups=100, n_namespaces=50,
                                         n_pods=5_000, n_tuples=20_000)
    else:
        raise KeyError(name)
    return w.schema_text, list(w.relationships), (w.resource_type,
                                                  w.permission)


SCENARIOS = ["graft", "wildcard", "nested_groups", "rbac_deny", "multitenant"]


def _unpack(words: np.ndarray) -> np.ndarray:
    """bool [R, 32 * W] lanes of int32 [R, W] packed rows."""
    w = np.ascontiguousarray(words).view(np.uint8).reshape(words.shape[0], -1)
    return np.unpackbits(w, axis=1, bitorder="little").astype(bool)


# -- the kernel cache --------------------------------------------------------

@pytest.mark.parametrize("name", SCENARIOS)
def test_pad_edges_and_bucket_match_reference(name):
    schema_text, rels, _ = _scenario(name)
    prog = compile_graph(ref_sch.parse_schema(schema_text),
                         [ref_parse(r) for r in rels])
    port_prog = convert.program_from_reference(prog)
    for cap in (None, port_spmv.bucket(max(2 * len(prog.edge_src), 256))):
        rs, rd = ref_spmv.pad_edges(prog, cap)
        ps, pd = port_spmv.pad_edges(port_prog, cap)
        assert np.array_equal(rs, ps) and np.array_equal(rd, pd)
    for n in (0, 1, 8, 33, 1000):
        assert port_spmv.bucket(n) == ref_spmv.bucket(n)
        assert port_spmv.bucket(n, 8) == ref_spmv.bucket(n, 8)
    with pytest.raises(ValueError):
        port_spmv.pad_edges(port_prog, len(prog.edge_src) - 1) \
            if len(prog.edge_src) else port_spmv.pad_edges(port_prog, -1)


@pytest.mark.parametrize("lanes", [8, 33, 256])
@pytest.mark.parametrize("name", SCENARIOS)
def test_kernel_cache_matches_reference(name, lanes):
    """Final state, trace, checks and lookups of the pipelined entries,
    the port's on the reference's own padded edge arrays."""
    schema_text, rels, (rtype, perm) = _scenario(name)
    prog = compile_graph(ref_sch.parse_schema(schema_text),
                         [ref_parse(r) for r in rels])
    cap = ref_spmv.bucket(max(2 * len(prog.edge_src), 256))
    src, dst = ref_spmv.pad_edges(prog, cap)
    kc = ref_spmv.KernelCache(prog)
    rng = np.random.default_rng(lanes)
    b = ref_spmv.bucket(lanes, 8)
    q = np.full(b, prog.dead_index, np.int32)
    q[:lanes] = rng.integers(0, prog.dead_index, lanes)
    g = 4 * lanes
    gi = rng.integers(0, prog.state_size, g).astype(np.int32)
    gc = rng.integers(0, lanes, g).astype(np.int32)
    gc[:lanes] = np.arange(lanes)
    ref_out, ref_tel = kc.checks3_device(q, gi, gc, jnp.asarray(src),
                                         jnp.asarray(dst))
    ref_state = np.asarray(kc._arenas[b]) > 0
    off, length = prog.slot_range(rtype, perm)
    ref_look, ref_tel_l = kc.lookup_T_device(off, length, q, jnp.asarray(src),
                                             jnp.asarray(dst))
    assert ref_tel is not None and int(np.asarray(ref_tel)[0]) >= 1

    class _Ref:   # the reference graph's fields the converter reads
        pass
    ref_graph = _Ref()
    ref_graph.prog, ref_graph.edge_src, ref_graph.edge_dst = prog, src, dst
    ref_graph.free, ref_graph.positions = [], {}
    p_src, p_dst, _, _, port = convert.segment_from_reference(
        ref_graph, device="cpu")
    assert port.num_iters == kc.num_iters
    w = max(1, -(-b // 32))
    w = 1 << (w - 1).bit_length()
    qp = np.full(32 * w, prog.dead_index, np.int32)
    qp[:b] = q
    kernels.reset_launches()
    state, tel = port.evaluate(torch.from_numpy(qp), w, p_src, p_dst,
                               port.take_arena(w))
    out, tel_c = port.checks_device(qp, w, gi, gc, p_src, p_dst)
    words, tel_l = port.lookup_packed_T_device(off, length, qp, w, p_src,
                                               p_dst)
    assert not any(kernels.LAUNCHES.values())   # CPU: the twins only

    lanes_p = _unpack(state.numpy())
    assert np.array_equal(lanes_p[:, :b], ref_state)
    assert not lanes_p[:, b:].any()
    assert np.array_equal(tel, np.asarray(ref_tel))
    assert np.array_equal(tel_c, np.asarray(ref_tel))
    assert np.array_equal(tel_l, np.asarray(ref_tel_l))
    assert np.array_equal(out.numpy(), np.asarray(ref_out))
    # [W, L] words against the reference's bool [B, L] rows
    look = _unpack(words.numpy().T).T
    assert np.array_equal(look[:b], np.asarray(ref_look))
    assert not look[b:].any()
    if lanes > 32:
        assert bool((state[:, 0] < 0).any())   # bit 31 is live


def test_edge_or_twin_matches_numpy():
    """Duplicate destinations, padding edges on the dead row, bit 31."""
    rng = np.random.default_rng(5)
    n, w, e = 50, 3, 400
    x = rng.integers(-2**31, 2**31, (n, w), dtype=np.int64).astype(np.int32)
    x[n - 1] = 0                                   # the dead row
    y = rng.integers(-2**31, 2**31, (n, w), dtype=np.int64).astype(np.int32)
    y[n - 1] = 0
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, 8, e).astype(np.int32)  # heavy duplicates
    src[-100:] = dst[-100:] = n - 1               # padding edges
    want = y.copy().view(np.uint32)
    for s, d in zip(src, dst):
        want[d] |= x.view(np.uint32)[s]
    got = torch.from_numpy(y.copy())
    kernels.edge_or(got, torch.from_numpy(x), torch.from_numpy(src),
                    torch.from_numpy(dst))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert bool((got < 0).any())
    assert not got[n - 1].any()
    # no edges: nothing changes
    keep = torch.from_numpy(y.copy())
    twins.edge_or(keep, torch.from_numpy(x), torch.zeros(0, dtype=torch.int32),
                  torch.zeros(0, dtype=torch.int32))
    assert np.array_equal(keep.numpy(), y)


def test_gather_twin_takes_a_table_without_gathers():
    """The segment sweep's init step: `ell_gather_or` over an [N, 0]
    table writes exactly the seed and the wildcard terms."""
    x0 = torch.tensor([[1], [2], [4], [0]], dtype=torch.int32)
    live = torch.tensor([[8], [16]], dtype=torch.int32)
    bits = torch.tensor([0, 1, 3, 2], dtype=torch.int32)
    y = torch.full((4, 1), 99, dtype=torch.int32)
    twins.ell_gather_or(y, torch.empty((4, 0), dtype=torch.int32), 0, x0=x0,
                        wc_bits=bits, wc_live=live)
    assert y.flatten().tolist() == [1, 2 | 8, 4 | 8 | 16, 16]


# -- the endpoint -----------------------------------------------------------

class Pair:
    """The port and the reference on the segment kernel, on equal
    stores, plus the oracle."""

    def __init__(self, schema_text, rels, clock=None, leopard=True):
        GATES._gates["LeopardIndex"].value = leopard
        try:
            self.jx = JaxEndpoint(ref_sch.parse_schema(schema_text),
                                  store=RefStore(clock=clock) if clock
                                  else None, kernel="segment")
        finally:
            GATES._gates["LeopardIndex"].value = True
        self.port = TorchEndpoint(port_sch.parse_schema(schema_text),
                                  store=TupleStore(clock=clock)
                                  if clock else None, device="cpu",
                                  kernel="segment", leopard=leopard)
        self.oracle = Evaluator(self.jx.schema, self.jx.store)
        if rels:
            self.write([("touch", r) for r in rels])

    def write(self, ops):
        """One committed write in each store; both endpoints then apply
        it and finish any Leopard re-close it kicked, so the next reads
        (and the `leopard_*` counters) never race a background re-close."""
        port_ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
        ref_ops = {"touch": RefOp.TOUCH, "delete": RefOp.DELETE}
        self.port.store.write([RelationshipUpdate(port_ops[o],
                                                  parse_relationship(r))
                               for o, r in ops])
        self.jx.store.write([RefUpdate(ref_ops[o], ref_parse(r))
                             for o, r in ops])
        for ep in (self.port, self.jx):
            with ep._lock:
                ep._current_graph()
            assert ep.wait_rebuilds()

    def agree(self, rtype, perm, names, objects=None, stype="user"):
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
        tri = {RefPermissionship.NO_PERMISSION: 0,
               RefPermissionship.CONDITIONAL_PERMISSION: 1,
               RefPermissionship.HAS_PERMISSION: 2}
        for (o, i), g, r in zip(reqs, got, ref):
            want = self.oracle.check3(RefObjectRef(rtype, o), perm, refs[i])
            assert port_te.TorchEndpoint._TRISTATE[tri[r.permissionship]] \
                == g.permissionship and tri[r.permissionship] == want, \
                (o, names[i])
        self.assert_same_edges()

    def assert_same_edges(self):
        p, r = self.port._graph, self.jx._graph
        assert isinstance(p, port_te._SegmentGraph)
        for k in ("rebuilds", "delta_batches", "spare_assignments",
                  "spare_reclaims", "stale_pair_marks",
                  "oracle_residual_checks", "leopard_checks",
                  "leopard_lookups", "leopard_recloses", "kernel_calls"):
            assert self.port.stats[k] == self.jx.stats[k], k
        assert self.port._graph_revision == self.jx._graph_revision
        assert np.array_equal(p.edge_src.numpy(), np.asarray(r.edge_src))
        assert np.array_equal(p.edge_dst.numpy(), np.asarray(r.edge_dst))
        assert np.array_equal(p.host_src, p.edge_src.numpy())
        assert np.array_equal(p.host_dst, p.edge_dst.numpy())
        assert p.free == r.free
        assert p.positions == r.positions
        assert p.tri_state_capable == r.tri_state_capable
        assert p.prog.object_ids == r.prog.object_ids


@pytest.mark.parametrize("name", SCENARIOS)
def test_endpoint_matches_reference_and_oracle(name):
    schema_text, rels, (rtype, perm) = _scenario(name)
    text = "\n".join(rels)
    port = create_endpoint("torch://?device=cpu",
                           Bootstrap(schema_text, text), kernel="segment")
    jx = JaxEndpoint.from_bootstrap(RefBootstrap(schema_text, text),
                                    kernel="segment")
    oracle = Evaluator(jx.schema, jx.store)
    assert port.kernel_kind == jx.kernel_kind == "segment"
    stype = "user"
    names = sorted({r.split("@", 1)[1].split(":", 1)[1].split("#")[0]
                    for r in rels if r.split("@", 1)[1].startswith("user:")}
                   - {"*"})
    rng = random.Random(name)
    subjects = rng.sample(names, min(6, len(names))) + ["first-contact"]
    objects = rng.sample(sorted(jx.store.object_ids_of_type(rtype)),
                         min(20, len(jx.store.object_ids_of_type(rtype))))
    got = run(port.lookup_resources_batch(
        rtype, perm, [SubjectRef(stype, s) for s in subjects]))
    ref = run(jx.lookup_resources_batch(
        rtype, perm, [RefSubjectRef(stype, s) for s in subjects]))
    for s, g, r in zip(subjects, got, ref):
        want = sorted(oracle.lookup_resources(rtype, perm,
                                              RefSubjectRef(stype, s)))
        assert sorted(g) == sorted(r) == want, s
    reqs = [(o, s) for o in objects + ["never-created"] for s in subjects]
    got = run(port.check_bulk_permissions(
        [CheckRequest(ObjectRef(rtype, o), perm, SubjectRef(stype, s))
         for o, s in reqs]))
    for (o, s), g in zip(reqs, got):
        assert g.allowed == oracle.check(RefObjectRef(rtype, o), perm,
                                         RefSubjectRef(stype, s)), (o, s)
    g = port._graph
    assert np.array_equal(g.edge_src.numpy(), np.asarray(jx._graph.edge_src))
    assert np.array_equal(g.edge_dst.numpy(), np.asarray(jx._graph.edge_dst))
    assert g.free == jx._graph.free and g.positions == jx._graph.positions
    # the sweep byte model is the reference's segment term
    assert port_te._sweep_bytes(g, 256) == \
        int(g.edge_src.shape[0]) * 2 * 256 * 4


def test_writes_deletes_and_expirations_keep_edges_equal():
    clk = [1_700_000_000.0]
    p = Pair(GROUPS_SCHEMA, ["namespace:ns1#viewer@user:alice",
                             "group:eng#member@user:bob",
                             "namespace:ns2#viewer@group:eng#member"],
             clock=lambda: clk[0])
    p.agree("namespace", "view", ["alice", "bob", "carol"])
    p.write([("touch", "group:eng#member@user:carol"),
             ("delete", "namespace:ns1#viewer@user:alice")])
    p.agree("namespace", "view", ["alice", "bob", "carol"])
    # re-touch is a no-op; a freed position is reused from the end
    p.write([("touch", "group:eng#member@user:carol"),
             ("touch", "namespace:ns1#viewer@user:alice")])
    p.agree("namespace", "view", ["alice", "bob", "carol"])
    p.write([("touch", "namespace:ns3#viewer@user:dave"
              f"[expiration:{clk[0] + 100}]"),
             ("touch", "namespace:fresh#creator@user:erin")])
    p.agree("namespace", "view", ["dave", "erin"])
    clk[0] += 200
    p.agree("namespace", "view", ["dave", "erin", "carol"])
    assert p.port.stats["rebuilds"] == 1
    assert p.port.stats["delta_batches"] >= 3
    assert p.port.stats["spare_assignments"] > 0


def test_capacity_exhaustion_rebuilds_like_the_reference():
    p = Pair(GROUPS_SCHEMA, [f"group:g#member@user:u{i}" for i in range(4)]
             + ["namespace:ns#viewer@group:g#member"])
    p.agree("namespace", "view", ["u1"])
    cap = p.port._graph.edge_src.shape[0]
    free0 = len(p.port._graph.free)
    assert cap == port_spmv.bucket(max(2 * 5, 256)) and free0 == cap - 5
    for k in range(0, free0 + 4, 40):
        p.write([("touch", f"group:g#member@user:n{j}")
                 for j in range(k, min(k + 40, free0 + 4))])
        p.agree("namespace", "view", ["u1", f"n{k}"], objects=["ns"])
    assert p.port.stats["rebuilds"] == p.jx.stats["rebuilds"] >= 2
    assert p.port._graph.edge_src.shape[0] > cap


@pytest.mark.parametrize("name", SCENARIOS)
def test_churned_edges_match_reference(name):
    """Seeded bursts of deletes, re-adds and new ids on every scenario
    (wildcard deletes are unabsorbable and rebuild in both packages)."""
    schema_text, rels, (rtype, perm) = _scenario(name)
    p = Pair(schema_text, [])
    text = "\n".join(rels)
    p.port = create_endpoint("torch://?device=cpu",
                             Bootstrap(schema_text, text), kernel="segment")
    p.jx = JaxEndpoint.from_bootstrap(RefBootstrap(schema_text, text),
                                      kernel="segment")
    p.oracle = Evaluator(p.jx.schema, p.jx.store)
    rng = random.Random(name)
    names = sorted({r.split("@", 1)[1].split(":", 1)[1].split("#")[0]
                    for r in rels if r.split("@", 1)[1].startswith("user:")}
                   - {"*"})
    subjects = rng.sample(names, min(4, len(names))) + ["first-contact"]
    objects = rng.sample(sorted(p.jx.store.object_ids_of_type(rtype)), 12)
    p.agree(rtype, perm, subjects, objects)
    for b in range(3):
        ops = [("delete", r) for r in rng.sample(rels, 6)]
        for r in rng.sample(rels, 6):
            res, sub = r.split("@", 1)
            t, rest = res.split(":", 1)
            ops.append(("touch", f"{t}:new{b}-{len(ops)}#"
                                 f"{rest.split('#', 1)[1]}@{sub}"))
        ops += [("touch", r) for o, r in ops[:3] if o == "delete"]
        p.write(ops)
        p.agree(rtype, perm, subjects, objects)
    if name != "wildcard":
        assert p.port.stats["rebuilds"] == 1
    assert p.port.stats["delta_batches"] >= 1


def test_flush_is_copy_on_write():
    # the index off: the batch below is captured on the port alone, so
    # it must reach the sweep, not the closure plane
    p = Pair(GROUPS_SCHEMA, ["namespace:ns1#viewer@user:alice",
                             "namespace:ns2#viewer@user:bob"], leopard=False)
    p.agree("namespace", "view", ["alice", "bob"])
    g = p.port._graph
    src, dst = g.snapshot()
    src0, dst0 = src.clone(), dst.clone()
    alice = SubjectRef("user", "alice")
    ctx = p.port._lookup_batch_capture("namespace", "view", [alice])
    p.write([("touch", "namespace:ns2#viewer@user:alice"),
             ("delete", "namespace:ns1#viewer@user:alice")])
    assert p.port.graph() is g
    assert torch.equal(src, src0) and torch.equal(dst, dst0)
    assert g.edge_src is not src and not torch.equal(g.edge_dst, dst0)
    assert [sorted(x) for x in p.port._lookup_batch_extract(ctx)] == \
        [["ns1"]]
    p.port.stats["kernel_calls"] -= 1   # the port-only capture above
    p.agree("namespace", "view", ["alice", "bob"])


def test_undecidable_caveat_rebuilds_and_routes_to_the_oracle():
    """A context-decided caveat is an ordinary edge; the first
    undecidable one cannot be placed (no MAYBE plane), rebuilds, and the
    rebuilt graph serves the caveat-affected pairs from the oracle."""
    rels = ["doc:d1#reader@user:a", "doc:d2#reader@group:g#member",
            "group:g#member@user:b", 'doc:d3#reader@user:c'
            '[caveat:flag:{"on": true}]', "doc:d1#blocked@user:c"]
    p = Pair(CAVEAT_SCHEMA, rels)
    p.agree("doc", "view", ["a", "b", "c", "d"])
    assert p.port._graph.tri_state_capable
    p.write([("touch", 'group:g#member@user:d[caveat:flag:{"on": false}]')])
    p.agree("doc", "view", ["a", "b", "c", "d"])
    assert p.port.stats["rebuilds"] == 1
    p.write([("touch", "doc:d1#reader@user:d[caveat:flag]")])
    p.agree("doc", "view", ["a", "b", "c", "d"])
    assert p.port.stats["rebuilds"] == 2
    assert not p.port._graph.tri_state_capable
    assert p.port.stats["oracle_residual_checks"] > 0
    # the undecidable tuple goes again: still a plane-less generation
    p.write([("delete", "doc:d1#reader@user:d[caveat:flag]")])
    p.agree("doc", "view", ["a", "b", "c", "d"])


def test_kernel_selection(monkeypatch):
    schema = port_sch.parse_schema(GROUPS_SCHEMA)
    monkeypatch.setenv("SPICEDB_TPU_KERNEL", "segment")
    ep = TorchEndpoint(schema, device="cpu")
    assert ep.kernel_kind == "segment"
    assert isinstance(ep.graph(), port_te._SegmentGraph)
    assert TorchEndpoint(schema, device="cpu", kernel="ell").kernel_kind \
        == "ell"
    monkeypatch.setenv("SPICEDB_TPU_KERNEL", "ell")
    assert isinstance(TorchEndpoint(schema, device="cpu").graph(),
                      port_te._EllGraph)
    monkeypatch.delenv("SPICEDB_TPU_KERNEL")
    assert TorchEndpoint(schema, device="cpu").kernel_kind == "ell"
    with pytest.raises(ValueError, match="unknown kernel 'sparse'"):
        TorchEndpoint(schema, device="cpu", kernel="sparse")
    with pytest.raises(ValueError) as ref_err:
        JaxEndpoint(ref_sch.parse_schema(GROUPS_SCHEMA), kernel="sparse")
    with pytest.raises(ValueError) as port_err:
        create_endpoint("torch://?device=cpu", Bootstrap(GROUPS_SCHEMA, ""),
                        kernel="sparse")
    assert str(port_err.value) == str(ref_err.value)
