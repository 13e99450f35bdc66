"""`torch://?mesh=2x4&device=cpu` end to end, against
`jax://?mesh=2x4&dispatch=direct` and the host oracle.

The port's mesh endpoint co-locates its eight shards on the CPU (the
kernels' plain twins, in-process collectives); the reference's runs
`shard_map` over the conftest's eight virtual CPU devices.  These are the
reference's tests/test_sharded_endpoint.py scenarios — URL parsing, the
delta drain and the sharded flush, hub trees, expirations, phantom
subjects, a batch spanning the data axis, the MeshExecution gate — plus
its caveated mesh case (tests/test_caveat_device.py) and its mesh-sharded
Leopard plane (tests/test_leopard.py), each asked of both endpoints and
the oracle with exact equality.  Both rebuild synchronously (the
reference's AsyncRebuild gate and the port's ASYNC_REBUILD switch off);
tests/test_torch_rebuild_async.py holds the off-loop rebuild.
"""

import asyncio
import random

import jax
import numpy as np
import pytest
import torch

from spicedb_kubeapi_proxy_tpu.ops.jax_endpoint import JaxEndpoint
from spicedb_kubeapi_proxy_tpu.parallel import sharding as ref_sharding
from spicedb_kubeapi_proxy_tpu.spicedb import schema as ref_sch
from spicedb_kubeapi_proxy_tpu.spicedb.endpoints import (
    Bootstrap as RefBootstrap,
    EndpointConfigError as RefConfigError,
    create_endpoint as ref_create_endpoint)
from spicedb_kubeapi_proxy_tpu.spicedb.evaluator import Evaluator
from spicedb_kubeapi_proxy_tpu.spicedb.store import TupleStore as RefStore
from spicedb_kubeapi_proxy_tpu.spicedb.types import (
    CheckRequest as RefCheckRequest,
    ObjectRef as RefObjectRef,
    Permissionship as RefPermissionship,
    Relationship as RefRelationship,
    RelationshipUpdate as RefUpdate,
    SubjectRef as RefSubjectRef,
    UpdateOp as RefOp,
    parse_relationship as ref_parse)
from spicedb_kubeapi_proxy_tpu.utils import workload as ref_workload
from spicedb_kubeapi_proxy_tpu.utils.features import GATES as REF_GATES
from spicedb_kubeapi_proxy_tpu_torch.ops import torch_endpoint as port_te
from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import TorchEndpoint
from spicedb_kubeapi_proxy_tpu_torch.parallel import sharding as port_sharding
from spicedb_kubeapi_proxy_tpu_torch.spicedb import schema as port_sch
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
    Bootstrap, EndpointConfigError, create_endpoint)
from spicedb_kubeapi_proxy_tpu_torch.spicedb.store import TupleStore
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
    CheckRequest,
    ObjectRef,
    Permissionship,
    Relationship,
    RelationshipUpdate,
    SubjectRef,
    UpdateOp,
    parse_relationship)
from spicedb_kubeapi_proxy_tpu_torch.utils import features as port_features
from spicedb_kubeapi_proxy_tpu_torch.utils import workload as port_workload

SCHEMA = """
definition user {}
definition group {
  relation member: user | group#member
}
definition namespace {
  relation viewer: user | group#member | user:*
  relation creator: user
  permission view = viewer + creator
}
"""

# the reference's tests/test_caveat_device.py schema and contexts
CAVEAT_SCHEMA = """
caveat flag(on bool) { on }
caveat limit(n int, max int) { n < max }
definition user {}
definition group {
  relation member: user | group#member | user with flag
}
definition folder {
  relation owner: user
  relation viewer: user | group#member | user with flag
  permission view = viewer + owner
}
definition doc {
  relation folder: folder
  relation reader: user | user with flag | user with limit
  relation blocked: user | user with flag
  relation required: user | user with flag
  permission base = reader + folder->view
  permission gated = base & required
  permission view = base - blocked
  permission strict = gated - blocked
}
"""
UNDECIDED = "[caveat:flag]"
TRUE_CTX = '[caveat:flag:{"on": true}]'
FALSE_CTX = '[caveat:flag:{"on": false}]'

# the reference's tests/test_leopard.py schema and depth-4 chain
NESTED_SCHEMA = """
definition user {}
definition group {
  relation member: user | group#member
  permission view = member
}
definition doc {
  relation viewer: user | group#member
  permission view = viewer
}
"""
CHAIN = [
    "group:g0#member@group:g1#member",
    "group:g1#member@group:g2#member",
    "group:g2#member@group:g3#member",
    "group:g3#member@user:alice",
    "doc:d0#viewer@group:g0#member",
    "doc:d1#viewer@user:bob",
]

TRI = {Permissionship.NO_PERMISSION: 0,
       Permissionship.CONDITIONAL_PERMISSION: 1,
       Permissionship.HAS_PERMISSION: 2}
REF_TRI = {RefPermissionship.NO_PERMISSION: 0,
           RefPermissionship.CONDITIONAL_PERMISSION: 1,
           RefPermissionship.HAS_PERMISSION: 2}


@pytest.fixture(autouse=True)
def reference_like_the_port(monkeypatch):
    """Both rebuild synchronously (the reference's AsyncRebuild gate and
    the port's ASYNC_REBUILD switch off), and both workload planes start
    empty: the same traffic drives both, so each generation's Leopard
    build orders the same measured candidates first
    (`candidate_order=`)."""
    monkeypatch.setattr(REF_GATES._gates["AsyncRebuild"], "value", False)
    monkeypatch.setattr(port_features, "ASYNC_REBUILD", False)
    ref_workload.WORKLOAD.reset()
    port_workload.WORKLOAD.reset()



def _order(candidates) -> list:
    """The Leopard build order a workload plane's candidates give
    (`candidate_order=`)."""
    return [(c["resource_type"], c["permission"]) for c in candidates]

def run(coro):
    return asyncio.run(coro)


class MeshPair:
    """The port's and the reference's mesh endpoints on equal stores, and
    the oracle; writes go to both stores."""

    def __init__(self, schema_text=SCHEMA, rels=(), mesh="2x4"):
        self.port = create_endpoint(f"torch://?mesh={mesh}&device=cpu",
                                    Bootstrap(schema_text=schema_text))
        self.jx = ref_create_endpoint(f"jax://?mesh={mesh}&dispatch=direct",
                                      RefBootstrap(schema_text=schema_text))
        self.oracle = Evaluator(self.jx.schema, self.jx.store)
        if rels:
            self.write([("touch", r) for r in rels])

    def write(self, ops):
        port_ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
        ref_ops = {"touch": RefOp.TOUCH, "delete": RefOp.DELETE}
        self.port.store.write([RelationshipUpdate(port_ops[o],
                                                  parse_relationship(r))
                               for o, r in ops])
        self.jx.store.write([RefUpdate(ref_ops[o], ref_parse(r))
                             for o, r in ops])

    def write_rel(self, port_rel, ref_rel):
        self.port.store.write([RelationshipUpdate(UpdateOp.TOUCH, port_rel)])
        self.jx.store.write([RefUpdate(RefOp.TOUCH, ref_rel)])

    def agree(self, subjects, rtype="namespace", perms=("view",)):
        """Lookups and tri-state checks over every object of `rtype`,
        equal across port, reference and oracle."""
        subs = [SubjectRef("user", s) for s in subjects]
        refs = [RefSubjectRef("user", s) for s in subjects]
        ids = sorted(self.jx.store.object_ids_of_type(rtype))
        for perm in perms:
            got = run(self.port.lookup_resources_batch(rtype, perm, subs))
            ref = run(self.jx.lookup_resources_batch(rtype, perm, refs))
            for s, g, r in zip(refs, got, ref):
                want = sorted(self.oracle.lookup_resources(rtype, perm, s))
                assert sorted(g) == sorted(r) == want, (perm, s)
            reqs = [(o, i) for o in ids for i in range(len(subs))]
            if not reqs:
                continue
            got = run(self.port.check_bulk_permissions(
                [CheckRequest(ObjectRef(rtype, o), perm, subs[i])
                 for o, i in reqs]))
            ref = run(self.jx.check_bulk_permissions(
                [RefCheckRequest(RefObjectRef(rtype, o), perm, refs[i])
                 for o, i in reqs]))
            for (o, i), g, r in zip(reqs, got, ref):
                want = self.oracle.check3(RefObjectRef(rtype, o), perm,
                                          refs[i])
                assert TRI[g.permissionship] == REF_TRI[r.permissionship] \
                    == want, (perm, o, subjects[i])
        assert self.port.stats["rebuilds"] == self.jx.stats["rebuilds"]


class TestShardedEndpoint:
    def test_mesh_url_selects_sharded_graph(self):
        p = MeshPair(rels=["namespace:ns#viewer@user:alice"])
        p.agree(["alice"])
        assert isinstance(p.port._graph, port_te._ShardedEllGraph)
        assert p.port.mesh.shape == dict(p.jx.mesh.shape) == \
            {"data": 2, "graph": 4}
        assert {str(d) for row in p.port.mesh.devices for d in row} == \
            {"cpu"}
        # every shard has its own table blocks: 8 shards, 4 blocks each
        main = p.port._graph.snapshot()[0]
        assert len(main) == 2 and all(len(r) == 4 for r in main)

    def test_mesh_auto_on_the_cpu_is_single_device(self):
        ep = create_endpoint("torch://?mesh=auto&device=cpu",
                             Bootstrap(schema_text=SCHEMA))
        assert ep.mesh is None
        ep.store.write([RelationshipUpdate(UpdateOp.TOUCH, parse_relationship(
            "namespace:ns#viewer@user:alice"))])
        assert run(ep.lookup_resources("namespace", "view",
                                       SubjectRef("user", "alice"))) == ["ns"]
        assert not isinstance(ep._graph, port_te._ShardedEllGraph)

    @pytest.mark.parametrize("mesh", ["banana", "0x4", "2x", "2x0", "-1x2"])
    def test_invalid_mesh_rejected(self, mesh):
        with pytest.raises(EndpointConfigError, match="mesh"):
            create_endpoint(f"torch://?mesh={mesh}&device=cpu",
                            Bootstrap(schema_text=SCHEMA))
        if mesh == "banana":
            with pytest.raises(RefConfigError, match="mesh"):
                ref_create_endpoint(f"jax://?mesh={mesh}",
                                    RefBootstrap(schema_text=SCHEMA))

    def test_mesh_needs_its_cards_and_the_ell_kernel(self, monkeypatch):
        n = torch.cuda.device_count()
        with pytest.raises(EndpointConfigError,
                           match=f"needs {n + 1} devices, have {n}"):
            create_endpoint(f"torch://?mesh=1x{n + 1}",
                            Bootstrap(schema_text=SCHEMA))
        mesh = port_sharding.make_mesh(["cpu"] * 2)
        with pytest.raises(ValueError, match="requires the ell kernel"):
            TorchEndpoint(port_sch.parse_schema(SCHEMA), mesh=mesh,
                          kernel="segment")
        with pytest.raises(ValueError, match="requires the ell kernel"):
            JaxEndpoint(ref_sch.parse_schema(SCHEMA), kernel="segment",
                        mesh=ref_sharding.make_mesh(jax.devices()[:2]))
        # distributed= as jax:// takes it: an invalid value is refused,
        # and a strict join with no cluster configured fails the build
        with pytest.raises(EndpointConfigError, match="invalid distributed"):
            create_endpoint("torch://?distributed=bogus&device=cpu",
                            Bootstrap(schema_text=SCHEMA))
        for k in ("SPICEDB_TPU_COORDINATOR", "SPICEDB_TPU_NUM_PROCESSES",
                  "SPICEDB_TPU_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
                  "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(k, raising=False)
        with pytest.raises(EndpointConfigError,
                           match="distributed=1 .* initialization failed"):
            create_endpoint("torch://?distributed=1&device=cpu",
                            Bootstrap(schema_text=SCHEMA))

    def test_basic_agreement(self):
        p = MeshPair(rels=[
            "group:eng#member@user:alice",
            "group:ops#member@group:eng#member",
            "namespace:ns1#viewer@group:ops#member",
            "namespace:ns2#creator@user:bob",
            "namespace:ns3#viewer@user:*",
        ])
        p.agree(["alice", "bob", "stranger"])

    def test_incremental_deltas_on_sharded_tables(self):
        p = MeshPair(rels=["namespace:ns1#viewer@user:alice",
                           "namespace:ns2#viewer@user:bob"])
        p.agree(["alice", "bob"])
        rebuilds = p.port.stats["rebuilds"]
        graph = p.port._graph
        snap = graph.snapshot()
        p.write([("touch", "namespace:ns1#viewer@user:bob")])
        p.write([("delete", "namespace:ns2#viewer@user:bob")])
        p.agree(["alice", "bob"])
        assert p.port.stats["rebuilds"] == rebuilds
        assert p.port.stats["delta_batches"] > 0
        # copy-on-write: the snapshot taken before the flush is unchanged
        assert graph.snapshot()[0] is not snap[0]
        host = graph.kernel.pad_tables(graph.host_main, graph.host_aux)
        for d in range(2):
            assert np.array_equal(torch.cat(graph.snapshot()[0][d]).numpy(),
                                  host[0])
        # a brand-new object id claims a spare row: no rebuild
        p.write([("touch", "namespace:brand-new#viewer@user:alice")])
        p.agree(["alice", "bob"])
        assert p.port._graph is graph
        assert p.port.stats["rebuilds"] == rebuilds
        assert p.port.stats["spare_assignments"] >= 1

    def test_hub_tree_deltas_sharded(self):
        rels = [f"group:eng#member@user:u{i}" for i in range(120)]
        rels += ["namespace:ns#viewer@group:eng#member"]
        p = MeshPair(rels=rels)
        p.agree(["u0", "u77", "u119"])
        rebuilds = p.port.stats["rebuilds"]
        assert p.port._graph.kernel.aux_passes >= 2
        p.write([("delete", "group:eng#member@user:u77")])
        p.write([("touch", "group:eng#member@user:u200")])
        p.agree(["u0", "u77", "u119", "u200"])
        assert p.port.stats["rebuilds"] == rebuilds

    def test_expiration_on_sharded_path(self):
        p = MeshPair()
        # one clock for both stores, moved by hand: the expiry lands
        # between two reads, whatever each endpoint's first batch costs
        clock = [1_000.0]
        p.port.store._clock = p.jx.store._clock = lambda: clock[0]
        exp = clock[0] + 0.3
        p.write_rel(
            Relationship(resource=ObjectRef("namespace", "ns"),
                         relation="viewer",
                         subject=SubjectRef("user", "alice"),
                         expires_at=exp),
            RefRelationship(resource=RefObjectRef("namespace", "ns"),
                            relation="viewer",
                            subject=RefSubjectRef("user", "alice"),
                            expires_at=exp))
        p.write([("touch", "namespace:ns#viewer@user:bob")])
        p.agree(["alice", "bob"])
        clock[0] += 0.35
        assert run(p.port.lookup_resources(
            "namespace", "view", SubjectRef("user", "alice"))) == []
        p.agree(["alice", "bob"])

    def test_phantom_subjects_sharded(self):
        p = MeshPair(rels=["namespace:open#viewer@user:*",
                           "namespace:closed#viewer@user:alice"])

        class _NoOracle:
            def __getattr__(self, name):
                raise AssertionError("oracle fallback on the sharded path")

        p.port._oracle = _NoOracle()
        subs = [SubjectRef("user", f"new{i}") for i in range(50)]
        out = run(p.port.lookup_resources_batch("namespace", "view", subs))
        assert all(x == ["open"] for x in out)

    def test_large_batch_spans_data_axis(self):
        rels = [f"namespace:ns{i % 7}#viewer@user:u{i}" for i in range(300)]
        p = MeshPair(rels=rels)
        names = [f"u{i}" for i in range(300)]
        subs = [SubjectRef("user", s) for s in names]
        got = run(p.port.lookup_resources_batch("namespace", "view", subs))
        ref = run(p.jx.lookup_resources_batch(
            "namespace", "view", [RefSubjectRef("user", s) for s in names]))
        assert [sorted(g) for g in got] == [sorted(r) for r in ref]
        for s, g in zip(subs[::37], got[::37]):
            assert sorted(g) == sorted(p.oracle.lookup_resources(
                "namespace", "view", RefSubjectRef("user", s.id)))
        # 300 lanes: 16 words, 8 per data shard — both shards answered
        kern = p.port._graph.kernel
        assert kern.padded_batch_words(300) == 16
        assert sum(1 for g in got if g) == 300
        p.agree(names[:40] + names[-40:])


class TestMeshGate:
    def test_gate_off_explicit_mesh_fails_loud(self, monkeypatch):
        monkeypatch.setattr(port_features, "MESH_EXECUTION", False)
        with pytest.raises(EndpointConfigError, match="MeshExecution"):
            create_endpoint("torch://?mesh=2x4&device=cpu",
                            Bootstrap(schema_text=SCHEMA))

    def test_gate_off_auto_is_single_device(self, monkeypatch):
        def boom(*a, **k):
            raise AssertionError("sharded path reached with the gate off")

        monkeypatch.setattr(port_te, "_ShardedEllGraph", boom)
        monkeypatch.setattr(port_sharding, "make_mesh", boom)
        monkeypatch.setattr(port_features, "MESH_EXECUTION", False)
        ep = create_endpoint("torch://?mesh=auto&device=cpu",
                             Bootstrap(schema_text=SCHEMA))
        assert ep.mesh is None
        ep.store.write([RelationshipUpdate(UpdateOp.TOUCH, parse_relationship(
            "namespace:ns#viewer@user:alice"))])
        assert run(ep.lookup_resources("namespace", "view",
                                       SubjectRef("user", "alice"))) == ["ns"]

    def test_sharded_arena_pool_reuses_state(self):
        p = MeshPair(rels=["namespace:ns#viewer@user:alice"])
        p.agree(["alice"])
        kern = p.port._graph.kernel
        key = kern.padded_batch_words(32)
        a1 = kern.take_arena(key)
        kern.put_arena(key, a1)
        a2 = kern.take_arena(key)
        assert a2 is a1
        kern.put_arena(key, a2)
        kern.discard_arena(key)
        assert kern.take_arena(key) is not a1


def _caveat_rels(seed):
    """The reference's tests/test_caveat_device.py random mesh graph."""
    rng = random.Random(seed + 100)
    users = [f"u{i}" for i in range(5)]
    docs = [f"d{i}" for i in range(6)]
    folders = ["f0", "f1"]
    rels = set()
    for _ in range(40):
        kind = rng.randrange(4)
        u = rng.choice(users)
        if kind == 0:
            suf = rng.choice(["", UNDECIDED, TRUE_CTX, FALSE_CTX])
            rel = rng.choice(["reader", "blocked", "required"])
            rels.add(f"doc:{rng.choice(docs)}#{rel}@user:{u}{suf}")
        elif kind == 1:
            rels.add(f"doc:{rng.choice(docs)}#folder@folder:"
                     f"{rng.choice(folders)}")
        elif kind == 2:
            suf = rng.choice(["", UNDECIDED])
            rels.add(f"folder:{rng.choice(folders)}#viewer@user:{u}{suf}")
        else:
            rels.add(f"folder:{rng.choice(folders)}#owner@user:{u}")
    return users, docs, sorted(rels)


@pytest.mark.parametrize("seed", [0, 1])
def test_caveats_on_the_sharded_mesh(seed):
    """The MAYBE plane on the mesh: tri-state checks (CONDITIONAL
    included) and definite-plane lookups equal the reference's and the
    oracle's, nothing routed to the oracle, and caveated deltas absorbed
    without a rebuild (the caveat table remapped into the padded rows)."""
    users, docs, rels = _caveat_rels(seed)
    p = MeshPair(CAVEAT_SCHEMA, rels)
    perms = ("base", "gated", "view", "strict")
    p.agree(users, "doc", perms)
    assert p.port.stats["oracle_residual_checks"] == 0
    kern = p.port._graph.kernel
    assert kern.planes and p.jx._graph.kernel.planes
    got = run(p.port.check_bulk_permissions(
        [CheckRequest(ObjectRef("doc", d), perm, SubjectRef("user", u))
         for d in docs for perm in perms for u in users]))
    assert any(r.permissionship == Permissionship.CONDITIONAL_PERMISSION
               for r in got)
    rebuilds = p.port.stats["rebuilds"]
    u0, d0 = users[0], docs[0]
    for suf in (UNDECIDED, TRUE_CTX, FALSE_CTX):
        p.write([("touch", f"doc:{d0}#blocked@user:{u0}{suf}")])
        p.agree([u0], "doc", ("view", "strict"))
    p.write([("delete", f"doc:{d0}#blocked@user:{u0}{FALSE_CTX}")])
    p.write([("touch", f"folder:f1#viewer@user:{users[1]}{UNDECIDED}")])
    p.agree(users, "doc", perms)
    assert p.port.stats["rebuilds"] == rebuilds
    graph = p.port._graph
    host = kern.pad_tables(graph.host_main, graph.host_aux, graph.host_cav)
    for blocks, want in zip(graph.snapshot(), host):
        for d in range(2):
            assert np.array_equal(torch.cat(blocks[d]).numpy(), want)


class TestLeopardOnTheMesh:
    """The closure planes row-sharded over the graph axis of a 1x2 mesh,
    as the reference's tests/test_leopard.py mesh case."""

    def _pair(self):
        port_mesh = port_sharding.make_mesh(["cpu"] * 2, data=1, graph=2)
        port = TorchEndpoint(port_sch.parse_schema(NESTED_SCHEMA),
                             store=TupleStore(), device="cpu",
                             mesh=port_mesh)
        jx = JaxEndpoint(ref_sch.parse_schema(NESTED_SCHEMA),
                         store=RefStore(),
                         mesh=ref_sharding.make_mesh(jax.devices()[:2],
                                                     data=1, graph=2))
        pair = MeshPair.__new__(MeshPair)
        pair.port, pair.jx = port, jx
        pair.oracle = Evaluator(jx.schema, jx.store)
        pair.write([("touch", r) for r in CHAIN])
        return pair

    def _settle(self, p):
        for ep in (p.port, p.jx):
            with ep._lock:
                ep._current_graph()
            assert ep.wait_rebuilds()

    def test_plane_parity_on_the_mesh(self):
        p = self._pair()
        p.agree(["alice", "bob", "zed"], "doc")
        lp = p.port._leopard
        assert lp.status_map().get("doc#view") == "indexed" == \
            p.jx._leopard.status_map().get("doc#view")
        assert (_order(port_workload.WORKLOAD.leopard_candidates())
                == _order(ref_workload.WORKLOAD.leopard_candidates()))
        frag = lp.lookup_frag("doc", "view")
        assert isinstance(frag.plane, tuple) and len(frag.plane) == 2
        ref_frag = p.jx._leopard.lookup_frag("doc", "view")
        plane = torch.cat(frag.plane).numpy().view(np.uint32)
        assert np.array_equal(plane, np.asarray(ref_frag.plane))
        assert p.port.stats["leopard_checks"] == \
            p.jx.stats["leopard_checks"] > 0
        assert p.port.stats["leopard_lookups"] == \
            p.jx.stats["leopard_lookups"] > 0
        # maintenance composes: an insert, then an unprovable delete that
        # quarantines and re-closes, hold parity on the sharded planes
        p.write([("touch", "group:g1#member@user:zed")])
        self._settle(p)
        p.agree(["alice", "zed"], "doc")
        p.write([("delete", "group:g1#member@user:zed")])
        self._settle(p)
        p.agree(["alice", "zed"], "doc")
        assert lp.status_map().get("doc#view") == "indexed"
        plane = torch.cat(lp.lookup_frag("doc", "view").plane).numpy()
        assert np.array_equal(plane.view(np.uint32), np.asarray(
            p.jx._leopard.lookup_frag("doc", "view").plane))
