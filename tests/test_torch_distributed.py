"""`torch://?distributed=` and the mesh across processes, on the CPU.

The reference's five TestDistributedGlue cases (tests/test_sharded_
endpoint.py) replayed on the port's parallel/distributed.py and
endpoint parsing, with the same monkeypatching, messages and recorded
calls.  Then 2- and 4-rank gloo meshes (`1x2`, `1x4` — two shards a rank,
so the in-rank kernel write and the cross-rank exchange both run — and
`2x2`): every rank is a subprocess (tests/torch_dist_rank.py) on
`device=cpu` with the SPICEDB_TPU_* env triplet and a free port, and
must answer bit for bit as the single-process `torch://?device=cpu&mesh=`,
the reference's `jax://?mesh=` on the conftest's eight virtual devices
and the oracle, sweep traces included, before and after a write that
every rank applies; the ShardedEllKernel alone on the plainly compiled
program gives the reference's lookup words, checks and traces.  Each
multi-process run has its own hard timeout, so a hung rank fails its
test and not the suite.
"""

import asyncio

import jax
import numpy as np
import pytest

from spicedb_kubeapi_proxy_tpu.models import workloads as ref_workloads
from spicedb_kubeapi_proxy_tpu.ops.graph_compile import (
    compile_graph as ref_compile)
from spicedb_kubeapi_proxy_tpu.parallel import sharding as ref_sharding
from spicedb_kubeapi_proxy_tpu.spicedb import schema as ref_sch
from spicedb_kubeapi_proxy_tpu.spicedb.endpoints import (
    Bootstrap as RefBootstrap, create_endpoint as ref_create_endpoint)
from spicedb_kubeapi_proxy_tpu.spicedb.evaluator import Evaluator
from spicedb_kubeapi_proxy_tpu.spicedb.types import (
    CheckRequest as RefCheckRequest, ObjectRef as RefObjectRef,
    RelationshipUpdate as RefUpdate, SubjectRef as RefSubjectRef,
    UpdateOp as RefOp, parse_relationship as ref_parse)
from spicedb_kubeapi_proxy_tpu.utils.features import GATES as REF_GATES
from spicedb_kubeapi_proxy_tpu_torch.parallel import distributed as dist
from spicedb_kubeapi_proxy_tpu_torch.parallel import sharding
from spicedb_kubeapi_proxy_tpu_torch.spicedb import endpoints as eps
from spicedb_kubeapi_proxy_tpu_torch.utils import features as port_features
from torch_dist_rank import drive_in_process, make_spec, spawn

RUN_TIMEOUT_S = 110


class TestDistributedGlue:
    """The reference's glue cases on the port (parallel/distributed.py)."""

    def test_partial_env_config_rejected(self, monkeypatch):
        monkeypatch.setattr(dist, "_runtime_initialized", lambda: False)
        monkeypatch.setenv("SPICEDB_TPU_COORDINATOR", "127.0.0.1:9999")
        monkeypatch.delenv("SPICEDB_TPU_NUM_PROCESSES", raising=False)
        monkeypatch.delenv("SPICEDB_TPU_PROCESS_ID", raising=False)
        with pytest.raises(ValueError, match="partial multi-host config"):
            dist.init_from_env()

    def test_idempotent_when_runtime_already_up(self, monkeypatch):
        monkeypatch.setattr(dist, "_runtime_initialized", lambda: True)
        monkeypatch.setattr(dist, "_init", lambda **k: pytest.fail(
            "the runtime was touched"))
        assert dist.init_from_env() is True

    def test_endpoint_param_triggers_strict_init(self, monkeypatch):
        calls = []
        monkeypatch.setattr(dist, "init_from_env",
                            lambda *a, **k: calls.append(k) or True)
        eps.create_endpoint("torch://?distributed=1&dispatch=direct"
                            "&device=cpu", None)
        assert calls == [{"strict": True}]
        calls.clear()
        eps.create_endpoint("torch://?distributed=auto&dispatch=direct"
                            "&device=cpu", None)
        assert calls == [{"strict": False}]

    def test_endpoint_param_off_and_invalid(self, monkeypatch):
        monkeypatch.setattr(
            dist, "init_from_env",
            lambda *a, **k: (_ for _ in ()).throw(AssertionError("called")))
        eps.create_endpoint("torch://?distributed=false&dispatch=direct"
                            "&device=cpu", None)
        with pytest.raises(eps.EndpointConfigError,
                           match="invalid distributed"):
            eps.create_endpoint("torch://?distributed=bogus&dispatch=direct"
                                "&device=cpu", None)

    def test_strict_init_failure_is_config_error(self, monkeypatch):
        def boom(*a, **k):
            raise RuntimeError("no coordinator")

        monkeypatch.setattr(dist, "init_from_env", boom)
        with pytest.raises(eps.EndpointConfigError,
                           match="initialization failed"):
            eps.create_endpoint("torch://?distributed=1&dispatch=direct"
                                "&device=cpu", None)


@pytest.mark.parametrize("value", ["1", "true", "yes", "auto", "0", "false",
                                   "no", "bogus", "2"])
def test_distributed_values_match_the_reference(monkeypatch, value):
    """Each value is accepted or refused by `torch://` as by `jax://`,
    with the strictness the reference passes."""
    from spicedb_kubeapi_proxy_tpu.parallel import distributed as ref_dist
    from spicedb_kubeapi_proxy_tpu.spicedb import endpoints as ref_eps
    seen = {"port": [], "ref": []}
    monkeypatch.setattr(dist, "init_from_env",
                        lambda *a, **k: seen["port"].append(k) or False)
    monkeypatch.setattr(ref_dist, "init_from_env",
                        lambda *a, **k: seen["ref"].append(k) or False)
    outcome = {}
    for side, make in (
            ("port", lambda: eps.create_endpoint(
                f"torch://?distributed={value}&dispatch=direct&device=cpu",
                None)),
            ("ref", lambda: ref_eps.create_endpoint(
                f"jax://?distributed={value}&dispatch=direct", None))):
        try:
            make()
            outcome[side] = "ok"
        except (eps.EndpointConfigError, ref_eps.EndpointConfigError) as e:
            outcome[side] = "invalid" if "invalid distributed" in str(e) \
                else str(e)
    assert outcome["port"] == outcome["ref"]
    assert seen["port"] == seen["ref"]


def test_no_cluster_strict_fails_auto_stays_standalone(monkeypatch):
    for k in ("SPICEDB_TPU_COORDINATOR", "SPICEDB_TPU_NUM_PROCESSES",
              "SPICEDB_TPU_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
              "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(eps.EndpointConfigError,
                       match="initialization failed"):
        eps.create_endpoint("torch://?distributed=1&device=cpu", None)
    ep = eps.create_endpoint("torch://?distributed=auto&mesh=auto"
                             "&dispatch=direct&device=cpu", None)
    assert ep.mesh is None and not dist.is_initialized()


def _spanning_mesh():
    """A mesh whose two shards lie on two ranks, as rank 0 sees it (no
    process group: nothing here runs a collective)."""
    return sharding.Mesh([["cpu", "cpu"]], ranks=[[0, 1]], rank=0, world=2)


@pytest.mark.parametrize("url,leopard,switches,match", [
    ("torch://?device=cpu", False, {}, "dispatch=direct"),
    ("torch://?device=cpu&dispatch=batched", False, {}, "dispatch=direct"),
    ("torch://?device=cpu&dispatch=direct&cache=1", False, {},
     "decision cache"),
    ("torch://?device=cpu&dispatch=direct", False, {"DECISION_CACHE": True},
     "decision cache"),
    ("torch://?device=cpu&dispatch=direct", None, {}, "Leopard"),
    ("torch://?device=cpu&dispatch=direct", True, {}, "Leopard"),
])
def test_mesh_across_processes_refuses_unordered_serving(
        monkeypatch, url, leopard, switches, match):
    """On a mesh across processes the batching dispatcher (also as the
    CROSS_REQUEST_BATCHING default), the decision cache (also as the
    DECISION_CACHE default) and the Leopard index (also as the
    LEOPARD_INDEX default) are configuration errors."""
    for name, value in switches.items():
        monkeypatch.setattr(port_features, name, value)
    kw = {} if leopard is None else {"leopard": leopard}
    with pytest.raises(eps.EndpointConfigError, match=match):
        eps.create_endpoint(url, None, mesh=_spanning_mesh(), **kw)


def test_process_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process group"):
        sharding.make_process_mesh(1, 2, device="cpu")


# -- the mesh across processes ------------------------------------------------

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


def _workload(name: str):
    """(schema text, relationships, rtype, permission, subjects, a write
    every rank applies)."""
    if name == "hub":
        rels = [f"group:big#member@user:u{i}" for i in range(120)]
        rels += [f"group:g{i}#member@group:g{i + 1}#member" for i in range(4)]
        rels += ["group:g4#member@group:big#member"]
        rels += [f"namespace:n{i}#viewer@group:g{i % 5}#member"
                 for i in range(40)]
        rels += [f"namespace:n{i}#creator@user:u{i}" for i in range(0, 40, 3)]
        rels += ["namespace:open#viewer@user:*"]
        subjects = [f"u{i}" for i in range(0, 130, 3)] + ["stranger"]
        write = [("touch", "group:g3#member@user:stranger"),
                 ("delete", "namespace:n3#creator@user:u3"),
                 ("touch", "namespace:fresh#viewer@user:u7")]
        return SCHEMA, rels, "namespace", "view", subjects, write
    if name == "caveated":
        w = ref_workloads.caveated_rbac(n_pods=300, n_users=200, n_groups=8)
        member = next(r for r in w.relationships if "#member@user:" in r)
        write = [("touch", member.split("@")[0] + "@user:" + w.subjects[0])]
    else:
        w = ref_workloads.multitenant_1m(n_tenants=6, n_users=400,
                                         n_groups=30, n_namespaces=20,
                                         n_pods=800, n_tuples=4_000)
        admin = next(r for r in w.relationships if "#admin@user:" in r)
        member = next(r for r in w.relationships
                      if r.endswith("#member@user:" + w.subjects[0]))
        # a subject loses a group and another becomes a tenant's admin
        write = [("delete", member),
                 ("touch", admin.split("@")[0] + "@user:" + w.subjects[2])]
    return (w.schema_text, list(w.relationships), w.resource_type,
            w.permission, list(w.subjects[:45]), write)


def _spec(name: str, mesh: str) -> dict:
    schema, rels, rtype, perm, subjects, write = _workload(name)
    return make_spec(schema, rels, rtype, perm, subjects, write, mesh)


def _single_process(spec: dict) -> dict:
    """The same sequence on `torch://?device=cpu&mesh=` in this process
    (`drive_in_process`), on `jax://?mesh=` and on the oracle; and the
    reference's ShardedEllKernel and ShardedKernel on the spec's query
    columns."""
    out = drive_in_process(spec)
    mesh = spec["mesh"]
    d, g = (int(v) for v in mesh.split("x"))
    jx = ref_create_endpoint(f"jax://?mesh={mesh}&dispatch=direct",
                             RefBootstrap(spec["schema"],
                                          "\n".join(spec["rels"])))
    oracle = Evaluator(jx.schema, jx.store)
    rtype, perm = spec["rtype"], spec["perm"]
    rsubs = [RefSubjectRef("user", u) for u in spec["subjects"]]
    rreqs = [RefCheckRequest(RefObjectRef(rtype, o), perm, rsubs[i])
             for o, i in spec["checks"]]
    tri = {0: "NO_PERMISSION", 1: "CONDITIONAL_PERMISSION",
           2: "HAS_PERMISSION"}
    for k, reads in enumerate(out["reads"]):
        if k:
            rops = {"touch": RefOp.TOUCH, "delete": RefOp.DELETE}
            asyncio.run(jx.write_relationships(
                [RefUpdate(rops[o], ref_parse(r))
                 for o, r in spec["writes"]]))
        ref_look = asyncio.run(jx.lookup_resources_batch(rtype, perm, rsubs))
        ref_chk = asyncio.run(jx.check_bulk_permissions(rreqs))
        reads.update(
            ref_lookups=[sorted(x) for x in ref_look],
            ref_checks=[c.permissionship.name for c in ref_chk],
            oracle_lookups=[sorted(oracle.lookup_resources(rtype, perm, s))
                            for s in rsubs],
            oracle_checks=[tri[oracle.check3(r.resource, perm, r.subject)]
                           for r in rreqs])

    prog = ref_compile(ref_sch.parse_schema(spec["schema"]),
                       [ref_parse(r) for r in spec["rels"]])
    ref_mesh = ref_sharding.make_mesh(jax.devices()[:d * g], data=d, graph=g)
    k = spec["kernel"]
    ref = ref_sharding.ShardedEllKernel(prog, ref_mesh)
    q = np.asarray(k["q"], np.int32)
    off, length = prog.slot_range(rtype, perm)
    tables = ref.snapshot_tables()
    words, tl = ref.lookup_packed_T_device(off, length, q, k["n_words"],
                                           *tables)
    chk, tc = ref.checks_device(q, k["n_words"], np.asarray(k["gi"], np.int32),
                                np.asarray(k["gc"], np.int32), *tables)
    out["ref_kernel"] = {"words": np.asarray(words).view(np.uint32).ravel()
                         .tolist(),
                         "checks": np.asarray(chk).view(np.uint32).tolist(),
                         "trace_l": np.asarray(tl).tolist(),
                         "trace_c": np.asarray(tc).tolist()}
    if "segment" in spec:
        sk = ref_sharding.ShardedKernel(prog, ref_mesh)
        src, dst = sk.device_edges()
        sq = np.asarray(spec["segment"]["q"], np.int32)
        out["ref_segment"] = {
            "lookup": np.asarray(sk.lookup(off, length, sq, src, dst))
            .tolist(),
            "checks": np.asarray(sk.checks(
                sq, np.asarray(spec["segment"]["gi"], np.int32),
                np.asarray(spec["segment"]["gc"], np.int32), src, dst))
            .tolist()}
    return out


@pytest.fixture(autouse=True)
def synchronous_rebuilds(monkeypatch):
    """The single-process endpoints rebuild synchronously, as the ranks
    do (a mesh across processes never rebuilds off the request path)."""
    monkeypatch.setattr(REF_GATES._gates["AsyncRebuild"], "value", False)
    monkeypatch.setattr(port_features, "ASYNC_REBUILD", False)


MESHES = [(2, "1x2"), (2, "1x4"), (4, "2x2")]
WORKLOADS = ["hub", "caveated", "multitenant"]


_RUNS: dict = {}


@pytest.fixture
def run_case(tmp_path_factory):
    """(rank outputs, single-process outputs) of a case, run once."""
    def go(n, mesh, name):
        key = (n, mesh, name)
        if key not in _RUNS:
            spec = _spec(name, mesh)
            tmp = tmp_path_factory.mktemp(f"r{n}_{mesh}_{name}")
            _RUNS[key] = (spawn(spec, n, tmp, timeout=RUN_TIMEOUT_S),
                          _single_process(spec))
        return _RUNS[key]
    return go


@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("n,mesh", MESHES)
def test_ranks_answer_as_one_process_the_reference_and_the_oracle(
        run_case, n, mesh, name):
    ranks, one = run_case(n, mesh, name)
    assert [r["rank"] for r in ranks] == list(range(n))
    for r in ranks:
        assert r["world"] == n
        for got, want in zip(r["reads"], one["reads"]):
            assert got["lookups"] == want["lookups"] == \
                want["ref_lookups"] == want["oracle_lookups"]
            assert got["checks"] == want["checks"] == want["ref_checks"] == \
                want["oracle_checks"]
            assert got["trace_l"] == want["trace_l"]
            assert got["trace_c"] == want["trace_c"]
        assert r["rebuilds"] == one["rebuilds"]
        if name == "caveated":
            assert r["planes"]
    # the write changed what was asked
    assert one["reads"][0]["lookups"] != one["reads"][1]["lookups"] or \
        one["reads"][0]["checks"] != one["reads"][1]["checks"]


@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("n,mesh", MESHES)
def test_ranks_kernel_words_checks_and_traces_match_the_reference(
        run_case, n, mesh, name):
    ranks, one = run_case(n, mesh, name)
    d, g = (int(v) for v in mesh.split("x"))
    for r in ranks:
        k, mine, want = r["kernel"], one["kernel"], one["ref_kernel"]
        assert k["local_shards"] == d * g // n
        assert mine["local_shards"] == d * g
        for key in ("trace_l", "trace_c", "words", "checks"):
            assert k[key] == mine[key] == want[key], key


@pytest.mark.parametrize("name", ["hub", "multitenant"])
@pytest.mark.parametrize("n,mesh", MESHES)
def test_ranks_segment_mesh_matches_the_reference(run_case, n, mesh, name):
    """ShardedKernel across ranks: each rank's edge blocks, the OR
    all-reduce over gathered partials, and the whole answer on every
    rank."""
    ranks, one = run_case(n, mesh, name)
    for r in ranks:
        for key in ("lookup", "checks"):
            assert r["segment"][key] == one["segment"][key] == \
                one["ref_segment"][key], key
        assert r["segment"]["trace"] == one["segment"]["trace"]
        assert r["collectives"]["or_allreduce"]["xrank_calls"] > 0


@pytest.mark.parametrize("n,mesh", MESHES)
def test_ranks_exchange_over_torch_distributed(run_case, n, mesh):
    """Every sweep's deltas are one all-reduce; blocks on other ranks
    arrive over `torch.distributed`, and a rank holding two replicas of
    a data shard copies what came in into the second."""
    ranks, _ = run_case(n, mesh, "hub")
    d, g = (int(v) for v in mesh.split("x"))
    per_rank = d * g // n
    for r in ranks:
        c = r["collectives"]
        red = c["reduce_sweep_deltas"]
        assert red["xrank_calls"] == red["calls"] > 0
        ag = c["all_gather_rows"]
        assert ag["xrank_calls"] > 0 and ag["xrank_bytes"] > 0
        if per_rank > 1:
            assert ag["copies"] > 0
        assert c["sum_across"]["xrank_calls"] > 0
        assert not r["launches"]        # the CPU runs the twins
        assert f"rank {r['rank']} of {n}" in r["mesh"]


@pytest.mark.parametrize("n,mesh", MESHES)
def test_ranks_refuse_what_would_reorder_their_collectives(run_case, n,
                                                           mesh):
    """`torch://?distributed=1&mesh=...` without `dispatch=direct` (the
    batching dispatcher is the default), with `cache=1`, or with the
    Leopard index is refused on every rank, before any request."""
    ranks, _ = run_case(n, mesh, "hub")
    for r in ranks:
        refused = r["refused"]
        assert "Leopard" in refused["leopard"]
        assert "dispatch=direct" in refused["dispatch"]
        assert "decision cache" in refused["cache"]
