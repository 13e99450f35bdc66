"""The torch port's mesh path held against the JAX reference's sharded
kernels, bit for bit.

The reference runs `parallel/sharding.py`'s ShardedEllKernel and
ShardedKernel under `shard_map` on the conftest's eight virtual CPU
devices; the port runs its own (`spicedb_kubeapi_proxy_tpu_torch.
parallel.sharding`) with every shard co-located on the CPU, i.e. the
CUDA kernels' plain twins and in-process collectives.  On the same
GraphProgram and tables, with the same seeded queries, the port must give
the reference's final per-shard state (the reference's replicated state
sliced by data shard, its trailing plane axis laid out as the port's
halves), sweep trace (KernelIntrospect on), checks ({0, 2}, or {0, 1, 2}
with planes) and lookup words, and equal row-sharded tables after the
sharded flush.  Tolerance is zero everywhere: the data are bitplanes and
integer tables.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from spicedb_kubeapi_proxy_tpu.models import workloads as ref_workloads
from spicedb_kubeapi_proxy_tpu.ops import ell as ref_ell
from spicedb_kubeapi_proxy_tpu.ops.graph_compile import (SELF_SLOT,
                                                         compile_graph)
from spicedb_kubeapi_proxy_tpu.parallel import sharding as ref_sharding
from spicedb_kubeapi_proxy_tpu.spicedb import schema as ref_sch
from spicedb_kubeapi_proxy_tpu.spicedb.types import parse_relationship
from spicedb_kubeapi_proxy_tpu_torch import convert
from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
from spicedb_kubeapi_proxy_tpu_torch.ops.ell import EllTables
from spicedb_kubeapi_proxy_tpu_torch.parallel import collectives
from spicedb_kubeapi_proxy_tpu_torch.parallel import sharding as port_sharding

WILDCARD_SCHEMA = """
definition user {}
definition bot {}
definition doc {
  relation viewer: user | user:* | bot
  relation editor: user
  relation banned: user
  permission view = viewer + editor - banned
}
"""

HUB_SCHEMA = """
definition user {}
definition group {
  relation member: user | group#member
}
definition doc {
  relation viewer: group#member | user
  permission view = viewer
}
"""


def _scenario(name):
    """(reference GraphProgram, lookup (type, permission))."""
    if name == "graft":
        prog, _, _ = graft._build_program()
        return prog, ("pod", "view")
    if name == "wildcard":
        schema_text = WILDCARD_SCHEMA
        rels = ["doc:d1#viewer@user:*", "doc:d2#editor@user:eve",
                "doc:d3#viewer@user:frank", "doc:d4#viewer@bot:b1",
                "doc:d1#banned@user:u3"]
        rels += [f"doc:x{i}#editor@user:u{i % 7}" for i in range(40)]
        rtype = ("doc", "view")
    elif name == "hub_groups":
        # a 300-member group and a chain of nested groups: OR-trees two
        # levels deep (tree_depth > 0, several aux passes)
        schema_text = HUB_SCHEMA
        rels = [f"group:big#member@user:u{i}" for i in range(300)]
        rels += [f"group:g{i}#member@group:g{i + 1}#member" for i in range(6)]
        rels += ["group:g6#member@group:big#member"]
        rels += [f"group:g{i}#member@user:u{300 + i}" for i in range(7)]
        rels += [f"doc:d{i}#viewer@group:g{i % 7}#member" for i in range(30)]
        rels += [f"doc:d{i}#viewer@user:u{i}" for i in range(0, 30, 4)]
        rtype = ("doc", "view")
    else:
        if name == "nested_groups":
            w = ref_workloads.nested_groups(n_pods=300, n_users=120,
                                            n_groups=30, n_teams=6,
                                            n_namespaces=12)
        elif name == "rbac_deny":
            w = ref_workloads.rbac_deny(n_pods=300, n_users=800, n_groups=12)
        elif name == "caveated_rbac":
            w = ref_workloads.caveated_rbac(n_pods=300, n_users=800,
                                            n_groups=12)
        elif name == "multitenant":
            w = ref_workloads.multitenant_1m(n_tenants=10, n_users=2_000,
                                             n_groups=100, n_namespaces=50,
                                             n_pods=5_000, n_tuples=20_000)
        else:
            raise KeyError(name)
        schema_text, rels = w.schema_text, w.relationships
        rtype = (w.resource_type, w.permission)
    prog = compile_graph(ref_sch.parse_schema(schema_text),
                         [parse_relationship(r) for r in rels])
    return prog, rtype


_CACHE: dict = {}


def _program(name):
    if name not in _CACHE:
        _CACHE[name] = _scenario(name)
    return _CACHE[name]


def _meshes(data, graph):
    ref = ref_sharding.make_mesh(jax.devices()[:data * graph], data=data,
                                 graph=graph)
    port = port_sharding.make_mesh(["cpu"] * (data * graph), data=data,
                                   graph=graph)
    return ref, port


def _kernels(prog, data, graph):
    """The reference's and the port's ShardedEllKernel on equal tables."""
    ref_mesh, port_mesh = _meshes(data, graph)
    t = ref_ell.build_tables(prog)
    port_t = EllTables(idx_main=t.idx_main.copy(), idx_aux=t.idx_aux.copy(),
                       tree_depth=t.tree_depth, spare_rows=t.spare_rows)
    ref = ref_sharding.ShardedEllKernel(prog, ref_mesh, tables=t)
    port_prog = convert.program_from_reference(prog)
    port = port_sharding.ShardedEllKernel(port_prog, port_mesh,
                                          tables=port_t)
    return ref, port, port_t


def _queries(prog, kern, lanes, seed):
    """Seeded query columns (subject self rows first, then any state row)
    padded to the data-divisible word bucket, and a gather list over the
    whole state that covers every lane."""
    rng = np.random.default_rng(seed)
    w = kern.padded_batch_words(lanes)
    q = np.full(w * 32, prog.dead_index, np.int32)
    subj = [t for (t, s) in prog.slot_offsets if s == SELF_SLOT
            and prog.num_objects.get(t)]
    lo = prog.slot_offsets[(subj[0], SELF_SLOT)]
    n_self = min(lanes // 2, prog.num_objects[subj[0]])
    q[:n_self] = lo + rng.choice(prog.num_objects[subj[0]], n_self,
                                 replace=False)
    q[n_self:lanes] = rng.integers(0, prog.dead_index, lanes - n_self)
    g = 4 * lanes
    gi = rng.integers(0, prog.state_size, g).astype(np.int32)
    gc = rng.integers(0, lanes, g).astype(np.int32)
    gc[:lanes] = np.arange(lanes)
    return w, q, gi, gc


def _ref_shard_state(ref_state, d, wl, planes):
    """Data shard d's words of the reference's replicated state, in the
    port's layout (uint32; with planes the definite words, then maybe)."""
    s = np.asarray(ref_state)
    if planes:
        return np.concatenate([s[:, d * wl:(d + 1) * wl, 0],
                               s[:, d * wl:(d + 1) * wl, 1]], axis=1)
    return s[:, d * wl:(d + 1) * wl]


def _assert_states(ref, port, w, port_x):
    d_n, g_n = port.mesh.shape["data"], port.mesh.shape["graph"]
    wl = w // d_n
    ref_state = ref._arenas[w]
    for d in range(d_n):
        want = _ref_shard_state(ref_state, d, wl, port.planes)
        for g in range(g_n):
            got = port_x[d][g].numpy().view(np.uint32)
            assert np.array_equal(got, want), (d, g)
    # co-located replicas never alias one buffer
    ptrs = {t.data_ptr() for row in port_x for t in row}
    assert len(ptrs) == d_n * g_n


CASES = [
    # (scenario, data, graph, lanes): every scenario at two or more
    # meshes, every mesh at two or more scenarios, every lane count
    # throughout
    ("graft", 1, 1, 8), ("graft", 2, 4, 33),
    ("wildcard", 1, 2, 33), ("wildcard", 2, 2, 256),
    ("hub_groups", 2, 1, 8), ("hub_groups", 1, 8, 256),
    ("nested_groups", 2, 2, 33), ("nested_groups", 1, 8, 8),
    ("rbac_deny", 2, 1, 256), ("rbac_deny", 2, 4, 8),
    ("caveated_rbac", 1, 1, 33), ("caveated_rbac", 2, 4, 256),
    ("caveated_rbac", 1, 2, 8),
    ("multitenant", 1, 2, 256), ("multitenant", 2, 4, 33),
]


@pytest.mark.parametrize("name,data,graph,lanes", CASES)
def test_sharded_ell_kernel_matches_reference(name, data, graph, lanes):
    prog, (rtype, perm) = _program(name)
    ref, port, _ = _kernels(prog, data, graph)
    assert (port.n_pad, port.a_pad, port.aux_passes, port.num_iters,
            port.planes) == (ref.n_pad, ref.a_pad, ref.aux_passes,
                             ref.num_iters, ref.planes)
    if name == "hub_groups":
        assert port.aux_passes >= 3
    if name == "caveated_rbac":
        assert port.planes
    w, q, gi, gc = _queries(prog, ref, lanes, seed=lanes + data * 10 + graph)
    tables = ref.snapshot_tables()
    ref_out, ref_tel = ref.checks_device(q, w, gi, gc, *tables)
    assert ref_tel is not None
    port_tables = port.snapshot_tables()

    kernels.reset_launches()
    collectives.reset_collectives()
    arenas = port.take_arena(w)
    x, tel = port.evaluate(q, w, port_tables, arenas)
    assert np.array_equal(tel, np.asarray(ref_tel))
    _assert_states(ref, port, w, x)
    port.put_arena(w, arenas)
    out, tel_c = port.checks_device(q, w, gi, gc, *port_tables)
    assert np.array_equal(tel_c, np.asarray(ref_tel))
    assert np.array_equal(out.numpy().view(np.uint32), np.asarray(ref_out))
    if port.planes:
        assert set(np.unique(out.numpy())) <= {0, 1, 2}
    off, length = prog.slot_range(rtype, perm)
    ref_words, ref_tel_l = ref.lookup_packed_T_device(off, length, q, w,
                                                      *tables)
    words, tel_l = port.lookup_packed_T_device(off, length, q, w,
                                               *port_tables)
    assert np.array_equal(tel_l, np.asarray(ref_tel_l))
    assert np.array_equal(words.numpy().view(np.uint32),
                          np.asarray(ref_words))
    # on the CPU only the twins run: nothing counts as a kernel launch
    assert not any(kernels.LAUNCHES.values())
    if graph > 1:
        assert collectives.COLLECTIVES["all_gather_rows"]["bytes"] > 0
    if lanes > 32 and data == 1:
        # lane 31 is a real query column: bit 31 of word 0 is in play
        assert bool((x[0][0][:, 0] < 0).any())


@pytest.mark.parametrize("data,graph", [(1, 2), (2, 4)])
def test_host_entries_and_comm_model_match_reference(data, graph):
    """The blocking entries (lookup bitmap, checks) and the traffic model
    equal the reference's; the bytes one sweep's all_gathers move equal
    the model's on the definite path."""
    prog, (rtype, perm) = _program("multitenant")
    ref, port, _ = _kernels(prog, data, graph)
    rng = np.random.default_rng(data * graph)
    q = rng.integers(0, prog.dead_index, 40).astype(np.int32)
    off, length = prog.slot_range(rtype, perm)
    assert np.array_equal(port.lookup(off, length, q),
                          ref.lookup(off, length, q))
    assert np.array_equal(port.lookup_packed(off, length, q),
                          ref.lookup_packed(off, length, q))
    gi = rng.integers(0, prog.state_size, 500).astype(np.int32)
    gc = rng.integers(0, 40, 500).astype(np.int32)
    assert np.array_equal(port.checks(q, gi, gc), ref.checks(q, gi, gc))
    for lanes in (1, 33, 256, 1000):
        assert port.padded_batch_words(lanes) == \
            ref.padded_batch_words(lanes)
    cm = port_sharding.comm_model(prog.state_size, port.a_pad, data, graph,
                                  256, aux_passes=port.aux_passes)
    assert cm == ref_sharding.comm_model(prog.state_size, port.a_pad, data,
                                         graph, 256,
                                         aux_passes=port.aux_passes)
    assert port_sharding.comm_model(10, 3, 2, 4, 33, planes=True) == \
        ref_sharding.comm_model(10, 3, 2, 4, 33, planes=True)
    w = port.padded_batch_words(256)
    qq = np.full(32 * w, prog.dead_index, np.int32)
    qq[:256] = rng.integers(0, prog.dead_index, 256)
    collectives.reset_collectives()
    arenas = port.take_arena(w)
    _, tel = port.evaluate(qq, w, port.snapshot_tables(), arenas)
    per_sweep = collectives.COLLECTIVES["all_gather_rows"]["bytes"] // tel[0]
    assert per_sweep // (data * graph) == \
        cm["all_gather_recv_bytes_per_device_per_iter"]


@pytest.mark.parametrize("name,data,graph", [
    ("multitenant", 2, 4), ("hub_groups", 1, 8), ("caveated_rbac", 2, 4),
    ("wildcard", 2, 2)])
def test_sharded_flush_leaves_equal_tables(name, data, graph):
    """update_{main,aux,cav}_rows on both: the row-sharded tables stay
    equal (every block of every data replica), untouched blocks keep
    their tensors, and a batch after the flush answers alike."""
    prog, (rtype, perm) = _program(name)
    ref, port, port_t = _kernels(prog, data, graph)
    snap = port.snapshot_tables()
    rng = np.random.default_rng(7)
    n = prog.state_size
    rows = np.sort(rng.choice(port_t.idx_main.shape[0], 5, replace=False))
    vals = rng.integers(0, n - 1, (5, port_t.idx_main.shape[1])).astype(
        np.int32)
    # point one row at an aux node: the value is remapped past n_pad
    if port_t.idx_aux.shape[0]:
        vals[0, 0] = n + int(rng.integers(0, port_t.idx_aux.shape[0]))
    for k in (ref, port):
        k.update_main_rows(rows.astype(np.int32), vals)
    updated = {"idx_main": set((rows // port.block_main).tolist())}
    if port_t.idx_aux.shape[0]:
        arows = np.unique(rng.integers(0, port_t.idx_aux.shape[0], 3)) \
            .astype(np.int32)
        avals = rng.integers(0, n - 1, (len(arows), port_t.idx_aux.shape[1])
                             ).astype(np.int32)
        for k in (ref, port):
            k.update_aux_rows(arows, avals)
        updated["idx_aux"] = set((arows // port.block_aux).tolist())
    if port.planes:
        host_cav = port.host_cav_compile
        crows = np.unique(np.concatenate([
            rng.integers(0, n, 3),
            rng.integers(n, host_cav.shape[0], 2)])).astype(np.int32)
        cvals = rng.integers(0, n - 1, (len(crows), host_cav.shape[1])
                             ).astype(np.int32)
        for k in (ref, port):
            k.update_cav_rows(crows, cvals)
        updated["idx_cav"] = set(
            (port.remap_values(crows) // port.block_cav).tolist())
    names = ("idx_main", "idx_aux") + (("idx_cav",) if port.planes else ())
    for i, tname in enumerate(names):
        want = np.asarray(getattr(ref, tname))
        blocks = getattr(port, tname)
        for d in range(data):
            got = torch.cat(blocks[d]).numpy()
            assert np.array_equal(got, want), (tname, d)
        touched = {g for g in range(graph)
                   if blocks[0][g] is not snap[i][0][g]}
        # exactly the blocks holding an updated row got new tensors
        assert touched == updated.get(tname, set()), tname
    # copy-on-write: the captured snapshot still holds the old tables
    assert snap[0] is not port.idx_main
    w, q, gi, gc = _queries(prog, ref, 33, seed=3)
    ref_out, ref_tel = ref.checks_device(q, w, gi, gc,
                                         *ref.snapshot_tables())
    out, tel = port.checks_device(q, w, gi, gc, *port.snapshot_tables())
    assert np.array_equal(tel, np.asarray(ref_tel))
    assert np.array_equal(out.numpy().view(np.uint32), np.asarray(ref_out))


@pytest.mark.parametrize("data,graph", [(1, 8), (2, 4), (8, 1), (2, 2)])
def test_sharded_segment_kernel_matches_reference(data, graph):
    """ShardedKernel (the edge-sharded segment sweep with its OR
    all-reduce) answers as the reference's, lookups and checks."""
    prog, (rtype, perm) = _program("graft")
    ref_mesh, port_mesh = _meshes(data, graph)
    ref = ref_sharding.ShardedKernel(prog, ref_mesh)
    port = port_sharding.ShardedKernel(convert.program_from_reference(prog),
                                       port_mesh)
    r_src, r_dst = ref.device_edges()
    p_src, p_dst = port.device_edges()
    assert np.array_equal(torch.cat(p_src[0]).numpy(), np.asarray(r_src))
    assert np.array_equal(torch.cat(p_dst[-1]).numpy(), np.asarray(r_dst))
    rng = np.random.default_rng(data + graph)
    q = rng.integers(0, prog.dead_index, 37).astype(np.int32)
    off, length = prog.slot_range(rtype, perm)
    collectives.reset_collectives()
    assert np.array_equal(port.lookup(off, length, q, p_src, p_dst),
                          np.asarray(ref.lookup(off, length, q, r_src,
                                                r_dst)))
    if graph > 1:
        assert collectives.COLLECTIVES["or_allreduce"]["calls"] > 0
    gi = rng.integers(0, prog.state_size, 300).astype(np.int32)
    gc = rng.integers(0, 37, 300).astype(np.int32)
    assert np.array_equal(port.checks(q, gi, gc, p_src, p_dst),
                          np.asarray(ref.checks(q, gi, gc, r_src, r_dst)))


def test_or_allreduce_and_all_gather_rows():
    """The collectives on co-located replicas: every replica ends at the
    OR of all partials, and a tiled all_gather gives every replica every
    block (only the given words when `cols` is set)."""
    rng = np.random.default_rng(1)
    parts = [torch.from_numpy(rng.integers(-2**31, 2**31, (9, 3),
                                           dtype=np.int64).astype(np.int32))
             for _ in range(4)]
    want = parts[0] | parts[1] | parts[2] | parts[3]
    collectives.reset_collectives()
    collectives.or_allreduce(parts)
    assert all(torch.equal(p, want) for p in parts)
    assert collectives.COLLECTIVES["or_allreduce"]["bytes"] == 6 * 9 * 3 * 4
    reps = [torch.full((8, 4), g, dtype=torch.int32) for g in range(4)]
    collectives.all_gather_rows(reps, 0, 8, cols=(2, 4))
    for r in reps:
        assert torch.equal(r[:, 2:].flatten().unique(),
                           torch.arange(4, dtype=torch.int32))
        assert torch.equal(r[::2, 2], torch.arange(4, dtype=torch.int32))
    assert [int(r[0, 0]) for r in reps] == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        collectives.all_gather_rows(reps, 0, 7)


@pytest.mark.parametrize("n", list(range(1, 9)))
def test_make_mesh_factors_match_reference(n):
    ref = ref_sharding.make_mesh(jax.devices()[:n])
    port = port_sharding.make_mesh(["cpu"] * n)
    assert port.shape == dict(ref.shape) and port.size == n
    with pytest.raises(ValueError):
        port_sharding.make_mesh(["cpu"] * n, data=n + 1, graph=1)


def test_mesh_places_shards_row_major():
    mesh = port_sharding.make_mesh(["cpu", "meta", "cpu", "meta"], data=2,
                                   graph=2)
    assert [str(d) for row in mesh.devices for d in row] == \
        ["cpu", "meta", "cpu", "meta"]
    with pytest.raises(ValueError):
        port_sharding.make_mesh([])
    with pytest.raises(ValueError):
        port_sharding.Mesh([["cpu"], ["cpu", "cpu"]])
