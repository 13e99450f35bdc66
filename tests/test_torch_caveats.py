"""The torch port's caveat path held against the JAX reference, bit for bit.

Caveats on the device: CEL decides a caveated tuple whose stored context
is complete; an undecidable one becomes an edge of the MAYBE plane.  The
port's copy of the CEL evaluator must answer as the reference's; its
`build_cav_tables` must produce the reference's caveat table; its
tri-state kernel cache (`EllKernelCache(planes=True)`, here on the CPU,
i.e. the kernels' plain-torch twins) must leave the reference's final [NT, 2W] state,
tri-state checks, definite lookup words, sweep trace and trip count; the
stage-free Jacobi step on the definite path must match the reference's
(`SPICEDB_TPU_STAGED=0`); `torch://?device=cpu` must answer as `jax://`
and the host oracle, CONDITIONAL included; and caveated writes must leave
both endpoints with equal host tables, caveat tables and rebuild counts.

Inputs are seeded (numpy or `random`); tolerance is zero everywhere: the
data are booleans, tri-state values, ids and bitplanes.  Both packages
run with their off-loop rebuilds off (the reference's AsyncRebuild gate,
the port's ASYNC_REBUILD switch), so a delta they cannot absorb rebuilds
synchronously and rebuild counts compare.
"""

import ast
import asyncio
import random
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spicedb_kubeapi_proxy_tpu.models import workloads as ref_workloads
from spicedb_kubeapi_proxy_tpu.ops import ell as ref_ell
from spicedb_kubeapi_proxy_tpu.ops.graph_compile import SELF_SLOT, compile_graph
from spicedb_kubeapi_proxy_tpu.ops.jax_endpoint import JaxEndpoint
from spicedb_kubeapi_proxy_tpu.rules import cel as ref_cel
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
from spicedb_kubeapi_proxy_tpu_torch import convert
from spicedb_kubeapi_proxy_tpu_torch.ops import ell as port_ell
from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference as twins
from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import TorchEndpoint
from spicedb_kubeapi_proxy_tpu_torch.rules import cel as port_cel
from spicedb_kubeapi_proxy_tpu_torch.spicedb import schema as port_sch
from spicedb_kubeapi_proxy_tpu_torch.spicedb.store import TupleStore as PortStore
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
    CheckRequest,
    ObjectRef,
    Permissionship,
    RelationshipUpdate,
    SubjectRef,
    UpdateOp,
    parse_relationship)
from spicedb_kubeapi_proxy_tpu_torch.utils import features as port_features

# the reference's caveat device schema (tests/test_caveat_device.py):
# flag/limit caveats, intersection, exclusion, arrows, nested groups
SCHEMA = """
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
DOC_PERMS = ["base", "gated", "view", "strict"]

TRI = {Permissionship.NO_PERMISSION: 0,
       Permissionship.CONDITIONAL_PERMISSION: 1,
       Permissionship.HAS_PERMISSION: 2}
REF_TRI = {RefPermissionship.NO_PERMISSION: 0,
           RefPermissionship.CONDITIONAL_PERMISSION: 1,
           RefPermissionship.HAS_PERMISSION: 2}


@pytest.fixture(autouse=True)
def sync_reference_rebuilds(monkeypatch):
    """Both packages rebuild synchronously: the reference's AsyncRebuild
    gate and the port's ASYNC_REBUILD switch are off."""
    monkeypatch.setattr(GATES._gates["AsyncRebuild"], "value", False)
    monkeypatch.setattr(port_features, "ASYNC_REBUILD", False)


def run(coro):
    return asyncio.run(coro)


def _random_rels(seed: int) -> list:
    """The reference's randomized caveat graph (test_caveat_device.py
    TestRandomizedDifferential.test_random_graphs): every decidability
    state of both caveats through every operator."""
    rng = random.Random(seed)
    users = [f"u{i}" for i in range(6)]
    docs = [f"d{i}" for i in range(8)]
    folders = [f"f{i}" for i in range(3)]
    groups = [f"g{i}" for i in range(3)]
    suffixes = ["", UNDECIDED, TRUE_CTX, FALSE_CTX,
                '[caveat:limit:{"n": 1}]', '[caveat:limit:{"n": 1, "max": 5}]']
    rels = set()
    for _ in range(60):
        kind = rng.randrange(5)
        u = rng.choice(users)
        if kind == 0:
            suf = rng.choice(suffixes)
            if "limit" in suf:
                rels.add(f"doc:{rng.choice(docs)}#reader@user:{u}{suf}")
            else:
                rel = rng.choice(["reader", "blocked", "required"])
                rels.add(f"doc:{rng.choice(docs)}#{rel}@user:{u}{suf}")
        elif kind == 1:
            rels.add(f"doc:{rng.choice(docs)}#folder@folder:"
                     f"{rng.choice(folders)}")
        elif kind == 2:
            suf = rng.choice(["", UNDECIDED])
            rels.add(f"folder:{rng.choice(folders)}#viewer@user:{u}{suf}")
        elif kind == 3:
            suf = rng.choice(["", UNDECIDED])
            rels.add(f"group:{rng.choice(groups)}#member@user:{u}{suf}")
        else:
            rels.add(f"folder:{rng.choice(folders)}#viewer@group:"
                     f"{rng.choice(groups)}#member")
    rels.add("group:g1#member@group:g0#member")
    return sorted(rels)


def _scenario(name: str) -> tuple:
    """(schema text, relationships, resource type, permission)."""
    if name == "caveat_schema":
        return SCHEMA, _random_rels(2), "doc", "view"
    if name == "caveated_rbac":
        w = ref_workloads.caveated_rbac(n_pods=300, n_users=800, n_groups=12)
        return w.schema_text, w.relationships, w.resource_type, w.permission
    if name == "rbac_deny":
        w = ref_workloads.rbac_deny(n_pods=300, n_users=800, n_groups=12)
        return w.schema_text, w.relationships, w.resource_type, w.permission
    if name == "nested_groups":
        w = ref_workloads.nested_groups(n_pods=300, n_users=120, n_groups=30,
                                        n_teams=6, n_namespaces=12)
        return w.schema_text, w.relationships, w.resource_type, w.permission
    if name == "wildcard":
        schema = ("definition user {}\ndefinition doc {\n"
                  "  relation viewer: user | user:*\n"
                  "  relation banned: user\n"
                  "  permission view = viewer - banned\n}")
        rels = ["doc:d1#viewer@user:*", "doc:d1#banned@user:u3"]
        rels += [f"doc:x{i}#viewer@user:u{i % 7}" for i in range(40)]
        rels += [f"doc:x{i}#banned@user:u{i % 5}" for i in range(0, 40, 3)]
        return schema, rels, "doc", "view"
    raise KeyError(name)


def _compile(name: str):
    schema_text, rels, rtype, perm = _scenario(name)
    prog = compile_graph(ref_sch.parse_schema(schema_text),
                         [ref_parse(r) for r in rels])
    return prog, rtype, perm


def _queries(prog, rtype, perm, lanes, seed):
    """Seeded query columns — subject self rows first (the rows a real
    batch seeds), then any state row — padded with the dead index to the
    word bucket, and a gather list over the permission's rows that covers
    every lane, plus random rows."""
    rng = np.random.default_rng(seed)
    w = ref_ell.batch_words(lanes)
    q = np.full(w * 32, prog.dead_index, np.int32)
    lo = prog.slot_offsets[("user", SELF_SLOT)]
    n_users = prog.num_objects["user"]
    n_self = min(lanes, n_users)
    q[:n_self] = lo + rng.choice(n_users, n_self, replace=False)
    q[n_self:lanes] = rng.integers(0, prog.dead_index, lanes - n_self)
    off, length = prog.slot_range(rtype, perm)
    g = 8 * lanes
    gi = np.concatenate([off + rng.integers(0, length, g),
                         rng.integers(0, prog.state_size, g)]).astype(np.int32)
    gc = rng.integers(0, lanes, 2 * g).astype(np.int32)
    gc[:lanes] = np.arange(lanes)
    return w, q, gi, gc


def _reference_plane_cache(prog):
    """The reference _EllGraph's tri-state tables and kernel cache
    (jax_endpoint.py:787-830): caveat OR-tree rows appended to the shared
    aux table as dead rows."""
    t = ref_ell.build_tables(prog)
    ct = ref_ell.build_cav_tables(prog, t.idx_aux.shape[0])
    aux = t.idx_aux
    if ct.n_aux_cav:
        aux = np.vstack([aux, np.full((ct.n_aux_cav, ref_ell.K_AUX),
                                      prog.dead_index, np.int32)])
    depth = max(t.tree_depth, ct.tree_depth)
    kc = ref_ell.EllKernelCache(prog, n_aux_rows=aux.shape[0],
                                tree_depth=depth, planes=True,
                                shared_tree_depth=t.tree_depth,
                                host_main=t.idx_main)
    return t.idx_main, aux, ct, depth, t.tree_depth, kc


# -- CEL ---------------------------------------------------------------------

def _cel_cases() -> list:
    """Every expression the reference's CEL tests compile (with its
    activation when the test gives a literal one)."""
    tree = ast.parse((Path(__file__).with_name("test_cel.py")).read_text())
    cases = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)
        src = node.args[0]
        if name not in ("run", "compile_condition") or not (
                isinstance(src, ast.Constant) and isinstance(src.value, str)):
            continue
        act = ast.literal_eval(node.args[1]) if len(node.args) > 1 else None
        cases.append((src.value, act))
    return sorted(set((s, repr(a)) for s, a in cases))


CEL_ACT = {
    "request": {"verb": "get", "resource": "pods", "apiGroup": "",
                "apiVersion": "v1", "name": "pod1", "namespace": "default"},
    "user": {"name": "admin", "uid": "u1",
             "groups": ["system:masters", "dev"], "extra": {}},
    "name": "pod1",
    "resourceNamespace": "default",
    "namespacedName": "default/pod1",
    "headers": {"Accept": ["application/json"]},
}


def _cel_outcome(mod, src, act):
    try:
        return ("ok", mod.compile_condition(src).eval(act))
    except Exception as e:  # compile and evaluation errors alike
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("src,act", _cel_cases())
def test_cel_matches_reference(src, act):
    act = eval(act) if act != "None" else CEL_ACT
    assert _cel_outcome(port_cel, src, act) == _cel_outcome(ref_cel, src, act)


@pytest.mark.parametrize("caveat,ctx", [
    ("flag", {"on": True}), ("flag", {"on": False}), ("flag", {}),
    ("limit", {"n": 1, "max": 5}), ("limit", {"n": 9, "max": 5}),
    ("limit", {"n": 1}), ("limit", {"n": "x", "max": 5}),
])
def test_caveat_evaluate_matches_reference(caveat, ctx):
    ref = ref_sch.parse_schema(SCHEMA).caveats[caveat]
    port = port_sch.parse_schema(SCHEMA).caveats[caveat]
    outcomes = []
    for c in (ref, port):
        try:
            outcomes.append(("ok", c.evaluate(dict(ctx))))
        except Exception as e:
            outcomes.append((type(e).__name__, str(e)))
    assert outcomes[0] == outcomes[1]


# -- host tables -------------------------------------------------------------

@pytest.mark.parametrize("name", ["caveat_schema", "caveated_rbac"])
def test_cav_tables_match_reference(name):
    prog, _, _ = _compile(name)
    assert len(prog.cav_src) and prog.caveats_device_ok
    port_prog = convert.program_from_reference(prog)
    t = ref_ell.build_tables(prog)
    for n_aux in (0, t.idx_aux.shape[0]):
        rc = ref_ell.build_cav_tables(prog, n_aux)
        pc = port_ell.build_cav_tables(port_prog, n_aux)
        assert np.array_equal(rc.idx_cav, pc.idx_cav)
        assert (rc.n_aux_cav, rc.tree_depth) == (pc.n_aux_cav, pc.tree_depth)
    assert port_ell.K_CAV == ref_ell.K_CAV


# -- the tri-state kernel cache ----------------------------------------------

@pytest.mark.parametrize("name,lanes", [
    ("caveat_schema", 8), ("caveat_schema", 33), ("caveat_schema", 256),
    ("caveated_rbac", 8), ("caveated_rbac", 33), ("caveated_rbac", 256)])
def test_plane_cache_matches_reference(name, lanes):
    prog, rtype, perm = _compile(name)
    main, aux, ct, depth, shared, kc = _reference_plane_cache(prog)
    w, q, gi, gc = _queries(prog, rtype, perm, lanes, seed=lanes)
    jm, ja, jc = jnp.asarray(main), jnp.asarray(aux), jnp.asarray(ct.idx_cav)
    ref_out, ref_tel = kc.checks_device(q, w, gi, gc, jm, ja, jc)
    ref_state = np.asarray(kc._arenas[w])
    off, length = prog.slot_range(rtype, perm)
    ref_words, ref_tel_l = kc.lookup_packed_T_device(off, length, q, w,
                                                     jm, ja, jc)
    ref_iters = kc.iterations(q, w, jm, ja, jc)
    assert ref_state.shape[1] == 2 * w

    port = port_ell.EllKernelCache(
        convert.program_from_reference(prog), n_aux_rows=aux.shape[0],
        tree_depth=depth, device="cpu", shared_tree_depth=shared,
        host_main=main, planes=True)
    assert port.stages == () and port.aux_passes == kc.aux_passes
    assert port.num_iters == kc.num_iters
    dm, da, dc = (torch.from_numpy(a.copy()) for a in (main, aux, ct.idx_cav))
    kernels.reset_launches()
    state, tel = port.evaluate(torch.from_numpy(q), w, dm, da,
                               port.take_arena(w), dc)
    out, tel_c = port.checks_device(q, w, gi, gc, dm, da, dc)
    words, tel_l = port.lookup_packed_T_device(off, length, q, w, dm, da, dc)
    assert not any(kernels.LAUNCHES.values())   # CPU: twins only

    assert np.array_equal(state.numpy().view(np.uint32), ref_state)
    assert np.array_equal(tel, np.asarray(ref_tel))
    assert np.array_equal(tel_c, np.asarray(ref_tel))
    assert np.array_equal(tel_l, np.asarray(ref_tel_l))
    assert port.iterations(q, w, dm, da, dc) == ref_iters == int(tel[0])
    assert np.array_equal(out.numpy().view(np.uint32), np.asarray(ref_out))
    assert np.array_equal(words.numpy().view(np.uint32),
                          np.asarray(ref_words))
    if lanes > 8:
        # the gathers met every tri-state value
        assert {0, 1, 2} <= set(np.asarray(ref_out).tolist())
    if lanes > 32:
        # bit 31 of the first word of each plane is live: int32 words
        # with the sign bit set took part in the equalities above
        for word in (0, w):
            assert ((ref_state[:, word] >> np.uint32(31)) & 1).any()
    if lanes == 33:
        # the serial host-facing entries answer as the reference's
        assert np.array_equal(port.checks(q, w, gi, gc, dm, da, dc),
                              kc.checks(q, w, gi, gc, jm, ja, jc))
        assert np.array_equal(
            port.lookup_packed(off, length, q, w, dm, da, dc),
            kc.lookup_packed(off, length, q, w, jm, ja, jc))
        assert np.array_equal(port.lookup(off, length, q, w, dm, da, dc),
                              kc.lookup(off, length, q, w, jm, ja, jc))


@pytest.mark.parametrize("name,lanes", [
    ("rbac_deny", 33), ("nested_groups", 256), ("wildcard", 33)])
def test_jacobi_definite_path_matches_reference(name, lanes, monkeypatch):
    """`stages=()` runs the reference's unstaged step
    (SPICEDB_TPU_STAGED=0) on the definite path."""
    monkeypatch.setenv("SPICEDB_TPU_STAGED", "0")
    prog, rtype, perm = _compile(name)
    t = ref_ell.build_tables(prog)
    kc = ref_ell.EllKernelCache(prog, n_aux_rows=t.idx_aux.shape[0],
                                tree_depth=t.tree_depth,
                                shared_tree_depth=t.tree_depth,
                                host_main=t.idx_main)
    assert kc.stages is None
    w, q, gi, gc = _queries(prog, rtype, perm, lanes, seed=lanes + 1)
    jm, ja = jnp.asarray(t.idx_main), jnp.asarray(t.idx_aux)
    ref_out, ref_tel = kc.checks_device(q, w, gi, gc, jm, ja)
    ref_state = np.asarray(kc._arenas[w])
    off, length = prog.slot_range(rtype, perm)
    ref_words, _ = kc.lookup_packed_T_device(off, length, q, w, jm, ja)

    _, dm, da, port = convert.from_reference(
        prog, t.idx_main, t.idx_aux, stages=(), tree_depth=t.tree_depth,
        shared_tree_depth=t.tree_depth, device="cpu")
    assert port.stages == ()
    state, tel = port.evaluate(torch.from_numpy(q), w, dm, da,
                               port.take_arena(w))
    out, _ = port.checks_device(q, w, gi, gc, dm, da)
    words, _ = port.lookup_packed_T_device(off, length, q, w, dm, da)
    assert np.array_equal(state.numpy().view(np.uint32), ref_state)
    assert np.array_equal(tel, np.asarray(ref_tel))
    assert np.array_equal(out.numpy().view(np.uint32), np.asarray(ref_out))
    assert np.array_equal(words.numpy().view(np.uint32),
                          np.asarray(ref_words))
    assert port.iterations(q, w, dm, da) == int(tel[0])


@pytest.mark.parametrize("half", [1, 2, 8])
def test_plane_twins_follow_kleene_algebra(half):
    """perm_program's plane mode, check_gather3 and the plane seed and
    lookup against a direct statement of the tri-state rules."""
    from spicedb_kubeapi_proxy_tpu_torch.ops.graph_compile import (
        PExclude, PIntersect, PRead, PUnion)
    rng = np.random.default_rng(half)
    w2 = 2 * half

    def rand(shape):
        return torch.from_numpy(rng.integers(-2**31, 2**31, shape,
                                             dtype=np.int64).astype(np.int32))
    x = rand((20, w2))
    # maybe ⊇ definite, as the sweep keeps it
    x[:, half:] |= x[:, :half]
    x0 = torch.zeros((20, w2), dtype=torch.int32)
    expr = PExclude(PUnion((PRead(0, 3), PIntersect((PRead(3, 3),
                                                     PRead(6, 3))))),
                    PRead(9, 3))
    code, _, _ = port_ell.compile_perm_program(expr, 12, 3)
    cur = x.clone()
    twins.perm_program(cur, x0, torch.from_numpy(code), 12, 3, half=half)
    d = {o: x[o:o + 3, :half] for o in (0, 3, 6, 9)}
    m = {o: x[o:o + 3, half:] for o in (0, 3, 6, 9)}
    base_d, base_m = d[0] | (d[3] & d[6]), m[0] | (m[3] & m[6])
    assert torch.equal(cur[12:15, :half], base_d & ~m[9])
    assert torch.equal(cur[12:15, half:], base_m & ~d[9])

    gi = torch.from_numpy(rng.integers(0, 20, 500).astype(np.int32))
    gc = torch.from_numpy(rng.integers(0, 32 * half, 500).astype(np.int32))
    got = twins.check_gather3(x, gi, gc, half).numpy()
    xs = x.numpy().view(np.uint32)
    for g in range(500):
        r, c = int(gi[g]), int(gc[g])
        db = (xs[r, c // 32] >> (c % 32)) & 1
        mb = (xs[r, half + c // 32] >> (c % 32)) & 1
        assert got[g] == (2 if db else (1 if mb else 0))

    q = torch.from_numpy(rng.integers(0, 19, 32 * half).astype(np.int32))
    ranges = torch.tensor([[0, 5], [5, 19]], dtype=torch.int32)
    live_p = torch.empty((2, w2), dtype=torch.int32)
    live_d = torch.empty((2, half), dtype=torch.int32)
    x0p = twins.seed_bitplanes(q, 20, half, 19, wc_ranges=ranges,
                               live=live_p, planes=True)
    x0d = twins.seed_bitplanes(q, 20, half, 19, wc_ranges=ranges, live=live_d)
    assert torch.equal(x0p, torch.cat([x0d, x0d], dim=1))
    assert torch.equal(live_p, torch.cat([live_d, live_d], dim=1))
    assert torch.equal(twins.lookup_T(x0p, 2, 10, half),
                       x0d[2:12].t().contiguous())


# -- end to end --------------------------------------------------------------

def _endpoints(schema_text, rels):
    from spicedb_kubeapi_proxy_tpu.spicedb.endpoints import (
        Bootstrap as RefBootstrap)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    text = "\n".join(rels)
    port = create_endpoint("torch://?device=cpu", Bootstrap(schema_text, text))
    jx = JaxEndpoint.from_bootstrap(RefBootstrap(schema_text, text))
    return port, jx, Evaluator(jx.schema, jx.store)


def _assert_agree(port, jx, oracle, rtype, objects, perms, names) -> dict:
    """Tri-state checks and lookups equal across port, reference and
    oracle; returns the count of each tri-state value the checks gave."""
    seen = {0: 0, 1: 0, 2: 0}
    subjects = [SubjectRef("user", n) for n in names]
    refs = [RefSubjectRef("user", n) for n in names]
    for perm in perms:
        got = run(port.lookup_resources_batch(rtype, perm, subjects))
        ref = run(jx.lookup_resources_batch(rtype, perm, refs))
        for s, g, r in zip(refs, got, ref):
            want = sorted(oracle.lookup_resources(rtype, perm, s))
            assert sorted(g) == sorted(r) == want, (perm, s.id)
        pairs = [(o, i) for o in objects for i in range(len(names))]
        got = run(port.check_bulk_permissions(
            [CheckRequest(ObjectRef(rtype, o), perm, subjects[i])
             for o, i in pairs]))
        ref = run(jx.check_bulk_permissions(
            [RefCheckRequest(RefObjectRef(rtype, o), perm, refs[i])
             for o, i in pairs]))
        for (o, i), g, r in zip(pairs, got, ref):
            want = oracle.check3(RefObjectRef(rtype, o), perm, refs[i])
            assert TRI[g.permissionship] == REF_TRI[r.permissionship] \
                == want, (perm, o, names[i])
            seen[want] += 1
    return seen


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_endpoint_matches_reference_on_random_caveat_graphs(seed):
    port, jx, oracle = _endpoints(SCHEMA, _random_rels(seed))
    seen = _assert_agree(port, jx, oracle, "doc",
                         [f"d{i}" for i in range(8)] + ["never"], DOC_PERMS,
                         [f"u{i}" for i in range(6)] + ["stranger"])
    assert seen[1] > 0            # the MAYBE plane answered
    assert port._graph.has_cav and port._graph.tri_state_capable
    assert port.stats["oracle_residual_checks"] == 0
    assert np.array_equal(port._graph.host_cav, jx._graph.host_cav)


def test_endpoint_matches_reference_on_caveated_rbac():
    schema_text, rels, rtype, perm = _scenario("caveated_rbac")
    port, jx, oracle = _endpoints(schema_text, rels)
    pods = sorted(jx.store.object_ids_of_type("pod"))[::7]
    seen = _assert_agree(port, jx, oracle, rtype, pods, [perm],
                         [f"u{i}" for i in range(0, 800, 23)])
    assert seen[1] > 0 and seen[2] > 0
    g = port._graph
    assert g.has_cav and g.kernel.planes
    assert port.stats["oracle_residual_checks"] == 0
    assert np.array_equal(g.host_cav, jx._graph.host_cav)
    assert np.array_equal(g.host_aux, jx._graph.host_aux)


def test_unsupported_caveat_shape_routes_to_the_oracle():
    """A caveated wildcard has no device lowering: its pairs go to the
    oracle on both endpoints, and the answers still agree."""
    schema = ("caveat flag(on bool) { on }\ndefinition user {}\n"
              "definition doc {\n  relation viewer: user | user:* with flag"
              " | user with flag\n  permission view = viewer\n}")
    rels = ["doc:d1#viewer@user:*[caveat:flag]", "doc:d2#viewer@user:a",
            "doc:d3#viewer@user:b[caveat:flag]"]
    port, jx, oracle = _endpoints(schema, rels)
    _assert_agree(port, jx, oracle, "doc", ["d1", "d2", "d3"], ["view"],
                  ["a", "b"])
    assert not port._graph.tri_state_capable
    assert port.stats["oracle_residual_checks"] == \
        jx.stats["oracle_residual_checks"] > 0


# -- caveated deltas ---------------------------------------------------------

class Pair:
    """The port and the reference on equal stores, plus the oracle."""

    def __init__(self, rels):
        self.port = TorchEndpoint(port_sch.parse_schema(SCHEMA), device="cpu")
        self.jx = JaxEndpoint(ref_sch.parse_schema(SCHEMA))
        self.oracle = Evaluator(self.jx.schema, self.jx.store)
        self.port.store.bulk_load([parse_relationship(r) for r in rels])
        self.jx.store.bulk_load([ref_parse(r) for r in rels])

    def write(self, *rels, op="touch"):
        self.port.store.write([RelationshipUpdate(
            UpdateOp.TOUCH if op == "touch" else UpdateOp.DELETE,
            parse_relationship(r)) for r in rels])
        self.jx.store.write([RefUpdate(
            RefOp.TOUCH if op == "touch" else RefOp.DELETE, ref_parse(r))
            for r in rels])

    def agree(self, objects, perms, names=("a", "b", "z")):
        _assert_agree(self.port, self.jx, self.oracle, "doc", objects, perms,
                      names)
        p, r = self.port._graph, self.jx._graph
        assert self.port.stats["rebuilds"] == self.jx.stats["rebuilds"]
        assert np.array_equal(p.host_main, r.host_main)
        assert np.array_equal(p.host_aux, r.host_aux)
        assert (p.host_cav is None) == (r.host_cav is None)
        if p.host_cav is not None:
            assert np.array_equal(p.host_cav, r.host_cav)
            assert np.array_equal(p.dev_cav.numpy(), p.host_cav)
        assert np.array_equal(p.dev_main.numpy(), p.host_main)
        assert np.array_equal(p.dev_aux.numpy(), p.host_aux)
        assert p.has_cav == r.has_cav
        assert self.port._caveated_keys == self.jx._caveated_keys
        for k in ("delta_batches", "stale_pair_marks",
                  "oracle_residual_checks"):
            assert self.port.stats[k] == self.jx.stats[k], k
        assert self.port.stats["oracle_residual_checks"] == 0

    def same_traces(self, lanes):
        """One batch's sweeps on the current tables, both packages."""
        pg, rg = self.port._graph, self.jx._graph
        prog = pg.prog
        w, q, gi, gc = _queries(prog, "doc", "view", lanes, seed=lanes)
        ref_out, ref_tel = rg.kernel.checks_device(
            q, w, gi, gc, rg.dev_main, rg.dev_aux, rg.dev_cav)
        out, tel = pg.kernel.checks_device(q, w, gi, gc, *pg.snapshot())
        assert np.array_equal(tel, np.asarray(ref_tel))
        assert np.array_equal(out.numpy().view(np.uint32),
                              np.asarray(ref_out))


def test_incremental_caveat_deltas_match_reference():
    """The reference's caveated delta sequence (test_caveat_device.py
    test_incremental_caveat_deltas_no_rebuild), replayed on both."""
    p = Pair(["doc:d0#reader@user:a", f"doc:d9#reader@user:z{UNDECIDED}",
              "doc:d0#folder@folder:f0", "folder:f0#owner@user:a"])
    p.agree(["d0", "d9"], ["base", "view"])
    rebuilds = p.port.stats["rebuilds"]
    steps = [
        ((f"doc:d0#blocked@user:a{UNDECIDED}",), "touch", ["view"]),
        ((f"doc:d0#blocked@user:a{TRUE_CTX}",), "touch", ["view"]),
        ((f"doc:d0#blocked@user:a{FALSE_CTX}",), "touch", ["view"]),
        (("doc:d9#reader@user:z",), "touch", ["base"]),
        ((f"doc:d9#reader@user:z{UNDECIDED}",), "touch", ["base"]),
        ((f"doc:d9#reader@user:z{UNDECIDED}",), "delete", ["base"]),
        ((f"doc:d0#folder@folder:f0{UNDECIDED}",), "touch", ["base", "view"]),
        (("doc:d0#folder@folder:f0",), "touch", ["base", "view"]),
    ]
    for rels, op, perms in steps:
        p.write(*rels, op=op)
        p.agree(["d0", "d9"], perms)
    p.same_traces(33)
    p.same_traces(256)
    assert p.port.stats["rebuilds"] == rebuilds, "caveat deltas rebuilt"
    assert p.port.stats["delta_batches"] == len(steps)


def test_first_undecidable_caveat_rebuilds_once_as_reference():
    """A graph compiled without planes gains them through one rebuild
    when the first undecidable caveat arrives; decided caveats never
    rebuild (test_caveat_device.py test_first_undecidable_caveat_
    rebuilds_once)."""
    p = Pair(["doc:d0#reader@user:a"])
    p.agree(["d0"], ["base"], names=("a", "b"))
    assert not p.port._graph.has_cav
    rebuilds = p.port.stats["rebuilds"]
    p.write(f"doc:d0#blocked@user:a{TRUE_CTX}")
    p.agree(["d0"], ["view"], names=("a", "b"))
    assert p.port.stats["rebuilds"] == rebuilds
    p.write(f"doc:d0#required@user:a{UNDECIDED}")
    p.agree(["d0"], ["gated"], names=("a", "b"))
    assert p.port.stats["rebuilds"] == rebuilds + 1
    assert p.port._graph.has_cav
    p.write(f"doc:d0#blocked@user:a{UNDECIDED}")
    p.agree(["d0"], ["view", "strict"], names=("a", "b"))
    assert p.port.stats["rebuilds"] == rebuilds + 1
    p.same_traces(33)


def test_caveated_expiry_clears_both_placements():
    """An expiring caveated tuple leaves the MAYBE plane on both
    endpoints at the store clock's instant."""
    clock = [1_700_000_000.0]
    now = lambda: clock[0]
    port = TorchEndpoint(port_sch.parse_schema(SCHEMA),
                         store=PortStore(clock=now), device="cpu")
    jx = JaxEndpoint(ref_sch.parse_schema(SCHEMA), store=RefStore(clock=now))
    base = ["doc:d0#reader@user:a", f"doc:d1#reader@user:b{UNDECIDED}"]
    port.store.bulk_load([parse_relationship(r) for r in base])
    jx.store.bulk_load([ref_parse(r) for r in base])
    oracle = Evaluator(jx.schema, jx.store)
    _assert_agree(port, jx, oracle, "doc", ["d0", "d1"], ["view"], ["a", "b"])
    rel = f"doc:d0#blocked@user:a{UNDECIDED}[expiration:{clock[0] + 100}]"
    port.store.write([RelationshipUpdate(UpdateOp.TOUCH,
                                         parse_relationship(rel))])
    jx.store.write([RefUpdate(RefOp.TOUCH, ref_parse(rel))])
    seen = _assert_agree(port, jx, oracle, "doc", ["d0"], ["view"], ["a"])
    assert seen[1] == 1
    clock[0] += 200     # past the expiration
    seen = _assert_agree(port, jx, oracle, "doc", ["d0"], ["view"], ["a"])
    assert seen[2] == 1
    assert port.stats["rebuilds"] == jx.stats["rebuilds"] == 1
    assert np.array_equal(port._graph.host_cav, jx._graph.host_cav)
    assert port._caveated_keys == jx._caveated_keys
