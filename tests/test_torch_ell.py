"""The torch port's ELL sweep held against the JAX reference, bit for bit.

Same GraphProgram, same tables (carried across with the port's
convert.from_reference), same seeded queries: the port's host builders
must produce the reference's arrays, and its pipelined entry points —
here on the CPU, i.e. the CUDA kernels' plain-torch twins — must produce
the reference EllKernelCache's final packed state, check values, [W, L]
lookup words and sweep trace exactly (tolerance 0: the data are boolean
bitplanes).  Inputs come from numpy generators with fixed seeds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as graft
from spicedb_kubeapi_proxy_tpu.models import workloads as ref_workloads
from spicedb_kubeapi_proxy_tpu.ops import ell as ref_ell
from spicedb_kubeapi_proxy_tpu.ops.graph_compile import compile_graph
from spicedb_kubeapi_proxy_tpu.spicedb import schema as ref_sch
from spicedb_kubeapi_proxy_tpu.spicedb.types import parse_relationship
from spicedb_kubeapi_proxy_tpu_torch import convert
from spicedb_kubeapi_proxy_tpu_torch.ops import ell as port_ell
from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference as twins

WILDCARD_SCHEMA = """
definition user {}
definition bot {}
definition doc {
  relation viewer: user | user:* | bot
  relation editor: user
  permission view = viewer + editor
}
"""


def _compile(schema_text, rels):
    schema = ref_sch.parse_schema(schema_text)
    return compile_graph(schema, [parse_relationship(r) for r in rels])


def _scenario(name):
    """(reference GraphProgram, lookup (type, permission)) per scenario."""
    if name == "graft":
        prog, _, _ = graft._build_program()
        return prog, ("pod", "view")
    if name == "wildcard":
        rels = ["doc:d1#viewer@user:*", "doc:d2#editor@user:eve",
                "doc:d3#viewer@user:frank", "doc:d4#viewer@bot:b1"]
        rels += [f"doc:x{i}#editor@user:u{i % 7}" for i in range(40)]
        return _compile(WILDCARD_SCHEMA, rels), ("doc", "view")
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
    return _compile(w.schema_text, w.relationships), (w.resource_type,
                                                      w.permission)


def _reference_cache(prog):
    t = ref_ell.build_tables(prog)
    kc = ref_ell.EllKernelCache(prog, n_aux_rows=t.idx_aux.shape[0],
                                tree_depth=t.tree_depth,
                                shared_tree_depth=t.tree_depth,
                                host_main=t.idx_main)
    return t, kc


def _queries(prog, lanes, seed):
    """Seeded query columns over every state row (any row is a legal
    one-hot seed), padded with the dead index to the word bucket, plus a
    gather list that covers every lane."""
    rng = np.random.default_rng(seed)
    w = ref_ell.batch_words(lanes)
    q = np.full(w * 32, prog.dead_index, np.int32)
    q[:lanes] = rng.integers(0, prog.dead_index, lanes)
    g = 4 * lanes
    gi = rng.integers(0, prog.state_size, g).astype(np.int32)
    gc = rng.integers(0, lanes, g).astype(np.int32)
    gc[:lanes] = np.arange(lanes)
    return w, q, gi, gc


@pytest.mark.parametrize("name", ["graft", "wildcard", "nested_groups",
                                  "rbac_deny", "multitenant"])
def test_host_builders_match_reference(name):
    prog, _ = _scenario(name)
    port_prog = convert.program_from_reference(prog)
    rt = ref_ell.build_tables(prog)
    pt = port_ell.build_tables(port_prog)
    assert np.array_equal(rt.idx_main, pt.idx_main)
    assert np.array_equal(rt.idx_aux, pt.idx_aux)
    assert rt.tree_depth == pt.tree_depth
    assert tuple(rt.spare_rows) == tuple(pt.spare_rows)
    rs = ref_ell.compute_stages(prog)
    assert rs == port_ell.compute_stages(port_prog)
    assert (ref_ell.annotate_stage_refresh(rs, rt.idx_main, prog.state_size)
            == port_ell.annotate_stage_refresh(rs, pt.idx_main,
                                               port_prog.state_size))
    assert ref_ell.batch_words(33) == port_ell.batch_words(33) == 2


@pytest.mark.parametrize("name,lanes", [
    ("graft", 8), ("wildcard", 33), ("nested_groups", 33), ("rbac_deny", 256),
    ("multitenant", 256)])
def test_pipelined_entries_match_reference(name, lanes):
    prog, (rtype, perm) = _scenario(name)
    t, kc = _reference_cache(prog)
    w, q, gi, gc = _queries(prog, lanes, seed=lanes)
    main, aux = jnp.asarray(t.idx_main), jnp.asarray(t.idx_aux)
    ref_out, ref_tel = kc.checks_device(q, w, gi, gc, main, aux)
    ref_state = np.asarray(kc._arenas[w])
    off, length = prog.slot_range(rtype, perm)
    ref_words, ref_tel_l = kc.lookup_packed_T_device(off, length, q, w,
                                                     main, aux)
    assert int(np.asarray(ref_tel)[0]) >= 1

    for term in prog.wildcard_terms:
        # the seeded columns make every wildcard term live somewhere
        lo, hi = term.self_offset, term.self_offset + term.self_length
        assert ((q[:lanes] >= lo) & (q[:lanes] < hi)).any()
    _, dm, da, port = convert.from_reference(
        prog, t.idx_main, t.idx_aux, stages=kc.stages,
        tree_depth=t.tree_depth, shared_tree_depth=t.tree_depth,
        device="cpu")
    assert port.num_iters == kc.num_iters and port.aux_passes == kc.aux_passes
    kernels.reset_launches()
    state, tel = port.evaluate(torch.from_numpy(q), w, dm, da,
                               port.take_arena(w))
    out, tel_c = port.checks_device(q, w, gi, gc, dm, da)
    words, tel_l = port.lookup_packed_T_device(off, length, q, w, dm, da)
    # on the CPU only the twins run: nothing counts as a kernel launch
    assert not any(kernels.LAUNCHES.values())

    assert np.array_equal(state.numpy().view(np.uint32), ref_state)
    assert np.array_equal(tel, np.asarray(ref_tel))
    assert np.array_equal(tel_c, np.asarray(ref_tel))
    assert np.array_equal(tel_l, np.asarray(ref_tel_l))
    assert np.array_equal(out.numpy().view(np.uint32), np.asarray(ref_out))
    assert np.array_equal(words.numpy().view(np.uint32),
                          np.asarray(ref_words))
    if lanes > 32:
        # lane 31 is a real query column, so bit 31 of word 0 is live:
        # the equalities above held with negative int32 words in play
        assert ((ref_state[:, 0] >> np.uint32(31)) & 1).any()
        assert bool((state[:, 0] < 0).any())


def test_perm_program_compiles_all_algebra():
    """Union, intersection, exclusion and nil in one expression."""
    from spicedb_kubeapi_proxy_tpu_torch.ops.graph_compile import (
        PExclude, PIntersect, PRead, PUnion, PZero)
    expr = PExclude(PUnion((PRead(0, 3), PIntersect((PRead(3, 3),
                                                     PRead(6, 3))))),
                    PUnion((PRead(9, 3), PZero(3))))
    code, depth, self_read = port_ell.compile_perm_program(expr, 12, 3)
    assert depth == 3 and not self_read
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, (16, 2),
                                      dtype=np.int64).astype(np.int32))
    x0 = torch.from_numpy(rng.integers(-2**31, 2**31, (16, 2),
                                       dtype=np.int64).astype(np.int32))
    cur = x.clone()
    twins.perm_program(cur, x0, torch.from_numpy(code), 12, 3)
    a, b, c, d = (x[o:o + 3] for o in (0, 3, 6, 9))
    want = ((a | (b & c)) & ~d) | x0[12:15]
    assert torch.equal(cur[12:15], want)
    assert torch.equal(cur[:12], x[:12]) and torch.equal(cur[15:], x[15:])


def test_twin_popcount_and_seed_cover_bit_31():
    rng = np.random.default_rng(3)
    a = rng.integers(-2**31, 2**31, (64, 4), dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, (64, 4), dtype=np.int64).astype(np.int32)
    ta, tb = torch.from_numpy(a.copy()), torch.from_numpy(b)
    got = twins.sweep_delta(ta, tb, dead=5)
    a[5] = 0
    want = int(np.unpackbits((a ^ b).view(np.uint8)).sum())
    assert got.tolist() == [want, 1]
    q = rng.integers(0, 10, 128).astype(np.int32)
    x0 = twins.seed_bitplanes(torch.from_numpy(q), 11, 4, dead=10)
    ref = np.zeros((11, 4), np.uint32)
    for c, r in enumerate(q):
        ref[r, c // 32] |= np.uint32(1) << np.uint32(c % 32)
    ref[10] = 0
    assert np.array_equal(x0.numpy().view(np.uint32), ref)


@pytest.mark.parametrize("w", [1, 4])
def test_lookup_T_twin_owns_its_result(w):
    """The state arena is reused by the next batch, so the lookup words
    must not alias it (a one-word batch made `.t().contiguous()` a view)."""
    x = torch.arange(40 * w, dtype=torch.int32).reshape(40, w)
    words = twins.lookup_T(x, 3, 20)
    assert torch.equal(words, x[3:23].t())
    assert words.is_contiguous()
    x.zero_()
    assert int(words.abs().sum()) > 0
