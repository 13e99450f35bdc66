"""Where the ELL sweep's gathers and permission programs write, held
against brute force.

The port's `EllKernelCache` plan says, per staged row range and for the
aux refresh, whether the gather may write the state in place: only when
its host table reads none of the rows it writes.  Here that flag is held
against a brute-force scan of the host tables on every scenario of
tests/test_torch_ell.py (staged and Jacobi) and after every burst of
tests/test_torch_delta.py's churn; a crafted write of a child inside its
own range must flip it (and a delete flip it back, with a snapshot
taken before the flush keeping its own plan).  The twins enforce the
rules: `ell_gather_or` refuses `in_place` for a range that reads its own
rows and equals the scratch path where it may write in place;
`perm_program` refuses `in_place` for a READ overlapping its slot, and
where the plan writes in place, an in-place evaluation row by row in any
order equals the out-of-place twin (random programs, self-reading ones,
both planes, stack depth 16).  Inputs come from numpy generators with
fixed seeds; tolerance 0 (integers and bitplanes).
"""

import random

import numpy as np
import pytest
import torch

from spicedb_kubeapi_proxy_tpu_torch import convert
from spicedb_kubeapi_proxy_tpu_torch.ops import ell as port_ell
from spicedb_kubeapi_proxy_tpu_torch.ops.graph_compile import (
    PExclude, PIntersect, PRead, PUnion, PZero)
from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference as twins
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
    Bootstrap, create_endpoint)
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
    RelationshipUpdate, UpdateOp, parse_relationship)
from test_torch_delta import GROUPS_SCHEMA
from test_torch_delta import _churn as delta_churn
from test_torch_delta import _scenario as delta_scenario
from test_torch_ell import _scenario as ell_scenario

SCENARIOS = ["graft", "wildcard", "nested_groups", "rbac_deny", "multitenant"]


def _assert_modes_match_brute_force(kc, host_main, host_aux) -> int:
    """Every gather's write mode in the current plan equals a scan of
    the host tables; returns how many ranges read their own rows."""
    n = kc.prog.state_size
    aux_self = bool((host_aux >= n).any())
    self_reading = 0
    for _, _, rows, ops, aux_mode in kc.plan:
        assert aux_mode == ("scratch" if aux_self else "in_place")
        for lo, hi, _, mode in rows:
            if not kc.stages:
                assert mode == "x_in"
                continue
            t = host_main[lo:hi]
            own = bool(((t >= lo) & (t < hi)).any())
            self_reading += own
            assert mode == ("scratch" if own else "in_place"), (lo, hi)
        for code, off, length, _ in ops:
            assert twins.reads_in_place(code.tolist(), off, length)
    return self_reading


@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("name", SCENARIOS)
def test_build_modes_match_brute_force(name, jacobi):
    prog, _ = ell_scenario(name)
    port_prog = convert.program_from_reference(prog)
    t = port_ell.build_tables(port_prog)
    kc = port_ell.EllKernelCache(
        port_prog, n_aux_rows=t.idx_aux.shape[0], tree_depth=t.tree_depth,
        device="cpu", host_main=t.idx_main, host_aux=t.idx_aux,
        stages=() if jacobi else None)
    _assert_modes_match_brute_force(kc, t.idx_main, t.idx_aux)
    # without the host tables nothing is proven: every gather scratch
    kc = port_ell.EllKernelCache(port_prog, n_aux_rows=t.idx_aux.shape[0],
                                 tree_depth=t.tree_depth, device="cpu",
                                 stages=() if jacobi else None)
    for _, _, rows, _, aux_mode in kc.plan:
        assert aux_mode == "scratch"
        assert all(r[3] == ("x_in" if jacobi else "scratch") for r in rows)


def test_some_scenario_reads_its_own_rows():
    """The brute force above sees both outcomes: nested groups read their
    own range, most ranges do not."""
    prog, _ = ell_scenario("nested_groups")
    port_prog = convert.program_from_reference(prog)
    t = port_ell.build_tables(port_prog)
    kc = port_ell.EllKernelCache(
        port_prog, n_aux_rows=t.idx_aux.shape[0], tree_depth=t.tree_depth,
        device="cpu", host_main=t.idx_main, host_aux=t.idx_aux)
    modes = [r[3] for _, _, rows, _, _ in kc.plan for r in rows]
    assert _assert_modes_match_brute_force(kc, t.idx_main, t.idx_aux) >= 1
    assert "in_place" in modes and "scratch" in modes


def _write(ep, ops) -> None:
    kinds = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
    ep.store.write([RelationshipUpdate(kinds[o], parse_relationship(r))
                    for o, r in ops])


@pytest.mark.parametrize("name", SCENARIOS)
def test_modes_match_brute_force_after_every_burst(name):
    schema_text, rels, _ = delta_scenario(name)
    ep = create_endpoint("torch://?device=cpu",
                         Bootstrap(schema_text, "\n".join(rels)))
    g = ep.graph()
    _assert_modes_match_brute_force(g.kernel, g.host_main, g.host_aux)
    for ops in delta_churn(name, rels, random.Random(name)):
        _write(ep, ops)
        g = ep.graph()     # applies and flushes the burst
        _assert_modes_match_brute_force(g.kernel, g.host_main, g.host_aux)
        assert g.snapshot().plan is g.kernel.plan


def test_crafted_flush_flips_a_range_to_scratch_and_back():
    rels = [f"group:g{i}#member@user:u{i}" for i in range(8)]
    rels += ["namespace:ns#viewer@group:g0#member"]
    ep = create_endpoint("torch://?device=cpu",
                         Bootstrap(GROUPS_SCHEMA, "\n".join(rels)))
    g = ep.graph()
    kc = g.kernel
    row = g.prog.state_index("group", "member", "g1")

    def mode_of(plan):
        return next(m for _, _, rows, _, _ in plan
                    for lo, hi, _, m in rows if lo <= row < hi)

    assert mode_of(kc.plan) == "in_place"
    before = g.snapshot()
    _write(ep, [("touch", "group:g1#member@group:g2#member")])
    assert ep.graph() is g
    _assert_modes_match_brute_force(kc, g.host_main, g.host_aux)
    assert mode_of(kc.plan) == "scratch"
    # the snapshot taken before the flush keeps the plan proven for its
    # tables; the new snapshot carries the new one
    assert mode_of(before.plan) == "in_place"
    assert g.snapshot().plan is kc.plan and before.plan is not kc.plan
    _write(ep, [("delete", "group:g1#member@group:g2#member")])
    ep.graph()
    _assert_modes_match_brute_force(kc, g.host_main, g.host_aux)
    assert mode_of(kc.plan) == "in_place"
    assert ep.stats["rebuilds"] == 1


def _rand(rng, shape):
    return torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, shape,
                                         dtype=np.int64).astype(np.int32))


@pytest.mark.parametrize("w", [1, 4, 8])
def test_gather_twin_refuses_in_place_on_self_reading_ranges(w):
    rng = np.random.default_rng(w)
    nt, lo, n = 200, 60, 40
    cur, x0 = _rand(rng, (nt, w)), _rand(rng, (nt, w))
    idx = torch.from_numpy(rng.integers(0, nt, (n, 2)).astype(np.int32))
    idx[3, 1] = lo + 5                        # a row of its own range
    with pytest.raises(ValueError):
        twins.ell_gather_or(cur.clone(), idx, lo, x0, in_place=True)
    # the same range through scratch, or with its own rows read from an
    # input buffer equal to the state there, is legal
    a, b = cur.clone(), cur.clone()
    x_in = _rand(rng, (nt, w))
    x_in[lo: lo + n] = cur[lo: lo + n]
    twins.ell_gather_or(a, idx, lo, x0)
    twins.ell_gather_or(b, idx, lo, x0, x_in=x_in)
    assert torch.equal(a, b)


@pytest.mark.parametrize("w", [1, 3, 8])
@pytest.mark.parametrize("seeded", [False, True])
def test_gather_in_place_equals_scratch_where_legal(w, seeded):
    rng = np.random.default_rng(10 * w + seeded)
    nt, lo, n = 300, 100, 77
    cur, x0 = _rand(rng, (nt, w)), _rand(rng, (nt, w))
    pool = np.r_[0:lo, lo + n:nt]
    idx = torch.from_numpy(rng.choice(pool, (n, 3)).astype(np.int32))
    bits = torch.from_numpy(rng.integers(0, 4, n).astype(np.int32))
    live = _rand(rng, (2, w))
    a, b = cur.clone(), cur.clone()
    twins.ell_gather_or(a, idx, lo, x0 if seeded else None, bits, live)
    twins.ell_gather_or(b, idx, lo, x0 if seeded else None, bits, live,
                        in_place=True)
    assert torch.equal(a, b)


L, N_SLOTS = 24, 6
OFFS = [i * L for i in range(N_SLOTS)]


def _rand_expr(rng, depth):
    if depth == 0 or rng.random() < 0.3:
        if rng.random() < 0.1:
            return PZero(length=L)
        return PRead(offset=int(rng.choice(OFFS)), length=L)
    kind = int(rng.integers(0, 3))
    if kind == 0:
        return PUnion(children=tuple(_rand_expr(rng, depth - 1)
                                     for _ in range(int(rng.integers(2, 5)))))
    if kind == 1:
        return PIntersect(children=tuple(
            _rand_expr(rng, depth - 1) for _ in range(int(rng.integers(2, 4)))))
    return PExclude(base=_rand_expr(rng, depth - 1),
                    subtract=_rand_expr(rng, depth - 1))


def _deep16(out):
    """A program whose stack is 16 deep, reading its own slot too."""
    e = PRead(offset=out, length=L)
    for i in range(15):
        e = PUnion(children=(PRead(offset=OFFS[i % N_SLOTS], length=L), e))
    return e


def _in_place_rows(cur, x0, code, offset, length, half, order) -> None:
    """The program written in place one row at a time, in `order`: each
    row reads the state as the earlier rows left it (how in-place kernel
    threads may interleave, at row grain)."""
    ops = code.tolist()
    for i in order:
        stack = []
        for op, arg in zip(ops[0::2], ops[1::2]):
            if op == twins.OP_READ:
                stack.append(cur[arg + i].clone())
            elif op == twins.OP_ZERO:
                stack.append(torch.zeros_like(cur[0]))
            elif op in (twins.OP_OR, twins.OP_AND):
                v = stack.pop()
                for _ in range(1, arg):
                    v = v | stack.pop() if op == twins.OP_OR else \
                        v & stack.pop()
                stack.append(v)
            else:
                b, a = stack.pop(), stack.pop()
                if half is not None:
                    b = torch.cat([b[half:], b[:half]])
                stack.append(a & ~b)
        cur[offset + i] = stack[0] | x0[offset + i]


@pytest.mark.parametrize("half", [None, 2])
@pytest.mark.parametrize("seed", range(3))
def test_perm_program_in_place_equals_the_out_of_place_twin(seed, half):
    rng = np.random.default_rng(100 + seed)
    w = 4 if half else 3
    n_self = 0
    for trial in range(40):
        out = int(rng.choice(OFFS))
        expr = _deep16(out) if trial == 0 else _rand_expr(rng, 4)
        code, depth, self_read = port_ell.compile_perm_program(expr, out, L)
        if trial == 0:
            assert depth == 16 and self_read
        n_self += self_read
        ct = torch.from_numpy(code)
        cur = _rand(rng, (N_SLOTS * L + 3, w))
        x0 = _rand(rng, cur.shape)
        want = cur.clone()
        twins.perm_program(want, x0, ct, out, L, in_place=False, half=half)
        got = cur.clone()
        twins.perm_program(got, x0, ct, out, L, in_place=True, half=half,
                           depth=depth)
        assert torch.equal(got, want)
        for order in (range(L), range(L - 1, -1, -1), rng.permutation(L)):
            got = cur.clone()
            _in_place_rows(got, x0, ct, out, L, half, order)
            assert torch.equal(got, want)
    assert n_self >= 1


def test_perm_program_twin_refuses_an_overlapping_read():
    rng = np.random.default_rng(7)
    cur = _rand(rng, (N_SLOTS * L, 2))
    x0 = _rand(rng, cur.shape)
    out = OFFS[2]
    code = np.asarray([twins.OP_READ, out - 3, twins.OP_READ, OFFS[0],
                       twins.OP_OR, 2], np.int32)
    assert not twins.reads_in_place(code.tolist(), out, L)
    with pytest.raises(ValueError):
        twins.perm_program(cur, x0, torch.from_numpy(code), out, L,
                           in_place=True)
    # row by row in place it would read rows it already wrote
    want = cur.clone()
    twins.perm_program(want, x0, torch.from_numpy(code), out, L)
    got = cur.clone()
    _in_place_rows(got, x0, torch.from_numpy(code), out, L, None, range(L))
    assert not torch.equal(got, want)
