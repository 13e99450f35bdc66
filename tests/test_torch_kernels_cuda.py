"""The torch port's CUDA kernels against their plain-torch twins, on a card.

Needs a CUDA device and nvcc (the kernels have no CPU mode), so every test
here carries the `cuda` marker and skips where no device is present.  It
imports nothing but the port, so it also runs on a machine without jax:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
"""

import time

import numpy as np
import pytest
import torch

from spicedb_kubeapi_proxy_tpu_torch.models import workloads
from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
from spicedb_kubeapi_proxy_tpu_torch.ops.ell import EllKernelCache
from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
    Bootstrap, create_endpoint)

WILDCARD = ("definition user {}\ndefinition doc {\n"
            "  relation viewer: user | user:*\n  relation banned: user\n"
            "  permission view = viewer - banned\n}")


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _graphs(schema, rels):
    bs = Bootstrap(schema, "\n".join(rels))
    return [create_endpoint(f"torch://?device={d}", bs).graph()
            for d in ("cpu", "cuda")]


def _workload():
    w = workloads.rbac_deny(n_pods=400, n_users=300, n_groups=10)
    return w.schema_text, w.relationships


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [8, 33, 256])
def test_every_sweep_step_matches_its_twin(lanes):
    _needs_card()
    g_cpu, g = _graphs(*_workload())
    kc, prog = g.kernel, g.prog
    main, aux, _ = g.snapshot()
    rng = np.random.default_rng(lanes)
    w = max(1, -(-lanes // 32))
    w = 1 << (w - 1).bit_length()
    q = np.full(32 * w, prog.dead_index, np.int32)
    q[:lanes] = rng.integers(0, prog.dead_index, lanes)
    qd = torch.from_numpy(q).cuda()
    nt = prog.state_size + kc.n_aux_rows
    x0 = kernels.seed_bitplanes(qd, nt, w, prog.dead_index)
    assert torch.equal(x0, reference.seed_bitplanes(qd, nt, w,
                                                    prog.dead_index))
    x = x0.clone()
    for _ in range(2):
        a, b = x.clone(), x.clone()
        for step in kc.sweep_steps(main, aux):
            EllKernelCache.run_step(step, a, x0, None, kernels)
            EllKernelCache.run_step(step, b, x0, None, reference)
            torch.cuda.synchronize()
            assert torch.equal(a, b), step[0]
        assert kernels.sweep_delta(a, x, prog.dead_index).tolist() == \
            reference.sweep_delta(b, x, prog.dead_index).tolist()
        x = a
    off, length = prog.slot_range("pod", "view")
    assert torch.equal(kernels.lookup_T(x, off, length),
                       reference.lookup_T(x, off, length))
    gi = torch.from_numpy(rng.integers(0, prog.state_size, 999)
                          .astype(np.int32)).cuda()
    gc = torch.from_numpy(rng.integers(0, lanes, 999).astype(np.int32)).cuda()
    assert torch.equal(kernels.check_gather(x, gi, gc),
                       reference.check_gather(x, gi, gc))


@pytest.mark.cuda
def test_card_and_cpu_endpoints_agree_with_wildcards():
    _needs_card()
    rels = ["doc:d1#viewer@user:*", "doc:d1#banned@user:u3",
            "doc:d2#viewer@user:u1"]
    rels += [f"doc:x{i}#viewer@user:u{i % 9}" for i in range(50)]
    g_cpu, g = _graphs(WILDCARD, rels)
    q = np.full(64, g.prog.dead_index, np.int32)
    q[:40] = np.arange(40) % g.prog.dead_index
    off, length = g.prog.slot_range("doc", "view")
    kernels.reset_launches()
    got = g.run_lookup_packed_T_device(off, length, q)
    want = g_cpu.run_lookup_packed_T_device(off, length, q)
    assert torch.equal(got[0].cpu(), want[0])
    assert np.array_equal(got[1], want[1])
    assert all(kernels.LAUNCHES[k] for k in
               ("seed_bitplanes", "ell_gather_or", "perm_program",
                "sweep_delta_checks", "lookup_T"))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 32])
def test_scatter_rows_matches_its_twin(k):
    """Copy-on-write row scatter on random tables: b from 1 to 4096 dirty
    rows, duplicates with equal values included, `src` never written."""
    _needs_card()
    rng = np.random.default_rng(k)
    r = 50_000 if k == 2 else 6_000
    src = torch.from_numpy(rng.integers(-2**31, 2**31, (r, k), dtype=np.int64)
                           .astype(np.int32)).cuda()
    src0 = src.clone()
    kernels.reset_launches()
    for b in (1, 2, 17, 512, 4096):
        rows = rng.integers(0, r, b).astype(np.int32)
        rows = np.concatenate([rows, rows[: b // 2], np.repeat(rows[-1:], 3)])
        uniq, first = np.unique(rows, return_index=True)
        vals = rng.integers(-2**31, 2**31, (len(rows), k),
                            dtype=np.int64).astype(np.int32)
        vals = vals[first[np.searchsorted(uniq, rows)]]
        t_rows = torch.from_numpy(rows).cuda()
        t_vals = torch.from_numpy(vals).cuda()
        got = kernels.scatter_rows(src, t_rows, t_vals)
        torch.cuda.synchronize()
        assert torch.equal(got, reference.scatter_rows(src, t_rows, t_vals))
        assert torch.equal(src, src0)
    # a row-offset view: for K = 2 it is not 16-byte aligned and takes
    # the scalar copy path
    view = src[1:]
    rows = torch.tensor([0, 5, 5], dtype=torch.int32, device="cuda")
    vals = torch.full((3, k), 7, dtype=torch.int32, device="cuda")
    assert torch.equal(kernels.scatter_rows(view, rows, vals),
                       reference.scatter_rows(view, rows, vals))
    assert kernels.LAUNCHES["scatter_rows"] == 6


def _rand(rng, shape):
    return torch.from_numpy(rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                            .astype(np.int32)).cuda()


def _lookup_tile(words: int) -> int:
    """Rows of one lookup_T tile (ell_kernels.cu ell_lookup_T): the
    largest power of two with tile * words <= 2048, within [32, 1024]."""
    t = 1
    while 2 * t * words <= 2048:
        t *= 2
    return min(max(t, 32), 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("length", ["1", "3", "tile-1", "tile+1", "200003"])
@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("words", [1, 2, 8, 32])
def test_lookup_T_edges_match_the_twin(words, planes, length):
    """The tiled transpose at its ragged edges: a short last tile, an odd
    row offset (rows not 16-byte aligned at 1 and 2 words), lengths not a
    multiple of 4 (output rows not 16-byte aligned), rows of one plane or
    of two (the definite plane of a tri-state row), and 32 words (1,024
    lanes: the wide-chunk padding)."""
    _needs_card()
    tile = _lookup_tile(words)
    n = {"1": 1, "3": 3, "tile-1": tile - 1, "tile+1": tile + 1,
         "200003": 200_003}[length]
    rng = np.random.default_rng(words * 10 + planes)
    stride = 2 * words if planes else words
    for offset in (3, 4):
        x = _rand(rng, (offset + n + 2, stride))
        kernels.reset_launches()
        got = kernels.lookup_T(x, offset, n, words)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["lookup_T"] == 1
        assert torch.equal(got, reference.lookup_T(x, offset, n, words))


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("b", [0, 1, 257, 5000])
@pytest.mark.parametrize("k", [1, 2, 32])
def test_scatter_rows_edges_match_the_twin(k, b, misaligned):
    """The one-launch copy and overrides: unsorted rows with duplicates
    (equal values), rows at and past R and negative ones (skipped), b
    past one block's 256 threads (a second pass over the list), a table
    whose word count is not a multiple of 4 or of the block span, and a
    source at a one-word offset (not 16-byte aligned: the 4-byte copy
    path).  `src` is left as it was."""
    _needs_card()
    r = 12_347
    rng = np.random.default_rng(k * 1000 + b)
    flat = _rand(rng, (1 + r * k,))
    src = flat[int(misaligned):][: r * k].view(r, k)
    assert (src.data_ptr() % 16 != 0) == misaligned
    src0 = src.clone()
    rows = rng.integers(0, r, b).astype(np.int32)
    if b > 1:
        rows[: b // 8] = rows[b // 2: b // 2 + b // 8]
        rows[-4:] = [r, r + 5, 2**31 - 1, -1][-min(4, b):]
    uniq, first = np.unique(rows, return_index=True)
    vals = rng.integers(-2**31, 2**31, (b, k), dtype=np.int64).astype(
        np.int32)[first[np.searchsorted(uniq, rows)]]
    t_rows = torch.from_numpy(rows).cuda()
    t_vals = torch.from_numpy(vals.reshape(b, k)).cuda()
    kernels.reset_launches()
    got = kernels.scatter_rows(src, t_rows, t_vals)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["scatter_rows"] == 1
    assert torch.equal(got, reference.scatter_rows(src, t_rows, t_vals))
    assert torch.equal(src, src0)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [33, 256])
def test_plane_kernels_match_their_twins(lanes):
    """cav_gather_or, perm_program in plane mode (ANDNOT across planes),
    check_gather3 and the plane seed and definite-half lookup on random
    inputs; bit 31 is live in both planes."""
    _needs_card()
    from spicedb_kubeapi_proxy_tpu_torch.ops.ell import compile_perm_program
    from spicedb_kubeapi_proxy_tpu_torch.ops.graph_compile import (
        PExclude, PIntersect, PRead, PUnion, PZero)
    rng = np.random.default_rng(lanes)
    half = 1 << (-(-lanes // 32) - 1).bit_length()
    nt = 3_000
    x = _rand(rng, (nt, 2 * half))
    x[:, half:] |= x[:, :half]
    kernels.reset_launches()
    idx = torch.from_numpy(rng.integers(0, nt, (nt - 7, 8))
                           .astype(np.int32)).cuda()
    a, b = x.clone(), x.clone()
    x_in = _rand(rng, (nt, 2 * half))
    kernels.cav_gather_or(a, x_in, idx, half)
    reference.cav_gather_or(b, x_in, idx, half)
    assert torch.equal(a, b) and not torch.equal(a, x)

    expr = PUnion((PExclude(PIntersect((PRead(0, 500), PRead(500, 500))),
                            PRead(1000, 500)),
                   PExclude(PRead(1500, 500), PZero(500))))
    x0 = _rand(rng, (nt, 2 * half))
    for off, in_place in ((2000, True), (500, False)):
        code, _, self_read = compile_perm_program(expr, off, 500)
        code = torch.from_numpy(code).cuda()
        a, b = x.clone(), x.clone()
        kernels.perm_program(a, x0, code, off, 500, in_place=not self_read,
                             half=half)
        reference.perm_program(b, x0, code, off, 500, half=half)
        assert torch.equal(a, b)
        assert self_read == (not in_place)

    gi = torch.from_numpy(rng.integers(0, nt, 5_000).astype(np.int32)).cuda()
    gc = torch.from_numpy(rng.integers(0, lanes, 5_000).astype(np.int32)).cuda()
    got = kernels.check_gather3(x, gi, gc, half)
    assert torch.equal(got, reference.check_gather3(x, gi, gc, half))
    assert set(got.unique().tolist()) == {0, 1, 2}

    q = torch.from_numpy(rng.integers(0, nt - 1, 32 * half)
                         .astype(np.int32)).cuda()
    wc = torch.tensor([[0, 700], [700, 2_999]], dtype=torch.int32,
                      device="cuda")
    live_k = torch.empty((2, 2 * half), dtype=torch.int32, device="cuda")
    live_t = torch.empty_like(live_k)
    s_k = kernels.seed_bitplanes(q, nt, half, nt - 1, wc_ranges=wc,
                                 live=live_k, planes=True)
    s_t = reference.seed_bitplanes(q, nt, half, nt - 1, wc_ranges=wc,
                                   live=live_t, planes=True)
    assert torch.equal(s_k, s_t) and torch.equal(live_k, live_t)
    assert torch.equal(kernels.lookup_T(x, 100, 900, half),
                       reference.lookup_T(x, 100, 900, half))
    for name in ("cav_gather_or", "perm_program", "check_gather3",
                 "seed_bitplanes", "lookup_T"):
        assert kernels.LAUNCHES[name] > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [33, 256])
def test_every_plane_sweep_step_matches_its_twin(lanes):
    """The Jacobi sweep of a caveated graph, step by step, on the card
    and on the twins; then the card's and the CPU's endpoints agree."""
    _needs_card()
    w = workloads.caveated_rbac(n_pods=2_000, n_users=1_500, n_groups=40)
    g_cpu, g = _graphs(w.schema_text, w.relationships)
    assert g.has_cav and g.kernel.planes
    kc, prog = g.kernel, g.prog
    main, aux, cav = g.snapshot()
    rng = np.random.default_rng(lanes)
    n_words = 1 << (-(-lanes // 32) - 1).bit_length()
    q = np.full(32 * n_words, prog.dead_index, np.int32)
    q[:lanes] = rng.integers(0, prog.dead_index, lanes)
    qd = torch.from_numpy(q).cuda()
    nt = prog.state_size + kc.n_aux_rows
    x0 = kernels.seed_bitplanes(qd, nt, n_words, prog.dead_index, planes=True)
    x = x0.clone()
    for _ in range(3):
        a, b = x.clone(), x.clone()
        for step in kc.sweep_steps(main, aux, cav, n_words):
            EllKernelCache.run_step(step, a, x0, None, kernels, x_in=x)
            EllKernelCache.run_step(step, b, x0, None, reference, x_in=x)
            torch.cuda.synchronize()
            assert torch.equal(a, b), step[0]
        assert kernels.sweep_delta(a, x, prog.dead_index).tolist() == \
            reference.sweep_delta(b, x, prog.dead_index).tolist()
        x = a
    users = [u for u in w.subjects[:lanes]]
    q_arr = np.full(32 * n_words, prog.dead_index, np.int32)
    q_arr[:lanes] = [prog.subject_index("user", u) for u in users]
    pods = prog.slot_range("pod", "view")
    gi = (pods[0] + rng.integers(0, pods[1], 4_000)).astype(np.int32)
    gc = rng.integers(0, lanes, 4_000).astype(np.int32)
    out, tel = g.run_checks3_device(q_arr, gi, gc)[:2]
    out_c, tel_c = g_cpu.run_checks3_device(q_arr, gi, gc)[:2]
    assert torch.equal(out.cpu(), out_c) and np.array_equal(tel, tel_c)
    words, tel = g.run_lookup_packed_T_device(*pods, q_arr)[:2]
    words_c, tel_c = g_cpu.run_lookup_packed_T_device(*pods, q_arr)[:2]
    assert torch.equal(words.cpu(), words_c) and np.array_equal(tel, tel_c)


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("g", [0, 1, 45, 4_096, 10_000])
def test_sweep_delta_checks_matches_its_twin(planes, g):
    """The fused sweep tail (delta pair and packed check answers) against
    its twin on the same card tensors, bit for bit, and its pinned host
    copy against the device buffer."""
    _needs_card()
    rng = np.random.default_rng(g)
    nt, half, cap = 5_003, 8, 16_384
    width = 2 * half if planes else half
    x = torch.from_numpy(rng.integers(-2**31, 2**31, (nt, width),
                                      dtype=np.int64).astype(np.int32))
    x_old = x.clone()
    x_old[rng.integers(0, nt, 300)] ^= 1 << 31
    tail = np.zeros(2 + 2 * cap, np.int32)
    tail[0] = g
    tail[2::2] = rng.integers(0, nt, cap)
    tail[3::2] = rng.integers(0, 32 * half, cap)
    tail[2:200:2] = nt - 1       # slots on the dead row read zero
    words = 4 + cap // 32 * (2 if planes else 1)
    a, b = x.cuda(), x.clone().cuda()
    xo, t = x_old.cuda(), torch.from_numpy(tail).cuda()
    out_k = torch.full((words,), -1, dtype=torch.int32, device="cuda")
    out_k[:4] = 0
    out_t = out_k.clone()
    host = torch.zeros(words, dtype=torch.int32, pin_memory=True)
    a[nt - 1] = 7                # the kernel zeroes the dead row
    kernels.reset_launches()
    for slot in (0, 1):          # slot 0 zeroes slot 1 for the next sweep
        kernels.sweep_delta_checks(a, xo, nt - 1, t, out_k,
                                   half=half if planes else None, host=host,
                                   slot=slot)
    reference.sweep_delta_checks(b, xo, nt - 1, t, out_t,
                                 half=half if planes else None, slot=1)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sweep_delta_checks"] == 2
    assert torch.equal(a, b) and not a[nt - 1].any()
    assert torch.equal(out_k, out_t)
    assert torch.equal(host, out_k.cpu())
    if g:
        gi, gc = t[2:2 + 2 * g:2].contiguous(), t[3:3 + 2 * g:2].contiguous()
        v = (kernels.check_gather3(a, gi, gc, half) if planes
             else kernels.check_gather(a, gi, gc)).cpu().numpy()
        h = host.numpy()
        d = np.unpackbits(h[4:4 + cap // 32].view(np.uint8),
                          bitorder="little")[:g]
        m = (np.unpackbits(h[4 + cap // 32:].view(np.uint8),
                           bitorder="little")[:g] if planes else 0)
        assert np.array_equal(v, 2 * d + m)


@pytest.mark.cuda
@pytest.mark.parametrize("caveated", [False, True])
def test_replayed_checks_ride_the_sweep_tail(caveated):
    """A warm check batch on the card: every sweep a graph replay whose
    tail gathers the answers, no standalone gather launched and no
    readback started for them; the answers equal `check_gather(3)` on the
    final state and the CPU endpoint's."""
    _needs_card()
    import asyncio
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, SubjectRef)
    w = (workloads.caveated_rbac(n_pods=2_000, n_users=1_500, n_groups=40)
         if caveated else workloads.rbac_deny(n_pods=2_000, n_users=1_500,
                                              n_groups=20))
    bs = Bootstrap(w.schema_text, "\n".join(w.relationships))
    eps = [create_endpoint(f"torch://?device={d}&dispatch=direct", bs,
                           leopard=False) for d in ("cpu", "cuda")]
    g = eps[1].graph()
    rng = np.random.default_rng(4)
    pods = [p for p in g.prog.object_ids["pod"] if "\x00" not in p]
    subs = [SubjectRef("user", u) for u in w.subjects[:200]]
    reqs = [CheckRequest(ObjectRef("pod", pods[int(i)]), "view",
                         subs[j % len(subs)])
            for j, i in enumerate(rng.integers(0, len(pods), 5_000))]
    asyncio.run(eps[1].check_bulk_permissions(reqs))    # captures
    kernels.reset_launches()
    st0, rb0 = dict(g.kernel.graph_stats), eps[1].stats["readbacks"]
    got = asyncio.run(eps[1].check_bulk_permissions(reqs))
    want = asyncio.run(eps[0].check_bulk_permissions(reqs))
    assert [r.permissionship for r in got] == [r.permissionship for r in want]
    sweeps = int(g.last_trace[0])
    st = {k: g.kernel.graph_stats[k] - st0[k] for k in st0}
    assert st["captures"] == st["eager_sweeps"] == 0
    assert st["replays"] == sweeps
    assert kernels.LAUNCHES["sweep_delta_checks"] == sweeps
    assert kernels.LAUNCHES["check_gather"] == 0
    assert kernels.LAUNCHES["check_gather3"] == 0
    assert kernels.LAUNCHES["sweep_delta"] == 0
    assert eps[1].stats["readbacks"] == rb0
    # the same slots gathered from the converged state, standalone
    q_arr, cols, _ = eps[1]._encode_subjects(g, subs)
    gi = [g.prog.state_index("pod", "view", r.resource.id) for r in reqs]
    gc = [cols[r.subject] for r in reqs]
    n_words = len(q_arr) // 32
    main, aux, cav = g.snapshot()
    out, _ = g.kernel.checks_device(q_arr, n_words, gi, gc, main, aux, cav)
    x, _ = g.kernel.evaluate(torch.from_numpy(q_arr).cuda(), n_words, main,
                             aux, g.kernel.take_arena(n_words), cav)
    gi_d = torch.tensor(gi, dtype=torch.int32, device="cuda")
    gc_d = torch.tensor(gc, dtype=torch.int32, device="cuda")
    alone = (kernels.check_gather3(x, gi_d, gc_d, n_words) if caveated
             else kernels.check_gather(x, gi_d, gc_d))
    assert torch.equal(out, alone.cpu())


def _edge_arrays(case: str, rng, n: int, dead: int) -> tuple:
    """int32 (src, dst) numpy edge arrays of one `test_edge_or_matches_its_
    twin` case; padding edges are (dead, dead) as the build lays them."""
    if case == "random":            # heavy duplicate destinations, any order
        src = rng.integers(0, dead, 150_000).astype(np.int32)
        dst = rng.integers(0, 500, 150_000).astype(np.int32)
        src[-50_000:] = dst[-50_000:] = dead
        return src, dst
    if case in ("runs", "offset_view"):
        # sorted destinations in runs that end inside a lane, a warp and a
        # block, and cross all of them (4 edges a thread, 256 threads)
        lengths = [1, 31, 33, 4_097, 100_000, 1, 2, 3, 5, 129, 1_025]
        dst = np.concatenate([np.full(k, i * 7 % dead, np.int32)
                              for i, k in enumerate(lengths)])
        dst = np.sort(dst)
        src = rng.integers(0, dead, dst.size).astype(np.int32)
        src[::5] = dead             # dead sources inside live runs
        pad = np.full(3_001, dead, np.int32)
        return np.concatenate([src, pad]), np.concatenate([dst, pad])
    if case == "unsorted_tail":     # as after churn: inserts in free slots
        e = 120_000
        dst = np.sort(rng.integers(0, dead, e)).astype(np.int32)
        src = rng.integers(0, dead, e).astype(np.int32)
        src[60_000:110_000] = dst[60_000:110_000] = dead
        tail = slice(e - 10_000, e)
        src[tail] = rng.integers(0, dead, 10_000)
        dst[tail] = rng.integers(0, dead, 10_000)
        return src, dst
    if case == "all_padding":
        return np.full(40_003, dead, np.int32), np.full(40_003, dead, np.int32)
    if case == "duplicates":        # every edge 9 times over, runs of 9+
        src = np.repeat(rng.integers(0, dead, 4_000), 9).astype(np.int32)
        dst = np.repeat(np.sort(rng.integers(0, 700, 4_000)), 9) \
            .astype(np.int32)
        return src, dst
    assert case == "nonzero_dead"
    dst = np.sort(rng.integers(0, dead, 50_000)).astype(np.int32)
    src = rng.integers(0, dead, 50_000).astype(np.int32)
    src[::3] = dead
    return src, dst


def _off16(t: torch.Tensor, k: int) -> torch.Tensor:
    """A copy of `t` whose data starts `k` words past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    b = (-(flat.data_ptr() // 4)) % 4
    v = flat[b + k: b + k + t.numel()].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("case", ["random", "runs", "unsorted_tail",
                                  "all_padding", "duplicates",
                                  "offset_view", "nonzero_dead"])
def test_edge_or_matches_its_twin(case, w):
    """The segment sweep's edge pass against its twin on random states
    (bit 31 live): destination runs that cross lanes, warps and blocks, a
    sorted array with an unsorted tail, all padding, duplicate edges,
    state and edge views one word off 16 bytes, W = 1 to 16.  The kernel
    skips the dead row's edges; with a non-zero dead row it equals the
    twin on that row zeroed (the skip is exact only under the callers'
    invariant that the row is zero), and with `dead=None` the twin as
    it is."""
    _needs_card()
    rng = np.random.default_rng(w * 10 + len(case))
    n = 20_000
    dead = n - 1
    x = _rand(rng, (n, w))
    if case != "nonzero_dead":
        x[dead] = 0
    y = _rand(rng, (n, w))
    y[dead] = 0
    src, dst = _edge_arrays(case, rng, n, dead)
    src_t, dst_t = torch.from_numpy(src).cuda(), torch.from_numpy(dst).cuda()
    if case == "offset_view":
        x, y = _off16(x, 1), _off16(y, 3)
        src_t, dst_t = _off16(src_t, 2), _off16(dst_t, 1)
    kernels.reset_launches()
    a, b = (_off16(y, 3) if case == "offset_view" else y.clone()), y.clone()
    kernels.edge_or(a, x, src_t, dst_t, dead=dead)
    x_twin = x.clone()
    x_twin[dead] = 0
    reference.edge_or(b, x_twin, src_t, dst_t)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert kernels.LAUNCHES["edge_or"] == 1
    if case == "all_padding":
        assert torch.equal(a, y)
    else:
        assert not torch.equal(a, y) and bool((a < 0).any())
    if case == "nonzero_dead":
        a, b = y.clone(), y.clone()
        kernels.edge_or(a, x, src_t, dst_t)
        reference.edge_or(b, x, src_t, dst_t)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
    if case == "random":
        assert not bool(a[dead].any())
        with pytest.raises(kernels.KernelError):
            kernels.edge_or(x, x, src_t, dst_t)
        with pytest.raises(kernels.KernelError):
            kernels.edge_or(a, x, src_t, dst_t, dead=n)


@pytest.mark.cuda
@pytest.mark.parametrize("wc", [63, 64, 65])
@pytest.mark.parametrize("rows", [1, 1_000, 5_013])
def test_word_cols_T_matches_its_twin(rows, wc):
    """Closure-plane word columns against the twin: 1 and 7 words (the
    column read), all words and repeated words (the tiled read), odd and
    even widths (the tile's pitch is padded for an even one), row counts
    that are no multiple of the 16-row tile, a plane taller than the rows
    read, and a plane view one word off 16 bytes."""
    _needs_card()
    rng = np.random.default_rng(rows + wc)
    plane = _rand(rng, (rows + 7, wc))
    sets = ([0, wc - 1, 5, 5, 31], list(range(wc)), [7],
            list(range(wc - 7, wc)), list(range(wc))[::-1] * 2,
            [int(v) for v in rng.integers(0, wc, 40)])
    kernels.reset_launches()
    for p in (plane, _off16(plane, 1)):
        for words in sets:
            wt = torch.tensor(words, dtype=torch.int32, device="cuda")
            got = kernels.word_cols_T(p, rows, wt)
            assert got.shape == (len(words), rows) and got.is_contiguous()
            assert torch.equal(got, reference.word_cols_T(p, rows, wt))
    assert kernels.LAUNCHES["word_cols_T"] == 2 * len(sets)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [8, 33, 256])
def test_every_segment_sweep_step_matches_its_twin(lanes):
    """The segment sweep of a card graph, step by step, against the
    twins; then the card's and the CPU's segment endpoints agree."""
    _needs_card()
    schema, rels = _workload()
    bs = Bootstrap(schema, "\n".join(rels))
    g_cpu, g = [create_endpoint(f"torch://?device={d}", bs,
                                kernel="segment", leopard=False).graph()
                for d in ("cpu", "cuda")]
    kc, prog = g.kernel, g.prog
    src, dst = g.snapshot()
    rng = np.random.default_rng(lanes)
    w = 1 << (-(-lanes // 32) - 1).bit_length()
    q = np.full(32 * w, prog.dead_index, np.int32)
    q[:lanes] = rng.integers(0, prog.dead_index, lanes)
    qd = torch.from_numpy(q).cuda()
    x0, live = kc.init_state(qd, w)
    x = x0.clone()
    for _ in range(3):
        a, b = torch.empty_like(x), torch.empty_like(x)
        for step in kc.sweep_steps(src, dst):
            kc.run_step(step, a, x, x0, live, kernels)
            kc.run_step(step, b, x, x0, live, reference)
            torch.cuda.synchronize()
            assert torch.equal(a, b), step[0]
        assert kernels.sweep_delta(a, x, prog.dead_index).tolist() == \
            reference.sweep_delta(b, x, prog.dead_index).tolist()
        x = a
    off, length = prog.slot_range("pod", "view")
    words, tel = g.run_lookup_packed_T_device(off, length, q)[:2]
    words_c, tel_c = g_cpu.run_lookup_packed_T_device(off, length, q)[:2]
    assert torch.equal(words.cpu(), words_c) and np.array_equal(tel, tel_c)


@pytest.mark.cuda
def test_card_and_cpu_agree_on_the_leopard_plane():
    """Group-explosion at a small size: the card endpoint serves from its
    closure plane and answers as the CPU one does."""
    _needs_card()
    import asyncio

    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, SubjectRef)
    w = workloads.group_explosion(n_groups=800, n_users=64, n_docs=200)
    bs = Bootstrap(w.schema_text, "\n".join(w.relationships))
    eps = [create_endpoint(f"torch://?device={d}", bs) for d in ("cpu",
                                                                  "cuda")]
    subs = [SubjectRef("user", u) for u in w.subjects]
    reqs = [CheckRequest(ObjectRef("doc", f"d{i}"), "view", s)
            for i in range(200) for s in subs[:8]]
    kernels.reset_launches()
    out = [(asyncio.run(ep.lookup_resources_batch("doc", "view", subs)),
            [c.allowed for c in asyncio.run(ep.check_bulk_permissions(reqs))])
           for ep in eps]
    assert [sorted(x) for x in out[0][0]] == [sorted(x) for x in out[1][0]]
    assert out[0][1] == out[1][1] and any(out[1][1])
    assert kernels.LAUNCHES["word_cols_T"] == 1
    assert kernels.LAUNCHES["check_gather"] == 1
    assert kernels.LAUNCHES["sweep_delta"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (4_099, 8), (100_000, 4)])
@pytest.mark.parametrize("g", [2, 3, 4, 8])
def test_or_combine_matches_its_twin(g, shape):
    """The OR all-reduce of G replicas in one launch on random words (bit
    31 live): every replica ends at the twin's OR, through the 16-byte
    path and its scalar tail (n % 4 != 0), and through the scalar path
    when the replicas are views one word off 16 bytes; more than
    MAX_OR_PARTS replicas, or two that share memory, are refused."""
    _needs_card()
    rng = np.random.default_rng(g * 1_000 + shape[0])
    n = shape[0] * shape[1]
    kernels.reset_launches()
    for off in (0, 1):
        bufs = [_rand(rng, (n + off,)) for _ in range(g)]
        parts = [b[off:].view(shape) for b in bufs]
        twin = [p.clone() for p in parts]
        want = twin[0].clone()
        for t in twin[1:]:
            want |= t
        kernels.or_combine(parts)
        reference.or_combine(twin)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(parts, twin))
        assert all(torch.equal(a, want) for a in parts)
    assert kernels.LAUNCHES["or_combine"] == 2
    with pytest.raises(kernels.KernelError):
        kernels.or_combine([_rand(rng, shape)
                            for _ in range(kernels.MAX_OR_PARTS + 1)])
    a = _rand(rng, (2 * n,))
    for alias in ([parts[0], parts[0]],
                  [a[:n].view(shape), a[n - 1: 2 * n - 1].view(shape)]):
        with pytest.raises(kernels.KernelError):
            kernels.or_combine(parts[1:] + alias)
    assert kernels.LAUNCHES["or_combine"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("half", [1, 2, 3, 4, 8, 16])
def test_cav_gather_or_block_form_matches_its_twin(half):
    """The mesh shard's form: one row block of the caveat table ORed into
    the maybe words of rows [dst_lo, dst_lo + R) of the state, and the
    whole table (dst_lo 0).  The kernel skips the dead row's gathers; the
    twin does not, and the dead row of x_in is zero as the sweep keeps
    it.  The table has holes mid-row, all-dead rows and rows that read
    the live rows next to the dead row (whose words are not zero).  A
    table narrower than K_CAV, and one whose rows are not 16-byte
    aligned, are refused."""
    _needs_card()
    k = kernels.K_CAV
    rng = np.random.default_rng(half * 10 + k)
    nt = 4_000
    dead = nt - 500
    x = _rand(rng, (nt, 2 * half))
    x_in = _rand(rng, (nt, 2 * half))
    x_in[dead] = 0
    blk = nt // 4
    host = np.full((nt, k), dead, np.int32)
    live = rng.random((nt, k)) < 0.2
    host[live] = rng.integers(0, nt, int(live.sum()))
    host[::5] = dead                                   # all-dead rows
    host[1::9, :3] = [dead - 1, dead, dead + 1]
    assert (host == dead).any(axis=1).mean() > 0.5
    kernels.reset_launches()
    for dst_lo, idx in ((0, host), (0, host[:blk]), (1_000, host[:blk]),
                        (nt - blk, host[blk: 2 * blk])):
        idx = torch.from_numpy(np.ascontiguousarray(idx)).cuda()
        r = idx.shape[0]
        a, b = x.clone(), x.clone()
        kernels.cav_gather_or(a, x_in, idx, half, dst_lo=dst_lo, dead=dead)
        reference.cav_gather_or(b, x_in, idx, half, dst_lo=dst_lo, dead=dead)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        assert not torch.equal(a, x)
        outside = torch.ones(nt, dtype=torch.bool, device="cuda")
        outside[dst_lo: dst_lo + r] = False
        assert torch.equal(a[outside], x[outside])
        assert torch.equal(a[:, :half], x[:, :half])
    with pytest.raises(kernels.KernelError):
        kernels.cav_gather_or(x.clone(), x_in, idx, half, dst_lo=nt - 10,
                              dead=dead)
    flat = torch.from_numpy(host[:blk].ravel()).cuda()
    for bad in (idx[:, :3], flat[1: 1 + (blk - 1) * k].view(blk - 1, k)):
        with pytest.raises(kernels.KernelError):
            kernels.cav_gather_or(x.clone(), x_in, bad, half, dead=dead)
    assert kernels.LAUNCHES["cav_gather_or"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", ["1x2", "2x4"])
def test_mesh_endpoint_on_the_card_agrees_with_the_cpu(mesh):
    """A mesh of shards co-located on one card answers as the same mesh on
    the CPU twins and as the single-device endpoint, with every per-shard
    kernel launched and the caveat path in play."""
    _needs_card()
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        TorchEndpoint)
    from spicedb_kubeapi_proxy_tpu_torch.parallel.sharding import make_mesh
    from spicedb_kubeapi_proxy_tpu_torch.spicedb import schema as sch
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, SubjectRef)
    w = workloads.caveated_rbac(n_pods=400, n_users=300, n_groups=10)
    d, g = (int(v) for v in mesh.split("x"))
    eps = []
    for dev in ("cpu", "cuda"):
        ep = TorchEndpoint(sch.parse_schema(w.schema_text), device=dev,
                           mesh=make_mesh([dev] * (d * g), data=d, graph=g),
                           leopard=False)
        ep.store.bulk_load_text("\n".join(w.relationships))
        eps.append(ep)
    single = create_endpoint("torch://", Bootstrap(
        w.schema_text, "\n".join(w.relationships)))
    subs = [SubjectRef("user", u) for u in w.subjects[:70]]
    pods = single.graph().prog.object_ids["pod"][:200]
    reqs = [CheckRequest(ObjectRef("pod", p), "view", subs[i % 70])
            for i, p in enumerate(pods)]
    kernels.reset_launches()
    import asyncio
    out = []
    for ep in eps + [single]:
        look = asyncio.run(ep.lookup_resources_batch("pod", "view", subs))
        chk = asyncio.run(ep.check_bulk_permissions(reqs))
        out.append(([sorted(x) for x in look],
                    [c.permissionship for c in chk]))
    assert out[0] == out[1] == out[2]
    assert eps[1]._graph.kernel.planes
    # the single-device endpoint's kernels, and the mesh sweep's own
    for name in ("ell_gather_or", "perm_program", "sweep_delta_checks",
                 "seed_bitplanes", "check_gather3", "lookup_T",
                 "cav_gather_or", "mesh_gather_or", "mesh_cav_gather_or",
                 "mesh_perm_program", "mesh_sweep_delta"):
        assert kernels.LAUNCHES[name] > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("workload", ["caveated", "groups"])
def test_mesh_across_cards_agrees_with_the_cpu(mesh, workload):
    """Shards on distinct cards (`torch://?mesh=DxG` takes the first D*G):
    each kernel launches on its shard's card and the collectives copy
    between cards.  Answers before and after a write flushed into the
    blocks equal the co-located CPU mesh's and the single-device
    endpoint's; with the index on, the Leopard plane's blocks sit on
    the graph shards' cards.  ShardedKernel (the edge-sharded sweep with
    its OR all-reduce) answers as on the CPU."""
    _needs_card()
    d, g = (int(v) for v in mesh.split("x"))
    if torch.cuda.device_count() < d * g:
        pytest.skip(f"needs {d * g} CUDA devices (one shard a card)")
    import asyncio

    from spicedb_kubeapi_proxy_tpu_torch.parallel.sharding import (
        ShardedKernel, make_mesh)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, RelationshipUpdate, SubjectRef, UpdateOp,
        parse_relationship)
    if workload == "caveated":
        w = workloads.caveated_rbac(n_pods=400, n_users=300, n_groups=10)
        rtype, perm = "pod", "view"
    else:
        w = workloads.group_explosion(n_groups=400, n_users=100, n_docs=300,
                                      depth=4)
        rtype, perm = "doc", "view"
    bs = Bootstrap(w.schema_text, "\n".join(w.relationships))
    eps = [create_endpoint(f"torch://?mesh={mesh}&device=cpu", bs),
           create_endpoint(f"torch://?mesh={mesh}", bs),
           create_endpoint("torch://", bs)]
    cards = [torch.device("cuda", i) for i in range(d * g)]
    assert [dev for row in eps[1].mesh.devices for dev in row] == cards
    subs = [SubjectRef("user", u) for u in w.subjects[:70]]
    objs = eps[2].graph().prog.object_ids[rtype][:200]
    reqs = [CheckRequest(ObjectRef(rtype, o), perm, subs[i % 70])
            for i, o in enumerate(objs) if "\x00" not in o]

    def answers():
        out = []
        for ep in eps:
            look = asyncio.run(ep.lookup_resources_batch(rtype, perm, subs))
            chk = asyncio.run(ep.check_bulk_permissions(reqs))
            out.append(([sorted(x) for x in look],
                        [c.permissionship for c in chk]))
        assert out[0] == out[1] == out[2]
        return out[0]

    kernels.reset_launches()
    answers()
    assert sum(kernels.LAUNCHES.values()) > 0
    if workload == "groups":
        frag = eps[1]._leopard.lookup_frag("doc", "view")
        assert frag is not None and \
            [b.device for b in frag.plane] == cards[:g]
    else:
        assert eps[1].graph().kernel.planes
    # a membership write for a queried subject, absorbed by every
    # endpoint (three stores) and flushed into the mesh's blocks
    member = next(r for r in w.relationships if "#member@user:" in r)
    rel = member.split("@")[0] + "@user:" + w.subjects[0]
    for ep in eps:
        ep.store.write([RelationshipUpdate(UpdateOp.TOUCH,
                                           parse_relationship(rel))])
    answers()
    assert eps[1].stats["rebuilds"] == eps[2].stats["rebuilds"]

    prog = eps[2].graph().prog
    q = np.random.default_rng(5).integers(0, prog.dead_index, 37) \
        .astype(np.int32)
    off, length = prog.slot_range(rtype, perm)
    gi = np.random.default_rng(6).integers(0, prog.state_size, 300) \
        .astype(np.int32)
    gc = np.random.default_rng(7).integers(0, 37, 300).astype(np.int32)
    got = []
    for devs in (["cpu"] * (d * g), cards):
        sk = ShardedKernel(prog, make_mesh(devs, data=d, graph=g))
        src, dst = sk.device_edges()
        got.append((np.asarray(sk.lookup(off, length, q, src, dst)),
                    np.asarray(sk.checks(q, gi, gc, src, dst))))
    assert np.array_equal(got[0][0], got[1][0])
    assert np.array_equal(got[0][1], got[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
@pytest.mark.parametrize("workload", ["caveated", "groups"])
def test_mesh_across_processes_agrees_with_the_cpu(mesh, workload, tmp_path):
    """Four ranks of one NCCL process group, a card each
    (`torch://?distributed=1&mesh=DxG`, tests/torch_dist_rank.py): every
    rank answers as the co-located CPU mesh in one process, before and
    after a write every rank applies, sweep traces included; the sharded
    ELL kernel alone gives the same lookup words, checks and traces, and
    ShardedKernel (the OR all-reduce over gathered partials) the same
    answers.  Each rank has its own timeout."""
    _needs_card()
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices (one rank a card)")
    import torch_dist_rank as tdr
    if workload == "caveated":
        w = workloads.caveated_rbac(n_pods=400, n_users=300, n_groups=10)
    else:
        w = workloads.group_explosion(n_groups=400, n_users=100, n_docs=300,
                                      depth=4)
    member = next(r for r in w.relationships if "#member@user:" in r)
    writes = [("touch", member.split("@")[0] + "@user:" + w.subjects[0])]
    spec = tdr.make_spec(w.schema_text, w.relationships, w.resource_type,
                         w.permission, w.subjects[:70], writes, mesh,
                         n_objs=200)
    kernels.build()
    one = tdr.drive_in_process(spec)
    ranks = tdr.spawn(spec, 4, tmp_path, device="cuda", timeout=180)
    for r in ranks:
        assert r["world"] == 4
        for got, want in zip(r["reads"], one["reads"]):
            assert got == want
        assert r["rebuilds"] == one["rebuilds"]
        assert r["planes"] == one["planes"] == (workload == "caveated")
        k = dict(r["kernel"])
        assert k.pop("local_shards") == 1
        assert k == {key: v for key, v in one["kernel"].items()
                     if key != "local_shards"}
        if "segment" in spec:
            assert r["segment"] == one["segment"]
            assert r["collectives"]["or_allreduce"]["xrank_calls"] > 0
        c = r["collectives"]
        assert c["reduce_sweep_deltas"]["xrank_calls"] == \
            c["reduce_sweep_deltas"]["calls"] > 0
        assert c["all_gather_rows"]["xrank_calls"] > 0
        for name in ("mesh_gather_or", "mesh_perm_program",
                     "mesh_sweep_delta", "seed_bitplanes"):
            assert r["launches"].get(name), (name, r["launches"])
        # refused before any request: what would reorder the collectives
        assert "Leopard" in r["refused"]["leopard"]
        assert "dispatch=direct" in r["refused"]["dispatch"]
        assert "decision cache" in r["refused"]["cache"]
    # the readout runs on each data shard's owner, (d, 0)'s rank
    d, g = (int(v) for v in mesh.split("x"))
    check = "check_gather3" if workload == "caveated" else "check_gather"
    for name in ("lookup_T", check):
        assert {r["rank"] for r in ranks if r["launches"].get(name)} == \
            {i * g for i in range(d)}, name


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["scratch", "in_place", "x_in"])
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("w", [1, 2, 3, 4, 8, 16])
def test_gather_modes_match_the_twin(w, seeded, mode):
    """`ell_gather_or` (16-byte chunks where W % 4 == 0, else 4-byte)
    against its twin at K of 0-4 and 32, with wildcard bits, through
    scratch, in place (a table that reads no row of its range) and with
    the range's own rows read from an input buffer; a misaligned state
    view takes the 4-byte path."""
    _needs_card()
    rng = np.random.default_rng(100 * w + 10 * seeded + len(mode))
    nt, lo, n = 5_000, 1_200, 2_777
    kernels.reset_launches()
    for k in (0, 1, 2, 3, 4, 32):
        cur, x0 = _rand(rng, (nt, w)), _rand(rng, (nt, w))
        pool = (np.r_[0:lo, lo + n:nt] if mode == "in_place"
                else np.arange(nt))
        idx = torch.from_numpy(rng.choice(pool, (n, k)).astype(np.int32))
        idx = idx.cuda()
        x_in = None
        if mode == "x_in":
            x_in = _rand(rng, (nt, w))
            x_in[lo: lo + n] = cur[lo: lo + n]
        bits = torch.from_numpy(rng.integers(0, 8, n).astype(np.int32)).cuda()
        live = _rand(rng, (3, w))
        a, b = cur.clone(), cur.clone()
        args = (x0 if seeded else None, bits, live)
        kernels.ell_gather_or(a, idx, lo, *args, in_place=mode == "in_place",
                              x_in=x_in)
        reference.ell_gather_or(b, idx, lo, *args,
                                in_place=mode == "in_place", x_in=x_in)
        torch.cuda.synchronize()
        assert torch.equal(a, b), k
    assert kernels.LAUNCHES["ell_gather_or"] == 6
    base = _rand(rng, (nt * w + 1,))
    view = base[1:].view(nt, w)
    idx = torch.from_numpy(rng.integers(0, nt, (n, 2)).astype(np.int32)).cuda()
    b = view.clone()
    kernels.ell_gather_or(view, idx, lo)
    reference.ell_gather_or(b, idx, lo)
    assert torch.equal(view, b)


def _random_program(rng, offs, length, depth):
    from spicedb_kubeapi_proxy_tpu_torch.ops.graph_compile import (
        PExclude, PIntersect, PRead, PUnion, PZero)
    if depth == 0 or rng.random() < 0.3:
        if rng.random() < 0.1:
            return PZero(length)
        return PRead(int(rng.choice(offs)), length)
    kind = int(rng.integers(0, 3))
    if kind == 0:
        return PUnion(tuple(_random_program(rng, offs, length, depth - 1)
                            for _ in range(int(rng.integers(2, 5)))))
    if kind == 1:
        return PIntersect(tuple(_random_program(rng, offs, length, depth - 1)
                                for _ in range(int(rng.integers(2, 4)))))
    return PExclude(_random_program(rng, offs, length, depth - 1),
                    _random_program(rng, offs, length, depth - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("w", [1, 3, 8, 16])
def test_perm_program_matches_the_twin(w, planes):
    """Random programs (self-reading ones, a 16-deep stack) in place
    against the out-of-place twin, definite and planes, at the register
    stack of 4 and of 16; and through scratch."""
    _needs_card()
    from spicedb_kubeapi_proxy_tpu_torch.ops.ell import compile_perm_program
    from spicedb_kubeapi_proxy_tpu_torch.ops.graph_compile import (
        PRead, PUnion)
    if planes and w % 2:
        pytest.skip("a plane row has an even width")
    rng = np.random.default_rng(w + 50 * planes)
    length, n_slots = 3_001, 6
    offs = [i * length for i in range(n_slots)]
    half = w // 2 if planes else None
    kernels.reset_launches()
    for trial in range(12):
        out = int(rng.choice(offs))
        if trial == 0:
            expr = PRead(out, length)
            for i in range(15):
                expr = PUnion((PRead(offs[i % n_slots], length), expr))
        else:
            expr = _random_program(rng, offs, length, 4)
        code, depth, _ = compile_perm_program(expr, out, length)
        code = torch.from_numpy(code).cuda()
        cur = _rand(rng, (n_slots * length + 5, w))
        x0 = _rand(rng, cur.shape)
        want = cur.clone()
        reference.perm_program(want, x0, code, out, length, half=half)
        for in_place, d in ((True, depth), (True, None), (False, depth)):
            got = cur.clone()
            kernels.perm_program(got, x0, code, out, length,
                                 in_place=in_place, half=half, depth=d)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (trial, in_place, d)
    assert kernels.LAUNCHES["perm_program"] == 36


GROUP_HUB = ("definition user {}\ndefinition group {\n"
             "  relation member: user | group#member\n}\n"
             "definition namespace {\n"
             "  relation viewer: user | group#member\n"
             "  relation creator: user\n"
             "  permission view = viewer + creator\n}")


@pytest.mark.cuda
def test_graph_sweeps_equal_eager_sweeps_across_flushes():
    """`evaluate` (one CUDA graph replay a sweep) equals `_evaluate_eager`
    in state and trace: on the loaded tables, after a flush (which
    recaptures), and after a growth that flips a stage's aux refresh
    on.  Replays count their launches: a graph batch and an eager batch
    of the same sweeps add the same LAUNCHES."""
    _needs_card()
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        RelationshipUpdate, UpdateOp, parse_relationship)
    rels = [f"group:hub#member@user:h{i}" for i in range(40)]
    rels += ["namespace:ns#viewer@user:u0"]
    rels += [f"namespace:seed{i}#viewer@user:u{i}" for i in range(1, 12)]
    rels += [f"namespace:n{i}#viewer@group:hub#member" for i in range(5)]
    ep = create_endpoint("torch://", Bootstrap(GROUP_HUB, "\n".join(rels)))
    q = None

    def compare(tag):
        g = ep.graph()
        kc, prog = g.kernel, g.prog
        snap = g.snapshot()
        nonlocal q
        q = np.full(64, prog.dead_index, np.int32)
        q[:50] = np.random.default_rng(len(tag)).integers(
            0, prog.dead_index, 50)
        qd = torch.from_numpy(q).cuda()
        arena = kc.take_arena(2)
        stats0 = dict(kc.graph_stats)
        for _ in range(2):       # a capture, then a hit
            kernels.reset_launches()
            x_g, tr_g = kc.evaluate(qd, 2, snap[0], snap[1], arena,
                                    plan=snap.plan)
            x_g = x_g.clone()
            graph_launches = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        x_e, tr_e = kc._evaluate_eager(qd, 2, snap[0], snap[1],
                                       kc.take_arena(2), plan=snap.plan)
        assert torch.equal(x_g, x_e) and np.array_equal(tr_g, tr_e), tag
        assert graph_launches == kernels.LAUNCHES, tag
        sweeps = int(tr_g[0])
        assert kc.graph_stats["captures"] == stats0["captures"] + 1, tag
        assert kc.graph_stats["replays"] >= stats0["replays"] + 2 * sweeps - 1
        return g

    g = compare("loaded")
    _write = lambda ops: ep.store.write(
        [RelationshipUpdate(UpdateOp.TOUCH if o == "touch" else
                            UpdateOp.DELETE, parse_relationship(r))
         for o, r in ops])
    _write([("touch", "group:hub#member@user:u5"),
            ("delete", "group:hub#member@user:h3")])
    assert compare("flushed") is g
    flips = ep.stats["stage_aux_flips"]
    for j in range(1, 12):
        _write([("touch", f"namespace:ns#viewer@user:u{j}")])
    assert compare("grown") is g
    assert ep.stats["stage_aux_flips"] > flips
    assert ep.stats["rebuilds"] == 1


# -- the sharded ELL sweep's kernels (parallel/sharding.py) -----------------

def _offset(t: torch.Tensor, misaligned: bool) -> torch.Tensor:
    """`t` itself, or an equal tensor that starts 4 bytes into its
    storage (not 16-byte aligned)."""
    if not misaligned:
        return t
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _cpu_jobs(jobs):
    """The same jobs on CPU copies (the twin's), and the copies of their
    destinations to compare."""
    host = lambda t: None if t is None else t.cpu()
    out = [tuple(host(t) for t in job[:-1]) + ([d.cpu() for d in job[-1]],)
           for job in jobs]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("k", [2, 5, 32])
@pytest.mark.parametrize("w", [1, 3, 4, 8])
@pytest.mark.parametrize("mesh", [(1, 2), (2, 4)])
def test_mesh_gather_or_matches_its_twin(mesh, w, k, misaligned):
    """One launch over every shard block of a co-located D x G mesh, each
    block written into its data shard's G replicas: seeded with wildcard
    terms (a main gather) and not (an aux pass, rows past the split read
    from another buffer), 16-byte rows and odd widths, wide rows split
    over 4 lanes (K = 32) and not, aligned and not."""
    _needs_card()
    d_n, g_n = mesh
    rng = np.random.default_rng(w * 100 + k + 7 * misaligned + d_n)
    n, split, n_hi = 1_003, 4_019, 517
    for seeded in (False, True):
        jobs, reps = [], []
        for d in range(d_n):
            lo = _offset(_rand(rng, (split + 5, w)), misaligned)
            hi = _offset(_rand(rng, (n_hi, w)), misaligned)
            live = _rand(rng, (3, w)) if seeded else None
            seed = _rand(rng, (g_n * n, w)) if seeded else None
            rep = [_offset(_rand(rng, (g_n * n, w)), misaligned)
                   for _ in range(g_n)]
            reps += rep
            for g in range(g_n):
                idx = torch.from_numpy(rng.integers(
                    0, split + n_hi, (n, k)).astype(np.int32)).cuda()
                bits = (torch.from_numpy(rng.integers(0, 8, n).astype(
                    np.int32)).cuda() if seeded else None)
                jobs.append((_offset(idx, misaligned), lo, hi,
                             None if seed is None
                             else seed[g * n:(g + 1) * n], bits, live,
                             [r[g * n:(g + 1) * n] for r in rep]))
        twin = _cpu_jobs(jobs)
        kernels.reset_launches()
        kernels.mesh_gather_or(jobs, split)
        reference.mesh_gather_or(twin, split)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["mesh_gather_or"] == 1
        for job, tj in zip(jobs, twin):
            for a, b in zip(job[-1], tj[-1]):
                assert torch.equal(a.cpu(), b), (seeded, len(jobs))


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("half", [1, 3, 4, 8])
@pytest.mark.parametrize("mesh", [(1, 2), (2, 4)])
def test_mesh_cav_gather_or_matches_its_twin(mesh, half, misaligned):
    """The caveat gathers of every shard block in one launch, each nonzero
    OR read-modify-written into the maybe words of its data shard's G
    replicas (which differ, so each is its own read); the dead row's
    gathers skipped (its words zero), holes mid-row, all-dead rows."""
    _needs_card()
    d_n, g_n = mesh
    k = kernels.K_CAV
    rng = np.random.default_rng(half * 10 + d_n + 5 * misaligned)
    nt, r = 4_000, 1_000
    dead = nt - 300
    jobs = []
    for d in range(d_n):
        x_in = _rand(rng, (nt, 2 * half))
        x_in[dead] = 0
        x_in = _offset(x_in, misaligned)
        rep = [_offset(_rand(rng, (g_n * r, 2 * half)), misaligned)
               for _ in range(g_n)]
        for g in range(g_n):
            host = np.full((r, k), dead, np.int32)
            live = rng.random((r, k)) < 0.2
            host[live] = rng.integers(0, nt, int(live.sum()))
            host[::5] = dead
            jobs.append((torch.from_numpy(host).cuda(), x_in,
                         [t[g * r:(g + 1) * r] for t in rep]))
    twin = _cpu_jobs(jobs)
    kernels.reset_launches()
    kernels.mesh_cav_gather_or(jobs, half, dead)
    reference.mesh_cav_gather_or(twin, half, dead)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mesh_cav_gather_or"] == 1
    for job, tj in zip(jobs, twin):
        for a, b in zip(job[-1], tj[-1]):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("w", [1, 3, 8, 16])
@pytest.mark.parametrize("g", [2, 4])
def test_mesh_perm_program_matches_its_twin(g, w, planes, misaligned):
    """Random programs (a 16-deep stack among them) of one replica written
    into G replicas in place, definite and planes, at the register stack
    of 4 and of 16."""
    _needs_card()
    from spicedb_kubeapi_proxy_tpu_torch.ops.ell import compile_perm_program
    from spicedb_kubeapi_proxy_tpu_torch.ops.graph_compile import (
        PRead, PUnion)
    if planes and w % 2:
        pytest.skip("a plane row has an even width")
    rng = np.random.default_rng(w + 50 * planes + 7 * g + misaligned)
    length, n_slots = 3_001, 6
    offs = [i * length for i in range(n_slots)]
    half = w // 2 if planes else None
    kernels.reset_launches()
    for trial in range(6):
        out = int(rng.choice(offs))
        if trial == 0:
            expr = PRead(out, length)
            for i in range(15):
                expr = PUnion((PRead(offs[i % n_slots], length), expr))
        else:
            expr = _random_program(rng, offs, length, 4)
        code, depth, _ = compile_perm_program(expr, out, length)
        code = torch.from_numpy(code).cuda()
        cur = _offset(_rand(rng, (n_slots * length + 5, w)), misaligned)
        reps = [cur] + [_offset(_rand(rng, cur.shape), misaligned)
                        for _ in range(g - 1)]
        x0 = _rand(rng, cur.shape)
        twin = [t.cpu() for t in reps]
        kernels.mesh_perm_program(cur, x0, code, out, length, reps, half,
                                  depth)
        reference.mesh_perm_program(twin[0], x0.cpu(), code.cpu(), out,
                                    length, twin, half, depth)
        torch.cuda.synchronize()
        for a, b in zip(reps, twin):
            assert torch.equal(a.cpu(), b), trial
    assert kernels.LAUNCHES["mesh_perm_program"] == 6


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("w", [1, 3, 8])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_mesh_sweep_delta_matches_its_twin(g, w, misaligned):
    """One delta for a data shard's G replicas, accumulated into a slot of
    a shared tensor: the count (bit 31 in play), the flag, every
    replica's dead row zeroed, the rest untouched."""
    _needs_card()
    rng = np.random.default_rng(g * 10 + w + misaligned)
    nt, dead = 50_001, 49_000
    x_old = _offset(_rand(rng, (nt, w)), misaligned)
    reps = [_offset(_rand(rng, (nt, w)), misaligned) for _ in range(g)]
    twin = [t.cpu() for t in reps]
    out = torch.zeros((3, 2), dtype=torch.int32, device="cuda")
    out_t = out.cpu()
    for slot in (1, 1):
        kernels.mesh_sweep_delta(reps[0], x_old, dead, out[slot], reps)
        reference.mesh_sweep_delta(twin[0], x_old.cpu(), dead, out_t[slot],
                                   twin)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), out_t)
    for a, b in zip(reps, twin):
        assert torch.equal(a.cpu(), b)
        assert int(a[dead].abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["caveated", "rbac"])
@pytest.mark.parametrize("mesh", [(1, 2), (2, 4)])
def test_mesh_sweep_on_the_card_matches_its_twins(mesh, workload):
    """Whole batches of the sharded ELL kernel co-located on the card
    against the same batches on the twins on the card (every replica, the
    trace, the lookup words), each sweep's output buffers poisoned first;
    a sweep launches at most D x (aux passes + 3 + permission ops)
    kernels, copies nothing and reads back once."""
    _needs_card()
    from spicedb_kubeapi_proxy_tpu_torch.parallel import collectives
    from spicedb_kubeapi_proxy_tpu_torch.parallel.sharding import make_mesh
    d_n, g_n = mesh
    if workload == "caveated":
        w = workloads.caveated_rbac(n_pods=400, n_users=300, n_groups=10)
    else:
        w = workloads.rbac_deny(n_pods=400, n_users=300, n_groups=10)
    ep = create_endpoint("torch://", Bootstrap(
        w.schema_text, "\n".join(w.relationships)),
        mesh=make_mesh(["cuda"] * (d_n * g_n), data=d_n, graph=g_n))
    g = ep.graph()
    kern, prog = g.kernel, g.prog
    assert kern.planes == (workload == "caveated")
    step = kern.step

    def poisoned(cur, x, x0, live, aux, *args, **kw):
        for t in [t for row in cur + aux for t in row]:
            t.fill_(0x5A5A5A5A)
        step(cur, x, x0, live, aux, *args, **kw)
    kern.step = poisoned
    for lanes in (8, 33, 256):
        q = np.full(32 * kern.padded_batch_words(lanes), prog.dead_index,
                    np.int32)
        q[:lanes] = np.random.default_rng(lanes).integers(
            0, prog.dead_index, lanes)
        n_words = len(q) // 32
        kernels.reset_launches()
        collectives.reset_collectives()
        xk, tk = kern.evaluate(q, n_words, g.snapshot(),
                               kern._alloc_arenas(n_words))
        sweeps = int(tk[0])
        launched = sum(kernels.LAUNCHES[n] for n in kernels.KERNEL_NAMES
                       if n.startswith("mesh_"))
        assert launched <= sweeps * d_n * (kern.aux_passes + 3
                                           + len(prog.perm_ops))
        assert collectives.COLLECTIVES["all_gather_rows"]["copies"] == 0
        assert collectives.COLLECTIVES["reduce_sweep_deltas"]["calls"] == \
            sweeps
        xt, tt = kern.evaluate(q, n_words, g.snapshot(),
                               kern._alloc_arenas(n_words), reference)
        torch.cuda.synchronize()
        assert np.array_equal(tk, tt)
        for a, b in zip([t for row in xk for t in row],
                        [t for row in xt for t in row]):
            assert torch.equal(a, b)
        off, length = prog.slot_range("pod", "view")
        assert torch.equal(kern.finish_lookup(xk, off, length, n_words),
                           kern.finish_lookup(xt, off, length, n_words,
                                              reference))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["caveated", "rbac"])
def test_mesh_mixed_placement_copies_to_the_far_card_only(workload):
    """Two graph shards on each of two cards (1 x 4 and 2 x 4 meshes): the
    gathers write both replicas on their card, each block goes to the
    other card's replicas by a copy, and the answers equal the co-located
    CPU mesh's."""
    _needs_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices")
    from spicedb_kubeapi_proxy_tpu_torch.parallel import collectives
    from spicedb_kubeapi_proxy_tpu_torch.parallel.sharding import make_mesh
    if workload == "caveated":
        w = workloads.caveated_rbac(n_pods=400, n_users=300, n_groups=10)
    else:
        w = workloads.rbac_deny(n_pods=400, n_users=300, n_groups=10)
    bs = Bootstrap(w.schema_text, "\n".join(w.relationships))
    for d_n in (1, 2):
        cards = ["cuda:0", "cuda:0", "cuda:1", "cuda:1"] * d_n
        kerns = [create_endpoint(url, bs, mesh=make_mesh(
            devs, data=d_n, graph=4)).graph()
            for url, devs in (("torch://?device=cpu", ["cpu"] * 4 * d_n),
                              ("torch://", cards))]
        prog = kerns[0].prog
        q = np.full(32 * kerns[0].kernel.padded_batch_words(64),
                    prog.dead_index, np.int32)
        q[:64] = np.random.default_rng(d_n).integers(0, prog.dead_index, 64)
        out = []
        for g in kerns:
            kern = g.kernel
            collectives.reset_collectives()
            x, tr = kern.evaluate(q, len(q) // 32, g.snapshot(),
                                  kern._alloc_arenas(len(q) // 32))
            out.append((tr, [t.cpu() for row in x for t in row],
                        collectives.COLLECTIVES["all_gather_rows"]
                        ["copies"]))
        assert np.array_equal(out[0][0], out[1][0])
        assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
        passes = kerns[1].kernel.aux_passes + 1 + kerns[1].kernel.planes
        # each of 4 blocks into the 2 replicas on the other card
        assert out[0][2] == 0
        assert out[1][2] == int(out[1][0][0]) * passes * d_n * 4 * 2


# -- off-loop rebuilds on the card ------------------------------------------

def _wildcard_pair(n_docs: int = 20_000):
    """A card endpoint and a CPU one (both `dispatch=direct`, so their
    internals are the endpoint's) on equal stores of WILDCARD docs."""
    rels = [f"doc:d{i}#viewer@user:u{i % 97}" for i in range(n_docs)]
    rels += ["doc:d1#banned@user:u1"]
    bs = Bootstrap(WILDCARD, "\n".join(rels))
    return [create_endpoint(url, bs) for url in (
        "torch://?dispatch=direct", "torch://?device=cpu&dispatch=direct")]


def _wildcard_reads(ep, subjects):
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, SubjectRef)
    subs = [SubjectRef("user", s) for s in subjects]
    looked = [sorted(x) for x in ep._lookup_batch_sync("doc", "view", subs)]
    reqs = [CheckRequest(ObjectRef("doc", f"d{i}"), "view", subs[i % len(subs)])
            for i in range(0, 400, 3)]
    checked = [r.permissionship.name for r in ep._check_batch_sync(reqs)]
    return looked, checked


def _write_both(eps, rel):
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        RelationshipUpdate, UpdateOp, parse_relationship)
    for ep in eps:
        ep.store.write([RelationshipUpdate(UpdateOp.TOUCH,
                                           parse_relationship(rel))])


@pytest.mark.cuda
def test_background_swap_under_concurrent_reads_on_the_card():
    """A background rebuild whose candidate prewarms, captures its sweep
    graphs and then recaptures one arena's graphs until the reader thread
    has replayed 8 batches of the live generation meanwhile (each with
    its side-stream readback): captures and replays from two threads
    coexist on the card.  A write lands during the build and replays at
    the install.  Every read answers as the CPU endpoint did before or
    after the write, and the swapped generation answers as the CPU one.
    (No quarantine here: a quarantined pair would be read from the host
    oracle, not the card.)"""
    _needs_card()
    import threading
    ep, cpu = _wildcard_pair()
    subjects = [f"u{i}" for i in range(0, 97, 3)] + ["nobody"]
    ep.warm_start(prewarm=True)
    ep.prewarm_rebuilds = True
    before = _wildcard_reads(cpu, subjects)
    assert _wildcard_reads(ep, subjects) == before
    stop = threading.Event()
    done = [0]
    seen, errors = [], []

    def reader():
        try:
            while not stop.is_set():
                seen.append(_wildcard_reads(ep, subjects))
                done[0] += 1
        except Exception as e:      # surfaced by the main thread
            errors.append(e)

    recaptures, prewarmed = [0], threading.Event()
    orig = ep._prewarm_graph

    def prewarm_and_recapture(graph):
        n = orig(graph)
        kc, snap = graph.kernel, graph.snapshot()
        arena = kc.take_arena(8)
        start = done[0]
        deadline = time.monotonic() + 60
        while done[0] < start + 8 and time.monotonic() < deadline:
            kc._capture(arena, tuple(snap), 8, snap.plan)
            recaptures[0] += 1
        kc.put_arena(8, arena)
        assert done[0] >= start + 8
        prewarmed.set()
        return n

    ep._prewarm_graph = prewarm_and_recapture
    thread = threading.Thread(target=reader)
    thread.start()
    try:
        with ep._lock:
            ep._kick_background_rebuild("background")
        _write_both((ep, cpu), "doc:dnew#viewer@user:u3")
        assert ep.wait_rebuilds(timeout=120)
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not thread.is_alive()
    after = _wildcard_reads(cpu, subjects)
    assert not errors, errors[:1]
    assert prewarmed.is_set() and recaptures[0] >= 1
    assert ep.stats["bg_rebuilds"] == 1 and ep.stats["rebuild_failures"] == 0
    assert all(s in (before, after) for s in seen)
    assert _wildcard_reads(ep, subjects) == after


@pytest.mark.cuda
def test_prewarm_leaves_no_capture_for_the_first_batch():
    """After `warm_start(prewarm=True)` the first 256-lane lookup and check
    batches replay graphs: no eager sweep, no capture, the same answers as
    the CPU endpoint."""
    _needs_card()
    ep, cpu = _wildcard_pair(5_000)
    ep.warm_start(prewarm=True)
    stats = dict(ep.graph().kernel.graph_stats)
    assert stats["captures"] == 4      # the 32, 64, 128 and 256-lane buckets
    subjects = [f"u{i}" for i in range(97)] + [f"x{i}" for i in range(159)]
    got = _wildcard_reads(ep, subjects)
    after = ep.graph().kernel.graph_stats
    assert after["eager_sweeps"] == stats["eager_sweeps"]
    assert after["captures"] == stats["captures"]
    assert after["replays"] > stats["replays"]
    assert got == _wildcard_reads(cpu, subjects)


@pytest.mark.cuda
def test_card_memory_returns_after_the_swap():
    """Two generations are on the card while the candidate builds; once
    it is swapped in and the reads dropped their snapshots, the outgoing
    generation's tables, arenas and graph pools are freed.  (The swap is
    kicked directly, as the preemptive refresh does: a quarantined pair
    would be read from the host oracle, slowly at this size.)"""
    _needs_card()
    import gc
    import weakref
    ep, cpu = _wildcard_pair(200_000)
    ep.prewarm_rebuilds = True
    ep.warm_start(prewarm=True)
    subjects = [f"u{i}" for i in range(64)]
    _wildcard_reads(ep, subjects)
    outgoing = weakref.ref(ep.graph())
    gc.collect()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with ep._lock:
        ep._kick_background_rebuild("background")
    _write_both((ep, cpu), "doc:dnew#viewer@user:u1")
    assert ep.wait_rebuilds(timeout=120)
    assert _wildcard_reads(ep, subjects) == _wildcard_reads(cpu, subjects)
    gc.collect()
    torch.cuda.synchronize()
    peak, m1 = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
    assert ep.stats["bg_rebuilds"] == 1 and outgoing() is None
    # the prewarmed candidate took about one generation more; it came back
    assert peak - m0 > 0
    assert m1 - m0 < 0.25 * (peak - m0), (m0, peak, m1)


# -- entry.py (the counterpart of __graft_entry__.py) on the card -------------

@pytest.mark.cuda
def test_entry_on_the_card_equals_the_cpu():
    _needs_card()
    from spicedb_kubeapi_proxy_tpu_torch import entry
    fn, args = entry.entry()
    assert all(a.device.type == "cuda" for a in args)
    cpu_fn, cpu_args = entry.entry(device="cpu")
    np.testing.assert_array_equal(fn(*args).cpu().numpy(),
                                  cpu_fn(*cpu_args).numpy())


@pytest.mark.cuda
def test_dryrun_multichip_on_the_cards():
    _needs_card()
    from spicedb_kubeapi_proxy_tpu_torch import entry
    out = entry.dryrun_multichip(4)
    assert all(d.startswith("cuda") for d in out["devices"])


# -- device telemetry on the card ------------------------------------------------


def _telemetry_endpoint():
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import SubjectRef
    w = workloads.multitenant_1m(n_pods=20_000, n_tuples=60_000,
                                 n_users=500, n_namespaces=200)
    # the index off: at this size the closure planes would answer pod#view
    # without a sweep
    ep = create_endpoint("torch://?dispatch=direct", Bootstrap(
        w.schema_text, "\n".join(w.relationships)), leopard=False)
    ep.warm_start(prewarm=True)
    subjects = [SubjectRef("user", u) for u in w.subjects[:256]]
    return ep, subjects


def _kernel_device_s() -> float:
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import REGISTRY
    h = REGISTRY.get("authz_kernel_time_seconds")
    return 0.0 if h is None else sum(
        v[1] for k, v in h.raw().items() if k[0] == "kernel.device")


@pytest.mark.cuda
def test_device_windows_are_cuda_event_times():
    """A batch's kernel.device seconds are the device spans of the seed
    and sweep graphs it replayed, read at readback: they agree with
    events the test records inside the same graphs, hold none of the
    host's time between sweeps, and no synchronize runs for them."""
    import asyncio

    from chip_smoke import _OwnGraphMarks
    _needs_card()
    marks = _OwnGraphMarks()
    syncs = []
    real_sync = torch.cuda.synchronize
    try:
        ep, subjects = _telemetry_endpoint()
        asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))
        torch.cuda.synchronize = lambda *a, **k: syncs.append(a) or \
            real_sync(*a, **k)
        marks.on = True
        k0, t0 = _kernel_device_s(), time.perf_counter()
        for _ in range(4):
            asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))
        host = time.perf_counter() - t0
        acc = _kernel_device_s() - k0
    finally:
        torch.cuda.synchronize = real_sync
        marks.uninstall()
    own = sum(marks.spans)
    sweeps = int(ep.graph().last_trace[0])
    # each batch: its seed graph and one graph a sweep
    assert len(marks.spans) == 4 * (1 + sweeps) and syncs == []
    assert abs(acc - own) <= 0.10 * own, (acc, own)
    assert acc < host


@pytest.mark.cuda
def test_stepwise_launches_are_stamped_on_the_card():
    """Outside a graph (the segment kernel launches each step), a batch's
    kernel.device seconds are the sum of the launchers' own event pairs:
    more than zero and less than events around the whole batch call,
    which hold the host's time between launches."""
    import asyncio
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import SubjectRef
    _needs_card()
    w = workloads.multitenant_1m(n_pods=20_000, n_tuples=60_000,
                                 n_users=500, n_namespaces=200)
    ep = create_endpoint("torch://?dispatch=direct&kernel=segment",
                         Bootstrap(w.schema_text,
                                   "\n".join(w.relationships)),
                         leopard=False)
    subjects = [SubjectRef("user", u) for u in w.subjects[:256]]
    asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))
    graph = ep.graph()
    orig = graph.run_lookup_packed_T_device
    pairs = []

    def whole(*a, **k):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = orig(*a, **k)
        e.record()
        pairs.append((s, e))
        return out

    graph.run_lookup_packed_T_device = whole
    try:
        k0 = _kernel_device_s()
        for _ in range(2):
            asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))
        acc = _kernel_device_s() - k0
    finally:
        del graph.run_lookup_packed_T_device
    outer = sum(s.elapsed_time(e) for s, e in pairs) / 1e3
    assert len(pairs) == 2 and 0 < acc < outer, (acc, outer)


@pytest.mark.cuda
def test_ledger_lies_between_the_tables_and_the_allocator():
    from spicedb_kubeapi_proxy_tpu_torch.utils import devtel
    _needs_card()
    ep, _ = _telemetry_endpoint()
    g = ep.graph()
    tables = devtel.tensor_bytes(g.dev_main, g.dev_aux, g.dev_cav)
    assert tables <= devtel.LEDGER.total() <= torch.cuda.memory_allocated()
    old = ep._devtel_gen
    ep.force_rebuild()
    assert devtel.LEDGER.generation_bytes(old) == 0
    assert devtel.LEDGER.generation_bytes(ep._devtel_gen) >= tables


@pytest.mark.cuda
def test_kernel_phases_open_nvtx_ranges_on_the_card(monkeypatch):
    import asyncio
    _needs_card()
    ep, subjects = _telemetry_endpoint()
    names = []
    push = torch.cuda.nvtx.range_push
    monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                        lambda n: names.append(n) or push(n))
    asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))
    assert "kernel.launch" in names and "kernel.wait" in names


@pytest.mark.cuda
def test_capture_survives_a_collection_of_dead_graphs():
    """Graphs dropped in reference cycles are freed at the next cyclic
    collection; one that ran on a capturing thread would free them there
    (`cudaGraphExecDestroy`), which CUDA refuses and answers by
    invalidating the capture.  Here dead graphs young enough for a
    first-generation collection lose their last references inside the
    captured function, whose own allocations would then trigger
    collections (threshold 1): with the collector paused while a capture
    is open, the capture still succeeds and replays, and the dead graphs
    go at the next collection after it."""
    import gc
    _needs_card()
    dev = torch.device("cuda")
    x = torch.zeros(1 << 10, dtype=torch.int32, device=dev)
    table = torch.zeros((64, 1), dtype=torch.int32, device=dev)
    src = torch.ones((8, 1), dtype=torch.int32, device=dev)
    rows = torch.arange(8, dtype=torch.int32, device=dev)
    keep = []
    threshold = gc.get_threshold()
    gc.collect()
    # made with the collector off, so no collection moves them past the
    # first generation before the capture
    gc.disable()
    try:
        for _ in range(8):
            dead = kernels.LaunchGraph(dev)
            dead.capture(lambda: x.add_(1))
            cycle = {"graph": dead}
            cycle["self"] = cycle
            keep.append(cycle)
        del dead, cycle
        g = kernels.LaunchGraph(dev)
    finally:
        gc.enable()

    def fn():
        keep.clear()            # the dead graphs are cyclic garbage now
        gc.set_threshold(1, 1, 1)
        junk = [[i] for i in range(2_000)]
        return len(junk), kernels.scatter_rows(table, rows, src)

    try:
        n, out = g.capture(fn)
        g.replay()
        torch.cuda.synchronize()
    finally:
        gc.set_threshold(*threshold)
        gc.collect()
    assert n == 2_000 and g.counts == {"scatter_rows": 1}
    assert int(out[:8].sum()) == 8 and int(out[8:].sum()) == 0
