"""The ELL check tail held against the JAX reference, bit for bit.

The port gathers a check batch's answers in the tail of every sweep
(`sweep_delta_checks`: the delta pair and the gather in one launch, the
answers packed 32 slots a word beside the pair and read back with it),
not in a launch and a copy of their own after the fixpoint.  Here, on the
CPU (the kernel's plain-torch twin), the port's `checks_device` must give
the reference `EllKernelCache`'s `run_checks` answers (ops/ell.py:853-887)
exactly: definite and with planes, at 33 and 256 lanes (bit 31 live), for
G = 0, 1, G not a multiple of 32 and padded slots, for a batch that the
iteration cap stops, and for a lookup that takes the arena right after a
check.  The wrappers are counted: the ELL path calls no `check_gather`,
`check_gather3` or `sweep_delta`, and reads back once a sweep.  Inputs
come from numpy generators with fixed seeds; tolerance 0 (the answers
are tri-state values and the words bitplanes).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spicedb_kubeapi_proxy_tpu.ops import ell as ref_ell
from spicedb_kubeapi_proxy_tpu_torch import convert
from spicedb_kubeapi_proxy_tpu_torch.ops import ell as port_ell
from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference as twins
from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
    _unify_check_buckets)

from test_torch_caveats import _compile as _cav_compile
from test_torch_caveats import _queries as _cav_queries
from test_torch_caveats import _reference_plane_cache
from test_torch_ell import _queries, _reference_cache, _scenario


class _Pair:
    """A reference kernel cache and the port's on the same program and
    tables (CPU), with the tables each entry point takes."""

    def __init__(self, name: str, planes: bool, num_iters=None,
                 jacobi: bool = False):
        if planes:
            prog, self.rtype, self.perm = _cav_compile(name)
            main, aux, ct, depth, shared, _ = _reference_plane_cache(prog)
            self.ref = ref_ell.EllKernelCache(
                prog, n_aux_rows=aux.shape[0], tree_depth=depth, planes=True,
                shared_tree_depth=shared, host_main=main,
                num_iters=num_iters)
            self.port = port_ell.EllKernelCache(
                convert.program_from_reference(prog),
                n_aux_rows=aux.shape[0], tree_depth=depth, device="cpu",
                shared_tree_depth=shared, host_main=main, planes=True,
                num_iters=num_iters)
            host = (main, aux, ct.idx_cav)
        else:
            prog, (self.rtype, self.perm) = _scenario(name)
            t, kc = _reference_cache(prog)
            self.ref = ref_ell.EllKernelCache(
                prog, n_aux_rows=t.idx_aux.shape[0],
                tree_depth=t.tree_depth, shared_tree_depth=t.tree_depth,
                host_main=t.idx_main, num_iters=num_iters)
            assert (self.ref.stages is None) == jacobi
            _, _, _, self.port = convert.from_reference(
                prog, t.idx_main, t.idx_aux,
                stages=() if jacobi else kc.stages,
                tree_depth=t.tree_depth, shared_tree_depth=t.tree_depth,
                num_iters=num_iters, device="cpu")
            host = (t.idx_main, t.idx_aux)
        self.prog, self.planes = prog, planes
        self.jt = tuple(jnp.asarray(a) for a in host)
        self.pt = tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                        for a in host)
        assert self.port.num_iters == self.ref.num_iters

    def queries(self, lanes: int, seed: int):
        if self.planes:
            return _cav_queries(self.prog, self.rtype, self.perm, lanes, seed)
        return _queries(self.prog, lanes, seed)

    def checks(self, q, w, gi, gc):
        ref_out, ref_tel = self.ref.checks_device(q, w, gi, gc, *self.jt)
        out, tel = self.port.checks_device(q, w, gi, gc, *self.pt)
        assert out.device.type == "cpu" and out.dtype == torch.int32
        return (np.asarray(ref_out).view(np.int32), np.asarray(ref_tel),
                out.numpy(), tel)


@pytest.fixture
def counted(monkeypatch):
    """Count the calls of the sweep-tail and gather wrappers and of the
    fixpoint's readback (CPU twins count no launch of their own)."""
    calls = {"sweep_delta_checks": 0, "sweep_delta": 0, "check_gather": 0,
             "check_gather3": 0, "readback": 0}
    for name in ("sweep_delta_checks", "sweep_delta", "check_gather",
                 "check_gather3"):
        fn = getattr(kernels, name)

        def wrap(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(kernels, name, wrap)
    readback = port_ell.EllKernelCache._readback

    def counted_readback(self, arena, slot):
        calls["readback"] += 1
        return readback(self, arena, slot)
    monkeypatch.setattr(port_ell.EllKernelCache, "_readback",
                        counted_readback)
    return calls


@pytest.mark.parametrize("name,planes,lanes", [
    ("wildcard", False, 33), ("nested_groups", False, 256),
    ("multitenant", False, 33), ("rbac_deny", False, 256),
    ("graft", False, 256),
    ("caveat_schema", True, 33), ("caveated_rbac", True, 256),
    ("caveat_schema", True, 256)])
def test_checks_equal_reference_run_checks(name, planes, lanes, counted):
    p = _Pair(name, planes)
    w, q, gi, gc = p.queries(lanes, seed=lanes + 7)
    assert len(gi) % 32 or lanes == 256   # G off a word boundary at 33
    ref_out, ref_tel, out, tel = p.checks(q, w, gi, gc)
    assert np.array_equal(tel, ref_tel)
    assert np.array_equal(out, ref_out)
    sweeps = int(tel[0])
    assert sweeps >= 1
    # one tail a sweep, one readback a sweep, no gather after the fixpoint
    assert counted == {"sweep_delta_checks": sweeps, "sweep_delta": 0,
                       "check_gather": 0, "check_gather3": 0,
                       "readback": sweeps}
    assert set(np.unique(ref_out).tolist()) >= ({0, 1, 2} if planes
                                                else {0, 2})
    # bit 31 of a word is a live column, and its answers equal too
    live31 = gc % 32 == 31
    assert live31.any() and np.array_equal(out[live31], ref_out[live31])


@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("g", [0, 1, 31, 32, 33, 100])
def test_small_and_ragged_batches(planes, g):
    p = _Pair("caveat_schema" if planes else "nested_groups", planes)
    w, q, gi, gc = p.queries(33, seed=g)
    ref_out, ref_tel, out, tel = p.checks(q, w, gi[:g], gc[:g])
    assert out.shape == (g,)
    assert np.array_equal(out, ref_out) and np.array_equal(tel, ref_tel)


@pytest.mark.parametrize("planes", [False, True])
def test_padded_slots_read_row_0(planes):
    """The endpoint pads a batch's slots to a bucket with (row 0, col 0);
    the padded answers are read too, and equal the reference's."""
    p = _Pair("caveated_rbac" if planes else "multitenant", planes)
    w, q, gi, gc = p.queries(33, seed=5)
    q_arr, gi_p, gc_p = _unify_check_buckets(q, gi[:70], gc[:70])
    assert len(gi_p) == 128 and not gi_p[70:].any() and not gc_p[70:].any()
    assert p.prog.dead_index != 0
    ref_out, ref_tel, out, tel = p.checks(q_arr, w, gi_p, gc_p)
    assert np.array_equal(out, ref_out) and np.array_equal(tel, ref_tel)


@pytest.mark.parametrize("name,planes,jacobi", [
    ("wildcard", False, False), ("nested_groups", False, True),
    ("caveated_rbac", True, False)])
def test_batch_stopped_by_the_iteration_cap(name, planes, jacobi, counted,
                                            monkeypatch):
    """With the cap below the fixpoint's depth the last executed sweep's
    answers are the batch's, as the reference's final state's (the
    stage-free Jacobi step of the definite path runs as the reference's
    with SPICEDB_TPU_STAGED=0)."""
    if jacobi:
        monkeypatch.setenv("SPICEDB_TPU_STAGED", "0")
    full = _Pair(name, planes, jacobi=jacobi)
    w, q, gi, gc = full.queries(256, seed=11)
    _, tel_full = full.ref.checks_device(q, w, gi, gc, *full.jt)
    depth = int(np.asarray(tel_full)[0])
    assert depth >= 2
    p = _Pair(name, planes, num_iters=1, jacobi=jacobi)
    assert p.port.num_iters < depth
    for k in counted:
        counted[k] = 0
    ref_out, ref_tel, out, tel = p.checks(q, w, gi, gc)
    assert int(tel[0]) == p.port.num_iters and tel[p.port.num_iters] > 0
    assert np.array_equal(out, ref_out) and np.array_equal(tel, ref_tel)
    assert counted["sweep_delta_checks"] == counted["readback"] == int(tel[0])


@pytest.mark.parametrize("planes", [False, True])
def test_lookup_after_a_check_on_the_same_arena(planes, counted):
    """A lookup takes the arena a check batch just left: its tail runs
    with G = 0 (nothing gathered, every answer word zero) and its words
    equal the reference's."""
    p = _Pair("caveated_rbac" if planes else "rbac_deny", planes)
    w, q, gi, gc = p.queries(256, seed=3)
    ref_out, _, out, _ = p.checks(q, w, gi, gc)
    assert np.array_equal(out, ref_out)
    arena = p.port._arenas[w]
    assert arena.g == len(gi) and arena.cap >= len(gi)
    off, length = p.prog.slot_range(p.rtype, p.perm)
    ref_words, ref_tel = p.ref.lookup_packed_T_device(off, length, q, w,
                                                      *p.jt)
    words, tel = p.port.lookup_packed_T_device(off, length, q, w, *p.pt)
    assert p.port._arenas[w] is arena and arena.g == 0
    assert int(arena.tail[0]) == 0 and not arena.out[4:].any()
    assert np.array_equal(words.numpy().view(np.uint32),
                          np.asarray(ref_words))
    assert np.array_equal(tel, np.asarray(ref_tel))
    # and the next check batch on it answers as the reference again
    ref_out, _, out, _ = p.checks(q, w, gi[:40], gc[:40])
    assert np.array_equal(out, ref_out)
    assert counted["check_gather"] == counted["check_gather3"] == 0


def test_tail_grows_past_its_capacity():
    """A batch of more slots than the arena's tail holds grows it to the
    next power of two (a new tail: the arena's graphs recapture)."""
    p = _Pair("multitenant", False)
    w, q, gi, gc = p.queries(33, seed=9)
    arena = p.port.take_arena(w)
    assert arena.cap == port_ell.TAIL_SLOTS
    p.port.put_arena(w, arena)
    n = port_ell.TAIL_SLOTS + 300
    gi, gc = np.resize(gi, n), np.resize(gc, n)
    ref_out, _, out, _ = p.checks(q, w, gi, gc)
    assert np.array_equal(out, ref_out)
    cap = 2 * port_ell.TAIL_SLOTS
    assert p.port._arenas[w] is arena and arena.cap == cap
    assert arena.tail.shape == (2 + 2 * cap,)
    assert arena.out.shape == (4 + cap // 32,)


def _numpy_tail(x, x_old, dead, g, pairs, cap, half, slot, before):
    """The fused tail computed with numpy alone: (x after the dead row's
    zeroing, out words as uint32), the delta added into pair `slot` of
    `before` (the pairs' words before the call) and the other pair
    zeroed."""
    x = x.copy()
    x[dead] = 0
    d = (x ^ x_old).view(np.uint32)
    bits = np.unpackbits(d.view(np.uint8)).sum()
    out = [0, 0, 0, 0]
    out[2 * slot] = (int(before[2 * slot]) + int(bits)) % (1 << 32)
    out[2 * slot + 1] = int(before[2 * slot + 1]) | int(d.any())
    xu = x.view(np.uint32)
    definite = np.zeros(cap, np.uint8)
    maybe = np.zeros(cap, np.uint8)
    for s, (r, c) in enumerate(pairs[:g]):
        definite[s] = (xu[r, c // 32] >> (c % 32)) & 1
        if half is not None:
            maybe[s] = ((xu[r, half + c // 32] >> (c % 32)) & 1) \
                & (1 - definite[s])
    pack = lambda b: np.packbits(b, bitorder="little").view(np.uint32)
    words = [pack(definite)] + ([pack(maybe)] if half is not None else [])
    return x, np.concatenate([np.asarray(out, np.uint32), *words])


@pytest.mark.parametrize("slot", [0, 1])
@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("g", [0, 1, 45, 64, 96])
def test_twin_packs_as_a_ballot(planes, g, slot):
    rng = np.random.default_rng(100 + g)
    nt, half = 40, 3
    width = 2 * half if planes else half
    x = rng.integers(-2**31, 2**31, (nt, width), dtype=np.int64).astype(
        np.int32)
    x_old = rng.integers(-2**31, 2**31, (nt, width),
                         dtype=np.int64).astype(np.int32)
    cap, dead = 96, 7
    pairs = np.stack([rng.integers(0, nt, cap),
                      rng.integers(0, 32 * half, cap)], 1).astype(np.int32)
    pairs[::5, 1] = 31           # bit 31 of word 0
    tail = np.zeros(2 + 2 * cap, np.int32)
    tail[0] = g
    tail[2:] = pairs.reshape(-1)
    nw = cap // 32
    # answer words start as garbage (every one is written); the pair the
    # call adds into holds a running sum, the other one is zeroed
    out = torch.full((4 + nw * (2 if planes else 1),), -1, dtype=torch.int32)
    out[2 * slot], out[2 * slot + 1] = 12_345, 0
    before = out[:4].numpy().view(np.uint32).copy()
    xt = torch.from_numpy(x.copy())
    got = kernels.sweep_delta_checks(xt, torch.from_numpy(x_old), dead,
                                     torch.from_numpy(tail), out,
                                     half=half if planes else None,
                                     slot=slot)
    assert got is out
    want_x, want = _numpy_tail(x, x_old, dead, g, pairs, cap,
                               half if planes else None, slot, before)
    assert np.array_equal(xt.numpy(), want_x)
    assert np.array_equal(out.numpy().view(np.uint32), want)
    # the standalone gathers' answers, packed, are the same bits
    if g:
        gi = torch.from_numpy(pairs[:g, 0].copy())
        gc = torch.from_numpy(pairs[:g, 1].copy())
        v = (twins.check_gather3(xt, gi, gc, half) if planes
             else twins.check_gather(xt, gi, gc))
        d = np.unpackbits(out.numpy()[4:4 + nw].view(np.uint8),
                          bitorder="little")[:g]
        m = (np.unpackbits(out.numpy()[4 + nw:].view(np.uint8),
                           bitorder="little")[:g] if planes else 0)
        assert np.array_equal(v.numpy(), 2 * d + m)


@pytest.mark.parametrize("bad,match", [
    (dict(tail=torch.zeros(10, dtype=torch.int32)), "tail of"),
    (dict(out=torch.zeros(7, dtype=torch.int32)), "out of"),
    (dict(half=3, out=torch.zeros(5, dtype=torch.int32)), "out of"),
    (dict(slot=2), "slot 2"),
    (dict(host=torch.zeros(5, dtype=torch.int32)), "host copy"),
])
def test_wrapper_refuses_bad_arguments(bad, match):
    x = torch.zeros((8, 2), dtype=torch.int32)
    args = dict(x_new=x, x_old=x.clone(), dead=7,
                tail=torch.zeros(2 + 64, dtype=torch.int32),
                out=torch.zeros(5, dtype=torch.int32))
    args.update(bad)
    with pytest.raises(kernels.KernelError, match=match):
        kernels.sweep_delta_checks(**args)


@pytest.mark.parametrize("url", ["torch://?device=cpu&dispatch=direct",
                                 "torch://?device=cpu"])
def test_endpoint_checks_ride_the_tail(url, counted):
    """`check_bulk_permissions` through the endpoint (direct and batched)
    answers as `jax://` and the oracle, calls no standalone gather on the
    ELL path and starts no readback of its own for the kernel rows."""
    import asyncio

    from spicedb_kubeapi_proxy_tpu.spicedb.endpoints import (
        Bootstrap as RefBootstrap, create_endpoint as ref_create_endpoint)
    from spicedb_kubeapi_proxy_tpu.spicedb.evaluator import Evaluator
    from spicedb_kubeapi_proxy_tpu.spicedb.types import (
        CheckRequest as RefCheckRequest, ObjectRef as RefObjectRef,
        SubjectRef as RefSubjectRef)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, SubjectRef)
    from test_torch_dispatch import E2E_SCHEMA, _e2e_rels

    rng = np.random.default_rng(21)
    text = "\n".join(_e2e_rels(rng))
    port = create_endpoint(url, Bootstrap(E2E_SCHEMA, text), leopard=False)
    jx = ref_create_endpoint("jax://?dispatch=direct",
                             RefBootstrap(E2E_SCHEMA, text))
    oracle = Evaluator(jx.schema, jx.store)
    inner = getattr(port, "inner", port)
    pairs = [(f"d{rng.integers(0, 44)}", perm, f"u{rng.integers(0, 14)}")
             for perm in ("view", "edit") for _ in range(45)]
    got = asyncio.run(port.check_bulk_permissions(
        [CheckRequest(ObjectRef("doc", d), p, SubjectRef("user", s))
         for d, p, s in pairs]))
    want = asyncio.run(jx.check_bulk_permissions(
        [RefCheckRequest(RefObjectRef("doc", d), p, RefSubjectRef("user", s))
         for d, p, s in pairs]))
    assert [r.permissionship.name for r in got] == \
        [r.permissionship.name for r in want]
    assert [r.permissionship.name == "HAS_PERMISSION" for r in got] == [
        oracle.check(RefObjectRef("doc", d), p, RefSubjectRef("user", s))
        for d, p, s in pairs]
    assert {r.source for r in got} == {"kernel"}
    assert counted["check_gather"] == counted["check_gather3"] == 0
    assert counted["sweep_delta"] == 0
    assert counted["sweep_delta_checks"] == counted["readback"] >= 1
    assert inner.stats["readbacks"] == 0
