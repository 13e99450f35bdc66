"""The sharded ELL sweep's design (PERF.md row 12) held against the JAX
reference's ShardedEllKernel, bit for bit, on the CPU twins.

One sweep writes every co-located replica from the launch that computes
its rows (`mesh_gather_or`, `mesh_cav_gather_or`), runs the permission
ops and the delta once per data shard a device (`mesh_perm_program`,
`mesh_sweep_delta`), copies no input and reads its deltas back once.
Every case here runs with all shards on the CPU (co-located), against
the reference under `shard_map` on the conftest's eight virtual devices:
each replica's final state, the trace, the checks and the lookup words
must equal the reference's, also when every sweep's output buffers hold
garbage before it (no row may rely on the input copy the sweep dropped).
The multi-destination gather's twin is held against the first design's
per-shard `ell_gather_or` calls plus `all_gather_rows` copies on random
tables.  Tolerance is zero: the data are bitplanes and integer tables.
"""

import numpy as np
import pytest
import torch

from test_torch_sharding import (_assert_states, _kernels, _program,
                                 _queries)
from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
from spicedb_kubeapi_proxy_tpu_torch.parallel import collectives

POISON = 0x5A5A5A5A


class _Counting:
    """The kernels module with a count of each wrapper's calls (on the CPU
    no wrapper counts a launch)."""

    def __init__(self):
        self.calls: dict = {}

    def __getattr__(self, name):
        fn = getattr(kernels, name)

        def call(*args, **kw):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*args, **kw)
        return call


def _poison_every_sweep(port):
    """Fill every sweep's output buffers (the replicas it writes and the
    aux ping-pong buffers) with POISON before it runs."""
    step = port.step

    def poisoned(cur, x, x0, live, aux, *args, **kw):
        for t in [t for row in cur + aux for t in row]:
            t.fill_(POISON)
        step(cur, x, x0, live, aux, *args, **kw)
    port.step = poisoned


CASES = [
    # (scenario, data, graph, lanes): each scenario at two or more of the
    # meshes 1x2, 2x2, 2x4 and 1x8, each mesh and lane count several times
    ("graft", 1, 2, 8), ("graft", 2, 4, 256),
    ("wildcard", 2, 2, 33), ("wildcard", 1, 8, 256),
    ("hub_groups", 1, 2, 33), ("hub_groups", 2, 4, 8),
    ("hub_groups", 1, 8, 256),
    ("rbac_deny", 2, 2, 256), ("rbac_deny", 1, 8, 33),
    ("caveated_rbac", 1, 2, 256), ("caveated_rbac", 2, 2, 8),
    ("caveated_rbac", 2, 4, 33),
    ("multitenant", 2, 4, 256), ("multitenant", 1, 8, 8),
]


@pytest.mark.parametrize("name,data,graph,lanes", CASES)
def test_mesh_sweep_matches_reference(name, data, graph, lanes):
    """Replicas, trace, checks and lookup words equal the reference's; a
    sweep makes aux_passes + 1 gather launches (+1 caveat launch with
    planes), one program launch per op and one delta per data shard, no
    copy between the co-located replicas, and one readback."""
    prog, (rtype, perm) = _program(name)
    ref, port, _ = _kernels(prog, data, graph)
    if name == "hub_groups":
        assert port.aux_passes >= 3
    w, q, gi, gc = _queries(prog, ref, lanes, seed=lanes + 7 * data + graph)
    tables = ref.snapshot_tables()
    ref_out, ref_tel = ref.checks_device(q, w, gi, gc, *tables)
    port_tables = port.snapshot_tables()

    spy = _Counting()
    collectives.reset_collectives()
    arenas = port.take_arena(w)
    x, tel = port.evaluate(q, w, port_tables, arenas, spy)
    assert np.array_equal(tel, np.asarray(ref_tel))
    _assert_states(ref, port, w, x)
    port.put_arena(w, arenas)
    sweeps = int(tel[0])
    want = {"mesh_gather_or": port.aux_passes + 1,
            "mesh_perm_program": data * len(prog.perm_ops),
            "mesh_sweep_delta": data}
    if port.planes:
        want["mesh_cav_gather_or"] = 1
    assert {k: v for k, v in spy.calls.items() if k.startswith("mesh_")} \
        == {k: v * sweeps for k, v in want.items()}
    c = collectives.COLLECTIVES
    assert c["all_gather_rows"]["copies"] == 0
    assert c["reduce_sweep_deltas"]["calls"] == sweeps
    if graph > 1:
        assert c["all_gather_rows"]["bytes"] > 0

    out, tel_c = port.checks_device(q, w, gi, gc, *port_tables)
    assert np.array_equal(tel_c, np.asarray(ref_tel))
    assert np.array_equal(out.numpy().view(np.uint32), np.asarray(ref_out))
    off, length = prog.slot_range(rtype, perm)
    ref_words, _ = ref.lookup_packed_T_device(off, length, q, w, *tables)
    words, _ = port.lookup_packed_T_device(off, length, q, w, *port_tables)
    assert np.array_equal(words.numpy().view(np.uint32),
                          np.asarray(ref_words))


@pytest.mark.parametrize("name,data,graph,lanes", [
    ("hub_groups", 2, 4, 33), ("caveated_rbac", 2, 4, 256),
    ("multitenant", 1, 8, 33), ("wildcard", 2, 2, 8)])
def test_poisoned_outputs_change_nothing(name, data, graph, lanes):
    """Every replica and aux buffer a sweep writes holds POISON before it
    runs; states, trace, checks and words still equal the reference's, so
    every row of a sweep's output is written by the sweep (main rows by
    the main gather, aux rows by the last aux pass — the ping-pong's
    parity —, the dead row zeroed by the delta)."""
    prog, (rtype, perm) = _program(name)
    ref, port, _ = _kernels(prog, data, graph)
    _poison_every_sweep(port)
    w, q, gi, gc = _queries(prog, ref, lanes, seed=3 * lanes + data)
    tables = ref.snapshot_tables()
    ref_out, ref_tel = ref.checks_device(q, w, gi, gc, *tables)
    port_tables = port.snapshot_tables()
    arenas = port.take_arena(w)
    for row in arenas:
        for a in row:
            a.a.fill_(POISON)
            a.b.fill_(POISON)
            a.aux.fill_(POISON)
    x, tel = port.evaluate(q, w, port_tables, arenas)
    assert np.array_equal(tel, np.asarray(ref_tel))
    _assert_states(ref, port, w, x)
    port.put_arena(w, arenas)
    out, _ = port.checks_device(q, w, gi, gc, *port_tables)
    assert np.array_equal(out.numpy().view(np.uint32), np.asarray(ref_out))
    off, length = prog.slot_range(rtype, perm)
    ref_words, _ = ref.lookup_packed_T_device(off, length, q, w, *tables)
    words, _ = port.lookup_packed_T_device(off, length, q, w, *port_tables)
    assert np.array_equal(words.numpy().view(np.uint32),
                          np.asarray(ref_words))


def _words(rng, shape):
    return torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, shape,
                                         dtype=np.int64).astype(np.int32))


@pytest.mark.parametrize("g,w,k,seeded", [
    (2, 1, 1, False), (3, 3, 5, True), (4, 7, 32, True), (8, 2, 2, False),
    (5, 4, 17, True)])
def test_multi_destination_gather_equals_gathers_and_copies(g, w, k, seeded):
    """`mesh_gather_or` with G jobs, each writing its block into all G
    replicas, against the first design: each replica a copy of the state,
    one `ell_gather_or` into its own block through scratch, then
    `all_gather_rows` copying every block into every peer.  Rows past the
    split come from a second buffer (an aux pass reading the previous
    pass's output)."""
    rng = np.random.default_rng(g * 100 + w * 10 + k)
    n = 11                       # rows a block
    split, n_hi = g * n + 3, 9   # the gathered rows: [0, split) and hi
    lo = _words(rng, (split + 2, w))
    hi = _words(rng, (n_hi, w))
    seed = _words(rng, (g * n, w)) if seeded else None
    live = _words(rng, (3, w)) if seeded else None
    blocks = [torch.from_numpy(rng.integers(0, split + n_hi, (n, k))
                               .astype(np.int32)) for _ in range(g)]
    bits = [torch.from_numpy(rng.integers(0, 8, n).astype(np.int32))
            if seeded else None for _ in range(g)]

    # the first design
    state = torch.cat([lo[:split], hi])
    old = [state.clone() for _ in range(g)]
    for j in range(g):
        reference.ell_gather_or(old[j], blocks[j], j * n,
                                x0=None if seed is None else
                                torch.cat([seed, state[g * n:]]),
                                wc_bits=bits[j], wc_live=live)
    collectives.reset_collectives()
    collectives.all_gather_rows(old, 0, g * n)
    assert collectives.COLLECTIVES["all_gather_rows"]["copies"] == \
        g * (g - 1)

    new = [torch.full((g * n, w), POISON, dtype=torch.int32)
           for _ in range(g)]
    jobs = [(blocks[j], lo, hi,
             None if seed is None else seed[j * n:(j + 1) * n], bits[j],
             live, [r[j * n:(j + 1) * n] for r in new]) for j in range(g)]
    kernels.mesh_gather_or(jobs, split)
    for r_old, r_new in zip(old, new):
        assert torch.equal(r_old[:g * n], r_new)
    collectives.reset_collectives()
    collectives.all_gather_rows(new, 0, g * n, written=True)
    assert collectives.COLLECTIVES["all_gather_rows"]["copies"] == 0
    assert collectives.COLLECTIVES["all_gather_rows"]["bytes"] == \
        g * (g - 1) * n * w * 4


def test_mesh_kernels_refuse_a_destination_that_is_read():
    """A destination that overlaps a source (or another destination) is
    refused on every device: the kernels write in place only because no
    launch reads what it writes."""
    rng = np.random.default_rng(1)
    x = _words(rng, (20, 4))
    cur = _words(rng, (20, 4))
    idx = torch.from_numpy(rng.integers(0, 20, (5, 2)).astype(np.int32))
    with pytest.raises(kernels.KernelError):
        kernels.mesh_gather_or([(idx, x, x[10:], None, None, None,
                                 [x[5:10]])], 10)
    with pytest.raises(kernels.KernelError):
        kernels.mesh_gather_or([(idx, x, cur[10:], None, None, None,
                                 [cur[8:13]])], 10)
    with pytest.raises(kernels.KernelError):
        kernels.mesh_gather_or([(idx, x, x[10:], None, None, None,
                                 [cur[0:5], cur[3:8]])], 10)
    out = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(kernels.KernelError):
        kernels.mesh_sweep_delta(cur, x, 19, out, [cur, x])
    kernels.mesh_gather_or([(idx, x, x[10:], None, None, None,
                             [cur[0:5], cur[5:10]])], 10)
    assert torch.equal(cur[0:5], cur[5:10])


def test_mesh_programs_refuse_a_slot_read_across_rows():
    """The permission program writes every replica in place, which is
    exact only when each READ is of its own slot or of a disjoint range;
    the twin refuses any other (the plan refuses it at build time)."""
    cur = torch.arange(40, dtype=torch.int32).reshape(20, 2)
    x0 = torch.zeros_like(cur)
    reps = [cur, cur.clone()]
    # slot [4, 8) reading rows [6, 10): overlapping, not the slot itself
    code = torch.tensor([reference.OP_READ, 6], dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.mesh_perm_program(cur, x0, code, 4, 4, reps)
    code = torch.tensor([reference.OP_READ, 4, reference.OP_READ, 12,
                         reference.OP_OR, 2], dtype=torch.int32)
    want = cur[4:8] | cur[12:16]
    kernels.mesh_perm_program(cur, x0, code, 4, 4, reps)
    assert all(torch.equal(r[4:8], want) for r in reps)


def test_sweep_delta_counts_once_per_data_shard():
    """mesh_sweep_delta reads one replica, zeroes the dead row of every
    replica and accumulates into its slot; the count the sweep reports
    sums the data shards once each."""
    rng = np.random.default_rng(5)
    x_old = _words(rng, (30, 3))
    reps = [_words(rng, (30, 3)) for _ in range(3)]
    reps[1].copy_(reps[0])
    out = torch.zeros((2, 2), dtype=torch.int32)
    kernels.mesh_sweep_delta(reps[0], x_old, 29, out[0], reps)
    assert all(int(r[29].abs().sum()) == 0 for r in reps)
    want = reference.sweep_delta(reps[0].clone(), x_old, 29)
    assert out[0].tolist() == want.tolist()
    count, changed = collectives.reduce_data_deltas(out, [out[0], out[1]])
    assert (count, changed) == (want.tolist()[0], True)

