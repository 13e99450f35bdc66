"""Sharded reachability on a 2D (data x graph) mesh, driven from one
process.

The torch counterpart of the reference's parallel/sharding.py.  The
reference's mesh is single-controller: one process drives every device
through `shard_map`, and its tests run eight shards on one host as eight
virtual CPU devices.  The port keeps that shape: a `Mesh` is a grid of
shard slots, each bound to a torch device (a device may repeat, so eight
shards can share one card or the CPU), every shard holds its own blocks
of the tables and its own state replica, and the collectives are copies
between the shards' buffers (parallel/collectives.py) or, on the ELL
sweep, writes of one kernel into every replica on its card.  On several
cards the same code places the shards on different cards and the copies
become peer copies.

- `data` axis — the packed word axis of the batch: each shard owns W/D
  uint32 words (32 query columns each) and seeds only those columns.
  Pure throughput parallelism: no communication.
- `graph` axis — table rows (`ShardedEllKernel`) or edges
  (`ShardedKernel`): each shard computes the one-step closure of its own
  rows or edges over the full state, and the results are reassembled
  every sweep (row blocks copied into every peer replica, or partials
  ORed together), so the state stays replicated along `graph`.

Every per-shard step is one of the hand-written CUDA kernels of
ops/kernels (their plain twins on CPU tensors); see `ShardedEllKernel`
for the sweep, which follows the reference's `_evaluate_shard_fn`.
"""

from __future__ import annotations

import threading
from collections import namedtuple
from typing import Optional

import numpy as np
import torch

from ..ops import kernels
from ..ops.ell import (K_AUX, _to_device, batch_words,
                       build_cav_tables, build_tables, compile_perm_program)
from ..ops.ell import MAX_ITERATIONS as ELL_MAX
from ..ops.graph_compile import GraphProgram
from ..ops.spmv import KernelCache as SegmentKernelCache
from ..ops.kernels.reference import reads_in_place
from ..ops.spmv import MAX_ITERATIONS, bucket, pad_edges
from .collectives import (all_gather_rows, or_allreduce, reduce_data_deltas,
                          reduce_sweep_deltas)

# One shard's state buffers of a bucket: the seed, the two sweep states the
# fixpoint loop swaps between (the seed is the first sweep's input), and
# the [a_pad, width] rows the aux passes ping-pong with `a` or `b`'s aux
# rows.
_ShardArena = namedtuple("_ShardArena", "x0 a b aux")


class Mesh:
    """A [data, graph] grid of torch devices.  `devices[d][g]` holds shard
    (d, g); `shape` is {"data": D, "graph": G}, as the reference's
    `jax.sharding.Mesh.shape`."""

    def __init__(self, devices):
        grid = [[torch.device(dev) for dev in row] for row in devices]
        if not grid or not grid[0] or any(len(r) != len(grid[0])
                                          for r in grid):
            raise ValueError("a mesh needs a non-empty rectangular grid")
        self.devices = tuple(tuple(row) for row in grid)
        self.shape = {"data": len(grid), "graph": len(grid[0])}
        self.size = len(grid) * len(grid[0])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape['data']}x{self.shape['graph']}: "
                + ", ".join(f"({d},{g})={dev}"
                            for d, row in enumerate(self.devices)
                            for g, dev in enumerate(row)) + ")")


def make_mesh(devices=None, data: Optional[int] = None,
              graph: Optional[int] = None) -> Mesh:
    """Build a 2D (data, graph) mesh over `devices` (default: every
    visible CUDA card), row-major: shard (d, g) gets devices[d * graph +
    g].  A list may repeat a device to co-locate shards.  Without an
    explicit split, the smallest factor pair with graph >= data (the
    graph axis is the capacity axis and gets the larger share), as the
    reference chooses."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(dev) for dev in devices]
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if data is None or graph is None:
        graph = n
        g = 1
        while g * g <= n:
            if n % g == 0:
                graph = n // g
            g += 1
        data = n // graph
    if data * graph != n:
        raise ValueError(f"mesh {data}x{graph} != {n} devices")
    return Mesh([devices[d * graph:(d + 1) * graph] for d in range(data)])


def padded_batch_words_for(n_data: int, batch: int) -> int:
    """uint32 word count for a `batch`-column query under a data axis of
    size n_data: a power of two at least n_data, rounded up to a multiple
    of it (the single source of the padding formula)."""
    w = batch_words(batch, minimum=n_data)
    if w % n_data:
        w += n_data - (w % n_data)
    return w


def comm_model(state_size: int, n_aux_rows: int, n_data: int, n_graph: int,
               batch: int, planes: bool = False,
               aux_passes: int = 1) -> dict:
    """Per-sweep traffic of the sharded ELL layout, the reference's model:
    row blocks are reassembled by an all_gather along `graph` every sweep
    (the aux block once per aux pass, the main block once; with planes
    3x the definite traffic), the `data` axis moves nothing."""
    n_pad = _ceil_mult(state_size, n_graph)
    a_pad = _ceil_mult(max(n_aux_rows, 1), n_graph)
    w_local = max(1, padded_batch_words_for(n_data, batch) // n_data)
    rows = n_pad + a_pad * max(1, aux_passes)
    factor = 3 if planes else 1
    return {
        "mesh": f"{n_data}x{n_graph} (data x graph)",
        "padded_rows": n_pad + a_pad,
        "aux_passes": max(1, aux_passes),
        "words_per_device": w_local,
        "bitplanes": 2 if planes else 1,
        "all_gather_recv_bytes_per_device_per_iter":
            rows * w_local * 4 * (n_graph - 1) // n_graph * factor,
        "data_axis_comm_bytes": 0,
    }


def _ceil_mult(n: int, m: int) -> int:
    return ((max(n, 1) + m - 1) // m) * m


def _blocks(mesh: Mesh, arr: np.ndarray, b: int) -> tuple:
    """[D][G] tuple of row blocks of `arr` (b rows each): block g of data
    replica d on mesh.devices[d][g].  Replicas on one device share the
    block: tables are only read, and a flush swaps whole blocks."""
    made: dict = {}
    out = []
    for row in mesh.devices:
        blocks = []
        for g, dev in enumerate(row):
            t = made.get((dev, g))
            if t is None:
                # copy=True: on the CPU `.to()` would alias the host array
                t = made[(dev, g)] = torch.from_numpy(np.ascontiguousarray(
                    arr[g * b:(g + 1) * b])).to(dev, copy=True)
            blocks.append(t)
        out.append(tuple(blocks))
    return tuple(out)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def _local_queries(mesh: Mesh, q_idx, n_words: int) -> list:
    """Each data shard's query columns: 32 * W/D of the batch's 32 *
    n_words (n_words a multiple of D)."""
    n_data = mesh.shape["data"]
    if n_words % n_data or len(q_idx) != 32 * n_words:
        raise ValueError(f"{len(q_idx)} query columns do not fill "
                         f"{n_words} words split over {n_data} shards")
    cols = 32 * (n_words // n_data)
    q = _host(q_idx).astype(np.int32)
    return [q[d * cols:(d + 1) * cols] for d in range(n_data)]


def _route_checks(x: list, gather_idx, gather_col, wl: int,
                  check) -> torch.Tensor:
    """`check(state, rows, cols)` per (state row, query column) pair, in
    request order, on shard (0, 0)'s device: each pair is routed to the
    data shard owning its column (col // 32 // wl) and read from that
    shard's graph replica 0."""
    gi = _host(gather_idx).astype(np.int32)
    gc = _host(gather_col).astype(np.int64)
    d_of = gc // 32 // wl
    dev0 = x[0][0].device
    parts, order = [], []
    for d in np.unique(d_of).tolist():
        sel = np.nonzero(d_of == d)[0]
        xs = x[d][0]
        res = check(xs, _to_device(gi[sel], xs.device),
                    _to_device((gc[sel] - d * 32 * wl).astype(np.int32),
                               xs.device))
        parts.append(res.to(dev0))
        order.append(sel)
    if len(parts) == 1 and len(order[0]) == len(gi):
        return parts[0]
    out = torch.empty(len(gi), dtype=torch.int32, device=dev0)
    if parts:
        out[torch.from_numpy(np.concatenate(order)).to(dev0)] = \
            torch.cat(parts)
    return out


def _join_lookup(x: list, slot_offset: int, slot_length: int,
                 words, impl=kernels) -> torch.Tensor:
    """Lookup words [W, slot_length]: `lookup_T` of graph replica 0 of
    each data shard (its first `words` words), word rows in data order,
    on shard (0, 0)'s device."""
    dev0 = x[0][0].device
    parts = [impl.lookup_T(row[0], slot_offset, slot_length, words).to(dev0)
             for row in x]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


class ShardedEllKernel:
    """The bit-packed fixed-fanin sweep over a (data x graph) mesh — the
    reference's ShardedEllKernel (parallel/sharding.py:276-893).

    Layout.  Main rows are padded to n_pad (a multiple of G) and aux rows
    to a_pad; aux references in the main, aux and caveat tables shift by
    n_pad - n.  Shard (d, g) holds row block g of each table (main
    [n_pad/G, K_MAIN], aux [a_pad/G, K_AUX], caveat [(n_pad + a_pad)/G,
    K_CAV] — the caveat table is sharded over the whole row space) and its
    own replica state int32 [n_pad + a_pad, W/D], or [.., 2W/D] with
    planes (definite words, then maybe words, the port's halves layout).

    One sweep (the reference's `_evaluate_shard_fn.step`, Jacobi) from the
    replicas `x` into the replicas `cur`, each pass one launch a card over
    every shard block on it (`step`): `aux_passes` times, the aux blocks
    (`mesh_gather_or`; the first pass reads everything from `x`, a later
    one `x`'s main rows and the previous pass's aux rows, which ping-pong
    between `cur`'s aux rows and the arena's `aux` buffer so that the last
    pass lands in `cur`); then the main blocks with the seed and the
    wildcard terms of their rows (reading `x`'s main rows and `cur`'s
    final aux rows); with planes the caveat closure of each caveat block
    ORed into the maybe words (`mesh_cav_gather_or`, reading `x`); then
    the permission ops (`mesh_perm_program`) and the delta
    (`mesh_sweep_delta`, which zeroes the dead row) once per data shard a
    card.  No pass reads a buffer that one of its launches writes, so
    every gather writes `cur` directly, and every row of `cur` is
    rewritten (main rows by the main gather, aux rows by the last aux
    pass, the dead row zeroed): the sweep copies no input.  Each launch
    reads one replica of a data shard on its card (the lead: the first
    there) and writes every replica of that shard on the card, so
    co-located replicas get their peers' blocks from the kernel that
    computes them, with no copy; a replica on another card gets each
    block by a copy (`all_gather_rows(written=True)`).  The deltas of a
    sweep land in one device tensor and come back in one readback.

    Wildcard liveness comes from the seed (no edge targets a self slot,
    the port's design rule), as on the single-device path.  Every entry
    returns the sweep trace int32 [1 + num_iters]: entry 0 the executed
    sweeps, entry 1 + i the changed bits of sweep i summed over the data
    shards — the reference's sharded trace (KernelIntrospect on), which
    differs from the single-device staged trace.

    A whole batch (arena take, sweeps, readback) runs under one lock, as
    the reference's `_dispatch_lock`: the shards of a batch share the
    bucket's arenas."""

    kernel_name = "ell"

    def __init__(self, prog: GraphProgram, mesh: Mesh,
                 num_iters: Optional[int] = None, tables=None, cav=None):
        """`cav`, given with `tables` by a graph that built both, is the
        caveat table whose dead OR-tree rows `tables.idx_aux` already
        holds; otherwise it is built here and the rows appended."""
        self.prog = prog
        self.mesh = mesh
        t = tables if tables is not None else build_tables(prog)
        n = prog.state_size
        dead = prog.dead_index
        n_graph = mesh.shape["graph"]
        self.planes = bool(len(prog.cav_src)) and prog.caveats_device_ok
        a = t.idx_aux.shape[0]
        tree_depth = t.tree_depth
        self.host_cav_compile = None
        if self.planes:
            if cav is None:
                cav = build_cav_tables(prog, a)
                if cav.n_aux_cav:
                    # caveat OR-tree nodes live in the aux block (dead rows
                    # in the shared aux table; children in the caveat
                    # table)
                    t.idx_aux = np.vstack([
                        t.idx_aux,
                        np.full((cav.n_aux_cav, K_AUX), dead, np.int32)])
                    a += cav.n_aux_cav
            # compile-row-space copy for the graph's incremental edits
            self.host_cav_compile = cav.idx_cav
            tree_depth = max(tree_depth, cav.tree_depth)
        # caveat OR-tree nodes start past this
        self.n_aux_shared = a - (cav.n_aux_cav if self.planes else 0)
        # in-sweep bottom-up aux refresh passes: the shared tree height,
        # +1 spare pass for incrementally grown levels
        self.aux_passes = t.tree_depth + 1
        self.tree_depth = tree_depth
        self.n_pad = _ceil_mult(n, n_graph)
        self.a_pad = _ceil_mult(max(a, 1), n_graph)
        self.rows = self.n_pad + self.a_pad
        self.block_main = self.n_pad // n_graph
        self.block_aux = self.a_pad // n_graph
        self.block_cav = self.rows // n_graph
        base = num_iters or ELL_MAX
        self.num_iters = base * (1 + tree_depth)
        main, aux, cav_dev = self.pad_tables(
            t.idx_main, t.idx_aux, cav.idx_cav if self.planes else None)
        self.idx_main = _blocks(mesh, main, self.block_main)
        self.idx_aux = _blocks(mesh, aux, self.block_aux)
        self.idx_cav = (_blocks(mesh, cav_dev, self.block_cav)
                        if self.planes else None)
        # per device: {data shard: [graph shards on it]}, the first of
        # each list the data shard's lead replica there
        self._placement: dict = {}
        for d, row in enumerate(mesh.devices):
            for g, dev in enumerate(row):
                self._placement.setdefault(dev, {}).setdefault(d, []).append(
                    g)
        if any(len(gs) > kernels.MESH_DSTS
               for per in self._placement.values() for gs in per.values()):
            raise NotImplementedError(
                f"more than {kernels.MESH_DSTS} replicas of one data shard "
                f"on one device")
        self._plans: dict = {}
        self._build_plans()
        self._arenas: dict = {}
        self._arena_lock = threading.Lock()
        self._dispatch_lock = threading.Lock()
        self.last_trace = None

    # -- tables ---------------------------------------------------------------

    def pad_tables(self, idx_main: np.ndarray, idx_aux: np.ndarray,
                   idx_cav: Optional[np.ndarray] = None) -> tuple:
        """Host tables (compile row space) -> the padded device row space:
        main [n_pad, K], aux [a_pad, K_AUX], caveat [n_pad + a_pad, K_CAV]
        (None without planes), aux references shifted by n_pad - n."""
        n = self.prog.state_size
        dead = self.prog.dead_index
        main = np.full((self.n_pad, idx_main.shape[1]), dead, np.int32)
        main[:n] = idx_main
        aux = np.full((self.a_pad, idx_aux.shape[1]), dead, np.int32)
        aux[:idx_aux.shape[0]] = idx_aux
        main, aux = self.remap_values(main), self.remap_values(aux)
        cav = None
        if idx_cav is not None:
            cav = np.full((self.rows, idx_cav.shape[1]), dead, np.int32)
            cav[:n] = idx_cav[:n]
            cav[self.n_pad: self.n_pad + (idx_cav.shape[0] - n)] = \
                idx_cav[n:]
            cav = self.remap_values(cav)
        return main, aux, cav

    def remap_values(self, vals: np.ndarray) -> np.ndarray:
        """Shift aux references for the padded main block (host tables are
        unpadded; device tables pad main rows to a multiple of G)."""
        n = self.prog.state_size
        if self.n_pad != n:
            vals = np.array(vals, np.int32)
            vals[vals >= n] += self.n_pad - n
        return vals

    def snapshot_tables(self) -> tuple:
        """The current [D][G] table blocks: (main, aux[, caveat]).  A flush
        swaps in new blocks and never writes these, so a captured tuple
        stays consistent while a batch sweeps outside the endpoint lock."""
        if self.planes:
            return (self.idx_main, self.idx_aux, self.idx_cav)
        return (self.idx_main, self.idx_aux)

    # -- incremental row updates (the sharded flush) --------------------------

    def _scatter_blocks(self, blocks: tuple, rows: np.ndarray,
                        vals: np.ndarray, b: int, impl=kernels) -> tuple:
        """Copy-on-write `scatter_rows` (`impl`'s: the kernel, or its twin)
        into each touched row block of each data replica, once per
        distinct block tensor; untouched blocks keep their tensors."""
        rows = np.asarray(rows, np.int64)
        vals = np.ascontiguousarray(vals, np.int32)
        g_of = rows // b
        out = [list(r) for r in blocks]
        for g in np.unique(g_of).tolist():
            sel = g_of == g
            local = (rows[sel] - g * b).astype(np.int32)
            new: dict = {}
            for d, row in enumerate(blocks):
                old = row[g]
                if id(old) not in new:
                    new[id(old)] = impl.scatter_rows(
                        old, _to_device(local, old.device),
                        _to_device(vals[sel], old.device))
                out[d][g] = new[id(old)]
        return tuple(tuple(r) for r in out)

    def update_main_rows(self, rows: np.ndarray, vals: np.ndarray) -> None:
        self.idx_main = self._scatter_blocks(
            self.idx_main, rows, self.remap_values(vals), self.block_main)

    def update_aux_rows(self, rows: np.ndarray, vals: np.ndarray) -> None:
        self.idx_aux = self._scatter_blocks(
            self.idx_aux, rows, self.remap_values(vals), self.block_aux)

    def update_cav_rows(self, rows: np.ndarray, vals: np.ndarray) -> None:
        """Caveat-table edits: host rows are in compile row space, and the
        rows shift by the same aux-block offset as the values they hold."""
        self.idx_cav = self._scatter_blocks(
            self.idx_cav, self.remap_values(rows), self.remap_values(vals),
            self.block_cav)

    def note_main_aux_ref(self, row: int) -> bool:
        """The graph's OR-tree growth pointed a main row at an aux node:
        nothing to flip, the sharded sweep has no staged step."""
        return False

    # -- build-time plan ------------------------------------------------------

    def _build_plans(self) -> None:
        """Per device: the wildcard terms' self ranges, each main block's
        wildcard bits (None where no row of the block has one) and each
        permission op's program, uploaded once."""
        prog = self.prog
        terms = list(prog.wildcard_terms)
        if len(terms) > kernels.MAX_WILDCARD_TERMS:
            raise NotImplementedError(
                f"{len(terms)} wildcard terms exceed the kernel's "
                f"{kernels.MAX_WILDCARD_TERMS}")
        bits = np.zeros(self.n_pad, np.uint32)
        for i, term in enumerate(terms):
            bits[np.asarray(term.mask_indices, np.int64)] |= (
                np.uint32(1) << np.uint32(i))
        ops = []
        for op in prog.perm_ops:
            code, depth, _ = compile_perm_program(op.expr, op.offset,
                                                  op.length)
            if depth > kernels.MAX_STACK:
                raise NotImplementedError(
                    f"permission expression needs a stack of {depth} "
                    f"(> {kernels.MAX_STACK})")
            if not reads_in_place(code.tolist(), op.offset, op.length):
                raise RuntimeError(
                    f"permission op at {op.offset} reads rows that overlap "
                    f"its own slot")
            ops.append((code, op.offset, op.length, depth))
        b = self.block_main
        for row in self.mesh.devices:
            for dev in row:
                if dev in self._plans:
                    continue
                wc_ranges = (torch.tensor(
                    [[t.self_offset, t.self_offset + t.self_length]
                     for t in terms], dtype=torch.int32, device=dev)
                    if terms else None)
                wc_bits = []
                for g in range(self.mesh.shape["graph"]):
                    blk = bits[g * b:(g + 1) * b]
                    wc_bits.append(torch.from_numpy(blk.view(np.int32)).to(
                        dev, copy=True) if blk.any() else None)
                self._plans[dev] = (
                    wc_ranges, wc_bits,
                    [(torch.from_numpy(code).to(dev), off, length, depth)
                     for code, off, length, depth in ops])

    # -- state arenas ---------------------------------------------------------

    def width(self, n_words: int) -> int:
        """State words per replica row for a bucket of `n_words` global
        lane words."""
        wl = n_words // self.mesh.shape["data"]
        return 2 * wl if self.planes else wl

    def _alloc_arenas(self, n_words: int) -> list:
        width = self.width(n_words)
        return [[_ShardArena(*(torch.empty((self.rows, width),
                                           dtype=torch.int32, device=dev)
                               for _ in range(3)),
                             torch.empty((self.a_pad, width),
                                         dtype=torch.int32, device=dev))
                 for dev in row] for row in self.mesh.devices]

    def take_arena(self, n_words: int) -> list:
        """Pop the bucket's per-shard arenas ([D][G] of (x0, a, b, aux);
        exclusive: two in-flight batches never share one), allocated on
        first use."""
        with self._arena_lock:
            a = self._arenas.pop(n_words, None)
        return a if a is not None else self._alloc_arenas(n_words)

    def put_arena(self, n_words: int, arenas: list) -> None:
        with self._arena_lock:
            self._arenas.setdefault(n_words, arenas)

    def discard_arena(self, n_words: int) -> None:
        with self._arena_lock:
            self._arenas.pop(n_words, None)

    # -- the sweep ------------------------------------------------------------

    def seed(self, q_idx, n_words: int, arenas: list, impl=kernels) -> tuple:
        """Seed every shard with its own 32 * W/D query columns: ([D][G] x0
        — each arena's x0 —, [D][G] wildcard liveness or None)."""
        wl = n_words // self.mesh.shape["data"]
        x0, live = [], []
        for d, (row, q_local) in enumerate(zip(
                self.mesh.devices,
                _local_queries(self.mesh, q_idx, n_words))):
            x0_row, live_row = [], []
            for g, dev in enumerate(row):
                wc_ranges = self._plans[dev][0]
                lv = (torch.empty((wc_ranges.shape[0], self.width(n_words)),
                                  dtype=torch.int32, device=dev)
                      if wc_ranges is not None else None)
                x0_row.append(impl.seed_bitplanes(
                    _to_device(q_local, dev), self.rows, wl,
                    self.prog.dead_index, out=arenas[d][g].x0,
                    wc_ranges=wc_ranges, live=lv, planes=self.planes))
                live_row.append(lv)
            x0.append(x0_row)
            live.append(live_row)
        return x0, live

    def sweep_calls(self, cur: list, x: list, x0: list, live: list,
                    aux: list, tables: tuple, n_words: int) -> list:
        """One sweep from the replicas `x` into `cur` ([D][G] each; `aux`
        the arenas' aux buffers), as its launches and collectives in
        order: [(name, fn)], `fn(impl)` running that step with `impl` (the
        kernels or their twins); `name` is the kernel's, or
        "all_gather_rows" for the copies to replicas on other devices."""
        main, aux_t = tables[0], tables[1]
        cav = tables[2] if self.planes else None
        n_pad = self.n_pad
        half = n_words // self.mesh.shape["data"] if self.planes else None
        aux_of = lambda bufs: [[t[n_pad:] for t in row] for row in bufs]
        calls: list = []

        def gathers(table, hi, dest, b, seeded):
            for dev, per_d in self._placement.items():
                jobs = []
                for d, gs in per_d.items():
                    lead = gs[0]
                    for g in gs:
                        seed = wcb = wcl = None
                        if seeded:
                            seed = x0[d][lead][g * b:(g + 1) * b]
                            wcb = self._plans[dev][1][g]
                            wcl = live[d][lead] if wcb is not None else None
                        jobs.append((table[d][g], x[d][lead], hi[d][lead],
                                     seed, wcb, wcl,
                                     [dest[d][j][g * b:(g + 1) * b]
                                      for j in gs]))
                calls.append(("mesh_gather_or", lambda impl, jobs=jobs:
                              impl.mesh_gather_or(jobs, n_pad)))
            for d, reps in enumerate(dest):
                calls.append(("all_gather_rows", lambda impl, reps=reps:
                              all_gather_rows(reps, 0, b * len(reps),
                                              written=True)))

        # the aux passes: the last one writes cur's aux rows
        src = aux_of(x)
        for p in range(self.aux_passes):
            dest = aux_of(cur) if (self.aux_passes - 1 - p) % 2 == 0 else aux
            gathers(aux_t, src, dest, self.block_aux, False)
            src = dest
        gathers(main, aux_of(cur), cur, self.block_main, True)
        if cav is not None:
            b = self.block_cav
            for dev, per_d in self._placement.items():
                jobs = [(cav[d][g], x[d][gs[0]],
                         [cur[d][j][g * b:(g + 1) * b] for j in gs])
                        for d, gs in per_d.items() for g in gs]
                calls.append(("mesh_cav_gather_or", lambda impl, jobs=jobs:
                              impl.mesh_cav_gather_or(
                                  jobs, half, self.prog.dead_index)))
            for reps in cur:
                calls.append(("all_gather_rows", lambda impl, reps=reps:
                              all_gather_rows(reps, 0, self.rows,
                                              cols=(half, 2 * half),
                                              written=True)))
        for dev, per_d in self._placement.items():
            for d, gs in per_d.items():
                reps = [cur[d][j] for j in gs]
                for code, off, length, depth in self._plans[dev][2]:
                    calls.append(("mesh_perm_program",
                                  lambda impl, d=d, lead=gs[0], reps=reps,
                                  code=code, off=off, length=length,
                                  depth=depth: impl.mesh_perm_program(
                                      cur[d][lead], x0[d][lead], code, off,
                                      length, reps, half, depth)))
        return calls

    def step(self, cur: list, x: list, x0: list, live: list, aux: list,
             tables: tuple, n_words: int, impl=kernels) -> None:
        """One sweep from the replicas `x` into `cur` with `impl`, the
        kernels or their twins (`sweep_calls`, in order).  Reads nothing
        of `cur` or `aux` as they stood before."""
        for _, fn in self.sweep_calls(cur, x, x0, live, aux, tables,
                                      n_words):
            fn(impl)

    def sweep_deltas(self, cur: list, x: list, out: dict,
                     impl=kernels) -> list:
        """`mesh_sweep_delta` of each data shard once on each device that
        holds one of its replicas, into row d of `out[device]` (int32
        [D, 2], zeroed); every replica's dead row zeroed.  Returns each
        data shard's row on the device of its replica 0."""
        dead = self.prog.dead_index
        for dev, per_d in self._placement.items():
            for d, gs in per_d.items():
                impl.mesh_sweep_delta(cur[d][gs[0]], x[d][gs[0]], dead,
                                      out[dev][d], [cur[d][j] for j in gs])
        return [out[row[0]][d] for d, row in enumerate(self.mesh.devices)]

    def evaluate(self, q_idx, n_words: int, tables: tuple, arenas: list,
                 impl=kernels) -> tuple:
        """Seed, then sweep to the fixpoint (or the iteration cap): the
        first sweep reads the seed, later ones swap the arenas' a and b.
        Returns ([D][G] final replica states — arena buffers —, trace)."""
        x0, live = self.seed(q_idx, n_words, arenas, impl)
        aux = [[ar.aux for ar in row] for row in arenas]
        x = x0
        cur = [[ar.b for ar in row] for row in arenas]
        spare = [[ar.a for ar in row] for row in arenas]
        n_data = self.mesh.shape["data"]
        deltas = {dev: torch.zeros((self.num_iters, n_data, 2),
                                   dtype=torch.int32, device=dev)
                  for dev in self._placement}
        dev0 = self.mesh.devices[0][0]
        trace = np.zeros(1 + self.num_iters, np.int32)
        i = 0
        changed = True
        while changed and i < self.num_iters:
            self.step(cur, x, x0, live, aux, tables, n_words, impl)
            slots = self.sweep_deltas(
                cur, x, {dev: t[i] for dev, t in deltas.items()}, impl)
            trace[1 + i], changed = reduce_data_deltas(deltas[dev0][i],
                                                       slots)
            i += 1
            x, cur = cur, (spare if x is x0 else x)
        trace[0] = i
        return x, trace

    # -- readout --------------------------------------------------------------

    def finish_checks(self, x: list, gather_idx, gather_col, n_words: int,
                      impl=kernels) -> torch.Tensor:
        """Tri-state check values per gather slot ({0, 2}; {0, 1, 2} with
        planes), in request order."""
        wl = n_words // self.mesh.shape["data"]
        if self.planes:
            check = lambda xs, gi, gc: impl.check_gather3(xs, gi, gc, wl)
        else:
            check = impl.check_gather
        return _route_checks(x, gather_idx, gather_col, wl, check)

    def finish_lookup(self, x: list, slot_offset: int, slot_length: int,
                      n_words: int, impl=kernels) -> torch.Tensor:
        """Lookup words [W, slot_length] (the definite plane with
        planes)."""
        wl = n_words // self.mesh.shape["data"]
        return _join_lookup(x, slot_offset, slot_length,
                            wl if self.planes else None, impl)

    def _run(self, n_words: int, q_idx, tables: tuple, finish) -> tuple:
        if self.planes and len(tables) < 3:
            raise ValueError("the plane path needs the caveat table")
        with self._dispatch_lock:
            arenas = self.take_arena(n_words)
            try:
                x, trace = self.evaluate(q_idx, n_words, tables, arenas)
                out = finish(x)
            except BaseException:
                # a failed batch returns no arenas and drops the pooled
                # ones: after a device fault their buffers are suspect
                self.discard_arena(n_words)
                raise
            self.put_arena(n_words, arenas)
        self.last_trace = trace
        return out, trace

    # -- pipelined (device-resident) entry points ----------------------------

    def checks_device(self, q_idx, n_words: int, gather_idx, gather_col,
                      idx_main, idx_aux, idx_cav=None) -> tuple:
        """Tri-state-encoded checks over the mesh ({0, 2}, or {0, 1, 2}
        with planes): (int32 [G] device tensor, trace).  `q_idx` must be
        padded to 32 * n_words lanes with n_words data-divisible (the
        graph's batch_bucket guarantees it)."""
        tables = (idx_main, idx_aux) + ((idx_cav,) if self.planes else ())
        return self._run(n_words, q_idx, tables,
                         lambda x: self.finish_checks(x, gather_idx,
                                                      gather_col, n_words))

    def lookup_packed_T_device(self, slot_offset: int, slot_length: int,
                               q_idx, n_words: int, idx_main, idx_aux,
                               idx_cav=None) -> tuple:
        """Packed lookup over the mesh, word-transposed: (int32 [n_words,
        slot_length] device tensor, trace); bit b of word row w is query
        column w*32+b (the DEFINITE plane with planes)."""
        tables = (idx_main, idx_aux) + ((idx_cav,) if self.planes else ())
        return self._run(n_words, q_idx, tables,
                         lambda x: self.finish_lookup(x, slot_offset,
                                                      slot_length, n_words))

    # -- host-facing ----------------------------------------------------------

    def padded_batch_words(self, batch: int) -> int:
        return padded_batch_words_for(self.mesh.shape["data"], batch)

    def _pad_q(self, q_idx) -> np.ndarray:
        q = _host(q_idx).astype(np.int32)
        w = self.padded_batch_words(len(q))
        out = np.full(w * 32, self.prog.dead_index, np.int32)
        out[: len(q)] = q
        return out

    def _table_args(self, tables=None) -> tuple:
        return tables if tables is not None else self.snapshot_tables()

    def lookup_packed(self, slot_offset: int, slot_length: int, q_idx,
                      tables=None) -> np.ndarray:
        """Packed uint32 [slot_length, padded words] allowed words (bit b
        of word w is query column w*32+b; DEFINITE plane with planes).
        Columns past len(q_idx) are padding."""
        q = self._pad_q(q_idx)
        words, _ = self.lookup_packed_T_device(
            slot_offset, slot_length, q, len(q) // 32,
            *self._table_args(tables))
        return np.ascontiguousarray(words.cpu().numpy().view(np.uint32).T)

    def lookup(self, slot_offset: int, slot_length: int, q_idx,
               tables=None) -> np.ndarray:
        """bool [slot_length, B] allowed bitmap over the real batch."""
        packed = self.lookup_packed(slot_offset, slot_length, q_idx, tables)
        bits = np.unpackbits(packed.view(np.uint8).reshape(slot_length, -1),
                             axis=1, bitorder="little").astype(bool)
        return bits[:, : len(q_idx)]

    def checks(self, q_idx, gather_idx, gather_col,
               tables=None) -> np.ndarray:
        """bool allowed per gather slot — or int8 {0, 1, 2} tri-state with
        planes."""
        q = self._pad_q(q_idx)
        out, _ = self.checks_device(q, len(q) // 32, gather_idx, gather_col,
                                    *self._table_args(tables))
        out = out.cpu().numpy()
        if self.planes:
            return out.astype(np.int8)
        return out != 0


class ShardedKernel:
    """The segment sweep sharded over edges — the reference's
    `make_sharded_evaluate` / ShardedKernel (parallel/sharding.py:63-148).

    The edge capacity is padded to a multiple of G and graph shard g holds
    edges [g * cap/G, (g + 1) * cap/G); the state, packed int32 [N, W/D]
    per shard (the reference's float32 lanes [N, B/D]), is replicated
    along `graph`.  One sweep per shard: `x0 | wildcard terms`, then
    `edge_or` over the shard's own edges, then `or_allreduce` over
    `graph` (the reference's `lax.pmax(y, "graph")`: one `or_combine`
    launch over the co-located replicas), then the permission ops and
    `sweep_delta` on every replica.  The per-device plan (wildcard bits,
    permission programs) is the single-device segment cache's."""

    def __init__(self, prog: GraphProgram, mesh: Mesh,
                 num_iters: Optional[int] = None):
        self.prog = prog
        self.mesh = mesh
        self.num_iters = num_iters or MAX_ITERATIONS
        self._caches: dict = {}
        for row in mesh.devices:
            for dev in row:
                if dev not in self._caches:
                    self._caches[dev] = SegmentKernelCache(
                        prog, dev, num_iters=self.num_iters)
        self._dispatch_lock = threading.Lock()
        self.last_trace = None

    # -- shape discipline -----------------------------------------------------

    def pad_edges_for_mesh(self, capacity: Optional[int] = None) -> tuple:
        n_graph = self.mesh.shape["graph"]
        e = max(len(self.prog.edge_src), 1)
        cap = capacity if capacity is not None else bucket(e)
        if cap % n_graph:
            cap += n_graph - (cap % n_graph)
        return pad_edges(self.prog, cap)

    def device_edges(self, capacity: Optional[int] = None) -> tuple:
        """([D][G] source blocks, [D][G] destination blocks): graph shard g
        of every data replica holds the g-th cap/G slice."""
        src, dst = self.pad_edges_for_mesh(capacity)
        b = len(src) // self.mesh.shape["graph"]
        return _blocks(self.mesh, src, b), _blocks(self.mesh, dst, b)

    # -- the sweep ------------------------------------------------------------

    def seed(self, q_idx, n_words: int, impl=kernels) -> tuple:
        """([D][G] seeds, [D][G] wildcard liveness or None) for a batch
        padded to 32 * n_words lanes, n_words data-divisible."""
        wl = n_words // self.mesh.shape["data"]
        n, dead = self.prog.state_size, self.prog.dead_index
        x0, live = [], []
        for row, q_local in zip(self.mesh.devices,
                                _local_queries(self.mesh, q_idx, n_words)):
            x0_row, live_row = [], []
            for dev in row:
                wc_ranges = self._caches[dev]._wc_ranges
                lv = (torch.empty((wc_ranges.shape[0], wl),
                                  dtype=torch.int32, device=dev)
                      if wc_ranges is not None else None)
                x0_row.append(impl.seed_bitplanes(
                    _to_device(q_local, dev), n, wl, dead,
                    wc_ranges=wc_ranges, live=lv))
                live_row.append(lv)
            x0.append(x0_row)
            live.append(live_row)
        return x0, live

    def partials(self, y: list, x: list, x0: list, live: list, edge_src,
                 edge_dst, impl=kernels) -> None:
        """Each shard's partial one-step closure into y[d][g]: `x0 |
        wildcard terms`, then `edge_or` over its own edges of x[d][g]."""
        for d, row in enumerate(self.mesh.devices):
            for g, dev in enumerate(row):
                kc = self._caches[dev]
                args = (y[d][g], x[d][g], x0[d][g], live[d][g], impl)
                kc.run_step(("init", kc._wc_bits), *args)
                kc.run_step(("edge_or", edge_src[d][g], edge_dst[d][g],
                             self.prog.dead_index), *args)

    def finish_step(self, y: list, x: list, x0: list, live: list,
                    impl=kernels) -> None:
        """The permission ops on every (combined) replica."""
        for d, row in enumerate(self.mesh.devices):
            for g, dev in enumerate(row):
                kc = self._caches[dev]
                for op in kc._ops:
                    kc.run_step(("perm_program",) + op, y[d][g], x[d][g],
                                x0[d][g], live[d][g], impl)

    def evaluate(self, q_idx, n_words: int, edge_src, edge_dst,
                 impl=kernels) -> tuple:
        """Seed, then sweep to the fixpoint (or the cap): ([D][G] final
        replica states, trace int32 [1 + num_iters])."""
        dead = self.prog.dead_index
        x0, live = self.seed(q_idx, n_words, impl)
        x = [[t.clone() for t in row] for row in x0]
        y = [[torch.empty_like(t) for t in row] for row in x0]
        trace = np.zeros(1 + self.num_iters, np.int32)
        i = 0
        changed = True
        while changed and i < self.num_iters:
            self.partials(y, x, x0, live, edge_src, edge_dst, impl)
            for reps in y:
                or_allreduce(reps, impl)
            self.finish_step(y, x, x0, live, impl)
            deltas = [[impl.sweep_delta(a, b, dead) for a, b in zip(yr, xr)]
                      for yr, xr in zip(y, x)]
            trace[1 + i], changed = reduce_sweep_deltas(deltas)
            i += 1
            x, y = y, x
        trace[0] = i
        return x, trace

    def _run(self, q_idx, edge_src, edge_dst, finish):
        n_data = self.mesh.shape["data"]
        q = _host(q_idx).astype(np.int32)
        w = padded_batch_words_for(n_data, len(q))
        qp = np.full(32 * w, self.prog.dead_index, np.int32)
        qp[: len(q)] = q
        with self._dispatch_lock:
            x, trace = self.evaluate(qp, w, edge_src, edge_dst)
            out = finish(x, w // n_data)
        self.last_trace = trace
        return out

    # -- host-facing ----------------------------------------------------------

    def lookup(self, slot_offset: int, slot_length: int, q_idx, edge_src,
               edge_dst) -> np.ndarray:
        """bool [slot_length, len(q_idx)] allowed bitmap."""
        words = self._run(q_idx, edge_src, edge_dst,
                          lambda x, wl: _join_lookup(
                              x, slot_offset, slot_length, None).cpu().numpy())
        packed = np.ascontiguousarray(words.view(np.uint32).T)
        bits = np.unpackbits(packed.view(np.uint8).reshape(slot_length, -1),
                             axis=1, bitorder="little").astype(bool)
        return bits[:, : len(q_idx)]

    def checks(self, q_idx, gather_idx, gather_col, edge_src,
               edge_dst) -> np.ndarray:
        """bool allowed per (state row, query column) gather pair."""
        return self._run(q_idx, edge_src, edge_dst,
                         lambda x, wl: _route_checks(
                             x, gather_idx, gather_col, wl,
                             kernels.check_gather).cpu().numpy() != 0)
