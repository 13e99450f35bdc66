"""Bit-packed ELL (fixed-fanin gather) reachability sweep on torch.

The torch counterpart of the reference's ops/ell.py.  Two halves:

- host (numpy, copied from the reference so both packages build the very
  same tables): `batch_words`, `build_tables`, `build_cav_tables`,
  `compute_stages`, `annotate_stage_refresh`, plus `compile_perm_program`,
  which flattens a permission expression into the postfix code the
  perm_program kernel runs;
- device: `EllKernelCache`, whose pipelined entries `checks_device` and
  `lookup_packed_T_device` seed the bitplanes, run a sweep to its
  fixpoint and gather the answers — every step a hand-written CUDA kernel
  (ops/kernels) on a CUDA device, or the kernels' plain-torch twins on
  the CPU.  The sweep is the staged Gauss-Seidel step on the definite
  path, or the Jacobi step (`stages=()`, and always with `planes`).

Layout: x is int32 [NT, W] (W = batch lanes / 32); rows [0, state_size)
are the GraphProgram's state, rows [state_size, NT) the aux OR-tree nodes
of hub destinations.  The program's dead index is the last state row;
padding slots in both tables point at it and it stays zero.

Tri-state (caveat) path, `planes=True`: x is [NT, 2W], words [0, W) the
DEFINITE plane and [W, 2W) the MAYBE plane (maybe ⊇ definite).  Edges of
caveated tuples whose context cannot decide the caveat live in a third
gather table, idx_cav [NT, K_CAV], which feeds only the maybe plane;
exclusion mixes the planes by Kleene logic.  Checks answer {0, 1, 2}
(NO / CONDITIONAL / HAS), lookups the definite plane only (LookupResources
skips conditional results).

The fixpoint loop runs on the host: after each sweep it reads back the
delta pair (changed bits, any change) — one device sync per sweep.  Each
sweep ends in the check tail, `sweep_delta_checks`: the delta and the
batch's check gather from the new state in one launch, its answers packed
32 slots a word beside the pair and read back with it, so the last
sweep's readback carries the fixpoint's answers and a check batch
launches and copies nothing after its sweeps.  On a CUDA device a
sweep's launches (the copy of the input, every step, the tail and its
copy to pinned host memory) are captured once per state arena, tables,
plan and tail in a CUDA graph, one for each direction between the
arena's two buffers, and each sweep is one replay; moving the
convergence test onto the device is later work (ROADMAP).
"""

from __future__ import annotations

import bisect
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils import devtel, timeline
from . import kernels
from .graph_compile import (
    GraphProgram,
    PExclude,
    PIntersect,
    PRead,
    PUnion,
    PZero,
)
from .kernels.reference import (OP_AND, OP_ANDNOT, OP_OR, OP_READ, OP_ZERO,
                                reads_in_place)

# Main-table fanin: rows with more in-edges are tree-split (production
# graphs are fanin-skewed: most rows have fanin 0 or 1).  The reference
# reads an environment override; the port keeps the default fixed.
K_MAIN = 2
# Aux-node fanin: wider is better for hubs (fewer tree levels).
K_AUX = 32
# Caveat (MAYBE-plane) table fanin; caveated tuples are typically sparse,
# hubs tree-split inside the same table (cav_gather_or's fixed width)
K_CAV = kernels.K_CAV

MAX_ITERATIONS = 50  # matches embedded reference dispatch depth cap

# Check slots an arena's tail holds from the start (more for a wider
# lane bucket): the bucket of a 10,000-pair bulk check, so that serving
# grows a tail, and recaptures its graphs, only past that.
TAIL_SLOTS = 16_384


def batch_words(batch: int, minimum: int = 1) -> int:
    """Power-of-two uint32 word count covering `batch` query columns."""
    w = max(minimum, 1)
    need = (max(batch, 1) + 31) // 32
    while w < need:
        w *= 2
    return w


@dataclass
class EllTables:
    """Host-side adjacency in fixed-fanin form (device copies are owned by
    the endpoint so it can do row-wise incremental updates)."""
    idx_main: np.ndarray                 # int32 [state_size, K_MAIN]
    idx_aux: np.ndarray                  # int32 [n_aux, K_AUX]
    tree_depth: int                      # max OR-tree levels over all hubs
    # trailing all-dead aux rows reserved for incremental growth: a delta
    # insert hitting a full main row moves the row's children into one of
    # these and gains an OR-tree level instead of forcing a rebuild
    spare_rows: tuple = ()               # aux-table row numbers


def build_tables(prog: GraphProgram,
                 k_main: Optional[int] = None) -> EllTables:
    """Group the program's (src, dst) edge list destination-major into
    fixed-fanin tables, tree-splitting hubs.

    Vectorized: one stable sort by destination, then per-slot scatter for
    the (overwhelmingly common) small rows; only hub destinations fall to
    a Python loop."""
    km = k_main if k_main is not None else K_MAIN
    n = prog.state_size
    dead = prog.dead_index
    idx_main = np.full((n, km), dead, np.int32)
    aux_rows: list[np.ndarray] = []
    tree_depth = 0
    e = len(prog.edge_src)
    if e:
        order = np.argsort(prog.edge_dst, kind="stable")
        sdst = prog.edge_dst[order]
        ssrc = prog.edge_src[order]
        starts = np.concatenate(
            [[0], np.nonzero(np.diff(sdst))[0] + 1])
        counts = np.diff(np.concatenate([starts, [e]]))
        gdst = sdst[starts]
        # rank of each edge within its destination group
        rank = np.arange(e) - np.repeat(starts, counts)
        small = counts <= km
        small_edges = np.repeat(small, counts)
        idx_main[sdst[small_edges], rank[small_edges]] = ssrc[small_edges]

        def new_aux(children: np.ndarray) -> int:
            row = np.full(K_AUX, dead, np.int32)
            row[: len(children)] = children
            aux_rows.append(row)
            return n + len(aux_rows) - 1

        for g in np.nonzero(~small)[0]:
            lo = int(starts[g])
            children = ssrc[lo: lo + int(counts[g])]
            depth = 0
            while len(children) > km:
                children = np.asarray(
                    [new_aux(children[i: i + K_AUX])
                     for i in range(0, len(children), K_AUX)], np.int32)
                depth += 1
            idx_main[int(gdst[g]), : len(children)] = children
            tree_depth = max(tree_depth, depth)

    if aux_rows:
        idx_aux = np.stack(aux_rows).astype(np.int32)
    else:
        idx_aux = np.full((0, K_AUX), dead, np.int32)
    # spare pool sized to the graph; hub-free graphs keep an empty aux
    # table (no per-iteration aux gather at all) and fall back to the
    # rebuild path on their rare full-row inserts.  The pool scales with
    # BOTH the aux table (hub growth) and the main row count (capped):
    # under sustained write churn full-row inserts land anywhere in the
    # graph, and the pool drying up is what turns churn back into
    # rebuilds — on the 1M-row graph the main-scaled term costs ~0.5MB
    # of aux table for thousands of extra in-place growths
    # (docs/performance.md "Overload & rebuild behavior").
    if aux_rows:
        n_spare = max(64, len(aux_rows) // 4, min(4096, n // 256))
        spare0 = idx_aux.shape[0]
        idx_aux = np.vstack([idx_aux,
                             np.full((n_spare, K_AUX), dead, np.int32)])
        spares = tuple(range(spare0, spare0 + n_spare))
    else:
        spares = ()
    return EllTables(idx_main=idx_main, idx_aux=idx_aux,
                     tree_depth=tree_depth, spare_rows=spares)


@dataclass
class CavTables:
    """MAYBE-plane adjacency: one [NT, K_CAV] gather table whose OR is the
    one-step closure over UNDECIDABLE caveated edges only.  Caveat hubs
    tree-split into aux rows appended after the shared aux rows (their
    children live in this same table); rows the shared tables own are
    dead-padded here and vice versa."""
    idx_cav: np.ndarray   # int32 [NT, K_CAV]
    n_aux_cav: int
    tree_depth: int


def build_cav_tables(prog: GraphProgram, n_aux_shared: int) -> CavTables:
    """Destination-major fixed-fanin table for the program's caveat edges.
    Python-loop build is fine: caveated tuples are sparse by nature."""
    dead = prog.dead_index
    base = prog.state_size + n_aux_shared
    groups: dict[int, list] = {}
    for s, d in zip(prog.cav_src, prog.cav_dst):
        groups.setdefault(int(d), []).append(int(s))
    aux_rows: list[list] = []
    roots: dict[int, list] = {}
    tree_depth = 0
    for dst, children in groups.items():
        depth = 0
        while len(children) > K_CAV:
            nxt = []
            for i in range(0, len(children), K_CAV):
                aux_rows.append(children[i: i + K_CAV])
                nxt.append(base + len(aux_rows) - 1)
            children = nxt
            depth += 1
        roots[dst] = children
        tree_depth = max(tree_depth, depth)
    nt = base + len(aux_rows)
    idx_cav = np.full((nt, K_CAV), dead, np.int32)
    for dst, children in roots.items():
        idx_cav[dst, : len(children)] = children
    for j, children in enumerate(aux_rows):
        idx_cav[base + j, : len(children)] = children
    return CavTables(idx_cav=idx_cav, n_aux_cav=len(aux_rows),
                     tree_depth=tree_depth)


def compute_stages(prog: GraphProgram) -> tuple:
    """Type-level Gauss-Seidel stages for the staged step: contiguous
    state-row ranges grouped by type-SCC, topologically ordered by the
    COMPILED edge list (type-of(src) -> type-of(dst)).

    Evaluating ranges in this order lets one sweep propagate a whole
    user->group->tenant->namespace->pod chain: the fixpoint trip count
    drops from the type-graph depth to ~the longest in-SCC chain (+1 to
    confirm).  Correctness never depends on the order — the while_loop
    exits at the true fixpoint under ANY update order (monotone OR), so
    delta-added edges that violate the compiled order (or cycles) just
    cost extra sweeps, exactly like the unstaged step.

    Returns a tuple of stage descriptors (ranges, repeat): `ranges` is a
    tuple of (lo, hi) row ranges (SCC members merge when adjacent), and
    `repeat` is 2 when the SCC has internal edges (e.g. group#member
    nesting) so one nesting hop resolves within the sweep instead of
    costing an extra sweep; deeper nests still converge via the outer
    while_loop."""
    # per-type contiguous range from the slot layout
    starts: dict = {}
    for (t, _slot), off in prog.slot_offsets.items():
        starts[t] = min(starts.get(t, off), off)
    if not starts:
        return ()
    types = sorted(starts, key=lambda t: starts[t])
    bounds = [starts[t] for t in types] + [prog.dead_index]
    rng_of = {t: (bounds[i], bounds[i + 1]) for i, t in enumerate(types)}
    # type dependency edges from the compiled edge list
    b = np.asarray(bounds[:-1], np.int64)
    deps: dict = {t: set() for t in types}
    self_dep: set = set()
    if len(prog.edge_src):
        from .graph_compile import SELF_SLOT
        live = prog.edge_dst != prog.dead_index
        esrc = prog.edge_src[live]
        src_t = np.searchsorted(b, esrc, side="right") - 1
        dst_t = np.searchsorted(b, prog.edge_dst[live], side="right") - 1
        # a same-type edge forces a within-sweep repeat only when its
        # source is a DYNAMIC slot; sources in the type's self range are
        # static query seeds and resolve in the first pass regardless
        self_lo = np.asarray(
            [prog.slot_offsets.get((t, SELF_SLOT), -1) for t in types],
            np.int64)
        self_hi = self_lo + np.asarray(
            [prog.num_objects.get(t, 0) for t in types], np.int64)
        in_self = (esrc >= self_lo[src_t]) & (esrc < self_hi[src_t])
        for s, d, st in set(zip(src_t.tolist(), dst_t.tolist(),
                                in_self.tolist())):
            if not (0 <= s < len(types) and 0 <= d < len(types)):
                continue
            if s == d:
                if not st:
                    self_dep.add(types[d])
            else:
                deps[types[d]].add(types[s])  # d depends on s
    # SCC condensation (iterative Tarjan) + topological order
    index: dict = {}
    low: dict = {}
    on_stack: dict = {}
    stack: list = []
    sccs: list = []
    counter = [0]
    for root in types:
        if root in index:
            continue
        work = [(root, iter(sorted(deps[root])))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack[root] = True
        while work:
            v, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack[nxt] = True
                    work.append((nxt, iter(sorted(deps[nxt]))))
                    advanced = True
                    break
                if on_stack.get(nxt):
                    low[v] = min(low[v], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    u = stack.pop()
                    on_stack[u] = False
                    comp.append(u)
                    if u == v:
                        break
                sccs.append(comp)
    # Tarjan emits SCCs in reverse topological order of the traversal
    # graph; with edges pointing dependent -> prerequisite, that is
    # exactly prerequisites-first — the evaluation order we want
    stages: list = []
    for comp in sccs:
        ranges = sorted(rng_of[t] for t in comp)
        merged = [list(ranges[0])]
        for lo, hi in ranges[1:]:
            if lo == merged[-1][1]:
                merged[-1][1] = hi
            else:
                merged.append([lo, hi])
        rtuple = tuple((lo, hi) for lo, hi in merged if hi > lo)
        if not rtuple:
            continue
        repeat = 2 if (len(comp) > 1 or any(t in self_dep for t in comp)) \
            else 1
        stages.append((rtuple, repeat, True))
    return tuple(stages)


def annotate_stage_refresh(stages: tuple, host_main: np.ndarray,
                           state_size: int) -> tuple:
    """Set each stage's aux-refresh flag to whether its gather table rows
    actually reference aux nodes (values >= state_size): stages that
    never read the aux table skip the per-stage OR-tree refresh.  The
    flags are a convergence-speed hint computed at build time — deltas
    that later grow a tree into a flag-less stage only cost extra
    sweeps (the while_loop still exits at the true fixpoint)."""
    out = []
    for ranges, repeat, _ in stages:
        refs = any(bool((host_main[lo:hi] >= state_size).any())
                   for lo, hi in ranges)
        out.append((ranges, repeat, refs))
    return tuple(out)


def compile_perm_program(expr, offset: int, length: int) -> tuple:
    """Postfix code (int32 pairs) for one permission op, as the
    perm_program kernel runs it; returns (code, stack depth, reads own
    rows).  Mirrors the reference's _apply_perm_expr_packed: union = OR,
    intersection = AND, exclusion = AND-NOT (across planes when the
    kernel runs in plane mode)."""
    code: list = []
    depth = [0, 0]   # current, max
    self_read = [False]

    def push():
        depth[0] += 1
        depth[1] = max(depth[1], depth[0])

    def emit(e) -> None:
        if isinstance(e, PRead):
            if e.length != length:
                raise ValueError(f"slot length {e.length} != op length "
                                 f"{length}")
            code.extend((OP_READ, e.offset))
            self_read[0] |= e.offset == offset
            push()
        elif isinstance(e, PZero):
            code.extend((OP_ZERO, 0))
            push()
        elif isinstance(e, (PUnion, PIntersect)):
            for c in e.children:
                emit(c)
            code.extend((OP_OR if isinstance(e, PUnion) else OP_AND,
                         len(e.children)))
            depth[0] -= len(e.children) - 1
        elif isinstance(e, PExclude):
            emit(e.base)
            emit(e.subtract)
            code.extend((OP_ANDNOT, 0))
            depth[0] -= 1
        else:
            raise TypeError(f"unknown perm expr {e!r}")

    emit(expr)
    return np.asarray(code, np.int32), depth[1], self_read[0]


# versions of the (tables, plan) a bucket's sweep graphs were captured
# for, unique across kernel caches
_TABLE_VERSIONS = itertools.count(1)


@dataclass
class _Arena:
    """One bucket's state buffers, [NT, W] int32 each ([NT, 2W] with
    planes): the seed x0 and the two sweep states the fixpoint loop swaps
    between; the wildcard liveness [T, W] (None without wildcard terms).

    The check tail (`sweep_delta_checks`, `size_tail`): `tail` [2 + 2C]
    holds G, then the batch's (row, column) gather pairs, written by the
    host once a batch (C = `cap` slots, a multiple of 32; `g` the G it
    holds); `out` [4 + C / 32] ([4 + C / 16] with planes) two delta
    pairs (a sweep adds into the pair of its direction and zeroes the
    other) and the last sweep's packed answers; on a card `host` the
    pinned copy of `out`, which each sweep writes, and `stage` the pinned
    buffer the tail is copied from; `words` a numpy view of `host` (of
    `out` on the CPU).

    On a CUDA device also the bucket's query lanes `q` [32 W] (a batch's
    lanes are copied in, so that the seed graph reads them), the seed's
    captured graph (the seed and its copy into `a`), the sweep's two
    captured graphs with the tables, plan and tail they were captured for
    (`graph_key`, which also keeps those tensors alive while the graphs
    may replay them) and the memory pool that every capture of this arena
    reuses (its graphs never replay at the same time: the arena is one
    batch's at a time)."""
    x0: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    live: Optional[torch.Tensor] = None
    q: Optional[torch.Tensor] = None
    tail: Optional[torch.Tensor] = None
    out: Optional[torch.Tensor] = None
    host: Optional[torch.Tensor] = None
    stage: Optional[torch.Tensor] = None
    words: Optional[np.ndarray] = None
    cap: int = 0
    g: int = 0
    seed_graph: Optional[object] = None
    graph_key: Optional[tuple] = None
    graphs: Optional[list] = None
    pool: Optional[tuple] = None    # the graphs' memory pool, kept


class EllKernelCache(devtel.ArenaLedger):
    """Packed check/lookup entry points for one (program, tables) pair on
    one device — the pipelined and serial paths of the reference's
    EllKernelCache (ops/ell.py:676-1088), with the KernelIntrospect sweep
    trace always on: every call returns an int32 [1 + num_iters] trace,
    entry 0 the executed sweep count and entry 1 + i popcount(x1 ^ x) of
    sweep i.

    With `planes=True` the state carries definite/maybe bitplanes and the
    entry points take the caveat table `idx_cav`: checks return tri-state
    {0, 1, 2}, lookups the DEFINITE plane.  The plane path sweeps with the
    Jacobi step, as the reference's does; `stages=()` selects the same
    step on the definite path (the reference's SPICEDB_TPU_STAGED=0).

    Where each gather writes is part of the plan: a staged row range, or
    the aux refresh, writes the state in place when its host table reads
    none of its own rows (counted at build from `host_main`/`host_aux`
    and kept true by `note_row`; unknown tables mean scratch), and the
    Jacobi main gather always does, reading its own rows from the sweep's
    input.  Permission programs always write in place.

    Kernel accounting (utils/devtel.py): a capture of an arena's sweep
    graphs is a compile of its lane bucket (and a `compile` slice on the
    dispatch timeline), a batch that replays them a graph-cache hit; the
    pooled arenas are ledger rows of the cache's graph generation."""

    # metric label of authz_sweep_iterations / authz_frontier_decay
    kernel_name = "ell"

    def __init__(self, prog: GraphProgram, n_aux_rows: int, tree_depth: int,
                 device: torch.device, num_iters: Optional[int] = None,
                 shared_tree_depth: Optional[int] = None,
                 host_main: Optional[np.ndarray] = None,
                 stages: Optional[tuple] = None, planes: bool = False,
                 host_aux: Optional[np.ndarray] = None):
        self.prog = prog
        self.n_aux_rows = n_aux_rows
        self.device = torch.device(device)
        self.planes = planes
        # in-sweep bottom-up aux refresh passes: the shared table's tree
        # height, +1 spare pass (as the reference sizes it); cav trees
        # climb one level per sweep and only count toward the cap
        std = shared_tree_depth if shared_tree_depth is not None else tree_depth
        self.aux_passes = std + 1
        base = num_iters or MAX_ITERATIONS
        self.tree_depth = tree_depth
        self.num_iters = base * (1 + tree_depth)
        if planes:
            if stages:
                raise ValueError("the plane path has no staged step")
            stages = ()
        elif stages is None:
            stages = compute_stages(prog)
            if stages and host_main is not None:
                stages = annotate_stage_refresh(stages, host_main,
                                                prog.state_size)
        self.stages = stages
        self._count_self_reads(host_main, host_aux)
        self._plan = self._build_plan()
        self._arenas: dict = {}
        self._arena_lock = threading.Lock()
        # CUDA graph upkeep: captures (and their host seconds), replayed
        # sweeps, sweeps launched step by step on the card
        self.graph_stats = {"captures": 0, "capture_s": 0.0, "replays": 0,
                            "eager_sweeps": 0, "seed_replays": 0}
        # per lane bucket, the tables and plan of its last capture and
        # their version (the recompile-storm detector's key: a capture
        # for new tables starts a new one)
        self._captured: dict = {}
        devtel.KERNELS.track(self)

    @property
    def _jits(self) -> list:
        """The pooled arenas holding captured sweep graphs (the graph
        cache that the entries gauge counts)."""
        with self._arena_lock:
            return [a for a in self._arenas.values() if a.graphs]

    def _arena_tensors(self, arena: _Arena) -> tuple:
        return (arena.x0, arena.a, arena.b, arena.live, arena.q, arena.tail,
                arena.out)

    # -- build-time plan -----------------------------------------------------

    def _count_self_reads(self, host_main: Optional[np.ndarray],
                          host_aux: Optional[np.ndarray]) -> None:
        """Per staged row range, the entries of its host main-table rows
        that point inside it; and the aux entries that point at aux nodes
        (the aux refresh writes every aux row).  A gather whose count is 0
        reads none of the rows it writes.  None where the table is not
        given."""
        n = self.prog.state_size
        self._ranges = sorted((lo, hi) for ranges, _, _ in self.stages
                              for lo, hi in ranges)
        self._range_lo = [lo for lo, _ in self._ranges]
        self._range_index = {r: i for i, r in enumerate(self._ranges)}
        self._main_reads = None if host_main is None else [
            int(((host_main[lo:hi] >= lo) & (host_main[lo:hi] < hi)).sum())
            for lo, hi in self._ranges]
        self._aux_reads = (None if host_aux is None
                           else int((host_aux >= n).sum()))

    def _gather_mode(self, lo: int, hi: int) -> str:
        """How the main gather of rows [lo, hi) writes: "x_in" (the Jacobi
        step: in place, its own rows read from the sweep's input),
        "in_place" (no row of the range is read), else "scratch"."""
        if not self.stages:
            return "x_in"
        if self._main_reads is not None and \
                self._main_reads[self._range_index[(lo, hi)]] == 0:
            return "in_place"
        return "scratch"

    def _aux_mode(self) -> str:
        return "in_place" if self._aux_reads == 0 else "scratch"

    def _build_plan(self) -> list:
        """Per stage: (repeat, wants_aux, [(lo, hi, wc_bits, mode)],
        [(code, offset, length, depth)], aux mode), with every table the
        kernels read uploaded once.  Perm ops and wildcard terms are
        grouped by the stage whose ranges contain them (a type's slots are
        contiguous, so containment is exact), as the reference groups
        them.  The Jacobi step is one pseudo-stage: every state row and
        every perm op in program order.  Every program writes in place:
        slots are disjoint row ranges of one length, so a READ is of the
        output slot itself or of rows outside it (checked here)."""
        prog, dev = self.prog, self.device
        terms = list(prog.wildcard_terms)
        if len(terms) > kernels.MAX_WILDCARD_TERMS:
            raise NotImplementedError(
                f"{len(terms)} wildcard terms exceed the kernel's "
                f"{kernels.MAX_WILDCARD_TERMS}")
        # self-row ranges of the wildcard terms: the seed kernel derives
        # each term's liveness from them
        self._wc_ranges = (torch.tensor(
            [[t.self_offset, t.self_offset + t.self_length] for t in terms],
            dtype=torch.int32, device=dev) if terms else None)
        masks = [np.asarray(t.mask_indices, np.int64) for t in terms]

        def in_stage(ranges, off):
            return any(lo <= off < hi for lo, hi in ranges)

        stages = self.stages or ((((0, prog.state_size),), 1, True),)
        aux_mode = self._aux_mode()
        plan = []
        for ranges, repeat, wants_aux in stages:
            rows = []
            for lo, hi in ranges:
                # bit i of a row's mask word: wildcard term i grants it
                bits = np.zeros(hi - lo, np.uint32)
                for i, m in enumerate(masks):
                    m = m[(m >= lo) & (m < hi)]
                    bits[m - lo] |= np.uint32(1) << np.uint32(i)
                wc = (torch.from_numpy(bits.view(np.int32)).to(dev)
                      if bits.any() else None)
                rows.append((lo, hi, wc, self._gather_mode(lo, hi)))
            ops = []
            for op in prog.perm_ops:
                if not in_stage(ranges, op.offset):
                    continue
                code, depth, _ = compile_perm_program(op.expr, op.offset,
                                                      op.length)
                if depth > kernels.MAX_STACK:
                    raise NotImplementedError(
                        f"permission expression needs a stack of {depth} "
                        f"(> {kernels.MAX_STACK})")
                if len(code) // 2 > kernels.MAX_PROGRAM:
                    raise NotImplementedError(
                        f"permission program of {len(code) // 2} "
                        f"instructions (> {kernels.MAX_PROGRAM})")
                if not reads_in_place(code.tolist(), op.offset, op.length):
                    raise RuntimeError(
                        f"permission op at {op.offset} reads rows that "
                        f"overlap its own slot")
                ops.append((torch.from_numpy(code).to(dev), op.offset,
                            op.length, depth))
            plan.append((repeat, wants_aux, rows, ops, aux_mode))
        return plan

    def note_main_aux_ref(self, row: int) -> bool:
        """Incremental growth (the endpoint graph's `_grow`) pointed main
        row `row` at an OR-tree aux node.  If the stage covering that row
        was annotated aux-free at build time, flip its wants_aux flag so
        its gathers see refreshed aux rows (reference ell.py:733-753);
        returns True when a flip happened.  The flip builds a NEW plan
        list: a batch that already took the old one (`evaluate`) sweeps
        on with it — the flip only adds a refresh, so answers agree."""
        if not self.stages:
            return False
        for i, (ranges, repeat, wants_aux) in enumerate(self.stages):
            if any(lo <= row < hi for lo, hi in ranges):
                if wants_aux:
                    return False
                self.stages = (self.stages[:i] + ((ranges, repeat, True),)
                               + self.stages[i + 1:])
                plan = list(self._plan)
                p_repeat, _, rows, ops, aux_mode = plan[i]
                plan[i] = (p_repeat, True, rows, ops, aux_mode)
                self._plan = plan
                return True
        return False

    def note_row(self, table: str, row: int, old: np.ndarray,
                 new: np.ndarray) -> None:
        """The endpoint graph changed row `row` of its host main ("m") or
        aux ("a") table from `old` to `new`: keep the self-read counts
        true.  The plan follows at `sync_in_place`."""
        if table == "m":
            if self._main_reads is None:
                return
            i = bisect.bisect_right(self._range_lo, row) - 1
            if i < 0 or row >= self._ranges[i][1]:
                return
            lo, hi = self._ranges[i]
            inside = lambda v: int(((v >= lo) & (v < hi)).sum())
            self._main_reads[i] += inside(new) - inside(old)
        elif self._aux_reads is not None:
            n = self.prog.state_size
            self._aux_reads += int((new >= n).sum()) - int((old >= n).sum())

    def sync_in_place(self) -> bool:
        """After a flush: give each gather the write mode its range's
        count now proves (a new child inside its own range moves it to
        scratch; removing the last one moves it back in place).  A change
        builds a NEW plan list, which goes into the graph's snapshots with
        the flushed tables; a batch holding an older snapshot sweeps its
        tables with its own plan.  Returns True when a mode changed."""
        aux_mode = self._aux_mode()
        plan, changed = [], False
        for repeat, wants_aux, rows, ops, old_aux in self._plan:
            new_rows = [(lo, hi, wc, self._gather_mode(lo, hi))
                        for lo, hi, wc, _ in rows]
            changed |= old_aux != aux_mode or any(
                a[3] != b[3] for a, b in zip(rows, new_rows))
            plan.append((repeat, wants_aux, new_rows, ops, aux_mode))
        if changed:
            self._plan = plan
        return changed

    @property
    def plan(self) -> list:
        """The current sweep plan (see `_build_plan`)."""
        return self._plan

    # -- state arenas --------------------------------------------------------

    def width(self, n_words: int) -> int:
        """State words per row for a bucket of `n_words` lane words."""
        return 2 * n_words if self.planes else n_words

    def take_arena(self, n_words: int) -> _Arena:
        """Pop the bucket's state arena (exclusive: two in-flight calls
        never share one); allocated on first use."""
        with self._arena_lock:
            a = self._arenas.pop(n_words, None)
        if a is not None:
            return a
        nt = self.prog.state_size + self.n_aux_rows
        w = self.width(n_words)
        live = (torch.empty((self._wc_ranges.shape[0], w), dtype=torch.int32,
                            device=self.device)
                if self._wc_ranges is not None else None)
        q = (torch.empty(32 * n_words, dtype=torch.int32, device=self.device)
             if self.device.type == "cuda" else None)
        a = _Arena(*(torch.empty((nt, w), dtype=torch.int32,
                                 device=self.device)
                     for _ in range(3)), live=live, q=q)
        self.size_tail(a, max(TAIL_SLOTS, 32 * n_words))
        self._ledger_arena(n_words, a)
        return a

    def size_tail(self, arena: _Arena, cap: int) -> None:
        """Give `arena` a check tail of `cap` slots (rounded up to whole
        answer words) holding G = 0.  The arena's graphs were captured
        over the old buffers: the sweep graphs' key no longer matches and
        the seed graph (which zeroes the delta pairs) is dropped, so the
        next batch seeds step by step and recaptures."""
        cap = -(-cap // 32) * 32
        words = 4 + cap // 32 * (2 if self.planes else 1)
        arena.tail = torch.zeros(2 + 2 * cap, dtype=torch.int32,
                                 device=self.device)
        arena.out = torch.zeros(words, dtype=torch.int32, device=self.device)
        if self.device.type == "cuda":
            arena.host = torch.zeros(words, dtype=torch.int32,
                                     pin_memory=True)
            arena.stage = torch.zeros(2 + 2 * cap, dtype=torch.int32,
                                      pin_memory=True)
        arena.words = (arena.host if arena.host is not None
                       else arena.out).numpy()
        arena.cap, arena.g = cap, 0
        arena.seed_graph = None

    def _load_tail(self, arena: _Arena, n_words: int, gathers) -> None:
        """Write a batch's check slots into the arena's tail (one copy to
        the card), or G = 0 for a batch without checks when the tail held
        some.  A batch of more slots than the tail holds first grows it
        to the next power of two."""
        g = 0 if gathers is None else len(gathers[0])
        if g > arena.cap:
            self.size_tail(arena, 1 << (g - 1).bit_length())
            self._ledger_arena(n_words, arena)
        if g:
            n = 2 + 2 * g
            # pinned staging on a card: the copy need not wait for the
            # stream, and the buffer is written again only by this
            # arena's next batch, after this one's sweeps read back
            stage = (arena.stage[:n] if arena.stage is not None
                     else torch.empty(n, dtype=torch.int32))
            buf = stage.numpy()
            buf[0], buf[1] = g, 0
            buf[2::2], buf[3::2] = gathers
            arena.tail[:n].copy_(stage, non_blocking=True)
        elif arena.g:
            arena.tail[:1].zero_()
        arena.g = g

    def _answers(self, arena: _Arena) -> torch.Tensor:
        """The last sweep's answers to the tail's G slots, decoded on the
        host from its packed words (the sweep's own readback): int32 [G],
        {0, 2}, or {0, 1, 2} with planes."""
        words, nw = arena.words, arena.cap // 32
        bits = lambda lo: np.unpackbits(
            words[lo:lo + nw].view(np.uint8), bitorder="little")[:arena.g]
        out = bits(4).astype(np.int32) * 2
        if self.planes:
            out += bits(4 + nw)
        return torch.from_numpy(out)

    def put_arena(self, n_words: int, arena: _Arena) -> None:
        """Return an arena to the pool; if a concurrent call repooled
        first, this one is dropped."""
        with self._arena_lock:
            self._arenas.setdefault(n_words, arena)

    def discard_arena(self, n_words: int) -> None:
        """Drop a bucket's pooled arena (after a failed call)."""
        with self._arena_lock:
            self._arenas.pop(n_words, None)
        self._unledger_arena(n_words)

    # -- the sweep -----------------------------------------------------------

    def sweep_steps(self, idx_main, idx_aux, idx_cav=None,
                    n_words: Optional[int] = None,
                    plan: Optional[list] = None):
        """The kernel calls of one sweep, in order: ("ell_gather_or", idx,
        dst_lo, seeded, wc_bits, mode), ("cav_gather_or", idx_cav, half,
        dead) and ("perm_program", code, offset, length, in_place, half,
        depth); `mode` is where the gather writes (`_gather_mode`), `half`
        is `n_words` on the plane path and None on the definite one,
        `dead` the dead row (the caveat kernel skips its gathers).  `plan`
        defaults to the current one.

        Staged step (reference staged_step, ell.py:444-500): each stage
        pass first refreshes the aux OR-trees (`aux_passes` Jacobi passes)
        when its rows read aux roots, then gathers its row ranges, then
        runs its permission ops; a final refresh leaves the aux rows
        consistent with the state, so a fixpoint compares unchanged.

        Jacobi step (reference step, ell.py:504-551): the aux refresh
        passes, the main gather over every state row (reading the state
        rows of the sweep's input and the refreshed aux rows), the caveat
        gather into the maybe plane (reading the sweep's INPUT, its aux
        rows included, so caveat trees climb one level per sweep), then
        every perm op in program order on the result."""
        half = n_words if self.planes else None
        n = self.prog.state_size
        plan = plan if plan is not None else self._plan
        refresh = [("ell_gather_or", idx_aux, n, False, None, plan[0][4])] \
            * (self.aux_passes if self.n_aux_rows else 0)
        if not self.stages:
            yield from refresh
            ((_, _, rows, ops, _),) = plan
            for lo, hi, wc, mode in rows:
                yield ("ell_gather_or", idx_main[lo:hi], lo, True, wc, mode)
            if self.planes and idx_cav is not None:
                yield ("cav_gather_or", idx_cav, half,
                       self.prog.dead_index)
            for code, off, length, depth in ops:
                yield ("perm_program", code, off, length, True, half, depth)
            return
        for repeat, wants_aux, rows, ops, _ in plan:
            for _ in range(repeat):
                if wants_aux:
                    yield from refresh
                for lo, hi, wc, mode in rows:
                    yield ("ell_gather_or", idx_main[lo:hi], lo, True, wc,
                           mode)
                for code, off, length, depth in ops:
                    yield ("perm_program", code, off, length, True, None,
                           depth)
        yield from refresh

    @staticmethod
    def run_step(step, cur, x0, live, impl=kernels, x_in=None) -> None:
        """Run one sweep step on `cur` with `impl` — the kernel wrappers,
        or their twins (kernels.reference) to hold a kernel against its
        plain version on the same inputs.  `x_in` is the sweep's input
        state, which the caveat gather and the Jacobi main gather read
        (the latter only for rows where it equals `cur`)."""
        kind = step[0]
        if kind == "ell_gather_or":
            _, idx, dst_lo, seeded, wc, mode = step
            if mode == "x_in" and x_in is None:
                raise ValueError("this gather reads the sweep's input: "
                                 "pass x_in")
            impl.ell_gather_or(cur, idx, dst_lo, x0=x0 if seeded else None,
                               wc_bits=wc,
                               wc_live=live if wc is not None else None,
                               in_place=mode == "in_place",
                               x_in=x_in if mode == "x_in" else None)
        elif kind == "cav_gather_or":
            _, idx, half, dead = step
            impl.cav_gather_or(cur, x_in, idx, half, dead=dead)
        else:
            _, code, off, length, in_place, half, depth = step
            impl.perm_program(cur, x0, code, off, length, in_place=in_place,
                              half=half, depth=depth)

    def evaluate(self, q_idx: torch.Tensor, n_words: int, idx_main,
                 idx_aux, arena: _Arena, idx_cav=None,
                 plan: Optional[list] = None) -> tuple:
        """Seed, then sweep to the fixpoint (or the iteration cap).
        Returns (final state — one of the arena's buffers, trace).  The
        whole batch sweeps with `plan` (the one its snapshot captured;
        default the current one).

        Each sweep starts `cur` as a copy of the input `x` and leaves it
        the next state, dead row zeroed by its tail.  `live` is the
        wildcard liveness: the reference ORs the self rows of the sweep's
        input state, which always equal the seed's (no edge, definite or
        caveated, targets a self slot), so the seed kernel computes it
        once.  On a CUDA device every sweep is one replay of a CUDA graph
        of the arena (`_sweep_graphs`), and so is the seed when the batch's
        lanes are the arena's `q`; on the CPU the twins run step by
        step."""
        return self._evaluate(q_idx, n_words, (idx_main, idx_aux, idx_cav),
                              arena, plan, self.device.type == "cuda")

    def _evaluate_eager(self, q_idx: torch.Tensor, n_words: int, idx_main,
                        idx_aux, arena: _Arena, idx_cav=None,
                        plan: Optional[list] = None) -> tuple:
        """`evaluate` with every sweep launched step by step, as the CPU
        runs it: what the graphs replay, for the card tests and the
        measurements that hold the two side by side."""
        return self._evaluate(q_idx, n_words, (idx_main, idx_aux, idx_cav),
                              arena, plan, False)

    def _seed(self, q_idx, n_words: int, arena: _Arena) -> None:
        """The seed into arena.x0 (and the liveness), copied into arena.a
        as the first sweep's input; the delta pairs that the sweeps add
        into start at zero."""
        kernels.seed_bitplanes(q_idx, self.prog.state_size
                               + self.n_aux_rows, n_words,
                               self.prog.dead_index, out=arena.x0,
                               wc_ranges=self._wc_ranges, live=arena.live,
                               planes=self.planes)
        arena.a.copy_(arena.x0)
        arena.out[:4].zero_()

    def _evaluate(self, q_idx, n_words: int, tables: tuple, arena: _Arena,
                  plan: Optional[list], graphs: bool) -> tuple:
        plan = plan if plan is not None else self._plan
        seed = (arena.seed_graph if graphs and q_idx is arena.q else None)
        if seed is None:
            self._seed(q_idx, n_words, arena)
        else:
            seed.replay()
            self.graph_stats["seed_replays"] += 1
        bufs = (arena.a, arena.b)
        replay = self._sweep_graphs(arena, tables, plan) if graphs else None
        if replay is not None:
            devtel.KERNELS.note_jit_hit(n_words * 32)
        trace = np.zeros(1 + self.num_iters, np.int32)
        i = 0
        changed = True
        while changed and i < self.num_iters:
            p = i % 2
            if replay is None:
                self._sweep(bufs[p], bufs[1 - p], arena, tables, n_words,
                            plan, slot=p)
                if graphs:
                    self.graph_stats["eager_sweeps"] += 1
            else:
                graph = replay[p]
                graph.replay()
                self.graph_stats["replays"] += 1
            delta, any_change = self._readback(arena, p)
            if seed is not None and i == 0:
                # the seed graph ran before this sweep's readback
                kernels.note_replay(seed)
            if replay is not None:
                kernels.note_replay(graph)
            if graphs and replay is None:
                # the first sweep after a miss ran every kernel of the
                # plan once (loaded); now capture both directions
                replay = self._capture(arena, tables, n_words, plan)
            trace[1 + i] = delta
            changed = bool(any_change)
            i += 1
        trace[0] = i
        return bufs[i % 2], trace

    def _readback(self, arena: _Arena, slot: int) -> tuple:
        """The sweep's readback: its (changed bits, any change) pair in
        `slot`, from the host copy the sweep itself made on a card (a wait
        on the stream), or from `out` on the CPU.  The answer words beside
        the pairs stay in `arena.words` for `_answers`."""
        if arena.host is not None:
            torch.cuda.current_stream(self.device).synchronize()
        return int(arena.words[2 * slot]), int(arena.words[2 * slot + 1])

    def _sweep(self, x, cur, arena: _Arena, tables: tuple, n_words: int,
               plan: list, slot: int = 0) -> torch.Tensor:
        """One sweep from `x` into `cur`, ending in the check tail
        (`sweep_delta_checks`): pair `slot` of the arena's `out` (its
        direction's: 0 from `a`, 1 from `b`) gets [changed bits, any
        change], the other pair zero, and the answer words the packed
        answers of its tail's slots; on a card its pinned `host` gets a
        copy of them.  Returns `out`."""
        cur.copy_(x)
        for step in self.sweep_steps(*tables, n_words, plan):
            self.run_step(step, cur, arena.x0, arena.live, x_in=x)
        return kernels.sweep_delta_checks(
            cur, x, self.prog.dead_index, arena.tail, arena.out,
            half=n_words if self.planes else None, host=arena.host,
            slot=slot)

    @staticmethod
    def _sweep_graphs(arena: _Arena, tables: tuple, plan: list):
        """The arena's captured sweep graphs if they were captured for
        these very tables, this plan and this tail (identity), else None:
        a flush, a plan change, a grown tail or a new arena recaptures,
        and a graph is never replayed over pointers it was not captured
        with."""
        key = arena.graph_key
        if key is not None and all(a is b for a, b in zip(
                key, (*tables, plan, arena.tail))):
            return arena.graphs
        return None

    def _capture(self, arena: _Arena, tables: tuple, n_words: int,
                 plan: list) -> list:
        """Capture one sweep in each direction between the arena's two
        buffers: [graph a -> b, graph b -> a], each ending in the check
        tail and its copy to the host; and, once an arena, the seed from
        its `q` lanes (it reads no table)."""
        t0 = time.perf_counter()
        if arena.pool is None:
            arena.pool = torch.cuda.graph_pool_handle()
        if arena.seed_graph is None and arena.q is not None:
            seed = kernels.LaunchGraph(self.device, arena.pool)
            seed.capture(lambda: self._seed(arena.q, n_words, arena))
            arena.seed_graph = seed
        # the old graphs go only after the new ones hold the pool, so that
        # its memory stays reserved for them
        graphs = []
        for slot, (x, cur) in enumerate(((arena.a, arena.b),
                                         (arena.b, arena.a))):
            graph = kernels.LaunchGraph(self.device, arena.pool)
            graph.capture(lambda x=x, cur=cur, slot=slot: self._sweep(
                x, cur, arena, tables, n_words, plan, slot))
            graphs.append(graph)
        arena.graph_key = (*tables, plan, arena.tail)
        arena.graphs = graphs
        self.graph_stats["captures"] += 1
        self.graph_stats["capture_s"] += time.perf_counter() - t0
        key = (*tables, plan)
        last = self._captured.get(n_words)
        if last is None or not all(a is b for a, b in zip(last[0], key)):
            last = (key, next(_TABLE_VERSIONS))
            self._captured[n_words] = last
        devtel.KERNELS.note_compile(n_words * 32, owner=last[1])
        timeline.record("compile", "device", t0, bucket=n_words * 32)
        return graphs

    def _run(self, n_words: int, q_idx, idx_main, idx_aux, idx_cav,
             finish, plan: Optional[list] = None, gathers=None) -> tuple:
        """Seed and sweep a batch on a pooled arena, then `finish(x)` on
        the final state, or, with `gathers` ((row, column) int32 arrays),
        the answers its sweeps' check tail gathered and read back."""
        if self.planes and idx_cav is None:
            raise ValueError("the plane path needs the caveat table")
        arena = self.take_arena(n_words)
        try:
            if arena.q is not None and len(q_idx) == arena.q.numel():
                # the seed graph reads the lanes from the arena
                q = arena.q
                q.copy_(torch.as_tensor(q_idx))
            else:
                q = _to_device(q_idx, self.device)
            self._load_tail(arena, n_words, gathers)
            x, trace = self.evaluate(q, n_words, idx_main, idx_aux, arena,
                                     idx_cav, plan)
            if gathers is not None:
                out = self._answers(arena)
            else:
                with kernels.unstamped():
                    out = finish(x)
        except BaseException:
            # a failed call returns no arena, and drops the bucket's pooled
            # one too: after a device fault its buffers are suspect
            self.discard_arena(n_words)
            raise
        self.put_arena(n_words, arena)
        return out, trace

    # -- pipelined entry points ----------------------------------------------

    def checks_device(self, q_idx, n_words: int, gather_idx, gather_col,
                      idx_main, idx_aux, idx_cav=None,
                      plan: Optional[list] = None) -> tuple:
        """Tri-state-encoded checks per gather slot ({0, 2}; {0, 1, 2}
        with planes): returns (int32 [G] host tensor, trace).  The gather
        rides every sweep's tail (`sweep_delta_checks`) and comes back
        with the sweep's delta pair: the last sweep's answers are the
        fixpoint's, and nothing is launched or copied after it."""
        gathers = tuple(np.ascontiguousarray(a, np.int32)
                        for a in (gather_idx, gather_col))
        if len(gathers[0]) != len(gathers[1]):
            raise ValueError("gather rows and columns differ in length")
        return self._run(n_words, q_idx, idx_main, idx_aux, idx_cav, None,
                         plan, gathers=gathers)

    def lookup_packed_T_device(self, slot_offset: int, slot_length: int,
                               q_idx, n_words: int, idx_main,
                               idx_aux, idx_cav=None,
                               plan: Optional[list] = None) -> tuple:
        """Packed lookup words, word-transposed on device: returns
        (int32 [n_words, slot_length] device tensor, trace); bit b of word
        row w is query column 32*w + b (the DEFINITE plane with planes)."""
        return self._run(n_words, q_idx, idx_main, idx_aux, idx_cav,
                         lambda x: kernels.lookup_T(x, slot_offset,
                                                    slot_length, n_words),
                         plan)

    def iterations(self, q_idx, n_words: int, idx_main, idx_aux,
                   idx_cav=None) -> int:
        """Executed sweeps to the fixpoint for this batch — the trace's
        trip count (the reference's roofline probe, ell.py:998-1040)."""
        _, trace = self._run(n_words, q_idx, idx_main, idx_aux, idx_cav,
                             lambda x: None)
        return int(trace[0])

    # -- serial host-facing entry points (blocking) ---------------------------

    def checks(self, q_idx, n_words: int, gather_idx, gather_col, idx_main,
               idx_aux, idx_cav=None) -> np.ndarray:
        """bool allowed per gather slot — or int8 {0, 1, 2} tri-state when
        the plane path is active."""
        out, _ = self.checks_device(q_idx, n_words, gather_idx, gather_col,
                                    idx_main, idx_aux, idx_cav)
        out = out.cpu().numpy()
        if self.planes:
            return out.astype(np.int8)
        return out != 0

    def lookup_packed(self, slot_offset: int, slot_length: int, q_idx,
                      n_words: int, idx_main, idx_aux,
                      idx_cav=None) -> np.ndarray:
        """Packed uint32 [slot_length, n_words] allowed words (bit b of
        word w is query column w*32+b; DEFINITE plane with planes)."""
        words, _ = self.lookup_packed_T_device(slot_offset, slot_length,
                                               q_idx, n_words, idx_main,
                                               idx_aux, idx_cav)
        return np.ascontiguousarray(words.cpu().numpy().view(np.uint32).T)

    def lookup(self, slot_offset: int, slot_length: int, q_idx,
               n_words: int, idx_main, idx_aux, idx_cav=None) -> np.ndarray:
        """bool [slot_length, n_words*32] allowed bitmap (columns beyond
        the real batch are padding; DEFINITE plane with planes)."""
        packed = self.lookup_packed(slot_offset, slot_length, q_idx, n_words,
                                    idx_main, idx_aux, idx_cav)
        # uint32 little-endian: bit b of word w lands at column w*32 + b
        return np.unpackbits(packed.view(np.uint8).reshape(slot_length, -1),
                             axis=1, bitorder="little").astype(bool)


def _to_device(a, device: torch.device) -> torch.Tensor:
    """int32 host array (or tensor) -> contiguous int32 tensor on device."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
