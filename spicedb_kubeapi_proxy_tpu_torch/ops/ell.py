"""Bit-packed ELL (fixed-fanin gather) reachability sweep on torch.

The torch counterpart of the reference's ops/ell.py, definite plane and
staged step only.  Two halves:

- host (numpy, copied from the reference so both packages build the very
  same tables): `batch_words`, `build_tables`, `compute_stages`,
  `annotate_stage_refresh`, plus `compile_perm_program`, which flattens a
  permission expression into the postfix code the perm_program kernel
  runs;
- device: `EllKernelCache`, whose pipelined entries `checks_device` and
  `lookup_packed_T_device` seed the bitplanes, run the staged
  Gauss-Seidel sweep to its fixpoint and gather the answers — every step
  a hand-written CUDA kernel (ops/kernels) on a CUDA device, or the
  kernels' plain-torch twins on the CPU.

Layout: x is int32 [NT, W] (W = batch lanes / 32); rows [0, state_size)
are the GraphProgram's state, rows [state_size, NT) the aux OR-tree nodes
of hub destinations.  The program's dead index is the last state row;
padding slots in both tables point at it and it stays zero.

The fixpoint loop runs on the host: after each sweep it reads back the
sweep_delta pair (changed bits, any change) — one device sync per sweep.
Moving the convergence test onto the device is later work (ROADMAP).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import kernels
from .graph_compile import (
    GraphProgram,
    PExclude,
    PIntersect,
    PRead,
    PUnion,
    PZero,
)
from .kernels.reference import OP_AND, OP_ANDNOT, OP_OR, OP_READ, OP_ZERO

# Main-table fanin: rows with more in-edges are tree-split (production
# graphs are fanin-skewed: most rows have fanin 0 or 1).  The reference
# reads an environment override; the port keeps the default fixed.
K_MAIN = 2
# Aux-node fanin: wider is better for hubs (fewer tree levels).
K_AUX = 32

MAX_ITERATIONS = 50  # matches embedded reference dispatch depth cap


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
    rows).  Mirrors the reference's _apply_perm_expr_packed (definite
    plane): union = OR, intersection = AND, exclusion = AND-NOT."""
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


@dataclass
class _Arena:
    """One bucket's state buffers, [NT, W] int32 each: the seed x0 and
    the two sweep states the fixpoint loop swaps between."""
    x0: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor


class EllKernelCache:
    """Packed check/lookup entry points for one (program, tables) pair on
    one device — the definite-plane pipelined path of the reference's
    EllKernelCache (ops/ell.py:676-996), with the KernelIntrospect sweep
    trace always on: every call returns an int32 [1 + num_iters] trace,
    entry 0 the executed sweep count and entry 1 + i popcount(x1 ^ x) of
    sweep i."""

    def __init__(self, prog: GraphProgram, n_aux_rows: int, tree_depth: int,
                 device: torch.device, num_iters: Optional[int] = None,
                 shared_tree_depth: Optional[int] = None,
                 host_main: Optional[np.ndarray] = None,
                 stages: Optional[tuple] = None):
        self.prog = prog
        self.n_aux_rows = n_aux_rows
        self.device = torch.device(device)
        # in-sweep bottom-up aux refresh passes: the shared table's tree
        # height, +1 spare pass (as the reference sizes it)
        std = shared_tree_depth if shared_tree_depth is not None else tree_depth
        self.aux_passes = std + 1
        base = num_iters or MAX_ITERATIONS
        self.num_iters = base * (1 + tree_depth)
        if stages is None:
            stages = compute_stages(prog)
            if stages and host_main is not None:
                stages = annotate_stage_refresh(stages, host_main,
                                                prog.state_size)
        if not stages and prog.state_size > 1:
            raise NotImplementedError(
                "a program without type stages needs the Jacobi step, which "
                "the torch port does not have yet")
        self.stages = stages
        self._plan = self._build_plan()
        self._arenas: dict = {}
        self._arena_lock = threading.Lock()

    # -- build-time plan -----------------------------------------------------

    def _build_plan(self) -> list:
        """Per stage: (repeat, wants_aux, [(lo, hi, wc_bits)], [(code, offset,
        length, in_place)]), with every table the kernels read uploaded
        once.  Perm ops and wildcard terms are grouped by the stage whose
        ranges contain them (a type's slots are contiguous, so containment
        is exact), as the reference groups them."""
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

        plan = []
        for ranges, repeat, wants_aux in self.stages or ():
            rows = []
            for lo, hi in ranges:
                # bit i of a row's mask word: wildcard term i grants it
                bits = np.zeros(hi - lo, np.uint32)
                for i, m in enumerate(masks):
                    m = m[(m >= lo) & (m < hi)]
                    bits[m - lo] |= np.uint32(1) << np.uint32(i)
                wc = (torch.from_numpy(bits.view(np.int32)).to(dev)
                      if bits.any() else None)
                rows.append((lo, hi, wc))
            ops = []
            for op in prog.perm_ops:
                if not in_stage(ranges, op.offset):
                    continue
                code, depth, self_read = compile_perm_program(
                    op.expr, op.offset, op.length)
                if depth > kernels.MAX_STACK:
                    raise NotImplementedError(
                        f"permission expression needs a stack of {depth} "
                        f"(> {kernels.MAX_STACK})")
                ops.append((torch.from_numpy(code).to(dev), op.offset,
                            op.length, not self_read))
            plan.append((repeat, wants_aux, rows, ops))
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
                p_repeat, _, rows, ops = plan[i]
                plan[i] = (p_repeat, True, rows, ops)
                self._plan = plan
                return True
        return False

    # -- state arenas --------------------------------------------------------

    def take_arena(self, n_words: int) -> _Arena:
        """Pop the bucket's state arena (exclusive: two in-flight calls
        never share one); allocated on first use."""
        with self._arena_lock:
            a = self._arenas.pop(n_words, None)
        if a is not None:
            return a
        nt = self.prog.state_size + self.n_aux_rows
        return _Arena(*(torch.empty((nt, n_words), dtype=torch.int32,
                                    device=self.device) for _ in range(3)))

    def put_arena(self, n_words: int, arena: _Arena) -> None:
        """Return an arena to the pool; if a concurrent call repooled
        first, this one is dropped."""
        with self._arena_lock:
            self._arenas.setdefault(n_words, arena)

    def discard_arena(self, n_words: int) -> None:
        """Drop a bucket's pooled arena (after a failed call)."""
        with self._arena_lock:
            self._arenas.pop(n_words, None)

    # -- the sweep -----------------------------------------------------------

    def sweep_steps(self, idx_main, idx_aux, plan: Optional[list] = None):
        """The kernel calls of one staged Gauss-Seidel sweep (reference
        staged_step, ell.py:444-500), in order: ("ell_gather_or", idx,
        dst_lo, seeded, wc_bits) and ("perm_program", code, offset,
        length, in_place).  Each stage pass first refreshes the aux
        OR-trees (`aux_passes` Jacobi passes) when its rows read aux
        roots, then gathers its row ranges, then runs its permission ops;
        a final refresh leaves the aux rows consistent with the state, so
        a fixpoint compares unchanged.  `plan` defaults to the current
        one."""
        n = self.prog.state_size
        refresh = [("ell_gather_or", idx_aux, n, False, None)] \
            * (self.aux_passes if self.n_aux_rows else 0)
        for repeat, wants_aux, rows, ops in (plan if plan is not None
                                             else self._plan):
            for _ in range(repeat):
                if wants_aux:
                    yield from refresh
                for lo, hi, wc in rows:
                    yield ("ell_gather_or", idx_main[lo:hi], lo, True, wc)
                for code, off, length, in_place in ops:
                    yield ("perm_program", code, off, length, in_place)
        yield from refresh

    @staticmethod
    def run_step(step, cur, x0, live, impl=kernels) -> None:
        """Run one sweep step on `cur` with `impl` — the kernel wrappers,
        or their twins (kernels.reference) to hold a kernel against its
        plain version on the same inputs."""
        if step[0] == "ell_gather_or":
            _, idx, dst_lo, seeded, wc = step
            impl.ell_gather_or(cur, idx, dst_lo, x0=x0 if seeded else None,
                               wc_bits=wc,
                               wc_live=live if wc is not None else None)
        else:
            _, code, off, length, in_place = step
            impl.perm_program(cur, x0, code, off, length, in_place=in_place)

    def _sweep(self, cur, x0, idx_main, idx_aux, live, plan) -> None:
        """One sweep: `cur` enters as a copy of the previous state and
        leaves as the next one, dead row not yet zeroed (sweep_delta does
        that).  `live` is the wildcard liveness: the reference ORs the
        self rows of the sweep's input state, which always equal the
        seed's (no edge targets a self slot), so the seed kernel computed
        it once."""
        for step in self.sweep_steps(idx_main, idx_aux, plan):
            self.run_step(step, cur, x0, live)

    def evaluate(self, q_idx: torch.Tensor, n_words: int, idx_main,
                 idx_aux, arena: _Arena) -> tuple:
        """Seed, then sweep to the fixpoint (or the iteration cap).
        Returns (final state — one of the arena's buffers, trace).  The
        whole batch sweeps with the plan current at its start."""
        plan = self._plan
        prog = self.prog
        nt = prog.state_size + self.n_aux_rows
        dead = prog.dead_index
        live = None
        if self._wc_ranges is not None:
            live = torch.empty((self._wc_ranges.shape[0], n_words),
                               dtype=torch.int32, device=self.device)
        x0 = kernels.seed_bitplanes(q_idx, nt, n_words, dead, out=arena.x0,
                                    wc_ranges=self._wc_ranges, live=live)
        x, cur = arena.a, arena.b
        x.copy_(x0)
        trace = np.zeros(1 + self.num_iters, np.int32)
        i = 0
        changed = True
        while changed and i < self.num_iters:
            cur.copy_(x)
            self._sweep(cur, x0, idx_main, idx_aux, live, plan)
            delta, any_change = kernels.sweep_delta(cur, x, dead).tolist()
            trace[1 + i] = delta
            changed = bool(any_change)
            i += 1
            x, cur = cur, x
        trace[0] = i
        return x, trace

    def _run(self, n_words: int, q_idx, idx_main, idx_aux, finish) -> tuple:
        arena = self.take_arena(n_words)
        try:
            q = _to_device(q_idx, self.device)
            x, trace = self.evaluate(q, n_words, idx_main, idx_aux, arena)
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
                      idx_main, idx_aux) -> tuple:
        """Tri-state-encoded checks ({0, 2}) per gather slot: returns
        (int32 [G] device tensor, trace)."""
        gi = _to_device(gather_idx, self.device)
        gc = _to_device(gather_col, self.device)
        return self._run(n_words, q_idx, idx_main, idx_aux,
                         lambda x: kernels.check_gather(x, gi, gc))

    def lookup_packed_T_device(self, slot_offset: int, slot_length: int,
                               q_idx, n_words: int, idx_main,
                               idx_aux) -> tuple:
        """Packed lookup words, word-transposed on device: returns
        (int32 [n_words, slot_length] device tensor, trace); bit b of word
        row w is query column 32*w + b."""
        return self._run(n_words, q_idx, idx_main, idx_aux,
                         lambda x: kernels.lookup_T(x, slot_offset,
                                                    slot_length))


def _to_device(a, device: torch.device) -> torch.Tensor:
    """int32 host array (or tensor) -> contiguous int32 tensor on device."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
