"""Leopard-style materialized group index (Zanzibar §2.4.1 "Leopard").

The torch counterpart of the reference's ops/leopard.py.  The iterative
sweep pays one fixpoint iteration per nesting level, so a depth-8 group
chain costs 8 sweeps per check.  This module answers such checks with one
probe of a precomputed closure plane:

- **planning** — `plan_schema` walks permission expressions with the same
  footprint discipline as the compiler and proves which (type,
  permission) pairs are *group-membership-only* fragments: pure
  union/arrow/userset chains with no intersection, exclusion, wildcard or
  relation trait anywhere in the fragment.  Only such fragments are safe
  to flatten (boolean reachability == permission).
- **materialization** — `LeopardIndex.build` computes the transitive
  closure of each eligible fragment as a dense subject×slot bitset on the
  host (monotone OR fixpoint over the fragment-restricted edge set and
  the union perm-ops), then uploads the permission-slot rows to the
  device as an int32 plane `plane[object_local, subject_col_word]`, sized
  under a byte budget (`SPICEDB_TPU_LEOPARD_BUDGET_BYTES`).
- **incremental maintenance** — the endpoint's delta path feeds
  `apply_insert`/`apply_remove` with exactly the edges it applied to the
  device graph.  Inserts propagate with a bounded frontier pass
  (`SPICEDB_TPU_LEOPARD_FRONTIER` full OR passes); deletes that cannot be
  proven closure-neutral *quarantine* the fragment (queries fall back to
  the sweep, which the delta path kept correct) until a background
  re-close rebuilds the closure from the maintained edge set.  Caveated
  tuples landing on a fragment relation retire the fragment for the
  generation — a closure bit cannot represent CONDITIONAL.
- **query integration** — ops/torch_endpoint.py consults
  `check_fragment`/`lookup_frag` before the sweep and falls back to it for
  anything the index cannot answer.

The host half (planner, `_close`, the maintenance) is the reference's,
line for line, so both packages build and maintain the very same closure.
What differs is the device plane: `_upload_plane` builds a NEW int32
tensor from the closure rows every time (a copy, as the reference's
`jnp.asarray`), never writing a plane in place, so a batch holding an
older `view` keeps reading the plane it captured.  The plane is a tuple
of row blocks: one, or with a mesh one per graph shard (rows padded to a
multiple of the `graph` axis, as the reference shards them);
`plane_check` and `plane_word_cols` route each read to its block.  The reference's metrics
gauges and HBM-ledger registration have no counterpart here yet
(ROADMAP).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..spicedb import schema as sch
from . import kernels
from .ell import _to_device
from .graph_compile import GraphProgram, PRead, PUnion, PZero, SELF_SLOT

BUDGET_ENV = "SPICEDB_TPU_LEOPARD_BUDGET_BYTES"
DEFAULT_BUDGET_BYTES = 64 << 20
FRONTIER_ENV = "SPICEDB_TPU_LEOPARD_FRONTIER"
DEFAULT_FRONTIER_PASSES = 16


def budget_bytes() -> int:
    try:
        return int(os.environ.get(BUDGET_ENV, DEFAULT_BUDGET_BYTES))
    except ValueError:
        return DEFAULT_BUDGET_BYTES


def frontier_passes() -> int:
    try:
        return int(os.environ.get(FRONTIER_ENV, DEFAULT_FRONTIER_PASSES))
    except ValueError:
        return DEFAULT_FRONTIER_PASSES


# -- static planning ---------------------------------------------------------

@dataclass(frozen=True)
class PlanEntry:
    """Static eligibility verdict for one (type, permission) pair."""
    eligible: bool
    reason: str = ""                 # ineligibility reason when not eligible
    slots: tuple = ()                # fragment (type, slot) closure
    subject_types: tuple = ()        # direct-subject types (closure columns)


def _plan_pair(schema: sch.Schema, rtype: str, perm: str) -> PlanEntry:
    """Prove (or refute) that the evaluation of (rtype, perm) is a pure
    group-membership fragment: every slot its value can depend on is a
    union/arrow/userset chain over trait-free, wildcard-free relations.
    The slot walk mirrors the compiled program's dependency structure:
    permission slots read relation slots and `__arrow__` aux slots;
    relation slots are fed by direct-subject SELF slots and userset
    subject slots; aux slots are fed by the arrow target slot at each
    direct subject type of the arrow's left relation."""
    d = schema.definitions.get(rtype)
    if d is None or perm not in d.permissions:
        return PlanEntry(False, "not-a-permission")
    slots: set = set()
    subject_types: set = set()

    def visit_slot(t: str, name: str) -> Optional[str]:
        if (t, name) in slots:
            return None
        slots.add((t, name))
        td = schema.definitions.get(t)
        if td is None:
            return f"unknown-type:{t}"
        if name == SELF_SLOT:
            return None
        if name in td.relations:
            for tr in td.relations[name]:
                if tr.wildcard:
                    return "wildcard"
                if tr.traits:
                    return f"trait:{tr.traits[0]}"
                if tr.relation:
                    bad = visit_slot(tr.type, tr.relation)
                    if bad:
                        return bad
                else:
                    subject_types.add(tr.type)
                    bad = visit_slot(tr.type, SELF_SLOT)
                    if bad:
                        return bad
            return None
        if name in td.permissions:
            return visit_expr(t, td, td.permissions[name], name)
        return f"unresolved:{t}#{name}"

    def visit_expr(t: str, td: sch.Definition, e: sch.Expr,
                   perm_name: str) -> Optional[str]:
        if isinstance(e, sch.Nil):
            return None
        if isinstance(e, sch.RelRef):
            return visit_slot(t, e.name)
        if isinstance(e, sch.Union):
            for c in e.children:
                bad = visit_expr(t, td, c, perm_name)
                if bad:
                    return bad
            return None
        if isinstance(e, sch.Arrow):
            if e.left not in td.relations:
                return f"arrow-left:{e.left}"
            for tr in td.relations[e.left]:
                if tr.wildcard:
                    return "wildcard"
                if tr.traits:
                    return f"trait:{tr.traits[0]}"
                if tr.relation:
                    # userset subjects never feed arrow edges; the left
                    # relation itself is still part of the fragment
                    bad = visit_slot(tr.type, tr.relation)
                else:
                    bad = visit_slot(tr.type, e.target)
                if bad:
                    return bad
            # the left relation's slot is fed by its own tuple edges
            return visit_slot(t, e.left)
        if isinstance(e, sch.Intersection):
            return "intersection"
        if isinstance(e, sch.Exclusion):
            return "exclusion"
        return f"expr:{type(e).__name__}"

    bad = visit_slot(rtype, perm)
    if bad:
        return PlanEntry(False, bad)
    if not subject_types:
        return PlanEntry(False, "no-direct-subjects")
    return PlanEntry(True, "", tuple(sorted(slots)),
                     tuple(sorted(subject_types)))


def plan_schema(schema: sch.Schema) -> Dict[Tuple[str, str], PlanEntry]:
    """Static Leopard plan for every (type, permission) pair."""
    out: Dict[Tuple[str, str], PlanEntry] = {}
    for t, d in schema.definitions.items():
        for p in d.permissions:
            out[(t, p)] = _plan_pair(schema, t, p)
    return out


def fragment_is_nested(schema: sch.Schema, rtype: str, perm: str) -> bool:
    """True when an eligible fragment actually nests — a userset subject
    or an arrow anywhere in its closure.  A flat single-level union is
    still *eligible*, but flattening it saves nothing."""
    entry = _plan_pair(schema, rtype, perm)
    if not entry.eligible:
        return False

    def has_arrow(e) -> bool:
        if isinstance(e, sch.Arrow):
            return True
        if isinstance(e, sch.Union):
            return any(has_arrow(c) for c in e.children)
        return False

    for (t, name) in entry.slots:
        d = schema.definitions.get(t)
        if d is None:
            continue
        if any(tr.relation for tr in d.relations.get(name, ())):
            return True
        e = d.permissions.get(name)
        if e is not None and has_arrow(e):
            return True
    return False


def estimate_fragment_bytes(schema: sch.Schema, rtype: str, perm: str,
                            counts) -> Optional[int]:
    """Closure byte estimate for an eligible pair: rows (every object of
    every fragment slot) × subject-column words × 4.  `counts` is either
    a {type: object_count} map or a flat per-type count; returns None
    for ineligible pairs."""
    entry = _plan_pair(schema, rtype, perm)
    if not entry.eligible:
        return None

    def n_of(t: str) -> int:
        if isinstance(counts, dict):
            return int(counts.get(t, 0))
        return int(counts)

    rows = sum(n_of(t) for (t, _slot) in entry.slots)
    cols = sum(n_of(t) for t in entry.subject_types)
    words = (max(cols, 1) + 31) // 32
    return rows * words * 4


# -- fragment ----------------------------------------------------------------

def _flatten_reads(expr) -> List[Tuple[int, int]]:
    """Flatten a compiled permission expression into its PRead ranges.
    Raises ValueError on any operator a pure-union fragment cannot
    contain (the static plan makes this unreachable; the raise is the
    tripwire if plan and compiler ever disagree)."""
    if isinstance(expr, PRead):
        return [(expr.offset, expr.length)]
    if isinstance(expr, PZero):
        return []
    if isinstance(expr, PUnion):
        out: List[Tuple[int, int]] = []
        for c in expr.children:
            out.extend(_flatten_reads(c))
        return out
    raise ValueError(f"non-union op in fragment: {type(expr).__name__}")


@dataclass
class _Fragment:
    pair: Tuple[str, str]
    slots: tuple
    subject_types: tuple
    local_of: np.ndarray          # int32 [state_size] -> local row | -1
    col_of: np.ndarray            # int32 [state_size] -> subject col | -1
    n_rows: int
    n_cols: int
    words: int
    state: np.ndarray             # uint32 [n_rows, words] host closure
    seeds: np.ndarray             # uint32 [n_rows, words] identity bits
    base_src: np.ndarray          # int32 [E] fragment-local compile edges
    base_dst: np.ndarray
    base_alive: np.ndarray        # bool [E]
    perm_ops_local: tuple         # ((dst_lo, length, (src_lo, ...)), ...)
    perm_lo: int                  # local row of the permission slot range
    plane_rows: int               # num_objects[rtype]
    key_edges: dict = field(default_factory=dict)   # key -> [(s_l, d_l)]
    # device int32 row blocks of [plane_rows, words]: one, or one per
    # graph shard under a mesh
    plane: Optional[tuple] = None
    view: tuple = ()              # (plane, plane_rows) consult snapshot
    live: bool = False
    quarantined: bool = False
    retired: bool = False
    reason: str = ""
    seq: int = 0

    @property
    def nbytes_host(self) -> int:
        return int(self.state.nbytes) * 2  # state + seeds

    def edge_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Current fragment edge set: live compile-time edges plus every
        applied-key edge."""
        srcs = [self.base_src[self.base_alive]]
        dsts = [self.base_dst[self.base_alive]]
        extra = [e for edges in self.key_edges.values() for e in edges]
        if extra:
            arr = np.asarray(extra, np.int32).reshape(-1, 2)
            srcs.append(arr[:, 0])
            dsts.append(arr[:, 1])
        return (np.concatenate(srcs), np.concatenate(dsts))


def _close(state: np.ndarray, src: np.ndarray, dst: np.ndarray,
           perm_ops_local: tuple, max_passes: int) -> bool:
    """Monotone OR fixpoint to convergence (bounded by `max_passes`):
    per pass, one edge sweep (`y[dst] |= x[src]`, unbuffered so duplicate
    destinations accumulate) then the union perm-ops in topo order.  The
    uint64 word-sum is monotone non-decreasing under OR, so an unchanged
    sum is exact convergence.  Returns True when converged."""
    before = int(state.sum(dtype=np.uint64))
    for _ in range(max_passes):
        if len(src):
            np.bitwise_or.at(state, dst, state[src])
        for (dlo, dlen, srcs) in perm_ops_local:
            for slo in srcs:
                state[dlo:dlo + dlen] |= state[slo:slo + dlen]
        after = int(state.sum(dtype=np.uint64))
        if after == before:
            return True
        before = after
    return False


# -- the index ---------------------------------------------------------------

def plane_check(view: tuple, rows: np.ndarray,
                cols: np.ndarray) -> torch.Tensor:
    """`check_gather` over a consult view's plane blocks: int32 {0, 2} per
    (plane row, closure column) pair, in request order.  Each row is
    routed to its block, one launch per block the rows touch, and the
    results are reassembled on the first block's device."""
    blocks, _ = view
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    b = blocks[0].shape[0]
    dev0 = blocks[0].device
    g_of = rows // b
    parts, order = [], []
    for g in np.unique(g_of).tolist():
        sel = np.nonzero(g_of == g)[0]
        blk = blocks[g]
        parts.append(kernels.check_gather(
            blk, _to_device(rows[sel] - g * b, blk.device),
            _to_device(cols[sel], blk.device)).to(dev0))
        order.append(sel)
    if len(parts) == 1:
        return parts[0]
    out = torch.empty(len(rows), dtype=torch.int32, device=dev0)
    if parts:
        out[torch.from_numpy(np.concatenate(order)).to(dev0)] = \
            torch.cat(parts)
    return out


def plane_word_cols(view: tuple, words: np.ndarray) -> torch.Tensor:
    """`word_cols_T` over a consult view's plane blocks: int32 [K, plane
    rows], the closure word columns `words` made contiguous, each block's
    real rows joined in row order on the first block's device."""
    blocks, n_rows = view
    words = np.asarray(words, np.int32)
    b = blocks[0].shape[0]
    dev0 = blocks[0].device
    parts = []
    for g, blk in enumerate(blocks):
        n = min(b, n_rows - g * b)
        if n <= 0:
            break
        parts.append(kernels.word_cols_T(
            blk, n, _to_device(words, blk.device)).to(dev0))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


class LeopardIndex:
    """Per-generation materialized closure over the eligible fragments of
    one compiled graph.  Thread discipline: every mutation happens under
    `self._lock` (a leaf lock — never acquire endpoint locks while
    holding it); the query path is lock-free against immutable `view`
    snapshots captured under the endpoint lock."""

    def __init__(self, prog: GraphProgram, device=None, mesh=None):
        self.prog = prog
        self.device = torch.device("cpu" if device is None else device)
        self.mesh = mesh
        self._lock = threading.Lock()
        self._frags: List[_Fragment] = []
        self._by_pair: Dict[Tuple[str, str], _Fragment] = {}
        self.statuses: Dict[str, str] = {}
        # accounting (host seconds and counts): plane uploads (build,
        # inserts, re-closes), quarantines, installed re-closes
        self.upload_s = 0.0
        self.uploads = 0
        self.quarantines = 0
        self.reclose_s = 0.0
        self.recloses = 0

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, schema: sch.Schema, prog: GraphProgram,
              caveat_affected=frozenset(), candidate_order: tuple = (),
              device=None, mesh=None) -> "LeopardIndex":
        """Materialize every statically eligible fragment that fits the
        byte budget, candidates first, then the rest in deterministic
        pair order.  With a `mesh` the planes are row-sharded over its
        `graph` axis."""
        idx = cls(prog, device, mesh)
        plan = plan_schema(schema)
        order = [p for p in candidate_order if p in plan]
        order += sorted(p for p in plan if p not in set(order))
        budget = budget_bytes()
        spent = 0
        for pair in order:
            entry = plan[pair]
            key = f"{pair[0]}#{pair[1]}"
            if not entry.eligible:
                idx.statuses[key] = f"ineligible({entry.reason})"
                continue
            if pair in caveat_affected:
                idx.statuses[key] = "ineligible(caveat)"
                continue
            if not fragment_is_nested(schema, pair[0], pair[1]):
                # a flat single-level union resolves in one sweep anyway
                idx.statuses[key] = "ineligible(flat)"
                continue
            est = estimate_fragment_bytes(schema, pair[0], pair[1],
                                          prog.num_objects)
            if est is None or spent + est > budget:
                idx.statuses[key] = "ineligible(over-budget)"
                continue
            frag = idx._materialize(pair, entry)
            if frag is None:
                continue
            spent += frag.nbytes_host // 2
            idx._frags.append(frag)
            idx._by_pair[pair] = frag
            idx.statuses[key] = "indexed"
        return idx

    def _materialize(self, pair: Tuple[str, str],
                     entry: PlanEntry) -> Optional[_Fragment]:
        prog = self.prog
        key = f"{pair[0]}#{pair[1]}"
        local_of = np.full(prog.state_size, -1, np.int32)
        col_of = np.full(prog.state_size, -1, np.int32)
        # the compiled program adds one `__arrow__:{perm}:{k}` aux slot
        # per arrow occurrence; they belong to their permission's fragment
        slots = set(entry.slots)
        for (t, name) in entry.slots:
            prefix = f"__arrow__:{name}:"
            for (t2, s2) in prog.slot_offsets:
                if t2 == t and s2.startswith(prefix):
                    slots.add((t2, s2))
        row = 0
        slot_lo: Dict[Tuple[str, str], int] = {}
        for (t, slot) in sorted(slots):
            rng = prog.slot_range(t, slot)
            if rng is None:
                self.statuses[key] = "ineligible(unslotted)"
                return None
            off, n = rng
            slot_lo[(t, slot)] = row
            local_of[off:off + n] = np.arange(row, row + n, dtype=np.int32)
            row += n
        n_rows = row
        col = 0
        for t in entry.subject_types:
            off, n = prog.slot_range(t, SELF_SLOT)
            col_of[off:off + n] = np.arange(col, col + n, dtype=np.int32)
            col += n
        n_cols = col
        words = (max(n_cols, 1) + 31) // 32
        # runtime ineligibility the static plan cannot see: caveated
        # MAYBE-plane edges or wildcard masks landing inside the fragment
        if len(prog.cav_dst) and np.any(local_of[prog.cav_dst] >= 0):
            self.statuses[key] = "ineligible(caveat)"
            return None
        for term in prog.wildcard_terms:
            if np.any(local_of[np.asarray(term.mask_indices,
                                          np.int64)] >= 0):
                self.statuses[key] = "ineligible(wildcard)"
                return None
        # an in-fragment dst fed by an out-of-fragment src means the plan
        # missed a dependency: refuse rather than under-approximate
        in_dst = local_of[prog.edge_dst] >= 0
        if np.any(in_dst & (local_of[prog.edge_src] < 0)):
            self.statuses[key] = "ineligible(edge-escape)"
            return None
        base_src = local_of[prog.edge_src[in_dst]]
        base_dst = local_of[prog.edge_dst[in_dst]]
        perm_ops_local = []
        try:
            for op in prog.perm_ops:
                lo = local_of[op.offset]
                if lo < 0:
                    continue
                srcs = tuple(int(local_of[o]) for (o, _l)
                             in _flatten_reads(op.expr))
                if any(s < 0 for s in srcs):
                    self.statuses[key] = "ineligible(edge-escape)"
                    return None
                perm_ops_local.append((int(lo), int(op.length), srcs))
        except ValueError:
            self.statuses[key] = "ineligible(non-union-op)"
            return None
        seeds = np.zeros((n_rows, words), np.uint32)
        cols_present = np.nonzero(col_of >= 0)[0]
        lrows = local_of[cols_present]
        lcols = col_of[cols_present]
        seeds[lrows, lcols // 32] |= np.uint32(1) << (lcols % 32).astype(
            np.uint32)
        perm_lo = slot_lo[pair]
        frag = _Fragment(
            pair=pair, slots=tuple(sorted(slots)),
            subject_types=entry.subject_types,
            local_of=local_of, col_of=col_of, n_rows=n_rows, n_cols=n_cols,
            words=words, state=seeds.copy(), seeds=seeds,
            base_src=base_src.astype(np.int32),
            base_dst=base_dst.astype(np.int32),
            base_alive=np.ones(len(base_src), bool),
            perm_ops_local=tuple(perm_ops_local), perm_lo=perm_lo,
            plane_rows=prog.num_objects[pair[0]])
        if not _close(frag.state, frag.base_src, frag.base_dst,
                      frag.perm_ops_local, max_passes=n_rows + 2):
            self.statuses[key] = "ineligible(no-converge)"
            return None
        self._upload_plane(frag)
        frag.live = True
        return frag

    def _upload_plane(self, frag: _Fragment) -> None:
        """Upload the permission-slot closure rows as a NEW device plane
        (int32, the bit pattern of the uint32 closure words) and publish
        it as the consult view.  The old plane is never written: a batch
        that captured it keeps it alive and reads it unchanged."""
        t0 = time.perf_counter()
        rows = frag.state[frag.perm_lo:frag.perm_lo + frag.plane_rows]
        host = np.ascontiguousarray(rows).view(np.int32)
        # one block of rows per graph shard (rows padded to a multiple of
        # the axis) on data replica 0's devices; one block without a mesh
        devices = (self.mesh.devices[0] if self.mesh is not None
                   else (self.device,))
        pad = (-frag.plane_rows) % len(devices)
        if pad:
            host = np.vstack([host, np.zeros((pad, frag.words), np.int32)])
        b = host.shape[0] // len(devices)
        # copy=True: on the CPU `.to()` would alias the host closure
        plane = tuple(
            torch.from_numpy(host[g * b:(g + 1) * b]).to(dev, copy=True)
            for g, dev in enumerate(devices))
        frag.plane = plane
        frag.view = (plane, frag.plane_rows)
        self.upload_s += time.perf_counter() - t0
        self.uploads += 1

    # -- introspection -------------------------------------------------------

    def status_map(self) -> Dict[str, str]:
        """Per-pair status: indexed, indexed(quarantined) or
        ineligible(reason)."""
        out = dict(self.statuses)
        for f in self._frags:
            key = f"{f.pair[0]}#{f.pair[1]}"
            if f.retired:
                out[key] = f"ineligible({f.reason or 'retired'})"
            elif f.quarantined:
                out[key] = "indexed(quarantined)"
            else:
                out[key] = "indexed"
        return out

    # -- query path ----------------------------------------------------------

    def check_fragment(self, rtype: str, perm: str) -> Optional[tuple]:
        """(fragment, slot offset of the permission) when a live fragment
        can answer checks of (rtype, perm); None routes them to the
        sweep.  The reference's `check_coords` per row: a check of subject
        state index s against permission state index p reads plane row
        p - offset, column `col_of[s]` (none when negative)."""
        frag = self._by_pair.get((rtype, perm))
        if frag is None or not frag.live:
            return None
        return frag, self.prog.slot_offsets[(rtype, perm)]

    def lookup_frag(self, rtype: str, perm: str) -> Optional[_Fragment]:
        frag = self._by_pair.get((rtype, perm))
        if frag is None or not frag.live:
            return None
        return frag

    # -- incremental maintenance --------------------------------------------

    def apply_insert(self, key, endpoints) -> None:
        """A definite tuple the device graph just absorbed: propagate the
        fragment-restricted edges with a bounded frontier pass.  An
        overflowing frontier quarantines (the closure is then a possible
        under-approximation and must not serve)."""
        if endpoints is None:
            return
        ends = np.asarray(endpoints, np.int64).reshape(-1, 2)
        with self._lock:
            for frag in self._frags:
                if frag.retired:
                    continue
                d_l = frag.local_of[ends[:, 1]]
                hit = d_l >= 0
                if not np.any(hit):
                    continue
                s_l = frag.local_of[ends[hit, 0]]
                if np.any(s_l < 0):
                    self._retire_locked(frag, "edge-escape")
                    continue
                if key in frag.key_edges:
                    continue  # idempotent replay
                edges = list(zip(s_l.tolist(), d_l[hit].tolist()))
                for s, d in edges:
                    # a TOUCH of a tuple this generation compiled in would
                    # otherwise record the edge twice (keyed and base);
                    # the key takes ownership of the base copy
                    cand = np.nonzero(frag.base_alive
                                      & (frag.base_src == s)
                                      & (frag.base_dst == d))[0]
                    if len(cand):
                        frag.base_alive[cand[0]] = False
                frag.key_edges[key] = edges
                frag.seq += 1
                if frag.quarantined:
                    continue  # the re-close will see the recorded edges
                src = np.asarray([e[0] for e in edges], np.int64)
                dst = np.asarray([e[1] for e in edges], np.int64)
                np.bitwise_or.at(frag.state, dst, frag.state[src])
                es, ed = frag.edge_arrays()
                if not _close(frag.state, es, ed, frag.perm_ops_local,
                              max_passes=frontier_passes()):
                    self._quarantine_locked(frag)
                    continue
                self._upload_plane(frag)

    def apply_remove(self, key, endpoints) -> None:
        """A tuple the device graph just removed.  Closure-neutrality is
        provable only when the removed edge's source row never carried a
        bit; anything else quarantines the fragment for a background
        re-close (churn never serves a stale closure)."""
        if endpoints is None:
            return
        ends = np.asarray(endpoints, np.int64).reshape(-1, 2)
        with self._lock:
            for frag in self._frags:
                if frag.retired:
                    continue
                d_l = frag.local_of[ends[:, 1]]
                hit = d_l >= 0
                if not np.any(hit):
                    continue
                frag.seq += 1
                edges = frag.key_edges.pop(key, None)
                if edges is None:
                    # predates this generation's build: mask the
                    # compile-time edge arrays
                    edges = []
                    s_all = frag.local_of[ends[hit, 0]]
                    for s, d in zip(s_all.tolist(), d_l[hit].tolist()):
                        cand = np.nonzero(frag.base_alive
                                          & (frag.base_src == s)
                                          & (frag.base_dst == d))[0]
                        if not len(cand):
                            self._retire_locked(frag, "edge-bookkeeping")
                            edges = None
                            break
                        frag.base_alive[cand[0]] = False
                        edges.append((s, d))
                if edges is None or frag.quarantined:
                    continue
                if any(frag.state[s].any() for (s, _d) in edges):
                    self._quarantine_locked(frag)
                # else: the edge never carried a bit — closure unchanged

    def retire_relation(self, rel_slot: Tuple[str, str],
                        reason: str = "caveat-tuple") -> None:
        """Retire every fragment whose closure includes this (type,
        relation) slot — a caveated tuple landed on it and a closure bit
        cannot represent CONDITIONAL."""
        with self._lock:
            for frag in self._frags:
                if not frag.retired and rel_slot in set(frag.slots):
                    self._retire_locked(frag, reason)

    def _quarantine_locked(self, frag: _Fragment) -> None:
        frag.quarantined = True
        frag.live = False
        self.quarantines += 1

    def _retire_locked(self, frag: _Fragment, reason: str) -> None:
        frag.retired = True
        frag.live = False
        frag.quarantined = False
        frag.reason = reason

    # -- background re-close -------------------------------------------------

    def reclose_pending(self) -> List[_Fragment]:
        with self._lock:
            return [f for f in self._frags if f.quarantined and not f.retired]

    def reclose(self, frag: _Fragment, attempts: int = 3) -> bool:
        """Rebuild one quarantined fragment's closure from its maintained
        edge set: snapshot under the lock, fixpoint off-lock, install iff
        no delta touched the fragment meanwhile (else retry)."""
        t0 = time.perf_counter()
        for _ in range(max(1, attempts)):
            with self._lock:
                if frag.retired or not frag.quarantined:
                    return not frag.retired
                seq = frag.seq
                src, dst = frag.edge_arrays()
            state = frag.seeds.copy()
            if not _close(state, src, dst, frag.perm_ops_local,
                          max_passes=frag.n_rows + 2):
                with self._lock:
                    self._retire_locked(frag, "no-converge")
                return False
            with self._lock:
                if frag.retired:
                    return False
                if frag.seq != seq:
                    continue  # raced a delta; re-snapshot
                frag.state = state
                self._upload_plane(frag)
                frag.quarantined = False
                frag.live = True
                self.reclose_s += time.perf_counter() - t0
                self.recloses += 1
                return True
        return False
