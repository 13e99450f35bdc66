"""`torch://` endpoint: checks and lookups as a CUDA fixpoint sweep.

The torch counterpart of the reference's ops/jax_endpoint.py.  The same
host tuple store as `embedded://` stays the source of truth; the device
holds the compiled relation graph, and CheckBulkPermissions /
LookupResources run as one fused sweep per batch — every step a
hand-written CUDA kernel (ops/kernels).  Two interchangeable kernel kinds,
as in the reference:

- **ell** (default): bit-packed fixed-fanin gather tables (ops/ell.py);
- **segment**: a flat padded COO edge list swept by `edge_or`
  (ops/spmv.py), the reference's differential fallback; select it with
  `TorchEndpoint(kernel="segment")` or `SPICEDB_TPU_KERNEL=segment`.

Both are fronted by the Leopard closure index (ops/leopard.py, on unless
`leopard=False`): a nested-group (type, permission) pair whose fragment
is indexed answers checks with one bit gather of its closure plane and
lookups with its word columns, instead of one sweep per nesting level.

What this endpoint carries over from the reference, and what not yet:

- a full build from the store snapshot (columnar fast path), with one
  phantom column per type for subjects outside the compiled universe and
  the reference's pool of spare object ids, so the compiled program has
  the reference's exact layout;
- the fused check capture/finish and lookup capture/extract, exposed as
  the two-phase entries the dispatcher pipelines
  (`check_bulk_permissions_start`/`_finish`,
  `lookup_resources_batch_start`/`_finish`); a capture ends by starting
  its results' copy to the host on a side stream (`_Readback`), and the
  finish waits on that copy, never on a blocking `.cpu()`;
- caveats on the device: a caveated tuple whose stored context decides
  its caveat is an ordinary edge (True) or none (False); an undecidable
  one is an edge of the MAYBE plane (the caveat table), and checks on a
  graph with planes answer HAS / CONDITIONAL / NO.  Only a caveat shape
  with no device lowering (caveated wildcard, unknown caveat, evaluation
  error) routes its affected (type, permission) pairs to the host oracle;
- incremental delta absorption: committed writes, deletes and
  expirations queue as deltas; the next read applies them to the host
  tables (positionless OR-tree edits in the definite and caveat tables,
  spare rows renamed for new ids, OR-tree growth for full rows) and
  flushes the dirty rows to the device copy-on-write (the `scatter_rows`
  kernel).  Every absorbed delta is mirrored into the Leopard closure
  (inserts propagate, unprovable deletes quarantine the fragment until a
  background re-close, a caveated tuple retires it);
- off-loop rebuilds (the reference's AsyncRebuild path, switch
  `utils/features.py` `ASYNC_REBUILD`): a delta the tables cannot absorb
  — a wildcard change, the first undecidable caveat on a graph compiled
  without planes, a dry spare pool, an exhausted growth budget —
  quarantines its (type, permission) closure, whose reads the host
  oracle answers exactly, while a candidate generation builds on a
  background thread and the old one serves everything else; the deltas
  that arrive meanwhile replay onto the candidate, which is swapped in
  under a short lock.  A spare pool below its low watermark rebuilds
  the same way before it runs dry.  With the switch off the generation
  rebuilds synchronously under the lock;
- `warm_start(prewarm=True)` builds the kernels and, for every word
  bucket of the prewarm lanes, runs one check and one lookup batch per
  slot range, so each bucket's arena exists and its sweep graphs are
  captured before the first request (`prewarm_rebuilds` does the same
  on background candidates before their swap).

Reads are fully consistent w.r.t. the store: pending deltas are applied
under the endpoint lock before a query captures its snapshot.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import heapq
import logging
import os
import threading
import time
from typing import Iterable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..spicedb import schema as sch
from ..spicedb.endpoints import (
    Bootstrap,
    DEFAULT_BOOTSTRAP_SCHEMA,
    PermissionsEndpoint,
    apply_bootstrap_once,
    merge_internal_definitions,
)
from ..spicedb.evaluator import Evaluator
from ..spicedb.store import TupleStore, Watcher
from ..spicedb.types import (
    WILDCARD,
    AnnotatedIds,
    CheckRequest,
    CheckResult,
    ObjectRef,
    Permissionship,
    Precondition,
    Relationship,
    RelationshipFilter,
    RelationshipUpdate,
    SubjectRef,
    UpdateOp,
    WatchUpdate,
)
from ..utils import features
from ..utils.failpoints import fail_point
from . import kernels
from .ell import (K_AUX, EllKernelCache, _to_device, batch_words,
                  build_cav_tables, build_tables)
from .graph_compile import (GraphProgram, caveat_affected_pairs,
                            compile_graph, compile_graph_columnar)
from .leopard import LeopardIndex, plane_check, plane_word_cols
from .spmv import KernelCache as SegmentKernelCache
from .spmv import pad_edges

_log = logging.getLogger(__name__)

_MIN_EDGE_BUCKET = 256

_MIN_BATCH_BUCKET = 8

# One synthetic zero-tuple subject per type is compiled into every graph:
# a subject that appears in no tuple can differ from any other zero-tuple
# subject of its type only through wildcard terms, which key on the subject
# TYPE — so every unknown query subject maps onto its type's phantom column
# instead of falling back to the recursive host oracle.  The id contains
# NUL, which can never appear in a stored relationship id.
PHANTOM_ID = "\x00__phantom__"

# Spare object rows, sized exactly as the reference sizes them: a write
# that names a brand-new object id claims one by renaming it in the
# program's id maps instead of rebuilding, and a row whose assigned id
# loses its last tuple returns to the pool.  The prefix contains NUL,
# which can never appear in a stored id.
_SPARE_PREFIX = "\x00__spare__"
_SPARE_FLOOR = 64
_SPARE_DIVISOR = 64


def bucket(n: int, minimum: int = 16) -> int:
    """Next power-of-two bucket >= n."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _object_ids_np(graph, resource_type: str) -> tuple:
    """(ids array, placeholder mask) view of the program's id list, cached
    per graph: object-dtype ids for fancy-indexed materialization, and a
    mask of internal NUL-prefixed ids (phantom + spare placeholders).
    The entry is marked published: the caller indexes it outside the
    lock, so a later rename copies it first (`_rename_row`)."""
    entry = graph.ids_np.get(resource_type)
    if entry is None:
        lst = graph.prog.object_ids[resource_type]
        arr = np.asarray(lst, dtype=object)
        mask = np.fromiter(("\x00" in i for i in lst), dtype=bool,
                           count=len(lst))
        entry = graph.ids_np[resource_type] = (arr, mask)
    graph.ids_np_published.add(resource_type)
    return entry


def _evict_id_views(graph) -> None:
    """Drop an outgoing generation's cached id views.  Lookups that
    already captured a pair keep their own references."""
    if graph is not None:
        graph.ids_np.clear()
        graph.ids_np_published.clear()


def _rel_from_key(key: tuple) -> Relationship:
    """The identity fields of a relationship from its key (enough for
    edge endpoints)."""
    return Relationship(resource=ObjectRef(key[0], key[1]), relation=key[2],
                        subject=SubjectRef(key[3], key[4], key[5]))


def _sweep_bytes(graph, lanes: int) -> int:
    """Modeled device bytes for ONE fixpoint sweep of `graph` at `lanes`
    query lanes (the reference's model, jax_endpoint.py:258-303): each
    gather slot's packed-state read plus one state write per row, main
    table once, the aux table once per aux pass and the caveat table once,
    scaled by the batch width (4 bytes per 32 lanes, twice that with the
    definite and maybe planes).  The segment kernel's term is the
    reference's too: one gather read and one segment write per edge slot
    at 4 bytes per lane — float32 lanes, 32 times the packed words the
    port's `edge_or` moves."""
    if isinstance(graph, _SegmentGraph):
        return int(graph.edge_src.shape[0]) * 2 * lanes * 4
    n, km = graph.dev_main.shape
    a_rows, ka = graph.dev_aux.shape
    rows = n * (km + 1) + graph.kernel.aux_passes * a_rows * (ka + 1)
    width = max(1, lanes // 32) * 4
    if graph.has_cav:
        rows += (n + a_rows) * (graph.dev_cav.shape[1] + 1)
        width *= 2
    return rows * width


def _word_col_indices(wcol: np.ndarray, bit: int) -> np.ndarray:
    """Allowed slot indices from one packed uint32 word column (bit b of
    word w = query column w*32+b)."""
    return np.nonzero((wcol >> np.uint32(bit)) & np.uint32(1))[0]


def _ids_for(ids: np.ndarray, idx: np.ndarray, ph, mask) -> tuple:
    """Materialize an allowed-id list, dropping the phantom column's
    reserved id.  Any other internal placeholder id is suppressed (fail
    closed) and counted: returns (id list, suppressed count)."""
    if ph is not None:
        idx = idx[idx != ph]
    sel = mask[idx]
    bad_n = int(sel.sum()) if sel.any() else 0
    if bad_n:
        idx = idx[~sel]
    return ids[idx].tolist(), bad_n


# lookup_resources_stream yields its ids in chunks of this many, giving
# the event loop a turn between chunks (reference jax_endpoint.py:2783)
_STREAM_CHUNK = 4096

# One side stream per card carries the result readbacks (`_Readback`).
# It comes from PyTorch's high-priority stream pool: the default-priority
# pool hands its streams round-robin to sweep-graph captures
# (kernels.LaunchGraph), and a readback enqueued on a stream that another
# thread is capturing would break that capture.
_SIDE_STREAMS: dict = {}
_SIDE_LOCK = threading.Lock()


def _side_stream(device: torch.device):
    with _SIDE_LOCK:
        stream = _SIDE_STREAMS.get(device)
        if stream is None:
            stream = _SIDE_STREAMS[device] = torch.cuda.Stream(
                device=device, priority=-1)
        return stream


class _Readback:
    """A device result's copy to the host, started when its batch is
    captured (the reference's `_start_readback`, jax_endpoint.py:390-449).

    On CUDA the card's side stream first waits for the current stream,
    which runs the kernels that produce the result; then it copies the
    result into a pinned host tensor without blocking, the result is
    marked as used on the side stream (so the caching allocator keeps its
    memory until the copy is done), and an event is recorded after the
    copy.  `wait()` waits on that event and returns the host tensor; a
    failed copy raises there, and there is no fallback.  Kernels stay on
    the current stream: only the copy moves to the side stream.  On the
    CPU the readback is the tensor itself."""

    __slots__ = ("host", "event")

    def __init__(self, dev: torch.Tensor):
        if dev.device.type != "cuda":
            self.host, self.event = dev, None
            return
        side = _side_stream(dev.device)
        side.wait_stream(torch.cuda.current_stream(dev.device))
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        with torch.cuda.stream(side):
            host.copy_(dev, non_blocking=True)
        dev.record_stream(side)
        self.event = torch.cuda.Event()
        self.event.record(side)
        self.host = host

    def wait(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        return self.host


def _unify_check_buckets(q_arr, gather_idx, gather_col) -> tuple:
    """Pad the check gather to a power-of-two bucket floored at the lane
    width (padded slots re-read (row 0, col 0) and are discarded); the
    query lanes are never padded."""
    g = max(bucket(len(gather_idx), _MIN_BATCH_BUCKET), len(q_arr))
    gi = np.zeros(g, np.int32)
    gc = np.zeros(g, np.int32)
    gi[: len(gather_idx)] = gather_idx
    gc[: len(gather_col)] = gather_col
    return q_arr, gi, gc


def _settle(devices) -> None:
    """Wait until the work this thread queued so far on each card (its
    current stream: uploads, launches, captures' first sweeps) is done;
    CPU devices have nothing to wait for.  A candidate generation built
    on a background thread settles before it is published."""
    for dev in {d for d in devices if d.type == "cuda"}:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class _PrewarmMixin:
    """Prewarm of a generation's read path, shared by the graph kinds
    (the reference's _PrewarmMixin, jax_endpoint.py:510-577).  torch
    compiles nothing per shape; what a first request would otherwise
    pay is the kernel library's build and load, its bucket's arena, the
    first sweep launched step by step and, on the ELL graph, the capture
    of the arena's two sweep graphs (ops/ell.py `_capture`).  The flush
    has nothing to warm: `scatter_rows` is one launch at any row count."""

    def prewarm(self, lanes: Iterable[int],
                slot_ranges: Iterable[tuple]) -> int:
        """Build and load the kernel library (on a card), then run one
        check batch of dead-index lanes per word bucket that `lanes` land
        in and one lookup batch per slot range and bucket, on this
        generation's snapshot.  A bucket's first batch seeds, sweeps step
        by step and captures its arena's sweep graphs; the later ones
        replay (captures are keyed by arena, tables and plan, not by slot
        range).  Returns the number of batches run; a failure raises, and
        nothing falls back to eager launches."""
        if any(d.type == "cuda" for d in self.devices()):
            kernels._load()
        dead = self.prog.dead_index
        snap = self.snapshot()
        slot_ranges = list(slot_ranges)
        warmed = 0
        for b in sorted({self.batch_bucket(n) for n in lanes}):
            q = np.full(b, dead, np.int32)
            g = np.zeros(b, np.int32)
            self.run_checks3_device(q, g, g, snap=snap)
            warmed += 1
            for off, length in slot_ranges:
                self.run_lookup_packed_T_device(off, length, q, snap=snap)
                warmed += 1
        return warmed


class _EllGraph(_PrewarmMixin):
    """One compiled graph generation: fixed-fanin gather tables on the
    host and on the device, plus the kernel cache that sweeps them.

    Delta edits are positionless (reference jax_endpoint.py:778-1050):
    an edge (src -> dst) lives somewhere in dst's main row or its
    OR-tree, and since every tree node is a monotone OR gate, any dead
    slot in the tree can take a new child.  Inserts and removals walk the
    host tables (O(row fanin), on writes only) and mark rows dirty;
    `flush` moves them to the device.  Undecidable caveated edges get the
    same treatment in the caveat (MAYBE-plane) table when the graph was
    compiled with planes (`has_cav`).

    Copy-on-write: `flush` never writes a device table in place.  It
    builds new tensors (`scatter_rows`) and swaps them in, so a
    `snapshot()` captured under the endpoint lock keeps the tables it
    took — alive through its own references — while its batch sweeps
    outside the lock.  Flushes and batches run on the device's current
    stream, so the caching allocator reuses a dropped table's memory only
    after every kernel queued before the drop."""

    # Repeated growth on one destination nests OR-tree levels beyond the
    # single spare level the sweep's aux_passes budget covers; each level
    # past it costs queries on that hub an extra sweep.  Past this many
    # extra levels on one root the delta goes stale (rebuild).
    _GROW_EXTRA_MAX = 3

    def __init__(self, prog: GraphProgram, edge_endpoints,
                 device: torch.device, num_iters: Optional[int] = None):
        self.prog = prog
        self._edge_endpoints = edge_endpoints
        t = build_tables(prog)
        # tri-state path: undecidable caveated edges live in a separate
        # MAYBE-plane gather table and caveat-affected queries stay on
        # the device; a graph without them compiles no planes
        self.has_cav = bool(len(prog.cav_src)) and prog.caveats_device_ok
        self.tri_state_capable = prog.caveats_device_ok
        # caveated tuples delta incrementally: decided ones through the
        # definite tables, undecidable ones through the caveat table
        self.supports_cav_deltas = True
        tree_depth = t.tree_depth
        a_shared = t.idx_aux.shape[0]
        self.host_cav = ct = None
        if self.has_cav:
            ct = build_cav_tables(prog, a_shared)
            if ct.n_aux_cav:
                # caveat OR-tree nodes get dead rows in the shared aux
                # table so the main/aux step covers every state row
                t.idx_aux = np.vstack([
                    t.idx_aux,
                    np.full((ct.n_aux_cav, K_AUX), prog.dead_index,
                            np.int32)])
            self.host_cav = ct.idx_cav
            tree_depth = max(tree_depth, ct.tree_depth)
        self.host_main = t.idx_main
        self.host_aux = t.idx_aux
        self._spare_aux = list(t.spare_rows)
        self._dirty_main: set = set()
        self._dirty_aux: set = set()
        self._dirty_cav: set = set()
        # first caveat-aux row: values >= this in the caveat table are
        # OR-tree nodes whose children live in the caveat table itself
        self._cav_aux_base = prog.state_size + a_shared
        self._grow_extra: dict = {}  # root row -> levels grown past build
        # growths that flipped a stage's build-time aux-free annotation
        # (the endpoint folds them into its stage_aux_flips stat)
        self.stage_aux_flips = 0
        self.ids_np: dict = {}
        self.ids_np_published: set = set()
        self.last_trace = None   # sweep trace of the last kernel batch
        self._init_device(t, ct, tree_depth, device, num_iters)

    def _init_device(self, t, ct, tree_depth: int, device,
                     num_iters: Optional[int]) -> None:
        """Upload the host tables (`ct` the caveat tables, or None) and
        build the kernel cache that sweeps them."""
        # copies: on the CPU `.to()` would alias the host tables
        self.dev_main = torch.from_numpy(t.idx_main).to(device, copy=True)
        self.dev_aux = torch.from_numpy(t.idx_aux).to(device, copy=True)
        self.dev_cav = (torch.from_numpy(self.host_cav).to(device, copy=True)
                        if self.has_cav else None)
        self.kernel = EllKernelCache(self.prog, n_aux_rows=t.idx_aux.shape[0],
                                     tree_depth=tree_depth, device=device,
                                     num_iters=num_iters,
                                     shared_tree_depth=t.tree_depth,
                                     host_main=t.idx_main,
                                     host_aux=t.idx_aux,
                                     planes=self.has_cav)

    # -- tree walking --------------------------------------------------------

    def _walk(self, root_row: int, want: int) -> Optional[tuple]:
        """Find `want` (a state index, or the dead index for a free slot)
        in root_row's main row or its aux subtree: (table, row, col)."""
        n = self.prog.state_size
        stack = [("m", root_row)]
        while stack:
            table, row = stack.pop()
            arr = self.host_main if table == "m" else self.host_aux
            for col, v in enumerate(arr[row]):
                v = int(v)
                if v == want:
                    return (table, row, col)
                if v >= n:  # aux child: descend
                    stack.append(("a", v - n))
        return None

    def _set(self, loc: tuple, value: int) -> None:
        table, row, col = loc
        arr = self.host_main if table == "m" else self.host_aux
        old = arr[row].copy()
        arr[row, col] = value
        (self._dirty_main if table == "m" else self._dirty_aux).add(row)
        self._note_row(table, row, old, arr[row])

    def _note_row(self, table: str, row: int, old: np.ndarray,
                  new: np.ndarray) -> None:
        """Every host-table row whose children change passes here, so the
        kernel's in-place proofs stay true (EllKernelCache.note_row)."""
        self.kernel.note_row(table, row, old, new)

    # -- delta application ---------------------------------------------------

    def remove_key(self, key: tuple) -> None:
        """Remove a tuple's edges wherever they sit (absent ones, and ids
        outside the compiled universe, are no-ops)."""
        for (s, d) in self._edge_endpoints(self.prog,
                                           _rel_from_key(key)) or ():
            loc = self._walk(d, s)
            if loc is not None:
                self._set(loc, self.prog.dead_index)

    def _grow(self, root_row: int, src: int) -> bool:
        """Full main row: move its entries into a spare aux node, append
        `src` there and point the row at the node — one extra OR-tree
        level, exactly equivalent under OR.  False (rebuild) when the
        spare pool is dry or the root's growth budget is spent."""
        if not self._spare_aux:
            return False
        grown = self._grow_extra.get(root_row, 0)
        if grown >= self._GROW_EXTRA_MAX:
            return False
        row = self.host_main[root_row].copy()
        if len(row) + 1 > self.host_aux.shape[1]:
            return False  # K_MAIN >= K_AUX: the children do not fit a node
        j = self._spare_aux.pop()
        n = self.prog.state_size
        old_aux = self.host_aux[j].copy()
        self.host_aux[j, : len(row)] = row
        self.host_aux[j, len(row)] = src
        self._dirty_aux.add(j)
        self._note_row("a", j, old_aux, self.host_aux[j])
        self.host_main[root_row, 0] = n + j
        self.host_main[root_row, 1:] = self.prog.dead_index
        self._dirty_main.add(root_row)
        self._note_row("m", root_row, row, self.host_main[root_row])
        self._grow_extra[root_row] = grown + 1
        if self.kernel.note_main_aux_ref(root_row):
            self.stage_aux_flips += 1
        return True

    def add_rel(self, rel: Relationship) -> bool:
        """Insert a definite tuple's edges; False forces a rebuild (an id
        outside the universe, a wildcard, or a row that cannot grow)."""
        pairs = self._edge_endpoints(self.prog, rel)
        if pairs is None:
            return False
        dead = self.prog.dead_index
        for (s, d) in pairs:
            if self._walk(d, s) is not None:
                continue  # already present (re-touch)
            loc = self._walk(d, dead)
            if loc is None:
                if not self._grow(d, s):
                    return False
                continue
            self._set(loc, s)
        return True

    # -- caveat (MAYBE plane) table deltas -----------------------------------
    # The same positionless tree walk over the caveat table; the endpoint
    # routes a tuple's edges here when its caveat is undecidable.

    def _walk_cav(self, root_row: int, want: int) -> Optional[tuple]:
        if self.host_cav is None:
            return None
        stack = [root_row]
        while stack:
            row = stack.pop()
            for col, v in enumerate(self.host_cav[row]):
                v = int(v)
                if v == want:
                    return (row, col)
                if v >= self._cav_aux_base:  # caveat OR-tree node: descend
                    stack.append(v)
        return None

    def _set_cav(self, loc: tuple, value: int) -> None:
        row, col = loc
        self.host_cav[row, col] = value
        self._dirty_cav.add(row)

    def remove_cav_key(self, key: tuple) -> None:
        """Remove a tuple's MAYBE-plane edges (absent ones are no-ops)."""
        if self.host_cav is None:
            return
        for (s, d) in self._edge_endpoints(self.prog,
                                           _rel_from_key(key)) or ():
            loc = self._walk_cav(d, s)
            if loc is not None:
                self._set_cav(loc, self.prog.dead_index)

    def add_cav_rel(self, rel: Relationship) -> bool:
        """Insert a tuple's edges into the MAYBE plane; False forces a
        rebuild (no planes compiled, unknown ids, or a full row/tree)."""
        if self.host_cav is None:
            return False
        pairs = self._edge_endpoints(self.prog, rel)
        if pairs is None:
            return False
        dead = self.prog.dead_index
        for (s, d) in pairs:
            if self._walk_cav(d, s) is not None:
                continue  # already present (re-touch)
            loc = self._walk_cav(d, dead)
            if loc is None:
                return False  # row and tree full: a rebuild grows a level
            self._set_cav(loc, s)
        return True

    def flush(self) -> bool:
        """Push the dirty rows to the device, copy-on-write; True when a
        table changed.  Exactly the dirty rows go: torch compiles nothing
        per shape, so the reference's power-of-two padding is not
        needed."""
        changed = False
        if self._dirty_main:
            self.dev_main = _scatter_dirty(self.dev_main, self.host_main,
                                           self._dirty_main)
            self._dirty_main = set()
            changed = True
        if self._dirty_aux:
            self.dev_aux = _scatter_dirty(self.dev_aux, self.host_aux,
                                          self._dirty_aux)
            self._dirty_aux = set()
            changed = True
        if self._dirty_cav:
            self.dev_cav = _scatter_dirty(self.dev_cav, self.host_cav,
                                          self._dirty_cav)
            self._dirty_cav = set()
            changed = True
        if changed:
            # the gathers' write modes for the new tables, which the next
            # snapshot carries with them
            self.kernel.sync_in_place()
        return changed

    # -- queries ------------------------------------------------------------

    def devices(self) -> list:
        """The devices this generation's tables live on."""
        return [self.kernel.device]

    def batch_bucket(self, n: int) -> int:
        return batch_words(n) * 32

    def snapshot(self) -> tuple:
        """The current device tables (main, aux, caveat — None without
        planes), with the sweep plan proven for them as `.plan`; a flush
        swaps in new ones and never writes these."""
        return _Snapshot((self.dev_main, self.dev_aux, self.dev_cav),
                         self.kernel.plan)

    def run_checks3_device(self, q_arr, gather_idx, gather_col, snap=None):
        """Tri-state check values {0: NO, 1: CONDITIONAL, 2: HAS} on the
        device ({0, 2} without planes)."""
        snap = snap if snap is not None else self.snapshot()
        main, aux, cav = snap
        q_arr, gi, gc = _unify_check_buckets(q_arr, gather_idx, gather_col)
        n_words = max(1, len(q_arr) // 32)
        dev, tel = self.kernel.checks_device(q_arr, n_words, gi, gc, main,
                                             aux, cav,
                                             plan=getattr(snap, "plan", None))
        return dev, tel, self.kernel

    def run_lookup_packed_T_device(self, offset: int, length: int, q_arr,
                                   snap=None):
        """Definite-plane lookup words [W, length] on the device."""
        snap = snap if snap is not None else self.snapshot()
        main, aux, cav = snap
        n_words = max(1, len(q_arr) // 32)
        dev, tel = self.kernel.lookup_packed_T_device(
            offset, length, q_arr, n_words, main, aux, cav,
            plan=getattr(snap, "plan", None))
        return dev, tel, self.kernel

    def index_tuples(self, tuples: list) -> None:
        """Positionless tables: nothing to index (the segment graph
        records each tuple's edge positions here)."""


class _Snapshot(tuple):
    """An _EllGraph's (main, aux, caveat) device tables and, as `plan`,
    the kernel's sweep plan of the same moment: a flush may change where
    the gathers write, so a batch sweeps its tables with the plan proven
    for them."""

    def __new__(cls, tables: tuple, plan: list):
        snap = super().__new__(cls, tables)
        snap.plan = plan
        return snap


def _scatter_dirty(dev: torch.Tensor, host: np.ndarray,
                   dirty: set) -> torch.Tensor:
    """A new device table: `dev` with the `dirty` rows taken from `host`."""
    rows = np.asarray(sorted(dirty), np.int32)
    return kernels.scatter_rows(dev, _to_device(rows, dev.device),
                                _to_device(host[rows], dev.device))


class _SegmentGraph(_PrewarmMixin):
    """One compiled generation as flat padded edge arrays, swept by the
    segment kernel (ops/spmv.py) — the reference's _SegmentGraph
    (jax_endpoint.py:601-776).

    Edge capacity is twice the compiled edge count, bucketed; padding
    edges are (dead, dead).  A tuple's edges occupy positions recorded in
    `positions`; a removal frees them (dead edges again) and an insert
    pops free positions from the end of the free list.  Edits queue in
    `_updates` (last write wins per position) and `flush` writes NEW
    device arrays with `scatter_rows` (each array viewed as [cap, 1]), so
    a captured `snapshot()` keeps the arrays it took.  `host_src` and
    `host_dst` are the host copies of the device arrays.

    The segment kernel has no MAYBE plane: it serves caveat-affected
    pairs only when every caveat was decided at compile time.  A
    context-decided caveated tuple deltas as an ordinary edge; an
    undecidable one forces a rebuild (`add_cav_rel` is False), and the
    rebuilt graph routes the affected pairs to the host oracle."""

    def __init__(self, prog: GraphProgram, edge_endpoints,
                 device: torch.device, num_iters: Optional[int] = None):
        self.prog = prog
        self._edge_endpoints = edge_endpoints
        self.tri_state_capable = (prog.caveats_device_ok
                                  and not len(prog.cav_src))
        self.supports_cav_deltas = True
        capacity = bucket(max(len(prog.edge_src) * 2, _MIN_EDGE_BUCKET))
        self.host_src, self.host_dst = pad_edges(prog, capacity)
        # copies: on the CPU `.to()` would alias the host arrays
        self.edge_src = torch.from_numpy(self.host_src).to(device, copy=True)
        self.edge_dst = torch.from_numpy(self.host_dst).to(device, copy=True)
        e = len(prog.edge_src)
        self.free: list = list(range(e, capacity))
        # tuple key -> positions occupied by that tuple's edges
        self.positions: dict = {}
        self._updates: dict = {}   # pos -> (src, dst), until the flush
        # (src, dst) -> compiled positions, consumed by index_tuples
        self._pos_by_pair: dict = {}
        for i, pair in enumerate(zip(prog.edge_src.tolist(),
                                     prog.edge_dst.tolist())):
            self._pos_by_pair.setdefault(pair, []).append(i)
        self.kernel = SegmentKernelCache(prog, device, num_iters=num_iters)
        self.stage_aux_flips = 0
        self.ids_np: dict = {}
        self.ids_np_published: set = set()
        self.last_trace = None

    def index_tuples(self, tuples: list) -> None:
        """Record each loaded tuple's compiled edge positions (edges were
        emitted in tuple order then sorted: match them by pair)."""
        for rel in tuples:
            pairs = self._edge_endpoints(self.prog, rel)
            if not pairs:
                continue
            positions = []
            for pair in pairs:
                stack = self._pos_by_pair.get(pair)
                if stack:
                    positions.append(stack.pop())
            self.positions[rel.key()] = positions
        self._pos_by_pair = {}

    # -- delta application ---------------------------------------------------

    def remove_key(self, key: tuple) -> bool:
        for pos in self.positions.pop(key, ()):
            self._updates[pos] = (self.prog.dead_index, self.prog.dead_index)
            self.free.append(pos)
        return True

    def add_rel(self, rel: Relationship) -> bool:
        """Place a definite tuple's edges in free positions; False forces
        a rebuild (an id outside the universe, a wildcard, no capacity)."""
        key = rel.key()
        if key in self.positions:
            return True  # edges already present (re-touch)
        pairs = self._edge_endpoints(self.prog, rel)
        if pairs is None:
            return False
        positions = []
        for (s, d) in pairs:
            if not self.free:
                return False
            pos = self.free.pop()
            self._updates[pos] = (s, d)
            positions.append(pos)
        self.positions[key] = positions
        return True

    # no MAYBE plane: removals are vacuous, insertions force a rebuild
    def remove_cav_key(self, key: tuple) -> bool:
        return True

    def add_cav_rel(self, rel: Relationship) -> bool:
        return False

    def flush(self) -> bool:
        """Write the queued edits into new device arrays, copy-on-write;
        True when an array changed."""
        if not self._updates:
            return False
        pos = np.fromiter(self._updates.keys(), np.int32,
                          count=len(self._updates))
        sd = np.asarray(list(self._updates.values()), np.int32).reshape(-1, 2)
        self._updates = {}
        self.host_src[pos] = sd[:, 0]
        self.host_dst[pos] = sd[:, 1]
        dev = self.edge_src.device
        cap = self.host_src.shape[0]
        rows = _to_device(pos, dev)
        self.edge_src = kernels.scatter_rows(
            self.edge_src.view(cap, 1), rows,
            _to_device(sd[:, :1], dev)).view(cap)
        self.edge_dst = kernels.scatter_rows(
            self.edge_dst.view(cap, 1), rows,
            _to_device(sd[:, 1:], dev)).view(cap)
        return True

    # -- queries ------------------------------------------------------------

    def devices(self) -> list:
        return [self.kernel.device]

    def batch_bucket(self, n: int) -> int:
        return batch_words(n) * 32

    def snapshot(self) -> tuple:
        """The current device edge arrays; a flush swaps in new ones and
        never writes these."""
        return (self.edge_src, self.edge_dst)

    def run_checks3_device(self, q_arr, gather_idx, gather_col, snap=None):
        """{0, 2} check values on the device."""
        src, dst = snap if snap is not None else self.snapshot()
        q_arr, gi, gc = _unify_check_buckets(q_arr, gather_idx, gather_col)
        n_words = max(1, len(q_arr) // 32)
        dev, tel = self.kernel.checks_device(q_arr, n_words, gi, gc, src, dst)
        return dev, tel, self.kernel

    def run_lookup_packed_T_device(self, offset: int, length: int, q_arr,
                                   snap=None):
        """Lookup words [W, length] on the device."""
        src, dst = snap if snap is not None else self.snapshot()
        n_words = max(1, len(q_arr) // 32)
        dev, tel = self.kernel.lookup_packed_T_device(offset, length, q_arr,
                                                      n_words, src, dst)
        return dev, tel, self.kernel


class _ShardedEllGraph(_EllGraph):
    """The ELL graph over a (data x graph) mesh — the reference's
    _ShardedEllGraph (jax_endpoint.py:1126-1255).  The host tables and
    the positionless delta walk are _EllGraph's; the device tables are
    row blocks owned by a parallel.sharding.ShardedEllKernel, which
    sweeps them shard by shard.  `flush` goes through the kernel's
    `update_*_rows` (copy-on-write `scatter_rows` per touched block, the
    caveat table remapped into the padded row space).  The sharded sweep
    has no staged step, so no growth flips a stage."""

    def __init__(self, prog: GraphProgram, edge_endpoints, mesh,
                 num_iters: Optional[int] = None):
        super().__init__(prog, edge_endpoints, mesh, num_iters)

    def _init_device(self, t, ct, tree_depth: int, mesh,
                     num_iters: Optional[int]) -> None:
        from ..parallel.sharding import ShardedEllKernel

        self.kernel = ShardedEllKernel(self.prog, mesh, num_iters=num_iters,
                                       tables=t, cav=ct)

    def _note_row(self, table: str, row: int, old: np.ndarray,
                  new: np.ndarray) -> None:
        """The sharded sweep reads no buffer that a pass writes
        (parallel/sharding.py): nothing to prove."""

    def flush(self) -> bool:
        changed = False
        for dirty, host, update in (
                (self._dirty_main, self.host_main,
                 self.kernel.update_main_rows),
                (self._dirty_aux, self.host_aux, self.kernel.update_aux_rows),
                (self._dirty_cav, self.host_cav,
                 self.kernel.update_cav_rows)):
            if dirty:
                rows = np.asarray(sorted(dirty), np.int32)
                update(rows, host[rows])
                dirty.clear()
                changed = True
        return changed

    def devices(self) -> list:
        return [d for row in self.kernel.mesh.devices for d in row]

    def batch_bucket(self, n: int) -> int:
        # whole words per data shard
        return self.kernel.padded_batch_words(max(n, 32)) * 32

    def snapshot(self) -> tuple:
        """The kernel's current [D][G] table blocks; a flush swaps in new
        blocks and never writes these."""
        return self.kernel.snapshot_tables()

    def run_checks3_device(self, q_arr, gather_idx, gather_col, snap=None):
        tables = snap if snap is not None else self.snapshot()
        q_arr, gi, gc = _unify_check_buckets(q_arr, gather_idx, gather_col)
        n_words = max(1, len(q_arr) // 32)
        dev, tel = self.kernel.checks_device(q_arr, n_words, gi, gc, *tables)
        return dev, tel, self.kernel

    def run_lookup_packed_T_device(self, offset: int, length: int, q_arr,
                                   snap=None):
        tables = snap if snap is not None else self.snapshot()
        n_words = max(1, len(q_arr) // 32)
        dev, tel = self.kernel.lookup_packed_T_device(offset, length, q_arr,
                                                      n_words, *tables)
        return dev, tel, self.kernel


_GRAPH_KINDS = {"ell": _EllGraph, "segment": _SegmentGraph}

# Background rebuilds and Leopard re-closes run here, never on the event
# loop's executor that the query paths wait on (reference _rebuild_pool).
_REBUILD_POOL = None
_REBUILD_POOL_LOCK = threading.Lock()


def _rebuild_pool():
    global _REBUILD_POOL
    if _REBUILD_POOL is None:
        with _REBUILD_POOL_LOCK:
            if _REBUILD_POOL is None:
                _REBUILD_POOL = concurrent.futures.ThreadPoolExecutor(
                    max_workers=2, thread_name_prefix="authz-rebuild")
    return _REBUILD_POOL


class _GenState:
    """One generation's host-side state, built as a candidate off the
    endpoint lock and installed under it (reference jax_endpoint.py:
    365-388).  The field names are the endpoint's live attributes, so the
    delta machinery (`_apply_batches` and the helpers it calls) runs
    identically on the live generation (`st=self`) and on a candidate
    mid-replay."""

    __slots__ = ("_graph", "_graph_revision", "_spare_pool",
                 "_assigned_refs", "_spare_seq", "_caveat_affected",
                 "_caveated_keys", "_expiry_heap", "_expiry_meta",
                 "_stale_pairs", "_leopard")

    def __init__(self):
        self._graph = None
        self._graph_revision = 0
        self._spare_pool: dict = {}
        self._assigned_refs: dict = {}
        self._spare_seq = 0
        self._caveat_affected: set = set()
        self._caveated_keys: set = set()
        self._expiry_heap: list = []
        self._expiry_meta: dict = {}
        self._stale_pairs: set = set()
        self._leopard = None


class TorchEndpoint(PermissionsEndpoint):
    """`kernel` picks the graph kind ("ell" or "segment"; default the
    SPICEDB_TPU_KERNEL environment variable, else "ell").  `leopard` is
    the port's form of the reference's LeopardIndex gate, read once here:
    with it on, every generation builds the closure index.  `mesh` (a
    parallel.sharding.Mesh) shards the ELL graph and the closure planes
    over its (data x graph) grid; the endpoint's own device is then shard
    (0, 0)'s unless `device` names one."""

    def __init__(self, schema: sch.Schema, store: Optional[TupleStore] = None,
                 num_iters: Optional[int] = None, device=None,
                 kernel: Optional[str] = None, leopard: bool = True,
                 mesh=None):
        kind = kernel or os.environ.get("SPICEDB_TPU_KERNEL", "ell")
        if kind not in _GRAPH_KINDS:
            raise ValueError(f"unknown kernel {kind!r}; "
                             f"expected one of {sorted(_GRAPH_KINDS)}")
        if mesh is not None and kind != "ell":
            raise ValueError("mesh sharding requires the ell kernel")
        self.mesh = mesh
        self.kernel_kind = kind
        self._graph_cls = _GRAPH_KINDS[kind]
        if device is None and mesh is not None:
            device = mesh.devices[0][0]
        self.device = resolve_device(device)
        self.schema = schema
        self.store = store if store is not None else TupleStore()
        # host oracle: caveat residuals and schema-error shapes
        self._oracle = Evaluator(schema, self.store)
        self._num_iters = num_iters
        self._lock = threading.RLock()
        self._graph = None
        # store revision the device graph reflects (checked_at source):
        # a rebuild captures it with its snapshot, applied delta batches
        # advance it to their own revision
        self._graph_revision = 0
        # store listeners run under the STORE lock and must never take
        # self._lock: delta intake is a lock-free deque append, a store
        # reset only raises a flag
        self._pending: collections.deque = collections.deque()
        self._graph_invalid = False
        # (expires_at, key) min-heap; _expiry_meta holds each key's
        # current expiry, and heap entries that disagree are skipped
        self._expiry_heap: list = []
        self._expiry_meta: dict = {}
        self._caveat_affected: set = set()
        self._caveated_keys: set = set()
        self._stale_closure_cache: dict = {}   # (type, rel) -> pair set
        self._spare_pool: dict = {}
        # (type, id) -> live tuple keys, for spare-ASSIGNED ids only: an
        # emptied set renames the row back to a placeholder and repools it
        self._assigned_refs: dict = {}
        self._spare_seq = 0
        self.stats = {"rebuilds": 0, "delta_batches": 0, "kernel_calls": 0,
                      "oracle_residual_checks": 0, "placeholder_suppressed": 0,
                      "spare_assignments": 0, "spare_reclaims": 0,
                      "stage_aux_flips": 0, "stale_pair_marks": 0,
                      "stale_routed": 0, "bg_rebuilds": 0,
                      "preemptive_rebuilds": 0, "rebuild_failures": 0,
                      "bg_install_s": 0.0,
                      "leopard_checks": 0, "leopard_lookups": 0,
                      "leopard_recloses": 0,
                      "delta_apply_s": 0.0, "flush_s": 0.0,
                      "readbacks": 0, "readback_bytes": 0,
                      "readback_wait_s": 0.0, "explain_checks": 0}
        # off-loop rebuild state (the reference's, jax_endpoint.py:
        # 1326-1359).  While a background rebuild is in flight the old
        # generation keeps serving: deltas it can absorb apply as usual,
        # deltas it cannot quarantine their (type, permission) closure in
        # _stale_pairs, whose reads the host oracle answers until the swap
        self._stale_pairs: set = set()
        self._bg_inflight = False
        self._bg_future = None
        self._bg_pending: Optional[collections.deque] = None
        self._bg_epoch = 0
        self._bg_not_before = 0.0
        # bumped at every install: a candidate built against epoch N is
        # abandoned when a synchronous rebuild installed N + 1 first
        self._gen_epoch = 0
        # bumped at every background start and every install
        self._rebuild_epoch = 0
        # the live generation's initial spare pool sizes, for the
        # low-watermark preemptive rebuild (_spare_pressure)
        self._spare_initial: dict = {}
        self._spare_aux_initial = 0
        # prewarm background candidates before their swap, as
        # warm_start(prewarm=True) does at startup
        self.prewarm_rebuilds = False
        # a leaf lock for the readback counters: a finish never takes
        # self._lock, which a rebuild may hold for a long time
        self._readback_lock = threading.Lock()
        # the Leopard closure index of the live generation (None when
        # off), and the in-flight background re-closes
        self._leopard_wanted = bool(leopard)
        self._leopard: Optional[LeopardIndex] = None
        self._leo_futures: list = []
        self.store.add_delta_listener(self._on_delta)
        self.store.add_reset_listener(self._on_reset)

    @classmethod
    def from_bootstrap(cls, bootstrap: Optional[Bootstrap] = None,
                       **kwargs) -> "TorchEndpoint":
        if bootstrap is None or not bootstrap.schema_text:
            schema_text = DEFAULT_BOOTSTRAP_SCHEMA
            rel_text = bootstrap.relationships_text if bootstrap else ""
        else:
            schema_text = bootstrap.schema_text
            rel_text = bootstrap.relationships_text
        ep = cls(merge_internal_definitions(sch.parse_schema(schema_text)),
                 **kwargs)
        apply_bootstrap_once(ep.store, rel_text)
        return ep

    # the prewarm ladder (reference jax_endpoint.py:1406-1412): the lane
    # counts fused batches land in, from the single-query floor through
    # the 256-concurrent headline shape, and at most this many lookup
    # slot ranges
    _PREWARM_LANES = (8, 16, 32, 64, 128, 256)
    _PREWARM_SLOT_CAP = 16

    def warm_start(self, prewarm: bool = False) -> None:
        """Build the device graph from the current store now instead of on
        the first query.  `prewarm=True` also runs the generation's
        prewarm (`_PrewarmMixin.prewarm`): the kernel library built and
        loaded, and every bucket of `_PREWARM_LANES` seeded, swept and
        captured, so the first batch of each pays none of it.  A failed
        prewarm raises."""
        with self._lock:
            self._apply_pending()
            graph = self._graph
        if not prewarm or graph is None:
            return
        t0 = time.perf_counter()
        warmed = self._prewarm_graph(graph)
        _log.info("prewarmed %d read batches (%d lane buckets x %d lookup "
                  "slot ranges + checks) in %.2f s", warmed,
                  len({graph.batch_bucket(n) for n in self._PREWARM_LANES}),
                  len(self._prewarm_slot_ranges(graph)),
                  time.perf_counter() - t0)

    def _prewarm_graph(self, graph) -> int:
        """Prewarm one generation — the live one at warm_start, or a
        background candidate before its swap, so the two can never cover
        different entries.  Returns the batches run; a failure raises (a
        background candidate then counts a rebuild failure and the old
        generation keeps serving)."""
        return graph.prewarm(lanes=self._PREWARM_LANES,
                             slot_ranges=self._prewarm_slot_ranges(graph))

    def _prewarm_slot_ranges(self, graph) -> list:
        slot_ranges = []
        for t, d in self.schema.definitions.items():
            for p in d.permissions:
                rng = graph.prog.slot_range(t, p)
                if rng is not None:
                    slot_ranges.append(rng)
            if len(slot_ranges) >= self._PREWARM_SLOT_CAP:
                break
        return slot_ranges[: self._PREWARM_SLOT_CAP]

    def graph(self):
        """The device graph reflecting the committed store (pending
        deltas applied, or the generation rebuilt, first)."""
        with self._lock:
            return self._current_graph()

    def force_rebuild(self) -> None:
        """Rebuild the generation from the store now."""
        with self._lock:
            self._rebuild()

    # -- delta intake -------------------------------------------------------

    def _on_delta(self, update: WatchUpdate) -> None:
        # under the store lock: must not take self._lock.  The background
        # intake is appended BEFORE self._pending (reference :1446-1461):
        # in the other order this thread could be preempted after the
        # _pending append, the foreground drain it onto the OLD
        # generation, the candidate replay without it and swap, and the
        # delta be lost from the new generation.  Appended first, it is
        # either in the intake before the swap's drain (replayed onto the
        # candidate) or appended after the swap cleared the intake, and
        # then _pending still holds it for the new generation's next
        # drain (re-applying a delta is idempotent).
        bg = self._bg_pending
        if bg is not None:
            bg.append(update)
        self._pending.append(update)

    def _on_reset(self) -> None:
        # bulk_load / delete_all: the next read rebuilds
        self._graph_invalid = True

    def _drain_pending(self) -> list:
        """Atomically take all queued delta batches."""
        out = []
        while True:
            try:
                out.append(self._pending.popleft())
            except IndexError:
                return out

    # -- graph maintenance --------------------------------------------------

    def _edge_endpoints(self, prog: GraphProgram,
                        rel: Relationship) -> Optional[list]:
        """(src, dst) state pairs a tuple contributes, [] for an edgeless
        one, None when an id is outside the compiled universe or the
        subject is a wildcard (baked into the program: rebuild)."""
        rt = rel.resource.type
        d = self.schema.definitions.get(rt)
        if d is None or rel.relation not in d.relations:
            return []
        dst = prog.state_index(rt, rel.relation, rel.resource.id)
        if dst is None:
            return None
        st, sid, srel = rel.subject.type, rel.subject.id, rel.subject.relation
        if sid == WILDCARD:
            return None
        src = prog.subject_index(st, sid, srel)
        if src is None:
            return None
        out = [(src, dst)]
        for (_, _, target, slot) in prog.arrow_specs.get((rt, rel.relation),
                                                         ()):
            if srel:
                continue
            target_def = self.schema.definitions.get(st)
            if (target_def is None
                    or not target_def.has_relation_or_permission(target)):
                continue
            asrc = prog.state_index(st, target, sid)
            adst = prog.state_index(rt, slot, rel.resource.id)
            if asrc is None or adst is None:
                return None
            out.append((asrc, adst))
        return out

    def _current_graph(self):
        """The graph reflecting the committed store (under self._lock)."""
        self._apply_pending()
        return self._graph

    def _apply_pending(self) -> None:
        """Drain store deltas into the graph and flush them (under
        self._lock; reference jax_endpoint.py:2003-2059).  The graph is
        rebuilt synchronously when it is missing or a store reset
        invalidated it.  A delta it cannot absorb quarantines its
        (type, permission) closure and kicks a background rebuild; with
        ASYNC_REBUILD off it rebuilds synchronously instead, the snapshot
        subsuming every drained delta."""
        if self._graph_invalid:
            self._graph_invalid = False
            _evict_id_views(self._graph)
            self._graph = None
        graph = self._graph
        if graph is None:
            self._rebuild()
            return
        # re-arm a needed rebuild (pairs still quarantined after a crashed
        # or abandoned background attempt), rate-limited
        if (self._stale_pairs and not self._bg_inflight
                and self._async_rebuild_on()
                and time.monotonic() >= self._bg_not_before):
            self._kick_background_rebuild("background")
        batches = self._drain_pending()
        if not batches and not (self._expiry_heap and self._expiry_heap[0][0]
                                <= self.store.now()):
            return
        t0 = time.perf_counter()
        stale, applied_revision = self._apply_batches(self, batches)
        if stale and not self._async_rebuild_on():
            self._rebuild()
            return
        self._graph_revision = applied_revision
        if stale:
            # quarantine: the affected pairs go to the host oracle while
            # the replacement builds off the lock and this generation
            # serves everything else
            self._stale_pairs |= stale
            self._kick_background_rebuild("background")
        if graph.stage_aux_flips:
            self.stats["stage_aux_flips"] += graph.stage_aux_flips
            graph.stage_aux_flips = 0
        t1 = time.perf_counter()
        if graph.flush():
            self.stats["delta_batches"] += 1
        # host seconds of delta application and of the flush (its
        # uploads and launches; the kernels run on asynchronously)
        self.stats["delta_apply_s"] += t1 - t0
        self.stats["flush_s"] += time.perf_counter() - t1
        if not stale and self._async_rebuild_on() and self._spare_pressure():
            # low watermark: refresh the spare pools in the background
            # before new-object churn runs them dry
            self._kick_background_rebuild("preemptive")
        self._kick_leopard_recloses()

    def _kick_leopard_recloses(self) -> None:
        """Submit background re-closes for delete-quarantined fragments
        (under self._lock; reference jax_endpoint.py:2061-2083).  Until a
        re-close lands the quarantined pairs are served by the sweep,
        which the delta path kept correct."""
        lp = self._leopard
        if lp is None:
            return
        self._leo_futures = [f for f in self._leo_futures if not f.done()]
        if self._leo_futures:
            return  # one re-close wave at a time
        for frag in lp.reclose_pending():
            try:
                fut = _rebuild_pool().submit(lp.reclose, frag)
            except RuntimeError:
                break  # executor shut down: the fragment stays quarantined
            self._leo_futures.append(fut)
            self.stats["leopard_recloses"] += 1

    # -- off-loop rebuilds (reference jax_endpoint.py:2095-2294) -------------

    _SPARE_LOW_FRACTION = 0.25
    _BG_RETRY_BACKOFF_S = 1.0
    _BG_REPLAY_ATTEMPTS = 3

    def _async_rebuild_on(self) -> bool:
        """The ASYNC_REBUILD switch; a missing one reads as off (fails
        closed: synchronous rebuilds)."""
        return getattr(features, "ASYNC_REBUILD", False) is True

    def _spare_pressure(self) -> bool:
        """True when the live generation's spare capacity (an object
        pool, or the ELL spare aux pool) is under the low watermark: the
        signal to rebuild while churn can still be absorbed in place."""
        for t, init in self._spare_initial.items():
            if init >= 8 and (len(self._spare_pool.get(t, ()))
                              < init * self._SPARE_LOW_FRACTION):
                return True
        if self._spare_aux_initial >= 8:
            free_aux = len(getattr(self._graph, "_spare_aux", ()))
            if free_aux < self._spare_aux_initial * self._SPARE_LOW_FRACTION:
                return True
        return False

    def _kick_background_rebuild(self, mode: str) -> None:
        """Submit one off-loop rebuild (under self._lock); a no-op while
        one is in flight or inside the failure backoff."""
        if self._bg_inflight or time.monotonic() < self._bg_not_before:
            return
        self._bg_inflight = True
        self._rebuild_epoch += 1
        self._bg_epoch = self._gen_epoch
        # open the candidate's delta intake BEFORE its snapshot: every
        # delta committed from now on is inside the snapshot (idempotent
        # replay) or replayed at the swap
        self._bg_pending = collections.deque()
        try:
            self._bg_future = _rebuild_pool().submit(self._bg_rebuild_run,
                                                     mode)
        except RuntimeError:    # the executor is shut down
            # a failed submit must not latch _bg_inflight, which would
            # pin the stale pairs on the oracle for good
            self._bg_pending = None
            self._bg_inflight = False
            self._bg_future = None
            self._bg_not_before = (time.monotonic()
                                   + self._BG_RETRY_BACKOFF_S)
            _log.exception("background rebuild submit failed; will re-arm")

    def _drain_bg_pending(self) -> list:
        out = []
        bg = self._bg_pending
        if bg is not None:
            while True:
                try:
                    out.append(bg.popleft())
                except IndexError:
                    break
        return out

    def _bg_rebuild_run(self, mode: str) -> None:
        """The executor's body of one off-loop rebuild: build a candidate
        from a store snapshot with no endpoint lock held (prewarmed when
        `prewarm_rebuilds`, and settled on the card), then under the lock
        replay the deltas that arrived during the build and swap.  A
        candidate that a synchronous install or a store reset overtook is
        abandoned.  A replay that cannot absorb a delta retries from a
        fresh snapshot; the last attempt installs with its residue still
        quarantined and backs off.  On any failure the old generation
        keeps serving."""
        try:
            for attempt in range(self._BG_REPLAY_ATTEMPTS):
                st = self._build_candidate()
                if self.prewarm_rebuilds:
                    self._prewarm_graph(st._graph)
                # the candidate's uploads, launches and captures are done
                # before any serving thread can see its tables
                _settle(st._graph.devices())
                with self._lock:
                    t_lock = time.perf_counter()
                    if self._gen_epoch != self._bg_epoch:
                        return  # a synchronous rebuild installed first
                    if self._graph_invalid:
                        # a bulk load or delete_all during the build: the
                        # next read rebuilds synchronously
                        return
                    stale, rev = self._apply_batches(
                        st, self._drain_bg_pending())
                    st._graph_revision = max(st._graph_revision, rev)
                    if stale and attempt < self._BG_REPLAY_ATTEMPTS - 1:
                        continue  # a fresh snapshot subsumes the misfits
                    st._stale_pairs |= stale
                    st._graph.flush()
                    self._install_candidate(st, mode=mode)
                    # host seconds the install held the lock: the replay,
                    # its flush and the swap
                    self.stats["bg_install_s"] += time.perf_counter() - t_lock
                    if stale:
                        # residue carried over: back off, then a read
                        # re-arms the follow-up
                        self._bg_not_before = (time.monotonic()
                                               + self._BG_RETRY_BACKOFF_S)
                    return
        except Exception:
            _log.exception("background graph rebuild (%s) failed; the "
                           "previous generation keeps serving", mode)
            with self._lock:
                self.stats["rebuild_failures"] += 1
                self._bg_not_before = (time.monotonic()
                                       + self._BG_RETRY_BACKOFF_S)
        finally:
            with self._lock:
                self._bg_pending = None
                self._bg_inflight = False
                self._bg_future = None

    @property
    def rebuild_inflight(self) -> bool:
        return self._bg_inflight

    @property
    def rebuild_epoch(self) -> int:
        """Monotone count of background rebuild starts and installs: an
        unchanged value proves no rebuild overlapped an operation."""
        return self._rebuild_epoch

    def wait_rebuilds(self, timeout: float = 30.0) -> bool:
        """Quiesce background work: block until no rebuild or Leopard
        re-close is in flight and no pair is quarantined, kicking a
        follow-up rebuild (or re-close) where one is needed.  The serving
        paths never call it.  Returns True when quiescent."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                fut = self._bg_future
                if fut is None:
                    leo = [f for f in self._leo_futures if not f.done()]
                    if leo:
                        fut = leo[0]
                    elif (self._leopard is not None
                            and self._leopard.reclose_pending()):
                        self._kick_leopard_recloses()
                        leo = [f for f in self._leo_futures
                               if not f.done()]
                        fut = leo[0] if leo else None
                    elif (not self._stale_pairs
                            or not self._async_rebuild_on()):
                        return True
                    else:
                        self._bg_not_before = 0.0
                        self._kick_background_rebuild("background")
                        fut = self._bg_future
            if fut is not None:
                try:
                    fut.result(timeout=max(0.01,
                                           deadline - time.monotonic()))
                except Exception:
                    pass  # a failed attempt counted itself; loop re-arms
        with self._lock:
            return not self._bg_inflight and not self._stale_pairs

    def _make_graph(self, prog: GraphProgram):
        if self.mesh is not None:
            return _ShardedEllGraph(prog, self._edge_endpoints, self.mesh,
                                    num_iters=self._num_iters)
        return self._graph_cls(prog, self._edge_endpoints, self.device,
                               num_iters=self._num_iters)

    def _rebuild(self) -> None:
        """Synchronous rebuild under the endpoint lock (reference
        jax_endpoint.py:1511-1521): the first build, a store reset,
        force_rebuild and the ASYNC_REBUILD-off path.  Queued deltas are
        subsumed by the snapshot: one that lands after the drain is
        re-applied idempotently."""
        self._drain_pending()
        self._graph_invalid = False
        self._install_candidate(self._build_candidate(), mode="sync")

    def _build_candidate(self) -> _GenState:
        """Build a complete candidate generation from the current store
        snapshot without changing the endpoint's state (reference
        jax_endpoint.py:1523-1605), the Leopard index included.  The live
        generation's sizes are read under the endpoint lock and the
        snapshot and its revision under the store lock; the compile, the
        uploads and the index build hold neither, so a background thread
        can run it while the live generation serves."""
        fail_point("rebuildExecutor")
        st = _GenState()
        with self._lock:
            prev = self._graph
            prev_counts = dict(prev.prog.num_objects) if prev else {}
            # num_objects counts the previous generation's synthetic rows
            # (1 phantom + the unassigned spares): size the pool from the
            # real universe
            prev_synth = ({t: 1 + len(p) for t, p in self._spare_pool.items()}
                          if prev else {})
        extra = {}
        for t in self.schema.definitions:
            n_t = max(prev_counts.get(t, 0) - prev_synth.get(t, 0),
                      len(self.store.object_ids_of_type(t)))
            n_spare = max(_SPARE_FLOOR, n_t // _SPARE_DIVISOR)
            spares = [f"{_SPARE_PREFIX}{k}" for k in range(n_spare)]
            extra[t] = {PHANTOM_ID, *spares}
            st._spare_pool[t] = spares
        with self.store.lock:
            st._graph_revision = self.store.revision
            caveated = self.store.caveated_relation_pairs()
            st._caveat_affected = (caveat_affected_pairs(self.schema,
                                                         caveated)
                                   if caveated else set())
            st._caveated_keys = self.store.caveated_keys() if caveated \
                else set()
            # the segment graph records tuple positions: it compiles from
            # the tuple list, as the reference's does
            view = (self.store.columnar_view()
                    if self._graph_cls is _EllGraph else None)
            tuples = None if view is not None else self.store.read(None)
        if view is not None:
            snap, rows, overlay = view
            prog = compile_graph_columnar(self.schema, snap, rows, overlay,
                                          extra_subject_ids=extra)
            graph = self._make_graph(prog)
            self._reset_expiry_columnar(st, snap, rows, overlay)
        else:
            prog = compile_graph(self.schema, tuples, extra_subject_ids=extra)
            graph = self._make_graph(prog)
            graph.index_tuples(tuples)
            self._reset_expiry(st, tuples)
        st._graph = graph
        # the closure is seeded from the compiled edges, so it reflects
        # exactly this generation's revision; the port has no workload
        # plane, so no candidate pairs go first
        if self._leopard_wanted:
            st._leopard = LeopardIndex.build(
                self.schema, prog,
                caveat_affected=frozenset(st._caveat_affected),
                device=self.device, mesh=self.mesh)
        return st

    def _install_candidate(self, st: _GenState, mode: str = "sync") -> None:
        """Swap a candidate generation in (under self._lock; reference
        jax_endpoint.py:1607-1671): the short-lock tail of the
        synchronous and the off-loop rebuild.  The outgoing generation's
        tables go when the last batch that captured them drops its
        snapshot."""
        _evict_id_views(self._graph)
        self._graph = st._graph
        self._graph_revision = st._graph_revision
        self._spare_pool = st._spare_pool
        self._assigned_refs = st._assigned_refs
        self._spare_seq = st._spare_seq
        self._caveat_affected = st._caveat_affected
        self._caveated_keys = st._caveated_keys
        self._expiry_heap = st._expiry_heap
        self._expiry_meta = st._expiry_meta
        # a candidate's unresolved stale pairs (its replay kept failing)
        # carry over, routed to the oracle until a follow-up; a clean
        # candidate clears the set
        self._stale_pairs = set(st._stale_pairs)
        self._spare_initial = {t: len(p) for t, p in st._spare_pool.items()}
        self._spare_aux_initial = len(getattr(st._graph, "_spare_aux", ()))
        self._leopard = st._leopard
        self._gen_epoch += 1
        self._rebuild_epoch += 1
        self.stats["rebuilds"] += 1
        if mode != "sync":
            # every off-loop install, preemptive ones included; an
            # abandoned candidate counts nowhere
            self.stats["bg_rebuilds"] += 1
        if mode == "preemptive":
            self.stats["preemptive_rebuilds"] += 1

    # -- expiry heap ----------------------------------------------------------

    def _reset_expiry_columnar(self, st, snap, rows, overlay) -> None:
        st._expiry_heap = []
        st._expiry_meta = {}
        exp = snap.expiry[rows]
        for i in np.nonzero(~np.isnan(exp))[0]:
            key = snap.key_of(int(rows[i]))
            self._set_expiry(st, key, float(exp[i]))
        for rel in overlay:
            if rel.expires_at is not None:
                self._set_expiry(st, rel.key(), rel.expires_at)

    def _reset_expiry(self, st, tuples: list) -> None:
        st._expiry_heap = []
        st._expiry_meta = {}
        for rel in tuples:
            if rel.expires_at is not None:
                self._set_expiry(st, rel.key(), rel.expires_at)

    def _set_expiry(self, st, key: tuple, expires_at) -> None:
        if expires_at is None:
            st._expiry_meta.pop(key, None)
        else:
            st._expiry_meta[key] = expires_at
            heapq.heappush(st._expiry_heap, (expires_at, key))

    # -- spare object rows ----------------------------------------------------
    # `st` is the live endpoint or a candidate mid-replay; counters move
    # only for the live one, whose deltas the replay re-applies (reference
    # jax_endpoint.py:1713-1732)

    def _assign_spare(self, st, graph, type_name: str, new_id: str) -> bool:
        """Claim a spare row for a brand-new object id by renaming it in
        the program's id maps; the tables are untouched (the row exists,
        dead, in every slot of the type).  False when the pool is dry."""
        pool = st._spare_pool.get(type_name)
        if not pool:
            return False
        self._rename_row(graph, type_name, pool.pop(), new_id)
        st._assigned_refs[(type_name, new_id)] = set()
        if st is self:
            self.stats["spare_assignments"] += 1
        return True

    def _rename_row(self, graph, type_name: str, old_id: str,
                    new_id: str) -> bool:
        """Rename one object row in the program's id maps and patch the
        graph's cached id view.  A published view (one a lookup may be
        indexing outside the lock) is copied before the patch and the copy
        replaces it; an unpublished one is patched in place."""
        prog = graph.prog
        local = prog.object_index[type_name].pop(old_id, None)
        if local is None:
            return False
        prog.object_index[type_name][new_id] = local
        prog.object_ids[type_name][local] = new_id
        entry = graph.ids_np.get(type_name)
        if entry is not None:
            arr, mask = entry
            if type_name in graph.ids_np_published:
                arr, mask = arr.copy(), mask.copy()
                graph.ids_np[type_name] = (arr, mask)
                graph.ids_np_published.discard(type_name)
            arr[local] = new_id
            mask[local] = "\x00" in new_id
        return True

    def _note_key_applied(self, st, key: tuple) -> None:
        """Record a live tuple against any spare-assigned ids it names."""
        for side in ((key[0], key[1]), (key[3], key[4])):
            refs = st._assigned_refs.get(side)
            if refs is not None:
                refs.add(key)

    def _note_key_removed(self, st, graph, key: tuple) -> None:
        """Drop a tuple from its ids' ref sets; an emptied set reclaims
        the spare row."""
        for side in ((key[0], key[1]), (key[3], key[4])):
            refs = st._assigned_refs.get(side)
            if refs is None:
                continue
            refs.discard(key)
            if not refs:
                self._reclaim_spare(st, graph, side)

    def _reclaim_spare(self, st, graph, side: tuple) -> None:
        """Rename an assigned id's row back to a fresh placeholder and
        return it to the pool."""
        t, old_id = side
        st._assigned_refs.pop(side, None)
        st._spare_seq += 1
        placeholder = f"{_SPARE_PREFIX}r{st._spare_seq}"
        if not self._rename_row(graph, t, old_id, placeholder):
            return
        st._spare_pool.setdefault(t, []).append(placeholder)
        if st is self:
            self.stats["spare_reclaims"] += 1

    def _ensure_ids_for(self, st, graph, rel: Relationship) -> bool:
        """Make every id a TOUCHed tuple names indexable, assigning spare
        rows to new ones; False (pool dry) forces a rebuild."""
        prog = graph.prog
        rt, rid = rel.resource.type, rel.resource.id
        d = self.schema.definitions.get(rt)
        if d is None or rel.relation not in d.relations:
            return True  # edgeless tuple: never spend a spare on it
        if rt in prog.object_index and rid not in prog.object_index[rt]:
            if not self._assign_spare(st, graph, rt, rid):
                return False
        stype, sid = rel.subject.type, rel.subject.id
        if (stype in prog.object_index and sid != WILDCARD
                and sid not in prog.object_index[stype]):
            if not self._assign_spare(st, graph, stype, sid):
                return False
        return True

    # -- delta application ----------------------------------------------------

    def _stale_closure(self, resource_type: str, relation: str) -> set:
        """(type, permission) pairs whose answers could depend on tuples
        of (resource_type, relation); memoized per schema."""
        key = (resource_type, relation)
        out = self._stale_closure_cache.get(key)
        if out is None:
            out = set(caveat_affected_pairs(self.schema, {key}))
            self._stale_closure_cache[key] = out
        return out

    def _caveat_decidability(self, rel: Relationship):
        """Mirror of the compiler's caveat resolution (_emit_tuple_edges):
        True = definite edges, False = no edges, None = MAYBE-plane edges,
        "unsupported" = no device lowering (wildcard / unknown caveat /
        evaluation error) — rebuild-only."""
        c = self.schema.caveats.get(rel.caveat.name)
        if c is None or rel.subject.id == WILDCARD:
            return "unsupported"
        try:
            return c.evaluate(rel.caveat.context())
        except Exception:
            return "unsupported"

    def _leo_insert(self, st, graph, rel: Relationship, key: tuple) -> None:
        """Mirror a definite tuple the graph just absorbed into the
        generation's Leopard closure."""
        if st._leopard is not None:
            st._leopard.apply_insert(key, self._edge_endpoints(graph.prog,
                                                               rel))

    def _leo_remove(self, st, graph, key: tuple) -> None:
        """Mirror a removal into the Leopard closure BEFORE a spare-row
        reclaim renames the ids away: the closure's rows are keyed by the
        compiled state index, which the rename re-purposes."""
        if st._leopard is not None:
            st._leopard.apply_remove(key, self._edge_endpoints(
                graph.prog, _rel_from_key(key)))

    def _remove_applied(self, st, graph, key: tuple) -> bool:
        """Take a removed or expired tuple out of the graph and the
        Leopard closure; False when only a rebuild can.  A caveated tuple
        may sit in the definite tables (context decided True) or in the
        MAYBE plane (undecidable): both placements are cleared."""
        if key in st._caveated_keys:
            if not graph.supports_cav_deltas:
                return False
            graph.remove_cav_key(key)
            st._caveated_keys.discard(key)
        graph.remove_key(key)
        self._leo_remove(st, graph, key)
        self._note_key_removed(st, graph, key)
        return True

    def _touch_caveated(self, st, graph, rel: Relationship,
                        key: tuple) -> bool:
        """Place a caveated TOUCH by its decidability; False when only a
        rebuild can (an unsupported caveat shape, the first undecidable
        caveat on a graph without planes, a full row)."""
        value = self._caveat_decidability(rel)
        if value == "unsupported" or not graph.supports_cav_deltas:
            return False
        # a re-touch may change the caveat's decidability (context edits):
        # clear any previous placement, then insert per the new value
        graph.remove_key(key)
        graph.remove_cav_key(key)
        st._caveated_keys.add(key)
        if value is True:
            ok = graph.add_rel(rel)
        elif value is None:
            ok = graph.add_cav_rel(rel)
        else:
            ok = True  # decided False: no edges at all
        if ok and st._leopard is not None:
            # a caveated tuple now lives on this relation: a closure bit
            # cannot represent CONDITIONAL, so its fragments retire for
            # the generation (the next build skips them as caveat-affected)
            st._leopard.retire_relation((rel.resource.type, rel.relation))
        return ok

    def _apply_batches(self, st, batches: list) -> tuple:
        """Apply drained delta batches and due expirations to one
        generation's host tables and Leopard closure (under self._lock;
        reference jax_endpoint.py:1865-2001): `st` is the live endpoint
        or a background candidate mid-replay.  Returns (stale pairs,
        applied revision): an update the tables cannot absorb adds its
        affected (type, permission) closure to the stale set and
        application goes on; the caller quarantines or rebuilds when the
        set is non-empty, and flushes."""
        graph = st._graph
        stale: set = set()
        applied_revision = st._graph_revision
        for batch in batches:
            applied_revision = max(applied_revision, batch.revision)
            for u in batch.updates:
                key = u.rel.key()
                rt, relation = u.rel.resource.type, u.rel.relation
                if u.op == UpdateOp.DELETE:
                    if u.rel.subject.id == WILDCARD:
                        # wildcard masks are baked into the program
                        stale |= self._stale_closure(rt, relation)
                        continue
                    self._set_expiry(st, key, None)
                    if not self._remove_applied(st, graph, key):
                        stale |= self._stale_closure(rt, relation)
                    continue
                self._set_expiry(st, key, u.rel.expires_at)
                if not self._ensure_ids_for(st, graph, u.rel):
                    stale |= self._stale_closure(rt, relation)
                    continue
                if u.rel.caveat is not None:
                    ok = self._touch_caveated(st, graph, u.rel, key)
                else:
                    if key in st._caveated_keys:
                        # a caveated tuple replaced by a definite one:
                        # undo its MAYBE-plane placement first
                        ok = graph.supports_cav_deltas
                        if ok:
                            graph.remove_cav_key(key)
                            st._caveated_keys.discard(key)
                            ok = graph.add_rel(u.rel)
                    else:
                        ok = graph.add_rel(u.rel)
                    if ok:
                        self._leo_insert(st, graph, u.rel, key)
                if not ok:
                    stale |= self._stale_closure(rt, relation)
                    continue
                self._note_key_applied(st, key)
        # expire lazily after the batches, on the store's clock (the one
        # reads filter with), so kernel and oracle agree at the instant
        now = self.store.now()
        while st._expiry_heap and st._expiry_heap[0][0] <= now:
            exp, key = heapq.heappop(st._expiry_heap)
            if st._expiry_meta.get(key) != exp:
                continue  # deleted or re-touched since
            del st._expiry_meta[key]
            if key[4] == WILDCARD or not self._remove_applied(st, graph,
                                                              key):
                stale |= self._stale_closure(key[0], key[2])
        if stale and st is self:
            self.stats["stale_pair_marks"] += len(stale)
        return stale, applied_revision

    # -- query encoding -----------------------------------------------------

    def _encode_subjects(self, graph, subjects: list) -> tuple:
        """Dedupe subjects into query columns; returns (q_idx array,
        col_of_subject dict, unknown set).  Subjects outside the compiled
        id universe share their type's phantom column; `unknown` is left
        only for subjects whose (type, relation) has no slot at all."""
        cols: dict = {}
        q: list[int] = []
        unknown: set = set()
        phantom_cols: dict = {}  # (type, relation) -> column
        for s in subjects:
            if s in cols or s in unknown:
                continue
            idx = graph.prog.subject_index(s.type, s.id, s.relation)
            if idx is None:
                pk = (s.type, s.relation)
                col = phantom_cols.get(pk)
                if col is not None:
                    cols[s] = col
                    continue
                pidx = graph.prog.subject_index(s.type, PHANTOM_ID, s.relation)
                if pidx is None:
                    unknown.add(s)
                    continue
                phantom_cols[pk] = cols[s] = len(q)
                q.append(pidx)
                continue
            cols[s] = len(q)
            q.append(idx)
        b = graph.batch_bucket(len(q))
        q_arr = np.full(b, graph.prog.dead_index, np.int32)
        q_arr[: len(q)] = q
        return q_arr, cols, unknown

    # -- checks --------------------------------------------------------------

    _TRISTATE = {0: Permissionship.NO_PERMISSION,
                 1: Permissionship.CONDITIONAL_PERMISSION,
                 2: Permissionship.HAS_PERMISSION}

    def _check_batch_capture(self, reqs: list) -> dict:
        """Phase 1 of a fused check batch: encode under the lock, then
        dispatch the kernel outside it on the immutable table snapshot."""
        with self._lock:
            graph = self._current_graph()
            rev = self._graph_revision
            q_arr, cols, unknown = self._encode_subjects(
                graph, [r.subject for r in reqs])
            gather_idx: list[int] = []
            gather_col: list[int] = []
            kernel_rows: list[int] = []
            results: list[Optional[tuple]] = [None] * len(reqs)
            oracle_rows: list[int] = []
            tri = graph.tri_state_capable
            # Leopard consult: rows whose (type, permission) has a live
            # closure fragment answer with one bit gather of its plane
            # instead of the sweep; views are immutable snapshots, so the
            # gather runs outside the lock like the kernel dispatch.  The
            # fragment is looked up once per pair and the closure columns
            # once per fragment (vectorized), so a batch on pairs the
            # index does not hold pays one dict probe per row.
            leo = self._leopard
            leo_frag: dict = {}   # pair -> (fragment, slot offset) | None
            leo_cand: dict = {}   # pair -> ([i], [query col], [state idx])
            stale = self._stale_pairs
            for i, r in enumerate(reqs):
                if stale and (r.resource.type, r.permission) in stale:
                    # quarantined pair: this generation could not absorb
                    # a delta affecting it (a background rebuild is on
                    # its way); the host oracle reads the live store
                    oracle_rows.append(i)
                    self.stats["stale_routed"] += 1
                    continue
                if (not tri and (r.resource.type, r.permission)
                        in self._caveat_affected):
                    # caveat residual with no device lowering: host
                    # tri-state evaluation
                    oracle_rows.append(i)
                    self.stats["oracle_residual_checks"] += 1
                    continue
                if r.subject in unknown:
                    oracle_rows.append(i)
                    continue
                state_idx = graph.prog.state_index(
                    r.resource.type, r.permission, r.resource.id)
                if state_idx is None:
                    d = self.schema.definitions.get(r.resource.type)
                    if d is None or not d.has_relation_or_permission(
                            r.permission):
                        oracle_rows.append(i)   # the oracle raises
                    else:
                        # unknown object: no tuples, the kernel answer is 0
                        results[i] = (0, rev)
                    continue
                if leo is not None:
                    pair = (r.resource.type, r.permission)
                    hit = leo_frag.get(pair, False)
                    if hit is False:
                        hit = leo_frag[pair] = leo.check_fragment(*pair)
                    if hit is not None:
                        cand = leo_cand.setdefault(pair, ([], [], []))
                        cand[0].append(i)
                        cand[1].append(cols[r.subject])
                        cand[2].append(state_idx)
                        continue
                gather_idx.append(state_idx)
                gather_col.append(cols[r.subject])
                kernel_rows.append(i)
            leo_rows: list = []   # (view, [i], rows, cols) per fragment
            for pair, (idx, qcols, sidx) in leo_cand.items():
                frag, off = leo_frag[pair]
                lcol = frag.col_of[q_arr[np.asarray(qcols, np.int64)]]
                ok = lcol >= 0
                for j in np.nonzero(~ok)[0].tolist():
                    # the subject has no closure column: the sweep answers
                    gather_idx.append(sidx[j])
                    gather_col.append(qcols[j])
                    kernel_rows.append(idx[j])
                if ok.any():
                    leo_rows.append((
                        frag.view, np.asarray(idx)[ok].tolist(),
                        (np.asarray(sidx, np.int64)[ok] - off).astype(
                            np.int32), lcol[ok].astype(np.int32)))
                    self.stats["leopard_checks"] += int(ok.sum())
            if kernel_rows:
                snap = graph.snapshot()
                self.stats["kernel_calls"] += 1
        ctx = {"reqs": reqs, "results": results, "kernel_rows": kernel_rows,
               "oracle_rows": oracle_rows, "rev": rev}
        if leo_rows:
            ctx["leopard"] = [(rows, self._start_readback(vals))
                              for rows, vals in
                              self._leo_check_launch(leo_rows)]
        if kernel_rows:
            dev, tel, _ = graph.run_checks3_device(q_arr, gather_idx,
                                                   gather_col, snap=snap)
            graph.last_trace = tel
            ctx["out"] = self._start_readback(dev)
        return ctx

    def _start_readback(self, dev: torch.Tensor) -> _Readback:
        """Start a result's copy to the host (`_Readback`), counting the
        side-stream ones."""
        rb = _Readback(dev)
        if rb.event is not None:
            with self._readback_lock:
                self.stats["readbacks"] += 1
                self.stats["readback_bytes"] += rb.host.numel() * \
                    rb.host.element_size()
        return rb

    def _wait_readback(self, rb: _Readback) -> np.ndarray:
        """The host copy of a started readback, as numpy."""
        t0 = time.perf_counter()
        host = rb.wait()
        if rb.event is not None:
            with self._readback_lock:
                self.stats["readback_wait_s"] += time.perf_counter() - t0
        return host.numpy()

    def _leo_check_launch(self, leo_rows: list) -> list:
        """Launch one `check_gather` per closure plane (per plane block
        under a mesh) over its (row, col) pairs —
        `((plane[row, col // 32] >> col % 32) & 1) * 2` is exactly
        the reference's `_leo_check_fill` (fragment closures never carry
        CONDITIONAL).  Returns [(request rows, device values)] for the
        finish to read back."""
        return [(idx, plane_check(view, rows, cls))
                for (view, idx, rows, cls) in leo_rows]

    def _check_batch_finish(self, ctx: dict) -> list:
        """Phase 2: wait for the kernel and closure-plane results' copies,
        evaluate oracle rows on the live store, assemble CheckResults.
        The endpoint lock is not taken: the answers are those of the
        snapshot the capture took."""
        results = ctx["results"]
        for rows, rb in ctx.get("leopard", ()):
            for i, v in zip(rows, self._wait_readback(rb).tolist()):
                results[i] = (v, ctx["rev"])
        if "out" in ctx:
            out = self._wait_readback(ctx["out"])
            for j, row in enumerate(ctx["kernel_rows"]):
                results[row] = (int(out[j]), ctx["rev"])
        for i in ctx["oracle_rows"]:
            r = ctx["reqs"][i]
            results[i] = (self._oracle.check3(r.resource, r.permission,
                                              r.subject),
                          self.store.revision)
        oracle_set = set(ctx["oracle_rows"])
        return [CheckResult(permissionship=self._TRISTATE[v], checked_at=at,
                            source="oracle" if i in oracle_set else "kernel")
                for i, (v, at) in enumerate(results)]

    def _check_batch_sync(self, reqs: list) -> list:
        return self._check_batch_finish(self._check_batch_capture(reqs))

    async def _off_loop(self, fn, *args):
        """Device work runs in the executor so the event loop stays free."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, lambda: fn(*args))

    async def check_permission(self, req: CheckRequest) -> CheckResult:
        return (await self._off_loop(self._check_batch_sync, [req]))[0]

    async def check_bulk_permissions(self, reqs: list) -> list:
        if not reqs:
            return []
        return await self._off_loop(self._check_batch_sync, reqs)

    async def check_bulk_permissions_start(self, reqs: list) -> dict:
        """Two-phase fused check, phase 1: encode, sweep and start the
        readback (reference jax_endpoint.py:2609).  The dispatcher pairs
        it with check_bulk_permissions_finish to pipeline batches."""
        return await self._off_loop(self._check_batch_capture, reqs)

    async def check_bulk_permissions_finish(self, ctx: dict) -> list:
        """Two-phase fused check, phase 2: readback wait, oracle rows,
        result assembly."""
        return await self._off_loop(self._check_batch_finish, ctx)

    # -- lookups -------------------------------------------------------------

    def _lookup_batch_capture(self, resource_type: str, permission: str,
                              subjects: list) -> dict:
        """Phase 1 of a fused batch lookup: capture a consistent (snapshot,
        id view) pair under the lock and dispatch the kernel outside it."""
        self.schema.definition(resource_type)  # raises like the oracle
        ctx = {"rt": resource_type, "perm": permission, "subjects": subjects}
        with self._lock:
            graph = self._current_graph()
            if (resource_type, permission) in self._stale_pairs:
                # quarantined pair (a background rebuild is on its way):
                # the host oracle answers exactly until the swap
                self.stats["stale_routed"] += 1
                ctx["all_oracle"] = True
                return ctx
            rng = graph.prog.slot_range(resource_type, permission)
            # a plane-capable kernel returns the DEFINITE plane, which
            # skips CONDITIONAL results as LookupResources must; without
            # a device lowering the oracle does the same
            if (((resource_type, permission) in self._caveat_affected
                 and not graph.tri_state_capable) or rng is None):
                ctx["all_oracle"] = True
                return ctx
            q_arr, cols, unknown = self._encode_subjects(graph, subjects)
            snap = graph.snapshot()
            ids, mask = _object_ids_np(graph, resource_type)
            ph = graph.prog.object_index[resource_type].get(PHANTOM_ID)
            # Leopard consult: a live fragment with a closure column for
            # EVERY known subject answers the whole batch from its plane
            # (unknown subjects go to the oracle at extraction either way)
            leo = None
            frag = (self._leopard.lookup_frag(resource_type, permission)
                    if self._leopard is not None else None)
            if frag is not None:
                lcols: Optional[dict] = {}
                for s, col in cols.items():
                    lcol = int(frag.col_of[int(q_arr[col])])
                    if lcol < 0:
                        lcols = None
                        break
                    lcols[col] = lcol
                if lcols is not None:
                    leo = (frag.view, lcols)
                    self.stats["leopard_lookups"] += len(lcols)
            if leo is None:
                self.stats["kernel_calls"] += 1
        ctx.update(cols=cols, unknown=unknown, ids=ids, mask=mask, ph=ph)
        if leo is not None:
            # the batch's distinct closure word columns, one launch (one
            # per plane block under a mesh)
            view, lcols = leo
            words = sorted({lcol // 32 for lcol in lcols.values()})
            rb = (self._start_readback(plane_word_cols(view, words))
                  if words else None)
            ctx["leopard"] = (rb, {w: k for k, w in enumerate(words)},
                              lcols)
            return ctx
        dev, tel, _ = graph.run_lookup_packed_T_device(rng[0], rng[1], q_arr,
                                                       snap=snap)
        graph.last_trace = tel
        ctx["dev"] = self._start_readback(dev)
        return ctx

    def _lookup_batch_extract(self, ctx: dict) -> list:
        """Phase 2: wait for the [W, L] words' copy (or the closure
        plane's word columns') and materialize per-subject id lists
        (columns shared by several subjects are decoded once), from the
        id view the capture took."""
        rt, perm = ctx["rt"], ctx["perm"]
        if ctx.get("all_oracle"):
            return [AnnotatedIds(self._oracle.lookup_resources(rt, perm, s),
                                 source="oracle")
                    for s in ctx["subjects"]]
        if "leopard" in ctx:
            rb, word_row, lcols = ctx["leopard"]
            word_cols = (self._wait_readback(rb).view(np.uint32)
                         if rb is not None else None)   # [K, plane rows]

            def col_indices(col):
                lcol = lcols[col]
                return _word_col_indices(word_cols[word_row[lcol // 32]],
                                         lcol % 32)
        else:
            packed_T = self._wait_readback(ctx["dev"]).view(np.uint32)  # [W, L]

            def col_indices(col):
                return _word_col_indices(packed_T[col // 32], col % 32)
        ids, mask, ph = ctx["ids"], ctx["mask"], ctx["ph"]
        cols, unknown = ctx["cols"], ctx["unknown"]
        per_col: dict = {}
        out = []
        for s in ctx["subjects"]:
            if s in unknown:
                out.append(AnnotatedIds(
                    self._oracle.lookup_resources(rt, perm, s),
                    source="oracle"))
                continue
            col = cols[s]
            lst = per_col.get(col)
            if lst is None:
                got, bad_n = _ids_for(ids, col_indices(col), ph, mask)
                if bad_n:
                    # an internal placeholder reached the result: never
                    # emit it; answer this column from the oracle
                    with self._lock:
                        self.stats["placeholder_suppressed"] += bad_n
                    _log.warning("suppressed %d placeholder ids in a %s#%s "
                                 "lookup", bad_n, rt, perm)
                    lst = AnnotatedIds(
                        self._oracle.lookup_resources(rt, perm, s),
                        source="oracle")
                else:
                    lst = AnnotatedIds(got, source="kernel")
                per_col[col] = lst
            out.append(lst)
        return out

    def _lookup_batch_sync(self, resource_type: str, permission: str,
                           subjects: list) -> list:
        return self._lookup_batch_extract(
            self._lookup_batch_capture(resource_type, permission, subjects))

    async def lookup_resources(self, resource_type: str, permission: str,
                               subject) -> list:
        return (await self._off_loop(self._lookup_batch_sync, resource_type,
                                     permission, [subject]))[0]

    async def lookup_resources_stream(self, resource_type: str,
                                      permission: str, subject):
        """Chunked id stream: the batch runs off the loop and the ids
        yield in chunks of 4,096, the loop getting a turn between chunks
        (reference jax_endpoint.py:2783-2796)."""
        ids = (await self._off_loop(self._lookup_batch_sync, resource_type,
                                    permission, [subject]))[0]
        for i in range(0, len(ids), _STREAM_CHUNK):
            for rid in ids[i: i + _STREAM_CHUNK]:
                yield rid
            await asyncio.sleep(0)

    async def lookup_resources_batch(self, resource_type: str, permission: str,
                                     subjects: list) -> list:
        if not subjects:
            return []
        return await self._off_loop(self._lookup_batch_sync, resource_type,
                                    permission, subjects)

    async def lookup_resources_batch_start(self, resource_type: str,
                                           permission: str,
                                           subjects: list) -> dict:
        """Two-phase fused lookup, phase 1: encode, sweep and start the
        readback (reference jax_endpoint.py:3075).  A batch finishes on
        the snapshot and id view it captured, whatever flush or rebuild
        runs before its finish."""
        return await self._off_loop(self._lookup_batch_capture,
                                    resource_type, permission, subjects)

    async def lookup_resources_batch_finish(self, ctx: dict) -> list:
        """Two-phase fused lookup, phase 2: readback wait and
        extraction."""
        return await self._off_loop(self._lookup_batch_extract, ctx)

    # -- store verbs ---------------------------------------------------------

    async def read_relationships(self, flt: RelationshipFilter) -> list:
        return self.store.read(flt)

    async def write_relationships(self, updates: Iterable[RelationshipUpdate],
                                  preconditions: Iterable[Precondition] = ()
                                  ) -> int:
        ups = self._validate_updates(updates)
        return await self._off_loop(self.store.write, ups,
                                    list(preconditions))

    async def delete_relationships(self, flt: RelationshipFilter,
                                   preconditions: Iterable[Precondition] = ()
                                   ) -> int:
        rev, _ = await self._off_loop(self.store.delete_by_filter, flt,
                                      list(preconditions))
        return rev

    def watch(self, object_types: Optional[Iterable[str]] = None) -> Watcher:
        return self.store.subscribe(object_types)

    # -- decision explain ----------------------------------------------------

    def explain_check(self, resource: ObjectRef, permission: str,
                      subject: SubjectRef):
        """Per-check evaluation witness (authz/explain.py `Witness`;
        reference jax_endpoint.py:3121-3172).

        One targeted re-check through the kernel path pins the decision;
        the witness path comes from the host replay of the fixpoint
        iterate over the compiled program (allowed rows: which relation
        hop / iteration admitted the subject).  Deltas applied since the
        last build live in the device tables, not the program's edge
        arrays, so a replay that disagrees with the kernel — and every
        denial or conditional — is explained by the (always current) host
        oracle instead."""
        from ..authz.explain import device_witness, oracle_witness

        req = CheckRequest(resource=resource, permission=permission,
                           subject=subject)
        result = self._check_batch_sync([req])[0]
        decision = {
            Permissionship.HAS_PERMISSION: "allowed",
            Permissionship.CONDITIONAL_PERMISSION: "conditional",
            Permissionship.NO_PERMISSION: "denied",
        }[result.permissionship]
        with self._lock:
            self.stats["explain_checks"] += 1
        prog = sidx = tidx = None
        if decision == "allowed":
            with self._lock:
                graph = self._graph
                if graph is not None:
                    prog = graph.prog
                    sidx = prog.subject_index(subject.type, subject.id,
                                              subject.relation)
                    tidx = prog.state_index(resource.type, permission,
                                            resource.id)
        if prog is not None and sidx is not None and tidx is not None:
            # the program's arrays are immutable after a build: the
            # replay runs outside the lock
            w = device_witness(prog, sidx, tidx)
            if w.decision == decision:
                w.backend = "torch"
                return w
        w = oracle_witness(self.schema, self.store, resource, permission,
                           subject)
        w.backend = "torch"
        if w.decision != decision:
            w.note = (f"kernel decision {decision!r} diverges from oracle "
                      f"witness {w.decision!r}")
            w.decision = decision
        return w
