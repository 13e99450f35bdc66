"""Schema + tuple-snapshot -> device reachability program.

Lowers Zanzibar userset-rewrite evaluation onto an iterative boolean-SpMV
fixpoint (the BASELINE.json north star): the authorization state is one
boolean vector over `(slot, object)` pairs, relationship tuples become edges
whose one-step closure is a gather + segment-sum, and permission expressions
(union / intersection / exclusion / arrow) become an elementwise program over
slot ranges executed each iteration.  This replaces the reference's recursive
graph walk inside embedded SpiceDB (the dominant cost behind
CheckBulkPermissions / LookupResources — reference pkg/authz/check.go:48,
lookups.go:74-135).

State layout
------------
Every definition type T contributes:
  - a `self` slot (one-hot marks "this object IS the query subject"),
  - one slot per relation,
  - one slot per permission,
  - one slot per arrow occurrence in its permission expressions (aux).
Each slot spans T's object-id range; ranges are concatenated into one state
vector of size `state_size` (+1 trailing dead index used for edge padding).

Edges (all boolean-OR semantics, presorted by destination):
  - direct tuple  o#rel@u       : self(type(u))[u]        -> rel(type(o))[o]
  - userset tuple o#rel@s#r2    : slot(type(s), r2)[s]    -> rel(type(o))[o]
  - arrow tuple   o#left@s (for `left->target` in a permission of type(o)):
                                  slot(type(s), target)[s] -> aux[o]
Wildcard tuples (`o#rel@T:*`) are not edges: each (rel, subject-type) pair
yields a dense mask applied when any self(T) bit is live in the query column.

Per iteration: y = OR-SpMV(x); wildcard masks OR'd in; x = max(y, x0); then
permission slots are recomputed from x by the expression program.  All values
are monotone in x, so recomputation converges to the least fixpoint; the
iteration count bounds effective recursion depth exactly like SpiceDB's
dispatch depth cap (reference pkg/spicedb/spicedb.go:34).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..spicedb import schema as sch
from ..spicedb.types import SchemaError, WILDCARD

SELF_SLOT = "__self__"


# -- expression program -----------------------------------------------------

@dataclass(frozen=True)
class PRead:
    """Read a slot range (a relation/permission/aux vector of this type)."""
    offset: int
    length: int


@dataclass(frozen=True)
class PZero:
    length: int


@dataclass(frozen=True)
class PUnion:
    children: tuple


@dataclass(frozen=True)
class PIntersect:
    children: tuple


@dataclass(frozen=True)
class PExclude:
    base: object
    subtract: object


@dataclass(frozen=True)
class PermOp:
    """Write `expr` into [offset, offset+length) each iteration."""
    offset: int
    length: int
    expr: object


@dataclass(frozen=True)
class WildcardTerm:
    """OR `mask` into y wherever any self(subject-type) bit is live."""
    self_offset: int
    self_length: int
    mask_indices: tuple  # state indices activated by this wildcard


@dataclass
class GraphProgram:
    state_size: int                      # includes trailing dead index
    edge_src: np.ndarray                 # int32 [E] (sorted by dst)
    edge_dst: np.ndarray                 # int32 [E]
    # MAYBE-plane edges from caveated tuples whose stored context cannot
    # decide the caveat (tri-state device path; tuples whose context
    # decides True are ordinary definite edges, False-deciding tuples are
    # dropped entirely — matching Evaluator._caveat_value)
    cav_src: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    cav_dst: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    # False when a caveat shape has no device lowering (caveated wildcard,
    # unknown caveat name, non-bool caveat body): queries on affected
    # pairs must fall back to the host oracle
    caveats_device_ok: bool = True
    perm_ops: list = field(default_factory=list)       # topo-ordered PermOp
    wildcard_terms: list = field(default_factory=list)
    # (resource_type, left_relation) -> [(perm, occurrence, target, aux_slot)]
    # — the arrow edges each tuple on that relation contributes; consumed by
    # the endpoint's incremental delta path
    arrow_specs: dict = field(default_factory=dict)
    num_objects: dict = field(default_factory=dict)    # type -> count
    object_ids: dict = field(default_factory=dict)     # type -> list[str]
    object_index: dict = field(default_factory=dict)   # type -> {id: local}
    slot_offsets: dict = field(default_factory=dict)   # (type, slot) -> offset
    suggested_iterations: int = 8

    @property
    def dead_index(self) -> int:
        return self.state_size - 1

    # -- host-side lookups --------------------------------------------------

    def state_index(self, type_name: str, slot: str, object_id: str) -> Optional[int]:
        off = self.slot_offsets.get((type_name, slot))
        if off is None:
            return None
        local = self.object_index.get(type_name, {}).get(object_id)
        if local is None:
            return None
        return off + local

    def slot_range(self, type_name: str, slot: str) -> Optional[tuple]:
        off = self.slot_offsets.get((type_name, slot))
        if off is None:
            return None
        return off, self.num_objects[type_name]

    def subject_index(self, subject_type: str, subject_id: str,
                      subject_relation: str = "") -> Optional[int]:
        """State index whose one-hot encodes this query subject."""
        slot = subject_relation if subject_relation else SELF_SLOT
        return self.state_index(subject_type, slot, subject_id)


def _assign_slots(prog: GraphProgram, schema: sch.Schema) -> tuple:
    """Slot layout + arrow bookkeeping shared by both compilers; returns
    (arrow_slots, arrows_by_left)."""
    offset = 0
    arrow_slots: dict[tuple, str] = {}  # (type, perm, occurrence) -> slot name

    def add_slot(t: str, slot: str) -> None:
        nonlocal offset
        prog.slot_offsets[(t, slot)] = offset
        offset += prog.num_objects[t]

    for t, d in schema.definitions.items():
        add_slot(t, SELF_SLOT)
        for r in d.relations:
            add_slot(t, r)
        for p in d.permissions:
            add_slot(t, p)
        # aux slots for arrows, one per occurrence
        for p, expr in d.permissions.items():
            for k, arrow in enumerate(_find_arrows(expr)):
                slot = f"__arrow__:{p}:{k}"
                arrow_slots[(t, p, k)] = slot
                add_slot(t, slot)
    prog.state_size = offset + 1  # trailing dead index

    # arrow tuple-edge construction needs, per (type, left-relation), the
    # list of (perm, occurrence, target) arrows reading it
    arrows_by_left: dict[tuple, list] = {}
    for t, d in schema.definitions.items():
        for p, expr in d.permissions.items():
            for k, arrow in enumerate(_find_arrows(expr)):
                arrows_by_left.setdefault((t, arrow.left), []).append(
                    (p, k, arrow.target))
                prog.arrow_specs.setdefault((t, arrow.left), []).append(
                    (p, k, arrow.target, arrow_slots[(t, p, k)]))
    return arrow_slots, arrows_by_left


def _emit_tuple_edges(prog: GraphProgram, schema: sch.Schema,
                      arrow_slots: dict, arrows_by_left: dict, rel,
                      srcs: list, dsts: list, wildcard_map: dict,
                      cav_srcs: Optional[list] = None,
                      cav_dsts: Optional[list] = None,
                      cav_flags: Optional[dict] = None) -> None:
    """Per-tuple edge emission (object path; also used for overlay tuples
    on top of a columnar base).

    Caveated tuples (SURVEY.md hard part (c)): a stored context that
    DECIDES the caveat resolves at compile time — True emits ordinary
    definite edges, False emits nothing.  Undecidable tuples emit
    MAYBE-plane edges (`cav_srcs`/`cav_dsts`) consumed by the tri-state
    ELL kernel; shapes with no device lowering (wildcards, unknown
    caveats) clear `cav_flags['ok']` so affected queries fall back to the
    host oracle (the pre-round-4 behavior for ALL caveats)."""
    cav = getattr(rel, "caveat", None)
    if cav is not None:
        c = schema.caveats.get(cav.name)
        try:
            value = c.evaluate(cav.context()) if c is not None else None
        except Exception:
            value = None
            c = None  # evaluation error: no device story for this caveat
        if value is False:
            return
        if value is None:
            if cav_srcs is None or c is None or rel.subject.id == WILDCARD:
                if cav_flags is not None:
                    cav_flags["ok"] = False
                return
            # MAYBE: route every edge this tuple contributes to the
            # caveat plane
            srcs, dsts = cav_srcs, cav_dsts
        # value is True: definite — fall through unchanged
    rt = rel.resource.type
    if rt not in schema.definitions:
        return
    d = schema.definitions[rt]
    if rel.relation not in d.relations:
        return  # tuples on undefined relations are unreachable
    dst = prog.state_index(rt, rel.relation, rel.resource.id)
    st, sid, srel = rel.subject.type, rel.subject.id, rel.subject.relation
    if sid == WILDCARD:
        if dst is not None:
            wildcard_map.setdefault(st, []).append(dst)
    else:
        src = (prog.state_index(st, srel, sid) if srel
               else prog.state_index(st, SELF_SLOT, sid))
        if src is not None and dst is not None:
            srcs.append(src)
            dsts.append(dst)
    # arrow edges ride the same tuples (direct subjects only)
    for (p, k, target) in arrows_by_left.get((rt, rel.relation), ()):
        if sid == WILDCARD or srel:
            continue
        target_def = schema.definitions.get(st)
        if target_def is None or not target_def.has_relation_or_permission(target):
            continue
        src = prog.state_index(st, target, sid)
        aux = prog.state_index(rt, arrow_slots[(rt, p, k)], rel.resource.id)
        if src is not None and aux is not None:
            srcs.append(src)
            dsts.append(aux)


def _finalize_program(prog: GraphProgram, schema: sch.Schema,
                      src_arr: np.ndarray, dst_arr: np.ndarray,
                      wildcard_map: dict, arrow_slots: dict,
                      cav_srcs: Optional[list] = None,
                      cav_dsts: Optional[list] = None,
                      caveats_device_ok: bool = True) -> GraphProgram:
    """Sort edges, materialize wildcard terms and the permission program."""
    if cav_srcs:
        prog.cav_src = np.asarray(cav_srcs, np.int32)
        prog.cav_dst = np.asarray(cav_dsts, np.int32)
    prog.caveats_device_ok = caveats_device_ok
    if len(src_arr):
        order = np.argsort(dst_arr, kind="stable")
        prog.edge_src = np.ascontiguousarray(src_arr[order])
        prog.edge_dst = np.ascontiguousarray(dst_arr[order])

    for st, indices in wildcard_map.items():
        rng = prog.slot_range(st, SELF_SLOT)
        if rng is None:
            continue
        prog.wildcard_terms.append(WildcardTerm(
            self_offset=rng[0], self_length=rng[1],
            mask_indices=tuple(sorted(set(int(i) for i in indices)))))

    # permission program (topo order within each type)
    for t, d in schema.definitions.items():
        order = _topo_permissions(d)
        for p in order:
            expr = d.permissions[p]
            off, n = prog.slot_range(t, p)
            compiled = _compile_expr(prog, schema, t, p, expr, arrow_slots,
                                     counter=[0])
            prog.perm_ops.append(PermOp(offset=off, length=n, expr=compiled))

    prog.suggested_iterations = max(2, schema.max_rewrite_depth() + 2)
    return prog


def compile_graph(schema: sch.Schema, tuples: list,
                  extra_subject_ids: Optional[dict] = None) -> GraphProgram:
    """Build a GraphProgram from a schema and a tuple snapshot.

    `extra_subject_ids` ({type: iterable of ids}) registers objects that
    appear in queries but not (yet) in tuples, so checks against them index
    correctly instead of falling to the dead slot.
    """
    # -- collect object universes ------------------------------------------
    ids_by_type: dict[str, set] = {t: set() for t in schema.definitions}
    for rel in tuples:
        if rel.resource.type in ids_by_type:
            ids_by_type[rel.resource.type].add(rel.resource.id)
        if rel.subject.type in ids_by_type and rel.subject.id != WILDCARD:
            ids_by_type[rel.subject.type].add(rel.subject.id)
    if extra_subject_ids:
        for t, ids in extra_subject_ids.items():
            if t in ids_by_type:
                ids_by_type[t].update(ids)

    prog = GraphProgram(state_size=0, edge_src=np.zeros(0, np.int32),
                        edge_dst=np.zeros(0, np.int32))
    for t, ids in ids_by_type.items():
        ordered = sorted(ids)
        prog.object_ids[t] = ordered
        prog.object_index[t] = {oid: i for i, oid in enumerate(ordered)}
        prog.num_objects[t] = len(ordered)

    arrow_slots, arrows_by_left = _assign_slots(prog, schema)

    srcs: list[int] = []
    dsts: list[int] = []
    cav_srcs: list[int] = []
    cav_dsts: list[int] = []
    cav_flags = {"ok": True}
    wildcard_map: dict[str, list] = {}  # subject type -> [state indices]
    for rel in tuples:
        _emit_tuple_edges(prog, schema, arrow_slots, arrows_by_left, rel,
                          srcs, dsts, wildcard_map,
                          cav_srcs, cav_dsts, cav_flags)

    return _finalize_program(prog, schema,
                             np.asarray(srcs, np.int32),
                             np.asarray(dsts, np.int32),
                             wildcard_map, arrow_slots,
                             cav_srcs, cav_dsts, cav_flags["ok"])


def compile_graph_columnar(schema: sch.Schema, snap, rows: np.ndarray,
                           overlay: list = (),
                           extra_subject_ids: Optional[dict] = None
                           ) -> GraphProgram:
    """Vectorized compile from a columnar snapshot (spicedb/columnar.py).

    Produces a GraphProgram identical (up to intra-destination edge order)
    to `compile_graph` over the equivalent materialized tuples: the same
    object universes/slot layout, the same edge multiset, wildcard terms,
    and permission program.  `rows` selects the live base rows; `overlay`
    is the (small) list of post-bootstrap Relationship objects, emitted via
    the per-tuple path on top.
    """
    pool = snap.pool
    n_pool = len(pool)
    rtype = snap.rtype[rows]
    rid = snap.rid[rows]
    rel_c = snap.rel[rows]
    stype = snap.stype[rows]
    sid = snap.sid[rows]
    srel = snap.srel[rows]
    wc_ord = snap.ordinal(WILDCARD)

    # -- universes (vectorized per type) ------------------------------------
    prog = GraphProgram(state_size=0, edge_src=np.zeros(0, np.int32),
                        edge_dst=np.zeros(0, np.int32))
    # ord -> local index, per type (pool-backed ids; extras live in dicts)
    local_of_ord: dict[str, np.ndarray] = {}
    for t in schema.definitions:
        t_ord = snap.ordinal(t)
        if t_ord >= 0:
            res = rid[rtype == t_ord]
            sub = sid[(stype == t_ord) & (sid != wc_ord)]
            ords = np.unique(np.concatenate([res, sub])) if (len(res) or len(sub)) \
                else np.zeros(0, np.int32)
        else:
            ords = np.zeros(0, np.int32)
        id_strings = [pool[o] for o in ords]
        extras: set = set()
        if extra_subject_ids and t in extra_subject_ids:
            extras.update(extra_subject_ids[t])
        for r in overlay:
            if r.resource.type == t:
                extras.add(r.resource.id)
            if r.subject.type == t and r.subject.id != WILDCARD:
                extras.add(r.subject.id)
        extras.difference_update(id_strings)
        # numpy string sort for the (large) pool-backed id set; the (few)
        # extras are merged through a second vectorized sort
        arr = np.asarray(id_strings, dtype=str) if id_strings else \
            np.zeros(0, dtype="U1")
        order = np.argsort(arr, kind="stable")
        lo = np.full(n_pool, -1, np.int32)
        if extras:
            ex = np.asarray(sorted(extras), dtype=str)
            merged = np.concatenate([arr[order], ex]) if len(arr) else ex
            m_order = np.argsort(merged, kind="stable")
            ordered = merged[m_order].tolist()
            inv = np.empty(len(m_order), np.int32)
            inv[m_order] = np.arange(len(m_order), dtype=np.int32)
            if len(ords):
                lo[ords[order]] = inv[: len(arr)]
        else:
            ordered = arr[order].tolist()
            if len(ords):
                lo[ords[order]] = np.arange(len(order), dtype=np.int32)
        prog.object_ids[t] = ordered
        prog.object_index[t] = {oid: i for i, oid in enumerate(ordered)}
        prog.num_objects[t] = len(ordered)
        local_of_ord[t] = lo

    arrow_slots, arrows_by_left = _assign_slots(prog, schema)

    # -- edges (grouped by (rtype, rel, stype, srel), vectorized per group) --
    src_parts: list[np.ndarray] = []
    dst_parts: list[np.ndarray] = []
    wildcard_map: dict[str, list] = {}

    wc_rows = np.nonzero(sid == wc_ord)[0] if wc_ord >= 0 else ()
    for i in wc_rows:
        t = pool[rtype[i]]
        d = schema.definitions.get(t)
        if d is None or pool[rel_c[i]] not in d.relations:
            continue
        off = prog.slot_offsets.get((t, pool[rel_c[i]]))
        loc = local_of_ord[t][rid[i]] if t in local_of_ord else -1
        if off is not None and loc >= 0:
            wildcard_map.setdefault(pool[stype[i]], []).append(int(off + loc))

    direct = np.nonzero(sid != wc_ord)[0] if wc_ord >= 0 else \
        np.arange(len(rows))
    if len(direct):
        g_rt, g_rl = rtype[direct], rel_c[direct]
        g_st, g_sr = stype[direct], srel[direct]
        order = np.lexsort((g_sr, g_st, g_rl, g_rt))
        srt, srl = g_rt[order], g_rl[order]
        sst, ssr = g_st[order], g_sr[order]
        change = np.nonzero((np.diff(srt) != 0) | (np.diff(srl) != 0)
                            | (np.diff(sst) != 0) | (np.diff(ssr) != 0))[0] + 1
        bounds = np.concatenate([[0], change, [len(order)]])
        for gi in range(len(bounds) - 1):
            lo_b, hi_b = int(bounds[gi]), int(bounds[gi + 1])
            if lo_b == hi_b:
                continue
            t = pool[srt[lo_b]]
            relation = pool[srl[lo_b]]
            st = pool[sst[lo_b]]
            sr = pool[ssr[lo_b]]
            d = schema.definitions.get(t)
            if d is None or relation not in d.relations:
                continue
            rows_g = direct[order[lo_b:hi_b]]
            dst_off = prog.slot_offsets[(t, relation)]
            dst_loc = local_of_ord[t][rid[rows_g]]
            dst_state = (dst_off + dst_loc).astype(np.int32)
            # direct/userset edge
            src_slot = prog.slot_offsets.get((st, sr if sr else SELF_SLOT))
            if src_slot is not None and st in local_of_ord:
                src_loc = local_of_ord[st][sid[rows_g]]
                ok = (src_loc >= 0) & (dst_loc >= 0)
                src_parts.append((src_slot + src_loc[ok]).astype(np.int32))
                dst_parts.append(dst_state[ok])
            # arrow edges (direct subjects only)
            if not sr:
                for (p, k, target) in arrows_by_left.get((t, relation), ()):
                    target_def = schema.definitions.get(st)
                    if (target_def is None
                            or not target_def.has_relation_or_permission(target)):
                        continue
                    a_src_off = prog.slot_offsets.get((st, target))
                    a_dst_off = prog.slot_offsets.get(
                        (t, arrow_slots[(t, p, k)]))
                    if a_src_off is None or a_dst_off is None:
                        continue
                    src_loc = local_of_ord[st][sid[rows_g]]
                    ok = (src_loc >= 0) & (dst_loc >= 0)
                    src_parts.append((a_src_off + src_loc[ok]).astype(np.int32))
                    dst_parts.append((a_dst_off + dst_loc[ok]).astype(np.int32))

    # overlay tuples via the per-tuple path (the columnar base layer is
    # caveat-free by construction — store.py bulk_load_text — so caveated
    # tuples only ever arrive here)
    srcs_o: list[int] = []
    dsts_o: list[int] = []
    cav_srcs: list[int] = []
    cav_dsts: list[int] = []
    cav_flags = {"ok": True}
    for r in overlay:
        _emit_tuple_edges(prog, schema, arrow_slots, arrows_by_left, r,
                          srcs_o, dsts_o, wildcard_map,
                          cav_srcs, cav_dsts, cav_flags)
    if srcs_o:
        src_parts.append(np.asarray(srcs_o, np.int32))
        dst_parts.append(np.asarray(dsts_o, np.int32))

    src_arr = np.concatenate(src_parts) if src_parts else np.zeros(0, np.int32)
    dst_arr = np.concatenate(dst_parts) if dst_parts else np.zeros(0, np.int32)
    return _finalize_program(prog, schema, src_arr, dst_arr,
                             wildcard_map, arrow_slots,
                             cav_srcs, cav_dsts, cav_flags["ok"])



def relation_footprint(schema: sch.Schema, resource_type: str,
                       name: str) -> frozenset:
    """All (type, relation) pairs whose tuples can influence evaluation of
    `name` (a permission or relation) on `resource_type` — the compiled
    program's relation footprint.

    This is exactly the set of relation nodes reachable in the schema's
    dependency graph from (resource_type, name): a relation depends on
    itself and, through userset annotations (`viewer: group#member`), on
    the referenced (type, relation); a permission depends on the
    relations/permissions its expression reads, and an arrow
    `left->target` additionally on `target` at every subject type
    annotated on `left` (a conservative superset, like
    caveat_affected_pairs).  Wildcard and caveated tuples live on
    ordinary relations, so they are covered without special cases.

    Used by the decision cache (spicedb/decision_cache.py) for
    relation-scoped invalidation: a store delta touching relation R only
    invalidates cached decisions whose footprint contains R."""
    seen: set = set()
    rels: set = set()
    stack: list = [(resource_type, name)]

    def push_expr(t: str, d: sch.Definition, e: sch.Expr) -> None:
        if isinstance(e, sch.RelRef):
            stack.append((t, e.name))
        elif isinstance(e, sch.Arrow):
            stack.append((t, e.left))
            for ref in d.relations.get(e.left, ()):
                stack.append((ref.type, e.target))
        elif isinstance(e, (sch.Union, sch.Intersection)):
            for c in e.children:
                push_expr(t, d, c)
        elif isinstance(e, sch.Exclusion):
            push_expr(t, d, e.base)
            push_expr(t, d, e.subtract)
        # Nil reads nothing

    while stack:
        node = stack.pop()
        if node in seen:
            continue
        seen.add(node)
        t, n = node
        d = schema.definitions.get(t)
        if d is None:
            continue
        if n in d.relations:
            rels.add((t, n))
            for ref in d.relations[n]:
                if ref.relation:
                    stack.append((ref.type, ref.relation))
            continue
        expr = d.permissions.get(n)
        if expr is not None:
            push_expr(t, d, expr)
    return frozenset(rels)


def caveat_affected_pairs(schema: sch.Schema, caveated_rels: set) -> set:
    """All (type, relation-or-permission) pairs whose evaluation could
    traverse a relation in `caveated_rels` ({(type, relation)} pairs that
    hold >=1 live caveated tuple).  Queries on these pairs are routed to
    the host oracle (tri-state Kleene evaluation); everything else stays on
    the kernel.  Static over the schema, so it is a superset of the truly
    affected queries — correct, and empty when no caveated tuples exist."""
    affected = set(caveated_rels)

    def expr_affected(t: str, d: sch.Definition, e: sch.Expr) -> bool:
        if isinstance(e, sch.Nil):
            return False
        if isinstance(e, sch.RelRef):
            return (t, e.name) in affected
        if isinstance(e, sch.Arrow):
            if (t, e.left) in affected:
                return True
            for ref in d.relations.get(e.left, ()):
                if (ref.type, e.target) in affected:
                    return True
            return False
        if isinstance(e, (sch.Union, sch.Intersection)):
            return any(expr_affected(t, d, c) for c in e.children)
        if isinstance(e, sch.Exclusion):
            return (expr_affected(t, d, e.base)
                    or expr_affected(t, d, e.subtract))
        raise SchemaError(f"unknown expression {e!r}")

    changed = True
    while changed:
        changed = False
        for t, d in schema.definitions.items():
            for r, refs in d.relations.items():
                if (t, r) in affected:
                    continue
                for ref in refs:
                    if ref.relation and (ref.type, ref.relation) in affected:
                        affected.add((t, r))
                        changed = True
                        break
            for p, expr in d.permissions.items():
                if (t, p) in affected:
                    continue
                if expr_affected(t, d, expr):
                    affected.add((t, p))
                    changed = True
    return affected


def _find_arrows(expr: sch.Expr) -> list:
    out = []

    def walk(e: sch.Expr) -> None:
        if isinstance(e, sch.Arrow):
            out.append(e)
        elif isinstance(e, (sch.Union, sch.Intersection)):
            for c in e.children:
                walk(c)
        elif isinstance(e, sch.Exclusion):
            walk(e.base)
            walk(e.subtract)

    walk(expr)
    return out


def _compile_expr(prog: GraphProgram, schema: sch.Schema, t: str, perm: str,
                  expr: sch.Expr, arrow_slots: dict, counter: list):
    n = prog.num_objects[t]
    if isinstance(expr, sch.Nil):
        return PZero(n)
    if isinstance(expr, sch.RelRef):
        off, ln = prog.slot_range(t, expr.name)
        return PRead(off, ln)
    if isinstance(expr, sch.Arrow):
        k = counter[0]
        counter[0] += 1
        off, ln = prog.slot_range(t, arrow_slots[(t, perm, k)])
        return PRead(off, ln)
    if isinstance(expr, sch.Union):
        return PUnion(tuple(
            _compile_expr(prog, schema, t, perm, c, arrow_slots, counter)
            for c in expr.children))
    if isinstance(expr, sch.Intersection):
        return PIntersect(tuple(
            _compile_expr(prog, schema, t, perm, c, arrow_slots, counter)
            for c in expr.children))
    if isinstance(expr, sch.Exclusion):
        base = _compile_expr(prog, schema, t, perm, expr.base, arrow_slots, counter)
        sub = _compile_expr(prog, schema, t, perm, expr.subtract, arrow_slots, counter)
        return PExclude(base, sub)
    raise SchemaError(f"unknown expression {expr!r}")


def _topo_permissions(d: sch.Definition) -> list:
    """Order permissions so intra-type references resolve in one pass;
    cycles fall back to declaration order (converge across iterations)."""
    deps: dict[str, set] = {}
    for p, expr in d.permissions.items():
        refs: set[str] = set()

        def walk(e: sch.Expr) -> None:
            if isinstance(e, sch.RelRef) and e.name in d.permissions:
                refs.add(e.name)
            elif isinstance(e, (sch.Union, sch.Intersection)):
                for c in e.children:
                    walk(c)
            elif isinstance(e, sch.Exclusion):
                walk(e.base)
                walk(e.subtract)

        walk(expr)
        deps[p] = refs

    ordered: list[str] = []
    visiting: set[str] = set()
    done: set[str] = set()

    def visit(p: str) -> None:
        if p in done or p in visiting:
            return
        visiting.add(p)
        for q in deps[p]:
            visit(q)
        visiting.discard(p)
        done.add(p)
        ordered.append(p)

    for p in d.permissions:
        visit(p)
    return ordered
