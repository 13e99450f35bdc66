"""Per-check decision explain: relation-path witnesses for audit events
(reference authz/explain.py).

Two witness sources, merged into one `Witness` record:

- **Oracle witness** (`oracle_witness`): a recursive mirror of the host
  evaluator (spicedb/evaluator.py) that, instead of a bare tri-state
  value, returns the admitting chain of relation hops for an allowed
  decision (`pod:a/x#view -> pod:a/x#viewer@user:alice [direct]`), the
  excluding chain for an exclusion-caused denial, and the probed
  frontier (which relations were searched and found empty) for ordinary
  denials.  Golden tests pin its decision to the oracle's on every
  schema construct (union/intersection/exclusion/arrow/userset/
  wildcard/caveat).

- **Device witness** (`device_witness`): an exact host (numpy) replay of
  the kernels' fixpoint step — edge OR-SpMV + wildcard terms +
  permission program — over the compiled GraphProgram, recording the
  iteration at which every state row first lit up.  For an allowed row
  this recovers *which relation hop / fixpoint iteration admitted the
  subject* from the staged iterate without any device work; the state
  chain is decoded back through the program's slot layout into the same
  hop vocabulary.  (Incremental deltas applied since the last compile
  live in the device tables, not the program's edge arrays, so the
  caller cross-checks the replay's decision against the kernel's and
  falls back to the oracle witness on disagreement.)

Witnesses attach to audit events (utils/audit.py) at Request level when
explain mode is on (`--audit-explain` or a `?explain=1` request), so a
filtered 10k-pod list can name, per hidden pod, the relation path that
excluded it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..spicedb import schema as sch
from ..spicedb.evaluator import MAX_DEPTH, NO, MAYBE, YES
from ..spicedb.store import TupleStore
from ..spicedb.types import (
    MaxDepthExceededError,
    ObjectRef,
    SchemaError,
    SubjectRef,
    WILDCARD,
)

_DECISION = {NO: "denied", MAYBE: "conditional", YES: "allowed"}

# bound the probed-frontier payload on denials: the first hops name the
# excluding relations; an exhaustive listing would bloat audit events
MAX_PROBED_HOPS = 16


@dataclass
class Hop:
    """One relation hop in an evaluation witness."""
    resource: str        # "type:id"
    relation: str
    subject: str         # "type:id" or "type:id#rel"
    via: str             # direct|wildcard|userset|arrow|permission|device
    admitted: bool = True
    caveated: bool = False

    def rel_string(self) -> str:
        return f"{self.resource}#{self.relation}@{self.subject}"

    def to_dict(self) -> dict:
        d = {"rel": self.rel_string(), "via": self.via,
             "admitted": self.admitted}
        if self.caveated:
            d["caveated"] = True
        return d


@dataclass
class Witness:
    """The evaluation record for one (resource, permission, subject)."""
    decision: str                  # allowed|conditional|denied
    path: list = field(default_factory=list)    # admitting/excluding chain
    probed: list = field(default_factory=list)  # searched-and-empty hops
    iterations: Optional[int] = None  # fixpoint admission iteration
    backend: str = "oracle"
    note: str = ""

    def to_dict(self) -> dict:
        d = {"decision": self.decision,
             "path": [h.to_dict() for h in self.path],
             "backend": self.backend}
        if self.probed:
            d["probed"] = [h.to_dict() for h in self.probed]
        if self.iterations is not None:
            d["iterations"] = self.iterations
        if self.note:
            d["note"] = self.note
        return d


def _obj_str(type_name: str, object_id: str) -> str:
    return f"{type_name}:{object_id}"


def _subj_str(s: SubjectRef) -> str:
    base = f"{s.type}:{s.id}"
    return f"{base}#{s.relation}" if s.relation else base


# -- oracle witness ----------------------------------------------------------


class _WitnessEval:
    """Recursive witness evaluator; mirrors Evaluator._check /
    _check_relation / _eval_expr hop for hop, carrying the admitting
    chain alongside the Kleene value.  No memoization: explain is a
    per-denial debug path, not the hot path."""

    def __init__(self, schema: sch.Schema, store: TupleStore,
                 max_depth: int = MAX_DEPTH):
        self.schema = schema
        self.store = store
        self.max_depth = max_depth

    def _caveat_value(self, caveat) -> int:
        if caveat is None:
            return YES
        c = self.schema.caveats.get(caveat.name)
        if c is None:
            raise SchemaError(f"caveat `{caveat.name}` not found")
        out = c.evaluate(caveat.context())
        if out is None:
            return MAYBE
        return YES if out else NO

    def check(self, resource: ObjectRef, name: str, subject: SubjectRef,
              depth: int, stack: set) -> tuple:
        """Returns (value, path): for YES/MAYBE the admitting chain, for
        NO the excluding chain when the denial came from an exclusion
        (else empty)."""
        if depth > self.max_depth:
            raise MaxDepthExceededError(
                f"max dispatch depth {self.max_depth} exceeded explaining"
                f" {resource}#{name}")
        key = (resource.type, resource.id, name, subject)
        if key in stack:
            return NO, []  # cycle: revisiting adds nothing new
        stack.add(key)
        try:
            d = self.schema.definition(resource.type)
            if name in d.relations:
                return self._relation(resource, name, subject, depth, stack)
            if name in d.permissions:
                return self._expr(d, resource, d.permissions[name], subject,
                                  depth, stack)
            raise SchemaError(
                f"relation/permission `{name}` not found for {resource.type}")
        finally:
            stack.discard(key)

    def _relation(self, resource: ObjectRef, relation: str,
                  subject: SubjectRef, depth: int, stack: set) -> tuple:
        best, best_path = NO, []
        res = _obj_str(resource.type, resource.id)
        for ts, caveat in self.store.subject_entries_for(resource, relation):
            cv = self._caveat_value(caveat)
            if cv == NO:
                continue
            cav = cv == MAYBE
            if not ts.relation:
                if ts.id == WILDCARD:
                    if ts.type == subject.type and not subject.relation:
                        hop = Hop(res, relation, f"{ts.type}:*",
                                  via="wildcard", caveated=cav)
                        if cv > best:
                            best, best_path = cv, [hop]
                else:
                    if ts == subject:
                        hop = Hop(res, relation, _subj_str(ts), via="direct",
                                  caveated=cav)
                        if cv > best:
                            best, best_path = cv, [hop]
            else:
                if (ts.type == subject.type and ts.id == subject.id
                        and ts.relation == subject.relation):
                    hop = Hop(res, relation, _subj_str(ts), via="userset",
                              caveated=cav)
                    if cv > best:
                        best, best_path = cv, [hop]
                else:
                    sub_v, sub_path = self.check(
                        ObjectRef(ts.type, ts.id), ts.relation, subject,
                        depth + 1, stack)
                    v = min(cv, sub_v)
                    if v > best:
                        hop = Hop(res, relation, _subj_str(ts), via="userset",
                                  caveated=cav)
                        best, best_path = v, [hop] + sub_path
            if best == YES:
                break
        return best, best_path

    def _expr(self, d: sch.Definition, resource: ObjectRef, expr,
              subject: SubjectRef, depth: int, stack: set) -> tuple:
        if isinstance(expr, sch.Nil):
            return NO, []
        if isinstance(expr, sch.RelRef):
            return self.check(resource, expr.name, subject, depth + 1, stack)
        if isinstance(expr, sch.Arrow):
            best, best_path = NO, []
            res = _obj_str(resource.type, resource.id)
            for ts, caveat in self.store.subject_entries_for(resource,
                                                             expr.left):
                if ts.id == WILDCARD or ts.relation:
                    continue
                cv = self._caveat_value(caveat)
                if cv == NO:
                    continue
                target_def = self.schema.definitions.get(ts.type)
                if (target_def is None
                        or not target_def.has_relation_or_permission(
                            expr.target)):
                    continue
                sub_v, sub_path = self.check(
                    ObjectRef(ts.type, ts.id), expr.target, subject,
                    depth + 1, stack)
                v = min(cv, sub_v)
                if v > best:
                    hop = Hop(res, expr.left, _subj_str(ts), via="arrow",
                              caveated=cv == MAYBE)
                    best, best_path = v, [hop] + sub_path
                if best == YES:
                    break
            return best, best_path
        if isinstance(expr, sch.Union):
            best, best_path = NO, []
            for c in expr.children:
                v, p = self._expr(d, resource, c, subject, depth, stack)
                if v > best:
                    best, best_path = v, p
                if best == YES:
                    break
            return best, best_path
        if isinstance(expr, sch.Intersection):
            worst, paths = YES, []
            for c in expr.children:
                v, p = self._expr(d, resource, c, subject, depth, stack)
                if v < worst:
                    worst = v
                if v == NO:
                    return NO, []  # this branch denies the intersection
                paths.extend(p)
            return worst, paths
        if isinstance(expr, sch.Exclusion):
            base_v, base_path = self._expr(d, resource, expr.base, subject,
                                           depth, stack)
            if base_v == NO:
                return NO, []
            sub_v, sub_path = self._expr(d, resource, expr.subtract, subject,
                                         depth, stack)
            v = min(base_v, YES - sub_v)
            if v == NO:
                # the EXCLUDING chain is the explanation: the subject was
                # granted by `base` but banned by `subtract`
                return NO, [Hop(h.resource, h.relation, h.subject,
                                via="exclusion", admitted=False,
                                caveated=h.caveated) for h in sub_path]
            return v, base_path + sub_path
        raise SchemaError(f"unknown expression node {expr!r}")


def _probe_frontier(schema: sch.Schema, resource: ObjectRef, name: str,
                    subject: SubjectRef) -> list:
    """Depth-1 description of a plain denial: the relation leaves of the
    permission expression, each an unadmitted hop — 'these are the
    relations that were searched and held no admitting tuple'."""
    res = _obj_str(resource.type, resource.id)
    subj = _subj_str(subject)
    try:
        d = schema.definition(resource.type)
    except SchemaError:
        return []
    if name in d.relations:
        return [Hop(res, name, subj, via="direct", admitted=False)]
    expr = d.permissions.get(name)
    if expr is None:
        return []
    out: list = []

    def walk(e) -> None:
        if len(out) >= MAX_PROBED_HOPS:
            return
        if isinstance(e, sch.RelRef):
            out.append(Hop(res, e.name, subj, via="permission",
                           admitted=False))
        elif isinstance(e, sch.Arrow):
            out.append(Hop(res, e.left, f"->{e.target}", via="arrow",
                           admitted=False))
        elif isinstance(e, (sch.Union, sch.Intersection)):
            for c in e.children:
                walk(c)
        elif isinstance(e, sch.Exclusion):
            walk(e.base)

    walk(expr)
    return out


def oracle_witness(schema: sch.Schema, store: TupleStore,
                   resource: ObjectRef, permission: str,
                   subject: SubjectRef,
                   max_depth: int = MAX_DEPTH) -> Witness:
    """Explain one check against the host oracle's semantics."""
    ev = _WitnessEval(schema, store, max_depth=max_depth)
    try:
        value, path = ev.check(resource, permission, subject, 0, set())
    except (SchemaError, MaxDepthExceededError) as e:
        return Witness(decision="denied", note=f"explain error: {e}")
    w = Witness(decision=_DECISION[value], path=path)
    if value == YES or value == MAYBE:
        # relation-hop count == the fixpoint iteration bound that admits
        # this subject (each hop is one one-step-closure application)
        w.iterations = len(path)
    else:
        w.probed = (_probe_frontier(schema, resource, permission, subject)
                    if not path else [])
    return w


# -- device witness (host replay of the kernel iterate) ----------------------


def _perm_expr_np(expr, x):
    """numpy mirror of ops/spmv._apply_perm_expr over a bool [N] state."""
    import numpy as np

    from ..ops.graph_compile import PExclude, PIntersect, PRead, PUnion, PZero

    if isinstance(expr, PRead):
        return x[expr.offset: expr.offset + expr.length]
    if isinstance(expr, PZero):
        return np.zeros(expr.length, bool)
    if isinstance(expr, PUnion):
        out = _perm_expr_np(expr.children[0], x)
        for c in expr.children[1:]:
            out = out | _perm_expr_np(c, x)
        return out
    if isinstance(expr, PIntersect):
        out = _perm_expr_np(expr.children[0], x)
        for c in expr.children[1:]:
            out = out & _perm_expr_np(c, x)
        return out
    if isinstance(expr, PExclude):
        return _perm_expr_np(expr.base, x) & ~_perm_expr_np(expr.subtract, x)
    raise TypeError(f"unknown perm expr {expr!r}")


def _iterate_states(prog, subject_idx: int, max_iters: int = 50) -> tuple:
    """Replay the kernel fixpoint on host; returns (final bool [N] state,
    int [N] first-admission iteration, -1 = never admitted)."""
    import numpy as np

    n = prog.state_size
    x0 = np.zeros(n, bool)
    x0[subject_idx] = True
    x0[n - 1] = False
    admitted = np.full(n, -1, np.int64)
    admitted[x0] = 0
    x = x0.copy()
    for it in range(1, max_iters + 1):
        y = np.zeros(n, bool)
        np.logical_or.at(y, prog.edge_dst, x[prog.edge_src])
        for term in prog.wildcard_terms:
            if x[term.self_offset: term.self_offset + term.self_length].any():
                y[list(term.mask_indices)] = True
        x1 = y | x0
        for op in prog.perm_ops:
            sl = slice(op.offset, op.offset + op.length)
            x1[sl] = _perm_expr_np(op.expr, x1) | x0[sl]
        x1[n - 1] = False
        new = x1 & ~x
        admitted[new & (admitted < 0)] = it
        if not new.any():
            break
        x = x1
    return x, admitted


def _slot_table(prog) -> tuple:
    """(sorted offsets, parallel (type, slot, length) rows) decode table
    for state indices, cached on the program."""
    table = getattr(prog, "_explain_slot_table", None)
    if table is None:
        rows = sorted(
            (off, t, slot, prog.num_objects[t])
            for (t, slot), off in prog.slot_offsets.items())
        table = ([r[0] for r in rows], [(r[1], r[2], r[3]) for r in rows])
        prog._explain_slot_table = table
    return table


def decode_state(prog, idx: int) -> Optional[tuple]:
    """State index -> (type, slot, object_id), or None for dead/padding."""
    import bisect

    offsets, rows = _slot_table(prog)
    i = bisect.bisect_right(offsets, idx) - 1
    if i < 0:
        return None
    t, slot, length = rows[i]
    if idx >= offsets[i] + length:
        return None
    return t, slot, prog.object_ids[t][idx - offsets[i]]


def _predecessor(prog, state, admitted, idx: int):
    """One state that admitted `idx` at an earlier iteration: an in-edge
    whose source lit earlier, or a permission-program read leaf."""
    import numpy as np

    it = admitted[idx]
    srcs = prog.edge_src[np.nonzero(prog.edge_dst == idx)[0]]
    for s in srcs:
        s = int(s)
        if 0 <= admitted[s] < it:
            return s
    for term in prog.wildcard_terms:
        if idx in term.mask_indices:
            sl = admitted[term.self_offset:
                          term.self_offset + term.self_length]
            live = np.nonzero((sl >= 0) & (sl < it))[0]
            if live.size:
                return term.self_offset + int(live[0])
    for op in prog.perm_ops:
        if not (op.offset <= idx < op.offset + op.length):
            continue
        local = idx - op.offset

        def leaf(e):
            from ..ops.graph_compile import (PExclude, PIntersect, PRead,
                                             PUnion)
            if isinstance(e, PRead):
                s = e.offset + local
                # a leaf admitted at it-1 OR at it: the permission
                # program applies within the same iteration as the edge
                # sweep that lit the leaf (Gauss-Seidel within the step)
                if 0 <= admitted[s] <= it and s != idx and state[s]:
                    return s
                return None
            if isinstance(e, (PUnion, PIntersect)):
                for c in e.children:
                    s = leaf(c)
                    if s is not None:
                        return s
                return None
            if isinstance(e, PExclude):
                return leaf(e.base)
            return None

        s = leaf(op.expr)
        if s is not None:
            return s
    return None


def device_witness(prog, subject_idx: int, target_idx: int,
                   max_iters: int = 50) -> Witness:
    """Witness from the compiled program's staged iterate: admission
    iteration + decoded state chain for (subject column, target row)."""
    state, admitted = _iterate_states(prog, subject_idx,
                                      max_iters=max_iters)
    if admitted[target_idx] < 0:
        return Witness(decision="denied", backend="device",
                       note="target row never admitted in the replayed "
                            "iterate")
    chain: list = []
    idx = target_idx
    seen = set()
    while idx != subject_idx and idx not in seen:
        seen.add(idx)
        decoded = decode_state(prog, idx)
        pred = _predecessor(prog, state, admitted, idx)
        if decoded is not None:
            t, slot, oid = decoded
            sub = "?"
            if pred is not None:
                pd = decode_state(prog, pred)
                if pd is not None:
                    sub = _obj_str(pd[0], pd[2])
                    if pd[1] not in ("__self__",):
                        sub += f"#{pd[1]}"
            chain.append(Hop(_obj_str(t, oid), slot, sub, via="device"))
        if pred is None:
            break
        idx = pred
    return Witness(decision="allowed", path=chain, backend="device",
                   iterations=int(admitted[target_idx]))


def witness_for(endpoint, resource: ObjectRef, permission: str,
                subject: SubjectRef) -> Optional[Witness]:
    """Best witness the endpoint can produce, or None when it carries no
    host store/schema.  Backends exposing `explain_check` (torch://) get
    iterate capture; anything with a schema + store gets the
    oracle witness."""
    explain = getattr(endpoint, "explain_check", None)
    if explain is not None:
        return explain(resource, permission, subject)
    schema = getattr(endpoint, "schema", None)
    store = getattr(endpoint, "store", None)
    if schema is None or store is None:
        return None
    w = oracle_witness(schema, store, resource, permission, subject)
    w.backend = "embedded"
    return w


async def witness_async(endpoint, resource: ObjectRef, permission: str,
                        subject: SubjectRef) -> Optional[Witness]:
    """witness_for off the event loop: iterate capture replays the
    fixpoint on host and must not stall concurrent requests."""
    import asyncio
    import contextvars

    loop = asyncio.get_running_loop()
    ctx = contextvars.copy_context()
    return await loop.run_in_executor(
        None, lambda: ctx.run(witness_for, endpoint, resource, permission,
                              subject))


async def witness_dict_for_rel(endpoint, rel,
                               object_id: Optional[str] = None
                               ) -> Optional[dict]:
    """Audit-event witness payload for a resolved rel (an audit helper:
    failures yield None, never an exception — an explain fault must not
    fail the decision it describes).  `object_id` overrides the rel's
    resource id (prefilter rels carry `$`)."""
    if rel is None:
        return None
    try:
        w = await witness_async(
            endpoint,
            ObjectRef(rel.resource_type,
                      rel.resource_id if object_id is None else object_id),
            rel.resource_relation,
            SubjectRef(rel.subject_type, rel.subject_id,
                       rel.subject_relation))
    except Exception:
        return None
    return w.to_dict() if w is not None else None
