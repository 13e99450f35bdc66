"""Columnar relationship snapshots: interned string pool + int32 columns.

The bulk-data representation shared by the text loader, the tuple store's
base layer, and the vectorized graph compiler.  A 1M-tuple bootstrap never materializes per-tuple Python objects on the hot
path: text -> (pool, columns) -> store base / device graph, with
Relationship objects created lazily only for small result sets.

Mirrors types.parse_relationship semantics exactly (grammar
rules/relstring.py:20-23, first-occurrence splits; "..." subject relation
normalizes to ""; blank and '#' lines skipped like
endpoints.Bootstrap.relationships()).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .types import ObjectRef, Relationship, SubjectRef

_COLS = ("rtype", "rid", "rel", "stype", "sid", "srel")


@dataclass
class ColumnarSnapshot:
    pool: list                      # interned strings; ordinals index this
    rtype: np.ndarray               # int32 [n]
    rid: np.ndarray
    rel: np.ndarray
    stype: np.ndarray
    sid: np.ndarray
    srel: np.ndarray
    expiry: np.ndarray              # float64 [n]; NaN = no expiration
    _pool_index: Optional[dict] = field(default=None, repr=False)

    def __len__(self) -> int:
        return len(self.rtype)

    @property
    def pool_index(self) -> dict:
        if self._pool_index is None:
            self._pool_index = {s: i for i, s in enumerate(self.pool)}
        return self._pool_index

    def ordinal(self, s: str) -> int:
        """Pool ordinal of `s`, or -1 (matches nothing)."""
        return self.pool_index.get(s, -1)

    def relationship(self, i: int) -> Relationship:
        pool = self.pool
        exp = float(self.expiry[i])
        return Relationship(
            resource=ObjectRef(pool[self.rtype[i]], pool[self.rid[i]]),
            relation=pool[self.rel[i]],
            subject=SubjectRef(pool[self.stype[i]], pool[self.sid[i]],
                               pool[self.srel[i]]),
            expires_at=None if np.isnan(exp) else exp,
        )

    def key_of(self, i: int) -> tuple:
        """Identity key of row i, as Relationship.key() gives it."""
        pool = self.pool
        return (pool[self.rtype[i]], pool[self.rid[i]], pool[self.rel[i]],
                pool[self.stype[i]], pool[self.sid[i]], pool[self.srel[i]])

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_text(cls, text: str) -> "ColumnarSnapshot":
        """Parse relationship lines (pure Python; this package carries no
        native parser).

        The bulk-text grammar is deliberately ASCII-strict: lines split on
        '\\n' only, surrounding whitespace is ASCII whitespace, and
        expiration floats reject Python-only forms (underscores) and
        C-only forms (hex).
        """
        pool: list = []
        index: dict = {}

        def intern(s: str) -> int:
            i = index.get(s)
            if i is None:
                i = len(pool)
                index[s] = i
                pool.append(s)
            return i

        ascii_ws = " \t\r\v\f\n"
        cols: list[list[int]] = [[] for _ in range(6)]
        expiry: list[float] = []
        for lineno, raw in enumerate(text.split("\n"), 1):
            line = raw.strip(ascii_ws)
            if not line or line.startswith("#"):
                continue
            exp = float("nan")
            if line.endswith("]"):
                lb = line.rfind("[expiration:")
                if lb != -1:
                    num = line[lb + 12: -1].strip(ascii_ws)
                    try:
                        if "_" in num:
                            raise ValueError(num)
                        exp = float(num)
                    except ValueError:
                        raise ValueError(f"line {lineno}: bad expiration: {line!r}")
                    line = line[:lb]
            try:
                c1 = line.index(":")
                h1 = line.index("#", c1 + 1)
                at = line.index("@", h1 + 1)
                c2 = line.index(":", at + 1)
            except ValueError:
                raise ValueError(f"line {lineno}: malformed: {line!r}")
            rest = line[c2 + 1:]
            h2 = rest.find("#")
            sid_s, srel_s = (rest, "") if h2 == -1 else (rest[:h2], rest[h2 + 1:])
            if srel_s == "...":
                srel_s = ""
            fields = (line[:c1], line[c1 + 1: h1], line[h1 + 1: at],
                      line[at + 1: c2], sid_s)
            if any(not f for f in fields) or "{{" in line:
                raise ValueError(f"line {lineno}: malformed: {line!r}")
            for col, val in zip(cols, (*fields, srel_s)):
                col.append(intern(val))
            expiry.append(exp)
        arrays = [np.asarray(c, np.int32) for c in cols]
        return cls(pool, *arrays, expiry=np.asarray(expiry, np.float64))


class BaseLayer:
    """A columnar snapshot acting as the tuple store's immutable base, with
    a dead-row mask for deletions/shadowing by overlay writes.

    All lookups are ordinal-based; group indexes are built lazily on first
    query.  Thread safety is provided by the owning store's lock.
    """

    def __init__(self, snap: ColumnarSnapshot, revision: int):
        self.snap = snap
        self.revision = revision
        self.dead = np.zeros(len(snap), bool)
        # (rtype_ord, rel_ord) -> (rows sorted by rid ordinal, their rids)
        self._groups: Optional[dict] = None
        # duplicate identities in the source text: keep only the LAST copy
        # (matching bulk_load's dict-upsert semantics); earlier copies are
        # dead from the start so find_row-based shadowing stays sound
        if len(snap):
            order = np.lexsort((np.arange(len(snap)), snap.srel, snap.sid,
                                snap.stype, snap.rel, snap.rid, snap.rtype))
            cols = (snap.rtype, snap.rid, snap.rel,
                    snap.stype, snap.sid, snap.srel)
            same = np.ones(len(snap) - 1, bool)
            for c in cols:
                v = c[order]
                same &= v[1:] == v[:-1]
            # `order` puts equal identities adjacent, ascending by row index;
            # a row followed by an equal identity is an earlier duplicate
            self.dead[order[:-1][same]] = True

    def __len__(self) -> int:
        return len(self.snap)

    # -- indexes ------------------------------------------------------------

    def _ensure_groups(self) -> dict:
        if self._groups is None:
            s = self.snap
            order = np.lexsort((s.rid, s.rel, s.rtype))
            rt, rl = s.rtype[order], s.rel[order]
            change = np.nonzero((np.diff(rt) != 0) | (np.diff(rl) != 0))[0] + 1
            bounds = np.concatenate([[0], change, [len(order)]])
            groups = {}
            for i in range(len(bounds) - 1):
                lo, hi = bounds[i], bounds[i + 1]
                if lo == hi:
                    continue
                rows = order[lo:hi]  # sorted by rid ordinal within the group
                # the rid column of the group, gathered once: a per-call
                # gather made every resource lookup O(group size)
                groups[(int(rt[lo]), int(rl[lo]))] = (rows, s.rid[rows])
            self._groups = groups
        return self._groups

    def rows_for_resource(self, rtype: str, relation: str,
                          rid: str) -> np.ndarray:
        s = self.snap
        t, r, i = s.ordinal(rtype), s.ordinal(relation), s.ordinal(rid)
        group = self._ensure_groups().get((t, r)) if t >= 0 and r >= 0 \
            else None
        if group is None or i < 0:
            return np.zeros(0, np.int64)
        rows, vals = group
        lo = np.searchsorted(vals, i, "left")
        hi = np.searchsorted(vals, i, "right")
        return rows[lo:hi]

    def find_row(self, key: tuple) -> int:
        """Row index of the live-identity tuple with this key, or -1
        (dead rows — deleted, shadowed, or pre-deduplicated — are
        invisible)."""
        (rtype, rid, relation, stype, sid, srel) = key
        s = self.snap
        st, si, sr = s.ordinal(stype), s.ordinal(sid), s.ordinal(srel)
        if st < 0 or si < 0 or sr < 0:
            return -1
        for row in self.rows_for_resource(rtype, relation, rid):
            if (not self.dead[row] and s.stype[row] == st
                    and s.sid[row] == si and s.srel[row] == sr):
                return int(row)
        return -1

    # -- liveness -----------------------------------------------------------

    def live_mask(self, now: float) -> np.ndarray:
        exp = self.snap.expiry
        return ~self.dead & (np.isnan(exp) | (now < exp))

    def row_live(self, row: int, now: float) -> bool:
        if self.dead[row]:
            return False
        e = self.snap.expiry[row]
        return bool(np.isnan(e) or now < e)

    def live_rows(self, now: float) -> np.ndarray:
        return np.nonzero(self.live_mask(now))[0]

    # -- filtered scan ------------------------------------------------------

    def matching_rows(self, flt, now: float) -> np.ndarray:
        """Vectorized RelationshipFilter scan -> live matching row indices."""
        s = self.snap
        mask = self.live_mask(now)

        def narrow(col: np.ndarray, value: str) -> bool:
            o = s.ordinal(value)
            if o < 0:
                return False
            np.logical_and(mask, col == o, out=mask)
            return True

        if flt is not None:
            if flt.resource_type and not narrow(s.rtype, flt.resource_type):
                return np.zeros(0, np.int64)
            if flt.resource_id and not narrow(s.rid, flt.resource_id):
                return np.zeros(0, np.int64)
            if flt.relation and not narrow(s.rel, flt.relation):
                return np.zeros(0, np.int64)
            sub = flt.subject
            if sub is not None:
                if sub.type and not narrow(s.stype, sub.type):
                    return np.zeros(0, np.int64)
                if sub.id and not narrow(s.sid, sub.id):
                    return np.zeros(0, np.int64)
                if sub.relation is not None and not narrow(s.srel, sub.relation):
                    return np.zeros(0, np.int64)
        return np.nonzero(mask)[0]
