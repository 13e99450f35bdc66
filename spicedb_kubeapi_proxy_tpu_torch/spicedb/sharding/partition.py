"""Tuple-space partition map: resource type -> shard leader (the
reference's spicedb/sharding/partition.py, over this package's own
`relation_footprint`).

The write path scales out by splitting the tuple space BY RESOURCE TYPE
across N independent leaders (each its own WAL, checkpoint lineage, and
replication tree) behind a thin router.  What makes type-partitioning
*provably* safe per-schema — rather than hoped-for — is the
`relation_footprint` closure (ops/graph_compile.py, Cedar's
analyzability angle, PAPERS.md): a permission whose closure only touches
relations of types co-located on one shard evaluates identically over
that shard's tuple subset and over the full store, because no tuple
outside the shard can influence it.  `PartitionMap.validate_schema`
enforces exactly that at startup: a permission (or proxy-rule template)
whose closure spans two shards is a hard configuration error unless the
operator routes the involved types to the same shard.

Internal bookkeeping types (lock / workflow / activity — the dual-write
engine's tuples, endpoints.INTERNAL_SCHEMA) are shard-agnostic: they
ride the shard of the batch that writes them (a dual-write's lock and
idempotency key land — and stay — on the same shard as the rule tuples
they guard, so lock contenders meet where the rule types live and a
router retry converges against that shard's key).  An internal-only
batch falls back to a stable hash of its resource id here; the
ShardedEndpoint additionally locates internal-only DELETE batches (a
dual-write's post-success lock release) on the shard that actually
holds the tuple, since the acquiring batch's rule types are not
recoverable from the release batch.  Internal-type READS fan out
across shards.
"""

from __future__ import annotations

import zlib
from typing import Iterable, Optional

from .. import schema as sch
from ...ops.graph_compile import relation_footprint

# definitions the dual-write engine owns (endpoints.INTERNAL_SCHEMA);
# mirrored from schema_lint.INTERNAL_TYPES (import would be circular:
# schema_lint consumes PartitionMap for SL007/SL008)
INTERNAL_TYPES = frozenset(("lock", "workflow", "activity"))


class PartitionMapError(ValueError):
    """Malformed --partition-map / --shards configuration."""


class CrossShardWriteError(Exception):
    """A write batch touches resource types on two different shards —
    unroutable: no single leader can apply it atomically.  The
    footprint validation at startup makes this unreachable for
    rule-generated dual-writes; hitting it means a caller bypassed the
    schema (or the map changed under a live client)."""


def _stable_shard(key: str, n_shards: int) -> int:
    """Deterministic, process-independent shard for internal-type ids
    (crc32: stable across runs/hosts, unlike hash())."""
    return zlib.crc32(key.encode("utf-8")) % n_shards


class PartitionMap:
    """Explicit `type=shard` assignments plus a default shard.

    `n_shards` bounds every assignment; unassigned types land on
    `default_shard`.  The map is static configuration — exactly one map
    must be shared by the router and every shard leader."""

    def __init__(self, n_shards: int, assignments: Optional[dict] = None,
                 default_shard: int = 0):
        if n_shards < 1:
            raise PartitionMapError(f"n_shards must be >= 1, got {n_shards}")
        assignments = dict(assignments or {})
        for t, s in assignments.items():
            if not isinstance(s, int) or not (0 <= s < n_shards):
                raise PartitionMapError(
                    f"partition map assigns type {t!r} to shard {s!r}, "
                    f"outside the configured 0..{n_shards - 1} range")
        if not (0 <= default_shard < n_shards):
            raise PartitionMapError(
                f"default shard {default_shard} outside 0..{n_shards - 1}")
        self.n_shards = n_shards
        self.assignments = assignments
        self.default_shard = default_shard

    @classmethod
    def parse(cls, spec: str, n_shards: Optional[int] = None,
              default_shard: int = 0) -> "PartitionMap":
        """Parse the `--partition-map` flag value: comma-separated
        `type=shard` pairs (`pod=0,secret=1`).  When `n_shards` is
        omitted it is inferred as max(assigned shard) + 1."""
        assignments: dict = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            name, eq, raw = part.partition("=")
            name = name.strip()
            raw = raw.strip()
            if not eq or not name or not raw:
                raise PartitionMapError(
                    f"invalid partition-map entry {part!r}: want type=shard")
            try:
                shard = int(raw)
            except ValueError as e:
                raise PartitionMapError(
                    f"invalid shard id in partition-map entry {part!r}: "
                    f"{e}") from e
            if shard < 0:
                raise PartitionMapError(
                    f"negative shard id in partition-map entry {part!r}")
            if name in assignments and assignments[name] != shard:
                raise PartitionMapError(
                    f"type {name!r} assigned to two shards "
                    f"({assignments[name]} and {shard})")
            assignments[name] = shard
        if n_shards is None:
            n_shards = max(assignments.values(), default=0) + 1
        return cls(n_shards, assignments, default_shard=default_shard)

    # -- routing -------------------------------------------------------------

    def shard_for_type(self, resource_type: str) -> int:
        return self.assignments.get(resource_type, self.default_shard)

    def shard_of(self, resource_type: str, resource_id: str = "") -> int:
        """Shard of one tuple/query: schema types route by assignment;
        internal bookkeeping types route by a stable hash of the id so
        retries and lock contenders always meet on one shard."""
        if resource_type in INTERNAL_TYPES and resource_id:
            return _stable_shard(resource_id, self.n_shards)
        return self.shard_for_type(resource_type)

    def shard_for_updates(self, updates: Iterable) -> int:
        """Route one write batch to exactly one shard.  All non-internal
        resource types in the batch must co-locate (the footprint
        validation guarantees this for every rule-generated dual-write);
        internal bookkeeping tuples ride along.  An internal-only batch
        routes by the stable hash of its first resource id —
        deterministic, so a crashed router's retry of the same
        dual-write lands on the SAME shard and converges against that
        shard's idempotency key.  (The ShardedEndpoint refines this for
        internal-only DELETE batches — a lock release must land where
        the acquiring rule batch put the lock, which this map alone
        cannot know; see ShardedEndpoint._locate_internal_shard.)"""
        shards: set = set()
        first_internal: Optional[tuple] = None
        for u in updates:
            rtype = u.rel.resource.type
            if rtype in INTERNAL_TYPES:
                if first_internal is None:
                    first_internal = (rtype, u.rel.resource.id)
                continue
            shards.add(self.shard_for_type(rtype))
        if len(shards) > 1:
            raise CrossShardWriteError(
                f"write batch spans shards {sorted(shards)}: no single "
                f"leader can apply it atomically (run --lint-schema with "
                f"the partition map to find the offending rule)")
        if shards:
            return shards.pop()
        if first_internal is not None:
            return self.shard_of(*first_internal)
        return self.default_shard

    def shards_for_filter(self, flt) -> list:
        """Shards a RelationshipFilter can touch.  A typed filter on a
        schema type touches one shard; internal types (whose tuples ride
        the shard of the batch that wrote them) and untyped filters fan
        out to every shard."""
        rtype = getattr(flt, "resource_type", "") if flt is not None else ""
        if rtype and rtype not in INTERNAL_TYPES:
            return [self.shard_for_type(rtype)]
        return list(range(self.n_shards))

    def shards_for_types(self, object_types: Optional[Iterable[str]]) -> list:
        """Shards a watch over `object_types` must merge (None = all)."""
        if not object_types:
            return list(range(self.n_shards))
        out: set = set()
        for t in object_types:
            if t in INTERNAL_TYPES:
                return list(range(self.n_shards))
            out.add(self.shard_for_type(t))
        return sorted(out)

    # -- static validation (the footprint proof) -----------------------------

    def closure_types(self, schema: sch.Schema, resource_type: str,
                      name: str) -> frozenset:
        """Resource types whose tuples can influence (resource_type,
        name): the type itself plus every type appearing in the
        relation_footprint closure."""
        types = {resource_type}
        for t, _rel in relation_footprint(schema, resource_type, name):
            types.add(t)
        return frozenset(types)

    def closure_shards(self, schema: sch.Schema, resource_type: str,
                       name: str) -> dict:
        """shard -> sorted types of the closure, excluding internal
        bookkeeping types (they are shard-agnostic by design)."""
        out: dict = {}
        for t in self.closure_types(schema, resource_type, name):
            if t in INTERNAL_TYPES:
                continue
            out.setdefault(self.shard_for_type(t), []).append(t)
        return {k: sorted(v) for k, v in out.items()}

    def validate_schema(self, schema: sch.Schema,
                        rule_configs: Iterable = ()) -> tuple:
        """-> (errors, warnings), each a list of (where, message).

        Errors (SL007, hard startup failure): a permission or a proxy
        rule whose relation_footprint closure spans two shards — an
        unroutable evaluation/dual-write.  Warnings (SL008): a partition
        map key naming a type absent from the schema (a typo silently
        falls back to the default shard)."""
        errors: list = []
        warnings: list = []
        if self.n_shards > 1:
            for tname, d in sorted(schema.definitions.items()):
                if tname in INTERNAL_TYPES:
                    continue
                for pname in sorted(d.permissions):
                    spread = self.closure_shards(schema, tname, pname)
                    if len(spread) > 1:
                        errors.append((
                            f"{tname}#{pname}",
                            f"permission {tname}#{pname} has a relation "
                            f"footprint spanning shards "
                            f"{sorted(spread)}: {self._spread_desc(spread)}"
                            f" — co-locate these types in the partition "
                            f"map or split the permission"))
            for rule_name, types in self._rule_type_sets(schema,
                                                         rule_configs):
                spread: dict = {}
                for t in types:
                    if t in INTERNAL_TYPES or t not in schema.definitions:
                        continue
                    spread.setdefault(self.shard_for_type(t), []).append(t)
                if len(spread) > 1:
                    spread = {k: sorted(v) for k, v in spread.items()}
                    errors.append((
                        f"rule {rule_name}",
                        f"rule {rule_name!r} touches types on shards "
                        f"{sorted(spread)}: {self._spread_desc(spread)} — "
                        f"an unroutable dual-write (its checks and "
                        f"updates cannot land on one leader)"))
        for t in sorted(self.assignments):
            if t not in schema.definitions:
                warnings.append((
                    f"partition-map {t}",
                    f"partition map assigns type {t!r} to shard "
                    f"{self.assignments[t]}, but the schema defines no "
                    f"such type — tuples of a mistyped name would route "
                    f"to the default shard instead"))
        return errors, warnings

    @staticmethod
    def _spread_desc(spread: dict) -> str:
        return "; ".join(f"shard {k} holds {', '.join(v)}"
                         for k, v in sorted(spread.items()))

    def _rule_type_sets(self, schema: sch.Schema,
                        rule_configs: Iterable) -> list:
        """(rule_name, closure-expanded resource types) per rule: every
        type a rule's templates name, each expanded through its
        footprint closure when the template names a real permission or
        relation."""
        from ..schema_lint import _iter_rule_templates, _parse_template
        by_rule: dict = {}
        for rule_name, tpl in _iter_rule_templates(rule_configs or ()):
            parsed = _parse_template(tpl)
            if parsed is None:
                continue
            rtype, rel, stype, srel = parsed
            types = by_rule.setdefault(rule_name, set())
            types.add(rtype)
            d = schema.definitions.get(rtype)
            if d is not None and d.has_relation_or_permission(rel):
                types.update(t for t, _ in relation_footprint(schema,
                                                              rtype, rel))
            if srel and srel != "*":
                sd = schema.definitions.get(stype)
                if sd is not None and sd.has_relation_or_permission(srel):
                    types.add(stype)
                    types.update(
                        t for t, _ in relation_footprint(schema, stype,
                                                         srel))
        return sorted(by_rule.items())

    def describe(self) -> dict:
        return {"n_shards": self.n_shards,
                "default_shard": self.default_shard,
                "assignments": dict(sorted(self.assignments.items()))}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"PartitionMap(n_shards={self.n_shards}, "
                f"assignments={self.assignments}, "
                f"default_shard={self.default_shard})")


def partition_map_for_schema(schema: sch.Schema, n_shards: int,
                             default_shard: int = 0) -> PartitionMap:
    """Derive a footprint-compatible partition map for a schema: types
    entangled through any permission's closure form one co-location
    class (union-find over closure type sets), classes spread
    round-robin (largest first) over `n_shards`.  Used by the fuzz
    harness (random schemas need a valid map per seed) and as a
    starting point for operators."""
    parent: dict = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    types = [t for t in schema.definitions if t not in INTERNAL_TYPES]
    for t in types:
        find(t)
    for tname, d in schema.definitions.items():
        if tname in INTERNAL_TYPES:
            continue
        for pname in d.permissions:
            closure = {tname}
            closure.update(t for t, _ in relation_footprint(schema, tname,
                                                            pname))
            closure = [t for t in closure
                       if t not in INTERNAL_TYPES and t in schema.definitions]
            for other in closure[1:]:
                union(closure[0], other)
        # a relation's userset annotation (`viewer: group#member`)
        # entangles the referenced type even outside any permission
        for refs in d.relations.values():
            for ref in refs:
                if (ref.relation and ref.type in schema.definitions
                        and ref.type not in INTERNAL_TYPES):
                    union(tname, ref.type)
    classes: dict = {}
    for t in types:
        classes.setdefault(find(t), []).append(t)
    assignments: dict = {}
    ordered = sorted(classes.values(), key=lambda c: (-len(c), sorted(c)))
    for i, cls_types in enumerate(ordered):
        shard = i % n_shards
        for t in cls_types:
            assignments[t] = shard
    return PartitionMap(n_shards, assignments, default_shard=default_shard)
