"""Static schema/rule lint (the reference's spicedb/schema_lint.py; its
findings and messages are the reference's, budget numbers included).

Cedar's design argument (PAPERS.md) is that an authorization language
should be *analyzable*: most policy bugs are reachable by static
inspection, before any request is served.  The proxy already has the
machinery — `ops.graph_compile.relation_footprint` is the transitive
"which relations can influence this permission" closure the decision
cache invalidates by — so the lint is cheap:

  SL001 (error)  rule template references an undefined type
  SL002 (error)  rule template references an undefined relation or
                 permission on its type (including the subject's
                 `#subrelation`)
  SL003 (warn)   permission with an EMPTY footprint: no tuple anywhere
                 can ever grant it (e.g. `permission x = nil`) — every
                 check is statically DENY
  SL004 (warn)   unreachable relation: no permission's footprint
                 includes it and no rule template reads it directly —
                 tuples written to it can never influence a decision
  SL005 (error)  caveated relation references an undefined caveat name:
                 a rule template writes `[caveat:name:...]` (or a
                 programmatically-built schema annotates `with name`)
                 for a caveat the schema never declares — every such
                 write fails at runtime
  SL006 (warn)   relation only reachable through an expiring path:
                 every route from a permission to it crosses a
                 `with expiration` subject annotation, so once those
                 expiring tuples lapse its tuples can never influence
                 a decision again (the PAuth ephemeral-grant footgun:
                 durable grants parked behind ephemeral indirection)
  SL007 (error)  a permission or rule template whose relation_footprint
                 closure spans two shards of the configured partition
                 map (spicedb/sharding): an unroutable dual-write — no
                 single shard leader can evaluate or apply it
                 atomically (only with a partition map configured)
  SL008 (warn)   a partition map key naming a type absent from the
                 schema: tuples of a mistyped name silently route to
                 the default shard
  SL009 (warn)   permission that is Leopard-eligible (pure
                 group-membership fragment, ops/leopard.py) but whose
                 estimated closure exceeds the configured byte budget
                 (SPICEDB_TPU_LEOPARD_BUDGET_BYTES) at the assumed
                 universe size (SPICEDB_TPU_LEOPARD_LINT_OBJECTS,
                 default 100000 objects/type) — the pair stays on the
                 iterative kernel and operators should know why

Proxy-internal definitions (lock / workflow / activity — the dual-write
engine's bookkeeping, spicedb/endpoints.py INTERNAL_SCHEMA) are exempt
from reachability: the engine reads them through its own code paths,
not through permissions.

Run via the CLI: `python -m spicedb_kubeapi_proxy_tpu_torch --lint-schema
[--spicedb-bootstrap x.yaml] [--rule-config rules.yaml]
[--lint-schema-strict] [--lint-schema-json]`.  SL009 reads this
package's Leopard budget (ops/leopard.py `budget_bytes`,
`estimate_fragment_bytes`).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

from . import schema as sch
from ..ops.graph_compile import relation_footprint

# assumed per-type object count for the SL009 closure-size estimate
LEOPARD_LINT_OBJECTS_ENV = "SPICEDB_TPU_LEOPARD_LINT_OBJECTS"
DEFAULT_LEOPARD_LINT_OBJECTS = 100_000


def _leopard_assumed_objects() -> int:
    try:
        return int(os.environ.get(LEOPARD_LINT_OBJECTS_ENV,
                                  DEFAULT_LEOPARD_LINT_OBJECTS))
    except ValueError:
        return DEFAULT_LEOPARD_LINT_OBJECTS

# definitions the dual-write engine owns (endpoints.INTERNAL_SCHEMA):
# written/read by engine code, not by schema permissions
INTERNAL_TYPES = frozenset(("lock", "workflow", "activity"))

_TPL_RE = re.compile(
    r"^(?P<rtype>[A-Za-z0-9_/]+):(?P<rid>.*)"
    r"#(?P<rel>[A-Za-z0-9_]+)"
    r"@(?P<stype>[A-Za-z0-9_/]+):(?P<sid>[^#]*)"
    r"(?:#(?P<srel>[A-Za-z0-9_*]+))?$")

# `[caveat:name]` / `[caveat:name:{...}]` suffixes on rule templates
_TPL_CAVEAT_RE = re.compile(r"\[caveat:([A-Za-z_][\w/]*)")


@dataclass
class Finding:
    code: str
    severity: str  # "error" | "warn"
    where: str     # "rule <name>" | "type#relation" | "type#permission"
    message: str


def _iter_rule_templates(rule_configs):
    """Yield (rule_name, template_string) for every relationship-shaped
    template a ProxyRule can carry (checks, post-checks, pre/post
    filters, update ops, preconditions)."""
    for cfg in rule_configs:
        spec = cfg.spec
        groups = [spec.checks, spec.post_checks,
                  spec.update.creates, spec.update.touches,
                  spec.update.deletes, spec.update.delete_by_filter,
                  spec.update.precondition_exists,
                  spec.update.precondition_does_not_exist]
        for pf in spec.pre_filters:
            if pf.lookup_matching_resources is not None:
                groups.append([pf.lookup_matching_resources])
        for pf in spec.post_filters:
            if pf.check_permission_template is not None:
                groups.append([pf.check_permission_template])
        for group in groups:
            for st in group:
                if getattr(st, "template", ""):
                    yield cfg.name, st.template
                rt = getattr(st, "relationship_template", None)
                if rt is not None:
                    res, sub = rt.resource, rt.subject
                    tpl = (f"{res.type}:{res.id or 'x'}#{res.relation}"
                           f"@{sub.type}:{sub.id or 'x'}"
                           + (f"#{sub.relation}" if sub.relation else ""))
                    yield cfg.name, tpl


def _parse_template(tpl: str):
    """-> (rtype, rel, stype, srel) or None when the string is not a
    single relationship template (tupleSets, exotic expressions)."""
    mm = _TPL_RE.match(tpl.split("[", 1)[0].strip())
    if mm is None:
        return None
    return (mm.group("rtype"), mm.group("rel"), mm.group("stype"),
            mm.group("srel") or "")


def _nonexpiring_reachable(schema: sch.Schema) -> set:
    """(type, relation) pairs reachable from ANY permission without
    crossing a `with expiration` subject annotation — the complement
    (vs the full footprint union) is SL006's warning set."""
    seen: set = set()
    rels: set = set()
    stack: list = [(t, p) for t, d in schema.definitions.items()
                   for p in d.permissions]

    def push_expr(t: str, d: sch.Definition, e: sch.Expr) -> None:
        if isinstance(e, sch.RelRef):
            stack.append((t, e.name))
        elif isinstance(e, sch.Arrow):
            stack.append((t, e.left))
            for ref in d.relations.get(e.left, ()):
                if "expiration" not in ref.traits:
                    stack.append((ref.type, e.target))
        elif isinstance(e, (sch.Union, sch.Intersection)):
            for c in e.children:
                push_expr(t, d, c)
        elif isinstance(e, sch.Exclusion):
            push_expr(t, d, e.base)
            push_expr(t, d, e.subtract)

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
                if ref.relation and "expiration" not in ref.traits:
                    stack.append((ref.type, ref.relation))
            continue
        expr = d.permissions.get(n)
        if expr is not None:
            push_expr(t, d, expr)
    return rels


def lint_schema(schema: sch.Schema, rule_configs=(),
                partition_map=None) -> list:
    """Run every lint pass; returns Findings (errors first).  With a
    `partition_map` (spicedb/sharding PartitionMap) the sharding
    co-location passes (SL007/SL008) run too."""
    findings: list = []
    referenced: set = set()  # (type, relation) pairs rules read directly

    # -- SL007/SL008: partition-map co-location (spicedb/sharding) -----------
    if partition_map is not None:
        errors, warnings = partition_map.validate_schema(schema,
                                                         rule_configs or ())
        findings.extend(Finding("SL007", "error", where, msg)
                        for where, msg in errors)
        findings.extend(Finding("SL008", "warn", where, msg)
                        for where, msg in warnings)

    # -- SL001/SL002/SL005: rule templates vs the schema ---------------------
    for rule_name, tpl in _iter_rule_templates(rule_configs or ()):
        for cav_name in _TPL_CAVEAT_RE.findall(tpl):
            if cav_name not in schema.caveats:
                findings.append(Finding(
                    "SL005", "error", f"rule {rule_name}",
                    f"template {tpl!r} writes caveat {cav_name!r}, but "
                    f"the schema declares no such caveat — every write "
                    f"through this rule fails validation"))
        parsed = _parse_template(tpl)
        if parsed is None:
            continue  # not a single-relationship template; nothing to check
        rtype, rel, stype, srel = parsed
        where = f"rule {rule_name}"
        d = schema.definitions.get(rtype)
        if d is None:
            findings.append(Finding(
                "SL001", "error", where,
                f"template {tpl!r} references undefined type {rtype!r}"))
        elif not d.has_relation_or_permission(rel):
            findings.append(Finding(
                "SL002", "error", where,
                f"template {tpl!r} references {rtype}#{rel}, but "
                f"{rtype!r} defines no relation or permission {rel!r}"))
        else:
            referenced.add((rtype, rel))
            if rel in d.relations:
                referenced.update(
                    (ref.type, ref.relation) for ref in d.relations[rel]
                    if ref.relation)
        sd = schema.definitions.get(stype)
        if sd is None:
            findings.append(Finding(
                "SL001", "error", where,
                f"template {tpl!r} references undefined subject type "
                f"{stype!r}"))
        elif srel and srel != "*" and not sd.has_relation_or_permission(srel):
            findings.append(Finding(
                "SL002", "error", where,
                f"template {tpl!r} references subject {stype}#{srel}, "
                f"but {stype!r} defines no relation or permission "
                f"{srel!r}"))
        elif srel and srel != "*":
            referenced.add((stype, srel))

    # -- SL005 (schema side): annotated caveats must exist -------------------
    # the parser rejects these, but schemas can also be BUILT (merged
    # internal definitions, programmatic IR) — lint re-checks the
    # invariant so --lint-schema holds for every construction path
    for tname, d in sorted(schema.definitions.items()):
        for rname in sorted(d.relations):
            for ref in d.relations[rname]:
                for trait in ref.traits:
                    if trait != "expiration" and trait not in schema.caveats:
                        findings.append(Finding(
                            "SL005", "error", f"{tname}#{rname}",
                            f"relation {tname}#{rname} annotates subject "
                            f"{ref.type!r} with caveat {trait!r}, but the "
                            f"schema declares no such caveat"))

    # -- footprints ----------------------------------------------------------
    reachable: set = set()  # (type, relation) influencing some permission
    for tname, d in sorted(schema.definitions.items()):
        for pname in sorted(d.permissions):
            fp = relation_footprint(schema, tname, pname)
            reachable.update(fp)
            if not fp and tname not in INTERNAL_TYPES:
                findings.append(Finding(
                    "SL003", "warn", f"{tname}#{pname}",
                    f"permission {tname}#{pname} has an empty relation "
                    f"footprint: no tuple can ever grant it (statically "
                    f"DENY for every subject)"))

    # -- SL006: relations only reachable through an expiring path ------------
    nonexpiring = _nonexpiring_reachable(schema)
    for tname, rname in sorted(reachable - nonexpiring):
        if tname in INTERNAL_TYPES:
            continue
        if rname not in schema.definitions.get(
                tname, sch.Definition(tname)).relations:
            continue
        findings.append(Finding(
            "SL006", "warn", f"{tname}#{rname}",
            f"relation {tname}#{rname} is only reachable through an "
            f"expiring path: every route from a permission to it crosses "
            f"a `with expiration` annotation, so once those tuples lapse "
            f"its tuples can no longer influence any decision"))

    # a relation is also "used" when another relation's subject
    # annotation names it (`viewer: group#member` keeps group#member live)
    for tname, d in schema.definitions.items():
        for refs in d.relations.values():
            reachable.update((ref.type, ref.relation) for ref in refs
                             if ref.relation)

    for tname, d in sorted(schema.definitions.items()):
        if tname in INTERNAL_TYPES:
            continue
        for rname in sorted(d.relations):
            pair = (tname, rname)
            if pair in reachable or pair in referenced:
                continue
            findings.append(Finding(
                "SL004", "warn", f"{tname}#{rname}",
                f"relation {tname}#{rname} is unreachable: no "
                f"permission's footprint includes it and no proxy rule "
                f"reads it — tuples written to it can never influence a "
                f"decision"))

    # -- SL009: Leopard-eligible fragments over the closure byte budget ------
    from ..ops.leopard import (BUDGET_ENV, budget_bytes,
                               estimate_fragment_bytes, fragment_is_nested)
    budget = budget_bytes()
    assumed = _leopard_assumed_objects()
    for tname, d in sorted(schema.definitions.items()):
        if tname in INTERNAL_TYPES:
            continue
        for pname in sorted(d.permissions):
            # only nested fragments (userset/arrow chains) warn: a flat
            # union gains nothing from flattening, so staying iterative
            # is not a loss worth a finding
            if not fragment_is_nested(schema, tname, pname):
                continue
            est = estimate_fragment_bytes(schema, tname, pname, assumed)
            if est is not None and est > budget:
                findings.append(Finding(
                    "SL009", "warn", f"{tname}#{pname}",
                    f"permission {tname}#{pname} is Leopard-eligible but "
                    f"its estimated closure (~{est} bytes at {assumed} "
                    f"objects per type) exceeds the configured budget "
                    f"({budget} bytes, {BUDGET_ENV}) — the pair stays on "
                    f"the iterative kernel; raise the budget (or lower "
                    f"{LEOPARD_LINT_OBJECTS_ENV} if the assumed universe "
                    f"overshoots) to let the index materialize it"))

    findings.sort(key=lambda f: (f.severity != "error", f.code, f.where))
    return findings
