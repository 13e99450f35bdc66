"""Random schema generator for the port's differential fuzzer.

The port's own copy of the reference generator (the JAX package's
fuzz/schema_gen.py): a seed gives the same schema text byte for byte,
so a seed or an artifact names one case in both packages.  It rests on
the port's spicedb/schema.py and `relation_footprint`
(ops/graph_compile.py), whose scores pick among the candidates.

Generates schema SOURCE TEXT (artifacts must be self-contained and
human-readable), constrained so that:

- it parses and validates (`spicedb.schema.parse_schema`);
- `--lint-schema` reports no ERRORS (the only schema-only error class,
  SL005, cannot be emitted: every caveat a relation names is defined);
- permission expressions stay within a bounded rewrite depth;
- arrows only target types defined EARLIER in the emission order, so
  cross-type permission references form a DAG (tuple-graph recursion —
  `group#member` self-usersets — is still generated: the kernels
  iterate it, the evaluator cycle-detects it);
- every shape the kernels special-case appears with tunable bias:
  wildcards (`user:*`), CEL caveats (decided and undecidable), expiring
  relations, caveat+expiration combos, intersections/exclusions, and
  multi-hop arrow chains.

`generate_schema` draws several candidates and keeps the one whose
permissions have the largest summed `relation_footprint` closure —
the Cedar-style analyzability metric biasing the fuzzer toward
deep/entangled closures instead of trivially-shallow schemas.
"""

from __future__ import annotations

import random

from ..ops.graph_compile import relation_footprint
from ..spicedb import schema as sch

# subject-relation pool for object definitions; names are cosmetic but
# stable so seeds stay readable
_TYPE_POOL = ("org", "folder", "doc", "proj", "ns", "pod", "board")
_REL_POOL = ("viewer", "editor", "owner", "reader", "writer", "auditor",
             "banned", "approved", "assigned", "pinned")
_PERM_POOL = ("view", "edit", "admin", "audit", "operate")

_CAVEAT_BODIES = (
    ("cur int, max int", "cur < max"),
    ("used int, quota int", "used + 1 < quota"),
    ("level int", "level > 2"),
)


class SchemaBias:
    """Knobs the scenario profiles (fuzz/scenarios.py) and the smoke
    size cap turn."""

    def __init__(self, wildcard=0.18, caveat=0.22, expiration=0.18,
                 userset=0.45, arrow=0.5, exclusion=0.35,
                 intersection=0.35, n_types=(2, 2, 3, 3, 4),
                 n_rels=(2, 2, 3, 3, 4), n_perms=(1, 2, 2),
                 expr_depth=2):
        self.wildcard = wildcard
        self.caveat = caveat
        self.expiration = expiration
        self.userset = userset
        self.arrow = arrow
        self.exclusion = exclusion
        self.intersection = intersection
        self.n_types = n_types
        self.n_rels = n_rels
        self.n_perms = n_perms
        self.expr_depth = expr_depth


DEFAULT_BIAS = SchemaBias()

# the fixed-seed smoke matrix: same shape universe (wildcards, caveats,
# expirations, usersets, arrows, exclusions) but bounded schema size so
# a cell's kernel compile stays cheap — the open-ended budgeted search
# runs DEFAULT_BIAS depth
SMOKE_BIAS = SchemaBias(n_types=(2, 2, 2), n_rels=(2, 2, 3),
                        n_perms=(1, 1, 2), expr_depth=1)


def _gen_caveats(rng: random.Random) -> list:
    n = rng.choice((0, 1, 1, 2))
    out = []
    for i in range(n):
        params, body = _CAVEAT_BODIES[rng.randrange(len(_CAVEAT_BODIES))]
        out.append((f"cav{i}", params, body))
    return out


def _gen_relation_refs(rng: random.Random, bias: SchemaBias, caveats: list,
                       has_group: bool, earlier_types: list) -> list:
    """One relation's `|`-union of TypeRef source strings."""
    refs = []
    n_refs = rng.choice((1, 1, 2, 2, 3))
    for _ in range(n_refs):
        roll = rng.random()
        if roll < bias.wildcard:
            base = "user:*"
        elif roll < bias.wildcard + bias.userset and has_group:
            base = "group#member"
        elif (roll < bias.wildcard + bias.userset + 0.2
                and earlier_types and rng.random() < 0.6):
            # object-valued relation: the raw material for arrows
            base = rng.choice(earlier_types)
        else:
            base = "user"
        traits = []
        if base == "user":
            # SpiceDB trait rules: `user with c` accepts ONLY c-caveated
            # tuples, so plain/caveated/expiring variants are separate refs
            if caveats and rng.random() < bias.caveat:
                traits.append(rng.choice(caveats)[0])
            if rng.random() < bias.expiration:
                traits.append("expiration")
        elif base == "group#member" and rng.random() < bias.expiration * 0.6:
            traits.append("expiration")
        refs.append(base + (" with " + " and ".join(traits) if traits else ""))
    # dedupe while keeping order; always keep at least one ref
    seen, out = set(), []
    for r in refs:
        if r not in seen:
            seen.add(r)
            out.append(r)
    return out


def _gen_perm_expr(rng: random.Random, bias: SchemaBias, relations: dict,
                   earlier_perms: list, arrow_targets: dict,
                   depth: int = 0) -> str:
    """Random permission expression of bounded depth.

    `relations`: name -> ref strings for THIS definition;
    `arrow_targets`: object-valued relation name -> candidate target
    names on its subject types (earlier types only: cross-type DAG)."""

    def leaf() -> str:
        choices = list(relations)
        if earlier_perms:
            choices += earlier_perms
        if arrow_targets and rng.random() < bias.arrow:
            left = rng.choice(sorted(arrow_targets))
            return f"{left}->{rng.choice(sorted(arrow_targets[left]))}"
        return rng.choice(choices)

    if depth >= bias.expr_depth or rng.random() < 0.35:
        return leaf()
    a = _gen_perm_expr(rng, bias, relations, earlier_perms, arrow_targets,
                       depth + 1)
    b = _gen_perm_expr(rng, bias, relations, earlier_perms, arrow_targets,
                       depth + 1)
    roll = rng.random()
    if roll < bias.exclusion:
        expr = f"{a} - {b}"
    elif roll < bias.exclusion + bias.intersection:
        expr = f"{a} & {b}"
    else:
        expr = f"{a} + {b}"
    return f"({expr})" if depth > 0 else expr


def _gen_once(rng: random.Random, bias: SchemaBias) -> str:
    caveats = _gen_caveats(rng)
    has_group = rng.random() < 0.85
    n_types = rng.choice(bias.n_types)
    type_names = list(_TYPE_POOL[:n_types])
    rng.shuffle(type_names)

    lines = []
    for name, params, body in caveats:
        lines.append(f"caveat {name}({params}) {{ {body} }}")
    lines.append("definition user {}")
    if has_group:
        member_refs = ["user", "group#member"]
        if caveats and rng.random() < bias.caveat:
            member_refs.append(f"user with {caveats[0][0]}")
        lines.append("definition group { relation member: "
                     + " | ".join(member_refs) + " }")

    # (type, perm-or-rel names) emitted so far, for arrow targets
    emitted: dict = {}
    if has_group:
        emitted["group"] = ["member"]
    for ti, tname in enumerate(type_names):
        earlier = [t for t in type_names[:ti]]
        n_rels = rng.choice(bias.n_rels)
        relations: dict = {}
        rel_names = list(_REL_POOL)
        rng.shuffle(rel_names)
        for rname in rel_names[:n_rels]:
            relations[rname] = _gen_relation_refs(
                rng, bias, caveats, has_group, earlier)
        # arrow raw material: relations whose refs include a direct
        # object type (subject id walkable by an arrow)
        arrow_targets: dict = {}
        for rname, refs in relations.items():
            targets: set = set()
            for ref in refs:
                base = ref.split(" with ")[0]
                if base in emitted:
                    targets.update(emitted[base])
            if targets:
                arrow_targets[rname] = targets
        body = [f"  relation {rname}: {' | '.join(refs)}"
                for rname, refs in relations.items()]
        perms = []
        n_perms = rng.choice(bias.n_perms)
        perm_names = list(_PERM_POOL)
        rng.shuffle(perm_names)
        for pname in perm_names[:n_perms]:
            expr = _gen_perm_expr(rng, bias, relations, perms, arrow_targets)
            body.append(f"  permission {pname} = {expr}")
            perms.append(pname)
        lines.append(f"definition {tname} {{\n" + "\n".join(body) + "\n}")
        emitted[tname] = list(relations) + perms
    return "\n".join(lines) + "\n"


def footprint_score(schema: sch.Schema) -> int:
    """Entanglement metric: summed footprint closure over every
    permission plus the rewrite depth — bigger = deeper/more entangled."""
    total = 0
    for tname, d in schema.definitions.items():
        for pname in d.permissions:
            total += len(relation_footprint(schema, tname, pname))
    return total + schema.max_rewrite_depth()


def generate_schema(seed: int, bias: SchemaBias = DEFAULT_BIAS,
                    candidates: int = 3):
    """-> (schema_text, parsed Schema). Draws `candidates` schemas from
    sub-seeds of `seed` and keeps the one with the largest
    `footprint_score` — the relation_footprint bias toward
    deep/entangled closures."""
    best = None
    for k in range(candidates):
        # stable cross-process sub-seed (str hash() is salted per process)
        rng = random.Random(seed * 1_000_003 + k * 7919)
        text = _gen_once(rng, bias)
        schema = sch.parse_schema(text)
        score = footprint_score(schema)
        if best is None or score > best[0]:
            best = (score, text, schema)
    return best[1], best[2]
