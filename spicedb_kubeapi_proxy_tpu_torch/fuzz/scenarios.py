"""The scenario workloads (caveat-heavy, wildcard-public, ephemeral
grants, and the Leopard group-explosion shape) and their fuzzer bias
profiles: the port's own copy of the reference's fuzz/scenarios.py, on
the port's models/workloads.py `Workload`.  At the same arguments the
schemas and tuples equal the reference's.

Each scenario ships twice:

- as a bench workload (`SCENARIO_WORKLOADS`), each churn round of which
  a bench can hold against the host oracle over the same store, with
  `delta_gen.FakeClock` as the ephemeral grants' clock;
- as a (SchemaBias, DeltaBias) pair that steers the random fuzzer's
  generators toward the scenario's shape, so the budgeted search
  (`python -m spicedb_kubeapi_proxy_tpu_torch.fuzz --budget-seconds N
  --scenario X`) keeps hammering the same seam with schemas nobody
  hand-wrote.

The workloads:

- **caveat-heavy**   CEL-caveated tuples at scale: decided-true /
  decided-false / undecidable contexts on membership + assignment +
  ban relations, decided on the device's tri-state planes or, for
  residuals, by the host oracle.
- **wildcard-public**  wildcard-heavy public resources (`user:*`): a
  fraction of docs world-readable, churn FLIPS wildcards on and off —
  the graph-rebuild path the kernels cannot absorb in place.
- **ephemeral-grants** PAuth-style task-scoped grants: short-TTL
  expiring tuples at high churn against the store's fake clock —
  stressing the store's expiry heap, decision-cache invalidation,
  rebuild absorption and (via the fuzzer's follower roles) replica
  expiry reseeding all at once.
- **group-explosion / nested-groups**  deep recursive group nesting at
  scale: 100k groups chained depth 8+ under pure union/userset/arrow
  rewrites — the exact shape the Leopard materialized closure index
  (ops/leopard.py) flattens to one AND+popcount.  The workload is
  named `group-explosion`; the fuzzer bias profile steering the random
  generators toward the same shape (membership-only subgraphs, deep
  userset chains, near-zero caveats/wildcards) is `nested-groups`.
"""

from __future__ import annotations

import random

from ..models.workloads import Workload
from .delta_gen import DeltaBias
from .schema_gen import SchemaBias

CAVEAT_HEAVY_SCHEMA = """
caveat within_quota(used int, quota int) { used < quota }
caveat min_level(level int) { level > 2 }
definition user {}
definition group {
  relation member: user | group#member | user with within_quota
}
definition doc {
  relation assigned: user | group#member | user with within_quota
  relation approved: group#member | user with min_level
  relation banned: user | user with min_level
  permission view = assigned & approved - banned
}
"""

WILDCARD_PUBLIC_SCHEMA = """
definition user {}
definition group {
  relation member: user | group#member
}
definition doc {
  relation public: user:*
  relation viewer: user | group#member
  relation banned: user
  permission view = (viewer + public) - banned
}
"""

EPHEMERAL_GRANTS_SCHEMA = """
definition user {}
definition task {
  relation runner: user
}
definition doc {
  relation owner: user
  relation grant: user with expiration | task
  permission view = owner + grant + grant->runner
}
"""


GROUP_EXPLOSION_SCHEMA = """
definition user {}
definition group {
  relation member: user | group#member
}
definition doc {
  relation viewer: group#member | user
  permission view = viewer
}
"""


def _ctx(rng: random.Random):
    roll = rng.random()
    if roll < 0.3:
        return '[caveat:within_quota:{"used": 1, "quota": 5}]'   # true
    if roll < 0.5:
        return '[caveat:within_quota:{"used": 9, "quota": 5}]'   # false
    return '[caveat:within_quota:{"used": 1}]'                   # undecidable


def caveat_heavy(n_docs: int = 3000, n_users: int = 400, n_groups: int = 40,
                 caveat_fraction: float = 0.5, seed: int = 12) -> Workload:
    rng = random.Random(seed)
    rels = set()
    for u in range(n_users):
        cav = _ctx(rng) if rng.random() < caveat_fraction else ""
        rels.add(f"group:g{u % n_groups}#member@user:u{u}{cav}")
    for d in range(n_docs):
        g = rng.randrange(n_groups)
        if rng.random() < caveat_fraction:
            rels.add(f"doc:d{d}#assigned@user:u{rng.randrange(n_users)}"
                     f"{_ctx(rng)}")
        else:
            rels.add(f"doc:d{d}#assigned@group:g{g}#member")
        if rng.random() < 0.3:
            lvl = rng.randrange(6)
            rels.add(f"doc:d{d}#approved@user:u{rng.randrange(n_users)}"
                     f'[caveat:min_level:{{"level": {lvl}}}]')
        rels.add(f"doc:d{d}#approved@group:g{g}#member")
        if rng.random() < 0.2:
            rels.add(f"doc:d{d}#banned@user:u{rng.randrange(n_users)}")
    return Workload(name="caveat-heavy", schema_text=CAVEAT_HEAVY_SCHEMA,
                    relationships=sorted(rels),
                    subjects=[f"u{i}" for i in range(n_users)],
                    resource_type="doc", permission="view",
                    expected_objects=n_docs)


def wildcard_public(n_docs: int = 4000, n_users: int = 400,
                    n_groups: int = 40, public_fraction: float = 0.25,
                    seed: int = 13) -> Workload:
    rng = random.Random(seed)
    rels = set()
    for u in range(n_users):
        rels.add(f"group:g{u % n_groups}#member@user:u{u}")
    for d in range(n_docs):
        if rng.random() < public_fraction:
            rels.add(f"doc:d{d}#public@user:*")
        rels.add(f"doc:d{d}#viewer@group:g{rng.randrange(n_groups)}#member")
        if rng.random() < 0.15:
            rels.add(f"doc:d{d}#banned@user:u{rng.randrange(n_users)}")
    return Workload(name="wildcard-public", schema_text=WILDCARD_PUBLIC_SCHEMA,
                    relationships=sorted(rels),
                    subjects=[f"u{i}" for i in range(n_users)],
                    resource_type="doc", permission="view",
                    expected_objects=n_docs)


def ephemeral_grants(n_docs: int = 3000, n_users: int = 300,
                     n_tasks: int = 60, grant_fraction: float = 0.5,
                     now: float = 0.0, ttl_s: float = 30.0,
                     seed: int = 14) -> Workload:
    """Short-TTL grants are stamped relative to `now` (the bench passes
    its fake clock's origin); half the granted docs also carry durable
    owner/task routes so expiry changes answers, not just sizes."""
    rng = random.Random(seed)
    rels = set()
    for t in range(n_tasks):
        rels.add(f"task:t{t}#runner@user:u{rng.randrange(n_users)}")
    for d in range(n_docs):
        rels.add(f"doc:d{d}#owner@user:u{rng.randrange(n_users)}")
        if rng.random() < grant_fraction:
            u = rng.randrange(n_users)
            exp = now + ttl_s * (0.2 + 0.8 * rng.random())
            rels.add(f"doc:d{d}#grant@user:u{u}[expiration:{exp}]")
        if rng.random() < 0.2:
            rels.add(f"doc:d{d}#grant@task:t{rng.randrange(n_tasks)}")
    return Workload(name="ephemeral-grants",
                    schema_text=EPHEMERAL_GRANTS_SCHEMA,
                    relationships=sorted(rels),
                    subjects=[f"u{i}" for i in range(n_users)],
                    resource_type="doc", permission="view",
                    expected_objects=n_docs)


def group_explosion(n_groups: int = 100_000, n_users: int = 2_000,
                    n_docs: int = 5_000, depth: int = 8,
                    seed: int = 15) -> Workload:
    """Leopard's headline shape: `n_groups` groups arranged in disjoint
    membership chains of length `depth` (every user membership enters at
    the chain TAIL, so reaching a chain-head group — and any doc shared
    with it — costs `depth` userset hops), docs shared with chain
    heads.  Pure union/userset rewrites: every pair is
    Leopard-eligible, so the index collapses the depth-8 walk to one
    closure-plane probe."""
    rng = random.Random(seed)
    n_chains = max(1, n_groups // depth)
    rels = set()
    for c in range(n_chains):
        base = c * depth
        for i in range(depth - 1):
            # members of g{base+i+1} are members of g{base+i}: the
            # chain HEAD (g{base}) is `depth` hops from the user
            rels.add(f"group:g{base + i}#member"
                     f"@group:g{base + i + 1}#member")
        rels.add(f"group:g{base + depth - 1}#member@user:u{c % n_users}")
    for d in range(n_docs):
        head = rng.randrange(n_chains) * depth
        rels.add(f"doc:d{d}#viewer@group:g{head}#member")
    return Workload(name="group-explosion",
                    schema_text=GROUP_EXPLOSION_SCHEMA,
                    relationships=sorted(rels),
                    subjects=[f"u{i}" for i in range(n_users)],
                    resource_type="doc", permission="view",
                    expected_objects=n_docs)


# fuzzer bias profiles: the budgeted random search steered toward each
# scenario's shape (`python -m spicedb_kubeapi_proxy_tpu_torch.fuzz
# --scenario`)
SCENARIO_BIASES = {
    "caveat-heavy": (
        SchemaBias(caveat=0.6, wildcard=0.05, expiration=0.05),
        DeltaBias(caveat_boost=3.0, short_ttl=0.05, expired=0.05)),
    "wildcard-public": (
        SchemaBias(wildcard=0.45, caveat=0.05, expiration=0.05),
        DeltaBias(wildcard_boost=3.0, delete=0.4)),
    "ephemeral-grants": (
        SchemaBias(expiration=0.5, caveat=0.08, wildcard=0.05),
        DeltaBias(short_ttl=0.6, expired=0.1, advance=0.35)),
    # the Leopard shape: membership-only subgraphs (deep usersets and
    # arrows, near-zero caveat/wildcard/expiration so fragments stay
    # eligible, SOME exclusion/intersection so the planner's
    # ineligibility edges get hammered too) under delete-heavy churn
    # (the quarantine -> background re-close path)
    "nested-groups": (
        SchemaBias(userset=0.65, arrow=0.6, caveat=0.04, wildcard=0.03,
                   expiration=0.04, exclusion=0.08, intersection=0.06),
        DeltaBias(delete=0.4, caveat_boost=0.3, wildcard_boost=0.3,
                  short_ttl=0.05, expired=0.05, bulk=0.12)),
}

# the fixed-seed leopard smoke cells run the same shape universe at the
# smoke size cap (cheap kernel compiles, same contract as SMOKE_BIAS)
NESTED_GROUPS_SMOKE_BIAS = SchemaBias(
    userset=0.65, arrow=0.6, caveat=0.04, wildcard=0.03, expiration=0.04,
    exclusion=0.08, intersection=0.06, n_types=(2, 2, 2),
    n_rels=(2, 2, 3), n_perms=(1, 1, 2), expr_depth=1)

SCENARIO_WORKLOADS = {
    "caveat-heavy": caveat_heavy,
    "wildcard-public": wildcard_public,
    "ephemeral-grants": ephemeral_grants,
    "group-explosion": group_explosion,
}
