"""Benchmark workload models: the BASELINE.json config sweep.

Each generator returns (schema_text, relationships, query_subjects,
resource_type, permission) for one of the five north-star configs
(BASELINE.md):

1. namespace list Filter, e2e/rules.yaml style (CPU-baseline scale)
2. 10k-pod list, 100k direct tuples, depth-1 (no rewrites)
3. user -> group -> team -> namespace nested groups, depth-4 recursion
4. intersection + exclusion userset rewrites (RBAC-with-deny)
5. 1M-tuple multi-tenant graph, 256 concurrent list subjects

plus `group_explosion`, the reference's Leopard deployment (its copy of
fuzz/scenarios.py `group_explosion`, which the reference bench runs as
`--config group-explosion`).
"""

from __future__ import annotations

import random
from dataclasses import dataclass


@dataclass
class Workload:
    name: str
    schema_text: str
    relationships: list          # rel strings
    subjects: list               # user ids issuing list requests
    resource_type: str
    permission: str
    expected_objects: int = 0    # size of the listed collection


NAMESPACE_SCHEMA = """
definition user {}
definition namespace {
  relation creator: user
  relation viewer: user
  permission view = viewer + creator
}
"""

PODS_DEPTH1_SCHEMA = """
definition user {}
definition pod {
  relation creator: user
  relation viewer: user
  permission view = viewer + creator
}
"""

NESTED_GROUPS_SCHEMA = """
definition user {}
definition group {
  relation member: user | group#member
}
definition team {
  relation member: user | group#member
}
definition namespace {
  relation viewer: team#member | group#member | user
  permission view = viewer
}
definition pod {
  relation namespace: namespace
  relation creator: user
  permission view = creator + namespace->view
}
"""

RBAC_DENY_SCHEMA = """
definition user {}
definition group {
  relation member: user | group#member
}
definition pod {
  relation assigned: user | group#member
  relation approved: group#member
  relation banned: user | group#member
  permission view = assigned & approved - banned
}
"""

CAVEATED_RBAC_SCHEMA = """
caveat within_quota(used int, quota int) { used < quota }
definition user {}
definition group {
  relation member: user | group#member | user with within_quota
}
definition pod {
  relation assigned: user | group#member | user with within_quota
  relation approved: group#member
  relation banned: user | group#member | user with within_quota
  permission view = assigned & approved - banned
}
"""

MULTITENANT_SCHEMA = """
definition user {}
definition group {
  relation member: user | group#member
}
definition tenant {
  relation admin: user
  relation member: user | group#member
  permission access = admin + member
}
definition namespace {
  relation tenant: tenant
  relation viewer: user | group#member
  permission view = viewer + tenant->access
}
definition pod {
  relation namespace: namespace
  relation creator: user
  permission view = creator + namespace->view
}
"""


def namespace_baseline(n_namespaces: int = 200, n_users: int = 50,
                       seed: int = 0) -> Workload:
    """Config 1: the deploy/rules.yaml namespace list filter shape."""
    rng = random.Random(seed)
    rels = []
    for ns in range(n_namespaces):
        rels.append(f"namespace:ns{ns}#creator@user:u{rng.randrange(n_users)}")
        for u in rng.sample(range(n_users), rng.randint(0, 3)):
            rels.append(f"namespace:ns{ns}#viewer@user:u{u}")
    return Workload(
        name="namespace-baseline",
        schema_text=NAMESPACE_SCHEMA,
        relationships=sorted(set(rels)),
        subjects=[f"u{i}" for i in range(n_users)],
        resource_type="namespace",
        permission="view",
        expected_objects=n_namespaces,
    )


def pods_depth1(n_pods: int = 10_000, n_users: int = 1_000,
                n_tuples: int = 100_000, seed: int = 1) -> Workload:
    """Config 2: 10k-pod list, 100k direct tuples, no rewrites."""
    rng = random.Random(seed)
    rels = set()
    while len(rels) < n_tuples:
        p = rng.randrange(n_pods)
        u = rng.randrange(n_users)
        rel = "viewer" if rng.random() < 0.8 else "creator"
        rels.add(f"pod:ns{p % 100}/p{p}#{rel}@user:u{u}")
    return Workload(
        name="pods-depth1",
        schema_text=PODS_DEPTH1_SCHEMA,
        relationships=sorted(rels),
        subjects=[f"u{i}" for i in range(n_users)],
        resource_type="pod",
        permission="view",
        expected_objects=n_pods,
    )


def nested_groups(n_pods: int = 10_000, n_users: int = 2_000,
                  n_groups: int = 200, n_teams: int = 40,
                  n_namespaces: int = 100, seed: int = 2) -> Workload:
    """Config 3: user -> group -> group -> team -> namespace, depth-4
    recursive rewrite reaching pods through an arrow."""
    rng = random.Random(seed)
    rels = set()
    for u in range(n_users):
        rels.add(f"group:g{rng.randrange(n_groups)}#member@user:u{u}")
    for g in range(n_groups):
        if g % 3 == 0 and g + 1 < n_groups:
            rels.add(f"group:g{g + 1}#member@group:g{g}#member")
        rels.add(f"team:t{g % n_teams}#member@group:g{g}#member")
    for ns in range(n_namespaces):
        rels.add(f"namespace:ns{ns}#viewer@team:t{rng.randrange(n_teams)}#member")
    for p in range(n_pods):
        ns = p % n_namespaces
        rels.add(f"pod:ns{ns}/p{p}#namespace@namespace:ns{ns}")
        if rng.random() < 0.1:
            rels.add(f"pod:ns{ns}/p{p}#creator@user:u{rng.randrange(n_users)}")
    return Workload(
        name="nested-groups-depth4",
        schema_text=NESTED_GROUPS_SCHEMA,
        relationships=sorted(rels),
        subjects=[f"u{i}" for i in range(n_users)],
        resource_type="pod",
        permission="view",
        expected_objects=n_pods,
    )


def rbac_deny(n_pods: int = 10_000, n_users: int = 2_000,
              n_groups: int = 100, seed: int = 3) -> Workload:
    """Config 4: intersection + exclusion (assigned & approved - banned)."""
    rng = random.Random(seed)
    rels = set()
    for u in range(n_users):
        rels.add(f"group:g{rng.randrange(n_groups)}#member@user:u{u}")
        if rng.random() < 0.05:
            rels.add(f"group:blocked#member@user:u{u}")
    for p in range(n_pods):
        g = rng.randrange(n_groups)
        rels.add(f"pod:ns{p % 100}/p{p}#assigned@group:g{g}#member")
        rels.add(f"pod:ns{p % 100}/p{p}#approved@group:g{(g + rng.randrange(2)) % n_groups}#member")
        if rng.random() < 0.3:
            rels.add(f"pod:ns{p % 100}/p{p}#banned@group:blocked#member")
    return Workload(
        name="rbac-deny",
        schema_text=RBAC_DENY_SCHEMA,
        relationships=sorted(rels),
        subjects=[f"u{i}" for i in range(n_users)],
        resource_type="pod",
        permission="view",
        expected_objects=n_pods,
    )


def caveated_rbac(n_pods: int = 10_000, n_users: int = 2_000,
                  n_groups: int = 100, caveat_fraction: float = 0.15,
                  seed: int = 7) -> Workload:
    """Caveat-heavy variant of config 4 (round-4 VERDICT item 5): a
    `caveat_fraction` share of membership/assignment/ban tuples carry an
    UNDECIDABLE caveat (context lacks the quota), exercising the tri-state
    definite/maybe bitplane path of the ELL kernel — previously these
    queries dropped to the recursive host oracle at ~1.8e3 checks/s."""
    rng = random.Random(seed)

    def maybe_caveat():
        if rng.random() < caveat_fraction:
            # one in three carries a DECIDED context (compile-time resolve)
            roll = rng.random()
            if roll < 0.2:
                return '[caveat:within_quota:{"used": 1, "quota": 5}]'
            if roll < 0.33:
                return '[caveat:within_quota:{"used": 9, "quota": 5}]'
            return '[caveat:within_quota:{"used": 1}]'  # undecidable
        return ""

    rels = set()
    for u in range(n_users):
        rels.add(f"group:g{rng.randrange(n_groups)}#member@user:u{u}"
                 f"{maybe_caveat()}")
        if rng.random() < 0.05:
            rels.add(f"group:blocked#member@user:u{u}")
    for p in range(n_pods):
        g = rng.randrange(n_groups)
        rels.add(f"pod:ns{p % 100}/p{p}#assigned@group:g{g}#member")
        rels.add(f"pod:ns{p % 100}/p{p}#approved@group:"
                 f"g{(g + rng.randrange(2)) % n_groups}#member")
        if rng.random() < 0.3:
            rels.add(f"pod:ns{p % 100}/p{p}#banned@group:blocked#member")
        if rng.random() < 0.1:
            rels.add(f"pod:ns{p % 100}/p{p}#banned@user:"
                     f"u{rng.randrange(n_users)}{maybe_caveat()}")
    return Workload(
        name="caveats-rbac",
        schema_text=CAVEATED_RBAC_SCHEMA,
        relationships=sorted(rels),
        subjects=[f"u{i}" for i in range(n_users)],
        resource_type="pod",
        permission="view",
        expected_objects=n_pods,
    )


def multitenant_1m(n_tenants: int = 100, n_users: int = 50_000,
                   n_groups: int = 2_000, n_namespaces: int = 2_000,
                   n_pods: int = 200_000, n_tuples: int = 1_000_000,
                   cold_subjects: float = 0.0, seed: int = 4) -> Workload:
    """Config 5: ~1M-tuple multi-tenant graph; subjects for 256 concurrent
    list requests.

    `cold_subjects` is the fraction of QUERY subjects that appear in no
    tuple at all (first-contact users): they exercise the phantom-column
    path instead of the compiled per-user columns (round-1 VERDICT item 7
    demanded a no-cliff bench for this)."""
    rng = random.Random(seed)
    rels = set()
    for u in range(n_users):
        rels.add(f"group:g{rng.randrange(n_groups)}#member@user:u{u}")
    for g in range(n_groups):
        t = rng.randrange(n_tenants)
        rels.add(f"tenant:t{t}#member@group:g{g}#member")
        if g % 7 == 0 and g + 1 < n_groups:
            rels.add(f"group:g{g + 1}#member@group:g{g}#member")
    for t in range(n_tenants):
        rels.add(f"tenant:t{t}#admin@user:u{rng.randrange(n_users)}")
    for ns in range(n_namespaces):
        rels.add(f"namespace:ns{ns}#tenant@tenant:t{ns % n_tenants}")
        if rng.random() < 0.2:
            rels.add(f"namespace:ns{ns}#viewer@group:g{rng.randrange(n_groups)}#member")
    for p in range(n_pods):
        ns = p % n_namespaces
        rels.add(f"pod:ns{ns}/p{p}#namespace@namespace:ns{ns}")
    # top up to the tuple target with direct pod viewers
    while len(rels) < n_tuples:
        p = rng.randrange(n_pods)
        rels.add(f"pod:ns{p % n_namespaces}/p{p}#viewer@user:u{rng.randrange(n_users)}")
    subjects = [f"u{i}" for i in range(n_users)]
    if cold_subjects > 0:
        n_cold = int(len(subjects) * cold_subjects)
        subjects[:n_cold] = [f"cold{i}" for i in range(n_cold)]
        rng.shuffle(subjects)
    return Workload(
        name="multitenant-1m",
        schema_text=MULTITENANT_SCHEMA,
        relationships=sorted(rels),
        subjects=subjects,
        resource_type="pod",
        permission="view",
        expected_objects=n_pods,
    )


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


def group_explosion(n_groups: int = 100_000, n_users: int = 2_000,
                    n_docs: int = 5_000, depth: int = 8,
                    seed: int = 15) -> Workload:
    """Leopard's headline shape: `n_groups` groups arranged in disjoint
    membership chains of length `depth` (every user membership enters at
    the chain TAIL, so reaching a chain-head group — and any doc shared
    with it — costs `depth` userset hops), docs shared with chain heads.
    Pure union/userset rewrites: every pair is Leopard-eligible, so the
    index collapses the depth-8 walk to one closure-plane probe."""
    rng = random.Random(seed)
    n_chains = max(1, n_groups // depth)
    rels = set()
    for c in range(n_chains):
        base = c * depth
        for i in range(depth - 1):
            # members of g{base+i+1} are members of g{base+i}: the chain
            # HEAD (g{base}) is `depth` hops from the user
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
