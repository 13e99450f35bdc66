"""Random delta-stream generator + the shared fake clock.

The port's own copy of the reference generator (the JAX package's
fuzz/delta_gen.py), over the port's spicedb/types: the same seed draws
the same bursts, so the order of the `random.Random` calls below is part
of the contract and must not change.

A delta stream is a JSON-serializable list of BURSTS; each burst is one
atomic store operation:

    {"kind": "write",   "ops": [{"op": "touch"|"delete", "rel": "..."}]}
    {"kind": "dbf",     "resource_type": t, "relation": r, "resource_id": i}
    {"kind": "bulk",    "rels": ["...", ...]}
    {"kind": "advance", "dt": seconds}

Relationships serialize as `rel_string()` and round-trip through
`parse_relationship`, so a repro artifact is a plain-text description
of the exact store history.

Time is FAKE: every store in a fuzz run shares one `FakeClock`, and
the only way it moves is an explicit `advance` burst — so short-TTL
expiring tuples (the PAuth ephemeral-grant shape) are deterministic:
a tuple expiring 5 fake-seconds out is live until the stream says
otherwise, on the leader and on every replica, in the kernels, the
decision cache, and the oracle alike.

Pathological shapes generated on purpose:

- wildcard flips: `user:*` TOUCHed then DELETEd (graph rebuild paths);
- plane-less caveats: the first caveated tuple on a pair whose graph
  was built caveat-free (quarantine/rebuild under AsyncRebuild);
- already-expired writes (lazy expiry-heap delete path) and short-TTL
  writes crossed by later `advance` bursts (heap + cache invalidation);
- brand-new object ids (spare-pool assignment path);
- delete_by_filter wiping a whole (type, relation) slice;
- mid-stream bulk loads (reset listeners; replica re-bootstrap).
"""

from __future__ import annotations

import random

from ..spicedb import schema as sch
from ..spicedb.types import (
    CaveatRef,
    ObjectRef,
    Relationship,
    SubjectRef,
)

EPOCH = 1_700_000_000.0  # fuzz time zero (arbitrary, stable)


class FakeClock:
    """Deterministic time source shared by every store in a fuzz run."""

    def __init__(self, t0: float = EPOCH):
        self.t = float(t0)

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


class DeltaBias:
    """Stream-shape knobs the scenario profiles turn."""

    def __init__(self, delete=0.3, new_id=0.15, short_ttl=0.25,
                 expired=0.2, wildcard_boost=1.0, caveat_boost=1.0,
                 dbf=0.12, bulk=0.08, advance=0.22):
        self.delete = delete
        self.new_id = new_id
        self.short_ttl = short_ttl
        self.expired = expired
        self.wildcard_boost = wildcard_boost
        self.caveat_boost = caveat_boost
        self.dbf = dbf
        self.bulk = bulk
        self.advance = advance


DEFAULT_DELTA_BIAS = DeltaBias()


def id_universe(schema: sch.Schema, rng: random.Random) -> dict:
    """type -> list of object ids (small, so closures entangle)."""
    out = {}
    for tname in schema.definitions:
        n = rng.randint(3, 8)
        out[tname] = [f"{tname[:2]}{i}" for i in range(n)]
    return out


def _pick_id(rng: random.Random, ids: dict, tname: str,
             new_id_rate: float) -> str:
    pool = ids.get(tname, [tname[:2] + "0"])
    if rng.random() < new_id_rate:
        return f"{tname[:2]}{rng.randrange(10 * len(pool))}x"
    return rng.choice(pool)


def _caveat_context(rng: random.Random, caveat: sch.Caveat) -> dict:
    """Decided-true / decided-false / undecidable / empty contexts."""
    roll = rng.random()
    params = [name for name, _ in caveat.params]
    if roll < 0.25:
        return {}  # fully context-dependent (undecidable)
    ctx = {name: rng.randrange(6) for name in params}
    if roll < 0.5 and len(params) > 1:
        del ctx[rng.choice(params)]  # partially missing (undecidable)
    return ctx


def random_tuple(schema: sch.Schema, rng: random.Random, clock: FakeClock,
                 ids: dict, bias: DeltaBias) -> Relationship:
    """One schema-valid relationship, biased toward the nasty shapes."""
    # weighted (definition, relation, ref) choice: wildcard / caveated /
    # expiring annotations get their boost here
    choices = []
    for tname, d in schema.definitions.items():
        if tname == "user":
            continue
        for rname, refs in d.relations.items():
            for ref in refs:
                w = 1.0
                if ref.wildcard:
                    w *= 1.5 * bias.wildcard_boost
                if any(t != "expiration" for t in ref.traits):
                    w *= 1.5 * bias.caveat_boost
                if "expiration" in ref.traits:
                    w *= 1.3
                choices.append((w, tname, rname, ref))
    total = sum(c[0] for c in choices)
    x = rng.random() * total
    for w, tname, rname, ref in choices:
        x -= w
        if x <= 0:
            break
    resource = ObjectRef(tname, _pick_id(rng, ids, tname, bias.new_id))
    if ref.wildcard:
        subject = SubjectRef(ref.type, "*")
    elif ref.relation:
        subject = SubjectRef(ref.type, _pick_id(rng, ids, ref.type, 0.0),
                             ref.relation)
    else:
        subject = SubjectRef(ref.type,
                             _pick_id(rng, ids, ref.type, bias.new_id))
    caveat = None
    expires_at = None
    for trait in ref.traits:
        if trait == "expiration":
            roll = rng.random()
            if roll < bias.expired:
                expires_at = clock.now() - 3600.0  # already expired
            elif roll < bias.expired + bias.short_ttl:
                expires_at = clock.now() + rng.randint(3, 25)  # short TTL
            else:
                expires_at = clock.now() + 86400.0
        else:
            caveat = CaveatRef.make(
                trait, _caveat_context(rng, schema.caveats[trait]))
    return Relationship(resource=resource, relation=rname, subject=subject,
                        expires_at=expires_at, caveat=caveat)


def initial_rels(schema: sch.Schema, rng: random.Random, clock: FakeClock,
                 ids: dict, bias: DeltaBias, n: int) -> list:
    """Seed tuples: no brand-new ids (the pool path is for the stream)."""
    seed_bias = DeltaBias(new_id=0.0, short_ttl=bias.short_ttl,
                          expired=bias.expired,
                          wildcard_boost=bias.wildcard_boost,
                          caveat_boost=bias.caveat_boost)
    rels = {}
    for _ in range(n):
        rel = random_tuple(schema, rng, clock, ids, seed_bias)
        rels[rel.rel_string()] = rel
    return sorted(rels)


def generate_bursts(schema: sch.Schema, rng: random.Random,
                    clock: FakeClock, ids: dict, bias: DeltaBias,
                    n_bursts: int) -> list:
    """The delta stream (list of serialized bursts).  Clock is advanced
    HERE as the stream is generated so TTLs embed the right instants;
    replay re-applies the same advances in order."""
    bursts = []
    for _ in range(n_bursts):
        roll = rng.random()
        if roll < bias.advance:
            dt = rng.choice((1.0, 5.0, 12.0, 40.0, 3600.0))
            clock.advance(dt)
            bursts.append({"kind": "advance", "dt": dt})
        elif roll < bias.advance + bias.dbf:
            tname = rng.choice([t for t in schema.definitions
                                if t != "user"])
            d = schema.definitions[tname]
            relation = (rng.choice(sorted(d.relations))
                        if d.relations and rng.random() < 0.7 else "")
            rid = (_pick_id(rng, ids, tname, 0.0)
                   if rng.random() < 0.5 else "")
            bursts.append({"kind": "dbf", "resource_type": tname,
                           "relation": relation, "resource_id": rid})
        elif roll < bias.advance + bias.dbf + bias.bulk:
            rels = initial_rels(schema, rng, clock, ids, bias,
                                rng.randint(3, 10))
            bursts.append({"kind": "bulk", "rels": rels})
        else:
            ops = []
            for _ in range(rng.randint(1, 6)):
                rel = random_tuple(schema, rng, clock, ids, bias)
                if rng.random() < bias.delete:
                    # deletes key on identity: strip caveat/expiry attrs
                    ops.append({"op": "delete",
                                "rel": rel.rel_string().split("[")[0]})
                else:
                    ops.append({"op": "touch", "rel": rel.rel_string()})
            bursts.append({"kind": "write", "ops": ops})
    return bursts
