"""The fuzz role: the reference's differential fuzz cases replayed on
`torch://`'s default read path.

Each case is the reference's own (`fuzz/driver.py` `build_case`, fully
derived from its seed): a generated schema, an initial load and a burst
stream of writes, deletes, delete-by-filter, bulk loads and clock
advances, under the default bias and each of the four scenario biases
(`fuzz/scenarios.py` `SCENARIO_BIASES`).  One `FakeClock` drives the
reference store, which the host oracle reads, and the port's store, which
four `torch://` endpoints share:

- `ell`:     batched dispatch, ELL kernel (the factory's default);
- `segment`: batched dispatch, segment kernel;
- `direct`:  `dispatch=direct`, ELL kernel, Leopard index off;
- `mesh`:    batched dispatch on a co-located 2 x 2 (data x graph) mesh.

After the load and after every burst, each endpoint answers the case's
queries — a lookup per target and subject, tri-state checks of up to 12
objects a target — issued concurrently, and every answer must equal the
reference oracle's `lookup_resources`/`check3`, as the reference's
`_compare_queries` holds them (`fuzz/driver.py:566-629`).  A divergence
prints its seed.  The endpoints run the port's defaults, off-loop
rebuilds included: a write they cannot absorb quarantines its pairs to
the oracle while a candidate builds in the background.  For a bias whose
writes force rebuilds (wildcard-public), the background installs and the
quarantine-routed reads summed over its cells must both be above zero,
so that path is shown to run, not bypassed.  The card leg runs the same seeds with `device="cuda"`
(the mesh on one card, repeated) and skips without a card.

The decision-cache legs are the reference fuzz harness's (`fuzz/driver.py:
412-466`): the plain, mesh and Leopard endpoints behind the decision
cache (`torch://?device=cpu&cache=1`; the Leopard one with
`dispatch=direct` and the index on), replayed on the same cells beside
`jax://` behind the reference's cache, on the reference's store.  Every
answer of each equals the oracle's and `jax://`'s, and after every step
each port cache's hit, miss, invalidation, eviction and fill counts and
resident bytes equal the reference cache's: the same queries and writes
reach every cache, whatever endpoint it fronts.

The sharded legs are the reference fuzz harness's `sharded2` role
(`fuzz/driver.py:101-105`, `:276-297`, `:335-371`): per case, the port's
`partition_map_for_schema(schema, 2)` (equal to the reference's, and
accepted by the footprint validation), two `torch://` shard stores fed
the case's stream routed by that map, and a `ShardedEndpoint` over one
endpoint a shard, whose answers after the load and after every burst
equal the oracle's over the whole stream.

The module imports nothing of jax (the jax endpoints of the cached
legs are imported inside their test), so the card leg runs on a
machine without it.

The reference's fuzz generator, store and evaluator import no jax:
`python -m pytest --noconftest tests/test_torch_fuzz.py -m cuda` runs
the card leg.
"""

import asyncio

import pytest
import torch

from spicedb_kubeapi_proxy_tpu.fuzz.delta_gen import (DEFAULT_DELTA_BIAS,
                                                      FakeClock)
from spicedb_kubeapi_proxy_tpu.fuzz.driver import build_case
from spicedb_kubeapi_proxy_tpu.fuzz.scenarios import SCENARIO_BIASES
from spicedb_kubeapi_proxy_tpu.fuzz.schema_gen import DEFAULT_BIAS
from spicedb_kubeapi_proxy_tpu.spicedb.evaluator import Evaluator
from spicedb_kubeapi_proxy_tpu.spicedb.store import TupleStore as RefStore
from spicedb_kubeapi_proxy_tpu.spicedb.types import (
    ObjectRef as RefObjectRef,
    RelationshipFilter as RefFilter,
    RelationshipUpdate as RefUpdate,
    SubjectRef as RefSubjectRef,
    UpdateOp as RefOp,
    parse_relationship as ref_parse)
from spicedb_kubeapi_proxy_tpu_torch.parallel.sharding import make_mesh
from spicedb_kubeapi_proxy_tpu_torch.spicedb.dispatch import BatchingEndpoint
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
    Bootstrap, create_endpoint)
from spicedb_kubeapi_proxy_tpu_torch.spicedb.store import TupleStore
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
    CheckRequest,
    ObjectRef,
    RelationshipFilter,
    RelationshipUpdate,
    SubjectRef,
    UpdateOp,
    parse_relationship)

P3 = {"NO_PERMISSION": 0, "CONDITIONAL_PERMISSION": 1, "HAS_PERMISSION": 2}

# (bias name, seeds): the default bias, then each scenario bias
CELLS = [("default", s) for s in range(5)] + [
    (name, 1000 + s) for name in sorted(SCENARIO_BIASES) for s in range(3)]
# biases whose writes force rebuilds (wildcard changes)
REBUILD_BIASES = ("wildcard-public",)
# (bias, seed, device) -> (background installs, quarantine-routed reads)
# summed over a replay's endpoints
_QUARANTINE: dict = {}


def _biases(name: str) -> tuple:
    if name == "default":
        return DEFAULT_BIAS, DEFAULT_DELTA_BIAS
    return SCENARIO_BIASES[name]


def _endpoints(schema_text: str, store, device: str) -> dict:
    url = "torch://" if device == "cuda" else "torch://?device=cpu"
    bs = Bootstrap(schema_text, "")
    eps = {
        "ell": create_endpoint(url, bs, store=store),
        "segment": create_endpoint(url, bs, store=store, kernel="segment"),
        "direct": create_endpoint(url, bs, store=store, dispatch="direct",
                                  leopard=False),
        "mesh": create_endpoint(url, bs, store=store, mesh=make_mesh(
            [device] * 4, data=2, graph=2)),
    }
    for name, ep in eps.items():
        assert isinstance(ep, BatchingEndpoint) == (name != "direct")
    return eps


def _apply(burst: dict, clock: FakeClock, ref: RefStore,
           port: TupleStore) -> None:
    """One burst on both stores (the reference replay's leader role)."""
    kind = burst["kind"]
    if kind == "advance":
        clock.advance(burst["dt"])
    elif kind == "write":
        ops = [(op["op"] == "delete", op["rel"]) for op in burst["ops"]]
        ref.write([RefUpdate(RefOp.DELETE if d else RefOp.TOUCH,
                             ref_parse(r)) for d, r in ops])
        port.write([RelationshipUpdate(UpdateOp.DELETE if d
                                       else UpdateOp.TOUCH,
                                       parse_relationship(r))
                    for d, r in ops])
    elif kind == "dbf":
        f = (burst["resource_type"], burst["relation"], burst["resource_id"])
        ref.delete_by_filter(RefFilter(resource_type=f[0], relation=f[1],
                                       resource_id=f[2]))
        port.delete_by_filter(RelationshipFilter(
            resource_type=f[0], relation=f[1], resource_id=f[2]))
    elif kind == "bulk":
        ref.bulk_load([ref_parse(r) for r in burst["rels"]])
        port.bulk_load([parse_relationship(r) for r in burst["rels"]])
    else:
        raise ValueError(f"unknown burst kind {kind!r}")


def _subject(s: str, cls):
    stype, _, rest = s.partition(":")
    sid, _, srel = rest.partition("#")
    return cls(stype, sid, srel)


async def _answers(ep, case, ids_of: dict) -> tuple:
    """The case's queries on `ep`, issued concurrently: sorted id lists
    per (target, subject), tri-state values per check call."""
    lookups = [ep.lookup_resources(rt, perm, _subject(s, SubjectRef))
               for rt, perm in case.targets for s in case.subjects]
    checks = [ep.check_bulk_permissions([
        CheckRequest(ObjectRef(rt, oid), perm, _subject(s, SubjectRef))
        for s in case.subjects])
        for rt, perm in case.targets for oid in ids_of[rt]]
    out = await asyncio.gather(*lookups, *checks)
    n = len(lookups)
    return ([sorted(x) for x in out[:n]],
            [[P3[r.permissionship.name] for r in c] for c in out[n:]])


def _oracle_answers(oracle: Evaluator, case, ids_of: dict) -> tuple:
    lookups = [sorted(oracle.lookup_resources(
        rt, perm, _subject(s, RefSubjectRef)))
        for rt, perm in case.targets for s in case.subjects]
    checks = [[oracle.check3(RefObjectRef(rt, oid), perm,
                             _subject(s, RefSubjectRef))
               for s in case.subjects]
              for rt, perm in case.targets for oid in ids_of[rt]]
    return lookups, checks


def _describe(case, ids_of, got, want) -> str:
    lk = [(t, s) for t in case.targets for s in case.subjects]
    for (t, s), g, w in zip(lk, got[0], want[0]):
        if g != w:
            return f"lookup {t[0]}#{t[1]}@{s}: port={g} oracle={w}"
    ck = [(t, oid) for t in case.targets for oid in ids_of[t[0]]]
    for (t, oid), g, w in zip(ck, got[1], want[1]):
        if g != w:
            return (f"check {t[0]}:{oid}#{t[1]} for {case.subjects}: "
                    f"port={g} oracle={w}")
    return "no difference"


def _cached_endpoints(schema_text: str, store, device: str) -> dict:
    """The reference fuzz harness's decision-cache legs on `torch://`."""
    url = ("torch://?cache=1" if device == "cuda"
           else "torch://?device=cpu&cache=1")
    bs = Bootstrap(schema_text, "")
    return {
        "ell": create_endpoint(url, bs, store=store),
        "mesh": create_endpoint(url, bs, store=store, mesh=make_mesh(
            [device] * 4, data=2, graph=2)),
        "leopard": create_endpoint(url, bs, store=store, dispatch="direct",
                                   leopard=True),
    }


def _ref_cached_endpoint(case, store):
    """`jax://` behind the reference's decision cache (fuzz/driver.py
    `build_endpoint`'s plain leg), over the reference store."""
    from spicedb_kubeapi_proxy_tpu.ops.jax_endpoint import JaxEndpoint
    from spicedb_kubeapi_proxy_tpu.spicedb.decision_cache import (
        DecisionCacheEndpoint)
    from spicedb_kubeapi_proxy_tpu.utils.features import GATES
    prev = GATES.enabled("LeopardIndex")
    try:
        GATES.set("LeopardIndex", False)
        return DecisionCacheEndpoint(JaxEndpoint(case.parsed_schema(),
                                                 store=store))
    finally:
        GATES.set("LeopardIndex", prev)


def _ref_answers(ep, case, ids_of: dict) -> tuple:
    """`_answers` with the reference package's request types."""
    from spicedb_kubeapi_proxy_tpu.spicedb.types import (
        CheckRequest as RefCheckRequest)

    async def go():
        lookups = [ep.lookup_resources(rt, perm, _subject(s, RefSubjectRef))
                   for rt, perm in case.targets for s in case.subjects]
        checks = [ep.check_bulk_permissions([
            RefCheckRequest(RefObjectRef(rt, oid), perm,
                            _subject(s, RefSubjectRef))
            for s in case.subjects])
            for rt, perm in case.targets for oid in ids_of[rt]]
        out = await asyncio.gather(*lookups, *checks)
        n = len(lookups)
        return ([sorted(x) for x in out[:n]],
                [[P3[r.permissionship.name] for r in c] for c in out[n:]])

    return asyncio.run(go())


def replay(bias: str, seed: int, device: str = "cpu",
           cached: bool = False) -> dict:
    """Replay one case on the four endpoints (`cached`: on the three
    decision-cache legs, beside the reference's on `jax://`); returns per
    endpoint the number of compared answers.  Raises on the first
    divergence, naming the seed."""
    schema_bias, delta_bias = _biases(bias)
    case = build_case(seed, schema_bias=schema_bias, delta_bias=delta_bias)
    clock = FakeClock()
    ref, port = RefStore(clock=clock.now), TupleStore(clock=clock.now)
    init = case.init_rels
    ref.bulk_load([ref_parse(r) for r in init])
    port.bulk_load([parse_relationship(r) for r in init])
    oracle = Evaluator(case.parsed_schema(), ref)
    if cached:
        eps = _cached_endpoints(case.schema_text, port, device)
        ref_ep = _ref_cached_endpoint(case, ref)
    else:
        eps, ref_ep = _endpoints(case.schema_text, port, device), None
    counts = dict.fromkeys(eps, 0)
    for step in range(-1, len(case.bursts)):
        if step >= 0:
            _apply(case.bursts[step], clock, ref, port)
        ids_of = {rt: ref.object_ids_of_type(rt)[:12]
                  for rt, _ in case.targets}
        want = _oracle_answers(oracle, case, ids_of)
        if ref_ep is not None:
            ref_got = _ref_answers(ref_ep, case, ids_of)
            ref_stats = (dict(ref_ep.cache.stats), ref_ep.cache.resident_bytes)
            if ref_got != want:
                raise AssertionError(f"jax:// diverges from the oracle: "
                                     f"seed={seed} bias={bias} step={step}")
        for name, ep in eps.items():
            got = asyncio.run(_answers(ep, case, ids_of))
            if got != want:
                msg = (f"DIVERGENCE seed={seed} bias={bias} endpoint={name} "
                       f"device={device} step={step} rev={ref.revision}: "
                       f"{_describe(case, ids_of, got, want)}")
                print(msg)
                raise AssertionError(msg)
            counts[name] += len(got[0]) + sum(len(c) for c in got[1])
            if ref_ep is not None:
                stats = (dict(ep.cache.stats), ep.cache.resident_bytes)
                if stats != ref_stats:
                    msg = (f"DIVERGENCE seed={seed} bias={bias} cached "
                           f"endpoint={name} step={step}: cache "
                           f"port={stats} reference={ref_stats}")
                    print(msg)
                    raise AssertionError(msg)
    for ep in eps.values():
        ep.wait_rebuilds()
    _QUARANTINE[(bias, seed, device)] = (
        sum(ep.stats["bg_rebuilds"] for ep in eps.values()),
        sum(ep.stats["stale_routed"] for ep in eps.values()))
    return counts


@pytest.mark.parametrize("bias,seed", CELLS)
def test_fuzz_case_answers_as_the_oracle(bias, seed):
    counts = replay(bias, seed)
    assert all(n > 0 for n in counts.values())


@pytest.mark.parametrize("bias,seed", CELLS)
def test_cached_fuzz_case_matches_jax_and_the_oracle(bias, seed):
    counts = replay(bias, seed, cached=True)
    assert set(counts) == {"ell", "mesh", "leopard"}
    assert all(n > 0 for n in counts.values())


@pytest.mark.parametrize("bias", REBUILD_BIASES)
def test_fuzz_bias_runs_the_quarantine_path(bias):
    """Summed over the bias's cells (replayed here unless this run already
    replayed them), background installs and quarantine-routed reads are
    both above zero."""
    bg = routed = 0
    for b, seed in CELLS:
        if b != bias:
            continue
        if (b, seed, "cpu") not in _QUARANTINE:
            replay(b, seed)
        n_bg, n_routed = _QUARANTINE[(b, seed, "cpu")]
        bg += n_bg
        routed += n_routed
    assert bg > 0 and routed > 0, (bg, routed)


def _route(burst: dict, clock: FakeClock, ref: RefStore, pmap,
           stores: list) -> None:
    """One burst on the reference store (the oracle's) and, routed by the
    partition map, on the shard stores (fuzz/driver.py `_route_burst`)."""
    kind = burst["kind"]
    if kind == "advance":
        clock.advance(burst["dt"])
    elif kind == "write":
        ops = [(op["op"] == "delete", op["rel"]) for op in burst["ops"]]
        ref.write([RefUpdate(RefOp.DELETE if d else RefOp.TOUCH,
                             ref_parse(r)) for d, r in ops])
        groups: dict = {}
        for d, r in ops:
            rel = parse_relationship(r)
            groups.setdefault(pmap.shard_of(rel.resource.type,
                                            rel.resource.id), []).append(
                RelationshipUpdate(UpdateOp.DELETE if d else UpdateOp.TOUCH,
                                   rel))
        for k, ups in sorted(groups.items()):
            stores[k].write(ups)
    elif kind == "dbf":
        f = (burst["resource_type"], burst["relation"], burst["resource_id"])
        ref.delete_by_filter(RefFilter(resource_type=f[0], relation=f[1],
                                       resource_id=f[2]))
        flt = RelationshipFilter(resource_type=f[0], relation=f[1],
                                 resource_id=f[2])
        for k in pmap.shards_for_filter(flt):
            stores[k].delete_by_filter(flt)
    elif kind == "bulk":
        ref.bulk_load([ref_parse(r) for r in burst["rels"]])
        _route_bulk(burst["rels"], pmap, stores)
    else:
        raise ValueError(f"unknown burst kind {kind!r}")


def _route_bulk(rels: list, pmap, stores: list) -> None:
    groups: dict = {}
    for r in rels:
        rel = parse_relationship(r)
        groups.setdefault(pmap.shard_of(rel.resource.type, rel.resource.id),
                          []).append(rel)
    for k, subset in sorted(groups.items()):
        stores[k].bulk_load(subset)


def replay_sharded(bias: str, seed: int, device: str = "cpu") -> int:
    """Replay one case through a `ShardedEndpoint` over two `torch://`
    shards (the reference fuzz's `sharded2` role); returns the number of
    compared answers.  Raises on the first divergence, naming the seed."""
    from spicedb_kubeapi_proxy_tpu.spicedb.sharding import (
        partition_map_for_schema as ref_partition_map)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb import schema as sch
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.sharding import (
        ShardedEndpoint, partition_map_for_schema)
    schema_bias, delta_bias = _biases(bias)
    case = build_case(seed, schema_bias=schema_bias, delta_bias=delta_bias)
    schema = sch.parse_schema(case.schema_text)
    pmap = partition_map_for_schema(schema, 2)
    assert pmap.validate_schema(schema)[0] == []
    assert pmap.describe() == ref_partition_map(case.parsed_schema(),
                                                2).describe()
    clock = FakeClock()
    ref = RefStore(clock=clock.now)
    stores = [TupleStore(clock=clock.now) for _ in range(2)]
    ref.bulk_load([ref_parse(r) for r in case.init_rels])
    _route_bulk(case.init_rels, pmap, stores)
    oracle = Evaluator(case.parsed_schema(), ref)
    url = "torch://" if device == "cuda" else "torch://?device=cpu"
    bs = Bootstrap(case.schema_text, "")
    ep = ShardedEndpoint(pmap, [create_endpoint(url, bs, store=st)
                                for st in stores], schema=schema)
    n = 0
    for step in range(-1, len(case.bursts)):
        if step >= 0:
            _route(case.bursts[step], clock, ref, pmap, stores)
        ids_of = {rt: ref.object_ids_of_type(rt)[:12]
                  for rt, _ in case.targets}
        want = _oracle_answers(oracle, case, ids_of)
        got = asyncio.run(_answers(ep, case, ids_of))
        if got != want:
            msg = (f"DIVERGENCE seed={seed} bias={bias} endpoint=sharded2 "
                   f"device={device} step={step} map={pmap.describe()}: "
                   f"{_describe(case, ids_of, got, want)}")
            print(msg)
            raise AssertionError(msg)
        n += len(got[0]) + sum(len(c) for c in got[1])
    ep.wait_rebuilds()
    return n


@pytest.mark.parametrize("bias,seed", CELLS)
def test_sharded_fuzz_case_answers_as_the_oracle(bias, seed):
    assert replay_sharded(bias, seed) > 0


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("bias,seed", CELLS)
def test_card_fuzz_case_answers_as_the_oracle(bias, seed):
    _needs_card()
    counts = replay(bias, seed, device="cuda")
    assert all(n > 0 for n in counts.values())


@pytest.mark.cuda
@pytest.mark.parametrize("bias,seed", CELLS)
def test_card_sharded_fuzz_case_answers_as_the_oracle(bias, seed):
    _needs_card()
    assert replay_sharded(bias, seed, device="cuda") > 0
