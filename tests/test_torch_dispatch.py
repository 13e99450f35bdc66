"""The torch port's cross-request dispatcher and two-phase read path,
held against the reference's.

The port's `BatchingEndpoint` (spicedb/dispatch.py) runs the reference's
scenarios on the port's own inner endpoints: tests/test_dispatch.py's
fusing, singleflight, failure isolation, fairness and dying-drain cases;
tests/test_pipeline.py's generation pinning, depth agreement under churn
and pipeline-switch-off serial entries; tests/test_streaming.py's stream
verbs; tests/test_admission.py's queue bounds.  Pipelining is shown by
ordering (batch N+1 starts before batch N finishes, through a gated
inner endpoint), never by a timing ratio.  Then the same concurrent
burst goes through `torch://?device=cpu` (batched, depth 1 and 2), a
co-located 2 x 2 mesh (batched) and `jax://`'s default batched endpoint:
the answers must be equal, and equal the oracle's.  Tolerance is zero
everywhere: the data are ids and tri-state answers.
"""

import asyncio

import numpy as np
import pytest
import torch

from spicedb_kubeapi_proxy_tpu.spicedb.dispatch import (
    BatchingEndpoint as RefBatchingEndpoint)
from spicedb_kubeapi_proxy_tpu.spicedb.endpoints import (
    Bootstrap as RefBootstrap,
    EndpointConfigError as RefConfigError,
    create_endpoint as ref_create_endpoint)
from spicedb_kubeapi_proxy_tpu.spicedb.evaluator import Evaluator
from spicedb_kubeapi_proxy_tpu.spicedb.types import (
    CheckRequest as RefCheckRequest,
    ObjectRef as RefObjectRef,
    SubjectRef as RefSubjectRef)
from spicedb_kubeapi_proxy_tpu_torch.ops import torch_endpoint as port_te
from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import TorchEndpoint
from spicedb_kubeapi_proxy_tpu_torch.parallel.sharding import make_mesh
from spicedb_kubeapi_proxy_tpu_torch.spicedb import schema as sch
from spicedb_kubeapi_proxy_tpu_torch.spicedb.dispatch import BatchingEndpoint
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
    Bootstrap,
    EmbeddedEndpoint,
    EndpointConfigError,
    create_endpoint,
)
from spicedb_kubeapi_proxy_tpu_torch.spicedb.evaluator import (
    Evaluator as PortEvaluator)
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
    CheckRequest,
    ObjectRef,
    RelationshipUpdate,
    SubjectRef,
    UpdateOp,
    parse_relationship,
)
from spicedb_kubeapi_proxy_tpu_torch.utils import admission, failpoints
from spicedb_kubeapi_proxy_tpu_torch.utils import features

SCHEMA = """
definition user {}
definition doc {
  relation viewer: user
  permission view = viewer
}
"""

GROUPS_SCHEMA = """
definition user {}
definition group {
  relation member: user
  permission m = member
}
definition doc {
  relation viewer: user | group#member
  relation editor: user
  permission view = viewer + editor
  permission edit = editor
}
"""


def touch(*rels):
    return [RelationshipUpdate(UpdateOp.TOUCH, parse_relationship(r))
            for r in rels]


def check(user, doc="d0"):
    return CheckRequest(resource=ObjectRef("doc", doc), permission="view",
                        subject=SubjectRef("user", user))


@pytest.fixture(autouse=True)
def disarm_failpoints():
    yield
    failpoints.disable_all()


class CountingEndpoint(EmbeddedEndpoint):
    """Embedded endpoint that records inner-call batch sizes."""

    def __init__(self, schema):
        super().__init__(schema)
        self.bulk_calls = []
        self.lr_batch_calls = []
        self.slow = False

    async def check_bulk_permissions(self, reqs):
        self.bulk_calls.append(len(reqs))
        if self.slow:
            await asyncio.sleep(0.01)
        return await super().check_bulk_permissions(reqs)

    async def lookup_resources_batch(self, resource_type, permission,
                                     subjects):
        self.lr_batch_calls.append(len(subjects))
        if self.slow:
            await asyncio.sleep(0.01)
        return await super().lookup_resources_batch(
            resource_type, permission, subjects)


def make(n_docs=4, users=("alice", "bob")):
    inner = CountingEndpoint(sch.parse_schema(SCHEMA))
    inner.store.write(touch(*[f"doc:d{i}#viewer@user:{users[i % len(users)]}"
                              for i in range(n_docs)]))
    return BatchingEndpoint(inner), inner


class TwoPhaseInner(EmbeddedEndpoint):
    """Inner endpoint with the two-phase pairs, recording the order of
    starts and finishes; `gate` (when set) holds every finish until it
    opens."""

    def __init__(self, schema):
        super().__init__(schema)
        self.events = []
        self.fail_start = 0
        self.fail_finish = 0
        self.gate = None

    async def lookup_resources_batch_start(self, resource_type, permission,
                                           subjects):
        if self.fail_start:
            self.fail_start -= 1
            raise RuntimeError("injected start failure")
        self.events.append(("start", "lr", len(subjects)))
        return {"rt": resource_type, "perm": permission,
                "subjects": subjects}

    async def lookup_resources_batch_finish(self, ctx):
        if self.gate is not None:
            await self.gate.wait()
        self.events.append(("finish", "lr", len(ctx["subjects"])))
        if self.fail_finish:
            self.fail_finish -= 1
            raise RuntimeError("injected finish failure")
        return [await self.lookup_resources(ctx["rt"], ctx["perm"], s)
                for s in ctx["subjects"]]

    async def check_bulk_permissions_start(self, reqs):
        self.events.append(("start", "ck", len(reqs)))
        return {"reqs": reqs}

    async def check_bulk_permissions_finish(self, ctx):
        if self.gate is not None:
            await self.gate.wait()
        self.events.append(("finish", "ck", len(ctx["reqs"])))
        return await self.check_bulk_permissions(ctx["reqs"])


def make_two_phase(n_docs=4, **kw):
    inner = TwoPhaseInner(sch.parse_schema(SCHEMA))
    inner.store.bulk_load([parse_relationship(f"doc:d{i}#viewer@user:alice")
                           for i in range(n_docs)])
    return BatchingEndpoint(inner, **kw), inner


ALICE_DOCS = ["d0", "d1", "d2", "d3"]


# -- tests/test_dispatch.py ----------------------------------------------------


def test_concurrent_checks_fuse_into_one_inner_call():
    ep, inner = make()
    inner.slow = True

    async def run():
        first = asyncio.create_task(ep.check_permission(check("alice", "d0")))
        await asyncio.sleep(0.002)
        rest = [asyncio.create_task(ep.check_permission(check(u, d)))
                for u, d in [("alice", "d2"), ("bob", "d1"), ("bob", "d3"),
                             ("alice", "d1")]]
        return [await first] + [await t for t in rest]

    results = asyncio.run(run())
    assert [r.allowed for r in results] == [True, True, True, True, False]
    assert inner.bulk_calls == [1, 4]
    assert ep.stats["fused_checks"] == 2
    assert ep.stats["max_fused_batch"] == 4


def test_concurrent_lookups_fuse_and_singleflight():
    ep, inner = make(n_docs=6)
    inner.slow = True

    async def run():
        first = asyncio.create_task(
            ep.lookup_resources("doc", "view", SubjectRef("user", "alice")))
        await asyncio.sleep(0.002)
        rest = [asyncio.create_task(
            ep.lookup_resources("doc", "view", SubjectRef("user", u)))
            for u in ("bob", "alice", "bob")]
        return [sorted(await first)] + [sorted(await t) for t in rest]

    res = asyncio.run(run())
    assert res == [["d0", "d2", "d4"], ["d1", "d3", "d5"],
                   ["d0", "d2", "d4"], ["d1", "d3", "d5"]]
    # the queued bob/alice/bob dedupe to two subjects in one fused call
    assert inner.lr_batch_calls == [1, 2]
    assert ep.stats["singleflight_hits"] == 1


def test_batch_failure_isolated_per_request():
    ep, _ = make()

    async def run():
        good = ep.check_permission(check("alice", "d0"))
        bad = ep.check_permission(CheckRequest(
            resource=ObjectRef("nosuchtype", "x"), permission="view",
            subject=SubjectRef("user", "alice")))
        return await asyncio.gather(good, bad, return_exceptions=True)

    good, bad = asyncio.run(run())
    assert good.allowed
    assert isinstance(bad, Exception)


def test_bulk_api_preserves_order_and_duplicates():
    ep, _ = make()
    res = asyncio.run(ep.check_bulk_permissions(
        [check("alice", "d0"), check("bob", "d0"), check("alice", "d0")]))
    assert [r.allowed for r in res] == [True, False, True]


def test_sequential_calls_drain_immediately():
    ep, inner = make()

    async def run():
        return (await ep.check_permission(check("alice", "d0")),
                await ep.check_permission(check("bob", "d0")))

    a, b = asyncio.run(run())
    assert a.allowed and not b.allowed
    assert inner.bulk_calls == [1, 1]


def test_writes_pass_through_and_are_visible():
    ep, _ = make(n_docs=1)

    async def run():
        before = await ep.check_permission(check("bob", "d9"))
        await ep.write_relationships(touch("doc:d9#viewer@user:bob"))
        return before, await ep.check_permission(check("bob", "d9"))

    before, after = asyncio.run(run())
    assert not before.allowed and after.allowed


def test_create_endpoint_wraps_torch_in_batching():
    bs = Bootstrap(SCHEMA, "doc:d0#viewer@user:alice")
    ep = create_endpoint("torch://?device=cpu", bs)
    assert isinstance(ep, BatchingEndpoint)
    assert isinstance(ep.inner, TorchEndpoint)
    assert (ep.max_batch, ep.pipeline_depth, ep.max_queue_depth) == \
        (4096, 2, 0)
    direct = create_endpoint("torch://?device=cpu&dispatch=direct", bs)
    assert type(direct) is TorchEndpoint
    custom = create_endpoint(
        "torch://?device=cpu&dispatch=batched&max_batch=128&pipeline_depth=3"
        "&max_queue_depth=7", bs)
    assert (custom.max_batch, custom.pipeline_depth,
            custom.max_queue_depth) == (128, 3, 7)
    kw = create_endpoint("torch://?device=cpu", bs, max_batch=64,
                         pipeline_depth=1)
    assert (kw.max_batch, kw.pipeline_depth) == (64, 1)
    assert type(create_endpoint("torch://", bs, device="cpu",
                                dispatch="direct")) is TorchEndpoint
    ids = asyncio.run(ep.lookup_resources("doc", "view",
                                          SubjectRef("user", "alice")))
    assert list(ids) == ["d0"]


def test_cross_request_batching_switch_sets_the_default(monkeypatch):
    bs = Bootstrap(SCHEMA, "")
    monkeypatch.setattr(features, "CROSS_REQUEST_BATCHING", False)
    assert type(create_endpoint("torch://?device=cpu", bs)) is TorchEndpoint
    assert isinstance(create_endpoint("torch://?device=cpu&dispatch=batched",
                                      bs), BatchingEndpoint)


@pytest.mark.parametrize("query", [
    "dispatch=bogus", "max_batch=0", "max_batch=many", "pipeline_depth=0",
    "max_queue_depth=-1"])
def test_bad_dispatch_parameters_raise_as_in_the_reference(query):
    with pytest.raises(EndpointConfigError) as port_err:
        create_endpoint(f"torch://?device=cpu&{query}", Bootstrap(SCHEMA, ""))
    with pytest.raises(RefConfigError) as ref_err:
        ref_create_endpoint(f"jax://?{query}", RefBootstrap(SCHEMA, ""))
    norm = lambda e, url: str(e.value).replace(url, "URL")
    assert norm(port_err, f"torch://?device=cpu&{query}") == \
        norm(ref_err, f"jax://?{query}")


def test_stats_merge_inner_counters_as_a_copy():
    ep = create_endpoint("torch://?device=cpu", Bootstrap(SCHEMA, ""))
    s = ep.stats
    assert {"drains", "rebuilds", "kernel_calls", "readbacks",
            "check_queue_depth"} <= set(s)
    s["rebuilds"] = 99   # a copy: the inner counter is untouched
    assert ep.inner.stats["rebuilds"] == ep.stats["rebuilds"] != 99


def test_two_phase_drain_resolves_all_waiters():
    ep, inner = make_two_phase()

    async def run():
        return await asyncio.gather(*[
            ep.lookup_resources("doc", "view", SubjectRef("user", "alice"))
            for _ in range(6)])

    assert all(sorted(o) == ALICE_DOCS for o in asyncio.run(run()))
    assert ("start", "lr", 1) in inner.events
    assert ("finish", "lr", 1) in inner.events


@pytest.mark.parametrize("fail", ["start", "finish"])
def test_two_phase_failure_degrades_per_member(fail):
    ep, inner = make_two_phase()
    setattr(inner, f"fail_{fail}", 10)

    async def run():
        return await asyncio.gather(*[
            ep.lookup_resources("doc", "view", SubjectRef("user", "alice"))
            for _ in range(4)])

    assert all(sorted(o) == ALICE_DOCS for o in asyncio.run(run()))


def test_two_phase_finish_failure_isolates_poison_member():
    class Poisoned(TwoPhaseInner):
        async def lookup_resources_batch_finish(self, ctx):
            raise RuntimeError("injected fused finish failure")

        async def lookup_resources(self, resource_type, permission, subject):
            if subject.id == "poison":
                raise RuntimeError("poison member")
            return await super().lookup_resources(resource_type, permission,
                                                  subject)

    inner = Poisoned(sch.parse_schema(SCHEMA))
    inner.store.bulk_load([parse_relationship(f"doc:d{i}#viewer@user:alice")
                           for i in range(3)])
    ep = BatchingEndpoint(inner)

    async def run():
        return await asyncio.gather(
            ep.lookup_resources("doc", "view", SubjectRef("user", "alice")),
            ep.lookup_resources("doc", "view", SubjectRef("user", "poison")),
            return_exceptions=True)

    good, bad = asyncio.run(run())
    assert sorted(good) == ["d0", "d1", "d2"]
    assert isinstance(bad, RuntimeError) and "poison" in str(bad)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipeline_window_orders_starts_and_finishes(depth):
    """Three fused batches queued together (two lookup keys and a check
    batch): at depth d, up to d-1 started batches wait for their finish,
    so batch N+1 starts before batch N finishes exactly when d > 1."""
    ep, inner = make_two_phase(pipeline_depth=depth)
    inner.gate = None

    async def run():
        tasks = [ep.lookup_resources("doc", "view",
                                     SubjectRef("user", "alice")),
                 ep.check_permission(check("alice", "d1")),
                 ep.lookup_resources("doc", "viewer",
                                     SubjectRef("user", "alice"))]
        return await asyncio.gather(*tasks)

    lr, ck, lr2 = asyncio.run(run())
    assert sorted(lr) == sorted(lr2) == ALICE_DOCS and ck.allowed
    kinds = [e[0] for e in inner.events]
    if depth == 1:
        # serial: no two-phase entry at all
        assert kinds == []
    else:
        assert kinds.count("start") == kinds.count("finish") == 3
        # the second start precedes the first finish
        assert kinds.index("finish") > 1
        in_flight = max(kinds[:i + 1].count("start")
                        - kinds[:i + 1].count("finish")
                        for i in range(len(kinds)))
        assert in_flight == depth


def test_pipelined_start_overlaps_a_held_finish():
    """Two lookup batches queued together, the first one's finish held
    at a gate: the second batch is started (not finished) before the
    gate opens."""
    ep, inner = make_two_phase(pipeline_depth=2)

    async def run():
        inner.gate = asyncio.Event()
        a = asyncio.create_task(ep.lookup_resources(
            "doc", "view", SubjectRef("user", "alice")))
        b = asyncio.create_task(ep.lookup_resources(
            "doc", "viewer", SubjectRef("user", "alice")))
        for _ in range(100):
            await asyncio.sleep(0.001)
            if [e[0] for e in inner.events].count("start") == 2:
                break
        held = list(inner.events)
        inner.gate.set()
        return held, await a, await b

    held, a, b = asyncio.run(run())
    assert [e[0] for e in held] == ["start", "start"]
    assert sorted(a) == sorted(b) == ALICE_DOCS


def test_cancelled_drain_fails_waiters_instead_of_hanging():
    class Blocking(CountingEndpoint):
        gate = None

        async def check_bulk_permissions(self, reqs):
            await self.gate.wait()
            return await super().check_bulk_permissions(reqs)

    inner = Blocking(sch.parse_schema(SCHEMA))
    ep = BatchingEndpoint(inner)

    async def run():
        inner.gate = asyncio.Event()
        first = asyncio.create_task(ep.check_permission(check("alice")))
        await asyncio.sleep(0.01)
        second = asyncio.create_task(ep.check_permission(check("bob")))
        await asyncio.sleep(0.01)
        assert not first.done() and not second.done()
        ep._drain_task.cancel()
        for waiter in (first, second):
            with pytest.raises(RuntimeError, match="drain task cancelled"):
                await asyncio.wait_for(waiter, 2)

    asyncio.run(run())


@pytest.mark.parametrize("site", ["dispatchDrain",
                                  "dispatchDrainBeforeFinish"])
def test_dying_drain_at_a_failpoint_fails_every_waiter(site):
    """A drain that dies at either failpoint fails its queued, in-flight
    and started-but-unfinished waiters with the failure; the next call
    starts a fresh drain and is answered."""
    ep, inner = make_two_phase()
    failpoints.enable_failpoint(site, 1)

    async def run():
        outs = await asyncio.gather(
            ep.lookup_resources("doc", "view", SubjectRef("user", "alice")),
            ep.lookup_resources("doc", "viewer", SubjectRef("user", "alice")),
            ep.check_permission(check("alice")),
            return_exceptions=True)
        again = await ep.lookup_resources("doc", "view",
                                          SubjectRef("user", "alice"))
        return outs, again

    outs, again = asyncio.run(run())
    assert all(isinstance(o, failpoints.FailPointPanic) for o in outs)
    assert sorted(again) == ALICE_DOCS
    assert ep._lr_pending == {} and ep.queue_depth() == 0


def test_dying_drain_fails_pending_two_phase_waiters():
    class Exploding(CountingEndpoint):
        async def lookup_resources_batch_start(self, rt, perm, subjects):
            return ("ctx", rt, perm, subjects)

        async def lookup_resources_batch_finish(self, ctx):
            raise asyncio.CancelledError()  # the drain dies in phase 2

        async def lookup_resources(self, rt, perm, subject):
            raise RuntimeError("retry path must not mask the drain death")

    ep = BatchingEndpoint(Exploding(sch.parse_schema(SCHEMA)))

    async def run():
        a = asyncio.create_task(
            ep.lookup_resources("doc", "view", SubjectRef("user", "alice")))
        b = asyncio.create_task(
            ep.lookup_resources("doc", "viewer", SubjectRef("user", "alice")))
        for t in (a, b):
            with pytest.raises((RuntimeError, asyncio.CancelledError)):
                await asyncio.wait_for(t, 2)

    asyncio.run(run())


def test_singleflight_dedupes_identical_queued_lookups():
    ep, inner = make(n_docs=4, users=("alice",))
    inner.slow = True

    async def run():
        first = asyncio.create_task(
            ep.lookup_resources("doc", "view", SubjectRef("user", "alice")))
        await asyncio.sleep(0.002)
        rest = [asyncio.create_task(
            ep.lookup_resources("doc", "view", SubjectRef("user", "alice")))
            for _ in range(5)]
        return [sorted(await first)] + [sorted(await t) for t in rest]

    assert all(r == ALICE_DOCS for r in asyncio.run(run()))
    assert inner.lr_batch_calls == [1, 1]
    assert ep.stats["singleflight_hits"] == 4


def test_singleflight_caller_cancellation_does_not_poison_others():
    ep, inner = make(n_docs=2, users=("alice",))
    inner.slow = True

    async def run():
        first = asyncio.create_task(
            ep.lookup_resources("doc", "view", SubjectRef("user", "alice")))
        await asyncio.sleep(0.002)
        a = asyncio.create_task(
            ep.lookup_resources("doc", "view", SubjectRef("user", "alice")))
        b = asyncio.create_task(
            ep.lookup_resources("doc", "view", SubjectRef("user", "alice")))
        await asyncio.sleep(0)
        a.cancel()
        out = sorted(await b)
        with pytest.raises(asyncio.CancelledError):
            await a
        await first
        return out

    assert asyncio.run(run()) == ["d0", "d1"]


def test_singleflight_window_closes_at_drain_pickup():
    ep, inner = make(n_docs=2, users=("alice",))
    inner.slow = True

    async def run():
        first = asyncio.create_task(
            ep.lookup_resources("doc", "view", SubjectRef("user", "alice")))
        await asyncio.sleep(0.005)
        second = asyncio.create_task(
            ep.lookup_resources("doc", "view", SubjectRef("user", "alice")))
        await asyncio.gather(first, second)

    asyncio.run(run())
    assert inner.lr_batch_calls == [1, 1]
    assert ep.stats["singleflight_hits"] == 0


def test_stats_export_queue_depth_and_inflight_batch_gauges():
    ep, inner = make()
    s = ep.stats
    assert (s["check_queue_depth"], s["lr_queue_depth"],
            s["inflight_batch"]) == (0, 0, 0)

    async def run():
        inner.slow = True
        first = asyncio.create_task(ep.check_permission(check("alice", "d0")))
        await asyncio.sleep(0.002)
        queued = [asyncio.create_task(ep.check_permission(check("bob", "d1")))
                  for _ in range(3)]
        lr = asyncio.create_task(
            ep.lookup_resources("doc", "view", SubjectRef("user", "alice")))
        await asyncio.sleep(0)
        depth = ep.stats
        assert depth["inflight_batch"] == 1
        assert depth["check_queue_depth"] == 3
        assert depth["lr_queue_depth"] == 1
        assert ep.queue_depth() == 4
        await asyncio.gather(first, lr, *queued)
        done = ep.stats
        assert (done["check_queue_depth"], done["lr_queue_depth"],
                done["inflight_batch"]) == (0, 0, 0)

    asyncio.run(run())


def test_lr_rotation_no_head_of_line_starvation():
    schema = sch.parse_schema(SCHEMA + """
definition pod {
  relation viewer: user
  permission view = viewer
}
""")
    inner = CountingEndpoint(schema)
    inner.store.write(touch("doc:d0#viewer@user:h0",
                            "pod:p0#viewer@user:cold"))
    order = []
    orig = inner.lookup_resources_batch

    async def recording(resource_type, permission, subjects):
        order.append((resource_type, len(subjects)))
        return await orig(resource_type, permission, subjects)

    inner.lookup_resources_batch = recording
    inner.slow = True
    ep = BatchingEndpoint(inner, max_batch=2)

    async def run():
        first = asyncio.create_task(ep.lookup_resources(
            "doc", "view", SubjectRef("user", "h0")))
        await asyncio.sleep(0.002)
        hot = [asyncio.create_task(ep.lookup_resources(
            "doc", "view", SubjectRef("user", f"h{i}"))) for i in range(1, 9)]
        await asyncio.sleep(0)
        cold = asyncio.create_task(ep.lookup_resources(
            "pod", "view", SubjectRef("user", "cold")))
        await asyncio.gather(first, cold, *hot)

    asyncio.run(run())
    fused = order[1:]
    cold_pos = next(i for i, (t, _n) in enumerate(fused) if t == "pod")
    assert cold_pos <= 1, f"cold key starved: {fused}"


def test_cobatched_member_cancellation_mid_fused_batch():
    ep, inner = make(n_docs=4, users=("alice", "bob"))
    inner.slow = True

    async def run():
        first = asyncio.create_task(ep.check_permission(check("alice", "d0")))
        await asyncio.sleep(0.002)
        c_keep = asyncio.create_task(ep.check_permission(check("bob", "d1")))
        c_cancel = asyncio.create_task(
            ep.check_permission(check("alice", "d2")))
        l_keep = asyncio.create_task(ep.lookup_resources(
            "doc", "view", SubjectRef("user", "alice")))
        l_cancel = asyncio.create_task(ep.lookup_resources(
            "doc", "view", SubjectRef("user", "bob")))
        await asyncio.sleep(0)
        for _ in range(100):
            await asyncio.sleep(0.001)
            if ep.stats["inflight_batch"]:
                break
        c_cancel.cancel()
        l_cancel.cancel()
        assert (await c_keep).allowed
        assert sorted(await l_keep) == ["d0", "d2"]
        for t in (c_cancel, l_cancel):
            with pytest.raises(asyncio.CancelledError):
                await t
        await first
        assert ep._lr_pending == {}
        again = sorted(await ep.lookup_resources(
            "doc", "view", SubjectRef("user", "bob")))
        assert again == ["d1", "d3"]

    asyncio.run(run())


def test_cancelled_follower_before_pickup_leader_still_drains():
    ep, inner = make(n_docs=2, users=("alice",))
    inner.slow = True

    async def run():
        first = asyncio.create_task(ep.lookup_resources(
            "doc", "view", SubjectRef("user", "alice")))
        await asyncio.sleep(0.002)
        doomed = asyncio.create_task(ep.lookup_resources(
            "doc", "view", SubjectRef("user", "alice")))
        survivor = asyncio.create_task(ep.lookup_resources(
            "doc", "view", SubjectRef("user", "alice")))
        await asyncio.sleep(0)
        doomed.cancel()
        got = sorted(await survivor)
        with pytest.raises(asyncio.CancelledError):
            await doomed
        await first
        assert got == ["d0", "d1"]
        assert ep._lr_pending == {}

    asyncio.run(run())


def test_drain_task_does_not_leak_across_event_loops():
    """Each asyncio.run makes a new loop: the dispatcher starts a fresh
    drain there, and close() on a later loop finds nothing to await."""
    ep, inner = make()
    for _ in range(3):
        assert asyncio.run(ep.check_permission(check("alice", "d0"))).allowed
        assert ep._drain_task.done()
    asyncio.run(ep.close())


def test_concurrent_direct_and_batched_calls_agree_under_thread_switching():
    """Direct calls run in executor threads at once (distinct arenas,
    counters under the endpoint lock) beside batched ones on the same
    endpoint; with the interpreter switching threads every microsecond
    every answer still equals the oracle and no kernel call is lost."""
    import sys
    ep, oracle = torch_pair("ell", n_docs=24, seed=29)
    bep = BatchingEndpoint(ep)
    subs = [SubjectRef("user", f"u{i}") for i in range(6)] * 8
    want = [sorted(oracle.lookup_resources("doc", "view", s)) for s in subs]
    calls0 = ep.stats["kernel_calls"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        async def go():
            direct = [ep.lookup_resources("doc", "view", s) for s in subs]
            batched = [bep.lookup_resources("doc", "view", s) for s in subs]
            return await asyncio.wait_for(
                asyncio.gather(*direct, *batched), 60)

        out = asyncio.run(go())
    finally:
        sys.setswitchinterval(old)
    assert [sorted(x) for x in out] == want + want
    fused = bep.stats["fused_lookups"]
    assert ep.stats["kernel_calls"] - calls0 == len(subs) + fused


# -- tests/test_pipeline.py: generation pinning, depth agreement ---------------


def torch_pair(kind, n_docs=24, n_users=6, n_groups=2, seed=3):
    """(direct torch endpoint, oracle) over a randomized doc/group graph:
    the ell or segment kernel, or a co-located 2 x 2 mesh."""
    rng = np.random.default_rng(seed)
    kw = {"device": "cpu", "leopard": False}
    if kind == "segment":
        kw["kernel"] = "segment"
    elif kind == "mesh":
        kw["mesh"] = make_mesh(["cpu"] * 4, data=2, graph=2)
    ep = TorchEndpoint(sch.parse_schema(GROUPS_SCHEMA), **kw)
    rels = []
    for g in range(n_groups):
        for u in range(n_users):
            if rng.random() < 0.5:
                rels.append(f"group:g{g}#member@user:u{u}")
    for d in range(n_docs):
        rels.append(f"doc:d{d}#viewer@user:u{rng.integers(0, n_users)}")
        if rng.random() < 0.3:
            rels.append(f"doc:d{d}#editor@user:u{rng.integers(0, n_users)}")
        if rng.random() < 0.3:
            rels.append(f"doc:d{d}#viewer@group:g"
                        f"{rng.integers(0, n_groups)}#member")
    ep.store.write(touch(*rels))
    return ep, PortEvaluator(ep.schema, ep.store)


@pytest.mark.parametrize("kind", ["ell", "segment", "mesh"])
@pytest.mark.parametrize("between", ["flush", "rebuild"])
def test_started_batches_finish_on_their_snapshot(kind, between):
    """A lookup and a check batch started before a write finish with the
    pre-write answers after the write's flush (or a rebuild); a fresh
    batch sees the write."""
    ep, oracle = torch_pair(kind, seed=7)
    subs = [SubjectRef("user", f"u{i}") for i in range(4)]
    reqs = [CheckRequest(ObjectRef("doc", f"d{d}"), "view", subs[0])
            for d in range(8)]

    async def go():
        ctx_l = await ep.lookup_resources_batch_start("doc", "view", subs)
        ctx_c = await ep.check_bulk_permissions_start(reqs)
        want_l = [sorted(oracle.lookup_resources("doc", "view", s))
                  for s in subs]
        want_c = [oracle.check(r.resource, r.permission, r.subject)
                  for r in reqs]
        ep.store.write(touch(*[f"doc:d{d}#editor@user:u{i}"
                               for d in range(8) for i in range(4)]))
        if between == "rebuild":
            ep.force_rebuild()
        else:
            ep.graph()   # applies and flushes the write
        got_l = await ep.lookup_resources_batch_finish(ctx_l)
        got_c = await ep.check_bulk_permissions_finish(ctx_c)
        assert [sorted(x) for x in got_l] == want_l
        assert [r.allowed for r in got_c] == want_c
        fresh = await ep.lookup_resources_batch("doc", "view", subs)
        assert [sorted(x) for x in fresh] == [
            sorted(oracle.lookup_resources("doc", "view", s)) for s in subs]
        assert all(r.allowed for r in await ep.check_bulk_permissions(reqs))

    asyncio.run(go())
    assert ep.stats["rebuilds"] == (2 if between == "rebuild" else 1)


def _churn_workload(depth, kind="ell", seed=17):
    ep, oracle = torch_pair(kind, n_docs=16, seed=seed)
    bep = BatchingEndpoint(ep, max_batch=4, pipeline_depth=depth)
    subs = [SubjectRef("user", f"u{i}") for i in range(6)]
    out = []

    async def go():
        for rnd in range(4):
            ep.store.write(touch(f"doc:d{rnd}#viewer@user:u{rnd % 6}"))
            tasks = [bep.lookup_resources("doc", "view", s) for s in subs]
            tasks += [bep.check_permission(CheckRequest(
                ObjectRef("doc", f"d{d}"), "view", subs[d % 6]))
                for d in range(10)]
            res = await asyncio.gather(*tasks)
            out.append([sorted(r) if isinstance(r, list) else r.allowed
                        for r in res])

    asyncio.run(go())
    for s in subs:
        assert sorted(asyncio.run(ep.lookup_resources("doc", "view", s))) == \
            sorted(oracle.lookup_resources("doc", "view", s))
    return out, bep.stats


@pytest.mark.parametrize("kind", ["ell", "mesh"])
def test_depths_agree_under_churn(kind):
    serial, _ = _churn_workload(1, kind)
    piped, stats = _churn_workload(3, kind)
    assert serial == piped
    assert stats["fused_lookups"] >= 4 and stats["fused_checks"] >= 4
    # one side-stream readback per fused batch only on a card
    assert stats["readbacks"] == 0


def test_rejects_bad_depth():
    ep, _ = torch_pair("ell", n_docs=2)
    with pytest.raises(ValueError, match="pipeline_depth"):
        BatchingEndpoint(ep, pipeline_depth=0)


def test_pipeline_switch_off_never_two_phases_checks(monkeypatch):
    monkeypatch.setattr(features, "DEVICE_PIPELINE", False)
    ep, oracle = torch_pair("ell", n_docs=6, seed=23)
    bep = BatchingEndpoint(ep, pipeline_depth=4)

    def boom(*a, **k):
        raise AssertionError("two-phase checks used with the switch off")

    monkeypatch.setattr(ep, "check_bulk_permissions_start", boom)

    async def go():
        return await asyncio.gather(*[bep.check_permission(CheckRequest(
            ObjectRef("doc", f"d{d}"), "view", SubjectRef("user", "u0")))
            for d in range(6)])

    res = asyncio.run(go())
    assert [r.allowed for r in res] == [
        oracle.check(ObjectRef("doc", f"d{d}"), "view",
                     SubjectRef("user", "u0")) for d in range(6)]


def test_pipeline_switch_off_keeps_a_single_slot_lookup_window(monkeypatch):
    """Off, lookups still go two-phase but at most one started batch
    waits, whatever the depth; checks run serially."""
    monkeypatch.setattr(features, "DEVICE_PIPELINE", False)
    ep, inner = make_two_phase(pipeline_depth=4)

    async def run():
        return await asyncio.gather(
            ep.lookup_resources("doc", "view", SubjectRef("user", "alice")),
            ep.check_permission(check("alice", "d1")),
            ep.lookup_resources("doc", "viewer", SubjectRef("user", "alice")))

    a, ck, b = asyncio.run(run())
    assert sorted(a) == sorted(b) == ALICE_DOCS and ck.allowed
    assert [e[1] for e in inner.events] == ["lr"] * 4
    kinds = [e[0] for e in inner.events]
    assert max(kinds[:i + 1].count("start") - kinds[:i + 1].count("finish")
               for i in range(len(kinds))) == 2


# -- tests/test_streaming.py ---------------------------------------------------


def test_default_stream_matches_list():
    ep, _ = make(n_docs=10, users=("alice",))

    async def run():
        sub = SubjectRef("user", "alice")
        want = await ep.inner.lookup_resources("doc", "view", sub)
        got = [r async for r in ep.inner.lookup_resources_stream(
            "doc", "view", sub)]
        assert sorted(got) == sorted(want)

    asyncio.run(run())


def test_torch_stream_matches_list_and_yields_between_chunks():
    ep = TorchEndpoint(sch.parse_schema(SCHEMA), device="cpu")
    ep.store.bulk_load([parse_relationship(f"doc:p{i:05d}#viewer@user:alice")
                        for i in range(5000)])
    sub = SubjectRef("user", "alice")

    async def run():
        turns = []

        async def ticker():
            while True:
                turns.append(len(got))
                await asyncio.sleep(0)

        got = []
        t = asyncio.create_task(ticker())
        async for r in ep.lookup_resources_stream("doc", "view", sub):
            got.append(r)
        t.cancel()
        want = await ep.lookup_resources("doc", "view", sub)
        return got, list(want), turns

    got, want, turns = asyncio.run(run())
    assert got == want and len(got) == 5000
    # the loop got a turn after the first 4,096-id chunk
    assert port_te._STREAM_CHUNK in turns


def test_stream_through_the_dispatcher():
    ep = create_endpoint("torch://?device=cpu", Bootstrap(
        SCHEMA, "\n".join(f"doc:d{i}#viewer@user:alice" for i in range(6))))

    async def run():
        sub = SubjectRef("user", "alice")
        got = [r async for r in ep.lookup_resources_stream("doc", "view",
                                                           sub)]
        rels = [r async for r in ep.read_relationships_stream(None)]
        return got, rels

    got, rels = asyncio.run(run())
    assert sorted(got) == [f"d{i}" for i in range(6)]
    assert len(rels) == 6
    assert ep.stats["fused_lookups"] == 1


def test_read_relationships_stream():
    ep, _ = make(n_docs=6)

    async def run():
        return [r async for r in ep.inner.read_relationships_stream(None)]

    assert len(asyncio.run(run())) == 6


# -- tests/test_admission.py: queue bounds -------------------------------------


class GatedEndpoint(EmbeddedEndpoint):
    """Fused calls block on an event, so a batch stays in flight while
    the queues build."""

    def __init__(self, schema):
        super().__init__(schema)
        self.gate = None

    async def check_bulk_permissions(self, reqs):
        if self.gate is not None:
            await self.gate.wait()
        return await super().check_bulk_permissions(reqs)

    async def lookup_resources_batch(self, resource_type, permission,
                                     subjects):
        if self.gate is not None:
            await self.gate.wait()
        return await super().lookup_resources_batch(resource_type,
                                                    permission, subjects)


def make_gated(max_queue_depth=2, n_docs=6):
    inner = GatedEndpoint(sch.parse_schema(SCHEMA))
    inner.store.write(touch(*[f"doc:d{i}#viewer@user:u{i % 3}"
                              for i in range(n_docs)]))
    return BatchingEndpoint(inner, max_batch=64,
                            max_queue_depth=max_queue_depth), inner


async def hold_batch_inflight(ep, inner):
    inner.gate = asyncio.Event()
    first = asyncio.create_task(ep.check_permission(check("u0")))
    for _ in range(50):
        await asyncio.sleep(0.001)
        if ep.stats["inflight_batch"]:
            break
    assert ep.stats["inflight_batch"] == 1
    return first


def test_check_queue_bound_rejects_fast():
    ep, inner = make_gated(max_queue_depth=2)
    assert admission.QUEUE_LIMIT["value"] == 2

    async def run():
        first = await hold_batch_inflight(ep, inner)
        q1 = asyncio.create_task(ep.check_permission(check("u1")))
        q2 = asyncio.create_task(ep.check_permission(check("u2")))
        await asyncio.sleep(0.005)
        before = admission.REJECTED.get("queue_limit", 0)
        with pytest.raises(admission.AdmissionRejectedError) as ei:
            await ep.check_permission(check("u0", "d3"))
        assert ei.value.reason == "queue_limit"
        assert ei.value.retry_after_s > 0
        assert admission.REJECTED["queue_limit"] == before + 1
        assert ep.stats["admission_rejected"] == 1
        inner.gate.set()
        assert (await first).allowed
        assert not (await q1).allowed and not (await q2).allowed

    asyncio.run(run())


def test_bulk_check_admitted_or_rejected_whole():
    ep, inner = make_gated(max_queue_depth=3)

    async def run():
        first = await hold_batch_inflight(ep, inner)
        big = asyncio.create_task(ep.check_bulk_permissions(
            [check(f"w{i}") for i in range(5)]))
        await asyncio.sleep(0.005)
        assert ep.stats["check_queue_depth"] == 5
        with pytest.raises(admission.AdmissionRejectedError):
            await ep.check_bulk_permissions([check(f"u{i}") for i in range(4)])
        assert ep.stats["check_queue_depth"] == 5
        inner.gate.set()
        assert len(await big) == 5
        await first

    asyncio.run(run())


def test_lookup_bound_and_singleflight_followers_free():
    ep, inner = make_gated(max_queue_depth=1)

    async def run():
        first = await hold_batch_inflight(ep, inner)
        lead = asyncio.create_task(ep.lookup_resources(
            "doc", "view", SubjectRef("user", "u0")))
        await asyncio.sleep(0.005)
        follow = asyncio.create_task(ep.lookup_resources(
            "doc", "view", SubjectRef("user", "u0")))
        await asyncio.sleep(0.005)
        assert not follow.done()
        with pytest.raises(admission.AdmissionRejectedError):
            await ep.lookup_resources("doc", "view", SubjectRef("user", "u1"))
        inner.gate.set()
        assert sorted(await lead) == sorted(await follow) == ["d0", "d3"]
        assert ep.stats["singleflight_hits"] == 1
        await first

    asyncio.run(run())


def test_lookup_bulk_larger_than_bound_admits_whole_when_idle():
    ep, _ = make_gated(max_queue_depth=4)
    subs = [SubjectRef("user", f"u{i}") for i in range(10)]
    assert len(asyncio.run(ep.lookup_resources_batch("doc", "view",
                                                     subs))) == 10


def test_exempt_context_bypasses_bound():
    ep, inner = make_gated(max_queue_depth=1)

    async def run():
        first = await hold_batch_inflight(ep, inner)
        q1 = asyncio.create_task(ep.check_permission(check("u1")))
        await asyncio.sleep(0.005)
        with admission.exempt():
            exempt_task = asyncio.create_task(ep.check_permission(check("u2")))
        await asyncio.sleep(0.005)
        assert not exempt_task.done()
        inner.gate.set()
        await asyncio.gather(first, q1, exempt_task)

    asyncio.run(run())


@pytest.mark.parametrize("bound,switch", [(1, False), (0, True)])
def test_unbounded_or_switched_off_never_rejects(monkeypatch, bound, switch):
    monkeypatch.setattr(features, "ADMISSION_CONTROL", switch)
    ep, inner = make_gated(max_queue_depth=bound)
    before = dict(admission.REJECTED)

    async def run():
        first = await hold_batch_inflight(ep, inner)
        tasks = [asyncio.create_task(ep.check_permission(check(f"u{i % 3}")))
                 for i in range(32)]
        await asyncio.sleep(0.005)
        inner.gate.set()
        await asyncio.gather(first, *tasks)

    asyncio.run(run())
    assert admission.REJECTED == before


# -- end to end: torch:// batched against jax://'s default batched -------------


E2E_SCHEMA = GROUPS_SCHEMA


def _e2e_rels(rng, n_docs=40, n_users=12, n_groups=4):
    rels = set()
    for g in range(n_groups):
        for u in range(n_users):
            if rng.random() < 0.4:
                rels.add(f"group:g{g}#member@user:u{u}")
    for d in range(n_docs):
        rels.add(f"doc:d{d}#viewer@user:u{rng.integers(0, n_users)}")
        if rng.random() < 0.4:
            rels.add(f"doc:d{d}#editor@user:u{rng.integers(0, n_users)}")
        if rng.random() < 0.4:
            rels.add(f"doc:d{d}#viewer@group:g"
                     f"{rng.integers(0, n_groups)}#member")
    return sorted(rels)


async def _burst(ep, subjects, pairs, sub, req):
    """One concurrent burst: a lookup per subject and permission, plus
    check calls of 5 pairs each, all gathered together."""
    calls = [ep.lookup_resources("doc", perm, sub(s))
             for perm in ("view", "edit") for s in subjects]
    calls += [ep.check_bulk_permissions([req(*p) for p in pairs[i:i + 5]])
              for i in range(0, len(pairs), 5)]
    out = await asyncio.gather(*calls)
    n = 2 * len(subjects)
    return ([sorted(x) for x in out[:n]],
            [r.permissionship.name for chunk in out[n:] for r in chunk])


@pytest.mark.parametrize("url", [
    "torch://?device=cpu&pipeline_depth=1",
    "torch://?device=cpu&pipeline_depth=2",
    "torch://?device=cpu&mesh=2x2"])
def test_concurrent_bursts_answer_as_jax_batched_and_the_oracle(url):
    rng = np.random.default_rng(12)
    rels = _e2e_rels(rng)
    port = create_endpoint(url, Bootstrap(E2E_SCHEMA, "\n".join(rels)))
    jx = ref_create_endpoint("jax://", RefBootstrap(E2E_SCHEMA,
                                                    "\n".join(rels)))
    assert isinstance(port, BatchingEndpoint)
    assert isinstance(jx, RefBatchingEndpoint)
    if "mesh" in url:
        assert port.mesh.shape == {"data": 2, "graph": 2}
    oracle = Evaluator(jx.inner.schema, jx.inner.store)
    subjects = [f"u{i}" for i in range(12)] + ["stranger"]
    for step in range(3):
        pairs = [(f"d{rng.integers(0, 44)}", perm, subjects[i % 13])
                 for i, perm in enumerate(["view", "edit"] * 30)]
        got = asyncio.run(_burst(
            port, subjects, pairs, lambda s: SubjectRef("user", s),
            lambda d, p, s: CheckRequest(ObjectRef("doc", d), p,
                                         SubjectRef("user", s))))
        want = asyncio.run(_burst(
            jx, subjects, pairs, lambda s: RefSubjectRef("user", s),
            lambda d, p, s: RefCheckRequest(RefObjectRef("doc", d), p,
                                            RefSubjectRef("user", s))))
        assert got == want, f"step {step}"
        assert got[0] == [sorted(oracle.lookup_resources(
            "doc", perm, RefSubjectRef("user", s)))
            for perm in ("view", "edit") for s in subjects]
        assert got[1] == [
            "HAS_PERMISSION" if oracle.check(RefObjectRef("doc", d), p,
                                             RefSubjectRef("user", s))
            else "NO_PERMISSION" for d, p, s in pairs]
        # the same writes through both, then the next burst reads them
        ws = [f"doc:d{40 + step}#viewer@user:u{step}",
              f"group:g{step}#member@user:u{11 - step}"]
        asyncio.run(port.write_relationships(touch(*ws)))
        from spicedb_kubeapi_proxy_tpu.spicedb.types import (
            RelationshipUpdate as RefUpdate, UpdateOp as RefOp,
            parse_relationship as ref_parse)
        asyncio.run(jx.write_relationships(
            [RefUpdate(RefOp.TOUCH, ref_parse(r)) for r in ws]))
    stats = port.stats
    assert stats["max_fused_batch"] > 1
    assert stats["kernel_calls"] < stats["fused_lookups"] + \
        stats["fused_checks"] + 1


# -- on a card -----------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
def test_card_readback_is_a_pinned_side_stream_copy():
    _needs_card()
    dev = torch.arange(1 << 20, dtype=torch.int32, device="cuda")
    rb = port_te._Readback(dev)
    assert rb.event is not None
    host = rb.wait()
    assert host.is_pinned() and torch.equal(host, dev.cpu())


@pytest.mark.cuda
def test_card_batched_answers_equal_the_cpu_and_count_readbacks():
    _needs_card()
    rng = np.random.default_rng(5)
    text = "\n".join(_e2e_rels(rng))
    eps = [create_endpoint(u, Bootstrap(E2E_SCHEMA, text), leopard=False)
           for u in ("torch://?device=cpu", "torch://")]
    subjects = [f"u{i}" for i in range(12)]
    pairs = [(f"d{i % 40}", "view", subjects[i % 12]) for i in range(60)]
    outs = [asyncio.run(_burst(
        ep, subjects, pairs, lambda s: SubjectRef("user", s),
        lambda d, p, s: CheckRequest(ObjectRef("doc", d), p,
                                     SubjectRef("user", s))))
        for ep in eps]
    assert outs[0] == outs[1]
    s = eps[1].stats
    # a lookup batch's words come back through a side-stream readback; a
    # check batch's answers with its last sweep (the ELL check tail)
    assert s["readbacks"] == s["fused_lookups"] > 0 and s["fused_checks"]
