"""The port's workflow engine, module by module, against the reference's
on shared inputs.

- The journals: one sequence of operations (create, events, attempts,
  completion, failure, prune) on the port's `MemoryJournal` and
  `SQLiteJournal` and the reference's, with equal records, event logs
  and pending lists after every step.
- The engine: replay of journaled activities, a journaled activity
  failure, the crash-replay budget, unknown workflows and instances,
  the result timeout, the worker's start/stop and its drain, the audit
  event of each finished instance; each run on both packages with equal
  outcomes.
- The pure helpers, over hypothesis-drawn inputs: `_invert`,
  `resource_lock_rel`, `_lock_update`, `_collect_updates`,
  `kube_conflict`, `_is_successful_kube_operation`,
  `workflow_for_lock_mode`, the activity codecs, `filter_from_rel`, and
  `idempotency_key_for_payload` (the same digest for the same payload and
  workflow id).
- `setup_workflow_engine`: SQLite for a path, memory for "".
- The counterpart of the reference's eager-task GC test
  (tests/test_audit.py::TestEagerWorkflowTaskRetention), which awaits
  one loop tick for the task's done-callback before it asserts the
  release.
"""

import asyncio
import dataclasses
import gc
import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_dualwrite import PORT, REF, mask

PKGS = {"port": PORT, "ref": REF}


def run(coro):
    return asyncio.run(coro)


def record(rec):
    return None if rec is None else dataclasses.asdict(rec)


# -- journals ----------------------------------------------------------------

def journal_ops(journal) -> list:
    """A fixed sequence of operations; the observable state after each."""
    seen = []

    def look(ids=("a", "b", "c", "d")):
        seen.append({i: (record(journal.get_instance(i)),
                         journal.events(i)) for i in ids})
        seen.append(journal.pending_instances())

    journal.create_instance("a", "Pessimistic", {"user_name": "u",
                                                 "creates": ["x"]})
    journal.create_instance("b", "Optimistic", {"n": 1.5, "l": [1, None]})
    look()
    journal.record_event("a", 0, "write_to_spicedb", {"written_at": 3})
    journal.record_event("a", 1, "write_to_kube", None, error="boom")
    journal.record_event("a", 1, "write_to_kube", {"status_code": 201})
    journal.record_event("b", 0, "__sleep__", None)
    look()
    seen.append([journal.bump_attempts("a"), journal.bump_attempts("a"),
                 journal.bump_attempts("b")])
    journal.complete_instance("a", {"status_code": 201, "body": "{}"})
    journal.complete_instance("b", None, error="workflow failed")
    journal.create_instance("c", "Pessimistic", {})
    journal.create_instance("d", "Pessimistic", {})
    journal.complete_instance("d", {"ok": True})
    look()
    journal.prune_completed(keep_last=1)
    look()
    journal.prune_completed(keep_last=0)
    look()
    return seen


@pytest.mark.parametrize("kind", ["MemoryJournal", "SQLiteJournal"])
def test_journal_matches_reference(kind, tmp_path):
    def make(pkg, name):
        cls = getattr(pkg.journal, kind)
        if kind == "SQLiteJournal":
            return cls(str(tmp_path / f"{name}.sqlite"))
        return cls()
    port, ref = make(PORT, "port"), make(REF, "ref")
    try:
        got, want = journal_ops(port), journal_ops(ref)
    finally:
        port.close()
        ref.close()
    if kind == "SQLiteJournal":
        # prune keeps the newest by creation time; two instances made in
        # one clock tick may order either way, so after a prune compare
        # which instances are pending and how many finished ones stay
        def kept(seen):
            return [sorted(k for k, v in s.items() if v[0] is not None)
                    if isinstance(s, dict) else s for s in seen[-4:]]
        assert [len(k) for k in kept(got)] == [len(k) for k in kept(want)]
        got, want = got[:-4], want[:-4]
    assert got == want


def test_sqlite_journal_survives_reopen(tmp_path):
    path = str(tmp_path / "j.sqlite")
    for pkg in (PORT, REF):
        j = pkg.journal.SQLiteJournal(path + pkg.root)
        j.create_instance("i", "Pessimistic", {"k": "v"})
        j.record_event("i", 0, "read_relationships", ["a:b#c@d:e"])
        j.close()
    got = PORT.journal.SQLiteJournal(path + PORT.root)
    want = REF.journal.SQLiteJournal(path + REF.root)
    assert record(got.get_instance("i")) == record(want.get_instance("i"))
    assert got.events("i") == want.events("i")
    assert got.pending_instances() == want.pending_instances() == ["i"]


# -- the engine --------------------------------------------------------------

class Audit:
    """A sink that keeps every event's dict."""
    enabled = True
    backend = "test"

    def __init__(self):
        self.events = []

    def emit(self, ev):
        d = ev.to_dict()
        d.pop("ts")
        self.events.append(d)


def engine_run(pkg, scenario) -> dict:
    eng_mod, fp = pkg.engine, pkg.failpoints
    audit = Audit()
    engine = eng_mod.WorkflowEngine(pkg.journal.MemoryJournal(),
                                    max_crash_replays=3, audit=audit)
    calls = []

    async def act_ok(x):
        calls.append(("ok", x))
        return {"echo": x}

    async def act_fail(x):
        calls.append(("fail", x))
        raise RuntimeError(f"no {x}")

    def act_crash(x):
        calls.append(("crash", x))
        fp.fail_point("panicKubeWrite")
        return x * 2

    async def wf(ctx, inp):
        a = await ctx.execute_activity("ok", inp["x"])
        try:
            await ctx.execute_activity("fail", inp["x"])
        except eng_mod.ActivityError as e:
            ctx.notes.setdefault("rollbacks", []).append(
                f"rollback due to {e}")
        await ctx.sleep(0)
        b = await ctx.execute_activity("crash", inp["x"])
        return {"status_code": 201, "a": a, "b": b}

    async def wf_raises(ctx, inp):
        raise ValueError("bad input")

    async def wf_nondeterministic(ctx, inp):
        name = "ok" if ctx.instance_id not in seen_once else "crash"
        seen_once.add(ctx.instance_id)
        await ctx.execute_activity(name, 1)
        fp.fail_point("panicKubeReadResp")
        return {}

    seen_once = set()
    engine.register_workflow("wf", wf)
    engine.register_workflow("raises", wf_raises)
    engine.register_workflow("nondet", wf_nondeterministic)
    for name, fn in (("ok", act_ok), ("fail", act_fail),
                     ("crash", act_crash)):
        engine.register_activity(name, fn)
    fp.disable_all()
    try:
        out = run(scenario(engine, fp))
    finally:
        fp.disable_all()
    return mask({"out": out, "calls": calls, "audit": audit.events})


async def sc_replay(engine, fp):
    fp.enable_failpoint("panicKubeWrite", 2)
    engine.create_instance("i1", "wf", {"x": 3, "user_name": "u",
                                        "verb": "create",
                                        "object_name": "o"})
    result = await engine.get_result("i1", timeout=5)
    rec = engine.journal.get_instance("i1")
    return [result, rec.attempts, engine.journal.events("i1")]


async def sc_budget(engine, fp):
    fp.enable_failpoint("panicKubeWrite", 10)
    engine.create_instance("i1", "wf", {"x": 1})
    try:
        await engine.get_result("i1", timeout=5)
    except Exception as e:
        return [type(e).__name__, str(e),
                engine.journal.get_instance("i1").attempts]
    return ["no error"]


async def sc_raises(engine, fp):
    engine.create_instance("i1", "raises", {"user_name": "u"})
    try:
        await engine.get_result("i1", timeout=5)
    except Exception as e:
        return [type(e).__name__, str(e).splitlines()[0]]
    return ["no error"]


async def sc_nondeterministic(engine, fp):
    fp.enable_failpoint("panicKubeReadResp", 1)
    engine.create_instance("i1", "nondet", {})
    try:
        await engine.get_result("i1", timeout=5)
    except Exception as e:
        return [type(e).__name__, str(e).splitlines()[0]]
    return ["no error"]


async def sc_unknowns(engine, fp):
    out = []
    for call in (lambda: engine.create_instance("i1", "absent", {}),):
        try:
            call()
        except Exception as e:
            out.append([type(e).__name__, str(e)])
    try:
        await engine.get_result("nope")
    except Exception as e:
        out.append([type(e).__name__, str(e)])
    engine.journal.create_instance("orphan", "wf", {"x": 1})
    try:
        await engine.get_result("orphan")
    except Exception as e:
        out.append([type(e).__name__, str(e)])
    engine.journal.create_instance("lost", "gone", {})
    out.append(await engine.run_pending_once())
    out.append(record(engine.journal.get_instance("lost")))
    return out


async def sc_timeout(engine, fp):
    gate = asyncio.Event()

    async def slow(ctx, inp):
        await gate.wait()
        return {"done": True}
    engine.register_workflow("slow", slow)
    engine.create_instance("i1", "slow", {})
    try:
        await engine.get_result("i1", timeout=0.05)
        out = ["no error"]
    except Exception as e:
        out = [type(e).__name__, str(e)]
    gate.set()
    await asyncio.sleep(0.01)
    return out + [engine.journal.get_instance("i1").status]


async def sc_worker(engine, fp):
    await engine.start()
    engine.create_instance("i1", "wf", {"x": 2})
    engine.create_instance("i2", "wf", {"x": 5})
    results = [await engine.get_result("i1", timeout=5),
               await engine.get_result("i2", timeout=5)]
    eager = len(engine._eager_tasks)
    await engine.stop()
    await engine.stop()
    return [results, eager, engine._task is None]


ENGINE_SCENARIOS = {"replay": sc_replay, "budget": sc_budget,
                    "raises": sc_raises,
                    "nondeterministic": sc_nondeterministic,
                    "unknowns": sc_unknowns, "timeout": sc_timeout,
                    "worker": sc_worker}


@pytest.mark.parametrize("name", sorted(ENGINE_SCENARIOS))
def test_engine_matches_reference(name):
    got = engine_run(PORT, ENGINE_SCENARIOS[name])
    want = engine_run(REF, ENGINE_SCENARIOS[name])
    assert got == want


def test_engine_scenarios_hold_the_reference_behaviour():
    replay = engine_run(PORT, sc_replay)
    result, attempts, events = replay["out"]
    assert result == {"status_code": 201, "a": {"echo": 3}, "b": 6}
    assert attempts == 2
    assert [e[1] for e in events] == ["ok", "fail", "__sleep__", "crash"]
    # the journaled activities ran once; the crashing one three times
    assert [c[0] for c in replay["calls"]] == ["ok", "fail", "crash",
                                               "crash", "crash"]
    assert replay["audit"][0]["decision"] == "denied"
    budget = engine_run(PORT, sc_budget)["out"]
    assert budget == ["WorkflowError",
                      "workflow exceeded crash-replay budget", 4]
    assert engine_run(PORT, sc_nondeterministic)["out"][0] == \
        "WorkflowError"
    assert engine_run(PORT, sc_timeout)["out"] == [
        "WorkflowError", "timed out waiting for workflow i1", "completed"]


# -- setup_workflow_engine ---------------------------------------------------

@pytest.mark.parametrize("db", [False, True])
def test_setup_workflow_engine(db, tmp_path):
    path = str(tmp_path / "wf.sqlite") if db else ""
    out = {}
    for key, pkg in PKGS.items():
        ep = pkg.endpoints.create_endpoint("embedded://")
        kube = pkg.kubefake.FakeKubeApiServer()
        engine, worker = pkg.client.setup_workflow_engine(
            ep, pkg.httpcore.HandlerTransport(kube),
            path + key if db else "", default_lock_mode="Optimistic")
        out[key] = (engine is worker, type(engine.journal).__name__,
                    sorted(engine._workflows), sorted(engine._activities),
                    engine.default_lock_mode, engine.audit.enabled)
    assert out["port"] == out["ref"]
    assert out["port"][1] == ("SQLiteJournal" if db else "MemoryJournal")


# -- pure helpers ------------------------------------------------------------

names = st.text(alphabet="abcdefghij-0123456789/", min_size=0, max_size=12)
ids = st.text(alphabet="abcdefghijklmnopqrstuvwxyz0123456789_", min_size=1,
              max_size=8)
rel_strings = st.builds(
    lambda rt, ri, r, st_, si: f"{rt}:{ri}#{r}@{st_}:{si}",
    ids, ids, ids, ids, ids)
verbs = st.sampled_from(["create", "update", "patch", "delete", "get",
                         "list", "watch", ""])


@settings(max_examples=60, deadline=None)
@given(op=st.sampled_from(["create", "touch", "delete"]), rel=rel_strings)
def test_invert(op, rel):
    u = {"op": op, "rel": rel}
    assert PORT.workflow._invert(u) == REF.workflow._invert(u)


@settings(max_examples=60, deadline=None)
@given(path=names, name=names, obj=names, verb=verbs, wid=ids)
def test_lock_rel(path, name, obj, verb, wid):
    inp = {"request_path": path, "request_name": name, "object_name": obj,
           "verb": verb}
    assert (PORT.workflow.resource_lock_rel(inp)
            == REF.workflow.resource_lock_rel(inp))
    assert (PORT.workflow._lock_update(inp, wid)
            == REF.workflow._lock_update(inp, wid))


@settings(max_examples=40, deadline=None)
@given(creates=st.lists(rel_strings, max_size=3),
       touches=st.lists(rel_strings, max_size=3),
       deletes=st.lists(rel_strings, max_size=3))
def test_collect_updates(creates, touches, deletes):
    inp = {"creates": creates, "touches": touches, "deletes": deletes}
    assert (PORT.workflow._collect_updates(inp)
            == REF.workflow._collect_updates(inp))


@settings(max_examples=60, deadline=None)
@given(error=st.text(max_size=20), resource=names, obj=names, group=names)
def test_kube_conflict(error, resource, obj, group):
    inp = {"resource": resource, "object_name": obj, "api_group": group}
    got = PORT.workflow.kube_conflict(error, inp)
    assert got == REF.workflow.kube_conflict(error, inp)
    assert got["status_code"] == json.loads(got["body"])["code"] == 409


@settings(max_examples=80, deadline=None)
@given(verb=verbs, code=st.sampled_from([0, 200, 201, 202, 404, 409, 422,
                                         500]))
def test_is_successful_kube_operation(verb, code):
    inp, out = {"verb": verb}, {"status_code": code}
    assert (PORT.workflow._is_successful_kube_operation(inp, out)
            == REF.workflow._is_successful_kube_operation(inp, out))


@pytest.mark.parametrize("mode", ["Optimistic", "Pessimistic", "", "x"])
def test_workflow_for_lock_mode(mode):
    assert (PORT.workflow.workflow_for_lock_mode(mode)
            == REF.workflow.workflow_for_lock_mode(mode))


payloads = st.recursive(
    st.none() | st.booleans() | st.integers(-5, 5) | st.text(max_size=6),
    lambda inner: st.lists(inner, max_size=3)
    | st.dictionaries(st.text(max_size=4), inner, max_size=3),
    max_leaves=8)


@settings(max_examples=80, deadline=None)
@given(payload=st.dictionaries(st.text(max_size=6), payloads, max_size=4),
       wid=ids)
def test_idempotency_key_for_payload(payload, wid):
    got = PORT.activity.idempotency_key_for_payload(payload, wid)
    want = REF.activity.idempotency_key_for_payload(payload, wid)
    assert got.resource.type == want.resource.type == "workflow"
    assert got.resource.id == want.resource.id == wid
    assert got.relation == want.relation == "idempotency_key"
    assert (got.subject.type, got.subject.id) == (want.subject.type,
                                                  want.subject.id)
    # 24 h from now, within the two calls' clock skew
    assert abs(got.expires_at - want.expires_at) < 5
    # the same payload and id give the same key; another id another one
    assert (PORT.activity.idempotency_key_for_payload(payload, wid)
            .subject.id == got.subject.id)
    assert (PORT.activity.idempotency_key_for_payload(payload, wid + "x")
            .subject.id != got.subject.id)


@settings(max_examples=60, deadline=None)
@given(rt=ids, ri=st.sampled_from(["", "o1"]), rel=st.sampled_from(["", "r"]),
       subject=st.sampled_from([None, ("user", "", None),
                                ("user", "ann", None),
                                ("group", "g", "member")]),
       op=st.sampled_from(["must_match", "must_not_match"]),
       upd=st.sampled_from(["create", "touch", "delete"]), rs=rel_strings)
def test_activity_codecs(rt, ri, rel, subject, op, upd, rs):
    f = {"resource_type": rt, "resource_id": ri, "relation": rel}
    if subject is not None:
        f["subject"] = dict(zip(("type", "id", "relation"), subject))
    for fn in ("filter_from_dict", "update_from_dict",
               "precondition_from_dict"):
        arg = {"filter_from_dict": f,
               "update_from_dict": {"op": upd, "rel": rs},
               "precondition_from_dict": {"op": op, "filter": f}}[fn]
        got = getattr(PORT.activity, fn)(arg)
        want = getattr(REF.activity, fn)(arg)
        assert repr(got).replace("_torch", "") == repr(want), fn
    flt = PORT.activity.filter_from_dict(f)
    assert (PORT.activity.filter_to_dict(flt)
            == REF.activity.filter_to_dict(REF.activity.filter_from_dict(f)))
    pre = PORT.activity.precondition_from_dict({"op": op, "filter": f})
    assert PORT.activity.precondition_to_dict(pre) == {
        "op": op, "filter": PORT.activity.filter_to_dict(flt)}


class _Rel:
    def __init__(self, fields):
        for k, v in fields.items():
            setattr(self, k, v)


FIELDS = ("resource_type", "resource_id", "resource_relation",
          "subject_type", "subject_id", "subject_relation")


@settings(max_examples=100, deadline=None)
@given(values=st.tuples(*[st.sampled_from(["", "x", "$", "$bad", None])
                          for _ in FIELDS]))
def test_filter_from_rel(values):
    fields = {}
    for name, v in zip(FIELDS, values):
        allowed = dict(REF.update._DOLLAR_FIELDS)[name]
        fields[name] = allowed if v is None else v
    outcome = {}
    for key, pkg in PKGS.items():
        try:
            outcome[key] = pkg.update.filter_from_rel(_Rel(fields))
        except pkg.update.UpdateError as e:
            outcome[key] = ("UpdateError", str(e))
    assert outcome["port"] == outcome["ref"]


# -- the eager path keeps its task until it is done --------------------------

def test_eager_instance_survives_gc():
    """tests/test_audit.py::TestEagerWorkflowTaskRetention on the port.
    The no-worker path keeps a strong reference to its task until the
    task is done; `get_result` returns when the instance's event is set,
    one loop tick before the task's done-callback releases it, so the
    release is asserted after that tick."""
    engine = PORT.engine.WorkflowEngine(PORT.journal.MemoryJournal())

    async def wf(ctx, input):
        for _ in range(5):
            await asyncio.sleep(0)
            gc.collect()
        return {"status_code": 200, "body": "{}"}

    engine.register_workflow("gc-probe", wf)

    async def go():
        engine.create_instance("i1", "gc-probe", {"user_name": "u"})
        assert engine._eager_tasks  # strong ref held
        gc.collect()
        result = await engine.get_result("i1", timeout=5)
        assert result["status_code"] == 200
        await asyncio.sleep(0)
        assert not engine._eager_tasks  # released on completion
    run(go())


def test_workflow_timeout_is_the_reference_one():
    assert (PORT.engine.DEFAULT_WORKFLOW_TIMEOUT
            == REF.engine.DEFAULT_WORKFLOW_TIMEOUT == 30.0)
    assert (PORT.activity.IDEMPOTENCY_KEY_EXPIRATION
            == REF.activity.IDEMPOTENCY_KEY_EXPIRATION == 24 * 3600.0)
