"""The port's dual writes held against the reference's.

Every case of tests/test_dualwrite.py (the happy paths under both lock
modes, the precondition conflict, delete-by-filter, the crash matrix of
four failpoints x two lock modes plus the two read failpoints, repeated
crashes, lock mutual exclusion, the rollback on a rejected request,
resuming from SQLite after a restart, replay without duplicated side
effects and the idempotency keys) runs through the port's `ProxyServer`
with `enable_dual_writes()` on `torch://?device=cpu` and `embedded://`,
and through the reference's over `embedded://` (what its test runs),
computed once a case.  Equal between the two: every response's status
and decoded body; the kube objects after the run; the store's
relationships without the workflow, lock and activity tuples (whose
ids are uuid4s), and the count of each of those types; and the
journal's final state, instance by instance (workflow, status, result,
the first line of an error, crash-replay attempts, and the journaled
events).  uuids and wall-clock stamps are masked before comparing.  The
reference test's own assertions are held on the port's observations
too, so a pass cannot be two equal wrong answers.
"""

import asyncio
import importlib
import json
import os
import re
import tempfile

import pytest

from test_dualwrite import FAILPOINT_MATRIX, RULES_TEMPLATE, SCHEMA

PORT_URLS = ["torch://?device=cpu", "embedded://"]
INTERNAL_TYPES = ("lock", "workflow", "activity")
_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                   r"[0-9a-f]{12}")
_EXPIRATION = re.compile(r"\[expiration:[^\]]*\]")
_TIMESTAMP = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ")
_WALL_CLOCK_KEYS = {"creationTimestamp", "deletionTimestamp", "trace_id"}


class DPkg:
    """The modules of one package that a dual-write scenario needs."""

    def __init__(self, root: str):
        def mod(name):
            return importlib.import_module(f"{root}.{name}")
        self.root = root
        self.kubefake = mod("kubefake.apiserver")
        self.httpcore = mod("proxy.httpcore")
        self.server = mod("proxy.server")
        self.endpoints = mod("spicedb.endpoints")
        self.types = mod("spicedb.types")
        self.failpoints = mod("utils.failpoints")
        self.client = mod("authz.distributedtx.client")
        self.engine = mod("authz.distributedtx.engine")
        self.journal = mod("authz.distributedtx.journal")
        self.workflow = mod("authz.distributedtx.workflow")
        self.activity = mod("authz.distributedtx.activity")
        self.update = mod("authz.update")


REF = DPkg("spicedb_kubeapi_proxy_tpu")
PORT = DPkg("spicedb_kubeapi_proxy_tpu_torch")


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def reset_failpoints():
    for pkg in (REF, PORT):
        pkg.failpoints.disable_all()
    yield
    for pkg in (REF, PORT):
        pkg.failpoints.disable_all()


def mask(obj):
    """`obj` with uuids, expiration stamps and wall-clock fields masked."""
    if isinstance(obj, dict):
        return {k: ("<t>" if k in _WALL_CLOCK_KEYS else mask(v))
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [mask(v) for v in obj]
    if isinstance(obj, str):
        obj = _TIMESTAMP.sub("<t>", _UUID.sub("<uuid>", obj))
        return _EXPIRATION.sub("[expiration:<t>]", obj)
    return obj


def snap(resp):
    """(status, body): the body decoded when it is JSON, masked."""
    body = resp.body
    if body and "json" in resp.headers.get("Content-Type", ""):
        body = json.loads(body)
    elif isinstance(body, bytes):
        body = body.decode("utf-8", errors="replace")
    return resp.status, mask(body)


def instance_ids(journal) -> list:
    """Every instance of a journal, in creation order."""
    if hasattr(journal, "_order"):
        with journal._lock:
            return list(journal._order)
    with journal._lock:
        rows = journal._conn.execute(
            "SELECT instance_id FROM instances ORDER BY created").fetchall()
    return [r[0] for r in rows]


def journal_state(journal) -> list:
    out = []
    for iid in instance_ids(journal):
        rec = journal.get_instance(iid)
        out.append(mask({
            "workflow": rec.workflow, "status": rec.status,
            "input": rec.input, "result": rec.result,
            "error": (rec.error or "").splitlines()[:1],
            "attempts": rec.attempts,
            "events": [list(e) for e in journal.events(iid)]}))
    return out


def split_rels(store) -> tuple:
    """(sorted user relationships, count of each internal type)."""
    rels = [r.rel_string() for r in store.read(None)]
    user = sorted(r for r in rels if r.split(":")[0] not in INTERNAL_TYPES)
    counts = {t: sum(r.split(":")[0] == t for r in rels)
              for t in INTERNAL_TYPES}
    return user, counts


def kube_state(kube) -> list:
    return mask(sorted(
        (list(key), ns, name, obj)
        for key, by_ns in kube.objects.items()
        for ns, by_name in by_ns.items()
        for name, obj in by_name.items()))


def final_state(proxy, kube) -> dict:
    user, counts = split_rels(proxy.endpoint.store)
    return {"rels": user, "internal": counts, "kube": kube_state(kube),
            "journal": journal_state(proxy.workflow_client.journal)}


def make_proxy(pkg, url, lock_mode="Pessimistic", db_path=""):
    kube = pkg.kubefake.FakeKubeApiServer()
    proxy = pkg.server.ProxyServer(pkg.server.Options(
        spicedb_endpoint=url,
        bootstrap=pkg.endpoints.Bootstrap(schema_text=SCHEMA),
        rules_yaml=RULES_TEMPLATE.format(lock_mode=lock_mode),
        upstream_transport=pkg.httpcore.HandlerTransport(kube),
        workflow_database_path=db_path,
    ))
    proxy.enable_dual_writes()
    return proxy, kube


def store_rels(proxy, resource_type=""):
    return {r.rel_string() for r in proxy.endpoint.store.read(None)
            if not resource_type or r.resource.type == resource_type}


# -- scenarios: async fn(pkg, proxy, kube, **kw) -> observations ----------

NS = "/api/v1/namespaces"


def ns_obj(name):
    return {"metadata": {"name": name}} if name else {"metadata": {}}


async def sc_create_namespace(pkg, proxy, kube):
    alice = proxy.get_embedded_client(user="alice")
    return [snap(await alice.post(NS, ns_obj("team-x"))),
            snap(await alice.get(f"{NS}/team-x"))]


async def sc_delete_namespace(pkg, proxy, kube):
    alice = proxy.get_embedded_client(user="alice")
    return [snap(await alice.post(NS, ns_obj("doomed"))),
            snap(await alice.delete(f"{NS}/doomed"))]


async def sc_precondition_conflict(pkg, proxy, kube):
    alice = proxy.get_embedded_client(user="alice")
    return [snap(await alice.post(NS, ns_obj("dup"))),
            snap(await alice.post(NS, ns_obj("dup")))]


async def sc_delete_by_filter(pkg, proxy, kube, failpoint=""):
    alice = proxy.get_embedded_client(user="alice")
    obs = [snap(await alice.post(f"{NS}/ns/pods", {
        "metadata": {"name": "p1", "namespace": "ns"}})),
        sorted(store_rels(proxy, "pod"))]
    if failpoint:
        pkg.failpoints.enable_failpoint(failpoint, 1)
    obs.append(snap(await alice.delete(f"{NS}/ns/pods/p1")))
    return obs


async def sc_crash_create(pkg, proxy, kube, failpoint, times=1,
                          ns_name="crashy"):
    alice = proxy.get_embedded_client(user="alice")
    pkg.failpoints.enable_failpoint(failpoint, times)
    return [snap(await alice.post(NS, ns_obj(ns_name)))]


async def sc_lock_mutual_exclusion(pkg, proxy, kube):
    lock_tmpl = pkg.workflow.resource_lock_rel({
        "request_path": NS, "object_name": "contested", "verb": "create"})
    held = lock_tmpl["rel"].replace("{workflow_id}", "other-workflow")
    proxy.endpoint.store.bulk_load([pkg.types.parse_relationship(held)])
    alice = proxy.get_embedded_client(user="alice")
    return [snap(await alice.post(NS, ns_obj("contested")))]


async def sc_rollback_on_rejection(pkg, proxy, kube):
    alice = proxy.get_embedded_client(user="alice")
    return [snap(await alice.post(NS, ns_obj("")))]


async def sc_replay_counts(pkg, proxy, kube):
    engine = proxy.workflow_client
    calls = {"spicedb": 0, "kube": 0}
    orig_spicedb = engine._activities["write_to_spicedb"]
    orig_kube = engine._activities["write_to_kube"]

    async def counting_spicedb(*a):
        calls["spicedb"] += 1
        return await orig_spicedb(*a)

    async def counting_kube(*a):
        calls["kube"] += 1
        return await orig_kube(*a)

    engine.register_activity("write_to_spicedb", counting_spicedb)
    engine.register_activity("write_to_kube", counting_kube)
    pkg.failpoints.enable_failpoint("panicKubeReadResp", 1)
    alice = proxy.get_embedded_client(user="alice")
    return [snap(await alice.post(NS, ns_obj("once"))), dict(calls)]


SCENARIOS = {
    "create_namespace": sc_create_namespace,
    "delete_namespace": sc_delete_namespace,
    "precondition_conflict": sc_precondition_conflict,
    "delete_by_filter": sc_delete_by_filter,
    "crash_create": sc_crash_create,
    "lock_mutual_exclusion": sc_lock_mutual_exclusion,
    "rollback_on_rejection": sc_rollback_on_rejection,
    "replay_counts": sc_replay_counts,
}


def observe(pkg, url, name, lock_mode="Pessimistic", **kw):
    """(observations, final state) of scenario `name` on `pkg`'s proxy
    over `url`."""
    pkg.failpoints.disable_all()
    try:
        proxy, kube = make_proxy(pkg, url, lock_mode)
        obs = run(SCENARIOS[name](pkg, proxy, kube, **kw))
        return obs, final_state(proxy, kube)
    finally:
        pkg.failpoints.disable_all()


_REF_RUNS: dict = {}


def ref_observe(name, lock_mode="Pessimistic", **kw):
    key = (name, lock_mode, tuple(sorted(kw.items())))
    if key not in _REF_RUNS:
        _REF_RUNS[key] = observe(REF, "embedded://", name, lock_mode, **kw)
    return _REF_RUNS[key]


def check(url, name, lock_mode="Pessimistic", **kw):
    """The port's run equals the reference's; returns the port's."""
    got = observe(PORT, url, name, lock_mode, **kw)
    want = ref_observe(name, lock_mode, **kw)
    assert got[0] == want[0]
    assert got[1] == want[1]
    return got


def namespaces(state) -> set:
    return {name for key, ns, name, _ in state["kube"]
            if key == ["", "v1", "namespaces"]}


class TestDualWriteHappyPath:
    @pytest.mark.parametrize("url", PORT_URLS)
    @pytest.mark.parametrize("lock_mode", ["Pessimistic", "Optimistic"])
    def test_create_namespace(self, url, lock_mode):
        (create, get), state = check(url, "create_namespace", lock_mode)
        assert create[0] == 201 and get[0] == 200
        assert "team-x" in namespaces(state)
        assert "namespace:team-x#creator@user:alice" in state["rels"]
        assert "namespace:team-x#cluster@cluster:cluster" in state["rels"]
        assert state["internal"]["lock"] == 0
        assert [i["status"] for i in state["journal"]] == ["completed"]

    @pytest.mark.parametrize("url", PORT_URLS)
    @pytest.mark.parametrize("lock_mode", ["Pessimistic", "Optimistic"])
    def test_delete_namespace(self, url, lock_mode):
        (create, delete), state = check(url, "delete_namespace", lock_mode)
        assert create[0] == 201 and delete[0] == 200
        assert "doomed" not in namespaces(state)
        assert not [r for r in state["rels"] if r.startswith("namespace:")]

    @pytest.mark.parametrize("url", PORT_URLS)
    def test_precondition_conflict(self, url):
        (first, second), _ = check(url, "precondition_conflict")
        assert first[0] == 201
        assert second[0] == 409 and second[1]["reason"] == "Conflict"

    @pytest.mark.parametrize("url", PORT_URLS)
    def test_delete_by_filter(self, url):
        (create, pods, delete), state = check(url, "delete_by_filter")
        assert create[0] == 201 and delete[0] == 200
        assert "pod:ns/p1#creator@user:alice" in pods
        assert not [r for r in state["rels"] if r.startswith("pod:")]


class TestCrashMatrix:
    @pytest.mark.parametrize("url", PORT_URLS)
    @pytest.mark.parametrize("lock_mode", ["Pessimistic", "Optimistic"])
    @pytest.mark.parametrize("failpoint", FAILPOINT_MATRIX)
    def test_create_survives_crash(self, url, lock_mode, failpoint):
        (resp,), state = check(url, "crash_create", lock_mode,
                               failpoint=failpoint)
        assert resp[0] in (201, 409), resp
        assert "crashy" in namespaces(state)
        assert "namespace:crashy#creator@user:alice" in state["rels"]
        assert state["internal"]["lock"] == 0
        # the crash was replayed from the journal, not lost
        assert state["journal"][0]["attempts"] == 1

    @pytest.mark.parametrize("url", PORT_URLS)
    @pytest.mark.parametrize("failpoint", ["panicReadSpiceDB",
                                           "panicSpiceDBReadResp"])
    def test_delete_by_filter_survives_crash(self, url, failpoint):
        obs, state = check(url, "delete_by_filter", failpoint=failpoint)
        assert obs[-1][0] == 200
        assert not [r for r in state["rels"] if r.startswith("pod:")]

    @pytest.mark.parametrize("url", PORT_URLS)
    def test_repeated_crashes_converge(self, url):
        (resp,), state = check(url, "crash_create",
                               failpoint="panicKubeWrite", times=3,
                               ns_name="stubborn")
        assert resp[0] == 201
        assert "stubborn" in namespaces(state)
        assert state["journal"][0]["attempts"] == 3


class TestLocking:
    @pytest.mark.parametrize("url", PORT_URLS)
    def test_lock_mutual_exclusion(self, url):
        (resp,), state = check(url, "lock_mutual_exclusion")
        assert resp[0] == 409
        assert "namespace:contested#creator@user:alice" not in state["rels"]
        assert "contested" not in namespaces(state)
        # the held lock stays, the workflow's own is rolled back
        assert state["internal"]["lock"] == 1

    @pytest.mark.parametrize("url", PORT_URLS)
    def test_rollback_on_kube_rejection(self, url):
        (resp,), state = check(url, "rollback_on_rejection")
        assert resp[0] == 403
        assert state["journal"] == []


class TestJournalRecovery:
    WRITE_INPUT = {
        "verb": "create", "request_uri": NS, "request_path": NS,
        "request_name": "", "api_group": "", "resource": "namespaces",
        "headers": {}, "user_name": "alice", "object_name": "revived",
        "body": json.dumps({"metadata": {"name": "revived"}}),
        "probe_uri": f"{NS}/revived",
        "creates": ["namespace:revived#creator@user:alice"],
        "touches": [], "deletes": [], "preconditions": [],
        "delete_by_filter": [],
    }

    @staticmethod
    def resume(pkg, url):
        """A pending instance left in the SQLite journal by a crashed
        process resumes on a fresh engine over the same file."""
        with tempfile.TemporaryDirectory() as tmp:
            db = os.path.join(tmp, "dtx.sqlite")
            proxy, kube = make_proxy(pkg, url, db_path=db)
            proxy.workflow_client.journal.create_instance(
                "inst-1", pkg.workflow.STRATEGY_PESSIMISTIC,
                TestJournalRecovery.WRITE_INPUT)

            async def restarted_process():
                engine, _ = pkg.client.setup_workflow_engine(
                    proxy.endpoint, pkg.httpcore.HandlerTransport(kube), db)
                count = await engine.run_pending_once()
                return count, journal_state(engine.journal)
            count, journal = run(restarted_process())
            user, counts = split_rels(proxy.endpoint.store)
            return count, journal, user, counts, kube_state(kube)

    @pytest.mark.parametrize("url", PORT_URLS)
    def test_resume_from_sqlite_after_restart(self, url):
        got = self.resume(PORT, url)
        assert got == self.resume(REF, "embedded://")
        count, journal, user, _, kube = got
        assert count == 1
        assert journal[0]["status"] == "completed"
        assert journal[0]["result"]["status_code"] == 201
        assert "namespace:revived#creator@user:alice" in user
        assert any(name == "revived" for _, _, name, _ in kube)

    @pytest.mark.parametrize("url", PORT_URLS)
    def test_replay_does_not_duplicate_side_effects(self, url):
        (resp, calls), state = check(url, "replay_counts")
        assert resp[0] in (201, 409)
        assert "once" in namespaces(state)
        # initial write + lock cleanup; the crashed kube write re-ran
        assert calls == {"spicedb": 2, "kube": 2}


class TestIdempotencyKeys:
    @pytest.mark.parametrize("url", PORT_URLS)
    def test_duplicate_spicedb_write_treated_as_success(self, url):
        (resp,), state = check(url, "crash_create",
                               failpoint="panicSpiceDBWriteResp",
                               ns_name="idem")
        assert resp[0] == 201
        assert "namespace:idem#creator@user:alice" in state["rels"]
        # the key of the replayed write outlives the workflow (24 h)
        assert state["internal"]["workflow"] >= 1
