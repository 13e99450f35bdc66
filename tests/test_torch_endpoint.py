"""`torch://?device=cpu` end to end, against `jax://` and the host oracle.

Every scenario loads the same bootstrap into the port's TorchEndpoint, the
reference JaxEndpoint and the reference's host Evaluator, then asks all
three the same checks and lookups (exact equality: the answers are sets
and booleans).  Covers unknown subjects (the phantom column), unknown
objects, userset subjects, wildcards, intersection/exclusion, and writes
and deletes followed by reads.
"""

import asyncio

import numpy as np
import pytest

from spicedb_kubeapi_proxy_tpu.models import workloads as ref_workloads
from spicedb_kubeapi_proxy_tpu.ops.jax_endpoint import JaxEndpoint
from spicedb_kubeapi_proxy_tpu.spicedb.endpoints import (
    Bootstrap as RefBootstrap)
from spicedb_kubeapi_proxy_tpu.spicedb.evaluator import Evaluator
from spicedb_kubeapi_proxy_tpu.spicedb.types import (
    CheckRequest as RefCheckRequest,
    ObjectRef as RefObjectRef,
    Permissionship as RefPermissionship,
    SubjectRef as RefSubjectRef,
)
from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
    Bootstrap, create_endpoint)
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
    CheckRequest,
    ObjectRef,
    RelationshipUpdate,
    SubjectRef,
    UpdateOp,
    parse_relationship,
)

WILDCARD_SCHEMA = """
definition user {}
definition bot {}
definition doc {
  relation viewer: user | user:* | bot
  relation editor: user
  permission view = viewer + editor
}
"""


def run(coro):
    return asyncio.run(coro)


def _endpoints(schema_text, rels):
    text = "\n".join(rels)
    port = create_endpoint("torch://?device=cpu",
                           Bootstrap(schema_text, text))
    jx = JaxEndpoint.from_bootstrap(RefBootstrap(schema_text, text))
    oracle = Evaluator(jx.schema, jx.store)
    return port, jx, oracle


def _ref_subject(s):
    return RefSubjectRef(s.type, s.id, s.relation)


def _assert_agree(port, jx, oracle, rtype, perm, subjects, objects):
    """Lookups (batched) and checks (bulk) equal across the three."""
    got = run(port.lookup_resources_batch(rtype, perm, subjects))
    ref = run(jx.lookup_resources_batch(rtype, perm,
                                        [_ref_subject(s) for s in subjects]))
    for s, g, r in zip(subjects, got, ref):
        want = sorted(oracle.lookup_resources(rtype, perm, _ref_subject(s)))
        assert sorted(g) == sorted(r) == want, s
    reqs = [CheckRequest(ObjectRef(rtype, o), perm, s)
            for o in objects for s in subjects]
    got = run(port.check_bulk_permissions(reqs))
    ref = run(jx.check_bulk_permissions(
        [RefCheckRequest(RefObjectRef(rtype, r.resource.id), perm,
                         _ref_subject(r.subject)) for r in reqs]))
    for req, g, r in zip(reqs, got, ref):
        want = oracle.check(RefObjectRef(rtype, req.resource.id), perm,
                            _ref_subject(req.subject))
        assert g.allowed == (r.permissionship
                             == RefPermissionship.HAS_PERMISSION) == want, req


def _users(*names):
    return [SubjectRef("user", n) for n in names]


@pytest.mark.parametrize("workload", ["nested_groups", "rbac_deny",
                                      "multitenant"])
def test_workload_answers_match_jax_and_oracle(workload):
    if workload == "nested_groups":
        w = ref_workloads.nested_groups(n_pods=200, n_users=80, n_groups=20,
                                        n_teams=5, n_namespaces=10)
    elif workload == "rbac_deny":
        w = ref_workloads.rbac_deny(n_pods=200, n_users=300, n_groups=10)
    else:
        w = ref_workloads.multitenant_1m(n_tenants=5, n_users=300,
                                         n_groups=30, n_namespaces=20,
                                         n_pods=400, n_tuples=2_000)
    port, jx, oracle = _endpoints(w.schema_text, w.relationships)
    rng = np.random.default_rng(11)
    # 40 known subjects plus first-contact ones (phantom column), so the
    # batch spans two packed words
    subjects = _users(*[w.subjects[i] for i in
                        rng.choice(len(w.subjects), 40, replace=False)],
                      "never-seen-1", "never-seen-2")
    objects = sorted(oracle.store.object_ids_of_type(w.resource_type))
    objects = [objects[i] for i in rng.choice(len(objects), 6,
                                              replace=False)]
    objects.append("no-such-object")
    _assert_agree(port, jx, oracle, w.resource_type, w.permission,
                  subjects, objects)
    # both verbs were answered on the device: by a sweep or, for a pair
    # the Leopard index flattened, by its closure plane — where jax://
    # answered them the same way
    served = ("kernel_calls", "leopard_checks", "leopard_lookups")
    assert [port.stats[k] for k in served] == [jx.stats[k] for k in served]
    assert (port.stats["kernel_calls"] + bool(port.stats["leopard_checks"])
            + bool(port.stats["leopard_lookups"])) >= 2
    assert port.stats["rebuilds"] == 1


def test_wildcard_userset_and_unknown_subjects():
    port, jx, oracle = _endpoints(WILDCARD_SCHEMA, [
        "doc:d1#viewer@user:*", "doc:d2#editor@user:eve",
        "doc:d3#viewer@user:frank", "doc:d4#viewer@bot:b1"])
    _assert_agree(port, jx, oracle, "doc", "view",
                  _users("eve", "frank", "zed") + [SubjectRef("bot", "b1"),
                                                    SubjectRef("bot", "b2")],
                  ["d1", "d2", "d3", "d4", "d9"])


def test_write_then_read_sees_the_write():
    rels = ["group:eng#member@user:alice",
            "namespace:ns1#viewer@group:eng#member",
            "namespace:ns2#viewer@user:bob"]
    schema = """
definition user {}
definition group { relation member: user | group#member }
definition namespace {
  relation viewer: user | group#member
  permission view = viewer
}
"""
    port, jx, oracle = _endpoints(schema, rels)
    subjects = _users("alice", "bob", "carol")
    _assert_agree(port, jx, oracle, "namespace", "view", subjects,
                  ["ns1", "ns2", "ns3"])
    updates = ["group:eng#member@user:carol", "namespace:ns3#viewer@user:bob"]
    run(port.write_relationships(
        [RelationshipUpdate(UpdateOp.TOUCH, parse_relationship(r))
         for r in updates]))
    from spicedb_kubeapi_proxy_tpu.spicedb.types import (
        RelationshipUpdate as RefUpdate, UpdateOp as RefOp,
        parse_relationship as ref_parse)
    run(jx.write_relationships([RefUpdate(RefOp.TOUCH, ref_parse(r))
                                for r in updates]))
    got = run(port.lookup_resources("namespace", "view",
                                    SubjectRef("user", "carol")))
    assert sorted(got) == ["ns1"]
    _assert_agree(port, jx, oracle, "namespace", "view", subjects,
                  ["ns1", "ns2", "ns3"])
    # delete: the next read must not see the removed grant
    gone = "namespace:ns1#viewer@group:eng#member"
    run(port.write_relationships(
        [RelationshipUpdate(UpdateOp.DELETE, parse_relationship(gone))]))
    run(jx.write_relationships([RefUpdate(RefOp.DELETE, ref_parse(gone))]))
    assert run(port.lookup_resources("namespace", "view",
                                     SubjectRef("user", "alice"))) == []
    _assert_agree(port, jx, oracle, "namespace", "view", subjects,
                  ["ns1", "ns2", "ns3"])
    # the writes (new ids on spare rows) and the delete were absorbed
    # incrementally, as the reference absorbs them
    assert port.stats["rebuilds"] == jx.stats["rebuilds"] == 1
    assert port.stats["spare_assignments"] == 2
    assert port.stats["delta_batches"] == 2


def test_checks_report_revision_and_source():
    port, _, _ = _endpoints(WILDCARD_SCHEMA, ["doc:d2#editor@user:eve"])
    kernels.reset_launches()
    res = run(port.check_permission(
        CheckRequest(ObjectRef("doc", "d2"), "view", SubjectRef("user",
                                                                "eve"))))
    assert res.allowed and res.source == "kernel"
    assert res.checked_at == port.store.revision
    # CPU tensors run the twins: no CUDA launch is ever counted
    assert not any(kernels.LAUNCHES.values())
