"""The port's proxy modules held against the reference's on shared inputs.

- `config/proxyrule.py`: `parse` of deploy/rules.yaml and of the e2e
  tests' rule strings (`dataclasses.asdict` equal), `parse_doc` of
  chip_smoke.py's phase-16 rule mappings, which equal the file's
  documents of the same names.
- `proxy/kube.py`: `parse_request_info` over a table of methods and URLs,
  and over generated paths (hypothesis).
- `rules/engine.py`: every rule compiled by both packages and every one
  of its relationship templates resolved against the same request
  inputs; CEL conditions evaluated on the same inputs; the matcher's
  choice of rules.
- `proxy/k8sproto.py`: list, object, Table and watch-event encodings
  byte for byte, their decodings and filters.
- `proxy/authn.py`: the header, token-file and anonymous authenticators'
  `UserInfo`.
- `utils/admission.py`: `LoadShedder` decisions on the reference
  tests/test_admission.py cases.

Tolerance is zero: the outputs are strings, bytes and decisions.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from spicedb_kubeapi_proxy_tpu.config import proxyrule as ref_rule
from spicedb_kubeapi_proxy_tpu.proxy import authn as ref_authn
from spicedb_kubeapi_proxy_tpu.proxy import httpcore as ref_http
from spicedb_kubeapi_proxy_tpu.proxy import k8sproto as ref_proto
from spicedb_kubeapi_proxy_tpu.proxy import kube as ref_kube
from spicedb_kubeapi_proxy_tpu.rules import engine as ref_engine
from spicedb_kubeapi_proxy_tpu.utils import admission as ref_adm
from spicedb_kubeapi_proxy_tpu.utils.features import GATES
from spicedb_kubeapi_proxy_tpu_torch.config import proxyrule as port_rule
from spicedb_kubeapi_proxy_tpu_torch.proxy import authn as port_authn
from spicedb_kubeapi_proxy_tpu_torch.proxy import httpcore as port_http
from spicedb_kubeapi_proxy_tpu_torch.proxy import k8sproto as port_proto
from spicedb_kubeapi_proxy_tpu_torch.proxy import kube as port_kube
from spicedb_kubeapi_proxy_tpu_torch.rules import engine as port_engine
from spicedb_kubeapi_proxy_tpu_torch.utils import admission as port_adm
from spicedb_kubeapi_proxy_tpu_torch.utils import features
from test_e2e_parity import CRD_RULES, GZIP_RULES
from test_proxy_e2e import RULES

ROOT = Path(__file__).resolve().parents[1]
DEPLOY_RULES = (ROOT / "deploy" / "rules.yaml").read_text()
RULE_SOURCES = {"deploy": DEPLOY_RULES, "e2e": RULES, "crd": CRD_RULES,
                "gzip": GZIP_RULES}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- config/proxyrule.py -------------------------------------------------------

@pytest.mark.parametrize("source", sorted(RULE_SOURCES))
def test_rule_parse_matches_reference(source):
    ref = ref_rule.parse(RULE_SOURCES[source])
    port = port_rule.parse(RULE_SOURCES[source])
    assert [dataclasses.asdict(c) for c in port] == \
        [dataclasses.asdict(c) for c in ref]


def test_phase16_rules_are_deploy_read_rules():
    """chip_smoke.py's phase-16 mappings are deploy/rules.yaml's
    documents of the same names, and parse_doc (no yaml) gives the
    reference's Configs for them."""
    dicts = _chip_smoke().PROXY_READ_RULES
    docs = {d["metadata"]["name"]: d
            for d in yaml.safe_load_all(DEPLOY_RULES) if d}
    names = [d["metadata"]["name"] for d in dicts]
    assert names == ["namespace-read", "namespace-enumerate", "pod-read",
                     "pod-enumerate", "event-postfilter"]
    assert dicts == [docs[n] for n in names]
    ref = {c.name: c for c in ref_rule.parse(DEPLOY_RULES)}
    assert [dataclasses.asdict(port_rule.parse_doc(d)) for d in dicts] == \
        [dataclasses.asdict(ref[n]) for n in names]


@pytest.mark.parametrize("bad", [
    "apiVersion: x\nkind: ProxyRule\nmetadata: {name: a}\n",
    "apiVersion: x\nkind: ProxyRule\nmetadata: {name: a}\n"
    "match: [{apiVersion: v1, resource: pods, verbs: [frob]}]\n",
    "apiVersion: x\nkind: ProxyRule\nmetadata: {name: a}\nlock: Maybe\n"
    "match: [{apiVersion: v1, resource: pods, verbs: [get]}]\n",
])
def test_rule_validation_errors_match_reference(bad):
    with pytest.raises(ref_rule.RuleValidationError) as ref_err:
        ref_rule.parse(bad)
    with pytest.raises(port_rule.RuleValidationError) as port_err:
        port_rule.parse(bad)
    assert str(port_err.value) == str(ref_err.value)


# -- proxy/kube.py ---------------------------------------------------------------

REQUEST_TABLE = [
    ("GET", "/api"), ("GET", "/apis"), ("GET", "/openapi/v2"),
    ("GET", "/healthz"), ("POST", "/api/v1"),
    ("GET", "/api/v1/pods"), ("GET", "/api/v1/pods?watch=true"),
    ("GET", "/api/v1/pods?watch=1&labelSelector=a%3Db"),
    ("GET", "/api/v1/namespaces"), ("GET", "/api/v1/namespaces/ns1"),
    ("GET", "/api/v1/namespaces/ns1/status"),
    ("PUT", "/api/v1/namespaces/ns1/finalize"),
    ("GET", "/api/v1/namespaces/ns1/pods"),
    ("GET", "/api/v1/namespaces/ns1/pods/p1"),
    ("GET", "/api/v1/namespaces/ns1/pods/p1/log"),
    ("GET", "/api/v1/namespaces/ns1/pods?fieldSelector=x%3Dy"),
    ("POST", "/api/v1/namespaces/ns1/pods"),
    ("PUT", "/api/v1/namespaces/ns1/pods/p1"),
    ("PATCH", "/api/v1/namespaces/ns1/pods/p1"),
    ("DELETE", "/api/v1/namespaces/ns1/pods/p1"),
    ("DELETE", "/api/v1/namespaces/ns1/pods"),
    ("GET", "/apis/apps/v1/deployments"),
    ("GET", "/apis/apps/v1/namespaces/ns/deployments/d?watch=true"),
    ("GET", "/apis/example.com/v1/namespaces/team-a/testresources/alpha"),
    ("GET", "/apis/example.com"), ("HEAD", "/api/v1/pods"),
    ("OPTIONS", "/api/v1/namespaces/x/pods/y"),
    ("GET", "/api/v1/watch/pods"), ("GET", "/api/v1/nodes/n1"),
]


@pytest.mark.parametrize("method,url", REQUEST_TABLE)
def test_parse_request_info_matches_reference(method, url):
    assert dataclasses.asdict(port_kube.parse_request_info(method, url)) == \
        dataclasses.asdict(ref_kube.parse_request_info(method, url))


_SEG = st.sampled_from(["api", "apis", "v1", "apps", "namespaces", "ns",
                        "pods", "p", "status", "watch", "log", ""])


@settings(max_examples=200, deadline=None, database=None)
@given(method=st.sampled_from(["GET", "POST", "PUT", "PATCH", "DELETE"]),
       segs=st.lists(_SEG, max_size=8),
       query=st.sampled_from(["", "?watch=true", "?watch=false",
                              "?labelSelector=a", "?watch=1&x=y"]))
def test_parse_request_info_generated(method, segs, query):
    url = "/" + "/".join(segs) + query
    assert dataclasses.asdict(port_kube.parse_request_info(method, url)) == \
        dataclasses.asdict(ref_kube.parse_request_info(method, url))


# -- rules/engine.py --------------------------------------------------------------

# (method, url, user, groups, body) inputs every rule is resolved against
INPUTS = [
    ("GET", "/api/v1/namespaces/team-a/pods/p0", "alice", [], b""),
    ("GET", "/api/v1/namespaces/team-a", "bob", ["devs"], b""),
    ("GET", "/api/v1/pods", "carol", ["admins"], b""),
    ("GET", "/api/v1/namespaces/ns1/events", "u1", [], b""),
    ("POST", "/api/v1/namespaces/team-a/pods", "alice",
     ["system:operators"],
     json.dumps({"metadata": {"name": "web", "namespace": "team-a",
                              "labels": {"tenant": "t1"}},
                 "spec": {"shareWith": ["bob", "carol"]}}).encode()),
    ("POST", "/api/v1/namespaces", "dave", [],
     json.dumps({"metadata": {"name": "ns9",
                              "labels": {"tenant": "t3"}}}).encode()),
    ("DELETE", "/api/v1/namespaces/ns9", "dave", [], b""),
    ("POST", "/apis/example.com/v1/namespaces/team-c/testresources", "bob",
     [], json.dumps({"metadata": {"name": "gamma"}}).encode()),
]


def _inputs(kube, engine, authn):
    out = []
    for method, url, user, groups, body in INPUTS:
        info = kube.parse_request_info(method, url)
        u = kube.UserInfo(name=user, groups=list(groups))
        headers = {"Content-Type": ["application/json"]} if body else {}
        out.append(engine.resolve_input_from_request(info, u, body, headers))
    return out


def _resolve_all(expr_list, inp, engine):
    out = []
    for expr in expr_list:
        try:
            out.append([r.rel_string()
                        for r in expr.generate_relationships(inp)])
        except engine.ResolveError as e:
            out.append(("error", str(e)))
    return out


def _rule_outputs(rule, inp, engine):
    """Everything a compiled rule yields for one input: its structure,
    CEL verdict and each template resolved."""
    try:
        cel = engine.evaluate_cel_conditions(rule.if_conditions, inp)
    except engine.ResolveError as e:
        cel = ("error", str(e))
    u = rule.update
    return {
        "name": rule.name, "lock": rule.lock_mode, "cel": cel,
        "checks": _resolve_all(rule.checks, inp, engine),
        "post_checks": _resolve_all(rule.post_checks, inp, engine),
        "pre_filter": _resolve_all([p.rel for p in rule.pre_filter], inp,
                                   engine),
        "post_filter": _resolve_all([p.rel for p in rule.post_filter], inp,
                                    engine),
        "update": None if u is None else {
            k: _resolve_all(getattr(u, k), inp, engine)
            for k in ("must_exist", "must_not_exist", "creates", "touches",
                      "deletes", "deletes_by_filter")},
    }


def _pkg_outputs(source, rule_mod, engine, kube, authn):
    rules = [engine.compile_rule(c) for c in rule_mod.parse(source)]
    return [[_rule_outputs(r, inp, engine) for r in rules]
            for inp in _inputs(kube, engine, authn)]


@pytest.mark.parametrize("source", sorted(RULE_SOURCES))
def test_compile_and_resolve_match_reference(source):
    ref = _pkg_outputs(RULE_SOURCES[source], ref_rule, ref_engine, ref_kube,
                       ref_authn)
    port = _pkg_outputs(RULE_SOURCES[source], port_rule, port_engine,
                        port_kube, port_authn)
    assert port == ref
    # the comparison saw resolved relationships, not only errors
    flat = json.dumps(ref)
    assert "@user:" in flat


@pytest.mark.parametrize("source", sorted(RULE_SOURCES))
def test_matcher_and_prefilter_ids_match_reference(source):
    """The rules each request matches, and the (namespace, name) a
    prefilter maps object ids to."""
    from spicedb_kubeapi_proxy_tpu.authz import lookups as ref_lookups
    from spicedb_kubeapi_proxy_tpu_torch.authz import lookups as port_lookups

    def outputs(rule_mod, engine, kube, lookups):
        matcher = engine.MapMatcher(rule_mod.parse(RULE_SOURCES[source]))
        out = []
        for (method, url, *_), inp in zip(
                INPUTS + [("GET", "/api/v1/pods", 0, 0, 0),
                          ("GET", "/api/v1/namespaces", 0, 0, 0)],
                _inputs(kube, engine, None) + [None, None]):
            info = kube.parse_request_info(method, url)
            rules = matcher.match(info)
            out.append([r.name for r in rules])
            if inp is None:
                inp = engine.resolve_input_from_request(
                    info, kube.UserInfo(name="u1"), b"", {})
            for r in rules:
                for p in r.pre_filter:
                    rel = engine.resolve_rel(p.rel, inp)
                    flt = engine.ResolvedPreFilter(
                        name_from_object_id=p.name_from_object_id,
                        namespace_from_object_id=p.namespace_from_object_id,
                        rel=rel)
                    for rid in ("ns1/p1", "team-a/alpha", "ns9", "a/b/c"):
                        try:
                            out.append(lookups.extract_namespaced_name(
                                flt, inp, rid))
                        except lookups.PreFilterError as e:
                            out.append(("error", str(e)))
        return out

    assert outputs(port_rule, port_engine, port_kube, port_lookups) == \
        outputs(ref_rule, ref_engine, ref_kube, ref_lookups)


class _IdStream:
    """An endpoint whose lookup streams fixed ids."""

    def __init__(self, ids):
        self.ids = ids

    async def lookup_resources_stream(self, resource_type, permission,
                                      subject):
        for rid in self.ids:
            yield rid


# a list rule whose namespace comes from the request, not the id
FROM_REQUEST_RULES = """
apiVersion: authzed.com/v1alpha1
kind: ProxyRule
metadata: {name: list-pods-in-request-namespace}
match: [{apiVersion: v1, resource: pods, verbs: [list]}]
prefilter:
- fromObjectIDNamespaceExpr: "{{request.namespace}}"
  fromObjectIDNameExpr: "{{split_name(resourceId)}}"
  lookupMatchingResources: {tpl: "pod:$#view@user:{{user.name}}"}
"""


@pytest.mark.parametrize("source", ["deploy", "e2e", "from-request"])
def test_prefilter_lookups_match_reference_when_ids_repeat(source):
    """`run_lookup_resources` over requests in two namespaces and two
    users, each asked twice, so the port's id memo is hit across rules,
    requests and users: the same allowed sets (or errors) as the
    reference's."""
    import asyncio

    from spicedb_kubeapi_proxy_tpu.authz import lookups as ref_lookups
    from spicedb_kubeapi_proxy_tpu_torch.authz import lookups as port_lookups

    ids = ["ns1/p1", "ns2/p2", "team-a/alpha", "ns9", "a/b/c", "ns1/p1"]

    def outputs(rule_mod, engine, kube, lookups):
        matcher = engine.MapMatcher(rule_mod.parse(
            FROM_REQUEST_RULES if source == "from-request"
            else RULE_SOURCES[source]))
        out = []
        for _ in range(2):
            for url in ("/api/v1/pods", "/api/v1/namespaces/ns1/pods",
                        "/api/v1/namespaces/ns2/pods",
                        "/api/v1/namespaces"):
                for user in ("u1", "u2"):
                    info = kube.parse_request_info("GET", url)
                    inp = engine.resolve_input_from_request(
                        info, kube.UserInfo(name=user), b"", {})
                    for r in matcher.match(info):
                        for p in r.pre_filter:
                            flt = engine.ResolvedPreFilter(
                                name_from_object_id=p.name_from_object_id,
                                namespace_from_object_id=(
                                    p.namespace_from_object_id),
                                rel=engine.resolve_rel(p.rel, inp))
                            try:
                                res = asyncio.run(lookups.run_lookup_resources(
                                    _IdStream(ids), flt, inp))
                                out.append(sorted(res.allowed))
                            except lookups.PreFilterError as e:
                                out.append(("error", str(e)))
        return out

    ref = outputs(ref_rule, ref_engine, ref_kube, ref_lookups)
    assert any(isinstance(o, list) and o for o in ref)
    if source == "from-request":
        assert ("ns1", "p2") in ref[2] and ("ns2", "p2") in ref[4]
    assert outputs(port_rule, port_engine, port_kube, port_lookups) == ref


# -- kubefake/apiserver.py ------------------------------------------------------------

def test_fake_apiserver_lists_follow_every_write():
    """The port's fake encodes a list body once until the next write:
    after each kind of write (seed, create, update, patch, delete,
    deletecollection) its JSON, protobuf and Table lists hold what the
    reference fake's do."""
    import asyncio

    from spicedb_kubeapi_proxy_tpu.kubefake import apiserver as ref_fake
    from spicedb_kubeapi_proxy_tpu_torch.kubefake import apiserver as port_fake

    proto = "application/vnd.kubernetes.protobuf"
    table = "application/json;as=Table;v=v1;g=meta.k8s.io"

    def pod(name, ns, **labels):
        return json.dumps({"metadata": {"name": name, "namespace": ns,
                                        "labels": labels}}).encode()

    def run(fake_mod, http, k8sproto):
        kube = fake_mod.FakeKubeApiServer()
        for i in range(4):
            kube.seed("", "v1", "pods", {"metadata": {
                "name": f"p{i}", "namespace": f"ns{i % 2}",
                "labels": {"app": "a" if i % 2 else "b"}}})

        async def call(method, target, body=b"", accept=None):
            headers = http.Headers([("Accept", accept)] if accept else [])
            return await kube(http.Request(method, target, headers, body))

        async def lists():
            out = []
            for target in ("/api/v1/pods", "/api/v1/namespaces/ns0/pods",
                           "/api/v1/pods?labelSelector=app%3Da"):
                body = json.loads((await call("GET", target)).body)
                out.append((body["metadata"]["resourceVersion"], [
                    (i["metadata"]["namespace"], i["metadata"]["name"],
                     i["metadata"]["resourceVersion"],
                     i["metadata"].get("labels"))
                    for i in body["items"]]))
            resp = await call("GET", "/api/v1/pods", accept=proto)
            _, _, raw, _ = k8sproto.decode_unknown(resp.body)
            out.append(sorted("/".join(k8sproto.object_meta(i))
                              for i in k8sproto.iter_list_items(raw)))
            rows = json.loads((await call("GET", "/api/v1/pods",
                                          accept=table)).body)["rows"]
            out.append(sorted(r["cells"][0] for r in rows))
            return out

        async def go():
            seen = [await lists(), await lists()]
            writes = [
                ("POST", "/api/v1/namespaces/ns0/pods", pod("c", "ns0")),
                ("PUT", "/api/v1/namespaces/ns0/pods/c",
                 pod("c", "ns0", app="a")),
                ("PATCH", "/api/v1/namespaces/ns1/pods/p1",
                 b'{"metadata": {"labels": {"app": "z"}}}'),
                ("DELETE", "/api/v1/namespaces/ns0/pods/p0", b""),
                ("DELETE", "/api/v1/namespaces/ns1/pods?labelSelector="
                 "app%3Da", b""),
            ]
            for method, target, body in writes:
                resp = await call(method, target, body)
                seen.append((resp.status, await lists()))
            kube.seed("", "v1", "pods", {"metadata": {
                "name": "s", "namespace": "ns0"}})
            seen.append(await lists())
            return seen

        return asyncio.run(go())

    ref = run(ref_fake, ref_http, ref_proto)
    assert len({json.dumps(x) for x in ref}) == len(ref) - 1
    assert run(port_fake, port_http, port_proto) == ref


# -- proxy/k8sproto.py ----------------------------------------------------------------

def _encodings(p):
    objs = [p.encode_object("v1", "Pod", f"p{i}", f"ns{i % 3}")
            for i in range(7)]
    lst = p.encode_list("v1", "PodList", objs)
    get = p.encode_unknown("v1", "Pod", objs[0],
                           "application/vnd.kubernetes.protobuf")
    rows = [p.encode_unknown(
        "meta.k8s.io/v1", "PartialObjectMetadata",
        p.encode_object("meta.k8s.io/v1", "PartialObjectMetadata",
                        f"p{i}", f"ns{i % 3}")) for i in range(5)]
    table = p.encode_table(rows)
    watch = p.encode_watch_event("ADDED", get)
    table_watch = p.encode_watch_event("MODIFIED", p.encode_table(rows[:1]))
    return {"objs": objs, "list": lst, "get": get, "table": table,
            "watch": watch, "table_watch": table_watch}


def _decodings(p, enc):
    def allowed(ns, name):
        return ns != "ns1" and name != "p4"
    _, _, lraw, _ = p.decode_unknown(enc["list"])
    _, _, traw, _ = p.decode_unknown(enc["table"])
    ev, av, kind, raw = p.decode_watch_event(enc["table_watch"][4:])
    return {
        "list": p.decode_unknown(enc["list"]),
        "items": [p.object_meta(i) for i in p.iter_list_items(lraw)],
        "list_filtered": p.filter_list_raw(lraw, allowed),
        "table_filtered": p.filter_table_raw(traw, allowed),
        "get": p.object_meta(p.decode_unknown(enc["get"])[2]),
        "watch": p.decode_watch_event(enc["watch"][4:]),
        "table_watch": (ev, av, kind, p.table_first_row_meta(raw)),
        "records": list(p.records(enc["get"][4:])),
        "is_proto": [p.is_k8s_proto(enc["list"]), p.is_k8s_proto(b"{}")],
    }


def test_k8sproto_encodings_match_reference():
    ref, port = _encodings(ref_proto), _encodings(port_proto)
    assert port == ref
    assert _decodings(port_proto, ref) == _decodings(ref_proto, ref)


@pytest.mark.parametrize("cut", [1, 4, 9])
def test_k8sproto_truncation_errors_match_reference(cut):
    body = _encodings(ref_proto)["list"][:-cut]
    errs = []
    for p in (ref_proto, port_proto):
        try:
            _, _, raw, _ = p.decode_unknown(body)
            errs.append(("ok", p.filter_list_raw(raw, lambda ns, n: True)))
        except p.K8sProtoError as e:
            errs.append(("error", str(e)))
    assert errs[0] == errs[1]


# -- proxy/authn.py -------------------------------------------------------------------

def _auth_requests(http):
    H = http.Headers
    return [
        http.Request("GET", "/api", headers=H([
            ("X-Remote-User", "alice"), ("X-Remote-Group", "devs"),
            ("X-Remote-Group", "admins"),
            ("X-Remote-Extra-Scopes", "a"), ("X-Remote-Extra-Scopes", "b")])),
        http.Request("GET", "/api", headers=H([("X-Remote-Group", "x")])),
        http.Request("GET", "/api", headers=H([
            ("Authorization", "Bearer tok-1")])),
        http.Request("GET", "/api", headers=H([
            ("Authorization", "Bearer tok-2")])),
        http.Request("GET", "/api", headers=H([
            ("Authorization", "Bearer nope")])),
        http.Request("GET", "/api", headers=H([
            ("Authorization", "Basic tok-1")])),
        http.Request("GET", "/api", peer_cert={"subject": (
            (("commonName", "svc"),), (("organizationName", "ops"),))}),
    ]


def test_authenticators_match_reference(tmp_path):
    tokens = tmp_path / "tokens.csv"
    tokens.write_text('tok-1,alice,uid-1,"devs,ops"\ntok-2,bob,uid-2\n'
                      'short,row\n')

    def users(authn, http):
        chains = [
            authn.HeaderAuthenticator(),
            authn.TokenFileAuthenticator(str(tokens)),
            authn.ClientCertAuthenticator(),
            authn.AuthenticatorChain([
                authn.TokenFileAuthenticator(str(tokens)),
                authn.HeaderAuthenticator(),
                authn.ClientCertAuthenticator(),
                authn.AnonymousAuthenticator()]),
        ]
        out = []
        for a in chains:
            for r in _auth_requests(http):
                u = a.authenticate(r)
                out.append(None if u is None else dataclasses.asdict(u))
        return out

    ref = users(ref_authn, ref_http)
    assert users(port_authn, port_http) == ref
    assert {"name": "alice", "uid": "uid-1", "groups": ["devs", "ops"],
            "extra": {}} in ref


# -- utils/admission.py LoadShedder ---------------------------------------------------

def _shedder_cases(adm, set_gate):
    """tests/test_admission.py TestLoadShedder's queue-depth cases, as
    decision sequences, with the depth read through `depth_fn` (the one
    signal the port's shedder takes)."""
    out = []
    depth = {"check_queue_depth": 5, "lr_queue_depth": 3}
    s = adm.LoadShedder(shed_queue_depth=8, retry_after_s=2.0,
                        depth_fn=lambda: sum(depth.values()))
    out += [s.check("list"), s.shedding_recently(), s.check("create"),
            s.check("delete")]
    depth["check_queue_depth"] = 0
    out.append(s.check("list"))
    s = adm.LoadShedder(depth_fn=lambda: 99)
    out.append(s.check("list"))
    s2 = adm.LoadShedder(shed_queue_depth=1, depth_fn=lambda: 99)
    set_gate(False)
    try:
        out.append(s2.check("list"))
    finally:
        set_gate(True)
    out.append(s2.check("list"))
    s = adm.LoadShedder(shed_queue_depth=1, depth_fn=lambda: 2)
    out.append(s.check("list"))
    snap = s.snapshot()
    out.append((snap["shed_total"], snap["shedding_recently"]))
    s = adm.LoadShedder(shed_queue_depth=3, depth_fn=lambda: 3)
    out += [s.check("watch"), s.check("patch"), s.retry_after_s,
            adm.LoadShedder(retry_after_s=0).retry_after_s]

    def broken():
        raise RuntimeError("no depth")
    s = adm.LoadShedder(shed_queue_depth=1, depth_fn=broken)
    out.append(s.check("get"))
    return out


def test_load_shedder_matches_reference():
    def ref_gate(on):
        GATES.set("AdmissionControl", on)

    def port_gate(on):
        features.ADMISSION_CONTROL = on

    before = dict(port_adm.REJECTED)
    ref = _shedder_cases(ref_adm, ref_gate)
    assert _shedder_cases(port_adm, port_gate) == ref
    assert ref[0] == "queue_depth" and ref[4] is None
    # a rejection counts once per reason, never with the switch off
    assert port_adm.REJECTED["queue_depth"] == \
        before.get("queue_depth", 0) + 4
    assert port_adm.READ_ONLY_VERBS == ref_adm.READ_ONLY_VERBS
    # the SLO-burn and stats inputs are left out, not silently ignored
    for kw in ({"shed_on_burn": True}, {"burning_fn": list},
               {"stats_fn": dict}):
        with pytest.raises(TypeError):
            port_adm.LoadShedder(**kw)
