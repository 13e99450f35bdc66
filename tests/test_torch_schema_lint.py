"""The port's schema lint held against the reference's.

`lint_schema` of both packages runs on the same schemas, rules and
partition maps, and their findings must be equal as (code, severity,
where, message), in order: every case of the reference's
tests/test_schema_lint.py (SL001-SL009, the internal types' exemption,
the sharding co-location rules), the reference's sharding test schema
and rules under its maps, every schema of `models/workloads.py` (with
and without a derived two-shard map), and deploy/'s bootstrap and rules.
The SL009 budget numbers come from each package's own Leopard module,
under the same environment.  Both CLIs' `--lint-schema` runs (text and
`--lint-schema-json`, strict and not, with and without a partition map,
inputs that would not boot) print the same output and exit with the
same code.
"""

import importlib
import inspect
import json
import pathlib

import pytest

import test_schema_lint as RL
from test_tuple_sharding import PMAP_SPEC, RULES as SHARD_RULES, \
    SCHEMA as SHARD_SCHEMA

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEPLOY = ROOT / "deploy"


class LPkg:
    def __init__(self, root: str):
        def mod(name):
            return importlib.import_module(f"{root}.{name}")
        self.sch = mod("spicedb.schema")
        self.endpoints = mod("spicedb.endpoints")
        self.proxyrule = mod("config.proxyrule")
        self.lint = mod("spicedb.schema_lint")
        self.sharding = mod("spicedb.sharding")
        self.workloads = mod("models.workloads")
        self.cli = mod("cli")


REF = LPkg("spicedb_kubeapi_proxy_tpu")
PORT = LPkg("spicedb_kubeapi_proxy_tpu_torch")

# the reference test's rule documents that name the islands rule
ISLAND_RULE = """
apiVersion: authzed.com/v1alpha1
kind: ProxyRule
metadata: {name: create-islands}
match: [{apiVersion: v1, resource: islands, verbs: [create]}]
check: [{tpl: "namespace:{{namespace}}#view@user:{{user.name}}"}]
update:
  creates:
  - tpl: "island:{{name}}#owner@user:{{user.name}}"
"""
AUDIT_RULE = """
apiVersion: authzed.com/v1alpha1
kind: ProxyRule
metadata: {name: audit}
match: [{apiVersion: v1, resource: docs, verbs: [get]}]
check: [{tpl: "doc:{{name}}#auditor@user:{{user.name}}"}]
"""
AUDIT_SCHEMA = """
definition user {}
definition doc {
  relation auditor: user
  relation viewer: user
  permission view = viewer
}
"""
PLAIN_DOC = """
definition user {}
definition doc {
  relation viewer: user
  permission view = viewer
}
"""
SL006_SCHEMAS = ["""
definition user {}
definition group { relation member: user }
definition ns {
  relation viewer: group#member with expiration
  relation creator: user
  permission view = viewer + creator
}
""", """
definition user {}
definition group { relation member: user }
definition ns {
  relation viewer: group#member with expiration
  relation auditor: group#member
  permission view = viewer + auditor
}
""", """
definition user {}
definition org {
  relation admin: user
}
definition ns {
  relation org: org with expiration
  permission view = org->admin
}
"""]
SL009_SCHEMA = """
definition user {}
definition group {
  relation member: user | group#member
  permission view = member
}
definition doc {
  relation viewer: user | group#member
  relation banned: user
  permission view = viewer
  permission allowed = view - banned
}
"""

# (schema text, merge internal definitions, rules text, partition map
# spec, shard count, ghost caveat on doc#viewer)
CASES = {
    "clean": (PLAIN_DOC, False, RL.RULES_OK, None, None, False),
    "footprints": (RL.SCHEMA, False, RL.RULES_OK, None, None, False),
    "rule_errors": (RL.SCHEMA, False, RL.RULES_BAD, None, None, False),
    "rule_keeps_reachable": (AUDIT_SCHEMA, False, AUDIT_RULE, None, None,
                             False),
    "unreachable_without_rule": (AUDIT_SCHEMA, False, "", None, None, False),
    "internal_exempt": (PLAIN_DOC, True, "", None, None, False),
    "sl005_rule": (RL.CAVEAT_SCHEMA, False, RL.RULES_CAVEAT_BAD, None, None,
                   False),
    "sl005_rule_ok": (RL.CAVEAT_SCHEMA, False, RL.RULES_CAVEAT_OK, None,
                      None, False),
    "sl005_programmatic": (PLAIN_DOC, False, "", None, None, True),
    "sl006_expiring": (SL006_SCHEMAS[0], False, "", None, None, False),
    "sl006_durable": (SL006_SCHEMAS[1], False, "", None, None, False),
    "sl006_arrow": (SL006_SCHEMAS[2], False, "", None, None, False),
    "sl007_permission": (RL.SHARDED_SCHEMA, False, "", "pod=1", 2, False),
    "sl007_colocated": (RL.SHARDED_SCHEMA, False, "", "pod=1,namespace=1",
                        2, False),
    "sl007_rule": (RL.SHARDED_SCHEMA, False, ISLAND_RULE, "island=1", 2,
                   False),
    "sl007_rule_ok": (RL.SHARDED_SCHEMA, False, ISLAND_RULE, "island=0", 2,
                      False),
    "sl008": (RL.SHARDED_SCHEMA, False, "", "podd=1", 2, False),
    "sl009": (SL009_SCHEMA, False, "", None, None, False),
    "sharding_spanning_rule": (SHARD_SCHEMA, True, SHARD_RULES, "pod=1", 2,
                               False),
    "sharding_unknown_type": (SHARD_SCHEMA, True, "", "mystery=1", 2, False),
    "sharding_clean": (SHARD_SCHEMA, True, SHARD_RULES, PMAP_SPEC, 2, False),
    "sharding_three_shards": (SHARD_SCHEMA, True, SHARD_RULES,
                              "pod=2,podns=1", 3, False),
    "sharding_no_map": (SHARD_SCHEMA, True, SHARD_RULES, None, None, False),
}


def findings(P, schema_text, merge, rules_text, spec, n, ghost):
    schema = P.sch.parse_schema(schema_text)
    if merge:
        schema = P.endpoints.merge_internal_definitions(schema)
    if ghost:
        schema.definitions["doc"].relations["viewer"].append(
            P.sch.TypeRef(type="user", traits=("ghost",)))
    rules = P.proxyrule.parse(rules_text) if rules_text else []
    pm = (P.sharding.PartitionMap.parse(spec, n_shards=n)
          if spec is not None else None)
    return [(f.code, f.severity, f.where, f.message)
            for f in P.lint.lint_schema(schema, rules, partition_map=pm)]


@pytest.mark.parametrize("budget", ["1024", None])
@pytest.mark.parametrize("name", sorted(CASES))
def test_findings_match_the_reference(name, budget, monkeypatch):
    monkeypatch.setenv("SPICEDB_TPU_LEOPARD_LINT_OBJECTS", "100000")
    if budget is None:
        monkeypatch.delenv("SPICEDB_TPU_LEOPARD_BUDGET_BYTES", raising=False)
    else:
        monkeypatch.setenv("SPICEDB_TPU_LEOPARD_BUDGET_BYTES", budget)
    got = findings(PORT, *CASES[name])
    assert got == findings(REF, *CASES[name])


def test_findings_hold_the_reference_tests_asserts(monkeypatch):
    monkeypatch.setenv("SPICEDB_TPU_LEOPARD_LINT_OBJECTS", "100000")
    monkeypatch.setenv("SPICEDB_TPU_LEOPARD_BUDGET_BYTES", str(64 << 30))
    f = {k: findings(PORT, *v) for k, v in CASES.items()}
    assert f["clean"] == [] and f["internal_exempt"] == []
    assert f["rule_keeps_reachable"] == []
    assert [x[0] for x in f["unreachable_without_rule"]] == ["SL004"]
    by_code = {x[0]: x for x in f["footprints"]}
    assert by_code["SL003"][2] == "doc#nobody"
    assert by_code["SL004"][2] == "doc#orphan"
    assert f["rule_errors"][0][1] == "error"
    assert [x[2] for x in f["sl006_expiring"]] == ["group#member"]
    assert not [x for x in f["sl006_durable"] if x[0] == "SL006"]
    assert any(x[0] == "SL007" and "create-islands" in x[2]
               for x in f["sl007_rule"])
    assert not [x for x in f["sl007_rule_ok"] if x[0] == "SL007"]
    assert [x[1] for x in f["sl008"] if x[0] == "SL008"] == ["warn"]
    assert not [x for x in f["sharding_clean"] if x[0] in ("SL007",
                                                           "SL008")]
    monkeypatch.setenv("SPICEDB_TPU_LEOPARD_BUDGET_BYTES", "1024")
    sl009 = {x[2] for x in findings(PORT, *CASES["sl009"])
             if x[0] == "SL009"}
    assert {"group#view", "doc#view"} <= sl009
    assert "doc#allowed" not in sl009


def _workload_schemas(P) -> dict:
    return {name: text for name, text in inspect.getmembers(P.workloads)
            if name.endswith("_SCHEMA") and isinstance(text, str)}


def test_workload_schemas_cover_the_reference_ones():
    port, ref = _workload_schemas(PORT), _workload_schemas(REF)
    assert {k: port[k] for k in ref} == ref
    assert len(port) >= 5


@pytest.mark.parametrize("name", sorted(_workload_schemas(PORT)))
def test_workload_schema_findings_match_the_reference(name):
    text = _workload_schemas(PORT)[name]
    for spec in (None, "derived"):
        out = []
        for P in (PORT, REF):
            schema = P.endpoints.merge_internal_definitions(
                P.sch.parse_schema(text))
            pm = (P.sharding.partition_map_for_schema(schema, 2)
                  if spec else None)
            out.append(([(f.code, f.severity, f.where, f.message)
                         for f in P.lint.lint_schema(
                             schema, (), partition_map=pm)],
                        pm.describe() if pm else None))
        assert out[0] == out[1]
        assert not [f for f in out[0][0] if f[0] == "SL007"]


@pytest.mark.parametrize("spec", [None, "pod=1", "pod=1,namespace=1",
                                  "namespace=1,pod=1,tenant=1,group=1",
                                  "widget=1"])
def test_deploy_findings_match_the_reference(spec):
    out = []
    for P in (PORT, REF):
        boot = P.endpoints.Bootstrap.from_file(str(DEPLOY / "bootstrap.yaml"))
        schema = P.endpoints.merge_internal_definitions(
            P.sch.parse_schema(boot.schema_text))
        rules = P.proxyrule.parse_file(str(DEPLOY / "rules.yaml"))
        pm = (P.sharding.PartitionMap.parse(spec, n_shards=2)
              if spec else None)
        out.append([(f.code, f.severity, f.where, f.message)
                    for f in P.lint.lint_schema(schema, rules,
                                                partition_map=pm)])
    assert out[0] == out[1]
    assert bool([f for f in out[0] if f[0] == "SL007"]) == (
        spec in ("pod=1", "pod=1,namespace=1"))


def _files(tmp_path):
    bad_yaml = tmp_path / "bad.yaml"
    bad_yaml.write_text("schema: [unclosed\n")
    bad_schema = tmp_path / "bad-schema.yaml"
    bad_schema.write_text("schema: |\n  definition user {\n")
    lint_boot = tmp_path / "lint.yaml"
    lint_boot.write_text("schema: |\n" + "\n".join(
        "  " + line for line in RL.SCHEMA.splitlines()))
    sharded_boot = tmp_path / "sharded.yaml"
    sharded_boot.write_text("schema: |\n" + "\n".join(
        "  " + line for line in RL.SHARDED_SCHEMA.splitlines()))
    rules_bad = tmp_path / "rules-bad.yaml"
    rules_bad.write_text(RL.RULES_BAD)
    return {"DEPLOY_BOOT": str(DEPLOY / "bootstrap.yaml"),
            "DEPLOY_RULES": str(DEPLOY / "rules.yaml"),
            "BAD_YAML": str(bad_yaml), "BAD_SCHEMA": str(bad_schema),
            "LINT_BOOT": str(lint_boot), "SHARDED_BOOT": str(sharded_boot),
            "RULES_BAD": str(rules_bad),
            "MISSING": str(tmp_path / "missing.yaml")}


CLI_RUNS = [
    [],
    ["--spicedb-bootstrap", "DEPLOY_BOOT", "--rule-config", "DEPLOY_RULES"],
    ["--spicedb-bootstrap", "DEPLOY_BOOT", "--rule-config", "DEPLOY_RULES",
     "--partition-map", "pod=1"],
    ["--spicedb-bootstrap", "DEPLOY_BOOT", "--rule-config", "DEPLOY_RULES",
     "--lint-schema-strict"],
    ["--spicedb-bootstrap", "LINT_BOOT", "--rule-config", "RULES_BAD"],
    ["--spicedb-bootstrap", "LINT_BOOT"],
    ["--spicedb-bootstrap", "LINT_BOOT", "--lint-schema-strict"],
    ["--spicedb-bootstrap", "SHARDED_BOOT", "--shards", "2",
     "--partition-map", "pod=1"],
    ["--spicedb-bootstrap", "SHARDED_BOOT", "--shards", "2",
     "--partition-map", "pod=1,namespace=1"],
    ["--spicedb-bootstrap", "SHARDED_BOOT", "--shard-leaders",
     "http://a:1,http://b:2,http://c:3", "--partition-map", "island=2"],
    ["--spicedb-bootstrap", "SHARDED_BOOT", "--partition-map", "pod=x"],
    ["--spicedb-bootstrap", "BAD_YAML"],
    ["--spicedb-bootstrap", "BAD_SCHEMA"],
    ["--spicedb-bootstrap", "MISSING"],
    ["--rule-config", "MISSING"],
]


@pytest.mark.parametrize("json_out", [False, True])
@pytest.mark.parametrize("run", range(len(CLI_RUNS)))
def test_cli_lint_matches_the_reference(run, json_out, tmp_path, capsys,
                                        monkeypatch):
    monkeypatch.delenv("SPICEDB_TPU_LEOPARD_BUDGET_BYTES", raising=False)
    monkeypatch.delenv("SPICEDB_TPU_LEOPARD_LINT_OBJECTS", raising=False)
    subs = _files(tmp_path)
    argv = ["--lint-schema"] + [subs.get(a, a) for a in CLI_RUNS[run]]
    if json_out:
        argv.append("--lint-schema-json")
    out = []
    for P in (PORT, REF):
        rc = P.cli.main(list(argv))
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    assert out[0] == out[1]
    rc, stdout, _ = out[0]
    assert rc in (0, 1, 2)
    if json_out:
        body = json.loads(stdout.splitlines()[0] if rc == 2 else stdout)
        assert body["version"] == 1
