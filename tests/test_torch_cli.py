"""The port's command line and kubeconfig held against the reference's.

Every case of tests/test_cli.py runs on the port's `cli` and
`proxy/kubeconfig.py` (TLS end to end included), with the port's
endpoints: `torch://` is the default and needs the card, so a case that
serves here asks for `torch://?device=cpu`; the reference's scheme-less
gRPC endpoint case carries the connection flags as the reference's.
Beside them: the same argv through both packages' `build_parser`,
`validate` and `complete` gives equal `Options` fields where both have
the field; the remote endpoint's flags and `--fleet-peers` parse and
validate as the reference's; `--feature-gates` sets
the port's switches and refuses other names; and `python -m
spicedb_kubeapi_proxy_tpu_torch` serves, dual-writes and exits 0 on
SIGTERM in a subprocess against a loopback fake apiserver.  The durable
store's and replication's flags (`--data-dir`, `--wal-fsync`,
`--checkpoint-interval`, `--replicate-from`, `--replica-*`,
`--shed-replica-lag`) reach the same `Options` and fail `validate` with
the reference's texts (the endpoint named `torch://` where the reference
names `jax://`), and a `python -m ... --data-dir` process killed with
SIGKILL after an acknowledged create serves that create again after its
restart on the same data dir.
"""

import asyncio
import base64
import dataclasses
import json
import os
import pathlib
import signal
import socket
import ssl
import subprocess
import sys

import pytest

from spicedb_kubeapi_proxy_tpu import cli as ref_cli
from spicedb_kubeapi_proxy_tpu_torch import cli
from spicedb_kubeapi_proxy_tpu_torch.config import proxyrule
from spicedb_kubeapi_proxy_tpu_torch.proxy import kubeconfig as kubecfg
from spicedb_kubeapi_proxy_tpu_torch.proxy.authn import (
    HeaderAuthenticator,
    TokenFileAuthenticator)
from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import (
    Headers,
    Request,
    Response,
    Transport,
)
from spicedb_kubeapi_proxy_tpu_torch.utils import features

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEPLOY = ROOT / "deploy"
CPU = "torch://?device=cpu"

RULES = """
apiVersion: authzed.com/v1alpha1
kind: ProxyRule
metadata: {name: get-namespaces}
match: [{apiVersion: v1, resource: namespaces, verbs: [get]}]
check: [{tpl: "namespace:{{name}}#view@user:{{user.name}}"}]
"""


def parse(argv):
    return cli.build_parser().parse_args(cli._normalize_argv(argv))


@pytest.fixture(autouse=True)
def restore_switches():
    saved = {v: getattr(features, v) for v in features.GATE_SWITCHES.values()}
    yield
    for k, v in saved.items():
        setattr(features, k, v)


# -- flag parsing ------------------------------------------------------------

def test_defaults():
    args = parse([])
    assert args.spicedb_endpoint == "torch://"
    assert args.workflow_database_path == cli.DEFAULT_WORKFLOW_DATABASE_PATH
    assert args.lock_mode == proxyrule.PESSIMISTIC_LOCK_MODE
    assert args.override_upstream is True
    assert args.secure_port == 443
    assert args.verbosity == 3
    assert args.prewarm_compiles is True


def test_word_separator_normalization():
    args = parse(["--rule_config", "/r.yaml", f"--spicedb_endpoint={CPU}"])
    assert args.rule_config == "/r.yaml"
    assert args.spicedb_endpoint == CPU


def test_lock_mode_choices():
    with pytest.raises(SystemExit):
        parse(["--lock-mode", "Bogus"])


# -- Validate ----------------------------------------------------------------

def test_validate_requires_upstream_and_rules():
    errs = cli.validate(parse([]))
    assert any("--backend-kubeconfig" in e for e in errs)
    assert any("--rule-config" in e for e in errs)


def test_validate_ok_with_in_cluster_and_rules():
    errs = cli.validate(parse(["--use-in-cluster-config",
                               "--rule-config", "r.yaml"]))
    assert errs == []


def test_validate_rejects_bad_port():
    errs = cli.validate(parse(["--use-in-cluster-config",
                               "--rule-config", "r.yaml",
                               "--secure-port", "0"]))
    assert any("secure-port" in e for e in errs)


@pytest.mark.parametrize("endpoint", [CPU, "torch://", "embedded://",
                                      "torch://?device=cpu&dispatch=direct"])
def test_validate_accepts_the_port_endpoints(endpoint):
    assert cli.validate(parse(["--use-in-cluster-config", "--rule-config",
                               "r.yaml", "--spicedb-endpoint",
                               endpoint])) == []


@pytest.mark.parametrize("endpoint", ["jax://", "jax://?mesh=auto",
                                      "spicedb.example.com:50051",
                                      "grpc://spicedb:50051", ""])
def test_validate_refuses_other_endpoints(endpoint):
    """`jax://` and an empty endpoint are refused; the remote endpoints
    (a scheme-less `host:port` and `grpc://`) validate, as in the
    reference."""
    argv = ["--use-in-cluster-config", "--rule-config", "r.yaml",
            "--spicedb-endpoint", endpoint]
    errs = cli.validate(parse(argv))
    if endpoint in ("spicedb.example.com:50051", "grpc://spicedb:50051"):
        assert errs == ref_cli.validate(
            ref_cli.build_parser().parse_args(argv)) == []
        return
    assert len(errs) == 1
    assert "torch://" in errs[0] and "embedded://" in errs[0]


# -- kubeconfig loading ------------------------------------------------------

def write_kubeconfig(tmp_path, server="https://kube.example:6443",
                     token="", insecure=False):
    cfg = {
        "apiVersion": "v1", "kind": "Config",
        "current-context": "ctx",
        "contexts": [{"name": "ctx",
                      "context": {"cluster": "c", "user": "u"}}],
        "clusters": [{"name": "c", "cluster": {
            "server": server,
            "insecure-skip-tls-verify": insecure,
        }}],
        "users": [{"name": "u", "user": {"token": token} if token else {}}],
    }
    path = tmp_path / "kubeconfig.yaml"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_load_kubeconfig_current_context(tmp_path):
    path = write_kubeconfig(tmp_path, token="sekrit")
    ctx = kubecfg.load_kubeconfig(path)
    assert ctx.server == "https://kube.example:6443"
    assert ctx.token == "sekrit"


def test_load_kubeconfig_override_upstream(tmp_path, monkeypatch):
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "443")
    ctx = kubecfg.load_kubeconfig(write_kubeconfig(tmp_path),
                                  override_upstream=True)
    assert ctx.server == "https://10.0.0.1:443"


def test_load_kubeconfig_cert_data(tmp_path):
    ca = base64.b64encode(b"CERTDATA").decode()
    cfg = {
        "current-context": "ctx",
        "contexts": [{"name": "ctx",
                      "context": {"cluster": "c", "user": "u"}}],
        "clusters": [{"name": "c", "cluster": {
            "server": "https://k:6443",
            "certificate-authority-data": ca}}],
        "users": [{"name": "u", "user": {}}],
    }
    path = tmp_path / "k.yaml"
    path.write_text(json.dumps(cfg))
    assert kubecfg.load_kubeconfig(str(path)).ca_data == b"CERTDATA"


def test_load_kubeconfig_matches_reference(tmp_path, monkeypatch):
    """Both packages resolve the same contexts from the same files: a
    token, inline and file cert data (relative to the file), a missing
    named cluster, the override."""
    from spicedb_kubeapi_proxy_tpu.proxy import kubeconfig as ref_kubecfg
    (tmp_path / "client.crt").write_bytes(b"CLIENTCERT")
    cfg = {
        "current-context": "b",
        "contexts": [{"name": "a", "context": {"cluster": "c1"}},
                     {"name": "b", "context": {"cluster": "c2",
                                               "user": "u2"}}],
        "clusters": [{"name": "c1", "cluster": {"server": "https://one"}},
                     {"name": "c2", "cluster": {
                         "server": "https://two:6443",
                         "certificate-authority-data":
                             base64.b64encode(b"CA").decode(),
                         "insecure-skip-tls-verify": True}}],
        "users": [{"name": "u2", "user": {
            "token": "t2", "client-certificate": "client.crt",
            "client-key-data": base64.b64encode(b"KEY").decode()}}],
    }
    path = tmp_path / "kc.yaml"
    path.write_text(json.dumps(cfg))
    for override in (False, True):
        monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "fd00::1")
        monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")
        got = kubecfg.load_kubeconfig(str(path), override_upstream=override)
        want = ref_kubecfg.load_kubeconfig(str(path),
                                           override_upstream=override)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cfg["contexts"][1]["context"]["cluster"] = "absent"
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="unknown cluster"):
        kubecfg.load_kubeconfig(str(path))


def test_bearer_token_transport_injects():
    seen = {}

    class Rec(Transport):
        async def round_trip(self, req):
            seen["auth"] = req.headers.get("Authorization")
            return Response(status=200)

    t = kubecfg.BearerTokenTransport(Rec(), "tok")
    asyncio.run(t.round_trip(Request(method="GET", target="/x")))
    assert seen["auth"] == "Bearer tok"


# -- Complete ----------------------------------------------------------------

class NullTransport(Transport):
    async def round_trip(self, req):
        return Response(status=200, body=b"{}")


def rules_file(tmp_path, text=RULES):
    rules = tmp_path / "rules.yaml"
    rules.write_text(text)
    return str(rules)


def test_complete_loads_and_validates_rules(tmp_path):
    args = parse(["--rule-config", rules_file(tmp_path),
                  "--use-in-cluster-config", "--embedded-mode"])
    completed = cli.complete(args, upstream_transport=NullTransport())
    assert len(completed.server_options.rule_configs) == 1
    assert completed.embedded_mode


def test_scheme_less_endpoint_is_refused():
    """The reference dials gRPC for a scheme-less host:port and carries
    the connection flags to it (tests/test_cli.py
    test_scheme_less_endpoint_carries_connection_flags); the port does
    the same since it serves the remote endpoint: it validates, and the
    four flags reach the endpoint keywords as the reference's."""
    argv = ["--spicedb-endpoint", "spicedb.example.com:50051",
            "--spicedb-token", "tok", "--spicedb-insecure",
            "--spicedb-ca-path", "/ca.pem", "--spicedb-skip-verify-ca",
            "--use-in-cluster-config", "--embedded-mode",
            "--rule-config", "r.yaml"]
    args = parse(argv)
    assert cli.validate(args) == []
    args.rule_config = ""
    completed = cli.complete(args, upstream_transport=NullTransport())
    ref_args = ref_cli.build_parser().parse_args(argv)
    ref_args.rule_config = ""
    want = ref_cli.complete(ref_args, upstream_transport=NullTransport())
    kw = completed.server_options.endpoint_kwargs
    assert kw == want.server_options.endpoint_kwargs == {
        "token": "tok", "insecure": True, "skip_verify_ca": True,
        "ca_path": "/ca.pem"}


def test_complete_rejects_invalid_rules(tmp_path):
    args = parse(["--rule-config", rules_file(
        tmp_path, "apiVersion: authzed.com/v1alpha1\nkind: Nope\n"),
        "--embedded-mode"])
    with pytest.raises(cli.OptionsError, match="invalid rule config"):
        cli.complete(args, upstream_transport=NullTransport())


def test_complete_missing_kubeconfig_errors(tmp_path):
    args = parse(["--rule-config", rules_file(tmp_path),
                  "--backend-kubeconfig", str(tmp_path / "absent.yaml")])
    with pytest.raises(cli.OptionsError, match="kubeconfig"):
        cli.complete(args)


def test_complete_embedded_mode_uses_header_auth(tmp_path):
    args = parse(["--rule-config", rules_file(tmp_path), "--embedded-mode"])
    completed = cli.complete(args, upstream_transport=NullTransport())
    kinds = [type(a) for a in completed.server_options.authenticators]
    assert kinds == [HeaderAuthenticator]
    assert completed.server_options.ssl_context is None


def test_complete_serving_mode_generates_self_signed_certs(tmp_path):
    pytest.importorskip("cryptography")
    args = parse(["--rule-config", rules_file(tmp_path),
                  "--cert-dir", str(tmp_path / "certs")])
    completed = cli.complete(args, upstream_transport=NullTransport())
    assert completed.server_options.ssl_context is not None
    assert (tmp_path / "certs" / "tls.crt").exists()
    assert (tmp_path / "certs" / "tls.key").exists()
    before = (tmp_path / "certs" / "tls.crt").read_bytes()
    cli.complete(args, upstream_transport=NullTransport())
    assert (tmp_path / "certs" / "tls.crt").read_bytes() == before


def test_complete_rejects_half_specified_tls_pair(tmp_path):
    args = parse(["--rule-config", rules_file(tmp_path),
                  "--tls-cert-file", str(tmp_path / "tls.crt")])
    with pytest.raises(cli.OptionsError, match="together"):
        cli.complete(args, upstream_transport=NullTransport())


def test_complete_missing_token_auth_file_errors(tmp_path):
    args = parse(["--rule-config", rules_file(tmp_path), "--embedded-mode",
                  "--token-auth-file", str(tmp_path / "absent.csv")])
    with pytest.raises(cli.OptionsError, match="token auth file"):
        cli.complete(args, upstream_transport=NullTransport())


def test_complete_token_auth_file(tmp_path):
    tokens = tmp_path / "tokens.csv"
    tokens.write_text('tok1,alice,uid1,"dev,ops"\ntok2,bob,uid2\n')
    args = parse(["--rule-config", rules_file(tmp_path), "--embedded-mode",
                  "--token-auth-file", str(tokens)])
    completed = cli.complete(args, upstream_transport=NullTransport())
    tf = [a for a in completed.server_options.authenticators
          if isinstance(a, TokenFileAuthenticator)]
    assert len(tf) == 1
    req = Request(method="GET", target="/",
                  headers=Headers([("Authorization", "Bearer tok1")]))
    user = tf[0].authenticate(req)
    assert user.name == "alice" and user.groups == ["dev", "ops"]
    assert tf[0].authenticate(Request(
        method="GET", target="/",
        headers=Headers([("Authorization", "Bearer nope")]))) is None


# -- end-to-end over TLS -----------------------------------------------------

def test_serve_tls_end_to_end(tmp_path):
    """complete() -> ProxyServer over real TLS -> an authenticated request
    is authorized and proxied (upstream faked)."""
    pytest.importorskip("cryptography")
    from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import H11Transport
    from spicedb_kubeapi_proxy_tpu_torch.proxy.server import ProxyServer
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        RelationshipUpdate, UpdateOp, parse_relationship)

    tokens = tmp_path / "tokens.csv"
    tokens.write_text("tok1,alice,uid1\n")

    class Upstream(Transport):
        async def round_trip(self, req):
            return Response(status=200, body=json.dumps({
                "kind": "Namespace", "apiVersion": "v1",
                "metadata": {"name": "ns1"}}).encode())

    args = parse(["--rule-config", rules_file(tmp_path),
                  "--cert-dir", str(tmp_path / "certs"),
                  "--token-auth-file", str(tokens),
                  "--use-in-cluster-config", "--spicedb-endpoint", CPU])
    completed = cli.complete(args, upstream_transport=Upstream())

    async def run():
        server = ProxyServer(completed.server_options)
        await server.endpoint.write_relationships([RelationshipUpdate(
            op=UpdateOp.TOUCH,
            rel=parse_relationship("namespace:ns1#viewer@user:alice"))])
        port = await server.start("127.0.0.1", 0)
        try:
            ssl_ctx = ssl.create_default_context()
            ssl_ctx.check_hostname = False
            ssl_ctx.verify_mode = ssl.CERT_NONE
            client = H11Transport(f"https://127.0.0.1:{port}",
                                  ssl_context=ssl_ctx)
            ok = await client.round_trip(Request(
                method="GET", target="/api/v1/namespaces/ns1",
                headers=Headers([("Authorization", "Bearer tok1"),
                                 ("Accept", "application/json")])))
            anon = await client.round_trip(Request(
                method="GET", target="/api/v1/namespaces/ns1",
                headers=Headers([("Accept", "application/json")])))
            return ok, anon
        finally:
            await server.stop()

    ok, anon = asyncio.run(run())
    assert ok.status == 200
    assert json.loads(ok.body)["metadata"]["name"] == "ns1"
    assert anon.status == 401


def test_trace_slow_threshold_flag_wires_through(tmp_path):
    rules = rules_file(tmp_path)
    args = parse(["--rule-config", rules, "--use-in-cluster-config",
                  "--embedded-mode", "--trace-slow-threshold", "1.5"])
    assert cli.validate(args) == []
    completed = cli.complete(args, upstream_transport=NullTransport())
    assert completed.server_options.trace_slow_threshold == 1.5
    assert parse([]).trace_slow_threshold == 0.0
    bad = parse(["--rule-config", rules, "--use-in-cluster-config",
                 "--embedded-mode", "--trace_slow_threshold", "-1"])
    assert any("trace-slow-threshold" in e for e in cli.validate(bad))


# -- against the reference CLI -----------------------------------------------

def _shape(value):
    """A comparable form of an Options field across the two packages."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return dataclasses.asdict(value)
    if isinstance(value, list):
        return [_shape(v) for v in value]
    if isinstance(value, (Transport, ssl.SSLContext)) or hasattr(
            value, "authenticate"):
        return type(value).__name__
    return value


@pytest.mark.parametrize("extra", [
    [],
    ["--lock-mode", "Optimistic", "--workflow-database-path", "wf.db",
     "--trace-slow-threshold", "2", "--audit-level", "Request",
     "--audit-sample-every", "3", "--audit-explain"],
    ["--pipeline-depth", "1", "--max-queue-depth", "64",
     "--shed-queue-depth", "32", "--shed-retry-after", "2.5",
     "--no-prewarm-compiles"],
    ["--spicedb_bootstrap", str(DEPLOY / "bootstrap.yaml"),
     "--token-auth-file", "TOKENS"],
    ["--decision-cache", "--decision-cache-bytes", "4096",
     "--flight-window", "5", "--flight-windows", "8",
     "--slo-check-p99-ms", "250", "--slo-objective", "0.05",
     "--slo-error-rate", "0.01", "--shed-slo-burn",
     "--device-hbm-peak-gbps", "3350"],
    ["--data-dir", "DATADIR", "--wal-fsync", "always",
     "--checkpoint-interval", "60"],
    ["--data-dir", "DATADIR", "--workflow-database-path", "wf.db"],
    ["--replicate-from", "http://leader:8443", "--replica-wait-ms", "250",
     "--no-replica-forward", "--replica-user", "system:r2",
     "--shed-replica-lag", "1.5", "--replica-id", "r2"],
    ["--replicate-from", "http://leader:8443", "--serve-replication",
     "--replication-mirror-dir", "MIRROR", "--promote-data-dir", "PROMOTE",
     "--promote-on-leader-loss", "--leader-loss-grace", "2",
     "--replica-peers", "http://a:1, http://b:2", "--replica-id", "a"],
])
def test_same_argv_gives_the_reference_options(tmp_path, extra):
    tokens = tmp_path / "tokens.csv"
    tokens.write_text("tok1,alice,uid1\n")
    subs = {"TOKENS": str(tokens), "DATADIR": str(tmp_path / "data"),
            "MIRROR": str(tmp_path / "mirror"),
            "PROMOTE": str(tmp_path / "promote")}
    argv = ["--rule-config", str(DEPLOY / "rules.yaml"),
            "--use-in-cluster-config", "--embedded-mode",
            "--spicedb-endpoint", "embedded://"] + [
        subs.get(a, a) for a in extra]
    ref_args = ref_cli.build_parser().parse_args(ref_cli._normalize_argv(
        argv))
    args = parse(argv)
    assert cli.validate(args) == ref_cli.validate(ref_args) == []
    got = cli.complete(args, upstream_transport=NullTransport())
    want = ref_cli.complete(ref_args, upstream_transport=NullTransport())
    port_fields = {f.name for f in dataclasses.fields(got.server_options)}
    ref_fields = {f.name for f in dataclasses.fields(want.server_options)}
    shared = sorted(port_fields & ref_fields)
    assert port_fields <= ref_fields
    assert len(shared) == len(port_fields) == 45
    for name in shared:
        assert (_shape(getattr(got.server_options, name))
                == _shape(getattr(want.server_options, name))), name
    for name in ("bind_address", "secure_port", "embedded_mode"):
        assert getattr(got, name) == getattr(want, name)


@pytest.mark.parametrize("flag", [
    ["--fleet-peers=http://q"], ["--fleet-peers", "http://p"],
    ["--spicedb-ca-path", "x"], ["--spicedb-skip-verify-ca"],
    ["--spicedb-token=t2"], ["--spicedb-insecure"],
    ["--spicedb-token", "t"],
])
def test_unported_flag_exits_2(flag):
    """The remote endpoint's four flags and `--fleet-peers`, refused
    with exit 2 while their features were unported, now parse into the
    reference's values, and `--fleet-peers` reaches `Options.fleet_peers`
    as the reference's does."""
    base = ["--use-in-cluster-config", "--embedded-mode",
            "--spicedb-endpoint", "embedded://", "--rule-config", "r.yaml"]
    want = ref_cli.build_parser().parse_args(base + flag)
    got = parse(base + flag)
    dest = flag[0].split("=")[0][2:].replace("-", "_")
    assert getattr(got, dest) == getattr(want, dest)
    assert cli.validate(got) == ref_cli.validate(want) == []
    if dest == "fleet_peers":
        got.rule_config = want.rule_config = ""
        got_opts = cli.complete(got, upstream_transport=NullTransport())
        want_opts = ref_cli.complete(want, upstream_transport=NullTransport())
        assert (got_opts.server_options.fleet_peers
                == want_opts.server_options.fleet_peers
                == [flag[-1].split("=")[-1]])


_SHARDING_DESTS = ("shards", "partition_map", "shard_leaders", "lint_schema",
                   "lint_schema_strict", "lint_schema_json")


@pytest.mark.parametrize("flag", [
    ["--lint-schema-strict"], ["--lint-schema-json"],
    ["--shards=4"], ["--shards", "2"],
    ["--partition-map", "pod=0"], ["--shard-leaders", "http://a"],
    ["--lint-schema"], ["--partition-map=pod=1"],
])
def test_sharding_flag_parses_as_the_reference(flag):
    want = ref_cli.build_parser().parse_args(ref_cli._normalize_argv(flag))
    got = parse(flag)
    assert ({d: getattr(got, d) for d in _SHARDING_DESTS}
            == {d: getattr(want, d) for d in _SHARDING_DESTS})


def test_feature_gates_set_the_port_switches(tmp_path):
    args = parse(["--rule-config", rules_file(tmp_path), "--embedded-mode",
                  "--feature-gates",
                  "AsyncRebuild=false, MeshExecution=false,DevicePipeline"])
    features.DEVICE_PIPELINE = False
    cli.complete(args, upstream_transport=NullTransport())
    assert features.ASYNC_REBUILD is False
    assert features.MESH_EXECUTION is False
    assert features.DEVICE_PIPELINE is True
    assert features.CROSS_REQUEST_BATCHING is True
    # each of the reference's gate names of the five switches
    for gate, switch in features.GATE_SWITCHES.items():
        from spicedb_kubeapi_proxy_tpu.utils.features import GATES
        assert gate in GATES.known()
        features.apply_flag(f"{gate}=false")
        assert getattr(features, switch) is False
        features.apply_flag(f"{gate}=true")
        assert getattr(features, switch) is True


@pytest.mark.parametrize("value", ["true", "false"])
def test_every_reference_gate_name_is_accepted(tmp_path, value):
    """The reference's 20 gate names in one --feature-gates value: both
    CLIs take it and both packages' apply_flag set every gate to it;
    LeopardIndex=false leaves a `torch://` endpoint without the index."""
    from spicedb_kubeapi_proxy_tpu.utils.features import GATES
    names = sorted(GATES.known())
    assert len(names) == 20 and set(names) == set(features.GATE_SWITCHES)
    spec = ",".join(f"{n}={value}" for n in names)
    saved = {n: GATES.enabled(n) for n in names}
    try:
        GATES.apply_flag(spec)
        features.apply_flag(spec)
        want = value == "true"
        for n in names:
            assert GATES.enabled(n) is want
            assert getattr(features, features.GATE_SWITCHES[n]) is want
        base = ["--rule-config", rules_file(tmp_path), "--embedded-mode",
                "--use-in-cluster-config", "--spicedb-endpoint",
                "torch://?device=cpu", "--feature-gates", spec]
        args = parse(base)
        assert cli.validate(args) == []
        cli.complete(args, upstream_transport=NullTransport())
        ref_args = ref_cli.build_parser().parse_args(
            ref_cli._normalize_argv(base))
        ref_cli.complete(ref_args, upstream_transport=NullTransport())
        assert features.LEOPARD_INDEX is want and \
            GATES.enabled("LeopardIndex") is want
        from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
            TorchEndpoint)
        from spicedb_kubeapi_proxy_tpu_torch.spicedb import schema as psch
        ep = TorchEndpoint(psch.parse_schema(
            "definition user {}\ndefinition doc {\n  relation viewer: user"
            "\n  permission view = viewer\n}"), device="cpu")
        assert ep._leopard_wanted is want
        assert TorchEndpoint(ep.schema, device="cpu",
                             leopard=True)._leopard_wanted
    finally:
        for n, v in saved.items():
            GATES.set(n, v)


# the decision cache and device-telemetry flags: each parses, validates
# and reaches the server Options (or the endpoint keywords) as in the
# reference CLI, and the endpoint built from them is what it asks for
_SLO = ["--slo-check-p99-ms", "250"]


@pytest.mark.parametrize("argv,where,name,want", [
    (["--decision-cache"], "endpoint", "decision_cache", True),
    (["--decision-cache-bytes", "4096"], "endpoint",
     "decision_cache_bytes", 4096),
    (["--flight-window", "2.5"], "options", "flight_window_s", 2.5),
    (["--flight-windows", "16"], "options", "flight_windows", 16),
    (_SLO, "options", "slo_check_p99_ms", 250.0),
    (_SLO + ["--slo-objective", "0.05"], "options", "slo_objective", 0.05),
    (["--slo-error-rate", "0.02"], "options", "slo_error_rate", 0.02),
    (_SLO + ["--shed-slo-burn"], "options", "shed_slo_burn", True),
    (["--device-hbm-peak-gbps", "3350"], "options",
     "device_hbm_peak_gbps", 3350.0),
    (["--feature-gates", "DecisionCache=true"], "switch",
     "DECISION_CACHE", True),
    (["--feature-gates", "DeviceTelemetry=false,Timeline=false,"
      "KernelIntrospect=false,Profiler=false"], "switch",
     "DEVICE_TELEMETRY", False),
])
def test_cache_and_telemetry_flags_reach_options(tmp_path, argv, where,
                                                 name, want):
    base = ["--rule-config", rules_file(tmp_path), "--embedded-mode",
            "--use-in-cluster-config", "--spicedb-endpoint", "embedded://"]
    args = parse(base + argv)
    assert cli.validate(args) == []
    got = cli.complete(args, upstream_transport=NullTransport())
    if where == "switch":
        assert getattr(features, name) is want
        return
    opts = got.server_options
    value = (opts.endpoint_kwargs.get(name) if where == "endpoint"
             else getattr(opts, name))
    assert value == want
    ref_args = ref_cli.build_parser().parse_args(
        ref_cli._normalize_argv(base + argv))
    ref_opts = ref_cli.complete(ref_args,
                                upstream_transport=NullTransport()
                                ).server_options
    ref_value = (ref_opts.endpoint_kwargs.get(name) if where == "endpoint"
                 else getattr(ref_opts, name))
    assert value == ref_value
    if where == "endpoint":
        from spicedb_kubeapi_proxy_tpu_torch.spicedb.decision_cache import (
            DecisionCacheEndpoint)
        from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
            create_endpoint)
        ep = create_endpoint("embedded://?cache=1", **opts.endpoint_kwargs)
        assert isinstance(ep, DecisionCacheEndpoint)
        if name == "decision_cache_bytes":
            assert ep.cache.max_bytes == want


@pytest.mark.parametrize("argv,err", [
    (["--shed-slo-burn"], "--shed-slo-burn needs an SLO"),
    (["--flight-windows", "1"], "--flight-windows must be >= 2"),
    (["--flight-window", "0"], "--flight-window must be > 0"),
    (["--slo-objective", "0"], "--slo-objective must be in (0, 1]"),
    (["--device-hbm-peak-gbps", "-1"], "--device-hbm-peak-gbps must be"),
    (["--decision-cache-bytes", "-1"], "--decision-cache-bytes must be"),
])
def test_bad_telemetry_values_fail_validate(tmp_path, argv, err):
    base = ["--rule-config", rules_file(tmp_path), "--embedded-mode",
            "--use-in-cluster-config"]
    errs = cli.validate(parse(base + argv))
    assert any(e.startswith(err) for e in errs), errs
    ref_errs = ref_cli.validate(ref_cli.build_parser().parse_args(
        ref_cli._normalize_argv(base + argv)))
    assert any(e.startswith(err) for e in ref_errs), ref_errs


@pytest.mark.parametrize("spec,match", [
    ("AsyncRebuild=false,Bogus=true", "unknown feature gate"),
    ("AsyncRebuild=maybe", "invalid feature gate value"),
])
def test_feature_gates_refuse_other_names(tmp_path, spec, match):
    args = parse(["--rule-config", rules_file(tmp_path), "--embedded-mode",
                  "--feature-gates", spec])
    with pytest.raises(cli.OptionsError, match=match):
        cli.complete(args, upstream_transport=NullTransport())
    # nothing of a refused value is applied
    assert features.ASYNC_REBUILD is True


# -- python -m spicedb_kubeapi_proxy_tpu_torch in a subprocess ---------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_module_serves_dual_writes_and_exits_on_sigterm(tmp_path):
    """`python -m spicedb_kubeapi_proxy_tpu_torch --spicedb-endpoint
    torch://?device=cpu --embedded-mode ...` against a fake apiserver on
    a loopback socket, through a kubeconfig: /readyz, a list, a create
    through the dual-write rule that the list then shows, a delete,
    mallory's list without api-1; SIGTERM exits 0 with no traceback, and
    the serving log line names the endpoint's device."""
    pytest.importorskip("h11")
    from spicedb_kubeapi_proxy_tpu_torch.kubefake.apiserver import (
        FakeKubeApiServer)
    from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import (
        H11Transport, HttpServer)

    async def go():
        kube = FakeKubeApiServer()
        kube.seed("", "v1", "namespaces", {"metadata": {"name": "acme-prod"}})
        for name in ("api-0", "api-1"):
            kube.seed("", "v1", "pods", {"metadata": {
                "name": name, "namespace": "acme-prod"}})
        upstream = HttpServer(kube)
        kport = await upstream.start("127.0.0.1", 0)
        kc = tmp_path / "kubeconfig"
        kc.write_text(json.dumps({
            "current-context": "c",
            "contexts": [{"name": "c", "context": {"cluster": "k"}}],
            "clusters": [{"name": "k", "cluster": {
                "server": f"http://127.0.0.1:{kport}"}}]}))
        port = _free_port()
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "spicedb_kubeapi_proxy_tpu_torch",
            "--spicedb-endpoint", CPU, "--embedded-mode",
            "--bind-address", "127.0.0.1", "--secure-port", str(port),
            "--backend-kubeconfig", str(kc), "--no-override-upstream",
            "--rule-config", str(DEPLOY / "rules.yaml"),
            "--spicedb-bootstrap", str(DEPLOY / "bootstrap.yaml"),
            "--workflow-database-path", str(tmp_path / "wf.db"), "-v", "2",
            cwd=str(ROOT), stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE,
            env={**os.environ, "PYTHONPATH": str(ROOT)})
        client = H11Transport(f"http://127.0.0.1:{port}")

        async def call(method, target, user="ada", obj=None):
            h = Headers([("X-Remote-User", user),
                         ("Accept", "application/json")])
            body = b""
            if obj is not None:
                body = json.dumps(obj).encode()
                h.set("Content-Type", "application/json")
            return await client.round_trip(Request(method, target,
                                                   headers=h, body=body))

        def names(resp):
            assert resp.status == 200, resp.body
            return sorted(i["metadata"]["name"]
                          for i in json.loads(resp.body)["items"])

        pods = "/api/v1/namespaces/acme-prod/pods"
        out = {}
        try:
            for _ in range(600):
                try:
                    if (await call("GET", "/readyz")).status == 200:
                        break
                except OSError:
                    pass
                if proc.returncode is not None:
                    break
                await asyncio.sleep(0.1)
            out["before"] = names(await call("GET", pods))
            out["create"] = (await call("POST", pods, obj={
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": "api-9", "namespace": "acme-prod"}})
            ).status
            out["after_create"] = names(await call("GET", pods))
            out["delete"] = (await call("DELETE", f"{pods}/api-9")).status
            out["after_delete"] = names(await call("GET", pods))
            out["mallory"] = names(await call("GET", pods, user="mallory"))
        finally:
            proc.send_signal(signal.SIGTERM)
            stdout, stderr = await asyncio.wait_for(proc.communicate(), 10)
            await upstream.stop()
        return out, proc.returncode, stderr.decode()

    out, rc, stderr = asyncio.run(go())
    assert out == {"before": ["api-0", "api-1"], "create": 201,
                   "after_create": ["api-0", "api-1", "api-9"],
                   "delete": 200, "after_delete": ["api-0", "api-1"],
                   "mallory": ["api-0"]}
    assert rc == 0, stderr[-2000:]
    assert "Traceback" not in stderr
    assert f"endpoint {CPU} on cpu" in stderr


def test_module_version_and_unported_flag():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-m",
                          "spicedb_kubeapi_proxy_tpu_torch", "--version"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    from spicedb_kubeapi_proxy_tpu_torch import __version__
    assert out.returncode == 0 and out.stdout.strip() == __version__
    # --fleet-peers parses now; an entry that is no http(s) URL is the
    # reference's validate error, exit 2
    out = subprocess.run([sys.executable, "-m",
                          "spicedb_kubeapi_proxy_tpu_torch",
                          "--use-in-cluster-config", "--rule-config", "r",
                          "--fleet-peers", "ftp://p"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode == 2 and "--fleet-peers" in out.stderr
    assert "must be an http(s) base URL" in out.stderr
    out = subprocess.run([sys.executable, "-m",
                          "spicedb_kubeapi_proxy_tpu_torch",
                          "--spicedb-endpoint", "jax://",
                          "--use-in-cluster-config", "--rule-config", "r"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 2 and "jax://" in out.stderr


# -- chip_smoke.py's phase 17 data -------------------------------------------

def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase17_rules_are_the_deploy_shapes():
    """Phase 17 (a)'s rules are deploy/rules.yaml's pod-launch and
    pod-retire without the viewer fan-out (multitenant-1m's pods have
    none), pod-retire under the pessimistic lock."""
    import yaml
    smoke = _chip_smoke()
    launch, retire = smoke.DUALWRITE_RULES
    deploy = {d["metadata"]["name"]: d for d in yaml.safe_load_all(
        (DEPLOY / "rules.yaml").read_text()) if d is not None}
    assert launch["check"] == deploy["pod-launch"]["check"]
    assert (launch["update"]["creates"]
            == deploy["pod-launch"]["update"]["creates"])
    assert "touches" not in launch["update"]
    assert retire["update"] == deploy["pod-retire"]["update"]
    assert (launch["lock"], retire["lock"]) == ("Optimistic", "Pessimistic")
    configs = [proxyrule.parse_doc(d) for d in smoke.DUALWRITE_RULES]
    assert [c.name for c in configs] == ["pod-launch", "pod-retire"]


# -- the durable store's and replication's flags ------------------------------

@pytest.mark.parametrize("argv", [
    ["--checkpoint-interval", "0"],
    ["--data-dir", "d", "--replicate-from", "http://leader:1"],
    ["--replicate-from", "leader:1"],
    ["--replica-wait-ms", "-1"],
    ["--shed-replica-lag", "-1"],
    ["--shed-replica-lag", "1"],
    ["--data-dir", "d", "--spicedb-endpoint", "grpc://h:1"],
    ["--replicate-from", "http://leader:1", "--spicedb-endpoint",
     "grpc://h:1"],
])
def test_durable_and_replica_flags_fail_validate_as_the_reference(
        tmp_path, argv):
    """Every error the reference's `validate` gives for these flags, the
    port's gives in the same words (its store-backed endpoints named
    `torch://` where the reference names `jax://`)."""
    base = ["--rule-config", rules_file(tmp_path), "--embedded-mode",
            "--use-in-cluster-config"]
    errs = cli.validate(parse(base + argv))
    ref_errs = ref_cli.validate(ref_cli.build_parser().parse_args(
        ref_cli._normalize_argv(base + argv)))
    assert ref_errs
    for e in ref_errs:
        assert e.replace("jax://", "torch://") in errs, (e, errs)


def test_durable_and_replica_flags_reach_options(tmp_path):
    base = ["--rule-config", rules_file(tmp_path), "--embedded-mode",
            "--use-in-cluster-config", "--spicedb-endpoint", CPU]
    data = tmp_path / "data"
    leader = cli.complete(parse(base + [
        "--data-dir", str(data), "--wal-fsync", "never",
        "--checkpoint-interval", "7"]), upstream_transport=NullTransport())
    o = leader.server_options
    assert (o.data_dir, o.wal_fsync, o.checkpoint_interval) == \
        (str(data), "never", 7.0)
    assert o.workflow_database_path == str(data / "dtx.sqlite")
    follower = cli.complete(parse(base + [
        "--replicate-from", "http://leader:8443", "--replica-wait-ms", "50",
        "--no-replica-forward", "--shed-replica-lag", "2",
        "--replica-id", "r1"]), upstream_transport=NullTransport())
    o = follower.server_options
    assert (o.replicate_from, o.replica_wait_ms, o.replica_forward,
            o.replica_user, o.shed_replica_lag_s, o.replica_id) == (
        "http://leader:8443", 50.0, False, "system:replica", 2.0, "r1")
    # with the DurableStore switch off the journal stays where it was
    features.DURABLE_STORE = False
    off = cli.complete(parse(base + ["--data-dir", str(tmp_path / "d2")]),
                       upstream_transport=NullTransport())
    assert off.server_options.workflow_database_path == \
        cli.DEFAULT_WORKFLOW_DATABASE_PATH


def test_module_with_data_dir_survives_sigkill(tmp_path):
    """`python -m spicedb_kubeapi_proxy_tpu_torch --data-dir D --wal-fsync
    always` on `torch://?device=cpu` and deploy/'s files, against a fake
    apiserver on a loopback socket: a create answered 201, then SIGKILL
    (no final checkpoint); a second process on D recovers the store,
    lists the pod, and stamps revisions that continue the first
    process's; SIGTERM then exits 0 after a final checkpoint.  The
    journal defaults into D."""
    pytest.importorskip("h11")
    from spicedb_kubeapi_proxy_tpu_torch.kubefake.apiserver import (
        FakeKubeApiServer)
    from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import (
        H11Transport, HttpServer)

    data = tmp_path / "data"

    async def go():
        kube = FakeKubeApiServer()
        kube.seed("", "v1", "namespaces", {"metadata": {"name": "acme-prod"}})
        kube.seed("", "v1", "pods", {"metadata": {
            "name": "api-0", "namespace": "acme-prod"}})
        upstream = HttpServer(kube)
        kport = await upstream.start("127.0.0.1", 0)
        kc = tmp_path / "kubeconfig"
        kc.write_text(json.dumps({
            "current-context": "c",
            "contexts": [{"name": "c", "context": {"cluster": "k"}}],
            "clusters": [{"name": "k", "cluster": {
                "server": f"http://127.0.0.1:{kport}"}}]}))

        async def spawn():
            port = _free_port()
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "spicedb_kubeapi_proxy_tpu_torch",
                "--spicedb-endpoint", CPU, "--embedded-mode",
                "--bind-address", "127.0.0.1", "--secure-port", str(port),
                "--backend-kubeconfig", str(kc), "--no-override-upstream",
                "--rule-config", str(DEPLOY / "rules.yaml"),
                "--spicedb-bootstrap", str(DEPLOY / "bootstrap.yaml"),
                "--data-dir", str(data), "--wal-fsync", "always", "-v", "2",
                cwd=str(ROOT), stdout=asyncio.subprocess.DEVNULL,
                stderr=asyncio.subprocess.PIPE,
                env={**os.environ, "PYTHONPATH": str(ROOT)})
            client = H11Transport(f"http://127.0.0.1:{port}")
            for _ in range(600):
                try:
                    h = Headers([("X-Remote-User", "ada")])
                    if (await client.round_trip(Request(
                            "GET", "/readyz", headers=h))).status == 200:
                        return proc, client
                except OSError:
                    pass
                if proc.returncode is not None:
                    break
                await asyncio.sleep(0.1)
            proc.kill()
            err = await proc.stderr.read()
            raise AssertionError(err.decode()[-2000:])

        async def call(client, method, target, obj=None):
            h = Headers([("X-Remote-User", "ada"),
                         ("Accept", "application/json")])
            body = b""
            if obj is not None:
                body = json.dumps(obj).encode()
                h.set("Content-Type", "application/json")
            return await client.round_trip(Request(method, target,
                                                   headers=h, body=body))

        pods = "/api/v1/namespaces/acme-prod/pods"
        out = {}
        try:
            proc, client = await spawn()
            created = await call(client, "POST", pods, {
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": "api-9", "namespace": "acme-prod"}})
            out["create"] = created.status
            out["rev1"] = int(created.headers.get("X-Authz-Revision"))
            proc.send_signal(signal.SIGKILL)
            await asyncio.wait_for(proc.wait(), 30)
            out["killed"] = proc.returncode
            proc, client = await spawn()
            listed = await call(client, "GET", pods)
            out["listed"] = sorted(i["metadata"]["name"]
                                   for i in json.loads(listed.body)["items"])
            out["rev2"] = int(listed.headers.get("X-Authz-Revision"))
            again = await call(client, "POST", pods, {
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": "api-10", "namespace": "acme-prod"}})
            out["create2"] = again.status
            out["rev3"] = int(again.headers.get("X-Authz-Revision"))
        finally:
            proc.send_signal(signal.SIGTERM)
            _, stderr = await asyncio.wait_for(proc.communicate(), 30)
            await upstream.stop()
        return out, proc.returncode, stderr.decode()

    out, rc, stderr = asyncio.run(go())
    assert out["create"] == 201 and out["killed"] == -signal.SIGKILL
    assert out["listed"] == ["api-0", "api-9"]
    assert out["rev2"] >= out["rev1"]
    assert out["create2"] == 201 and out["rev3"] > out["rev2"]
    assert rc == 0, stderr[-2000:]
    assert "Traceback" not in stderr
    assert "recovered store at revision" in stderr
    assert "skipping bootstrap relationships" in stderr
    assert (data / "dtx.sqlite").exists()
    # the clean stop wrote a final checkpoint, which reclaimed the log
    assert list((data / "checkpoints").glob("ckpt-*.npz"))
    assert not list((data / "wal").glob("seg-*.wal"))
