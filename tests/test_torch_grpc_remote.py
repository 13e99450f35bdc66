"""The port's remote endpoint, gRPC server and permsd held against the
reference's, over loopback gRPC on the CPU.

- The seven verbs (CheckPermission, CheckBulkPermissions,
  LookupResources, ReadRelationships, WriteRelationships,
  DeleteRelationships, Watch) through a port `RemoteEndpoint` against a
  port `PermissionsGrpcServer` over batched `torch://?device=cpu`, and
  across the packages both ways (port client, reference server over
  `jax://`; reference client, port server): every answer, revision and
  error equals the reference pair's and the host oracle's.
- Concurrent LookupResources streams fuse into batches on the server.
- Caveats over the wire (tests/test_grpc_caveats.py's cases): CONDITIONAL
  crosses as permissionship 3, LookupResources skips it, a caveated watch
  event keeps its context.
- The bearer token (UNAUTHENTICATED otherwise), TLS with a CA and with a
  pinned certificate (tests/test_grpc_pinning.py's cases).
- `python -m spicedb_kubeapi_proxy_tpu_torch.permsd` as a subprocess on
  `torch://?device=cpu`, SIGTERM to exit 0.
- With `grpc` blocked from import: the module and its handlers load and
  answer in-process, `grpc://` raises the "requires grpcio" error, and
  permsd exits 1 with it.

Every scenario runs under its own time limit (`LIMIT_S`).  Tolerance:
exact equality.
"""

import asyncio
import datetime
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
LIMIT_S = 60

SCHEMA = """
definition user {}
definition group {
  relation member: user | group#member
}
definition namespace {
  relation viewer: user | group#member
  relation creator: user
  permission view = viewer + creator
}
definition pod {
  relation namespace: namespace
  relation viewer: user
  permission view = viewer + namespace->view
}
"""

CAVEAT_SCHEMA = """
caveat on_call(active bool) { active }
definition user {}
definition doc {
  relation viewer: user | user with on_call
  permission view = viewer
}
"""


class GPkg:
    """One package's modules, by package root."""

    def __init__(self, root: str):
        def mod(name):
            return importlib.import_module(f"{root}.{name}")
        self.root = root
        self.grpc = mod("spicedb.grpc_remote")
        self.wire = mod("spicedb.wire")
        self.endpoints = mod("spicedb.endpoints")
        self.types = mod("spicedb.types")


PORT = GPkg("spicedb_kubeapi_proxy_tpu_torch")
REF = GPkg("spicedb_kubeapi_proxy_tpu")
PORT_URL = "torch://?device=cpu"
REF_URL = "jax://"


def boot_rels(n_users=12, n_ns=6, n_pods=40, seed=7):
    import numpy as np
    rng = np.random.default_rng(seed)
    rels = []
    for g in range(3):
        for u in rng.choice(n_users, 3, replace=False):
            rels.append(f"group:g{g}#member@user:u{u}")
    rels.append("group:g2#member@group:g0#member")
    for k in range(n_ns):
        rels.append(f"namespace:ns{k}#creator@user:u{rng.integers(n_users)}")
        rels.append(f"namespace:ns{k}#viewer@group:g{rng.integers(3)}"
                    f"#member")
    for p in range(n_pods):
        rels.append(f"pod:ns{p % n_ns}/p{p}#namespace@namespace:ns{p % n_ns}")
        if rng.integers(0, 3) == 0:
            rels.append(f"pod:ns{p % n_ns}/p{p}#viewer@user:"
                        f"u{rng.integers(n_users)}")
    return sorted(set(rels))


def make_endpoint(P, url, schema=SCHEMA, rels=()):
    return P.endpoints.create_endpoint(url, P.endpoints.Bootstrap(
        schema_text=schema, relationships_text="\n".join(rels)))


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def _ship(r) -> str:
    return r.permissionship.name


async def seven_verbs(C, client, n_users=12, n_pods=40):
    """Drive every verb through `client` (a package C RemoteEndpoint or a
    local endpoint): the observations, in package-free form."""
    T = C.types
    out = {}
    users = [T.SubjectRef("user", f"u{i}") for i in range(n_users)]
    looked = await asyncio.gather(*(client.lookup_resources(
        "pod", "view", u) for u in users))
    out["lookups"] = [sorted(ids) for ids in looked]
    out["lookups_ns"] = [sorted(ids) for ids in await asyncio.gather(*(
        client.lookup_resources("namespace", "view", u) for u in users))]
    reqs = [T.CheckRequest(T.ObjectRef("pod", f"ns{p % 6}/p{p}"), "view", u)
            for p in range(0, n_pods, 3) for u in users[::2]]
    out["bulk"] = [_ship(r) for r in
                   await client.check_bulk_permissions(reqs)]
    one = await client.check_permission(reqs[1])
    out["check"] = _ship(one)
    rev0 = one.checked_at
    watcher = client.watch(["pod"])
    await asyncio.sleep(0.3)  # the remote stream establishes
    rev1 = await client.write_relationships([
        T.RelationshipUpdate(T.UpdateOp.TOUCH, T.parse_relationship(
            f"pod:ns0/p{p}#viewer@user:u1")) for p in range(0, 12, 2)])
    rev2 = await client.write_relationships([T.RelationshipUpdate(
        T.UpdateOp.CREATE, T.parse_relationship("pod:ns1/new#viewer@user:u2"))])
    out["revs"] = (rev1 - rev0, rev2 - rev1)
    out["after_write"] = sorted(await client.lookup_resources(
        "pod", "view", users[1]))
    read = await client.read_relationships(T.RelationshipFilter(
        resource_type="pod", relation="viewer",
        subject=T.SubjectFilter(type="user", id="u1")))
    out["read"] = sorted(r.rel_string() for r in read)
    try:
        await client.write_relationships([T.RelationshipUpdate(
            T.UpdateOp.CREATE,
            T.parse_relationship("pod:ns1/new#viewer@user:u2"))])
        out["dup_create"] = "ok"
    except Exception as e:
        out["dup_create"] = type(e).__name__
    try:
        await client.write_relationships(
            [T.RelationshipUpdate(T.UpdateOp.TOUCH, T.parse_relationship(
                "pod:ns1/x#viewer@user:u3"))],
            [T.Precondition(op=T.PreconditionOp.MUST_MATCH,
                            filter=T.RelationshipFilter(
                                resource_type="pod", resource_id="none"))])
        out["precondition"] = "ok"
    except Exception as e:
        out["precondition"] = ("PreconditionFailed" if "recondition" in
                               (type(e).__name__ + str(e)) else
                               type(e).__name__)
    rev3 = await client.delete_relationships(T.RelationshipFilter(
        resource_type="pod", relation="viewer",
        subject=T.SubjectFilter(type="user", id="u1")))
    out["delete_rev"] = rev3 - rev2
    out["after_delete"] = sorted(await client.lookup_resources(
        "pod", "view", users[1]))
    seen = []
    loop = asyncio.get_running_loop()
    for _ in range(3):
        upd = await loop.run_in_executor(None, watcher.poll, 5.0)
        if upd is None:
            break
        seen.append(sorted((u.op.name, u.rel.rel_string())
                           for u in upd.updates))
    watcher.close()
    out["watch"] = seen
    return out


async def served(P_server, server_url, C_client, client_fn, token="",
                 client_token=None, **client_kw):
    """Serve a fresh P_server endpoint over loopback gRPC and run
    `client_fn(C_client, client)` against it."""
    ep = make_endpoint(P_server, server_url, rels=boot_rels())
    server = P_server.grpc.PermissionsGrpcServer(ep, token=token)
    port = await server.start("127.0.0.1:0")
    client = C_client.grpc.RemoteEndpoint(
        f"127.0.0.1:{port}", insecure=True,
        token=token if client_token is None else client_token, **client_kw)
    try:
        return await client_fn(C_client, client), ep
    finally:
        await client.close()
        await server.stop()


def local(P, url):
    async def go():
        ep = make_endpoint(P, url, rels=boot_rels())
        return await seven_verbs(P, ep)
    return run(go())


@pytest.fixture(scope="module")
def oracle_run():
    return local(PORT, "embedded://")


def test_seven_verbs_port_client_against_port_server(oracle_run):
    got, ep = run(served(PORT, PORT_URL, PORT, seven_verbs))
    assert got == oracle_run
    assert got == local(REF, REF_URL)
    # the server's endpoint was the batched torch:// one, and its lookups
    # were answered by the (twin) kernels, not the oracle
    assert type(ep).__name__ == "BatchingEndpoint"
    assert got["dup_create"] == "AlreadyExistsError"
    assert got["precondition"] == "PreconditionFailed"
    assert got["watch"] and got["revs"] == (1, 1)


def test_port_client_against_reference_server(oracle_run):
    got, _ = run(served(REF, REF_URL, PORT, seven_verbs))
    assert got == oracle_run


def test_reference_client_against_port_server(oracle_run):
    got, _ = run(served(PORT, PORT_URL, REF, seven_verbs))
    assert got == oracle_run


def test_concurrent_lookups_fuse_on_the_server():
    """64 concurrent LookupResources streams from two clients reach the
    server's dispatcher together: fewer batches than RPCs, answers equal
    to the oracle's."""
    async def go():
        ep = make_endpoint(PORT, PORT_URL, rels=boot_rels())
        oracle = make_endpoint(PORT, "embedded://", rels=boot_rels())
        server = PORT.grpc.PermissionsGrpcServer(ep)
        port = await server.start("127.0.0.1:0")
        T = PORT.types
        clients = [PORT.grpc.RemoteEndpoint(f"127.0.0.1:{port}",
                                            insecure=True) for _ in range(2)]
        try:
            subjects = [T.SubjectRef("user", f"u{i % 12}") for i in range(64)]
            before = dict(ep.stats)
            got = await asyncio.gather(*(
                clients[i % 2].lookup_resources("pod", "view", s)
                for i, s in enumerate(subjects)))
            after = dict(ep.stats)
            want = [await oracle.lookup_resources("pod", "view", s)
                    for s in subjects]
            return ([sorted(x) for x in got], [sorted(x) for x in want],
                    before, after)
        finally:
            for c in clients:
                await c.close()
            await server.stop()

    got, want, before, after = run(go())
    assert got == want
    # fused_lookups counts the dispatcher's fused batches
    batches = after["fused_lookups"] - before["fused_lookups"]
    assert 1 <= batches < 64
    assert after["max_fused_batch"] > 1


# -- caveats over the wire (tests/test_grpc_caveats.py) ------------------------


async def caveat_scenario(S, server_url, C):
    T = C.types
    inner = S.endpoints.create_endpoint(
        server_url, S.endpoints.Bootstrap(schema_text=CAVEAT_SCHEMA))
    server = S.grpc.PermissionsGrpcServer(inner)
    port = await server.start("127.0.0.1:0")
    client = C.grpc.RemoteEndpoint(f"127.0.0.1:{port}", insecure=True)
    out = {}
    try:
        watcher = client.watch(["doc"])
        await asyncio.sleep(0.3)
        await client.write_relationships([
            T.RelationshipUpdate(T.UpdateOp.TOUCH, T.parse_relationship(
                "doc:d1#viewer@user:alice[caveat:on_call]")),
            T.RelationshipUpdate(T.UpdateOp.TOUCH, T.parse_relationship(
                'doc:d2#viewer@user:alice[caveat:on_call:{"active": true}]')),
            T.RelationshipUpdate(T.UpdateOp.TOUCH, T.parse_relationship(
                "doc:d3#viewer@user:alice")),
            T.RelationshipUpdate(T.UpdateOp.TOUCH, T.parse_relationship(
                'doc:d4#viewer@user:bob[caveat:on_call:{"active": false}]')),
        ])
        out["read"] = sorted(r.rel_string()
                             for r in await client.read_relationships(None))
        out["checks"] = [
            (await client.check_permission(T.CheckRequest(
                T.ObjectRef("doc", d), "view",
                T.SubjectRef("user", u)))).permissionship.name
            for d, u in (("d1", "alice"), ("d2", "alice"), ("d3", "alice"),
                         ("d4", "bob"), ("d3", "bob"))]
        out["lookup"] = sorted(await client.lookup_resources(
            "doc", "view", T.SubjectRef("user", "alice")))
        upd = await asyncio.get_running_loop().run_in_executor(
            None, watcher.poll, 5.0)
        out["watch"] = sorted((u.rel.rel_string(),
                               u.rel.caveat.context() if u.rel.caveat
                               else None) for u in upd.updates)
        watcher.close()
    finally:
        await client.close()
        await server.stop()
    return out


@pytest.mark.parametrize("server", ["port-torch", "port-embedded", "ref"])
def test_caveats_round_trip_grpc(server):
    S, url = {"port-torch": (PORT, PORT_URL),
              "port-embedded": (PORT, "embedded://"),
              "ref": (REF, REF_URL)}[server]
    got = run(caveat_scenario(S, url, PORT))
    want = run(caveat_scenario(REF, "embedded://", REF))
    assert got == want
    assert got["checks"] == ["CONDITIONAL_PERMISSION", "HAS_PERMISSION",
                             "HAS_PERMISSION", "NO_PERMISSION",
                             "NO_PERMISSION"]
    assert got["lookup"] == ["d2", "d3"]
    assert ("doc:d4#viewer@user:bob[caveat:on_call:{\"active\": false}]",
            {"active": False}) in got["watch"]


def test_remote_lr_skips_conditional_results():
    """CONDITIONAL, absent and unknown permissionships never enter a
    lookup's answer (reference lookups.go:85-88), as in the reference."""
    def frame(W, rid, ship):
        return (W._len_field(1, W.enc_zedtoken(1)) + W._str_field(2, rid)
                + W._varint_field(3, ship))

    def ids(P):
        ep = P.grpc.RemoteEndpoint("127.0.0.1:1", insecure=True)

        async def fake_stream(method, payload):
            assert method == "LookupResources"
            for rid, ship in (("definite-id", 2), ("caveated-id", 3),
                              ("unspecified-id", 0), ("future-enum-id", 9),
                              ("another-definite", 2)):
                yield frame(P.wire, rid, ship)

        ep._unary_stream = fake_stream
        return asyncio.run(ep.lookup_resources(
            "doc", "view", P.types.SubjectRef("user", "a")))

    assert ids(PORT) == ids(REF) == ["definite-id", "another-definite"]


# -- the bearer token and TLS --------------------------------------------------


def test_bearer_token_required():
    async def check(C, client):
        T = C.types
        return _ship(await client.check_permission(T.CheckRequest(
            T.ObjectRef("namespace", "ns0"), "view", T.SubjectRef("user",
                                                                  "u0"))))

    async def wrong(C, client):
        try:
            await check(C, client)
        except C.grpc.RemoteEndpointError as e:
            return str(e.code)
        return "answered"

    async def wrong_stream(C, client):
        try:
            await client.lookup_resources("pod", "view",
                                          C.types.SubjectRef("user", "u0"))
        except C.grpc.RemoteEndpointError as e:
            return str(e.code)
        return "answered"

    right, _ = run(served(PORT, "embedded://", PORT, check, token="s3cret"))
    want, _ = run(served(REF, "embedded://", REF, check, token="s3cret"))
    assert right == want
    for fn in (wrong, wrong_stream):
        for client_token in ("", "nope"):
            got, _ = run(served(PORT, "embedded://", PORT, fn,
                                token="s3cret", client_token=client_token))
            ref, _ = run(served(REF, "embedded://", REF, fn,
                                token="s3cret", client_token=client_token))
            assert got == ref == "StatusCode.UNAUTHENTICATED"


def test_watch_over_a_token_protected_server():
    """The port's watch stream carries the bearer token, so it delivers
    the writes of a token-protected server.  The reference's sends none
    and its stream ends UNAUTHENTICATED at once, delivering nothing (a
    fault of the reference the port does not share; ROADMAP Queue 3)."""
    async def go(C):
        ep = make_endpoint(PORT, "embedded://", rels=boot_rels())
        server = PORT.grpc.PermissionsGrpcServer(ep, token="k")
        port = await server.start("127.0.0.1:0")
        client = C.grpc.RemoteEndpoint(f"127.0.0.1:{port}", insecure=True,
                                       token="k")
        T = C.types
        try:
            watcher = client.watch(["pod"])
            await asyncio.sleep(0.5)
            for p in range(3):
                await client.write_relationships([T.RelationshipUpdate(
                    T.UpdateOp.TOUCH, T.parse_relationship(
                        f"pod:ns0/p{p}#viewer@user:u9"))])
            seen = []
            loop = asyncio.get_running_loop()
            for _ in range(3):
                upd = await loop.run_in_executor(None, watcher.poll, 3.0)
                if upd is None:
                    break
                seen += [u.rel.rel_string() for u in upd.updates]
            watcher.close()
            return seen, watcher.closed
        finally:
            await client.close()
            await server.stop()

    got, want = run(go(PORT)), run(go(REF))
    assert got[0] == [f"pod:ns0/p{p}#viewer@user:u9" for p in range(3)]
    assert want == ([], True)


def _self_signed(tmp, cn="localhost", san=("localhost",), ip="127.0.0.1"):
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID
    import ipaddress
    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])
    now = datetime.datetime(2026, 1, 1)
    alt = [x509.DNSName(s) for s in san]
    if ip:
        alt.append(x509.IPAddress(ipaddress.ip_address(ip)))
    cert = (x509.CertificateBuilder().subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now)
            .not_valid_after(now + datetime.timedelta(days=3650))
            .add_extension(x509.SubjectAlternativeName(alt), critical=False)
            .sign(key, hashes.SHA256()))
    cert_pem = cert.public_bytes(serialization.Encoding.PEM)
    key_pem = key.private_bytes(serialization.Encoding.PEM,
                                serialization.PrivateFormat.PKCS8,
                                serialization.NoEncryption())
    ca_path = os.path.join(tmp, "ca.pem")
    with open(ca_path, "wb") as f:
        f.write(cert_pem)
    return cert_pem, key_pem, ca_path


@pytest.mark.parametrize("mode", ["ca_path", "skip_verify"])
def test_tls_with_ca_and_with_a_pinned_certificate(mode, tmp_path):
    """A TLS server; the client trusts it through `ca_path` (the CLI's
    --spicedb-ca-path), or pins the certificate it fetched itself
    (--spicedb-skip-verify-ca), and answers as the reference's."""
    pytest.importorskip("cryptography")
    cert, key, ca_path = _self_signed(str(tmp_path))

    async def go(P):
        ep = make_endpoint(P, "embedded://", rels=boot_rels())
        server = P.grpc.PermissionsGrpcServer(ep, token="t", tls_cert=cert,
                                              tls_key=key)
        port = await server.start("127.0.0.1:0")
        kw = ({"ca_path": ca_path} if mode == "ca_path"
              else {"skip_verify_ca": True})
        client = P.endpoints.create_endpoint(f"grpcs://127.0.0.1:{port}",
                                             token="t", **kw)
        try:
            T = P.types
            return (type(client).__name__, client.insecure,
                    sorted(await client.lookup_resources(
                        "pod", "view", T.SubjectRef("user", "u1"))))
        finally:
            await client.close()
            await server.stop()

    got, want = run(go(PORT)), run(go(REF))
    assert got == want and got[0] == "RemoteEndpoint" and got[1] is False
    assert got[2]


class TestParseTargetAndPinning:
    """tests/test_grpc_pinning.py's cases on the port's client."""

    @pytest.mark.parametrize("target,want", [
        ("[::1]:50051", ("::1", 50051)), ("[fe80::1]", ("fe80::1", 443)),
        ("fe80::1:2", ("fe80::1:2", 443)),
        ("example.com:443", ("example.com", 443)),
        ("example.com", ("example.com", 443))])
    def test_parse_target(self, target, want):
        assert (PORT.grpc.RemoteEndpoint._parse_target(target)
                == REF.grpc.RemoteEndpoint._parse_target(target) == want)

    def _pins(self, P, monkeypatch, pem, target):
        import ssl
        record = []

        def fake_get(addr, timeout=None):
            record.append((addr, threading.current_thread()))
            return pem

        monkeypatch.setattr(ssl, "get_server_certificate", fake_get)
        ep = P.grpc.RemoteEndpoint(target, skip_verify=True)

        async def go():
            await ep._ensure_pinned()
            return threading.current_thread()
        loop_thread = asyncio.run(go())
        pinned = ep._pin_server_cert()
        return (record[0][0], pinned, len(record),
                record[0][1] is not loop_thread)

    @pytest.mark.parametrize("san", [("alt.example",), ()])
    def test_pin_off_loop_with_name_override(self, monkeypatch, tmp_path,
                                             san):
        pytest.importorskip("cryptography")
        cert, _, _ = _self_signed(str(tmp_path), cn="myserver", san=san,
                                  ip=None)
        pem = cert.decode()
        got = self._pins(PORT, monkeypatch, pem, "[::1]:50051")
        want = self._pins(REF, monkeypatch, pem, "[::1]:50051")
        assert got == want
        assert got[0] == ("::1", 50051) and got[2] == 1 and got[3]
        assert got[1][1] == [("grpc.ssl_target_name_override",
                              san[0] if san else "myserver")]

    def test_no_pin_when_ca_given(self, monkeypatch):
        import ssl
        monkeypatch.setattr(ssl, "get_server_certificate",
                            lambda *a, **k: pytest.fail("fetched"))
        ep = PORT.grpc.RemoteEndpoint("host:443", skip_verify=True,
                                      ca_pem=b"ca")
        asyncio.run(ep._ensure_pinned())
        assert ep._pinned is None


# -- the endpoint factory's remote branch ---------------------------------------


@pytest.mark.parametrize("url,kw", [
    ("grpc://localhost:50051", {}), ("localhost:50051", {}),
    ("grpcs://h:1", {"insecure": True}), ("http://h:2", {}),
    ("https://h:3", {"token": "t", "skip_verify": True}),
])
def test_create_endpoint_remote_as_the_reference(url, kw):
    def shape(P):
        ep = P.endpoints.create_endpoint(url, **kw)
        return (type(ep).__name__, ep.target, ep.insecure, ep.token,
                ep.skip_verify, ep.ca_pem)
    assert shape(PORT) == shape(REF)


@pytest.mark.parametrize("kw,match", [
    ({"store": "STORE"}, "--data-dir persistence requires a store-backed"),
    ({"decision_cache": True}, "--decision-cache requires a store-backed"),
])
def test_remote_refuses_store_and_cache(kw, match):
    for P in (PORT, REF):
        if "store" in kw:
            kw = {"store": importlib.import_module(
                f"{P.root}.spicedb.store").TupleStore()}
        with pytest.raises(P.endpoints.EndpointConfigError, match=match):
            P.endpoints.create_endpoint("grpc://localhost:50051", **kw)


def test_switch_derived_cache_is_dropped_for_remote():
    from spicedb_kubeapi_proxy_tpu_torch.utils import features
    features.DECISION_CACHE = True
    try:
        ep = PORT.endpoints.create_endpoint("grpc://127.0.0.1:1")
        assert type(ep).__name__ == "RemoteEndpoint"
    finally:
        features.DECISION_CACHE = False


# -- permsd --------------------------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_permsd_serves_torch_cpu_and_exits_0_on_sigterm(tmp_path):
    boot = tmp_path / "bootstrap.json"
    boot.write_text(json.dumps({"schema": SCHEMA,
                                "relationships": "\n".join(boot_rels())}))
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "spicedb_kubeapi_proxy_tpu_torch.permsd",
         "--listen-address", f"127.0.0.1:{port}", "--spicedb-endpoint",
         PORT_URL, "--spicedb-bootstrap", str(boot), "--spicedb-token", "k"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        async def go():
            client = PORT.grpc.RemoteEndpoint(f"127.0.0.1:{port}",
                                              insecure=True, token="k")
            T = PORT.types
            try:
                for _ in range(300):
                    try:
                        return sorted(await client.lookup_resources(
                            "pod", "view", T.SubjectRef("user", "u1")))
                    except PORT.grpc.RemoteEndpointError:
                        if proc.poll() is not None:
                            raise
                        await asyncio.sleep(0.2)
            finally:
                await client.close()
        got = run(go())
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    want = run(make_endpoint(PORT, "embedded://", rels=boot_rels())
               .lookup_resources("pod", "view",
                                 PORT.types.SubjectRef("user", "u1")))
    assert got == sorted(want) and got
    assert proc.returncode == 0, err[-2000:]
    assert "Traceback" not in err
    assert f"permsd serving {PORT_URL}" in err


# -- grpc blocked ----------------------------------------------------------------

_BLOCKED = r"""
import asyncio, json, subprocess, sys
sys.modules["grpc"] = None
sys.modules["grpc.aio"] = None
from spicedb_kubeapi_proxy_tpu_torch.spicedb import grpc_remote, wire
from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
    Bootstrap, EndpointConfigError, create_endpoint)
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
    CheckRequest, ObjectRef, SubjectRef)
out = {}
try:
    create_endpoint("grpc://127.0.0.1:1")
    out["grpc"] = "built"
except EndpointConfigError as e:
    out["grpc"] = str(e)
ep = create_endpoint("torch://?device=cpu", Bootstrap(
    "definition user {}\ndefinition doc { relation viewer: user\n"
    "permission view = viewer }", "doc:d1#viewer@user:ann"))
server = grpc_remote.PermissionsGrpcServer(ep)
handlers = server.handlers()

class Aborted(Exception):
    pass

class Ctx:
    async def abort(self, code, details):
        raise Aborted(f"{code}: {details}")
    def cancelled(self):
        return False

async def go():
    path = "/authzed.api.v1.PermissionsService/"
    _, lookup = handlers[path + "LookupResources"]
    frames = [f async for f in lookup(wire.enc_lookup_request(
        "doc", "view", SubjectRef("user", "ann")), Ctx())]
    _, check = handlers[path + "CheckPermission"]
    res = wire.dec_check_response(await check(wire.enc_check_request(
        CheckRequest(ObjectRef("doc", "d1"), "view",
                     SubjectRef("user", "ann"))), Ctx()))
    _, write = handlers[path + "WriteRelationships"]
    try:
        await write(b"\x0a\x02\x08\x07", Ctx())
        bad = "written"
    except Aborted as e:
        bad = str(e)
    return ([wire.dec_lookup_response(f)[0] for f in frames],
            res.permissionship.name, bad)

out["ids"], out["check"], out["bad_write"] = asyncio.run(go())
try:
    asyncio.run(server.start())
    out["start"] = "started"
except ImportError as e:
    out["start"] = str(e)
from spicedb_kubeapi_proxy_tpu_torch import permsd
out["permsd"] = permsd.main(["--spicedb-endpoint", "embedded://"])
out["modules"] = sorted(m for m, mod in sys.modules.items()
                        if mod is not None)
print(json.dumps(out))
"""


def test_module_and_handlers_load_with_grpc_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT,
                         capture_output=True, text=True, timeout=LIMIT_S * 2)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "requires grpcio" in res["grpc"]
    assert res["ids"] == ["d1"] and res["check"] == "HAS_PERMISSION"
    assert res["bad_write"].startswith("INVALID_ARGUMENT: ")
    assert "require grpcio" in res["start"]
    assert res["permsd"] == 1
    assert "permsd: the remote endpoint and permsd require grpcio" in \
        out.stderr
    assert not [m for m in res["modules"]
                if m == "grpc" or m.startswith("grpc.")]


# -- chip_smoke.py phase 22 on the CPU, at a small size -------------------------


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _count_twins(monkeypatch):
    """The kernels' twins count launches as the card's wrappers do."""
    import functools

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    for name in kernels.KERNEL_NAMES:
        fn = getattr(reference, name, None)
        if fn is None:
            continue

        def counted(*a, _fn=fn, _name=name, **k):
            kernels._count(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(reference, name, functools.wraps(fn)(counted))


@pytest.mark.parametrize("transport", ["grpc", "in-process"])
def test_chip_smoke_phase22_rehearsal_on_the_cpu(monkeypatch, tmp_path,
                                                 transport):
    """chip_smoke.py's phase 22 runs after phase 16 on `device="cpu"` over
    a small multitenant-1m, both ways: over loopback gRPC (permsd as a
    process answering and exiting 0), and with grpc unimportable (the
    handlers in-process; permsd and `grpc://` failing with the grpcio
    message).  Every check of the phase holds, and every read kernel and
    `scatter_rows` launched."""
    from spicedb_kubeapi_proxy_tpu_torch.models import workloads
    from spicedb_kubeapi_proxy_tpu_torch.utils import features

    pytest.importorskip("yaml")
    smoke = _chip_smoke()
    monkeypatch.setenv("SPICEDB_TPU_LEOPARD_BUDGET_BYTES", "0")
    monkeypatch.setattr(features, "ASYNC_REBUILD", features.ASYNC_REBUILD)
    _count_twins(monkeypatch)
    if transport == "in-process":
        blocked = tmp_path / "blocked"
        (blocked / "grpc").mkdir(parents=True)
        (blocked / "grpc" / "__init__.py").write_text(
            "raise ImportError('grpc is blocked here')\n")
        monkeypatch.setenv("PYTHONPATH", str(blocked))
        monkeypatch.setitem(sys.modules, "grpc", None)
        monkeypatch.setitem(sys.modules, "grpc.aio", None)
    for const, value in (("PROXY_NAMESPACES", 200), ("PROXY_PODS", 1000),
                         ("PROXY_EVENTS", 50), ("PROXY_LIST_USERS", 32),
                         ("PROXY_GETS", 50), ("REMOTE_LOOKUPS", 16),
                         ("REMOTE_BULK", 1_000), ("REMOTE_WRITES", 8),
                         ("REMOTE_ORACLE_CHECKS", 50)):
        monkeypatch.setattr(smoke, const, value)
    w = workloads.multitenant_1m(n_pods=2_000, n_tuples=20_000,
                                 n_users=500, n_namespaces=200)
    p16 = smoke.proxy_path(w, "cpu", device="cpu")
    out = smoke.remote_path(p16, "cpu", device="cpu")
    assert out["transport"] == transport
    assert all(out["launches"][k] > 0
               for k in smoke.READ_KERNELS + ("scatter_rows",))
