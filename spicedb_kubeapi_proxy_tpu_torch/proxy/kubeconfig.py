"""Backend kubeconfig loading and upstream-transport construction
(this package's reference proxy/kubeconfig.py:31-276).

Python equivalent of the reference's kubeconfig plumbing
(pkg/proxy/options.go:382-410 `configFromPath`, options.go:429-449
`NewTransportForKubeconfig`, and the in-cluster branch of `Complete`,
options.go:223-246): parse a kubeconfig YAML, honor `--override-upstream`
(rewrite every cluster server to the in-cluster service address from the
environment), and build a TLS client transport carrying the kubeconfig's
client certificate and/or bearer token.

`yaml` is imported by `load_kubeconfig` when it runs, and `cryptography` by
`generate_self_signed_cert` when it runs: neither is needed to import
this module.
"""

from __future__ import annotations

import base64
import ipaddress
import os
import ssl
import tempfile
from dataclasses import dataclass
from typing import Optional

from .httpcore import Request, Response, Transport, H11Transport

IN_CLUSTER_TOKEN_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/token"
IN_CLUSTER_CA_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"


@dataclass
class KubeconfigContext:
    """The resolved current-context of a kubeconfig."""
    server: str = ""
    ca_data: bytes = b""
    client_cert_data: bytes = b""
    client_key_data: bytes = b""
    token: str = ""
    insecure_skip_tls_verify: bool = False


def _b64_or_file(entry: dict, data_key: str, path_key: str,
                 base_dir: str = "") -> bytes:
    if entry.get(data_key):
        return base64.b64decode(entry[data_key])
    path = entry.get(path_key)
    if path:
        # relative cert paths resolve against the kubeconfig's directory
        # (standard clientcmd semantics)
        if base_dir and not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        with open(path, "rb") as f:
            return f.read()
    return b""


def load_kubeconfig(path: str,
                    override_upstream: bool = False) -> KubeconfigContext:
    """Load the current-context of a kubeconfig file.

    With `override_upstream`, the server address is taken from the
    `KUBERNETES_SERVICE_HOST`/`KUBERNETES_SERVICE_PORT` environment instead of
    the file (reference options.go:396-407).
    """
    if not os.path.isabs(path):
        path = os.path.join(os.getcwd(), path)
    import yaml
    with open(path, "r", encoding="utf-8") as f:
        data = yaml.safe_load(f.read()) or {}

    def by_name(section: str, name: str) -> dict:
        for item in data.get(section, []) or []:
            if item.get("name") == name:
                return item
        return {}

    current = data.get("current-context", "")
    ctx = by_name("contexts", current).get("context", {}) if current else {}
    clusters = data.get("clusters", []) or []
    users = data.get("users", []) or []
    # a named cluster/user that is missing is an error (clientcmd semantics);
    # the single-entry fallback applies only when nothing is named
    if ctx.get("cluster"):
        cluster = by_name("clusters", ctx["cluster"]).get("cluster")
        if cluster is None:
            raise ValueError(
                f"kubeconfig context references unknown cluster"
                f" {ctx['cluster']!r}")
    else:
        cluster = clusters[0].get("cluster", {}) if clusters else {}
    if ctx.get("user"):
        user = by_name("users", ctx["user"]).get("user")
        if user is None:
            raise ValueError(
                f"kubeconfig context references unknown user {ctx['user']!r}")
    else:
        user = users[0].get("user", {}) if users else {}

    base_dir = os.path.dirname(path)
    out = KubeconfigContext(
        server=cluster.get("server", ""),
        ca_data=_b64_or_file(cluster, "certificate-authority-data",
                             "certificate-authority", base_dir),
        client_cert_data=_b64_or_file(user, "client-certificate-data",
                                      "client-certificate", base_dir),
        client_key_data=_b64_or_file(user, "client-key-data", "client-key",
                                     base_dir),
        token=user.get("token", ""),
        insecure_skip_tls_verify=bool(cluster.get("insecure-skip-tls-verify")),
    )
    if override_upstream:
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "")
        if host:
            hostpart = f"[{host}]" if ":" in host else host
            out.server = f"https://{hostpart}:{port}" if port else f"https://{hostpart}"
    return out


def in_cluster_context() -> KubeconfigContext:
    """Ambient service-account config (reference options.go:225-246 via
    rest.InClusterConfig)."""
    host = os.environ.get("KUBERNETES_SERVICE_HOST", "")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "")
    if not host:
        raise RuntimeError(
            "not running in-cluster: KUBERNETES_SERVICE_HOST is unset")
    token = ""
    if os.path.exists(IN_CLUSTER_TOKEN_PATH):
        with open(IN_CLUSTER_TOKEN_PATH, "r", encoding="utf-8") as f:
            token = f.read().strip()
    ca = b""
    if os.path.exists(IN_CLUSTER_CA_PATH):
        with open(IN_CLUSTER_CA_PATH, "rb") as f:
            ca = f.read()
    hostpart = f"[{host}]" if ":" in host else host
    return KubeconfigContext(server=f"https://{hostpart}:{port}",
                             ca_data=ca, token=token)


def _client_ssl_context(ctx: KubeconfigContext) -> Optional[ssl.SSLContext]:
    if not ctx.server.startswith("https"):
        return None
    ssl_ctx = ssl.create_default_context()
    if ctx.insecure_skip_tls_verify:
        ssl_ctx.check_hostname = False
        ssl_ctx.verify_mode = ssl.CERT_NONE
    elif ctx.ca_data:
        ssl_ctx = ssl.create_default_context(cadata=ctx.ca_data.decode())
    if ctx.client_cert_data and ctx.client_key_data:
        # ssl requires file paths for the client chain
        with tempfile.NamedTemporaryFile("wb", suffix=".crt",
                                         delete=False) as cf:
            cf.write(ctx.client_cert_data)
            cert_path = cf.name
        with tempfile.NamedTemporaryFile("wb", suffix=".key",
                                         delete=False) as kf:
            kf.write(ctx.client_key_data)
            key_path = kf.name
        try:
            ssl_ctx.load_cert_chain(cert_path, key_path)
        finally:
            os.unlink(cert_path)
            os.unlink(key_path)
    return ssl_ctx


class BearerTokenTransport(Transport):
    """Injects the service-account / kubeconfig bearer token upstream.

    The proxy strips the *client's* Authorization header before forwarding
    (pkg/proxy/server.go's director rewrites auth); the upstream credential
    comes from the backend kubeconfig, mirroring rest.Config's transport.
    """

    def __init__(self, base: Transport, token: str):
        self.base = base
        self.token = token

    async def round_trip(self, req: Request) -> Response:
        if self.token:
            req.headers.set("Authorization", f"Bearer {self.token}")
        return await self.base.round_trip(req)

    async def close(self) -> None:
        await self.base.close()


def transport_for(ctx: KubeconfigContext) -> Transport:
    """Build the upstream transport for a resolved kubeconfig context
    (reference NewTransportForKubeconfig, options.go:429-449)."""
    if not ctx.server:
        raise ValueError("kubeconfig has no cluster server address")
    transport: Transport = H11Transport(ctx.server,
                                        ssl_context=_client_ssl_context(ctx))
    if ctx.token:
        transport = BearerTokenTransport(transport, ctx.token)
    return transport


# ---------------------------------------------------------------------------
# Serving certificates
# ---------------------------------------------------------------------------

def generate_self_signed_cert(cert_dir: str, pair_name: str = "tls",
                              hosts: Optional[list] = None) -> tuple:
    """Generate a self-signed serving certificate into `cert_dir` if absent;
    returns (cert_path, key_path).

    Mirrors SecureServing.MaybeDefaultWithSelfSignedCerts (reference
    options.go:286-299): reused if already present, SANs cover localhost and
    the bind hosts.
    """
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    os.makedirs(cert_dir, exist_ok=True)
    cert_path = os.path.join(cert_dir, f"{pair_name}.crt")
    key_path = os.path.join(cert_dir, f"{pair_name}.key")
    if os.path.exists(cert_path) and os.path.exists(key_path):
        return cert_path, key_path

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    names = {"localhost"}
    ips = {ipaddress.ip_address("127.0.0.1"), ipaddress.ip_address("::1")}
    for h in hosts or []:
        if not h or h == "0.0.0.0" or h == "::":
            continue
        try:
            ips.add(ipaddress.ip_address(h))
        except ValueError:
            names.add(h)
    san = x509.SubjectAlternativeName(
        [x509.DNSName(n) for n in sorted(names)]
        + [x509.IPAddress(ip) for ip in sorted(ips, key=str)])
    subject = x509.Name([x509.NameAttribute(
        NameOID.COMMON_NAME, "spicedb-kubeapi-proxy-tpu-self-signed")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(subject).issuer_name(subject)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=365))
            .add_extension(san, critical=False)
            .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                           critical=True)
            .sign(key, hashes.SHA256()))
    with open(key_path, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption()))
    with open(cert_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    return cert_path, key_path


def serving_ssl_context(cert_file: str, key_file: str,
                        client_ca_file: str = "",
                        extra_client_ca_files: tuple = ()) -> ssl.SSLContext:
    """Server-side TLS context; with a client CA, client certificates are
    requested and verified (kube client-cert authn).  Extra CAs (e.g. the
    front-proxy requestheader CA) join the handshake trust store; the
    authenticators decide per-CA trust afterwards."""
    ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ssl_ctx.load_cert_chain(cert_file, key_file)
    ca_files = ([client_ca_file] if client_ca_file else []) + \
        [f for f in extra_client_ca_files if f]
    for ca in ca_files:
        ssl_ctx.load_verify_locations(ca)
    if ca_files:
        ssl_ctx.verify_mode = ssl.CERT_OPTIONAL
    return ssl_ctx
