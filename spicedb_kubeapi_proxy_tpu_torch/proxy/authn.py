"""Request authentication.

Mirrors the reference's authenticator stack (pkg/proxy/authn.go:17-53:
WithClientCert().WithOIDC().WithTokenFile().WithRequestHeader()):

- embedded mode: a header-based authenticator reads `X-Remote-User`,
  `X-Remote-Group`, `X-Remote-Extra-*` with no cert check (reference
  authn.go:78-119 — embedded mode sits behind a trusted front end);
- serving mode: TLS client certificate maps CN -> user, O -> groups (the
  kube client-cert convention);
- front-proxy (request-header) mode: `X-Remote-*` headers are trusted ONLY
  when the request's client certificate cryptographically chains to the
  configured front-proxy CA and its CN is in the allowed-names list
  (k8s.io/apiserver requestheader semantics, reference authn.go:121-153);
- OIDC: bearer JWTs verified against a static JWKS file (no issuer
  discovery), iss/aud/exp/nbf enforced.

Authenticators compose: first success wins.
"""

from __future__ import annotations

import base64
import json
import time
from typing import Optional

from .httpcore import Request
from .kube import UserInfo

REMOTE_USER_HEADER = "X-Remote-User"
REMOTE_GROUP_HEADER = "X-Remote-Group"
REMOTE_EXTRA_PREFIX = "X-Remote-Extra-"


class Authenticator:
    def authenticate(self, req: Request) -> Optional[UserInfo]:
        raise NotImplementedError


class HeaderAuthenticator(Authenticator):
    """Embedded-mode authenticator (reference authn.go:78-119)."""

    def authenticate(self, req: Request) -> Optional[UserInfo]:
        name = req.headers.get(REMOTE_USER_HEADER)
        if not name:
            return None
        groups = req.headers.get_all(REMOTE_GROUP_HEADER)
        extra: dict = {}
        for k, v in req.headers.items():
            if k.lower().startswith(REMOTE_EXTRA_PREFIX.lower()):
                extra.setdefault(k[len(REMOTE_EXTRA_PREFIX):].lower(), []).append(v)
        return UserInfo(name=name, groups=list(groups), extra=extra)


class ClientCertAuthenticator(Authenticator):
    """TLS client-certificate authenticator: CN -> user, O -> groups."""

    def authenticate(self, req: Request) -> Optional[UserInfo]:
        cert = req.peer_cert
        if not cert:
            return None
        name = ""
        groups: list = []
        for rdn in cert.get("subject", ()):  # ((('commonName', 'x'),), ...)
            for key, value in rdn:
                if key == "commonName":
                    name = value
                elif key == "organizationName":
                    groups.append(value)
        if not name:
            return None
        return UserInfo(name=name, groups=groups)


class TokenFileAuthenticator(Authenticator):
    """Static bearer-token authenticator in the kube token-auth-file format
    (`token,user,uid[,"group1,group2"]` CSV rows), one of the built-in
    authentication modes the reference composes in via
    BuiltInAuthenticationOptions (reference authn.go:17-53)."""

    def __init__(self, path: str):
        import csv

        self._by_token: dict[str, UserInfo] = {}
        with open(path, "r", encoding="utf-8", newline="") as f:
            for row in csv.reader(f):
                if not row or len(row) < 3:
                    continue
                token, name, uid = row[0], row[1], row[2]
                groups = [g for g in (row[3].split(",") if len(row) > 3 else [])
                          if g]
                self._by_token[token] = UserInfo(name=name, uid=uid,
                                                 groups=groups)

    def authenticate(self, req: Request) -> Optional[UserInfo]:
        auth = req.headers.get("Authorization")
        if not auth.startswith("Bearer "):
            return None
        user = self._by_token.get(auth[len("Bearer "):].strip())
        if user is None:
            return None
        return UserInfo(name=user.name, uid=user.uid,
                        groups=list(user.groups),
                        extra={k: list(v) for k, v in user.extra.items()})


class RequestHeaderAuthenticator(Authenticator):
    """Front-proxy authenticator: trust `X-Remote-*` identity headers only
    from a verified front proxy (reference authn.go:121-153 wires
    k8s.io/apiserver's requestheader config; semantics from
    apiserver/pkg/authentication/request/headerrequest).

    The proxy's client certificate must verify against `ca_file` — issuer
    match + signature + validity window are checked cryptographically on
    the DER presented at the TLS handshake — and, when `allowed_names` is
    non-empty, its CN must be one of them.  A spoofed `X-Remote-User`
    without such a certificate authenticates as nobody.
    """

    def __init__(self, ca_file: str, allowed_names: tuple = (),
                 username_headers: tuple = (REMOTE_USER_HEADER,),
                 group_headers: tuple = (REMOTE_GROUP_HEADER,),
                 extra_prefixes: tuple = (REMOTE_EXTRA_PREFIX,)):
        from cryptography import x509

        with open(ca_file, "rb") as f:
            self._ca = x509.load_pem_x509_certificate(f.read())
        self.allowed_names = tuple(allowed_names)
        self.username_headers = tuple(username_headers)
        self.group_headers = tuple(group_headers)
        self.extra_prefixes = tuple(extra_prefixes)

    def _verify_front_proxy(self, der: Optional[bytes]) -> bool:
        from cryptography import x509
        from cryptography.exceptions import InvalidSignature
        from cryptography.x509.oid import NameOID

        if not der:
            return False
        try:
            cert = x509.load_der_x509_certificate(der)
            # issuer-name match + signature by the CA key
            cert.verify_directly_issued_by(self._ca)
        except (ValueError, TypeError, InvalidSignature):
            return False
        import datetime
        now = datetime.datetime.now(datetime.timezone.utc)
        if not (cert.not_valid_before_utc <= now <= cert.not_valid_after_utc):
            return False
        if self.allowed_names:
            cns = [a.value for a in cert.subject.get_attributes_for_oid(
                NameOID.COMMON_NAME)]
            if not any(cn in self.allowed_names for cn in cns):
                return False
        return True

    def authenticate(self, req: Request) -> Optional[UserInfo]:
        if not self._verify_front_proxy(req.peer_cert_der):
            return None
        name = ""
        for h in self.username_headers:
            name = req.headers.get(h)
            if name:
                break
        if not name:
            return None
        groups: list = []
        for h in self.group_headers:
            groups.extend(req.headers.get_all(h))
        extra: dict = {}
        for k, v in req.headers.items():
            for prefix in self.extra_prefixes:
                if k.lower().startswith(prefix.lower()):
                    extra.setdefault(k[len(prefix):].lower(), []).append(v)
                    break
        return UserInfo(name=name, groups=groups, extra=extra)


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


class OIDCAuthenticator(Authenticator):
    """OIDC bearer-token authenticator with a STATIC JWKS file (reference
    authn.go:17-53 WithOIDC; no issuer discovery: keys are provided out
    of band like kube-apiserver's structured authn config `keyFile`
    option).

    Verifies RS256/ES256 signatures via the `cryptography` runtime and
    enforces iss, aud (client_id), exp and nbf.
    """

    def __init__(self, issuer_url: str, client_id: str, jwks_file: str,
                 username_claim: str = "sub", groups_claim: str = "groups",
                 username_prefix: str = ""):
        self.issuer = issuer_url
        self.client_id = client_id
        self.username_claim = username_claim
        self.groups_claim = groups_claim
        self.username_prefix = username_prefix
        with open(jwks_file, "r", encoding="utf-8") as f:
            jwks = json.load(f)
        self._keys = []  # (kid, alg-family, public key object)
        for k in jwks.get("keys", []):
            key = self._load_jwk(k)
            if key is not None:
                self._keys.append((k.get("kid", ""), k.get("kty"), key))
        if not self._keys:
            raise ValueError(f"no usable keys in JWKS file {jwks_file}")

    @staticmethod
    def _load_jwk(jwk: dict):
        from cryptography.hazmat.primitives.asymmetric import ec, rsa

        def num(field):
            return int.from_bytes(_b64url_decode(jwk[field]), "big")

        try:
            if jwk.get("kty") == "RSA":
                return rsa.RSAPublicNumbers(num("e"), num("n")).public_key()
            if jwk.get("kty") == "EC" and jwk.get("crv") == "P-256":
                return ec.EllipticCurvePublicNumbers(
                    num("x"), num("y"), ec.SECP256R1()).public_key()
        except (KeyError, ValueError):
            return None
        return None

    def _verify_signature(self, signing_input: bytes, sig: bytes,
                          alg: str, kid: str) -> bool:
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import ec, padding
        from cryptography.hazmat.primitives.asymmetric.utils import (
            encode_dss_signature,
        )

        want_kty = {"RS256": "RSA", "ES256": "EC"}.get(alg)
        if want_kty is None:
            return False
        candidates = [(k, t, key) for k, t, key in self._keys
                      if t == want_kty and (not kid or k == kid)]
        for _, _, key in candidates:
            try:
                if want_kty == "RSA":
                    key.verify(sig, signing_input, padding.PKCS1v15(),
                               hashes.SHA256())
                else:
                    if len(sig) != 64:
                        continue
                    der_sig = encode_dss_signature(
                        int.from_bytes(sig[:32], "big"),
                        int.from_bytes(sig[32:], "big"))
                    key.verify(der_sig, signing_input,
                               ec.ECDSA(hashes.SHA256()))
                return True
            except InvalidSignature:
                continue
        return False

    def authenticate(self, req: Request) -> Optional[UserInfo]:
        auth = req.headers.get("Authorization")
        if not auth.startswith("Bearer "):
            return None
        token = auth[len("Bearer "):].strip()
        parts = token.split(".")
        if len(parts) != 3:
            return None
        try:
            header = json.loads(_b64url_decode(parts[0]))
            claims = json.loads(_b64url_decode(parts[1]))
            sig = _b64url_decode(parts[2])
        except (ValueError, TypeError):
            return None
        signing_input = f"{parts[0]}.{parts[1]}".encode("ascii")
        if not self._verify_signature(signing_input, sig,
                                      header.get("alg", ""),
                                      header.get("kid", "")):
            return None
        if claims.get("iss") != self.issuer:
            return None
        aud = claims.get("aud")
        if isinstance(aud, str):
            aud = [aud]
        if not aud or self.client_id not in aud:
            return None
        now = time.time()
        leeway = 10.0
        exp = claims.get("exp")
        if not isinstance(exp, (int, float)) or now > exp + leeway:
            return None
        nbf = claims.get("nbf")
        if isinstance(nbf, (int, float)) and now < nbf - leeway:
            return None
        name = claims.get(self.username_claim)
        if not isinstance(name, str) or not name:
            return None
        groups = claims.get(self.groups_claim) or []
        if isinstance(groups, str):
            groups = [groups]
        if not all(isinstance(g, str) for g in groups):
            return None
        return UserInfo(name=self.username_prefix + name,
                        groups=list(groups))


class AnonymousAuthenticator(Authenticator):
    """Kube-style anonymous fallback."""

    def authenticate(self, req: Request) -> Optional[UserInfo]:
        return UserInfo(name="system:anonymous",
                        groups=["system:unauthenticated"])


class AuthenticatorChain(Authenticator):
    def __init__(self, authenticators: list):
        self.authenticators = authenticators

    def authenticate(self, req: Request) -> Optional[UserInfo]:
        from ..utils.tracing import span

        with span("authn", phase=True) as attrs:
            for a in self.authenticators:
                user = a.authenticate(req)
                if user is not None:
                    attrs["authenticator"] = type(a).__name__
                    return user
            return None
