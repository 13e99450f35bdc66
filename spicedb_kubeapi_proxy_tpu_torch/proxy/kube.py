"""Kubernetes request metadata types and URL parsing.

Python equivalents of the k8s.io/apiserver types the reference leans on:
`request.RequestInfo` (populated by the RequestInfo filter in the handler
chain, reference pkg/proxy/server.go:157) and `user.DefaultInfo`.  The parser
follows the upstream RequestInfoFactory conventions for API paths:

  /api/v1[/namespaces/{ns}]/{resource}[/{name}[/{subresource}]]
  /apis/{group}/{version}[/namespaces/{ns}]/{resource}[/{name}[/{subresource}]]

with verb derivation: GET -> get/list/watch (list when no name, watch when
`watch=true`), POST -> create, PUT -> update, PATCH -> patch,
DELETE -> delete/deletecollection.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from urllib.parse import parse_qs, urlsplit


@dataclass
class RequestInfo:
    is_resource_request: bool = False
    path: str = ""
    verb: str = ""
    api_prefix: str = ""
    api_group: str = ""
    api_version: str = ""
    namespace: str = ""
    resource: str = ""
    subresource: str = ""
    name: str = ""
    parts: list = field(default_factory=list)
    label_selector: str = ""
    field_selector: str = ""


@dataclass
class UserInfo:
    name: str = ""
    uid: str = ""
    groups: list = field(default_factory=list)
    extra: dict = field(default_factory=dict)


# Subresources of the namespace object itself (upstream RequestInfoFactory's
# namespaceSubresources set): /namespaces/{ns}/status addresses the namespace,
# while /namespaces/{ns}/{resource} addresses resources within it.
_NAMESPACE_SUBRESOURCES = {"status", "finalize"}


def parse_request_info(method: str, url: str) -> RequestInfo:
    """Derive RequestInfo from an HTTP method + URL (path and query)."""
    split = urlsplit(url)
    path = split.path
    query = parse_qs(split.query)

    info = RequestInfo(path=path)
    info.label_selector = (query.get("labelSelector") or [""])[0]
    info.field_selector = (query.get("fieldSelector") or [""])[0]

    parts = [p for p in path.split("/") if p]
    if not parts or parts[0] not in ("api", "apis"):
        info.verb = _nonresource_verb(method)
        return info

    info.api_prefix = parts[0]
    rest: list[str]
    if parts[0] == "api":
        # core group: /api/v1/...
        if len(parts) < 2:
            info.verb = _nonresource_verb(method)
            return info
        info.api_group = ""
        info.api_version = parts[1]
        rest = parts[2:]
    else:
        # /apis/{group}/{version}/...
        if len(parts) < 3:
            info.verb = _nonresource_verb(method)
            return info
        info.api_group = parts[1]
        info.api_version = parts[2]
        rest = parts[3:]

    if not rest:
        info.verb = _nonresource_verb(method)
        return info

    info.is_resource_request = True

    # Upstream's "watch" path prefix (legacy /watch/...) also exists; handle
    # the common modern form (watch=true query) plus the legacy prefix.
    legacy_watch = False
    if rest and rest[0] == "watch":
        legacy_watch = True
        rest = rest[1:]

    # Upstream convention: /namespaces/{ns}/{resource}/... addresses resources
    # inside the namespace; /namespaces/{ns}[/status|/finalize] addresses the
    # namespace object itself (namespace stays set to {ns} in both cases).
    if rest and rest[0] == "namespaces":
        if len(rest) > 1:
            info.namespace = rest[1]
            if len(rest) > 2 and rest[2] not in _NAMESPACE_SUBRESOURCES:
                rest = rest[2:]
    if rest:
        info.resource = rest[0]
        if len(rest) >= 2:
            info.name = rest[1]
        if len(rest) >= 3:
            info.subresource = rest[2]
    info.parts = rest

    watching = legacy_watch or (query.get("watch") or ["false"])[0] in ("true", "1")
    method = method.upper()
    if method == "GET":
        if watching:
            info.verb = "watch"
        elif info.name:
            info.verb = "get"
        else:
            info.verb = "list"
    elif method == "POST":
        info.verb = "create"
    elif method == "PUT":
        info.verb = "update"
    elif method == "PATCH":
        info.verb = "patch"
    elif method == "DELETE":
        info.verb = "delete" if info.name else "deletecollection"
    else:
        info.verb = ""
    return info


def _nonresource_verb(method: str) -> str:
    return {
        "GET": "get", "HEAD": "get", "POST": "post",
        "PUT": "put", "PATCH": "patch", "DELETE": "delete",
    }.get(method.upper(), "")
