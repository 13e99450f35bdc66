"""Workflow activities (reference pkg/authz/distributedtx/activity.go;
this package's reference authz/distributedtx/activity.py:88-197).

All inputs/outputs are JSON-serializable dicts (the journal round-trips
them).  Codec helpers translate between the wire dicts and the store types.

- write_to_spicedb: attaches an idempotency-key relationship (hash of the
  request payload + workflow id, 24h expiration); on error, an existing key
  means the write already happened and is treated as success
  (reference activity.go:47-126)
- read_relationships: drains the filter read (activity.go:152-172)
- write_to_kube: replays the original URI/body/headers (minus
  Accept-Encoding) against the upstream transport (activity.go:175-238)
- check_kube_resource: existence probe (activity.go:240-254)

Failpoints fire at the same five sites as the reference.
"""

from __future__ import annotations

import hashlib
import time

from ...proxy.httpcore import Headers, Request, Transport
from ...spicedb.endpoints import PermissionsEndpoint
from ...spicedb.types import (
    Precondition,
    PreconditionOp,
    Relationship,
    RelationshipFilter,
    RelationshipUpdate,
    SubjectFilter,
    UpdateOp,
    parse_relationship,
)
from ...utils.failpoints import fail_point

IDEMPOTENCY_KEY_EXPIRATION = 24 * 3600.0


# -- codecs ------------------------------------------------------------------

def update_to_dict(op: str, rel: Relationship) -> dict:
    return {"op": op, "rel": rel.rel_string()}


def update_from_dict(d: dict) -> RelationshipUpdate:
    return RelationshipUpdate(op=UpdateOp(d["op"]),
                              rel=parse_relationship(d["rel"]))


def filter_to_dict(f: RelationshipFilter) -> dict:
    out: dict = {
        "resource_type": f.resource_type,
        "resource_id": f.resource_id,
        "relation": f.relation,
    }
    if f.subject is not None:
        out["subject"] = {"type": f.subject.type, "id": f.subject.id,
                          "relation": f.subject.relation}
    return out


def filter_from_dict(d: dict) -> RelationshipFilter:
    subject = None
    if d.get("subject") is not None:
        s = d["subject"]
        subject = SubjectFilter(type=s.get("type", ""), id=s.get("id", ""),
                                relation=s.get("relation"))
    return RelationshipFilter(
        resource_type=d.get("resource_type", ""),
        resource_id=d.get("resource_id", ""),
        relation=d.get("relation", ""),
        subject=subject,
    )


def precondition_to_dict(p: Precondition) -> dict:
    return {"op": p.op.value, "filter": filter_to_dict(p.filter)}


def precondition_from_dict(d: dict) -> Precondition:
    return Precondition(op=PreconditionOp(d["op"]),
                        filter=filter_from_dict(d["filter"]))


# -- activities --------------------------------------------------------------

class ActivityHandler:
    def __init__(self, endpoint: PermissionsEndpoint, kube_transport: Transport):
        self.endpoint = endpoint
        self.kube_transport = kube_transport

    # write_request: {"updates": [update dicts], "preconditions": [dicts]}
    async def write_to_spicedb(self, write_request: dict, workflow_id: str) -> dict:
        fail_point("panicWriteSpiceDB")
        key_rel = idempotency_key_for_payload(write_request, workflow_id)

        updates = [update_from_dict(u) for u in write_request.get("updates", [])]
        updates.append(RelationshipUpdate(UpdateOp.CREATE, key_rel))
        preconditions = [precondition_from_dict(p)
                         for p in write_request.get("preconditions", [])]
        try:
            rev = await self.endpoint.write_relationships(updates, preconditions)
            fail_point("panicSpiceDBWriteResp")
        except Exception as e:
            from ...utils.failpoints import FailPointPanic
            if isinstance(e, FailPointPanic):
                raise
            # on error, an existing idempotency key means the relationships
            # were already written (activity.go:62-74)
            existing = await self.endpoint.read_relationships(RelationshipFilter(
                resource_type=key_rel.resource.type,
                resource_id=key_rel.resource.id,
                relation=key_rel.relation,
                subject=SubjectFilter(type=key_rel.subject.type,
                                      id=key_rel.subject.id),
            ))
            if existing:
                return {"written_at": self.endpoint.store.revision}
            raise
        return {"written_at": rev}

    async def read_relationships(self, filter_dict: dict) -> list:
        fail_point("panicReadSpiceDB")
        rels = await self.endpoint.read_relationships(filter_from_dict(filter_dict))
        fail_point("panicSpiceDBReadResp")
        return [r.rel_string() for r in rels]

    # kube_req: {"method_verb", "request_uri", "headers": {k: [v]}, "body": str}
    async def write_to_kube(self, kube_req: dict) -> dict:
        fail_point("panicKubeWrite")
        verb = kube_req.get("verb", "")
        method = {
            "put": "PUT", "patch": "PATCH", "post": "POST",
            "update": "PUT", "delete": "DELETE", "create": "POST",
        }.get(verb)
        if method is None:
            raise ValueError(f"unsupported kube verb: {verb}")
        uri = kube_req.get("request_uri", "")
        if not uri:
            raise ValueError("request URI must be specified for kube write")
        headers = Headers()
        for k, values in (kube_req.get("headers") or {}).items():
            # the transport owns gzip negotiation (activity.go:208-215)
            if k.lower() in ("accept-encoding", "content-length", "host",
                             "connection"):
                continue
            if k.lower().startswith("x-remote-"):
                continue
            for v in values:
                headers.add(k, v)
        body = (kube_req.get("body") or "").encode()
        resp = await self.kube_transport.round_trip(  # noqa: A006(external kube hop)
            Request(method=method, target=uri, headers=headers, body=body))
        fail_point("panicKubeReadResp")
        retry_after = 0
        header = resp.headers.get("Retry-After")
        if header.isdigit():
            retry_after = int(header)
        else:
            try:
                import json as _json
                details = (_json.loads(resp.body) or {}).get("details") or {}
                retry_after = int(details.get("retryAfterSeconds") or 0)
            except (ValueError, AttributeError):
                retry_after = 0
        return {
            "status_code": resp.status,
            "content_type": resp.headers.get("Content-Type", "application/json"),
            "body": resp.body.decode("utf-8", errors="replace"),
            "retry_after_seconds": retry_after,
        }

    async def check_kube_resource(self, probe_uri: str) -> bool:
        resp = await self.kube_transport.round_trip(  # noqa: A006(external kube hop)
            Request(method="GET", target=probe_uri, headers=Headers()))
        if 200 <= resp.status < 300:
            return True
        if resp.status == 404:
            return False
        raise RuntimeError(f"kube existence probe failed: {resp.status}")


def idempotency_key_for_payload(write_request: dict, workflow_id: str) -> Relationship:
    """workflow:{id}#idempotency_key@activity:{payload hash}, 24h expiration
    (reference activity.go:80-102; xxhash becomes blake2b here)."""
    import json
    payload = json.dumps(write_request, sort_keys=True).encode()
    digest = hashlib.blake2b(payload + workflow_id.encode(),
                             digest_size=8).hexdigest()
    from ...spicedb.types import ObjectRef, SubjectRef
    return Relationship(
        resource=ObjectRef("workflow", workflow_id),
        relation="idempotency_key",
        subject=SubjectRef("activity", digest),
        expires_at=time.time() + IDEMPOTENCY_KEY_EXPIRATION,
    )
