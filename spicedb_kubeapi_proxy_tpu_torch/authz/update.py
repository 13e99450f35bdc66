"""Update glue (reference pkg/authz/update.go; this package's reference
authz/update.py:17-143): resolve the update rule's
creates/touches/deletes/preconditions/deleteByFilter templates (including
`$`-wildcard filter fields), launch the dual-write workflow, wait for the
result (≤30s), and write the kube-style response."""

from __future__ import annotations

import uuid

from ..proxy.httpcore import Request, Response
from ..rules.engine import ResolveInput, RunnableRule
from .distributedtx.workflow import (
    DEFAULT_WORKFLOW_TIMEOUT,
    workflow_for_lock_mode,
)


class UpdateError(Exception):
    pass


_DOLLAR_FIELDS = (
    ("resource_type", "$resourceType"),
    ("resource_id", "$resourceID"),
    ("resource_relation", "$resourceRelation"),
    ("subject_type", "$subjectType"),
    ("subject_id", "$subjectID"),
    ("subject_relation", "$subjectRelation"),
)


def filter_from_rel(rel) -> dict:
    """Resolved rel -> relationship filter dict; `$<field>` wildcards leave
    the field unset, any other `$` use is an error (update.go:197-271)."""
    for attr, allowed in _DOLLAR_FIELDS:
        value = getattr(rel, attr)
        if "$" in value and value != allowed:
            raise UpdateError(
                f"invalid use of '$' in {attr} field '{value}':"
                f" only '{allowed}' is allowed")
    f: dict = {"resource_type": "", "resource_id": "", "relation": ""}
    if rel.resource_type != "$resourceType":
        f["resource_type"] = rel.resource_type
    if rel.resource_id != "$resourceID":
        f["resource_id"] = rel.resource_id
    if rel.resource_relation != "$resourceRelation":
        f["relation"] = rel.resource_relation
    subject_type = "" if rel.subject_type == "$subjectType" else rel.subject_type
    subject_id = "" if rel.subject_id == "$subjectID" else rel.subject_id
    subject_rel = ("" if rel.subject_relation == "$subjectRelation"
                   else rel.subject_relation)
    if subject_type or subject_id or subject_rel:
        f["subject"] = {"type": subject_type, "id": subject_id,
                        "relation": subject_rel or None}
    if not any([f["resource_type"], f["resource_id"], f["relation"],
                f.get("subject")]):
        raise UpdateError("invalid relationship filter: no fields set")
    return f


def _rel_strings(exprs: list, input: ResolveInput) -> list:
    from ..spicedb.types import parse_relationship
    out = []
    for expr in exprs:
        for rel in expr.generate_relationships(input):
            s = rel.rel_string()
            try:
                # invalid relationships (empty/templated fields) are rejected
                # before the workflow launches (reference update.go:41-44)
                parse_relationship(s)
            except ValueError as e:
                raise UpdateError(f"invalid relationship `{s}`: {e}") from e
            out.append(s)
    return out


def build_write_input(rule: RunnableRule, input: ResolveInput,
                      request_uri: str) -> dict:
    """WriteObjInput equivalent (workflow.go:41-74), JSON-serializable."""
    u = rule.update
    preconditions = []
    for expr in u.must_exist:
        for rel in expr.generate_relationships(input):
            preconditions.append({"op": "must_match",
                                  "filter": filter_from_rel(rel)})
    for expr in u.must_not_exist:
        for rel in expr.generate_relationships(input):
            preconditions.append({"op": "must_not_match",
                                  "filter": filter_from_rel(rel)})
    delete_by_filter = []
    for expr in u.deletes_by_filter:
        for rel in expr.generate_relationships(input):
            delete_by_filter.append(filter_from_rel(rel))

    req = input.request
    probe_uri = req.path
    if input.name and not req.name:
        probe_uri = f"{req.path}/{input.name}"
    # the originating trace id rides the (journaled) workflow input so
    # the dual-write audit event still correlates when the instance is
    # replayed at crash recovery, outside any live request context
    from ..utils import tracing
    trace_id = getattr(tracing.current_trace(), "trace_id", "")
    return {
        "verb": req.verb,
        "trace_id": trace_id,
        "request_uri": request_uri,
        "request_path": req.path,
        "request_name": req.name,
        "api_group": req.api_group,
        "resource": req.resource,
        "headers": {k: list(v) for k, v in input.headers.items()},
        "user_name": input.user.name if input.user else "",
        "object_name": input.name,
        "body": input.body.decode("utf-8", errors="replace"),
        "probe_uri": probe_uri,
        "creates": _rel_strings(u.creates, input),
        "touches": _rel_strings(u.touches, input),
        "deletes": _rel_strings(u.deletes, input),
        "preconditions": preconditions,
        "delete_by_filter": delete_by_filter,
    }


async def perform_update(rule: RunnableRule, input: ResolveInput,
                         req: Request, workflow_client) -> Response:
    """Launch the dual-write workflow and await its response
    (update.go:53-144, 146-195)."""
    write_input = build_write_input(rule, input, req.target)
    lock_mode = rule.lock_mode or getattr(
        workflow_client, "default_lock_mode", "Pessimistic")
    workflow_name = workflow_for_lock_mode(lock_mode)
    instance_id = str(uuid.uuid4())
    workflow_client.create_instance(instance_id, workflow_name, write_input)
    result = await workflow_client.get_result(
        instance_id, timeout=DEFAULT_WORKFLOW_TIMEOUT)
    if not result or result.get("body") is None:
        raise UpdateError("empty response from dual write")
    resp = Response(status=result.get("status_code", 500),
                    body=(result.get("body") or "").encode())
    resp.headers.set("Content-Type",
                     result.get("content_type", "application/json"))
    return resp
