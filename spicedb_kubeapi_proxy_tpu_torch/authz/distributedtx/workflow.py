"""Dual-write workflows (reference pkg/authz/distributedtx/workflow.go;
this package's reference authz/distributedtx/workflow.py:36-254).

Pessimistic: acquire a lock relationship (hash of path+name+verb) together
with the SpiceDB writes and preconditions, then write to kube with bounded
retries; on failure roll back with inverted operations; always remove the
lock.  SpiceDB write failures surface as kube 409 Conflict.

Optimistic: SpiceDB write -> kube write; on a kube activity failure, probe
object existence and roll back iff the object is absent.

deleteByFilter reads matching relationships first so retries delete a
deterministic set (workflow.go:353-388).
"""

from __future__ import annotations

import hashlib
import json
from typing import Optional

from .engine import ActivityError, DEFAULT_WORKFLOW_TIMEOUT, WorkflowContext

LOCK_RESOURCE_TYPE = "lock"
LOCK_RELATION_NAME = "workflow"
WORKFLOW_RESOURCE_TYPE = "workflow"
MAX_KUBE_ATTEMPTS = 5
STRATEGY_OPTIMISTIC = "Optimistic"
STRATEGY_PESSIMISTIC = "Pessimistic"

__all__ = ["DEFAULT_WORKFLOW_TIMEOUT"]

KUBE_BACKOFF_BASE = 0.1
KUBE_BACKOFF_FACTOR = 2.0


def _invert(update: dict) -> dict:
    op = update["op"]
    inverted = "delete" if op in ("create", "touch") else "touch"
    return {"op": inverted, "rel": update["rel"]}


async def _cleanup(ctx: WorkflowContext, rollback_updates: list,
                   reason: str) -> None:
    """Inverted-op rollback, retried until success (workflow.go:86-129).
    Like the reference, this loops until the write lands (the journal keeps
    the instance durable across crashes; the client's 30s result timeout
    does not stop the workflow) and bails only on unrecoverable
    invalid-argument errors."""
    if reason.startswith("rollback"):
        # note the outcome for the engine's dual-write audit event (the
        # post-success lock cleanup is not a rollback and is not noted)
        notes = getattr(ctx, "notes", None)
        if notes is not None:
            notes.setdefault("rollbacks", []).append(reason)
    updates = [_invert(u) for u in rollback_updates]
    while True:
        try:
            await ctx.execute_activity(
                "write_to_spicedb", {"updates": updates, "preconditions": []},
                ctx.instance_id)
            return
        except ActivityError as e:
            if "invalid" in str(e).lower():
                return  # unrecoverable, matches codes.InvalidArgument bail
            await ctx.sleep(0.05)


def resource_lock_rel(input: dict) -> dict:
    """lock:{hash(path/name/verb)}#workflow@workflow:{id}
    (workflow.go:392-418; xxhash becomes blake2b)."""
    name = input.get("request_name", "")
    if input.get("object_name"):
        name = input["object_name"]
    lock_key = f"{input.get('request_path', '')}/{name}/{input.get('verb', '')}"
    lock_hash = hashlib.blake2b(lock_key.encode(), digest_size=8).hexdigest()
    return {
        "op": "create",
        "rel": (f"{LOCK_RESOURCE_TYPE}:{lock_hash}#{LOCK_RELATION_NAME}"
                f"@{WORKFLOW_RESOURCE_TYPE}:{{workflow_id}}"),
        "lock_hash": lock_hash,
    }


def _lock_update(input: dict, workflow_id: str) -> tuple:
    tmpl = resource_lock_rel(input)
    rel = tmpl["rel"].replace("{workflow_id}", workflow_id)
    precondition = {
        "op": "must_not_match",
        "filter": {
            "resource_type": LOCK_RESOURCE_TYPE,
            "resource_id": tmpl["lock_hash"],
            "relation": LOCK_RELATION_NAME,
            "subject": {"type": WORKFLOW_RESOURCE_TYPE, "id": "",
                        "relation": None},
        },
    }
    return {"op": "create", "rel": rel}, precondition


def _collect_updates(input: dict) -> list:
    updates = []
    for r in input.get("creates", []):
        updates.append({"op": "create", "rel": r})
    for r in input.get("touches", []):
        updates.append({"op": "touch", "rel": r})
    for r in input.get("deletes", []):
        updates.append({"op": "delete", "rel": r})
    return updates


async def _append_deletes_from_filters(ctx: WorkflowContext, input: dict,
                                       updates: list) -> None:
    """Read-then-delete for deterministic retry (workflow.go:353-388)."""
    for f in input.get("delete_by_filter", []):
        rels = await ctx.execute_activity("read_relationships", f)
        for rel_string in rels:
            updates.append({"op": "delete", "rel": rel_string})


def kube_conflict(error: str, input: dict) -> dict:
    """SpiceDB failure -> kube 409 Conflict (workflow.go:422-450)."""
    status = {
        "kind": "Status", "apiVersion": "v1", "metadata": {},
        "status": "Failure",
        "message": (f"Operation cannot be fulfilled on"
                    f" {input.get('resource', '')} \"{input.get('object_name', '')}\":"
                    f" {error}"),
        "reason": "Conflict",
        "details": {"group": input.get('api_group', ''),
                    "kind": input.get('resource', ''),
                    "name": input.get('object_name', '')},
        "code": 409,
    }
    return {"status_code": 409, "content_type": "application/json",
            "body": json.dumps(status)}


def _kube_req(input: dict) -> dict:
    return {
        "verb": input.get("verb", ""),
        "request_uri": input.get("request_uri", ""),
        "headers": input.get("headers", {}),
        "body": input.get("body", ""),
    }


def _is_successful_kube_operation(input: dict, out: dict) -> Optional[bool]:
    """None => unsupported verb (workflow.go:249-276)."""
    verb = input.get("verb", "")
    code = out.get("status_code", 0)
    if verb == "delete":
        return code in (404, 200)
    if verb in ("create", "update", "patch"):
        return code in (409, 201, 200)
    return None


async def pessimistic_write(ctx: WorkflowContext, input: dict) -> dict:
    """workflow.go:134-247."""
    if not input.get("user_name"):
        raise ValueError("missing user info in CreateObjectInput")

    lock_rel, lock_precondition = _lock_update(input, ctx.instance_id)
    rollback = [lock_rel]

    preconditions = [lock_precondition] + list(input.get("preconditions", []))
    updates = _collect_updates(input)
    await _append_deletes_from_filters(ctx, input, updates)

    try:
        await ctx.execute_activity(
            "write_to_spicedb",
            {"updates": updates + [lock_rel], "preconditions": preconditions},
            ctx.instance_id)
    except ActivityError as e:
        await _cleanup(ctx, rollback + updates, "rollback due to failed SpiceDB write")
        return kube_conflict(str(e), input)

    backoff = KUBE_BACKOFF_BASE
    for attempt in range(MAX_KUBE_ATTEMPTS + 1):
        try:
            out = await ctx.execute_activity("write_to_kube", _kube_req(input))
        except ActivityError:
            await ctx.sleep(backoff)
            backoff *= KUBE_BACKOFF_FACTOR
            continue

        # kube throttling: honor RetryAfterSeconds (workflow.go:225-229)
        retry_after = out.get("retry_after_seconds") or 0
        if retry_after > 0:
            await ctx.sleep(min(float(retry_after), 5.0))
            continue

        ok = _is_successful_kube_operation(input, out)
        if ok is None:
            await _cleanup(ctx, rollback + updates,
                           "rollback due to unsupported kube verb")
            raise ValueError(f"unsupported kube verb: {input.get('verb')}")
        if ok:
            await _cleanup(ctx, rollback,
                           "cleanup after successful kube operation")
            return out
        await _cleanup(ctx, rollback + updates,
                       "rollback due to unsuccessful kube operation")
        return out

    await _cleanup(ctx, rollback + updates,
                   "rollback due to failed kube operation after max attempts")
    raise RuntimeError(
        f"failed to communicate with kubernetes after {MAX_KUBE_ATTEMPTS} attempts")


async def optimistic_write(ctx: WorkflowContext, input: dict) -> dict:
    """workflow.go:279-351."""
    if not input.get("user_name"):
        raise ValueError("missing user info in CreateObjectInput")

    updates = _collect_updates(input)
    await _append_deletes_from_filters(ctx, input, updates)

    try:
        await ctx.execute_activity(
            "write_to_spicedb",
            {"updates": updates,
             "preconditions": list(input.get("preconditions", []))},
            ctx.instance_id)
    except ActivityError as e:
        await _cleanup(ctx, updates, "rollback due to failed SpiceDB write")
        return kube_conflict(str(e), input)

    try:
        out = await ctx.execute_activity("write_to_kube", _kube_req(input))
    except ActivityError:
        # the activity may have failed after the kube write landed: probe
        exists = await ctx.execute_activity(
            "check_kube_resource", input.get("probe_uri", ""))
        if not exists:
            await _cleanup(ctx, updates, "rollback due to failed Kube write")
        # when the object exists the state has converged, but like the
        # reference (workflow.go:334-350 returns a nil response) the client
        # still sees an error and must re-inspect
        raise
    return out


WORKFLOWS = {
    STRATEGY_PESSIMISTIC: pessimistic_write,
    STRATEGY_OPTIMISTIC: optimistic_write,
}


def workflow_for_lock_mode(lock_mode: str) -> str:
    return (STRATEGY_OPTIMISTIC if lock_mode == STRATEGY_OPTIMISTIC
            else STRATEGY_PESSIMISTIC)
