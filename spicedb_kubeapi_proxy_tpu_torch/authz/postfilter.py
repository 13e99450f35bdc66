"""PostFilter: per-item bulk checks on list responses
(reference pkg/authz/postfilter.go).

Each returned item resolves every PostFilter CheckPermissionTemplate against
an item-scoped input; one CheckBulkPermissions covers all items, and an item
is kept only if all of its checks pass.  Items whose templates fail to
resolve keep going (the check is skipped), matching the reference's
tolerance (postfilter.go:90-96).
"""

from __future__ import annotations

import json

from ..rules.engine import ResolveInput, new_resolve_input, resolve_rel
from ..spicedb.endpoints import PermissionsEndpoint
from .check import check_request_from_rel


async def filter_list_response(body: bytes, filtered_rules: list,
                               input: ResolveInput,
                               endpoint: PermissionsEndpoint) -> bytes:
    """Returns the filtered body (reference postfilter.go:17-55)."""
    try:
        decoded = json.loads(body)
    except ValueError as e:
        raise ValueError(f"failed to parse list response: {e}") from e
    items = decoded.get("items")
    if not isinstance(items, list) or not items:
        return body

    bulk_reqs = []
    item_to_requests: dict[int, list] = {}
    for idx, item in enumerate(items):
        if not isinstance(item, dict):
            continue
        meta = item.get("metadata") or {}
        obj = {"metadata": {"name": meta.get("name", ""),
                            "namespace": meta.get("namespace", "")}}
        item_input = new_resolve_input(input.request, input.user, obj, b"", {})
        for r in filtered_rules:
            for f in r.post_filter:
                try:
                    rel = resolve_rel(f.rel, item_input)
                except Exception:
                    continue  # skip this check, don't fail the operation
                item_to_requests.setdefault(idx, []).append(len(bulk_reqs))
                bulk_reqs.append(check_request_from_rel(rel))

    if not bulk_reqs:
        return body

    results = await endpoint.check_bulk_permissions(bulk_reqs)
    allowed_items = []
    for idx, item in enumerate(items):
        indices = item_to_requests.get(idx)
        if indices is None:
            allowed_items.append(item)
            continue
        if all(results[i].allowed for i in indices):
            allowed_items.append(item)
    decoded["items"] = allowed_items
    return json.dumps(decoded).encode()
