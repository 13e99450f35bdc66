"""PreFilter LookupResources (reference pkg/authz/lookups.go; this
package's reference authz/lookups.py, without its decision-cache route).

Resolves the single LR template, streams allowed resource ids from the
endpoint, and maps each id to a NamespacedName via the rule's
fromObjectIDName/Namespace expressions.  The namespace expression is first
queried against `{"resourceId": id}`; a null result falls back to the full
request input (reference lookups.go:108-127).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..config.proxyrule import MATCHING_ID_FIELD_VALUE
from ..rules import blang
from ..rules.engine import ResolveInput, ResolvedPreFilter, _to_template_data
from ..spicedb.endpoints import PermissionsEndpoint
from ..spicedb.types import SubjectRef


class PreFilterError(Exception):
    pass


@dataclass
class PrefilterResult:
    """The allowed NamespacedName set (reference lookups.go:19-36)."""
    all_allowed: bool = False
    allowed: set = field(default_factory=set)  # {(namespace, name)}
    error: Optional[Exception] = None
    # evaluator that produced the frontier (kernel|oracle; "" when the
    # endpoint chain doesn't attribute) — audit decision_source
    source: str = ""

    def is_allowed(self, namespace: str, name: str) -> bool:
        if self.all_allowed:
            return True
        return (namespace, name) in self.allowed


# an id's (namespace or None, name), memoized on the rule's name
# expression and keyed by (namespace expression, resource id, subject id):
# both expressions are pure functions of the id, and a list or watch asks
# for the names of every id each of its users may see, the same ids again
# and again across users.  Cleared when full.
_ID_NAMES_ATTR = "_id_names_memo"
_ID_NAMES_CAP = 1 << 18


def _id_names(filter: ResolvedPreFilter, resource_id: str,
              subject_id: str) -> tuple:
    """(namespace, name) from the id alone; namespace None when the
    namespace expression gives nothing for the id."""
    name_exec = filter.name_from_object_id
    memo = name_exec.__dict__.get(_ID_NAMES_ATTR)
    if memo is None:
        memo = name_exec.__dict__.setdefault(_ID_NAMES_ATTR, {})
    key = (filter.namespace_from_object_id, resource_id, subject_id)
    hit = memo.get(key)
    if hit is not None:
        return hit
    data = {"resourceId": resource_id, "subjectId": subject_id}
    try:
        name = name_exec.query(data)
    except blang.BlangError as e:
        raise PreFilterError(f"error querying name from object ID: {e}") from e
    if not isinstance(name, str) or not name:
        raise PreFilterError(
            f"unable to determine name for resource {resource_id!r}")
    try:
        namespace = filter.namespace_from_object_id.query(data)
    except blang.BlangError as e:
        raise PreFilterError(f"error querying namespace from object ID: {e}") from e
    if namespace is not None and not isinstance(namespace, str):
        raise PreFilterError(
            f"namespace expression returned {type(namespace).__name__}")
    if len(memo) >= _ID_NAMES_CAP:
        memo.clear()
    memo[key] = hit = (namespace, name)
    return hit


def _input_namespace(filter: ResolvedPreFilter, input: ResolveInput) -> str:
    """The namespace from the request input, for rules whose namespace
    comes from the request rather than the object id."""
    try:
        namespace = filter.namespace_from_object_id.query(
            _to_template_data(input))
    except blang.BlangError as e:
        raise PreFilterError(
            f"error querying namespace from input: {e}") from e
    if namespace is None:
        return ""
    if not isinstance(namespace, str):
        raise PreFilterError(
            f"namespace expression returned {type(namespace).__name__}")
    return namespace


def extract_namespaced_name(filter: ResolvedPreFilter, input: ResolveInput,
                            resource_id: str,
                            subject_id: str = "") -> tuple:
    """Map an object id to (namespace, name) via the filter expressions.
    The namespace expression is first queried against the id; a null
    result falls back to the full request input (reference
    lookups.go:108-127)."""
    namespace, name = _id_names(filter, resource_id, subject_id)
    if namespace is None:
        namespace = _input_namespace(filter, input)
    return namespace, name


async def run_lookup_resources(endpoint: PermissionsEndpoint,
                               filter: ResolvedPreFilter,
                               input: ResolveInput) -> PrefilterResult:
    """LR + per-result extraction (reference lookups.go:43-136).

    Drains the endpoint's id stream incrementally so NamespacedName
    extraction overlaps the remaining transfer (reference drains the gRPC
    server-stream the same way, lookups.go:74-135)."""
    if filter.rel.resource_id != MATCHING_ID_FIELD_VALUE:
        raise PreFilterError("preFilter called with non-$ resource ID")
    result = PrefilterResult()
    subject = SubjectRef(filter.rel.subject_type, filter.rel.subject_id,
                         filter.rel.subject_relation)
    allowed = result.allowed
    from_input = None     # the request's namespace, queried once
    async for rid in endpoint.lookup_resources_stream(
            filter.rel.resource_type,
            filter.rel.resource_relation,
            subject):
        namespace, name = _id_names(filter, rid, "")
        if namespace is None:
            if from_input is None:
                from_input = _input_namespace(filter, input)
            namespace = from_input
        allowed.add((namespace, name))
    return result
