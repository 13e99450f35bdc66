"""Bulk permission-check runner (reference pkg/authz/check.go).

All Check/PostCheck templates across the matched rules resolve to
relationships and are checked concurrently per-expression; each expression's
relationships go through one CheckBulkPermissions call and every item must
be HAS_PERMISSION.
"""

from __future__ import annotations

from typing import Optional

from ..rules.engine import ResolveInput
from ..spicedb.endpoints import PermissionsEndpoint
from ..spicedb.types import CheckRequest, ObjectRef, SubjectRef


class UnauthorizedError(Exception):
    """A failed bulk check; carries the failing relationship and the rule
    that generated it so the audit event (and an explain witness) can
    name the exact check that denied the request."""

    def __init__(self, message: str, rel=None, rule: str = "",
                 check_type: str = "", source: str = ""):
        super().__init__(message)
        self.rel = rel            # resolved relationship (rel_string-able)
        self.rule = rule          # ProxyRule name the template came from
        self.check_type = check_type
        self.source = source      # evaluator that denied (kernel|oracle|cache)


def check_request_from_rel(rel) -> CheckRequest:
    return CheckRequest(
        resource=ObjectRef(rel.resource_type, rel.resource_id),
        permission=rel.resource_relation,
        subject=SubjectRef(rel.subject_type, rel.subject_id,
                           rel.subject_relation),
    )


async def check_relationships(endpoint: PermissionsEndpoint, resolved_rels: list,
                              check_type: str,
                              rules_of: Optional[list] = None) -> list:
    """One bulk check; all must pass (reference check.go:18-72); returns
    the CheckResult list so callers can attribute decision sources.
    `rules_of` (parallel to `resolved_rels`) attributes each rel to the
    ProxyRule that generated it for the UnauthorizedError."""
    if not resolved_rels:
        return []
    reqs = [check_request_from_rel(rel) for rel in resolved_rels]
    results = await endpoint.check_bulk_permissions(reqs)
    for i, (rel, result) in enumerate(zip(resolved_rels, results)):
        if not result.allowed:
            raise UnauthorizedError(
                f"bulk {check_type} failed for {rel.rel_string()}",
                rel=rel, rule=rules_of[i] if rules_of else "",
                check_type=check_type,
                source=getattr(result, "source", ""))
    return results


def decision_source_of(results: list) -> str:
    """Collapse per-check sources into one audit label: the common
    source, `mixed` when checks disagree, "" when nothing attributes."""
    sources = {getattr(r, "source", "") for r in results} - {""}
    if not sources:
        return ""
    return sources.pop() if len(sources) == 1 else "mixed"


async def _run_exprs(endpoint: PermissionsEndpoint, rules_list: list,
                     input: ResolveInput, attr: str, check_type: str) -> list:
    # All templates across all matched rules resolve first, then fold into
    # ONE CheckBulkPermissions call for the whole request (reference
    # check.go:23-48 collects every checkRel before the single bulk RPC).
    resolved: list = []
    rules_of: list = []
    for r in rules_list:
        rule_name = getattr(r, "name", "")
        for expr in getattr(r, attr):
            for rel in expr.generate_relationships(input):
                resolved.append(rel)
                rules_of.append(rule_name)
    return await check_relationships(endpoint, resolved, check_type,
                                     rules_of=rules_of)


async def run_all_matching_checks(endpoint: PermissionsEndpoint,
                                  matching_rules: list,
                                  input: ResolveInput) -> list:
    return await _run_exprs(endpoint, matching_rules, input, "checks",
                            "check")


async def run_all_matching_post_checks(endpoint: PermissionsEndpoint,
                                       matching_rules: list,
                                       input: ResolveInput) -> list:
    return await _run_exprs(endpoint, matching_rules, input, "post_checks",
                            "postcheck")
