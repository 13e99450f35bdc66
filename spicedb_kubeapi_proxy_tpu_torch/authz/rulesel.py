"""Rule-selection invariants (reference pkg/authz/rules.go): at most one
update rule and at most one prefilter rule may match a request."""

from __future__ import annotations


class MultipleRulesError(Exception):
    pass


def single_update_rule(matching_rules: list):
    with_updates = [r for r in matching_rules if r.update is not None]
    if not with_updates:
        return None
    if len(with_updates) > 1:
        raise MultipleRulesError(
            f"multiple write rules matched: {[r.name for r in with_updates]}")
    return with_updates[0]


def single_pre_filter_rule(matching_rules: list):
    with_pre = [r for r in matching_rules if r.pre_filter]
    if not with_pre:
        return None
    if len(with_pre) > 1:
        raise MultipleRulesError(
            f"multiple pre-filter rules matched: {[r.name for r in with_pre]}")
    return with_pre[0]

