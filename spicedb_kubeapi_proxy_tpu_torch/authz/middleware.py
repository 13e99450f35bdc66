"""Authorization middleware (reference pkg/authz/authz.go WithAuthorization;
this package's reference authz/middleware.py).

Per-request orchestration: extract ResolveInput -> match rules -> CEL filter
-> run Checks (concurrent bulk) -> dispatch to the update workflow / watch
filter / prefilter+response-filter / post-check / post-filter path.  A
request whose matched rule carries an update (a dual write) runs the
dual-write workflow (authz/update.py) when the server wired a workflow
client (`ProxyServer.enable_dual_writes`), and gets the 500 Status
"update engine not configured" when it did not, as in the reference.

Every decision taken here emits a structured audit event (utils/audit.py):
stage names which gate decided (resolve/match/check/postcheck/update/watch),
and — with explain mode on — a denial carries the relation-path witness
(authz/explain.py) naming the check that excluded the caller.
"""

from __future__ import annotations

import time

from ..proxy.httpcore import Handler, Request, Response, json_response
from ..proxy.kube import RequestInfo
from ..proxy.restmapper import CachingRESTMapper
from ..rules.engine import (
    ResolveError,
    filter_rules_with_cel_conditions,
    resolve_input_from_request)
from ..utils import admission
from ..utils.admission import AdmissionRejectedError
from ..utils.audit import (
    AuditEvent,
    AuditSink,
    NULL_SINK,
    OUTCOME_ALLOWED,
    OUTCOME_ALWAYS_ALLOW,
    OUTCOME_DENIED,
    OUTCOME_ERROR,
)
from ..utils.tracing import span
from ..spicedb.endpoints import PermissionsEndpoint
from .check import (
    UnauthorizedError,
    decision_source_of,
    run_all_matching_checks,
    run_all_matching_post_checks,
)
from .postfilter import filter_list_response
from .responsefilterer import (
    EmptyResponseFilterer,
    StandardResponseFilterer,
    WatchResponseFilterer,
)
from .rulesel import MultipleRulesError, single_pre_filter_rule, single_update_rule

UPDATE_VERBS = ("create", "update", "patch", "delete")

FILTERER_KEY = "response_filterer"
AUDIT_KEY = "audit_sink"
EXPLAIN_KEY = "audit_explain"


def forbidden_response(message: str) -> Response:
    return json_response(403, {
        "kind": "Status", "apiVersion": "v1", "metadata": {},
        "status": "Failure", "message": message, "reason": "Forbidden",
        "code": 403,
    })


def always_allow(info: RequestInfo) -> bool:
    """Unfiltered access to api metadata (reference authz.go:207-210)."""
    return info.path in ("/api", "/apis", "/openapi/v2") and info.verb == "get"


def should_run_post_checks(verb: str) -> bool:
    return verb == "get"


def should_run_post_filters(verb: str, rules_list: list) -> bool:
    return verb == "list" and any(r.post_filter for r in rules_list)


def audit_event_for(req: Request, stage: str, decision: str,
                    **overrides) -> AuditEvent:
    """Build an AuditEvent from the request context: identity, verb/GVR,
    matched rules, and the active trace id/latency come for free so
    decision sites only add stage/decision and payload fields."""
    from ..utils import tracing

    ev = AuditEvent(stage=stage, decision=decision)
    user = req.context.get("user")
    if user is not None:
        ev.user = user.name
        ev.groups = tuple(user.groups)
    info = req.context.get("request_info")
    if info is not None:
        ev.verb = info.verb
        ev.api_group = info.api_group
        ev.api_version = info.api_version
        ev.resource = info.resource
        ev.namespace = info.namespace
        if info.name:
            ev.names = (info.name,)
            ev.count = 1
    rules = req.context.get("matched_rules")
    if rules:
        ev.rule = ",".join(rules)
    ev.decision_source = req.context.get("decision_source", "")
    tr = tracing.current_trace()
    trace_id = getattr(tr, "trace_id", "")
    if trace_id:
        ev.trace_id = trace_id
        ev.latency_ms = (time.perf_counter() - tr.t0) * 1e3
        # hop provenance (fleet tracing): the tier path this request
        # walked to reach this node, so /debug/decisions on any node
        # names the full forwarding chain of a decision
        attrs = getattr(tr, "attrs", None)
        if isinstance(attrs, dict):
            ev.tier_path = str(attrs.get("tier_path") or "")
    sink: AuditSink = req.context.get(AUDIT_KEY) or NULL_SINK
    ev.backend = getattr(sink, "backend", "")
    for k, v in overrides.items():
        setattr(ev, k, v)
    return ev


def _emit(req: Request, stage: str, decision: str, **overrides) -> None:
    sink: AuditSink = req.context.get(AUDIT_KEY) or NULL_SINK
    if not sink.enabled:
        return
    sink.emit(audit_event_for(req, stage, decision, **overrides))


def explain_requested(req: Request) -> bool:
    """Explain mode: the sink-wide flag (--audit-explain) or a per-request
    `?explain=1` query parameter."""
    sink = req.context.get(AUDIT_KEY) or NULL_SINK
    if getattr(sink, "explain", False):
        return sink.enabled
    target = getattr(req, "target", "") or ""
    _, _, query = target.partition("?")
    return sink.enabled and any(
        p in ("explain=1", "explain=true") for p in query.split("&"))


async def _denial_witness(req: Request, endpoint, rel):
    """Relation-path witness for a failed check (None when explain is off
    or the backend cannot witness)."""
    if rel is None or not explain_requested(req):
        return None
    from .explain import witness_dict_for_rel

    return await witness_dict_for_rel(endpoint, rel)


def with_authorization(handler: Handler, failed: Handler,
                       rest_mapper: CachingRESTMapper,
                       endpoint: PermissionsEndpoint,
                       matcher_ref,  # callable returning the current matcher
                       input_extractor=None,
                       workflow_client=None,
                       audit: AuditSink = NULL_SINK) -> Handler:
    """Build the authorization handler (reference authz.go:23-197).

    `matcher_ref` is a zero-arg callable returning the active MapMatcher so
    tests can swap rule sets at runtime (the reference exposes *Matcher)."""

    async def authorized(req: Request) -> Response:
        info: RequestInfo = req.context["request_info"]
        if info.verb in UPDATE_VERBS:
            # dual-writes are never shed: their authorization checks and
            # the workflow they feed bypass the dispatcher queue bounds
            # (utils/admission.py) — rejecting a write mid-two-phase
            # commit is strictly worse than running it slowly.  The
            # contextvar rides the request context across executor hops.
            with admission.exempt():
                return await _authorized(req)
        return await _authorized(req)

    async def _authorized(req: Request) -> Response:
        info: RequestInfo = req.context["request_info"]
        user = req.context["user"]
        # structured request logging (reference requestlogger.go +
        # rules.go:242-279): the logging middleware reads these back out
        # of the request context after the chain completes.  The outcome
        # vocabulary is the shared enum in utils/audit.py so metrics,
        # traces, and audit events join by trace id.
        req.context["authz_outcome"] = OUTCOME_DENIED
        req.context[AUDIT_KEY] = audit
        try:
            with span("resolve", phase=True):
                if input_extractor is not None:
                    input = input_extractor(req, info, user)
                else:
                    input = resolve_input_from_request(
                        info, user, req.body, req.headers.to_dict())
        except ResolveError as e:
            _emit(req, "resolve", OUTCOME_DENIED, message=str(e))
            return forbidden_response(str(e))
        req.context["resolve_input"] = input

        if always_allow(info):
            req.context["authz_outcome"] = OUTCOME_ALWAYS_ALLOW
            req.context[FILTERER_KEY] = EmptyResponseFilterer()
            _emit(req, "match", OUTCOME_ALWAYS_ALLOW)
            return await handler(req)

        # rule matching + CEL condition filtering are one attribution
        # phase: both walk the matched rule set against the request (and
        # one serving stage, which the fleet's tail report ranks)
        from ..utils import timeline
        with span("match", phase=True) as match_attrs, \
                timeline.serving_span("rule_match"):
            matching_rules = matcher_ref().match(info)
            filtered_rules: list = []
            cel_failed = False
            if matching_rules:
                try:
                    filtered_rules = filter_rules_with_cel_conditions(
                        matching_rules, input)
                except ResolveError:
                    cel_failed = True
            match_attrs["rules"] = len(filtered_rules)
        if cel_failed or not filtered_rules:
            _emit(req, "match", OUTCOME_DENIED,
                  message=("CEL condition resolution failed" if cel_failed
                           else "no rule matched"))
            return await failed(req)
        req.context["matched_rules"] = [r.name for r in filtered_rules]

        try:
            # informational wrapper: the dispatch layer records the
            # queue_wait/execute phase spans for the bulk check itself
            with span("check"):
                check_results = await run_all_matching_checks(
                    endpoint, filtered_rules, input)
            # which evaluator decided (cache|kernel|oracle|mixed): stashed
            # so every later event built for this request carries it
            req.context["decision_source"] = decision_source_of(
                check_results)
        except UnauthorizedError as e:
            req.context["decision_source"] = e.source
            _emit(req, "check", OUTCOME_DENIED,
                  rule=e.rule or ",".join(r.name for r in filtered_rules),
                  rel=e.rel.rel_string() if e.rel is not None else "",
                  message=str(e),
                  explain=await _denial_witness(req, endpoint, e.rel))
            return await failed(req)
        except ResolveError as e:
            _emit(req, "check", OUTCOME_ERROR, message=str(e))
            return await failed(req)

        try:
            update_rule = single_update_rule(filtered_rules)
        except MultipleRulesError as e:
            _emit(req, "match", OUTCOME_DENIED, message=str(e))
            return await failed(req)

        if update_rule is not None:
            if info.verb not in UPDATE_VERBS:
                _emit(req, "update", OUTCOME_DENIED,
                      rule=update_rule.name,
                      message=f"update rule on non-update verb {info.verb}")
                return await failed(req)
            if workflow_client is None:
                return json_response(500, {
                    "kind": "Status", "apiVersion": "v1",
                    "status": "Failure", "code": 500,
                    "message": "update engine not configured"})
            from .update import perform_update
            try:
                req.context["authz_outcome"] = OUTCOME_ALLOWED
                _emit(req, "update", OUTCOME_ALLOWED, rule=update_rule.name)
                with span("workflow", phase=True):
                    return await perform_update(update_rule, input, req,
                                                workflow_client)
            except Exception as e:
                req.context["authz_outcome"] = OUTCOME_ERROR
                _emit(req, "update", OUTCOME_ERROR, rule=update_rule.name,
                      message=str(e))
                return forbidden_response(f"failed to perform update: {e}")

        if info.verb == "watch":
            try:
                watch_rule = single_pre_filter_rule(filtered_rules)
            except MultipleRulesError as e:
                _emit(req, "match", OUTCOME_DENIED, message=str(e))
                return await failed(req)
            if watch_rule is None:
                _emit(req, "watch", OUTCOME_DENIED,
                      message="no pre-filter rule for watch")
                return await failed(req)
            filterer = WatchResponseFilterer(rest_mapper, input, watch_rule,
                                             endpoint, audit=audit)
            try:
                filterer.run_watcher()
            except Exception as e:
                _emit(req, "watch", OUTCOME_ERROR, rule=watch_rule.name,
                      message=str(e))
                return await failed(req)
            req.context[FILTERER_KEY] = filterer
            req.context["authz_outcome"] = OUTCOME_ALLOWED
            _emit(req, "watch", OUTCOME_ALLOWED, rule=watch_rule.name)
            return await handler(req)

        filterer = StandardResponseFilterer(rest_mapper, input,
                                            filtered_rules, endpoint)
        req.context[FILTERER_KEY] = filterer
        try:
            filterer.run_pre_filters()
        except AdmissionRejectedError:
            raise  # surfaces as 429 + Retry-After, not a 403 denial
        except Exception as e:
            _emit(req, "check", OUTCOME_ERROR, message=str(e))
            return await failed(req)

        if should_run_post_checks(info.verb):
            resp = await handler(req)
            if 200 <= resp.status < 300:
                try:
                    with span("postcheck"):
                        post_results = await run_all_matching_post_checks(
                            endpoint, filtered_rules, input)
                    src = decision_source_of(post_results)
                    if src:
                        req.context["decision_source"] = src
                except UnauthorizedError as e:
                    req.context["decision_source"] = e.source
                    _emit(req, "postcheck", OUTCOME_DENIED,
                          rule=e.rule,
                          rel=(e.rel.rel_string() if e.rel is not None
                               else ""),
                          message=str(e),
                          explain=await _denial_witness(req, endpoint,
                                                        e.rel))
                    return await failed(req)
                except ResolveError as e:
                    _emit(req, "postcheck", OUTCOME_ERROR, message=str(e))
                    return await failed(req)
            req.context["authz_outcome"] = OUTCOME_ALLOWED
            _emit(req, "check", OUTCOME_ALLOWED)
            return resp
        if should_run_post_filters(info.verb, filtered_rules):
            resp = await handler(req)
            if 200 <= resp.status < 300 and info.verb == "list":
                try:
                    with span("postfilter"):
                        body = await filter_list_response(
                            resp.body, filtered_rules, input, endpoint)
                except AdmissionRejectedError:
                    raise  # 429 + Retry-After, not a 403 denial
                except Exception as e:
                    _emit(req, "postfilter", OUTCOME_ERROR, message=str(e))
                    return await failed(req)
                resp.body = body
                resp.headers.set("Content-Type", "application/json")
                resp.headers.set("Content-Length", str(len(body)))
            req.context["authz_outcome"] = OUTCOME_ALLOWED
            _emit(req, "postfilter", OUTCOME_ALLOWED)
            return resp
        req.context["authz_outcome"] = OUTCOME_ALLOWED
        _emit(req, "check", OUTCOME_ALLOWED)
        return await handler(req)

    return authorized
