"""Rules compiler and runtime: templates -> RunnableRules, request matching.

Mirrors the behavior of the reference rules engine (pkg/rules/rules.go):
- `compile_rule` -> RunnableRule with precompiled template expressions and
  CEL conditions (reference rules.go:719-900)
- `MapMatcher` keyed on (verb, group, version, resource)
  (reference rules.go:78-117)
- `ResolveInput` extraction and normalization (reference rules.go:231-353)
- template field compilation with `{{ expr }}` detection and literal
  wrapping (reference rules.go:1008-1029), tupleSet expressions returning
  arrays of relationship strings (reference rules.go:148-201)
- `split_name` / `split_namespace` helper functions (reference env.go:13-58).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Optional

from ..config import proxyrule
from ..proxy.kube import RequestInfo, UserInfo
from . import blang, cel
from .relstring import ResolvedRel, UncompiledRelExpr, parse_rel_string


class RuleCompileError(ValueError):
    pass


class ResolveError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Expression environment
# ---------------------------------------------------------------------------

def _split_name(value: Any) -> Any:
    """`ns/name` -> `name`; passthrough when no separator (env.go:19-38)."""
    if not isinstance(value, str):
        raise blang.BlangEvalError("split_name expects a string argument")
    if "/" not in value:
        return value
    return value.split("/", 1)[1]


def _split_namespace(value: Any) -> Any:
    """`ns/name` -> `ns`; empty when no separator (env.go:40-58)."""
    if not isinstance(value, str):
        raise blang.BlangEvalError("split_namespace expects a string argument")
    if "/" not in value:
        return ""
    return value.split("/", 1)[0]


def default_environment() -> blang.Environment:
    env = blang.Environment()
    env.register_function("split_name", _split_name)
    env.register_function("split_namespace", _split_namespace)
    return env


_ENV = default_environment()


def compile_template_expression(expr: str) -> blang.Executor:
    """Compile a template field: `{{ expr }}` is an expression, anything else
    is a literal (reference rules.go:1008-1029, including the quirk that a
    half-delimited `{{foo` compiles as the literal with delimiters stripped).
    """
    expr = expr.strip()
    if expr == "":
        return _ENV.parse('""')
    has_prefix = expr.startswith("{{")
    if has_prefix:
        expr = expr[2:]
    has_suffix = expr.endswith("}}")
    if has_suffix:
        expr = expr[:-2]
    if not (has_prefix and has_suffix):
        if expr == "":
            return _ENV.parse('""')
        return _LiteralExecutor(expr)
    inner = expr.strip()
    if inner == "":
        return _ENV.parse('""')
    return _ENV.parse(inner)


def compile_tuple_set_expression(expr: str) -> blang.Executor:
    """tupleSet fields are always expressions; optional {{ }} wrapper is
    stripped (reference rules.go:1035-1051)."""
    expr = expr.strip()
    if expr == "":
        return _ENV.parse('""')
    if expr.startswith("{{") and expr.endswith("}}"):
        expr = expr[2:-2].strip()
        if expr == "":
            return _ENV.parse('""')
    return _ENV.parse(expr)


class _LiteralExecutor(blang.Executor):
    """An executor that returns a fixed string (literal template field)."""

    def __init__(self, value: str):
        self._value = value

    def query(self, data: Any) -> Any:
        return self._value


# ---------------------------------------------------------------------------
# ResolveInput
# ---------------------------------------------------------------------------

@dataclass
class ResolveInput:
    """The data fed into template expressions (reference rules.go:231-240)."""
    name: str = ""
    namespace: str = ""
    namespaced_name: str = ""
    request: Optional[RequestInfo] = None
    user: Optional[UserInfo] = None
    object: Optional[dict] = None  # partial object metadata: {"metadata": {...}}
    body: bytes = b""
    headers: dict = field(default_factory=dict)  # name -> list[str]

    def to_key_values(self) -> list:
        """Structured log fields (reference rules.go:242-279)."""
        out: list[Any] = [
            "name", self.name,
            "namespace", self.namespace,
            "namespacedName", self.namespaced_name,
            "object", self.object,
            "body", self.body,
        ]
        if self.request is not None:
            out += [
                "request.verb", self.request.verb,
                "request.resource", self.request.resource,
                "request.labelSelector", self.request.label_selector,
                "request.fieldSelector", self.request.field_selector,
                "request.path", self.request.path,
            ]
        if self.user is not None:
            out += [
                "user.name", self.user.name,
                "user.groups", self.user.groups,
                "user.extra", self.user.extra,
            ]
        for k, v in self.headers.items():
            out += [k, v]
        return out


def new_resolve_input(request: RequestInfo, user: UserInfo,
                      obj: Optional[dict] = None, body: bytes = b"",
                      headers: Optional[dict] = None) -> ResolveInput:
    """Normalized input construction (reference rules.go:315-353): name and
    namespace default from the object, fall back to the request; requests on
    the `namespaces` resource clear the namespace so they match other
    cluster-scoped objects."""
    name = ""
    namespace = ""
    if obj is not None:
        meta = obj.get("metadata") or {}
        name = meta.get("name") or ""
        namespace = meta.get("namespace") or ""
    if not name:
        name = request.name
    if not namespace:
        namespace = request.namespace
    if request.resource == "namespaces":
        namespace = ""
    namespaced_name = f"{namespace}/{name}" if namespace else name
    return ResolveInput(
        name=name,
        namespace=namespace,
        namespaced_name=namespaced_name,
        request=request,
        user=user,
        object=obj,
        body=body,
        headers=headers or {},
    )


def resolve_input_from_request(request: RequestInfo, user: UserInfo,
                               body: bytes, headers: dict) -> ResolveInput:
    """HTTP extraction (reference rules.go:281-312): create/update/patch
    bodies are parsed as kube objects and carried in the input."""
    obj: Optional[dict] = None
    parsed_body = b""
    if request.verb in ("create", "update", "patch"):
        parsed_body = body
        try:
            decoded = json.loads(body) if body else None
        except (ValueError, UnicodeDecodeError) as e:
            raise ResolveError(f"unable to decode request body as kube object: {e}") from e
        if not isinstance(decoded, dict):
            raise ResolveError("unable to decode request body as kube object")
        obj = {"metadata": decoded.get("metadata") or {}}
        obj["apiVersion"] = decoded.get("apiVersion", "")
        obj["kind"] = decoded.get("kind", "")
    return new_resolve_input(request, user, obj, parsed_body, headers)


def _to_template_data(inp: ResolveInput) -> dict:
    """Input conversion for template expressions (reference rules.go:524-617),
    including the `resourceId` alias and object/metadata body merge."""
    data: dict[str, Any] = {
        "name": inp.name,
        "namespace": inp.namespace,
        "namespacedName": inp.namespaced_name,
        "resourceId": inp.namespaced_name,
        "headers": {k: list(v) for k, v in inp.headers.items()},
    }
    if inp.request is not None:
        data["request"] = {
            "verb": inp.request.verb,
            "apiGroup": inp.request.api_group,
            "apiVersion": inp.request.api_version,
            "resource": inp.request.resource,
            "name": inp.request.name,
            "namespace": inp.request.namespace,
        }
    if inp.user is not None:
        data["user"] = {
            "name": inp.user.name,
            "uid": inp.user.uid,
            "groups": list(inp.user.groups),
            "extra": {k: list(v) for k, v in inp.user.extra.items()},
        }
    body_data: Optional[dict] = None
    if inp.body:
        try:
            parsed = json.loads(inp.body)
            if isinstance(parsed, dict):
                body_data = parsed
        except (ValueError, UnicodeDecodeError):
            body_data = None
    if body_data is not None:
        object_data = dict(body_data)
        if inp.object is not None and "metadata" in inp.object:
            object_data["metadata"] = inp.object["metadata"]
        data["object"] = object_data
        if "metadata" in object_data:
            data["metadata"] = object_data["metadata"]
    elif inp.object is not None:
        object_data = {"metadata": inp.object.get("metadata") or {}}
        data["object"] = object_data
        data["metadata"] = object_data["metadata"]
    if inp.body:
        data["body"] = inp.body.decode("utf-8", errors="replace")
    return data


def _to_cel_input(inp: ResolveInput) -> dict:
    """Input conversion for CEL conditions (reference rules.go:470-521)."""
    data: dict[str, Any] = {
        "name": inp.name,
        "resourceNamespace": inp.namespace,
        "namespacedName": inp.namespaced_name,
        "headers": {k: list(v) for k, v in inp.headers.items()},
    }
    if inp.body:
        data["body"] = inp.body
    if inp.request is not None:
        data["request"] = {
            "verb": inp.request.verb,
            "apiGroup": inp.request.api_group,
            "apiVersion": inp.request.api_version,
            "resource": inp.request.resource,
            "name": inp.request.name,
            "namespace": inp.request.namespace,
        }
    if inp.user is not None:
        data["user"] = {
            "name": inp.user.name,
            "uid": inp.user.uid,
            "groups": list(inp.user.groups),
            "extra": {k: list(v) for k, v in inp.user.extra.items()},
        }
    if inp.object is not None:
        data["object"] = inp.object
    return data


# ---------------------------------------------------------------------------
# Relationship expressions
# ---------------------------------------------------------------------------

@dataclass
class RelExpr:
    """A relationship template with compiled field expressions
    (reference rules.go:137-144)."""
    resource_type: blang.Executor
    resource_id: blang.Executor
    resource_relation: blang.Executor
    subject_type: blang.Executor
    subject_id: blang.Executor
    subject_relation: Optional[blang.Executor] = None

    def generate_relationships(self, inp: ResolveInput) -> list:
        return [resolve_rel(self, inp)]


@dataclass
class TupleSetExpr:
    """An expression returning an array of relationship strings
    (reference rules.go:148-201)."""
    expression: blang.Executor

    def generate_relationships(self, inp: ResolveInput) -> list:
        data = _to_template_data(inp)
        try:
            result = self.expression.query(data)
        except blang.BlangError as e:
            raise ResolveError(f"error executing tuple set expression: {e}") from e
        if not isinstance(result, list):
            raise ResolveError(
                f"tuple set expression must return an array, got {type(result).__name__}")
        rels = []
        for i, item in enumerate(result):
            if not isinstance(item, str):
                raise ResolveError(
                    f"tuple set expression item {i} must be a string, got {type(item).__name__}")
            try:
                u = parse_rel_string(item)
            except ValueError as e:
                raise ResolveError(f"error parsing relationship string {item!r}: {e}") from e
            rels.append(ResolvedRel(
                resource_type=u.resource_type,
                resource_id=u.resource_id,
                resource_relation=u.resource_relation,
                subject_type=u.subject_type,
                subject_id=u.subject_id,
                subject_relation=u.subject_relation,
            ))
        return rels


def resolve_rel(expr: RelExpr, inp: ResolveInput) -> ResolvedRel:
    """Evaluate all six field expressions (reference rules.go:355-417):
    a None result is an error; results must be strings."""
    data = _to_template_data(inp)

    def q(executor: blang.Executor, what: str) -> str:
        try:
            v = executor.query(data)
        except blang.BlangError as e:
            raise ResolveError(f"error resolving relationship: {e}") from e
        if v is None:
            raise ResolveError(f"error resolving relationship: empty {what}")
        if not isinstance(v, str):
            raise ResolveError(
                f"error resolving relationship: {what} must be a string, got {type(v).__name__}")
        return v

    rel = ResolvedRel(
        resource_type=q(expr.resource_type, "resource type"),
        resource_id=q(expr.resource_id, "resource id"),
        resource_relation=q(expr.resource_relation, "relation"),
        subject_type=q(expr.subject_type, "subject type"),
        subject_id=q(expr.subject_id, "subject id"),
    )
    if expr.subject_relation is not None:
        rel.subject_relation = q(expr.subject_relation, "subject relation")
    return rel


# ---------------------------------------------------------------------------
# Runnable rules
# ---------------------------------------------------------------------------

@dataclass
class PreFilter:
    """Compiled prefilter (reference rules.go:689-693)."""
    name_from_object_id: blang.Executor
    namespace_from_object_id: blang.Executor
    rel: RelExpr


@dataclass
class ResolvedPreFilter:
    """A prefilter whose LR template has been resolved for a request
    (reference rules.go:698-702)."""
    name_from_object_id: blang.Executor
    namespace_from_object_id: blang.Executor
    rel: ResolvedRel


@dataclass
class PostFilter:
    rel: RelExpr


@dataclass
class UpdateSet:
    must_exist: list = field(default_factory=list)
    must_not_exist: list = field(default_factory=list)
    creates: list = field(default_factory=list)
    touches: list = field(default_factory=list)
    deletes: list = field(default_factory=list)
    deletes_by_filter: list = field(default_factory=list)


@dataclass
class RunnableRule:
    """A fully compiled rule (reference rules.go:660-669)."""
    name: str = ""
    lock_mode: str = ""
    if_conditions: list = field(default_factory=list)  # cel.Program
    checks: list = field(default_factory=list)
    post_checks: list = field(default_factory=list)
    update: Optional[UpdateSet] = None
    pre_filter: list = field(default_factory=list)
    post_filter: list = field(default_factory=list)


def _compile_rel_template(t: proxyrule.StringOrTemplate) -> RelExpr:
    if t.template:
        u = parse_rel_string(t.template)
    else:
        rt = t.relationship_template
        u = UncompiledRelExpr(
            resource_type=rt.resource.type,
            resource_id=rt.resource.id,
            resource_relation=rt.resource.relation,
            subject_type=rt.subject.type,
            subject_id=rt.subject.id,
            subject_relation=rt.subject.relation,
        )
    try:
        expr = RelExpr(
            resource_type=compile_template_expression(u.resource_type),
            resource_id=compile_template_expression(u.resource_id),
            resource_relation=compile_template_expression(u.resource_relation),
            subject_type=compile_template_expression(u.subject_type),
            subject_id=compile_template_expression(u.subject_id),
        )
        if u.subject_relation:
            expr.subject_relation = compile_template_expression(u.subject_relation)
    except blang.BlangError as e:
        raise RuleCompileError(f"error compiling relationship template: {e}") from e
    return expr


def _compile_templates(tmpls: list) -> list:
    out = []
    for t in tmpls:
        if t.tuple_set:
            try:
                executor = compile_tuple_set_expression(t.tuple_set)
            except blang.BlangError as e:
                raise RuleCompileError(f"error compiling tuple set expression: {e}") from e
            out.append(TupleSetExpr(executor))
        else:
            out.append(_compile_rel_template(t))
    return out


def _compile_single_rel(t: proxyrule.StringOrTemplate, what: str) -> RelExpr:
    if t.tuple_set:
        raise RuleCompileError(
            f"{what}: tupleSet is not allowed in this context, use tpl or a"
            " relationship template instead")
    return _compile_rel_template(t)


_POSTCHECK_INCOMPATIBLE_VERBS = ("create", "update", "patch", "delete", "list", "watch")


def compile_rule(config: proxyrule.Config) -> RunnableRule:
    """Compile a parsed config into a RunnableRule (reference rules.go:719-900)."""
    spec = config.spec
    rule = RunnableRule(name=config.name, lock_mode=spec.locking)

    for i, expr in enumerate(spec.if_conditions):
        try:
            rule.if_conditions.append(cel.compile_condition(expr))
        except cel.CELCompileError as e:
            raise RuleCompileError(
                f"error compiling CEL expression {i} ({expr!r}): {e}") from e

    try:
        rule.checks = _compile_templates(spec.checks)
    except RuleCompileError as e:
        raise RuleCompileError(f"error compiling checks: {e}") from e
    try:
        rule.post_checks = _compile_templates(spec.post_checks)
    except RuleCompileError as e:
        raise RuleCompileError(f"error compiling postchecks: {e}") from e

    if spec.post_checks:
        for m in spec.matches:
            for v in m.verbs:
                if v in _POSTCHECK_INCOMPATIBLE_VERBS:
                    raise RuleCompileError(
                        f"PostCheck operations cannot be used with verb {v!r}."
                        " PostChecks only apply to read-only operations like 'get'")

    u = spec.update
    if not u.empty():
        rule.update = UpdateSet(
            must_exist=_compile_templates(u.precondition_exists),
            must_not_exist=_compile_templates(u.precondition_does_not_exist),
            creates=_compile_templates(u.creates),
            touches=_compile_templates(u.touches),
            deletes=_compile_templates(u.deletes),
            deletes_by_filter=_compile_templates(u.delete_by_filter),
        )

    for f in spec.pre_filters:
        try:
            name_exec = compile_template_expression(f.from_object_id_name_expr)
            ns_exec = compile_template_expression(f.from_object_id_namespace_expr)
        except blang.BlangError as e:
            raise RuleCompileError(f"failed to compile expression: {e}") from e
        if f.lookup_matching_resources is None:
            raise RuleCompileError("pre-filter must have LookupMatchingResources defined")
        rel = _compile_single_rel(f.lookup_matching_resources, "LookupMatchingResources")
        # The LR resourceID template must produce `$` (reference rules.go:858-877).
        try:
            processed = rel.resource_id.query({"resourceId": "$"})
        except blang.BlangError as e:
            raise RuleCompileError(
                f"error processing resource ID in LookupMatchingResources: {e}") from e
        if processed != proxyrule.MATCHING_ID_FIELD_VALUE:
            raise RuleCompileError(
                "LookupMatchingResources resourceID must be set to $ to match"
                f" all resources, got {processed!r}")
        rule.pre_filter.append(PreFilter(
            name_from_object_id=name_exec,
            namespace_from_object_id=ns_exec,
            rel=rel,
        ))

    for f in spec.post_filters:
        rel = _compile_single_rel(f.check_permission_template, "CheckPermissionTemplate")
        rule.post_filter.append(PostFilter(rel=rel))

    return rule


# ---------------------------------------------------------------------------
# Matching
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RequestMeta:
    verb: str
    api_group: str
    api_version: str
    resource: str


def _parse_group_version(gv: str) -> tuple:
    """'v1' -> ('', 'v1'); 'apps/v1' -> ('apps', 'v1')."""
    if not gv:
        return "", ""
    parts = gv.split("/")
    if len(parts) == 1:
        return "", parts[0]
    if len(parts) == 2:
        return parts[0], parts[1]
    raise RuleCompileError(f"couldn't parse gv {gv!r}: unexpected GroupVersion string")


class MapMatcher:
    """Rules keyed on (verb, group, version, resource)
    (reference rules.go:78-117)."""

    def __init__(self, configs: list):
        self._rules: dict[RequestMeta, list[RunnableRule]] = {}
        for cfg in configs:
            for m in cfg.spec.matches:
                group, version = _parse_group_version(m.group_version)
                for verb in m.verbs:
                    meta = RequestMeta(verb=verb, api_group=group,
                                       api_version=version, resource=m.resource)
                    try:
                        compiled = compile_rule(cfg)
                    except RuleCompileError as e:
                        raise RuleCompileError(
                            f"couldn't compile rule {cfg.name}: {e}") from e
                    self._rules.setdefault(meta, []).append(compiled)

    def match(self, info: RequestInfo) -> list:
        return self._rules.get(RequestMeta(
            verb=info.verb,
            api_group=info.api_group,
            api_version=info.api_version,
            resource=info.resource,
        ), [])


# ---------------------------------------------------------------------------
# CEL condition evaluation
# ---------------------------------------------------------------------------

def evaluate_cel_conditions(programs: list, inp: ResolveInput) -> bool:
    """All conditions must be true (reference rules.go:420-449)."""
    if not programs:
        return True
    cel_input = _to_cel_input(inp)
    for i, program in enumerate(programs):
        try:
            result = program.eval(cel_input)
        except cel.CELError as e:
            raise ResolveError(f"error evaluating CEL condition {i}: {e}") from e
        if not isinstance(result, bool):
            raise ResolveError(
                f"CEL condition {i} returned non-boolean value: {result!r}")
        if not result:
            return False
    return True


def filter_rules_with_cel_conditions(rules: list, inp: ResolveInput) -> list:
    """Keep rules whose conditions all pass (reference rules.go:452-467)."""
    out = []
    for rule in rules:
        if evaluate_cel_conditions(rule.if_conditions, inp):
            out.append(rule)
    return out
