"""ProxyRule config schema (`authzed.com/v1alpha1`, kind ProxyRule).

Typed dataclasses + multi-doc YAML parsing + validation, mirroring the
reference schema and its validator semantics (reference:
pkg/config/proxyrule/rule.go:12-272):

- `match` required, each entry needs apiVersion/resource/verbs with verbs in
  the fixed kube verb set
- `StringOrTemplate` is exactly one of `tpl` | structured template | `tupleSet`
- prefilter / postfilter / update substructures.

`yaml` is imported by `parse` when it runs: `parse_doc` takes a mapping
and needs no third-party package, so rules given as Python dicts load
where PyYAML is missing.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from typing import Any, Optional, Union

API_VERSION = "authzed.com/v1alpha1"
KIND = "ProxyRule"

# LookupResources requests use this resourceID value to indicate "match the
# object being processed" (reference rule.go:19-22).
MATCHING_ID_FIELD_VALUE = "$"

PESSIMISTIC_LOCK_MODE = "Pessimistic"
OPTIMISTIC_LOCK_MODE = "Optimistic"

ALLOWED_VERBS = ("get", "list", "watch", "create", "update", "patch", "delete")


class RuleValidationError(ValueError):
    pass


@dataclass
class ObjectTemplate:
    type: str = ""
    id: str = ""
    relation: str = ""


@dataclass
class RelationshipTemplate:
    resource: ObjectTemplate = field(default_factory=ObjectTemplate)
    subject: ObjectTemplate = field(default_factory=ObjectTemplate)


@dataclass
class StringOrTemplate:
    """Exactly one of template / tuple_set / relationship_template is set."""
    template: str = ""
    tuple_set: str = ""
    relationship_template: Optional[RelationshipTemplate] = None

    def validate(self, path: str) -> None:
        count = sum([bool(self.template), bool(self.tuple_set),
                     self.relationship_template is not None])
        if count == 0:
            raise RuleValidationError(
                f"{path}: one of tpl, tupleSet, or a relationship template is required")
        if count > 1:
            raise RuleValidationError(
                f"{path}: tpl, tupleSet, and relationship template are mutually exclusive")


@dataclass
class Match:
    group_version: str = ""
    resource: str = ""
    verbs: list = field(default_factory=list)

    def validate(self, path: str) -> None:
        if not self.group_version:
            raise RuleValidationError(f"{path}.apiVersion is required")
        if not self.resource:
            raise RuleValidationError(f"{path}.resource is required")
        if not self.verbs:
            raise RuleValidationError(f"{path}.verbs must be non-empty")
        for v in self.verbs:
            if v not in ALLOWED_VERBS:
                raise RuleValidationError(
                    f"{path}.verbs: {v!r} is not one of {ALLOWED_VERBS}")


@dataclass
class PreFilter:
    from_object_id_name_expr: str = ""
    from_object_id_namespace_expr: str = ""
    lookup_matching_resources: Optional[StringOrTemplate] = None


@dataclass
class PostFilter:
    check_permission_template: Optional[StringOrTemplate] = None

    def validate(self, path: str) -> None:
        if self.check_permission_template is None:
            raise RuleValidationError(
                f"{path}.checkPermissionTemplate is required")
        self.check_permission_template.validate(path + ".checkPermissionTemplate")


@dataclass
class Update:
    precondition_exists: list = field(default_factory=list)
    precondition_does_not_exist: list = field(default_factory=list)
    creates: list = field(default_factory=list)
    touches: list = field(default_factory=list)
    deletes: list = field(default_factory=list)
    delete_by_filter: list = field(default_factory=list)

    def empty(self) -> bool:
        return not (self.precondition_exists or self.precondition_does_not_exist
                    or self.creates or self.touches or self.deletes
                    or self.delete_by_filter)


@dataclass
class Spec:
    locking: str = ""
    matches: list = field(default_factory=list)
    if_conditions: list = field(default_factory=list)
    checks: list = field(default_factory=list)
    post_checks: list = field(default_factory=list)
    pre_filters: list = field(default_factory=list)
    post_filters: list = field(default_factory=list)
    update: Update = field(default_factory=Update)


@dataclass
class Config:
    """A parsed ProxyRule document (TypeMeta + ObjectMeta + Spec inline)."""
    api_version: str = API_VERSION
    kind: str = KIND
    name: str = ""
    spec: Spec = field(default_factory=Spec)


def _string_or_template(raw: Any, path: str) -> StringOrTemplate:
    if not isinstance(raw, dict):
        raise RuleValidationError(f"{path}: expected a mapping, got {type(raw).__name__}")
    out = StringOrTemplate(
        template=raw.get("tpl", "") or "",
        tuple_set=raw.get("tupleSet", "") or "",
    )
    if "resource" in raw or "subject" in raw:
        res = raw.get("resource") or {}
        sub = raw.get("subject") or {}
        out.relationship_template = RelationshipTemplate(
            resource=ObjectTemplate(
                type=res.get("type", ""), id=res.get("id", ""),
                relation=res.get("relation", "")),
            subject=ObjectTemplate(
                type=sub.get("type", ""), id=sub.get("id", ""),
                relation=sub.get("relation", "")),
        )
    out.validate(path)
    return out


def _string_or_template_list(raw: Any, path: str) -> list:
    if raw is None:
        return []
    if not isinstance(raw, list):
        raise RuleValidationError(f"{path}: expected a list")
    return [_string_or_template(item, f"{path}[{i}]") for i, item in enumerate(raw)]


def parse_doc(doc: dict) -> Config:
    """Parse and validate a single ProxyRule YAML document."""
    if not isinstance(doc, dict):
        raise RuleValidationError(f"rule document must be a mapping, got {type(doc).__name__}")
    cfg = Config()
    cfg.api_version = doc.get("apiVersion", "")
    cfg.kind = doc.get("kind", "")
    meta = doc.get("metadata") or {}
    cfg.name = meta.get("name", "")

    spec = cfg.spec
    spec.locking = doc.get("lock", "") or ""
    if spec.locking and spec.locking not in (PESSIMISTIC_LOCK_MODE, OPTIMISTIC_LOCK_MODE):
        raise RuleValidationError(
            f"lock must be one of {OPTIMISTIC_LOCK_MODE!r}, {PESSIMISTIC_LOCK_MODE!r};"
            f" got {spec.locking!r}")

    raw_matches = doc.get("match")
    if not raw_matches or not isinstance(raw_matches, list):
        raise RuleValidationError("match is required and must be a non-empty list")
    for i, m in enumerate(raw_matches):
        if not isinstance(m, dict):
            raise RuleValidationError(f"match[{i}]: expected a mapping, got {type(m).__name__}")
        match = Match(
            group_version=m.get("apiVersion", ""),
            resource=m.get("resource", ""),
            verbs=list(m.get("verbs") or []),
        )
        match.validate(f"match[{i}]")
        spec.matches.append(match)

    raw_if = doc.get("if") or []
    if not isinstance(raw_if, list):
        raise RuleValidationError("if must be a list of CEL expressions")
    spec.if_conditions = [str(x) for x in raw_if]

    spec.checks = _string_or_template_list(doc.get("check"), "check")
    spec.post_checks = _string_or_template_list(doc.get("postcheck"), "postcheck")

    raw_pre = doc.get("prefilter") or []
    if not isinstance(raw_pre, list):
        raise RuleValidationError("prefilter must be a list")
    for i, p in enumerate(raw_pre):
        if not isinstance(p, dict):
            raise RuleValidationError(f"prefilter[{i}]: expected a mapping, got {type(p).__name__}")
        pf = PreFilter(
            from_object_id_name_expr=p.get("fromObjectIDNameExpr", "") or "",
            from_object_id_namespace_expr=p.get("fromObjectIDNamespaceExpr", "") or "",
        )
        if p.get("lookupMatchingResources") is not None:
            pf.lookup_matching_resources = _string_or_template(
                p["lookupMatchingResources"], f"prefilter[{i}].lookupMatchingResources")
        spec.pre_filters.append(pf)

    raw_post = doc.get("postfilter") or []
    if not isinstance(raw_post, list):
        raise RuleValidationError("postfilter must be a list")
    for i, p in enumerate(raw_post):
        if not isinstance(p, dict):
            raise RuleValidationError(
                f"postfilter[{i}]: expected a mapping, "
                f"got {type(p).__name__}")
        pf = PostFilter()
        if p.get("checkPermissionTemplate") is not None:
            pf.check_permission_template = _string_or_template(
                p["checkPermissionTemplate"], f"postfilter[{i}].checkPermissionTemplate")
        pf.validate(f"postfilter[{i}]")
        spec.post_filters.append(pf)

    raw_update = doc.get("update") or {}
    if not isinstance(raw_update, dict):
        raise RuleValidationError("update must be a mapping")
    if raw_update:
        u = spec.update
        u.precondition_exists = _string_or_template_list(
            raw_update.get("preconditionExists"), "update.preconditionExists")
        u.precondition_does_not_exist = _string_or_template_list(
            raw_update.get("preconditionDoesNotExist"), "update.preconditionDoesNotExist")
        u.creates = _string_or_template_list(raw_update.get("creates"), "update.creates")
        u.touches = _string_or_template_list(raw_update.get("touches"), "update.touches")
        u.deletes = _string_or_template_list(raw_update.get("deletes"), "update.deletes")
        u.delete_by_filter = _string_or_template_list(
            raw_update.get("deleteByFilter"), "update.deleteByFilter")
    return cfg


def parse(source: Union[str, bytes, io.IOBase]) -> list:
    """Parse multi-document YAML into a list of validated Configs
    (reference rule.go:215-239)."""
    if isinstance(source, io.IOBase):
        source = source.read()
    if isinstance(source, bytes):
        source = source.decode("utf-8")
    import yaml

    configs: list[Config] = []
    for doc in yaml.safe_load_all(source):
        if doc is None:
            continue
        configs.append(parse_doc(doc))
    return configs


def parse_file(path: str) -> list:
    with open(path, "r", encoding="utf-8") as f:
        return parse(f.read())
