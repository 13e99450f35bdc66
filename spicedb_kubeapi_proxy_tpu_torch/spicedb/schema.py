"""SpiceDB schema DSL parser -> schema IR.

Parses the subset of the SpiceDB schema language the reference uses in its
bootstrap schemas (reference pkg/spicedb/bootstrap.yaml:1-41 and the e2e
schemas in e2e/proxy_test.go): `use` directives, `definition` blocks with
`relation` declarations (union types, subject relations `type#rel`, wildcards
`type:*`, `with expiration`) and `permission` expressions (union `+`,
intersection `&`, exclusion `-`, arrow `->`, `nil`, parentheses).

The IR doubles as the input to the graph compiler (ops/graph_compile.py),
which lowers permission expressions onto the iterative bit-packed sweep.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .types import SchemaError

# ---------------------------------------------------------------------------
# IR
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TypeRef:
    """One allowed subject type of a relation: `user`, `group#member`,
    `user:*`, `activity with expiration`."""
    type: str
    relation: str = ""      # subject relation ("" = direct subject)
    wildcard: bool = False  # type:*
    traits: tuple = ()      # e.g. ("expiration",)


class Expr:
    __slots__ = ()


@dataclass(frozen=True)
class Nil(Expr):
    pass


@dataclass(frozen=True)
class RelRef(Expr):
    """Reference to a relation or permission on the same definition."""
    name: str


@dataclass(frozen=True)
class Arrow(Expr):
    """`left->target`: for each subject object of relation `left`, evaluate
    `target` on it."""
    left: str
    target: str


@dataclass(frozen=True)
class Union(Expr):
    children: tuple


@dataclass(frozen=True)
class Intersection(Expr):
    children: tuple


@dataclass(frozen=True)
class Exclusion(Expr):
    base: Expr
    subtract: Expr


@dataclass
class Definition:
    name: str
    relations: dict = field(default_factory=dict)    # name -> list[TypeRef]
    permissions: dict = field(default_factory=dict)  # name -> Expr

    def has_relation_or_permission(self, name: str) -> bool:
        return name in self.relations or name in self.permissions


@dataclass
class Caveat:
    """`caveat name(param type, ...) { cel-expression }`.  The body is a CEL
    expression evaluated against the merged tuple/request context; a tuple
    carrying this caveat grants CONDITIONAL permission until the context
    decides it (the reference proxy skips CONDITIONAL LookupResources
    results, pkg/authz/lookups.go:85-88)."""
    name: str
    params: tuple          # ((param name, type source text), ...)
    body_src: str          # raw CEL source between the braces

    def __post_init__(self):
        self._prog = None

    def evaluate(self, context: dict) -> Optional[bool]:
        """True/False when decidable with `context`; None (CONDITIONAL)
        when required parameters are missing."""
        missing = [n for (n, _) in self.params if n not in context]
        if missing:
            return None
        if self._prog is None:
            from ..rules import cel  # lazy: schema is imported by rules
            self._prog = cel.compile_expression(self.body_src)
        out = self._prog.eval(dict(context))
        if not isinstance(out, bool):
            raise SchemaError(f"caveat {self.name!r} returned "
                              f"{type(out).__name__}, expected bool")
        return out


@dataclass
class Schema:
    definitions: dict = field(default_factory=dict)  # name -> Definition
    caveats: dict = field(default_factory=dict)      # name -> Caveat
    uses: tuple = ()

    def definition(self, type_name: str) -> Definition:
        d = self.definitions.get(type_name)
        if d is None:
            raise SchemaError(f"object definition `{type_name}` not found")
        return d

    def max_rewrite_depth(self) -> int:
        """Upper bound on acyclic rewrite nesting: used by the graph
        compiler to suggest an iteration count.  Recursive schemas (e.g.
        group#member in group membership) contribute via tuple-graph depth,
        not rewrite depth; see ops/graph_compile.py."""
        depths: dict[tuple, int] = {}

        def expr_depth(def_name: str, e: Expr, stack: frozenset) -> int:
            if isinstance(e, Nil):
                return 0
            if isinstance(e, RelRef):
                return ref_depth(def_name, e.name, stack)
            if isinstance(e, Arrow):
                # target evaluated on other definitions; bound separately
                best = 0
                for d in self.definitions.values():
                    if e.target in d.permissions or e.target in d.relations:
                        best = max(best, ref_depth(d.name, e.target, stack))
                return 1 + best
            if isinstance(e, (Union, Intersection)):
                return max((expr_depth(def_name, c, stack) for c in e.children),
                           default=0)
            if isinstance(e, Exclusion):
                return max(expr_depth(def_name, e.base, stack),
                           expr_depth(def_name, e.subtract, stack))
            raise SchemaError(f"unknown expr {e!r}")

        def ref_depth(def_name: str, name: str, stack: frozenset) -> int:
            key = (def_name, name)
            if key in stack:
                return 0  # recursive cycle; handled by iteration count
            if key in depths:
                return depths[key]
            d = self.definitions.get(def_name)
            if d is None:
                return 0
            if name in d.permissions:
                v = 1 + expr_depth(def_name, d.permissions[name], stack | {key})
            else:
                v = 1
            depths[key] = v
            return v

        best = 0
        for d in self.definitions.values():
            for p in d.permissions:
                best = max(best, ref_depth(d.name, p, frozenset()))
        return best


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_PUNCT = ["->", "{", "}", "(", ")", ":", "#", "|", "+", "&", "-", "=", ";",
          ",", "*", "/", "<", ">"]


def _tokenize(src: str) -> list:
    toks = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c in " \t\r\n":
            i += 1
            continue
        if src.startswith("//", i):
            while i < n and src[i] != "\n":
                i += 1
            continue
        if src.startswith("/*", i):
            end = src.find("*/", i + 2)
            if end < 0:
                raise SchemaError(f"unterminated block comment at {i}")
            i = end + 2
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            toks.append(("ident", src[i:j], i))
            i = j
            continue
        if c in "\"'":
            # string literals only occur inside caveat bodies, which are
            # skipped; tokenize so the skipper can walk over them
            j = i + 1
            while j < n and src[j] != c:
                j += 2 if src[j] == "\\" else 1
            if j >= n:
                raise SchemaError(f"unterminated string at offset {i}")
            toks.append(("str", src[i + 1:j], i))
            i = j + 1
            continue
        if c.isdigit():
            j = i
            while j < n and (src[j].isdigit() or src[j] == "."):
                j += 1
            toks.append(("num", src[i:j], i))
            i = j
            continue
        for p in _PUNCT:
            if src.startswith(p, i):
                toks.append(("punct", p, i))
                i += len(p)
                break
        else:
            raise SchemaError(f"unexpected character {c!r} at offset {i}")
    toks.append(("eof", "", n))
    return toks


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class _P:
    def __init__(self, toks: list, src: str = ""):
        self.toks = toks
        self.src = src
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def at(self, val: str) -> bool:
        k, v, _ = self.peek()
        return k == "punct" and v == val

    def eat(self, val: str) -> bool:
        if self.at(val):
            self.next()
            return True
        return False

    def expect_punct(self, val: str):
        k, v, pos = self.next()
        if k != "punct" or v != val:
            raise SchemaError(f"expected {val!r} at offset {pos}, got {v!r}")

    def expect_ident(self, what: str = "identifier") -> str:
        k, v, pos = self.next()
        if k != "ident":
            raise SchemaError(f"expected {what} at offset {pos}, got {v!r}")
        return v

    def qualified_name(self) -> str:
        """`name` or `prefix/name` (SpiceDB permits namespaced definitions)."""
        name = self.expect_ident("definition name")
        while self.eat("/"):
            name += "/" + self.expect_ident("name component")
        return name

    # -- grammar ------------------------------------------------------------

    def parse_schema(self) -> Schema:
        schema = Schema()
        uses = []
        while True:
            k, v, pos = self.peek()
            if k == "eof":
                break
            if k == "ident" and v == "use":
                self.next()
                uses.append(self.expect_ident("feature name"))
                continue
            if k == "ident" and v == "definition":
                d = self.parse_definition()
                if d.name in schema.definitions:
                    raise SchemaError(f"duplicate definition {d.name!r}")
                schema.definitions[d.name] = d
                continue
            if k == "ident" and v == "caveat":
                c = self.parse_caveat()
                if c.name in schema.caveats:
                    raise SchemaError(f"duplicate caveat {c.name!r}")
                schema.caveats[c.name] = c
                continue
            raise SchemaError(f"unexpected token {v!r} at offset {pos}")
        schema.uses = tuple(uses)
        _validate(schema)
        return schema

    def parse_caveat(self) -> Caveat:
        """`caveat name(param type, ...) { cel-expression }`."""
        self.next()  # 'caveat'
        name = self.expect_ident("caveat name")
        self.expect_punct("(")
        params = []
        while not self.eat(")"):
            pname = self.expect_ident("caveat parameter name")
            # the type is a free-form token run (`int`, `list<string>`,
            # `map<any>`, ...) up to `,` or `)`
            type_parts = []
            depth = 0
            while True:
                k, v, pos = self.peek()
                if k == "eof":
                    raise SchemaError("unterminated caveat parameter list")
                if depth == 0 and k == "punct" and v in (",", ")"):
                    break
                if k == "punct" and v == "<":
                    depth += 1
                elif k == "punct" and v == ">":
                    depth -= 1
                type_parts.append(v)
                self.next()
            if not type_parts:
                raise SchemaError(
                    f"caveat parameter {pname!r} missing a type")
            params.append((pname, "".join(type_parts)))
            self.eat(",")
        k, v, start = self.peek()
        self.expect_punct("{")
        depth = 1
        end = start
        while depth:
            k, v, end = self.next()
            if k == "eof":
                raise SchemaError("unterminated caveat body")
            if v == "{":
                depth += 1
            elif v == "}":
                depth -= 1
        body = self.src[start + 1: end].strip() if self.src else ""
        if not body:
            raise SchemaError(f"caveat {name!r} has an empty body")
        return Caveat(name=name, params=tuple(params), body_src=body)

    def parse_definition(self) -> Definition:
        self.next()  # 'definition'
        d = Definition(name=self.qualified_name())
        self.expect_punct("{")
        while not self.eat("}"):
            k, v, pos = self.peek()
            if k == "ident" and v == "relation":
                self.next()
                name = self.expect_ident("relation name")
                self.expect_punct(":")
                refs = [self.parse_type_ref()]
                while self.eat("|"):
                    refs.append(self.parse_type_ref())
                self.eat(";")
                if d.has_relation_or_permission(name):
                    raise SchemaError(
                        f"duplicate relation/permission {name!r} on {d.name}")
                d.relations[name] = refs
            elif k == "ident" and v == "permission":
                self.next()
                name = self.expect_ident("permission name")
                self.expect_punct("=")
                expr = self.parse_perm_expr()
                self.eat(";")
                if d.has_relation_or_permission(name):
                    raise SchemaError(
                        f"duplicate relation/permission {name!r} on {d.name}")
                d.permissions[name] = expr
            else:
                raise SchemaError(
                    f"expected relation or permission at offset {pos}, got {v!r}")
        return d

    def parse_type_ref(self) -> TypeRef:
        t = self.qualified_name()
        relation = ""
        wildcard = False
        if self.eat(":"):
            self.expect_punct("*")
            wildcard = True
        elif self.eat("#"):
            relation = self.expect_ident("subject relation")
        traits = []
        while True:
            k, v, _ = self.peek()
            if k == "ident" and v == "with":
                self.next()
                traits.append(self.expect_ident("trait name"))
                # `with caveat_name and expiration` continuation
                while True:
                    k2, v2, _ = self.peek()
                    if k2 == "ident" and v2 == "and":
                        self.next()
                        traits.append(self.expect_ident("trait name"))
                    else:
                        break
            else:
                break
        return TypeRef(type=t, relation=relation, wildcard=wildcard,
                       traits=tuple(traits))

    # precedence: `+` (lowest) < `&` < `-` (tightest), all left-assoc,
    # matching the SpiceDB schema DSL
    def parse_perm_expr(self) -> Expr:
        return self.parse_union()

    def parse_union(self) -> Expr:
        left = self.parse_intersection()
        children = [left]
        while self.eat("+"):
            children.append(self.parse_intersection())
        if len(children) == 1:
            return left
        return Union(tuple(children))

    def parse_intersection(self) -> Expr:
        left = self.parse_exclusion()
        children = [left]
        while self.eat("&"):
            children.append(self.parse_exclusion())
        if len(children) == 1:
            return left
        return Intersection(tuple(children))

    def parse_exclusion(self) -> Expr:
        left = self.parse_base()
        while self.eat("-"):
            left = Exclusion(left, self.parse_base())
        return left

    def parse_base(self) -> Expr:
        if self.eat("("):
            e = self.parse_perm_expr()
            self.expect_punct(")")
            return e
        k, v, pos = self.next()
        if k != "ident":
            raise SchemaError(f"expected expression at offset {pos}, got {v!r}")
        if v == "nil":
            return Nil()
        name = v
        if self.at("->"):
            self.next()
            target = self.expect_ident("arrow target")
            return Arrow(name, target)
        return RelRef(name)


def _validate(schema: Schema) -> None:
    for d in schema.definitions.values():
        for rel_name, refs in d.relations.items():
            for ref in refs:
                target = schema.definitions.get(ref.type)
                if target is None:
                    raise SchemaError(
                        f"{d.name}#{rel_name}: unknown subject type {ref.type!r}")
                if ref.relation and not target.has_relation_or_permission(ref.relation):
                    raise SchemaError(
                        f"{d.name}#{rel_name}: {ref.type!r} has no relation"
                        f" or permission {ref.relation!r}")
                for trait in ref.traits:
                    if trait != "expiration" and trait not in schema.caveats:
                        raise SchemaError(
                            f"{d.name}#{rel_name}: unknown trait/caveat"
                            f" {trait!r}")
        for perm_name, expr in d.permissions.items():
            _validate_expr(schema, d, perm_name, expr)


def _validate_expr(schema: Schema, d: Definition, perm: str, e: Expr) -> None:
    if isinstance(e, Nil):
        return
    if isinstance(e, RelRef):
        if not d.has_relation_or_permission(e.name):
            raise SchemaError(
                f"{d.name}#{perm}: references unknown relation/permission {e.name!r}")
        return
    if isinstance(e, Arrow):
        if e.left not in d.relations:
            raise SchemaError(
                f"{d.name}#{perm}: arrow left side {e.left!r} must be a relation"
                f" on {d.name}")
        return
    if isinstance(e, (Union, Intersection)):
        for c in e.children:
            _validate_expr(schema, d, perm, c)
        return
    if isinstance(e, Exclusion):
        _validate_expr(schema, d, perm, e.base)
        _validate_expr(schema, d, perm, e.subtract)
        return
    raise SchemaError(f"unknown expression node {e!r}")


def parse_schema(src: str) -> Schema:
    return _P(_tokenize(src), src).parse_schema()


def validate_relationship(schema: Schema, rel) -> None:
    """Reject writes the schema does not permit — the behavior of SpiceDB's
    WriteRelationships validation behind the reference's embedded server:
    undefined resource/subject types, writes to permissions or undeclared
    relations, subject types/sub-relations a relation does not accept,
    wildcard subjects without a `type:*` annotation, and caveats that are
    not declared in the schema.  Raises SchemaError."""
    d = schema.definition(rel.resource.type)
    relation = rel.relation
    if relation in d.permissions:
        raise SchemaError(
            f"cannot write relationship to permission "
            f"`{rel.resource.type}#{relation}`")
    refs = d.relations.get(relation)
    if refs is None:
        raise SchemaError(
            f"relation `{relation}` not found on definition "
            f"`{rel.resource.type}`")
    schema.definition(rel.subject.type)  # subject type must exist
    caveat = getattr(rel, "caveat", None)
    if caveat is not None and caveat.name not in schema.caveats:
        raise SchemaError(f"caveat `{caveat.name}` not found in schema")
    sub_rel = rel.subject.relation or ""
    wildcard = rel.subject.id == "*"
    # the traits the written tuple carries must be exactly what a matching
    # type annotation requires: `user with c` accepts only c-caveated
    # tuples, plain `user` only trait-free ones (SpiceDB semantics —
    # permit both by declaring `user | user with c`)
    tuple_traits = set()
    if caveat is not None:
        tuple_traits.add(caveat.name)
    if getattr(rel, "expires_at", None) is not None:
        tuple_traits.add("expiration")
    for ref in refs:
        if ref.type != rel.subject.type:
            continue
        if set(ref.traits) != tuple_traits:
            continue
        if wildcard:
            if ref.wildcard:
                break
            continue
        if not ref.wildcard and (ref.relation or "") == sub_rel:
            break
    else:
        want = (f"{rel.subject.type}:*" if wildcard
                else rel.subject.type + (f"#{sub_rel}" if sub_rel else ""))
        if tuple_traits:
            want += " with " + " and ".join(sorted(tuple_traits))
        raise SchemaError(
            f"subject `{want}` is not allowed on relation "
            f"`{rel.resource.type}#{relation}`")
