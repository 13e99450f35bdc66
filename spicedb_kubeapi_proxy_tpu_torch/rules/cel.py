"""CEL-subset evaluator for rule `if` conditions.

The reference compiles each `if` expression with cel-go against an environment
of typed variables (request, user, object, name, resourceNamespace,
namespacedName, headers, body — reference: pkg/rules/rules.go:32-51) and
rejects expressions whose static output type is not boolean
(pkg/rules/rules.go:741-743).  This module implements the subset of CEL used
for such conditions:

- operators: `||` `&&` `!` `==` `!=` `<` `<=` `>` `>=` `in` `+ - * / %`
  and the ternary `cond ? a : b`
- literals: strings, ints, floats, booleans, null, lists, maps
- field access `a.b`, indexing `a[k]`
- functions/methods: `size(x)`, `x.size()`, `.startsWith()`, `.endsWith()`,
  `.contains()`, `.matches()` (RE2-style via Python re), `has(a.b)`,
  `string()`, `int()`, `double()`
- static boolean-output validation at compile time, mirroring the
  reference's `ast.OutputType().IsExactType(cel.BoolType)` gate.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Optional

from .blang import (
    BlangParseError,
    Tok,
    tokenize as _blang_tokenize,
)


class CELError(Exception):
    pass


class CELCompileError(CELError):
    pass


class CELEvalError(CELError):
    pass


# CEL has its own keywords; reuse the blang lexer but re-tag words.
_CEL_KEYWORDS = {"true", "false", "null", "in", "has"}


def _tokenize(src: str) -> list[Tok]:
    try:
        toks = _blang_tokenize(src)
    except BlangParseError as e:
        raise CELCompileError(str(e)) from e
    out = []
    for t in toks:
        if t.kind in ("kw", "ident"):
            if t.val in _CEL_KEYWORDS:
                out.append(Tok("kw", t.val, t.pos))
            else:
                out.append(Tok("ident", t.val, t.pos))
        elif t.kind == "nl":
            continue
        else:
            out.append(t)
    return out


# -- AST --------------------------------------------------------------------

class N:
    __slots__ = ()


@dataclass
class Lit(N):
    val: Any


@dataclass
class Ident(N):
    name: str


@dataclass
class Field(N):
    base: N
    name: str


@dataclass
class Index(N):
    base: N
    index: N


@dataclass
class Call(N):
    base: Optional[N]  # receiver for methods, None for global fns
    name: str
    args: list


@dataclass
class Bin(N):
    op: str
    left: N
    right: N


@dataclass
class Un(N):
    op: str
    operand: N


@dataclass
class Ternary(N):
    cond: N
    then: N
    otherwise: N


@dataclass
class ListLit(N):
    items: list


@dataclass
class MapLit(N):
    items: list


@dataclass
class Has(N):
    target: N  # must be a Field


class _Parser:
    def __init__(self, toks: list[Tok]):
        self.toks = toks
        self.i = 0

    def peek(self) -> Tok:
        return self.toks[self.i]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at(self, val: str) -> bool:
        t = self.peek()
        return t.kind == "punct" and t.val == val

    def eat(self, val: str) -> bool:
        if self.at(val):
            self.next()
            return True
        return False

    def expect(self, val: str) -> None:
        if not self.eat(val):
            t = self.peek()
            raise CELCompileError(f"expected {val!r}, got {t.val!r} at {t.pos}")

    def parse(self) -> N:
        e = self.ternary()
        if self.peek().kind != "eof":
            t = self.peek()
            raise CELCompileError(f"trailing input at {t.pos}: {t.val!r}")
        return e

    def ternary(self) -> N:
        cond = self.or_()
        if self.eat("?"):
            then = self.ternary()
            self.expect(":")
            return Ternary(cond, then, self.ternary())
        return cond

    def or_(self) -> N:
        left = self.and_()
        while self.at("||"):
            self.next()
            left = Bin("||", left, self.and_())
        return left

    def and_(self) -> N:
        left = self.rel()
        while self.at("&&"):
            self.next()
            left = Bin("&&", left, self.rel())
        return left

    def rel(self) -> N:
        left = self.add()
        t = self.peek()
        if t.kind == "punct" and t.val in ("==", "!=", "<", "<=", ">", ">="):
            self.next()
            return Bin(t.val, left, self.add())
        if t.kind == "kw" and t.val == "in":
            self.next()
            return Bin("in", left, self.add())
        return left

    def add(self) -> N:
        left = self.mul()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.val in ("+", "-"):
                self.next()
                left = Bin(t.val, left, self.mul())
            else:
                return left

    def mul(self) -> N:
        left = self.unary()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.val in ("*", "/", "%"):
                self.next()
                left = Bin(t.val, left, self.unary())
            else:
                return left

    def unary(self) -> N:
        t = self.peek()
        if t.kind == "punct" and t.val in ("!", "-"):
            self.next()
            return Un(t.val, self.unary())
        return self.postfix()

    def postfix(self) -> N:
        node = self.primary()
        while True:
            if self.at("."):
                self.next()
                t = self.next()
                if t.kind not in ("ident", "kw"):
                    raise CELCompileError(f"expected field name at {t.pos}")
                if self.at("("):
                    node = Call(node, t.val, self._args())
                else:
                    node = Field(node, t.val)
            elif self.at("["):
                self.next()
                idx = self.ternary()
                self.expect("]")
                node = Index(node, idx)
            else:
                return node

    def _args(self) -> list:
        self.expect("(")
        args: list[N] = []
        if not self.at(")"):
            args.append(self.ternary())
            while self.eat(","):
                args.append(self.ternary())
        self.expect(")")
        return args

    def primary(self) -> N:
        t = self.peek()
        if t.kind in ("str", "num"):
            self.next()
            return Lit(t.val)
        if t.kind == "kw":
            self.next()
            if t.val == "true":
                return Lit(True)
            if t.val == "false":
                return Lit(False)
            if t.val == "null":
                return Lit(None)
            if t.val == "has":
                args = self._args()
                if len(args) != 1 or not isinstance(args[0], Field):
                    raise CELCompileError("has() requires a field selection argument")
                return Has(args[0])
            raise CELCompileError(f"unexpected keyword {t.val!r} at {t.pos}")
        if t.kind == "ident":
            self.next()
            if self.at("("):
                return Call(None, t.val, self._args())
            return Ident(t.val)
        if t.kind == "punct":
            if t.val == "(":
                self.next()
                inner = self.ternary()
                self.expect(")")
                return inner
            if t.val == "[":
                self.next()
                items: list[N] = []
                if not self.at("]"):
                    items.append(self.ternary())
                    while self.eat(","):
                        items.append(self.ternary())
                self.expect("]")
                return ListLit(items)
            if t.val == "{":
                self.next()
                pairs: list[tuple[N, N]] = []
                if not self.at("}"):
                    pairs.append(self._pair())
                    while self.eat(","):
                        pairs.append(self._pair())
                self.expect("}")
                return MapLit(pairs)
        raise CELCompileError(f"unexpected token {t.val!r} at {t.pos}")

    def _pair(self) -> tuple[N, N]:
        k = self.ternary()
        self.expect(":")
        return k, self.ternary()


# -- static type gate -------------------------------------------------------

_BOOL_METHODS = {"startsWith", "endsWith", "contains", "matches",
                 "exists", "all", "exists_one"}


def _static_type(node: N, var_types: dict[str, str]) -> str:
    """Loose static inference: returns 'bool', 'string', 'int', 'double',
    'list', 'map', 'bytes', 'null' or 'dyn'."""
    if isinstance(node, Lit):
        v = node.val
        if isinstance(v, bool):
            return "bool"
        if isinstance(v, int):
            return "int"
        if isinstance(v, float):
            return "double"
        if isinstance(v, str):
            return "string"
        if v is None:
            return "null"
        return "dyn"
    if isinstance(node, Ident):
        return var_types.get(node.name, "dyn")
    if isinstance(node, (Field, Index)):
        return "dyn"
    if isinstance(node, ListLit):
        return "list"
    if isinstance(node, MapLit):
        return "map"
    if isinstance(node, Has):
        return "bool"
    if isinstance(node, Un):
        if node.op == "!":
            return "bool"
        return _static_type(node.operand, var_types)
    if isinstance(node, Bin):
        if node.op in ("||", "&&", "==", "!=", "<", "<=", ">", ">=", "in"):
            return "bool"
        lt = _static_type(node.left, var_types)
        rt = _static_type(node.right, var_types)
        if lt == rt:
            return lt
        return "dyn"
    if isinstance(node, Ternary):
        a = _static_type(node.then, var_types)
        b = _static_type(node.otherwise, var_types)
        return a if a == b else "dyn"
    if isinstance(node, Call):
        if node.name in _BOOL_METHODS:
            return "bool"
        if node.name == "size":
            return "int"
        if node.name == "string":
            return "string"
        if node.name == "int":
            return "int"
        if node.name == "double":
            return "double"
        return "dyn"
    return "dyn"


# -- program ----------------------------------------------------------------

# Variable environment matching the reference CEL env (rules.go:32-41).
DEFAULT_VAR_TYPES = {
    "request": "map",
    "user": "map",
    "object": "map",
    "name": "string",
    "resourceNamespace": "string",
    "namespacedName": "string",
    "headers": "map",
    "body": "bytes",
}


class Program:
    def __init__(self, ast: N, source: str):
        self._ast = ast
        self.source = source

    def eval(self, activation: dict[str, Any]) -> Any:
        return _eval(self._ast, activation)


def compile_condition(src: str,
                      var_types: Optional[dict[str, str]] = None) -> Program:
    """Compile a CEL condition, requiring a statically-boolean result
    (mirrors reference pkg/rules/rules.go:735-751)."""
    vt = DEFAULT_VAR_TYPES if var_types is None else var_types
    ast = _Parser(_tokenize(src)).parse()
    t = _static_type(ast, vt)
    if t != "bool":
        raise CELCompileError(
            f"CEL expression ({src!r}) must return a boolean, got {t}")
    return Program(ast, src)


def compile_expression(src: str) -> Program:
    """Compile a CEL expression without the boolean-output requirement."""
    ast = _Parser(_tokenize(src)).parse()
    return Program(ast, src)


# -- evaluation -------------------------------------------------------------

def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _eval(node: N, act: dict[str, Any]) -> Any:
    if isinstance(node, Lit):
        return node.val
    if isinstance(node, Ident):
        if node.name not in act:
            raise CELEvalError(f"no such attribute: {node.name}")
        return act[node.name]
    if isinstance(node, Field):
        base = _eval(node.base, act)
        if isinstance(base, dict):
            if node.name not in base:
                raise CELEvalError(f"no such key: {node.name}")
            return base[node.name]
        raise CELEvalError(f"cannot select field {node.name!r} on {type(base).__name__}")
    if isinstance(node, Index):
        base = _eval(node.base, act)
        idx = _eval(node.index, act)
        if isinstance(base, list):
            if not isinstance(idx, int) or isinstance(idx, bool):
                raise CELEvalError("list index must be int")
            if 0 <= idx < len(base):
                return base[idx]
            raise CELEvalError("index out of range")
        if isinstance(base, dict):
            if idx not in base:
                raise CELEvalError(f"no such key: {idx!r}")
            return base[idx]
        raise CELEvalError(f"cannot index {type(base).__name__}")
    if isinstance(node, Has):
        try:
            base = _eval(node.target.base, act)
        except CELEvalError:
            return False
        return isinstance(base, dict) and node.target.name in base
    if isinstance(node, ListLit):
        return [_eval(x, act) for x in node.items]
    if isinstance(node, MapLit):
        out = {}
        for k, v in node.items:
            out[_eval(k, act)] = _eval(v, act)
        return out
    if isinstance(node, Un):
        v = _eval(node.operand, act)
        if node.op == "!":
            if not isinstance(v, bool):
                raise CELEvalError("! on non-bool")
            return not v
        if not _is_num(v):
            raise CELEvalError("- on non-number")
        return -v
    if isinstance(node, Ternary):
        c = _eval(node.cond, act)
        if not isinstance(c, bool):
            raise CELEvalError("ternary condition must be bool")
        return _eval(node.then, act) if c else _eval(node.otherwise, act)
    if isinstance(node, Bin):
        op = node.op
        if op == "&&":
            l = _eval(node.left, act)
            if not isinstance(l, bool):
                raise CELEvalError("&& on non-bool")
            if not l:
                return False
            r = _eval(node.right, act)
            if not isinstance(r, bool):
                raise CELEvalError("&& on non-bool")
            return r
        if op == "||":
            l = _eval(node.left, act)
            if not isinstance(l, bool):
                raise CELEvalError("|| on non-bool")
            if l:
                return True
            r = _eval(node.right, act)
            if not isinstance(r, bool):
                raise CELEvalError("|| on non-bool")
            return r
        left = _eval(node.left, act)
        right = _eval(node.right, act)
        if op == "in":
            if isinstance(right, list):
                return any(_cel_eq(left, x) for x in right)
            if isinstance(right, dict):
                return left in right
            raise CELEvalError(f"'in' on {type(right).__name__}")
        if op == "==":
            return _cel_eq(left, right)
        if op == "!=":
            return not _cel_eq(left, right)
        if op in ("<", "<=", ">", ">="):
            if (_is_num(left) and _is_num(right)) or (
                    isinstance(left, str) and isinstance(right, str)):
                return {"<": left < right, "<=": left <= right,
                        ">": left > right, ">=": left >= right}[op]
            raise CELEvalError(f"cannot order {type(left).__name__} and {type(right).__name__}")
        if op == "+":
            if isinstance(left, str) and isinstance(right, str):
                return left + right
            if isinstance(left, list) and isinstance(right, list):
                return left + right
            if _is_num(left) and _is_num(right):
                return left + right
            raise CELEvalError("bad operands for +")
        if op in ("-", "*", "/", "%"):
            if not (_is_num(left) and _is_num(right)):
                raise CELEvalError(f"bad operands for {op}")
            if op == "-":
                return left - right
            if op == "*":
                return left * right
            if right == 0:
                raise CELEvalError("division by zero")
            if op == "/":
                if isinstance(left, int) and isinstance(right, int):
                    q = abs(left) // abs(right)
                    return q if (left >= 0) == (right >= 0) else -q
                return left / right
            # CEL % truncates toward zero
            r = abs(left) % abs(right)
            return r if left >= 0 else -r
        raise CELEvalError(f"unknown operator {op}")
    if isinstance(node, Call):
        return _call(node, act)
    raise CELEvalError(f"unhandled node {type(node).__name__}")


def _cel_eq(a: Any, b: Any) -> bool:
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    return a == b


def _call(node: Call, act: dict[str, Any]) -> Any:
    # comprehension macros bind their first argument as an iteration variable,
    # so they are handled before eager argument evaluation
    if node.base is not None and node.name in ("exists", "all", "exists_one"):
        if len(node.args) != 2 or not isinstance(node.args[0], Ident):
            raise CELEvalError(
                f"{node.name}() expects (var, predicate) arguments")
        var = node.args[0].name
        base = _eval(node.base, act)
        if not isinstance(base, (list, dict)):
            raise CELEvalError(f"{node.name}() on {type(base).__name__}")
        items = list(base)
        count = 0
        for item in items:
            v = _eval(node.args[1], {**act, var: item})
            if not isinstance(v, bool):
                raise CELEvalError(f"{node.name}() predicate must be boolean")
            if v:
                count += 1
            elif node.name == "all":
                return False
        if node.name == "all":
            return True
        if node.name == "exists_one":
            return count == 1
        return count > 0

    args = [_eval(a, act) for a in node.args]
    if node.base is None:
        if node.name in ("size", "string", "int", "double") and len(args) != 1:
            raise CELEvalError(f"{node.name}() expects 1 argument, got {len(args)}")
        if node.name == "size":
            v = args[0]
            if isinstance(v, (str, list, dict, bytes)):
                return len(v)
            raise CELEvalError("size() of unsupported type")
        if node.name == "string":
            v = args[0]
            if isinstance(v, str):
                return v
            if isinstance(v, bool):
                return "true" if v else "false"
            if _is_num(v):
                return str(v)
            if isinstance(v, bytes):
                return v.decode("utf-8", errors="replace")
            raise CELEvalError("string() of unsupported type")
        if node.name == "int":
            v = args[0]
            if _is_num(v):
                return int(v)
            if isinstance(v, str):
                try:
                    return int(v)
                except ValueError as e:
                    raise CELEvalError(f"int({v!r})") from e
            raise CELEvalError("int() of unsupported type")
        if node.name == "double":
            v = args[0]
            if _is_num(v):
                return float(v)
            if isinstance(v, str):
                try:
                    return float(v)
                except ValueError as e:
                    raise CELEvalError(f"double({v!r})") from e
            raise CELEvalError("double() of unsupported type")
        raise CELEvalError(f"unknown function {node.name!r}")

    base = _eval(node.base, act)
    if node.name == "size" and not args:
        if isinstance(base, (str, list, dict, bytes)):
            return len(base)
        raise CELEvalError("size() of unsupported type")
    if node.name in ("startsWith", "endsWith", "contains", "matches"):
        if not isinstance(base, str) or len(args) != 1 or not isinstance(args[0], str):
            raise CELEvalError(f"{node.name} expects string.{node.name}(string)")
        if node.name == "startsWith":
            return base.startswith(args[0])
        if node.name == "endsWith":
            return base.endswith(args[0])
        if node.name == "contains":
            return args[0] in base
        try:
            return re.search(args[0], base) is not None
        except re.error as e:
            raise CELEvalError(f"bad regex: {e}") from e
    raise CELEvalError(f"unknown method {node.name!r}")
