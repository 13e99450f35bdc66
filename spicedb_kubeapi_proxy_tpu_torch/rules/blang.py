"""Template expression language for relationship templates ("blang").

A small, self-contained interpreter covering the subset of Bloblang that the
reference proxy's rule templates use (reference: pkg/rules/rules.go:1005-1051
compiles `{{ ... }}` template fields with a Bloblang environment, and
pkg/rules/env.go:13-58 registers the custom `split_name` / `split_namespace`
functions).  Supported forms, matching the expressions exercised by the
reference test corpus (pkg/rules/rules_test.go, tupleset_test.go):

- literals: strings ("..."), numbers, booleans, null, arrays ([a, b])
- `this` and implicit-this field paths: `user.name` == `this.user.name`
- field access `a.b.c`, indexing `a[0]`, `a["k"]`
- context capture: `expr.(name -> body)` — binds `name` to the value of
  `expr`; `this` inside `body` is unchanged (lexical named context)
- `let name = expr` statements (newline-separated), referenced as `$name`
- methods: `.map_each(expr)` / `.filter(expr)` (element bound to `this`),
  `.string()`, `.number()`, `.length()`, `.uppercase()`, `.lowercase()`,
  `.trim()`, `.contains(x)`, `.has_prefix(x)`, `.has_suffix(x)`,
  `.split(sep)`, `.join(sep)`, `.catch(fallback)`
- functions: registered per-environment (`split_name`, `split_namespace`)
- operators: `||` `&&` `==` `!=` `<` `<=` `>` `>=` `+` `-` `*` `/` `%` `!`,
  unary minus, and the catch/coalesce pipe `a | b` (null-or-error -> b)
- conditionals: `if cond { expr } else if cond { expr } else { expr }`

Evaluation is purely functional over plain Python data (dict/list/str/num).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional


class BlangError(Exception):
    """Compile- or eval-time error in a template expression."""


class BlangParseError(BlangError):
    pass


class BlangEvalError(BlangError):
    pass


_NULL = object()  # sentinel distinct from Python None (which means JSON null)


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_PUNCT = [
    "->", "==", "!=", "<=", ">=", "&&", "||",
    "(", ")", "[", "]", "{", "}", ".", ",", "|", "+", "-", "*", "/", "%",
    "<", ">", "!", "=", "$", ":", "?",
]

_KEYWORDS = {"if", "else", "let", "null", "true", "false", "this", "root"}


@dataclass
class Tok:
    kind: str  # 'ident' | 'num' | 'str' | 'punct' | 'kw' | 'eof' | 'nl'
    val: Any
    pos: int


def tokenize(src: str) -> list[Tok]:
    toks: list[Tok] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c == "\n":
            toks.append(Tok("nl", "\n", i))
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        if c == "#":  # comment to end of line
            while i < n and src[i] != "\n":
                i += 1
            continue
        if c in "\"'":
            quote = c
            j = i + 1
            buf = []
            while j < n and src[j] != quote:
                if src[j] == "\\" and j + 1 < n:
                    esc = src[j + 1]
                    buf.append({"n": "\n", "t": "\t", "\\": "\\", quote: quote}.get(esc, esc))
                    j += 2
                else:
                    buf.append(src[j])
                    j += 1
            if j >= n:
                raise BlangParseError(f"unterminated string at {i}")
            toks.append(Tok("str", "".join(buf), i))
            i = j + 1
            continue
        if c.isdigit():
            j = i
            while j < n and (src[j].isdigit() or (
                    src[j] == "." and j + 1 < n and src[j + 1].isdigit())):
                j += 1
            text = src[i:j]
            try:
                val = int(text) if "." not in text else float(text)
            except ValueError as e:
                raise BlangParseError(f"bad number {text!r} at {i}") from e
            toks.append(Tok("num", val, i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            toks.append(Tok("kw" if word in _KEYWORDS else "ident", word, i))
            i = j
            continue
        for p in _PUNCT:
            if src.startswith(p, i):
                toks.append(Tok("punct", p, i))
                i += len(p)
                break
        else:
            raise BlangParseError(f"unexpected character {c!r} at {i}")
    toks.append(Tok("eof", None, n))
    return toks


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

class Node:
    __slots__ = ()


@dataclass
class Lit(Node):
    val: Any


@dataclass
class ArrayLit(Node):
    items: list


@dataclass
class ObjectLit(Node):
    items: list  # list of (key_node, value_node)


@dataclass
class This(Node):
    pass


@dataclass
class NameRef(Node):
    """Bare identifier: resolves to a named context if bound, else this.<name>."""
    name: str


@dataclass
class VarRef(Node):
    """`$name` — a `let` variable."""
    name: str


@dataclass
class Field(Node):
    base: Node
    name: str


@dataclass
class Index(Node):
    base: Node
    index: Node


@dataclass
class Call(Node):
    name: str
    args: list


@dataclass
class Method(Node):
    base: Node
    name: str
    args: list  # AST nodes; map_each/filter receive them unevaluated


@dataclass
class Capture(Node):
    base: Node
    name: str
    body: Node


@dataclass
class BinOp(Node):
    op: str
    left: Node
    right: Node


@dataclass
class Unary(Node):
    op: str
    operand: Node


@dataclass
class IfExpr(Node):
    cond: Node
    then: Node
    otherwise: Optional[Node]


@dataclass
class Mapping(Node):
    """A sequence of `let` statements followed by a final expression."""
    lets: list  # list of (name, Node)
    result: Node


# ---------------------------------------------------------------------------
# Parser (precedence climbing)
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, toks: list[Tok]):
        self.toks = toks
        self.i = 0
        # While parsing a `let` statement's right-hand side, a newline at
        # bracket depth 0 terminates the expression instead of being skipped.
        self.stop_at_nl = False
        self.depth = 0

    def _skips_nl(self) -> bool:
        return not (self.stop_at_nl and self.depth == 0)

    def peek(self, skip_nl: bool = True) -> Tok:
        j = self.i
        while skip_nl and self._skips_nl() and self.toks[j].kind == "nl":
            j += 1
        return self.toks[j]

    def next(self, skip_nl: bool = True) -> Tok:
        while skip_nl and self._skips_nl() and self.toks[self.i].kind == "nl":
            self.i += 1
        t = self.toks[self.i]
        self.i += 1
        if t.kind == "punct":
            if t.val in ("(", "[", "{"):
                self.depth += 1
            elif t.val in (")", "]", "}"):
                self.depth -= 1
        return t

    def expect(self, kind: str, val: Any = None) -> Tok:
        t = self.next()
        if t.kind != kind or (val is not None and t.val != val):
            raise BlangParseError(f"expected {val or kind}, got {t.val!r} at {t.pos}")
        return t

    def at_punct(self, val: str) -> bool:
        t = self.peek()
        return t.kind == "punct" and t.val == val

    def eat_punct(self, val: str) -> bool:
        if self.at_punct(val):
            self.next()
            return True
        return False

    # mapping := (let ident = expr NL)* expr
    def parse_mapping(self) -> Node:
        lets: list[tuple[str, Node]] = []
        while True:
            t = self.peek()
            if t.kind == "kw" and t.val == "let":
                self.next()
                name = self.expect("ident").val
                self.expect("punct", "=")
                # the let RHS ends at the first newline outside brackets
                self.stop_at_nl = True
                try:
                    lets.append((name, self.parse_expr()))
                finally:
                    self.stop_at_nl = False
            else:
                break
        result = self.parse_expr()
        t = self.peek()
        if t.kind != "eof":
            raise BlangParseError(f"trailing input at {t.pos}: {t.val!r}")
        return Mapping(lets, result) if lets else result

    def parse_expr(self) -> Node:
        return self.parse_catch()

    def parse_catch(self) -> Node:
        left = self.parse_or()
        while self.at_punct("|") and not self.at_punct("||"):
            self.next()
            right = self.parse_or()
            left = BinOp("|", left, right)
        return left

    def parse_or(self) -> Node:
        left = self.parse_and()
        while self.at_punct("||"):
            self.next()
            left = BinOp("||", left, self.parse_and())
        return left

    def parse_and(self) -> Node:
        left = self.parse_cmp()
        while self.at_punct("&&"):
            self.next()
            left = BinOp("&&", left, self.parse_cmp())
        return left

    def parse_cmp(self) -> Node:
        left = self.parse_add()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.val in ("==", "!=", "<", "<=", ">", ">="):
                self.next()
                left = BinOp(t.val, left, self.parse_add())
            else:
                return left

    def parse_add(self) -> Node:
        left = self.parse_mul()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.val in ("+", "-"):
                self.next()
                left = BinOp(t.val, left, self.parse_mul())
            else:
                return left

    def parse_mul(self) -> Node:
        left = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.val in ("*", "/", "%"):
                self.next()
                left = BinOp(t.val, left, self.parse_unary())
            else:
                return left

    def parse_unary(self) -> Node:
        t = self.peek()
        if t.kind == "punct" and t.val in ("!", "-"):
            self.next()
            return Unary(t.val, self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self) -> Node:
        node = self.parse_primary()
        while True:
            if self.at_punct("."):
                self.next()
                if self.at_punct("("):
                    # context capture: .(name -> body)
                    self.next()
                    name = self.expect("ident").val
                    self.expect("punct", "->")
                    body = self.parse_expr()
                    self.expect("punct", ")")
                    node = Capture(node, name, body)
                    continue
                t = self.next()
                if t.kind not in ("ident", "kw"):
                    raise BlangParseError(f"expected field name at {t.pos}")
                name = t.val
                if self.at_punct("("):
                    node = Method(node, name, self._parse_args())
                else:
                    node = Field(node, name)
            elif self.at_punct("["):
                self.next()
                idx = self.parse_expr()
                self.expect("punct", "]")
                node = Index(node, idx)
            else:
                return node

    def _parse_args(self) -> list:
        self.expect("punct", "(")
        args: list[Node] = []
        if not self.at_punct(")"):
            args.append(self.parse_expr())
            while self.eat_punct(","):
                args.append(self.parse_expr())
        self.expect("punct", ")")
        return args

    def parse_primary(self) -> Node:
        t = self.peek()
        if t.kind == "str" or t.kind == "num":
            self.next()
            return Lit(t.val)
        if t.kind == "kw":
            if t.val in ("true", "false"):
                self.next()
                return Lit(t.val == "true")
            if t.val == "null":
                self.next()
                return Lit(None)
            if t.val in ("this", "root"):
                self.next()
                return This()
            if t.val == "if":
                return self._parse_if()
            raise BlangParseError(f"unexpected keyword {t.val!r} at {t.pos}")
        if t.kind == "ident":
            self.next()
            if self.at_punct("("):
                return Call(t.val, self._parse_args())
            return NameRef(t.val)
        if t.kind == "punct":
            if t.val == "$":
                self.next()
                name = self.expect("ident").val
                return VarRef(name)
            if t.val == "(":
                self.next()
                inner = self.parse_expr()
                self.expect("punct", ")")
                return inner
            if t.val == "[":
                self.next()
                items: list[Node] = []
                if not self.at_punct("]"):
                    items.append(self.parse_expr())
                    while self.eat_punct(","):
                        items.append(self.parse_expr())
                self.expect("punct", "]")
                return ArrayLit(items)
            if t.val == "{":
                self.next()
                pairs: list[tuple[Node, Node]] = []
                if not self.at_punct("}"):
                    pairs.append(self._parse_pair())
                    while self.eat_punct(","):
                        pairs.append(self._parse_pair())
                self.expect("punct", "}")
                return ObjectLit(pairs)
        raise BlangParseError(f"unexpected token {t.val!r} at {t.pos}")

    def _parse_pair(self) -> tuple[Node, Node]:
        key = self.parse_expr()
        self.expect("punct", ":")
        return key, self.parse_expr()

    def _parse_if(self) -> Node:
        self.expect("kw", "if")
        cond = self.parse_expr()
        self.expect("punct", "{")
        then = self.parse_expr()
        self.expect("punct", "}")
        otherwise: Optional[Node] = None
        t = self.peek()
        if t.kind == "kw" and t.val == "else":
            self.next()
            t2 = self.peek()
            if t2.kind == "kw" and t2.val == "if":
                otherwise = self._parse_if()
            else:
                self.expect("punct", "{")
                otherwise = self.parse_expr()
                self.expect("punct", "}")
        return IfExpr(cond, then, otherwise)


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------

@dataclass
class _Scope:
    this: Any
    names: dict  # named contexts from captures
    lets: dict   # $vars


def _truthy(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    raise BlangEvalError(f"expected boolean, got {type(v).__name__}")


def _to_string(v: Any) -> str:
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isfinite(v) and v == int(v):
            return str(int(v))
        return repr(v)
    if v is None:
        return "null"
    raise BlangEvalError(f"cannot convert {type(v).__name__} to string")


class Environment:
    """An expression environment with registered global functions.

    Mirrors the role of the reference's custom Bloblang environment
    (pkg/rules/env.go:13-58).
    """

    def __init__(self) -> None:
        self._functions: dict[str, Callable[..., Any]] = {}

    def register_function(self, name: str, fn: Callable[..., Any]) -> None:
        self._functions[name] = fn

    def parse(self, src: str) -> "Executor":
        ast = _Parser(tokenize(src)).parse_mapping()
        return Executor(ast, self)


class Executor:
    """A compiled expression; query() evaluates it against input data."""

    def __init__(self, ast: Node, env: Environment):
        self._ast = ast
        self._env = env

    def query(self, data: Any) -> Any:
        scope = _Scope(this=data, names={}, lets={})
        return self._eval(self._ast, scope)

    # -- evaluation ---------------------------------------------------------

    def _eval(self, node: Node, s: _Scope) -> Any:
        m = getattr(self, "_eval_" + type(node).__name__, None)
        if m is None:
            raise BlangEvalError(f"unhandled node {type(node).__name__}")
        return m(node, s)

    def _eval_Lit(self, node: Lit, s: _Scope) -> Any:
        return node.val

    def _eval_ArrayLit(self, node: ArrayLit, s: _Scope) -> Any:
        return [self._eval(it, s) for it in node.items]

    def _eval_ObjectLit(self, node: ObjectLit, s: _Scope) -> Any:
        out = {}
        for k, v in node.items:
            key = self._eval(k, s)
            if not isinstance(key, str):
                raise BlangEvalError("object keys must be strings")
            out[key] = self._eval(v, s)
        return out

    def _eval_This(self, node: This, s: _Scope) -> Any:
        return s.this

    def _eval_NameRef(self, node: NameRef, s: _Scope) -> Any:
        if node.name in s.names:
            return s.names[node.name]
        return self._field(s.this, node.name)

    def _eval_VarRef(self, node: VarRef, s: _Scope) -> Any:
        if node.name not in s.lets:
            raise BlangEvalError(f"undefined variable ${node.name}")
        return s.lets[node.name]

    def _eval_Field(self, node: Field, s: _Scope) -> Any:
        return self._field(self._eval(node.base, s), node.name)

    @staticmethod
    def _field(base: Any, name: str) -> Any:
        if base is None:
            return None  # missing fields propagate null (caught by `|`)
        if isinstance(base, dict):
            return base.get(name)
        raise BlangEvalError(f"cannot access field {name!r} on {type(base).__name__}")

    def _eval_Index(self, node: Index, s: _Scope) -> Any:
        base = self._eval(node.base, s)
        idx = self._eval(node.index, s)
        if base is None:
            return None
        if isinstance(base, list):
            if not isinstance(idx, int) or isinstance(idx, bool):
                raise BlangEvalError("list index must be an integer")
            if -len(base) <= idx < len(base):
                return base[idx]
            raise BlangEvalError(f"index {idx} out of bounds")
        if isinstance(base, dict):
            if not isinstance(idx, str):
                raise BlangEvalError("map index must be a string")
            return base.get(idx)
        raise BlangEvalError(f"cannot index {type(base).__name__}")

    def _eval_Call(self, node: Call, s: _Scope) -> Any:
        fn = self._env._functions.get(node.name)
        if fn is None:
            raise BlangEvalError(f"unknown function {node.name!r}")
        args = [self._eval(a, s) for a in node.args]
        return fn(*args)

    def _eval_Capture(self, node: Capture, s: _Scope) -> Any:
        val = self._eval(node.base, s)
        inner = _Scope(this=s.this, names={**s.names, node.name: val}, lets=s.lets)
        return self._eval(node.body, inner)

    def _eval_IfExpr(self, node: IfExpr, s: _Scope) -> Any:
        if _truthy(self._eval(node.cond, s)):
            return self._eval(node.then, s)
        if node.otherwise is not None:
            return self._eval(node.otherwise, s)
        return None

    def _eval_Mapping(self, node: Mapping, s: _Scope) -> Any:
        lets = dict(s.lets)
        for name, expr in node.lets:
            lets[name] = self._eval(expr, _Scope(s.this, s.names, lets))
        return self._eval(node.result, _Scope(s.this, s.names, lets))

    def _eval_Unary(self, node: Unary, s: _Scope) -> Any:
        v = self._eval(node.operand, s)
        if node.op == "!":
            return not _truthy(v)
        if node.op == "-":
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise BlangEvalError("unary minus on non-number")
            return -v
        raise BlangEvalError(f"unknown unary op {node.op}")

    def _eval_BinOp(self, node: BinOp, s: _Scope) -> Any:
        op = node.op
        if op == "|":
            try:
                left = self._eval(node.left, s)
            except BlangEvalError:
                return self._eval(node.right, s)
            if left is None:
                return self._eval(node.right, s)
            return left
        if op == "&&":
            return _truthy(self._eval(node.left, s)) and _truthy(self._eval(node.right, s))
        if op == "||":
            return _truthy(self._eval(node.left, s)) or _truthy(self._eval(node.right, s))
        left = self._eval(node.left, s)
        right = self._eval(node.right, s)
        if op == "==":
            return self._eq(left, right)
        if op == "!=":
            return not self._eq(left, right)
        if op == "+":
            if isinstance(left, str) and isinstance(right, str):
                return left + right
            if self._both_numbers(left, right):
                return left + right
            if isinstance(left, list) and isinstance(right, list):
                return left + right
            raise BlangEvalError(
                f"cannot add {type(left).__name__} and {type(right).__name__}")
        if op in ("-", "*", "/", "%"):
            if not self._both_numbers(left, right):
                raise BlangEvalError(f"arithmetic on non-numbers ({op})")
            if op == "-":
                return left - right
            if op == "*":
                return left * right
            if op == "/":
                if right == 0:
                    raise BlangEvalError("division by zero")
                return left / right
            if right == 0:
                raise BlangEvalError("modulo by zero")
            return left % right
        if op in ("<", "<=", ">", ">="):
            if self._both_numbers(left, right) or (
                    isinstance(left, str) and isinstance(right, str)):
                return {"<": left < right, "<=": left <= right,
                        ">": left > right, ">=": left >= right}[op]
            raise BlangEvalError(f"cannot compare {type(left).__name__} and {type(right).__name__}")
        raise BlangEvalError(f"unknown operator {op}")

    @staticmethod
    def _both_numbers(a: Any, b: Any) -> bool:
        return (isinstance(a, (int, float)) and not isinstance(a, bool)
                and isinstance(b, (int, float)) and not isinstance(b, bool))

    @staticmethod
    def _eq(a: Any, b: Any) -> bool:
        if isinstance(a, bool) != isinstance(b, bool):
            return False
        return a == b

    # -- methods ------------------------------------------------------------

    def _eval_Method(self, node: Method, s: _Scope) -> Any:
        name = node.name
        if name in ("catch", "or"):
            # lazily evaluated: the fallback applies when the base errors
            # (catch/or) or resolves to null (or)
            if len(node.args) != 1:
                raise BlangEvalError(f"{name} expects 1 argument")
            try:
                base = self._eval(node.base, s)
            except BlangEvalError:
                return self._eval(node.args[0], s)
            if name == "or" and base is None:
                return self._eval(node.args[0], s)
            return base
        base = self._eval(node.base, s)

        if name in ("map_each", "filter"):
            if len(node.args) != 1:
                raise BlangEvalError(f"{name} expects 1 argument")
            if base is None:
                raise BlangEvalError(f"{name} on null")
            if not isinstance(base, list):
                raise BlangEvalError(f"{name} expects an array, got {type(base).__name__}")
            out = []
            for item in base:
                inner = _Scope(this=item, names=s.names, lets=s.lets)
                val = self._eval(node.args[0], inner)
                if name == "map_each":
                    out.append(val)
                elif _truthy(val):
                    out.append(item)
            return out

        arity = _METHOD_ARITY.get(name)
        if arity is None:
            raise BlangEvalError(f"unknown method {name!r}")
        lo, hi = arity
        if not (lo <= len(node.args) <= hi):
            raise BlangEvalError(
                f"{name} expects {lo if lo == hi else f'{lo}-{hi}'}"
                f" argument(s), got {len(node.args)}")
        args = [self._eval(a, s) for a in node.args]

        if name == "string":
            return _to_string(base)
        if name == "number":
            if isinstance(base, bool):
                raise BlangEvalError("cannot convert bool to number")
            if isinstance(base, (int, float)):
                return base
            if isinstance(base, str):
                try:
                    return int(base) if "." not in base else float(base)
                except ValueError as e:
                    raise BlangEvalError(f"cannot parse number from {base!r}") from e
            raise BlangEvalError(f"cannot convert {type(base).__name__} to number")
        if name == "length":
            if isinstance(base, (str, list, dict)):
                return len(base)
            raise BlangEvalError(f"length of {type(base).__name__}")
        if name == "uppercase":
            return self._str_method(base, str.upper)
        if name == "lowercase":
            return self._str_method(base, str.lower)
        if name == "trim":
            return self._str_method(base, str.strip)
        if name == "contains":
            if isinstance(base, str):
                return isinstance(args[0], str) and args[0] in base
            if isinstance(base, list):
                return any(self._eq(x, args[0]) for x in base)
            raise BlangEvalError(f"contains on {type(base).__name__}")
        if name in ("has_prefix", "has_suffix"):
            if not isinstance(args[0], str):
                raise BlangEvalError(f"{name} expects a string argument")
            if name == "has_prefix":
                return self._str_method(base, lambda x: x.startswith(args[0]))
            return self._str_method(base, lambda x: x.endswith(args[0]))
        if name == "split":
            if not isinstance(base, str) or not isinstance(args[0], str):
                raise BlangEvalError("split expects string.split(string)")
            if args[0] == "":
                return list(base)  # empty separator splits into characters
            return base.split(args[0])
        if name == "join":
            if not isinstance(base, list):
                raise BlangEvalError("join expects an array")
            sep = args[0] if args else ""
            if not all(isinstance(x, str) for x in base):
                raise BlangEvalError("join expects an array of strings")
            return sep.join(base)
        if name == "keys":
            if isinstance(base, dict):
                return sorted(base.keys())
            raise BlangEvalError("keys on non-map")
        if name == "values":
            if isinstance(base, dict):
                return [base[k] for k in sorted(base.keys())]
            raise BlangEvalError("values on non-map")
        if name == "sort":
            if isinstance(base, list):
                try:
                    return sorted(base)
                except TypeError as e:
                    raise BlangEvalError("cannot sort mixed-type array") from e
            raise BlangEvalError("sort on non-array")
        if name == "unique":
            if isinstance(base, list):
                seen, out = set(), []
                for x in base:
                    key = repr(x)
                    if key not in seen:
                        seen.add(key)
                        out.append(x)
                return out
            raise BlangEvalError("unique on non-array")
        if name == "slice":
            if not isinstance(base, (list, str)):
                raise BlangEvalError("slice on non-array/string")
            if not all(isinstance(a, int) and not isinstance(a, bool) for a in args):
                raise BlangEvalError("slice bounds must be integers")
            lo = args[0]
            hi = args[1] if len(args) == 2 else len(base)
            return base[lo:hi]
        if name == "exists":
            if isinstance(base, dict) and isinstance(args[0], str):
                return args[0] in base
            raise BlangEvalError("exists expects map.exists(string)")
        raise BlangEvalError(f"unknown method {name!r}")

    @staticmethod
    def _str_method(base: Any, fn: Callable[[str], Any]) -> Any:
        if not isinstance(base, str):
            raise BlangEvalError(f"string method on {type(base).__name__}")
        return fn(base)


# (min, max) argument counts for builtin methods; checked before dispatch so
# wrong-arity calls surface as BlangEvalError (catchable by `|`/.catch()).
_METHOD_ARITY = {
    "string": (0, 0), "number": (0, 0), "length": (0, 0),
    "uppercase": (0, 0), "lowercase": (0, 0), "trim": (0, 0),
    "keys": (0, 0), "values": (0, 0), "sort": (0, 0), "unique": (0, 0),
    "contains": (1, 1), "has_prefix": (1, 1), "has_suffix": (1, 1),
    "split": (1, 1), "join": (0, 1), "slice": (1, 2), "exists": (1, 1),
}
