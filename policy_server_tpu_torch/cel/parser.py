"""CEL expression parser (the subset Kubernetes-style validation
expressions use).

Grammar (CEL spec precedence):
  ternary   :  or ('?' or ':' ternary)?
  or        :  and ('||' and)*
  and       :  rel ('&&' rel)*
  rel       :  add (('=='|'!='|'<'|'<='|'>'|'>='|'in') add)?
  add       :  mul (('+'|'-') mul)*
  mul       :  unary (('*'|'/'|'%') unary)*
  unary     :  ('!'|'-')* postfix
  postfix   :  primary ('.' IDENT ('(' args ')')? | '[' ternary ']')*
  primary   :  literal | IDENT ('(' args ')')? | '(' ternary ')' | list

Produces a small AST (dataclasses below) consumed by lower.py (→ IR for
the fused device program) and interp.py (host evaluation fallback).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


class CelParseError(ValueError):
    pass


# -- AST --------------------------------------------------------------------


@dataclass(frozen=True)
class Lit:
    value: Any


@dataclass(frozen=True)
class Ident:
    name: str


@dataclass(frozen=True)
class Select:
    base: Any
    field: str


@dataclass(frozen=True)
class Call:
    recv: Any  # None for global functions (size, has, ...)
    name: str
    args: tuple


@dataclass(frozen=True)
class Index:
    base: Any
    index: Any


@dataclass(frozen=True)
class Unary:
    op: str  # '!' | '-'
    operand: Any


@dataclass(frozen=True)
class Binary:
    op: str  # '||' '&&' '==' '!=' '<' '<=' '>' '>=' 'in' '+' '-' '*' '/' '%'
    lhs: Any
    rhs: Any


@dataclass(frozen=True)
class Ternary:
    cond: Any
    then: Any
    other: Any


@dataclass(frozen=True)
class ListLit:
    items: tuple


# -- tokenizer --------------------------------------------------------------

_TWO_CHAR = {"==", "!=", "<=", ">=", "&&", "||"}
_ONE_CHAR = set("()[]{},.?:!<>-+*/%")


def _tokenize(src: str) -> list[tuple[str, Any]]:
    out: list[tuple[str, Any]] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c.isspace():
            i += 1
            continue
        if src[i : i + 2] in _TWO_CHAR:
            out.append(("op", src[i : i + 2]))
            i += 2
            continue
        if c in ("'", '"'):
            j = i + 1
            buf: list[str] = []
            while j < n and src[j] != c:
                if src[j] == "\\" and j + 1 < n:
                    esc = src[j + 1]
                    buf.append(
                        {"n": "\n", "t": "\t", "r": "\r"}.get(esc, esc)
                    )
                    j += 2
                else:
                    buf.append(src[j])
                    j += 1
            if j >= n:
                raise CelParseError(f"unterminated string at {i}")
            out.append(("str", "".join(buf)))
            i = j + 1
            continue
        if c.isdigit():
            j = i
            while j < n and (src[j].isdigit() or src[j] == "."):
                j += 1
            text = src[i:j]
            if text.count(".") > 1:
                raise CelParseError(f"bad number {text!r}")
            out.append(("num", float(text) if "." in text else int(text)))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            if word in ("true", "false"):
                out.append(("bool", word == "true"))
            elif word == "null":
                out.append(("null", None))
            elif word == "in":
                out.append(("op", "in"))
            else:
                out.append(("ident", word))
            i = j
            continue
        if c in _ONE_CHAR:
            out.append(("op", c))
            i += 1
            continue
        raise CelParseError(f"unexpected character {c!r} at {i}")
    return out


# -- parser -----------------------------------------------------------------


class _Parser:
    def __init__(self, tokens: list[tuple[str, Any]]):
        self.toks = tokens
        self.pos = 0

    def peek(self) -> tuple[str, Any] | None:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> tuple[str, Any]:
        tok = self.peek()
        if tok is None:
            raise CelParseError("unexpected end of expression")
        self.pos += 1
        return tok

    def expect(self, op: str) -> None:
        tok = self.next()
        if tok != ("op", op):
            raise CelParseError(f"expected {op!r}, got {tok!r}")

    def at_op(self, *ops: str) -> str | None:
        tok = self.peek()
        if tok and tok[0] == "op" and tok[1] in ops:
            return tok[1]
        return None

    # -- grammar ------------------------------------------------------------

    def ternary(self):
        cond = self.or_()
        if self.at_op("?"):
            self.next()
            then = self.or_()
            self.expect(":")
            other = self.ternary()
            return Ternary(cond, then, other)
        return cond

    def or_(self):
        node = self.and_()
        while self.at_op("||"):
            self.next()
            node = Binary("||", node, self.and_())
        return node

    def and_(self):
        node = self.rel()
        while self.at_op("&&"):
            self.next()
            node = Binary("&&", node, self.rel())
        return node

    def rel(self):
        node = self.add()
        op = self.at_op("==", "!=", "<", "<=", ">", ">=", "in")
        if op:
            self.next()
            node = Binary(op, node, self.add())
        return node

    def add(self):
        node = self.mul()
        while True:
            op = self.at_op("+", "-")
            if not op:
                return node
            self.next()
            node = Binary(op, node, self.mul())

    def mul(self):
        node = self.unary()
        while True:
            op = self.at_op("*", "/", "%")
            if not op:
                return node
            self.next()
            node = Binary(op, node, self.unary())

    def unary(self):
        op = self.at_op("!", "-")
        if op:
            self.next()
            return Unary(op, self.unary())
        return self.postfix()

    def postfix(self):
        node = self.primary()
        while True:
            if self.at_op("."):
                self.next()
                kind, name = self.next()
                if kind != "ident":
                    raise CelParseError(f"expected field name, got {name!r}")
                if self.at_op("("):
                    node = Call(node, name, self.args())
                else:
                    node = Select(node, name)
            elif self.at_op("["):
                self.next()
                idx = self.ternary()
                self.expect("]")
                node = Index(node, idx)
            else:
                return node

    def args(self) -> tuple:
        self.expect("(")
        items = []
        if not self.at_op(")"):
            items.append(self.ternary())
            while self.at_op(","):
                self.next()
                items.append(self.ternary())
        self.expect(")")
        return tuple(items)

    def primary(self):
        tok = self.next()
        kind, value = tok
        if kind in ("str", "num", "bool", "null"):
            return Lit(value)
        if kind == "ident":
            if self.at_op("("):
                return Call(None, value, self.args())
            return Ident(value)
        if tok == ("op", "("):
            node = self.ternary()
            self.expect(")")
            return node
        if tok == ("op", "["):
            items = []
            if not self.at_op("]"):
                items.append(self.ternary())
                while self.at_op(","):
                    self.next()
                    items.append(self.ternary())
            self.expect("]")
            return ListLit(tuple(items))
        raise CelParseError(f"unexpected token {tok!r}")


def parse(src: str):
    """CEL source → AST; raises CelParseError."""
    if not isinstance(src, str) or not src.strip():
        raise CelParseError("empty expression")
    parser = _Parser(_tokenize(src))
    node = parser.ternary()
    if parser.peek() is not None:
        raise CelParseError(f"trailing tokens from {parser.peek()!r}")
    return node
