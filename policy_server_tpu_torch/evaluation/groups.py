"""Policy-group boolean expressions: parser, boot-time type check, and
masked batched lowering.

Reference parity: the Rhai-based ``PolicyGroupEvaluator`` (SURVEY.md §2.2;
src/evaluation/evaluation_environment.rs:596-651):

* grammar — member names as 0-ary calls composed with ``&&``, ``||``, ``!``,
  parentheses, and ``true``/``false`` literals
  (policies.yml.example: ``sigstore_pgp() || (sigstore_gh_action() &&
  reject_latest_tag())``);
* the expression must type-check to bool at boot against the member set
  (evaluation_environment.rs:1075-1112);
* rejection aggregates per-member causes under ``spec.policies.<member>``
  (evaluation_environment.rs:984-994);
* short-circuit semantics: members skipped by ``&&``/``||`` short-circuiting
  produce no causes (evaluation_environment.rs:996-999).

Batched lowering: evaluation computes *every* member's verdict, then
derives the group verdict with elementwise boolean tensor ops and — to
stay bit-exact on cause reporting — an "evaluated" mask per member that
replays left-to-right short-circuit semantics as masked boolean algebra
(no data-dependent control flow).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Mapping

import torch


class ExpressionError(ValueError):
    """Boot-time expression failure (parse error, unknown member, non-bool
    result) — a policy-initialization error, like the reference's Rhai
    type-check failures."""


# -- AST -------------------------------------------------------------------


@dataclass(frozen=True)
class MemberCall:
    name: str


@dataclass(frozen=True)
class BoolLit:
    value: bool


@dataclass(frozen=True)
class NotExpr:
    operand: Any


@dataclass(frozen=True)
class AndExpr:
    lhs: Any
    rhs: Any


@dataclass(frozen=True)
class OrExpr:
    lhs: Any
    rhs: Any


_TOKEN_RE = re.compile(
    r"\s*(?:(?P<and>&&)|(?P<or>\|\|)|(?P<not>!)|(?P<lpar>\()|(?P<rpar>\))"
    r"|(?P<ident>[A-Za-z_][A-Za-z0-9_]*)\s*\(\s*\)"
    r"|(?P<lit>true|false)(?![A-Za-z0-9_])"
    r")"
)


def tokenize(expression: str) -> list[tuple[str, str]]:
    tokens: list[tuple[str, str]] = []
    pos = 0
    while pos < len(expression):
        if expression[pos:].strip() == "":
            break
        # literals must be tried before ident+() — handle by ordering checks
        m = re.match(r"\s*(true|false)(?![A-Za-z0-9_(])", expression[pos:])
        if m:
            tokens.append(("lit", m.group(1)))
            pos += m.end()
            continue
        m = _TOKEN_RE.match(expression, pos)
        if not m or m.end() == pos:
            raise ExpressionError(
                f"invalid token in expression at offset {pos}: {expression[pos:pos+20]!r}"
            )
        kind = m.lastgroup
        if kind == "ident":
            tokens.append(("member", m.group("ident")))
        elif kind == "lit":
            tokens.append(("lit", m.group("lit")))
        else:
            tokens.append((kind, m.group(0).strip()))
        pos = m.end()
    return tokens


def parse_expression(expression: str) -> Any:
    """Recursive-descent parse: or → and → unary → primary."""
    tokens = tokenize(expression)
    idx = 0

    def peek() -> tuple[str, str] | None:
        return tokens[idx] if idx < len(tokens) else None

    def take(kind: str) -> tuple[str, str]:
        nonlocal idx
        tok = peek()
        if tok is None or tok[0] != kind:
            raise ExpressionError(f"expected {kind}, got {tok} in {expression!r}")
        idx += 1
        return tok

    def parse_or() -> Any:
        node = parse_and()
        while (tok := peek()) and tok[0] == "or":
            take("or")
            node = OrExpr(node, parse_and())
        return node

    def parse_and() -> Any:
        node = parse_unary()
        while (tok := peek()) and tok[0] == "and":
            take("and")
            node = AndExpr(node, parse_unary())
        return node

    def parse_unary() -> Any:
        tok = peek()
        if tok and tok[0] == "not":
            take("not")
            return NotExpr(parse_unary())
        return parse_primary()

    def parse_primary() -> Any:
        tok = peek()
        if tok is None:
            raise ExpressionError(f"unexpected end of expression: {expression!r}")
        if tok[0] == "lpar":
            take("lpar")
            node = parse_or()
            take("rpar")
            return node
        if tok[0] == "member":
            take("member")
            return MemberCall(tok[1])
        if tok[0] == "lit":
            take("lit")
            return BoolLit(tok[1] == "true")
        raise ExpressionError(f"unexpected token {tok} in {expression!r}")

    node = parse_or()
    if idx != len(tokens):
        raise ExpressionError(
            f"trailing tokens in expression {expression!r}: {tokens[idx:]}"
        )
    return node


def referenced_members(ast: Any) -> set[str]:
    if isinstance(ast, MemberCall):
        return {ast.name}
    if isinstance(ast, NotExpr):
        return referenced_members(ast.operand)
    if isinstance(ast, (AndExpr, OrExpr)):
        return referenced_members(ast.lhs) | referenced_members(ast.rhs)
    return set()


def validate_expression(expression: str, member_names: set[str]) -> Any:
    """Boot-time validation (reference: Rhai type-check to bool,
    evaluation_environment.rs:1075-1112 test matrix)."""
    ast = parse_expression(expression)
    unknown = referenced_members(ast) - member_names
    if unknown:
        raise ExpressionError(
            f"expression references unknown policies: {sorted(unknown)}"
        )
    return ast


# -- lowering --------------------------------------------------------------


def lower_group(
    ast: Any,
    member_allowed: Mapping[str, Any],
) -> tuple[Any, dict[str, Any]]:
    """Batched lowering: member verdict bits (each ``(B,)`` bool) → the
    group verdict plus per-member "was evaluated under short-circuit
    semantics" masks.

    Masks replay Rhai's left-to-right semantics: in ``a && b``, b is only
    evaluated where a is true; in ``a || b``, only where a is false. All
    members are *computed* (batching), but causes are reported only where
    evaluated — bit-exact with the reference (SURVEY.md §7.4 #6).
    """
    evaluated: dict[str, Any] = {}

    def rec(node: Any, active: Any) -> Any:
        if isinstance(node, BoolLit):
            return torch.tensor(node.value)
        if isinstance(node, MemberCall):
            bits = member_allowed[node.name]
            mask = active & torch.ones_like(bits, dtype=torch.bool)
            if node.name in evaluated:
                evaluated[node.name] = evaluated[node.name] | mask
            else:
                evaluated[node.name] = mask
            return bits
        if isinstance(node, NotExpr):
            return ~rec(node.operand, active)
        if isinstance(node, AndExpr):
            lhs = rec(node.lhs, active)
            rhs = rec(node.rhs, active & lhs)
            return lhs & rhs
        if isinstance(node, OrExpr):
            lhs = rec(node.lhs, active)
            rhs = rec(node.rhs, active & ~lhs)
            return lhs | rhs
        raise ExpressionError(f"unknown expression node {type(node).__name__}")

    try:
        verdict = rec(ast, torch.tensor(True))
    finally:
        # ``rec`` reaches itself through its cell: a cycle that would hold
        # the member bits (tensors on the card) until a garbage collection
        del rec
    return verdict, evaluated


def evaluate_group_host(ast: Any, member_allowed: Mapping[str, bool]) -> tuple[bool, dict[str, bool]]:
    """Host (oracle) evaluation with true short-circuiting — returns
    (verdict, evaluated-members map). Must agree with lower_group exactly."""
    evaluated: dict[str, bool] = {}

    def rec(node: Any) -> bool:
        if isinstance(node, BoolLit):
            return node.value
        if isinstance(node, MemberCall):
            evaluated[node.name] = True
            return bool(member_allowed[node.name])
        if isinstance(node, NotExpr):
            return not rec(node.operand)
        if isinstance(node, AndExpr):
            return rec(node.lhs) and rec(node.rhs)
        if isinstance(node, OrExpr):
            return rec(node.lhs) or rec(node.rhs)
        raise ExpressionError(f"unknown expression node {type(node).__name__}")

    return rec(ast), evaluated
