"""Predicate-program optimizer: cross-policy CSE, constant folding, and
dead-field pruning over the predicate IR (ROADMAP item 3 stretch goal,
round 15).

The naive lowering compiles every policy's rules as an independent
subgraph even though a realistic policy set re-derives the same field
gathers and comparison subtrees dozens of times per batch (the flagship
32-policy set carries pod-privileged three times, disallow-latest twice,
and three safe-labels entries with identical mandatory-label rules). The
optimizer runs BEFORE lowering, purely structurally — no float
re-association, no value rewrites — so bit-exactness against the
unoptimized program and the host oracle is provable, not hoped:

* **CSE** — every sub-expression gets a *scoped canonical key*
  (structure + absolute leaf paths under the enclosing quantifier domain
  stack). Identical keys are the same computation; the compiler lowers
  each distinct key once per fused program through a shared let-binding
  table (``ops/compiler.py`` ``cse=`` memo) instead of once per policy.

* **Constant folding** — boolean identities (``And``/``Or`` absorb and
  drop constant operands, ``Not`` of a constant folds), ``Cmp``/``InSet``
  over constants evaluate exactly (one comparison of two constants —
  nothing is re-associated), quantifiers over constant predicates fold
  (``AnyOf(d, False) → False``, ``AllOf(d, True) → True``,
  ``CountOf(d, False) → 0``). Rules ordered after an always-violated
  rule can never be the FIRST violated rule, so their conditions fold to
  ``False``; a policy whose every rule folds to a constant has a
  constant verdict and drops out of the device program entirely (the
  environment broadcasts the constant — audit/metrics/report rows are
  unchanged, the compute is gone).

* **Validity-mask elision** (folding against the schema bucket's
  zero-fill) — the codec encodes a missing/mismatched leaf as
  ``value = 0`` with ``mask = False`` (ops/codec.py ``_convert``), and
  the compiler lowers ``Cmp``/``InSet`` as ``cmp(value, const) & mask``.
  When the comparison is provably False AT THE ZERO-FILL — ``x == True``
  on a bool lane, ``x > 10`` on a zero-filled number, any ID
  equality/membership (real intern ids start at 1; 0 is the reserved
  MISSING id) — the mask term is pointwise redundant for every encodable
  input, so the comparison lowers mask-free. A value column whose every
  use is mask-free drops its ``:m:`` column from the feature schema.

* **Dead-field pruning** — the feature schema is built from the
  *surviving* (folded) expressions only: fields read exclusively by
  folded-away subtrees lose their gather columns, and the elided
  validity masks above drop theirs. Composing with the round-12
  columnar transport, pruned columns are bytes that never ship.

The pass is per-environment (it re-runs for every reload candidate
epoch) and reports its work through ``EvaluationEnvironment.
optimizer_stats`` → ``runtime_stats`` → /metrics + OTLP.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np

from policy_server_tpu_torch.ops import ir
from policy_server_tpu_torch.ops.ir import (
    CmpOp,
    Const,
    DType,
    Elem,
    Expr,
    Path,
)

# numpy dtypes of the zero-fill the codec writes for a missing leaf
# (ops/codec.py zero-initializes every buffer; _convert only writes when
# the JSON value is well-typed)
_ZERO_FILL = {
    DType.ID: np.int32(0),
    DType.I32: np.int32(0),
    DType.F32: np.float32(0.0),
    DType.BOOL: np.bool_(False),
}

_CMP_NP = {
    CmpOp.EQ: lambda a, b: a == b,
    CmpOp.NE: lambda a, b: a != b,
    CmpOp.LT: lambda a, b: a < b,
    CmpOp.LE: lambda a, b: a <= b,
    CmpOp.GT: lambda a, b: a > b,
    CmpOp.GE: lambda a, b: a >= b,
}


# ---------------------------------------------------------------------------
# Scoped canonical keys (the CSE identity)
# ---------------------------------------------------------------------------


def scoped_key(e: Expr, stack: ir.DomainStack = ()) -> tuple:
    """Structural identity of a sub-expression UNDER its quantifier
    scope: two nodes with equal keys compute the same value over the
    same feature columns, regardless of which policy they appear in.
    Leaves resolve to absolute paths (``ir.absolute_path``), so the same
    ``Elem`` shape under different domains gets different keys."""
    if isinstance(e, Const):
        return ("const", e.dtype.value, e.value)
    if isinstance(e, (Path, Elem)):
        p = ir.absolute_path(e, stack)
        return ("leaf", p.key(), p.dtype.value)
    if isinstance(e, ir.Exists):
        return ("exists", ir.absolute_path(e.target, stack).key())
    if isinstance(e, ir.Not):
        return ("not", scoped_key(e.operand, stack))
    if isinstance(e, (ir.And, ir.Or)):
        tag = "and" if isinstance(e, ir.And) else "or"
        return (tag,) + tuple(scoped_key(op, stack) for op in e.operands)
    if isinstance(e, ir.Cmp):
        return (
            "cmp", e.op.value,
            scoped_key(e.lhs, stack), scoped_key(e.rhs, stack),
        )
    if isinstance(e, ir.InSet):
        return (
            "inset", e.dtype.value, scoped_key(e.operand, stack),
            tuple(sorted(e.values, key=repr)),
        )
    if isinstance(e, ir.StrPred):
        p = ir.absolute_path(e.operand, stack)
        return ("strpred", p.key(), e.kind, e.pattern)
    if isinstance(e, ir.Quantifier):
        dom = ir.absolute_path(e.over, stack)
        tag = {"AnyOf": "any", "AllOf": "all", "CountOf": "count"}[
            type(e).__name__
        ]
        return (tag, dom.key(), scoped_key(e.pred, stack + (dom,)))
    raise ir.IRError(f"unknown IR node {type(e).__name__}")


# ---------------------------------------------------------------------------
# Constant folding (structural; no value rewrites)
# ---------------------------------------------------------------------------


def _const_bool(v: bool) -> Const:
    return Const(bool(v), DType.BOOL)


def _np_const(e: Const) -> Any:
    if e.dtype is DType.F32:
        return np.float32(e.value)
    if e.dtype is DType.I32:
        return np.int32(e.value)
    if e.dtype is DType.BOOL:
        return np.bool_(e.value)
    return e.value  # ID: python string — EQ/NE only, exact


def _fold_cmp_consts(op: CmpOp, lhs: Const, rhs: Const) -> Const:
    """Exact evaluation of one comparison of two constants — performed
    with the SAME numpy dtypes the device comparison would use, so no
    re-association and no precision drift."""
    if lhs.dtype is DType.ID or rhs.dtype is DType.ID:
        # string constants compare as strings (intern-id equality is
        # string equality for non-missing operands)
        res = lhs.value == rhs.value
        return _const_bool(res if op is CmpOp.EQ else not res)
    return _const_bool(bool(_CMP_NP[op](_np_const(lhs), _np_const(rhs))))


def fold_expr(e: Expr) -> Expr:
    """Bottom-up structural constant folding. Returns ``e`` itself when
    nothing folds (identity is preserved so CSE keys stay shared)."""
    if isinstance(e, (Const, Path, Elem, ir.Exists, ir.StrPred)):
        return e
    if isinstance(e, ir.Not):
        op = fold_expr(e.operand)
        if isinstance(op, Const):
            return _const_bool(not op.value)
        return e if op is e.operand else ir.Not(op)
    if isinstance(e, (ir.And, ir.Or)):
        is_and = isinstance(e, ir.And)
        absorbing, neutral = (False, True) if is_and else (True, False)
        kept: list[Expr] = []
        changed = False
        for op in e.operands:
            f = fold_expr(op)
            changed = changed or f is not op
            if isinstance(f, Const):
                changed = True
                if bool(f.value) == absorbing:
                    return _const_bool(absorbing)
                continue  # neutral element drops
            kept.append(f)
        if not kept:
            return _const_bool(neutral)
        if not changed:
            return e
        if len(kept) == 1:
            return kept[0]
        return ir.And(tuple(kept)) if is_and else ir.Or(tuple(kept))
    if isinstance(e, ir.Cmp):
        lhs, rhs = fold_expr(e.lhs), fold_expr(e.rhs)
        if isinstance(lhs, Const) and isinstance(rhs, Const):
            return _fold_cmp_consts(e.op, lhs, rhs)
        if lhs is e.lhs and rhs is e.rhs:
            return e
        return ir.Cmp(e.op, lhs, rhs)
    if isinstance(e, ir.InSet):
        if not e.values:
            return _const_bool(False)
        op = fold_expr(e.operand)
        if isinstance(op, Const):
            # membership with the DEVICE dtype semantics, not Python
            # object equality: the lowered form compares after numpy
            # casts (e.g. two doubles distinct in Python may round to
            # the same f32), and the fold must agree bit-exactly
            if e.dtype is DType.F32:
                member = any(
                    np.float32(op.value) == np.float32(v)
                    for v in e.values
                )
            elif e.dtype is DType.I32:
                member = any(
                    np.int32(op.value) == np.int32(v) for v in e.values
                )
            elif e.dtype is DType.BOOL:
                member = bool(op.value) in {bool(v) for v in e.values}
            else:  # ID: intern-id equality is string equality
                member = op.value in e.values
            return _const_bool(member)
        return e if op is e.operand else ir.InSet(op, e.values, e.dtype)
    if isinstance(e, ir.Quantifier):
        pred = fold_expr(e.pred)
        if isinstance(pred, Const):
            if isinstance(e, ir.AnyOf) and not pred.value:
                return _const_bool(False)
            if isinstance(e, ir.AllOf) and pred.value:
                return _const_bool(True)
            if isinstance(e, ir.CountOf) and not pred.value:
                return Const(0, DType.I32)
            # AnyOf(d, True) / AllOf(d, False) / CountOf(d, True) depend
            # on the domain size — not foldable structurally
        if pred is e.pred:
            return e
        return type(e)(e.over, pred)
    raise ir.IRError(f"unknown IR node {type(e).__name__}")


# ---------------------------------------------------------------------------
# Validity-mask requirement analysis (zero-fill folding)
# ---------------------------------------------------------------------------


def _value_key(p: Path) -> str:
    return f"{p.key()}:v:{p.dtype.value}"


def _leaf_of(e: Expr) -> "Path | Elem | None":
    return e if isinstance(e, (Path, Elem)) else None


def _cmp_needs_mask(op: CmpOp, leaf: "Path | Elem", other: Expr) -> bool:
    """Does ``cmp(leaf, other)`` need the leaf's validity mask? Not when
    the comparison is provably False at the leaf's zero-fill — then a
    missing/mismatched leaf already yields False without the mask
    (pointwise identical for every encodable input, because the codec
    guarantees value==0 wherever mask==0)."""
    if not isinstance(other, Const):
        return True  # leaf-vs-leaf / leaf-vs-CountOf: keep the mask
    if leaf.dtype is DType.ID:
        # intern ids of real strings start at 1; MISSING is the reserved
        # id 0, so equality with any constant string is False when
        # missing. Inequality is True at zero-fill → mask required.
        return op is not CmpOp.EQ
    zero = _ZERO_FILL[leaf.dtype]
    return bool(_CMP_NP[op](zero, _np_const(other)))


def _inset_needs_mask(e: "ir.InSet") -> bool:
    if e.dtype is DType.ID:
        return False  # MISSING_ID can never be an interned member
    if e.dtype is DType.F32:
        return any(np.float32(0.0) == np.float32(v) for v in e.values)
    if e.dtype is DType.I32:
        return 0 in e.values
    return False in e.values  # BOOL


def _scan_mask_uses(
    e: Expr,
    stack: ir.DomainStack,
    all_keys: set[str],
    required: set[str],
) -> None:
    """Collect every value-spec key and the subset whose mask some use
    still requires."""

    def leaf_use(leaf: "Path | Elem", needs_mask: bool) -> None:
        key = _value_key(ir.absolute_path(leaf, stack))
        all_keys.add(key)
        if needs_mask:
            required.add(key)

    if isinstance(e, (Path, Elem)):
        # bare leaf used as a value outside Cmp/InSet (no known lowering
        # produces this, but stay conservative)
        leaf_use(e, True)
        return
    if isinstance(e, ir.Cmp):
        lhs_leaf, rhs_leaf = _leaf_of(e.lhs), _leaf_of(e.rhs)
        if lhs_leaf is not None:
            leaf_use(lhs_leaf, _cmp_needs_mask(e.op, lhs_leaf, e.rhs))
        else:
            _scan_mask_uses(e.lhs, stack, all_keys, required)
        if rhs_leaf is not None:
            # mirror the comparison so the zero-fill sits on the leaf side
            mirrored = {
                CmpOp.LT: CmpOp.GT, CmpOp.GT: CmpOp.LT,
                CmpOp.LE: CmpOp.GE, CmpOp.GE: CmpOp.LE,
            }.get(e.op, e.op)
            leaf_use(rhs_leaf, _cmp_needs_mask(mirrored, rhs_leaf, e.lhs))
        else:
            _scan_mask_uses(e.rhs, stack, all_keys, required)
        return
    if isinstance(e, ir.InSet):
        leaf = _leaf_of(e.operand)
        if leaf is not None:
            leaf_use(leaf, _inset_needs_mask(e))
        else:
            _scan_mask_uses(e.operand, stack, all_keys, required)
        return
    if isinstance(e, (Const, ir.Exists, ir.StrPred)):
        return
    if isinstance(e, ir.Not):
        _scan_mask_uses(e.operand, stack, all_keys, required)
        return
    if isinstance(e, (ir.And, ir.Or)):
        for op in e.operands:
            _scan_mask_uses(op, stack, all_keys, required)
        return
    if isinstance(e, ir.Quantifier):
        dom = ir.absolute_path(e.over, stack)
        _scan_mask_uses(e.pred, stack + (dom,), all_keys, required)
        return
    raise ir.IRError(f"unknown IR node {type(e).__name__}")


# ---------------------------------------------------------------------------
# The policy-set pass
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PolicyOptimization:
    """One policy's folded form: per-rule conditions aligned with the
    ORIGINAL rule tuple (indices never shift — the materializer maps
    ``rule_idx`` back into ``program.rules``), plus the constant verdict
    when every rule folded."""

    conditions: tuple[Expr, ...]
    constant: "tuple[bool, int] | None" = None  # (allowed, rule_idx)


@dataclass
class SetOptimization:
    policies: dict[str, PolicyOptimization] = field(default_factory=dict)
    # folded conditions of non-constant policies — the schema builds
    # from exactly these, so dead fields never get columns
    surviving_exprs: list[Expr] = field(default_factory=list)
    # value-spec keys whose ':m:' mask column is provably redundant
    unmasked_value_keys: frozenset = frozenset()
    # distinct non-trivial scoped keys appearing in >1 place
    subtrees_shared: int = 0
    policies_folded: int = 0
    rules_folded: int = 0


def _count_shared(conditions_by_policy: Mapping[str, tuple[Expr, ...]]) -> int:
    """Distinct non-trivial (non-leaf, non-const) scoped keys occurring
    more than once across the whole set — the subtrees the CSE table
    will compute once instead of N times."""
    seen: dict[tuple, int] = {}

    def visit(e: Expr, stack: ir.DomainStack) -> None:
        if not isinstance(e, (Const, Path, Elem)):
            k = scoped_key(e, stack)
            seen[k] = seen.get(k, 0) + 1
        if isinstance(e, (ir.Not,)):
            visit(e.operand, stack)
        elif isinstance(e, (ir.And, ir.Or)):
            for op in e.operands:
                visit(op, stack)
        elif isinstance(e, ir.Cmp):
            visit(e.lhs, stack)
            visit(e.rhs, stack)
        elif isinstance(e, ir.InSet):
            visit(e.operand, stack)
        elif isinstance(e, ir.Quantifier):
            dom = ir.absolute_path(e.over, stack)
            visit(e.pred, stack + (dom,))

    for conds in conditions_by_policy.values():
        for c in conds:
            visit(c, ())
    return sum(1 for n in seen.values() if n > 1)


def fold_policy(conditions: tuple[Expr, ...]) -> PolicyOptimization:
    """Fold one policy's rule conditions. First-violated semantics: a
    rule after an always-violated rule can never be selected, so its
    condition folds to False; all-constant conditions give the policy a
    constant verdict."""
    folded = [fold_expr(c) for c in conditions]
    # rules after the first constant-True rule are unreachable
    for i, c in enumerate(folded):
        if isinstance(c, Const) and bool(c.value):
            folded[i + 1 :] = [
                _const_bool(False) for _ in folded[i + 1 :]
            ]
            break
    constant: tuple[bool, int] | None = None
    if all(isinstance(c, Const) for c in folded):
        rule_idx = next(
            (i for i, c in enumerate(folded) if bool(c.value)), -1
        )
        constant = (rule_idx == -1, rule_idx)
    return PolicyOptimization(tuple(folded), constant)


def optimize_policy_set(
    programs: Mapping[str, Any],  # pid -> PolicyProgram
) -> SetOptimization:
    """Run the full pass over a bound policy set. ``programs`` maps
    policy id → ``ops.compiler.PolicyProgram``."""
    out = SetOptimization()
    conditions_by_policy: dict[str, tuple[Expr, ...]] = {}
    for pid, program in programs.items():
        po = fold_policy(tuple(r.condition for r in program.rules))
        out.policies[pid] = po
        out.rules_folded += sum(
            1
            for orig, cond in zip(program.rules, po.conditions)
            if isinstance(cond, Const)
            and not isinstance(orig.condition, Const)
        )
        if po.constant is not None:
            out.policies_folded += 1
            continue
        conditions_by_policy[pid] = po.conditions
        out.surviving_exprs.extend(
            c for c in po.conditions if not isinstance(c, Const)
        )
    out.subtrees_shared = _count_shared(conditions_by_policy)

    all_keys: set[str] = set()
    required: set[str] = set()
    for e in out.surviving_exprs:
        _scan_mask_uses(e, (), all_keys, required)
    out.unmasked_value_keys = frozenset(all_keys - required)
    return out
