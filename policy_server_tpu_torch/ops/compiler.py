"""IR → PyTorch lowering: each policy becomes a plain function over batched
feature tensors.

These functions are the plain version of the predicate body that the
``policy_matrix`` kernel interprets on the card (``ops/cuda_kernels.py``):
the CPU path runs them directly, and the kernel's tape is compiled from
the same IR with the same CSE keys and the same lowering rules, so the two
agree bit for bit.

Lowering rules (mirrored exactly by evaluation/oracle.py):
* every sub-expression lowers to ``(values, n_elem_axes)`` where values has
  shape ``(B, *axis_prefix)`` — element axes are appended in quantifier
  nesting order, so any two operands align by trailing-dim broadcast;
* comparisons fold validity masks: missing operands ⇒ False;
* AnyOf = ``any(pred & domain_mask)``; AllOf = ``all(pred | ~domain_mask)``;
  CountOf = ``sum(pred & domain_mask)``;
* no data-dependent control flow — everything is masked elementwise ops.

A policy program returns ``(allowed: bool(B,), rule_idx: int32(B,))`` where
rule_idx is the FIRST violated deny-rule (host side maps it to the message
template) or -1 when allowed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping

import torch

from policy_server_tpu_torch.ops import ir
from policy_server_tpu_torch.ops.codec import BATCH_KEY, FeatureSchema, mask_key_for
from policy_server_tpu_torch.ops.ir import CmpOp, DType, Expr, Path
from policy_server_tpu_torch.ops.optimizer import scoped_key
from policy_server_tpu_torch.utils.interning import InternTable

Features = Mapping[str, Any]

_TORCH_DTYPES = {
    DType.ID: torch.int32,
    DType.I32: torch.int32,
    DType.F32: torch.float32,
    DType.BOOL: torch.bool,
}


@dataclass
class Lowered:
    """A lowered sub-expression: shape (B, *axes[:naxes])."""

    values: Any
    naxes: int


def _align(a: Lowered, b: Lowered) -> tuple[Any, Any, int]:
    n = max(a.naxes, b.naxes)
    av, bv = a.values, b.values
    for _ in range(n - a.naxes):
        av = av[..., None]
    for _ in range(n - b.naxes):
        bv = bv[..., None]
    return av, bv, n


_CMP_FNS: dict[CmpOp, Callable[[Any, Any], Any]] = {
    CmpOp.EQ: lambda a, b: a == b,
    CmpOp.NE: lambda a, b: a != b,
    CmpOp.LT: lambda a, b: a < b,
    CmpOp.LE: lambda a, b: a <= b,
    CmpOp.GT: lambda a, b: a > b,
    CmpOp.GE: lambda a, b: a >= b,
}


def const_value(e: ir.Const, table: InternTable) -> Any:
    """The scalar a constant lowers to: an intern id for strings, else the
    value in its device dtype."""
    if e.dtype is DType.ID:
        return table.intern(e.value)
    if e.dtype is DType.F32:
        return float(e.value)
    if e.dtype is DType.I32:
        return int(e.value)
    return bool(e.value)


def inset_values(e: ir.InSet, table: InternTable) -> list:
    """The sorted members of an ``InSet`` as device scalars."""
    if e.dtype is DType.ID:
        return sorted(table.intern(v) for v in e.values)
    return sorted(e.values)


def lower_expr(
    expr: Expr,
    features: Features,
    table: InternTable,
    cse: dict | None = None,
    scalar_inset: bool = False,
) -> Any:
    """Lower a typechecked boolean IR expression to a ``(B,)`` bool tensor.

    ``stack`` is the enclosing-quantifier domain stack (ir.DomainStack),
    threaded through the traversal — the same IR node may be reused under
    different quantifiers, so scope is contextual, never keyed on node
    identity.

    ``cse`` is the optimizer's shared let-binding table: a per-call dict
    keyed by ``optimizer.scoped_key`` — identical scoped subtrees anywhere
    in the policy set lower to the SAME tensor. None disables sharing.

    A leaf whose validity mask the schema elided (``FeatureSpec.masked``
    False) lowers mask-free: the mask key is simply absent from
    ``features``.

    ``scalar_inset`` lowers ``InSet`` membership as an OR chain of scalar
    equality compares (the kernel's form) instead of one compare against
    a constant table. Identical results."""

    # constants are created on the features' device: an element axis
    # appended to a 0-dim CPU tensor would no longer mix with CUDA tensors
    device = features[BATCH_KEY].device

    def scalar(v: Any, dtype: DType) -> Any:
        return torch.tensor(v, dtype=_TORCH_DTYPES[dtype], device=device)

    def value_of(e: Expr, stack: ir.DomainStack) -> tuple[Lowered, Lowered | None]:
        """→ (values, validity-mask or None-if-always-valid)."""
        if cse is not None and not isinstance(e, ir.Const):
            memo_key = ("v", scoped_key(e, stack))
            hit = cse.get(memo_key)
            if hit is None:
                hit = cse[memo_key] = _value_of(e, stack)
            return hit
        return _value_of(e, stack)

    def _value_of(e: Expr, stack: ir.DomainStack) -> tuple[Lowered, Lowered | None]:
        if isinstance(e, ir.Const):
            return Lowered(scalar(const_value(e, table), e.dtype), 0), None
        if isinstance(e, (Path, ir.Elem)):
            p = ir.absolute_path(e, stack)
            key = f"{p.key()}:v:{p.dtype.value}"
            vals = features[key]
            mask_arr = features.get(mask_key_for(key))
            if mask_arr is None:
                # mask elided by the optimizer: every use of this column
                # is provably False at the zero-fill (see ops/optimizer)
                return Lowered(vals, p.n_stars), None
            return Lowered(vals, p.n_stars), Lowered(mask_arr, p.n_stars)
        # boolean/integer-valued nodes used as values
        return Lowered(bool_of(e, stack), _naxes_of(e, stack)), None

    def _naxes_of(e: Expr, stack: ir.DomainStack) -> int:
        # number of element axes of a lowered node at its own scope
        if isinstance(e, (Path, ir.Elem)):
            return ir.absolute_path(e, stack).n_stars
        if isinstance(e, ir.Exists):
            return ir.absolute_path(e.target, stack).n_stars
        if isinstance(e, ir.StrPred):
            return ir.absolute_path(e.operand, stack).n_stars
        if isinstance(e, ir.Not):
            return _naxes_of(e.operand, stack)
        if isinstance(e, (ir.And, ir.Or)):
            return max(_naxes_of(op, stack) for op in e.operands)
        if isinstance(e, ir.Cmp):
            return max(_naxes_of(e.lhs, stack), _naxes_of(e.rhs, stack))
        if isinstance(e, ir.InSet):
            return _naxes_of(e.operand, stack)
        if isinstance(e, (ir.AnyOf, ir.AllOf, ir.CountOf)):
            # the domain axis is reduced away
            return ir.absolute_path(e.over, stack).n_stars - 1
        if isinstance(e, ir.Const):
            return 0
        raise ir.IRError(f"unknown IR node {type(e).__name__}")

    def _quantifier_parts(e: Any, stack: ir.DomainStack) -> tuple[Any, Any]:
        """→ aligned (pred_values, domain_mask) for AnyOf/AllOf/CountOf."""
        dom = ir.absolute_path(e.over, stack)
        mask = features[f"{dom.key()}:p"]
        inner = stack + (dom,)
        pred = Lowered(bool_of(e.pred, inner), _naxes_of(e.pred, inner))
        m, pv, _ = _align(Lowered(mask, dom.n_stars), pred)
        return pv, m

    def bool_of(e: Expr, stack: ir.DomainStack) -> Any:
        if cse is not None and not isinstance(e, ir.Const):
            memo_key = ("b", scoped_key(e, stack))
            hit = cse.get(memo_key)
            if hit is None:
                hit = cse[memo_key] = _bool_of(e, stack)
            return hit
        return _bool_of(e, stack)

    def _bool_of(e: Expr, stack: ir.DomainStack) -> Any:
        if isinstance(e, ir.Const):
            return scalar(bool(e.value), DType.BOOL)
        if isinstance(e, ir.Exists):
            p = ir.absolute_path(e.target, stack)
            return features[f"{p.key()}:p"]
        if isinstance(e, ir.Not):
            return ~bool_of(e.operand, stack)
        if isinstance(e, (ir.And, ir.Or)):
            parts = [
                Lowered(bool_of(op, stack), _naxes_of(op, stack))
                for op in e.operands
            ]
            out = parts[0]
            is_and = isinstance(e, ir.And)
            for p in parts[1:]:
                a, b, n = _align(out, p)
                out = Lowered(a & b if is_and else a | b, n)
            return out.values
        if isinstance(e, ir.Cmp):
            lv, lm = value_of(e.lhs, stack)
            rv, rm = value_of(e.rhs, stack)
            a, b, n = _align(lv, rv)
            # int32 against float32 promotes to float32, as jnp does
            out = Lowered(_CMP_FNS[e.op](a, b), n)
            for m in (lm, rm):
                if m is not None:
                    mv, ov, n2 = _align(m, out)
                    out = Lowered(mv & ov, n2)
            return out.values
        if isinstance(e, ir.InSet):
            if not e.values:
                return scalar(False, DType.BOOL)
            ov, om = value_of(e.operand, stack)
            vals = inset_values(e, table)
            if scalar_inset:
                hits = ov.values == scalar(vals[0], e.dtype)
                for v in vals[1:]:
                    hits = hits | (ov.values == scalar(v, e.dtype))
            else:
                consts = torch.tensor(
                    vals, dtype=_TORCH_DTYPES[e.dtype], device=device
                )
                hits = (ov.values[..., None] == consts).any(dim=-1)
            out = Lowered(hits, ov.naxes)
            if om is not None:
                mv, hv, n = _align(om, out)
                out = Lowered(mv & hv, n)
            return out.values
        if isinstance(e, ir.StrPred):
            p = ir.absolute_path(e.operand, stack)
            return features[f"{p.key()}:sp:{e.key()}"]
        if isinstance(e, ir.AnyOf):
            pv, m = _quantifier_parts(e, stack)
            return (pv & m).any(dim=-1)
        if isinstance(e, ir.AllOf):
            pv, m = _quantifier_parts(e, stack)
            return (pv | ~m).all(dim=-1)
        if isinstance(e, ir.CountOf):
            pv, m = _quantifier_parts(e, stack)
            return (pv & m).sum(dim=-1, dtype=torch.int32)
        raise ir.IRError(f"cannot lower {type(e).__name__} as boolean")

    try:
        return bool_of(expr, ())
    finally:
        # the nested functions reach each other through their cells: a
        # cycle that would hold ``features`` and ``cse`` (tensors on the
        # card) until a garbage collection; emptying the cells frees them
        # with the call
        del value_of, _value_of, _naxes_of, _quantifier_parts, bool_of, _bool_of


# --------------------------------------------------------------------------
# Policy programs
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Rule:
    """One deny-rule of a policy: ``condition`` True ⇒ the rule is violated.
    ``message`` is a host-side template: str or fn(payload, settings) -> str
    (the device selects the rule index; the host materializes the text)."""

    name: str
    condition: Expr
    message: str | Callable[[Any], str]


@dataclass(frozen=True)
class PolicyProgram:
    """A policy bound to its settings: ordered deny rules + optional host
    mutator. ``allowed = not any(rule violated)``; the first violated rule
    selects the rejection message (rules are priority-ordered)."""

    rules: tuple[Rule, ...]
    # host-side mutation hook: fn(payload) -> list of JSONPatch ops or None.
    # Only consulted when the verdict is "allowed" and the policy mutates.
    mutator: Callable[[Any], list[dict] | None] | None = None
    # host-side pre-evaluation hook (latency-fault fixtures like the
    # 'sleeping' builtin). Runs before encoding.
    pre_eval_hook: Callable[[Any], None] | None = None
    # host-side context provider: fn(payload) -> {context_key: [objects]}
    # merged into the payload's __context__ slice at encode time (how
    # image-signature verification feeds its cached results to the device
    # program).
    context_provider: Callable[[Any], Mapping[str, list]] | None = None
    # host-executed policies (wasm modules): fn(payload) -> verdict dict.
    # Not served by this package yet; the environment refuses them.
    host_evaluator: Callable[[Any], Mapping[str, Any]] | None = None

    def typecheck(self) -> None:
        if not self.rules:
            raise ir.IRError("policy must define at least one rule")
        for r in self.rules:
            ir.typecheck(r.condition)

    def exprs(self) -> list[Expr]:
        return [r.condition for r in self.rules]


def compile_program(
    program: PolicyProgram,
    schema: FeatureSchema,
    table: InternTable,
    conditions: "tuple[Any, ...] | None" = None,
) -> Callable[..., tuple[Any, Any]]:
    """→ fn(features, cse=None, scalar_inset=False) -> (allowed (B,),
    rule_idx (B,) int32, -1 if allowed).

    ``conditions``: optimizer-folded per-rule conditions aligned with
    ``program.rules`` (indices never shift — the materializer maps
    ``rule_idx`` into the ORIGINAL rule tuple). A folded-constant
    condition lowers as a broadcast, so rule indices stay put."""
    conds = (
        conditions
        if conditions is not None
        else tuple(r.condition for r in program.rules)
    )
    if len(conds) != len(program.rules):
        raise ValueError("conditions must align with the program's rules")

    def fn(
        features: Features,
        cse: dict | None = None,
        scalar_inset: bool = False,
    ) -> tuple[Any, Any]:
        batch = features[BATCH_KEY].shape
        device = features[BATCH_KEY].device
        violated = torch.stack(
            [
                torch.broadcast_to(
                    lower_expr(
                        c, features, table, cse=cse,
                        scalar_inset=scalar_inset,
                    ).to(device),
                    batch,
                )
                for c in conds
            ],
            dim=-1,
        )  # (B, R)
        any_violated = violated.any(dim=-1)
        # argmax rejects bool; it returns the FIRST maximal index
        first = violated.to(torch.uint8).argmax(dim=-1).to(torch.int32)
        rule_idx = torch.where(
            any_violated, first, torch.tensor(-1, dtype=torch.int32)
        )
        return ~any_violated, rule_idx

    return fn


def compile_constant(
    allowed: bool, rule_idx: int
) -> Callable[..., tuple[Any, Any]]:
    """A policy whose verdict the optimizer folded to a constant: no
    predicate work, just two broadcasts. Output columns (and therefore
    materialized responses) are identical to the unoptimized program's."""

    def fn(
        features: Features,
        cse: dict | None = None,
        scalar_inset: bool = False,
    ) -> tuple[Any, Any]:
        batch = features[BATCH_KEY].shape
        device = features[BATCH_KEY].device
        return (
            torch.full(batch, bool(allowed), dtype=torch.bool, device=device),
            torch.full(batch, int(rule_idx), dtype=torch.int32, device=device),
        )

    return fn
