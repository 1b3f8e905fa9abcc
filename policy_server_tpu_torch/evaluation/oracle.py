"""Host-side IR interpreter: the bit-exact correctness oracle.

Stands in for the reference's wasmtime execution path
(src/evaluation/evaluation_environment.rs:546-581) the way BASELINE.json's
north star keeps "the WASM path as correctness oracle": every IR construct is
interpreted directly over the raw JSON payload with semantics that mirror
ops/compiler.py exactly —

* comparisons / string-preds on missing or type-mismatched leaves are False,
* AnyOf over empty/missing arrays is False, AllOf is True, CountOf is 0,
* leaf typing matches ops/codec.py's ``_convert`` (bools are not numbers,
  null is missing).

It is also the escape hatch for requests whose arrays overflow the feature
schema's axis caps (ops/codec.py SchemaOverflow), and the differential-test
reference: tests assert jax-backend verdicts == oracle verdicts on the same
corpus (SURVEY.md §4 implication).
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping

from policy_server_tpu_torch.ops import ir
from policy_server_tpu_torch.ops.codec import star_elements
from policy_server_tpu_torch.ops.compiler import PolicyProgram
from policy_server_tpu_torch.ops.ir import CmpOp, DType, Expr, Path, STAR

_MISSING = object()

_STR_PRED_CACHE: dict[tuple[str, str], Any] = {}


def _cached_str_pred(kind: str, pattern: str):
    key = (kind, pattern)
    fn = _STR_PRED_CACHE.get(key)
    if fn is None:
        fn = _STR_PRED_CACHE[key] = ir.build_str_pred(kind, pattern)
    return fn


def _walk_path(payload: Any, segments: tuple[str, ...]) -> Iterator[Any]:
    """Yield every JSON value the path reaches (0 or more; wildcards fan
    out). Missing branches yield nothing. Wildcard element semantics are
    shared with the codec (ops.codec.star_elements): lists yield items, maps
    yield {__key__, __value__} wrappers in sorted key order."""
    if not segments:
        if payload is not None:
            yield payload
        return
    head, rest = segments[0], segments[1:]
    if head == STAR:
        elems = star_elements(payload)
        if elems is not None:
            for elem in elems:
                yield from _walk_path(elem, rest)
    else:
        if isinstance(payload, Mapping) and head in payload:
            yield from _walk_path(payload[head], rest)


def _scalar_at(payload: Any, segments: tuple[str, ...], dtype: DType) -> Any:
    """Resolve a wildcard-free path to a typed scalar or _MISSING
    (typing rules identical to codec._convert)."""
    vals = list(_walk_path(payload, segments))
    if not vals:
        return _MISSING
    v = vals[0]
    if dtype is DType.ID:
        return v if isinstance(v, str) else _MISSING
    if dtype is DType.F32:
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return _MISSING
        return float(v)
    if dtype is DType.BOOL:
        return v if isinstance(v, bool) else _MISSING
    if dtype is DType.I32:
        if isinstance(v, bool) or not isinstance(v, int):
            return _MISSING
        return int(v)
    raise AssertionError(dtype)


_CMP = {
    CmpOp.EQ: lambda a, b: a == b,
    CmpOp.NE: lambda a, b: a != b,
    CmpOp.LT: lambda a, b: a < b,
    CmpOp.LE: lambda a, b: a <= b,
    CmpOp.GT: lambda a, b: a > b,
    CmpOp.GE: lambda a, b: a >= b,
}


class OracleInterpreter:
    """Interprets typechecked IR expressions over one JSON payload."""

    def __init__(self, payload: Any):
        self.payload = payload

    def evaluate(self, expr: Expr) -> bool:
        return bool(self._eval(expr, env=None))

    # env: the current element JSON value per quantifier depth (innermost last)
    def _leaf(self, e: Expr, env: Any) -> Any:
        """Typed scalar value of a Path/Elem leaf in the current scope."""
        if isinstance(e, ir.Elem):
            if env is None:
                raise ir.IRError("Elem outside quantifier")
            return _scalar_at(env, e.segments, e.dtype)
        assert isinstance(e, Path)
        if env is not None and STAR not in e.segments:
            # absolute scalar path inside a quantifier — still absolute
            return _scalar_at(self.payload, e.segments, e.dtype)
        if STAR in e.segments:
            raise ir.IRError(
                f"path {e.key()!r} with unbound wildcards used as a scalar"
            )
        return _scalar_at(self.payload, e.segments, e.dtype)

    def _value(self, e: Expr, env: Any) -> Any:
        if isinstance(e, ir.Const):
            return e.value
        if isinstance(e, (Path, ir.Elem)):
            return self._leaf(e, env)
        if isinstance(e, ir.CountOf):
            return self._count(e, env)
        return self._eval(e, env)

    def _domain(self, e: Expr, env: Any) -> list[Any]:
        """Elements of a quantifier domain (path ends with STAR)."""
        over = e.over
        segs = over.segments
        assert segs[-1] == STAR
        if isinstance(over, ir.Elem):
            base = env
        else:
            base = self.payload
        out: list[Any] = []
        for v in _walk_path(base, segs[:-1]):
            elems = star_elements(v)
            if elems is not None:
                out.extend(elems)
        return out

    def _count(self, e: "ir.CountOf", env: Any) -> int:
        return sum(
            1 for elem in self._domain(e, env) if self._eval(e.pred, elem)
        )

    def _eval(self, e: Expr, env: Any) -> bool:
        if isinstance(e, ir.Const):
            return bool(e.value)
        if isinstance(e, ir.Exists):
            t = e.target
            base = env if isinstance(t, ir.Elem) else self.payload
            return any(True for _ in _walk_path(base, t.segments))
        if isinstance(e, ir.Not):
            return not self._eval(e.operand, env)
        if isinstance(e, ir.And):
            return all(self._eval(op, env) for op in e.operands)
        if isinstance(e, ir.Or):
            return any(self._eval(op, env) for op in e.operands)
        if isinstance(e, ir.Cmp):
            lv = self._value(e.lhs, env)
            rv = self._value(e.rhs, env)
            if lv is _MISSING or rv is _MISSING:
                return False
            if isinstance(lv, bool) != isinstance(rv, bool) and e.op in (
                CmpOp.EQ,
                CmpOp.NE,
            ):
                # BOOL never compares equal to numerics (dtype-checked anyway)
                return e.op is CmpOp.NE
            return bool(_CMP[e.op](lv, rv))
        if isinstance(e, ir.InSet):
            if not e.values:
                return False
            v = self._value(e.operand, env)
            if v is _MISSING:
                return False
            return v in e.values
        if isinstance(e, ir.StrPred):
            v = self._leaf(e.operand, env)
            if v is _MISSING:
                return False
            return _cached_str_pred(e.kind, e.pattern)(v)
        if isinstance(e, ir.AnyOf):
            return any(
                self._eval(e.pred, elem) for elem in self._domain(e, env)
            )
        if isinstance(e, ir.AllOf):
            return all(
                self._eval(e.pred, elem) for elem in self._domain(e, env)
            )
        if isinstance(e, ir.CountOf):
            raise ir.IRError("CountOf is not boolean; wrap in a comparison")
        raise ir.IRError(f"unknown IR node {type(e).__name__}")


def evaluate_expr(expr: Expr, payload: Any) -> bool:
    return OracleInterpreter(payload).evaluate(expr)


def evaluate_program(program: PolicyProgram, payload: Any) -> tuple[bool, int]:
    """→ (allowed, first-violated rule idx or -1) — same contract as the
    compiled device program (ops/compiler.py compile_program)."""
    interp = OracleInterpreter(payload)
    for i, rule in enumerate(program.rules):
        if interp.evaluate(rule.condition):
            return False, i
    return True, -1
