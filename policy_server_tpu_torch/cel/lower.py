"""CEL → predicate-IR lowering: CEL validations compile onto the device.

The device path is the point of this framework, so CEL expressions lower
to the same IR the builtin library uses (ops/ir.py) whenever they fit the
IR's shape: path comparisons, string predicates, membership, and the
all/exists/exists_one macros → AllOf/AnyOf/CountOf quantifiers. What
doesn't fit (arithmetic on fields, ternaries, map construction, cross-
scope macro variables) raises :class:`CelLoweringError` and the policy
falls back to the host CEL interpreter (cel/interp.py) — the same
fast-path/escape-hatch split as the rest of the build.

Semantics note (documented divergence): IR comparisons on MISSING fields
are False (codec semantics), while real CEL errors on missing fields —
both produce a deny for a bare failed validation, but guard idioms like
``has(object.spec.x) && object.spec.x > 3`` behave identically and are
the recommended form. ``params.<key>`` resolves from the policy settings
at build time (the Kubernetes ValidatingAdmissionPolicy naming).
"""

from __future__ import annotations

from typing import Any, Mapping

from policy_server_tpu_torch.cel import parser as P
from policy_server_tpu_torch.ops import ir
from policy_server_tpu_torch.ops.ir import CmpOp, Const, DType, Expr


class CelLoweringError(ValueError):
    """Expression is outside the IR-lowerable subset."""


# The validate payload root is the AdmissionRequest document itself
# (models/admission.py payload(); library policies address e.g.
# Path("object.spec.containers") the same way)
_ROOTS: dict[str, tuple[str, ...]] = {
    "request": (),
    "object": ("object",),
    "oldObject": ("oldObject",),
}

_STR_METHODS = {
    "contains": "contains",
    "startsWith": "prefix",
    "endsWith": "suffix",
    "matches": "regex",
}

_CMP = {
    "==": CmpOp.EQ, "!=": CmpOp.NE, "<": CmpOp.LT,
    "<=": CmpOp.LE, ">": CmpOp.GT, ">=": CmpOp.GE,
}


def _dtype_of_value(v: Any) -> DType:
    if isinstance(v, bool):
        return DType.BOOL
    if isinstance(v, int):
        return DType.I32
    if isinstance(v, float):
        return DType.F32
    if isinstance(v, str):
        return DType.ID
    raise CelLoweringError(f"unsupported literal type {type(v).__name__}")


class _PathRef:
    """A resolved CEL selection chain: absolute or element-relative."""

    __slots__ = ("kind", "segments")

    def __init__(self, kind: str, segments: tuple[str, ...]):
        self.kind = kind  # 'abs' | 'elem'
        self.segments = segments

    def leaf(self, dtype: DType):
        if self.kind == "abs":
            return ir.Path(self.segments, dtype)
        return ir.Elem(self.segments, dtype)

    def extended(self, field: str) -> "_PathRef":
        return _PathRef(self.kind, self.segments + (field,))


class Lowerer:
    def __init__(self, params: Mapping[str, Any]):
        self.params = dict(params or {})
        # var name → _PathRef ('abs' survives macro nesting; 'elem' refers
        # to the INNERMOST quantifier only, so entering a nested macro
        # invalidates outer elem vars — IR has one element scope)
        self.env: dict[str, _PathRef] = {}

    # -- resolution ---------------------------------------------------------

    def _resolve_param(self, node: Any) -> Any:
        """params.<a>.<b>… → the settings value, or raise."""
        chain: list[str] = []
        cur = node
        while isinstance(cur, P.Select):
            chain.append(cur.field)
            cur = cur.base
        if not (isinstance(cur, P.Ident) and cur.name == "params"):
            raise CelLoweringError("not a params reference")
        value: Any = self.params
        for field in reversed(chain):
            if not isinstance(value, Mapping) or field not in value:
                raise CelLoweringError(
                    f"params.{'.'.join(reversed(chain))} not present in settings"
                )
            value = value[field]
        return value

    def _as_path(self, node: Any) -> _PathRef:
        """Selection chain → _PathRef; raises when not a pure path."""
        if isinstance(node, P.Ident):
            if node.name in self.env:
                return self.env[node.name]
            root = _ROOTS.get(node.name)
            if root is None:
                raise CelLoweringError(f"unknown identifier {node.name!r}")
            return _PathRef("abs", root)
        if isinstance(node, P.Select):
            return self._as_path(node.base).extended(node.field)
        raise CelLoweringError(f"not a field path: {type(node).__name__}")

    def _const_value(self, node: Any) -> Any:
        if isinstance(node, P.Lit):
            return node.value
        if isinstance(node, P.ListLit):
            return [self._const_value(x) for x in node.items]
        try:
            return self._resolve_param(node)
        except CelLoweringError:
            raise CelLoweringError(
                f"expected a constant, got {type(node).__name__}"
            ) from None

    # -- lowering -----------------------------------------------------------

    def lower(self, node: Any) -> Expr:
        """AST → boolean IR expression."""
        if isinstance(node, P.Lit):
            if isinstance(node.value, bool):
                return ir.true() if node.value else ir.false()
            raise CelLoweringError("non-boolean literal in boolean position")
        if isinstance(node, P.Unary) and node.op == "!":
            return ir.Not(self.lower(node.operand))
        if isinstance(node, P.Binary):
            return self._lower_binary(node)
        if isinstance(node, P.Call):
            return self._lower_call(node)
        if isinstance(node, (P.Ident, P.Select)):
            # a bare boolean field: object.spec.hostNetwork
            return ir.Cmp(
                CmpOp.EQ, self._as_path(node).leaf(DType.BOOL), Const(True, DType.BOOL)
            )
        raise CelLoweringError(
            f"unsupported construct {type(node).__name__} in boolean position"
        )

    def _lower_binary(self, node: P.Binary) -> Expr:
        op = node.op
        if op == "&&":
            return ir.And((self.lower(node.lhs), self.lower(node.rhs)))
        if op == "||":
            return ir.Or((self.lower(node.lhs), self.lower(node.rhs)))
        if op == "in":
            return self._lower_in(node)
        if op in _CMP:
            return self._lower_cmp(node)
        raise CelLoweringError(f"operator {op!r} does not lower to IR")

    def _lower_cmp(self, node: P.Binary) -> Expr:
        op = _CMP[node.op]
        # size(x) <op> N
        for size_side, const_side, flip in (
            (node.lhs, node.rhs, False),
            (node.rhs, node.lhs, True),
        ):
            if (
                isinstance(size_side, P.Call)
                and size_side.name == "size"
            ):
                count = self._lower_size(size_side)
                value = self._const_value(const_side)
                if isinstance(value, bool) or not isinstance(value, int):
                    raise CelLoweringError("size() compares to an integer")
                cmp_op = _FLIPPED[op] if flip else op
                return ir.Cmp(cmp_op, count, Const(value, DType.I32))
        # path <op> const | const <op> path. Path-vs-path comparisons do
        # NOT lower: the leaf dtypes are unknowable statically and a wrong
        # guess silently mis-encodes (ID-typed numeric leaves read as
        # MISSING) — the host interpreter handles them with real values.
        lhs_path = self._try_path(node.lhs)
        rhs_path = self._try_path(node.rhs)
        if lhs_path is not None and rhs_path is not None:
            raise CelLoweringError(
                "field-to-field comparisons need the host interpreter"
            )
        if lhs_path is not None:
            value = self._const_value(node.rhs)
            dtype = _dtype_of_value(value)
            return ir.Cmp(op, lhs_path.leaf(dtype), Const(value, dtype))
        if rhs_path is not None:
            value = self._const_value(node.lhs)
            dtype = _dtype_of_value(value)
            return ir.Cmp(_FLIPPED[op], rhs_path.leaf(dtype), Const(value, dtype))
        raise CelLoweringError("comparison needs at least one field path")

    def _try_path(self, node: Any) -> _PathRef | None:
        if not isinstance(node, (P.Ident, P.Select)):
            return None
        if self._is_params_ref(node):
            return None
        try:
            return self._as_path(node)
        except CelLoweringError:
            return None

    @staticmethod
    def _is_params_ref(node: Any) -> bool:
        cur = node
        while isinstance(cur, P.Select):
            cur = cur.base
        return isinstance(cur, P.Ident) and cur.name == "params"

    def _lower_in(self, node: P.Binary) -> Expr:
        lhs_path = self._try_path(node.lhs)
        if lhs_path is not None:
            values = self._const_value(node.rhs)
            if not isinstance(values, list):
                raise CelLoweringError("'in' needs a constant list")
            if not values:
                return ir.false()
            dtype = _dtype_of_value(values[0])
            return ir.InSet(lhs_path.leaf(dtype), tuple(values), )
        # literal in path-list:  'NET_ADMIN' in c.securityContext.capabilities.add
        rhs_path = self._try_path(node.rhs)
        if rhs_path is not None:
            value = self._const_value(node.lhs)
            dtype = _dtype_of_value(value)
            over = rhs_path.leaf(dtype)
            return ir.AnyOf(
                over=over, pred=ir.Cmp(CmpOp.EQ, ir.Elem((), dtype), Const(value, dtype))
            )
        raise CelLoweringError("'in' needs a field path on one side")

    def _lower_size(self, node: P.Call):
        # size() is polymorphic in CEL (list length, map size, STRING
        # length); CountOf only counts elements, and the operand's runtime
        # type is unknowable statically — a string field would silently
        # count 0. Host interpreter territory.
        raise CelLoweringError("size() needs the host interpreter")

    def _lower_call(self, node: P.Call) -> Expr:
        if node.recv is None:
            if node.name == "has" and len(node.args) == 1:
                path = self._as_path(node.args[0])
                return ir.Exists(path.leaf(DType.ID))
            raise CelLoweringError(f"function {node.name!r} does not lower")
        # string predicate methods
        if node.name in _STR_METHODS:
            if len(node.args) != 1:
                raise CelLoweringError(f"{node.name}() takes one argument")
            pattern = self._const_value(node.args[0])
            if not isinstance(pattern, str):
                raise CelLoweringError(f"{node.name}() needs a string argument")
            path = self._as_path(node.recv)
            return ir.StrPred(
                path.leaf(DType.ID), _STR_METHODS[node.name], pattern
            )
        # macros: list.all(v, pred) / exists / exists_one
        if node.name in ("all", "exists", "exists_one"):
            if len(node.args) != 2 or not isinstance(node.args[0], P.Ident):
                raise CelLoweringError(f"{node.name}() needs (var, predicate)")
            var = node.args[0].name
            domain = self._as_path(node.recv)
            saved = dict(self.env)
            # entering a quantifier: element-relative vars of OUTER scopes
            # cannot be referenced inside (IR has one element scope)
            self.env = {
                name: ref
                for name, ref in self.env.items()
                if ref.kind == "abs"
            }
            self.env[var] = _PathRef("elem", ())
            try:
                pred = self.lower(node.args[1])
            finally:
                self.env = saved
            over = domain.leaf(DType.ID)
            if node.name == "all":
                return ir.AllOf(over=over, pred=pred)
            if node.name == "exists":
                return ir.AnyOf(over=over, pred=pred)
            return ir.Cmp(
                CmpOp.EQ, ir.CountOf(over=over, pred=pred), Const(1, DType.I32)
            )
        raise CelLoweringError(f"method {node.name!r} does not lower")


_FLIPPED = {
    CmpOp.EQ: CmpOp.EQ, CmpOp.NE: CmpOp.NE,
    CmpOp.LT: CmpOp.GT, CmpOp.LE: CmpOp.GE,
    CmpOp.GT: CmpOp.LT, CmpOp.GE: CmpOp.LE,
}


def lower(ast: Any, params: Mapping[str, Any] | None = None) -> Expr:
    """CEL AST → boolean IR expression; raises CelLoweringError when the
    expression is outside the lowerable subset."""
    expr = Lowerer(params or {}).lower(ast)
    ir.typecheck(expr)
    return expr
