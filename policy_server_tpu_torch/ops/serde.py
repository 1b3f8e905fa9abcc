"""IR ↔ JSON serialization — the policy *artifact* format's payload.

The reference distributes policies as WASM binaries with embedded metadata
(src/evaluation/precompiled_policy.rs:46-64); this framework's native
artifact is a JSON document carrying serialized predicate IR (ops/ir.py).
Serialization is total over the IR; deserialization typechecks on load so a
malformed artifact fails at bootstrap exactly like bad wasm metadata.

Settings binding: artifacts are templates — any ``Const``/``InSet`` value
position may be ``{"$setting": "key"}`` (with optional ``"default"``),
resolved against the policy's settings at build time
(PolicyProgram = module + settings, evaluation/precompiled.py). Unresolved
required settings are settings-validation errors (the reference's
validate_settings path, evaluation_environment.rs:472-510).
"""

from __future__ import annotations

from typing import Any, Mapping

from policy_server_tpu_torch.ops import ir
from policy_server_tpu_torch.ops.ir import (
    AllOf,
    And,
    AnyOf,
    Cmp,
    CmpOp,
    Const,
    CountOf,
    DType,
    Elem,
    Exists,
    Expr,
    InSet,
    IRError,
    Not,
    Or,
    Path,
    StrPred,
)


class SettingsBindingError(IRError):
    """A ``$setting`` reference could not be resolved."""


# --------------------------------------------------------------------------
# Expr → JSON
# --------------------------------------------------------------------------


def expr_to_json(e: Expr) -> dict[str, Any]:
    if isinstance(e, Path):
        return {"op": "path", "path": e.key(), "dtype": e.dtype.value}
    if isinstance(e, Elem):
        return {
            "op": "elem",
            "path": ir.render_key(e.segments) if e.segments else "",
            "dtype": e.dtype.value,
        }
    if isinstance(e, Const):
        return {"op": "const", "value": e.value, "dtype": e.dtype.value}
    if isinstance(e, Exists):
        return {"op": "exists", "target": expr_to_json(e.target)}
    if isinstance(e, Not):
        return {"op": "not", "operand": expr_to_json(e.operand)}
    if isinstance(e, And):
        return {"op": "and", "operands": [expr_to_json(o) for o in e.operands]}
    if isinstance(e, Or):
        return {"op": "or", "operands": [expr_to_json(o) for o in e.operands]}
    if isinstance(e, Cmp):
        return {
            "op": "cmp",
            "cmp": e.op.value,
            "lhs": expr_to_json(e.lhs),
            "rhs": expr_to_json(e.rhs),
        }
    if isinstance(e, InSet):
        return {
            "op": "in_set",
            "operand": expr_to_json(e.operand),
            "values": list(e.values),
            "dtype": e.dtype.value,
        }
    if isinstance(e, StrPred):
        return {
            "op": "str_pred",
            "operand": expr_to_json(e.operand),
            "kind": e.kind,
            "pattern": e.pattern,
        }
    if isinstance(e, AnyOf):
        return {"op": "any_of", "over": expr_to_json(e.over),
                "pred": expr_to_json(e.pred)}
    if isinstance(e, AllOf):
        return {"op": "all_of", "over": expr_to_json(e.over),
                "pred": expr_to_json(e.pred)}
    if isinstance(e, CountOf):
        return {"op": "count_of", "over": expr_to_json(e.over),
                "pred": expr_to_json(e.pred)}
    raise IRError(f"cannot serialize IR node {type(e).__name__}")


# --------------------------------------------------------------------------
# JSON → Expr (with settings binding)
# --------------------------------------------------------------------------


def _dtype(d: Mapping[str, Any]) -> DType:
    raw = d.get("dtype", "id")
    try:
        return DType(raw)
    except ValueError:
        raise IRError(f"unknown dtype {raw!r}") from None


def _resolve_value(v: Any, settings: Mapping[str, Any]) -> Any:
    """Resolve a value position: literal, or {"$setting": key, "default"?}."""
    if isinstance(v, Mapping) and "$setting" in v:
        key = v["$setting"]
        if key in settings:
            return settings[key]
        if "default" in v:
            return v["default"]
        raise SettingsBindingError(f"required setting {key!r} is not provided")
    return v


def _leaf(d: Mapping[str, Any]) -> Path | Elem:
    op = d.get("op")
    if op == "path":
        return Path(d["path"], _dtype(d))
    if op == "elem":
        return Elem(d.get("path") or (), _dtype(d))
    raise IRError(f"expected path/elem leaf, got {op!r}")


def expr_from_json(
    d: Mapping[str, Any], settings: Mapping[str, Any] | None = None
) -> Expr:
    """Deserialize one IR expression, resolving ``$setting`` references.
    The caller typechecks the resulting rule set (artifact load path,
    fetch/artifact.py)."""
    settings = settings or {}
    if not isinstance(d, Mapping) or "op" not in d:
        raise IRError("IR node must be an object with an `op` field")
    op = d["op"]
    if op in ("path", "elem"):
        return _leaf(d)
    if op == "const":
        value = _resolve_value(d.get("value"), settings)
        dt = _dtype(d)
        if dt is DType.BOOL and not isinstance(value, bool):
            raise IRError(f"const dtype bool with non-bool value {value!r}")
        return Const(value, dt)
    if op == "exists":
        return Exists(_leaf(d["target"]))
    if op == "not":
        return Not(expr_from_json(d["operand"], settings))
    if op == "and":
        return And([expr_from_json(o, settings) for o in d["operands"]])
    if op == "or":
        return Or([expr_from_json(o, settings) for o in d["operands"]])
    if op == "cmp":
        try:
            cmp_op = CmpOp(d.get("cmp"))
        except ValueError:
            raise IRError(f"unknown comparison {d.get('cmp')!r}") from None
        return Cmp(
            cmp_op,
            expr_from_json(d["lhs"], settings),
            expr_from_json(d["rhs"], settings),
        )
    if op == "in_set":
        values = _resolve_value(d.get("values"), settings)
        if not isinstance(values, (list, tuple)):
            raise IRError("in_set `values` must resolve to a list")
        return InSet(
            expr_from_json(d["operand"], settings), tuple(values), _dtype(d)
        )
    if op == "str_pred":
        pattern = _resolve_value(d.get("pattern"), settings)
        if not isinstance(pattern, str):
            raise IRError("str_pred `pattern` must resolve to a string")
        return StrPred(_leaf(d["operand"]), d.get("kind", ""), pattern)
    if op in ("any_of", "all_of", "count_of"):
        cls = {"any_of": AnyOf, "all_of": AllOf, "count_of": CountOf}[op]
        return cls(_leaf(d["over"]), expr_from_json(d["pred"], settings))
    raise IRError(f"unknown IR op {op!r}")
