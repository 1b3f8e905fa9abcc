"""The CEL policy module (PolicyExecutionMode::Cel).

The reference runs CEL policies through a wasm-embedded cel-interpreter
module configured by settings shaped like Kubernetes
ValidatingAdmissionPolicy (src/evaluation/precompiled_policy.rs:46-64;
upstream ghcr.io/kubewarden/policies/cel-policy):

```yaml
settings:
  variables:                      # optional named sub-expressions
    - name: replicas
      expression: "object.spec.replicas"
  validations:                    # at least one; ALL must hold
    - expression: "variables.replicas <= 5"
      message: "too many replicas"
      messageExpression: "'replicas: ' + string(variables.replicas)"
```

Device-first twist: each validation expression is LOWERED TO PREDICATE IR
(cel/lower.py) so CEL policies run inside the fused device program like
any builtin — no interpreter on the hot path. Expressions outside the
lowerable subset fall back to the host CEL interpreter (cel/interp.py)
for the whole policy, becoming a host-executed policy exactly like a
wasm module. ``variables.<name>`` references are inlined by AST
substitution before lowering, so variables never force the host path.
"""

from __future__ import annotations

from typing import Any, Mapping

from policy_server_tpu_torch.cel import interp as interp_mod
from policy_server_tpu_torch.cel import parser as parser_mod
from policy_server_tpu_torch.cel.interp import CelEvalError
from policy_server_tpu_torch.cel.lower import CelLoweringError, lower
from policy_server_tpu_torch.cel.parser import CelParseError
from policy_server_tpu_torch.context import CONTEXT_KEY
from policy_server_tpu_torch.ops import ir
from policy_server_tpu_torch.ops.compiler import PolicyProgram, Rule
from policy_server_tpu_torch.policies.base import (
    BuiltinPolicy,
    SettingsError,
    SettingsValidationResponse,
)


def _substitute_variables(ast: Any, variables: Mapping[str, Any]) -> Any:
    """Replace ``variables.<name>`` selections with the named expression's
    AST (already-substituted, so earlier variables compose)."""
    P = parser_mod
    if isinstance(ast, P.Select):
        if isinstance(ast.base, P.Ident) and ast.base.name == "variables":
            if ast.field not in variables:
                raise SettingsError(f"unknown variable {ast.field!r}")
            return variables[ast.field]
        return P.Select(_substitute_variables(ast.base, variables), ast.field)
    if isinstance(ast, P.Call):
        return P.Call(
            _substitute_variables(ast.recv, variables)
            if ast.recv is not None
            else None,
            ast.name,
            tuple(_substitute_variables(a, variables) for a in ast.args),
        )
    if isinstance(ast, P.Index):
        return P.Index(
            _substitute_variables(ast.base, variables),
            _substitute_variables(ast.index, variables),
        )
    if isinstance(ast, P.Unary):
        return P.Unary(ast.op, _substitute_variables(ast.operand, variables))
    if isinstance(ast, P.Binary):
        return P.Binary(
            ast.op,
            _substitute_variables(ast.lhs, variables),
            _substitute_variables(ast.rhs, variables),
        )
    if isinstance(ast, P.Ternary):
        return P.Ternary(
            _substitute_variables(ast.cond, variables),
            _substitute_variables(ast.then, variables),
            _substitute_variables(ast.other, variables),
        )
    if isinstance(ast, P.ListLit):
        return P.ListLit(
            tuple(_substitute_variables(x, variables) for x in ast.items)
        )
    return ast  # Lit / Ident


def _bindings(payload: Any, settings: Mapping[str, Any]) -> dict[str, Any]:
    """CEL evaluation bindings from one validate payload (the payload root
    IS the AdmissionRequest document, models/admission.py payload())."""
    request = dict(payload) if isinstance(payload, Mapping) else {}
    request.pop(CONTEXT_KEY, None)
    out: dict[str, Any] = {"request": request, "params": dict(settings)}
    if "object" in request:
        out["object"] = request["object"]
    if "oldObject" in request:
        out["oldObject"] = request["oldObject"]
    return out


class _Validation:
    __slots__ = ("ast", "expression", "message", "message_ast")

    def __init__(self, doc: Mapping[str, Any], variables: Mapping[str, Any]):
        if not isinstance(doc, Mapping) or not isinstance(
            doc.get("expression"), str
        ):
            raise SettingsError(
                "each validation needs a string 'expression'"
            )
        self.expression = doc["expression"]
        try:
            self.ast = _substitute_variables(
                parser_mod.parse(self.expression), variables
            )
        except CelParseError as e:
            raise SettingsError(
                f"invalid CEL expression {self.expression!r}: {e}"
            ) from e
        message = doc.get("message")
        if message is not None and not isinstance(message, str):
            raise SettingsError("validation 'message' must be a string")
        self.message = message or f"failed expression: {self.expression}"
        self.message_ast = None
        msg_expr = doc.get("messageExpression")
        if msg_expr is not None:
            if not isinstance(msg_expr, str):
                raise SettingsError(
                    "validation 'messageExpression' must be a string"
                )
            try:
                self.message_ast = _substitute_variables(
                    parser_mod.parse(msg_expr), variables
                )
            except CelParseError as e:
                raise SettingsError(
                    f"invalid messageExpression {msg_expr!r}: {e}"
                ) from e

    def message_for(self, payload: Any, settings: Mapping[str, Any]) -> str:
        if self.message_ast is not None:
            try:
                value = interp_mod.evaluate(
                    self.message_ast, _bindings(payload, settings)
                )
                if isinstance(value, str) and value:
                    return value
            except CelEvalError:
                pass  # fall back to the static message
        return self.message


class CelPolicy(BuiltinPolicy):
    """``builtin://cel-policy`` — Kubernetes-style CEL validations,
    compiled onto the device via predicate-IR lowering with a host
    interpreter fallback."""

    name = "cel-policy"
    mutating = False
    upstream_equivalents = ("ghcr.io/kubewarden/policies/cel-policy",)

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        settings = dict(settings or {})
        validations_doc = settings.get("validations")
        if not isinstance(validations_doc, list) or not validations_doc:
            raise SettingsError(
                "setting 'validations' must be a non-empty list"
            )
        variables: dict[str, Any] = {}
        variables_doc = settings.get("variables") or []
        if not isinstance(variables_doc, list):
            raise SettingsError("setting 'variables' must be a list")
        for v in variables_doc:
            if not isinstance(v, Mapping) or not isinstance(
                v.get("name"), str
            ) or not isinstance(v.get("expression"), str):
                raise SettingsError(
                    "each variable needs string 'name' and 'expression'"
                )
            try:
                variables[v["name"]] = _substitute_variables(
                    parser_mod.parse(v["expression"]), variables
                )
            except CelParseError as e:
                raise SettingsError(
                    f"invalid variable expression {v['expression']!r}: {e}"
                ) from e

        validations = [_Validation(doc, variables) for doc in validations_doc]

        # device path: every validation lowers → one deny-rule each (rule
        # fires when the validation does NOT hold)
        rules: list[Rule] = []
        try:
            for i, v in enumerate(validations):
                condition = ir.Not(lower(v.ast, params=settings))
                message: Any = v.message
                if v.message_ast is not None:
                    message = (
                        lambda payload, _v=v: _v.message_for(payload, settings)
                    )
                rules.append(
                    Rule(
                        name=f"cel-validation-{i}",
                        condition=condition,
                        message=message,
                    )
                )
            program = PolicyProgram(rules=tuple(rules))
            program.typecheck()
            return program
        except (CelLoweringError, ir.IRError):
            pass  # outside the lowerable subset → host interpreter

        def host_eval(payload: Any) -> Mapping[str, Any]:
            bindings = _bindings(payload, settings)
            for v in validations:
                try:
                    result = interp_mod.evaluate(v.ast, bindings)
                # host evaluators must NEVER raise (the group member
                # contract, environment._eval_wasm_members): any failure
                # is an in-band deny
                except Exception as e:  # noqa: BLE001
                    return {
                        "accepted": False,
                        "message": f"{v.message} (CEL error: {e})",
                    }
                if result is not True:
                    return {
                        "accepted": False,
                        "message": v.message_for(payload, settings),
                    }
            return {"accepted": True}

        return PolicyProgram(
            rules=(Rule("cel-host-executed", ir.false(), "unreachable"),),
            host_evaluator=host_eval,
        )

    def validate_settings(
        self, settings: Mapping[str, Any]
    ) -> SettingsValidationResponse:
        try:
            self.build(dict(settings or {}))
        except (SettingsError, ValueError) as e:
            return SettingsValidationResponse.error(str(e))
        return SettingsValidationResponse.ok()
