"""Host CEL interpreter — the fallback for expressions outside the
IR-lowerable subset (cel/lower.py) and the engine for
``messageExpression``.

Semantics follow CEL where it matters for validation policies: selecting
a missing field raises :class:`CelEvalError` (a failed validation), the
``all``/``exists``/``exists_one``/``filter``/``map`` macros bind a
variable per element, ``in`` works over lists/maps/strings, and dynamic
values compare by value. Arithmetic, ternaries, and string concatenation
are supported here even though they do not lower to IR.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

from policy_server_tpu_torch.cel import parser as P


class CelEvalError(ValueError):
    pass


class Interpreter:
    def __init__(self, bindings: Mapping[str, Any]):
        self.bindings = dict(bindings)

    def eval(self, node: Any) -> Any:
        if isinstance(node, P.Lit):
            return node.value
        if isinstance(node, P.ListLit):
            return [self.eval(x) for x in node.items]
        if isinstance(node, P.Ident):
            if node.name not in self.bindings:
                raise CelEvalError(f"unknown identifier {node.name!r}")
            return self.bindings[node.name]
        if isinstance(node, P.Select):
            base = self.eval(node.base)
            if isinstance(base, Mapping):
                if node.field not in base:
                    raise CelEvalError(f"no such key: {node.field!r}")
                return base[node.field]
            raise CelEvalError(
                f"cannot select {node.field!r} from {type(base).__name__}"
            )
        if isinstance(node, P.Index):
            base = self.eval(node.base)
            idx = self.eval(node.index)
            try:
                return base[idx]
            except (KeyError, IndexError, TypeError) as e:
                raise CelEvalError(f"bad index: {e}") from e
        if isinstance(node, P.Unary):
            v = self.eval(node.operand)
            if node.op == "!":
                if not isinstance(v, bool):
                    raise CelEvalError("'!' needs a boolean")
                return not v
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise CelEvalError("unary '-' needs a number")
            return -v
        if isinstance(node, P.Ternary):
            cond = self.eval(node.cond)
            if not isinstance(cond, bool):
                raise CelEvalError("ternary condition must be boolean")
            return self.eval(node.then if cond else node.other)
        if isinstance(node, P.Binary):
            return self._binary(node)
        if isinstance(node, P.Call):
            return self._call(node)
        raise CelEvalError(f"unsupported node {type(node).__name__}")

    def _binary(self, node: P.Binary) -> Any:
        op = node.op
        if op == "&&":
            # CEL commutative &&: false short-circuits past errors
            try:
                lhs = self.eval(node.lhs)
            except CelEvalError:
                if self.eval(node.rhs) is False:
                    return False
                raise
            if lhs is False:
                return False
            rhs = self.eval(node.rhs)
            if not isinstance(lhs, bool) or not isinstance(rhs, bool):
                raise CelEvalError("'&&' needs booleans")
            return lhs and rhs
        if op == "||":
            try:
                lhs = self.eval(node.lhs)
            except CelEvalError:
                if self.eval(node.rhs) is True:
                    return True
                raise
            if lhs is True:
                return True
            rhs = self.eval(node.rhs)
            if not isinstance(lhs, bool) or not isinstance(rhs, bool):
                raise CelEvalError("'||' needs booleans")
            return lhs or rhs
        lhs = self.eval(node.lhs)
        rhs = self.eval(node.rhs)
        if op == "in":
            if isinstance(rhs, str):
                if not isinstance(lhs, str):
                    raise CelEvalError("'in' over a string needs a string")
                return lhs in rhs
            if isinstance(rhs, list):
                return any(self._equal(lhs, x) for x in rhs)
            if isinstance(rhs, Mapping):
                try:
                    return lhs in rhs
                except TypeError as e:
                    raise CelEvalError(f"'in' over a map: {e}") from e
            raise CelEvalError("'in' needs a list, map, or string")
        if op in ("==", "!="):
            eq = self._equal(lhs, rhs)
            return eq if op == "==" else not eq
        if op in ("<", "<=", ">", ">="):
            if not self._ordered(lhs, rhs):
                raise CelEvalError(f"cannot order {lhs!r} and {rhs!r}")
            return {
                "<": lhs < rhs, "<=": lhs <= rhs,
                ">": lhs > rhs, ">=": lhs >= rhs,
            }[op]
        if op == "+":
            if isinstance(lhs, str) and isinstance(rhs, str):
                return lhs + rhs
            if isinstance(lhs, list) and isinstance(rhs, list):
                return lhs + rhs
            return self._arith(lhs, rhs, lambda a, b: a + b)
        if op == "-":
            return self._arith(lhs, rhs, lambda a, b: a - b)
        if op == "*":
            return self._arith(lhs, rhs, lambda a, b: a * b)
        if op == "/":
            if rhs == 0:
                raise CelEvalError("division by zero")
            if isinstance(lhs, int) and isinstance(rhs, int):
                return self._arith(lhs, rhs, lambda a, b: int(a / b))
            return self._arith(lhs, rhs, lambda a, b: a / b)
        if op == "%":
            if rhs == 0:
                raise CelEvalError("modulo by zero")
            return self._arith(lhs, rhs, lambda a, b: a - int(a / b) * b)
        raise CelEvalError(f"unsupported operator {op!r}")

    @staticmethod
    def _equal(a: Any, b: Any) -> bool:
        if isinstance(a, bool) != isinstance(b, bool):
            return False
        return a == b

    @staticmethod
    def _ordered(a: Any, b: Any) -> bool:
        if isinstance(a, bool) or isinstance(b, bool):
            return False
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            return True
        return isinstance(a, str) and isinstance(b, str)

    @staticmethod
    def _arith(a: Any, b: Any, fn) -> Any:
        if isinstance(a, bool) or isinstance(b, bool):
            raise CelEvalError("arithmetic on booleans")
        if not isinstance(a, (int, float)) or not isinstance(b, (int, float)):
            raise CelEvalError("arithmetic needs numbers")
        return fn(a, b)

    def _call(self, node: P.Call) -> Any:
        name = node.name
        if node.recv is None:
            if name == "has":
                if len(node.args) != 1 or not isinstance(
                    node.args[0], (P.Select, P.Index)
                ):
                    raise CelEvalError("has() needs a field selection")
                try:
                    self.eval(node.args[0])
                    return True
                except CelEvalError:
                    return False
            if name == "size":
                (arg,) = node.args
                v = self.eval(arg)
                if isinstance(v, (str, list, Mapping)):
                    return len(v)
                raise CelEvalError("size() needs a string, list, or map")
            if name in ("int", "double", "string"):
                (arg,) = node.args
                v = self.eval(arg)
                try:
                    if name == "int":
                        return int(v)
                    if name == "double":
                        return float(v)
                    return v if isinstance(v, str) else _to_string(v)
                except (TypeError, ValueError) as e:
                    raise CelEvalError(f"{name}(): {e}") from e
            raise CelEvalError(f"unknown function {name!r}")
        recv = self.eval(node.recv)
        if name in ("all", "exists", "exists_one", "filter", "map"):
            return self._macro(name, recv, node.args)
        if name in ("contains", "startsWith", "endsWith", "matches"):
            (arg,) = node.args
            pattern = self.eval(arg)
            if not isinstance(recv, str) or not isinstance(pattern, str):
                raise CelEvalError(f"{name}() needs strings")
            if name == "contains":
                return pattern in recv
            if name == "startsWith":
                return recv.startswith(pattern)
            if name == "endsWith":
                return recv.endswith(pattern)
            try:
                return re.search(pattern, recv) is not None
            except re.error as e:
                raise CelEvalError(f"matches(): bad pattern: {e}") from e
        raise CelEvalError(f"unknown method {name!r}")

    def _macro(self, name: str, recv: Any, args: tuple) -> Any:
        if len(args) != 2 or not isinstance(args[0], P.Ident):
            raise CelEvalError(f"{name}() needs (var, expression)")
        var = args[0].name
        if isinstance(recv, Mapping):
            elements: list = list(recv.keys())
        elif isinstance(recv, list):
            elements = recv
        else:
            raise CelEvalError(f"{name}() needs a list or map")
        saved = self.bindings.get(var, _MISSING)
        results = []
        try:
            for elem in elements:
                self.bindings[var] = elem
                results.append(self.eval(args[1]))
        finally:
            if saved is _MISSING:
                self.bindings.pop(var, None)
            else:
                self.bindings[var] = saved
        if name in ("all", "exists", "exists_one"):
            if not all(isinstance(r, bool) for r in results):
                raise CelEvalError(f"{name}() predicate must be boolean")
            if name == "all":
                return all(results)
            if name == "exists":
                return any(results)
            return sum(results) == 1
        if name == "filter":
            return [e for e, r in zip(elements, results) if r is True]
        return results  # map


_MISSING = object()


def _to_string(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    return str(v)


def evaluate(ast: Any, bindings: Mapping[str, Any]) -> Any:
    return Interpreter(bindings).eval(ast)
