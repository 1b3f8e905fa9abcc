"""OPA / Gatekeeper wasm ABI host.

Runs policies compiled by OPA's wasm backend (Rego → wasm) — the
``PolicyExecutionMode::OpaGatekeeper`` path of the reference's engine
(burrego; exercised by the embedded gatekeeper fixtures,
src/evaluation/evaluation_environment.rs:727-731). The module imports
``env.memory`` plus the ``opa_builtin{0..4}``/``opa_abort`` host calls and
exports the classic OPA eval surface (opa_malloc / opa_json_parse /
opa_eval_ctx_* / eval / opa_json_dump).

Evaluation protocol (one fresh instance per evaluation, mirroring the
reference's rehydrate-per-request isolation,
evaluation_environment.rs:76-84):

1. parse ``data`` and ``input`` JSON into OPA values on the module heap,
2. build an eval context, bind input/data/entrypoint,
3. ``eval(ctx)``, read the result set via ``opa_json_dump``.

Gatekeeper verdict mapping (burrego semantics): the entrypoint yields
``violations`` objects; no violations ⇒ allowed, otherwise the ``msg``
fields aggregate into the rejection message."""

from __future__ import annotations

import json
from typing import Any, Callable, Mapping

from policy_server_tpu_torch.wasm import builtins as builtins_mod
from policy_server_tpu_torch.wasm.binary import WasmModule, ensure_module
from policy_server_tpu_torch.wasm.native_exec import make_instance
from policy_server_tpu_torch.wasm.interp import Instance, Memory, WasmTrap


class OpaError(Exception):
    pass


def _read_cstring(instance: Instance, addr: int) -> bytes:
    mem = instance.memory.data
    end = mem.find(b"\x00", addr)
    if end < 0:
        raise WasmTrap("unterminated string")
    return bytes(mem[addr:end])


class OpaPolicy:
    """A decoded OPA wasm policy; instantiate_and_eval per request."""

    def __init__(self, wasm_bytes: bytes | WasmModule, fuel: int | None = 50_000_000):
        self.module: WasmModule = ensure_module(wasm_bytes)
        self.fuel = fuel
        exports = {e.name for e in self.module.exports}
        required = {"opa_malloc", "opa_json_parse", "opa_json_dump", "eval",
                    "opa_eval_ctx_new", "opa_eval_ctx_set_input",
                    "opa_eval_ctx_set_data", "opa_eval_ctx_get_result"}
        missing = required - exports
        if missing:
            raise OpaError(f"not an OPA wasm module (missing {sorted(missing)})")
        # id → name for host-dispatched builtins, from the module's own
        # builtins() declaration (the OPA wasm ABI contract; burrego reads
        # the same export). Resolved once at load; {} when the module
        # declares none.
        self._builtin_names: dict[int, str] = {}
        if "builtins" in exports:
            declared = self.builtins()
            self._builtin_names = {
                int(v): str(k) for k, v in declared.items()
            }

    # -- instantiation ------------------------------------------------------

    def _imports(self) -> tuple[dict, list[str]]:
        aborts: list[str] = []

        def opa_abort(instance: Instance, addr: int) -> None:
            message = _read_cstring(instance, addr).decode("utf-8", "replace")
            aborts.append(message)
            raise WasmTrap(f"opa_abort: {message}")

        def opa_println(instance: Instance, addr: int) -> None:
            pass  # debugging aid in the guest; ignored

        def builtin(n: int) -> Callable:
            def call(instance: Instance, builtin_id: int, ctx: int, *args: int) -> int:
                name = self._builtin_names.get(builtin_id)
                impl = builtins_mod.REGISTRY.get(name) if name else None
                if impl is None:
                    label = f"{builtin_id} ({name})" if name else str(builtin_id)
                    raise WasmTrap(
                        f"OPA builtin {label} (arity {n}) is not provided "
                        "by this host"
                    )
                # decode each arg through the guest's own serializer, run
                # the host implementation, re-enter the guest to intern the
                # result (burrego round-trips values the same way). EVERY
                # host failure — BuiltinError, arity-mismatch TypeError,
                # decode errors from a hostile module — must surface as a
                # WasmTrap so the policy layer maps it to an in-band
                # rejection, never a crashed request handler.
                try:
                    decoded = [self._dump_value(instance, a) for a in args]
                    result = impl(*decoded)
                except WasmTrap:
                    raise
                except Exception as e:
                    raise WasmTrap(f"OPA builtin {name}: {e}") from e
                return self._parse_value(instance, result)

            return call

        env: dict[str, Any] = {
            "opa_abort": opa_abort,
            "opa_println": opa_println,
        }
        for n in range(5):
            env[f"opa_builtin{n}"] = builtin(n)
        for imp in self.module.imports:
            if imp.kind == "memory" and imp.module == "env":
                env["memory"] = Memory(imp.desc)
        return {"env": env}, aborts

    def instantiate(self) -> Instance:
        imports, _aborts = self._imports()
        return make_instance(self.module, imports, fuel=self.fuel)

    # -- host-builtin value marshalling -------------------------------------

    @staticmethod
    def _dump_value(instance: Instance, addr: int) -> Any:
        """Guest OPA value → decoded JSON, via the guest's opa_json_dump."""
        dumped = instance.invoke("opa_json_dump", addr)[0]
        return json.loads(_read_cstring(instance, dumped).decode())

    @staticmethod
    def _parse_value(instance: Instance, value: Any) -> int:
        """Host JSON value → guest OPA value address."""
        raw = json.dumps(value).encode()
        addr = instance.invoke("opa_malloc", len(raw))[0]
        instance.memory.write(addr, raw)
        parsed = instance.invoke("opa_json_parse", addr, len(raw))[0]
        if parsed == 0:
            raise WasmTrap("opa_json_parse failed for builtin result")
        return parsed

    # -- evaluation ---------------------------------------------------------

    def evaluate(
        self,
        input_doc: Any,
        data_doc: Any = None,
        entrypoint: int = 0,
    ) -> Any:
        """One isolated evaluation → the decoded OPA result set."""
        inst = self.instantiate()

        def load_json(doc: Any) -> int:
            raw = json.dumps(doc if doc is not None else {}).encode()
            addr = inst.invoke("opa_malloc", len(raw))[0]
            inst.memory.write(addr, raw)
            value = inst.invoke("opa_json_parse", addr, len(raw))[0]
            if value == 0:
                raise OpaError("opa_json_parse failed")
            return value

        data_addr = load_json(data_doc)
        input_addr = load_json(input_doc)
        ctx = inst.invoke("opa_eval_ctx_new")[0]
        inst.invoke("opa_eval_ctx_set_data", ctx, data_addr)
        inst.invoke("opa_eval_ctx_set_input", ctx, input_addr)
        if "opa_eval_ctx_set_entrypoint" in {e.name for e in self.module.exports}:
            inst.invoke("opa_eval_ctx_set_entrypoint", ctx, entrypoint)
        rc = inst.invoke("eval", ctx)
        if rc and rc[0] != 0:
            raise OpaError(f"eval returned {rc[0]}")
        result_addr = inst.invoke("opa_eval_ctx_get_result", ctx)[0]
        dumped = inst.invoke("opa_json_dump", result_addr)[0]
        return json.loads(_read_cstring(inst, dumped).decode())

    def entrypoints(self) -> dict[str, int]:
        inst = self.instantiate()
        addr = inst.invoke("entrypoints")[0]
        dumped = inst.invoke("opa_json_dump", addr)[0]
        return json.loads(_read_cstring(inst, dumped).decode())

    def builtins(self) -> dict[str, int]:
        inst = self.instantiate()
        addr = inst.invoke("builtins")[0]
        dumped = inst.invoke("opa_json_dump", addr)[0]
        return json.loads(_read_cstring(inst, dumped).decode())


# ---------------------------------------------------------------------------
# Gatekeeper verdict mapping (burrego parity)
# ---------------------------------------------------------------------------


def gatekeeper_validate(
    policy: OpaPolicy, admission_request: Mapping[str, Any],
    parameters: Mapping[str, Any] | None = None,
) -> tuple[bool, str | None]:
    """Evaluate a Gatekeeper-compiled policy against one AdmissionReview
    request → (allowed, message). Gatekeeper policies see
    ``input.review`` + ``input.parameters`` and emit ``violations``
    (burrego's Gatekeeper evaluator contract)."""
    result = policy.evaluate(
        {"review": dict(admission_request), "parameters": dict(parameters or {})}
    )
    violations: list = []
    for entry in result if isinstance(result, list) else []:
        r = entry.get("result")
        if isinstance(r, Mapping):
            violations.extend(r.get("violations") or [])
        elif isinstance(r, list):
            violations.extend(r)
    if not violations:
        return True, None
    msgs = [
        str(v.get("msg", v)) if isinstance(v, Mapping) else str(v)
        for v in violations
    ]
    return False, "; ".join(msgs)
