"""Wasm policy modules — multi-ABI policy execution (SURVEY.md §2.2).

The reference executes every policy as wasm under wasmtime, speaking one
of several ABIs (PolicyExecutionMode: Kubewarden waPC, OPA, OPA-Gatekeeper
— precompiled_policy.rs:46-64). This module is this package's
counterpart: a fetched ``.wasm`` artifact becomes a
:class:`WasmPolicyModule` whose bound program carries a
``host_evaluator`` — the evaluation environment routes such policies
through host-side wasm execution (wasm/interp.py) instead of the fused
device program. Wasm policies are the generality escape hatch; the
predicate-IR path remains the device fast path.

ABI detection is by exports: ``__guest_call`` ⇒ waPC (Kubewarden
protocol, wasm/wapc.py); ``opa_eval_ctx_new`` ⇒ OPA/Gatekeeper
(wasm/opa.py); ``_start`` ⇒ WASI command module (wasm/wasi.py:
argv-selected operation, request JSON on stdin, verdict JSON on
stdout). A runaway module exhausts its interpreter fuel and is
rejected in-band with the reference's "execution deadline exceeded"
message (the epoch-interruption analog, src/lib.rs:176-190)."""

from __future__ import annotations

from typing import Any, Mapping

from policy_server_tpu_torch.ops.compiler import PolicyProgram, Rule
from policy_server_tpu_torch.ops.ir import false
from policy_server_tpu_torch.policies.base import SettingsValidationResponse
from policy_server_tpu_torch.wasm.binary import decode_module
from policy_server_tpu_torch.wasm.interp import (
    WasmFuelExhausted,
    WasmTrap,
    deadline_scope,
)
from policy_server_tpu_torch.wasm.opa import OpaError, OpaPolicy, gatekeeper_validate
from policy_server_tpu_torch.wasm.wapc import KubewardenWapcPolicy, WapcError
from policy_server_tpu_torch.wasm.wasi import WasiError, WasiPolicy

DEADLINE_MESSAGE = "execution deadline exceeded"


class WasmPolicyModule:
    """PolicyModule protocol over a wasm payload (multi-ABI)."""

    def __init__(
        self,
        wasm_bytes: bytes,
        name: str,
        digest: str,
        fuel: int | None = 50_000_000,
        wall_clock_budget: float | None = 2.0,
    ):
        self.name = name
        self.digest = digest
        # Per-evaluation wall-clock budget — the epoch-interruption analog
        # (reference --policy-timeout default 2 s, src/cli.rs:164-169).
        # The environment builder syncs this to the server's configured
        # policy timeout; None disables. Instance state, not a process
        # global: each server's environment owns its modules the way each
        # reference PolicyServer owns its wasmtime Engine epoch.
        self.wall_clock_budget = wall_clock_budget
        # offline sigstore trust root (fetch/keyless.TrustRoot) for the
        # keyless v2/verify host capability; synced by the environment
        # builder from the server's sigstore cache dir
        self.trust_root = None
        # image ref → manifest digest callable backing oci/v1/
        # manifest_digest (Downloader.manifest_digest); synced by the
        # environment builder from the server's registry client
        self.oci_digest_source = None
        module = decode_module(wasm_bytes)  # decoded ONCE, shared by hosts
        exports = {e.name for e in module.exports}
        if "__guest_call" in exports:
            self.abi = "wapc"
            self._wapc = KubewardenWapcPolicy(module, fuel=fuel)
        elif "opa_eval_ctx_new" in exports:
            self.abi = "opa-gatekeeper"
            self._opa = OpaPolicy(module, fuel=fuel)
        elif "_start" in exports:
            self.abi = "wasi"
            self._wasi = WasiPolicy(module, fuel=fuel)
            self._wasi.name = name
        else:
            raise WasmTrap(
                f"wasm module {name!r} speaks no supported policy ABI "
                "(expected waPC __guest_call, OPA opa_eval_ctx_new, or "
                "WASI _start exports)"
            )
        # waPC and WASI guests may return a mutated object; whether the
        # operator permits it is gated by allowedToMutate like any policy
        self.mutating = self.abi in ("wapc", "wasi")

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        from policy_server_tpu_torch.context import CONTEXT_KEY
        from policy_server_tpu_torch.policies.base import SettingsError
        from policy_server_tpu_torch.wasm.capabilities import (
            kubernetes_capabilities,
            static_capabilities,
        )

        bound_settings = dict(settings or {})
        # optional signature store: backs the sigstore host capability
        # (kubewarden/v1/verify) the way the policy's own settings back
        # verify-image-signatures; fail fast on a non-string value rather
        # than surfacing a misleading "no store configured" per request
        bundle_source = None
        store = bound_settings.get("signatureStore")
        if store is not None:
            if not isinstance(store, str):
                raise SettingsError(
                    "setting 'signatureStore' must be a directory path"
                )
            from policy_server_tpu_torch.policies.images import file_bundle_source

            bundle_source = file_bundle_source(store)
        allow_network = bool(bound_settings.get("allowNetworkCapabilities"))
        # payload-independent capability entries: built ONCE per policy
        statics = static_capabilities(
            bundle_source, allow_network, trust_root=self.trust_root,
            oci_digest_source=self.oci_digest_source,
        )

        def evaluate(payload: Any) -> Mapping[str, Any]:
            try:
                return _evaluate_inner(payload)
            except WasmFuelExhausted:
                # fuel OR wall-clock deadline (WasmDeadlineExceeded)
                return {
                    "accepted": False,
                    "message": DEADLINE_MESSAGE,
                    "code": 500,
                }
            except (WasmTrap, WapcError, OpaError, WasiError) as e:
                # guest crash → in-band rejection, mirroring the reference
                # surfacing wasm errors as 500 responses
                return {
                    "accepted": False,
                    "message": f"wasm policy execution failed: {e}",
                    "code": 500,
                }

        def _evaluate_inner(payload: Any) -> Mapping[str, Any]:
            with deadline_scope(self.wall_clock_budget):
                if self.abi == "wapc":
                    # the guest gets the REQUEST; cluster state is served
                    # on demand through the kubernetes capabilities from
                    # the same snapshot slice (no bulk context in-payload)
                    request_doc = (
                        {k: v for k, v in payload.items() if k != CONTEXT_KEY}
                        if isinstance(payload, Mapping)
                        else payload
                    )
                    return self._wapc.validate(
                        request_doc,
                        bound_settings,
                        host_capabilities={
                            **statics,
                            **kubernetes_capabilities(payload),
                        },
                    )
                if self.abi == "wasi":
                    request_doc = (
                        {k: v for k, v in payload.items() if k != CONTEXT_KEY}
                        if isinstance(payload, Mapping)
                        else payload
                    )
                    return self._wasi.validate(request_doc, bound_settings)
                allowed, message = gatekeeper_validate(
                    self._opa, payload, parameters=bound_settings
                )
                return {"accepted": allowed, "message": message}

        return PolicyProgram(
            # the device program never decides for wasm policies; the
            # false() rule keeps the fused-program machinery total
            rules=(Rule("wasm-host-executed", false(), "unreachable"),),
            host_evaluator=evaluate,
        )

    def validate_settings(
        self, settings: Mapping[str, Any]
    ) -> SettingsValidationResponse:
        if self.abi in ("wapc", "wasi"):
            host = self._wapc if self.abi == "wapc" else self._wasi
            try:
                # settings validation runs at boot but executes GUEST code:
                # it needs the same wall-clock cut as evaluate(), or a
                # spinning validate_settings hangs environment build
                with deadline_scope(self.wall_clock_budget):
                    doc = host.validate_settings(dict(settings or {}))
            except WasmFuelExhausted:
                return SettingsValidationResponse(
                    valid=False,
                    message=f"settings validation failed: {DEADLINE_MESSAGE}",
                )
            except (WasmTrap, WapcError, OpaError, WasiError) as e:
                return SettingsValidationResponse(
                    valid=False, message=f"settings validation failed: {e}"
                )
            return SettingsValidationResponse(
                valid=bool(doc.get("valid")), message=doc.get("message")
            )
        return SettingsValidationResponse(valid=True, message=None)
