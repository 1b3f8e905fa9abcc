"""WebAssembly execution substrate (host-side).

The reference's entire evaluation engine is per-request wasm under
wasmtime (src/evaluation/precompiled_policy.rs:46-64,
src/evaluation/evaluation_environment.rs:513-543). This package is its
host-side counterpart — an independent wasm MVP
interpreter plus the policy ABI hosts (OPA/Gatekeeper, waPC) — serving
two roles:

* **multi-ABI policy execution**: ``.wasm`` policy payloads run host-side
  per request (the escape hatch the device path falls back to, and the
  execution path for policies outside the predicate IR);
* **non-circular correctness oracle**: differential tests run REAL wasm
  modules (including upstream-compiled Gatekeeper policies) against the
  device path — the oracle no longer interprets the same IR the device
  compiles, so a shared lowering bug cannot pass silently.

Guests run on a native C++ core (``csrc/wasmint.cpp``, through
``native_exec.make_instance``); the pure Python stack interpreter
(wasm/interp.py) is the semantic reference. Both enforce memory bounds,
type-checked indirect calls, and a fuel limit and wall-clock deadline as
the epoch-interruption analog (src/lib.rs:176-190)."""

from policy_server_tpu_torch.wasm.binary import WasmModule, decode_module
from policy_server_tpu_torch.wasm.interp import Instance, WasmTrap

__all__ = ["WasmModule", "decode_module", "Instance", "WasmTrap"]
