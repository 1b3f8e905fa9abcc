"""waPC host — the guest-call protocol Kubewarden policies speak.

Reference parity: the reference's engine instantiates a fresh wasm guest
per evaluation and drives it through waPC
(evaluation_environment.rs:513-543; waPC is the ABI of
PolicyExecutionMode::KubewardenWapc modules). The protocol:

* host invokes the guest export ``__guest_call(op_len, payload_len)``;
* the guest allocates buffers and calls back ``__guest_request`` for the
  host to write the operation name and payload;
* the guest answers via ``__guest_response`` / ``__guest_error``;
* ``__host_call`` is the guest→host capability channel (the reference's
  callback_handler seam) — host capabilities are provided as Python
  callables keyed by (namespace, operation).

Kubewarden operations: ``validate`` (payload ``{"request":…,
"settings":…}`` → ``{"accepted":…}``), ``validate_settings``,
``protocol_version``.

Flat payload ABI: policies authored in this repo's WAT subset cannot
carry a full JSON parser, so the host ALSO offers ``validate`` with a
flattened payload (``flatten_payload``: ``key\\0value\\0…`` entries) when
the guest exports the marker global ``__flat_abi``. The flattener is a
direct JSON walk, deliberately independent of ops/codec.py's tensor
encoding — that independence is what makes the wasm differential oracle
non-circular."""

from __future__ import annotations

import json
from typing import Any, Callable, Mapping

from policy_server_tpu_torch.wasm.binary import ensure_module
from policy_server_tpu_torch.wasm.native_exec import make_instance
from policy_server_tpu_torch.wasm.interp import Instance, WasmTrap

HostCapability = Callable[[bytes], bytes]


class WapcError(Exception):
    pass


def _escape_map_key(k: str) -> str:
    """Mapping keys are escaped so a rendered mapping key can never
    contain ``#`` (list-index marker) or ``.`` (path separator): any
    ``#`` in a flat key provably marks list traversal, and any ``.``
    provably separates path segments. Without this, a mapping key like
    ``spec.hostNetwork`` or ``containers.#0.securityContext.privileged``
    (dots inside ONE key) would render byte-identical to a real
    structural path and spoof the WAT oracles' matchers. The tensor
    codec treats such keys as single opaque keys (trie walk is
    structural), so the oracles must see them the same way."""
    return k.replace("%", "%25").replace("#", "%23").replace(".", "%2E")


def flatten_payload(doc: Any, prefix: str = "") -> bytes:
    """JSON → ``key\\0value\\0`` entries (sorted, deterministic).

    Keys: dotted paths; list indices render as ``#N`` segments; mapping
    keys are %-escaped so they can never start with ``#`` (see
    ``_escape_map_key``).

    Values are TYPE-TAGGED with one leading byte so wasm policies can
    tell a JSON string from other scalars rendering to the same text
    (``true`` vs ``"true"`` — an untagged ABI made bool-valued policy
    checks spoofable by strings): ``s`` string (raw bytes follow),
    ``b`` bool (``btrue``/``bfalse``), ``z`` null, ``n`` number
    (JSON text follows)."""
    entries: list[tuple[str, str]] = []

    def walk(node: Any, path: str) -> None:
        if isinstance(node, Mapping):
            for k in sorted(node):
                ek = _escape_map_key(str(k))
                walk(node[k], f"{path}.{ek}" if path else ek)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}.#{i}" if path else f"#{i}")
        else:
            if node is True:
                text = "btrue"
            elif node is False:
                text = "bfalse"
            elif node is None:
                text = "z"
            elif isinstance(node, str):
                text = "s" + node
            else:
                text = "n" + json.dumps(node)
            if "\x00" in path or "\x00" in text:
                # NUL is legal inside JSON strings but is this ABI's entry
                # framing: letting it through would let a request string
                # forge extra key/value entries (policy bypass)
                raise WapcError(
                    "NUL byte in payload key or value cannot be framed in "
                    "the flat ABI"
                )
            entries.append((path, text))

    walk(doc, prefix)
    out = bytearray()
    for k, v in entries:
        out += k.encode() + b"\x00" + v.encode() + b"\x00"
    return bytes(out)


class WapcGuest:
    """A decoded waPC policy module; every call() gets a fresh instance
    (per-request isolation, evaluation_environment.rs:76-84)."""

    def __init__(
        self,
        wasm_bytes: bytes,
        host_capabilities: Mapping[tuple[str, str], HostCapability] | None = None,
        fuel: int | None = 50_000_000,
    ):
        self.module = ensure_module(wasm_bytes)
        self.host_capabilities = dict(host_capabilities or {})
        self.fuel = fuel
        exports = self.module.export_map()
        if "__guest_call" not in exports:
            raise WapcError("not a waPC module (missing __guest_call)")
        self.flat_abi = "__flat_abi" in exports

    def call(
        self,
        operation: str,
        payload: bytes,
        host_capabilities: Mapping[tuple[str, str], HostCapability] | None = None,
    ) -> bytes:
        capabilities = (
            self.host_capabilities
            if host_capabilities is None
            else {**self.host_capabilities, **host_capabilities}
        )
        op_bytes = operation.encode()
        state: dict[str, Any] = {"response": None, "error": None,
                                 "host_response": b"", "host_error": b""}

        def guest_request(inst: Instance, op_ptr: int, payload_ptr: int):
            inst.memory.write(op_ptr, op_bytes)
            inst.memory.write(payload_ptr, payload)

        def guest_response(inst: Instance, ptr: int, length: int):
            state["response"] = inst.memory.read(ptr, length)

        def guest_error(inst: Instance, ptr: int, length: int):
            state["error"] = inst.memory.read(ptr, length)

        def host_call(inst, bd_ptr, bd_len, ns_ptr, ns_len, op_ptr, op_len,
                      ptr, length):
            ns = inst.memory.read(ns_ptr, ns_len).decode()
            op = inst.memory.read(op_ptr, op_len).decode()
            fn = capabilities.get((ns, op))
            if fn is None:
                state["host_error"] = (
                    f"host capability {ns}/{op} not available".encode()
                )
                return 0
            try:
                state["host_response"] = fn(inst.memory.read(ptr, length))
                return 1
            except Exception as e:  # noqa: BLE001 — surfaced to the guest
                state["host_error"] = str(e).encode()
                return 0

        def host_response_len(inst):
            return len(state["host_response"])

        def host_response(inst, ptr):
            inst.memory.write(ptr, state["host_response"])

        def host_error_len(inst):
            return len(state["host_error"])

        def host_error(inst, ptr):
            inst.memory.write(ptr, state["host_error"])

        def console_log(inst, ptr, length):
            pass

        imports = {
            "wapc": {
                "__guest_request": guest_request,
                "__guest_response": guest_response,
                "__guest_error": guest_error,
                "__host_call": host_call,
                "__host_response_len": host_response_len,
                "__host_response": host_response,
                "__host_error_len": host_error_len,
                "__host_error": host_error,
                "__console_log": console_log,
            }
        }
        inst = make_instance(self.module, imports, fuel=self.fuel)
        ok = inst.invoke("__guest_call", len(op_bytes), len(payload))
        if not ok or not ok[0]:
            err = state["error"] or b"guest call failed"
            raise WapcError(err.decode("utf-8", "replace"))
        if state["response"] is None:
            raise WapcError("guest returned no response")
        return state["response"]


class KubewardenWapcPolicy:
    """Kubewarden validate/validate_settings over a waPC guest."""

    def __init__(
        self,
        wasm_bytes: bytes,
        host_capabilities: Mapping[tuple[str, str], HostCapability] | None = None,
        fuel: int | None = 50_000_000,
    ):
        self.guest = WapcGuest(wasm_bytes, host_capabilities, fuel=fuel)

    def validate(
        self,
        request: Mapping[str, Any],
        settings: Mapping[str, Any] | None,
        host_capabilities: Mapping[tuple[str, str], HostCapability] | None = None,
    ) -> dict:
        if self.guest.flat_abi:
            payload = flatten_payload(
                {"request": dict(request), "settings": dict(settings or {})}
            )
        else:
            payload = json.dumps(
                {"request": dict(request), "settings": dict(settings or {})}
            ).encode()
        return _json_object(
            self.guest.call("validate", payload, host_capabilities)
        )

    def validate_settings(self, settings: Mapping[str, Any] | None) -> dict:
        if self.guest.flat_abi:
            payload = flatten_payload(dict(settings or {}))
        else:
            payload = json.dumps(dict(settings or {})).encode()
        return _json_object(self.guest.call("validate_settings", payload))


def _json_object(raw: bytes) -> dict:
    """Guest responses must be JSON objects; anything else is a guest
    protocol error (mapped to an in-band 500 upstream)."""
    try:
        doc = json.loads(raw)
    except ValueError as e:
        raise WapcError(f"guest response is not valid JSON: {e}") from e
    if not isinstance(doc, dict):
        raise WapcError("guest response is not a JSON object")
    return doc
