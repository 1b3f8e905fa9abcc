"""WASI policy execution (PolicyExecutionMode::Wasi).

The reference runs WASI policies as wasmtime command modules: the policy
is a program whose argv selects the operation, the request/settings JSON
arrives on stdin, and the verdict JSON leaves on stdout
(src/evaluation/precompiled_policy.rs:46-64; SURVEY.md §2.2
PolicyExecutionMode row). This module provides:

* a ``wasi_snapshot_preview1`` host — the import set command modules
  need (fd_read/fd_write over in-memory stdio, args/environ, proc_exit,
  clocks, random), with ENOSYS stubs for the rest so modules linking
  more of libc still instantiate;
* :class:`WasiPolicy` — one fresh instance per evaluation (the
  rehydrate-per-request isolation, evaluation_environment.rs:76-84),
  protocol: ``argv = [name, operation]``, stdin =
  ``{"request":…, "settings":…}``, stdout = the Kubewarden
  ValidationResponse JSON (same shape as the waPC protocol, wasm/wapc.py).

Fuel bounds runaway guests exactly like the other ABIs.
"""

from __future__ import annotations

import json
import time
from typing import Any, Mapping

from policy_server_tpu_torch.wasm.binary import WasmModule, ensure_module
from policy_server_tpu_torch.wasm.native_exec import make_instance
from policy_server_tpu_torch.wasm.interp import Instance, Memory, WasmTrap

ERRNO_SUCCESS = 0
ERRNO_BADF = 8
ERRNO_NOSYS = 52


class WasiError(Exception):
    pass


class WasiExit(Exception):
    """proc_exit: terminates the guest with an exit code."""

    def __init__(self, code: int):
        super().__init__(f"proc_exit({code})")
        self.code = code


class _WasiState:
    """Per-instantiation stdio + argv."""

    def __init__(self, argv: list[str], stdin: bytes):
        self.argv = [a.encode() for a in argv]
        self.stdin = stdin
        self.stdin_pos = 0
        self.stdout = bytearray()
        self.stderr = bytearray()


def _u32(mem: Memory, addr: int) -> int:
    return int.from_bytes(mem.read(addr, 4), "little")


def _store_u32(mem: Memory, addr: int, value: int) -> None:
    mem.write(addr, (value & 0xFFFFFFFF).to_bytes(4, "little"))


def _store_u64(mem: Memory, addr: int, value: int) -> None:
    mem.write(addr, (value & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little"))


def make_wasi_imports(state: _WasiState) -> dict[str, Any]:
    """The wasi_snapshot_preview1 function table over one state."""

    def fd_read(inst: Instance, fd: int, iovs: int, iovs_len: int, nread_ptr: int) -> int:
        if fd != 0:
            return ERRNO_BADF
        mem = inst.memory
        total = 0
        for i in range(iovs_len):
            buf_ptr = _u32(mem, iovs + 8 * i)
            buf_len = _u32(mem, iovs + 8 * i + 4)
            remaining = len(state.stdin) - state.stdin_pos
            n = min(buf_len, remaining)
            if n:
                mem.write(
                    buf_ptr, state.stdin[state.stdin_pos : state.stdin_pos + n]
                )
                state.stdin_pos += n
                total += n
            if n < buf_len:
                break
        _store_u32(mem, nread_ptr, total)
        return ERRNO_SUCCESS

    def fd_write(inst: Instance, fd: int, ciovs: int, ciovs_len: int, nwritten_ptr: int) -> int:
        if fd not in (1, 2):
            return ERRNO_BADF
        sink = state.stdout if fd == 1 else state.stderr
        mem = inst.memory
        total = 0
        for i in range(ciovs_len):
            buf_ptr = _u32(mem, ciovs + 8 * i)
            buf_len = _u32(mem, ciovs + 8 * i + 4)
            sink.extend(mem.read(buf_ptr, buf_len))
            total += buf_len
        _store_u32(mem, nwritten_ptr, total)
        return ERRNO_SUCCESS

    def args_sizes_get(inst: Instance, argc_ptr: int, buf_size_ptr: int) -> int:
        _store_u32(inst.memory, argc_ptr, len(state.argv))
        _store_u32(
            inst.memory, buf_size_ptr, sum(len(a) + 1 for a in state.argv)
        )
        return ERRNO_SUCCESS

    def args_get(inst: Instance, argv_ptr: int, buf_ptr: int) -> int:
        mem = inst.memory
        offset = buf_ptr
        for i, arg in enumerate(state.argv):
            _store_u32(mem, argv_ptr + 4 * i, offset)
            mem.write(offset, arg + b"\x00")
            offset += len(arg) + 1
        return ERRNO_SUCCESS

    def environ_sizes_get(inst: Instance, count_ptr: int, size_ptr: int) -> int:
        _store_u32(inst.memory, count_ptr, 0)
        _store_u32(inst.memory, size_ptr, 0)
        return ERRNO_SUCCESS

    def environ_get(inst: Instance, env_ptr: int, buf_ptr: int) -> int:
        return ERRNO_SUCCESS

    def proc_exit(inst: Instance, code: int) -> None:
        raise WasiExit(code)

    def fd_close(inst: Instance, fd: int) -> int:
        return ERRNO_SUCCESS

    def fd_fdstat_get(inst: Instance, fd: int, ptr: int) -> int:
        if fd > 2:
            return ERRNO_BADF
        # filetype=character_device(2), zero flags/rights
        inst.memory.write(ptr, bytes([2]) + b"\x00" * 23)
        return ERRNO_SUCCESS

    def fd_seek(inst: Instance, fd: int, offset: int, whence: int, new_ptr: int) -> int:
        return 29  # ESPIPE: stdio is not seekable

    def fd_prestat_get(inst: Instance, fd: int, ptr: int) -> int:
        return ERRNO_BADF  # no preopened directories

    def fd_prestat_dir_name(inst: Instance, fd: int, ptr: int, n: int) -> int:
        return ERRNO_BADF

    def random_get(inst: Instance, buf: int, n: int) -> int:
        # deterministic stream: policies must not branch on entropy, and
        # reproducible evaluations keep the differential harness exact
        inst.memory.write(buf, bytes(((i * 97 + 13) & 0xFF) for i in range(n)))
        return ERRNO_SUCCESS

    def clock_time_get(inst: Instance, clock_id: int, precision: int, out_ptr: int) -> int:
        _store_u64(inst.memory, out_ptr, time.time_ns())
        return ERRNO_SUCCESS

    def sched_yield(inst: Instance) -> int:
        return ERRNO_SUCCESS

    return {
        "fd_read": fd_read,
        "fd_write": fd_write,
        "args_sizes_get": args_sizes_get,
        "args_get": args_get,
        "environ_sizes_get": environ_sizes_get,
        "environ_get": environ_get,
        "proc_exit": proc_exit,
        "fd_close": fd_close,
        "fd_fdstat_get": fd_fdstat_get,
        "fd_seek": fd_seek,
        "fd_prestat_get": fd_prestat_get,
        "fd_prestat_dir_name": fd_prestat_dir_name,
        "random_get": random_get,
        "clock_time_get": clock_time_get,
        "sched_yield": sched_yield,
    }


def _nosys_stub(name: str):
    def stub(inst: Instance, *args: int) -> int:
        return ERRNO_NOSYS

    stub.__name__ = f"wasi_{name}_nosys"
    return stub


class WasiPolicy:
    """A decoded WASI command module; fresh instance per evaluation."""

    def __init__(self, wasm_bytes: bytes | WasmModule, fuel: int | None = 50_000_000):
        self.module: WasmModule = ensure_module(wasm_bytes)
        self.fuel = fuel
        exports = {e.name for e in self.module.exports}
        if "_start" not in exports:
            raise WasiError("not a WASI command module (no _start export)")
        self.name = "wasi-policy"

    def _run(self, operation: str, payload: Mapping[str, Any]) -> dict:
        state = _WasiState(
            argv=[self.name, operation],
            stdin=json.dumps(payload, separators=(",", ":")).encode(),
        )
        table = make_wasi_imports(state)
        imports: dict[str, Any] = {}
        for imp in self.module.imports:
            if imp.module == "wasi_snapshot_preview1" and imp.kind == "func":
                imports.setdefault(imp.module, {})[imp.name] = (
                    table.get(imp.name) or _nosys_stub(imp.name)
                )
            elif imp.kind == "memory":
                imports.setdefault(imp.module, {})[imp.name] = Memory(imp.desc)
        inst = make_instance(self.module, imports, fuel=self.fuel)
        code = 0
        try:
            inst.invoke("_start")
        except WasiExit as e:
            code = e.code
        if code != 0:
            err = bytes(state.stderr).decode("utf-8", "replace").strip()
            raise WasiError(
                f"wasi policy exited with code {code}"
                + (f": {err}" if err else "")
            )
        out = bytes(state.stdout).decode("utf-8", "replace").strip()
        if not out:
            raise WasiError("wasi policy produced no output")
        try:
            doc = json.loads(out)
        except json.JSONDecodeError as e:
            raise WasiError(f"wasi policy output is not JSON: {e}") from e
        if not isinstance(doc, dict):
            raise WasiError("wasi policy output must be a JSON object")
        return doc

    def validate(
        self, request: Mapping[str, Any], settings: Mapping[str, Any] | None
    ) -> dict:
        return self._run(
            "validate",
            {"request": dict(request), "settings": dict(settings or {})},
        )

    def validate_settings(self, settings: Mapping[str, Any] | None) -> dict:
        return self._run("validate-settings", dict(settings or {}))
