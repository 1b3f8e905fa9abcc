"""WebAssembly interpreter — the execution half of the wasm substrate.

A classic stack machine over the pre-decoded flat instruction lists from
wasm/binary.py. Design choices:

* **Correctness over speed**: this backs the differential oracle and the
  host-side wasm policy path, not the device hot loop. Semantics follow the
  core spec: 32/64-bit wraparound, trap on OOB access / div-by-zero /
  bad indirect call, NaN-correct float ops where Python's floats agree.
* **Fuel limit** as the epoch-interruption analog (src/lib.rs:176-190):
  every executed instruction costs 1 fuel; exhaustion raises
  :class:`WasmFuelExhausted` and the caller maps it to the reference's
  "execution deadline exceeded" semantics.
* **Wall-clock deadline**: fuel bounds instructions, not time — a slow-
  but-terminating guest can exceed the policy timeout in real time
  without exhausting fuel. :func:`deadline_scope` arms an ambient
  (thread-local) absolute deadline; the dispatch loop checks the clock
  every 65536 instructions (piggybacked on the fuel countdown, ~ms
  granularity) and raises :class:`WasmDeadlineExceeded`, which IS a
  WasmFuelExhausted so callers map both to the reference's wall-clock
  epoch semantics (src/lib.rs:176-190).
* **Host imports** are plain Python callables registered per module+name;
  imported memories come from the embedder (the OPA ABI imports
  ``env.memory``).
"""

from __future__ import annotations

import contextlib
import math
import struct
import threading
import time
from typing import Any, Callable, Iterator, Mapping

from policy_server_tpu_torch.wasm.binary import (
    ELSE,
    END,
    F32,
    F64,
    I32,
    I64,
    FuncType,
    Limits,
    WasmModule,
)

PAGE_SIZE = 65536

_U32 = 0xFFFFFFFF
_U64 = 0xFFFFFFFFFFFFFFFF


class WasmTrap(Exception):
    pass


class WasmFuelExhausted(WasmTrap):
    pass


class WasmDeadlineExceeded(WasmFuelExhausted):
    """Wall-clock budget exceeded (subclasses WasmFuelExhausted so every
    caller's deadline mapping covers both)."""


_ambient = threading.local()


@contextlib.contextmanager
def deadline_scope(seconds: float | None) -> Iterator[None]:
    """Arm a wall-clock budget for Instances created on this thread within
    the scope (nested scopes keep the TIGHTER deadline). ``None`` is a
    no-op — deadline disabled, reference parity with --policy-timeout 0."""
    if seconds is None:
        yield
        return
    prev = getattr(_ambient, "deadline", None)
    mine = time.monotonic() + seconds
    _ambient.deadline = mine if prev is None else min(prev, mine)
    try:
        yield
    finally:
        _ambient.deadline = prev


def _i32(v: int) -> int:
    v &= _U32
    return v - (1 << 32) if v & 0x80000000 else v


def _i64(v: int) -> int:
    v &= _U64
    return v - (1 << 64) if v & 0x8000000000000000 else v


def _u32(v: int) -> int:
    return v & _U32


def _u64(v: int) -> int:
    return v & _U64


def _f32(v: float) -> float:
    return struct.unpack("<f", struct.pack("<f", v))[0]


class Memory:
    """Linear memory with page-granular growth."""

    __slots__ = ("data", "maximum")

    def __init__(self, limits: Limits):
        self.data = bytearray(limits.minimum * PAGE_SIZE)
        self.maximum = limits.maximum

    @property
    def pages(self) -> int:
        return len(self.data) // PAGE_SIZE

    def grow(self, delta: int) -> int:
        old = self.pages
        new = old + delta
        if self.maximum is not None and new > self.maximum:
            return -1
        if new > 65536:
            return -1
        self.data.extend(b"\x00" * (delta * PAGE_SIZE))
        return old

    def read(self, addr: int, n: int) -> bytes:
        if addr < 0 or addr + n > len(self.data):
            raise WasmTrap("out of bounds memory access")
        return bytes(self.data[addr : addr + n])

    def write(self, addr: int, payload: bytes) -> None:
        if addr < 0 or addr + len(payload) > len(self.data):
            raise WasmTrap("out of bounds memory access")
        self.data[addr : addr + len(payload)] = payload


class HostFunc:
    __slots__ = ("fn", "functype")

    def __init__(self, fn: Callable, functype: FuncType):
        self.fn = fn
        self.functype = functype


class _Func:
    """A resolved module function (imported or local)."""

    __slots__ = ("functype", "host", "body", "locals")

    def __init__(self, functype, host=None, body=None, locals_=None):
        self.functype = functype
        self.host = host
        self.body = body
        self.locals = locals_ or []


class Instance:
    """One instantiated module: memories/tables/globals bound, start run."""

    def __init__(
        self,
        module: WasmModule,
        imports: Mapping[str, Mapping[str, Any]] | None = None,
        fuel: int | None = 500_000_000,
    ):
        self.module = module
        # ambient wall-clock deadline (deadline_scope) captured at
        # instantiation; the check piggybacks on the fuel countdown, so a
        # deadline with fuel disabled arms an effectively-infinite tank
        self.deadline = getattr(_ambient, "deadline", None)
        if self.deadline is not None and fuel is None:
            fuel = 1 << 62
        self.fuel = fuel
        imports = imports or {}
        self.funcs: list[_Func] = []
        self.memories: list[Memory] = []
        self.tables: list[list[int | None]] = []
        self.globals: list[list] = []  # [valtype, value] mutable cells
        self.dropped_data: set[int] = set()

        for imp in module.imports:
            provided = (imports.get(imp.module) or {}).get(imp.name)
            if provided is None:
                raise WasmTrap(
                    f"missing import {imp.module}.{imp.name} ({imp.kind})"
                )
            if imp.kind == "func":
                ft = module.types[imp.desc]
                if isinstance(provided, HostFunc):
                    self.funcs.append(_Func(provided.functype, host=provided.fn))
                else:
                    self.funcs.append(_Func(ft, host=provided))
            elif imp.kind == "memory":
                if not isinstance(provided, Memory):
                    raise WasmTrap("memory import must be a Memory")
                self.memories.append(provided)
            elif imp.kind == "table":
                self.tables.append(provided)
            elif imp.kind == "global":
                self.globals.append(provided)

        for i, typeidx in enumerate(module.functions):
            body = module.code[i]
            self.funcs.append(
                _Func(module.types[typeidx], body=body.code, locals_=body.locals)
            )
        for limits in module.memories:
            self.memories.append(Memory(limits))
        for limits in module.tables:
            self.tables.append([None] * limits.minimum)
        for g in module.globals:
            self.globals.append([g.valtype, self._const_eval(g.init)])

        for seg in module.elems:
            offset = self._const_eval(seg.offset)
            table = self.tables[seg.table]
            if offset + len(seg.func_indices) > len(table):
                raise WasmTrap("element segment out of bounds")
            for j, fidx in enumerate(seg.func_indices):
                table[offset + j] = fidx
        for idx, seg in enumerate(module.data):
            if seg.offset is None:
                continue  # passive
            offset = self._const_eval(seg.offset)
            self.memories[seg.memory].write(offset, seg.data)

        self._exports = module.export_map()
        if module.start is not None:
            self._call_index(module.start, [])

    # -- public API ---------------------------------------------------------

    @property
    def memory(self) -> Memory:
        return self.memories[0]

    def invoke(self, name: str, *args: int | float) -> list:
        exp = self._exports.get(name)
        if exp is None or exp.kind != "func":
            raise WasmTrap(f"no exported function {name!r}")
        return self._call_index(exp.index, list(args))

    def global_value(self, name: str):
        exp = self._exports.get(name)
        if exp is None or exp.kind != "global":
            raise WasmTrap(f"no exported global {name!r}")
        return self.globals[exp.index][1]

    # -- internals ----------------------------------------------------------

    def _const_eval(self, expr: list):
        stack: list = []
        for op, imm in expr:
            if op in (0x41, 0x42, 0x43, 0x44):
                stack.append(imm)
            elif op == 0x23:  # global.get
                stack.append(self.globals[imm][1])
            else:
                raise WasmTrap(f"unsupported const instr 0x{op:02x}")
        return stack[-1] if stack else 0

    def _call_index(self, index: int, args: list) -> list:
        fn = self.funcs[index]
        if fn.host is not None:
            result = fn.host(self, *args)
            if result is None:
                return []
            if isinstance(result, tuple):
                return list(result)
            return [result]
        return self._exec(fn, args)

    def _block_arity(self, bt) -> tuple[int, int]:
        """(param_count, result_count) of a blocktype."""
        if bt is None:
            return 0, 0
        if isinstance(bt, int) and bt in (I32, I64, F32, F64):
            return 0, 1
        ft = self.module.types[bt]
        return len(ft.params), len(ft.results)

    def _exec(self, fn: _Func, args: list) -> list:  # noqa: C901 —
        # the dispatch loop is one deliberate monolith: a function call per
        # opcode would dominate runtime
        module = self.module
        mem = self.memories[0] if self.memories else None
        locals_: list = list(args) + [
            0.0 if t in (F32, F64) else 0 for t in fn.locals
        ]
        stack: list = []
        # control stack entries: (label_pc, stack_height, arity, is_loop)
        ctrl: list = []
        code = fn.body
        pc = 0
        fuel = self.fuel
        deadline = self.deadline

        while True:
            if fuel is not None:
                fuel -= 1
                if fuel <= 0:
                    self.fuel = 0
                    raise WasmFuelExhausted("wasm fuel exhausted")
                if (
                    deadline is not None
                    and (fuel & 0xFFFF) == 0
                    and time.monotonic() >= deadline
                ):
                    self.fuel = fuel
                    raise WasmDeadlineExceeded(
                        "wasm wall-clock deadline exceeded"
                    )
            op, imm = code[pc]

            if op == 0x20:  # local.get
                stack.append(locals_[imm])
            elif op == 0x21:  # local.set
                locals_[imm] = stack.pop()
            elif op == 0x22:  # local.tee
                locals_[imm] = stack[-1]
            elif op == 0x41 or op == 0x42 or op == 0x43 or op == 0x44:
                stack.append(imm)
            elif op == 0x28:  # i32.load
                stack.append(
                    _i32(
                        int.from_bytes(
                            mem.read(_u32(stack.pop()) + imm, 4), "little"
                        )
                    )
                )
            elif op == 0x36:  # i32.store
                v = stack.pop()
                mem.write(_u32(stack.pop()) + imm, _u32(v).to_bytes(4, "little"))
            elif op == 0x02:  # block
                bt, end = imm
                params, results = self._block_arity(bt)
                ctrl.append((end, len(stack) - params, results, False))
            elif op == 0x03:  # loop
                bt, end = imm
                params, _results = self._block_arity(bt)
                ctrl.append((pc, len(stack) - params, params, True))
            elif op == 0x04:  # if
                bt, end, else_idx = imm
                cond = stack.pop()
                params, results = self._block_arity(bt)
                if cond:
                    ctrl.append((end, len(stack) - params, results, False))
                elif else_idx is not None:
                    ctrl.append((end, len(stack) - params, results, False))
                    pc = else_idx  # +1 below → first else-body instruction
                else:
                    pc = end  # +1 below → past END; no frame was pushed
            elif op == ELSE:
                # reached from the then-branch: jump to block end
                pc = imm
                ctrl.pop()
            elif op == END:
                if ctrl:
                    ctrl.pop()
                else:
                    ft = fn.functype
                    n = len(ft.results)
                    self.fuel = fuel  # writeback: consumed fuel must not
                    return stack[-n:] if n else []  # refund to the caller
            elif op == 0x0C:  # br
                npc = self._branch(imm, ctrl, stack)
                if npc is None:  # br targeting the function body = return
                    n = len(fn.functype.results)
                    self.fuel = fuel
                    return stack[-n:] if n else []
                pc = npc
                continue
            elif op == 0x0D:  # br_if
                if stack.pop():
                    npc = self._branch(imm, ctrl, stack)
                    if npc is None:
                        n = len(fn.functype.results)
                        self.fuel = fuel
                        return stack[-n:] if n else []
                    pc = npc
                    continue
            elif op == 0x0E:  # br_table
                targets, default = imm
                i = _u32(stack.pop())
                label = targets[i] if i < len(targets) else default
                npc = self._branch(label, ctrl, stack)
                if npc is None:
                    n = len(fn.functype.results)
                    self.fuel = fuel
                    return stack[-n:] if n else []
                pc = npc
                continue
            elif op == 0x0F:  # return
                ft = fn.functype
                n = len(ft.results)
                self.fuel = fuel
                return stack[-n:] if n else []
            elif op == 0x10:  # call
                callee = self.funcs[imm]
                n = len(callee.functype.params)
                call_args = stack[len(stack) - n :] if n else []
                del stack[len(stack) - n :]
                self.fuel = fuel
                stack.extend(self._call_index(imm, call_args))
                fuel = self.fuel
            elif op == 0x11:  # call_indirect
                typeidx, table_idx = imm
                elem = _u32(stack.pop())
                table = self.tables[table_idx]
                if elem >= len(table) or table[elem] is None:
                    raise WasmTrap("undefined element")
                findex = table[elem]
                callee = self.funcs[findex]
                if callee.functype != module.types[typeidx]:
                    raise WasmTrap("indirect call type mismatch")
                n = len(callee.functype.params)
                call_args = stack[len(stack) - n :] if n else []
                del stack[len(stack) - n :]
                self.fuel = fuel
                stack.extend(self._call_index(findex, call_args))
                fuel = self.fuel
            elif op == 0x00:
                raise WasmTrap("unreachable")
            elif op == 0x01:
                pass  # nop
            elif op == 0x1A:  # drop
                stack.pop()
            elif op == 0x1B:  # select
                c = stack.pop()
                b = stack.pop()
                a = stack.pop()
                stack.append(a if c else b)
            elif op == 0x23:  # global.get
                stack.append(self.globals[imm][1])
            elif op == 0x24:  # global.set
                self.globals[imm][1] = stack.pop()
            # ---- loads -----------------------------------------------------
            elif op == 0x29:  # i64.load
                stack.append(
                    _i64(int.from_bytes(mem.read(_u32(stack.pop()) + imm, 8), "little"))
                )
            elif op == 0x2A:  # f32.load
                stack.append(struct.unpack("<f", mem.read(_u32(stack.pop()) + imm, 4))[0])
            elif op == 0x2B:  # f64.load
                stack.append(struct.unpack("<d", mem.read(_u32(stack.pop()) + imm, 8))[0])
            elif op == 0x2C:  # i32.load8_s
                stack.append(
                    int.from_bytes(mem.read(_u32(stack.pop()) + imm, 1), "little", signed=True)
                )
            elif op == 0x2D:  # i32.load8_u
                stack.append(mem.read(_u32(stack.pop()) + imm, 1)[0])
            elif op == 0x2E:  # i32.load16_s
                stack.append(
                    int.from_bytes(mem.read(_u32(stack.pop()) + imm, 2), "little", signed=True)
                )
            elif op == 0x2F:  # i32.load16_u
                stack.append(int.from_bytes(mem.read(_u32(stack.pop()) + imm, 2), "little"))
            elif op == 0x30:  # i64.load8_s
                stack.append(
                    int.from_bytes(mem.read(_u32(stack.pop()) + imm, 1), "little", signed=True)
                )
            elif op == 0x31:
                stack.append(mem.read(_u32(stack.pop()) + imm, 1)[0])
            elif op == 0x32:
                stack.append(
                    int.from_bytes(mem.read(_u32(stack.pop()) + imm, 2), "little", signed=True)
                )
            elif op == 0x33:
                stack.append(int.from_bytes(mem.read(_u32(stack.pop()) + imm, 2), "little"))
            elif op == 0x34:  # i64.load32_s
                stack.append(
                    int.from_bytes(mem.read(_u32(stack.pop()) + imm, 4), "little", signed=True)
                )
            elif op == 0x35:  # i64.load32_u
                stack.append(int.from_bytes(mem.read(_u32(stack.pop()) + imm, 4), "little"))
            # ---- stores ----------------------------------------------------
            elif op == 0x37:  # i64.store
                v = stack.pop()
                mem.write(_u32(stack.pop()) + imm, _u64(v).to_bytes(8, "little"))
            elif op == 0x38:  # f32.store
                v = stack.pop()
                mem.write(_u32(stack.pop()) + imm, struct.pack("<f", v))
            elif op == 0x39:  # f64.store
                v = stack.pop()
                mem.write(_u32(stack.pop()) + imm, struct.pack("<d", v))
            elif op == 0x3A:  # i32.store8
                v = stack.pop()
                mem.write(_u32(stack.pop()) + imm, bytes([_u32(v) & 0xFF]))
            elif op == 0x3B:  # i32.store16
                v = stack.pop()
                mem.write(_u32(stack.pop()) + imm, (_u32(v) & 0xFFFF).to_bytes(2, "little"))
            elif op == 0x3C:  # i64.store8
                v = stack.pop()
                mem.write(_u32(stack.pop()) + imm, bytes([_u64(v) & 0xFF]))
            elif op == 0x3D:  # i64.store16
                v = stack.pop()
                mem.write(_u32(stack.pop()) + imm, (_u64(v) & 0xFFFF).to_bytes(2, "little"))
            elif op == 0x3E:  # i64.store32
                v = stack.pop()
                mem.write(_u32(stack.pop()) + imm, (_u64(v) & _U32).to_bytes(4, "little"))
            elif op == 0x3F:  # memory.size
                stack.append(mem.pages)
            elif op == 0x40:  # memory.grow
                stack.append(mem.grow(_u32(stack.pop())))
            # ---- i32 compare/arith ----------------------------------------
            elif op == 0x45:  # i32.eqz
                stack.append(1 if stack.pop() == 0 else 0)
            elif op == 0x46:
                stack.append(1 if _u32(stack.pop()) == _u32(stack.pop()) else 0)
            elif op == 0x47:
                stack.append(1 if _u32(stack.pop()) != _u32(stack.pop()) else 0)
            elif op == 0x48:  # i32.lt_s
                b, a = _i32(stack.pop()), _i32(stack.pop())
                stack.append(1 if a < b else 0)
            elif op == 0x49:  # i32.lt_u
                b, a = _u32(stack.pop()), _u32(stack.pop())
                stack.append(1 if a < b else 0)
            elif op == 0x4A:  # i32.gt_s
                b, a = _i32(stack.pop()), _i32(stack.pop())
                stack.append(1 if a > b else 0)
            elif op == 0x4B:  # i32.gt_u
                b, a = _u32(stack.pop()), _u32(stack.pop())
                stack.append(1 if a > b else 0)
            elif op == 0x4C:  # i32.le_s
                b, a = _i32(stack.pop()), _i32(stack.pop())
                stack.append(1 if a <= b else 0)
            elif op == 0x4D:  # i32.le_u
                b, a = _u32(stack.pop()), _u32(stack.pop())
                stack.append(1 if a <= b else 0)
            elif op == 0x4E:  # i32.ge_s
                b, a = _i32(stack.pop()), _i32(stack.pop())
                stack.append(1 if a >= b else 0)
            elif op == 0x4F:  # i32.ge_u
                b, a = _u32(stack.pop()), _u32(stack.pop())
                stack.append(1 if a >= b else 0)
            # ---- i64 compare ----------------------------------------------
            elif op == 0x50:
                stack.append(1 if stack.pop() == 0 else 0)
            elif op == 0x51:
                stack.append(1 if _u64(stack.pop()) == _u64(stack.pop()) else 0)
            elif op == 0x52:
                stack.append(1 if _u64(stack.pop()) != _u64(stack.pop()) else 0)
            elif op == 0x53:
                b, a = _i64(stack.pop()), _i64(stack.pop())
                stack.append(1 if a < b else 0)
            elif op == 0x54:
                b, a = _u64(stack.pop()), _u64(stack.pop())
                stack.append(1 if a < b else 0)
            elif op == 0x55:
                b, a = _i64(stack.pop()), _i64(stack.pop())
                stack.append(1 if a > b else 0)
            elif op == 0x56:
                b, a = _u64(stack.pop()), _u64(stack.pop())
                stack.append(1 if a > b else 0)
            elif op == 0x57:
                b, a = _i64(stack.pop()), _i64(stack.pop())
                stack.append(1 if a <= b else 0)
            elif op == 0x58:
                b, a = _u64(stack.pop()), _u64(stack.pop())
                stack.append(1 if a <= b else 0)
            elif op == 0x59:
                b, a = _i64(stack.pop()), _i64(stack.pop())
                stack.append(1 if a >= b else 0)
            elif op == 0x5A:
                b, a = _u64(stack.pop()), _u64(stack.pop())
                stack.append(1 if a >= b else 0)
            # ---- float compare --------------------------------------------
            elif op in (0x5B, 0x61):  # f32.eq / f64.eq
                b, a = stack.pop(), stack.pop()
                stack.append(1 if a == b else 0)
            elif op in (0x5C, 0x62):
                b, a = stack.pop(), stack.pop()
                stack.append(1 if a != b else 0)
            elif op in (0x5D, 0x63):
                b, a = stack.pop(), stack.pop()
                stack.append(1 if a < b else 0)
            elif op in (0x5E, 0x64):
                b, a = stack.pop(), stack.pop()
                stack.append(1 if a > b else 0)
            elif op in (0x5F, 0x65):
                b, a = stack.pop(), stack.pop()
                stack.append(1 if a <= b else 0)
            elif op in (0x60, 0x66):
                b, a = stack.pop(), stack.pop()
                stack.append(1 if a >= b else 0)
            # ---- i32 arithmetic -------------------------------------------
            elif op == 0x67:  # i32.clz
                v = _u32(stack.pop())
                stack.append(32 if v == 0 else 31 - v.bit_length() + 1)
            elif op == 0x68:  # i32.ctz
                v = _u32(stack.pop())
                stack.append(32 if v == 0 else (v & -v).bit_length() - 1)
            elif op == 0x69:  # i32.popcnt
                stack.append(bin(_u32(stack.pop())).count("1"))
            elif op == 0x6A:
                b, a = stack.pop(), stack.pop()
                stack.append(_i32(a + b))
            elif op == 0x6B:
                b, a = stack.pop(), stack.pop()
                stack.append(_i32(a - b))
            elif op == 0x6C:
                b, a = stack.pop(), stack.pop()
                stack.append(_i32(a * b))
            elif op == 0x6D:  # i32.div_s
                b, a = _i32(stack.pop()), _i32(stack.pop())
                if b == 0:
                    raise WasmTrap("integer divide by zero")
                q = abs(a) // abs(b)
                q = -q if (a < 0) != (b < 0) else q
                if q > 0x7FFFFFFF:
                    raise WasmTrap("integer overflow")
                stack.append(_i32(q))
            elif op == 0x6E:  # i32.div_u
                b, a = _u32(stack.pop()), _u32(stack.pop())
                if b == 0:
                    raise WasmTrap("integer divide by zero")
                stack.append(_i32(a // b))
            elif op == 0x6F:  # i32.rem_s
                b, a = _i32(stack.pop()), _i32(stack.pop())
                if b == 0:
                    raise WasmTrap("integer divide by zero")
                r = abs(a) % abs(b)
                stack.append(_i32(-r if a < 0 else r))
            elif op == 0x70:  # i32.rem_u
                b, a = _u32(stack.pop()), _u32(stack.pop())
                if b == 0:
                    raise WasmTrap("integer divide by zero")
                stack.append(_i32(a % b))
            elif op == 0x71:
                b, a = stack.pop(), stack.pop()
                stack.append(_i32(_u32(a) & _u32(b)))
            elif op == 0x72:
                b, a = stack.pop(), stack.pop()
                stack.append(_i32(_u32(a) | _u32(b)))
            elif op == 0x73:
                b, a = stack.pop(), stack.pop()
                stack.append(_i32(_u32(a) ^ _u32(b)))
            elif op == 0x74:  # i32.shl
                b, a = stack.pop(), stack.pop()
                stack.append(_i32(_u32(a) << (b & 31)))
            elif op == 0x75:  # i32.shr_s
                b, a = stack.pop(), _i32(stack.pop())
                stack.append(_i32(a >> (b & 31)))
            elif op == 0x76:  # i32.shr_u
                b, a = stack.pop(), _u32(stack.pop())
                stack.append(_i32(a >> (b & 31)))
            elif op == 0x77:  # i32.rotl
                b, a = stack.pop() & 31, _u32(stack.pop())
                stack.append(_i32(((a << b) | (a >> (32 - b))) & _U32))
            elif op == 0x78:  # i32.rotr
                b, a = stack.pop() & 31, _u32(stack.pop())
                stack.append(_i32(((a >> b) | (a << (32 - b))) & _U32))
            # ---- i64 arithmetic -------------------------------------------
            elif op == 0x79:
                v = _u64(stack.pop())
                stack.append(64 if v == 0 else 64 - v.bit_length())
            elif op == 0x7A:
                v = _u64(stack.pop())
                stack.append(64 if v == 0 else (v & -v).bit_length() - 1)
            elif op == 0x7B:
                stack.append(bin(_u64(stack.pop())).count("1"))
            elif op == 0x7C:
                b, a = stack.pop(), stack.pop()
                stack.append(_i64(a + b))
            elif op == 0x7D:
                b, a = stack.pop(), stack.pop()
                stack.append(_i64(a - b))
            elif op == 0x7E:
                b, a = stack.pop(), stack.pop()
                stack.append(_i64(a * b))
            elif op == 0x7F:
                b, a = _i64(stack.pop()), _i64(stack.pop())
                if b == 0:
                    raise WasmTrap("integer divide by zero")
                q = abs(a) // abs(b)
                q = -q if (a < 0) != (b < 0) else q
                if q > 0x7FFFFFFFFFFFFFFF:
                    raise WasmTrap("integer overflow")
                stack.append(_i64(q))
            elif op == 0x80:
                b, a = _u64(stack.pop()), _u64(stack.pop())
                if b == 0:
                    raise WasmTrap("integer divide by zero")
                stack.append(_i64(a // b))
            elif op == 0x81:
                b, a = _i64(stack.pop()), _i64(stack.pop())
                if b == 0:
                    raise WasmTrap("integer divide by zero")
                r = abs(a) % abs(b)
                stack.append(_i64(-r if a < 0 else r))
            elif op == 0x82:
                b, a = _u64(stack.pop()), _u64(stack.pop())
                if b == 0:
                    raise WasmTrap("integer divide by zero")
                stack.append(_i64(a % b))
            elif op == 0x83:
                b, a = stack.pop(), stack.pop()
                stack.append(_i64(_u64(a) & _u64(b)))
            elif op == 0x84:
                b, a = stack.pop(), stack.pop()
                stack.append(_i64(_u64(a) | _u64(b)))
            elif op == 0x85:
                b, a = stack.pop(), stack.pop()
                stack.append(_i64(_u64(a) ^ _u64(b)))
            elif op == 0x86:
                b, a = stack.pop(), stack.pop()
                stack.append(_i64(_u64(a) << (b & 63)))
            elif op == 0x87:
                b, a = stack.pop(), _i64(stack.pop())
                stack.append(_i64(a >> (b & 63)))
            elif op == 0x88:
                b, a = stack.pop(), _u64(stack.pop())
                stack.append(_i64(a >> (b & 63)))
            elif op == 0x89:
                b, a = stack.pop() & 63, _u64(stack.pop())
                stack.append(_i64(((a << b) | (a >> (64 - b))) & _U64))
            elif op == 0x8A:
                b, a = stack.pop() & 63, _u64(stack.pop())
                stack.append(_i64(((a >> b) | (a << (64 - b))) & _U64))
            # ---- float arithmetic -----------------------------------------
            elif op in (0x8B, 0x99):  # abs
                stack.append(abs(stack.pop()))
            elif op in (0x8C, 0x9A):  # neg
                stack.append(-stack.pop())
            elif op in (0x8D, 0x9B):  # ceil
                stack.append(float(math.ceil(stack.pop())))
            elif op in (0x8E, 0x9C):  # floor
                stack.append(float(math.floor(stack.pop())))
            elif op in (0x8F, 0x9D):  # trunc
                stack.append(float(math.trunc(stack.pop())))
            elif op in (0x90, 0x9E):  # nearest
                v = stack.pop()
                f = math.floor(v)
                d = v - f
                if d > 0.5:
                    n = f + 1
                elif d < 0.5:
                    n = f
                else:
                    n = f if f % 2 == 0 else f + 1
                stack.append(float(n))
            elif op in (0x91, 0x9F):  # sqrt
                stack.append(math.sqrt(stack.pop()))
            elif op == 0x92:
                b, a = stack.pop(), stack.pop()
                stack.append(_f32(a + b))
            elif op == 0x93:
                b, a = stack.pop(), stack.pop()
                stack.append(_f32(a - b))
            elif op == 0x94:
                b, a = stack.pop(), stack.pop()
                stack.append(_f32(a * b))
            elif op == 0x95:
                b, a = stack.pop(), stack.pop()
                stack.append(_f32(a / b) if b != 0 else math.copysign(math.inf, a) * math.copysign(1, b) if a != 0 else math.nan)
            elif op == 0x96:  # f32.min
                b, a = stack.pop(), stack.pop()
                stack.append(min(a, b))
            elif op == 0x97:
                b, a = stack.pop(), stack.pop()
                stack.append(max(a, b))
            elif op == 0x98:  # f32.copysign
                b, a = stack.pop(), stack.pop()
                stack.append(math.copysign(a, b))
            elif op == 0xA0:
                b, a = stack.pop(), stack.pop()
                stack.append(a + b)
            elif op == 0xA1:
                b, a = stack.pop(), stack.pop()
                stack.append(a - b)
            elif op == 0xA2:
                b, a = stack.pop(), stack.pop()
                stack.append(a * b)
            elif op == 0xA3:  # f64.div
                b, a = stack.pop(), stack.pop()
                if b == 0:
                    stack.append(
                        math.nan if a == 0 else math.copysign(math.inf, a) * math.copysign(1.0, b)
                    )
                else:
                    stack.append(a / b)
            elif op == 0xA4:
                b, a = stack.pop(), stack.pop()
                stack.append(min(a, b))
            elif op == 0xA5:
                b, a = stack.pop(), stack.pop()
                stack.append(max(a, b))
            elif op == 0xA6:
                b, a = stack.pop(), stack.pop()
                stack.append(math.copysign(a, b))
            # ---- conversions ----------------------------------------------
            elif op == 0xA7:  # i32.wrap_i64
                stack.append(_i32(stack.pop()))
            elif op in (0xA8, 0xAA):  # i32.trunc_f32_s / f64_s
                v = stack.pop()
                if math.isnan(v) or math.isinf(v):
                    raise WasmTrap("invalid conversion to integer")
                t = math.trunc(v)
                if not -(2**31) <= t <= 2**31 - 1:
                    raise WasmTrap("integer overflow")
                stack.append(int(t))
            elif op in (0xA9, 0xAB):  # i32.trunc_f32_u / f64_u
                v = stack.pop()
                if math.isnan(v) or math.isinf(v):
                    raise WasmTrap("invalid conversion to integer")
                t = math.trunc(v)
                if not 0 <= t <= 2**32 - 1:
                    raise WasmTrap("integer overflow")
                stack.append(_i32(int(t)))
            elif op == 0xAC:  # i64.extend_i32_s
                stack.append(_i32(stack.pop()))
            elif op == 0xAD:  # i64.extend_i32_u
                stack.append(_u32(stack.pop()))
            elif op in (0xAE, 0xB0):  # i64.trunc_f32_s / f64_s
                v = stack.pop()
                if math.isnan(v) or math.isinf(v):
                    raise WasmTrap("invalid conversion to integer")
                t = math.trunc(v)
                if not -(2**63) <= t <= 2**63 - 1:
                    raise WasmTrap("integer overflow")
                stack.append(int(t))
            elif op in (0xAF, 0xB1):  # i64.trunc_f32_u / f64_u
                v = stack.pop()
                if math.isnan(v) or math.isinf(v):
                    raise WasmTrap("invalid conversion to integer")
                t = math.trunc(v)
                if not 0 <= t <= 2**64 - 1:
                    raise WasmTrap("integer overflow")
                stack.append(_i64(int(t)))
            elif op in (0xB2, 0xB3):  # f32.convert_i32_s/u
                v = stack.pop()
                stack.append(_f32(float(v if op == 0xB2 else _u32(v))))
            elif op in (0xB4, 0xB5):  # f32.convert_i64_s/u
                v = stack.pop()
                stack.append(_f32(float(v if op == 0xB4 else _u64(v))))
            elif op == 0xB6:  # f32.demote_f64
                stack.append(_f32(stack.pop()))
            elif op in (0xB7, 0xB8):  # f64.convert_i32_s/u
                v = stack.pop()
                stack.append(float(v if op == 0xB7 else _u32(v)))
            elif op in (0xB9, 0xBA):  # f64.convert_i64_s/u
                v = stack.pop()
                stack.append(float(v if op == 0xB9 else _u64(v)))
            elif op == 0xBB:  # f64.promote_f32
                stack.append(float(stack.pop()))
            elif op == 0xBC:  # i32.reinterpret_f32
                stack.append(_i32(struct.unpack("<I", struct.pack("<f", stack.pop()))[0]))
            elif op == 0xBD:  # i64.reinterpret_f64
                stack.append(_i64(struct.unpack("<Q", struct.pack("<d", stack.pop()))[0]))
            elif op == 0xBE:  # f32.reinterpret_i32
                stack.append(struct.unpack("<f", struct.pack("<I", _u32(stack.pop())))[0])
            elif op == 0xBF:  # f64.reinterpret_i64
                stack.append(struct.unpack("<d", struct.pack("<Q", _u64(stack.pop())))[0])
            # ---- sign extension -------------------------------------------
            elif op == 0xC0:  # i32.extend8_s
                v = stack.pop() & 0xFF
                stack.append(v - 256 if v & 0x80 else v)
            elif op == 0xC1:  # i32.extend16_s
                v = stack.pop() & 0xFFFF
                stack.append(v - 65536 if v & 0x8000 else v)
            elif op == 0xC2:  # i64.extend8_s
                v = stack.pop() & 0xFF
                stack.append(v - 256 if v & 0x80 else v)
            elif op == 0xC3:
                v = stack.pop() & 0xFFFF
                stack.append(v - 65536 if v & 0x8000 else v)
            elif op == 0xC4:  # i64.extend32_s
                stack.append(_i32(stack.pop()))
            # ---- 0xFC extensions ------------------------------------------
            elif op >= 0xFC00:
                sub = op & 0xFF
                if sub in (0, 1, 2, 3, 4, 5, 6, 7):  # saturating trunc
                    v = stack.pop()
                    signed = sub % 2 == 0
                    to64 = sub >= 4
                    if math.isnan(v):
                        stack.append(0)
                    else:
                        t = math.trunc(v) if not math.isinf(v) else (
                            math.inf if v > 0 else -math.inf
                        )
                        bits = 64 if to64 else 32
                        if signed:
                            lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
                        else:
                            lo, hi = 0, 2**bits - 1
                        t = max(lo, min(hi, t))
                        stack.append(
                            (_i64 if to64 else _i32)(int(t) & ((1 << bits) - 1))
                        )
                elif sub == 8:  # memory.init
                    n = _u32(stack.pop())
                    src = _u32(stack.pop())
                    dst = _u32(stack.pop())
                    seg = module.data[imm]
                    if imm in self.dropped_data:
                        if n:
                            raise WasmTrap("data segment dropped")
                    payload = seg.data[src : src + n]
                    if len(payload) != n:
                        raise WasmTrap("out of bounds memory.init")
                    mem.write(dst, payload)
                elif sub == 9:  # data.drop
                    self.dropped_data.add(imm)
                elif sub == 10:  # memory.copy
                    n = _u32(stack.pop())
                    src = _u32(stack.pop())
                    dst = _u32(stack.pop())
                    chunk = mem.read(src, n)
                    mem.write(dst, chunk)
                elif sub == 11:  # memory.fill
                    n = _u32(stack.pop())
                    val = stack.pop() & 0xFF
                    dst = _u32(stack.pop())
                    # bounds-trap BEFORE building the fill buffer: n can be
                    # ~4 GiB and hostile wasm must not force that allocation
                    if dst + n > len(mem.data):
                        raise WasmTrap("out of bounds memory access")
                    mem.data[dst : dst + n] = bytes([val]) * n
                else:
                    raise WasmTrap(f"unsupported extended op {sub}")
            else:
                raise WasmTrap(f"unsupported opcode 0x{op:02x}")
            pc += 1

    @staticmethod
    def _branch(label: int, ctrl: list, stack: list) -> int | None:
        """Apply a br to the ``label``-th enclosing block; returns the new
        pc, or None when the branch targets the implicit function-body
        label (= return)."""
        if label >= len(ctrl):
            return None
        for _ in range(label):
            ctrl.pop()
        target_pc, height, arity, is_loop = ctrl[-1]
        results = stack[len(stack) - arity :] if arity else []
        del stack[height:]
        stack.extend(results)
        if is_loop:
            return target_pc + 1  # continue after the loop header
        ctrl.pop()
        return target_pc + 1  # continue after the matching end
