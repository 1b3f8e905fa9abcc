"""WebAssembly binary decoder (MVP + sign-extension + saturating
truncation + bulk memory — the feature set clang/LLVM and the OPA wasm
compiler emit for policy modules).

Decodes a ``.wasm`` byte string into a :class:`WasmModule` with function
bodies as flat instruction lists whose structured control flow
(block/loop/if) is pre-resolved to jump targets, so the interpreter
(wasm/interp.py) executes with simple program-counter jumps."""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any

MAGIC = b"\x00asm\x01\x00\x00\x00"

# value types
I32, I64, F32, F64 = 0x7F, 0x7E, 0x7D, 0x7C
FUNCREF = 0x70
VALTYPES = {I32: "i32", I64: "i64", F32: "f32", F64: "f64"}


class WasmDecodeError(Exception):
    pass


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def bytes(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        if len(out) != n:
            raise WasmDecodeError("unexpected end of section")
        self.pos += n
        return out

    def u32(self) -> int:
        result = shift = 0
        while True:
            b = self.byte()
            result |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return result

    def s_leb(self, bits: int) -> int:
        result = shift = 0
        while True:
            b = self.byte()
            result |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                if shift < bits and b & 0x40:
                    result |= -(1 << shift)
                return result

    def s32(self) -> int:
        return self.s_leb(32)

    def s64(self) -> int:
        return self.s_leb(64)

    def f32(self) -> float:
        return struct.unpack("<f", self.bytes(4))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self.bytes(8))[0]

    def name(self) -> str:
        return self.bytes(self.u32()).decode("utf-8")

    def done(self) -> bool:
        return self.pos >= len(self.data)


@dataclass(frozen=True)
class FuncType:
    params: tuple[int, ...]
    results: tuple[int, ...]


@dataclass
class Limits:
    minimum: int
    maximum: int | None


@dataclass
class Import:
    module: str
    name: str
    kind: str  # func | table | memory | global
    desc: Any  # typeidx | Limits | (valtype, mutable)


@dataclass
class Export:
    name: str
    kind: str
    index: int


@dataclass
class GlobalDef:
    valtype: int
    mutable: bool
    init: list  # const expr instruction list


@dataclass
class ElemSegment:
    table: int
    offset: list  # const expr
    func_indices: list[int]


@dataclass
class DataSegment:
    memory: int
    offset: list | None  # const expr; None = passive
    data: bytes


@dataclass
class FuncBody:
    typeidx: int
    locals: list[int]  # flattened local valtypes (excluding params)
    code: list  # flat [(op, imm), ...] with targets resolved


@dataclass
class WasmModule:
    types: list[FuncType] = field(default_factory=list)
    imports: list[Import] = field(default_factory=list)
    functions: list[int] = field(default_factory=list)  # typeidx per local fn
    tables: list[Limits] = field(default_factory=list)
    memories: list[Limits] = field(default_factory=list)
    globals: list[GlobalDef] = field(default_factory=list)
    exports: list[Export] = field(default_factory=list)
    start: int | None = None
    elems: list[ElemSegment] = field(default_factory=list)
    code: list[FuncBody] = field(default_factory=list)
    data: list[DataSegment] = field(default_factory=list)

    def export_map(self) -> dict[str, Export]:
        return {e.name: e for e in self.exports}

    @property
    def num_imported_funcs(self) -> int:
        return sum(1 for i in self.imports if i.kind == "func")


# ---------------------------------------------------------------------------
# Instruction decoding
# ---------------------------------------------------------------------------

# opcodes with no immediate are decoded as (op, None). The interpreter
# dispatches on the integer opcode; 0xFC-prefixed ops are encoded as
# 0xFC00 | sub.

_BLOCK_OPS = {0x02, 0x03, 0x04}  # block, loop, if
END, ELSE = 0x0B, 0x05

_MEM_OPS = set(range(0x28, 0x3F))  # loads/stores (memarg immediates)


def _decode_blocktype(r: _Reader) -> Any:
    b = r.data[r.pos]
    if b == 0x40:
        r.pos += 1
        return None  # empty
    if b in VALTYPES:
        r.pos += 1
        return b  # single result valtype
    return r.s32()  # type index (multi-value)


def _decode_instr(op: int, r: _Reader):
    if op in _BLOCK_OPS:
        return (op, _decode_blocktype(r))
    if op in (END, ELSE, 0x00, 0x01, 0x0F, 0x1A, 0x1B):  # end/else/unreachable/nop/return/drop/select
        return (op, None)
    if op in (0x0C, 0x0D):  # br, br_if
        return (op, r.u32())
    if op == 0x0E:  # br_table
        n = r.u32()
        targets = [r.u32() for _ in range(n)]
        default = r.u32()
        return (op, (targets, default))
    if op == 0x10:  # call
        return (op, r.u32())
    if op == 0x11:  # call_indirect
        typeidx = r.u32()
        table = r.u32()
        return (op, (typeidx, table))
    if op in (0x20, 0x21, 0x22, 0x23, 0x24):  # local/global get/set/tee
        return (op, r.u32())
    if op in _MEM_OPS:  # memarg: align, offset
        r.u32()
        return (op, r.u32())  # keep offset only
    if op in (0x3F, 0x40):  # memory.size / memory.grow
        r.byte()
        return (op, None)
    if op == 0x41:
        return (op, r.s32())
    if op == 0x42:
        return (op, r.s64())
    if op == 0x43:
        return (op, r.f32())
    if op == 0x44:
        return (op, r.f64())
    if 0x45 <= op <= 0xC4:  # numeric ops + sign extension, no immediates
        return (op, None)
    if op == 0xFC:
        sub = r.u32()
        code = 0xFC00 | sub
        if sub in (0, 1, 2, 3, 4, 5, 6, 7):  # saturating truncations
            return (code, None)
        if sub == 8:  # memory.init
            seg = r.u32()
            r.byte()
            return (code, seg)
        if sub == 9:  # data.drop
            return (code, r.u32())
        if sub == 10:  # memory.copy
            r.byte()
            r.byte()
            return (code, None)
        if sub == 11:  # memory.fill
            r.byte()
            return (code, None)
        if sub == 12:  # table.init
            seg = r.u32()
            table = r.u32()
            return (code, (seg, table))
        if sub == 13:  # elem.drop
            return (code, r.u32())
        if sub == 14:  # table.copy
            return (code, (r.u32(), r.u32()))
        if sub in (15, 16, 17):  # table.grow/size/fill
            return (code, r.u32())
        raise WasmDecodeError(f"unsupported 0xFC opcode {sub}")
    raise WasmDecodeError(f"unsupported opcode 0x{op:02x}")


def decode_body(r: _Reader) -> list:
    """Decode one function body to a flat instruction list with control
    targets resolved:

    * ``block``/``if`` imm → (blocktype, end_index, else_index|None)
    * ``loop`` imm → (blocktype, end_index)
    * ``end``/``else`` stay as markers (interpreter skips them; ``else``
      jumps to its block's end when reached from the then-branch)
    """
    code: list = []
    stack: list[tuple[int, int]] = []  # (opcode, index)
    while True:
        op = r.byte()
        if op == END:
            if not stack:
                code.append((END, None))
                return code
            code.append((END, None))
            start_op, idx = stack.pop()
            kind, imm = code[idx]
            end_index = len(code) - 1
            if start_op == 0x04:  # if: (bt, end, else)
                bt, _, else_idx = imm
                code[idx] = (kind, (bt, end_index, else_idx))
                if else_idx is not None:
                    code[else_idx] = (ELSE, end_index)
            elif start_op == 0x02:  # block
                bt, _ = imm
                code[idx] = (kind, (bt, end_index))
            else:  # loop
                bt, _ = imm
                code[idx] = (kind, (bt, end_index))
            continue
        if op == ELSE:
            # find the innermost if and record the else position
            start_op, idx = stack[-1]
            if start_op != 0x04:
                raise WasmDecodeError("else outside if")
            kind, (bt, e, _none) = code[idx]
            code.append((ELSE, None))  # target patched at END
            code[idx] = (kind, (bt, e, len(code) - 1))
            continue
        instr = _decode_instr(op, r)
        if op in _BLOCK_OPS:
            bt = instr[1]
            if op == 0x04:
                code.append((op, (bt, -1, None)))
            else:
                code.append((op, (bt, -1)))
            stack.append((op, len(code) - 1))
        else:
            code.append(instr)


def decode_const_expr(r: _Reader) -> list:
    """Constant expressions (globals / offsets): a short instruction run
    terminated by END."""
    out = []
    while True:
        op = r.byte()
        if op == END:
            return out
        out.append(_decode_instr(op, r))


# ---------------------------------------------------------------------------
# Module decoding
# ---------------------------------------------------------------------------


def decode_module(data: bytes) -> WasmModule:
    if data[:8] != MAGIC:
        raise WasmDecodeError("not a wasm v1 module")
    m = WasmModule()
    r = _Reader(data, 8)
    while r.pos < len(data):
        sid = r.byte()
        size = r.u32()
        section = _Reader(r.bytes(size))
        if sid == 1:  # types
            for _ in range(section.u32()):
                if section.byte() != 0x60:
                    raise WasmDecodeError("expected functype")
                params = tuple(section.byte() for _ in range(section.u32()))
                results = tuple(section.byte() for _ in range(section.u32()))
                m.types.append(FuncType(params, results))
        elif sid == 2:  # imports
            for _ in range(section.u32()):
                module = section.name()
                name = section.name()
                kind = section.byte()
                if kind == 0:
                    m.imports.append(Import(module, name, "func", section.u32()))
                elif kind == 1:
                    section.byte()  # reftype
                    m.imports.append(
                        Import(module, name, "table", _limits(section))
                    )
                elif kind == 2:
                    m.imports.append(
                        Import(module, name, "memory", _limits(section))
                    )
                elif kind == 3:
                    vt = section.byte()
                    mut = section.byte()
                    m.imports.append(
                        Import(module, name, "global", (vt, bool(mut)))
                    )
                else:
                    raise WasmDecodeError(f"bad import kind {kind}")
        elif sid == 3:  # functions
            m.functions = [section.u32() for _ in range(section.u32())]
        elif sid == 4:  # tables
            for _ in range(section.u32()):
                section.byte()  # reftype
                m.tables.append(_limits(section))
        elif sid == 5:  # memories
            for _ in range(section.u32()):
                m.memories.append(_limits(section))
        elif sid == 6:  # globals
            for _ in range(section.u32()):
                vt = section.byte()
                mut = section.byte()
                m.globals.append(
                    GlobalDef(vt, bool(mut), decode_const_expr(section))
                )
        elif sid == 7:  # exports
            kinds = {0: "func", 1: "table", 2: "memory", 3: "global"}
            for _ in range(section.u32()):
                name = section.name()
                kind = kinds[section.byte()]
                m.exports.append(Export(name, kind, section.u32()))
        elif sid == 8:  # start
            m.start = section.u32()
        elif sid == 9:  # elements
            for _ in range(section.u32()):
                flags = section.u32()
                if flags == 0:
                    offset = decode_const_expr(section)
                    funcs = [section.u32() for _ in range(section.u32())]
                    m.elems.append(ElemSegment(0, offset, funcs))
                elif flags == 2:
                    table = section.u32()
                    offset = decode_const_expr(section)
                    if section.byte() != 0:
                        raise WasmDecodeError("unsupported elemkind")
                    funcs = [section.u32() for _ in range(section.u32())]
                    m.elems.append(ElemSegment(table, offset, funcs))
                else:
                    raise WasmDecodeError(
                        f"unsupported element segment flags {flags}"
                    )
        elif sid == 10:  # code
            for _ in range(section.u32()):
                body_size = section.u32()
                body = _Reader(section.bytes(body_size))
                locals_out: list[int] = []
                for _ in range(body.u32()):
                    n = body.u32()
                    vt = body.byte()
                    locals_out.extend([vt] * n)
                code = decode_body(body)
                m.code.append(FuncBody(0, locals_out, code))
        elif sid == 11:  # data
            for _ in range(section.u32()):
                flags = section.u32()
                if flags == 0:
                    offset = decode_const_expr(section)
                    m.data.append(
                        DataSegment(0, offset, section.bytes(section.u32()))
                    )
                elif flags == 1:  # passive
                    m.data.append(
                        DataSegment(0, None, section.bytes(section.u32()))
                    )
                elif flags == 2:
                    mem = section.u32()
                    offset = decode_const_expr(section)
                    m.data.append(
                        DataSegment(mem, offset, section.bytes(section.u32()))
                    )
                else:
                    raise WasmDecodeError(f"bad data segment flags {flags}")
        # sid 0 (custom) and 12 (datacount) carry nothing we execute
    # bind typeidx into FuncBody for convenience
    for i, body in enumerate(m.code):
        body.typeidx = m.functions[i]
    return m


def ensure_module(wasm: "bytes | WasmModule") -> WasmModule:
    """bytes→decode, WasmModule→passthrough: the one definition of the
    polymorphism every ABI host accepts."""
    return wasm if isinstance(wasm, WasmModule) else decode_module(wasm)


def _limits(r: _Reader) -> Limits:
    flags = r.byte()
    minimum = r.u32()
    maximum = r.u32() if flags & 1 else None
    return Limits(minimum, maximum)
