"""Minimal WAT (WebAssembly text) assembler.

Covers the subset this repo's wasm-oracle policies are written in — flat
(non-folded) instruction syntax, named functions/locals/labels, one
memory, data segments, exports and func imports. The output of
:func:`assemble` feeds wasm/binary.py's decoder, so every authored policy
round-trips through the same binary format a real toolchain would emit.

Grammar (s-expressions):

    (module
      (import "env" "host_fn" (func $host (param i32) (result i32)))
      (memory 1) | (memory (export "memory") 1)
      (data (i32.const 8) "bytes\\00")
      (global $g (mut i32) (i32.const 0))
      (func $name (export "name") (param $x i32) (result i32) (local $t i32)
        local.get $x
        i32.const 1
        i32.add)
      (export "name" (func $name)))

Control flow: ``block $label [result]`` / ``loop $label`` /
``if [result]`` / ``else`` / ``end``; branches take label names or
depths."""

from __future__ import annotations

import struct
from typing import Any

from policy_server_tpu_torch.wasm.binary import F32, F64, I32, I64


class WatError(Exception):
    pass


# -- s-expression parsing ----------------------------------------------------


def _tokenize(src: str) -> list[str]:
    out: list[str] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c in "()":
            out.append(c)
            i += 1
        elif c == '"':
            j = i + 1
            buf = []
            while src[j] != '"':
                if src[j] == "\\":
                    esc = src[j + 1]
                    if esc == "n":
                        buf.append("\n")
                        j += 2
                    elif esc == "t":
                        buf.append("\t")
                        j += 2
                    elif esc in ('"', "\\"):
                        buf.append(esc)
                        j += 2
                    else:  # \xx hex byte
                        buf.append(chr(int(src[j + 1 : j + 3], 16)))
                        j += 3
                else:
                    buf.append(src[j])
                    j += 1
            out.append('"' + "".join(buf))
            i = j + 1
        elif c == ";" and i + 1 < n and src[i + 1] == ";":
            while i < n and src[i] != "\n":
                i += 1
        elif c == "(" or c.isspace():
            i += 1
        else:
            j = i
            while j < n and not src[j].isspace() and src[j] not in '()"':
                j += 1
            out.append(src[i:j])
            i = j
    return out


def _parse(tokens: list[str]):
    pos = 0

    def node():
        nonlocal pos
        tok = tokens[pos]
        if tok == "(":
            pos += 1
            items = []
            while tokens[pos] != ")":
                items.append(node())
            pos += 1
            return items
        pos += 1
        return tok

    result = node()
    if pos != len(tokens):
        raise WatError("trailing tokens")
    return result


# -- encoding helpers --------------------------------------------------------


def _uleb(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _sleb(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if (v == 0 and not b & 0x40) or (v == -1 and b & 0x40):
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _vec(items: list[bytes]) -> bytes:
    return _uleb(len(items)) + b"".join(items)


def _name(s: str) -> bytes:
    raw = s.encode()
    return _uleb(len(raw)) + raw


_VALTYPES = {"i32": I32, "i64": I64, "f32": F32, "f64": F64}

# opcode table for plain (no-immediate) instructions
_SIMPLE = {
    "unreachable": 0x00, "nop": 0x01, "return": 0x0F, "drop": 0x1A,
    "select": 0x1B, "memory.size": None, "memory.grow": None,
    "i32.eqz": 0x45, "i32.eq": 0x46, "i32.ne": 0x47, "i32.lt_s": 0x48,
    "i32.lt_u": 0x49, "i32.gt_s": 0x4A, "i32.gt_u": 0x4B, "i32.le_s": 0x4C,
    "i32.le_u": 0x4D, "i32.ge_s": 0x4E, "i32.ge_u": 0x4F,
    "i64.eqz": 0x50, "i64.eq": 0x51, "i64.ne": 0x52, "i64.lt_s": 0x53,
    "i64.lt_u": 0x54, "i64.gt_s": 0x55, "i64.gt_u": 0x56, "i64.le_s": 0x57,
    "i64.le_u": 0x58, "i64.ge_s": 0x59, "i64.ge_u": 0x5A,
    "f64.eq": 0x61, "f64.ne": 0x62, "f64.lt": 0x63, "f64.gt": 0x64,
    "f64.le": 0x65, "f64.ge": 0x66,
    "i32.clz": 0x67, "i32.ctz": 0x68, "i32.popcnt": 0x69,
    "i32.add": 0x6A, "i32.sub": 0x6B, "i32.mul": 0x6C, "i32.div_s": 0x6D,
    "i32.div_u": 0x6E, "i32.rem_s": 0x6F, "i32.rem_u": 0x70,
    "i32.and": 0x71, "i32.or": 0x72, "i32.xor": 0x73, "i32.shl": 0x74,
    "i32.shr_s": 0x75, "i32.shr_u": 0x76, "i32.rotl": 0x77, "i32.rotr": 0x78,
    "i64.add": 0x7C, "i64.sub": 0x7D, "i64.mul": 0x7E, "i64.div_s": 0x7F,
    "i64.div_u": 0x80, "i64.rem_s": 0x81, "i64.rem_u": 0x82,
    "i64.and": 0x83, "i64.or": 0x84, "i64.xor": 0x85, "i64.shl": 0x86,
    "i64.shr_s": 0x87, "i64.shr_u": 0x88,
    "f64.add": 0xA0, "f64.sub": 0xA1, "f64.mul": 0xA2, "f64.div": 0xA3,
    "i32.wrap_i64": 0xA7, "i64.extend_i32_s": 0xAC, "i64.extend_i32_u": 0xAD,
    "f64.convert_i32_s": 0xB7, "i32.trunc_f64_s": 0xAA,
}

_MEM_OPCODES = {
    "i32.load": 0x28, "i64.load": 0x29, "f32.load": 0x2A, "f64.load": 0x2B,
    "i32.load8_s": 0x2C, "i32.load8_u": 0x2D, "i32.load16_s": 0x2E,
    "i32.load16_u": 0x2F, "i64.load8_u": 0x31, "i64.load32_u": 0x35,
    "i32.store": 0x36, "i64.store": 0x37, "f32.store": 0x38,
    "f64.store": 0x39, "i32.store8": 0x3A, "i32.store16": 0x3B,
}


class _FuncAsm:
    def __init__(self, asm: "_ModuleAsm", params, results, locals_, names):
        self.asm = asm
        self.params = params
        self.results = results
        self.locals = locals_
        self.local_names = names  # name → index (params first)
        self.body = bytearray()
        self.labels: list[str | None] = []

    def _local_index(self, tok: str) -> int:
        if tok.startswith("$"):
            if tok not in self.local_names:
                raise WatError(f"unknown local {tok}")
            return self.local_names[tok]
        return int(tok)

    def _label_depth(self, tok: str) -> int:
        if tok.startswith("$"):
            for depth, name in enumerate(reversed(self.labels)):
                if name == tok:
                    return depth
            raise WatError(f"unknown label {tok}")
        return int(tok)

    def emit(self, instrs: list, i: int = 0) -> None:
        body = self.body
        n = len(instrs)
        while i < n:
            tok = instrs[i]
            if not isinstance(tok, str):
                raise WatError(f"folded expressions unsupported: {tok}")
            i += 1
            if tok in ("block", "loop", "if"):
                label = None
                if i < n and isinstance(instrs[i], str) and instrs[i].startswith("$"):
                    label = instrs[i]
                    i += 1
                bt = 0x40
                if (
                    i < n
                    and isinstance(instrs[i], list)
                    and instrs[i]
                    and instrs[i][0] == "result"
                ):
                    bt = _VALTYPES[instrs[i][1]]
                    i += 1
                body.append({"block": 0x02, "loop": 0x03, "if": 0x04}[tok])
                body.append(bt)
                self.labels.append(label)
            elif tok == "else":
                body.append(0x05)
            elif tok == "end":
                body.append(0x0B)
                if self.labels:
                    self.labels.pop()
            elif tok in ("br", "br_if"):
                body.append(0x0C if tok == "br" else 0x0D)
                body += _uleb(self._label_depth(instrs[i]))
                i += 1
            elif tok == "br_table":
                targets = []
                while i < n and isinstance(instrs[i], str) and (
                    instrs[i].startswith("$") or instrs[i].isdigit()
                ):
                    targets.append(self._label_depth(instrs[i]))
                    i += 1
                body.append(0x0E)
                body += _uleb(len(targets) - 1)
                for t in targets[:-1]:
                    body += _uleb(t)
                body += _uleb(targets[-1])
            elif tok == "call":
                body.append(0x10)
                body += _uleb(self.asm.func_index(instrs[i]))
                i += 1
            elif tok in ("local.get", "local.set", "local.tee"):
                body.append({"local.get": 0x20, "local.set": 0x21, "local.tee": 0x22}[tok])
                body += _uleb(self._local_index(instrs[i]))
                i += 1
            elif tok in ("global.get", "global.set"):
                body.append(0x23 if tok == "global.get" else 0x24)
                body += _uleb(self.asm.global_index(instrs[i]))
                i += 1
            elif tok == "i32.const":
                body.append(0x41)
                body += _sleb(int(instrs[i], 0))
                i += 1
            elif tok == "i64.const":
                body.append(0x42)
                body += _sleb(int(instrs[i], 0))
                i += 1
            elif tok == "f64.const":
                body.append(0x44)
                body += struct.pack("<d", float(instrs[i]))
                i += 1
            elif tok in _MEM_OPCODES:
                offset = 0
                if i < n and isinstance(instrs[i], str) and instrs[i].startswith("offset="):
                    offset = int(instrs[i].split("=", 1)[1], 0)
                    i += 1
                body.append(_MEM_OPCODES[tok])
                body += _uleb(0)  # align
                body += _uleb(offset)
            elif tok == "memory.size":
                body += b"\x3f\x00"
            elif tok == "memory.grow":
                body += b"\x40\x00"
            elif tok == "memory.copy":
                body += b"\xfc\x0a\x00\x00"
            elif tok == "memory.fill":
                body += b"\xfc\x0b\x00"
            elif tok in _SIMPLE and _SIMPLE[tok] is not None:
                body.append(_SIMPLE[tok])
            else:
                raise WatError(f"unsupported instruction {tok!r}")


class _ModuleAsm:
    def __init__(self):
        self.types: list[tuple[tuple, tuple]] = []
        self.imports: list[bytes] = []
        self.func_names: dict[str, int] = {}
        self.func_typeidx: list[int] = []  # local funcs
        self.n_imported = 0
        self.global_names: dict[str, int] = {}
        self.globals: list[bytes] = []
        self.exports: list[bytes] = []
        self.memory: tuple[int, int | None] | None = None
        self.datas: list[bytes] = []
        self.bodies: list[bytes] = []

    def typeidx(self, params: tuple, results: tuple) -> int:
        key = (params, results)
        if key not in self.types:
            self.types.append(key)
        return self.types.index(key)

    def func_index(self, tok: str) -> int:
        if tok.startswith("$"):
            if tok not in self.func_names:
                raise WatError(f"unknown function {tok}")
            return self.func_names[tok]
        return int(tok)

    def global_index(self, tok: str) -> int:
        if tok.startswith("$"):
            return self.global_names[tok]
        return int(tok)


def _sig_of(items: list) -> tuple[tuple, tuple, dict]:
    """Parse (param ...) / (result ...) clauses → (params, results, names)."""
    params: list[int] = []
    results: list[int] = []
    names: dict[str, int] = {}
    for clause in items:
        if isinstance(clause, list) and clause and clause[0] == "param":
            rest = clause[1:]
            if rest and rest[0].startswith("$"):
                names[rest[0]] = len(params)
                params.append(_VALTYPES[rest[1]])
            else:
                params.extend(_VALTYPES[t] for t in rest)
        elif isinstance(clause, list) and clause and clause[0] == "result":
            results.extend(_VALTYPES[t] for t in clause[1:])
    return tuple(params), tuple(results), names


def assemble(source: str) -> bytes:
    """WAT text → wasm binary."""
    tree = _parse(_tokenize(source))
    if not tree or tree[0] != "module":
        raise WatError("expected (module ...)")
    asm = _ModuleAsm()

    funcs: list[tuple[list, Any]] = []  # deferred bodies

    # pass 1: declare everything so call/$name resolves forward refs
    for form in tree[1:]:
        head = form[0]
        if head == "import":
            module, name = form[1][1:], form[2][1:]
            desc = form[3]
            if desc[0] != "func":
                raise WatError("only func imports supported in WAT subset")
            fname = None
            rest = desc[1:]
            if rest and isinstance(rest[0], str) and rest[0].startswith("$"):
                fname = rest[0]
                rest = rest[1:]
            params, results, _ = _sig_of(rest)
            ti = asm.typeidx(params, results)
            asm.imports.append(_name(module) + _name(name) + b"\x00" + _uleb(ti))
            if fname:
                asm.func_names[fname] = asm.n_imported
            asm.n_imported += 1
        elif head == "func":
            rest = form[1:]
            fname = None
            if rest and isinstance(rest[0], str) and rest[0].startswith("$"):
                fname = rest[0]
                rest = rest[1:]
            index = asm.n_imported + len(asm.func_typeidx)
            if fname:
                asm.func_names[fname] = index
            export_clauses = [
                c for c in rest if isinstance(c, list) and c and c[0] == "export"
            ]
            for e in export_clauses:
                asm.exports.append(_name(e[1][1:]) + b"\x00" + _uleb(index))
            sig_rest = [
                c for c in rest
                if isinstance(c, list) and c and c[0] in ("param", "result")
            ]
            params, results, names = _sig_of(sig_rest)
            asm.func_typeidx.append(asm.typeidx(params, results))
            funcs.append((rest, (params, results, names, index)))
        elif head == "memory":
            rest = form[1:]
            export = None
            if rest and isinstance(rest[0], list) and rest[0][0] == "export":
                export = rest[0][1][1:]
                rest = rest[1:]
            minimum = int(rest[0])
            maximum = int(rest[1]) if len(rest) > 1 else None
            asm.memory = (minimum, maximum)
            if export:
                asm.exports.append(_name(export) + b"\x02" + _uleb(0))
        elif head == "data":
            offset_expr = form[1]
            payload = form[2][1:].encode("latin-1")
            seg = (
                b"\x00"
                + b"\x41"
                + _sleb(int(offset_expr[1], 0))
                + b"\x0b"
                + _uleb(len(payload))
                + payload
            )
            asm.datas.append(seg)
        elif head == "global":
            rest = form[1:]
            gname = None
            if rest and isinstance(rest[0], str) and rest[0].startswith("$"):
                gname = rest[0]
                rest = rest[1:]
            gtype = rest[0]
            mutable = isinstance(gtype, list) and gtype[0] == "mut"
            vt = _VALTYPES[gtype[1] if mutable else gtype]
            init = rest[1]
            expr = b"\x41" + _sleb(int(init[1], 0)) + b"\x0b"
            if gname:
                asm.global_names[gname] = len(asm.globals)
            asm.globals.append(
                bytes([vt, 1 if mutable else 0]) + expr
            )
        elif head == "export":
            kind = form[2][0]
            target = form[2][1]
            kinds = {"func": 0, "table": 1, "memory": 2, "global": 3}
            if kind == "func":
                idx = asm.func_index(target)
            elif kind == "global":
                idx = asm.global_index(target)
            else:
                idx = int(str(target).lstrip("$") or 0)
            asm.exports.append(_name(form[1][1:]) + bytes([kinds[kind]]) + _uleb(idx))
        else:
            raise WatError(f"unsupported module form {head!r}")

    # pass 2: assemble bodies
    for rest, (params, results, names, _index) in funcs:
        locals_: list[int] = []
        for clause in rest:
            if isinstance(clause, list) and clause and clause[0] == "local":
                lrest = clause[1:]
                if lrest and lrest[0].startswith("$"):
                    names[lrest[0]] = len(params) + len(locals_)
                    locals_.append(_VALTYPES[lrest[1]])
                else:
                    locals_.extend(_VALTYPES[t] for t in lrest)
        instrs = [
            c for c in rest
            if not (
                isinstance(c, list)
                and c
                and c[0] in ("param", "result", "local", "export")
            )
        ]
        fb = _FuncAsm(asm, params, results, locals_, names)
        fb.emit(instrs)
        fb.body.append(0x0B)  # end
        # locals vector: run-length encode
        runs: list[tuple[int, int]] = []
        for vt in locals_:
            if runs and runs[-1][1] == vt:
                runs[-1] = (runs[-1][0] + 1, vt)
            else:
                runs.append((1, vt))
        locals_enc = _uleb(len(runs)) + b"".join(
            _uleb(c) + bytes([vt]) for c, vt in runs
        )
        body = locals_enc + bytes(fb.body)
        asm.bodies.append(_uleb(len(body)) + body)

    # emit sections
    def section(sid: int, payload: bytes) -> bytes:
        return bytes([sid]) + _uleb(len(payload)) + payload

    out = bytearray(b"\x00asm\x01\x00\x00\x00")
    type_entries = [
        b"\x60"
        + _uleb(len(p))
        + bytes(p)
        + _uleb(len(r))
        + bytes(r)
        for p, r in asm.types
    ]
    out += section(1, _vec(type_entries))
    if asm.imports:
        out += section(2, _vec(asm.imports))
    if asm.func_typeidx:
        out += section(3, _vec([_uleb(t) for t in asm.func_typeidx]))
    if asm.memory is not None:
        mn, mx = asm.memory
        lim = (b"\x01" + _uleb(mn) + _uleb(mx)) if mx is not None else (b"\x00" + _uleb(mn))
        out += section(5, _vec([lim]))
    if asm.globals:
        out += section(6, _vec(asm.globals))
    if asm.exports:
        out += section(7, _vec(asm.exports))
    if asm.bodies:
        out += section(10, _vec(asm.bodies))
    if asm.datas:
        out += section(11, _vec(asm.datas))
    return bytes(out)
