"""ctypes bridge to the native wasm execution core
(``policy_server_tpu_torch/csrc/wasmint.cpp``).

The Python interpreter (wasm/interp.py) is the semantic reference; this
bridge translates a decoded module's flat instruction lists into the
op/immediate arrays the C++ dispatch loop executes, and exposes a
NativeInstance with the SAME surface as interp.Instance (invoke, memory
read/write, global_value, ambient deadline, fuel) so the waPC/OPA/WASI
hosts run unchanged on either engine.

``make_instance`` is the one construction point. It picks the engine:

* the native core, built at first use with g++ into
  ``build/torch_kernels/torch_wasmint-<abi>.so`` beside the package and
  reused while it is newer than the source. A failed build, load or bind
  RAISES with g++'s or the loader's text: there is no silent fallback to
  the interpreter;
* the interpreter, when the caller asks for it with
  ``PSTPU_NO_NATIVE_WASM=1``, or for a module that uses a construct the
  native core does not model (imported tables or globals, several
  memories: ``NativeUnsupported``), which is not a failure.

``engine_counts()`` says how many instances each engine made.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import struct
import subprocess
import threading
import time
from pathlib import Path

from policy_server_tpu_torch.ops import buildcache
from policy_server_tpu_torch.wasm import interp as _interp
from policy_server_tpu_torch.wasm.binary import ELSE, END, F32, F64, WasmModule
from policy_server_tpu_torch.wasm.interp import (
    Memory,
    WasmDeadlineExceeded,
    WasmFuelExhausted,
    WasmTrap,
)

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE_DIR / "csrc" / "wasmint.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_BLOCK = 0x02
_LOOP = 0x03
_IF = 0x04

_MEM_OPS = set(range(0x28, 0x3F))  # loads + stores (memarg offset in imm)

# f32/f64 immediates and slot values cross the boundary as raw IEEE-754
# bit patterns in 64-bit slots; one spelling per layout
_SLOT_U64 = struct.Struct("<Q")
_SLOT_I64 = struct.Struct("<q")
_SLOT_F64 = struct.Struct("<d")


class NativeUnsupported(Exception):
    """Module uses a construct the native core does not model."""


# -- library build/load ------------------------------------------------------

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()
# seconds the last g++ run took (0.0 when an up-to-date library was reused)
build_seconds = 0.0

# instances made by each engine (make_instance)
_counts_lock = threading.Lock()
_engine_counts = {"native": 0, "interp": 0}  # guarded-by: _counts_lock

_HOSTCB = ctypes.CFUNCTYPE(
    ctypes.c_int32,
    ctypes.c_void_p,  # ctx (unused; dispatch via thread-local)
    ctypes.c_int32,  # func index
    ctypes.POINTER(ctypes.c_uint64),  # args
    ctypes.c_int32,  # nargs
    ctypes.POINTER(ctypes.c_uint64),  # results out
    ctypes.POINTER(ctypes.c_int32),  # nresults out
)


def native_disabled() -> bool:
    """True when the caller asked for the interpreter
    (``PSTPU_NO_NATIVE_WASM=1``)."""
    return os.environ.get("PSTPU_NO_NATIVE_WASM") == "1"


def engine_counts() -> dict[str, int]:
    """Instances made so far by each engine: ``native`` and ``interp``."""
    with _counts_lock:
        return dict(_engine_counts)


def _count(engine: str) -> None:
    with _counts_lock:
        _engine_counts[engine] += 1


def library_path() -> Path:
    """The library's file in the build directory, named by the hash of
    its inputs (``ops/buildcache.py``)."""
    tag = buildcache.abi_tag()
    key = buildcache.input_key([SOURCE], "g++", GXX_FLAGS, tag)
    return buildcache.build_dir() / f"torch_wasmint-{tag}-{key}.so"


def _compile(out: Path) -> float:
    """g++ the source into ``out`` (atomically, under a file lock other
    processes building the same library wait on) → seconds spent in g++,
    0.0 when the library (named by the hash of its inputs) was already
    built. Raises with g++'s
    output on failure."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".torch_wasmint.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return 0.0
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=300
            )
        except FileNotFoundError as e:
            raise RuntimeError(
                "g++ not found: the native wasm core is compiled from "
                f"{SOURCE} at first use"
            ) from e
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
        return seconds


def build_library(force: bool = False) -> ctypes.CDLL:
    """Compile the native core when its library is missing (always with
    ``force``), then load it and declare its entry
    points. Raises on a failed build, load or bind."""
    global _lib, build_seconds
    if _lib is not None and not force:
        return _lib
    with _lib_lock:
        if _lib is not None and not force:
            return _lib
        path = library_path()
        if force:
            path.unlink(missing_ok=True)
        build_seconds = _compile(path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(
                f"the native wasm core {path} failed to load: {e}"
            ) from e
        try:
            _bind(lib)
        except AttributeError as e:
            raise RuntimeError(
                f"the native wasm core {path} lacks an entry point: {e}"
            ) from e
        _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    lib.wasmint_module_new.restype = ctypes.c_void_p
    lib.wasmint_module_free.argtypes = [ctypes.c_void_p]
    lib.wasmint_add_func.restype = ctypes.c_int32
    lib.wasmint_add_func.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    lib.wasmint_set_brpool.restype = ctypes.c_int32
    lib.wasmint_set_brpool.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    lib.wasmint_add_data.restype = ctypes.c_int32
    lib.wasmint_add_data.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.wasmint_inst_new.restype = ctypes.c_void_p
    lib.wasmint_inst_new.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_double, ctypes.c_int32, _HOSTCB,
        ctypes.c_void_p,
    ]
    lib.wasmint_inst_free.argtypes = [ctypes.c_void_p]
    lib.wasmint_set_globals.restype = ctypes.c_int32
    lib.wasmint_set_globals.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
    ]
    lib.wasmint_get_global.restype = ctypes.c_int64
    lib.wasmint_get_global.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.wasmint_add_table.restype = ctypes.c_int32
    lib.wasmint_add_table.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    lib.wasmint_mem_size.restype = ctypes.c_int64
    lib.wasmint_mem_size.argtypes = [ctypes.c_void_p]
    lib.wasmint_mem_read.restype = ctypes.c_int32
    lib.wasmint_mem_read.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
    ]
    lib.wasmint_mem_write.restype = ctypes.c_int32
    lib.wasmint_mem_write.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.wasmint_mem_find0.restype = ctypes.c_int64
    lib.wasmint_mem_find0.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.wasmint_fuel_left.restype = ctypes.c_int64
    lib.wasmint_fuel_left.argtypes = [ctypes.c_void_p]
    lib.wasmint_set_fuel.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.wasmint_err.restype = ctypes.c_char_p
    lib.wasmint_err.argtypes = [ctypes.c_void_p]
    lib.wasmint_invoke.restype = ctypes.c_int32
    lib.wasmint_invoke.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int32),
    ]


def available() -> bool:
    """True when the native core serves (it is not disabled); builds and
    loads it on first use, raising when that fails."""
    if native_disabled():
        return False
    build_library()
    return True


# -- module translation ------------------------------------------------------


class _CompiledModule:
    """Shared, immutable native module handle + metadata for instances."""

    def __init__(self, module: WasmModule):
        lib = build_library()
        self.module = module
        self.lib = lib

        if any(imp.kind in ("table", "global") for imp in module.imports):
            raise NativeUnsupported("imported table/global")
        n_mem = len(module.memories) + sum(
            1 for i in module.imports if i.kind == "memory"
        )
        if n_mem > 1:
            raise NativeUnsupported("multiple memories")

        # function table: imports first (host), then local functions —
        # the same index space as interp.Instance.funcs
        self.host_types = []  # functype per import (None for local)
        types = module.types
        type_ids: dict = {}

        def type_id(ft) -> int:
            # fixed 32-slot marshalling buffers in the C++ core
            if len(ft.params) > 32 or len(ft.results) > 32:
                raise NativeUnsupported("functype with >32 params/results")
            key = (tuple(ft.params), tuple(ft.results))
            return type_ids.setdefault(key, len(type_ids))

        self.functypes = []
        self.handle = lib.wasmint_module_new()
        if not self.handle:
            raise MemoryError("out of memory creating native module")

        def checked(status: int) -> None:
            # nonzero = allocation failure inside the native core (it must
            # not let bad_alloc unwind through ctypes)
            if status:
                raise MemoryError("out of memory building native module")

        try:
            br_pool: list[int] = []
            translated = []
            for imp in module.imports:
                if imp.kind != "func":
                    continue
                ft = types[imp.desc]
                self.functypes.append(ft)
                translated.append((type_id(ft), len(ft.params),
                                   len(ft.results), 0, 1, None))
            for i, typeidx in enumerate(module.functions):
                ft = types[typeidx]
                self.functypes.append(ft)
                body = module.code[i]
                arrays = self._translate(
                    body.code, types, type_id, br_pool
                )
                translated.append((type_id(ft), len(ft.params),
                                   len(ft.results), len(body.locals), 0,
                                   arrays))
            for tid, np_, nr, nl, is_host, arrays in translated:
                if arrays is None:
                    checked(lib.wasmint_add_func(
                        self.handle, tid, np_, nr, nl, is_host,
                        None, None, None, None, 0,
                    ))
                else:
                    ops, ia, ib, ic = arrays
                    n = len(ops)
                    checked(lib.wasmint_add_func(
                        self.handle, tid, np_, nr, nl, is_host,
                        (ctypes.c_uint32 * n)(*ops),
                        (ctypes.c_int64 * n)(*ia),
                        (ctypes.c_int32 * n)(*ib),
                        (ctypes.c_int32 * n)(*ic),
                        n,
                    ))
            if br_pool:
                checked(lib.wasmint_set_brpool(
                    self.handle, (ctypes.c_int32 * len(br_pool))(*br_pool),
                    len(br_pool),
                ))
            for seg in module.data:
                checked(lib.wasmint_add_data(self.handle, bytes(seg.data),
                                             len(seg.data)))
        except Exception:
            # freed here, so __del__ must not free it again (a module the
            # core does not model raises NativeUnsupported mid-translation)
            handle, self.handle = self.handle, None
            lib.wasmint_module_free(handle)
            raise

        self.exports = module.export_map()
        self.n_func_imports = sum(
            1 for i in module.imports if i.kind == "func"
        )

    def __del__(self):  # pragma: no cover — interpreter shutdown ordering
        lib = getattr(self, "lib", None)
        handle = getattr(self, "handle", None)
        if lib is not None and handle:
            try:
                lib.wasmint_module_free(handle)
            except Exception:  # noqa: BLE001
                pass

    @staticmethod
    def _block_arity(bt, types) -> tuple[int, int]:
        if bt is None:
            return 0, 0
        from policy_server_tpu_torch.wasm.binary import F32 as _F32
        from policy_server_tpu_torch.wasm.binary import F64 as _F64
        from policy_server_tpu_torch.wasm.binary import I32 as _I32
        from policy_server_tpu_torch.wasm.binary import I64 as _I64

        if isinstance(bt, int) and bt in (_I32, _I64, _F32, _F64):
            return 0, 1
        ft = types[bt]
        return len(ft.params), len(ft.results)

    def _translate(self, code, types, type_id, br_pool):
        n = len(code)
        ops = [0] * n
        ia = [0] * n
        ib = [0] * n
        ic = [0] * n
        for pc, (op, imm) in enumerate(code):
            ops[pc] = op
            if op in (_BLOCK, _LOOP):
                bt, end = imm
                params, results = self._block_arity(bt, types)
                ia[pc], ib[pc], ic[pc] = end, params, results
            elif op == _IF:
                bt, end, else_idx = imm
                params, results = self._block_arity(bt, types)
                ia[pc] = end
                ib[pc] = -1 if else_idx is None else else_idx
                ic[pc] = (params << 16) | results
            elif op == ELSE:
                ia[pc] = imm if imm is not None else 0
            elif op in (0x0C, 0x0D):
                ia[pc] = imm
            elif op == 0x0E:
                targets, default = imm
                ia[pc] = len(br_pool)
                ib[pc] = len(targets)
                br_pool.extend(targets)
                br_pool.append(default)
            elif op == 0x10:
                ia[pc] = imm
            elif op == 0x11:
                typeidx, table = imm
                ia[pc] = type_id(types[typeidx])
                ib[pc] = table
            elif op in (0x20, 0x21, 0x22, 0x23, 0x24):
                ia[pc] = imm
            elif op in _MEM_OPS:
                ia[pc] = imm
            elif op == 0x41 or op == 0x42:
                ia[pc] = imm
            elif op in (0x43, 0x44):
                ia[pc] = _SLOT_I64.unpack(_SLOT_F64.pack(float(imm)))[0]
            elif op >= 0xFC00:
                sub = op & 0xFF
                if sub in (8, 9):
                    ia[pc] = imm
                elif sub in (0, 1, 2, 3, 4, 5, 6, 7, 10, 11):
                    pass
                else:
                    raise NativeUnsupported(f"extended op {sub}")
            # END / numeric / parameterless ops: no imm
        return ops, ia, ib, ic


def compiled_module(module: WasmModule) -> "_CompiledModule":
    cached = getattr(module, "_native_compiled", None)
    if cached is None:
        # negative results cache too: per-request instantiation must not
        # re-run a full translate-and-reject pass before every fallback
        unsupported = getattr(module, "_native_unsupported", None)
        if unsupported is not None:
            raise NativeUnsupported(unsupported)
        try:
            cached = _CompiledModule(module)
        except NativeUnsupported as e:
            module._native_unsupported = str(e)
            raise
        module._native_compiled = cached
    return cached


# -- instance ---------------------------------------------------------------


class _NativeMemData:
    """The tiny slice of the bytearray API host code touches on
    ``memory.data``: ``find(b"\\x00", start)`` and slicing."""

    def __init__(self, proxy: "_NativeMemory"):
        self._proxy = proxy

    def find(self, needle: bytes, start: int = 0) -> int:
        if needle != b"\x00":
            data = self._proxy.read(0, len(self._proxy))
            return data.find(needle, start)
        return self._proxy._inst._find0(start)

    def __getitem__(self, item):
        # bytearray-faithful indexing: negative indices/bounds wrap from
        # the end and out-of-range slice bounds clamp — host code treating
        # memory.data as a bytearray must not silently read wrong offsets
        n = len(self._proxy)
        if isinstance(item, slice):
            if item.step not in (None, 1):
                raise ValueError(
                    "extended slice steps are not supported on wasm memory"
                )
            start, stop, _ = item.indices(n)
            if stop <= start:
                return b""
            return self._proxy.read(start, stop - start)
        idx = int(item)
        if idx < 0:
            idx += n
        if not 0 <= idx < n:
            raise IndexError("index out of range")
        return self._proxy.read(idx, 1)[0]

    def __len__(self) -> int:
        return len(self._proxy)


class _NativeMemory:
    """interp.Memory surface over the C++-owned linear memory."""

    def __init__(self, inst: "NativeInstance"):
        self._inst = inst

    def __len__(self) -> int:
        return self._inst._mem_size()

    @property
    def pages(self) -> int:
        return self._inst._mem_size() // 65536

    @property
    def data(self) -> _NativeMemData:
        return _NativeMemData(self)

    def read(self, addr: int, n: int) -> bytes:
        return self._inst._mem_read(addr, n)

    def write(self, addr: int, payload: bytes) -> None:
        self._inst._mem_write(addr, payload)


class NativeInstance:
    """interp.Instance drop-in backed by the C++ core. Raises
    NativeUnsupported from the constructor when the module (or its
    imports) cannot run natively — callers fall back to Instance."""

    def __init__(self, module: WasmModule, imports=None, fuel: int | None = 500_000_000):
        self._lib = None  # set late: __del__ must survive partial init
        self._handle = None
        cm = compiled_module(module)
        self.module = module
        self._cm = cm
        lib = cm.lib

        self.deadline = getattr(_interp._ambient, "deadline", None)
        if self.deadline is not None and fuel is None:
            fuel = 1 << 62

        imports = imports or {}
        host_fns = []
        imported_memory: Memory | None = None
        for imp in module.imports:
            provided = (imports.get(imp.module) or {}).get(imp.name)
            if provided is None:
                raise WasmTrap(
                    f"missing import {imp.module}.{imp.name} ({imp.kind})"
                )
            if imp.kind == "func":
                fn = (
                    provided.fn
                    if isinstance(provided, _interp.HostFunc)
                    else provided
                )
                host_fns.append(fn)
            elif imp.kind == "memory":
                if not isinstance(provided, Memory):
                    raise WasmTrap("memory import must be a Memory")
                imported_memory = provided
        self._host_fns = host_fns
        self._host_exc: BaseException | None = None

        # the callback must outlive every invoke on this instance
        self._cb = _HOSTCB(self._dispatch_host)

        mem_pages = 0
        mem_max = -1
        if imported_memory is not None:
            mem_pages = imported_memory.pages
            mem_max = (
                imported_memory.maximum
                if imported_memory.maximum is not None
                else -1
            )
        elif module.memories:
            mem_pages = module.memories[0].minimum
            mem_max = (
                module.memories[0].maximum
                if module.memories[0].maximum is not None
                else -1
            )
        deadline = self.deadline if self.deadline is not None else 0.0
        self._handle = lib.wasmint_inst_new(
            cm.handle, mem_pages, mem_max,
            fuel if fuel is not None else 0,
            1 if fuel is not None else 0,
            deadline, 1 if self.deadline is not None else 0,
            self._cb, None,
        )
        if not self._handle:
            # NULL = allocation failure in the native core (a module may
            # legally declare a ~4 GiB initial memory); fail this request,
            # not the process.
            self._handle = None
            raise WasmTrap("out of memory instantiating module")
        self._lib = lib
        if imported_memory is not None and any(imported_memory.data):
            # the provided Memory's pre-existing content seeds the
            # C++-owned copy (the object itself is discarded — all later
            # access goes through the instance.memory proxy, matching
            # every in-repo creation pattern)
            self._mem_write(0, bytes(imported_memory.data))

        # globals (const-eval like interp.Instance; imports were rejected)
        global_bits = []
        self._global_types = []
        for g in module.globals:
            value = self._const_eval(g.init, global_bits, self._global_types)
            self._global_types.append(g.valtype)
            global_bits.append(self._encode_slot(value, g.valtype))
        if global_bits:
            if lib.wasmint_set_globals(
                self._handle,
                (ctypes.c_uint64 * len(global_bits))(*global_bits),
                len(global_bits),
            ):
                raise WasmTrap("out of memory instantiating module")

        # tables + element segments
        tables = [[-1] * limits.minimum for limits in module.tables]
        for seg in module.elems:
            offset = self._const_eval_plain(seg.offset, global_bits)
            table = tables[seg.table]
            if offset + len(seg.func_indices) > len(table):
                raise WasmTrap("element segment out of bounds")
            for j, fidx in enumerate(seg.func_indices):
                table[offset + j] = fidx
        for t in tables:
            if lib.wasmint_add_table(
                self._handle, (ctypes.c_int32 * len(t))(*t), len(t)
            ):
                raise WasmTrap("out of memory instantiating module")

        # active data segments
        for seg in module.data:
            if seg.offset is None:
                continue
            offset = self._const_eval_plain(seg.offset, global_bits)
            self._mem_write(offset, bytes(seg.data))

        self.memories = (
            [_NativeMemory(self)]
            if (module.memories or imported_memory is not None)
            else []
        )
        self._exports = cm.exports
        if module.start is not None:
            self._invoke_index(module.start, [])

    # -- const-eval (same subset as interp.Instance._const_eval) ----------

    def _const_eval(self, expr, global_bits, global_types):
        stack = []
        for op, imm in expr:
            if op in (0x41, 0x42, 0x43, 0x44):
                stack.append(imm)
            elif op == 0x23:
                stack.append(
                    self._decode_slot(global_bits[imm], global_types[imm])
                )
            else:
                raise WasmTrap(f"unsupported const instr 0x{op:02x}")
        return stack[-1] if stack else 0

    def _const_eval_plain(self, expr, global_bits):
        return self._const_eval(expr, global_bits, self._global_types)

    # -- slot codec --------------------------------------------------------

    @staticmethod
    def _encode_slot(value, valtype) -> int:
        if valtype in (F32, F64):
            return _SLOT_U64.unpack(_SLOT_F64.pack(float(value)))[0]
        return int(value) & 0xFFFFFFFFFFFFFFFF

    @staticmethod
    def _decode_slot(bits: int, valtype):
        if valtype in (F32, F64):
            return _SLOT_F64.unpack(_SLOT_U64.pack(bits & 0xFFFFFFFFFFFFFFFF))[0]
        v = bits & 0xFFFFFFFFFFFFFFFF
        return v - (1 << 64) if v >= (1 << 63) else v

    # -- host dispatch -----------------------------------------------------

    def _dispatch_host(self, _ctx, fidx, args_p, nargs, results_p, nresults_p):
        try:
            ft = self._cm.functypes[fidx]
            fn = self._host_fns[fidx]
            py_args = []
            for k, t in enumerate(ft.params):
                py_args.append(self._decode_slot(args_p[k], t))
            result = fn(self, *py_args)
            if result is None:
                out = []
            elif isinstance(result, tuple):
                out = list(result)
            else:
                out = [result]
            for k, t in enumerate(ft.results):
                results_p[k] = self._encode_slot(out[k], t)
            nresults_p[0] = len(ft.results)
            return 0
        except BaseException as e:  # noqa: BLE001 — crosses the C boundary
            self._host_exc = e
            return 1

    # -- memory ------------------------------------------------------------

    def _mem_size(self) -> int:
        return self._lib.wasmint_mem_size(self._handle)

    def _mem_read(self, addr: int, n: int) -> bytes:
        if n < 0:
            raise WasmTrap("out of bounds memory access")
        buf = ctypes.create_string_buffer(n)
        if self._lib.wasmint_mem_read(self._handle, addr, n, buf):
            raise WasmTrap("out of bounds memory access")
        return buf.raw

    def _mem_write(self, addr: int, payload: bytes) -> None:
        if self._lib.wasmint_mem_write(
            self._handle, addr, bytes(payload), len(payload)
        ):
            raise WasmTrap("out of bounds memory access")

    def _find0(self, start: int) -> int:
        return self._lib.wasmint_mem_find0(self._handle, start)

    # -- public API (interp.Instance surface) ------------------------------

    @property
    def memory(self) -> _NativeMemory:
        return self.memories[0]

    @property
    def fuel(self):
        return self._lib.wasmint_fuel_left(self._handle)

    def invoke(self, name: str, *args):
        exp = self._exports.get(name)
        if exp is None or exp.kind != "func":
            raise WasmTrap(f"no exported function {name!r}")
        return self._invoke_index(exp.index, list(args))

    def global_value(self, name: str):
        exp = self._exports.get(name)
        if exp is None or exp.kind != "global":
            raise WasmTrap(f"no exported global {name!r}")
        bits = self._lib.wasmint_get_global(self._handle, exp.index)
        valtype = (
            self._global_types[exp.index]
            if exp.index < len(self._global_types)
            else None
        )
        return self._decode_slot(bits & 0xFFFFFFFFFFFFFFFF, valtype)

    def _invoke_index(self, findex: int, args: list):
        ft = self._cm.functypes[findex]
        if len(args) != len(ft.params):
            raise WasmTrap(
                f"function expects {len(ft.params)} arguments, got {len(args)}"
            )
        raw = (ctypes.c_uint64 * max(1, len(args)))()
        for k, (v, t) in enumerate(zip(args, ft.params)):
            raw[k] = self._encode_slot(v, t)
        res = (ctypes.c_uint64 * 32)()
        nres = ctypes.c_int32(0)
        self._host_exc = None
        rc = self._lib.wasmint_invoke(
            self._handle, findex, raw, len(args), res, ctypes.byref(nres)
        )
        if rc != 0:
            msg = (self._lib.wasmint_err(self._handle) or b"").decode(
                "utf-8", "replace"
            )
            if rc == 2:
                raise WasmFuelExhausted("wasm fuel exhausted")
            if rc == 3:
                raise WasmDeadlineExceeded("wasm wall-clock deadline exceeded")
            if rc == 4:
                exc = self._host_exc
                self._host_exc = None
                if exc is not None:
                    raise exc
                raise WasmTrap("host function raised")
            raise WasmTrap(msg or "wasm trap")
        return [
            self._decode_slot(res[k], ft.results[k]) for k in range(nres.value)
        ]

    def __del__(self):  # pragma: no cover — interpreter shutdown ordering
        lib, handle = self._lib, self._handle
        if lib is not None and handle:
            try:
                lib.wasmint_inst_free(handle)
            except Exception:  # noqa: BLE001
                pass


def make_instance(module: WasmModule, imports=None, fuel: int | None = 500_000_000):
    """The native core's instance, or the interpreter's when the caller
    disabled the core (``PSTPU_NO_NATIVE_WASM=1``) or the module uses a
    construct the core does not model — the single construction point the
    waPC/OPA/WASI hosts use. A failed build, load or bind of the core
    raises."""
    if available():
        try:
            inst = NativeInstance(module, imports, fuel=fuel)
        except NativeUnsupported:
            pass
        else:
            _count("native")
            return inst
    inst = _interp.Instance(module, imports, fuel=fuel)
    _count("interp")
    return inst
