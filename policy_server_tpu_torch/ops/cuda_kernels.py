"""Hand-written CUDA kernels of the /validate path, their plain PyTorch
versions, the predicate-tape compiler, and the nvcc build and loader.

``policy_matrix`` is the fused gather → predicate → reduce step: one launch
evaluates every policy of the set over a batch of packed feature rows and
returns the ``(B, n_tiles * width)`` allowed / first-violated-rule matrices
(``csrc/policy_matrix.cu`` explains the kernel). Because the predicates
differ for every policy set, the kernel is an interpreter: this module
compiles each policy tile's optimizer-folded rule conditions into a flat
``int32`` instruction tape (``compile_tape``) that the kernel walks per row.

``probe`` is an ``(8, 128)`` float32 ``x + 1`` kernel the environment
launches once when it is built on the card.

Every wrapper takes its plain version only for tensors on the CPU; a CUDA
tensor goes through the kernel or raises. Each wrapper counts its own
launches (``<wrapper>.launches``), and nowhere else adds to that count.

The kernels build at first use with nvcc into ``build/torch_kernels/``
(beside the package) and load through ctypes with a plain C interface.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path as FsPath
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from policy_server_tpu_torch.ops import ir
from policy_server_tpu_torch.ops.codec import (
    PackedLayout,
    mask_key_for,
    unpack_rows,
)
from policy_server_tpu_torch.ops.compiler import const_value, inset_values
from policy_server_tpu_torch.ops.ir import CmpOp, DType, Expr, Path
from policy_server_tpu_torch.ops.optimizer import PolicyOptimization, scoped_key
from policy_server_tpu_torch.utils.interning import InternTable

# policies per policy tile (grid dim 1 of the kernel)
POLICY_TILE = 32

# threads per block of the policy-matrix kernel
THREADS = 256

# dynamic shared memory a block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448

_PACKAGE_DIR = FsPath(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR.parent / "build" / "torch_kernels"
LIB_NAME = "libpolicy_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


@dataclass
class KernelLibrary:
    """The loaded kernel library and how it was built."""

    lib: ctypes.CDLL
    path: FsPath
    build_seconds: float  # 0.0 when an up-to-date library was reused
    build_log: str


_library: KernelLibrary | None = None
_library_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidate = os.path.join(cuda_home, "bin", "nvcc")
        if os.path.exists(candidate):
            return candidate
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the policy "
        "kernels are compiled from csrc/ at first use"
    )


def _sources() -> list[FsPath]:
    return sorted(CSRC_DIR.glob("*.cu"))


def build_library(force: bool = False) -> KernelLibrary:
    """Compile ``csrc/*.cu`` into ``build/torch_kernels/`` when the library
    is missing or older than a source, then load it. Raises with nvcc's
    output when the build fails."""
    global _library
    with _library_lock:
        if _library is not None and not force:
            return _library
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / LIB_NAME
        sources = _sources()
        stale = force or not out.exists() or any(
            s.stat().st_mtime > out.stat().st_mtime for s in sources
        )
        log = ""
        seconds = 0.0
        if stale:
            tmp = BUILD_DIR / f".{LIB_NAME}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
                )
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pm_policy_matrix.argtypes = [
            vp, ci, ci, vp, vp, vp, vp, ci, ci, ci, ci, vp, vp, vp, ci, ci, vp,
        ]
        lib.pm_policy_matrix.restype = ci
        lib.pm_probe.argtypes = [vp, vp, ci, vp]
        lib.pm_probe.restype = ci
        lib.pm_error_string.argtypes = [ci]
        lib.pm_error_string.restype = ctypes.c_char_p
        _library = KernelLibrary(lib, out, seconds, log)
        return _library


def _check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.pm_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}: {msg}")


def _stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got {t.device}")


# ---------------------------------------------------------------------------
# probe: (8, 128) float32 x + 1
# ---------------------------------------------------------------------------


def probe_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def probe(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` for a contiguous float32 tensor: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("probe takes a contiguous float32 tensor")
    if x.device.type == "cpu":
        return probe_plain(x)
    _require_cuda(x, "probe")
    lib = build_library().lib
    y = torch.empty_like(x)
    rc = lib.pm_probe(
        x.data_ptr(), y.data_ptr(), x.numel(), _stream_handle(x.device)
    )
    _check(lib, rc, "probe")
    probe.launches += 1
    return y


probe.launches = 0


# ---------------------------------------------------------------------------
# the predicate tape
# ---------------------------------------------------------------------------

# opcodes; keep in sync with csrc/policy_matrix.cu
OP_LOAD_BIT = 0
OP_LOAD_U8 = 1
OP_LOAD_U16 = 2
OP_LOAD_W32 = 3
OP_CONST = 4
OP_CMP = 5
OP_AND = 6
OP_OR = 7
OP_NOT = 8
OP_INSET = 9
OP_ANY = 10
OP_ALL = 11
OP_COUNT = 12
OP_RULE = 13

T_BOOL, T_I32, T_F32 = 0, 1, 2

CMP_CODES = {
    CmpOp.EQ: 0, CmpOp.NE: 1, CmpOp.LT: 2, CmpOp.LE: 3, CmpOp.GT: 4,
    CmpOp.GE: 5,
}

INSTR_WORDS = 8

_TYPE_OF = {
    DType.ID: T_I32, DType.I32: T_I32, DType.F32: T_F32, DType.BOOL: T_BOOL,
}


def _f32_bits(v: float) -> int:
    return int(np.array([v], np.float32).view(np.int32)[0])


@dataclass(frozen=True)
class _Lane:
    """Where one feature column lives in a packed row of a given form."""

    op: int  # load opcode
    offset: int  # byte offset (bit offset for LOAD_BIT)
    caps: tuple[int, ...]
    type: int


def lane_map(
    layout: PackedLayout, transport: bool, narrow: bool
) -> dict[str, _Lane]:
    """Feature key → its lane in the chosen buffer form (the same offsets
    ``codec.unpack_rows`` slices)."""
    lanes: dict[str, _Lane] = {}
    for e in layout.entries8:
        op = OP_LOAD_BIT if transport else OP_LOAD_U8
        lanes[e.key] = _Lane(op, e.offset, e.caps, T_BOOL)
    id_off = other_off = 0
    for e in layout.entries32:
        t = T_F32 if e.is_f32 else T_I32
        if narrow:
            if e.is_id:
                lanes[e.key] = _Lane(
                    OP_LOAD_U16, layout.t16_off_u16_bytes + 2 * id_off,
                    e.caps, t,
                )
                id_off += e.elems
            else:
                lanes[e.key] = _Lane(
                    OP_LOAD_W32, layout.t16_off32_bytes + 4 * other_off,
                    e.caps, t,
                )
                other_off += e.elems
        else:
            base = layout.t_off32_bytes if transport else layout.off32_bytes
            lanes[e.key] = _Lane(
                OP_LOAD_W32, base + 4 * e.offset, e.caps, t
            )
    return lanes


def _count(caps: tuple[int, ...]) -> int:
    return int(np.prod(caps, dtype=np.int64)) if caps else 1


@dataclass(frozen=True)
class _Val:
    """A lowered sub-expression: a slot with its element axes."""

    slot: int
    naxes: int
    caps: tuple[int, ...]
    type: int

    @property
    def count(self) -> int:
        return _count(self.caps)


@dataclass
class Tape:
    """One policy tile's compiled program before arena allocation: rows of
    ``[op, dst, a, b, n, p0, p1, p2]`` with slot ids in dst/a/b."""

    instrs: list[list[int]] = field(default_factory=list)
    slot_sizes: list[int] = field(default_factory=list)  # bytes per slot


class _TapeCompiler:
    """Lowers one policy tile, mirroring ``compiler.lower_expr`` node for
    node: the same CSE keys (``optimizer.scoped_key``), the same trailing-
    axis broadcast, the same mask folding and quantifier reductions."""

    def __init__(
        self,
        lanes: Mapping[str, _Lane],
        table: InternTable,
        pool: list[int],
        use_cse: bool,
    ) -> None:
        self.lanes = lanes
        self.table = table
        self.pool = pool
        self.use_cse = use_cse
        self.tape = Tape()
        self.cse: dict[tuple, Any] = {}
        self.loads: dict[str, _Val] = {}
        self.consts: dict[tuple[int, int], _Val] = {}

    # -- emission ----------------------------------------------------------

    def _new_slot(self, count: int, type_: int) -> int:
        self.tape.slot_sizes.append(count * (1 if type_ == T_BOOL else 4))
        return len(self.tape.slot_sizes) - 1

    def _emit(
        self, op: int, caps: tuple[int, ...], naxes: int, type_: int,
        a: int = -1, b: int = -1, p0: int = 0, p1: int = 0, p2: int = 0,
    ) -> _Val:
        count = _count(caps)
        dst = self._new_slot(count, type_)
        self.tape.instrs.append([op, dst, a, b, count, p0, p1, p2])
        return _Val(dst, naxes, caps, type_)

    def load(self, key: str) -> _Val:
        hit = self.loads.get(key)
        if hit is None:
            lane = self.lanes[key]
            hit = self.loads[key] = self._emit(
                lane.op, lane.caps, len(lane.caps), lane.type, p0=lane.offset
            )
        return hit

    def const(self, value: Any, dtype: DType) -> _Val:
        t = _TYPE_OF[dtype]
        bits = _f32_bits(value) if t == T_F32 else int(value)
        hit = self.consts.get((t, bits))
        if hit is None:
            hit = self.consts[(t, bits)] = self._emit(
                OP_CONST, (), 0, t, p0=bits, p1=t
            )
        return hit

    def _binary(self, op: int, a: _Val, b: _Val, type_: int, p2: int = 0) -> _Val:
        big = a if a.naxes >= b.naxes else b
        if a.caps != big.caps[: a.naxes] or b.caps != big.caps[: b.naxes]:
            raise ir.IRError("operand axes do not broadcast")
        return self._emit(
            op, big.caps, big.naxes, type_, a=a.slot, b=b.slot,
            p0=big.count // a.count, p1=big.count // b.count, p2=p2,
        )

    def land(self, a: _Val, b: _Val) -> _Val:
        return self._binary(OP_AND, a, b, T_BOOL)

    def lor(self, a: _Val, b: _Val) -> _Val:
        return self._binary(OP_OR, a, b, T_BOOL)

    # -- lowering (mirrors compiler.lower_expr) ----------------------------

    def value_of(self, e: Expr, stack: ir.DomainStack) -> tuple[_Val, _Val | None]:
        if self.use_cse and not isinstance(e, ir.Const):
            memo_key = ("v", scoped_key(e, stack))
            hit = self.cse.get(memo_key)
            if hit is None:
                hit = self.cse[memo_key] = self._value_of(e, stack)
            return hit
        return self._value_of(e, stack)

    def _value_of(self, e: Expr, stack: ir.DomainStack) -> tuple[_Val, _Val | None]:
        if isinstance(e, ir.Const):
            return self.const(const_value(e, self.table), e.dtype), None
        if isinstance(e, (Path, ir.Elem)):
            p = ir.absolute_path(e, stack)
            key = f"{p.key()}:v:{p.dtype.value}"
            vals = self.load(key)
            mkey = mask_key_for(key)
            if mkey not in self.lanes:
                return vals, None
            return vals, self.load(mkey)
        return self.bool_of(e, stack), None

    def bool_of(self, e: Expr, stack: ir.DomainStack) -> _Val:
        if self.use_cse and not isinstance(e, ir.Const):
            memo_key = ("b", scoped_key(e, stack))
            hit = self.cse.get(memo_key)
            if hit is None:
                hit = self.cse[memo_key] = self._bool_of(e, stack)
            return hit
        return self._bool_of(e, stack)

    def _bool_of(self, e: Expr, stack: ir.DomainStack) -> _Val:
        if isinstance(e, ir.Const):
            return self.const(bool(e.value), DType.BOOL)
        if isinstance(e, ir.Exists):
            p = ir.absolute_path(e.target, stack)
            return self.load(f"{p.key()}:p")
        if isinstance(e, ir.Not):
            a = self.bool_of(e.operand, stack)
            return self._emit(OP_NOT, a.caps, a.naxes, T_BOOL, a=a.slot)
        if isinstance(e, (ir.And, ir.Or)):
            parts = [self.bool_of(op, stack) for op in e.operands]
            out = parts[0]
            combine = self.land if isinstance(e, ir.And) else self.lor
            for p in parts[1:]:
                out = combine(out, p)
            return out
        if isinstance(e, ir.Cmp):
            lv, lm = self.value_of(e.lhs, stack)
            rv, rm = self.value_of(e.rhs, stack)
            code = CMP_CODES[e.op] | (lv.type << 4) | (rv.type << 6)
            out = self._binary(OP_CMP, lv, rv, T_BOOL, p2=code)
            for m in (lm, rm):
                if m is not None:
                    out = self.land(m, out)
            return out
        if isinstance(e, ir.InSet):
            if not e.values:
                return self.const(False, DType.BOOL)
            ov, om = self.value_of(e.operand, stack)
            vals = inset_values(e, self.table)
            t = _TYPE_OF[e.dtype]
            start = len(self.pool)
            self.pool.extend(
                _f32_bits(v) if t == T_F32 else int(v) for v in vals
            )
            out = self._emit(
                OP_INSET, ov.caps, ov.naxes, T_BOOL, a=ov.slot,
                p0=start, p1=len(vals), p2=t,
            )
            if om is not None:
                out = self.land(om, out)
            return out
        if isinstance(e, ir.StrPred):
            p = ir.absolute_path(e.operand, stack)
            return self.load(f"{p.key()}:sp:{e.key()}")
        if isinstance(e, (ir.AnyOf, ir.AllOf, ir.CountOf)):
            dom = ir.absolute_path(e.over, stack)
            mask = self.load(f"{dom.key()}:p")
            pred = self.bool_of(e.pred, stack + (dom,))
            if pred.caps != mask.caps[: pred.naxes]:
                raise ir.IRError("quantifier predicate axes do not broadcast")
            inner = mask.caps[-1]
            op = (
                OP_ANY if isinstance(e, ir.AnyOf)
                else OP_ALL if isinstance(e, ir.AllOf) else OP_COUNT
            )
            return self._emit(
                op, mask.caps[:-1], mask.naxes - 1,
                T_I32 if op == OP_COUNT else T_BOOL,
                a=pred.slot, b=mask.slot, p0=inner,
                p1=mask.count // pred.count,
            )
        raise ir.IRError(f"cannot lower {type(e).__name__} as boolean")

    def rule(self, column: int, rule_idx: int, cond: Expr) -> None:
        if isinstance(cond, ir.Const) and not cond.value:
            return  # never violated
        v = self.bool_of(cond, ())
        if v.count != 1 or v.type != T_BOOL:
            raise ir.IRError("a rule condition must lower to one bool per row")
        self.tape.instrs.append([OP_RULE, -1, v.slot, -1, 1, column, rule_idx, 0])


def compile_tape(
    bucket: Sequence[str],
    sources: Mapping[str, PolicyOptimization],
    lanes: Mapping[str, _Lane],
    table: InternTable,
    pool: list[int],
    use_cse: bool,
) -> tuple[Tape, list[tuple[int, int]]]:
    """One policy tile → its tape and per-column ``(allowed, rule)``
    initial values. A policy with a constant verdict emits no instructions:
    its column starts at the constant. Every other column starts allowed
    (rule -1) and its rules, in index order, clear it at the first
    violation — the first-violated-rule argmax of ``compile_program``."""
    comp = _TapeCompiler(lanes, table, pool, use_cse)
    init: list[tuple[int, int]] = []
    for k, pid in enumerate(bucket):
        src = sources[pid]
        if src.constant is not None:
            allowed, rule_idx = src.constant
            init.append((int(bool(allowed)), int(rule_idx)))
            continue
        init.append((1, -1))
        for r, cond in enumerate(src.conditions):
            comp.rule(k, r, cond)
    return comp.tape, init


def allocate_arena(tape: Tape) -> tuple[np.ndarray, int]:
    """Assign each slot a byte offset in the block's arena, reusing the
    bytes of slots past their last use (first fit). A destination never
    shares bytes with a source of the same instruction. → (instructions
    with byte offsets, arena bytes)."""
    last_use: dict[int, int] = {}
    for i, ins in enumerate(tape.instrs):
        for s in (ins[1], ins[2], ins[3]):
            if s >= 0:
                last_use[s] = i
    offsets: dict[int, int] = {}
    free: list[tuple[int, int]] = []  # (offset, size), sorted by offset
    top = 0

    def alloc(size: int) -> int:
        nonlocal top
        size = (size + 3) & ~3
        for j, (off, sz) in enumerate(free):
            if sz >= size:
                if sz == size:
                    free.pop(j)
                else:
                    free[j] = (off + size, sz - size)
                return off
        off = top
        top += size
        return off

    def release(off: int, size: int) -> None:
        size = (size + 3) & ~3
        free.append((off, size))
        free.sort()
        merged: list[tuple[int, int]] = []
        for o, s in free:
            if merged and merged[-1][0] + merged[-1][1] == o:
                merged[-1] = (merged[-1][0], merged[-1][1] + s)
            else:
                merged.append((o, s))
        free[:] = merged

    out = np.zeros((len(tape.instrs), INSTR_WORDS), np.int32)
    for i, ins in enumerate(tape.instrs):
        row = list(ins)
        dst = ins[1]
        if dst >= 0:
            offsets[dst] = alloc(tape.slot_sizes[dst])
            row[1] = offsets[dst]
        for w in (2, 3):
            if ins[w] >= 0:
                row[w] = offsets[ins[w]]
        out[i] = row
        for s in {ins[1], ins[2], ins[3]}:
            if s >= 0 and last_use.get(s) == i:
                release(offsets[s], tape.slot_sizes[s])
    return out, (top + 15) & ~15


# ---------------------------------------------------------------------------
# policy_matrix
# ---------------------------------------------------------------------------


def plan_policy_tiles(
    policy_ids: Sequence[str], tile: int = POLICY_TILE
) -> tuple[list[tuple[str, ...]], int, dict[str, int]]:
    """Split the policy list into tiles of at most ``tile`` policies:
    ``(buckets, width, column_of)``, every tile padded to ``width``
    columns (the JAX package's plan, so the output layouts match)."""
    ordered = list(policy_ids)
    n_tiles = max(1, (len(ordered) + tile - 1) // tile)
    buckets = [
        tuple(ordered[t * tile : (t + 1) * tile]) for t in range(n_tiles)
    ]
    width = max(1, max(len(b) for b in buckets))
    column_of = {
        pid: t * width + k
        for t, bucket in enumerate(buckets)
        for k, pid in enumerate(bucket)
    }
    return buckets, width, column_of


@dataclass
class PolicyMatrixProgram:
    """Everything one buffer form of one schema bucket needs: the plain
    version's compiled functions and the kernel's tape."""

    layout: PackedLayout
    transport: bool
    narrow: bool
    buckets: list[tuple[str, ...]]
    width: int
    column_of: dict[str, int]
    compiled: Mapping[str, Callable]
    use_cse: bool
    tape: np.ndarray  # (n_instr, INSTR_WORDS) int32, all tiles
    tile_start: np.ndarray  # (n_tiles + 1,) int32
    pool: np.ndarray  # int32 (f32 constants as bits)
    col_init: np.ndarray  # (n_tiles, width, 2) int32
    arena_bytes: int
    _device_arrays: dict = field(default_factory=dict, repr=False)

    @property
    def buf_width(self) -> int:
        lo = self.layout
        if self.narrow:
            return lo.transport16_width
        return lo.transport_width if self.transport else lo.width

    @property
    def n_tiles(self) -> int:
        return len(self.buckets)

    @property
    def out_cols(self) -> int:
        return self.n_tiles * self.width

    def row_smem_bytes(self) -> int:
        return ((self.buf_width + 15) & ~15) + ((8 * self.width + 15) & ~15)

    @property
    def arena_in_smem(self) -> bool:
        return self.row_smem_bytes() + self.arena_bytes <= MAX_SMEM_BYTES

    def smem_bytes(self) -> int:
        return self.row_smem_bytes() + (
            self.arena_bytes if self.arena_in_smem else 0
        )

    def element_ops_per_row(self) -> int:
        """Element operations one row's tape performs (each instruction's
        element count; a reduction counts its inner elements)."""
        total = 0
        for ins in self.tape:
            op, n, p0 = int(ins[0]), int(ins[4]), int(ins[5])
            if op in (OP_ANY, OP_ALL, OP_COUNT):
                total += n * p0
            elif op == OP_INSET:
                total += n * int(ins[6])
            else:
                total += n
        return total

    def device_arrays(self, device: torch.device) -> tuple[torch.Tensor, ...]:
        hit = self._device_arrays.get(device)
        if hit is None:
            hit = self._device_arrays[device] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (
                    self.tape,
                    self.tile_start,
                    self.pool if self.pool.size else np.zeros(1, np.int32),
                    self.col_init,
                )
            )
        return hit


def build_policy_matrix(
    layout: PackedLayout,
    transport: bool,
    narrow: bool,
    compiled: Mapping[str, Callable],
    sources: Mapping[str, PolicyOptimization],
    table: InternTable,
    use_cse: bool = True,
) -> PolicyMatrixProgram:
    """Compile the policy set (``compiled``'s order) for one buffer form
    of one schema bucket. ``sources`` holds each policy's rule conditions
    or constant verdict; intern ids of string constants come from
    ``table``."""
    buckets, width, column_of = plan_policy_tiles(list(compiled))
    lanes = lane_map(layout, transport, narrow)
    pool: list[int] = []
    tapes: list[np.ndarray] = []
    starts = [0]
    col_init = np.zeros((len(buckets), width, 2), np.int32)
    arena = 0
    for t, bucket in enumerate(buckets):
        tape, init = compile_tape(bucket, sources, lanes, table, pool, use_cse)
        instrs, arena_t = allocate_arena(tape)
        tapes.append(instrs)
        starts.append(starts[-1] + len(instrs))
        arena = max(arena, arena_t)
        for k, (a, r) in enumerate(init):
            col_init[t, k] = (a, r)
    return PolicyMatrixProgram(
        layout=layout,
        transport=transport,
        narrow=narrow,
        buckets=buckets,
        width=width,
        column_of=column_of,
        compiled=compiled,
        use_cse=use_cse,
        tape=(
            np.concatenate(tapes)
            if any(len(x) for x in tapes)
            else np.zeros((0, INSTR_WORDS), np.int32)
        ),
        tile_start=np.asarray(starts, np.int32),
        pool=np.asarray(pool, np.int32),
        col_init=col_init,
        arena_bytes=max(arena, 16),
    )


def policy_matrix_plain(
    buf: torch.Tensor, program: PolicyMatrixProgram
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``unpack_rows`` and each tile's compiled
    functions (shared CSE table per tile, scalar InSet form), columns
    padded to the tile width with (False, 0)."""
    feats = unpack_rows(buf, program.layout, program.transport, program.narrow)
    rows = buf.shape[0]
    a_cols: list[torch.Tensor] = []
    r_cols: list[torch.Tensor] = []
    for bucket in program.buckets:
        cse: dict | None = {} if program.use_cse else None
        for pid in bucket:
            allowed, rule = program.compiled[pid](feats, cse, True)
            a_cols.append(allowed.to(torch.bool))
            r_cols.append(rule.to(torch.int32))
        pad = program.width - len(bucket)
        a_cols.extend(
            [torch.zeros(rows, dtype=torch.bool, device=buf.device)] * pad
        )
        r_cols.extend(
            [torch.zeros(rows, dtype=torch.int32, device=buf.device)] * pad
        )
    return torch.stack(a_cols, dim=-1), torch.stack(r_cols, dim=-1)


def policy_matrix(
    buf: torch.Tensor, program: PolicyMatrixProgram
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(allowed bool (B, cols), rule int32 (B, cols))`` for a packed
    ``uint8 (B, W)`` buffer in ``program``'s form: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if buf.dtype != torch.uint8 or buf.dim() != 2:
        raise ValueError("policy_matrix takes a 2-D uint8 buffer")
    if buf.shape[1] != program.buf_width:
        raise ValueError(
            f"buffer width {buf.shape[1]} does not match the program's "
            f"{program.buf_width}"
        )
    if not buf.is_contiguous():
        raise ValueError("policy_matrix takes a contiguous buffer")
    if buf.device.type == "cpu":
        return policy_matrix_plain(buf, program)
    _require_cuda(buf, "policy_matrix")
    batch, row_width = buf.shape
    if row_width % 4 or buf.data_ptr() % 16:
        raise ValueError("packed rows must be 4-byte wide and 16-byte aligned")
    lib = build_library().lib
    tape, tile_start, pool, col_init = program.device_arrays(buf.device)
    allowed = torch.empty(
        (batch, program.out_cols), dtype=torch.bool, device=buf.device
    )
    rule = torch.empty(
        (batch, program.out_cols), dtype=torch.int32, device=buf.device
    )
    scratch = None
    if not program.arena_in_smem:
        scratch = torch.empty(
            batch * program.n_tiles * program.arena_bytes,
            dtype=torch.uint8, device=buf.device,
        )
    rc = lib.pm_policy_matrix(
        buf.data_ptr(), batch, row_width,
        tape.data_ptr(), tile_start.data_ptr(), pool.data_ptr(),
        col_init.data_ptr(), program.n_tiles, program.width,
        program.arena_bytes, int(program.arena_in_smem),
        None if scratch is None else scratch.data_ptr(),
        allowed.data_ptr(), rule.data_ptr(),
        THREADS, program.smem_bytes(), _stream_handle(buf.device),
    )
    _check(lib, rc, "policy_matrix")
    policy_matrix.launches += 1
    return allowed, rule


policy_matrix.launches = 0


def reset_launch_counts() -> None:
    """Zero every wrapper's launch count."""
    probe.launches = 0
    policy_matrix.launches = 0


def launch_counts() -> dict[str, int]:
    return {
        "policy_matrix": policy_matrix.launches,
        "probe": probe.launches,
    }
