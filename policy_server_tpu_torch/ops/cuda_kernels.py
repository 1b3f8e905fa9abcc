"""Hand-written CUDA kernels of the /validate path, their plain PyTorch
versions, the predicate-tape compiler, and the nvcc build and loader.

``policy_matrix`` is the fused gather → predicate → reduce step: one launch
evaluates every policy of the set over a batch of packed feature rows and
returns the ``(B, n_tiles * width)`` allowed / first-violated-rule matrices
(``csrc/policy_matrix.cu`` explains the kernel). Because the predicates
differ for every policy set, the kernel is an interpreter: this module
splits the policies into tape parts of about equal length
(``plan_tape_parts``), compiles each part's optimizer-folded rule
conditions into a flat ``int32`` instruction tape (``compile_tape``), each
part with its own InSet constant pool. The kernel runs a warp per row; its
arenas live in shared memory where one warp's fits beside the largest
part's code, else in a device scratch buffer (``PolicyMatrixProgram``).

``probe`` is an ``(8, 128)`` float32 ``x + 1`` kernel the environment
launches once when it is built on the card.

Every wrapper takes its plain version only for tensors on the CPU; a CUDA
tensor goes through the kernel or raises. Each wrapper counts its own
launches (``<wrapper>.launches``), and nowhere else adds to that count.

The kernels build at first use with nvcc into the build directory
(``build/torch_kernels/`` beside the package, or ``--compilation-cache-dir``;
``ops/buildcache.py``) and load through ctypes with a plain C interface.
"""

from __future__ import annotations

import ctypes
import fcntl
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

from policy_server_tpu_torch.ops import buildcache, ir
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

# tape parts the policy set is split into (grid dim 1 of the kernel):
# with 16 the flagship set's parts hold 24-39 instructions (1 part: 284)
TAPE_PARTS = 16

# where the policy-matrix kernel keeps its arenas (a warp per row); keep
# in sync with csrc/policy_matrix.cu
LAYOUT_WARPS = 0  # in shared memory
LAYOUT_WARPS_SPILL = 1  # in a device scratch buffer
LAYOUT_NAMES = {LAYOUT_WARPS: "warps", LAYOUT_WARPS_SPILL: "warps-spill"}
MAX_WARPS = 16  # rows (warps) per block, at most

# dynamic shared memory a block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448

_PACKAGE_DIR = FsPath(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / "csrc"
LIB_STEM = "libpolicy_kernels"
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
# the wrappers' launch counts are bumped from several pipeline threads
_count_lock = threading.Lock()

# The launch path's hot state, set once by the first successful
# build_library(): the bound entry points and torch's raw current-stream
# getter. A launch reads these module globals and takes no lock.
_pm_policy_matrix: Callable[..., int] | None = None
_pm_probe: Callable[..., int] | None = None
_pm_error_string: Callable[[int], bytes] | None = None
_raw_stream: Callable[[int], int] | None = None


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


def library_path() -> FsPath:
    """The library's file in the build directory, named by the hash of
    its inputs: the sources, nvcc and its flags, and the CUDA runtime
    torch was built for (``ops/buildcache.py``)."""
    key = buildcache.input_key(
        _sources(), _nvcc(), NVCC_FLAGS, f"cuda-{torch.version.cuda}"
    )
    return buildcache.build_dir() / f"{LIB_STEM}-{key}.so"


def build_library(force: bool = False) -> KernelLibrary:
    """Compile ``csrc/*.cu`` into the build directory when the library
    (named by the hash of its inputs) is missing or ``force`` is set, then
    load it and bind the launch path. Raises with nvcc's output when the
    build fails."""
    global _library, _pm_policy_matrix, _pm_probe, _pm_error_string
    global _raw_stream
    with _library_lock:
        if _library is not None and not force:
            return _library
        out = library_path()
        out.parent.mkdir(parents=True, exist_ok=True)
        log = ""
        seconds = 0.0
        # other processes building the same library wait on the lock
        with open(out.parent / f".{LIB_STEM}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if force or not out.exists():
                tmp = out.parent / f".{out.name}.{os.getpid()}.tmp"
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
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
        # Triton's launcher reads the stream the same way: no
        # torch.cuda.Stream object is built per launch
        raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        if raw_stream is None:
            raise RuntimeError("this torch build has no CUDA stream binding")
        lib = ctypes.CDLL(str(out))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pm_policy_matrix.argtypes = [vp, vp, ci, vp, vp, vp, vp]
        lib.pm_policy_matrix.restype = ci
        lib.pm_probe.argtypes = [vp, vp, ci, vp]
        lib.pm_probe.restype = ci
        lib.pm_error_string.argtypes = [ci]
        lib.pm_error_string.restype = ctypes.c_char_p
        _library = KernelLibrary(lib, out, seconds, log)
        _pm_policy_matrix = lib.pm_policy_matrix
        _pm_probe = lib.pm_probe
        _pm_error_string = lib.pm_error_string
        _raw_stream = raw_stream
        return _library


def _launch_failed(rc: int, what: str) -> RuntimeError:
    msg = _pm_error_string(rc).decode(errors="replace")
    return RuntimeError(f"{what} launch failed: CUDA error {rc}: {msg}")


def is_cuda_error(e: BaseException) -> bool:
    """True for an error the CUDA runtime reported: a wrapper's failed
    launch, or a torch operation's CUDA error (a sticky one, an illegal
    address say, poisons the context for the life of the process)."""
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if accelerator_error is not None and isinstance(e, accelerator_error):
        return True
    return isinstance(e, RuntimeError) and "CUDA error" in str(e)


def _not_cuda(t: torch.Tensor, what: str) -> ValueError:
    return ValueError(f"{what}: expected a CPU or CUDA tensor, got {t.device}")


_sm_counts: dict[int, int] = {}


def _sm_count(index: int) -> int:
    n = _sm_counts.get(index)
    if n is None:
        n = _sm_counts[index] = torch.cuda.get_device_properties(
            index
        ).multi_processor_count
    return n


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
    if x.is_cpu:
        return probe_plain(x)
    if not x.is_cuda:
        raise _not_cuda(x, "probe")
    if _pm_probe is None:
        build_library()
    y = torch.empty_like(x)
    rc = _pm_probe(
        x.data_ptr(), y.data_ptr(), x.numel(), _raw_stream(x.get_device())
    )
    if rc:
        raise _launch_failed(rc, "probe")
    with _count_lock:
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

    # -- trial emission (plan_tape_parts) -----------------------------------

    def checkpoint(self) -> tuple[int, ...]:
        return (
            len(self.tape.instrs), len(self.tape.slot_sizes), len(self.pool),
            len(self.cse), len(self.loads), len(self.consts),
        )

    def rollback(self, cp: tuple[int, ...]) -> None:
        """Forget everything emitted since ``cp`` (the memo dicts keep
        insertion order, so their newest entries are the ones to drop)."""
        n_instrs, n_slots, n_pool, *n_memo = cp
        del self.tape.instrs[n_instrs:]
        del self.tape.slot_sizes[n_slots:]
        del self.pool[n_pool:]
        for memo, n in zip((self.cse, self.loads, self.consts), n_memo):
            while len(memo) > n:
                memo.popitem()

    def policy(self, column: int, src: PolicyOptimization) -> None:
        for r, cond in enumerate(src.conditions):
            self.rule(column, r, cond)

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
    """One tape part's policies → its tape and per-local-column
    ``(allowed, rule)`` initial values (local column k is ``bucket[k]``).
    A policy with a constant verdict emits no instructions:
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
        comp.policy(k, src)
    return comp.tape, init


def plan_tape_parts(
    order: Sequence[str],
    sources: Mapping[str, PolicyOptimization],
    lanes: Mapping[str, _Lane],
    table: InternTable,
    use_cse: bool,
    n_parts: int,
) -> list[list[str]]:
    """Split the policies that have rules into at most ``n_parts`` parts of
    about equal instruction count: longest policy first, each to the part
    whose tape it leaves shortest (its marginal cost counts what CSE shares
    with the policies already there). → each part's policies, in
    ``order``."""
    dynamic = [pid for pid in order if sources[pid].constant is None]
    n_parts = max(1, min(n_parts, len(dynamic)))
    alone = {}
    for pid in dynamic:
        comp = _TapeCompiler(lanes, table, [], use_cse)
        comp.policy(0, sources[pid])
        alone[pid] = len(comp.tape.instrs)
    comps = [_TapeCompiler(lanes, table, [], use_cse) for _ in range(n_parts)]
    parts: list[list[str]] = [[] for _ in range(n_parts)]
    for pid in sorted(dynamic, key=lambda p: -alone[p]):
        best = (0, -1)
        for j, comp in enumerate(comps):
            cp = comp.checkpoint()
            comp.policy(0, sources[pid])
            size = len(comp.tape.instrs)
            comp.rollback(cp)
            if best[1] < 0 or size < best[0]:
                best = (size, j)
        comps[best[1]].policy(0, sources[pid])
        parts[best[1]].append(pid)
    rank = {pid: i for i, pid in enumerate(order)}
    return [sorted(part, key=rank.__getitem__) for part in parts]


def encode_divisor(d: int) -> int:
    """A broadcast divisor as the kernel reads it: log2 for a power of two
    (a shift), else the negated divisor (a division)."""
    if d <= 0:
        raise ValueError(f"broadcast divisor must be positive, got {d}")
    return d.bit_length() - 1 if d & (d - 1) == 0 else -d


def decode_divide(x: Any, w: int) -> Any:
    """``x`` divided by an encoded divisor (``encode_divisor``)."""
    return x >> w if w >= 0 else x // -w


def encode_divisors(instrs: np.ndarray) -> None:
    """Encode the broadcast divisors of an allocated tape in place: p0 and
    p1 of binary instructions, p1 of reductions."""
    for ins in instrs:
        op = int(ins[0])
        if op in (OP_CMP, OP_AND, OP_OR):
            ins[5] = encode_divisor(int(ins[5]))
            ins[6] = encode_divisor(int(ins[6]))
        elif op in (OP_ANY, OP_ALL, OP_COUNT):
            ins[6] = encode_divisor(int(ins[6]))


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


def _align16(n: int) -> int:
    return (n + 15) & ~15


class _LaunchArgs(ctypes.Structure):
    """What a launch needs that does not change from call to call for one
    program, batch size and device (``LaunchArgs`` in
    csrc/policy_matrix.cu), built once so a launch passes seven
    arguments through ctypes."""

    _fields_ = [
        ("code", ctypes.c_void_p), ("meta", ctypes.c_void_p),
        *((name, ctypes.c_int) for name in (
            "row_width", "n_parts", "out_cols", "arena_bytes", "layout",
            "rows_per_block", "max_cols", "off_cols", "off_arena",
            "smem_bytes",
        )),
    ]


@dataclass(frozen=True)
class LaunchShape:
    """One launch's layout, rows (warps) per block and shared-memory plan
    (byte offsets of the column state and the arena after the part's
    code)."""

    layout: int
    rows_per_block: int
    off_cols: int
    off_arena: int
    smem_bytes: int


@dataclass
class PolicyMatrixProgram:
    """Everything one buffer form of one schema bucket needs: the plain
    version's compiled functions and the kernel's tape parts. Part q runs
    instructions ``part_start[q]:part_start[q+1]``, whose InSet constants
    are ``pool[pool_start[q]:pool_start[q+1]]`` (their p0 counts from the
    part's first), and owns local columns ``col_start[q]:col_start[q+1]``,
    written to output columns ``part_cols[...]``; every output column
    belongs to exactly one part."""

    layout: PackedLayout
    transport: bool
    narrow: bool
    buckets: list[tuple[str, ...]]
    width: int
    column_of: dict[str, int]
    compiled: Mapping[str, Callable]
    use_cse: bool
    tape: np.ndarray  # (n_instr, INSTR_WORDS) int32, every part in turn
    part_start: np.ndarray  # (n_parts + 1,) int32
    part_cols: np.ndarray  # (n_local,) int32 output column of each
    col_start: np.ndarray  # (n_parts + 1,) int32
    col_init: np.ndarray  # (n_local, 2) int32 (allowed, rule)
    pool: np.ndarray  # int32 (f32 constants as bits), every part in turn
    pool_start: np.ndarray  # (n_parts + 1,) int32
    arena_bytes: int
    arena_layout: int = field(init=False)  # LAYOUT_WARPS unless it must spill
    max_warps: int = field(init=False)  # rows per block, at most
    buf_width: int = field(init=False)
    out_cols: int = field(init=False)
    # caches, fresh in every copy (dataclasses.replace)
    _device_code: dict = field(default_factory=dict, init=False, repr=False)
    _shapes: dict = field(default_factory=dict, init=False, repr=False)
    _launches: dict = field(default_factory=dict, init=False, repr=False)
    # guards building _device_code and _launches: two pipeline threads
    # building one card's device code at once would each keep a struct
    # pointing at their own copy, and one copy is freed while in use
    _launch_lock: Any = field(
        default_factory=threading.Lock, init=False, repr=False, compare=False
    )

    def __post_init__(self) -> None:
        lo = self.layout
        if self.narrow:
            self.buf_width = lo.transport16_width
        else:
            self.buf_width = lo.transport_width if self.transport else lo.width
        self.out_cols = len(self.buckets) * self.width
        for layout in (LAYOUT_WARPS, LAYOUT_WARPS_SPILL):
            if self.smem_plan(layout, 1)[-1] <= MAX_SMEM_BYTES:
                break
        else:
            q = int(np.argmax(self.part_int4s))
            raise ValueError(
                f"tape part {q} needs {self.smem_plan(layout, 1)[-1]:,} B of "
                f"shared memory with its arena spilled ("
                f"{self.part_lengths[q]} instructions, "
                f"{int(np.diff(self.col_start)[q])} columns, "
                f"{int(np.diff(self.pool_start)[q])} InSet constants); a "
                f"block has {MAX_SMEM_BYTES:,} B: split the set into more "
                f"parts or shorten its allow-lists"
            )
        self.arena_layout = layout
        warps = 1
        while (
            2 * warps <= MAX_WARPS
            and self.smem_plan(layout, 2 * warps)[-1] <= MAX_SMEM_BYTES
        ):
            warps *= 2
        self.max_warps = warps

    @property
    def n_parts(self) -> int:
        return len(self.part_start) - 1

    @property
    def part_lengths(self) -> list[int]:
        return np.diff(self.part_start).tolist()

    @property
    def max_part_instrs(self) -> int:
        return max(self.part_lengths, default=0)

    @property
    def max_part_cols(self) -> int:
        return max(np.diff(self.col_start).tolist(), default=0)

    @property
    def part_pool_int4s(self) -> list[int]:
        """16-byte words of each part's InSet pool."""
        return [-(-n // 4) for n in np.diff(self.pool_start).tolist()]

    @property
    def part_int4s(self) -> list[int]:
        """16-byte words of each part's staged code: two per instruction,
        one per column record, then its pool."""
        return [
            2 * n + c + k for n, c, k in zip(
                self.part_lengths, np.diff(self.col_start).tolist(),
                self.part_pool_int4s,
            )
        ]

    def smem_plan(self, layout: int, rows: int) -> tuple[int, int, int]:
        """→ (column-state and arena byte offsets, total bytes) of a block
        of ``rows`` rows in ``layout``: the largest part's code, each
        row's column state and the rows' arenas (none when spilled)."""
        off_cols = 16 * max(self.part_int4s, default=0)
        off_arena = off_cols + _align16(8 * rows * self.max_part_cols)
        arena = 0 if layout == LAYOUT_WARPS_SPILL else rows * self.arena_bytes
        return off_cols, off_arena, off_arena + arena

    def launch_shape(self, batch: int, n_sm: int) -> LaunchShape:
        """Up to ``max_warps`` rows per block, halving while the grid would
        give the card's ``n_sm`` SMs fewer blocks than one each."""
        key = (batch, n_sm)
        hit = self._shapes.get(key)
        if hit is None:
            rows = self.max_warps
            while rows > 1 and -(-batch // rows) * self.n_parts < n_sm:
                rows //= 2
            hit = self._shapes[key] = LaunchShape(
                self.arena_layout, rows,
                *self.smem_plan(self.arena_layout, rows),
            )
        return hit

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

    def device_code(self) -> tuple[np.ndarray, np.ndarray]:
        """The tape as the kernel stages it: ``code`` (int32, 4 per
        16-byte word) holds, for each part, its instructions (two words
        each), one ``(output column, allowed, rule, 0)`` record per local
        column and its pool, zero-padded to whole words; ``meta``
        (n_parts, 4) holds each part's ``(word offset, instructions,
        columns, pool words)``."""
        chunks = [np.zeros((0, 4), np.int32)]
        meta = np.zeros((self.n_parts, 4), np.int32)
        offset = 0
        for q in range(self.n_parts):
            i0, i1 = self.part_start[q], self.part_start[q + 1]
            c0, c1 = self.col_start[q], self.col_start[q + 1]
            records = np.zeros((c1 - c0, 4), np.int32)
            records[:, 0] = self.part_cols[c0:c1]
            records[:, 1:3] = self.col_init[c0:c1]
            n_pool = self.part_pool_int4s[q]
            pool = np.zeros(4 * n_pool, np.int32)
            part_pool = self.pool[self.pool_start[q] : self.pool_start[q + 1]]
            pool[: len(part_pool)] = part_pool
            chunks += [
                self.tape[i0:i1].reshape(-1, 4), records, pool.reshape(-1, 4)
            ]
            meta[q] = (offset, i1 - i0, c1 - c0, n_pool)
            offset += self.part_int4s[q]
        return np.concatenate(chunks).reshape(-1), meta

    def launch_args(self, index: int, batch: int) -> tuple[int, int]:
        """→ (address of the ``_LaunchArgs`` for a batch of ``batch`` rows
        on card ``index``, scratch bytes the launch needs). Built on first
        use; the program keeps the struct and the device code alive."""
        key = (index, batch)
        hit = self._launches.get(key)
        if hit is not None:
            return hit[1], hit[2]
        with self._launch_lock:
            hit = self._launches.get(key)
            if hit is None:
                code = self._device_code.get(index)
                if code is None:
                    code = self._device_code[index] = tuple(
                        torch.from_numpy(a).to(torch.device("cuda", index))
                        for a in self.device_code()
                    )
                shape = self.launch_shape(batch, _sm_count(index))
                args = _LaunchArgs(
                    code[0].data_ptr(), code[1].data_ptr(), self.buf_width,
                    self.n_parts, self.out_cols, self.arena_bytes, shape.layout,
                    shape.rows_per_block, self.max_part_cols, shape.off_cols,
                    shape.off_arena, shape.smem_bytes,
                )
                scratch = (
                    batch * self.n_parts * self.arena_bytes
                    if shape.layout == LAYOUT_WARPS_SPILL else 0
                )
                hit = self._launches[key] = (args, ctypes.addressof(args), scratch)
        return hit[1], hit[2]

    def release_device_code(self) -> None:
        """Drop the launch structs and the device code they point into.
        The caller makes sure no launch of this program is still queued."""
        with self._launch_lock:
            self._launches.clear()
            self._device_code.clear()


def build_policy_matrix(
    layout: PackedLayout,
    transport: bool,
    narrow: bool,
    compiled: Mapping[str, Callable],
    sources: Mapping[str, PolicyOptimization],
    table: InternTable,
    use_cse: bool = True,
    n_parts: int = TAPE_PARTS,
    buckets: Sequence[tuple[str, ...]] | None = None,
    width: int | None = None,
) -> PolicyMatrixProgram:
    """Compile the policy set (``compiled``'s order) for one buffer form
    of one schema bucket. ``sources`` holds each policy's rule conditions
    or constant verdict; intern ids of string constants come from
    ``table``. The output columns follow ``plan_policy_tiles``; the tape
    follows ``plan_tape_parts`` into ``n_parts`` parts (the tests vary
    it), and constant-verdict and padding columns go to the parts with the
    fewest columns. Each part gets its own InSet pool.

    ``buckets``/``width`` override the tile plan, as the JAX package's
    ``policy_matrix_program`` takes them: the mesh passes one bucket, a
    policy shard's ids, padded to the shard block's width, so the tape
    holds only that shard's policies and the output is its block."""
    if buckets is None:
        buckets, width, column_of = plan_policy_tiles(list(compiled))
    else:
        if width is None:
            raise ValueError("a tile plan override needs its width")
        buckets = [tuple(b) for b in buckets]
        if any(len(b) > width for b in buckets):
            raise ValueError(f"a bucket is wider than the plan's {width} columns")
        column_of = {
            pid: t * width + k
            for t, bucket in enumerate(buckets)
            for k, pid in enumerate(bucket)
        }
    order = [pid for bucket in buckets for pid in bucket]
    lanes = lane_map(layout, transport, narrow)
    for key, lane in lanes.items():
        if lane.op == OP_LOAD_W32 and lane.offset % 4:
            raise ValueError(f"32-bit lane {key} is not word aligned")
    parts = plan_tape_parts(order, sources, lanes, table, use_cse, n_parts)
    spare = [pid for pid in order if sources[pid].constant is not None]
    spare_cols: list[list[str]] = [[] for _ in parts]
    for pid in spare:
        q = min(range(len(parts)), key=lambda j: len(parts[j]) + len(spare_cols[j]))
        spare_cols[q].append(pid)
    pads = sorted(set(range(len(buckets) * width)) - set(column_of.values()))
    pad_cols: list[list[int]] = [[] for _ in parts]
    for c in pads:
        q = min(
            range(len(parts)),
            key=lambda j: len(parts[j]) + len(spare_cols[j]) + len(pad_cols[j]),
        )
        pad_cols[q].append(c)
    rank = {pid: i for i, pid in enumerate(order)}
    pool: list[int] = []
    tapes: list[np.ndarray] = []
    starts, col_starts, pool_starts = [0], [0], [0]
    cols: list[int] = []
    init_rows: list[tuple[int, int]] = []
    arena = 0
    for q, part in enumerate(parts):
        pids = sorted(part + spare_cols[q], key=rank.__getitem__)
        part_pool: list[int] = []
        tape, init = compile_tape(
            pids, sources, lanes, table, part_pool, use_cse
        )
        pool.extend(part_pool)
        pool_starts.append(len(pool))
        instrs, arena_q = allocate_arena(tape)
        encode_divisors(instrs)
        tapes.append(instrs)
        starts.append(starts[-1] + len(instrs))
        cols.extend([column_of[p] for p in pids] + pad_cols[q])
        init_rows.extend(init + [(0, 0)] * len(pad_cols[q]))
        col_starts.append(len(cols))
        arena = max(arena, arena_q)
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
        part_start=np.asarray(starts, np.int32),
        part_cols=np.asarray(cols, np.int32),
        col_start=np.asarray(col_starts, np.int32),
        col_init=np.asarray(init_rows, np.int32).reshape(-1, 2),
        pool=np.asarray(pool, np.int32),
        pool_start=np.asarray(pool_starts, np.int32),
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
    batch, row_width = buf.shape
    if row_width != program.buf_width:
        raise ValueError(
            f"buffer width {row_width} does not match the program's "
            f"{program.buf_width}"
        )
    if not buf.is_contiguous():
        raise ValueError("policy_matrix takes a contiguous buffer")
    if buf.is_cpu:
        return policy_matrix_plain(buf, program)
    if not buf.is_cuda:
        raise _not_cuda(buf, "policy_matrix")
    if row_width % 4 or buf.data_ptr() % 4:
        raise ValueError("packed rows must be 4-byte wide and 4-byte aligned")
    cols = program.out_cols
    if batch == 0:  # an empty grid is not a launch
        return (
            torch.empty((0, cols), dtype=torch.bool, device=buf.device),
            torch.empty((0, cols), dtype=torch.int32, device=buf.device),
        )
    if _pm_policy_matrix is None:
        build_library()
    index = buf.get_device()
    args, scratch_bytes = program.launch_args(index, batch)
    # two allocations: on the card's host, one buffer cut into two typed
    # views (four view calls) cost more than a second allocation
    allowed = buf.new_empty((batch, cols), dtype=torch.bool)
    rule = buf.new_empty((batch, cols), dtype=torch.int32)
    scratch = buf.new_empty(scratch_bytes) if scratch_bytes else None
    rc = _pm_policy_matrix(
        args, buf.data_ptr(), batch,
        None if scratch is None else scratch.data_ptr(),
        allowed.data_ptr(), rule.data_ptr(), _raw_stream(index),
    )
    if rc:
        raise _launch_failed(rc, "policy_matrix")
    with _count_lock:
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
