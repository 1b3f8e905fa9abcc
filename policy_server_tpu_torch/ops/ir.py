"""The predicate IR: a tensorizable expression language over AdmissionReview
documents.

This is the TPU-native replacement for the reference's execution model. The
reference runs each policy as an arbitrary WASM module per request
(src/evaluation/evaluation_environment.rs:513-581); here every policy is a
pure predicate expressed in this IR, which lowers two ways:

* ``ops.compiler``   — to fused jnp ops over batched feature tensors (the
  production TPU path),
* ``evaluation.oracle`` — to a direct host-side interpretation over the raw
  JSON (the bit-exact correctness oracle, standing in for the reference's
  wasmtime backend).

Design rules that keep the IR XLA-friendly (SURVEY.md §7.4):
* leaves are JSON paths with *declared* dtypes → static feature schema;
* arrays are handled by quantifiers (AnyOf/AllOf/CountOf) whose element axes
  become padded tensor dims with masks — never data-dependent loops;
* string operations are id-equality or precomputed per-string predicate bits
  (utils/interning.py) — no string compute on device;
* missing-value semantics are fixed and two-valued after grounding:
  comparisons/string-preds on missing values are False, AnyOf over an
  empty/missing array is False, AllOf is (vacuously) True, Exists tests
  presence. ``Not`` is plain logical complement of the grounded result.
"""

from __future__ import annotations

import enum
import fnmatch
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

STAR = "*"


class DType(enum.Enum):
    ID = "id"  # interned string
    F32 = "f32"  # JSON number
    BOOL = "bool"
    I32 = "i32"  # integer-valued (counts, lengths)


class IRError(ValueError):
    """Raised for malformed IR (bad types, bad nesting). Surfaces as a
    policy-initialization error at boot, mirroring the reference's
    settings-validation failures (evaluation_environment.rs:472-510)."""


# --------------------------------------------------------------------------
# Expression nodes
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Expr:
    def __and__(self, other: "Expr") -> "Expr":
        return And((self, other))

    def __or__(self, other: "Expr") -> "Expr":
        return Or((self, other))

    def __invert__(self) -> "Expr":
        return Not(self)


def render_key(segments: tuple[str, ...]) -> str:
    out = ""
    for s in segments:
        if s == STAR:
            out += "[*]"
        elif out:
            out += "." + s
        else:
            out = s
    return out


def _parse_segments(path: str | tuple[str, ...]) -> tuple[str, ...]:
    if isinstance(path, tuple):
        return path
    segs: list[str] = []
    for raw in path.split("."):
        while raw.endswith("[*]"):
            raw = raw[:-3]
            if raw:
                segs.append(raw)
            segs.append(STAR)
            raw = ""
        if raw:
            segs.append(raw)
    return tuple(segs)


@dataclass(frozen=True)
class Path(Expr):
    """Absolute JSON path into the validate payload. Segments are object
    keys, with ``*`` marking an array axis (e.g.
    ``request.object.spec.containers[*].image``). A path's wildcards must be
    bound by enclosing quantifiers except when the path is itself a
    quantifier domain."""

    segments: tuple[str, ...]
    dtype: DType = DType.ID

    def __init__(self, segments: str | tuple[str, ...], dtype: DType = DType.ID):
        object.__setattr__(self, "segments", _parse_segments(segments))
        object.__setattr__(self, "dtype", dtype)

    @property
    def n_stars(self) -> int:
        return sum(1 for s in self.segments if s == STAR)

    def key(self) -> str:
        return render_key(self.segments)


@dataclass(frozen=True)
class Elem(Expr):
    """Path relative to the current element of the innermost enclosing
    quantifier. ``Elem(())`` is the element itself (arrays of scalars)."""

    segments: tuple[str, ...] = ()
    dtype: DType = DType.ID

    def __init__(self, segments: str | tuple[str, ...] = (), dtype: DType = DType.ID):
        object.__setattr__(
            self, "segments", _parse_segments(segments) if segments else ()
        )
        object.__setattr__(self, "dtype", dtype)

    @property
    def n_stars(self) -> int:
        return sum(1 for s in self.segments if s == STAR)


@dataclass(frozen=True)
class Const(Expr):
    value: Any = None
    dtype: DType = DType.ID

    @classmethod
    def of(cls, value: Any) -> "Const":
        if isinstance(value, bool):
            return cls(value, DType.BOOL)
        if isinstance(value, int):
            return cls(value, DType.I32)
        if isinstance(value, float):
            return cls(value, DType.F32)
        if isinstance(value, str):
            return cls(value, DType.ID)
        raise IRError(f"unsupported constant {value!r}")


@dataclass(frozen=True)
class Exists(Expr):
    """True iff the path resolves to a present value (inside a quantifier the
    target may be an Elem)."""

    target: Path | Elem


@dataclass(frozen=True)
class Not(Expr):
    operand: Expr


@dataclass(frozen=True)
class And(Expr):
    operands: tuple[Expr, ...]

    def __init__(self, operands: tuple[Expr, ...] | list[Expr]):
        object.__setattr__(self, "operands", tuple(operands))


@dataclass(frozen=True)
class Or(Expr):
    operands: tuple[Expr, ...]

    def __init__(self, operands: tuple[Expr, ...] | list[Expr]):
        object.__setattr__(self, "operands", tuple(operands))


class CmpOp(enum.Enum):
    EQ = "=="
    NE = "!="
    LT = "<"
    LE = "<="
    GT = ">"
    GE = ">="


_ORDERED = {CmpOp.LT, CmpOp.LE, CmpOp.GT, CmpOp.GE}


@dataclass(frozen=True)
class Cmp(Expr):
    """Comparison; False when either side is missing. ID operands support
    only EQ/NE (string ordering has no device semantics)."""

    op: CmpOp
    lhs: Expr
    rhs: Expr


@dataclass(frozen=True)
class InSet(Expr):
    """Membership of a scalar in a constant set (settings-derived).
    False when the operand is missing; empty set → False."""

    operand: Expr
    values: tuple[Any, ...]
    dtype: DType = DType.ID


@dataclass(frozen=True)
class StrPred(Expr):
    """A host-registered predicate over the *string value* of the operand —
    regex match, glob match, prefix... Evaluated per unique string at intern
    time (utils/interning.py), emitted as a boolean feature column, so it
    costs nothing on device. False for missing values."""

    operand: Path | Elem
    kind: str  # regex | glob | prefix | suffix | contains
    pattern: str

    def key(self) -> str:
        return f"{self.kind}:{self.pattern}"

    def fn(self) -> Callable[[str], bool]:
        return build_str_pred(self.kind, self.pattern)


def build_str_pred(kind: str, pattern: str) -> Callable[[str], bool]:
    if kind == "regex":
        try:
            rx = re.compile(pattern)
        except re.error as e:
            raise IRError(f"invalid regex {pattern!r}: {e}") from e
        return lambda s: rx.search(s) is not None
    if kind == "glob":
        rx = re.compile(fnmatch.translate(pattern))
        return lambda s: rx.match(s) is not None
    if kind == "prefix":
        return lambda s: s.startswith(pattern)
    if kind == "suffix":
        return lambda s: s.endswith(pattern)
    if kind == "contains":
        return lambda s: pattern in s
    raise IRError(f"unknown string predicate kind {kind!r}")


@dataclass(frozen=True)
class AnyOf(Expr):
    """∃ element of ``over`` such that ``pred`` — empty/missing array → False.
    ``over`` must end with a ``*`` axis (appended implicitly if absent)."""

    over: Path | Elem
    pred: Expr

    def __post_init__(self) -> None:
        _normalize_quantifier_domain(self)


@dataclass(frozen=True)
class AllOf(Expr):
    """∀ element — empty/missing array → True (vacuous truth)."""

    over: Path | Elem
    pred: Expr

    def __post_init__(self) -> None:
        _normalize_quantifier_domain(self)


@dataclass(frozen=True)
class CountOf(Expr):
    """Number of elements satisfying ``pred`` (I32; 0 for missing arrays).
    Compose with Cmp for minimum-match semantics."""

    over: Path | Elem
    pred: Expr

    def __post_init__(self) -> None:
        _normalize_quantifier_domain(self)


def _normalize_quantifier_domain(q: AnyOf | AllOf | CountOf) -> None:
    over = q.over
    if not over.segments or over.segments[-1] != STAR:
        fixed = type(over)(tuple(over.segments) + (STAR,), over.dtype)
        object.__setattr__(q, "over", fixed)


Quantifier = (AnyOf, AllOf, CountOf)


# --------------------------------------------------------------------------
# Sugar
# --------------------------------------------------------------------------


def eq(lhs: Expr, rhs: Any) -> Expr:
    return Cmp(CmpOp.EQ, lhs, rhs if isinstance(rhs, Expr) else Const.of(rhs))


def ne(lhs: Expr, rhs: Any) -> Expr:
    return Cmp(CmpOp.NE, lhs, rhs if isinstance(rhs, Expr) else Const.of(rhs))


def lt(lhs: Expr, rhs: Any) -> Expr:
    return Cmp(CmpOp.LT, lhs, rhs if isinstance(rhs, Expr) else Const.of(rhs))


def le(lhs: Expr, rhs: Any) -> Expr:
    return Cmp(CmpOp.LE, lhs, rhs if isinstance(rhs, Expr) else Const.of(rhs))


def gt(lhs: Expr, rhs: Any) -> Expr:
    return Cmp(CmpOp.GT, lhs, rhs if isinstance(rhs, Expr) else Const.of(rhs))


def ge(lhs: Expr, rhs: Any) -> Expr:
    return Cmp(CmpOp.GE, lhs, rhs if isinstance(rhs, Expr) else Const.of(rhs))


def in_set(operand: Expr, values: Any, dtype: DType = DType.ID) -> Expr:
    return InSet(operand, tuple(values), dtype)


def true() -> Expr:
    return Const(True, DType.BOOL)


def false() -> Expr:
    return Const(False, DType.BOOL)


def matches_glob(operand: Path | Elem, pattern: str) -> Expr:
    return StrPred(operand, "glob", pattern)


def matches_regex(operand: Path | Elem, pattern: str) -> Expr:
    return StrPred(operand, "regex", pattern)


# --------------------------------------------------------------------------
# Type checking
# --------------------------------------------------------------------------


def infer_dtype(e: Expr) -> DType:
    if isinstance(e, (Path, Elem, Const)):
        return e.dtype
    if isinstance(e, CountOf):
        return DType.I32
    return DType.BOOL


def typecheck(expr: Expr) -> None:
    """Validate an IR expression: BOOL at top, comparable dtypes, Elem only
    inside quantifiers, wildcard arity bound by quantifier nesting (max
    depth 2), ordered comparisons only on numeric dtypes."""
    _typecheck(expr, depth=0)
    if infer_dtype(expr) is not DType.BOOL:
        raise IRError(f"policy predicate must be boolean, got {infer_dtype(expr)}")


_NUMERIC = {DType.F32, DType.I32}


def _comparable(a: DType, b: DType) -> bool:
    if a == b:
        return True
    return a in _NUMERIC and b in _NUMERIC


def _typecheck(e: Expr, depth: int) -> None:
    if isinstance(e, Path):
        if e.n_stars > 0:
            raise IRError(
                f"path {e.key()!r}: starred paths may only appear as quantifier "
                "domains; use Elem for element-scoped leaves"
            )
        return
    if isinstance(e, Elem):
        if depth == 0:
            raise IRError("Elem used outside a quantifier")
        if STAR in e.segments:
            raise IRError("Elem sub-path must not contain '*' (nest quantifiers instead)")
        return
    if isinstance(e, Const):
        return
    if isinstance(e, Exists):
        _typecheck(e.target, depth)
        return
    if isinstance(e, Not):
        _typecheck(e.operand, depth)
        if infer_dtype(e.operand) is not DType.BOOL:
            raise IRError("Not requires a boolean operand")
        return
    if isinstance(e, (And, Or)):
        if not e.operands:
            raise IRError("And/Or require at least one operand")
        for op in e.operands:
            _typecheck(op, depth)
            if infer_dtype(op) is not DType.BOOL:
                raise IRError("And/Or operands must be boolean")
        return
    if isinstance(e, Cmp):
        _typecheck(e.lhs, depth)
        _typecheck(e.rhs, depth)
        lt_, rt = infer_dtype(e.lhs), infer_dtype(e.rhs)
        if not _comparable(lt_, rt):
            raise IRError(f"cannot compare {lt_} with {rt}")
        if e.op in _ORDERED and lt_ not in _NUMERIC:
            raise IRError(f"ordered comparison {e.op.value} requires numeric operands")
        return
    if isinstance(e, InSet):
        _typecheck(e.operand, depth)
        if infer_dtype(e.operand) is not e.dtype:
            raise IRError(
                f"InSet dtype mismatch: operand {infer_dtype(e.operand)} vs set {e.dtype}"
            )
        return
    if isinstance(e, StrPred):
        _typecheck(e.operand, depth)
        if e.operand.dtype is not DType.ID:
            raise IRError("string predicates require an ID-typed operand")
        build_str_pred(e.kind, e.pattern)  # validates kind + pattern
        return
    if isinstance(e, Quantifier):
        if depth >= 2:
            raise IRError("quantifier nesting deeper than 2 is not supported")
        over = e.over
        # Domain shape rules keep the compiler and the oracle symmetric by
        # construction: top-level domains are absolute paths with exactly the
        # trailing star; nested domains are Elem-relative (their absolute
        # form inherits the enclosing axes).
        if isinstance(over, Elem):
            if depth == 0:
                raise IRError("Elem quantifier domain used outside a quantifier")
            if over.n_stars != 1:
                raise IRError("nested quantifier domain must have a single trailing '*'")
        else:
            if depth != 0:
                raise IRError(
                    "nested quantifiers must iterate an Elem-relative domain"
                )
            if over.n_stars != 1:
                raise IRError(
                    f"quantifier domain {over.key()!r} must have exactly one "
                    "trailing '*'"
                )
        _typecheck(e.pred, depth + 1)
        if infer_dtype(e.pred) is not DType.BOOL:
            raise IRError("quantifier predicate must be boolean")
        return
    raise IRError(f"unknown IR node {type(e).__name__}")


# --------------------------------------------------------------------------
# Traversal helpers (used by codec + compiler + oracle)
# --------------------------------------------------------------------------


def walk(e: Expr) -> Iterator[Expr]:
    yield e
    if isinstance(e, Exists):
        yield from walk(e.target)
    elif isinstance(e, Not):
        yield from walk(e.operand)
    elif isinstance(e, (And, Or)):
        for op in e.operands:
            yield from walk(op)
    elif isinstance(e, Cmp):
        yield from walk(e.lhs)
        yield from walk(e.rhs)
    elif isinstance(e, InSet):
        yield from walk(e.operand)
    elif isinstance(e, StrPred):
        yield from walk(e.operand)
    elif isinstance(e, Quantifier):
        yield from walk(e.over)
        yield from walk(e.pred)


DomainStack = tuple[Path, ...]


def absolute_path(leaf: "Path | Elem", stack: DomainStack) -> Path:
    """Absolute Path of a leaf under the enclosing-quantifier domain stack.
    Contextual (the same Elem/Path node may be reused under different
    quantifiers — node identity carries no scope). Codec, compiler and
    oracle all flatten through this single helper."""
    if isinstance(leaf, Path):
        return leaf
    if not stack:
        raise IRError("Elem used outside a quantifier")
    base = stack[-1]
    return Path(tuple(base.segments) + tuple(leaf.segments), leaf.dtype)


# --------------------------------------------------------------------------
# Op registry (the --long-version banner; reference prints burrego's OPA
# builtins, src/cli.rs:7-21)
# --------------------------------------------------------------------------


def registered_op_names() -> list[str]:
    return sorted(
        [
            "path", "elem", "const", "exists", "not", "and", "or",
            "cmp.eq", "cmp.ne", "cmp.lt", "cmp.le", "cmp.gt", "cmp.ge",
            "in_set", "str.regex", "str.glob", "str.prefix", "str.suffix",
            "str.contains", "any_of", "all_of", "count_of",
        ]
    )
