"""A policy-matrix program whose tape emits every opcode of the kernel.

The shipped policy sets never reach some opcodes once the optimizer has
folded them (``OP_ALL``, ``OP_COUNT``, f32 compares, ``OP_INSET`` over
bools, integers and floats), and every quantifier cap they use is a power
of two, so every broadcast divisor is a shift. ``every_opcode_program``
builds rule conditions by hand over the flagship set's schema that reach
all of them; ``with_division_divisors`` re-encodes a program's divisors as
divisions (the same arithmetic), so the kernel's division path runs too.
``allow_list_program`` builds allow-lists long enough to spill the arena
and to reach the shared-memory limit.
The tests and ``chip_smoke.py`` (which puts this directory on its path)
hold the kernel against its plain version on both. Imports nothing of
JAX."""

from __future__ import annotations

import dataclasses

import numpy as np

from policy_server_tpu_torch.ops import cuda_kernels as ck
from policy_server_tpu_torch.ops import ir
from policy_server_tpu_torch.ops.compiler import (
    PolicyProgram,
    Rule,
    compile_program,
)
from policy_server_tpu_torch.ops.ir import CmpOp, Const, DType, Elem, Path
from policy_server_tpu_torch.ops.optimizer import PolicyOptimization

CONTAINERS = Path("object.spec.containers[*]")
CAPS = Elem("securityContext.capabilities.add[*]")
PRIVILEGED = Elem("securityContext.privileged", DType.BOOL)
REPLICAS = Path("object.spec.replicas", DType.F32)
HOST_NETWORK = Path("object.spec.hostNetwork", DType.BOOL)


def _i32_scalar(lanes) -> Path:
    """The schema's first scalar i32 field (an image-verification
    count in the flagship set)."""
    for key in sorted(lanes):
        if key.endswith(":v:i32") and not lanes[key].caps:
            return Path(key[: -len(":v:i32")], DType.I32)
    raise ValueError("the schema has no scalar i32 field")


def every_opcode_conditions(lanes) -> dict[str, tuple[ir.Expr, ...]]:
    """Policy id → rule conditions over the flagship schema's fields
    (``lanes``: ``cuda_kernels.lane_map``) that, unoptimized, lower to
    every opcode of the tape (``OP_LOAD_U8`` only in the wide form, whose
    bool lanes are bytes)."""
    unverified = _i32_scalar(lanes)
    true = Const(True, DType.BOOL)
    return {
        "cover-all": (
            ir.AllOf(CONTAINERS, ir.Cmp(CmpOp.EQ, PRIVILEGED, true)),
            # a per-container value against a scalar one (divisor > 1)
            ir.AnyOf(CONTAINERS, ir.Or((
                ir.And((
                    ir.Cmp(CmpOp.NE, PRIVILEGED, true),
                    ir.Cmp(CmpOp.EQ, HOST_NETWORK, true),
                )),
                ir.Not(ir.Exists(Elem("image"))),
            ))),
        ),
        "cover-count": (
            ir.Cmp(
                CmpOp.GE,
                ir.CountOf(CONTAINERS, ir.Cmp(CmpOp.EQ, PRIVILEGED, true)),
                Const(2, DType.I32),
            ),
            # the count of a constant predicate: a reduction whose
            # predicate broadcasts over the mask (divisor > 1)
            ir.AnyOf(
                CONTAINERS,
                ir.Cmp(CmpOp.GE, ir.CountOf(CAPS, true), Const(3, DType.I32)),
            ),
        ),
        "cover-f32": (
            ir.Cmp(CmpOp.GT, REPLICAS, Const(3.5, DType.F32)),
            ir.Cmp(CmpOp.LE, REPLICAS, Const(1, DType.I32)),
            ir.Cmp(CmpOp.LT, unverified, REPLICAS),
        ),
        "cover-inset": (
            ir.InSet(HOST_NETWORK, (True,), DType.BOOL),
            ir.InSet(unverified, (1, 3), DType.I32),
            ir.InSet(REPLICAS, (2.0, 5.0), DType.F32),
            ir.Not(ir.AllOf(
                CONTAINERS,
                ir.AnyOf(CAPS, ir.InSet(Elem(), ("NET_RAW", "SYS_ADMIN"))),
            )),
        ),
    }


def every_opcode_program(
    env, schema_idx: int, transport: bool, narrow: bool
) -> ck.PolicyMatrixProgram:
    """The every-opcode program for one schema bucket and buffer form of a
    flagship environment (``evaluation.environment``). Interns its string
    constants into ``env.table``; no CSE, so the tape mirrors the
    conditions node for node."""
    layout = env.schemas[schema_idx].packed_layout()
    lanes = ck.lane_map(layout, transport, narrow)
    compiled = {}
    sources = {}
    for pid, conds in every_opcode_conditions(lanes).items():
        program = PolicyProgram(
            tuple(Rule(f"{pid}-{i}", c, pid) for i, c in enumerate(conds))
        )
        program.typecheck()
        compiled[pid] = compile_program(program, env.schema, env.table)
        sources[pid] = PolicyOptimization(conds)
    return ck.build_policy_matrix(
        layout, transport, narrow, compiled, sources, env.table,
        use_cse=False,
    )


def with_division_divisors(
    program: ck.PolicyMatrixProgram,
) -> ck.PolicyMatrixProgram:
    """A copy of ``program`` whose shift-encoded broadcast divisors are
    encoded as divisions by the same power of two."""
    tape = program.tape.copy()
    for ins in tape:
        op = int(ins[0])
        fields = (
            (5, 6) if op in (ck.OP_CMP, ck.OP_AND, ck.OP_OR)
            else (6,) if op in (ck.OP_ANY, ck.OP_ALL, ck.OP_COUNT) else ()
        )
        for f in fields:
            if ins[f] >= 0:
                ins[f] = -(1 << int(ins[f]))
    return dataclasses.replace(program, tape=tape)


def allow_list_program(
    env, sizes
) -> tuple[ck.PolicyMatrixProgram, int]:
    """A program of one policy per entry of ``sizes``, each with one rule:
    the schema's scalar i32 field in a set of that many even numbers
    (wide form of the small bucket, no CSE). → (program, byte offset of
    the field in a row)."""
    layout = env.schemas[0].packed_layout()
    lanes = ck.lane_map(layout, False, False)
    field = _i32_scalar(lanes)
    compiled = {}
    sources = {}
    for j, n in enumerate(sizes):
        pid = f"allow-list-{j}"
        cond = ir.InSet(field, tuple(range(2 * j, 2 * (j + n), 2)), DType.I32)
        compiled[pid] = compile_program(
            PolicyProgram((Rule(f"{pid}-0", cond, pid),)), env.schema,
            env.table,
        )
        sources[pid] = PolicyOptimization((cond,))
    program = ck.build_policy_matrix(
        layout, False, False, compiled, sources, env.table, use_cse=False
    )
    return program, lanes[f"{field.key()}:v:i32"].offset


def allow_list_at_limit(env) -> int:
    """The list length at which ``allow_list_program``'s one part, its
    arena spilled, takes exactly a block's shared memory."""
    small, _ = allow_list_program(env, [4])
    spare = ck.MAX_SMEM_BYTES - small.smem_plan(ck.LAYOUT_WARPS_SPILL, 1)[-1]
    if spare <= 0 or spare % 16:
        raise ValueError(f"no list length reaches the limit ({spare} B)")
    return 4 + 4 * (spare // 16)


def allow_list_rows(
    program: ck.PolicyMatrixProgram, offset: int, batch: int, seed: int
) -> np.ndarray:
    """``batch`` rows of random bits whose allow-listed field (at byte
    ``offset``) steps by 5 across the top of the first list, so some rows
    are in it and some are not."""
    rng = np.random.default_rng(seed)
    buf = (rng.random((batch, program.buf_width)) < 0.5).astype(np.uint8)
    n = int(program.tape[program.tape[:, 0] == ck.OP_INSET][0, 6])
    values = np.arange(batch, dtype=np.int32) * 5 + 2 * n - 5 * (batch // 2)
    buf[:, offset : offset + 4] = values[:, None].view(np.uint8)
    return buf


def opcodes_of(program: ck.PolicyMatrixProgram) -> set[int]:
    return {int(op) for op in np.unique(program.tape[:, 0])}
