"""The port's kernels on the CPU: ``policy_matrix``'s plain version and its
predicate tape against the JAX package's Pallas kernel
(``policy_matrix_program(..., interpret=True)``), and the probe's plain
version. The tape runs through a small numpy interpreter of the kernel's
instruction set that lives in this file, so a tape bug shows here before
the card ever sees it. Tolerance: exact equality throughout (verdicts are
booleans and int32 rule indices; f32 values are only compared)."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from policy_server_tpu.ops import pallas_kernels
from policy_server_tpu_torch.ops import cuda_kernels as ck

from torch_port_support import (
    FORM_FLAGS,
    buffer_forms,
    catalog_docs,
    catalog_specs,
    firehose_docs,
    flagship_specs,
    jax_env,
    packed_batches,
    sync_envs,
    torch_env,
)

BATCH = 8


# ---------------------------------------------------------------------------
# a numpy interpreter of the tape (the kernel's semantics, row by row)
# ---------------------------------------------------------------------------


_NP = {ck.T_BOOL: np.uint8, ck.T_I32: np.int32, ck.T_F32: np.float32}


def _view(arena: np.ndarray, off: int, count: int, type_: int) -> np.ndarray:
    size = 1 if type_ == ck.T_BOOL else 4
    return arena[off : off + size * count].view(_NP[type_])


def _cmp(code: int, a, b):
    return [
        np.equal, np.not_equal, np.less, np.less_equal, np.greater,
        np.greater_equal,
    ][code](a, b)


def _sources(op, a, b, n, p0, p1, p2):
    """(byte offset, element count, type) of each slot an instruction
    reads — the counts follow from the broadcast divisors."""
    if op == ck.OP_CMP:
        return [(a, n // p0, (p2 >> 4) & 3), (b, n // p1, (p2 >> 6) & 3)]
    if op in (ck.OP_AND, ck.OP_OR):
        return [(a, n // p0, ck.T_BOOL), (b, n // p1, ck.T_BOOL)]
    if op == ck.OP_NOT:
        return [(a, n, ck.T_BOOL)]
    if op == ck.OP_INSET:
        return [(a, n, p2)]
    if op in (ck.OP_ANY, ck.OP_ALL, ck.OP_COUNT):
        return [(a, n * p0 // p1, ck.T_BOOL), (b, n * p0, ck.T_BOOL)]
    if op == ck.OP_RULE:
        return [(a, 1, ck.T_BOOL)]
    return []


def run_tape(program: ck.PolicyMatrixProgram, buf: np.ndarray):
    """Interpret ``program`` over ``buf`` the way the kernel does: one
    arena per (row, tile), slots as raw bytes at their allocated offsets,
    each read typed by the reading instruction, every destination
    disjoint from its instruction's sources."""
    batch = buf.shape[0]
    allowed = np.zeros((batch, program.out_cols), np.bool_)
    rule = np.zeros((batch, program.out_cols), np.int32)
    for row in range(batch):
        srow = buf[row]
        for t in range(program.n_tiles):
            arena = np.zeros(program.arena_bytes, np.uint8)
            col_allowed = program.col_init[t, :, 0].copy()
            col_rule = program.col_init[t, :, 1].copy()
            for pc in range(program.tile_start[t], program.tile_start[t + 1]):
                op, d, a, b, n, p0, p1, p2 = (int(x) for x in program.tape[pc])
                srcs = _sources(op, a, b, n, p0, p1, p2)
                vals = [_view(arena, *s).copy() for s in srcs]

                def write(values, type_):
                    values = np.asarray(values).astype(_NP[type_])
                    size = values.nbytes
                    assert d >= 0 and d + size <= program.arena_bytes
                    for s_off, cnt, ty in srcs:
                        s_size = cnt * (1 if ty == ck.T_BOOL else 4)
                        assert d + size <= s_off or s_off + s_size <= d, (
                            "destination overlaps a source", pc
                        )
                    arena[d : d + size] = values.view(np.uint8)

                idx = np.arange(n)
                if op == ck.OP_LOAD_BIT:
                    bits = p0 + idx
                    write((srow[bits >> 3] >> (bits & 7)) & 1, ck.T_BOOL)
                elif op == ck.OP_LOAD_U8:
                    write(srow[p0 : p0 + n] != 0, ck.T_BOOL)
                elif op == ck.OP_LOAD_U16:
                    pairs = srow[p0 : p0 + 2 * n].astype(np.int32)
                    write(pairs[0::2] | (pairs[1::2] << 8), ck.T_I32)
                elif op == ck.OP_LOAD_W32:
                    write(srow[p0 : p0 + 4 * n].copy().view(np.int32), ck.T_I32)
                elif op == ck.OP_CONST:
                    if p1 == ck.T_BOOL:
                        write([p0 != 0], ck.T_BOOL)
                    else:
                        write([p0], ck.T_I32)  # f32 constants as bits
                elif op == ck.OP_CMP:
                    (va, vb) = vals
                    ta, tb = srcs[0][2], srcs[1][2]
                    fp = ck.T_F32 in (ta, tb)
                    cast = np.float32 if fp else np.int32
                    write(
                        _cmp(p2 & 15, va[idx // p0].astype(cast),
                             vb[idx // p1].astype(cast)),
                        ck.T_BOOL,
                    )
                elif op in (ck.OP_AND, ck.OP_OR):
                    va, vb = vals
                    f = np.bitwise_and if op == ck.OP_AND else np.bitwise_or
                    write(f(va[idx // p0], vb[idx // p1]), ck.T_BOOL)
                elif op == ck.OP_NOT:
                    write(vals[0] == 0, ck.T_BOOL)
                elif op == ck.OP_INSET:
                    pool = program.pool[p0 : p0 + p1]
                    if p2 == ck.T_F32:
                        pool = pool.view(np.float32)
                    write(
                        (vals[0][:, None] == pool[None, :]).any(axis=1),
                        ck.T_BOOL,
                    )
                elif op in (ck.OP_ANY, ck.OP_ALL, ck.OP_COUNT):
                    va, vm = vals
                    j = np.arange(n * p0)
                    pv = va[j // p1].astype(bool).reshape(n, p0)
                    m = vm.astype(bool).reshape(n, p0)
                    if op == ck.OP_ANY:
                        write((pv & m).any(axis=1), ck.T_BOOL)
                    elif op == ck.OP_ALL:
                        write((pv | ~m).all(axis=1), ck.T_BOOL)
                    else:
                        write((pv & m).sum(axis=1), ck.T_I32)
                elif op == ck.OP_RULE:
                    if vals[0][0] and col_allowed[p0]:
                        col_allowed[p0] = 0
                        col_rule[p0] = p1
                else:
                    raise AssertionError(f"unknown opcode {op}")
            cols = slice(t * program.width, (t + 1) * program.width)
            allowed[row, cols] = col_allowed != 0
            rule[row, cols] = col_rule
    return allowed, rule


# ---------------------------------------------------------------------------
# fixtures: JAX and torch environments on identical bytes
# ---------------------------------------------------------------------------


def _paired(specs: dict, docs: list, predicate_opt: bool = True):
    jenv = jax_env(specs, predicate_opt=predicate_opt)
    tenv = torch_env(specs, predicate_opt=predicate_opt)
    sync_envs(jenv, tenv, docs)
    return jenv, tenv


@pytest.fixture(scope="module")
def flagship_pair():
    docs = firehose_docs(2 * BATCH, seed=5)
    jenv, tenv = _paired(flagship_specs(), docs)
    return jenv, tenv, packed_batches(jenv, docs, BATCH)


@pytest.fixture(scope="module")
def catalog_pair():
    docs = catalog_docs(2 * BATCH, seed=6)
    jenv, tenv = _paired(catalog_specs(), docs)
    return jenv, tenv, packed_batches(jenv, docs, BATCH)


def _pallas(jenv, idx: int, form: str, buf: np.ndarray):
    transport, narrow = FORM_FLAGS[form]
    run, column_of = pallas_kernels.policy_matrix_program(
        jenv.schemas[idx].packed_layout(), transport, narrow,
        jenv._compiled, use_cse=jenv.optimization is not None,
        interpret=True,
    )
    a, r = run(jnp.asarray(buf))
    return np.asarray(a), np.asarray(r), column_of


CASES = [
    ("flagship", 0, "narrow"),
    ("flagship", 1, "narrow"),
    ("flagship", 1, "transport"),
    ("catalog", 0, "transport"),
    ("catalog", 1, "wide"),
]


@pytest.mark.parametrize("which,idx,form", CASES)
def test_plain_and_tape_match_pallas(request, which, idx, form):
    """K1's plain version and its tape (numpy interpreter) against the
    Pallas kernel in interpret mode, on the same packed bytes."""
    jenv, tenv, batches = request.getfixturevalue(f"{which}_pair")
    buf = buffer_forms(jenv, idx, batches[idx])[form]
    want_a, want_r, want_cols = _pallas(jenv, idx, form, buf)
    program = tenv.program_for(idx, *FORM_FLAGS[form])
    assert program.column_of == want_cols
    got_a, got_r = ck.policy_matrix(torch.from_numpy(buf), program)
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    tape_a, tape_r = run_tape(program, buf)
    np.testing.assert_array_equal(tape_a, want_a)
    np.testing.assert_array_equal(tape_r, want_r)
    # the batch is not vacuous: some policy rejects some row
    assert not want_a[:, [want_cols[p] for p in want_cols]].all()


def test_tape_without_cse_matches_plain():
    """With the optimizer off (no CSE, unfolded conditions) the tape still
    agrees with the plain version on every form of both buckets."""
    docs = catalog_docs(BATCH, seed=7)
    jenv, tenv = _paired(catalog_specs(), docs, predicate_opt=False)
    batches = packed_batches(jenv, docs, BATCH)
    for idx, wide in batches.items():
        for form, buf in buffer_forms(jenv, idx, wide).items():
            program = tenv.program_for(idx, *FORM_FLAGS[form])
            assert not program.use_cse
            want_a, want_r = ck.policy_matrix_plain(
                torch.from_numpy(buf), program
            )
            got_a, got_r = run_tape(program, buf)
            np.testing.assert_array_equal(got_a, want_a.numpy())
            np.testing.assert_array_equal(got_r, want_r.numpy())


def test_cse_shares_subtrees_in_the_tape(flagship_pair):
    """The flagship set carries pod-privileged three times: with CSE the
    tape holds fewer instructions than without."""
    _jenv, tenv, _ = flagship_pair
    with_cse = tenv.program_for(1, True, True)
    tenv_nocse = torch_env(flagship_specs(), predicate_opt=False)
    without = tenv_nocse.program_for(1, True, True)
    assert len(with_cse.tape) < len(without.tape)


def test_arena_reuses_dead_slots(flagship_pair):
    """Slot bytes are reused after their last use: the arena is smaller
    than the sum of all slots."""
    _jenv, tenv, _ = flagship_pair
    program = tenv.program_for(1, True, True)
    lanes = ck.lane_map(program.layout, True, True)
    tape, _init = ck.compile_tape(
        program.buckets[0], tenv._sources(), lanes, tenv.table, [], True
    )
    _instrs, arena = ck.allocate_arena(tape)
    assert arena < sum(tape.slot_sizes)


def test_wrapper_checks_and_cpu_path(flagship_pair):
    _jenv, tenv, batches = flagship_pair
    program = tenv.program_for(0, True, True)
    buf = torch.zeros((4, program.buf_width), dtype=torch.uint8)
    before = ck.policy_matrix.launches
    a, r = ck.policy_matrix(buf, program)
    assert a.dtype == torch.bool and r.dtype == torch.int32
    assert a.shape == r.shape == (4, program.out_cols)
    # the CPU tensor took the plain version: no kernel launch counted
    assert ck.policy_matrix.launches == before
    with pytest.raises(ValueError):
        ck.policy_matrix(buf.to(torch.int32), program)
    with pytest.raises(ValueError):
        ck.policy_matrix(buf[:, :-4].contiguous(), program)
    with pytest.raises(ValueError):
        ck.policy_matrix(
            torch.zeros((4, 2 * program.buf_width), dtype=torch.uint8)[
                :, : program.buf_width
            ],
            program,
        )


def test_probe_plain_version():
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((8, 128)).astype(np.float32)
    )
    before = ck.probe.launches
    y = ck.probe(x)
    assert torch.equal(y, x + 1.0)
    assert ck.probe.launches == before
    with pytest.raises(ValueError):
        ck.probe(x.to(torch.float64))
