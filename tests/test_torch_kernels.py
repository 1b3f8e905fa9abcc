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
from policy_server_tpu_torch.models import (
    AdmissionReviewRequest as TAdmissionReviewRequest,
)
from policy_server_tpu_torch.ops import cuda_kernels as ck

import torch_tape_coverage as tape_coverage
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


def _cmp(code: int, a, b):
    return [
        np.equal, np.not_equal, np.less, np.less_equal, np.greater,
        np.greater_equal,
    ][code](a, b)


def _sources(op, a, b, n, p0, p1, p2):
    """(byte offset, element count, type) of each slot an instruction
    reads — the counts follow from the (encoded) broadcast divisors."""
    div = ck.decode_divide
    if op == ck.OP_CMP:
        return [(a, div(n, p0), (p2 >> 4) & 3), (b, div(n, p1), (p2 >> 6) & 3)]
    if op in (ck.OP_AND, ck.OP_OR):
        return [(a, div(n, p0), ck.T_BOOL), (b, div(n, p1), ck.T_BOOL)]
    if op == ck.OP_NOT:
        return [(a, n, ck.T_BOOL)]
    if op == ck.OP_INSET:
        return [(a, n, p2)]
    if op in (ck.OP_ANY, ck.OP_ALL, ck.OP_COUNT):
        return [(a, div(n * p0, p1), ck.T_BOOL), (b, n * p0, ck.T_BOOL)]
    if op == ck.OP_RULE:
        return [(a, 1, ck.T_BOOL)]
    return []


class _Arenas:
    """The arenas of a block's rows, one contiguous ``arena_bytes`` each,
    as raw bytes: slots at their allocated offsets, each read typed by
    the reading instruction."""

    def __init__(self, nrows: int, arena_bytes: int):
        self.mem = np.zeros((nrows, arena_bytes), np.uint8)

    def _span(self, off: int, count: int, type_: int) -> slice:
        size = 1 if type_ == ck.T_BOOL else 4
        assert off >= 0 and off + size * count <= self.mem.shape[1]
        return slice(off, off + size * count)

    def read(self, off: int, count: int, type_: int) -> np.ndarray:
        """→ (rows, count) values of one slot."""
        raw = self.mem[:, self._span(off, count, type_)]
        return np.ascontiguousarray(raw).view(_NP[type_])

    def write(self, off: int, values: np.ndarray, type_: int) -> None:
        values = np.ascontiguousarray(np.asarray(values).astype(_NP[type_]))
        self.mem[:, self._span(off, values.shape[1], type_)] = values.view(
            np.uint8
        )


def run_tape(program: ck.PolicyMatrixProgram, buf: np.ndarray):
    """Interpret ``program`` over ``buf`` the way the kernel does: for each
    tape part and each block of rows, one arena per row, every destination
    disjoint from its instruction's sources, InSet constants read from the
    part's own pool, every output column written by exactly one part."""
    rows = program.max_warps
    batch = buf.shape[0]
    div = ck.decode_divide
    allowed = np.zeros((batch, program.out_cols), np.bool_)
    rule = np.zeros((batch, program.out_cols), np.int32)
    owners = np.zeros(program.out_cols, np.int32)
    for q in range(program.n_parts):
        c0, c1 = program.col_start[q], program.col_start[q + 1]
        owners[program.part_cols[c0:c1]] += 1
        part_pool = program.pool[program.pool_start[q] : program.pool_start[q + 1]]
        for row0 in range(0, batch, rows):
            srow = buf[row0 : row0 + rows]
            nrows = srow.shape[0]
            arena = _Arenas(nrows, program.arena_bytes)
            col_allowed = np.repeat(program.col_init[c0:c1, 0:1], nrows, 1)
            col_rule = np.repeat(program.col_init[c0:c1, 1:2], nrows, 1)
            for pc in range(program.part_start[q], program.part_start[q + 1]):
                op, d, a, b, n, p0, p1, p2 = (int(x) for x in program.tape[pc])
                srcs = _sources(op, a, b, n, p0, p1, p2)
                vals = [arena.read(*s) for s in srcs]

                def write(values, type_):
                    values = np.asarray(values).reshape(nrows, -1)
                    size = values.shape[1] * (1 if type_ == ck.T_BOOL else 4)
                    for s_off, cnt, ty in srcs:
                        s_size = cnt * (1 if ty == ck.T_BOOL else 4)
                        assert d + size <= s_off or s_off + s_size <= d, (
                            "destination overlaps a source", pc
                        )
                    arena.write(d, values, type_)

                idx = np.arange(n)
                if op == ck.OP_LOAD_BIT:
                    bits = p0 + idx
                    write((srow[:, bits >> 3] >> (bits & 7)) & 1, ck.T_BOOL)
                elif op == ck.OP_LOAD_U8:
                    write(srow[:, p0 : p0 + n] != 0, ck.T_BOOL)
                elif op == ck.OP_LOAD_U16:
                    pairs = srow[:, p0 : p0 + 2 * n].astype(np.int32)
                    write(pairs[:, 0::2] | (pairs[:, 1::2] << 8), ck.T_I32)
                elif op == ck.OP_LOAD_W32:
                    words = np.ascontiguousarray(srow[:, p0 : p0 + 4 * n])
                    write(words.view(np.int32), ck.T_I32)
                elif op == ck.OP_CONST:
                    v = p0 != 0 if p1 == ck.T_BOOL else p0  # f32 as bits
                    write(
                        np.full((nrows, 1), v),
                        ck.T_BOOL if p1 == ck.T_BOOL else ck.T_I32,
                    )
                elif op == ck.OP_CMP:
                    va, vb = vals
                    ta, tb = srcs[0][2], srcs[1][2]
                    cast = np.float32 if ck.T_F32 in (ta, tb) else np.int32
                    write(
                        _cmp(p2 & 15, va[:, div(idx, p0)].astype(cast),
                             vb[:, div(idx, p1)].astype(cast)),
                        ck.T_BOOL,
                    )
                elif op in (ck.OP_AND, ck.OP_OR):
                    va, vb = vals
                    f = np.bitwise_and if op == ck.OP_AND else np.bitwise_or
                    write(f(va[:, div(idx, p0)], vb[:, div(idx, p1)]), ck.T_BOOL)
                elif op == ck.OP_NOT:
                    write(vals[0] == 0, ck.T_BOOL)
                elif op == ck.OP_INSET:
                    assert 0 <= p0 and p0 + p1 <= len(part_pool)
                    pool = part_pool[p0 : p0 + p1]
                    if p2 == ck.T_F32:
                        pool = pool.view(np.float32)
                    write(
                        (vals[0][:, :, None] == pool[None, None, :]).any(axis=2),
                        ck.T_BOOL,
                    )
                elif op in (ck.OP_ANY, ck.OP_ALL, ck.OP_COUNT):
                    va, vm = vals
                    j = np.arange(n * p0)
                    pv = va[:, div(j, p1)].astype(bool).reshape(nrows, n, p0)
                    m = vm.astype(bool).reshape(nrows, n, p0)
                    if op == ck.OP_ANY:
                        write((pv & m).any(axis=2), ck.T_BOOL)
                    elif op == ck.OP_ALL:
                        write((pv | ~m).all(axis=2), ck.T_BOOL)
                    else:
                        write((pv & m).sum(axis=2), ck.T_I32)
                elif op == ck.OP_RULE:
                    hit = (vals[0][:, 0] != 0) & (col_allowed[p0] != 0)
                    col_allowed[p0, hit] = 0
                    col_rule[p0, hit] = p1
                else:
                    raise AssertionError(f"unknown opcode {op}")
            out_rows = slice(row0, row0 + nrows)
            for k in range(c1 - c0):
                col = program.part_cols[c0 + k]
                allowed[out_rows, col] = col_allowed[k] != 0
                rule[out_rows, col] = col_rule[k]
    assert (owners == 1).all(), "an output column is not written exactly once"
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


@pytest.fixture(scope="module")
def flagship_torch():
    """A torch-only flagship environment with encoded batches of 37 rows
    (ragged against the kernel's row blocks) for each schema bucket."""
    docs = firehose_docs(2 * 37, seed=9)
    tenv = torch_env(flagship_specs())
    per: dict[int, list] = {0: [], 1: []}
    for d in docs:
        idx, enc = tenv.encode_bucketed(
            TAdmissionReviewRequest.from_dict(d).request.to_dict()
        )
        per[idx].append(enc)
    wide = {
        idx: tenv.schemas[idx].pack(
            tenv.schemas[idx].stack(encs[:37], batch_size=37)
        )
        for idx, encs in per.items()
    }
    return tenv, wide


def _torch_form(tenv, idx: int, wide: dict, form: str) -> np.ndarray:
    transport, narrow = FORM_FLAGS[form]
    if not transport:
        return wide["__packed__"]
    return tenv.schemas[idx].to_transport(
        wide, vocab_size=len(tenv.table) if narrow else None
    )["__packed__"]


@pytest.mark.parametrize("data", ["firehose", "random"])
@pytest.mark.parametrize("idx,form", [
    (0, "narrow"), (0, "transport"), (0, "wide"),
    (1, "narrow"), (1, "transport"), (1, "wide"),
])
def test_every_opcode_tape_matches_plain(flagship_torch, idx, form, data):
    """A hand-built tape that emits every opcode (OP_ALL, OP_COUNT, f32
    compares, InSet over bool/i32/f32, ...) against the plain version on
    the same bytes, with its divisors encoded as shifts and as
    divisions."""
    tenv, wide = flagship_torch
    program = tape_coverage.every_opcode_program(
        tenv, idx, *FORM_FLAGS[form]
    )
    want_ops = set(range(ck.OP_RULE + 1)) - {
        ck.OP_LOAD_U8 if form != "wide" else ck.OP_LOAD_BIT,
        ck.OP_LOAD_U16 if form != "narrow" else -1,
    }
    assert tape_coverage.opcodes_of(program) == want_ops
    if data == "firehose":
        buf = _torch_form(tenv, idx, wide[idx], form)
    else:
        rng = np.random.default_rng(100 + idx)
        shape = (45, program.buf_width)
        buf = np.where(
            rng.random(shape) < 0.15, rng.integers(0, 256, shape), 0
        ).astype(np.uint8)
    want_a, want_r = (
        t.numpy() for t in ck.policy_matrix_plain(torch.from_numpy(buf), program)
    )
    division = tape_coverage.with_division_divisors(program)
    assert (division.tape != program.tape).any()
    for prog in (program, division):
        got_a, got_r = run_tape(prog, buf)
        np.testing.assert_array_equal(got_a, want_a)
        np.testing.assert_array_equal(got_r, want_r)
    # not vacuous: rows differ in their verdicts
    assert len({tuple(r) for r in want_r}) > 1


def test_layouts_fit_and_parts_balance(flagship_torch):
    """Both flagship buckets keep their arenas in shared memory (a warp per
    row); every launch shape fits a block's shared memory; the tape parts
    are balanced (the longest holds fewer than the 280 instructions of the
    first 32-policy tile, and no more than the longest policy alone or
    1.25 times the mean)."""
    tenv, _ = flagship_torch
    for idx in (0, 1):
        for transport, narrow in ((True, True), (True, False)):
            program = tenv.program_for(idx, transport, narrow)
            assert program.arena_layout == ck.LAYOUT_WARPS
            lengths = program.part_lengths
            assert program.n_parts == ck.TAPE_PARTS
            assert max(lengths) < 280
            lanes = ck.lane_map(program.layout, transport, narrow)
            alone = []
            for pid, src in tenv._sources().items():
                if src.constant is None:
                    comp = ck._TapeCompiler(lanes, tenv.table, [], True)
                    comp.policy(0, src)
                    alone.append(len(comp.tape.instrs))
            assert max(lengths) <= max(
                max(alone), 1.25 * sum(lengths) / len(lengths)
            )
            for batch in (1, 51, 128, 1024, 4096):
                for n_sm in (1, 132):
                    shape = program.launch_shape(batch, n_sm)
                    assert shape.layout == program.arena_layout
                    assert shape.smem_bytes <= ck.MAX_SMEM_BYTES
                    assert shape.off_cols == 16 * max(program.part_int4s)
                    assert (
                        shape.off_cols <= shape.off_arena
                        <= shape.smem_bytes
                    )
                    assert shape.off_cols % 16 == shape.off_arena % 16 == 0
                    assert 1 <= shape.rows_per_block <= program.max_warps
                    assert shape.smem_bytes == (
                        shape.off_arena
                        + shape.rows_per_block * program.arena_bytes
                    )
            # every output column is owned by exactly one part
            assert sorted(program.part_cols.tolist()) == list(
                range(program.out_cols)
            )


def test_device_code_packs_every_part(flagship_torch):
    """The kernel's staged code holds, for each part, its instructions,
    its column records and only the InSet constants its own instructions
    use, where the part table says."""
    tenv, _ = flagship_torch
    for program in (
        tenv.program_for(0, True, True),
        tape_coverage.every_opcode_program(tenv, 0, True, True),
    ):
        code, meta = program.device_code()
        words = code.reshape(-1, 4)
        offset = 0
        for q, (start, n_instr, ncols, n_pool) in enumerate(meta):
            assert start == offset
            i0 = program.part_start[q]
            c0 = program.col_start[q]
            assert n_instr == program.part_lengths[q]
            np.testing.assert_array_equal(
                words[start : start + 2 * n_instr].reshape(-1, ck.INSTR_WORDS),
                program.tape[i0 : i0 + n_instr],
            )
            records = words[start + 2 * n_instr : start + 2 * n_instr + ncols]
            np.testing.assert_array_equal(
                records[:, 0], program.part_cols[c0 : c0 + ncols]
            )
            np.testing.assert_array_equal(
                records[:, 1:3], program.col_init[c0 : c0 + ncols]
            )
            part_pool = program.pool[
                program.pool_start[q] : program.pool_start[q + 1]
            ]
            pool_at = start + 2 * n_instr + ncols
            assert n_pool == -(-len(part_pool) // 4)
            np.testing.assert_array_equal(
                code[4 * pool_at : 4 * pool_at + len(part_pool)], part_pool
            )
            tape = program.tape[i0 : i0 + n_instr]
            insets = tape[tape[:, 0] == ck.OP_INSET]
            assert len(part_pool) == int(insets[:, 6].sum())
            offset = start + program.part_int4s[q]
        assert offset == len(words)
        assert program.pool_start[-1] == len(program.pool)
    # the every-opcode set's InSet constants all sit in one policy's part
    assert sum(n > 0 for n in program.part_pool_int4s) == 1


def test_inset_pool_limit_is_per_part(flagship_torch):
    """A part stages only its own InSet constants, so the shared-memory
    limit (232,448 B) holds per part: a part exactly at it builds (arena
    spilled) and agrees with the plain version, four constants more
    refuse to build with the limit in the message, and two parts whose
    pools together exceed the limit build."""
    tenv, _ = flagship_torch
    at_limit = tape_coverage.allow_list_at_limit(tenv)
    program, offset = tape_coverage.allow_list_program(tenv, [at_limit])
    assert program.smem_plan(ck.LAYOUT_WARPS_SPILL, 1)[-1] == ck.MAX_SMEM_BYTES
    assert program.arena_layout == ck.LAYOUT_WARPS_SPILL
    shape = program.launch_shape(51, 132)
    assert shape.smem_bytes <= ck.MAX_SMEM_BYTES
    buf = tape_coverage.allow_list_rows(program, offset, 51, seed=12)
    want_a, want_r = (
        t.numpy() for t in ck.policy_matrix_plain(torch.from_numpy(buf), program)
    )
    got_a, got_r = run_tape(program, buf)
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_array_equal(got_r, want_r)
    assert len(set(want_a[:, 0].tolist())) == 2  # some rows hit the set
    with pytest.raises(ValueError, match="232,448 B"):
        tape_coverage.allow_list_program(tenv, [at_limit + 4])
    two, _ = tape_coverage.allow_list_program(tenv, [at_limit // 2 + 1000] * 2)
    assert two.n_parts == 2
    assert 16 * sum(two.part_pool_int4s) > ck.MAX_SMEM_BYTES
    assert all(16 * n < ck.MAX_SMEM_BYTES for n in two.part_pool_int4s)
    assert (two.tape[two.tape[:, 0] == ck.OP_INSET][:, 5] == 0).all()


def test_parts_split_the_tape(flagship_torch):
    """More parts give shorter parts; the total grows only by what CSE no
    longer shares across parts, and verdicts do not change."""
    tenv, wide = flagship_torch
    base = tenv.program_for(0, True, True)
    buf = _torch_form(tenv, 0, wide[0], "narrow")
    want_a, want_r = run_tape(base, buf)
    longest = None
    for n_parts in (1, 2, 8):
        program = ck.build_policy_matrix(
            base.layout, True, True, base.compiled, tenv._sources(),
            tenv.table, use_cse=True, n_parts=n_parts,
        )
        assert program.n_parts == n_parts
        if longest is not None:
            assert program.max_part_instrs < longest
        longest = program.max_part_instrs
        got_a, got_r = run_tape(program, buf)
        np.testing.assert_array_equal(got_a, want_a)
        np.testing.assert_array_equal(got_r, want_r)


def test_divisor_encoding():
    """Powers of two become shifts, other divisors negated divisions; the
    decoded division equals integer division for both."""
    assert [ck.encode_divisor(d) for d in (1, 2, 8, 64)] == [0, 1, 3, 6]
    assert [ck.encode_divisor(d) for d in (3, 6, 12)] == [-3, -6, -12]
    x = np.arange(200)
    for d in (1, 2, 3, 4, 6, 8, 12, 32, 64):
        np.testing.assert_array_equal(
            ck.decode_divide(x, ck.encode_divisor(d)), x // d
        )
    with pytest.raises(ValueError):
        ck.encode_divisor(0)


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
