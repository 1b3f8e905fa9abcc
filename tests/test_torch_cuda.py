"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports nothing of JAX, so it runs on a machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``.
Without a card every test here skips. Tolerance: exact equality (verdicts
are booleans and int32 rule indices; f32 values are only compared)."""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import threading

import pytest
import torch

from policy_server_tpu_torch.api import profiling
from policy_server_tpu_torch.evaluation.environment import (
    EvaluationEnvironmentBuilder,
)
from policy_server_tpu_torch.models import AdmissionReviewRequest, ValidateRequest
from policy_server_tpu_torch.ops import cuda_kernels as ck
from policy_server_tpu_torch.policies.flagship import (
    flagship_policies,
    synthetic_firehose,
)
from policy_server_tpu_torch.telemetry import flightrec

import torch_tape_coverage as tape_coverage


@pytest.fixture(scope="module")
def card_env():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return EvaluationEnvironmentBuilder(device="cuda").build(flagship_policies())


def _batch(env, idx: int, n: int, narrow: bool):
    schema = env.schemas[idx]
    encs = []
    for doc in synthetic_firehose(n, seed=31 + idx):
        if idx == 1:
            doc = copy.deepcopy(doc)
            pod = doc["request"]["object"]["spec"]
            pod["containers"] = [
                dict(pod["containers"][i % len(pod["containers"])], name=f"c{i}")
                for i in range(12)
            ]
        payload = AdmissionReviewRequest.from_dict(doc).request.to_dict()
        got, enc = env.encode_bucketed(payload)
        assert got == idx
        encs.append(enc)
    wide = schema.pack(schema.stack(encs, batch_size=n))
    return schema.to_transport(
        wide, vocab_size=len(env.table) if narrow else None
    )["__packed__"]


@pytest.mark.cuda
@pytest.mark.parametrize("idx", [0, 1])
@pytest.mark.parametrize("narrow", [True, False])
def test_policy_matrix_matches_plain(card_env, idx, narrow):
    buf = torch.from_numpy(_batch(card_env, idx, 64, narrow)).cuda()
    program = card_env.program_for(idx, True, narrow)
    want_a, want_r = ck.policy_matrix_plain(buf, program)
    before = ck.policy_matrix.launches
    got_a, got_r = ck.policy_matrix(buf, program)
    torch.cuda.synchronize()
    assert ck.policy_matrix.launches == before + 1
    assert torch.equal(got_a, want_a)
    assert torch.equal(got_r, want_r)


@pytest.fixture(scope="module")
def cover_env(card_env):
    """A second flagship environment for the every-opcode tapes, which
    intern their own string constants."""
    return EvaluationEnvironmentBuilder(device="cuda").build(flagship_policies())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 51, 129, 1029])
@pytest.mark.parametrize("idx", [0, 1])
@pytest.mark.parametrize("narrow", [True, False])
def test_policy_matrix_ragged_batches(card_env, idx, narrow, batch):
    """Batches that fill no row block (1-16 rows) exactly against the
    plain version."""
    buf = torch.from_numpy(_batch(card_env, idx, batch, narrow)).cuda()
    program = card_env.program_for(idx, True, narrow)
    assert program.arena_layout == ck.LAYOUT_WARPS
    want_a, want_r = ck.policy_matrix_plain(buf, program)
    got_a, got_r = ck.policy_matrix(buf, program)
    torch.cuda.synchronize()
    assert torch.equal(got_a, want_a)
    assert torch.equal(got_r, want_r)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 51, 129, 1029])
@pytest.mark.parametrize("idx", [0, 1])
@pytest.mark.parametrize("form", [(True, True), (True, False), (False, False)])
def test_every_opcode_tape_matches_plain(cover_env, idx, form, batch):
    """The every-opcode tape (and its division-encoded twin) on sparse
    random bytes against the plain version."""
    program = tape_coverage.every_opcode_program(cover_env, idx, *form)
    gen = torch.Generator().manual_seed(batch * 10 + idx)
    shape = (batch, program.buf_width)
    keep = torch.rand(shape, generator=gen) < 0.15
    noise = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
    buf = torch.where(keep, noise, torch.zeros_like(noise)).cuda()
    want_a, want_r = ck.policy_matrix_plain(buf, program)
    for prog in (program, tape_coverage.with_division_divisors(program)):
        got_a, got_r = ck.policy_matrix(buf, prog)
        torch.cuda.synchronize()
        assert torch.equal(got_a, want_a)
        assert torch.equal(got_r, want_r)


@pytest.mark.cuda
def test_probe_matches_plain(card_env):
    x = torch.randn(8, 128, device="cuda")
    assert torch.equal(ck.probe(x), ck.probe_plain(x))


@pytest.mark.cuda
def test_run_batch_matches_plain_env(card_env):
    """The environment's device step (transport, one copy, the kernel, the
    combine) against the same batch on the CPU through the plain path."""
    cpu_env = EvaluationEnvironmentBuilder(device="cpu").build(
        flagship_policies()
    )
    bufs = [_batch(card_env, idx, 32, True) for idx in (0, 1)]
    cpu_env.install_reference_state(
        list(card_env.table.strings()),
        [dataclasses.asdict(s.packed_layout()) for s in card_env.schemas],
    )
    for buf in bufs:
        assert (card_env.evaluate_packed(buf) == cpu_env.evaluate_packed(buf)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 51, 129])
def test_spilled_arena_matches_plain(cover_env, batch):
    """An allow-list whose part takes nearly all of shared memory runs with
    its arenas in the device scratch buffer, and agrees with the plain
    version."""
    program, offset = tape_coverage.allow_list_program(
        cover_env, [tape_coverage.allow_list_at_limit(cover_env)]
    )
    assert program.arena_layout == ck.LAYOUT_WARPS_SPILL
    buf = torch.from_numpy(
        tape_coverage.allow_list_rows(program, offset, batch, seed=batch)
    ).cuda()
    want_a, want_r = ck.policy_matrix_plain(buf, program)
    got_a, got_r = ck.policy_matrix(buf, program)
    torch.cuda.synchronize()
    assert torch.equal(got_a, want_a)
    assert torch.equal(got_r, want_r)


def _sync_step(env, buf):
    """The device step without the split: a pageable copy in, the kernel,
    the combine, a synchronous copy out."""
    idx, _lo, transport, narrow = env._layout_for_buffer(buf.shape[1])
    program = env.program_for(idx, transport, narrow)
    a_mat, r_mat = ck.policy_matrix(torch.from_numpy(buf).cuda(), program)
    return env._combine_outputs(a_mat, r_mat, program.column_of).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("idx", [0, 1])
@pytest.mark.parametrize("batch", [1, 51, 128])
def test_enqueue_fetch_matches_the_synchronous_step(card_env, idx, batch):
    """The page-locked enqueue and its fetch return what the synchronous
    step returns, and evaluate_packed is the two back to back."""
    buf = _batch(card_env, idx, batch, True)
    want = _sync_step(card_env, buf)
    step = card_env.enqueue_packed(buf)
    assert step.host_in.is_pinned() and step.host_out.is_pinned()
    assert (step.wait() == want).all()
    assert (card_env.evaluate_packed(buf) == want).all()


@pytest.mark.cuda
def test_inflight_steps_never_share_buffers(card_env):
    """Steps in flight together hold distinct page-locked buffers, and two
    pipeline threads enqueuing and fetching the same shape over and over
    each read their own verdicts."""
    base = _batch(card_env, 0, 64, True)
    bufs = [base, base[::-1].copy()]
    wants = [_sync_step(card_env, b) for b in bufs]
    assert not (wants[0] == wants[1]).all()
    steps = [card_env.enqueue_packed(b) for b in bufs]
    assert steps[0].host_out.data_ptr() != steps[1].host_out.data_ptr()
    assert steps[0].host_in.data_ptr() != steps[1].host_in.data_ptr()
    for step, want in zip(steps, wants):
        assert (step.wait() == want).all()
    bad: list = []

    def worker(k: int) -> None:
        for _ in range(100):
            if not (card_env.evaluate_packed(bufs[k]) == wants[k]).all():
                bad.append(k)

    threads = [threading.Thread(target=worker, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not bad


@pytest.mark.cuda
def test_concurrent_first_launches_share_one_device_code(card_env):
    """Pipeline threads launching a program for the first time at once
    build ONE copy of its device code and one launch struct per batch
    size; every launch then agrees with the plain version."""
    fresh = dataclasses.replace(card_env.program_for(0, True, True))
    buf = torch.from_numpy(_batch(card_env, 0, 51, True)).cuda()
    want_a, want_r = ck.policy_matrix_plain(buf, fresh)
    gate = threading.Barrier(8)
    got: list = []

    def worker() -> None:
        gate.wait()
        got.append((fresh.launch_args(0, 51), ck.policy_matrix(buf, fresh)))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert len(got) == 8 and len({args for args, _out in got}) == 1
    assert list(fresh._device_code) == [0]
    for _args, (a_mat, r_mat) in got:
        assert torch.equal(a_mat, want_a) and torch.equal(r_mat, want_r)


@pytest.mark.cuda
def test_device_execute_stamps_the_cuda_event_wait():
    """On the card the recorder's device_execute is the fetch's wait on
    the step's CUDA event: one per dispatched chunk, under the batch's
    id, its rows the chunk's dispatched rows, nested in the fetch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    env = EvaluationEnvironmentBuilder(
        device="cuda", verdict_cache_size=0
    ).build(flagship_policies())
    ids = sorted(flagship_policies())
    pairs = [
        (ids[i % len(ids)], ValidateRequest.from_admission(
            AdmissionReviewRequest.from_dict(d).request
        ))
        for i, d in enumerate(synthetic_firehose(48, seed=41))
    ]
    rec = flightrec.install(flightrec.FlightRecorder(capacity=1024))
    try:
        with flightrec.batch_scope(7):
            handle = env.validate_batch_begin(pairs)
            got = env.validate_batch_finish(handle)
    finally:
        flightrec.install(None)
    assert [r.to_dict() for r in got] == [
        r.to_dict() for r in env.validate_batch(pairs, prefer_host=True)
    ]
    events = [e for e in rec.snapshot() if e["batch"] == 7]
    execs = [e for e in events if e["phase"] == flightrec.PH_DEVICE_EXECUTE]
    fetches = [e for e in events if e["phase"] == flightrec.PH_FETCH]
    assert len(execs) == len(fetches) == env.host_profile["dispatched_chunks"]
    assert sum(e["rows"] for e in execs) == env.host_profile["dispatched_rows"]
    for ex, fe in zip(execs, fetches):
        assert fe["start_ns"] <= ex["start_ns"] <= ex["end_ns"] <= fe["end_ns"]
    assert {flightrec.PH_PREPARE, flightrec.PH_ENCODE,
            flightrec.PH_MATERIALIZE} <= {e["phase"] for e in events}


@pytest.mark.cuda
def test_heap_profile_reports_the_card(card_env):
    """/debug/pprof/heap's document lists the card with its allocator
    statistics and its free and total memory."""
    doc = json.loads(profiling.heap_profile())
    assert set(doc) == {"devices", "host_top_allocations"}
    dev = doc["devices"][0]
    assert (dev["id"], dev["platform"]) == (0, "gpu")
    stats = dev["memory_stats"]
    assert stats["allocated_bytes.all.current"] > 0
    assert 0 < stats["free_bytes"] <= stats["total_bytes"]


@pytest.mark.cuda
def test_device_trace_records_the_kernels(card_env, tmp_path):
    """start_device_trace traces the card: the Chrome trace it writes holds
    the policy_matrix launches made inside it."""
    buf = torch.from_numpy(_batch(card_env, 0, 51, True)).cuda()
    program = card_env.program_for(0, True, True)
    profiling.start_device_trace(str(tmp_path))
    for _ in range(3):
        ck.policy_matrix(buf, program)
    path = profiling.stop_device_trace()
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        names = [
            e["name"] for e in json.load(f)["traceEvents"]
            if e.get("cat") == "kernel"
        ]
    assert sum("policy_matrix" in n for n in names) >= 3


@pytest.mark.cuda
def test_closed_environments_return_device_memory_to_a_plateau():
    """Three environments in turn, each built (probe on its own stream),
    warmed, serving through a batcher and closed: each close drops its
    kernel programs' device code, and ``torch.cuda.memory_allocated`` comes
    back to the same level after the second and the third; a dispatch
    after close raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from policy_server_tpu_torch.runtime.batcher import MicroBatcher

    ids = sorted(flagship_policies())
    pairs = [
        (ids[i % len(ids)], ValidateRequest.from_admission(
            AdmissionReviewRequest.from_dict(d).request
        ))
        for i, d in enumerate(synthetic_firehose(96, seed=43))
    ]
    want = None
    after = []
    for _ in range(3):
        env = EvaluationEnvironmentBuilder(
            device="cuda", verdict_cache_size=0
        ).build(flagship_policies())
        batcher = MicroBatcher(
            env, host_fastpath_threshold=0, latency_budget_ms=0
        ).start()
        batcher.warmup()
        got = [
            f.result(timeout=60).to_dict() for f in batcher.submit_many(pairs)
        ]
        batcher.shutdown()
        want = want or got
        assert got == want
        programs = list(env._programs.values())
        assert any(p._device_code for p in programs)
        assert env.close() is True
        assert not any(p._device_code or p._launches for p in programs)
        with pytest.raises(RuntimeError, match="environment closed"):
            env.validate_batch(pairs[:1])
        del env, batcher, programs
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated())
    assert after[2] <= after[1], after


@pytest.fixture(scope="module")
def wasm_group_env(tmp_path_factory):
    """The flagship set plus a group with a waPC wasm member
    (``wasmpriv() && ns()``) and a standalone wasm policy, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import torch_wasm_fixtures as fixtures

    from policy_server_tpu_torch.fetch import load_artifact
    from policy_server_tpu_torch.models.policy import parse_policies
    from policy_server_tpu_torch.policies import resolve_builtin
    from policy_server_tpu_torch.policies.flagship import flagship_policy_specs

    path = tmp_path_factory.mktemp("wasm") / "priv.wasm"
    path.write_bytes(fixtures.wapc_privileged_wasm())
    module = load_artifact(path)
    specs = flagship_policy_specs()
    specs["guard"] = {
        "expression": "wasmpriv() && ns()",
        "message": "guard",
        "policies": {
            "wasmpriv": {"module": "file:///priv.wasm"},
            "ns": {"module": "builtin://namespace-validate",
                   "settings": {"denied_namespaces": ["kube-system"]}},
        },
    }
    specs["wasm-priv"] = {"module": "file:///priv.wasm"}
    return EvaluationEnvironmentBuilder(
        device="cuda",
        module_resolver=lambda url: module if url.endswith(".wasm") else resolve_builtin(url),
    ).build(parse_policies(specs))


@pytest.mark.cuda
@pytest.mark.parametrize("idx", [0, 1])
@pytest.mark.parametrize("batch", [1, 51, 128])
def test_wasm_bits_ride_with_the_rows(wasm_group_env, idx, batch):
    """The wasm members' bits go to the card in the rows' page-locked
    copy, and the combine reads them there: the enqueue equals the
    synchronous step given the same bits on the card, and a bit flips the
    group's verdict."""
    import numpy as np

    env = wasm_group_env
    assert len(env._wasm_member_order) == 1
    buf = _batch(env, idx, batch, True)
    bits = (np.arange(batch) % 2 == 0).reshape(batch, 1)
    idx_, _lo, transport, narrow = env._layout_for_buffer(buf.shape[1])
    program = env.program_for(idx_, transport, narrow)
    a_mat, r_mat = ck.policy_matrix(torch.from_numpy(buf).cuda(), program)
    want = env._combine_outputs(
        a_mat, r_mat, program.column_of, torch.from_numpy(bits).cuda()
    ).cpu().numpy()
    step = env.enqueue_packed(buf, bits)
    assert step.host_in.is_pinned()
    assert step.host_in.numel() == buf.size + bits.size
    got = step.wait()
    assert (got == want).all()
    out = env._unpack(got)
    pid = env._wasm_member_order[0]
    assert (out[f"p:{pid}:allowed"] == bits[:, 0]).all()
    assert (out[f"p:{pid}:rule"] == 0).all()
    ns_ok = out["p:guard/ns:allowed"]
    assert (out["g:guard:allowed"] == (bits[:, 0] & ns_ok)).all()
    assert out["g:guard:eval:wasmpriv"].all()
    assert (out["g:guard:eval:ns"] == bits[:, 0]).all()
    flipped = env._unpack(env.enqueue_packed(buf, ~bits).wait())
    assert (flipped["g:guard:allowed"] == (~bits[:, 0] & ns_ok)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n_namespaces", [200, 256])
@pytest.mark.parametrize("idx", [0, 1])
def test_policy_matrix_on_context_rows(n_namespaces, idx):
    """Rows carrying a ``__context__`` slice of up to 256 namespaces (the
    context axis cap) through K1 on the card, namespace-exists beside the
    flagship set: equal to the plain version, and a quarter of the rows,
    in a namespace outside the cluster, rejected by namespace-exists."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from policy_server_tpu_torch.context import (
        ContextSnapshotService,
        StaticContextFetcher,
    )
    from policy_server_tpu_torch.evaluation.policy_id import PolicyID
    from policy_server_tpu_torch.models.policy import (
        ContextAwareResource,
        parse_policy_entry,
    )

    names = [f"ns-{i}" for i in range(n_namespaces)]
    service = ContextSnapshotService(
        StaticContextFetcher({"v1/Namespace": [
            {"metadata": {"name": n, "uid": f"u-{n}"}} for n in names
        ]}),
        wanted=[ContextAwareResource("v1", "Namespace")],
    )
    service.refresh()
    policies = dict(flagship_policies())
    policies["namespace-exists"] = parse_policy_entry("namespace-exists", {
        "module": "builtin://namespace-exists",
        "contextAwareResources": [{"apiVersion": "v1", "kind": "Namespace"}],
    })
    env = EvaluationEnvironmentBuilder(
        device="cuda", context_service=service
    ).build(policies)
    target = env._lookup_top_level(PolicyID.parse("namespace-exists"))
    encs, ghosts = [], 0
    for i, doc in enumerate(synthetic_firehose(400, seed=61)):
        doc = copy.deepcopy(doc)
        if idx == 1:
            pod = doc["request"]["object"]["spec"]
            pod["containers"] = [
                dict(pod["containers"][k % len(pod["containers"])], name=f"c{k}")
                for k in range(12)
            ]
        doc["request"]["namespace"] = names[i % n_namespaces] if i % 4 else "ghost"
        req = ValidateRequest.from_admission(
            AdmissionReviewRequest.from_dict(doc).request
        )
        got, enc = env.encode_bucketed(env.payload_for(target, req))
        if got == idx:
            encs.append(enc)
            ghosts += i % 4 == 0
        if len(encs) == 128:
            break
    assert len(encs) == 128
    schema = env.schemas[idx]
    wide = schema.pack(schema.stack(encs, batch_size=128))
    buf = torch.from_numpy(
        schema.to_transport(wide, vocab_size=len(env.table))["__packed__"]
    ).cuda()
    program = env.program_for(idx, True, True)
    want_a, want_r = ck.policy_matrix_plain(buf, program)
    before = ck.policy_matrix.launches
    got_a, got_r = ck.policy_matrix(buf, program)
    torch.cuda.synchronize()
    assert ck.policy_matrix.launches == before + 1
    assert torch.equal(got_a, want_a) and torch.equal(got_r, want_r)
    col = program.column_of["namespace-exists"]
    assert int((~got_a[:, col]).sum()) == ghosts > 0
    env.close()
