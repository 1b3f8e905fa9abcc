#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``policy_server_tpu_torch``) on
one NVIDIA card: ``python3 chip_smoke.py`` from the repository root.

Phases, each reported on its own line(s), every line of numbers with the
card's name and power limit:

1. card and build — the card's name and power limit, the torch and CUDA
   versions, an nvcc build of the kernel library from ``csrc/`` (timed,
   with ptxas' registers and spills for both instances of the
   policy-matrix kernel: arenas in shared memory and spilled), and the
   ``probe`` kernel against ``x + 1`` (exact), timed beside ``torch.add``
   (where it is slower, with the host's cost per call of each);
2. ``policy_matrix`` against its plain PyTorch version on the card — the
   32-policy flagship set, firehose batches at B = 51, 128 and 1024 for
   both schema buckets in the narrow and transport forms, the
   every-opcode tape (``tests/torch_tape_coverage.py``, divisors as shifts
   and as divisions) at B = 51, 129 and 1029 on sparse random bytes, and
   an allow-list at the shared-memory limit (arenas spilled) at B = 51 and
   129; allowed and rule matrices must be exactly equal (tolerance 0:
   verdicts are booleans and int32 rule indices, f32 values are only
   compared); median kernel and plain times per call, from CUDA events
   around back-to-back calls, beside PR 1's kernel times; and the
   environment's device step at B = 128 split into its phases;
3. the main path over HTTP — the port's server on 127.0.0.1 with the
   flagship set on the card, at least 512 distinct firehose
   AdmissionReviews POSTed to /validate across all 32 policy ids from
   several client threads; every body must equal what the port's host
   oracle gives for the same request; every kernel's launch count, zeroed
   just before the server is built, must have advanced; requests/s and
   p50/p99 latency.

Then one JSON line of per-kernel numbers, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before the last line is printed. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import copy
import http.client
import json
import os
import random
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): HBM bandwidth and non-tensor-core
# float32 rate — the tape's element operations are 32-bit compares
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

N_REQUESTS = 1024
CLIENT_THREADS = 128
PHASE2_BATCHES = (51, 128, 1024)
COVER_BATCHES = (51, 129, 1029)
SPILL_BATCHES = (51, 129)

# policy_matrix's time per call in PR 1 (one block per row and policy
# tile; H100 80GB HBM3, 700 W), by (bucket, form, B)
PR1_MS = {
    (0, "narrow", 128): 0.1386, (0, "transport", 128): 0.1421,
    (0, "narrow", 1024): 0.2228, (0, "transport", 1024): 0.2248,
    (1, "narrow", 128): 0.3288, (1, "transport", 128): 0.3306,
    (1, "narrow", 1024): 0.4938, (1, "transport", 1024): 0.7078,
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def time_cuda(fn, iters: int, reps: int = 5, warmup: int = 3) -> float:
    """Median over ``reps`` repetitions of the milliseconds per call of
    ``fn()``, each repetition timed with CUDA events around ``iters``
    back-to-back calls on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    per_call = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call)


def graph_ms(fn, iters: int = 20) -> float:
    """Milliseconds per call of ``fn()`` with the host's launch cost taken
    out: ``iters`` calls captured in one CUDA graph, the graph's replay
    timed as ``time_cuda`` times a call."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_cuda(graph.replay, 5) / iters


def host_us(fn, n: int = 200) -> float:
    """Microseconds of host time per call of ``fn()`` over ``n`` calls
    issued back to back (the device drained before; ``n`` well under the
    launch queue's depth, so the host never waits on the device)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / n * 1e6


def step_phases(env, buf, program):
    """``env.evaluate_packed(buf)`` step by step with a CUDA event between
    phases → (its output, [h2d, policy_matrix, combine, d2h ms on the
    stream, host wall ms of the whole step])."""
    import numpy as np
    import torch

    from policy_server_tpu_torch.ops import cuda_kernels as ck

    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events[0].record()
    dev = torch.from_numpy(np.ascontiguousarray(buf)).to(env.device)
    events[1].record()
    a_mat, r_mat = ck.policy_matrix(dev, program)
    events[2].record()
    out = env._combine_outputs(a_mat, r_mat, program.column_of)
    events[3].record()
    host = out.cpu().numpy()
    events[4].record()
    events[4].synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return host, [
        events[i].elapsed_time(events[i + 1]) for i in range(4)
    ] + [wall]


def widen(doc: dict, n_containers: int = 12) -> dict:
    """A firehose review whose container array overflows the small schema
    bucket (8), so it encodes into the large bucket."""
    doc = copy.deepcopy(doc)
    pod = doc["request"]["object"]
    base = pod["spec"]["containers"]
    pod["spec"]["containers"] = [
        dict(base[i % len(base)], name=f"c{i}") for i in range(n_containers)
    ]
    return doc


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a card")
    if not os.path.isdir(os.path.join(REPO, "policy_server_tpu_torch")):
        fail("the policy_server_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import numpy as np

    from policy_server_tpu_torch.api.service import RequestOrigin, evaluate
    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.models import (
        AdmissionReviewRequest,
        AdmissionReviewResponse,
        ValidateRequest,
    )
    from policy_server_tpu_torch.ops import cuda_kernels as ck
    from policy_server_tpu_torch.policies.flagship import (
        flagship_policies,
        synthetic_firehose,
    )
    from policy_server_tpu_torch.server import PolicyServer

    import torch_tape_coverage as tape_coverage

    device = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # -- phase 1: card and build ------------------------------------------
    print(f"phase1 card: {card}")
    print(
        f"phase1 python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()} [{card}]"
    )
    lib = ck.build_library(force=True)
    ptxas = [
        line.strip() for line in lib.build_log.splitlines()
        if "registers" in line or "spill" in line or "smem" in line
        or "Compiling entry" in line
    ]
    print(
        f"phase1 nvcc build {lib.build_seconds:.3f} s -> {lib.path.name} "
        f"[{card}]"
    )
    for line in ptxas:
        print(f"phase1 ptxas: {line} [{card}]")
    x = torch.arange(8 * 128, dtype=torch.float32, device=device).reshape(8, 128)
    y = ck.probe(x)
    torch.cuda.synchronize()
    if not torch.equal(y, x + 1.0):
        fail("probe kernel disagrees with x + 1")
    probe_err = float((y - (x + 1.0)).abs().max())
    probe_ms = time_cuda(lambda: ck.probe(x), 100)
    probe_plain_ms = time_cuda(lambda: ck.probe_plain(x), 100)
    probe_lib_ms = time_cuda(lambda: torch.add(x, 1.0), 100)
    print(
        f"phase1 probe ok: max_abs_err {probe_err} kernel {probe_ms:.6f} ms "
        f"plain {probe_plain_ms:.6f} ms torch.add {probe_lib_ms:.6f} ms "
        f"[{card}]"
    )
    if probe_ms > probe_lib_ms:
        # both are host-bound: where the probe is slower, its host cost
        print(
            f"phase1 probe slower than torch.add; host us per call: probe "
            f"{host_us(lambda: ck.probe(x)):.3f} torch.add "
            f"{host_us(lambda: torch.add(x, 1.0)):.3f} [{card}]"
        )

    # -- phase 2: policy_matrix against its plain version -----------------
    env = EvaluationEnvironmentBuilder(device="cuda").build(flagship_policies())
    docs = synthetic_firehose(max(PHASE2_BATCHES), seed=7)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    k1_rows = []
    k1_err = 0
    for idx, schema in enumerate(env.schemas):
        encs = []
        for d in docs:
            d = widen(d) if idx == 1 else d
            payload = AdmissionReviewRequest.from_dict(d).request.to_dict()
            got_idx, enc = env.encode_bucketed(payload)
            if got_idx != idx:
                fail(f"firehose doc encoded into bucket {got_idx}, not {idx}")
            encs.append(enc)
        if idx == 0:
            small_encs = encs
        for batch in PHASE2_BATCHES:
            wide = schema.pack(schema.stack(encs[:batch], batch_size=batch))
            for narrow in (True, False):
                buf = schema.to_transport(
                    wide, vocab_size=len(env.table) if narrow else None
                )["__packed__"]
                program = env.program_for(idx, True, narrow)
                dev = torch.from_numpy(buf).to(device)
                want_a, want_r = ck.policy_matrix_plain(dev, program)
                got_a, got_r = ck.policy_matrix(dev, program)
                torch.cuda.synchronize()
                if not (torch.equal(got_a, want_a) and torch.equal(got_r, want_r)):
                    bad = int((got_a != want_a).sum() + (got_r != want_r).sum())
                    fail(
                        f"policy_matrix disagrees with its plain version: "
                        f"bucket {idx} B={batch} narrow={narrow}: {bad} cells"
                    )
                err = int((got_r - want_r).abs().max()) + int(
                    (got_a.to(torch.int32) - want_a.to(torch.int32)).abs().max()
                )
                k1_err = max(k1_err, err)
                if not bool((~want_a[:, list(program.column_of.values())]).any()):
                    fail("phase 2 batch is vacuous: no policy rejects any row")
                ms = time_cuda(lambda: ck.policy_matrix(dev, program), 20)
                device_ms = graph_ms(lambda: ck.policy_matrix(dev, program))
                plain_ms = time_cuda(
                    lambda: ck.policy_matrix_plain(dev, program), 2, warmup=1
                )
                form = "narrow" if narrow else "transport"
                nbytes = buf.nbytes + batch * program.out_cols * 5
                ops = batch * program.element_ops_per_row()
                bound_bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
                bound_ops_ms = ops / PEAK_OPS_PER_S * 1e3
                shape = program.launch_shape(batch, n_sm)
                row = {
                    "bucket": idx, "batch": batch, "form": form,
                    "width": int(buf.shape[1]), "ms": ms,
                    "pr1_ms": PR1_MS.get((idx, form, batch)),
                    "device_ms": device_ms,
                    "plain_ms": plain_ms,
                    "bytes": nbytes, "ops": ops,
                    "bound_ms": max(bound_bytes_ms, bound_ops_ms),
                    "bound_by": (
                        "bytes" if bound_bytes_ms >= bound_ops_ms
                        else "operations"
                    ),
                    "layout": ck.LAYOUT_NAMES[shape.layout],
                    "part_instructions": program.part_lengths,
                    "rows_per_block": shape.rows_per_block,
                    "arena_bytes": program.arena_bytes,
                    "smem_bytes": shape.smem_bytes,
                    "max_abs_err": err,
                    "card": card,
                }
                k1_rows.append(row)
                print(f"phase2 policy_matrix exact: {json.dumps(row)}")

    # the every-opcode tape on sparse random bytes, shifts and divisions
    cover_env = EvaluationEnvironmentBuilder(device="cuda").build(
        flagship_policies()
    )
    gen = torch.Generator().manual_seed(5)
    n_cover = 0
    for idx in range(len(cover_env.schemas)):
        for transport, narrow in ((True, True), (True, False), (False, False)):
            cover = tape_coverage.every_opcode_program(
                cover_env, idx, transport, narrow
            )
            for batch in COVER_BATCHES:
                shape = (batch, cover.buf_width)
                keep = torch.rand(shape, generator=gen) < 0.15
                noise = torch.randint(
                    0, 256, shape, generator=gen, dtype=torch.uint8
                )
                dev = torch.where(keep, noise, torch.zeros_like(noise)).to(device)
                want_a, want_r = ck.policy_matrix_plain(dev, cover)
                for prog in (cover, tape_coverage.with_division_divisors(cover)):
                    got_a, got_r = ck.policy_matrix(dev, prog)
                    torch.cuda.synchronize()
                    if not (torch.equal(got_a, want_a)
                            and torch.equal(got_r, want_r)):
                        bad = int((got_a != want_a).sum()
                                  + (got_r != want_r).sum())
                        fail(
                            f"every-opcode tape disagrees with its plain "
                            f"version: bucket {idx} transport={transport} "
                            f"narrow={narrow} B={batch}: {bad} cells"
                        )
                    n_cover += 1
    print(
        f"phase2 every-opcode tape exact: {n_cover} cases, opcodes "
        f"{sorted(tape_coverage.opcodes_of(cover))}, B in {COVER_BATCHES}, "
        f"0 differing cells [{card}]"
    )
    # an allow-list part at the shared-memory limit: arenas spilled
    n_list = tape_coverage.allow_list_at_limit(cover_env)
    spill, offset = tape_coverage.allow_list_program(cover_env, [n_list])
    if spill.arena_layout != ck.LAYOUT_WARPS_SPILL:
        fail("the allow-list at the limit does not spill its arenas")
    for batch in SPILL_BATCHES:
        dev = torch.from_numpy(
            tape_coverage.allow_list_rows(spill, offset, batch, seed=batch)
        ).to(device)
        want_a, want_r = ck.policy_matrix_plain(dev, spill)
        got_a, got_r = ck.policy_matrix(dev, spill)
        torch.cuda.synchronize()
        if not (torch.equal(got_a, want_a) and torch.equal(got_r, want_r)):
            fail(f"spilled-arena allow-list disagrees at B={batch}")
    print(
        f"phase2 spilled arenas exact: one part of {n_list} InSet "
        f"constants, {spill.smem_plan(spill.arena_layout, 1)[-1]} B of "
        f"shared memory, B in {SPILL_BATCHES}, 0 differing cells [{card}]"
    )
    print(
        f"phase2 policy_matrix launches so far: "
        f"{ck.policy_matrix.launches} [{card}]"
    )

    # the environment's device step at the headline shape, phase by phase
    # (stream time between CUDA events, so the host's enqueue is in it)
    schema = env.schemas[0]
    batch = 128
    wide = schema.pack(schema.stack(small_encs[:batch], batch_size=batch))
    buf = schema.to_transport(wide, vocab_size=len(env.table))["__packed__"]
    program = env.program_for(0, True, True)
    if not np.array_equal(env.evaluate_packed(buf), step_phases(env, buf, program)[0]):
        fail("the split device step disagrees with evaluate_packed")
    split = [step_phases(env, buf, program)[1] for _ in range(50)]
    names = ("h2d", "policy_matrix", "combine", "d2h", "host_wall")
    med = {n: statistics.median(s[i] for s in split) for i, n in enumerate(names)}
    print(
        "phase2 device step split, bucket 0 narrow B=128, median of 50, ms: "
        + " ".join(f"{n} {v:.5f}" for n, v in med.items())
        + f" [{card}]"
    )

    # -- phase 3: the main path over HTTP ---------------------------------
    rng = random.Random(11)
    reviews = synthetic_firehose(N_REQUESTS, seed=2024)
    reviews = [widen(d) if i % 8 == 0 else d for i, d in enumerate(reviews)]
    policy_ids = sorted(flagship_policies())
    work = [
        (policy_ids[i % len(policy_ids)], json.dumps(d).encode())
        for i, d in enumerate(reviews)
    ]
    rng.shuffle(work)
    ck.reset_launch_counts()
    server = PolicyServer(
        flagship_policies(), host="127.0.0.1", port=0, device="cuda"
    )
    server.start()
    results: list = [None] * len(work)
    latencies: list = [0.0] * len(work)
    errors: list = []

    def client(tid: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
        try:
            for i in range(tid, len(work), CLIENT_THREADS):
                pid, body = work[i]
                t0 = time.perf_counter()
                conn.request(
                    "POST", f"/validate/{pid}", body=body,
                    headers={"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                data = resp.read()
                latencies[i] = time.perf_counter() - t0
                results[i] = (resp.status, data)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"client {tid}: {type(e).__name__}: {e}")
        finally:
            conn.close()

    t0 = time.perf_counter()
    threads = [
        threading.Thread(target=client, args=(t,)) for t in range(CLIENT_THREADS)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    alive = any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    batches, batch_rows = server.batcher.batches, server.batcher.batch_rows
    server.stop()
    if alive:
        fail("HTTP clients did not finish")
    if errors:
        fail("; ".join(errors[:3]))

    oracle = EvaluationEnvironmentBuilder(backend="oracle").build(
        flagship_policies()
    )
    mismatches = 0
    for (pid, body), (status, data) in zip(work, results):
        req = ValidateRequest.from_admission(
            AdmissionReviewRequest.from_dict(json.loads(body)).request
        )
        want = json.dumps(
            AdmissionReviewResponse(
                evaluate(oracle, pid, req, RequestOrigin.VALIDATE)
            ).to_dict()
        ).encode()
        if status != 200 or data != want:
            mismatches += 1
    if mismatches:
        fail(f"{mismatches} of {len(work)} HTTP bodies differ from the oracle")
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    lat_ms = sorted(x * 1e3 for x in latencies)
    p50 = lat_ms[len(lat_ms) // 2]
    p99 = lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))]
    print(
        f"phase3 http /validate: {len(work)} requests, {len(policy_ids)} "
        f"policy ids, {CLIENT_THREADS} clients, all bodies equal to the "
        f"oracle; {len(work) / wall:.1f} req/s p50 {p50:.3f} ms p99 "
        f"{p99:.3f} ms; {batches} micro-batches, mean "
        f"{batch_rows / max(1, batches):.1f} rows; launches {counts} "
        f"[{card}]"
    )

    # -- the kernels line -------------------------------------------------
    main_row = next(
        r for r in k1_rows
        if r["bucket"] == 0 and r["batch"] == 128 and r["form"] == "narrow"
    )
    probe_bytes = 2 * x.numel() * 4
    probe_bound_bytes_ms = probe_bytes / PEAK_BYTES_PER_S * 1e3
    probe_bound_ops_ms = x.numel() / PEAK_OPS_PER_S * 1e3
    kernels = [
        {
            "name": "policy_matrix",
            "route": "cuda",
            "source": "policy_server_tpu_torch/csrc/policy_matrix.cu",
            "replaces": "policy_server_tpu/ops/pallas_kernels.py:164",
            "launches": counts["policy_matrix"],
            "max_abs_err": k1_err,
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": None,
        },
        {
            "name": "probe",
            "route": "cuda",
            "source": "policy_server_tpu_torch/csrc/policy_matrix.cu",
            "replaces": "policy_server_tpu/ops/pallas_kernels.py:83",
            "launches": counts["probe"],
            "max_abs_err": probe_err,
            "ms": probe_ms,
            "plain_ms": probe_plain_ms,
            "bound_ms": max(probe_bound_bytes_ms, probe_bound_ops_ms),
            "bound_by": (
                "bytes" if probe_bound_bytes_ms >= probe_bound_ops_ms
                else "operations"
            ),
            "library_ms": probe_lib_ms,
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": kind,
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
