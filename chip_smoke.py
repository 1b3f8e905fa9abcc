#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``policy_server_tpu_torch``) on
one NVIDIA card: ``python3 chip_smoke.py`` from the repository root.

Phases, each reported on its own line(s):

1. card and build — the card's name and power limit, the torch and CUDA
   versions, an nvcc build of the kernel library from ``csrc/`` (timed),
   and the ``probe`` kernel against ``x + 1`` (exact);
2. ``policy_matrix`` against its plain PyTorch version on the card — the
   32-policy flagship set, firehose batches at B = 128 and 1024 for both
   schema buckets in the narrow and transport forms; allowed and rule
   matrices must be exactly equal (tolerance 0: verdicts are booleans and
   int32 rule indices, f32 values are only compared); median kernel and
   plain times per call, from CUDA events around back-to-back calls;
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
PHASE2_BATCHES = (128, 1024)


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

    device = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # -- phase 1: card and build ------------------------------------------
    print(f"phase1 card: {card}")
    print(
        f"phase1 python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}"
    )
    lib = ck.build_library(force=True)
    ptxas = [
        line.strip() for line in lib.build_log.splitlines()
        if "registers" in line or "spill" in line or "smem" in line
    ]
    print(f"phase1 nvcc build {lib.build_seconds:.3f} s -> {lib.path.name}")
    for line in ptxas:
        print(f"phase1 ptxas: {line}")
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
        f"plain {probe_plain_ms:.6f} ms torch.add {probe_lib_ms:.6f} ms"
    )

    # -- phase 2: policy_matrix against its plain version -----------------
    env = EvaluationEnvironmentBuilder(device="cuda").build(flagship_policies())
    docs = synthetic_firehose(max(PHASE2_BATCHES), seed=7)
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
                plain_ms = time_cuda(
                    lambda: ck.policy_matrix_plain(dev, program), 2, warmup=1
                )
                nbytes = buf.nbytes + batch * program.out_cols * 5
                ops = batch * program.element_ops_per_row()
                bound_bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
                bound_ops_ms = ops / PEAK_OPS_PER_S * 1e3
                row = {
                    "bucket": idx, "batch": batch,
                    "form": "narrow" if narrow else "transport",
                    "width": int(buf.shape[1]), "ms": ms, "plain_ms": plain_ms,
                    "bytes": nbytes, "ops": ops,
                    "bound_ms": max(bound_bytes_ms, bound_ops_ms),
                    "bound_by": (
                        "bytes" if bound_bytes_ms >= bound_ops_ms
                        else "operations"
                    ),
                    "instructions": int(len(program.tape)),
                    "arena_bytes": program.arena_bytes,
                    "smem_bytes": program.smem_bytes(),
                    "max_abs_err": err,
                }
                k1_rows.append(row)
                print(f"phase2 policy_matrix exact: {json.dumps(row)}")
    print(f"phase2 policy_matrix launches so far: {ck.policy_matrix.launches}")

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
