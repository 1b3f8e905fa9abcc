"""One process of the port's two-process mesh: ``python
tests/torch_mesh_drive.py OUT COORDINATOR RANK N [--device cpu|cuda]
[--frontend python|native]``.

Boots the port's server with the flagship set at ``--mesh auto
--distributed-coordinator COORDINATOR --distributed-num-processes 2
--distributed-process-id RANK`` (kernel-only: no host routing, no verdict
cache), so the two processes form one ``torch.distributed`` group over
gloo and a global ``data:2`` mesh with one position each. It then POSTs
its own N firehose reviews (uids tagged with its rank) to its own
/validate, 8 connections at a time, holds every body against the port's
host oracle, stops, and writes what it saw to OUT as JSON: the mesh, its
local data shards, the columnar gate, the mismatches, K1's dispatches and
(on the card) launches in the wave, and the wave's seconds. Before it stops,
each process runs K1 over its own N reviews and sums their allowed bits
through ``acceptance_psum`` over the global mesh (one ``all_reduce`` on the
gloo group), and reports those counts beside the host oracle's over both
processes' reviews. Imports the port only; run with the repository on
``PYTHONPATH``."""

from __future__ import annotations

import argparse
import copy
import http.client
import json
import sys
import threading
import time


def acceptance_bits(env, docs: list, device) -> tuple[list, "np.ndarray"]:
    """(policy ids, the ``(len(docs), P)`` allowed bits of K1 over
    ``docs``): each schema bucket's rows in one K1 step of the
    environment's whole program, its columns in sorted policy-id order
    (the ids every bucket's program has a column for)."""
    import numpy as np
    import torch

    from policy_server_tpu_torch.models import AdmissionReviewRequest
    from policy_server_tpu_torch.ops import cuda_kernels as ck

    by_bucket: dict = {}
    for i, d in enumerate(docs):
        payload = AdmissionReviewRequest.from_dict(d).request.to_dict()
        idx, enc = env.encode_bucketed(payload)
        by_bucket.setdefault(idx, []).append((i, enc))
    steps = []
    for idx, rows in sorted(by_bucket.items()):
        schema = env.schemas[idx]
        wide = schema.pack(schema.stack([e for _i, e in rows], len(rows)))
        buf = np.asarray(env._transport({"__packed__": wide["__packed__"]})[
            "__packed__"
        ])
        _i, _layout, transport, narrow = env._layout_for_buffer(buf.shape[1])
        program = env.program_for(idx, transport, narrow)
        allowed, _rule = ck.policy_matrix(
            torch.from_numpy(buf).to(device), program
        )
        steps.append(([i for i, _e in rows], program, allowed.cpu().numpy()))
    pids = sorted(set.intersection(*(set(p.column_of) for _r, p, _a in steps)))
    bits = np.zeros((len(docs), len(pids)), dtype=bool)
    for rows, program, allowed in steps:
        bits[rows] = allowed[:, [program.column_of[p] for p in pids]]
    return pids, bits


def oracle_bits(env, docs: list, pids: list) -> "np.ndarray":
    """The host oracle's allowed bit of each of ``pids``' programs on each
    review's payload (the bits K1 computes)."""
    import numpy as np

    from policy_server_tpu_torch.evaluation import oracle as oracle_mod
    from policy_server_tpu_torch.models import AdmissionReviewRequest

    out = np.zeros((len(docs), len(pids)), dtype=bool)
    for i, d in enumerate(docs):
        payload = AdmissionReviewRequest.from_dict(d).request.to_dict()
        for j, pid in enumerate(pids):
            out[i, j] = oracle_mod.evaluate_program(
                env._bound[pid].precompiled.program, payload
            )[0]
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("coordinator")
    ap.add_argument("rank", type=int)
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--frontend", default="python")
    args = ap.parse_args(argv)

    import torch

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
    from policy_server_tpu_torch.parallel import acceptance_psum
    from policy_server_tpu_torch.parallel import mesh as mesh_mod
    from policy_server_tpu_torch.policies.flagship import (
        flagship_policies,
        synthetic_firehose,
    )
    from policy_server_tpu_torch.server import PolicyServer

    all_docs = synthetic_firehose(2 * args.n, seed=171)
    docs = all_docs[args.rank * args.n : (args.rank + 1) * args.n]
    ids = sorted(flagship_policies())
    work = []
    for i, d in enumerate(docs):
        d = copy.deepcopy(d)
        d["request"]["uid"] = f"{d['request']['uid']}-rank{args.rank}"
        work.append((ids[i % len(ids)], json.dumps(d).encode()))
    oracle = EvaluationEnvironmentBuilder(backend="oracle").build(
        flagship_policies()
    )
    want = []
    for pid, body in work:
        req = ValidateRequest.from_admission(
            AdmissionReviewRequest.from_dict(json.loads(body)).request
        )
        want.append(json.dumps(AdmissionReviewResponse(
            evaluate(oracle, pid, req, RequestOrigin.VALIDATE)
        ).to_dict()).encode())

    server = PolicyServer(
        flagship_policies(), port=0, readiness_probe_port=0,
        device=args.device, frontend=args.frontend, mesh="auto",
        distributed_coordinator=args.coordinator,
        distributed_num_processes=2, distributed_process_id=args.rank,
        host_fastpath_threshold=0, verdict_cache_size=0, latency_budget_ms=0,
    )
    env = server.env
    report = {
        "rank": args.rank,
        "world": mesh_mod.process_count(),
        "mesh": env._mesh.shape if env._mesh is not None else None,
        "local_shards": [[str(d) for d in row] for row in env._mesh_shards],
        "columnar_ok": env._columnar_mesh_ok(),
    }
    server.start()
    got: list = [None] * len(work)
    try:
        ps0, hp0 = env.pallas_stats, env.host_profile
        if args.device != "cpu":
            torch.cuda.synchronize()
        ck.reset_launch_counts()
        t0 = time.perf_counter()

        def post(part: list) -> None:
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
            try:
                for i, (pid, body) in part:
                    conn.request("POST", f"/validate/{pid}", body=body,
                                 headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    got[i] = (resp.status, resp.read())
            finally:
                conn.close()

        indexed = list(enumerate(work))
        threads = [threading.Thread(target=post, args=(indexed[k::8],))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        report["wave_s"] = time.perf_counter() - t0
        if args.device != "cpu":
            torch.cuda.synchronize()
        report["launches"] = ck.launch_counts()["policy_matrix"]
        report["k1_dispatches"] = (
            env.pallas_stats["dispatches"] - ps0["dispatches"]
        )
        report["wire_rows"] = env.host_profile["wire_rows"] - hp0["wire_rows"]
        report["dispatched_chunks"] = (
            env.host_profile["dispatched_chunks"] - hp0["dispatched_chunks"]
        )
        # the acceptance counts of this process's rows over the global mesh
        pids, bits = acceptance_bits(env, docs, env.device)
        t1 = time.perf_counter()
        counts = acceptance_psum(env._mesh)(torch.from_numpy(bits).to(env.device))
        report["psum_s"] = time.perf_counter() - t1
        report["psum"] = counts.cpu().tolist()
        report["psum_device"] = str(counts.device)
        report["psum_policies"] = len(pids)
        report["k1_bits_are_the_oracles"] = bool(
            (bits == oracle_bits(env, docs, pids)).all()
        )
        report["oracle_counts"] = (
            oracle_bits(env, all_docs, pids).sum(axis=0).tolist()
        )
    finally:
        server.stop()
    bad = [
        i for i, g in enumerate(got) if g is None or g != (200, want[i])
    ]
    report["answered"] = sum(g is not None for g in got)
    report["mismatches"] = len(bad)
    report["first_mismatch"] = (
        None if not bad else [bad[0], repr(got[bad[0]])[:600]]
    )
    report["group_after_stop"] = mesh_mod.process_count()
    with open(args.out, "w") as f:
        json.dump(report, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
