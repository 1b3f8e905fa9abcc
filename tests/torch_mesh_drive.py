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
(on the card) launches in the wave, and the wave's seconds. Imports the
port only; run with the repository on ``PYTHONPATH``."""

from __future__ import annotations

import argparse
import copy
import http.client
import json
import sys
import threading
import time


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
    from policy_server_tpu_torch.parallel import mesh as mesh_mod
    from policy_server_tpu_torch.policies.flagship import (
        flagship_policies,
        synthetic_firehose,
    )
    from policy_server_tpu_torch.server import PolicyServer

    docs = synthetic_firehose(2 * args.n, seed=171)[
        args.rank * args.n : (args.rank + 1) * args.n
    ]
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
