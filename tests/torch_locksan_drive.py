"""Serve the PyTorch port under its lock-order sanitizer and report.

Run as a script, in a process of its own: the sanitizer must be armed
(``policy_server_tpu_torch.locksan.install()``) before any module of the
package is imported, so that every lock the package builds is
instrumented::

    python tests/torch_locksan_drive.py OUT.json [--device cpu|cuda]
        [--native N] [--stdlib N] [--full]

It boots a server on a small policy set with ``--state-dir``,
``--audit-mode interval --audit-matrix`` and two serving shards under
``--frontend native``, answers N reviews through it, and then (with
``--full``) kills shard 0's dispatch loop and waits for its fence, waits
for an audit sweep over the reviewed objects and its matrix spill, and
reloads the policies; it stops, boots a second server under ``--frontend
python`` on the same state directory (a warm boot), answers N more
reviews, and stops. OUT gets the sanitizer's report
(acquisitions, order edges, inversions with their first stacks, long
holds) and what the run did. Imports no JAX (``chip_smoke.py`` phase 16
runs it on the card).
"""

from __future__ import annotations

import argparse
import copy
import http.client
import json
import os
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the policy set: a plain policy, a mutating one and a group
POLICIES = {
    "pod-privileged": {"module": "builtin://pod-privileged"},
    "psp-capabilities": {
        "module": "builtin://psp-capabilities",
        "allowedToMutate": True,
        "settings": {
            "allowed_capabilities": ["NET_BIND_SERVICE", "CHOWN"],
            "required_drop_capabilities": ["NET_ADMIN"],
            "default_add_capabilities": ["CHOWN"],
        },
    },
    "pod-security-group": {
        "expression": "unprivileged() && (nonroot() || readonly())",
        "message": "pod security baseline not met",
        "policies": {
            "unprivileged": {"module": "builtin://pod-privileged"},
            "nonroot": {"module": "builtin://run-as-non-root"},
            "readonly": {"module": "builtin://readonly-root-fs"},
        },
    },
}
# the reload's set: one policy more
RELOADED = dict(POLICIES, nonroot={"module": "builtin://run-as-non-root"})


def wait_for(pred, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(f"gave up waiting for {what}")
        time.sleep(0.05)


def post_all(port: int, work: list, conns: int = 4) -> dict[int, int]:
    """POST each (policy id, body) on ``conns`` keep-alive connections →
    answers per status."""
    statuses: dict[int, int] = {}
    lock = threading.Lock()

    def run(part: list) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            for pid, body in part:
                conn.request(
                    "POST", f"/validate/{pid}", body=body,
                    headers={"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                resp.read()
                with lock:
                    statuses[resp.status] = statuses.get(resp.status, 0) + 1
                if resp.getheader("Connection", "").lower() == "close":
                    conn.close()
                    conn = http.client.HTTPConnection(
                        "127.0.0.1", port, timeout=30
                    )
        finally:
            conn.close()

    with ThreadPoolExecutor(conns) as pool:
        for f in [pool.submit(run, work[i::conns]) for i in range(conns)]:
            f.result()
    return statuses


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--native", type=int, default=64)
    ap.add_argument("--stdlib", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)

    from policy_server_tpu_torch import locksan

    locksan.install()

    from policy_server_tpu_torch import failpoints
    from policy_server_tpu_torch.models.policy import parse_policies
    from policy_server_tpu_torch.policies.flagship import synthetic_firehose
    from policy_server_tpu_torch.server import PolicyServer

    t0 = time.monotonic()
    facts: dict = {}
    n_total = args.native + args.stdlib
    docs = synthetic_firehose(n_total, seed=31)
    pids = sorted(POLICIES)
    work = []
    for i, d in enumerate(docs):
        d = copy.deepcopy(d)
        # distinct objects, so the audit snapshot holds a row per review
        d["request"]["object"]["metadata"]["name"] = f"locksan-{i}"
        work.append((pids[i % len(pids)], json.dumps(d).encode()))
    root = tempfile.mkdtemp(prefix="locksan-drive-")
    state_dir = os.path.join(root, "state")
    policies_path = os.path.join(root, "policies.json")
    with open(policies_path, "w") as f:
        json.dump(POLICIES, f)

    def boot(frontend: str) -> PolicyServer:
        server = PolicyServer(
            parse_policies(POLICIES),
            port=0, readiness_probe_port=0, device=args.device,
            frontend=frontend, max_batch_size=8,
            host_fastpath_threshold=0, verdict_cache_size=0,
            state_dir=state_dir, audit_mode="interval",
            audit_interval_seconds=0.5, audit_matrix=True,
            audit_matrix_spill_seconds=0.5,
            serving_shards=2, shard_heartbeat_seconds=0.2,
            selfheal_interval_seconds=0,
            policies_path=policies_path,
            enable_metrics=True,
        )
        server.start()
        return server

    def die() -> None:
        raise RuntimeError("locksan drive: shard killed")

    server = boot("native")
    try:
        facts["native"] = post_all(server.port, work[: args.native])
        if args.full:
            router = server.state.batcher
            scanner = server.state.audit
            failpoints.set_failpoint(
                "shard.dispatch", die, count=1, scope="shard-0"
            )
            # traffic on both shards until the dead loop is fenced (rows
            # the dead loop held answer 503)
            deadline = time.monotonic() + 60
            while router.stats_snapshot()["shard_fences"] < 1:
                if time.monotonic() > deadline:
                    raise TimeoutError("the killed shard was never fenced")
                post_all(server.port, work[:8], conns=2)
            failpoints.clear("shard.dispatch")
            facts["fences"] = router.stats_snapshot()["shard_fences"]
            wait_for(
                lambda: scanner.stats()["rows_scanned"] > 0
                and scanner.matrix.stats()["spills"] > 0,
                60, "an audit sweep and its matrix spill",
            )
            facts["audit_rows_scanned"] = scanner.stats()["rows_scanned"]
            facts["matrix_spills"] = scanner.matrix.stats()["spills"]
        with open(policies_path, "w") as f:
            json.dump(RELOADED, f)
        facts["reload"] = server.lifecycle.reload(reason="locksan")
        facts["native_after_reload"] = post_all(server.port, work[:8], conns=2)
    finally:
        server.stop()
    if args.stdlib:
        with open(policies_path, "w") as f:
            json.dump(POLICIES, f)
        server = boot("python")
        try:
            facts["warm"] = server.state.boot_report.get("warm")
            facts["stdlib"] = post_all(server.port, work[args.native :])
        finally:
            server.stop()
    rep = locksan.report()
    out = {
        "acquisitions": rep["acquisitions"],
        "edges": len(rep["edges"]),
        "inversions": rep["inversions"],
        "long_holds": [(site, ms) for site, ms, _stack in rep["long_holds"]],
        "max_hold_ms": max(rep["max_hold_ms"].values(), default=0.0),
        "report": locksan.format_report(rep),
        "facts": facts,
        "seconds": time.monotonic() - t0,
    }
    with open(args.out, "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
