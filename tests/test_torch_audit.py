"""The port's background audit scanner (``policy_server_tpu_torch/audit/``
and the batcher's audit lane) held against the JAX package's: each case of
``tests/test_audit.py``, under the same name, runs its sequence through
each package (the JAX side's environment on its ``jax`` backend, the
port's on the CPU) and the two must agree exactly (tolerance 0: verdicts,
report rows, counters and bodies), beside the JAX test's own assertions.
Also held: a seeded firehose inventory swept under the flagship set, the
shard router's audit lane, the YAML rule of the resources file, a sweep
that meets a closed environment, and, at the default flags (``--audit-mode
off``), the status and body of the audit GET routes on both ports under
both frontends and the audit, matrix and watch families on /metrics.

Every batcher, scanner and server a test starts is shut down by it, and
the failpoints it arms are scoped to its own thread."""

from __future__ import annotations

import json
import re
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from policy_server_tpu.models.policy import parse_policy_entry as jparse
from policy_server_tpu.telemetry import metrics as jmetrics
from policy_server_tpu_torch.models.policy import parse_policy_entry as tparse
from policy_server_tpu_torch.server import PolicyServer
from policy_server_tpu_torch.telemetry import metrics as tmetrics

from torch_port_support import (
    audit_sides,
    firehose_docs,
    flagship_specs,
    pod_doc,
    pod_review,
    report_view,
    result_view,
    side_request,
)

JAX, PORT = audit_sides()
SIDES = (JAX, PORT)
SCOPE = "audit-test"
SPECS = {
    "priv": {"module": "builtin://pod-privileged"},
    "happy": {"module": "builtin://always-happy"},
}


@pytest.fixture(autouse=True)
def clean_failpoints():
    for side in SIDES:
        side.fp.reset()
    yield
    for side in SIDES:
        side.fp.reset()


@pytest.fixture(scope="module")
def envs():
    built = {side.name: side.env(SPECS) for side in SIDES}
    yield built
    for e in built.values():
        e.close()


def both(case, *args):
    """Run ``case(side, ...)`` for each package → the two observations,
    which must be equal."""
    jax_obs = case(JAX, *args)
    port_obs = case(PORT, *args)
    assert port_obs == jax_obs
    return port_obs


def wait_until(predicate, timeout: float = 15.0, step: float = 0.05) -> bool:
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if predicate():
            return True
        time.sleep(step)
    return False


def sweep_fault():
    raise_fault = lambda: (_ for _ in ()).throw(  # noqa: E731
        RuntimeError("injected sweep fault")
    )
    return raise_fault


# ---------------------------------------------------------------------------
# snapshot store
# ---------------------------------------------------------------------------


def test_snapshot_key_supersede_delete_and_dirty():
    def case(side):
        store = side.audit.SnapshotStore(max_bytes=10 * 1024 * 1024)
        a1 = pod_review(side, "a", privileged=False)
        a2 = pod_review(side, "a", privileged=True)
        b = pod_review(side, "b")
        assert side.audit.resource_key(a1) == side.audit.resource_key(a2)
        store.observe([a1, b])
        assert len(store) == 2
        store.observe([a2])
        assert len(store) == 2
        rows = dict(store.collect())
        assert rows[side.audit.resource_key(a2)] is a2
        store.observe([a2])
        dirty = [k for k, _ in store.collect(dirty_only=True)]
        assert dirty == [side.audit.resource_key(a2)]
        store.observe([pod_review(side, "a", operation="DELETE")])
        assert len(store) == 1
        stats = store.stats()
        assert stats["superseded"] == 2 and stats["deleted"] == 1
        store.observe([side.ValidateRequest.from_raw({"uid": "r"})])
        assert len(store) == 1
        return sorted(rows), dirty, store.stats(), sorted(store.take_deletions())

    both(case)


def test_snapshot_byte_budget_evicts_lru():
    def case(side):
        one = len(pod_review(side, "x").payload_json())
        store = side.audit.SnapshotStore(max_bytes=int(one * 2.5))
        store.observe([pod_review(side, f"n{i}") for i in range(4)])
        assert len(store) == 2
        assert store.stats()["evicted"] == 2
        kept = [k for k, _ in store.collect()]
        assert all(k.endswith(("n2", "n3")) for k in kept)
        return one, kept, store.stats()

    both(case)


SEED_DOC = {
    "items": [
        {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {"name": "seeded", "namespace": "ns1"},
            "spec": {"containers": [{"name": "c", "image": "i"}]},
        },
        {"not-an-object": True},
    ]
}


def test_snapshot_seed_from_file(tmp_path):
    """The JSON resources file (a List document) seeds the same rows and
    payload bytes in both packages."""
    path = tmp_path / "resources.json"
    path.write_text(json.dumps(SEED_DOC))

    def case(side):
        store = side.audit.SnapshotStore()
        assert store.seed_from_file(str(path)) == 1
        (key, req), = store.collect()
        assert key == "/v1/Pod/ns1/seeded"
        assert req.admission_request.operation == "CREATE"
        return key, req.payload_json(), store.stats()

    both(case)


def test_snapshot_seed_yaml_reads_with_pyyaml_and_raises_without(
    tmp_path, monkeypatch
):
    """A YAML resources file seeds what the JAX package seeds where PyYAML
    is installed; without PyYAML the port raises a clear error (never a
    silent empty seed), while a JSON file still needs nothing."""
    pytest.importorskip("yaml")
    path = tmp_path / "resources.yml"
    path.write_text(
        "- apiVersion: v1\n  kind: Pod\n  metadata:\n    name: y\n"
        "    namespace: ns2\n  spec:\n    containers:\n    - name: c\n"
        "      image: i\n"
    )

    def case(side):
        store = side.audit.SnapshotStore()
        assert store.seed_from_file(str(path)) == 1
        (key, req), = store.collect()
        return key, req.payload_json()

    assert both(case)[0] == "/v1/Pod/ns2/y"
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ValueError, match="needs PyYAML"):
        PORT.audit.SnapshotStore().seed_from_file(str(path))
    json_path = tmp_path / "resources.json"
    json_path.write_text(json.dumps(SEED_DOC["items"]))
    assert PORT.audit.SnapshotStore().seed_from_file(str(json_path)) == 1


# ---------------------------------------------------------------------------
# report store
# ---------------------------------------------------------------------------


def test_report_store_rows_summary_and_rollback_staleness():
    def case(side):
        store = side.audit.PolicyReportStore()
        req = pod_review(side, "a", namespace="ns1")
        key = side.audit.resource_key(req)
        deny = side.Response.reject("u", "denied", 400)
        allow = side.Response(uid="u", allowed=True)
        store.put([
            store.row_from_result(key, "p1", req, deny, epoch=0),
            store.row_from_result(key, "p2", req, allow, epoch=0),
            store.row_from_result(key, "p3", req, RuntimeError("boom"), epoch=0),
        ])
        first = report_view(store.payload())
        assert first["summary"] == {
            "results": 3, "resources": 1, "pass": 1, "fail": 1, "error": 1,
            "mutated": 0, "stale": 0,
        }
        assert store.payload("other")["summary"]["results"] == 0
        assert store.payload("ns1")["summary"]["results"] == 3
        store.put([store.row_from_result(key, "p1", req, allow, epoch=1)])
        assert store.mark_epoch_stale(1) == 1
        after = report_view(store.payload())
        assert after["summary"]["stale"] == 1
        assert after["summary"]["pass"] == 1
        return first, after, store.stats(), store.version()

    both(case)


# ---------------------------------------------------------------------------
# the batcher's best-effort audit lane
# ---------------------------------------------------------------------------


def lane_keys(batcher) -> dict:
    snap = batcher.stats_snapshot()
    return {
        k: snap[k] for k in (
            "audit_batches_dispatched", "audit_rows_dispatched",
            "audit_preemptions", "matrix_lookup_hits", "matrix_lookup_misses",
        )
    }


def test_audit_lane_dispatches_raw_verdicts_when_idle(envs):
    def case(side):
        batcher = side.Batcher(
            envs[side.name], max_batch_size=8, policy_timeout=10.0
        ).start()
        try:
            pairs = [
                ("priv", pod_review(side, "lane-a", privileged=True)),
                ("priv", pod_review(side, "lane-b", privileged=False)),
            ]
            results = batcher.submit_audit(pairs).result(timeout=30)
            assert results[0].allowed is False
            assert results[1].allowed is True
            assert batcher.audit_lane_depth() == 0
            return result_view(results), lane_keys(batcher)
        finally:
            batcher.shutdown()

    _, counts = both(case)
    assert counts["audit_batches_dispatched"] == 1
    assert counts["audit_rows_dispatched"] == 2


def test_audit_lane_single_inflight_cap(envs):
    def case(side):
        env = envs[side.name]
        release = threading.Event()
        started: list[float] = []
        real = env.validate_batch

        class Blocking:
            def __getattr__(self, name):
                return getattr(env, name)

            def validate_batch(self, pairs, **kw):
                started.append(time.perf_counter())
                assert release.wait(timeout=30)
                return real(pairs, **kw)

        batcher = side.Batcher(
            Blocking(), max_batch_size=8, policy_timeout=10.0
        ).start()
        try:
            f1 = batcher.submit_audit([("happy", pod_review(side, "c1"))])
            f2 = batcher.submit_audit([("happy", pod_review(side, "c2"))])
            assert wait_until(lambda: started, timeout=5)
            time.sleep(0.3)
            while_blocked = len(started)
            release.set()
            r1, r2 = f1.result(timeout=30), f2.result(timeout=30)
            return while_blocked, len(started), result_view(r1 + r2)
        finally:
            release.set()
            batcher.shutdown()

    blocked, total, _ = both(case)
    assert (blocked, total) == (1, 2)


def test_audit_preemption_requeues_for_live_work(envs):
    def case(side):
        batcher = side.Batcher(
            envs[side.name], max_batch_size=8, policy_timeout=10.0
        )
        try:
            fut = batcher.submit_audit([("happy", pod_review(side, "pre"))])
            live = batcher.submit(
                "happy", pod_review(side, "live"), side.origin.VALIDATE
            )
            batcher._maybe_dispatch_audit()
            assert wait_until(lambda: batcher.audit_lane_depth() == 1, 5)
            requeued = (batcher.audit_lane_depth(), lane_keys(batcher),
                        fut.done())
            batcher.start()
            answers = (
                live.result(timeout=30).to_dict(),
                result_view(fut.result(timeout=30)),
            )
            return requeued, answers
        finally:
            batcher.shutdown()

    (depth, counts, done), _ = both(case)
    assert depth == 1 and counts["audit_preemptions"] == 1 and not done


def test_audit_slack_gate_blocks_on_breaker_and_tight_budget(envs):
    def case(side):
        env = envs[side.name]

        class BreakerOpen:
            breaker_all_open = True

            def __getattr__(self, name):
                return getattr(env, name)

        out = [side.Batcher(BreakerOpen(), max_batch_size=8)._audit_slack_ok(8)]
        b2 = side.Batcher(env, max_batch_size=8, request_timeout_ms=100.0)
        bucket = side.bucket_size(8)
        for rtt, rows in ((0.5, 8), (0.001, 8), (0.008, 8), (0.008, 64)):
            b2._dev_rtt[bucket] = rtt
            out.append(b2._audit_slack_ok(rows))
        b3 = side.Batcher(env, max_batch_size=8, request_timeout_ms=0.0)
        b3._dev_rtt[bucket] = 0.5
        out.append(b3._audit_slack_ok(8))
        return out

    assert both(case) == [False, False, True, True, False, True]


def test_audit_lane_rejects_on_shutdown(envs):
    def case(side):
        batcher = side.Batcher(envs[side.name], max_batch_size=8)
        fut = batcher.submit_audit([("happy", pod_review(side, "s1"))])
        batcher.shutdown()
        later = batcher.submit_audit([("happy", pod_review(side, "s2"))])
        out = []
        for f in (fut, later):
            with pytest.raises(RuntimeError, match="audit lane closed") as e:
                f.result(timeout=5)
            out.append(str(e.value))
        return out

    both(case)


def test_preemption_proof_live_deadlines_met_under_saturating_sweep(envs):
    """With the lane saturated, live waves keep their deadline in both
    packages, and every live answer is the same."""

    def case(side):
        batcher = side.Batcher(
            envs[side.name], max_batch_size=16, policy_timeout=5.0,
            host_fastpath_threshold=0,
        ).start()
        try:
            batcher.warmup()
            for b in range(40):
                batcher.submit_audit([
                    ("priv", pod_review(side, f"audit-{b}-{i}",
                                        privileged=bool(i % 2)))
                    for i in range(64)
                ])
            latencies, answers = [], []
            for wave in range(10):
                t0 = time.perf_counter()
                futs = [
                    batcher.submit(
                        "priv", pod_review(side, f"live-{wave}-{i}"),
                        side.origin.VALIDATE,
                    )
                    for i in range(8)
                ]
                answers += [f.result(timeout=10).to_dict() for f in futs]
                latencies.append(time.perf_counter() - t0)
                time.sleep(0.05)
            snap = batcher.stats_snapshot()
            assert snap["audit_batches_dispatched"] >= 1
            assert max(latencies) < 4.0, latencies
            assert snap["deadline_abandoned_batches"] == 0
            return answers
        finally:
            batcher.shutdown()

    answers = both(case)
    assert all(a["allowed"] for a in answers)


# ---------------------------------------------------------------------------
# the scanner
# ---------------------------------------------------------------------------


def make_scanner(side, env, batcher, lifecycle=None, **kw):
    state = SimpleNamespace(
        evaluation_environment=env, batcher=batcher, lifecycle=lifecycle
    )
    kw.setdefault("mode", "interval")
    kw.setdefault("interval_seconds", 30.0)
    return side.audit.AuditScanner(
        state=state, snapshot=side.audit.SnapshotStore(),
        reports=side.audit.PolicyReportStore(), **kw
    )


def scanner_view(scanner) -> dict:
    stats = dict(scanner.stats())
    stats.pop("freshness_seconds")
    return {"reports": report_view(scanner.report_payload()), "stats": stats}


def test_scanner_full_and_dirty_sweeps(envs):
    def case(side):
        env = envs[side.name]
        batcher = side.Batcher(env, max_batch_size=8, policy_timeout=10.0).start()
        scanner = make_scanner(side, env, batcher, batch_size=4)
        try:
            scanner.snapshot.observe([
                pod_review(side, "a", privileged=True), pod_review(side, "b"),
            ])
            counts = [scanner.sweep(full=True)]
            first = scanner_view(scanner)
            by = {(r["name"], r["policy_id"]): r
                  for r in first["reports"]["reports"]}
            assert by[("a", "priv")]["allowed"] is False
            assert by[("a", "happy")]["allowed"] is True
            assert by[("b", "priv")]["allowed"] is True
            counts.append(scanner.sweep(full=False))
            scanner.snapshot.observe([pod_review(side, "b", privileged=True)])
            counts.append(scanner.sweep(full=False))
            assert scanner.stats()["freshness_seconds"] >= 0
            return counts, first, scanner_view(scanner)
        finally:
            batcher.shutdown()

    counts, _, last = both(case)
    assert counts == [4, 0, 2]
    assert (last["stats"]["full_sweeps"], last["stats"]["dirty_sweeps"],
            last["stats"]["rows_scanned"]) == (1, 2, 6)


def test_scanner_rows_scanned_accounts_whole_run_across_epochs(envs):
    def case(side):
        env = envs[side.name]
        lifecycle = SimpleNamespace(current_epoch=0)
        batcher = side.Batcher(env, max_batch_size=8, policy_timeout=10.0).start()
        scanner = make_scanner(side, env, batcher, lifecycle=lifecycle,
                               batch_size=4)
        try:
            scanner.snapshot.observe([
                pod_review(side, "a", privileged=True), pod_review(side, "b"),
            ])
            counts = [scanner.sweep(full=True)]
            lifecycle.current_epoch = 1
            scanner.on_promote(1)
            counts.append(scanner.sweep(full=True))
            return counts, scanner_view(scanner)
        finally:
            batcher.shutdown()

    counts, view = both(case)
    assert counts == [4, 4]
    assert view["stats"]["rows_scanned_by_epoch"] == {"0": 4, "1": 4}


def test_scanner_pauses_while_breaker_open(envs):
    def case(side):
        env = envs[side.name]

        class BreakerOpen:
            breaker_all_open = True

            def __getattr__(self, name):
                return getattr(env, name)

        batcher = side.Batcher(env, max_batch_size=8).start()
        scanner = make_scanner(side, BreakerOpen(), batcher)
        try:
            scanner.snapshot.observe([pod_review(side, "a")])
            return scanner.sweep(full=True), scanner_view(scanner)
        finally:
            batcher.shutdown()

    n, view = both(case)
    assert n == 0 and view["stats"]["paused_sweeps"] == 1


def test_scanner_fault_aborts_then_resumes(envs):
    """A scoped ``audit.sweep`` fault aborts the sweep; the retry judges
    the whole corpus. The scanner never wedges."""

    def case(side):
        env = envs[side.name]
        batcher = side.Batcher(env, max_batch_size=8, policy_timeout=10.0).start()
        scanner = make_scanner(side, env, batcher)
        try:
            scanner.snapshot.observe([pod_review(side, "a"), pod_review(side, "b")])
            with side.fp.scope(SCOPE), side.fp.active(
                "audit.sweep", sweep_fault(), count=1, scope=SCOPE
            ):
                with pytest.raises(RuntimeError, match="injected"):
                    scanner.sweep(full=True)
            fired = side.fp.fired_count("audit.sweep")
            dirty = scanner.snapshot.stats()["dirty"]
            return fired, dirty, scanner.sweep(full=True), scanner_view(scanner)
        finally:
            batcher.shutdown()

    fired, dirty, n, _ = both(case)
    assert (fired, dirty, n) == (1, 2, 4)


def test_scanner_mid_sweep_batcher_shutdown_remarks_dirty(envs):
    def case(side):
        env = envs[side.name]
        batcher = side.Batcher(env, max_batch_size=8, policy_timeout=10.0)
        batcher.shutdown()
        scanner = make_scanner(side, env, batcher, job_timeout_seconds=5.0)
        scanner.snapshot.observe([pod_review(side, "a"), pod_review(side, "b")])
        with pytest.raises(RuntimeError) as e:
            scanner.sweep(full=True)
        dirty = scanner.snapshot.stats()["dirty"]
        batcher2 = side.Batcher(env, max_batch_size=8, policy_timeout=10.0).start()
        scanner.state.batcher = batcher2
        try:
            return str(e.value), dirty, scanner.sweep(full=False)
        finally:
            batcher2.shutdown()

    assert both(case)[1:] == (2, 4)


def test_scanner_sweep_on_a_closed_environment_remarks_dirty():
    """The port's ``close()`` makes a later dispatch raise "environment
    closed" (the lifecycle closes a retired epoch's environment): the
    audit job fails, the sweep aborts with its rows re-marked dirty and
    counts one error on the cadence thread, as the mid-sweep shutdown
    does in the JAX package; a healthy epoch then finishes the job."""
    env = PORT.env(SPECS)
    batcher = PORT.Batcher(env, max_batch_size=8, policy_timeout=10.0).start()
    scanner = make_scanner(PORT, env, batcher, job_timeout_seconds=5.0,
                           interval_seconds=0.05)
    env2 = PORT.env(SPECS)
    batcher2 = PORT.Batcher(env2, max_batch_size=8, policy_timeout=10.0).start()
    try:
        scanner.snapshot.observe([pod_review(PORT, "a"), pod_review(PORT, "b")])
        env.close()
        with pytest.raises(RuntimeError, match="environment closed"):
            scanner.sweep(full=True)
        assert scanner.snapshot.stats()["dirty"] == 2
        with scanner._lock:
            assert scanner._full_pending is True
        scanner.start()
        assert wait_until(lambda: scanner.stats()["sweep_errors"] >= 1)
        scanner.state.evaluation_environment = env2
        scanner.state.batcher = batcher2
        assert wait_until(lambda: scanner.stats()["full_sweeps"] == 1)
        assert scanner.report_payload()["summary"]["results"] == 4
    finally:
        scanner.shutdown()
        batcher.shutdown()
        batcher2.shutdown()
        env2.close()


# ---------------------------------------------------------------------------
# end to end: servers, the HTTP surface, epoch coherence
# ---------------------------------------------------------------------------


CAPS_MUTATOR = {
    "module": "builtin://psp-capabilities",
    "settings": {
        "allowed_capabilities": ["*"],
        "required_drop_capabilities": ["NET_ADMIN"],
    },
}
SERVER_SPECS = {
    "pod-privileged": {"module": "builtin://pod-privileged"},
    "caps-mutator": CAPS_MUTATOR,
}


def jax_handle(specs: dict, **overrides):
    from test_server import ServerHandle, make_config

    config = make_config(
        policies={k: jparse(k, v) for k, v in specs.items()},
        policy_timeout_seconds=5.0, warmup_at_boot=False, **overrides,
    )
    return ServerHandle(config)


def port_handle(specs: dict, **kw) -> SimpleNamespace:
    kw = dict(dict(port=0, readiness_probe_port=0, device="cpu",
                   policy_timeout=5.0, warmup=False), **kw)
    server = PolicyServer({k: tparse(k, v) for k, v in specs.items()}, **kw)
    server.start()
    return SimpleNamespace(
        server=server, api_port=server.port,
        readiness_port=server.readiness_port, stop=server.stop,
    )


class Pair:
    """A JAX server and a port server on one policy set and audit flags."""

    def __init__(self, specs: dict, **audit):
        self.jax = jax_handle(specs, **audit)
        try:
            self.port = port_handle(specs, **audit)
        except BaseException:
            self.jax.stop()
            raise

    def sides(self):
        return (
            (JAX, self.jax.server, self.jax.server.api_port,
             self.jax.server.readiness_port),
            (PORT, self.port.server, self.port.api_port,
             self.port.readiness_port),
        )

    def stop(self) -> None:
        try:
            self.port.stop()
        finally:
            self.jax.stop()


def http(port: int, method: str, path: str, body: bytes | None = None,
         headers: dict | None = None) -> tuple[int, dict, bytes]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method=method,
        headers=dict({"Content-Type": "application/json"}, **(headers or {})),
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


@pytest.fixture(scope="module")
def audit_pair():
    pair = Pair(
        SERVER_SPECS, audit_mode="interval", audit_interval_seconds=60.0,
        audit_batch_size=8,
    )
    yield pair
    pair.stop()


def served_pod(privileged: bool, namespace: str = "default",
               name: str = "p") -> bytes:
    doc = pod_doc(name, namespace=namespace, privileged=privileged)
    doc["request"]["uid"] = "hello"
    return json.dumps(doc).encode()


def test_audit_skips_constraints_validate_applies_them(audit_pair):
    def case(side_server):
        side, _server, api, _rp = side_server
        body = served_pod(False)
        v = http(api, "POST", "/validate/caps-mutator", body)
        a = http(api, "POST", "/audit/caps-mutator", body)
        return v[0], json.loads(v[2]), a[0], json.loads(a[2])

    jax_obs, port_obs = (case(s) for s in audit_pair.sides())
    assert port_obs == jax_obs
    vs, vresp, as_, aresp = port_obs
    assert vs == as_ == 200
    assert vresp["response"]["allowed"] is False
    assert aresp["response"]["allowed"] is True
    assert aresp["response"]["patchType"] == "JSONPatch"


def _reports(port: int, path: str = "/audit/reports") -> tuple[int, dict]:
    status, _h, body = http(port, "GET", path)
    return status, report_view(json.loads(body))


def test_dirty_tracking_sweep_and_reports_endpoints(audit_pair):
    def case(side_server):
        side, server, api, rp = side_server
        scanner = server.state.audit
        assert scanner is not None
        http(api, "POST", "/validate/pod-privileged",
             served_pod(True, namespace="ns-a"))
        assert wait_until(lambda: any(
            "ns-a" in k for k, _ in scanner.snapshot.rows_snapshot()
        ))
        before = scanner.snapshot.stats()["resources"]
        http(api, "POST", "/audit/pod-privileged",
             served_pod(True, namespace="ns-b"))
        time.sleep(0.3)
        assert scanner.snapshot.stats()["resources"] == before
        scanner.sweep(full=True)
        out = {}
        for name, port in (("api", api), ("readiness", rp)):
            for path in ("/audit/reports", "/audit/reports/ns-a",
                         "/audit/reports/no-such-ns"):
                status, body = _reports(port, path)
                body["scanner"].pop("full_sweeps")
                body["scanner"].pop("rows_scanned")
                out[name, path] = (status, body)
        return out

    jax_obs, port_obs = (case(s) for s in audit_pair.sides())
    assert port_obs == jax_obs
    rows = {(r["namespace"], r["policy_id"]): r
            for r in port_obs["api", "/audit/reports"][1]["reports"]}
    assert rows[("ns-a", "pod-privileged")]["allowed"] is False
    assert rows[("ns-a", "caps-mutator")]["mutated"] is True
    assert port_obs["api", "/audit/reports/no-such-ns"][1]["summary"][
        "results"] == 0


def test_epoch_coherence_promote_rescans_rollback_stales(audit_pair):
    def case(side_server):
        side, server, api, _rp = side_server
        scanner = server.state.audit
        lifecycle = server.lifecycle
        http(api, "POST", "/validate/pod-privileged", served_pod(False))
        scanner.sweep(full=True)
        epoch0 = lifecycle.current_epoch
        base = scanner.report_payload()
        assert all(x["epoch"] == epoch0 for x in base["reports"])
        sweeps = scanner.stats()["full_sweeps"]
        with lifecycle._swap_lock:
            current = dict(lifecycle._current.policies)
        assert lifecycle.reload(policies=current) == "promoted"
        epoch1 = lifecycle.current_epoch
        assert wait_until(
            lambda: scanner.stats()["full_sweeps"] > sweeps and all(
                x["epoch"] == epoch1
                for x in scanner.report_payload()["reports"]
            ), timeout=30,
        )
        with scanner._sweep_lock:
            assert lifecycle.rollback() == "rolled-back"
            stale = report_view(scanner.report_payload())
        assert wait_until(
            lambda: all(
                x["epoch"] == epoch0 and not x["stale"]
                for x in scanner.report_payload()["reports"]
            ), timeout=30,
        )
        for body in (stale,):
            body["scanner"].pop("full_sweeps")
            body["scanner"].pop("rows_scanned")
        return epoch1 - epoch0, stale["summary"], [
            (r["resource"], r["policy_id"], r["epoch"] - epoch0, r["stale"])
            for r in stale["reports"]
        ]

    jax_obs, port_obs = (case(s) for s in audit_pair.sides())
    assert port_obs == jax_obs
    assert port_obs[1]["stale"] == len(port_obs[2]) > 0


def test_reports_endpoint_404_when_audit_off():
    pair = Pair({"pod-privileged": {"module": "builtin://pod-privileged"}},
                policy_reload_mode="off")
    try:
        got = []
        for side, server, api, rp in pair.sides():
            assert server.state.audit is None
            status, _h, body = http(api, "GET", "/audit/reports")
            got.append((status, json.loads(body)))
        assert got[1] == got[0]
        assert got[1][0] == 404
        assert "audit scanner is disabled" in got[1][1]["message"]
    finally:
        pair.stop()


# ---------------------------------------------------------------------------
# deferred full sweeps, report GC, lane cancel, tenants
# ---------------------------------------------------------------------------


def test_paused_full_sweep_keeps_its_pending_claim(envs):
    def case(side):
        env = envs[side.name]

        class BreakerOpen:
            breaker_all_open = True

            def __getattr__(self, name):
                return getattr(env, name)

        batcher = side.Batcher(env, max_batch_size=8).start()
        scanner = make_scanner(side, BreakerOpen(), batcher, mode="on-promote")
        try:
            out = []
            with scanner._lock:
                scanner._full_pending = False
            out.append(scanner.sweep(full=True))
            with scanner._lock:
                out.append(scanner._full_pending)
                scanner._full_pending = False
            with side.fp.scope(SCOPE), side.fp.active(
                "audit.sweep", sweep_fault(), count=1, scope=SCOPE
            ):
                with pytest.raises(RuntimeError):
                    scanner.sweep(full=True)
            with scanner._lock:
                out.append(scanner._full_pending)
            return out
        finally:
            batcher.shutdown()

    assert both(case) == [0, True, True]


def test_reports_pruned_for_deleted_and_evicted_resources(envs):
    def case(side):
        env = envs[side.name]
        batcher = side.Batcher(env, max_batch_size=8, policy_timeout=10.0).start()
        scanner = make_scanner(side, env, batcher)
        try:
            scanner.snapshot.observe([pod_review(side, "a"), pod_review(side, "b")])
            scanner.sweep(full=True)
            views = [scanner_view(scanner)]
            scanner.snapshot.observe([pod_review(side, "a", operation="DELETE")])
            scanner.sweep(full=False)
            views.append(scanner_view(scanner))
            scanner.reports.put([
                scanner.reports.row_from_result(
                    "/v1/Pod/default/b", "removed-policy",
                    pod_review(side, "b"),
                    side.Response(uid="u", allowed=True), epoch=0,
                )
            ])
            scanner.sweep(full=True)
            views.append(scanner_view(scanner))
            return views
        finally:
            batcher.shutdown()

    views = both(case)
    assert views[1]["reports"]["summary"]["resources"] == 1
    assert {r["policy_id"] for r in views[2]["reports"]["reports"]} == {
        "priv", "happy",
    }


def test_cancel_audit_removes_queued_job(envs):
    def case(side):
        batcher = side.Batcher(envs[side.name], max_batch_size=8)
        try:
            fut = batcher.submit_audit([("happy", pod_review(side, "c"))])
            out = [batcher.audit_lane_depth(), batcher.cancel_audit(fut),
                   batcher.audit_lane_depth()]
            with pytest.raises(RuntimeError, match="cancelled"):
                fut.result(timeout=5)
            out.append(batcher.cancel_audit(fut))
            return out
        finally:
            batcher.shutdown()

    assert both(case) == [1, True, 0, False]


def test_sweep_job_timeout_cancels_lane_job_and_remarks_dirty(envs):
    def case(side):
        batcher = side.Batcher(envs[side.name], max_batch_size=8)
        scanner = make_scanner(side, envs[side.name], batcher,
                               job_timeout_seconds=0.3)
        try:
            scanner.snapshot.observe([pod_review(side, "a")])
            with pytest.raises(RuntimeError, match="timed out") as e:
                scanner.sweep(full=True)
            with scanner._lock:
                pending = scanner._full_pending
            return (str(e.value), batcher.audit_lane_depth(),
                    scanner.snapshot.stats()["dirty"], pending)
        finally:
            batcher.shutdown()

    assert both(case)[1:] == (0, 1, True)


def test_on_promote_mode_drains_deletions_between_sweeps(envs):
    def case(side):
        env = envs[side.name]
        batcher = side.Batcher(env, max_batch_size=8, policy_timeout=10.0).start()
        scanner = make_scanner(side, env, batcher, mode="on-promote")
        try:
            scanner.snapshot.observe([pod_review(side, "a"), pod_review(side, "b")])
            scanner.sweep(full=True)
            with scanner._lock:
                scanner._full_pending = False
            scanner.start()
            scanner.snapshot.observe([pod_review(side, "a", operation="DELETE")])
            assert wait_until(
                lambda: scanner.report_payload()["summary"]["resources"] == 1
                and not scanner.snapshot.take_deletions()
            )
            stats = scanner.stats()
            return stats["full_sweeps"], stats["dirty_sweeps"]
        finally:
            scanner.shutdown()
            batcher.shutdown()

    assert both(case) == (1, 0)


def test_tenant_traffic_never_feeds_the_audit_snapshot(envs):
    def case(side):
        env = envs[side.name]
        store = side.audit.SnapshotStore(max_bytes=10 * 1024 * 1024)
        default_batcher = side.Batcher(
            env, max_batch_size=8, policy_timeout=10.0, audit_tracker=store,
        ).start()
        tenant_batcher = side.Batcher(
            env, max_batch_size=8, policy_timeout=10.0, audit_tracker=None,
            tenant="ten-a",
        ).start()
        try:
            default_batcher.submit(
                "priv", pod_review(side, "from-default"), side.origin.VALIDATE
            ).result(timeout=30)
            tenant_batcher.submit(
                "priv", pod_review(side, "from-tenant-a"), side.origin.VALIDATE
            ).result(timeout=30)
            return sorted(k for k, _ in store.collect())
        finally:
            default_batcher.shutdown()
            tenant_batcher.shutdown()

    keys = both(case)
    assert len(keys) == 1 and "from-default" in keys[0]


# ---------------------------------------------------------------------------
# seeded inventory, the shard router's lane
# ---------------------------------------------------------------------------


def test_seeded_firehose_sweep_reports_equal_jax():
    """A seeded firehose inventory (one object in three widened to the
    large schema bucket) swept under the flagship set: every report row
    and the summary are the JAX package's, on the audit lane's device path
    (the port's plain kernel here)."""
    specs = flagship_specs()
    docs = firehose_docs(24, seed=8, wide_every=3)

    def case(side):
        env = side.env(specs)
        batcher = side.Batcher(env, max_batch_size=64, policy_timeout=30.0).start()
        scanner = make_scanner(side, env, batcher, batch_size=96)
        try:
            scanner.snapshot.observe([side_request(side, d) for d in docs])
            n = scanner.sweep(full=True)
            return n, scanner_view(scanner), lane_keys(batcher)
        finally:
            batcher.shutdown()
            env.close()

    n, view, lane = both(case)
    assert n == view["reports"]["summary"]["resources"] * len(specs)
    assert view["reports"]["summary"]["fail"] > 0
    assert lane["audit_batches_dispatched"] == -(-n // 96)


def test_shard_router_submit_audit_and_depth():
    """``ShardRouter.submit_audit`` lands a batch on one shard's lane,
    ``audit_lane_depth`` sums every shard's and ``cancel_audit`` finds a
    job on whichever shard holds it."""

    def case(side):
        env = side.env(SPECS)
        router = side.shards.build_serving_shards(
            env, lambda e: side.Batcher(e, max_batch_size=8),
            lambda _policies: side.env(SPECS),
            2,
        )
        try:
            futs = [
                router.submit_audit([("priv", pod_review(side, f"r{i}",
                                                          privileged=True))])
                for i in range(3)
            ]
            depth = router.audit_lane_depth()
            cancelled = router.cancel_audit(futs[0])
            depth_after = router.audit_lane_depth()
            router.start()
            results = [result_view(f.result(timeout=30)) for f in futs[1:]]
            snap = router.stats_snapshot()
            return (depth, cancelled, depth_after, results,
                    snap["audit_batches_dispatched"], snap["audit_rows_dispatched"])
        finally:
            router.shutdown()
            env.close()

    obs = both(case)
    assert obs[:3] == (3, True, 2) and obs[4:] == (2, 2)


# ---------------------------------------------------------------------------
# default flags: the audit GET routes and the /metrics families
# ---------------------------------------------------------------------------


ROUTES = ("/audit/reports", "/audit/reports/team-a", "/audit/stream",
          "/audit/stream?cursor=7")
FAMILY_PREFIX = "policy_server_audit"


@pytest.fixture(scope="module")
def default_servers():
    """At the default flags: a JAX server under each frontend and the
    port's under each (the ``--frontend native`` pair on one of them)."""
    from test_torch_native_frontend import JaxServerHandle, port_server

    # each package's process registry reads the runtime stats of the last
    # server built: every one of these is at the default flags
    jmetrics.reset_metrics_for_tests()
    tmetrics.reset_metrics_for_tests()
    built = []
    try:
        for front in ("python", "native"):
            built.append(("jax", front, JaxServerHandle(
                frontend=front, enable_metrics=True, warmup_at_boot=False
            )))
            built.append(("port", front, port_server(
                frontend=front, warmup=False
            )))
        yield {(pkg, front): s for pkg, front, s in built}
    finally:
        for _pkg, _front, s in reversed(built):
            s.stop()
        jmetrics.reset_metrics_for_tests()
        tmetrics.reset_metrics_for_tests()


def _raw_get(port: int, path: str) -> tuple[str, bytes, dict]:
    from test_torch_native_frontend import exchange

    (status, headers, body), = exchange(
        port, f"GET {path} HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n"
        .encode()
    )
    return status, body, {k: v for k, v in headers.items()
                          if k in ("content-type", "allow")}


def test_default_flags_audit_routes_answer_as_the_jax_package(default_servers):
    """``--audit-mode off``: on the API port (each frontend against the
    JAX package's same frontend) and on the readiness port, the audit GET
    routes give the JAX package's status and body."""
    for front in ("python", "native"):
        jax_s, port_s = default_servers["jax", front], default_servers["port", front]
        for path in ROUTES:
            want = _raw_get(jax_s.port, path)
            got = _raw_get(port_s.port, path)
            assert got[:2] == want[:2], (front, path, got, want)
            if front == "python":
                assert got[2] == want[2]
            want = _raw_get(jax_s.readiness_port, path)
            got = _raw_get(port_s.readiness_port, path)
            assert got[:2] == want[:2], (front, "readiness", path, got, want)
    python_port = default_servers["port", "python"]
    status, body, _h = _raw_get(python_port.port, "/audit/reports")
    assert status.startswith("HTTP/1.1 404") and json.loads(body) == {
        "message": "the background audit scanner is disabled", "status": 404,
    }
    status, body, _h = _raw_get(python_port.readiness_port, "/audit/stream")
    assert json.loads(body)["message"] == "the verdict matrix is disabled"


def _families(text: str) -> dict:
    """Each ``policy_server_audit*`` family → (type, help, samples)."""
    out = {}
    for name, kind in re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M):
        if name.startswith(FAMILY_PREFIX):
            help_text = re.search(
                rf"^# HELP {re.escape(name)} (.*)$", text, re.M
            ).group(1)
            samples = re.findall(
                rf"^{re.escape(name)}(?:_total)?(?:{{[^}}]*}})? (\S+)$",
                text, re.M,
            )
            out[name] = (kind, help_text, samples)
    return out


def test_default_flags_metrics_carry_the_jax_audit_families(default_servers):
    """/metrics carries every audit, matrix and watch family of the JAX
    package's, with its type, help text and zero values (freshness -1)."""
    for front in ("python", "native"):
        want = _families(http(
            default_servers["jax", front].readiness_port, "GET", "/metrics"
        )[2].decode())
        got = _families(http(
            default_servers["port", front].readiness_port, "GET", "/metrics"
        )[2].decode())
        assert len(want) == 32
        assert got == want
    for name, (_kind, _help, samples) in got.items():
        assert samples == (["-1.0"] if "freshness" in name else ["0.0"]), name


# -- every family of the JAX package's /metrics at the default flags ---------

# the families whose help text names the port's CUDA path (type and name
# are the JAX package's)
CUDA_WORDED = {
    "policy_server_batches_dispatched", "policy_server_fragment_hits",
    "policy_server_host_encode_seconds", "policy_server_pallas_buckets_armed",
    "policy_server_pallas_dispatches",
}
# the port's own family: kernel and CUDA errors
PORT_ONLY = {"policy_server_device_errors"}
# the families the port lacked at the default flags, by what feeds them
REPAIRED = {
    "predicate": (
        "policy_server_predicate_subtrees_shared",
        "policy_server_predicate_policies_folded",
        "policy_server_predicate_rules_folded",
        "policy_server_predicate_fields_pruned",
        "policy_server_predicate_row_bytes_saved",
    ),
    "boot": (
        "policy_server_boot_time_to_ready_seconds",
        "policy_server_boot_warm",
        "policy_server_boot_degraded_sources",
    ),
    "statestore": (
        "policy_server_statestore_artifacts_resident",
        "policy_server_statestore_bytes_resident",
        "policy_server_statestore_artifact_cache_hits",
        "policy_server_statestore_artifact_cache_misses",
        "policy_server_statestore_manifests_persisted",
        "policy_server_statestore_journal_records",
        "policy_server_statestore_fsck_quarantined",
        "policy_server_statestore_audit_spills",
        "policy_server_statestore_audit_rows_restored",
    ),
    "kernel-mode": ("policy_server_pallas_interpret_mode",),
    "soak": (
        "policy_server_soak_window_rps",
        "policy_server_soak_window_p99_ms",
        "policy_server_soak_window_shed_rate",
    ),
    "columnar": (
        "policy_server_wire_bytes_shipped",
        "policy_server_wire_bytes_packed_equivalent",
        "policy_server_wire_rows",
        "policy_server_delta_columns_shipped",
        "policy_server_delta_columns_available",
        "policy_server_donated_buffer_dispatches",
        "policy_server_device_resident_constant_bytes",
    ),
}


def _all_families(port: int) -> dict:
    """Every family of a /metrics page → (type, help, sample values), the
    ``_total`` of a counter's name dropped."""
    text = http(port, "GET", "/metrics")[2].decode()
    out = {}
    for name, kind in re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M):
        help_text = re.search(
            rf"^# HELP {re.escape(name)} (.*)$", text, re.M
        ).group(1)
        samples = re.findall(
            rf"^{re.escape(name)}(?:_total)?(?:{{[^}}]*}})? (\S+)$", text, re.M
        )
        key = name[: -len("_total")] if (
            kind == "counter" and name.endswith("_total")
        ) else name
        out[key] = (kind, help_text, samples)
    return out


@pytest.fixture(scope="module")
def family_pages(default_servers):
    """Each (package, frontend) server's families at the default flags."""
    return {
        key: _all_families(server.readiness_port)
        for key, server in default_servers.items()
    }


@pytest.mark.parametrize("front", ["python", "native"])
def test_default_flags_family_set_is_the_jax_packages(family_pages, front):
    """The port exports every family the JAX package exports, and its own
    device-errors family besides."""
    want = set(family_pages["jax", front])
    got = set(family_pages["port", front])
    assert got - want == PORT_ONLY
    assert want - got == set()
    assert {n for names in REPAIRED.values() for n in names} <= got


@pytest.mark.parametrize("front", ["python", "native"])
def test_default_flags_family_type_and_help_are_the_jax_packages(
    family_pages, front
):
    jax_fam, port_fam = family_pages["jax", front], family_pages["port", front]
    for name in set(jax_fam) & set(port_fam):
        assert port_fam[name][0] == jax_fam[name][0], name
        if name in CUDA_WORDED:
            assert port_fam[name][1] != jax_fam[name][1], name
        else:
            assert port_fam[name][1] == jax_fam[name][1], name


@pytest.mark.parametrize("group", sorted(REPAIRED))
@pytest.mark.parametrize("front", ["python", "native"])
def test_default_flags_repaired_family_values(family_pages, front, group):
    """The values: the predicate optimizer's facts equal the JAX server's
    on the same policies; the boot time to ready is the port's own (above
    0), a cold boot without a state store reads warm 0 and no degraded
    source, the store's families 0; the kernel-mode gauge 1 on the CPU,
    where K1 runs its plain version; the soak and columnar families 0."""
    jax_fam, port_fam = family_pages["jax", front], family_pages["port", front]
    values = {
        n: [float(v) for v in port_fam[n][2]] for n in REPAIRED[group]
    }
    assert all(len(v) == 1 for v in values.values()), values
    if group == "predicate":
        for n, v in values.items():
            assert v == [float(x) for x in jax_fam[n][2]], n
        assert sum(v[0] for v in values.values()) > 0
    elif group == "boot":
        assert values["policy_server_boot_time_to_ready_seconds"][0] > 0
        assert values["policy_server_boot_warm"] == [0.0]
        assert values["policy_server_boot_degraded_sources"] == [0.0]
    elif group == "kernel-mode":
        assert values == {"policy_server_pallas_interpret_mode": [1.0]}
    else:
        assert all(v == [0.0] for v in values.values()), values


def test_columnar_and_kernel_mode_families_after_kernel_traffic():
    """The JAX server and the port's, both on their Pallas path with the
    columnar transport off (``--kernel pallas --columnar off``; K1 in the
    port), after the same kernel-only traffic: the seven columnar
    families read 0 on both, and the kernel-mode gauge 1 on both (Pallas
    interpret mode there, K1's plain version here, on the CPU)."""
    from test_torch_native_frontend import (
        JaxServerHandle,
        corpus,
        pipelined,
        port_server,
        send_raw,
    )

    flags = dict(host_fastpath_threshold=0, verdict_cache_size=0)
    jmetrics.reset_metrics_for_tests()
    tmetrics.reset_metrics_for_tests()
    jax_s = JaxServerHandle(enable_metrics=True, kernel="pallas",
                            columnar=False, **flags)
    port_s = None
    try:
        port_s = port_server(frontend="python", columnar=False, **flags)
        work = corpus(7)[:64]
        pages = {}
        for name, server in (("jax", jax_s), ("port", port_s)):
            send_raw(server.port, pipelined(work), timeout=120)
            pages[name] = _all_families(server.readiness_port)
        assert float(pages["jax"]["policy_server_pallas_dispatches"][2][0]) > 0
        assert float(pages["port"]["policy_server_pallas_dispatches"][2][0]) > 0
        for n in REPAIRED["columnar"] + REPAIRED["kernel-mode"]:
            assert pages["port"][n] == pages["jax"][n], n
        assert pages["port"]["policy_server_pallas_interpret_mode"][2] == ["1.0"]
    finally:
        if port_s is not None:
            port_s.stop()
        jax_s.stop()
        jmetrics.reset_metrics_for_tests()
        tmetrics.reset_metrics_for_tests()
