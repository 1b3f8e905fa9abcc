"""The port's server surface around the serving path, on the CPU: the
readiness port (``/readiness``, ``/metrics``, ``/debug/timeline``), the
timeline on the API port, the pprof endpoints under ``--enable-pprof``,
the ``KUBEWARDEN_*`` environment variables of the flags, and
``python -m policy_server_tpu_torch`` serving both ports."""

from __future__ import annotations

import http.client
import json
import os
import re
import subprocess
import sys
import threading
import time

import pytest

from policy_server_tpu_torch.__main__ import build_cli, server_from_args
from policy_server_tpu_torch.api import profiling
from policy_server_tpu_torch.api.state import ApiServerState
from policy_server_tpu_torch.models import AdmissionReviewRequest, ValidateRequest
from policy_server_tpu_torch.models.policy import parse_policy_entry
from policy_server_tpu_torch.server import PolicyServer
from policy_server_tpu_torch.telemetry import flightrec, metrics

from torch_port_support import firehose_docs, torch_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPECS = {
    "pod-privileged": {"module": "builtin://pod-privileged"},
    "priv-monitor": {"module": "builtin://pod-privileged",
                     "policyMode": "monitor"},
    "trusted-repos": {
        "module": "builtin://trusted-repos",
        "settings": {"registries": {"allow": ["docker.io"]},
                     "tags": {"reject": ["latest"]}},
    },
    "group": {
        "expression": "unpriv() && trusted()",
        "message": "group rejected the request",
        "policies": {
            "unpriv": {"module": "builtin://pod-privileged"},
            "trusted": {"module": "builtin://trusted-repos",
                        "settings": {"registries": {"allow": ["docker.io"]}}},
        },
    },
}

N_REQUESTS = 24


def _policies() -> dict:
    return {k: parse_policy_entry(k, v) for k, v in SPECS.items()}


def _get(port: int, path: str) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _post(port: int, path: str, body: bytes) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _work() -> list[tuple[str, dict]]:
    ids = sorted(SPECS)
    return [
        (ids[i % len(ids)], d)
        for i, d in enumerate(firehose_docs(N_REQUESTS, seed=91, wide_every=5))
    ]


def _evaluations(port: int) -> tuple[float, float]:
    status, text = _get(port, "/metrics")
    assert status == 200
    total = rejected = 0.0
    for line in text.decode().splitlines():
        if line.startswith(metrics.EVALUATIONS_TOTAL + "{"):
            value = float(line.rpartition(" ")[2])
            total += value
            rejected += value * ('accepted="false"' in line)
    return total, rejected


@pytest.fixture(scope="module")
def server():
    """A kernel-only server (every batch through the device path's plain
    versions) with metrics, pprof and the recorder on, after N requests
    from concurrent clients."""
    metrics.reset_metrics_for_tests()
    s = PolicyServer(
        _policies(), port=0, readiness_probe_port=0, device="cpu",
        max_batch_size=8, batch_timeout_ms=5.0, host_fastpath_threshold=0,
        latency_budget_ms=0, enable_metrics=True, enable_pprof=True,
        recorder_row_sample_rate=1.0,
    )
    s.start()
    before = _evaluations(s.readiness_port)
    answers: list = [None] * N_REQUESTS
    work = _work()

    def client(k: int) -> None:
        for i in range(k, N_REQUESTS, 6):
            pid, doc = work[i]
            answers[i] = _post(s.port, f"/validate/{pid}", json.dumps(doc).encode())

    threads = [threading.Thread(target=client, args=(k,)) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    yield s, before, answers
    s.stop()
    metrics.reset_metrics_for_tests()


def test_readiness_on_the_readiness_port_only(server):
    s, _before, _answers = server
    assert _get(s.readiness_port, "/readiness") == (200, b"ok")
    status, body = _get(s.port, "/readiness")
    assert status == 404 and json.loads(body)["status"] == 404
    # not ready until the warmup has finished
    assert ApiServerState(s.env, s.batcher, ready=False).readiness()[0] == 503


def test_metrics_count_every_request_with_the_oracles_rejections(server):
    """/metrics on the readiness port counts one evaluation per answered
    request; the rejected ones are the oracle's verdicts before the
    mode's constraints (a monitor-mode rejection is answered allowed)."""
    s, before, answers = server
    assert all(status == 200 for status, _body in answers)
    oracle = torch_env(SPECS, backend="oracle")
    want_rejected = sum(
        not oracle.validate(pid, ValidateRequest.from_admission(
            AdmissionReviewRequest.from_dict(doc).request
        )).allowed
        for pid, doc in _work()
    )
    answered_rejected = sum(b'"allowed": false' in body for _s, body in answers)
    total, rejected = _evaluations(s.readiness_port)
    assert total - before[0] == N_REQUESTS
    assert rejected - before[1] == want_rejected > 0
    assert want_rejected > answered_rejected  # the monitor-mode policy


def test_metrics_expose_the_runtime_families_the_port_has(server):
    s, _before, _answers = server
    text = _get(s.readiness_port, "/metrics")[1].decode()
    types = dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))
    for name, kind in (
        ("policy_server_batches_dispatched_total", "counter"),
        ("policy_server_queue_depth", "gauge"),
        ("policy_server_queue_wait_seconds_total", "counter"),
        ("policy_server_verdict_cache_bytes", "gauge"),
        ("policy_server_breaker_trips_total", "counter"),
        ("policy_server_device_errors_total", "counter"),
        ("policy_server_pallas_buckets_armed", "gauge"),
        ("policy_server_flight_recorder_events_total", "counter"),
        ("policy_server_tail_exemplar_latency_seconds", "gauge"),
        ("policy_server_phase_latency_seconds", "histogram"),
        ("kubewarden_policy_evaluation_latency_milliseconds", "histogram"),
        # the native frontend's, zero under the standard-library frontend
        ("policy_server_native_http_requests_total", "counter"),
        ("policy_server_native_inflight_requests", "gauge"),
        ("policy_server_bulk_submits_total", "counter"),
        # the policy lifecycle's and the supervisor's
        ("policy_server_policy_reloads_total", "counter"),
        ("policy_server_policy_reload_failures_total", "counter"),
        ("policy_server_policy_reload_rollbacks_total", "counter"),
        ("policy_server_reload_canary_replays_total", "counter"),
        ("policy_server_reload_canary_divergences_total", "counter"),
        ("policy_server_policy_epoch", "gauge"),
        ("policy_server_selfheal_batcher_revives_total", "counter"),
        ("policy_server_selfheal_frontend_revives_total", "counter"),
        ("policy_server_worker_respawns_total", "counter"),
        ("policy_server_worker_respawn_backoff_seconds_total", "counter"),
        ("policy_server_worker_slots_given_up", "gauge"),
    ):
        assert types.get(name) == kind, name
    assert "policy_server_policy_epoch 0.0" in text
    assert "policy_server_native_http_requests_total 0.0" in text
    assert "policy_server_pallas_buckets_armed 2.0" in text
    batches = float(re.search(
        r"^policy_server_batches_dispatched_total (\S+)$", text, re.M
    ).group(1))
    assert batches >= N_REQUESTS / 8
    # the JAX package's audit, verdict-matrix and watch families, with
    # zeros at the default flags (--audit-mode off; freshness reads -1);
    # shedding, tenants and shards export theirs too
    from policy_server_tpu.telemetry import metrics as jax_metrics

    audit_names = [
        getattr(jax_metrics, k) for k in dir(jax_metrics)
        if k.startswith(("AUDIT_", "MATRIX_", "WATCH_"))
    ]
    assert len(audit_names) == 32
    exported = {n.removesuffix("_total") for n in types}
    assert set(audit_names) <= exported
    for name in audit_names:
        value = re.search(
            rf"^{name}(?:_total)? (\S+)$", text, re.M
        ).group(1)
        assert value == ("-1.0" if "freshness" in name else "0.0"), name
    for name, kind in (
        ("policy_server_shed_requests_total", "counter"),
        ("policy_server_expired_dropped_rows_total", "counter"),
        ("policy_server_tenant_shed_rows_total", "counter"),
        ("policy_server_tenants_serving", "gauge"),
        ("policy_server_shards_serving", "gauge"),
        ("policy_server_shard_fences_total", "counter"),
    ):
        assert types.get(name) == kind, name
    assert "policy_server_tenants_serving 0.0" in text
    assert "policy_server_shards_serving 1.0" in text


def test_timeline_is_chrome_trace_json_with_each_stamped_phase(server):
    s, _before, _answers = server
    for port in (s.readiness_port, s.port):
        status, body = _get(port, "/debug/timeline")
        assert status == 200
        doc = json.loads(body)
        phases = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
        assert {
            flightrec.PH_QUEUE_WAIT, flightrec.PH_FORM, flightrec.PH_DISPATCH,
            flightrec.PH_HANDOFF, flightrec.PH_DELIVER, flightrec.PH_PREPARE,
            flightrec.PH_BLOB_DEDUP, flightrec.PH_ENCODE,
            flightrec.PH_BOOKKEEPING, flightrec.PH_FETCH,
            flightrec.PH_MATERIALIZE, flightrec.PH_DEVICE_EXECUTE,
        } <= phases
        assert doc["otherData"]["rows_sampled"] >= N_REQUESTS
        assert any(e["pid"] == 2 for e in doc["traceEvents"])


def test_pprof_heap_returns_the_documents_keys(server):
    s, _before, _answers = server
    status, body = _get(s.port, "/debug/pprof/heap")
    assert status == 200
    doc = json.loads(body)
    assert set(doc) == {"devices", "host_top_allocations"}
    assert doc["devices"] == []  # no card here
    assert doc["host_top_allocations"]  # tracemalloc started by the flag


def test_pprof_cpu_is_single_flight(server):
    """A CPU profile while one runs answers 409; the running one answers
    collapsed stacks."""
    s, _before, _answers = server
    first: dict = {}

    def long_profile() -> None:
        first["answer"] = _get(s.port, "/debug/pprof/cpu?interval=1.5&frequency=50")

    t = threading.Thread(target=long_profile)
    t.start()
    try:
        deadline = time.monotonic() + 10
        while not profiling._cpu_lock.locked():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        status, body = _get(s.port, "/debug/pprof/cpu?interval=0.1")
        assert status == 409
        assert json.loads(body) == {
            "message": "a CPU profile is already being generated",
            "status": 409,
        }
    finally:
        t.join(30)
    assert not t.is_alive()
    status, body = first["answer"]
    assert status == 200 and body.strip()
    assert _get(s.port, "/debug/pprof/cpu?interval=x")[0] == 422


def test_pprof_and_timeline_are_off_when_not_asked_for():
    """Without --enable-pprof the pprof routes are not there; with
    --flight-recorder off /debug/timeline answers 404 on both ports."""
    s = PolicyServer(
        _policies(), port=0, readiness_probe_port=0, device="cpu",
        max_batch_size=2, flight_recorder=False,
    )
    s.start()
    try:
        assert flightrec.recorder() is None
        for path in ("/debug/pprof/heap", "/debug/pprof/cpu?interval=0.1"):
            assert _get(s.port, path)[0] == 404
        for port in (s.port, s.readiness_port):
            status, body = _get(port, "/debug/timeline")
            assert status == 404
            assert json.loads(body)["message"] == "the flight recorder is disabled"
        assert _get(s.readiness_port, "/readiness") == (200, b"ok")
    finally:
        s.stop()


def test_stop_uninstalls_the_servers_recorder():
    s = PolicyServer(
        _policies(), port=0, readiness_probe_port=0, device="cpu",
        max_batch_size=2, recorder_ring_events=100,
    )
    try:
        rec = flightrec.recorder()
        assert rec is not None and rec._cap == 128
        # the warmup ran under the recorder: its device waits are in it
        assert any(
            e["phase"] == flightrec.PH_DEVICE_EXECUTE for e in rec.snapshot()
        )
    finally:
        s.start()
        s.stop()
    assert flightrec.recorder() is None


@pytest.mark.parametrize(
    "env,value,attr,want",
    [
        ("KUBEWARDEN_PORT", "3101", "port", 3101),
        ("KUBEWARDEN_READINESS_PROBE_PORT", "8181", "readiness_probe_port", 8181),
        ("KUBEWARDEN_ENABLE_METRICS", "true", "enable_metrics", True),
        ("KUBEWARDEN_ENABLE_PPROF", "1", "enable_pprof", True),
        ("KUBEWARDEN_LOG_LEVEL", "debug", "log_level", "debug"),
        ("KUBEWARDEN_LOG_FMT", "json", "log_fmt", "json"),
        ("KUBEWARDEN_LOG_NO_COLOR", "yes", "log_no_color", True),
        ("KUBEWARDEN_FLIGHT_RECORDER", "off", "flight_recorder", "off"),
        ("KUBEWARDEN_RECORDER_RING_EVENTS", "4096", "recorder_ring_events", 4096),
        ("KUBEWARDEN_RECORDER_ROW_SAMPLE_RATE", "0.5",
         "recorder_row_sample_rate", 0.5),
        ("KUBEWARDEN_VERDICT_CACHE_SIZE", "1Mi", "verdict_cache_size", 1024**2),
        ("KUBEWARDEN_HOST_FASTPATH_THRESHOLD", "0", "host_fastpath_threshold", 0),
        ("KUBEWARDEN_POLICIES", "x.yml", "policies", "x.yml"),
    ],
)
def test_environment_variables_set_the_flags(monkeypatch, env, value, attr, want):
    defaults = build_cli().parse_args([])
    monkeypatch.setenv(env, value)
    args = build_cli().parse_args([])
    assert getattr(args, attr) == want != getattr(defaults, attr)
    # the command line still wins over the environment
    flag = "--" + attr.replace("_", "-")
    if not isinstance(want, bool):
        assert getattr(build_cli().parse_args([flag, str(getattr(defaults, attr))]),
                       attr) == getattr(defaults, attr)


def test_flag_defaults_are_the_reference_ports():
    args = build_cli().parse_args([])
    assert (args.port, args.readiness_probe_port) == (3000, 8081)
    assert (args.flight_recorder, args.enable_metrics, args.enable_pprof) == (
        "on", False, False
    )


def test_server_from_args_wires_the_flags(tmp_path):
    path = tmp_path / "policies.json"
    path.write_text(json.dumps(SPECS))
    args = build_cli().parse_args([
        "--policies", str(path), "--device", "cpu", "--port", "0",
        "--readiness-probe-port", "0", "--flight-recorder", "off",
        "--enable-pprof", "--max-batch-size", "4",
    ])
    s = server_from_args(args)
    try:
        assert s.state.enable_pprof and flightrec.recorder() is None
        assert s.batcher.max_batch_size == 4
        assert s.readiness_port not in (0, s.port)
    finally:
        s.start()
        s.stop()


def test_main_serves_validate_readiness_and_metrics(tmp_path):
    """``python -m policy_server_tpu_torch`` logs both bound ports and
    answers on each."""
    path = tmp_path / "policies.json"
    path.write_text(json.dumps(SPECS))
    env = dict(os.environ, KUBEWARDEN_LOG_NO_COLOR="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "policy_server_tpu_torch", "--policies",
         str(path), "--device", "cpu", "--addr", "127.0.0.1", "--port", "0",
         "--readiness-probe-port", "0", "--enable-metrics"],
        cwd=REPO, env=env, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = ""
        deadline = time.monotonic() + 120
        while "serving on" not in line:
            assert time.monotonic() < deadline and proc.poll() is None
            line = proc.stderr.readline()
        api, ready = map(int, re.search(
            r"serving on 127\.0\.0\.1:(\d+), readiness on (\d+)", line
        ).groups())
        doc = firehose_docs(1, seed=92)[0]
        status, body = _post(api, "/validate/pod-privileged", json.dumps(doc).encode())
        assert status == 200 and json.loads(body)["kind"] == "AdmissionReview"
        assert _get(ready, "/readiness") == (200, b"ok")
        status, text = _get(ready, "/metrics")
        assert status == 200
        assert f"{metrics.EVALUATIONS_TOTAL}{{" in text.decode()
    finally:
        proc.terminate()
        proc.wait(30)
        proc.stderr.close()


# -- the TLS and prefork-worker families -----------------------------------------

TLS_WORKER_FAMILIES = tuple(
    getattr(metrics, k) for k in dir(metrics) if k.startswith("TLS_")
) + (
    metrics.WORKER_RESPAWNS,
    metrics.WORKER_RESPAWN_BACKOFF_SECONDS,
    metrics.WORKER_SLOTS_GIVEN_UP,
)


def _families(port: int, names=TLS_WORKER_FAMILIES) -> dict:
    from prometheus_client.parser import text_string_to_metric_families

    text = _get(port, "/metrics")[1].decode()
    want = {n.removesuffix("_total") for n in names}
    return {
        fam.name: (fam.type, fam.documentation,
                   [(s.name, s.value) for s in fam.samples])
        for fam in text_string_to_metric_families(text)
        if fam.name in want
    }


def _tls_traffic(port: int, ctx, n: int) -> list[int]:
    """``n`` requests, each on its own TLS connection → the statuses."""
    import socket

    body = json.dumps(_pod_doc(False)).encode()
    out = []
    for _ in range(n):
        s = ctx.wrap_socket(socket.create_connection(("127.0.0.1", port), timeout=30))
        s.sendall(
            b"POST /validate/pod-privileged HTTP/1.1\r\nHost: t\r\n"
            b"Content-Length: %d\r\nConnection: close\r\n\r\n%s" % (len(body), body)
        )
        data = b""
        while chunk := s.recv(65536):
            data += chunk
        s.close()
        out.append(int(data.split(b" ", 2)[1]))
    return out


def _pod_doc(privileged: bool) -> dict:
    from torch_port_support import pod_doc

    return pod_doc(privileged=privileged)


def test_default_flags_carry_the_jax_tls_and_worker_families():
    """The ten TLS families and the three worker families, under the JAX
    package's names, types and help texts, with zeros at the default flags
    (plaintext, one HTTP process)."""
    from torch_port_support import JaxServer

    assert len(TLS_WORKER_FAMILIES) == 13
    jax = JaxServer(SPECS, enable_metrics=True)
    port = None
    try:
        port = PolicyServer(_policies(), port=0, readiness_probe_port=0,
                            device="cpu", enable_metrics=True)
        port.start()
        want = _families(jax.readiness_port)
        got = _families(port.readiness_port)
    finally:
        if port is not None:
            port.stop()
        jax.stop()
    assert len(got) == 13
    assert got == want
    assert all(v == 0 for _t, _d, samples in got.values() for _n, v in samples)


def test_tls_families_under_native_mtls_equal_the_jax_packages(tmp_path):
    """After the same mTLS traffic on both packages' native terminators:
    handshakes equal the connections opened, one generation, native
    termination 1; a cert-less client counts once in the failures; the
    expiry gauge is the identity's notAfter (the same certificate on both,
    read a moment apart)."""
    from policy_server_tpu.config.config import TlsConfig as JTlsConfig
    from policy_server_tpu.runtime import native_frontend as jnf
    from policy_server_tpu_torch.certs import TlsConfig
    from policy_server_tpu_torch.runtime import native_frontend as nf
    from torch_port_support import JaxServer, client_context, tls_material

    m = tls_material(tmp_path)
    mp = pytest.MonkeyPatch()
    mp.setattr(nf, "server_header", jnf.server_header)
    jax = JaxServer(SPECS, frontend="native", enable_metrics=True,
                    tls_config=JTlsConfig(cert_file=m["cert"], key_file=m["key"],
                                          client_ca_file=(m["ca"],)))
    port = None
    out = {}
    try:
        port = PolicyServer(
            _policies(), port=0, readiness_probe_port=0, device="cpu",
            enable_metrics=True, frontend="native",
            tls_config=TlsConfig(cert_file=m["cert"], key_file=m["key"],
                                 client_ca_file=(m["ca"],)),
        )
        port.start()
        good = client_context(m["good_cert"], m["good_key"])
        for name, api, ready in (
            ("jax", jax.port, jax.readiness_port),
            ("port", port.port, port.readiness_port),
        ):
            statuses = _tls_traffic(api, good, 6)
            try:  # refused at the handshake: an alert, or a bare close
                refused = not _tls_traffic(api, client_context(), 1)
            except (OSError, IndexError):
                refused = True
            assert refused
            time.sleep(0.3)
            out[name] = (statuses, _families(ready))
    finally:
        if port is not None:
            port.stop()
        jax.stop()
        mp.undo()
    expiry = "policy_server_tls_cert_expiry_seconds"
    (jt, jd, [(jn, jv)]) = out["jax"][1].pop(expiry)
    (pt, pd, [(pn, pv)]) = out["port"][1].pop(expiry)
    assert (pt, pd, pn) == (jt, jd, jn) and abs(pv - jv) < 30 and pv > 80000
    assert out["port"] == out["jax"]
    fams = out["port"][1]
    assert out["port"][0] == [200] * 6
    assert fams["policy_server_tls_handshakes_ok"][2][0][1] == 6
    assert fams["policy_server_tls_handshakes_failed"][2][0][1] == 1
    assert fams["policy_server_tls_native_termination"][2][0][1] == 1
    assert fams["policy_server_tls_generations"][2][0][1] == 1
