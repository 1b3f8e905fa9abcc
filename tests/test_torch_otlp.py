"""The OTLP export of the PyTorch port (``policy_server_tpu_torch/
telemetry/otlp.py`` and its callers: ``tracing.span``, the batcher's
``policy_evaluation`` child spans, the two frontends' ``traceparent``, the
server's metrics pusher) against the JAX package's, over one in-process
gRPC collector (``tests/torch_otlp_collector.py``).

Each case of ``tests/test_otlp.py`` and ``tests/test_metrics_counters.py::
test_counters_survive_otlp_conversion`` runs through the JAX package, then
the port, against the same collector, and the decoded requests must agree
exactly (tolerance 0): span names, kinds, attribute sets and values (the
timed ``elapsed_ms`` by type only), status and parent links (a parent
inside the export by its name, one from a ``traceparent`` by its ids);
metric names, kinds, descriptions, units and points (attributes, values,
bucket counts and bounds). Then the port's own: a request's
``traceparent`` on both frontends against the JAX servers', the server's
metrics push against its /metrics pull, and the answer where grpcio is
missing (one ERROR line; serving and the pull carry on)."""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import threading
import time
import types
import urllib.request
from pathlib import Path

import pytest

import policy_server_tpu.telemetry.metrics as j_metrics
import policy_server_tpu.telemetry.otlp as j_otlp
import policy_server_tpu.telemetry.tracing as j_tracing
import policy_server_tpu_torch.telemetry.metrics as p_metrics
import policy_server_tpu_torch.telemetry.otlp as p_otlp
import policy_server_tpu_torch.telemetry.otlp_pb2 as pb
import policy_server_tpu_torch.telemetry.tracing as p_tracing
from torch_otlp_collector import Collector, attributes, counter_total

JAX = types.SimpleNamespace(name="jax", otlp=j_otlp, metrics=j_metrics,
                            tracing=j_tracing)
PORT = types.SimpleNamespace(name="port", otlp=p_otlp, metrics=p_metrics,
                             tracing=p_tracing)
SIDES = (JAX, PORT)
REPO = str(Path(__file__).resolve().parent.parent)
TIMED = {"elapsed_ms"}


@pytest.fixture()
def collector():
    c = Collector(pb)
    yield c
    c.stop()
    for side in SIDES:
        side.otlp.shutdown_for_tests()


@pytest.fixture(autouse=True)
def fresh_metrics():
    for side in SIDES:
        side.metrics.reset_metrics_for_tests()
    yield
    for side in SIDES:
        side.metrics.reset_metrics_for_tests()


def span_view(spans) -> list:
    """Spans without their ids and times: name, kind, attributes (a timed
    one by its type), status, and the parent link: a parent in the same
    export by its name (and whether the trace is the parent's), one from
    outside by its ids."""
    by_id = {s.span_id: s for s in spans}
    out = []
    for s in spans:
        if not s.parent_span_id:
            link = None
        elif s.parent_span_id in by_id:
            parent = by_id[s.parent_span_id]
            link = ("span", parent.name, parent.trace_id == s.trace_id)
        else:
            link = ("external", s.parent_span_id.hex(), s.trace_id.hex())
        attrs = sorted(
            (k, (v[0], None if k in TIMED else v[1]))
            for k, v in attributes(s.attributes).items()
        )
        out.append((s.name, s.kind, link, tuple(attrs), s.status.code,
                    s.status.message))
    return sorted(out, key=repr)


def metric_view(metrics) -> list:
    """Metrics without their times, points sorted by their attributes."""
    out = []
    for m in metrics:
        kind = m.WhichOneof("data")
        data = getattr(m, kind)
        points = []
        for p in data.data_points:
            attrs = tuple(sorted(
                (kv.key, kv.value.string_value) for kv in p.attributes
            ))
            if kind == "histogram":
                points.append((attrs, p.count, p.sum, tuple(p.bucket_counts),
                               tuple(p.explicit_bounds)))
            else:
                points.append((attrs, p.as_double))
        extra = (
            (data.is_monotonic, data.aggregation_temporality)
            if kind == "sum" else
            (data.aggregation_temporality,) if kind == "histogram" else ()
        )
        out.append((m.name, kind, m.description, m.unit, extra,
                    tuple(sorted(points, key=repr))))
    return sorted(out, key=repr)


def both(case, collector):
    """``case(side, collector)`` → the spans or metrics it exported, for
    the JAX package then the port (each side's pipeline torn down after
    its run): the two views must be equal."""
    views = []
    for side in SIDES:
        mark = collector.mark()
        try:
            views.append(case(side, collector, mark))
        finally:
            side.otlp.shutdown_for_tests()
    assert views[0] == views[1], views
    return views[1]


def _flush(side, collector) -> None:
    side.otlp._processor.force_flush()  # noqa: SLF001 — the test flushes
    assert collector.wait()


# -- tests/test_otlp.py ------------------------------------------------------


def test_span_pipeline_exports_to_collector(collector):
    def case(side, collector, mark):
        tracer = side.otlp.install_tracer(collector.endpoint)
        with tracer.start_span("validation") as sp:
            sp.set_attributes({
                "policy_id": "priv", "request_uid": "uid-1",
                "allowed": False, "response_code": 500,
            })
            # a child on another thread, its parent given explicitly (the
            # batcher's pattern)
            t = threading.Thread(
                target=side.otlp.emit_span,
                args=("policy_evaluation", sp.context, None,
                      {"policy_id": "priv", "batch_size": 4}),
            )
            t.start()
            t.join()
        _flush(side, collector)
        spans = collector.spans(mark)
        val = next(s for s in spans if s.name == "validation")
        child = next(s for s in spans if s.name == "policy_evaluation")
        assert child.trace_id == val.trace_id
        assert child.parent_span_id == val.span_id
        attrs = {kv.key: kv.value for kv in val.attributes}
        assert attrs["policy_id"].string_value == "priv"
        assert attrs["allowed"].bool_value is False
        assert attrs["response_code"].int_value == 500
        return span_view(spans)

    view = both(case, collector)
    assert {v[0] for v in view} == {"validation", "policy_evaluation"}
    assert collector.resource_service_names() == {"kubewarden-policy-server"}


def test_metrics_push_delivers_both_instruments(collector):
    def case(side, collector, mark):
        registry = side.metrics.setup_metrics()
        m = side.metrics.PolicyEvaluation(
            policy_name="priv", policy_mode="protect", resource_kind="Pod",
            resource_namespace="default", resource_request_operation="CREATE",
            accepted=True, mutated=False, request_origin="validate",
        )
        registry.add_policy_evaluation(m)
        registry.record_policy_latency(3.5, m)
        pusher = side.otlp.OtlpMetricsPusher(
            registry, side.otlp.OtlpExporter(collector.endpoint),
            interval_seconds=3600,
        )
        try:
            assert pusher.push_once()
            assert collector.wait()
        finally:
            pusher.shutdown()  # pushes the final state once more
        metrics = collector.metrics(mark)
        names = {m.name for m in metrics}
        assert side.metrics.EVALUATIONS_TOTAL in names
        assert side.metrics.LATENCY_MILLISECONDS in names
        total = next(m for m in metrics
                     if m.name == side.metrics.EVALUATIONS_TOTAL)
        assert total.sum.is_monotonic
        assert total.sum.data_points[0].as_double == 1.0
        labels = {kv.key: kv.value.string_value
                  for kv in total.sum.data_points[0].attributes}
        assert labels["policy_name"] == "priv" and labels["accepted"] == "true"
        hist = next(m for m in metrics
                    if m.name == side.metrics.LATENCY_MILLISECONDS)
        dp = hist.histogram.data_points[0]
        assert dp.count == 1 and dp.sum == pytest.approx(3.5)
        assert len(dp.bucket_counts) == len(dp.explicit_bounds) + 1
        assert sum(dp.bucket_counts) == dp.count
        return metric_view(metrics)

    view = both(case, collector)
    assert len(view) == 4  # two pushes of the two instruments


def _review(side):
    from conftest import build_admission_review_dict

    if side is JAX:
        from policy_server_tpu.models import AdmissionReviewRequest, ValidateRequest
    else:
        from policy_server_tpu_torch.models import (
            AdmissionReviewRequest,
            ValidateRequest,
        )
    return ValidateRequest.from_admission(
        AdmissionReviewRequest.from_dict(build_admission_review_dict()).request
    )


def test_batcher_emits_child_spans_with_propagated_trace_id(collector):
    from torch_port_support import jax_env, torch_env

    specs = {"priv": {"module": "builtin://pod-privileged"}}

    def case(side, collector, mark):
        if side is JAX:
            from policy_server_tpu.api.service import RequestOrigin
            from policy_server_tpu.runtime.batcher import MicroBatcher

            env = jax_env(specs)
        else:
            from policy_server_tpu_torch.api.service import RequestOrigin
            from policy_server_tpu_torch.runtime.batcher import MicroBatcher

            env = torch_env(specs)
        tracer = side.otlp.install_tracer(collector.endpoint)
        batcher = MicroBatcher(env, host_fastpath_threshold=0, max_batch_size=4,
                               batch_timeout_ms=1.0).start()
        try:
            with tracer.start_span("validation") as sp:
                fut = batcher.submit("priv", _review(side), RequestOrigin.VALIDATE)
                fut.result(timeout=60)
                trace_id = sp.context.trace_id
        finally:
            batcher.shutdown()
            env.close()
        _flush(side, collector)
        children = [s for s in collector.spans(mark)
                    if s.name == "policy_evaluation"]
        assert children and children[0].trace_id == trace_id
        return span_view(collector.spans(mark))

    view = both(case, collector)
    child = next(v for v in view if v[0] == "policy_evaluation")
    assert child[2] == ("span", "validation", True)
    assert dict(child[3]) == {
        "policy_id": ("string_value", "priv"),
        "batch_size": ("int_value", 1),
        "allowed": ("bool_value", True),
    }


TID = "4bf92f3577b34da6a3ce929d0e0e4736"
SID = "00f067aa0ba902b7"


def test_parse_traceparent_vectors():
    def case(side):
        ctx = side.otlp.parse_traceparent(f"00-{TID}-{SID}-01")
        assert ctx.trace_id == bytes.fromhex(TID)
        assert ctx.span_id == bytes.fromhex(SID)
        good = [f"00-{TID}-{SID}-01", f"  01-{TID}-{SID}-01-extra  "]
        bad = [
            None, "", "garbage", f"00-{TID}-{SID}", f"ff-{TID}-{SID}-01",
            f"00-{'0' * 32}-{SID}-01", f"00-{TID}-{'0' * 16}-01",
            f"00-{TID[:-2]}-{SID}-01", f"00-{TID}-{SID}zz-01",
            f"00-{TID}-{SID}-01-extra", f"00-{TID}-{SID}-zz",
            f"00-{TID}-{SID}-0", f"00-{TID[:-1]}�-{SID}-01",
        ]
        out = [side.otlp.parse_traceparent(v) for v in good + bad]
        return [(c.trace_id, c.span_id) if c else None for c in out]

    jax, port = case(JAX), case(PORT)
    assert port == jax
    assert all(port[:2]) and not any(port[2:])


def test_handler_span_parents_to_incoming_traceparent(collector):
    def case(side, collector, mark):
        side.otlp.install_tracer(collector.endpoint)
        parent = side.otlp.parse_traceparent(f"00-{TID}-{SID}-01")
        with side.tracing.span("validation", parent_ctx=parent, policy_id="priv"):
            pass
        _flush(side, collector)
        val = next(s for s in collector.spans(mark) if s.name == "validation")
        assert val.trace_id == bytes.fromhex(TID)
        assert val.parent_span_id == bytes.fromhex(SID)
        return span_view(collector.spans(mark))

    [view] = both(case, collector)
    assert view[2] == ("external", SID, TID)


def test_span_duration_matches_logged_elapsed_ms(collector):
    def case(side, collector, mark):
        side.otlp.install_tracer(collector.endpoint)
        with side.tracing.span("validation", policy_id="priv") as fields:
            time.sleep(0.02)
        _flush(side, collector)
        val = next(s for s in collector.spans(mark) if s.name == "validation")
        exported_ms = (val.end_time_unix_nano - val.start_time_unix_nano) / 1e6
        assert exported_ms == pytest.approx(fields["elapsed_ms"], abs=1e-6)
        attrs = {kv.key: kv.value for kv in val.attributes}
        assert attrs["elapsed_ms"].double_value == fields["elapsed_ms"]
        assert fields["trace_id"] == val.trace_id.hex()
        return span_view(collector.spans(mark))

    both(case, collector)


def test_explicit_end_time_survives_context_exit(collector):
    def case(side, collector, mark):
        tracer = side.otlp.install_tracer(collector.endpoint)
        with tracer.start_span("pinned") as sp:
            sp.data.end_unix_nano = sp.data.start_unix_nano + 12345
        _flush(side, collector)
        pinned = next(s for s in collector.spans(mark) if s.name == "pinned")
        assert pinned.end_time_unix_nano - pinned.start_time_unix_nano == 12345
        return span_view(collector.spans(mark))

    both(case, collector)


# -- tests/test_metrics_counters.py::test_counters_survive_otlp_conversion ----


def _pod_body(uid: str, privileged: bool) -> bytes:
    from conftest import build_admission_review_dict

    doc = build_admission_review_dict()
    doc["request"]["uid"] = uid
    doc["request"]["object"] = {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": "p", "namespace": "default"},
        "spec": {"containers": [{
            "name": "c", "image": "nginx",
            "securityContext": {"privileged": privileged},
        }]},
    }
    return json.dumps(doc).encode()


def _post(port: int, body: bytes, policy: str = "pod-privileged",
          traceparent: bytes | None = None) -> tuple:
    from test_torch_native_frontend import exchange, post_bytes

    extra = b"traceparent: " + traceparent + b"\r\n" if traceparent else b""
    payload = post_bytes(f"/validate/{policy}", body)
    head, _, rest = payload.partition(b"Connection: close\r\n")
    status, _headers, answer = exchange(
        port, head + extra + b"Connection: close\r\n" + rest
    )[0]
    return status, answer


def test_counters_survive_otlp_conversion(tmp_path):
    """The pusher converts the registry the pull reads: after the same
    three requests (a cold one, an exact replay, a fresh uid) every family
    the JAX test names comes through from both packages' registries, the
    two conversions give the same metric names and kinds (the port adds its
own CUDA-error counter), and the
    evaluation counter's points are equal."""
    from policy_server_tpu_torch.server import PolicyServer
    from policy_server_tpu_torch.models.policy import parse_policy_entry
    from torch_port_support import JaxServer

    specs = {"pod-privileged": {"module": "builtin://pod-privileged"}}
    jax_srv = JaxServer(specs, enable_metrics=True, host_fastpath_threshold=0,
                        policy_timeout_seconds=30.0)
    port_srv = PolicyServer(
        {k: parse_policy_entry(k, v) for k, v in specs.items()},
        port=0, readiness_probe_port=0, device="cpu", enable_metrics=True,
        host_fastpath_threshold=0, policy_timeout=30.0, max_batch_size=8,
    )
    port_srv.start()
    try:
        for port in (jax_srv.port, port_srv.port):
            for uid in ("u-1", "u-1", "u-2"):
                assert _post(port, _pod_body(uid, False))[0].startswith(
                    "HTTP/1.1 200"
                )
        time.sleep(0.2)
        now = time.time_ns()
        views = []
        for side, registry in (
            (JAX, j_metrics.default_registry().registry),
            (PORT, p_metrics.default_registry()),
        ):
            views.append(side.otlp.prometheus_to_otlp(
                registry, now - 10**9, now
            ))
    finally:
        jax_srv.stop()
        port_srv.stop()
    jax_metrics, port_metrics = views
    names = {m.name for m in port_metrics}
    for expected in (
        p_metrics.DEDUP_BLOB_HITS, p_metrics.VERDICT_CACHE_HITS,
        p_metrics.BATCH_DEDUP_HITS, p_metrics.HOST_ENCODE_SECONDS,
        p_metrics.DISPATCH_WAIT_SECONDS, p_metrics.DISPATCHED_ROWS,
        p_metrics.VERDICT_CACHE_BYTES, p_metrics.POLICY_RELOADS,
        p_metrics.POLICY_RELOAD_ROLLBACKS, p_metrics.RELOAD_CANARY_REPLAYS,
        p_metrics.POLICY_EPOCH, p_metrics.AUDIT_ROWS_SCANNED,
        p_metrics.AUDIT_PREEMPTIONS, p_metrics.AUDIT_REPORT_FRESHNESS,
        p_metrics.AUDIT_SNAPSHOT_BYTES,
    ):
        assert any(expected in n for n in names), (expected, names)

    def kinds(metrics) -> set:
        return {(m.name, m.WhichOneof("data")) for m in metrics}

    # the port's one family of its own: its CUDA errors (metrics.py)
    assert kinds(port_metrics) - kinds(jax_metrics) == {
        (p_metrics.DEVICE_ERRORS + "_total", "sum")
    }
    assert kinds(jax_metrics) <= kinds(port_metrics)

    def evaluations(metrics) -> list:
        return metric_view(
            [m for m in metrics if m.name == p_metrics.EVALUATIONS_TOTAL]
        )

    assert evaluations(port_metrics) == evaluations(jax_metrics)
    assert counter_total(next(
        m for m in port_metrics if m.name == p_metrics.EVALUATIONS_TOTAL
    )) == 3.0


# -- a traceparent on each frontend -------------------------------------------


def _traceparents(n: int, seed: int) -> list[bytes]:
    rng = random.Random(seed)
    return [
        f"00-{rng.getrandbits(128):032x}-{rng.getrandbits(64):016x}-01".encode()
        for _ in range(n)
    ]


BAD_TRACEPARENTS = [b"garbage", b"00-" + b"\xff" * 32 + b"-" + SID.encode() + b"-01"]


@pytest.mark.parametrize("frontend", ["python", "native"])
def test_traceparent_parents_the_spans_on_both_frontends(collector, frontend):
    """Requests with their own ``traceparent`` (and a malformed and a
    non-UTF-8 one) to the port's server and to the JAX server on the same
    frontend, with the span pipeline installed: every answer is 200, and
    the exported spans are the JAX server's: under the stdlib frontend
    (aiohttp in the JAX package) a ``validation`` span per request
    parented to its header and a ``policy_evaluation`` child; under the
    native frontend the ``policy_evaluation`` span alone, parented to the
    header, and none for a request without a usable one. Each server's
    ``stop()`` flushes its spans."""
    from policy_server_tpu_torch.models.policy import parse_policy_entry
    from policy_server_tpu_torch.server import PolicyServer
    from torch_port_support import JaxServer

    specs = {"pod-privileged": {"module": "builtin://pod-privileged"}}
    headers = _traceparents(6, seed=11) + BAD_TRACEPARENTS

    def case(side, collector, mark):
        side.otlp.install_tracer(collector.endpoint)
        if side is JAX:
            srv = JaxServer(specs, frontend=frontend,
                            policy_timeout_seconds=30.0)
            stop = srv.stop
        else:
            srv = PolicyServer(
                {k: parse_policy_entry(k, v) for k, v in specs.items()},
                port=0, readiness_probe_port=0, device="cpu",
                frontend=frontend, policy_timeout=30.0, max_batch_size=8,
            )
            srv.start()
            stop = srv.stop
        try:
            answers = [
                _post(srv.port, _pod_body(f"u{i}", i % 2 == 0), traceparent=tp)
                for i, tp in enumerate(headers)
            ]
        finally:
            stop()  # both servers' stop() flushes the spans
        assert all(s.startswith("HTTP/1.1 200") for s, _b in answers), answers
        spans = collector.spans(mark)
        for tp in headers[:6]:
            _v, tid, sid, _f = tp.decode().split("-")
            mine = [s for s in spans if s.trace_id.hex() == tid]
            assert mine, tp
            first = next(s for s in mine if s.parent_span_id.hex() == sid)
            assert first.name == (
                "validation" if frontend == "python" else "policy_evaluation"
            )
        return [b for _s, b in answers], span_view(spans)

    bodies, view = both(case, collector)
    names = sorted(v[0] for v in view)
    if frontend == "python":
        assert names == ["policy_evaluation"] * 8 + ["validation"] * 8
        roots = [v for v in view if v[0] == "validation" and v[2] is None]
        assert len(roots) == 2  # the two unusable headers: fresh roots
    else:
        assert names == ["policy_evaluation"] * 6
    assert [json.loads(b)["response"]["allowed"] for b in bodies] == [
        False, True, False, True, False, True, False, True,
    ]


def test_the_server_pushes_the_registry_its_pull_reads(collector, monkeypatch):
    """``--enable-metrics`` with ``OTEL_EXPORTER_OTLP_ENDPOINT`` set: the
    port's server pushes its registry, and the push made at ``stop()``
    carries the evaluation counter the /metrics pull read after the wave;
    the JAX server's push for the same requests carries the same points."""
    from policy_server_tpu_torch.models.policy import parse_policy_entry
    from policy_server_tpu_torch.server import PolicyServer
    from torch_port_support import JaxServer

    monkeypatch.setenv("OTEL_EXPORTER_OTLP_ENDPOINT", collector.endpoint)
    specs = {"pod-privileged": {"module": "builtin://pod-privileged"}}

    def case(side, collector, mark):
        if side is JAX:
            srv = JaxServer(specs, enable_metrics=True,
                            policy_timeout_seconds=30.0)
            readiness = srv.readiness_port
        else:
            srv = PolicyServer(
                {k: parse_policy_entry(k, v) for k, v in specs.items()},
                port=0, readiness_probe_port=0, device="cpu",
                enable_metrics=True, policy_timeout=30.0, max_batch_size=8,
            )
            srv.start()
            readiness = srv.readiness_port
        try:
            for i in range(5):
                assert _post(srv.port, _pod_body(f"m{i}", i == 0))[0].startswith(
                    "HTTP/1.1 200"
                )
            time.sleep(0.2)
            text = urllib.request.urlopen(
                f"http://127.0.0.1:{readiness}/metrics", timeout=10
            ).read().decode()
        finally:
            srv.stop()
        pulled = sum(
            float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
            if line.startswith(p_metrics.EVALUATIONS_TOTAL + "{")
        )
        pushed = collector.metrics(mark)
        last = [m for m in pushed if m.name == p_metrics.EVALUATIONS_TOTAL][-1]
        assert counter_total(last) == pulled == 5.0
        return metric_view([last])

    both(case, collector)


# -- without grpcio ------------------------------------------------------------

BLOCKED_GRPC = r"""
import importlib.abc, json, logging, sys, urllib.request


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "grpc" or name.startswith("grpc."):
            raise ImportError("No module named 'grpc'", name="grpc")
        return None


sys.meta_path.insert(0, Block())
from policy_server_tpu_torch.models.policy import parse_policy_entry
from policy_server_tpu_torch.server import PolicyServer
from policy_server_tpu_torch.telemetry import setup_tracing

setup_tracing("info", "otlp")
srv = PolicyServer(
    {"p": parse_policy_entry("p", {"module": "builtin://pod-privileged"})},
    port=0, readiness_probe_port=0, device="cpu", enable_metrics=True,
)
srv.start()
body = json.dumps(json.loads(sys.argv[1])).encode()
req = urllib.request.Request(
    f"http://127.0.0.1:{srv.port}/validate/p", data=body,
    headers={"Content-Type": "application/json",
             "traceparent": "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"},
)
answer = json.loads(urllib.request.urlopen(req, timeout=30).read())
pulled = urllib.request.urlopen(
    f"http://127.0.0.1:{srv.readiness_port}/metrics", timeout=30
).read().decode()
srv.stop()
print(json.dumps({
    "allowed": answer["response"]["allowed"],
    "pulled": "kubewarden_policy_evaluations_total{" in pulled,
    "grpc_loaded": "grpc" in sys.modules,
}))
logging.shutdown()
"""


def test_without_grpcio_one_error_line_then_json_logs_and_the_pull(tmp_path):
    """With ``grpc`` not importable, ``--log-fmt otlp`` and the metrics push
    each log one ERROR line naming what is missing, after which the
    request is served, its span line is logged as JSON, and /metrics
    answers."""
    from conftest import build_admission_review_dict

    env = dict(os.environ, OTEL_EXPORTER_OTLP_ENDPOINT="http://127.0.0.1:9")
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_GRPC,
         json.dumps(build_admission_review_dict())],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path), env=env,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"allowed": True, "pulled": True, "grpc_loaded": False}
    lines = [json.loads(line) for line in proc.stderr.splitlines()
             if line.startswith("{")]
    errors = [d["message"] for d in lines if d["level"] == "ERROR"]
    assert errors == [
        "--log-fmt otlp requested but grpcio/protobuf are not available "
        "(missing: grpcio); spans stay on JSON-lines logging only",
        "OTLP metrics push requested but grpcio/protobuf are not available "
        "(missing: grpcio); metrics stay on the Prometheus pull endpoint",
    ]
    spans = [d for d in lines if d["message"] == "validation"]
    assert len(spans) == 1 and "trace_id" not in spans[0]["fields"]
