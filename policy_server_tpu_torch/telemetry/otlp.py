"""OTLP gRPC export: spans and metrics pushed to a collector (the JAX
package's ``telemetry/otlp.py``).

* Spans: ``--log-fmt otlp`` installs a tracer (``install_tracer``) whose
  finished spans go through a batch processor (a queue of 4,096, batches of
  512, a flush every 2 s; a span that finds the queue full is dropped and
  counted) to the collector, under the service name
  ``kubewarden-policy-server``. Request spans come from
  ``telemetry.tracing.span``; the batcher's ``policy_evaluation`` child
  spans from ``emit_span``, whose parent travels explicitly across threads.
* Metrics: ``--enable-metrics`` with ``OTEL_EXPORTER_OTLP_ENDPOINT`` set
  installs a pusher (``install_metrics_pusher``) that converts the port's
  own registry (``telemetry/metrics.py``, the one the Prometheus pull
  reads) every 10 s: counters → monotonic cumulative Sum, gauges → Gauge,
  histograms → cumulative Histogram with explicit bounds.

Transport: grpcio's generic ``unary_unary`` against the two collector
method paths; the messages are ``otlp_pb2``, a byte-for-byte copy of the
JAX package's generated module (both register ``otlp.proto`` in
protobuf's default pool, and identical copies share their classes). The
endpoint is ``OTEL_EXPORTER_OTLP_ENDPOINT`` (default
``http://localhost:4317``); an ``https`` scheme means TLS, with the CA and
client pair from ``OTEL_EXPORTER_OTLP_CERTIFICATE``,
``..._CLIENT_CERTIFICATE`` and ``..._CLIENT_KEY``.

``grpc`` and ``google.protobuf`` are imported on the first install, never
when this module is imported. Where either is missing, the install logs
one ERROR line naming what is missing and returns None: logging carries on
in JSON lines and the metrics on the Prometheus pull.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import queue
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping

from policy_server_tpu_torch.telemetry.tracing import SERVICE_NAME, logger

# the export stack, imported by _load() on the first install
grpc: Any = None
pb: Any = None

# pb.Status codes (copies: pb is imported late)
STATUS_CODE_UNSET = 0
STATUS_CODE_ERROR = 2

TRACE_EXPORT_METHOD = (
    "/opentelemetry.proto.collector.trace.v1.TraceService/Export"
)
METRICS_EXPORT_METHOD = (
    "/opentelemetry.proto.collector.metrics.v1.MetricsService/Export"
)
ENDPOINT_ENV = "OTEL_EXPORTER_OTLP_ENDPOINT"
DEFAULT_ENDPOINT = "http://localhost:4317"
SCOPE_NAME = "policy-server-tpu"
TLS_ENV_PREFIX = "OTEL_EXPORTER_OTLP"


def configured_endpoint() -> str:
    return os.environ.get(ENDPOINT_ENV) or DEFAULT_ENDPOINT


def _load() -> list[str]:
    """Import grpc and the generated messages → the distributions that are
    missing (empty once loaded)."""
    global grpc, pb
    if grpc is not None and pb is not None:
        return []
    missing = []
    try:
        import grpc as grpc_module
    except ImportError:
        missing.append("grpcio")
    try:
        import google.protobuf  # noqa: F401 — the messages' runtime
    except ImportError:
        missing.append("protobuf")
    if missing:
        return missing
    from policy_server_tpu_torch.telemetry import otlp_pb2

    grpc, pb = grpc_module, otlp_pb2
    return []


def _unavailable(what: str, fallback: str) -> bool:
    """Load the export stack; where it is missing, log the one ERROR line
    and → True."""
    missing = _load()
    if missing:
        logger.error(
            "%s requested but grpcio/protobuf are not available (missing: "
            "%s); %s", what, ", ".join(missing), fallback,
        )
    return bool(missing)


def _any_value(v: Any) -> Any:
    if isinstance(v, bool):
        return pb.AnyValue(bool_value=v)
    if isinstance(v, int):
        return pb.AnyValue(int_value=v)
    if isinstance(v, float):
        return pb.AnyValue(double_value=v)
    return pb.AnyValue(string_value=str(v))


def _key_values(attrs: Mapping[str, Any]) -> list:
    return [
        pb.KeyValue(key=k, value=_any_value(v))
        for k, v in attrs.items()
        if v is not None
    ]


def _resource() -> Any:
    return pb.Resource(attributes=_key_values({"service.name": SERVICE_NAME}))


# -- spans ------------------------------------------------------------------


@dataclass
class SpanData:
    """One finished span, ready for export."""

    name: str
    trace_id: bytes
    span_id: bytes
    parent_span_id: bytes
    start_unix_nano: int
    end_unix_nano: int = 0
    attributes: dict[str, Any] = field(default_factory=dict)
    status_code: int = STATUS_CODE_UNSET
    status_message: str = ""

    def to_proto(self) -> Any:
        return pb.Span(
            trace_id=self.trace_id,
            span_id=self.span_id,
            parent_span_id=self.parent_span_id,
            name=self.name,
            kind=pb.Span.SPAN_KIND_SERVER
            if not self.parent_span_id
            else pb.Span.SPAN_KIND_INTERNAL,
            start_time_unix_nano=self.start_unix_nano,
            end_time_unix_nano=self.end_unix_nano,
            attributes=_key_values(self.attributes),
            status=pb.Status(code=self.status_code, message=self.status_message),
        )


@dataclass(frozen=True)
class SpanContext:
    """The identity of a live span, handed across threads (into the
    batcher) to parent child spans."""

    trace_id: bytes
    span_id: bytes


_current_span: contextvars.ContextVar[SpanContext | None] = (
    contextvars.ContextVar("otlp_current_span", default=None)
)


def current_span_context() -> SpanContext | None:
    return _current_span.get()


def parse_traceparent(value: str | None) -> SpanContext | None:
    """A W3C ``traceparent`` header → its SpanContext, or None for anything
    malformed (a fresh root, never a raise): a 2-hex version (ff reserved;
    version 00 has exactly four fields, later versions may append more), a
    32-hex trace id and a 16-hex span id, neither all zero, and 2-hex
    flags."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_hex, span_hex, flags = parts[0], parts[1], parts[2], parts[3]
    if len(version) != 2 or version.lower() == "ff":
        return None
    if version == "00" and len(parts) != 4:
        return None
    if len(trace_hex) != 32 or len(span_hex) != 16 or len(flags) != 2:
        return None
    try:
        bytes.fromhex(version)
        bytes.fromhex(flags)
        trace_id = bytes.fromhex(trace_hex)
        span_id = bytes.fromhex(span_hex)
    except ValueError:
        return None
    if trace_id == bytes(16) or span_id == bytes(8):
        return None
    return SpanContext(trace_id, span_id)


class Tracer:
    """Makes spans and hands finished ones to the batch processor."""

    def __init__(self, processor: "BatchSpanProcessor"):
        self.processor = processor

    def start_span(
        self,
        name: str,
        attributes: Mapping[str, Any] | None = None,
        parent: SpanContext | None = None,
    ) -> "ActiveSpan":
        if parent is None:
            parent = _current_span.get()
        trace_id = parent.trace_id if parent else secrets.token_bytes(16)
        return ActiveSpan(
            tracer=self,
            data=SpanData(
                name=name,
                trace_id=trace_id,
                span_id=secrets.token_bytes(8),
                parent_span_id=parent.span_id if parent else b"",
                start_unix_nano=time.time_ns(),
                attributes=dict(attributes or {}),
            ),
        )


class ActiveSpan:
    """Context manager for one span: the current span while it is open,
    with its SpanContext for cross-thread parents and mutable attributes."""

    def __init__(self, tracer: Tracer, data: SpanData):
        self.tracer = tracer
        self.data = data
        self._token: contextvars.Token | None = None

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.data.trace_id, self.data.span_id)

    def set_attributes(self, attrs: Mapping[str, Any]) -> None:
        self.data.attributes.update(
            {k: v for k, v in attrs.items() if v is not None}
        )

    def set_error(self, message: str) -> None:
        self.data.status_code = STATUS_CODE_ERROR
        self.data.status_message = message

    def __enter__(self) -> "ActiveSpan":
        self._token = _current_span.set(self.context)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _current_span.reset(self._token)
        if exc is not None and self.data.status_code == STATUS_CODE_UNSET:
            self.set_error(str(exc))
        # an end time the caller pinned (tracing.span pins start +
        # elapsed_ms) wins; only an unpinned span is stamped here
        if self.data.end_unix_nano == 0:
            self.data.end_unix_nano = time.time_ns()
        self.tracer.processor.on_end(self.data)


class BatchSpanProcessor:
    """A bounded queue and a background flusher: spans export in batches
    of ``max_batch`` or every ``interval_seconds``, off the request path.
    A span that finds the queue full is dropped and counted (``dropped``)."""

    def __init__(
        self,
        exporter: "OtlpExporter",
        interval_seconds: float = 2.0,
        max_batch: int = 512,
        max_queue: int = 4096,
    ):
        self.exporter = exporter
        self.interval = interval_seconds
        self.max_batch = max_batch
        self._queue: queue.Queue[SpanData] = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._wake = threading.Event()
        # on_end runs on every serving thread; the lock is taken only on a
        # full queue
        self._drop_lock = threading.Lock()
        self.dropped = 0  # guarded-by: _drop_lock
        self._thread = threading.Thread(
            target=self._loop, name="otlp-span-export", daemon=True
        )
        self._thread.start()

    def on_end(self, span: SpanData) -> None:
        try:
            self._queue.put_nowait(span)
        except queue.Full:
            with self._drop_lock:
                self.dropped += 1
        if self._queue.qsize() >= self.max_batch:
            self._wake.set()

    def _drain(self) -> list[SpanData]:
        out: list[SpanData] = []
        while len(out) < self.max_batch:
            try:
                out.append(self._queue.get_nowait())
            except queue.Empty:
                break
        return out

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=self.interval)
            self._wake.clear()
            batch = self._drain()
            if batch:
                self.exporter.export_spans(batch)

    def force_flush(self, timeout: float = 5.0) -> None:
        deadline = time.monotonic() + timeout
        while not self._queue.empty() and time.monotonic() < deadline:
            batch = self._drain()
            if batch:
                self.exporter.export_spans(batch)

    def shutdown(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5)
        self.force_flush()


# -- the exporter -------------------------------------------------------------


def _client_tls_files_from_env(prefix: str = TLS_ENV_PREFIX) -> dict[str, str]:
    """The exporter's TLS files from the environment: ``{prefix}_CERTIFICATE``
    (the CA), and ``{prefix}_CLIENT_CERTIFICATE`` with ``{prefix}_CLIENT_KEY``,
    both or neither."""
    ca = os.environ.get(f"{prefix}_CERTIFICATE")
    cert = os.environ.get(f"{prefix}_CLIENT_CERTIFICATE")
    key = os.environ.get(f"{prefix}_CLIENT_KEY")
    out: dict[str, str] = {}
    if ca:
        out["ca_file"] = ca
    if (cert is None) != (key is None):
        raise ValueError(
            f"{prefix}_CLIENT_CERTIFICATE and {prefix}_CLIENT_KEY must be "
            "set together"
        )
    if cert and key:
        out["cert_file"] = cert
        out["key_file"] = key
    return out


class OtlpExporter:
    """A thin gRPC client of the collector's two Export methods (the
    export stack must be loaded: ``install_*`` load it)."""

    def __init__(self, endpoint: str | None = None, timeout: float = 10.0):
        if _load():
            raise ImportError("the OTLP exporter needs grpcio and protobuf")
        endpoint = endpoint or configured_endpoint()
        self.timeout = timeout
        target, use_tls = self._parse(endpoint)
        if use_tls:
            self._channel = grpc.secure_channel(target, self._tls_credentials())
        else:
            self._channel = grpc.insecure_channel(target)
        self._export_traces = self._channel.unary_unary(
            TRACE_EXPORT_METHOD,
            request_serializer=pb.ExportTraceServiceRequest.SerializeToString,
            response_deserializer=pb.ExportTraceServiceResponse.FromString,
        )
        self._export_metrics = self._channel.unary_unary(
            METRICS_EXPORT_METHOD,
            request_serializer=pb.ExportMetricsServiceRequest.SerializeToString,
            response_deserializer=pb.ExportMetricsServiceResponse.FromString,
        )

    @staticmethod
    def _parse(endpoint: str) -> tuple[str, bool]:
        if endpoint.startswith("https://"):
            return endpoint[len("https://"):], True
        if endpoint.startswith("http://"):
            return endpoint[len("http://"):], False
        return endpoint, False

    @staticmethod
    def _tls_credentials() -> Any:
        files = _client_tls_files_from_env()

        def read(key: str) -> bytes | None:
            path = files.get(key)
            if not path:
                return None
            with open(path, "rb") as f:
                return f.read()

        return grpc.ssl_channel_credentials(
            root_certificates=read("ca_file"),
            private_key=read("key_file"),
            certificate_chain=read("cert_file"),
        )

    def export_spans(self, spans: Iterable[SpanData]) -> bool:
        req = pb.ExportTraceServiceRequest(
            resource_spans=[
                pb.ResourceSpans(
                    resource=_resource(),
                    scope_spans=[
                        pb.ScopeSpans(
                            scope=pb.InstrumentationScope(name=SCOPE_NAME),
                            spans=[s.to_proto() for s in spans],
                        )
                    ],
                )
            ]
        )
        try:
            self._export_traces(req, timeout=self.timeout)
            return True
        except grpc.RpcError as e:
            logger.warning("OTLP trace export failed: %s", e)
            return False

    def export_metrics(self, metrics: list) -> bool:
        req = pb.ExportMetricsServiceRequest(
            resource_metrics=[
                pb.ResourceMetrics(
                    resource=_resource(),
                    scope_metrics=[
                        pb.ScopeMetrics(
                            scope=pb.InstrumentationScope(name=SCOPE_NAME),
                            metrics=metrics,
                        )
                    ],
                )
            ]
        )
        try:
            self._export_metrics(req, timeout=self.timeout)
            return True
        except grpc.RpcError as e:
            logger.warning("OTLP metrics export failed: %s", e)
            return False

    def close(self) -> None:
        self._channel.close()


# -- the registry → OTLP metrics ---------------------------------------------


def prometheus_to_otlp(
    registry: Any, start_unix_nano: int, now_unix_nano: int
) -> list:
    """The cumulative state of the port's registry (``MetricsRegistry.
    collect()``, the families the /metrics pull writes) → OTLP metrics:
    counters → monotonic cumulative Sum, gauges → Gauge, histograms →
    cumulative Histogram with explicit bounds and per-bucket counts. A
    family with no sample is left out."""
    if _load():
        raise ImportError("the OTLP conversion needs grpcio and protobuf")
    out: list = []
    for family in registry.collect():
        if family.type == "counter":
            points = [
                pb.NumberDataPoint(
                    start_time_unix_nano=start_unix_nano,
                    time_unix_nano=now_unix_nano,
                    as_double=s.value,
                    attributes=_key_values(s.labels),
                )
                for s in family.samples
                if s.name.endswith("_total")
            ]
            if points:
                out.append(pb.Metric(
                    name=family.name + "_total"
                    if not family.name.endswith("_total") else family.name,
                    description=family.documentation,
                    sum=pb.Sum(
                        data_points=points,
                        aggregation_temporality=(
                            pb.AGGREGATION_TEMPORALITY_CUMULATIVE
                        ),
                        is_monotonic=True,
                    ),
                ))
        elif family.type == "gauge":
            points = [
                pb.NumberDataPoint(
                    start_time_unix_nano=start_unix_nano,
                    time_unix_nano=now_unix_nano,
                    as_double=s.value,
                    attributes=_key_values(s.labels),
                )
                for s in family.samples
            ]
            if points:
                out.append(pb.Metric(
                    name=family.name,
                    description=family.documentation,
                    gauge=pb.Gauge(data_points=points),
                ))
        elif family.type == "histogram":
            # the samples are per label set: _bucket{le}, _count, _sum
            grouped: dict[tuple, dict[str, Any]] = {}
            for s in family.samples:
                labels = {k: v for k, v in s.labels.items() if k != "le"}
                g = grouped.setdefault(
                    tuple(sorted(labels.items())),
                    {"labels": labels, "buckets": [], "sum": 0.0, "count": 0},
                )
                if s.name.endswith("_bucket"):
                    g["buckets"].append((float(s.labels["le"]), s.value))
                elif s.name.endswith("_sum"):
                    g["sum"] = s.value
                elif s.name.endswith("_count"):
                    g["count"] = s.value
            points = []
            for g in grouped.values():
                buckets = sorted(g["buckets"], key=lambda b: b[0])
                bounds = [b for b, _ in buckets if b != float("inf")]
                # OTLP's bucket counts are per bucket (Prometheus's are
                # cumulative) and include the overflow bucket
                counts, prev = [], 0
                for _b, v in buckets:
                    counts.append(int(v) - prev)
                    prev = int(v)
                points.append(pb.HistogramDataPoint(
                    start_time_unix_nano=start_unix_nano,
                    time_unix_nano=now_unix_nano,
                    count=int(g["count"]),
                    sum=g["sum"],
                    bucket_counts=counts,
                    explicit_bounds=bounds,
                    attributes=_key_values(g["labels"]),
                ))
            if points:
                out.append(pb.Metric(
                    name=family.name,
                    description=family.documentation,
                    unit="ms" if family.name.endswith("_milliseconds") else "",
                    histogram=pb.Histogram(
                        data_points=points,
                        aggregation_temporality=(
                            pb.AGGREGATION_TEMPORALITY_CUMULATIVE
                        ),
                    ),
                ))
    return out


class OtlpMetricsPusher:
    """Pushes the registry over OTLP every ``interval_seconds``, and once
    more at shutdown."""

    def __init__(
        self,
        registry: Any,  # telemetry.metrics.MetricsRegistry
        exporter: OtlpExporter,
        interval_seconds: float = 10.0,
    ):
        self.registry = registry
        self.exporter = exporter
        self.interval = interval_seconds
        self.start_unix_nano = time.time_ns()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="otlp-metrics-push", daemon=True
        )
        self._thread.start()

    def push_once(self) -> bool:
        metrics = prometheus_to_otlp(
            self.registry, self.start_unix_nano, time.time_ns()
        )
        if not metrics:
            return True
        return self.exporter.export_metrics(metrics)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.push_once()
            except Exception as e:  # noqa: BLE001 — the push never kills
                logger.warning("OTLP metrics push failed: %s", e)

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        with contextlib.suppress(Exception):
            self.push_once()  # the final state


# -- the process-wide pipeline -------------------------------------------------

_tracer: Tracer | None = None
_processor: BatchSpanProcessor | None = None
_pusher: OtlpMetricsPusher | None = None
_lock = threading.Lock()


def install_tracer(endpoint: str | None = None) -> Tracer | None:
    """Build and install the span pipeline (exporter → batch processor →
    tracer), once per process → the tracer, or None where the export stack
    is missing (logged at ERROR; JSON-lines logging carries on alone)."""
    global _tracer, _processor
    if _unavailable(
        "--log-fmt otlp", "spans stay on JSON-lines logging only"
    ):
        return None
    with _lock:
        if _tracer is None:
            _processor = BatchSpanProcessor(OtlpExporter(endpoint))
            _tracer = Tracer(_processor)
        return _tracer


def tracer() -> Tracer | None:
    return _tracer


def processor() -> BatchSpanProcessor | None:
    return _processor


def emit_span(
    name: str,
    parent: SpanContext | None,
    start_unix_nano: int | None,
    attributes: Mapping[str, Any],
    error: str | None = None,
) -> None:
    """A finished child span from any thread, its parent given explicitly
    (how the batcher carries trace ids across its threads); nothing without
    a tracer or a parent."""
    tr = _tracer
    if tr is None or parent is None:
        return
    now = time.time_ns()
    data = SpanData(
        name=name,
        trace_id=parent.trace_id,
        span_id=secrets.token_bytes(8),
        parent_span_id=parent.span_id,
        start_unix_nano=start_unix_nano or now,
        end_unix_nano=now,
        attributes={k: v for k, v in attributes.items() if v is not None},
    )
    if error is not None:
        data.status_code = STATUS_CODE_ERROR
        data.status_message = error
    tr.processor.on_end(data)


def install_metrics_pusher(
    registry: Any, endpoint: str | None = None, interval_seconds: float = 10.0
) -> OtlpMetricsPusher | None:
    """Install the metrics pusher over ``registry``, once per process → the
    pusher, or None where the export stack is missing (logged at ERROR; the
    Prometheus pull keeps serving alone)."""
    global _pusher
    if _unavailable(
        "OTLP metrics push", "metrics stay on the Prometheus pull endpoint"
    ):
        return None
    with _lock:
        if _pusher is None:
            _pusher = OtlpMetricsPusher(
                registry, OtlpExporter(endpoint), interval_seconds
            )
        return _pusher


def shutdown_pipeline() -> None:
    """Flush and tear down the span and metrics pipeline (the server's
    ``stop()``): buffered spans and the last metric state reach the
    collector before the process exits."""
    global _tracer, _processor, _pusher
    with _lock:
        if _processor is not None:
            _processor.shutdown()
        if _pusher is not None:
            _pusher.shutdown()
        _tracer = _processor = _pusher = None


def shutdown_for_tests() -> None:
    shutdown_pipeline()
