"""An in-process OTLP gRPC collector (no JAX; ``chip_smoke.py`` uses it on
the card too): it records every trace and metrics Export request it is
sent. ``pb`` is an ``otlp_pb2`` module (the port's; the JAX package's is
the same bytes and shares its classes)."""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any


class Collector:
    """Records Export requests; ``spans()`` and ``metrics()`` decode them."""

    def __init__(self, pb: Any) -> None:
        import grpc

        self.pb = pb
        self.trace_requests: list = []
        self.metrics_requests: list = []
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._server = grpc.server(ThreadPoolExecutor(max_workers=2))

        def export_traces(request, context):
            with self._lock:
                self.trace_requests.append(request)
            self._event.set()
            return pb.ExportTraceServiceResponse()

        def export_metrics(request, context):
            with self._lock:
                self.metrics_requests.append(request)
            self._event.set()
            return pb.ExportMetricsServiceResponse()

        def service(name: str, fn, req, resp):
            return grpc.method_handlers_generic_handler(name, {
                "Export": grpc.unary_unary_rpc_method_handler(
                    fn, request_deserializer=req.FromString,
                    response_serializer=resp.SerializeToString,
                )
            })

        self._server.add_generic_rpc_handlers((
            service("opentelemetry.proto.collector.trace.v1.TraceService",
                    export_traces, pb.ExportTraceServiceRequest,
                    pb.ExportTraceServiceResponse),
            service("opentelemetry.proto.collector.metrics.v1.MetricsService",
                    export_metrics, pb.ExportMetricsServiceRequest,
                    pb.ExportMetricsServiceResponse),
        ))
        self.port = self._server.add_insecure_port("127.0.0.1:0")
        self._server.start()

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def wait(self, timeout: float = 10.0) -> bool:
        ok = self._event.wait(timeout)
        self._event.clear()
        return ok

    def mark(self) -> tuple[int, int]:
        """The number of requests seen so far (for ``spans(since=...)``)."""
        with self._lock:
            return len(self.trace_requests), len(self.metrics_requests)

    def spans(self, since: tuple[int, int] = (0, 0)) -> list:
        with self._lock:
            reqs = self.trace_requests[since[0]:]
        return [
            s for req in reqs for rs in req.resource_spans
            for ss in rs.scope_spans for s in ss.spans
        ]

    def metrics(self, since: tuple[int, int] = (0, 0)) -> list:
        with self._lock:
            reqs = self.metrics_requests[since[1]:]
        return [
            m for req in reqs for rm in req.resource_metrics
            for sm in rm.scope_metrics for m in sm.metrics
        ]

    def resource_service_names(self) -> set[str]:
        with self._lock:
            reqs = list(self.trace_requests) + list(self.metrics_requests)
        out = set()
        for req in reqs:
            containers = getattr(req, "resource_spans", None) or getattr(
                req, "resource_metrics"
            )
            for r in containers:
                for kv in r.resource.attributes:
                    if kv.key == "service.name":
                        out.add(kv.value.string_value)
        return out

    def stop(self) -> None:
        self._server.stop(grace=None)


def attributes(kvs) -> dict:
    """An OTLP attribute list → {key: (value field, value)}."""
    out = {}
    for kv in kvs:
        which = kv.value.WhichOneof("value")
        out[kv.key] = (which, getattr(kv.value, which) if which else None)
    return out


def counter_total(metric, match: dict | None = None) -> float:
    """The sum of a Sum metric's points whose string attributes match."""
    total = 0.0
    for p in metric.sum.data_points:
        attrs = {kv.key: kv.value.string_value for kv in p.attributes}
        if match and any(attrs.get(k) != v for k, v in match.items()):
            continue
        total += p.as_double
    return total
