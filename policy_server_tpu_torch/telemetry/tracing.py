"""Structured logging setup and request spans.

Counterpart of ``policy_server_tpu/telemetry/tracing.py``: the log formats
``text``, ``json`` and ``otlp``, a level filter that keeps noisy
dependencies at WARNING, and ``span`` — a per-request field dict logged as
one structured line with its elapsed time. The service name is
``kubewarden-policy-server``.

``otlp`` logs the same JSON lines and also installs the OTLP span pipeline
(``telemetry/otlp.py``): every ``span`` then exports a real span to the
collector at ``OTEL_EXPORTER_OTLP_ENDPOINT``, parented to the caller's
``parent_ctx`` (a request's ``traceparent``), with its trace id added to
the log line. Where grpcio or protobuf is not installed, the install logs
one ERROR line and logging carries on alone.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import logging
import logging.handlers
import queue
import sys
import time
from typing import Any, Iterator

SERVICE_NAME = "kubewarden-policy-server"

_NOISY_LOGGERS = ("torch", "urllib3")

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "error": logging.ERROR,
}


class _TextFormatter(logging.Formatter):
    COLORS = {
        logging.DEBUG: "\x1b[36m",
        logging.INFO: "\x1b[32m",
        logging.WARNING: "\x1b[33m",
        logging.ERROR: "\x1b[31m",
    }
    RESET = "\x1b[0m"

    def __init__(self, color: bool) -> None:
        super().__init__()
        self.color = color

    def format(self, record: logging.LogRecord) -> str:
        ts = self.formatTime(record, "%Y-%m-%dT%H:%M:%S")
        level = record.levelname
        if self.color:
            c = self.COLORS.get(record.levelno, "")
            level = f"{c}{level}{self.RESET}"
        fields = getattr(record, "span_fields", None)
        tail = ""
        if fields:
            tail = " " + " ".join(f"{k}={v}" for k, v in fields.items())
        return f"{ts} {level} {record.name}: {record.getMessage()}{tail}"


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        doc: dict[str, Any] = {
            "timestamp": self.formatTime(record, "%Y-%m-%dT%H:%M:%S"),
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
            "service.name": SERVICE_NAME,
        }
        fields = getattr(record, "span_fields", None)
        if fields:
            doc["fields"] = fields
        return json.dumps(doc, default=str)


def setup_tracing(
    log_level: str = "info", log_fmt: str = "text", no_color: bool = False
) -> logging.Logger:
    """Configure the root logger. Emission is asynchronous: the handler
    hangs off a QueueListener thread, so a request's span line costs the
    serving thread one queue put instead of formatting and writing."""
    level = _LEVELS.get(log_level, logging.INFO)
    root = logging.getLogger()
    root.setLevel(level)
    for h in list(root.handlers):
        root.removeHandler(h)
        old_stop = getattr(h, "_span_listener_stop", None)
        if old_stop is not None:
            old_stop()
    handler = logging.StreamHandler(sys.stderr)
    if log_fmt == "text":
        handler.setFormatter(_TextFormatter(color=not no_color))
    else:  # json and otlp share the JSON-lines log structure
        handler.setFormatter(_JsonFormatter())
    log_queue: queue.SimpleQueue = queue.SimpleQueue()
    queue_handler = logging.handlers.QueueHandler(log_queue)
    listener = logging.handlers.QueueListener(
        log_queue, handler, respect_handler_level=False
    )
    listener.start()

    def stop_listener() -> None:
        if getattr(listener, "_stopped", False):
            return
        listener._stopped = True  # type: ignore[attr-defined]
        listener.stop()  # flushes everything enqueued before the sentinel
        # atexit runs LIFO: handlers registered earlier may still log
        # after this stop; write their stragglers synchronously
        while True:
            try:
                record = log_queue.get_nowait()
            except queue.Empty:
                break
            if record is not None:
                handler.handle(record)

    atexit.register(stop_listener)
    queue_handler._span_listener_stop = stop_listener  # type: ignore[attr-defined]
    root.addHandler(queue_handler)
    if log_fmt == "otlp":
        # the span pipeline (exporter → batch processor → tracer); the
        # JSON lines above stay on for correlation
        from policy_server_tpu_torch.telemetry import otlp

        otlp.install_tracer()
    for name in _NOISY_LOGGERS:
        logging.getLogger(name).setLevel(max(level, logging.WARNING))
    return logging.getLogger(SERVICE_NAME)


logger = logging.getLogger(SERVICE_NAME)


@contextlib.contextmanager
def span(
    span_name: str, parent_ctx: Any = None, **fields: Any
) -> Iterator[dict[str, Any]]:
    """A request span: yields a mutable field dict (the handlers record
    the verdict's fields into it) and logs one structured line on exit
    with the elapsed milliseconds. Where the OTLP pipeline is installed, a
    real span of the same name and fields is exported, parented to
    ``parent_ctx`` (an ``otlp.SpanContext``; None parents it to the
    current span, if any), and its trace id joins the log line. The
    exported end time is pinned to start + ``elapsed_ms``, so the exported
    duration and the logged one agree."""
    from policy_server_tpu_torch.telemetry import otlp

    start = time.perf_counter()
    data = dict(fields)
    tr = otlp.tracer()
    active = (
        tr.start_span(span_name, parent=parent_ctx) if tr is not None else None
    )
    with active if active is not None else contextlib.nullcontext():
        try:
            yield data
        finally:
            elapsed_ms = round((time.perf_counter() - start) * 1e3, 3)
            data["elapsed_ms"] = elapsed_ms
            if active is not None:
                active.set_attributes(data)
                data["trace_id"] = active.context.trace_id.hex()
                active.data.end_unix_nano = (
                    active.data.start_unix_nano + int(elapsed_ms * 1e6)
                )
            logger.info(span_name, extra={"span_fields": data})
