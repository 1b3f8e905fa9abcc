"""Structured logging setup and request spans.

Counterpart of ``policy_server_tpu/telemetry/tracing.py``: the log formats
``text`` and ``json``, a level filter that keeps noisy dependencies at
WARNING, and ``span`` — a per-request field dict logged as one structured
line with its elapsed time. The service name is
``kubewarden-policy-server``.

The JAX package's ``otlp`` format also exports spans over OTLP gRPC; that
exporter is not ported (``ROADMAP.md``), so ``--log-fmt otlp`` logs the
same JSON lines and warns once that no span is exported.
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
    for name in _NOISY_LOGGERS:
        logging.getLogger(name).setLevel(max(level, logging.WARNING))
    log = logging.getLogger(SERVICE_NAME)
    if log_fmt == "otlp":
        log.warning(
            "--log-fmt otlp: the OTLP span exporter is not part of this "
            "package; logging JSON lines, exporting no span"
        )
    return log


logger = logging.getLogger(SERVICE_NAME)


@contextlib.contextmanager
def span(span_name: str, **fields: Any) -> Iterator[dict[str, Any]]:
    """A request span: yields a mutable field dict (the handlers record
    the verdict's fields into it) and logs one structured line on exit
    with the elapsed milliseconds."""
    start = time.perf_counter()
    data = dict(fields)
    try:
        yield data
    finally:
        data["elapsed_ms"] = round((time.perf_counter() - start) * 1e3, 3)
        logger.info(span_name, extra={"span_fields": data})
