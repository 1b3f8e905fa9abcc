"""The prefork HTTP frontend: worker processes over the evaluation bridge,
and the zero-parse wire request.

``--http-workers N`` (N > 1) runs N - 1 worker processes beside the
serving process. Each binds the API port with ``SO_REUSEPORT`` (the kernel
spreads accepted connections over every process on the port) and does a
request's host work: HTTP framing, the AdmissionReview parse and its 422
answers, the span line and the response's headers. It forwards the parsed
request to the one evaluation process that owns the card over a
length-prefixed frame on a unix socket (:class:`EvaluationBridge`) and
writes the ``(status, body)`` it gets back. The serving process keeps
everything stateful: the environments, the batchers, metrics (scraped from
its readiness port). A worker imports no torch and boots in milliseconds;
a worker's crash loses only its own connections (the server's supervisor
respawns it).

Frame wire format (little-endian), the JAX package's
(``policy_server_tpu/runtime/frontend.py``) byte for byte::

    request:  u32 frame_len | u64 req_id | u8 origin | u16 policy_id_len
              | policy_id utf-8 | tail
    response: u32 frame_len | u64 req_id | u16 http_status | body bytes

``origin`` 0 = validate, 1 = validate_raw, 2 = audit (the tail is the raw
request body); 3 = validate and 4 = audit already parsed by the worker
(the tail is ``u32 header_len | header json | payload json``, where the
header holds uid, namespace, operation and kind, and the payload is
``json.dumps(AdmissionRequest.to_dict(), separators=(",", ":"))``). A
tenant-routed path crosses as ``"tenant/policy"`` in the policy-id field.
The frame has no header channel, so a shed (429) or fenced (503) answer's
Retry-After is rebuilt on the worker from ``retry_after_seconds`` in its
body (:func:`_shed_headers`).

Where the JAX package runs asyncio (and an aiohttp app in the worker),
this package runs threads and the standard library's HTTP server; the
frames are the same. ``python -m policy_server_tpu_torch.runtime.frontend
--socket S --addr A --port P [--frontend native]`` is a worker's entry.

:class:`WireValidateRequest` is the request of a parsed frame and of the
native frontend's records: the native encoder reads ``payload_json()``
straight from the wire bytes, and ``payload()`` parses them only for
host-side consumers (the oracle, pre-eval hooks, rule message callables,
mutators). A field the header does not carry (the object's kind and name,
which the audit snapshot keys rows by) is read from the full
``AdmissionRequest``, parsed from the payload once, on first use.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from concurrent.futures import Future
from http.server import ThreadingHTTPServer
from typing import Any, Mapping

from policy_server_tpu_torch.api.api_error import api_error_body
from policy_server_tpu_torch.api.http_common import (
    BodyError,
    JsonHandler,
    parse_admission_review_bytes,
    span_fields_from_admission,
)
from policy_server_tpu_torch.telemetry.tracing import logger, span

_REQ_HEADER = struct.Struct("<QBH")
_PARSED_EXTRA = struct.Struct("<I")  # header-json length, parsed frames only
_RESP_HEADER = struct.Struct("<QH")
_LEN = struct.Struct("<I")

ORIGIN_VALIDATE, ORIGIN_RAW, ORIGIN_AUDIT = 0, 1, 2
ORIGIN_VALIDATE_PARSED, ORIGIN_AUDIT_PARSED = 3, 4

MAX_FRAME = 32 * 1024 * 1024  # bridge frames (body + header + framing)

UNAVAILABLE_BODY = json.dumps(
    {"message": "evaluation backend unavailable"}
).encode()


def _shed_headers(status: int, payload: bytes) -> dict | None:
    """The Retry-After of a shed 429 or fenced 503, rebuilt from the
    ``retry_after_seconds`` its JSON body carries."""
    if status not in (429, 503):
        return None
    try:
        retry_after = json.loads(payload).get("retry_after_seconds")
    except (ValueError, AttributeError):
        return None
    if not retry_after:
        return None
    return {"Retry-After": str(retry_after)}


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    """``n`` bytes, or None at end of stream."""
    chunks = []
    while n:
        try:
            chunk = sock.recv(min(n, 1 << 20))
        except OSError:
            return None
        if not chunk:
            return None
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _read_frame(sock: socket.socket) -> bytes | None:
    raw_len = _recv_exact(sock, _LEN.size)
    if raw_len is None:
        return None
    (length,) = _LEN.unpack(raw_len)
    if length > MAX_FRAME:
        raise ValueError(f"frame of {length} bytes exceeds the limit")
    return _recv_exact(sock, length)


def _frame(payload: bytes) -> bytes:
    return _LEN.pack(len(payload)) + payload


def admission_header(adm: Any) -> bytes:
    """A parsed frame's header: the request fields the service layer
    reads."""
    return json.dumps(
        {
            "uid": adm.uid,
            "namespace": adm.namespace,
            "operation": adm.operation,
            "kind": adm.request_kind.kind if adm.request_kind else None,
        }
    ).encode()


def canonical_payload(adm: Any) -> bytes:
    """``to_dict()`` of the parsed request, not the body's own bytes: the
    payload must be byte-identical to the in-process path's."""
    return json.dumps(adm.to_dict(), separators=(",", ":")).encode()


# ---------------------------------------------------------------------------
# The zero-parse wire request
# ---------------------------------------------------------------------------


class _WireKind:
    __slots__ = ("kind",)

    def __init__(self, kind: str):
        self.kind = kind


class _WireAdmission:
    """The slice of AdmissionRequest the service layer reads (the
    always-accept namespace and the metric labels); any other field comes
    from the full request, parsed from the payload on first use."""

    __slots__ = ("uid", "namespace", "operation", "request_kind", "_owner",
                 "_full")

    def __init__(self, header: Mapping[str, Any], owner: "WireValidateRequest"):
        self.uid = str(header.get("uid") or "")
        self.namespace = header.get("namespace")
        self.operation = header.get("operation")
        kind = header.get("kind")
        self.request_kind = _WireKind(str(kind)) if kind else None
        self._owner = owner
        self._full = None

    def __getattr__(self, name: str) -> Any:
        # called only for what the header lacks (kind, name, object, ...)
        if name.startswith("_"):
            raise AttributeError(name)
        full = self._full
        if full is None:
            from policy_server_tpu_torch.models import AdmissionRequest

            full = self._full = AdmissionRequest.from_dict(
                self._owner.payload()
            )
        return getattr(full, name)


class WireValidateRequest:
    """ValidateRequest-compatible object whose payload stays as the wire
    JSON bytes; ``payload()`` materializes them lazily."""

    __slots__ = ("admission_request", "_payload_bytes", "_payload_cache")

    is_raw = False
    raw = None

    def __init__(self, header: Mapping[str, Any], payload_bytes: bytes):
        self.admission_request = _WireAdmission(header, self)
        self._payload_bytes = payload_bytes
        self._payload_cache = None

    def uid(self) -> str:
        return self.admission_request.uid

    def payload(self) -> Any:
        if self._payload_cache is None:
            self._payload_cache = json.loads(self._payload_bytes)
        return self._payload_cache

    def payload_json(self) -> bytes:
        return self._payload_bytes


# ---------------------------------------------------------------------------
# The evaluation process's side: the bridge
# ---------------------------------------------------------------------------


class _BridgeConnection:
    """One worker's connection: response frames are written under a lock
    (they come from the batchers' delivery threads) and a reader thread
    takes the request frames."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._lock = threading.Lock()
        self.thread: threading.Thread | None = None

    def reply(self, req_id: int, status: int, body: bytes) -> None:
        data = _frame(_RESP_HEADER.pack(req_id, status) + body)
        try:
            with self._lock:
                self.sock.sendall(data)
        except OSError:
            pass  # the worker went away: its connections went with it

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


class EvaluationBridge:
    """The unix-socket server inside the evaluation process. Each request
    frame is admitted to the batcher without blocking the connection
    (``submit_nowait``), and its answer frame is written when the batcher
    resolves it; frames of one connection may be answered out of order
    (``req_id`` correlates). Every failure after the request id is read
    answers the frame (an unanswered frame would hang its HTTP request); a
    frame too short to carry the header closes the connection, which fails
    every request the worker has in flight."""

    def __init__(self, state: Any, socket_path: str):
        self.state = state
        self.socket_path = socket_path
        self._listener: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._connections: set[_BridgeConnection] = set()  # guarded-by: _lock
        self._frames = 0  # guarded-by: _lock
        self._stopping = False

    def start(self) -> "EvaluationBridge":
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            listener.bind(self.socket_path)
            listener.listen(64)
        except OSError:
            listener.close()
            raise
        self._listener = listener
        self._thread = threading.Thread(
            target=self._accept_loop, name="bridge-accept", daemon=True
        )
        self._thread.start()
        return self

    def stats(self) -> dict[str, int]:
        """Request frames read, and the worker connections open."""
        with self._lock:
            return {"frames": self._frames,
                    "connections": len(self._connections)}

    def stop(self) -> None:
        """Stop accepting and close every connection: the workers see the
        end of stream, fail what they have in flight and reconnect later."""
        self._stopping = True
        if self._listener is not None:
            try:
                self._listener.shutdown(socket.SHUT_RDWR)  # wakes accept()
            except OSError:
                pass
            self._listener.close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            conns = list(self._connections)
            self._connections.clear()
        for conn in conns:
            conn.close()
        for conn in conns:
            if conn.thread is not None:
                conn.thread.join(timeout=5)

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return
            conn = _BridgeConnection(sock)
            with self._lock:
                if self._stopping:
                    conn.close()
                    return
                self._connections.add(conn)
            conn.thread = threading.Thread(
                target=self._serve_connection, args=(conn,),
                name="bridge-conn", daemon=True,
            )
            conn.thread.start()

    def _serve_connection(self, conn: _BridgeConnection) -> None:
        try:
            while True:
                try:
                    frame = _read_frame(conn.sock)
                except ValueError as e:
                    logger.error("bridge frame rejected: %s; closing", e)
                    return
                if frame is None or not self._handle_frame(frame, conn):
                    return
        finally:
            with self._lock:
                self._connections.discard(conn)
            conn.close()

    def _handle_frame(self, frame: bytes, conn: _BridgeConnection) -> bool:
        """Admit one frame → False when the connection must close."""
        try:
            req_id, origin_code, pid_len = _REQ_HEADER.unpack_from(frame)
        except struct.error:
            logger.error("malformed bridge frame (%d bytes); closing", len(frame))
            return False
        with self._lock:
            self._frames += 1
        try:
            offset = _REQ_HEADER.size
            policy_id = frame[offset : offset + pid_len].decode()
            answered = self._submit(
                origin_code, policy_id, frame[offset + pid_len :]
            )
        except Exception as e:  # noqa: BLE001 — the in-process JSON 500
            logger.error("bridge frame handling failed: %s", e)
            answered = (500, json.dumps(
                {"message": "Something went wrong"}
            ).encode())
        if isinstance(answered[0], int):
            conn.reply(req_id, *answered)
            return True
        kind, future = answered
        future.add_done_callback(
            lambda f: self._deliver(conn, req_id, kind, f)
        )
        return True

    @staticmethod
    def _deliver(conn: _BridgeConnection, req_id: int, kind: str, fut) -> None:
        from policy_server_tpu_torch.api.handlers import evaluation_answer

        try:
            status, body, _headers = evaluation_answer(kind, fut.result)
        except Exception as e:  # noqa: BLE001 — answer, never hang
            logger.error("bridge answer failed: %s", e)
            status, body = 500, api_error_body(500, "Something went wrong")
        conn.reply(req_id, status, body)

    def _submit(self, origin_code: int, policy_id: str, rest: bytes):
        """→ ``(status, body)`` answered now, or ``(kind, Future)``."""
        from policy_server_tpu_torch.api.service import RequestOrigin
        from policy_server_tpu_torch.models import (
            RawReviewRequest,
            ValidateRequest,
        )
        from policy_server_tpu_torch.runtime.native_frontend import route_policy

        if origin_code in (ORIGIN_VALIDATE_PARSED, ORIGIN_AUDIT_PARSED):
            batcher, policy_id, not_found = route_policy(self.state, policy_id)
            if batcher is None:
                return 404, not_found
            (hlen,) = _PARSED_EXTRA.unpack_from(rest)
            header = json.loads(
                rest[_PARSED_EXTRA.size : _PARSED_EXTRA.size + hlen]
            )
            request = WireValidateRequest(
                header, rest[_PARSED_EXTRA.size + hlen :]
            )
            audit = origin_code == ORIGIN_AUDIT_PARSED
            kind = "audit" if audit else "validate"
        else:
            # the JAX bridge's parse and 422 texts, for bodies it forwards
            # unparsed
            try:
                if origin_code == ORIGIN_RAW:
                    raw_review = RawReviewRequest.from_dict(json.loads(rest))
                    request = ValidateRequest.from_raw(raw_review.request)
                else:
                    review = parse_admission_review_bytes(rest)
                    request = ValidateRequest.from_admission(review.request)
            except BodyError as e:
                return 422, api_error_body(422, e.message)
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                return 422, api_error_body(
                    422, f"Failed to parse the request body as JSON: {e}"
                )
            except (KeyError, TypeError, ValueError, AttributeError) as e:
                return 422, api_error_body(
                    422, f"Failed to deserialize the JSON body: {e}"
                )
            audit = origin_code == ORIGIN_AUDIT
            kind = (
                "validate_raw" if origin_code == ORIGIN_RAW
                else "audit" if audit else "validate"
            )
            batcher, policy_id, not_found = route_policy(self.state, policy_id)
            if batcher is None:
                return 404, not_found
        origin = RequestOrigin.AUDIT if audit else RequestOrigin.VALIDATE
        try:
            future = batcher.submit_nowait(policy_id, request, origin)
        except Exception as e:  # noqa: BLE001 — a shed answers through the map
            future = Future()
            future.set_exception(e)
        return kind, future


# ---------------------------------------------------------------------------
# The worker's side
# ---------------------------------------------------------------------------


class BridgeClient:
    """Multiplexing client over one unix-socket connection. ``submit``
    returns a Future of ``(status, body)``; a reader thread bound to the
    connection resolves them. At the end of the connection's stream every
    request in flight on it fails with ``ConnectionError``, and the next
    call reconnects."""

    def __init__(self, socket_path: str):
        self.socket_path = socket_path
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None  # guarded-by: _lock
        # the pending map is scoped to its connection: a stale reader can
        # only fail its own requests
        self._pending: dict[int, Future] = {}  # guarded-by: _lock
        self._next_id = 0  # guarded-by: _lock
        self._dead = True  # guarded-by: _lock

    def connect(self) -> None:
        with self._lock:
            self._connect_locked()

    def _connect_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()
            self._sock = None
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.connect(self.socket_path)
        except OSError as e:
            sock.close()
            raise ConnectionError(f"evaluation bridge unavailable: {e}") from e
        pending: dict[int, Future] = {}
        self._sock = sock
        self._pending = pending
        self._dead = False
        threading.Thread(
            target=self._read_loop, args=(sock, pending),
            name="bridge-client-read", daemon=True,
        ).start()

    def _read_loop(self, sock: socket.socket, pending: dict[int, Future]) -> None:
        try:
            while True:
                frame = _read_frame(sock)
                if frame is None:
                    break
                req_id, status = _RESP_HEADER.unpack_from(frame)
                with self._lock:
                    fut = pending.pop(req_id, None)
                if fut is not None and not fut.done():
                    fut.set_result((status, frame[_RESP_HEADER.size :]))
        except Exception as e:  # noqa: BLE001 — ends the connection below
            logger.error("bridge client read failed: %s", e)
        finally:
            with self._lock:
                if pending is self._pending:
                    self._dead = True
                failed = list(pending.values())
                pending.clear()
            for fut in failed:
                if not fut.done():
                    fut.set_exception(
                        ConnectionError("evaluation bridge closed")
                    )

    def _submit(self, origin_code: int, policy_id: str, tail: bytes) -> Future:
        fut: Future = Future()
        pid = policy_id.encode()
        with self._lock:
            if self._dead or self._sock is None:
                self._connect_locked()
            self._next_id += 1
            req_id = self._next_id
            self._pending[req_id] = fut
            try:
                self._sock.sendall(_frame(
                    _REQ_HEADER.pack(req_id, origin_code, len(pid)) + pid + tail
                ))
            except OSError as e:
                self._pending.pop(req_id, None)
                self._dead = True
                raise ConnectionError(f"evaluation bridge closed: {e}") from e
        return fut

    def submit(self, origin_code: int, policy_id: str, body: bytes) -> Future:
        return self._submit(origin_code, policy_id, body)

    def submit_parsed(
        self, origin_code: int, policy_id: str, header: bytes, payload: bytes
    ) -> Future:
        return self._submit(
            origin_code, policy_id,
            _PARSED_EXTRA.pack(len(header)) + header + payload,
        )

    def call(self, origin_code: int, policy_id: str, body: bytes) -> tuple[int, bytes]:
        return self.submit(origin_code, policy_id, body).result()

    def call_parsed(
        self, origin_code: int, policy_id: str, header: bytes, payload: bytes
    ) -> tuple[int, bytes]:
        return self.submit_parsed(origin_code, policy_id, header, payload).result()

    def close(self) -> None:
        with self._lock:
            self._dead = True
            if self._sock is not None:
                try:
                    self._sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                self._sock.close()
                self._sock = None


# evaluation route → (parsed-frame origin or None for raw, span name)
_WORKER_ROUTES = {
    "validate": (ORIGIN_VALIDATE_PARSED, "validation"),
    "validate_raw": (None, "validation_raw"),
    "audit": (ORIGIN_AUDIT_PARSED, "audit"),
}


class WorkerHandler(JsonHandler):
    """A worker's API port: the three evaluation POSTs (and their tenant
    routes), parsed here and forwarded over the bridge; every other request
    answers 404, as the serving process's API port does for a path it
    lacks. ``self.server.bridge`` is the :class:`BridgeClient`."""

    def do_POST(self) -> None:  # noqa: N802 — http.server's hook name
        parts = self.path.split("?", 1)[0].strip("/").split("/")
        body = self._read_body()
        if body is None:
            return
        if (
            parts[0] not in _WORKER_ROUTES
            or len(parts) not in (2, 3)
            or not all(parts)
        ):
            self._not_found()
            return
        # a tenant route crosses as "tenant/policy"
        policy_id = "/".join(parts[1:])
        parsed_origin, span_name = _WORKER_ROUTES[parts[0]]
        bridge: BridgeClient = self.server.bridge  # type: ignore[attr-defined]
        hostname = self.server.hostname  # type: ignore[attr-defined]
        if parsed_origin is None:
            with span(span_name, host=hostname, policy_id=policy_id) as fields:
                self._forward(fields, lambda: bridge.call(
                    ORIGIN_RAW, policy_id, body
                ))
            return
        try:
            review = parse_admission_review_bytes(body)
        except BodyError as e:
            self._send_json(422, api_error_body(422, e.message))
            return
        adm = review.request
        with span(
            span_name, host=hostname, policy_id=policy_id,
            **span_fields_from_admission(review),
        ) as fields:
            self._forward(fields, lambda: bridge.call_parsed(
                parsed_origin, policy_id, admission_header(adm),
                canonical_payload(adm),
            ))

    def do_GET(self) -> None:  # noqa: N802
        self._not_found()

    def _forward(self, fields: dict, call: Any) -> None:
        try:
            status, payload = call()
        except ConnectionError:
            self._send_json(503, UNAVAILABLE_BODY)
            return
        fields["response_code"] = status
        self._send_json(status, payload, _shed_headers(status, payload))


class WorkerHttpServer(ThreadingHTTPServer):
    """A worker's standard-library server on the shared API port."""

    daemon_threads = True
    allow_reuse_address = True
    allow_reuse_port = True
    request_queue_size = 1024

    def __init__(
        self, addr: tuple[str, int], bridge: BridgeClient, hostname: str
    ) -> None:
        self.bridge = bridge
        self.hostname = hostname
        super().__init__(addr, WorkerHandler)


def _serve_native(bridge: BridgeClient, addr: str, port: int) -> None:
    """The worker as the owner of a native event loop: framing and the
    AdmissionReview parse run in C++ without the GIL, and its drained
    records cross the bridge (``native_frontend.BridgeSink``). A failed
    build, load or bind raises: the worker exits and the supervisor
    counts it."""
    import time

    from policy_server_tpu_torch.runtime import native_frontend as nf

    sock = nf.make_listen_socket(addr, port, reuse_port=True)
    try:
        front = nf.NativeFrontend(sock, nf.BridgeSink(bridge))
    except BaseException:
        sock.close()
        raise
    front.start()
    try:
        while True:  # until the server terminates this process
            time.sleep(3600)
    finally:
        front.stop_accepting()
        front.shutdown(timeout=2.0)


def main(argv: list[str] | None = None) -> int:
    """A worker process: ``python -m
    policy_server_tpu_torch.runtime.frontend``. SIGTERM ends it."""
    import argparse
    import signal
    import sys

    from policy_server_tpu_torch.telemetry.tracing import setup_tracing

    parser = argparse.ArgumentParser()
    parser.add_argument("--socket", required=True)
    parser.add_argument("--addr", required=True)
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--hostname", default="worker")
    parser.add_argument("--log-level", default="info")
    parser.add_argument("--log-fmt", default="text")
    parser.add_argument(
        "--frontend", default="python", choices=["python", "native"]
    )
    args = parser.parse_args(argv)
    setup_tracing(args.log_level, args.log_fmt)
    signal.signal(signal.SIGTERM, lambda _s, _f: sys.exit(0))
    bridge = BridgeClient(args.socket)
    bridge.connect()
    try:
        if args.frontend == "native":
            _serve_native(bridge, args.addr, args.port)
        else:
            httpd = WorkerHttpServer((args.addr, args.port), bridge, args.hostname)
            try:
                httpd.serve_forever()
            finally:
                httpd.server_close()
    except KeyboardInterrupt:
        pass
    finally:
        bridge.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
