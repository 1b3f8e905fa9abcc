"""HTTP handlers on the standard library's ``http.server``, for the API
port and the readiness port (the JAX package's ``build_router`` and
``build_readiness_router``).

API port (``ApiHandler``):

* POST ``/validate/{policy_id}``     → the AdmissionReview response
* POST ``/validate_raw/{policy_id}`` → the raw review response
* POST ``/audit/{policy_id}``        → the AdmissionReview response of an
  audit-origin evaluation (no mode or mutation constraints)
* POST ``/{validate,validate_raw,audit}/{tenant}/{policy_id}`` → the same,
  served by that tenant's batcher under ``--tenants`` (``tenancy.py``); 404
  ``unknown tenant: {tenant}`` for a name the manifest lacks (every name,
  without one)
* GET  ``/audit/reports[/{namespace}]`` → the audit scanner's report
  rows and summary (404 "the background audit scanner is disabled" under
  ``--audit-mode off``), with an ETag; a matching If-None-Match → 304
* GET  ``/audit/stream[?cursor=N]``  → the verdict matrix's changelog as
  chunked ``application/x-ndjson``, one entry a line (404 "the verdict
  matrix is disabled" without ``--audit-matrix``, 422 for a cursor that is
  not an integer, 503 at ``--audit-stream-max-clients``); a client whose
  queue overflowed gets an OVERFLOW line and the stream ends. The literal
  ``reports`` and ``stream`` routes come before ``/audit/{policy_id}``.
* GET  ``/debug/timeline``           → the flight recorder's Chrome trace
  JSON (404 when the recorder is off)
* GET  ``/debug/pprof/cpu?interval=&frequency=`` and ``/debug/pprof/heap``
  under ``--enable-pprof`` (a second CPU profile while one runs: 409)

Readiness port (``ReadinessHandler``):

* GET ``/readiness`` → ``ok`` (with the device breaker's counters once it
  has tripped or a device error was seen; 503 while it is open under
  ``--degraded-mode reject``, and before the first policy epoch is built
  and warmed; under ``--tenants``, 503 only when every tenant is degraded)
* GET ``/readiness/{tenant}`` → that tenant's own verdict (404 for an
  unknown tenant)
* GET ``/metrics``   → the process registry in Prometheus text format
* GET ``/audit/reports[/{namespace}]`` and ``/audit/stream``, as on the API
  port (also under ``--frontend native``, whose API port answers only the
  evaluation POSTs)
* GET ``/debug/timeline``, as on the API port
* POST ``/policies/reload`` (202), ``/policies/promote`` and
  ``/policies/rollback`` → the policy lifecycle's admin actions
  (``lifecycle.py``), behind ``Authorization: Bearer <--reload-admin-token>``:
  404 when reload is off, 403 when no token is configured, 401 for a
  missing or wrong bearer, 409 with the rejection's text when the
  lifecycle refuses. Promote and rollback run on the handler's thread.

The native frontend (``runtime/native_frontend.py``) serves the same
evaluation routes with the same bytes when ``--frontend native``.

Error mapping: a malformed JSON body → 422 ``{"message", "status"}``;
PolicyNotFound → 404; a ``ShedError`` (load shed at admission or a tenant's
quota) → 429, and its ``FencedError`` (a fenced serving shard) → 503, each
with ``Retry-After`` and ``{"message", "retry_after_seconds"}``; any other
evaluation error → 500 "Something went wrong". Overload of the queue (429),
an expired deadline (504) and shutdown (503) are in-band answers of the
batcher, inside a 200 AdmissionReview. Bodies are ``json.dumps`` of the response dict with the default
separators, byte for byte what the JAX package's aiohttp frontend writes;
a ``FragVerdict`` (a cache hit answered from a pre-built template) writes
the bytes of ``FragTemplate.to_response(uid)``. Each evaluation runs in a
request span (``telemetry.tracing.span``) with the JAX package's fields.
"""

from __future__ import annotations

import hmac
import json
import select
import socket
from typing import Any
from urllib.parse import parse_qs, unquote

from policy_server_tpu_torch.api import profiling
from policy_server_tpu_torch.api.api_error import (
    ShedError,
    api_error_body,
    shed_answer,
    something_went_wrong,
)
from policy_server_tpu_torch.api.http_common import (
    JSON_CONTENT_TYPE as _JSON,
    TEXT_CONTENT_TYPE as _TEXT,
    BodyError,
    JsonHandler,
    parse_admission_review_bytes,
    parse_raw_review_bytes,
    span_fields_from_admission as _span_fields_from_admission,
)
from policy_server_tpu_torch.api.service import RequestOrigin
from policy_server_tpu_torch.api.state import ApiServerState, readiness
from policy_server_tpu_torch.evaluation.errors import PolicyNotFoundError
from policy_server_tpu_torch.models import (
    AdmissionReviewResponse,
    RawReviewResponse,
    ValidateRequest,
)
from policy_server_tpu_torch.models.admission import FragVerdict
from policy_server_tpu_torch.telemetry import default_registry, flightrec
from policy_server_tpu_torch.telemetry.tracing import logger, span
from policy_server_tpu_torch.tenancy import lookup_tenant, unknown_tenant_message

__all__ = [
    "ApiHandler",
    "ReadinessHandler",
    "admin_gate",
    "evaluate_body",
    "evaluation_answer",
    "lifecycle_action",
    "policies_reload",
    "readiness",
]

def _record_response(fields: dict, response: Any) -> None:
    """The verdict's fields on the request span."""
    fields["allowed"] = response.allowed
    fields["mutated"] = response.patch is not None
    if response.status:
        if response.status.code is not None:
            fields["response_code"] = response.status.code
        if response.status.message:
            fields["response_message"] = response.status.message


# evaluation route → (span name, origin)
EVALUATION_ROUTES = {
    "validate": ("validation", RequestOrigin.VALIDATE),
    "validate_raw": ("validation_raw", RequestOrigin.VALIDATE),
    "audit": ("audit", RequestOrigin.AUDIT),
}


def evaluation_answer(
    kind: str, get_result: Any, span_fields: dict | None = None
) -> tuple[int, bytes, dict[str, str] | None]:
    """An evaluation's answer → (status, response body, headers):
    ``get_result()`` returns the batcher's result or raises, and its error
    maps as in the module docstring. The headers are a shed or fenced
    answer's Retry-After, else None. The verdict goes on ``span_fields``
    when given."""
    try:
        result = get_result()
    except ShedError as e:
        status, retry, body = shed_answer(e)
        return status, body, {"Retry-After": str(retry)}
    except PolicyNotFoundError as e:
        return 404, api_error_body(404, str(e)), None
    except Exception as e:  # noqa: BLE001 — keep the JSON error contract
        logger.error("Evaluation error: %s", e)
        return *something_went_wrong(), None
    if type(result) is FragVerdict:
        result = result.to_response()
    if span_fields is not None:
        _record_response(span_fields, result)
    envelope = (
        RawReviewResponse(result)
        if kind == "validate_raw"
        else AdmissionReviewResponse(result)
    )
    return 200, json.dumps(envelope.to_dict()).encode(), None


def evaluate_body(
    batcher: Any, kind: str, policy_id: str, body: bytes, hostname: str = ""
) -> tuple[int, bytes, dict[str, str] | None]:
    """One POST body → (status, response body, headers). ``kind`` is
    ``validate``, ``validate_raw`` or ``audit``. The headers are a shed or
    fenced answer's Retry-After, else None."""
    span_name, origin = EVALUATION_ROUTES[kind]
    try:
        if kind == "validate_raw":
            raw = parse_raw_review_bytes(body)
            request = ValidateRequest.from_raw(raw.request)
            fields = {}
        else:
            review = parse_admission_review_bytes(body)
            request = ValidateRequest.from_admission(review.request)
            fields = _span_fields_from_admission(review)
    except BodyError as e:
        return 422, api_error_body(422, e.message), None
    with span(
        span_name, host=hostname, policy_id=policy_id, **fields,
    ) as span_fields:
        return evaluation_answer(
            kind,
            lambda: batcher.submit(policy_id, request, origin).result(),
            span_fields,
        )


def _pprof_cpu(query: str) -> tuple[int, bytes, str]:
    """GET /debug/pprof/cpu?interval=&frequency= (seconds, Hz)."""
    params = parse_qs(query)
    try:
        interval = float(
            params.get("interval", [profiling.DEFAULT_PROFILING_INTERVAL])[0]
        )
        frequency = int(
            params.get("frequency", [profiling.DEFAULT_PROFILING_FREQUENCY])[0]
        )
    except ValueError:
        return 422, api_error_body(
            422, "invalid 'interval'/'frequency' query parameter"
        ), _JSON
    try:
        profile = profiling.start_one_cpu_profile(interval, frequency)
    except profiling.ProfileInProgress as e:
        return 409, api_error_body(409, str(e)), _JSON
    except Exception as e:  # noqa: BLE001 — keep the JSON error contract
        logger.error("pprof error: %s", e)
        return (*something_went_wrong(), _JSON)
    return 200, profile.text.encode(), "application/octet-stream"


def _pprof_heap() -> tuple[int, bytes, str]:
    """GET /debug/pprof/heap: host allocations and each card's memory."""
    try:
        return 200, profiling.heap_profile(), _JSON
    except Exception as e:  # noqa: BLE001 — keep the JSON error contract
        logger.error("pprof error: %s", e)
        return (*something_went_wrong(), _JSON)


def admin_gate(state: ApiServerState, authorization: str) -> tuple[int, bytes] | None:
    """The /policies/* endpoints' gate: a token must be configured
    (``--reload-admin-token``) and presented as a bearer; None lets the
    request through."""
    if state.lifecycle is None:
        return 404, api_error_body(404, "policy hot reload is disabled")
    if not state.admin_token:
        return 403, api_error_body(
            403,
            "policy admin endpoints disabled: --reload-admin-token is "
            "not configured",
        )
    if not hmac.compare_digest(authorization, f"Bearer {state.admin_token}"):
        return 401, api_error_body(401, "invalid or missing bearer token")
    return None


def policies_reload(state: ApiServerState, authorization: str) -> tuple[int, bytes]:
    """POST /policies/reload: start a background reload → 202."""
    denied = admin_gate(state, authorization)
    if denied is not None:
        return denied
    started = state.lifecycle.request_reload("admin-endpoint")
    body = {
        "status": "reload started" if started else "reload already in progress",
        "epoch": state.lifecycle.current_epoch,
    }
    return 202, json.dumps(body).encode()


def lifecycle_action(
    state: ApiServerState, authorization: str, action: str
) -> tuple[int, bytes]:
    """POST /policies/promote (``promote_staged``) and /policies/rollback
    (``rollback``), run on the calling thread; a rejection → 409."""
    from policy_server_tpu_torch.lifecycle import ReloadRejected

    denied = admin_gate(state, authorization)
    if denied is not None:
        return denied
    try:
        outcome = getattr(state.lifecycle, action)()
    except ReloadRejected as e:
        return 409, api_error_body(409, str(e))
    except Exception as e:  # noqa: BLE001 — keep the JSON error contract
        logger.error("policy %s failed: %s", action, e)
        return something_went_wrong()
    body = {"status": outcome, "epoch": state.lifecycle.current_epoch}
    return 200, json.dumps(body).encode()


def _audit_reports_etag(state: ApiServerState) -> str:
    """The GET /audit/reports validator: the snapshot's generation (what
    the cluster looks like), the serving epoch (which set judged it) and
    the report store's version (what the sweeps wrote)."""
    scanner = state.audit
    generation = scanner.snapshot.stats().get("generation", 0)
    epoch = state.lifecycle.current_epoch if state.lifecycle is not None else 0
    return f'"audit-{generation}-{epoch}-{scanner.reports.version()}"'


def _audit_reports(
    state: ApiServerState, namespace: str | None, if_none_match: str | None
) -> tuple[int, bytes, dict[str, str]]:
    """GET /audit/reports[/{namespace}] → (status, body, headers): the
    report rows and summary with the scanner's facts and an ETag, a 304
    with an empty body for a matching If-None-Match, or the 404 of a
    disabled scanner."""
    if state.audit is None:
        return 404, api_error_body(
            404, "the background audit scanner is disabled"
        ), {}
    etag = _audit_reports_etag(state)
    if if_none_match == etag:
        return 304, b"", {"ETag": etag}
    body = json.dumps(state.audit.report_payload(namespace)).encode()
    return 200, body, {"ETag": etag}


def _ndjson(entry: dict) -> bytes:
    return json.dumps(entry, separators=(",", ":")).encode() + b"\n"


def _timeline() -> tuple[int, bytes]:
    """GET /debug/timeline: the recorder's ring as Chrome trace JSON."""
    rec = flightrec.recorder()
    if rec is None:
        return 404, api_error_body(404, "the flight recorder is disabled")
    return 200, rec.chrome_trace_json()


class _Handler(JsonHandler):
    """Shared plumbing; ``self.server.state`` is the ApiServerState."""

    @property
    def state(self) -> ApiServerState:
        return self.server.state  # type: ignore[attr-defined]

    def _audit_get(self, path: str, query: str) -> bool:
        """Answer the audit GET routes → False for any other path."""
        if path == "/audit/stream":
            self._audit_stream(query)
            return True
        if path == "/audit/reports":
            namespace = None
        elif path.startswith("/audit/reports/") and _one_segment(path[15:]):
            namespace = unquote(path[15:])
        else:
            return False
        status, body, headers = _audit_reports(
            self.state, namespace, self.headers.get("If-None-Match")
        )
        if status == 304:
            self.send_response(304)
            for name, value in headers.items():
                self.send_header(name, value)
            self.end_headers()
        else:
            self._send_json(status, body, headers)
        return True

    def _audit_stream(self, query: str) -> None:
        """GET /audit/stream[?cursor=N]: the matrix's changelog as chunked
        NDJSON until the client goes away, its queue overflows (an OVERFLOW
        line, then the end) or the server stops."""
        state = self.state
        matrix = state.audit_matrix
        if matrix is None:
            self._send_json(
                404, api_error_body(404, "the verdict matrix is disabled")
            )
            return
        cap = state.audit_stream_max_clients
        if matrix.stream_clients() >= cap:
            self._send_json(503, api_error_body(
                503, f"audit stream client cap reached ({cap}); retry later"
            ))
            return
        cursor: int | None = None
        raw = parse_qs(query).get("cursor")
        if raw is not None:
            try:
                cursor = int(raw[-1])
            except ValueError:
                self._send_json(
                    422, api_error_body(422, f"invalid cursor {raw[-1]!r}")
                )
                return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        self.close_connection = True
        sub = matrix.subscribe(cursor)
        closing = self.server.closing  # type: ignore[attr-defined]
        try:
            while not closing.is_set():
                entries, dead = matrix.drain(sub)
                data = b"".join(_ndjson(e) for e in entries)
                if dead:
                    # the queue overflowed: say so (the client reconnects
                    # with its cursor) rather than leave a silent gap
                    data += _ndjson(
                        {"type": "OVERFLOW", "matrixVersion": matrix.version}
                    )
                if data:
                    self._write_chunk(data)
                if dead or self._client_gone(0.1):
                    break
            self._write_chunk(b"")
        except OSError:
            pass  # the client went away: its cursor covers its return
        finally:
            matrix.unsubscribe(sub)

    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
        self.wfile.flush()

    def _client_gone(self, wait: float) -> bool:
        """Wait up to ``wait`` seconds for the client's socket to become
        readable → True when it was closed (a stream client sends
        nothing)."""
        conn = self.connection
        readable, _w, _x = select.select([conn], [], [], wait)
        if not readable:
            return False
        try:
            return conn.recv(1, socket.MSG_PEEK) == b""
        except OSError:
            return True


class ApiHandler(_Handler):
    """The API port: evaluation, the timeline and, under
    ``--enable-pprof``, the profiling endpoints."""

    def do_GET(self) -> None:  # noqa: N802 — http.server's hook name
        path, _, query = self.path.partition("?")
        if self._audit_get(path, query):
            return
        if path == "/debug/timeline":
            self._send_json(*_timeline())
        elif path == "/debug/pprof/cpu" and self.state.enable_pprof:
            self._send(*_pprof_cpu(query))
        elif path == "/debug/pprof/heap" and self.state.enable_pprof:
            self._send(*_pprof_heap())
        else:
            self._not_found()

    def do_POST(self) -> None:  # noqa: N802
        parts = self.path.split("?", 1)[0].strip("/").split("/")
        body = self._read_body()
        if body is None:
            return
        if (
            parts[0] not in EVALUATION_ROUTES
            or len(parts) not in (2, 3)
            or not all(parts)
        ):
            self._not_found()
            return
        state = self.state
        if len(parts) == 3:
            tenant = lookup_tenant(state, parts[1])
            if tenant is None:
                self._send_json(
                    404, api_error_body(404, unknown_tenant_message(parts[1]))
                )
                return
            batcher = tenant.state.batcher
        else:
            batcher = state.batcher
        self._send_json(*evaluate_body(
            batcher, parts[0], parts[-1], body, state.hostname
        ))


def _one_segment(name: str) -> bool:
    return bool(name) and "/" not in name


_ADMIN_ACTIONS = {
    "/policies/promote": "promote_staged",
    "/policies/rollback": "rollback",
}


class ReadinessHandler(_Handler):
    """The plaintext readiness port: probes, the Prometheus scrape, the
    timeline and the policy lifecycle's admin endpoints."""

    def do_POST(self) -> None:  # noqa: N802 — http.server's hook name
        path = self.path.partition("?")[0]
        if self._read_body() is None:
            return
        authorization = self.headers.get("Authorization", "")
        if path == "/policies/reload":
            self._send_json(*policies_reload(self.state, authorization))
        elif path in _ADMIN_ACTIONS:
            self._send_json(
                *lifecycle_action(self.state, authorization, _ADMIN_ACTIONS[path])
            )
        else:
            self._not_found()

    def do_GET(self) -> None:  # noqa: N802 — http.server's hook name
        path, _, query = self.path.partition("?")
        if self._audit_get(path, query):
            return
        if path == "/readiness":
            status, text = self.state.readiness()
            self._send(status, text.encode(), _TEXT)
        elif path.startswith("/readiness/") and _one_segment(path[11:]):
            name = path[11:]
            tenant = lookup_tenant(self.state, name)
            if tenant is None:
                self._send_json(
                    404, api_error_body(404, unknown_tenant_message(name))
                )
            else:
                status, text = tenant.readiness()
                self._send(status, text.encode(), _TEXT)
        elif path == "/metrics":
            self._send(200, default_registry().exposition(), _TEXT)
        elif path == "/debug/timeline":
            self._send_json(*_timeline())
        else:
            self._not_found()
