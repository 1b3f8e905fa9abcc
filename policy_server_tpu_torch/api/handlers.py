"""HTTP handlers on the standard library's ``http.server``.

* POST ``/validate/{policy_id}``     → the AdmissionReview response
* POST ``/validate_raw/{policy_id}`` → the raw review response
* GET  ``/readiness``                → ``ok``

Error mapping: a malformed JSON body → 422 ``{"message", "status"}``;
PolicyNotFound → 404; any other evaluation error → 500 "Something went
wrong". Bodies are ``json.dumps`` of the response dict with the default
separators, byte for byte what the JAX package's aiohttp frontend writes.
"""

from __future__ import annotations

import json
import logging
from http.server import BaseHTTPRequestHandler
from typing import Any

from policy_server_tpu_torch.api.service import RequestOrigin
from policy_server_tpu_torch.evaluation.errors import (
    EvaluationError,
    PolicyNotFoundError,
)
from policy_server_tpu_torch.models import (
    AdmissionReviewRequest,
    AdmissionReviewResponse,
    RawReviewRequest,
    RawReviewResponse,
    ValidateRequest,
)

logger = logging.getLogger("kubewarden-policy-server")

MAX_BODY_BYTES = 8 * 1024**2


class BodyError(Exception):
    """Malformed request body; ``message`` carries the 422 text."""

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


def api_error_body(status: int, message: str) -> bytes:
    return json.dumps({"message": message, "status": status}).encode()


def parse_admission_review_bytes(body: bytes) -> AdmissionReviewRequest:
    try:
        return AdmissionReviewRequest.from_dict(json.loads(body))
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise BodyError(f"Failed to parse the request body as JSON: {e}") from e
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        raise BodyError(f"Failed to deserialize the JSON body: {e}") from e


def parse_raw_review_bytes(body: bytes) -> RawReviewRequest:
    try:
        return RawReviewRequest.from_dict(json.loads(body))
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise BodyError(f"Failed to parse the request body as JSON: {e}") from e
    except (KeyError, TypeError, ValueError) as e:
        raise BodyError(f"Failed to deserialize the JSON body: {e}") from e


def evaluate_body(
    batcher: Any, kind: str, policy_id: str, body: bytes
) -> tuple[int, bytes]:
    """One POST body → (status, response body). ``kind`` is ``validate``
    or ``validate_raw``."""
    try:
        if kind == "validate":
            review = parse_admission_review_bytes(body)
            request = ValidateRequest.from_admission(review.request)
        else:
            raw = parse_raw_review_bytes(body)
            request = ValidateRequest.from_raw(raw.request)
    except BodyError as e:
        return 422, api_error_body(422, e.message)
    try:
        result = batcher.submit(
            policy_id, request, RequestOrigin.VALIDATE
        ).result()
    except PolicyNotFoundError as e:
        return 404, api_error_body(404, str(e))
    except EvaluationError as e:
        logger.error("Evaluation error: %s", e)
        return 500, api_error_body(500, "Something went wrong")
    except Exception as e:  # noqa: BLE001 — keep the JSON error contract
        logger.error("Evaluation error: %s", e)
        return 500, api_error_body(500, "Something went wrong")
    envelope = (
        AdmissionReviewResponse(result)
        if kind == "validate"
        else RawReviewResponse(result)
    )
    return 200, json.dumps(envelope.to_dict()).encode()


class ApiHandler(BaseHTTPRequestHandler):
    """Routes requests to the server's batcher (``self.server.batcher``)."""

    protocol_version = "HTTP/1.1"
    server_version = "policy-server-torch"

    def log_message(self, format: str, *args: Any) -> None:  # noqa: A002
        logger.debug("%s - %s", self.address_string(), format % args)

    def _send(self, status: int, body: bytes, content_type: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, status: int, body: bytes) -> None:
        self._send(status, body, "application/json; charset=utf-8")

    def do_GET(self) -> None:  # noqa: N802 — http.server's hook name
        if self.path == "/readiness":
            self._send(200, b"ok", "text/plain; charset=utf-8")
        else:
            self._send_json(404, api_error_body(404, "Not Found"))

    def do_POST(self) -> None:  # noqa: N802
        parts = self.path.split("?", 1)[0].strip("/").split("/")
        length = int(self.headers.get("Content-Length") or 0)
        if length > MAX_BODY_BYTES:
            self.close_connection = True
            self._send_json(
                413, api_error_body(413, "request body too large")
            )
            return
        body = self.rfile.read(length)
        if len(parts) != 2 or parts[0] not in ("validate", "validate_raw"):
            self._send_json(404, api_error_body(404, "Not Found"))
            return
        status, payload = evaluate_body(
            self.server.batcher, parts[0], parts[1], body
        )
        self._send_json(status, payload)
