"""The HTTP pieces the serving process and the prefork workers share.

A prefork worker (``runtime/frontend.py``) frames requests, parses
AdmissionReviews and writes responses exactly as the serving process's
standard-library frontend does, and must boot in milliseconds: nothing here
imports torch. :class:`JsonHandler` is the response plumbing of every
``http.server`` handler of the package (HTTP/1.1, the Server header,
``Content-Type``, ``Content-Length`` and, on a connection about to close,
``Connection: close``), so a worker's answer and the serving process's
differ only in the Date header.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler
from typing import Any

from policy_server_tpu_torch.api.api_error import api_error_body
from policy_server_tpu_torch.models import (
    AdmissionReviewRequest,
    RawReviewRequest,
)
from policy_server_tpu_torch.telemetry.tracing import logger

MAX_BODY_BYTES = 8 * 1024**2

JSON_CONTENT_TYPE = "application/json; charset=utf-8"
TEXT_CONTENT_TYPE = "text/plain; charset=utf-8"


class BodyError(Exception):
    """Malformed request body; ``message`` carries the 422 text."""

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


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


def span_fields_from_admission(review: AdmissionReviewRequest) -> dict:
    """The request's identifying fields for its span."""
    req = review.request
    fields = {
        "request_uid": req.uid,
        "name": req.name,
        "namespace": req.namespace,
        "operation": req.operation,
        "subresource": req.sub_resource,
    }
    if req.kind:
        fields.update(
            kind_group=req.kind.group, kind_version=req.kind.version,
            kind=req.kind.kind,
        )
    if req.resource:
        fields.update(
            resource_group=req.resource.group,
            resource_version=req.resource.version,
            resource=req.resource.resource,
        )
    return {k: v for k, v in fields.items() if v not in (None, "")}


class JsonHandler(BaseHTTPRequestHandler):
    """Response plumbing shared by every handler of the package."""

    protocol_version = "HTTP/1.1"
    server_version = "policy-server-torch"

    def log_message(self, format: str, *args: Any) -> None:  # noqa: A002
        logger.debug("%s - %s", self.address_string(), format % args)

    def _send(
        self, status: int, body: bytes, content_type: str,
        headers: dict[str, str] | None = None,
    ) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        if self.close_connection:
            # as the native frontend and the JAX package's aiohttp say it
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _send_json(
        self, status: int, body: bytes, headers: dict[str, str] | None = None
    ) -> None:
        self._send(status, body, JSON_CONTENT_TYPE, headers)

    def _not_found(self) -> None:
        self._send_json(404, api_error_body(404, "Not Found"))

    def _read_body(self) -> bytes | None:
        """The request body, or None after answering 413 for one over
        ``MAX_BODY_BYTES`` (the connection then closes)."""
        length = int(self.headers.get("Content-Length") or 0)
        if length > MAX_BODY_BYTES:
            self.close_connection = True
            self._send_json(413, api_error_body(413, "request body too large"))
            return None
        return self.rfile.read(length)
