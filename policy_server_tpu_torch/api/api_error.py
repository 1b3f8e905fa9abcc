"""JSON API errors: ``{"message": ..., "status": ...}`` bodies, byte for
byte what the JAX package's frontends write (``json.dumps`` with the
default separators)."""

from __future__ import annotations

import json
import math


def api_error_body(status: int, message: str) -> bytes:
    return json.dumps({"message": message, "status": status}).encode()


def something_went_wrong() -> tuple[int, bytes]:
    """The catch-all 500."""
    return 500, api_error_body(500, "Something went wrong")


def shed_body(retry_after: int, message: str) -> bytes:
    """The body of a shed (429) or fenced (503) answer."""
    return json.dumps(
        {"message": message, "retry_after_seconds": retry_after}
    ).encode()


def shed_answer(exc: Exception) -> tuple[int, int, bytes]:
    """A ``ShedError`` (or its ``FencedError``) → (status, Retry-After
    seconds, body): the status and text come off the exception's class, the
    header is the retry rounded up to a whole second, at least 1."""
    retry = max(1, math.ceil(exc.retry_after_seconds))
    return exc.http_status, retry, shed_body(retry, exc.message)

