"""JSON API errors: ``{"message": ..., "status": ...}`` bodies, byte for
byte what the JAX package's frontends write (``json.dumps`` with the
default separators), and the shed answers (``ShedError``, ``FencedError``:
429 and 503 with Retry-After). Nothing here imports torch: the prefork
workers (``runtime/frontend.py``) use it too."""

from __future__ import annotations

import json
import math


class ShedError(Exception):
    """Raised (or set on a row's Future) at admission when the row cannot
    be served within its deadline: the queue's estimated wait exceeds the
    budget, or the tenant's quota is spent. The HTTP layer answers
    ``http_status`` with ``Retry-After: ceil(retry_after_seconds)``."""

    http_status = 429
    message = "policy server overloaded; retry later"

    def __init__(self, retry_after_seconds: float):
        super().__init__(self.message)
        self.retry_after_seconds = max(0.001, retry_after_seconds)


class FencedError(ShedError):
    """The answer for a row a serving shard can no longer serve: its
    dispatch loop died or wedged and no healthy sibling had room. The row
    was never dispatched, so a retry is safe; a 503, so the overload (429)
    counts never absorb a fence."""

    http_status = 503
    message = "serving shard fenced; retry later"


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

