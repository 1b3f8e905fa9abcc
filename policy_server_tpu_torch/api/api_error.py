"""JSON API errors: ``{"message": ..., "status": ...}`` bodies, byte for
byte what the JAX package's frontends write (``json.dumps`` with the
default separators)."""

from __future__ import annotations

import json


def api_error_body(status: int, message: str) -> bytes:
    return json.dumps({"message": message, "status": status}).encode()


def something_went_wrong() -> tuple[int, bytes]:
    """The catch-all 500."""
    return 500, api_error_body(500, "Something went wrong")
