"""The zero-parse wire request of the native HTTP frontend.

The C++ frontend (``csrc/httpfront.cpp``) parses an AdmissionReview once
and hands over the ``request`` object as the exact compact bytes
``json.dumps(AdmissionRequest.to_dict(), separators=(",", ":"))`` would
produce, with the few header fields the service layer reads (uid,
namespace, operation, requestKind.kind) beside them.
:class:`WireValidateRequest` carries both: the native encoder reads
``payload_json()`` straight from the wire bytes, and ``payload()`` parses
them only for host-side consumers (the oracle, pre-eval hooks, rule
message callables, mutators). A field the header does not carry (the
object's kind and name, which the audit snapshot keys rows by) is read
from the full ``AdmissionRequest``, parsed from the payload once, on first
use.
"""

from __future__ import annotations

import json
from typing import Any, Mapping


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
