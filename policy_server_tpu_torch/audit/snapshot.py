"""Snapshot store: the audit scanner's view of the cluster (the JAX
package's ``audit/snapshot.py``).

The scan runs in-process, so it keeps its own inventory of resources, as
admission requests. Two feeds fill it:

* **Dirty-set tracking.** The batcher records every object served through
  ``/validate``, once per formed batch, keyed by GVK + namespace + name,
  so a later admission of the same object SUPERSEDES the earlier one. A
  ``DELETE`` admission evicts the key.
* **File seeding** (``--audit-resources-file``): a JSON or YAML list of
  Kubernetes objects, or a ``List`` document (``{items: [...]}``),
  recorded as synthetic CREATE reviews. A file that parses as JSON needs
  nothing more; any other is read with PyYAML, and where PyYAML is not
  installed the read raises.

Rows keep their encoded payload (``ValidateRequest.payload_json`` is
memoized, and the live path computed it already), so a sweep re-submits
pre-encoded rows. ``--audit-max-snapshot-bytes`` bounds the store, with
LRU eviction on the recording order.
"""

from __future__ import annotations

import collections
import json
import threading
from typing import Any, Iterable

from policy_server_tpu_torch.models import (
    AdmissionRequest,
    GroupVersionKind,
    ValidateRequest,
)
from policy_server_tpu_torch.telemetry.tracing import logger


def synthesize_review(
    obj: Any, operation: str = "CREATE", uid: str | None = None
) -> ValidateRequest | None:
    """One Kubernetes object → the admission review the API server would
    have sent for it (CREATE rows for file seeding; a DELETE carries only
    the identity). None for an object with no kind."""
    if not isinstance(obj, dict) or "kind" not in obj:
        return None
    api_version = obj.get("apiVersion", "v1") or "v1"
    group, _, version = api_version.rpartition("/")
    meta = obj.get("metadata") or {}
    gvk = GroupVersionKind(
        group=group, version=version, kind=obj.get("kind", "")
    )
    uid = uid or meta.get("uid") or f"audit-synth-{id(obj):x}"
    name = meta.get("name") or uid
    req = AdmissionRequest(
        uid=uid,
        kind=gvk,
        name=name,
        namespace=meta.get("namespace"),
        operation=operation,
        user_info={"username": "system:policy-server-audit"},
        object=None if operation == "DELETE" else obj,
        dry_run=True,
    )
    return ValidateRequest.from_admission(req)


def resource_key(request: ValidateRequest) -> str | None:
    """GVK + namespace + name of the object a review targets; None for rows
    the store cannot track (raw requests, reviews with neither a name nor
    a uid)."""
    adm = request.admission_request
    if adm is None:
        return None
    kind = adm.kind or GroupVersionKind()
    name = adm.name or adm.uid
    if not name:
        return None
    return "/".join(
        (kind.group, kind.version, kind.kind, adm.namespace or "", name)
    )


def read_resources_document(path: str) -> Any:
    """A resources file → its document: JSON when it parses as JSON, else
    YAML through PyYAML, which raises where PyYAML is not installed."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        json_error = e
    try:
        import yaml
    except ImportError:
        raise ValueError(
            f"audit resources file {path!r} is not JSON ({json_error}), and "
            "reading YAML needs PyYAML, which is not installed"
        ) from json_error
    return yaml.safe_load(text)


class SnapshotStore:
    """Bounded, dirty-tracking inventory of cluster resources (module
    docstring). Thread-safe: batch workers record while the scanner
    collects."""

    def __init__(self, max_bytes: int = 64 * 1024 * 1024):
        self.max_bytes = max(0, int(max_bytes))
        self._lock = threading.Lock()
        # key -> (request, nbytes); insertion order is the LRU axis
        self._rows: collections.OrderedDict[
            str, tuple[ValidateRequest, int]
        ] = collections.OrderedDict()  # guarded-by: _lock
        self._dirty: set[str] = set()  # guarded-by: _lock
        # keys evicted by an observed DELETE since the scanner last drained
        # them (their report rows are pruned)
        self._pending_deletions: set[str] = set()  # guarded-by: _lock
        self._bytes = 0  # guarded-by: _lock
        self._recorded = 0  # guarded-by: _lock
        self._superseded = 0  # guarded-by: _lock
        self._evicted = 0  # guarded-by: _lock
        self._deleted = 0  # guarded-by: _lock
        # bumps on every observe that records a row: an axis of the
        # /audit/reports ETag
        self._generation = 0  # guarded-by: _lock

    # -- recording ---------------------------------------------------------

    def observe(self, requests: Iterable[ValidateRequest]) -> None:
        """Record one batch of served requests; sizes are taken outside
        the lock (payload_json is memoized and the encoder reuses it)."""
        prepared: list[tuple[str, ValidateRequest | None, int]] = []
        for request in requests:
            key = resource_key(request)
            if key is None:
                continue
            adm = request.admission_request
            if adm is not None and (adm.operation or "").upper() == "DELETE":
                prepared.append((key, None, 0))
                continue
            prepared.append((key, request, len(request.payload_json())))
        if not prepared:
            return
        with self._lock:
            self._generation += 1
            for key, request, nbytes in prepared:
                if request is None:
                    old = self._rows.pop(key, None)
                    if old is not None:
                        self._bytes -= old[1]
                        self._deleted += 1
                    self._dirty.discard(key)
                    self._pending_deletions.add(key)
                    continue
                self._pending_deletions.discard(key)  # re-created object
                old = self._rows.pop(key, None)
                if old is not None:
                    self._bytes -= old[1]
                    self._superseded += 1
                self._rows[key] = (request, nbytes)
                self._bytes += nbytes
                self._recorded += 1
                self._dirty.add(key)
            self._evict_over_budget_locked()

    def _evict_over_budget_locked(self) -> None:
        # holds: _lock
        if self.max_bytes <= 0:
            return
        while self._bytes > self.max_bytes and self._rows:
            key, (_req, nbytes) = self._rows.popitem(last=False)
            self._bytes -= nbytes
            self._dirty.discard(key)
            self._evicted += 1

    # -- durable spill (statestore.py) -------------------------------------

    def export_rows(self) -> list[tuple[str, bytes]]:
        """One locked snapshot of the inventory as ``(key, payload_json)``
        pairs: the audit spill's corpus (payload_json is memoized)."""
        with self._lock:
            items = list(self._rows.items())
        return [(key, req.payload_json()) for key, (req, _n) in items]

    def restore_rows(self, pairs: Iterable[tuple[str, bytes]]) -> int:
        """Rebuild rows from a spill's encoded payloads (a warm boot's seed:
        the watch feed then resumes from its spilled resourceVersion instead
        of re-LISTing) → the rows restored. Undecodable rows are skipped and
        counted at WARNING; the next full re-LIST repairs what they lost."""
        restored: list[ValidateRequest] = []
        skipped = 0
        for _key, payload in pairs:
            try:
                req = AdmissionRequest.from_dict(json.loads(payload))
                restored.append(ValidateRequest.from_admission(req))
            except Exception:  # noqa: BLE001 — a damaged row must not
                skipped += 1  # fail the boot; the resync repairs it
        self.observe(restored)
        if skipped:
            logger.warning(
                "audit spill restore skipped %d undecodable row(s); the "
                "next full re-LIST resync repairs the inventory", skipped,
            )
        return len(restored)

    # -- seeding -----------------------------------------------------------

    def seed_from_file(self, path: str) -> int:
        """Record one synthetic CREATE review per object of a resources file
        (a list of objects or a List document) → the rows seeded."""
        doc = read_resources_document(path)
        if isinstance(doc, dict) and "items" in doc:
            objects = doc["items"]
        elif isinstance(doc, list):
            objects = doc
        else:
            raise ValueError(
                f"audit resources file {path!r} must hold a list of "
                "objects or a List document with an 'items' field"
            )
        batch: list[ValidateRequest] = []
        for i, obj in enumerate(objects):
            req = synthesize_review(obj, "CREATE", uid=f"audit-seed-{i}")
            if req is not None:
                batch.append(req)
        self.observe(batch)
        logger.info(
            "audit snapshot seeded from resources file",
            extra={"span_fields": {"path": path, "resources": len(batch)}},
        )
        return len(batch)

    # -- collection (the scanner's sweep feed) -----------------------------

    def collect(
        self, dirty_only: bool = False
    ) -> list[tuple[str, ValidateRequest]]:
        """The sweep corpus (the whole inventory, or the keys touched since
        the last collect), clearing the dirty set. A failed sweep gives its
        unscanned keys back through ``remark_dirty``."""
        with self._lock:
            if dirty_only:
                keys = [k for k in self._dirty if k in self._rows]
            else:
                keys = list(self._rows)
            self._dirty.clear()
            return [(k, self._rows[k][0]) for k in keys]

    def remark_dirty(self, keys: Iterable[str]) -> None:
        with self._lock:
            self._dirty.update(k for k in keys if k in self._rows)

    def clear_dirty(self, keys: Iterable[str]) -> int:
        """Drop the dirty marks of rows proven current by other means."""
        with self._lock:
            before = len(self._dirty)
            self._dirty.difference_update(keys)
            return before - len(self._dirty)

    def rows_snapshot(self) -> list[tuple[str, ValidateRequest]]:
        """The whole inventory WITHOUT clearing dirty marks (the verdict
        matrix's row axis; ``collect`` alone claims the dirty set)."""
        with self._lock:
            return [(k, row[0]) for k, row in self._rows.items()]

    def dirty_keys(self) -> set[str]:
        with self._lock:
            return set(self._dirty)

    def take_deletions(self) -> set[str]:
        """Drain the keys DELETEs evicted since the last call."""
        with self._lock:
            out = self._pending_deletions
            self._pending_deletions = set()
            return out

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "resources": len(self._rows),
                "bytes": self._bytes,
                "dirty": len(self._dirty),
                "generation": self._generation,
                "recorded": self._recorded,
                "superseded": self._superseded,
                "evicted": self._evicted,
                "deleted": self._deleted,
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)
