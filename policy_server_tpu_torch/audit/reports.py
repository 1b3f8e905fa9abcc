"""PolicyReport store: the audit scanner's queryable output (the JAX
package's ``audit/reports.py``).

One row per (resource, policy), served over ``GET /audit/reports``
(cluster-wide) and ``GET /audit/reports/{namespace}``: policy id, allowed,
message and code, mutated — the RAW audit-origin verdict, with no mode or
mutation constraint applied.

Every row is stamped with the policy epoch whose environment produced it.
A promotion re-judges the inventory (the scanner's hook), so rows move to
the new epoch; a ROLLBACK marks every row of the rolled-back epoch
``stale``: listed, but left out of the pass/fail summary until the
post-rollback sweep overwrites it.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from policy_server_tpu_torch.models import AdmissionResponse, ValidateRequest


class PolicyReportStore:
    """Thread-safe map of (resource key, policy id) -> latest audit
    result row. Bounded implicitly by the snapshot store's byte budget
    times the policy-set size (the scanner only writes rows for
    resources the snapshot holds)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (resource_key, policy_id) -> report row dict
        self._rows: dict[tuple[str, str], dict[str, Any]] = {}  # guarded-by: _lock
        self._stale_marked = 0  # guarded-by: _lock
        # bumps on every mutation (put/drop/retain/mark-stale) — one of
        # the GET /audit/reports ETag axes (304 short-circuit)
        self._version = 0  # guarded-by: _lock

    @staticmethod
    def row_from_result(
        key: str,
        policy_id: str,
        request: ValidateRequest,
        result: AdmissionResponse | Exception,
        epoch: int,
    ) -> dict[str, Any]:
        """Build one report row from a replayed audit verdict. Exception
        results (unknown policy raced a reload, init error) become error
        rows rather than being dropped — an auditor must see scan
        failures, not silence."""
        adm = request.admission_request
        row: dict[str, Any] = {
            "resource": key,
            "namespace": (adm.namespace if adm else None) or "",
            "name": (adm.name if adm else None) or "",
            "kind": (adm.kind.kind if adm and adm.kind else "") or "",
            "policy_id": policy_id,
            "epoch": epoch,
            "stale": False,
            "scanned_at": time.time(),
        }
        if isinstance(result, Exception):
            row.update(
                allowed=None, mutated=False,
                message=f"audit error: {result}", code=None, error=True,
            )
            return row
        status = result.status
        row.update(
            allowed=bool(result.allowed),
            mutated=result.patch is not None,
            message=status.message if status else None,
            code=status.code if status else None,
            error=False,
        )
        return row

    def put(self, rows: list[dict[str, Any]]) -> None:
        with self._lock:
            if rows:
                self._version += 1
            for row in rows:
                self._rows[(row["resource"], row["policy_id"])] = row

    def drop_resource(self, key: str) -> None:
        """Remove every policy's row for one deleted resource."""
        self.drop_resources({key})

    def drop_resources(self, keys: set) -> int:
        """Remove every row belonging to the given resource keys in ONE
        pass over the store (the scanner drains observed DELETEs in
        bulk; a per-key scan would be O(deletions × rows)). Returns the
        number of rows dropped."""
        if not keys:
            return 0
        with self._lock:
            dead = [k for k in self._rows if k[0] in keys]
            for k in dead:
                del self._rows[k]
            if dead:
                self._version += 1
        return len(dead)

    def retain(self, resource_keys: set, policy_ids: set) -> int:
        """Post-full-sweep garbage collection: drop every row whose
        resource is no longer in the swept inventory (deleted or
        LRU-evicted) or whose policy the serving set no longer carries —
        a completed full sweep refreshed everything that still exists,
        so anything it did not touch is history. This is what actually
        bounds the store to snapshot size × policy-set size. Returns the
        number of rows dropped."""
        with self._lock:
            dead = [
                k for k in self._rows
                if k[0] not in resource_keys or k[1] not in policy_ids
            ]
            for k in dead:
                del self._rows[k]
            if dead:
                self._version += 1
        return len(dead)

    def mark_epoch_stale(self, epoch: int) -> int:
        """Rollback invalidation: every row produced by ``epoch`` is
        flagged stale (kept visible — the operator can still see WHAT
        the revoked set decided — but excluded from the pass/fail
        summary). Returns the number of rows marked."""
        marked = 0
        with self._lock:
            for row in self._rows.values():
                if row["epoch"] == epoch and not row["stale"]:
                    row["stale"] = True
                    marked += 1
            self._stale_marked += marked
            if marked:
                self._version += 1
        return marked

    # -- query surface (GET /audit/reports[/{namespace}]) ------------------

    def payload(self, namespace: str | None = None) -> dict[str, Any]:
        """The report listing plus summary counters. Stale rows are
        reported but not counted in pass/fail — they describe a policy
        set that was rolled back."""
        with self._lock:
            rows = [
                dict(row) for row in self._rows.values()
                if namespace is None or row["namespace"] == namespace
            ]
        rows.sort(key=lambda r: (r["namespace"], r["name"], r["policy_id"]))
        fresh = [r for r in rows if not r["stale"]]
        summary = {
            "results": len(rows),
            "resources": len({r["resource"] for r in rows}),
            "pass": sum(1 for r in fresh if r["allowed"] is True),
            "fail": sum(1 for r in fresh if r["allowed"] is False),
            "error": sum(1 for r in fresh if r["error"]),
            "mutated": sum(1 for r in fresh if r["mutated"]),
            "stale": len(rows) - len(fresh),
        }
        return {"summary": summary, "reports": rows}

    def version(self) -> int:
        with self._lock:
            return self._version

    def stats(self) -> dict[str, int]:
        with self._lock:
            resident = len(self._rows)
            stale = sum(1 for r in self._rows.values() if r["stale"])
        return {
            "resident": resident,
            "stale": stale,
        }
