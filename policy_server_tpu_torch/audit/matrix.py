"""The (object × policy) verdict matrix (the JAX package's
``audit/matrix.py``): continuous compliance as a standing cross-product,
and a serving accelerator.

* **Rows** are cluster objects (the snapshot store's keys). A DELETE
  evicts the object's row here too (:meth:`VerdictMatrix.evict_rows`,
  driven by the scanner's deletion prune).
* **Columns** are policies, keyed by a CONTENT fingerprint of the policy
  entry (module, mode, settings, members), not by epoch: a promotion that
  changes 2 of 32 policies dirties 2 columns (:meth:`set_columns`), and
  the sweep re-judges dirty rows × all columns plus clean rows × dirty
  columns, never the whole cluster.
* **Cells** hold the verdict (allowed, code, message, causes), the column
  fingerprint and normalized payload hash that scope its validity, and a
  lazily built :class:`~policy_server_tpu_torch.models.admission.
  FragTemplate` for lookup admission.

Verdict changes append to a bounded changelog ring stamped with a
monotonic ``matrixVersion``; ``GET /audit/stream`` clients subscribe with
bounded per-client queues (:meth:`subscribe`). A slow consumer overflows
its own queue and is dropped with a counted close: the publisher never
blocks on a client. A cursor older than the ring's tail gets a RESYNC
marker and the full current state. A promotion that leaves a column's
fingerprint unchanged re-stamps its cells without emission.

Lookup admission: a ``/validate`` UPDATE whose encoded payload is
byte-identical (uid normalized out) to the row the matrix judged, for a
column whose fingerprint matches the serving set, is answered from the
stored verdict as a pre-serialized fragment. Eligibility is exactly the
fragment lane's proof (``environment._frag_eligible``: protect mode, no
mutator, static messages), and the batcher also requires a hookless
target, so the audit lane's raw verdict and the live verdict are the same
bytes.

Without a state store (the spill and the warm resume wait for ROADMAP
A11) :meth:`maybe_spill` spills nothing and :meth:`restore` restores
nothing, as the JAX package's matrix does without ``--state-dir``.

Thread-safety: one lock guards all matrix state. Publishers append to
subscriber queues under it; handlers drain through :meth:`drain`.
Template builds run outside it (a GIL-atomic attribute store; racing
builders make identical templates).
"""

from __future__ import annotations

import collections
import hashlib
import json
import threading
from typing import Any, Iterable, Mapping

from policy_server_tpu_torch.audit.snapshot import SnapshotStore, resource_key
from policy_server_tpu_torch.models.admission import FragTemplate
from policy_server_tpu_torch.telemetry.tracing import logger


def policy_fingerprint(entry: Any) -> str:
    """Content fingerprint of one policies.yml entry (Policy or
    PolicyGroup) — the column identity. Canonical JSON with sorted keys
    and sorted member/resource sets, so the hash is stable across
    processes and PYTHONHASHSEED (frozenset iteration order is not)."""
    return hashlib.sha256(
        json.dumps(
            _entry_doc(entry), sort_keys=True, separators=(",", ":")
        ).encode()
    ).hexdigest()[:16]


def _entry_doc(entry: Any) -> dict:
    def car(resources) -> list:
        return sorted(
            (r.to_dict() for r in resources),
            key=lambda d: sorted(d.items()),
        )

    if hasattr(entry, "expression"):  # PolicyGroup
        return {
            "kind": "group",
            "expression": entry.expression,
            "message": entry.message,
            "mode": entry.policy_mode.value,
            "members": {
                name: {
                    "module": m.module,
                    "settings": m.settings,
                    "car": car(m.context_aware_resources),
                }
                for name, m in entry.policies.items()
            },
        }
    return {
        "kind": "policy",
        "module": entry.module,
        "mode": entry.policy_mode.value,
        "mutate": entry.allowed_to_mutate,
        "settings": entry.settings,
        "car": car(entry.context_aware_resources),
    }


def normalized_payload_hash(request: Any) -> bytes | None:
    """Digest of the request's canonical encoded payload with the uid
    normalized out (the uid is first in ``AdmissionRequest.to_dict`` and
    compact-JSON encoded, so one bounded substring replace covers it).
    Byte-identity of this digest is the lookup-admission precondition:
    two admissions of the same object content differ only in the uid the
    API server minted. None for raw/untrackable requests."""
    adm = getattr(request, "admission_request", None)
    if adm is None:
        return None
    payload = request.payload_json()
    uid = adm.uid
    if uid:
        token = b'"uid":' + json.dumps(uid).encode()
        payload = payload.replace(token, b'"uid":""', 1)
    return hashlib.blake2b(payload, digest_size=16).digest()


class _Cell:
    """One (resource, policy) verdict plus the facts that scope its
    validity: the column fingerprint of the policy that judged it and
    the normalized payload hash of the object it judged. ``tmpl`` is the
    lazily built FragTemplate (False = proven ineligible)."""

    __slots__ = (
        "allowed", "code", "message", "causes", "epoch", "col_fp",
        "phash", "version", "tmpl",
    )

    def __init__(
        self, allowed, code, message, causes, epoch, col_fp, phash, version
    ) -> None:
        self.allowed = allowed
        self.code = code
        self.message = message
        self.causes = causes
        self.epoch = epoch
        self.col_fp = col_fp
        self.phash = phash
        self.version = version
        self.tmpl: FragTemplate | None | bool = None

    def verdict(self) -> tuple:
        return (self.allowed, self.code, self.message, self.causes)


class MatrixSubscription:
    """One /audit/stream client: a bounded queue the publisher fills
    under the matrix lock and the handler drains. Overflow marks the
    subscription dead (counted close) — the publisher never blocks."""

    __slots__ = ("queue", "dead", "resync")

    def __init__(self) -> None:
        self.queue: collections.deque = collections.deque()
        self.dead = False
        self.resync = False


class VerdictMatrix:
    """The persistent (object × policy) verdict matrix (module
    docstring). Fed by the audit scanner's sweeps, trimmed by the same
    deletion and retention passes that bound the report store, and
    consulted by the batcher's submit paths for lookup admission."""

    def __init__(
        self,
        *,
        snapshot: SnapshotStore,
        changelog_capacity: int = 4096,
        client_queue_capacity: int = 1024,
    ) -> None:
        self.snapshot = snapshot
        self.client_queue_capacity = max(16, int(client_queue_capacity))
        self._lock = threading.Lock()
        # (resource_key, policy_id) -> _Cell
        self._cells: dict[tuple[str, str], _Cell] = {}  # guarded-by: _lock
        # policy_id -> content fingerprint of the SERVING column set
        self._cols: dict[str, str] = {}  # guarded-by: _lock
        self._dirty_cols: set[str] = set()  # guarded-by: _lock
        self._epoch = 0  # guarded-by: _lock
        # monotonic matrixVersion: bumps on every emitted verdict change
        self._version = 0  # guarded-by: _lock
        self._changelog: collections.deque = collections.deque(
            maxlen=max(64, int(changelog_capacity))
        )  # guarded-by: _lock
        self._subs: list[MatrixSubscription] = []  # guarded-by: _lock
        # -- counters (runtime_stats families) ----------------------------
        self._emits = 0  # guarded-by: _lock
        self._dropped_clients = 0  # guarded-by: _lock
        self._lookup_hits = 0  # guarded-by: _lock
        self._lookup_misses = 0  # guarded-by: _lock
        self._rows_evicted = 0  # guarded-by: _lock
        self._columns_invalidated = 0  # guarded-by: _lock
        self._row_sweep_rows = 0  # guarded-by: _lock
        self._column_sweep_rows = 0  # guarded-by: _lock
        self._last_whatif: dict | None = None  # guarded-by: _lock

    # -- columns (epoch lifecycle) -----------------------------------------

    def set_columns(self, policies: Mapping[str, Any], epoch: int) -> dict:
        """Install the serving policy set's columns, DIFFING content
        fingerprints against the previous set: changed/new columns are
        marked dirty (the scanner re-judges them against every row),
        removed columns evict their cells (emitted as DELETEs — the
        verdicts are withdrawn), and unchanged columns re-stamp their
        cells' epoch WITHOUT emission (a promotion is not a verdict
        change). Returns the diff for logging and the sweep planner."""
        fps = {pid: policy_fingerprint(p) for pid, p in policies.items()}
        with self._lock:
            old = self._cols
            dirty = sorted(
                pid for pid, fp in fps.items() if old.get(pid) != fp
            )
            removed = sorted(pid for pid in old if pid not in fps)
            unchanged = sorted(
                pid for pid, fp in fps.items() if old.get(pid) == fp
            )
            self._cols = fps
            self._epoch = epoch
            self._dirty_cols.update(dirty)
            self._columns_invalidated += len(dirty)
            if removed:
                gone = set(removed)
                for (key, pid) in [
                    k for k in self._cells if k[1] in gone
                ]:
                    self._cells.pop((key, pid))
                    self._emit_locked(
                        {"type": "DELETE", "resource": key, "policy": pid}
                    )
            if unchanged:
                keep = set(unchanged)
                for (key, pid), cell in self._cells.items():
                    if pid in keep:
                        cell.epoch = epoch
        if dirty or removed:
            logger.info(
                "verdict matrix columns diffed for epoch %d: %d dirty, "
                "%d removed, %d unchanged", epoch, len(dirty),
                len(removed), len(unchanged),
            )
        return {"dirty": dirty, "removed": removed, "unchanged": unchanged}

    def has_columns(self) -> bool:
        with self._lock:
            return bool(self._cols)

    def take_dirty_columns(self) -> set[str]:
        """Claim the dirty column set for one sweep (the caller re-marks
        on failure, mirroring SnapshotStore.collect/remark_dirty)."""
        with self._lock:
            out = self._dirty_cols & set(self._cols)
            self._dirty_cols = set()
            return out

    def remark_columns_dirty(self, policy_ids: Iterable[str]) -> None:
        with self._lock:
            self._dirty_cols.update(
                pid for pid in policy_ids if pid in self._cols
            )

    # -- rows ---------------------------------------------------------------

    def evict_rows(self, keys: Iterable[str]) -> int:
        """DELETE-evicted objects drop their whole matrix row; each
        resident cell emits a DELETE changelog entry."""
        keys = set(keys)
        if not keys:
            return 0
        evicted = 0
        with self._lock:
            for (key, pid) in [k for k in self._cells if k[0] in keys]:
                self._cells.pop((key, pid))
                evicted += 1
                self._emit_locked(
                    {"type": "DELETE", "resource": key, "policy": pid}
                )
            self._rows_evicted += evicted
        return evicted

    def retain(
        self, resource_keys: set[str], policy_ids: set[str]
    ) -> int:
        """Post-full-sweep GC (the report store's retain contract): any
        cell outside the swept inventory × serving policy set describes
        an evicted resource or a dropped policy — prune silently (their
        DELETEs were already emitted when observed; this is the bound,
        not the signal)."""
        with self._lock:
            stale = [
                k for k in self._cells
                if k[0] not in resource_keys or k[1] not in policy_ids
            ]
            for k in stale:
                self._cells.pop(k)
            return len(stale)

    # -- recording (the scanner's sweep results) ---------------------------

    def record_rows(
        self,
        rows: list[tuple[str, str, Any, Any]],
        epoch: int,
    ) -> None:
        """Install one sweep chunk's verdicts: ``(key, policy_id,
        request, result)`` tuples where result is an AdmissionResponse
        or an Exception. A verdict CHANGE (new cell, flipped fields)
        emits on the changelog; a re-judge that confirms the standing
        verdict re-stamps validity (epoch, payload hash, column
        fingerprint) without emission. Errors evict the cell — an
        unjudgeable pair must not keep serving a stale verdict."""
        prepared = []
        for key, pid, request, result in rows:
            if isinstance(result, Exception) or result is None:
                prepared.append((key, pid, None, None))
                continue
            phash = normalized_payload_hash(request)
            st = getattr(result, "status", None)
            causes = None
            if st is not None and st.details is not None:
                causes = tuple(
                    (c.field, c.message) for c in st.details.causes
                )
            prepared.append((
                key, pid,
                (
                    bool(result.allowed),
                    None if st is None else st.code,
                    None if st is None else st.message,
                    causes,
                ),
                phash,
            ))
        with self._lock:
            for key, pid, verdict, phash in prepared:
                if verdict is None:
                    if self._cells.pop((key, pid), None) is not None:
                        self._emit_locked(
                            {
                                "type": "DELETE", "resource": key,
                                "policy": pid,
                            }
                        )
                    continue
                col_fp = self._cols.get(pid)
                if col_fp is None:
                    continue  # column raced away mid-sweep
                cell = self._cells.get((key, pid))
                if cell is not None and cell.verdict() == verdict:
                    cell.epoch = epoch
                    if cell.phash != phash or cell.col_fp != col_fp:
                        cell.phash = phash
                        cell.col_fp = col_fp
                        cell.tmpl = None
                    continue
                allowed, code, message, causes = verdict
                self._version += 1
                self._cells[(key, pid)] = _Cell(
                    allowed, code, message, causes, epoch, col_fp,
                    phash, self._version,
                )
                self._emit_locked(
                    {
                        "type": "VERDICT",
                        "resource": key,
                        "policy": pid,
                        "allowed": allowed,
                        "code": code,
                        "message": message,
                        "epoch": epoch,
                    },
                    bumped=True,
                )

    def note_sweep(self, row_rows: int = 0, column_rows: int = 0) -> None:
        """Sweep-planner accounting: rows judged because their ROW was
        dirty vs rows judged because their COLUMN was dirty — the two
        axes of the cross-product, kept separate so the dashboard shows
        which axis the cluster's churn is actually exercising."""
        with self._lock:
            self._row_sweep_rows += row_rows
            self._column_sweep_rows += column_rows

    # -- changelog / stream -------------------------------------------------

    def _emit_locked(self, entry: dict, bumped: bool = False) -> None:
        # holds: _lock
        if not bumped:
            self._version += 1
        entry["matrixVersion"] = self._version
        self._changelog.append(entry)
        self._emits += 1
        cap = self.client_queue_capacity
        for sub in self._subs:
            if sub.dead:
                continue
            if len(sub.queue) >= cap:
                # slow consumer: drop the CLIENT, never block or trim
                # its view into silent gaps — the counted close tells it
                # to reconnect with its cursor and resync honestly
                sub.dead = True
                self._dropped_clients += 1
                continue
            sub.queue.append(entry)

    def subscribe(self, cursor: int | None) -> MatrixSubscription:
        """Register a stream client. ``cursor`` is the last
        matrixVersion the client saw (None = new client, live tail
        only). A cursor the changelog ring still covers replays exactly
        the missed entries; an older cursor gets a RESYNC marker plus
        the full current state, stamped with each cell's own version."""
        sub = MatrixSubscription()
        with self._lock:
            if cursor is not None and cursor < self._version:
                tail_v = (
                    self._changelog[0]["matrixVersion"]
                    if self._changelog else self._version + 1
                )
                if cursor >= tail_v - 1:
                    for e in self._changelog:
                        if e["matrixVersion"] > cursor:
                            sub.queue.append(e)
                else:
                    sub.resync = True
                    sub.queue.append(
                        {"type": "RESYNC", "matrixVersion": self._version}
                    )
                    for (key, pid), cell in sorted(
                        self._cells.items(), key=lambda kv: kv[1].version
                    ):
                        sub.queue.append(
                            {
                                "type": "VERDICT",
                                "resource": key,
                                "policy": pid,
                                "allowed": cell.allowed,
                                "code": cell.code,
                                "message": cell.message,
                                "epoch": cell.epoch,
                                "matrixVersion": cell.version,
                            }
                        )
            self._subs.append(sub)
        return sub

    def unsubscribe(self, sub: MatrixSubscription) -> None:
        with self._lock:
            try:
                self._subs.remove(sub)
            except ValueError:
                pass

    def drain(self, sub: MatrixSubscription) -> tuple[list[dict], bool]:
        """Pop everything queued for one client; returns (entries,
        dead). A dead subscription's drained tail still delivers — the
        close is counted, not silent."""
        with self._lock:
            out = list(sub.queue)
            sub.queue.clear()
            return out, sub.dead

    def stream_clients(self) -> int:
        with self._lock:
            return sum(1 for s in self._subs if not s.dead)

    # -- lookup admission ---------------------------------------------------

    def lookup(self, policy_id: str, request: Any, env: Any):
        """The precomputed verdict for a byte-identical admission, as a
        FragTemplate — or None (counted miss). The caller (batcher) has
        already proven the target hookless and the origin VALIDATE; this
        method proves payload identity (normalized hash), column
        currency (fingerprint match), and fragment eligibility (the
        fragment lane's proof, memoized per cell)."""
        key = resource_key(request)
        if key is None:
            with self._lock:
                self._lookup_misses += 1
            return None
        phash = normalized_payload_hash(request)
        with self._lock:
            cell = self._cells.get((key, policy_id))
            if (
                cell is None
                or cell.phash != phash
                or cell.col_fp != self._cols.get(policy_id)
            ):
                self._lookup_misses += 1
                return None
            tmpl = cell.tmpl
        if tmpl is None:
            tmpl = self._build_template(policy_id, cell, env)
        if tmpl is False:
            with self._lock:
                self._lookup_misses += 1
            return None
        with self._lock:
            self._lookup_hits += 1
        return tmpl

    def _build_template(self, policy_id: str, cell: _Cell, env: Any):
        """Build (or refuse) the cell's FragTemplate outside the lock:
        eligibility is the fragment lane's own proof, so a template only
        exists where the audit verdict and the live constrained verdict
        are the same pure function of (policy, payload). GIL-atomic
        store; racing builders produce identical templates."""
        from policy_server_tpu_torch.evaluation.policy_id import PolicyID

        try:
            target = env._lookup_top_level(  # noqa: SLF001 — same package
                PolicyID.parse(policy_id)
            )
            eligible = env._frag_eligible(target)  # noqa: SLF001 — same package
        except Exception:  # noqa: BLE001 — unknown id / stale env
            eligible = False
        if not eligible:
            cell.tmpl = False
            return False
        try:
            tmpl = FragTemplate(
                allowed=cell.allowed,
                code=cell.code,
                message=cell.message,
                causes=cell.causes,
            )
        except UnicodeEncodeError:
            # json can represent what utf-8 cannot encode (lone
            # surrogates) — permanently Python-rendered, never a hit
            cell.tmpl = False
            return False
        cell.tmpl = tmpl
        return tmpl

    # -- durability ---------------------------------------------------------

    def maybe_spill(self, force: bool = False) -> bool:
        """Spill the matrix when the cadence (or ``force``) says so → False:
        there is no state store to spill through (ROADMAP A11), as in the
        JAX package without ``--state-dir``."""
        return False

    def restore(self) -> int:
        """Warm-boot restore from the spill → 0: there is no state store
        (ROADMAP A11)."""
        return 0

    # -- what-if (--audit-matrix-whatif) -------------------------------------

    def whatif_diff(
        self, candidate_env: Any, policies: Mapping[str, Any],
        max_rows: int = 256,
    ) -> dict:
        """Cluster-wide shadow canary: evaluate a CANDIDATE epoch's
        CHANGED columns against the live snapshot (bounded) and diff the
        verdicts against the standing matrix — canarying over the whole
        cluster, not a request ring. Returns (and retains, for the
        reload status surface) a summary with a sample of flips."""
        fps = {pid: policy_fingerprint(p) for pid, p in policies.items()}
        with self._lock:
            changed = sorted(
                pid for pid, fp in fps.items()
                if self._cols.get(pid) != fp
            )
        rows = self.snapshot.rows_snapshot()[:max_rows]
        pairs = [
            (key, pid, req)
            for key, req in rows
            for pid in changed
            if pid in candidate_env.policy_ids()
        ]
        flips: list[dict] = []
        evaluated = 0
        for start in range(0, len(pairs), 128):
            chunk = pairs[start:start + 128]
            results = candidate_env.validate_batch(
                [(pid, req) for _k, pid, req in chunk], run_hooks=False
            )
            for (key, pid, _req), result in zip(chunk, results):
                evaluated += 1
                if isinstance(result, Exception):
                    continue
                allowed = bool(result.allowed)
                with self._lock:
                    cell = self._cells.get((key, pid))
                before = None if cell is None else cell.allowed
                if before is not None and before != allowed and len(
                    flips
                ) < 32:
                    flips.append(
                        {
                            "resource": key, "policy": pid,
                            "was_allowed": before, "would_allow": allowed,
                        }
                    )
        summary = {
            "columns_changed": changed,
            "rows_evaluated": evaluated,
            "verdict_flips": len(flips),
            "flips_sample": flips,
        }
        with self._lock:
            self._last_whatif = summary
        return summary

    def last_whatif(self) -> dict | None:
        with self._lock:
            return self._last_whatif

    # -- introspection -------------------------------------------------------

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def serving_epoch(self) -> int:
        with self._lock:
            return self._epoch

    def coverage(self) -> tuple[int, int]:
        """(distinct matrix rows, rows with a cell for EVERY serving
        column)."""
        with self._lock:
            cols = set(self._cols)
            rows: dict[str, int] = {}
            for (key, _pid) in self._cells:
                rows[key] = rows.get(key, 0) + 1
            complete = sum(
                1 for n in rows.values() if cols and n >= len(cols)
            )
            return len(rows), complete

    def stats(self) -> dict[str, Any]:
        with self._lock:
            rows = {key for (key, _pid) in self._cells}
            return {
                "rows_resident": len(rows),
                "cells_resident": len(self._cells),
                "columns": len(self._cols),
                "dirty_columns": len(self._dirty_cols),
                "matrix_version": self._version,
                "changelog_emits": self._emits,
                "changelog_dropped_clients": self._dropped_clients,
                "stream_clients": sum(
                    1 for s in self._subs if not s.dead
                ),
                "lookup_hits": self._lookup_hits,
                "lookup_misses": self._lookup_misses,
                "rows_evicted": self._rows_evicted,
                "columns_invalidated": self._columns_invalidated,
                "row_sweep_rows": self._row_sweep_rows,
                "column_sweep_rows": self._column_sweep_rows,
                # no state store (ROADMAP A11): nothing spilled or restored
                "spills": 0,
                "cells_restored": 0,
            }

    def cells_snapshot(self) -> dict[tuple[str, str], tuple]:
        """Verdict fields per cell — the bit-exactness witness the tests
        compare against a full re-sweep."""
        with self._lock:
            return {
                k: cell.verdict() for k, cell in self._cells.items()
            }
