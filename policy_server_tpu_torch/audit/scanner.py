"""Background audit scanner: the continuous re-scan of the cluster on idle
device capacity (the JAX package's ``audit/scanner.py``).

The scan lives in-process and rides the batcher's best-effort audit lane
(:meth:`MicroBatcher.submit_audit`): audit batches dispatch only when the
live lane is empty with slack in the request deadline, at most one audit
dispatch is ever in flight, and a popped audit batch is re-queued
(preempted) the moment live work arrives. On a card each audit batch goes
through the device path (``validate_batch`` without ``prefer_host``), so
through the ``policy_matrix`` kernel; a batch that fails there fails its
sweep, which re-marks its rows dirty, counts an error and retries.

Sweep cadences:

* **full sweep**: the whole snapshot store through the live epoch's
  environment, at scanner start, on every policy-epoch PROMOTION (the
  lifecycle's post-promote hook: the new set re-judges everything
  admitted under the old one) and after a ROLLBACK (which first marks the
  rolled-back epoch's reports stale);
* **dirty sweep**: only objects served through ``/validate`` since the
  last sweep, every ``--audit-interval-seconds`` (``--audit-mode
  interval``; ``on-promote`` sweeps only on epoch flips).

With a verdict matrix (``--audit-matrix``) a promotion diffs the policies'
content fingerprints instead: the dirty sweep then re-judges dirty rows ×
all columns plus clean rows × the changed columns.

Results land in the :class:`~policy_server_tpu_torch.audit.reports.
PolicyReportStore` stamped with the epoch that produced them: RAW
verdicts (audit origin: no mode or mutation constraint), sharing the
epoch's verdict cache with live traffic.

While the device breaker is fully open the scanner PAUSES (the skipped
sweeps are counted). A mid-sweep reload retires the old epoch's batcher
and closes its environment; the in-flight audit job then fails, the sweep
aborts re-marking its unscanned keys dirty, and the post-promote sweep
picks everything up on the new epoch.

Chaos site: ``audit.sweep`` fires at the head of every sweep.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any

from policy_server_tpu_torch import failpoints
from policy_server_tpu_torch.audit.reports import PolicyReportStore
from policy_server_tpu_torch.audit.snapshot import SnapshotStore
from policy_server_tpu_torch.telemetry.tracing import logger

AUDIT_MODES = ("off", "interval", "on-promote")


class AuditScanner:
    """The background sweeper (see module docstring). Owns a daemon
    thread; sweeps are serialized by ``_sweep_lock`` so a test-driven
    synchronous :meth:`sweep` never races the cadence thread."""

    def __init__(
        self,
        *,
        state: Any,
        snapshot: SnapshotStore,
        reports: PolicyReportStore,
        mode: str = "interval",
        interval_seconds: float = 30.0,
        batch_size: int = 256,
        job_timeout_seconds: float = 60.0,
        matrix: Any = None,
    ) -> None:
        if mode not in AUDIT_MODES:
            raise ValueError(f"invalid audit mode {mode!r}")
        self.state = state
        self.snapshot = snapshot
        self.reports = reports
        # optional verdict matrix (audit/matrix.py): when armed, sweeps
        # evaluate the dirty CROSS-PRODUCT (dirty-rows × all-columns +
        # clean-rows × dirty-columns) and feed results to the matrix
        # next to the report store; epoch hooks diff policy-content
        # fingerprints instead of requesting whole-cluster re-judges
        self.matrix = matrix
        self.mode = mode
        self.interval = max(0.05, float(interval_seconds))
        self.batch_size = max(1, int(batch_size))
        # bound on one audit-lane dispatch (queue wait behind live bursts
        # + device time); a sweep that cannot land a batch inside it
        # aborts and retries on the next cadence tick
        self.job_timeout = float(job_timeout_seconds)
        # optional live-cluster feed (audit/watch_feed.WatchFeed): set by
        # the server under --audit-watch so sweep payloads and stats
        # carry the feed's freshness accounting next to the scanner's
        self.watch_feed: Any = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        # serializes whole sweeps (the cadence thread against direct callers)
        self._sweep_lock = threading.Lock()
        self._lock = threading.Lock()
        self._full_pending = True  # guarded-by: _lock — first sweep is full
        # a matrix column-diff promotion requests a DIRTY sweep; this
        # flag lets on-promote mode run it without a cadence tick
        self._kick_pending = False  # guarded-by: _lock
        self._full_sweeps = 0  # guarded-by: _lock
        self._dirty_sweeps = 0  # guarded-by: _lock
        self._sweep_errors = 0  # guarded-by: _lock
        self._paused_sweeps = 0  # guarded-by: _lock
        self._rows_scanned = 0  # guarded-by: _lock
        # whole-run accounting, segmented by the policy epoch whose set
        # judged the rows (one total alone reads ambiguously after an
        # epoch flip)
        self._rows_by_epoch: dict[int, int] = {}  # guarded-by: _lock
        self._last_full_sweep: float | None = None  # guarded-by: _lock

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "AuditScanner":
        if self._thread is None:
            # the pending boot sweep runs on the first loop pass, not an
            # interval later (freshness gauge live from the start)
            self._wake.set()
            self._thread = threading.Thread(
                target=self._loop, name="audit-scanner", daemon=True
            )
            self._thread.start()
        return self

    def shutdown(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self.matrix is not None:
            # the final spill (nothing without a state store, ROADMAP A11)
            self.matrix.maybe_spill(force=True)

    # -- triggers ----------------------------------------------------------

    def request_full_sweep(self, reason: str) -> None:
        with self._lock:
            self._full_pending = True
        self._wake.set()
        logger.info("audit full sweep requested (%s)", reason)

    def request_dirty_sweep(self, reason: str) -> None:
        """Kick one dirty sweep out of cadence (matrix column-diff
        promotions: only the changed columns need re-judging, so a full
        sweep would throw away exactly the work the matrix preserved)."""
        with self._lock:
            self._kick_pending = True
        self._wake.set()
        logger.info("audit dirty sweep requested (%s)", reason)

    def _matrix_columns_sync(self, epoch: int) -> "dict | None":
        """Diff the SERVING policy set's content fingerprints into the
        matrix columns. Returns the diff, or None when the matrix is off
        or the environment cannot supply its source policies (then the
        caller falls back to the pre-matrix full-sweep contract)."""
        matrix = self.matrix
        if matrix is None:
            return None
        env = self.state.evaluation_environment
        policies = (
            getattr(env, "source_policies", None)
            if env is not None else None
        )
        if not policies:
            return None
        return matrix.set_columns(policies, epoch)

    def on_promote(self, epoch: int) -> None:
        """Lifecycle post-promote hook. Matrix off: the newly serving
        policy set must re-judge every resource admitted under the
        previous one (full sweep). Matrix on: diff column fingerprints —
        a promotion that changes 2 of 32 policies dirties 2 columns and
        kicks a dirty sweep; an unchanged-content promotion re-stamps
        cells and re-judges NOTHING."""
        diff = self._matrix_columns_sync(epoch)
        if diff is None:
            self.request_full_sweep(f"epoch-{epoch}-promoted")
            return
        if diff["dirty"] or diff["removed"]:
            self.request_dirty_sweep(
                f"epoch-{epoch}-promoted: {len(diff['dirty'])} column(s) "
                f"dirty, {len(diff['removed'])} removed"
            )

    def on_rollback(self, stale_epoch: int, serving_epoch: int) -> None:
        """Lifecycle rollback hook: the rolled-back epoch's verdicts no
        longer describe a policy set anyone serves — mark them stale,
        then re-scan under the revived epoch. The matrix diffs columns
        first (a rollback to byte-identical policy content keeps its
        cells valid; the full sweep's re-judge then re-stamps without
        emission), but the REPORT rows need the revived epoch's stamp,
        so the full-sweep contract stays."""
        marked = self.reports.mark_epoch_stale(stale_epoch)
        logger.warning(
            "audit reports from rolled-back policy epoch %d marked stale "
            "(%d rows); full re-scan under epoch %d queued",
            stale_epoch, marked, serving_epoch,
        )
        self._matrix_columns_sync(serving_epoch)
        self.request_full_sweep(f"epoch-{stale_epoch}-rolled-back")

    # -- the cadence loop --------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            # interval mode ticks on the cadence; on-promote mode sleeps
            # until a hook kicks it (short timeout only to observe stop)
            timeout = self.interval if self.mode == "interval" else 0.5
            self._wake.wait(timeout)
            self._wake.clear()
            if self._stop.is_set():
                return
            # drain observed DELETEs every tick, even when no sweep runs
            # (on-promote mode may not sweep for days; without this the
            # pending-deletion set grows unbounded under cluster churn
            # and deleted objects' report rows keep reading as current)
            self._prune_deletions()
            with self._lock:
                full = self._full_pending
                self._full_pending = False
                kick = self._kick_pending
                self._kick_pending = False
            if not full and not kick and self.mode != "interval":
                continue
            try:
                self.sweep(full=full)
            except Exception as e:  # noqa: BLE001 — the scanner must
                # survive any sweep failure (mid-sweep reload, injected
                # fault) and resume on the next trigger; sweep() already
                # re-pended the full-sweep claim
                with self._lock:
                    self._sweep_errors += 1
                logger.error("audit sweep failed (will retry): %s", e)

    # -- sweeping ----------------------------------------------------------

    def sweep(self, full: bool = True) -> int:
        """Run one sweep synchronously; returns resources×policies rows
        scanned. Public for tests and the chip smoke test. A full sweep
        that fails for ANY reason (injected fault, mid-sweep epoch
        retirement, job timeout) keeps its pending claim so the next
        trigger retries it."""
        with self._sweep_lock:
            try:
                return self._run_sweep(full)
            except BaseException:
                self._defer_full(full)
                raise

    def _prune_deletions(self) -> None:
        """Drain DELETE-evicted snapshot keys and drop their report rows
        (and matrix rows — each emits a DELETE changelog entry) in one
        bulk pass; called every cadence tick and at sweep heads."""
        deleted = self.snapshot.take_deletions()
        self.reports.drop_resources(deleted)
        if self.matrix is not None and deleted:
            self.matrix.evict_rows(deleted)

    def _defer_full(self, full: bool) -> None:
        """A full sweep that could not run keeps its claim: without this
        a promotion landing while the breaker is open would silently
        never re-judge the cluster under the new set (on-promote mode
        has no cadence to catch it later)."""
        if not full:
            return
        with self._lock:
            self._full_pending = True

    def _run_sweep(self, full: bool) -> int:
        # holds: _sweep_lock
        failpoints.fire("audit.sweep")
        env = self.state.evaluation_environment
        batcher = self.state.batcher
        if env is None or batcher is None:
            self._defer_full(full)
            return 0
        if getattr(env, "breaker_all_open", False):
            # open shards pause audit instead of burning the oracle
            # capacity degraded live traffic is leaning on; the pending
            # full sweep survives the pause
            with self._lock:
                self._paused_sweeps += 1
            self._defer_full(full)
            return 0
        lifecycle = getattr(self.state, "lifecycle", None)
        epoch = lifecycle.current_epoch if lifecycle is not None else 0
        # deletions observed since the last sweep prune their report
        # rows (a deleted object's verdicts must not read as current
        # cluster posture); one bulk pass, not per-key scans
        self._prune_deletions()
        matrix = self.matrix
        if matrix is not None and not matrix.has_columns():
            # standalone harnesses (tests) that never fire a
            # lifecycle hook still get columns before the first record
            self._matrix_columns_sync(epoch)
        items = self.snapshot.collect(dirty_only=not full)
        policy_ids = list(env.policy_ids())
        rows = [
            (key, pid, request)
            for key, request in items
            for pid in policy_ids
        ]
        dirty_cols: set[str] = set()
        if matrix is not None:
            # the dirty CROSS-PRODUCT: dirty-rows × ALL columns (above)
            # plus clean-rows × dirty-columns. A full sweep already
            # covers every cell, so it just claims (and thereby clears)
            # the dirty-column set.
            dirty_cols = matrix.take_dirty_columns()
            col_rows = 0
            if dirty_cols and not full:
                dirty_keys = {key for key, _req in items}
                cols = [pid for pid in policy_ids if pid in dirty_cols]
                extra = [
                    (key, pid, request)
                    for key, request in self.snapshot.rows_snapshot()
                    if key not in dirty_keys
                    for pid in cols
                ]
                col_rows = len(extra)
                rows.extend(extra)
            matrix.note_sweep(
                row_rows=len(rows) - col_rows, column_rows=col_rows
            )
        scanned = 0
        try:
            for start in range(0, len(rows), self.batch_size):
                if self._stop.is_set():
                    raise RuntimeError("audit scanner shutting down")
                chunk = rows[start : start + self.batch_size]
                future = batcher.submit_audit(
                    [(pid, request) for _key, pid, request in chunk]
                )
                try:
                    results = future.result(timeout=self.job_timeout)
                except FutureTimeout:
                    # abandon the job IN THE LANE too — without this,
                    # overload-era retries would pile duplicate jobs
                    # into the deque and later burn idle dispatches on
                    # results nobody reads
                    batcher.cancel_audit(future)
                    raise RuntimeError(
                        f"audit batch timed out after "
                        f"{self.job_timeout:.0f}s waiting for an idle "
                        "slot"
                    ) from None
                report_rows = [
                    self.reports.row_from_result(
                        key, pid, request, result, epoch
                    )
                    for (key, pid, request), result in zip(chunk, results)
                ]
                self.reports.put(report_rows)
                if matrix is not None:
                    matrix.record_rows(
                        [
                            (key, pid, request, result)
                            for (key, pid, request), result in zip(
                                chunk, results
                            )
                        ],
                        epoch,
                    )
                scanned += len(chunk)
                with self._lock:
                    self._rows_scanned += len(chunk)
                    self._rows_by_epoch[epoch] = (
                        self._rows_by_epoch.get(epoch, 0) + len(chunk)
                    )
        except BaseException:
            # abort: un-judged resources go back on the dirty set so the
            # next sweep (e.g. the post-promote full sweep after a
            # mid-sweep reload killed our batcher) picks them up
            self.snapshot.remark_dirty(
                {key for key, _pid, _req in rows[scanned:]}
            )
            if matrix is not None and dirty_cols:
                # the claimed columns were not (fully) re-judged; give
                # them back so the next sweep picks them up (re-judging
                # an already-landed cell merely re-stamps, never emits)
                matrix.remark_columns_dirty(dirty_cols)
            raise
        if full:
            # a completed full sweep covered the ENTIRE inventory: any
            # report row it did not refresh describes an evicted/deleted
            # resource or a policy the serving set no longer has — prune
            # (this is what keeps the report store bounded by snapshot
            # size x policy-set size)
            self.reports.retain(
                {key for key, _pid, _req in rows}, set(policy_ids)
            )
            if matrix is not None:
                matrix.retain(
                    {key for key, _pid, _req in rows}, set(policy_ids)
                )
        with self._lock:
            if full:
                self._full_sweeps += 1
                self._last_full_sweep = time.monotonic()
            else:
                self._dirty_sweeps += 1
        if matrix is not None:
            # the spill rides the sweep tail, never the serving path
            # (nothing without a state store, ROADMAP A11)
            matrix.maybe_spill()
        return scanned

    # -- introspection -----------------------------------------------------

    def freshness_seconds(self) -> float:
        """Seconds since the last COMPLETED full sweep; -1 before the
        first one lands (the dashboard's report-freshness gauge)."""
        with self._lock:
            last = self._last_full_sweep
        if last is None:
            return -1.0
        return time.monotonic() - last

    def report_payload(self, namespace: str | None = None) -> dict[str, Any]:
        """The GET /audit/reports body: report rows + summary, plus the
        scanner's own freshness/cadence facts."""
        body = self.reports.payload(namespace)
        with self._lock:
            body["scanner"] = {
                "mode": self.mode,
                "full_sweeps": self._full_sweeps,
                "dirty_sweeps": self._dirty_sweeps,
                "sweep_errors": self._sweep_errors,
                "paused_sweeps": self._paused_sweeps,
                "rows_scanned": self._rows_scanned,
            }
        body["scanner"]["freshness_seconds"] = self.freshness_seconds()
        body["scanner"]["snapshot"] = self.snapshot.stats()
        if self.watch_feed is not None:
            body["scanner"]["watch_feed"] = self.watch_feed.stats()
        if self.matrix is not None:
            body["scanner"]["matrix"] = self.matrix.stats()
        return body

    def stats(self) -> dict[str, Any]:
        """One locked snapshot for runtime_stats (/metrics).
        ``rows_scanned`` is the WHOLE-RUN total across every policy
        epoch; ``rows_scanned_by_epoch`` decomposes it (string epoch
        keys, JSON friendly) so a run whose last event was an
        epoch flip still reports the run's full audit volume next to the
        post-promote sweep's share."""
        with self._lock:
            out: dict[str, Any] = {
                "full_sweeps": self._full_sweeps,
                "dirty_sweeps": self._dirty_sweeps,
                "sweep_errors": self._sweep_errors,
                "paused_sweeps": self._paused_sweeps,
                "rows_scanned": self._rows_scanned,
                "rows_scanned_by_epoch": {
                    str(e): n
                    for e, n in sorted(self._rows_by_epoch.items())
                },
            }
        out["freshness_seconds"] = self.freshness_seconds()
        if self.watch_feed is not None:
            wstats = self.watch_feed.stats()
            out["watch_events_applied"] = wstats["events_applied"]
            out["watch_events_dropped"] = wstats["events_dropped"]
            out["watch_resyncs"] = wstats["resyncs"]
        else:
            out["watch_events_applied"] = 0
            out["watch_events_dropped"] = 0
            out["watch_resyncs"] = 0
        rstats = self.reports.stats()
        out["reports_resident"] = rstats["resident"]
        out["reports_stale"] = rstats["stale"]
        sstats = self.snapshot.stats()
        out["snapshot_resources"] = sstats["resources"]
        out["snapshot_bytes"] = sstats["bytes"]
        if self.matrix is not None:
            out["matrix"] = self.matrix.stats()
        return out
