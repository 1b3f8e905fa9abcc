"""Live-cluster watch feed for the audit snapshot store.

Until round 13 the audit scanner's cluster inventory came from two
approximations of reality: /validate dirty-tracking (only objects that
happened to flow through the webhook) and a boot-time seed file
(``--audit-resources-file``). The reference's audit companion instead
LISTs the live cluster. This module closes that gap in-process: it runs
the SAME list+watch state machine the context service uses
(:func:`~policy_server_tpu_torch.context.service.run_watch_loop` —
resourceVersion resume on clean stream close, 410/transport-fault
re-LIST with backoff, interval resync bounding staleness) and folds the
events straight into the :class:`~policy_server_tpu_torch.audit.snapshot.
SnapshotStore`:

* **ADDED / MODIFIED** → a synthetic CREATE/UPDATE admission review;
  the store's supersede semantics keep only the newest generation.
* **DELETED** → a synthetic DELETE review; the store evicts the key and
  queues it for report pruning (the scanner's ``take_deletions`` drain).
* **full re-LIST** (resync, 410, recovery after an overflow) → the
  fresh inventory supersedes in bulk, and every key this feed
  previously fed that is ABSENT from the new LIST gets a synthetic
  DELETE — a deletion that happened while the stream was down must not
  leave a ghost report row.

Queueing is BOUNDED and loud: watcher threads (one per kind) push
events onto one bounded queue drained by a single applier thread (the
payload-encoding work of ``observe`` must not stall the HTTP streams).
When the queue is full the event is DROPPED, counted, and the kind's
watcher raises — forcing a full re-LIST resync, so a drop can delay
freshness but never corrupt the inventory. Every resync is counted per
reason (``expired`` / ``error`` / ``interval``).

Chaos site: ``watch.stream`` fires before every watch-stream connect —
a raise there exercises exactly the transport-fault resync path.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Iterable

from policy_server_tpu_torch import failpoints
from policy_server_tpu_torch.audit.snapshot import (
    SnapshotStore,
    resource_key as snapshot_key,
    synthesize_review,
)
from policy_server_tpu_torch.context.service import run_watch_loop, resource_key
from policy_server_tpu_torch.models.policy import ContextAwareResource
from policy_server_tpu_torch.telemetry.tracing import logger


class _QueueOverflow(Exception):
    """Raised into the watch loop when the bounded event queue is full:
    the loop treats it like a transport fault — backoff, then a full
    re-LIST that repairs whatever the dropped events would have done."""


def parse_watch_resources(spec: str) -> tuple[ContextAwareResource, ...]:
    """``"v1/Pod,apps/v1/Deployment"`` → ContextAwareResource tuple (the
    --audit-watch-resources flag format: apiVersion/Kind per entry)."""
    out = []
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        api_version, _, kind = entry.rpartition("/")
        if not api_version or not kind:
            raise ValueError(
                f"malformed watch resource {entry!r} "
                "(expected apiVersion/Kind, e.g. v1/Pod or "
                "apps/v1/Deployment)"
            )
        out.append(ContextAwareResource(api_version=api_version, kind=kind))
    return tuple(out)


class WatchFeed:
    """Owns the per-kind watcher threads + the applier thread feeding the
    snapshot store (see module docstring). ``fetcher`` is anything with
    the ``list_with_version(resource)`` / ``watch(resource, rv)``
    protocol — the in-cluster :class:`KubeApiFetcher`, or a synthetic
    cluster (tools/soak, tests)."""

    # applier drains up to this many events into ONE observe() call
    APPLY_CHUNK = 512

    def __init__(
        self,
        fetcher: Any,
        resources: Iterable[ContextAwareResource],
        snapshot: SnapshotStore,
        *,
        refresh_seconds: float = 30.0,
        max_queue_events: int = 65536,
        resync_multiplier: int = 10,
        statestore: Any = None,
        spill_interval_seconds: float = 30.0,
        resume_rvs: dict[str, str] | None = None,
        resume_fed: dict[str, dict[tuple, str]] | None = None,
    ) -> None:
        self.fetcher = fetcher
        self.resources = tuple(resources)
        self.snapshot = snapshot
        self.refresh_seconds = float(refresh_seconds)
        self.max_queue_events = max(1, int(max_queue_events))
        self.resync_multiplier = int(resync_multiplier)
        # durable audit spill (round 17, statestore.py): a DEDICATED
        # spiller thread periodically writes the per-kind resourceVersion
        # cursors + the fed-object map + the snapshot inventory, so a
        # restarted process RESUMES the watch streams (resume_rvs/
        # resume_fed seed the loops) instead of re-LISTing the whole
        # cluster. Off the applier thread on purpose: serializing a
        # 100k-row inventory must never stall event application into a
        # queue-overflow re-LIST. None = no --state-dir, bit-identical
        # pre-round-17 behavior.
        self.statestore = statestore
        self.spill_interval_seconds = float(spill_interval_seconds)
        self._resume_rvs = dict(resume_rvs or {})
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._cond = threading.Condition()
        # ("event", kind_key, etype, obj, rv) | ("replace", kind_key,
        # items, rv)
        self._queue: collections.deque = collections.deque()  # guarded-by: _cond
        # per kind: object identity -> snapshot-store key, for DELETE
        # synthesis on replace (applier-written; the spiller copies it,
        # so mutations AND copies hold the lock)
        self._fed: dict[str, dict[tuple, str]] = dict(resume_fed or {})  # guarded-by: _cond
        # per kind: the LIST rv the watcher last announced (watcher-
        # thread confined per kind; attached to the queued replace)
        self._list_rvs: dict[str, str] = {}  # graftcheck: lockfree — per-kind watcher-thread-confined
        # per kind: newest APPLIED resourceVersion — the spill cursor.
        # Advanced only after the snapshot observed the event/LIST, so a
        # spill can never persist a cursor ahead of its inventory (a
        # crash between would silently skip those events on resume).
        self._rvs: dict[str, str] = dict(resume_rvs or {})  # guarded-by: _cond
        self._events_applied = 0  # guarded-by: _cond
        self._events_dropped = 0  # guarded-by: _cond
        self._resyncs = 0  # guarded-by: _cond
        self._resync_reasons: dict[str, int] = {}  # guarded-by: _cond
        self._streams_opened = 0  # guarded-by: _cond
        self._replaces = 0  # guarded-by: _cond
        self._deletes_synthesized = 0  # guarded-by: _cond
        self._spills = 0  # guarded-by: _cond
        self._resumed_kinds = len(self._resume_rvs)  # graftcheck: lockfree — set once pre-start

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "WatchFeed":
        if self._threads:
            return self
        applier = threading.Thread(
            target=self._apply_loop, name="audit-watch-apply", daemon=True
        )
        applier.start()
        self._threads.append(applier)
        if self.statestore is not None:
            spiller = threading.Thread(
                target=self._spill_loop, name="audit-spill", daemon=True
            )
            spiller.start()
            self._threads.append(spiller)
        for r in self.resources:
            t = threading.Thread(
                target=self._watch_one,
                args=(r,),
                name=f"audit-watch-{resource_key(r)}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)
        logger.info(
            "audit watch feed started",
            extra={"span_fields": {
                "kinds": [resource_key(r) for r in self.resources],
                "max_queue_events": self.max_queue_events,
            }},
        )
        return self

    def stop(self) -> None:
        self._stop.set()
        # a watcher blocked inside fetcher.watch() only observes _stop
        # between events; fetchers that support it (SyntheticCluster)
        # close their streams so shutdown does not ride out the joins.
        # The in-cluster fetcher's streams have a bounded read timeout,
        # so its daemon watchers die on their own.
        close = getattr(self.fetcher, "close_streams", None)
        if close is not None:
            close()
        with self._cond:
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []

    # -- watcher side ------------------------------------------------------

    def _watch_one(self, resource: ContextAwareResource) -> None:
        def on_stream() -> None:
            with self._cond:
                self._streams_opened += 1
            failpoints.fire("watch.stream")

        def on_resync(key: str, reason: str) -> None:
            with self._cond:
                self._resyncs += 1
                self._resync_reasons[reason] = (
                    self._resync_reasons.get(reason, 0) + 1
                )
            logger.warning(
                "audit watch feed resynced %s via full re-LIST (%s)",
                key, reason,
            )

        def on_rv(key: str, rv: str) -> None:
            # announced before replace_kind on the same watcher thread:
            # _enqueue_replace attaches it to the queued LIST, and the
            # cursor only ADVANCES when the applier lands the inventory
            self._list_rvs[key] = rv

        run_watch_loop(
            self.fetcher,
            resource,
            stop=self._stop,
            refresh_seconds=self.refresh_seconds,
            replace_kind=self._enqueue_replace,
            apply_event=self._enqueue_event,
            # a spilled resourceVersion RESUMES the watch where the
            # crashed process left off (no boot LIST); a stale cursor
            # degrades to the loop's standard 410/error re-LIST path.
            # None = the loop's first pass does the boot LIST.
            rv=self._resume_rvs.get(resource_key(resource)),
            resync_multiplier=self.resync_multiplier,
            on_resync=on_resync,
            on_stream=on_stream,
            on_rv=on_rv,
        )

    def _enqueue_event(self, key: str, etype: str, obj: Any) -> None:
        rv = ((obj.get("metadata") or {}).get("resourceVersion")
              if isinstance(obj, dict) else None)
        with self._cond:
            if len(self._queue) >= self.max_queue_events:
                self._events_dropped += 1
                # raising into run_watch_loop forces the full re-LIST
                # that repairs whatever this drop lost — loud, bounded,
                # never silently stale
                raise _QueueOverflow(
                    f"watch event queue full ({self.max_queue_events}); "
                    f"dropping {etype} for {key} and forcing a resync"
                )
            self._queue.append(
                ("event", key, etype, obj, str(rv) if rv else None)
            )
            self._cond.notify()

    def _enqueue_replace(self, key: str, items: Iterable[Any]) -> None:
        items = tuple(items)
        with self._cond:
            # a replace supersedes every queued event of this kind —
            # purging them guarantees space and keeps per-kind ordering
            self._queue = collections.deque(
                e for e in self._queue if e[1] != key
            )
            self._queue.append(
                ("replace", key, items, self._list_rvs.get(key))
            )
            self._cond.notify()

    # -- applier side ------------------------------------------------------

    def _apply_loop(self) -> None:
        while True:
            batch: list = []
            with self._cond:
                while not self._queue and not self._stop.is_set():
                    self._cond.wait(timeout=0.5)
                if self._stop.is_set() and not self._queue:
                    return
                while self._queue and len(batch) < self.APPLY_CHUNK:
                    batch.append(self._queue.popleft())
            try:
                self._apply_batch(batch)
            except Exception as e:  # noqa: BLE001 — the feed must survive
                # any malformed object; the interval resync re-LISTs the
                # truth eventually
                logger.error("audit watch feed apply failed: %s", e)

    # -- spiller side ------------------------------------------------------

    def _spill_loop(self) -> None:
        while not self._stop.wait(self.spill_interval_seconds):
            self._spill_once()
        # final spill on clean shutdown so the next boot resumes from
        # the freshest possible cursor
        self._spill_once()

    def _spill_once(self) -> None:
        """One durable spill: cursor map + fed map + the whole snapshot
        inventory, one atomic journal replace. The cursors are copied
        BEFORE the inventory export, so concurrent application can only
        leave the inventory AHEAD of the cursor — the resume then
        replays overlapping events, which the store's supersede
        semantics absorb; a cursor ahead of its inventory (silently
        skipped events) is impossible by construction. Contained — a
        full disk degrades durability, never the feed."""
        if self.statestore is None:
            return
        try:
            with self._cond:
                rvs = dict(self._rvs)
                fed = {k: dict(m) for k, m in self._fed.items()}
            self.statestore.spill_audit(
                rvs, fed, self.snapshot.export_rows()
            )
            with self._cond:
                self._spills += 1
        except Exception as e:  # noqa: BLE001 — durability is best-effort
            logger.error("audit spill failed: %s", e)

    def _apply_batch(self, batch: list) -> None:
        from policy_server_tpu_torch.context.service import _object_key

        reviews: list = []
        applied = 0
        deletes = 0
        # kind -> newest rv in this batch's EVENT entries; committed to
        # the spill cursor only after the final observe below lands the
        # buffered reviews in the snapshot
        event_rvs: dict[str, str] = {}
        for entry in batch:
            if entry[0] == "replace":
                # flush ordered work queued before this replace first
                if reviews:
                    self.snapshot.observe(reviews)
                    reviews = []
                _kind, key, items, list_rv = entry
                reviews_r, deletes_r = self._replace_reviews(key, items)
                self.snapshot.observe(reviews_r)
                deletes += deletes_r
                with self._cond:
                    self._replaces += 1
                    self._deletes_synthesized += deletes_r
                    if list_rv:
                        # the LIST is now fully applied: the cursor may
                        # advance past everything it superseded
                        self._rvs[key] = list_rv
                event_rvs.pop(key, None)
                continue
            _tag, key, etype, obj, rv = entry
            op = {
                "ADDED": "CREATE",
                "MODIFIED": "UPDATE",
                "DELETED": "DELETE",
            }.get(etype)
            if op is None:
                continue
            review = synthesize_review(obj, op)
            if review is None:
                continue
            okey = _object_key(obj)
            skey = snapshot_key(review)
            with self._cond:
                fed = self._fed.setdefault(key, {})
                if op == "DELETE":
                    fed.pop(okey, None)
                elif skey is not None:
                    fed[okey] = skey
            if rv:
                event_rvs[key] = rv
            reviews.append(review)
            applied += 1
        if reviews:
            self.snapshot.observe(reviews)
        with self._cond:
            if applied:
                self._events_applied += applied
            # every buffered review is in the snapshot now: commit the
            # batch's event cursors
            self._rvs.update(event_rvs)

    def _replace_reviews(self, key: str, items: tuple) -> tuple[list, int]:
        """A full LIST for one kind → CREATE reviews for the inventory
        plus synthetic DELETEs for previously-fed objects that vanished
        while the stream was down (their report rows must prune)."""
        from policy_server_tpu_torch.context.service import _object_key

        with self._cond:
            fed = dict(self._fed.get(key) or {})
        fresh: dict[tuple, str] = {}
        reviews: list = []
        for obj in items:
            review = synthesize_review(obj, "CREATE")
            if review is None:
                continue
            skey = snapshot_key(review)
            if skey is not None:
                fresh[_object_key(obj)] = skey
            reviews.append(review)
        deletes = 0
        fresh_skeys = set(fresh.values())
        for okey, skey in fed.items():
            if okey in fresh:
                continue
            # deleted-and-RE-CREATED during the outage: the uid changed
            # but the same GVK/ns/name is alive in the fresh LIST — the
            # store is name-keyed, so a synthetic DELETE here would
            # evict the live row the CREATE above just recorded
            if skey in fresh_skeys:
                continue
            # identity + kind fields are recoverable from the store key:
            # group/version/kind/namespace/name
            group, version, kind, ns, name = skey.split("/", 4)
            obj = {
                "apiVersion": f"{group}/{version}" if group else version,
                "kind": kind,
                "metadata": {"name": name, "namespace": ns or None},
            }
            review = synthesize_review(obj, "DELETE")
            if review is not None:
                reviews.append(review)
                deletes += 1
        with self._cond:
            self._fed[key] = fresh
        return reviews, deletes

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict[str, Any]:
        with self._cond:
            return {
                "events_applied": self._events_applied,
                "events_dropped": self._events_dropped,
                "resyncs": self._resyncs,
                "resync_reasons": dict(self._resync_reasons),
                "streams_opened": self._streams_opened,
                "replaces": self._replaces,
                "deletes_synthesized": self._deletes_synthesized,
                "queue_depth": len(self._queue),
                "spills": self._spills,
                "resumed_kinds": self._resumed_kinds,
            }
