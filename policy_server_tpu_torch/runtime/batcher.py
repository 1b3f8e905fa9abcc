"""MicroBatcher — gathers concurrent requests into batched evaluations and
decides where each batch is answered.

Requests from any number of threads queue up; one loop thread takes the
first waiting request, drains whatever else is queued, waits at most
``batch_timeout_ms`` for more (or until ``max_batch_size`` are waiting),
and hands the formed batch to a pipeline pool of four workers, so that
consecutive batches overlap (batch N+1 encodes while
batch N's device step runs). Requests addressed to different policies share a batch, since every
launch computes every policy's verdict.

Per batch:

1. the service layer's pre-evaluation (id parse, the always-accept
   namespace) and the targets' pre-eval hooks, under the request deadline;
2. routing: a batch of at most ``host_fastpath_threshold`` rows, or one
   whose measured device round trip (a per-bucket EWMA) would blow the
   oldest request's ``latency_budget_ms`` while the host would not, is
   answered by the environment's host oracle
   (``validate_batch(prefer_host=True)``); every other batch runs the
   native pipeline (``validate_batch_begin`` then ``validate_batch_finish``
   on one worker, with cache hits as pre-built fragments);
3. the ``policy_timeout`` watchdog: requests still unanswered at their
   deadline resolve in-band with "execution deadline exceeded"; a batch
   whose every request expired is abandoned (its late verdicts are thrown
   away) and, when the device wait was long, reported to the breaker;
4. the service layer's mode and mutation constraints (skipped for
   fragment verdicts, whose eligibility proved them the identity) and
   one evaluation metric per answered request, flushed once per batch
   (``record_evaluations_batch``).

With a flight recorder installed (``telemetry/flightrec.py``) each batch
stamps ``queue_wait`` (oldest enqueue → formed), ``form`` (phase 1),
``dispatch`` (phase 2's window), ``handoff`` (the pool pickup and the
wake after the work, inside the dispatch window) and ``deliver`` (phase
3), each at one site below; the environment's phases run under the
batch's id (``flightrec.batch_scope``) on the worker. Per-row recorder
work is batch-granular: one exemplar offer and one stride reservation per
batch.

While the environment's breaker is fully open, ``degraded_mode`` other
than ``oracle`` answers accept-all (``monitor``) or in-band 503s
(``reject``) instead of evaluating.

Completion is per request through a Future, or batch-granular: rows
admitted with ``submit_many(items, origin, sink=..., tokens=[...])`` get no
Future, and ``sink.deliver_many([(token, response, exc), ...])`` is called
once per phase of a dispatched batch that answers any of them (the native
HTTP frontend's bulk completion). The pipeline workers call it
concurrently; a sink that raises is logged and never takes the batch down.

The submission queue is bounded (``queue_capacity``, by default eight
batches; the server passes ``--workers`` × ``--max-batch-size``). A full
queue waits for room in 50 ms slices up to the request's policy timeout
(without one, for as long as it takes) and then answers an in-band 429,
"policy server overloaded"; callers that must never block
(``submit_nowait``, and the rows of a ``submit_many`` burst that do not
fit) park that wait on a pool of eight overload threads. ``shutdown()``
answers every row still queued, and every later submission, with an
in-band 503, "policy server shutting down".

With ``request_timeout_ms`` above 0 (the server's ``--request-timeout-ms``,
10,000 by default) every row carries a propagated deadline: a submission
whose estimated queue wait (``estimated_wait``, from the measured device
round trip) already exceeds its budget is shed with ``ShedError`` (429 and
Retry-After), an overload wait ends at the deadline, and a row whose
deadline passed in the queue is dropped before it is encoded, answered 504
"request deadline exceeded before evaluation". A tenant's ``admission``
quota (``tenancy.TenantAdmission``) is charged once per submission and
released exactly once per row, on whichever answer comes first; a
``scheduler`` (``runtime/scheduler.py``) grants each batch's evaluation a
dispatch slot shared by every tenant. A dispatch loop that dies holding
popped rows answers each ``FencedError`` (503 and Retry-After): they were
never dispatched, so a retry is safe. ``fence_drain()`` hands the serving
shard router (``runtime/shards.py``) every row still queued.

Construction does not start the dispatch loop: ``start()`` does (an epoch
of the policy lifecycle is built and warmed, and started only when it is
promoted). ``dispatch_wedged()`` and ``revive_dispatch()`` are the self-heal
watchdog's view of the loop (``supervision.py``); a ``shadow_recorder``
sees every formed batch's ``(policy_id, request)`` pairs once (the reload
canary's replay ring, ``lifecycle.py``), and an ``audit_tracker`` (the
audit scanner's ``SnapshotStore``) every formed batch's VALIDATE requests.

A second, best-effort lane serves the background audit scanner
(``submit_audit``): an audit batch is dispatched only when the loop finds
the live queue empty and the measured device round trip of the batch fits
in half the request deadline, at most one audit dispatch is in flight (a
pool of one thread of its own), and a popped audit batch whose worker sees
live work queued goes back to the head of its lane (a preemption). Audit
batches are raw verdicts (``validate_batch(..., run_hooks=False)``), on a
card through the device path. With a ``verdict_matrix``
(``audit/matrix.py``) a VALIDATE UPDATE byte-identical to a row the audit
lane judged is answered from the stored verdict at submission, before
shedding and quota (lookup admission).
"""

from __future__ import annotations

import collections
import logging
import math
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any

from policy_server_tpu_torch import failpoints
from policy_server_tpu_torch.api.api_error import FencedError, ShedError
from policy_server_tpu_torch.api import service
from policy_server_tpu_torch.api.service import (
    RequestOrigin,
    handle_initialization_error,
    post_evaluate,
    pre_evaluate,
)
from policy_server_tpu_torch.evaluation.environment import (
    bucket_size,
    fragment_responses,
)
from policy_server_tpu_torch.evaluation.errors import PolicyInitializationError
from policy_server_tpu_torch.evaluation.policy_id import PolicyID
from policy_server_tpu_torch.models import AdmissionResponse, ValidateRequest
from policy_server_tpu_torch.models.admission import FragVerdict
from policy_server_tpu_torch.runtime.workers import DaemonExecutor
from policy_server_tpu_torch.telemetry import flightrec

logger = logging.getLogger("kubewarden-policy-server")

DEFAULT_MAX_BATCH_SIZE = 128
DEFAULT_BATCH_TIMEOUT_MS = 1.0
DEFAULT_POLICY_TIMEOUT = 2.0
DEFAULT_HOST_FASTPATH_THRESHOLD = 64
DEFAULT_LATENCY_BUDGET_MS = 50.0
DEGRADED_MODES = ("oracle", "monitor", "reject")

DEADLINE_MESSAGE = "execution deadline exceeded"
# a row whose propagated deadline passed while it queued: the webhook
# caller has given up, so it is dropped before encode and dispatch
EXPIRED_MESSAGE = "request deadline exceeded before evaluation"
DEGRADED_MESSAGE = "policy server degraded: device backend unavailable"
OVERLOADED_MESSAGE = "policy server overloaded"
STOPPING_MESSAGE = "policy server shutting down"
_AUDIT_CLOSED = "batcher shutting down; audit lane closed"

# pipeline workers: consecutive batches overlap across them
PIPELINE_WORKERS = 4


class _Pending:
    __slots__ = (
        "policy_id", "request", "origin", "future", "enqueued_at", "sink",
        "token", "answered", "deadline", "quota_token", "owner",
    )

    def __init__(
        self,
        policy_id: str,
        request: ValidateRequest,
        origin: RequestOrigin,
        future: Future | None,
        enqueued_at: float | None = None,
        sink: Any = None,
        token: Any = None,
    ) -> None:
        self.policy_id = policy_id
        self.request = request
        self.origin = origin
        # None for a row delivered through ``sink`` (submit_many): its
        # answer joins its batch's one ``sink.deliver_many`` call
        self.future = future
        self.enqueued_at = (
            time.perf_counter() if enqueued_at is None else enqueued_at
        )
        self.sink = sink
        self.token = token
        # a sink row's first answer wins, as a Future's does: the watchdog
        # and a late result, or a failed batch, may both try, each on the
        # batch's one worker thread, so no lock is needed
        self.answered = False
        # the propagated deadline (absolute perf_counter time), stamped at
        # submission under a request timeout; None without one
        self.deadline: float | None = None
        # the TenantAdmission this row was charged to, cleared by its first
        # answer so the in-flight claim is released exactly once
        self.quota_token: Any = None
        # the batcher responsible for answering the row while it is queued:
        # stamped at every enqueue, cleared by fence_drain under the queue
        # mutex, stamped again by the sibling a fenced row is re-routed to
        self.owner: Any = None


class _DeliveryBatch:
    """Sink completions gathered over one phase of a batch; ``flush()``
    calls each sink once."""

    __slots__ = ("_by_sink",)

    def __init__(self) -> None:
        self._by_sink: dict = {}

    def add(self, p: _Pending, response: Any = None, exc: Any = None) -> None:
        self._by_sink.setdefault(p.sink, []).append((p.token, response, exc))

    def flush(self) -> None:
        for sink, items in self._by_sink.items():
            _deliver_sink(sink, items)
        self._by_sink.clear()


def _fail_future(future: Future, exc: BaseException) -> None:
    try:
        future.set_exception(exc)
    except Exception:  # noqa: BLE001 — a racing completion won
        pass


def _deliver_sink(sink: Any, items: list) -> None:
    """One batch-granular completion call; a broken sink never takes the
    dispatch path down."""
    try:
        sink.deliver_many(items)
    except Exception:  # noqa: BLE001 — delivery is best-effort
        logger.exception("completion sink failed; batch dropped on floor")


class _BatchRec:
    """One batch's flight-recorder context: the batch id and the phase
    boundary stamps the batcher reads anyway (formed, phase-1 end, the
    dispatch window); a row's exemplar breakdown reuses them."""

    __slots__ = ("rec", "bid", "formed_at", "form_ns", "disp_ns")

    def __init__(self, rec: flightrec.FlightRecorder, formed_at: float) -> None:
        self.rec = rec
        self.bid = rec.next_batch()
        self.formed_at = formed_at
        self.form_ns = 0  # phase-1 duration, set when PH_FORM records
        self.disp_ns = 0  # dispatch duration, set when PH_DISPATCH records

    def row_breakdown(self, enqueued_at: float) -> dict:
        return {
            flightrec.PH_QUEUE_WAIT: int(
                max(0.0, self.formed_at - enqueued_at) * 1e9
            ),
            flightrec.PH_FORM: self.form_ns,
            flightrec.PH_DISPATCH: self.disp_ns,
        }


class _AuditJob:
    """One audit-lane batch: ``pairs`` of (policy_id, request), resolved
    with the raw verdicts (audit origin: no constraint applied)."""

    __slots__ = ("pairs", "future")

    def __init__(self, pairs: list, future: Future):
        self.pairs = pairs
        self.future = future


class MicroBatcher:
    """Thread-safe evaluation front: ``submit()`` returns a Future resolved
    with the final response (service-layer constraints applied; an
    ``AdmissionResponse``, or a ``FragVerdict`` for a cache hit, which
    serializes to the same bytes) or the EvaluationError of an invalid or
    unknown policy id. ``start()`` starts its loop thread; ``shutdown()``
    stops it and answers what is left."""

    def __init__(
        self,
        env: Any,
        max_batch_size: int = DEFAULT_MAX_BATCH_SIZE,
        batch_timeout_ms: float = DEFAULT_BATCH_TIMEOUT_MS,
        policy_timeout: float | None = DEFAULT_POLICY_TIMEOUT,
        host_fastpath_threshold: int = DEFAULT_HOST_FASTPATH_THRESHOLD,
        latency_budget_ms: float = DEFAULT_LATENCY_BUDGET_MS,
        degraded_mode: str = "oracle",
        queue_capacity: int | None = None,
        shadow_recorder: Any = None,
        request_timeout_ms: float = 0.0,
        admission: Any = None,
        scheduler: Any = None,
        tenant: str = "default",
        audit_tracker: Any = None,
        verdict_matrix: Any = None,
    ) -> None:
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be at least 1")
        if degraded_mode not in DEGRADED_MODES:
            raise ValueError(f"unknown degraded mode {degraded_mode!r}")
        self.env = env
        self.max_batch_size = max_batch_size
        self.batch_timeout = max(0.0, batch_timeout_ms) / 1e3
        self.policy_timeout = policy_timeout
        self.host_fastpath_threshold = max(0, int(host_fastpath_threshold))
        # a soft per-request latency target for routing (distinct from
        # policy_timeout, the hard in-band deadline); None disables it
        self.latency_budget = (
            None if latency_budget_ms <= 0 else latency_budget_ms / 1e3
        )
        # the propagated request deadline (a webhook's timeoutSeconds,
        # distinct from policy_timeout, the bound on one evaluation); None
        # disables deadlines and load shedding
        self.request_timeout = (
            request_timeout_ms / 1e3 if request_timeout_ms > 0 else None
        )
        self.degraded_mode = degraded_mode
        # the tenant's admission quota (tenancy.TenantAdmission), charged
        # once per submission; None without one
        self.admission = admission
        # the dispatch slots every tenant's batcher shares
        # (runtime/scheduler.py); None without tenants
        self.scheduler = scheduler
        # this batcher's tenant: also the failpoint scope its evaluation
        # threads carry, so a scoped fault hits one tenant
        self.tenant = tenant
        # the serving shard's failpoint scope ("shard-<i>", set by the
        # shard router) under which the loop fires ``shard.dispatch``;
        # None passes the caller's scope through
        self.failpoint_scope: str | None = None
        # the reload canary's replay ring (lifecycle.ShadowRecorder): one
        # observe per formed batch; None when reload is off
        self.shadow_recorder = shadow_recorder
        # the audit scanner's inventory (audit.SnapshotStore): every formed
        # batch's VALIDATE requests, one observe per batch; None when the
        # scanner is off (and for named tenants)
        self.audit_tracker = audit_tracker
        # the verdict matrix (audit.VerdictMatrix) of lookup admission;
        # None without --audit-matrix
        self.verdict_matrix = verdict_matrix
        self._env_fastpath = env.supports_host_fastpath
        # EWMA device round trip per batch bucket, seconds (seeded by
        # warmup, learned from real dispatches, decayed on each budget
        # bypass so a stale slow reading re-probes the device); benign
        # races between workers: the last EWMA step wins
        self._dev_rtt: dict[int, float] = {}
        # EWMA host fast-path cost per row, seconds
        self._host_cost_per_row = 1e-4
        # policy ids known to resolve, and whether their target has hooks
        self._hookless: dict[str, bool] = {}
        # policy id → its payload is the bare request (no cluster
        # snapshot, no provider output); lookup admission needs it
        self._plain: dict[str, bool] = {}
        self._queue: queue.Queue[_Pending] = queue.Queue(
            maxsize=queue_capacity or self.max_batch_size * 8
        )
        self._stop = threading.Event()
        # set first by shutdown(): every submission from then on answers
        # 503, and overload waiters see it within one wait slice
        self._stopping = False
        self._thread: threading.Thread | None = None
        # the bounded waits of rows that found the queue full and whose
        # caller must not block (submit_nowait, a burst's overflow)
        self._overload_pool = DaemonExecutor(8, "overload-wait")
        # batch workers run a batch's phases and its watchdog wait; device
        # workers run the evaluation itself, so a hung device call wedges a
        # device worker, never a batch worker (daemon threads: a wedged
        # call is abandoned at exit, never joined)
        self._batch_workers = PIPELINE_WORKERS
        self._batch_pool = DaemonExecutor(self._batch_workers, "batch")
        self._device_pool = DaemonExecutor(self._batch_workers, "device-dispatch")
        self._inflight = threading.BoundedSemaphore(self._batch_workers)
        self._stats_lock = threading.Lock()
        self.batches = 0  # guarded-by: _stats_lock; formed micro-batches
        self.batch_rows = 0  # guarded-by: _stats_lock; rows in them
        self.host_fastpath_batches = 0  # guarded-by: _stats_lock
        # host-routed by the latency budget (a subset of the above)
        self.budget_routed_batches = 0  # guarded-by: _stats_lock
        self.deadline_abandoned_batches = 0  # guarded-by: _stats_lock
        # requests answered in-band with DEADLINE_MESSAGE, and the longest
        # time from submission to an answer (how near policy_timeout the
        # answers come)
        self.deadline_rejections = 0  # guarded-by: _stats_lock
        self.max_answer_seconds = 0.0  # guarded-by: _stats_lock
        self.degraded_responses = 0  # guarded-by: _stats_lock
        # rows shed at admission (429), and rows dropped with their
        # deadline passed before evaluation (504)
        self.shed_requests = 0  # guarded-by: _stats_lock
        self.expired_dropped = 0  # guarded-by: _stats_lock
        # summed time from submission to batch formation
        self.queue_wait_ns = 0  # guarded-by: _stats_lock
        # submit_many calls and the rows they carried (rows per call is
        # the burst size the native frontend admits at once)
        self.bulk_submits = 0  # guarded-by: _stats_lock
        self.bulk_submitted_rows = 0  # guarded-by: _stats_lock
        # audit batches dispatched and the rows they carried, and those
        # re-queued because live work arrived first
        self.audit_batches_dispatched = 0  # guarded-by: _stats_lock
        self.audit_rows_dispatched = 0  # guarded-by: _stats_lock
        self.audit_preemptions = 0  # guarded-by: _stats_lock
        # requests answered from the verdict matrix, and matrix-eligible
        # ones it could not answer
        self.matrix_lookup_hits = 0  # guarded-by: _stats_lock
        self.matrix_lookup_misses = 0  # guarded-by: _stats_lock
        # fragment-lane metric memo: label tuple -> metric (bounded)
        self._metric_memo: dict[tuple, Any] = {}
        # the audit lane: jobs wait in a deque (a preempted one goes back
        # to its head); the pool of one thread is the one-in-flight cap
        self._audit_lock = threading.Lock()
        self._audit_jobs: collections.deque[_AuditJob] = (
            collections.deque()
        )  # guarded-by: _audit_lock
        self._audit_inflight = False  # guarded-by: _audit_lock
        self._audit_pool = DaemonExecutor(1, "audit-dispatch")

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "MicroBatcher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="micro-batcher", daemon=True
            )
            self._thread.start()
        return self

    def dispatch_wedged(self) -> bool:
        """True when the dispatch loop died outside shutdown: submissions
        still queue, nothing forms a batch."""
        t = self._thread
        return (
            t is not None
            and not t.is_alive()
            and not self._stopping
            and not self._stop.is_set()
        )

    def revive_dispatch(self) -> bool:
        """Start a new dispatch loop in place of a dead one (the queue and
        the pools are still up). False when there is nothing to revive:
        alive, never started, or shutting down."""
        if not self.dispatch_wedged():
            return False
        self._thread = threading.Thread(
            target=self._loop, name="micro-batcher-revived", daemon=True
        )
        self._thread.start()
        return True

    def warmup(self) -> None:
        """Warm every batch bucket up to ``max_batch_size`` and seed the
        device-RTT estimator: each bucket warms twice, and the second run
        is the routing and shedding baseline."""
        sizes = []
        b = 1
        while b < self.max_batch_size:
            sizes.append(b)
            b <<= 1
        sizes.append(bucket_size(self.max_batch_size))
        self.env.warmup(tuple(sizes))
        # the estimators serve the latency-budget router and the shedding
        # check alike, so either knob seeds them; the seed is the second,
        # build-free run (a first run's program build would overestimate
        # the wait and shed sound traffic at boot)
        if self.latency_budget is None and self.request_timeout is None:
            return
        # one warmup((b,)) dispatches once per schema bucket; a serving
        # batch dispatches once
        per_warmup = self.env.warmup_dispatches
        for b in sizes:
            t0 = time.perf_counter()
            self.env.warmup((b,))
            self._dev_rtt[bucket_size(b)] = (time.perf_counter() - t0) / per_warmup

    def shutdown(self) -> None:
        """Stop the loop and answer every row: batches already formed
        finish (bounded by the watchdog), rows still queued and every later
        submission answer 503. The batcher borrows its environment and
        never closes it."""
        # refuse new rows and wake the overload waiters into the 503 path
        # before draining, so no put that lands after the drain strands
        self._stopping = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._batch_pool.shutdown(wait=True)
        self._drain_rejecting()
        # every overload waiter sees _stopping within a slice and answers
        # itself, or has enqueued; the second drain answers the latter
        self._overload_pool.shutdown(wait=True)
        self._drain_rejecting()
        # a wedged device call must not hold shutdown: its rows were
        # answered by the watchdog
        self._device_pool.shutdown(wait=False)
        # queued audit jobs fail (the scanner re-marks their rows dirty);
        # an audit dispatch in flight is abandoned, never joined
        self._drain_audit_rejecting()
        self._audit_pool.shutdown(wait=False)

    def _drain_rejecting(self) -> None:
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            self._reject_stopping(p)

    def fence_drain(self) -> list[_Pending]:
        """Take every row still queued, atomically (the shard router's
        fencing step). A queued row belongs to no batch worker and has not
        been answered, so the router may re-route it or answer it 503
        without a second answer being possible; rows the loop already
        popped are answered by their batch worker (or, when the loop died
        holding them, ``FencedError``). Overload waiters are woken to see
        the room."""
        q = self._queue
        with q.mutex:
            taken = list(q.queue)
            q.queue.clear()
            for p in taken:
                p.owner = None  # the router answers for them now
            q.not_full.notify_all()
        return taken

    # -- admission: deadlines, shedding and quota ----------------------------

    def estimated_wait(self) -> float:
        """Seconds until a row enqueued now would be dispatched: the queue
        in batches × the measured device round trip of a full batch, over
        the pipeline width (the host's cost per row stands in before any
        device measurement). The shedding signal; it adds no margin, since
        shedding on a pessimistic estimate would turn a burst that clears
        into 429s."""
        depth = self._queue.qsize()
        if depth <= 0:
            return 0.0
        rtt = self._dev_rtt.get(bucket_size(self.max_batch_size))
        if rtt is None:
            rtt = self._host_cost_per_row * self.max_batch_size
        batches = math.ceil(depth / self.max_batch_size)
        return batches * rtt / self._batch_workers

    def _shed_check(self, pending: _Pending) -> None:
        """Raise ShedError when the estimated wait already exceeds the
        row's remaining budget (no-op without a request timeout)."""
        if pending.deadline is None:
            return
        est = self.estimated_wait()
        if est > pending.deadline - time.perf_counter():
            with self._stats_lock:
                self.shed_requests += 1
            raise ShedError(est)

    def _admit_quota(self, pendings: list[_Pending]) -> None:
        """Charge the rows to the tenant's quota; a denial raises ShedError
        and counts the rows as shed here too (no-op without a quota)."""
        adm = self.admission
        if adm is None:
            return
        try:
            adm.admit(len(pendings))
        except ShedError:
            with self._stats_lock:
                self.shed_requests += len(pendings)
            raise
        for p in pendings:
            p.quota_token = adm

    @staticmethod
    def _release_quota(p: _Pending) -> None:
        """Release a row's in-flight claim on its first answer (the token is
        cleared, so a later answer releases nothing)."""
        tok = p.quota_token
        if tok is not None:
            p.quota_token = None
            tok.release(1)

    def _stamp(self, pending: _Pending) -> _Pending:
        if self.request_timeout is not None:
            pending.deadline = pending.enqueued_at + self.request_timeout
        return pending

    # -- submission --------------------------------------------------------

    def _try_matrix(self, p: _Pending) -> bool:
        """Lookup admission: answer the row from the verdict matrix when
        every gate holds — VALIDATE origin, an UPDATE (a CREATE or DELETE
        changes the inventory), no always-accept namespace, a hookless
        target whose payload is the bare request (no cluster snapshot),
        and the matrix's own (byte-identical payload, current column
        fingerprint, fragment eligibility). A hit resolves as a
        FragVerdict and is not recorded for the audit tracker (its payload
        is the row the verdict came from). False on any miss."""
        matrix = self.verdict_matrix
        if matrix is None or p.origin is not RequestOrigin.VALIDATE:
            return False
        adm = p.request.admission_request
        if adm is None or (adm.operation or "").upper() != "UPDATE":
            return False
        if self.env.always_accept_namespace is not None:
            return False
        if self._target_hookless(p.policy_id) is not True:
            return False
        if self._target_plain(p.policy_id) is not True:
            # the payload carries the cluster snapshot: a cell judged
            # under an older snapshot would answer stale
            return False
        tmpl = matrix.lookup(p.policy_id, p.request, self.env)
        if not tmpl:
            with self._stats_lock:
                self.matrix_lookup_misses += 1
            return False
        done_at = time.perf_counter()
        with self._stats_lock:
            self.matrix_lookup_hits += 1
        try:
            service._registry().record_evaluations_batch(
                [((done_at - p.enqueued_at) * 1e3, self._metric_of(p, tmpl))]
            )
        except Exception:  # noqa: BLE001 — metrics must not fail serving
            pass
        verdict = FragVerdict(p.request.uid(), tmpl)
        self._resolve(
            p, verdict if p.sink is not None else verdict.to_response()
        )
        return True

    def _metric_of(self, p: _Pending, tmpl: Any) -> Any:
        """The evaluation metric of a row answered from a template,
        memoized by its labels (bounded at 4,096: a stream of ever-new
        labels is built per row)."""
        adm = p.request.admission_request
        key = (
            p.policy_id, p.origin, tmpl.allowed, tmpl.code,
            adm.request_kind.kind if adm.request_kind else "",
            adm.namespace, adm.operation,
        )
        m = self._metric_memo.get(key)
        if m is None:
            m = service.evaluation_metric(
                self.env, p.policy_id, p.request, p.origin,
                accepted=tmpl.allowed, mutated=False, error_code=tmpl.code,
            )
            if len(self._metric_memo) < 4096:
                self._metric_memo[key] = m
        return m

    def submit(
        self,
        policy_id: str,
        request: ValidateRequest,
        origin: RequestOrigin = RequestOrigin.VALIDATE,
    ) -> Future:
        """Queue one request → a Future of its response. A full queue waits
        for room (``_put_waiting``); after ``shutdown()`` the Future holds
        the 503. Under a request timeout or a quota this may raise
        ShedError instead."""
        pending = self._stamp(_Pending(policy_id, request, origin, Future()))
        if self._stopping:
            self._reject_stopping(pending)
            return pending.future
        if self._try_matrix(pending):
            return pending.future
        self._shed_check(pending)
        self._admit_quota([pending])
        self._put_waiting(pending)
        return pending.future

    # overload waiters sleep in bounded slices, so each sees shutdown
    # within one slice (an unbounded put could outlast the drain)
    _WAIT_SLICE_SECONDS = 0.05

    def _put_waiting(self, pending: _Pending) -> bool:
        """Enqueue, waiting for room up to the request's policy timeout and
        its propagated deadline (unbounded without either) and always
        watching ``_stopping``. True when enqueued; False when answered
        in-band (429, 504 or 503)."""
        while True:
            if self._stopping:
                self._reject_stopping(pending)
                return False
            bounds = []
            if self.policy_timeout is not None:
                bounds.append(pending.enqueued_at + self.policy_timeout)
            if pending.deadline is not None:
                bounds.append(pending.deadline)
            if not bounds:
                wait = self._WAIT_SLICE_SECONDS
            else:
                now = time.perf_counter()
                remaining = min(bounds) - now
                if remaining <= 0:
                    # a wait that ran out the propagated deadline is an
                    # expired drop (504, counted), not an overload 429
                    if pending.deadline is not None and now >= pending.deadline:
                        self._reject_expired(pending)
                    else:
                        self._reject_overloaded(pending)
                    return False
                wait = min(self._WAIT_SLICE_SECONDS, remaining)
            try:
                self._queue.put(pending, timeout=wait)
                pending.owner = self
            except queue.Full:
                continue
            # shutdown may have finished both drains between the check
            # above and this put: drain again (a second answer to a row
            # is dropped)
            if self._stopping:
                self._drain_rejecting()
            return True

    def submit_nowait(
        self,
        policy_id: str,
        request: ValidateRequest,
        origin: RequestOrigin = RequestOrigin.VALIDATE,
    ) -> Future:
        """``submit`` for callers that must never block (the native
        frontend's drainer): a full queue parks the bounded wait on the
        overload pool and the Future is returned at once. Sheds as
        ``submit`` does."""
        pending = self._stamp(_Pending(policy_id, request, origin, Future()))
        if self._stopping:
            self._reject_stopping(pending)
            return pending.future
        if self._try_matrix(pending):
            return pending.future
        self._shed_check(pending)
        self._admit_quota([pending])
        try:
            self._queue.put_nowait(pending)
            pending.owner = self
            if self._stopping:
                self._drain_rejecting()
            return pending.future
        except queue.Full:
            pass
        try:
            self._overload_pool.submit(self._put_waiting, pending)
        except RuntimeError:  # the pool was shut down: a stop race
            self._reject_stopping(pending)
        return pending.future

    def submit_many(
        self,
        items: list[tuple[str, ValidateRequest]],
        origin: RequestOrigin = RequestOrigin.VALIDATE,
        sink: Any = None,
        tokens: list | None = None,
    ) -> list[Future] | None:
        """Queue a burst under one admission stamp, one shed estimate and
        one quota charge. Without ``sink``: one Future per item. With
        ``sink`` and a parallel list of ``tokens``: no Futures (returns
        None); ``sink.deliver_many([(token, response, exc), ...])`` answers
        the rows batch by batch. A shed burst answers every row ShedError
        (a bulk call cannot raise per row). Rows that do not fit the queue
        wait on the overload pool; never blocks."""
        if sink is not None and (tokens is None or len(tokens) != len(items)):
            raise ValueError("a sink needs one token per item")
        now = time.perf_counter()
        if sink is None:
            futures: list[Future] | None = [Future() for _ in items]
            pendings = [
                _Pending(pid, req, origin, fut, now)
                for (pid, req), fut in zip(items, futures)
            ]
        else:
            futures = None
            pendings = [
                _Pending(pid, req, origin, None, now, sink, token)
                for (pid, req), token in zip(items, tokens)
            ]
        if self.request_timeout is not None:
            deadline = now + self.request_timeout
            for p in pendings:
                p.deadline = deadline
        with self._stats_lock:
            self.bulk_submits += 1
            self.bulk_submitted_rows += len(pendings)
        if self._stopping:
            for p in pendings:
                self._reject_stopping(p)
            return futures
        if self.verdict_matrix is not None:
            # lookup admission row by row before the burst's shed and
            # quota: a hit takes no queue room and no quota
            pendings = [p for p in pendings if not self._try_matrix(p)]
            if not pendings:
                return futures
        if self.request_timeout is not None:
            est = self.estimated_wait()
            if est > self.request_timeout:
                with self._stats_lock:
                    self.shed_requests += len(pendings)
                self._fail_all(pendings, ShedError(est))
                return futures
        if self.admission is not None:
            try:
                self._admit_quota(pendings)
            except ShedError as err:
                self._fail_all(pendings, err)
                return futures
        overflow = self._put_burst(pendings)
        if self._stopping:
            self._drain_rejecting()
        for p in overflow:
            try:
                self._overload_pool.submit(self._put_waiting, p)
            except RuntimeError:  # the pool was shut down: a stop race
                self._reject_stopping(p)
        return futures

    def _put_burst(self, pendings: list[_Pending]) -> list[_Pending]:
        """Enqueue as many rows of a burst as fit under one acquisition of
        the queue's mutex (the deque and condition ``queue.Queue.put``
        uses, without its lock round-trip per row), stamping their owner
        under it → the rows that did not fit. Its one consumer, the
        formation loop, drains greedily, so a single notify wakes it."""
        q = self._queue
        with q.mutex:
            space = q.maxsize - len(q.queue) if q.maxsize > 0 else len(pendings)
            take = pendings[: max(0, space)]
            if take:
                for p in take:
                    p.owner = self
                q.queue.extend(take)
                q.unfinished_tasks += len(take)
                q.not_empty.notify()
        return pendings[len(take):]

    def _reject_overloaded(self, p: _Pending) -> None:
        self._resolve(
            p, AdmissionResponse.reject(p.request.uid(), OVERLOADED_MESSAGE, 429)
        )

    def _reject_stopping(self, p: _Pending) -> None:
        self._resolve(
            p, AdmissionResponse.reject(p.request.uid(), STOPPING_MESSAGE, 503)
        )

    def _reject_expired(
        self, p: _Pending, delivery: _DeliveryBatch | None = None
    ) -> None:
        """Answer a row whose propagated deadline passed before it was
        evaluated: 504 in-band, counted, never encoded."""
        with self._stats_lock:
            self.expired_dropped += 1
        self._resolve(
            p,
            AdmissionResponse.reject(p.request.uid(), EXPIRED_MESSAGE, 504),
            delivery,
        )

    def queue_depth(self) -> int:
        """Requests waiting for batch formation."""
        return self._queue.qsize()

    def stats_snapshot(self) -> dict[str, int]:
        """The /metrics scrape's counters under one acquisition of the
        stats lock, with the JAX package's key names."""
        with self._stats_lock:
            return {
                "batches_dispatched": self.batches,
                "requests_dispatched": self.batch_rows,
                "deadline_abandoned_batches": self.deadline_abandoned_batches,
                "host_fastpath_batches": self.host_fastpath_batches,
                "budget_routed_batches": self.budget_routed_batches,
                "shed_requests": self.shed_requests,
                "expired_dropped": self.expired_dropped,
                "degraded_responses": self.degraded_responses,
                "queue_wait_ns": self.queue_wait_ns,
                "bulk_submits": self.bulk_submits,
                "bulk_submitted_rows": self.bulk_submitted_rows,
                "audit_batches_dispatched": self.audit_batches_dispatched,
                "audit_rows_dispatched": self.audit_rows_dispatched,
                "audit_preemptions": self.audit_preemptions,
                "matrix_lookup_hits": self.matrix_lookup_hits,
                "matrix_lookup_misses": self.matrix_lookup_misses,
            }

    def evaluate(
        self,
        policy_id: str,
        request: ValidateRequest,
        origin: RequestOrigin = RequestOrigin.VALIDATE,
    ) -> Any:
        """Submit and wait (the synchronous convenience)."""
        return self.submit(policy_id, request, origin).result()

    # -- the best-effort audit lane ------------------------------------------

    def submit_audit(self, pairs: list) -> Future:
        """Queue one audit batch → a Future of ``validate_batch``'s results
        (raw verdicts, or an Exception per row), resolved whenever an idle
        slot dispatches it: the lane promises no latency. A stopping
        batcher fails the Future; this never raises."""
        future: Future = Future()
        if self._stopping:
            future.set_exception(RuntimeError(_AUDIT_CLOSED))
            return future
        with self._audit_lock:
            self._audit_jobs.append(_AuditJob(list(pairs), future))
        # shutdown may have drained the lane between the check and the
        # append: drain again
        if self._stopping:
            self._drain_audit_rejecting()
        return future

    def audit_lane_depth(self) -> int:
        """Audit batches waiting for an idle slot."""
        with self._audit_lock:
            return len(self._audit_jobs)

    def cancel_audit(self, future: Future) -> bool:
        """Take a job not yet dispatched out of the lane and fail its
        Future (the scanner abandons a job it timed out on, so retries do
        not stack duplicates). False when the job is gone already."""
        with self._audit_lock:
            for job in self._audit_jobs:
                if job.future is future:
                    self._audit_jobs.remove(job)
                    break
            else:
                return False
        _fail_future(future, RuntimeError("audit job cancelled by its submitter"))
        return True

    def _audit_slack_ok(self, audit_rows: int) -> bool:
        """True when one audit batch of ``audit_rows`` may be dispatched now
        without breaking a live request that arrives right after: the
        breaker is not fully open (the scan pauses instead of taking the
        oracle's capacity), and the batch's estimated device hold (the
        round-trip EWMA of a full bucket times the full buckets the rows
        span) fits in half the request deadline. The soft latency budget
        does not gate here: a live batch formed while an audit dispatch
        holds the device is routed to the host by the budget router."""
        if self.env.breaker_all_open:
            return False
        if self.request_timeout is None:
            return True
        bucket = bucket_size(self.max_batch_size)
        rtt = self._dev_rtt.get(bucket)
        if rtt is None:
            # no measurement yet: the first audit dispatch is one
            return True
        hold = rtt * max(1, math.ceil(audit_rows / bucket))
        return hold <= 0.5 * self.request_timeout

    def _maybe_dispatch_audit(self) -> None:
        """Called by the loop only when the live queue came up empty: hand
        at most one audit batch to the audit pool. The slack check runs
        outside the lane lock (it reads the breaker; the lane lock stays
        innermost)."""
        if self._stopping:
            return
        with self._audit_lock:
            if self._audit_inflight or not self._audit_jobs:
                return
            head_rows = len(self._audit_jobs[0].pairs)
        if not self._audit_slack_ok(head_rows):
            return
        with self._audit_lock:
            if self._audit_inflight or not self._audit_jobs:
                return
            job = self._audit_jobs.popleft()
            self._audit_inflight = True
        try:
            self._audit_pool.submit(self._run_audit_job, job)
        except RuntimeError:  # the pool was shut down: a stop race
            with self._audit_lock:
                self._audit_inflight = False
            _fail_future(job.future, RuntimeError(_AUDIT_CLOSED))

    def _requeue_audit(self, job: _AuditJob) -> None:
        """A preemption: the job goes back to the head of its lane."""
        with self._stats_lock:
            self.audit_preemptions += 1
        with self._audit_lock:
            self._audit_jobs.appendleft(job)

    def _run_audit_job(self, job: _AuditJob) -> None:
        try:
            # live work arrived between the pop and this worker's start:
            # the live batch goes first
            if self._queue.qsize() > 0 and not self._stopping:
                self._requeue_audit(job)
                return
            if self._stopping:
                _fail_future(job.future, RuntimeError(_AUDIT_CLOSED))
                return
            sched = self.scheduler
            granted = False
            if sched is not None:
                from policy_server_tpu_torch.runtime import scheduler as fair

                # under tenants audit also yields to every tenant's live
                # waiters: a bounded wait, then back to the lane's head
                granted = sched.acquire(
                    self.tenant, fair.AUDIT, timeout=0.5,
                    should_abort=lambda: self._stopping,
                )
                if not granted:
                    if self._stopping:
                        _fail_future(job.future, RuntimeError(_AUDIT_CLOSED))
                    else:
                        self._requeue_audit(job)
                    return
            try:
                try:
                    # raw verdicts on the device path, without hooks (the
                    # scan judges policy logic, as the reload canary does)
                    with failpoints.scope(self.tenant):
                        results = self.env.validate_batch(
                            job.pairs, run_hooks=False
                        )
                except Exception as e:  # noqa: BLE001 — the job carries it
                    _fail_future(job.future, e)
                    return
                with self._stats_lock:
                    self.audit_batches_dispatched += 1
                    self.audit_rows_dispatched += len(job.pairs)
                job.future.set_result(results)
            finally:
                if granted:
                    sched.release(self.tenant)
        finally:
            with self._audit_lock:
                self._audit_inflight = False

    def _drain_audit_rejecting(self) -> None:
        while True:
            with self._audit_lock:
                if not self._audit_jobs:
                    return
                job = self._audit_jobs.popleft()
            _fail_future(job.future, RuntimeError(_AUDIT_CLOSED))

    # -- the loop ----------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch: list[_Pending] = []
            try:
                # chaos site, before any pop: a raise kills this thread
                # holding no row (the self-heal and shard-fence drills),
                # under the shard's scope so one shard can be killed
                with failpoints.scope(self.failpoint_scope):
                    failpoints.fire("shard.dispatch")
                # the live lane is empty for the moment: the one time the
                # audit lane may claim a slot (under steady load the queue
                # drains to zero between bursts, and those gaps are the
                # idle capacity audit rides; its dispatch runs on a pool of
                # its own, so the get below is not delayed)
                if self._queue.qsize() == 0:
                    self._maybe_dispatch_audit()
                try:
                    first = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                batch.append(first)
                # a backlog drains at once: the timeout window only bounds
                # the latency ADDED under light load
                deadline = first.enqueued_at + self.batch_timeout
                while len(batch) < self.max_batch_size:
                    try:
                        batch.append(self._queue.get_nowait())
                        continue
                    except queue.Empty:
                        pass
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(self._queue.get(timeout=remaining))
                    except queue.Empty:
                        break
                self._launch_batch(batch)
            except BaseException:
                # the thread is dying: rows it popped belong to no batch
                # worker and were never dispatched, so answer each 503 with
                # Retry-After (a retry is safe) before dispatch_wedged()
                # sees the dead thread
                self._fail_all(batch, FencedError(0.5))
                raise

    def _launch_batch(self, batch: list[_Pending]) -> None:
        """Hand a formed batch to the pipeline pool (bounded in flight);
        a stop while waiting for a slot answers the batch 503."""
        while not self._inflight.acquire(timeout=0.05):
            if self._stopping or self._stop.is_set():
                for p in batch:
                    self._reject_stopping(p)
                return
        try:
            self._batch_pool.submit(self._process_batch, batch)
        except RuntimeError:  # the pool was shut down: a stop race
            self._inflight.release()
            for p in batch:
                self._reject_stopping(p)

    def _process_batch(self, batch: list[_Pending]) -> None:
        try:
            # the tenant's failpoint scope rides the batch worker
            with failpoints.scope(self.tenant):
                self._dispatch(batch)
        except Exception as e:  # noqa: BLE001 — the worker must survive
            logger.exception("micro-batch dispatch failed")
            delivery = _DeliveryBatch()
            for p in batch:
                self._fail(p, e, delivery)
            delivery.flush()
        finally:
            self._inflight.release()

    # -- completion --------------------------------------------------------

    def _resolve(
        self, p: _Pending, response: Any, delivery: _DeliveryBatch | None = None
    ) -> None:
        """Answer one row: its Future, or its sink through ``delivery``,
        which the caller flushes once for the batch (without one, the sink
        is called at once)."""
        self._release_quota(p)
        if p.sink is not None:
            if p.answered:
                return
            p.answered = True
            if delivery is None:
                _deliver_sink(p.sink, [(p.token, response, None)])
            else:
                delivery.add(p, response, None)
        else:
            if p.future.done():
                return
            try:
                p.future.set_result(response)
            except Exception:  # noqa: BLE001 — a racing completion won
                return
        waited = time.perf_counter() - p.enqueued_at
        with self._stats_lock:
            self.max_answer_seconds = max(self.max_answer_seconds, waited)

    @classmethod
    def _fail(
        cls, p: _Pending, exc: BaseException, delivery: _DeliveryBatch
    ) -> None:
        cls._release_quota(p)
        if p.sink is not None:
            if p.answered:
                return
            p.answered = True
            delivery.add(p, None, exc)
            return
        if not p.future.done():
            try:
                p.future.set_exception(exc)
            except Exception:  # noqa: BLE001 — a racing completion won
                pass

    def _reject_deadline(self, p: _Pending, delivery: _DeliveryBatch) -> None:
        with self._stats_lock:
            self.deadline_rejections += 1
        self._resolve(
            p,
            AdmissionResponse.reject(p.request.uid(), DEADLINE_MESSAGE, 500),
            delivery,
        )

    # -- one batch ---------------------------------------------------------

    def _dispatch(self, batch: list[_Pending]) -> None:
        formed_at = time.perf_counter()
        with self._stats_lock:
            self.batches += 1
            self.batch_rows += len(batch)
            self.queue_wait_ns += int(
                sum(formed_at - p.enqueued_at for p in batch) * 1e9
            )
        rec = flightrec.recorder()
        brec = None
        if rec is not None:
            brec = _BatchRec(rec, formed_at)
            rec.record_phase(
                flightrec.PH_QUEUE_WAIT,
                int(min(p.enqueued_at for p in batch) * 1e9),
                int(formed_at * 1e9),
                rows=len(batch), batch=brec.bid,
            )
        if self.shadow_recorder is not None:
            try:
                self.shadow_recorder.observe(
                    [(p.policy_id, p.request) for p in batch]
                )
            except Exception:  # noqa: BLE001 — the canary corpus just
                pass  # stays smaller; the batch is unaffected
        if self.audit_tracker is not None:
            try:
                # only objects admitted through /validate belong in the
                # cluster snapshot (audit replays must not feed it)
                self.audit_tracker.observe(
                    [p.request for p in batch
                     if p.origin is RequestOrigin.VALIDATE]
                )
            except Exception:  # noqa: BLE001 — the scan corpus just
                pass  # stays smaller; the batch is unaffected
        # phase 1 (host): pre-evaluation and bounded pre-eval hooks; rows
        # that short-circuit or fail resolve here, sink rows in one call
        delivery = _DeliveryBatch()
        runnable: list[_Pending] = []
        now = formed_at
        for p in batch:
            # a row whose propagated deadline passed while it queued is
            # dropped here, before any encode or dispatch
            if p.deadline is not None and now >= p.deadline:
                self._reject_expired(p, delivery)
                continue
            try:
                short = pre_evaluate(
                    self.env, p.policy_id, p.request, p.origin, p.enqueued_at
                )
            except Exception as e:  # noqa: BLE001 — per-item error channel
                self._fail(p, e, delivery)
                continue
            if short is not None:
                self._resolve(p, short, delivery)
                continue
            if self._target_hookless(p.policy_id) is False:
                try:
                    if not self._run_hooks_with_deadline(p, delivery):
                        continue  # deadline rejection already delivered
                except Exception as e:  # noqa: BLE001 — per-item isolation
                    self._fail(p, e, delivery)
                    continue
                now = time.perf_counter()  # hooks block: refresh the clock
            if (
                self.policy_timeout is not None
                and now - p.enqueued_at >= self.policy_timeout
            ):
                self._reject_deadline(p, delivery)
                continue
            runnable.append(p)
        delivery.flush()
        if brec is not None:
            phase1_end = time.perf_counter()
            brec.form_ns = int((phase1_end - formed_at) * 1e9)
            rec.record_phase(
                flightrec.PH_FORM, int(formed_at * 1e9), int(phase1_end * 1e9),
                rows=len(batch), batch=brec.bid,
            )
        if not runnable:
            return
        sched = self.scheduler
        if sched is None:
            self._evaluate_runnable(runnable, brec)
            return
        from policy_server_tpu_torch.runtime import scheduler as fair

        # the weighted-fair dispatch slot: a tenant past its share waits
        # here, spending its own rows' budget while the others' batches
        # keep flowing
        if not sched.acquire(
            self.tenant, fair.LIVE, should_abort=lambda: self._stopping
        ):
            for p in runnable:
                self._reject_stopping(p)
            return
        try:
            self._evaluate_runnable(runnable, brec)
        finally:
            sched.release(self.tenant)

    def _route_host(self, runnable: list[_Pending]) -> bool:
        """The latency fast path, two tiers: occupancy (a batch of at most
        ``host_fastpath_threshold`` rows formed from a shallow queue, so
        its requests are latency-critical) and the budget (the measured
        device round trip would blow the oldest request's remaining
        budget and the host estimate would not)."""
        if not self._env_fastpath:
            return False
        n = len(runnable)
        if n <= self.host_fastpath_threshold:
            return True
        if self.latency_budget is None:
            return False
        bucket = bucket_size(n)
        est = self._dev_rtt.get(bucket)
        if est is None:
            return False
        oldest = min(p.enqueued_at for p in runnable)
        remaining = self.latency_budget - (time.perf_counter() - oldest)
        # only when the host can MEET the budget the device would blow: a
        # batch whose budget is already gone stays on the device
        if self._host_cost_per_row * n <= remaining < est:
            self._dev_rtt[bucket] = est * 0.98
            with self._stats_lock:
                self.budget_routed_batches += 1
            return True
        return False

    def _evaluate_runnable(
        self, runnable: list[_Pending], brec: _BatchRec | None = None
    ) -> None:
        """Phases 2 and 3: the degraded-mode gate, host or device
        evaluation under the watchdog, the service-layer constraints and
        the batch's metrics."""
        if self.degraded_mode != "oracle" and self.env.breaker_all_open:
            self._serve_degraded(runnable)
            return
        pairs = [(p.policy_id, p.request) for p in runnable]
        n = len(runnable)
        use_host = self._route_host(runnable)
        if use_host:
            with self._stats_lock:
                self.host_fastpath_batches += 1
            fn, args = self._host_validate, (pairs,)
        else:
            fn, args = self._fused_validate, (pairs,)
        bid = brec.bid if brec is not None else -1
        start = time.perf_counter()
        live = runnable
        # the pool hand-off gaps (submit → worker pickup, work end → wake)
        handoffs: list[tuple[int, int]] = []
        if self.policy_timeout is None:
            try:
                with failpoints.scope(self.tenant), flightrec.batch_scope(bid):
                    results = fn(*args)
            except Exception as e:  # noqa: BLE001
                self._fail_all(runnable, e)
                return
        else:
            t_submit = time.perf_counter_ns()
            dev_future = self._device_pool.submit(
                self._scoped_timed, bid, fn, *args
            )
            try:
                wrapped, live = self._watchdog_wait(dev_future, runnable)
            except Exception as e:  # noqa: BLE001 — the evaluation raised
                self._fail_all(runnable, e)
                return
            if wrapped is None:
                waited = time.perf_counter() - start
                if not use_host:
                    self._record_device_failure(runnable, waited)
                self._observe_dispatch(use_host, n, waited, lower_bound=True)
                return  # every item deadline-rejected; the work is abandoned
            results, t_start, t_end = wrapped
            handoffs = [(t_submit, t_start), (t_end, time.perf_counter_ns())]
        done_at = time.perf_counter()
        self._observe_dispatch(use_host, n, done_at - start)
        if brec is not None:
            brec.disp_ns = int((done_at - start) * 1e9)
            brec.rec.record_phase(
                flightrec.PH_DISPATCH, int(start * 1e9), int(done_at * 1e9),
                rows=n, batch=bid,
            )
            for h0, h1 in handoffs:
                if h1 > h0:
                    brec.rec.record_phase(
                        flightrec.PH_HANDOFF, h0, h1, rows=n, batch=bid
                    )
        # phase 3 (host): constraints and metrics; rows the watchdog
        # already answered are skipped; one sink call for the batch
        live_ids = {id(p) for p in live}
        delivery = _DeliveryBatch()
        metrics_sink: list = []
        hit_rows = 0  # cache-hit (fragment) rows, for the batch's mix
        for p, result in zip(runnable, results):
            if id(p) not in live_ids:
                continue
            try:
                if isinstance(result, PolicyInitializationError):
                    self._resolve(
                        p, handle_initialization_error(p.request, result),
                        delivery,
                    )
                elif isinstance(result, Exception):
                    self._fail(p, result, delivery)
                else:
                    # a fragment verdict passes post_evaluate unchanged:
                    # its eligibility proved the constraints the identity
                    hit_rows += type(result) is FragVerdict
                    self._resolve(
                        p,
                        post_evaluate(
                            self.env, p.policy_id, p.request, p.origin,
                            result, p.enqueued_at, metrics_sink=metrics_sink,
                            now=done_at,
                        ),
                        delivery,
                    )
            except Exception as e:  # noqa: BLE001 — never kill the worker
                self._fail(p, e, delivery)
        delivery.flush()
        if metrics_sink:
            service._registry().record_evaluations_batch(metrics_sink)
        if brec is not None:
            self._record_delivery(brec, done_at, live, hit_rows)

    def _fail_all(self, batch: list[_Pending], exc: BaseException) -> None:
        delivery = _DeliveryBatch()
        for p in batch:
            self._fail(p, exc, delivery)
        delivery.flush()

    @staticmethod
    def _record_delivery(
        brec: _BatchRec, done_at: float, live: list[_Pending], hit_rows: int
    ) -> None:
        """Phase 3's recorder work: the deliver interval, the batch's
        cache-hit mix, one exemplar offer (the oldest row is the batch's
        slowest: every row shares ``done_at``) and the sampled rows."""
        rec, bid = brec.rec, brec.bid
        rec.record_phase(
            flightrec.PH_DELIVER, int(done_at * 1e9), time.perf_counter_ns(),
            rows=len(live), batch=bid,
        )
        rec.record_batch_mix(bid, hit_rows, len(live))
        if not live:
            return
        done_ns = int(done_at * 1e9)
        oldest = min(live, key=lambda q: q.enqueued_at)
        rec.offer_exemplar(
            oldest.request.uid(), oldest.policy_id,
            int(oldest.enqueued_at * 1e9), done_ns,
            brec.row_breakdown(oldest.enqueued_at),
        )
        for i in rec.sample_indices(len(live)):
            p = live[i]
            rec.record_row(
                p.request.uid(), p.policy_id, int(p.enqueued_at * 1e9),
                done_ns, bid, brec.row_breakdown(p.enqueued_at),
                flightrec.FlightRecorder.ROW_SAMPLED,
            )

    def _scoped_timed(self, bid: int, fn: Any, *args: Any) -> tuple[Any, int, int]:
        """``fn(*args)`` on a pool worker under the tenant's failpoint scope
        and the batch's recorder scope → (result, start ns, end ns): the
        worker-side stamps give the hand-off gaps around the pool
        crossing."""
        with failpoints.scope(self.tenant), flightrec.batch_scope(bid):
            t0 = time.perf_counter_ns()
            out = fn(*args)
            return out, t0, time.perf_counter_ns()

    def _host_validate(self, pairs: list) -> list:
        return self.env.validate_batch(pairs, run_hooks=False, prefer_host=True)

    def _fused_validate(self, pairs: list) -> list:
        """The encode → device → fetch chain as ONE unit of pool work: the
        environment's host half and device half back to back on the same
        worker, with the cache-hit fragment lane armed. Environments
        without the split (the oracle backend, a tripped breaker) take
        plain validate_batch."""
        with fragment_responses():
            handle = self.env.validate_batch_begin(pairs, run_hooks=False)
            if handle is not None:
                return self.env.validate_batch_finish(handle)
            return self.env.validate_batch(pairs, run_hooks=False)

    def _observe_dispatch(
        self, use_host: bool, n: int, dur: float, lower_bound: bool = False
    ) -> None:
        """Feed the estimators with a measured evaluation: they serve the
        latency-budget router and the shedding check, so they stay live
        when either knob is on."""
        if (
            self.latency_budget is None and self.request_timeout is None
        ) or n <= 0:
            return
        if use_host:
            if not lower_bound:  # a truncated host batch measures nothing
                self._host_cost_per_row = (
                    0.7 * self._host_cost_per_row + 0.3 * dur / n
                )
            return
        bucket = bucket_size(n)
        est = self._dev_rtt.get(bucket)
        if lower_bound:
            # an abandoned dispatch only bounds the round trip from below
            self._dev_rtt[bucket] = max(est or 0.0, dur)
        else:
            self._dev_rtt[bucket] = dur if est is None else 0.7 * est + 0.3 * dur

    def _watchdog_wait(
        self, dev_future: Future, runnable: list[_Pending]
    ) -> tuple[Any, list[_Pending]]:
        """Wait for the evaluation, but never past any item's deadline:
        items whose deadline passes first resolve in-band with "execution
        deadline exceeded" (500). Returns ``(the future's result, live
        items)``, or
        ``(None, [])`` when every item expired — the work then finishes
        in the background and its verdicts are thrown away."""
        live = list(runnable)
        while True:
            next_deadline = min(p.enqueued_at + self.policy_timeout for p in live)
            wait = max(0.0, next_deadline - time.perf_counter())
            try:
                return dev_future.result(timeout=wait), live
            except FutureTimeout:
                now = time.perf_counter()
                expired = [
                    p for p in live if now >= p.enqueued_at + self.policy_timeout
                ]
                delivery = _DeliveryBatch()
                for p in expired:
                    self._reject_deadline(p, delivery)
                delivery.flush()
                live = [p for p in live if p not in expired]
                if not live:
                    with self._stats_lock:
                        self.deadline_abandoned_batches += 1
                    dev_future.add_done_callback(self._discard_late_batch)
                    return None, []

    @staticmethod
    def _discard_late_batch(dev_future: Future) -> None:
        """Completion of an abandoned batch: log, never deliver."""
        exc = dev_future.exception()
        if exc is not None:
            logger.warning("abandoned device batch failed late: %s", exc)
        else:
            logger.info(
                "abandoned device batch completed after deadline; "
                "verdicts discarded"
            )

    def _record_device_failure(self, batch: list[_Pending], waited: float) -> None:
        """Report a watchdog abandonment to the environment's breaker —
        the failure exceptions cannot see (the device call HUNG). A batch
        that expired soon after dispatch because its items aged in the
        queue is a queueing failure, not a device one: only a wait of at
        least half the deadline counts."""
        if self.policy_timeout is not None and waited < 0.5 * self.policy_timeout:
            return
        self.env.record_dispatch_failure([p.policy_id for p in batch])

    def _serve_degraded(self, runnable: list[_Pending]) -> None:
        """The fully-tripped answer per ``degraded_mode``: 'monitor'
        accepts (fail-open, logged), 'reject' answers in-band 503s
        (fail-closed)."""
        with self._stats_lock:
            self.degraded_responses += len(runnable)
        logger.warning(
            "device breaker fully open: serving %d request(s) in degraded "
            "mode %r", len(runnable), self.degraded_mode,
        )
        delivery = _DeliveryBatch()
        for p in runnable:
            uid = p.request.uid()
            if self.degraded_mode == "reject":
                self._resolve(
                    p, AdmissionResponse.reject(uid, DEGRADED_MESSAGE, 503),
                    delivery,
                )
            else:
                self._resolve(p, AdmissionResponse(uid=uid, allowed=True), delivery)
        delivery.flush()

    # -- pre-eval hooks ----------------------------------------------------

    def _target_hookless(self, policy_id: str) -> bool | None:
        """Whether the id's target has no pre-eval hooks (memoized for
        registry-known ids only); None for an id the registry does not
        know, which fails later, in validate_batch, with its full
        semantics."""
        known = self._hookless.get(policy_id)
        if known is not None:
            return known
        try:
            target = self.env._lookup_top_level(PolicyID.parse(policy_id))
        except Exception:  # noqa: BLE001 — resolved later with semantics
            return None
        hookless = not self.env._hooks_of(target)
        self._hookless[policy_id] = hookless
        return hookless

    def _target_plain(self, policy_id: str) -> bool | None:
        """Whether the id's target evaluates the bare request, with no
        context snapshot or provider output in its payload (memoized as
        ``_target_hookless`` is); None for an unknown id."""
        known = self._plain.get(policy_id)
        if known is not None:
            return known
        try:
            target = self.env._lookup_top_level(PolicyID.parse(policy_id))
        except Exception:  # noqa: BLE001 — resolved later with semantics
            return None
        plain = self.env._target_plain(target)
        self._plain[policy_id] = plain
        return plain

    def _run_hooks_with_deadline(
        self, p: _Pending, delivery: _DeliveryBatch
    ) -> bool:
        """Run the target's pre-eval hooks on a thread of their own,
        waiting at most the request's remaining deadline. False when the
        request was rejected for its deadline."""
        target = self.env._lookup_top_level(PolicyID.parse(p.policy_id))
        hooks = self.env._hooks_of(target)
        payload = self.env.payload_for(target, p.request)
        remaining = (
            None
            if self.policy_timeout is None
            else self.policy_timeout - (time.perf_counter() - p.enqueued_at)
        )
        done = threading.Event()
        box: dict[str, BaseException] = {}

        def runner() -> None:
            try:
                for h in hooks:
                    h(payload)
            except BaseException as e:  # noqa: BLE001 — carried to the caller
                box["error"] = e
            finally:
                done.set()

        # one daemon thread per hook run: a timed-out hook leaks only its
        # own thread until it finishes
        threading.Thread(target=runner, name="pre-eval-hook", daemon=True).start()
        if not done.wait(timeout=remaining):
            self._reject_deadline(p, delivery)
            return False
        if "error" in box:
            raise box["error"]
        return True
