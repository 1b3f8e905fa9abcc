"""Zero-downtime policy lifecycle: epoch-based hot reload with a shadow
canary and last-good rollback.

* **Epochs.** A serving generation is an :class:`Epoch`: one evaluation
  environment (its own kernel programs, verdict cache and circuit breaker,
  so cache and breaker state never leak across policy sets) and one
  micro-batcher. One epoch is *current*; the one it replaced stays
  *pinned*, its environment open, for one generation, so ``POST
  /policies/rollback`` can revert at once.

* **Reload pipeline** (SIGHUP, a change of the policies file's digest, or
  the authenticated ``POST /policies/reload``): re-read the file, then
  build and warm the NEW policy set in the background on the same card,
  while the current epoch keeps serving.

* **Shadow canary.** Before promotion the candidate replays a bounded ring
  of recently served requests (recorded by the batcher at dispatch) plus
  one synthetic review per policy of the NEW set, and each verdict is held
  against the host oracle. A trap, a canary timeout, a settings failure or
  a divergence above ``--reload-divergence-threshold`` rejects the
  candidate: a set that failed the canary never serves, last-good keeps
  serving, and ``policy_server_policy_reload_rollbacks_total`` counts it.

* **Atomic swap.** Promotion flips the epoch pointer on the shared
  ``ApiServerState``; batches in flight drain on the old epoch's batcher,
  which is then shut down. Its environment stays open, pinned for
  rollback, and closes only when a LATER promotion pushes it past the
  one-generation window.

* **Epoch hooks.** ``set_epoch_hooks`` registers the audit scanner's
  observers, fired after each pointer flip: ``on_promote(epoch)`` (a
  re-judge under the new set) and ``on_rollback(rolled_back, serving)``
  (the revoked epoch's reports go stale). A failing observer is logged and
  never fails the promotion or rollback.

* **Cluster what-if** (``set_whatif_matrix``, ``--audit-matrix-whatif``).
  After a candidate passes its canary, the verdict matrix evaluates the
  candidate's changed columns against the first rows of the live audit
  snapshot and keeps the verdict-flip summary (``stats()["whatif"]``).
  It is advisory: a failing what-if never rejects the candidate.

Failpoints (``failpoints.py``): ``reload.fetch``, ``reload.compile``,
``reload.canary``, one per pipeline stage.

Counterpart of ``policy_server_tpu/lifecycle.py``, without the state store
(durable manifests), which this package does not have."""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Mapping

from policy_server_tpu_torch import failpoints
from policy_server_tpu_torch.models import AdmissionReviewRequest, ValidateRequest
from policy_server_tpu_torch.telemetry.tracing import logger

# policies.yml digest-poll period (the same portable inotify stand-in as
# the cert watcher, certs.py WATCH_INTERVAL_SECONDS)
WATCH_INTERVAL_SECONDS = 1.0

# how long a demoted epoch's batcher may keep draining in-flight work
# before it is stopped regardless (shutdown resolves anything left)
DRAIN_TIMEOUT_SECONDS = 30.0


class ReloadRejected(Exception):
    """A reload candidate was rejected before promotion; ``stage`` names
    the pipeline stage that failed (fetch / compile / canary)."""

    def __init__(self, stage: str, message: str):
        super().__init__(f"policy reload rejected at {stage}: {message}")
        self.stage = stage


class ShadowRecorder:
    """Bounded ring buffer of recently served ``(policy_id, request)``
    pairs — the shadow-canary replay corpus. The micro-batcher calls
    :meth:`observe` once per formed batch (one lock acquisition, a few
    deque appends); memory is bounded by ``capacity`` payloads."""

    def __init__(self, capacity: int = 64):
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, int(capacity))
        )  # guarded-by: _lock

    def observe(self, pairs: list[tuple[str, Any]]) -> None:
        with self._lock:
            self._ring.extend(pairs)

    def snapshot(self) -> list[tuple[str, Any]]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


class Epoch:
    """One serving generation: an evaluation environment + micro-batcher
    pair, the policy mapping they were built from, and (when the set
    came from a file) the exact text that was parsed."""

    __slots__ = (
        "number", "environment", "batcher", "policies", "policies_yaml",
        "created_at", "drain_thread",
    )

    def __init__(
        self, number: int, environment: Any, batcher: Any,
        policies: Mapping[str, Any], policies_yaml: str | None = None,
    ):
        self.number = number
        self.environment = environment
        self.batcher = batcher
        self.policies = dict(policies)
        self.policies_yaml = policies_yaml
        self.created_at = time.time()
        self.drain_thread: threading.Thread | None = None


def _synthetic_review_dict() -> dict:
    """A minimal, always-encodable AdmissionReview used to seed the
    canary corpus for policies that have no recorded traffic yet (new
    policies in the candidate set, or a reload before any request)."""
    return {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "request": {
            "uid": "reload-canary",
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "resource": {"group": "", "version": "v1", "resource": "pods"},
            "name": "canary",
            "namespace": "default",
            "operation": "CREATE",
            "userInfo": {"username": "system:policy-server-reload"},
            "object": {
                "apiVersion": "v1",
                "kind": "Pod",
                "metadata": {"name": "canary", "namespace": "default"},
                "spec": {"containers": [{"name": "c", "image": "nginx"}]},
            },
            "dryRun": True,
        },
    }


def _verdict_key(result: Any) -> tuple:
    """Canonical comparison key for one replayed verdict: the canary is
    bit-exactness on everything the API server would observe."""
    if isinstance(result, Exception):
        return ("exc", type(result).__name__)
    status = getattr(result, "status", None)
    return (
        "resp",
        result.allowed,
        result.patch,
        None if status is None else status.code,
        None if status is None else status.message,
    )


class PolicyLifecycleManager:
    """Epoch-based policy-set manager (see module docstring).

    Construction wires in the server's own factories so every reload
    reuses the boot pipeline — same builder kwargs, same batcher knobs::

        build_environment(policies)        -> EvaluationEnvironment (torch)
        build_oracle_environment(policies) -> EvaluationEnvironment (host
                                              oracle — the canary referee)
        build_batcher(environment)         -> MicroBatcher (not started)
        read_policies()                    -> (policies, text) re-read from
                                              disk (None when the server
                                              has no policies file)

    ``last_stage_seconds`` holds the wall time of each stage of the last
    reload that got past its fetch (``fetch``, ``compile``, ``canary``).
    """

    def __init__(
        self,
        *,
        state: Any,
        build_environment: Callable[[Mapping[str, Any]], Any],
        build_oracle_environment: Callable[[Mapping[str, Any]], Any],
        build_batcher: Callable[[Any], Any],
        recorder: ShadowRecorder,
        read_policies: Callable[[], Mapping[str, Any]] | None = None,
        policies_path: str | None = None,
        mode: str = "auto",
        canary_requests: int = 64,
        divergence_threshold: float = 0.0,
        warmup: bool = True,
        tenant: str = "default",
    ) -> None:
        self.state = state
        # names the ambient failpoint scope the reload and canary threads
        # carry ("default": this package serves no other tenant)
        self.tenant = tenant
        self._build_environment = build_environment
        self._build_oracle_environment = build_oracle_environment
        self._build_batcher = build_batcher
        self.recorder = recorder
        self._read_policies = read_policies
        self._policies_path = policies_path
        self.mode = mode
        self.canary_requests = max(0, int(canary_requests))
        self.divergence_threshold = max(0.0, float(divergence_threshold))
        self.warmup = warmup
        # upper bound on one full canary replay (candidate + oracle); a
        # candidate that cannot answer the corpus inside it is rejected —
        # a hung candidate must never gate promotion forever. Tests
        # shrink this to exercise the timeout rejection path.
        self.canary_timeout_seconds = 30.0
        # lock ORDER (locksan-visible): _reload_lock, then _swap_lock.
        # _reload_lock serializes whole reload/rollback pipelines;
        # _swap_lock guards the epoch pointers + counters and is only
        # ever taken for pointer flips / stat reads.
        self._reload_lock = threading.Lock()
        self._swap_lock = threading.Lock()
        self._current: Epoch | None = None  # guarded-by: _swap_lock
        self._previous: Epoch | None = None  # guarded-by: _swap_lock
        self._staged: Epoch | None = None  # guarded-by: _swap_lock
        self._epoch_counter = 0  # guarded-by: _swap_lock
        # counters (the /metrics + OTLP reload surface; server.py yields
        # them through runtime_stats)
        self._reloads = 0  # guarded-by: _swap_lock
        self._reload_failures = 0  # guarded-by: _swap_lock
        self._rollbacks = 0  # guarded-by: _swap_lock
        self._canary_replays = 0  # guarded-by: _swap_lock
        self._canary_divergences = 0  # guarded-by: _swap_lock
        self._last_outcome = "none"  # guarded-by: _swap_lock
        self._stop = threading.Event()
        self._watch_thread: threading.Thread | None = None
        self._reload_inflight = threading.BoundedSemaphore(1)
        self.last_stage_seconds: dict[str, float] = {}
        # epoch-transition observers (the audit scanner's), fired after the
        # pointer flip outside _swap_lock
        self._on_promote: Callable[[int], None] | None = None
        self._on_rollback: Callable[[int, int], None] | None = None
        # the verdict matrix asked for the cluster what-if; None = off
        self._whatif_matrix: Any = None

    def set_whatif_matrix(self, matrix: Any) -> None:
        """Arm the cluster what-if of each candidate that passes its
        canary (module docstring)."""
        self._whatif_matrix = matrix

    def set_epoch_hooks(
        self,
        on_promote: Callable[[int], None] | None = None,
        on_rollback: Callable[[int, int], None] | None = None,
    ) -> None:
        """Register the epoch-transition observers: ``on_promote(epoch)``
        after every promotion (a staged one's too) and
        ``on_rollback(rolled_back_epoch, serving_epoch)`` after a
        rollback."""
        self._on_promote = on_promote
        self._on_rollback = on_rollback

    @staticmethod
    def _fire_hook(hook: Callable | None, *args: Any) -> None:
        if hook is None:
            return
        try:
            hook(*args)
        except Exception as e:  # noqa: BLE001 — observers must not fail
            logger.error("epoch-transition hook failed: %s", e)

    # -- bootstrap ---------------------------------------------------------

    def install_first_epoch(self, environment: Any, batcher: Any,
                            policies: Mapping[str, Any],
                            policies_yaml: str | None = None) -> Epoch:
        """Adopt the boot-built environment/batcher pair as epoch 0 and
        mark the server ready (readiness honesty: /readiness serves 503
        until this runs — the first epoch is compiled AND warmed)."""
        with self._swap_lock:
            epoch = Epoch(self._epoch_counter, environment, batcher,
                          policies, policies_yaml)
            self._current = epoch
        self.state.evaluation_environment = environment
        self.state.batcher = batcher
        self.state.ready = True
        return epoch

    def start_watching(self) -> None:
        """Start the policies-file digest watcher (no-op without a file
        path — programmatically built configs reload via SIGHUP or the
        admin endpoint only)."""
        if self._policies_path is None or self._watch_thread is not None:
            return
        import hashlib
        from pathlib import Path

        path = Path(self._policies_path)

        def digest() -> str:
            try:
                return hashlib.sha256(path.read_bytes()).hexdigest()
            except OSError:
                return ""

        def loop() -> None:
            last = digest()
            while not self._stop.wait(WATCH_INTERVAL_SECONDS):
                now = digest()
                if now and now != last:
                    logger.info(
                        "policies file changed on disk; starting background "
                        "policy reload", extra={"span_fields": {
                            "policies_path": str(path)}},
                    )
                    # advance the baseline only when the trigger LANDED: a
                    # change arriving while a reload is in flight must be
                    # re-detected next tick (the running reload may already
                    # have fetched the older content)
                    if self.request_reload("file-watch"):
                        last = now

        self._watch_thread = threading.Thread(
            target=loop, name="policy-reload-watcher", daemon=True
        )
        self._watch_thread.start()

    # -- triggers ----------------------------------------------------------

    def request_reload(self, reason: str) -> bool:
        """Kick a background reload; returns False when one is already in
        flight (triggers coalesce — the running reload re-reads the
        config, so the newest on-disk state wins either way)."""
        if not self._reload_inflight.acquire(blocking=False):
            return False

        def run() -> None:
            try:
                self.reload(reason=reason)
            except ReloadRejected:
                pass  # counted + logged inside reload()
            except Exception as e:  # noqa: BLE001 — background thread
                logger.error("policy reload (%s) failed unexpectedly: %s",
                             reason, e)
            finally:
                self._reload_inflight.release()

        threading.Thread(
            target=run, name="policy-reload", daemon=True
        ).start()
        return True

    def reload_in_flight(self) -> bool:
        """True while a background reload pipeline is running — a
        point-in-time observation for callers that want to wait for a
        triggered reload to settle."""
        if self._reload_inflight.acquire(blocking=False):
            self._reload_inflight.release()
            return False
        return True

    # -- the reload pipeline ----------------------------------------------

    def reload(
        self,
        policies: Mapping[str, Any] | None = None,
        reason: str = "api",
    ) -> str:
        """Run the full reload pipeline synchronously. Returns
        ``"promoted"`` or ``"staged"`` (manual mode); raises
        :class:`ReloadRejected` when the candidate is rejected — the
        current epoch is untouched in every failure mode."""
        # the whole pipeline runs under this tenant's failpoint scope so
        # a tenant-scoped reload fault hits only THIS tenant's pipeline
        with failpoints.scope(self.tenant):
            return self._reload_scoped(policies, reason)

    def _reload_scoped(
        self,
        policies: Mapping[str, Any] | None,
        reason: str,
    ) -> str:
        with self._reload_lock:
            if self._stop.is_set():
                raise ReloadRejected("shutdown", "lifecycle shutting down")
            t0 = time.perf_counter()
            candidate_env = None
            candidate_batcher = None
            policies_yaml: str | None = None
            stages: dict[str, float] = {}
            try:
                # stage 1 — fetch: re-read the policies file
                stage = "fetch"
                failpoints.fire("reload.fetch")
                if policies is None:
                    policies, policies_yaml = self._fetch_policies()
                t1 = time.perf_counter()
                stages["fetch"] = t1 - t0
                # stage 2 — build (the kernel library and its probe, the
                # kernel programs) and warm the candidate epoch, off the
                # serving path
                stage = "compile"
                failpoints.fire("reload.compile")
                candidate_env = self._build_environment(policies)
                candidate_batcher = self._build_batcher(candidate_env)
                if self.warmup:
                    candidate_batcher.warmup()
                t2 = time.perf_counter()
                stages["compile"] = t2 - t1
                # stage 3 — shadow canary against the host oracle
                stage = "canary"
                self._run_canary(candidate_env, policies)
                stages["canary"] = time.perf_counter() - t2
                # the cluster what-if: what would flip cluster-wide if the
                # candidate promoted (advisory; a fault never rejects it)
                if self._whatif_matrix is not None:
                    try:
                        self._whatif_matrix.whatif_diff(candidate_env, policies)
                    except Exception as we:  # noqa: BLE001 — advisory
                        logger.warning(
                            "matrix what-if diff failed (advisory, "
                            "promotion unaffected): %s", we,
                        )
            except ReloadRejected as e:
                self.last_stage_seconds = stages
                self._reject(
                    stage, candidate_env, candidate_batcher, reason,
                    detail=str(e),
                )
                raise
            except Exception as e:  # noqa: BLE001 — every stage failure
                # takes the same last-good path
                self.last_stage_seconds = stages
                self._reject(
                    stage, candidate_env, candidate_batcher, reason,
                    detail=str(e),
                )
                raise ReloadRejected(stage, str(e)) from e

            self.last_stage_seconds = stages
            if self._stop.is_set():
                # shutdown raced the build: drop the candidate quietly
                # (no failure counters — nothing was rejected on merit)
                candidate_batcher.shutdown()
                candidate_env.close()
                raise ReloadRejected("shutdown", "lifecycle shutting down")
            with self._swap_lock:
                self._epoch_counter += 1
                epoch = Epoch(
                    self._epoch_counter, candidate_env, candidate_batcher,
                    policies, policies_yaml,
                )
            if self.mode == "manual":
                self._stage(epoch)
                outcome = "staged"
            else:
                self._promote(epoch)
                outcome = "promoted"
            logger.info(
                "policy reload %s", outcome,
                extra={"span_fields": {
                    "reason": reason,
                    "epoch": epoch.number,
                    "policies": len(epoch.policies),
                    "elapsed_seconds": round(time.perf_counter() - t0, 3),
                }},
            )
            return outcome

    def _fetch_policies(self) -> tuple[Mapping[str, Any], str | None]:
        """(policies, yaml_text) — the text is the exact source the
        mapping was parsed from (None for programmatic sets). Closures
        returning a bare mapping (embedders, older tests) still work."""
        if self._read_policies is not None:
            result = self._read_policies()
            if isinstance(result, tuple):
                return result
            return result, None
        with self._swap_lock:
            current = self._current
        if current is None:
            raise ReloadRejected("fetch", "no current epoch to reload from")
        return current.policies, current.policies_yaml

    def _reject(
        self, stage: str, env: Any, batcher: Any, reason: str,
        detail: str = "",
    ) -> None:
        """Last-good containment: tear the candidate down, count the
        failure loudly, leave the current epoch serving untouched."""
        if batcher is not None:
            try:
                batcher.shutdown()
            except Exception:  # noqa: BLE001 — teardown must not mask
                pass
        if env is not None:
            try:
                env.close()
            except Exception:  # noqa: BLE001
                pass
        with self._swap_lock:
            self._reload_failures += 1
            self._rollbacks += 1
            self._last_outcome = f"rejected:{stage}"
        logger.error(
            "policy reload (%s) REJECTED at %s stage (%s); last-good policy "
            "set keeps serving (policy_server_policy_reload_rollbacks_total "
            "incremented)", reason, stage, detail or "no detail",
        )

    # -- shadow canary -----------------------------------------------------

    def _corpus(
        self, policies: Mapping[str, Any]
    ) -> list[tuple[str, Any]]:
        """Replay corpus: up to ``--reload-canary-requests`` recorded
        requests (the newest end of the ring; 0 disables recorded
        replay), plus one synthetic boot review per top-level policy in
        the CANDIDATE set. The synthetics are NEVER capped — every
        policy in the new set gets at least one canary evaluation, no
        matter how large the set is (a broken policy must not promote
        just because the budget ran out before reaching it)."""
        pairs = self.recorder.snapshot()[-self.canary_requests:] \
            if self.canary_requests else []
        synth = ValidateRequest.from_admission(
            AdmissionReviewRequest.from_dict(_synthetic_review_dict()).request
        )
        for pid in policies:
            pairs.append((pid, synth))
        return pairs

    def _run_canary(
        self, candidate_env: Any, policies: Mapping[str, Any]
    ) -> None:
        """Replay the corpus through the candidate and the host oracle;
        raise :class:`ReloadRejected` on any trap, timeout, or a
        divergence fraction above the configured threshold."""
        pairs = self._corpus(policies)
        if not pairs:
            return
        oracle_env = self._build_oracle_environment(policies)
        try:
            def replay() -> tuple[list, list]:
                # the chaos site rides INSIDE the watchdog-bounded replay
                # so an injected sleep simulates a hung candidate (and an
                # injected raise a canary-infrastructure fault)
                failpoints.fire("reload.canary")
                # run_hooks=False on BOTH sides: the canary checks verdict
                # logic, not hook latency, and both paths must observe the
                # same inputs for the comparison to mean anything
                cand = candidate_env.validate_batch(pairs, run_hooks=False)
                orac = oracle_env.validate_batch(pairs, run_hooks=False)
                return cand, orac

            from concurrent.futures import Future
            from concurrent.futures import TimeoutError as FutureTimeout

            # one FRESH daemon thread per canary (never a fixed pool): a
            # hung replay is abandoned at the timeout below, and a wedged
            # worker must not poison the NEXT reload's canary — the same
            # per-run-thread discipline as the batcher's hook runner
            future: Future = Future()

            def runner() -> None:
                if not future.set_running_or_notify_cancel():
                    return
                try:
                    # the canary replays on a FRESH thread: the tenant
                    # failpoint scope must travel with it
                    with failpoints.scope(self.tenant):
                        future.set_result(replay())
                except BaseException as e:  # noqa: BLE001 — future carries
                    future.set_exception(e)

            threading.Thread(
                target=runner, name="reload-canary", daemon=True
            ).start()
            try:
                cand, orac = future.result(
                    timeout=self.canary_timeout_seconds
                )
            except FutureTimeout:
                raise ReloadRejected(
                    "canary",
                    f"replay exceeded {self.canary_timeout_seconds:.0f}s "
                    "(hung candidate)",
                ) from None
            divergences = 0
            trap: Exception | None = None
            for (pid, _req), c, o in zip(pairs, cand, orac):
                ck, ok = _verdict_key(c), _verdict_key(o)
                if ck != ok:
                    divergences += 1
                    logger.warning(
                        "reload canary divergence on policy %r: "
                        "candidate=%r oracle=%r", pid, ck, ok,
                    )
                    if isinstance(c, Exception) and not isinstance(
                        o, Exception
                    ):
                        trap = c
            with self._swap_lock:
                self._canary_replays += len(pairs)
                self._canary_divergences += divergences
            if trap is not None:
                raise ReloadRejected(
                    "canary", f"candidate trapped during replay: {trap}"
                )
            fraction = divergences / len(pairs)
            if fraction > self.divergence_threshold:
                raise ReloadRejected(
                    "canary",
                    f"verdict divergence {fraction:.3f} "
                    f"({divergences}/{len(pairs)} replays) exceeds "
                    f"threshold {self.divergence_threshold:.3f}",
                )
        finally:
            oracle_env.close()

    # -- promotion / staging / rollback ------------------------------------

    def _stage(self, epoch: Epoch) -> None:
        with self._swap_lock:
            old_staged = self._staged
            self._staged = epoch
            self._last_outcome = "staged"
        if old_staged is not None:
            self._retire(old_staged, close_env=True)
        logger.info(
            "policy epoch %d staged (manual reload mode): promote via "
            "POST /policies/promote", epoch.number,
        )

    def _promote(self, epoch: Epoch) -> None:
        """The atomic swap: start the new epoch's batcher FIRST, then flip
        the state pointers (no request can ever reach an unstarted
        batcher), then drain-retire the demoted epoch and close whatever
        fell past the one-generation pin window."""
        epoch.batcher.start()
        with self._swap_lock:
            old = self._current
            beyond_pin = self._previous
            self._current = epoch
            self._previous = old
            self._reloads += 1
            self._last_outcome = "promoted"
        # the pointer flip the handlers observe: one attribute rebind per
        # field; a request racing the flip lands on one epoch or the
        # other, both of which are serving
        self.state.evaluation_environment = epoch.environment
        self.state.batcher = epoch.batcher
        if old is not None:
            # in-flight work drains on the old epoch's batcher; its
            # environment stays OPEN, pinned for rollback
            self._retire(old, close_env=False)
        if beyond_pin is not None:
            # one generation is the pin window: the epoch demoted two
            # promotions ago closes for good
            self._retire(beyond_pin, close_env=True)
        # the post-promote observers (the audit scanner's re-judge)
        self._fire_hook(self._on_promote, epoch.number)

    def _retire(self, epoch: Epoch, close_env: bool) -> None:
        """Background drain-then-stop of a demoted epoch's batcher (and
        optionally its environment): new traffic stopped arriving at the
        pointer flip, so the queue empties naturally; shutdown() then
        resolves in-flight work bounded by the dispatch watchdog."""
        prior = epoch.drain_thread

        def drain() -> None:
            if prior is not None:
                prior.join(timeout=DRAIN_TIMEOUT_SECONDS)
            deadline = time.monotonic() + DRAIN_TIMEOUT_SECONDS
            try:
                while (
                    time.monotonic() < deadline
                    and epoch.batcher.queue_depth() > 0
                ):
                    time.sleep(0.05)
                epoch.batcher.shutdown()
            except Exception:  # noqa: BLE001 — retirement is best-effort
                pass
            if close_env:
                try:
                    epoch.environment.close()
                except Exception:  # noqa: BLE001
                    pass

        t = threading.Thread(
            target=drain, name=f"epoch-{epoch.number}-retire", daemon=True
        )
        epoch.drain_thread = t
        t.start()

    # how long a synchronous admin action (promote/rollback) waits for
    # an in-flight background reload before answering 409: the EMERGENCY
    # endpoints must fail fast with a clear answer, never hang behind a
    # minutes-long compile
    _ADMIN_LOCK_TIMEOUT_SECONDS = 5.0

    def _acquire_reload_lock_or_reject(self, action: str) -> None:
        if not self._reload_lock.acquire(
            timeout=self._ADMIN_LOCK_TIMEOUT_SECONDS
        ):
            raise ReloadRejected(
                action,
                "a policy reload is in progress; retry once it settles "
                "(the admin endpoints never wait behind a compile)",
            )

    def promote_staged(self) -> str:
        """Promote the epoch a manual-mode reload staged; raises
        :class:`ReloadRejected` when nothing is staged (or a reload is
        mid-flight — bounded wait, then 409)."""
        self._acquire_reload_lock_or_reject("promote")
        try:
            with self._swap_lock:
                epoch = self._staged
                self._staged = None
            if epoch is None:
                raise ReloadRejected("promote", "no staged policy epoch")
            self._promote(epoch)
            logger.info("staged policy epoch %d promoted", epoch.number)
            return "promoted"
        finally:
            self._reload_lock.release()

    def rollback(self) -> str:
        """Instant revert to the pinned previous epoch: its environment
        is still open (compiled + warm), so only a fresh batcher needs
        building. The demoted epoch takes the pinned slot symmetrically
        — a rollback can itself be rolled back. Bounded wait on an
        in-flight reload (ReloadRejected → HTTP 409, retry) — the
        incident-response endpoint must never hang behind a compile."""
        self._acquire_reload_lock_or_reject("rollback")
        try:
            with self._swap_lock:
                prev = self._previous
            if prev is None:
                raise ReloadRejected(
                    "rollback", "no previous policy epoch pinned"
                )
            # the pinned epoch's batcher was drain-stopped at demotion;
            # serve it through a fresh one over the still-open environment
            revived = Epoch(
                prev.number, prev.environment,
                self._build_batcher(prev.environment), prev.policies,
                prev.policies_yaml,
            )
            revived.batcher.start()
            with self._swap_lock:
                demoted = self._current
                self._current = revived
                self._previous = demoted
                self._rollbacks += 1
                self._last_outcome = "rolled-back"
            self.state.evaluation_environment = revived.environment
            self.state.batcher = revived.batcher
            if demoted is not None:
                self._retire(demoted, close_env=False)
            # the post-rollback observers: the demoted epoch's reports go
            # stale, then a re-judge under the revived one
            self._fire_hook(
                self._on_rollback,
                demoted.number if demoted is not None else -1,
                revived.number,
            )
            logger.warning(
                "policy set ROLLED BACK to epoch %d; the rejected epoch "
                "stays pinned for forensic promote", revived.number,
            )
            return "rolled-back"
        finally:
            self._reload_lock.release()

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict[str, Any]:
        """One locked snapshot of the reload surface (runtime_stats /
        tests): counters plus the current epoch gauge."""
        with self._swap_lock:
            return {
                "reloads": self._reloads,
                "reload_failures": self._reload_failures,
                "rollbacks": self._rollbacks,
                "canary_replays": self._canary_replays,
                "canary_divergences": self._canary_divergences,
                "epoch": self._current.number if self._current else 0,
                "staged": 1 if self._staged is not None else 0,
                "last_outcome": self._last_outcome,
                # the last cluster what-if (None when --audit-matrix-whatif
                # is off or no reload ran yet)
                "whatif": (
                    self._whatif_matrix.last_whatif()
                    if self._whatif_matrix is not None
                    else None
                ),
            }

    @property
    def current_epoch(self) -> int:
        with self._swap_lock:
            return self._current.number if self._current else 0

    # -- teardown ----------------------------------------------------------

    def shutdown(self) -> None:
        """Stop the watcher and tear down EVERY epoch (current, pinned
        previous, staged) — server shutdown overrides the pin window."""
        self._stop.set()
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=5)
            self._watch_thread = None
        # wait (bounded) for an in-flight reload: promoting into a
        # closed-down state would leak a serving epoch. The _stop checks
        # in reload() make any still-running pipeline drop its candidate.
        acquired = self._reload_lock.acquire(timeout=DRAIN_TIMEOUT_SECONDS)
        try:
            with self._swap_lock:
                epochs = [
                    e for e in (self._current, self._previous, self._staged)
                    if e is not None
                ]
                self._current = self._previous = self._staged = None
        finally:
            if acquired:
                self._reload_lock.release()
        for epoch in epochs:
            drain = epoch.drain_thread
            if drain is not None:
                drain.join(timeout=DRAIN_TIMEOUT_SECONDS)
            try:
                epoch.batcher.shutdown()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
            try:
                epoch.environment.close()
            except Exception:  # noqa: BLE001
                pass
