"""Failure containment: the device circuit breaker and the capped-backoff
retry helper.

One CircuitBreaker guards each EvaluationEnvironment's device path:
repeated faults or watchdog trips within a sliding window trip it OPEN,
and while open every batch short-circuits to the bit-exact host oracle —
verdicts stay correct and requests never queue behind a hung device.
After a cooldown the breaker goes HALF_OPEN and admits one probe
dispatch; a probe success closes it, a probe failure re-opens it. The
caller asks ``allow_device()`` per batch and reports the outcome through
``record_success``/``record_failure`` (the batcher's watchdog reports
abandonments as failures, so a device that HANGS — the failure mode
exceptions cannot see — still trips it).

Every trip is logged at ERROR and every recovery at WARNING; the counters
(``stats()``) are read by the environment's ``breaker_stats`` and shown on
``/readiness``. The environment feeds the breaker raises at dispatch and
fetch, failpoint injections among them, but never an error the CUDA
runtime reported: a kernel or CUDA error (a sticky one poisons the
context, and no probe recovers from it) fails its batch's requests
instead of turning into host answers.

``retry_with_backoff`` is the fetch path's policy: capped exponential
backoff with full jitter for transient registry and HTTPS failures (429
and 5xx answers, connect errors, timeouts), so one registry blip at boot
or reload is not fatal.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable

logger = logging.getLogger("kubewarden-policy-server")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class CircuitBreaker:
    """Thread-safe three-state breaker with a sliding failure window.

    ``allow_device()`` is the admission question ("may this batch use the
    device?"); ``record_success``/``record_failure`` close the loop. All
    transitions and denial counts are exported via :meth:`stats`.

    A half-open probe whose batch ends up not dispatching at all (every
    row answered by the verdict cache or host-executed) reports no
    outcome; the ``last_probe_at`` guard below admits a fresh probe one
    cooldown later, so a cache-hit-heavy stream delays recovery but can
    never wedge the breaker half-open.
    """

    def __init__(
        self,
        failure_threshold: int = 5,
        window_seconds: float = 30.0,
        cooldown_seconds: float = 5.0,
        half_open_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.failure_threshold = max(1, int(failure_threshold))
        self.window_seconds = max(0.001, float(window_seconds))
        self.cooldown_seconds = max(0.0, float(cooldown_seconds))
        self.half_open_probes = max(1, int(half_open_probes))
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED  # guarded-by: _lock
        self._failures: list[float] = []  # guarded-by: _lock
        self._opened_at = 0.0  # guarded-by: _lock
        self._probes_in_flight = 0  # guarded-by: _lock
        self._last_probe_at = 0.0  # guarded-by: _lock
        # counters (monotonic; metrics surface)
        self.trips = 0  # guarded-by: _lock
        self.recoveries = 0  # guarded-by: _lock
        self.probes = 0  # guarded-by: _lock
        # per-CALL denials while open (unit-test introspection only; the
        # exported metric is the environment's per-REQUEST
        # breaker_short_circuited_requests — one authority, not two)
        self.short_circuits = 0  # guarded-by: _lock

    # -- admission ---------------------------------------------------------

    def allow_device(self) -> bool:
        with self._lock:
            if self._state == CLOSED:
                return True
            now = self._clock()
            if self._state == OPEN:
                if now - self._opened_at >= self.cooldown_seconds:
                    self._state = HALF_OPEN
                    self._probes_in_flight = 0
                else:
                    self.short_circuits += 1
                    return False
            # HALF_OPEN: admit a bounded number of concurrent probes; a
            # probe whose outcome never comes back (shouldn't happen — the
            # watchdog reports abandonment as failure) unblocks after one
            # more cooldown rather than wedging the breaker half-open
            if self._probes_in_flight < self.half_open_probes or (
                now - self._last_probe_at >= self.cooldown_seconds
            ):
                self._probes_in_flight += 1
                self._last_probe_at = now
                self.probes += 1
                return True
            self.short_circuits += 1
            return False

    # -- outcome reporting -------------------------------------------------

    def record_success(self) -> None:
        with self._lock:
            recovered = self._state == HALF_OPEN
            if recovered:
                self._state = CLOSED
                self.recoveries += 1
                self._probes_in_flight = 0
                self._failures.clear()
            elif self._state == CLOSED and self._failures:
                # healthy dispatches age the window out faster than the
                # clock alone: a burst of long-spaced failures cannot
                # accumulate across hours of healthy traffic
                self._prune(self._clock())
        if recovered:
            logger.warning(
                "device circuit breaker closed: a probe succeeded, the "
                "device serves again"
            )

    def record_failure(self) -> None:
        with self._lock:
            now = self._clock()
            if self._state == HALF_OPEN:
                # the probe failed: straight back to OPEN, fresh cooldown
                self._state = OPEN
                self._opened_at = now
                self._probes_in_flight = 0
                self.trips += 1
                reason, trips = "a half-open probe failed", self.trips
            elif self._state == OPEN:
                return  # late failures from abandoned work change nothing
            else:
                self._failures.append(now)
                self._prune(now)
                if len(self._failures) < self.failure_threshold:
                    return
                self._state = OPEN
                self._opened_at = now
                self._failures.clear()
                self.trips += 1
                reason = (
                    f"{self.failure_threshold} device failures within "
                    f"{self.window_seconds} s"
                )
                trips = self.trips
        logger.error(
            "device circuit breaker tripped (%s; trip %d): the host oracle "
            "answers until a probe succeeds, %s s from now",
            reason, trips, self.cooldown_seconds,
        )

    def _prune(self, now: float) -> None:  # holds: _lock
        cutoff = now - self.window_seconds
        self._failures = [t for t in self._failures if t >= cutoff]

    # -- introspection -----------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def is_open(self) -> bool:
        """True while device dispatch is tripped (open or probing)."""
        with self._lock:
            return self._state != CLOSED

    @property
    def blocking_device(self) -> bool:
        """True while a device attempt would be denied RIGHT NOW — open
        and still cooling, or half-open with the probe budget in use.
        Side-effect-free twin of :meth:`allow_device`: gates that bypass
        the dispatch path entirely (the batcher's --degraded-mode gate)
        must use THIS, so that once a probe is due the batch proceeds to
        the dispatch path whose allow_device() actually runs the probe —
        a gate keyed on ``is_open`` would bypass allow_device forever and
        the breaker could never leave OPEN."""
        with self._lock:
            if self._state == CLOSED:
                return False
            now = self._clock()
            if self._state == OPEN:
                return now - self._opened_at < self.cooldown_seconds
            return not (
                self._probes_in_flight < self.half_open_probes
                or now - self._last_probe_at >= self.cooldown_seconds
            )

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "state_code": _STATE_CODE[self._state],
                "open": int(self._state != CLOSED),
                "trips": self.trips,
                "recoveries": self.recoveries,
                "probes": self.probes,
            }


def retry_with_backoff(
    fn: Callable[[], "object"],
    is_retryable: Callable[[BaseException], bool],
    attempts: int = 4,
    base_seconds: float = 0.25,
    cap_seconds: float = 5.0,
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Callable[[int, BaseException, float], None] | None = None,
) -> "object":
    """Run ``fn`` up to ``attempts`` times; between attempts sleep with
    capped exponential backoff and full jitter (the AWS-style policy —
    decorrelated enough that a boot-time thundering herd of policy
    fetchers does not re-synchronize on the registry). Non-retryable
    exceptions and the final attempt's failure propagate unchanged."""
    attempts = max(1, int(attempts))
    for attempt in range(attempts):
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 — filtered by predicate
            if attempt + 1 >= attempts or not is_retryable(e):
                raise
            delay = random.uniform(
                0, min(cap_seconds, base_seconds * (2**attempt))
            )
            if on_retry is not None:
                on_retry(attempt + 1, e, delay)
            sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
