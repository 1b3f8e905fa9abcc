"""Supervised recovery: the supervision counters and the self-heal watchdog.

* :class:`SupervisorStats` — the locked counters behind the
  ``policy_server_worker_respawn*``, ``policy_server_worker_slots_given_up``
  and ``policy_server_selfheal_*`` /metrics families. The server's prefork
  worker supervisor (``server.PolicyServer._supervise_workers``, under
  ``--http-workers`` > 1) feeds the respawn and give-up counters, which
  stay 0 without workers, as the JAX package's do; the watchdog below
  feeds the revive counters. ``/readiness`` names the given-up slots.

* :class:`SelfHealWatchdog` — a daemon thread that checks, every
  ``interval_seconds``, that the threads a request depends on are alive:
  every tenant's batcher's dispatch loop (a shard router's heartbeat, under
  ``--serving-shards``) and the native frontend's drainer. A thread
  that died outside shutdown leaves a zombie server: the port stays bound,
  readiness answers 200 and every request times out. The watchdog starts a
  new thread in its place (``MicroBatcher.revive_dispatch``,
  ``NativeFrontend.revive_drainer``), counts the revive and logs it at
  ERROR, and serving resumes with the process's warm state.
"""

from __future__ import annotations

import threading
from typing import Any

from policy_server_tpu_torch.telemetry.tracing import logger


class SupervisorStats:
    """Locked counters of the supervision /metrics families (read by
    ``runtime_stats`` through ``ApiServerState.supervisor``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._worker_respawns = 0  # guarded-by: _lock
        self._worker_backoff_seconds = 0.0  # guarded-by: _lock
        self._worker_slots_given_up = 0  # guarded-by: _lock
        self._batcher_revives = 0  # guarded-by: _lock
        self._frontend_revives = 0  # guarded-by: _lock

    def count_respawn(self, backoff_seconds: float = 0.0) -> None:
        with self._lock:
            self._worker_respawns += 1
            self._worker_backoff_seconds += max(0.0, backoff_seconds)

    def count_slot_given_up(self) -> None:
        with self._lock:
            self._worker_slots_given_up += 1

    def count_batcher_revive(self) -> None:
        with self._lock:
            self._batcher_revives += 1

    def count_frontend_revive(self) -> None:
        with self._lock:
            self._frontend_revives += 1

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "worker_respawns": self._worker_respawns,
                "worker_backoff_seconds": self._worker_backoff_seconds,
                "worker_slots_given_up": self._worker_slots_given_up,
                "batcher_revives": self._batcher_revives,
                "frontend_revives": self._frontend_revives,
            }


class SelfHealWatchdog:
    """The periodic liveness check and rebuild of the serving threads (see
    the module docstring). ``state`` is the ApiServerState: the watchdog
    reads the batcher through it, so it follows the epoch flips."""

    def __init__(
        self,
        state: Any,
        stats: SupervisorStats,
        interval_seconds: float = 5.0,
    ) -> None:
        self.state = state
        self.stats = stats
        self.interval_seconds = float(interval_seconds)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "SelfHealWatchdog":
        if self.interval_seconds <= 0 or self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, name="selfheal-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _batchers(self) -> list[Any]:
        """The batchers to check: the serving epoch's of every tenant. A
        shard router's liveness is its heartbeat's, which owns fencing and
        reviving its shards, so each shard revive is counted once."""
        out = [self.state.batcher]
        tenants = self.state.tenants
        if tenants is not None:
            for t in tenants.all():
                b = t.state.batcher
                if b is not None and b not in out:
                    out.append(b)
        return out

    def check_once(self) -> int:
        """One liveness pass → the number of revives it made."""
        revived = 0
        for batcher in self._batchers():
            try:
                if batcher.dispatch_wedged() and batcher.revive_dispatch():
                    self.stats.count_batcher_revive()
                    revived += 1
                    logger.error(
                        "self-heal: batcher dispatch loop was DEAD "
                        "outside shutdown — rebuilt it (queue depth %d); "
                        "a zombie batcher would have timed out every "
                        "request while readiness kept answering 200",
                        batcher.queue_depth(),
                    )
            except Exception as e:  # noqa: BLE001 — the watchdog must live
                logger.error("self-heal batcher check failed: %s", e)
        front = self.state.native_frontend
        if front is not None:
            try:
                if front.drainer_wedged() and front.revive_drainer():
                    self.stats.count_frontend_revive()
                    revived += 1
                    logger.error(
                        "self-heal: native frontend drainer was DEAD "
                        "outside shutdown — rebuilt it; parsed requests "
                        "would otherwise rot in the submission rings"
                    )
            except Exception as e:  # noqa: BLE001
                logger.error("self-heal frontend check failed: %s", e)
        return revived

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_seconds):
            self.check_once()
