"""Host-local serving shards: failure-domain isolation for the batcher (the
JAX package's ``runtime/shards.py``).

With ``--serving-shards M`` above 1 a tenant is served by M full stacks,
each with its own evaluation environment (its own K1 programs, stream,
page-locked buffers, verdict cache and breaker on the card) and its own
``MicroBatcher``. Shard 0 borrows the caller's environment; the siblings'
are rebuilt from ``env.source_policies``, so every shard answers the same
bytes, and the router owns and closes them. A tenant's admission quota and
the fair scheduler are shared by its shards, so quotas do not multiply by M.

:class:`ShardRouter` has the ``MicroBatcher`` surface the rest of the
server uses (the frontends, the lifecycle, the self-heal watchdog):

* ``--serving-shards 1`` is the bypass: :func:`build_serving_shards`
  returns the plain batcher and no router is on the path;
* a reload epoch builds a whole new router, so all M shards flip with the
  one ``state.batcher`` pointer;
* the self-heal watchdog supervises the router's heartbeat thread through
  ``dispatch_wedged``/``revive_dispatch``; the heartbeat supervises the
  shards, so a killed shard is revived, and counted, once.

Each submission (a ``submit_many`` burst or one row) goes whole to the
healthy shard with the lowest queue-depth EWMA. Every ``heartbeat_seconds``
the heartbeat checks each shard's dispatch loop; a shard whose loop died
(or whose probe faulted) is fenced within one interval:

1. its queued rows are taken atomically (``MicroBatcher.fence_drain``,
   under the queue mutex: no batch worker owns them and none was answered);
2. they are re-routed to the healthiest sibling with their deadline,
   sink and quota token (no second admission: the row's first answer
   releases its quota), or answered ``FencedError`` (503 and Retry-After)
   when no sibling has room — never both;
3. the shard is revived in place (``revive_dispatch``: the queue, pools,
   caches and K1 programs survive) without touching its siblings.

``shutdown()`` drains the shards in sequence, then closes the sibling
environments (``EvaluationEnvironment.close``: refuse new dispatches, wait
for those in flight and for each stream's last event, then drop the device
code), never shard 0's. Chaos sites: ``shard.dispatch`` (the batcher's
loop) and ``shard.heartbeat`` (here), both under the shard's ``shard-<i>``
failpoint scope.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

from policy_server_tpu_torch import failpoints
from policy_server_tpu_torch.runtime.batcher import FencedError, MicroBatcher
from policy_server_tpu_torch.telemetry.tracing import logger

# queue-depth EWMA smoothing: new = (1 - alpha) * old + alpha * depth
_EWMA_ALPHA = 0.2


class _Shard:
    """One serving shard: its batcher, its environment, and the router's
    routing state for it."""

    __slots__ = (
        "index", "batcher", "env", "owns_env", "healthy", "ewma", "scope",
    )

    def __init__(
        self, index: int, batcher: MicroBatcher, env: Any, owns_env: bool
    ) -> None:
        self.index = index
        self.batcher = batcher
        self.env = env
        self.owns_env = owns_env
        self.healthy = True  # guarded-by: ShardRouter._lock
        self.ewma = 0.0  # guarded-by: ShardRouter._lock
        self.scope = f"shard-{index}"
        batcher.failpoint_scope = self.scope


class ShardRouter:
    """Health and queue-depth-EWMA router over M serving shards (module
    docstring). Attributes it does not define are shard 0's batcher's."""

    def __init__(
        self,
        shards: list[_Shard],
        heartbeat_seconds: float = 0.5,
        supervisor: Any = None,
    ) -> None:
        if len(shards) < 2:
            raise ValueError("a router needs at least two shards")
        self._shards = shards
        self.heartbeat_seconds = max(0.05, float(heartbeat_seconds))
        # shard revives count into the self-heal batcher revives, as the
        # JAX package's do: a shard revive is a batcher revive
        self._supervisor = supervisor
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.shard_fences = 0  # guarded-by: _stats_lock
        self.shard_reroutes = 0  # guarded-by: _stats_lock
        self.shard_fenced_rows = 0  # guarded-by: _stats_lock
        self.shard_respawns = 0  # guarded-by: _stats_lock
        self.shard_heartbeat_faults = 0  # guarded-by: _stats_lock
        self._stop = threading.Event()
        self._stopping = False
        self._thread: threading.Thread | None = None

    def __getattr__(self, name: str) -> Any:
        # only for attributes the router does not define: knobs, tenant,
        # degraded mode, the shadow recorder — the same on every shard
        return getattr(self._shards[0].batcher, name)

    @property
    def env(self) -> Any:
        """Shard 0's environment (the caller's)."""
        return self._shards[0].env

    @property
    def serving_shards(self) -> int:
        return len(self._shards)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ShardRouter":
        for s in self._shards:
            s.batcher.start()
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._heartbeat_loop, name="shard-heartbeat",
                daemon=True,
            )
            self._thread.start()
        return self

    def warmup(self) -> None:
        for s in self._shards:
            s.batcher.warmup()

    def shutdown(self) -> None:
        """Stop the heartbeat, shut the shards down in sequence (each
        answers what it holds before the next begins), then close the
        sibling environments; shard 0's is the caller's."""
        self._stopping = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        for s in self._shards:
            s.batcher.shutdown()
        for s in self._shards:
            if s.owns_env:
                try:
                    s.env.close()
                except Exception as e:  # noqa: BLE001 — teardown goes on
                    logger.error(
                        "shard %d environment close failed: %s", s.index, e
                    )

    # -- self-heal surface: the watchdog supervises the heartbeat -----------

    def dispatch_wedged(self) -> bool:
        """True when the heartbeat thread died outside shutdown (the shards'
        loops are the heartbeat's charges)."""
        t = self._thread
        return (
            t is not None
            and not t.is_alive()
            and not self._stopping
            and not self._stop.is_set()
        )

    def revive_dispatch(self) -> bool:
        if not self.dispatch_wedged():
            return False
        self._thread = threading.Thread(
            target=self._heartbeat_loop, name="shard-heartbeat-revived",
            daemon=True,
        )
        self._thread.start()
        return True

    # -- routing -------------------------------------------------------------

    def _pick(self) -> _Shard:
        """The healthy shard with the lowest queue-depth EWMA; when every
        shard is fenced, the least loaded (its queue still accepts, and the
        next heartbeat revives it or fences its rows into 503s)."""
        with self._lock:
            best = None
            best_any = None
            for s in self._shards:
                s.ewma = (
                    (1.0 - _EWMA_ALPHA) * s.ewma
                    + _EWMA_ALPHA * s.batcher.queue_depth()
                )
                if best_any is None or s.ewma < best_any.ewma:
                    best_any = s
                if s.healthy and (best is None or s.ewma < best.ewma):
                    best = s
            return best if best is not None else best_any

    def submit(self, policy_id, request, origin):
        return self._pick().batcher.submit(policy_id, request, origin)

    def submit_nowait(self, policy_id, request, origin):
        return self._pick().batcher.submit_nowait(policy_id, request, origin)

    def evaluate(self, policy_id, request, origin):
        return self._pick().batcher.evaluate(policy_id, request, origin)

    def submit_many(self, items, origin, sink=None, tokens=None):
        # a whole burst lands on one shard: M queue-depth reads per burst,
        # nothing per row
        return self._pick().batcher.submit_many(
            items, origin, sink=sink, tokens=tokens
        )

    def submit_audit(self, pairs):
        """An audit batch goes whole to the healthiest shard's lane."""
        return self._pick().batcher.submit_audit(pairs)

    def cancel_audit(self, future) -> bool:
        return any(s.batcher.cancel_audit(future) for s in self._shards)

    # -- introspection -------------------------------------------------------

    def queue_depth(self) -> int:
        return sum(s.batcher.queue_depth() for s in self._shards)

    def audit_lane_depth(self) -> int:
        return sum(s.batcher.audit_lane_depth() for s in self._shards)

    def estimated_wait(self) -> float:
        """The wait a row routed now would see: the best healthy shard's."""
        with self._lock:
            healthy = [s for s in self._shards if s.healthy]
        return min(s.batcher.estimated_wait() for s in healthy or self._shards)

    def stats_snapshot(self) -> dict[str, int]:
        """The shards' counters summed key by key, with the router's own
        under ``shard_*`` keys."""
        out: dict[str, int] = {}
        for s in self._shards:
            for k, v in s.batcher.stats_snapshot().items():
                out[k] = out.get(k, 0) + v
        with self._stats_lock:
            out["shard_fences"] = self.shard_fences
            out["shard_reroutes"] = self.shard_reroutes
            out["shard_fenced_rows"] = self.shard_fenced_rows
            out["shard_respawns"] = self.shard_respawns
            out["shard_heartbeat_faults"] = self.shard_heartbeat_faults
        return out

    def shard_health(self) -> list[dict[str, Any]]:
        """One row per shard for the labelled /metrics gauges."""
        with self._lock:
            return [
                {
                    "shard": s.index,
                    "healthy": s.healthy,
                    "queue_depth": s.batcher.queue_depth(),
                    "ewma": round(s.ewma, 3),
                    "dispatch_alive": not s.batcher.dispatch_wedged(),
                }
                for s in self._shards
            ]

    # -- heartbeat and fencing -----------------------------------------------

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_seconds):
            try:
                self.check_shards()
            except Exception as e:  # noqa: BLE001 — the prober must live
                logger.error("shard heartbeat pass failed: %s", e)

    def check_shards(self) -> int:
        """One heartbeat pass over every shard → the shards fenced."""
        fenced = 0
        for s in self._shards:
            probe_fault = False
            try:
                with failpoints.scope(s.scope):
                    failpoints.fire("shard.heartbeat")
            except Exception:  # noqa: BLE001 — an injected probe fault
                probe_fault = True
                with self._stats_lock:
                    self.shard_heartbeat_faults += 1
            wedged = s.batcher.dispatch_wedged()
            if not (wedged or probe_fault):
                with self._lock:
                    if not s.healthy:
                        s.healthy = True
                        s.ewma = 0.0
                continue
            self._fence(s, "wedged dispatch" if wedged else "probe fault")
            fenced += 1
            # revive in place; a fault still armed kills it again and the
            # next pass fences again, never touching the siblings
            if wedged and s.batcher.revive_dispatch():
                with self._stats_lock:
                    self.shard_respawns += 1
                if self._supervisor is not None:
                    self._supervisor.count_batcher_revive()
                with self._lock:
                    s.healthy = True
                    s.ewma = 0.0
                logger.error(
                    "shard %d dispatch loop was DEAD — fenced, drained, "
                    "and warm-revived in place (siblings untouched)",
                    s.index,
                )
        return fenced

    def _fence(self, victim: _Shard, reason: str) -> None:
        """Mark the shard unroutable, take its queued rows and re-route them
        to the healthiest sibling, or answer them ``FencedError`` when no
        sibling has room. Rows a batch worker holds are answered there."""
        with self._lock:
            victim.healthy = False
        rows = victim.batcher.fence_drain()
        with self._stats_lock:
            self.shard_fences += 1
        refused = rows
        if rows:
            with self._lock:
                siblings = [
                    s for s in self._shards if s.healthy and s is not victim
                ]
                target = min(siblings, key=lambda s: s.ewma) if siblings else None
            if target is not None:
                # the sibling's enqueue stamps the rows' owner under its
                # queue mutex
                refused = target.batcher._put_burst(rows)  # noqa: SLF001
            victim.batcher._fail_all(  # noqa: SLF001
                refused, FencedError(self.heartbeat_seconds)
            )
        with self._stats_lock:
            self.shard_reroutes += len(rows) - len(refused)
            self.shard_fenced_rows += len(refused)
        logger.error(
            "FENCED shard %d (%s): %d queued row(s) re-routed, %d "
            "answered 503+Retry-After; in-flight batches resolve on "
            "their workers", victim.index, reason,
            len(rows) - len(refused), len(refused),
        )


def build_serving_shards(
    env: Any,
    make_batcher: Callable[[Any], MicroBatcher],
    build_env: Callable[[dict], Any] | None,
    count: int,
    heartbeat_seconds: float = 0.5,
    supervisor: Any = None,
) -> "MicroBatcher | ShardRouter":
    """One tenant's serving plane: the plain ``MicroBatcher`` when
    ``count`` is at most 1 (the bypass), else a :class:`ShardRouter` over
    ``count`` stacks whose siblings' environments ``build_env`` rebuilds
    from ``env.source_policies``."""
    primary = make_batcher(env)
    if count <= 1:
        return primary
    if build_env is None:
        raise ValueError("serving_shards > 1 requires an environment builder")
    policies = getattr(env, "source_policies", None)
    if policies is None:
        raise ValueError(
            "serving_shards > 1 requires env.source_policies (set by "
            "EvaluationEnvironmentBuilder.build)"
        )
    shards = [_Shard(0, primary, env, owns_env=False)]
    t0 = time.perf_counter()
    try:
        for i in range(1, count):
            sib_env = build_env(policies)
            shards.append(
                _Shard(i, make_batcher(sib_env), sib_env, owns_env=True)
            )
    except BaseException:
        for s in shards[1:]:
            s.batcher.shutdown()
            s.env.close()
        primary.shutdown()
        raise
    logger.info(
        "serving shards: built %d sibling stack(s) in %.1f ms",
        count - 1, (time.perf_counter() - t0) * 1e3,
    )
    return ShardRouter(
        shards, heartbeat_seconds=heartbeat_seconds, supervisor=supervisor
    )
