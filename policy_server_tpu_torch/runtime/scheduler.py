"""Weighted-fair dispatch scheduler: the one arbitration point of the card
and the host CPU between tenants (the JAX package's
``runtime/scheduler.py``).

Every tenant's batcher (``tenancy.py``) acquires a dispatch slot before it
evaluates a batch; at most ``max_concurrent`` evaluations run at once. The
grant order:

* live before audit: a waiting live batch is always granted before an
  audit one;
* weighted shares among tenants, by virtual-time stride scheduling: each
  live grant advances the tenant's virtual clock by ``1/weight`` and the
  waiter with the lowest clock wins, so under contention grant counts
  converge to the weight ratio. A tenant that went idle banks no credit:
  its clock is floored to the lowest clock among the live waiters.

A batcher asks for a LIVE slot for each formed batch and for an AUDIT slot
for each batch of its best-effort audit lane (``MicroBatcher.submit_audit``).
Without tenants no scheduler exists and the batcher never asks for a slot.
Per tenant it counts grants, the summed wait for a slot and the waiters of
the moment (the tenant-labelled /metrics families).
"""

from __future__ import annotations

import itertools
import threading
import time

# priority classes (grant order: lower value first)
LIVE = 0
AUDIT = 1

# bounded condition-wait slice: every waiter re-checks its abort within one
# slice, so shutdown can never strand a blocked acquire
_WAIT_SLICE_SECONDS = 0.05


class _Waiter:
    __slots__ = ("tenant", "priority", "seq", "granted")

    def __init__(self, tenant: str, priority: int, seq: int):
        self.tenant = tenant
        self.priority = priority
        self.seq = seq
        self.granted = False


class FairDispatchScheduler:
    """The weighted-fair slot gate every tenant's batcher shares (module
    docstring)."""

    def __init__(
        self,
        max_concurrent: int = 4,
        weights: dict[str, float] | None = None,
        default_weight: float = 1.0,
    ) -> None:
        self.max_concurrent = max(1, int(max_concurrent))
        self.default_weight = max(1e-6, float(default_weight))
        self._weights = {
            k: max(1e-6, float(v)) for k, v in (weights or {}).items()
        }
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._inflight = 0  # guarded-by: _lock
        self._seq = itertools.count()  # guarded-by: _lock
        self._waiters: list[_Waiter] = []  # guarded-by: _lock
        self._vtime: dict[str, float] = {}  # guarded-by: _lock
        self._grants: dict[str, int] = {}  # guarded-by: _lock
        self._wait_ns: dict[str, int] = {}  # guarded-by: _lock

    def weight_of(self, tenant: str) -> float:
        return self._weights.get(tenant, self.default_weight)

    def acquire(
        self,
        tenant: str,
        priority: int = LIVE,
        timeout: float | None = None,
        should_abort=None,
    ) -> bool:
        """Block until a slot is granted → True; False on ``timeout`` or
        once ``should_abort()`` turns true (shutdown)."""
        t0 = time.perf_counter()
        deadline = None if timeout is None else t0 + timeout
        with self._lock:
            w = _Waiter(tenant, priority, next(self._seq))
            self._waiters.append(w)
            self._grant_locked()
            while not w.granted:
                if should_abort is not None and should_abort():
                    self._waiters.remove(w)
                    return False
                wait = _WAIT_SLICE_SECONDS
                if deadline is not None:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        self._waiters.remove(w)
                        return False
                    wait = min(wait, remaining)
                self._cond.wait(wait)
            self._wait_ns[tenant] = self._wait_ns.get(tenant, 0) + int(
                (time.perf_counter() - t0) * 1e9
            )
            return True

    def release(self, tenant: str) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            self._grant_locked()
            self._cond.notify_all()

    def _grant_locked(self) -> None:
        # holds: _lock — grant slots to the best waiters until the cap is
        # reached or nobody waits
        granted_any = False
        while self._inflight < self.max_concurrent and self._waiters:
            best = min(
                self._waiters,
                key=lambda w: (
                    w.priority, self._vtime.get(w.tenant, 0.0), w.seq,
                ),
            )
            self._waiters.remove(best)
            best.granted = True
            self._inflight += 1
            granted_any = True
            if best.priority == LIVE:
                # an audit grant only ever takes an idle slot, so it does
                # not charge the tenant's live share
                floor = min(
                    (
                        self._vtime.get(w.tenant, 0.0)
                        for w in self._waiters
                        if w.priority == LIVE
                    ),
                    default=self._vtime.get(best.tenant, 0.0),
                )
                self._vtime[best.tenant] = (
                    max(self._vtime.get(best.tenant, 0.0), floor)
                    + 1.0 / self.weight_of(best.tenant)
                )
            self._grants[best.tenant] = self._grants.get(best.tenant, 0) + 1
        if granted_any:
            self._cond.notify_all()

    def stats(self) -> dict[str, dict]:
        """Per tenant, under one lock: grants, the summed wait (ns) and the
        waiters of the moment."""
        with self._lock:
            depth: dict[str, int] = {}
            for w in self._waiters:
                depth[w.tenant] = depth.get(w.tenant, 0) + 1
            tenants = set(self._grants) | set(self._wait_ns) | set(depth)
            return {
                t: {
                    "grants": self._grants.get(t, 0),
                    "wait_ns": self._wait_ns.get(t, 0),
                    "waiting": depth.get(t, 0),
                }
                for t in tenants
            }
