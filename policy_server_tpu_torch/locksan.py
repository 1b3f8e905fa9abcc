"""Lock-order sanitizer: the JAX package's ``locksan.py`` for this package.

Opt-in instrumentation of every ``threading.Lock``/``RLock`` the
package creates: when armed, the factory is monkeypatched so locks
constructed from ``policy_server_tpu_torch`` code return a
:class:`SanLock` wrapper that records, per thread, the stack of locks
currently held. Each acquisition while another lock is held adds an edge
to a global acquired-after graph (with the acquisition stack captured
the first time an edge is seen); a cycle in that graph is a lock-order
inversion — two threads interleaving those chains can deadlock. Releases
also record hold durations, and holds longer than the deadline threshold
(``GRAFTCHECK_LOCKSAN_HOLD_MS``, default 2000 ms — the policy deadline)
are reported as long-hold events.

Zero-cost off: nothing in this module runs unless :func:`install` is
called, and production code never imports it. ``install()`` must run
before the package's modules are imported: a lock a module builds at its
import is built by the factory in place then. The tests arm it in a
subprocess (``tests/test_torch_locksan.py``), as does ``chip_smoke.py``
phase 16.

Lock identity is the CREATION SITE (``file:line`` of the constructor
call), not the instance: the order contract "batcher stats lock before
breaker lock" is a property of the code paths, so all instances created
at one site share a graph node. Consequences, both deliberate:

* same-site edges (instance A's lock taken while instance B's lock
  from the same line is held) are ignored — hand-over-hand over
  same-class instances would need an instance-level order we don't
  impose anywhere;
* an inversion between two sites is reported even if the two observed
  chains used different instances — that is still a latent deadlock
  for the instance-sharing case and exactly what a static reviewer
  would flag.

Only locks created from package code are wrapped (the factory inspects
the caller's frame once, at construction): stdlib internals (logging,
queue, ThreadPoolExecutor) keep native locks, so arming does not
perturb unrelated machinery.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

_installed = False
# the sanitizer's own state lock — constructed at import time, which is
# necessarily before install() can patch the factory, so it is a native
# lock and never self-instruments
_state_lock = threading.Lock()
_edges: dict[tuple[str, str], list[str]] = {}  # guarded-by: _state_lock
_long_holds: list[tuple[str, float, list[str]]] = []  # guarded-by: _state_lock
_max_hold: dict[str, float] = {}  # guarded-by: _state_lock
_acquisitions = 0  # guarded-by: _state_lock

_tls = threading.local()

HOLD_THRESHOLD_MS = float(os.environ.get("GRAFTCHECK_LOCKSAN_HOLD_MS", "2000"))
_PKG_DIR = os.path.dirname(os.path.abspath(__file__))


def _held_stack() -> list:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _site_of_caller() -> str | None:
    """file:line of the frame constructing the lock, package-relative;
    None when the constructor is not package code."""
    frame = sys._getframe(2)
    fname = frame.f_code.co_filename
    if not fname.startswith(_PKG_DIR) or fname == __file__:
        return None
    rel = os.path.relpath(fname, os.path.dirname(_PKG_DIR))
    return f"{rel}:{frame.f_lineno}"


class SanLock:
    """Instrumented wrapper with the threading.Lock surface the package
    uses (acquire/release/locked/context manager)."""

    __slots__ = ("_lock", "site", "_acquired_at", "_reentrant", "_depth")

    def __init__(self, real, site: str, reentrant: bool):
        self._lock = real
        self.site = site
        self._acquired_at = 0.0
        self._reentrant = reentrant
        # re-entrancy depth (RLock): hold time must span OUTER acquire
        # to OUTER release, so the timestamp is taken only at 0 -> 1 and
        # the duration only at 1 -> 0. Same-thread only by definition of
        # re-entrancy, so a plain int is safe.
        self._depth = 0

    # -- threading.Lock surface -------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._on_acquired()
        return got

    def release(self) -> None:
        self._on_release()
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "SanLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- recording ---------------------------------------------------------

    def _on_acquired(self) -> None:
        held = _held_stack()
        now = time.monotonic()
        new_edges = []
        for prior in held:
            if prior.site != self.site:
                new_edges.append((prior.site, self.site))
        self._depth += 1
        if self._depth == 1:
            self._acquired_at = now
        held.append(self)
        with _state_lock:
            global _acquisitions
            _acquisitions += 1
            for edge in new_edges:
                if edge not in _edges:
                    _edges[edge] = traceback.format_stack(
                        sys._getframe(2), limit=12
                    )

    def _on_release(self) -> None:
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        self._depth -= 1
        if self._depth > 0:  # inner re-entrant release: not the hold end
            return
        dur_ms = (time.monotonic() - self._acquired_at) * 1000.0
        with _state_lock:
            if dur_ms > _max_hold.get(self.site, 0.0):
                _max_hold[self.site] = dur_ms
            if dur_ms > HOLD_THRESHOLD_MS:
                _long_holds.append(
                    (
                        self.site,
                        dur_ms,
                        traceback.format_stack(sys._getframe(2), limit=8),
                    )
                )


def _factory(real_ctor, reentrant: bool):
    def make(*args, **kwargs):
        site = _site_of_caller()
        real = real_ctor(*args, **kwargs)
        if site is None:
            return real
        return SanLock(real, site, reentrant)

    return make


def install() -> None:
    """Arm the sanitizer: patch threading.Lock/RLock so package-created
    locks are instrumented. Idempotent."""
    global _installed
    if _installed:
        return
    threading.Lock = _factory(_REAL_LOCK, False)  # type: ignore[assignment]
    threading.RLock = _factory(_REAL_RLOCK, True)  # type: ignore[assignment]
    _installed = True


def uninstall() -> None:
    global _installed
    threading.Lock = _REAL_LOCK  # type: ignore[assignment]
    threading.RLock = _REAL_RLOCK  # type: ignore[assignment]
    _installed = False


def installed() -> bool:
    return _installed


def reset() -> None:
    with _state_lock:
        _edges.clear()
        _long_holds.clear()
        _max_hold.clear()
        global _acquisitions
        _acquisitions = 0


def cycles() -> list[list[str]]:
    """Cycles (lock-order inversions) in the acquired-after graph, each
    as the sorted list of member sites (SCCs with >1 node)."""
    from policy_server_tpu_torch.utils.graphs import strongly_connected_components

    with _state_lock:
        graph: dict[str, set[str]] = {}
        for a, b in _edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
    return strongly_connected_components(graph)


def report() -> dict:
    """Snapshot for the end-of-session reporter: edge count, inversions
    (with first-seen acquisition stacks), long holds, max hold times."""
    found = cycles()
    with _state_lock:
        edge_list = sorted(_edges)
        inversion_stacks = {}
        for cyc in found:
            members = set(cyc)
            for edge in edge_list:
                if edge[0] in members and edge[1] in members:
                    inversion_stacks[edge] = _edges[edge]
        return {
            "acquisitions": _acquisitions,
            "edges": edge_list,
            "inversions": found,
            "inversion_stacks": inversion_stacks,
            "long_holds": list(_long_holds),
            "max_hold_ms": dict(sorted(_max_hold.items())),
        }


def format_report(rep: dict | None = None) -> str:
    rep = rep or report()
    lines = [
        "graftcheck locksan: "
        f"{rep['acquisitions']} acquisitions, "
        f"{len(rep['edges'])} distinct order edges, "
        f"{len(rep['inversions'])} inversion(s), "
        f"{len(rep['long_holds'])} long hold(s) "
        f"(> {HOLD_THRESHOLD_MS:.0f} ms)",
    ]
    for cyc in rep["inversions"]:
        lines.append("  INVERSION (potential deadlock): " + " <-> ".join(cyc))
        for edge, stack in rep["inversion_stacks"].items():
            if edge[0] in cyc and edge[1] in cyc:
                lines.append(f"    first {edge[0]} -> {edge[1]} at:")
                lines.extend("      " + ln.rstrip() for ln in stack[-3:])
    for site, dur, _stack in rep["long_holds"][:10]:
        lines.append(f"  LONG HOLD: {site} held {dur:.0f} ms")
    return "\n".join(lines)
