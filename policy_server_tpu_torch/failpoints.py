"""Fault-injection failpoints.

The serving path calls ``fire("site")`` at named failure sites. With no
failpoint configured — the production state — ``fire`` is one test of a
module global and returns at once: no allocation, no dict lookup, no lock
on the hot path.

Activation, either:

* a configuration string (the ``FAILPOINTS`` environment variable, read at
  import and again by :func:`configure_from_env`)::

      FAILPOINTS="device.fetch=sleep:5;encode.batch=raise:boom*3"

  grammar per entry: ``site=action[:param][*count]`` —
  ``raise[:message]`` raises :class:`FailpointError`, ``sleep:seconds``
  blocks, ``off`` clears the site. ``*count`` disarms the action after it
  fired ``count`` times (the fail-then-succeed shape chaos tests need).

* programmatic (tests): ``set_failpoint("site", fn, count=None)`` installs
  any callable — an Event-gated hang, a custom exception — or use the
  :func:`active` context manager for scoped injection.

``set_failpoint(..., scope="name")`` arms the action only for threads whose
ambient failpoint scope (a thread-local set with :func:`scope`) matches;
unscoped failpoints fire everywhere. Code that hands work to another
thread carries the scope across with ``with scope(current_scope()):``.

Sites instrumented (grep for ``failpoints.fire``):

==================  =====================================================
``device.fetch``    device result fetch (environment._device_fetch) —
                    ``sleep`` = hung device, ``raise`` = dispatch fault
``encode.batch``    host batch encode (the native pipeline's encode of
                    each schema bucket and chunk)
``fetch.http``      every registry or HTTPS GET (fetch/downloader.py) —
                    an injected failure is retryable, like a real 5xx or
                    timeout; the retries are counted
``watch.stream``    before every watch-stream connect (audit/
                    watch_feed.py) — ``raise`` = a watch transport fault;
                    the kind's loop backs off and resyncs through a
                    counted full re-LIST, the snapshot keeps serving
``frontend.accept`` the native HTTP frontend's intake of one drained
                    burst (runtime/native_frontend.py) — ``raise``
                    answers every request of the burst 500 in-band
``shard.dispatch``  top of each MicroBatcher dispatch-loop iteration
                    (runtime/batcher.py), before any queue pop — ``raise``
                    kills the dispatch thread holding no row (the
                    self-heal watchdog revives it)
``reload.fetch``    policy hot-reload fetch stage (lifecycle.py) —
                    ``raise`` = an unreadable policies file; the reload
                    is rejected and last-good keeps serving
``reload.compile``  policy hot-reload compile+warm stage (lifecycle.py) —
                    ``raise`` = a candidate set that fails to build;
                    ``sleep`` = a compile stall (serving is untouched)
``reload.canary``   policy hot-reload shadow canary (lifecycle.py) —
                    ``raise`` = a canary fault; the candidate is
                    rejected, never promoted
``audit.sweep``     head of every audit sweep (audit/scanner.py) —
                    ``raise`` aborts the sweep: its rows stay dirty, the
                    error is counted and the next trigger retries
``certs.reload``    TLS identity reload (certs.py) — ``raise`` stands for
                    corrupt cert material mid-rotation: the last good
                    identity keeps serving and the failure is counted
``tls.handshake``   native TLS accept path (runtime/native_frontend.py
                    ``NativeTlsManager``, polled every 0.25 s) — ``raise``
                    refuses every new handshake until it is disarmed;
                    established connections are untouched
==================  =====================================================

Every fire is counted (``fired_count(site)``) so a test can check that an
injection really intercepted the path it claims to cover.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable

ENV_VAR = "FAILPOINTS"


class FailpointError(Exception):
    """The injected fault for ``raise`` actions."""


class _Point:
    __slots__ = ("fn", "remaining", "scope")

    def __init__(
        self,
        fn: Callable[[], None],
        remaining: int | None,
        scope: str | None = None,
    ):
        self.fn = fn
        self.remaining = remaining  # None = unlimited
        self.scope = scope  # None = fire for every thread


_lock = threading.Lock()
_points: dict[str, _Point] = {}  # guarded-by: _lock
_fired: dict[str, int] = {}  # guarded-by: _lock
# the ONE hot-path gate: False ⇒ fire() returns before touching any dict
# lock-free: a single bool; a stale read only delays (dis)arming
_armed = False


def fire(site: str) -> None:
    """Trigger the failpoint for ``site`` if one is armed; no-op (one
    global check) otherwise. Called from serving hot paths — per batch,
    never per row."""
    if not _armed:
        return
    _fire_slow(site)


def _fire_slow(site: str) -> None:
    with _lock:
        point = _points.get(site)
        if point is None:
            return
        if point.scope is not None and point.scope != current_scope():
            return  # scoped to other threads: no-op
        if point.remaining is not None:
            if point.remaining <= 0:
                return
            point.remaining -= 1
            if point.remaining == 0:
                # leave the exhausted point in place (fired counts keep
                # accumulating semantics simple); it no longer fires
                pass
        _fired[site] = _fired.get(site, 0) + 1
        fn = point.fn
    fn()  # OUTSIDE the lock: a sleeping/hanging action must not block
    # concurrent fire() calls on other sites


def set_failpoint(
    site: str,
    fn: Callable[[], None],
    count: int | None = None,
    scope: str | None = None,
) -> None:
    """Install a callable to run on every ``fire(site)`` (at most
    ``count`` times when given; only for threads whose ambient
    failpoint scope matches when ``scope`` is given)."""
    global _armed
    with _lock:
        _points[site] = _Point(fn, count, scope)
        _armed = True


# -- scoping (thread-local ambient scope) ----------------------------------

_tls = threading.local()


def current_scope() -> str | None:
    """The calling thread's ambient failpoint scope (None outside any
    ``with scope(...)`` block)."""
    return getattr(_tls, "scope", None)


class scope:
    """Set the ambient failpoint scope for the calling thread::

        with failpoints.scope("a"):
            ...  # failpoints scoped to "a" fire here

    Nests (the previous scope is restored on exit); a ``None`` name is a
    no-op passthrough so call sites need no conditional."""

    __slots__ = ("name", "_prev")

    def __init__(self, name: str | None):
        self.name = name
        self._prev: str | None = None

    def __enter__(self) -> "scope":
        self._prev = getattr(_tls, "scope", None)
        if self.name is not None:
            _tls.scope = self.name
        return self

    def __exit__(self, *exc) -> None:
        if self.name is not None:
            _tls.scope = self._prev


def clear(site: str | None = None) -> None:
    """Remove one site's failpoint, or all of them (``site=None``)."""
    global _armed
    with _lock:
        if site is None:
            _points.clear()
        else:
            _points.pop(site, None)
        _armed = bool(_points)


def reset() -> None:
    """Full reset: clear every failpoint AND the fired counters."""
    clear()
    with _lock:
        _fired.clear()


def fired_count(site: str) -> int:
    with _lock:
        return _fired.get(site, 0)


class active:
    """Scoped injection for tests::

        with failpoints.active("device.fetch", lambda: time.sleep(2)):
            ...
    """

    def __init__(
        self,
        site: str,
        fn: Callable[[], None],
        count: int | None = None,
        scope: str | None = None,
    ):
        self.site = site
        self.fn = fn
        self.count = count
        self.scope = scope

    def __enter__(self) -> "active":
        set_failpoint(self.site, self.fn, self.count, scope=self.scope)
        return self

    def __exit__(self, *exc) -> None:
        clear(self.site)


# ---------------------------------------------------------------------------
# String/env configuration
# ---------------------------------------------------------------------------


def _parse_action(spec: str) -> tuple[Callable[[], None], int | None]:
    """``action[:param][*count]`` → (callable, count)."""
    count: int | None = None
    if "*" in spec:
        spec, _, c = spec.rpartition("*")
        count = int(c)
    action, _, param = spec.partition(":")
    action = action.strip().lower()
    if action == "raise":
        message = param or "injected fault"

        def fn() -> None:
            raise FailpointError(message)

        return fn, count
    if action == "sleep":
        seconds = float(param or "1")

        def fn() -> None:
            time.sleep(seconds)

        return fn, count
    raise ValueError(f"unknown failpoint action {action!r}")


def configure(spec: str) -> None:
    """Install failpoints from a ``site=action;site=action`` string.
    ``site=off`` clears that site; an empty string clears everything."""
    spec = (spec or "").strip()
    if not spec:
        reset()
        return
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        site, sep, action = entry.partition("=")
        if not sep:
            raise ValueError(f"malformed failpoint entry {entry!r}")
        site = site.strip()
        if action.strip().lower() == "off":
            clear(site)
            continue
        fn, count = _parse_action(action)
        set_failpoint(site, fn, count)


def configure_from_env() -> None:
    spec = os.environ.get(ENV_VAR, "")
    if spec:
        configure(spec)


configure_from_env()
