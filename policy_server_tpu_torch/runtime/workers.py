"""Daemon-thread task executor for device-facing work.

``concurrent.futures.ThreadPoolExecutor`` workers are non-daemon and joined
at interpreter exit; a worker wedged inside a hung device call (the exact
failure the dispatch watchdog exists for — a fetch that never returns)
would block process shutdown forever. This executor keeps the same
``submit() -> Future`` surface but runs tasks on daemon threads, so an
abandoned hung call can never hold the process hostage."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future


class DaemonExecutor:
    """Fixed-width daemon-thread pool with a ThreadPoolExecutor-compatible
    subset: ``submit``, ``shutdown(wait=...)``."""

    def __init__(self, max_workers: int, thread_name_prefix: str = "worker"):
        self._tasks: queue.Queue = queue.Queue()
        self._shutdown = False  # guarded-by: _lock
        self._lock = threading.Lock()
        self._threads = [
            threading.Thread(
                target=self._run,
                name=f"{thread_name_prefix}-{i}",
                daemon=True,
            )
            for i in range(max_workers)
        ]
        for t in self._threads:
            t.start()

    def _run(self) -> None:
        while True:
            item = self._tasks.get()
            if item is None:  # poison pill
                return
            fut, fn, args, kwargs = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args, **kwargs))
            except BaseException as e:  # noqa: BLE001 — future carries it
                fut.set_exception(e)

    def submit(self, fn, *args, **kwargs) -> Future:
        with self._lock:
            if self._shutdown:
                raise RuntimeError("cannot schedule new futures after shutdown")
            fut: Future = Future()
            self._tasks.put((fut, fn, args, kwargs))
            return fut

    def shutdown(self, wait: bool = True) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            for _ in self._threads:
                self._tasks.put(None)
        if wait:
            # Bounded join: daemon threads wedged in a hung device call are
            # abandoned (their futures were already resolved in-band by the
            # watchdog); everything healthy drains its queue first.
            for t in self._threads:
                t.join(timeout=5)
