"""MicroBatcher — gathers concurrent requests into one batched evaluation.

Requests from any number of threads queue up; one worker thread takes the
first waiting request, waits at most ``batch_timeout_ms`` for more (or
until ``max_batch_size`` are waiting), and runs ONE
``EvaluationEnvironment.validate_batch`` over the micro-batch — requests
addressed to different policies share the batch, since every launch
computes every policy's verdict. The service halves (api/service.py) wrap
the batch: the namespace short-circuit before, the mode and mutation
constraints after.

Flag semantics follow the server's ``--max-batch-size`` (default 128) and
``--batch-timeout-ms`` (default 1.0).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any

from policy_server_tpu_torch.api.service import (
    RequestOrigin,
    handle_initialization_error,
    post_evaluate,
    pre_evaluate,
)
from policy_server_tpu_torch.evaluation.errors import PolicyInitializationError
from policy_server_tpu_torch.models import ValidateRequest

logger = logging.getLogger("kubewarden-policy-server")

DEFAULT_MAX_BATCH_SIZE = 128
DEFAULT_BATCH_TIMEOUT_MS = 1.0


class MicroBatcher:
    """Owns one worker thread; ``close()`` stops it."""

    def __init__(
        self,
        env: Any,
        max_batch_size: int = DEFAULT_MAX_BATCH_SIZE,
        batch_timeout_ms: float = DEFAULT_BATCH_TIMEOUT_MS,
    ) -> None:
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be at least 1")
        self.env = env
        self.max_batch_size = max_batch_size
        self.batch_timeout = max(0.0, batch_timeout_ms) / 1e3
        self._cond = threading.Condition()
        self._queue: deque = deque()  # guarded-by: _cond
        self._closed = False  # guarded-by: _cond
        self.batches = 0  # dispatched micro-batches (worker thread only)
        self.batch_rows = 0  # rows in them
        self._worker = threading.Thread(
            target=self._run, name="micro-batcher", daemon=True
        )
        self._worker.start()

    def submit(
        self,
        policy_id: str,
        request: ValidateRequest,
        origin: RequestOrigin = RequestOrigin.VALIDATE,
    ) -> Future:
        """Queue one request → a Future of its AdmissionResponse (or the
        EvaluationError raised for an invalid or unknown policy id)."""
        return self.submit_many([(policy_id, request)], origin)[0]

    def submit_many(
        self,
        items: list[tuple[str, ValidateRequest]],
        origin: RequestOrigin = RequestOrigin.VALIDATE,
    ) -> list[Future]:
        futures = [Future() for _ in items]
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher closed")
            for (pid, req), fut in zip(items, futures):
                self._queue.append((pid, req, origin, fut))
            self._cond.notify()
        return futures

    def close(self, timeout: float = 5.0) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout)

    # -- worker ------------------------------------------------------------

    def _take_batch(self) -> list | None:
        with self._cond:
            while not self._queue and not self._closed:
                self._cond.wait()
            if not self._queue:
                return None  # closed and drained
            deadline = time.monotonic() + self.batch_timeout
            while len(self._queue) < self.max_batch_size and not self._closed:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(left)
            n = min(len(self._queue), self.max_batch_size)
            return [self._queue.popleft() for _ in range(n)]

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                self._dispatch(batch)
            except Exception as e:  # noqa: BLE001 — the worker must survive
                logger.exception("micro-batch dispatch failed")
                for *_rest, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)

    def _dispatch(self, batch: list) -> None:
        env = self.env
        pending: list[tuple[str, ValidateRequest, RequestOrigin, Future]] = []
        for pid, req, origin, fut in batch:
            try:
                short = pre_evaluate(env, pid, req)
            except Exception as e:  # noqa: BLE001 — per-item error channel
                fut.set_exception(e)
                continue
            if short is not None:
                fut.set_result(short)
            else:
                pending.append((pid, req, origin, fut))
        if not pending:
            return
        self.batches += 1
        self.batch_rows += len(pending)
        results = env.validate_batch([(pid, req) for pid, req, _o, _f in pending])
        for (pid, req, origin, fut), res in zip(pending, results):
            if isinstance(res, PolicyInitializationError):
                fut.set_result(handle_initialization_error(req, res))
            elif isinstance(res, Exception):
                fut.set_exception(res)
            else:
                fut.set_result(post_evaluate(env, pid, origin, res))
