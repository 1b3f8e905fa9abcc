"""PolicyServer — the environment, the micro-batcher and the HTTP frontend.

``PolicyServer(policies, device=...)`` builds the evaluation environment
(on the card unless the caller asks for the CPU) with its verdict cache and
device circuit breaker, starts the batcher (warming every batch bucket and
seeding its device round-trip estimate) and serves the API on
``host:port`` from a ``ThreadingHTTPServer``: each connection's thread
parses its request and waits on the batcher's future, so concurrent
requests form micro-batches.
"""

from __future__ import annotations

import gc
import threading
from http.server import ThreadingHTTPServer
from typing import Any, Mapping

from policy_server_tpu_torch.api.handlers import ApiHandler
from policy_server_tpu_torch.evaluation.environment import (
    DEFAULT_VERDICT_CACHE_SIZE,
    EvaluationEnvironmentBuilder,
)
from policy_server_tpu_torch.runtime.batcher import (
    DEFAULT_BATCH_TIMEOUT_MS,
    DEFAULT_HOST_FASTPATH_THRESHOLD,
    DEFAULT_LATENCY_BUDGET_MS,
    DEFAULT_MAX_BATCH_SIZE,
    DEFAULT_POLICY_TIMEOUT,
    MicroBatcher,
)


class _HttpServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # admission webhooks arrive in bursts from many API-server
    # connections; the default listen backlog of 5 would drop SYNs
    request_queue_size = 1024

    def __init__(self, addr: tuple[str, int], batcher: MicroBatcher) -> None:
        self.batcher = batcher
        super().__init__(addr, ApiHandler)


class PolicyServer:
    def __init__(
        self,
        policies: Mapping[str, Any],
        host: str = "127.0.0.1",
        port: int = 3000,
        device: Any = None,
        max_batch_size: int = DEFAULT_MAX_BATCH_SIZE,
        batch_timeout_ms: float = DEFAULT_BATCH_TIMEOUT_MS,
        continue_on_errors: bool = False,
        always_accept_admission_reviews_on_namespace: str | None = None,
        verdict_cache_size: int = DEFAULT_VERDICT_CACHE_SIZE,
        host_fastpath_threshold: int = DEFAULT_HOST_FASTPATH_THRESHOLD,
        latency_budget_ms: float = DEFAULT_LATENCY_BUDGET_MS,
        policy_timeout: float | None = DEFAULT_POLICY_TIMEOUT,
        breaker_failure_threshold: int = 5,
        breaker_window_seconds: float = 30.0,
        breaker_cooldown_seconds: float = 5.0,
        degraded_mode: str = "oracle",
    ) -> None:
        self.env = EvaluationEnvironmentBuilder(
            device=device,
            continue_on_errors=continue_on_errors,
            always_accept_admission_reviews_on_namespace=(
                always_accept_admission_reviews_on_namespace
            ),
            verdict_cache_size=verdict_cache_size,
            breaker_config=dict(
                failure_threshold=breaker_failure_threshold,
                window_seconds=breaker_window_seconds,
                cooldown_seconds=breaker_cooldown_seconds,
            ),
        ).build(policies)
        self.batcher = MicroBatcher(
            self.env,
            max_batch_size=max_batch_size,
            batch_timeout_ms=batch_timeout_ms,
            policy_timeout=policy_timeout,
            host_fastpath_threshold=host_fastpath_threshold,
            latency_budget_ms=latency_budget_ms,
            degraded_mode=degraded_mode,
        )
        self.batcher.warmup()
        # collect the build's and the warmup's garbage (and any the caller
        # left) before serving: left to the first full collection under
        # traffic, the finalizers of freed device and page-locked memory
        # ran on whichever serving thread triggered it, and stalled it for
        # up to 2 s on an H100 host (``PERF.md``)
        gc.collect()
        self._httpd = _HttpServer((host, port), self.batcher)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        """Serve on a background thread."""
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="http", daemon=True
        )
        self._thread.start()

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5)
        self.batcher.close()
