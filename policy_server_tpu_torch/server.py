"""PolicyServer — the environment, the micro-batcher and the HTTP frontend.

``PolicyServer(policies, device=...)`` builds the evaluation environment
(on the card unless the caller asks for the CPU), starts the batcher and
serves the API on ``host:port`` from a ``ThreadingHTTPServer``: each
connection's thread parses its request and waits on the batcher's future,
so concurrent requests form micro-batches.
"""

from __future__ import annotations

import threading
from http.server import ThreadingHTTPServer
from typing import Any, Mapping

from policy_server_tpu_torch.api.handlers import ApiHandler
from policy_server_tpu_torch.evaluation.environment import (
    EvaluationEnvironmentBuilder,
)
from policy_server_tpu_torch.runtime.batcher import (
    DEFAULT_BATCH_TIMEOUT_MS,
    DEFAULT_MAX_BATCH_SIZE,
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
    ) -> None:
        self.env = EvaluationEnvironmentBuilder(
            device=device,
            continue_on_errors=continue_on_errors,
            always_accept_admission_reviews_on_namespace=(
                always_accept_admission_reviews_on_namespace
            ),
        ).build(policies)
        self.env.warmup((1, max_batch_size))
        self.batcher = MicroBatcher(self.env, max_batch_size, batch_timeout_ms)
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
