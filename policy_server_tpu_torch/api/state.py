"""Shared API server state, and the readiness verdict both HTTP ports'
handlers read."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


def readiness(batcher: Any) -> tuple[int, str]:
    """The /readiness verdict. 503 while the device breaker is open under
    ``--degraded-mode reject``, as the JAX package's (every review would be
    answered with an in-band 503); otherwise 200. Once the breaker has
    tripped, or a kernel or CUDA error has failed requests, the body shows
    the counts, so host answers in place of the device's are never
    silent."""
    env = batcher.env
    if batcher.degraded_mode == "reject" and env.breaker_all_open:
        return 503, (
            "the device breaker is open and --degraded-mode reject refuses "
            "traffic"
        )
    stats = env.breaker_stats
    errors = env.device_errors
    if not stats.get("trips") and not errors:
        return 200, "ok"
    return 200, (
        f"ok; device breaker {'open' if stats['open_shards'] else 'closed'}: "
        f"trips {stats['trips']}, recoveries {stats['recoveries']}, requests "
        f"answered by the host oracle while open "
        f"{stats['short_circuited_requests']}; device errors {errors}"
    )


@dataclass
class ApiServerState:
    evaluation_environment: Any
    batcher: Any
    hostname: str = ""
    # routes /debug/pprof/cpu and /debug/pprof/heap on the API port
    enable_pprof: bool = False
    # False until the environment is built and the batcher warmed
    ready: bool = True
    # the runtime/native_frontend.NativeFrontend under --frontend native
    native_frontend: Any = None

    def readiness(self) -> tuple[int, str]:
        """503 before the first warmup has finished, then ``readiness``."""
        if not self.ready:
            return 503, "policies not yet compiled and warmed"
        return readiness(self.batcher)
