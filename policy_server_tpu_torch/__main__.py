"""``python -m policy_server_tpu_torch --policies FILE --port N``.

Reads the policies file with PyYAML where it is installed (a JSON file
needs nothing) and serves /validate until interrupted. The serving flags
and their defaults are the JAX package's (``config/cli.py``).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from policy_server_tpu_torch.models.policy import parse_policies
from policy_server_tpu_torch.runtime.batcher import (
    DEFAULT_BATCH_TIMEOUT_MS,
    DEFAULT_HOST_FASTPATH_THRESHOLD,
    DEFAULT_LATENCY_BUDGET_MS,
    DEFAULT_MAX_BATCH_SIZE,
    DEFAULT_POLICY_TIMEOUT,
    DEGRADED_MODES,
)
from policy_server_tpu_torch.server import PolicyServer

_SIZE_SUFFIXES = {
    "k": 1024, "ki": 1024, "kb": 1000,
    "m": 1024**2, "mi": 1024**2, "mb": 1000**2,
    "g": 1024**3, "gi": 1024**3, "gb": 1000**3,
}


def parse_size(value: str) -> int:
    """A byte size: a plain integer, or one with a K/M/G (binary) or
    KB/MB/GB (decimal) suffix, case-insensitive; a trailing 'i' (Ki/Mi/Gi)
    is the same binary unit."""
    s = str(value).strip().lower()
    for suffix in sorted(_SIZE_SUFFIXES, key=len, reverse=True):
        if s.endswith(suffix):
            return int(float(s[: -len(suffix)]) * _SIZE_SUFFIXES[suffix])
    return int(s)


def _read_policies(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        return parse_policies(json.loads(text))
    return parse_policies(yaml.safe_load(text))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="policy_server_tpu_torch")
    p.add_argument("--policies", required=True, help="policies YAML/JSON file")
    p.add_argument("--addr", default="0.0.0.0")
    p.add_argument("--port", type=int, default=3000)
    p.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs the plain "
        "PyTorch versions of the kernels)",
    )
    p.add_argument("--max-batch-size", type=int, default=DEFAULT_MAX_BATCH_SIZE)
    p.add_argument(
        "--batch-timeout-ms", type=float, default=DEFAULT_BATCH_TIMEOUT_MS
    )
    p.add_argument("--continue-on-errors", action="store_true")
    p.add_argument("--always-accept-admission-reviews-on-namespace")
    p.add_argument(
        "--policy-timeout", type=float, default=DEFAULT_POLICY_TIMEOUT,
        metavar="MAXIMUM_EXECUTION_TIME_SECONDS",
        help="Interrupt policy evaluation after the given time",
    )
    p.add_argument(
        "--host-fastpath-threshold", type=int,
        default=DEFAULT_HOST_FASTPATH_THRESHOLD, metavar="N",
        help="Micro-batches with at most N requests are answered by the "
        "bit-exact host oracle instead of a device dispatch (0 disables)",
    )
    p.add_argument(
        "--latency-budget-ms", type=float, default=DEFAULT_LATENCY_BUDGET_MS,
        metavar="MS",
        help="Soft per-request latency target: a batch whose measured "
        "device round trip would exceed the oldest request's remaining "
        "budget is answered by the host oracle (0 disables)",
    )
    p.add_argument(
        "--verdict-cache-size", type=parse_size, default="256Mi",
        metavar="BYTES",
        help="Byte budget of the two-tier verdict cache (K/M/G[i] "
        "suffixes), split between the pre-encode blob tier and the "
        "post-encode row tier; 0 disables caching and in-batch row dedup",
    )
    p.add_argument(
        "--breaker-failure-threshold", type=int, default=5, metavar="N",
        help="Device faults or watchdog trips within the window that trip "
        "the device circuit breaker open",
    )
    p.add_argument(
        "--breaker-window-seconds", type=float, default=30.0,
        metavar="SECONDS",
        help="Sliding window over which breaker failures accumulate",
    )
    p.add_argument(
        "--breaker-cooldown-seconds", type=float, default=5.0,
        metavar="SECONDS",
        help="Time a tripped breaker stays open before a half-open probe",
    )
    p.add_argument(
        "--degraded-mode", default="oracle", choices=DEGRADED_MODES,
        help="What to serve while the breaker is open: 'oracle' (bit-exact "
        "host verdicts), 'monitor' (accept-all) or 'reject' (in-band 503s)",
    )
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    server = PolicyServer(
        _read_policies(args.policies),
        host=args.addr,
        port=args.port,
        device=args.device,
        max_batch_size=args.max_batch_size,
        batch_timeout_ms=args.batch_timeout_ms,
        continue_on_errors=args.continue_on_errors,
        always_accept_admission_reviews_on_namespace=(
            args.always_accept_admission_reviews_on_namespace
        ),
        verdict_cache_size=args.verdict_cache_size,
        host_fastpath_threshold=args.host_fastpath_threshold,
        latency_budget_ms=args.latency_budget_ms,
        policy_timeout=args.policy_timeout,
        breaker_failure_threshold=args.breaker_failure_threshold,
        breaker_window_seconds=args.breaker_window_seconds,
        breaker_cooldown_seconds=args.breaker_cooldown_seconds,
        degraded_mode=args.degraded_mode,
    )
    logging.getLogger("kubewarden-policy-server").info(
        "serving on %s:%d (%s)", args.addr, server.port, server.env.device
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
