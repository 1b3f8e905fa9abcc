"""``python -m policy_server_tpu_torch --policies FILE --port N``.

Reads the policies file with PyYAML where it is installed (a JSON file
needs nothing) and serves /validate until interrupted.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from policy_server_tpu_torch.models.policy import parse_policies
from policy_server_tpu_torch.runtime.batcher import (
    DEFAULT_BATCH_TIMEOUT_MS,
    DEFAULT_MAX_BATCH_SIZE,
)
from policy_server_tpu_torch.server import PolicyServer


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
