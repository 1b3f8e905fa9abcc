"""``python -m policy_server_tpu_torch --policies FILE``.

Reads the policies file with PyYAML where it is installed (a JSON file
needs nothing) and serves /validate on ``--port`` (3000) and /readiness,
/metrics, /debug/timeline and the /policies/* admin endpoints on
``--readiness-probe-port`` (8081) until interrupted; ``--frontend native``
serves the API port's evaluation POSTs from the C++ frontend;
``--cert-file``/``--key-file`` serve it over HTTPS (``--client-ca-file``
adds mTLS; ``--native-tls``), and ``--http-workers N`` adds prefork worker
processes on it. By default
the policies file is watched and a changed digest, SIGHUP or ``POST
/policies/reload`` reloads it (``--policy-reload-mode``); ``--tenants``
serves named tenants beside the default one and ``--serving-shards`` serves
each from several stacks; ``--audit-mode interval|on-promote`` runs the
background audit scanner (``--audit-matrix`` its verdict matrix,
``--audit-watch`` the live list+watch feed). ``--state-dir DIR`` keeps
the durable last-good state (``statestore.py``): the artifact cache, the
per-tenant manifests, the boot report, the shard incident log and, with
the audit scanner on, the audit snapshot spill (``--state-audit-spill-
seconds``) and the verdict matrix journal (``--audit-matrix-spill-
seconds``), so a restart boots warm and resumes compliance.
``--log-fmt otlp`` exports spans, and ``--enable-metrics`` pushes the
metrics, over OTLP/gRPC to ``OTEL_EXPORTER_OTLP_ENDPOINT`` where it is set
(``telemetry/otlp.py``). Modules that are not
builtins are fetched (``--policies-download-dir``, ``--sources-path``,
``--docker-config-json-path``) and verified (``--verification-path``,
``--sigstore-cache-dir``); the sources and verification files are JSON, or
YAML where PyYAML is installed. Context-aware policies read the cluster
through the in-cluster Kubernetes API (``--context-*``,
``--kube-insecure-skip-tls-verify``,
``--ignore-kubernetes-connection-failure``). ``--evaluation-backend jax``
(the default) is this package's device backend — the CUDA kernels on the
card, or their plain PyTorch versions under ``--device cpu``; ``oracle`` is
the host interpreter. ``docs --output FILE`` writes the markdown CLI
reference, and ``--daemon`` detaches. ``--mesh`` lays a device mesh over
the cards (the data axis, and a policy axis in the fused form,
``parallel/mesh.py``), and ``--distributed-*`` join a ``torch.distributed``
process group before it is laid. The flags, their defaults, choices,
validation and ``KUBEWARDEN_*`` environment variables are the JAX
package's (``config/cli.py``, ``config/config.py``).
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import threading
from typing import Any

from policy_server_tpu_torch import __version__
from policy_server_tpu_torch.audit import parse_watch_resources
from policy_server_tpu_torch.config import read_sources_file, read_verification_file
from policy_server_tpu_torch.runtime.batcher import (
    DEFAULT_BATCH_TIMEOUT_MS,
    DEFAULT_HOST_FASTPATH_THRESHOLD,
    DEFAULT_LATENCY_BUDGET_MS,
    DEFAULT_MAX_BATCH_SIZE,
    DEFAULT_POLICY_TIMEOUT,
    DEGRADED_MODES,
)
from policy_server_tpu_torch.certs import TlsConfig
from policy_server_tpu_torch.parallel.mesh import MeshSpec
from policy_server_tpu_torch.server import (
    DEFAULT_AUDIT_WATCH_MAX_QUEUE_EVENTS,
    DEFAULT_AUDIT_WATCH_RESOURCES,
    DEFAULT_CONTEXT_REFRESH_SECONDS,
    DEFAULT_NATIVE_IDLE_TIMEOUT_SECONDS,
    DEFAULT_NATIVE_READ_TIMEOUT_SECONDS,
    DEFAULT_NATIVE_TLS_HANDSHAKE_TIMEOUT_SECONDS,
    DEFAULT_READINESS_PROBE_PORT,
    DEFAULT_RELOAD_CANARY_REQUESTS,
    DEFAULT_REQUEST_TIMEOUT_MS,
    DEFAULT_SELFHEAL_INTERVAL_SECONDS,
    DEFAULT_SHARD_HEARTBEAT_SECONDS,
    DEFAULT_WORKER_RESPAWN_GIVEUP,
    FRONTENDS,
    MESH_DISPATCHES,
    NATIVE_TLS_MODES,
    RELOAD_MODES,
    PolicyServer,
    read_policies_source,
)
from policy_server_tpu_torch.telemetry import flightrec
from policy_server_tpu_torch.telemetry.tracing import setup_tracing
from policy_server_tpu_torch.tenancy import read_tenants_file

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


PROG = "policy_server_tpu_torch"


def _flag_specs() -> list[tuple[str, str | None, dict[str, Any]]]:
    """(flag, environment variable, argparse keywords): the JAX package's
    names, defaults, choices and ``KUBEWARDEN_*`` variables
    (``config/cli.py``) for the flags this package has."""
    return [
        ("--addr", "KUBEWARDEN_BIND_ADDRESS",
         dict(default="0.0.0.0", metavar="BIND_ADDRESS",
              help="Bind against ADDRESS")),
        ("--port", "KUBEWARDEN_PORT",
         dict(type=int, default=3000, metavar="PORT",
              help="Listen on PORT")),
        ("--readiness-probe-port", "KUBEWARDEN_READINESS_PROBE_PORT",
         dict(type=int, default=DEFAULT_READINESS_PROBE_PORT,
              metavar="READINESS_PROBE_PORT",
              help="Expose the readiness endpoint (and /metrics and "
                   "/debug/timeline) on this (plaintext) port")),
        ("--policies", "KUBEWARDEN_POLICIES",
         dict(default="policies.yml", metavar="POLICIES_FILE",
              help="YAML (or JSON) file holding the policies to be loaded "
                   "and their settings")),
        ("--policies-download-dir", "KUBEWARDEN_POLICIES_DOWNLOAD_DIR",
         dict(default=".", metavar="POLICIES_DOWNLOAD_DIR",
              help="Download path for the policies")),
        ("--sources-path", "KUBEWARDEN_SOURCES_PATH",
         dict(default=None, metavar="SOURCES_PATH",
              help="YAML file holding source information (registries, HTTP, "
                   "insecure sources, authorities)")),
        ("--verification-path", "KUBEWARDEN_VERIFICATION_CONFIG_PATH",
         dict(default=None, metavar="VERIFICATION_CONFIG_PATH",
              help="YAML file holding verification config information "
                   "(signatures, requirements)")),
        ("--sigstore-cache-dir", "KUBEWARDEN_SIGSTORE_CACHE_DIR",
         dict(default="sigstore-data", metavar="SIGSTORE_CACHE_DIR",
              help="Directory used to cache sigstore data")),
        ("--docker-config-json-path", "KUBEWARDEN_DOCKER_CONFIG_JSON_PATH",
         dict(default=None, metavar="DOCKER_CONFIG",
              help="Path to a Docker config.json-like file holding registry "
                   "authentication details")),
        ("--workers", "KUBEWARDEN_WORKERS",
         dict(type=int, default=None, metavar="WORKERS_NUMBER",
              help="Number of concurrent evaluation slots (default: number "
                   "of CPUs); with --max-batch-size it bounds the batcher's "
                   "queue (WORKERS x MAX_BATCH_SIZE rows)")),
        ("--policy-timeout", "KUBEWARDEN_POLICY_TIMEOUT",
         dict(type=float, default=DEFAULT_POLICY_TIMEOUT,
              metavar="MAXIMUM_EXECUTION_TIME_SECONDS",
              help="Interrupt policy evaluation after the given time")),
        ("--request-timeout-ms", "KUBEWARDEN_REQUEST_TIMEOUT_MS",
         dict(type=float, default=DEFAULT_REQUEST_TIMEOUT_MS, metavar="MS",
              help="Propagated per-request deadline, aligned to the "
                   "admission webhook timeoutSeconds model (the API server "
                   "abandons a review after its timeout, so work past it is "
                   "waste). Requests whose estimated queue wait exceeds the "
                   "budget are shed at admission with 429 + Retry-After, "
                   "and rows already expired when their batch forms are "
                   "dropped before encode/dispatch. 0 disables deadline "
                   "propagation and load shedding")),
        ("--disable-timeout-protection", "KUBEWARDEN_DISABLE_TIMEOUT_PROTECTION",
         dict(action="store_true", help="Disable policy timeout protection")),
        ("--ignore-kubernetes-connection-failure",
         "KUBEWARDEN_IGNORE_KUBERNETES_CONNECTION_FAILURE",
         dict(action="store_true",
              help="Do not exit with an error if the Kubernetes connection fails; "
                   "context-aware policies will break")),
        ("--kube-insecure-skip-tls-verify",
         "KUBEWARDEN_KUBE_INSECURE_SKIP_TLS_VERIFY",
         dict(action="store_true",
              help="Skip TLS verification of the Kubernetes API server "
                   "(explicit opt-in; without it, a missing cluster CA falls "
                   "back to the system trust store)")),
        ("--always-accept-admission-reviews-on-namespace",
         "KUBEWARDEN_ALWAYS_ACCEPT_ADMISSION_REVIEWS_ON_NAMESPACE",
         dict(default=None, metavar="NAMESPACE",
              help="Always accept AdmissionReviews that target the given "
                   "namespace")),
        ("--continue-on-errors", "KUBEWARDEN_CONTINUE_ON_ERRORS",
         dict(action="store_true", help=argparse.SUPPRESS)),
        ("--enable-metrics", "KUBEWARDEN_ENABLE_METRICS",
         dict(action="store_true",
              help="Enable metrics (Prometheus text on the readiness "
                   "port's /metrics)")),
        ("--enable-pprof", "KUBEWARDEN_ENABLE_PPROF",
         dict(action="store_true", help="Enable profiling endpoints")),
        ("--log-level", "KUBEWARDEN_LOG_LEVEL",
         dict(default="info", metavar="LOG_LEVEL",
              choices=["trace", "debug", "info", "warn", "error"],
              help="Log level (trace, debug, info, warn, error)")),
        ("--log-fmt", "KUBEWARDEN_LOG_FMT",
         dict(default="text", metavar="LOG_FMT",
              choices=["text", "json", "otlp"],
              help="Log output format (text, json, otlp)")),
        ("--log-no-color", "KUBEWARDEN_LOG_NO_COLOR",
         dict(action="store_true", help="Disable colored output for logs")),
        ("--daemon", "KUBEWARDEN_DAEMON",
         dict(action="store_true",
              help="If set, runs policy-server in detached mode as a daemon")),
        ("--daemon-pid-file", "KUBEWARDEN_DAEMON_PID_FILE",
         dict(default="policy-server.pid", metavar="DAEMON-PID-FILE",
              help="Path to the PID file, used only when running in daemon mode")),
        ("--daemon-stdout-file", "KUBEWARDEN_DAEMON_STDOUT_FILE",
         dict(default=None, metavar="DAEMON-STDOUT-FILE",
              help="Path to the file holding stdout, used only in daemon mode")),
        ("--daemon-stderr-file", "KUBEWARDEN_DAEMON_STDERR_FILE",
         dict(default=None, metavar="DAEMON-STDERR-FILE",
              help="Path to the file holding stderr, used only in daemon mode")),
        ("--evaluation-backend", "KUBEWARDEN_EVALUATION_BACKEND",
         dict(default="jax", metavar="BACKEND", choices=["jax", "oracle"],
              help="Evaluation backend: 'jax' (batched predicate programs on "
                   "the device; in this package the CUDA kernels on the "
                   "card, or their plain PyTorch versions under --device "
                   "cpu) or 'oracle' (host interpreter, the "
                   "differential-test oracle)")),
        ("--max-batch-size", "KUBEWARDEN_MAX_BATCH_SIZE",
         dict(type=int, default=DEFAULT_MAX_BATCH_SIZE, metavar="N",
              help="Maximum micro-batch size dispatched to the device")),
        ("--batch-timeout-ms", "KUBEWARDEN_BATCH_TIMEOUT_MS",
         dict(type=float, default=DEFAULT_BATCH_TIMEOUT_MS, metavar="MS",
              help="Maximum time a request waits for its micro-batch to "
                   "fill")),
        ("--host-fastpath-threshold", "KUBEWARDEN_HOST_FASTPATH_THRESHOLD",
         dict(type=int, default=DEFAULT_HOST_FASTPATH_THRESHOLD, metavar="N",
              help="Micro-batches with at most N requests are answered by "
                   "the bit-exact host oracle instead of a device dispatch "
                   "(0 disables)")),
        ("--latency-budget-ms", "KUBEWARDEN_LATENCY_BUDGET_MS",
         dict(type=float, default=DEFAULT_LATENCY_BUDGET_MS, metavar="MS",
              help="Soft per-request latency target: a batch whose "
                   "measured device round trip would exceed the oldest "
                   "request's remaining budget is answered by the host "
                   "oracle (0 disables)")),
        ("--columnar", "KUBEWARDEN_COLUMNAR",
         dict(default="on", metavar="MODE", choices=["on", "off"],
              help="Columnar device transport (round 12): ship encoded "
                   "batches as bit-packed / dictionary-narrowed column "
                   "PLANES with all-zero columns elided (steady-state "
                   "traffic ships only delta columns; elided planes are "
                   "reconstructed from device-resident zero constants). "
                   "'off' restores the row-packed transport. Mesh-sharded "
                   "programs always use the packed transport")),
        ("--donate-buffers", "KUBEWARDEN_DONATE_BUFFERS",
         dict(default="on", metavar="MODE", choices=["on", "off"],
              help="Columnar dispatches hand their device planes back to "
                   "the allocator once the plane rebuild is enqueued, so "
                   "the next enqueue can reuse their blocks in stream "
                   "order (PyTorch has no donate_argnums; this is its "
                   "counterpart); 'off' keeps each dispatch's planes "
                   "until its fetch (diagnostic). Bodies are the same "
                   "under both")),
        ("--predicate-opt", "KUBEWARDEN_PREDICATE_OPT",
         dict(default="on", metavar="MODE", choices=["on", "off"],
              help="Predicate-program optimizer (round 15): before "
                   "lowering, run cross-policy common-subexpression "
                   "elimination (identical field-gather + comparison "
                   "subtrees compute once via a shared let-binding "
                   "table), constant folding (whole policies folding to "
                   "a constant verdict drop out of the device program), "
                   "and dead-field pruning (fields no surviving "
                   "predicate reads lose their gather columns; validity "
                   "masks provably redundant at the zero-fill lose "
                   "their mask lanes). Purely structural — bit-exact vs "
                   "the unoptimized program and the host oracle. 'off' "
                   "restores the naive per-policy lowering")),
        ("--kernel", "KUBEWARDEN_KERNEL",
         dict(default="pallas", metavar="KERNEL", choices=["xla", "pallas"],
              help="Device program form: 'pallas' (default) sends each "
                   "schema bucket's batches to the hand-written "
                   "policy_matrix CUDA kernel (the counterpart of the "
                   "JAX package's fused gather→predicate→reduce Pallas "
                   "kernel) once the bucket turns hot (8 dispatches, "
                   "warmup dispatches included, so the default warmup "
                   "arms every bucket); armed buckets ship the packed "
                   "transport form (the kernel fuses the unpack), and "
                   "cold buckets run the non-Pallas program. 'xla' "
                   "serves every batch with the non-Pallas program: the "
                   "compiled predicates as PyTorch ops on the card, over "
                   "the columnar delta planes (or the packed transport "
                   "form with --columnar off). The JAX package's default "
                   "is 'xla'; this package's is 'pallas', its main path")),
        ("--breaker-failure-threshold", "KUBEWARDEN_BREAKER_FAILURE_THRESHOLD",
         dict(type=int, default=5, metavar="N",
              help="Device faults or watchdog trips within the window that "
                   "trip the device circuit breaker open")),
        ("--breaker-window-seconds", "KUBEWARDEN_BREAKER_WINDOW_SECONDS",
         dict(type=float, default=30.0, metavar="SECONDS",
              help="Sliding window over which breaker failures "
                   "accumulate")),
        ("--breaker-cooldown-seconds", "KUBEWARDEN_BREAKER_COOLDOWN_SECONDS",
         dict(type=float, default=5.0, metavar="SECONDS",
              help="Time a tripped breaker stays open before a half-open "
                   "probe")),
        ("--degraded-mode", "KUBEWARDEN_DEGRADED_MODE",
         dict(default="oracle", metavar="MODE", choices=DEGRADED_MODES,
              help="What to serve while the breaker is open: 'oracle' "
                   "(bit-exact host verdicts), 'monitor' (accept-all) or "
                   "'reject' (in-band 503s)")),
        ("--verdict-cache-size", "KUBEWARDEN_VERDICT_CACHE_SIZE",
         dict(type=parse_size, default="256Mi", metavar="BYTES",
              help="Byte budget of the two-tier verdict cache (K/M/G[i] "
                   "suffixes), split between the pre-encode blob tier and "
                   "the post-encode row tier; 0 disables caching and "
                   "in-batch row dedup")),
        ("--flight-recorder", "KUBEWARDEN_FLIGHT_RECORDER",
         dict(default="on", metavar="MODE", choices=["on", "off"],
              help="Always-on flight recorder: a lock-free ring of "
                   "nanosecond-stamped phase events per batch, read as "
                   "Chrome trace JSON on GET /debug/timeline and as "
                   "per-phase histograms and tail exemplars on /metrics; "
                   "'off' disables the recorder and the timeline "
                   "endpoint")),
        ("--recorder-ring-events", "KUBEWARDEN_RECORDER_RING_EVENTS",
         dict(type=int, default=flightrec.DEFAULT_RING_EVENTS, metavar="N",
              help="Flight-recorder ring capacity in events (rounded up "
                   "to a power of two; older events are overwritten)")),
        ("--recorder-row-sample-rate", "KUBEWARDEN_RECORDER_ROW_SAMPLE_RATE",
         dict(type=float, default=flightrec.DEFAULT_ROW_SAMPLE_RATE,
              metavar="FRACTION",
              help="Fraction of delivered rows that record per-row "
                   "timeline segments (a deterministic 1-in-round"
                   "(1/FRACTION) stride; 0 disables row sampling)")),
        ("--frontend", "KUBEWARDEN_FRONTEND",
         dict(default="python", metavar="IMPL", choices=FRONTENDS,
              help="HTTP framing implementation for the evaluation POST "
                   "surface (/validate, /validate_raw, /audit): 'native' "
                   "serves it from the GIL-free C++ epoll front-end "
                   "(csrc/httpfront.cpp), which parses AdmissionReviews, "
                   "admits each burst to the batcher at once and "
                   "serializes verdicts natively; 'python' keeps the "
                   "standard-library server. With 'native' the API port "
                   "serves only the evaluation POSTs (/readiness, /metrics "
                   "and /debug/timeline stay on the readiness port, and "
                   "the pprof endpoints need 'python'); a native build, "
                   "load or bind that fails stops the server")),
        ("--native-idle-timeout-seconds",
         "KUBEWARDEN_NATIVE_IDLE_TIMEOUT_SECONDS",
         dict(type=float, default=DEFAULT_NATIVE_IDLE_TIMEOUT_SECONDS,
              metavar="SECONDS",
              help="Native frontend: close keep-alive connections idle "
                   "longer than this between requests (0 disables)")),
        ("--native-read-timeout-seconds",
         "KUBEWARDEN_NATIVE_READ_TIMEOUT_SECONDS",
         dict(type=float, default=DEFAULT_NATIVE_READ_TIMEOUT_SECONDS,
              metavar="SECONDS",
              help="Native frontend: a single request (header+body) must "
                   "arrive in full within this bound or the connection is "
                   "closed, the slowloris defense (0 disables)")),
        ("--native-max-connections", "KUBEWARDEN_NATIVE_MAX_CONNECTIONS",
         dict(type=int, default=0, metavar="N",
              help="Native frontend: cap on concurrent connections; "
                   "accepts over it answer an in-band 503 + Retry-After "
                   "and close (counted; 0 = uncapped)")),
        ("--cert-file", "KUBEWARDEN_CERT_FILE",
         dict(default=None, metavar="CERT_FILE",
              help="Path to an X.509 certificate file for HTTPS")),
        ("--key-file", "KUBEWARDEN_KEY_FILE",
         dict(default=None, metavar="KEY_FILE",
              help="Path to an X.509 private key file for HTTPS")),
        ("--client-ca-file", "KUBEWARDEN_CLIENT_CA_FILE",
         dict(default=None, metavar="CLIENT_CA_FILE", action="append",
              help="Path to a CA certificate file that issued the client "
                   "certificates; required to enable mTLS (repeatable)")),
        ("--native-tls", "KUBEWARDEN_NATIVE_TLS",
         dict(default="auto", metavar="MODE", choices=list(NATIVE_TLS_MODES),
              help="Native frontend TLS termination: 'auto' terminates "
                   "TLS on the C++ epoll loops when --cert/--key are set "
                   "— SIGHUP/digest hot-rotation atomically swaps the "
                   "SSL_CTX for NEW connections while established ones "
                   "drain on the old identity, and a failed reload keeps "
                   "last-good serving; a libssl that does not load stops "
                   "the server. 'off' terminates TLS on the standard-"
                   "library frontend even under --frontend native")),
        ("--native-tls-handshake-timeout-seconds",
         "KUBEWARDEN_NATIVE_TLS_HANDSHAKE_TIMEOUT_SECONDS",
         dict(type=float, default=DEFAULT_NATIVE_TLS_HANDSHAKE_TIMEOUT_SECONDS,
              metavar="SECONDS",
              help="Native TLS: the full handshake must COMPLETE within "
                   "this window measured from accept — byte drips never "
                   "refresh it, so a TLS-layer slowloris is reaped on "
                   "schedule (0 disables)")),
        ("--http-workers", "KUBEWARDEN_HTTP_WORKERS",
         dict(type=int, default=1, metavar="N",
              help="HTTP frontend processes sharing the API port via "
                   "SO_REUSEPORT, forwarding to the evaluation process "
                   "over a unix socket (1 = serve in-process); each worker "
                   "runs the --frontend this process runs, and none is "
                   "started with TLS")),
        ("--worker-respawn-giveup", "KUBEWARDEN_WORKER_RESPAWN_GIVEUP",
         dict(type=int, default=DEFAULT_WORKER_RESPAWN_GIVEUP, metavar="N",
              help="Prefork respawn breaker: a frontend worker slot that "
                   "crash-loops N consecutive times within the crash "
                   "window stops respawning (exponential backoff applies "
                   "before the cap); the remaining processes keep serving "
                   "and /readiness reports the degraded slot honestly")),
        ("--mesh", "KUBEWARDEN_MESH",
         dict(default="auto", metavar="MESH_SPEC",
              help="Device mesh spec, e.g. 'auto', 'data:8', 'data:4,policy:2'")),
        ("--mesh-dispatch", "KUBEWARDEN_MESH_DISPATCH",
         dict(default="fused", metavar="MODE", choices=list(MESH_DISPATCHES),
              help="How a >1 policy axis executes: 'fused' splits the "
                   "policy set round-robin over the policy axis, each mesh "
                   "position runs its policy shard (the policy_matrix "
                   "CUDA kernel's per-shard program, or the shard's "
                   "predicates) on its data shard's rows, and the verdict "
                   "blocks gather on the data shard's first CUDA device "
                   "for the group combine; 'threaded' builds one "
                   "environment per policy shard, each data-parallel over "
                   "its row of the mesh, and dispatches a batch's shards "
                   "from a thread pool (PolicyShardedEvaluator)")),
        ("--policy-reload-mode", "KUBEWARDEN_POLICY_RELOAD_MODE",
         dict(default="auto", metavar="MODE", choices=list(RELOAD_MODES),
              help="Zero-downtime policy hot reload (epoch-based, "
                   "lifecycle.py): 'auto' builds and warms a new policy set "
                   "in the background on SIGHUP / policies-file change / "
                   "POST /policies/reload, shadow-canaries it against the "
                   "host oracle, and promotes atomically only on a clean "
                   "canary (last-good keeps serving otherwise); 'manual' "
                   "stages the validated candidate for an explicit POST "
                   "/policies/promote; 'off' freezes the policy set at "
                   "boot")),
        ("--reload-canary-requests", "KUBEWARDEN_RELOAD_CANARY_REQUESTS",
         dict(type=int, default=DEFAULT_RELOAD_CANARY_REQUESTS, metavar="N",
              help="Shadow-canary replay budget: the candidate epoch "
                   "replays up to N recently served requests (a bounded "
                   "ring recorded at dispatch, plus one synthetic review "
                   "per candidate policy) and cross-checks every verdict "
                   "against the host oracle before promotion")),
        ("--reload-divergence-threshold",
         "KUBEWARDEN_RELOAD_DIVERGENCE_THRESHOLD",
         dict(type=float, default=0.0, metavar="FRACTION",
              help="Fraction of canary replays allowed to diverge from "
                   "the host oracle before the candidate policy set is "
                   "rejected (default 0.0: any divergence, trap, or "
                   "canary timeout keeps last-good serving and increments "
                   "the rollback counter)")),
        ("--reload-admin-token", "KUBEWARDEN_RELOAD_ADMIN_TOKEN",
         dict(default=None, metavar="TOKEN",
              help="Bearer token authenticating the policy-lifecycle "
                   "admin endpoints (POST /policies/reload, /policies/"
                   "promote, /policies/rollback on the readiness port); "
                   "unset disables them")),
        ("--state-dir", "KUBEWARDEN_STATE_DIR",
         dict(default=None, metavar="DIR",
              help="Durable last-good state directory (round 17, "
                   "statestore.py): a crash-consistent store (atomic "
                   "tmp+fsync+rename writes, CRC-framed generation-"
                   "numbered journals) holding (a) a content-addressed "
                   "policy artifact cache shared by boot and hot-reload "
                   "fetch, (b) per-tenant last-good epoch manifests "
                   "persisted on every promotion/rollback so the "
                   "rollback pin survives restarts, and (c) the audit "
                   "snapshot spill (resourceVersion cursors + "
                   "inventory) so the watch feed RESUMES instead of "
                   "re-LISTing the cluster. A warm boot whose policies "
                   "config matches the last-good manifest loads pinned "
                   "artifacts from the cache with ZERO network fetches; "
                   "a failed fetch degrades loudly to last-good instead "
                   "of fail-closing. Corrupt or torn entries are "
                   "quarantined by the boot fsck pass, never fatal. "
                   "Pair with --compilation-cache-dir inside it so "
                   "compiled programs survive too. Unset = amnesiac "
                   "restarts (every boot refetches and re-LISTs)")),
        ("--state-audit-spill-seconds", "KUBEWARDEN_STATE_AUDIT_SPILL_SECONDS",
         dict(type=float, default=30.0, metavar="SECONDS",
              help="Cadence of the audit snapshot spill into the state "
                   "dir (one atomic journal replace per tick; also "
                   "spilled on clean shutdown). Only with --state-dir "
                   "and --audit-watch")),
        ("--selfheal-interval-seconds", "KUBEWARDEN_SELFHEAL_INTERVAL_SECONDS",
         dict(type=float, default=DEFAULT_SELFHEAL_INTERVAL_SECONDS,
              metavar="SECONDS",
              help="Self-heal watchdog cadence (supervision.py): every "
                   "tick it verifies the batcher dispatch loop and the "
                   "native frontend's drainer thread are alive, and "
                   "REBUILDS a dead one instead of serving zombies "
                   "(counted on /metrics as "
                   "policy_server_selfheal_*_revives). 0 disables")),
        ("--tenants", "KUBEWARDEN_TENANTS",
         dict(default=None, metavar="TENANTS_FILE",
              help="Multi-tenant serving (tenancy.py): a manifest (JSON, or "
                   "YAML where PyYAML is installed) mapping tenant names to "
                   "their own policies files plus per-tenant knobs — weight "
                   "(weighted-fair dispatch share), quota-rows-per-second + "
                   "quota-burst (token-bucket admission; overflow answers "
                   "429 + Retry-After), max-inflight (admitted-unresolved "
                   "row cap), request-timeout-ms (per-tenant deadline "
                   "class), and degraded-mode (per-tenant breaker "
                   "fallback). Each named tenant owns an independent epoch "
                   "lifecycle (reload/canary/rollback/digest watch) over its "
                   "policies file and is served at POST "
                   "/validate/{tenant}/{policy_id} (plus the audit/raw "
                   "variants and GET /readiness/{tenant}); every "
                   "un-prefixed URL stays the reserved 'default' tenant, "
                   "configured by --policies as before. A top-level "
                   "'default:' entry applies quota/weight knobs to the "
                   "default tenant; 'max-concurrent-dispatches' caps the "
                   "shared weighted-fair dispatch scheduler. Unset = "
                   "single-tenant, bit-identical to the pre-tenancy "
                   "serving path")),
        ("--serving-shards", "KUBEWARDEN_SERVING_SHARDS",
         dict(type=int, default=1, metavar="M",
              help="Host-local serving shards (runtime/shards.py): M full "
                   "serving stacks — each with its own evaluation "
                   "environment (kernel programs, verdict cache + breaker) "
                   "and micro-batcher — behind a health + queue-depth-EWMA "
                   "router. A shard whose dispatch loop wedges or dies is "
                   "fenced within one heartbeat interval (queued rows "
                   "re-routed to a sibling or answered 503 with "
                   "Retry-After, never double-answered) and warm-revived in "
                   "place without touching its siblings; SIGTERM drains "
                   "shards in sequence. 1 bypasses the router entirely — "
                   "the serving path is byte-identical to a routerless "
                   "build")),
        ("--shard-heartbeat-seconds", "KUBEWARDEN_SHARD_HEARTBEAT_SECONDS",
         dict(type=float, default=DEFAULT_SHARD_HEARTBEAT_SECONDS,
              metavar="SECONDS",
              help="Shard router heartbeat cadence: each tick probes every "
                   "shard's dispatch loop, fences a wedged/dead shard "
                   "(draining its queued rows to the healthiest sibling), "
                   "and warm-revives it. Bounds the fencing latency after a "
                   "shard death. Ignored when --serving-shards is 1")),
        ("--audit-mode", "KUBEWARDEN_AUDIT_MODE",
         dict(default="off", metavar="MODE",
              choices=["off", "interval", "on-promote"],
              help="Background audit scanner (audit/scanner.py): "
                   "continuously re-scans a snapshot of cluster resources "
                   "(seeded from --audit-resources-file and from every "
                   "object served through /validate) through the live "
                   "policy epoch on the micro-batcher's best-effort lane "
                   "— live traffic strictly preempts audit work. "
                   "'interval' sweeps the dirty set on a cadence and "
                   "fully on every policy-epoch promotion; 'on-promote' "
                   "sweeps fully on epoch flips only; 'off' disables the "
                   "scanner and the GET /audit/reports endpoints")),
        ("--audit-interval-seconds", "KUBEWARDEN_AUDIT_INTERVAL_SECONDS",
         dict(type=float, default=30.0, metavar="SECONDS",
              help="Dirty-set sweep cadence for --audit-mode interval "
                   "(objects served through /validate since the last "
                   "sweep are re-judged)")),
        ("--audit-batch-size", "KUBEWARDEN_AUDIT_BATCH_SIZE",
         dict(type=int, default=256, metavar="N",
              help="Rows per best-effort audit-lane batch (audit rides "
                   "idle device slots in large batches; at most one "
                   "audit dispatch is ever in flight)")),
        ("--audit-max-snapshot-bytes", "KUBEWARDEN_AUDIT_MAX_SNAPSHOT_BYTES",
         dict(default="64Mi", metavar="BYTES",
              help="Byte budget of the audit snapshot store holding "
                   "cluster resources as pre-encoded admission rows "
                   "(accepts K/M/G[i] suffixes; least-recently-recorded "
                   "rows evict beyond it)")),
        ("--audit-resources-file", "KUBEWARDEN_AUDIT_RESOURCES_FILE",
         dict(default=None, metavar="RESOURCES_FILE",
              help="YAML/JSON file of Kubernetes objects (a list or a "
                   "List document) seeding the audit snapshot store at "
                   "boot — the stand-in for the companion audit "
                   "scanner's cluster LIST")),
        ("--audit-watch", "KUBEWARDEN_AUDIT_WATCH",
         dict(action="store_true",
              help="Feed the audit snapshot store from the Kubernetes "
                   "list+watch stream (audit/watch_feed.py): "
                   "ADDED/MODIFIED events supersede, DELETED evicts and "
                   "prunes report rows, and the scanner then audits the "
                   "LIVE cluster instead of only /validate traffic and "
                   "the seed file. Streams resume from the last "
                   "resourceVersion on clean close; faults and "
                   "queue overflows force a counted full re-LIST "
                   "resync. Requires --audit-mode interval|on-promote")),
        ("--audit-watch-resources", "KUBEWARDEN_AUDIT_WATCH_RESOURCES",
         dict(default=DEFAULT_AUDIT_WATCH_RESOURCES,
              metavar="KINDS",
              help="Comma-separated apiVersion/Kind list the audit "
                   "watch feed follows (e.g. 'v1/Pod,apps/v1/"
                   "Deployment')")),
        ("--audit-watch-max-queue-events",
         "KUBEWARDEN_AUDIT_WATCH_MAX_QUEUE_EVENTS",
         dict(type=int, default=DEFAULT_AUDIT_WATCH_MAX_QUEUE_EVENTS,
              metavar="N",
              help="Bound of the watch-event queue between the per-kind "
                   "watcher threads and the snapshot applier; an "
                   "overflow drops the event (counted loudly) and "
                   "forces a full re-LIST resync of that kind, so a "
                   "drop can delay freshness but never corrupt the "
                   "inventory")),
        ("--audit-matrix", "KUBEWARDEN_AUDIT_MATRIX",
         dict(action="store_true",
              help="Maintain the persistent (object × policy) verdict "
                   "matrix (audit/matrix.py): sweeps evaluate only the "
                   "dirty cross-product (dirty rows × all columns + "
                   "clean rows × dirty columns — a promotion changing 2 "
                   "of 32 policies re-judges 2 columns, not the "
                   "cluster), verdict changes stream on GET "
                   "/audit/stream with a monotonic matrixVersion "
                   "cursor, columns spill through --state-dir for warm "
                   "resume, and a /validate UPDATE byte-identical to a "
                   "judged row answers from the precomputed verdict. "
                   "Requires --audit-mode interval|on-promote")),
        ("--audit-stream-max-clients",
         "KUBEWARDEN_AUDIT_STREAM_MAX_CLIENTS",
         dict(type=int, default=64, metavar="N",
              help="Cap on concurrent GET /audit/stream clients; beyond "
                   "it new subscribers get an in-band 503 (each client "
                   "holds a bounded changelog queue — a slow consumer "
                   "overflows its own queue and is dropped with a "
                   "counted close, never blocking the applier)")),
        ("--audit-matrix-spill-seconds",
         "KUBEWARDEN_AUDIT_MATRIX_SPILL_SECONDS",
         dict(type=float, default=30.0, metavar="SECONDS",
              help="Verdict-matrix spill cadence: how often the scanner "
                   "spills the matrix columns (epoch-fingerprint-keyed) "
                   "to --state-dir so a warm restart resumes compliance "
                   "without re-judging clean rows")),
        ("--audit-matrix-whatif", "KUBEWARDEN_AUDIT_MATRIX_WHATIF",
         dict(action="store_true",
              help="During a reload's shadow canary, also evaluate the "
                   "CANDIDATE epoch's changed columns against the live "
                   "audit snapshot and surface the cluster-wide what-if "
                   "verdict diff on the reload status — canarying over "
                   "the whole cluster, not just the request ring. "
                   "Requires --audit-matrix")),
        ("--context-refresh-seconds", "KUBEWARDEN_CONTEXT_REFRESH_SECONDS",
         dict(type=float, default=DEFAULT_CONTEXT_REFRESH_SECONDS,
              metavar="SECONDS",
              help="Context-aware snapshot freshness: the re-LIST period in "
                   "poll mode; in watch mode (snapshots are event-fresh) "
                   "the error-backoff cap, with a full re-LIST resync every "
                   "10x this value (staleness contract: context/service.py)")),
        ("--context-no-watch", "KUBEWARDEN_CONTEXT_NO_WATCH",
         dict(action="store_true",
              help="Disable the Kubernetes watch stream for context-aware "
                   "snapshots and poll with periodic LISTs instead")),
        ("--no-warmup", "KUBEWARDEN_NO_WARMUP",
         dict(action="store_true",
              help="Skip the warmup of every batch bucket at boot and for "
                   "each reload candidate")),
        ("--compilation-cache-dir", "KUBEWARDEN_COMPILATION_CACHE_DIR",
         dict(default=None, metavar="DIR",
              help="Build directory of the native libraries (the CUDA "
                   "kernels, the native encoder, the native HTTP frontend "
                   "and the native wasm core): each is built there at "
                   "first use under a name that hashes its sources, "
                   "compiler flags and ABI, and reused from there by "
                   "every later boot, so compiled programs survive "
                   "restarts. A directory that cannot be written is "
                   "refused. Unset = build/torch_kernels/ beside the "
                   "package")),
        ("--distributed-coordinator", "KUBEWARDEN_DISTRIBUTED_COORDINATOR",
         dict(default=None, metavar="HOST:PORT",
              help="torch.distributed rendezvous address (gloo) for "
                   "multi-process serving; when set, bootstrap joins the "
                   "process group before building the device mesh, which "
                   "then spans every process's CUDA devices, each process "
                   "serving its own requests on its own data shards")),
        ("--distributed-num-processes", "KUBEWARDEN_DISTRIBUTED_NUM_PROCESSES",
         dict(type=int, default=None, metavar="N",
              help="Total number of policy-server processes in the "
                   "multi-host group (requires --distributed-coordinator)")),
        ("--distributed-process-id", "KUBEWARDEN_DISTRIBUTED_PROCESS_ID",
         dict(type=int, default=None, metavar="ID",
              help="This process's rank in the multi-host group "
                   "(requires --distributed-coordinator)")),
        ("--device", None,
         dict(default=None,
              help="torch device (default: the CUDA card; 'cpu' runs the "
                   "plain PyTorch versions of the kernels)")),
    ]


def long_version() -> str:
    """``--long-version`` banner: the version, the predicate-IR op registry
    and the OPA builtins the wasm host implements."""
    from policy_server_tpu_torch.ops.ir import registered_op_names
    from policy_server_tpu_torch.wasm.builtins import get_builtins

    ops = "\n".join(f"  - {name}" for name in registered_op_names())
    builtins = "\n".join(f"  - {name}" for name in sorted(get_builtins()))
    return (
        f"{PROG} {__version__}\npredicate IR ops:\n{ops}\n\n"
        f"Open Policy Agent/Gatekeeper implemented builtins:\n{builtins}"
    )


def build_cli() -> argparse.ArgumentParser:
    """The parser; a flag's environment variable, when set, replaces its
    default."""
    parser = argparse.ArgumentParser(prog=PROG)
    parser.add_argument(
        "--version", action="version", version=f"{PROG} {__version__}"
    )
    parser.add_argument(
        "--long-version",
        action="store_true",
        help="Print version information and the predicate-IR op registry",
    )
    for flag, env, kwargs in _flag_specs():
        kwargs = dict(kwargs)
        if env is not None:
            value = os.environ.get(env)
            if kwargs.get("action") == "store_true":
                kwargs["default"] = (value or "").lower() in (
                    "1", "true", "yes", "on"
                )
            elif kwargs.get("action") == "append":
                if value is not None:
                    kwargs["default"] = value.split(",")
            elif value is not None:
                kwargs["default"] = kwargs.get("type", str)(value)
            if kwargs.get("help") is not argparse.SUPPRESS:
                kwargs["help"] += f" [env: {env}]"
        parser.add_argument(flag, **kwargs)
    sub = parser.add_subparsers(dest="subcommand")
    docs = sub.add_parser(
        "docs", help="Generates the markdown documentation for the CLI"
    )
    docs.add_argument(
        "--output", "-o", required=True, metavar="FILE",
        help="path where to save the docs file",
    )
    return parser


def generate_docs() -> str:
    """The markdown CLI reference of the ``docs`` subcommand, in the JAX
    package's format (reference cli-docs.md, main.rs:68)."""
    lines = [
        f"# Command-Line Help for `{PROG}`",
        "",
        f"This document contains the help content for the `{PROG}` "
        "command-line program.",
        "",
        f"## `{PROG}`",
        "",
        f"**Usage:** `{PROG} [OPTIONS] [COMMAND]`",
        "",
        "###### **Subcommands:**",
        "",
        "* `docs` — Generates the markdown documentation for the CLI",
        "",
        "###### **Options:**",
        "",
    ]
    for flag, env, kwargs in _flag_specs():
        help_text = kwargs.get("help")
        if help_text is argparse.SUPPRESS:
            continue
        metavar = kwargs.get("metavar")
        action = kwargs.get("action")
        head = flag if action in ("store_true",) else f"{flag} <{metavar}>"
        lines.append(f"* `{head}` — {help_text}")
        if env:
            lines.append(f"  [env: `{env}`]")
        default = kwargs.get("default")
        if default not in (None, False, []):
            lines.append("")
            lines.append(f"  Default value: `{default}`")
        choices = kwargs.get("choices")
        if choices:
            lines.append("")
            lines.append(
                "  Possible values: " + ", ".join(f"`{c}`" for c in choices)
            )
        lines.append("")
    return "\n".join(lines)


def validate_args(args: argparse.Namespace) -> None:
    """The JAX package's checks (``Config.validate``) of this package's
    flags; raises ValueError with its text."""
    tls_config_of(args).validate()
    MeshSpec.parse(args.mesh)
    if args.workers is not None and args.workers < 1:
        raise ValueError("--workers must be >= 1")
    if args.max_batch_size < 1:
        raise ValueError("--max-batch-size must be >= 1")
    if not (0 <= args.port <= 65535) or not (
        0 <= args.readiness_probe_port <= 65535
    ):
        raise ValueError("ports must be in [0, 65535]")
    if args.http_workers < 1:
        raise ValueError("--http-workers must be >= 1")
    if args.breaker_failure_threshold < 1:
        raise ValueError("--breaker-failure-threshold must be >= 1")
    if args.breaker_window_seconds <= 0:
        raise ValueError("--breaker-window-seconds must be > 0")
    if args.breaker_cooldown_seconds < 0:
        raise ValueError("--breaker-cooldown-seconds must be >= 0")
    if args.reload_canary_requests < 0:
        raise ValueError("--reload-canary-requests must be >= 0")
    if args.selfheal_interval_seconds < 0:
        raise ValueError("--selfheal-interval-seconds must be >= 0")
    if args.worker_respawn_giveup < 1:
        raise ValueError("--worker-respawn-giveup must be >= 1")
    if args.native_idle_timeout_seconds < 0:
        raise ValueError("--native-idle-timeout-seconds must be >= 0")
    if args.native_read_timeout_seconds < 0:
        raise ValueError("--native-read-timeout-seconds must be >= 0")
    if args.native_max_connections < 0:
        raise ValueError("--native-max-connections must be >= 0")
    if args.native_tls not in NATIVE_TLS_MODES:
        raise ValueError(
            f"invalid native TLS mode {args.native_tls!r} "
            "(expected auto or off)"
        )
    if args.native_tls_handshake_timeout_seconds < 0:
        raise ValueError(
            "--native-tls-handshake-timeout-seconds must be >= 0"
        )
    if not (0.0 <= args.reload_divergence_threshold <= 1.0):
        raise ValueError("--reload-divergence-threshold must be in [0, 1]")
    if args.serving_shards < 1:
        raise ValueError("--serving-shards must be >= 1")
    if args.shard_heartbeat_seconds <= 0:
        raise ValueError("--shard-heartbeat-seconds must be > 0")
    if args.audit_interval_seconds <= 0:
        raise ValueError("--audit-interval-seconds must be > 0")
    if args.audit_batch_size < 1:
        raise ValueError("--audit-batch-size must be >= 1")
    if parse_size(args.audit_max_snapshot_bytes) < 0:
        raise ValueError("--audit-max-snapshot-bytes must be >= 0")
    if args.context_refresh_seconds <= 0:
        raise ValueError("--context-refresh-seconds must be > 0")
    if args.audit_watch:
        if args.audit_mode == "off":
            raise ValueError(
                "--audit-watch requires the audit scanner "
                "(--audit-mode interval or on-promote)"
            )
        if not parse_watch_resources(args.audit_watch_resources):
            raise ValueError(
                "--audit-watch-resources must name at least one "
                "apiVersion/Kind"
            )
    if args.audit_watch_max_queue_events < 1:
        raise ValueError("--audit-watch-max-queue-events must be >= 1")
    if args.audit_matrix and args.audit_mode == "off":
        raise ValueError(
            "--audit-matrix requires the audit scanner "
            "(--audit-mode interval or on-promote)"
        )
    if args.audit_stream_max_clients < 1:
        raise ValueError("--audit-stream-max-clients must be >= 1")
    if args.audit_matrix_spill_seconds <= 0:
        raise ValueError("--audit-matrix-spill-seconds must be > 0")
    if args.audit_matrix_whatif and not args.audit_matrix:
        raise ValueError("--audit-matrix-whatif requires --audit-matrix")
    if args.state_audit_spill_seconds <= 0:
        raise ValueError("--state-audit-spill-seconds must be > 0")
    if args.mesh_dispatch not in MESH_DISPATCHES:
        raise ValueError(
            f"invalid mesh dispatch {args.mesh_dispatch!r} "
            "(expected 'fused' or 'threaded')"
        )
    if args.distributed_coordinator is None:
        if (
            args.distributed_num_processes is not None
            or args.distributed_process_id is not None
        ):
            raise ValueError(
                "--distributed-num-processes/--distributed-process-id "
                "require --distributed-coordinator"
            )
    else:
        if (args.distributed_num_processes is None) != (
            args.distributed_process_id is None
        ):
            raise ValueError(
                "--distributed-num-processes and --distributed-process-id "
                "must be set together"
            )
        if (
            args.distributed_num_processes is not None
            and not (
                0 <= args.distributed_process_id < args.distributed_num_processes
            )
        ):
            raise ValueError(
                "--distributed-process-id must be in "
                "[0, --distributed-num-processes)"
            )


def tls_config_of(args: argparse.Namespace) -> TlsConfig:
    return TlsConfig(
        cert_file=args.cert_file,
        key_file=args.key_file,
        client_ca_file=tuple(args.client_ca_file or ()),
    )


def server_from_args(args: argparse.Namespace) -> PolicyServer:
    validate_args(args)
    policies, text = read_policies_source(args.policies)
    return PolicyServer(
        policies,
        host=args.addr,
        port=args.port,
        readiness_probe_port=args.readiness_probe_port,
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
        policy_timeout=(
            None if args.disable_timeout_protection else args.policy_timeout
        ),
        breaker_failure_threshold=args.breaker_failure_threshold,
        breaker_window_seconds=args.breaker_window_seconds,
        breaker_cooldown_seconds=args.breaker_cooldown_seconds,
        degraded_mode=args.degraded_mode,
        enable_metrics=args.enable_metrics,
        enable_pprof=args.enable_pprof,
        flight_recorder=args.flight_recorder == "on",
        recorder_ring_events=args.recorder_ring_events,
        recorder_row_sample_rate=args.recorder_row_sample_rate,
        frontend=args.frontend,
        native_idle_timeout_seconds=args.native_idle_timeout_seconds,
        native_read_timeout_seconds=args.native_read_timeout_seconds,
        native_max_connections=args.native_max_connections,
        workers=args.workers,
        warmup=not args.no_warmup,
        policy_reload_mode=args.policy_reload_mode,
        reload_canary_requests=args.reload_canary_requests,
        reload_divergence_threshold=args.reload_divergence_threshold,
        reload_admin_token=args.reload_admin_token,
        selfheal_interval_seconds=args.selfheal_interval_seconds,
        policies_path=args.policies,
        policies_text=text,
        request_timeout_ms=args.request_timeout_ms,
        tenants=read_tenants_file(args.tenants) if args.tenants else None,
        serving_shards=args.serving_shards,
        shard_heartbeat_seconds=args.shard_heartbeat_seconds,
        audit_mode=args.audit_mode,
        audit_interval_seconds=args.audit_interval_seconds,
        audit_batch_size=args.audit_batch_size,
        audit_max_snapshot_bytes=parse_size(args.audit_max_snapshot_bytes),
        audit_resources_file=args.audit_resources_file,
        audit_matrix=args.audit_matrix,
        audit_stream_max_clients=args.audit_stream_max_clients,
        audit_matrix_whatif=args.audit_matrix_whatif,
        audit_matrix_spill_seconds=args.audit_matrix_spill_seconds,
        tls_config=tls_config_of(args),
        native_tls=args.native_tls,
        native_tls_handshake_timeout_seconds=(
            args.native_tls_handshake_timeout_seconds
        ),
        http_workers=args.http_workers,
        worker_respawn_giveup=args.worker_respawn_giveup,
        log_level=args.log_level,
        log_fmt=args.log_fmt,
        backend="torch" if args.evaluation_backend == "jax" else "oracle",
        predicate_opt=args.predicate_opt == "on",
        kernel=args.kernel,
        columnar=args.columnar == "on",
        donate_buffers=args.donate_buffers == "on",
        compilation_cache_dir=args.compilation_cache_dir,
        sources=read_sources_file(args.sources_path) if args.sources_path else None,
        verification_config=(
            read_verification_file(args.verification_path)
            if args.verification_path else None
        ),
        docker_config_json_path=args.docker_config_json_path,
        policies_download_dir=args.policies_download_dir,
        sigstore_cache_dir=args.sigstore_cache_dir,
        context_refresh_seconds=args.context_refresh_seconds,
        context_watch=not args.context_no_watch,
        kube_insecure_skip_tls_verify=args.kube_insecure_skip_tls_verify,
        ignore_kubernetes_connection_failure=(
            args.ignore_kubernetes_connection_failure
        ),
        audit_watch=args.audit_watch,
        audit_watch_resources=args.audit_watch_resources,
        audit_watch_max_queue_events=args.audit_watch_max_queue_events,
        state_dir=args.state_dir,
        state_audit_spill_seconds=args.state_audit_spill_seconds,
        mesh=MeshSpec.parse(args.mesh),
        mesh_dispatch=args.mesh_dispatch,
        distributed_coordinator=args.distributed_coordinator,
        distributed_num_processes=args.distributed_num_processes,
        distributed_process_id=args.distributed_process_id,
    )


def daemonize(argv: list[str], args: argparse.Namespace) -> int:
    """``--daemon``: run the server detached in a new session (setsid, as
    the reference's daemonize crate, main.rs:35-55), its stdout and
    stderr in the given files (else /dev/null), and write its pid file.
    The detached process is a fresh interpreter started without
    ``--daemon``: forking this one, whose torch import already runs
    threads, can deadlock the child."""
    child_argv = [a for a in argv if a != "--daemon"]
    env = dict(os.environ, KUBEWARDEN_DAEMON="")
    with open(args.daemon_stdout_file or os.devnull, "ab") as out, open(
        args.daemon_stderr_file or os.devnull, "ab"
    ) as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "policy_server_tpu_torch", *child_argv],
            stdin=subprocess.DEVNULL, stdout=out, stderr=err, env=env,
            start_new_session=True,
        )
    with open(args.daemon_pid_file, "w", encoding="utf-8") as f:
        f.write(str(proc.pid))
    return 0


def install_reload_signal(server: PolicyServer) -> None:
    """SIGHUP → ``server.reload_signal()`` (from the main thread only, where
    the platform has the signal)."""
    sighup = getattr(signal, "SIGHUP", None)
    if sighup is None or threading.current_thread() is not threading.main_thread():
        return
    signal.signal(sighup, lambda _signum, _frame: server.reload_signal())


def main(argv: list[str] | None = None) -> int:
    args = build_cli().parse_args(argv)
    if args.long_version:
        print(long_version())
        return 0
    if args.subcommand == "docs":
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(generate_docs())
        return 0
    if args.daemon:
        return daemonize(sys.argv[1:] if argv is None else list(argv), args)
    log = setup_tracing(args.log_level, args.log_fmt, args.log_no_color)
    server = server_from_args(args)
    install_reload_signal(server)
    log.info(
        "serving on %s:%d, readiness on %d (%s, %s frontend)",
        args.addr, server.port, server.readiness_port, server.env.device,
        server.frontend,
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
