"""PolicyServer — the environment, the micro-batcher and the two HTTP
ports.

``PolicyServer(policies, device=...)`` installs the flight recorder (so the
warmup records), builds the evaluation environment (on the card unless the
caller asks for the CPU) with its verdict cache and device circuit
breaker, starts the batcher (warming every batch bucket and seeding its
device round-trip estimate), attaches the runtime-stats provider to the
process metrics registry, and binds the API on ``host:port`` and then the
readiness port (``/readiness``, ``/metrics``, ``/debug/timeline``) on
``host:readiness_probe_port`` (0 binds any free port; ``readiness_port``
says which). Each port is a ``ThreadingHTTPServer``: each connection's
thread parses its request and waits on the batcher's future, so
concurrent requests form micro-batches.

The server runs the JAX package's default lifecycle: with
``policy_reload_mode`` other than ``off`` (``auto`` by default) the boot
environment and batcher are the policy lifecycle's first epoch
(``lifecycle.py``; /readiness answers 503 until it is installed), every
batcher feeds one shadow-canary ring, the policies file (``policies_path``)
is watched for a changed digest, SIGHUP (``reload_signal``) and ``POST
/policies/reload`` start a reload, and ``/policies/promote`` and
``/policies/rollback`` answer on the readiness port behind
``--reload-admin-token``. Every batcher comes from one builder
(``make_batcher``): its queue holds ``workers`` × ``max_batch_size`` rows.
With ``selfheal_interval_seconds`` above 0 (5 by default) a watchdog
(``supervision.py``) revives a dead dispatch loop or native drainer.
``request_timeout_ms`` (10,000 by default, as the JAX package's
``--request-timeout-ms``) gives every row a propagated deadline: the
batcher sheds at admission (429 and Retry-After) and drops rows that
expired in its queue (504).

``tenants`` (a ``tenancy.TenantManifest``, ``--tenants``) adds named
tenants beside the default one: each gets its own environments, batcher
(its quota, deadline and degraded mode from its manifest entry) and
lifecycle over its own policies file, all sharing one weighted-fair
dispatch scheduler (``state.tenants`` is the ``TenantManager``).
``serving_shards`` above 1 serves every tenant from that many stacks behind
a ``runtime/shards.ShardRouter`` whose heartbeat (``shard_heartbeat_seconds``)
fences a dead shard and revives it; at 1 the plain batcher serves, with no
router on the path. Every epoch, reload candidate and rollback of every
tenant builds its serving plane through one ``build_batcher``.

``audit_mode`` ``interval`` or ``on-promote`` (``--audit-mode``; ``off`` by
default, as the JAX package's) adds the background audit scanner
(``audit/``): a snapshot store of the cluster's resources, seeded from
``audit_resources_file`` and fed by every default-tenant batcher, swept by
an ``AuditScanner`` on the batchers' best-effort audit lane (started by
``start()``), with the lifecycle's epoch hooks; ``audit_matrix`` adds the
verdict matrix (built before the batchers, which consult it for lookup
admission; ``GET /audit/stream``), and ``audit_matrix_whatif`` the
lifecycle's cluster what-if. Named tenants feed neither. Every audit,
matrix and watch family is on /metrics at every setting, with zeros for
what is off.

Module acquisition follows the JAX package's bootstrap: the offline
sigstore trust root is loaded once from ``sigstore_cache_dir`` (a
malformed one warns and disables keyless verification), and when a
policy's module is not a builtin, or ``sources`` or
``verification_config`` is given, ``fetch.make_module_resolver`` fetches
``file://``, ``https://`` and ``registry://`` modules into
``policies_download_dir`` and verifies them. That resolver (or the
caller's ``module_resolver``) serves every environment the server builds,
reloads included; without either only builtins resolve. Wasm guests get
the trust root, a registry client for ``oci/v1/manifest_digest``
(``Downloader.manifest_digest``) and ``policy_timeout`` as their
wall-clock budget.

When a policy declares ``contextAwareResources`` the server starts a
``context.ContextSnapshotService`` over the in-cluster Kubernetes API
(list+watch, or polling with ``context_watch=False``), and every
environment injects each policy's allowed slice of its snapshot; a
connection failure fails the boot unless
``ignore_kubernetes_connection_failure``, which serves an empty cluster.
``audit_watch`` feeds the audit snapshot store from the same API
(``audit.WatchFeed`` over ``audit_watch_resources``).

``state_dir`` (``--state-dir``) opens the durable last-good store
(``statestore.py``) before any fetch: the fsck pass quarantines torn
state, and the last-good manifest of each tenant whose policies file is
byte-identical to it pins the artifact digests, which the resolver then
loads from the store's cache with no network; a changed file prefers the
live fetch and degrades loudly to the cache, and a named tenant whose file
cannot be read boots on its manifest. Every boot, promotion and rollback
persists its manifest; shard fences and respawns are journaled; the boot
report (warm or cold, time to ready, cache hits, degraded sources,
quarantined files) goes to ``last_boot.json`` and /metrics. With the audit
scanner on, the boot keeps the JAX package's order: the audit spill's rows
are restored into the snapshot, then the seed file is read, then the
verdict matrix gets its columns and restores the spilled cells that its
column fingerprints and the restored rows' payloads still validate (where
any were, the boot's full sweep becomes a dirty sweep), and last the watch
feed starts from the spilled resourceVersion cursors, so a kind with a
cursor is not re-LISTed. The feed spills the snapshot every
``state_audit_spill_seconds``; the scanner spills the matrix every
``audit_matrix_spill_seconds`` at a sweep's tail and once at its stop.

``stop()`` follows the JAX package's order: the watchdog, then the native
frontend stops accepting, the worker supervisor stops, the workers are
terminated (killed after 5 s), the bridge closes and its socket and
directory go, the audit streams end, then the audit watch feed, the
audit scanner,
then the named tenants' epochs, then every epoch of the default tenant:
each batcher answers what it holds (503 for rows not yet in a batch) and
its environments close, then the native TLS manager stops and the native
frontend flushes and frees, the certificate watcher ends and, last, the
context snapshot service (the environments read it until they close),
and the OTLP pipeline is flushed and torn down (``telemetry/otlp.py``).

``enable_metrics`` with ``OTEL_EXPORTER_OTLP_ENDPOINT`` set also pushes the
registry over OTLP every 10 s; ``--log-fmt otlp`` (``setup_tracing``)
exports the request spans, and the batcher's ``policy_evaluation`` child
spans, parented to a request's ``traceparent`` on either frontend. Prefork
workers log JSON lines: the spans stay in this process.

``tls_config`` (``--cert-file``, ``--key-file``, ``--client-ca-file``)
serves the API port over HTTPS, with mTLS when client CAs are given
(``certs.py``): the identity reloads when both files change on disk or on
SIGHUP, and the last good one keeps serving when a reload fails. The
standard-library frontend wraps each accepted connection and shakes hands
on the connection's own thread (a silent client never stalls the accept
loop); ``--frontend native`` terminates TLS on its C++ loops
(``NativeTlsManager``), and a libssl that does not load there raises at
start: there is no fallback to another frontend. ``native_tls="off"``
chooses the standard-library terminator under ``--frontend native``, as
the JAX package's help text says. The readiness port stays plaintext.

``http_workers`` above 1 (``--http-workers``) adds that many minus one
worker processes (``runtime/frontend.py``) on the API port, which then
carries ``SO_REUSEPORT``: they frame and parse requests and forward them
over the evaluation bridge, a unix socket in a private 0700 directory. A
supervisor thread respawns a dead worker every 2 s, backs a crash-looping
slot off exponentially and gives it up after ``worker_respawn_giveup``
fast deaths (counted on /metrics and named by /readiness). With TLS the
workers are not started (they would each need the identity): the server
serves in-process, with the JAX package's warning.

``frontend="native"`` (``--frontend native``) serves the API port's
evaluation POSTs (``/validate``, ``/validate_raw``, ``/audit``) from the
C++ epoll frontend instead (``runtime/native_frontend.py``): it frames and
canonicalizes requests without the GIL, admits each poll burst to the
batcher in one ``submit_many`` and serializes verdicts natively. Its
library and listen socket are made before the collection at start; a
failed build, load or bind raises. ``/readiness``, ``/metrics`` and
``/debug/timeline`` stay on the readiness port; the pprof endpoints need
the standard-library frontend.
"""

from __future__ import annotations

import contextlib
import gc
import json
import logging
import os
import shutil
import socket
import ssl
import subprocess
import sys
import tempfile
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Any, Callable, Iterator, Mapping

from policy_server_tpu_torch import failpoints
from policy_server_tpu_torch.api import profiling
from policy_server_tpu_torch.audit import (
    AUDIT_MODES,
    AuditScanner,
    PolicyReportStore,
    SnapshotStore,
    VerdictMatrix,
    WatchFeed,
    parse_watch_resources,
)
from policy_server_tpu_torch.api.handlers import ApiHandler, ReadinessHandler
from policy_server_tpu_torch.api.state import ApiServerState
from policy_server_tpu_torch.certs import (
    TlsConfig,
    create_tls_config_and_watch_certificate_changes,
)
from policy_server_tpu_torch.config.sources import Sources
from policy_server_tpu_torch.config.verification import VerificationConfig
from policy_server_tpu_torch.evaluation.environment import (
    DEFAULT_KERNEL,
    DEFAULT_VERDICT_CACHE_SIZE,
    EvaluationEnvironmentBuilder,
    resolve_device,
)
from policy_server_tpu_torch.fetch import (
    Downloader,
    FetchConfig,
    load_trust_root,
    make_module_resolver,
)
from policy_server_tpu_torch.fetch.downloader import retry_stats
from policy_server_tpu_torch.lifecycle import PolicyLifecycleManager, ShadowRecorder
from policy_server_tpu_torch.models.policy import parse_policies
from policy_server_tpu_torch.ops import buildcache
from policy_server_tpu_torch.parallel import mesh as mesh_mod
from policy_server_tpu_torch.parallel.policy_sharded import PolicyShardedEvaluator
from policy_server_tpu_torch.policies import resolve_builtin
from policy_server_tpu_torch.runtime import native_frontend as nf
from policy_server_tpu_torch.runtime.frontend import EvaluationBridge
from policy_server_tpu_torch.supervision import SelfHealWatchdog, SupervisorStats
from policy_server_tpu_torch.runtime.batcher import (
    DEFAULT_BATCH_TIMEOUT_MS,
    DEFAULT_HOST_FASTPATH_THRESHOLD,
    DEFAULT_LATENCY_BUDGET_MS,
    DEFAULT_MAX_BATCH_SIZE,
    DEFAULT_POLICY_TIMEOUT,
    MicroBatcher,
)
from policy_server_tpu_torch.runtime.scheduler import FairDispatchScheduler
from policy_server_tpu_torch.runtime.shards import build_serving_shards
from policy_server_tpu_torch.statestore import StateStore, compute_fingerprint
from policy_server_tpu_torch.tenancy import (
    DEFAULT_TENANT,
    Tenant,
    TenantAdmission,
    TenantManager,
    TenantManifest,
    TenantSpec,
    TenantState,
)
from policy_server_tpu_torch.telemetry import (
    default_registry,
    flightrec,
    metrics as names,
    otlp,
    setup_metrics,
)

DEFAULT_READINESS_PROBE_PORT = 8081
FRONTENDS = ("python", "native")
RELOAD_MODES = ("off", "auto", "manual")
DEFAULT_RELOAD_CANARY_REQUESTS = 64
DEFAULT_SELFHEAL_INTERVAL_SECONDS = 5.0
DEFAULT_REQUEST_TIMEOUT_MS = 10000.0
DEFAULT_SHARD_HEARTBEAT_SECONDS = 0.5
DEFAULT_NATIVE_IDLE_TIMEOUT_SECONDS = nf.NativeFrontend.IDLE_TIMEOUT_MS / 1000
DEFAULT_NATIVE_READ_TIMEOUT_SECONDS = nf.NativeFrontend.READ_TIMEOUT_MS / 1000
DEFAULT_AUDIT_INTERVAL_SECONDS = 30.0
DEFAULT_AUDIT_BATCH_SIZE = 256
DEFAULT_AUDIT_MAX_SNAPSHOT_BYTES = 64 * 1024 * 1024
DEFAULT_AUDIT_STREAM_MAX_CLIENTS = 64
DEFAULT_AUDIT_WATCH_RESOURCES = (
    "v1/Pod,v1/Namespace,apps/v1/Deployment,apps/v1/ReplicaSet,"
    "apps/v1/StatefulSet,apps/v1/DaemonSet"
)
DEFAULT_AUDIT_WATCH_MAX_QUEUE_EVENTS = 65536
DEFAULT_CONTEXT_REFRESH_SECONDS = 30.0
NATIVE_TLS_MODES = ("auto", "off")
MESH_DISPATCHES = ("fused", "threaded")
DEFAULT_NATIVE_TLS_HANDSHAKE_TIMEOUT_SECONDS = (
    nf.NativeTlsManager.HANDSHAKE_TIMEOUT_MS / 1000
)
DEFAULT_WORKER_RESPAWN_GIVEUP = 5
# the standard-library terminator's handshake deadline: asyncio's default
# ``ssl_handshake_timeout``, which the JAX package's aiohttp terminator uses
STDLIB_TLS_HANDSHAKE_TIMEOUT_SECONDS = 60.0

logger = logging.getLogger("kubewarden-policy-server")


class _HttpServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # admission webhooks arrive in bursts from many API-server
    # connections; the default listen backlog of 5 would drop SYNs
    request_queue_size = 1024

    def __init__(
        self, addr: tuple[str, int], handler: type, state: ApiServerState,
        tls_context: ssl.SSLContext | None = None, reuse_port: bool = False,
    ) -> None:
        self.state = state
        # set by PolicyServer.stop(): long-lived handlers (the audit
        # stream) end within their poll interval
        self.closing = threading.Event()
        self.tls_context = tls_context
        # SO_REUSEPORT only where prefork workers share the port
        self.allow_reuse_port = reuse_port
        super().__init__(addr, handler)

    def get_request(self):
        sock, addr = super().get_request()
        if self.tls_context is not None:
            # the accept thread only wraps: the handshake happens on the
            # connection's own thread (finish_request), so one silent
            # client cannot stall every accept
            sock = self.tls_context.wrap_socket(
                sock, server_side=True, do_handshake_on_connect=False
            )
        return sock, addr

    def finish_request(self, request, client_address) -> None:
        if self.tls_context is not None:
            try:
                request.settimeout(STDLIB_TLS_HANDSHAKE_TIMEOUT_SECONDS)
                request.do_handshake()
                request.settimeout(None)
            except OSError as e:  # ssl.SSLError and timeouts included
                logger.debug("TLS handshake failed: %s", e)
                return  # shutdown_request closes the socket
        super().finish_request(request, client_address)


def _admission_of(spec: TenantSpec) -> TenantAdmission | None:
    """A tenant's quota, or None when its entry sets none."""
    if spec.quota_rows_per_second > 0 or spec.max_inflight > 0:
        return TenantAdmission(
            spec.name,
            rows_per_second=spec.quota_rows_per_second,
            burst=spec.quota_burst,
            max_inflight=spec.max_inflight,
        )
    return None


def default_workers() -> int:
    """``--workers``' default: the number of CPUs."""
    return os.cpu_count() or 1


def read_policies_source(path: str) -> tuple[dict, str]:
    """A policies file → (the parsed mapping, the exact text parsed)."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    return parse_policies_text(text), text


def parse_policies_text(text: str) -> dict:
    """A policies file's text → the parsed mapping. YAML where PyYAML is
    installed; JSON needs nothing."""
    try:
        import yaml
    except ImportError:
        return parse_policies(json.loads(text))
    return parse_policies(yaml.safe_load(text))


def _read_text(path: str | None) -> str | None:
    if not path:
        return None
    try:
        with open(path, encoding="utf-8") as f:
            return f.read()
    except OSError:
        return None  # an unreadable file pins nothing


def _open_statestore(
    state_dir: str | None, policies: Mapping[str, Any],
    policies_path: str | None, policies_text: str | None,
    tenants: TenantManifest | None, backend: str, predicate_opt: bool,
    kernel: str, columnar: bool,
) -> tuple[Any, str | None, dict, dict[str, str]]:
    """(store, fingerprint, boot report, artifact pins) of a boot: all
    empty without ``state_dir``. The fingerprint's parts are the JAX
    package's, ``--kernel`` and ``--columnar`` among them, with the
    runtime's versions (torch, CUDA) in place of jax's: a JAX package's
    manifest is found, but its fingerprint does not match, and neither
    does one written under another ``--kernel``."""
    boot_report: dict = {"warm": False}
    if not state_dir:
        return None, None, boot_report, {}
    import torch

    store = StateStore(state_dir)
    fingerprint = compute_fingerprint({
        "policy_ids": sorted(policies),
        "backend": "jax" if backend == "torch" else backend,
        "predicate_opt": bool(predicate_opt),
        "kernel": kernel,
        "columnar": bool(columnar),
        "torch": str(torch.__version__),
        "cuda": str(torch.version.cuda),
    })
    manifest = store.last_good_manifest(DEFAULT_TENANT)
    boot_report.update(
        manifest_epoch=manifest.get("epoch") if manifest is not None else None,
        manifest_found=manifest is not None,
        fingerprint_match=(
            manifest is not None and manifest.get("fingerprint") == fingerprint
        ),
    )
    if policies_text is None:
        policies_text = _read_text(policies_path)
    pinned = store.pinned_digests(DEFAULT_TENANT, policies_text)
    if tenants is not None:
        for name, spec in tenants.tenants.items():
            pinned.update(
                store.pinned_digests(name, _read_text(spec.policies_path))
            )
    return store, fingerprint, boot_report, pinned


def _finish_boot_report(
    boot_report: dict, store: Any, boot_t0: float
) -> None:
    """Complete the boot report once the first epoch is built and warmed:
    the time to ready, and with a store whether the boot was warm, its
    cache hits, degraded sources and quarantined files (persisted as
    ``last_boot.json`` and logged)."""
    boot_report["time_to_ready_seconds"] = round(time.monotonic() - boot_t0, 3)
    if store is None:
        return
    ss = store.stats()
    boot_report.update(
        warm=bool(boot_report.get("manifest_found")),
        artifacts_from_cache=ss["artifact_cache_hits"],
        degraded_sources=ss["degraded_loads"],
        fsck_quarantined=ss["fsck_quarantined"],
        fetch_retry_giveups=retry_stats()["giveups"],
    )
    store.record_boot_report(boot_report)
    logger.info("boot report", extra={"span_fields": dict(boot_report)})


def runtime_stats(state: ApiServerState) -> Iterator[tuple]:
    """The serving runtime's families for one /metrics scrape, under the
    JAX package's names: the batcher's counters, the environment's
    ``dedup_stats``, ``host_profile``, ``breaker_stats``,
    ``device_errors`` and kernel stats, the policy lifecycle's, the
    supervisor's, the audit scanner's and the verdict matrix's counters,
    and the flight recorder's. Everything is read through ``state``, so the
    scrape follows the epoch flips. As the JAX package's: the native
    frontend's families read zero under ``--frontend python``, the
    lifecycle's under ``--policy-reload-mode off``, the audit families
    under ``--audit-mode off``, the matrix families without
    ``--audit-matrix`` and the watch families without ``--audit-watch``
    (they count what the watch feed applied, dropped and resynced); the
    tenant families have no samples without ``--tenants`` and the shard
    families show one shard and no fence at ``--serving-shards 1``. The
    fetch-retry families count the downloader's retries process-wide."""
    batcher = state.batcher
    env = state.evaluation_environment
    b = batcher.stats_snapshot()
    front = state.native_frontend
    n = front.stats() if front is not None else {}
    yield (names.NATIVE_HTTP_REQUESTS, "counter",
           "HTTP requests framed by the native (GIL-free C++) front-end",
           n.get("http_requests", 0))
    yield (names.NATIVE_PARSE_FALLBACKS, "counter",
           "Requests the native AdmissionReview parser declined and "
           "shipped to the Python parse oracle (floats, duplicate keys, "
           "malformed bodies)", n.get("parse_fallbacks", 0))
    yield (names.NATIVE_RING_FULL, "counter",
           "Requests answered 503 because the native submission ring was "
           "full (drainer overrun)", n.get("ring_full_rejections", 0))
    yield (names.NATIVE_VERDICTS_SERIALIZED, "counter",
           "Responses serialized natively (common verdict shape)",
           n.get("responses_native_serialized", 0))
    yield (names.NATIVE_PYTHON_SERIALIZED, "counter",
           "Responses rendered by Python behind the native frontend "
           "(errors, mutations, exotic status fields)",
           n.get("responses_python_serialized", 0))
    yield (names.NATIVE_FRAMING_SECONDS, "counter",
           "Native-thread time in HTTP framing, AdmissionReview "
           "canonicalization, and response serialization",
           n.get("framing_ns", 0) / 1e9)
    yield (names.NATIVE_INFLIGHT, "gauge",
           "Requests accepted by the native frontend still awaiting their "
           "completion", n.get("inflight", 0))
    yield (names.NATIVE_IDLE_CLOSES, "counter",
           "Native-frontend connections reaped by the idle or read "
           "(slowloris) timeout", n.get("idle_timeout_closes", 0))
    yield (names.NATIVE_CONN_CAP_REJECTS, "counter",
           "Connections answered an in-band 503 because the native "
           "frontend's connection cap was reached",
           n.get("conn_cap_rejections", 0))
    yield from _tls_families(state, n)
    yield (names.BULK_SUBMITS, "counter",
           "submit_many bursts admitted (one queue-lock acquisition each)",
           b["bulk_submits"])
    yield (names.BULK_SUBMITTED_ROWS, "counter",
           "Rows admitted through submit_many bursts",
           b["bulk_submitted_rows"])
    yield (names.BATCHES_DISPATCHED, "counter",
           "Micro-batches dispatched", b["batches_dispatched"])
    yield (names.REQUESTS_DISPATCHED, "counter",
           "Requests dispatched through the micro-batcher",
           b["requests_dispatched"])
    yield (names.DEADLINE_ABANDONED_BATCHES, "counter",
           "Device batches abandoned by the dispatch watchdog",
           b["deadline_abandoned_batches"])
    yield (names.QUEUE_DEPTH, "gauge",
           "Requests waiting for batch formation", batcher.queue_depth())
    yield (names.QUEUE_WAIT_SECONDS, "counter",
           "Cumulative time requests spent queued between batcher "
           "submission and batch formation", b["queue_wait_ns"] / 1e9)
    yield (names.ORACLE_FALLBACKS, "counter",
           "Requests routed to the host oracle (schema overflow)",
           env.oracle_fallbacks)
    yield (names.HOST_FASTPATH_BATCHES, "counter",
           "Micro-batches answered by the host latency fast-path",
           b["host_fastpath_batches"])
    yield (names.HOST_FASTPATH_REQUESTS, "counter",
           "Requests answered by the host latency fast-path",
           env.host_fastpath_requests)
    yield (names.BUDGET_ROUTED_BATCHES, "counter",
           "Batches routed host-side by the latency-budget check",
           b["budget_routed_batches"])
    yield (names.SHED_REQUESTS, "counter",
           "Requests shed at admission (429 + Retry-After)",
           b["shed_requests"])
    yield (names.EXPIRED_DROPPED, "counter",
           "Expired rows dropped before encode/dispatch (no dead work)",
           b["expired_dropped"])
    yield (names.DEGRADED_RESPONSES, "counter",
           "Requests answered by the --degraded-mode policy while the "
           "device breaker was fully tripped", b["degraded_responses"])
    dedup = env.dedup_stats
    yield (names.DEDUP_BLOB_HITS, "counter",
           "Pre-encode blob-tier dedup hits (exact payload replays that "
           "skipped encoding)", dedup["blob_cache_hits"])
    yield (names.DEDUP_BLOB_MISSES, "counter",
           "Pre-encode blob-tier dedup misses", dedup["blob_cache_misses"])
    yield (names.VERDICT_CACHE_HITS, "counter",
           "Row-tier verdict cache hits (post-encode, uid-insensitive)",
           dedup["cache_hits"])
    yield (names.VERDICT_CACHE_MISSES, "counter",
           "Row-tier verdict cache misses", dedup["cache_misses"])
    yield (names.VERDICT_CACHE_BYTES, "gauge",
           "Resident bytes across both verdict-cache tiers",
           dedup["cache_bytes"] + dedup["blob_cache_bytes"])
    yield (names.BATCH_DEDUP_HITS, "counter",
           "Rows answered by an identical row in the same batch",
           dedup["batch_dup_hits"])
    yield (names.FRAGMENT_HITS, "counter",
           "Cache-hit rows answered as pre-serialized response fragments",
           dedup["fragment_hits"])
    profile = env.host_profile
    yield (names.HOST_ENCODE_SECONDS, "counter",
           "Host time in the native batch encode",
           profile["encode_ns"] / 1e9)
    yield (names.HOST_ENCODE_ROWS, "counter",
           "Rows through the native encoder (blob-tier hits skip it)",
           profile["encode_rows"])
    yield (names.HOST_BOOKKEEPING_SECONDS, "counter",
           "Host time in dedup tiers + slot/LRU bookkeeping",
           profile["bookkeeping_ns"] / 1e9)
    yield (names.DISPATCH_WAIT_SECONDS, "counter",
           "Host time blocked on device results",
           profile["dispatch_wait_ns"] / 1e9)
    yield (names.DISPATCHED_ROWS, "counter",
           "Unique rows actually shipped to the device",
           profile["dispatched_rows"])
    breaker = env.breaker_stats
    yield (names.BREAKER_OPEN_SHARDS, "gauge",
           "Device shards whose circuit breaker is currently tripped "
           "(open or half-open)", breaker.get("open_shards", 0))
    yield (names.BREAKER_TRIPS, "counter",
           "Circuit breaker CLOSED/HALF_OPEN -> OPEN transitions",
           breaker.get("trips", 0))
    yield (names.BREAKER_RECOVERIES, "counter",
           "Circuit breaker HALF_OPEN -> CLOSED recoveries",
           breaker.get("recoveries", 0))
    yield (names.BREAKER_PROBES, "counter",
           "Half-open recovery probe dispatches admitted",
           breaker.get("probes", 0))
    yield (names.BREAKER_SHORT_CIRCUITED, "counter",
           "Requests served host-side because a breaker was open",
           breaker.get("short_circuited_requests", 0))
    fetch_retries = retry_stats()
    yield (names.FETCH_RETRY_ATTEMPTS, "counter",
           "Transient policy-fetch failures retried with backoff",
           fetch_retries["attempts"])
    yield (names.FETCH_RETRY_GIVEUPS, "counter",
           "Policy-fetch operations that exhausted the retry budget",
           fetch_retries["giveups"])
    yield (names.DEVICE_ERRORS, "counter",
           "Kernel and CUDA errors at dispatch or fetch (each failed its "
           "batch's requests; none tripped the breaker)", env.device_errors)
    # 0 for an environment without them (the threaded evaluator), as in
    # the JAX package
    pstats = getattr(env, "pallas_stats", None) or {}
    yield (names.PALLAS_DISPATCHES, "counter",
           "Device dispatches served by the policy_matrix kernel (--kernel "
           "pallas, armed buckets)",
           pstats.get("dispatches", 0))
    yield (names.PALLAS_BUCKETS_ARMED, "gauge",
           "Schema buckets currently armed for the policy_matrix kernel "
           "(per-bucket opt-in by dispatch count)",
           pstats.get("buckets_armed", 0))
    yield (names.PALLAS_INTERPRET_MODE, "gauge",
           "1 when the Pallas kernel runs in interpret mode (the Mosaic "
           "capability probe failed — bit-exact, slow, loudly warned)",
           pstats.get("interpret_mode", 0))
    yield from _predicate_families(env)
    yield from _columnar_families(env.host_profile)
    yield from _recovery_families(state)
    yield from _tenant_families(state)
    lstats = state.lifecycle.stats() if state.lifecycle is not None else {}
    yield (names.POLICY_RELOADS, "counter",
           "Policy hot-reload promotions (new epoch serving)",
           lstats.get("reloads", 0))
    yield (names.POLICY_RELOAD_FAILURES, "counter",
           "Policy reload candidates rejected (fetch/compile/canary "
           "failure) — last-good kept serving",
           lstats.get("reload_failures", 0))
    yield (names.POLICY_RELOAD_ROLLBACKS, "counter",
           "Reverts to the last-good policy set: rejected canaries plus "
           "explicit POST /policies/rollback", lstats.get("rollbacks", 0))
    yield (names.RELOAD_CANARY_REPLAYS, "counter",
           "Recorded/synthetic requests replayed through candidate epochs "
           "during shadow canary", lstats.get("canary_replays", 0))
    yield (names.RELOAD_CANARY_DIVERGENCES, "counter",
           "Canary replays whose candidate verdict diverged from the host "
           "oracle", lstats.get("canary_divergences", 0))
    yield (names.POLICY_EPOCH, "gauge",
           "Monotonic number of the currently serving policy epoch (0 = the "
           "boot set)", lstats.get("epoch", 0))
    astats = state.audit.stats() if state.audit is not None else {}
    yield from _audit_families(batcher, b, astats)
    sup = state.supervisor.stats() if state.supervisor is not None else {}
    yield (names.WORKER_RESPAWNS, "counter",
           "Prefork frontend workers respawned after dying",
           sup.get("worker_respawns", 0))
    yield (names.WORKER_RESPAWN_BACKOFF_SECONDS, "counter",
           "Cumulative crash-loop backoff applied before worker respawns",
           sup.get("worker_backoff_seconds", 0.0))
    yield (names.WORKER_SLOTS_GIVEN_UP, "gauge",
           "Frontend worker slots abandoned by the respawn breaker "
           "(crash-looped past the give-up cap; /readiness reports the "
           "degradation)", sup.get("worker_slots_given_up", 0))
    yield (names.SELFHEAL_BATCHER_REVIVES, "counter",
           "Batcher dispatch loops the self-heal watchdog found dead and "
           "rebuilt", sup.get("batcher_revives", 0))
    yield (names.SELFHEAL_FRONTEND_REVIVES, "counter",
           "Native-frontend drainer threads the self-heal watchdog found "
           "dead and rebuilt", sup.get("frontend_revives", 0))
    yield from _shard_families(batcher, b)
    yield from _matrix_families(state, b)
    rec = flightrec.recorder()
    yield (names.FLIGHT_RECORDER_EVENTS, "counter",
           "Phase events written to the flight-recorder ring",
           rec.events_recorded() if rec is not None else 0)
    yield (names.FLIGHT_RECORDER_ROWS_SAMPLED, "counter",
           "Rows that recorded per-row timeline segments "
           "(--recorder-row-sample-rate stride)",
           rec.rows_sampled() if rec is not None else 0)
    yield (
        names.TAIL_EXEMPLAR_LATENCY_SECONDS, "gauge",
        "Tail exemplars: the slowest rows of the current flight-recorder "
        "window, with trace id and slowest phase (full phase breakdown on "
        "/debug/timeline)",
        [
            ((ex["trace_id"], ex["policy_id"], ex["slowest_phase"]),
             ex["latency_seconds"])
            for ex in (rec.exemplars() if rec is not None else ())
        ],
        ("trace_id", "policy_id", "slowest_phase"),
    )


def _predicate_families(env: Any) -> Iterator[tuple]:
    """The predicate optimizer's facts about the serving set
    (``env.optimizer_stats``; 0 for an environment without them)."""
    o = getattr(env, "optimizer_stats", None) or {}
    yield (names.PREDICATE_SUBTREES_SHARED, "gauge",
           "Distinct predicate subtrees shared across policies by the "
           "optimizer's CSE table (computed once per program instead of "
           "once per policy)", o.get("subtrees_shared", 0))
    yield (names.PREDICATE_POLICIES_FOLDED, "gauge",
           "Policies whose verdict folded to a constant and dropped out of "
           "the device program", o.get("policies_folded", 0))
    yield (names.PREDICATE_RULES_FOLDED, "gauge",
           "Rule conditions folded to constants (unreachable or constant "
           "rules; indices preserved)", o.get("rules_folded", 0))
    yield (names.PREDICATE_FIELDS_PRUNED, "gauge",
           "Feature-schema fields pruned by the optimizer (dead gather "
           "columns + zero-fill-redundant validity masks)",
           o.get("fields_pruned", 0))
    yield (names.PREDICATE_ROW_BYTES_SAVED, "gauge",
           "Packed-row bytes saved per row, summed over schema buckets, vs "
           "the unoptimized layout", o.get("row_bytes_saved", 0))


def _columnar_families(profile: Mapping[str, int]) -> Iterator[tuple]:
    """The columnar transport's families, from the environment's
    ``host_profile`` (0 at ``--columnar off`` and for batches K1 served)."""
    for name, key, help_text in (
        (names.WIRE_BYTES_SHIPPED, "wire_bytes_shipped",
         "Bytes actually shipped to the device by the columnar transport "
         "(delta planes + column indices)"),
        (names.WIRE_BYTES_PACKED_EQUIV, "wire_bytes_packed_equiv",
         "Bytes the row-packed transport form would have shipped for the "
         "same dispatches"),
        (names.WIRE_ROWS, "wire_rows",
         "Rows shipped by the columnar transport (bytes/row = "
         "wire_bytes_shipped / this)"),
        (names.DELTA_COLS_SHIPPED, "delta_cols_shipped",
         "32-bit feature columns shipped (delta columns with any nonzero "
         "value, after power-of-two padding)"),
        (names.DELTA_COLS_TOTAL, "delta_cols_total",
         "32-bit feature columns in the dispatched schemas (hit rate = 1 - "
         "shipped/total)"),
        (names.DONATED_DISPATCHES, "donated_dispatches",
         "Columnar dispatches whose input buffers were donated (jax "
         "donate_argnums)"),
        (names.RESIDENT_CONST_BYTES, "resident_const_bytes",
         "Bytes of elided zero planes/columns materialized as "
         "device-resident constants of compiled columnar programs"),
    ):
        yield (name, "counter", help_text, profile.get(key, 0))


def _recovery_families(state: ApiServerState) -> Iterator[tuple]:
    """The soak window's gauges (``state.soak``), the boot's
    (``state.boot_report``) and the state store's (``statestore.stats()``;
    zero without ``--state-dir``)."""
    soak = state.soak or {}
    yield (names.SOAK_WINDOW_RPS, "gauge",
           "Requests/s of the current soak window (tools/soak in-process "
           "engine; 0 outside a soak)", soak.get("rps", 0.0))
    yield (names.SOAK_WINDOW_P99_MS, "gauge",
           "p99 latency (ms) of the current soak window",
           soak.get("p99_ms", 0.0))
    yield (names.SOAK_WINDOW_SHED_RATE, "gauge",
           "Shed (429) fraction of the current soak window",
           soak.get("shed_rate", 0.0))
    boot = state.boot_report or {}
    yield (names.BOOT_TIME_TO_READY, "gauge",
           "Seconds from process bootstrap start to the first serving epoch "
           "compiled+warmed (the MTTR numerator)",
           boot.get("time_to_ready_seconds", 0.0))
    yield (names.BOOT_WARM, "gauge",
           "1 when this boot was WARM: a last-good manifest was found in the "
           "state store (artifact pins / audit resume applied where "
           "eligible)", 1 if boot.get("warm") else 0)
    yield (names.BOOT_DEGRADED_SOURCES, "gauge",
           "Policy sources this boot served from last-good state because "
           "the live read/fetch FAILED (loud degradation, not an outage)",
           boot.get("degraded_sources", 0))
    store = state.statestore
    ss = store.stats() if store is not None else {}
    for name, kind, help_text, key in (
        (names.STATESTORE_ARTIFACTS, "gauge",
         "Content-addressed policy artifacts resident in the state store's "
         "cache", "artifacts_resident"),
        (names.STATESTORE_BYTES, "gauge",
         "Bytes resident in the state store's artifact cache",
         "bytes_resident"),
        (names.STATESTORE_CACHE_HITS, "counter",
         "Artifact-cache hits (pinned warm-boot loads + degraded last-good "
         "fallbacks)", "artifact_cache_hits"),
        (names.STATESTORE_CACHE_MISSES, "counter",
         "Artifact-cache misses (url unknown, blob missing, or "
         "content-address verification failed)", "artifact_cache_misses"),
        (names.STATESTORE_MANIFESTS_PERSISTED, "counter",
         "Last-good epoch manifests persisted (boot, promotion, rollback — "
         "the durable rollback pin)", "manifests_persisted"),
        (names.STATESTORE_JOURNAL_RECORDS, "gauge",
         "Live records across the state store's journals (manifest history "
         "+ url map)", "journal_records"),
        (names.STATESTORE_FSCK_QUARANTINED, "counter",
         "Torn/corrupt state-dir entries the fsck pass moved to quarantine "
         "(boot continued on surviving state)", "fsck_quarantined"),
        (names.STATESTORE_AUDIT_SPILLS, "counter",
         "Audit snapshot spills written (cursors + fed map + inventory, one "
         "atomic journal replace each)", "audit_spills"),
        (names.STATESTORE_AUDIT_ROWS_RESTORED, "gauge",
         "Audit inventory rows restored from the spill at this boot (the "
         "re-LIST the warm boot did NOT pay)", "audit_rows_restored"),
    ):
        yield (name, kind, help_text, ss.get(key, 0))


def _tls_families(state: ApiServerState, n: dict) -> Iterator[tuple]:
    """The TLS families, under the JAX package's names and help texts. The
    expiry gauge and the reload counters read ``certs.py`` whichever
    frontend terminates TLS; the handshake counters are the native loops'
    (zero under the standard-library terminator and plaintext)."""
    reloadable = state.tls_reloadable
    manager = state.native_tls
    expiry = reloadable.identity_not_after() if reloadable is not None else None
    reloads, reload_failures = (
        reloadable.counters() if reloadable is not None else (0, 0)
    )
    yield (names.TLS_CERT_EXPIRY_SECONDS, "gauge",
           "Seconds until the serving TLS identity's notAfter (negative = "
           "expired; 0 when TLS is off or the leaf is undecodable)",
           (expiry - time.time()) if expiry is not None else 0)
    yield (names.TLS_HANDSHAKES_OK, "counter",
           "TLS handshakes completed by the native frontend",
           n.get("tls_handshakes_ok", 0))
    yield (names.TLS_HANDSHAKES_FAILED, "counter",
           "Native TLS handshakes that failed hard (bad record, mTLS "
           "client-CA rejection, injected tls.handshake faults)",
           n.get("tls_handshakes_failed", 0))
    yield (names.TLS_HANDSHAKE_TIMEOUTS, "counter",
           "Native TLS handshakes reaped by the arrival timeout (byte drips "
           "never refresh it — the TLS-layer slowloris defense)",
           n.get("tls_handshake_timeouts", 0))
    yield (names.TLS_HANDSHAKE_DISCONNECTS, "counter",
           "Connections that disconnected mid-handshake before the native "
           "TLS handshake completed", n.get("tls_handshake_disconnects", 0))
    yield (names.TLS_CLEAN_CLOSES, "counter",
           "Native TLS connections closed with a close_notify alert "
           "(in-band rejections included — no truncation-looking RSTs for "
           "well-behaved clients)", n.get("tls_clean_closes", 0))
    yield (names.TLS_GENERATIONS, "counter",
           "SSL_CTX generations installed on the native loops (boot + each "
           "successful hot-rotation; established connections drain on the "
           "generation they pinned)",
           manager.snapshot()["generations"] if manager is not None else 0)
    yield (names.TLS_RELOADS, "counter",
           "TLS identity/client-CA hot reloads applied by certs.py (SIGHUP "
           "or digest-watch rotation)", reloads)
    yield (names.TLS_RELOAD_FAILURES, "counter",
           "TLS reload attempts that failed validation; the last-good "
           "identity kept serving each time", reload_failures)
    yield (names.TLS_NATIVE_TERMINATION, "gauge",
           "1 when TLS terminates on the native epoll loops, 0 under the "
           "aiohttp terminator or plaintext",
           1 if manager is not None else 0)


def _tenant_families(state: ApiServerState) -> Iterator[tuple]:
    """The tenant-labelled families (no samples without tenants)."""
    t = state.tenants.stats() if state.tenants is not None else {}
    for name, kind, text, key in (
        (names.TENANT_SHED_ROWS, "counter",
         "Rows shed by a tenant's admission quota (token bucket + "
         "in-flight cap; 429 + Retry-After)", "shed_rows"),
        (names.TENANT_ADMITTED_ROWS, "counter",
         "Rows admitted through a tenant's admission quota", "admitted_rows"),
        (names.TENANT_INFLIGHT_ROWS, "gauge",
         "Admitted-but-unresolved rows per tenant (the max-inflight cap's "
         "numerator)", "inflight_rows"),
        (names.TENANT_QUEUE_DEPTH, "gauge",
         "Requests waiting in each tenant batcher's submission queue",
         "queue_depth"),
        (names.TENANT_DISPATCH_GRANTS, "counter",
         "Weighted-fair dispatch slots granted per tenant (live + audit "
         "classes)", "dispatch_grants"),
        (names.TENANT_DISPATCH_WAIT_SECONDS, "counter",
         "Cumulative time each tenant's batches waited for a "
         "fair-scheduler dispatch slot", "dispatch_wait_seconds"),
        (names.TENANT_EPOCH, "gauge",
         "Each tenant's currently serving policy epoch", "epoch"),
        (names.TENANT_ROLLBACKS, "counter",
         "Per-tenant reverts to last-good (rejected canaries + explicit "
         "rollbacks)", "rollbacks"),
        (names.TENANT_READY, "gauge",
         "Per-tenant honest readiness (1 ready, 0 degraded — the "
         "/readiness/{tenant} verdict)", "ready"),
    ):
        yield (name, kind, text, t.get(key, []), ("tenant",))
    yield (names.TENANTS_SERVING, "gauge",
           "Tenants served by this process (0 without a tenants manifest; "
           "includes the default tenant otherwise)", t.get("serving", 0))


def _audit_families(batcher: Any, b: dict, a: dict) -> Iterator[tuple]:
    """The audit lane's (the default tenant's plane), the scanner's and the
    watch feed's families."""
    for name, kind, text, value in (
        (names.AUDIT_BATCHES_DISPATCHED, "counter",
         "Best-effort audit-lane batches dispatched on idle slots",
         b["audit_batches_dispatched"]),
        (names.AUDIT_PREEMPTIONS, "counter",
         "Audit batches re-queued because live work arrived first",
         b["audit_preemptions"]),
        (names.AUDIT_LANE_DEPTH, "gauge",
         "Audit batches waiting for an idle dispatch slot",
         batcher.audit_lane_depth()),
        (names.AUDIT_ROWS_SCANNED, "counter",
         "Resource x policy rows the audit scanner has judged",
         a.get("rows_scanned", 0)),
        (names.AUDIT_FULL_SWEEPS, "counter",
         "Completed full audit sweeps (boot, epoch promotions, rollbacks)",
         a.get("full_sweeps", 0)),
        (names.AUDIT_DIRTY_SWEEPS, "counter",
         "Completed dirty-set audit sweeps (interval cadence)",
         a.get("dirty_sweeps", 0)),
        (names.AUDIT_SWEEP_ERRORS, "counter",
         "Audit sweeps aborted by a fault (retried on the next trigger)",
         a.get("sweep_errors", 0)),
        (names.AUDIT_PAUSED_SWEEPS, "counter",
         "Audit sweeps skipped while the device breaker was open",
         a.get("paused_sweeps", 0)),
        (names.AUDIT_REPORT_FRESHNESS, "gauge",
         "Seconds since the last completed full audit sweep (-1 before the "
         "first)", a.get("freshness_seconds", -1.0)),
        (names.AUDIT_REPORTS_RESIDENT, "gauge",
         "Audit report rows currently held", a.get("reports_resident", 0)),
        (names.AUDIT_REPORTS_STALE, "gauge",
         "Audit report rows stamped by a rolled-back policy epoch",
         a.get("reports_stale", 0)),
        (names.AUDIT_SNAPSHOT_RESOURCES, "gauge",
         "Cluster resources held in the audit snapshot store",
         a.get("snapshot_resources", 0)),
        (names.AUDIT_SNAPSHOT_BYTES, "gauge",
         "Resident bytes of the audit snapshot store",
         a.get("snapshot_bytes", 0)),
        (names.WATCH_EVENTS_APPLIED, "counter",
         "Kubernetes watch events applied to the audit snapshot store "
         "(ADDED/MODIFIED supersede, DELETED evicts)",
         a.get("watch_events_applied", 0)),
        (names.WATCH_EVENTS_DROPPED, "counter",
         "Watch events dropped by the bounded feed queue (each forces a "
         "counted full re-LIST resync of its kind)",
         a.get("watch_events_dropped", 0)),
        (names.WATCH_RESYNCS, "counter",
         "Full re-LIST resyncs of the audit watch feed (410 expiry, "
         "transport fault, queue overflow, or the staleness-bounding "
         "interval)", a.get("watch_resyncs", 0)),
    ):
        yield (name, kind, text, value)


def _matrix_families(state: ApiServerState, b: dict) -> Iterator[tuple]:
    """The verdict matrix's families, and lookup admission's (the default
    tenant's plane)."""
    m = state.audit_matrix.stats() if state.audit_matrix is not None else {}
    for name, kind, text, value in (
        (names.MATRIX_ROWS_RESIDENT, "gauge",
         "Distinct snapshot rows holding at least one verdict cell in the "
         "matrix", m.get("rows_resident", 0)),
        (names.MATRIX_CELLS_RESIDENT, "gauge",
         "Resident (object x policy) verdict cells",
         m.get("cells_resident", 0)),
        (names.MATRIX_COLUMNS, "gauge",
         "Policy columns of the serving epoch (keyed by policy content "
         "fingerprint, not epoch number)", m.get("columns", 0)),
        (names.MATRIX_DIRTY_COLUMNS, "gauge",
         "Columns awaiting a column-dirty sweep (epoch promotion changed "
         "their policy content)", m.get("dirty_columns", 0)),
        (names.MATRIX_VERSION, "gauge",
         "Monotonic matrix version — the /audit/stream resume cursor's "
         "upper bound", m.get("matrix_version", 0)),
        (names.MATRIX_ROW_SWEEP_ROWS, "counter",
         "Matrix rows re-judged because the watch feed dirtied the object "
         "row", m.get("row_sweep_rows", 0)),
        (names.MATRIX_COLUMN_SWEEP_ROWS, "counter",
         "Matrix rows re-judged because an epoch promotion dirtied the "
         "policy column", m.get("column_sweep_rows", 0)),
        (names.MATRIX_ROWS_EVICTED, "counter",
         "Matrix rows evicted by watch-feed DELETEs",
         m.get("rows_evicted", 0)),
        (names.MATRIX_COLUMNS_INVALIDATED, "counter",
         "Policy columns invalidated (content fingerprint changed or "
         "policy removed at promotion/rollback)",
         m.get("columns_invalidated", 0)),
        (names.MATRIX_CHANGELOG_EMITS, "counter",
         "Verdict-change entries emitted to the matrix changelog ring "
         "(re-stamps that confirm a standing verdict do not emit)",
         m.get("changelog_emits", 0)),
        (names.MATRIX_STREAM_CLIENTS, "gauge",
         "Connected GET /audit/stream subscribers",
         m.get("stream_clients", 0)),
        (names.MATRIX_STREAM_DROPPED_CLIENTS, "counter",
         "Stream subscribers dropped for slow consumption (bounded "
         "per-client queue overflowed; the applier never blocks)",
         m.get("changelog_dropped_clients", 0)),
        (names.MATRIX_LOOKUP_HITS, "counter",
         "/validate requests answered from a precomputed matrix verdict "
         "(byte-identical UPDATE payload, protect-mode hookless target)",
         b.get("matrix_lookup_hits", 0)),
        (names.MATRIX_LOOKUP_MISSES, "counter",
         "Matrix-eligible /validate requests that fell through to full "
         "evaluation (no cell, stale payload hash, or stale column "
         "fingerprint)", b.get("matrix_lookup_misses", 0)),
        (names.MATRIX_SPILLS, "counter",
         "Matrix spills journaled to the statestore (cadenced sweep-tail "
         "spills + the shutdown spill)", m.get("spills", 0)),
        (names.MATRIX_CELLS_RESTORED, "gauge",
         "Verdict cells restored from the statestore spill at warm boot "
         "(column fingerprint + payload hash matched)",
         m.get("cells_restored", 0)),
    ):
        yield (name, kind, text, value)


def _shard_families(batcher: Any, b: dict) -> Iterator[tuple]:
    """The serving-shard families of the default tenant's plane: one
    shard and no fence at ``--serving-shards 1``."""
    rows = batcher.shard_health() if hasattr(batcher, "shard_health") else []
    yield (names.SHARDS_SERVING, "gauge",
           "Host-local serving shards behind the router (--serving-shards; "
           "1 = router bypassed)", len(rows) or 1)
    yield (names.SHARD_HEALTHY, "gauge",
           "Per-shard routability (1 = routable, 0 = fenced pending warm "
           "revive)",
           [((str(r["shard"]),), 1 if r["healthy"] else 0) for r in rows],
           ("shard",))
    yield (names.SHARD_QUEUE_DEPTH, "gauge",
           "Per-shard submission queue depth (the router's EWMA routing "
           "signal reads this)",
           [((str(r["shard"]),), r["queue_depth"]) for r in rows],
           ("shard",))
    for name, text, key in (
        (names.SHARD_FENCES,
         "Shards fenced by the heartbeat (wedged/dead dispatch loop or "
         "faulted probe)", "shard_fences"),
        (names.SHARD_REROUTED_ROWS,
         "Queued rows re-routed to a sibling shard at fence time "
         "(deadline, trace, and quota token preserved)", "shard_reroutes"),
        (names.SHARD_FENCED_ROWS,
         "Queued rows answered 503+Retry-After at fence time (no sibling "
         "had room)", "shard_fenced_rows"),
        (names.SHARD_RESPAWNS,
         "Fenced shards warm-revived in place (queue, pools, caches, and "
         "compiled programs survive)", "shard_respawns"),
        (names.SHARD_HEARTBEAT_FAULTS,
         "shard.heartbeat failpoint faults observed by the router's prober",
         "shard_heartbeat_faults"),
    ):
        yield (name, "counter", text, b.get(key, 0))


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
        readiness_probe_port: int = DEFAULT_READINESS_PROBE_PORT,
        enable_metrics: bool = False,
        enable_pprof: bool = False,
        flight_recorder: bool = True,
        recorder_ring_events: int = flightrec.DEFAULT_RING_EVENTS,
        recorder_row_sample_rate: float = flightrec.DEFAULT_ROW_SAMPLE_RATE,
        frontend: str = "python",
        native_idle_timeout_seconds: float = DEFAULT_NATIVE_IDLE_TIMEOUT_SECONDS,
        native_read_timeout_seconds: float = DEFAULT_NATIVE_READ_TIMEOUT_SECONDS,
        native_max_connections: int = 0,
        workers: int | None = None,
        warmup: bool = True,
        policy_reload_mode: str = "auto",
        reload_canary_requests: int = DEFAULT_RELOAD_CANARY_REQUESTS,
        reload_divergence_threshold: float = 0.0,
        reload_admin_token: str | None = None,
        selfheal_interval_seconds: float = DEFAULT_SELFHEAL_INTERVAL_SECONDS,
        policies_path: str | None = None,
        policies_text: str | None = None,
        request_timeout_ms: float = DEFAULT_REQUEST_TIMEOUT_MS,
        tenants: TenantManifest | None = None,
        serving_shards: int = 1,
        shard_heartbeat_seconds: float = DEFAULT_SHARD_HEARTBEAT_SECONDS,
        audit_mode: str = "off",
        audit_interval_seconds: float = DEFAULT_AUDIT_INTERVAL_SECONDS,
        audit_batch_size: int = DEFAULT_AUDIT_BATCH_SIZE,
        audit_max_snapshot_bytes: int = DEFAULT_AUDIT_MAX_SNAPSHOT_BYTES,
        audit_resources_file: str | None = None,
        audit_matrix: bool = False,
        audit_stream_max_clients: int = DEFAULT_AUDIT_STREAM_MAX_CLIENTS,
        audit_matrix_whatif: bool = False,
        audit_matrix_spill_seconds: float = 30.0,
        tls_config: TlsConfig | None = None,
        native_tls: str = "auto",
        native_tls_handshake_timeout_seconds: float = (
            DEFAULT_NATIVE_TLS_HANDSHAKE_TIMEOUT_SECONDS
        ),
        http_workers: int = 1,
        worker_respawn_giveup: int = DEFAULT_WORKER_RESPAWN_GIVEUP,
        log_level: str = "info",
        log_fmt: str = "text",
        module_resolver: Callable[[str], Any] | None = None,
        backend: str = "torch",
        predicate_opt: bool = True,
        sources: Sources | None = None,
        verification_config: VerificationConfig | None = None,
        docker_config_json_path: str | None = None,
        policies_download_dir: str = ".",
        sigstore_cache_dir: str = "sigstore-data",
        context_refresh_seconds: float = DEFAULT_CONTEXT_REFRESH_SECONDS,
        context_watch: bool = True,
        kube_insecure_skip_tls_verify: bool = False,
        ignore_kubernetes_connection_failure: bool = False,
        audit_watch: bool = False,
        audit_watch_resources: str = DEFAULT_AUDIT_WATCH_RESOURCES,
        audit_watch_max_queue_events: int = DEFAULT_AUDIT_WATCH_MAX_QUEUE_EVENTS,
        state_dir: str | None = None,
        state_audit_spill_seconds: float = 30.0,
        kernel: str = DEFAULT_KERNEL,
        columnar: bool = True,
        donate_buffers: bool = True,
        compilation_cache_dir: str | None = None,
        mesh: "mesh_mod.MeshSpec | str | None" = None,
        mesh_dispatch: str = "fused",
        distributed_coordinator: str | None = None,
        distributed_num_processes: int | None = None,
        distributed_process_id: int | None = None,
        mesh_devices: list | None = None,
    ) -> None:
        boot_t0 = time.monotonic()
        if compilation_cache_dir:
            # before the first build: every native library of this
            # process builds into (or is reused from) the directory
            buildcache.set_build_dir(compilation_cache_dir)
        if frontend not in FRONTENDS:
            raise ValueError(f"unknown frontend {frontend!r}")
        if native_tls not in NATIVE_TLS_MODES:
            raise ValueError(
                f"invalid native TLS mode {native_tls!r} (expected auto or off)"
            )
        if http_workers < 1:
            raise ValueError("--http-workers must be >= 1")
        if worker_respawn_giveup < 1:
            raise ValueError("--worker-respawn-giveup must be >= 1")
        tls_config = tls_config or TlsConfig()
        tls_config.validate()
        if audit_mode not in AUDIT_MODES:
            raise ValueError(
                f"invalid audit mode {audit_mode!r} "
                "(expected off, interval, or on-promote)"
            )
        if audit_matrix and audit_mode == "off":
            raise ValueError(
                "--audit-matrix requires the audit scanner "
                "(--audit-mode interval or on-promote)"
            )
        if audit_matrix_whatif and not audit_matrix:
            raise ValueError("--audit-matrix-whatif requires --audit-matrix")
        if audit_watch and audit_mode == "off":
            raise ValueError(
                "--audit-watch requires the audit scanner "
                "(--audit-mode interval or on-promote)"
            )
        if context_refresh_seconds <= 0:
            raise ValueError("--context-refresh-seconds must be > 0")
        if policy_reload_mode not in RELOAD_MODES:
            raise ValueError(
                f"invalid policy reload mode {policy_reload_mode!r} "
                "(expected off, auto, or manual)"
            )
        mesh_spec = (
            mesh_mod.MeshSpec.parse(mesh) if isinstance(mesh, str)
            else mesh or mesh_mod.MeshSpec()
        )
        if mesh_dispatch not in MESH_DISPATCHES:
            raise ValueError(
                f"invalid mesh dispatch {mesh_dispatch!r} "
                "(expected 'fused' or 'threaded')"
            )
        self._distributed = bool(distributed_coordinator)
        if distributed_coordinator:
            # before any device enumeration: the mesh built below spans
            # every process's devices
            mesh_mod.initialize_distributed(
                coordinator_address=distributed_coordinator,
                num_processes=distributed_num_processes,
                process_id=distributed_process_id,
            )
            logger.info(
                "torch.distributed initialized",
                extra={"span_fields": {
                    "coordinator": distributed_coordinator,
                    "process_id": distributed_process_id,
                    "num_processes": distributed_num_processes,
                }},
            )
        if enable_metrics:
            registry = setup_metrics()
            # the push goes where a collector is configured; the
            # Prometheus pull stays on either way, and both read the one
            # registry
            if os.environ.get(otlp.ENDPOINT_ENV):
                otlp.install_metrics_pusher(registry)
        # the durable last-good store, opened before any fetch: its fsck
        # quarantines torn state (never fatal), and the last-good
        # manifests pin the artifact digests of every tenant whose
        # policies file is byte-identical to its manifest's
        statestore, fingerprint, boot_report, pinned = _open_statestore(
            state_dir, policies, policies_path, policies_text, tenants,
            backend=backend, predicate_opt=predicate_opt, kernel=kernel,
            columnar=columnar,
        )
        # the offline sigstore trust root, loaded once and shared by the
        # module resolver (artifact verification) and every environment
        # (the wasm keyless v2/verify capability); None degrades keyless
        trust_root = load_trust_root(sigstore_cache_dir)
        if module_resolver is None and (
            sources or verification_config or _needs_fetch(policies)
        ):
            module_resolver = make_module_resolver(
                FetchConfig(
                    sources=sources,
                    verification_config=verification_config,
                    docker_config_json_path=docker_config_json_path,
                    policies_download_dir=policies_download_dir,
                    sigstore_cache_dir=sigstore_cache_dir,
                ),
                trust_root=trust_root,
                statestore=statestore,
                pinned_artifacts=pinned,
            )
        # the registry client of the oci/v1/manifest_digest capability:
        # the token flow, TLS and docker config of registry:// pulls
        oci_digest_source = Downloader(
            sources=sources, docker_config_json_path=docker_config_json_path
        ).manifest_digest
        self._context_service = _build_context_service(
            policies,
            refresh_seconds=context_refresh_seconds,
            watch=context_watch,
            insecure_skip_tls_verify=kube_insecure_skip_tls_verify,
            ignore_connection_failure=ignore_kubernetes_connection_failure,
        )
        # the recorder goes in before the environment and the batcher are
        # built, so their warmup records
        self._recorder = (
            flightrec.FlightRecorder(
                capacity=recorder_ring_events,
                row_sample_rate=recorder_row_sample_rate,
                registry=default_registry(),
            )
            if flight_recorder
            else None
        )
        flightrec.install(self._recorder)
        if enable_pprof:
            profiling.activate_memory_profiling()
            if http_workers > 1:
                logger.warning(
                    "--enable-pprof with --http-workers: the pprof routes "
                    "are served by the main process only; a fraction of "
                    "connections on the shared port land on workers and "
                    "404 — hit the endpoint repeatedly or set "
                    "--http-workers 1 when profiling"
                )
        reload_enabled = policy_reload_mode != "off"
        # the canary's replay ring: every epoch's batcher feeds the same
        # one, so a reload replays the traffic the serving epoch saw
        recorder = (
            ShadowRecorder(capacity=reload_canary_requests)
            if reload_enabled else None
        )
        queue_capacity = (workers or default_workers()) * max_batch_size

        # every environment (boot, reload candidate and its oracle referee,
        # each tenant and each shard) resolves modules through the same
        # resolver, reads the same context snapshot, and gives wasm guests
        # the trust root, the registry client and the policy timeout as
        # their wall-clock budget (None under --disable-timeout-protection)
        wasm_kwargs = dict(
            module_resolver=module_resolver,
            wasm_wall_clock_budget=policy_timeout,
            wasm_trust_root=trust_root,
            wasm_oci_digest_source=oci_digest_source,
            context_service=self._context_service,
        )

        builder_kwargs = dict(
            backend=backend,
            device=device,
            predicate_opt=predicate_opt,
            kernel=kernel,
            columnar=columnar,
            donate_buffers=donate_buffers,
            continue_on_errors=continue_on_errors,
            always_accept_admission_reviews_on_namespace=(
                always_accept_admission_reviews_on_namespace
            ),
            **wasm_kwargs,
            verdict_cache_size=verdict_cache_size,
            breaker_config=dict(
                failure_threshold=breaker_failure_threshold,
                window_seconds=breaker_window_seconds,
                cooldown_seconds=breaker_cooldown_seconds,
            ),
        )
        if mesh_devices is None and backend == "torch":
            # the default device list, once: in a process group it is a
            # collective, which a reload on one process alone must not
            # call again
            mesh_devices = mesh_mod.global_devices(resolve_device(device).type)

        def build_environment(policy_set: Mapping[str, Any]) -> Any:
            # boot, every epoch and shard sibling, and the lifecycle's
            # candidates
            return _build_environment(
                policy_set, builder_kwargs, mesh_spec, mesh_dispatch,
                devices=mesh_devices,
            )

        def build_oracle_environment(policy_set: Mapping[str, Any]) -> Any:
            # the canary's referee: the host oracle over the same set
            return EvaluationEnvironmentBuilder(
                backend="oracle",
                continue_on_errors=continue_on_errors,
                always_accept_admission_reviews_on_namespace=(
                    always_accept_admission_reviews_on_namespace
                ),
                **wasm_kwargs,
            ).build(dict(policy_set))

        # the tenants' shared dispatch scheduler and the default tenant's
        # quota exist before any batcher; without a manifest both are None
        # and every batcher is the single-tenant one
        scheduler = None
        default_spec: TenantSpec | None = None
        default_admission = None
        if tenants is not None:
            default_spec = tenants.default
            weights = {n: t.weight for n, t in tenants.tenants.items()}
            weights[DEFAULT_TENANT] = default_spec.weight
            scheduler = FairDispatchScheduler(
                max_concurrent=tenants.max_concurrent_dispatches,
                weights=weights,
            )
            default_admission = _admission_of(default_spec)
        supervisor = SupervisorStats()
        # the audit scanner's inventory, fed by every epoch's default-tenant
        # batcher (the dirty set survives reloads, as the canary ring
        # does), and the verdict matrix, built before the batchers that
        # consult it
        snapshot = None
        matrix = None
        self._watch_feed = None
        if audit_mode != "off":
            snapshot = SnapshotStore(max_bytes=audit_max_snapshot_bytes)
            audit_resume = (
                statestore.load_audit_spill() if statestore is not None
                else None
            )
            if audit_resume is not None:
                # a warm boot rebuilds the inventory from the spill, so the
                # watch feed resumes from its cursors instead of re-LISTing
                restored = snapshot.restore_rows(audit_resume["rows"])
                boot_report["audit_rows_restored"] = restored
                logger.info(
                    "audit snapshot restored from the state-store spill",
                    extra={"span_fields": {
                        "rows": restored,
                        "kinds_with_cursor": len(audit_resume["rvs"]),
                    }},
                )
            if audit_resources_file:
                snapshot.seed_from_file(audit_resources_file)
            if audit_matrix:
                # restored after the snapshot: its cells are validated
                # against the restored rows' payload hashes
                matrix = VerdictMatrix(
                    snapshot=snapshot, statestore=statestore,
                    spill_interval_seconds=audit_matrix_spill_seconds,
                )
                matrix.set_columns(policies, 0)
                if statestore is not None:
                    boot_report["matrix_cells_restored"] = matrix.restore()
            if audit_watch:
                # the live feed: list+watch events populate the snapshot
                # the scanner sweeps (audit/watch_feed.py)
                try:
                    self._watch_feed = _build_audit_watch_feed(
                        snapshot,
                        resources=audit_watch_resources,
                        refresh_seconds=context_refresh_seconds,
                        max_queue_events=audit_watch_max_queue_events,
                        insecure_skip_tls_verify=kube_insecure_skip_tls_verify,
                        ignore_connection_failure=(
                            ignore_kubernetes_connection_failure
                        ),
                        statestore=statestore,
                        spill_interval_seconds=state_audit_spill_seconds,
                        resume=audit_resume,
                    )
                except BaseException:
                    self._stop_feeds()
                    raise

        def make_batcher(
            env: Any, tenant: str, admission: Any, spec: TenantSpec | None,
            shadow: Any, tracker: Any = None,
        ) -> MicroBatcher:
            """The one batcher builder: every tenant, epoch and rollback
            gets the same knobs (not started), with a tenant's own
            deadline and degraded mode where its manifest entry sets
            them; only the default tenant's feed the audit snapshot and
            consult the verdict matrix."""
            timeout_ms, degraded = request_timeout_ms, degraded_mode
            if spec is not None:
                if spec.request_timeout_ms is not None:
                    timeout_ms = spec.request_timeout_ms
                if spec.degraded_mode is not None:
                    degraded = spec.degraded_mode
            return MicroBatcher(
                env,
                max_batch_size=max_batch_size,
                batch_timeout_ms=batch_timeout_ms,
                policy_timeout=policy_timeout,
                host_fastpath_threshold=host_fastpath_threshold,
                latency_budget_ms=latency_budget_ms,
                degraded_mode=degraded,
                queue_capacity=queue_capacity,
                shadow_recorder=shadow,
                request_timeout_ms=timeout_ms,
                admission=admission,
                scheduler=scheduler,
                tenant=tenant,
                audit_tracker=tracker,
                verdict_matrix=matrix if tracker is not None else None,
            )

        def plane_builder(
            tenant: str, admission: Any, spec: TenantSpec | None, shadow: Any,
            tracker: Any = None,
        ):
            """A tenant's ``build_batcher``: the plain batcher at one
            shard, else a shard router whose siblings' environments are
            rebuilt from ``env.source_policies``; the tenant's quota and
            the scheduler are shared by its shards."""
            return lambda env: build_serving_shards(
                env,
                lambda e: make_batcher(
                    e, tenant, admission, spec, shadow, tracker
                ),
                build_environment,
                serving_shards,
                heartbeat_seconds=shard_heartbeat_seconds,
                supervisor=supervisor,
                statestore=statestore,
            )

        build_batcher = plane_builder(
            DEFAULT_TENANT, default_admission, default_spec, recorder, snapshot
        )
        try:
            env = build_environment(policies)
        except BaseException:
            self._stop_feeds()
            raise
        try:
            batcher = build_batcher(env)
        except BaseException:
            env.close()
            self._stop_feeds()
            raise
        self._selfheal_interval = selfheal_interval_seconds
        self._selfheal: SelfHealWatchdog | None = None
        self.state = ApiServerState(
            env, batcher, hostname=socket.gethostname(),
            enable_pprof=enable_pprof, ready=False,
            admin_token=reload_admin_token, supervisor=supervisor,
            audit_matrix=matrix,
            audit_stream_max_clients=audit_stream_max_clients,
            statestore=statestore, boot_report=boot_report,
        )
        self.lifecycle: PolicyLifecycleManager | None = None
        self._httpd: _HttpServer | None = None
        self._tls_context: ssl.SSLContext | None = None
        # the prefork workers (started by start(); see _start_workers)
        self._http_workers = http_workers
        self._worker_respawn_giveup = worker_respawn_giveup
        self._worker_args = (host, socket.gethostname(), log_level, log_fmt)
        self._compilation_cache_dir = compilation_cache_dir
        self._worker_procs: list = []
        self._worker_cmd: list[str] = []
        self._worker_stop = threading.Event()
        self._worker_supervisor: threading.Thread | None = None
        self._bridge: EvaluationBridge | None = None
        self._bridge_dir: str | None = None
        self._bridge_socket: str | None = None
        manager = None
        try:
            if warmup:
                batcher.warmup()
            batcher.start()
            if reload_enabled:
                self.lifecycle = self.state.lifecycle = PolicyLifecycleManager(
                    state=self.state,
                    build_environment=build_environment,
                    build_oracle_environment=build_oracle_environment,
                    build_batcher=build_batcher,
                    recorder=recorder,
                    read_policies=(
                        (lambda: read_policies_source(policies_path))
                        if policies_path else None
                    ),
                    policies_path=policies_path,
                    mode=policy_reload_mode,
                    canary_requests=reload_canary_requests,
                    divergence_threshold=reload_divergence_threshold,
                    warmup=warmup,
                    statestore=statestore,
                    fingerprint=fingerprint,
                )
            if tenants is not None:
                manager = TenantManager(scheduler=scheduler)
                manager.add(
                    Tenant(DEFAULT_TENANT, default_spec, self.state,
                           default_admission)
                )
                for name, spec in tenants.tenants.items():
                    manager.add(self._build_tenant(
                        name, spec, build_environment,
                        build_oracle_environment, plane_builder,
                        reload_enabled, policy_reload_mode,
                        reload_canary_requests, reload_divergence_threshold,
                        warmup, statestore, fingerprint,
                    ))
            if tls_config.enabled:
                self._tls_context = (
                    create_tls_config_and_watch_certificate_changes(tls_config)
                )
                # the expiry and reload counters read it, whichever
                # frontend terminates TLS
                self.state.tls_reloadable = self._tls_context._reloadable
            prefork = http_workers > 1 and self._tls_context is None
            if http_workers > 1 and self._tls_context is not None:
                logger.warning(
                    "--http-workers is not supported with TLS yet (workers "
                    "would each need the cert material); serving in-process"
                )
            native = frontend == "native"
            if native and self._tls_context is not None and native_tls == "off":
                logger.warning(
                    "--native-tls off with --frontend native: TLS "
                    "terminates on the standard-library frontend (the "
                    "native loops cannot share its port); serving with "
                    "the Python frontend"
                )
                native = False
            self._frontend_choice = "native" if native else "python"
            # the API port first (its native library and poll buffer too,
            # before the collection below), the readiness port once it is
            # bound
            if native:
                self._bind_native_frontend(
                    host, port, native_idle_timeout_seconds,
                    native_read_timeout_seconds, native_max_connections,
                    reuse_port=prefork,
                    handshake_timeout_seconds=(
                        native_tls_handshake_timeout_seconds
                    ),
                )
                if enable_pprof:
                    logger.warning(
                        "--enable-pprof with --frontend native: the native "
                        "frontend serves only the evaluation POSTs; the "
                        "pprof endpoints need --frontend python"
                    )
            else:
                self._httpd = _HttpServer(
                    (host, port), ApiHandler, self.state,
                    tls_context=self._tls_context, reuse_port=prefork,
                )
            self._prefork = prefork
            # collect the build's and the warmup's garbage (and any the
            # caller left) before serving: left to the first full
            # collection under traffic, the finalizers of freed device and
            # page-locked memory ran on whichever serving thread triggered
            # it, and stalled it for up to 2 s on an H100 host (``PERF.md``)
            gc.collect()
            self._readiness = _HttpServer(
                (host, readiness_probe_port), ReadinessHandler, self.state
            )
        except BaseException:
            if manager is not None:
                manager.shutdown()
            self._close_api()
            self._stop_tls_watch()
            batcher.shutdown()
            env.close()
            self._stop_feeds()
            if flightrec.recorder() is self._recorder:
                flightrec.install(None)
            raise
        default_registry().attach_runtime_stats(
            lambda: runtime_stats(self.state)
        )
        if self.lifecycle is not None:
            # epoch 0 is the boot build; installing it flips readiness
            self.lifecycle.install_first_epoch(
                env, batcher, policies, policies_yaml=policies_text
            )
            self.lifecycle.start_watching()
        else:
            self.state.ready = True
        if manager is not None:
            for t in manager.named():
                if t.state.lifecycle is not None:
                    t.state.lifecycle.start_watching()
            self.state.tenants = manager
        if snapshot is not None:
            scanner = self.state.audit = AuditScanner(
                state=self.state,
                snapshot=snapshot,
                reports=PolicyReportStore(),
                mode=audit_mode,
                interval_seconds=audit_interval_seconds,
                batch_size=audit_batch_size,
                matrix=matrix,
            )
            if boot_report.get("matrix_cells_restored", 0) > 0:
                # the restore proved the rows it covers current, so the
                # boot's sweep is a dirty sweep of the rest
                scanner.skip_boot_full_sweep()
            if self.lifecycle is not None:
                # a promotion re-judges under the new set; a rollback
                # stales the revoked epoch's rows
                self.lifecycle.set_epoch_hooks(
                    on_promote=scanner.on_promote,
                    on_rollback=scanner.on_rollback,
                )
                if audit_matrix_whatif:
                    self.lifecycle.set_whatif_matrix(matrix)
            # the live feed (built with the snapshot) joins the scanner's
            # stats and report payload
            scanner.watch_feed = self.state.audit_watch = self._watch_feed
        self._threads: list[threading.Thread] = []
        _finish_boot_report(boot_report, statestore, boot_t0)

    @staticmethod
    def _build_tenant(
        name: str, spec: TenantSpec, build_environment: Any,
        build_oracle_environment: Any, plane_builder: Any,
        reload_enabled: bool, reload_mode: str, canary_requests: int,
        divergence_threshold: float, warmup: bool, statestore: Any = None,
        fingerprint: str | None = None,
    ) -> Tenant:
        """One named tenant's stack: its policies (the ``tenant.reload``
        failpoint fires first, under its scope), environment, serving
        plane (its quota, deadline and degraded mode) and, with reload on,
        its lifecycle over its policies file with a shadow ring of its
        own. With a state store, a policies file that cannot be read boots
        the tenant on its last-good manifest, loudly."""
        try:
            with failpoints.scope(name):
                failpoints.fire("tenant.reload")
            t_policies, t_text = read_policies_source(spec.policies_path)
        except Exception as e:  # noqa: BLE001 — every read failure
            manifest = (
                statestore.last_good_manifest(name)
                if statestore is not None else None
            )
            if manifest is None or not manifest.get("policies_yaml"):
                raise
            statestore.count_degraded_load()
            logger.error(
                "tenant %s policies read FAILED (%s); booting DEGRADED on "
                "the last-good manifest (epoch %s) — fix the manifest and "
                "reload to clear this", name, e, manifest.get("epoch"),
            )
            t_text = manifest["policies_yaml"]
            t_policies = parse_policies_text(t_text)
        admission = _admission_of(spec)
        shadow = (
            ShadowRecorder(capacity=canary_requests) if reload_enabled else None
        )
        build_batcher = plane_builder(name, admission, spec, shadow)
        t_env = build_environment(t_policies)
        try:
            t_batcher = build_batcher(t_env)
        except BaseException:
            t_env.close()
            raise
        state = TenantState(name=name)
        try:
            if warmup:
                t_batcher.warmup()
            t_batcher.start()
        except BaseException:
            t_batcher.shutdown()
            t_env.close()
            raise
        if reload_enabled:

            def read_policies(path: str = spec.policies_path):
                # the tenant's reload runs under its failpoint scope, so a
                # scoped fault here rejects this tenant's reload only
                failpoints.fire("tenant.reload")
                return read_policies_source(path)

            state.lifecycle = PolicyLifecycleManager(
                state=state,
                build_environment=build_environment,
                build_oracle_environment=build_oracle_environment,
                build_batcher=build_batcher,
                recorder=shadow,
                read_policies=read_policies,
                policies_path=spec.policies_path,
                mode=reload_mode,
                canary_requests=canary_requests,
                divergence_threshold=divergence_threshold,
                warmup=warmup,
                tenant=name,
                statestore=statestore,
                fingerprint=fingerprint,
            )
            state.lifecycle.install_first_epoch(
                t_env, t_batcher, t_policies, policies_yaml=t_text
            )
        else:
            state.evaluation_environment = t_env
            state.batcher = t_batcher
            state.ready = True
        logger.info(
            "tenant serving", extra={"span_fields": {
                "tenant": name,
                "policies": len(t_policies),
                "weight": spec.weight,
                "quota_rows_per_second": spec.quota_rows_per_second,
            }},
        )
        return Tenant(name, spec, state, admission)

    @property
    def context_service(self) -> Any:
        """The ``context.ContextSnapshotService`` when a policy declares
        ``contextAwareResources``, else None."""
        return self._context_service

    def _stop_feeds(self) -> None:
        """Stop the cluster clients a failed boot started: the audit watch
        feed and the context snapshot service."""
        if self._watch_feed is not None:
            self._watch_feed.stop()
        if self._context_service is not None:
            self._context_service.stop()

    @property
    def env(self) -> Any:
        """The serving epoch's environment."""
        return self.state.evaluation_environment

    @property
    def batcher(self) -> MicroBatcher:
        """The serving epoch's batcher."""
        return self.state.batcher

    @property
    def selfheal(self) -> SelfHealWatchdog | None:
        """The self-heal watchdog once serving has started (None when its
        interval is 0)."""
        return self._selfheal

    def _bind_native_frontend(
        self, host: str, port: int, idle_s: float, read_s: float,
        max_connections: int, reuse_port: bool,
        handshake_timeout_seconds: float,
    ) -> None:
        """The native frontend on the API port, built and bound but not
        started (``state.native_frontend``), terminating TLS on its loops
        when the server has a TLS context (``state.native_tls``). Raises
        when the library does not build or load, the port does not bind or,
        with TLS, libssl does not load: no other frontend takes over."""
        sock = nf.make_listen_socket(host, port, reuse_port=reuse_port)
        front = None
        try:
            front = nf.NativeFrontend(
                sock, nf.BatcherSink(self.state),
                idle_timeout_ms=int(idle_s * 1000),
                read_timeout_ms=int(read_s * 1000),
                max_connections=max_connections,
            )
            if self._tls_context is not None:
                if not nf.tls_available():
                    raise RuntimeError(
                        f"native TLS unavailable ({nf.tls_error()}): "
                        "--frontend native cannot terminate TLS here "
                        "(--native-tls off terminates it on the "
                        "standard-library frontend)"
                    )
                reloadable = getattr(self._tls_context, "_reloadable", None)
                if reloadable is None:
                    raise RuntimeError(
                        "TLS context carries no reloadable identity"
                    )
                self.state.native_tls = nf.NativeTlsManager(
                    front, reloadable,
                    handshake_timeout_ms=int(handshake_timeout_seconds * 1000),
                )
        except BaseException:
            if front is not None:
                front.shutdown(timeout=0)  # closes the socket too
            else:
                sock.close()
            raise
        self._native_port = sock.getsockname()[1]
        self.state.native_frontend = front

    def _close_api(self) -> None:
        """Free the API port's frontend (the native one waits for its
        in-flight completions, stops its loops and joins its drainer; its
        TLS manager stops first, so nothing touches a handle mid-free)."""
        if self.state.native_tls is not None:
            self.state.native_tls.stop()
            self.state.native_tls = None
        if self.native_frontend is not None:
            self.native_frontend.shutdown()
            self.state.native_frontend = None
        elif self._httpd is not None:
            self._httpd.server_close()

    def _stop_tls_watch(self) -> None:
        if self.state.tls_reloadable is not None:
            self.state.tls_reloadable.stop()

    @property
    def tls_context(self) -> ssl.SSLContext | None:
        """The API port's TLS context (its ``_reloadable`` is the
        ``certs.ReloadableTlsContext``), or None for plaintext."""
        return self._tls_context

    @property
    def bridge(self) -> EvaluationBridge | None:
        """The evaluation bridge under ``--http-workers`` > 1, once
        started."""
        return self._bridge

    @property
    def worker_procs(self) -> list:
        """The worker slots: a live ``Popen``, a ``_PendingRespawn`` while a
        respawn waits out its backoff, or None for a slot given up."""
        return self._worker_procs

    @property
    def native_frontend(self) -> Any:
        """The NativeFrontend under ``--frontend native``, else None."""
        return self.state.native_frontend

    @property
    def frontend(self) -> str:
        return self._frontend_choice

    @property
    def port(self) -> int:
        if self._httpd is None:
            return self._native_port
        return self._httpd.server_address[1]

    @property
    def readiness_port(self) -> int:
        return self._readiness.server_address[1]

    def _serve_in_background(self, httpd: _HttpServer, name: str) -> None:
        t = threading.Thread(target=httpd.serve_forever, name=name, daemon=True)
        t.start()
        self._threads.append(t)

    def _start_selfheal(self) -> None:
        """The self-heal watchdog and the audit scanner (its boot sweep
        runs on its first pass)."""
        if self._selfheal_interval > 0 and self._selfheal is None:
            self._selfheal = SelfHealWatchdog(
                self.state, self.state.supervisor,
                interval_seconds=self._selfheal_interval,
            ).start()
        if self.state.audit is not None:
            self.state.audit.start()

    def start(self) -> None:
        """Serve both ports in the background (the native frontend on its
        own threads), with the self-heal watchdog, the audit scanner and,
        under ``--http-workers``, the prefork workers."""
        self._start_selfheal()
        if self.native_frontend is not None:
            self.native_frontend.start()
        else:
            self._serve_in_background(self._httpd, "http")
        self._start_workers()
        self._serve_in_background(self._readiness, "readiness")

    def serve_forever(self) -> None:
        """Serve until ``stop()``: the API on this thread (the readiness
        port in the background), or under the native frontend, which runs
        on its own threads, the readiness port on this one."""
        self._start_selfheal()
        if self.native_frontend is not None:
            self.native_frontend.start()
            self._start_workers()
            self._readiness.serve_forever()
            return
        self._start_workers()
        self._serve_in_background(self._readiness, "readiness")
        self._httpd.serve_forever()

    # -- the prefork workers ------------------------------------------------

    _WORKER_RESPAWN_INTERVAL_SECONDS = 2.0
    # a worker that dies within the crash window of its spawn is a
    # crash-loop death: it is respawned after an exponential backoff, and
    # its slot is given up after --worker-respawn-giveup such deaths in a
    # row (a worker that cannot boot would otherwise respawn forever)
    _WORKER_CRASH_WINDOW_SECONDS = 5.0
    _WORKER_BACKOFF_BASE_SECONDS = 0.5
    _WORKER_BACKOFF_CAP_SECONDS = 30.0

    def _start_workers(self) -> None:
        """The evaluation bridge on a unix socket in a private 0700
        directory (a shared /tmp path would let any local user squat the
        name or reach the bridge past the API port's TLS), then the
        ``http_workers - 1`` worker processes on the API port, and their
        supervisor."""
        if not self._prefork or self._bridge is not None:
            return
        self._bridge_dir = tempfile.mkdtemp(prefix="policy-server-bridge-")
        os.chmod(self._bridge_dir, 0o700)
        self._bridge_socket = os.path.join(self._bridge_dir, "bridge.sock")
        self._bridge = EvaluationBridge(self.state, self._bridge_socket).start()
        host, hostname, log_level, log_fmt = self._worker_args
        self._worker_cmd = [
            sys.executable, "-m", "policy_server_tpu_torch.runtime.frontend",
            "--socket", self._bridge_socket,
            "--addr", host,
            "--port", str(self.port),
            "--hostname", hostname,
            "--log-level", log_level,
            # workers log; spans stay in this process
            "--log-fmt", log_fmt if log_fmt != "otlp" else "json",
            "--frontend", self.frontend,
        ]
        if self._compilation_cache_dir:
            # a native worker builds its frontend where this process does
            self._worker_cmd += [
                "--compilation-cache-dir", self._compilation_cache_dir
            ]
        for _ in range(self._http_workers - 1):
            self._worker_procs.append(subprocess.Popen(self._worker_cmd))
        logger.info(
            "prefork HTTP frontend started",
            extra={"span_fields": {
                "workers": self._http_workers, "bridge": self._bridge_socket,
            }},
        )
        self._worker_supervisor = threading.Thread(
            target=self._supervise_workers, name="worker-supervisor",
            daemon=True,
        )
        self._worker_supervisor.start()

    def _supervise_workers(self) -> None:
        """Respawn dead workers every 2 s (a dead one otherwise shrinks
        the port's accept pool until restart), with the crash-loop backoff
        and the give-up breaker (``SupervisorStats`` counts both)."""
        giveup = self._worker_respawn_giveup
        supervisor = self.state.supervisor
        n = len(self._worker_procs)
        spawned_at = [time.monotonic()] * n
        fast_deaths = [0] * n
        respawn_at = [0.0] * n
        while not self._worker_stop.wait(self._WORKER_RESPAWN_INTERVAL_SECONDS):
            now = time.monotonic()
            procs = self._worker_procs
            for i, proc in enumerate(list(procs)):
                if (
                    proc is None
                    or isinstance(proc, _PendingRespawn)
                    or proc.poll() is None
                ):
                    continue
                lifetime = now - spawned_at[i]
                if lifetime < self._WORKER_CRASH_WINDOW_SECONDS:
                    fast_deaths[i] += 1
                else:
                    fast_deaths[i] = 0
                if fast_deaths[i] >= giveup:
                    logger.error(
                        "frontend worker slot %d crash-looped %d times "
                        "within %.1fs of spawn (rc=%s); giving up on the "
                        "slot — the remaining processes keep serving",
                        i, fast_deaths[i], self._WORKER_CRASH_WINDOW_SECONDS,
                        proc.returncode,
                    )
                    procs[i] = None
                    supervisor.count_slot_given_up()
                    continue
                backoff = 0.0
                if fast_deaths[i]:
                    backoff = min(
                        self._WORKER_BACKOFF_CAP_SECONDS,
                        self._WORKER_BACKOFF_BASE_SECONDS
                        * 2 ** (fast_deaths[i] - 1),
                    )
                respawn_at[i] = now + backoff
                logger.warning(
                    "frontend worker died (rc=%s, lived %.1fs); respawning "
                    "in %.1fs (consecutive fast deaths: %d)",
                    proc.returncode, lifetime, backoff, fast_deaths[i],
                )
                procs[i] = _PendingRespawn(proc.returncode)
                supervisor.count_respawn(backoff)
            for i, proc in enumerate(list(procs)):
                if (
                    isinstance(proc, _PendingRespawn)
                    and now >= respawn_at[i]
                    and not self._worker_stop.is_set()
                ):
                    procs[i] = subprocess.Popen(self._worker_cmd)
                    spawned_at[i] = time.monotonic()

    def _stop_workers(self) -> None:
        """The supervisor, then the workers (SIGTERM, SIGKILL after 5 s),
        the bridge, its socket and its directory."""
        self._worker_stop.set()
        if self._worker_supervisor is not None:
            self._worker_supervisor.join(timeout=10)
            self._worker_supervisor = None
        live = [
            p for p in self._worker_procs
            if p is not None and not isinstance(p, _PendingRespawn)
        ]
        for proc in live:
            with contextlib.suppress(ProcessLookupError):
                proc.terminate()
        for proc in live:
            try:
                proc.wait(5)
            except subprocess.TimeoutExpired:
                # no orphan may keep a share of the port
                with contextlib.suppress(ProcessLookupError):
                    proc.kill()
                proc.wait(5)
        self._worker_procs.clear()
        if self._bridge is not None:
            self._bridge.stop()
            self._bridge = None
        if self._bridge_socket:
            with contextlib.suppress(OSError):
                os.unlink(self._bridge_socket)
            self._bridge_socket = None
        if self._bridge_dir:
            shutil.rmtree(self._bridge_dir, ignore_errors=True)
            self._bridge_dir = None

    def reload_signal(self) -> None:
        """SIGHUP: reload the TLS identity and client CAs
        (``reload_now``, whatever the change detector says) and start a
        background policy reload, of every tenant under ``--tenants``. Each
        keeps its last good state on a failure, and the work runs on daemon
        threads, so this is safe in a signal handler."""
        if self.state.tls_reloadable is not None:
            threading.Thread(
                target=self.state.tls_reloadable.reload_now,
                name="sighup-cert-reload", daemon=True,
            ).start()
        if self.state.tenants is not None:
            self.state.tenants.reload_all("sighup")
        elif self.lifecycle is not None:
            self.lifecycle.request_reload("sighup")

    def stop(self) -> None:
        if self._selfheal is not None:
            # first: threads that are shutting down must not be taken for
            # dead ones and revived
            self._selfheal.stop()
            self._selfheal = None
        if self.native_frontend is not None:
            # stop accepting; in-flight requests are answered below once
            # the batcher's shutdown has delivered them
            self.native_frontend.stop_accepting()
        self._stop_workers()
        for httpd in (self._httpd, self._readiness):
            if httpd is not None:
                httpd.closing.set()  # the audit streams end
                httpd.shutdown()
        for t in self._threads:
            t.join(5)
        if self._watch_feed is not None:
            # the live feed stops before the scanner: events applied into
            # a store nobody sweeps again are dead work
            self._watch_feed.stop()
            self._watch_feed = self.state.audit_watch = None
        if self.state.audit is not None:
            # sweeping stops before the epochs tear down: a sweep racing
            # the batchers' shutdown would only burn its retries
            self.state.audit.shutdown()
        if self.state.tenants is not None:
            # the named tenants first (each lifecycle closes its own
            # epochs); the default tenant follows
            self.state.tenants.shutdown()
        if self.lifecycle is not None:
            # the lifecycle owns every epoch: current, pinned and staged
            self.lifecycle.shutdown()
        else:
            self.batcher.shutdown()
            self.env.close()
        self._close_api()
        self._stop_tls_watch()
        self._readiness.server_close()
        if self._context_service is not None:
            self._context_service.stop()
        if self._recorder is not None and flightrec.recorder() is self._recorder:
            flightrec.install(None)
        # the buffered spans and the last metric state reach the collector
        otlp.shutdown_pipeline()
        if self._distributed:
            self._distributed = False
            mesh_mod.shutdown_distributed()


def _build_environment(
    policies: Mapping[str, Any],
    builder_kwargs: dict,
    mesh: "mesh_mod.MeshSpec | None" = None,
    mesh_dispatch: str = "fused",
    devices: list | None = None,
) -> Any:
    """Build an evaluation environment, honouring ``mesh`` and
    ``mesh_dispatch`` as the JAX package's ``_build_environment``:

    * a policy axis > 1 under ``--mesh-dispatch threaded``: a
      :class:`PolicyShardedEvaluator`, one environment per policy shard on
      its row of the mesh, the shards of a batch dispatched from a thread
      pool;
    * otherwise, over more than one device, the mesh is attached
      (``attach_mesh``: the data axis, and under a policy axis > 1 the
      fused (data × policy) form);
    * on one device (``auto`` on one card) the plain environment.

    ``devices`` is the mesh's device list (default: the cards, or the
    process group's global list; one CPU entry under ``device="cpu"``)."""
    builder = EvaluationEnvironmentBuilder(**builder_kwargs)
    spec = mesh or mesh_mod.MeshSpec()
    if builder.backend == "torch":
        grid = mesh_mod.make_mesh(
            spec, devices=devices, device_type=builder.device.type
        )
        if spec.policy_size() > 1 and mesh_dispatch == "threaded":
            shard_kwargs = dict(builder_kwargs)
            sharded = PolicyShardedEvaluator(
                policies, grid,
                backend=shard_kwargs.pop("backend", "torch"),
                continue_on_errors=shard_kwargs.pop("continue_on_errors", False),
                builder_kwargs=shard_kwargs,
            )
            logger.info(
                "policy-sharded mesh attached (threaded MPMD fallback)",
                extra={"span_fields": {
                    "mesh": dict(spec.axes),
                    "shards": len(sharded.shards),
                }},
            )
            return sharded
    environment = builder.build(dict(policies))
    if builder.backend == "torch" and grid.size > 1:
        try:
            environment.attach_mesh(grid)
        except BaseException:
            environment.close()
            raise
        logger.info(
            "fused SPMD mesh attached",
            extra={"span_fields": {
                "mesh": dict(spec.axes),
                "devices": grid.size,
                "policy_sharded": bool(environment._mesh_buckets),
            }},
        )
    return environment


def _needs_fetch(policies: Mapping[str, Any]) -> bool:
    """True when a module URL of the policies is not a builtin."""
    urls: list[str] = []
    for entry in policies.values():
        if hasattr(entry, "module"):
            urls.append(entry.module)
        else:
            urls.extend(m.module for m in entry.policies.values())
    return any(resolve_builtin(u) is None for u in urls)


def _build_context_service(
    policies: Mapping[str, Any], refresh_seconds: float, watch: bool,
    insecure_skip_tls_verify: bool, ignore_connection_failure: bool,
) -> Any:
    """The context snapshot service (reference kube::Client bootstrap,
    lib.rs:91-125), started, when some policy declares
    ``contextAwareResources``, else None. A connection failure fails the
    boot unless ``ignore_connection_failure`` (lib.rs:106-123): context-
    aware policies then see an empty cluster."""
    wanted: set = set()
    for entry in policies.values():
        if hasattr(entry, "context_aware_resources"):
            wanted |= set(entry.context_aware_resources)
        elif hasattr(entry, "policies"):
            for member in entry.policies.values():
                wanted |= set(member.context_aware_resources)
    if not wanted:
        return None
    from policy_server_tpu_torch.context import (
        ContextSnapshotService,
        KubeApiFetcher,
        KubeConnectionError,
        StaticContextFetcher,
    )

    try:
        fetcher = KubeApiFetcher(
            insecure_skip_tls_verify=insecure_skip_tls_verify
        )
    except KubeConnectionError as e:
        if not ignore_connection_failure:
            raise RuntimeError(
                f"cannot connect to the Kubernetes API: {e} "
                "(use --ignore-kubernetes-connection-failure to boot anyway)"
            ) from e
        logger.error(
            "Kubernetes connection failed, context-aware policies will see "
            "an empty cluster: %s", e,
        )
        fetcher = StaticContextFetcher()
    return ContextSnapshotService(
        fetcher,
        wanted,
        refresh_seconds=refresh_seconds,
        # None = auto (watch when the fetcher supports it); False = forced
        # poll mode via --context-no-watch
        watch=None if watch else False,
    ).start()


def _build_audit_watch_feed(
    snapshot: SnapshotStore, resources: str, refresh_seconds: float,
    max_queue_events: int, insecure_skip_tls_verify: bool,
    ignore_connection_failure: bool, statestore: Any = None,
    spill_interval_seconds: float = 30.0, resume: dict | None = None,
) -> Any:
    """``--audit-watch``: the in-cluster list+watch client feeding the
    audit snapshot store, started; with a state store it spills the
    snapshot on its cadence and resumes from a warm boot's cursors
    (``resume``: the audit spill's ``rvs`` and ``fed``). A connection
    failure fails the boot unless ``ignore_connection_failure``, which
    leaves the store to the /validate traffic and the seed file (None)."""
    from policy_server_tpu_torch.context import KubeApiFetcher, KubeConnectionError

    kinds = parse_watch_resources(resources)
    try:
        fetcher = KubeApiFetcher(
            insecure_skip_tls_verify=insecure_skip_tls_verify
        )
    except KubeConnectionError as e:
        if not ignore_connection_failure:
            raise RuntimeError(
                f"--audit-watch cannot connect to the Kubernetes API: {e} "
                "(use --ignore-kubernetes-connection-failure to boot "
                "without the live feed)"
            ) from e
        logger.error(
            "Kubernetes connection failed; the audit snapshot store "
            "falls back to /validate dirty-tracking and the seed file: "
            "%s", e,
        )
        return None
    return WatchFeed(
        fetcher, kinds, snapshot,
        refresh_seconds=refresh_seconds,
        max_queue_events=max_queue_events,
        statestore=statestore,
        spill_interval_seconds=spill_interval_seconds,
        resume_rvs=(resume or {}).get("rvs"),
        resume_fed=(resume or {}).get("fed"),
    ).start()


class _PendingRespawn:
    """A worker slot whose respawn waits out its backoff."""

    __slots__ = ("returncode",)

    def __init__(self, returncode: int | None):
        self.returncode = returncode
