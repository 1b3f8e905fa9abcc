"""Evaluation metrics — Kubewarden's two instruments under their own names
and label schema, and the serving runtime's families, on a Prometheus pull
endpoint (``GET /metrics`` on the readiness port).

Counterpart of ``policy_server_tpu/telemetry/metrics.py``: the same family
names, label keys, units, buckets and registry API. The exposition (text
format 0.0.4) is written here with the standard library, since the card's
machine has no ``prometheus_client``: counters as ``<name>_total``, gauges
bare, histograms as ``_bucket{le=...}`` (cumulative), ``_count`` and
``_sum``. No ``_created`` samples are written.

Label structs:

* ``PolicyEvaluation`` — policy_name, policy_mode, resource_kind,
  resource_namespace?, resource_request_operation, accepted, mutated,
  request_origin, error_code?
* ``RawPolicyEvaluation`` — policy_name, policy_mode, accepted, mutated,
  error_code? (the resource labels empty, request_origin ``validate_raw``)
* ``PolicyInitializationError`` — policy_name, initialization_error
"""

from __future__ import annotations

import bisect
import collections
import math
import threading
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Mapping

METER_NAME = "kubewarden"
# Kubewarden's instruments
EVALUATIONS_TOTAL = "kubewarden_policy_evaluations_total"
LATENCY_MILLISECONDS = "kubewarden_policy_evaluation_latency_milliseconds"
INIT_ERRORS_TOTAL = "kubewarden_policy_initialization_errors_total"

# Serving-runtime families, read on each scrape from the provider the
# server attaches (attach_runtime_stats). The names are the JAX
# package's, those of subsystems the port has not got included; the
# server emits only the families whose source it has, and the audit,
# matrix and watch families at every flag setting.
BATCHES_DISPATCHED = "policy_server_batches_dispatched"
REQUESTS_DISPATCHED = "policy_server_requests_dispatched"
DEADLINE_ABANDONED_BATCHES = "policy_server_deadline_abandoned_batches"
QUEUE_DEPTH = "policy_server_queue_depth"
ORACLE_FALLBACKS = "policy_server_oracle_fallbacks"
HOST_FASTPATH_BATCHES = "policy_server_host_fastpath_batches"
HOST_FASTPATH_REQUESTS = "policy_server_host_fastpath_requests"
DEDUP_BLOB_HITS = "policy_server_dedup_blob_hits"
DEDUP_BLOB_MISSES = "policy_server_dedup_blob_misses"
VERDICT_CACHE_HITS = "policy_server_verdict_cache_hits"
VERDICT_CACHE_MISSES = "policy_server_verdict_cache_misses"
VERDICT_CACHE_BYTES = "policy_server_verdict_cache_bytes"
BATCH_DEDUP_HITS = "policy_server_batch_dedup_hits"
FRAGMENT_HITS = "policy_server_fragment_hits"
BUDGET_ROUTED_BATCHES = "policy_server_budget_routed_batches"
SHED_REQUESTS = "policy_server_shed_requests"
EXPIRED_DROPPED = "policy_server_expired_dropped_rows"
DEGRADED_RESPONSES = "policy_server_degraded_responses"
BREAKER_OPEN_SHARDS = "policy_server_breaker_open_shards"
BREAKER_TRIPS = "policy_server_breaker_trips"
BREAKER_RECOVERIES = "policy_server_breaker_recoveries"
BREAKER_PROBES = "policy_server_breaker_probes"
BREAKER_SHORT_CIRCUITED = "policy_server_breaker_short_circuited_requests"
FETCH_RETRY_ATTEMPTS = "policy_server_fetch_retry_attempts"
FETCH_RETRY_GIVEUPS = "policy_server_fetch_retry_giveups"
POLICY_RELOADS = "policy_server_policy_reloads"
POLICY_RELOAD_FAILURES = "policy_server_policy_reload_failures"
POLICY_RELOAD_ROLLBACKS = "policy_server_policy_reload_rollbacks"
RELOAD_CANARY_REPLAYS = "policy_server_reload_canary_replays"
RELOAD_CANARY_DIVERGENCES = "policy_server_reload_canary_divergences"
POLICY_EPOCH = "policy_server_policy_epoch"
WORKER_RESPAWNS = "policy_server_worker_respawns"
WORKER_RESPAWN_BACKOFF_SECONDS = (
    "policy_server_worker_respawn_backoff_seconds_total"
)
WORKER_SLOTS_GIVEN_UP = "policy_server_worker_slots_given_up"
SELFHEAL_BATCHER_REVIVES = "policy_server_selfheal_batcher_revives"
SELFHEAL_FRONTEND_REVIVES = "policy_server_selfheal_frontend_revives"
# TLS termination (certs.py, runtime/native_frontend.NativeTlsManager): the
# identity's expiry, the native loops' handshake outcomes (zero under the
# standard-library terminator and plaintext), and the rotation counters
TLS_CERT_EXPIRY_SECONDS = "policy_server_tls_cert_expiry_seconds"
TLS_HANDSHAKES_OK = "policy_server_tls_handshakes_ok"
TLS_HANDSHAKES_FAILED = "policy_server_tls_handshakes_failed"
TLS_HANDSHAKE_TIMEOUTS = "policy_server_tls_handshake_timeouts"
TLS_HANDSHAKE_DISCONNECTS = "policy_server_tls_handshake_disconnects"
TLS_CLEAN_CLOSES = "policy_server_tls_clean_closes"
TLS_GENERATIONS = "policy_server_tls_generations"
TLS_RELOADS = "policy_server_tls_reloads"
TLS_RELOAD_FAILURES = "policy_server_tls_reload_failures"
TLS_NATIVE_TERMINATION = "policy_server_tls_native_termination"
AUDIT_ROWS_SCANNED = "policy_server_audit_rows_scanned"
AUDIT_BATCHES_DISPATCHED = "policy_server_audit_batches_dispatched"
AUDIT_PREEMPTIONS = "policy_server_audit_preemptions"
AUDIT_LANE_DEPTH = "policy_server_audit_lane_depth"
AUDIT_FULL_SWEEPS = "policy_server_audit_full_sweeps"
AUDIT_DIRTY_SWEEPS = "policy_server_audit_dirty_sweeps"
AUDIT_SWEEP_ERRORS = "policy_server_audit_sweep_errors"
AUDIT_PAUSED_SWEEPS = "policy_server_audit_paused_sweeps"
AUDIT_REPORT_FRESHNESS = "policy_server_audit_report_freshness_seconds"
AUDIT_REPORTS_RESIDENT = "policy_server_audit_reports_resident"
AUDIT_REPORTS_STALE = "policy_server_audit_reports_stale"
AUDIT_SNAPSHOT_RESOURCES = "policy_server_audit_snapshot_resources"
AUDIT_SNAPSHOT_BYTES = "policy_server_audit_snapshot_bytes"
NATIVE_HTTP_REQUESTS = "policy_server_native_http_requests"
NATIVE_PARSE_FALLBACKS = "policy_server_native_parse_fallbacks"
NATIVE_RING_FULL = "policy_server_native_ring_full_rejections"
NATIVE_VERDICTS_SERIALIZED = "policy_server_native_serialized_verdicts"
NATIVE_PYTHON_SERIALIZED = "policy_server_native_python_serialized_responses"
NATIVE_FRAMING_SECONDS = "policy_server_native_framing_seconds_total"
NATIVE_INFLIGHT = "policy_server_native_inflight_requests"
QUEUE_WAIT_SECONDS = "policy_server_queue_wait_seconds_total"
HOST_ENCODE_SECONDS = "policy_server_host_encode_seconds_total"
HOST_ENCODE_ROWS = "policy_server_host_encode_rows_total"
HOST_BOOKKEEPING_SECONDS = "policy_server_host_bookkeeping_seconds_total"
DISPATCH_WAIT_SECONDS = "policy_server_dispatch_wait_seconds_total"
DISPATCHED_ROWS = "policy_server_dispatched_rows_total"
BULK_SUBMITS = "policy_server_bulk_submits"
BULK_SUBMITTED_ROWS = "policy_server_bulk_submitted_rows"
WIRE_BYTES_SHIPPED = "policy_server_wire_bytes_shipped"
WIRE_BYTES_PACKED_EQUIV = "policy_server_wire_bytes_packed_equivalent"
WIRE_ROWS = "policy_server_wire_rows"
DELTA_COLS_SHIPPED = "policy_server_delta_columns_shipped"
DELTA_COLS_TOTAL = "policy_server_delta_columns_available"
DONATED_DISPATCHES = "policy_server_donated_buffer_dispatches"
RESIDENT_CONST_BYTES = "policy_server_device_resident_constant_bytes"
WATCH_EVENTS_APPLIED = "policy_server_audit_watch_events_applied"
WATCH_EVENTS_DROPPED = "policy_server_audit_watch_events_dropped"
WATCH_RESYNCS = "policy_server_audit_watch_resyncs"
NATIVE_IDLE_CLOSES = "policy_server_native_idle_timeout_closes"
NATIVE_CONN_CAP_REJECTS = "policy_server_native_connection_cap_rejections"
TENANT_SHED_ROWS = "policy_server_tenant_shed_rows"
TENANT_ADMITTED_ROWS = "policy_server_tenant_admitted_rows"
TENANT_INFLIGHT_ROWS = "policy_server_tenant_inflight_rows"
TENANT_QUEUE_DEPTH = "policy_server_tenant_queue_depth"
TENANT_DISPATCH_GRANTS = "policy_server_tenant_dispatch_grants"
TENANT_DISPATCH_WAIT_SECONDS = (
    "policy_server_tenant_dispatch_wait_seconds_total"
)
TENANT_EPOCH = "policy_server_tenant_policy_epoch"
TENANT_ROLLBACKS = "policy_server_tenant_reload_rollbacks"
TENANT_READY = "policy_server_tenant_ready"
TENANTS_SERVING = "policy_server_tenants_serving"
SHARDS_SERVING = "policy_server_shards_serving"
SHARD_HEALTHY = "policy_server_shard_healthy"
SHARD_QUEUE_DEPTH = "policy_server_shard_queue_depth"
SHARD_FENCES = "policy_server_shard_fences"
SHARD_REROUTED_ROWS = "policy_server_shard_rerouted_rows"
SHARD_FENCED_ROWS = "policy_server_shard_fenced_rows"
SHARD_RESPAWNS = "policy_server_shard_respawns"
SHARD_HEARTBEAT_FAULTS = "policy_server_shard_heartbeat_faults"
SOAK_WINDOW_RPS = "policy_server_soak_window_rps"
SOAK_WINDOW_P99_MS = "policy_server_soak_window_p99_ms"
SOAK_WINDOW_SHED_RATE = "policy_server_soak_window_shed_rate"
PREDICATE_SUBTREES_SHARED = "policy_server_predicate_subtrees_shared"
PREDICATE_POLICIES_FOLDED = "policy_server_predicate_policies_folded"
PREDICATE_RULES_FOLDED = "policy_server_predicate_rules_folded"
PREDICATE_FIELDS_PRUNED = "policy_server_predicate_fields_pruned"
PREDICATE_ROW_BYTES_SAVED = "policy_server_predicate_row_bytes_saved"
PALLAS_DISPATCHES = "policy_server_pallas_dispatches"
PALLAS_BUCKETS_ARMED = "policy_server_pallas_buckets_armed"

# the verdict matrix's families (audit/matrix.py), with lookup admission's
MATRIX_ROWS_RESIDENT = "policy_server_audit_matrix_rows_resident"
MATRIX_CELLS_RESIDENT = "policy_server_audit_matrix_cells_resident"
MATRIX_COLUMNS = "policy_server_audit_matrix_columns"
MATRIX_DIRTY_COLUMNS = "policy_server_audit_matrix_dirty_columns"
MATRIX_VERSION = "policy_server_audit_matrix_version"
MATRIX_ROW_SWEEP_ROWS = "policy_server_audit_matrix_row_sweep_rows"
MATRIX_COLUMN_SWEEP_ROWS = "policy_server_audit_matrix_column_sweep_rows"
MATRIX_ROWS_EVICTED = "policy_server_audit_matrix_rows_evicted"
MATRIX_COLUMNS_INVALIDATED = "policy_server_audit_matrix_columns_invalidated"
MATRIX_CHANGELOG_EMITS = "policy_server_audit_matrix_changelog_emits"
MATRIX_STREAM_CLIENTS = "policy_server_audit_matrix_stream_clients"
MATRIX_STREAM_DROPPED_CLIENTS = (
    "policy_server_audit_matrix_stream_dropped_clients"
)
MATRIX_LOOKUP_HITS = "policy_server_audit_matrix_lookup_hits"
MATRIX_LOOKUP_MISSES = "policy_server_audit_matrix_lookup_misses"
MATRIX_SPILLS = "policy_server_audit_matrix_spills"
MATRIX_CELLS_RESTORED = "policy_server_audit_matrix_cells_restored"

# flight recorder (telemetry/flightrec.py): the per-phase histogram, the
# tail-exemplar gauges and the recorder's own volume counters
PHASE_LATENCY_SECONDS = "policy_server_phase_latency_seconds"
TAIL_EXEMPLAR_LATENCY_SECONDS = "policy_server_tail_exemplar_latency_seconds"
FLIGHT_RECORDER_EVENTS = "policy_server_flight_recorder_events"
FLIGHT_RECORDER_ROWS_SAMPLED = "policy_server_flight_recorder_rows_sampled"

# The port's own family (no JAX-package counterpart): kernel and CUDA
# errors at dispatch or fetch, each of which failed its batch's requests
# and none of which fed the breaker (``env.device_errors``).
DEVICE_ERRORS = "policy_server_device_errors"

# Prometheus requires a fixed label set per metric family; optional
# labels (resource_namespace, error_code) encode absence as "".
_EVAL_LABELS = (
    "policy_name",
    "policy_mode",
    "resource_kind",
    "resource_namespace",
    "resource_request_operation",
    "accepted",
    "mutated",
    "request_origin",
    "error_code",
)
_INIT_LABELS = ("policy_name", "initialization_error")

# Millisecond buckets from 0.1 ms up to past the 2 s policy deadline.
_LATENCY_BUCKETS_MS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
)

# Second buckets for the per-phase histogram (flight recorder): phases
# span ~10 µs (bookkeeping on a warm batch) to ~100 ms (a cold device
# dispatch), so the grid is log-spaced across five decades.
_PHASE_BUCKETS_S = (
    25e-6, 50e-6, 100e-6, 250e-6, 500e-6, 1e-3, 2.5e-3, 5e-3,
    10e-3, 25e-3, 50e-3, 100e-3, 250e-3, 1.0,
)

# the registry's own families: (name, type, help, label keys, buckets)
_FAMILIES = (
    (EVALUATIONS_TOTAL, "counter", "Number of policy evaluations",
     _EVAL_LABELS, None),
    (LATENCY_MILLISECONDS, "histogram",
     "Policy evaluation latency in milliseconds", _EVAL_LABELS,
     _LATENCY_BUCKETS_MS),
    (INIT_ERRORS_TOTAL, "counter",
     "Number of policies that failed to initialize", _INIT_LABELS, None),
    (PHASE_LATENCY_SECONDS, "histogram",
     "Per-batch serving-phase latency in seconds (flight recorder)",
     ("phase",), _PHASE_BUCKETS_S),
)
_BUCKETS = {name: b for name, _t, _h, _l, b in _FAMILIES if b is not None}


def _b(v: bool) -> str:
    return "true" if v else "false"


@dataclass(frozen=True)
class PolicyEvaluation:
    policy_name: str
    policy_mode: str
    resource_kind: str
    resource_namespace: str | None
    resource_request_operation: str
    accepted: bool
    mutated: bool
    request_origin: str
    error_code: int | None = None

    def labels(self) -> dict[str, str]:
        return {
            "policy_name": self.policy_name,
            "policy_mode": self.policy_mode,
            "resource_kind": self.resource_kind,
            "resource_namespace": self.resource_namespace or "",
            "resource_request_operation": self.resource_request_operation,
            "accepted": _b(self.accepted),
            "mutated": _b(self.mutated),
            "request_origin": self.request_origin,
            "error_code": "" if self.error_code is None else str(self.error_code),
        }


@dataclass(frozen=True)
class RawPolicyEvaluation:
    policy_name: str
    policy_mode: str
    accepted: bool
    mutated: bool
    error_code: int | None = None

    def labels(self) -> dict[str, str]:
        return {
            "policy_name": self.policy_name,
            "policy_mode": self.policy_mode,
            "resource_kind": "",
            "resource_namespace": "",
            "resource_request_operation": "",
            "accepted": _b(self.accepted),
            "mutated": _b(self.mutated),
            "request_origin": "validate_raw",
            "error_code": "" if self.error_code is None else str(self.error_code),
        }


@dataclass(frozen=True)
class PolicyInitializationError:
    policy_name: str
    initialization_error: str

    def labels(self) -> dict[str, str]:
        return {
            "policy_name": self.policy_name,
            "initialization_error": self.initialization_error,
        }


# -- text format 0.0.4 ------------------------------------------------------


def _go_float(value: float) -> str:
    """A sample value or bucket bound as Prometheus writes it (Go's float
    formatting: ``+Inf``, ``NaN``, exponents from 1e+07 up)."""
    d = float(value)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(value: str) -> str:
    return (
        value.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")
    )


def _sample(name: str, labels: Iterable[tuple[str, str]], value: float) -> str:
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in sorted(labels))
    return f"{name}{{{body}}} {_go_float(value)}\n" if body else (
        f"{name} {_go_float(value)}\n"
    )


def _header(name: str, kind: str, help_text: str) -> str:
    doc = help_text.replace("\\", r"\\").replace("\n", r"\n")
    return f"# HELP {name} {doc}\n# TYPE {name} {kind}\n"


def _family_name(name: str, kind: str) -> str:
    """The name a family's header and samples use: a counter's is
    ``<base>_total`` whether or not its constant carries the suffix."""
    if kind != "counter":
        return name
    return name if name.endswith("_total") else name + "_total"


class MetricsRegistry:
    """Thread-safe metrics sink: counters, latency histograms and a
    bounded window of recent latency samples per label set (the test
    surface), all under one lock, plus the serving runtime's families
    read on each scrape from the attached provider."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (family, sorted label items) → value
        self._counters: dict[tuple[str, tuple], float] = {}  # guarded-by: _lock
        # (family, sorted label items) → per-bucket counts (the last one
        # past the largest bound) followed by the sum
        self._hists: dict[tuple[str, tuple], list[float]] = {}  # guarded-by: _lock
        self._latencies: dict[tuple, collections.deque[float]] = {}  # guarded-by: _lock
        # metric dataclass → sorted label key, computed once per distinct
        # label combination (dict assignment is atomic under the GIL;
        # racing builders store equal keys)
        self._resolved: dict[object, tuple] = {}
        self._runtime_stats_fn: Callable[[], Iterable[tuple]] | None = None

    def _key(self, m: Any) -> tuple:
        key = self._resolved.get(m)
        if key is None:
            key = self._resolved[m] = tuple(sorted(m.labels().items()))
        return key

    def _observe_locked(self, family: str, key: tuple, value: float) -> None:
        # holds: _lock
        buckets = _BUCKETS[family]
        slot = self._hists.get((family, key))
        if slot is None:
            slot = self._hists[(family, key)] = [0.0] * (len(buckets) + 2)
        slot[bisect.bisect_left(buckets, value)] += 1
        slot[-1] += value

    # -- recording ---------------------------------------------------------

    def add_policy_evaluation(
        self, m: PolicyEvaluation | RawPolicyEvaluation
    ) -> None:
        ck = (EVALUATIONS_TOTAL, self._key(m))
        with self._lock:
            self._counters[ck] = self._counters.get(ck, 0) + 1

    def record_policy_latency(
        self, milliseconds: float, m: PolicyEvaluation | RawPolicyEvaluation
    ) -> None:
        key = self._key(m)
        with self._lock:
            self._latencies.setdefault(
                key, collections.deque(maxlen=4096)
            ).append(milliseconds)
            self._observe_locked(LATENCY_MILLISECONDS, key, milliseconds)

    def record_evaluations_batch(
        self,
        pairs: list[tuple[float, PolicyEvaluation | RawPolicyEvaluation]],
    ) -> None:
        """Batch form of add_policy_evaluation + record_policy_latency for
        the batcher's phase 3: one lock acquisition per batch."""
        groups: dict[object, list[float]] = {}
        for ms, m in pairs:
            groups.setdefault(m, []).append(ms)
        keyed = [(self._key(m), vals) for m, vals in groups.items()]
        with self._lock:
            for key, vals in keyed:
                ck = (EVALUATIONS_TOTAL, key)
                self._counters[ck] = self._counters.get(ck, 0) + len(vals)
                self._latencies.setdefault(
                    key, collections.deque(maxlen=4096)
                ).extend(vals)
                for v in vals:
                    self._observe_locked(LATENCY_MILLISECONDS, key, v)

    def add_policy_initialization_error(
        self, m: PolicyInitializationError
    ) -> None:
        ck = (INIT_ERRORS_TOTAL, tuple(sorted(m.labels().items())))
        with self._lock:
            self._counters[ck] = self._counters.get(ck, 0) + 1

    def observe_phase(self, phase: str, seconds: float) -> None:
        """One flight-recorder phase observation: one lock acquisition per
        batch per phase."""
        with self._lock:
            self._observe_locked(
                PHASE_LATENCY_SECONDS, (("phase", phase),), seconds
            )

    def attach_runtime_stats(self, snapshot_fn) -> None:
        """Install (or replace) the serving-runtime stats provider:
        ``snapshot_fn() -> [(name, 'counter'|'gauge', help, value), ...]``;
        a labelled family yields ``(name, kind, help, [(label_values,
        value), ...], label_keys)``. Called by the server with a closure
        over its batcher and environment."""
        self._runtime_stats_fn = snapshot_fn

    # -- exposition ----------------------------------------------------------

    def exposition(self) -> bytes:
        """Prometheus text format 0.0.4 for the /metrics endpoint."""
        out: list[str] = []
        fn = self._runtime_stats_fn
        for item in fn() if fn is not None else ():
            name, kind, help_text, value = item[:4]
            fam = _family_name(name, kind)
            out.append(_header(fam, kind, help_text))
            if len(item) > 4:
                keys = item[4]
                for label_values, v in value:
                    out.append(
                        _sample(fam, zip(keys, map(str, label_values)), v)
                    )
            else:
                out.append(_sample(fam, (), value))
        with self._lock:
            counters = dict(self._counters)
            hists = {k: list(v) for k, v in self._hists.items()}
        for name, kind, help_text, _keys, buckets in _FAMILIES:
            fam = _family_name(name, kind)
            out.append(_header(fam, kind, help_text))
            if kind == "counter":
                for (family, key), v in sorted(counters.items()):
                    if family == name:
                        out.append(_sample(fam, key, v))
                continue
            for (family, key), slot in sorted(hists.items()):
                if family != name:
                    continue
                running = 0.0
                for bound, n in zip((*buckets, math.inf), slot[:-1]):
                    running += n
                    out.append(
                        _sample(
                            f"{fam}_bucket", key + (("le", _go_float(bound)),),
                            running,
                        )
                    )
                out.append(_sample(f"{fam}_count", key, running))
                out.append(_sample(f"{fam}_sum", key, slot[-1]))
        return "".join(out).encode()

    # -- test/introspection surface ----------------------------------------

    def counter_value(
        self, name: str, match: Mapping[str, str] | None = None
    ) -> float:
        with self._lock:
            total = 0.0
            for (metric, key), v in self._counters.items():
                if metric != name:
                    continue
                labels = dict(key)
                if match and any(labels.get(k) != v2 for k, v2 in match.items()):
                    continue
                total += v
            return total

    def latency_samples(self, match: Mapping[str, str] | None = None) -> list[float]:
        with self._lock:
            out: list[float] = []
            for key, vals in self._latencies.items():
                labels = dict(key)
                if match and any(labels.get(k) != v for k, v in match.items()):
                    continue
                out.extend(vals)
            return out


_default: MetricsRegistry | None = None
_default_lock = threading.Lock()


def setup_metrics() -> MetricsRegistry:
    """Install (or return) the process-wide registry."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default


def default_registry() -> MetricsRegistry:
    return setup_metrics()


def reset_metrics_for_tests() -> None:
    global _default
    with _default_lock:
        _default = None


def add_policy_evaluation(m: PolicyEvaluation | RawPolicyEvaluation) -> None:
    default_registry().add_policy_evaluation(m)


def record_policy_latency(
    milliseconds: float, m: PolicyEvaluation | RawPolicyEvaluation
) -> None:
    default_registry().record_policy_latency(milliseconds, m)


def add_policy_initialization_error(m: PolicyInitializationError) -> None:
    default_registry().add_policy_initialization_error(m)
