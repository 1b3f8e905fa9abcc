"""Shared API server state, and the readiness verdict both HTTP ports'
handlers read.

The environment and batcher fields are the policy lifecycle's epoch
pointer (``lifecycle.py``): a hot reload promotes a new epoch by rebinding
them, and handlers read them per request, so a request racing the flip
lands on one serving epoch or the other."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


def readiness(batcher: Any) -> tuple[int, str]:
    """The /readiness verdict of a serving epoch. 503 while the device
    breaker is open under ``--degraded-mode reject``, as the JAX package's
    (every review would be answered with an in-band 503); otherwise 200.
    Once the breaker has tripped, or a kernel or CUDA error has failed
    requests, the body shows the counts, so host answers in place of the
    device's are never silent."""
    env = batcher.env
    if batcher.degraded_mode == "reject" and env.breaker_all_open:
        return 503, (
            "every device shard breaker is open and --degraded-mode "
            "reject refuses traffic"
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


def readiness_verdict(ready: bool, batcher: Any) -> tuple[int, str]:
    """One tenant's verdict: 503 until its first epoch is built and warmed,
    then its serving epoch's ``readiness`` (200 on last-good during a
    reload)."""
    if not ready:
        return 503, "first policy epoch not yet compiled and warmed"
    return readiness(batcher)


@dataclass
class ApiServerState:
    evaluation_environment: Any
    batcher: Any
    hostname: str = ""
    # routes /debug/pprof/cpu and /debug/pprof/heap on the API port
    enable_pprof: bool = False
    # False until the first policy epoch is built and warmed
    # (lifecycle.install_first_epoch flips it); True for states built
    # directly (tests, embedding)
    ready: bool = True
    # the runtime/native_frontend.NativeFrontend under --frontend native
    native_frontend: Any = None
    # the lifecycle.PolicyLifecycleManager; None under
    # --policy-reload-mode off
    lifecycle: Any = None
    # the bearer token of the /policies/* admin endpoints; None disables
    # them
    admin_token: str | None = None
    # the supervision.SupervisorStats (worker respawns, self-heal revives)
    supervisor: Any = None
    # the tenancy.TenantManager under --tenants (the default tenant
    # included); None serves every URL from this state's epoch pointer
    tenants: Any = None
    # the audit.AuditScanner under --audit-mode interval|on-promote (GET
    # /audit/reports answers 404 without one)
    audit: Any = None
    # the audit.WatchFeed under --audit-watch (None without it, or when the
    # Kubernetes connection failed under
    # --ignore-kubernetes-connection-failure)
    audit_watch: Any = None
    # the audit.VerdictMatrix under --audit-matrix (GET /audit/stream
    # answers 404 without one)
    audit_matrix: Any = None
    # concurrent GET /audit/stream clients; past it a new one gets 503
    audit_stream_max_clients: int = 64
    # the certs.ReloadableTlsContext with --cert-file (the expiry gauge and
    # the reload counters read it, whichever frontend terminates TLS)
    tls_reloadable: Any = None
    # the native_frontend.NativeTlsManager when TLS terminates on the
    # native loops (the generations counter and the termination gauge)
    native_tls: Any = None
    # the statestore.StateStore under --state-dir (the statestore
    # families read its stats; None without it)
    statestore: Any = None
    # how this boot went: warm or cold, time to ready, cache hits,
    # degraded sources (the boot families); written once at boot
    boot_report: Any = None
    # a soak window's {rps, p99_ms, shed_rate}, refreshed by whoever runs
    # a soak in-process; None outside one (the soak gauges read 0)
    soak: Any = None

    def _supervisor_note(self, body: str) -> str:
        """A 200 body names the frontend worker slots that gave up
        respawning, as the JAX package's does."""
        if self.supervisor is None:
            return body
        given_up = self.supervisor.stats().get("worker_slots_given_up", 0)
        if given_up:
            return (
                f"{body} (degraded: {given_up} frontend worker slot(s) "
                "gave up respawning after crash-looping)"
            )
        return body

    def readiness(self) -> tuple[int, str]:
        """Without tenants, this state's ``readiness_verdict``. With
        tenants, 503 only when every tenant is degraded: a partial outage
        keeps the pod in rotation, with the degraded tenants named in the
        200 body (``/readiness/{tenant}`` gives each one's verdict)."""
        if self.tenants is None:
            code, body = readiness_verdict(self.ready, self.batcher)
            return code, (self._supervisor_note(body) if code == 200 else body)
        degraded = self.tenants.degraded_names()
        if not self.tenants.any_ready():
            return 503, "every tenant is degraded: " + ", ".join(degraded)
        if degraded:
            return 200, self._supervisor_note(
                "ok (degraded tenants: " + ", ".join(degraded) + ")"
            )
        return 200, self._supervisor_note("ok")
