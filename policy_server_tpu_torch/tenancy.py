"""Multi-tenant serving: several named policy sets in one process, each
isolated from the others' load and faults (the JAX package's
``tenancy.py``).

* **The manifest** (``--tenants FILE``; JSON always, YAML where PyYAML is
  installed)::

      tenants:
        team-a:
          policies: team-a-policies.json  # relative to the manifest
          weight: 2.0                     # weighted-fair dispatch share
          quota-rows-per-second: 500      # token bucket; 0 = unlimited
          quota-burst: 250                # bucket depth (default: rate)
          max-inflight: 512               # admitted-unanswered cap; 0 = off
          request-timeout-ms: 5000        # this tenant's deadline
          degraded-mode: reject           # this tenant's breaker fallback
      default:                            # knobs of the default tenant
        weight: 1.0
      max-concurrent-dispatches: 4        # FairDispatchScheduler slots

* **A lifecycle per tenant.** Each named tenant has its own
  ``PolicyLifecycleManager`` over its own policies file (digest watch,
  reload, shadow canary with its own ring, rollback), its own environments
  (K1 programs, verdict cache, breaker) and its own batcher, or shard set.
* **Admission quotas.** :class:`TenantAdmission`, a token bucket over rows
  and an in-flight cap, is charged by the tenant's batcher once per
  submission; a denial answers 429 with Retry-After and counts into the
  tenant-labelled shed family, so one tenant's storm sheds at its own door.
* **Weighted-fair dispatch.** Every tenant's batcher shares one
  ``runtime/scheduler.FairDispatchScheduler``.
* **Routing.** ``POST /validate/{tenant}/{policy_id}`` (and the raw and
  audit routes) picks the tenant from the path; every other URL is the
  reserved ``default`` tenant, so a server without a manifest serves as
  before. ``GET /readiness/{tenant}`` is that tenant's verdict; the global
  probe answers 503 only when every tenant is degraded.

Failpoints: ``tenant.reload`` (a tenant's policies read) and
``tenant.admission`` (the quota check's head), both under the tenant's
failpoint scope.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping

from policy_server_tpu_torch import failpoints
from policy_server_tpu_torch.api.state import readiness_verdict
from policy_server_tpu_torch.runtime.batcher import DEGRADED_MODES, ShedError
from policy_server_tpu_torch.telemetry.tracing import logger

#: the reserved tenant every un-prefixed URL routes to
DEFAULT_TENANT = "default"

# names that would shadow literal routes or the reserved default
_RESERVED_TENANT_NAMES = frozenset({DEFAULT_TENANT, "reports", "stream"})


def unknown_tenant_message(name: str) -> str:
    """The one 404 text of an unknown tenant, shared by both frontends."""
    return f"unknown tenant: {name}"


class TenantConfigError(ValueError):
    """Malformed tenants manifest."""


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's parsed manifest entry."""

    name: str
    policies_path: str | None = None  # None only for the default tenant
    weight: float = 1.0
    quota_rows_per_second: float = 0.0  # 0 = unlimited
    quota_burst: float = 0.0  # 0 = one second of rate
    max_inflight: int = 0  # 0 = uncapped
    request_timeout_ms: float | None = None  # None = the server's
    degraded_mode: str | None = None  # None = the server's

    def validate(self) -> None:
        if not self.name or "/" in self.name:
            raise TenantConfigError(
                f"invalid tenant name {self.name!r} (must be non-empty, "
                "no '/')"
            )
        if self.name in _RESERVED_TENANT_NAMES and self.name != DEFAULT_TENANT:
            raise TenantConfigError(
                f"tenant name {self.name!r} is reserved (it would shadow "
                "a literal route)"
            )
        if self.weight <= 0:
            raise TenantConfigError(
                f"tenant {self.name!r}: weight must be > 0"
            )
        if self.quota_rows_per_second < 0 or self.quota_burst < 0:
            raise TenantConfigError(
                f"tenant {self.name!r}: quota values must be >= 0"
            )
        if self.max_inflight < 0:
            raise TenantConfigError(
                f"tenant {self.name!r}: max-inflight must be >= 0"
            )
        if self.degraded_mode is not None and (
            self.degraded_mode not in DEGRADED_MODES
        ):
            raise TenantConfigError(
                f"tenant {self.name!r}: invalid degraded-mode "
                f"{self.degraded_mode!r}"
            )


@dataclass
class TenantManifest:
    """The parsed manifest: the named tenants' specs, the default tenant's
    knobs and the scheduler's slot count."""

    tenants: dict[str, TenantSpec] = field(default_factory=dict)
    default: TenantSpec = field(
        default_factory=lambda: TenantSpec(name=DEFAULT_TENANT)
    )
    max_concurrent_dispatches: int = 4


_SPEC_KEYS = {
    "policies", "weight", "quota-rows-per-second", "quota-burst",
    "max-inflight", "request-timeout-ms", "degraded-mode",
}


def _spec_from_doc(name: str, doc: Mapping, base_dir: Path) -> TenantSpec:
    if not isinstance(doc, Mapping):
        raise TenantConfigError(
            f"tenant {name!r}: entry must be a mapping, got "
            f"{type(doc).__name__}"
        )
    unknown = set(doc) - _SPEC_KEYS
    if unknown:
        raise TenantConfigError(
            f"tenant {name!r}: unknown keys {sorted(unknown)} "
            f"(expected {sorted(_SPEC_KEYS)})"
        )
    policies = doc.get("policies")
    if policies is not None:
        p = Path(policies)
        if not p.is_absolute():
            p = base_dir / p
        policies = str(p)
    rt = doc.get("request-timeout-ms")
    spec = TenantSpec(
        name=name,
        policies_path=policies,
        weight=float(doc.get("weight", 1.0)),
        quota_rows_per_second=float(doc.get("quota-rows-per-second", 0.0)),
        quota_burst=float(doc.get("quota-burst", 0.0)),
        max_inflight=int(doc.get("max-inflight", 0)),
        request_timeout_ms=None if rt is None else float(rt),
        degraded_mode=doc.get("degraded-mode"),
    )
    spec.validate()
    return spec


def _load_document(text: str) -> Any:
    """A manifest's text → its document: YAML where PyYAML is installed
    (JSON is YAML), else JSON, with a clear error for a YAML file."""
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(text)
        except json.JSONDecodeError as e:
            raise TenantConfigError(
                f"tenants file is not JSON ({e}), and reading YAML needs "
                "PyYAML, which is not installed"
            ) from e
    return yaml.safe_load(text)


def read_tenants_file(path: str | Path) -> TenantManifest:
    """Parse a tenants manifest (module docstring). Relative policies
    paths resolve against the manifest's own directory."""
    path = Path(path)
    with open(path, encoding="utf-8") as f:
        doc = _load_document(f.read()) or {}
    if not isinstance(doc, Mapping):
        raise TenantConfigError("tenants file must be a YAML mapping")
    unknown = set(doc) - {"tenants", "default", "max-concurrent-dispatches"}
    if unknown:
        raise TenantConfigError(
            f"unknown top-level keys {sorted(unknown)} in tenants file"
        )
    base_dir = path.resolve().parent
    tenants_doc = doc.get("tenants") or {}
    if not isinstance(tenants_doc, Mapping) or not tenants_doc:
        raise TenantConfigError(
            "tenants file must define at least one tenant under 'tenants:'"
        )
    tenants: dict[str, TenantSpec] = {}
    for name, entry in tenants_doc.items():
        name = str(name)
        if name in _RESERVED_TENANT_NAMES:
            raise TenantConfigError(
                f"tenant name {name!r} is reserved (the default tenant is "
                "configured under the top-level 'default:' key)"
            )
        spec = _spec_from_doc(name, entry or {}, base_dir)
        if spec.policies_path is None:
            raise TenantConfigError(f"tenant {name!r}: 'policies' is required")
        tenants[name] = spec
    default = _spec_from_doc(DEFAULT_TENANT, doc.get("default") or {}, base_dir)
    if default.policies_path is not None:
        raise TenantConfigError(
            "the default tenant's policies come from --policies, not the "
            "tenants manifest"
        )
    cap = int(doc.get("max-concurrent-dispatches", 4))
    if cap < 1:
        raise TenantConfigError("max-concurrent-dispatches must be >= 1")
    return TenantManifest(
        tenants=tenants, default=default, max_concurrent_dispatches=cap
    )


def split_tenant_path(policy_id: str) -> tuple[str | None, str]:
    """``"tenant/policy"`` → ``("tenant", "policy")``; a bare id →
    ``(None, policy_id)``."""
    tenant, sep, rest = policy_id.partition("/")
    if not sep:
        return None, policy_id
    return tenant, rest


def lookup_tenant(state: Any, name: str) -> "Tenant | None":
    """The :class:`Tenant` called ``name``, or None (every name, on a
    server without a manifest)."""
    mgr = state.tenants
    return mgr.get(name) if mgr is not None else None


def resolve_tenant_batcher(state: Any, policy_id: str):
    """A wire policy id (possibly ``"tenant/policy"``) → ``(batcher,
    bare policy id, None)``, or ``(None, bare policy id, unknown tenant
    name)``; the caller answers the 404 with
    :func:`unknown_tenant_message`."""
    tenant, pid = split_tenant_path(policy_id)
    if tenant is None:
        return state.batcher, policy_id, None
    t = lookup_tenant(state, tenant)
    if t is None:
        return None, pid, tenant
    return t.state.batcher, pid, None


class TenantAdmission:
    """A tenant's admission quota: a token bucket over admitted rows
    (refilled at ``rows_per_second`` up to ``burst``) and a cap on rows
    admitted and not yet answered. A denial raises ShedError with the wait
    the refill needs. One instance fronts all of a tenant's shards: a row's
    claim travels with it when a fenced shard's queue is re-routed, and its
    first answer releases it."""

    def __init__(
        self,
        tenant: str,
        rows_per_second: float = 0.0,
        burst: float = 0.0,
        max_inflight: int = 0,
    ) -> None:
        self.tenant = tenant
        self.rate = max(0.0, float(rows_per_second))
        self.burst = float(burst) if burst > 0 else max(1.0, self.rate)
        self.max_inflight = max(0, int(max_inflight))
        self._lock = threading.Lock()
        self._tokens = self.burst  # guarded-by: _lock
        self._refilled_at = time.monotonic()  # guarded-by: _lock
        self._inflight = 0  # guarded-by: _lock
        self._admitted_rows = 0  # guarded-by: _lock
        self._quota_sheds = 0  # guarded-by: _lock
        self._inflight_sheds = 0  # guarded-by: _lock

    def admit(self, n: int = 1) -> None:
        """Admit ``n`` rows or raise ShedError. The ``tenant.admission``
        failpoint fires first, under this tenant's scope (the calling
        handler thread carries none)."""
        with failpoints.scope(self.tenant):
            failpoints.fire("tenant.admission")
        with self._lock:
            if self.max_inflight and self._inflight + n > self.max_inflight:
                self._inflight_sheds += n
                raise ShedError(0.05)
            if self.rate > 0:
                now = time.monotonic()
                self._tokens = min(
                    self.burst,
                    self._tokens + (now - self._refilled_at) * self.rate,
                )
                self._refilled_at = now
                # a burst deeper than the bucket is admitted from a full
                # bucket and leaves a deficit that later admissions repay
                # at ``rate``, so the mean rate stays bounded
                need = min(float(n), self.burst)
                if self._tokens < need:
                    self._quota_sheds += n
                    raise ShedError((need - self._tokens) / self.rate)
                self._tokens -= n
            self._inflight += n
            self._admitted_rows += n

    def release(self, n: int = 1) -> None:
        """Rows admitted earlier were answered; floored at zero."""
        with self._lock:
            self._inflight = max(0, self._inflight - n)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "admitted_rows": self._admitted_rows,
                "quota_sheds": self._quota_sheds,
                "inflight_sheds": self._inflight_sheds,
                "inflight": self._inflight,
                "shed_rows": self._quota_sheds + self._inflight_sheds,
            }


@dataclass
class TenantState:
    """A named tenant's epoch pointer, rebound by its lifecycle on
    promotion and rollback as ``ApiServerState`` is for the default
    tenant."""

    name: str
    evaluation_environment: Any = None
    batcher: Any = None
    ready: bool = False
    lifecycle: Any = None


class Tenant:
    """One tenant: its spec, its epoch pointer (``TenantState``, or the
    server's ``ApiServerState`` for the default tenant) and its quota."""

    def __init__(
        self, name: str, spec: TenantSpec, state: Any,
        admission: TenantAdmission | None,
    ) -> None:
        self.name = name
        self.spec = spec
        self.state = state
        self.admission = admission

    def readiness(self) -> tuple[int, str]:
        """This tenant's own verdict, from its epoch pointer's fields (the
        default tenant's ``ApiServerState.readiness`` is the aggregate)."""
        return readiness_verdict(self.state.ready, self.state.batcher)

    def request_reload(self, reason: str) -> bool:
        lc = self.state.lifecycle
        return lc.request_reload(reason) if lc is not None else False


class TenantManager:
    """The tenant registry (name → :class:`Tenant`, the default included),
    fixed once the server is built."""

    def __init__(self, scheduler: Any = None) -> None:
        self.scheduler = scheduler
        self._tenants: dict[str, Tenant] = {}

    def add(self, tenant: Tenant) -> None:
        self._tenants[tenant.name] = tenant

    def get(self, name: str) -> Tenant | None:
        return self._tenants.get(name)

    def named(self) -> list[Tenant]:
        """Every tenant but the default (whose epochs the server owns)."""
        return [t for t in self._tenants.values() if t.name != DEFAULT_TENANT]

    def all(self) -> list[Tenant]:
        return list(self._tenants.values())

    def any_ready(self) -> bool:
        return any(t.readiness()[0] == 200 for t in self._tenants.values())

    def degraded_names(self) -> list[str]:
        return [
            t.name for t in self._tenants.values() if t.readiness()[0] != 200
        ]

    def reload_all(self, reason: str) -> int:
        """Start a background reload on every tenant with a lifecycle (the
        SIGHUP contract) → how many started."""
        return sum(t.request_reload(reason) for t in self._tenants.values())

    def shutdown(self) -> None:
        """Tear down every named tenant's epochs (the server shuts the
        default tenant's down itself)."""
        for t in self.named():
            lc = t.state.lifecycle
            if lc is not None:
                steps = [("lifecycle shutdown", lc.shutdown)]
            else:
                steps = [
                    ("batcher shutdown", t.state.batcher.shutdown),
                    ("environment close", t.state.evaluation_environment.close),
                ]
            for what, step in steps:
                try:
                    step()
                except Exception as e:  # noqa: BLE001 — teardown goes on
                    logger.error("tenant %s %s failed: %s", t.name, what, e)

    def stats(self) -> dict[str, Any]:
        """The tenant-labelled samples of one /metrics scrape:
        ``{family key: [((tenant,), value), ...]}`` and the tenant count."""
        sched = self.scheduler.stats() if self.scheduler is not None else {}
        out: dict[str, Any] = {
            k: [] for k in (
                "shed_rows", "admitted_rows", "inflight_rows", "queue_depth",
                "dispatch_grants", "dispatch_wait_seconds", "epoch",
                "rollbacks", "ready",
            )
        }
        for name, t in self._tenants.items():
            key = (name,)
            if t.admission is not None:
                adm = t.admission.stats()
                out["shed_rows"].append((key, float(adm["shed_rows"])))
                out["admitted_rows"].append((key, float(adm["admitted_rows"])))
                out["inflight_rows"].append((key, float(adm["inflight"])))
            if t.state.batcher is not None:
                out["queue_depth"].append(
                    (key, float(t.state.batcher.queue_depth()))
                )
            ss = sched.get(name)
            if ss is not None:
                out["dispatch_grants"].append((key, float(ss["grants"])))
                out["dispatch_wait_seconds"].append((key, ss["wait_ns"] / 1e9))
            lc = t.state.lifecycle
            if lc is not None:
                ls = lc.stats()
                out["epoch"].append((key, float(ls["epoch"])))
                out["rollbacks"].append((key, float(ls["rollbacks"])))
            out["ready"].append(
                (key, 1.0 if t.readiness()[0] == 200 else 0.0)
            )
        out["serving"] = len(self._tenants)
        return out
