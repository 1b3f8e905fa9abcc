"""Cluster-state snapshot service (see package docstring for the design).

``KubeApiFetcher`` is the in-cluster client (reference kube::Client,
src/lib.rs:96-104): service-account token + CA from the standard pod paths,
LIST per allowlisted resource. Connection failure at boot is fatal unless
``--ignore-kubernetes-connection-failure`` (lib.rs:106-123).

Requests go through the standard-library client (``httpclient.py``):
15 s timeouts, and a watch stream's read timeout of 305 s (the API server
closes a watch after about 5 minutes)."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Iterable, Mapping

from policy_server_tpu_torch import httpclient
from policy_server_tpu_torch.models.policy import ContextAwareResource
from policy_server_tpu_torch.telemetry.tracing import logger

CONTEXT_KEY = "__context__"

SERVICE_ACCOUNT_DIR = Path("/var/run/secrets/kubernetes.io/serviceaccount")
# the in-cluster API server address (kube::Client's default)
KUBE_API_SERVER = "https://kubernetes.default.svc"

# Core-group kinds → plural list endpoints (the subset Kubewarden's
# context-aware policies commonly use; anything else goes through the
# apiVersion path form directly).
_CORE_PLURALS = {
    "Namespace": "namespaces",
    "Pod": "pods",
    "Service": "services",
    "ConfigMap": "configmaps",
    "Secret": "secrets",
    "ServiceAccount": "serviceaccounts",
}
_NAMED_PLURALS = {
    "Deployment": "deployments",
    "ReplicaSet": "replicasets",
    "StatefulSet": "statefulsets",
    "DaemonSet": "daemonsets",
    "Ingress": "ingresses",
    "Job": "jobs",
    "CronJob": "cronjobs",
}


def resource_key(resource: ContextAwareResource) -> str:
    """Snapshot key for one allowlisted kind: ``apiVersion/Kind`` (IR paths
    address it as ``__context__.<apiVersion/Kind>[*]...``)."""
    return f"{resource.api_version}/{resource.kind}"


class KubeConnectionError(Exception):
    pass


@dataclass(frozen=True)
class ContextSnapshot:
    """Immutable view of the allowlisted cluster state."""

    version: int
    taken_at: float
    resources: Mapping[str, tuple[Any, ...]]  # key → list of objects

    def view(self, allowlist: Iterable[ContextAwareResource]) -> dict[str, list]:
        """The capability-filtered slice a single policy may see
        (EvaluationContext allowlist parity)."""
        out: dict[str, list] = {}
        for r in allowlist:
            key = resource_key(r)
            out[key] = list(self.resources.get(key, ()))
        return out


EMPTY_SNAPSHOT = ContextSnapshot(version=0, taken_at=0.0, resources={})


class StaticContextFetcher:
    """Test/dev fetcher: serves fixed (mutable) resource collections."""

    def __init__(self, resources: Mapping[str, list] | None = None):
        self.resources = dict(resources or {})

    def fetch(
        self, wanted: Iterable[ContextAwareResource]
    ) -> dict[str, tuple[Any, ...]]:
        return {
            resource_key(r): tuple(self.resources.get(resource_key(r), ()))
            for r in wanted
        }


class KubeApiFetcher:
    """Minimal in-cluster LIST client over the pod service account."""

    def __init__(
        self,
        api_server: str | None = None,
        token: str | None = None,
        ca_file: str | None = None,
        insecure_skip_tls_verify: bool = False,
    ):
        self.api_server = api_server or KUBE_API_SERVER
        self.insecure_skip_tls_verify = insecure_skip_tls_verify
        token_path = SERVICE_ACCOUNT_DIR / "token"
        ca_path = SERVICE_ACCOUNT_DIR / "ca.crt"
        if token is None:
            if not token_path.exists():
                raise KubeConnectionError(
                    "no service-account token found "
                    f"({token_path}); not running in a cluster?"
                )
            token = token_path.read_text().strip()
        self.token = token
        self.ca_file = ca_file or (str(ca_path) if ca_path.exists() else None)
        # probe the API server (kube::Client::try_default analog)
        try:
            resp = self._get("/version")
        except httpclient.RequestError as e:
            raise KubeConnectionError(f"cannot reach the Kubernetes API: {e}") from e
        if resp.status_code >= 500:
            raise KubeConnectionError(
                f"Kubernetes API error: HTTP {resp.status_code}"
            )

    def _request(
        self,
        path: str,
        params: Mapping[str, str] | None = None,
        stream: bool = False,
        timeout: Any = 15,
    ) -> httpclient.Response:
        # No silent TLS bypass to the API server: without a cluster CA the
        # system trust store is used (and fails loudly on self-signed
        # clusters); verification is skipped ONLY on explicit operator
        # opt-in (the reference's kube client refuses likewise).
        if self.insecure_skip_tls_verify:
            verify: bool | str = False
        else:
            verify = self.ca_file if self.ca_file else True
        return httpclient.get(
            f"{self.api_server}{path}",
            params=params,
            headers={"Authorization": f"Bearer {self.token}"},
            verify=verify,
            stream=stream,
            timeout=timeout,
        )

    def _get(self, path: str) -> httpclient.Response:
        return self._request(path)

    def _list_path(self, resource: ContextAwareResource) -> str:
        api_version, kind = resource.api_version, resource.kind
        if api_version == "v1":
            plural = _CORE_PLURALS.get(kind, kind.lower() + "s")
            return f"/api/v1/{plural}"
        plural = _NAMED_PLURALS.get(kind, kind.lower() + "s")
        return f"/apis/{api_version}/{plural}"

    def fetch(
        self, wanted: Iterable[ContextAwareResource]
    ) -> dict[str, tuple[Any, ...]]:
        out: dict[str, tuple[Any, ...]] = {}
        for r in wanted:
            resp = self._get(self._list_path(r))
            if resp.status_code != 200:
                logger.error(
                    "context list %s failed: HTTP %s",
                    resource_key(r), resp.status_code,
                )
                out[resource_key(r)] = ()
                continue
            out[resource_key(r)] = tuple(resp.json().get("items") or ())
        return out

    # -- watch primitives (list+watch with resourceVersion resume) ---------

    def list_with_version(
        self, resource: ContextAwareResource
    ) -> tuple[tuple[Any, ...], str]:
        """LIST one kind, returning (items, list resourceVersion) — the
        resume point for a subsequent watch."""
        resp = self._get(self._list_path(resource))
        resp.raise_for_status()
        doc = resp.json()
        return (
            tuple(doc.get("items") or ()),
            str((doc.get("metadata") or {}).get("resourceVersion") or ""),
        )

    def watch(
        self, resource: ContextAwareResource, resource_version: str
    ):
        """Stream watch events for one kind from ``resource_version``.

        Yields decoded K8s watch event dicts (``{"type": ..., "object":
        ...}``). Returns normally when the server closes the stream (the
        caller re-watches from its last seen resourceVersion); raises on
        transport errors (the caller falls back to a fresh LIST)."""
        import json

        resp = self._request(
            self._list_path(resource),
            params={
                "watch": "true",
                "resourceVersion": resource_version,
                "allowWatchBookmarks": "true",
            },
            stream=True,
            timeout=(15, 305),  # connect, read — servers close ~5 min
        )
        resp.raise_for_status()
        with resp:
            for line in resp.iter_lines():
                if line:
                    yield json.loads(line)


def _object_key(obj: Mapping[str, Any]) -> tuple:
    """Identity of one cluster object inside a kind's collection: uid when
    present, else (namespace, name)."""
    meta = obj.get("metadata") or {}
    uid = meta.get("uid")
    if uid:
        return ("uid", uid)
    return ("nn", meta.get("namespace"), meta.get("name"))


def run_watch_loop(
    fetcher: Any,
    resource: ContextAwareResource,
    *,
    stop: threading.Event,
    refresh_seconds: float,
    replace_kind: Any,
    apply_event: Any,
    rv: str | None = None,
    resync_multiplier: int = 10,
    on_resync: Any = None,
    on_stream: Any = None,
    on_rv: Any = None,
) -> None:
    """The ONE list+watch state machine (round 13: extracted so the audit
    snapshot feed shares it with the context service instead of re-growing
    the subtle parts independently). For a single kind:

    * a cleanly closed stream (server-side ~5 min timeout) resumes the
      watch from the last seen resourceVersion — bookmarks exist precisely
      so this path never re-LISTs;
    * a 410-Gone-style ERROR event or any exception (transport fault, an
      injected ``on_stream`` failure, a consumer signalling overflow)
      drops the rv and restarts from a fresh LIST after an exponentially
      growing backoff capped at ``refresh_seconds``;
    * a full re-LIST resync runs at the first stream close after
      ``resync_multiplier x refresh_seconds`` since the last LIST — the
      safety net bounding staleness from silently dropped events.

    Callbacks: ``replace_kind(key, items)`` applies a full LIST,
    ``apply_event(key, etype, obj)`` applies one event (it may RAISE to
    force a resync — e.g. a bounded queue that overflowed), ``on_resync
    (key, reason)`` counts every post-boot LIST (reason: "expired" |
    "error" | "interval"), ``on_stream()`` runs before each watch connect
    (the ``watch.stream`` chaos hook). The caller seeds ``rv`` from its
    boot LIST; ``rv=None`` starts with a LIST."""
    key = resource_key(resource)
    base_backoff = min(1.0, refresh_seconds)
    backoff = base_backoff
    # rv seeded => the caller just LISTed; unseeded => first pass LISTs
    last_list = time.monotonic()
    resync_interval = refresh_seconds * resync_multiplier
    pending_reason = None
    boot_list_pending = rv is None  # the caller's first LIST: not a resync
    while not stop.is_set():
        delivered = False
        try:
            if rv is None or time.monotonic() - last_list > resync_interval:
                reason = pending_reason or "interval"
                items, rv = fetcher.list_with_version(resource)
                if on_rv is not None and rv is not None:
                    # the LIST's collection resourceVersion — the durable
                    # resume cursor the audit spill records (round 17).
                    # Announced BEFORE replace_kind so the consumer can
                    # attach it to the queued replace and only ADVANCE
                    # its cursor once the inventory is applied; per-event
                    # rvs reach the consumer via apply_event.
                    on_rv(key, str(rv))
                replace_kind(key, items)
                last_list = time.monotonic()
                pending_reason = None
                if on_resync is not None and not boot_list_pending:
                    on_resync(key, reason)
                boot_list_pending = False
            if on_stream is not None:
                on_stream()
            for event in fetcher.watch(resource, rv):
                if stop.is_set():
                    return
                etype = event.get("type")
                obj = event.get("object") or {}
                if etype == "ERROR":
                    # e.g. 410 Gone: resourceVersion too old → re-list
                    # (an ERROR does NOT count as healthy delivery — a
                    # persistently erroring stream must back off, not
                    # spin LISTs against the control plane)
                    logger.info("watch %s expired, re-listing", key)
                    rv = None
                    pending_reason = "expired"
                    break
                if etype == "BOOKMARK":
                    rv = str(
                        (obj.get("metadata") or {}).get("resourceVersion")
                        or rv
                    )
                    delivered = True
                    backoff = base_backoff
                    continue
                apply_event(key, etype, obj)
                rv = str(
                    (obj.get("metadata") or {}).get("resourceVersion")
                    or rv
                )
                # applied, not just received: a consumer fault (e.g. a
                # queue overflow raised by apply_event) must take the
                # backoff below, not spin full re-LISTs against the API
                delivered = True
                backoff = base_backoff
            # clean close with rv intact → resume watch, no LIST
        except Exception as e:  # noqa: BLE001 — keep last good state
            if stop.is_set():
                return
            logger.error("watch %s failed: %s", key, e)
            rv = None  # transport/consumer fault → full re-list on recovery
            pending_reason = "error"
        if not delivered and not stop.is_set():
            # ERROR event, exception, or a stream that closed without
            # delivering anything: wait before hitting the API again,
            # growing exponentially up to the refresh period
            stop.wait(backoff)
            backoff = min(backoff * 2, max(refresh_seconds, base_backoff))


class ContextSnapshotService:
    """Background refresher holding the current immutable snapshot.

    Staleness contract (SURVEY.md §7.4 #5; replaces the reference's
    read-through callback_handler, which pays a K8s round-trip per guest
    call but is always fresh):

    * **watch mode** (default when the fetcher supports list+watch, i.e.
      the real ``KubeApiFetcher``): a per-kind watcher applies K8s watch
      events to the snapshot as they arrive — staleness is event-delivery
      latency (typically milliseconds). The watch resumes from the last
      seen ``resourceVersion``; an expired version (410 Gone) or transport
      error falls back to a fresh LIST after an exponentially growing
      backoff capped at ``refresh_seconds``, during which the last good
      snapshot keeps serving. As a safety net against silently dropped
      watch events, a full re-LIST resync runs at the first stream close
      after ``RESYNC_MULTIPLIER × refresh_seconds`` has elapsed since the
      last LIST (the API server bounds watch-stream lifetime, so closes
      arrive regularly).
    * **poll mode** (fetchers without watch, or ``watch=False``): full
      re-LIST every ``refresh_seconds`` (``--context-refresh-seconds``),
      so a policy may observe cluster state up to ``refresh_seconds`` +
      one LIST older than reality.

    Either way every policy evaluation reads ONE immutable snapshot
    (``snapshot()``), so all rows of a batch see a consistent cluster
    view — fresher-but-torn reads are not possible by construction.
    """

    # watch-mode full re-LIST cadence = RESYNC_MULTIPLIER × refresh_seconds
    RESYNC_MULTIPLIER = 10

    def __init__(
        self,
        fetcher: Any,
        wanted: Iterable[ContextAwareResource] = (),
        refresh_seconds: float = 30.0,
        watch: bool | None = None,
    ):
        self.fetcher = fetcher
        self.wanted = frozenset(wanted)
        self.refresh_seconds = refresh_seconds
        self.watch_enabled = (
            watch
            if watch is not None
            else hasattr(fetcher, "watch") and hasattr(fetcher, "list_with_version")
        )
        self._snapshot = EMPTY_SNAPSHOT  # guarded-by: _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # watch mode: mutable per-kind object maps the watchers fold events
        # into; every publish snapshots them into immutable tuples
        self._store: dict[str, dict[tuple, Any]] = {}  # graftcheck: lockfree — watcher-thread-confined; published into _snapshot under _lock

    def snapshot(self) -> ContextSnapshot:
        with self._lock:
            return self._snapshot

    def refresh(self) -> ContextSnapshot:
        resources = self.fetcher.fetch(self.wanted)
        with self._lock:
            self._snapshot = ContextSnapshot(
                version=self._snapshot.version + 1,
                taken_at=time.time(),
                resources=resources,
            )
            return self._snapshot

    def start(self) -> "ContextSnapshotService":
        if self._threads:
            return self
        if not self.wanted:
            self.refresh()
            return self
        if self.watch_enabled:
            # Boot prefetch = ONE LIST per kind, done synchronously so a
            # failing context fetch still fails the boot (the caller's
            # --ignore-kubernetes-connection-failure handling stays in
            # force); each watcher is seeded with the LIST's
            # resourceVersion and starts with a watch, not a second LIST.
            seeds: dict[str, str | None] = {}
            for r in sorted(self.wanted, key=resource_key):
                key = resource_key(r)
                try:
                    items, rv = self.fetcher.list_with_version(r)
                except httpclient.HTTPError as e:
                    # Non-2xx (e.g. RBAC denies list on one kind): same
                    # tolerance as poll-mode fetch() — that kind serves an
                    # empty view and its watcher keeps retrying with
                    # backoff. Transport errors still propagate: boot
                    # fails unless --ignore-kubernetes-connection-failure
                    # chose a StaticContextFetcher instead.
                    logger.error("context boot list %s failed: %s", key, e)
                    self._replace_kind(key, ())
                    seeds[key] = None
                    continue
                self._replace_kind(key, items)
                seeds[key] = rv
            for r in sorted(self.wanted, key=resource_key):
                t = threading.Thread(
                    target=self._watch_loop,
                    args=(r, seeds[resource_key(r)]),
                    name=f"context-watch-{resource_key(r)}",
                    daemon=True,
                )
                t.start()
                self._threads.append(t)
        else:
            self.refresh()  # boot-time prefetch: first request = real state
            t = threading.Thread(
                target=self._poll_loop, name="context-snapshot", daemon=True
            )
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []

    # -- poll mode ----------------------------------------------------------

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.refresh_seconds):
            try:
                self.refresh()
            except Exception as e:  # noqa: BLE001 — keep last good
                logger.error("context refresh failed: %s", e)

    # -- watch mode ---------------------------------------------------------

    def _watch_loop(
        self, resource: ContextAwareResource, rv: str | None = None
    ) -> None:
        """list+watch with resourceVersion resume for ONE kind — the
        shared :func:`run_watch_loop` state machine applied to the
        context snapshot's per-kind store (a transport error keeps the
        last good snapshot serving while the loop backs off)."""
        run_watch_loop(
            self.fetcher,
            resource,
            stop=self._stop,
            refresh_seconds=self.refresh_seconds,
            replace_kind=self._replace_kind,
            apply_event=self._apply_event,
            rv=rv,
            resync_multiplier=self.RESYNC_MULTIPLIER,
        )

    def _replace_kind(self, key: str, items: Iterable[Any]) -> None:
        self._store[key] = {_object_key(o): o for o in items}
        self._publish(key)

    def _apply_event(self, key: str, etype: str, obj: Mapping[str, Any]) -> None:
        kind_map = self._store.setdefault(key, {})
        okey = _object_key(obj)
        if etype == "DELETED":
            kind_map.pop(okey, None)
        else:  # ADDED / MODIFIED
            kind_map[okey] = obj
        self._publish(key)

    def _publish(self, key: str) -> None:
        """Fold the mutable store into a new immutable snapshot."""
        with self._lock:
            resources = dict(self._snapshot.resources)
            resources[key] = tuple(self._store.get(key, {}).values())
            self._snapshot = ContextSnapshot(
                version=self._snapshot.version + 1,
                taken_at=time.time(),
                resources=resources,
            )
