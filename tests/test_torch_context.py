"""Context-aware policies in the PyTorch port against the JAX package:
every case of ``tests/test_context.py`` runs the same snapshot and the same
requests through both packages' snapshot services and environments (the
port's on the CPU), with equal responses; the watch-mode cases drive both
services with the same fake watch fetcher script. Then the port's own
cases: the kube client's TLS context, the in-cluster client against a
local HTTPS API server, the 256/257-namespace context-axis boundary, and a
watch event that flips the next verdict through a server with the verdict
cache on."""

from __future__ import annotations

import json
import queue
import ssl
import time

import pytest

import policy_server_tpu.context as j_context
import policy_server_tpu.context.service as j_service
import policy_server_tpu.models.policy as j_policy
from policy_server_tpu.evaluation.environment import (
    EvaluationEnvironmentBuilder as JaxBuilder,
)
from policy_server_tpu.models import AdmissionReviewRequest as JReview
from policy_server_tpu.models import ValidateRequest as JRequest
import policy_server_tpu_torch.context as p_context
import policy_server_tpu_torch.context.service as p_service
import policy_server_tpu_torch.models.policy as p_policy
from policy_server_tpu_torch import httpclient
from policy_server_tpu_torch.evaluation.environment import (
    EvaluationEnvironmentBuilder as TorchBuilder,
)
from policy_server_tpu_torch.models import AdmissionReviewRequest as TReview
from policy_server_tpu_torch.models import ValidateRequest as TRequest

from conftest import build_admission_review_dict
import torch_fetch_fixtures as fx

NS_ALLOWLIST = [{"apiVersion": "v1", "kind": "Namespace"}]


class Side:
    def __init__(self, name, context, service, policy, builder, review, request):
        self.name = name
        self.context = context
        self.service = service
        self.policy = policy
        self.builder = builder
        self.review = review
        self.request = request

    def car(self):
        return self.policy.ContextAwareResource("v1", "Namespace")

    def build_env(self, service, with_allowlist=True, backend=None, **kw):
        entry = {
            "module": "builtin://namespace-exists",
            **({"contextAwareResources": NS_ALLOWLIST} if with_allowlist else {}),
        }
        policies = {"ns-exists": self.policy.parse_policy_entry("ns-exists", entry)}
        if self.name == "jax":
            return self.builder(
                backend=backend or "jax", context_service=service, **kw
            ).build(policies)
        if backend == "oracle":
            return self.builder(backend="oracle", context_service=service, **kw).build(policies)
        return self.builder(device="cpu", context_service=service, **kw).build(policies)

    def request_in(self, namespace: str):
        doc = build_admission_review_dict()
        doc["request"]["namespace"] = namespace
        return self.request.from_admission(self.review.from_dict(doc).request)

    def make_service(self, namespaces):
        fetcher = self.context.StaticContextFetcher(
            {"v1/Namespace": [ns_object(n) for n in namespaces]}
        )
        service = self.context.ContextSnapshotService(fetcher, wanted=[self.car()])
        service.refresh()
        return service


JAX = Side("jax", j_context, j_service, j_policy, JaxBuilder, JReview, JRequest)
PORT = Side("port", p_context, p_service, p_policy, TorchBuilder, TReview, TRequest)


def ns_object(name: str) -> dict:
    return {"metadata": {"name": name}}


def both(case):
    got = [case(side) for side in (JAX, PORT)]
    assert got[0] == got[1], got
    return got[1]


@pytest.mark.parametrize("backend", ["jax", "oracle"])
def test_namespace_exists_against_snapshot(backend):
    def case(side):
        env = side.build_env(side.make_service(["default", "prod"]), backend=backend)
        return [env.validate("ns-exists", side.request_in(ns)).to_dict()
                for ns in ("prod", "ghost")]

    prod, ghost = both(case)
    assert prod["allowed"] and not ghost["allowed"]
    assert "ghost" in ghost["status"]["message"]


def test_jax_matches_oracle_with_context():
    def case(side):
        service = side.make_service(["a", "b", "team-x"])
        dev = side.build_env(service)
        oracle = side.build_env(service, backend="oracle")
        out = []
        for ns in ("a", "b", "team-x", "nope", "A"):
            r1 = dev.validate("ns-exists", side.request_in(ns)).to_dict()
            r2 = oracle.validate("ns-exists", side.request_in(ns)).to_dict()
            assert r1 == r2, ns
            out.append(r1)
        return out

    both(case)


def test_without_allowlist_policy_sees_empty_cluster():
    def case(side):
        env = side.build_env(side.make_service(["default"]), with_allowlist=False)
        return env.validate("ns-exists", side.request_in("default")).to_dict()

    assert not both(case)["allowed"]


def test_snapshot_refresh_changes_verdicts():
    def case(side):
        fetcher = side.context.StaticContextFetcher(
            {"v1/Namespace": [ns_object("old")]}
        )
        service = side.context.ContextSnapshotService(fetcher, wanted=[side.car()])
        service.refresh()
        env = side.build_env(service)
        before = env.validate("ns-exists", side.request_in("new")).to_dict()
        fetcher.resources["v1/Namespace"] = [ns_object("old"), ns_object("new")]
        service.refresh()
        after = env.validate("ns-exists", side.request_in("new")).to_dict()
        return before, after, service.snapshot().version

    before, after, version = both(case)
    assert not before["allowed"] and after["allowed"] and version == 2


def test_batched_context_evaluation():
    def case(side):
        env = side.build_env(side.make_service(["default", "prod"]))
        items = [("ns-exists", side.request_in(ns))
                 for ns in ("default", "ghost", "prod")]
        return [r.to_dict() for r in env.validate_batch(items)]

    assert [r["allowed"] for r in both(case)] == [True, False, True]


# -- watch-based freshness ---------------------------------------------------


class FakeWatchFetcher:
    """list+watch double: LIST serves ``self.items``; watch() yields events
    pushed through a queue (None = close the stream cleanly)."""

    def __init__(self, side, items):
        self.side = side
        self.items = list(items)
        self.events: queue.Queue = queue.Queue()
        self.lists = 0
        self.watches = 0
        self.watch_versions: list[str] = []

    def fetch(self, wanted):
        return {self.side.service.resource_key(r): tuple(self.items) for r in wanted}

    def list_with_version(self, resource):
        self.lists += 1
        return tuple(self.items), f"rv-{self.lists}"

    def watch(self, resource, resource_version):
        self.watches += 1
        self.watch_versions.append(resource_version)
        while True:
            ev = self.events.get(timeout=10)
            if ev is None:
                return
            if isinstance(ev, Exception):
                raise ev
            yield ev


def wait_for(predicate, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return False


def watch_event(etype: str, name: str, rv: str = "1") -> dict:
    return {
        "type": etype,
        "object": {"metadata": {"name": name, "resourceVersion": rv}},
    }


def names(service) -> set:
    return {
        (o.get("metadata") or {}).get("name")
        for o in service.snapshot().resources.get("v1/Namespace", ())
    }


def run_watch(side, script, refresh_seconds=0.5, multiplier=None, watch=None,
              fetcher_cls=FakeWatchFetcher):
    """Start ``side``'s service over a fake fetcher, run ``script(fetcher,
    service)`` → its observation, then stop the service."""
    fetcher = fetcher_cls(side, [ns_object("seed")])
    service = side.context.ContextSnapshotService(
        fetcher, wanted=[side.car()], refresh_seconds=refresh_seconds,
        **({} if watch is None else {"watch": watch}),
    )
    if multiplier is not None:
        service.RESYNC_MULTIPLIER = multiplier
    service.start()
    try:
        return script(fetcher, service)
    finally:
        service._stop.set()  # noqa: SLF001 — stop before waking the watcher
        fetcher.events.put(None)
        service.stop()


def test_watch_mode_applies_events():
    def script(fetcher, service):
        assert service.watch_enabled
        assert wait_for(lambda: fetcher.watches == 1)
        baseline = fetcher.lists
        fetcher.events.put(watch_event("ADDED", "fresh"))
        assert wait_for(lambda: "fresh" in names(service))
        fetcher.events.put(watch_event("DELETED", "seed"))
        assert wait_for(lambda: "seed" not in names(service))
        return (fetcher.lists - baseline, sorted(names(service)),
                service.snapshot().version >= 3)

    assert both(lambda side: run_watch(side, script)) == (0, ["fresh"], True)


def test_watch_error_event_triggers_relist():
    def script(fetcher, service):
        assert wait_for(lambda: fetcher.watches == 1)
        fetcher.items.append(ns_object("recovered"))
        fetcher.events.put({"type": "ERROR", "object": {"code": 410}})
        assert wait_for(lambda: fetcher.watches == 2)
        assert wait_for(lambda: "recovered" in names(service))
        return fetcher.watch_versions

    assert both(lambda side: run_watch(side, script)) == ["rv-1", "rv-2"]


def test_watch_transport_error_backs_off_and_recovers():
    def script(fetcher, service):
        assert wait_for(lambda: fetcher.watches == 1)
        seed_visible = "seed" in names(service)
        fetcher.items.append(ns_object("after-crash"))
        fetcher.events.put(ConnectionError("stream reset"))
        assert wait_for(lambda: fetcher.watches == 2)
        assert wait_for(lambda: "after-crash" in names(service))
        return seed_visible, sorted(names(service))

    assert both(lambda side: run_watch(side, script)) == (
        True, ["after-crash", "seed"]
    )


def test_watch_resync_relists_after_interval():
    def script(fetcher, service):
        assert wait_for(lambda: fetcher.watches == 1)
        fetcher.items.append(ns_object("missed"))
        time.sleep(0.05)
        fetcher.events.put(None)
        assert wait_for(lambda: "missed" in names(service))
        return fetcher.lists >= 2

    assert both(lambda side: run_watch(
        side, script, refresh_seconds=0.01, multiplier=1
    )) is True


def test_boot_list_http_error_serves_empty_view_for_that_kind():
    import requests as _requests

    class DeniedFetcher(FakeWatchFetcher):
        def list_with_version(self, resource):
            self.lists += 1
            if self.side is JAX:
                resp = _requests.Response()
                resp.status_code = 403
                raise _requests.HTTPError("403 Forbidden", response=resp)
            raise httpclient.HTTPError("403 Forbidden")

    def script(fetcher, service):
        return service.snapshot().resources.get("v1/Namespace")

    assert both(lambda side: run_watch(
        side, script, fetcher_cls=DeniedFetcher
    )) == ()


def test_poll_mode_when_watch_disabled():
    def script(fetcher, service):
        assert not service.watch_enabled
        fetcher.items.append(ns_object("b"))
        assert wait_for(lambda: "b" in names(service))
        return fetcher.watches

    assert both(lambda side: run_watch(
        side, script, refresh_seconds=0.05, watch=False
    )) == 0


# -- the kube client's TLS ---------------------------------------------------


@pytest.fixture()
def kube(tmp_path):
    api = fx.KubeApi(tmp_path / "kube")
    api.register(fx.list_path("v1", "Namespace"),
                 [fx.namespace(n) for n in ("default", "prod")])
    sa = api.write_service_account(tmp_path / "serviceaccount")
    yield api, sa
    api.stop()


def test_kube_client_never_silently_skips_tls(monkeypatch, kube):
    """Without a cluster CA the kube client verifies against the system
    trust store, with the CA it trusts that CA only, and it skips
    verification only on the explicit opt-in — asserted on the ``ssl``
    context of each request."""
    api, sa = kube
    contexts: list = []
    real_open = httpclient._open

    def spy(url, headers, timeout, context, stream):
        contexts.append(context)
        return real_open(url, headers, timeout, context, stream)

    monkeypatch.setattr(httpclient, "_open", spy)
    ca = str(sa / "ca.crt")
    token = api.token
    with pytest.raises(p_service.KubeConnectionError):
        p_service.KubeApiFetcher(api_server=api.url, token=token)
    system = contexts[-1]
    assert system.verify_mode == ssl.CERT_REQUIRED and system.check_hostname
    assert not any(
        c.get("subject") == ((("commonName", "kube-ca"),),)
        for c in system.get_ca_certs()
    )
    p_service.KubeApiFetcher(api_server=api.url, token=token, ca_file=ca)
    pinned = contexts[-1]
    assert pinned.verify_mode == ssl.CERT_REQUIRED and pinned.check_hostname
    assert [c["subject"] for c in pinned.get_ca_certs()] == [
        ((("commonName", "kube-ca"),),)
    ]
    p_service.KubeApiFetcher(
        api_server=api.url, token=token, insecure_skip_tls_verify=True,
    )
    assert contexts[-1].verify_mode == ssl.CERT_NONE
    assert not contexts[-1].check_hostname


def test_in_cluster_client_lists_and_watches_the_api_server(monkeypatch, kube):
    """``KubeApiFetcher`` with the service-account files and the address
    constant pointed at a local HTTPS API server: the boot LIST, then a
    watch stream whose events (and a clean close) reach the snapshot, as
    the JAX package's client (``requests``) sees the same server."""
    api, sa = kube
    path = fx.list_path("v1", "Namespace")
    monkeypatch.setattr(p_service, "SERVICE_ACCOUNT_DIR", sa)
    monkeypatch.setattr(p_service, "KUBE_API_SERVER", api.url)
    monkeypatch.setattr(j_service, "SERVICE_ACCOUNT_DIR", sa)
    monkeypatch.setattr(
        j_service.KubeApiFetcher.__init__, "__defaults__",
        (api.url, None, None, False),
    )

    def case(side):
        fetcher = side.service.KubeApiFetcher()
        items, rv = fetcher.list_with_version(side.car())
        service = side.context.ContextSnapshotService(
            fetcher, wanted=[side.car()], refresh_seconds=0.5
        ).start()
        try:
            name = f"added-{side.name}"
            api.add(path, fx.namespace(name))
            assert wait_for(lambda: name in names(service), timeout=10)
            api.close_streams()
            later = f"later-{side.name}"
            api.add(path, fx.namespace(later))
            assert wait_for(lambda: later in names(service), timeout=10)
            api.delete(path, fx.namespace(name))
            assert wait_for(lambda: name not in names(service), timeout=10)
            return (sorted(o["metadata"]["name"] for o in items
                           if "-" not in o["metadata"]["name"]),
                    sorted(n for n in names(service) if "-" not in n))
        finally:
            service.stop()
            api.close_streams()

    assert both(case) == (["default", "prod"], ["default", "prod"])


# -- the context axis boundary -----------------------------------------------


@pytest.mark.parametrize("n_namespaces", [256, 257])
def test_context_axis_boundary_matches_the_jax_routing(n_namespaces):
    """At most 256 elements of the watched kind ride the device rows; at
    257 every context row overflows to the host oracle, in both packages,
    with equal answers."""
    names_ = [f"ns-{i}" for i in range(n_namespaces)]

    def case(side):
        env = side.build_env(side.make_service(names_), verdict_cache_size=0)
        items = [("ns-exists", side.request_in(f"ns-{i * 5}")) for i in range(64)]
        before = env.oracle_fallbacks
        out = [r.to_dict() for r in env.validate_batch(items)]
        return out, env.oracle_fallbacks - before

    out, fallbacks = both(case)
    assert fallbacks == (0 if n_namespaces <= 256 else 64)
    assert sum(r["allowed"] for r in out) == sum(
        1 for i in range(64) if i * 5 < n_namespaces
    )
    env = PORT.build_env(PORT.make_service(names_), verdict_cache_size=0)
    before = env.host_profile["dispatched_rows"]
    env.validate_batch(
        [("ns-exists", PORT.request_in(f"ns-{i}")) for i in range(64)]
    )
    shipped = env.host_profile["dispatched_rows"] - before
    assert (shipped > 0) == (n_namespaces <= 256)


# -- a watch event through a server with the verdict cache on -----------------


@pytest.fixture()
def context_server(monkeypatch, kube):
    """A port server and a JAX server (its host oracle) serving
    namespace-exists over the same local API server, at the default
    verdict cache."""
    from policy_server_tpu_torch.server import PolicyServer
    from torch_port_support import JaxServer

    api, sa = kube
    monkeypatch.setattr(p_service, "SERVICE_ACCOUNT_DIR", sa)
    monkeypatch.setattr(p_service, "KUBE_API_SERVER", api.url)
    monkeypatch.setattr(j_service, "SERVICE_ACCOUNT_DIR", sa)
    monkeypatch.setattr(
        j_service.KubeApiFetcher.__init__, "__defaults__",
        (api.url, None, None, False),
    )
    specs = {"ns-exists": {"module": "builtin://namespace-exists",
                           "contextAwareResources": NS_ALLOWLIST},
             "priv": {"module": "builtin://pod-privileged"}}
    port = PolicyServer(
        {k: p_policy.parse_policy_entry(k, v) for k, v in specs.items()},
        port=0, readiness_probe_port=0, device="cpu", max_batch_size=8,
        context_refresh_seconds=1.0,
    )
    port.start()
    jax = JaxServer(specs, context_refresh_seconds=1.0)
    yield api, port, jax
    port.stop()
    jax.stop()


def test_watch_event_flips_the_next_verdict_with_the_cache_on(context_server):
    from test_torch_native_frontend import exchange, post_bytes

    api, port, jax = context_server
    path = fx.list_path("v1", "Namespace")
    assert port.context_service is not None

    def ask(server_port, ns):
        doc = build_admission_review_dict()
        doc["request"]["namespace"] = ns
        status, _h, body = exchange(server_port, post_bytes(
            "/validate/ns-exists", json.dumps(doc).encode()
        ))[0]
        return status, json.loads(body)["response"]

    def same(ns):
        a, b = ask(port.port, ns), ask(jax.port, ns)
        assert a == b, (ns, a, b)
        return a[1]["allowed"]

    assert same("prod") and not same("team-new")
    assert not same("team-new")  # a cached answer, still right
    version = port.context_service.snapshot().version
    api.add(path, fx.namespace("team-new"))
    assert wait_for(
        lambda: port.context_service.snapshot().version > version
        and ask(jax.port, "team-new")[1]["allowed"], timeout=15,
    )
    assert same("team-new")
    version = port.context_service.snapshot().version
    api.delete(path, fx.namespace("prod"))
    assert wait_for(
        lambda: port.context_service.snapshot().version > version
        and not ask(jax.port, "prod")[1]["allowed"], timeout=15,
    )
    assert not same("prod")
    dedup = port.env.dedup_stats
    assert dedup["blob_cache_hits"] + dedup["cache_hits"] > 0


def static_context_artifact(pkg_fetch, ir, compiler) -> bytes:
    """A context-aware artifact with a static message (so its verdicts are
    frag-eligible, the matrix's lookup condition): rejects a request whose
    namespace is not in the snapshot."""
    known = ir.AnyOf(
        ir.Path("__context__.v1/Namespace"),
        ir.eq(ir.Elem("metadata.name"), ir.Path("namespace")),
    )
    doc = pkg_fetch.dump_artifact("ns-known", [compiler.Rule(
        "unknown-namespace", ir.Exists(ir.Path("namespace")) & ~known,
        "namespace unknown",
    )])
    return json.dumps(doc).encode()


def test_lookup_admission_never_answers_a_context_policy_from_the_matrix(
    monkeypatch, kube, tmp_path,
):
    """With --audit-matrix, an UPDATE byte-identical to an inventory row
    whose policy reads the cluster snapshot is evaluated, not answered
    from the cell the sweep judged under an older snapshot: after the
    namespace appears, the port answers allowed. (The JAX package's
    lookup admission serves such a cell — queue C, reference-side.)"""
    import policy_server_tpu.fetch as jf
    import policy_server_tpu.ops.compiler as jc
    import policy_server_tpu.ops.ir as jir
    import policy_server_tpu_torch.fetch as pf
    import policy_server_tpu_torch.ops.compiler as pc
    import policy_server_tpu_torch.ops.ir as pir
    from policy_server_tpu_torch.server import PolicyServer
    from test_torch_native_frontend import exchange, post_bytes
    from torch_port_support import JaxServer

    api, sa = kube
    path = fx.list_path("v1", "Namespace")
    data = static_context_artifact(pf, pir, pc)
    assert data == static_context_artifact(jf, jir, jc)
    art = tmp_path / "ns-known.tpp.json"
    art.write_bytes(data)
    monkeypatch.setattr(p_service, "SERVICE_ACCOUNT_DIR", sa)
    monkeypatch.setattr(p_service, "KUBE_API_SERVER", api.url)
    monkeypatch.setattr(j_service, "SERVICE_ACCOUNT_DIR", sa)
    monkeypatch.setattr(
        j_service.KubeApiFetcher.__init__, "__defaults__",
        (api.url, None, None, False),
    )
    specs = {"ns-known": {"module": f"file://{art}",
                          "contextAwareResources": NS_ALLOWLIST}}
    audit = dict(audit_mode="interval", audit_interval_seconds=0.2,
                 audit_matrix=True, context_refresh_seconds=1.0,
                 policies_download_dir=str(tmp_path / "store"))
    port = PolicyServer(
        {k: p_policy.parse_policy_entry(k, v) for k, v in specs.items()},
        port=0, readiness_probe_port=0, device="cpu", max_batch_size=8,
        **audit,
    )
    port.start()
    jax = JaxServer(specs, **audit)
    try:
        doc = build_admission_review_dict()
        doc["request"]["namespace"] = "team-late"

        def ask(server_port, uid):
            d = json.loads(json.dumps(doc))
            d["request"]["uid"] = uid
            _s, _h, body = exchange(server_port, post_bytes(
                "/validate/ns-known", json.dumps(d).encode()
            ))[0]
            return json.loads(body)["response"]

        assert not ask(port.port, "a")["allowed"]
        assert not ask(jax.port, "a")["allowed"]
        # the sweep judges the inventory row under the snapshot without it
        assert wait_for(lambda: port.state.audit_matrix.stats()["cells_resident"] >= 1,
                        timeout=15)
        assert wait_for(
            lambda: jax.server.state.audit_matrix.stats()["cells_resident"] >= 1,
            timeout=15,
        )
        version = port.context_service.snapshot().version
        api.add(path, fx.namespace("team-late"))
        assert wait_for(
            lambda: port.context_service.snapshot().version > version, timeout=15
        )
        time.sleep(2.0)  # the JAX service's watch applies the same event
        jax_hits = jax.server.batcher.matrix_lookup_hits
        got = ask(port.port, "b")
        jax_got = ask(jax.port, "b")
        assert got["allowed"] is True
        assert port.batcher.stats_snapshot()["matrix_lookup_hits"] == 0
        # the reference answers the stale cell from its matrix
        assert jax_got["allowed"] is False
        assert jax.server.batcher.matrix_lookup_hits == jax_hits + 1
    finally:
        port.stop()
        jax.stop()
