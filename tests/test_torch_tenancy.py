"""The port's multi-tenant serving (``policy_server_tpu_torch/tenancy.py``,
``runtime/scheduler.py``) held against the JAX package's on the same
inputs, case by case as ``tests/test_tenancy.py`` holds the JAX package:

* the manifest, read by both packages from the same JSON and YAML files,
  and its malformed forms (the same ``TenantConfigError`` texts);
* the token bucket, the in-flight cap and the ``tenant.admission``
  failpoint, the weighted-fair scheduler's grants, timeouts and aborts, and
  the readiness aggregation, driven through both packages in the same
  sequence (equal stats and verdicts);
* servers with a two-tenant manifest and a quota tenant — the JAX
  package's (its host oracle), the port's standard-library and native
  frontends (the kernel's plain version on the CPU): per-tenant routes, the
  unknown tenant's 404, ``/readiness/{tenant}``, a quota tenant's 429 with
  Retry-After beside a tenant that keeps serving, verdict-cache and
  shadow-ring isolation, a per-tenant reload, the scheduler's accounting
  and the tenant-labelled /metrics families. Status and body must be equal
  byte for byte (tolerance 0), with the Retry-After header.

A default-flag /metrics scrape of each package exports the same shed,
expired, tenant and shard family names."""

from __future__ import annotations

import asyncio
import dataclasses
import http.client
import json
import re
import threading
import time

import pytest

from policy_server_tpu import failpoints as jfp
from policy_server_tpu import tenancy as jt
from policy_server_tpu.api.state import ApiServerState as JState
from policy_server_tpu.config.config import Config, TlsConfig
from policy_server_tpu.models.policy import parse_policy_entry as j_parse
from policy_server_tpu.runtime import batcher as jbatcher
from policy_server_tpu.runtime import scheduler as jsched
from policy_server_tpu.server import PolicyServer as JaxPolicyServer
from policy_server_tpu.telemetry import metrics as j_metrics
from policy_server_tpu_torch import failpoints as tfp
from policy_server_tpu_torch import tenancy as tt
from policy_server_tpu_torch.api.state import ApiServerState as TState
from policy_server_tpu_torch.models.policy import parse_policy_entry as t_parse
from policy_server_tpu_torch.runtime import batcher as tbatcher
from policy_server_tpu_torch.runtime import scheduler as tsched
from policy_server_tpu_torch.server import PolicyServer
from policy_server_tpu_torch.telemetry import metrics as t_metrics

from test_torch_shards import review_doc


class Pkg:
    def __init__(self, name, fp, tenancy, sched, batcher, state_cls):
        self.name = name
        self.fp = fp
        self.t = tenancy
        self.sched = sched
        self.bm = batcher
        self.State = state_cls


JAX = Pkg("jax", jfp, jt, jsched, jbatcher, JState)
PORT = Pkg("port", tfp, tt, tsched, tbatcher, TState)
BOTH = (JAX, PORT)


@pytest.fixture(autouse=True)
def clean_failpoints():
    for pkg in BOTH:
        pkg.fp.reset()
    yield
    for pkg in BOTH:
        pkg.fp.reset()


def _both(case):
    out = {pkg.name: case(pkg) for pkg in BOTH}
    assert out["port"] == out["jax"]
    return out["port"]


# -- the manifest --------------------------------------------------------------

_MANIFEST_DOC = {
    "tenants": {
        "team-a": {
            "policies": "a.json", "weight": 2.5, "quota-rows-per-second": 100,
            "quota-burst": 25, "max-inflight": 64, "request-timeout-ms": 5000,
            "degraded-mode": "reject",
        },
    },
    "default": {"weight": 0.5, "quota-rows-per-second": 10},
    "max-concurrent-dispatches": 3,
}
_MANIFEST_YAML = """\
tenants:
  team-a:
    policies: a.json
    weight: 2.5
    quota-rows-per-second: 100
    quota-burst: 25
    max-inflight: 64
    request-timeout-ms: 5000
    degraded-mode: reject
default:
  weight: 0.5
  quota-rows-per-second: 10
max-concurrent-dispatches: 3
"""


@pytest.mark.parametrize("form", ["json", "yaml"])
def test_manifest_parses_specs_and_resolves_relative_paths(tmp_path, form):
    path = tmp_path / f"tenants.{form}"
    path.write_text(
        json.dumps(_MANIFEST_DOC) if form == "json" else _MANIFEST_YAML
    )

    def case(pkg):
        m = pkg.t.read_tenants_file(path)
        return (
            {n: dataclasses.asdict(s) for n, s in m.tenants.items()},
            dataclasses.asdict(m.default), m.max_concurrent_dispatches,
        )

    tenants, default, cap = _both(case)
    assert tenants["team-a"]["policies_path"] == str(tmp_path / "a.json")
    assert tenants["team-a"]["degraded_mode"] == "reject"
    assert default["weight"] == 0.5 and cap == 3


@pytest.mark.parametrize("text", [
    "tenants: {}\n",
    "tenants:\n  default:\n    policies: a.yml\n",
    "tenants:\n  reports:\n    policies: a.yml\n",
    "tenants:\n  t:\n    policies: a.yml\n    bogus: 1\n",
    "tenants:\n  t:\n    policies: a.yml\n    weight: 0\n",
    "tenants:\n  t: {}\n",
    "tenants:\n  t:\n    policies: a.yml\ndefault:\n  policies: b.yml\n",
    "tenants:\n  t:\n    policies: a.yml\nmax-concurrent-dispatches: 0\n",
    "tenants:\n  t:\n    policies: a.yml\n    degraded-mode: loud\n",
    "tenants:\n  a/b:\n    policies: a.yml\n",
    "- not\n- a mapping\n",
    "tenants:\n  t:\n    policies: a.yml\nextra: 1\n",
])
def test_manifest_rejects_malformed(tmp_path, text):
    path = tmp_path / "tenants.yml"
    path.write_text(text)

    def case(pkg):
        with pytest.raises(pkg.t.TenantConfigError) as e:
            pkg.t.read_tenants_file(path)
        return str(e.value)

    _both(case)


def test_yaml_manifest_without_pyyaml_is_a_clear_error(tmp_path, monkeypatch):
    """The card's machine has no PyYAML: a JSON manifest still reads, a
    YAML one raises a TenantConfigError that says why."""
    import builtins

    real_import = builtins.__import__

    def no_yaml(name, *a, **k):
        if name == "yaml":
            raise ImportError("No module named 'yaml'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    path = tmp_path / "tenants.json"
    path.write_text(json.dumps(_MANIFEST_DOC))
    assert tt.read_tenants_file(path).max_concurrent_dispatches == 3
    path.write_text(_MANIFEST_YAML)
    with pytest.raises(tt.TenantConfigError, match="PyYAML"):
        tt.read_tenants_file(path)


def test_split_tenant_path():
    _both(lambda pkg: [
        pkg.t.split_tenant_path(p)
        for p in ("pod-privileged", "team-a/pol", "a/b/c", "/x", "x/")
    ])


# -- the admission quota -------------------------------------------------------


def test_token_bucket_sheds_past_burst_and_refills():
    def case(pkg):
        adm = pkg.t.TenantAdmission("t", rows_per_second=50.0, burst=5.0)
        adm.admit(5)
        with pytest.raises(pkg.bm.ShedError) as e:
            adm.admit(1)
        assert e.value.retry_after_seconds > 0
        first = adm.stats()
        time.sleep(0.1)  # 50 rows/s: ~5 tokens back
        adm.admit(2)
        return first, adm.stats()

    first, after = _both(case)
    assert (first["admitted_rows"], first["quota_sheds"]) == (5, 1)
    assert after["admitted_rows"] == 7


def test_token_bucket_admits_bursts_larger_than_depth():
    def case(pkg):
        adm = pkg.t.TenantAdmission("t", rows_per_second=100.0, burst=8.0)
        adm.admit(16)
        with pytest.raises(pkg.bm.ShedError) as e:
            adm.admit(1)
        assert 0 < e.value.retry_after_seconds < 1.0
        time.sleep(0.15)
        adm.admit(1)
        return adm.stats()

    assert _both(case)["admitted_rows"] == 17


def test_inflight_cap_sheds_and_release_reopens():
    def case(pkg):
        adm = pkg.t.TenantAdmission("t", max_inflight=3)
        adm.admit(3)
        with pytest.raises(pkg.bm.ShedError) as e:
            adm.admit(1)
        shed = (e.value.retry_after_seconds, e.value.http_status)
        adm.release(2)
        adm.admit(2)
        mid = adm.stats()
        adm.release(100)
        return shed, mid, adm.stats()

    shed, mid, end = _both(case)
    assert shed == (0.05, 429) and mid["inflight"] == 3
    assert mid["inflight_sheds"] == 1 and end["inflight"] == 0


def test_tenant_admission_failpoint_fires_in_admit():
    def case(pkg):
        adm = pkg.t.TenantAdmission("t", rows_per_second=1000.0)

        def boom():
            raise pkg.fp.FailpointError("boom")

        with pkg.fp.active("tenant.admission", boom, scope="t"):
            with pytest.raises(pkg.fp.FailpointError):
                adm.admit(1)
        # another tenant's scope: the armed fault does not fire
        other = pkg.t.TenantAdmission("u", rows_per_second=1000.0)
        with pkg.fp.active("tenant.admission", boom, scope="t"):
            other.admit(1)
        return pkg.fp.fired_count("tenant.admission"), adm.stats(), other.stats()

    fired, adm, other = _both(case)
    assert fired == 1 and adm["admitted_rows"] == 0 and other["admitted_rows"] == 1


def test_failpoint_scope_is_thread_local_and_restored():
    def case(pkg):
        hits: list[str] = []
        pkg.fp.set_failpoint(
            "tenant.admission", lambda: hits.append("hit"), scope="tenant-a"
        )
        pkg.fp.fire("tenant.admission")
        with pkg.fp.scope("tenant-b"):
            pkg.fp.fire("tenant.admission")
            with pkg.fp.scope("tenant-a"):
                pkg.fp.fire("tenant.admission")
            inner = pkg.fp.current_scope()
        t = threading.Thread(target=lambda: pkg.fp.fire("tenant.admission"))
        t.start()
        t.join()
        return hits, inner, pkg.fp.current_scope()

    assert _both(case) == (["hit"], "tenant-b", None)


# -- the weighted-fair scheduler -----------------------------------------------


def test_scheduler_fast_path_and_release():
    def case(pkg):
        s = pkg.sched.FairDispatchScheduler(max_concurrent=2)
        assert s.acquire("a") and s.acquire("b")
        granted = []
        t = threading.Thread(
            target=lambda: granted.append(s.acquire("c", timeout=5))
        )
        t.start()
        time.sleep(0.05)
        waiting = list(granted)
        s.release("a")
        t.join(timeout=5)
        stats = s.stats()
        assert stats["c"]["wait_ns"] > 0
        return waiting, granted, {k: v["grants"] for k, v in stats.items()}

    assert _both(case) == ([], [True], {"a": 1, "b": 1, "c": 1})


def test_scheduler_timeout_and_abort():
    def case(pkg):
        s = pkg.sched.FairDispatchScheduler(max_concurrent=1)
        assert s.acquire("a")
        t0 = time.perf_counter()
        timed_out = s.acquire("b", timeout=0.15)
        assert time.perf_counter() - t0 < 2.0
        aborted = s.acquire("b", should_abort=lambda: True)
        s.release("a")
        return timed_out, aborted, s.acquire("b"), s.stats()["b"]["waiting"]

    assert _both(case) == (False, False, True, 0)


def test_scheduler_weighted_shares_converge():
    def case(pkg):
        s = pkg.sched.FairDispatchScheduler(
            max_concurrent=1, weights={"heavy": 3.0, "light": 1.0}
        )
        done = threading.Event()
        counts = {"heavy": 0, "light": 0}
        lock = threading.Lock()

        def worker(name: str) -> None:
            while not done.is_set():
                if s.acquire(name, timeout=1.0, should_abort=done.is_set):
                    with lock:
                        counts[name] += 1
                    s.release(name)

        threads = [
            threading.Thread(target=worker, args=(n,), daemon=True)
            for n in ("heavy", "light") for _ in range(2)
        ]
        for t in threads:
            t.start()
        time.sleep(0.8)
        done.set()
        for t in threads:
            t.join(timeout=5)
        total = counts["heavy"] + counts["light"]
        return total > 50 and 0.6 < counts["heavy"] / total < 0.9

    assert _both(case) is True


def test_audit_grants_do_not_charge_the_live_share():
    def case(pkg):
        s = pkg.sched.FairDispatchScheduler(
            max_concurrent=1, weights={"a": 1.0, "b": 1.0, "c": 1.0}
        )
        for _ in range(5):
            assert s.acquire("a", pkg.sched.AUDIT)
            s.release("a")
        assert s.acquire("c", pkg.sched.LIVE)
        order: list[str] = []

        def live_waiter(name: str) -> None:
            assert s.acquire(name, pkg.sched.LIVE, timeout=10)
            order.append(name)
            s.release(name)

        ta = threading.Thread(target=live_waiter, args=("a",))
        ta.start()
        time.sleep(0.05)
        tb = threading.Thread(target=live_waiter, args=("b",))
        tb.start()
        time.sleep(0.05)
        s.release("c")
        ta.join(timeout=5)
        tb.join(timeout=5)
        return order

    assert _both(case) == ["a", "b"]


def test_scheduler_audit_yields_to_live():
    def case(pkg):
        s = pkg.sched.FairDispatchScheduler(max_concurrent=1)
        assert s.acquire("a", pkg.sched.LIVE)
        order: list[str] = []

        def waiter(name: str, prio: int) -> None:
            assert s.acquire(name, prio, timeout=10)
            order.append(name)
            time.sleep(0.02)
            s.release(name)

        t_audit = threading.Thread(target=waiter, args=("aud", pkg.sched.AUDIT))
        t_audit.start()
        time.sleep(0.05)
        t_live = threading.Thread(target=waiter, args=("live", pkg.sched.LIVE))
        t_live.start()
        time.sleep(0.05)
        s.release("a")
        t_audit.join(timeout=5)
        t_live.join(timeout=5)
        return order

    assert _both(case) == ["live", "aud"]


class _StubBatcher:
    """What a readiness verdict reads of a batcher."""

    degraded_mode = "oracle"

    class env:  # noqa: N801 — an attribute bag
        breaker_all_open = False
        breaker_stats = {"trips": 0, "open_shards": 0}
        device_errors = 0


def test_tenant_shutdown_closes_the_environment_when_the_batcher_raises(caplog):
    """A named tenant without a lifecycle: its batcher's shutdown raising
    still closes its environment, and the next tenant is torn down too,
    as in the JAX package; the port logs the failure."""
    def case(pkg):
        closed = []

        class Batcher:
            def shutdown(self):
                raise RuntimeError("injected shutdown fault")

        class Env:
            def __init__(self, name):
                self.name = name

            def close(self):
                closed.append(self.name)

        mgr = pkg.t.TenantManager()
        for name in ("a", "b"):
            mgr.add(pkg.t.Tenant(
                name, pkg.t.TenantSpec(name=name),
                pkg.t.TenantState(name=name, batcher=Batcher(),
                                  evaluation_environment=Env(name)),
                None,
            ))
        mgr.shutdown()
        return closed

    with caplog.at_level("ERROR"):
        assert _both(case) == ["a", "b"]
    assert "tenant a batcher shutdown failed: injected shutdown fault" in caplog.text


def test_global_readiness_503_only_when_every_tenant_degraded():
    def case(pkg):
        b = _StubBatcher()
        state = pkg.State(evaluation_environment=b.env, batcher=b, ready=True)
        mgr = pkg.t.TenantManager()
        mgr.add(pkg.t.Tenant(pkg.t.DEFAULT_TENANT,
                             pkg.t.TenantSpec(name=pkg.t.DEFAULT_TENANT),
                             state, None))
        t_a = pkg.t.Tenant("a", pkg.t.TenantSpec(name="a"),
                           pkg.t.TenantState(name="a", ready=False), None)
        t_b = pkg.t.Tenant("b", pkg.t.TenantSpec(name="b"),
                           pkg.t.TenantState(name="b", batcher=b,
                                             evaluation_environment=b.env,
                                             ready=True), None)
        mgr.add(t_a)
        mgr.add(t_b)
        state.tenants = mgr
        out = [state.readiness(), t_a.readiness(), t_b.readiness()]
        t_b.state.ready = False
        state.ready = False
        out.append(state.readiness())
        state.tenants = None
        out.append(state.readiness())
        state.ready = True
        out.append(state.readiness())
        return out

    got = _both(case)
    assert got[0] == (200, "ok (degraded tenants: a)")
    assert [c for c, _ in got[1:]] == [503, 200, 503, 503, 200]


# -- servers with a tenants manifest --------------------------------------------

_TENANT_POLICIES = {
    "ten-a": {
        "only-a": {"module": "builtin://pod-privileged"},
        "common": {"module": "builtin://pod-privileged"},
    },
    "ten-b": {
        "only-b": {"module": "builtin://pod-privileged"},
        "common": {
            "module": "builtin://namespace-validate",
            "settings": {"denied_namespaces": ["blocked"]},
        },
    },
}
_TENANTS = {
    "tenants": {
        "ten-a": {"policies": "ten-a.json", "weight": 1.0},
        "ten-b": {"policies": "ten-b.json", "weight": 2.0},
        "ten-q": {"policies": "ten-a.json", "quota-rows-per-second": 2,
                  "quota-burst": 3, "max-inflight": 64},
    },
}
_DEFAULT = {"pod-privileged": {"module": "builtin://pod-privileged"}}


class JaxServer:
    """The JAX package's PolicyServer (host oracle) in an event-loop
    thread."""

    def __init__(self, **config) -> None:
        self.server = JaxPolicyServer.new_from_config(Config(
            addr="127.0.0.1", port=0, readiness_probe_port=0,
            tls_config=TlsConfig(), evaluation_backend="oracle",
            max_batch_size=8, batch_timeout_ms=1.0, **config,
        ))
        self.loop = asyncio.new_event_loop()
        started = threading.Event()

        def run() -> None:
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.server.start())
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(120), "the JAX server did not start"

    @property
    def port(self) -> int:
        return self.server.api_port

    @property
    def readiness_port(self) -> int:
        return self.server.readiness_port

    def stop(self) -> None:
        async def shutdown():
            await self.server.stop()
            self.loop.stop()

        asyncio.run_coroutine_threadsafe(shutdown(), self.loop)
        self.thread.join(timeout=30)


def request(port: int, method: str, path: str, body: bytes = b"") -> tuple:
    """→ (status, body, Retry-After header or None)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read(), resp.getheader("Retry-After")
    finally:
        conn.close()


def post(port: int, path: str, privileged: bool = False,
         namespace: str = "default") -> tuple:
    return request(port, "POST", path,
                   json.dumps(review_doc(namespace, privileged)).encode())


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """{"jax", "python", "native"} servers with the same tenants manifest;
    the native port server is built last, so /metrics reads its stats."""
    tmp = tmp_path_factory.mktemp("tenants")
    for name, specs in _TENANT_POLICIES.items():
        (tmp / f"{name}.json").write_text(json.dumps(specs))
    (tmp / "tenants.json").write_text(json.dumps(_TENANTS))
    (tmp / "policies.json").write_text(json.dumps(_DEFAULT))
    j_metrics.reset_metrics_for_tests()
    t_metrics.reset_metrics_for_tests()
    jax = JaxServer(
        policies={k: j_parse(k, v) for k, v in _DEFAULT.items()},
        policies_path=str(tmp / "policies.json"),
        policy_timeout_seconds=5.0,
        tenants_path=str(tmp / "tenants.json"),
        tenants=jt.read_tenants_file(tmp / "tenants.json"),
        host_fastpath_threshold=0, enable_metrics=True,
    )
    out = {"jax": jax}
    try:
        for frontend in ("python", "native"):
            server = PolicyServer(
                {k: t_parse(k, v) for k, v in _DEFAULT.items()},
                port=0, readiness_probe_port=0, device="cpu",
                max_batch_size=8, policy_timeout=5.0,
                host_fastpath_threshold=0, enable_metrics=True,
                frontend=frontend, policies_path=str(tmp / "policies.json"),
                tenants=tt.read_tenants_file(tmp / "tenants.json"),
            )
            server.start()
            out[frontend] = server
        yield out
    finally:
        for s in out.values():
            s.stop()


def _on_all(servers, fn) -> dict:
    return {name: fn(s) for name, s in servers.items()}


def _equal(got: dict):
    assert got["python"] == got["jax"] and got["native"] == got["jax"], got
    return got["jax"]


def test_tenant_routes_resolve_their_own_policy_sets(servers):
    for path, privileged, namespace in (
        ("/validate/pod-privileged", False, "default"),
        ("/validate/ten-a/only-a", True, "default"),
        ("/validate/ten-a/only-b", False, "default"),
        ("/validate/only-a", False, "default"),
        ("/validate/ten-b/common", False, "blocked"),
        ("/validate/ten-a/common", False, "blocked"),
        ("/validate_raw/ten-b/only-b", False, "default"),
        ("/audit/ten-a/only-a", True, "default"),
    ):
        got = _equal(_on_all(
            servers, lambda s: post(s.port, path, privileged, namespace)
        ))
        if path.startswith("/validate/"):
            want = {"/validate/ten-a/only-b": 404, "/validate/only-a": 404}
            assert got[0] == want.get(path, 200), path
    # the tenant's own set answered: ten-b's "common" rejects the blocked
    # namespace, ten-a's does not
    b = json.loads(post(servers["native"].port, "/validate/ten-b/common",
                        namespace="blocked")[1])
    a = json.loads(post(servers["native"].port, "/validate/ten-a/common",
                        namespace="blocked")[1])
    assert b["response"]["allowed"] is False and a["response"]["allowed"] is True


def test_unknown_tenant_404_with_shared_message(servers):
    got = _equal(_on_all(
        servers, lambda s: post(s.port, "/validate/nope/pod-privileged")
    ))
    assert got[0] == 404
    assert json.loads(got[1])["message"] == tt.unknown_tenant_message("nope")
    assert tt.unknown_tenant_message("x") == jt.unknown_tenant_message("x")


def test_per_tenant_and_global_readiness(servers):
    for path in ("/readiness", "/readiness/ten-a", "/readiness/ten-b",
                 "/readiness/nope"):
        got = _equal(_on_all(
            servers, lambda s: request(s.readiness_port, "GET", path)
        ))
        assert got[0] == (404 if path.endswith("nope") else 200), path


def test_quota_overload_sheds_tenant_q_while_b_serves(servers):
    """ten-q past its 2 rows/s, burst 3 answers 429 with Retry-After and the
    JAX package's body; ten-b's traffic beside it is all 200."""
    for name in ("jax", "python", "native"):
        s = servers[name]
        flood: list = []
        steady: list = []

        def flood_q():
            for _ in range(25):
                flood.append(post(s.port, "/validate/ten-q/common"))

        def steady_b():
            for _ in range(15):
                steady.append(post(s.port, "/validate/ten-b/common")[0])
                time.sleep(0.01)

        threads = [threading.Thread(target=flood_q),
                   threading.Thread(target=steady_b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        sheds = [(st, body, ra) for st, body, ra in flood if st == 429]
        assert len(sheds) >= 5, (name, [f[0] for f in flood])
        assert set(sheds) == {(429, json.dumps({
            "message": "policy server overloaded; retry later",
            "retry_after_seconds": 1,
        }).encode(), "1")}, name
        assert steady == [200] * 15, name
        assert {st for st, _b, _r in flood} <= {200, 429}
        adm = s.server.state.tenants.get("ten-q").admission if name == "jax" \
            else s.state.tenants.get("ten-q").admission
        assert adm.stats()["quota_sheds"] == len(sheds)
        deadline = time.monotonic() + 10
        while adm.stats()["inflight"] and time.monotonic() < deadline:
            time.sleep(0.05)
        assert adm.stats()["inflight"] == 0


def test_cross_tenant_verdict_cache_isolation(servers):
    mgr = servers["python"].state.tenants
    env_b = mgr.get("ten-b").state.evaluation_environment
    keys = ("blob_cache_hits", "blob_cache_misses", "cache_hits", "cache_misses")
    before = {k: env_b.dedup_stats[k] for k in keys}
    for _ in range(3):
        assert post(servers["python"].port, "/validate/ten-a/common", True)[0] == 200
    assert {k: env_b.dedup_stats[k] for k in keys} == before
    assert post(servers["python"].port, "/validate/ten-b/common", True)[0] == 200
    after = env_b.dedup_stats
    assert (after["blob_cache_misses"] + after["cache_misses"]
            > before["blob_cache_misses"] + before["cache_misses"])


def test_shadow_canary_rings_are_tenant_scoped(servers):
    server = servers["python"]
    post(server.port, "/validate/ten-a/ring-probe-a")
    post(server.port, "/validate/ten-b/ring-probe-b")
    mgr = server.state.tenants

    def ring(name):
        return [pid for pid, _ in mgr.get(name).state.lifecycle.recorder.snapshot()]

    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not (
        "ring-probe-a" in ring("ten-a") and "ring-probe-b" in ring("ten-b")
    ):
        time.sleep(0.05)
    assert "ring-probe-a" in ring("ten-a") and "ring-probe-a" not in ring("ten-b")
    assert "ring-probe-b" in ring("ten-b") and "ring-probe-b" not in ring("ten-a")
    default = [pid for pid, _ in server.lifecycle.recorder.snapshot()]
    assert "ring-probe-a" not in default and "ring-probe-b" not in default


def test_per_tenant_reload_advances_one_epoch_only(servers):
    server = servers["python"]
    mgr = server.state.tenants
    lc_a, lc_b = mgr.get("ten-a").state.lifecycle, mgr.get("ten-b").state.lifecycle
    epoch_b, epoch_default = lc_b.current_epoch, server.lifecycle.current_epoch
    before_a = lc_a.current_epoch
    assert lc_a.reload(reason="test") == "promoted"
    assert lc_a.current_epoch == before_a + 1
    assert (lc_b.current_epoch, server.lifecycle.current_epoch) == (
        epoch_b, epoch_default
    )
    assert post(server.port, "/validate/ten-a/only-a")[0] == 200


def test_tenant_reload_failpoint_rejects_one_tenant_only(servers):
    server = servers["python"]
    mgr = server.state.tenants
    lc_a, lc_b = mgr.get("ten-a").state.lifecycle, mgr.get("ten-b").state.lifecycle

    def boom():
        raise tfp.FailpointError("tenant reload fault")

    tfp.set_failpoint("tenant.reload", boom, scope="ten-a")
    with pytest.raises(Exception, match="tenant reload fault"):
        lc_a.reload(reason="test")
    assert lc_b.reload(reason="test") == "promoted"
    assert lc_a.stats()["last_outcome"].startswith("rejected")


def test_tenant_metrics_families_exported(servers):
    text = request(servers["native"].readiness_port, "GET", "/metrics")[1].decode()
    for line in (
        'policy_server_tenant_admitted_rows_total{tenant="ten-q"}',
        'policy_server_tenant_shed_rows_total{tenant="ten-q"}',
        'policy_server_tenant_policy_epoch{tenant="ten-b"}',
        'policy_server_tenant_queue_depth{tenant="ten-a"}',
        'policy_server_tenant_ready{tenant="default"}',
        "policy_server_tenants_serving 4.0",
    ):
        assert line in text, line
    shed = servers["native"].state.tenants.get("ten-q").admission.stats()
    assert re.search(
        r'^policy_server_tenant_shed_rows_total\{tenant="ten-q"\} '
        + re.escape(f"{float(shed['shed_rows'])}") + "$", text, re.M,
    )


def test_scheduler_accounts_tenant_grants(servers):
    for name in ("python", "native"):
        stats = servers[name].state.tenants.scheduler.stats()
        assert stats["ten-a"]["grants"] > 0 and stats["ten-b"]["grants"] > 0


def test_sighup_reloads_every_tenant(servers):
    server = servers["native"]
    mgr = server.state.tenants
    before = {t.name: t.state.lifecycle.stats()["reloads"] for t in mgr.all()}
    server.reload_signal()
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and any(
        t.state.lifecycle.stats()["reloads"] <= before[t.name]
        or t.state.lifecycle.reload_in_flight() for t in mgr.all()
    ):
        time.sleep(0.05)
    assert all(
        t.state.lifecycle.stats()["reloads"] == before[t.name] + 1
        for t in mgr.all()
    )


# -- the default flags' /metrics families ---------------------------------------


def _families(text: str, prefixes) -> set:
    return {
        n for n in re.findall(r"^# TYPE (\S+) \S+$", text, re.M)
        if n.startswith(prefixes)
    }


def test_default_flag_metrics_export_the_same_shed_tenant_and_shard_families(tmp_path):
    prefixes = ("policy_server_shed", "policy_server_expired",
                "policy_server_tenant", "policy_server_shard")
    j_metrics.reset_metrics_for_tests()
    t_metrics.reset_metrics_for_tests()
    jax = JaxServer(policies={k: j_parse(k, v) for k, v in _DEFAULT.items()},
                    enable_metrics=True)
    try:
        want = request(jax.readiness_port, "GET", "/metrics")[1].decode()
    finally:
        jax.stop()
    port = PolicyServer(
        {k: t_parse(k, v) for k, v in _DEFAULT.items()}, port=0,
        readiness_probe_port=0, device="cpu", enable_metrics=True,
    )
    port.start()
    try:
        assert port.batcher.request_timeout == 10.0
        got = request(port.readiness_port, "GET", "/metrics")[1].decode()
    finally:
        port.stop()
    fams = _families(got, prefixes)
    assert fams == _families(want, prefixes)
    assert len(fams) == 20, sorted(fams)


@pytest.mark.parametrize("frontend", ["python", "native"])
def test_tenants_at_two_shards_answer_the_jax_packages_bytes(servers, tmp_path, frontend):
    """A port server with the same manifest at --serving-shards 2: every
    tenant's plane is a shard router, and each route answers what the JAX
    package's server (one shard) answers."""
    from policy_server_tpu_torch.runtime.shards import ShardRouter

    for name, specs in _TENANT_POLICIES.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(specs))
    (tmp_path / "tenants.json").write_text(json.dumps(_TENANTS))
    server = PolicyServer(
        {k: t_parse(k, v) for k, v in _DEFAULT.items()},
        port=0, readiness_probe_port=0, device="cpu", max_batch_size=8,
        policy_timeout=5.0, host_fastpath_threshold=0, frontend=frontend,
        serving_shards=2, policy_reload_mode="off",
        tenants=tt.read_tenants_file(tmp_path / "tenants.json"),
    )
    server.start()
    try:
        assert all(
            type(t.state.batcher) is ShardRouter
            for t in server.state.tenants.all()
        )
        for path, privileged, namespace in (
            ("/validate/pod-privileged", True, "default"),
            ("/validate/ten-a/only-a", True, "default"),
            ("/validate/ten-b/common", False, "blocked"),
            ("/validate/ten-b/only-a", False, "default"),
            ("/validate/nope/only-a", False, "default"),
            ("/validate_raw/ten-b/only-b", False, "default"),
        ):
            want = post(servers["jax"].port, path, privileged, namespace)
            assert post(server.port, path, privileged, namespace) == want, path
        for path in ("/readiness", "/readiness/ten-b", "/readiness/nope"):
            assert request(server.readiness_port, "GET", path) == request(
                servers["jax"].readiness_port, "GET", path
            ), path
    finally:
        server.stop()
