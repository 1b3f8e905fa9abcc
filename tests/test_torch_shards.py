"""The port's serving shards (``policy_server_tpu_torch/runtime/shards.py``)
held against the JAX package's (``policy_server_tpu/runtime/shards.py``):
each case of ``tests/test_shards.py`` but the two state-store ones runs
through both packages on the same reviews, and the verdicts, exceptions and
counters must be equal (tolerance 0: these are bytes and integers). The
JAX side serves through its host oracle, the port's through the kernel's
plain version on the CPU. Also held: a dispatch loop that dies holding
popped rows answers each one 503 ``FencedError`` with Retry-After, equal to
the JAX package's answer, through the batcher and both frontends, and a
server at ``--serving-shards 2`` answers the bytes of one at 1 and of the
JAX package's."""

from __future__ import annotations

import copy
import json
import logging
import threading
import time

import pytest

from policy_server_tpu import failpoints as jfp
from policy_server_tpu.api import service as jservice
from policy_server_tpu.api.service import RequestOrigin as JOrigin
from policy_server_tpu.evaluation.environment import (
    EvaluationEnvironmentBuilder as JBuilder,
)
from policy_server_tpu.models import AdmissionReviewRequest as JReview
from policy_server_tpu.models import AdmissionReviewResponse as JReviewResponse
from policy_server_tpu.models import ValidateRequest as JValidateRequest
from policy_server_tpu.models.policy import parse_policy_entry as j_parse
from policy_server_tpu.runtime import batcher as jbatcher
from policy_server_tpu.runtime import native_frontend as jnf
from policy_server_tpu.runtime import shards as jshards
from policy_server_tpu.tenancy import TenantAdmission as JAdmission
from policy_server_tpu_torch import failpoints as tfp
from policy_server_tpu_torch.api.handlers import evaluate_body
from policy_server_tpu_torch.api.service import RequestOrigin as TOrigin
from policy_server_tpu_torch.evaluation.environment import (
    EvaluationEnvironmentBuilder as TBuilder,
)
from policy_server_tpu_torch.models import AdmissionReviewRequest as TReview
from policy_server_tpu_torch.models import ValidateRequest as TValidateRequest
from policy_server_tpu_torch.models.policy import parse_policy_entry as t_parse
from policy_server_tpu_torch.runtime import batcher as tbatcher
from policy_server_tpu_torch.runtime import native_frontend as tnf
from policy_server_tpu_torch.runtime import shards as tshards
from policy_server_tpu_torch.tenancy import TenantAdmission as TAdmission

from conftest import build_admission_review_dict
from torch_port_support import jax_native_libraries  # noqa: F401 (autouse)

SPECS = {
    "ns": {
        "module": "builtin://namespace-validate",
        "settings": {"denied_namespaces": ["blocked"]},
    },
    "priv": {"module": "builtin://pod-privileged"},
}
SHARD_KEYS = {
    "shard_fences", "shard_reroutes", "shard_fenced_rows",
    "shard_respawns", "shard_heartbeat_faults",
}


class Pkg:
    """One package's shard surface, environment builder and requests."""

    def __init__(self, name, fp, origin, builder, parse, review_cls,
                 request_cls, batcher_mod, shards_mod, admission_cls, **env_kw):
        self.name = name
        self.fp = fp
        self.origin = origin
        self._builder = builder
        self._parse = parse
        self._review_cls = review_cls
        self._request_cls = request_cls
        self.bm = batcher_mod
        self.sm = shards_mod
        self.Admission = admission_cls
        self._env_kw = env_kw

    def build_env(self, policies):
        return self._builder(**self._env_kw).build(policies)

    def policies(self):
        return {k: self._parse(k, v) for k, v in SPECS.items()}

    def make(self, env, **kw):
        return self.bm.MicroBatcher(
            env, max_batch_size=8, batch_timeout_ms=1.0, policy_timeout=5.0,
            **kw,
        )

    def review(self, namespace: str = "default", privileged: bool = False):
        return self._request_cls.from_admission(
            self._review_cls.from_dict(review_doc(namespace, privileged)).request
        )

    def router(self, count=2, make=None, **kw):
        """A started router whose heartbeat is long enough that the test
        drives fencing with check_shards()."""
        r = self.sm.build_serving_shards(
            self.build_env(self.policies()), make or self.make,
            self.build_env, count, heartbeat_seconds=30.0, **kw,
        )
        r.start()
        return r


JAX = Pkg("jax", jfp, JOrigin.VALIDATE, JBuilder, j_parse, JReview,
          JValidateRequest, jbatcher, jshards, JAdmission, backend="oracle")
PORT = Pkg("port", tfp, TOrigin.VALIDATE, TBuilder, t_parse, TReview,
           TValidateRequest, tbatcher, tshards, TAdmission, device="cpu")
BOTH = (JAX, PORT)


def review_doc(namespace: str = "default", privileged: bool = False) -> dict:
    doc = build_admission_review_dict()
    doc["request"]["namespace"] = namespace
    doc["request"]["object"] = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": "p", "namespace": namespace},
        "spec": {"containers": [{
            "name": "c", "image": "nginx",
            "securityContext": {"privileged": privileged},
        }]},
    }
    return doc


@pytest.fixture(autouse=True)
def clean_failpoints():
    for pkg in BOTH:
        pkg.fp.reset()
    yield
    for pkg in BOTH:
        pkg.fp.reset()


def _die():
    raise RuntimeError("injected shard death")


def _wait_wedged(batcher, timeout=5.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if batcher.dispatch_wedged():
            return
        time.sleep(0.02)
    raise AssertionError("dispatch thread never wedged")


def _kill(pkg, router, index: int):
    pkg.fp.set_failpoint("shard.dispatch", _die, count=1, scope=f"shard-{index}")
    victim = router._shards[index].batcher
    _wait_wedged(victim)
    pkg.fp.clear("shard.dispatch")
    return victim


def _dict(resp) -> dict:
    if hasattr(resp, "to_response"):
        resp = resp.to_response()
    return resp.to_dict()


def _shed(exc) -> tuple:
    return (type(exc).__name__, exc.http_status, exc.message,
            exc.retry_after_seconds)


def _both(case) -> None:
    """Run ``case(pkg)`` through both packages; their outcomes must be
    equal."""
    out = {pkg.name: case(pkg) for pkg in BOTH}
    assert out["port"] == out["jax"]
    return out["port"]


# -- M = 1 bypass --------------------------------------------------------------


def test_m1_bypass_returns_the_plain_batcher():
    def case(pkg):
        env = pkg.build_env(pkg.policies())
        b = pkg.sm.build_serving_shards(env, pkg.make, pkg.build_env, 1)
        try:
            return (
                type(b) is pkg.bm.MicroBatcher, b.env is env,
                hasattr(b, "shard_health"), b.failpoint_scope,
                "shard_fences" in b.stats_snapshot(),
            )
        finally:
            b.shutdown()
            env.close()

    assert _both(case) == (True, True, False, None, False)


def test_m1_vs_m2_bit_exact_verdicts_and_counter_parity():
    def case(pkg):
        corpus = [
            ("ns", pkg.review("default")), ("ns", pkg.review("blocked")),
            ("priv", pkg.review(privileged=True)),
            ("priv", pkg.review(privileged=False)),
        ] * 2
        runs = []
        for count in (1, 2):
            env = pkg.build_env(pkg.policies())
            b = pkg.sm.build_serving_shards(env, pkg.make, pkg.build_env, count)
            b.start()
            try:
                out = [
                    json.dumps(_dict(b.submit(pid, r, pkg.origin).result(30)),
                               sort_keys=True)
                    for pid, r in corpus
                ]
                runs.append((out, set(b.stats_snapshot())))
            finally:
                b.shutdown()
                env.close()
        (v1, k1), (v2, k2) = runs
        assert k2 == k1 | SHARD_KEYS, pkg.name
        return v1, v2

    v1, v2 = _both(case)
    assert v1 == v2


# -- routing -------------------------------------------------------------------


def test_routing_prefers_the_shallow_queue_by_ewma():
    def case(pkg):
        r = pkg.router()
        try:
            picks = []
            for ewmas in ((50.0, 0.0), (0.0, 50.0)):
                with r._lock:
                    for s, e in zip(r._shards, ewmas):
                        s.ewma = e
                picks.append(r._pick().index)
            return picks
        finally:
            r.shutdown()

    assert _both(case) == [1, 0]


def test_routing_skips_fenced_shards_and_never_strands():
    def case(pkg):
        r = pkg.router()
        try:
            with r._lock:
                r._shards[0].healthy = False
            picks = [r._pick().index for _ in range(5)]
            with r._lock:
                r._shards[1].healthy = False
            return picks, r._pick() is not None
        finally:
            r.shutdown()

    assert _both(case) == ([1] * 5, True)


def test_router_duck_types_the_batcher_surface():
    def case(pkg):
        r = pkg.router()
        try:
            resp = r.submit("ns", pkg.review("blocked"), pkg.origin).result(30)
            return (
                r.serving_shards, r.queue_depth(), r.estimated_wait() >= 0.0,
                r.max_batch_size == r._shards[0].batcher.max_batch_size,
                r.env is r._shards[0].env, _dict(resp),
            )
        finally:
            r.shutdown()

    got = _both(case)
    assert got[:5] == (2, 0, True, True, True) and got[5]["allowed"] is False


# -- fencing -------------------------------------------------------------------


def test_scoped_dispatch_kill_fences_reroutes_and_warm_revives():
    def case(pkg):
        r = pkg.router()
        try:
            victim = _kill(pkg, r, 0)
            assert not r._shards[1].batcher.dispatch_wedged()
            futs = [
                victim.submit_nowait(
                    "ns", pkg.review("blocked" if i % 2 else "default"),
                    pkg.origin,
                )
                for i in range(4)
            ]
            owners = [p.owner is victim for p in list(victim._queue.queue)]
            fenced = r.check_shards()
            answers = [_dict(f.result(timeout=30)) for f in futs]
            stats = {k: r.stats_snapshot()[k] for k in SHARD_KEYS}
            health = [(h["healthy"], h["dispatch_alive"]) for h in r.shard_health()]
            after = _dict(r.submit("ns", pkg.review(), pkg.origin).result(30))
            return owners, fenced, answers, stats, health, after
        finally:
            r.shutdown()

    owners, fenced, answers, stats, health, after = _both(case)
    assert owners == [True] * 4 and fenced == 1
    assert [a["allowed"] for a in answers] == [True, False, True, False]
    assert stats == {"shard_fences": 1, "shard_reroutes": 4,
                     "shard_fenced_rows": 0, "shard_respawns": 1,
                     "shard_heartbeat_faults": 0}
    assert health == [(True, True)] * 2 and after["allowed"] is True


def test_fence_without_sibling_answers_503_fenced_error():
    def case(pkg):
        r = pkg.router()
        try:
            victim = _kill(pkg, r, 0)
            futs = [
                victim.submit_nowait("ns", pkg.review(), pkg.origin)
                for _ in range(3)
            ]
            with r._lock:
                r._shards[1].healthy = False
            r._fence(r._shards[0], "test: no sibling")
            errs = []
            for f in futs:
                with pytest.raises(pkg.bm.FencedError) as e:
                    f.result(timeout=10)
                assert isinstance(e.value, pkg.bm.ShedError)
                errs.append(_shed(e.value))
            stats = r.stats_snapshot()
            return errs, stats["shard_fenced_rows"], stats["shard_reroutes"]
        finally:
            r.shutdown()

    errs, fenced_rows, reroutes = _both(case)
    assert errs == [("FencedError", 503, "serving shard fenced; retry later", 30.0)] * 3
    assert (fenced_rows, reroutes) == (3, 0)


def test_fence_drain_clears_ownership_and_reroute_restamps():
    def case(pkg):
        r = pkg.router()
        try:
            victim = _kill(pkg, r, 0)
            sibling = _kill(pkg, r, 1)
            futs = [
                victim.submit_nowait("ns", pkg.review(), pkg.origin)
                for _ in range(3)
            ]
            rows = victim.fence_drain()
            cleared = [p.owner is None for p in rows]
            depth = victim.queue_depth()
            overflow = sibling._put_burst(rows)
            stamped = [p.owner is sibling for p in list(sibling._queue.queue)]
            revived = sibling.revive_dispatch()
            answers = [_dict(f.result(timeout=30))["allowed"] for f in futs]
            return cleared, depth, overflow, stamped, revived, answers, \
                victim.revive_dispatch()
        finally:
            r.shutdown()

    assert _both(case) == (
        [True] * 3, 0, [], [True] * 3, True, [True] * 3, True,
    )


def test_heartbeat_probe_fault_fences_then_recovers():
    def case(pkg):
        r = pkg.router()
        try:
            pkg.fp.set_failpoint("shard.heartbeat", _die, count=1, scope="shard-1")
            first = r.check_shards()
            health = [h["healthy"] for h in r.shard_health()]
            stats = {k: r.stats_snapshot()[k] for k in SHARD_KEYS}
            second = r.check_shards()
            return first, health, stats, second, [
                h["healthy"] for h in r.shard_health()
            ]
        finally:
            r.shutdown()

    first, health, stats, second, after = _both(case)
    assert (first, health, second, after) == (1, [True, False], 0, [True, True])
    assert stats["shard_heartbeat_faults"] == 1 and stats["shard_fences"] == 1
    assert stats["shard_respawns"] == 0


# -- the dying dispatch loop (the 500 repaired to the JAX package's 503) -------


def test_dead_dispatch_mid_iteration_fails_held_rows_exactly_once():
    """A loop that dies after popping rows answers each popped row
    FencedError (503 with Retry-After), never the exception it died of
    (which the frontends answer 500); once revived, it serves."""
    def case(pkg):
        env = pkg.build_env(pkg.policies())
        b = pkg.make(env)
        b.start()
        try:
            orig = b._launch_batch

            def exploding_launch(batch):
                raise RuntimeError("injected mid-iteration death")

            b._launch_batch = exploding_launch
            fut = b.submit_nowait("ns", pkg.review(), pkg.origin)
            with pytest.raises(pkg.bm.FencedError) as e:
                fut.result(timeout=10)
            _wait_wedged(b)
            b._launch_batch = orig
            revived = b.revive_dispatch()
            after = _dict(b.submit("ns", pkg.review(), pkg.origin).result(30))
            return _shed(e.value), revived, after["allowed"]
        finally:
            b.shutdown()
            env.close()

    assert _both(case) == (
        ("FencedError", 503, "serving shard fenced; retry later", 0.5), True, True,
    )


class _Sink:
    def __init__(self):
        self.items = []
        self.done = threading.Event()

    def deliver_many(self, items):
        self.items.extend(items)
        self.done.set()


class _CaptureFrontend:
    def __init__(self):
        self.answers = {}
        self.done = threading.Event()

    def complete(self, req_id, status, body, retry_after=0):
        self.answers[req_id] = (status, body, retry_after)
        self.done.set()


def test_dying_loop_rows_answer_503_through_both_frontends():
    """The same death under a sink (the native frontend's path) and through
    the standard-library frontend's body: 503, Retry-After 1 and the JAX
    package's fenced body, never a 500."""
    body = json.dumps(review_doc()).encode()
    want_body = jnf._shed_body(1, jbatcher.FencedError.message)

    def dying(pkg, b):
        def exploding_launch(batch):
            raise RuntimeError("injected mid-iteration death")

        b._launch_batch = exploding_launch
        b.start()

    # the JAX native frontend's sink and the port's, each through a
    # capturing frontend
    got = {}
    for pkg, nfmod in ((JAX, jnf), (PORT, tnf)):
        env = pkg.build_env(pkg.policies())
        b = pkg.make(env)
        try:
            front = _CaptureFrontend()
            sink = nfmod.BatcherSink(_StateOf(env, b))
            dying(pkg, b)
            b.submit_many([("ns", pkg.review())], pkg.origin, sink=sink,
                          tokens=[(front, 7, False)])
            assert front.done.wait(10)
            got[pkg.name] = front.answers[7]
        finally:
            b.shutdown()
            env.close()
    assert got["port"] == got["jax"] == (503, want_body, 1)

    # the port's standard-library frontend, and its Retry-After header
    env = PORT.build_env(PORT.policies())
    b = PORT.make(env)
    try:
        dying(PORT, b)
        status, payload, headers = evaluate_body(b, "validate", "ns", body)
        assert (status, payload) == (503, want_body)
        assert headers == {"Retry-After": "1"}
    finally:
        b.shutdown()
        env.close()


class _StateOf:
    """The state a BatcherSink reads (its batcher)."""

    def __init__(self, env, batcher):
        self.evaluation_environment = env
        self.batcher = batcher
        self.tenants = None


# -- the tenant quota across a fence -------------------------------------------


def _counting_admission(pkg):
    class Counting(pkg.Admission):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.released_rows = 0

        def release(self, n: int = 1) -> None:
            self.released_rows += n
            super().release(n)

    return Counting("capped", max_inflight=8)


def _quota_case(pkg, no_sibling: bool):
    adm = _counting_admission(pkg)
    r = pkg.router(make=lambda e: pkg.make(e, admission=adm))
    try:
        victim = _kill(pkg, r, 0)
        n = 4 if no_sibling else 6
        futs = victim.submit_many(
            [("ns", pkg.review()) for _ in range(n)], pkg.origin
        )
        inflight = adm.stats()["inflight"]
        if no_sibling:
            with r._lock:
                r._shards[1].healthy = False
            r._fence(r._shards[0], "test: no sibling")
            answers = []
            for f in futs:
                with pytest.raises(pkg.bm.FencedError) as e:
                    f.result(timeout=10)
                answers.append(_shed(e.value))
        else:
            assert r.check_shards() == 1
            answers = [_dict(f.result(timeout=30))["allowed"] for f in futs]
        out = (inflight, answers, adm.released_rows, adm.stats())
        adm.admit(8)
        adm.release(8)
        return out
    finally:
        r.shutdown()


def test_shard_kill_releases_quota_exactly_once_on_reroute():
    inflight, answers, released, stats = _both(lambda p: _quota_case(p, False))
    assert (inflight, answers, released) == (6, [True] * 6, 6)
    assert stats["inflight"] == 0 and stats["admitted_rows"] == 6


def test_shard_kill_releases_quota_exactly_once_on_503():
    inflight, answers, released, stats = _both(lambda p: _quota_case(p, True))
    assert (inflight, released, stats["inflight"]) == (4, 4, 0)
    assert [a[1] for a in answers] == [503] * 4


# -- shutdown ------------------------------------------------------------------


def test_shutdown_drains_shards_in_sequence_and_closes_owned_envs():
    def case(pkg):
        env = pkg.build_env(pkg.policies())
        closed = []
        r = pkg.sm.build_serving_shards(
            env, pkg.make, pkg.build_env, 3, heartbeat_seconds=30.0
        )
        r.start()
        for s in r._shards[1:]:
            orig_close = s.env.close

            def tracking_close(*a, _orig=orig_close, _i=s.index, **k):
                closed.append(_i)
                return _orig(*a, **k)

            s.env.close = tracking_close
        futs = [
            r.submit_nowait("ns", pkg.review(), pkg.origin) for _ in range(4)
        ]
        r.shutdown()
        done = [f.done() for f in futs]
        env.close()
        return done, closed

    assert _both(case) == ([True] * 4, [1, 2])


# -- the server: --serving-shards 2 against 1 and against the JAX package ------


def _server_bodies(serving_shards: int, frontend: str, docs) -> list:
    import http.client

    from policy_server_tpu_torch.server import PolicyServer

    server = PolicyServer(
        PORT.policies(), port=0, readiness_probe_port=0, device="cpu",
        serving_shards=serving_shards, frontend=frontend,
        policy_reload_mode="off", selfheal_interval_seconds=0,
        shard_heartbeat_seconds=0.05,
    )
    server.start()
    try:
        assert (type(server.batcher) is tbatcher.MicroBatcher) == (
            serving_shards == 1
        )
        out = []
        for pid, d in docs:
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
            conn.request("POST", f"/validate/{pid}", body=json.dumps(d).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            out.append((resp.status, resp.read()))
            conn.close()
        return out
    finally:
        server.stop()


@pytest.mark.parametrize("frontend", ["python", "native"])
def test_server_at_two_shards_answers_the_bytes_of_one_and_of_jax(frontend):
    docs = []
    for i in range(6):
        d = review_doc("blocked" if i % 3 == 0 else "default", i % 2 == 0)
        d["request"]["uid"] = f"uid-{i}"
        docs.append(("ns" if i % 2 else "priv", d))
        docs.append(("missing", copy.deepcopy(d)))
    one = _server_bodies(1, frontend, docs)
    two = _server_bodies(2, frontend, docs)
    assert one == two
    jenv = JAX.build_env(JAX.policies())
    for (pid, d), (status, body) in zip(docs, two):
        req = JValidateRequest.from_admission(JReview.from_dict(d).request)
        if pid == "missing":
            assert status == 404
            continue
        want = jservice.evaluate(jenv, pid, req, JOrigin.VALIDATE)
        assert (status, body) == (
            200, json.dumps(JReviewResponse(want).to_dict()).encode()
        )


def test_killed_shard_is_fenced_revived_and_counted_once():
    """Two revivers watch the loops: the self-heal watchdog (here every
    50 ms) sees only the router's heartbeat, which fences and revives the
    killed shard, so the revive counts once on /metrics."""
    from policy_server_tpu_torch.server import PolicyServer

    server = PolicyServer(
        PORT.policies(), port=0, readiness_probe_port=0, device="cpu",
        serving_shards=2, shard_heartbeat_seconds=0.05,
        selfheal_interval_seconds=0.05, policy_reload_mode="off",
        enable_metrics=True,
    )
    server.start()
    try:
        router = server.batcher
        # a 50 ms heartbeat may revive the loop before a poll sees it dead,
        # so wait for the revive itself
        PORT.fp.set_failpoint("shard.dispatch", _die, count=1, scope="shard-1")
        deadline = time.monotonic() + 10
        while router.stats_snapshot()["shard_respawns"] < 1:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        PORT.fp.clear("shard.dispatch")
        time.sleep(0.3)  # several more watchdog and heartbeat passes
        stats = router.stats_snapshot()
        assert (stats["shard_fences"], stats["shard_respawns"]) == (1, 1)
        assert server.state.supervisor.stats()["batcher_revives"] == 1
        from policy_server_tpu_torch.telemetry import default_registry

        text = default_registry().exposition().decode()
        for line in ("policy_server_shard_fences_total 1.0",
                     "policy_server_shard_respawns_total 1.0",
                     "policy_server_selfheal_batcher_revives_total 1.0",
                     "policy_server_shards_serving 2.0",
                     'policy_server_shard_healthy{shard="1"} 1.0'):
            assert line in text, line
        status, payload, _headers = evaluate_body(
            router, "validate", "priv", json.dumps(review_doc()).encode()
        )
        assert status == 200 and json.loads(payload)["response"]["allowed"]
    finally:
        server.stop()


# -- the durable incident journal (statestore.py) --------------------------------


class _FakeIncidentStore:
    """A store carrying a canned shard incident log."""

    def __init__(self, events):
        self._events = events

    def shard_events(self):
        return list(self._events)

    def record_shard_event(self, event):
        self._events.append(dict(event))


class _BrokenIncidentStore:
    def shard_events(self):
        raise OSError("journal unreadable")


class _WriteFailsStore(_FakeIncidentStore):
    def record_shard_event(self, event):
        raise OSError("journal unwritable")


def test_router_counters_seed_from_durable_incident_journal():
    """A rebuilt router (a reload epoch, a restart) resumes its fence,
    re-route and respawn counters from the incident journal."""
    events = [
        {"shard": 1, "reason": "wedged dispatch",
         "rows_rerouted": 3, "rows_fenced": 2},
        {"shard": 1, "reason": "warm-respawn"},
        {"shard": 0, "reason": "probe fault",
         "rows_rerouted": 0, "rows_fenced": 5},
    ]

    def case(pkg):
        r = pkg.router(statestore=_FakeIncidentStore(list(events)))
        try:
            return {k: r.stats_snapshot()[k] for k in SHARD_KEYS}
        finally:
            r.shutdown()

    assert _both(case) == {
        "shard_fences": 2, "shard_reroutes": 3, "shard_fenced_rows": 7,
        "shard_respawns": 1, "shard_heartbeat_faults": 1,
    }


@pytest.mark.parametrize("store", ["none", "empty", "broken"])
def test_router_counters_zero_on_empty_or_broken_journal(store, caplog):
    """No journal, an empty one and one that cannot be read all seed zero;
    the unreadable journal is logged at error level by the port."""
    def case(pkg):
        made = {"none": None, "empty": _FakeIncidentStore([]),
                "broken": _BrokenIncidentStore()}[store]
        r = pkg.router(statestore=made)
        try:
            return {k: r.stats_snapshot()[k] for k in SHARD_KEYS}
        finally:
            r.shutdown()

    with caplog.at_level(logging.ERROR):
        assert _both(case) == dict.fromkeys(SHARD_KEYS, 0)
    logged = [
        rec for rec in caplog.records
        if rec.levelno == logging.ERROR
        and "shard incident journal unreadable" in rec.getMessage()
    ]
    assert len(logged) == (1 if store == "broken" else 0)


def test_fences_and_respawns_are_journaled_and_seed_the_next_router(tmp_path):
    """With a real state store: a killed shard's fence and warm respawn
    are journaled (the same events in both packages), and a router built
    afterwards over the same store (the next epoch, or the process after
    a crash) starts from the counters the first one ended with."""
    from policy_server_tpu import statestore as jss
    from policy_server_tpu_torch import statestore as tss

    def case(pkg):
        ss = jss if pkg is JAX else tss
        store = ss.StateStore(tmp_path / pkg.name)
        r = pkg.router(statestore=store)
        try:
            _kill(pkg, r, 0)
            fut = r._shards[0].batcher.submit_nowait(
                "ns", pkg.review("blocked"), pkg.origin
            )
            r.check_shards()
            fut.result(timeout=30)
            before = {k: r.stats_snapshot()[k] for k in SHARD_KEYS}
        finally:
            r.shutdown()
        events = [
            {k: v for k, v in ev.items() if k != "time"}
            for ev in ss.StateStore(tmp_path / pkg.name).shard_events()
        ]
        r2 = pkg.router(statestore=ss.StateStore(tmp_path / pkg.name))
        try:
            after = {k: r2.stats_snapshot()[k] for k in SHARD_KEYS}
        finally:
            r2.shutdown()
        return before, events, after

    before, events, after = _both(case)
    assert before == after and before["shard_fences"] == 1
    assert events == [
        {"shard": 0, "reason": "wedged dispatch", "rows_rerouted": 1,
         "rows_fenced": 0},
        {"shard": 0, "reason": "warm-respawn"},
    ]


def test_failed_journal_write_is_logged_and_the_fence_stands(caplog):
    """A journal write that fails never fails the fence: the counters are
    the JAX package's, and the port logs the failure at error level."""
    def case(pkg):
        r = pkg.router(statestore=_WriteFailsStore([]))
        try:
            _kill(pkg, r, 1)
            fenced = r.check_shards()
            return fenced, {k: r.stats_snapshot()[k] for k in SHARD_KEYS}
        finally:
            r.shutdown()

    with caplog.at_level(logging.ERROR):
        fenced, stats = _both(case)
    assert fenced == 1 and stats["shard_fences"] == 1
    assert stats["shard_respawns"] == 1
    logged = [
        rec for rec in caplog.records
        if "could not journal shard incident" in rec.getMessage()
    ]
    assert len(logged) == 2 and all(
        rec.levelno == logging.ERROR for rec in logged
    )
