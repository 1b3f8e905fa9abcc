"""The port's self-heal watchdog and supervision counters
(``policy_server_tpu_torch/supervision.py``) held against the JAX
package's (``policy_server_tpu/supervision.py``): the counters after the
same calls, a batcher whose dispatch loop was killed (the ``shard.dispatch``
failpoint, before any pop) revived by each package's watchdog with the same
counts and the same bodies served after the revive, no revive during
shutdown, and the drainer check over the same fake frontends. On the port's
servers (``device="cpu"``): a killed dispatch loop and a killed native
drainer are revived, counted on ``/metrics`` under the JAX package's
family names, and serving resumes with the JAX package's bodies. Tolerance
0: counts and bytes."""

from __future__ import annotations

import http.client
import json
import re
import time

import pytest

from policy_server_tpu import failpoints as jfp
from policy_server_tpu import supervision as jsup
from policy_server_tpu.api.service import RequestOrigin as JOrigin
from policy_server_tpu.api.service import evaluate as jevaluate
from policy_server_tpu.api.state import ApiServerState as JState
from policy_server_tpu.models import AdmissionReviewResponse as JReviewResponse
from policy_server_tpu.runtime.batcher import MicroBatcher as JBatcher
from policy_server_tpu_torch import failpoints as tfp
from policy_server_tpu_torch import supervision as tsup
from policy_server_tpu_torch.api.service import RequestOrigin as TOrigin
from policy_server_tpu_torch.api.state import ApiServerState as TState
from policy_server_tpu_torch.models import AdmissionReviewResponse as TReviewResponse
from policy_server_tpu_torch.models.policy import parse_policy_entry as tparse
from policy_server_tpu_torch.runtime.batcher import MicroBatcher as TBatcher
from policy_server_tpu_torch.server import PolicyServer

from torch_port_support import firehose_docs, items_for, jax_env, torch_env

SPECS = {"pod-privileged": {"module": "builtin://pod-privileged"}}


@pytest.fixture(autouse=True)
def clean_failpoints():
    jfp.reset()
    tfp.reset()
    yield
    jfp.reset()
    tfp.reset()


@pytest.fixture(scope="module")
def envs():
    return jax_env(SPECS), torch_env(SPECS)


def wait_for(pred, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def test_supervisor_stats_counters_match():
    out = {}
    for sup in (jsup, tsup):
        stats = sup.SupervisorStats()
        stats.count_respawn(0.5)
        stats.count_respawn(1.0)
        stats.count_respawn(-3.0)
        stats.count_slot_given_up()
        stats.count_batcher_revive()
        stats.count_frontend_revive()
        stats.count_frontend_revive()
        out[sup.__name__] = stats.stats()
    assert out["policy_server_tpu_torch.supervision"] == out["policy_server_tpu.supervision"]


def _sides(envs):
    jenv, tenv = envs
    return (
        ("jax", jenv, JBatcher, JState, jsup, jfp, JOrigin.VALIDATE, JReviewResponse, 1),
        ("port", tenv, TBatcher, TState, tsup, tfp, TOrigin.VALIDATE, TReviewResponse, 2),
    )


def _kill_once(fp, batcher) -> None:
    """Kill ``batcher``'s dispatch loop once. The fault is scoped to this
    batcher, so a loop another test left running in the process cannot
    take it."""
    batcher.failpoint_scope = "selfheal-drill"

    def die() -> None:
        raise fp.FailpointError("injected-loop-death")

    fp.set_failpoint("shard.dispatch", die, count=1, scope="selfheal-drill")


def test_selfheal_watchdog_revives_dead_dispatch_loop(envs):
    """The loop killed before any pop is wedged; each package's watchdog
    revives it once, and the next requests are served with equal bodies."""
    items = items_for(firehose_docs(6, 3, wide_every=0), ["pod-privileged"], 3)
    out = {}
    for name, env, Batcher, State, sup, fp, origin, ReviewResponse, col in _sides(envs):
        batcher = Batcher(env, max_batch_size=4, batch_timeout_ms=1.0).start()
        try:
            state = State(evaluation_environment=env, batcher=batcher)
            stats = sup.SupervisorStats()
            dog = sup.SelfHealWatchdog(state, stats, interval_seconds=0.05)
            healthy = dog.check_once()
            _kill_once(fp, batcher)
            assert wait_for(lambda: not batcher._thread.is_alive(), 5), name
            wedged = batcher.dispatch_wedged()
            dog.start()
            try:
                assert wait_for(lambda: stats.stats()["batcher_revives"] == 1), name
                bodies = [
                    json.dumps(ReviewResponse(
                        batcher.submit(it[0], it[col], origin).result(timeout=10)
                    ).to_dict())
                    for it in items
                ]
            finally:
                dog.stop()
            out[name] = (
                healthy, wedged, batcher.dispatch_wedged(), stats.stats(),
                fp.fired_count("shard.dispatch"), bodies,
            )
        finally:
            batcher.shutdown()
    assert out["port"] == out["jax"]
    healthy, wedged, still, stats, fired, _bodies = out["port"]
    assert (healthy, wedged, still, fired) == (0, True, False, 1)
    assert stats["batcher_revives"] == 1 and stats["frontend_revives"] == 0


def test_selfheal_watchdog_never_revives_during_shutdown(envs):
    out = {}
    for name, env, Batcher, *_rest in _sides(envs):
        batcher = Batcher(env, max_batch_size=4, batch_timeout_ms=1.0).start()
        batcher.shutdown()
        out[name] = (batcher.dispatch_wedged(), batcher.revive_dispatch())
    assert out["port"] == out["jax"] == (False, False)


class _FakeFrontend:
    def __init__(self, dead: bool, revivable: bool = True, broken: bool = False):
        self.dead = dead
        self.revivable = revivable
        self.broken = broken
        self.revives = 0

    def drainer_wedged(self) -> bool:
        if self.broken:
            raise RuntimeError("introspection fault")
        return self.dead

    def revive_drainer(self) -> bool:
        if not self.revivable:
            return False
        self.revives += 1
        self.dead = False
        return True


class _FakeBatcher:
    def dispatch_wedged(self) -> bool:
        return False

    def queue_depth(self) -> int:
        return 0


@pytest.mark.parametrize("dead,revivable,broken", [
    (False, True, False), (True, True, False), (True, False, False),
    (False, True, True),
])
def test_drainer_check_counts_as_the_jax_watchdog(dead, revivable, broken):
    """The drainer half of ``check_once`` over the same fake frontend:
    the same revive counts and return values."""
    out = {}
    for name, sup, State in (("jax", jsup, JState), ("port", tsup, TState)):
        front = _FakeFrontend(dead, revivable, broken)
        state = State(evaluation_environment=None, batcher=_FakeBatcher())
        state.native_frontend = front
        stats = sup.SupervisorStats()
        dog = sup.SelfHealWatchdog(state, stats, interval_seconds=0)
        out[name] = (dog.check_once(), dog.check_once(), stats.stats(), front.revives)
    assert out["port"] == out["jax"]


# -- the port's servers --------------------------------------------------------


def _post(port: int, body: bytes) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=15)
    try:
        conn.request("POST", "/validate/pod-privileged", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _metric(port: int, name: str) -> float:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=15)
    try:
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
    finally:
        conn.close()
    return float(re.search(rf"^{name} (\S+)$", text, re.M).group(1))


class _DrainerDeath(BaseException):
    """Escapes every ``except Exception``: it ends the thread it is raised
    on."""


def _jax_bodies(docs: list[dict]) -> list[bytes]:
    from policy_server_tpu.models import AdmissionReviewRequest, ValidateRequest

    jenv = jax_env(SPECS)
    return [
        json.dumps(JReviewResponse(jevaluate(
            jenv, "pod-privileged",
            ValidateRequest.from_admission(AdmissionReviewRequest.from_dict(d).request),
            JOrigin.VALIDATE,
        )).to_dict()).encode()
        for d in docs
    ]


@pytest.mark.parametrize("frontend", ["python", "native"])
def test_killed_dispatch_loop_is_revived_and_counted_on_metrics(frontend):
    docs = firehose_docs(4, 21, wide_every=0)
    want = _jax_bodies(docs)
    server = PolicyServer(
        {k: tparse(k, v) for k, v in SPECS.items()}, port=0,
        readiness_probe_port=0, device="cpu", enable_metrics=True,
        frontend=frontend, selfheal_interval_seconds=0.05,
    )
    server.start()
    try:
        rp = server.readiness_port
        assert _post(server.port, json.dumps(docs[0]).encode()) == (200, want[0])
        _kill_once(tfp, server.batcher)
        assert wait_for(lambda: _metric(
            rp, "policy_server_selfheal_batcher_revives_total") == 1.0)
        got = [_post(server.port, json.dumps(d).encode()) for d in docs]
        assert got == [(200, w) for w in want]
        assert _metric(rp, "policy_server_selfheal_frontend_revives_total") == 0.0
        assert server.state.supervisor.stats()["batcher_revives"] == 1
    finally:
        server.stop()


def test_killed_native_drainer_is_revived_and_counted_on_metrics():
    """A drainer that dies answers its burst first (500), is revived by
    the watchdog and counted; the requests after it get the JAX package's
    bodies."""
    docs = firehose_docs(4, 22, wide_every=0)
    want = _jax_bodies(docs)
    server = PolicyServer(
        {k: tparse(k, v) for k, v in SPECS.items()}, port=0,
        readiness_probe_port=0, device="cpu", enable_metrics=True,
        frontend="native", selfheal_interval_seconds=0.05,
    )
    server.start()
    try:
        rp = server.readiness_port
        front = server.native_frontend

        def die():
            raise _DrainerDeath()

        tfp.set_failpoint("frontend.accept", die, count=1)
        status, body = _post(server.port, json.dumps(docs[0]).encode())
        assert (status, json.loads(body)) == (
            500, {"message": "Something went wrong", "status": 500}
        )
        assert wait_for(lambda: _metric(
            rp, "policy_server_selfheal_frontend_revives_total") == 1.0)
        assert not front.drainer_wedged()
        got = [_post(server.port, json.dumps(d).encode()) for d in docs]
        assert got == [(200, w) for w in want]
        assert _metric(rp, "policy_server_selfheal_batcher_revives_total") == 0.0
    finally:
        server.stop()
