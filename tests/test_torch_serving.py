"""The port's serving decisions on the CPU, against the JAX package:

* the host fast path: ``validate_batch(prefer_host=True)`` responses equal
  the JAX environment's (``kernel="pallas"``) for accept, reject, group
  causes and mutation, and equal the port's own device path;
* the batcher's routing: batches of at most ``host_fastpath_threshold``
  rows go host-side, none when it is 0, and the latency budget routes by
  a seeded device round-trip estimate;
* the device circuit breaker: its state sequence equals the JAX
  package's under one injected clock; at the environment level a
  ``device.fetch`` failpoint fired 5 times trips it, tripped batches
  answer as the oracle does, and a half-open probe after the cooldown
  closes it; the ``policy_timeout`` watchdog answers in-band and counts a
  breaker failure; ``degraded_mode`` answers as the JAX batcher does; a
  kernel or CUDA error fails its requests and never trips the breaker;
  every trip is logged and shown on ``/readiness``;
* cache hits come back from the batcher as fragment verdicts whose bytes
  equal the full response's.

Tolerance: exact equality."""

from __future__ import annotations

import copy
import json
import logging
import threading
import time

import pytest

from policy_server_tpu.api.service import RequestOrigin as JOrigin
from policy_server_tpu.resilience import CircuitBreaker as JaxBreaker
from policy_server_tpu.runtime.batcher import MicroBatcher as JaxBatcher
from policy_server_tpu_torch import failpoints
from policy_server_tpu_torch.api.handlers import evaluate_body, readiness
from policy_server_tpu_torch.api.service import RequestOrigin, evaluate
from policy_server_tpu_torch.evaluation.environment import (
    InflightStep,
    bucket_size,
)
from policy_server_tpu_torch.models.admission import FragVerdict
from policy_server_tpu_torch.resilience import CircuitBreaker
from policy_server_tpu_torch.runtime.batcher import (
    DEADLINE_MESSAGE,
    DEGRADED_MESSAGE,
    MicroBatcher,
)

from test_torch_verdict_cache import pair, pallas_env, pod_doc
from torch_port_support import jax_env, response_dicts, torch_env

POLICIES = {
    "priv": {"module": "builtin://pod-privileged"},
    "ns": {
        "module": "builtin://namespace-validate",
        "settings": {"denied_namespaces": ["blocked"]},
    },
    "grp": {
        "expression": "happy() || priv()",
        "message": "group denied",
        "policies": {
            "happy": {"module": "builtin://always-unhappy"},
            "priv": {"module": "builtin://pod-privileged"},
        },
    },
    "caps": {
        "module": "builtin://psp-capabilities",
        "allowedToMutate": True,
        "settings": {
            "allowed_capabilities": ["NET_BIND_SERVICE", "CHOWN"],
            "required_drop_capabilities": ["NET_ADMIN"],
            "default_add_capabilities": ["CHOWN"],
        },
    },
}


@pytest.fixture(autouse=True)
def clean_failpoints():
    failpoints.reset()
    yield
    failpoints.reset()


def corpus() -> list[tuple]:
    """(policy id, JAX request, port request): every policy over four
    documents — accepted, rejected, group causes, and patches."""
    docs = [
        pod_doc(ns, priv, f"{ns}-{priv}")
        for ns in ("default", "blocked")
        for priv in (False, True)
    ]
    return [(pid, *pair(d)) for pid in sorted(POLICIES) for d in docs]


def test_fastpath_matches_jax_and_the_device_path():
    jenv = pallas_env(POLICIES)
    tenv = torch_env(POLICIES, verdict_cache_size=0)
    triples = corpus()
    want = response_dicts(
        jenv.validate_batch([(p, j) for p, j, _t in triples], prefer_host=True)
    )
    host = response_dicts(
        tenv.validate_batch([(p, t) for p, _j, t in triples], prefer_host=True)
    )
    device = response_dicts(tenv.validate_batch([(p, t) for p, _j, t in triples]))
    assert host == want == device
    assert tenv.host_fastpath_requests == len(triples)
    assert {r["allowed"] for r in host} == {True, False}
    assert any("patch" in r for r in host)
    assert any(r.get("status", {}).get("details") for r in host)


def test_fastpath_handles_unknown_policy():
    tenv = torch_env(POLICIES)
    (res,) = tenv.validate_batch(
        [("missing", pair(pod_doc("default", False, "u"))[1])], prefer_host=True
    )
    assert type(res).__name__ == "PolicyNotFoundError"


def _batcher(env, threshold: int, **kw) -> MicroBatcher:
    kw.setdefault("policy_timeout", 5.0)
    return MicroBatcher(env, host_fastpath_threshold=threshold, **kw).start()


def test_batcher_small_batch_takes_fastpath():
    env = torch_env(POLICIES)
    b = _batcher(env, 64, max_batch_size=32)
    try:
        for pid, _j, t in corpus()[:6]:
            got = b.evaluate(pid, t).to_dict()
            assert got == evaluate(env, pid, t, RequestOrigin.VALIDATE).to_dict()
        assert b.host_fastpath_batches == b.batches >= 1
        assert env.host_fastpath_requests >= 6
        assert env.host_profile["dispatched_chunks"] == 0
    finally:
        b.shutdown()


def test_batcher_large_batch_uses_device():
    env = torch_env(POLICIES)
    b = _batcher(env, 2, max_batch_size=16, batch_timeout_ms=200.0)
    try:
        gate = threading.Barrier(9)
        futures = []
        lock = threading.Lock()
        req = pair(pod_doc("default", False, "u"))[1]

        def submit():
            gate.wait()
            f = b.submit("priv", req)
            with lock:
                futures.append(f)

        threads = [threading.Thread(target=submit) for _ in range(8)]
        for t in threads:
            t.start()
        gate.wait()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        for f in futures:
            assert f.result(timeout=10).allowed is True
        # 8 concurrent submissions in a 200 ms window form a batch > 2
        assert env.host_fastpath_requests < 8
        assert env.host_profile["dispatched_chunks"] >= 1
    finally:
        b.shutdown()


def test_batcher_fastpath_disabled():
    env = torch_env(POLICIES)
    b = _batcher(env, 0)
    try:
        for pid, _j, t in corpus()[:4]:
            assert b.evaluate(pid, t).to_dict() == evaluate(
                env, pid, t, RequestOrigin.VALIDATE
            ).to_dict()
        assert b.host_fastpath_batches == 0
        assert env.host_fastpath_requests == 0
    finally:
        b.shutdown()


@pytest.mark.parametrize("rtt,routed", [(5.0, True), (1e-6, False)])
def test_budget_routing_with_seeded_rtt(rtt, routed):
    """With the occupancy tier off, a batch goes host-side exactly when
    the device's round-trip estimate for its bucket would blow the
    latency budget and the host's would not."""
    env = torch_env(POLICIES, verdict_cache_size=0)
    triples = corpus()[:8]
    b = _batcher(
        env, 0, max_batch_size=len(triples), batch_timeout_ms=500.0,
        latency_budget_ms=50.0,
    )
    try:
        b._dev_rtt[bucket_size(len(triples))] = rtt
        futures = b.submit_many([(p, t) for p, _j, t in triples])
        got = [f.result(timeout=30).to_dict() for f in futures]
        assert got == [
            evaluate(env, p, t, RequestOrigin.VALIDATE).to_dict()
            for p, _j, t in triples
        ]
        assert b.batches == 1
        assert b.budget_routed_batches == b.host_fastpath_batches == int(routed)
    finally:
        b.shutdown()


def test_warmup_seeds_every_bucket():
    env = torch_env(POLICIES)
    b = _batcher(env, 64, max_batch_size=8)
    try:
        b.warmup()
        assert sorted(b._dev_rtt) == [1, 2, 4, 8]
        assert all(v > 0 for v in b._dev_rtt.values())
    finally:
        b.shutdown()


def _drive_breaker(cls) -> list:
    """One fixed sequence of admissions and outcomes under an injected
    clock → the (call, result, state, stats) trace."""
    clock = {"t": 0.0}
    b = cls(
        failure_threshold=3, window_seconds=5.0, cooldown_seconds=2.0,
        clock=lambda: clock["t"],
    )
    steps = [
        (0.0, "allow"), (0.0, "fail"), (0.0, "fail"), (6.0, "fail"),
        (6.0, "fail"), (6.0, "fail"), (6.5, "allow"), (8.5, "allow"),
        (8.5, "allow"), (8.6, "fail"), (9.0, "allow"), (11.0, "allow"),
        (11.0, "ok"), (11.0, "fail"), (11.0, "fail"), (11.0, "fail"),
        (11.5, "ok"), (13.5, "allow"), (13.5, "ok"), (14.0, "ok"),
    ]
    trace = []
    for t, call in steps:
        clock["t"] = t
        if call == "allow":
            result = b.allow_device()
        elif call == "fail":
            result = b.record_failure()
        else:
            result = b.record_success()
        trace.append(
            (t, call, result, b.state, b.blocking_device, b.short_circuits,
             b.stats())
        )
    return trace


def test_breaker_state_sequence_matches_jax():
    got = _drive_breaker(CircuitBreaker)
    assert got == _drive_breaker(JaxBreaker)
    states = [row[3] for row in got]
    assert {"closed", "open", "half_open"} <= set(states)
    assert got[-1][-1]["trips"] == 3 and got[-1][-1]["recoveries"] == 2


def test_device_fetch_faults_trip_the_breaker_and_a_probe_recovers():
    """Five injected fetch faults (the default threshold) trip the
    environment's breaker; tripped batches answer host-side exactly as
    the oracle does, without touching the device path; after the cooldown
    a half-open probe dispatches again and closes it."""
    env = torch_env(
        POLICIES, verdict_cache_size=0, breaker_config={"cooldown_seconds": 0.3}
    )
    oracle = torch_env(POLICIES, backend="oracle")
    items = [(p, t) for p, _j, t in corpus()]
    failpoints.configure("device.fetch=raise:injected-fetch-fault*5")
    for k in range(5):
        assert env.breaker_stats["trips"] == 0
        with pytest.raises(failpoints.FailpointError):
            env.validate_batch(items[k : k + 1])
    stats = env.breaker_stats
    assert stats["trips"] == 1 and stats["open_shards"] == 1
    assert failpoints.fired_count("device.fetch") == 5

    chunks = env.host_profile["dispatched_chunks"]
    tripped = response_dicts(env.validate_batch(items))
    assert tripped == response_dicts(oracle.validate_batch(items))
    assert env.breaker_stats["short_circuited_requests"] == len(items)
    assert env.host_profile["dispatched_chunks"] == chunks
    assert env.breaker_all_open

    time.sleep(0.35)
    assert not env.breaker_all_open  # a probe is due
    out = response_dicts(env.validate_batch(items[:3]))
    assert out == response_dicts(oracle.validate_batch(items[:3]))
    stats = env.breaker_stats
    assert stats["recoveries"] == 1 and stats["open_shards"] == 0
    assert stats["probes"] == 1
    assert env.host_profile["dispatched_chunks"] > chunks


def test_watchdog_answers_in_band_and_counts_a_breaker_failure():
    """A fetch that sleeps past ``policy_timeout`` resolves its requests
    in-band with the deadline message; the abandonment is the breaker's
    hang signal (threshold 1: one trip). The breaker then serves the next
    request from the host oracle, correctly."""
    env = torch_env(
        POLICIES, verdict_cache_size=0,
        breaker_config={"failure_threshold": 1, "cooldown_seconds": 60.0},
    )
    release = threading.Event()
    failpoints.set_failpoint(
        "device.fetch", lambda: release.wait(timeout=10), count=1
    )
    b = _batcher(env, 0, policy_timeout=0.4, latency_budget_ms=0)
    try:
        (pid, _j, t), (pid2, _j2, t2) = corpus()[8:10]
        t0 = time.perf_counter()
        resp = b.evaluate(pid, t)
        assert time.perf_counter() - t0 < 2.0
        assert resp.allowed is False and resp.status.code == 500
        assert DEADLINE_MESSAGE in resp.status.message
        assert b.deadline_abandoned_batches == 1
        assert b.deadline_rejections == 1
        assert 0.4 <= b.max_answer_seconds < 2.0
        assert env.breaker_stats["trips"] == 1
        got = b.evaluate(pid2, t2).to_dict()
        assert got == evaluate(
            torch_env(POLICIES, backend="oracle"), pid2, t2, RequestOrigin.VALIDATE
        ).to_dict()
        assert env.breaker_stats["short_circuited_requests"] == 1
    finally:
        release.set()
        b.shutdown()


CUDA_FAULT = (
    "policy_matrix launch failed: CUDA error 700: an illegal memory access "
    "was encountered"
)


@pytest.mark.parametrize("where", ["dispatch", "fetch"])
def test_cuda_errors_fail_requests_and_never_trip_the_breaker(
    where, monkeypatch, caplog
):
    """A kernel or CUDA error at dispatch or fetch (a sticky one would
    poison the context for good) fails its batch's requests, is logged
    and counted, and is kept from the breaker: past the threshold the
    device path is still the one asked, and no host answer replaces it."""
    env = torch_env(POLICIES, verdict_cache_size=0)
    # every bucket armed, as after a server's boot: K1 serves each batch
    env.warmup((1,))
    oracle = torch_env(POLICIES, backend="oracle")
    items = [(p, t) for p, _j, t in corpus()]
    def fault(*_args):
        raise RuntimeError(CUDA_FAULT)

    if where == "dispatch":
        monkeypatch.setattr(env, "enqueue_packed", fault)
    else:
        monkeypatch.setattr(InflightStep, "wait", fault)
    b = _batcher(env, 0, latency_budget_ms=0)
    try:
        with caplog.at_level(logging.ERROR, logger="kubewarden-policy-server"):
            for k in range(8):
                pid, t = items[k]
                with pytest.raises(Exception, match="CUDA error 700"):
                    b.evaluate(pid, t)
        assert env.device_errors == 8
        assert env.breaker_stats["trips"] == 0
        assert env.breaker_stats["short_circuited_requests"] == 0
        assert sum("device error" in r.getMessage() for r in caplog.records) == 8
        status, text = readiness(b)
        assert status == 200 and "device errors 8" in text
        # the fault cleared: the device path answers, as the oracle does
        monkeypatch.undo()
        got = response_dicts([b.evaluate(pid, t) for pid, t in items[:4]])
        assert got == response_dicts(oracle.validate_batch(items[:4]))
        assert env.breaker_stats["trips"] == 0
    finally:
        b.shutdown()


@pytest.mark.parametrize("mode", ["oracle", "reject"])
def test_breaker_trip_is_logged_and_shown_on_readiness(mode, caplog):
    """A trip is logged at ERROR and its counters are on /readiness (503
    under --degraded-mode reject while open); the recovery is logged."""
    env = torch_env(
        POLICIES, verdict_cache_size=0, breaker_config={"cooldown_seconds": 0.3}
    )
    b = _batcher(env, 0, latency_budget_ms=0, degraded_mode=mode)
    items = [(p, t) for p, _j, t in corpus()]
    try:
        assert readiness(b) == (200, "ok")
        failpoints.configure("device.fetch=raise:injected-fetch-fault*5")
        with caplog.at_level(logging.WARNING, logger="kubewarden-policy-server"):
            for k in range(5):
                with pytest.raises(failpoints.FailpointError):
                    env.validate_batch(items[k : k + 1])
            trips = [r for r in caplog.records if "breaker tripped" in r.getMessage()]
            assert len(trips) == 1 and trips[0].levelno == logging.ERROR
            status, text = readiness(b)
            if mode == "reject":
                assert status == 503
            else:
                assert status == 200
                assert "device breaker open: trips 1, recoveries 0" in text
            time.sleep(0.35)
            env.validate_batch(items[:2])
            assert any(
                "breaker closed" in r.getMessage() for r in caplog.records
            )
        status, text = readiness(b)
        assert status == 200
        assert "device breaker closed: trips 1, recoveries 1" in text
    finally:
        b.shutdown()


@pytest.mark.parametrize("mode", ["reject", "monitor"])
def test_degraded_mode_matches_jax(mode):
    breaker = {"failure_threshold": 1, "cooldown_seconds": 60.0}
    jenv = jax_env(POLICIES, verdict_cache_size=0, breaker_config=breaker)
    tenv = torch_env(POLICIES, verdict_cache_size=0, breaker_config=breaker)
    jenv.breaker.record_failure()
    tenv.breaker.record_failure()
    assert tenv.breaker_all_open and jenv.breaker_all_open
    kw = dict(
        max_batch_size=4, batch_timeout_ms=1.0, policy_timeout=2.0,
        host_fastpath_threshold=0, latency_budget_ms=0, degraded_mode=mode,
    )
    jb = JaxBatcher(jenv, **kw).start()
    tb = MicroBatcher(tenv, **kw).start()
    try:
        for pid, j, t in corpus()[::5]:
            want = jb.submit(pid, j, JOrigin.VALIDATE).result(timeout=10)
            got = tb.submit(pid, t).result(timeout=10)
            assert got.to_dict() == want.to_dict()
            if mode == "reject":
                assert got.status.code == 503
                assert DEGRADED_MESSAGE in got.status.message
            else:
                assert got.allowed is True and got.status is None
        assert tb.degraded_responses == jb.degraded_responses > 0
    finally:
        jb.shutdown()
        tb.shutdown()


def test_cache_hits_come_back_as_fragments_with_equal_bytes():
    env = torch_env(POLICIES)
    b = _batcher(env, 0, max_batch_size=64, batch_timeout_ms=20.0)
    try:
        docs = [pod_doc("default", priv, f"f-{priv}") for priv in (False, True)]
        work = [("priv", d) for d in docs] + [("grp", d) for d in docs]
        first = [
            evaluate_body(b, "validate", pid, json.dumps(d).encode())
            for pid, d in work
        ]
        replay = [
            evaluate_body(b, "validate", pid, json.dumps(d).encode())
            for pid, d in work
        ]
        assert replay == first
        assert env.dedup_stats["fragment_hits"] == len(work)
        pid, doc = work[1]
        fut = b.submit(pid, pair(copy.deepcopy(doc))[1])
        frag = fut.result(timeout=10)
        assert type(frag) is FragVerdict
        assert json.dumps(frag.to_dict()) == json.dumps(
            frag.tmpl.to_response(frag.uid).to_dict()
        )
        assert first[1][1] == json.dumps({
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "response": frag.to_dict(),
        }).encode()
    finally:
        b.shutdown()
