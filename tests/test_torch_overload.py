"""The port's batcher under overload and at shutdown, held against the JAX
package's (``policy_server_tpu/runtime/batcher.py``) on the same requests:
the bounded queue, the 50 ms-sliced wait up to the policy timeout and its
in-band 429 "policy server overloaded", the overload pool behind
``submit_nowait`` and a ``submit_many`` burst's overflow, and the in-band
503 "policy server shutting down" for a queued backlog, for overload
waiters and for every submission after ``shutdown()``. Every response is
compared exactly (tolerance 0: these are bytes), as the dict the batcher
resolves, as the standard-library frontend's body and as the native
frontend's rendered body. Batchers are built without ``start()`` so the
queue fills deterministically; each test waits at most a few policy
timeouts of 0.2 s.

Also held: the server's queue bound (``--workers`` × ``--max-batch-size``)
and a server stopped with requests in flight, through both frontends,
answering each with a verdict or the in-band 503, never a 500.

Deadlines and load shedding (``--request-timeout-ms``, the cases of the
JAX package's ``tests/test_resilience.py`` and ``test_native_frontend.py``):
the shed at admission (``ShedError``, 429), the expired rows' 504 before
encode, the overload wait that ends at the deadline, a shed burst's
Retry-After from the measured round trip, the round trip seeded from the
second warmup run under a request timeout alone, the 429/503 answers with
Retry-After through both frontends, and the 10 s default; the JAX side runs
on its host oracle here."""

from __future__ import annotations

import http.client
import json
import re
import struct
import threading
import time

import pytest

from policy_server_tpu.api import service as jax_service
from policy_server_tpu.models import (
    AdmissionReviewResponse as JAdmissionReviewResponse,
)
from policy_server_tpu.runtime import native_frontend as jnf
from policy_server_tpu.runtime.batcher import MicroBatcher as JaxBatcher
from policy_server_tpu_torch import failpoints
from policy_server_tpu_torch.api import service as t_service
from policy_server_tpu_torch.api.handlers import evaluate_body
from policy_server_tpu_torch.api.state import ApiServerState
from policy_server_tpu_torch.models import AdmissionReviewRequest as TReview
from policy_server_tpu_torch.models import ValidateRequest as TValidateRequest
from policy_server_tpu_torch.models.policy import (
    parse_policy_entry as t_parse_policy_entry,
)
from policy_server_tpu_torch.runtime import native_frontend as nf
from policy_server_tpu_torch.runtime.batcher import MicroBatcher
from policy_server_tpu_torch.server import PolicyServer, default_workers

from torch_port_support import firehose_docs, items_for, jax_env, torch_env

SPECS = {
    "pod-privileged": {"module": "builtin://pod-privileged"},
    "ns": {
        "module": "builtin://namespace-validate",
        "settings": {"denied_namespaces": ["kube-system"]},
    },
}
POLICY_TIMEOUT = 0.2
OVERLOADED = "policy server overloaded"
STOPPING = "policy server shutting down"


@pytest.fixture(scope="module")
def envs():
    return jax_env(SPECS, verdict_cache_size=0), torch_env(SPECS, verdict_cache_size=0)


@pytest.fixture(autouse=True)
def clean_failpoints():
    failpoints.reset()
    yield
    failpoints.reset()


def _docs(n: int, seed: int) -> list[dict]:
    return firehose_docs(n, seed, wide_every=0)


def _items(n: int, seed: int):
    return items_for(_docs(n, seed), sorted(SPECS), seed)


class Side:
    """One package's batcher factory, origin and request of each item."""

    def __init__(self, name: str, env, make, origin, col: int):
        self.name = name
        self.env = env
        self.make = make
        self.origin = origin
        self.col = col

    def batcher(self, **kw):
        kw.setdefault("max_batch_size", 1)
        kw.setdefault("policy_timeout", POLICY_TIMEOUT)
        return self.make(self.env, **kw)

    def pairs(self, items):
        return [(it[0], it[self.col]) for it in items]


def sides(envs) -> list[Side]:
    jenv, tenv = envs
    return [
        Side("jax", jenv, JaxBatcher, jax_service.RequestOrigin.VALIDATE, 1),
        Side("port", tenv, MicroBatcher, t_service.RequestOrigin.VALIDATE, 2),
    ]


def _dict(result) -> dict:
    if hasattr(result, "to_response"):
        result = result.to_response()
    return result.to_dict()


def _codes(dicts: list[dict]) -> list:
    return [(d.get("status") or {}).get("code") for d in dicts]


class _RecordingSink:
    def __init__(self, expected: int):
        self.items: list = []
        self.lock = threading.Lock()
        self.done = threading.Event()
        self.expected = expected

    def deliver_many(self, items):
        with self.lock:
            self.items.extend(items)
            if len(self.items) >= self.expected:
                self.done.set()


class _CaptureFrontend:
    """What the port's BatcherSink hands the native frontend, rendered the
    way the C++ side writes it."""

    def __init__(self, expected: int):
        self.bodies: dict[int, tuple[int, bytes]] = {}
        self.lock = threading.Lock()
        self.done = threading.Event()
        self.expected = expected

    def _put(self, req_id: int, status: int, body: bytes) -> None:
        with self.lock:
            self.bodies[req_id] = (status, body)
            if len(self.bodies) >= self.expected:
                self.done.set()

    def complete_verdict_bulk(self, records: list[bytes]) -> None:
        for r in records:
            self._put(struct.unpack_from("<Q", r)[0], 200, nf.render_verdict_bytes(r))

    def complete(self, req_id, status, body, retry_after=0) -> None:
        self._put(req_id, status, body)


def _jax_native_body(req_id: int, response) -> tuple[int, bytes]:
    return 200, jnf.render_verdict_bytes(
        jnf.pack_verdict_record(req_id, response, False)
    )


def _jax_stdlib_body(response) -> bytes:
    return json.dumps(JAdmissionReviewResponse(response).to_dict()).encode()


# -- submit ------------------------------------------------------------------


def test_submit_waits_for_room_then_answers_429(envs):
    """A full queue: the second submit waits the policy timeout and is
    answered 429 in-band; shutdown answers the queued first one 503."""
    items = _items(2, 11)
    out = {}
    for side in sides(envs):
        b = side.batcher(queue_capacity=1)
        (p0, r0), (p1, r1) = side.pairs(items)
        f0 = b.submit(p0, r0, side.origin)
        t0 = time.perf_counter()
        f1 = b.submit(p1, r1, side.origin)
        waited = time.perf_counter() - t0
        got1 = _dict(f1.result(timeout=5))
        b.shutdown()
        got0 = _dict(f0.result(timeout=5))
        assert POLICY_TIMEOUT * 0.9 <= waited < POLICY_TIMEOUT + 1.0, side.name
        out[side.name] = (got1, got0)
    assert out["port"] == out["jax"]
    got1, got0 = out["port"]
    assert (got1["status"]["code"], got1["status"]["message"]) == (429, OVERLOADED)
    assert (got0["status"]["code"], got0["status"]["message"]) == (503, STOPPING)
    assert got1["allowed"] is False and got1["uid"] == items[1][2].uid()


def test_submit_nowait_parks_the_wait_on_the_overload_pool(envs):
    """submit_nowait never blocks: a full queue's row waits on the overload
    pool and comes back 429."""
    items = _items(2, 12)
    out = {}
    for side in sides(envs):
        b = side.batcher(queue_capacity=1)
        (p0, r0), (p1, r1) = side.pairs(items)
        b.submit_nowait(p0, r0, side.origin)
        t0 = time.perf_counter()
        f1 = b.submit_nowait(p1, r1, side.origin)
        assert time.perf_counter() - t0 < 0.1, side.name
        out[side.name] = _dict(f1.result(timeout=5))
        b.shutdown()
    assert out["port"] == out["jax"]
    assert out["port"]["status"]["code"] == 429


@pytest.mark.parametrize("mode", ["futures", "sink"])
def test_submit_many_overflow_answers_429_and_backlog_503(envs, mode):
    """A burst larger than the queue: the rows that fit are queued (503 at
    shutdown), the overflow waits on the overload pool (429); the call
    itself returns at once, with futures and with a sink."""
    items = _items(5, 13)
    out = {}
    for side in sides(envs):
        b = side.batcher(queue_capacity=2)
        pairs = side.pairs(items)
        t0 = time.perf_counter()
        if mode == "futures":
            futures = b.submit_many(pairs, side.origin)
            assert time.perf_counter() - t0 < 0.1, side.name
            time.sleep(POLICY_TIMEOUT + 0.3)
            b.shutdown()
            got = [_dict(f.result(timeout=5)) for f in futures]
        else:
            sink = _RecordingSink(len(pairs))
            assert b.submit_many(
                pairs, side.origin, sink=sink, tokens=list(range(len(pairs)))
            ) is None
            assert time.perf_counter() - t0 < 0.1, side.name
            time.sleep(POLICY_TIMEOUT + 0.3)
            b.shutdown()
            assert sink.done.wait(5)
            by_token = {tok: (r, e) for tok, r, e in sink.items}
            assert sorted(by_token) == list(range(len(pairs)))
            assert all(e is None for _r, e in by_token.values())
            got = [_dict(by_token[i][0]) for i in range(len(pairs))]
        out[side.name] = got
    assert out["port"] == out["jax"]
    assert _codes(out["port"]) == [503, 503, 429, 429, 429]


# -- shutdown ----------------------------------------------------------------


def test_shutdown_answers_the_backlog_and_every_later_submit_503(envs):
    """Rows queued at shutdown, and submit, submit_nowait and submit_many
    (futures and sink) after it: every answer is the in-band 503."""
    items = _items(8, 14)
    out = {}
    for side in sides(envs):
        b = side.batcher(max_batch_size=4, queue_capacity=16)
        pairs = side.pairs(items)
        backlog = [b.submit(p, r, side.origin) for p, r in pairs[:4]]
        b.shutdown()
        got = [_dict(f.result(timeout=5)) for f in backlog]
        p, r = pairs[4]
        got.append(_dict(b.submit(p, r, side.origin).result(timeout=5)))
        p, r = pairs[5]
        got.append(_dict(b.submit_nowait(p, r, side.origin).result(timeout=5)))
        got += [_dict(f.result(timeout=5)) for f in b.submit_many(pairs[6:7], side.origin)]
        sink = _RecordingSink(1)
        b.submit_many(pairs[7:], side.origin, sink=sink, tokens=[0])
        assert sink.done.wait(5)
        got.append(_dict(sink.items[0][1]))
        out[side.name] = got
    assert out["port"] == out["jax"]
    assert _codes(out["port"]) == [503] * 8
    assert {d["status"]["message"] for d in out["port"]} == {STOPPING}


def test_shutdown_wakes_overload_waiters_into_503(envs):
    """Rows waiting for room when shutdown starts answer 503 within a wait
    slice, not 429 at their timeout."""
    items = _items(3, 15)
    out = {}
    for side in sides(envs):
        b = side.batcher(queue_capacity=1, policy_timeout=5.0)
        pairs = side.pairs(items)
        futures = b.submit_many(pairs, side.origin)
        time.sleep(0.1)
        t0 = time.perf_counter()
        b.shutdown()
        got = [_dict(f.result(timeout=5)) for f in futures]
        assert time.perf_counter() - t0 < 2.0, side.name
        out[side.name] = got
    assert out["port"] == out["jax"]
    assert _codes(out["port"]) == [503, 503, 503]


def test_without_a_policy_timeout_a_waiter_waits_for_room(envs):
    """--disable-timeout-protection: a full queue waits for as long as it
    takes, and the row is served once the loop starts."""
    items = _items(2, 16)
    out = {}
    for side in sides(envs):
        b = side.batcher(queue_capacity=1, policy_timeout=None)
        pairs = side.pairs(items)
        futures = [b.submit_nowait(p, r, side.origin) for p, r in pairs]
        time.sleep(0.3)
        assert not futures[1].done(), side.name
        b.start()
        got = [_dict(f.result(timeout=10)) for f in futures]
        b.shutdown()
        out[side.name] = got
    assert out["port"] == out["jax"]
    assert not {429, 503} & set(_codes(out["port"]))


# -- the frontends' bodies ----------------------------------------------------


def test_overload_and_shutdown_bodies_through_both_frontends(envs):
    """The standard-library frontend's body (``evaluate_body``) and the
    native frontend's rendered body (``BatcherSink`` through a capturing
    frontend) for a 429 and a 503, byte-equal to the JAX package's
    renderings of its batcher's answers."""
    jside, tside = sides(envs)
    items = _items(3, 17)
    docs = _docs(3, 17)

    # the JAX package's answers and their two renderings
    jb = jside.batcher(queue_capacity=1)
    (jp0, jr0), (jp1, jr1), (jp2, jr2) = jside.pairs(items)
    jb.submit(jp0, jr0, jside.origin)
    j429 = jb.submit(jp1, jr1, jside.origin).result(timeout=5)
    jb.shutdown()
    j503 = jb.submit(jp2, jr2, jside.origin).result(timeout=5)
    want = [
        (200, _jax_stdlib_body(j429)), (200, _jax_stdlib_body(j503)),
        _jax_native_body(1, j429), _jax_native_body(2, j503),
    ]

    # the port's standard-library frontend
    tb = tside.batcher(queue_capacity=1)
    (tp0, tr0), _, _ = tside.pairs(items)
    tb.submit(tp0, tr0, tside.origin)
    got = [evaluate_body(tb, "validate", items[1][0], json.dumps(docs[1]).encode())[:2]]
    tb.shutdown()
    got.append(evaluate_body(tb, "validate", items[2][0], json.dumps(docs[2]).encode())[:2])

    # the port's native frontend: its sink's deliveries, rendered
    tb = tside.batcher(queue_capacity=1)
    sink = nf.BatcherSink(ApiServerState(tside.env, tb))
    front = _CaptureFrontend(expected=2)
    tb.submit(tp0, tr0, tside.origin)
    (tp1, tr1), (tp2, tr2) = tside.pairs(items)[1:]
    tb.submit_many([(tp1, tr1)], tside.origin, sink=sink, tokens=[(front, 1, False)])
    time.sleep(POLICY_TIMEOUT + 0.3)
    tb.shutdown()
    tb.submit_many([(tp2, tr2)], tside.origin, sink=sink, tokens=[(front, 2, False)])
    assert front.done.wait(5)
    got += [front.bodies[1], front.bodies[2]]
    assert got == want
    assert b'"code": 429' in got[0][1] and b'"code": 503' in got[1][1]


# -- the server ----------------------------------------------------------------


def _policies() -> dict:
    return {k: t_parse_policy_entry(k, v) for k, v in SPECS.items()}


def test_server_queue_is_bounded_by_workers_times_max_batch_size(envs):
    """--workers x --max-batch-size, as the JAX server passes it; a
    batcher built alone holds eight batches, as the JAX package's."""
    server = PolicyServer(
        _policies(), port=0, readiness_probe_port=0, device="cpu",
        max_batch_size=4, workers=3, policy_reload_mode="off",
        selfheal_interval_seconds=0,
    )
    server.start()
    try:
        assert server.batcher._queue.maxsize == 12
    finally:
        server.stop()
    server = PolicyServer(
        _policies(), port=0, readiness_probe_port=0, device="cpu",
        max_batch_size=4, policy_reload_mode="off", selfheal_interval_seconds=0,
    )
    server.start()
    try:
        assert server.batcher._queue.maxsize == default_workers() * 4
    finally:
        server.stop()
    jside, tside = sides(envs)
    for kw in ({"max_batch_size": 16}, {"max_batch_size": 5, "queue_capacity": 7}):
        jb, tb = jside.batcher(**kw), tside.batcher(**kw)
        assert tb._queue.maxsize == jb._queue.maxsize
        jb.shutdown()
        tb.shutdown()


def _post(port: int, body: bytes, out: list, i: int) -> None:
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/validate/pod-privileged", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        out[i] = (resp.status, resp.read())
        conn.close()
    except Exception as e:  # noqa: BLE001 — recorded and asserted on
        out[i] = ("error", repr(e))


@pytest.mark.parametrize("frontend", ["python", "native"])
def test_stop_with_requests_in_flight_answers_verdicts_or_503(frontend):
    """Requests in flight and queued when the server stops: the batches
    already formed deliver their verdicts, the rows still queued answer the
    in-band 503, and none is answered 500."""
    server = PolicyServer(
        _policies(), port=0, readiness_probe_port=0, device="cpu",
        max_batch_size=2, batch_timeout_ms=0.0, host_fastpath_threshold=0,
        latency_budget_ms=0, verdict_cache_size=0, frontend=frontend,
        selfheal_interval_seconds=0,
    )
    server.start()
    docs = _docs(24, 18)
    want = [
        t_service.evaluate(
            server.env, "pod-privileged",
            TValidateRequest.from_admission(TReview.from_dict(d).request),
            t_service.RequestOrigin.VALIDATE,
        ).to_dict()
        for d in docs
    ]
    release = threading.Event()
    failpoints.set_failpoint("device.fetch", lambda: release.wait(0.4))
    # count the rows the batcher took in (stop only once every request has
    # reached it: a connection still in the listen backlog is reset)
    b = server.batcher
    admitted = []
    submit, submit_many = b.submit, b.submit_many

    def counting_submit(*a, **k):
        admitted.append(1)
        return submit(*a, **k)

    def counting_submit_many(items, *a, **k):
        admitted.extend([1] * len(items))
        return submit_many(items, *a, **k)

    b.submit, b.submit_many = counting_submit, counting_submit_many
    out: list = [None] * len(docs)
    threads = [
        threading.Thread(target=_post, args=(server.port, json.dumps(d).encode(), out, i))
        for i, d in enumerate(docs)
    ]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and len(admitted) < len(docs):
        time.sleep(0.01)
    assert len(admitted) == len(docs)
    server.stop()
    for t in threads:
        t.join(30)
    codes = []
    for (status, body), w in zip(out, want):
        assert status == 200, (status, body)
        response = json.loads(body)["response"]
        code = (response.get("status") or {}).get("code")
        codes.append(code)
        if code == 503:
            assert response["status"]["message"] == STOPPING
        else:
            assert response == w
    assert 503 in codes and 500 not in codes


def test_concurrent_submitters_racing_shutdown_all_answered_once(envs):
    """More submitting threads than cores, a queue of four rows and a
    short switch interval, with shutdown() landing mid-stream: every row
    of submit, submit_nowait and submit_many (futures and a sink) is
    answered exactly once, with a verdict, the 429 or the 503 — the
    stranding windows after each put hold."""
    import sys

    _jside, tside = sides(envs)
    pairs = tside.pairs(_items(24, 19))
    b = tside.batcher(max_batch_size=2, queue_capacity=4, policy_timeout=0.5).start()
    futures: list = []
    sink = _RecordingSink(expected=10**9)
    tokens = iter(range(10**6))
    lock = threading.Lock()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def submitter(k: int) -> None:
        for i in range(12):
            p, r = pairs[(k + i) % len(pairs)]
            mode = (k + i) % 4
            if mode == 0:
                got = [b.submit(p, r, tside.origin)]
            elif mode == 1:
                got = [b.submit_nowait(p, r, tside.origin)]
            elif mode == 2:
                got = b.submit_many([(p, r), (p, r)], tside.origin)
            else:
                with lock:
                    toks = [next(tokens), next(tokens)]
                b.submit_many([(p, r), (p, r)], tside.origin, sink=sink, tokens=toks)
                got = []
            with lock:
                futures.extend(got)

    try:
        threads = [threading.Thread(target=submitter, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        time.sleep(0.05)
        b.shutdown()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    codes = [_codes([_dict(f.result(timeout=10))])[0] for f in futures]
    with lock:
        issued = next(tokens)
    deadline = time.monotonic() + 10
    while len(sink.items) < issued and time.monotonic() < deadline:
        time.sleep(0.01)
    delivered = sorted(tok for tok, _r, _e in sink.items)
    assert delivered == list(range(issued))  # each sink row exactly once
    assert all(e is None for _t, _r, e in sink.items)
    codes += _codes([_dict(r) for _t, r, _e in sink.items])
    verdicts = set(_codes([
        t_service.evaluate(tside.env, p, r, tside.origin).to_dict() for p, r in pairs
    ]))
    assert set(codes) <= verdicts | {429, 503} and 503 in codes


# -- deadlines and load shedding (--request-timeout-ms) -------------------------


@pytest.fixture(scope="module")
def shed_envs():
    """(the JAX package's host-oracle environment, the port's on the CPU)."""
    return (
        jax_env(SPECS, backend="oracle"),
        torch_env(SPECS, verdict_cache_size=0),
    )


def _shed(exc) -> tuple:
    return (type(exc).__name__, exc.http_status, exc.message)


def test_admission_sheds_when_estimated_wait_exceeds_budget(shed_envs):
    """A measured slow device and a queue: a row whose deadline cannot be
    met raises ShedError at admission, counted, and the admitted row stays
    queued (503 at shutdown)."""
    items = _items(2, 20)
    out = {}
    for side in sides(shed_envs):
        b = side.batcher(max_batch_size=4, policy_timeout=5.0,
                         request_timeout_ms=50.0)
        (p0, r0), (p1, r1) = side.pairs(items)
        b._dev_rtt[4] = 1.0  # 1 s per full batch
        fut = b.submit(p0, r0, side.origin)
        with pytest.raises(Exception) as e:
            b.submit(p1, r1, side.origin)
        shed = (_shed(e.value), e.value.retry_after_seconds > 0.05,
                b.stats_snapshot()["shed_requests"], fut.done())
        b.shutdown()
        out[side.name] = (shed, _dict(fut.result(timeout=1)))
    assert out["port"] == out["jax"]
    (name, status, message), _retry, shed_count, done = out["port"][0]
    assert (name, status, shed_count, done) == ("ShedError", 429, 1, False)
    assert out["port"][1]["status"]["code"] == 503


def test_expired_rows_dropped_pre_encode_no_dead_work(shed_envs):
    """Rows whose deadline passed in the queue answer 504 "request
    deadline exceeded before evaluation", counted, and are never encoded;
    a fresh row on the same batcher is served."""
    items = _items(6, 21)
    out = {}
    for side in sides(shed_envs):
        b = side.batcher(max_batch_size=8, policy_timeout=5.0,
                         request_timeout_ms=100.0, host_fastpath_threshold=0,
                         latency_budget_ms=0)
        pairs = side.pairs(items)
        futs = [b.submit(p, r, side.origin) for p, r in pairs[:5]]
        time.sleep(0.25)
        rows0 = side.env.host_profile["encode_rows"] if side.name == "port" else 0
        b.start()
        got = [_dict(f.result(timeout=5)) for f in futs]
        expired = b.stats_snapshot()["expired_dropped"]
        if side.name == "port":
            assert side.env.host_profile["encode_rows"] == rows0
        p, r = pairs[5]
        fresh = _dict(b.submit(p, r, side.origin).result(timeout=10))
        if side.name == "port":
            assert side.env.host_profile["encode_rows"] > rows0
        b.shutdown()
        out[side.name] = (got, expired, fresh)
    assert out["port"] == out["jax"]
    got, expired, fresh = out["port"]
    assert _codes(got) == [504] * 5 and expired == 5
    assert {d["status"]["message"] for d in got} == {
        "request deadline exceeded before evaluation"
    }
    assert (fresh.get("status") or {}).get("code") != 504


def test_request_timeout_disabled_keeps_legacy_behavior(shed_envs):
    items = _items(1, 22)
    out = {}
    for side in sides(shed_envs):
        b = side.batcher(max_batch_size=4, policy_timeout=5.0)
        b._dev_rtt[4] = 100.0
        b.start()
        (p, r), = side.pairs(items)
        got = _dict(b.submit(p, r, side.origin).result(timeout=10))
        stats = b.stats_snapshot()
        b.shutdown()
        out[side.name] = (got, stats["shed_requests"], stats["expired_dropped"])
    assert out["port"] == out["jax"]
    assert out["port"][1:] == (0, 0)


def test_overload_wait_past_the_deadline_is_an_expired_504(shed_envs):
    """A full queue: a row whose request deadline ends before its policy
    timeout answers the expired 504, not the overload 429."""
    items = _items(2, 23)
    out = {}
    for side in sides(shed_envs):
        b = side.batcher(queue_capacity=1, policy_timeout=5.0,
                         request_timeout_ms=150.0)
        (p0, r0), (p1, r1) = side.pairs(items)
        b.submit(p0, r0, side.origin)
        t0 = time.perf_counter()
        got = _dict(b.submit_nowait(p1, r1, side.origin).result(timeout=5))
        assert 0.1 < time.perf_counter() - t0 < 2.0, side.name
        out[side.name] = (got, b.stats_snapshot()["expired_dropped"])
        b.shutdown()
    assert out["port"] == out["jax"]
    assert out["port"][0]["status"]["code"] == 504 and out["port"][1] == 1


def test_submit_many_shed_retry_after_derives_from_ewma(shed_envs):
    """A shed burst answers every row ShedError stamped with the estimate
    the check used: four times the device round trip, four times the
    retry."""
    items = _items(4, 24)
    out = {}
    for side in sides(shed_envs):
        b = side.batcher(max_batch_size=4, policy_timeout=5.0,
                         request_timeout_ms=50.0)
        pairs = side.pairs(items)
        b.submit(*pairs[0], side.origin)
        retries = []
        for rtt in (2.0, 8.0):
            b._dev_rtt[4] = rtt
            est = b.estimated_wait()
            errs = []
            for f in b.submit_many(pairs[1:], side.origin):
                with pytest.raises(Exception) as e:
                    f.result(timeout=1)
                errs.append((_shed(e.value), e.value.retry_after_seconds))
            assert {r for _s, r in errs} == {est}, side.name
            retries.append(errs)
        # and through a sink, one delivery per row
        sink = _RecordingSink(3)
        b.submit_many(pairs[1:], side.origin, sink=sink, tokens=[0, 1, 2])
        assert sink.done.wait(5)
        sunk = sorted((t, _shed(e), e.retry_after_seconds) for t, _r, e in sink.items)
        out[side.name] = (retries, sunk, b.stats_snapshot()["shed_requests"])
        b.shutdown()
    assert out["port"] == out["jax"]
    retries, sunk, shed = out["port"]
    assert retries[1][0][1] == pytest.approx(4 * retries[0][0][1])
    assert shed == 9 and len(sunk) == 3


def test_shed_error_maps_to_http_429_with_retry_after():
    """429 (and FencedError's 503), Retry-After ceil(retry) and the body
    {"message", "retry_after_seconds"}: the JAX package's aiohttp handler's
    answer, the port's standard-library frontend's and its native sink's."""
    import asyncio

    from policy_server_tpu.api import handlers as jhandlers
    from policy_server_tpu.runtime import batcher as jbatcher
    from policy_server_tpu_torch.runtime import batcher as tbatcher

    doc = _docs(1, 25)[0]
    for jerr, terr in (
        (jbatcher.ShedError(2.3), tbatcher.ShedError(2.3)),
        (jbatcher.FencedError(0.5), tbatcher.FencedError(0.5)),
    ):
        class JaxRaising:
            async def submit_async(self, *args):
                raise jerr

        class PortRaising:
            def submit(self, *args):
                raise terr

            def submit_many(self, items, origin, sink=None, tokens=None):
                sink.deliver_many([(tokens[0], None, terr)])

        resp = asyncio.run(jhandlers._evaluate(
            JaxRaising(), "ns", None, jax_service.RequestOrigin.VALIDATE
        ))
        want = (resp.status, resp.body, resp.headers["Retry-After"])
        status, body, headers = evaluate_body(
            PortRaising(), "validate", "ns", json.dumps(doc).encode()
        )
        assert (status, body, headers["Retry-After"]) == want
        sink = nf.BatcherSink(ApiServerState(None, PortRaising()))
        front = _CaptureFrontendWithRetry()
        sink.deliver_many([((front, 3, False), None, terr)])
        assert front.answers[3] == (want[0], want[1], int(want[2]))
        jfront = _CaptureFrontendWithRetry()
        jnf.BatcherSink(None).deliver_many([((jfront, 3, False), None, jerr)])
        assert jfront.answers[3] == front.answers[3]
    assert want[0] == 503 and want[2] == "1"


class _CaptureFrontendWithRetry:
    def __init__(self):
        self.answers = {}

    def complete(self, req_id, status, body, retry_after=0):
        self.answers[req_id] = (status, body, retry_after)


def test_shed_429_carries_retry_after_natively():
    """A port native server whose device looks pathologically slow: under
    concurrent arrivals some requests are shed, each with 429, Retry-After
    and the shed body."""
    server = PolicyServer(
        _policies(), port=0, readiness_probe_port=0, device="cpu",
        frontend="native", request_timeout_ms=100.0, max_batch_size=2,
        batch_timeout_ms=5.0, policy_timeout=30.0, policy_reload_mode="off",
        selfheal_interval_seconds=0,
    )
    server.start()
    try:
        server.batcher._dev_rtt[2] = 50.0
        body = json.dumps(_docs(1, 26)[0]).encode()
        results: list = [None] * 128

        def one(i: int) -> None:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
                conn.request("POST", "/validate/pod-privileged", body=body,
                             headers={"Connection": "close"})
                resp = conn.getresponse()
                results[i] = (resp.status, resp.getheader("Retry-After"), resp.read())
                conn.close()
            except OSError:
                results[i] = (None, None, None)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(128)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        sheds = [r for r in results if r[0] == 429]
        assert sheds, results[:5]
        for _status, ra, payload in sheds:
            assert int(ra) >= 1
            assert json.loads(payload) == {
                "message": "policy server overloaded; retry later",
                "retry_after_seconds": int(ra),
            }
        assert server.batcher.stats_snapshot()["shed_requests"] >= len(sheds)
    finally:
        server.stop()


class _SlowFirstWarmEnv:
    """An environment whose first warmup of each bucket pays a 'build'
    (0.3 s) and whose second is quick: the batcher must seed its round
    trip from the second."""

    supports_host_fastpath = True
    warmup_dispatches = 1

    def __init__(self):
        self.warmed: set = set()

    def warmup(self, sizes) -> None:
        slow = [b for b in sizes if b not in self.warmed]
        self.warmed.update(sizes)
        if slow:
            time.sleep(0.3)


def test_warmup_seeds_the_round_trip_from_the_second_run_under_a_timeout_alone():
    """With the latency budget off and only a request timeout, warmup still
    seeds the device round trip per bucket (shedding reads it), from the
    build-free second run, as the JAX package does."""
    from policy_server_tpu.runtime.batcher import MicroBatcher as JB

    out = {}
    for name, cls in (("jax", JB), ("port", MicroBatcher)):
        seeded = []
        for timeout_ms in (0.0, 10000.0):
            b = cls(_SlowFirstWarmEnv(), max_batch_size=8, latency_budget_ms=0,
                    request_timeout_ms=timeout_ms)
            b.warmup()
            seeded.append(sorted(b._dev_rtt))
            assert all(v < 0.1 for v in b._dev_rtt.values()), (name, b._dev_rtt)
            b.shutdown()
        out[name] = seeded
    assert out["port"] == out["jax"] == [[], [1, 2, 4, 8]]


def test_default_flags_propagate_the_ten_second_deadline(monkeypatch):
    """--request-timeout-ms defaults to 10,000 (KUBEWARDEN_REQUEST_TIMEOUT_MS
    replaces it); the server's batcher stamps every row's deadline."""
    from policy_server_tpu.config.cli import build_cli as jax_cli
    from policy_server_tpu_torch.__main__ import build_cli, validate_args

    args = build_cli().parse_args([])
    assert args.request_timeout_ms == jax_cli().parse_args([]).request_timeout_ms == 10000.0
    for flag, value, text in (
        ("--serving-shards", "0", "--serving-shards must be >= 1"),
        ("--shard-heartbeat-seconds", "0", "--shard-heartbeat-seconds must be > 0"),
    ):
        with pytest.raises(ValueError, match=re.escape(text)):
            validate_args(build_cli().parse_args([flag, value]))
    monkeypatch.setenv("KUBEWARDEN_REQUEST_TIMEOUT_MS", "2500")
    monkeypatch.setenv("KUBEWARDEN_SERVING_SHARDS", "3")
    args = build_cli().parse_args([])
    assert (args.request_timeout_ms, args.serving_shards) == (2500.0, 3)
    server = PolicyServer(
        _policies(), port=0, readiness_probe_port=0, device="cpu",
        policy_reload_mode="off", selfheal_interval_seconds=0,
    )
    server.start()
    try:
        b = server.batcher
        assert b.request_timeout == 10.0
        item, = _items(1, 27)
        futs = b.submit_many([(item[0], item[2])], t_service.RequestOrigin.VALIDATE)
        futs[0].result(timeout=10)
        assert b.stats_snapshot()["shed_requests"] == 0
    finally:
        server.stop()
