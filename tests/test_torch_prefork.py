"""The port's prefork HTTP frontend (``runtime/frontend.py``: the bridge
frames, ``EvaluationBridge``, ``BridgeClient``, the worker; the native
worker's ``native_frontend.BridgeSink``; the server's worker lifecycle)
held against the JAX package's on identical inputs, with tolerance 0:

* the port's ``BridgeClient`` writes the JAX client's bytes for every
  origin, and the port's ``EvaluationBridge`` answers frames the JAX
  client sends with the JAX bridge's ``(status, body)``;
* ``--http-workers 2`` under both frontends: every answer (status, headers
  but Date, body) equals the in-process server's on the same request,
  422, 429 and 503 with Retry-After included, and the workers answered
  part of the traffic;
* a killed worker is respawned within the supervisor's interval and
  counted once; a crash-looping slot backs off and is given up at the cap,
  with the readiness note and the worker families on /metrics equal to the
  JAX package's; ``stop()`` leaves no process, socket or directory;
* ``SO_REUSEPORT`` is on the API port only with workers.

The counterparts of ``tests/test_frontend.py``."""

from __future__ import annotations

import asyncio
import json
import math
import os
import signal
import socket
import struct
import sys
import threading
import time
import urllib.request

import pytest
from prometheus_client.parser import text_string_to_metric_families

from policy_server_tpu.runtime import frontend as jfr
from policy_server_tpu_torch.api.api_error import FencedError, ShedError
from policy_server_tpu_torch.models import AdmissionReviewRequest
from policy_server_tpu_torch.models.policy import (
    parse_policy_entry as t_parse_policy_entry,
)
from policy_server_tpu_torch.runtime import frontend as tfr
from policy_server_tpu_torch.runtime import native_frontend as nf
from policy_server_tpu_torch.server import PolicyServer
from policy_server_tpu_torch.telemetry import metrics as t_metrics

from test_torch_native_frontend import (
    SPECS,
    corpus,
    normalize,
    parse_responses,
    post_bytes,
    review,
    send_raw,
)
from torch_port_support import JaxServer

WORKER_FAMILIES = (
    t_metrics.WORKER_RESPAWNS,
    t_metrics.WORKER_RESPAWN_BACKOFF_SECONDS,
    t_metrics.WORKER_SLOTS_GIVEN_UP,
)


def _port_server(**kw) -> PolicyServer:
    server = PolicyServer(
        {k: t_parse_policy_entry(k, v) for k, v in SPECS.items()},
        **dict(dict(port=0, readiness_probe_port=0, device="cpu",
                    max_batch_size=8, host="127.0.0.1"), **kw),
    )
    server.start()
    return server


# -- the frames -----------------------------------------------------------------


class _Capture:
    """A unix-socket peer that keeps every byte a client writes and answers
    each request frame ``(200, b"{}")`` under its id."""

    def __init__(self, path: str):
        self.path = path
        self.data = b""
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.bind(path)
        self.sock.listen(4)
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self) -> None:
        conn, _ = self.sock.accept()
        buf = b""
        while True:
            chunk = conn.recv(65536)
            if not chunk:
                break
            self.data += chunk
            buf += chunk
            while len(buf) >= 4:
                (n,) = struct.unpack_from("<I", buf)
                if len(buf) < 4 + n:
                    break
                req_id = struct.unpack_from("<Q", buf, 4)[0]
                buf = buf[4 + n:]
                reply = struct.pack("<QH", req_id, 200) + b"{}"
                conn.sendall(struct.pack("<I", len(reply)) + reply)
        conn.close()

    def close(self) -> None:
        self.sock.close()


_HEADER = json.dumps(
    {"uid": "u-1", "namespace": "ns", "operation": "CREATE", "kind": "Pod"}
).encode()
FRAME_CASES = {
    "validate": (0, "pod-privileged", review(), None),
    "validate_raw": (1, "raw-mutation", b'{"request": {"uid": "r"}}', None),
    "audit": (2, "team-a/pod-privileged", review(), None),
    "validate_parsed": (3, "pod-privileged", _HEADER, b'{"uid":"u-1"}'),
    "audit_parsed": (4, "t/priv-monitor", _HEADER, b"{}"),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_bridge_client_frames_are_the_jax_clients_bytes(tmp_path, case):
    origin, pid, body, payload = FRAME_CASES[case]

    jcap = _Capture(str(tmp_path / "j.sock"))

    async def jax_calls():
        client = jfr.BridgeClient(jcap.path)
        await client.connect()
        for _ in range(2):  # two frames: the ids count up alike
            if payload is None:
                got = await client.call(origin, pid, body)
            else:
                got = await client.call_parsed(origin, pid, body, payload)
            assert got == (200, b"{}")

    asyncio.run(jax_calls())
    tcap = _Capture(str(tmp_path / "t.sock"))
    client = tfr.BridgeClient(tcap.path)
    client.connect()
    for _ in range(2):
        if payload is None:
            assert client.call(origin, pid, body) == (200, b"{}")
        else:
            assert client.call_parsed(origin, pid, body, payload) == (200, b"{}")
    client.close()
    for cap in (jcap, tcap):
        cap.thread.join(timeout=10)
        cap.close()
    assert tcap.data == jcap.data and len(tcap.data) > 30


def _parsed(body: bytes) -> tuple[bytes, bytes]:
    adm = AdmissionReviewRequest.from_dict(json.loads(body)).request
    return tfr.admission_header(adm), tfr.canonical_payload(adm)


BRIDGE_CASES = {
    "validate": (0, "pod-privileged", review()),
    "validate_malformed": (0, "pod-privileged", b"{not json"),
    "validate_no_review": (0, "pod-privileged", b'{"no": "review"}'),
    "validate_unknown_policy": (0, "nope", review()),
    "validate_unknown_tenant": (0, "team-x/pod-privileged", review()),
    "raw": (1, "raw-mutation", json.dumps(
        {"request": {"uid": "r-1", "spec": {"x": 1}}}).encode()),
    "raw_not_json": (1, "raw-mutation", b"not json"),
    "raw_list": (1, "raw-mutation", b"[]"),
    "audit": (2, "priv-monitor", review()),
    "validate_parsed": (3, "pod-privileged", review()),
    "audit_parsed": (4, "mutate-denied", review()),
    "parsed_unknown_tenant": (3, "team-x/pod-privileged", review()),
}


@pytest.fixture(scope="module")
def bridges(tmp_path_factory):
    """A JAX server with its EvaluationBridge and a port server with the
    port's, on the same policies."""
    d = tmp_path_factory.mktemp("bridges")
    jax = JaxServer(SPECS)
    port = None
    try:
        jbridge = jfr.EvaluationBridge(jax.server.state, str(d / "j.sock"))
        jax.run(jbridge.start())
        port = _port_server()
        tbridge = tfr.EvaluationBridge(port.state, str(d / "t.sock")).start()
        yield jbridge, tbridge
        tbridge.stop()
        jax.run(jbridge.stop())
    finally:
        if port is not None:
            port.stop()
        jax.stop()


@pytest.mark.parametrize("case", sorted(BRIDGE_CASES))
def test_port_bridge_answers_the_jax_client_as_the_jax_bridge(bridges, case):
    jbridge, tbridge = bridges
    origin, pid, body = BRIDGE_CASES[case]

    async def ask(path):
        client = jfr.BridgeClient(path)
        await client.connect()
        if origin >= 3:
            return await client.call_parsed(origin, pid, *_parsed(body))
        return await client.call(origin, pid, body)

    want = asyncio.run(ask(jbridge.socket_path))
    got = asyncio.run(ask(tbridge.socket_path))
    assert got == want


def test_a_short_frame_closes_the_connection_and_fails_in_flight(tmp_path):
    """The counterpart of the JAX bridge's malformed-frame rule: a frame
    too short for its header closes the connection; the client fails what
    it has in flight with ConnectionError and reconnects on its next
    call."""
    path = str(tmp_path / "b.sock")
    bridge = tfr.EvaluationBridge(None, path).start()
    try:
        client = tfr.BridgeClient(path)
        client.connect()
        with client._lock:
            sock = client._sock
            fut = tfr.Future()
            client._pending[1] = fut
            sock.sendall(struct.pack("<I", 3) + b"abc")
        with pytest.raises(ConnectionError):
            fut.result(timeout=10)
        assert client.call(1, "p", b"not json")[0] == 422
    finally:
        bridge.stop()


def test_bridge_client_reconnects_after_a_bridge_restart(tmp_path):
    """The evaluation process goes away and comes back on the same path:
    in-flight and next calls fail with ConnectionError (a worker answers
    503), and the client recovers by itself."""
    path = str(tmp_path / "b.sock")
    bridge = tfr.EvaluationBridge(None, path).start()
    client = tfr.BridgeClient(path)
    client.connect()
    # the raw path 422s before it needs a batcher
    assert client.call(1, "p", b"not json")[0] == 422
    bridge.stop()
    os.unlink(path)
    with pytest.raises(ConnectionError):
        client.call(1, "p", b"not json")
    bridge = tfr.EvaluationBridge(None, path).start()
    try:
        assert client.call(1, "p", b"not json")[0] == 422
    finally:
        bridge.stop()
        client.close()


# -- servers with workers --------------------------------------------------------


class _Refuse:
    """An admission that refuses every row with ``exc``."""

    def __init__(self, exc):
        self.exc = exc

    def admit(self, n: int) -> None:
        raise self.exc


@pytest.fixture(scope="module", params=["python", "native"])
def pair(request):
    """(a server with ``--http-workers 2``, the same server in-process)
    under one frontend."""
    prefork = _port_server(frontend=request.param, http_workers=2)
    alone = None
    try:
        alone = _port_server(frontend=request.param)
        assert len(prefork.worker_procs) == 1
        _wait_for_worker(prefork)
        yield prefork, alone
    finally:
        if alone is not None:
            alone.stop()
        prefork.stop()


def _wait_for_worker(server, timeout: float = 30.0) -> None:
    """Until the bridge has a worker connected (the worker bound the port
    before it connected)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if server.bridge.stats()["connections"] >= 1:
            return
        time.sleep(0.05)
    raise AssertionError("no worker connected to the bridge")


def _answer(port: int, wire: bytes):
    return normalize(parse_responses(send_raw(port, wire)))


def _requests() -> list[bytes]:
    out = [
        post_bytes(f"/validate/{pid}", body) for pid, body in corpus(31)[:12]
    ]
    out += [
        post_bytes("/audit/priv-monitor", review()),
        post_bytes("/validate/pod-privileged", b"{not json"),
        post_bytes("/validate/nope", review()),
        post_bytes("/validate/team-x/pod-privileged", review()),
        post_bytes("/validate_raw/raw-mutation", json.dumps(
            {"request": {"uid": "r-1", "spec": {"x": 1}}}).encode()),
        post_bytes("/nothing/here", b"{}"),
    ]
    return out


def test_workers_answer_as_the_in_process_server(pair):
    prefork, alone = pair
    frames = prefork.bridge.stats()["frames"]
    for _round in range(3):  # fresh connections spread over both processes
        for wire in _requests():
            assert _answer(prefork.port, wire) == _answer(alone.port, wire)
    assert prefork.bridge.stats()["frames"] > frames, "no worker answered"


@pytest.mark.parametrize("exc", [ShedError(2.2), FencedError(0.4)],
                         ids=["shed_429", "fenced_503"])
def test_shed_and_fenced_answers_carry_retry_after_through_workers(pair, exc):
    prefork, alone = pair
    wire = post_bytes("/validate/pod-privileged", review())
    saved = [(s, s.batcher.admission) for s in (prefork, alone)]
    for s, _a in saved:
        s.batcher.admission = _Refuse(exc)
    try:
        want = _answer(alone.port, wire)
        frames = prefork.bridge.stats()["frames"]
        deadline = time.monotonic() + 30
        while prefork.bridge.stats()["frames"] == frames:
            assert _answer(prefork.port, wire) == want
            assert time.monotonic() < deadline, "no worker answered"
    finally:
        for s, a in saved:
            s.batcher.admission = a
    status, headers, _body = want[0]
    assert status.startswith(f"HTTP/1.1 {exc.http_status}")
    assert headers["retry-after"] == str(max(1, math.ceil(exc.retry_after_seconds)))


@pytest.mark.parametrize("frontend", ["python", "native"])
def test_reuse_port_only_with_workers(frontend):
    for workers, want in ((1, 0), (2, 1)):
        server = _port_server(frontend=frontend, http_workers=workers)
        try:
            sock = (
                server.native_frontend._sock if frontend == "native"
                else server._httpd.socket
            )
            assert sock.getsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT) == want
        finally:
            server.stop()


@pytest.mark.parametrize("frontend", ["python", "native"])
def test_killed_worker_is_respawned_and_counted_once(frontend):
    server = _port_server(frontend=frontend, http_workers=2)
    try:
        _wait_for_worker(server)
        victim = server.worker_procs[0]
        bridge_dir, bridge_socket = server._bridge_dir, server._bridge_socket
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=10)
        deadline = time.monotonic() + server._WORKER_RESPAWN_INTERVAL_SECONDS + 1.0
        while (
            server.state.supervisor.stats()["worker_respawns"] == 0
            and time.monotonic() < deadline
        ):
            time.sleep(0.05)
        assert server.state.supervisor.stats()["worker_respawns"] == 1
        # the respawn waits out its backoff, then serves
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not (
            hasattr(server.worker_procs[0], "pid")
            and server.bridge.stats()["connections"] >= 1
        ):
            time.sleep(0.05)
        fresh = server.worker_procs[0]
        assert fresh is not victim and fresh.poll() is None
        for wire in _requests()[:8]:
            assert _answer(server.port, wire)[0][0].startswith("HTTP/1.1 ")
        assert server.state.supervisor.stats()["worker_respawns"] == 1
    finally:
        server.stop()
    assert fresh.poll() is not None
    assert not os.path.exists(bridge_socket) and not os.path.exists(bridge_dir)


def _worker_families(readiness_port: int) -> dict:
    text = urllib.request.urlopen(
        f"http://127.0.0.1:{readiness_port}/metrics", timeout=30
    ).read().decode()
    out = {}
    for fam in text_string_to_metric_families(text):
        if fam.name in WORKER_FAMILIES or fam.name + "_total" in WORKER_FAMILIES:
            out[fam.name] = (fam.type, fam.documentation,
                             [(s.name, s.value) for s in fam.samples])
    return out


def _readiness(port: int) -> tuple[int, str]:
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/readiness", timeout=30
    ) as r:
        return r.status, r.read().decode()


def test_crash_looping_slot_gives_up_as_the_jax_package():
    """Every respawn of the slot exits at once: two respawns with backoff,
    then the slot is given up at ``--worker-respawn-giveup 3``, and the
    server keeps serving with an honest readiness note."""
    crash = [sys.executable, "-c", "import sys; sys.exit(7)"]
    out = {}
    for side in ("jax", "port"):
        if side == "jax":
            handle = JaxServer(
                SPECS, http_workers=2, worker_respawn_giveup=3,
                enable_metrics=True,
            )
            srv = handle.server
            api_port, ready_port = srv.api_port, srv.readiness_port
        else:
            srv = handle = _port_server(
                http_workers=2, worker_respawn_giveup=3, enable_metrics=True
            )
            api_port, ready_port = srv.port, srv.readiness_port
        try:
            srv._WORKER_RESPAWN_INTERVAL_SECONDS = 0.1
            srv._WORKER_CRASH_WINDOW_SECONDS = 60.0
            srv._WORKER_BACKOFF_BASE_SECONDS = 0.05
            srv._worker_cmd = crash
            procs = srv._worker_procs
            procs[0].kill()
            deadline = time.monotonic() + 30
            while procs[0] is not None and time.monotonic() < deadline:
                time.sleep(0.1)
            assert procs[0] is None, "slot must be given up"
            answer = _answer(api_port, post_bytes(
                "/validate/pod-privileged", review()))
            sup = srv.state.supervisor.stats()
            out[side] = {
                "status": answer[0][0],
                "given_up": sup["worker_slots_given_up"],
                "respawns": sup["worker_respawns"],
                "backoff": round(sup["worker_backoff_seconds"], 9),
                "readiness": _readiness(ready_port),
                "families": _worker_families(ready_port),
            }
        finally:
            handle.stop()
    assert out["port"] == out["jax"]
    assert out["port"]["given_up"] == 1 and out["port"]["respawns"] == 2
    assert "1 frontend worker slot(s) gave up" in out["port"]["readiness"][1]


def test_stop_leaves_no_worker_socket_or_directory():
    server = _port_server(frontend="native", http_workers=3)
    _wait_for_worker(server)
    procs = list(server.worker_procs)
    bridge_dir, bridge_socket = server._bridge_dir, server._bridge_socket
    assert len(procs) == 2 and os.path.exists(bridge_socket)
    assert (os.stat(bridge_dir).st_mode & 0o777) == 0o700
    server.stop()
    assert all(p.poll() is not None for p in procs)
    assert not os.path.exists(bridge_socket) and not os.path.exists(bridge_dir)
    assert server.worker_procs == [] and server.bridge is None


def test_worker_without_a_bridge_answers_503(tmp_path):
    """A worker whose evaluation process is gone answers the JAX package's
    503 body."""
    httpd = tfr.WorkerHttpServer(
        ("127.0.0.1", 0), tfr.BridgeClient(str(tmp_path / "gone.sock")), "w"
    )
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        got = _answer(httpd.server_address[1],
                      post_bytes("/validate/pod-privileged", review()))
        assert got[0][0].startswith("HTTP/1.1 503")
        assert got[0][2] == tfr.UNAVAILABLE_BODY == json.dumps(
            {"message": "evaluation backend unavailable"}).encode()
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_native_bridge_sink_forwards_the_jax_sinks_frames(tmp_path):
    """The native worker's sink: a parsed record crosses as the JAX
    ``BridgeSink``'s parsed frame, a fallback record is parsed in the
    worker (422 answered there, never crossing), a raw record crosses as it
    came; answers complete the request with the rebuilt Retry-After."""
    cap = _Capture(str(tmp_path / "c.sock"))
    client = tfr.BridgeClient(cap.path)
    client.connect()

    class Front:
        def __init__(self):
            self.done = []
            self.event = threading.Event()

        def complete(self, req_id, status, body, retry_after=0):
            self.done.append((req_id, status, body, retry_after))
            if len(self.done) == 4:
                self.event.set()

    front = Front()
    sink = nf.BridgeSink(client)
    body = review()
    burst = [
        (1, nf.K_VALIDATE, "pod-privileged", "u-1", "ns", "CREATE", "Pod",
         b'{"uid":"u-1"}', "", 0, 0, 0),
        (2, nf.K_VALIDATE_FB, "pod-privileged", "", None, "", "", b"{bad",
         "", 0, 0, 0),
        (3, nf.K_AUDIT_FB, "priv-monitor", "", None, "", "", body, "", 0, 0, 0),
        (4, nf.K_RAW, "raw-mutation", "", None, "", "", b'{"request": {}}',
         "", 0, 0, 0),
    ]
    sink.handle_burst(front, burst)
    assert front.event.wait(10)
    client.close()
    cap.thread.join(timeout=10)
    cap.close()
    statuses = sorted((d[0], d[1]) for d in front.done)
    assert statuses[0] == (1, 200) and statuses[1][1] == 422

    # the same three crossing frames from the JAX package's client
    jcap = _Capture(str(tmp_path / "j.sock"))

    async def jax_frames():
        c = jfr.BridgeClient(jcap.path)
        await c.connect()
        await c.call_parsed(3, "pod-privileged", json.dumps(
            {"uid": "u-1", "namespace": "ns", "operation": "CREATE",
             "kind": "Pod"}).encode(), b'{"uid":"u-1"}')
        await c.call_parsed(4, "priv-monitor", *_parsed(body))
        await c.call(1, "raw-mutation", b'{"request": {}}')

    asyncio.run(jax_frames())
    jcap.thread.join(timeout=10)
    jcap.close()
    assert cap.data == jcap.data


def test_workers_with_tls_serve_in_process_with_the_jax_warning(tmp_path, caplog):
    """``--http-workers`` above 1 with TLS starts no worker (each would
    need the identity) and says so in the JAX package's words; the API
    port then carries no SO_REUSEPORT."""
    import logging

    from policy_server_tpu_torch.certs import TlsConfig
    from torch_port_support import tls_material

    m = tls_material(tmp_path)
    with caplog.at_level(logging.WARNING):
        server = _port_server(
            http_workers=3, tls_config=TlsConfig(m["cert"], m["key"])
        )
    try:
        assert server.worker_procs == [] and server.bridge is None
        assert server._httpd.socket.getsockopt(
            socket.SOL_SOCKET, socket.SO_REUSEPORT) == 0
        assert any(
            r.getMessage() == "--http-workers is not supported with TLS yet "
            "(workers would each need the cert material); serving in-process"
            for r in caplog.records
        )
    finally:
        server.stop()
