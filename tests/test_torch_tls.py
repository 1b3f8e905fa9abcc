"""TLS in the port (``policy_server_tpu_torch/certs.py``, the TLS flags,
the standard-library terminator in ``server.py`` and the native terminator
``runtime/native_frontend.NativeTlsManager``) held against the JAX
package's on identical inputs, with tolerance 0.

* ``certs.py``: both packages' ``ReloadableTlsContext`` watch the same
  files through the same sequence of writes (both files, one file, a
  corrupt PEM, a client-CA change, the ``certs.reload`` failpoint, SIGHUP's
  ``reload_now``); after every step their ``counters()``, identity and
  client-CA snapshots and ``identity_not_after()`` are equal. The
  multi-cert, multi-key and empty files raise the same texts.
* Flags: the JAX package's ``Config.from_args`` and the port's
  ``validate_args`` reject the same bad values with the same texts.
* HTTPS: the port's native terminator against the JAX package's native
  terminator (status, headers but Date, body; the port sends the JAX
  package's Server header here), and the port's standard-library
  terminator against the JAX package's aiohttp terminator (status, headers
  but Date and Server, body; framing garbage and the 413 by status only,
  as each package's plaintext frontends answer them in their own words),
  over mTLS with a client the CA issued: the firehose, keep-alive and
  pipelining, malformed and oversized bodies; clients with no certificate
  or another CA's are refused by all four. The native loops' connection
  cap (503 and a clean close_notify), handshake-timeout reap and
  mid-handshake disconnect, rotation under load and the ``tls.handshake``
  failpoint give equal observations on both packages.
* The port's rule where the JAX package falls back: ``--frontend native``
  with TLS and a libssl that does not load raises at start.

Certificates are made with ``cryptography``."""

from __future__ import annotations

import json
import re
import socket
import ssl
import threading
import time

import pytest

pytest.importorskip("cryptography")

from policy_server_tpu import certs as jcerts
from policy_server_tpu import failpoints as jfp
from policy_server_tpu.config.config import TlsConfig as JTlsConfig
from policy_server_tpu.runtime import native_frontend as jnf
from policy_server_tpu_torch import certs as tcerts
from policy_server_tpu_torch import failpoints as tfp
from policy_server_tpu_torch.runtime import native_frontend as nf
from policy_server_tpu_torch.server import PolicyServer

from test_torch_native_frontend import (
    SPECS,
    corpus,
    normalize,
    parse_responses,
    pod_review_body,
    post_bytes,
    review,
)
from torch_port_support import (
    JaxServer,
    cert_pem,
    client_context,
    key_pem,
    make_cert,
    peer_serial,
    tls_material,
)
from policy_server_tpu_torch.models.policy import (
    parse_policy_entry as t_parse_policy_entry,
)
from torch_port_support import jax_native_libraries  # noqa: F401 (autouse)

pytestmark = pytest.mark.skipif(
    not (nf.native_available() and nf.tls_available()),
    reason="the native frontend or its libssl does not load here",
)

SOCKET_TIMEOUT = 15.0


@pytest.fixture(autouse=True)
def clean_failpoints():
    jfp.reset()
    tfp.reset()
    yield
    jfp.reset()
    tfp.reset()


# -- certs.py ------------------------------------------------------------------


def _observe(ctx) -> dict:
    return {
        "counters": ctx.counters(),
        "identity": ctx.identity_snapshot(),
        "client_cas": ctx.client_ca_snapshot(),
        "not_after": ctx.identity_not_after(),
    }


def _rotate(d, stem="server", cert=True, key=True):
    k, c = make_cert("rotated")
    if cert:
        (d / f"{stem}.crt").write_bytes(cert_pem(c))
    if key:
        (d / f"{stem}.key").write_bytes(key_pem(k))


def _new_ca(d):
    (d / "ca.crt").write_bytes(cert_pem(make_cert("ca-2", is_ca=True)[1]))


def _arm_failpoints():
    def boom():
        raise RuntimeError("corrupt cert material")

    jfp.set_failpoint("certs.reload", boom, count=1)
    tfp.set_failpoint("certs.reload", boom, count=1)


# each scenario: the steps, every one a write followed by "poll" (the 1 s
# digest poll's body) or "sighup" (reload_now)
CERT_SCENARIOS = {
    "both_files_changed": [(lambda d: _rotate(d), "poll")],
    "one_file_changed": [
        (lambda d: _rotate(d, key=False), "poll"),
        (lambda d: _rotate(d, cert=False), "poll"),
    ],
    "corrupt_pem": [
        (lambda d: ((d / "server.crt").write_text("-----NOT A CERT-----\n"),
                    (d / "server.key").write_text("garbage\n")), "poll"),
        (lambda d: None, "poll"),
        (lambda d: _rotate(d), "poll"),
    ],
    "client_ca_changed": [
        (_new_ca, "poll"),
        (lambda d: (d / "ca.crt").write_text("truncated\n"), "poll"),
    ],
    "certs_reload_failpoint": [
        (lambda d: (_arm_failpoints(), _rotate(d)), "poll"),
        (lambda d: None, "poll"),
    ],
    "sighup_with_one_file": [(lambda d: _rotate(d, key=False), "sighup")],
}


@pytest.mark.parametrize("scenario", sorted(CERT_SCENARIOS))
def test_reload_rules_and_counters_match_the_jax_package(tmp_path, scenario):
    m = tls_material(tmp_path)
    jctx = jcerts.ReloadableTlsContext(JTlsConfig(
        cert_file=m["cert"], key_file=m["key"], client_ca_file=(m["ca"],)
    ))
    tctx = tcerts.ReloadableTlsContext(tcerts.TlsConfig(
        cert_file=m["cert"], key_file=m["key"], client_ca_file=(m["ca"],)
    ))
    seen_j, seen_t = [_observe(jctx)], [_observe(tctx)]
    notified = {"jax": 0, "port": 0}
    jctx.add_reload_listener(lambda: notified.__setitem__("jax", notified["jax"] + 1))
    tctx.add_reload_listener(lambda: notified.__setitem__("port", notified["port"] + 1))
    for write, how in CERT_SCENARIOS[scenario]:
        write(tmp_path)
        for ctx in (jctx, tctx):
            if how == "poll":
                ctx._check_files_once()
            else:
                ctx.reload_now()
        seen_j.append(_observe(jctx))
        seen_t.append(_observe(tctx))
    assert seen_t == seen_j
    assert notified["port"] == notified["jax"]
    # every scenario moves a counter
    assert seen_t[-1]["counters"] != seen_t[0]["counters"]


def test_the_watch_thread_applies_a_rotation_within_a_poll(tmp_path):
    m = tls_material(tmp_path)
    outer = tcerts.create_tls_config_and_watch_certificate_changes(
        tcerts.TlsConfig(cert_file=m["cert"], key_file=m["key"])
    )
    rel = outer._reloadable
    try:
        _rotate(tmp_path)
        deadline = time.monotonic() + tcerts.WATCH_INTERVAL_SECONDS + 3
        while rel.counters() == (0, 0) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert rel.counters() == (1, 0)
    finally:
        rel.stop()
    assert rel._thread is None


@pytest.mark.parametrize("case", ["two_certs", "no_cert", "two_keys", "no_key"])
def test_tls_config_errors_have_the_jax_texts(tmp_path, case):
    m = tls_material(tmp_path)
    bad = tmp_path / "bad.pem"
    cert, key = open(m["cert"], "rb").read(), open(m["key"], "rb").read()
    bad.write_bytes({
        "two_certs": cert + cert, "no_cert": b"nothing\n",
        "two_keys": key + key, "no_key": b"nothing\n",
    }[case])
    paths = (
        dict(cert_file=str(bad), key_file=m["key"])
        if case in ("two_certs", "no_cert")
        else dict(cert_file=m["cert"], key_file=str(bad))
    )
    with pytest.raises(jcerts.TlsConfigError) as want:
        jcerts.ReloadableTlsContext(JTlsConfig(**paths))
    with pytest.raises(tcerts.TlsConfigError) as got:
        tcerts.ReloadableTlsContext(tcerts.TlsConfig(**paths))
    assert str(got.value) == str(want.value)


# -- the flags -----------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--cert-file", "c.pem"],
    ["--key-file", "k.pem"],
    ["--client-ca-file", "ca.pem"],
    ["--http-workers", "0"],
    ["--worker-respawn-giveup", "0"],
    ["--native-tls-handshake-timeout-seconds", "-1"],
])
def test_flag_validation_texts_are_the_jax_configs(tmp_path, argv):
    from policy_server_tpu.config.cli import build_cli as jax_cli
    from policy_server_tpu.config.config import Config
    from policy_server_tpu_torch.__main__ import build_cli, validate_args

    policies = tmp_path / "policies.yml"
    policies.write_text("{}\n")
    argv = argv + ["--policies", str(policies)]
    with pytest.raises(ValueError) as want:
        Config.from_args(jax_cli().parse_args(argv))
    with pytest.raises(ValueError) as got:
        validate_args(build_cli().parse_args(argv))
    assert str(got.value) == str(want.value)


def test_tls_flags_reach_the_server(tmp_path, monkeypatch):
    """The flags and their KUBEWARDEN_* variables (a comma list for the
    repeatable client-CA flag, as the JAX package reads it)."""
    from policy_server_tpu_torch.__main__ import build_cli, server_from_args

    m = tls_material(tmp_path)
    policies = tmp_path / "policies.json"
    policies.write_text(json.dumps(
        {"pod-privileged": {"module": "builtin://pod-privileged"}}
    ))
    monkeypatch.setenv("KUBEWARDEN_CLIENT_CA_FILE", f"{m['ca']},{m['ca']}")
    monkeypatch.setenv("KUBEWARDEN_NATIVE_TLS_HANDSHAKE_TIMEOUT_SECONDS", "3")
    args = build_cli().parse_args([
        "--policies", str(policies), "--port", "0",
        "--readiness-probe-port", "0", "--addr", "127.0.0.1",
        "--device", "cpu", "--cert-file", m["cert"], "--key-file", m["key"],
        "--frontend", "native",
    ])
    assert args.client_ca_file == [m["ca"], m["ca"]]
    assert args.native_tls == "auto" and args.http_workers == 1
    assert args.worker_respawn_giveup == 5
    server = server_from_args(args)
    server.start()
    try:
        rel = server.tls_context._reloadable
        assert rel.tls_config.client_ca_file == (m["ca"], m["ca"])
        assert server.state.native_tls is not None
        s = client_context(m["good_cert"], m["good_key"]).wrap_socket(
            socket.create_connection(("127.0.0.1", server.port), timeout=10)
        )
        assert peer_serial(s) == m["serial"]
        s.close()
    finally:
        server.stop()


# -- HTTPS against the JAX package ---------------------------------------------


def _port_server(tls, **kw) -> PolicyServer:
    server = PolicyServer(
        {k: t_parse_policy_entry(k, v) for k, v in SPECS.items()},
        port=0, readiness_probe_port=0, device="cpu", max_batch_size=8,
        tls_config=tls, **kw,
    )
    server.start()
    return server


@pytest.fixture(scope="module")
def mtls_quad(tmp_path_factory):
    """(JAX native, port native, JAX aiohttp, port stdlib), every one
    terminating mTLS with the same identity and client CA."""
    m = tls_material(tmp_path_factory.mktemp("mtls"))
    mp = pytest.MonkeyPatch()
    mp.setattr(nf, "server_header", jnf.server_header)
    jtls = JTlsConfig(cert_file=m["cert"], key_file=m["key"],
                      client_ca_file=(m["ca"],))
    ttls = tcerts.TlsConfig(cert_file=m["cert"], key_file=m["key"],
                            client_ca_file=(m["ca"],))
    servers = []
    try:
        servers.append(JaxServer(SPECS, frontend="native", tls_config=jtls))
        servers.append(_port_server(ttls, frontend="native"))
        servers.append(JaxServer(SPECS, frontend="python", tls_config=jtls))
        servers.append(_port_server(ttls, frontend="python"))
        assert servers[0].server._native_tls is not None
        assert servers[1].state.native_tls is not None
        yield servers, m
    finally:
        for s in servers:
            s.stop()
        mp.undo()


def send_tls(port: int, data: bytes, ctx, timeout: float = SOCKET_TIMEOUT) -> bytes:
    s = ctx.wrap_socket(socket.create_connection(("127.0.0.1", port), timeout=timeout))
    try:
        try:
            s.sendall(data)
        except OSError:
            pass  # answered and closed before the whole body was read (413)
        out = b""
        try:
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                out += chunk
        except (socket.timeout, ConnectionResetError, ssl.SSLError):
            pass
        return out
    finally:
        s.close()


def _exchange(server, data, ctx, drop=("date",)):
    return normalize(parse_responses(send_tls(server.port, data, ctx)), drop)


def assert_quad(quad, data: bytes, n: int | None = None):
    """Native against native with every header but Date; the standard
    library's against aiohttp without Server."""
    (jnat, tnat, jpy, tpy), m = quad
    ctx = client_context(m["good_cert"], m["good_key"])
    want = _exchange(jnat, data, ctx)
    assert _exchange(tnat, data, ctx) == want
    want_py = _exchange(jpy, data, ctx, drop=("date", "server"))
    got_py = _exchange(tpy, data, ctx, drop=("date", "server"))
    assert got_py == want_py
    if n is not None:
        assert len(want) == n and len(got_py) == n
    return want


def test_firehose_over_mtls_equals_the_jax_package(mtls_quad):
    work = corpus(21, "-tls")[:24]
    wire = b"".join(
        post_bytes(f"/validate/{pid}", body, close=i == len(work) - 1)
        for i, (pid, body) in enumerate(work)
    )
    resps = assert_quad(mtls_quad, wire, len(work))
    assert all(s == "HTTP/1.1 200 OK" for s, _h, _b in resps)


def test_keep_alive_and_pipelining_over_mtls(mtls_quad):
    body = review()
    wire = (
        post_bytes("/validate/pod-privileged", body, close=False)
        + post_bytes("/audit/priv-monitor", body, close=False)
        + post_bytes("/validate/pod-privileged", body, close=True)
    )
    assert_quad(mtls_quad, wire, 3)


@pytest.mark.parametrize("body", [b"{not json", b'{"no": "review"}'])
def test_malformed_bodies_over_mtls(mtls_quad, body):
    resps = assert_quad(mtls_quad, post_bytes("/validate/pod-privileged", body), 1)
    assert resps[0][0].startswith("HTTP/1.1 422")


def test_oversized_body_and_framing_garbage_over_mtls(mtls_quad):
    (jnat, tnat, jpy, tpy), m = mtls_quad
    ctx = client_context(m["good_cert"], m["good_key"])
    big = post_bytes(
        "/validate/pod-privileged",
        review(obj={"filler": "x" * (9 * 1024 * 1024)}),
    )

    def mask(resps):
        return [
            (s, {k: v for k, v in h.items() if k != "content-length"},
             re.sub(rb"actual body size \d+", b"actual body size N", b))
            for s, h, b in resps
        ]

    want = mask(_exchange(jnat, big, ctx))
    assert mask(_exchange(tnat, big, ctx)) == want
    assert want[0][0] == "HTTP/1.1 413 Request Entity Too Large"
    for server in (jpy, tpy):
        assert _exchange(server, big, ctx)[0][0].startswith("HTTP/1.1 413")
        out = send_tls(server.port, b"BLARGH\r\n\r\n", ctx)
        assert b" 400 " in out.split(b"\r\n", 1)[0], out[:100]
    assert send_tls(jnat.port, b"BLARGH\r\n\r\n", ctx).split(b"\r\n", 1)[0] == (
        send_tls(tnat.port, b"BLARGH\r\n\r\n", ctx).split(b"\r\n", 1)[0]
    )


def _refused(port: int, ctx) -> bool:
    """True when the server serves no HTTP to this client: the handshake
    fails with an alert or the connection closes."""
    try:
        s = ctx.wrap_socket(
            socket.create_connection(("127.0.0.1", port), timeout=5)
        )
        s.sendall(post_bytes("/validate/pod-privileged", review()))
        data = s.recv(1000)
        s.close()
        return data == b""
    except (OSError, ssl.SSLError):
        return True


def test_mtls_refuses_and_accepts_as_the_jax_package(mtls_quad):
    (jnat, tnat, jpy, tpy), m = mtls_quad
    before = {
        "jax": jnat.server._native_frontend.stats()["tls_handshakes_failed"],
        "port": tnat.native_frontend.stats()["tls_handshakes_failed"],
    }
    for server in (jnat, tnat, jpy, tpy):
        assert _refused(server.port, client_context()), "cert-less client served"
        assert _refused(
            server.port, client_context(m["bad_cert"], m["bad_key"])
        ), "other-CA client served"
    resps = assert_quad(
        mtls_quad, post_bytes("/validate/pod-privileged", review()), 1
    )
    assert resps[0][0] == "HTTP/1.1 200 OK"
    after = {
        "jax": jnat.server._native_frontend.stats()["tls_handshakes_failed"],
        "port": tnat.native_frontend.stats()["tls_handshakes_failed"],
    }
    assert after["port"] - before["port"] == after["jax"] - before["jax"] == 2


# -- the native loops' hardening, both packages ----------------------------------


class _EchoSink:
    def handle_burst(self, frontend, burst):
        for rec in burst:
            frontend.complete(rec[0], 200, b'{"ok": true}')


def _mini(mod, m, **kw):
    sock = mod.make_listen_socket("127.0.0.1", 0)
    front = mod.NativeFrontend(sock, _EchoSink(), **kw)
    handle = mod.tls_ctx_create(
        open(m["cert"], "rb").read(), open(m["key"], "rb").read()
    )
    front.set_tls(handle)
    front.start()
    return front, sock.getsockname()[1], handle


def _connection_cap(mod, m) -> dict:
    front, port, h = _mini(mod, m, max_connections=2)
    try:
        ctx = client_context()
        keep = []
        for _ in range(2):
            s = ctx.wrap_socket(socket.create_connection(("127.0.0.1", port)))
            s.sendall(post_bytes("/validate/p", b"{}", close=False))
            assert s.recv(200).startswith(b"HTTP/1.1 200")
            keep.append(s)
        over = ctx.wrap_socket(
            socket.create_connection(("127.0.0.1", port)),
            suppress_ragged_eofs=False,
        )
        over.settimeout(10)
        data = b""
        while True:  # an SSLEOFError here is a close without close_notify
            chunk = over.recv(65536)
            if not chunk:
                break
            data += chunk
        resp = normalize(parse_responses(data))
        for s in keep:
            s.close()
        st = front.stats()
        return {"resp": resp, "cap": st["conn_cap_rejections"],
                "clean": st["tls_clean_closes"] >= 1}
    finally:
        front.shutdown(timeout=5)
        mod.tls_ctx_free(h)


def _handshake_drip(mod, m) -> dict:
    front, port, h = _mini(mod, m)
    front.configure_tls(handshake_timeout_ms=1000)
    try:
        s = socket.create_connection(("127.0.0.1", port))
        s.settimeout(1.0)
        t0 = time.monotonic()
        closed_at = None
        for b in b"\x16\x03\x01\x00\xc8\x01\x00\x00" * 4:
            try:
                s.sendall(bytes([b]))
                if s.recv(1) == b"":
                    closed_at = time.monotonic() - t0
                    break
            except socket.timeout:
                continue
            except OSError:
                closed_at = time.monotonic() - t0
                break
        s.close()
        return {"reaped": closed_at is not None and closed_at < 10.0,
                "timeouts": front.stats()["tls_handshake_timeouts"]}
    finally:
        front.shutdown(timeout=5)
        mod.tls_ctx_free(h)


def _mid_handshake_disconnect(mod, m) -> dict:
    front, port, h = _mini(mod, m)
    try:
        s = socket.create_connection(("127.0.0.1", port))
        s.sendall(b"\x16\x03\x01\x00\x80\x01\x00")  # a ClientHello fragment
        s.close()
        deadline = time.time() + 5
        while (
            time.time() < deadline
            and front.stats()["tls_handshake_disconnects"] == 0
        ):
            time.sleep(0.05)
        st = front.stats()
        return {k: st[k] for k in (
            "tls_handshake_disconnects", "tls_connections", "tls_handshakes_ok"
        )}
    finally:
        front.shutdown(timeout=5)
        mod.tls_ctx_free(h)


@pytest.mark.parametrize("scenario", [
    _connection_cap, _handshake_drip, _mid_handshake_disconnect,
], ids=["connection_cap_close_notify", "handshake_timeout_reap",
        "mid_handshake_disconnect"])
def test_native_tls_hardening_matches_the_jax_package(tmp_path, scenario):
    m = tls_material(tmp_path)
    mp = pytest.MonkeyPatch()
    mp.setattr(nf, "server_header", jnf.server_header)
    try:
        want = scenario(jnf, m)
        got = scenario(nf, m)
    finally:
        mp.undo()
    assert got == want
    assert any(v for v in got.values())


# -- rotation under load and the handshake failpoint -----------------------------


def read_response(sock) -> tuple[int, bytes]:
    """One whole response from a keep-alive connection → (status, body)."""
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("closed mid-response")
        data += chunk
    head, _, rest = data.partition(b"\r\n\r\n")
    length = int(re.search(rb"(?i)content-length: *(\d+)", head).group(1))
    while len(rest) < length:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("closed mid-body")
        rest += chunk
    return int(head.split(b" ", 2)[1]), rest[:length]


class _Side:
    """One package's TLS server on mutable identity files, with what the
    scenarios read from it."""

    def __init__(self, side: str, directory, frontend: str):
        self.m = tls_material(directory)
        self.directory = directory
        if side == "jax":
            self.handle = JaxServer(SPECS, frontend=frontend, tls_config=JTlsConfig(
                cert_file=self.m["cert"], key_file=self.m["key"]))
            srv = self.handle.server
            self.port, self.reload_signal = srv.api_port, srv.reload_signal
            self.reloadable = srv.tls_context._reloadable
            self.manager, self.front = srv._native_tls, srv._native_frontend
            self.fp = jfp
        else:
            self.handle = _port_server(
                tcerts.TlsConfig(cert_file=self.m["cert"], key_file=self.m["key"]),
                frontend=frontend,
            )
            self.port, self.reload_signal = self.handle.port, self.handle.reload_signal
            self.reloadable = self.handle.state.tls_reloadable
            self.manager = self.handle.state.native_tls
            self.front = self.handle.native_frontend
            self.fp = tfp

    def generations(self) -> int:
        return self.manager.snapshot()["generations"] if self.manager else 0

    def connect(self, ctx=None):
        return (ctx or client_context()).wrap_socket(
            socket.create_connection(("127.0.0.1", self.port), timeout=30)
        )


def _rotation_under_load(side: _Side) -> dict:
    """Traffic on three keep-alive connections through a rotation: every
    answer 200, new connections see the new serial after a digest poll,
    an established one keeps being answered under the old serial; a half-written rotation changes nothing, and a corrupt PEM
    keeps the last good identity and counts one failure."""
    stop = threading.Event()
    statuses: list[int] = []
    errors: list[str] = []
    req = post_bytes(
        "/validate/pod-privileged",
        json.dumps(pod_review_body(False)).encode(), close=False,
    )

    def traffic() -> None:
        try:
            s = side.connect()
            while not stop.is_set():
                s.sendall(req)
                statuses.append(read_response(s)[0])
            s.close()
        except Exception as e:  # noqa: BLE001 — recorded for the assert
            errors.append(repr(e))

    established = side.connect()
    established.sendall(req)
    first = read_response(established)[0]
    threads = [threading.Thread(target=traffic, daemon=True) for _ in range(3)]
    for t in threads:
        t.start()
    counters, d = side.reloadable.counters, side.directory
    c0, g0 = counters(), side.generations()
    k2, c2 = make_cert("next")
    (d / "server.crt").write_bytes(cert_pem(c2))
    time.sleep(tcerts.WATCH_INTERVAL_SECONDS + 0.5)
    half = (counters() == c0, side.generations() == g0)
    (d / "server.key").write_bytes(key_pem(k2))
    # a poll, then room for a loaded test machine (the card's run holds
    # the poll plus 1 s)
    deadline = time.monotonic() + tcerts.WATCH_INTERVAL_SECONDS + 4.0
    seen_new = False
    while time.monotonic() < deadline and not seen_new:
        s = side.connect()
        seen_new = peer_serial(s) == c2.serial_number
        s.close()
        if not seen_new:
            time.sleep(0.1)
    established.sendall(req)
    still = (read_response(established)[0],
             peer_serial(established) == side.m["serial"])
    established.close()
    c1, g1 = counters(), side.generations()
    (d / "server.crt").write_text("-----NOT A CERT-----\n")
    side.reload_signal()
    deadline = time.monotonic() + 5
    while counters()[1] == c1[1] and time.monotonic() < deadline:
        time.sleep(0.05)
    s = side.connect()
    kept = peer_serial(s) == c2.serial_number
    s.close()
    time.sleep(0.3)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    return {
        "first": first, "half_written_ignored": half, "seen_new": seen_new,
        "established_on_old": still,
        "reloads": (c1[0] - c0[0], counters()[0] - c1[0]),
        "failures": counters()[1] - c1[1],
        "generations": (g1 - g0, side.generations() - g1),
        "kept_last_good": kept,
        "all_200": len(statuses) > 10 and set(statuses) == {200},
        "errors": errors,
    }


@pytest.mark.parametrize("frontend", ["native", "python"])
def test_rotation_under_load_matches_the_jax_package(tmp_path, frontend):
    """Native against native, the standard library's against aiohttp: the
    same observations, with ``tls_generations`` moving only on the native
    loops."""
    out = {}
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        side = _Side(name, tmp_path / name, frontend)
        try:
            out[name] = _rotation_under_load(side)
        finally:
            side.handle.stop()
    assert out["port"] == out["jax"]
    got = out["port"]
    assert got["seen_new"] and got["kept_last_good"] and got["all_200"]
    assert got["established_on_old"] == (200, True)
    assert got["half_written_ignored"] == (True, True)
    assert got["reloads"] == (1, 0) and got["failures"] == 1
    assert got["generations"] == ((1, 0) if frontend == "native" else (0, 0))


def _handshake_failpoint(side: _Side) -> tuple:
    established = side.connect()

    def boom():
        raise side.fp.FailpointError("injected TLS accept outage")

    side.fp.set_failpoint("tls.handshake", boom)
    side.manager.poll_failpoint_once()
    refused = _refused(side.port, client_context())
    deadline = time.monotonic() + 5
    while (
        side.front.stats()["tls_handshakes_fail_injected"] == 0
        and time.monotonic() < deadline
    ):
        time.sleep(0.05)
    injected = side.front.stats()["tls_handshakes_fail_injected"] >= 1
    side.fp.reset()
    side.manager.poll_failpoint_once()
    ok = side.connect()
    recovered = ok.version() is not None
    ok.close()
    established.sendall(post_bytes(
        "/validate/pod-privileged", json.dumps(pod_review_body(False)).encode()
    ))
    rode_through = read_response(established)[0]
    established.close()
    return refused, injected, recovered, rode_through


def test_tls_handshake_failpoint_matches_the_jax_package(tmp_path):
    out = {}
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        side = _Side(name, tmp_path / name, "native")
        try:
            out[name] = _handshake_failpoint(side)
        finally:
            side.handle.stop()
    assert out["port"] == out["jax"] == (True, True, True, 200)


# -- the port's no-fallback rule -------------------------------------------------


def test_native_tls_with_an_unloadable_libssl_raises(tmp_path, monkeypatch):
    """The JAX package warns and serves TLS on aiohttp
    (``tests/test_native_tls.py::test_fallback_when_libssl_unavailable``);
    the port raises at start, and nothing stays bound."""
    m = tls_material(tmp_path)
    monkeypatch.setattr(nf, "tls_available", lambda: False)
    monkeypatch.setattr(
        nf, "tls_error", lambda: "libssl.so: cannot open shared object"
    )
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    with pytest.raises(RuntimeError, match="native TLS unavailable"):
        PolicyServer(
            {"pod-privileged": t_parse_policy_entry(
                "pod-privileged", {"module": "builtin://pod-privileged"})},
            port=port, readiness_probe_port=0, device="cpu",
            frontend="native",
            tls_config=tcerts.TlsConfig(cert_file=m["cert"], key_file=m["key"]),
        )
    s = socket.socket()
    s.bind(("127.0.0.1", port))  # the failed start left the port free
    s.close()


def test_native_tls_off_terminates_on_the_stdlib_frontend(tmp_path, caplog):
    import logging

    m = tls_material(tmp_path)
    with caplog.at_level(logging.WARNING):
        server = _port_server(
            tcerts.TlsConfig(cert_file=m["cert"], key_file=m["key"]),
            frontend="native", native_tls="off",
        )
    try:
        assert server.frontend == "python"
        assert server.native_frontend is None and server.state.native_tls is None
        assert any("--native-tls off" in r.getMessage() for r in caplog.records)
        out = parse_responses(send_tls(
            server.port, post_bytes("/validate/pod-privileged", review()),
            client_context(),
        ))
        assert out[0][0] == "HTTP/1.1 200 OK"
    finally:
        server.stop()


def test_stdlib_handshake_runs_on_the_connection_thread(tmp_path):
    """A client that connects and sends nothing does not stall the next
    client's handshake (the accept thread only wraps the socket)."""
    m = tls_material(tmp_path)
    server = _port_server(
        tcerts.TlsConfig(cert_file=m["cert"], key_file=m["key"]),
        frontend="python",
    )
    silent = socket.create_connection(("127.0.0.1", server.port))
    try:
        t0 = time.monotonic()
        out = parse_responses(send_tls(
            server.port, post_bytes("/validate/pod-privileged", review()),
            client_context(),
        ))
        assert out[0][0] == "HTTP/1.1 200 OK"
        assert time.monotonic() - t0 < 10
    finally:
        silent.close()
        server.stop()
