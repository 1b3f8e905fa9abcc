"""The port's native HTTP frontend (``policy_server_tpu_torch/csrc/
httpfront.cpp`` through ``runtime/native_frontend.py``) on the CPU, held
against the JAX package's native frontend (``csrc/httpfront.cpp`` through
``policy_server_tpu.runtime.native_frontend``) on the same policies and the
same raw byte streams: status lines, headers (the Date value excluded) and
body bytes equal, tolerance 0. Both servers run ``--frontend native``; the
port's on ``device="cpu"`` (its kernels' plain versions). The port's
Server header is set to the JAX package's for these comparisons (each
package names its own server; ``test_server_header_is_the_stdlib_
frontends`` holds the port's).

Also held: the record packers and the native renderer byte-equal to the
JAX package's over the family catalog; the C++ canonical bytes equal to
the port's ``AdmissionRequest.to_dict()`` dump; ``submit_many(sink=...)``
delivering once per dispatched batch, with bulk counters equal to the JAX
batcher's; the native ``/metrics`` families equal to the JAX package's
after the same traffic; a failed build or bind under ``--frontend
native`` raising; and the port's two frontends agreeing on the corpus.

Every socket has its own timeout and every server stops in a fixture's
teardown or a ``finally``."""

from __future__ import annotations

import asyncio
import copy
import json
import socket
import threading
import time

import pytest
from prometheus_client.parser import text_string_to_metric_families

from policy_server_tpu.api import service as jax_service
from policy_server_tpu.config.config import Config, TlsConfig
from policy_server_tpu.models import (
    AdmissionResponse as JAdmissionResponse,
)
from policy_server_tpu.models import (
    FragTemplate as JFragTemplate,
)
from policy_server_tpu.models import (
    FragVerdict as JFragVerdict,
)
from policy_server_tpu.models import (
    StatusCause as JStatusCause,
)
from policy_server_tpu.models import (
    StatusDetails as JStatusDetails,
)
from policy_server_tpu.models import (
    ValidationStatus as JValidationStatus,
)
from policy_server_tpu.models.policy import parse_policy_entry
from policy_server_tpu.runtime import native_frontend as jnf
from policy_server_tpu.runtime.batcher import MicroBatcher as JaxBatcher
from policy_server_tpu.server import PolicyServer as JaxPolicyServer
from policy_server_tpu_torch import failpoints
from policy_server_tpu_torch.ops import buildcache
from policy_server_tpu_torch.api import service as t_service
from policy_server_tpu_torch.models import AdmissionReviewRequest
from policy_server_tpu_torch.models.admission import (
    AdmissionResponse,
    FragTemplate,
    FragVerdict,
    StatusCause,
    StatusDetails,
    ValidationStatus,
)
from policy_server_tpu_torch.models.policy import (
    parse_policy_entry as t_parse_policy_entry,
)
from policy_server_tpu_torch.runtime import native_frontend as nf
from policy_server_tpu_torch.runtime.batcher import MicroBatcher
from policy_server_tpu_torch.server import PolicyServer
from policy_server_tpu_torch.telemetry import flightrec
from policy_server_tpu_torch.telemetry import metrics as t_metrics

from conftest import build_admission_review_dict
from torch_port_support import (
    catalog_docs,
    catalog_specs,
    items_for,
    jax_env,
    torch_env,
)
from torch_port_support import jax_native_libraries  # noqa: F401 (autouse)

SPECS = dict(
    catalog_specs(),
    **{
        "priv-monitor": {"module": "builtin://pod-privileged",
                         "policyMode": "monitor"},
        "mutate-denied": {
            "module": "builtin://psp-capabilities",
            "allowedToMutate": False,
            "settings": {
                "allowed_capabilities": ["NET_BIND_SERVICE", "CHOWN"],
                "required_drop_capabilities": ["NET_ADMIN"],
                "default_add_capabilities": ["CHOWN"],
            },
        },
        "group": {
            "expression": "unpriv() && (nonroot() || trusted())",
            "message": "group rejected the request",
            "policies": {
                "unpriv": {"module": "builtin://pod-privileged"},
                "nonroot": {"module": "builtin://run-as-non-root"},
                "trusted": {
                    "module": "builtin://trusted-repos",
                    "settings": {"registries": {"allow": ["docker.io"]}},
                },
            },
        },
    },
)

SOCKET_TIMEOUT = 15.0
# the port's own Server header, before any fixture swaps it
PORT_SERVER_HEADER = nf.server_header
NATIVE_FAMILIES = (
    t_metrics.NATIVE_HTTP_REQUESTS,
    t_metrics.NATIVE_PARSE_FALLBACKS,
    t_metrics.NATIVE_RING_FULL,
    t_metrics.NATIVE_VERDICTS_SERIALIZED,
    t_metrics.NATIVE_PYTHON_SERIALIZED,
    t_metrics.NATIVE_INFLIGHT,
    t_metrics.NATIVE_IDLE_CLOSES,
    t_metrics.NATIVE_CONN_CAP_REJECTS,
    t_metrics.BULK_SUBMITS,
    t_metrics.BULK_SUBMITTED_ROWS,
)
# timings: present on both sides, never equal
NATIVE_TIME_FAMILIES = (
    t_metrics.NATIVE_FRAMING_SECONDS,
    t_metrics.QUEUE_WAIT_SECONDS,
)


# -- servers -----------------------------------------------------------------


class JaxServerHandle:
    """The JAX package's PolicyServer inside a private event-loop thread."""

    def __init__(self, **overrides) -> None:
        config = Config(
            addr="127.0.0.1",
            port=0,
            readiness_probe_port=0,
            tls_config=TlsConfig(),
            policies={k: parse_policy_entry(k, v) for k, v in SPECS.items()},
            **dict(dict(max_batch_size=8, batch_timeout_ms=1.0), **overrides),
        )
        self.server = JaxPolicyServer.new_from_config(config)
        self.loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        assert self._started.wait(timeout=120), "JAX server failed to start"

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.run_until_complete(self.server.start())
        self._started.set()
        self.loop.run_forever()

    @property
    def port(self) -> int:
        return self.server.api_port

    @property
    def readiness_port(self) -> int:
        return self.server.readiness_port

    def stop(self) -> None:
        async def _shutdown():
            await self.server.stop()
            self.loop.stop()

        asyncio.run_coroutine_threadsafe(_shutdown(), self.loop)
        self.thread.join(timeout=30)


def _port_policies() -> dict:
    return {k: t_parse_policy_entry(k, v) for k, v in SPECS.items()}


def port_server(**kw) -> PolicyServer:
    kw = dict(
        dict(port=0, readiness_probe_port=0, device="cpu", max_batch_size=8,
             enable_metrics=True),
        **kw,
    )
    server = PolicyServer(_port_policies(), **kw)
    server.start()
    return server


@pytest.fixture(scope="module")
def same_server_header():
    """The port's native frontend sends the JAX package's Server header
    in the comparisons below."""
    mp = pytest.MonkeyPatch()
    mp.setattr(nf, "server_header", jnf.server_header)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def trio(same_server_header):
    """(JAX native, port native, port stdlib) on the same policies."""
    jax_server = JaxServerHandle(frontend="native", enable_metrics=True)
    port_native = port_stdlib = None
    try:
        port_stdlib = port_server(frontend="python")
        # built last: the process registry's runtime stats are its
        port_native = port_server(frontend="native")
        assert port_native.native_frontend is not None
        assert jax_server.server._native_frontend is not None
        yield jax_server, port_native, port_stdlib
    finally:
        for s in (port_native, port_stdlib):
            if s is not None:
                s.stop()
        jax_server.stop()


# -- raw-socket helpers ------------------------------------------------------


def send_raw(port: int, data: bytes, timeout: float = SOCKET_TIMEOUT) -> bytes:
    """Send ``data`` on a fresh connection and read until the server
    closes it (or ``timeout`` passes with nothing more)."""
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    try:
        s.sendall(data)
        out = b""
        try:
            while True:
                chunk = s.recv(1 << 20)
                if not chunk:
                    break
                out += chunk
        except (socket.timeout, ConnectionResetError):
            pass
        return out
    finally:
        s.close()


def parse_responses(stream: bytes) -> list[tuple[str, dict, bytes]]:
    """Split a byte stream into (status line, headers, body); a 100
    Continue is kept as a body-less entry."""
    out = []
    rest = stream
    while rest:
        head_end = rest.find(b"\r\n\r\n")
        if head_end < 0:
            out.append(("<trailing-garbage>", {}, rest))
            break
        head = rest[:head_end].decode("latin-1")
        rest = rest[head_end + 4 :]
        lines = head.split("\r\n")
        headers: dict[str, str] = {}
        for ln in lines[1:]:
            k, _, v = ln.partition(":")
            headers[k.strip().lower()] = v.strip()
        if lines[0].endswith("100 Continue"):
            out.append((lines[0], headers, b""))
            continue
        n = int(headers.get("content-length", "0"))
        out.append((lines[0], headers, rest[:n]))
        rest = rest[n:]
    return out


def normalize(parsed, drop=("date",)):
    return [
        (status, {k: v for k, v in hdrs.items() if k not in drop}, body)
        for status, hdrs, body in parsed
    ]


def exchange(port: int, payload: bytes) -> list:
    return normalize(parse_responses(send_raw(port, payload)))


def assert_identical(trio, payload: bytes, n_responses: int | None = None):
    jax_server, port_native, _ = trio
    want = exchange(jax_server.port, payload)
    got = exchange(port_native.port, payload)
    assert got == want, (
        f"frontends diverged for {payload[:120]!r}...\n"
        f"JAX: {want}\nport: {got}"
    )
    if n_responses is not None:
        assert len(got) == n_responses
    return got


def post_bytes(path: str, body: bytes, close: bool = True, extra: str = "") -> bytes:
    head = (
        f"POST {path} HTTP/1.1\r\nHost: t\r\n"
        f"Content-Type: application/json\r\n"
        f"Content-Length: {len(body)}\r\n{extra}"
    )
    if close:
        head += "Connection: close\r\n"
    return head.encode() + b"\r\n" + body


def pod_review_body(privileged: bool) -> dict:
    doc = build_admission_review_dict()
    doc["request"]["object"] = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": "p", "namespace": "default"},
        "spec": {
            "containers": [
                {
                    "name": "c",
                    "image": "nginx",
                    "securityContext": {"privileged": privileged},
                }
            ]
        },
    }
    return doc


def review(obj=None, **request_overrides) -> bytes:
    doc = pod_review_body(False)
    if obj is not None:
        doc["request"]["object"] = obj
    doc["request"].update(request_overrides)
    return json.dumps(doc).encode()


def corpus(seed: int, uid_suffix: str = "") -> list[tuple[str, bytes]]:
    """The family catalog's reviews, each addressed to two policy ids."""
    docs = catalog_docs(28, seed)
    ids = sorted(SPECS)
    out = []
    for i, d in enumerate(docs):
        d = copy.deepcopy(d)
        d["request"]["uid"] = f"{d['request']['uid']}-{i}{uid_suffix}"
        body = json.dumps(d).encode()
        out.append((ids[(2 * i) % len(ids)], body))
        out.append((ids[(2 * i + 1) % len(ids)], body))
    return out


def pipelined(work: list[tuple[str, bytes]], route: str = "validate") -> bytes:
    return b"".join(
        post_bytes(f"/{route}/{pid}", body, close=i == len(work) - 1)
        for i, (pid, body) in enumerate(work)
    )


# -- the differential corpus -------------------------------------------------


@pytest.mark.parametrize("seed", [5, 41])
def test_catalog_verdicts_bit_exact_pipelined(trio, seed):
    """The family catalog's verdicts through one pipelined keep-alive
    connection per server, then again with new uids (the verdict cache
    answers: fragment records)."""
    for suffix in ("", "-again"):
        work = corpus(seed, suffix)
        resps = assert_identical(trio, pipelined(work), len(work))
        assert all(s == "HTTP/1.1 200 OK" for s, _h, _b in resps)
        allowed = {json.loads(b)["response"]["allowed"] for _s, _h, b in resps}
        assert allowed == {True, False}  # the sweep is not vacuous


def test_keep_alive_and_pipelining(trio):
    one = post_bytes(
        "/validate/pod-privileged",
        json.dumps(pod_review_body(False)).encode(), close=False,
    )
    two = post_bytes(
        "/validate/pod-privileged", json.dumps(pod_review_body(True)).encode()
    )
    resps = assert_identical(trio, one + two, 2)
    assert all(s == "HTTP/1.1 200 OK" for s, _h, _b in resps)
    assert "connection" not in resps[0][1]
    assert resps[1][1].get("connection") == "close"


MALFORMED = [
    b"not json at all",
    b"{",
    b'{"request": "not an object"}',
    b'{"nope": 1}',
    b'{"request": {"operation": "CREATE"}}',
    b'{"request": {"uid": ""}}',
    b'{"request": {"uid": 42}}',
    b'{"request": {"uid": "u", "kind": "Pod"}}',
    json.dumps({"request": {"uid": "u"}, "extra": [1, {"a": None}]}).encode(),
]


@pytest.mark.parametrize("body", MALFORMED)
def test_malformed_and_undeserializable_bodies(trio, body):
    (status, _h, resp) = assert_identical(
        trio, post_bytes("/validate/pod-privileged", body), 1
    )[0]
    if body == MALFORMED[-1]:
        assert status == "HTTP/1.1 200 OK"
    else:
        assert status == "HTTP/1.1 422 Unprocessable Entity", resp


def test_routing_404_405_and_unknown_tenants(trio):
    a = assert_identical(trio, post_bytes("/no/such/route", b"{}"), 1)
    assert a[0][0] == "HTTP/1.1 404 Not Found"
    a = assert_identical(
        trio,
        b"GET /validate/pod-privileged HTTP/1.1\r\nHost: t\r\n"
        b"Connection: close\r\n\r\n",
        1,
    )
    assert a[0][0] == "HTTP/1.1 405 Method Not Allowed"
    assert a[0][1]["allow"] == "POST"
    body = json.dumps(pod_review_body(False)).encode()
    a = assert_identical(trio, post_bytes("/validate/nope", body), 1)
    assert a[0][0] == "HTTP/1.1 404 Not Found"
    assert json.loads(a[0][2])["status"] == 404
    # a two-segment id names a tenant; neither server has one
    for route in ("validate", "audit"):
        a = assert_identical(
            trio, post_bytes(f"/{route}/team-a/pod-privileged", body), 1
        )
        assert json.loads(a[0][2]) == {
            "message": "unknown tenant: team-a", "status": 404,
        }


def _oversized_cases():
    big = review(obj={"filler": "x" * (9 * 1024 * 1024)})
    payload = b"y" * (9 * 1024 * 1024)
    chunked = (
        b"POST /validate/pod-privileged HTTP/1.1\r\nHost: t\r\n"
        b"Transfer-Encoding: chunked\r\nConnection: close\r\n\r\n"
        + hex(len(payload))[2:].encode() + b"\r\n" + payload
        + b"\r\n0\r\n\r\n"
    )
    return [
        ("content-length", post_bytes("/validate/pod-privileged", big), len(big)),
        ("chunked", chunked, len(payload)),
    ]


@pytest.mark.parametrize("case", ["content-length", "chunked"])
def test_oversized_bodies(trio, case):
    (wire, total) = next((w, t) for name, w, t in _oversized_cases() if name == case)
    a = assert_identical(trio, wire, 1)
    assert a[0][0] == "HTTP/1.1 413 Request Entity Too Large"
    assert a[0][2] == (
        f"Maximum request body size 8388608 exceeded, actual body size {total}"
    ).encode()


def test_chunked_valid_body(trio):
    body = json.dumps(pod_review_body(True)).encode()
    mid = len(body) // 2
    chunked = (
        b"POST /validate/pod-privileged HTTP/1.1\r\nHost: t\r\n"
        b"Transfer-Encoding: chunked\r\nConnection: close\r\n\r\n"
        + hex(mid)[2:].encode() + b"\r\n" + body[:mid] + b"\r\n"
        + hex(len(body) - mid)[2:].encode() + b"\r\n" + body[mid:]
        + b"\r\n0\r\n\r\n"
    )
    a = assert_identical(trio, chunked, 1)
    assert a[0][0] == "HTTP/1.1 200 OK"
    assert json.loads(a[0][2])["response"]["allowed"] is False


def test_expect_100_continue(trio):
    body = json.dumps(pod_review_body(False)).encode()
    a = assert_identical(
        trio,
        post_bytes(
            "/validate/pod-privileged", body, extra="Expect: 100-continue\r\n"
        ),
        2,
    )
    assert a[0][0].endswith("100 Continue")
    assert a[1][0] == "HTTP/1.1 200 OK"


UNICODE_DOC = {
    "apiVersion": "admission.k8s.io/v1",
    "kind": "AdmissionReview",
    "request": {
        "unknownKey": {"deep": [1, 2, {"x": "y"}]},
        "uid": "uid-üñí-😀",
        "operation": "CREATE",
        "name": None,
        "namespace": "späce",
        "requestKind": {"version": "v1", "kind": "Pod", "junk": 1},
        "userInfo": {},
        "dryRun": False,
        "object": {
            "metadata": {
                "labels": {"app": "ünïcode- -😀", "tab": "a\tb"},
                "annotations": {"empty": "", "ctl": "\x01\x7f"},
            },
            "spec": {
                "containers": [
                    {"name": "c", "securityContext": {"privileged": True}}
                ]
            },
        },
    },
}


def test_canonicalization_parity_unicode_and_shapes(trio):
    a = assert_identical(
        trio,
        post_bytes("/validate/pod-privileged", json.dumps(UNICODE_DOC).encode()),
        1,
    )
    assert a[0][0] == "HTTP/1.1 200 OK"
    resp = json.loads(a[0][2])["response"]
    assert resp["allowed"] is False and resp["uid"] == "uid-üñí-😀"


def _fallback_bodies() -> dict[str, bytes]:
    deep_obj: dict = {"leaf": 1}
    for _ in range(120):
        deep_obj = {"n": deep_obj}
    return {
        "float": review(obj={"spec": {"weight": 0.25, "big": 1e30}}),
        "duplicate-key": (
            b'{"request": {"uid": "u1", "object": {"a": 1, "a": 2}, '
            b'"operation": "CREATE"}}'
        ),
        "deep": review(obj=deep_obj),
        "nan": b'{"request": {"uid": "u2", "object": {"v": NaN}}}',
    }


@pytest.mark.parametrize("shape", ["float", "duplicate-key", "deep", "nan"])
def test_python_fallback_shapes_still_bit_exact(trio, shape):
    """What the C++ parser declines goes to the Python parse oracle."""
    _jax, port_native, _ = trio
    before = port_native.native_frontend.stats()["parse_fallbacks"]
    a = assert_identical(
        trio, post_bytes("/validate/pod-privileged", _fallback_bodies()[shape]), 1
    )
    assert a[0][0] == "HTTP/1.1 200 OK", a[0][2]
    assert port_native.native_frontend.stats()["parse_fallbacks"] == before + 1


def test_canonical_expansion_overflow_falls_back(trio):
    """A body under the cap whose escaped canonical form is over it ships
    raw to the Python oracle."""
    doc = json.loads(review())
    doc["request"]["object"] = {"notes": "😀" * (1024 * 1024)}
    body = json.dumps(doc, ensure_ascii=False).encode()
    assert len(body) < 8 * 1024**2
    _jax, port_native, _ = trio
    before = port_native.native_frontend.stats()["parse_fallbacks"]
    a = assert_identical(trio, post_bytes("/validate/pod-privileged", body), 1)
    assert a[0][0] == "HTTP/1.1 200 OK"
    assert port_native.native_frontend.stats()["parse_fallbacks"] > before


@pytest.mark.parametrize(
    "path,body,status",
    [
        ("/validate_raw/raw-mutation", b"steak", 422),
        ("/validate_raw/raw-mutation", b'{"nope": 1}', 422),
        ("/validate_raw/raw-mutation", b'{"request": []}', 200),
        ("/validate_raw/raw-mutation",
         json.dumps({"request": {"uid": "raw-1", "user": "x"}}).encode(), 200),
        ("/audit/pod-privileged", json.dumps(pod_review_body(True)).encode(), 200),
        ("/audit/mutate-denied", json.dumps(pod_review_body(False)).encode(), 200),
        ("/audit/pod-privileged", b"{", 422),
    ],
)
def test_validate_raw_and_audit_parity(trio, path, body, status):
    a = assert_identical(trio, post_bytes(path, body), 1)
    assert a[0][0].split(" ")[1] == str(status), a


def test_mid_body_disconnect_leaves_server_serving(trio):
    jax_server, port_native, _ = trio
    for port in (jax_server.port, port_native.port):
        s = socket.create_connection(("127.0.0.1", port), timeout=SOCKET_TIMEOUT)
        s.sendall(
            b"POST /validate/pod-privileged HTTP/1.1\r\nHost: t\r\n"
            b"Content-Length: 5000\r\n\r\npartial-body-then-gone"
        )
        s.close()
    time.sleep(0.2)
    body = json.dumps(pod_review_body(False)).encode()
    a = assert_identical(trio, post_bytes("/validate/pod-privileged", body), 1)
    assert a[0][0] == "HTTP/1.1 200 OK"


@pytest.mark.parametrize(
    "wire",
    [
        b"BLARGH\r\n\r\n",
        # duplicate Content-Length, and Content-Length with chunked: the
        # request-smuggling vectors
        b"POST /validate/pod-privileged HTTP/1.1\r\nHost: t\r\n"
        b"Content-Length: 2\r\nContent-Length: 5\r\n"
        b"Connection: close\r\n\r\n{}",
        b"POST /validate/pod-privileged HTTP/1.1\r\nHost: t\r\n"
        b"Content-Length: 7\r\nTransfer-Encoding: chunked\r\n"
        b"Connection: close\r\n\r\n2\r\n{}\r\n0\r\n\r\n",
    ],
)
def test_bad_request_lines_and_smuggling_vectors_400(trio, wire):
    a = assert_identical(trio, wire, 1)
    assert a[0][0] == "HTTP/1.1 400 Bad Request", a


@pytest.mark.parametrize(
    "target", [b"/validate/\xff", b"/audit/pod-\xc3(", b"/validate/\xff/x"]
)
def test_non_utf8_policy_id_is_answered_and_the_drainer_lives(trio, target):
    """The C++ router passes the raw request target through as the policy
    id: bytes that are not UTF-8 get an in-band 404, the requests around
    them on the same connection are served, and a later connection is
    served too. (The JAX package's drainer dies here and relies on its
    watchdog, so this holds the port alone, against its stdlib frontend.)"""
    _jax, port_native, port_stdlib = trio
    good = json.dumps(pod_review_body(False)).encode()
    bad = post_bytes("/x", good, close=False).replace(b"/x", target, 1)
    wire = (
        post_bytes("/validate/pod-privileged", good, close=False)
        + bad
        + post_bytes("/validate/pod-privileged", good)
    )
    got = exchange(port_native.port, wire)
    want = exchange(port_stdlib.port, wire)
    assert [st for st, _h, _b in got] == [
        "HTTP/1.1 200 OK", "HTTP/1.1 404 Not Found", "HTTP/1.1 200 OK"
    ], got
    assert [st.split(" ")[1] for st, _h, _b in got] == [
        st.split(" ")[1] for st, _h, _b in want
    ]
    assert got[0][2] == got[2][2] == want[0][2]
    after = exchange(
        port_native.port, post_bytes("/validate/pod-privileged", good)
    )
    assert after == got[2:]


def test_intake_failpoint_answers_every_request_500(trio):
    """A fault at the drainer's intake (``frontend.accept``) answers the
    burst in-band, as the JAX package's does."""
    from policy_server_tpu import failpoints as jax_failpoints

    body = json.dumps(pod_review_body(False)).encode()
    wire = post_bytes("/validate/pod-privileged", body)
    jax_server, port_native, _ = trio
    jax_failpoints.configure("frontend.accept=raise:intake*1")
    failpoints.configure("frontend.accept=raise:intake*1")
    try:
        want = exchange(jax_server.port, wire)
        got = exchange(port_native.port, wire)
    finally:
        jax_failpoints.reset()
        failpoints.reset()
    assert got == want
    assert got[0][0] == "HTTP/1.1 500 Internal Server Error"
    assert json.loads(got[0][2]) == {"message": "Something went wrong", "status": 500}


# -- the port's two frontends, and the canonical bytes ----------------------


def test_native_and_stdlib_frontends_agree_on_the_corpus(trio):
    """Status and body of every corpus request, the port's native
    frontend against its standard-library frontend."""
    _jax, port_native, port_stdlib = trio
    work = corpus(13, "-pair")
    work += [("pod-privileged", b"{"), ("nope", work[0][1])]
    for route in ("validate", "audit"):
        want = exchange(port_stdlib.port, pipelined(work, route))
        got = exchange(port_native.port, pipelined(work, route))
        assert [(s, b) for s, _h, b in got] == [(s, b) for s, _h, b in want]
    assert len(got) == len(work)


class _CaptureSink:
    """Answers 200 and keeps every drained record."""

    def __init__(self, want: int = 1):
        self.records: list[tuple] = []
        self.bursts = 0
        self.want = want
        self.got = threading.Event()

    def handle_burst(self, frontend, burst):
        self.records.extend(burst)
        self.bursts += 1
        for rec in burst:
            frontend.complete(rec[0], 200, b'{"ok": true}')
        if len(self.records) >= self.want:
            self.got.set()


class _EchoSink:
    def handle_burst(self, frontend, burst):
        for rec in burst:
            frontend.complete(rec[0], 200, b'{"ok": true}')


class _GatedSink:
    """Blocks its first burst until released: the ring behind it fills."""

    def __init__(self):
        self.gate = threading.Event()

    def handle_burst(self, frontend, burst):
        self.gate.wait(timeout=30)
        for rec in burst:
            frontend.complete(rec[0], 200, b'{"ok": true}')


def mini_frontend(module, sink, **kw):
    sock = module.make_listen_socket("127.0.0.1", 0)
    port = sock.getsockname()[1]
    try:
        front = module.NativeFrontend(sock, sink, **kw).start()
    except BaseException:
        sock.close()
        raise
    return front, port


def test_canonical_bytes_equal_the_models_dump():
    """The C++ canonical ``request`` bytes equal ``json.dumps(
    AdmissionRequest.to_dict(), separators=(",", ":"))`` of the port's
    model, and the header fields equal its attributes, over the catalog's
    reviews and the Unicode shapes: the blob tier and the native encoder
    read these bytes."""
    docs = catalog_docs(28, 3) + [UNICODE_DOC, json.loads(review())]
    sink = _CaptureSink(want=len(docs))
    front, port = mini_frontend(nf, sink)
    try:
        wire = b"".join(
            post_bytes("/validate/p", json.dumps(d).encode(),
                       close=i == len(docs) - 1)
            for i, d in enumerate(docs)
        )
        send_raw(port, wire)
        assert sink.got.wait(timeout=SOCKET_TIMEOUT)
    finally:
        front.shutdown(timeout=5)
    assert len(sink.records) == len(docs)
    for rec, d in zip(sink.records, docs):
        (_rid, kind, policy, uid, ns, op, gvk, payload) = rec[:8]
        adm = AdmissionReviewRequest.from_dict(d).request
        assert kind == nf.K_VALIDATE and policy == "p"
        assert payload == json.dumps(
            adm.to_dict(), separators=(",", ":")
        ).encode()
        assert (uid, ns, op, gvk or None) == (
            adm.uid, adm.namespace, adm.operation,
            adm.request_kind.kind if adm.request_kind else None,
        )


def test_server_header_is_the_stdlib_frontends():
    from http.server import BaseHTTPRequestHandler

    from policy_server_tpu_torch.api.handlers import ApiHandler

    assert PORT_SERVER_HEADER() == ApiHandler.version_string(
        BaseHTTPRequestHandler.__new__(ApiHandler)
    )


def test_concurrent_pipelined_clients_each_get_their_own_answers(trio):
    """Eight connections pipelining at once, with a short thread switch
    interval so the pipeline workers' ``deliver_many`` calls interleave:
    every connection gets its own requests' bodies, in order, equal to
    the standard-library frontend's."""
    import sys

    _jax, port_native, port_stdlib = trio
    streams = [corpus(100 + c, f"-c{c}")[:16] for c in range(8)]
    want = [
        [(s, b) for s, _h, b in exchange(port_stdlib.port, pipelined(w))]
        for w in streams
    ]
    got: list = [None] * len(streams)
    errors: list = []

    def client(c: int) -> None:
        try:
            got[c] = [
                (s, b) for s, _h, b in
                exchange(port_native.port, pipelined(streams[c]))
            ]
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert got == want


# -- the connection-abuse cases (mini frontends, both packages) -------------


def _ring_full_run(module) -> tuple[list, int]:
    """600 pipelined requests behind a wedged drainer and a 256-slot
    ring → (responses, ring-full rejections counted)."""
    sink = _GatedSink()
    front, port = mini_frontend(module, sink, ring_bits=8)
    s = socket.create_connection(("127.0.0.1", port), timeout=20)
    try:
        s.sendall(post_bytes("/validate/p", b"{}", close=False))
        time.sleep(0.3)  # the drainer is now blocked in the sink
        s.sendall(
            b"".join(post_bytes("/validate/p", b"{}", close=False)
                     for _ in range(600))
        )
        deadline = time.time() + 10
        while time.time() < deadline and not front.stats()["ring_full_rejections"]:
            time.sleep(0.05)
        sink.gate.set()
        stream = b""
        try:
            while stream.count(b"HTTP/1.1 ") < 601:
                chunk = s.recv(1 << 20)
                if not chunk:
                    break
                stream += chunk
        except socket.timeout:
            pass
        return normalize(parse_responses(stream)), front.stats()[
            "ring_full_rejections"
        ]
    finally:
        sink.gate.set()
        s.close()
        front.shutdown(timeout=5)


def test_ring_full_answers_inband_503(same_server_header):
    """With the drainer wedged, a flood past the ring answers in-band
    503s (counted) from the event loop, and the release answers every
    admitted request: the same shapes from both packages."""
    shapes = {}
    for name, module in (("jax", jnf), ("port", nf)):
        resps, rejected = _ring_full_run(module)
        assert len(resps) == 601
        codes = [st.split(" ")[1] for st, _h, _b in resps]
        assert rejected > 0 and codes.count("503") == rejected
        assert codes.count("200") == 601 - rejected
        shapes[name] = sorted(
            {(st, tuple(sorted(h.items())), b) for st, h, b in resps}
        )
    assert shapes["port"] == shapes["jax"]
    assert len(shapes["port"]) == 2  # one 200 and one 503 shape


def _reaped(sock_, drip: bool) -> bool:
    deadline = time.time() + 8
    while time.time() < deadline:
        try:
            if drip:
                sock_.sendall(b"X")
            sock_.settimeout(0.3)
            try:
                if sock_.recv(4096) == b"":
                    return True
            except socket.timeout:
                pass
        except OSError:
            return True
        time.sleep(0.2)
    return False


def test_read_timeout_reaps_slowloris_and_idle_conns():
    front, port = mini_frontend(
        nf, _EchoSink(), read_timeout_ms=1000, idle_timeout_ms=2500
    )
    conns = []
    try:
        slow = socket.create_connection(("127.0.0.1", port), timeout=10)
        conns.append(slow)
        slow.sendall(b"POST /validate/p HTTP/1.1\r\n")
        idle = socket.create_connection(("127.0.0.1", port), timeout=10)
        conns.append(idle)
        idle.sendall(post_bytes("/validate/p", b"{}", close=False))
        assert b" 200 " in idle.recv(65536)
        assert _reaped(slow, drip=True), "slowloris conn never reaped"
        assert _reaped(idle, drip=False), "idle conn never reaped"
        assert front.stats()["idle_timeout_closes"] >= 2
        ok = socket.create_connection(("127.0.0.1", port), timeout=10)
        conns.append(ok)
        ok.sendall(post_bytes("/validate/p", b"{}"))
        assert b" 200 " in ok.recv(65536)
    finally:
        for c in conns:
            c.close()
        front.shutdown(timeout=5)


def test_continuous_pipelining_outlives_read_timeout():
    """The read-timeout clock runs per request: a client pipelining for
    3.5x the read timeout, its buffer always ending mid-request, is never
    reaped."""
    front, port = mini_frontend(
        nf, _EchoSink(), read_timeout_ms=700, idle_timeout_ms=60_000
    )
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        one = post_bytes("/validate/p", b"{}", close=False)
        head, tail = one[: len(one) // 2], one[len(one) // 2 :]
        s.sendall(one + head)
        sent = 1
        stream = b""
        deadline = time.time() + 2.5
        while time.time() < deadline:
            while stream.count(b"HTTP/1.1 ") < sent:
                chunk = s.recv(1 << 16)
                assert chunk, "server closed a continuously pipelining conn"
                stream += chunk
            s.sendall(tail + one + head)
            sent += 2
            time.sleep(0.05)
        s.sendall(tail)
        while stream.count(b"HTTP/1.1 ") < sent:
            chunk = s.recv(1 << 16)
            assert chunk, "server closed the conn on the final drain"
            stream += chunk
        resps = parse_responses(stream)
        assert len(resps) == sent and sent >= 20
        assert all(" 200 " in st for st, _h, _b in resps)
        assert front.stats()["idle_timeout_closes"] == 0
    finally:
        s.close()
        front.shutdown(timeout=5)


def _connection_cap_run(module) -> tuple[list, int]:
    front, port = mini_frontend(module, _EchoSink(), max_connections=2)
    held = []
    try:
        held = [
            socket.create_connection(("127.0.0.1", port), timeout=10)
            for _ in range(2)
        ]
        time.sleep(0.3)  # both registered by the event loop
        over = socket.create_connection(("127.0.0.1", port), timeout=10)
        held.append(over)
        data = b""
        while True:
            try:
                chunk = over.recv(65536)
            except socket.timeout:
                break
            if not chunk:
                break
            data += chunk
        rejected = front.stats()["conn_cap_rejections"]
        # capacity frees as a held connection closes
        held[0].close()
        time.sleep(1.2)
        again = socket.create_connection(("127.0.0.1", port), timeout=10)
        held.append(again)
        again.sendall(post_bytes("/validate/p", b"{}"))
        assert b" 200 " in again.recv(65536)
        return normalize(parse_responses(data)), rejected
    finally:
        for c in held:
            c.close()
        front.shutdown(timeout=5)


def test_connection_cap_rejects_inband_503(same_server_header):
    want, want_n = _connection_cap_run(jnf)
    got, got_n = _connection_cap_run(nf)
    assert got == want and got_n == want_n == 1
    assert got[0][0] == "HTTP/1.1 503 Service Unavailable"
    assert b"connection limit reached" in got[0][2]
    assert "retry-after" in got[0][1]


def test_record_timestamps_cross_the_ring():
    """Each record carries CLOCK_MONOTONIC stamps (received, pushed) on
    perf_counter_ns's timebase; the drainer records the native accept,
    parse and ring-cross phases, and the server's sink admit and
    native_serialize, one stamp site each."""
    installed = flightrec.recorder()
    rec = flightrec.install(flightrec.FlightRecorder(capacity=1024))
    sink = _CaptureSink()
    front, port = mini_frontend(nf, sink)
    try:
        body = review()
        t_before = time.perf_counter_ns()
        send_raw(port, post_bytes("/validate/priv", body))
        assert sink.got.wait(timeout=SOCKET_TIMEOUT)
        t_after = time.perf_counter_ns()
    finally:
        front.shutdown(timeout=5)
        flightrec.install(installed)
    (record,) = sink.records
    _tf, t_parse, t_push = record[9], record[10], record[11]
    assert t_before < t_parse <= t_push < t_after
    phases = {e["phase"] for e in rec.snapshot()}
    assert {
        flightrec.PH_NATIVE_ACCEPT, flightrec.PH_NATIVE_PARSE,
        flightrec.PH_RING_CROSS,
    } <= phases
    assert all(e["end_ns"] >= e["start_ns"] for e in rec.snapshot())


def test_served_burst_stamps_admit_and_native_serialize(trio):
    _jax, port_native, _ = trio
    rec = flightrec.recorder()
    assert rec is not None
    cursor = rec.events_recorded()
    work = corpus(17, "-stamps")[:8]
    assert len(exchange(port_native.port, pipelined(work))) == len(work)
    phases = {e["phase"] for e in rec.snapshot() if e["seq"] >= cursor}
    assert {
        flightrec.PH_NATIVE_ACCEPT, flightrec.PH_NATIVE_PARSE,
        flightrec.PH_RING_CROSS, flightrec.PH_ADMIT,
        flightrec.PH_NATIVE_SERIALIZE, flightrec.PH_DISPATCH,
    } <= phases


# -- /metrics ----------------------------------------------------------------


def _families(port: int) -> dict[str, float]:
    text = send_raw(
        port, b"GET /metrics HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n"
    )
    body = parse_responses(text)[0][2].decode()
    out = {}
    for fam in text_string_to_metric_families(body):
        for sample in fam.samples:
            if not sample.labels:
                out[sample.name] = sample.value
    return out


def _metric(fams: dict, name: str) -> float:
    return fams.get(name, fams.get(name + "_total"))


def test_native_metrics_families_equal_the_jax_packages(trio):
    """The same traffic (verdicts, a fallback, a route miss, a 422), one
    request per connection so each is a burst of its own, moves every
    native family by the same amount on both servers."""
    jax_server, port_native, _ = trio
    wires = [
        post_bytes(f"/validate/{pid}", body)
        for pid, body in corpus(23, "-metrics")[:12]
    ] + [
        post_bytes("/validate/pod-privileged", _fallback_bodies()["float"]),
        post_bytes("/validate/pod-privileged", b"{"),
        post_bytes("/no/such/route", b"{}"),
    ]
    deltas = {}
    for name, srv in (("jax", jax_server), ("port", port_native)):
        before = _families(srv.readiness_port)
        for wire in wires:
            exchange(srv.port, wire)
        time.sleep(0.2)  # the last completions flush on the loops' tick
        after = _families(srv.readiness_port)
        deltas[name] = {
            fam: _metric(after, fam) - _metric(before, fam)
            for fam in NATIVE_FAMILIES
        }
        for fam in NATIVE_TIME_FAMILIES:
            assert _metric(after, fam) >= _metric(before, fam) >= 0, fam
    assert deltas["port"] == deltas["jax"]
    assert deltas["port"][t_metrics.NATIVE_HTTP_REQUESTS] == len(wires)
    assert deltas["port"][t_metrics.NATIVE_PARSE_FALLBACKS] == 2
    assert deltas["port"][t_metrics.BULK_SUBMITS] == 12


def test_native_families_read_zero_under_the_stdlib_frontend():
    server = port_server(frontend="python")
    try:
        fams = _families(server.readiness_port)
    finally:
        server.stop()
    for fam in NATIVE_FAMILIES[:8]:
        assert _metric(fams, fam) == 0, fam


# -- the record packers against the JAX package's ---------------------------


@pytest.fixture(scope="module")
def catalog_pair():
    specs = catalog_specs()
    return jax_env(specs), torch_env(specs)


@pytest.mark.parametrize("seed", [31, 77])
def test_packers_byte_equal_over_the_family_catalog(catalog_pair, seed):
    """pack_verdict_record and render_verdict_bytes, port against JAX, on
    the same reviews' verdicts in both envelopes; the render equals the
    Python responder's bytes."""
    jenv, tenv = catalog_pair
    items = items_for(catalog_docs(40, seed), sorted(catalog_specs()), seed)
    jres = jenv.validate_batch([(p, j) for p, j, _t in items])
    tres = tenv.validate_batch([(p, t) for p, _j, t in items])
    rendered = 0
    for j, t in zip(jres, tres):
        if isinstance(j, Exception):
            assert repr(j) == repr(t)
            continue
        for raw_shape in (False, True):
            want = jnf.pack_verdict_record(7, j, raw_shape)
            got = nf.pack_verdict_record(7, t, raw_shape)
            assert got == want and got is not None, t.to_dict()
            assert nf.render_verdict_bytes(got) == jnf.render_verdict_bytes(want)
            assert nf.render_verdict_bytes(got) == nf._python_body(t, raw_shape)
        rendered += 1
    assert rendered > len(catalog_specs())


def test_packers_on_the_mutation_and_constraint_paths(catalog_pair):
    """The audit-against-validate constraint fork on a mutating policy:
    both post-constraint responses pack and render as the JAX package's."""
    jenv, tenv = catalog_pair
    items = items_for(catalog_docs(40, 5), ["psp-capabilities"], 5)
    saw_patch = False
    for (pid, j, t), jv, tv in zip(
        items,
        jenv.validate_batch([(p, j) for p, j, _t in items]),
        tenv.validate_batch([(p, t) for p, _j, t in items]),
    ):
        saw_patch = saw_patch or tv.patch is not None
        for jo, to in (
            (jax_service.RequestOrigin.VALIDATE, t_service.RequestOrigin.VALIDATE),
            (jax_service.RequestOrigin.AUDIT, t_service.RequestOrigin.AUDIT),
        ):
            jr = jax_service.post_evaluate(jenv, pid, j, jo, jv, 0.0, now=0.0)
            tr = t_service.post_evaluate(tenv, pid, t, to, tv, 0.0, now=0.0)
            want = jnf.pack_verdict_record(3, jr, False)
            got = nf.pack_verdict_record(3, tr, False)
            assert got == want and got is not None
            assert nf.render_verdict_bytes(got) == nf._python_body(tr, False)
    assert saw_patch


def _templates(T):
    return [
        T(True),
        T(False, code=400, message="nope"),
        T(False, code=None, message="ünï 😀"),
        T(False, code=403, message="group", causes=(("a", "x"), (None, "y"))),
        T(False, code=-3, message="negative"),
    ]


def test_fragment_records_byte_equal():
    """Cache-hit fragments: uid + template tail, port against JAX, and the
    template's memoized tail reused on the second pack."""
    jt = _templates(JFragTemplate)
    tt = _templates(FragTemplate)
    for uid in ("u-1", "ü-😀", "bad-\ud800"):
        for j, t in zip(jt, tt):
            for raw_shape in (False, True):
                want = jnf.pack_frag_record(9, JFragVerdict(uid, j), raw_shape)
                got = nf.pack_frag_record(9, FragVerdict(uid, t), raw_shape)
                assert got == want
                if got is not None:
                    assert nf.render_verdict_bytes(got) == nf._python_body(
                        FragVerdict(uid, t), raw_shape
                    )


def _shapes(R, S, D, C):
    return [
        R(uid="a", allowed=True, warnings=["w1", "wü"]),
        R(uid="b", allowed=False, status=S(message="m", code=401, reason="Why",
                                            details=D(causes=(C(field="f", message="x"),)))),
        R(uid="c", allowed=True, patch_type="JSONPatch", patch="W10="),
        R(uid="d", allowed=True, patch="W10="),  # patch without a type
        R(uid="e", allowed=False, status=S(message="m", code=2**31)),
        R(uid="f", allowed=True, warnings=["w"] * 256),
        R(uid="g\ud800", allowed=True),
        R(uid="h", allowed=True, audit_annotations={"k": "v"}),
        R(uid="i", allowed=False, status=S(message=None, code=None)),
    ]


def test_synthetic_shapes_pack_as_the_jax_package_does():
    """Every natively classified field shape, and the Python-only tail
    (None from both packers)."""
    want = _shapes(JAdmissionResponse, JValidationStatus, JStatusDetails, JStatusCause)
    got = _shapes(AdmissionResponse, ValidationStatus, StatusDetails, StatusCause)
    n_native = 0
    for j, t in zip(want, got):
        w = jnf.pack_verdict_record(1, j, False)
        g = nf.pack_verdict_record(1, t, False)
        assert g == w, t
        if g is not None:
            n_native += 1
            assert nf.render_verdict_bytes(g) == nf._python_body(t, False)
    assert n_native == 4


def test_response_field_classification_is_total():
    fields = set(AdmissionResponse.__dataclass_fields__)
    assert nf.NATIVE_RESPONSE_FIELDS | nf.PYTHON_ONLY_RESPONSE_FIELDS == fields
    assert not nf.NATIVE_RESPONSE_FIELDS & nf.PYTHON_ONLY_RESPONSE_FIELDS
    status = set(ValidationStatus.__dataclass_fields__)
    assert nf.NATIVE_STATUS_FIELDS | nf.PYTHON_ONLY_STATUS_FIELDS == status


# -- the batcher's batch-granular completion ---------------------------------


class _RecordingSink:
    def __init__(self):
        self.calls: list[list] = []
        self.lock = threading.Lock()
        self.done = threading.Event()
        self.expected = 0

    def deliver_many(self, items):
        with self.lock:
            self.calls.append(list(items))
            if sum(len(c) for c in self.calls) >= self.expected:
                self.done.set()


def _bursts(items, sizes):
    out, i = [], 0
    for n in sizes:
        out.append(items[i : i + n])
        i += n
    return out


@pytest.mark.parametrize("host_fastpath_threshold", [64, 0])
def test_submit_many_sink_delivers_once_per_batch(host_fastpath_threshold):
    """Sink rows get no Future; each dispatched batch answers its rows in
    one ``deliver_many`` call, every token exactly once, with the
    responses ``submit`` gives; the bulk counters equal the JAX batcher's
    on the same bursts."""
    specs = {k: SPECS[k] for k in ("pod-privileged", "priv-monitor", "group",
                                   "trusted-repos")}
    tenv = torch_env(specs)
    jenv = jax_env(specs)
    items = items_for(catalog_docs(36, 9), sorted(specs), 9)
    sizes = [1, 7, 16, 9, 7]
    kw = dict(max_batch_size=16, batch_timeout_ms=20.0,
              host_fastpath_threshold=host_fastpath_threshold,
              latency_budget_ms=0)
    tb = MicroBatcher(tenv, **kw).start()
    jb = JaxBatcher(jenv, **kw).start()
    sink = _RecordingSink()
    try:
        sink.expected = sum(sizes)
        tokens = iter(range(sum(sizes)))
        for burst in _bursts(items, sizes):
            assert tb.submit_many(
                [(p, t) for p, _j, t in burst], t_service.RequestOrigin.VALIDATE,
                sink=sink, tokens=[next(tokens) for _ in burst],
            ) is None
            jb.submit_many(
                [(p, j) for p, j, _t in burst], jax_service.RequestOrigin.VALIDATE,
                sink=_RecordingSink(), tokens=list(range(len(burst))),
            )
        assert sink.done.wait(timeout=60)
        want = [tb.submit(p, t).result(timeout=60) for p, _j, t in items]
        time.sleep(0.1)
        tstats, jstats = tb.stats_snapshot(), jb.stats_snapshot()
    finally:
        tb.shutdown()
        jb.shutdown()
    delivered = [tok for call in sink.calls for tok, _r, _e in call]
    assert sorted(delivered) == list(range(sum(sizes)))
    assert len(sink.calls) <= tstats["batches_dispatched"] - len(items)
    responses = {tok: r for call in sink.calls for tok, r, e in call if e is None}
    for tok, w in enumerate(want):
        r = responses[tok]
        assert (r.to_response() if isinstance(r, FragVerdict) else r).to_dict() == (
            w.to_response() if isinstance(w, FragVerdict) else w
        ).to_dict()
    assert (tstats["bulk_submits"], tstats["bulk_submitted_rows"]) == (
        len(sizes), sum(sizes)
    ) == (jstats["bulk_submits"], jstats["bulk_submitted_rows"])


def test_a_broken_sink_never_takes_the_batch_down():
    class Broken:
        def deliver_many(self, items):
            raise RuntimeError("sink fault")

    tenv = torch_env({"pod-privileged": SPECS["pod-privileged"]})
    b = MicroBatcher(tenv, max_batch_size=8).start()
    try:
        (pid, _j, t), = items_for(catalog_docs(1, 4)[:1], ["pod-privileged"], 4)
        b.submit_many([(pid, t)], sink=Broken(), tokens=[0])
        # the worker survives: later requests still answer
        assert b.submit(pid, t).result(timeout=30).uid == t.uid()
    finally:
        b.shutdown()


def test_sink_rows_answer_once_when_the_batch_fails(monkeypatch):
    tenv = torch_env({"pod-privileged": SPECS["pod-privileged"]})
    b = MicroBatcher(tenv, max_batch_size=8, host_fastpath_threshold=0,
                     latency_budget_ms=0).start()
    sink = _RecordingSink()
    sink.expected = 3
    monkeypatch.setattr(b, "_evaluate_runnable",
                        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("x")))
    try:
        items = items_for(catalog_docs(3, 8)[:3], ["pod-privileged"], 8)
        b.submit_many([(p, t) for p, _j, t in items], sink=sink,
                      tokens=[0, 1, 2])
        assert sink.done.wait(timeout=30)
        time.sleep(0.1)
    finally:
        b.shutdown()
    delivered = [(tok, type(e).__name__) for c in sink.calls for tok, _r, e in c]
    assert sorted(delivered) == [(0, "RuntimeError"), (1, "RuntimeError"),
                                 (2, "RuntimeError")]


# -- start-up, shutdown and failures -----------------------------------------


def test_failed_build_raises_under_frontend_native(tmp_path, monkeypatch):
    """No fallback: a g++ that fails stops the server's construction, and
    the batcher and recorder it had started are closed."""
    monkeypatch.setattr(nf, "_library", None)
    monkeypatch.setattr(buildcache, "_build_dir", tmp_path / "build")
    monkeypatch.setattr(nf, "GXX", "false")
    with pytest.raises(RuntimeError, match="false failed"):
        PolicyServer(_port_policies(), port=0, readiness_probe_port=0,
                     device="cpu", max_batch_size=4, frontend="native")
    assert flightrec.recorder() is None
    assert not nf.native_available()


def test_bind_failure_raises_under_frontend_native():
    taken = socket.socket()
    try:
        taken.bind(("127.0.0.1", 0))
        taken.listen(1)
        with pytest.raises(OSError):
            PolicyServer(_port_policies(), port=taken.getsockname()[1],
                         readiness_probe_port=0, device="cpu", max_batch_size=4,
                         frontend="native")
    finally:
        taken.close()
    assert flightrec.recorder() is None


def test_second_native_server_on_a_held_port_raises():
    """No SO_REUSEPORT: a second native server cannot bind the port a
    native server holds, so the kernel never splits connections between
    them."""
    first = port_server(frontend="native", max_batch_size=4)
    try:
        with pytest.raises(OSError):
            PolicyServer(_port_policies(), port=first.port,
                         readiness_probe_port=0, device="cpu",
                         max_batch_size=4, frontend="native")
        body = json.dumps(pod_review_body(False)).encode()
        a = exchange(first.port, post_bytes("/validate/pod-privileged", body))
        assert a[0][0] == "HTTP/1.1 200 OK", a
    finally:
        first.stop()


def test_stop_drains_and_frees_the_native_frontend():
    server = port_server(frontend="native", max_batch_size=4)
    front = server.native_frontend
    try:
        work = corpus(2, "-stop")[:6]
        s = socket.create_connection(("127.0.0.1", server.port), timeout=SOCKET_TIMEOUT)
        s.sendall(pipelined(work))
    finally:
        server.stop()
    stream = b""
    try:
        while True:
            chunk = s.recv(1 << 20)
            if not chunk:
                break
            stream += chunk
    except (socket.timeout, ConnectionResetError):
        pass
    s.close()
    assert front.stats() == {k: 0 for k in nf._STAT_NAMES}  # freed
    assert front._drainer is None and server.native_frontend is None
    # what was answered before the stop is whole
    assert all(" 200 " in st for st, _h, _b in parse_responses(stream))


def test_flags_are_the_jax_packages():
    from policy_server_tpu.config.cli import build_cli as jax_cli

    from policy_server_tpu_torch.__main__ import build_cli

    ours = {a.dest: a for a in build_cli()._actions}
    theirs = {a.dest: a for a in jax_cli()._actions}
    for dest in ("frontend", "native_idle_timeout_seconds",
                 "native_read_timeout_seconds", "native_max_connections"):
        assert ours[dest].default == theirs[dest].default
        assert ours[dest].type == theirs[dest].type
        assert list(ours[dest].choices or ()) == list(theirs[dest].choices or ())
        assert ours[dest].option_strings == theirs[dest].option_strings


@pytest.mark.parametrize(
    "env,value,attr,want",
    [
        ("KUBEWARDEN_FRONTEND", "native", "frontend", "native"),
        ("KUBEWARDEN_NATIVE_IDLE_TIMEOUT_SECONDS", "5", "native_idle_timeout_seconds", 5.0),
        ("KUBEWARDEN_NATIVE_READ_TIMEOUT_SECONDS", "2.5", "native_read_timeout_seconds", 2.5),
        ("KUBEWARDEN_NATIVE_MAX_CONNECTIONS", "64", "native_max_connections", 64),
    ],
)
def test_environment_variables_set_the_native_flags(monkeypatch, env, value, attr, want):
    from policy_server_tpu_torch.__main__ import build_cli

    defaults = build_cli().parse_args([])
    monkeypatch.setenv(env, value)
    assert getattr(build_cli().parse_args([]), attr) == want != getattr(defaults, attr)


def test_server_from_args_serves_native(tmp_path):
    from policy_server_tpu_torch.__main__ import build_cli, server_from_args

    path = tmp_path / "policies.json"
    path.write_text(json.dumps({"pod-privileged": SPECS["pod-privileged"]}))
    args = build_cli().parse_args([
        "--policies", str(path), "--device", "cpu", "--port", "0",
        "--readiness-probe-port", "0", "--frontend", "native",
        "--native-max-connections", "8", "--native-read-timeout-seconds", "3",
        "--max-batch-size", "4",
    ])
    server = server_from_args(args)
    try:
        server.start()
        assert server.frontend == "native"
        a = exchange(server.port, post_bytes(
            "/validate/pod-privileged", json.dumps(pod_review_body(True)).encode()
        ))
        assert json.loads(a[0][2])["response"]["allowed"] is False
        r = exchange(server.readiness_port,
                     b"GET /readiness HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n")
        assert r[0][0].split(" ")[1] == "200"
    finally:
        server.stop()


def test_every_phase_has_exactly_one_stamp_site():
    """With the native frontend's stamps in, each of the flight recorder's
    phases but ``gc`` is recorded at exactly one ``record_phase`` call
    site of the package (the JAX package's one-site rule); ``gc`` only
    at the collector's hook."""
    import ast
    import pathlib

    import policy_server_tpu_torch as pkg

    by_name = {
        name: value for name, value in vars(flightrec).items()
        if name.startswith("PH_")
    }
    sites: dict[str, list] = {phase: [] for phase in flightrec.PHASES}
    for path in pathlib.Path(pkg.__path__[0]).rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "record_phase"
                and node.args
            ):
                continue
            arg = node.args[0]
            name = arg.attr if isinstance(arg, ast.Attribute) else getattr(arg, "id", None)
            if name in by_name:
                sites[by_name[name]].append(f"{path.name}:{node.lineno}")
    # ``gc`` has none: the collector's hook writes it (record_collection)
    assert {p: len(s) for p, s in sites.items()} == {
        **dict.fromkeys(flightrec.PHASES, 1), flightrec.PH_GC: 0
    }, sites
