"""ctypes bindings and runtime owner of the native HTTP frontend
(``policy_server_tpu_torch/csrc/httpfront.cpp``).

The native frontend moves HTTP framing off Python: epoll event loops on
native threads accept connections, parse HTTP/1.1 (keep-alive, chunked
bodies, pipelining), canonicalize AdmissionReview JSON into the exact
compact bytes ``json.dumps(AdmissionRequest.to_dict(), separators=(",",
":"))`` would produce, and serialize responses, all without the GIL.
Python's per-request work shrinks to: drain a burst of parsed records
from the loops' lock-free rings, admit the whole burst to the
micro-batcher in one ``submit_many(sink=...)`` call, and complete each
dispatched batch's verdicts with one native bulk call. Verdicts pack into
v2 records (:func:`pack_verdict_record`, the one packing path;
:func:`pack_frag_record` for cache-hit fragments) that the C++ side
renders byte-exactly; the Python-only tail (audit annotations, strings
utf-8 cannot encode) is rendered by Python.

Build: compiled at first use with ``g++ -O2 -shared -fPIC -std=c++17
-pthread ... -ldl`` into ``build/torch_kernels/torch_httpfront-<abi>.so``
beside the package, and reused while it is newer than the source. A failed
build or load raises with g++'s output: under ``--frontend native`` there
is no fallback to the standard-library frontend.

TLS: the library resolves libssl with ``dlopen`` at run time
(``tls_available``); :class:`NativeTlsManager` builds SSL_CTX generations
from ``certs.py``'s last good snapshots, swaps them on every rotation and
drives the ``tls.handshake`` failpoint. The handshakes run on the event
loop without the GIL, with their own counters in ``stats()``.

Prefork: a worker process (``runtime/frontend.py``) owns its own native
loop on the shared API port (``make_listen_socket(reuse_port=True)``) and
forwards its records over the evaluation bridge (:class:`BridgeSink`).
Nothing here imports torch at import time, so a worker boots without it.
"""

from __future__ import annotations

import ctypes
import fcntl
import json
import os
import socket
import struct
import subprocess
import sys
import sysconfig
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any

from policy_server_tpu_torch import failpoints
from policy_server_tpu_torch.api.api_error import api_error_body as _api_error_body
from policy_server_tpu_torch.api.api_error import ShedError, shed_answer
from policy_server_tpu_torch.api.http_common import (
    MAX_BODY_BYTES,
    BodyError,
    JsonHandler,
    parse_admission_review_bytes,
)
from policy_server_tpu_torch.models.admission import FragVerdict
from policy_server_tpu_torch.telemetry import flightrec
from policy_server_tpu_torch.telemetry.tracing import logger

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE_DIR / "csrc" / "httpfront.cpp"
BUILD_DIR = _PACKAGE_DIR.parent / "build" / "torch_kernels"
GXX = "g++"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
GXX_LIBS = ("-ldl",)

# record kinds (csrc/httpfront.cpp)
K_VALIDATE, K_AUDIT, K_RAW, K_VALIDATE_FB, K_AUDIT_FB = 0, 1, 2, 3, 4

# u32 total | u64 req_id | u8 kind | u8 flags | u16 policy/uid/ns/op/gvk/tp
# | u32 payload_len | i64 t_first/t_parse/t_push (flight-recorder stamps
# on CLOCK_MONOTONIC, the clock perf_counter_ns reads on Linux)
_REC = struct.Struct("<IQBB6HI3q")

# the C++ stats enum, in order
_STAT_NAMES = (
    "connections_accepted",
    "http_requests",
    "requests_parsed_native",
    "parse_fallbacks",
    "responses_native_serialized",
    "responses_python_serialized",
    "ring_full_rejections",
    "bad_requests",
    "route_misses",
    "oversized_rejections",
    "bytes_in",
    "bytes_out",
    "framing_ns",
    "inflight",
    "midbody_disconnects",
    "idle_timeout_closes",
    "conn_cap_rejections",
    "tls_connections",
    "tls_handshakes_ok",
    "tls_handshakes_failed",
    "tls_handshake_timeouts",
    "tls_handshake_disconnects",
    "tls_handshakes_fail_injected",
    "tls_clean_closes",
)

# slots handed to httpfront_stats as its cap (the C side writes
# min(cap, its count)); only the first len(_STAT_NAMES) are named
_STAT_SLOTS = 24


@dataclass
class FrontendLibrary:
    """The loaded frontend library and how it was built."""

    lib: ctypes.CDLL
    # the same library with the GIL held across calls: the completion
    # entry points are pure memory operations (a lock-free stack push),
    # and a release and reacquire of the GIL per call would cost more
    pylib: ctypes.PyDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date library was reused


_lib_lock = threading.Lock()
_library: FrontendLibrary | None = None  # guarded-by: _lib_lock


def library_path() -> Path:
    tag = sysconfig.get_config_var("SOABI") or (
        f"py{sys.version_info[0]}{sys.version_info[1]}"
    )
    return BUILD_DIR / f"torch_httpfront-{tag}.so"


def _build_library(force: bool = False) -> tuple[Path, float]:
    """g++ the source when its library is missing, older than the source,
    or ``force`` is set (atomically, under a file lock other processes
    building the same library wait on) → (library path, seconds in g++;
    0.0 when the library was reused). Raises with g++'s output."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".torch_httpfront.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if force:
            out.unlink(missing_ok=True)
        if out.exists() and out.stat().st_mtime >= SOURCE.stat().st_mtime:
            return out, 0.0
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [GXX, *GXX_FLAGS, str(SOURCE), "-o", str(tmp), *GXX_LIBS]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=300
            )
        except FileNotFoundError as e:
            raise RuntimeError(
                f"{GXX} not found: the native frontend is compiled from "
                f"{SOURCE} at first use"
            ) from e
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{GXX} failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
        return out, seconds


def build_library(force: bool = False) -> FrontendLibrary:
    """Build (when needed) and load the library and declare its entry
    points. Raises when the build or the load fails."""
    global _library
    with _lib_lock:
        if _library is not None and not force:
            return _library
        path, seconds = _build_library(force)
        lib = ctypes.CDLL(str(path))
        pylib = ctypes.PyDLL(str(path))
        lib.httpfront_create.restype = ctypes.c_void_p
        lib.httpfront_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.httpfront_configure.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.httpfront_set_static.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
        ]
        lib.httpfront_start.restype = ctypes.c_int
        lib.httpfront_start.argtypes = [ctypes.c_void_p]
        lib.httpfront_stop_accepting.argtypes = [ctypes.c_void_p]
        lib.httpfront_stop.argtypes = [ctypes.c_void_p]
        lib.httpfront_destroy.argtypes = [ctypes.c_void_p]
        lib.httpfront_poll.restype = ctypes.c_int64
        lib.httpfront_poll.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ]
        pylib.httpfront_complete.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int,
        ]
        pylib.httpfront_complete_verdict_bulk.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int64,
        ]
        pylib.httpfront_render_verdict.restype = ctypes.c_int64
        pylib.httpfront_render_verdict.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int64,
        ]
        pylib.httpfront_outstanding.restype = ctypes.c_int64
        pylib.httpfront_outstanding.argtypes = [ctypes.c_void_p]
        pylib.httpfront_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ]
        # TLS termination: the library resolves libssl with dlopen at run
        # time, so these entry points exist whether or not libssl loads
        # (tls_available says which)
        lib.httpfront_tls_available.restype = ctypes.c_int
        lib.httpfront_tls_error.restype = ctypes.c_char_p
        lib.httpfront_ktls_supported.restype = ctypes.c_int
        lib.httpfront_tls_ctx_create.restype = ctypes.c_void_p
        lib.httpfront_tls_ctx_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.httpfront_tls_ctx_free.argtypes = [ctypes.c_void_p]
        lib.httpfront_set_tls.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.httpfront_tls_configure.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.httpfront_tls_fail_handshakes.argtypes = [
            ctypes.c_void_p, ctypes.c_long,
        ]
        _library = FrontendLibrary(lib, pylib, path, seconds)
        return _library


def _load() -> FrontendLibrary:
    return build_library()


def native_available() -> bool:
    """True when the library builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def tls_available() -> bool:
    """True when the library's run-time ``dlopen`` of libssl and libcrypto
    resolved every symbol it needs. Raises when the library does not
    build or load."""
    return bool(_load().lib.httpfront_tls_available())


def tls_error() -> str:
    """Why native TLS is unavailable, or the last context build's error."""
    return (_load().lib.httpfront_tls_error() or b"").decode("utf-8", "replace")


def ktls_supported() -> bool:
    """Whether the loaded OpenSSL could hand records to kernel TLS after the
    handshake (reported, never acted on)."""
    return bool(_load().lib.httpfront_ktls_supported())


def tls_ctx_create(
    cert_pem: bytes, key_pem: bytes, ca_pem: bytes | None = None
) -> int:
    """One native SSL_CTX generation from PEM bytes (``ca_pem`` turns on
    client-certificate verification, as ``ssl.CERT_REQUIRED`` does) → an
    opaque handle. Raises with the native error text on failure."""
    handle = _load().lib.httpfront_tls_ctx_create(
        cert_pem, len(cert_pem), key_pem, len(key_pem),
        ca_pem, len(ca_pem) if ca_pem else 0,
    )
    if not handle:
        raise RuntimeError(f"native TLS context build failed: {tls_error()}")
    return handle


def tls_ctx_free(handle: int) -> None:
    if handle:
        _load().lib.httpfront_tls_ctx_free(handle)


def render_verdict_bytes(record: bytes) -> bytes | None:
    """Render one packed v2 verdict record through the same native emitter
    serving uses (``httpfront_render_verdict``). None when the record is
    malformed."""
    pylib = _load().pylib
    # worst-case escape expansion is 6x (\\uXXXX per char) plus the
    # fixed envelope
    cap = len(record) * 6 + 8192
    out = ctypes.create_string_buffer(cap)
    n = pylib.httpfront_render_verdict(record, len(record), out, cap)
    if n < 0:
        return None
    return ctypes.string_at(out, n)


def server_header() -> str:
    """The Server header the standard-library frontend sends
    (``BaseHTTPRequestHandler.version_string()`` of the API handler); the
    native frontend sends the same string."""
    return f"{JsonHandler.server_version} {JsonHandler.sys_version}"


def make_listen_socket(
    addr: str, port: int, backlog: int = 1024, reuse_port: bool = False
) -> socket.socket:
    """A bound, listening, non-blocking socket. SO_REUSEPORT only with
    ``reuse_port`` (prefork workers share the API port, and the kernel
    spreads the accepted connections over them): otherwise a second
    listener on the port (another server, or an old one still draining)
    must fail to bind."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if reuse_port:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s.bind((addr, port))
        s.listen(backlog)
        s.setblocking(False)
    except OSError:
        s.close()
        raise
    return s


class NativeFrontend:
    """Owns one native httpfront instance: the listen socket, its event
    loop thread, the drainer thread, and the completion calls. Bodies over
    ``api.http_common.MAX_BODY_BYTES`` answer 413, as on the standard-library
    frontend. The sink's ``handle_burst(frontend, burst)`` takes each
    drained burst of records."""

    _POLL_TIMEOUT_MS = 200

    # connection-abuse defaults: idle matches a 75 s keep-alive; the read
    # timeout bounds one request's arrival (header and body), which is
    # what defeats slowloris drips; the connection cap answers an in-band
    # 503 over it (0 = uncapped)
    IDLE_TIMEOUT_MS = 75_000
    READ_TIMEOUT_MS = 30_000
    MAX_CONNECTIONS = 0

    def __init__(
        self,
        sock: socket.socket,
        sink: Any,
        *,
        ring_bits: int = 12,
        idle_timeout_ms: int | None = None,
        read_timeout_ms: int | None = None,
        max_connections: int | None = None,
    ):
        library = _load()
        self._lib = library.lib
        self._pylib = library.pylib
        self._sock = sock
        self._sink = sink
        # the poll buffer holds the largest single record (a fallback
        # record carries the whole raw body); allocated here, before the
        # server's collection at start, not on the drainer's first cycle
        self._poll_cap = MAX_BODY_BYTES + 64 * 1024
        self._poll_buf = ctypes.create_string_buffer(self._poll_cap)
        self._lock = threading.Lock()
        # one event loop, as the JAX package's server runs
        handle = self._lib.httpfront_create(
            sock.fileno(), 1, MAX_BODY_BYTES, server_header().encode(),
            int(ring_bits),
        )
        if not handle:
            raise RuntimeError("httpfront_create failed")
        self._lib.httpfront_configure(
            handle,
            self.IDLE_TIMEOUT_MS if idle_timeout_ms is None
            else int(idle_timeout_ms),
            self.READ_TIMEOUT_MS if read_timeout_ms is None
            else int(read_timeout_ms),
            self.MAX_CONNECTIONS if max_connections is None
            else int(max_connections),
        )
        self._handle = handle  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        self._drainer: threading.Thread | None = None
        self._set_statics(handle)

    # -- static responses (404, 405, 413, ring-full 503, 400) ---------------

    def _set_statics(self, handle) -> None:
        text = b"text/plain; charset=utf-8"
        js = b"application/json; charset=utf-8"

        def set_static(slot, status, ct, body, extra=b""):
            self._lib.httpfront_set_static(
                handle, slot, status, ct, body, len(body), extra
            )

        set_static(0, 404, text, b"404: Not Found")
        set_static(1, 405, text, b"405: Method Not Allowed", b"Allow: POST\r\n")
        set_static(
            2, 413, text,
            (
                f"Maximum request body size {MAX_BODY_BYTES} exceeded, "
                "actual body size %lld"
            ).encode(),
        )
        set_static(
            3, 503, js,
            json.dumps({"message": "evaluation backend unavailable"}).encode(),
        )
        set_static(4, 400, text, b"Bad Request")

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "NativeFrontend":
        with self._lock:
            handle = self._handle
        if self._lib.httpfront_start(handle) != 0:
            raise RuntimeError("httpfront_start failed")
        self._drainer = threading.Thread(
            target=self._drain_loop, name="httpfront-drain", daemon=True
        )
        self._drainer.start()
        return self

    def stop_accepting(self) -> None:
        with self._lock:
            if self._closed or not self._handle:
                return
            self._lib.httpfront_stop_accepting(self._handle)

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop serving: wait for every in-flight request's completion to
        flush (the batcher's shutdown answered them before this is called),
        then stop the loops, join the drainer and free the instance."""
        with self._lock:
            if self._closed:
                return
            handle = self._handle
        deadline = time.monotonic() + timeout
        while (
            time.monotonic() < deadline
            and self._pylib.httpfront_outstanding(handle) > 0
        ):
            time.sleep(0.02)
        self._lib.httpfront_stop(handle)
        drainer_alive = False
        if self._drainer is not None:
            self._drainer.join(timeout=10)
            drainer_alive = self._drainer.is_alive()
            self._drainer = None
        with self._lock:
            self._closed = True
            self._handle = None
        if drainer_alive:
            # the drainer is stuck inside its sink: destroying the
            # instance it polls next would be a use after free
            logger.warning(
                "native frontend drainer did not exit within the stop "
                "deadline; leaking the native instance rather than "
                "freeing it under the thread"
            )
        else:
            self._lib.httpfront_destroy(handle)
        try:
            self._sock.close()
        except OSError:
            pass

    # -- TLS termination ----------------------------------------------------

    def set_tls(self, ctx_handle: int | None) -> None:
        """The SSL_CTX generation new connections shake hands under (the
        native side takes its own reference; the caller frees its handle
        with ``tls_ctx_free``). Established connections keep the generation
        they pinned at accept. None turns TLS off for new connections."""
        with self._lock:
            if self._closed or not self._handle:
                return
            self._lib.httpfront_set_tls(self._handle, ctx_handle or None)

    def configure_tls(self, handshake_timeout_ms: int) -> None:
        """The handshake's deadline, from accept, never refreshed by
        arriving bytes (the TLS-layer slowloris defense; 0 disables)."""
        with self._lock:
            if self._closed or not self._handle:
                return
            self._lib.httpfront_tls_configure(
                self._handle, int(handshake_timeout_ms)
            )

    def fail_tls_handshakes(self, n: int) -> None:
        """The ``tls.handshake`` failpoint's switch: fail the next ``n``
        handshakes (n > 0), every one (-1), or none (0)."""
        with self._lock:
            if self._closed or not self._handle:
                return
            self._lib.httpfront_tls_fail_handshakes(self._handle, int(n))

    # -- self-heal (supervision.SelfHealWatchdog) ---------------------------

    def drainer_wedged(self) -> bool:
        """True when the drain thread died while the frontend still serves:
        the native loops keep framing requests into the ring, and nothing
        moves them to the batcher."""
        with self._lock:
            closed = self._closed
        t = self._drainer
        return not closed and t is not None and not t.is_alive()

    def revive_drainer(self) -> bool:
        """Start a new drain thread in place of a dead one. The ring has one
        consumer: the old one is dead (``drainer_wedged``) before the new
        one starts."""
        if not self.drainer_wedged():
            return False
        self._drainer = threading.Thread(
            target=self._drain_loop, name="httpfront-drain-revived",
            daemon=True,
        )
        self._drainer.start()
        return True

    # -- completions (any thread) -------------------------------------------
    # Each takes the frontend lock, so no completion reaches an instance
    # that shutdown() has marked closed and is freeing.

    def complete(
        self, req_id: int, status: int, body: bytes, retry_after: int = 0
    ) -> None:
        with self._lock:
            if self._closed or not self._handle:
                return  # raced the shutdown: the socket is gone anyway
            self._pylib.httpfront_complete(
                self._handle, req_id, status, body, len(body),
                int(retry_after),
            )

    def complete_verdict_bulk(self, records: list[bytes]) -> None:
        """One dispatched batch's packed v2 verdict records: one lock
        acquisition and one native call push them all onto the completion
        stack; the C++ side renders each response."""
        buf = b"".join(records)
        with self._lock:
            if self._closed or not self._handle:
                return
            self._pylib.httpfront_complete_verdict_bulk(
                self._handle, buf, len(buf), len(records)
            )

    def complete_verdict_rec(self, record: bytes) -> None:
        """One packed v2 verdict record (the per-request path)."""
        self.complete_verdict_bulk([record])

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict[str, int]:
        out = (ctypes.c_int64 * _STAT_SLOTS)()
        with self._lock:
            if self._closed or not self._handle:
                return {name: 0 for name in _STAT_NAMES}
            self._pylib.httpfront_stats(
                self._handle,
                ctypes.cast(out, ctypes.POINTER(ctypes.c_int64)),
                _STAT_SLOTS,
            )
        return {name: int(out[i]) for i, name in enumerate(_STAT_NAMES)}

    # -- the drainer --------------------------------------------------------

    @staticmethod
    def _record_burst_phases(burst: list[tuple]) -> None:
        """The flight recorder's native phases for one drained burst, from
        the CLOCK_MONOTONIC stamps the C++ side carried across its ring:
        accept (first byte → fully received), parse (received →
        canonicalized and pushed), ring cross (pushed → drained here). One
        event per phase per burst, spanning the burst's earliest start to
        its latest end."""
        rec = flightrec.recorder()
        if rec is None:
            return
        t_drain = time.perf_counter_ns()
        rows = len(burst)
        # t_first is 0 for a request that arrived in one read: the parse
        # stamp stands in, so the accept interval stays on the timebase
        firsts = [r[9] if r[9] else r[10] for r in burst]
        parses = [r[10] for r in burst]
        pushes = [r[11] for r in burst]
        rec.record_phase(
            flightrec.PH_NATIVE_ACCEPT, min(firsts), max(parses), rows=rows
        )
        rec.record_phase(
            flightrec.PH_NATIVE_PARSE, min(parses), max(pushes), rows=rows
        )
        rec.record_phase(
            flightrec.PH_RING_CROSS, min(pushes), t_drain, rows=rows
        )

    def _fail_burst(self, burst: list[tuple]) -> None:
        body = _api_error_body(500, "Something went wrong")
        for rec in burst:
            self.complete(rec[0], 500, body)

    def _drain_loop(self) -> None:
        buf = self._poll_buf
        lib = self._lib
        with self._lock:
            # the handle outlives this thread: shutdown() stops the loops
            # and joins the drainer before it frees the instance
            handle = self._handle
        sink = self._sink
        unpack_from = _REC.unpack_from
        rec_size = _REC.size
        while True:
            n = lib.httpfront_poll(
                handle, buf, self._poll_cap, self._POLL_TIMEOUT_MS
            )
            if n < 0:
                return  # stopped and fully drained
            if n == 0:
                continue
            # string_at copies exactly n bytes (buf.raw would copy the
            # whole body-sized buffer every cycle)
            data = ctypes.string_at(buf, n)
            off = 0
            burst: list[tuple] = []
            while off < n:
                (
                    total, req_id, kind, flags, plen, ulen, nslen, oplen,
                    glen, tplen, paylen, t_first, t_parse, t_push,
                ) = unpack_from(data, off)
                p = off + rec_size
                off += total
                # The body's strings were checked as UTF-8 by the C++
                # parser, but the policy id is the raw request target and
                # the traceparent a raw header: a client's bytes must never
                # kill this thread, so every field decodes with "replace"
                # and a record that still fails is answered on its own.
                try:
                    policy = data[p : p + plen].decode(errors="replace")
                    p += plen
                    uid = data[p : p + ulen].decode(errors="replace")
                    p += ulen
                    ns = (
                        data[p : p + nslen].decode(errors="replace")
                        if flags & 1 else None
                    )
                    p += nslen
                    op = data[p : p + oplen].decode(errors="replace")
                    p += oplen
                    gvk = data[p : p + glen].decode(errors="replace")
                    p += glen
                    tp = (
                        data[p : p + tplen].decode(errors="replace")
                        if tplen else ""
                    )
                    p += tplen
                    payload = data[p : p + paylen]
                except Exception as e:  # noqa: BLE001 — answer, never hang
                    logger.error("native frontend record unreadable: %s", e)
                    self._fail_burst([(req_id,)])
                    continue
                burst.append(
                    (
                        req_id, kind, policy, uid, ns, op, gvk, payload,
                        tp, t_first, t_parse, t_push,
                    )
                )
            if not burst:
                continue
            # nothing past this point may end the thread: a burst that
            # fails anywhere is answered in-band and the loop goes on
            try:
                self._record_burst_phases(burst)
                # chaos site, once per burst: a fault at intake answers
                # every request of the burst instead of stranding it
                failpoints.fire("frontend.accept")
                sink.handle_burst(self, burst)
            except Exception as e:  # noqa: BLE001 — answer, never hang
                logger.error("native frontend burst failed: %s", e)
                self._fail_burst(burst)
            except BaseException:
                # the thread is dying: its burst is answered first, so
                # nothing strands until the watchdog revives the drainer
                self._fail_burst(burst)
                raise


class NativeTlsManager:
    """TLS termination on the native loops, fed by ``certs.py``.

    * builds SSL_CTX generations from the ``ReloadableTlsContext``'s last
      good snapshots (the bytes the standard-library contexts serve, never
      files mid-rotation) and installs each on the frontend;
    * a reload listener installs a new generation after every successful
      rotation (SIGHUP or the digest poll): new connections shake hands
      under it while established ones drain on the one they pinned; a
      failed rebuild keeps the previous generation serving and is counted;
    * a poll thread fires the ``tls.handshake`` failpoint every 0.25 s and
      arms or disarms the native refuse-every-handshake switch with it.
    """

    HANDSHAKE_TIMEOUT_MS = 10_000
    _FAILPOINT_POLL_SECONDS = 0.25

    def __init__(
        self,
        frontend: NativeFrontend,
        reloadable: Any,
        *,
        handshake_timeout_ms: int | None = None,
    ):
        self._frontend = frontend
        self._reloadable = reloadable
        self._lock = threading.Lock()
        self._ctx_handle: int | None = None  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._fail_armed = False
        self.generations = 0  # guarded-by: _lock
        self.failed_swaps = 0  # guarded-by: _lock
        frontend.configure_tls(
            self.HANDSHAKE_TIMEOUT_MS
            if handshake_timeout_ms is None
            else int(handshake_timeout_ms)
        )
        self._install_current()  # raises when the identity will not build
        reloadable.add_reload_listener(self._on_reload)
        self._thread = threading.Thread(
            target=self._failpoint_loop, name="native-tls-failpoints",
            daemon=True,
        )
        self._thread.start()

    def _install_current(self) -> None:
        cert_pem, key_pem = self._reloadable.identity_snapshot()
        ca = self._reloadable.client_ca_snapshot()
        handle = tls_ctx_create(cert_pem, key_pem, ca.encode() if ca else None)
        self._frontend.set_tls(handle)
        with self._lock:
            old, self._ctx_handle = self._ctx_handle, handle
            self.generations += 1
        if old:
            tls_ctx_free(old)

    def _on_reload(self) -> None:
        if self._stop.is_set():
            return  # the loops are gone: nothing to install on
        try:
            self._install_current()
            logger.info(
                "native TLS generation rotated (generation %d): new "
                "connections handshake under the new identity, "
                "established connections drain on the old one",
                self.generations,
            )
        except Exception as e:  # noqa: BLE001 — keep the last good serving
            with self._lock:
                self.failed_swaps += 1
            logger.error(
                "native TLS generation rebuild failed; the previous "
                "identity keeps serving: %s", e,
            )

    def _failpoint_loop(self) -> None:
        while not self._stop.wait(self._FAILPOINT_POLL_SECONDS):
            self.poll_failpoint_once()

    def poll_failpoint_once(self) -> None:
        """One ``tls.handshake`` evaluation (the loop's body, and the entry
        tests drive): a raising site refuses every new handshake until it
        is disarmed."""
        try:
            failpoints.fire("tls.handshake")
            armed = False
        except Exception:  # noqa: BLE001 — any raise means refuse
            armed = True
        if armed != self._fail_armed:
            self._fail_armed = armed
            self._frontend.fail_tls_handshakes(-1 if armed else 0)

    def snapshot(self) -> dict:
        """Generations, failed swaps, the reload counters, the identity's
        notAfter and the kernel-TLS capability."""
        reloads, reload_failures = self._reloadable.counters()
        with self._lock:
            generations = self.generations
            failed_swaps = self.failed_swaps
        return {
            "generations": generations,
            "failed_swaps": failed_swaps,
            "reloads": reloads,
            "reload_failures": reload_failures,
            "cert_expiry_epoch": self._reloadable.identity_not_after(),
            "ktls": ktls_supported(),
        }

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            handle, self._ctx_handle = self._ctx_handle, None
        if handle:
            tls_ctx_free(handle)


# -- native response assembly: the one packing path --------------------------
# Fields of AdmissionResponse / ValidationStatus the C++ emitter renders,
# and the Python-only rest (rendered by json.dumps here).
NATIVE_RESPONSE_FIELDS = frozenset(
    {"uid", "allowed", "patch_type", "patch", "status", "warnings"}
)
PYTHON_ONLY_RESPONSE_FIELDS = frozenset({"audit_annotations"})
NATIVE_STATUS_FIELDS = frozenset({"message", "code", "reason", "details"})
PYTHON_ONLY_STATUS_FIELDS: frozenset = frozenset()

# v2 bulk verdict record header (csrc/httpfront.cpp parse_verdict_record):
#   u64 req_id | u8 allowed | u8 raw_shape | u8 flags | u8 n_warnings |
#   i32 code | i32 uid_len | i32 msg_len | i32 patch_len |
#   i32 reason_len | i32 n_causes
# then uid | msg | patch | reason | warnings (u32 len + bytes each) |
# causes (i32 field_len | i32 msg_len | field | msg each). -1 lengths =
# absent; flags bit0 = status present, bit1 = warnings list present.
_BULK_REC = struct.Struct("<QBBBBiiiiii")
_WARN_LEN = struct.Struct("<I")
_CAUSE_LEN = struct.Struct("<ii")
# the record's leading u64 alone: the in-band error path recovers req_ids
# from records whose bulk fill failed as a unit
_REC_REQ_ID = struct.Struct("<Q")
# status codes ride an i32 with -1 as the absent sentinel: anything
# outside [0, 2^31) takes the Python renderer
_CODE_MAX = 0x7FFFFFFF


def _pack_causes(causes_b) -> bytes:
    """The (field_len | msg_len | field | msg) cause tail, shared by both
    packers."""
    parts = []
    for fb, mb in causes_b:
        parts.append(
            _CAUSE_LEN.pack(
                -1 if fb is None else len(fb), -1 if mb is None else len(mb)
            )
        )
        if fb is not None:
            parts.append(fb)
        if mb is not None:
            parts.append(mb)
    return b"".join(parts)


def pack_verdict_record(req_id: int, r: Any, raw_shape: bool) -> bytes | None:
    """Pack one AdmissionResponse-shaped verdict into the v2 record the
    native serializer renders byte-exactly. None when the shape needs the
    Python renderer: audit annotations, a patchType without a patch (or a
    non-JSONPatch type), status codes outside the i32 range, more than 255
    warnings, or strings utf-8 cannot encode (surrogates)."""
    if r.audit_annotations is not None:
        return None
    patch = r.patch
    if (patch is None) != (r.patch_type is None) or (
        r.patch_type is not None and r.patch_type != "JSONPatch"
    ):
        return None
    st = r.status
    warnings = r.warnings
    try:
        uid_b = r.uid.encode()
        msg_b = reason_b = None
        code = -1
        n_causes = -1
        causes_b: tuple = ()
        flags = 0
        if st is not None:
            flags |= 1
            if st.message is not None:
                msg_b = st.message.encode()
            if st.code is not None:
                if not 0 <= st.code <= _CODE_MAX:
                    return None
                code = int(st.code)
            if st.reason is not None:
                reason_b = st.reason.encode()
            if st.details is not None:
                causes_b = tuple(
                    (
                        c.field.encode() if c.field is not None else None,
                        c.message.encode() if c.message is not None else None,
                    )
                    for c in st.details.causes
                )
                n_causes = len(causes_b)
        patch_b = patch.encode() if patch is not None else None
        warn_b = None
        if warnings is not None:
            if len(warnings) > 255:
                return None
            flags |= 2
            warn_b = [w.encode() for w in warnings]
    except (UnicodeEncodeError, AttributeError):
        return None
    parts = [
        _BULK_REC.pack(
            req_id, 1 if r.allowed else 0, 1 if raw_shape else 0,
            flags, len(warn_b) if warn_b is not None else 0, code,
            len(uid_b),
            -1 if msg_b is None else len(msg_b),
            -1 if patch_b is None else len(patch_b),
            -1 if reason_b is None else len(reason_b),
            n_causes,
        ),
        uid_b,
    ]
    if msg_b is not None:
        parts.append(msg_b)
    if patch_b is not None:
        parts.append(patch_b)
    if reason_b is not None:
        parts.append(reason_b)
    if warn_b:
        for w in warn_b:
            parts.append(_WARN_LEN.pack(len(w)))
            parts.append(w)
    if causes_b:
        parts.append(_pack_causes(causes_b))
    return b"".join(parts)


def pack_frag_record(req_id: int, frag: Any, raw_shape: bool) -> bytes | None:
    """The cache-hit lane of :func:`pack_verdict_record`: a FragVerdict's
    template already carries the encoded message and cause bytes, so a
    hit packs as one header + uid + the template's memoized tail (cached
    on the template the first time a hit ships)."""
    t = frag.tmpl
    try:
        uid_b = frag.uid.encode()
    except UnicodeEncodeError:
        return None
    tail = t.native_tail
    if tail is None:
        if t.code is not None and not 0 <= t.code <= _CODE_MAX:
            return None
        n_causes = -1 if t.causes_b is None else len(t.causes_b)
        tail = (
            t.allowed,
            0 if t.status is None else 1,  # flags: status present
            -1 if t.code is None else int(t.code),
            t.msg_b,
            n_causes,
            _pack_causes(t.causes_b or ()),
        )
        t.native_tail = tail
    allowed, flags, code, msg_b, n_causes, causes_tail = tail
    header = _BULK_REC.pack(
        req_id, 1 if allowed else 0, 1 if raw_shape else 0,
        flags, 0, code, len(uid_b),
        -1 if msg_b is None else len(msg_b),
        -1, -1, n_causes,
    )
    if msg_b is None:
        return b"".join((header, uid_b, causes_tail))
    return b"".join((header, uid_b, msg_b, causes_tail))


def _pack(req_id: int, r: Any, raw_shape: bool) -> bytes | None:
    return (
        pack_frag_record(req_id, r, raw_shape)
        if type(r) is FragVerdict
        else pack_verdict_record(req_id, r, raw_shape)
    )


def _python_body(r: Any, raw_shape: bool) -> bytes:
    """The Python-rendered 200 body of a verdict no record can carry."""
    from policy_server_tpu_torch.models import (
        AdmissionReviewResponse,
        RawReviewResponse,
    )

    env = RawReviewResponse(r) if raw_shape else AdmissionReviewResponse(r)
    return json.dumps(env.to_dict()).encode()


def route_policy(state: Any, policy_id: str):
    """A bare id → the server's batcher; a two-segment id ("tenant/policy",
    passed through verbatim by the C++ router and the bridge) → that
    tenant's batcher (``tenancy.resolve_tenant_batcher``), or ``(None,
    policy, 404 body)`` with the unknown-tenant text every frontend shares.
    Per record of every burst, so the common case is one substring test."""
    if "/" not in policy_id:
        return state.batcher, policy_id, None
    from policy_server_tpu_torch.tenancy import (
        resolve_tenant_batcher,
        unknown_tenant_message,
    )

    batcher, pid, unknown = resolve_tenant_batcher(state, policy_id)
    if batcher is None:
        return None, pid, _api_error_body(404, unknown_tenant_message(unknown))
    return batcher, pid, None


class BatcherSink:
    """Parsed records feed the MicroBatcher array-at-a-time (one
    ``submit_many`` per poll burst); verdicts come back batch-granular
    through :meth:`deliver_many`: one frontend-lock acquisition and one
    native bulk completion per dispatched batch. The batcher's pipeline
    workers call ``deliver_many`` concurrently; the frontend's lock
    serializes their completion calls."""

    def __init__(self, state: Any):
        self.state = state
        # a token is the completion route (frontend, req_id, raw_shape):
        # the frontend rides in the token, not on the sink

    def handle_burst(self, frontend: NativeFrontend, burst: list[tuple]) -> None:
        """One poll burst → at most one submit_many per (tenant batcher,
        origin); fallback records (the Python parse oracle, raw shapes)
        keep their per-record path."""
        from policy_server_tpu_torch.api.service import RequestOrigin
        from policy_server_tpu_torch.runtime.frontend import WireValidateRequest

        rec = flightrec.recorder()
        t_admit = time.perf_counter_ns() if rec is not None else 0
        # (id(batcher), origin) → [batcher, origin, items, tokens]
        groups: dict = {}
        for (
            req_id, kind, policy_id, uid, ns, op, gvk, payload,
            _tp, _tf, _tpr, _tpu,
        ) in burst:
            if kind in (K_VALIDATE, K_AUDIT):
                batcher, pid, not_found = route_policy(self.state, policy_id)
                if batcher is None:
                    frontend.complete(req_id, 404, not_found)
                    continue
                header = {
                    "uid": uid,
                    "namespace": ns,
                    "operation": op,
                    "kind": gvk or None,
                }
                origin = (
                    RequestOrigin.AUDIT if kind == K_AUDIT
                    else RequestOrigin.VALIDATE
                )
                g = groups.setdefault(
                    (id(batcher), origin), [batcher, origin, [], []]
                )
                g[2].append((pid, WireValidateRequest(header, payload)))
                g[3].append((frontend, req_id, False))
            else:
                try:
                    self._handle_fallback(
                        frontend, req_id, kind, policy_id, payload
                    )
                except Exception as e:  # noqa: BLE001 — answer, never hang
                    logger.error("native frontend record failed: %s", e)
                    frontend.complete(
                        req_id, 500,
                        _api_error_body(500, "Something went wrong"),
                    )
        # a failure admitting one group answers only its records
        for batcher, origin, g_items, g_tokens in groups.values():
            try:
                batcher.submit_many(g_items, origin, sink=self, tokens=g_tokens)
            except Exception as e:  # noqa: BLE001 — answer, never hang
                logger.error("bulk submission failed: %s", e)
                body = _api_error_body(500, "Something went wrong")
                for _fe, req_id, _raw in g_tokens:
                    frontend.complete(req_id, 500, body)
        if rec is not None and groups:
            rec.record_phase(
                flightrec.PH_ADMIT, t_admit, time.perf_counter_ns(),
                rows=sum(len(g[2]) for g in groups.values()),
            )

    def _handle_fallback(self, frontend, req_id, kind, policy_id, payload) -> None:
        from policy_server_tpu_torch.api.service import RequestOrigin
        from policy_server_tpu_torch.models import ValidateRequest

        raw_shape = False
        if kind in (K_VALIDATE_FB, K_AUDIT_FB):
            # the native parser declined (a float, a duplicate key, bad
            # syntax, ...): Python is the parse oracle, so 422 bodies are
            # the standard-library frontend's
            try:
                review = parse_admission_review_bytes(payload)
            except BodyError as e:
                frontend.complete(req_id, 422, _api_error_body(422, e.message))
                return
            request = ValidateRequest.from_admission(review.request)
            origin = (
                RequestOrigin.AUDIT if kind == K_AUDIT_FB
                else RequestOrigin.VALIDATE
            )
        else:  # K_RAW
            from policy_server_tpu_torch.models import RawReviewRequest

            raw_shape = True
            try:
                raw_review = RawReviewRequest.from_dict(json.loads(payload))
                request = ValidateRequest.from_raw(raw_review.request)
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                frontend.complete(
                    req_id, 422,
                    _api_error_body(
                        422, f"Failed to parse the request body as JSON: {e}"
                    ),
                )
                return
            except (KeyError, TypeError, ValueError, AttributeError) as e:
                frontend.complete(
                    req_id, 422,
                    _api_error_body(
                        422, f"Failed to deserialize the JSON body: {e}"
                    ),
                )
                return
            origin = RequestOrigin.VALIDATE
        self._submit(frontend, req_id, policy_id, request, origin, raw_shape)

    def _submit(self, frontend, req_id, policy_id, request, origin, raw_shape) -> None:
        batcher, policy_id, not_found = route_policy(self.state, policy_id)
        if batcher is None:
            frontend.complete(req_id, 404, not_found)
            return
        try:
            fut = batcher.submit_nowait(policy_id, request, origin)
        except ShedError as e:
            _complete_shed(frontend, req_id, e)
            return
        fut.add_done_callback(lambda f: _deliver(frontend, req_id, raw_shape, f))

    # -- batch-granular completion (MicroBatcher's sink) ---------------------

    def deliver_many(self, completions: list[tuple]) -> None:
        """One call per dispatched batch: the common verdict shape packs
        into one native bulk fill; errors and the Python-only shapes take
        their per-record paths. Every record is guarded on its own: one
        broken response answers 500, the rest of the batch still ships."""
        bulk_by_frontend: dict = {}
        for token, response, exc in completions:
            frontend, req_id, raw_shape = token
            try:
                self._deliver_one(
                    bulk_by_frontend, frontend, req_id, raw_shape,
                    response, exc,
                )
            except Exception as e:  # noqa: BLE001 — answer, never hang
                logger.error("completion delivery failed: %s", e)
                try:
                    frontend.complete(
                        req_id, 500,
                        _api_error_body(500, "Something went wrong"),
                    )
                except Exception:  # noqa: BLE001 — frontend gone
                    pass
        rec = flightrec.recorder()
        t_ser = (
            time.perf_counter_ns()
            if rec is not None and bulk_by_frontend else 0
        )
        for frontend, records in bulk_by_frontend.items():
            try:
                frontend.complete_verdict_bulk(records)
            except Exception as e:  # noqa: BLE001 — the fill failed as a
                # unit: answer each record in-band
                logger.error("bulk completion fill failed: %s", e)
                for record in records:
                    try:
                        frontend.complete(
                            _REC_REQ_ID.unpack_from(record)[0], 500,
                            _api_error_body(500, "Something went wrong"),
                        )
                    except Exception:  # noqa: BLE001
                        pass
        if t_ser:
            # the handoff to the native serializer (the event loop renders
            # the bytes afterwards; framing_ns counts that side)
            rec.record_phase(
                flightrec.PH_NATIVE_SERIALIZE, t_ser, time.perf_counter_ns(),
                rows=sum(len(r) for r in bulk_by_frontend.values()),
            )

    def _deliver_one(
        self, bulk_by_frontend, frontend, req_id, raw_shape, response, exc
    ) -> None:
        if exc is not None:
            self._deliver_exc(frontend, req_id, exc)
            return
        record = _pack(req_id, response, raw_shape)
        if record is not None:
            bulk_by_frontend.setdefault(frontend, []).append(record)
            return
        frontend.complete(req_id, 200, _python_body(response, raw_shape))

    @staticmethod
    def _deliver_exc(frontend, req_id: int, exc: BaseException) -> None:
        from policy_server_tpu_torch.evaluation.errors import PolicyNotFoundError

        if isinstance(exc, ShedError):
            _complete_shed(frontend, req_id, exc)
        elif isinstance(exc, PolicyNotFoundError):
            frontend.complete(req_id, 404, _api_error_body(404, str(exc)))
        else:
            logger.error("Evaluation error: %s", exc)
            frontend.complete(
                req_id, 500, _api_error_body(500, "Something went wrong")
            )


def _complete_shed(frontend: NativeFrontend, req_id: int, exc) -> None:
    """A shed (429) or fenced (503) answer, with its Retry-After header."""
    status, retry, body = shed_answer(exc)
    frontend.complete(req_id, status, body, retry)


def _deliver(frontend: NativeFrontend, req_id: int, raw_shape: bool, fut) -> None:
    """A resolved batcher future → the HTTP answer (the fallback records'
    path). Runs as a done-callback: any escape would strand the request,
    so the whole body is guarded."""
    try:
        exc = fut.exception()
        if exc is not None:
            BatcherSink._deliver_exc(frontend, req_id, exc)
            return
        r = fut.result()
        record = _pack(req_id, r, raw_shape)
        if record is not None:
            frontend.complete_verdict_rec(record)
            return
        frontend.complete(req_id, 200, _python_body(r, raw_shape))
    except Exception as e:  # noqa: BLE001 — answer, never hang
        logger.error("verdict delivery failed: %s", e)
        try:
            frontend.complete(
                req_id, 500, _api_error_body(500, "Something went wrong")
            )
        except Exception:  # noqa: BLE001 — frontend gone
            pass


class BridgeSink:
    """A prefork worker's sink: the worker owns a native event loop and
    forwards each drained record over the evaluation bridge
    (``runtime/frontend.py``) as the JAX package's ``BridgeSink`` does:
    parsed records as parsed frames, fallback records parsed here first
    (their 422s never cross the bridge), raw records as they came. The
    answer frame completes the request from the bridge client's reader
    thread; a closed bridge answers 503, any other failure 500."""

    def __init__(self, bridge: Any):
        self.bridge = bridge

    def handle_burst(self, frontend: NativeFrontend, burst: list[tuple]) -> None:
        for rec in burst:
            req_id = rec[0]
            try:
                fut = self._forward(frontend, *rec[:8])
            except Exception as e:  # noqa: BLE001 — answer, never hang
                fut = None
                self._complete(frontend, req_id, None, e)
            if fut is not None:
                fut.add_done_callback(
                    lambda f, req_id=req_id: self._complete(
                        frontend, req_id, f, None
                    )
                )

    def _forward(
        self, frontend, req_id, kind, policy_id, uid, ns, op, gvk, payload
    ):
        """One record → the bridge's Future, or None when answered here."""
        from policy_server_tpu_torch.runtime import frontend as fr

        if kind in (K_VALIDATE, K_AUDIT):
            header = json.dumps(
                {"uid": uid, "namespace": ns, "operation": op,
                 "kind": gvk or None}
            ).encode()
            return self.bridge.submit_parsed(
                fr.ORIGIN_AUDIT_PARSED if kind == K_AUDIT
                else fr.ORIGIN_VALIDATE_PARSED,
                policy_id, header, payload,
            )
        if kind in (K_VALIDATE_FB, K_AUDIT_FB):
            try:
                review = parse_admission_review_bytes(payload)
            except BodyError as e:
                frontend.complete(req_id, 422, _api_error_body(422, e.message))
                return None
            adm = review.request
            return self.bridge.submit_parsed(
                fr.ORIGIN_AUDIT_PARSED if kind == K_AUDIT_FB
                else fr.ORIGIN_VALIDATE_PARSED,
                policy_id, fr.admission_header(adm), fr.canonical_payload(adm),
            )
        return self.bridge.submit(fr.ORIGIN_RAW, policy_id, payload)

    @staticmethod
    def _complete(frontend, req_id: int, fut, exc) -> None:
        from policy_server_tpu_torch.runtime import frontend as fr

        try:
            if fut is not None:
                exc = fut.exception()
            if exc is None:
                status, body = fut.result()
                headers = fr._shed_headers(status, body)
                retry = int(headers["Retry-After"]) if headers else 0
                frontend.complete(req_id, status, body, retry)
            elif isinstance(exc, ConnectionError):
                frontend.complete(req_id, 503, fr.UNAVAILABLE_BODY)
            else:
                logger.error("bridge forward failed: %s", exc)
                frontend.complete(
                    req_id, 500, _api_error_body(500, "Something went wrong")
                )
        except Exception as e:  # noqa: BLE001 — frontend gone
            logger.error("bridge answer failed: %s", e)
