"""The webhook load: writers in a closed loop over HTTPS keep-alive.

A writer takes its next object write only when every call of the current
one has been answered, and makes that write's calls as the Kubernetes API
server calls admission webhooks: first each mutating webhook alone, one
after another, each on the object as the patches before it left it; then
every validating webhook at once on the mutated object, one call in flight
per connection and no pipelining. A mutating webhook that denies or fails
ends the write, as the API server rejects it there. Writers are spread over
several client processes, each a single-threaded loop over non-blocking
TLS sockets, so that the client is not what paces the server.

The load is an extended copy of ``chip_smoke.py``'s ``native_client_main``
(raw keep-alive HTTP/1.1, ``Content-Length`` framing) and ``write_corpus``
(the raw POST), reshaped into this loop.

A client process is driven over a pipe: ``connect`` opens and shakes hands
on every connection, ``run`` sends the load between the given monotonic
times and returns every call's timing, ``verify`` holds each answer against
the plain reference after the server has stopped. Nothing here imports the
program.
"""

from __future__ import annotations

import base64
import gc
import json
import os
import selectors
import socket
import ssl
import time
from typing import Any

from admission_bench import pods

OK, FAILED = 0, 1
# an answer's in-band status codes that say the server failed the call
FAILURE_CODES = (500, 502, 503, 504)


def request_bytes(policy_id: str, body: bytes) -> bytes:
    return (
        f"POST /validate/{policy_id} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
        f"Content-Type: application/json\r\nContent-Length: {len(body)}\r\n\r\n"
    ).encode() + body


def classify(status: int, body: bytes) -> tuple[int, dict | None]:
    """(OK, the AdmissionResponse) for an answer that carries a verdict;
    (FAILED, None) for a refusal (429, 503), an in-band 5xx such as the 504
    of an expired deadline, or a body that is not an AdmissionReview."""
    if status != 200:
        return FAILED, None
    try:
        response = json.loads(body)["response"]
        code = (response.get("status") or {}).get("code")
    except (ValueError, TypeError, KeyError, AttributeError):
        return FAILED, None
    return (FAILED, None) if code in FAILURE_CODES else (OK, response)


def expected_answers(ref: Any, review: dict, phases: list[list[str]]) -> dict:
    """What ``ref`` answers each call of one write, the write's calls made
    as the API server makes them (``pods.phases``) with ``ref``'s own
    patches applied: policy id → AdmissionResponse (patch decoded). A
    mutating webhook that denies ends the write, so later phases have no
    entry."""
    want: dict = {}
    for phase in phases[:-1]:
        answer = want[phase[0]] = ref.answer(phase[0], review)
        if not answer["allowed"]:
            return want
        if "patch" in answer:
            review = pods.mutated(review, answer["patch"])
    for pid in phases[-1]:
        want[pid] = ref.answer(pid, review)
    return want


class Conn:
    """One keep-alive TLS connection and the call it has in flight."""

    __slots__ = ("sock", "writer", "slot", "out", "buf", "sent_at", "policy")

    def __init__(self, sock: ssl.SSLSocket, writer: int, slot: int):
        self.sock = sock
        self.writer = writer
        self.slot = slot
        self.out = b""
        self.buf = b""
        self.sent_at = 0.0
        self.policy = ""


class Client:
    """The writers of one client process."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.mix = cfg["mix"]
        self.seed = cfg["seed"]
        self.policy_ids = cfg["policy_ids"]
        self.mutating = cfg["mutating"]
        self.writers = cfg["writers"]
        self.slots = cfg["slots_per_writer"]
        self.ctx = ssl.create_default_context(cafile=cfg["ca_file"])
        self.sel = selectors.DefaultSelector()
        self.conns: dict[int, list[Conn]] = {}
        # per writer: index of the write in flight, its start, its phases,
        # the phase in flight, the review as mutated so far, answers due
        self.index = dict.fromkeys(self.writers, -1)
        self.started: dict[int, float] = {}
        self.phases: dict[int, list] = {}
        self.phase: dict[int, int] = {}
        self.review: dict[int, dict] = {}
        self.due: dict[int, int] = {}
        self.failed_obj: dict[int, bool] = {}
        self.calls: list[tuple] = []      # (writer, index, policy, sent, done, kind)
        self.bodies: list[bytes] = []     # the answer of each call, same order
        self.objects: list[tuple] = []    # (writer, index, start, done, all_ok)
        self.errors: list[str] = []
        self.stop_at = 0.0
        self.in_flight = 0

    # -- connections ---------------------------------------------------------

    def _open(self, writer: int, slot: int) -> Conn:
        raw = socket.create_connection((self.cfg["host"], self.cfg["port"]), timeout=60)
        raw.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock = self.ctx.wrap_socket(raw, server_hostname=self.cfg["host"])
        sock.setblocking(False)
        conn = Conn(sock, writer, slot)
        self.sel.register(sock, selectors.EVENT_READ, conn)
        return conn

    def connect(self) -> int:
        for w in self.writers:
            self.conns[w] = [self._open(w, s) for s in range(self.slots)]
        return sum(len(c) for c in self.conns.values())

    def _reopen(self, conn: Conn) -> None:
        try:
            self.sel.unregister(conn.sock)
            conn.sock.close()
        except (OSError, KeyError, ValueError):
            pass
        self.conns[conn.writer][conn.slot] = self._open(conn.writer, conn.slot)

    # -- the loop ------------------------------------------------------------

    def _start_write(self, writer: int, now: float) -> None:
        k = self.index[writer] + 1
        self.index[writer] = k
        self.review[writer] = pods.object_review(self.seed, writer, k, self.mix)
        self.phases[writer] = pods.phases(
            self.policy_ids, self.mutating, self.seed, writer, k, self.mix)
        self.phase[writer] = 0
        self.started[writer] = now
        self.failed_obj[writer] = False
        self._start_phase(writer)

    def _start_phase(self, writer: int) -> None:
        targets = self.phases[writer][self.phase[writer]]
        body = pods.review_body(self.review[writer])
        self.due[writer] = len(targets)
        for slot, pid in enumerate(targets):
            conn = self.conns[writer][slot]
            conn.policy = pid
            conn.buf = b""
            conn.sent_at = time.monotonic()
            self.in_flight += 1
            self._send(conn, request_bytes(pid, body))

    def _send(self, conn: Conn, data: bytes) -> None:
        try:
            n = conn.sock.send(data)
        except (ssl.SSLWantWriteError, ssl.SSLWantReadError):
            n = 0
        conn.out = data[n:]
        if conn.out:
            self.sel.modify(conn.sock, selectors.EVENT_READ | selectors.EVENT_WRITE, conn)

    def _finish_call(self, w: int, policy: str, sent: float, done: float, kind: int,
                     body: bytes, response: dict | None = None) -> None:
        """Record one call's answer; start the write's next phase, or its
        writer's next write, once the phase has every answer."""
        self.calls.append((w, self.index[w], policy, sent, done, kind))
        self.bodies.append(body)
        self.in_flight -= 1
        if kind != OK:
            self.failed_obj[w] = True
        self.due[w] -= 1
        if self.due[w]:
            return
        last = self.phase[w] == len(self.phases[w]) - 1
        if not last and kind == OK and response.get("allowed") and self._apply(w, response):
            self.phase[w] += 1
            self._start_phase(w)
            return
        self.objects.append((w, self.index[w], self.started[w], done, not self.failed_obj[w]))
        if done < self.stop_at:
            self._start_write(w, done)

    def _apply(self, w: int, response: dict) -> bool:
        """A mutating webhook allowed the write: apply its patch, if any, to
        the object the next webhook gets. False for a patch that does not
        apply, which ends the write as the API server rejects it (the
        reference judges the answer)."""
        patch = response.get("patch")
        if not patch:
            return True
        try:
            self.review[w] = pods.mutated(self.review[w], json.loads(base64.b64decode(patch)))
        except (ValueError, TypeError, KeyError, IndexError, AttributeError) as e:
            self.errors.append(f"patch does not apply: {type(e).__name__}: {e}")
            return False
        return True

    def _readable(self, conn: Conn) -> None:
        while True:
            try:
                chunk = conn.sock.recv(1 << 16)
            except (ssl.SSLWantReadError, ssl.SSLWantWriteError):
                break
            if not chunk:
                raise ConnectionError("server closed the connection")
            conn.buf += chunk
        he = conn.buf.find(b"\r\n\r\n")
        if he < 0 or not conn.policy:
            return
        length = 0
        for line in conn.buf[:he].split(b"\r\n")[1:]:
            if line[:15].lower() == b"content-length:":
                length = int(line[15:])
        if len(conn.buf) < he + 4 + length:
            return
        done = time.monotonic()
        status = int(conn.buf[9:12])
        body = conn.buf[he + 4: he + 4 + length]
        conn.buf = conn.buf[he + 4 + length:]
        kind, response = classify(status, body)
        policy, conn.policy = conn.policy, ""
        self._finish_call(conn.writer, policy, conn.sent_at, done, kind, body, response)

    def _fail(self, conn: Conn, now: float) -> None:
        """A call that got no answer: its slot gets a fresh connection
        first, so that the next call the writer makes goes over it."""
        policy, conn.policy = conn.policy, ""
        self._reopen(conn)
        if policy:
            self._finish_call(conn.writer, policy, conn.sent_at, now, FAILED, b"")

    def run(self, t_load: float, stop_at: float, give_up_at: float) -> dict:
        """Send from ``t_load``; start no write after ``stop_at``; wait for
        the calls in flight until ``give_up_at``."""
        self.stop_at = stop_at
        timeout = float(self.mix["call_timeout_seconds"])
        while time.monotonic() < t_load:
            time.sleep(min(0.01, max(0.0, t_load - time.monotonic())))
        # no collection pauses a writer inside the load; what the load
        # keeps (every answer, for the check) is freed after it
        gc.disable()
        cpu0, wall0 = time.process_time(), time.monotonic()
        for w in self.writers:
            self._start_write(w, time.monotonic())
        next_scan = time.monotonic() + 1.0
        probes: list[float] = []
        while self.in_flight and time.monotonic() < give_up_at:
            for key, mask in self.sel.select(timeout=0.05):
                conn = key.data
                if self.conns[conn.writer][conn.slot] is not conn:
                    continue  # replaced earlier in this round
                try:
                    if mask & selectors.EVENT_WRITE and conn.out:
                        data, conn.out = conn.out, b""
                        self.sel.modify(conn.sock, selectors.EVENT_READ, conn)
                        self._send(conn, data)
                    if mask & selectors.EVENT_READ:
                        self._readable(conn)
                except (OSError, ConnectionError, ValueError) as e:
                    self.errors.append(f"{type(e).__name__}: {e}")
                    self._fail(conn, time.monotonic())
            now = time.monotonic()
            if now < next_scan:
                continue
            next_scan = now + 1.0
            if now < stop_at:
                probes.append(cpu_probe())
            for cs in self.conns.values():
                for conn in list(cs):
                    if conn.policy and now - conn.sent_at > timeout:
                        self.errors.append(f"timeout on /validate/{conn.policy}")
                        self._fail(conn, now)
        unanswered = self.in_flight
        cpu = time.process_time() - cpu0
        wall = time.monotonic() - wall0
        gc.enable()
        for cs in self.conns.values():
            for c in cs:
                c.sock.close()
        return {
            "calls": [c[3:] for c in self.calls],
            "objects": [o[2:] for o in self.objects],
            "unanswered": unanswered,
            "errors": self.errors[:20],
            "n_errors": len(self.errors),
            "cpu_s": cpu,
            "wall_s": wall,
            "probe_us": sorted(probes)[len(probes) // 2] if probes else None,
        }

    # -- correctness -----------------------------------------------------------

    def verify(self, policies: dict, controls: frozenset = frozenset()) -> dict:
        """Hold every answered call against the plain reference (or, with
        ``controls``, the reference with those guarantees broken in the
        program's place): the number checked, the number that differ, and
        a few examples."""
        from admission_bench.reference import Reference, normalize

        ref = Reference(policies)
        control = Reference(policies, controls) if controls else None
        checked = mismatched = 0
        examples: list = []
        key = None
        # the calls of one write together, so that its answers are worked
        # out once
        for i in sorted(range(len(self.calls)), key=lambda i: self.calls[i][:2]):
            (w, k, pid, _sent, _done, kind), body = self.calls[i], self.bodies[i]
            if kind != OK:
                continue
            if (w, k) != key:
                key = (w, k)
                review = pods.object_review(self.seed, w, k, self.mix)
                phases = pods.phases(self.policy_ids, self.mutating, self.seed, w, k, self.mix)
                want_of = expected_answers(ref, review, phases)
                got_of = expected_answers(control, review, phases) if control else None
            # a call that the reference's own chain does not make (after a
            # mutating webhook it denies) is off the reference too
            want = want_of.get(pid)
            got = got_of.get(pid) if got_of is not None else normalize(json.loads(body)["response"])
            checked += 1
            if got != want:
                mismatched += 1
                if len(examples) < 3:
                    examples.append({"policy": pid, "uid": review["request"]["uid"],
                                     "got": got, "want": want})
        return {"checked": checked, "mismatched": mismatched, "examples": examples}


def cpu_probe() -> float:
    """Microseconds of a fixed pure-Python loop: a reading of how fast this
    core runs Python now, apart from the server's threads."""
    t = time.perf_counter()
    x = 0
    for i in range(20000):
        x += i * i
    return (time.perf_counter() - t) * 1e6


def client_main(pipe: Any, cfg: dict) -> None:
    """A client process: obey ``connect``, ``run``, ``verify`` and ``exit``
    from the pipe, answering each with a dict."""
    if cfg.get("cores"):
        os.sched_setaffinity(0, cfg["cores"])
    client = Client(cfg)
    while True:
        cmd, args = pipe.recv()
        try:
            if cmd == "connect":
                pipe.send({"connections": client.connect()})
            elif cmd == "run":
                pipe.send(client.run(*args))
            elif cmd == "verify":
                pipe.send(client.verify(*args))
            else:
                break
        except Exception as e:  # noqa: BLE001 — reported to the harness, which fails the run
            pipe.send({"error": f"{type(e).__name__}: {e}"})
            break
    pipe.close()
