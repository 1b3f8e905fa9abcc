"""The port's verdict matrix (``policy_server_tpu_torch/audit/matrix.py``),
lookup admission and ``GET /audit/stream`` held against the JAX package's:
each case of ``tests/test_audit_stream.py``, under the same name, runs
through each package and the two must agree exactly (tolerance 0:
fingerprints, payload digests, changelog entries, cells, counters and
bodies), beside the JAX test's own assertions. Also held: the digests of
seeded firehose reviews, the stream's client cap and OVERFLOW line over
HTTP, the cluster what-if of a reload with the dirty-column sweep after
its promotion, and the audit GET routes of a matrix server on both ports
under both frontends.

Every batcher, scanner and server a test starts is shut down by it; no
failpoint is armed."""

from __future__ import annotations

import json
import threading
from http.client import HTTPConnection
from types import SimpleNamespace

import pytest

from test_torch_audit import Pair, http, make_scanner, wait_until
from torch_port_support import (
    audit_sides,
    firehose_docs,
    pod_doc,
    pod_review,
    report_view,
    side_request,
)

JAX, PORT = audit_sides()
SIDES = (JAX, PORT)


def _specs(denied=("blocked",)) -> dict:
    return {
        "priv": {"module": "builtin://pod-privileged"},
        "ns": {
            "module": "builtin://namespace-validate",
            "settings": {"denied_namespaces": list(denied)},
        },
    }


def _policies(side, denied=("blocked",)) -> dict:
    return {k: side.parse(k, v) for k, v in _specs(denied).items()}


@pytest.fixture(autouse=True)
def clean_failpoints():
    for side in SIDES:
        side.fp.reset()
    yield
    for side in SIDES:
        side.fp.reset()


@pytest.fixture(scope="module")
def envs():
    built = {side.name: side.env(_specs()) for side in SIDES}
    yield built
    for e in built.values():
        e.close()


def both(case, *args):
    jax_obs = case(JAX, *args)
    port_obs = case(PORT, *args)
    assert port_obs == jax_obs
    return port_obs


def _allow(side, uid="u"):
    return side.Response(uid=uid, allowed=True)


def _deny(side, uid="u"):
    return side.Response.reject(uid, "denied", 400)


def _record_one(side, matrix, req, pid="priv", result=None, epoch=0):
    matrix.record_rows(
        [(side.audit.resource_key(req), pid, req, result or _allow(side))],
        epoch,
    )


def _matrix(side, snapshot=None, **kw):
    return side.audit.VerdictMatrix(
        snapshot=snapshot or side.audit.SnapshotStore(), **kw
    )


# ---------------------------------------------------------------------------
# fingerprints + payload identity
# ---------------------------------------------------------------------------


def test_policy_fingerprint_tracks_content_not_identity():
    def case(side):
        a, b = _policies(side), _policies(side)
        changed = _policies(side, denied=("other",))
        fp = side.audit.policy_fingerprint
        assert fp(a["ns"]) == fp(b["ns"])
        assert fp(a["ns"]) != fp(changed["ns"])
        assert fp(a["priv"]) == fp(changed["priv"])
        group = side.parse("g", {
            "expression": "a() && b()", "message": "no",
            "policies": {"a": {"module": "builtin://pod-privileged"},
                         "b": {"module": "builtin://always-happy"}},
        })
        return [fp(a["ns"]), fp(a["priv"]), fp(changed["ns"]), fp(group)]

    both(case)


def test_normalized_payload_hash_ignores_uid_only():
    def case(side):
        h = side.audit.normalized_payload_hash
        r1 = pod_review(side, "same", uid="uid-one")
        r2 = pod_review(side, "same", uid="uid-two-entirely-different")
        r3 = pod_review(side, "same", privileged=True, uid="uid-one")
        assert h(r1) == h(r2)
        assert h(r1) != h(r3)
        assert h(side.ValidateRequest.from_raw({"uid": "r"})) is None
        return [h(r1), h(r3)]

    both(case)


def test_normalized_payload_hash_equals_the_jax_digest_on_seeded_reviews():
    """Lookup admission's precondition across the packages: the port's
    ``payload_json`` bytes, and so the uid-normalized digest, equal the
    JAX package's for the same review (seeded firehose reviews, one in
    three widened, each under two uids)."""
    docs = firehose_docs(48, seed=21, wide_every=3)

    def case(side):
        out = []
        for i, d in enumerate(docs):
            req = side_request(side, d)
            out.append((req.payload_json(),
                        side.audit.normalized_payload_hash(req)))
            d2 = json.loads(json.dumps(d))
            d2["request"]["uid"] = f"fresh-{i}"
            assert side.audit.normalized_payload_hash(
                side_request(side, d2)
            ) == out[-1][1]
        return out

    both(case)


# ---------------------------------------------------------------------------
# changelog emission semantics
# ---------------------------------------------------------------------------


def test_emission_only_on_verdict_change_restamp_is_silent():
    def case(side):
        m = _matrix(side)
        m.set_columns(_policies(side), 0)
        req = pod_review(side, "a")
        sub = m.subscribe(None)
        out = []
        _record_one(side, m, req, result=_allow(side), epoch=0)
        out.append(m.drain(sub))
        _record_one(side, m, req, result=_allow(side), epoch=1)
        out.append((m.drain(sub), m.version))
        _record_one(side, m, req, result=_deny(side), epoch=1)
        out.append(m.drain(sub))
        _record_one(side, m, req, result=RuntimeError("boom"), epoch=1)
        out.append(m.drain(sub))
        out.append(m.stats())
        return out

    first, (silent, v1), flip, delete, stats = both(case)
    assert [e["type"] for e in first[0]] == ["VERDICT"]
    assert silent == ([], False) and v1 == first[0][0]["matrixVersion"]
    assert flip[0][0]["allowed"] is False
    assert [e["type"] for e in delete[0]] == ["DELETE"]
    assert stats["cells_resident"] == 0


def test_unchanged_promotion_restamps_columns_without_emission():
    def case(side):
        m = _matrix(side)
        m.set_columns(_policies(side), 0)
        m.take_dirty_columns()
        for i in range(3):
            _record_one(side, m, pod_review(side, f"p{i}"), pid="priv")
            _record_one(side, m, pod_review(side, f"p{i}"), pid="ns")
        sub = m.subscribe(None)
        v = m.version
        out = [m.set_columns(_policies(side), 1), m.take_dirty_columns(),
               m.drain(sub), m.version - v]
        out += [m.set_columns(_policies(side, denied=("other",)), 2),
                m.take_dirty_columns()]
        out += [m.set_columns({"priv": _policies(side)["priv"]}, 3),
                m.drain(sub), m.stats()]
        return out

    out = both(case)
    assert out[0]["dirty"] == [] and out[1] == set() and out[3] == 0
    assert out[4]["dirty"] == ["ns"] and out[5] == {"ns"}
    assert out[6]["removed"] == ["ns"] and len(out[7][0]) == 3


# ---------------------------------------------------------------------------
# slow-consumer backpressure, cursors
# ---------------------------------------------------------------------------


def test_slow_consumer_overflows_and_is_dropped_counted():
    def case(side):
        m = _matrix(side, client_queue_capacity=16)
        m.set_columns(_policies(side), 0)
        slow, fast = m.subscribe(None), m.subscribe(None)
        for i in range(40):
            _record_one(side, m, pod_review(side, f"burst-{i}"))
            if i % 2:
                fast.queue.clear()
        entries, dead = m.drain(slow)
        clients = m.stream_clients()
        fast_dead = m.drain(fast)[1]
        m.unsubscribe(slow)
        m.unsubscribe(fast)
        return len(entries), dead, clients, fast_dead, m.stats()

    n, dead, clients, fast_dead, stats = both(case)
    assert (n, dead, clients, fast_dead) == (16, True, 1, False)
    assert stats["changelog_dropped_clients"] == 1
    assert stats["cells_resident"] == 40


def test_cursor_resume_replays_exactly_the_missed_entries():
    def case(side):
        m = _matrix(side)
        m.set_columns(_policies(side), 0)
        for i in range(5):
            _record_one(side, m, pod_review(side, f"r{i}"))
        cursor = m.version
        for i in range(5, 9):
            _record_one(side, m, pod_review(side, f"r{i}"))
        sub = m.subscribe(cursor)
        entries = m.drain(sub)
        sub2 = m.subscribe(m.version)
        caught_up = m.drain(sub2)
        m.unsubscribe(sub)
        m.unsubscribe(sub2)
        return cursor, entries, caught_up

    cursor, (entries, dead), caught_up = both(case)
    assert [e["matrixVersion"] for e in entries] == [
        cursor + 1, cursor + 2, cursor + 3, cursor + 4,
    ]
    assert not dead and caught_up == ([], False)


def test_cursor_older_than_the_ring_gets_resync_plus_full_state():
    def case(side):
        m = _matrix(side, changelog_capacity=64)
        m.set_columns(_policies(side), 0)
        for i in range(80):
            _record_one(side, m, pod_review(side, f"res-{i:03d}"))
        sub = m.subscribe(0)
        entries, _ = m.drain(sub)
        m.unsubscribe(sub)
        return m.version, entries

    version, entries = both(case)
    assert version == 80
    assert entries[0] == {"type": "RESYNC", "matrixVersion": 80}
    assert [e["matrixVersion"] for e in entries[1:]] == list(range(1, 81))


# ---------------------------------------------------------------------------
# the incremental cross-product sweep (scanner integration)
# ---------------------------------------------------------------------------


def _full_resweep_cells(side, env, batcher, rows):
    matrix = _matrix(side)
    scanner = make_scanner(side, env, batcher, matrix=matrix, batch_size=8)
    scanner.snapshot.observe(rows)
    scanner.sweep(full=True)
    return matrix.cells_snapshot()


def _cells(side, matrix) -> dict:
    """Cells keyed by resource and policy, as plain data."""
    return {f"{k}|{p}": list(v) for (k, p), v in matrix.cells_snapshot().items()}


def test_dirty_column_sweep_is_bit_exact_vs_full_resweep(envs):
    def case(side):
        env = envs[side.name]
        rows = [
            pod_review(side, "a", privileged=True),
            pod_review(side, "b"),
            pod_review(side, "c", namespace="blocked"),
            pod_review(side, "d", namespace="other"),
        ]
        batcher = side.Batcher(env, max_batch_size=8, policy_timeout=10.0).start()
        matrix = _matrix(side)
        scanner = make_scanner(side, env, batcher, matrix=matrix, batch_size=8)
        env2 = side.env(_specs(denied=("other",)))
        batcher2 = side.Batcher(env2, max_batch_size=8, policy_timeout=10.0).start()
        try:
            scanner.snapshot.observe(rows)
            out = [scanner.sweep(full=True), _cells(side, matrix)]
            assert matrix.cells_snapshot() == _full_resweep_cells(
                side, env, batcher, rows
            )
            scanner.state.evaluation_environment = env2
            scanner.state.batcher = batcher2
            scanner.on_promote(1)
            out += [scanner.sweep(full=False), matrix.stats(),
                    _cells(side, matrix)]
            assert matrix.cells_snapshot() == _full_resweep_cells(
                side, env2, batcher2, rows
            )
            return out
        finally:
            batcher.shutdown()
            batcher2.shutdown()
            env2.close()

    full, before, dirty, stats, after = both(case)
    assert (full, dirty, stats["column_sweep_rows"]) == (8, 4, 4)
    assert before["/v1/Pod/blocked/c|ns"][0] is False
    assert after["/v1/Pod/blocked/c|ns"][0] is True
    assert after["/v1/Pod/other/d|ns"][0] is False


def test_deleted_object_evicts_matrix_row_and_report_rows(envs):
    def case(side):
        env = envs[side.name]
        batcher = side.Batcher(env, max_batch_size=8, policy_timeout=10.0).start()
        matrix = _matrix(side)
        scanner = make_scanner(side, env, batcher, matrix=matrix, batch_size=8)
        try:
            scanner.snapshot.observe([pod_review(side, "gone"),
                                      pod_review(side, "kept")])
            scanner.sweep(full=True)
            sub = matrix.subscribe(None)
            scanner.snapshot.observe([pod_review(side, "gone", operation="DELETE")])
            scanner.sweep(full=False)
            entries, _ = matrix.drain(sub)
            matrix.unsubscribe(sub)
            return (entries, matrix.stats(),
                    report_view(scanner.report_payload())["reports"])
        finally:
            batcher.shutdown()

    entries, stats, reports = both(case)
    assert [e["type"] for e in entries] == ["DELETE", "DELETE"]
    assert stats["rows_resident"] == 1
    assert {r["name"] for r in reports} == {"kept"}


def test_spill_and_restore_without_a_state_store(envs):
    """Without ``--state-dir`` (a matrix with no state store) both
    packages' matrices spill nothing and restore nothing, with the same
    counters."""

    def case(side):
        snapshot = side.audit.SnapshotStore()
        m = side.audit.VerdictMatrix(snapshot=snapshot)
        m.set_columns(_policies(side), 0)
        snapshot.observe([pod_review(side, "a")])
        _record_one(side, m, pod_review(side, "a"))
        out = [m.maybe_spill(), m.maybe_spill(force=True), m.restore()]
        stats = m.stats()
        return out, stats["spills"], stats["cells_restored"], snapshot.dirty_keys()

    assert both(case)[:3] == ([False, False, 0], 0, 0)


def test_spill_restore_roundtrip_validates_columns_and_payloads(envs, tmp_path):
    """``tests/test_audit_stream.py``'s case: a swept matrix spills through
    the state store; a warm boot whose snapshot holds one CHANGED row and
    one identical row restores only the identical row's cells, clears that
    row's dirty mark, keeps the version cursor, and a serving set whose
    ``ns`` policy changed restores only the ``priv`` column. Both packages
    observe the same, and each restores the other's journal the same."""
    from policy_server_tpu.statestore import StateStore as JStore
    from policy_server_tpu_torch.statestore import StateStore as PStore

    stores = {"jax": JStore, "port": PStore}

    def case(side):
        state = tmp_path / side.name
        store = stores[side.name](str(state))
        env = envs[side.name]
        rows = [pod_review(side, "a", privileged=True), pod_review(side, "b")]
        batcher = side.Batcher(env, max_batch_size=8, policy_timeout=10.0).start()
        snapshot = side.audit.SnapshotStore()
        matrix = side.audit.VerdictMatrix(snapshot=snapshot, statestore=store)
        scanner = side.audit.AuditScanner(
            state=SimpleNamespace(
                evaluation_environment=env, batcher=batcher, lifecycle=None
            ),
            snapshot=snapshot, reports=side.audit.PolicyReportStore(),
            matrix=matrix, mode="interval", interval_seconds=30.0,
            batch_size=8,
        )
        try:
            snapshot.observe(rows)
            scanner.sweep(full=True)
            before = matrix.cells_snapshot()
            spilled = matrix.maybe_spill(force=True)
        finally:
            batcher.shutdown()
        key_b = side.audit.resource_key(rows[1])
        out = [spilled]
        for reader in stores.values():
            snapshot2 = side.audit.SnapshotStore()
            changed_a = pod_review(side, "a", privileged=False)
            snapshot2.observe([changed_a, pod_review(side, "b")])
            m2 = side.audit.VerdictMatrix(
                snapshot=snapshot2, statestore=reader(str(state))
            )
            m2.set_columns(_policies(side), 0)
            restored = m2.restore()
            cells = m2.cells_snapshot()
            assert set(cells) == {(key_b, "priv"), (key_b, "ns")}
            assert cells[(key_b, "priv")] == before[(key_b, "priv")]
            assert snapshot2.dirty_keys() == {side.audit.resource_key(changed_a)}
            assert m2.version >= matrix.version
            snapshot3 = side.audit.SnapshotStore()
            snapshot3.observe([pod_review(side, "b")])
            m3 = side.audit.VerdictMatrix(
                snapshot=snapshot3, statestore=reader(str(state))
            )
            m3.set_columns(_policies(side, denied=("other",)), 0)
            out.append((restored, _cells(side, m2), m2.stats()["cells_restored"],
                        m3.restore(), _cells(side, m3)))
        return out

    spilled, *restores = both(case)
    assert spilled is True and restores[0] == restores[1]
    restored, cells, counted, stale, stale_cells = restores[0]
    assert restored == 2 and counted == 2 and len(cells) == 2
    assert stale == 1 and list(stale_cells) == ["/v1/Pod/default/b|priv"]


# ---------------------------------------------------------------------------
# lookup admission (the batcher fast path)
# ---------------------------------------------------------------------------


def test_lookup_gates_payload_identity_and_column_currency(envs):
    def case(side):
        env = envs[side.name]
        m = _matrix(side)
        m.set_columns(_policies(side), 0)
        judged = pod_review(side, "obj", operation="UPDATE", uid="uid-judged")
        _record_one(side, m, judged, pid="priv", result=_allow(side))
        replay = pod_review(side, "obj", operation="UPDATE", uid="uid-fresh")
        tmpl = m.lookup("priv", replay, env)
        out = [tmpl.to_response("x").to_dict()]
        out.append(m.lookup("priv", pod_review(
            side, "obj", privileged=True, operation="UPDATE"), env))
        out.append(m.lookup("ns", replay, env))
        m.set_columns({
            "priv": side.parse("priv", {
                "module": "builtin://pod-privileged", "policyMode": "monitor",
            }),
            "ns": _policies(side)["ns"],
        }, 1)
        out.append(m.lookup("priv", replay, env))
        out.append(m.stats())
        return out

    out = both(case)
    assert out[0]["allowed"] is True and out[1:4] == [None, None, None]
    assert (out[4]["lookup_hits"], out[4]["lookup_misses"]) == (1, 3)


def test_batcher_answers_byte_identical_update_from_the_matrix(envs):
    def case(side):
        env = envs[side.name]
        m = _matrix(side)
        m.set_columns(_policies(side), 0)
        batcher = side.Batcher(
            env, max_batch_size=8, policy_timeout=10.0, verdict_matrix=m
        ).start()
        try:
            judged = pod_review(side, "hot", operation="UPDATE", uid="uid-a")
            _record_one(side, m, judged, pid="priv",
                        result=_allow(side, "uid-a"))
            replay = pod_review(side, "hot", operation="UPDATE", uid="uid-b")
            out = [batcher.submit("priv", replay, side.origin.VALIDATE)
                   .result(timeout=30).to_dict()]
            out.append(batcher.stats_snapshot()["matrix_lookup_hits"])
            create = pod_review(side, "hot", operation="CREATE", uid="uid-c")
            out.append(batcher.submit("priv", create, side.origin.VALIDATE)
                       .result(timeout=30).to_dict())
            out.append(batcher.stats_snapshot()["matrix_lookup_hits"])
            results = batcher.submit_audit([("priv", replay)]).result(timeout=30)
            out.append(results[0].to_dict())
            bulk = batcher.submit_many(
                [("priv", pod_review(side, "hot", operation="UPDATE",
                                     uid=f"uid-m{i}")) for i in range(3)],
                side.origin.VALIDATE,
            )
            out.append([f.result(timeout=30).to_dict() for f in bulk])
            snap = batcher.stats_snapshot()
            out.append((snap["matrix_lookup_hits"],
                        snap["matrix_lookup_misses"]))
            return out
        finally:
            batcher.shutdown()

    out = both(case)
    assert out[0]["uid"] == "uid-b" and out[0]["allowed"] is True
    assert out[1] == out[3] == 1
    assert out[6] == (4, 0)


# ---------------------------------------------------------------------------
# the HTTP surface: NDJSON stream + ETag/304
# ---------------------------------------------------------------------------


SERVER_SPECS = {"pod-privileged": {"module": "builtin://pod-privileged"}}


@pytest.fixture(scope="module")
def matrix_pair():
    pair = Pair(
        SERVER_SPECS, audit_mode="interval", audit_interval_seconds=60.0,
        audit_batch_size=8, audit_matrix=True,
    )
    yield pair
    pair.stop()


def stream_lines(port: int, query: str, want: int, timeout: float = 10.0):
    """Read up to ``want`` NDJSON lines of GET /audit/stream (the
    connection closes after) → (status, content type, lines)."""
    conn = HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", f"/audit/stream{query}")
        resp = conn.getresponse()
        if resp.status != 200:
            return resp.status, resp.getheader("Content-Type"), [
                json.loads(resp.read())
            ]
        lines = []
        while len(lines) < want:
            raw = resp.fp.readline().strip()
            if raw == b"0" or not raw and resp.fp.peek(1) == b"":
                break  # the last chunk, or the server closed
            if not raw.startswith(b"{"):
                continue  # a chunk's size line
            lines.append(json.loads(raw))
            if lines[-1]["type"] == "OVERFLOW":
                break
        return resp.status, resp.getheader("Content-Type"), lines
    finally:
        conn.close()


def _served_update(name: str, privileged: bool) -> bytes:
    doc = pod_doc(name, privileged=privileged, operation="UPDATE")
    return json.dumps(doc).encode()


def test_stream_delivers_sweep_verdicts_and_resumes(matrix_pair):
    def case(side_server):
        side, server, api, rp = side_server
        scanner = server.state.audit
        matrix = server.state.audit_matrix
        assert matrix is not None and scanner.matrix is matrix
        assert http(api, "POST", "/validate/pod-privileged",
                    _served_update("streamed", True))[0] == 200
        assert wait_until(lambda: scanner.snapshot.stats()["resources"] >= 1)
        v0 = matrix.version
        got = {}

        def consume():
            got["live"] = stream_lines(api, "", 1)

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        assert wait_until(lambda: matrix.stream_clients() == 1)
        scanner.sweep(full=True)
        t.join(timeout=15)
        out = {"live": got["live"]}
        out["replay"] = stream_lines(rp, f"?cursor={v0}", matrix.version - v0)
        out["bad"] = stream_lines(api, "?cursor=bogus", 1)
        if side is PORT:
            # the port's stream ends when its client goes away
            assert wait_until(lambda: matrix.stream_clients() == 0)
        return out, matrix.version - v0

    jax_obs, port_obs = (case(s) for s in matrix_pair.sides())
    assert port_obs == jax_obs
    out, emitted = port_obs
    status, ctype, lines = out["live"]
    assert (status, ctype) == (200, "application/x-ndjson")
    assert lines[0]["type"] == "VERDICT" and lines[0]["allowed"] is False
    assert out["replay"][2] == lines[:1] + out["replay"][2][1:]
    assert len(out["replay"][2]) == emitted
    assert out["bad"][0] == 422


def test_audit_reports_etag_and_304(matrix_pair):
    def case(side_server):
        side, server, api, rp = side_server
        status, headers, _b = http(api, "GET", "/audit/reports")
        etag = headers.get("ETag")
        assert status == 200 and etag.startswith('"audit-')
        not_modified = http(api, "GET", "/audit/reports",
                            headers={"If-None-Match": etag})
        assert not_modified[0] == 304
        assert not_modified[1].get("ETag") == etag and not not_modified[2]
        assert http(api, "POST", "/validate/pod-privileged",
                    _served_update("etag-fresh", False))[0] == 200
        assert wait_until(lambda: http(
            rp, "GET", "/audit/reports", headers={"If-None-Match": etag}
        )[0] == 200)
        fresh = http(rp, "GET", "/audit/reports")[1].get("ETag")
        return fresh != etag

    assert [case(s) for s in matrix_pair.sides()] == [True, True]


def test_stream_404_when_matrix_off():
    pair = Pair(SERVER_SPECS, audit_mode="interval",
                audit_interval_seconds=60.0)
    try:
        got = []
        for side, server, api, rp in pair.sides():
            assert server.state.audit_matrix is None
            for port in (api, rp):
                status, _h, body = http(port, "GET", "/audit/stream")
                got.append((side.name, status, json.loads(body)))
        assert [g[1:] for g in got[2:]] == [g[1:] for g in got[:2]]
        assert got[2][1:] == (404, {
            "message": "the verdict matrix is disabled", "status": 404,
        })
    finally:
        pair.stop()


def test_stream_client_cap_and_overflow_line():
    """At ``--audit-stream-max-clients`` a new client gets the JAX
    package's 503; a client whose bounded queue overflows gets the
    OVERFLOW line and its stream ends."""
    pair = Pair(SERVER_SPECS, audit_mode="interval",
                audit_interval_seconds=60.0, audit_matrix=True,
                audit_stream_max_clients=1)
    try:
        got = []
        for side, server, api, rp in pair.sides():
            matrix = server.state.audit_matrix
            sub = matrix.subscribe(None)  # holds the one client slot
            status, _h, body = http(rp, "GET", "/audit/stream")
            got.append((status, json.loads(body)))
            matrix.unsubscribe(sub)
            matrix.client_queue_capacity = 16
            lines: dict = {}

            def consume():
                lines["got"] = stream_lines(api, "", 10_000, timeout=20)

            t = threading.Thread(target=consume, daemon=True)
            t.start()
            assert wait_until(lambda: matrix.stream_clients() == 1)
            policies = {"pod-privileged": side.parse(
                "pod-privileged", SERVER_SPECS["pod-privileged"])}
            matrix.set_columns(policies, 0)
            for i in range(200):
                req = pod_review(side, f"of-{i}")
                matrix.record_rows([(side.audit.resource_key(req),
                                     "pod-privileged", req, side.Response(
                                         uid="u", allowed=True))], 0)
            t.join(timeout=20)
            tail = lines["got"][2][-1]
            got.append((tail["type"], matrix.stats()["changelog_dropped_clients"]))
        assert got[2:] == got[:2]
        assert got[0] == (503, {
            "message": "audit stream client cap reached (1); retry later",
            "status": 503,
        })
        assert got[1] == ("OVERFLOW", 1)
    finally:
        pair.stop()


# ---------------------------------------------------------------------------
# the cluster what-if of a reload, and the dirty-column sweep after it
# ---------------------------------------------------------------------------


def test_whatif_summary_and_dirty_column_sweep_on_a_reload(tmp_path):
    """A reload with ``--audit-matrix-whatif``: the what-if summary on
    ``lifecycle.stats()`` (changed columns, rows evaluated, verdict flips
    and their sample), the dirty-column sweep after the promotion and the
    matrix's cells are the JAX package's; the inventory comes from a JSON
    ``--audit-resources-file``."""
    objects = [
        pod_doc(f"w{i}", namespace=("blocked", "other", "default")[i % 3],
                privileged=i % 4 == 0)["request"]["object"]
        for i in range(12)
    ]
    path = tmp_path / "resources.json"
    path.write_text(json.dumps({"items": objects}))
    pair = Pair(_specs(), audit_mode="on-promote", audit_matrix=True,
                audit_matrix_whatif=True, audit_resources_file=str(path),
                audit_batch_size=8)
    try:
        got = []
        for side, server, api, rp in pair.sides():
            scanner, matrix = server.state.audit, server.state.audit_matrix
            assert wait_until(lambda: scanner.stats()["full_sweeps"] == 1)
            before = {k: v[0] for k, v in matrix.cells_snapshot().items()}
            new = _policies(side, denied=("other",))
            del new["priv"]
            new["happy"] = side.parse("happy", {"module": "builtin://always-happy"})
            assert server.lifecycle.reload(policies=new) == "promoted"
            whatif = server.lifecycle.stats()["whatif"]
            assert wait_until(lambda: scanner.stats()["dirty_sweeps"] == 1)
            stats = matrix.stats()
            got.append((whatif, stats["column_sweep_rows"],
                        stats["columns_invalidated"],
                        {f"{k}|{p}": v for (k, p), v in
                         matrix.cells_snapshot().items()},
                        len(before)))
        assert got[1] == got[0]
        whatif, column_rows, invalidated, cells, n_before = got[1]
        assert whatif["columns_changed"] == ["happy", "ns"]
        assert whatif["rows_evaluated"] == 24
        assert whatif["verdict_flips"] == 8
        assert column_rows == 24 and invalidated == 4
        assert n_before == 24 and len(cells) == 24
    finally:
        pair.stop()


# ---------------------------------------------------------------------------
# a matrix server's audit GET routes under both frontends
# ---------------------------------------------------------------------------


def test_matrix_server_routes_on_both_ports_and_frontends():
    """With ``--audit-mode interval --audit-matrix``: the readiness port
    serves the reports and the stream under either frontend, the native
    frontend's API port answers the audit GETs as the JAX package's
    native frontend does, and the stdlib frontend's as its aiohttp one."""
    from test_torch_native_frontend import exchange

    flags = dict(audit_mode="interval", audit_interval_seconds=60.0,
                 audit_matrix=True)
    got = {}
    for front in ("python", "native"):
        pair = Pair(SERVER_SPECS, frontend=front, **flags)
        try:
            for side, server, api, rp in pair.sides():
                assert wait_until(
                    lambda: server.state.audit.stats()["full_sweeps"] == 1
                )
                for port_name, port in (("api", api), ("readiness", rp)):
                    for path in ("/audit/reports", "/audit/reports/default",
                                 "/audit/stream?cursor=x"):
                        (status, headers, body), = exchange(
                            port, f"GET {path} HTTP/1.1\r\nHost: t\r\n"
                            "Connection: close\r\n\r\n".encode()
                        )
                        if body.startswith(b'{"summary"'):
                            body = report_view(json.loads(body))
                        got[front, side.name, port_name, path] = (
                            status, headers.get("content-type"), body,
                        )
        finally:
            pair.stop()
    for (front, name, port_name, path), value in got.items():
        if name == "port":
            assert value == got[front, "jax", port_name, path], (
                front, port_name, path, value,
            )
    assert got["native", "port", "api", "/audit/reports"][0].endswith("405 Method Not Allowed")
    assert got["python", "port", "api", "/audit/reports"][0].endswith("200 OK")


# ---------------------------------------------------------------------------
# native-frontend requests on the audit path
# ---------------------------------------------------------------------------


def test_native_frontend_requests_feed_the_snapshot_and_lookup_admission():
    """Requests the native frontend parsed (``WireValidateRequest``, whose
    header lacks the object's kind and name) are keyed into the audit
    snapshot and answered by lookup admission: the port under
    ``--frontend native`` gives the bodies, snapshot keys and lookup
    counts of the JAX package under its stdlib-equivalent aiohttp
    frontend. (The JAX package's own native frontend answers such an
    UPDATE 500 with the matrix on and feeds its snapshot nothing: its
    ``resource_key`` reads a ``kind`` the wire header has not got.)"""
    flags = dict(audit_mode="interval", audit_interval_seconds=60.0,
                 audit_matrix=True)
    reviews = [(f"wire-{i}", i % 3 == 0) for i in range(6)]
    jax_python = Pair(SERVER_SPECS, **flags)
    try:
        port_native = Pair(SERVER_SPECS, frontend="native", **flags)
    except BaseException:
        jax_python.stop()
        raise
    try:
        sides = (jax_python.sides()[0], port_native.sides()[1])
        got = []
        for side, server, api, rp in sides:
            scanner = server.state.audit
            bodies = [http(api, "POST", "/validate/pod-privileged",
                           _served_update(name, priv))[::2]
                      for name, priv in reviews]
            assert wait_until(lambda: scanner.snapshot.stats()["resources"]
                              == len(reviews))
            keys = sorted(k for k, _r in scanner.snapshot.rows_snapshot())
            scanner.sweep(full=False)
            again = []
            for name, priv in reviews:
                doc = json.loads(_served_update(name, priv))
                doc["request"]["uid"] += "-again"
                again.append(http(api, "POST", "/validate/pod-privileged",
                                  json.dumps(doc).encode())[::2])
            snap = server.batcher.stats_snapshot()
            got.append((bodies, keys, again, snap["matrix_lookup_hits"],
                        snap["matrix_lookup_misses"]))
        assert got[1] == got[0]
        assert got[1][3] == len(reviews)
        assert all(status == 200 for status, _b in got[1][0] + got[1][2])
    finally:
        port_native.stop()
        jax_python.stop()
