"""Crash recovery's core in the PyTorch port (``policy_server_tpu_torch/
statestore.py`` and its callers: the boot, the resolver's artifact cache,
the lifecycle's manifests and the shard router's incident journal) against
the JAX package's (``policy_server_tpu/statestore.py``).

Each case of ``tests/test_statestore.py`` but the three supervision ones
(``tests/test_torch_supervision.py`` holds those) runs ``case(pkg, dir)``
through the JAX package, then the port, each in a directory of its own,
and the two observations must be equal (tolerance 0: bytes, integers and
verdicts). Both packages' clocks are pinned where a record carries the
time, so their journals are compared byte for byte. Then the cases this
port adds: journals framed by both packages byte-equal, a state directory
written by either package opening in the other, the fingerprint that
differs across packages, ``--state-dir`` with the audit scanner (an audit
spill and a matrix journal written by either package restoring the same
rows, cells and cursors in the other; a warm audit reboot over a local
Kubernetes API held against the JAX server's, and its /metrics values),
the store errors that are logged and never raised, and a warm restart over
HTTP with the source gone and the network failpoint armed, the port's
bodies held against the JAX server's."""

from __future__ import annotations

import json
import logging
import threading
import time
import types
from pathlib import Path

import pytest

import policy_server_tpu.audit as j_audit
import policy_server_tpu.failpoints as j_failpoints
import policy_server_tpu.fetch as j_fetch
import policy_server_tpu.models as j_models
import policy_server_tpu.ops.compiler as j_compiler
import policy_server_tpu.ops.ir as j_ir
import policy_server_tpu.statestore as j_ss
from policy_server_tpu.models.policy import parse_policy_entry as j_parse
import policy_server_tpu_torch.audit as p_audit
import policy_server_tpu_torch.failpoints as p_failpoints
import policy_server_tpu_torch.fetch as p_fetch
import policy_server_tpu_torch.models as p_models
import policy_server_tpu_torch.ops.compiler as p_compiler
import policy_server_tpu_torch.ops.ir as p_ir
import policy_server_tpu_torch.statestore as p_ss
from policy_server_tpu_torch.models.policy import parse_policy_entry as p_parse

JAX = types.SimpleNamespace(
    name="jax", ss=j_ss, failpoints=j_failpoints, fetch=j_fetch,
    compiler=j_compiler, ir=j_ir, audit=j_audit, parse=j_parse,
    models=j_models,
)
PORT = types.SimpleNamespace(
    name="port", ss=p_ss, failpoints=p_failpoints, fetch=p_fetch,
    compiler=p_compiler, ir=p_ir, audit=p_audit, parse=p_parse,
    models=p_models,
)
PINNED_TIME = 1_700_000_000.25
ARTIFACT_URL = "http://r/p.tpp.json"


@pytest.fixture(autouse=True)
def clean_failpoints():
    for pkg in (JAX, PORT):
        pkg.failpoints.reset()
    yield
    for pkg in (JAX, PORT):
        pkg.failpoints.reset()


@pytest.fixture
def pinned_clock(monkeypatch):
    """Both stores stamp records with one fixed time (``time.time`` is read
    only through each module's ``time``)."""
    for pkg in (JAX, PORT):
        clock = types.SimpleNamespace(time=lambda: PINNED_TIME)
        monkeypatch.setattr(pkg.ss, "time", clock)


def both(case, tmp_path):
    """``case(pkg, dir)`` for the JAX package, then the port, each in its
    own directory: the observations (each side's directory written
    ``<dir>``) must be equal; returns the port's."""
    out = []
    for pkg in (JAX, PORT):
        d = tmp_path / pkg.name
        d.mkdir(exist_ok=True)
        out.append(_rebase(case(pkg, d), str(d)))
    assert out[0] == out[1], (out[0], out[1])
    return out[1]


def _rebase(obj, d: str):
    if isinstance(obj, str):
        return obj.replace(d, "<dir>")
    if isinstance(obj, (list, tuple)):
        return type(obj)(_rebase(o, d) for o in obj)
    if isinstance(obj, dict):
        return {_rebase(k, d): _rebase(v, d) for k, v in obj.items()}
    return obj


def quarantined(root: Path) -> list[str]:
    """The quarantine's file names without their time prefix."""
    return sorted(
        p.name.split("-", 1)[1]
        for p in (root / "quarantine").iterdir()
    )


def tree(root: Path) -> dict[str, bytes]:
    """Every file under ``root`` but the quarantine → its bytes."""
    return {
        str(p.relative_to(root)): p.read_bytes()
        for p in sorted(root.rglob("*"))
        if p.is_file() and "quarantine" not in p.parts
    }


# -- journal + atomic write mechanics ----------------------------------------


def test_atomic_write_leaves_no_temp_and_replaces(tmp_path):
    def case(pkg, d):
        p = d / "f.bin"
        pkg.ss.atomic_write_bytes(p, b"one")
        pkg.ss.atomic_write_bytes(p, b"two")
        return p.read_bytes(), [x.name for x in d.iterdir()]

    assert both(case, tmp_path) == (b"two", ["f.bin"])


def test_journal_roundtrip_and_torn_tail(tmp_path):
    def case(pkg, d):
        records = [(1, {"a": 1}), (2, {"b": "x"}), (3, {"c": [1, 2]})]
        data = pkg.ss.frame_records(records)
        whole = pkg.ss.parse_records(data)
        torn = pkg.ss.parse_records(data[:-3])
        return data, whole, torn

    data, whole, torn = both(case, tmp_path)
    assert whole == ([(1, {"a": 1}), (2, {"b": "x"}), (3, {"c": [1, 2]})], False)
    assert torn[1] is True and len(torn[0]) == 2


def test_manifest_persist_reload_and_retention(tmp_path, pinned_clock):
    def case(pkg, d):
        s = pkg.ss.StateStore(d)
        for epoch in range(5):
            s.persist_manifest(
                "default", epoch=epoch, outcome="promoted",
                policy_ids=[f"p{epoch}"], policies_yaml=f"v: {epoch}\n",
            )
        s2 = pkg.ss.StateStore(d)
        return s2.last_good_manifest("default"), s2.stats(), tree(d)

    m, stats, _files = both(case, tmp_path)
    assert m["epoch"] == 4 and m["policy_ids"] == ["p4"]
    assert stats["journal_records"] == 2


def test_manifest_is_per_tenant(tmp_path, pinned_clock):
    def case(pkg, d):
        s = pkg.ss.StateStore(d)
        s.persist_manifest("default", epoch=3, outcome="promoted",
                           policy_ids=["a"])
        s.persist_manifest("ten-1", epoch=7, outcome="boot", policy_ids=["b"])
        s2 = pkg.ss.StateStore(d)
        return [s2.last_good_manifest(t) for t in ("default", "ten-1", "ten-2")]

    got = both(case, tmp_path)
    assert [m and m["epoch"] for m in got] == [3, 7, None]


# -- the corrupt-manifest fuzz -----------------------------------------------


def _seed_store(pkg, d: Path) -> tuple[Path, list]:
    s = pkg.ss.StateStore(d)
    valid = []
    for epoch in (0, 1):
        s.persist_manifest(
            "default", epoch=epoch, outcome="promoted",
            policy_ids=[f"p{epoch}"], policies_yaml=f"set: {epoch}\n",
        )
        valid.append(
            (epoch, s.last_good_manifest("default")["policies_digest"])
        )
    return d / pkg.ss.StateStore.MANIFESTS_JOURNAL, valid


def _last_good_or_cold(pkg, d: Path, valid) -> int | None:
    m = pkg.ss.StateStore(d).last_good_manifest("default")
    if m is None:
        return None
    assert (m["epoch"], m["policies_digest"]) in valid, m
    return m["epoch"]


def test_fuzz_manifest_byte_flips(tmp_path, pinned_clock):
    def case(pkg, d):
        journal, valid = _seed_store(pkg, d)
        pristine = journal.read_bytes()
        outcomes = []
        for pos in range(len(pristine)):
            damaged = bytearray(pristine)
            damaged[pos] ^= 0xFF
            journal.write_bytes(bytes(damaged))
            outcomes.append(_last_good_or_cold(pkg, d, valid))
            journal.write_bytes(pristine)
        return outcomes

    outcomes = both(case, tmp_path)
    assert outcomes.count(0) > 0 and outcomes.count(None) > 0
    assert outcomes.count(1) == 0


def test_fuzz_manifest_truncations(tmp_path, pinned_clock):
    def case(pkg, d):
        journal, valid = _seed_store(pkg, d)
        pristine = journal.read_bytes()
        outcomes = []
        for cut in range(len(pristine)):
            journal.write_bytes(pristine[:cut])
            outcomes.append(_last_good_or_cold(pkg, d, valid))
            journal.write_bytes(pristine)
        return outcomes, _last_good_or_cold(pkg, d, valid)

    outcomes, untouched = both(case, tmp_path)
    assert None in outcomes and 0 in outcomes and untouched == 1


def test_fsck_quarantines_and_salvages(tmp_path, pinned_clock):
    def case(pkg, d):
        journal, _valid = _seed_store(pkg, d)
        data = bytearray(journal.read_bytes())
        data[-10] ^= 0x01
        journal.write_bytes(bytes(data))
        s = pkg.ss.StateStore(d)
        third = pkg.ss.StateStore(d).stats()["fsck_quarantined"]
        return (s.last_good_manifest("default")["epoch"],
                s.stats()["fsck_quarantined"], quarantined(d), third,
                journal.read_bytes())

    epoch, count, names, third, _salvage = both(case, tmp_path)
    assert (epoch, count, names, third) == (0, 1, ["manifests.journal"], 0)


def test_stray_tmp_files_are_swept(tmp_path):
    def case(pkg, d):
        pkg.ss.StateStore(d)
        (d / "manifests.journal.tmp.1234").write_bytes(b"torn")
        s = pkg.ss.StateStore(d)
        return (s.stats()["fsck_quarantined"],
                (d / "manifests.journal.tmp.1234").exists())

    assert both(case, tmp_path) == (1, False)


# -- artifact cache ----------------------------------------------------------


def test_artifact_cache_roundtrip_and_pinning(tmp_path, pinned_clock):
    def case(pkg, d):
        s = pkg.ss.StateStore(d)
        digest = s.record_artifact(ARTIFACT_URL, b"bundle-bytes")
        path = s.cached_artifact(ARTIFACT_URL)
        s.persist_manifest(
            "default", epoch=0, outcome="boot", policy_ids=["p"],
            policies_yaml="p: 1\n", artifact_digests={ARTIFACT_URL: digest},
        )
        s2 = pkg.ss.StateStore(d)
        return (digest, str(path), path.read_bytes(),
                s2.pinned_digests("default", "p: 1\n"),
                s2.pinned_digests("default", "p: 2\n"),
                s2.pinned_digests("default", None), tree(d))

    digest, _p, data, pinned, changed, none, _files = both(case, tmp_path)
    assert data == b"bundle-bytes" and pinned == {ARTIFACT_URL: digest}
    assert changed == {} and none == {}


def test_artifact_bitflip_quarantined_never_loads(tmp_path):
    def case(pkg, d):
        s = pkg.ss.StateStore(d)
        digest = s.record_artifact(ARTIFACT_URL, b"bundle-bytes")
        blob = d / pkg.ss.StateStore.ARTIFACTS_DIR / digest
        data = bytearray(blob.read_bytes())
        data[0] ^= 0xFF
        blob.write_bytes(bytes(data))
        s2 = pkg.ss.StateStore(d)
        return (s2.cached_artifact(ARTIFACT_URL),
                s2.stats()["fsck_quarantined"], quarantined(d))

    hit, count, names = both(case, tmp_path)
    assert hit is None and count >= 1 and len(names) == 1


def test_fingerprint_is_stable_and_sensitive(tmp_path):
    def case(pkg, d):
        fp = pkg.ss.compute_fingerprint
        a = fp({"ids": ["a", "b"], "kernel": "xla"})
        return (a, a == fp({"kernel": "xla", "ids": ["a", "b"]}),
                a == fp({"ids": ["a"], "kernel": "xla"}))

    _a, stable, collides = both(case, tmp_path)
    assert stable and not collides


def test_artifact_sidecar_travels_into_the_cache(tmp_path):
    def case(pkg, d):
        s = pkg.ss.StateStore(d)
        digest = s.record_artifact(
            ARTIFACT_URL, b"bundle-bytes", sidecar=b'{"signatures": []}'
        )
        blob = s.cached_artifact(ARTIFACT_URL)
        sidecar = blob.with_name(blob.name + ".sig.json")
        s2 = pkg.ss.StateStore(d)
        return (sidecar.read_bytes(), s2.stats()["fsck_quarantined"],
                s2.stats()["artifacts_resident"],
                s2.cached_artifact(ARTIFACT_URL) == blob, digest in blob.name)

    assert both(case, tmp_path) == (b'{"signatures": []}', 0, 1, True, True)


def test_pinned_digest_survives_lost_urlmap(tmp_path):
    def case(pkg, d):
        s = pkg.ss.StateStore(d)
        digest = s.record_artifact(ARTIFACT_URL, b"bundle-bytes")
        (d / pkg.ss.StateStore.URLMAP_JOURNAL).unlink()
        s2 = pkg.ss.StateStore(d)
        unpinned = s2.cached_artifact(ARTIFACT_URL)
        pinned = s2.cached_artifact(ARTIFACT_URL, digest=digest)
        return unpinned, pinned.read_bytes()

    assert both(case, tmp_path) == (None, b"bundle-bytes")


def test_quarantined_temp_files_are_not_requarantined(tmp_path):
    def case(pkg, d):
        pkg.ss.StateStore(d)
        (d / "manifests.journal.tmp.1.0").write_bytes(b"torn")
        counts = [pkg.ss.StateStore(d).stats()["fsck_quarantined"]
                  for _ in range(3)]
        return counts, quarantined(d)

    assert both(case, tmp_path) == ([1, 0, 0], ["manifests.journal.tmp.1.0"])


# -- audit spill ---------------------------------------------------------------


def _pod_object(i: int, privileged: bool = False, namespace: str = "ns") -> dict:
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": f"p{i}", "namespace": namespace, "uid": f"u{i}"},
        "spec": {"containers": [{
            "name": "c", "image": "nginx:1.25",
            "securityContext": {"privileged": privileged},
        }]},
    }


def test_audit_spill_roundtrip_with_snapshot_store(tmp_path, pinned_clock):
    """``tests/test_statestore.py``'s case: five synthetic rows spill with
    their cursor and fed map, and restore with byte-identical payloads;
    the journals the two packages write are the same bytes."""
    def case(pkg, d):
        snapshot = pkg.audit.snapshot
        store = snapshot.SnapshotStore()
        store.observe([
            snapshot.synthesize_review(
                {"apiVersion": "v1", "kind": "Pod",
                 "metadata": {"name": f"p{i}", "namespace": "ns"}},
                "CREATE", uid=f"u{i}",
            )
            for i in range(5)
        ])
        s = pkg.ss.StateStore(d)
        n = s.spill_audit(
            {"v1/Pod": "1234"},
            {"v1/Pod": {("uid", "u0"): "/v1/Pod/ns/p0"}},
            store.export_rows(),
        )
        loaded = pkg.ss.StateStore(d).load_audit_spill()
        restored = snapshot.SnapshotStore()
        count = restored.restore_rows(loaded["rows"])
        assert dict(restored.export_rows()) == dict(store.export_rows())
        return (n, loaded["rvs"], loaded["fed"], count,
                sorted(restored.export_rows()), tree(d))

    n, rvs, fed, count, rows, _files = both(case, tmp_path)
    assert n == 5 and count == 5 and len(rows) == 5
    assert rvs == {"v1/Pod": "1234"}
    assert fed["v1/Pod"] == {("uid", "u0"): "/v1/Pod/ns/p0"}


def test_audit_spill_torn_tail_keeps_prefix(tmp_path, pinned_clock):
    """A torn last record loses that row only; the head (the cursors)
    survives."""
    def case(pkg, d):
        s = pkg.ss.StateStore(d)
        s.spill_audit({"v1/Pod": "9"}, {}, [
            (f"k{i}", json.dumps({"i": i}).encode()) for i in range(4)
        ])
        spill = d / pkg.ss.StateStore.AUDIT_SPILL
        data = spill.read_bytes()
        spill.write_bytes(data[:-5])
        loaded = pkg.ss.StateStore(d).load_audit_spill()
        return data, loaded["rvs"], loaded["rows"]

    _data, rvs, rows = both(case, tmp_path)
    assert rvs == {"v1/Pod": "9"} and len(rows) == 3


def test_restore_skips_undecodable_rows_at_warning(tmp_path, caplog):
    """A spilled row that does not decode is skipped and counted in one
    WARNING line, in both packages; the rest restore."""
    def case(pkg, d):
        snapshot = pkg.audit.snapshot
        good = snapshot.synthesize_review(_pod_object(1), "CREATE", uid="u1")
        pairs = [("k-bad", b"{not json"), ("k-1", good.payload_json()),
                 ("k-bad2", json.dumps({"uid": 3}).encode())]
        store = snapshot.SnapshotStore()
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            n = store.restore_rows(pairs)
        return n, [r.getMessage() for r in caplog.records
                   if r.levelno == logging.WARNING]

    n, warnings = both(case, tmp_path)
    assert n == 1
    assert warnings == [
        "audit spill restore skipped 2 undecodable row(s); the next full "
        "re-LIST resync repairs the inventory"
    ]


def _audit_state(pkg, d: Path) -> None:
    """An audit spill and a matrix journal, written through the package's
    own snapshot store and verdict matrix: eight pods judged by two
    policies, one of them since changed."""
    specs = {
        "priv": {"module": "builtin://pod-privileged"},
        "ns": {"module": "builtin://namespace-validate",
               "settings": {"denied_namespaces": ["blocked"]}},
    }
    policies = {k: pkg.parse(k, v) for k, v in specs.items()}
    store = pkg.ss.StateStore(d)
    snapshot = pkg.audit.SnapshotStore()
    rows = [
        pkg.audit.snapshot.synthesize_review(
            _pod_object(i, i % 3 == 0, "blocked" if i % 4 == 0 else "ns"),
            "CREATE", uid=f"u{i}",
        )
        for i in range(8)
    ]
    snapshot.observe(rows)
    matrix = pkg.audit.VerdictMatrix(snapshot=snapshot, statestore=store)
    matrix.set_columns(policies, 0)
    for i, req in enumerate(rows):
        key = pkg.audit.snapshot.resource_key(req)
        for pid in ("priv", "ns"):
            allowed = not (pid == "priv" and i % 3 == 0) and not (
                pid == "ns" and i % 4 == 0
            )
            matrix.record_rows([(key, pid, req, _response(pkg, allowed))], 0)
    store.spill_audit({"v1/Pod": "41"},
                      {"v1/Pod": {("uid", "u0"): "/v1/Pod/blocked/p0"}},
                      snapshot.export_rows())
    assert matrix.maybe_spill(force=True) is True


def _response(pkg, allowed: bool):
    if allowed:
        return pkg.models.AdmissionResponse(uid="u", allowed=True)
    return pkg.models.AdmissionResponse.reject("u", "denied", 400)


def _audit_resume(pkg, d: Path, changed: bool = False) -> tuple:
    """What a warm boot restores from ``d``: the rows, the cursors, and the
    cells a matrix over the serving policies validates (``changed``: the
    ``ns`` policy's settings differ from the spilled ones)."""
    specs = {
        "priv": {"module": "builtin://pod-privileged"},
        "ns": {"module": "builtin://namespace-validate",
               "settings": {"denied_namespaces": (
                   ["other"] if changed else ["blocked"]
               )}},
    }
    store = pkg.ss.StateStore(d)
    spill = store.load_audit_spill()
    snapshot = pkg.audit.SnapshotStore()
    restored = snapshot.restore_rows(spill["rows"])
    matrix = pkg.audit.VerdictMatrix(snapshot=snapshot, statestore=store)
    matrix.set_columns({k: pkg.parse(k, v) for k, v in specs.items()}, 0)
    cells = matrix.restore()
    return (
        store.stats()["fsck_quarantined"], restored, spill["rvs"],
        spill["fed"], sorted(snapshot.export_rows()), cells,
        matrix.cells_snapshot(), sorted(snapshot.dirty_keys()),
        matrix.stats()["cells_restored"], matrix.version,
    )


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_an_audit_state_directory_resumes_in_the_other_package(
    tmp_path, pinned_clock, writer,
):
    """An audit spill and a matrix journal written by either package
    restore the same rows, cursors and cells in the other, and the same
    journals come out of both packages byte for byte. A changed policy
    loses its column's cells in both."""
    w, r = (JAX, PORT) if writer == "jax" else (PORT, JAX)
    _audit_state(w, tmp_path / "w")
    other = tmp_path / "other"
    _audit_state(r, other)
    assert tree(tmp_path / "w") == tree(other)
    written = _audit_resume(w, tmp_path / "w")
    read = _audit_resume(r, tmp_path / "w")
    assert read == written
    assert read[0] == 0 and read[1] == 8 and read[5] == 16
    assert read[2] == {"v1/Pod": "41"} and read[7] == []
    stale = _audit_resume(r, tmp_path / "w", changed=True)
    assert stale == _audit_resume(w, tmp_path / "w", changed=True)
    assert stale[5] == 8 and {p for _k, p in stale[6]} == {"priv"}
    assert len(stale[7]) == 8  # every row still lacks its ns cell


# -- the servers: warm boot, degraded loads, manifests -----------------------


def _write_artifact_policy(pkg, d: Path) -> Path:
    ir = pkg.ir
    src = d / "deny-ns.tpp.json"
    src.write_text(json.dumps(pkg.fetch.dump_artifact(
        "deny-ns",
        [pkg.compiler.Rule(
            "denied", ir.in_set(ir.Path("namespace"), ["blocked"]),
            "namespace blocked",
        )],
    )))
    return src


class Booted:
    """One package's server booted in-process on ``d/state`` from the
    policies file (and tenants manifest), as the JAX package's tests boot
    theirs: the JAX side through ``new_from_config`` (no HTTP), the port's
    started on free ports."""

    def __init__(self, pkg, d: Path, policies_path: Path, tenants_path=None):
        self.pkg = pkg
        if pkg is JAX:
            from policy_server_tpu.config.config import (
                Config,
                TlsConfig,
                read_policies_file,
            )
            from policy_server_tpu.server import PolicyServer
            from policy_server_tpu.tenancy import read_tenants_file

            cfg = Config(
                addr="127.0.0.1", port=0, readiness_probe_port=0,
                tls_config=TlsConfig(),
                policies=read_policies_file(policies_path),
                policies_path=str(policies_path),
                policies_download_dir=str(d / "dl"),
                state_dir=str(d / "state"),
                policy_timeout_seconds=2.0, max_batch_size=8,
                selfheal_interval_seconds=0.0,
            )
            if tenants_path is not None:
                cfg.tenants_path = str(tenants_path)
                cfg.tenants = read_tenants_file(tenants_path)
            self.server = PolicyServer.new_from_config(cfg)
        else:
            from policy_server_tpu_torch.server import (
                PolicyServer,
                read_policies_source,
            )
            from policy_server_tpu_torch.tenancy import read_tenants_file

            policies, text = read_policies_source(str(policies_path))
            self.server = PolicyServer(
                policies, port=0, readiness_probe_port=0, device="cpu",
                policies_path=str(policies_path), policies_text=text,
                policies_download_dir=str(d / "dl"),
                state_dir=str(d / "state"),
                policy_timeout=2.0, max_batch_size=8,
                selfheal_interval_seconds=0.0,
                tenants=(
                    read_tenants_file(tenants_path) if tenants_path else None
                ),
            )
            self.server.start()
        self.state = self.server.state

    def validate(self, policy_id: str, namespace: str, batcher=None):
        """(allowed, message) of a pod in ``namespace``."""
        if self.pkg is JAX:
            from policy_server_tpu.models import (
                AdmissionRequest,
                GroupVersionKind,
                ValidateRequest,
            )
        else:
            from policy_server_tpu_torch.models import (
                AdmissionRequest,
                GroupVersionKind,
                ValidateRequest,
            )
        req = ValidateRequest.from_admission(AdmissionRequest(
            uid="t", kind=GroupVersionKind(group="", version="v1", kind="Pod"),
            name="p", namespace=namespace, operation="CREATE",
            user_info={"username": "t"},
            object={"apiVersion": "v1", "kind": "Pod",
                    "metadata": {"name": "p", "namespace": namespace},
                    "spec": {"containers": [{"name": "c", "image": "nginx"}]}},
        ))
        env = (batcher or self.state.batcher).env
        [resp] = env.validate_batch([(policy_id, req)], run_hooks=False)
        return resp.allowed, (resp.status.message if resp.status else None)

    def stop(self) -> None:
        if self.pkg is JAX:
            if self.state.tenants is not None:
                self.state.tenants.shutdown()
            self.server.lifecycle.shutdown()
        else:
            self.server.stop()


def _report(report: dict) -> dict:
    """A boot report without its timing."""
    return {k: v for k, v in report.items() if k != "time_to_ready_seconds"}


def _registry_outage(pkg):
    def raise_():
        raise pkg.failpoints.FailpointError("registry outage")

    return pkg.failpoints.active("fetch.http", raise_)


def test_warm_boot_serves_pinned_artifacts_with_source_gone(tmp_path):
    def case(pkg, d):
        src = _write_artifact_policy(pkg, d)
        policies_path = d / "policies.yml"
        policies_path.write_text(
            f"deny-ns:\n  module: file://{src}\n"
            "priv:\n  module: builtin://pod-privileged\n"
        )
        s1 = Booted(pkg, d, policies_path)
        try:
            cold = (s1.state.boot_report["warm"],
                    s1.validate("deny-ns", "blocked"),
                    s1.validate("deny-ns", "default"))
        finally:
            s1.stop()
        src.unlink()
        with _registry_outage(pkg):
            s2 = Booted(pkg, d, policies_path)
        try:
            report = s2.state.boot_report
            warm = (report["warm"], report["artifacts_from_cache"],
                    report["degraded_sources"], report["fingerprint_match"],
                    s2.validate("deny-ns", "blocked"),
                    s2.validate("deny-ns", "default"))
        finally:
            s2.stop()
        return cold, warm

    cold, warm = both(case, tmp_path)
    assert cold == (False, (False, "namespace blocked"), (True, None))
    assert warm == (True, 1, 0, True, (False, "namespace blocked"),
                    (True, None))


def test_changed_config_degrades_loudly_to_last_good_on_fetch_failure(
    tmp_path,
):
    def case(pkg, d):
        src = _write_artifact_policy(pkg, d)
        policies_path = d / "policies.yml"
        policies_path.write_text(f"deny-ns:\n  module: file://{src}\n")
        Booted(pkg, d, policies_path).stop()
        policies_path.write_text(
            f"deny-ns:\n  module: file://{src}\n"
            "extra:\n  module: builtin://always-happy\n"
        )
        src.unlink()
        s2 = Booted(pkg, d, policies_path)
        try:
            return (s2.state.boot_report["degraded_sources"],
                    s2.validate("deny-ns", "blocked"))
        finally:
            s2.stop()

    assert both(case, tmp_path) == (1, (False, "namespace blocked"))


def test_manifest_tracks_promotions_and_rollbacks(tmp_path):
    def case(pkg, d):
        policies_path = d / "policies.yml"
        policies_path.write_text("priv:\n  module: builtin://pod-privileged\n")
        srv = Booted(pkg, d, policies_path)
        parse = j_parse if pkg is JAX else p_parse
        seen = []
        try:
            store = srv.state.statestore
            seen.append(store.last_good_manifest()["outcome"])
            srv.server.lifecycle.reload(policies={
                "priv": parse("priv", {"module": "builtin://pod-privileged"}),
                "happy": parse("happy", {"module": "builtin://always-happy"}),
            }, reason="test")
            m = store.last_good_manifest()
            seen.append((m["outcome"], m["epoch"], m["policy_ids"]))
            srv.server.lifecycle.rollback()
            m = store.last_good_manifest()
            seen.append((m["outcome"], m["epoch"]))
            seen.append(
                pkg.ss.StateStore(d / "state").last_good_manifest()["epoch"]
            )
        finally:
            srv.stop()
        return seen

    assert both(case, tmp_path) == [
        "boot", ("promoted", 1, ["happy", "priv"]), ("rolled-back", 0), 0,
    ]


def test_tenant_boot_degrades_to_last_good_manifest(tmp_path):
    def case(pkg, d):
        (d / "tenant-policies.yml").write_text(
            "tpriv:\n  module: builtin://pod-privileged\n"
        )
        tenants_yml = d / "tenants.yml"
        tenants_yml.write_text(
            "tenants:\n  ten-a:\n    policies: tenant-policies.yml\n"
        )
        policies_path = d / "policies.yml"
        policies_path.write_text("priv:\n  module: builtin://pod-privileged\n")
        Booted(pkg, d, policies_path, tenants_yml).stop()
        persisted = pkg.ss.StateStore(d / "state").last_good_manifest("ten-a")

        def boom():
            raise pkg.failpoints.FailpointError("tenant manifest unreadable")

        with pkg.failpoints.active("tenant.reload", boom):
            srv2 = Booted(pkg, d, policies_path, tenants_yml)
        try:
            ten = srv2.state.tenants.get("ten-a")
            return (persisted is not None,
                    "tpriv" in ten.state.evaluation_environment.policy_ids(),
                    srv2.state.boot_report["degraded_sources"],
                    ten.readiness()[0],
                    srv2.validate("tpriv", "default",
                                  batcher=ten.state.batcher))
        finally:
            srv2.stop()

    assert both(case, tmp_path) == (True, True, 1, 200, (True, None))


def test_manifest_persists_the_yaml_the_reload_actually_read(tmp_path):
    def case(pkg, d):
        policies_path = d / "policies.yml"
        v1 = "priv:\n  module: builtin://pod-privileged\n"
        policies_path.write_text(v1)
        srv = Booted(pkg, d, policies_path)
        try:
            lifecycle = srv.server.lifecycle
            orig_read = lifecycle._read_policies

            def racy_read():
                result = orig_read()
                policies_path.write_text(
                    "rogue:\n  module: builtin://always-unhappy\n"
                )
                return result

            lifecycle._read_policies = racy_read
            lifecycle.reload(reason="toctou-test")
            m = srv.state.statestore.last_good_manifest()
            return m["epoch"], m["policies_yaml"] == v1, m["policy_ids"]
        finally:
            srv.stop()

    assert both(case, tmp_path) == (1, True, ["priv"])


# -- the same bytes on disk, and each package's directory in the other ------


def _write_everything(pkg, d: Path) -> None:
    """Every record kind the store writes, the same in both packages."""
    s = pkg.ss.StateStore(d)
    digest = s.record_artifact(ARTIFACT_URL, b"bundle-bytes",
                               sidecar=b'{"signatures": []}')
    s.record_artifact("file:///m/other.wasm", b"\0asm-bytes")
    for tenant, epoch in (("default", 0), ("default", 1), ("ten-a", 0)):
        s.persist_manifest(
            tenant, epoch=epoch, outcome="promoted" if epoch else "boot",
            policy_ids=["p", "q"], policies_yaml=f"p: {epoch}\n",
            artifact_digests={ARTIFACT_URL: digest}, fingerprint="f" * 64,
        )
    s.record_shard_event({"shard": 1, "reason": "wedged dispatch",
                          "rows_rerouted": 2, "rows_fenced": 0})
    s.record_shard_event({"shard": 1, "reason": "warm-respawn"})
    s.record_boot_report({"warm": True, "time_to_ready_seconds": 1.5})
    s.spill_audit({"v1/Pod": "9"}, {"v1/Pod": {("uid", "u0"): "/p"}},
                  [("k0", b'{"i":0}'), ("k1", b'{"i":1}')])
    s.spill_matrix({"epoch": 2, "version": 5, "cols": {"p": "c"}},
                   [{"k": "k0", "p": "p", "allowed": True}])


def test_both_packages_frame_the_same_journal_bytes(tmp_path, pinned_clock):
    """The same records framed by each package are the same bytes, and so
    is every file of a state directory after the same operations: the
    artifact blobs and sidecar, the url map, the manifests, the shard
    incident log, the boot report and both spills."""
    def case(pkg, d):
        framed = pkg.ss.frame_records(
            [(1, {"a": 1, "s": "xé"}), (7, {"b": [1, 2, {"c": None}]})]
        )
        _write_everything(pkg, d)
        return framed, tree(d)

    framed, files = both(case, tmp_path)
    assert framed.startswith(b"TPSJ")
    assert set(files) >= {
        "manifests.journal", "urlmap.journal", "shard_events.json",
        "last_boot.json", "audit/spill.journal", "audit/matrix.journal",
    }


def _view(pkg, d: Path) -> tuple:
    """What a boot reads from a state directory."""
    s = pkg.ss.StateStore(d)
    blob = s.cached_artifact(ARTIFACT_URL)
    return (
        s.stats()["fsck_quarantined"],
        [s.last_good_manifest(t) for t in ("default", "ten-a", "ten-b")],
        s.pinned_digests("default", "p: 1\n"),
        blob.read_bytes(),
        blob.with_name(blob.name + ".sig.json").read_bytes(),
        s.shard_events(),
        s.load_audit_spill(),
        s.load_matrix_spill(),
        s.stats(),
    )


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_state_directory_opens_in_the_other_package(tmp_path, writer):
    """A state directory written by either package opens in the other with
    nothing quarantined, and reads as it does in the package that wrote
    it."""
    w, r = (JAX, PORT) if writer == "jax" else (PORT, JAX)
    _write_everything(w, tmp_path)
    written = _view(w, tmp_path)
    read = _view(r, tmp_path)
    assert read[0] == 0 and written[0] == 0
    assert read == written
    assert read[1][0]["epoch"] == 1 and read[1][2] is None


def test_the_fingerprint_differs_across_packages(tmp_path):
    """One policy set, one state directory: each package finds the other's
    last-good manifest (the boot is warm, the pinned artifact loads from
    the cache with the source gone and the registry failpoint armed), but
    its fingerprint does not match: the JAX package's names jax and its
    kernel, the port's torch, CUDA and the CUDA kernel."""
    src = _write_artifact_policy(JAX, tmp_path)
    policies_path = tmp_path / "policies.yml"
    policies_path.write_text(
        f"deny-ns:\n  module: file://{src}\n"
        "priv:\n  module: builtin://pod-privileged\n"
    )
    reports = {}
    for pkg in (JAX, PORT, PORT, JAX):
        with _registry_outage(pkg):
            srv = Booted(pkg, tmp_path, policies_path)
        try:
            reports.setdefault(pkg.name, []).append(
                (_report(srv.state.boot_report),
                 srv.validate("deny-ns", "blocked"))
            )
        finally:
            srv.stop()
        src.unlink(missing_ok=True)
    first_jax, second_jax = reports["jax"]
    first_port, second_port = reports["port"]
    assert first_jax[0]["warm"] is False
    # the port after the JAX package, and the JAX package after the port:
    # warm, served from the cache, fingerprint mismatched
    for report, verdict in (first_port, second_jax):
        assert report["warm"] is True and report["fingerprint_match"] is False
        assert report["artifacts_from_cache"] == 1
        assert report["degraded_sources"] == 0 and report["fsck_quarantined"] == 0
        assert verdict == (False, "namespace blocked")
    # the port after itself: the fingerprint matches
    assert second_port[0]["fingerprint_match"] is True
    assert second_port[0]["artifacts_from_cache"] == 1


# -- --state-dir with the audit scanner ---------------------------------------


@pytest.mark.parametrize("audit_flags", [
    ["--audit-mode", "interval"],
    ["--audit-mode", "on-promote"],
    ["--audit-mode", "interval", "--audit-watch"],
    ["--audit-mode", "interval", "--audit-matrix"],
])
def test_state_dir_with_the_audit_scanner_is_refused(tmp_path, audit_flags):
    """The combination the port refused until its audit spill was ported
    now boots, as the JAX package's does: a cold boot judges the seeded
    pod, and a second boot on the same directory is warm; with
    ``--audit-matrix`` it restores the spilled cell (the scanner's stop
    spilled it) and its boot sweep judges nothing. Without a Kubernetes
    API, ``--audit-watch`` boots with the ignore flag and no feed."""
    from policy_server_tpu_torch import __main__ as cli

    policies = tmp_path / "p.json"
    policies.write_text(json.dumps({"p": {"module": "builtin://pod-privileged"}}))
    seed = tmp_path / "seed.json"
    seed.write_text(json.dumps([_pod_object(1, privileged=True)]))
    state = tmp_path / "state"
    argv = ["--policies", str(policies), "--port", "0",
            "--readiness-probe-port", "0", "--device", "cpu", "--no-warmup",
            "--state-dir", str(state), "--audit-resources-file", str(seed),
            "--audit-interval-seconds", "0.2"] + audit_flags
    if "--audit-watch" in audit_flags:
        argv.append("--ignore-kubernetes-connection-failure")
    reports, scanned = [], []
    for _boot in ("cold", "warm"):
        server = cli.server_from_args(cli.build_cli().parse_args(argv))
        try:
            server.start()
            scanner = server.state.audit

            def swept() -> bool:
                stats = scanner.stats()
                return (stats["full_sweeps"] + stats["dirty_sweeps"] >= 1
                        and not scanner.snapshot.dirty_keys())

            assert wait_until(swept)
            reports.append(dict(server.state.boot_report))
            scanned.append(scanner.stats()["rows_scanned"])
        finally:
            server.stop()
    cold, warm = reports
    assert cold["warm"] is False and warm["warm"] is True
    assert (state / "last_boot.json").exists()
    assert "audit_rows_restored" not in warm  # no feed, no audit spill
    if "--audit-matrix" in audit_flags:
        assert cold["matrix_cells_restored"] == 0
        assert warm["matrix_cells_restored"] == 1
        assert (state / "audit" / "matrix.journal").exists()
        assert scanned == [1, 0]
    else:
        assert "matrix_cells_restored" not in warm
        assert scanned == [1, 1]


def wait_until(cond, timeout=30.0, interval=0.05) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return bool(cond())


AUDIT_SPECS = {
    "priv": {"module": "builtin://pod-privileged"},
    "ns": {"module": "builtin://namespace-validate",
           "settings": {"denied_namespaces": ["blocked"]}},
}
AUDIT_PODS = 24
CHANGED_WHILE_DOWN = (1, 2, 5)
DELETED_WHILE_DOWN = 7


class AuditServer:
    """One package's server with the audit scanner, its verdict matrix and
    the live watch feed on ``d/state``, from its configuration (the JAX
    package's) or its command line (the port's, on the CPU); no spill
    cadence fires (3,600 s), so only a stop spills the snapshot and only
    the first sweep's tail and the stop spill the matrix."""

    def __init__(self, pkg, d: Path, policies_path: Path) -> None:
        self.pkg = pkg
        if pkg is JAX:
            from torch_port_support import JaxServer

            self.handle = JaxServer(
                AUDIT_SPECS, state_dir=str(d / "state"), enable_metrics=True,
                policies_path=str(policies_path),
                audit_mode="interval", audit_interval_seconds=0.2,
                audit_matrix=True, audit_watch=True,
                audit_watch_resources="v1/Pod", context_refresh_seconds=1.0,
                state_audit_spill_seconds=3600.0,
                audit_matrix_spill_seconds=3600.0,
            )
            self.server = self.handle.server
            self.readiness_port = self.handle.readiness_port
        else:
            from policy_server_tpu_torch import __main__ as cli

            self.server = cli.server_from_args(cli.build_cli().parse_args([
                "--policies", str(policies_path), "--port", "0",
                "--readiness-probe-port", "0", "--device", "cpu",
                "--no-warmup", "--enable-metrics",
                "--state-dir", str(d / "state"),
                "--audit-mode", "interval", "--audit-interval-seconds", "0.2",
                "--audit-matrix", "--audit-watch",
                "--audit-watch-resources", "v1/Pod",
                "--context-refresh-seconds", "1",
                "--state-audit-spill-seconds", "3600",
                "--audit-matrix-spill-seconds", "3600",
            ]))
            self.server.start()
            self.readiness_port = self.server.readiness_port
        self.state = self.server.state
        self.scanner = self.state.audit

    def settled(self, rows: int, scanned: int) -> bool:
        """The scanner has swept at least once, the matrix holds every
        row's two cells, nothing is dirty, and the scanner has judged
        ``scanned`` (row, policy) pairs."""
        snap = self.scanner.snapshot
        stats = self.scanner.stats()
        return (
            stats["full_sweeps"] + stats["dirty_sweeps"] >= 1
            and len(snap) == rows and not snap.dirty_keys()
            and self.scanner.matrix.stats()["cells_resident"] == 2 * rows
            and stats["rows_scanned"] == scanned
        )

    def families(self) -> dict:
        import urllib.request

        text = urllib.request.urlopen(
            f"http://127.0.0.1:{self.readiness_port}/metrics", timeout=10
        ).read().decode()
        names = ("policy_server_statestore_audit_spills_total",
                 "policy_server_statestore_audit_rows_restored",
                 "policy_server_audit_matrix_spills_total",
                 "policy_server_audit_matrix_cells_restored")
        return {
            line.split(" ")[0]: float(line.split(" ")[1])
            for line in text.splitlines() if line.split(" ")[0] in names
        }

    def stop(self) -> None:
        (self.handle if self.pkg is JAX else self.server).stop()


def _audit_view(srv: AuditServer) -> tuple:
    """The compliance a server holds: its matrix cells and report rows."""
    cells = {
        f"{k}|{p}": v[0]
        for (k, p), v in srv.scanner.matrix.cells_snapshot().items()
    }
    reports = sorted(
        (r["name"], r["policy_id"], r["allowed"], r["stale"])
        for r in srv.scanner.report_payload()["reports"]
    )
    return cells, reports


@pytest.mark.parametrize("changed", [False, True],
                         ids=["unchanged", "changed"])
def test_warm_audit_reboot_resumes_from_the_spill(tmp_path, monkeypatch,
                                                  changed):
    """A warm reboot with the audit scanner, its matrix and the watch feed
    over a local Kubernetes API, through each package: the cold boot LISTs
    and judges every (pod, policy) cell; a clean stop spills the snapshot
    with its cursor and the matrix; while the server is down the API takes
    nothing, or three MODIFIED events and one DELETED. The warm boot
    restores every row and every cell, LISTs nothing, resumes the watch
    from the cursor and re-judges exactly the changed pods (none over an
    unchanged inventory); its matrix, report rows, counters and /metrics
    values are the JAX server's, and its cells are the verdicts of a JAX
    oracle over the API's objects."""
    modified = CHANGED_WHILE_DOWN if changed else ()
    import policy_server_tpu.context.service as j_service
    import policy_server_tpu_torch.context.service as p_service
    import torch_fetch_fixtures as fx

    def case(pkg, d):
        api = fx.KubeApi(d / "kube")
        path = fx.list_path("v1", "Pod")
        pods = [_pod_object(i, i % 3 == 0, "blocked" if i % 4 == 0 else "ns")
                for i in range(AUDIT_PODS)]
        api.register(path, pods)
        sa = api.write_service_account(d / "sa")
        monkeypatch.setattr(p_service, "SERVICE_ACCOUNT_DIR", sa)
        monkeypatch.setattr(p_service, "KUBE_API_SERVER", api.url)
        monkeypatch.setattr(j_service, "SERVICE_ACCOUNT_DIR", sa)
        monkeypatch.setattr(
            j_service.KubeApiFetcher.__init__, "__defaults__",
            (api.url, None, None, False),
        )
        policies_path = d / "policies.json"
        policies_path.write_text(json.dumps(AUDIT_SPECS))
        seen = []
        try:
            srv = AuditServer(pkg, d, policies_path)
            try:
                assert wait_until(
                    lambda: srv.settled(AUDIT_PODS, 2 * AUDIT_PODS)
                ), srv.scanner.stats()
                cold = _audit_view(srv)
                seen.append(api.lists.get(path, 0))
            finally:
                srv.stop()
            for i in modified:
                api.modify(path, _pod_object(i, True, "ns"))
            if changed:
                api.delete(path, pods[DELETED_WHILE_DOWN])
            api.lists.clear()
            srv = AuditServer(pkg, d, policies_path)
            try:
                report = srv.state.boot_report
                seen.append({k: report.get(k) for k in (
                    "warm", "audit_rows_restored", "matrix_cells_restored",
                )})
                assert wait_until(lambda: srv.settled(
                    AUDIT_PODS - changed, 2 * len(modified)
                )), srv.scanner.stats()
                warm = _audit_view(srv)
                stats = srv.scanner.matrix.stats()
                seen += [
                    api.lists.get(path, 0),
                    srv.scanner.stats()["rows_scanned"],
                    {k: stats[k] for k in (
                        "cells_restored", "row_sweep_rows",
                        "column_sweep_rows", "cells_resident", "spills",
                    )},
                    srv.state.audit_watch.stats()["events_applied"],
                    warm, srv.families(),
                ]
            finally:
                srv.stop()
        finally:
            api.stop()
        return cold, seen, api.list(path)[0]

    cold, seen, objects = both(case, tmp_path)
    from policy_server_tpu.audit.snapshot import resource_key, synthesize_review
    from torch_port_support import jax_env

    oracle = jax_env(AUDIT_SPECS, backend="oracle")
    want = {}
    for obj in objects:
        req = synthesize_review(obj, "UPDATE")
        for pid in AUDIT_SPECS:
            want[f"{resource_key(req)}|{pid}"] = oracle.validate(pid, req).allowed
    cold_lists, report, warm_lists, scanned, mstats, applied, warm, fams = seen
    assert cold_lists == 1 and warm_lists == 0
    assert report == {"warm": True, "audit_rows_restored": AUDIT_PODS,
                      "matrix_cells_restored": 2 * AUDIT_PODS}
    assert scanned == 2 * len(modified)
    assert applied == (len(modified) + 1 if changed else 0)
    assert mstats["row_sweep_rows"] == 2 * len(modified)
    assert mstats["column_sweep_rows"] == 0
    assert mstats["cells_restored"] == 2 * AUDIT_PODS
    assert len(cold[0]) == 2 * AUDIT_PODS and len(cold[1]) == 2 * AUDIT_PODS
    assert warm[0] == want
    # only the re-judged pods have report rows: the report store is not
    # spilled (in either package); the matrix carries the rest
    assert {name for name, *_ in warm[1]} == {f"p{i}" for i in modified}
    assert fams == {
        "policy_server_statestore_audit_spills_total": 0.0,
        "policy_server_statestore_audit_rows_restored": float(AUDIT_PODS),
        "policy_server_audit_matrix_spills_total": float(mstats["spills"]),
        "policy_server_audit_matrix_cells_restored": float(2 * AUDIT_PODS),
    }


# -- the store errors that are logged, never raised --------------------------


def _errors(caplog, text: str) -> list[str]:
    return [
        rec.getMessage() for rec in caplog.records
        if rec.levelno >= logging.ERROR and text in rec.getMessage()
    ]


def test_failed_manifest_persist_is_logged_and_the_promotion_stands(
    tmp_path, caplog
):
    """A manifest that cannot be persisted (a full disk) never fails the
    promotion, in either package; the port logs it at error level."""
    def case(pkg, d):
        policies_path = d / "policies.yml"
        policies_path.write_text("priv:\n  module: builtin://pod-privileged\n")
        srv = Booted(pkg, d, policies_path)
        try:
            store = srv.state.statestore

            def full_disk(*args, **kwargs):
                raise OSError(28, "No space left on device")

            store.persist_manifest = full_disk
            policies_path.write_text(
                "priv:\n  module: builtin://pod-privileged\n"
                "happy:\n  module: builtin://always-happy\n"
            )
            outcome = srv.server.lifecycle.reload(reason="full-disk")
            m = store.last_good_manifest()
            return (outcome, srv.server.lifecycle.stats()["epoch"],
                    m["outcome"], m["epoch"])
        finally:
            srv.stop()

    with caplog.at_level(logging.ERROR):
        got = both(case, tmp_path)
    assert got[1:] == (1, "boot", 0)
    # one line from each package
    assert len(_errors(caplog, "could not persist the last-good manifest")) == 2


@pytest.mark.parametrize("damage", ["torn-journal", "log-unwritable",
                                    "log-unreadable"])
def test_store_damage_is_logged_never_raised(tmp_path, caplog, damage):
    """fsck quarantining a torn journal, an incident log that cannot be
    written and one that cannot be parsed: each is logged at error level by
    the port, and each leaves the JAX package's served behaviour."""
    def case(pkg, d):
        s = pkg.ss.StateStore(d)
        if damage == "torn-journal":
            s.persist_manifest("default", epoch=0, outcome="boot",
                               policy_ids=["p"])
            journal = d / "manifests.journal"
            journal.write_bytes(journal.read_bytes()[:-3])
            s2 = pkg.ss.StateStore(d)
            return s2.stats()["fsck_quarantined"], s2.last_good_manifest()
        if damage == "log-unwritable":
            (d / "shard_events.json").mkdir()
            s.record_shard_event({"shard": 0, "reason": "probe fault"})
            return s.shard_events(), (d / "shard_events.json").is_dir()
        (d / "shard_events.json").write_bytes(b"{torn")
        return s.shard_events()

    with caplog.at_level(logging.ERROR):
        got = both(case, tmp_path)
    want, text = {
        "torn-journal": ((1, None), "statestore fsck QUARANTINED"),
        "log-unwritable": (([], True),
                           "could not write the shard incident log"),
        "log-unreadable": ([], "could not read the shard incident log"),
    }[damage]
    assert got == want
    port_lines = [
        rec for rec in caplog.records
        if rec.name == p_ss.logger.name and rec.levelno >= logging.ERROR
        and text in rec.getMessage()
        and str(tmp_path / "port") in rec.getMessage()
    ]
    assert port_lines, damage


# -- over HTTP: the warm restart, and a reload under load -------------------


class HttpServer:
    """One package's server over HTTP on a state directory, from a policies
    file: the JAX server in its event-loop thread, the port's from its
    command line on the CPU."""

    def __init__(self, pkg, d: Path, policies_path: Path, *extra: str,
                 **jax_config):
        self.pkg = pkg
        if pkg is JAX:
            from torch_port_support import JaxServer

            self.handle = JaxServer(
                json.loads(policies_path.read_text()),
                policies_path=str(policies_path),
                policies_download_dir=str(d / "dl"),
                state_dir=str(d / "state"), **jax_config,
            )
            self.server = self.handle.server
            self.port = self.handle.port
        else:
            from policy_server_tpu_torch import __main__ as cli

            self.server = cli.server_from_args(cli.build_cli().parse_args([
                "--policies", str(policies_path), "--port", "0",
                "--readiness-probe-port", "0", "--device", "cpu",
                "--policies-download-dir", str(d / "dl"),
                "--state-dir", str(d / "state"), *extra,
            ]))
            self.server.start()
            self.port = self.server.port
        self.state = self.server.state

    def post(self, policy_id: str, doc: dict) -> tuple:
        from test_torch_native_frontend import exchange, post_bytes

        status, _headers, body = exchange(
            self.port,
            post_bytes(f"/validate/{policy_id}", json.dumps(doc).encode()),
        )[0]
        return status, body

    def stop(self) -> None:
        (self.handle if self.pkg is JAX else self.server).stop()


def _pod_doc(namespace: str, privileged: bool, uid: str) -> dict:
    from conftest import build_admission_review_dict

    doc = build_admission_review_dict()
    doc["request"]["uid"] = uid
    doc["request"]["namespace"] = namespace
    doc["request"]["object"] = {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": "p", "namespace": namespace},
        "spec": {"containers": [{
            "name": "c", "image": "nginx",
            "securityContext": {"privileged": privileged},
        }]},
    }
    return doc


WARM_DOCS = [
    _pod_doc(ns, priv, f"u{i}")
    for i, (ns, priv) in enumerate(
        [("default", False), ("blocked", False), ("default", True),
         ("blocked", True), ("kube-system", False)]
    )
]


def test_warm_restart_over_http_with_the_source_gone(tmp_path):
    """Boot, serve, stop; delete the ``file://`` source, arm
    ``fetch.http=raise`` and boot again on the same state directory: the
    boot is warm, the artifact comes from the cache with no fetch, and
    every body equals the JAX server's in the same steps."""
    def case(pkg, d):
        src = _write_artifact_policy(pkg, d)
        policies_path = d / "policies.json"
        policies_path.write_text(json.dumps({
            "deny-ns": {"module": f"file://{src}"},
            "priv": {"module": "builtin://pod-privileged"},
        }))
        answers = []
        reports = []
        for boot in ("cold", "warm"):
            if boot == "warm":
                src.unlink()
                pkg.failpoints.configure("fetch.http=raise")
            srv = HttpServer(pkg, d, policies_path)
            try:
                reports.append(_report(srv.state.boot_report))
                answers.append([
                    srv.post(pid, doc)
                    for pid in ("deny-ns", "priv") for doc in WARM_DOCS
                ])
            finally:
                srv.stop()
        last_boot = json.loads((d / "state" / "last_boot.json").read_text())
        return answers, reports, _report(last_boot)

    answers, reports, last_boot = both(case, tmp_path)
    assert answers[0] == answers[1]
    assert all(status.startswith("HTTP/1.1 200") for status, _b in answers[1])
    denied = [json.loads(b)["response"]["allowed"] for _s, b in answers[1]]
    assert denied == [True, False, True, False, True,
                      True, True, False, False, True]
    cold, warm = reports
    assert cold["warm"] is False and cold["artifacts_from_cache"] == 0
    assert warm["warm"] is True and warm["artifacts_from_cache"] == 1
    assert warm["degraded_sources"] == 0 and warm["fsck_quarantined"] == 0
    assert warm["fingerprint_match"] is True and last_boot == warm


def test_statestore_armed_reload_under_load_then_warm_reboot(tmp_path):
    """Traffic across a hot reload with ``--state-dir``: every answer 200
    and the last-good manifest follows the promotion; a warm reboot with
    the registry failpoint armed carries the epoch forward; a third boot
    over a bit-flipped manifest journal quarantines it and serves. The
    observations are the JAX package's."""
    def case(pkg, d):
        policies_path = d / "policies.json"
        policies_path.write_text(json.dumps(
            {"pod-privileged": {"module": "builtin://pod-privileged"}}
        ))
        extra = ("--policy-timeout", "5", "--max-batch-size", "4",
                 "--selfheal-interval-seconds", "0.2")
        jax_config = dict(policy_timeout_seconds=5.0, max_batch_size=4,
                          selfheal_interval_seconds=0.2)
        srv = HttpServer(pkg, d, policies_path, *extra, **jax_config)
        stop = threading.Event()
        statuses: list[str] = []

        def client() -> None:
            doc = _pod_doc("default", False, "load")
            while not stop.is_set():
                statuses.append(srv.post("pod-privileged", doc)[0])

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(2)]
        seen = []
        try:
            for t in threads:
                t.start()
            store = srv.state.statestore
            seen.append(store.last_good_manifest()["outcome"])
            policies_path.write_text(json.dumps({
                "pod-privileged": {"module": "builtin://pod-privileged"},
                "happy": {"module": "builtin://always-happy"},
            }))
            assert srv.server.lifecycle.request_reload("chaos")
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                m = store.last_good_manifest()
                if m["outcome"] == "promoted" and m["epoch"] >= 1:
                    break
                time.sleep(0.1)
            m = store.last_good_manifest()
            # the file watcher may land a second reload of the same file
            # (in both packages), so the epoch is at least 1
            seen.append((m["outcome"], m["epoch"] >= 1, m["policy_ids"]))
            seen.append(srv.state.supervisor.stats()["batcher_revives"])
            time.sleep(0.3)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
            denied = srv.post(
                "pod-privileged", _pod_doc("default", True, "priv")
            )
            srv.stop()
        seen.append(bool(statuses)
                    and all(s.startswith("HTTP/1.1 200") for s in statuses))
        seen.append(denied)
        pkg.failpoints.configure("fetch.http=raise")
        srv2 = HttpServer(pkg, d, policies_path, *extra, **jax_config)
        try:
            r = srv2.state.boot_report
            seen.append((r["warm"], r["manifest_epoch"] >= 1))
            seen.append(srv2.post(
                "pod-privileged", _pod_doc("default", True, "priv")
            ))
        finally:
            srv2.stop()
        pkg.failpoints.reset()
        journal = d / "state" / "manifests.journal"
        data = bytearray(journal.read_bytes())
        data[8] ^= 0xFF
        journal.write_bytes(bytes(data))
        srv3 = HttpServer(pkg, d, policies_path, *extra, **jax_config)
        try:
            r = srv3.state.boot_report
            seen.append((r["warm"], r["fsck_quarantined"]))
            seen.append(srv3.post(
                "pod-privileged", _pod_doc("default", False, "ok")
            )[0])
        finally:
            srv3.stop()
        return seen

    seen = both(case, tmp_path)
    assert seen[0] == "boot"
    assert seen[1] == ("promoted", True, ["happy", "pod-privileged"])
    assert seen[2] == 0 and seen[3] is True
    assert json.loads(seen[4][1])["response"]["allowed"] is False
    assert seen[5] == (True, True) and seen[6] == seen[4]
    assert seen[7] == (False, 1) and seen[8].startswith("HTTP/1.1 200")
