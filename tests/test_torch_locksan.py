"""The PyTorch port's lock-order sanitizer (``policy_server_tpu_torch/
locksan.py``, with ``utils/graphs.py``) against the JAX package's: the
four sanitizer cases of ``tests/test_graftcheck.py`` run against the
port's module, one sequence fed through both modules gives equal reports,
and the port's server, armed in a subprocess of its own, serves through
both frontends, fences a killed shard, sweeps and spills its audit state,
reloads and warm-boots with no lock-order inversion."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from policy_server_tpu import locksan as jlocksan
from policy_server_tpu.utils import graphs as jgraphs
from policy_server_tpu_torch import locksan
from policy_server_tpu_torch.utils import graphs

REPO = Path(__file__).resolve().parent.parent
DRIVE = REPO / "tests" / "torch_locksan_drive.py"
# the serving subprocess's own limit
DRIVE_TIMEOUT_S = 120


@pytest.fixture
def fresh():
    if locksan.installed():
        pytest.skip("the port's sanitizer is armed in this process")
    locksan.reset()
    yield locksan
    locksan.reset()


def test_locksan_detects_abc_bca_inversion(fresh):
    a = fresh.SanLock(threading.Lock(), "fix.py:1", False)
    b = fresh.SanLock(threading.Lock(), "fix.py:2", False)
    c = fresh.SanLock(threading.Lock(), "fix.py:3", False)
    with a, b:
        pass
    with b, c:
        pass
    with c, a:  # closes the 3-cycle
        pass
    rep = fresh.report()
    assert rep["inversions"] == [["fix.py:1", "fix.py:2", "fix.py:3"]]
    assert rep["acquisitions"] == 6
    assert rep["inversion_stacks"]


def test_locksan_consistent_order_is_clean_and_same_site_ignored(fresh):
    a = fresh.SanLock(threading.Lock(), "fix.py:1", False)
    b = fresh.SanLock(threading.Lock(), "fix.py:2", False)
    b2 = fresh.SanLock(threading.Lock(), "fix.py:2", False)
    with a, b:
        pass
    with b, b2:  # same creation site: hand-over-hand, no edge
        pass
    rep = fresh.report()
    assert rep["inversions"] == []
    assert rep["edges"] == [("fix.py:1", "fix.py:2")]


def test_locksan_long_hold_reported(fresh, monkeypatch):
    monkeypatch.setattr(fresh, "HOLD_THRESHOLD_MS", 5.0)
    lk = fresh.SanLock(threading.Lock(), "fix.py:9", False)
    with lk:
        time.sleep(0.02)
    rep = fresh.report()
    assert rep["long_holds"] and rep["long_holds"][0][0] == "fix.py:9"
    assert rep["inversions"] == []  # long holds report, never fail


def test_locksan_install_instruments_package_locks_only(fresh):
    fresh.install()
    try:
        from policy_server_tpu_torch.resilience import CircuitBreaker

        breaker = CircuitBreaker()
        assert type(breaker._lock).__name__ == "SanLock"
        assert breaker._lock.site.startswith("policy_server_tpu_torch/resilience.py:")
        # non-package construction sites keep native locks
        assert type(threading.Lock()).__name__ != "SanLock"
        breaker.record_failure()
        assert breaker.state  # the instrumented lock drives the real breaker
    finally:
        fresh.uninstall()
    assert not fresh.installed()


def _sequence(mod) -> tuple[dict, str]:
    """One scripted sequence of acquisitions: an inversion, a clean
    same-site pair, a re-entrant lock and a long hold."""
    mod.reset()
    a = mod.SanLock(threading.Lock(), "seq.py:1", False)
    b = mod.SanLock(threading.Lock(), "seq.py:2", False)
    c = mod.SanLock(threading.Lock(), "seq.py:3", False)
    c2 = mod.SanLock(threading.Lock(), "seq.py:3", False)
    r = mod.SanLock(threading.RLock(), "seq.py:4", True)
    d = mod.SanLock(threading.Lock(), "seq.py:5", False)
    with a, b:
        pass
    with b, c, c2:
        pass
    with r, r, a:
        pass
    with c, a:
        pass
    with d:
        time.sleep(0.03)
    rep = mod.report()
    text = mod.format_report(rep)
    mod.reset()
    return rep, text


def test_one_sequence_gives_equal_reports_in_both_modules(fresh, monkeypatch):
    if jlocksan.installed():
        pytest.skip("the JAX package's sanitizer is armed in this session")
    monkeypatch.setattr(jlocksan, "HOLD_THRESHOLD_MS", 10.0)
    monkeypatch.setattr(locksan, "HOLD_THRESHOLD_MS", 10.0)
    jrep, jtext = _sequence(jlocksan)
    trep, ttext = _sequence(locksan)
    for key in ("acquisitions", "edges", "inversions"):
        assert trep[key] == jrep[key], key
    assert trep["inversions"] == [["seq.py:1", "seq.py:2", "seq.py:3"]]
    assert set(trep["inversion_stacks"]) == set(jrep["inversion_stacks"])
    assert [h[0] for h in trep["long_holds"]] == [h[0] for h in jrep["long_holds"]]
    assert set(trep["max_hold_ms"]) == set(jrep["max_hold_ms"])
    # the text differs only in the hold durations and the stack lines,
    # which name each module's own frames
    def strip(text: str) -> list[str]:
        heads = ("graftcheck", "  INVERSION", "    first", "  LONG HOLD")
        return [
            ln.split(" held ")[0] for ln in text.splitlines()
            if ln.startswith(heads)
        ]

    assert strip(ttext) == strip(jtext)


def test_graphs_equal_the_jax_packages():
    rng = __import__("random").Random(3)
    for _ in range(50):
        nodes = [f"n{i}" for i in range(rng.randint(1, 12))]
        graph = {
            v: {w for w in nodes if rng.random() < 0.2} for v in nodes
        }
        assert graphs.strongly_connected_components(graph) == (
            jgraphs.strongly_connected_components(graph)
        )


def test_server_under_the_sanitizer_has_no_inversion(tmp_path):
    """The port's server in a subprocess with its sanitizer armed before
    any of its modules is imported: ``--state-dir``, ``--audit-mode
    interval --audit-matrix`` and two shards, reviews through the native
    frontend, a killed shard fenced, an audit sweep and its matrix spill,
    a reload, then a warm boot under the stdlib frontend with more
    reviews. Every inversion would be a fault of the port; long holds are
    printed and do not fail."""
    out = tmp_path / "locksan.json"
    proc = subprocess.run(
        [sys.executable, str(DRIVE), str(out), "--device", "cpu", "--full",
         "--native", "64", "--stdlib", "32"],
        cwd=REPO, capture_output=True, text=True, timeout=DRIVE_TIMEOUT_S,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    rep = json.loads(out.read_text())
    print(rep["report"])
    assert rep["inversions"] == [], rep["report"]
    facts = rep["facts"]
    assert facts["native"] == {"200": 64}
    assert facts["stdlib"] == {"200": 32}
    assert facts["fences"] >= 1
    assert facts["audit_rows_scanned"] > 0 and facts["matrix_spills"] > 0
    assert facts["reload"] == "promoted"
    assert facts["warm"] is True
    # the drive went through the instrumented locks of many threads
    assert rep["acquisitions"] > 1000 and rep["edges"] > 10
