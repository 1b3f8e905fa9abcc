"""The port's host-time accounting in its flight recorder
(``policy_server_tpu_torch/telemetry/flightrec.py``), on the CPU.

* On-CPU time: a span stamped at its call site carries its thread's
  ``time.thread_time_ns`` delta and the thread's index; a span that burns
  the CPU reads near its wall time, one that sleeps near 0; the native
  frontend's stamps carry none. ``attribution()`` and ``chrome_trace()``
  report them.
* The collector: with a recorder installed, each collection writes one
  ``gc`` event (rows = its generation), and a collection that starts on a
  thread holding the metrics registry's lock and the recorder's own locks
  completes: the hook takes no lock. Clearing the recorder removes it.
* The recorder on the profiler's clock (``api/profiling.py``): a
  ``record_function`` range opened inside a recorder span lands inside
  that span in the merged trace, within the anchor's width; the
  ``idle_by_phase`` summary charges every idle instant once.
* The benchmark's five readers of these spans
  (``admission_bench/metrics/``) on hand-made records, a wrapped ring
  among them, and on a record that lacks the spans (None).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import pathlib
import threading
import time

import pytest
import torch

from policy_server_tpu_torch.api import profiling
from policy_server_tpu_torch.runtime import native_frontend as nf
from policy_server_tpu_torch.telemetry import flightrec, metrics
from policy_server_tpu_torch.telemetry.flightrec import FlightRecorder

from test_torch_telemetry import STAMP_POLICIES, _stamp_requests
from torch_port_support import torch_env

METRICS_DIR = pathlib.Path(__file__).resolve().parents[1] / "admission_bench" / "metrics"
SPAN_S = 0.06


@pytest.fixture(autouse=True)
def no_recorder():
    flightrec.install(None)
    yield
    flightrec.install(None)


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"host_time_metric_{name}", METRICS_DIR / f"{name}.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# -- on-CPU time -------------------------------------------------------------


def _burn(seconds: float) -> None:
    end = time.perf_counter() + seconds
    x = 0
    while time.perf_counter() < end:
        x += 1


@pytest.mark.parametrize("work", ["burn", "sleep"])
def test_host_eval_cpu_time_reads_work_not_waiting(work):
    """The host route's ``host_eval`` span around rows whose payload takes
    ``SPAN_S`` on the CPU, or asleep: CPU time near the wall time, or
    near 0."""
    env = torch_env(STAMP_POLICIES, verdict_cache_size=0)
    rec = flightrec.install(FlightRecorder(capacity=256))
    real = env.payload_for
    calls = [0]

    def payload_for(target, request):
        if not calls[0]:
            (_burn if work == "burn" else time.sleep)(SPAN_S)
        calls[0] += 1
        return real(target, request)

    env.payload_for = payload_for
    with flightrec.batch_scope(7):
        out = env.validate_batch(_stamp_requests(3), prefer_host=True)
    assert not any(isinstance(r, Exception) for r in out)
    (ev,) = [e for e in rec.snapshot() if e["phase"] == flightrec.PH_HOST_EVAL]
    wall = ev["end_ns"] - ev["start_ns"]
    assert (ev["batch"], ev["rows"]) == (7, 3) and wall >= SPAN_S * 1e9
    assert ev["cpu_ns"] <= wall + 2_000_000  # one thread: never more than wall
    if work == "burn":
        assert ev["cpu_ns"] >= 0.5 * wall
    else:
        assert ev["cpu_ns"] <= 0.25 * wall


def test_native_stamps_carry_no_cpu_time():
    """The native frontend's phases come from C++ stamps carried across
    its ring: no thread CPU time, no thread."""
    rec = flightrec.install(FlightRecorder(capacity=64))
    t = time.perf_counter_ns()
    burst = [(i, 0, "p", "u", "", "", "", b"", b"", t, t + 10, t + 20) for i in range(3)]
    nf.NativeFrontend._record_burst_phases(burst)
    phases = {e["phase"]: e for e in rec.snapshot()}
    assert set(phases) == {
        flightrec.PH_NATIVE_ACCEPT, flightrec.PH_NATIVE_PARSE, flightrec.PH_RING_CROSS,
    }
    assert not any("cpu_ns" in e or "thread" in e for e in phases.values())


def test_attribution_and_chrome_trace_report_cpu_time():
    rec = FlightRecorder(capacity=256)
    bid = rec.next_batch()
    rec.record_phase(flightrec.PH_QUEUE_WAIT, 0, 1000, rows=10, batch=bid)
    rec.record_phase(flightrec.PH_FORM, 1000, 1100, rows=10, batch=bid, cpu_ns=100)
    rec.record_phase(flightrec.PH_DISPATCH, 1100, 2900, rows=10, batch=bid)
    rec.record_phase(flightrec.PH_ENCODE, 1100, 1500, rows=10, batch=bid, cpu_ns=100)
    rec.record_phase(flightrec.PH_SUBMIT, 1500, 1700, rows=10, batch=bid, cpu_ns=200)
    rec.record_phase(flightrec.PH_FETCH, 1700, 2700, rows=10, batch=bid, cpu_ns=0)
    rec.record_phase(flightrec.PH_DELIVER, 2900, 3000, rows=10, batch=bid, cpu_ns=100)
    att = rec.attribution()
    assert att["cpu_us_per_row"] == {
        flightrec.PH_FORM: 0.01, flightrec.PH_ENCODE: 0.01,
        flightrec.PH_FETCH: 0.0, flightrec.PH_SUBMIT: 0.02,
        flightrec.PH_DELIVER: 0.01,
    }
    # host spans 100 + 400 + 200 + 100 ns of wall, 500 ns on the CPU;
    # the fetch (a device wait) left out
    assert att["off_cpu_share"] == pytest.approx(1 - 500 / 800)
    # residual: 1,800 of dispatch less 1,600 nested (submit counts), over
    # the batch's 2,000 of wall
    assert att["residual_fraction_of_wall"] == pytest.approx(200 / 2000)
    doc = json.loads(rec.chrome_trace_json())
    slices = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert slices[flightrec.PH_SUBMIT]["args"]["cpu_us"] == 0.2
    assert slices[flightrec.PH_SUBMIT]["tid"] == flightrec.THREAD_TRACK_BASE
    assert "cpu_us" not in slices[flightrec.PH_DISPATCH]["args"]
    assert slices[flightrec.PH_DISPATCH]["tid"] == 1 + bid % 12
    names = {
        e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
        if e["ph"] == "M" and e["name"] == "thread_name"
    }
    assert names[flightrec.THREAD_TRACK_BASE] == f"thread {threading.current_thread().name}"


def test_each_thread_gets_its_own_index():
    rec = FlightRecorder(capacity=64)

    def stamp():
        rec.record_phase(flightrec.PH_ENCODE, 0, 1, cpu_ns=1)

    stamp()
    t = threading.Thread(target=stamp)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    stamp()
    assert [e["thread"] for e in rec.snapshot()] == [0, 1, 0]


# -- the collector -------------------------------------------------------------


def test_each_collection_writes_one_gc_event():
    rec = flightrec.install(FlightRecorder(capacity=256))
    was = gc.isenabled()
    gc.disable()  # no automatic collection in between
    try:
        cursor = rec.events_recorded()
        for generation in (0, 1, 2):
            gc.collect(generation)
    finally:
        if was:
            gc.enable()
    events = [e for e in rec.snapshot() if e["seq"] >= cursor]
    assert [(e["phase"], e["rows"], e["batch"]) for e in events] == [
        (flightrec.PH_GC, g, -1) for g in (0, 1, 2)
    ]
    assert all(e["end_ns"] >= e["start_ns"] and e["cpu_ns"] >= 0 for e in events)


def test_a_collection_under_the_registry_and_recorder_locks_completes():
    """The hook takes no lock: a collection on a thread that holds the
    metrics registry's lock and the recorder's ``_ex_lock`` and
    ``_row_lock`` (none reentrant) still completes and is recorded."""
    reg = metrics.MetricsRegistry()
    rec = flightrec.install(FlightRecorder(capacity=256, registry=reg))
    done = threading.Event()

    def collect_holding_locks():
        with reg._lock, rec._ex_lock, rec._row_lock:
            gc.collect()
        done.set()

    t = threading.Thread(target=collect_holding_locks, daemon=True)
    t.start()
    t.join(timeout=30)
    assert done.is_set() and not t.is_alive()
    assert any(e["phase"] == flightrec.PH_GC for e in rec.snapshot())


def test_clearing_the_recorder_removes_the_hook():
    flightrec.install(FlightRecorder(capacity=16))
    flightrec.install(FlightRecorder(capacity=16))
    assert gc.callbacks.count(flightrec._on_gc) == 1
    flightrec.install(None)
    assert flightrec._on_gc not in gc.callbacks


# -- the recorder on the profiler's clock --------------------------------------


def test_a_range_inside_a_recorder_span_lands_inside_it(tmp_path):
    rec = flightrec.install(FlightRecorder(capacity=256))
    profiling.start_device_trace(str(tmp_path))
    try:
        for i in range(3):
            t0 = time.perf_counter_ns()
            with torch.profiler.record_function(f"probe{i}"):
                time.sleep(0.002)
            rec.record_phase(
                flightrec.PH_ENCODE, t0, time.perf_counter_ns(), rows=1, batch=i,
            )
    finally:
        path = profiling.stop_device_trace()
    with open(profiling.summary_path(path)) as f:
        summary = json.load(f)
    width = summary["clock"]["width_us"]
    assert summary["recorder_events"] == 3 and width < 1000
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {
        e["args"]["batch"]: e for e in events
        if e.get("pid") == profiling.RECORDER_PID and e.get("ph") == "X"
    }
    for i in range(3):
        (probe,) = [e for e in events if e.get("name") == f"probe{i}"]
        span = spans[i]
        assert probe["ts"] >= span["ts"] - width
        assert probe["ts"] + probe["dur"] <= span["ts"] + span["dur"] + width
    idle = summary["idle_by_phase"]
    assert idle["busy_s"] == 0 and idle["gaps"] == 1
    assert sum(idle["phase_s"].values()) + idle["no_phase_s"] == pytest.approx(
        idle["idle_s"]
    )


def test_idle_by_phase_charges_each_idle_instant_once():
    rp = profiling.RECORDER_PID

    def x(name, ts, dur, **kw):
        return {"ph": "X", "name": name, "ts": ts, "dur": dur, **kw}

    trace = {"traceEvents": [
        x("k", 10, 10, cat="kernel", pid=1),
        x("k2", 15, 10, cat="gpu_memcpy", pid=1),
        x("dispatch", 0, 60, pid=rp),
        x("encode", 20, 20, pid=rp),
        x("encode", 30, 20, pid=rp),
        x("gc", 45, 10, pid=rp),
        x("fetch", 70, 10, pid=rp),
    ]}
    got = profiling.idle_by_phase(trace, (0, 100))
    assert got["busy_s"] == pytest.approx(15e-6)
    assert got["idle_s"] == pytest.approx(85e-6) and got["gaps"] == 2
    assert got["phase_s"] == pytest.approx(
        {"gc": 10e-6, "encode": 20e-6, "fetch": 10e-6, "dispatch": 15e-6}
    )
    assert got["no_phase_s"] == pytest.approx(30e-6)
    assert got["covered_s"]["encode"] == pytest.approx(25e-6)
    assert got["covered_s"]["dispatch"] == pytest.approx(45e-6)


def test_clock_map_is_linear_between_its_anchors():
    start = [(1_000_000, 1_000_500)]
    stop = [(3_000_000, 3_000_500)]
    trace = {"traceEvents": [
        {"ph": "X", "name": profiling.ANCHOR_NAME, "ts": 5001.0, "dur": 0.2},
        {"ph": "X", "name": profiling.ANCHOR_NAME, "ts": 7003.0, "dur": 0.2},
    ]}
    clock = profiling.clock_map(trace, start, stop)
    # start: the range [5001.0, 5001.2] inside [1000, 1000.5] puts the
    # offset in [4000.7, 4001.0]
    assert clock["offset0_us"] == pytest.approx(4000.85)
    assert clock["offset1_us"] == pytest.approx(4002.85)
    assert clock["width_us"] == pytest.approx(0.15)
    assert profiling.to_trace_us(clock, 2_000_250) == pytest.approx(2000.25 + 4001.85)
    assert profiling.clock_map(trace, start, stop + stop) is None


# -- the benchmark's readers ---------------------------------------------------


def _record(capacity: int):
    """Two batches, a host-routed one and a device one, and two
    collections, with fixed clocks: the events of the window as the
    harness copies them (``run["events"]``)."""
    rec = FlightRecorder(capacity=capacity)
    cursor = rec.events_recorded()
    b1, b2 = rec.next_batch(), rec.next_batch()
    for bid, t in ((b1, 0), (b2, 10_000)):
        rec.record_phase(flightrec.PH_QUEUE_WAIT, t, t + 1000, rows=4, batch=bid)
        rec.record_phase(flightrec.PH_FORM, t + 1000, t + 1200, rows=4, batch=bid,
                         cpu_ns=150)
        rec.record_phase(flightrec.PH_DISPATCH, t + 1200, t + 5200, rows=4, batch=bid)
        rec.record_phase(flightrec.PH_HANDOFF, t + 1200, t + 1300, rows=4, batch=bid)
        if bid == b1:
            rec.record_phase(flightrec.PH_HOST_EVAL, t + 1300, t + 4300, rows=4,
                             batch=bid, cpu_ns=600)
        else:
            rec.record_phase(flightrec.PH_ENCODE, t + 1300, t + 2300, rows=4,
                             batch=bid, cpu_ns=300)
            rec.record_phase(flightrec.PH_SUBMIT, t + 2300, t + 2800, rows=3,
                             batch=bid, cpu_ns=400)
            rec.record_phase(flightrec.PH_FETCH, t + 2800, t + 4800, rows=3,
                             batch=bid, cpu_ns=10)
        rec.record_phase(flightrec.PH_DELIVER, t + 5200, t + 5400, rows=4, batch=bid,
                         cpu_ns=50)
        rec.record_batch_mix(bid, 0, 4)
    rec.record_collection(2, 6000, 6500, 500)
    rec.record_collection(0, 16000, 16100, 100)
    return rec, {"events": [e for e in rec.snapshot() if e["seq"] >= cursor]}


def test_readers_on_a_hand_made_record():
    rec, run = _record(256)
    assert reader("host_route_us_per_row")(run) == pytest.approx(3000 / 4 / 1e3)
    assert reader("submit_us_per_row")(run) == pytest.approx(500 / 3 / 1e3)
    # form, host_eval, encode, submit, deliver: wall 200 + 3000 + 200 +
    # 1000 + 500 + 200 + 200 ns against cpu 150 + 600 + 50 + 150 + 300 +
    # 400 + 50; the fetch left out
    assert reader("host_off_cpu_share")(run) == pytest.approx(1 - 1700 / 5300)
    assert reader("gc_pause_share")(run) == pytest.approx(600 / 16100)
    assert reader("dispatch_residual_share")(run) == pytest.approx(
        rec.attribution()["residual_fraction_of_wall"], abs=1e-4
    )
    # batch 1: 4,000 of dispatch less 3,100 nested; batch 2: less 3,600;
    # 4,400 of wall each
    assert reader("dispatch_residual_share")(run) == pytest.approx(1300 / 8800)


def test_readers_divide_by_what_a_wrapped_ring_kept():
    """A ring of 16 keeps the last 16 of the record's 18 events: batch 1's
    queue_wait and form are gone, so it is no complete batch; its
    host_eval row stays a host-route row, and the recorded time starts at
    its dispatch."""
    rec, run = _record(16)
    assert rec.events_recorded() == 18 and len(run["events"]) == 16
    assert reader("host_route_us_per_row")(run) == pytest.approx(3000 / 4 / 1e3)
    assert reader("submit_us_per_row")(run) == pytest.approx(500 / 3 / 1e3)
    assert reader("dispatch_residual_share")(run) == pytest.approx(400 / 4400)
    assert reader("gc_pause_share")(run) == pytest.approx(600 / (16100 - 1200))


def test_readers_find_nothing_in_a_record_without_the_spans():
    """The parent's record: no CPU time, no host_eval, submit or gc."""
    rec = FlightRecorder(capacity=64)
    bid = rec.next_batch()
    rec.record_phase(flightrec.PH_FORM, 0, 100, rows=2, batch=bid)
    rec.record_phase(flightrec.PH_ENCODE, 100, 200, rows=2, batch=bid)
    run = {"events": rec.snapshot()}
    for name in ("host_route_us_per_row", "submit_us_per_row",
                 "host_off_cpu_share", "gc_pause_share",
                 "dispatch_residual_share"):
        assert reader(name)(run) is None, name
    assert reader("host_off_cpu_share")({"events": []}) is None
