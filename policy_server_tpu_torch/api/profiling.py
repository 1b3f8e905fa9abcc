"""The profiling endpoints' engine.

Counterpart of ``policy_server_tpu/api/profiling.py``:

* ``start_one_cpu_profile`` — a process-wide sampling profiler of the
  host's threads (``sys._current_frames`` at ``frequency`` Hz for
  ``interval`` seconds), collapsed stacks sorted by count; single-flight:
  a second profile while one runs raises ``ProfileInProgress``.
* ``heap_profile`` — the host's top allocations (``tracemalloc``, once
  ``activate_memory_profiling`` started it) and, for each CUDA card, its
  allocator statistics (``torch.cuda.memory_stats``) with the free and
  total memory ``torch.cuda.mem_get_info`` reports, under the JAX
  package's document keys (``devices[].id/platform/memory_stats``,
  ``host_top_allocations``).
* ``start_device_trace`` / ``stop_device_trace`` — a ``torch.profiler``
  trace with CPU and CUDA activities, written as Chrome trace JSON into
  ``log_dir``. On a machine with a card the trace must record CUDA
  activity: where the profiler cannot, starting it raises rather than
  tracing the host alone. Each end of the trace stamps a clock anchor: a
  ``record_function`` range (``flightrec.clock_anchor``) between two
  ``perf_counter_ns`` reads, the narrowest of a few tries. From the
  anchors' ranges in the exported trace, the flight recorder's events of
  the window are laid into the trace on its time base, as a process of
  their own, and a summary (``idle_by_phase``, beside the trace) gives,
  over the card's idle gaps, the seconds each recorder phase covers.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
import tracemalloc
from dataclasses import dataclass
from typing import Any

import torch

from policy_server_tpu_torch.telemetry import flightrec

DEFAULT_PROFILING_FREQUENCY = 99  # Hz
DEFAULT_PROFILING_INTERVAL = 30  # seconds

# single-flight: one CPU profile at a time
_cpu_lock = threading.Lock()


class ProfileInProgress(Exception):
    pass


@dataclass
class CpuProfile:
    text: str
    interval: float


def start_one_cpu_profile(
    interval: float, frequency: int = DEFAULT_PROFILING_FREQUENCY
) -> CpuProfile:
    """Every 1/frequency seconds for ``interval`` seconds, snapshot every
    other thread's stack and count the collapsed stacks (``frame;frame
    count`` lines, most frequent first)."""
    if not _cpu_lock.acquire(blocking=False):
        raise ProfileInProgress("a CPU profile is already being generated")
    try:
        period = 1.0 / max(1, frequency)
        stacks: collections.Counter[str] = collections.Counter()
        own = threading.get_ident()
        deadline = time.perf_counter() + interval
        while time.perf_counter() < deadline:
            for tid, frame in sys._current_frames().items():
                if tid == own:
                    continue
                parts = []
                f = frame
                while f is not None and len(parts) < 64:
                    code = f.f_code
                    parts.append(f"{code.co_filename}:{code.co_name}")
                    f = f.f_back
                stacks[";".join(reversed(parts))] += 1
            time.sleep(period)
        lines = [
            f"{stack} {count}"
            for stack, count in sorted(stacks.items(), key=lambda kv: -kv[1])
        ]
        return CpuProfile(text="\n".join(lines) + "\n", interval=interval)
    finally:
        _cpu_lock.release()


_memory_profiling_active = False


def activate_memory_profiling() -> None:
    """Start host allocation tracking (``--enable-pprof`` at boot)."""
    global _memory_profiling_active
    if not _memory_profiling_active:
        tracemalloc.start()
        _memory_profiling_active = True


def heap_profile() -> bytes:
    """Host top allocations and, per CUDA card, its allocator statistics
    with the free and total bytes ``torch.cuda.mem_get_info`` reports, as
    JSON."""
    doc: dict = {"devices": [], "host_top_allocations": []}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        stats: dict[str, Any] = dict(torch.cuda.memory_stats(i))
        stats["free_bytes"], stats["total_bytes"] = torch.cuda.mem_get_info(i)
        doc["devices"].append({"id": i, "platform": "gpu", "memory_stats": stats})
    if _memory_profiling_active:
        snapshot = tracemalloc.take_snapshot()
        for stat in snapshot.statistics("lineno")[:50]:
            doc["host_top_allocations"].append(
                {
                    "location": str(stat.traceback),
                    "size_bytes": stat.size,
                    "count": stat.count,
                }
            )
    return json.dumps(doc, indent=2).encode()


_trace_lock = threading.Lock()
_trace: dict[str, Any] = {}  # guarded-by: _trace_lock

ANCHOR_NAME = "flightrec.clock_anchor"
ANCHOR_TRIES = 5
# the recorder's events in a merged trace: a process of their own
RECORDER_PID = 1 << 30
# the card's activity in a torch.profiler trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# which phase an idle instant is charged to where several spans cover it:
# the collector first (it stops every thread), then the leaf spans, the
# waits and wrappers after them, the queue last
IDLE_PRECEDENCE = (
    flightrec.PH_GC, flightrec.PH_DEVICE_EXECUTE, flightrec.PH_SUBMIT,
    flightrec.PH_ENCODE, flightrec.PH_HOST_EVAL, flightrec.PH_PREPARE,
    flightrec.PH_BLOB_DEDUP, flightrec.PH_BOOKKEEPING,
    flightrec.PH_MATERIALIZE, flightrec.PH_FETCH, flightrec.PH_HANDOFF,
    flightrec.PH_FORM, flightrec.PH_DELIVER, flightrec.PH_ADMIT,
    flightrec.PH_NATIVE_SERIALIZE, flightrec.PH_RING_CROSS,
    flightrec.PH_NATIVE_PARSE, flightrec.PH_NATIVE_ACCEPT,
    flightrec.PH_DISPATCH, flightrec.PH_QUEUE_WAIT,
)


def _clock_anchor() -> list[tuple[int, int]]:
    """``ANCHOR_TRIES`` empty ``record_function`` ranges, each between two
    ``perf_counter_ns`` reads: [(before, after)] in order."""
    tries = []
    for _ in range(ANCHOR_TRIES):
        t0 = time.perf_counter_ns()
        with torch.profiler.record_function(ANCHOR_NAME):
            pass
        tries.append((t0, time.perf_counter_ns()))
    return tries


def _anchor_point(tries: list[tuple[int, int]], ranges: list[tuple[float, float]]):
    """(recorder µs, offset µs, half-width µs) from the narrowest try: the
    trace's range [ts, ts + dur] (trace µs) lies inside its try's
    [before, after] (recorder ns), so profiler − recorder lies in
    [ts + dur − after, ts − before]; the midpoint, and half the width."""
    best = None
    for (t0, t1), (ts, end) in zip(tries, ranges):
        lo, hi = end - t1 / 1e3, ts - t0 / 1e3
        if best is None or hi - lo < best[2] - best[1]:
            best = ((t0 + t1) / 2e3, lo, hi)
    at, lo, hi = best
    return at, (lo + hi) / 2, max(0.0, hi - lo) / 2


def clock_map(trace: dict, start: list, stop: list) -> dict | None:
    """The recorder's clock onto the trace's, from the anchor ranges the
    trace holds (the first ``len(start)`` in time order are the start
    anchor's tries, the last ``len(stop)`` the stop anchor's): the offset
    at each end, linear in between, and the larger half-width (the
    conversion's uncertainty, µs). None when the trace lacks them."""
    ranges = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
        for e in trace.get("traceEvents", ())
        if e.get("ph") == "X" and e.get("name") == ANCHOR_NAME
    )
    if len(ranges) != len(start) + len(stop):
        return None
    a = _anchor_point(start, ranges[: len(start)])
    b = _anchor_point(stop, ranges[len(start):])
    return {
        "t0_us": a[0], "offset0_us": a[1], "t1_us": b[0], "offset1_us": b[1],
        "width_us": max(a[2], b[2]),
        "window_us": (ranges[len(start) - 1][1], ranges[len(start)][0]),
    }


def to_trace_us(clock: dict, ns: float) -> float:
    """A recorder stamp (perf_counter ns) on the trace's time base (µs)."""
    us = ns / 1e3
    span = clock["t1_us"] - clock["t0_us"]
    f = (us - clock["t0_us"]) / span if span > 0 else 0.0
    return us + clock["offset0_us"] + f * (clock["offset1_us"] - clock["offset0_us"])


def _union(spans) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _intersect(a: list, b: list) -> list[tuple[float, float]]:
    """Two unions' common part (both sorted, disjoint)."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(a: list, b: list) -> list[tuple[float, float]]:
    """``a`` less ``b`` (both unions)."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if e > s:
            out.append((s, e))
    return out


def _length(spans: list) -> float:
    return sum(e - s for s, e in spans)


def idle_by_phase(trace: dict, window: tuple[float, float]) -> dict:
    """Over the card's idle gaps in ``window`` (trace µs): the seconds each
    recorder phase covers (``covered_s``, the union of its events: phases
    nest, so these overlap), the same with each idle instant charged to
    one phase by ``IDLE_PRECEDENCE`` (``phase_s``), and the rest
    (``no_phase_s``); ``phase_s`` and ``no_phase_s`` sum to ``idle_s``."""
    events = trace.get("traceEvents", ())
    lo, hi = window
    busy = _intersect(
        _union(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
        ),
        [(lo, hi)],
    )
    idle = _subtract([(lo, hi)], busy)
    by_phase: dict[str, list] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("pid") == RECORDER_PID:
            ts = float(e["ts"])
            by_phase.setdefault(e["name"], []).append((ts, ts + float(e["dur"])))
    unions = {p: _union(v) for p, v in by_phase.items()}
    covered = {p: _length(_intersect(idle, u)) / 1e6 for p, u in unions.items()}
    rest = idle
    charged = {}
    order = [p for p in IDLE_PRECEDENCE if p in unions]
    order += sorted(p for p in unions if p not in IDLE_PRECEDENCE)
    for p in order:
        hit = _intersect(rest, unions[p])
        charged[p] = _length(hit) / 1e6
        rest = _subtract(rest, hit)
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": _length(busy) / 1e6,
        "idle_s": _length(idle) / 1e6,
        "gaps": len(idle),
        "phase_s": {p: v for p, v in charged.items() if v > 0},
        "no_phase_s": _length(rest) / 1e6,
        "covered_s": {p: v for p, v in covered.items() if v > 0},
    }


def merge_recorder(trace: dict, rec: Any, clock: dict) -> int:
    """Append the recorder's events of the trace window to ``trace`` on its
    time base, as process ``RECORDER_PID`` (the recorder's own tracks:
    one per stamping thread, batch lanes, native bursts, sampled rows);
    returns how many."""
    t0, t1 = clock["window_us"]
    doc = rec.chrome_trace()
    added = []
    for e in doc["traceEvents"]:
        e = dict(e)
        if e["ph"] == "X":
            if e["pid"] != 1:
                continue  # sampled rows: per-row segments, not phases
            start_ns = e["ts"] * 1e3
            ts = to_trace_us(clock, start_ns)
            end = to_trace_us(clock, start_ns + e["dur"] * 1e3)
            if end < t0 or ts > t1:
                continue
            e["ts"], e["dur"] = ts, end - ts
            e["cat"] = "flightrec"
        elif e["pid"] != 1:
            continue
        e["pid"] = RECORDER_PID
        if e["ph"] == "M" and e["name"] == "process_name":
            e["args"] = {"name": "flight recorder (policy-server)"}
        added.append(e)
    trace.setdefault("traceEvents", []).extend(added)
    return sum(1 for e in added if e["ph"] == "X")


def summary_path(trace_path: str) -> str:
    """The ``idle_by_phase`` summary written beside a trace."""
    return os.path.splitext(trace_path)[0] + ".idle_by_phase.json"


def start_device_trace(log_dir: str) -> None:
    """Begin a ``torch.profiler`` trace of the host and, where there is a
    card, the card. Raises when a trace is already running, and on a card
    when the profiler cannot record CUDA activity."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(
                "torch.profiler cannot record CUDA activity here; refusing "
                "to trace the host alone"
            )
        activities.append(ProfilerActivity.CUDA)
    with _trace_lock:
        if _trace:
            raise RuntimeError("a device trace is already running")
        prof = profile(activities=activities)
        prof.__enter__()
        _trace.update(prof=prof, log_dir=log_dir, anchor=_clock_anchor())


def stop_device_trace() -> str:
    """Stop the trace, write it as Chrome trace JSON into the directory
    given to ``start_device_trace`` and return the file's path. With a
    flight recorder installed, the file also holds the recorder's events
    of the window on the trace's time base (``merge_recorder``). Beside
    it, ``summary_path(path)`` holds the clock mapping and
    ``idle_by_phase`` over the window between the anchors."""
    with _trace_lock:
        if not _trace:
            raise RuntimeError("no device trace is running")
        prof, log_dir = _trace.pop("prof"), _trace.pop("log_dir")
        start = _trace.pop("anchor")
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    stop = _clock_anchor()
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"device_trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    clock = clock_map(trace, start, stop)
    summary: dict = {"clock": clock, "recorder_events": 0, "idle_by_phase": None}
    if clock is not None:
        rec = flightrec.recorder()
        if rec is not None:
            summary["recorder_events"] = merge_recorder(trace, rec, clock)
            with open(path, "w", encoding="utf-8") as f:
                json.dump(trace, f)
        summary["idle_by_phase"] = idle_by_phase(trace, clock["window_us"])
    with open(summary_path(path), "w", encoding="utf-8") as f:
        json.dump(summary, f, indent=1)
    return path
