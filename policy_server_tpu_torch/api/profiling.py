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
  tracing the host alone.
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
        _trace.update(prof=prof, log_dir=log_dir)


def stop_device_trace() -> str:
    """Stop the trace, write it as Chrome trace JSON into the directory
    given to ``start_device_trace`` and return the file's path."""
    with _trace_lock:
        if not _trace:
            raise RuntimeError("no device trace is running")
        prof, log_dir = _trace.pop("prof"), _trace.pop("log_dir")
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"device_trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path
