"""The traced run's device side: a ``torch.profiler`` window over the card,
its reduction to busy time, kernel times and idle gaps, and K1's byte count.

K1 is the port's policy-matrix kernel (``ops/cuda_kernels.py::
policy_matrix``, ``csrc/policy_matrix.cu``). Its least time is bound by
bytes: it reads a packed ``uint8 (B, W)`` buffer once and writes a
``bool (B, cols)`` verdict and an ``int32 (B, cols)`` rule index, so one
launch moves ``B*W + B*cols*(1 + 4)`` bytes. The harness records ``B``,
``W`` and ``cols`` of every launch in the window by wrapping the module's
function, and divides the bytes by the card's published bandwidth.
"""

from __future__ import annotations

import json
import os
from typing import Any

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, bytes/s (at the 700 W limit)
H100_HBM_BYTES_PER_S = 3.35e12
K1_KERNEL = "policy_matrix_kernel"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cuda_runtime", "cuda_driver")
NO_CALL = "host, no CUDA call"


def k1_launch_bytes(batch: int, row_width: int, cols: int) -> int:
    """Bytes one K1 launch must move: the rows read once, both outputs
    written once."""
    return batch * row_width + batch * cols * (1 + 4)


class K1Shapes:
    """Records each K1 launch's shape while installed around
    ``cuda_kernels.policy_matrix``; the original's launch count stays
    where the module keeps it."""

    def __init__(self, cuda_kernels: Any):
        self.ck = cuda_kernels
        self.original = cuda_kernels.policy_matrix
        self.launches: list[tuple[int, int, int]] = []

    def __enter__(self) -> "K1Shapes":
        original, launches = self.original, self.launches

        def policy_matrix(buf, program):
            out = original(buf, program)
            if buf.is_cuda and buf.shape[0]:
                launches.append((int(buf.shape[0]), int(buf.shape[1]), int(program.out_cols)))
            return out

        policy_matrix.launches = original.launches
        self.ck.policy_matrix = policy_matrix
        self.wrapper = policy_matrix
        return self

    def __exit__(self, *exc: Any) -> None:
        self.original.launches = self.wrapper.launches
        self.ck.policy_matrix = self.original

    def total_bytes(self) -> int:
        return sum(k1_launch_bytes(b, w, c) for b, w, c in self.launches)


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce_trace(path: str) -> dict:
    """From a Chrome trace of the window: device busy seconds (the union of
    kernel, copy and set intervals), the trace's span, seconds per device
    operation name, K1's kernel seconds and count, and the idle gaps by
    the host's CUDA call that overlapped them."""
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    device, host = [], []
    lo, hi = float("inf"), float("-inf")
    per_op: dict[str, float] = {}
    k1_us, k1_n = 0.0, 0
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATEGORIES:
            device.append((s, s + d))
            per_op[e["name"]] = per_op.get(e["name"], 0.0) + d
            if K1_KERNEL in e["name"]:
                k1_us += d
                k1_n += 1
        elif cat in HOST_CATEGORIES:
            host.append((s, s + d, e["name"]))
        else:
            continue
        lo, hi = min(lo, s), max(hi, s + d)
    busy = _merge(device)
    busy_us = sum(e - s for s, e in busy)
    gaps: list[tuple[float, float]] = []
    cursor = lo
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor, hi))
    idle: dict[str, float] = {}
    host.sort()
    j = 0
    for gs, ge in gaps:
        covered = 0.0
        while j < len(host) and host[j][1] <= gs:
            j += 1
        k = j
        while k < len(host) and host[k][0] < ge:
            hs, he, name = host[k]
            part = min(he, ge) - max(hs, gs)
            if part > 0:
                idle[name] = idle.get(name, 0.0) + part
                covered += part
            k += 1
        idle[NO_CALL] = idle.get(NO_CALL, 0.0) + max(0.0, (ge - gs) - covered)
    return {
        "busy_s": busy_us / 1e6,
        "span_s": max(0.0, hi - lo) / 1e6 if device or host else 0.0,
        "device_ops": sorted(((n, v / 1e6) for n, v in per_op.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(((n, v / 1e6) for n, v in idle.items()), key=lambda x: -x[1])[:10],
        "k1_seconds": k1_us / 1e6,
        "k1_kernels": k1_n,
    }


class DeviceTrace:
    """A ``torch.profiler`` window over the card (CUDA activity: kernels,
    copies and the host's CUDA calls), written under ``directory``."""

    def __init__(self, directory: str):
        self.path = os.path.join(directory, "window.trace.json")
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()

    def reduce(self) -> dict:
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        try:
            return reduce_trace(self.path)
        finally:
            os.remove(self.path)
