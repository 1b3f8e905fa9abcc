"""Host threads under the GIL (the Python-side serving phases): the share
of the host spans' wall time their threads spent off the CPU, waiting for
the GIL or blocked: 1 - summed thread CPU time (``cpu_ns``) over summed
wall time of the window's events of the phases below that carry it. The
device waits (``fetch``, ``device_execute``) are left out: they are off
the CPU by design."""

PHASES = frozenset((
    "form", "prepare", "blob_dedup", "encode", "submit", "materialize",
    "bookkeeping", "host_eval", "deliver", "admit", "native_serialize",
))


def read(run: dict) -> float | None:
    wall = cpu = 0
    for e in run["events"]:
        if e["phase"] in PHASES and "cpu_ns" in e:
            wall += max(0, e["end_ns"] - e["start_ns"])
            cpu += e["cpu_ns"]
    return 1.0 - cpu / wall if wall else None
