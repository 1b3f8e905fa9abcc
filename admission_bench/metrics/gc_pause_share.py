"""Python collector (the server process): the share of the window's
recorded time the garbage collector stopped the thread it ran on, summed
``gc`` events (one per collection of any generation) over the time the
window's events span (the latest end less the earliest start). Both come
from the events the ring kept, so a ring that wrapped inside the window
gives the share of the part it kept."""


def read(run: dict) -> float | None:
    paused = 0
    first = last = None
    collections = 0
    for e in run["events"]:
        if e["kind"] == "mix":
            continue  # a per-batch marker, not an interval
        first = e["start_ns"] if first is None else min(first, e["start_ns"])
        last = e["end_ns"] if last is None else max(last, e["end_ns"])
        if e["phase"] == "gc":
            paused += max(0, e["end_ns"] - e["start_ns"])
            collections += 1
    if not collections or last <= first:
        return None
    return paused / (last - first)
