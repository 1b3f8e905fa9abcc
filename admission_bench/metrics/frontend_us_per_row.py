"""Native frontend (``runtime/native_frontend.py``, ``csrc/httpfront.cpp``):
microseconds a row spends in its phases, from the flight recorder's events
of the window: accept, parse, the ring crossing, admission and the native
serialization, each phase's time over the rows it carried, summed."""

PHASES = ("native_accept", "native_parse", "ring_cross", "admit", "native_serialize")


def read(run: dict) -> float | None:
    ns = dict.fromkeys(PHASES, 0)
    rows = dict.fromkeys(PHASES, 0)
    for e in run["events"]:
        if e["phase"] in ns:
            ns[e["phase"]] += max(0, e["end_ns"] - e["start_ns"])
            rows[e["phase"]] += e["rows"]
    if not any(rows.values()):
        return None
    return sum(ns[p] / rows[p] / 1e3 for p in PHASES if rows[p])
