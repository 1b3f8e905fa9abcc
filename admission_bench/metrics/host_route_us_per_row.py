"""Host-oracle route (``evaluation/environment.py::_validate_batch_hostpath``):
microseconds of the flight recorder's ``host_eval`` phase (the route's row
loop, one event per host-routed batch) per row it answered in the window."""


def read(run: dict) -> float | None:
    ns = rows = 0
    for e in run["events"]:
        if e["phase"] == "host_eval":
            ns += max(0, e["end_ns"] - e["start_ns"])
            rows += e["rows"]
    return ns / rows / 1e3 if rows else None
