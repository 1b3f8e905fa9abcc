"""Device submission (``evaluation/environment.py::_device_step`` and its
caller): microseconds of the flight recorder's ``submit`` phase (a device
chunk's wasm bits, pack, host-to-device copy and launches, up to the
step's return) per row the chunk answers, in the window."""


def read(run: dict) -> float | None:
    ns = rows = 0
    for e in run["events"]:
        if e["phase"] == "submit":
            ns += max(0, e["end_ns"] - e["start_ns"])
            rows += e["rows"]
    return ns / rows / 1e3 if rows else None
