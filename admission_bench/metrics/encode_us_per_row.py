"""Host encode (``ops/fastenc.py``, ``evaluation/environment.py``):
microseconds of the flight recorder's ``encode`` phase per row it encoded
in the window."""


def read(run: dict) -> float | None:
    ns = rows = 0
    for e in run["events"]:
        if e["phase"] == "encode":
            ns += max(0, e["end_ns"] - e["start_ns"])
            rows += e["rows"]
    return ns / rows / 1e3 if rows else None
