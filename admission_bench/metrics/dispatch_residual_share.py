"""Micro-batcher dispatch (``runtime/batcher.py``): the share of batch wall
time (``form`` start to ``deliver`` end) that no recorder phase covers,
summed over the window's complete batches (``form``, ``dispatch`` and
``deliver`` all kept by the ring), as ``FlightRecorder.attribution``
computes its ``residual_fraction_of_wall``: dispatch time the phases
nested in it leave unexplained, plus the gaps between the batcher's
phases."""

NESTED = (
    "handoff", "prepare", "encode", "blob_dedup", "fetch", "materialize",
    "bookkeeping", "host_eval", "submit",
)


def read(run: dict) -> float | None:
    batches: dict[int, dict[str, list]] = {}
    for e in run["events"]:
        if e["kind"] == "batch" and e["batch"] >= 0:
            batches.setdefault(e["batch"], {}).setdefault(e["phase"], []).append(e)

    def dur(phs: dict, name: str) -> int:
        return sum(max(0, e["end_ns"] - e["start_ns"]) for e in phs.get(name, ()))

    wall = residual = 0
    for phs in batches.values():
        if not all(p in phs for p in ("form", "dispatch", "deliver")):
            continue
        w = max(0, phs["deliver"][0]["end_ns"] - phs["form"][0]["start_ns"])
        disp = dur(phs, "dispatch")
        nested = sum(dur(phs, p) for p in NESTED)
        residual += max(0, disp - nested) + max(
            0, w - (dur(phs, "form") + disp + dur(phs, "deliver"))
        )
        wall += w
    return residual / wall if wall else None
