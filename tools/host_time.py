"""Where the server's host time goes, from the flight recorder of traced
``admission_bench`` runs: wall and CPU time per recorder phase, CPU time per
stamping thread, the spans' CPU against the process's, the ``gc`` spans
against the harness's own collector probe (``GcPauses``), and the ring's
events per second; then the cost of the recorder's writes, of the CPU clock
and of the ``gc`` hook on this host.

    python3 tools/host_time.py OUT.json SEED [SEED ...] [--seconds 51]
        [--workload flagship32.fanout] [--cpu]

Run from the repository root, on a card; each seed is one ``--trace 1`` run
of the cell, and its result line is printed as the harness prints it.
``--cpu`` runs each seed on the CPU instead, at 40 calls in flight from two
client processes: a rehearsal of this script, not a measurement.

The harness keeps the run's record (``window``, ``events``,
``server_cpu_s``, ``gc_pauses``) to itself and hands it to each per-layer
metric's reader, so this script wraps ``admission_bench.catalog.reader`` to
keep a copy, and wraps ``FlightRecorder.events_recorded`` for the ring's
cursor at each end of the window (the events written there, whether or not
the ring still holds them)."""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import sys
import time
import timeit

DEVICE_WAITS = ("fetch", "device_execute")


def phase_table(events: list[dict]) -> dict:
    """Per phase: spans, rows, wall and CPU seconds, µs a row, and the share
    of wall the stamping thread spent off the CPU (spans with CPU time)."""
    out: dict = {}
    for e in events:
        if e["kind"] != "batch":
            continue
        p = out.setdefault(
            e["phase"], {"spans": 0, "rows": 0, "wall_s": 0.0, "cpu_s": 0.0, "cpu_spans": 0}
        )
        p["spans"] += 1
        p["rows"] += e["rows"]
        p["wall_s"] += max(0, e["end_ns"] - e["start_ns"]) / 1e9
        if "cpu_ns" in e:
            p["cpu_s"] += e["cpu_ns"] / 1e9
            p["cpu_spans"] += 1
    for p in out.values():
        rows = max(1, p["rows"])
        p["wall_us_per_row"] = p["wall_s"] / rows * 1e6
        timed = p["cpu_spans"] > 0
        p["cpu_us_per_row"] = p["cpu_s"] / rows * 1e6 if timed else None
        p["off_cpu_share"] = (
            1 - p["cpu_s"] / p["wall_s"] if timed and p["wall_s"] else None
        )
    return out


def thread_table(events: list[dict], names: dict[int, str]) -> dict:
    """Per stamping thread: the CPU and wall seconds of its spans (device
    waits and collections left out: they nest in other spans) and its CPU
    seconds per phase."""
    out: dict = {}
    for e in events:
        if "thread" not in e or e["phase"] in (*DEVICE_WAITS, "gc"):
            continue
        name = names.get(e["thread"], str(e["thread"]))
        t = out.setdefault(name, {"cpu_s": 0.0, "wall_s": 0.0, "phases": {}})
        t["cpu_s"] += e["cpu_ns"] / 1e9
        t["wall_s"] += (e["end_ns"] - e["start_ns"]) / 1e9
        t["phases"][e["phase"]] = t["phases"].get(e["phase"], 0.0) + e["cpu_ns"] / 1e9
    return out


def breakdown(record: dict, cursors: list[int], names: dict[int, str],
              ring_capacity: int | None) -> dict:
    events = record["events"]
    t0, t1 = record["window"]
    window_s = t1 - t0
    phases = phase_table(events)
    spans = [e for e in events if e["kind"] != "mix"]
    gc_s = [0.0, 0.0, 0.0]
    gc_n = [0, 0, 0]
    for e in events:
        if e["phase"] == "gc":
            gc_s[e["rows"]] += (e["end_ns"] - e["start_ns"]) / 1e9
            gc_n[e["rows"]] += 1
    written = cursors[-1] - cursors[-2] if len(cursors) >= 2 else None
    return {
        "window_s": window_s,
        "events_kept": len(events),
        "events_written": written,
        "events_per_s": written / window_s if written else None,
        "ring_capacity": ring_capacity,
        "ring_held_window": written is not None and ring_capacity is not None
        and written <= ring_capacity,
        "events_span_s": (
            (max(e["end_ns"] for e in spans) - min(e["start_ns"] for e in spans)) / 1e9
            if spans else None
        ),
        "phases": phases,
        "threads": thread_table(events, names),
        "span_cpu_s": sum(
            p["cpu_s"] for k, p in phases.items() if k not in (*DEVICE_WAITS, "gc")
        ),
        "server_cpu_s": record["server_cpu_s"],
        "gc_spans": {"seconds": gc_s, "count": gc_n, "total_s": sum(gc_s)},
        "gc_probe": record["gc_pauses"],
        "gc_probe_total_s": sum(record["gc_pauses"]["seconds"]),
    }


def recorder_costs(flightrec) -> dict:
    """ns per call on this host, the best of five repeats."""
    rec = flightrec.FlightRecorder()
    n = 200_000

    def per_call(fn, number=n):
        return min(timeit.repeat(fn, number=number, repeat=5)) / number * 1e9

    costs = {
        "record_phase_ns": per_call(
            lambda: rec.record_phase("encode", 1, 2, rows=4, batch=3)
        ),
        "record_phase_cpu_ns": per_call(
            lambda: rec.record_phase("encode", 1, 2, rows=4, batch=3, cpu_ns=5)
        ),
        "thread_time_ns_ns": per_call(time.thread_time_ns),
        "perf_counter_ns_ns": per_call(time.perf_counter_ns),
    }
    keep = [[i] for i in range(100_000)]  # a young generation worth walking
    flightrec.install(None)
    costs["gc0_no_hook_ns"] = per_call(lambda: gc.collect(0), number=2000)
    flightrec.install(rec)
    costs["gc0_hook_ns"] = per_call(lambda: gc.collect(0), number=2000)
    flightrec.install(None)
    del keep
    return costs


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("seeds", nargs="+")
    ap.add_argument("--seconds", default="51")
    ap.add_argument("--workload", default="flagship32.fanout")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    from admission_bench import catalog
    from admission_bench import run as bench
    from policy_server_tpu_torch.telemetry import flightrec

    kept: dict = {}
    read = catalog.reader

    def keeping_reader(name):
        fn = read(name)

        def wrapped(record):
            if "events" in record:  # the run's record, not a trace summary
                kept["record"] = record
            return fn(record)

        return wrapped

    catalog.reader = keeping_reader
    events_recorded = flightrec.FlightRecorder.events_recorded

    def counting(self):
        n = events_recorded(self)
        kept.setdefault("cursors", []).append(n)
        kept["names"] = self.thread_names()
        kept["capacity"] = self._cap
        return n

    flightrec.FlightRecorder.events_recorded = counting

    runs = []
    for seed in args.seeds:
        kept.clear()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if args.cpu:
                cell = catalog.cell(args.workload)
                cell.mix.update(
                    {"calls_in_flight": 40, "client_processes": 2, "ramp_seconds": 0.5}
                )
                print(json.dumps(bench.run_cell(cell, int(seed), float(args.seconds), True, "cpu")))
                rc = 0
            else:
                rc = bench.main([
                    "--workload", args.workload, "--seed", seed,
                    "--seconds", args.seconds, "--trace", "1",
                ])
        text = buf.getvalue()
        print(text, end="", flush=True)
        if rc != 0 or "record" not in kept:
            print(f"host_time: seed {seed} gave no record (rc {rc})", file=sys.stderr)
            return 1
        b = breakdown(kept["record"], kept.get("cursors", []), kept.get("names", {}),
                      kept.get("capacity"))
        b.update(seed=seed, seconds=args.seconds,
                 result=json.loads(text.strip().splitlines()[-1]))
        runs.append(b)
        print(json.dumps({k: b[k] for k in (
            "seed", "events_per_s", "ring_held_window", "gc_spans",
            "gc_probe_total_s", "span_cpu_s", "server_cpu_s",
        )}), flush=True)
    costs = recorder_costs(flightrec)
    print(json.dumps({"costs": costs}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump({"runs": runs, "costs": costs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
