"""One run of one cell: ``python3 -m admission_bench --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``.

In order: makes the run's signature store, TLS identity and policies file
from the seed; starts the client processes; builds the port's native
libraries and boots ``policy_server_tpu_torch`` through its own command
line (``__main__.build_cli`` and ``server_from_args``) on the card; opens
every webhook connection; ramps the closed loop up; measures for
``--seconds``; lets the calls in flight finish; stops the server; holds
every answer against the plain reference in the client processes; and
prints the result as the last line of standard output. ``setup_s`` runs
from the process's start until the window opens.

With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read by ``metrics/<name>.py`` from the
run's record: the calls' timings, the program's counters and flight
recorder over the window, and a ``torch.profiler`` trace of the card.

The run fails, printing no result, when there is no card (or fewer than the
cell asks for), and when ``jax``, ``jaxlib``, ``flax`` or the JAX package
``policy_server_tpu`` was loaded by the time the window closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any

from admission_bench import catalog, stats

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "policy_server_tpu")
# every build and kernel cache of the program, at fixed paths in the checkout
CACHE_DIR = os.path.join(catalog.ROOT, "build", "admission_bench")
CACHE_ENV = {
    "TRITON_CACHE_DIR": "triton",
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "CUDA_CACHE_PATH": "nv_compute",
}
MIN_CORES_TO_PIN = 8


def process_age() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat", encoding="ascii") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime", encoding="ascii") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot), taken
    whole, is one of ``FORBIDDEN_MODULES``."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN_MODULES))


def split_cores(n_clients: int) -> tuple[list[int], list[int]]:
    """(server cores, client cores): disjoint where the machine has enough
    cores, else both all of them."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < MIN_CORES_TO_PIN:
        return cores, cores
    return cores[:-n_clients], cores[-n_clients:]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False,
        )
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def counters(server: Any) -> dict:
    """The program's serving counters, read in process."""
    env = server.env
    return {
        "batcher": dict(server.batcher.stats_snapshot()),
        "dedup": dict(env.dedup_stats),
        "host_profile": dict(env.host_profile),
        "host_fastpath_requests": int(env.host_fastpath_requests),
    }


def stop_logging() -> None:
    """Flush and stop the program's log listener, so that the checks are
    the last lines on standard error."""
    import logging

    for handler in list(logging.getLogger().handlers):
        stop = getattr(handler, "_span_listener_stop", None)
        if stop is not None:
            stop()


class GcPauses:
    """The garbage collector's pauses in this (the server's) process while
    installed: count and seconds per generation, and the longest."""

    def __init__(self) -> None:
        self.seconds = [0.0, 0.0, 0.0]
        self.count = [0, 0, 0]
        self.longest = 0.0
        self._t = 0.0

    def _callback(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
            return
        d = time.perf_counter() - self._t
        g = info["generation"]
        self.seconds[g] += d
        self.count[g] += 1
        self.longest = max(self.longest, d)

    def __enter__(self) -> "GcPauses":
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc: Any) -> None:
        gc.callbacks.remove(self._callback)

    def summary(self) -> dict:
        return {"count": self.count, "seconds": self.seconds, "longest_s": self.longest}


class Lap:
    """The set-up split: seconds of each named step."""

    def __init__(self) -> None:
        self.split = {"process_start_to_main": process_age()}
        self.t = time.monotonic()

    def __call__(self, name: str) -> None:
        now = time.monotonic()
        self.split[name] = self.split.get(name, 0.0) + (now - self.t)
        self.t = now


def start_clients(cell: catalog.Cell, seed: int, policies: dict, port: int,
                  ca_file: str, cores: list[int]) -> list:
    from admission_bench import pods
    from admission_bench.client import client_main

    mix = cell.mix
    policy_ids = list(policies)
    mutating = list(cell.config.get("mutating_webhooks", []))
    # one connection per call a write can have in flight at once; as many
    # writers as keep at most ``calls_in_flight`` calls in flight
    slots = pods.widest_phase(policy_ids, mutating, mix)
    n_writers = max(1, int(mix["calls_in_flight"]) // slots)
    n_procs = max(1, min(int(mix["client_processes"]), n_writers))
    ctx = multiprocessing.get_context("spawn")
    clients = []
    for i in range(n_procs):
        parent, child = ctx.Pipe()
        cfg = {
            "host": "127.0.0.1", "port": port, "ca_file": ca_file, "seed": seed,
            "mix": mix, "policy_ids": policy_ids, "mutating": mutating,
            "slots_per_writer": slots,
            "writers": list(range(i, n_writers, n_procs)), "cores": cores,
        }
        proc = ctx.Process(target=client_main, args=(child, cfg), daemon=True)
        proc.start()
        child.close()
        clients.append((proc, parent))
    return clients


def ask(clients: list, cmd: str, args: tuple = ()) -> list[dict]:
    for _proc, pipe in clients:
        pipe.send((cmd, args))
    out = []
    for _proc, pipe in clients:
        reply = pipe.recv()
        if "error" in reply:
            raise RuntimeError(f"client process failed at {cmd}: {reply['error']}")
        out.append(reply)
    return out


def stop_clients(clients: list) -> None:
    for proc, pipe in clients:
        try:
            pipe.send(("exit", ()))
        except (OSError, BrokenPipeError):
            pass
    for proc, pipe in clients:
        proc.join(30)
        if proc.is_alive():
            proc.kill()
            proc.join(10)
        pipe.close()


def server_argv(cell: catalog.Cell, policies_path: str, cert: str, key: str,
                device: str) -> list[str]:
    argv = [
        "--policies", policies_path, "--addr", "127.0.0.1", "--port", "0",
        "--readiness-probe-port", "0",
        "--compilation-cache-dir", os.path.join(CACHE_DIR, "kernels"),
        *cell.config["server_flags"],
    ]
    if cell.config.get("tls"):
        argv += ["--cert-file", cert, "--key-file", key]
    if device != "cuda":
        argv += ["--device", device]
    return argv


def build_libraries(device: str) -> None:
    """Build (or find built) the program's native libraries in the cache
    directory the server is given, before it boots, so set-up can tell
    builds from the rest."""
    from policy_server_tpu_torch.ops import buildcache, fastenc
    from policy_server_tpu_torch.runtime import native_frontend

    buildcache.set_build_dir(os.path.join(CACHE_DIR, "kernels"))
    if device == "cuda":
        from policy_server_tpu_torch.ops import cuda_kernels

        cuda_kernels.build_library()
    fastenc.build_library()
    native_frontend.build_library()


def boot_server(argv: list[str], lap: Lap) -> Any:
    """The server as ``python -m policy_server_tpu_torch`` builds it, the
    batcher's warm-up timed apart."""
    from policy_server_tpu_torch import __main__ as entry
    from policy_server_tpu_torch.runtime import batcher as batcher_mod
    from policy_server_tpu_torch.telemetry.tracing import setup_tracing

    args = entry.build_cli().parse_args(argv)
    setup_tracing(args.log_level, args.log_fmt, args.log_no_color)
    original = batcher_mod.MicroBatcher.warmup
    warm = [0.0]

    def timed_warmup(self):
        t = time.monotonic()
        try:
            return original(self)
        finally:
            warm[0] += time.monotonic() - t

    batcher_mod.MicroBatcher.warmup = timed_warmup
    try:
        server = entry.server_from_args(args)
    finally:
        batcher_mod.MicroBatcher.warmup = original
    lap("policy_load_and_warmup")
    lap.split["of_which_warmup"] = warm[0]
    server.start()
    lap("server_start")
    return server


def run_cell(cell: catalog.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", lap: Lap | None = None,
             controls: frozenset = frozenset()) -> dict:
    """One run; returns the result object (see the module docstring).
    ``controls`` (for the control tests only) puts the reference with
    those guarantees broken in the program's place when the answers are
    checked (``reference.Reference``)."""
    import torch

    from admission_bench import material
    from admission_bench.trace import H100_HBM_BYTES_PER_S, DeviceTrace, K1Shapes

    lap = lap or Lap()
    mix = cell.mix
    n_procs = int(mix["client_processes"])
    server_cores, client_cores = split_cores(n_procs)
    own_cores = os.sched_getaffinity(0)
    os.sched_setaffinity(0, server_cores)
    run_dir = tempfile.mkdtemp(prefix="admission-bench-")
    clients: list = []
    server = None
    try:
        store = os.path.join(run_dir, "signatures")
        pubkey = material.write_signature_store(store, seed)
        cert, key = material.write_tls_identity(run_dir, seed)
        policies = material.render_policies(cell.policies, pubkey, store)
        policies_path = os.path.join(run_dir, "policies.yml")
        with open(policies_path, "w", encoding="utf-8") as f:
            json.dump(policies, f)
        lap("material")
        if device == "cuda":
            torch.cuda.init()
            torch.zeros(1, device="cuda")
            lap("cuda_init")
        build_libraries(device)
        lap("builds")
        if trace and device == "cuda":
            # the profiler's first start initialises CUPTI, which takes
            # longer than a window: pay it here, not inside the window
            warm = DeviceTrace(run_dir)
            warm.start()
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            warm.stop()
            lap("profiler_init")
        server = boot_server(server_argv(cell, policies_path, cert, key, device), lap)
        clients = start_clients(cell, seed, policies, server.port, cert, client_cores)
        connections = sum(r["connections"] for r in ask(clients, "connect"))
        lap("client_connect")

        ramp = float(mix["ramp_seconds"])
        t_load = time.monotonic() + 0.1
        t0 = t_load + ramp
        t1 = t0 + seconds
        for _proc, pipe in clients:
            pipe.send(("run", (t_load, t1, t1 + float(mix["drain_seconds"]))))
        tracer = shapes = None
        if trace and device == "cuda":
            from policy_server_tpu_torch.ops import cuda_kernels

            time.sleep(max(0.0, t0 - 1.0 - time.monotonic()))
            shapes = K1Shapes(cuda_kernels).__enter__()
            tracer = DeviceTrace(run_dir)
            tracer.start()
            trace_t0 = time.monotonic()
        from policy_server_tpu_torch.telemetry import flightrec

        rec = flightrec.recorder()
        time.sleep(max(0.0, t0 - time.monotonic()))
        before = counters(server)
        cursor0 = rec.events_recorded() if rec is not None else 0
        lap("ramp")
        setup_s = process_age()
        pauses = GcPauses().__enter__()
        cpu0 = time.process_time()
        timeline = [before]
        while time.monotonic() < t1 - 1e-3:
            time.sleep(max(0.0, min(t1, t0 + len(timeline)) - time.monotonic()))
            timeline.append(counters(server))
        after = timeline[-1]
        server_cpu_s = time.process_time() - cpu0
        pauses.__exit__()
        cursor1 = rec.events_recorded() if rec is not None else 0
        if tracer is not None:
            tracer.stop()
            window_s = time.monotonic() - trace_t0
            shapes.__exit__()
        events = (
            [e for e in rec.snapshot() if cursor0 <= e["seq"] < cursor1]
            if trace and rec is not None else []
        )
        memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        loads = [pipe.recv() for _proc, pipe in clients]
        for r in loads:
            if "error" in r:
                raise RuntimeError(f"client process failed: {r['error']}")
        server.stop()
        server = None
        stop_logging()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        for _proc, pipe in clients:
            pipe.send(("verify", (policies, controls)))
        trace_summary = tracer.reduce() if tracer is not None else None
        if trace_summary is not None:
            trace_summary["window_s"] = window_s
        verdicts = []
        for _proc, pipe in clients:
            reply = pipe.recv()
            if "error" in reply:
                raise RuntimeError(f"client process failed at verify: {reply['error']}")
            verdicts.append(reply)
    finally:
        if server is not None:
            server.stop()
        stop_clients(clients)
        shutil.rmtree(run_dir, ignore_errors=True)
        os.sched_setaffinity(0, own_cores)

    calls = [c for r in loads for c in r["calls"]]
    objects = [o for r in loads for o in r["objects"]]
    in_window = [c for c in calls if t0 <= c[1] <= t1]
    unanswered = sum(r["unanswered"] for r in loads)
    failed = sum(1 for c in in_window if c[2] != 0) + unanswered
    # every call of the run (ramp, window, drain) answered without a
    # verdict: a refusal, an in-band 5xx, a body that is no
    # AdmissionReview, a timeout or a dropped connection
    calls_failed = sum(1 for c in calls if c[2] != 0)
    checked = sum(v["checked"] for v in verdicts)
    mismatched = sum(v["mismatched"] for v in verdicts)
    record = {
        "window": (t0, t1),
        "calls": calls,
        "objects": objects,
        "counters": {"before": before, "after": after},
        "events": events,
        "trace": trace_summary,
        "k1": None if shapes is None else {
            "bytes": shapes.total_bytes(), "launches": len(shapes.launches),
        },
        "hbm_bytes_per_s": H100_HBM_BYTES_PER_S,
        "timeline": timeline,
        "server_cpu_s": server_cpu_s,
        "gc_pauses": pauses.summary(),
    }
    rate = stats.window_rate([c[1] for c in calls], [c[2] == 0 for c in calls], t0, t1)
    end_to_end = {"reviews_per_s": rate, "setup_s": setup_s}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        values = {m["name"]: catalog.reader(m["name"])(record) for m in cell.per_layer}
    else:
        values = {m["name"]: end_to_end[m["name"]] for m in cell.end_to_end}
    metrics = {n: {"value": v, "unit": units[n]} for n, v in values.items() if v is not None}
    kind = torch.cuda.get_device_name(0) if device == "cuda" else device
    out: dict = {
        "correct": checked > 0 and mismatched == 0 and unanswered == 0 and calls_failed == 0,
        "attempted": len(in_window) + unanswered,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device == "cuda" else device,
            "kind": kind,
            "count": cell.chips,
            "memory_peak_bytes": memory_peak,
            "power": power_limit() if device == "cuda" else "not read",
        },
    }
    if trace_summary is not None:
        out["device"]["busy_s"] = trace_summary["busy_s"]
        out["device"]["window_s"] = window_s
        out["breakdown"] = {
            "device_ops": [list(x) for x in trace_summary["device_ops"]],
            "idle_gaps": [list(x) for x in trace_summary["idle_gaps"]],
        }
    out["host"] = host_readings(loads, record)
    out["checks"] = {
        "answers_off_reference": {"value": mismatched, "limit": 0},
        "calls_failed": {"value": calls_failed, "limit": 0},
        "calls_never_answered": {"value": unanswered, "limit": 0},
        "answers_checked": {"value": checked, "limit": "> 0"},
    }
    report(lap, loads, verdicts, end_to_end, connections, record, out)
    return out


def report(lap: Lap, loads: list, verdicts: list, end_to_end: dict,
           connections: int, record: dict, out: dict) -> None:
    """Everything but the result, on earlier lines: the set-up split, each
    client process, the window's rate (also in traced runs, which is the
    tracing overhead), K1's launch count, and any mismatch."""
    print(json.dumps({"setup_split_s": lap.split}))
    t0, t1 = record["window"]
    for i, r in enumerate(loads):
        print(json.dumps({
            "client": i, "calls": len(r["calls"]), "objects": len(r["objects"]),
            "cpu_share_of_wall": r["cpu_s"] / r["wall_s"] if r["wall_s"] else None,
            "cpu_probe_us": r["probe_us"],
            "errors": r["n_errors"], "first_errors": r["errors"][:3],
        }))
    print(json.dumps({
        "window_s": t1 - t0, "connections": connections,
        "reviews_per_s": end_to_end["reviews_per_s"], "setup_s": end_to_end["setup_s"],
        **{name: catalog.reader(name)(record)
           for name in ("rows_per_batch", "device_row_share", "cache_hit_share")},
        "k1": record["k1"],
        "k1_traced": None if record["trace"] is None else record["trace"]["k1_kernels"],
    }))
    print(json.dumps({
        "server_cpu_cores": record["server_cpu_s"] / (t1 - t0),
        "gc_pauses_in_window": record["gc_pauses"],
        "per_second": per_second(record),
    }))
    for v in verdicts:
        for ex in v["examples"]:
            print(json.dumps({"mismatch": ex}), file=sys.stderr)
    sys.stdout.flush()
    for name, check in out["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']})", file=sys.stderr)
    sys.stderr.flush()


def host_readings(loads: list, record: dict) -> dict:
    """What the host did in the window, for reading the rate against: the
    client processes' CPU probe (median over processes of each one's median
    second, in us), their CPU per answered call, the server's busy cores,
    the calls in flight on average (Little's law over the window's calls)
    and the collector's pauses in the server."""
    t0, t1 = record["window"]
    probes = sorted(r["probe_us"] for r in loads if r["probe_us"] is not None)
    answered = sum(len(r["calls"]) for r in loads)
    busy = sum(min(done, t1) - max(sent, t0) for sent, done, _kind in record["calls"]
               if done > t0 and sent < t1)
    return {
        "client_cpu_probe_us": probes[len(probes) // 2] if probes else None,
        "client_cpu_us_per_call": (
            1e6 * sum(r["cpu_s"] for r in loads) / answered if answered else None),
        "server_cpu_cores": record["server_cpu_s"] / (t1 - t0),
        "calls_in_flight_mean": busy / (t1 - t0),
        "server_gc_pause_s": sum(record["gc_pauses"]["seconds"]),
    }


def per_second(record: dict) -> dict:
    """Each second of the window: calls answered with a verdict, rows per
    batch and the card's share of rows, from the counters read each
    second."""
    t0, _t1 = record["window"]
    calls = [0] * (len(record["timeline"]) - 1)
    for _sent, done, kind in record["calls"]:
        i = int(done - t0)
        if kind == 0 and 0 <= done - t0 and i < len(calls):
            calls[i] += 1
    rows, share = [], []
    for a, b in zip(record["timeline"], record["timeline"][1:]):
        pair = {"counters": {"before": a, "after": b}}
        rows.append(catalog.reader("rows_per_batch")(pair))
        share.append(catalog.reader("device_row_share")(pair))
    return {"calls": calls, "rows_per_batch": rows, "device_row_share": share}


def parse_args(argv: list[str] | None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="admission_bench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    lap = Lap()
    args = parse_args(argv)
    cell = catalog.cell(args.workload)
    for var, sub in CACHE_ENV.items():
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    import torch

    lap("import_torch")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(
            f"admission_bench: {args.workload} needs {cell.chips} CUDA card(s); "
            f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
            file=sys.stderr,
        )
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", lap)
    found = forbidden_modules()
    if found:
        print(f"admission_bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
