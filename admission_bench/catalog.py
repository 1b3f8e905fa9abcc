"""Everything a run looks up by name: the cell in ``BENCHMARK.json``, its
configuration's directory, its traffic mix and the readers of its per-layer
metrics. A new configuration, mix, cell or metric is new files and entries;
nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Any, Callable

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the config's JSON file, with "dir" added
    policies: dict        # the policies file as data (placeholders kept)
    mix: dict             # the traffic file
    end_to_end: list      # the manifest's entries this cell reports
    per_layer: list


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` (or of ``bench``,
    a manifest in that form), with its files read from under ``root``."""
    bench = manifest(root) if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg_path = os.path.join(root, cfg_entry["file"])
    with open(cfg_path, encoding="utf-8") as f:
        config = json.load(f)
    config["dir"] = os.path.dirname(cfg_path)
    with open(os.path.join(config["dir"], config["policies"]), encoding="utf-8") as f:
        policies = json.load(f)
    traffic = os.path.join(root, os.path.basename(BENCH_DIR), "traffic", w["traffic"] + ".json")
    with open(traffic, encoding="utf-8") as f:
        mix = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name) and m["moves"] in e2e_names]
    return Cell(name, int(w["chips"]), config, policies, mix, e2e, per_layer)


def reader(metric: str) -> Callable[[dict], Any]:
    """``metrics/<name>.py``'s ``read``: the run's record → the number, or
    None when the run holds nothing to read it from."""
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"admission_bench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
