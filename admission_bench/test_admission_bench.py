"""The benchmark's own CPU tests: ``python -m pytest admission_bench``.

They run the harness end to end against the port on the CPU at a tiny
load (the kernels' plain PyTorch versions, the native frontend over TLS),
hold the manifest to its contract, check the arithmetic of the window's
rate and tails, find a configuration and a mix added as files, and see
``correct`` come out false when the served answers are broken.
"""

from __future__ import annotations

import json
import os
import random
import re
import shutil
import sys

import pytest

from admission_bench import catalog, pods, reference, run, stats
from admission_bench.trace import k1_launch_bytes, reduce_trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = ("flagship32.fanout", "pss-restricted.fanout")


def with_pss() -> dict:
    """The manifest with the ``pss-restricted.fanout`` cell added. Its
    configuration's files are here; ``PERF.md`` says why its cell is not
    in ``BENCHMARK.json`` yet."""
    bench = catalog.manifest()
    bench["configs"].append({
        "name": "pss-restricted", "source": "test", "reduced": [], "why": "test",
        "file": "admission_bench/configs/pss-restricted/config.json"})
    bench["workloads"].append({
        "name": "pss-restricted.fanout", "config": "pss-restricted", "traffic": "fanout",
        "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + ["pss-restricted.fanout"]
    return bench


def get_cell(name: str) -> catalog.Cell:
    return catalog.cell(name, bench=with_pss())


def tiny(cell: catalog.Cell, calls: int = 40) -> catalog.Cell:
    cell.mix.update({"calls_in_flight": calls, "client_processes": 2, "ramp_seconds": 0.5})
    return cell


def cpu_run(cell: catalog.Cell, seconds: float = 2.0, trace: bool = False, seed: int = 2**31 + 12345):
    return run.run_cell(cell, seed, seconds, trace, device="cpu")


# -- the manifest -------------------------------------------------------------


def test_manifest_names_units_and_files():
    bench = catalog.manifest()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["admission_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]] \
        + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert all(NAME.match(n) for n in names), names
    assert len({c["name"] for c in bench["configs"]}) == len(bench["configs"])
    assert len({w["name"] for w in bench["workloads"]}) == len(bench["workloads"])
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("admission_bench/") and os.path.isfile(
            os.path.join(catalog.ROOT, c["file"]))
        assert isinstance(c["reduced"], list) and all(NAME.match(k) for k in c["reduced"])
    config_names = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in config_names and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert os.path.isfile(os.path.join(catalog.BENCH_DIR, "traffic", w["traffic"] + ".json"))
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "source", "bound", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert isinstance(m["bound"], (int, float)) and 0 < m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}
        assert os.path.isfile(os.path.join(catalog.BENCH_DIR, "metrics", m["name"] + ".py"))
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cells_resolve_by_name(name):
    cell = get_cell(name)
    assert {m["name"] for m in cell.end_to_end} >= {"reviews_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} >= {
        "p95_ms", "object_p95_ms", "frontend_us_per_row", "rows_per_batch", "device_row_share",
        "cache_hit_share", "encode_us_per_row", "device_idle_share", "k1_roofline"}
    assert cell.config["tls"] and "--frontend" in cell.config["server_flags"]


# -- arithmetic ---------------------------------------------------------------


def test_window_rate_counts_only_verdicts_answered_inside_the_window():
    done = [0.5, 1.0, 1.5, 2.0, 2.9, 3.0, 3.1]
    ok = [True, True, False, True, True, True, True]
    # in [1, 3]: 1.0, 2.0, 2.9, 3.0 answered with a verdict; 1.5 failed
    assert stats.window_rate(done, ok, 1.0, 3.0) == 4 / 2.0


@pytest.mark.parametrize("q", [50, 95, 99])
def test_percentile_matches_numpy_over_every_value(q):
    np = pytest.importorskip("numpy")
    rng = random.Random(q)
    values = [rng.expovariate(1.0) for _ in range(1001)]
    assert stats.percentile(values, q) == pytest.approx(float(np.percentile(values, q)))
    assert stats.percentile([], q) is None


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx((5.25 - 1.75) / 3.5)


def test_tail_readers_take_every_answer_of_the_window():
    record = {
        "window": (10.0, 20.0),
        # (sent, done, kind): one before the window, one failed, one after
        "calls": [(9.0, 9.5, 0), (10.0, 10.1, 0), (11.0, 11.2, 0), (12.0, 12.3, 1), (19.0, 21.0, 0)],
        "objects": [(9.9, 10.1, True), (11.0, 11.2, True), (19.0, 21.0, True)],
    }
    assert catalog.reader("p95_ms")(record) == pytest.approx(
        stats.percentile([100.0, 200.0], 95))
    assert catalog.reader("object_p95_ms")(record) == pytest.approx(
        stats.percentile([200.0, 200.0], 95))


def test_counter_readers_take_window_deltas():
    def c(batches, rows, host, bh, bm, rh):
        return {"batcher": {"batches_dispatched": batches, "requests_dispatched": rows},
                "dedup": {"blob_cache_hits": bh, "blob_cache_misses": bm, "cache_hits": rh},
                "host_profile": {}, "host_fastpath_requests": host}
    record = {"counters": {"before": c(10, 500, 100, 5, 95, 0),
                           "after": c(20, 1500, 350, 15, 985, 100)}}
    assert catalog.reader("rows_per_batch")(record) == 100.0
    assert catalog.reader("device_row_share")(record) == 0.75
    assert catalog.reader("cache_hit_share")(record) == (10 + 100) / 900
    empty = {"counters": {"before": c(0, 0, 0, 0, 0, 0), "after": c(0, 0, 0, 0, 0, 0)}}
    for name in ("rows_per_batch", "device_row_share", "cache_hit_share"):
        assert catalog.reader(name)(empty) is None


def test_trace_reduction_and_k1_roofline(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "void policy_matrix_kernel<0>", "ts": 100, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 105, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 300, "dur": 20},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 50, "dur": 40},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 290, "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaEventSynchronize", "ts": 320, "dur": 80},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = reduce_trace(str(path))
    # busy: [100, 115] and [300, 320]; span [50, 400]
    assert t["busy_s"] == pytest.approx(35e-6)
    assert t["span_s"] == pytest.approx(350e-6)
    gaps = dict(t["idle_gaps"])
    assert gaps["cudaLaunchKernel"] == pytest.approx(40e-6)
    assert gaps["cudaEventSynchronize"] == pytest.approx(80e-6)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(5e-6)
    assert sum(gaps.values()) == pytest.approx(315e-6)
    assert t["k1_kernels"] == 1 and t["k1_seconds"] == pytest.approx(10e-6)
    t["window_s"] = 350e-6
    assert catalog.reader("device_idle_share")({"trace": t}) == pytest.approx(1 - 35 / 350)
    launch = k1_launch_bytes(128, 364, 36)
    assert launch == 128 * 364 + 128 * 36 * 5
    record = {"trace": t, "k1": {"bytes": 2 * launch, "launches": 2}, "hbm_bytes_per_s": 3.35e12}
    # one of the two launches in the trace: its bytes over its time
    assert catalog.reader("k1_roofline")(record) == pytest.approx(
        100 * launch / 3.35e12 / 10e-6)
    assert catalog.reader("k1_roofline")({"trace": None, "k1": None}) is None


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "policy_server_tpu_torch_probe", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "policy_server_tpu.server", object())
    assert run.forbidden_modules() == ["jax", "policy_server_tpu"]


# -- traffic --------------------------------------------------------------------


def test_object_writes_are_fixed_by_seed_writer_and_index():
    mix = get_cell("flagship32.fanout").mix
    def body(seed, writer, index):
        return pods.review_body(pods.object_review(seed, writer, index, mix))

    a = body(2**31 + 7, 3, 11)
    assert a == body(2**31 + 7, 3, 11)
    assert a != body(2**31 + 8, 3, 11)
    assert a != body(2**31 + 7, 4, 11)


def test_pss_fields_keep_the_generator_and_hit_each_control():
    mix = dict(get_cell("pss-restricted.fanout").mix)
    base = dict(mix, pss_field_rate=0.0)
    seen = {"procMount": 0, "seLinuxOptions": 0, "runAsUser": 0, "sysctls": 0}
    containers = 0
    for k in range(3000):
        plain = pods.object_review(5, 0, k, base)
        full = pods.object_review(5, 0, k, mix)
        for c_plain, c_full in zip(plain["request"]["object"]["spec"]["containers"],
                                   full["request"]["object"]["spec"]["containers"]):
            containers += 1
            assert c_plain["image"] == c_full["image"]
            sc = c_full.get("securityContext", {})
            for f in ("procMount", "seLinuxOptions", "runAsUser"):
                seen[f] += f in sc
        seen["sysctls"] += "securityContext" in full["request"]["object"]["spec"]
    for f in ("procMount", "seLinuxOptions", "runAsUser"):
        assert 0.03 < seen[f] / containers < 0.07, seen
    assert 0.03 < seen["sysctls"] / 3000 < 0.07


@pytest.mark.parametrize("name", CELLS)
def test_mutating_webhooks_are_the_policies_allowed_to_mutate_in_name_order(name):
    """Kubewarden registers a policy allowed to mutate as a mutating
    webhook, and the API server calls those by configuration name."""
    cell = get_cell(name)
    allowed = [p for p, spec in cell.policies.items() if spec.get("allowedToMutate")]
    assert cell.config["mutating_webhooks"] == sorted(allowed)


def test_fanout_calls_the_mutating_webhooks_in_turn_then_the_rest_at_once():
    cell = get_cell("flagship32.fanout")
    ids = list(cell.policies)
    mutating = cell.config["mutating_webhooks"]
    assert len(ids) == 32 and mutating == ["psp-capabilities", "raw-gate"]
    phases = pods.phases(ids, mutating, 1, 0, 0, cell.mix)
    assert phases[:2] == [["psp-capabilities"], ["raw-gate"]]
    assert phases[2] == [p for p in ids if p not in mutating]
    assert pods.widest_phase(ids, mutating, cell.mix) == 30
    assert pods.phases(ids, [], 1, 0, 0, cell.mix) == [ids]
    one = pods.phases(ids, mutating, 1, 0, 0, dict(cell.mix, fanout="one"))
    assert len(one) == 1 and len(one[0]) == 1


def test_json_patch_is_applied_as_the_api_server_applies_it():
    doc = {"spec": {"containers": [{"name": "a"}, {"name": "b"}]}, "x~y/z": 1}
    out = pods.apply_patch(doc, [
        {"op": "add", "path": "/spec/containers/0/securityContext", "value": {}},
        {"op": "add", "path": "/spec/containers/0/securityContext/capabilities",
         "value": {"drop": ["ALL"]}},
        {"op": "add", "path": "/spec/containers/-", "value": {"name": "c"}},
        {"op": "replace", "path": "/spec/containers/1/name", "value": "B"},
        {"op": "remove", "path": "/x~0y~1z"},
        {"op": "add", "path": "/validated", "value": True},
    ])
    assert out == {"spec": {"containers": [
        {"name": "a", "securityContext": {"capabilities": {"drop": ["ALL"]}}},
        {"name": "B"}, {"name": "c"}]}, "validated": True}
    assert doc == {"spec": {"containers": [{"name": "a"}, {"name": "b"}]}, "x~y/z": 1}
    # a value the patch adds is copied, so later operations leave the patch as it was
    ops = [{"op": "add", "path": "/a", "value": {}}, {"op": "add", "path": "/a/b", "value": 1}]
    assert pods.apply_patch({}, ops) == {"a": {"b": 1}} and ops[0]["value"] == {}
    with pytest.raises(KeyError):
        pods.apply_patch(doc, [{"op": "replace", "path": "/missing", "value": 1}])


def test_expected_answers_follow_the_mutations_and_stop_at_a_denial():
    """Each webhook of the chain sees the object as the patches before it
    left it; a mutating webhook that denies ends the write."""
    from admission_bench.client import expected_answers

    class Stub:
        def __init__(self, deny=()):
            self.seen, self.deny = {}, deny

        def answer(self, pid, review):
            self.seen[pid] = review["request"]["object"]
            if pid in self.deny:
                return {"uid": "u", "allowed": False}
            if pid.startswith("m"):
                return {"uid": "u", "allowed": True, "patchType": "JSONPatch",
                        "patch": [{"op": "add", "path": f"/{pid}", "value": True}]}
            return {"uid": "u", "allowed": True}

    review = {"request": {"uid": "u", "object": {"o": 1}}}
    stub = Stub()
    want = expected_answers(stub, review, [["m1"], ["m2"], ["v1", "v2"]])
    assert set(want) == {"m1", "m2", "v1", "v2"}
    assert stub.seen["m1"] == {"o": 1}
    assert stub.seen["m2"] == {"o": 1, "m1": True}
    assert stub.seen["v1"] == stub.seen["v2"] == {"o": 1, "m1": True, "m2": True}
    assert review == {"request": {"uid": "u", "object": {"o": 1}}}
    stub = Stub(deny=("m1",))
    assert set(expected_answers(stub, review, [["m1"], ["m2"], ["v1"]])) == {"m1"}


# -- the reference and the controls ------------------------------------------------


def served_policies(cell: catalog.Cell, tmp_path, seed: int = 9) -> dict:
    from admission_bench import material

    store = str(tmp_path / "signatures")
    pub = material.write_signature_store(store, seed)
    return material.render_policies(cell.policies, pub, store)


@pytest.mark.parametrize("name,control", [
    ("flagship32.fanout", "skip_signatures"),
    ("flagship32.fanout", "drop_patches"),
    ("pss-restricted.fanout", "drop_patches"),
])
def test_controls_differ_from_the_reference(name, control, tmp_path):
    cell = get_cell(name)
    policies = served_policies(cell, tmp_path)
    ref = reference.Reference(policies)
    broken = reference.Reference(policies, frozenset({control}))
    differ = sum(
        ref.answer(pid, review) != broken.answer(pid, review)
        for k in range(200)
        for review in [pods.object_review(9, 0, k, cell.mix)]
        for pid in policies
    )
    assert differ > 0


def test_reference_matches_the_ports_environment_on_both_sets(tmp_path):
    """The reference against the port's environment, call by call, on the
    host oracle's backend and on the plain PyTorch device path."""
    from policy_server_tpu_torch.api.service import RequestOrigin, evaluate
    from policy_server_tpu_torch.evaluation.environment import EvaluationEnvironmentBuilder
    from policy_server_tpu_torch.models import AdmissionReviewRequest, ValidateRequest
    from policy_server_tpu_torch.server import parse_policies

    for name in CELLS:
        cell = get_cell(name)
        policies = served_policies(cell, tmp_path)
        ref = reference.Reference(policies)
        env = EvaluationEnvironmentBuilder(device="cpu").build(parse_policies(policies))
        for k in range(30):
            review = pods.object_review(9, 1, k, cell.mix)
            req = ValidateRequest.from_admission(AdmissionReviewRequest.from_dict(review).request)
            for pid in policies:
                got = reference.normalize(evaluate(env, pid, req, RequestOrigin.VALIDATE).to_dict())
                assert got == ref.answer(pid, review), (name, pid, k)


# -- whole runs on the CPU ------------------------------------------------------------


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("route", ["host", "device"])
def test_run_is_correct_on_each_batcher_route(name, route):
    """A whole run, served over TLS by the native frontend, every answer
    held against the reference: once with every micro-batch on the host
    oracle's route and once with every one on the device route (the plain
    PyTorch kernels on the CPU)."""
    cell = tiny(get_cell(name))
    threshold = "100000" if route == "host" else "0"
    cell.config["server_flags"] = cell.config["server_flags"] + [
        "--host-fastpath-threshold", threshold, "--latency-budget-ms", "0"]
    out = cpu_run(cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["checks"]["answers_checked"]["value"] > 100
    share = out["metrics"]["device_row_share"]["value"]
    if route == "device":
        assert share == 1.0
    else:
        # a host-routed batch dispatched before the close and answered after
        # it counts in the dispatched rows only (the reader's docstring)
        assert share < 0.05, share
    assert out["failed"] == 0
    # mutations were served and held: psp-capabilities patches every set
    assert out["metrics"]["rows_per_batch"]["value"] > 1


def test_default_run_reports_the_end_to_end_metrics():
    cell = tiny(get_cell("pss-restricted.fanout"))
    out = cpu_run(cell, trace=False)
    assert out["correct"]
    assert set(out["metrics"]) == {"reviews_per_s", "setup_s"}
    assert out["metrics"]["reviews_per_s"]["value"] > 0
    assert list(out)[-1] == "checks"
    assert out["host"]["calls_in_flight_mean"] > 0 and out["host"]["server_cpu_cores"] > 0
    assert run.forbidden_modules() == []


@pytest.mark.parametrize("fault", ["verdict_flipped", "patch_dropped", "half_failed"])
def test_a_broken_answer_makes_the_run_incorrect(fault, monkeypatch):
    """The timed path broken underneath: the environment's answer altered
    where it is produced (a denial flipped, a patch dropped, or every
    second answer an in-band 504 in place of its verdict, half of the
    calls left out). The run must say ``correct: false``."""
    from policy_server_tpu_torch.evaluation import environment
    from policy_server_tpu_torch.models import AdmissionResponse

    original = environment.EvaluationEnvironment._materialize_single
    count = [0]

    def broken(self, bp, uid, payload_fn, outputs):
        response = original(self, bp, uid, payload_fn, outputs)
        if fault == "verdict_flipped" and not response.allowed:
            response.allowed, response.status = True, None
        if fault == "patch_dropped":
            response.patch = response.patch_type = None
        if fault == "half_failed":
            count[0] += 1
            if count[0] % 2:
                return AdmissionResponse.reject(
                    uid, "request deadline exceeded before evaluation", 504)
        return response

    monkeypatch.setattr(environment.EvaluationEnvironment, "_materialize_single", broken)
    cell = tiny(get_cell("pss-restricted.fanout"))
    cell.config["server_flags"] = cell.config["server_flags"] + ["--verdict-cache-size", "0"]
    out = cpu_run(cell)
    assert not out["correct"]
    if fault == "half_failed":
        # no answer is off the reference: the failed calls alone fail it
        assert out["checks"]["answers_off_reference"]["value"] == 0
        assert out["checks"]["calls_failed"]["value"] > 0
    else:
        assert out["checks"]["answers_off_reference"]["value"] > 0


def test_a_configuration_and_a_mix_added_as_files_run_without_harness_edits(tmp_path):
    """A new configuration directory, a new traffic file and a new cell in
    BENCHMARK.json: found by name, and a run of the cell is correct."""
    root = tmp_path / "checkout"
    shutil.copytree(catalog.BENCH_DIR, root / "admission_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg_dir = root / "admission_bench" / "configs" / "three"
    cfg_dir.mkdir()
    (cfg_dir / "policies.yml").write_text(json.dumps({
        "privileged": {"module": "builtin://pod-privileged"},
        # mutating: adds NET_RAW to every container; the validating
        # caps-check denies it, so its answers hold only on the mutated
        # object the client has to send it
        "caps": {"module": "builtin://psp-capabilities", "allowedToMutate": True,
                 "settings": {"allowed_capabilities": ["*"],
                              "default_add_capabilities": ["NET_RAW"]}},
        "caps-check": {"module": "builtin://psp-capabilities",
                       "settings": {"allowed_capabilities": ["CHOWN"]}},
        "ns": {"module": "builtin://namespace-validate",
               "settings": {"denied_namespaces": ["kube-system"]}},
    }))
    (cfg_dir / "config.json").write_text(json.dumps({
        "name": "three", "source": "test", "policies": "policies.yml",
        "server_flags": ["--frontend", "native", "--workers", "8"], "tls": True,
        "mutating_webhooks": ["caps"], "reduced": [], "assumed": {}}))
    mix = json.loads((root / "admission_bench" / "traffic" / "fanout.json").read_text())
    mix.update({"replay_share": 0.8, "replay_window": 64})
    (root / "admission_bench" / "traffic" / "replay.json").write_text(json.dumps(mix))
    bench = catalog.manifest()
    bench["configs"].append({"name": "three", "source": "test",
                             "file": "admission_bench/configs/three/config.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "three.replay", "config": "three",
                               "traffic": "replay", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = tiny(catalog.cell("three.replay", root=str(root)), calls=30)
    assert list(cell.policies) == ["privileged", "caps", "caps-check", "ns"]
    assert cell.mix["replay_share"] == 0.8
    assert cell.per_layer == []  # no per-layer metric lists the new cell
    out = cpu_run(cell)
    assert out["correct"], out["checks"]
    assert out["metrics"]["reviews_per_s"]["value"] > 0


def test_a_control_run_is_not_correct():
    """The control path of a run (the card test runs it at the cells' own
    load): answers held against the reference with a guarantee broken."""
    cell = tiny(get_cell("pss-restricted.fanout"))
    out = run.run_cell(cell, 2**31 + 77, 2.0, False, "cpu", controls=frozenset({"drop_patches"}))
    assert not out["correct"]
    assert out["checks"]["answers_off_reference"]["value"] > 0
