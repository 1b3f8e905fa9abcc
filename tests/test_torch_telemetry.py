"""The port's telemetry (``policy_server_tpu_torch/telemetry/``) against the
JAX package's, on the CPU.

* Metrics: the same reviews through both environments' ``validate_batch``
  and service halves, and through both micro-batchers (monitor mode, raw
  requests, the always-accept namespace, a policy that failed to
  initialize, cache-hit fragments), each package with a fresh registry:
  ``kubewarden_policy_evaluations_total`` equal for every label set, the
  same number of latency samples per label set, and the parsed
  expositions' families, types, label keys and bucket bounds equal
  (``_created`` samples left out: the port writes none).
* Flight recorder: one scripted event sequence with fixed clocks into both
  packages' recorders — ``snapshot()``, ``attribution()`` and the phase
  histograms equal, ``chrome_trace_json()`` byte-equal — and the ring,
  torn-slot, row-sampling, exemplar and attribution cases of
  ``tests/test_flightrec.py`` as tests of the port's copy.
* The port's batcher stamps each of its phases once per batch, and a
  recorder or metrics fault fails requests loudly instead of turning them
  into host answers.

Tolerance: exact equality.
"""

from __future__ import annotations

import copy
import json
import logging
import time

import pytest
from prometheus_client.parser import text_string_to_metric_families

from policy_server_tpu.api import service as jservice
from policy_server_tpu.models import AdmissionReviewRequest as JReview
from policy_server_tpu.models import RawReviewRequest as JRaw
from policy_server_tpu.models import ValidateRequest as JRequest
from policy_server_tpu.runtime.batcher import MicroBatcher as JaxBatcher
from policy_server_tpu.telemetry import flightrec as jflightrec
from policy_server_tpu.telemetry import metrics as jmetrics
from policy_server_tpu.telemetry import tracing as jtracing
from policy_server_tpu_torch.api import service as tservice
from policy_server_tpu_torch.models import AdmissionReviewRequest as TReview
from policy_server_tpu_torch.models import RawReviewRequest as TRaw
from policy_server_tpu_torch.models import ValidateRequest as TRequest
from policy_server_tpu_torch.runtime.batcher import MicroBatcher
from policy_server_tpu_torch.telemetry import flightrec
from policy_server_tpu_torch.telemetry import metrics
from policy_server_tpu_torch.telemetry import tracing
from policy_server_tpu_torch.telemetry.flightrec import (
    PH_DELIVER,
    PH_DISPATCH,
    PH_FORM,
    PH_QUEUE_WAIT,
    PHASES,
    FlightRecorder,
)

from conftest import build_admission_review_dict
from torch_port_support import (
    catalog_docs,
    catalog_specs,
    firehose_docs,
    flagship_specs,
    items_for,
    jax_env,
    sync_envs,
    torch_env,
)

EVALS = metrics.EVALUATIONS_TOTAL


@pytest.fixture(autouse=True)
def fresh_telemetry():
    """Each test starts and ends with fresh process registries and no
    installed recorder, in both packages."""
    jmetrics.reset_metrics_for_tests()
    metrics.reset_metrics_for_tests()
    yield
    jmetrics.reset_metrics_for_tests()
    metrics.reset_metrics_for_tests()
    jflightrec.install(None)
    flightrec.install(None)


def pallas_env(specs: dict, **kw):
    env = jax_env(specs, kernel="pallas", **kw)
    env._pallas_armed.update(range(len(env.schemas)))
    env._pallas_interpret = True
    return env


def families(reg) -> dict:
    """name → (type, label keys, bucket bounds) of a registry's parsed
    exposition, ``_created`` left out."""
    out = {}
    for fam in text_string_to_metric_families(reg.exposition().decode()):
        if fam.name.endswith("_created"):
            continue
        keys = set()
        bounds = set()
        for s in fam.samples:
            if s.name.endswith("_created"):
                continue
            keys |= set(s.labels) - {"le"}
            if "le" in s.labels:
                bounds.add(float(s.labels["le"]))
        out[fam.name] = (fam.type, sorted(keys), sorted(bounds))
    return out


def eval_label_sets(reg) -> list[dict]:
    for fam in text_string_to_metric_families(reg.exposition().decode()):
        if fam.name + "_total" == EVALS:
            return sorted(
                (s.labels for s in fam.samples if s.name == EVALS),
                key=lambda d: sorted(d.items()),
            )
    return []


def assert_registries_agree(jreg, treg) -> int:
    """Equal counts and latency-sample counts per label set, and equal
    families; returns the number of evaluations."""
    assert families(treg) == families(jreg)
    sets = eval_label_sets(jreg)
    assert sets and eval_label_sets(treg) == sets
    for labels in sets:
        assert treg.counter_value(EVALS, labels) == jreg.counter_value(EVALS, labels)
        assert len(treg.latency_samples(labels)) == len(jreg.latency_samples(labels))
    assert treg.counter_value(metrics.INIT_ERRORS_TOTAL) == jreg.counter_value(
        jmetrics.INIT_ERRORS_TOTAL
    )
    return int(treg.counter_value(EVALS))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["flagship", "catalog"])
def test_validate_batch_metrics_match_jax(which):
    """Both environments' verdicts through their service's post-dispatch
    half, one batched flush each: the same counts per label set."""
    specs = flagship_specs() if which == "flagship" else catalog_specs()
    docs = (
        firehose_docs(24, seed=81) if which == "flagship"
        else catalog_docs(12, seed=82)
    )
    jenv = pallas_env(specs, verdict_cache_size=0)
    tenv = torch_env(specs, verdict_cache_size=0)
    sync_envs(jenv, tenv, docs)
    items = items_for(docs, tenv.policy_ids(), seed=83)
    jres = jenv.validate_batch([(p, j) for p, j, _t in items])
    tres = tenv.validate_batch([(p, t) for p, _j, t in items])
    now = time.perf_counter()
    jsink: list = []
    tsink: list = []
    for k, ((pid, j, t), jr, tr) in enumerate(zip(items, jres, tres)):
        audit = k % 3 == 0
        jservice.post_evaluate(
            jenv, pid, j,
            jservice.RequestOrigin.AUDIT if audit
            else jservice.RequestOrigin.VALIDATE,
            jr, now - 1e-3, metrics_sink=jsink, now=now,
        )
        tservice.post_evaluate(
            tenv, pid, t,
            tservice.RequestOrigin.AUDIT if audit
            else tservice.RequestOrigin.VALIDATE,
            tr, now - 1e-3, metrics_sink=tsink, now=now,
        )
    jmetrics.default_registry().record_evaluations_batch(jsink)
    metrics.default_registry().record_evaluations_batch(tsink)
    n = assert_registries_agree(
        jmetrics.default_registry(), metrics.default_registry()
    )
    assert n == len(items)
    reg = metrics.default_registry()
    assert 0 < reg.counter_value(EVALS, {"accepted": "false"}) < n
    assert reg.counter_value(EVALS, {"request_origin": "audit"}) > 0


BATCHER_POLICIES = {
    "priv": {"module": "builtin://pod-privileged"},
    "priv-monitor": {"module": "builtin://pod-privileged",
                     "policyMode": "monitor"},
    "ns": {
        "module": "builtin://namespace-validate",
        "settings": {"denied_namespaces": ["blocked"]},
    },
    "grp": {
        "expression": "a() && b()",
        "message": "group denied",
        "policies": {
            "a": {"module": "builtin://always-happy"},
            "b": {"module": "builtin://pod-privileged"},
        },
    },
    "raw-mutation": {"module": "builtin://raw-mutation",
                     "allowedToMutate": True},
    "broken": {
        "module": "builtin://namespace-validate",
        "settings": {"denied_namespaces": "not-a-list"},
    },
}


def _pod_doc(namespace: str, privileged: bool, uid: str) -> dict:
    doc = build_admission_review_dict()
    doc["request"]["uid"] = uid
    doc["request"]["namespace"] = namespace
    doc["request"]["object"] = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": "p", "namespace": namespace},
        "spec": {"containers": [
            {"name": "c", "image": "nginx",
             "securityContext": {"privileged": privileged}}
        ]},
    }
    return doc


def _batcher_work() -> list[tuple[str, JRequest, TRequest]]:
    out = []
    for ns in ("default", "blocked", "kube-system"):
        for priv in (False, True):
            doc = _pod_doc(ns, priv, f"u-{ns}-{priv}")
            for pid in ("priv", "priv-monitor", "ns", "grp", "broken"):
                out.append((
                    pid,
                    JRequest.from_admission(
                        JReview.from_dict(copy.deepcopy(doc)).request
                    ),
                    TRequest.from_admission(
                        TReview.from_dict(copy.deepcopy(doc)).request
                    ),
                ))
    raw = {"request": {"uid": "raw-1", "operation": "create",
                       "resource": {"replicas": 3}}}
    for pid in ("raw-mutation", "priv"):
        out.append((
            pid,
            JRequest.from_raw(JRaw.from_dict(copy.deepcopy(raw)).request),
            TRequest.from_raw(TRaw.from_dict(copy.deepcopy(raw)).request),
        ))
    return out


def _outcome(future) -> tuple:
    try:
        return ("answer", json.dumps(future.result(timeout=60).to_dict()))
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return ("error", type(e).__name__, str(e))


def test_batcher_metrics_match_jax():
    """Both micro-batchers on the same work, twice (the replay answered by
    cache-hit fragments): equal counts and initialization errors."""
    kw = dict(
        continue_on_errors=True,
        always_accept_admission_reviews_on_namespace="kube-system",
    )
    jenv = pallas_env(BATCHER_POLICIES, **kw)
    tenv = torch_env(BATCHER_POLICIES, **kw)
    bkw = dict(
        max_batch_size=8, batch_timeout_ms=1.0, policy_timeout=30.0,
        host_fastpath_threshold=0, latency_budget_ms=0,
    )
    jb = JaxBatcher(jenv, **bkw).start()
    tb = MicroBatcher(tenv, **bkw).start()
    work = _batcher_work()
    try:
        for _pass in range(2):
            jf = jb.submit_many(
                [(p, j) for p, j, _t in work], jservice.RequestOrigin.VALIDATE
            )
            tf = tb.submit_many([(p, t) for p, _j, t in work])
            for a, b in zip(jf, tf):
                assert _outcome(b) == _outcome(a)
    finally:
        jb.shutdown()
        tb.shutdown()
    assert tenv.dedup_stats["fragment_hits"] > 0
    n = assert_registries_agree(
        jmetrics.default_registry(), metrics.default_registry()
    )
    # the broken policy's requests are no evaluation: answered as
    # initialization errors, or, in the always-accepted namespace, failed
    # by its mode lookup
    n_broken = sum(1 for p, _j, _t in work if p == "broken")
    assert n == 2 * (len(work) - n_broken)
    reg = metrics.default_registry()
    assert reg.counter_value(metrics.INIT_ERRORS_TOTAL) == 2 * 4
    assert reg.counter_value(
        EVALS, {"policy_mode": "monitor", "accepted": "false"}
    ) > 0
    assert reg.counter_value(EVALS, {"request_origin": "validate_raw"}) == 4
    assert reg.counter_value(
        EVALS, {"resource_namespace": "kube-system", "accepted": "true"}
    ) == 2 * 2 * 4


def _fill(mod) -> object:
    """A registry of ``mod`` fed the same observations, label values that
    need escaping and runtime families of every shape included."""
    reg = mod.MetricsRegistry()
    odd = 'ns"x\\y\nz'
    e1 = mod.PolicyEvaluation("p", "protect", "Pod", odd, "CREATE", True, False,
                              "validate", None)
    e2 = mod.RawPolicyEvaluation("q", "monitor", False, True, 400)
    e3 = mod.PolicyEvaluation("p", "protect", "Pod", None, "DELETE", False,
                              False, "audit", 400)
    reg.record_evaluations_batch([(1.5, e1), (0.05, e1), (1e4, e2), (0.1, e2)])
    reg.record_policy_latency(3.0, e3)
    reg.add_policy_evaluation(e3)
    reg.add_policy_evaluation(e1)
    for phase, s in (("form", 1e-5), ("form", 2.0), ("deliver", 0.001)):
        reg.observe_phase(phase, s)
    reg.add_policy_initialization_error(
        mod.PolicyInitializationError("q", "boom\nx")
    )
    reg.attach_runtime_stats(lambda: iter([
        ("policy_server_queue_wait_seconds_total", "counter", "h", 1.5),
        ("policy_server_batches_dispatched", "counter", "h", 7),
        ("policy_server_queue_depth", "gauge", "h\\x\ny", 3),
        ("policy_server_tail_exemplar_latency_seconds", "gauge", "h",
         [(('a"', "b", "c"), 0.5), (("d", "e", "f"), 1e-7)],
         ("trace_id", "policy_id", "slowest_phase")),
    ]))
    return reg


def _samples(reg) -> dict:
    out = {}
    for fam in text_string_to_metric_families(reg.exposition().decode()):
        for s in fam.samples:
            if not s.name.endswith("_created"):
                out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def test_exposition_samples_match_jax():
    """Every sample of the same observations, values included, parses
    equal from both packages' expositions (escaping, counters' ``_total``,
    cumulative buckets, ``+Inf``, labelled runtime gauges)."""
    jreg, treg = _fill(jmetrics), _fill(metrics)
    assert _samples(treg) == _samples(jreg)
    assert families(treg) == families(jreg)
    text = treg.exposition().decode()
    assert "_created" not in text
    assert "# TYPE kubewarden_policy_evaluations_total counter" in text
    assert 'le="+Inf"' in text


@pytest.mark.parametrize(
    "value,text",
    [(3, "3.0"), (0.1, "0.1"), (2.5e-05, "2.5e-05"), (float("inf"), "+Inf"),
     (1e7, "1e+07"), (12345678.0, "1.2345678e+07")],
)
def test_sample_values_use_go_float_text(value, text):
    assert metrics._go_float(value) == text


def test_service_records_the_vanilla_verdict_init_errors_and_short_circuits():
    """The port's service layer: a monitor-mode rejection counts as
    rejected though it is answered allowed, an always-accepted namespace
    counts as accepted, a policy that failed to initialize counts in the
    initialization-error family and not as an evaluation."""
    env = torch_env(
        BATCHER_POLICIES, continue_on_errors=True,
        always_accept_admission_reviews_on_namespace="kube-system",
    )
    reg = metrics.default_registry()

    def req(ns: str) -> TRequest:
        return TRequest.from_admission(
            TReview.from_dict(_pod_doc(ns, True, "s-1")).request
        )

    resp = tservice.evaluate(env, "priv-monitor", req("default"),
                             tservice.RequestOrigin.VALIDATE)
    assert resp.allowed
    assert reg.counter_value(
        EVALS, {"policy_mode": "monitor", "accepted": "false"}
    ) == 1
    assert tservice.evaluate(env, "priv", req("kube-system"),
                             tservice.RequestOrigin.VALIDATE).allowed
    assert reg.counter_value(
        EVALS, {"resource_namespace": "kube-system", "accepted": "true"}
    ) == 1
    resp = tservice.evaluate(env, "broken", req("default"),
                             tservice.RequestOrigin.VALIDATE)
    assert resp.status.code == 500
    assert reg.counter_value(metrics.INIT_ERRORS_TOTAL,
                             {"policy_name": "broken"}) == 1
    assert reg.counter_value(EVALS) == 2
    assert len(reg.latency_samples()) == 2


# ---------------------------------------------------------------------------
# flight recorder: parity on a scripted sequence
# ---------------------------------------------------------------------------


def _script(mod, capacity: int, rate: float):
    """A fixed sequence of every write the batcher and the environment
    make, with fixed timestamps, into a recorder of package ``mod``."""
    reg = (jmetrics if mod is jflightrec else metrics).MetricsRegistry()
    rec = mod.FlightRecorder(
        capacity=capacity, row_sample_rate=rate, registry=reg,
        exemplar_slots=3,
    )
    t = 1_000_000
    for k in range(6):
        bid = rec.next_batch()
        rows = 4 + k
        rec.record_phase(mod.PH_QUEUE_WAIT, t, t + 900, rows=rows, batch=bid)
        rec.record_phase(mod.PH_FORM, t + 900, t + 1000, rows=rows, batch=bid)
        rec.record_phase(mod.PH_DISPATCH, t + 1000, t + 5000, rows=rows, batch=bid)
        rec.record_phase(mod.PH_HANDOFF, t + 1000, t + 1100, rows=rows, batch=bid)
        rec.record_phase(mod.PH_PREPARE, t + 1100, t + 1300, rows=rows, batch=bid)
        if k % 2:
            rec.record_phase(mod.PH_BLOB_DEDUP, t + 1300, t + 1400,
                             rows=rows, batch=bid)
        rec.record_phase(mod.PH_ENCODE, t + 1400, t + 2400, rows=rows, batch=bid)
        rec.record_phase(mod.PH_FETCH, t + 2600, t + 4000, rows=rows, batch=bid)
        rec.record_phase(mod.PH_DEVICE_EXECUTE, t + 2700, t + 3900,
                         rows=rows, batch=bid)
        rec.record_phase(mod.PH_MATERIALIZE, t + 4000, t + 4700,
                         rows=rows, batch=bid)
        rec.record_phase(mod.PH_DELIVER, t + 5000, t + 5300 + 10 * k,
                         rows=rows, batch=bid)
        rec.record_batch_mix(bid, rows if k == 3 else k % 2, rows)
        breakdown = {mod.PH_QUEUE_WAIT: 900, mod.PH_FORM: 100,
                     mod.PH_DISPATCH: 4000}
        rec.offer_exemplar(f"uid-{k}", "pol", t - 1000 * k, t + 5000, breakdown)
        for i in rec.sample_indices(rows):
            rec.record_row(f"row-{k}-{i}", "pol", t, t + 5000, bid, breakdown,
                           mod.FlightRecorder.ROW_SAMPLED)
        rec.observe_row(f"obs-{k}", "pol", t, t + 700 * k, bid, breakdown)
        t += 10_000
    return rec, reg


@pytest.mark.parametrize(
    "capacity,rate", [(4096, 0.25), (32, 1.0), (4096, 0.0)],
    ids=["ring", "wrapped", "no-rows"],
)
def test_recorder_matches_jax_on_scripted_events(monkeypatch, capacity, rate):
    # fixed clocks: the exemplar window and the trace's exemplar reads
    monkeypatch.setattr(time, "perf_counter_ns", lambda: 10**12)
    jrec, jreg = _script(jflightrec, capacity, rate)
    trec, treg = _script(flightrec, capacity, rate)
    assert trec.snapshot() == jrec.snapshot()
    assert trec.events_recorded() == jrec.events_recorded()
    assert trec.rows_sampled() == jrec.rows_sampled()
    assert trec.exemplars() == jrec.exemplars()
    assert trec.attribution() == jrec.attribution()
    since = trec.events_recorded() // 2
    assert trec.attribution(since=since) == jrec.attribution(since=since)
    assert trec.chrome_trace_json() == jrec.chrome_trace_json()
    assert _samples(treg) == _samples(jreg)
    if capacity == 32:
        assert len(trec.snapshot()) == 32 < trec.events_recorded()
    assert bool(trec.rows_sampled()) == (rate > 0)


def test_phase_names_are_the_jax_packages():
    """The JAX package's 17 phases are the port's first 17, in order, so
    their indices stay; the port's own three follow."""
    assert len(jflightrec.PHASES) == 17 and PHASES[:17] == jflightrec.PHASES
    assert PHASES[17:] == (
        flightrec.PH_HOST_EVAL, flightrec.PH_SUBMIT, flightrec.PH_GC
    )
    assert flightrec._DISPATCH_NESTED == jflightrec._DISPATCH_NESTED + (
        flightrec.PH_HOST_EVAL, flightrec.PH_SUBMIT
    )
    assert PH_QUEUE_WAIT in PHASES and flightrec.PH_DEVICE_EXECUTE not in (
        flightrec._DISPATCH_NESTED
    )


# ---------------------------------------------------------------------------
# flight recorder: the cases of tests/test_flightrec.py, on the port's copy
# ---------------------------------------------------------------------------


def test_ring_wraparound_keeps_last_capacity_events():
    rec = FlightRecorder(capacity=16)
    for i in range(100):
        rec.record_phase(PH_FORM, i * 10, i * 10 + 5, rows=1, batch=i)
    assert rec.events_recorded() == 100
    snap = rec.snapshot()
    assert [e["seq"] for e in snap] == list(range(84, 100))
    assert [e["batch"] for e in snap] == list(range(84, 100))
    assert all(e["end_ns"] - e["start_ns"] == 5 for e in snap)


@pytest.mark.parametrize("asked,cap", [(1, 16), (100, 128), (65536, 65536)])
def test_capacity_rounds_up_to_power_of_two(asked, cap):
    assert FlightRecorder(capacity=asked)._cap == cap


def test_events_are_well_formed_and_ordered():
    rec = FlightRecorder(capacity=64)
    bid = rec.next_batch()
    t = time.perf_counter_ns()
    rec.record_phase(PH_QUEUE_WAIT, t, t + 100, rows=4, batch=bid)
    rec.record_phase(PH_FORM, t + 100, t + 200, rows=4, batch=bid)
    snap = rec.snapshot()
    assert [e["phase"] for e in snap] == [PH_QUEUE_WAIT, PH_FORM]
    assert all(e["kind"] == "batch" and e["end_ns"] >= e["start_ns"]
               for e in snap)


def test_torn_slot_is_dropped_not_misread():
    """A slot whose sequence number a writer has invalidated (fields being
    overwritten) is left out of the snapshot."""
    rec = FlightRecorder(capacity=16)
    for i in range(3):
        rec.record_phase(PH_FORM, i, i + 1, rows=1, batch=i)
    rec._seq[1] = -1  # a writer between its invalidate and its publish
    assert [e["seq"] for e in rec.snapshot()] == [0, 2]


@pytest.mark.parametrize("rate,stride", [(1.0, 1), (0.25, 4), (0.0, 0)])
def test_row_sampling_is_a_deterministic_stride(rate, stride):
    rec = FlightRecorder(capacity=256, row_sample_rate=rate)
    picked = []
    base = 0
    for n in (3, 5, 9):
        picked += [base + i for i in rec.sample_indices(n)]
        base += n
    assert picked == (list(range(0, base, stride)) if stride else [])


def test_exemplars_keep_slowest_n_with_trace_ids():
    rec = FlightRecorder(capacity=64, exemplar_slots=4)
    t0 = time.perf_counter_ns()
    for i in range(32):
        lat_ns = (i + 1) * 1_000_000
        rec.observe_row(f"uid-{i}", "pol", t0, t0 + lat_ns, 1,
                        {PH_DISPATCH: lat_ns})
    ex = rec.exemplars()
    assert [e["trace_id"] for e in ex] == ["uid-31", "uid-30", "uid-29", "uid-28"]
    assert all(e["slowest_phase"] == PH_DISPATCH for e in ex)
    assert rec.row_flags(0.0000001) & FlightRecorder.ROW_EXEMPLAR == 0


def test_exemplar_table_unfreezes_after_spike_window():
    rec = FlightRecorder(capacity=64, exemplar_slots=2,
                         exemplar_window_seconds=0.01)
    t0 = time.perf_counter_ns()
    rec.offer_exemplar("spike-a", "pol", t0 - 100_000_000, t0, {})
    rec.offer_exemplar("spike-b", "pol", t0 - 90_000_000, t0, {})
    assert rec._ex_floor > 0
    time.sleep(0.03)
    t1 = time.perf_counter_ns()
    rec.offer_exemplar("fast", "pol", t1 - 1_000_000, t1, {})
    with rec._ex_lock:
        assert [e[1] for e in rec._ex_current] == ["fast"]
        assert rec._ex_floor == 0.0
    time.sleep(0.03)
    rec.exemplars()
    time.sleep(0.03)
    ids = {e["trace_id"] for e in rec.exemplars()}
    assert "spike-a" not in ids and "spike-b" not in ids


def test_exemplars_dedup_duplicate_label_sets():
    rec = FlightRecorder(capacity=64, exemplar_slots=4,
                         exemplar_window_seconds=0.01)
    t = time.perf_counter_ns()
    rec.offer_exemplar("dup-uid", "pol", t - 50_000_000, t,
                       {PH_DISPATCH: 50_000_000})
    time.sleep(0.03)
    t = time.perf_counter_ns()
    rec.offer_exemplar("dup-uid", "pol", t - 40_000_000, t,
                       {PH_DISPATCH: 40_000_000})
    ex = rec.exemplars()
    assert len(ex) == 1
    assert ex[0]["latency_seconds"] == pytest.approx(0.05)


def test_exemplar_window_rotation():
    rec = FlightRecorder(capacity=64, exemplar_slots=2,
                         exemplar_window_seconds=0.0)
    t0 = time.perf_counter_ns()
    rec.observe_row("old-slow", "pol", t0, t0 + 50_000_000, 1, {})
    rec.observe_row("new-fast", "pol", t0, t0 + 1_000_000, 1, {})
    assert {e["trace_id"] for e in rec.exemplars()} == {"old-slow", "new-fast"}


def test_attribution_residual_math():
    rec = FlightRecorder(capacity=256)
    bid = rec.next_batch()
    rec.record_phase(PH_QUEUE_WAIT, 0, 1000, rows=10, batch=bid)
    rec.record_phase(PH_FORM, 1000, 1100, rows=10, batch=bid)
    rec.record_phase(PH_DISPATCH, 1100, 1900, rows=10, batch=bid)
    rec.record_phase(flightrec.PH_ENCODE, 1100, 1500, rows=10, batch=bid)
    rec.record_phase(flightrec.PH_FETCH, 1500, 1700, rows=10, batch=bid)
    rec.record_phase(PH_DELIVER, 1900, 2000, rows=10, batch=bid)
    att = rec.attribution()
    assert (att["batches_complete"], att["rows"]) == (1, 10)
    assert att["wall_us_per_row"] == pytest.approx(0.1)
    assert att["residual_us_per_row"] == pytest.approx(0.02)
    assert att["residual_fraction_of_wall"] == pytest.approx(0.2)
    # device_execute nests under the fetch: never added
    rec.record_phase(flightrec.PH_DEVICE_EXECUTE, 1500, 1700, rows=10, batch=bid)
    assert rec.attribution()["residual_us_per_row"] == pytest.approx(0.02)


def test_attribution_since_cursor_excludes_old_batches():
    rec = FlightRecorder(capacity=256)
    b1 = rec.next_batch()
    for ph, s in ((PH_FORM, 0), (PH_DISPATCH, 100), (PH_DELIVER, 200)):
        rec.record_phase(ph, s, s + 100, rows=1, batch=b1)
    cursor = rec.events_recorded()
    b2 = rec.next_batch()
    for ph, s in ((PH_FORM, 0), (PH_DISPATCH, 100), (PH_DELIVER, 200)):
        rec.record_phase(ph, s, s + 100, rows=5, batch=b2)
    att = rec.attribution(since=cursor)
    assert (att["batches_complete"], att["rows"]) == (1, 5)


# ---------------------------------------------------------------------------
# the port's batcher and environment under a recorder
# ---------------------------------------------------------------------------

STAMP_POLICIES = {k: BATCHER_POLICIES[k] for k in ("priv", "ns", "grp")}


def _stamp_requests(n: int) -> list[tuple[str, TRequest]]:
    ids = sorted(STAMP_POLICIES)
    return [
        (ids[i % len(ids)], TRequest.from_admission(
            TReview.from_dict(_pod_doc("default", i % 2 == 0, f"s-{i}")).request
        ))
        for i in range(n)
    ]


@pytest.mark.parametrize("route", ["host", "device"])
def test_batcher_stamps_each_phase_once_per_batch(route):
    """Every batch stamps queue_wait, form, dispatch, deliver and its two
    hand-off gaps once, and its mix once; device batches add the native
    path's phases under the same batch id, with one ``submit`` per
    device chunk (as many as its fetches), the host fast path one
    ``host_eval`` and none of the native path's. Spans on one thread carry
    its CPU time and index; the cross-thread ones carry neither."""
    env = torch_env(STAMP_POLICIES, verdict_cache_size=0)
    rec = flightrec.install(FlightRecorder(capacity=4096, row_sample_rate=1.0))
    b = MicroBatcher(
        env, max_batch_size=8, batch_timeout_ms=20.0, policy_timeout=30.0,
        host_fastpath_threshold=64 if route == "host" else 0,
        latency_budget_ms=0,
    ).start()
    try:
        futs = b.submit_many(_stamp_requests(24))
        for f in futs:
            f.result(timeout=60)
    finally:
        b.shutdown()
    by_batch: dict = {}
    for e in rec.snapshot():
        if e["batch"] > 0 and e["kind"] != "row":
            by_batch.setdefault(e["batch"], []).append(e)
    assert len(by_batch) == b.batches
    native = {flightrec.PH_PREPARE, flightrec.PH_ENCODE, flightrec.PH_FETCH,
              flightrec.PH_MATERIALIZE, flightrec.PH_DEVICE_EXECUTE}
    for events in by_batch.values():
        phases = [e["phase"] for e in events if e["kind"] == "batch"]
        for ph in (PH_QUEUE_WAIT, PH_FORM, PH_DISPATCH, PH_DELIVER):
            assert phases.count(ph) == 1
        assert phases.count(flightrec.PH_HANDOFF) == 2
        assert sum(e["kind"] == "mix" for e in events) == 1
        if route == "host":
            assert not native & set(phases)
            assert phases.count(flightrec.PH_HOST_EVAL) == 1
            assert flightrec.PH_SUBMIT not in phases
        else:
            assert native <= set(phases)
            assert flightrec.PH_HOST_EVAL not in phases
            assert phases.count(flightrec.PH_SUBMIT) == phases.count(
                flightrec.PH_FETCH
            ) >= 1
        for e in events:
            if e["kind"] != "batch":
                continue
            crosses = e["phase"] in (PH_QUEUE_WAIT, PH_DISPATCH, flightrec.PH_HANDOFF)
            assert ("cpu_ns" in e) == ("thread" in e) == (not crosses), e
            if not crosses:
                assert 0 <= e["cpu_ns"] and e["thread"] >= 0
    att = rec.attribution()
    assert att["rows"] == 24 and att["batches_complete"] == b.batches
    assert rec.rows_sampled() == 24


def test_chrome_trace_schema_from_the_batcher():
    env = torch_env(STAMP_POLICIES, verdict_cache_size=0)
    rec = flightrec.install(FlightRecorder(capacity=4096, row_sample_rate=1.0))
    b = MicroBatcher(env, max_batch_size=8, batch_timeout_ms=1.0,
                     policy_timeout=10.0, host_fastpath_threshold=0).start()
    try:
        for f in b.submit_many(_stamp_requests(8)):
            f.result(timeout=60)
    finally:
        b.shutdown()
    doc = json.loads(rec.chrome_trace_json())
    assert doc["displayTimeUnit"] == "ms"
    events = doc["traceEvents"]
    assert {"process_name", "thread_name"} <= {
        e["name"] for e in events if e["ph"] == "M"
    }
    slices = [e for e in events if e["ph"] == "X"]
    for e in slices:
        assert e["name"] in PHASES and e["dur"] >= 0 and e["pid"] in (1, 2)
        assert isinstance(e["ts"], float) and "rows" in e["args"]
    assert all(e["args"].get("uid") for e in slices if e["pid"] == 2)
    assert doc["otherData"]["events_recorded"] == rec.events_recorded()
    assert {"trace_id", "policy_id", "latency_seconds", "slowest_phase",
            "phase_breakdown_us"} <= set(doc["exemplars"][0])


class _Boom(RuntimeError):
    pass


@pytest.mark.parametrize("fault", ["recorder", "metrics"])
def test_a_telemetry_fault_fails_loudly_never_a_host_answer(
    monkeypatch, caplog, fault
):
    """A recorder fault inside the device path fails the batch's requests;
    a metrics fault after delivery is logged. Neither feeds the breaker,
    so no request is answered by the host oracle in the device's place."""
    env = torch_env(STAMP_POLICIES, verdict_cache_size=0)
    rec = flightrec.install(FlightRecorder(capacity=1024))
    if fault == "recorder":
        real = rec.record_phase

        def record_phase(phase, *a, **kw):
            if phase == flightrec.PH_DEVICE_EXECUTE:
                raise _Boom("recorder fault")
            return real(phase, *a, **kw)

        monkeypatch.setattr(rec, "record_phase", record_phase)
    else:
        def record_evaluations_batch(pairs):
            raise _Boom("metrics fault")

        monkeypatch.setattr(
            metrics.default_registry(), "record_evaluations_batch",
            record_evaluations_batch,
        )
    b = MicroBatcher(env, max_batch_size=8, batch_timeout_ms=1.0,
                     policy_timeout=10.0, host_fastpath_threshold=0,
                     latency_budget_ms=0).start()
    caplog.set_level(logging.ERROR, logger="kubewarden-policy-server")
    try:
        for _ in range(6):
            futs = b.submit_many(_stamp_requests(8))
            for f in futs:
                if fault == "recorder":
                    with pytest.raises(_Boom):
                        f.result(timeout=60)
                else:
                    assert f.result(timeout=60).uid.startswith("s-")
    finally:
        b.shutdown()
    assert env.breaker_stats["trips"] == 0
    assert env.breaker_short_circuited_requests == 0
    assert env.host_fastpath_requests == 0
    if fault == "metrics":
        assert any("dispatch failed" in r.getMessage() for r in caplog.records)


# ---------------------------------------------------------------------------
# structured logs and spans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_log_line_formats_match_jax(fmt):
    """One span record formats to the same line through both packages'
    formatters (text without colour, and JSON lines)."""
    record = logging.LogRecord(
        "kubewarden-policy-server", logging.INFO, __file__, 1, "validation",
        None, None,
    )
    record.span_fields = {"policy_id": "priv", "allowed": False,
                          "elapsed_ms": 1.25}
    if fmt == "text":
        want = jtracing._TextFormatter(color=False).format(record)
        got = tracing._TextFormatter(color=False).format(record)
    else:
        want = jtracing._JsonFormatter().format(record)
        got = tracing._JsonFormatter().format(record)
    assert got == want and "policy_id" in got


def test_span_logs_its_fields_and_elapsed_time(caplog):
    caplog.set_level(logging.INFO, logger="kubewarden-policy-server")
    with tracing.span("validation", policy_id="priv") as fields:
        fields["allowed"] = True
    (rec,) = [r for r in caplog.records if r.getMessage() == "validation"]
    assert rec.span_fields["policy_id"] == "priv"
    assert rec.span_fields["allowed"] is True
    assert rec.span_fields["elapsed_ms"] >= 0
