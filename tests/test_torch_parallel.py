"""The threaded policy-shard dispatcher of the PyTorch port
(``policy_server_tpu_torch/parallel/policy_sharded.py``,
``plan_policy_shards`` and ``acceptance_psum`` of ``parallel/mesh.py``,
``--mesh-dispatch threaded``) against the JAX package's
(``policy_server_tpu/parallel``): the shard plan over 8 entries against
JAX's over the test process's 8 virtual CPU devices, the evaluator against
JAX's ``PolicyShardedEvaluator`` and the oracle on the firehose under both
kernels and both transports, the cases of ``tests/test_parallel.py``
(routing, resize, drain-based retirement, groups, hooks through the
batcher), the verdict-cache split, the summed counters, per-shard breaker
containment, the acceptance counts against JAX's ``acceptance_psum``, and
the server under ``threaded`` against the JAX server. The port's meshes lie
over one CPU entry taken N times. Tolerance: exact equality throughout
(verdicts, rule indices, response bodies, counts)."""

from __future__ import annotations

import contextlib
import http.client
import json
import re
import threading

import jax
import numpy as np
import pytest
import torch

from policy_server_tpu.config.config import MeshSpec as JMeshSpec
from policy_server_tpu.models import AdmissionReviewRequest, ValidateRequest
from policy_server_tpu.models.policy import parse_policy_entry
from policy_server_tpu.parallel import PolicyShardedEvaluator as JaxSharded
from policy_server_tpu.parallel import acceptance_psum as jax_psum
from policy_server_tpu.parallel import mesh as jmesh
from policy_server_tpu_torch.api.service import RequestOrigin
from policy_server_tpu_torch.evaluation.errors import PolicyNotFoundError
from policy_server_tpu_torch.models import (
    AdmissionReviewRequest as TAdmissionReviewRequest,
)
from policy_server_tpu_torch.models import ValidateRequest as TValidateRequest
from policy_server_tpu_torch.models.policy import (
    parse_policy_entry as t_parse_policy_entry,
)
from policy_server_tpu_torch.ops import cuda_kernels as ck
from policy_server_tpu_torch.parallel import (
    PolicyShardedEvaluator,
    SubmeshPlan,
    acceptance_psum,
    plan_policy_shards,
)
from policy_server_tpu_torch.parallel import mesh as tmesh
from policy_server_tpu_torch.runtime.batcher import MicroBatcher
from policy_server_tpu_torch.server import PolicyServer

from conftest import build_admission_review_dict
from torch_port_support import (
    JaxServer,
    firehose_docs,
    flagship_specs,
    items_for,
    response_dicts,
    torch_env,
)

CPU = torch.device("cpu")
N_REVIEWS = 256
SERVE_BATCH = 60
SHARD_MESHES = ["data:4,policy:2", "data:2,policy:4", "data:1,policy:8"]

# tests/test_parallel.py's small set
POLICIES = {
    "priv": {"module": "builtin://pod-privileged"},
    "ns": {
        "module": "builtin://namespace-validate",
        "settings": {"denied_namespaces": ["blocked"]},
    },
    "latest": {"module": "builtin://disallow-latest-tag"},
    "happy": {"module": "builtin://always-happy"},
}
GROUP = {
    "expression": "a() && b()",
    "message": "denied",
    "policies": {
        "a": {"module": "builtin://always-happy"},
        "b": {"module": "builtin://pod-privileged"},
    },
}


def n_devices(spec: str) -> int:
    n = 1
    for _name, size in tmesh.MeshSpec.parse(spec).axes:
        n *= size
    return n


def cpu_mesh(spec: str, entries=None) -> tmesh.Mesh:
    return tmesh.make_mesh(
        tmesh.MeshSpec.parse(spec), devices=entries or [CPU] * n_devices(spec)
    )


def jax_mesh(spec: str):
    return jmesh.make_mesh(JMeshSpec.parse(spec), jax.devices()[: n_devices(spec)])


def port_policies(specs: dict) -> dict:
    return {k: t_parse_policy_entry(k, v) for k, v in specs.items()}


def jax_policies(specs: dict) -> dict:
    return {k: parse_policy_entry(k, v) for k, v in specs.items()}


def sharded(specs: dict, spec: str = "data:4,policy:2", **kw):
    kw = dict(dict(device="cpu"), **kw)
    return PolicyShardedEvaluator(
        port_policies(specs), cpu_mesh(spec), builder_kwargs=kw
    )


def pod_doc(namespace: str, privileged: bool) -> dict:
    doc = build_admission_review_dict()
    doc["request"]["namespace"] = namespace
    doc["request"]["object"] = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": "p", "namespace": namespace},
        "spec": {"containers": [
            {"name": "c", "image": "nginx",
             "securityContext": {"privileged": privileged}},
        ]},
    }
    return doc


def requests_of(doc: dict) -> tuple:
    """(JAX request, port request) of one review."""
    return (
        ValidateRequest.from_admission(
            AdmissionReviewRequest.from_dict(json.loads(json.dumps(doc))).request
        ),
        TValidateRequest.from_admission(
            TAdmissionReviewRequest.from_dict(json.loads(json.dumps(doc))).request
        ),
    )


CASES = [("priv", "default", True), ("ns", "blocked", False),
         ("latest", "default", False), ("happy", "default", False),
         ("priv", "default", False)]


def both_items(cases) -> tuple[list, list]:
    j, t = [], []
    for pid, ns, priv in cases:
        jr, tr = requests_of(pod_doc(ns, priv))
        j.append((pid, jr))
        t.append((pid, tr))
    return j, t


# -- plan_policy_shards --------------------------------------------------------


@pytest.mark.parametrize("spec", SHARD_MESHES)
def test_plan_policy_shards_is_the_jax_packages(spec):
    """Ids per shard, each submesh's axes, shape and row positions (device
    index) equal JAX's ``plan_policy_shards`` over its 8 virtual devices."""
    ids = sorted(flagship_specs())
    entries = [torch.device("cpu", i) for i in range(8)]
    want = jmesh.plan_policy_shards(ids, jmesh.make_mesh(JMeshSpec.parse(spec)))
    got = plan_policy_shards(ids, cpu_mesh(spec, entries))
    assert len(got) == len(want) == tmesh.MeshSpec.parse(spec).policy_size()
    for g, w in zip(got, want):
        assert isinstance(g, SubmeshPlan)
        assert (g.shard_index, g.policy_ids) == (w.shard_index, w.policy_ids)
        assert g.mesh.axis_names == tuple(w.mesh.axis_names)
        assert g.mesh.shape == dict(w.mesh.shape)
        assert np.array_equal(
            np.vectorize(lambda d: d.index)(g.mesh.devices),
            np.vectorize(lambda d: d.id)(w.mesh.devices),
        )
    assert sorted(p for g in got for p in g.policy_ids) == ids


def test_plan_policy_shards_reads_a_data_major_grid_by_its_policy_rows(
    monkeypatch,
):
    """On a multi-process mesh (data axis outermost) a shard's row is still
    its policy position along the data axis, with the entries' owners; a
    row that spans processes is refused at the build, naming the layout."""
    monkeypatch.setattr(tmesh, "process_count", lambda: 2)
    monkeypatch.setattr(tmesh, "local_device_count", lambda _t="cuda": 2)
    mesh = tmesh.make_mesh(tmesh.MeshSpec.parse("data:2,policy:2"), list(range(4)))
    assert mesh.axis_names == ("data", "policy")
    plans = plan_policy_shards(["a", "b", "c"], mesh)
    assert [p.policy_ids for p in plans] == [("a", "c"), ("b",)]
    assert [p.mesh.devices.tolist() for p in plans] == [[[0, 2]], [[1, 3]]]
    assert [p.mesh.processes.tolist() for p in plans] == [[[0, 1]], [[0, 1]]]
    specs = {"p": {"module": "builtin://pod-privileged"}}
    with pytest.raises(ValueError, match=r"policy shard 0's submesh row "
                       r"\['0', '2'\] spans processes \[0, 1\]"):
        PolicyShardedEvaluator(port_policies(specs), mesh,
                               builder_kwargs=dict(device="cpu"))


# -- the evaluator against JAX's and the oracle --------------------------------


@pytest.fixture(scope="module")
def firehose():
    docs = firehose_docs(N_REVIEWS, seed=171)
    ids = torch_env(flagship_specs(), backend="oracle").policy_ids()
    return items_for(docs, ids + ["missing", "missing/member"], seed=172)


def serve(env, items, jax_side: bool) -> list:
    out = []
    for c in range(0, len(items), SERVE_BATCH):
        chunk = items[c : c + SERVE_BATCH]
        out += response_dicts(
            env.validate_batch([(p, j if jax_side else t) for p, j, t in chunk])
        )
    return out


@pytest.fixture(scope="module")
def references(firehose):
    """The oracle's bodies, and JAX's ``PolicyShardedEvaluator``'s under
    each mesh, on the firehose."""
    refs = {"oracle": serve(
        torch_env(flagship_specs(), backend="oracle"), firehose, False
    )}
    spec = "data:4,policy:2"
    ev = JaxSharded(jax_policies(flagship_specs()), jax_mesh(spec),
                    builder_kwargs=dict(verdict_cache_size=0))
    refs[spec] = serve(ev, firehose, True)
    ev.close()
    return refs


@contextlib.contextmanager
def counting_k1(monkeypatch):
    """Count K1's runs (the plain version, on the CPU) by program."""
    calls: list = []
    real = ck.policy_matrix

    def counting(buf, program):
        calls.append(program)
        return real(buf, program)

    monkeypatch.setattr(ck, "policy_matrix", counting)
    yield calls
    monkeypatch.setattr(ck, "policy_matrix", real)


@pytest.mark.parametrize("spec,kernel,columnar", [
    ("data:4,policy:2", "pallas", True), ("data:4,policy:2", "pallas", False),
    ("data:4,policy:2", "xla", True), ("data:4,policy:2", "xla", False),
    ("data:2,policy:4", "pallas", True),
])
def test_sharded_evaluator_equals_jax_and_the_oracle(
    firehose, references, monkeypatch, spec, kernel, columnar
):
    """Every body (unknown ids' ``PolicyNotFoundError`` included) equals
    the oracle's, and at ``data:4,policy:2`` JAX's
    ``PolicyShardedEvaluator``'s, under both kernels and both transports
    (its bodies do not depend on the mesh: ``data:2,policy:4`` against
    the oracle). Under ``pallas``
    each shard's K1 runs once per position of its row per K1 step of that
    shard (``pallas_stats['dispatches']``), each run a program of that
    shard's own policies; under ``xla`` K1 never runs."""
    ev = sharded(flagship_specs(), spec, kernel=kernel, columnar=columnar,
                 verdict_cache_size=0)
    ev.warmup((SERVE_BATCH,))
    d0 = [s.pallas_stats["dispatches"] for s in ev.shards]
    with counting_k1(monkeypatch) as calls:
        got = serve(ev, firehose, False)
    steps = [s.pallas_stats["dispatches"] - d for s, d in zip(ev.shards, d0)]
    owned = [set(s._compiled) for s in ev.shards]
    positions = ev.mesh.shape["data"]
    ev.close()
    assert got == references["oracle"] == references["data:4,policy:2"]
    assert any(not isinstance(r, str) and not r["allowed"] for r in got)
    assert sum(isinstance(r, str) and "PolicyNotFoundError" in r for r in got)
    if kernel == "pallas":
        assert all(steps) and len(calls) == positions * sum(steps)
        for program in calls:
            assert any(set(program.column_of) <= o for o in owned)
    else:
        assert not calls and not any(steps)


def test_sharded_evaluator_routes_and_reports_unknown_ids():
    """``tests/test_parallel.py``'s sharded-against-single case: bodies
    equal JAX's evaluator, and an unknown id is ``PolicyNotFoundError``."""
    j_items, t_items = both_items(CASES)
    jev = JaxSharded(jax_policies(POLICIES), jax_mesh("data:4,policy:2"))
    ev = sharded(POLICIES)
    try:
        assert response_dicts(ev.validate_batch(t_items)) == response_dicts(
            jev.validate_batch(j_items)
        )
        out = ev.validate_batch([("missing", t_items[0][1])])
        assert isinstance(out[0], PolicyNotFoundError)
        with pytest.raises(PolicyNotFoundError):
            ev.validate("missing", t_items[0][1])
        assert ev.policy_ids() == sorted(POLICIES)
        assert len(ev.shards) == 2 and ev.mesh.shape == {"policy": 2, "data": 4}
        assert all(s._mesh.shape == {"policy": 1, "data": 4} for s in ev.shards)
    finally:
        ev.close()
        jev.close()


def test_group_routing_is_the_jax_packages():
    specs = dict(POLICIES, grp=GROUP)
    jr, tr = requests_of(pod_doc("default", True))
    jev = JaxSharded(jax_policies(specs), jax_mesh("data:4,policy:2"))
    ev = sharded(specs)
    try:
        got = ev.validate("grp", tr)
        assert not got.allowed
        assert got.status.details.causes[0].field == "spec.policies.b"
        assert got.to_dict() == jev.validate("grp", jr).to_dict()
    finally:
        ev.close()
        jev.close()


def test_hooks_through_the_batcher():
    """The batcher serves through the evaluator (hook lookups, the host
    fast path's split) with the oracle's verdict."""
    ev = sharded(POLICIES)
    batcher = MicroBatcher(ev, host_fastpath_threshold=0, max_batch_size=4,
                           batch_timeout_ms=1.0).start()
    try:
        _j, tr = requests_of(pod_doc("default", True))
        resp = batcher.evaluate("priv", tr, RequestOrigin.VALIDATE)
        assert not resp.allowed
    finally:
        batcher.shutdown()
        ev.close()


# -- resize --------------------------------------------------------------------


def test_resize_shrinks_and_grows_and_refuses_an_empty_set():
    """``tests/test_parallel.py``'s churn case through both packages: 8 → 6
    entries keeps the policy axis 2 (data 3), 6 → 5 forces one shard, the
    verdicts stay the same, and an empty set raises JAX's message."""
    j_items, t_items = both_items(CASES[:4])
    jev = JaxSharded(jax_policies(POLICIES), jax_mesh("data:4,policy:2"))
    ev = sharded(POLICIES)
    try:
        before = response_dicts(ev.validate_batch(t_items))
        assert before == response_dicts(jev.validate_batch(j_items))
        for n in (6, 5, 8):
            jev.resize(list(jax.devices())[:n])
            ev.resize([CPU] * n)
            assert ev.mesh.shape == dict(jev.mesh.shape)
            assert len(ev.shards) == len(jev.shards)
            assert response_dicts(ev.validate_batch(t_items)) == before
            assert sorted(ev.policy_ids()) == sorted(POLICIES)
        assert ev.resizes == jev.resizes == 3
        assert ev.mesh.shape == {"policy": 2, "data": 4}
        with pytest.raises(ValueError) as jerr:
            jev.resize([])
        with pytest.raises(ValueError) as terr:
            ev.resize([])
        assert str(terr.value) == str(jerr.value) == (
            "cannot resize to an empty device set"
        )
    finally:
        ev.close()
        jev.close()


def test_resize_under_in_flight_batches():
    """A resize concurrent with serving: batches in flight finish on the
    old shards, new ones route through the new set, no torn routing."""
    ev = sharded(POLICIES)
    _j, t_items = both_items(CASES[:2])
    cases = t_items * 8
    expected = response_dicts(ev.validate_batch(cases))
    stop = threading.Event()
    failures: list = []
    served = [0]

    def loop() -> None:
        while not stop.is_set():
            try:
                if response_dicts(ev.validate_batch(cases)) != expected:
                    failures.append("verdict drift")
                    return
                served[0] += 1
            except Exception as e:  # noqa: BLE001 — reported below
                failures.append(repr(e))
                return

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    try:
        ev.resize([CPU] * 4)
        ev.resize([CPU] * 8)
    finally:
        stop.set()
        t.join(timeout=30)
    ev.close()
    assert not failures, failures
    assert served[0] > 0 and ev.resizes == 2


def test_retired_snapshot_closes_only_when_it_drains():
    """A resize must not close the old shards while a dispatch is pinned to
    them, however long it takes, and must close them when it drains."""
    ev = sharded(POLICIES)
    old_envs = list(ev.shards)
    closed = {id(e): 0 for e in old_envs}
    for env in old_envs:
        real_close = env.close

        def counting_close(real_close=real_close, key=id(env), **kw):
            closed[key] += 1
            return real_close(**kw)

        env.close = counting_close
    entered, release = threading.Event(), threading.Event()
    target = ev._shard_of("priv")
    real_vb = target.validate_batch

    def blocking(items, **kw):
        entered.set()
        assert release.wait(timeout=30), "test deadlock"
        return real_vb(items, **kw)

    target.validate_batch = blocking
    _j, t_items = both_items(CASES[:1])
    result: list = []
    t = threading.Thread(
        target=lambda: result.append(ev.validate_batch(t_items)), daemon=True
    )
    t.start()
    assert entered.wait(timeout=30)
    ev.resize([CPU] * 4)
    assert not any(closed.values()), "a retired environment closed in flight"
    assert len(ev._retired) == 1
    release.set()
    t.join(timeout=30)
    assert not t.is_alive()
    assert result and not isinstance(result[0][0], Exception)
    assert all(n == 1 for n in closed.values()), closed
    assert ev._retired == []
    assert not isinstance(ev.validate_batch(t_items)[0], Exception)
    ev.close()
    assert all(n == 1 for n in closed.values()), "closed twice"


# -- counters, caches and breakers --------------------------------------------


def test_verdict_cache_budget_splits_over_the_shards():
    jev = JaxSharded(jax_policies(POLICIES), jax_mesh("data:2,policy:4"),
                     builder_kwargs=dict(verdict_cache_size=1 << 20))
    ev = sharded(POLICIES, "data:2,policy:4", verdict_cache_size=1 << 20)
    try:
        keys = ("cache_capacity", "blob_cache_capacity")
        want = [[s.dedup_stats[k] for k in keys] for s in jev.shards]
        got = [[s.dedup_stats[k] for k in keys] for s in ev.shards]
        whole = torch_env(POLICIES, verdict_cache_size=1 << 20)
        quarter = torch_env(POLICIES, verdict_cache_size=(1 << 20) // 4)
        assert got == want == [[quarter.dedup_stats[k] for k in keys]] * 4
        assert sum(g[0] for g in got) <= whole.dedup_stats["cache_capacity"]
        assert [ev.dedup_stats[k] for k in keys] == [
            jev.dedup_stats[k] for k in keys
        ]
        whole.close()
        quarter.close()
    finally:
        ev.close()
        jev.close()


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_summed_counters_and_the_exact_warmup_count(monkeypatch, kernel):
    """``warmup_dispatches`` is the exact sum of the shards' exact counts:
    one ``warmup((b,))`` makes that many device dispatches; the summed
    counters are the sums of the shards'."""
    ev = sharded(flagship_specs(), "data:2,policy:2", kernel=kernel,
                 verdict_cache_size=0)
    try:
        made: list = []
        for shard in ev.shards:
            real = shard._enqueue_features

            def counting(features, real=real):
                made.append(1)
                return real(features)

            monkeypatch.setattr(shard, "_enqueue_features", counting)
        for _ in range(2):  # fresh, then with every pallas bucket armed
            want, made[:] = ev.warmup_dispatches, []
            assert want == sum(s.warmup_dispatches for s in ev.shards) > 0
            ev.warmup((8,))
            assert len(made) == want
        for name in ("host_profile", "dedup_stats", "breaker_stats"):
            summed: dict = {}
            for s in ev.shards:
                for k, v in getattr(s, name).items():
                    summed[k] = summed.get(k, 0) + v
            assert getattr(ev, name) == summed, name
        for name in ("plane_program_compiles", "batch_dedup_hits",
                     "host_fastpath_requests", "oracle_fallbacks",
                     "device_errors"):
            assert getattr(ev, name) == sum(getattr(s, name) for s in ev.shards)
        assert ev.supports_host_fastpath
    finally:
        ev.close()


def test_breaker_trips_only_the_owning_shard():
    jev = JaxSharded(jax_policies(POLICIES), jax_mesh("data:4,policy:2"))
    ev = sharded(POLICIES)
    try:
        for side in (jev, ev):
            owner = side._routing.owner["priv"]
            for _ in range(side.shards[owner].breaker.failure_threshold):
                side.record_dispatch_failure(["priv/x", "missing"])
            opened = [s.breaker_all_open for s in side.shards]
            assert opened == [i == owner for i in range(len(side.shards))]
            assert not side.breaker_all_open
            assert side.breaker_stats["open_shards"] == 1
        assert ev.breaker_stats == jev.breaker_stats
        for side in (jev, ev):
            for _ in range(5):
                side.record_dispatch_failure()
        assert ev.breaker_all_open and jev.breaker_all_open
        assert ev.breaker_stats == jev.breaker_stats
    finally:
        ev.close()
        jev.close()


def test_a_failed_shard_build_closes_the_shards_already_built(monkeypatch):
    from policy_server_tpu_torch.evaluation import environment as em

    built: list = []
    real_build = em.EvaluationEnvironmentBuilder.build

    def build(self, policies):
        if built:
            raise RuntimeError("shard build failed")
        env = real_build(self, policies)
        built.append(env)
        return env

    monkeypatch.setattr(em.EvaluationEnvironmentBuilder, "build", build)
    with pytest.raises(RuntimeError, match="shard build failed"):
        sharded(POLICIES)
    assert len(built) == 1 and built[0]._closed


# -- acceptance_psum -----------------------------------------------------------


def psum_bits() -> list:
    fixed = np.zeros((16, 3), dtype=bool)
    fixed[:5, 0] = True
    fixed[:, 1] = True
    rng = np.random.default_rng(173)
    return [fixed, rng.random((64, 37)) < 0.3, rng.random((1024, 5)) < 0.9]


@pytest.mark.parametrize("which", range(3))
def test_acceptance_psum_is_the_jax_packages(which):
    bits = psum_bits()[which]
    want = np.asarray(jax_psum(jmesh.make_mesh(JMeshSpec.parse("data:8")))(bits))
    got = acceptance_psum(cpu_mesh("data:8"))(torch.from_numpy(bits))
    assert got.dtype == torch.int32 and got.device == CPU
    assert got.tolist() == want.tolist() == bits.sum(axis=0).tolist()
    if which == 0:
        assert got.tolist() == [5, 16, 0]


def test_acceptance_psum_rows_must_split_over_the_data_axis():
    with pytest.raises(ValueError, match="does not split over 8"):
        acceptance_psum(cpu_mesh("data:8"))(torch.zeros((12, 2), dtype=torch.bool))


# -- the server under --mesh-dispatch threaded --------------------------------


def _post(port: int, path: str, body: bytes) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _get(port: int, path: str) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        return conn.getresponse().read().decode()
    finally:
        conn.close()


def _family_set(text: str) -> set:
    """The families of a /metrics page, without prometheus_client's
    ``_created`` series (the port's stdlib exposition has none)."""
    return {
        name for name in re.findall(r"^# TYPE (\S+) \S+$", text, re.M)
        if not name.endswith("_created")
    }


def _routes(server_port: int, reviews: list) -> list:
    raw = json.dumps({"request": {"uid": "raw-17", "operation": "create",
                                  "resource": {"replicas": 3}}}).encode()
    out = [_post(server_port, f"/validate/{pid}", body) for pid, body in reviews]
    out.append(_post(server_port, "/validate/nope", reviews[0][1]))
    out.append(_post(server_port, "/validate_raw/pod-privileged", raw))
    out.append(_post(server_port, "/validate_raw/nope", raw))
    return out


def test_server_under_threaded_answers_as_the_jax_server(monkeypatch):
    """The port's server at ``data:2,policy:2 --mesh-dispatch threaded``
    over 4 CPU entries, against the JAX server at the same flags (over 4 of
    its virtual devices): the same ``/validate`` and ``/validate_raw``
    status and bodies, the unknown id's 404, the same ``/metrics`` family
    set (the port's device-errors family besides); after one reload to a
    changed set, the promoted epoch is again a threaded evaluator over the
    same mesh, and both answer the changed set alike."""
    real_devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: real_devices(*a)[:4])
    specs = flagship_specs()
    changed = dict(specs)
    changed.pop("baseline-canary")
    docs = firehose_docs(24, seed=174)
    reviews = [(pid, json.dumps(docs[i]).encode())
               for i, pid in enumerate(sorted(specs)[:24])]
    port = PolicyServer(
        port_policies(specs), port=0, readiness_probe_port=0, device="cpu",
        mesh="data:2,policy:2", mesh_dispatch="threaded",
        mesh_devices=[CPU] * 4, max_batch_size=8,
    )
    assert isinstance(port.env, PolicyShardedEvaluator)
    assert [s._mesh.shape for s in port.env.shards] == [
        {"policy": 1, "data": 2}] * 2
    port.start()
    got = {}
    try:
        got["before"] = _routes(port.port, reviews)
        port_families = _family_set(_get(port.readiness_port, "/metrics"))
        assert port.lifecycle.reload(policies=port_policies(changed)) == "promoted"
        assert isinstance(port.env, PolicyShardedEvaluator)
        assert port.env.mesh.shape == {"policy": 2, "data": 2}
        assert "baseline-canary" not in port.env.policy_ids()
        got["after"] = _routes(port.port, reviews)
    finally:
        port.stop()
    want = {}
    jax_server = JaxServer(specs, mesh=JMeshSpec.parse("data:2,policy:2"),
                           mesh_dispatch="threaded")
    try:
        assert isinstance(jax_server.server.environment, JaxSharded)
        want["before"] = _routes(jax_server.port, reviews)
        jax_families = _family_set(_get(jax_server.readiness_port, "/metrics"))
        assert jax_server.server.lifecycle.reload(
            policies=jax_policies(changed)
        ) == "promoted"
        assert isinstance(jax_server.server.lifecycle._current.environment,
                          JaxSharded)
        want["after"] = _routes(jax_server.port, reviews)
    finally:
        jax_server.stop()
    assert got == want
    assert got["before"] != got["after"]
    assert [s for s, _b in got["before"]].count(404) == 2
    assert port_families - jax_families == {"policy_server_device_errors_total"}
    assert jax_families - port_families == set()


def test_serving_shards_under_threaded_fail_at_boot_as_in_the_jax_package():
    """``--serving-shards 2`` needs ``env.source_policies``, which neither
    package's threaded evaluator has: both refuse at boot with the JAX
    package's message."""
    from policy_server_tpu.runtime import shards as jshards

    class NoSource:
        pass

    with pytest.raises(ValueError) as jerr:
        jshards.build_serving_shards(NoSource(), lambda e: e, lambda p: p, 2)
    with pytest.raises(ValueError) as terr:
        PolicyServer(port_policies(POLICIES), port=0, readiness_probe_port=0,
                     device="cpu", mesh="data:1,policy:2",
                     mesh_dispatch="threaded", mesh_devices=[CPU] * 2,
                     serving_shards=2)
    assert str(terr.value) == str(jerr.value)
