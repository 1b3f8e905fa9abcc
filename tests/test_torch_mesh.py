"""The device mesh of the PyTorch port (``policy_server_tpu_torch/parallel``,
``EvaluationEnvironment.attach_mesh``) against the JAX package's
(``policy_server_tpu/parallel/mesh.py``): ``MeshSpec.parse``,
``resolve_axes`` and ``make_mesh`` over 8 entries against JAX's over the
test process's 8 virtual CPU devices, ``plan_policy_buckets``, ``bucket_for``,
K1's per-shard tile plan against ``policy_matrix_program(buckets=[b],
width=w, interpret=True)``, environments over CPU meshes (a device list of
one CPU entry taken several times) against the JAX single-device
environment, the oracle, JAX's ``PolicyShardedEvaluator`` and JAX's
data-mesh environment, a one-device mesh against no mesh, and the server
built over a mesh against the JAX server. Tolerance: exact equality
throughout (verdicts, rule indices and response bodies)."""

from __future__ import annotations

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from policy_server_tpu.config.config import MeshSpec as JMeshSpec
from policy_server_tpu.ops import pallas_kernels
from policy_server_tpu.parallel import PolicyShardedEvaluator
from policy_server_tpu.parallel import mesh as jmesh
from policy_server_tpu_torch.models.policy import (
    parse_policy_entry as t_parse_policy_entry,
)
from policy_server_tpu_torch.ops import cuda_kernels as ck
from policy_server_tpu_torch.parallel import mesh as tmesh
from policy_server_tpu_torch.server import PolicyServer, _build_environment

from test_torch_kernels import run_tape
from torch_port_support import (
    FORM_FLAGS,
    buffer_forms,
    firehose_docs,
    flagship_specs,
    items_for,
    jax_env,
    packed_batches,
    response_dicts,
    sync_envs,
    torch_env,
)
from policy_server_tpu.models.policy import parse_policy_entry

CPU = torch.device("cpu")
N_REVIEWS = 256
# the firehose goes in batches of this many: 256 = 4 x 60 + 16, an uneven
# final batch
SERVE_BATCH = 60
MESHES = ["data:8", "data:3", "data:4,policy:2", "data:2,policy:4",
          "data:1,policy:8"]
KERNEL_BATCH = 8


def n_devices(spec: str) -> int:
    n = 1
    for _name, size in tmesh.MeshSpec.parse(spec).axes:
        n *= size
    return n


def cpu_mesh(spec: str) -> tmesh.Mesh:
    return tmesh.make_mesh(
        tmesh.MeshSpec.parse(spec), devices=[CPU] * n_devices(spec)
    )


def outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


# -- MeshSpec, resolve_axes, make_mesh ----------------------------------------


@pytest.mark.parametrize("spec", [
    "auto", "", "data:8", "data:4,policy:2", "policy:2", "gpu:2", "data:0",
    "data:x", "data:2,data:2", "data:2,,policy:2",
])
def test_mesh_spec_parse_is_the_jax_packages(spec):
    want = outcome(lambda s: JMeshSpec.parse(s).axes, spec)
    got = outcome(lambda s: tmesh.MeshSpec.parse(s).axes, spec)
    assert got == want
    if want[0] == "ok":
        jm, tm = JMeshSpec.parse(spec), tmesh.MeshSpec.parse(spec)
        assert (tm.data_size(), tm.policy_size()) == (
            jm.data_size(), jm.policy_size()
        )


@pytest.mark.parametrize("spec", [
    "auto", "data:8", "data:4,policy:2", "data:2,policy:4", "data:1,policy:8",
    "policy:8", "policy:2", "data:3", "policy:3", "data:2,policy:2",
])
def test_make_mesh_over_eight_entries_is_the_jax_packages(spec):
    """Axis sizes, axis names and the grid's order by device index equal
    JAX's ``make_mesh`` over the test process's 8 virtual devices; the errors
    ("does not divide", "does not match") are its text."""
    jdevs = jax.devices()
    assert len(jdevs) == 8
    j_spec, t_spec = JMeshSpec.parse(spec), tmesh.MeshSpec.parse(spec)
    entries = [torch.device("cpu", i) for i in range(8)]
    want = outcome(jmesh.resolve_axes, j_spec, jdevs)
    assert outcome(tmesh.resolve_axes, t_spec, entries) == want
    jm = outcome(jmesh.make_mesh, j_spec, jdevs)
    tm = outcome(tmesh.make_mesh, t_spec, entries)
    assert jm[0] == tm[0]
    if jm[0] != "ok":
        assert tm == jm
        return
    jm, tm = jm[1], tm[1]
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.shape == dict(jm.shape)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert np.array_equal(np.vectorize(lambda d: d.index)(tm.devices), ids)


def test_multi_process_mesh_rejects_host_spanning_data_shards(monkeypatch):
    """``tests/test_mesh_spmd.py``'s host-spanning check with a faked
    process count, through both packages: the same message, and a
    host-local policy axis builds with the data axis outermost."""
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    monkeypatch.setattr(jax, "local_device_count", lambda: 2)
    monkeypatch.setattr(tmesh, "process_count", lambda: 4)
    monkeypatch.setattr(tmesh, "local_device_count", lambda _t="cuda": 2)
    with pytest.raises(ValueError, match="policy axis 4 must divide") as jerr:
        jmesh.make_mesh(JMeshSpec.parse("data:2,policy:4"))
    with pytest.raises(ValueError) as terr:
        tmesh.make_mesh(tmesh.MeshSpec.parse("data:2,policy:4"), list(range(8)))
    assert str(terr.value) == str(jerr.value)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "local_device_count", lambda: 4)
    monkeypatch.setattr(tmesh, "process_count", lambda: 2)
    monkeypatch.setattr(tmesh, "local_device_count", lambda _t="cuda": 4)
    jm = jmesh.make_mesh(JMeshSpec.parse("data:4,policy:2"))
    tm = tmesh.make_mesh(tmesh.MeshSpec.parse("data:4,policy:2"), list(range(8)))
    assert tm.axis_names == tuple(jm.axis_names) == ("data", "policy")
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert np.array_equal(tm.devices.astype(np.int64), ids)
    # each process owns its half, data shard by data shard
    assert tm.processes.tolist() == [[0, 0], [0, 0], [1, 1], [1, 1]]
    assert tm.local_data_shards() == [[0, 1], [2, 3]]
    tm.process_index = 1
    assert tm.local_data_shards() == [[4, 5], [6, 7]]


# -- plan_policy_buckets, bucket_for, shard_*, pad_batch_to -------------------


@pytest.fixture(scope="module")
def flagship_ids() -> list[str]:
    env = torch_env(flagship_specs(), backend="oracle")
    return list(env._bound)


@pytest.mark.parametrize("shards", [1, 2, 3, 8, 64])
def test_plan_policy_buckets_is_the_jax_packages(flagship_ids, shards):
    assert len(flagship_ids) < 64
    got = tmesh.plan_policy_buckets(flagship_ids, shards)
    assert got == jmesh.plan_policy_buckets(flagship_ids, shards)
    assert tmesh.plan_policy_buckets(["d", "b", "a", "c", "e"], 2) == (
        [("a", "c", "e"), ("b", "d")], 3,
        {"a": 0, "c": 1, "e": 2, "b": 3, "d": 4},
    )


@pytest.fixture(scope="module")
def bucket_envs():
    specs = {"priv": {"module": "builtin://pod-privileged"}}
    return jax_env(specs), specs


@pytest.mark.parametrize("data", range(1, 9))
def test_bucket_for_is_the_jax_packages(bucket_envs, data):
    """``bucket_for`` rounds to multiples of the data axis as the JAX
    package's (its ``_min_bucket`` set as ``attach_mesh`` sets it)."""
    jenv, specs = bucket_envs
    tenv = torch_env(specs)
    tenv.attach_mesh(cpu_mesh(f"data:{data}"))
    jenv._min_bucket = data
    try:
        sizes = list(range(0, 70)) + [127, 128, 129, 1000, 1023, 1024, 1025]
        assert [tenv.bucket_for(n) for n in sizes] == [
            jenv.bucket_for(n) for n in sizes
        ]
        assert all(tenv.bucket_for(n) % data == 0 for n in sizes)
    finally:
        jenv._min_bucket = 1
        tenv.close()


def test_shard_features_and_delta_planes():
    """Batch rows split into contiguous data shards; planes of 2 or more
    dimensions split, 1-D column vectors go whole to every shard (the JAX
    package's ``shard_delta_planes`` placement)."""
    shards = len(cpu_mesh("data:4,policy:2").local_data_shards())
    assert shards == 4
    delta = {
        "i32": np.arange(48, dtype=np.int32).reshape(8, 6),
        "i32_cols": np.arange(6, dtype=np.int32),
        "bits": np.arange(16, dtype=np.uint8).reshape(8, 2),
    }
    parts = tmesh.shard_delta_planes(delta, shards)
    assert len(parts) == 4
    for d, part in enumerate(parts):
        assert np.array_equal(part["i32"], delta["i32"][2 * d : 2 * d + 2])
        assert np.array_equal(part["bits"], delta["bits"][2 * d : 2 * d + 2])
        assert part["i32_cols"] is delta["i32_cols"]
    feats = tmesh.shard_features({"__packed__": delta["bits"]}, shards)
    assert np.array_equal(
        np.concatenate([f["__packed__"] for f in feats]), delta["bits"]
    )
    with pytest.raises(ValueError, match="does not split over 4"):
        tmesh.shard_features({"__packed__": np.zeros((6, 2))}, shards)


@pytest.mark.parametrize("n,multiple", [
    (0, 1), (5, 1), (5, 0), (1, 4), (4, 4), (5, 4), (17, 3), (1024, 6),
])
def test_pad_batch_to_is_the_jax_packages(n, multiple):
    assert tmesh.pad_batch_to(n, multiple) == jmesh.pad_batch_to(n, multiple)


# -- K1's per-shard tile plan --------------------------------------------------


@pytest.fixture(scope="module")
def sharded_pair():
    """A JAX and a port flagship environment on one intern table, the
    port's over a ``data:1,policy:4`` CPU mesh (its per-shard programs
    built), and packed batches of both buckets."""
    docs = firehose_docs(2 * KERNEL_BATCH, seed=161)
    jenv = jax_env(flagship_specs())
    tenv = torch_env(flagship_specs())
    sync_envs(jenv, tenv, docs)
    return jenv, tenv, packed_batches(jenv, docs, KERNEL_BATCH)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("idx,form", [(0, "narrow"), (1, "transport")],
                         ids=["small-narrow", "large-transport"])
def test_per_shard_program_matches_pallas(sharded_pair, shards, idx, form):
    """For each policy shard: the plain version of its program and its tape
    (the numpy interpreter) equal JAX ``policy_matrix_program(...,
    buckets=[b], width=w, interpret=True)`` over that shard's compiled
    functions, on the same packed bytes; the output is the shard's block
    (width columns) and the tape holds only the shard's policies."""
    jenv, tenv, batches = sharded_pair
    tenv.attach_mesh(cpu_mesh(f"data:1,policy:{shards}"))
    buckets, width, _col = jmesh.plan_policy_buckets(
        list(jenv._compiled), shards
    )
    assert tenv._mesh_buckets == buckets and tenv._mesh_block_width == width
    buf = buffer_forms(jenv, idx, batches[idx])[form]
    transport, narrow = FORM_FLAGS[form]
    full = tenv.program_for(idx, transport, narrow)
    for p, bucket in enumerate(buckets):
        run, want_cols = pallas_kernels.policy_matrix_program(
            jenv.schemas[idx].packed_layout(), transport, narrow,
            {pid: jenv._compiled[pid] for pid in bucket},
            use_cse=jenv.optimization is not None, interpret=True,
            buckets=[tuple(bucket)], width=width,
        )
        want_a, want_r = (np.asarray(x) for x in run(jnp.asarray(buf)))
        program = tenv.program_for(idx, transport, narrow, p)
        assert program.column_of == want_cols
        assert program.out_cols == width == want_a.shape[1]
        got_a, got_r = ck.policy_matrix(torch.from_numpy(buf), program)
        np.testing.assert_array_equal(got_a.numpy(), want_a)
        np.testing.assert_array_equal(got_r.numpy(), want_r)
        tape_a, tape_r = run_tape(program, buf)
        np.testing.assert_array_equal(tape_a, want_a)
        np.testing.assert_array_equal(tape_r, want_r)
        assert len(program.tape) < len(full.tape)
    # every shard's program is cached under its own key
    keys = {k for k in tenv._programs if len(k) == 4}
    assert {k[3] for k in keys} == set(range(shards))


# -- environments over CPU meshes ---------------------------------------------


@pytest.fixture(scope="module")
def firehose():
    docs = firehose_docs(N_REVIEWS, seed=162)
    ids = torch_env(flagship_specs(), backend="oracle").policy_ids()
    return docs, items_for(docs, ids, seed=163)


def serve(env, items, jax_side: bool) -> list:
    """The firehose through ``validate_batch`` in batches of SERVE_BATCH
    (an uneven final batch)."""
    out = []
    for c in range(0, len(items), SERVE_BATCH):
        chunk = items[c : c + SERVE_BATCH]
        pairs = [(p, j if jax_side else t) for p, j, t in chunk]
        out += response_dicts(env.validate_batch(pairs))
    return out


@pytest.fixture(scope="module")
def references(firehose):
    """Bodies of the oracle, of the JAX single-device environment under
    each kernel (pallas armed by its warmup), of JAX's
    ``PolicyShardedEvaluator`` under each policy-axis mesh and of JAX's
    ``data:8`` data-mesh environment, on the same firehose."""
    _docs, items = firehose
    specs = flagship_specs()
    refs = {"oracle": serve(torch_env(specs, backend="oracle"), items, False)}
    for kernel in ("pallas", "xla"):
        jenv = jax_env(specs, kernel=kernel, verdict_cache_size=0)
        jenv.warmup((SERVE_BATCH,))
        refs[kernel] = serve(jenv, items, True)
        if kernel == "pallas":
            assert jenv.pallas_stats["buckets_armed"] == len(jenv.schemas)
        jenv.close()
    parsed = {k: parse_policy_entry(k, v) for k, v in specs.items()}
    for spec in MESHES:
        if JMeshSpec.parse(spec).policy_size() > 1:
            sharded = PolicyShardedEvaluator(
                parsed, jmesh.make_mesh(JMeshSpec.parse(spec)),
                builder_kwargs=dict(verdict_cache_size=0),
            )
            refs[spec] = serve(sharded, items, True)
            sharded.close()
    data_env = jax_env(specs, verdict_cache_size=0)
    data_env.attach_mesh(jmesh.make_mesh(JMeshSpec.parse("data:8")))
    refs["data:8"] = serve(data_env, items, True)
    data_env.close()
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


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "packed"])
@pytest.mark.parametrize("kernel", ["pallas", "xla"])
@pytest.mark.parametrize("spec", MESHES)
def test_mesh_environment_equals_single_device_and_oracle(
    firehose, references, monkeypatch, spec, kernel, columnar
):
    """Every body over the mesh equals the oracle's and the JAX
    single-device environment's of the same kernel; under a policy axis
    also JAX's ``PolicyShardedEvaluator``'s, under ``data:8`` JAX's
    data-mesh environment's. Under ``pallas`` every bucket is armed and
    each K1 step runs once per mesh position (policy shard's program
    under a policy axis); under ``xla`` K1 never runs."""
    _docs, items = firehose
    env = torch_env(
        flagship_specs(), kernel=kernel, columnar=columnar, verdict_cache_size=0
    )
    mesh = cpu_mesh(spec)
    env.attach_mesh(mesh)
    env.warmup((SERVE_BATCH,))
    ps0 = env.pallas_stats
    hp0 = env.host_profile
    with counting_k1(monkeypatch) as calls:
        got = serve(env, items, False)
    shard_programs = {
        id(program): k[3] for k, program in env._programs.items() if len(k) == 4
    }
    env.close()
    assert got == references["oracle"]
    assert got == references[kernel]
    if spec in references:
        assert got == references[spec]
    assert any(not r["allowed"] for r in got)
    assert any("patch" in r for r in got)
    dispatches = env.pallas_stats["dispatches"] - ps0["dispatches"]
    positions = mesh.size
    if kernel == "pallas":
        assert env.pallas_stats["buckets_armed"] == len(env.schemas)
        assert dispatches == env.host_profile["dispatched_chunks"] - hp0[
            "dispatched_chunks"
        ] > 0
        assert len(calls) == positions * dispatches
        if mesh.shape["policy"] > 1:
            # every launch is a shard's program, and every shard ran
            assert {shard_programs[id(p)] for p in calls} == set(
                range(mesh.shape["policy"])
            )
            assert all(p.out_cols == env._mesh_block_width for p in calls)
        else:
            assert all(p.out_cols >= len(env._compiled) for p in calls)
    else:
        assert dispatches == 0 and not calls
    wire_rows = env.host_profile["wire_rows"] - hp0["wire_rows"]
    assert (wire_rows > 0) == (columnar and kernel == "xla")
    if wire_rows:
        assert wire_rows % mesh.shape["data"] == 0


def test_multi_process_mesh_keeps_packed(monkeypatch):
    """As the JAX package's: a multi-process mesh keeps the packed
    transport (``_columnar_mesh_ok``), and the warmup counts one dispatch
    per bucket."""
    env = torch_env(flagship_specs(), kernel="xla")
    env.attach_mesh(cpu_mesh("data:2"))
    assert env._columnar_mesh_ok() and env.warmup_dispatches == 2 * len(env.schemas)
    monkeypatch.setattr(tmesh, "process_count", lambda: 2)
    assert not env._columnar_mesh_ok()
    assert env.warmup_dispatches == len(env.schemas)
    env.close()


def test_mesh_position_of_another_device_type_raises():
    env = torch_env(flagship_specs())
    mesh = tmesh.make_mesh(
        tmesh.MeshSpec.parse("data:2"), devices=[CPU, torch.device("cuda", 0)]
    )
    with pytest.raises(ValueError, match="this environment runs on cpu"):
        env.attach_mesh(mesh)
    env.close()


def test_close_waits_on_the_last_event_of_every_card(monkeypatch):
    """A step over two cards records an event on each card's default
    stream, and both streams have the handle 0: ``close()`` still waits
    on both before it releases the programs and the page-locked pool.
    The CUDA stream, event and device calls are faked, so this runs
    without a card."""
    env = torch_env(flagship_specs())
    on = iter([0, 1])
    waited = []

    class Stream:
        def __init__(self):
            self.device_index, self.cuda_stream = next(on), 0

    class Event:
        def record(self, stream):
            self.card = stream.device_index

        def synchronize(self):
            waited.append(self.card)

    monkeypatch.setattr(torch.cuda, "device", lambda _d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(
        env._pinned, "take", lambda shape, dtype: torch.empty(shape, dtype=dtype)
    )
    outs = [torch.full((2, 3), d, dtype=torch.uint8) for d in (0, 1)]
    step = env._finish_step(outs, torch.empty(4, dtype=torch.uint8))
    assert step.host_out.tolist() == [[0] * 3] * 2 + [[1] * 3] * 2
    assert sorted(env._last_events) == [(0, 0), (1, 0)]
    assert env.close()
    assert sorted(waited) == [0, 1]


# -- a one-device mesh is no mesh ---------------------------------------------


@pytest.mark.parametrize("spec", ["auto", "data:1"])
@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_one_device_mesh_equals_no_mesh(firehose, spec, kernel):
    """``_build_environment`` over one device attaches nothing: the bodies,
    ``pallas_stats`` and the columnar counters equal an environment built
    without a mesh, on the same traffic."""
    _docs, items = firehose
    kwargs = dict(backend="torch", device="cpu", kernel=kernel,
                  verdict_cache_size=0)
    policies = {k: t_parse_policy_entry(k, v) for k, v in flagship_specs().items()}
    meshed = _build_environment(
        policies, kwargs, tmesh.MeshSpec.parse(spec), devices=[CPU]
    )
    plain = torch_env(flagship_specs(), kernel=kernel, verdict_cache_size=0)
    assert meshed._mesh is None and meshed._min_bucket == 1
    for env in (meshed, plain):
        env.warmup((SERVE_BATCH,))
    assert serve(meshed, items, False) == serve(plain, items, False)
    assert meshed.pallas_stats == plain.pallas_stats
    assert meshed.host_profile["wire_rows"] == plain.host_profile["wire_rows"]
    assert {k: v for k, v in meshed.host_profile.items() if not k.endswith("_ns")} == {
        k: v for k, v in plain.host_profile.items() if not k.endswith("_ns")
    }
    meshed.close()
    plain.close()


# -- the server over a mesh ----------------------------------------------------


def post(port: int, pid: str, doc: dict) -> tuple[int, dict]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", f"/validate/{pid}", body=json.dumps(doc),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_server_over_a_mesh_answers_as_the_jax_server(firehose):
    """The port's server at ``data:4,policy:2`` over 8 CPU entries (the
    ``devices`` seam of ``_build_environment``) answers ``/validate`` with
    the JAX server's bodies (its default ``auto`` mesh over the test process's 8
    virtual devices), before and after a reload to a changed set; the
    reload candidate is built over the mesh too."""
    from torch_port_support import JaxServer

    docs, _items = firehose
    specs = flagship_specs()
    changed = dict(specs)
    changed.pop("baseline-canary")
    work = [(pid, docs[i]) for i, pid in enumerate(sorted(specs)[:24])]
    port = PolicyServer(
        {k: t_parse_policy_entry(k, v) for k, v in specs.items()},
        port=0, readiness_probe_port=0, device="cpu",
        mesh="data:4,policy:2", mesh_devices=[CPU] * 8,
        host_fastpath_threshold=0, verdict_cache_size=0,
    )
    assert port.env._mesh is not None and port.env._mesh_buckets
    port.start()
    bodies = {}
    try:
        for name, policy_set in (("before", specs), ("after", changed)):
            if name == "after":
                assert port.lifecycle.reload(policies={
                    k: t_parse_policy_entry(k, v) for k, v in changed.items()
                }) == "promoted"
                assert port.env._mesh.shape == {"policy": 2, "data": 4}
            bodies[name] = [post(port.port, pid, d) for pid, d in work]
    finally:
        port.stop()
    for name, policy_set in (("before", specs), ("after", changed)):
        jax_server = JaxServer(policy_set)
        try:
            want = [post(jax_server.port, pid, d) for pid, d in work]
        finally:
            jax_server.stop()
        assert bodies[name] == want, name
    assert bodies["before"] != bodies["after"]


def test_mesh_larger_than_the_devices_fails_at_boot():
    """``--mesh data:2`` over one device fails at boot with the JAX
    package's message."""
    with pytest.raises(ValueError) as jerr:
        jmesh.resolve_axes(JMeshSpec.parse("data:2"), jax.devices()[:1])
    policies = {"p": t_parse_policy_entry("p", {"module": "builtin://pod-privileged"})}
    with pytest.raises(ValueError) as terr:
        PolicyServer(policies, port=0, readiness_probe_port=0, device="cpu",
                     mesh="data:2")
    assert str(terr.value) == str(jerr.value) == (
        "mesh 2x1 does not match device count 1"
    )


def test_threaded_dispatch_with_a_policy_axis_boots_a_policy_sharded_evaluator():
    """``--mesh-dispatch threaded`` with a policy axis > 1 builds the
    thread-per-shard ``PolicyShardedEvaluator`` (its parity is in
    ``tests/test_torch_parallel.py``); without a policy axis the flag
    leaves the fused environment."""
    from policy_server_tpu_torch.parallel import PolicyShardedEvaluator as Sharded

    policies = {"p": t_parse_policy_entry("p", {"module": "builtin://pod-privileged"})}
    server = PolicyServer(policies, port=0, readiness_probe_port=0, device="cpu",
                          mesh="data:1,policy:2", mesh_dispatch="threaded",
                          mesh_devices=[CPU] * 2)
    server.start()
    try:
        assert isinstance(server.env, Sharded) and len(server.env.shards) == 2
    finally:
        server.stop()
    env = _build_environment(
        policies, dict(backend="torch", device="cpu"),
        tmesh.MeshSpec.parse("data:2"), "threaded", devices=[CPU] * 2,
    )
    assert not isinstance(env, Sharded) and env._mesh.shape["data"] == 2
    env.close()
