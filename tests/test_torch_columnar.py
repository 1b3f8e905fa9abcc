"""The columnar delta-plane device path of the PyTorch port (``--kernel``,
``--columnar``, ``--donate-buffers``) against the JAX package's
``EvaluationEnvironment(kernel="xla")``: the delta planes built on the
host key for key, every response body byte-equal to the JAX package's
and the host oracle's (the three-policy set of ``tests/test_columnar.py``,
the family catalog and the flagship set over the firehose), the wire
accounting and the compile count equal after the same traffic;
``tests/test_columnar.py::TestColumnarParity`` through the port; the
plane rebuild on the resident zero tensors, ids past 32,767 and f32
columns; the ``--kernel pallas`` hotness gate, the warmup that arms every
bucket, K1 errors that never reach the non-Pallas program, and
``--kernel xla`` that launches no K1; the batcher's compile-sample
discard and the state store's fingerprint under ``--kernel``."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from policy_server_tpu.evaluation.environment import (
    EvaluationEnvironment as JaxEnvironment,
)
from policy_server_tpu.runtime.batcher import MicroBatcher as JaxBatcher
from policy_server_tpu_torch.evaluation import environment as tenv_mod
from policy_server_tpu_torch.evaluation.environment import (
    PALLAS_HOT_DISPATCHES,
    EvaluationEnvironment,
)
from policy_server_tpu_torch.ops import cuda_kernels
from policy_server_tpu_torch.runtime.batcher import MicroBatcher
from test_columnar import POLICIES
from torch_port_support import (
    catalog_docs,
    catalog_specs,
    export_state,
    firehose_docs,
    flagship_specs,
    items_for,
    jax_env,
    packed_batches,
    response_dicts,
    sync_envs,
    torch_env,
)

PACKED = "__packed__"
WIRE_KEYS = (
    "wire_bytes_shipped", "wire_bytes_packed_equiv", "wire_rows",
    "delta_cols_shipped", "delta_cols_total", "donated_dispatches",
    "resident_const_bytes", "dispatched_rows", "dispatched_chunks",
)
SETS = {
    "columnar": (lambda: dict(POLICIES), lambda: firehose_docs(48, seed=71)),
    "catalog": (catalog_specs, lambda: catalog_docs(24, seed=72)),
    "flagship": (flagship_specs, lambda: firehose_docs(48, seed=73)),
}


def pair(specs: dict, docs: list, **flags):
    """A JAX and a port environment on one intern table, at ``flags``
    (``kernel="xla"`` unless given)."""
    flags.setdefault("kernel", "xla")
    jenv = jax_env(specs, **flags)
    tenv = torch_env(specs, **flags)
    sync_envs(jenv, tenv, docs)
    return jenv, tenv


def profile_delta(env, before: dict) -> dict:
    after = env.host_profile
    return {k: after[k] - before[k] for k in WIRE_KEYS}


def assert_delta_equal(jd: dict, td: dict) -> None:
    assert sorted(td) == sorted(jd)
    for k, a in jd.items():
        a = np.asarray(a)
        assert td[k].dtype == a.dtype, k
        assert np.array_equal(td[k], a), k


@pytest.mark.parametrize("which", sorted(SETS))
def test_build_delta_equals_the_jax_packages_key_for_key(which):
    specs_of, docs_of = SETS[which]
    docs = docs_of()
    jenv, tenv = pair(specs_of(), docs)
    for batch in (1, 8, 32):
        for idx, wide in packed_batches(jenv, docs, batch).items():
            js, jd = jenv._build_delta(idx, {PACKED: wide})
            ts, td = tenv._build_delta(idx, {PACKED: wide})
            assert ts == js
            assert_delta_equal(jd, td)


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "packed"])
@pytest.mark.parametrize("which", sorted(SETS))
def test_bodies_and_accounting_equal_the_jax_package_and_the_oracle(
    which, columnar
):
    """``--kernel xla`` with ``--columnar on`` and ``off``: every body the
    JAX package's and the oracle's, and after the same traffic the wire
    accounting, the compile count and ``pallas_stats`` the JAX
    package's."""
    specs_of, docs_of = SETS[which]
    docs = docs_of()
    specs = specs_of()
    jenv, tenv = pair(specs, docs, columnar=columnar, verdict_cache_size=0)
    oracle = torch_env(specs, backend="oracle")
    items = items_for(docs, tenv.policy_ids(), seed=74)
    jb, tb = jenv.host_profile, tenv.host_profile
    want = response_dicts(jenv.validate_batch([(p, j) for p, j, _t in items]))
    got = response_dicts(tenv.validate_batch([(p, t) for p, _j, t in items]))
    assert got == want
    assert response_dicts(
        oracle.validate_batch([(p, t) for p, _j, t in items])
    ) == want
    assert any(not r["allowed"] for r in got)
    jd, td = profile_delta(jenv, jb), profile_delta(tenv, tb)
    assert td == jd
    assert (td["wire_rows"] > 0) == columnar
    assert tenv.plane_program_compiles == jenv.plane_program_compiles
    assert tenv.pallas_stats == jenv.pallas_stats == {
        "dispatches": 0, "buckets_armed": 0, "interpret_mode": 0,
    }
    if which == "columnar":
        assert any("patch" in r for r in got)


# -- tests/test_columnar.py::TestColumnarParity through the port -------------


@pytest.fixture(scope="module")
def col_pair():
    docs = firehose_docs(150, seed=11, wide_every=0)
    return pair(POLICIES, docs), docs


def _items(docs):
    return items_for(docs, sorted(POLICIES), seed=12)


def test_columnar_enabled_by_default():
    assert torch_env(POLICIES).columnar
    assert torch_env(POLICIES, backend="oracle").columnar is False


def test_columnar_matches_row_packed_and_oracle(col_pair):
    (jenv, tenv), docs = col_pair
    items = _items(docs)
    row_env = torch_env(POLICIES, kernel="xla", columnar=False)
    row_env.install_reference_state(*export_state(jenv))
    oracle = torch_env(POLICIES, backend="oracle")
    t_items = [(p, t) for p, _j, t in items]
    col = response_dicts(tenv.validate_batch(t_items))
    assert col == response_dicts(row_env.validate_batch(t_items))
    assert col == response_dicts(oracle.validate_batch(t_items))
    assert col == response_dicts(
        jenv.validate_batch([(p, j) for p, j, _t in items])
    )


def test_mutation_patches_survive_columnar(col_pair):
    (_jenv, tenv), docs = col_pair
    items = _items(docs)
    results = tenv.validate_batch([(p, t) for p, _j, t in items])
    patches = [
        r.patch for (pid, _j, _t), r in zip(items, results)
        if pid == "psp-capabilities" and r.patch is not None
    ]
    assert patches, "corpus produced no mutation patches"


def test_wire_accounting_reconciles(col_pair):
    """Shipped bytes positive and below the transport form's, every
    columnar dispatch donated, delta columns within the total: the JAX
    package's checks, and its numbers."""
    (jenv, tenv), docs = col_pair
    items = _items(docs)
    deltas = []
    for env, side in ((jenv, 1), (tenv, 2)):
        before = env.host_profile
        env.reset_verdict_cache()
        env.validate_batch([(it[0], it[side]) for it in items])
        deltas.append(profile_delta(env, before))
    jd, td = deltas
    assert td == jd
    assert td["wire_rows"] > 0 and td["wire_bytes_shipped"] > 0
    assert td["wire_bytes_shipped"] < td["wire_bytes_packed_equiv"]
    assert td["donated_dispatches"] == td["dispatched_chunks"]
    assert td["delta_cols_shipped"] <= td["delta_cols_total"]


@pytest.mark.parametrize("donate", [True, False], ids=["donate", "keep"])
def test_donation_off_still_bit_exact(col_pair, donate):
    (_jenv, _tenv), docs = col_pair
    env = torch_env(POLICIES, kernel="xla", donate_buffers=donate)
    oracle = torch_env(POLICIES, backend="oracle")
    t_items = [(p, t) for p, _j, t in _items(docs)]
    assert response_dicts(env.validate_batch(t_items)) == response_dicts(
        oracle.validate_batch(t_items)
    )
    donated = env.host_profile["donated_dispatches"]
    assert donated == (env.host_profile["dispatched_chunks"] if donate else 0)


def test_all_zero_batch_planes_elided(col_pair):
    """The warmup shape: an all-missing batch ships no delta bytes (every
    plane a resident zero tensor) and still evaluates, as in JAX."""
    (jenv, tenv), _docs = col_pair
    outs = []
    for env in (jenv, tenv):
        before = env.host_profile
        outs.append(env.run_batch(env.schemas[0].empty_batch_packed(8)))
        after = env.host_profile
        assert after["wire_bytes_shipped"] == before["wire_bytes_shipped"]
        assert after["wire_rows"] - before["wire_rows"] == 8
    for k, v in outs[0].items():
        assert np.array_equal(np.asarray(v), outs[1][k]), k


def test_delta_plane_padding_is_value_identical():
    """The power-of-two padding repeats a real column with its values:
    the port's selection is the JAX package's, and the duplicate scatter
    writes on the rebuild give back the matrix."""
    mat = np.zeros((4, 16), np.int32)
    mat[:, 3] = 7
    mat[:, 9] = np.arange(4)
    mat[:, 12] = -1
    jd: dict = {}
    td: dict = {}
    JaxEnvironment._delta_plane(jd, "i32", mat, 0.75)
    EvaluationEnvironment._delta_plane(td, "i32", mat, 0.75)
    assert_delta_equal(jd, td)
    cols = td["i32_cols"]
    assert len(cols) == 4 and sorted(set(cols.tolist())) == [3, 9, 12]
    rebuilt = torch.zeros((4, 16), dtype=torch.int32)
    rebuilt[:, torch.from_numpy(cols).long()] = torch.from_numpy(td["i32"])
    assert np.array_equal(rebuilt.numpy(), mat)


# -- the rebuild's hazards ----------------------------------------------------


def test_consecutive_batches_never_write_the_resident_zeros():
    """Two batches with different delta column sets, one after the other
    and then the first again: each equals the JAX package's output, and
    every resident zero tensor is still all zero."""
    pods = firehose_docs(16, seed=75, wide_every=0)
    # a labelled pod, a Deployment, a sysctl pod and a hostPath pod
    others = catalog_docs(4, seed=75)[-4:]
    jenv, tenv = pair(flagship_specs(), pods + others)
    a = packed_batches(jenv, pods, 16)[0]
    b = packed_batches(jenv, others, 16)[0]
    planes = [tenv._build_delta(0, {PACKED: x})[1] for x in (a, b)]
    # other planes, and other columns of the planes both ship
    assert set(planes[1]) - set(planes[0])
    assert not np.array_equal(planes[0]["bits_cols"], planes[1]["bits_cols"])
    for wide in (a, b, a):
        want = jenv.run_batch({PACKED: wide})
        got = tenv.run_batch({PACKED: wide})
        for k, v in want.items():
            assert np.array_equal(np.asarray(v), got[k]), k
    assert tenv._resident
    assert all(not bool(t.any()) for t in tenv._resident.values())


def test_ids_past_32767_widen_without_the_sign():
    """An intern table past 32,768 strings: the uint16 id plane carries
    ids the int16 view reads as negative, and every body still equals
    the JAX package's and the oracle's."""
    specs = flagship_specs()
    docs = firehose_docs(32, seed=76)
    jenv = jax_env(specs, kernel="xla", verdict_cache_size=0)
    tenv = torch_env(specs, kernel="xla", verdict_cache_size=0)
    for i in range(40_000):
        jenv.table.intern(f"padding-{i}")
    sync_envs(jenv, tenv, docs)
    assert 32_768 < len(tenv.table) <= 65_536
    wide = packed_batches(jenv, docs, 32)[0]
    _spec, delta = tenv._build_delta(0, {PACKED: wide})
    ids = delta.get("ids", delta.get("ids_full"))
    assert int(ids.max()) >= 32_768
    items = items_for(docs, tenv.policy_ids(), seed=77)
    want = response_dicts(jenv.validate_batch([(p, j) for p, j, _t in items]))
    assert response_dicts(
        tenv.validate_batch([(p, t) for p, _j, t in items])
    ) == want
    assert response_dicts(
        torch_env(specs, backend="oracle").validate_batch(
            [(p, t) for p, _j, t in items]
        )
    ) == want


def test_f32_columns_are_a_bitcast():
    """``replicas-max`` reads ``object.spec.replicas`` as f32: the i32
    plane ships its bits, and the rebuild bitcasts them."""
    specs = {
        "replicas": {
            "module": "builtin://replicas-max",
            "settings": {"max_replicas": 4},
        },
    }
    docs = []
    for i, n in enumerate((1, 4, 5, 9, 3.5, 4.5, 1e6, 0)):
        d = copy.deepcopy(catalog_docs(24, seed=78)[-3])
        d["request"]["uid"] = f"replicas-{i}"
        d["request"]["object"]["spec"]["replicas"] = n
        docs.append(d)
    jenv, tenv = pair(specs, docs, verdict_cache_size=0)
    layout = tenv.schemas[0].packed_layout()
    assert any(e.is_f32 for e in layout.entries32)
    wide = packed_batches(jenv, docs, 8)[0]
    _spec, delta = tenv._build_delta(0, {PACKED: wide})
    assert "i32" in delta or "i32_full" in delta
    feats, _bits = tenv._features_from_planes(_spec, {
        k: torch.from_numpy(np.ascontiguousarray(v).view(np.uint8))
        .view(tenv_mod._PLANE_DTYPES[v.dtype]).view(v.shape)
        for k, v in delta.items()
    })
    got = feats["object.spec.replicas:v:f32"]
    assert got.dtype == torch.float32
    assert got[:, ...].reshape(-1)[:3].tolist() == [1.0, 4.0, 5.0]
    items = items_for(docs, ["replicas"], seed=79)
    want = response_dicts(jenv.validate_batch([(p, j) for p, j, _t in items]))
    assert response_dicts(
        tenv.validate_batch([(p, t) for p, _j, t in items])
    ) == want
    assert [r["allowed"] for r in want] == [
        True, True, False, False, True, False, False, True,
    ]


# -- --kernel pallas: the hotness gate, the warmup, K1 errors -------------------


def test_pallas_hotness_gate_arms_after_threshold():
    """``tests/test_predicate_opt.py``'s gate through the port: below the
    threshold the non-Pallas program serves (no K1 dispatch), the
    threshold-th dispatch arms the bucket and goes to K1; the JAX
    package's counts after the same dispatches."""
    specs = {"priv": {"module": "builtin://pod-privileged"}}
    jenv = jax_env(specs, kernel="pallas")
    tenv = torch_env(specs, kernel="pallas")
    assert PALLAS_HOT_DISPATCHES == JaxEnvironment.PALLAS_HOT_DISPATCHES
    for env in (jenv, tenv):
        batch = env.schemas[0].empty_batch_packed(4)
        env._add_wasm_bits(batch, 4)
        for _ in range(PALLAS_HOT_DISPATCHES - 1):
            env.run_batch(dict(batch))
        assert env.pallas_stats["dispatches"] == 0
        assert env.pallas_stats["buckets_armed"] == 0
        env.run_batch(dict(batch))
        assert env.pallas_stats["buckets_armed"] == 1
        assert env.pallas_stats["dispatches"] == 1
    assert tenv.pallas_stats == jenv.pallas_stats
    assert tenv.plane_program_compiles == jenv.plane_program_compiles
    for k in WIRE_KEYS[:-2]:
        assert tenv.host_profile[k] == jenv.host_profile[k], k


def test_kernel_defaults_to_pallas_and_the_warmup_arms_every_bucket():
    from policy_server_tpu_torch import __main__ as cli
    from policy_server_tpu_torch.evaluation.environment import (
        DEFAULT_KERNEL,
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.server import PolicyServer
    import inspect

    assert DEFAULT_KERNEL == "pallas"
    assert cli.build_cli().parse_args([]).kernel == "pallas"
    assert EvaluationEnvironmentBuilder(device="cpu").kernel == "pallas"
    for fn in (PolicyServer.__init__, EvaluationEnvironment.__init__):
        assert inspect.signature(fn).parameters["kernel"].default == "pallas"
    env = torch_env(POLICIES)
    assert env.kernel == "pallas" and env.columnar and env.donate_buffers
    # per fresh bucket: the zero batch, the dense one, then dispatches
    # until the PALLAS_HOT_DISPATCHES-th arms it; the JAX package's
    # formula bounds that from above
    assert env.warmup_dispatches == len(env.schemas) * PALLAS_HOT_DISPATCHES
    jenv = jax_env(POLICIES, kernel="pallas")
    assert jenv.warmup_dispatches == len(env.schemas) * (2 + PALLAS_HOT_DISPATCHES)
    env.warmup((1, 2, 4, 8))
    stats = env.pallas_stats
    assert stats["buckets_armed"] == len(env.schemas)
    assert stats["interpret_mode"] == 1  # K1's plain version, on the CPU
    # after the warmup the served path is K1's
    calls = []
    orig = cuda_kernels.policy_matrix

    def counting(buf, program):
        calls.append(buf.shape[0])
        return orig(buf, program)

    before = env.host_profile["wire_rows"]
    cuda_kernels.policy_matrix = counting
    try:
        docs = firehose_docs(16, seed=80)
        items = items_for(docs, env.policy_ids(), seed=81)
        env.validate_batch([(p, t) for p, _j, t in items])
    finally:
        cuda_kernels.policy_matrix = orig
    assert calls and env.host_profile["wire_rows"] == before
    assert env.pallas_stats["dispatches"] == stats["dispatches"] + len(calls)


@pytest.mark.parametrize(
    "kernel,columnar",
    [("pallas", True), ("pallas", False), ("xla", True), ("xla", False)],
)
def test_warmup_dispatches_counts_what_one_warmup_makes(kernel, columnar):
    """``warmup_dispatches`` is the number of device dispatches the next
    ``warmup((b,))`` makes, on a fresh environment and after the
    batcher's warmup (where the batcher divides its RTT seed by it);
    under ``xla`` it is the JAX package's count."""
    env = torch_env(POLICIES, kernel=kernel, columnar=columnar)
    made = []
    orig = env._enqueue_features

    def counting(features):
        made.append(1)
        return orig(features)

    env._enqueue_features = counting
    try:
        fresh = env.warmup_dispatches
        env.warmup((1,))
        assert len(made) == fresh
        batcher = MicroBatcher(env, max_batch_size=8, latency_budget_ms=50)
        try:
            batcher.warmup()
            for b in (1, 2, 4, 8):
                expected, made[:] = env.warmup_dispatches, []
                env.warmup((b,))
                assert len(made) == expected, b
            assert sorted(batcher._dev_rtt) == [1, 2, 4, 8]
        finally:
            batcher.shutdown()
    finally:
        del env._enqueue_features
    per_bucket = (2 if columnar else 1) + (kernel == "pallas")
    assert env.warmup_dispatches == len(env.schemas) * per_bucket
    if kernel == "xla":
        jenv = jax_env(POLICIES, kernel="xla", columnar=columnar)
        assert env.warmup_dispatches == jenv.warmup_dispatches


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "packed"])
def test_kernel_xla_launches_no_k1(monkeypatch, columnar):
    env = torch_env(POLICIES, kernel="xla", columnar=columnar)
    calls = []
    monkeypatch.setattr(
        cuda_kernels, "policy_matrix", lambda *a: calls.append(a) or None
    )
    env.warmup((1, 4))
    docs = firehose_docs(24, seed=82)
    items = items_for(docs, env.policy_ids(), seed=83)
    got = response_dicts(env.validate_batch([(p, t) for p, _j, t in items]))
    assert calls == []
    assert env.pallas_stats == {
        "dispatches": 0, "buckets_armed": 0, "interpret_mode": 0,
    }
    assert got == response_dicts(
        torch_env(POLICIES, backend="oracle").validate_batch(
            [(p, t) for p, _j, t in items]
        )
    )


def test_k1_error_on_an_armed_bucket_fails_the_batch():
    """An armed bucket's K1 error fails its batch and is counted; the
    non-Pallas program never answers it."""
    env = torch_env(POLICIES, verdict_cache_size=0)
    env.warmup((1,))
    fallbacks = []
    for name in ("_enqueue_planes", "_enqueue_unpacked", "_eval_features"):
        orig = getattr(env, name)
        setattr(env, name, lambda *a, _o=orig, _n=name: fallbacks.append(_n) or _o(*a))
    fault = RuntimeError(
        "policy_matrix launch failed: CUDA error 700: an illegal memory "
        "access was encountered"
    )

    def broken(buf, program):
        raise fault

    orig_k1 = cuda_kernels.policy_matrix
    cuda_kernels.policy_matrix = broken
    try:
        docs = firehose_docs(8, seed=84)
        items = items_for(docs, env.policy_ids(), seed=85)
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            env.run_batch(env.schemas[0].empty_batch_packed(4))
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            env.validate_batch([(p, t) for p, _j, t in items])
    finally:
        cuda_kernels.policy_matrix = orig_k1
    assert fallbacks == []
    assert env.device_errors == 2
    assert env.breaker_stats["trips"] == 0


# -- the batcher's compile-sample discard ---------------------------------------


class _Env:
    """The counters a batcher's estimator reads."""

    plane_program_compiles = 0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_batcher_drops_the_rtt_sample_of_a_compile_window(pkg):
    """A dispatch window that saw a new program form feeds no RTT
    sample; the next one does. Both packages' estimators."""
    cls = JaxBatcher if pkg == "jax" else MicroBatcher
    b = object.__new__(cls)
    b.env = _Env()
    b.latency_budget = 0.05
    b.request_timeout = None
    b._dev_rtt = {8: 1.0}

    def observe(dur, before):
        if pkg == "jax":
            b._observe_dispatch(False, 8, 8, dur, compiles_before=before)
        else:
            b._observe_dispatch(False, 8, dur, compiles_before=before)

    before = b.env.plane_program_compiles
    b.env.plane_program_compiles += 1  # a new form inside the window
    observe(9.0, before)
    assert b._dev_rtt[8] == 1.0
    observe(2.0, b.env.plane_program_compiles)
    assert b._dev_rtt[8] == pytest.approx(0.7 * 1.0 + 0.3 * 2.0)


def test_served_batcher_keeps_the_seed_through_a_new_form():
    """Through a real batcher on the columnar path: the first batch of a
    new delta structure leaves the RTT estimate as it was, a repeat of
    the structure moves it."""
    env = torch_env(POLICIES, kernel="xla", verdict_cache_size=0)
    b = MicroBatcher(
        env, host_fastpath_threshold=0, latency_budget_ms=0,
        request_timeout_ms=10_000, max_batch_size=1, policy_timeout=30.0,
    ).start()
    try:
        docs = firehose_docs(2, seed=86, wide_every=0)
        items = items_for(docs, ["pod-privileged"], seed=87)
        b._dev_rtt[1] = 123.0
        compiles = env.plane_program_compiles
        b.evaluate(items[0][0], items[0][2])
        assert env.plane_program_compiles == compiles + 1
        assert b._dev_rtt[1] == 123.0
        b.evaluate(items[0][0], copy.deepcopy(items[0][2]))
        assert env.plane_program_compiles == compiles + 1
        assert b._dev_rtt[1] != 123.0
    finally:
        b.shutdown()


# -- the state store's fingerprint ----------------------------------------------


def test_fingerprint_changes_with_the_kernel(tmp_path):
    """A warm boot under another ``--kernel`` (or ``--columnar``) is a
    fingerprint mismatch, as in the JAX package; the same flags match."""
    from policy_server_tpu_torch.models.policy import parse_policies
    from policy_server_tpu_torch.server import PolicyServer

    def boot(**flags) -> dict:
        srv = PolicyServer(
            parse_policies(POLICIES), port=0, readiness_probe_port=0,
            device="cpu", warmup=False, state_dir=str(tmp_path / "state"),
            **flags,
        )
        srv.start()
        try:
            return dict(srv.state.boot_report)
        finally:
            srv.stop()

    assert boot()["warm"] is False
    assert boot()["fingerprint_match"] is True
    assert boot(kernel="xla")["fingerprint_match"] is False
    assert boot(kernel="xla")["fingerprint_match"] is True
    assert boot(kernel="xla", columnar=False)["fingerprint_match"] is False


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_a_dispatch_leaves_no_tensor_to_the_garbage_collector(kernel):
    """The compiled predicates' lowering (``lower_expr``) and the group
    combine (``lower_group``) free their tensors when the call returns: a
    reference cycle among their nested functions would hold them, on the
    card device memory, until a garbage collection (the card's test of
    closed environments' memory plateau failed on it)."""
    import gc

    env = torch_env(flagship_specs(), kernel=kernel, verdict_cache_size=0)
    env.warmup((1,))
    items = items_for(firehose_docs(16, seed=88), env.policy_ids(), seed=89)
    pairs = [(p, t) for p, _j, t in items]
    env.validate_batch(pairs)
    gc.collect()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        env.validate_batch(pairs)
        gc.collect()
        leaked = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    assert leaked == []
