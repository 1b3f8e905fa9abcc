"""Host-executed policies in the port's environment against the JAX
package's: a policy group mixing a waPC wasm member with an IR member
(``wasmpriv() && ns()``), a group whose wasm member is never referenced,
a group with a mutating wasm member, and standalone waPC, OPA/Gatekeeper,
WASI, mutating and host-interpreted CEL policies beside IR policies.

Every path is held to the JAX environment (``kernel="pallas"``, every
bucket armed, interpret mode) and to the port's oracle backend: the
verdicts, causes, messages, codes and patches must be equal through
``validate``, ``validate_batch`` (the native path, with the verdict cache
on and off), the host fast path, the split native pipeline
(``validate_batch_begin``/``finish``), ``backend="oracle"``, the
micro-batcher, and a replay — which re-runs the wasm engine (wasm targets
are never cached) and dispatches no cached IR row."""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from torch_port_support import (
    audit_sides,
    firehose_docs,
    items_for,
    jax_env,
    pod_doc,
    response_dicts,
    torch_env,
)
import torch_wasm_fixtures as fixtures

JAX = "policy_server_tpu"
PORT = "policy_server_tpu_torch"


def mod(side: str, name: str):
    return importlib.import_module(f"{side}.{name}")


def mutating_stub(side: str):
    """A host-executed module whose verdict always carries a mutation."""
    compiler = mod(side, "ops.compiler")
    ir = mod(side, "ops.ir")
    base = mod(side, "policies.base")

    class MutatingWasmStub:
        name = "mutator"
        digest = "stub"

        def build(self, settings):
            return compiler.PolicyProgram(
                rules=(compiler.Rule("wasm-host-executed", ir.false(), "unreachable"),),
                host_evaluator=lambda payload: {
                    "accepted": True,
                    "mutated_object": {"patched": True},
                },
            )

        def validate_settings(self, settings):
            return base.SettingsValidationResponse(valid=True, message=None)

    return MutatingWasmStub()


def resolver_for(side: str, tmp_path):
    """URL → module: the fixtures' wasm through the side's load_artifact,
    the stub, and the side's builtins."""
    load = mod(side, "fetch.artifact").load_artifact
    modules = {}
    for name, data in (
        ("priv.wasm", fixtures.wapc_privileged_wasm()),
        ("opa.wasm", fixtures.builtin_oracle_wasm()),
        ("wasi.wasm", fixtures.wasi_policy_wasm()),
    ):
        path = tmp_path / f"{side}-{name}"
        path.write_bytes(data)
        modules[f"file:///{name}"] = load(path)
    modules["stub://mutator"] = mutating_stub(side)
    resolve_builtin = mod(side, "policies").resolve_builtin

    def resolve(url: str):
        if url in modules:
            return modules[url]
        builtin = resolve_builtin(url)
        assert builtin is not None, url
        return builtin

    return resolve


NS = {"module": "builtin://namespace-validate",
      "settings": {"denied_namespaces": ["blocked"]}}

SPECS = {
    "guard": {
        "expression": "wasmpriv() && ns()",
        "message": "pod guard rejected",
        "policies": {"wasmpriv": {"module": "file:///priv.wasm"}, "ns": NS},
    },
    "g-unref": {
        "expression": "ns()",
        "message": "denied",
        "policies": {"wasmpriv": {"module": "file:///priv.wasm"}, "ns": NS},
    },
    "g-mut": {
        "expression": "mut() || happy()",
        "message": "denied",
        "policies": {"mut": {"module": "stub://mutator"},
                     "happy": {"module": "builtin://always-happy"}},
    },
    "wasm-priv": {"module": "file:///priv.wasm"},
    "opa-gk": {"module": "file:///opa.wasm"},
    "wasi-priv": {"module": "file:///wasi.wasm"},
    "mut-alone": {"module": "stub://mutator", "allowedToMutate": True},
    "cel-host": {"module": "builtin://cel-policy", "settings": {"validations": [{
        "expression": "object.spec.replicas * 2 <= 10",
        "message": "too many replicas",
    }]}},
    "ns": NS,
    "priv-ir": {"module": "builtin://pod-privileged"},
}
WASM_TARGETS = ("guard", "g-mut", "wasm-priv", "opa-gk", "wasi-priv",
                "mut-alone", "cel-host")


def pallas_env(specs, **kw):
    env = jax_env(specs, kernel="pallas", **kw)
    env._pallas_armed.update(range(len(env.schemas)))
    env._pallas_interpret = True
    return env


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wasm")
    jres = resolver_for(JAX, tmp)
    tres = resolver_for(PORT, tmp)
    return {
        "jax": pallas_env(SPECS, module_resolver=jres, verdict_cache_size=0),
        "port": torch_env(SPECS, module_resolver=tres),
        "port_nocache": torch_env(SPECS, module_resolver=tres, verdict_cache_size=0),
        "port_oracle": torch_env(SPECS, backend="oracle", module_resolver=tres),
    }


def pod_docs() -> list[dict]:
    docs = [
        pod_doc(name=f"p{k}", namespace=ns, privileged=priv, uid=f"u{k}")
        for k, (ns, priv) in enumerate(
            [(n, p) for n in ("default", "blocked") for p in (False, True)] * 2
        )
    ]
    for k, d in enumerate(docs):
        if k % 3 == 0:
            d["request"]["object"]["spec"]["replicas"] = 2 + 2 * k
    return docs


def review_docs() -> list[dict]:
    return pod_docs() + firehose_docs(16, seed=71)


def paired_items(seed: int):
    """Every pod review to every policy id, then seeded firehose reviews
    to seeded policy ids."""
    ids = sorted(SPECS)
    crossed = [
        (pid, j, t)
        for pid in ids
        for _p, j, t in items_for(pod_docs(), [pid], seed=seed)
    ]
    return crossed + items_for(firehose_docs(16, seed=71), ids, seed=seed)


def jax_answers(envs, items):
    return response_dicts(envs["jax"].validate_batch([(p, j) for p, j, _t in items]))


def test_the_set_is_not_vacuous(envs):
    items = paired_items(seed=73)
    want = jax_answers(envs, items)
    by_target = {}
    for (pid, _j, _t), r in zip(items, want):
        by_target.setdefault(pid, set()).add(r["allowed"])
    # every wasm target is addressed; the guard both admits and rejects
    assert set(WASM_TARGETS) <= set(by_target)
    assert by_target["guard"] == {True, False}
    assert any("patch" in r for r in want)
    assert any(r.get("status", {}).get("message") ==
               "mutation is not allowed inside of policy group" for r in want)


PATHS = ["validate", "native", "native_nocache", "hostpath", "split", "oracle"]


@pytest.mark.parametrize("path", PATHS)
def test_every_path_matches_the_jax_environment(envs, path):
    items = paired_items(seed=73)
    want = jax_answers(envs, items)
    titems = [(p, t) for p, _j, t in items]
    env = envs["port"]
    if path == "validate":
        got = [env.validate(p, t) for p, t in titems]
    elif path == "native":
        env.reset_verdict_cache()
        got = env.validate_batch(titems)
    elif path == "native_nocache":
        got = envs["port_nocache"].validate_batch(titems)
    elif path == "hostpath":
        env.reset_verdict_cache()
        got = env.validate_batch(titems, prefer_host=True)
    elif path == "split":
        env.reset_verdict_cache()
        got = env.validate_batch_finish(env.validate_batch_begin(titems))
    else:
        got = envs["port_oracle"].validate_batch(titems)
    assert response_dicts(got) == want


def test_replay_reruns_wasm_and_dispatches_no_cached_ir_row(envs):
    """A replay of the same reviews: equal answers; every wasm evaluation
    runs again (engine instances rise by the first pass's count); only
    the rows carrying wasm bits are dispatched again, the IR rows come
    from the verdict cache."""
    native_exec = mod(PORT, "wasm.native_exec")
    env = envs["port"]
    env.reset_verdict_cache()
    items = paired_items(seed=79)
    titems = [(p, t) for p, _j, t in items]
    want = jax_answers(envs, items)

    def run():
        c0 = sum(native_exec.engine_counts().values())
        rows0 = env.host_profile["dispatched_rows"]
        got = response_dicts(env.validate_batch(titems))
        return (got, sum(native_exec.engine_counts().values()) - c0,
                env.host_profile["dispatched_rows"] - rows0)

    first, inst1, rows1 = run()
    second, inst2, rows2 = run()
    assert first == second == want
    assert inst1 == inst2 > 0
    # the rows of groups with a wasm member (referenced or not) carry bits
    n_bits = sum(1 for p, _ in titems if p in env._groups_with_wasm)
    assert env._groups_with_wasm == {"guard", "g-unref", "g-mut"}
    assert rows2 == n_bits < rows1
    # no wasm-involving target entered either cache tier
    cached = {k[0] for tier in (env._verdict_cache, env._blob_cache)
              for k in tier._data}
    assert cached and not cached & {
        ("g", "guard"), ("g", "g-mut"), ("p", "wasm-priv"), ("p", "opa-gk"),
        ("p", "wasi-priv"), ("p", "mut-alone"), ("p", "cel-host"),
    }


def test_device_combine_reads_the_wasm_bits(envs):
    """The group verdicts and member-evaluated masks the device step
    computes from the wasm bits equal the host oracle's, for both groups
    with wasm members; the bits ride behind the rows."""
    env = envs["port"]
    jside, tside = audit_sides()
    for doc in review_docs()[:8]:
        treq = mod(PORT, "models").ValidateRequest.from_admission(
            mod(PORT, "models").AdmissionReviewRequest.from_dict(doc).request
        )
        payload = treq.payload()
        for name in ("guard", "g-unref"):
            target = env._fast_target(name)
            _idx, enc = env.encode_bucketed(payload)
            schema = env.schemas[_idx]
            batch = schema.pack(schema.stack([enc], batch_size=1))
            info = env._eval_wasm_members(target, payload)
            stash = env._add_wasm_bits(batch, 1, [(0, info)] if info else None)
            assert batch["__wasm_bits__"].shape == (1, len(env._wasm_member_order))
            dev = env.run_batch(batch)
            want = env._oracle_outputs(payload, target)
            for key in [f"g:{name}:allowed"] + [
                f"g:{name}:eval:{m}" for m in target.members
            ]:
                assert bool(dev[key][0]) == bool(want[key]), (name, key)
            for key, vals in stash.items():
                assert vals[0] == want[key]


def test_standalone_wasm_rows_never_reach_the_device(envs):
    env = envs["port_nocache"]
    rows0 = env.host_profile["dispatched_rows"]
    items = [(p, t) for p, _j, t in paired_items(seed=83)
             if p in ("wasm-priv", "opa-gk", "wasi-priv", "mut-alone", "cel-host")]
    env.validate_batch(items)
    assert env.host_profile["dispatched_rows"] == rows0


def test_through_the_micro_batcher(envs):
    """The mixed set through the port's batcher on the device path (host
    fast path off) equals the JAX environment's answers."""
    from policy_server_tpu_torch.api.service import RequestOrigin
    from policy_server_tpu_torch.runtime.batcher import MicroBatcher
    from policy_server_tpu_torch.telemetry import metrics as metrics_mod

    metrics_mod.reset_metrics_for_tests()
    items = paired_items(seed=89)
    want = jax_answers(envs, items)
    b = MicroBatcher(
        envs["port_nocache"], host_fastpath_threshold=0, max_batch_size=8,
        batch_timeout_ms=5.0,
    ).start()
    try:
        futs = [b.submit(p, t, RequestOrigin.VALIDATE) for p, _j, t in items]
        got = response_dicts([f.result(timeout=30) for f in futs])
    finally:
        b.shutdown()
        metrics_mod.reset_metrics_for_tests()
    assert got == want


def test_group_member_ids_and_cacheability(envs):
    env = envs["port"]
    jenv = envs["jax"]
    assert env._wasm_member_order == jenv._wasm_member_order
    assert env._groups_with_wasm == jenv._groups_with_wasm
    assert env.policy_ids() == jenv.policy_ids()
    for pid in env.policy_ids():
        t, j = env._fast_target(pid), jenv._fast_target(pid)
        assert env._cacheable(t) == jenv._cacheable(j), pid
        assert env._frag_eligible(t) == jenv._frag_eligible(j), pid
        assert env._host_executed(t) == jenv._host_executed(j), pid


def test_warmup_ships_the_bits(envs):
    env = envs["port_nocache"]
    seen = []
    orig = env._enqueue_open

    def spy(buf, wasm_bits=None):
        seen.append(None if wasm_bits is None else np.asarray(wasm_bits).shape)
        return orig(buf, wasm_bits)

    env._enqueue_open = spy
    try:
        env.warmup((1, 4))
    finally:
        del env._enqueue_open
    n_wasm = len(env._wasm_member_order)
    assert n_wasm == 3 and seen == [(1, n_wasm), (4, n_wasm)] * len(env.schemas)


def test_non_builtin_module_without_resolver_raises():
    from policy_server_tpu_torch.evaluation.errors import BootstrapFailure

    with pytest.raises(BootstrapFailure, match="no fetcher was configured"):
        torch_env({"w": {"module": "file:///priv.wasm"}})
    env = torch_env({"w": {"module": "file:///priv.wasm"}, "ns": NS},
                    continue_on_errors=True)
    jenv = jax_env({"w": {"module": "file:///priv.wasm"}, "ns": NS},
                   backend="oracle", continue_on_errors=True)
    # the port's text goes on to name the fetch path (--sources-path and
    # fetch.make_module_resolver); up to there it is the JAX package's
    prefix = "module 'file:///priv.wasm' is not a builtin and no fetcher was configured"
    assert set(env._init_errors) == set(jenv._init_errors) == {"w"}
    assert env._init_errors["w"].startswith(prefix)
    assert jenv._init_errors["w"].startswith(prefix)
    assert "--sources-path" in env._init_errors["w"]


def test_audit_sweep_over_host_executed_targets(tmp_path):
    """A full audit sweep over the mixed set (wasm, host CEL and the
    wasm group among IR policies) gives the JAX package's report rows,
    summary and lane counters."""
    from test_torch_audit import lane_keys, make_scanner, scanner_view
    from torch_port_support import side_request

    docs = [d for d in review_docs()[:10]]

    def case(side):
        pkg = JAX if side.name == "jax" else PORT
        env = side.env(SPECS, module_resolver=resolver_for(pkg, tmp_path))
        batcher = side.Batcher(env, max_batch_size=16, policy_timeout=30.0).start()
        scanner = make_scanner(side, env, batcher, batch_size=32)
        try:
            scanner.snapshot.observe([side_request(side, d) for d in docs])
            n = scanner.sweep(full=True)
            return n, scanner_view(scanner), lane_keys(batcher)
        finally:
            batcher.shutdown()
            env.close()

    jside, tside = audit_sides()
    want = case(jside)
    got = case(tside)
    assert got == want
    n, view, _lane = got
    assert n == view["reports"]["summary"]["resources"] * len(SPECS)
    rows = {(r["name"], r["policy_id"]): r for r in view["reports"]["reports"]}
    assert any(not r["allowed"] for (_n, pid), r in rows.items() if pid == "wasm-priv")
    assert any(r["allowed"] for (_n, pid), r in rows.items() if pid == "guard")
