"""The whole slice on the CPU: the port's ``validate_batch`` against the JAX
environment with ``kernel="pallas"`` (every bucket armed, interpret mode)
and against the host oracle, on flagship firehose and catalog items —
response dicts equal, mutation patches included — plus the state carry-
over, the oracle fallback, and the guards (no JAX import, no silent CPU
fallback). Tolerance: exact equality."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from policy_server_tpu.models import ValidateRequest as JValidateRequest
from policy_server_tpu_torch.evaluation.environment import (
    EvaluationEnvironmentBuilder,
)
from policy_server_tpu_torch.models import ValidateRequest
from policy_server_tpu_torch.policies.flagship import flagship_policies

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pallas_env(specs):
    env = jax_env(specs, kernel="pallas", verdict_cache_size=0)
    env._pallas_armed.update(range(len(env.schemas)))
    env._pallas_interpret = True
    return env


@pytest.mark.parametrize("which", ["flagship", "catalog"])
def test_validate_batch_matches_pallas_env_and_oracle(which):
    specs = flagship_specs() if which == "flagship" else catalog_specs()
    docs = (
        firehose_docs(24, seed=61) if which == "flagship"
        else catalog_docs(16, seed=62)
    )
    jenv = _pallas_env(specs)
    tenv = torch_env(specs)
    toracle = torch_env(specs, backend="oracle")
    ids = tenv.policy_ids()
    assert ids == jenv.policy_ids()
    items = items_for(docs, ids, seed=63)
    got = response_dicts(tenv.validate_batch([(p, t) for p, _j, t in items]))
    want = response_dicts(jenv.validate_batch([(p, j) for p, j, _t in items]))
    assert jenv.pallas_stats["dispatches"] > 0
    assert got == want
    assert response_dicts(
        toracle.validate_batch([(p, t) for p, _j, t in items])
    ) == want
    assert sum(1 for r in got if not r["allowed"]) > 0
    if which == "catalog":
        assert any("patch" in r for r in got)


def test_optimizer_off_matches_oracle():
    specs = catalog_specs()
    docs = catalog_docs(16, seed=64)
    tenv = torch_env(specs, predicate_opt=False)
    toracle = torch_env(specs, backend="oracle")
    items = [(p, t) for p, _j, t in items_for(docs, tenv.policy_ids(), seed=65)]
    assert response_dicts(tenv.validate_batch(items)) == response_dicts(
        toracle.validate_batch(items)
    )


def test_raw_mutation_patch_matches_jax():
    specs = {"raw-mutation": {"module": "builtin://raw-mutation",
                              "allowedToMutate": True}}
    raw = {"uid": "raw-1", "operation": "create", "resource": {"replicas": 2}}
    jenv = jax_env(specs)
    tenv = torch_env(specs)
    want = jenv.validate("raw-mutation", JValidateRequest.from_raw(dict(raw)))
    got = tenv.validate("raw-mutation", ValidateRequest.from_raw(dict(raw)))
    assert got.patch is not None
    assert got.to_dict() == want.to_dict()


def test_jax_encoded_buffer_runs_unchanged():
    """After the JAX state is installed, a packed buffer the JAX package
    encoded evaluates through the port to the JAX program's outputs."""
    specs = flagship_specs()
    docs = firehose_docs(16, seed=66)
    jenv = jax_env(specs, columnar=False, verdict_cache_size=0)
    tenv = torch_env(specs)
    sync_envs(jenv, tenv, docs)
    for idx, wide in packed_batches(jenv, docs, 8).items():
        want = jenv.run_batch({"__packed__": wide})
        got = tenv.run_batch({"__packed__": wide})
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), key)


def test_state_install_round_trip():
    tenv = torch_env(flagship_specs())
    jenv = jax_env(flagship_specs())
    sync_envs(jenv, tenv, firehose_docs(4, seed=67))
    assert list(tenv.table.strings()) == list(jenv.table.strings())
    assert export_state(tenv) == export_state(jenv)


def test_schema_overflow_falls_back_to_the_oracle():
    specs = {"priv": {"module": "builtin://pod-privileged"}}
    doc = firehose_docs(1, seed=68, wide_every=0)[0]
    pod = doc["request"]["object"]["spec"]
    pod["containers"] = [
        {"name": f"c{i}", "image": "nginx",
         "securityContext": {"privileged": i == 70}}
        for i in range(80)
    ]
    jenv = jax_env(specs)
    tenv = torch_env(specs)
    (pid, j, t), = items_for([doc], ["priv"], seed=0)
    got = tenv.validate_batch([(pid, t)])[0]
    want = jenv.validate_batch([(pid, j)])[0]
    assert tenv.oracle_fallbacks == 1
    assert got.to_dict() == want.to_dict()
    assert got.allowed is False


def test_unknown_policy_is_a_per_item_error():
    tenv = torch_env(flagship_specs())
    (_p, _j, t), = items_for(firehose_docs(1, seed=69), ["x"], seed=0)
    out = tenv.validate_batch([("no-such-policy", t), ("pod-privileged", t)])
    assert type(out[0]).__name__ == "PolicyNotFoundError"
    assert not isinstance(out[1], Exception)


_NOT_ON_THE_CARD = ("jax", "jaxlib", "policy_server_tpu", "prometheus_client",
                    "aiohttp", "yaml", "requests")


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of the port, nor ``chip_smoke.py``, nor the port's wasm
    and fetch fixtures (``tests/torch_wasm_fixtures.py``,
    ``tests/torch_fetch_fixtures.py``), imports JAX, the JAX
    package, or what the card's machine lacks or does not promise
    (prometheus_client, aiohttp, PyYAML, requests): imported in a fresh interpreter, with the native
    wasm core built and a fixture assembled and run on it, and
    ``chip_smoke.py``'s import statements read from its source, lazy ones
    included."""
    code = textwrap.dedent(
        f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, "tests")
        import policy_server_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        import policy_server_tpu_torch.__main__
        import chip_smoke
        import torch_fetch_fixtures
        import torch_wasm_fixtures
        from policy_server_tpu_torch.wasm import native_exec, wapc
        native_exec.build_library()
        out = wapc.KubewardenWapcPolicy(
            torch_wasm_fixtures.wapc_privileged_wasm()
        ).validate({{"object": {{}}}}, {{}})
        assert out == {{"accepted": True}}, out
        assert native_exec.engine_counts()["native"] == 1
        policy_server_tpu_torch.__main__.long_version()
        bad = sorted(
            n for n in sys.modules
            if n.split(".")[0] in {_NOT_ON_THE_CARD!r}
        )
        print(len(list(pkgutil.walk_packages(pkg.__path__))), bad)
        assert not bad, bad
        serving = [
            "policy_server_tpu_torch.ops.fastenc",
            "policy_server_tpu_torch.evaluation.verdict_cache",
            "policy_server_tpu_torch.resilience",
            "policy_server_tpu_torch.failpoints",
            "policy_server_tpu_torch.runtime.workers",
            "policy_server_tpu_torch.telemetry.metrics",
            "policy_server_tpu_torch.telemetry.tracing",
            "policy_server_tpu_torch.telemetry.flightrec",
            "policy_server_tpu_torch.api.profiling",
            "policy_server_tpu_torch.api.state",
            "policy_server_tpu_torch.api.api_error",
            "policy_server_tpu_torch.api.http_common",
            "policy_server_tpu_torch.certs",
            "policy_server_tpu_torch.runtime.native_frontend",
            "policy_server_tpu_torch.runtime.frontend",
            "policy_server_tpu_torch.supervision",
            "policy_server_tpu_torch.lifecycle",
            "policy_server_tpu_torch.tenancy",
            "policy_server_tpu_torch.runtime.scheduler",
            "policy_server_tpu_torch.runtime.shards",
            "policy_server_tpu_torch.audit.snapshot",
            "policy_server_tpu_torch.audit.reports",
            "policy_server_tpu_torch.audit.matrix",
            "policy_server_tpu_torch.audit.scanner",
            "policy_server_tpu_torch.context",
            "policy_server_tpu_torch.wasm.binary",
            "policy_server_tpu_torch.wasm.interp",
            "policy_server_tpu_torch.wasm.wat",
            "policy_server_tpu_torch.wasm.native_exec",
            "policy_server_tpu_torch.wasm.wapc",
            "policy_server_tpu_torch.wasm.builtins",
            "policy_server_tpu_torch.wasm.opa",
            "policy_server_tpu_torch.wasm.wasi",
            "policy_server_tpu_torch.wasm.capabilities",
            "policy_server_tpu_torch.evaluation.wasm_policy",
            "policy_server_tpu_torch.ops.serde",
            "policy_server_tpu_torch.fetch.artifact",
            "policy_server_tpu_torch.policies.wasm_oracle",
            "policy_server_tpu_torch.cel.parser",
            "policy_server_tpu_torch.cel.interp",
            "policy_server_tpu_torch.cel.lower",
            "policy_server_tpu_torch.cel.policy",
            "policy_server_tpu_torch.httpclient",
            "policy_server_tpu_torch.config.sources",
            "policy_server_tpu_torch.config.verification",
            "policy_server_tpu_torch.fetch.downloader",
            "policy_server_tpu_torch.fetch.verify",
            "policy_server_tpu_torch.fetch.keyless",
            "policy_server_tpu_torch.context.service",
            "policy_server_tpu_torch.audit.watch_feed",
        ]
        assert all(n in sys.modules for n in serving), serving
        print(bad)
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("[]")
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    imported = {
        alias.name for node in ast.walk(tree)
        if isinstance(node, ast.Import) for alias in node.names
    } | {
        node.module for node in ast.walk(tree)
        if isinstance(node, ast.ImportFrom) and node.module
    }
    assert "policy_server_tpu_torch.server" in imported
    assert "policy_server_tpu_torch.runtime.shards" in imported
    assert not {n for n in imported if n.split(".")[0] in _NOT_ON_THE_CARD}


def test_prefork_worker_imports_no_torch_jax_or_what_the_card_lacks():
    """A prefork worker never touches the card and boots in milliseconds:
    its module, with the native frontend it owns under ``--frontend
    native`` and the TLS module, imports neither torch nor JAX, the JAX
    package, aiohttp or PyYAML, in a fresh interpreter."""
    code = textwrap.dedent(
        """
        import sys
        import policy_server_tpu_torch.runtime.frontend as fr
        import policy_server_tpu_torch.runtime.native_frontend
        import policy_server_tpu_torch.certs
        assert callable(fr.main)
        bad = sorted(
            n for n in sys.modules
            if n.split(".")[0] in ("torch", "jax", "jaxlib",
                                   "policy_server_tpu", "aiohttp", "yaml")
        )
        print(bad)
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "[]"


def test_native_frontend_builds_the_ports_source_only(tmp_path, monkeypatch):
    """The native frontend's g++ build reads the port's copy,
    ``policy_server_tpu_torch/csrc/httpfront.cpp``, and never the JAX
    package's ``csrc/``; it builds into ``build/torch_kernels/``."""
    from policy_server_tpu_torch.runtime import native_frontend as nf

    port_source = os.path.join(
        REPO, "policy_server_tpu_torch", "csrc", "httpfront.cpp"
    )
    assert os.path.samefile(nf.SOURCE, port_source)
    assert nf.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")
    commands = []
    real_run = subprocess.run

    def recording_run(cmd, *args, **kwargs):
        commands.append(list(cmd))
        return real_run(cmd, *args, **kwargs)

    monkeypatch.setattr(nf.subprocess, "run", recording_run)
    monkeypatch.setattr(nf, "BUILD_DIR", tmp_path / "build" / "torch_kernels")
    monkeypatch.setattr(nf, "_library", None)
    lib = nf.build_library()
    assert lib.build_seconds > 0 and lib.path.parent == nf.BUILD_DIR
    (cmd,) = commands
    sources = [a for a in cmd if a.endswith((".cpp", ".cc", ".c"))]
    assert sources == [str(nf.SOURCE)]
    root_csrc = os.path.join(REPO, "csrc")
    assert not any(a.startswith(root_csrc + os.sep) for a in cmd)
    assert "-ldl" in cmd and "-pthread" in cmd


def test_native_wasm_core_builds_the_ports_source_only(tmp_path, monkeypatch):
    """The native wasm core's g++ build reads the port's copy,
    ``policy_server_tpu_torch/csrc/wasmint.cpp``, never the repository
    root's ``csrc/``, and builds into ``build/torch_kernels/``."""
    from policy_server_tpu_torch.wasm import native_exec

    port_source = os.path.join(
        REPO, "policy_server_tpu_torch", "csrc", "wasmint.cpp"
    )
    assert os.path.samefile(native_exec.SOURCE, port_source)
    assert native_exec.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")
    commands = []
    real_run = subprocess.run

    def recording_run(cmd, *args, **kwargs):
        commands.append(list(cmd))
        return real_run(cmd, *args, **kwargs)

    monkeypatch.setattr(native_exec.subprocess, "run", recording_run)
    monkeypatch.setattr(native_exec, "BUILD_DIR", tmp_path / "build" / "torch_kernels")
    monkeypatch.setattr(native_exec, "_lib", None)
    native_exec.build_library()
    assert native_exec.build_seconds > 0
    assert native_exec.library_path().parent == native_exec.BUILD_DIR
    (cmd,) = commands
    sources = [a for a in cmd if a.endswith((".cpp", ".cc", ".c"))]
    assert sources == [str(native_exec.SOURCE)]
    root_csrc = os.path.join(REPO, "csrc")
    assert not any(a.startswith(root_csrc + os.sep) for a in cmd)


def test_builder_without_a_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EvaluationEnvironmentBuilder()
    with pytest.raises(RuntimeError):
        EvaluationEnvironmentBuilder(device="cuda")
    # an explicit CPU request and the oracle backend need no card
    env = EvaluationEnvironmentBuilder(device="cpu").build(flagship_policies())
    assert env.device == torch.device("cpu")
    EvaluationEnvironmentBuilder(backend="oracle")


def _close_env_and_pairs():
    from policy_server_tpu_torch.models import AdmissionReviewRequest

    specs = {"pod-privileged": {"module": "builtin://pod-privileged"}}
    tenv = torch_env(specs, verdict_cache_size=0)
    pairs = [
        ("pod-privileged", ValidateRequest.from_admission(
            AdmissionReviewRequest.from_dict(d).request
        ))
        for d in firehose_docs(6, 51, wide_every=0)
    ]
    return specs, tenv, pairs


def test_dispatch_after_close_raises_as_the_jax_package():
    """After close() every dispatch raises RuntimeError("environment
    closed"), the JAX environment's error; the kernel programs are
    dropped; close is idempotent."""
    specs, tenv, pairs = _close_env_and_pairs()
    jenv = jax_env(specs)
    jenv.close()
    with pytest.raises(RuntimeError) as jerr:
        jenv.validate_batch([("pod-privileged", JValidateRequest.from_admission(
            __import__("policy_server_tpu.models", fromlist=["x"])
            .AdmissionReviewRequest.from_dict(firehose_docs(1, 51)[0]).request
        ))])
    want = tenv.validate_batch(pairs)
    buf = tenv.schemas[0].empty_batch_packed(1)
    assert tenv._programs and tenv.close() is True
    assert tenv._closed and tenv._programs == {}
    for call in (
        lambda: tenv.validate_batch(pairs),
        lambda: tenv.validate_batch(pairs, prefer_host=True),
        lambda: tenv.validate_batch_begin(pairs),
        lambda: tenv.run_batch(buf),
        lambda: tenv.warmup((1,)),
    ):
        with pytest.raises(RuntimeError) as err:
            call()
        assert str(err.value) == str(jerr.value) == "environment closed"
    assert tenv.close() is True
    assert not isinstance(want[0], Exception)


def test_close_waits_for_an_in_flight_step():
    """A dispatch held in its fetch keeps close() waiting; once it
    finishes, close returns and the dispatch's answers are whole. A close
    bounded shorter than the hold refuses to drop the device state."""
    import threading

    from policy_server_tpu_torch import failpoints

    _specs, tenv, pairs = _close_env_and_pairs()
    want = [r.to_dict() for r in tenv.validate_batch(pairs)]
    release = threading.Event()
    failpoints.set_failpoint("device.fetch", lambda: release.wait(10))
    try:
        box: dict = {}
        worker = threading.Thread(
            target=lambda: box.setdefault("got", tenv.validate_batch(pairs))
        )
        worker.start()
        deadline = time.monotonic() + 10
        while failpoints.fired_count("device.fetch") < 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert tenv.close(timeout=0.2) is False  # held: nothing dropped
        assert tenv._programs
        _s, tenv2, _p = _close_env_and_pairs()
        worker2 = threading.Thread(
            target=lambda: box.setdefault("got2", tenv2.validate_batch(pairs))
        )
        worker2.start()
        while failpoints.fired_count("device.fetch") < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        closer = threading.Thread(
            target=lambda: box.setdefault("closed", tenv2.close(timeout=10))
        )
        closer.start()
        time.sleep(0.3)
        assert closer.is_alive() and "closed" not in box
        release.set()
        for t in (worker, worker2, closer):
            t.join(10)
        assert box["closed"] is True and tenv2._programs == {}
        assert [r.to_dict() for r in box["got2"]] == want
        assert [r.to_dict() for r in box["got"]] == want
    finally:
        release.set()
        failpoints.reset()
