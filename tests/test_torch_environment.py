"""The whole slice on the CPU: the port's ``validate_batch`` against the JAX
environment with ``kernel="pallas"`` (every bucket armed, interpret mode)
and against the host oracle, on flagship firehose and catalog items —
response dicts equal, mutation patches included — plus the state carry-
over, the oracle fallback, and the guards (no JAX import, no silent CPU
fallback). Tolerance: exact equality."""

from __future__ import annotations

import subprocess
import sys
import textwrap

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


def test_port_imports_neither_jax_nor_the_jax_package():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import policy_server_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        import policy_server_tpu_torch.__main__
        bad = sorted(
            n for n in sys.modules
            if n == "jax" or n.startswith("jax.") or n == "jaxlib"
            or n == "policy_server_tpu" or n.startswith("policy_server_tpu.")
        )
        print(len(list(pkgutil.walk_packages(pkg.__path__))), bad)
        assert not bad, bad
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("[]")


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
