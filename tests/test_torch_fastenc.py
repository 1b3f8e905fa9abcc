"""The port's native encoder (``policy_server_tpu_torch/ops/fastenc.py`` over
``policy_server_tpu_torch/csrc/fastenc.cpp``) on the CPU:

* against the JAX package's native encoder, on the same blobs from one
  intern table: identical packed bytes, identical status vectors (the
  overflow cascade into the large bucket and past it), identical intern
  tables afterwards;
* against the port's own Python trie (``FeatureSchema.encode``, the
  encoder's plain version) on every feature array;
* a failed g++ build raises with g++'s output, and an environment whose
  encoder cannot be built does not fall back to the trie.

Tolerance: exact equality."""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest

from policy_server_tpu_torch.evaluation.environment import (
    EvaluationEnvironmentBuilder,
)
from policy_server_tpu_torch.models import AdmissionReviewRequest
from policy_server_tpu_torch.ops import fastenc
from policy_server_tpu_torch.ops.codec import SchemaOverflow
from policy_server_tpu_torch.policies.flagship import flagship_policies

from torch_port_support import (
    firehose_docs,
    flagship_specs,
    items_for,
    jax_env,
    response_dicts,
    sync_envs,
    torch_env,
)


def _payload(doc: dict) -> dict:
    return AdmissionReviewRequest.from_dict(copy.deepcopy(doc)).request.to_dict()


def _blob(doc: dict) -> bytes:
    return json.dumps(_payload(doc), separators=(",", ":")).encode()


def _torture_docs() -> list[dict]:
    """Unicode and escapes, wrong-typed leaves, and an overflow of every
    bucket."""
    base = firehose_docs(3, seed=81, wide_every=0)
    uni = copy.deepcopy(base[0])
    uni["request"]["object"]["metadata"]["labels"] = {
        "app": "café-☃️",
        'quote"key': "line1\nline2\tend \U0001f600",
        "backslash\\key": "nul ctrl",
    }
    uni["request"]["object"]["metadata"]["annotations"] = {
        "prod.example.com/debug": "true"
    }
    typed = copy.deepcopy(base[1])
    pod = typed["request"]["object"]
    pod["spec"]["containers"][0]["image"] = 42
    pod["spec"]["hostNetwork"] = "yes"
    pod["spec"]["containers"][0]["securityContext"] = {"privileged": "true"}
    pod["metadata"]["labels"] = None
    huge = copy.deepcopy(base[2])
    huge["request"]["object"]["spec"]["containers"] = [
        {"name": f"c{i}", "image": f"registry.example/img{i}:v{i}"}
        for i in range(80)
    ]
    return [uni, typed, huge]


CORPORA = {
    "firehose": lambda: firehose_docs(40, seed=82, wide_every=3),
    "torture": _torture_docs,
}


@pytest.fixture(scope="module")
def envs():
    specs = flagship_specs()
    jenv = jax_env(specs, verdict_cache_size=0)
    tenv = torch_env(specs, verdict_cache_size=0)
    assert jenv.native_encoding
    return jenv, tenv


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_native_matches_jax_native_encoder(envs, corpus):
    """Both native encoders, one intern table to start from, the same
    blobs through each bucket in turn (rows that fail a bucket go on to the
    next, as the serving path sends them): packed bytes, statuses and the
    tables afterwards are identical."""
    jenv, tenv = envs
    docs = CORPORA[corpus]()
    sync_envs(jenv, tenv, firehose_docs(8, seed=80))
    assert list(tenv.table.strings()) == list(jenv.table.strings())
    pending = [_blob(d) for d in docs]
    cascade = []
    for jschema, tschema in zip(jenv.schemas, tenv.schemas):
        if not pending:
            break
        want, want_status = jschema.native.encode_batch(
            pending, len(pending), jenv.table
        )
        got, got_status = tschema.native.encode_batch(
            pending, len(pending), tenv.table
        )
        np.testing.assert_array_equal(got_status, want_status)
        assert got["__packed__"].tobytes() == want["__packed__"].tobytes()
        cascade.append(int((got_status == 0).sum()))
        pending = [b for b, s in zip(pending, got_status) if s != 0]
    # one request at a time (the host path's row key), with images and
    # namespaces neither table has seen: the port scatters these few
    # records in plain Python, the JAX package with numpy
    solo = copy.deepcopy(docs[::-1])
    for k, d in enumerate(solo):
        d["request"]["namespace"] = f"solo-{k}"
        for c in d["request"]["object"]["spec"]["containers"]:
            c["image"] = f"solo.example/{k}/{c['image']}"
    before = len(tenv.table)
    for blob in [_blob(d) for d in solo]:
        for jschema, tschema in zip(jenv.schemas, tenv.schemas):
            want, want_status = jschema.native.encode_batch([blob], 1, jenv.table)
            got, got_status = tschema.native.encode_batch([blob], 1, tenv.table)
            np.testing.assert_array_equal(got_status, want_status)
            assert got["__packed__"].tobytes() == want["__packed__"].tobytes()
    assert len(tenv.table) > before
    assert list(tenv.table.strings()) == list(jenv.table.strings())
    if corpus == "torture":
        # the 80-container review passes no bucket
        assert len(pending) == 1
    else:
        assert cascade[0] > 0 and len(cascade) == 2 and cascade[1] > 0


def test_overflow_cascade_reaches_the_oracle_alike(envs):
    """End to end: rows past the widest bucket answer from the oracle in
    both packages, with equal responses and equal fallback counts."""
    jenv, tenv = envs
    docs = _torture_docs() + firehose_docs(6, seed=83, wide_every=2)
    items = items_for(docs, ["pod-privileged", "trusted-repos"], seed=84)
    j0, t0 = jenv.oracle_fallbacks, tenv.oracle_fallbacks
    want = response_dicts(jenv.validate_batch([(p, j) for p, j, _t in items]))
    got = response_dicts(tenv.validate_batch([(p, t) for p, _j, t in items]))
    assert got == want
    assert tenv.oracle_fallbacks - t0 == jenv.oracle_fallbacks - j0 == 1


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_native_matches_python_trie(corpus):
    """The port's native encoder against its own plain version, row by
    row (packed bytes, and a refusal where the trie overflows) in every
    bucket, then as one batch encode against the trie's packed rows (trie
    first, so both see the same ids)."""
    env = EvaluationEnvironmentBuilder(device="cpu", verdict_cache_size=0).build(
        flagship_policies()
    )
    docs = CORPORA[corpus]()
    compared = 0
    for schema in env.schemas:
        encs, blobs = [], []
        for d in docs:
            payload = _payload(d)
            try:
                py = schema.encode(payload, env.table)
            except SchemaOverflow:  # both must refuse the row
                _, status = schema.native.encode_batch([_blob(d)], 1, env.table)
                assert status[0] < 0
                continue
            nat, status = schema.native.encode_batch([_blob(d)], 1, env.table)
            assert status[0] == 0
            one = schema.pack(schema.stack([py], batch_size=1))
            np.testing.assert_array_equal(nat["__packed__"], one["__packed__"])
            encs.append(py)
            blobs.append(_blob(d))
            compared += 1
        if not encs:
            continue
        want = schema.pack(schema.stack(encs, batch_size=len(encs)))
        got, status = schema.native.encode_batch(blobs, len(blobs), env.table)
        assert (status == 0).all()
        assert got["__packed__"].tobytes() == want["__packed__"].tobytes()
    assert compared >= len(docs) - 1


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "fastenc.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(fastenc, "SOURCE", bad)
    monkeypatch.setattr(fastenc, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=r"g\+\+ failed") as err:
        fastenc.build_library(force=True)
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_no_trie_fallback_when_the_encoder_cannot_build(monkeypatch):
    def broken(force: bool = False):
        raise RuntimeError("g++ failed (1): stand-in")

    monkeypatch.setattr(fastenc, "build_library", broken)
    with pytest.raises(RuntimeError, match="stand-in"):
        EvaluationEnvironmentBuilder(device="cpu").build(flagship_policies())
    # the oracle backend needs no encoder
    EvaluationEnvironmentBuilder(backend="oracle").build(flagship_policies())


def test_serving_path_encodes_natively(monkeypatch):
    """validate_batch never calls the Python trie: every row goes through
    the native encoder (the trie is the tests' plain version only)."""
    env = torch_env(flagship_specs())

    def trie(*_a, **_k):
        raise AssertionError("the serving path reached the Python trie")

    for schema in env.schemas:
        monkeypatch.setattr(schema, "encode", trie)
    docs = firehose_docs(12, seed=85)
    items = items_for(docs, env.policy_ids(), seed=86)
    out = env.validate_batch([(p, t) for p, _j, t in items])
    assert not any(isinstance(r, Exception) for r in out)
    assert env.host_profile["encode_rows"] >= len(items)
