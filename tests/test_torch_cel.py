"""The port's CEL policy against the JAX package's: the parse of every
corpus expression of ``tests/test_wasi_cel.py``, the lowered predicate IR
(equal as ``ops/serde.py`` JSON), the host interpreter's values, the
lowered programs through K1's plain version and its tape against
``policy_matrix_program(interpret=True)``, the served responses, and the
resolution of ``builtin://cel-policy`` and its upstream reference."""

from __future__ import annotations

import copy
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from policy_server_tpu.ops import serde as jserde
from policy_server_tpu_torch.ops import cuda_kernels as ck
from policy_server_tpu_torch.ops import serde as tserde

from test_torch_kernels import _paired, _pallas, run_tape
from torch_port_support import (
    FORM_FLAGS,
    buffer_forms,
    firehose_docs,
    items_for,
    jax_env,
    packed_batches,
    response_dicts,
    torch_env,
)

JAX = "policy_server_tpu"
PORT = "policy_server_tpu_torch"


def mod(side: str, name: str):
    return importlib.import_module(f"{side}.{name}")


# the expressions of tests/test_wasi_cel.py, and the phase-12 set's
LOWERED = [
    "object.spec.containers.all(c, !(c.securityContext.privileged == true))",
    "request.operation in ['CREATE', 'UPDATE']",
    "has(object.spec.replicas)",
    "object.metadata.name.startsWith('p')",
    "object.metadata.name.matches('^[a-z]+$')",
    "'NET_ADMIN' in object.spec.containers",
    "object.spec.containers.exists(c, c.image.contains('nginx'))",
    "object.spec.containers.exists_one(c, c.image.startsWith('docker.io/'))",
    "object.spec.replicas <= 5",
    "!(request.operation == 'DELETE')",
]
HOST = [
    "size(object.spec.containers) <= 2",
    "object.spec.replicas * 2 <= 10",
    "'replicas ' + string(object.spec.replicas) + ' over limit'",
    "object.spec.replicas == object.spec.minReplicas",
    "size(object.metadata.name) > 3",
    "object.spec.replicas in params.allowed",
    "object.spec.replicas > 3 ? object.spec.replicas <= 10 : true",
    "x ? 1 : 2",
]
BAD = ["object.spec.", "", "object.spec.("]

# settings of the policies the tests serve (phase 12's CEL policies too)
CEL_SPECS = {
    "cel-device": {"validations": [
        {"expression": LOWERED[0], "message": "privileged containers are not allowed"},
        {"expression": LOWERED[1], "message": "only create/update supported"},
    ]},
    "cel-lowered": {
        "variables": [{"name": "cs", "expression": "object.spec.containers"}],
        "validations": [
            {"expression": "object.spec.replicas <= 5", "message": "too many replicas"},
            {"expression": "variables.cs.all(c, c.image.startsWith('docker.io/'))",
             "message": "images must come from docker.io"},
            {"expression": "variables.cs.exists_one(c, c.name == 'c')",
             "message": "exactly one container named c"},
        ],
    },
    "cel-host": {"validations": [{
        "expression": "object.spec.replicas * 2 <= 10",
        "message": "too many replicas",
        "messageExpression": "'replicas ' + string(object.spec.replicas) + ' over limit'",
    }]},
    "cel-ternary": {"validations": [{
        "expression": "has(object.spec.replicas) ? object.spec.replicas <= 3 : true",
        "message": "replicas over 3",
    }]},
    "cel-in-mismatch": {"allowed": "1,2,3", "validations": [
        {"expression": "object.spec.replicas in params.allowed"},
    ]},
    **{
        f"cel-x{i}": {"validations": [{"expression": e, "message": f"failed {i}"}]}
        for i, e in enumerate(LOWERED[2:])
    },
}


def cel_spec(name: str) -> dict:
    return {"module": "builtin://cel-policy", "settings": CEL_SPECS[name]}


def tree(node):
    """A parse tree as plain data (each package has its own classes)."""
    if dataclasses.is_dataclass(node):
        return (type(node).__name__,) + tuple(
            tree(getattr(node, f.name)) for f in dataclasses.fields(node)
        )
    if isinstance(node, (list, tuple)):
        return [tree(n) for n in node]
    return node


def parsed(side: str, src: str):
    parser = mod(side, "cel.parser")
    try:
        return tree(parser.parse(src))
    except parser.CelParseError as e:
        return ("CelParseError", str(e))


@pytest.mark.parametrize("src", LOWERED + HOST + BAD)
def test_parse_matches_jax(src):
    want = parsed(JAX, src)
    assert parsed(PORT, src) == want
    assert (want[0] == "CelParseError") == (src in BAD)


def lowered_json(side: str, settings: dict):
    """Each rule's condition as serde JSON, or the host fallback."""
    program = mod(side, "cel.policy").CelPolicy().build(settings)
    if program.host_evaluator is not None:
        return "host"
    to_json = (jserde if side == JAX else tserde).expr_to_json
    return [(r.name, to_json(r.condition)) for r in program.rules]


@pytest.mark.parametrize("name", sorted(CEL_SPECS))
def test_lowered_ir_matches_jax(name):
    """The lowered IR of each policy, equal as ``ops/serde.py`` JSON (or
    both packages take the host interpreter)."""
    want = lowered_json(JAX, CEL_SPECS[name])
    got = lowered_json(PORT, CEL_SPECS[name])
    assert got == want
    assert (got == "host") == (name in ("cel-host", "cel-ternary", "cel-in-mismatch"))


def test_serde_round_trip_matches_jax():
    """The port's serde reads back what it writes, into the same JSON the
    JAX package's reads back."""
    for name in sorted(CEL_SPECS):
        got = lowered_json(PORT, CEL_SPECS[name])
        if got == "host":
            continue
        for _rule, doc in got:
            back = tserde.expr_to_json(tserde.expr_from_json(doc, {}))
            assert back == jserde.expr_to_json(jserde.expr_from_json(doc, {}))
            assert back == doc


def bindings_docs() -> list[dict]:
    docs = []
    for d in firehose_docs(12, seed=23):
        req = copy.deepcopy(d["request"])
        req.setdefault("operation", "CREATE")
        docs.append(req)
    for k, req in enumerate(docs):
        for c in (req.get("object") or {}).get("spec", {}).get("containers", []):
            c.setdefault("securityContext", {}).setdefault("privileged", k % 4 == 0)
    docs[0].setdefault("object", {}).setdefault("spec", {})["replicas"] = 4
    docs[1].setdefault("object", {}).setdefault("spec", {})["replicas"] = 9
    docs[1]["object"]["spec"]["minReplicas"] = 9
    return docs


def values(side: str, src: str) -> list:
    parser = mod(side, "cel.parser")
    interp = mod(side, "cel.interp")
    ast = parser.parse(src)
    out = []
    for req in bindings_docs():
        bindings = {"object": req.get("object"), "request": req,
                    "params": {"allowed": "1,2,3"}, "x": True}
        try:
            out.append(("ok", interp.evaluate(ast, bindings)))
        except interp.CelEvalError as e:
            out.append(("CelEvalError", str(e)))
    return out


@pytest.mark.parametrize("src", LOWERED + HOST)
def test_interpreter_values_match_jax(src):
    want = values(JAX, src)
    assert values(PORT, src) == want
    # a string right of 'in' with a number left is a CEL error on every doc
    assert any(v[0] == "ok" for v in want) != ("params.allowed" in src)


# -- the lowered programs through K1 ------------------------------------------

K1_CASES = [(opt, idx, form) for opt in (True, False) for idx in (0, 1)
            for form in ("wide", "transport", "narrow")]


@pytest.fixture(scope="module")
def cel_pairs():
    docs = firehose_docs(128, seed=31)
    specs = {name: cel_spec(name) for name in CEL_SPECS}
    out = {}
    for opt in (True, False):
        jenv, tenv = _paired(specs, docs, predicate_opt=opt)
        out[opt] = (jenv, tenv, packed_batches(jenv, docs, 64))
    return out


@pytest.mark.parametrize("opt,idx,form", K1_CASES)
def test_lowered_programs_through_k1_plain_and_tape(cel_pairs, opt, idx, form):
    """Every lowered CEL program of the set, in K1's plain version and
    its tape (numpy interpreter), against the Pallas kernel in interpret
    mode on the same packed bytes: the tape compiler accepts the
    quantifier programs (``all``, ``exists``, ``exists_one``) and splits
    them into parts without changing a verdict."""
    jenv, tenv, batches = cel_pairs[opt]
    buf = buffer_forms(jenv, idx, batches[idx])[form]
    want_a, want_r, want_cols = _pallas(jenv, idx, form, buf)
    program = tenv.program_for(idx, *FORM_FLAGS[form])
    assert program.column_of == want_cols
    got_a, got_r = ck.policy_matrix(torch.from_numpy(buf), program)
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    tape_a, tape_r = run_tape(program, buf)
    np.testing.assert_array_equal(tape_a, want_a)
    np.testing.assert_array_equal(tape_r, want_r)
    cols = [want_cols[p] for p in want_cols if p.startswith("cel-x")]
    assert not want_a[:, cols].all() and want_a[:, cols].any()


# -- served responses ------------------------------------------------------------


@pytest.fixture(scope="module")
def cel_envs():
    specs = {name: cel_spec(name) for name in CEL_SPECS}
    return (
        jax_env(specs, backend="oracle"),
        torch_env(specs),
        torch_env(specs, backend="oracle"),
    )


def review_docs() -> list[dict]:
    docs = firehose_docs(48, seed=37)
    for k, d in enumerate(docs):
        obj = d["request"].setdefault("object", {})
        if k % 3 == 0:
            obj.setdefault("spec", {})["replicas"] = k % 11
    return docs


@pytest.mark.parametrize("path", ["native", "hostpath", "oracle", "validate"])
def test_cel_responses_match_jax(cel_envs, path):
    """Every CEL policy's answers (device-lowered and host-interpreted)
    through each of the port's paths equal the JAX package's."""
    jenv, tenv, toracle = cel_envs
    items = items_for(review_docs(), sorted(CEL_SPECS), seed=43)
    want = response_dicts(jenv.validate_batch([(p, j) for p, j, _t in items]))
    titems = [(p, t) for p, _j, t in items]
    if path == "native":
        got = tenv.validate_batch(titems)
    elif path == "hostpath":
        got = tenv.validate_batch(titems, prefer_host=True)
    elif path == "oracle":
        got = toracle.validate_batch(titems)
    else:
        got = [tenv.validate(p, t) for p, t in titems]
    assert response_dicts(got) == want
    assert any(not r["allowed"] for r in want) and any(r["allowed"] for r in want)


@pytest.mark.parametrize("url", [
    "builtin://cel-policy",
    "registry://ghcr.io/kubewarden/policies/cel-policy:v1.0.0",
    "ghcr.io/kubewarden/policies/cel-policy@sha256:" + "0" * 64,
])
def test_cel_policy_urls_resolve(url):
    jmod = mod(JAX, "policies").resolve_builtin(url)
    tmod = mod(PORT, "policies").resolve_builtin(url)
    assert jmod is not None and tmod is not None
    assert tmod.name == jmod.name == "cel-policy"
    assert type(tmod).__module__ == "policy_server_tpu_torch.cel.policy"


@pytest.mark.parametrize("settings", [
    {}, {"validations": []}, {"validations": [{"expression": "object.spec.("}]},
    CEL_SPECS["cel-device"], CEL_SPECS["cel-host"],
])
def test_cel_settings_validation_matches_jax(settings):
    want = mod(JAX, "cel.policy").CelPolicy().validate_settings(settings)
    got = mod(PORT, "cel.policy").CelPolicy().validate_settings(settings)
    assert (got.valid, got.message) == (want.valid, want.message)
