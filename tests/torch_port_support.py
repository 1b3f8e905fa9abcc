"""Shared fixtures of the PyTorch-port differential tests: the same inputs,
made from a seed, go through the JAX package and its PyTorch counterpart
(``policy_server_tpu_torch``), which runs here on the CPU through the
kernels' plain versions."""

from __future__ import annotations

import copy
import dataclasses
import random

import numpy as np

from policy_server_tpu.evaluation.environment import (
    EvaluationEnvironmentBuilder as JaxBuilder,
)
from policy_server_tpu.models import AdmissionReviewRequest, ValidateRequest
from policy_server_tpu.models.policy import parse_policy_entry
from policy_server_tpu.policies.flagship import (
    flagship_policy_specs,
    synthetic_firehose,
)
from policy_server_tpu_torch.evaluation.environment import (
    EvaluationEnvironmentBuilder as TorchBuilder,
)
from policy_server_tpu_torch.models import (
    AdmissionReviewRequest as TAdmissionReviewRequest,
)
from policy_server_tpu_torch.models import ValidateRequest as TValidateRequest
from policy_server_tpu_torch.models.policy import (
    parse_policy_entry as t_parse_policy_entry,
)

from test_predicate_opt import FAMILY_CATALOG, review_of


def jax_env(specs: dict, **kw):
    return JaxBuilder(backend=kw.pop("backend", "jax"), **kw).build(
        {k: parse_policy_entry(k, v) for k, v in specs.items()}
    )


def torch_env(specs: dict, **kw):
    kw.setdefault("device", "cpu")
    if kw.get("backend") == "oracle":
        kw.pop("device")
    return TorchBuilder(**kw).build(
        {k: t_parse_policy_entry(k, v) for k, v in specs.items()}
    )


def flagship_specs() -> dict:
    return flagship_policy_specs()


def catalog_specs() -> dict:
    return dict(FAMILY_CATALOG)


def widen(doc: dict, n_containers: int = 12) -> dict:
    """A copy of a firehose review whose arrays overflow the small schema
    bucket's caps (8 elements), so it encodes into the large bucket."""
    doc = copy.deepcopy(doc)
    pod = doc["request"]["object"]
    base = pod["spec"]["containers"]
    pod["spec"]["containers"] = [
        dict(base[i % len(base)], name=f"c{i}") for i in range(n_containers)
    ]
    return doc


def firehose_docs(n: int, seed: int, wide_every: int = 3) -> list[dict]:
    """Firehose reviews; every ``wide_every``-th one widened to the large
    bucket."""
    docs = synthetic_firehose(n, seed=seed)
    return [
        widen(d) if wide_every and i % wide_every == 0 else d
        for i, d in enumerate(docs)
    ]


def catalog_docs(n: int, seed: int) -> list[dict]:
    docs = firehose_docs(n, seed)
    extra_objs = [
        {"kind": "Pod", "apiVersion": "v1",
         "metadata": {"name": "lab", "labels": {"cost-center": "x"}},
         "spec": {}},
        {"kind": "Deployment", "apiVersion": "apps/v1",
         "metadata": {"name": "big"}, "spec": {"replicas": 9}},
        {"kind": "Pod", "apiVersion": "v1", "metadata": {"name": "sy"},
         "spec": {"securityContext": {
             "sysctls": [{"name": "kernel.msgmax", "value": "1"}]}}},
        {"kind": "Pod", "apiVersion": "v1", "metadata": {"name": "hp"},
         "spec": {"volumes": [{"name": "v",
                               "hostPath": {"path": "/etc/shadow"}}]}},
    ]
    return docs + [review_of(o) for o in extra_objs]


def items_for(docs: list[dict], policy_ids: list[str], seed: int):
    """(policy id, JAX request, torch request) triples: each doc addressed
    to a policy id drawn from a seeded generator."""
    rng = random.Random(seed)
    out = []
    for d in docs:
        pid = rng.choice(policy_ids)
        out.append((
            pid,
            ValidateRequest.from_admission(
                AdmissionReviewRequest.from_dict(copy.deepcopy(d)).request
            ),
            TValidateRequest.from_admission(
                TAdmissionReviewRequest.from_dict(copy.deepcopy(d)).request
            ),
        ))
    return out


def export_state(jenv) -> tuple[list[str], list[dict]]:
    """The JAX environment's intern table (strings in id order) and packed
    layouts, as plain data."""
    return (
        list(jenv.table.strings()),
        [dataclasses.asdict(s.packed_layout()) for s in jenv.schemas],
    )


def sync_envs(jenv, tenv, docs: list[dict]) -> None:
    """Give both environments one intern table: the JAX table first takes
    the torch table's strings (the string constants its tapes interned at
    build, in id order) and the documents' strings, then the torch
    environment installs the JAX state. No JAX program is traced."""
    for s in tenv.table.strings():
        jenv.table.intern(s)
    for d in docs:
        jenv.encode_bucketed(
            AdmissionReviewRequest.from_dict(copy.deepcopy(d)).request.to_dict()
        )
    strings, layouts = export_state(jenv)
    tenv.install_reference_state(strings, layouts)


def packed_batches(jenv, docs: list[dict], batch: int) -> dict[int, np.ndarray]:
    """schema index → the wide packed batch the JAX environment encodes
    for the docs that fall in that bucket (padded to ``batch`` rows; a
    bucket no doc reaches gets an all-missing batch)."""
    per: dict[int, list] = {i: [] for i in range(len(jenv.schemas))}
    for d in docs:
        payload = AdmissionReviewRequest.from_dict(
            copy.deepcopy(d)
        ).request.to_dict()
        idx, enc = jenv.encode_bucketed(payload)
        if len(per[idx]) < batch:
            per[idx].append(enc)
    out = {}
    for idx, encs in per.items():
        schema = jenv.schemas[idx]
        if encs:
            out[idx] = schema.pack(schema.stack(encs, batch_size=batch))[
                "__packed__"
            ]
        else:
            out[idx] = schema.empty_batch_packed(batch)["__packed__"]
    return out


def buffer_forms(jenv, idx: int, wide: np.ndarray) -> dict[str, np.ndarray]:
    """The three forms of one wide packed batch, as the JAX codec makes
    them."""
    schema = jenv.schemas[idx]
    key = "__packed__"
    return {
        "wide": wide,
        "transport": schema.to_transport({key: wide})[key],
        "narrow": schema.to_transport(
            {key: wide}, vocab_size=len(jenv.table)
        )[key],
    }


FORM_FLAGS = {
    "wide": (False, False),
    "transport": (True, False),
    "narrow": (True, True),
}


def response_dicts(results) -> list:
    return [
        r.to_dict() if not isinstance(r, Exception) else repr(r)
        for r in results
    ]
