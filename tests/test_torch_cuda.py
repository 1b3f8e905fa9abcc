"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports nothing of JAX, so it runs on a machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``.
Without a card every test here skips. Tolerance: exact equality (verdicts
are booleans and int32 rule indices; f32 values are only compared)."""

from __future__ import annotations

import copy
import dataclasses

import pytest
import torch

from policy_server_tpu_torch.evaluation.environment import (
    EvaluationEnvironmentBuilder,
)
from policy_server_tpu_torch.models import AdmissionReviewRequest
from policy_server_tpu_torch.ops import cuda_kernels as ck
from policy_server_tpu_torch.policies.flagship import (
    flagship_policies,
    synthetic_firehose,
)


@pytest.fixture(scope="module")
def card_env():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return EvaluationEnvironmentBuilder(device="cuda").build(flagship_policies())


def _batch(env, idx: int, n: int, narrow: bool):
    schema = env.schemas[idx]
    encs = []
    for doc in synthetic_firehose(n, seed=31 + idx):
        if idx == 1:
            doc = copy.deepcopy(doc)
            pod = doc["request"]["object"]["spec"]
            pod["containers"] = [
                dict(pod["containers"][i % len(pod["containers"])], name=f"c{i}")
                for i in range(12)
            ]
        payload = AdmissionReviewRequest.from_dict(doc).request.to_dict()
        got, enc = env.encode_bucketed(payload)
        assert got == idx
        encs.append(enc)
    wide = schema.pack(schema.stack(encs, batch_size=n))
    return schema.to_transport(
        wide, vocab_size=len(env.table) if narrow else None
    )["__packed__"]


@pytest.mark.cuda
@pytest.mark.parametrize("idx", [0, 1])
@pytest.mark.parametrize("narrow", [True, False])
def test_policy_matrix_matches_plain(card_env, idx, narrow):
    buf = torch.from_numpy(_batch(card_env, idx, 64, narrow)).cuda()
    program = card_env.program_for(idx, True, narrow)
    want_a, want_r = ck.policy_matrix_plain(buf, program)
    before = ck.policy_matrix.launches
    got_a, got_r = ck.policy_matrix(buf, program)
    torch.cuda.synchronize()
    assert ck.policy_matrix.launches == before + 1
    assert torch.equal(got_a, want_a)
    assert torch.equal(got_r, want_r)


@pytest.mark.cuda
def test_probe_matches_plain(card_env):
    x = torch.randn(8, 128, device="cuda")
    assert torch.equal(ck.probe(x), ck.probe_plain(x))


@pytest.mark.cuda
def test_run_batch_matches_plain_env(card_env):
    """The environment's device step (transport, one copy, the kernel, the
    combine) against the same batch on the CPU through the plain path."""
    cpu_env = EvaluationEnvironmentBuilder(device="cpu").build(
        flagship_policies()
    )
    bufs = [_batch(card_env, idx, 32, True) for idx in (0, 1)]
    cpu_env.install_reference_state(
        list(card_env.table.strings()),
        [dataclasses.asdict(s.packed_layout()) for s in card_env.schemas],
    )
    for buf in bufs:
        assert (card_env.evaluate_packed(buf) == cpu_env.evaluate_packed(buf)).all()
