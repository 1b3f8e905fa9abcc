"""The benchmark's tests that need the card: ``python -m pytest -m cuda
admission_bench/test_admission_bench_card.py`` on a machine with one.

The control of each cell: a run at the cell's own load and window, whose
answers are then held against the reference with one guarantee that the
configuration states broken and put in the program's place. It has to
come out not correct on every seed; the number of answers it gets wrong
is the upper reading of the limit on ``answers_off_reference`` (whose
lower reading, over sound runs, is 0).

And a fault planted in the program at the cell's own load: every second
answer the environment materializes is an in-band 504 in place of its
verdict (half of the calls left out). It has to come out not correct on
every seed; the calls it fails are the upper reading of the limit on
``calls_failed`` (lower reading 0).
"""

from __future__ import annotations

import json

import pytest

from admission_bench import catalog, run

# (cell, the guarantee its control breaks)
CONTROLS = [("flagship32.fanout", "skip_signatures")]
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,control", CONTROLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(card, name, control, seed):
    seconds = catalog.manifest()["run_seconds"]
    out = run.run_cell(catalog.cell(name), seed, seconds, False, "cuda",
                       controls=frozenset({control}))
    print(json.dumps({"control": control, "cell": name, "seed": seed, "card": card,
                      "checks": out["checks"]}))
    assert not out["correct"]
    assert out["checks"]["answers_off_reference"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c[0] for c in CONTROLS])
@pytest.mark.parametrize("seed", SEEDS)
def test_half_the_calls_failed_is_not_correct(card, name, seed, monkeypatch):
    from policy_server_tpu_torch.evaluation import environment
    from policy_server_tpu_torch.models import AdmissionResponse

    original = environment.EvaluationEnvironment._materialize_single
    count = [0]

    def half_failed(self, bp, uid, payload_fn, outputs):
        response = original(self, bp, uid, payload_fn, outputs)
        count[0] += 1
        if count[0] % 2:
            return AdmissionResponse.reject(uid, "request deadline exceeded before evaluation", 504)
        return response

    monkeypatch.setattr(environment.EvaluationEnvironment, "_materialize_single", half_failed)
    seconds = catalog.manifest()["run_seconds"]
    out = run.run_cell(catalog.cell(name), seed, seconds, False, "cuda")
    print(json.dumps({"fault": "half_failed", "cell": name, "seed": seed, "card": card,
                      "checks": out["checks"]}))
    assert not out["correct"]
    assert out["checks"]["calls_failed"]["value"] > 0
