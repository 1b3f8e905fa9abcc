"""Evaluation errors.

Reference parity: src/evaluation/errors.rs:6-24 (``EvaluationError``
variants). The API layer maps PolicyNotFound → 404 and everything else →
500 (src/api/handlers.rs:321-342); PolicyInitialization errors become
in-band 500 rejections (src/api/service.rs:78-94).
"""

from __future__ import annotations


class EvaluationError(Exception):
    pass


class InvalidPolicyId(EvaluationError):
    pass


class PolicyNotFoundError(EvaluationError):
    def __init__(self, policy_id: str):
        super().__init__(f"policy not found: {policy_id}")
        self.policy_id = policy_id


class PolicyInitializationError(EvaluationError):
    def __init__(self, policy_id: str, message: str):
        super().__init__(message)
        self.policy_id = policy_id


class BootstrapFailure(EvaluationError):
    pass


class ExecutionDeadlineExceeded(EvaluationError):
    """The batched analog of wasmtime epoch interruption
    (reference lib.rs:176-190; rejection message
    'execution deadline exceeded', integration_test.rs:417)."""

    def __init__(self) -> None:
        super().__init__("execution deadline exceeded")
