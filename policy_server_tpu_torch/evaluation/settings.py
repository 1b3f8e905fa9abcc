"""Per-policy evaluation settings.

Reference parity: src/evaluation/policy_evaluation_settings.rs:7-14.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from policy_server_tpu_torch.models.policy import PolicyMode


@dataclass
class PolicyEvaluationSettings:
    policy_mode: PolicyMode = PolicyMode.PROTECT
    allowed_to_mutate: bool = False
    settings: dict[str, Any] = field(default_factory=dict)
