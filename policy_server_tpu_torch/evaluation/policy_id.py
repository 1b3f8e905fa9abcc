"""PolicyID: ``name`` or ``group/member``.

Reference parity: src/evaluation/policy_id.rs:7-49. Policy names never
contain '/' (enforced at config parse, models/policy.py), so one slash
unambiguously addresses a group member.
"""

from __future__ import annotations

from dataclasses import dataclass

from policy_server_tpu_torch.evaluation.errors import InvalidPolicyId


@dataclass(frozen=True)
class PolicyID:
    name: str
    group: str | None = None

    @property
    def is_group_member(self) -> bool:
        return self.group is not None

    @classmethod
    def parse(cls, raw: str) -> "PolicyID":
        if not raw:
            raise InvalidPolicyId("empty policy id")
        parts = raw.split("/")
        if len(parts) == 1:
            return cls(name=parts[0])
        if len(parts) == 2 and parts[0] and parts[1]:
            return cls(group=parts[0], name=parts[1])
        raise InvalidPolicyId(f"invalid policy id: {raw!r}")

    def __str__(self) -> str:
        return f"{self.group}/{self.name}" if self.group else self.name
