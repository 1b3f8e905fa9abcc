"""policies.yml data model: policies, policy groups, modes, settings.

Reference parity: src/config.rs —
* ``PolicyMode`` (config.rs:287-303): ``monitor`` | ``protect``, default protect.
* ``PolicyOrPolicyGroup`` untagged enum (config.rs:361-394): an entry is a
  group iff it has a ``policies`` key, else an individual policy with a
  required ``module``.
* ``PolicyGroupMember`` (config.rs:343-351): ``module``, ``settings``,
  ``contextAwareResources`` (camelCase on the wire, deny-unknown-fields).
* ``ContextAwareResource`` (config.rs:548-555): ``{apiVersion, kind}``.
* ``SettingsJSON`` (config.rs:306-328): settings parsed from YAML are
  normalized to JSON (YAML-only scalars like dates become strings).
* policy-name validation (config.rs:237-258): names must not contain ``/``
  (it is the group/member separator, see evaluation/policy_id.py).
"""

from __future__ import annotations

import datetime
import enum
from dataclasses import dataclass, field
from typing import Any, Mapping


class PolicyMode(str, enum.Enum):
    """monitor: never rejects, only reports; protect: enforces.

    Reference: config.rs:287-303; the monitor/protect semantics are applied
    in api/service.py (reference src/api/service.rs:160-208).
    """

    MONITOR = "monitor"
    PROTECT = "protect"

    @classmethod
    def parse(cls, value: Any) -> "PolicyMode":
        if value is None:
            return cls.PROTECT
        if isinstance(value, PolicyMode):
            return value
        if isinstance(value, str):
            try:
                return cls(value)
            except ValueError:
                pass
        raise ValueError(f"invalid policy mode: {value!r} (expected 'monitor' or 'protect')")


def normalize_settings(value: Any) -> Any:
    """YAML→JSON settings normalization (reference SettingsJSON,
    config.rs:306-328, 417-443): YAML-only scalar types are stringified so
    the settings handed to policies are plain JSON."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, (datetime.date, datetime.datetime)):
        return value.isoformat()
    if isinstance(value, bytes):
        return value.decode("utf-8", errors="replace")
    if isinstance(value, Mapping):
        return {str(k): normalize_settings(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set)):
        return [normalize_settings(v) for v in value]
    return str(value)


@dataclass(frozen=True, order=True)
class ContextAwareResource:
    """A Kubernetes resource a policy is allowed to read (config.rs:548-555)."""

    api_version: str
    kind: str

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ContextAwareResource":
        if not isinstance(d, Mapping):
            raise ValueError("contextAwareResources entries must be objects")
        try:
            return cls(api_version=str(d["apiVersion"]), kind=str(d["kind"]))
        except KeyError as e:
            raise ValueError(f"contextAwareResources entry missing key: {e}") from e

    def to_dict(self) -> dict[str, str]:
        return {"apiVersion": self.api_version, "kind": self.kind}


def _parse_context_aware(value: Any) -> frozenset[ContextAwareResource]:
    if value is None:
        return frozenset()
    if not isinstance(value, (list, tuple)):
        raise ValueError("contextAwareResources must be a list")
    return frozenset(ContextAwareResource.from_dict(v) for v in value)


_POLICY_KEYS = {"module", "policyMode", "allowedToMutate", "settings", "contextAwareResources"}
_GROUP_KEYS = {"policyMode", "policies", "expression", "message"}
_MEMBER_KEYS = {"module", "settings", "contextAwareResources"}


@dataclass
class Policy:
    """An individual policy entry in policies.yml (config.rs:365-381)."""

    module: str
    policy_mode: PolicyMode = PolicyMode.PROTECT
    allowed_to_mutate: bool | None = None
    settings: dict[str, Any] | None = None
    context_aware_resources: frozenset[ContextAwareResource] = field(
        default_factory=frozenset
    )

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Policy":
        unknown = set(d) - _POLICY_KEYS
        if unknown:
            raise ValueError(f"unknown policy fields: {sorted(unknown)}")
        if "module" not in d or not isinstance(d["module"], str) or not d["module"]:
            raise ValueError("policy must have a non-empty `module`")
        settings = d.get("settings")
        if settings is not None and not isinstance(settings, Mapping):
            raise ValueError("policy `settings` must be a mapping")
        allowed = d.get("allowedToMutate")
        if allowed is not None and not isinstance(allowed, bool):
            raise ValueError("`allowedToMutate` must be a boolean")
        return cls(
            module=d["module"],
            policy_mode=PolicyMode.parse(d.get("policyMode")),
            allowed_to_mutate=allowed,
            settings=normalize_settings(settings) if settings is not None else None,
            context_aware_resources=_parse_context_aware(d.get("contextAwareResources")),
        )

    def settings_json(self) -> dict[str, Any]:
        return dict(self.settings or {})


@dataclass
class PolicyGroupMember:
    """config.rs:343-351."""

    module: str
    settings: dict[str, Any] | None = None
    context_aware_resources: frozenset[ContextAwareResource] = field(
        default_factory=frozenset
    )

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "PolicyGroupMember":
        if not isinstance(d, Mapping):
            raise ValueError("policy group member must be an object")
        unknown = set(d) - _MEMBER_KEYS
        if unknown:
            raise ValueError(f"unknown policy group member fields: {sorted(unknown)}")
        if "module" not in d or not isinstance(d["module"], str) or not d["module"]:
            raise ValueError("policy group member must have a non-empty `module`")
        settings = d.get("settings")
        if settings is not None and not isinstance(settings, Mapping):
            raise ValueError("member `settings` must be a mapping")
        return cls(
            module=d["module"],
            settings=normalize_settings(settings) if settings is not None else None,
            context_aware_resources=_parse_context_aware(d.get("contextAwareResources")),
        )

    def settings_json(self) -> dict[str, Any]:
        return dict(self.settings or {})


@dataclass
class PolicyGroup:
    """A group of policies evaluated under a boolean expression
    (config.rs:382-394). Group-level mutation is forbidden (reference
    integration test "mutation is not allowed inside of policy group",
    tests/integration_test.rs:239-251)."""

    policies: dict[str, PolicyGroupMember]
    expression: str
    message: str
    policy_mode: PolicyMode = PolicyMode.PROTECT

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "PolicyGroup":
        unknown = set(d) - _GROUP_KEYS
        if unknown:
            raise ValueError(f"unknown policy group fields: {sorted(unknown)}")
        for req in ("policies", "expression", "message"):
            if req not in d:
                raise ValueError(f"policy group must have `{req}`")
        policies = d["policies"]
        if not isinstance(policies, Mapping) or not policies:
            raise ValueError("policy group `policies` must be a non-empty mapping")
        members = {
            str(name): PolicyGroupMember.from_dict(member)
            for name, member in policies.items()
        }
        if not isinstance(d["expression"], str) or not d["expression"].strip():
            raise ValueError("policy group `expression` must be a non-empty string")
        if not isinstance(d["message"], str):
            raise ValueError("policy group `message` must be a string")
        return cls(
            policies=members,
            expression=d["expression"],
            message=d["message"],
            policy_mode=PolicyMode.parse(d.get("policyMode")),
        )


PolicyOrPolicyGroup = Policy | PolicyGroup


def parse_policy_entry(name: str, d: Mapping[str, Any]) -> PolicyOrPolicyGroup:
    """Untagged-enum dispatch (config.rs:361-394): an entry with a
    ``policies`` key is a group; otherwise it must be an individual policy."""
    if not isinstance(d, Mapping):
        raise ValueError(f"policy {name!r}: entry must be an object")
    try:
        if "policies" in d:
            return PolicyGroup.from_dict(d)
        return Policy.from_dict(d)
    except ValueError as e:
        raise ValueError(f"policy {name!r}: {e}") from e


def validate_policy_names(policies: Mapping[str, Any]) -> None:
    """Policy names must not contain '/' (config.rs:237-258) — it is reserved
    as the group/member separator in PolicyID."""
    invalid = [name for name in policies if "/" in name]
    if invalid:
        raise ValueError(
            "policy names must not contain '/': " + ", ".join(sorted(invalid))
        )


def parse_policies(doc: Mapping[str, Any]) -> dict[str, PolicyOrPolicyGroup]:
    """Parse a full policies.yml document (config.rs:219-258, 449-453)."""
    if doc is None:
        return {}
    if not isinstance(doc, Mapping):
        raise ValueError("policies file must contain a mapping of name -> policy")
    validate_policy_names(doc)
    return {str(name): parse_policy_entry(str(name), entry) for name, entry in doc.items()}
