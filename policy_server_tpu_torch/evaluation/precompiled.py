"""Module resolution + digest-keyed program cache.

Reference parity: src/evaluation/precompiled_policy.rs —
* ``PrecompiledPolicy::new`` (precompiled_policy.rs:46-64): read module,
  extract metadata, AOT-compile, sha256 digest. Here "AOT compile" is IR
  build + typecheck (XLA compilation happens once for the fused program at
  boot warmup), and the digest keys both dedup and the persistent JAX
  compilation cache.
* module dedup by digest (evaluation_environment.rs:100-108, 400-418): two
  policies with the same module share one ``PolicyModule``; bound programs
  are additionally cached by (module digest, settings digest) since a
  program is module+settings.
* ``has_minimum_kubewarden_version`` gate (precompiled_policy.rs:76-95):
  artifacts may declare a minimum framework version; patch/pre-release is
  ignored in the comparison.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Any, Mapping, Protocol

from policy_server_tpu_torch.ops.compiler import PolicyProgram
from policy_server_tpu_torch.policies.base import BuiltinPolicy, SettingsValidationResponse
from policy_server_tpu_torch.version import __version__


class PolicyModule(Protocol):
    """What the evaluation environment needs from a resolvable module —
    implemented by builtins (policies/base.py) and fetched artifacts
    (fetch/artifact.py)."""

    name: str
    mutating: bool

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram: ...

    def validate_settings(
        self, settings: Mapping[str, Any]
    ) -> SettingsValidationResponse: ...


def module_digest(module: PolicyModule) -> str:
    """Stable identity of a module. Builtins hash name+framework version
    (their code ships with the binary); artifact modules override via a
    ``digest`` attribute (sha256 of artifact bytes, like the reference's
    sha256 of the wasm file)."""
    explicit = getattr(module, "digest", None)
    if explicit:
        return str(explicit)
    h = hashlib.sha256(f"builtin:{module.name}:{__version__}".encode()).hexdigest()
    return h


def settings_digest(settings: Mapping[str, Any]) -> str:
    return hashlib.sha256(
        json.dumps(settings or {}, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()


def check_minimum_version(required: str | None) -> bool:
    """precompiled_policy.rs:76-95: compare major.minor only."""
    if not required:
        return True
    def mm(v: str) -> tuple[int, int]:
        parts = v.lstrip("v").split("-")[0].split("+")[0].split(".")
        try:
            return int(parts[0]), int(parts[1]) if len(parts) > 1 else 0
        except ValueError:
            return (0, 0)
    want, have = mm(required), mm(__version__)
    return have >= want


@dataclass
class PrecompiledPolicy:
    """A module bound to settings: the built+typechecked program, with its
    identity digests (the unit the fused device program is assembled from)."""

    module: PolicyModule
    module_digest: str
    settings_digest: str
    program: PolicyProgram


class ProgramCache:
    """(module_digest, settings_digest) → PrecompiledPolicy. The analog of
    ``PrecompiledPolicies = HashMap<Url, Result<PrecompiledPolicy>>``
    (precompiled_policy.rs:72) plus the digest dedup of
    evaluation_environment.rs:400-418."""

    def __init__(self) -> None:
        self._cache: dict[tuple[str, str], PrecompiledPolicy] = {}

    def get_or_build(
        self, module: PolicyModule, settings: Mapping[str, Any]
    ) -> PrecompiledPolicy:
        key = (module_digest(module), settings_digest(settings))
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        program = module.build(dict(settings or {}))
        program.typecheck()
        pre = PrecompiledPolicy(
            module=module,
            module_digest=key[0],
            settings_digest=key[1],
            program=program,
        )
        self._cache[key] = pre
        return pre

    def __len__(self) -> int:
        return len(self._cache)
