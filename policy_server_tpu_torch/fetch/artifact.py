"""Policy artifact format (`.tpp.json`) and fetched-module resolution.

The reference distributes policies as OCI artifacts containing WASM with
embedded Kubewarden metadata (policy_metadata::Metadata, SURVEY.md §2.2).
This framework's native artifact is a JSON bundle of serialized predicate IR
(ops/serde.py):

```json
{
  "apiVersion": "tpp.kubewarden.dev/v1",
  "kind": "PolicyBundle",
  "metadata": {
    "name": "no-latest-tag",
    "mutating": false,
    "minimumFrameworkVersion": "0.1",
    "requiredSettings": ["denied_namespaces"]
  },
  "rules": [
    {"name": "r0", "message": "...", "condition": { ...IR JSON... }}
  ]
}
```

``.wasm`` artifacts execute host-side through the wasm substrate
(wasm/ + evaluation/wasm_policy.py — waPC and OPA/Gatekeeper ABIs), the
multi-ABI escape hatch; known upstream URLs still prefer the native
re-implementation (policies.resolve_builtin, the burrego-builtins
equivalent) because the predicate-IR path is the device fast path."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any, Mapping

from policy_server_tpu_torch.evaluation.precompiled import check_minimum_version
from policy_server_tpu_torch.ops import serde
from policy_server_tpu_torch.ops.compiler import PolicyProgram, Rule
from policy_server_tpu_torch.ops.ir import IRError
from policy_server_tpu_torch.policies.base import SettingsValidationResponse
from policy_server_tpu_torch.version import __version__

API_VERSION = "tpp.kubewarden.dev/v1"
BUNDLE_KIND = "PolicyBundle"


class ArtifactError(ValueError):
    pass


class ArtifactPolicyModule:
    """A fetched `.tpp.json` bundle as a PolicyModule
    (evaluation/precompiled.PolicyModule protocol)."""

    def __init__(self, doc: Mapping[str, Any], digest: str):
        if doc.get("apiVersion") != API_VERSION or doc.get("kind") != BUNDLE_KIND:
            raise ArtifactError(
                f"not a {API_VERSION}/{BUNDLE_KIND} artifact: "
                f"{doc.get('apiVersion')}/{doc.get('kind')}"
            )
        meta = doc.get("metadata") or {}
        self.name = str(meta.get("name") or "unnamed-policy")
        self.mutating = bool(meta.get("mutating", False))
        self.digest = digest
        self.upstream_equivalents: tuple[str, ...] = ()
        self.required_settings = tuple(meta.get("requiredSettings") or ())
        minimum = meta.get("minimumFrameworkVersion")
        if minimum and not check_minimum_version(str(minimum)):
            # precompiled_policy.rs:76-95 gate
            raise ArtifactError(
                f"artifact requires framework >= {minimum}, running {__version__}"
            )
        rules = doc.get("rules")
        if not isinstance(rules, list) or not rules:
            raise ArtifactError("artifact must declare a non-empty `rules` list")
        self._rule_docs = rules

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        rules = []
        for i, rd in enumerate(self._rule_docs):
            if not isinstance(rd, Mapping) or "condition" not in rd:
                raise ArtifactError(f"rule {i} must have a `condition`")
            condition = serde.expr_from_json(rd["condition"], settings)
            rules.append(
                Rule(
                    name=str(rd.get("name", f"rule-{i}")),
                    condition=condition,
                    message=str(rd.get("message", "request rejected")),
                )
            )
        program = PolicyProgram(rules=tuple(rules))
        program.typecheck()
        return program

    def validate_settings(
        self, settings: Mapping[str, Any]
    ) -> SettingsValidationResponse:
        missing = [k for k in self.required_settings if k not in settings]
        if missing:
            return SettingsValidationResponse.error(
                f"missing required settings: {', '.join(sorted(missing))}"
            )
        try:
            self.build(settings)
        except (IRError, ArtifactError) as e:
            return SettingsValidationResponse.error(str(e))
        return SettingsValidationResponse.ok()


def load_artifact(path: str | Path):
    """Parse a downloaded artifact file → PolicyModule.

    ``.tpp.json`` bundles compile to device predicate programs (the device
    fast path). ``.wasm`` payloads execute host-side through the wasm
    substrate (evaluation/wasm_policy.py: waPC or OPA/Gatekeeper ABI) —
    the multi-ABI escape hatch matching the reference's wasmtime
    execution (precompiled_policy.rs:46-64); an unsupported ABI surfaces
    as a policy initialization error."""
    data = Path(path).read_bytes()
    digest = hashlib.sha256(data).hexdigest()
    if data[:4] == b"\x00asm":
        from policy_server_tpu_torch.evaluation.wasm_policy import WasmPolicyModule

        try:
            return WasmPolicyModule(data, name=Path(path).stem, digest=digest)
        except Exception as e:  # noqa: BLE001 — arbitrary fetched bytes can
            # break the decoder in arbitrary ways (IndexError on truncated
            # sections, KeyError on bad kinds, ...); EVERY failure is the
            # same outcome: an unusable artifact. ArtifactError is a
            # ValueError, so it surfaces as a per-policy initialization
            # error (and through --continue-on-errors), never a bootstrap
            # crash.
            raise ArtifactError(f"unusable wasm artifact: {e}") from e
    try:
        doc = json.loads(data)
    except json.JSONDecodeError as e:
        raise ArtifactError(f"artifact is not valid JSON: {e}") from e
    return ArtifactPolicyModule(doc, digest=digest)


def dump_artifact(
    name: str,
    rules: list[Rule],
    mutating: bool = False,
    required_settings: tuple[str, ...] = (),
    minimum_framework_version: str | None = None,
) -> dict[str, Any]:
    """Serialize a rule set into bundle-document form (the authoring /
    test-fixture side of load_artifact)."""
    return {
        "apiVersion": API_VERSION,
        "kind": BUNDLE_KIND,
        "metadata": {
            "name": name,
            "mutating": mutating,
            "requiredSettings": list(required_settings),
            **(
                {"minimumFrameworkVersion": minimum_framework_version}
                if minimum_framework_version
                else {}
            ),
        },
        "rules": [
            {
                "name": r.name,
                "message": r.message if isinstance(r.message, str) else "rejected",
                "condition": serde.expr_to_json(r.condition),
            }
            for r in rules
        ],
    }
