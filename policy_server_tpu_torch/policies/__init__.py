"""Builtin policy registry and module-URL resolution.

Module URL schemes accepted in policies.yml (reference README.md:73-82
documents file://, https://, registry://):

* ``builtin://<name>``      — a native policy family from this library.
* ``registry://…`` / ``https://`` / ``file://`` — fetched artifacts
  (fetch/downloader.py). Fetched ``.tpp.json`` artifacts contain serialized
  IR (fetch/artifact.py); fetched ``.wasm`` modules are parsed for their
  Kubewarden metadata and mapped to a builtin equivalent when one exists
  (the mechanical analog of burrego's builtins registry, SURVEY.md §2.2).

``resolve_builtin`` maps known upstream OCI refs (e.g.
``ghcr.io/kubewarden/policies/psp-capabilities:v0.1.7``) to their native
re-implementation so the reference's example policies.yml works verbatim.
"""

from __future__ import annotations

from policy_server_tpu_torch.policies.base import (
    BuiltinPolicy,
    SettingsError,
    SettingsValidationResponse,
)
from policy_server_tpu_torch.policies.library import ALL_FAMILIES

BUILTINS: dict[str, BuiltinPolicy] = {cls.name: cls() for cls in ALL_FAMILIES}

_UPSTREAM_MAP: dict[str, BuiltinPolicy] = {}
for _policy in BUILTINS.values():
    for _ref in _policy.upstream_equivalents:
        _UPSTREAM_MAP[_ref] = _policy


def _strip_scheme(url: str) -> str:
    for scheme in ("registry://", "https://", "http://", "oci://"):
        if url.startswith(scheme):
            return url[len(scheme):]
    return url


def resolve_builtin(module_url: str) -> BuiltinPolicy | None:
    """Resolve a policies.yml ``module`` URL to a builtin policy, or None
    if it must be fetched."""
    if module_url.startswith("builtin://"):
        name = module_url[len("builtin://"):]
        policy = BUILTINS.get(name)
        if policy is None:
            raise KeyError(
                f"unknown builtin policy {name!r}; available: {sorted(BUILTINS)}"
            )
        return policy
    bare = _strip_scheme(module_url)
    # drop :tag / @digest
    ref = bare.split("@")[0]
    if ":" in ref.rsplit("/", 1)[-1]:
        ref = ref.rsplit(":", 1)[0]
    return _UPSTREAM_MAP.get(ref)


__all__ = [
    "BUILTINS",
    "BuiltinPolicy",
    "SettingsError",
    "SettingsValidationResponse",
    "resolve_builtin",
]
