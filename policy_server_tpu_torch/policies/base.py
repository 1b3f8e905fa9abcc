"""Builtin policy base class and settings-validation ABI.

Reference parity: the Kubewarden policy SDK contract —
``SettingsValidationResponse {valid, message}``
(kubewarden_policy_sdk::settings, used at
src/evaluation/evaluation_environment.rs:478-494) and the per-policy
``Metadata`` (mutating flag, execution mode;
src/evaluation/precompiled_policy.rs:48-51).

A builtin policy is this framework's equivalent of a WASM policy module: a
"model family" that, bound to user settings (policies.yml ``settings:``),
builds a tensorizable ``PolicyProgram`` (ops/compiler.py). Settings are
validated at boot exactly like the reference's validate_settings pass
(evaluation_environment.rs:472-510): invalid settings are a
policy-initialization error.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping

from policy_server_tpu_torch.ops.compiler import PolicyProgram


@dataclass(frozen=True)
class SettingsValidationResponse:
    valid: bool
    message: str | None = None

    @classmethod
    def ok(cls) -> "SettingsValidationResponse":
        return cls(True, None)

    @classmethod
    def error(cls, message: str) -> "SettingsValidationResponse":
        return cls(False, message)


class SettingsError(ValueError):
    """Raised by builders on invalid settings (converted to
    SettingsValidationResponse by validate_settings)."""


class BuiltinPolicy:
    """Base class for the native policy library.

    Subclasses define ``name`` (the module identity, addressable as
    ``builtin://<name>``), ``mutating`` and ``build(settings)``.
    """

    name: str = ""
    mutating: bool = False
    # Known upstream OCI images this builtin re-implements (lets the example
    # policies.yml of the reference work verbatim via known-module mapping).
    upstream_equivalents: tuple[str, ...] = ()

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        raise NotImplementedError

    def validate_settings(self, settings: Mapping[str, Any]) -> SettingsValidationResponse:
        """Default: settings are valid iff build() accepts them."""
        try:
            program = self.build(dict(settings or {}))
            program.typecheck()
        except (SettingsError, ValueError) as e:
            return SettingsValidationResponse.error(str(e))
        return SettingsValidationResponse.ok()


def _as_str_list(settings: Mapping[str, Any], key: str, default: list | None = None) -> list[str]:
    v = settings.get(key, default if default is not None else [])
    if v is None:
        return []
    if not isinstance(v, (list, tuple)) or not all(isinstance(x, str) for x in v):
        raise SettingsError(f"setting {key!r} must be a list of strings")
    return list(v)


def _as_bool(settings: Mapping[str, Any], key: str, default: bool = False) -> bool:
    v = settings.get(key, default)
    if not isinstance(v, bool):
        raise SettingsError(f"setting {key!r} must be a boolean")
    return v


def _as_number(settings: Mapping[str, Any], key: str, default: float | None = None) -> float:
    v = settings.get(key, default)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise SettingsError(f"setting {key!r} must be a number")
    return float(v)


str_list = _as_str_list
bool_setting = _as_bool
number_setting = _as_number

MutatorFn = Callable[[Any], list[dict] | None]
