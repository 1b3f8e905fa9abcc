"""verification.yml: sigstore verification requirements for policy artifacts.

Reference parity: policy-fetcher's ``LatestVerificationConfig`` /
``VerificationConfigV1`` as used at src/config.rs (read_verification_file)
and verification.yml.example — ``allOf`` (every signature requirement must
match) and ``anyOf`` with ``minimumMatches`` (default 1). Signature
requirement kinds: ``pubKey``, ``genericIssuer`` (subject equal/urlPrefix),
``githubAction``.

Full keyless (Fulcio/Rekor TUF) verification requires network egress; this
module models and validates the config schema, and ``fetch/verify.py`` applies
the subset that is verifiable hermetically (pubKey signatures, digest
checksums). Unsupported kinds are reported, not silently accepted.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping

from policy_server_tpu_torch.config.sources import read_config_document

_SIGNATURE_KINDS = {"pubKey", "genericIssuer", "githubAction"}


@dataclass(frozen=True)
class Subject:
    """genericIssuer subject matcher: exactly one of equal / urlPrefix.

    urlPrefix is post-fixed with '/' when not already present
    (verification.yml.example note: "for security reasons")."""

    equal: str | None = None
    url_prefix: str | None = None

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Subject":
        equal = d.get("equal")
        prefix = d.get("urlPrefix")
        if (equal is None) == (prefix is None):
            raise ValueError("subject requires exactly one of `equal` / `urlPrefix`")
        if prefix is not None and not prefix.endswith("/"):
            prefix = prefix + "/"
        return cls(equal=equal, url_prefix=prefix)

    def matches(self, subject: str) -> bool:
        if self.equal is not None:
            return subject == self.equal
        assert self.url_prefix is not None
        return subject.startswith(self.url_prefix)


@dataclass(frozen=True)
class SignatureRequirement:
    kind: str
    owner: str | None = None
    repo: str | None = None
    key: str | None = None
    issuer: str | None = None
    subject: Subject | None = None
    annotations: Mapping[str, str] | None = None

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SignatureRequirement":
        kind = d.get("kind")
        if kind not in _SIGNATURE_KINDS:
            raise ValueError(
                f"unknown signature kind {kind!r}; expected one of {sorted(_SIGNATURE_KINDS)}"
            )
        if kind == "pubKey" and not d.get("key"):
            raise ValueError("pubKey signature requires `key`")
        if kind == "genericIssuer":
            if not d.get("issuer"):
                raise ValueError("genericIssuer signature requires `issuer`")
            if not isinstance(d.get("subject"), Mapping):
                raise ValueError("genericIssuer signature requires `subject`")
        if kind == "githubAction" and not d.get("owner"):
            raise ValueError("githubAction signature requires `owner`")
        annotations = d.get("annotations")
        return cls(
            kind=kind,
            owner=d.get("owner"),
            repo=d.get("repo"),
            key=d.get("key"),
            issuer=d.get("issuer"),
            subject=Subject.from_dict(d["subject"]) if kind == "genericIssuer" else None,
            annotations=dict(annotations) if isinstance(annotations, Mapping) else None,
        )


@dataclass
class AnyOf:
    minimum_matches: int = 1
    signatures: tuple[SignatureRequirement, ...] = ()

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "AnyOf":
        minimum = d.get("minimumMatches", 1)
        if not isinstance(minimum, int) or minimum < 1:
            raise ValueError("anyOf.minimumMatches must be a positive integer")
        sigs = tuple(
            SignatureRequirement.from_dict(s) for s in (d.get("signatures") or [])
        )
        if len(sigs) < minimum:
            raise ValueError(
                "anyOf has fewer signatures than minimumMatches "
                f"({len(sigs)} < {minimum})"
            )
        return cls(minimum_matches=minimum, signatures=sigs)


@dataclass
class VerificationConfig:
    """apiVersion v1 verification config."""

    api_version: str = "v1"
    all_of: tuple[SignatureRequirement, ...] = ()
    any_of: AnyOf | None = None

    @classmethod
    def from_dict(cls, doc: Mapping[str, Any]) -> "VerificationConfig":
        if not isinstance(doc, Mapping):
            raise ValueError("verification file must contain a mapping")
        api_version = doc.get("apiVersion")
        if api_version != "v1":
            raise ValueError(f"unsupported verification config apiVersion: {api_version!r}")
        all_of = tuple(
            SignatureRequirement.from_dict(s) for s in (doc.get("allOf") or [])
        )
        any_of_doc = doc.get("anyOf")
        any_of = AnyOf.from_dict(any_of_doc) if any_of_doc is not None else None
        if not all_of and any_of is None:
            raise ValueError("verification config must define allOf and/or anyOf")
        return cls(api_version="v1", all_of=all_of, any_of=any_of)


def read_verification_file(path: str | Path) -> VerificationConfig:
    return VerificationConfig.from_dict(
        read_config_document(path, "verification")
    )
