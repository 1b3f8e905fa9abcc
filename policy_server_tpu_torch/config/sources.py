"""sources.yml: registry trust configuration.

Reference parity: policy-fetcher's ``Sources`` / ``read_sources_file`` as used
at src/config.rs:270-285 and sources.yml.example — ``insecure_sources`` (plain
HTTP / skip TLS verify) and ``source_authorities`` (extra CA certs per
registry, entries of type Path or Data).

A sources or verification file is read as JSON when it parses as JSON,
else as YAML through PyYAML, imported only then; where PyYAML is not
installed a YAML file raises with a clear message.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping


@dataclass(frozen=True)
class SourceAuthority:
    """One CA certificate for a registry host: either a file path or inline
    PEM/DER data (sources.yml.example types ``Path`` / ``Data``)."""

    type: str  # "Path" | "Data"
    path: str | None = None
    data: str | None = None

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SourceAuthority":
        kind = d.get("type")
        if kind == "Path":
            if not d.get("path"):
                raise ValueError("source authority of type Path requires `path`")
            return cls(type="Path", path=str(d["path"]))
        if kind == "Data":
            if not d.get("data"):
                raise ValueError("source authority of type Data requires `data`")
            return cls(type="Data", data=str(d["data"]))
        raise ValueError(f"unknown source authority type: {kind!r}")

    def pem_bytes(self) -> bytes:
        if self.type == "Data":
            assert self.data is not None
            return self.data.encode()
        assert self.path is not None
        return Path(self.path).read_bytes()


@dataclass
class Sources:
    insecure_sources: frozenset[str] = field(default_factory=frozenset)
    source_authorities: dict[str, tuple[SourceAuthority, ...]] = field(
        default_factory=dict
    )

    def is_insecure(self, host: str) -> bool:
        return host in self.insecure_sources

    def authorities_for(self, host: str) -> tuple[SourceAuthority, ...]:
        return self.source_authorities.get(host, ())

    @classmethod
    def from_dict(cls, doc: Mapping[str, Any] | None) -> "Sources":
        if doc is None:
            return cls()
        if not isinstance(doc, Mapping):
            raise ValueError("sources file must contain a mapping")
        insecure = doc.get("insecure_sources") or []
        if not isinstance(insecure, (list, tuple)):
            raise ValueError("insecure_sources must be a list")
        authorities_doc = doc.get("source_authorities") or {}
        if not isinstance(authorities_doc, Mapping):
            raise ValueError("source_authorities must be a mapping")
        authorities = {
            str(host): tuple(SourceAuthority.from_dict(a) for a in certs)
            for host, certs in authorities_doc.items()
        }
        return cls(
            insecure_sources=frozenset(str(s) for s in insecure),
            source_authorities=authorities,
        )


def read_config_document(path: str | Path, what: str) -> Any:
    """A config file → its document: JSON when it parses as JSON, else
    YAML through PyYAML, which raises where PyYAML is not installed."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        json_error = e
    try:
        import yaml
    except ImportError:
        raise ValueError(
            f"{what} file {str(path)!r} is not JSON ({json_error}), and "
            "reading YAML needs PyYAML, which is not installed"
        ) from json_error
    return yaml.safe_load(text)


def read_sources_file(path: str | Path) -> Sources:
    """config.rs:270-285."""
    return Sources.from_dict(read_config_document(path, "sources"))
