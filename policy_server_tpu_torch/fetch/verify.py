"""Supply-chain verification of policy artifacts.

Reference parity: src/policy_downloader.rs:101-127 (pre-download
verification → verified digest) and 157-187 (post-download local checksum),
applying verification.yml's allOf/anyOf requirements (config/verification.py).

The reference's sigstore keyless flow (Fulcio/Rekor over TUF) requires
network egress to the public good instance; this build
implements the ``pubKey`` requirement kind with REAL Ed25519 signature
verification (`cryptography`), plus digest pinning. An artifact is
accompanied by a detached signature document ``<artifact>.sig.json``
holding simplesigning-style entries — the signature covers a canonical
payload that binds BOTH the artifact digest and the annotations, the way
sigstore's simplesigning payload does (annotations in the unsigned sidecar
would otherwise be attacker-editable):

```json
{"signatures": [
  {"keyid": "...",
   "payload": "<base64 canonical JSON {critical:{artifact:{sha256-digest},
               type}, optional:{annotations}}>",
   "signature": "<base64 Ed25519 over the payload bytes>"}
]}
```

``genericIssuer`` / ``githubAction`` kinds (keyless) verify OFFLINE when a
file-based trust root is present (``trust_root.json`` in the sigstore
cache dir — fetch/keyless.py: Fulcio-style cert chain, Rekor-style SET +
Merkle inclusion). Without a trust root they keep FAILING LOUDLY —
verification FAILS if a config demands kinds this build cannot check
(never silently accepted)."""

from __future__ import annotations

import base64
import hashlib
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Mapping

from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PublicKey
from cryptography.hazmat.primitives.serialization import load_pem_public_key

from policy_server_tpu_torch.config.verification import (
    SignatureRequirement,
    VerificationConfig,
)


class VerificationError(Exception):
    pass


SIGNATURE_PAYLOAD_TYPE = "tpp-policy-signature"


@dataclass(frozen=True)
class ArtifactSignature:
    keyid: str
    signature: bytes
    payload: bytes  # the signed canonical simplesigning-style document


def make_signature_payload(
    digest_hex: str, annotations: Mapping[str, str] | None = None
) -> bytes:
    """Canonical signed payload: digest + annotations under one signature
    (sigstore simplesigning analog — annotations are cryptographically
    bound, not sidecar metadata)."""
    doc = {
        "critical": {
            "artifact": {"sha256-digest": digest_hex},
            "type": SIGNATURE_PAYLOAD_TYPE,
        },
        "optional": dict(annotations or {}),
    }
    return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()


def load_signature_document(
    artifact_path: str | Path,
) -> tuple[list[ArtifactSignature], list[dict]]:
    """One parse of the ``.sig.json`` sidecar → (pubKey signatures,
    keyless entries). Keyless entries (a ``cert`` field) are verified by
    fetch/keyless.py; the rest are detached pubKey signatures."""
    sig_path = Path(str(artifact_path) + ".sig.json")
    if not sig_path.exists():
        return [], []
    try:
        doc = json.loads(sig_path.read_text())
        signatures: list[ArtifactSignature] = []
        keyless: list[dict] = []
        for s in doc.get("signatures") or []:
            if isinstance(s, Mapping) and s.get("cert"):
                keyless.append(dict(s))
                continue
            signatures.append(
                ArtifactSignature(
                    keyid=str(s.get("keyid", "")),
                    signature=base64.b64decode(s["signature"]),
                    payload=base64.b64decode(s["payload"]),
                )
            )
        return signatures, keyless
    except (ValueError, KeyError, TypeError) as e:
        raise VerificationError(f"malformed signature document {sig_path}: {e}") from e


def _keyless_requirement_matches(
    req: SignatureRequirement,
    artifact_digest: str,
    keyless_entries: list[dict],
    trust_root,
) -> tuple[bool, str]:
    from policy_server_tpu_torch.fetch import keyless as keyless_mod

    if trust_root is None:
        return False, (
            f"signature kind {req.kind!r} requires a sigstore trust root; "
            "none is available (place trust_root.json in the sigstore cache "
            "dir, or use network egress to fetch the TUF root — not "
            "supported by this build)"
        )
    if not keyless_entries:
        return False, (
            f"signature kind {req.kind!r}: artifact carries no keyless "
            "signature bundle"
        )
    reasons: list[str] = []
    for entry in keyless_entries:
        try:
            identity, signed_annotations = keyless_mod.verify_keyless_entry(
                entry, artifact_digest, trust_root, SIGNATURE_PAYLOAD_TYPE
            )
        except keyless_mod.KeylessError as e:
            reasons.append(str(e))
            continue
        ok, why = keyless_mod.identity_satisfies(req, identity)
        if not ok:
            reasons.append(why)
            continue
        if req.annotations and any(
            signed_annotations.get(k) != v
            for k, v in req.annotations.items()
        ):
            reasons.append("signed annotations do not match requirement")
            continue
        return True, ""
    return False, "; ".join(reasons) or "no keyless bundle verified"


def _requirement_matches(
    req: SignatureRequirement,
    artifact_digest: str,
    signatures: list[ArtifactSignature],
    keyless_entries: list[dict] | None = None,
    trust_root=None,
) -> tuple[bool, str]:
    """→ (matched, reason-if-not)."""
    if req.kind in ("genericIssuer", "githubAction"):
        return _keyless_requirement_matches(
            req, artifact_digest, keyless_entries or [], trust_root
        )
    if req.kind != "pubKey":
        return False, (
            f"signature kind {req.kind!r} is not supported by this build"
        )
    try:
        key = load_pem_public_key(req.key.encode())
    except ValueError as e:
        return False, f"invalid pubKey PEM: {e}"
    if not isinstance(key, Ed25519PublicKey):
        return False, "pubKey must be an Ed25519 public key"
    for sig in signatures:
        try:
            key.verify(sig.signature, sig.payload)
        except InvalidSignature:
            continue
        # Signature is authentic for this key: now bind it to THIS artifact
        # and read annotations from the SIGNED payload only.
        try:
            payload = json.loads(sig.payload)
            critical = payload["critical"]
            signed_digest = critical["artifact"]["sha256-digest"]
            payload_type = critical["type"]
            signed_annotations = dict(payload.get("optional") or {})
        except (ValueError, KeyError, TypeError):
            continue
        if payload_type != SIGNATURE_PAYLOAD_TYPE:
            continue
        if signed_digest != artifact_digest:
            continue
        if req.annotations:
            if any(
                signed_annotations.get(k) != v
                for k, v in req.annotations.items()
            ):
                continue
        return True, ""
    return False, "no signature matched the configured public key"


def verify_artifact(
    artifact_path: str | Path,
    config: VerificationConfig | None,
    trust_root=None,
) -> str:
    """Apply the verification config to a downloaded artifact. Returns the
    artifact's sha256 digest (the reference returns the verified manifest
    digest, policy_downloader.rs:118-126). Raises VerificationError when
    requirements are not met. ``trust_root`` (fetch/keyless.TrustRoot)
    enables the offline keyless kinds; without one they fail loudly."""
    data = Path(artifact_path).read_bytes()
    digest = hashlib.sha256(data).hexdigest()
    if config is None:
        return digest
    signatures, keyless_entries = load_signature_document(artifact_path)

    failures: list[str] = []
    for req in config.all_of:
        ok, why = _requirement_matches(
            req, digest, signatures, keyless_entries, trust_root
        )
        if not ok:
            failures.append(f"allOf requirement not satisfied: {why}")
    if config.any_of is not None:
        matched = 0
        reasons: list[str] = []
        for req in config.any_of.signatures:
            ok, why = _requirement_matches(
                req, digest, signatures, keyless_entries, trust_root
            )
            if ok:
                matched += 1
            else:
                reasons.append(why)
        if matched < config.any_of.minimum_matches:
            failures.append(
                f"anyOf matched {matched} < minimumMatches "
                f"{config.any_of.minimum_matches}: {'; '.join(reasons)}"
            )
    if failures:
        raise VerificationError(
            f"artifact {artifact_path} failed verification: "
            + " | ".join(failures)
        )
    return digest


def verify_local_checksum(artifact_path: str | Path, expected_digest: str) -> None:
    """policy_downloader.rs:157-176: the downloaded file must hash to the
    verified digest."""
    data = Path(artifact_path).read_bytes()
    actual = hashlib.sha256(data).hexdigest()
    if actual != expected_digest:
        raise VerificationError(
            f"artifact {artifact_path} checksum mismatch: "
            f"expected {expected_digest}, got {actual}"
        )


def sign_artifact_bytes(private_key_pem: bytes, data: bytes) -> bytes:
    """Authoring/test helper: Ed25519 detached signature over raw bytes."""
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
    )
    from cryptography.hazmat.primitives.serialization import (
        load_pem_private_key,
    )

    key = load_pem_private_key(private_key_pem, password=None)
    assert isinstance(key, Ed25519PrivateKey)
    return key.sign(data)


def make_signature_entry(
    private_key_pem: bytes,
    artifact_bytes: bytes,
    keyid: str = "",
    annotations: Mapping[str, str] | None = None,
) -> dict[str, str]:
    """Authoring/test helper: one sidecar ``signatures[]`` entry — canonical
    payload (digest + annotations) signed with Ed25519."""
    digest = hashlib.sha256(artifact_bytes).hexdigest()
    payload = make_signature_payload(digest, annotations)
    signature = sign_artifact_bytes(private_key_pem, payload)
    return {
        "keyid": keyid,
        "payload": base64.b64encode(payload).decode(),
        "signature": base64.b64encode(signature).decode(),
    }
