"""Offline sigstore-keyless verification scaffolding.

Reference parity: the reference builds a sigstore trust root from a TUF
cache (``SigstoreTrustRoot::new(cache_dir)`` → ``fulcio_certs()`` /
``rekor_keys()``, src/lib.rs:309-336) and verifies keyless-signed policy
artifacts against verification.yml's ``genericIssuer`` / ``githubAction``
requirement kinds (src/policy_downloader.rs:101-127). Fetching the real
public-good TUF root needs network egress this build does not have; the
VERIFICATION LOGIC does not. This module implements the offline half:

* **Trust root** — a local JSON document (``trust_root.json`` inside
  ``--sigstore-cache-dir``, standing in for the TUF cache) holding
  Fulcio-style CA certificates and Rekor-style log public keys (PEM).
* **Fulcio-style certificate chain** — the artifact signature is made by
  a short-lived leaf certificate carrying the signer identity in its SAN
  and the OIDC issuer in the sigstore OID extension (1.3.6.1.4.1.57264.1.1);
  the chain must verify up to a trust-root CA, and the leaf must have
  been valid at the log's ``integratedTime`` (short-lived certs are the
  POINT of keyless: validity is anchored to log time, not wall clock).
* **Rekor-style inclusion** — the log entry body binds the signed payload
  hash and the leaf certificate; a signed entry timestamp (SET) from a
  trust-root Rekor key covers {body, integratedTime, logIndex, logID};
  an RFC 6962/9162 Merkle inclusion proof ties the body to a signed
  checkpoint root hash.

Authoring helpers at the bottom mint test fixtures (a CA, identity
certs, a toy transparency log) so the verify paths — and their tamper
rejections — are provable offline. Without a trust root on disk, keyless
requirements keep FAILING LOUDLY exactly as before.
"""

from __future__ import annotations

import base64
import datetime as _dt
import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping

from cryptography import x509
from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec, padding, rsa
from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey,
    Ed25519PublicKey,
)
from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID


class KeylessError(Exception):
    pass


# Fulcio certificate extension: OIDC issuer (sigstore OID arc)
OID_FULCIO_ISSUER = x509.ObjectIdentifier("1.3.6.1.4.1.57264.1.1")
GITHUB_ACTIONS_ISSUER = "https://token.actions.githubusercontent.com"

_MAX_CHAIN_LEN = 6


# ---------------------------------------------------------------------------
# Trust root
# ---------------------------------------------------------------------------


@dataclass
class TrustRoot:
    """The offline stand-in for the TUF-rooted sigstore trust root
    (lib.rs:309-336): Fulcio CA certs + Rekor log keys."""

    fulcio_certs: list[x509.Certificate] = field(default_factory=list)
    rekor_keys: list[Any] = field(default_factory=list)

    @classmethod
    def load(cls, path: str | Path) -> "TrustRoot":
        """Load ``trust_root.json``: {"fulcio_certs": [PEM...],
        "rekor_keys": [PEM...]}."""
        try:
            doc = json.loads(Path(path).read_text())
        except (OSError, ValueError) as e:
            raise KeylessError(f"cannot load trust root {path}: {e}") from e
        if not isinstance(doc, Mapping):
            raise KeylessError(
                f"trust root {path} must be a JSON object with "
                "fulcio_certs and rekor_keys"
            )
        certs = []
        for pem in doc.get("fulcio_certs") or []:
            try:
                certs.append(x509.load_pem_x509_certificate(pem.encode()))
            except ValueError as e:
                raise KeylessError(f"bad fulcio cert in trust root: {e}") from e
        keys = []
        for pem in doc.get("rekor_keys") or []:
            try:
                keys.append(serialization.load_pem_public_key(pem.encode()))
            except ValueError as e:
                raise KeylessError(f"bad rekor key in trust root: {e}") from e
        if not certs or not keys:
            raise KeylessError(
                "trust root must hold at least one fulcio cert and one "
                "rekor key"
            )
        return cls(fulcio_certs=certs, rekor_keys=keys)

    @classmethod
    def load_from_cache_dir(cls, cache_dir: str | Path) -> "TrustRoot | None":
        """The bootstrap entry point: ``<sigstore-cache-dir>/trust_root.json``
        if present, else None (keyless requirements then fail loudly —
        degraded like the reference's failed TUF fetch, lib.rs:81-89)."""
        p = Path(cache_dir) / "trust_root.json"
        if not p.exists():
            return None
        return cls.load(p)


# ---------------------------------------------------------------------------
# Signature / digest helpers
# ---------------------------------------------------------------------------


def _verify_with_key(
    key: Any,
    signature: bytes,
    data: bytes,
    hash_alg: hashes.HashAlgorithm | None = None,
) -> None:
    """Algorithm-dispatched signature check (ECDSA-P256/SHA256 is the
    sigstore default; Ed25519 and RSA-PKCS1v15 accepted). ``hash_alg``
    overrides SHA-256 when the signature declares its own digest (X.509
    signatures carry it — real Fulcio intermediates sign with SHA-384)."""
    h = hash_alg or hashes.SHA256()
    if isinstance(key, ec.EllipticCurvePublicKey):
        key.verify(signature, data, ec.ECDSA(h))
    elif isinstance(key, Ed25519PublicKey):
        key.verify(signature, data)
    elif isinstance(key, rsa.RSAPublicKey):
        key.verify(signature, data, padding.PKCS1v15(), h)
    else:
        raise KeylessError(f"unsupported key type {type(key).__name__}")


def _canonical(doc: Mapping[str, Any]) -> bytes:
    return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()


def _sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


# ---------------------------------------------------------------------------
# RFC 6962 / 9162 Merkle tree (transparency-log inclusion)
# ---------------------------------------------------------------------------


def leaf_hash(entry: bytes) -> bytes:
    return _sha256(b"\x00" + entry)


def _node_hash(left: bytes, right: bytes) -> bytes:
    return _sha256(b"\x01" + left + right)


def verify_inclusion(
    entry: bytes,
    index: int,
    tree_size: int,
    proof: list[bytes],
    root_hash: bytes,
) -> bool:
    """RFC 9162 §2.1.3.2 inclusion-proof verification."""
    if index < 0 or tree_size <= 0 or index >= tree_size:
        return False
    fn, sn = index, tree_size - 1
    r = leaf_hash(entry)
    for p in proof:
        if sn == 0:
            return False
        if fn % 2 == 1 or fn == sn:
            r = _node_hash(p, r)
            if fn % 2 == 0:
                while not (fn % 2 == 1 or fn == 0):
                    fn >>= 1
                    sn >>= 1
        else:
            r = _node_hash(r, p)
        fn >>= 1
        sn >>= 1
    return sn == 0 and r == root_hash


# ---------------------------------------------------------------------------
# Bundle verification
# ---------------------------------------------------------------------------


@dataclass
class KeylessIdentity:
    """What the verified certificate attests: the OIDC issuer (from the
    Fulcio OID extension) and the SAN subject (email or URI)."""

    issuer: str
    subject: str


def _cert_identity(cert: x509.Certificate) -> KeylessIdentity:
    try:
        ext = cert.extensions.get_extension_for_oid(OID_FULCIO_ISSUER)
        issuer = ext.value.value.decode()  # UnrecognizedExtension bytes
    except x509.ExtensionNotFound:
        raise KeylessError("certificate carries no sigstore issuer extension")
    subject = None
    try:
        san = cert.extensions.get_extension_for_class(
            x509.SubjectAlternativeName
        ).value
        emails = san.get_values_for_type(x509.RFC822Name)
        uris = san.get_values_for_type(x509.UniformResourceIdentifier)
        if emails:
            subject = emails[0]
        elif uris:
            subject = uris[0]
    except x509.ExtensionNotFound:
        pass
    if not subject:
        raise KeylessError("certificate SAN carries no email/URI identity")
    return KeylessIdentity(issuer=issuer, subject=subject)


def _verify_cert_signature(cert: x509.Certificate, issuer: x509.Certificate) -> None:
    _verify_with_key(
        issuer.public_key(),
        cert.signature,
        cert.tbs_certificate_bytes,
        hash_alg=cert.signature_hash_algorithm,
    )


def _valid_at(cert: x509.Certificate, t: _dt.datetime) -> bool:
    return cert.not_valid_before_utc <= t <= cert.not_valid_after_utc


def _build_chain_to_root(
    leaf: x509.Certificate,
    intermediates: list[x509.Certificate],
    trust_root: TrustRoot,
    at: _dt.datetime,
) -> None:
    """Walk issuer links from the leaf up to a trust-root CA, verifying
    every signature and every CA's validity window at the log integration
    time (an expired intermediate must not vouch for fresh leaves).
    Raises KeylessError if no path verifies."""
    # Bound the attacker-supplied search space FIRST: real sigstore
    # bundles carry 1-3 intermediates, and without a cap a crafted bundle
    # of cross-signed same-subject/same-key certificates makes the
    # backtracking walk below combinatorial (each candidate's signature
    # verifies, every path dead-ends late).
    if len(intermediates) > _MAX_CHAIN_LEN * 2:
        raise KeylessError(
            f"certificate chain too long ({len(intermediates)} intermediates)"
        )
    root_fps = {c.fingerprint(hashes.SHA256()) for c in trust_root.fulcio_certs}
    pool = list(intermediates) + list(trust_root.fulcio_certs)

    # Depth-first with backtracking: two pool certificates may share the
    # subject a child names as issuer, and the one whose signature happens
    # to verify first can still lead to a dead end — a greedy walk would
    # then reject a chain whose OTHER candidate reaches the root. `seen`
    # breaks cross-signature cycles; `failed_at` memoizes the shallowest
    # depth at which a certificate dead-ended (failure with budget r
    # implies failure with any budget ≤ r), bounding the walk to
    # O(pool × depth) expansions instead of exponential.
    #
    # Memo soundness (ADVICE r6 #1): a dead end is only PATH-INDEPENDENT
    # when the subtree walk never skipped a candidate via the `seen`
    # ancestor prune. A failure that pruned an ancestor says "this cert
    # fails when X is already on the path" — from a different starting
    # path (valid cross-signed topologies have exactly this shape) the
    # same cert can still reach the root, so memoizing that failure
    # falsely rejected valid chains. ascend() therefore reports whether
    # its subtree was pruned, and only prune-free failures enter the memo.
    #
    # The memo was ALSO the complexity bound, and prune-tainted subtrees
    # now bypass it — a crafted bundle of mutually cross-signed
    # same-subject intermediates could make every failure prune-tainted
    # and the walk combinatorial. A flat expansion budget restores the
    # bound: real chains spend well under pool×depth (≤ ~72) candidate
    # expansions, so exhausting the budget means an adversarial topology
    # and the walk FAILS CLOSED.
    failed_at: dict[bytes, int] = {}
    budget = [512]  # candidate expansions (signature checks) remaining

    def ascend(
        cur: x509.Certificate, depth: int, seen: frozenset
    ) -> tuple[bool, bool]:
        """Returns (reached_root, subtree_pruned): ``subtree_pruned``
        means some candidate in this subtree was skipped because it was
        an ancestor on the current path, making a failure here
        path-dependent and unmemoizable."""
        if depth >= _MAX_CHAIN_LEN:
            return False, False  # pure depth exhaustion: monotonic, safe
        pruned = False
        for cand in pool:
            if cand.subject != cur.issuer:
                continue
            fp = cand.fingerprint(hashes.SHA256())
            if fp in seen:
                pruned = True
                continue
            if depth >= failed_at.get(fp, _MAX_CHAIN_LEN + 1):
                continue
            budget[0] -= 1
            if budget[0] < 0:
                raise KeylessError(
                    "certificate chain walk budget exceeded "
                    "(adversarial cross-signed topology)"
                )
            try:
                _verify_cert_signature(cur, cand)
            except (InvalidSignature, KeylessError):
                continue
            if not _valid_at(cand, at):
                continue
            if fp in root_fps:
                return True, False
            # non-root parent must be a CA
            try:
                bc = cand.extensions.get_extension_for_class(
                    x509.BasicConstraints
                ).value
                if not bc.ca:
                    continue
            except x509.ExtensionNotFound:
                continue
            sub_found, sub_pruned = ascend(cand, depth + 1, seen | {fp})
            if sub_found:
                return True, False
            if sub_pruned:
                pruned = True  # cand might succeed from another path
            else:
                failed_at[fp] = min(failed_at.get(fp, depth), depth)
        return False, pruned

    if not ascend(leaf, 0, frozenset())[0]:
        raise KeylessError(
            "certificate chain does not verify up to a trust-root CA"
        )


def _check_leaf_usage(leaf: x509.Certificate) -> None:
    try:
        eku = leaf.extensions.get_extension_for_class(
            x509.ExtendedKeyUsage
        ).value
        if ExtendedKeyUsageOID.CODE_SIGNING not in eku:
            raise KeylessError("leaf certificate lacks code-signing EKU")
    except x509.ExtensionNotFound:
        raise KeylessError("leaf certificate lacks code-signing EKU")


def verify_keyless_signature(
    entry: Mapping[str, Any],
    trust_root: TrustRoot,
) -> tuple[KeylessIdentity, dict[str, Any]]:
    """The generic keyless core: certificate chain to the trust root,
    signature over the payload, Rekor-style SET + Merkle inclusion, and
    cert validity at integration time. Returns (identity, parsed signed
    payload document) — the CALLER binds the payload to its subject
    (artifact digest for policy bundles, image reference+digest for the
    cosign-style image flavor). Raises KeylessError on any failure.

    Entry schema (the bundle analog):
    ``{"cert": PEM, "chain": [PEM...], "payload": b64, "signature": b64,
    "rekor": {"body": b64, "integratedTime": s, "logIndex": n,
    "logID": hex, "signedEntryTimestamp": b64,
    "checkpoint": {"logSize": n, "rootHash": hex, "signature": b64},
    "inclusionProof": [hex...]}}``
    """
    try:
        leaf = x509.load_pem_x509_certificate(entry["cert"].encode())
        chain = [
            x509.load_pem_x509_certificate(c.encode())
            for c in entry.get("chain") or []
        ]
        payload = base64.b64decode(entry["payload"])
        signature = base64.b64decode(entry["signature"])
        rekor = entry["rekor"]
        body = base64.b64decode(rekor["body"])
        integrated_time = int(rekor["integratedTime"])
        log_index = int(rekor["logIndex"])
        log_id = str(rekor["logID"])
        set_sig = base64.b64decode(rekor["signedEntryTimestamp"])
        checkpoint = rekor["checkpoint"]
        log_size = int(checkpoint["logSize"])
        root_hash = bytes.fromhex(checkpoint["rootHash"])
        checkpoint_sig = base64.b64decode(checkpoint["signature"])
        proof = [bytes.fromhex(h) for h in rekor.get("inclusionProof") or []]
    except (KeyError, TypeError, ValueError) as e:
        raise KeylessError(f"malformed keyless entry: {e}") from e

    # 1. chain of custody: leaf verifies up to a trust-root Fulcio CA,
    # every CA valid at the log integration time
    t = _dt.datetime.fromtimestamp(integrated_time, tz=_dt.timezone.utc)
    _build_chain_to_root(leaf, chain, trust_root, at=t)
    _check_leaf_usage(leaf)

    # 2. signature by the leaf key, over the canonical payload
    try:
        _verify_with_key(leaf.public_key(), signature, payload)
    except InvalidSignature:
        raise KeylessError("signature does not verify against leaf")

    # 3. the payload parses; WHAT it binds is the caller's check
    try:
        pdoc = json.loads(payload)
        if not isinstance(pdoc, dict):
            raise ValueError("payload is not an object")
    except (ValueError, TypeError) as e:
        raise KeylessError(f"malformed signed payload: {e}") from e

    # 4. rekor body binds the payload hash and the signing certificate
    try:
        bdoc = json.loads(body)
        body_payload_hash = bdoc["payloadHash"]
        body_cert_fp = bdoc["certFingerprint"]
    except (ValueError, KeyError, TypeError) as e:
        raise KeylessError(f"malformed rekor body: {e}") from e
    if body_payload_hash != hashlib.sha256(payload).hexdigest():
        raise KeylessError("rekor body does not bind this payload")
    if body_cert_fp != leaf.fingerprint(hashes.SHA256()).hex():
        raise KeylessError("rekor body does not bind the signing certificate")

    # 5. SET: a trust-root rekor key signed {body, time, index, logID}
    set_doc = _canonical(
        {
            "body": base64.b64encode(body).decode(),
            "integratedTime": integrated_time,
            "logID": log_id,
            "logIndex": log_index,
        }
    )
    if not _any_rekor_key_verifies(trust_root, set_sig, set_doc):
        raise KeylessError("signed entry timestamp does not verify")

    # 6. checkpoint + Merkle inclusion of the body in the signed tree head
    cp_doc = _canonical(
        {"logID": log_id, "logSize": log_size, "rootHash": root_hash.hex()}
    )
    if not _any_rekor_key_verifies(trust_root, checkpoint_sig, cp_doc):
        raise KeylessError("log checkpoint signature does not verify")
    if not verify_inclusion(body, log_index, log_size, proof, root_hash):
        raise KeylessError("merkle inclusion proof does not verify")

    # 7. the short-lived cert must have been valid AT INTEGRATION TIME
    if not _valid_at(leaf, t):
        raise KeylessError(
            "certificate was not valid at the log integration time"
        )

    return _cert_identity(leaf), pdoc


def verify_keyless_entry(
    entry: Mapping[str, Any],
    artifact_digest: str,
    trust_root: TrustRoot,
    payload_type: str,
) -> tuple[KeylessIdentity, dict[str, str]]:
    """Policy-artifact flavor: the generic core plus the artifact binding
    (payload type + sha256 digest). Returns the attested identity and the
    SIGNED annotations; callers decide whether the identity satisfies the
    verification.yml requirement."""
    identity, pdoc = verify_keyless_signature(entry, trust_root)
    try:
        signed_digest = pdoc["critical"]["artifact"]["sha256-digest"]
        ptype = pdoc["critical"]["type"]
        annotations = dict(pdoc.get("optional") or {})
    except (ValueError, KeyError, TypeError) as e:
        raise KeylessError(f"malformed signed payload: {e}") from e
    if ptype != payload_type:
        raise KeylessError(f"signed payload type {ptype!r} unexpected")
    if signed_digest != artifact_digest:
        raise KeylessError(
            "signed digest does not match artifact "
            f"({signed_digest} != {artifact_digest})"
        )
    return identity, annotations


def _any_rekor_key_verifies(
    trust_root: TrustRoot, signature: bytes, data: bytes
) -> bool:
    for key in trust_root.rekor_keys:
        try:
            _verify_with_key(key, signature, data)
            return True
        except (InvalidSignature, KeylessError):
            continue
    return False


# ---------------------------------------------------------------------------
# Requirement matching (verification.yml genericIssuer / githubAction)
# ---------------------------------------------------------------------------


def identity_satisfies(req: Any, identity: KeylessIdentity) -> tuple[bool, str]:
    """Does a verified identity satisfy a SignatureRequirement of kind
    genericIssuer or githubAction (config/verification.py)?"""
    if req.kind == "genericIssuer":
        if identity.issuer != req.issuer:
            return False, (
                f"issuer {identity.issuer!r} does not match required "
                f"{req.issuer!r}"
            )
        sub = req.subject
        if sub is not None and not sub.matches(identity.subject):
            return False, (
                f"subject {identity.subject!r} does not match the "
                "configured subject requirement"
            )
        return True, ""
    if req.kind == "githubAction":
        if identity.issuer != GITHUB_ACTIONS_ISSUER:
            return False, (
                f"issuer {identity.issuer!r} is not GitHub Actions"
            )
        want = f"https://github.com/{req.owner}/"
        if req.repo:
            want = f"https://github.com/{req.owner}/{req.repo}/"
        if not identity.subject.startswith(want):
            return False, (
                f"subject {identity.subject!r} is not under {want!r}"
            )
        return True, ""
    return False, f"kind {req.kind!r} is not a keyless requirement"


# ---------------------------------------------------------------------------
# Authoring helpers (test fixtures; NOT used on the serving path)
# ---------------------------------------------------------------------------


def make_test_ca(
    name: str = "sigstore-test-ca",
) -> tuple[x509.Certificate, ec.EllipticCurvePrivateKey]:
    key = ec.generate_private_key(ec.SECP256R1())
    subject = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, name)]
    )
    now = _dt.datetime.now(_dt.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(subject)
        .issuer_name(subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - _dt.timedelta(days=1))
        .not_valid_after(now + _dt.timedelta(days=365))
        .add_extension(x509.BasicConstraints(ca=True, path_length=None), True)
        .sign(key, hashes.SHA256())
    )
    return cert, key


def issue_intermediate_ca(
    parent_cert: x509.Certificate,
    parent_key: ec.EllipticCurvePrivateKey,
    name: str = "sigstore-test-intermediate",
    not_before: _dt.datetime | None = None,
    lifetime_days: int = 365,
) -> tuple[x509.Certificate, ec.EllipticCurvePrivateKey]:
    key = ec.generate_private_key(ec.SECP256R1())
    nb = not_before or (
        _dt.datetime.now(_dt.timezone.utc) - _dt.timedelta(days=1)
    )
    cert = (
        x509.CertificateBuilder()
        .subject_name(x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, name)]))
        .issuer_name(parent_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(nb)
        .not_valid_after(nb + _dt.timedelta(days=lifetime_days))
        .add_extension(x509.BasicConstraints(ca=True, path_length=0), True)
        .sign(parent_key, hashes.SHA256())
    )
    return cert, key


def issue_identity_cert(
    ca_cert: x509.Certificate,
    ca_key: ec.EllipticCurvePrivateKey,
    subject: str,
    issuer_claim: str,
    lifetime_s: int = 600,
    not_before: _dt.datetime | None = None,
) -> tuple[x509.Certificate, ec.EllipticCurvePrivateKey]:
    """A Fulcio-style short-lived identity cert: SAN carries the subject
    (email or URI), the sigstore OID extension carries the OIDC issuer."""
    key = ec.generate_private_key(ec.SECP256R1())
    nb = not_before or (
        _dt.datetime.now(_dt.timezone.utc) - _dt.timedelta(seconds=60)
    )
    san: x509.GeneralName
    if "://" in subject:
        san = x509.UniformResourceIdentifier(subject)
    else:
        san = x509.RFC822Name(subject)
    cert = (
        x509.CertificateBuilder()
        .subject_name(x509.Name([]))
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(nb)
        .not_valid_after(nb + _dt.timedelta(seconds=60 + lifetime_s))
        .add_extension(x509.SubjectAlternativeName([san]), False)
        .add_extension(
            x509.ExtendedKeyUsage([ExtendedKeyUsageOID.CODE_SIGNING]), False
        )
        .add_extension(
            x509.UnrecognizedExtension(
                OID_FULCIO_ISSUER, issuer_claim.encode()
            ),
            False,
        )
        .sign(ca_key, hashes.SHA256())
    )
    return cert, key


def build_toy_log(entries: list[bytes]) -> tuple[bytes, list[list[bytes]]]:
    """RFC 6962 Merkle tree hash + per-entry inclusion paths."""

    def mth(es: list[bytes]) -> bytes:
        if len(es) == 1:
            return leaf_hash(es[0])
        k = 1
        while k * 2 < len(es):
            k *= 2
        return _node_hash(mth(es[:k]), mth(es[k:]))

    def path(m: int, es: list[bytes]) -> list[bytes]:
        if len(es) == 1:
            return []
        k = 1
        while k * 2 < len(es):
            k *= 2
        if m < k:
            return path(m, es[:k]) + [mth(es[k:])]
        return path(m - k, es[k:]) + [mth(es[:k])]

    return mth(entries), [path(i, entries) for i in range(len(entries))]


def make_keyless_entry(
    artifact_bytes: bytes,
    ca_cert: x509.Certificate,
    ca_key: ec.EllipticCurvePrivateKey,
    rekor_key: ec.EllipticCurvePrivateKey,
    subject: str,
    issuer_claim: str,
    payload_type: str,
    annotations: Mapping[str, str] | None = None,
    log_padding: int = 4,
    integrated_time: int | None = None,
    leaf_override: tuple[x509.Certificate, ec.EllipticCurvePrivateKey] | None = None,
    chain_certs: list[x509.Certificate] | None = None,
    payload_override: bytes | None = None,
) -> dict[str, Any]:
    """Authoring/test helper: a complete keyless sidecar entry — leaf cert
    from the CA, signed payload, rekor body + SET + checkpoint + inclusion
    proof from a toy log (the entry sits at a non-trivial index among
    ``log_padding`` synthetic neighbors)."""
    leaf_cert, leaf_key = leaf_override or issue_identity_cert(
        ca_cert, ca_key, subject, issuer_claim
    )
    digest = hashlib.sha256(artifact_bytes).hexdigest()
    if payload_override is not None:
        payload = payload_override
    else:
        payload = _canonical(
            {
                "critical": {
                    "artifact": {"sha256-digest": digest},
                    "type": payload_type,
                },
                "optional": dict(annotations or {}),
            }
        )
    signature = leaf_key.sign(payload, ec.ECDSA(hashes.SHA256()))
    body = _canonical(
        {
            "payloadHash": hashlib.sha256(payload).hexdigest(),
            "certFingerprint": leaf_cert.fingerprint(hashes.SHA256()).hex(),
        }
    )
    neighbors = [
        _canonical({"synthetic": i}) for i in range(max(0, log_padding))
    ]
    entries = neighbors[: log_padding // 2] + [body] + neighbors[log_padding // 2 :]
    index = log_padding // 2
    root, paths = build_toy_log(entries)
    log_id = hashlib.sha256(
        rekor_key.public_key().public_bytes(
            serialization.Encoding.DER,
            serialization.PublicFormat.SubjectPublicKeyInfo,
        )
    ).hexdigest()
    t = integrated_time or int(
        _dt.datetime.now(_dt.timezone.utc).timestamp()
    )
    set_doc = _canonical(
        {
            "body": base64.b64encode(body).decode(),
            "integratedTime": t,
            "logID": log_id,
            "logIndex": index,
        }
    )
    cp_doc = _canonical(
        {"logID": log_id, "logSize": len(entries), "rootHash": root.hex()}
    )
    return {
        "cert": leaf_cert.public_bytes(serialization.Encoding.PEM).decode(),
        "chain": [
            c.public_bytes(serialization.Encoding.PEM).decode()
            for c in (chain_certs or [])
        ],
        "payload": base64.b64encode(payload).decode(),
        "signature": base64.b64encode(signature).decode(),
        "rekor": {
            "body": base64.b64encode(body).decode(),
            "integratedTime": t,
            "logIndex": index,
            "logID": log_id,
            "signedEntryTimestamp": base64.b64encode(
                rekor_key.sign(set_doc, ec.ECDSA(hashes.SHA256()))
            ).decode(),
            "checkpoint": {
                "logSize": len(entries),
                "rootHash": root.hex(),
                "signature": base64.b64encode(
                    rekor_key.sign(cp_doc, ec.ECDSA(hashes.SHA256()))
                ).decode(),
            },
            "inclusionProof": [h.hex() for h in paths[index]],
        },
    }


def make_test_trust_root_doc(
    ca_cert: x509.Certificate, rekor_key: ec.EllipticCurvePrivateKey
) -> dict[str, Any]:
    return {
        "fulcio_certs": [
            ca_cert.public_bytes(serialization.Encoding.PEM).decode()
        ],
        "rekor_keys": [
            rekor_key.public_key()
            .public_bytes(
                serialization.Encoding.PEM,
                serialization.PublicFormat.SubjectPublicKeyInfo,
            )
            .decode()
        ],
    }
