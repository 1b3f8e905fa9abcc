"""What a run makes from its seed before the server boots: the image
signature store, the server's TLS identity and the policies file as served.

The signature store is a frozen copy of the port's flagship fixture
(``policies/flagship.py::_signature_fixture`` with ``policies/images.py``'s
bundle format): one ``<sha256(image)>.sig.json`` per signed image, an
Ed25519 signature over a cosign-style payload that binds the image
reference and a manifest digest. Here the key comes from the seed.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import json
import os
from typing import Any

from admission_bench.pods import SIGNED_IMAGES

IMAGE_SIGNATURE_TYPE = "cosign container image signature"
PUBKEY_PLACEHOLDER = "${SIGNATURE_PUBKEY}"
STORE_PLACEHOLDER = "${SIGNATURE_STORE}"


def _seed_bytes(seed: int, what: str) -> bytes:
    return hashlib.sha256(f"admission-bench:{what}:{seed}".encode()).digest()


def signature_payload(image: str, digest: str) -> bytes:
    doc = {
        "critical": {
            "identity": {"docker-reference": image},
            "image": {"docker-manifest-digest": digest},
            "type": IMAGE_SIGNATURE_TYPE,
        },
        "optional": {},
    }
    return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()


def bundle_path(store: str, image: str) -> str:
    return os.path.join(store, hashlib.sha256(image.encode()).hexdigest() + ".sig.json")


def write_signature_store(store: str, seed: int) -> str:
    """Sign ``SIGNED_IMAGES`` with the seed's Ed25519 key into ``store``;
    returns the public key's PEM."""
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey
    from cryptography.hazmat.primitives.serialization import Encoding, PublicFormat

    key = Ed25519PrivateKey.from_private_bytes(_seed_bytes(seed, "signing"))
    os.makedirs(store, exist_ok=True)
    for image in SIGNED_IMAGES:
        digest = "sha256:" + hashlib.sha256(image.encode()).hexdigest()
        payload = signature_payload(image, digest)
        bundle = {"signatures": [{
            "keyid": "",
            "payload": base64.b64encode(payload).decode(),
            "signature": base64.b64encode(key.sign(payload)).decode(),
        }]}
        with open(bundle_path(store, image), "w", encoding="utf-8") as f:
            json.dump(bundle, f)
    return key.public_key().public_bytes(
        Encoding.PEM, PublicFormat.SubjectPublicKeyInfo
    ).decode()


def write_tls_identity(directory: str, seed: int) -> tuple[str, str]:
    """A self-signed P-256 certificate for ``localhost``/127.0.0.1 with
    its key derived from the seed; returns (cert path, key path)."""
    import ipaddress

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    secret = int.from_bytes(_seed_bytes(seed, "tls"), "big") % (2**255) + 1
    key = ec.derive_private_key(secret, ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "policy-server")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name).issuer_name(name).public_key(key.public_key())
        .serial_number(int.from_bytes(_seed_bytes(seed, "serial")[:8], "big") | 1)
        .not_valid_before(now - datetime.timedelta(days=1))
        .not_valid_after(now + datetime.timedelta(days=30))
        .add_extension(x509.SubjectAlternativeName([
            x509.DNSName("localhost"),
            x509.IPAddress(ipaddress.ip_address("127.0.0.1")),
        ]), critical=False)
        .sign(key, hashes.SHA256())
    )
    cert_path = os.path.join(directory, "server.crt")
    key_path = os.path.join(directory, "server.key")
    with open(cert_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    with open(key_path, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        ))
    return cert_path, key_path


def render_policies(spec: Any, pubkey: str, store: str) -> Any:
    """The policies mapping with the run's signature key and store in
    place of their placeholders."""
    if isinstance(spec, dict):
        return {k: render_policies(v, pubkey, store) for k, v in spec.items()}
    if isinstance(spec, list):
        return [render_policies(v, pubkey, store) for v in spec]
    if spec == PUBKEY_PLACEHOLDER:
        return pubkey
    if spec == STORE_PLACEHOLDER:
        return store
    return spec
