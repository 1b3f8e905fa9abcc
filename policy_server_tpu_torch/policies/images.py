"""Host-side container-image signature verification.

Reference parity: the ``verify-image-signatures`` upstream policy asks the
host for sigstore verification of every container image through the
callback channel (SURVEY.md §2.2 callback_handler / sigstore rows). The
TPU-native shape splits that into three stages so the device data path
never blocks on crypto or I/O:

1. **pre-eval hook** (host, per request, bounded by the policy deadline):
   verify every not-yet-cached image reference against the policy's
   configured public keys — real Ed25519 over a cosign-style
   simplesigning payload binding the image reference and its manifest
   digest. Results are cached per image ref, so steady-state traffic is
   pure cache hits.
2. **context provider** (host, pure cache read at encode time): counts the
   request's glob-matched-but-unverified images into the payload's
   ``__context__`` slice.
3. **device rules**: the glob pre-filter plus a batched comparison on the
   provided count — both fuse into the regular predicate program.

Signature transport: with zero registry egress in this environment,
signature bundles are read from a local **signature store** directory
(``signatureStore`` setting / ``KUBEWARDEN_IMAGE_SIGNATURE_STORE``), one
``<sha256(image-ref)>.sig.json`` per image — the hermetic stand-in for
cosign's ``<repo>:sha256-<digest>.sig`` registry tags. The bundle format
mirrors fetch/verify.py's sidecars; an image with no bundle, an unparsable
bundle, or no signature matching a configured key is UNVERIFIED
(fail-closed)."""

from __future__ import annotations

import base64
import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass
from fnmatch import fnmatchcase
from pathlib import Path as FsPath
from typing import Any, Callable, Iterable, Mapping

from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PublicKey
from cryptography.hazmat.primitives.serialization import load_pem_public_key

import logging

logger = logging.getLogger("kubewarden-policy-server")

IMAGE_SIGNATURE_TYPE = "cosign container image signature"
SIGNATURE_STORE_ENV = "KUBEWARDEN_IMAGE_SIGNATURE_STORE"


@dataclass(frozen=True)
class SignatureEntry:
    """One ``signatures[]`` settings entry: which images it covers and the
    keys that must have signed them."""

    image_glob: str
    pub_keys: tuple[str, ...]  # PEM Ed25519 public keys
    annotations: Mapping[str, str]


def signature_bundle_path(store_dir: str, image: str) -> FsPath:
    """Store layout: one bundle per image ref, content-addressed by the
    ref's sha256 (image refs contain '/' and ':')."""
    return FsPath(store_dir) / (
        hashlib.sha256(image.encode()).hexdigest() + ".sig.json"
    )


def file_bundle_source(store_dir: str) -> Callable[[str], Mapping | None]:
    def source(image: str) -> Mapping | None:
        path = signature_bundle_path(store_dir, image)
        if not path.exists():
            return None
        try:
            return json.loads(path.read_text())
        except ValueError as e:
            logger.error("malformed image signature bundle %s: %s", path, e)
            return None

    return source


def make_image_signature_payload(
    image: str, manifest_digest: str, annotations: Mapping[str, str] | None = None
) -> bytes:
    """Canonical cosign-style simplesigning payload: the signature binds
    the image REFERENCE and its manifest DIGEST (and any annotations) under
    one signature, so a bundle cannot be replayed for a different image."""
    doc = {
        "critical": {
            "identity": {"docker-reference": image},
            "image": {"docker-manifest-digest": manifest_digest},
            "type": IMAGE_SIGNATURE_TYPE,
        },
        "optional": dict(annotations or {}),
    }
    return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()


def payload_binds_image(doc: Any, image: str) -> str | None:
    """The shared cosign payload trust boundary for BOTH verify flavors
    (pubKey v1 and keyless v2): a parsed signed payload counts for
    ``image`` only when it carries the cosign signature type, names this
    exact image reference, and pins a real sha256 manifest digest.
    Returns the digest, or None when the payload does not bind."""
    try:
        critical = doc["critical"]
        if critical["type"] != IMAGE_SIGNATURE_TYPE:
            return None
        if critical["identity"]["docker-reference"] != image:
            return None
        digest = str(critical["image"]["docker-manifest-digest"])
    except (ValueError, KeyError, TypeError):
        return None
    if not digest.startswith("sha256:"):
        return None
    return digest


def _entry_verifies(
    entry: SignatureEntry, image: str, bundle: Mapping
) -> bool:
    keys: list[Ed25519PublicKey] = []
    for pem in entry.pub_keys:
        try:
            key = load_pem_public_key(pem.encode())
        except ValueError:
            logger.error("invalid pubKey PEM in verify-image-signatures entry")
            continue
        if isinstance(key, Ed25519PublicKey):
            keys.append(key)
    for sig in bundle.get("signatures") or []:
        try:
            payload = base64.b64decode(sig["payload"])
            signature = base64.b64decode(sig["signature"])
        except (KeyError, TypeError, ValueError):
            continue
        authentic = False
        for key in keys:
            try:
                key.verify(signature, payload)
                authentic = True
                break
            except InvalidSignature:
                continue
        if not authentic:
            continue
        # the signature is authentic for a configured key: bind it to THIS
        # image and check annotations from the SIGNED payload only
        try:
            doc = json.loads(payload)
            if payload_binds_image(doc, image) is None:
                continue
            signed_annotations = dict(doc.get("optional") or {})
        except (ValueError, KeyError, TypeError):
            continue
        if entry.annotations and any(
            signed_annotations.get(k) != v for k, v in entry.annotations.items()
        ):
            continue
        return True
    return False


class ImageSignatureVerifier:
    """Per-policy verifier: glob matching + cached Ed25519 verification.

    Cache policy: positive results are kept for the process lifetime (a
    signature cannot be un-published in this trust model); NEGATIVE results
    expire after ``NEGATIVE_TTL_SECONDS`` so a signature published after an
    image's first sighting is honored without a restart (upstream
    re-verifies per request). The cache is LRU-bounded so unique image
    strings cannot grow server memory without limit."""

    NEGATIVE_TTL_SECONDS = 60.0
    MAX_CACHE_ENTRIES = 65536

    def __init__(
        self,
        entries: Iterable[SignatureEntry],
        bundle_source: Callable[[str], Mapping | None] | None = None,
    ):
        from collections import OrderedDict

        self.entries = tuple(entries)
        if bundle_source is None:
            store = os.environ.get(SIGNATURE_STORE_ENV)
            bundle_source = file_bundle_source(store) if store else None
        self.bundle_source = bundle_source
        # image ref → (verified, cached_at monotonic)
        self._cache: "OrderedDict[str, tuple[bool, float]]" = OrderedDict()  # guarded-by: _lock
        self._lock = threading.Lock()

    def entries_for(self, image: str) -> list[SignatureEntry]:
        return [e for e in self.entries if fnmatchcase(image, e.image_glob)]

    def matched(self, image: str) -> bool:
        return bool(self.entries_for(image))

    def _cached_current(self, image: str) -> bool:  # holds: _lock
        """Lock held: True when the cache answers for this image without
        re-verification (positive, or negative inside its TTL)."""
        hit = self._cache.get(image)
        if hit is None:
            return False
        verified, at = hit
        if not verified and (
            time.monotonic() - at > self.NEGATIVE_TTL_SECONDS
        ):
            return False
        self._cache.move_to_end(image)
        return True

    def all_cached(self, images: Iterable[str]) -> bool:
        """Would ensure() do any blocking work? Used by the batcher's hook
        fast path to skip the hook thread on warm traffic."""
        with self._lock:
            return all(self._cached_current(i) for i in images)

    def ensure(self, images: Iterable[str]) -> None:
        """Verify every image the cache cannot answer for (the blocking
        stage; runs in the pre-eval hook under the request deadline)."""
        for image in images:
            with self._lock:
                if self._cached_current(image):
                    continue
            verified = self._verify(image)
            with self._lock:
                self._cache[image] = (verified, time.monotonic())
                self._cache.move_to_end(image)
                while len(self._cache) > self.MAX_CACHE_ENTRIES:
                    self._cache.popitem(last=False)

    def unverified(self, images: Iterable[str]) -> list[str]:
        """Cache-only read: glob-matched images that did not verify.
        Unknown images count as unverified (fail-closed) — they can only
        be unknown if the hook did not run."""
        out = []
        with self._lock:
            for image in images:
                hit = self._cache.get(image)
                if self.matched(image) and not (hit is not None and hit[0]):
                    out.append(image)
        return out

    def _verify(self, image: str) -> bool:
        entries = self.entries_for(image)
        if not entries:
            return False
        if self.bundle_source is None:
            logger.error(
                "verify-image-signatures: no signature store configured "
                "(set the signatureStore setting or %s); image %r is "
                "treated as unverified", SIGNATURE_STORE_ENV, image,
            )
            return False
        bundle = self.bundle_source(image)
        if bundle is None:
            return False
        return any(_entry_verifies(e, image, bundle) for e in entries)


def extract_container_images(payload: Any) -> list[str]:
    """All container image refs of the request's pod spec (containers,
    initContainers, ephemeralContainers), deduplicated, order-stable.
    Total over arbitrary JSON — a crafted non-mapping object/spec yields
    [] rather than an exception (one malformed request must never fail
    its co-batched neighbors)."""
    if not isinstance(payload, Mapping):
        return []
    obj = payload.get("object")
    spec = obj.get("spec") if isinstance(obj, Mapping) else None
    if not isinstance(spec, Mapping):
        return []
    seen: dict[str, None] = {}
    for key in ("containers", "initContainers", "ephemeralContainers"):
        lst = spec.get(key)
        if not isinstance(lst, (list, tuple)):
            continue
        for c in lst:
            if isinstance(c, Mapping):
                img = c.get("image")
                if isinstance(img, str) and img:
                    seen.setdefault(img, None)
    return list(seen)


# -- authoring/test helpers --------------------------------------------------


def sign_image(
    private_key_pem: bytes,
    image: str,
    manifest_digest: str = "sha256:" + "0" * 64,
    keyid: str = "",
    annotations: Mapping[str, str] | None = None,
) -> dict:
    """Build a signature bundle for an image (test/authoring helper, the
    analog of fetch/verify.py's make_signature_entry)."""
    from cryptography.hazmat.primitives.serialization import (
        load_pem_private_key,
    )

    payload = make_image_signature_payload(image, manifest_digest, annotations)
    key = load_pem_private_key(private_key_pem, password=None)
    signature = key.sign(payload)
    return {
        "signatures": [
            {
                "keyid": keyid,
                "payload": base64.b64encode(payload).decode(),
                "signature": base64.b64encode(signature).decode(),
            }
        ]
    }


def write_signature_bundle(store_dir: str, image: str, bundle: Mapping) -> None:
    path = signature_bundle_path(store_dir, image)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(bundle))
