"""Default waPC host capabilities — the guest→host surface of the
reference's callback_handler (SURVEY.md §2.2: K8s context lookups,
sigstore verification, OCI digest, DNS, crypto served to wasm guests over
``__host_call``; src/lib.rs:91-125 wires the same set).

Device-first twist: Kubernetes lookups are answered from the request
payload's ``__context__`` snapshot slice — the SAME capability-filtered,
immutable view the device programs see (context/service.py), so a wasm
guest cannot observe fresher-but-torn cluster state than its co-batched
device rows, and the per-policy contextAwareResources allowlist is
enforced for free (the slice only contains allowlisted kinds).

Capability keys are ``(namespace, operation)`` per the Kubewarden SDK
protocol; payloads are JSON. Network-reaching capabilities (DNS, OCI) are
OPT-IN per policy (``allowNetworkCapabilities: true``) because blocking
egress is invisible to the wasm fuel meter; capabilities that cannot be
served in this environment raise — the guest receives a host error,
never a fabricated answer."""

from __future__ import annotations

import base64
import json
from typing import Any, Callable, Mapping

from policy_server_tpu_torch.context import CONTEXT_KEY

HostCapability = Callable[[bytes], bytes]


def _context_of(payload: Any) -> Mapping[str, Any]:
    if isinstance(payload, Mapping):
        ctx = payload.get(CONTEXT_KEY)
        if isinstance(ctx, Mapping):
            return ctx
    return {}


def _resource_key(api_version: str, kind: str) -> str:
    return f"{api_version}/{kind}"


def _kind_items(ctx: Mapping[str, Any], req: Mapping[str, Any]) -> list:
    key = _resource_key(str(req.get("api_version")), str(req.get("kind")))
    items = ctx.get(key)
    return list(items) if isinstance(items, (list, tuple)) else []


def _matches_label_selector(obj: Mapping[str, Any], selector: str | None) -> bool:
    """equality-based selectors only (k=v,k2!=v2); set-based selectors are
    rejected loudly by the caller."""
    if not selector:
        return True
    labels = ((obj.get("metadata") or {}).get("labels")) or {}
    for clause in selector.split(","):
        clause = clause.strip()
        if "!=" in clause:
            k, v = clause.split("!=", 1)
            if labels.get(k.strip()) == v.strip():
                return False
        elif "=" in clause:
            k, v = clause.split("=", 1)
            if labels.get(k.strip().rstrip("=")) != v.strip():
                return False
        elif clause:
            if clause not in labels:
                return False
    return True


DNS_TIMEOUT_SECONDS = 2.0


def kubernetes_capabilities(payload: Any) -> dict[tuple[str, str], HostCapability]:
    """The payload-dependent entries: Kubernetes lookups answered from the
    request's ``__context__`` snapshot slice (capability-filtered by the
    policy's contextAwareResources allowlist)."""
    ctx = _context_of(payload)

    def list_resources_by_namespace(raw: bytes) -> bytes:
        req = json.loads(raw)
        items = [
            o
            for o in _kind_items(ctx, req)
            if ((o.get("metadata") or {}).get("namespace")) == req.get("namespace")
            and _matches_label_selector(o, req.get("label_selector"))
        ]
        return json.dumps(
            {
                "apiVersion": req.get("api_version"),
                "kind": f"{req.get('kind')}List",
                "items": items,
            }
        ).encode()

    def list_all_resources(raw: bytes) -> bytes:
        req = json.loads(raw)
        items = [
            o
            for o in _kind_items(ctx, req)
            if _matches_label_selector(o, req.get("label_selector"))
        ]
        return json.dumps(
            {
                "apiVersion": req.get("api_version"),
                "kind": f"{req.get('kind')}List",
                "items": items,
            }
        ).encode()

    def get_resource(raw: bytes) -> bytes:
        req = json.loads(raw)
        for o in _kind_items(ctx, req):
            meta = o.get("metadata") or {}
            if meta.get("name") == req.get("name") and (
                req.get("namespace") is None
                or meta.get("namespace") == req.get("namespace")
            ):
                return json.dumps(o).encode()
        raise LookupError(
            f"{req.get('kind')} {req.get('namespace')}/{req.get('name')} "
            "not found in the context snapshot (is the kind in this "
            "policy's contextAwareResources allowlist?)"
        )

    return {
        ("kubernetes", "list_resources_by_namespace"): list_resources_by_namespace,
        ("kubernetes", "list_all_resources"): list_all_resources,
        ("kubernetes", "get_resource"): get_resource,
    }


def static_capabilities(
    signature_bundle_source: Callable[[str], Mapping | None] | None = None,
    allow_network: bool = False,
    trust_root: Any = None,
    oci_digest_source: Callable[[str], str] | None = None,
) -> dict[tuple[str, str], HostCapability]:
    """The payload-independent entries — build ONCE per bound policy.
    Network-reaching capabilities (DNS, OCI) are served only when the
    policy opted in via ``allowNetworkCapabilities: true``: a guest must
    not gain blocking egress (which the fuel meter cannot see) by
    default. ``trust_root`` (fetch/keyless.TrustRoot) enables the
    keyless ``v2/verify`` flavor against cosign-style keyless bundles in
    the signature store; without one it rejects in-band.
    ``oci_digest_source`` (image ref → manifest digest; the server wires
    ``Downloader.manifest_digest``) backs ``oci/v1/manifest_digest`` —
    absent, that capability fails loudly."""

    # -- sigstore verify (pub-key flavor; keyless needs Fulcio/Rekor) -------

    def verify_pub_keys_image(raw: bytes) -> bytes:
        if signature_bundle_source is None:
            raise RuntimeError(
                "image signature verification requires a configured "
                "signature store (signatureStore setting)"
            )
        req = json.loads(raw)
        image = str(req.get("image"))
        from policy_server_tpu_torch.policies.images import (
            SignatureEntry,
            _entry_verifies,
        )

        entry = SignatureEntry(
            image_glob="*",
            pub_keys=tuple(req.get("pub_keys") or ()),
            annotations=dict(req.get("annotations") or {}),
        )
        bundle = signature_bundle_source(image)
        trusted = bool(bundle) and _entry_verifies(entry, image, bundle)
        return json.dumps({"is_trusted": trusted, "digest": ""}).encode()

    def verify_keyless_image(raw: bytes) -> bytes:
        """Keyless image verification against the OFFLINE trust root: the
        signature store's bundle carries cosign-style keyless entries
        (cert + rekor scaffolding) whose signed payload binds the image
        reference and manifest digest; identity must match a requested
        (issuer, subject) pair."""
        if trust_root is None:
            raise RuntimeError(
                "sigstore keyless verification requires a trust root "
                "(place trust_root.json in the sigstore cache dir; "
                "fetching the public Fulcio/Rekor TUF root needs network "
                "egress this build does not have)"
            )
        if signature_bundle_source is None:
            raise RuntimeError(
                "image signature verification requires a configured "
                "signature store (signatureStore setting)"
            )
        from policy_server_tpu_torch.fetch.keyless import (
            KeylessError,
            verify_keyless_signature,
        )
        from policy_server_tpu_torch.policies.images import payload_binds_image

        req = json.loads(raw)
        image = str(req.get("image"))
        wanted = [
            (str(k.get("issuer")), str(k.get("subject")))
            for k in req.get("keyless") or []
            if isinstance(k, Mapping)
        ]
        annotations = dict(req.get("annotations") or {})
        bundle = signature_bundle_source(image) or {}
        for entry in bundle.get("keyless") or []:
            try:
                identity, pdoc = verify_keyless_signature(entry, trust_root)
            except KeylessError:
                continue
            # shared v1/v2 trust boundary: type + reference + real digest
            digest = payload_binds_image(pdoc, image)
            if digest is None:
                continue
            try:
                signed_ann = dict(pdoc.get("optional") or {})
            except (TypeError, ValueError):
                continue
            if annotations and any(
                signed_ann.get(k) != v for k, v in annotations.items()
            ):
                continue
            if (identity.issuer, identity.subject) in wanted:
                return json.dumps(
                    {"is_trusted": True, "digest": digest}
                ).encode()
        return json.dumps({"is_trusted": False, "digest": ""}).encode()

    # -- net ---------------------------------------------------------------

    def dns_lookup_host(raw: bytes) -> bytes:
        if not allow_network:
            raise RuntimeError(
                "network capabilities are not enabled for this policy "
                "(set allowNetworkCapabilities: true in its settings)"
            )
        import socket
        from concurrent.futures import Future

        req = json.loads(raw)
        host = str(req.get("host"))
        # bounded: the resolver blocks outside the fuel meter, so a
        # non-resolving host must not stall the serving thread past the
        # deadline
        import threading

        box: Future = Future()

        def resolve() -> None:
            try:
                box.set_result(socket.gethostbyname_ex(host))
            except BaseException as e:  # noqa: BLE001
                box.set_exception(e)

        threading.Thread(target=resolve, daemon=True).start()
        try:
            _, _, ips = box.result(timeout=DNS_TIMEOUT_SECONDS)
        except TimeoutError:
            raise RuntimeError(f"DNS lookup timed out for {host!r}") from None
        except OSError as e:
            raise RuntimeError(f"DNS lookup failed for {host!r}: {e}") from e
        return json.dumps({"ips": ips}).encode()

    # -- crypto ------------------------------------------------------------

    def is_certificate_trusted(raw: bytes) -> bytes:
        """Validity-window + chain-signature check of a PEM/DER cert
        against the supplied chain (the Kubewarden crypto capability)."""
        import datetime

        from cryptography import x509
        from cryptography.exceptions import InvalidSignature

        req = json.loads(raw)

        def load(doc: Mapping[str, Any]) -> x509.Certificate:
            data = doc.get("data")
            if isinstance(data, list):  # SDK encodes bytes as int arrays
                blob = bytes(data)
            else:
                blob = base64.b64decode(data) if isinstance(data, str) else b""
            if doc.get("encoding") == "Der":
                return x509.load_der_x509_certificate(blob)
            return x509.load_pem_x509_certificate(blob)

        try:
            cert = load(req["cert"])
            chain = [load(c) for c in req.get("cert_chain") or []]
        except (KeyError, ValueError, TypeError) as e:
            return json.dumps(
                {"trusted": False, "reason": f"unparsable certificate: {e}"}
            ).encode()

        now = datetime.datetime.now(datetime.timezone.utc)
        not_after = req.get("not_after")
        if not_after:
            try:
                deadline = datetime.datetime.fromisoformat(
                    str(not_after).replace("Z", "+00:00")
                )
            except ValueError:
                return json.dumps(
                    {"trusted": False, "reason": "invalid not_after"}
                ).encode()
            if cert.not_valid_after_utc < deadline:
                return json.dumps(
                    {"trusted": False,
                     "reason": "certificate expires before not_after"}
                ).encode()
        if not (cert.not_valid_before_utc <= now <= cert.not_valid_after_utc):
            return json.dumps(
                {"trusted": False, "reason": "certificate outside validity window"}
            ).encode()
        # chain of signatures: cert signed by chain[0], chain[i] by chain[i+1]
        current = cert
        for issuer in chain:
            try:
                current.verify_directly_issued_by(issuer)
            except (ValueError, TypeError, InvalidSignature) as e:
                return json.dumps(
                    {"trusted": False, "reason": f"chain verification failed: {e}"}
                ).encode()
            current = issuer
        return json.dumps({"trusted": True, "reason": ""}).encode()

    # -- oci ---------------------------------------------------------------

    def manifest_digest(raw: bytes) -> bytes:
        if not allow_network:
            raise RuntimeError(
                "network capabilities are not enabled for this policy "
                "(set allowNetworkCapabilities: true in its settings)"
            )
        if oci_digest_source is None:
            # no registry client was wired in (library callers outside a
            # server bootstrap) — loud, like the reference without its
            # callback handler's registry sources (src/lib.rs:91-125)
            raise RuntimeError(
                "OCI manifest digest lookup requires registry egress, which "
                "this environment does not have"
            )
        doc = json.loads(raw.decode())
        # the SDK sends a bare JSON string; tolerate {"image": ...} too
        image = doc.get("image") if isinstance(doc, Mapping) else doc
        if not isinstance(image, str) or not image:
            raise RuntimeError(
                "manifest_digest request must carry an image reference"
            )
        try:
            digest = oci_digest_source(image)
        except Exception as e:  # noqa: BLE001 — network failure → in-band
            raise RuntimeError(
                f"manifest digest lookup for {image!r} failed: {e}"
            ) from e
        return json.dumps({"digest": digest}).encode()

    return {
        ("kubewarden", "v1/verify"): verify_pub_keys_image,
        ("kubewarden", "v2/verify"): verify_keyless_image,
        ("net", "v1/dns_lookup_host"): dns_lookup_host,
        ("crypto", "v1/is_certificate_trusted"): is_certificate_trusted,
        ("oci", "v1/manifest_digest"): manifest_digest,
        ("oci", "v1/oci_manifest_digest"): manifest_digest,
    }


def build_default_capabilities(
    payload: Any,
    signature_bundle_source: Callable[[str], Mapping | None] | None = None,
    allow_network: bool = False,
    trust_root: Any = None,
    oci_digest_source: Callable[[str], str] | None = None,
) -> dict[tuple[str, str], HostCapability]:
    """Full table for one request (tests and one-off callers; the serving
    path hoists static_capabilities per policy and merges only the
    kubernetes closures per request)."""
    return {
        **static_capabilities(
            signature_bundle_source, allow_network, trust_root=trust_root,
            oci_digest_source=oci_digest_source,
        ),
        **kubernetes_capabilities(payload),
    }
