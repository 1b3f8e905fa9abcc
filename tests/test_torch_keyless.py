"""Offline sigstore-keyless verification in the PyTorch port
(``fetch/keyless.py``) against the JAX package: every case of
``tests/test_keyless.py`` verifies the same canned bundles, chains and
trust roots through both packages, and the outcomes (identity and
annotations, or the error type and text) must be equal. Bundles made by
either package's helpers verify in the other."""

from __future__ import annotations

import base64
import copy
import datetime as dt
import hashlib
import json

import pytest

from cryptography import x509
from cryptography.hazmat.primitives import hashes
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID

import policy_server_tpu.config.verification as j_verification
import policy_server_tpu.fetch.keyless as j_keyless
import policy_server_tpu.fetch.verify as j_verify
import policy_server_tpu_torch.config.verification as p_verification
import policy_server_tpu_torch.fetch.keyless as p_keyless
import policy_server_tpu_torch.fetch.verify as p_verify

ARTIFACT = b"the policy artifact bytes"
DIGEST = hashlib.sha256(ARTIFACT).hexdigest()
SUBJECT = "release@example.com"
ISSUER = "https://issuer.example.com"
PAYLOAD_TYPE = p_verify.SIGNATURE_PAYLOAD_TYPE
SIDES = ((j_keyless, j_verify, j_verification), (p_keyless, p_verify, p_verification))


def outcome(fn, *args, **kwargs):
    try:
        out = fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 — observed
        return (type(e).__name__, str(e))
    if isinstance(out, tuple) and len(out) == 2 and hasattr(out[0], "subject"):
        identity, annotations = out
        return ("ok", identity.subject, identity.issuer, annotations)
    return ("ok", out)


def both(call):
    """``call(keyless, verify, verification)`` on the JAX package, then the
    port: equal outcomes; returns the port's."""
    got = [call(*side) for side in SIDES]
    assert got[0] == got[1], got
    return got[1]


def verify_entry(entry, trust_roots, digest=DIGEST):
    """Both packages' ``verify_keyless_entry`` on one entry (each with its
    own TrustRoot loaded from the same file)."""
    return both(lambda k, v, c: outcome(
        k.verify_keyless_entry, copy.deepcopy(entry), digest,
        trust_roots[k.__name__], PAYLOAD_TYPE,
    ))


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    ca_cert, ca_key = p_keyless.make_test_ca()
    rekor_key = ec.generate_private_key(ec.SECP256R1())
    root_dir = tmp_path_factory.mktemp("sigstore-cache")
    (root_dir / "trust_root.json").write_text(
        json.dumps(p_keyless.make_test_trust_root_doc(ca_cert, rekor_key))
    )
    roots = {
        k.__name__: k.TrustRoot.load_from_cache_dir(root_dir)
        for k, _v, _c in SIDES
    }
    entry = p_keyless.make_keyless_entry(
        ARTIFACT, ca_cert, ca_key, rekor_key,
        subject=SUBJECT, issuer_claim=ISSUER, payload_type=PAYLOAD_TYPE,
        annotations={"env": "prod"},
    )
    return {"ca": (ca_cert, ca_key), "rekor_key": rekor_key, "roots": roots,
            "root_dir": root_dir, "entry": entry}


def test_trust_root_docs_are_the_jax_packages(pki):
    ca_cert, _ = pki["ca"]
    assert j_keyless.make_test_trust_root_doc(
        ca_cert, pki["rekor_key"]
    ) == p_keyless.make_test_trust_root_doc(ca_cert, pki["rekor_key"])


def test_canned_bundle_verifies(pki):
    assert verify_entry(pki["entry"], pki["roots"]) == (
        "ok", SUBJECT, ISSUER, {"env": "prod"}
    )


def test_bundles_made_by_either_package_verify_in_both(pki):
    ca_cert, ca_key = pki["ca"]
    for k, _v, _c in SIDES:
        entry = k.make_keyless_entry(
            ARTIFACT, ca_cert, ca_key, pki["rekor_key"],
            subject=SUBJECT, issuer_claim=ISSUER, payload_type=PAYLOAD_TYPE,
        )
        assert verify_entry(entry, pki["roots"])[0] == "ok"


MUTATIONS = [
    (lambda e: e.update(
        payload=base64.b64encode(json.dumps({
            "critical": {"artifact": {"sha256-digest": "0" * 64},
                         "type": PAYLOAD_TYPE},
            "optional": {}},
            sort_keys=True, separators=(",", ":")).encode()).decode()),
     "signature"),
    (lambda e: e.update(signature=base64.b64encode(
        bytes([base64.b64decode(e["signature"])[0] ^ 1])
        + base64.b64decode(e["signature"])[1:]).decode()),
     "signature"),
    (lambda e: e["rekor"].update(logIndex=e["rekor"]["logIndex"] + 1),
     "timestamp"),
    (lambda e: e["rekor"].update(
        inclusionProof=e["rekor"]["inclusionProof"][:-1]),
     "inclusion"),
    (lambda e: e["rekor"]["checkpoint"].update(rootHash="ab" * 32),
     "checkpoint"),
    (lambda e: e["rekor"].update(
        integratedTime=e["rekor"]["integratedTime"] + 10 * 365 * 86400),
     "chain"),
]


@pytest.mark.parametrize("mutate,expect", MUTATIONS)
def test_tampered_bundles_reject(pki, mutate, expect):
    entry = copy.deepcopy(pki["entry"])
    mutate(entry)
    kind, text = verify_entry(entry, pki["roots"])
    assert kind == "KeylessError" and expect in text.lower(), text


def test_cert_from_foreign_ca_rejects(pki):
    evil_ca, evil_key = p_keyless.make_test_ca("evil-ca")
    entry = p_keyless.make_keyless_entry(
        ARTIFACT, evil_ca, evil_key, pki["rekor_key"],
        subject=SUBJECT, issuer_claim=ISSUER, payload_type=PAYLOAD_TYPE,
    )
    kind, text = verify_entry(entry, pki["roots"])
    assert kind == "KeylessError" and "trust-root" in text


def test_expired_cert_at_integration_time_rejects(pki):
    ca_cert, ca_key = pki["ca"]
    old = dt.datetime.now(dt.timezone.utc) - dt.timedelta(days=30)
    leaf = p_keyless.issue_identity_cert(
        ca_cert, ca_key, SUBJECT, ISSUER, lifetime_s=600, not_before=old
    )
    entry = p_keyless.make_keyless_entry(
        ARTIFACT, ca_cert, ca_key, pki["rekor_key"],
        subject=SUBJECT, issuer_claim=ISSUER, payload_type=PAYLOAD_TYPE,
        leaf_override=leaf,
    )
    kind, text = verify_entry(entry, pki["roots"])
    assert kind == "KeylessError" and "integration time" in text


def requirement(c, doc):
    return c.VerificationConfig.from_dict({"apiVersion": "v1", "allOf": [doc]}).all_of[0]


def test_identity_requirements(pki):
    def call(k, v, c):
        identity, _ = k.verify_keyless_entry(
            copy.deepcopy(pki["entry"]), DIGEST, pki["roots"][k.__name__],
            PAYLOAD_TYPE,
        )
        return [
            k.identity_satisfies(requirement(c, {
                "kind": "genericIssuer", "issuer": issuer,
                "subject": {"equal": SUBJECT}}), identity)
            for issuer in (ISSUER, "https://other")
        ]

    (ok, why), (bad, why2) = both(call)
    assert ok, why
    assert not bad and "issuer" in why2


def test_github_action_requirement(pki):
    ca_cert, ca_key = pki["ca"]
    entry = p_keyless.make_keyless_entry(
        ARTIFACT, ca_cert, ca_key, pki["rekor_key"],
        subject="https://github.com/kubewarden/policy/.github/workflows/release.yml@refs/tags/v1",
        issuer_claim=p_keyless.GITHUB_ACTIONS_ISSUER,
        payload_type=PAYLOAD_TYPE,
    )
    assert j_keyless.GITHUB_ACTIONS_ISSUER == p_keyless.GITHUB_ACTIONS_ISSUER

    def call(k, v, c):
        identity, _ = k.verify_keyless_entry(
            copy.deepcopy(entry), DIGEST, pki["roots"][k.__name__], PAYLOAD_TYPE
        )
        return [
            k.identity_satisfies(requirement(c, doc), identity)
            for doc in (
                {"kind": "githubAction", "owner": "kubewarden", "repo": "policy"},
                {"kind": "githubAction", "owner": "someone-else"},
            )
        ]

    (ok, why), (bad, _) = both(call)
    assert ok, why
    assert not bad


def test_verify_artifact_end_to_end(pki, tmp_path):
    art = tmp_path / "policy.tpp.json"
    (tmp_path / "policy.tpp.json.sig.json").write_text(
        json.dumps({"signatures": [pki["entry"]]})
    )
    doc = {"kind": "genericIssuer", "issuer": ISSUER,
           "subject": {"equal": SUBJECT}}

    def call(k, v, c):
        cfg = c.VerificationConfig.from_dict({"apiVersion": "v1", "allOf": [doc]})
        root = pki["roots"][k.__name__]
        art.write_bytes(ARTIFACT)
        good = outcome(v.verify_artifact, art, cfg, trust_root=root)
        art.write_bytes(ARTIFACT + b"tampered")
        tampered = outcome(v.verify_artifact, art, cfg, trust_root=root)
        art.write_bytes(ARTIFACT)
        rootless = outcome(v.verify_artifact, art, cfg, trust_root=None)
        return good, tampered, rootless

    good, tampered, rootless = both(call)
    assert good == ("ok", DIGEST)
    assert tampered[0] == "VerificationError"
    assert rootless[0] == "VerificationError" and "trust root" in rootless[1]


def test_inclusion_proof_primitive():
    entries = [f"e{i}".encode() for i in range(7)]

    def call(k, v, c):
        root, paths = k.build_toy_log(entries)
        out = []
        for i, e in enumerate(entries):
            out.append(k.verify_inclusion(e, i, len(entries), paths[i], root))
            out.append(k.verify_inclusion(
                e, (i + 1) % 7, len(entries), paths[i], root
            ))
        out.append(k.verify_inclusion(
            entries[0], 0, 7, paths[0], k.leaf_hash(b"x")
        ))
        return root, out

    _root, out = both(call)
    assert out == [True, False] * 7 + [False]


def test_trust_root_absent_is_none(tmp_path):
    assert both(lambda k, v, c: k.TrustRoot.load_from_cache_dir(tmp_path)) is None


def test_intermediate_chain_verifies_and_expired_intermediate_rejects(pki):
    ca_cert, ca_key = pki["ca"]
    good_int, good_key = p_keyless.issue_intermediate_ca(ca_cert, ca_key)
    entry = p_keyless.make_keyless_entry(
        ARTIFACT, good_int, good_key, pki["rekor_key"],
        subject=SUBJECT, issuer_claim=ISSUER, payload_type=PAYLOAD_TYPE,
        chain_certs=[good_int],
    )
    assert verify_entry(entry, pki["roots"])[1] == SUBJECT
    dead_start = dt.datetime.now(dt.timezone.utc) - dt.timedelta(days=400)
    dead_int, dead_key = p_keyless.issue_intermediate_ca(
        ca_cert, ca_key, not_before=dead_start, lifetime_days=30
    )
    entry = p_keyless.make_keyless_entry(
        ARTIFACT, dead_int, dead_key, pki["rekor_key"],
        subject=SUBJECT, issuer_claim=ISSUER, payload_type=PAYLOAD_TYPE,
        chain_certs=[dead_int],
    )
    kind, text = verify_entry(entry, pki["roots"])
    assert kind == "KeylessError" and "trust-root" in text


def _ca(subject, key, issuer_name, issuer_key, path_length=None):
    now = dt.datetime.now(dt.timezone.utc)
    return (
        x509.CertificateBuilder()
        .subject_name(subject)
        .issuer_name(issuer_name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - dt.timedelta(days=1))
        .not_valid_after(now + dt.timedelta(days=365))
        .add_extension(x509.BasicConstraints(ca=True, path_length=path_length), True)
        .sign(issuer_key, hashes.SHA256())
    )


def test_chain_backtracks_over_same_subject_dead_end(pki):
    ca_cert, ca_key = pki["ca"]
    good_int, good_key = p_keyless.issue_intermediate_ca(ca_cert, ca_key)
    orphan_key = ec.generate_private_key(ec.SECP256R1())
    decoy = _ca(
        good_int.subject, good_key,
        x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "orphan-ca")]),
        orphan_key, path_length=0,
    )
    entry = p_keyless.make_keyless_entry(
        ARTIFACT, good_int, good_key, pki["rekor_key"],
        subject=SUBJECT, issuer_claim=ISSUER, payload_type=PAYLOAD_TYPE,
        chain_certs=[decoy, good_int],
    )
    assert verify_entry(entry, pki["roots"])[1] == SUBJECT


def test_cross_signed_cycle_chain_verifies_regardless_of_order(pki):
    ca_cert, ca_key = pki["ca"]
    k_old = ec.generate_private_key(ec.SECP256R1())
    k_new = ec.generate_private_key(ec.SECP256R1())
    s1 = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "cross-signed-ca")])
    a_old = _ca(s1, k_old, ca_cert.subject, ca_key)
    x_no = _ca(s1, k_new, s1, k_old)
    x_on = _ca(s1, k_old, s1, k_new)
    for chain in ([x_on, x_no, a_old], [x_no, x_on, a_old], [a_old, x_on, x_no]):
        entry = p_keyless.make_keyless_entry(
            ARTIFACT, x_no, k_new, pki["rekor_key"],
            subject=SUBJECT, issuer_claim=ISSUER, payload_type=PAYLOAD_TYPE,
            chain_certs=chain,
        )
        assert verify_entry(entry, pki["roots"])[1] == SUBJECT


def test_sha384_signed_chain_verifies(pki, tmp_path):
    key = ec.generate_private_key(ec.SECP384R1())
    subject = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "sha384-ca")])
    now = dt.datetime.now(dt.timezone.utc)
    ca384 = (
        x509.CertificateBuilder()
        .subject_name(subject).issuer_name(subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - dt.timedelta(days=1))
        .not_valid_after(now + dt.timedelta(days=365))
        .add_extension(x509.BasicConstraints(ca=True, path_length=None), True)
        .sign(key, hashes.SHA384())
    )
    (tmp_path / "trust_root.json").write_text(json.dumps(
        p_keyless.make_test_trust_root_doc(ca384, pki["rekor_key"])
    ))
    roots = {k.__name__: k.TrustRoot.load_from_cache_dir(tmp_path)
             for k, _v, _c in SIDES}
    assert j_keyless.OID_FULCIO_ISSUER == p_keyless.OID_FULCIO_ISSUER
    lk = ec.generate_private_key(ec.SECP256R1())
    leaf = (
        x509.CertificateBuilder()
        .subject_name(x509.Name([])).issuer_name(ca384.subject)
        .public_key(lk.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - dt.timedelta(minutes=1))
        .not_valid_after(now + dt.timedelta(minutes=10))
        .add_extension(
            x509.SubjectAlternativeName([x509.RFC822Name(SUBJECT)]), False)
        .add_extension(
            x509.ExtendedKeyUsage([ExtendedKeyUsageOID.CODE_SIGNING]), False)
        .add_extension(
            x509.UnrecognizedExtension(
                p_keyless.OID_FULCIO_ISSUER, ISSUER.encode()
            ), False)
        .sign(key, hashes.SHA384())
    )
    entry = p_keyless.make_keyless_entry(
        ARTIFACT, ca384, key, pki["rekor_key"],
        subject=SUBJECT, issuer_claim=ISSUER, payload_type=PAYLOAD_TYPE,
        leaf_override=(leaf, lk),
    )
    assert verify_entry(entry, roots)[1] == SUBJECT


def test_trust_root_not_an_object_rejects(tmp_path):
    (tmp_path / "trust_root.json").write_text("[]")
    kind, text = both(lambda k, v, c: outcome(
        k.TrustRoot.load_from_cache_dir, tmp_path
    ))
    assert kind == "KeylessError" and "JSON object" in text


def test_malformed_trust_root_degrades_not_crashes(tmp_path, caplog):
    """A corrupt trust_root.json degrades (a warning, keyless disabled) on
    both load paths — the server's shared load and the resolver's own —
    in both packages, and the server boots builtin policies."""
    from policy_server_tpu.config.config import Config
    from policy_server_tpu.fetch import make_module_resolver as j_resolver
    from policy_server_tpu.models.policy import parse_policy_entry
    from policy_server_tpu.server import PolicyServer as JaxPolicyServer
    from policy_server_tpu_torch.fetch import FetchConfig, make_module_resolver
    from policy_server_tpu_torch.models.policy import (
        parse_policy_entry as t_parse_policy_entry,
    )
    from policy_server_tpu_torch.server import PolicyServer

    cache = tmp_path / "sigstore"
    cache.mkdir()
    (cache / "trust_root.json").write_text("{not json")
    config = Config(
        addr="127.0.0.1", port=0, readiness_probe_port=0,
        policies={"ns": parse_policy_entry(
            "ns", {"module": "builtin://pod-privileged"})},
        sources=None, sigstore_cache_dir=str(cache),
        policies_download_dir=str(tmp_path / "store"),
    )
    assert j_resolver(config) is not None
    assert JaxPolicyServer.new_from_config(config).environment is not None
    jax_warnings = [r.getMessage() for r in caplog.records
                    if "trust root" in r.getMessage()]
    caplog.clear()
    assert make_module_resolver(FetchConfig(
        sigstore_cache_dir=str(cache),
        policies_download_dir=str(tmp_path / "store"),
    )) is not None
    server = PolicyServer(
        {"ns": t_parse_policy_entry("ns", {"module": "builtin://pod-privileged"})},
        port=0, readiness_probe_port=0, device="cpu", warmup=False,
        sigstore_cache_dir=str(cache),
    )
    server.start()
    try:
        assert server.env is not None
    finally:
        server.stop()
    port_warnings = [r.getMessage() for r in caplog.records
                     if "trust root" in r.getMessage()]
    assert port_warnings == jax_warnings and len(port_warnings) == 2
