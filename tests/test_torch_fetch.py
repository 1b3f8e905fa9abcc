"""Policy acquisition in the PyTorch port against the JAX package: every
case of ``tests/test_fetch.py`` runs its inputs through both packages (the
same artifacts, the same local registry and HTTPS host) and the two
observations must be equal; then the cases this port adds — the
standard-library client's TLS per host, its redirects and its 401 flow,
fetch retries, the server's resolver and registry client, the fetched
flagship subset served over HTTP, and the resolver's lifetime cache."""

from __future__ import annotations

import base64
import copy
import hashlib
import json
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest

from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

import policy_server_tpu.config.sources as j_sources
import policy_server_tpu.config.verification as j_verification
import policy_server_tpu.fetch as j_fetch
import policy_server_tpu.fetch.downloader as j_downloader
import policy_server_tpu.fetch.verify as j_verify
import policy_server_tpu.failpoints as j_failpoints
import policy_server_tpu.models.policy as j_policy
import policy_server_tpu.ops.compiler as j_compiler
import policy_server_tpu.ops.ir as j_ir
import policy_server_tpu.ops.serde as j_serde
import policy_server_tpu.policies as j_policies
import policy_server_tpu.policies.wasm_oracle as j_wasm_oracle
import policy_server_tpu_torch.config.sources as p_sources
import policy_server_tpu_torch.config.verification as p_verification
import policy_server_tpu_torch.fetch as p_fetch
import policy_server_tpu_torch.fetch.downloader as p_downloader
import policy_server_tpu_torch.fetch.verify as p_verify
import policy_server_tpu_torch.failpoints as p_failpoints
import policy_server_tpu_torch.models.policy as p_policy
import policy_server_tpu_torch.ops.compiler as p_compiler
import policy_server_tpu_torch.ops.ir as p_ir
import policy_server_tpu_torch.ops.serde as p_serde
import policy_server_tpu_torch.policies as p_policies
import policy_server_tpu_torch.policies.wasm_oracle as p_wasm_oracle
from policy_server_tpu_torch import httpclient

import torch_fetch_fixtures as fx

JAX = types.SimpleNamespace(
    name="jax", sources=j_sources, verification=j_verification,
    fetch=j_fetch, downloader=j_downloader, verify=j_verify,
    failpoints=j_failpoints, policy=j_policy, compiler=j_compiler, ir=j_ir,
    serde=j_serde, policies=j_policies, wasm_oracle=j_wasm_oracle,
)
PORT = types.SimpleNamespace(
    name="port", sources=p_sources, verification=p_verification,
    fetch=p_fetch, downloader=p_downloader, verify=p_verify,
    failpoints=p_failpoints, policy=p_policy, compiler=p_compiler, ir=p_ir,
    serde=p_serde, policies=p_policies, wasm_oracle=p_wasm_oracle,
)


def both(case, tmp_path=None):
    """``case(pkg[, dir])`` for the JAX package, then the port: the two
    observations must be equal; returns the port's."""
    out = []
    for pkg in (JAX, PORT):
        if tmp_path is None:
            out.append(case(pkg))
        else:
            d = tmp_path / pkg.name
            d.mkdir(exist_ok=True)
            out.append(_rebase(case(pkg, d), str(d)))
    assert out[0] == out[1], (out[0], out[1])
    return out[1]


def _rebase(obj, d: str):
    """An observation with each side's own directory written ``<dir>``."""
    if isinstance(obj, str):
        return obj.replace(d, "<dir>")
    if isinstance(obj, (list, tuple)):
        return type(obj)(_rebase(o, d) for o in obj)
    if isinstance(obj, dict):
        return {_rebase(k, d): _rebase(v, d) for k, v in obj.items()}
    return obj


def error_of(fn, *args, **kwargs):
    """(exception type name, message) of a raising call, or ("ok", value)."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 — observed, not handled
        return (type(e).__name__, str(e))


def config_for(pkg, policies, **kw):
    """The resolver's config: the JAX ``Config``, or the port's
    ``FetchConfig``."""
    if pkg is JAX:
        from policy_server_tpu.config.config import Config

        return Config(policies=policies, **kw)
    return p_fetch.FetchConfig(**kw)


# -- serde ------------------------------------------------------------------


def sample_exprs(pkg):
    ir = pkg.ir
    IRPath, Elem, DType = ir.Path, ir.Elem, ir.DType
    return [
        ir.eq(IRPath("request.operation"), "CREATE"),
        ir.in_set(IRPath("request.namespace"), ["a", "b"]),
        ir.AnyOf(
            IRPath("request.object.spec.containers"),
            ir.eq(Elem("securityContext.privileged", DType.BOOL), True)
            & ~ir.Exists(Elem("image")),
        ),
        ir.gt(
            ir.CountOf(
                IRPath("request.object.spec.containers"),
                ir.matches_glob(Elem("image"), "*:latest"),
            ),
            0,
        ),
        ir.AllOf(
            IRPath("request.object.metadata.labels"),
            ir.Not(ir.in_set(Elem("__key__"), ["bad"])),
        ),
    ]


def test_serde_roundtrip():
    def case(pkg):
        docs = []
        for expr in sample_exprs(pkg):
            doc = pkg.serde.expr_to_json(expr)
            back = pkg.serde.expr_from_json(json.loads(json.dumps(doc)))
            assert back == expr
            docs.append(doc)
        return docs

    both(case)


def test_serde_setting_refs():
    def case(pkg):
        serde, ir = pkg.serde, pkg.ir
        doc = {
            "op": "in_set",
            "operand": {"op": "path", "path": "request.namespace", "dtype": "id"},
            "values": {"$setting": "denied"},
            "dtype": "id",
        }
        e = serde.expr_from_json(doc, {"denied": ["x", "y"]})
        assert e == ir.in_set(ir.Path("request.namespace"), ["x", "y"])
        with pytest.raises(serde.SettingsBindingError) as exc:
            serde.expr_from_json(doc, {})
        doc["values"] = {"$setting": "denied", "default": ["z"]}
        e2 = serde.expr_from_json(doc, {})
        assert e2 == ir.in_set(ir.Path("request.namespace"), ["z"])
        return [serde.expr_to_json(e), str(exc.value), serde.expr_to_json(e2)]

    both(case)


# -- artifacts --------------------------------------------------------------


def bundle_bytes(pkg, required=()) -> bytes:
    doc = pkg.fetch.dump_artifact(
        "deny-namespaces",
        [
            pkg.compiler.Rule(
                "denied-ns",
                pkg.ir.in_set(pkg.ir.Path("namespace"), ["blocked"]),
                "namespace is blocked",
            )
        ],
        required_settings=tuple(required),
    )
    if required:
        doc["rules"][0]["condition"]["values"] = {"$setting": required[0]}
    return json.dumps(doc).encode()


def test_artifact_bytes_are_the_jax_packages():
    assert bundle_bytes(JAX) == bundle_bytes(PORT)
    assert bundle_bytes(JAX, ("denied",)) == bundle_bytes(PORT, ("denied",))


def test_artifact_load_and_build(tmp_path):
    def case(pkg, d):
        p = d / "pol.tpp.json"
        p.write_bytes(bundle_bytes(pkg))
        module = pkg.fetch.load_artifact(p)
        program = module.build({})
        return (module.name, len(program.rules),
                module.validate_settings({}).valid, module.digest)

    both(case, tmp_path)


def test_artifact_required_settings(tmp_path):
    def case(pkg, d):
        p = d / "pol.tpp.json"
        p.write_bytes(bundle_bytes(pkg, required=("denied",)))
        module = pkg.fetch.load_artifact(p)
        resp = module.validate_settings({})
        return (resp.valid, resp.message,
                module.validate_settings({"denied": ["a"]}).valid)

    assert both(case, tmp_path)[0] is False


def test_artifact_accepts_wasm_with_known_abi(tmp_path):
    def case(pkg, d):
        p = d / "pol.wasm"
        p.write_bytes(pkg.wasm_oracle.oracle_wasm("always-happy"))
        module = pkg.fetch.load_artifact(p)
        bare = d / "bare.wasm"
        bare.write_bytes(b"\x00asm\x01\x00\x00\x00")
        return (module.abi, module.name,
                error_of(pkg.fetch.load_artifact, bare))

    abi, name, err = both(case, tmp_path)
    assert (abi, name) == ("wapc", "pol")
    assert err[0] == "ArtifactError" and "ABI" in err[1]


def test_artifact_minimum_version(tmp_path):
    def case(pkg, d):
        doc = json.loads(bundle_bytes(pkg))
        doc["metadata"]["minimumFrameworkVersion"] = "999.0"
        p = d / "pol.tpp.json"
        p.write_text(json.dumps(doc))
        return error_of(pkg.fetch.load_artifact, p)

    err = both(case, tmp_path)
    assert err[0] == "ArtifactError" and "999.0" in err[1]


# -- signatures -------------------------------------------------------------


def keypair():
    key = Ed25519PrivateKey.generate()
    priv = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )
    pub = key.public_key().public_bytes(
        serialization.Encoding.PEM,
        serialization.PublicFormat.SubjectPublicKeyInfo,
    )
    return priv, pub


KEYS = keypair()
OTHER_KEYS = keypair()


def sidecar_doc(pkg, data: bytes, priv: bytes, annotations=None) -> dict:
    entry = pkg.verify.make_signature_entry(
        priv, data, keyid="k1", annotations=annotations
    )
    return {"signatures": [entry]}


def write_signed(pkg, d: Path, data: bytes, priv: bytes, annotations=None):
    artifact = d / "pol.tpp.json"
    artifact.write_bytes(data)
    (d / "pol.tpp.json.sig.json").write_text(
        json.dumps(sidecar_doc(pkg, data, priv, annotations))
    )
    return artifact


def verification_config(pkg, pub: bytes, annotations=None):
    doc = {
        "apiVersion": "v1",
        "allOf": [
            {
                "kind": "pubKey",
                "owner": "tester",
                "key": pub.decode(),
                **({"annotations": annotations} if annotations else {}),
            }
        ],
    }
    return pkg.verification.VerificationConfig.from_dict(doc)


def test_signature_entries_are_the_jax_packages():
    """Ed25519 is deterministic: both packages sign the same payload
    bytes into the same sidecar entry."""
    data = bundle_bytes(PORT)
    assert sidecar_doc(JAX, data, KEYS[0], {"env": "prod"}) == sidecar_doc(
        PORT, data, KEYS[0], {"env": "prod"}
    )


def test_signature_verification_pass_and_fail(tmp_path):
    def case(pkg, d):
        priv, pub = KEYS
        artifact = write_signed(pkg, d, bundle_bytes(pkg), priv)
        ok = pkg.fetch.verify_artifact(artifact, verification_config(pkg, pub))
        artifact.write_bytes(bundle_bytes(pkg) + b" ")
        tampered = error_of(
            pkg.fetch.verify_artifact, artifact, verification_config(pkg, pub)
        )
        artifact.write_bytes(bundle_bytes(pkg))
        wrong_key = error_of(
            pkg.fetch.verify_artifact, artifact,
            verification_config(pkg, OTHER_KEYS[1]),
        )
        return ok, tampered[0], wrong_key[0]

    digest, tampered, wrong = both(case, tmp_path)
    assert len(digest) == 64
    assert tampered == wrong == "VerificationError"


def test_signature_annotations_must_match(tmp_path):
    def case(pkg, d):
        priv, pub = KEYS
        artifact = write_signed(pkg, d, bundle_bytes(pkg), priv, {"env": "prod"})
        return (
            error_of(pkg.fetch.verify_artifact, artifact,
                     verification_config(pkg, pub, {"env": "prod"}))[0],
            error_of(pkg.fetch.verify_artifact, artifact,
                     verification_config(pkg, pub, {"env": "staging"}))[0],
        )

    assert both(case, tmp_path) == ("ok", "VerificationError")


def test_sidecar_annotations_are_signed(tmp_path):
    def case(pkg, d):
        priv, pub = KEYS
        artifact = write_signed(pkg, d, bundle_bytes(pkg), priv, {"env": "staging"})
        sidecar = d / "pol.tpp.json.sig.json"
        doc = json.loads(sidecar.read_text())
        doc["signatures"][0]["annotations"] = {"env": "prod"}
        sidecar.write_text(json.dumps(doc))
        grafted = error_of(pkg.fetch.verify_artifact, artifact,
                           verification_config(pkg, pub, {"env": "prod"}))
        payload = json.loads(base64.b64decode(doc["signatures"][0]["payload"]))
        payload["optional"] = {"env": "prod"}
        doc["signatures"][0]["payload"] = base64.b64encode(
            json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()
        ).decode()
        sidecar.write_text(json.dumps(doc))
        forged = error_of(pkg.fetch.verify_artifact, artifact,
                          verification_config(pkg, pub, {"env": "prod"}))
        return grafted[0], forged[0]

    assert both(case, tmp_path) == ("VerificationError", "VerificationError")


def test_signature_bound_to_digest_not_reusable(tmp_path):
    def case(pkg, d):
        priv, pub = KEYS
        write_signed(pkg, d, bundle_bytes(pkg), priv)
        other = d / "other.tpp.json"
        other.write_bytes(bundle_bytes(pkg) + b"  ")
        (d / "other.tpp.json.sig.json").write_text(
            (d / "pol.tpp.json.sig.json").read_text()
        )
        return error_of(pkg.fetch.verify_artifact, other,
                        verification_config(pkg, pub))[0]

    assert both(case, tmp_path) == "VerificationError"


def test_downloader_carries_sidecar_to_store(tmp_path):
    def case(pkg, d):
        priv, pub = KEYS
        src_dir = d / "src"
        src_dir.mkdir()
        artifact = write_signed(pkg, src_dir, bundle_bytes(pkg), priv, {"env": "prod"})
        store = d / "store"
        dl = pkg.fetch.Downloader(verification_config=verification_config(pkg, pub))
        url = f"file://{artifact}"
        fetched = dl.download_policies(
            {"p": pkg.policy.parse_policy_entry("p", {"module": url})}, store
        )
        stored = fetched.ok(url)
        assert stored.parent == store
        assert (store / (stored.name + ".sig.json")).exists()
        return (stored.name, pkg.fetch.verify_artifact(
            stored, verification_config(pkg, pub, {"env": "prod"})
        ))

    both(case, tmp_path)


def test_keyless_kinds_fail_loudly(tmp_path):
    def case(pkg, d):
        artifact = write_signed(pkg, d, bundle_bytes(pkg), KEYS[0])
        config = pkg.verification.VerificationConfig.from_dict({
            "apiVersion": "v1",
            "allOf": [{"kind": "githubAction", "owner": "kubewarden"}],
        })
        return error_of(pkg.fetch.verify_artifact, artifact, config)

    err = both(case, tmp_path)
    assert err[0] == "VerificationError"
    assert "'githubAction' requires a sigstore trust root" in err[1]


# -- downloader -------------------------------------------------------------


@pytest.fixture(scope="module")
def registry():
    reg = fx.Registry()
    data = bundle_bytes(PORT)
    reg.publish("kubewarden/policies/deny-ns", "v1.0", data)
    reg.files["/plain/pol.tpp.json"] = data
    yield reg
    reg.stop()


def insecure_sources(pkg, host: str):
    return pkg.sources.Sources(insecure_sources=frozenset({host}))


def test_fetch_file_scheme(tmp_path):
    def case(pkg, d):
        src = d / "pol.tpp.json"
        src.write_bytes(bundle_bytes(pkg))
        dl = pkg.fetch.Downloader()
        path = dl.fetch_policy(f"file://{src}", d / "store")
        again = dl.fetch_policy(f"file://{src}", d / "store")
        assert again == path
        return path.name, path.read_bytes()

    assert both(case, tmp_path)[1] == bundle_bytes(PORT)


def test_fetch_http_scheme(tmp_path, registry):
    def case(pkg, d):
        dl = pkg.fetch.Downloader(sources=insecure_sources(pkg, "127.0.0.1"))
        path = dl.fetch_policy(
            f"http://{registry.netloc}/plain/pol.tpp.json", d / "store"
        )
        return path.name, path.read_bytes()

    assert both(case, tmp_path)[1] == bundle_bytes(PORT)


def test_fetch_registry_scheme_with_token_flow(tmp_path, registry):
    def case(pkg, d):
        dl = pkg.fetch.Downloader(sources=insecure_sources(pkg, registry.netloc))
        path = dl.fetch_policy(
            f"registry://{registry.netloc}/kubewarden/policies/deny-ns:v1.0",
            d / "store",
        )
        return path.name, path.suffix, path.read_bytes()

    name, suffix, data = both(case, tmp_path)
    assert suffix == ".json" and data == bundle_bytes(PORT)


def test_download_policies_collects_errors(tmp_path):
    def case(pkg, d):
        policies = {
            "good": pkg.policy.parse_policy_entry(
                "good", {"module": "builtin://always-happy"}
            ),
            "bad": pkg.policy.parse_policy_entry(
                "bad", {"module": "file:///does/not/exist.tpp.json"}
            ),
        }
        result = pkg.fetch.Downloader().download_policies(policies, d / "store")
        return (sorted(result.fetched),
                {u: str(e) for u, e in result.errors.items()})

    fetched, errors = both(case, tmp_path)
    assert fetched == ["file:///does/not/exist.tpp.json"]
    assert "builtin://always-happy" not in fetched


def test_server_bootstraps_fetched_artifact(tmp_path):
    from policy_server_tpu.evaluation.environment import (
        EvaluationEnvironmentBuilder as JaxBuilder,
    )
    from policy_server_tpu.models import AdmissionReviewRequest as JReview
    from policy_server_tpu.models import ValidateRequest as JRequest
    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder as TorchBuilder,
    )
    from policy_server_tpu_torch.models import AdmissionReviewRequest as TReview
    from policy_server_tpu_torch.models import ValidateRequest as TRequest

    from conftest import build_admission_review_dict

    def case(pkg, d):
        src = d / "pol.tpp.json"
        src.write_bytes(bundle_bytes(pkg))
        policies = {
            "deny-ns": pkg.policy.parse_policy_entry(
                "deny-ns", {"module": f"file://{src}"}
            )
        }
        resolver = pkg.fetch.make_module_resolver(config_for(
            pkg, policies, policies_download_dir=str(d / "store")
        ))
        if pkg is JAX:
            env = JaxBuilder(backend="jax", module_resolver=resolver).build(policies)
            review, request = JReview, JRequest
        else:
            env = TorchBuilder(device="cpu", module_resolver=resolver).build(policies)
            review, request = TReview, TRequest
        out = []
        for ns in ("blocked", "fine"):
            doc = build_admission_review_dict()
            doc["request"]["namespace"] = ns
            req = request.from_admission(review.from_dict(doc).request)
            out.append(env.validate("deny-ns", req).to_dict())
        return out

    blocked, fine = both(case, tmp_path)
    assert blocked["allowed"] is False
    assert blocked["status"]["message"] == "namespace is blocked"
    assert fine["allowed"] is True


def manifest_digest_of(data: bytes) -> str:
    manifest = json.dumps({
        "schemaVersion": 2,
        "layers": [{
            "mediaType": "application/vnd.tpp.policy.v1+json",
            "digest": "sha256:" + hashlib.sha256(data).hexdigest(),
            "size": len(data),
        }],
    }).encode()
    return manifest


def closed_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_manifest_digest_token_auth_flow(registry):
    """As the JAX test, with the unreachable registry a refused local
    port (the JAX test's input is a host name nobody resolves)."""
    unreachable = f"127.0.0.1:{closed_port()}"

    def case(pkg):
        dl = pkg.fetch.Downloader(
            sources=insecure_sources(pkg, registry.netloc),
            retry_sleep=lambda s: None,
        )
        digest = dl.manifest_digest(
            f"{registry.netloc}/kubewarden/policies/deny-ns:v1.0"
        )
        bad = error_of(dl.manifest_digest, f"{unreachable}/nope/nope:v0")
        return digest, bad[0]

    digest, err = both(case)
    manifest = registry.manifest_bytes(bundle_bytes(PORT))
    assert digest == "sha256:" + hashlib.sha256(manifest).hexdigest()
    assert err == "RetryableFetchError"


def test_manifest_digest_header_verified_not_trusted(registry):
    ref = f"{registry.netloc}/kubewarden/policies/deny-ns:v1.0"
    manifest = registry.manifest_bytes(bundle_bytes(PORT))

    def case(pkg):
        dl = pkg.fetch.Downloader(sources=insecure_sources(pkg, registry.netloc))
        computed = dl.manifest_digest(ref)
        out = [computed]
        sha512 = "sha512:" + hashlib.sha512(manifest).hexdigest()
        for header in (computed, "sha256:" + "0" * 64, "nothash:abcdef",
                       "shake_128:abcdef", sha512):
            registry.manifest_headers = {"Docker-Content-Digest": header}
            try:
                out.append(error_of(dl.manifest_digest, ref))
            finally:
                registry.manifest_headers = {}
        return out

    got = both(case)
    computed = got[0]
    assert got[1] == ("ok", computed)
    assert got[2][0] == "FetchError" and "digest mismatch" in got[2][1]
    assert got[3] == got[4] == ("ok", computed)
    assert got[5][1].startswith("sha512:")


# -- what the port adds -----------------------------------------------------


@pytest.fixture(scope="module")
def https_host(tmp_path_factory):
    ca = fx.make_ca("source-ca")
    tls = fx.server_context(tmp_path_factory.mktemp("https-host"), ca)
    host = fx.FileHost(tls)
    host.files["/pol.tpp.json"] = bundle_bytes(PORT)
    yield host, fx.pem_of(ca[1])
    host.stop()


def test_https_source_authority_is_trusted_for_its_host_only(tmp_path, https_host):
    """A CA listed under ``source_authorities`` for a host verifies that
    host's HTTPS; without it the system store refuses the private CA, and
    an insecure source skips verification (both packages)."""
    host, ca_pem = https_host
    url = f"https://{host.netloc}/pol.tpp.json"

    def case(pkg, d):
        Sources = pkg.sources.Sources
        authority = pkg.sources.SourceAuthority(type="Data", data=ca_pem)
        with_ca = Sources(source_authorities={"127.0.0.1": (authority,)})
        other_host = Sources(source_authorities={"localhost": (authority,)})
        insecure = Sources(insecure_sources=frozenset({"127.0.0.1"}))
        out = []
        for sources in (with_ca, other_host, insecure, None):
            dl = pkg.fetch.Downloader(sources=sources, retry_attempts=1)
            got = error_of(dl.fetch_policy, url, d / "store")
            out.append(got[0] if got[0] != "ok" else got[1].read_bytes())
        return out

    ok, other, insecure, system = both(case, tmp_path)
    assert ok == insecure == bundle_bytes(PORT)
    assert other == system == "RetryableFetchError"


@pytest.fixture()
def private_registry(tmp_path):
    """A registry with one repository behind basic auth and blobs behind a
    307 to a storage host that refuses ``Authorization``."""
    reg = fx.Registry()
    data = bundle_bytes(PORT)
    reg.publish("team/basic", "v1", data)
    reg.basic_auth["team/basic"] = "alice:s3cret"
    reg.publish("team/redirected", "v1", data)
    reg.redirect_repos.update({"team/redirected", "team/basic"})
    cfg = fx.docker_config(tmp_path / "config.json", reg.netloc, "alice:s3cret")
    yield reg, cfg
    reg.stop()


def test_authorization_dropped_on_cross_host_redirect(tmp_path, private_registry):
    """A blob's 307 to object storage on another host: the registry's
    Bearer token and basic-auth credentials are not sent there (as
    ``requests`` drops them), so the presigned URL serves the blob."""
    reg, cfg = private_registry

    def case(pkg, d):
        dl = pkg.fetch.Downloader(
            sources=insecure_sources(pkg, reg.netloc),
            docker_config_json_path=str(cfg),
        )
        refusals = reg.storage_refusals
        out = []
        for repo in ("team/redirected", "team/basic"):
            path = dl.fetch_policy(
                f"registry://{reg.netloc}/{repo}:v1", d / "store"
            )
            out.append(path.read_bytes())
        return out, reg.storage_refusals - refusals

    fetched, refusals = both(case, tmp_path)
    assert fetched == [bundle_bytes(PORT)] * 2 and refusals == 0
    assert reg.storage_hits == 4


def test_client_strips_authorization_only_off_host():
    assert httpclient.should_strip_auth("http://a:1/x", "http://b:1/x")
    assert httpclient.should_strip_auth("http://a:1/x", "http://a:2/x")
    assert not httpclient.should_strip_auth("http://a:1/x", "http://a:1/y")
    assert not httpclient.should_strip_auth("http://a/x", "https://a/y")
    import requests.sessions

    session = requests.sessions.Session()
    for old, new in (("http://a:1/x", "http://b:1/x"),
                     ("http://a:1/x", "http://a:2/x"),
                     ("http://a/x", "https://a/y"),
                     ("https://a/x", "http://a/y"),
                     ("http://a:80/x", "http://a/y")):
        assert httpclient.should_strip_auth(old, new) == session.should_strip_auth(
            old, new
        ), (old, new)


def test_basic_auth_missing_is_a_fetch_error(tmp_path, private_registry):
    reg, _cfg = private_registry

    def case(pkg, d):
        dl = pkg.fetch.Downloader(sources=insecure_sources(pkg, reg.netloc))
        return error_of(
            dl.fetch_policy, f"registry://{reg.netloc}/team/basic:v1", d / "s"
        )

    err = both(case, tmp_path)
    assert err[0] == "FetchError" and "HTTP 401" in err[1]


def test_fetch_http_failpoint_retries_are_counted_then_fail(tmp_path, registry):
    """``fetch.http`` faults are retried with backoff and counted, then
    the JAX package's error."""

    def case(pkg, d):
        pkg.failpoints.reset()
        before = pkg.downloader.retry_stats()
        pkg.failpoints.configure("fetch.http=raise:registry down")
        try:
            dl = pkg.fetch.Downloader(
                sources=insecure_sources(pkg, registry.netloc),
                retry_sleep=lambda s: None,
            )
            err = error_of(
                dl.fetch_policy,
                f"registry://{registry.netloc}/kubewarden/policies/deny-ns:v1.0",
                d / "store",
            )
        finally:
            pkg.failpoints.reset()
        after = pkg.downloader.retry_stats()
        return err, {k: after[k] - before[k] for k in after}

    err, counts = both(case, tmp_path)
    assert err[0] == "FetchError" and "registry down" in err[1]
    assert counts == {"attempts": 3, "giveups": 1}


def test_resolver_cache_lives_as_long_as_the_resolver(tmp_path, registry):
    """A URL whose tag moved keeps resolving to the module first fetched
    (both packages: the per-URL cache lives as long as the resolver)."""

    def case(pkg, d):
        ref = f"registry://{registry.netloc}/moving/pol:latest"
        resolver = pkg.fetch.make_module_resolver(config_for(
            pkg, {}, sources=insecure_sources(pkg, registry.netloc),
            policies_download_dir=str(d / "store"),
        ))
        registry.publish("moving/pol", "latest", bundle_bytes(pkg))
        first = resolver(ref).digest
        registry.publish("moving/pol", "latest", bundle_bytes(pkg, ("denied",)))
        second = resolver(ref).digest
        fresh = pkg.fetch.make_module_resolver(config_for(
            pkg, {}, sources=insecure_sources(pkg, registry.netloc),
            policies_download_dir=str(d / "store"),
        ))(ref).digest
        return first == second, first == fresh

    assert both(case, tmp_path) == (True, False)


def test_verification_raises_without_cryptography(tmp_path):
    """Without ``cryptography`` a configured verification raises the JAX
    package's text, and unverified fetching still works (each package in
    a fresh interpreter that cannot import it)."""
    src = tmp_path / "pol.tpp.json"
    src.write_bytes(bundle_bytes(PORT))
    out = {}
    for pkg in ("policy_server_tpu", "policy_server_tpu_torch"):
        code = textwrap.dedent(f"""
            import sys
            sys.modules["cryptography"] = None
            from {pkg}.fetch import Downloader, verify_artifact
            from {pkg}.config.verification import VerificationConfig
            path = Downloader().fetch_policy("file://{src}", __import__("pathlib").Path("{tmp_path}/{pkg}"))
            print(path.read_bytes() == open("{src}", "rb").read())
            cfg = VerificationConfig.from_dict({{"apiVersion": "v1", "allOf": [{{"kind": "pubKey", "key": "k"}}]}})
            try:
                verify_artifact(path, cfg)
            except Exception as e:
                print(type(e).__name__, e)
        """)
        proc = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=120, env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"},
            cwd=str(Path(__file__).resolve().parent.parent),
        )
        assert proc.returncode == 0, proc.stderr
        out[pkg] = proc.stdout
    assert out["policy_server_tpu"] == out["policy_server_tpu_torch"]
    assert out["policy_server_tpu_torch"].splitlines() == [
        "True",
        "VerificationError artifact verification requires the "
        "'cryptography' package",
    ]


def test_config_files_read_json_and_yaml(tmp_path):
    """sources and verification files: JSON needs nothing, YAML goes
    through PyYAML (both equal to the JAX package's reading); without
    PyYAML a YAML file raises a clear error."""
    sources = {"insecure_sources": ["localhost:5000"],
               "source_authorities": {"r.example": [{"type": "Data", "data": "PEM"}]}}
    verification = {"apiVersion": "v1", "allOf": [
        {"kind": "pubKey", "owner": "o", "key": "k"},
        {"kind": "genericIssuer", "issuer": "https://i",
         "subject": {"urlPrefix": "https://github.com/o"}},
    ], "anyOf": {"minimumMatches": 1, "signatures": [
        {"kind": "githubAction", "owner": "kubewarden"}]}}
    (tmp_path / "s.json").write_text(json.dumps(sources))
    (tmp_path / "v.json").write_text(json.dumps(verification))
    (tmp_path / "s.yml").write_text(
        "insecure_sources:\n  - localhost:5000\nsource_authorities:\n"
        "  r.example:\n    - type: Data\n      data: PEM\n"
    )
    for name in ("s.json", "s.yml"):
        assert repr(p_sources.read_sources_file(tmp_path / name)) == repr(
            j_sources.read_sources_file(tmp_path / name)
        )
    assert repr(p_verification.read_verification_file(tmp_path / "v.json")) == repr(
        j_verification.read_verification_file(tmp_path / "v.json")
    )
    code = textwrap.dedent(f"""
        import sys
        sys.modules["yaml"] = None
        from policy_server_tpu_torch.config import read_sources_file
        print(read_sources_file("{tmp_path}/s.json").insecure_sources)
        try:
            read_sources_file("{tmp_path}/s.yml")
        except ValueError as e:
            print(e)
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=str(Path(__file__).resolve().parent.parent),
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "frozenset({'localhost:5000'})"
    assert "is not JSON" in lines[1] and "PyYAML" in lines[1]


# -- the server: resolver, registry client, fetched flagship over HTTP -------


def carried_flagship(pkg) -> dict:
    """The flagship policies whose programs ``serde`` can carry (no
    mutator, context provider, pre-eval hook or host evaluator) → their
    artifact bytes; the others (the signature policies, mutators, groups)
    stay builtins."""
    out = {}
    for name, spec in pkg.policies_flagship().items():
        if "module" not in spec:
            continue
        module = pkg.policies.resolve_builtin(spec["module"])
        program = module.build(spec.get("settings") or {})
        if (program.mutator or program.context_provider
                or program.pre_eval_hook or program.host_evaluator):
            continue
        doc = pkg.fetch.dump_artifact(name, list(program.rules))
        out[name] = json.dumps(doc, sort_keys=True).encode()
    return out


def _jax_flagship():
    from policy_server_tpu.policies.flagship import flagship_policy_specs

    return flagship_policy_specs()


def _port_flagship():
    from policy_server_tpu_torch.policies.flagship import flagship_policy_specs

    return flagship_policy_specs()


JAX.policies_flagship = _jax_flagship
PORT.policies_flagship = _port_flagship


def test_carried_flagship_artifacts_are_the_jax_packages():
    j, p = carried_flagship(JAX), carried_flagship(PORT)
    assert j == p
    assert 12 <= len(p) < len(_port_flagship())


def fetched_flagship_setup(tmp_path, registry_obj, https, ca_pem):
    """Write the carried flagship artifacts, signed, a third each behind
    file://, https:// and registry://; → (specs, sources doc,
    verification doc)."""
    artifacts = carried_flagship(PORT)
    specs = copy.deepcopy(_port_flagship())
    files = tmp_path / "artifacts"
    files.mkdir(exist_ok=True)
    for i, (name, data) in enumerate(sorted(artifacts.items())):
        sidecar = json.dumps(sidecar_doc(PORT, data, KEYS[0])).encode()
        where = i % 3
        if where == 0:
            (files / f"{name}.tpp.json").write_bytes(data)
            (files / f"{name}.tpp.json.sig.json").write_bytes(sidecar)
            url = f"file://{files}/{name}.tpp.json"
        elif where == 1:
            https.files[f"/{name}.tpp.json"] = data
            https.files[f"/{name}.tpp.json.sig.json"] = sidecar
            url = f"https://{https.netloc}/{name}.tpp.json"
        else:
            registry_obj.publish(f"fetched/{name}", "v1", data)
            registry_obj.sign(f"fetched/{name}", data, sidecar)
            url = f"registry://{registry_obj.netloc}/fetched/{name}:v1"
        spec = {k: v for k, v in specs[name].items() if k != "settings"}
        spec["module"] = url
        specs[name] = spec
    sources = {
        "insecure_sources": [registry_obj.netloc],
        "source_authorities": {"127.0.0.1": [{"type": "Data", "data": ca_pem}]},
    }
    verification = {"apiVersion": "v1", "allOf": [
        {"kind": "pubKey", "owner": "tester", "key": KEYS[1].decode()}
    ]}
    return specs, sources, verification


@pytest.fixture(scope="module")
def fetched_trio(tmp_path_factory, registry, https_host):
    """(JAX native, port native, port stdlib) servers over the fetched
    flagship set, each booted through its own resolver."""
    from policy_server_tpu.config.config import Config, TlsConfig
    from policy_server_tpu.runtime import native_frontend as jnf
    from policy_server_tpu.server import PolicyServer as JaxPolicyServer
    from policy_server_tpu_torch.runtime import native_frontend as nf
    from policy_server_tpu_torch.server import PolicyServer

    from test_torch_wasm_server import JaxServerHandle

    tmp = tmp_path_factory.mktemp("fetched-flagship")
    host, ca_pem = https_host
    specs, sources_doc, verification_doc = fetched_flagship_setup(
        tmp, registry, host, ca_pem
    )
    mp = pytest.MonkeyPatch()
    mp.setattr(nf, "server_header", jnf.server_header)
    j_src = j_sources.Sources.from_dict(sources_doc)
    j_ver = j_verification.VerificationConfig.from_dict(verification_doc)
    jax_server = JaxServerHandle(
        specs, None, frontend="native", sources=j_src,
        verification_config=j_ver,
        policies_download_dir=str(tmp / "jax-store"),
    )
    servers = []
    try:
        for frontend in ("native", "python"):
            servers.append(PolicyServer(
                {k: p_policy.parse_policy_entry(k, v) for k, v in specs.items()},
                port=0, readiness_probe_port=0, device="cpu",
                max_batch_size=8, frontend=frontend,
                sources=p_sources.Sources.from_dict(sources_doc),
                verification_config=p_verification.VerificationConfig.from_dict(
                    verification_doc
                ),
                policies_download_dir=str(tmp / f"port-store-{frontend}"),
            ))
            servers[-1].start()
        yield specs, jax_server, servers[0], servers[1]
    finally:
        for s in servers:
            s.stop()
        jax_server.stop()
        mp.undo()


def test_fetched_flagship_over_http_matches_the_jax_server(fetched_trio):
    """The flagship set booted from signed file://, https:// (private CA
    in source_authorities) and registry:// artifacts answers byte for byte
    as the JAX package's server over the same files, on both frontends."""
    from test_torch_native_frontend import exchange, post_bytes
    from torch_port_support import firehose_docs

    specs, jax_server, port_native, port_stdlib = fetched_trio
    fetched = [k for k, v in specs.items() if "builtin://" not in v.get("module", "builtin://")]
    assert len(fetched) >= 12
    for pid in sorted(specs):
        for doc in firehose_docs(6, seed=113):
            payload = post_bytes(f"/validate/{pid}", json.dumps(doc).encode())
            want = exchange(jax_server.port, payload)
            assert exchange(port_native.port, payload) == want, pid
            status, headers, body = exchange(port_stdlib.port, payload)[0]
            assert (status, headers.get("content-type"), body) == (
                want[0][0], want[0][1].get("content-type"), want[0][2]
            ), pid


def test_server_hands_the_registry_client_and_trust_root_to_wasm(tmp_path, registry):
    """The server is the builder's caller for ``wasm_trust_root`` and
    ``wasm_oci_digest_source``: a wasm policy opted into network
    capabilities gets ``oci/v1/manifest_digest`` answered from the local
    registry (no in-band failure), and the trust root loaded from
    ``--sigstore-cache-dir``."""
    from policy_server_tpu_torch.fetch.keyless import (
        make_test_ca,
        make_test_trust_root_doc,
    )
    from policy_server_tpu_torch.server import PolicyServer
    from cryptography.hazmat.primitives.asymmetric import ec

    ca_cert, _ca_key = make_test_ca()
    cache = tmp_path / "sigstore"
    cache.mkdir()
    (cache / "trust_root.json").write_text(json.dumps(
        make_test_trust_root_doc(ca_cert, ec.generate_private_key(ec.SECP256R1()))
    ))
    wasm = tmp_path / "pol.wasm"
    wasm.write_bytes(p_wasm_oracle.oracle_wasm("always-happy"))
    server = PolicyServer(
        {"w": p_policy.parse_policy_entry("w", {
            "module": f"file://{wasm}",
            "settings": {"allowNetworkCapabilities": True},
        })},
        port=0, readiness_probe_port=0, device="cpu", warmup=False,
        sources=insecure_sources(PORT, registry.netloc),
        sigstore_cache_dir=str(cache),
        policies_download_dir=str(tmp_path / "store"),
    )
    server.start()
    try:
        module = server.env._bound["w"].precompiled.module
        assert module.trust_root is not None
        image = f"{registry.netloc}/kubewarden/policies/deny-ns:v1.0"
        from policy_server_tpu_torch.wasm import capabilities

        caps = capabilities.static_capabilities(
            allow_network=True, trust_root=module.trust_root,
            oci_digest_source=module.oci_digest_source,
        )
        answer = json.loads(
            caps[("oci", "v1/manifest_digest")](json.dumps(image).encode())
        )
        manifest = registry.manifest_bytes(bundle_bytes(PORT))
        assert answer == {
            "digest": "sha256:" + hashlib.sha256(manifest).hexdigest()
        }
    finally:
        server.stop()


def test_tampered_artifact_fails_boot_and_continue_on_errors_serves_the_rest(tmp_path):
    """A tampered artifact fails the boot with the JAX package's text;
    under --continue-on-errors its id answers that text as the init error
    and the other policies serve."""
    from policy_server_tpu_torch import __main__ as cli
    from policy_server_tpu.config.config import Config

    data = bundle_bytes(PORT)
    art = tmp_path / "pol.tpp.json"
    art.write_bytes(data + b" ")  # signed below over the untampered bytes
    (tmp_path / "pol.tpp.json.sig.json").write_text(
        json.dumps(sidecar_doc(PORT, data, KEYS[0]))
    )
    (tmp_path / "verification.json").write_text(json.dumps({
        "apiVersion": "v1",
        "allOf": [{"kind": "pubKey", "owner": "t", "key": KEYS[1].decode()}],
    }))
    policies = {"deny": {"module": f"file://{art}"},
                "priv": {"module": "builtin://pod-privileged"}}
    (tmp_path / "policies.json").write_text(json.dumps(policies))
    # the JAX package's text for the same files
    j_resolver = j_fetch.make_module_resolver(Config(
        policies={}, policies_download_dir=str(tmp_path / "store"),
        verification_config=j_verification.read_verification_file(
            tmp_path / "verification.json"
        ),
    ))
    jax_err = error_of(j_resolver, f"file://{art}")
    assert jax_err[0] == "VerificationError"
    base = ["--policies", str(tmp_path / "policies.json"), "--port", "0",
            "--readiness-probe-port", "0", "--device", "cpu", "--no-warmup",
            "--verification-path", str(tmp_path / "verification.json"),
            "--policies-download-dir", str(tmp_path / "store")]
    got = error_of(cli.server_from_args, cli.build_cli().parse_args(base))
    assert got == jax_err
    server = cli.server_from_args(
        cli.build_cli().parse_args(base + ["--continue-on-errors"])
    )
    server.start()
    try:
        from test_torch_native_frontend import exchange, post_bytes
        from torch_port_support import firehose_docs

        doc = firehose_docs(1, seed=5)[0]
        deny = json.loads(exchange(server.port, post_bytes(
            "/validate/deny", json.dumps(doc).encode()))[0][2])
        priv = json.loads(exchange(server.port, post_bytes(
            "/validate/priv", json.dumps(doc).encode()))[0][2])
        assert deny["response"]["allowed"] is False
        assert jax_err[1] in deny["response"]["status"]["message"]
        assert "status" not in priv["response"] or priv["response"]["allowed"] in (
            True, False
        )
        assert server.env._init_errors == {"deny": jax_err[1]}
    finally:
        server.stop()
