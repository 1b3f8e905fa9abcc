"""Shared fixtures of the PyTorch-port differential tests: the same inputs,
made from a seed, go through the JAX package and its PyTorch counterpart
(``policy_server_tpu_torch``), which runs here on the CPU through the
kernels' plain versions."""

from __future__ import annotations

import copy
import dataclasses
import fcntl
import random
from pathlib import Path

import numpy as np
import pytest

from policy_server_tpu.evaluation.environment import (
    EvaluationEnvironmentBuilder as JaxBuilder,
)
from policy_server_tpu.models import AdmissionReviewRequest, ValidateRequest
from policy_server_tpu.models.policy import parse_policy_entry
from policy_server_tpu.policies.flagship import (
    flagship_policy_specs,
    synthetic_firehose,
)
from policy_server_tpu_torch.evaluation.environment import (
    EvaluationEnvironmentBuilder as TorchBuilder,
)
from policy_server_tpu_torch.models import (
    AdmissionReviewRequest as TAdmissionReviewRequest,
)
from policy_server_tpu_torch.models import ValidateRequest as TValidateRequest
from policy_server_tpu_torch.models.policy import (
    parse_policy_entry as t_parse_policy_entry,
)

from test_predicate_opt import FAMILY_CATALOG, review_of


@pytest.fixture(scope="session", autouse=True)
def jax_native_libraries():
    """The JAX package's native libraries (the HTTP frontend, the encoder,
    the wasm core), built and loaded before a test compares against them.

    Their build functions write each library in place under ``build/`` and
    load whatever file is there, so test workers that race to build one can
    load a half-written file; that worker then runs the JAX side without the
    library (its server falls back to the Python frontend). Here every worker
    builds under one file lock, so it finds each file whole or waits for it,
    and a load that failed earlier in the worker is tried again. Raises when
    a library does not build or load. A test module takes the fixture by
    importing it."""
    from policy_server_tpu.ops import fastenc
    from policy_server_tpu.runtime import native_frontend
    from policy_server_tpu.wasm import native_exec

    build = Path(__file__).resolve().parents[1] / "build"
    build.mkdir(exist_ok=True)
    with open(build / ".jax_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for mod in (native_frontend, fastenc, native_exec):
            if mod._build_library() is None:
                raise RuntimeError(f"{mod.__name__}: the library did not build")
            with mod._lib_lock:
                if mod._lib is None:
                    mod._lib_failed = False
            if mod._load() is None:
                raise RuntimeError(f"{mod.__name__}: the library did not load")


def jax_env(specs: dict, **kw):
    return JaxBuilder(backend=kw.pop("backend", "jax"), **kw).build(
        {k: parse_policy_entry(k, v) for k, v in specs.items()}
    )


def torch_env(specs: dict, **kw):
    kw.setdefault("device", "cpu")
    if kw.get("backend") == "oracle":
        kw.pop("device")
    return TorchBuilder(**kw).build(
        {k: t_parse_policy_entry(k, v) for k, v in specs.items()}
    )


def flagship_specs() -> dict:
    return flagship_policy_specs()


def catalog_specs() -> dict:
    return dict(FAMILY_CATALOG)


def widen(doc: dict, n_containers: int = 12) -> dict:
    """A copy of a firehose review whose arrays overflow the small schema
    bucket's caps (8 elements), so it encodes into the large bucket."""
    doc = copy.deepcopy(doc)
    pod = doc["request"]["object"]
    base = pod["spec"]["containers"]
    pod["spec"]["containers"] = [
        dict(base[i % len(base)], name=f"c{i}") for i in range(n_containers)
    ]
    return doc


def firehose_docs(n: int, seed: int, wide_every: int = 3) -> list[dict]:
    """Firehose reviews; every ``wide_every``-th one widened to the large
    bucket."""
    docs = synthetic_firehose(n, seed=seed)
    return [
        widen(d) if wide_every and i % wide_every == 0 else d
        for i, d in enumerate(docs)
    ]


def catalog_docs(n: int, seed: int) -> list[dict]:
    docs = firehose_docs(n, seed)
    extra_objs = [
        {"kind": "Pod", "apiVersion": "v1",
         "metadata": {"name": "lab", "labels": {"cost-center": "x"}},
         "spec": {}},
        {"kind": "Deployment", "apiVersion": "apps/v1",
         "metadata": {"name": "big"}, "spec": {"replicas": 9}},
        {"kind": "Pod", "apiVersion": "v1", "metadata": {"name": "sy"},
         "spec": {"securityContext": {
             "sysctls": [{"name": "kernel.msgmax", "value": "1"}]}}},
        {"kind": "Pod", "apiVersion": "v1", "metadata": {"name": "hp"},
         "spec": {"volumes": [{"name": "v",
                               "hostPath": {"path": "/etc/shadow"}}]}},
    ]
    return docs + [review_of(o) for o in extra_objs]


def items_for(docs: list[dict], policy_ids: list[str], seed: int):
    """(policy id, JAX request, torch request) triples: each doc addressed
    to a policy id drawn from a seeded generator."""
    rng = random.Random(seed)
    out = []
    for d in docs:
        pid = rng.choice(policy_ids)
        out.append((
            pid,
            ValidateRequest.from_admission(
                AdmissionReviewRequest.from_dict(copy.deepcopy(d)).request
            ),
            TValidateRequest.from_admission(
                TAdmissionReviewRequest.from_dict(copy.deepcopy(d)).request
            ),
        ))
    return out


def export_state(jenv) -> tuple[list[str], list[dict]]:
    """The JAX environment's intern table (strings in id order) and packed
    layouts, as plain data."""
    return (
        list(jenv.table.strings()),
        [dataclasses.asdict(s.packed_layout()) for s in jenv.schemas],
    )


def sync_envs(jenv, tenv, docs: list[dict]) -> None:
    """Give both environments one intern table: the JAX table first takes
    the torch table's strings (the string constants its tapes interned at
    build, in id order) and the documents' strings, then the torch
    environment installs the JAX state. No JAX program is traced."""
    for s in tenv.table.strings():
        jenv.table.intern(s)
    for d in docs:
        jenv.encode_bucketed(
            AdmissionReviewRequest.from_dict(copy.deepcopy(d)).request.to_dict()
        )
    strings, layouts = export_state(jenv)
    tenv.install_reference_state(strings, layouts)


def packed_batches(jenv, docs: list[dict], batch: int) -> dict[int, np.ndarray]:
    """schema index → the wide packed batch the JAX environment encodes
    for the docs that fall in that bucket (padded to ``batch`` rows; a
    bucket no doc reaches gets an all-missing batch)."""
    per: dict[int, list] = {i: [] for i in range(len(jenv.schemas))}
    for d in docs:
        payload = AdmissionReviewRequest.from_dict(
            copy.deepcopy(d)
        ).request.to_dict()
        idx, enc = jenv.encode_bucketed(payload)
        if len(per[idx]) < batch:
            per[idx].append(enc)
    out = {}
    for idx, encs in per.items():
        schema = jenv.schemas[idx]
        if encs:
            out[idx] = schema.pack(schema.stack(encs, batch_size=batch))[
                "__packed__"
            ]
        else:
            out[idx] = schema.empty_batch_packed(batch)["__packed__"]
    return out


def buffer_forms(jenv, idx: int, wide: np.ndarray) -> dict[str, np.ndarray]:
    """The three forms of one wide packed batch, as the JAX codec makes
    them."""
    schema = jenv.schemas[idx]
    key = "__packed__"
    return {
        "wide": wide,
        "transport": schema.to_transport({key: wide})[key],
        "narrow": schema.to_transport(
            {key: wide}, vocab_size=len(jenv.table)
        )[key],
    }


FORM_FLAGS = {
    "wide": (False, False),
    "transport": (True, False),
    "narrow": (True, True),
}


def response_dicts(results) -> list:
    return [
        r.to_dict() if not isinstance(r, Exception) else repr(r)
        for r in results
    ]


# -- the audit subsystem's two sides -------------------------------------------


def audit_sides():
    """(JAX, PORT): namespaces of each package's audit-related modules and
    types, so one scenario runs unchanged through either (the JAX side's
    environments on its ``jax`` backend, the port's on the CPU)."""
    from types import SimpleNamespace

    from policy_server_tpu import audit as jaudit
    from policy_server_tpu import failpoints as jfp
    from policy_server_tpu.api.service import RequestOrigin as JOrigin
    from policy_server_tpu.evaluation.environment import bucket_size as jbucket
    from policy_server_tpu.models import AdmissionResponse as JResponse
    from policy_server_tpu.runtime import shards as jshards
    from policy_server_tpu.runtime.batcher import MicroBatcher as JBatcher
    from policy_server_tpu_torch import audit as taudit
    from policy_server_tpu_torch import failpoints as tfp
    from policy_server_tpu_torch.api.service import RequestOrigin as TOrigin
    from policy_server_tpu_torch.evaluation.environment import (
        bucket_size as tbucket,
    )
    from policy_server_tpu_torch.models import AdmissionResponse as TResponse
    from policy_server_tpu_torch.runtime import shards as tshards
    from policy_server_tpu_torch.runtime.batcher import MicroBatcher as TBatcher

    jax_side = SimpleNamespace(
        name="jax", audit=jaudit, fp=jfp, Batcher=JBatcher, origin=JOrigin,
        Review=AdmissionReviewRequest, ValidateRequest=ValidateRequest,
        Response=JResponse, parse=parse_policy_entry, bucket_size=jbucket,
        shards=jshards,
        env=lambda specs, **kw: JaxBuilder(backend="jax", **kw).build(
            {k: parse_policy_entry(k, v) for k, v in specs.items()}
        ),
    )
    port_side = SimpleNamespace(
        name="port", audit=taudit, fp=tfp, Batcher=TBatcher, origin=TOrigin,
        Review=TAdmissionReviewRequest, ValidateRequest=TValidateRequest,
        Response=TResponse, parse=t_parse_policy_entry, bucket_size=tbucket,
        shards=tshards,
        env=lambda specs, **kw: TorchBuilder(device="cpu", **kw).build(
            {k: t_parse_policy_entry(k, v) for k, v in specs.items()}
        ),
    )
    return jax_side, port_side


def pod_doc(
    name: str = "p",
    namespace: str = "default",
    privileged: bool = False,
    operation: str = "CREATE",
    uid: str | None = None,
) -> dict:
    """``tests/test_audit.py``'s pod review, as a document."""
    from conftest import build_admission_review_dict

    doc = build_admission_review_dict()
    doc["request"]["uid"] = uid or f"uid-{namespace}-{name}"
    doc["request"]["name"] = name
    doc["request"]["namespace"] = namespace
    doc["request"]["operation"] = operation
    doc["request"]["kind"] = {"group": "", "version": "v1", "kind": "Pod"}
    doc["request"]["object"] = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {
            "containers": [
                {
                    "name": "c",
                    "image": "nginx",
                    "securityContext": {"privileged": privileged},
                }
            ]
        },
    }
    return doc


def side_request(side, doc: dict):
    """A document → that side's ValidateRequest."""
    return side.ValidateRequest.from_admission(
        side.Review.from_dict(copy.deepcopy(doc)).request
    )


def pod_review(side, *args, **kwargs):
    return side_request(side, pod_doc(*args, **kwargs))


def report_view(body: dict) -> dict:
    """An audit reports payload without its clock readings (each row's
    ``scanned_at``, the scanner's ``freshness_seconds``)."""
    body = copy.deepcopy(body)
    for row in body.get("reports", ()):
        row.pop("scanned_at", None)
    scanner = body.get("scanner")
    if scanner is not None:
        scanner.pop("freshness_seconds", None)
    return body


def result_view(results) -> list:
    """Audit-lane results as comparable data."""
    return [
        repr(r) if isinstance(r, Exception) else r.to_dict() for r in results
    ]


# -- TLS material and a JAX server in a thread ---------------------------------


def make_cert(cn: str, issuer=None, is_ca: bool = False, days: int = 1):
    """(key, certificate) made with ``cryptography``: self-signed, or signed
    by ``issuer`` = (key, certificate). Each call has a new random
    serial."""
    import datetime
    import ipaddress

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    subject = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])
    issuer_key, issuer_cert = issuer if issuer is not None else (key, None)
    now = datetime.datetime.now(datetime.timezone.utc).replace(microsecond=0)
    cert = (
        x509.CertificateBuilder()
        .subject_name(subject)
        .issuer_name(issuer_cert.subject if issuer_cert is not None else subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(
            x509.BasicConstraints(ca=is_ca, path_length=None), critical=True
        )
        .add_extension(
            x509.SubjectAlternativeName([
                x509.DNSName("localhost"),
                x509.IPAddress(ipaddress.ip_address("127.0.0.1")),
            ]),
            critical=False,
        )
        .sign(issuer_key, hashes.SHA256())
    )
    return key, cert


def cert_pem(cert) -> bytes:
    from cryptography.hazmat.primitives import serialization

    return cert.public_bytes(serialization.Encoding.PEM)


def key_pem(key) -> bytes:
    from cryptography.hazmat.primitives import serialization

    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )


def write_identity(directory, stem: str, key, cert) -> tuple[str, str]:
    """Write ``stem.crt`` and ``stem.key`` → their paths."""
    cert_path = directory / f"{stem}.crt"
    key_path = directory / f"{stem}.key"
    cert_path.write_bytes(cert_pem(cert))
    key_path.write_bytes(key_pem(key))
    return str(cert_path), str(key_path)


def tls_material(directory) -> dict:
    """A server identity, a client CA with a client it issued, and a
    client issued by another CA, written under ``directory``."""
    server = make_cert("original")
    ca = make_cert("client-ca", is_ca=True)
    good = make_cert("good-client", issuer=ca)
    other_ca = make_cert("other-ca", is_ca=True)
    bad = make_cert("bad-client", issuer=other_ca)
    out = {}
    out["cert"], out["key"] = write_identity(directory, "server", *server)
    out["good_cert"], out["good_key"] = write_identity(directory, "good", *good)
    out["bad_cert"], out["bad_key"] = write_identity(directory, "bad", *bad)
    ca_path = directory / "ca.crt"
    ca_path.write_bytes(cert_pem(ca[1]))
    out["ca"] = str(ca_path)
    out["serial"] = server[1].serial_number
    return out


def client_context(certfile=None, keyfile=None):
    """A TLS client context that trusts any server (the tests compare what
    is served, not who serves it), presenting a client certificate when
    given one."""
    import ssl

    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    if certfile:
        ctx.load_cert_chain(certfile, keyfile)
    return ctx


def peer_serial(sock) -> int:
    """The serial number of the certificate a TLS socket's server sent."""
    from cryptography import x509

    return x509.load_der_x509_certificate(
        sock.getpeercert(binary_form=True)
    ).serial_number


class JaxServer:
    """The JAX package's PolicyServer, built from ``Config(**config)`` with
    ``specs``, inside a private event-loop thread (``run`` schedules a
    coroutine there)."""

    def __init__(self, specs: dict, **config) -> None:
        import asyncio
        import threading

        from policy_server_tpu.config.config import Config, TlsConfig
        from policy_server_tpu.server import PolicyServer as JaxPolicyServer

        config.setdefault("tls_config", TlsConfig())
        self.server = JaxPolicyServer.new_from_config(Config(
            addr="127.0.0.1", port=0, readiness_probe_port=0,
            policies={k: parse_policy_entry(k, v) for k, v in specs.items()},
            **dict(dict(max_batch_size=8, batch_timeout_ms=1.0), **config),
        ))
        self.loop = asyncio.new_event_loop()
        started = threading.Event()

        def run() -> None:
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.server.start())
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(timeout=120), "JAX server failed to start"

    @property
    def port(self) -> int:
        return self.server.api_port

    @property
    def readiness_port(self) -> int:
        return self.server.readiness_port

    def run(self, coro, timeout: float = 60):
        import asyncio

        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def stop(self) -> None:
        async def shutdown():
            await self.server.stop()
            self.loop.stop()

        import asyncio

        asyncio.run_coroutine_threadsafe(shutdown(), self.loop)
        self.thread.join(timeout=30)
        rel = getattr(self.server.tls_context, "_reloadable", None)
        if rel is not None:
            rel.stop()
