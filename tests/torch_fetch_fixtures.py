"""In-process servers for the acquisition and cluster-context tests and
for ``chip_smoke.py``: an OCI registry (anonymous token flow, basic auth,
a blob behind a 307 to a storage host that refuses ``Authorization``), an
HTTPS file host, and a fake Kubernetes API server (``/version``, LIST
with a ``resourceVersion``, chunked watch streams with 410 expiry).

Imports only the standard library and ``cryptography`` (for the
certificates), never JAX or either policy package, so the script on the
card can use it."""

from __future__ import annotations

import base64
import datetime
import hashlib
import http.server
import ipaddress
import json
import ssl
import threading
import urllib.parse
from pathlib import Path
from typing import Any, Iterable

TOKEN = "tok123"


# -- certificates -----------------------------------------------------------


def make_ca(cn: str = "test-ca"):
    """(key, certificate) of a self-signed CA."""
    return _make_cert(cn, None, is_ca=True)


def issue_server_cert(ca, cn: str = "localhost"):
    """(key, certificate) for 127.0.0.1 and localhost, signed by ``ca``."""
    return _make_cert(cn, ca, is_ca=False)


def _make_cert(cn: str, issuer, is_ca: bool):
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
        .not_valid_after(now + datetime.timedelta(days=1))
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


def pem_of(cert) -> str:
    from cryptography.hazmat.primitives import serialization

    return cert.public_bytes(serialization.Encoding.PEM).decode()


def server_context(directory: Path, ca, stem: str = "server") -> ssl.SSLContext:
    """A server-side TLS context for a certificate ``ca`` issues, its files
    written under ``directory``."""
    from cryptography.hazmat.primitives import serialization

    key, cert = issue_server_cert(ca)
    directory.mkdir(parents=True, exist_ok=True)
    crt, kfile = directory / f"{stem}.crt", directory / f"{stem}.key"
    crt.write_text(pem_of(cert))
    kfile.write_bytes(key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    ))
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(str(crt), str(kfile))
    return ctx


# -- a threaded server ------------------------------------------------------


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    request_queue_size = 256


class Served:
    """A ``ThreadingHTTPServer`` on 127.0.0.1 in a daemon thread, over TLS
    when given a context; ``stop()`` shuts it down."""

    def __init__(self, handler: type, tls: ssl.SSLContext | None = None):
        self.httpd = _Server(("127.0.0.1", 0), handler)
        self.httpd.owner = self
        if tls is not None:
            self.httpd.socket = tls.wrap_socket(
                self.httpd.socket, server_side=True
            )
        self.thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self.thread.start()

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def netloc(self) -> str:
        return f"127.0.0.1:{self.port}"

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):  # silence
        pass

    @property
    def owner(self) -> Any:
        return self.server.owner

    def send_body(
        self, status: int, body: bytes, ctype: str = "application/json",
        headers: dict | None = None,
    ) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)


# -- the OCI registry -------------------------------------------------------


def media_type_of(data: bytes) -> str:
    return (
        "application/vnd.wasm.content.layer.v1+wasm"
        if data[:4] == b"\x00asm" else "application/vnd.tpp.policy.v1+json"
    )


class _RegistryHandler(_Handler):
    def do_GET(self):  # noqa: N802 — http.server's name
        reg: Registry = self.owner.registry
        reg.count(self)
        path = urllib.parse.urlsplit(self.path).path
        if path in reg.files:
            self.send_body(200, reg.files[path], "application/octet-stream")
            return
        if path == "/token":
            self.send_body(200, json.dumps({"token": TOKEN}).encode())
            return
        if not path.startswith("/v2/"):
            self.send_body(404, b"{}")
            return
        rest = path[len("/v2/"):]
        if "/manifests/" in rest:
            repo, _, tag = rest.partition("/manifests/")
        elif "/blobs/" in rest:
            repo, _, tag = rest.partition("/blobs/")
        else:
            self.send_body(404, b"{}")
            return
        if not reg.authorized(repo, self.headers.get("Authorization", "")):
            host = self.headers["Host"]
            challenge = (
                f'Basic realm="{host}"' if repo in reg.basic_auth
                else f'Bearer realm="http://{host}/token",'
                     f'service="registry",scope="repository:{repo}:pull"'
            )
            self.send_body(401, b"{}", headers={"WWW-Authenticate": challenge})
            return
        if "/manifests/" in rest:
            blob = reg.repos.get(repo, {}).get(tag)
            if blob is None:
                self.send_body(404, b"{}")
                return
            manifest = reg.manifest_bytes(blob)
            self.send_body(
                200, manifest, "application/vnd.oci.image.manifest.v1+json",
                headers=reg.manifest_headers,
            )
            return
        blob = reg.blobs.get(tag)
        if blob is None:
            self.send_body(404, b"{}")
            return
        if repo in reg.redirect_repos and reg.storage is not None:
            where = f"http://{reg.storage.netloc}/blob/{tag}"
            self.send_body(307, b"", headers={"Location": where})
            return
        self.send_body(200, blob, "application/octet-stream")


class _StorageHandler(_Handler):
    """Object storage behind a presigned URL: a request that carries
    ``Authorization`` is refused, as S3 and GCS refuse one."""

    def do_GET(self):  # noqa: N802
        reg: Registry = self.owner.registry
        if self.headers.get("Authorization"):
            reg.storage_refusals += 1
            self.send_body(400, b"Authorization header on a presigned URL")
            return
        digest = urllib.parse.urlsplit(self.path).path.rsplit("/", 1)[-1]
        blob = reg.blobs.get(digest)
        if blob is None:
            self.send_body(404, b"")
            return
        reg.storage_hits += 1
        self.send_body(200, blob, "application/octet-stream")


class Registry:
    """An OCI registry on plain HTTP (list it in ``insecure_sources``).

    ``publish(repo, tag, data)`` serves ``data`` as the only layer of
    ``repo:tag``; ``sign(repo, data, sidecar)`` publishes a detached
    signature document at the cosign tag ``sha256-<digest>.sig``.
    Anonymous repositories answer 401 with a Bearer challenge until the
    token is presented; ``basic_auth[repo] = "user:pass"`` asks for basic
    auth instead; blobs of ``redirect_repos`` answer 307 to a second
    server (``storage``) that refuses a request carrying
    ``Authorization``. ``files`` maps a path to bytes for plain GETs."""

    def __init__(self, tls: ssl.SSLContext | None = None) -> None:
        self.repos: dict[str, dict[str, bytes]] = {}
        self.blobs: dict[str, bytes] = {}
        self.files: dict[str, bytes] = {}
        self.basic_auth: dict[str, str] = {}
        self.redirect_repos: set[str] = set()
        self.manifest_headers: dict[str, str] = {}
        self.storage_refusals = 0
        self.storage_hits = 0
        self.requests = 0
        self._lock = threading.Lock()
        self.server = Served(_RegistryHandler, tls)
        self.server.registry = self
        self.storage = Served(_StorageHandler)
        self.storage.registry = self

    @property
    def netloc(self) -> str:
        return self.server.netloc

    def count(self, _handler) -> None:
        with self._lock:
            self.requests += 1

    def publish(self, repo: str, tag: str, data: bytes) -> str:
        digest = "sha256:" + hashlib.sha256(data).hexdigest()
        self.blobs[digest] = data
        self.repos.setdefault(repo, {})[tag] = data
        return digest

    def sign(self, repo: str, data: bytes, sidecar: bytes) -> None:
        self.publish(repo, f"sha256-{hashlib.sha256(data).hexdigest()}.sig",
                     sidecar)

    def manifest_bytes(self, blob: bytes) -> bytes:
        return json.dumps({
            "schemaVersion": 2,
            "layers": [{
                "mediaType": media_type_of(blob),
                "digest": "sha256:" + hashlib.sha256(blob).hexdigest(),
                "size": len(blob),
            }],
        }).encode()

    def authorized(self, repo: str, header: str) -> bool:
        if repo in self.basic_auth:
            want = base64.b64encode(self.basic_auth[repo].encode()).decode()
            return header == f"Basic {want}"
        return header == f"Bearer {TOKEN}"

    def stop(self) -> None:
        self.server.stop()
        self.storage.stop()


def docker_config(path: Path, netloc: str, user_pass: str) -> Path:
    """A docker ``config.json`` with basic auth for ``netloc``."""
    auth = base64.b64encode(user_pass.encode()).decode()
    path.write_text(json.dumps({"auths": {netloc: {"auth": auth}}}))
    return path


# -- an HTTPS file host -----------------------------------------------------


class _FileHandler(_Handler):
    def do_GET(self):  # noqa: N802
        files = self.owner.files
        path = urllib.parse.urlsplit(self.path).path
        if path in files:
            self.send_body(200, files[path], "application/octet-stream")
        else:
            self.send_body(404, b"")


class FileHost:
    """Serves ``files`` (path → bytes), over TLS when given a context."""

    def __init__(self, tls: ssl.SSLContext | None = None) -> None:
        self.files: dict[str, bytes] = {}
        self.server = Served(_FileHandler, tls)
        self.server.files = self.files

    @property
    def netloc(self) -> str:
        return self.server.netloc

    def stop(self) -> None:
        self.server.stop()


# -- a fake Kubernetes API server -------------------------------------------

_CORE = {"Namespace": "namespaces", "Pod": "pods"}


def list_path(api_version: str, kind: str) -> str:
    """The LIST path of a kind, as ``KubeApiFetcher`` builds it."""
    if api_version == "v1":
        return f"/api/v1/{_CORE.get(kind, kind.lower() + 's')}"
    return f"/apis/{api_version}/{kind.lower()}s"


class _KubeHandler(_Handler):
    def do_GET(self):  # noqa: N802
        kube: KubeApi = self.owner.kube
        if self.headers.get("Authorization") != f"Bearer {kube.token}":
            self.send_body(401, b'{"kind":"Status","code":401}')
            return
        parts = urllib.parse.urlsplit(self.path)
        query = dict(urllib.parse.parse_qsl(parts.query))
        if parts.path == "/version":
            self.send_body(200, b'{"major":"1","minor":"30"}')
            return
        if parts.path not in kube.kinds:
            self.send_body(404, b'{"kind":"Status","code":404}')
            return
        if query.get("watch") == "true":
            self._watch(kube, parts.path, query.get("resourceVersion") or "0")
            return
        items, rv = kube.list(parts.path)
        self.send_body(200, json.dumps({
            "kind": "List", "apiVersion": "v1",
            "metadata": {"resourceVersion": str(rv)}, "items": items,
        }).encode())

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
        self.wfile.flush()

    def _watch(self, kube: "KubeApi", path: str, since: str) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        cursor = int(since)
        gen = kube.stream_generation(path)
        try:
            while True:
                events, cursor, state = kube.wait_events(path, cursor, gen)
                for ev in events:
                    self._chunk(json.dumps(ev).encode() + b"\n")
                if state == "expired":
                    self._chunk(json.dumps({
                        "type": "ERROR",
                        "object": {"kind": "Status", "code": 410,
                                   "reason": "Expired"},
                    }).encode() + b"\n")
                    break
                if state == "closed":
                    break
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except OSError:
            pass
        self.close_connection = True


class KubeApi:
    """A Kubernetes API server over HTTPS: ``/version``, LIST of each
    registered kind with the collection's ``resourceVersion``, and watch
    streams (chunked, one JSON event a line) that replay the events after
    the client's ``resourceVersion`` and then follow new ones.

    ``add``/``modify``/``delete`` change a kind's objects and append the
    event (each bumps the global resourceVersion; ``sent_at[rv]`` is the
    monotonic time the event was made). ``expire(path)`` answers every
    open stream of the kind a 410-Gone ERROR and makes resumes from an rv
    before now expire too; ``close_streams()`` ends every open stream
    cleanly. ``write_service_account(dir)`` writes ``token`` and
    ``ca.crt`` for the in-cluster client."""

    def __init__(self, directory: Path, token: str = "kube-token") -> None:
        self.token = token
        self.ca = make_ca("kube-ca")
        self.kinds: dict[str, dict[str, dict]] = {}
        self.events: dict[str, list[tuple[int, dict]]] = {}
        self.floor: dict[str, int] = {}
        self.generation: dict[str, int] = {}
        # how a kind's streams ended at its last generation bump
        self._ended: dict[str, str] = {}
        self.rv = 1
        self.sent_at: dict[int, float] = {}
        self.sent_wall: dict[int, float] = {}
        self._cond = threading.Condition()
        self.server = Served(
            _KubeHandler, server_context(Path(directory), self.ca, "kube")
        )
        self.server.kube = self

    @property
    def url(self) -> str:
        return f"https://{self.server.netloc}"

    def write_service_account(self, directory: Path) -> Path:
        directory.mkdir(parents=True, exist_ok=True)
        (directory / "token").write_text(self.token)
        (directory / "ca.crt").write_text(pem_of(self.ca[1]))
        return directory

    def register(self, path: str, objects: Iterable[dict] = ()) -> None:
        with self._cond:
            self.kinds[path] = {}
            self.events[path] = []
            self.floor[path] = 0
            self.generation[path] = 0
            for obj in objects:
                self._stamp(obj)
                self.kinds[path][_key(obj)] = obj

    def _stamp(self, obj: dict) -> int:
        self.rv += 1
        obj.setdefault("metadata", {})["resourceVersion"] = str(self.rv)
        return self.rv

    def _event(self, path: str, etype: str, obj: dict) -> int:
        import time

        obj = json.loads(json.dumps(obj))
        with self._cond:
            rv = self._stamp(obj)
            if etype == "DELETED":
                self.kinds[path].pop(_key(obj), None)
            else:
                self.kinds[path][_key(obj)] = obj
            self.events[path].append((rv, {"type": etype, "object": obj}))
            self.sent_at[rv] = time.monotonic()
            self.sent_wall[rv] = time.time()
            self._cond.notify_all()
            return rv

    def add(self, path: str, obj: dict) -> int:
        return self._event(path, "ADDED", obj)

    def modify(self, path: str, obj: dict) -> int:
        return self._event(path, "MODIFIED", obj)

    def delete(self, path: str, obj: dict) -> int:
        return self._event(path, "DELETED", obj)

    def list(self, path: str) -> tuple[list[dict], int]:
        with self._cond:
            return [json.loads(json.dumps(o)) for o in self.kinds[path].values()], self.rv

    def stream_generation(self, path: str) -> int:
        with self._cond:
            return self.generation[path]

    def wait_events(self, path: str, cursor: int, gen: int):
        """(events after ``cursor``, the new cursor, state): state is
        "open", "expired" (a 410 ends the stream) or "closed"."""
        with self._cond:
            while True:
                if cursor < self.floor[path]:
                    return [], cursor, "expired"
                if self.generation[path] != gen:
                    return [], cursor, self._ended[path]
                events = [e for rv, e in self.events[path] if rv > cursor]
                if events:
                    return events, self.events[path][-1][0], "open"
                self._cond.wait(0.5)

    def expire(self, path: str) -> None:
        """Compact the kind's history: open streams get a 410 ERROR, and a
        resume from any rv before now expires as well."""
        with self._cond:
            self.floor[path] = self.rv
            self._ended[path] = "expired"
            self.generation[path] += 1
            self._cond.notify_all()

    def close_streams(self) -> None:
        with self._cond:
            for path in self.kinds:
                self._ended[path] = "closed"
                self.generation[path] += 1
            self._cond.notify_all()

    def stop(self) -> None:
        self.close_streams()
        self.server.stop()


def _key(obj: dict) -> str:
    meta = obj.get("metadata") or {}
    return meta.get("uid") or f"{meta.get('namespace')}/{meta.get('name')}"


def namespace(name: str) -> dict:
    return {
        "apiVersion": "v1", "kind": "Namespace",
        "metadata": {"name": name, "uid": f"ns-{name}"},
    }
