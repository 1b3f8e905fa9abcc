"""Policy artifact acquisition.

Reference parity: src/policy_downloader.rs —
* ``Downloader::download_policies`` (policy_downloader.rs:53-217): flatten
  groups to ``group/#member`` pseudo-names (234-256), dedup by URL, verify
  (optional), fetch, local checksum; per-policy errors captured in
  ``FetchedPolicies`` rather than aborting (the --continue-on-errors
  feed).
* schemes (README.md:73-82): ``file://`` (local path), ``https://`` (direct
  download), ``registry://`` (OCI artifact pull: token auth → manifest →
  first layer blob, the policy-fetcher flow). ``builtin://`` is this
  build's native scheme and needs no fetching.

Registry auth: anonymous token flow (WWW-Authenticate Bearer realm), plus
``DOCKER_CONFIG`` basic-auth like the reference (config.rs:279-283).
TLS trust honors sources.yml: ``insecure_sources`` and per-host
``source_authorities`` (config/sources.py).

Every GET goes through the standard-library client (``httpclient.py``):
30 s timeouts, per-host TLS, and a redirect that leaves the registry host
(a blob's 307 to object storage) drops the registry's ``Authorization``."""

from __future__ import annotations

import base64
import hashlib
import json
import os
import re
import threading
import time
import urllib.parse
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Mapping

from policy_server_tpu_torch import failpoints, httpclient
from policy_server_tpu_torch.resilience import retry_with_backoff
from policy_server_tpu_torch.config.sources import Sources
from policy_server_tpu_torch.config.verification import VerificationConfig

try:
    from policy_server_tpu_torch.fetch.verify import (
        VerificationError,
        verify_artifact,
    )
except ImportError:  # cryptography unavailable: fetching still works,
    # verification degrades LOUDLY — any configured verification fails
    # per-policy instead of the whole fetch subsystem failing to import

    class VerificationError(Exception):  # type: ignore[no-redef]
        pass

    def verify_artifact(*args, **kwargs):  # type: ignore[misc]
        raise VerificationError(
            "artifact verification requires the 'cryptography' package"
        )
from policy_server_tpu_torch.models.policy import (
    Policy,
    PolicyGroup,
    PolicyOrPolicyGroup,
)
from policy_server_tpu_torch.telemetry.tracing import logger

KUBEWARDEN_ARTIFACT_MEDIA_TYPES = (
    "application/vnd.tpp.policy.v1+json",
    "application/vnd.oci.image.layer.v1.tar",
    "application/octet-stream",
)


class FetchError(Exception):
    pass


class RetryableFetchError(FetchError):
    """A transient transport/registry failure (connect error, timeout,
    HTTP 429/5xx): eligible for the capped-backoff retry policy. Still a
    FetchError, so an exhausted retry budget surfaces through the same
    error channel callers already handle."""


# HTTP statuses worth retrying: rate limiting and server-side failures.
# 4xx other than 429 are deterministic (auth, not-found) — retrying them
# only delays the real error.
RETRYABLE_HTTP_STATUS = frozenset({429, 500, 502, 503, 504})

# process-wide retry accounting (the /metrics runtime collector reads
# this; Downloader instances are transient — built at boot, hot-reload,
# and per manifest_digest call — so the counters cannot live on them)
_retry_lock = threading.Lock()
_retry_totals = {"attempts": 0, "giveups": 0}


def retry_stats() -> dict[str, int]:
    """Cumulative fetch-retry counters: ``attempts`` (individual retries
    performed) and ``giveups`` (operations that exhausted the budget)."""
    with _retry_lock:
        return dict(_retry_totals)


def _count_retry(n: int = 1, giveup: bool = False) -> None:
    with _retry_lock:
        _retry_totals["attempts"] += n
        if giveup:
            _retry_totals["giveups"] += 1


@dataclass
class FetchedPolicies:
    """url → local path or error (policy_downloader.rs:24)."""

    fetched: dict[str, Path | Exception] = field(default_factory=dict)

    def ok(self, url: str) -> Path:
        result = self.fetched[url]
        if isinstance(result, Exception):
            raise result
        return result

    @property
    def errors(self) -> dict[str, Exception]:
        return {
            u: r for u, r in self.fetched.items() if isinstance(r, Exception)
        }


def iter_module_urls(
    policies: Mapping[str, PolicyOrPolicyGroup],
) -> dict[str, str]:
    """policy name (groups flattened as ``group/#member``) → module URL
    (policy_downloader.rs:234-256)."""
    out: dict[str, str] = {}
    for name, entry in policies.items():
        if isinstance(entry, Policy):
            out[name] = entry.module
        elif isinstance(entry, PolicyGroup):
            for member_name, member in entry.policies.items():
                out[f"{name}/#{member_name}"] = member.module
    return out


class Downloader:
    """policy_downloader.rs:27-217."""

    def __init__(
        self,
        sources: Sources | None = None,
        verification_config: VerificationConfig | None = None,
        docker_config_json_path: str | None = None,
        trust_root=None,  # fetch/keyless.TrustRoot for keyless kinds
        retry_attempts: int = 4,
        retry_base_seconds: float = 0.25,
        retry_cap_seconds: float = 5.0,
        retry_sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self.sources = sources or Sources()
        self.verification_config = verification_config
        self.trust_root = trust_root
        self._docker_auths = _load_docker_auths(docker_config_json_path)
        self._ca_bundles: dict[str, str] = {}  # host → PEM bundle (cached)
        # transient-failure retry policy (applied to every registry/HTTPS
        # round-trip at boot AND hot-reload): one 5xx blip must not be
        # fatal, capped exponential backoff + full jitter keeps a fleet of
        # rebooting servers from re-synchronizing on the registry
        self.retry_attempts = max(1, int(retry_attempts))
        self.retry_base_seconds = retry_base_seconds
        self.retry_cap_seconds = retry_cap_seconds
        self._retry_sleep = retry_sleep

    def _with_retries(self, fn: Callable[[], Any], what: str) -> Any:
        """Run one fetch operation under the retry policy. Retryable:
        RetryableFetchError (connect/timeout/429/5xx) and injected
        ``fetch.http`` failpoint faults; everything else propagates on
        the first attempt."""

        def on_retry(attempt: int, exc: BaseException, delay: float) -> None:
            _count_retry()
            logger.warning(
                "transient fetch failure for %s (attempt %d/%d, retrying "
                "in %.2fs): %s", what, attempt, self.retry_attempts, delay,
                exc,
            )

        try:
            return retry_with_backoff(
                fn,
                is_retryable=lambda e: isinstance(
                    e, (RetryableFetchError, failpoints.FailpointError)
                ),
                attempts=self.retry_attempts,
                base_seconds=self.retry_base_seconds,
                cap_seconds=self.retry_cap_seconds,
                sleep=self._retry_sleep,
                on_retry=on_retry,
            )
        except RetryableFetchError:
            _count_retry(0, giveup=True)
            raise
        except failpoints.FailpointError as e:
            _count_retry(0, giveup=True)
            raise FetchError(f"GET {what} failed: {e}") from e

    def download_policies(
        self,
        policies: Mapping[str, PolicyOrPolicyGroup],
        download_dir: str | Path,
    ) -> FetchedPolicies:
        dest = Path(download_dir)
        dest.mkdir(parents=True, exist_ok=True)
        result = FetchedPolicies()
        for url in sorted(set(iter_module_urls(policies).values())):
            if url.startswith("builtin://"):
                continue
            if url in result.fetched:
                continue
            try:
                path = self.fetch_policy(url, dest)
                if self.verification_config is not None:
                    # signature/digest verification; the verify→load
                    # checksum guard runs at module-resolution time
                    # (fetch/__init__.make_module_resolver)
                    verify_artifact(
                        path,
                        self.verification_config,
                        trust_root=self.trust_root,
                    )
                result.fetched[url] = path
            except (FetchError, VerificationError, OSError, ValueError) as e:
                logger.error("failed to fetch policy %s: %s", url, e)
                result.fetched[url] = e
        return result

    # -- single fetch ------------------------------------------------------

    def fetch_policy(self, url: str, dest_dir: Path) -> Path:
        """Fetch one module URL into the store; returns the local path.
        Files are stored content-addressed (digest-named) so identical
        modules dedup across URLs and restarts reuse the store
        (policy_downloader.rs:129-134).

        The detached-signature sidecar travels WITH the artifact: verify
        runs against the stored path, so the sidecar must land at
        ``<stored>.sig.json`` (for file:// it is copied, for https://
        downloaded from ``<url>.sig.json``, for registry:// pulled from the
        cosign-convention tag ``sha256-<digest>.sig``)."""
        parsed = urllib.parse.urlparse(url)
        if parsed.scheme == "file":
            src = Path(parsed.path)
            if not src.exists():
                raise FetchError(f"file not found: {src}")
            path = self._store(dest_dir, src.read_bytes(), src.suffix)
            sidecar = Path(str(src) + ".sig.json")
            if sidecar.exists():
                self._store_sidecar(path, sidecar.read_bytes())
            return path
        if parsed.scheme in ("http", "https"):
            data = self._http_get(url, parsed.hostname or "")
            suffix = Path(parsed.path).suffix or ".artifact"
            path = self._store(dest_dir, data, suffix)
            if self.verification_config is not None:
                # the .sig.json suffix goes on the PATH — appending to the
                # full URL would corrupt query-string URLs (presigned S3)
                sig_url = parsed._replace(path=parsed.path + ".sig.json")
                try:
                    sig = self._http_get(
                        urllib.parse.urlunparse(sig_url), parsed.hostname or ""
                    )
                    self._store_sidecar(path, sig)
                except FetchError:
                    pass  # unsigned artifact; verification decides the fate
            return path
        if parsed.scheme == "registry":
            data, suffix = self._fetch_oci(parsed)
            path = self._store(dest_dir, data, suffix)
            if self.verification_config is not None:
                sig = self._fetch_oci_signature(parsed, data)
                if sig is not None:
                    self._store_sidecar(path, sig)
            return path
        raise FetchError(f"unsupported module URL scheme: {url}")

    def _store_sidecar(self, artifact_path: Path, sidecar_bytes: bytes) -> None:
        sidecar_path = Path(str(artifact_path) + ".sig.json")
        tmp = sidecar_path.with_suffix(sidecar_path.suffix + ".tmp")
        tmp.write_bytes(sidecar_bytes)
        tmp.replace(sidecar_path)

    def _store(self, dest_dir: Path, data: bytes, suffix: str) -> Path:
        dest_dir.mkdir(parents=True, exist_ok=True)
        digest = hashlib.sha256(data).hexdigest()
        path = dest_dir / f"{digest}{suffix}"
        if not path.exists():
            tmp = path.with_suffix(path.suffix + ".tmp")
            tmp.write_bytes(data)
            tmp.replace(path)
        return path

    # -- transports --------------------------------------------------------

    def _tls_kwargs(self, host: str) -> dict[str, Any]:
        if self.sources.is_insecure(host):
            return {"verify": False}
        authorities = self.sources.authorities_for(host)
        if authorities:
            # the per-host CA bundle is static: build it once, reuse
            data = self._ca_bundles.get(host)
            if data is None:
                data = self._ca_bundles[host] = "".join(
                    a.pem_bytes().decode() + "\n" for a in authorities
                )
            return {"cadata": data}
        return {}

    def _context_for(self, netloc: str) -> Any:
        """TLS for a redirect that left the first host: that host's own
        ``sources`` entry (by ``host:port``, then host), else the system
        store."""
        hostname = urllib.parse.urlsplit(f"//{netloc}").hostname or netloc
        tls = self._tls_kwargs(netloc) or self._tls_kwargs(hostname)
        return httpclient.ssl_context(
            tls.get("verify", True), tls.get("cadata")
        )

    def _get(
        self, url: str, host: str, headers: Mapping[str, str] | None = None
    ) -> httpclient.Response:
        tls = self._tls_kwargs(host)
        return httpclient.get(
            url, headers=headers or {}, timeout=30,
            verify=tls.get("verify", True), cadata=tls.get("cadata"),
            context_for=self._context_for,
        )

    def _http_get(
        self, url: str, host: str, headers: dict[str, str] | None = None
    ) -> bytes:
        def attempt() -> bytes:
            failpoints.fire("fetch.http")
            try:
                resp = self._get(url, host, headers)
            except httpclient.RequestError as e:
                raise RetryableFetchError(f"GET {url} failed: {e}") from e
            if resp.status_code != 200:
                message = f"GET {url} -> HTTP {resp.status_code}"
                if resp.status_code in RETRYABLE_HTTP_STATUS:
                    raise RetryableFetchError(message)
                raise FetchError(message)
            return resp.content

        return self._with_retries(attempt, url)

    def _fetch_oci(self, parsed: urllib.parse.ParseResult) -> tuple[bytes, str]:
        """OCI distribution pull: ref → token (if challenged) → manifest →
        config/layer blob."""
        host = parsed.netloc
        ref = parsed.path.lstrip("/")
        name, tag = _split_ref(ref)
        scheme = "http" if self.sources.is_insecure(host) else "https"
        base = f"{scheme}://{host}/v2/{name}"
        headers = {
            "Accept": (
                "application/vnd.oci.image.manifest.v1+json, "
                "application/vnd.docker.distribution.manifest.v2+json"
            )
        }
        auth = self._docker_auths.get(host)
        if auth:
            headers["Authorization"] = f"Basic {auth}"
        manifest_url = f"{base}/manifests/{tag}"
        resp = self._oci_get(manifest_url, host, headers)
        manifest = resp.json()
        layers = manifest.get("layers") or []
        if not layers:
            raise FetchError(f"manifest for {ref} has no layers")
        layer = layers[0]
        media_type = layer.get("mediaType", "application/octet-stream")
        blob_digest = layer["digest"]
        blob = self._oci_get(f"{base}/blobs/{blob_digest}", host, headers).content
        actual = "sha256:" + hashlib.sha256(blob).hexdigest()
        if actual != blob_digest:
            raise FetchError(
                f"blob digest mismatch for {ref}: {actual} != {blob_digest}"
            )
        suffix = ".wasm" if "wasm" in media_type or name.endswith("wasm") else (
            ".tpp.json" if "tpp" in media_type or "json" in media_type else ".artifact"
        )
        return blob, suffix

    def manifest_digest(self, image: str) -> str:
        """Resolve an image reference to its manifest digest — the backing
        client for the ``("oci", "v1/manifest_digest")`` host capability
        (the reference serves it through the callback handler's registry
        client, src/lib.rs:91-125). Reuses this downloader's token-auth /
        TLS / docker-config machinery; raises FetchError on any actual
        network or registry failure.

        Accepts docker-style refs (``host/name:tag``, ``name@sha256:..``,
        optionally ``registry://``-prefixed); registry-less refs get the
        standard docker.io/library defaults."""
        ref = image
        for prefix in ("registry://", "oci://", "docker://"):
            if ref.startswith(prefix):
                ref = ref[len(prefix):]
                break
        first, slash, rest = ref.partition("/")
        if not slash or (
            "." not in first and ":" not in first and first != "localhost"
        ):
            # no registry component: docker hub defaults
            host = "registry-1.docker.io"
            name_part = ref if slash else f"library/{ref}"
        else:
            host, name_part = first, rest
        name, tag = _split_ref(name_part)
        scheme = "http" if self.sources.is_insecure(host) else "https"
        headers = {
            # the digest is of whatever manifest the registry serves for
            # the ref — accept single manifests AND multi-arch indexes so
            # the returned digest matches what cosign signs
            "Accept": (
                "application/vnd.oci.image.manifest.v1+json, "
                "application/vnd.oci.image.index.v1+json, "
                "application/vnd.docker.distribution.manifest.v2+json, "
                "application/vnd.docker.distribution.manifest.list.v2+json"
            )
        }
        auth = self._docker_auths.get(host)
        if auth:
            headers["Authorization"] = f"Basic {auth}"
        resp = self._oci_get(
            f"{scheme}://{host}/v2/{name}/manifests/{tag}", host, headers
        )
        # NEVER trust the Docker-Content-Digest header verbatim (ADVICE
        # r5 #2): the value feeds policy verify decisions via
        # oci/v1/manifest_digest, and a misbehaving registry can return a
        # digest that does not match the manifest bytes it served.
        # Standard client behavior (containerd/oras): recompute over the
        # served bytes and reject on disagreement.
        computed = "sha256:" + hashlib.sha256(resp.content).hexdigest()
        header_digest = resp.headers.get("Docker-Content-Digest")
        if not header_digest:
            return computed
        algo, sep, hexval = header_digest.partition(":")
        if not sep:
            raise FetchError(
                f"malformed Docker-Content-Digest for {ref}: "
                f"{header_digest!r}"
            )
        algo = algo.lower()
        try:
            verifier = hashlib.new(algo)
            verifier.update(resp.content)
            header_hex = verifier.hexdigest()
        except (ValueError, TypeError):
            # unverifiable algorithm (unknown name, or a variable-length
            # digest like shake_* whose hexdigest needs a length): fall
            # back to the digest this client computed rather than
            # trusting an opaque header
            return computed
        if header_hex != hexval.lower():
            raise FetchError(
                f"manifest digest mismatch for {ref}: registry header "
                f"{header_digest} != computed {algo}:{header_hex}"
            )
        return header_digest

    def _fetch_oci_signature(
        self, parsed: urllib.parse.ParseResult, artifact_bytes: bytes
    ) -> bytes | None:
        """Pull the detached-signature sidecar stored at the
        cosign-convention tag ``sha256-<digest>.sig`` in the same repo; None
        when absent (verification then sees zero signatures)."""
        host = parsed.netloc
        name, _ = _split_ref(parsed.path.lstrip("/"))
        digest = hashlib.sha256(artifact_bytes).hexdigest()
        sig_ref = urllib.parse.ParseResult(
            scheme="registry", netloc=host,
            path=f"/{name}:sha256-{digest}.sig",
            params="", query="", fragment="",
        )
        try:
            blob, _ = self._fetch_oci(sig_ref)
            return blob
        except (FetchError, KeyError, ValueError):
            return None

    def _oci_get(
        self, url: str, host: str, headers: dict[str, str]
    ) -> httpclient.Response:
        def attempt() -> httpclient.Response:
            failpoints.fire("fetch.http")
            req_headers = headers
            try:
                resp = self._get(url, host, req_headers)
                if resp.status_code == 401:
                    challenge = resp.headers.get("WWW-Authenticate", "")
                    token = self._anonymous_token(challenge)
                    if token:
                        req_headers = dict(req_headers)
                        req_headers["Authorization"] = f"Bearer {token}"
                        resp = self._get(url, host, req_headers)
            except httpclient.RequestError as e:
                raise RetryableFetchError(f"GET {url} failed: {e}") from e
            if resp.status_code != 200:
                message = f"GET {url} -> HTTP {resp.status_code}"
                if resp.status_code in RETRYABLE_HTTP_STATUS:
                    raise RetryableFetchError(message)
                raise FetchError(message)
            return resp

        return self._with_retries(attempt, url)

    def _anonymous_token(self, challenge: str) -> str | None:
        m = re.match(r'Bearer realm="([^"]+)"(.*)', challenge)
        if not m:
            return None
        realm, rest = m.group(1), m.group(2)
        params = dict(re.findall(r'(\w+)="([^"]+)"', rest))
        params.pop("error", None)
        try:
            # the token realm is verified against the system store, as
            # the JAX package's plain ``session.get`` does
            resp = httpclient.get(realm, params=params, timeout=30)
            if resp.status_code != 200:
                return None
            return resp.json().get("token") or resp.json().get("access_token")
        except (httpclient.RequestError, ValueError):
            return None


def _split_ref(ref: str) -> tuple[str, str]:
    """'org/policy:v1.0' → ('org/policy', 'v1.0'); digest refs supported."""
    if "@" in ref:
        name, _, digest = ref.partition("@")
        return name, digest
    if ":" in ref.rsplit("/", 1)[-1]:
        name, _, tag = ref.rpartition(":")
        return name, tag
    return ref, "latest"


def _load_docker_auths(config_path: str | None) -> dict[str, str]:
    """DOCKER_CONFIG-style auth map: host → base64 user:pass
    (config.rs:279-283)."""
    path = None
    if config_path:
        p = Path(config_path)
        path = p / "config.json" if p.is_dir() else p
    elif os.environ.get("DOCKER_CONFIG"):
        path = Path(os.environ["DOCKER_CONFIG"]) / "config.json"
    if path is None or not path.exists():
        return {}
    try:
        doc = json.loads(path.read_text())
        out = {}
        for host, entry in (doc.get("auths") or {}).items():
            auth = entry.get("auth")
            if auth:
                out[urllib.parse.urlparse(f"//{host}").netloc or host] = auth
            elif entry.get("username") and entry.get("password"):
                raw = f"{entry['username']}:{entry['password']}".encode()
                out[host] = base64.b64encode(raw).decode()
        return out
    except (ValueError, OSError):
        return {}

