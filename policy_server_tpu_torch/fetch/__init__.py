"""Policy acquisition (reference src/policy_downloader.rs + policy-fetcher):
downloader, artifact format, supply-chain verification, module resolution.

``make_module_resolver(config)`` is the server's resolver: builtins and
known upstream refs resolve natively; any other ``file://``, ``https://``
or ``registry://`` module is fetched into the download directory,
verified per ``verification.yml`` and loaded as a ``.tpp.json`` or
``.wasm`` artifact. Verification needs ``cryptography``; without it a
configured verification raises and unverified fetching still works."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import TYPE_CHECKING, Any, Callable

from policy_server_tpu_torch.config.sources import Sources
from policy_server_tpu_torch.config.verification import VerificationConfig
from policy_server_tpu_torch.fetch.artifact import (
    ArtifactError,
    ArtifactPolicyModule,
    dump_artifact,
    load_artifact,
)
from policy_server_tpu_torch.fetch.downloader import (
    Downloader,
    FetchedPolicies,
    FetchError,
    # real when cryptography is available, loud stubs otherwise
    # (downloader.py owns the soft import): unverified acquisition stays
    # usable without it
    VerificationError,
    iter_module_urls,
    verify_artifact,
)
from policy_server_tpu_torch.telemetry.tracing import logger

try:
    from policy_server_tpu_torch.fetch.verify import (
        sign_artifact_bytes,
        verify_local_checksum,
    )
except ImportError:  # pragma: no cover — cryptography unavailable

    def sign_artifact_bytes(*args, **kwargs):  # type: ignore[misc]
        raise VerificationError(
            "artifact signing requires the 'cryptography' package"
        )

    def verify_local_checksum(*args, **kwargs):  # type: ignore[misc]
        raise VerificationError(
            "checksum verification requires the 'cryptography' package"
        )

if TYPE_CHECKING:
    from policy_server_tpu_torch.evaluation.precompiled import PolicyModule

__all__ = [
    "ArtifactError",
    "ArtifactPolicyModule",
    "Downloader",
    "FetchConfig",
    "FetchError",
    "FetchedPolicies",
    "VerificationError",
    "dump_artifact",
    "iter_module_urls",
    "load_artifact",
    "load_trust_root",
    "make_module_resolver",
    "sign_artifact_bytes",
    "verify_artifact",
    "verify_local_checksum",
]


@dataclass
class FetchConfig:
    """The acquisition settings of the command line (``--sources-path``,
    ``--verification-path``, ``--docker-config-json-path``,
    ``--policies-download-dir``, ``--sigstore-cache-dir``), with the JAX
    package's defaults."""

    sources: Sources | None = None
    verification_config: VerificationConfig | None = None
    docker_config_json_path: str | None = None
    policies_download_dir: str = "."
    sigstore_cache_dir: str = "sigstore-data"


def load_trust_root(sigstore_cache_dir: str) -> Any:
    """The offline sigstore trust root of ``sigstore_cache_dir``, or None
    (with a warning) when it is absent or malformed, or when
    ``cryptography`` is not installed: keyless requirements then fail
    loudly per requirement (lib.rs:81-89, a failed TUF fetch)."""
    try:
        from policy_server_tpu_torch.fetch.keyless import KeylessError, TrustRoot
    except ImportError:
        return None
    try:
        return TrustRoot.load_from_cache_dir(sigstore_cache_dir)
    except KeylessError as e:
        logger.warning(
            "cannot load sigstore trust root; keyless verification "
            "disabled: %s", e,
        )
        return None


# distinct from None: None means "load attempted, unavailable/failed"
# (keyless then fails loudly per-requirement), the sentinel means the
# caller did not try to load at all
_TRUST_ROOT_UNSET = object()


def make_module_resolver(
    config: Any, trust_root: Any = _TRUST_ROOT_UNSET
) -> Callable[[str], "PolicyModule"]:
    """The server's module resolver (lib.rs:134-143 download step folded
    into evaluation bootstrap): builtin:// and known upstream refs resolve
    natively; everything else is fetched into the download dir, verified
    per verification.yml, and loaded as an artifact. ``config`` is a
    :class:`FetchConfig` (any object with its five fields).

    ``trust_root``: the offline sigstore trust root — keyless requirement
    kinds verify against it; absent, they fail loudly per-requirement.
    Loaded here only when the caller did not already attempt the load
    (the server loads once and shares, including its failure).

    The cache is per URL and lives as long as the resolver: the server
    builds one resolver, so a reload whose URL is unchanged keeps the
    module it first fetched, even where the tag has moved since (as in
    the JAX package)."""
    from policy_server_tpu_torch.policies import resolve_builtin

    if trust_root is _TRUST_ROOT_UNSET:
        trust_root = load_trust_root(config.sigstore_cache_dir)

    downloader = Downloader(
        sources=config.sources,
        verification_config=config.verification_config,
        docker_config_json_path=config.docker_config_json_path,
        trust_root=trust_root,
    )
    dest = Path(config.policies_download_dir)
    cache: dict[str, "PolicyModule"] = {}

    def resolve(url: str) -> "PolicyModule":
        if url in cache:
            return cache[url]
        builtin = resolve_builtin(url)
        if builtin is not None:
            cache[url] = builtin
            return builtin
        path = downloader.fetch_policy(url, dest)
        digest = None
        if config.verification_config is not None:
            digest = verify_artifact(
                path, config.verification_config, trust_root=trust_root
            )
        module = load_artifact(path)
        if digest is not None and module.digest != digest:
            # verify→load TOCTOU guard (the reference's post-download local
            # checksum, policy_downloader.rs:157-176): the bytes LOADED must
            # be the bytes VERIFIED
            raise VerificationError(
                f"artifact {path} changed between verification and load "
                f"(verified {digest}, loaded {module.digest})"
            )
        cache[url] = module
        return module

    return resolve
