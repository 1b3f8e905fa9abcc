"""Policy acquisition: the artifact format and fetched-module resolution.

Only the artifact seam lives here so far: ``load_artifact`` turns the
bytes of a ``.wasm`` module or a ``.tpp.json`` bundle into a policy
module, and ``dump_artifact`` writes a bundle. Acquiring a module over
``file://``, ``https://`` or ``registry://`` (the downloader, its
verification and keyless signatures) is not part of this package yet."""

from __future__ import annotations

from policy_server_tpu_torch.fetch.artifact import (
    ArtifactError,
    ArtifactPolicyModule,
    dump_artifact,
    load_artifact,
)

__all__ = [
    "ArtifactError",
    "ArtifactPolicyModule",
    "dump_artifact",
    "load_artifact",
]
