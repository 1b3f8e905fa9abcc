"""Config files: sources.yml (registry trust) and verification.yml
(signature requirements), as JSON or, where PyYAML is installed, YAML.

The command line itself lives in ``__main__.py``."""

from policy_server_tpu_torch.config.sources import Sources, read_sources_file
from policy_server_tpu_torch.config.verification import (
    VerificationConfig,
    read_verification_file,
)

__all__ = [
    "Sources",
    "read_sources_file",
    "VerificationConfig",
    "read_verification_file",
]
