"""Version info."""

from policy_server_tpu_torch import __version__

__all__ = ["__version__"]
