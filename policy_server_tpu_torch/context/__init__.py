"""Cluster context: the payload key under which a policy's context
arrives.

Only the key lives here. The context service (cluster snapshots by list
and watch) is not part of this package yet, so ``__context__`` holds what
the policy program's own context providers put there, as in the JAX
package without ``--context-*`` flags."""

# payload key under which context (program providers' output) is merged
CONTEXT_KEY = "__context__"

__all__ = ["CONTEXT_KEY"]
