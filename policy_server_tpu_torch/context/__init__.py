"""Context-aware policy support: the cluster-state snapshot service.

Reference mapping (SURVEY.md §2.2 ``callback_handler`` row): the reference
bridges synchronous wasm guests to async Kubernetes lookups with a
``CallbackHandler`` task + mpsc channel (src/lib.rs:91-125, 241-246) and a
per-policy ``EvaluationContext`` capability allowlist
(evaluation_environment.rs:243-247). A device predicate program cannot call the
host mid-kernel, so the design inverts the dataflow: a background
service keeps a versioned SNAPSHOT of the allowlisted cluster resources, and
each evaluation sees the snapshot as part of its input (payload key
``__context__``) — prefetch replaces read-through callbacks.

Staleness contract (SURVEY.md §7.4 hard-part #5): verdicts reflect cluster
state as of ``snapshot.version`` (refreshed every ``refresh_seconds``, 30 s
default), never mid-evaluation reads. The per-policy allowlist is enforced
at injection: a policy sees ONLY the resource kinds its
``contextAwareResources`` declares (EvaluationContext parity)."""

from policy_server_tpu_torch.context.service import (
    CONTEXT_KEY,
    ContextSnapshot,
    ContextSnapshotService,
    KubeApiFetcher,
    KubeConnectionError,
    StaticContextFetcher,
)

__all__ = [
    "CONTEXT_KEY",
    "ContextSnapshot",
    "ContextSnapshotService",
    "KubeApiFetcher",
    "KubeConnectionError",
    "StaticContextFetcher",
]
