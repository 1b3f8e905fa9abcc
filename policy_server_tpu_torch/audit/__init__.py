"""In-process background audit scanner, live watch feed and verdict
matrix (the JAX package's ``audit/``).

The scanner (``scanner.py``) keeps re-judging a snapshot of the cluster's
resources (``snapshot.py``) through the serving policy epoch on the
batcher's best-effort audit lane, so live admission traffic strictly
preempts it, and keeps PolicyReport-style rows (``reports.py``). The
verdict matrix (``matrix.py``) holds the (object × policy) verdicts,
streams their changes and answers byte-identical admissions from them.
The watch feed (``watch_feed.py``) keeps the snapshot tracking a live
cluster through list+watch (``--audit-watch``).
"""

from policy_server_tpu_torch.audit.matrix import (
    VerdictMatrix,
    normalized_payload_hash,
    policy_fingerprint,
)
from policy_server_tpu_torch.audit.reports import PolicyReportStore
from policy_server_tpu_torch.audit.scanner import AUDIT_MODES, AuditScanner
from policy_server_tpu_torch.audit.snapshot import (
    SnapshotStore,
    resource_key,
    synthesize_review,
)
from policy_server_tpu_torch.audit.watch_feed import WatchFeed, parse_watch_resources

__all__ = [
    "AUDIT_MODES",
    "AuditScanner",
    "PolicyReportStore",
    "SnapshotStore",
    "VerdictMatrix",
    "WatchFeed",
    "normalized_payload_hash",
    "parse_watch_resources",
    "policy_fingerprint",
    "resource_key",
    "synthesize_review",
]
