"""Device-mesh parallelism (``parallel/mesh.py``): the data axis and the
fused (data × policy) form over CUDA cards, the multi-process group and
the acceptance-count collective; the thread-per-shard dispatcher of
``--mesh-dispatch threaded`` (``parallel/policy_sharded.py``).
Counterpart of ``policy_server_tpu/parallel``."""

from policy_server_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    POLICY_AXIS,
    Mesh,
    MeshSpec,
    SubmeshPlan,
    acceptance_psum,
    initialize_distributed,
    make_mesh,
    pad_batch_to,
    plan_policy_buckets,
    plan_policy_shards,
    resolve_axes,
    shard_delta_planes,
    shard_features,
)
from policy_server_tpu_torch.parallel.policy_sharded import PolicyShardedEvaluator

__all__ = [
    "DATA_AXIS",
    "POLICY_AXIS",
    "Mesh",
    "MeshSpec",
    "PolicyShardedEvaluator",
    "SubmeshPlan",
    "acceptance_psum",
    "initialize_distributed",
    "make_mesh",
    "pad_batch_to",
    "plan_policy_buckets",
    "plan_policy_shards",
    "resolve_axes",
    "shard_delta_planes",
    "shard_features",
]
