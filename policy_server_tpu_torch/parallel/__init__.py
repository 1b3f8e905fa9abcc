"""Device-mesh parallelism (``parallel/mesh.py``): the data axis and the
fused (data × policy) form over CUDA cards, and the multi-process group.
Counterpart of ``policy_server_tpu/parallel``; the thread-per-shard
dispatcher (``--mesh-dispatch threaded``) is not ported."""

from policy_server_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    POLICY_AXIS,
    Mesh,
    MeshSpec,
    initialize_distributed,
    make_mesh,
    pad_batch_to,
    plan_policy_buckets,
    resolve_axes,
    shard_delta_planes,
    shard_features,
)

__all__ = [
    "DATA_AXIS",
    "POLICY_AXIS",
    "Mesh",
    "MeshSpec",
    "initialize_distributed",
    "make_mesh",
    "pad_batch_to",
    "plan_policy_buckets",
    "resolve_axes",
    "shard_delta_planes",
    "shard_features",
]
