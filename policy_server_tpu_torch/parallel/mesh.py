"""The device mesh: data-parallel batch sharding and the policy axis of the
fused (data × policy) form, over CUDA cards.

Counterpart of ``policy_server_tpu/parallel/mesh.py``. A :class:`Mesh` is a
grid of ``torch.device`` entries with named axes:

* ``data`` — the batch rows split into contiguous data shards, one per
  position on the axis. A row's verdicts depend on that row alone, so no
  collective is needed: each data shard's rows run on its own devices and
  come back in order.
* ``policy`` — the policy set split round-robin into shards
  (``plan_policy_buckets``). Position (p, d) evaluates shard p's policies
  on data shard d's rows; the verdict blocks are gathered, shard-major,
  on data shard d's first device, where the group combine runs
  (``evaluation/environment.py``). Under ``--mesh-dispatch threaded``
  each policy shard is an environment of its own instead, on its row of
  the mesh (``plan_policy_shards``, ``parallel/policy_sharded.py``).

Entries need not be distinct: a mesh laid over one card (or the CPU)
taken several times runs every form's code on that device.

Multi-process: ``initialize_distributed`` joins a ``torch.distributed``
process group over gloo, and the mesh's default device list is the
group's global list in rank order (``global_devices``). The data axis
goes outermost, so each data shard is host-local and each process serves
its own requests on its own positions; no tensor crosses processes (see
``EvaluationEnvironment.attach_mesh``).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
POLICY_AXIS = "policy"

# the JAX package's jax.distributed.initialize default
DEFAULT_INIT_TIMEOUT_SECONDS = 300.0


@dataclass(frozen=True)
class MeshSpec:
    """Device-mesh request, e.g. ``data:8`` or ``data:4,policy:2``.

    Axis names: ``data`` shards the request batch dimension; ``policy``
    shards the loaded policy set. ``auto`` sizes the data axis to every
    device at boot.
    """

    axes: tuple[tuple[str, int], ...] = (("data", 0),)  # 0 = auto

    @classmethod
    def parse(cls, spec: str) -> "MeshSpec":
        if spec in ("auto", ""):
            return cls()
        axes: list[tuple[str, int]] = []
        for part in spec.split(","):
            name, _, size = part.partition(":")
            name = name.strip()
            if name not in ("data", "policy"):
                raise ValueError(f"unknown mesh axis {name!r} (expected data/policy)")
            try:
                n = int(size)
            except ValueError:
                raise ValueError(f"invalid mesh axis size in {part!r}") from None
            if n < 1:
                raise ValueError(f"mesh axis size must be >= 1: {part!r}")
            axes.append((name, n))
        if not axes:
            raise ValueError(f"invalid mesh spec {spec!r}")
        names = [a for a, _ in axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mesh axis in {spec!r}")
        return cls(axes=tuple(axes))

    def data_size(self) -> int:
        return dict(self.axes).get("data", 1)

    def policy_size(self) -> int:
        return dict(self.axes).get("policy", 1)


class Mesh:
    """A grid of devices with named axes. ``processes`` (same shape) holds
    the rank that owns each entry, ``process_index`` this process's rank;
    a single-process mesh owns every entry."""

    def __init__(
        self,
        devices: np.ndarray,
        axis_names: Sequence[str],
        processes: np.ndarray | None = None,
        process_index: int = 0,
    ) -> None:
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(
                f"{devices.ndim}-d device grid for axes {self.axis_names}"
            )
        self.processes = (
            np.zeros(devices.shape, np.int64) if processes is None else processes
        )
        self.process_index = process_index

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _data_major(self, grid: np.ndarray) -> np.ndarray:
        """``grid`` as (data, policy), whatever the axis order."""
        if self.axis_names.index(DATA_AXIS) == 0:
            return grid
        return grid.T

    def local_data_shards(self) -> list[list[Any]]:
        """This process's data shards, in data-axis order: each the list of
        its devices along the policy axis. A data shard belongs to the
        process that owns its entries (``make_mesh`` keeps each one
        within a host)."""
        grid = self._data_major(self.devices)
        owner = self._data_major(self.processes)
        out = []
        for d in range(grid.shape[0]):
            ranks = set(owner[d].tolist())
            if ranks == {self.process_index}:
                out.append(list(grid[d]))
            elif self.process_index in ranks:
                raise ValueError(
                    f"data shard {d} spans processes {sorted(ranks)}"
                )
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.tolist()})"


def process_count() -> int:
    """Processes in the ``torch.distributed`` group (1 without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank in the ``torch.distributed`` group (0 without
    one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def local_device_count(device_type: str = "cuda") -> int:
    """The devices this process brings to a mesh: every CUDA card, or one
    CPU entry."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    return 1


def local_devices(device_type: str = "cuda") -> list[torch.device]:
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(local_device_count("cuda"))]
    return [torch.device(device_type)]


def global_devices(device_type: str = "cuda") -> list[torch.device]:
    """The mesh's default device list: this process's devices, or, in a
    process group, every rank's in rank order (one ``all_gather_object``
    of each rank's local count — a collective, so every rank calls it
    together, once, at boot). Each rank must bring the same count."""
    n = process_count()
    if n == 1:
        return local_devices(device_type)
    import torch.distributed as dist

    counts: list[Any] = [None] * n
    dist.all_gather_object(counts, local_device_count(device_type))
    if len(set(counts)) != 1:
        raise ValueError(
            f"multi-process mesh: every process must bring the same device "
            f"count, got {counts} by rank"
        )
    return [d for _rank in range(n) for d in local_devices(device_type)]


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    timeout_seconds: float = DEFAULT_INIT_TIMEOUT_SECONDS,
) -> None:
    """Join the multi-process group (``torch.distributed`` over gloo,
    rendezvous at ``tcp://coordinator_address``). No-op without a
    coordinator.

    gloo on the card too: the serving path sends no tensor between
    processes (each serves its own rows on its own positions), and NCCL
    refuses two ranks on one card. A failed bring-up leaves no process
    group behind, so the process can still serve or retry."""
    if coordinator_address is None:
        return
    import torch.distributed as dist

    try:
        dist.init_process_group(
            backend="gloo",
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes,
            rank=process_id,
            timeout=datetime.timedelta(seconds=timeout_seconds),
        )
    except BaseException:
        if dist.is_initialized():
            dist.destroy_process_group()
        raise


def shutdown_distributed() -> None:
    """Leave the process group ``initialize_distributed`` joined (a no-op
    without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def resolve_axes(spec: MeshSpec, devices: Sequence[Any] | None = None) -> dict[str, int]:
    """Concretize a MeshSpec against the available devices (``data: 0`` =
    auto → all devices not consumed by the policy axis)."""
    devs = list(devices if devices is not None else global_devices())
    policy = spec.policy_size()
    data = spec.data_size()
    if policy < 1 or len(devs) % policy != 0:
        raise ValueError(
            f"policy axis {policy} does not divide device count {len(devs)}"
        )
    if data == 0:  # auto
        data = len(devs) // policy
    if data * policy != len(devs):
        raise ValueError(
            f"mesh {data}x{policy} does not match device count {len(devs)}"
        )
    return {DATA_AXIS: data, POLICY_AXIS: policy}


def make_mesh(
    spec: MeshSpec | None = None,
    devices: Sequence[Any] | None = None,
    device_type: str = "cuda",
) -> Mesh:
    """Build the (data, policy) mesh over ``devices`` (default:
    ``global_devices(device_type)``).

    Single process: ``policy`` outer, ``data`` inner on the device list.
    Multi-process: ``data`` outermost — the global list holds each
    process's devices contiguously, so an outer data axis splits the
    batch across processes while each data shard, and its policy axis,
    stays within one host."""
    listed = list(devices if devices is not None else global_devices(device_type))
    devs = np.empty(len(listed), dtype=object)
    devs[:] = listed
    axes = resolve_axes(spec or MeshSpec(), listed)
    n_proc = process_count()
    if n_proc > 1:
        # a data shard (policy-axis consecutive global devices) must live
        # within one host: the host serves that shard's rows itself
        local = local_device_count(device_type)
        policy = axes[POLICY_AXIS]
        if policy > local or local % policy != 0:
            raise ValueError(
                f"multi-process mesh: policy axis {policy} must divide "
                f"the per-host device count {local} (a data shard must "
                "be host-local; shrink the policy axis or use more "
                "devices per host)"
            )
        if len(listed) % n_proc:
            raise ValueError(
                f"multi-process mesh: {len(listed)} devices do not split "
                f"over {n_proc} processes"
            )
        owner = np.arange(len(listed)) // (len(listed) // n_proc)
        shape = (axes[DATA_AXIS], axes[POLICY_AXIS])
        return Mesh(
            devs.reshape(shape), (DATA_AXIS, POLICY_AXIS),
            owner.reshape(shape), process_index(),
        )
    grid = devs.reshape(axes[POLICY_AXIS], axes[DATA_AXIS])
    return Mesh(grid, (POLICY_AXIS, DATA_AXIS))


@dataclass(frozen=True)
class SubmeshPlan:
    """One policy shard of ``--mesh-dispatch threaded``: the policy ids it
    evaluates and its data-parallel submesh (one row of the mesh)."""

    shard_index: int
    policy_ids: tuple[str, ...]
    mesh: Mesh


def plan_policy_shards(
    policy_ids: Sequence[str], mesh: Mesh
) -> list[SubmeshPlan]:
    """Partition top-level policy ids round-robin (sorted) over the policy
    axis; shard ``s`` owns the mesh's row at policy position ``s`` — its
    devices along the data axis, whichever axis the grid holds first —
    as a ``(1, data)`` submesh over ``(policy, data)``, with the owner
    ranks of those entries."""
    n_shards = mesh.shape[POLICY_AXIS]
    buckets: list[list[str]] = [[] for _ in range(n_shards)]
    for i, pid in enumerate(sorted(policy_ids)):
        buckets[i % n_shards].append(pid)
    grid = mesh._data_major(mesh.devices)
    owner = mesh._data_major(mesh.processes)
    plans = []
    for s in range(n_shards):
        submesh = Mesh(
            grid[:, s].reshape(1, -1), (POLICY_AXIS, DATA_AXIS),
            owner[:, s].reshape(1, -1), mesh.process_index,
        )
        plans.append(SubmeshPlan(s, tuple(buckets[s]), submesh))
    return plans


def plan_policy_buckets(
    policy_ids: Sequence[str], n_shards: int
) -> tuple[list[tuple[str, ...]], int, dict[str, int]]:
    """Partition policy ids round-robin (sorted) into the policy axis's
    shards. Returns ``(buckets, width, column_of)``: every shard pads its
    verdict block to ``width`` columns, and ``column_of[pid]`` is the
    policy's column in the gathered ``(batch, n_shards * width)`` verdict
    matrix (shard-major: shard ``s`` slot ``k`` lands at
    ``s * width + k``)."""
    ordered = sorted(policy_ids)
    buckets: list[list[str]] = [[] for _ in range(n_shards)]
    for i, pid in enumerate(ordered):
        buckets[i % n_shards].append(pid)
    width = max(1, max((len(b) for b in buckets), default=1))
    column_of = {
        pid: s * width + k
        for s, bucket in enumerate(buckets)
        for k, pid in enumerate(bucket)
    }
    return [tuple(b) for b in buckets], width, column_of


def _row_split(n_rows: int, n_shards: int) -> list[slice]:
    if n_shards < 1 or n_rows % n_shards:
        raise ValueError(
            f"a batch of {n_rows} rows does not split over {n_shards} "
            "data shards (batches are bucketed to multiples of the data "
            "axis: bucket_for)"
        )
    b = n_rows // n_shards
    return [slice(d * b, (d + 1) * b) for d in range(n_shards)]


def shard_features(
    features: Mapping[str, np.ndarray], shards: int
) -> list[dict[str, np.ndarray]]:
    """A host batch split into ``shards`` data shards (this process's:
    ``len(Mesh.local_data_shards())``, 1 without a mesh): every array's
    rows split into contiguous, equal shards (views, no copy), one dict
    per data shard in data-axis order."""
    rows = next(iter(features.values())).shape[0] if features else 0
    cuts = _row_split(rows, shards)
    return [{k: v[s] for k, v in features.items()} for s in cuts]


def shard_delta_planes(
    delta: Mapping[str, np.ndarray], shards: int
) -> list[dict[str, np.ndarray]]:
    """Columnar delta planes split like ``shard_features``: planes of two
    or more dimensions (a leading batch dim) split over the data shards;
    1-D column-index vectors go whole to every shard (each shard scatters
    the same columns)."""
    batched = [v for v in delta.values() if v.ndim >= 2]
    rows = batched[0].shape[0] if batched else 0
    cuts = _row_split(rows, shards) if batched else [slice(None)] * shards
    return [
        {k: (v[s] if v.ndim >= 2 else v) for k, v in delta.items()}
        for s in cuts
    ]


def acceptance_psum(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """``(B, P)`` verdict bits of this process's rows → the ``(P,)``
    ``int32`` acceptance counts over the whole mesh, on the caller's
    device (the serving-metrics collective). The rows split over this
    process's data shards as a batch does; each process sums its own, and
    a mesh that spans processes adds them with one ``all_reduce(SUM)`` on
    the group ``initialize_distributed`` joined (gloo, so the counts
    cross on the host)."""
    shards = len(mesh.local_data_shards())
    spans = len(set(np.asarray(mesh.processes).ravel().tolist())) > 1

    def count(allowed: torch.Tensor) -> torch.Tensor:
        _row_split(allowed.shape[0], shards)
        local = allowed.sum(dim=0, dtype=torch.int32)
        if not spans:
            return local
        import torch.distributed as dist

        host = local.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM)
        return host.to(allowed.device)

    return count


def pad_batch_to(n: int, multiple: int) -> int:
    """``n`` rounded up to a multiple of ``multiple`` (the data axis):
    batches must divide it; pad-rows are all-missing and cost one masked
    lane each. ``EvaluationEnvironment.bucket_for`` rounds with it."""
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple
