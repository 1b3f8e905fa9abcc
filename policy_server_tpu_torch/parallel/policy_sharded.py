"""Policy-sharded evaluation, ``--mesh-dispatch threaded``: the policy set
split over the mesh's ``policy`` axis, one environment per shard, each
data-parallel over its row of the mesh.

Counterpart of ``policy_server_tpu/parallel/policy_sharded.py``. Policies
are heterogeneous programs, so this is MPMD: each shard owns one row of
the mesh (``plan_policy_shards``) and its own environment — its own K1
program over its own policies (``ops/cuda_kernels.py``), its verdict
cache and its breaker — and the host routes each policy id to its owning
shard. A batch that reaches several shards runs them concurrently on a
thread pool: a shard's ``validate_batch`` blocks on its card's CUDA event
with the GIL released, so another shard's host encode and device step
overlap it. The fused form (``attach_mesh`` with a policy axis, the
default) runs one device step per batch instead.

A resize re-factors the policy axis over the surviving devices and swaps
the routing in one assignment; the retired shards close when their last
dispatch drains, never on a timer."""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator, Mapping

# a module reference: the environment module imports parallel/mesh.py
from policy_server_tpu_torch.evaluation import environment as environment_mod
from policy_server_tpu_torch.evaluation.errors import PolicyNotFoundError
from policy_server_tpu_torch.models import AdmissionResponse, ValidateRequest
from policy_server_tpu_torch.models.policy import PolicyOrPolicyGroup
from policy_server_tpu_torch.parallel import mesh as mesh_mod


class _Routing:
    """One immutable routing snapshot (shards and the policy → shard owner
    map) with its lifecycle state: the dispatches in flight against it and
    whether a resize retired it. A retired snapshot closes when its last
    dispatch drains."""

    __slots__ = ("shards", "owner", "inflight", "retired", "closed")

    def __init__(
        self,
        shards: list[environment_mod.EvaluationEnvironment],
        owner: dict[str, int],
    ) -> None:
        self.shards = shards
        self.owner = owner
        self.inflight = 0  # guarded-by: PolicyShardedEvaluator._snapshot_lock
        self.retired = False  # guarded-by: PolicyShardedEvaluator._snapshot_lock
        self.closed = False  # guarded-by: PolicyShardedEvaluator._snapshot_lock


class PolicyShardedEvaluator:
    """Routes policy ids to per-shard ``EvaluationEnvironment``\\ s, with
    the environment surface the micro-batcher, the service layer and the
    server read, so they work unchanged on top of it."""

    def __init__(
        self,
        policies: Mapping[str, PolicyOrPolicyGroup],
        mesh: mesh_mod.Mesh,
        backend: str = "torch",
        continue_on_errors: bool = False,
        builder_kwargs: dict[str, Any] | None = None,
    ) -> None:
        from concurrent.futures import ThreadPoolExecutor

        self._policies = dict(policies)
        self._backend = backend
        self._continue_on_errors = continue_on_errors
        self._builder_kwargs = dict(builder_kwargs or {})
        self._resize_lock = threading.Lock()
        # overlaps the shards of one batch; sized to the configured policy
        # axis, which a resize never grows past
        self._shard_pool = ThreadPoolExecutor(
            max_workers=max(1, mesh.shape[mesh_mod.POLICY_AXIS]),
            thread_name_prefix="policy-shard",
        )
        # the snapshots' lifecycle state and the retired list: resize(),
        # the draining dispatch and close() all take it
        self._snapshot_lock = threading.Lock()
        # snapshots a resize retired while dispatches were still pinned to
        # them; each closes when its last dispatch drains
        self._retired: list[_Routing] = []  # guarded-by: _snapshot_lock
        self.mesh = mesh
        # the operator's policy axis: resize() re-factors toward it, so a
        # shrink can grow back
        self._configured_policy_axis = mesh.shape[mesh_mod.POLICY_AXIS]
        self.resizes = 0  # guarded-by: _resize_lock
        # shards and owner swap as ONE _Routing object, so routing always
        # reads a consistent pair across a concurrent resize
        try:
            self._routing: _Routing = _Routing(*self._build_shards(mesh))
        except BaseException:
            self._shard_pool.shutdown(wait=False)
            raise

    def _build_shards(
        self, mesh: mesh_mod.Mesh
    ) -> tuple[list[environment_mod.EvaluationEnvironment], dict[str, int]]:
        plans = mesh_mod.plan_policy_shards(list(self._policies), mesh)
        for plan in plans:
            ranks = sorted(set(plan.mesh.processes.ravel().tolist()))
            if len(ranks) > 1:
                # the JAX package's layout for this case cannot be checked
                # (its multi-process meshes fail on jax 0.9): refuse it
                raise ValueError(
                    f"--mesh-dispatch threaded: policy shard "
                    f"{plan.shard_index}'s submesh row "
                    f"{[str(d) for d in plan.mesh.devices.ravel()]} spans "
                    f"processes {ranks} of the {mesh.shape} mesh; a "
                    "threaded policy shard must lie within one process "
                    "(use --mesh-dispatch fused)"
                )
        # --verdict-cache-size is a TOTAL byte budget: split over the
        # shards (a resize's retired shards keep theirs until they drain)
        shard_kwargs = dict(self._builder_kwargs)
        total_cache = shard_kwargs.get("verdict_cache_size")
        if total_cache and len(plans) > 1:
            shard_kwargs["verdict_cache_size"] = total_cache // len(plans)
        shards: list[environment_mod.EvaluationEnvironment] = []
        owner: dict[str, int] = {}
        try:
            for plan in plans:
                kwargs = dict(shard_kwargs)
                if self._backend == "torch":
                    # the shard's environment lives on its row's first device
                    kwargs["device"] = plan.mesh.devices.ravel()[0]
                env = environment_mod.EvaluationEnvironmentBuilder(
                    backend=self._backend,
                    continue_on_errors=self._continue_on_errors,
                    **kwargs,
                ).build({pid: self._policies[pid] for pid in plan.policy_ids})
                shards.append(env)
                if self._backend == "torch" and plan.mesh.size > 1:
                    env.attach_mesh(plan.mesh)
                for pid in plan.policy_ids:
                    owner[pid] = plan.shard_index
        except BaseException:
            for env in shards:
                env.close()
            raise
        return shards, owner

    # -- preemption churn --------------------------------------------------

    def resize(self, devices: list[Any]) -> None:
        """Rebuild the shard set over a changed device set: the policy axis
        re-factors over the survivors (the largest divisor of their count
        up to the configured axis) and every shard is built anew. Serving
        goes on over the old shards until the new set is built; the swap
        is one assignment."""
        if not devices:
            raise ValueError("cannot resize to an empty device set")
        with self._resize_lock:
            new_policy_axis = min(self._configured_policy_axis, len(devices))
            while len(devices) % new_policy_axis:
                new_policy_axis -= 1
            spec = mesh_mod.MeshSpec.parse(
                f"data:{len(devices) // new_policy_axis},"
                f"policy:{new_policy_axis}"
            )
            new_mesh = mesh_mod.make_mesh(
                spec, devices, device_type=self._device_type()
            )
            # dispatches in flight finish on the old shards; new calls
            # route through the new set
            new_routing = _Routing(*self._build_shards(new_mesh))
            with self._snapshot_lock:
                old = self._routing
                self._routing = new_routing
                old.retired = True
                drained = old.inflight == 0
                if not drained:
                    self._retired.append(old)
            self.mesh = new_mesh
            self.resizes += 1
            if drained:
                self._close_snapshot(old)

    def _device_type(self) -> str:
        device = self._builder_kwargs.get("device")
        return "cuda" if device is None else str(device).split(":")[0]

    @contextlib.contextmanager
    def _pin_routing(self) -> Iterator[_Routing]:
        """Pin the current routing snapshot for one dispatch: a concurrent
        resize() cannot close its shards until this dispatch, and every
        other one pinned to it, drains."""
        with self._snapshot_lock:
            snap = self._routing
            snap.inflight += 1
        try:
            yield snap
        finally:
            with self._snapshot_lock:
                snap.inflight -= 1
                close_now = (
                    snap.retired and snap.inflight == 0 and not snap.closed
                )
                if close_now:
                    with contextlib.suppress(ValueError):
                        self._retired.remove(snap)
            if close_now:
                self._close_snapshot(snap)

    def _close_snapshot(self, snap: _Routing) -> None:
        # test-and-set under the lock: close() racing a draining
        # _pin_routing closes each environment once
        with self._snapshot_lock:
            if snap.closed:
                return
            snap.closed = True
        for env in snap.shards:
            env.close()

    # -- routing -----------------------------------------------------------

    @property
    def shards(self) -> list[environment_mod.EvaluationEnvironment]:
        return self._routing.shards

    @staticmethod
    def _shard_in(
        snap: _Routing, policy_id: str
    ) -> environment_mod.EvaluationEnvironment:
        idx = snap.owner.get(policy_id.split("/")[0])
        if idx is None:
            raise PolicyNotFoundError(policy_id)
        return snap.shards[idx]

    def _shard_of(self, policy_id: str) -> environment_mod.EvaluationEnvironment:
        return self._shard_in(self._routing, policy_id)

    # -- environment surface ----------------------------------------------

    def policy_ids(self) -> list[str]:
        out: list[str] = []
        for env in self.shards:
            out.extend(env.policy_ids())
        return sorted(out)

    def get_policy_mode(self, policy_id: str):
        return self._shard_of(policy_id).get_policy_mode(policy_id)

    def get_policy_allowed_to_mutate(self, policy_id: str) -> bool:
        return self._shard_of(policy_id).get_policy_allowed_to_mutate(policy_id)

    def should_always_accept_requests_made_inside_of_namespace(
        self, namespace: str
    ) -> bool:
        return any(
            env.should_always_accept_requests_made_inside_of_namespace(namespace)
            for env in self.shards
        )

    def pre_eval_hooks_of(self, target) -> list:
        return environment_mod.pre_eval_hooks_of(target)

    # the micro-batcher's name for the hooks of a target
    _hooks_of = pre_eval_hooks_of

    def payload_for(self, target, request):
        # every shard's builder shares the context service, so any shard
        # gives the same snapshot view
        return self.shards[0].payload_for(target, request)

    def _target_plain(self, target) -> bool:
        # the payload_for of the same shard decides it
        return self.shards[0]._target_plain(target)

    def _lookup_top_level(self, pid):
        return self._shard_of(str(pid))._lookup_top_level(pid)

    def validate(
        self, policy_id: str, request: ValidateRequest
    ) -> AdmissionResponse:
        with self._pin_routing() as snap:
            return self._shard_in(snap, policy_id).validate(policy_id, request)

    @property
    def host_fastpath_requests(self) -> int:
        return sum(env.host_fastpath_requests for env in self._routing.shards)

    @property
    def oracle_fallbacks(self) -> int:
        return sum(env.oracle_fallbacks for env in self._routing.shards)

    def record_dispatch_failure(self, policy_ids: Any = None) -> None:
        """A device failure the batcher saw (watchdog abandonment, a failed
        dispatch) marks the breakers of the shards that own the batch's
        policies only: a hung shard trips alone. Without ``policy_ids``
        every shard takes the mark."""
        snap = self._routing
        if not policy_ids:
            for env in snap.shards:
                env.record_dispatch_failure()
            return
        hit: set[int] = set()
        for pid in policy_ids:
            idx = snap.owner.get(str(pid).split("/")[0])
            if idx is not None and idx not in hit:
                hit.add(idx)
                snap.shards[idx].record_dispatch_failure()

    @property
    def breaker_all_open(self) -> bool:
        """True only when EVERY shard's device path is tripped, the state
        ``--degraded-mode`` keys on."""
        shards = self._routing.shards
        return bool(shards) and all(env.breaker_all_open for env in shards)

    def _summed(self, stats: str) -> dict[str, int]:
        totals: dict[str, int] = {}
        for env in self._routing.shards:
            for k, v in getattr(env, stats).items():
                totals[k] = totals.get(k, 0) + v
        return totals

    @property
    def breaker_stats(self) -> dict[str, int]:
        """Breaker counters summed over the shards."""
        return self._summed("breaker_stats")

    @property
    def device_errors(self) -> int:
        """Kernel and CUDA errors summed over the shards."""
        return sum(env.device_errors for env in self._routing.shards)

    @property
    def warmup_dispatches(self) -> int:
        """Device dispatches ONE ``warmup((b,))`` makes: every shard warms
        in turn, each its exact count — the batcher's RTT-seed divisor."""
        return max(
            1, sum(env.warmup_dispatches for env in self._routing.shards)
        )

    @property
    def plane_program_compiles(self) -> int:
        """Columnar plane structures built, summed over the shards."""
        return sum(env.plane_program_compiles for env in self._routing.shards)

    @property
    def batch_dedup_hits(self) -> int:
        return sum(env.batch_dedup_hits for env in self._routing.shards)

    @property
    def dedup_stats(self) -> dict[str, int]:
        """The two dedup tiers' counters summed over the shards (capacity
        too: each shard owns its share of the budget)."""
        return self._summed("dedup_stats")

    @property
    def host_profile(self) -> dict[str, int]:
        """Host-pipeline counters summed over the shards."""
        return self._summed("host_profile")

    @property
    def supports_host_fastpath(self) -> bool:
        return all(env.supports_host_fastpath for env in self._routing.shards)

    def validate_batch(
        self,
        items: list[tuple[str, ValidateRequest]],
        run_hooks: bool = True,
        prefer_host: bool = False,
    ) -> list[AdmissionResponse | Exception]:
        """Partition the batch by owning shard, run each shard's
        ``validate_batch`` (concurrently on the shard pool when the batch
        reaches more than one), and merge in submission order. Each
        environment is entered by one thread of this batch only."""
        with self._pin_routing() as snap:  # one consistent routing snapshot
            shards, owner = snap.shards, snap.owner
            per_shard: dict[int, list[int]] = {}
            results: list[AdmissionResponse | Exception | None] = (
                [None] * len(items)
            )
            for i, (pid, _) in enumerate(items):
                idx = owner.get(pid.split("/")[0])
                if idx is None:
                    results[i] = PolicyNotFoundError(pid)
                    continue
                per_shard.setdefault(idx, []).append(i)

            def run_shard(idx: int, indices: list[int]):
                return shards[idx].validate_batch(
                    [items[i] for i in indices],
                    run_hooks=run_hooks, prefer_host=prefer_host,
                )

            if len(per_shard) > 1:
                futures = {
                    idx: self._shard_pool.submit(run_shard, idx, indices)
                    for idx, indices in per_shard.items()
                }
                shard_outs = {idx: f.result() for idx, f in futures.items()}
            else:
                shard_outs = {
                    idx: run_shard(idx, indices)
                    for idx, indices in per_shard.items()
                }
            for idx, indices in per_shard.items():
                for i, r in zip(indices, shard_outs[idx]):
                    results[i] = r
            return results  # type: ignore[return-value]

    def warmup(self, batch_sizes: tuple[int, ...] = (1,)) -> None:
        for env in self.shards:
            env.warmup(batch_sizes)

    def close(self) -> None:
        """Close every shard environment, current and retired, and stop
        the shard pool (shutdown overrides drain-before-close). Each
        environment's close waits on the last event of every card it
        used."""
        with self._snapshot_lock:
            snaps = [self._routing] + self._retired
            self._retired = []
        for snap in snaps:
            self._close_snapshot(snap)
        self._shard_pool.shutdown(wait=False)
