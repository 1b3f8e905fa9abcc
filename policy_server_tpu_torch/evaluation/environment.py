"""EvaluationEnvironment — the policy registry and the batched evaluator.

Counterpart of ``policy_server_tpu/evaluation/environment.py`` for PyTorch
on an NVIDIA card. The registry is built once (builder → environment):
module dedup by digest, per-policy settings validated at boot, group
expressions type-checked at boot, ``policy_initialization_errors`` under
``continue_on_errors``. ``validate(policy_id, request)`` dispatches single
vs group targets.

The serving path (``validate_batch`` → ``_validate_batch_native``):

* a pre-encode BLOB-tier verdict-cache lookup answers exact payload
  replays (``evaluation/verdict_cache.py``);
* the native C++ encoder (``ops/fastenc.py``) writes every remaining
  request's packed ``uint8`` row in one call per schema bucket; rows that
  overflow a bucket cascade to the next, and rows beyond the widest fall
  back to the host oracle (``evaluation/oracle.py``, counted);
* one ``np.unique`` over the packed rows gives the ROW-tier lookup and the
  in-batch dedup, so only unique, uncached rows are dispatched;
* the device step is split: the enqueue copies the batch (narrowed to its
  transport form) to the card from page-locked memory, launches the
  ``policy_matrix`` kernel (``ops/cuda_kernels.py``), runs the group
  combine and the output packing as plain PyTorch, starts the copy back
  into a page-locked buffer and records a CUDA event; the fetch waits on
  that event. ``validate_batch_begin`` / ``validate_batch_finish`` expose
  the split, so the batcher encodes batch N+1 while batch N runs.

Which device program a batch gets is the JAX package's choice
(``_enqueue_features``, its ``_dispatch_features``): under ``kernel=
"pallas"`` (this package's default) a schema bucket's batches go to the
``policy_matrix`` kernel once the bucket has seen ``PALLAS_HOT_DISPATCHES``
dispatches, warmup included; every other batch runs the non-Pallas
program (``_eval_features``: each policy's compiled function as PyTorch
ops, then the combine), over the columnar delta planes (``columnar``: the
host ships only the nonzero columns of a bit-packed, a uint16 and an int32
plane in one page-locked copy, and the card rebuilds the rest from
resident zero tensors, ``_features_from_planes``) or over the transport
form's ``unpack_rows``. ``donate_buffers`` lets a columnar step drop its
device planes once the rebuild is enqueued.

A per-environment circuit breaker (``resilience.py``) guards every device
call and fetch; while it is open, batches are answered by the bit-exact
host oracle and counted. It counts raises at dispatch and fetch (failpoint
injections among them) and the batcher's watchdog abandonments, never an
error the CUDA runtime reported: a kernel or CUDA error is logged and
fails its batch's requests. ``validate_batch(prefer_host=True)`` is the
batcher's latency fast path: the targeted host oracle, sharing the
verdict cache.

With a flight recorder installed (``telemetry/flightrec.py``) the native
path stamps ``prepare``, ``blob_dedup``, ``encode``, ``bookkeeping``,
``submit`` (wasm bits to the step's launches enqueued), ``fetch``,
``materialize`` and, inside the fetch, ``device_execute`` (the wait on the
step's CUDA event), each under the batcher's batch id and with the
thread's CPU time; the host fast path stamps ``host_eval`` around its
row loop.

Host-executed policies (a program with a ``host_evaluator``: wasm
modules, CEL that does not lower) never reach the device on their own:
every path answers them from the host evaluator, and they are never
cached. A policy group with such members evaluates them on the host when
its rows are prepared; their verdict bits ride to the card behind the
batch's rows (``WASM_BITS_KEY``, one page-locked copy) and the combine
reads them there. ``module_resolver`` (the builder's) maps module URLs to
modules; the default knows builtins only.

Backends: ``torch`` (the device path; ``device="cpu"`` runs the kernels'
plain PyTorch versions, and the fetch is immediate) and ``oracle`` (the
host interpreter).

``close()`` retires an environment (the policy lifecycle closes every epoch
past its rollback pin): every later dispatch raises ``RuntimeError
("environment closed")``; the dispatches in progress are waited for (up to
a bound; past it the device state is kept, never freed under a launch);
then the CUDA events this environment recorded are waited on, and the
kernel programs' device code, the launch structs that point into it and
the page-locked buffer pool are dropped. The build's probe launch waits on
its own stream's event, never on the whole card, so building a reload
candidate does not wait for the serving epoch's batches.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import json
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from policy_server_tpu_torch import failpoints
from policy_server_tpu_torch.context import CONTEXT_KEY
from policy_server_tpu_torch.evaluation import groups as groups_mod
from policy_server_tpu_torch.evaluation import oracle as oracle_mod
from policy_server_tpu_torch.evaluation.errors import (
    BootstrapFailure,
    PolicyInitializationError,
    PolicyNotFoundError,
)
from policy_server_tpu_torch.evaluation.policy_id import PolicyID
from policy_server_tpu_torch.evaluation.precompiled import (
    PolicyModule,
    PrecompiledPolicy,
    ProgramCache,
)
from policy_server_tpu_torch.evaluation.settings import PolicyEvaluationSettings
from policy_server_tpu_torch.evaluation.verdict_cache import (
    VerdictCache,
    extract_row,
)
from policy_server_tpu_torch.models import (
    AdmissionResponse,
    StatusCause,
    StatusDetails,
    ValidateRequest,
    ValidationStatus,
)
from policy_server_tpu_torch.models.admission import (
    JSON_PATCH,
    FragTemplate,
    FragVerdict,
)
from policy_server_tpu_torch.models.policy import (
    Policy,
    PolicyGroup,
    PolicyMode,
    PolicyOrPolicyGroup,
)
from policy_server_tpu_torch.ops import cuda_kernels, fastenc
from policy_server_tpu_torch.ops.codec import (
    BATCH_KEY,
    DEFAULT_AXIS_CAP,
    DEFAULT_NESTED_AXIS_CAP,
    PACKED_KEY,
    FeatureSchema,
    SchemaOverflow,
    ensure_unique_packed_widths,
    mask_key_for,
    unpack_rows,
)
from policy_server_tpu_torch.ops.compiler import compile_constant, compile_program
from policy_server_tpu_torch.ops.optimizer import (
    PolicyOptimization,
    optimize_policy_set,
)
from policy_server_tpu_torch.parallel import mesh as mesh_mod
from policy_server_tpu_torch.policies import resolve_builtin
from policy_server_tpu_torch.resilience import CircuitBreaker
from policy_server_tpu_torch.telemetry import flightrec
from policy_server_tpu_torch.utils.interning import InternTable

logger = logging.getLogger("kubewarden-policy-server")

GROUP_MUTATION_MESSAGE = "mutation is not allowed inside of policy group"


# wasm_wall_clock_budget's "not given" sentinel, distinct from None: None
# DISABLES the wasm wall-clock budget
_BUDGET_UNSET = object()

# Device input carrying the host-computed verdict bits of wasm group
# members, shape (batch, n_wasm_members) bool: how host-executed policies
# join the device group combine
WASM_BITS_KEY = "__wasm_bits__"

# The device program forms (``--kernel``): ``pallas`` sends a schema
# bucket's batches to the policy_matrix kernel (K1) once the bucket is hot,
# and the non-Pallas program (PyTorch ops) serves the rest; ``xla`` serves
# every batch with the non-Pallas program. The port's default is
# ``pallas``, where the JAX package's is ``xla``: K1 is this package's
# main path.
KERNELS = ("xla", "pallas")
DEFAULT_KERNEL = "pallas"

# A schema bucket arms for K1 once this many batches have dispatched into
# it (warmup dispatches count, so the default warmup arms every bucket)
PALLAS_HOT_DISPATCHES = 8

# element-axis caps of the small schema bucket (the large bucket uses the
# codec's defaults, 64 and 32); the JAX package's defaults
SMALL_AXIS_CAP = 8
SMALL_NESTED_AXIS_CAP = 4

# How a delta plane's numpy dtype is viewed on the card: uint16 ids as
# int16 (PyTorch's uint16 supports few ops; the rebuild widens them without
# the sign), the rest as themselves
_PLANE_DTYPES = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint16): torch.int16,
    np.dtype(np.int32): torch.int32,
}


def _on(device: torch.device) -> Any:
    """The CUDA device context of ``device``; nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# Verdict-cache budget in BYTES, split evenly between the blob tier
# (pre-encode exact-replay dedup) and the row tier (post-encode
# uid-insensitive dedup); 0 disables caching AND in-batch row dedup.
DEFAULT_VERDICT_CACHE_SIZE = 256 * 1024 * 1024

# Cached-row key under which a row dict carries its per-target
# FragTemplate map ({cache key of target: FragTemplate | False}); the
# materializers never read it and extract_row copies it along.
FRAG_KEY = "__frag__"

# Thread-local arming flag: FragVerdicts go only to callers that handle
# them (the batcher's pipeline, which runs begin and finish on one thread);
# direct validate_batch callers keep getting AdmissionResponse rows.
_frag_scope = threading.local()


class fragment_responses:
    """Context manager arming the cache-hit fragment lane on this thread
    (see FRAG_KEY). Entered by the batcher around its pipeline call."""

    __slots__ = ("_prev",)

    def __enter__(self) -> "fragment_responses":
        self._prev = getattr(_frag_scope, "on", False)
        _frag_scope.on = True
        return self

    def __exit__(self, *exc) -> None:
        _frag_scope.on = self._prev


def _fragments_enabled() -> bool:
    return getattr(_frag_scope, "on", False)


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """The device the environment runs on: the card unless the caller
    names another. Never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "kernels' plain PyTorch versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class _RowView:
    """Zero-copy row view over the batched output arrays."""

    __slots__ = ("_outputs", "_row")

    def __init__(self, outputs: Mapping[str, Any], row: int):
        self._outputs = outputs
        self._row = row

    def __getitem__(self, key: str) -> Any:
        return self._outputs[key][self._row]

    def get(self, key: str, default: Any = None) -> Any:
        arr = self._outputs.get(key)
        return default if arr is None else arr[self._row]


class PinnedBuffers:
    """Page-locked host buffers of one environment (one card), kept per
    (shape, dtype) — the batch bucket fixes the shape — and lent to ONE
    device step at a time: a buffer returns to the pool only after the
    fetch that owns it has read it, so a pipeline worker never writes a
    buffer another is still reading."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._free: dict[tuple, list[torch.Tensor]] = {}  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock

    def close(self) -> None:
        """Drop every pooled buffer; buffers given back later are dropped
        too."""
        with self._lock:
            self._closed = True
            self._free.clear()

    def take(self, shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
        with self._lock:
            free = self._free.get((shape, dtype))
            if free:
                return free.pop()
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def give(self, *buffers: torch.Tensor) -> None:
        with self._lock:
            if self._closed:
                return
            for b in buffers:
                self._free.setdefault((tuple(b.shape), b.dtype), []).append(b)


class InflightStep:
    """One enqueued device step: the CUDA events recorded after its copy
    back, one per data shard (one without a mesh), and the page-locked
    input and output buffers it holds until :meth:`wait` has read the
    output. ``device_in``, when set, is the step's device inputs, held
    until the fetch (``--donate-buffers off``). On the CPU the output is
    ready at enqueue and ``wait`` returns it at once."""

    __slots__ = ("events", "host_in", "host_out", "pool", "ready", "device_in")

    def __init__(
        self,
        events: tuple = (),
        host_in: torch.Tensor | None = None,
        host_out: torch.Tensor | None = None,
        pool: PinnedBuffers | None = None,
        ready: np.ndarray | None = None,
        device_in: list[torch.Tensor] | None = None,
    ) -> None:
        self.events = events
        self.host_in = host_in
        self.host_out = host_out
        self.pool = pool
        self.ready = ready
        self.device_in = device_in

    def wait(self) -> np.ndarray:
        if self.ready is not None:
            return self.ready
        for event in self.events:
            event.synchronize()
        out = self.host_out.numpy().copy()
        self.pool.give(self.host_in, self.host_out)
        self.device_in = None
        self.ready = out
        return out


def pre_eval_hooks_of(target: "BoundPolicy | BoundGroup") -> list:
    targets = (
        list(target.members.values())
        if isinstance(target, BoundGroup)
        else [target]
    )
    return [
        bp.precompiled.program.pre_eval_hook
        for bp in targets
        if bp.precompiled.program.pre_eval_hook is not None
    ]


def bucket_size(n: int) -> int:
    """Round a batch length up to the next power of two."""
    b = 1
    while b < n:
        b <<= 1
    return b


@dataclass
class BoundPolicy:
    """A module bound to settings under a policy id ('name' or
    'group/member')."""

    policy_id: str
    module_url: str
    precompiled: PrecompiledPolicy
    eval_settings: PolicyEvaluationSettings
    # per-policy cluster-state capability allowlist (reference
    # EvaluationContext.ctx_aware_resources_allow_list,
    # evaluation_environment.rs:243-247)
    ctx_allowlist: frozenset = frozenset()


@dataclass
class BoundGroup:
    name: str
    expression: str
    ast: Any
    message: str
    policy_mode: PolicyMode
    members: dict[str, BoundPolicy] = field(default_factory=dict)


def default_module_resolver(url: str) -> PolicyModule:
    builtin = resolve_builtin(url)
    if builtin is None:
        raise BootstrapFailure(
            f"module {url!r} is not a builtin and no fetcher was configured "
            "(serve it through PolicyServer, which fetches file://, https:// "
            "and registry:// modules per --sources-path and "
            "--verification-path, or pass fetch.make_module_resolver(...) "
            "as module_resolver)"
        )
    return builtin


class EvaluationEnvironmentBuilder:
    """Boot-time assembly of an :class:`EvaluationEnvironment`.

    ``device`` defaults to the card; with no card the builder raises
    unless the caller asks for ``device="cpu"``. The ``oracle`` backend
    needs no device.

    ``module_resolver`` maps a module URL to a policy module; the default
    resolves builtins and raises ``BootstrapFailure`` for anything else
    (``fetch.make_module_resolver`` fetches and verifies artifacts).
    ``wasm_wall_clock_budget``, when given, is set on every module that
    has a ``wall_clock_budget`` (None disables it); ``wasm_trust_root``
    (the offline sigstore trust root) and ``wasm_oci_digest_source`` (an
    image ref → its manifest digest, ``Downloader.manifest_digest``) are
    handed to every wasm module for the keyless ``v2/verify`` and the
    ``oci/v1/manifest_digest`` capabilities. ``context_service`` (a
    ``context.ContextSnapshotService``) gives every context-aware policy
    the capability-filtered cluster snapshot under ``__context__``.
    ``kernel``, ``columnar`` and ``donate_buffers`` are the device path's
    forms (``--kernel``, ``--columnar``, ``--donate-buffers``; see
    :class:`EvaluationEnvironment`)."""

    def __init__(
        self,
        backend: str = "torch",
        device: "str | torch.device | None" = None,
        continue_on_errors: bool = False,
        always_accept_admission_reviews_on_namespace: str | None = None,
        predicate_opt: bool = True,
        verdict_cache_size: int = DEFAULT_VERDICT_CACHE_SIZE,
        breaker_config: Mapping[str, Any] | None = None,
        module_resolver: Callable[[str], PolicyModule] | None = None,
        wasm_wall_clock_budget: float | None | object = _BUDGET_UNSET,
        wasm_trust_root: Any = None,
        wasm_oci_digest_source: Callable[[str], str] | None = None,
        context_service: Any = None,
        kernel: str = DEFAULT_KERNEL,
        columnar: bool = True,
        donate_buffers: bool = True,
    ) -> None:
        if backend not in ("torch", "oracle"):
            raise ValueError(f"unknown backend {backend!r}")
        if kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r} (expected one of {KERNELS})")
        self.backend = backend
        self.kernel = kernel
        self.columnar = columnar
        self.donate_buffers = donate_buffers
        self.device = resolve_device(device) if backend == "torch" else None
        self.continue_on_errors = continue_on_errors
        self.always_accept_namespace = always_accept_admission_reviews_on_namespace
        self.predicate_opt = predicate_opt
        self.verdict_cache_size = verdict_cache_size
        self.breaker_config = breaker_config
        self.module_resolver = module_resolver or default_module_resolver
        self.wasm_wall_clock_budget = wasm_wall_clock_budget
        self.wasm_trust_root = wasm_trust_root
        self.wasm_oci_digest_source = wasm_oci_digest_source
        self.context_service = context_service

    def build(
        self, policies: Mapping[str, PolicyOrPolicyGroup]
    ) -> "EvaluationEnvironment":
        from policy_server_tpu_torch.fetch.downloader import (
            FetchError,
            VerificationError,
        )

        acquisition_errors = (FetchError, VerificationError)
        cache = ProgramCache()
        bound: dict[str, BoundPolicy] = {}
        groups: dict[str, BoundGroup] = {}
        init_errors: dict[str, str] = {}

        def bootstrap_policy(
            pid: str,
            module_url: str,
            settings: Mapping[str, Any] | None,
            policy_mode: PolicyMode,
            allowed_to_mutate: bool,
            ctx_allowlist: frozenset = frozenset(),
        ) -> BoundPolicy:
            module = self.module_resolver(module_url)
            if self.wasm_wall_clock_budget is not _BUDGET_UNSET and hasattr(
                module, "wall_clock_budget"
            ):
                module.wall_clock_budget = self.wasm_wall_clock_budget
            if self.wasm_trust_root is not None and hasattr(
                module, "trust_root"
            ):
                module.trust_root = self.wasm_trust_root
            if self.wasm_oci_digest_source is not None and hasattr(
                module, "oci_digest_source"
            ):
                module.oci_digest_source = self.wasm_oci_digest_source
            validation = module.validate_settings(dict(settings or {}))
            if not validation.valid:
                raise PolicyInitializationError(
                    pid, f"Policy settings are invalid: {validation.message or ''}"
                )
            pre = cache.get_or_build(module, settings or {})
            return BoundPolicy(
                policy_id=pid,
                module_url=module_url,
                precompiled=pre,
                eval_settings=PolicyEvaluationSettings(
                    policy_mode=policy_mode,
                    allowed_to_mutate=allowed_to_mutate,
                    settings=dict(settings or {}),
                ),
                ctx_allowlist=ctx_allowlist,
            )

        for name, entry in policies.items():
            try:
                if isinstance(entry, Policy):
                    bound[name] = bootstrap_policy(
                        name,
                        entry.module,
                        entry.settings,
                        entry.policy_mode,
                        bool(entry.allowed_to_mutate),
                        entry.context_aware_resources,
                    )
                elif isinstance(entry, PolicyGroup):
                    ast = groups_mod.validate_expression(
                        entry.expression, set(entry.policies)
                    )
                    group = BoundGroup(
                        name=name,
                        expression=entry.expression,
                        ast=ast,
                        message=entry.message,
                        policy_mode=entry.policy_mode,
                    )
                    # wasm members are served: their verdicts are computed
                    # on the host and join the device group combine as
                    # input bits (WASM_BITS_KEY)
                    for member_name, member in entry.policies.items():
                        group.members[member_name] = bootstrap_policy(
                            f"{name}/{member_name}",
                            member.module,
                            member.settings,
                            entry.policy_mode,
                            False,  # group members never mutate
                            member.context_aware_resources,
                        )
                    groups[name] = group
                    for bp in group.members.values():
                        bound[bp.policy_id] = bp
                else:
                    raise BootstrapFailure(
                        f"unknown policy entry type for {name!r}"
                    )
            except (
                PolicyInitializationError,
                groups_mod.ExpressionError,
                BootstrapFailure,
                KeyError,
                ValueError,
            ) as e:
                if not self.continue_on_errors:
                    raise BootstrapFailure(
                        f"failed to bootstrap policy {name!r}: {e}"
                    ) from e
                init_errors[name] = str(e)
            except acquisition_errors as e:
                # a module that could not be fetched or verified: its own
                # error at boot (the JAX package's text), a per-policy
                # initialization error under continue_on_errors, as the
                # reference's per-policy download errors are
                # (policy_downloader.rs:53-217)
                if not self.continue_on_errors:
                    raise
                init_errors[name] = str(e)

        env = EvaluationEnvironment(
            backend=self.backend,
            device=self.device,
            bound=bound,
            groups=groups,
            init_errors=init_errors,
            always_accept_namespace=self.always_accept_namespace,
            predicate_opt=self.predicate_opt,
            verdict_cache_size=self.verdict_cache_size,
            breaker_config=self.breaker_config,
            context_service=self.context_service,
            kernel=self.kernel,
            columnar=self.columnar,
            donate_buffers=self.donate_buffers,
        )
        # the mapping it was built from: the shard router rebuilds sibling
        # environments from it (runtime/shards.py); the serving path never
        # reads it
        env.source_policies = dict(policies)
        return env


_NO_CACHE_STATS = {
    "cache_hits": 0,
    "cache_misses": 0,
    "cache_entries": 0,
    "cache_bytes": 0,
    "cache_capacity": 0,
}


class EvaluationEnvironment:
    """The post-boot registry and the batched evaluator. The registry is
    read-only after construction; the counters, caches and lazily built
    kernel programs are guarded by their own locks."""

    # largest single device dispatch; bigger lists are chunked
    max_dispatch_batch = 1024
    # dispatches a chunked list keeps in flight before it fetches the oldest
    max_inflight_dispatches = 32

    def __init__(
        self,
        backend: str,
        device: torch.device | None,
        bound: dict[str, BoundPolicy],
        groups: dict[str, BoundGroup],
        init_errors: dict[str, str],
        always_accept_namespace: str | None = None,
        predicate_opt: bool = True,
        verdict_cache_size: int = DEFAULT_VERDICT_CACHE_SIZE,
        breaker_config: Mapping[str, Any] | None = None,
        context_service: Any = None,
        kernel: str = DEFAULT_KERNEL,
        columnar: bool = True,
        donate_buffers: bool = True,
    ) -> None:
        self.backend = backend
        self.device = device
        # the device program forms; the oracle backend has no device path
        self.kernel = kernel if backend == "torch" else "xla"
        self.columnar = bool(columnar) and backend == "torch"
        self.donate_buffers = bool(donate_buffers)
        self.always_accept_namespace = always_accept_namespace
        self.context_service = context_service
        self._bound = bound
        self._groups = groups
        self._init_errors = init_errors
        self._lock = threading.Lock()  # kernel programs and the table swap
        self.table = InternTable()
        exprs = [
            rule.condition
            for bp in bound.values()
            for rule in bp.precompiled.program.rules
        ]
        # element-axis shape buckets: a request encodes into the smallest
        # schema whose caps fit; the widest schema's caps are the oracle
        # fallback boundary
        cap_buckets = [
            (SMALL_AXIS_CAP, SMALL_NESTED_AXIS_CAP),
            (DEFAULT_AXIS_CAP, DEFAULT_NESTED_AXIS_CAP),
        ]
        # the predicate optimizer (CSE keys, constant folding, dead-field
        # and mask pruning) runs before the schema is built; the oracle
        # backend interprets the ORIGINAL IR
        self.predicate_opt = bool(predicate_opt) and backend == "torch"
        self.optimization = None
        schema_exprs = exprs
        unmasked: frozenset = frozenset()
        if self.predicate_opt:
            self.optimization = optimize_policy_set(
                {pid: bp.precompiled.program for pid, bp in bound.items()}
            )
            schema_exprs = self.optimization.surviving_exprs
            unmasked = self.optimization.unmasked_value_keys
        self.schemas = [
            FeatureSchema.build(
                schema_exprs, axis_cap=a, nested_axis_cap=n, unmasked=unmasked
            )
            for a, n in cap_buckets
        ]
        self.schema = self.schemas[-1]
        # the optimizer's pruning accounting against the unoptimized
        # schema (optimizer_stats), computed on the first read: a reload
        # candidate's build does not pay for it
        self._opt_accounting: tuple[int, int] | None = None
        self._opt_base_exprs = exprs if self.optimization is not None else None
        self._opt_cap_buckets = list(cap_buckets)
        # the device selects a layout by row width, so widths must be
        # unique across schemas and buffer forms; fixed before the native
        # encoder captures the row stride
        ensure_unique_packed_widths(self.schemas)
        if backend == "torch":
            # the native encoder is the serving path's only encoder: a
            # failed g++ build raises here, with g++'s output
            for schema in self.schemas:
                fastenc.attach_native(schema)
        self._policy_order = list(bound)
        self._policy_index = {pid: j for j, pid in enumerate(self._policy_order)}
        # uint8 outputs when every rule index fits a byte
        self._compact_outputs = all(
            len(bp.precompiled.program.rules) < 255 for bp in bound.values()
        )
        self._group_order = list(groups)
        self._max_group_members = max(
            (len(g.members) for g in groups.values()), default=0
        )
        self._single_mat: dict[str, tuple[str, str]] = {
            pid: (f"p:{pid}:allowed", f"p:{pid}:rule") for pid in bound
        }
        self._group_mat: dict[str, tuple] = {}
        for name, group in groups.items():
            members = [
                (
                    m,
                    bp,
                    f"g:{name}:eval:{m}",
                    f"p:{bp.policy_id}:allowed",
                    f"p:{bp.policy_id}:rule",
                    f"wm:{bp.policy_id}:mutated",
                    f"wm:{bp.policy_id}:msg",
                    bp.precompiled.program.host_evaluator is not None,
                    bp.precompiled.program.mutator,
                )
                for m, bp in group.members.items()
            ]
            # members that could trip the group-mutation ban: a mutator or
            # a wasm evaluator
            risky = [e for e in members if e[7] or e[8] is not None]
            self._group_mat[name] = (f"g:{name}:allowed", members, risky)
        # Host-executed (wasm) group members: their verdict bits reach the
        # device combine as the WASM_BITS_KEY input, one column per member
        # in this order. Standalone wasm policies are not listed: they
        # bypass the device (_host_executed).
        self._wasm_member_order = [
            bp.policy_id
            for g in groups.values()
            for bp in g.members.values()
            if bp.precompiled.program.host_evaluator is not None
        ]
        self._wasm_member_col = {
            pid: j for j, pid in enumerate(self._wasm_member_order)
        }
        self._groups_with_wasm = {
            g.name
            for g in groups.values()
            if any(
                bp.precompiled.program.host_evaluator is not None
                for bp in g.members.values()
            )
        }
        # the device path's breaker: dispatch and fetch faults, and the
        # batcher's watchdog abandonments (record_dispatch_failure), trip
        # it; while open, batches short-circuit to the host oracle
        self.breaker = (
            CircuitBreaker(**dict(breaker_config or {}))
            if backend == "torch"
            else None
        )
        # the two-tier verdict cache (verdict_cache.py): the byte budget
        # splits between the blob and the row tier; the oracle backend is
        # the independent reference and always recomputes
        caching = verdict_cache_size > 0 and backend == "torch"
        self._verdict_cache = (
            VerdictCache(max(1, verdict_cache_size // 2)) if caching else None
        )
        self._blob_cache = (
            VerdictCache(max(1, verdict_cache_size - verdict_cache_size // 2))
            if caching
            else None
        )
        self._stats_lock = threading.Lock()
        self._oracle_fallbacks = 0  # guarded-by: _stats_lock
        # requests answered host-side because the breaker was open
        self._breaker_short_circuited = 0  # guarded-by: _stats_lock
        # kernel and CUDA errors at dispatch or fetch (kept from the breaker)
        self._device_errors = 0  # guarded-by: _stats_lock
        # rows answered by validate_batch(prefer_host=True)
        self._host_fastpath_requests = 0  # guarded-by: _stats_lock
        # rows answered by another identical row of the SAME batch
        self._batch_dedup_hits = 0  # guarded-by: _stats_lock
        # rows answered as pre-built fragments
        self._frag_hits = 0  # guarded-by: _stats_lock
        # where the native path's host time goes: ns totals and row counts
        self._host_profile: dict[str, int] = {  # guarded-by: _stats_lock
            "encode_ns": 0,  # the native encode calls
            "encode_rows": 0,  # rows that went through the encoder
            "bookkeeping_ns": 0,  # both dedup tiers and slot bookkeeping
            "bookkeeping_rows": 0,
            "dispatch_wait_ns": 0,  # blocked in the fetch
            "dispatched_rows": 0,  # unique rows sent to the device
            "dispatched_chunks": 0,
            # the columnar transport
            "wire_bytes_shipped": 0,  # bytes of the shipped planes
            "wire_bytes_packed_equiv": 0,  # what the transport form ships
            "wire_rows": 0,
            "delta_cols_shipped": 0,  # 32-bit columns shipped
            "delta_cols_total": 0,  # 32-bit columns in the schema
            "donated_dispatches": 0,
            "resident_const_bytes": 0,  # zero planes rebuilt on the device
        }
        # --kernel pallas: batches per schema bucket, the buckets armed for
        # K1 and K1's dispatches
        self._bucket_dispatches: dict[int, int] = {}  # guarded-by: _stats_lock
        self._pallas_armed: set[int] = set()  # guarded-by: _stats_lock
        self._pallas_dispatches = 0  # guarded-by: _stats_lock
        # the (form, shapes) combinations dispatched so far, and their
        # count: the first dispatch of each is the JAX package's program
        # compile, and the batcher drops the RTT sample it lands in
        self._plane_combos: set = set()  # guarded-by: _stats_lock
        self._plane_compiles = 0  # guarded-by: _stats_lock
        # read-only zero tensors standing in for the planes a columnar
        # dispatch did not ship, per (shape, dtype, device); written under
        # _lock, read without it (a dict lookup is atomic under the GIL)
        self._resident: dict[tuple, torch.Tensor] = {}
        # hot-loop memos over the immutable registry (dict get/set is
        # atomic under the GIL; racing builders store identical values)
        self._target_memo: dict[str, Any] = {}
        self._hooks_memo: dict[int, list] = {}
        self._blob_plain_memo: dict[int, bool] = {}
        self._frag_eligible_memo: dict[int, bool] = {}
        self._pinned = PinnedBuffers()
        # close(): the dispatches in progress, and the last CUDA event this
        # environment recorded on each stream
        self._gate = threading.Condition()
        self._active = 0  # guarded-by: _gate
        self._closed = False  # guarded-by: _gate
        # keyed by (card, stream handle)
        self._last_events: dict[tuple[int, int], Any] = {}  # guarded-by: _gate
        # the device mesh (attach_mesh): this process's data shards, each
        # the list of its devices along the policy axis (without a mesh,
        # one shard of this environment's device); under a policy axis > 1
        # the round-robin policy buckets, their common block width and
        # each policy's column in the gathered verdict matrix. Batches
        # bucket to multiples of the data axis (bucket_for).
        self._mesh: Any = None
        self._mesh_shards: list[list[torch.device]] = [[device]]
        self._mesh_buckets: list[tuple[str, ...]] = []
        self._mesh_block_width = 0
        self._mesh_policy_col: dict[str, int] = {}
        self._min_bucket = 1
        self._compile()
        if backend == "torch" and device is not None and device.type == "cuda":
            self._probe_device()

    # -- compilation -------------------------------------------------------

    def _sources(self) -> dict[str, PolicyOptimization]:
        """Each policy's rule conditions (optimizer-folded when the
        optimizer is on) or constant verdict — the tape's input."""
        if self.optimization is not None:
            return dict(self.optimization.policies)
        return {
            pid: PolicyOptimization(
                tuple(r.condition for r in bp.precompiled.program.rules)
            )
            for pid, bp in self._bound.items()
        }

    def _compile(self) -> None:
        """(Re)build the plain compiled functions and the kernel programs
        from the current intern table. Kernel programs for the transport
        forms build eagerly, which interns every string constant now —
        later builds (the wide form) cannot shift an id."""
        table = self.table
        self._compiled: dict[str, Callable] = {}
        for pid, src in self._sources().items():
            if src.constant is not None:
                self._compiled[pid] = compile_constant(*src.constant)
            else:
                self._compiled[pid] = compile_program(
                    self._bound[pid].precompiled.program,
                    self.schema,
                    table,
                    conditions=src.conditions,
                )
        for schema in self.schemas:
            schema.register_preds(table)
        self._programs: dict[tuple, Any] = {}
        self._combine_cols: dict[tuple, torch.Tensor] = {}
        if self.backend != "torch":
            return
        self._build_transport_programs()

    def _build_transport_programs(self) -> None:
        """Build the transport forms' programs, each policy shard's too
        under a policy axis."""
        shards = [None, *range(len(self._mesh_buckets))]
        for idx, schema in enumerate(self.schemas):
            for shard in shards:
                if schema.packed_layout().u16_count:
                    self.program_for(idx, True, True, shard)
                self.program_for(idx, True, False, shard)

    def program_for(
        self,
        schema_idx: int,
        transport: bool,
        narrow: bool,
        shard: int | None = None,
    ) -> "cuda_kernels.PolicyMatrixProgram":
        """The ``policy_matrix`` program of one schema bucket and buffer
        form (built on first use); with ``shard``, that policy shard's
        program under the mesh's policy axis: its bucket alone, padded to
        the shard block's width (K1's per-shard tile plan)."""
        key = (schema_idx, transport, narrow)
        plan: dict[str, Any] = {}
        if shard is not None:
            key += (shard,)
            plan = dict(
                buckets=[self._mesh_buckets[shard]],
                width=self._mesh_block_width,
            )
        with self._lock:
            program = self._programs.get(key)
            if program is None:
                program = self._programs[key] = cuda_kernels.build_policy_matrix(
                    self.schemas[schema_idx].packed_layout(),
                    transport,
                    narrow,
                    self._compiled,
                    self._sources(),
                    self.table,
                    use_cse=self.optimization is not None,
                    **plan,
                )
        return program

    def _probe_device(self) -> None:
        """Build the kernel library and launch the probe kernel once: a
        failed build or launch raises with the compiler's or the CUDA
        runtime's text."""
        cuda_kernels.build_library()
        # on a stream of its own: waiting on its event waits for the probe,
        # not for the batches other environments run on the card
        stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(stream):
            x = torch.arange(8 * 128, dtype=torch.float32, device=self.device)
            x = x.reshape(8, 128)
            y = cuda_kernels.probe(x)
            ok = torch.equal(y, x + 1.0)
        if not ok:
            raise RuntimeError("probe kernel returned a wrong result")

    # -- retirement --------------------------------------------------------

    def _enter(self) -> None:
        """Start a dispatch; raises once the environment is closed."""
        with self._gate:
            if self._closed:
                raise RuntimeError("environment closed")
            self._active += 1

    def _leave(self) -> None:
        with self._gate:
            self._active -= 1
            if not self._active:
                self._gate.notify_all()

    def close(self, timeout: float = 30.0) -> bool:
        """Retire the environment (idempotent): refuse later dispatches,
        wait up to ``timeout`` seconds for those in progress, wait on the
        CUDA events it recorded, then drop the kernel programs' device
        code and launch structs and the page-locked buffers. False when a
        dispatch was still running at the bound: the device state is then
        kept, since freeing it under a launch would be a use after free.
        Called by whoever built the environment, never by a batcher."""
        with self._gate:
            if self._closed:
                return True
            self._closed = True
            drained = self._gate.wait_for(lambda: self._active == 0, timeout)
            events = list(self._last_events.values())
            self._last_events.clear()
        if not drained:
            logger.warning(
                "environment closed with a dispatch still running after "
                "%.1f s; its device code is kept", timeout,
            )
            return False
        for event in events:
            event.synchronize()
        with self._lock:
            programs = list(self._programs.values())
            self._programs = {}
            self._combine_cols = {}
            self._resident = {}
        for program in programs:
            program.release_device_code()
        self._pinned.close()
        return True

    def install_reference_state(
        self, strings: Sequence[str], layouts: Sequence[Mapping[str, Any]]
    ) -> None:
        """Install another environment's intern table and check its packed
        layouts, given as plain data: ``strings`` are the table's strings
        in id order from id 1 (id 0 is the reserved MISSING id), and
        ``layouts`` each schema's ``PackedLayout`` fields
        (``dataclasses.asdict``). Afterwards a packed buffer encoded by
        that environment evaluates unchanged here. The verdict cache is
        emptied: its row keys are packed bytes of the old ids. Raises
        ValueError when a layout differs."""
        if len(layouts) != len(self.schemas):
            raise ValueError(
                f"{len(layouts)} layouts given for {len(self.schemas)} schemas"
            )
        for i, (schema, want) in enumerate(zip(self.schemas, layouts)):
            have = _plain(dataclasses.asdict(schema.packed_layout()))
            if have != _plain(want):
                raise ValueError(f"schema {i}: packed layout differs")
        table = InternTable()
        for i, s in enumerate(strings, start=1):
            if table.intern(s) != i:
                raise ValueError(f"duplicate string {s!r} in the intern table")
        with self._lock:
            self.table = table
        self._compile()
        self.reset_verdict_cache()

    # -- the device mesh (parallel/mesh.py) ---------------------------------

    def attach_mesh(self, mesh: "mesh_mod.Mesh") -> None:
        """Serve every device step over a device mesh, the JAX package's
        ``attach_mesh``: the batch rows split into contiguous data shards
        (buckets round up to multiples of the data axis, ``bucket_for``),
        and each of this process's data shards runs on its own devices.

        * Data axis only: a data shard's rows run the whole program (K1's
          full program, or the non-Pallas program) on its device.
        * Policy axis > 1, the fused form: the policy set splits
          round-robin into shards (``plan_policy_buckets``); position
          (p, d) runs shard p's policies on data shard d's rows — K1's
          per-shard program, or shard p's compiled predicates with one CSE
          table per shard, each block padded to the common width. The
          blocks are gathered shard-major on data shard d's first device
          (the JAX package's all-gather over the policy axis) and the
          group combine runs there per data shard.

        Every data shard's output is copied back into its rows of one
        page-locked buffer, with an event per data shard. A row's verdicts
        depend on that row alone, so every split answers as one device
        does.

        Multi-process (``torch.distributed``): each process holds only its
        own data shards — ``make_mesh`` keeps each within one host, data
        axis outermost — and serves only its own requests on them, as the
        JAX package's ``_device_fetch`` and ``_local_rows`` give each host
        its local rows. The policy axis is host-local and the data axis
        needs no collective, so no tensor crosses processes and no step
        waits for another process: the answers are those of one device.
        Columnar stays off there (``_columnar_mesh_ok``), so the columnar
        accounting reads as the JAX package's.

        A mesh position on a device that is not present, or of another
        type than this environment's device, raises."""
        if self.backend != "torch":
            raise ValueError("a mesh needs the torch backend")
        shards = mesh.local_data_shards()
        if not shards:
            raise ValueError(
                f"mesh {mesh.shape} holds no data shard of process "
                f"{mesh.process_index}"
            )
        n_cards = torch.cuda.device_count() if self.device.type == "cuda" else 0
        local = []
        for devices in shards:
            row = []
            for entry in devices:
                dev = torch.device(entry)
                if dev.type != self.device.type:
                    raise ValueError(
                        f"mesh position on {dev}: this environment runs on "
                        f"{self.device.type}"
                    )
                if dev.type == "cuda":
                    if (dev.index or 0) >= n_cards:
                        raise ValueError(
                            f"mesh position on {dev}, which is not present "
                            f"({n_cards} CUDA devices)"
                        )
                    dev = torch.device("cuda", dev.index or 0)
                row.append(dev)
            local.append(row)
        n_policy = mesh.shape.get(mesh_mod.POLICY_AXIS, 1)
        buckets: list[tuple[str, ...]] = []
        width = 0
        column_of: dict[str, int] = {}
        if n_policy > 1 and self._compiled:
            buckets, width, column_of = mesh_mod.plan_policy_buckets(
                list(self._compiled), n_policy
            )
        with self._lock:
            # a mesh attached before this one: its shard programs go (an
            # environment is meshed at its build, before it serves)
            for key in [k for k in self._programs if len(k) == 4]:
                del self._programs[key]
            self._mesh = mesh
            self._mesh_shards = local
            self._mesh_buckets = buckets
            self._mesh_block_width = width
            self._mesh_policy_col = column_of
            self._min_bucket = mesh.shape[mesh_mod.DATA_AXIS]
        self._build_transport_programs()

    def _columnar_mesh_ok(self) -> bool:
        """Columnar dispatch on this topology: not on a multi-process mesh,
        as in the JAX package, whose delta-plane structure comes from
        host-local batch content and could differ between processes."""
        return self._mesh is None or mesh_mod.process_count() == 1

    def bucket_for(self, n: int) -> int:
        """Power-of-two bucket, rounded up to a multiple of the mesh data
        axis (every data shard gets the same number of rows)."""
        return mesh_mod.pad_batch_to(
            max(bucket_size(n), self._min_bucket), self._min_bucket
        )

    # -- registry accessors ------------------------------------------------

    def policy_ids(self) -> list[str]:
        singles = [pid for pid in self._bound if "/" not in pid]
        return sorted(singles + list(self._groups))

    def _lookup_top_level(self, pid: PolicyID) -> BoundPolicy | BoundGroup:
        raw = str(pid)
        if raw in self._init_errors:
            raise PolicyInitializationError(raw, self._init_errors[raw])
        if pid.is_group_member:
            bp = self._bound.get(raw)
            if bp is None:
                raise PolicyNotFoundError(raw)
            return bp
        if pid.name in self._groups:
            return self._groups[pid.name]
        bp = self._bound.get(pid.name)
        if bp is None:
            raise PolicyNotFoundError(raw)
        return bp

    def get_policy_mode(self, policy_id: str) -> PolicyMode:
        target = self._lookup_top_level(PolicyID.parse(policy_id))
        if isinstance(target, BoundGroup):
            return target.policy_mode
        return target.eval_settings.policy_mode

    def get_policy_allowed_to_mutate(self, policy_id: str) -> bool:
        target = self._lookup_top_level(PolicyID.parse(policy_id))
        if isinstance(target, BoundGroup):
            return False
        return target.eval_settings.allowed_to_mutate

    def should_always_accept_requests_made_inside_of_namespace(
        self, namespace: str
    ) -> bool:
        return (
            self.always_accept_namespace is not None
            and namespace == self.always_accept_namespace
        )

    @staticmethod
    def _allowlist_of(target: "BoundPolicy | BoundGroup") -> frozenset:
        """The context kinds a target may see: its own allowlist, or the
        union of its members' for a group."""
        if isinstance(target, BoundGroup):
            out: set = set()
            for bp in target.members.values():
                out |= bp.ctx_allowlist
            return frozenset(out)
        return target.ctx_allowlist

    @staticmethod
    def _providers_of(target: "BoundPolicy | BoundGroup") -> list:
        bps = (
            list(target.members.values())
            if isinstance(target, BoundGroup)
            else [target]
        )
        return [
            bp.precompiled.program.context_provider
            for bp in bps
            if bp.precompiled.program.context_provider is not None
        ]

    def payload_for(
        self, target: "BoundPolicy | BoundGroup", request: ValidateRequest
    ) -> Any:
        """The evaluation payload: the request document, plus — under
        ``__context__`` — the capability-filtered cluster snapshot for
        context-aware policies (context/service.py; the reference's
        EvaluationContext allowlist, evaluation_environment.rs:243-247)
        and any program context-provider output (cached host capabilities
        such as image-signature verification)."""
        payload = request.payload()
        if self._target_plain(target):
            return payload
        allowlist = self._allowlist_of(target)
        providers = self._providers_of(target)
        has_snapshot = bool(allowlist) and self.context_service is not None
        payload = dict(payload)
        ctx: dict = {}
        if has_snapshot:
            ctx.update(self.context_service.snapshot().view(allowlist))
        for provider in providers:
            ctx.update(provider(payload))
        payload[CONTEXT_KEY] = ctx
        return payload

    # -- hot-loop memos and cache keys -------------------------------------

    def _fast_target(self, policy_id: str) -> "BoundPolicy | BoundGroup":
        """Memoized top-level lookup for the batch loops. Failing ids
        (unknown, init-error) raise through the uncached path every time."""
        target = self._target_memo.get(policy_id)
        if target is None:
            target = self._lookup_top_level(PolicyID.parse(policy_id))
            self._target_memo[policy_id] = target
        return target

    def _hooks_of(self, target: "BoundPolicy | BoundGroup") -> list:
        hooks = self._hooks_memo.get(id(target))
        if hooks is None:
            hooks = pre_eval_hooks_of(target)
            self._hooks_memo[id(target)] = hooks
        return hooks

    def _target_plain(self, target: "BoundPolicy | BoundGroup") -> bool:
        """Memoized: True when the target's evaluation payload is the raw
        request document (no context snapshot, no providers), so the
        canonical blob is ``request.payload_json()``. The one source of
        truth for ``payload_for``, ``_payload_blob`` and ``_blob_of``:
        desynchronizing them would key the blob tier on other bytes than
        the payload evaluated (a snapshot change must change the key)."""
        plain = self._blob_plain_memo.get(id(target))
        if plain is None:
            plain = not (
                (
                    self._allowlist_of(target)
                    and self.context_service is not None
                )
                or self._providers_of(target)
            )
            self._blob_plain_memo[id(target)] = plain
        return plain

    def _payload_blob(
        self, target: "BoundPolicy | BoundGroup", request: ValidateRequest
    ) -> bytes:
        if self._target_plain(target):
            return request.payload_json()
        return json.dumps(
            self.payload_for(target, request), separators=(",", ":")
        ).encode()

    def _blob_of(
        self, target: "BoundPolicy | BoundGroup", request: ValidateRequest,
        payload: Any,
    ) -> bytes:
        """Canonical payload blob for ONE request given its already-built
        ``payload`` — the same object the verdict is computed from."""
        if self._target_plain(target):
            return request.payload_json()
        return json.dumps(payload, separators=(",", ":")).encode()

    @staticmethod
    def _cache_key_of(target: "BoundPolicy | BoundGroup") -> tuple[str, str]:
        """Stable identity of an evaluation target in the verdict cache
        (the prefix keeps policy and group names disjoint)."""
        if isinstance(target, BoundGroup):
            return ("g", target.name)
        return ("p", target.policy_id)

    def _cacheable(self, target: "BoundPolicy | BoundGroup") -> bool:
        """Whether a target's verdict is a pure function of its payload
        blob. Wasm-involving targets are not: a wasm wall-clock deadline
        makes their verdict time-dependent."""
        if isinstance(target, BoundGroup):
            return target.name not in self._groups_with_wasm
        return target.precompiled.program.host_evaluator is None

    @staticmethod
    def _host_executed(target: "BoundPolicy | BoundGroup") -> bool:
        """True when the target's verdict comes from host-side wasm
        execution (evaluation/wasm_policy.py), bypassing the device."""
        return (
            not isinstance(target, BoundGroup)
            and target.precompiled.program.host_evaluator is not None
        )

    def _frag_eligible(self, target: "BoundPolicy | BoundGroup") -> bool:
        """True when a cached output row's RESPONSE is a pure function of
        (target, row) plus the request uid, and the service layer's
        constraints are provably the identity on it: protect mode, no
        mutator and no wasm in the target, every reachable rule message
        static. Memoized per target."""
        hit = self._frag_eligible_memo.get(id(target))
        if hit is not None:
            return hit
        ok = self._cacheable(target)
        if ok:
            if isinstance(target, BoundGroup):
                _ak, members, risky = self._group_mat[target.name]
                ok = (
                    target.policy_mode is PolicyMode.PROTECT
                    and not risky
                    and isinstance(target.message, str)
                    and all(
                        isinstance(r.message, str)
                        for e in members
                        for r in e[1].precompiled.program.rules
                    )
                )
            else:
                prog = target.precompiled.program
                ok = (
                    target.eval_settings.policy_mode is PolicyMode.PROTECT
                    and prog.mutator is None
                    and prog.host_evaluator is None
                    and all(isinstance(r.message, str) for r in prog.rules)
                )
        self._frag_eligible_memo[id(target)] = ok
        return ok

    def _frag_of(
        self, target: "BoundPolicy | BoundGroup", row: Mapping[str, Any]
    ) -> "FragTemplate | None":
        """The cached row's FragTemplate for ``target``, built on its first
        hit and attached to the row dict under FRAG_KEY (dict stores are
        GIL-atomic; racing builders produce identical templates). None for
        ineligible targets: the caller materializes normally."""
        frags = row.get(FRAG_KEY)
        if frags is None:
            frags = {}
            row[FRAG_KEY] = frags  # type: ignore[index]
        ckey = self._cache_key_of(target)
        tmpl = frags.get(ckey)
        if tmpl is None:
            if not self._frag_eligible(target):
                frags[ckey] = False
                return None
            resp = self._materialize_from_row(target, "", row)
            st = resp.status
            try:
                tmpl = FragTemplate(
                    allowed=resp.allowed,
                    code=None if st is None else st.code,
                    message=None if st is None else st.message,
                    causes=(
                        tuple((c.field, c.message) for c in st.details.causes)
                        if st is not None and st.details is not None
                        else None
                    ),
                )
            except UnicodeEncodeError:
                # a static message json can carry but utf-8 cannot encode
                # (a lone surrogate): rendered per row instead
                frags[ckey] = False
                return None
            frags[ckey] = tmpl
        return tmpl or None  # the False sentinel → None

    def _materialize_from_row(
        self, target: "BoundPolicy | BoundGroup", uid: str, row: Mapping[str, Any]
    ) -> AdmissionResponse:
        """_materialize for a bare output row with no request in hand:
        eligible targets never touch the payload, and a raising stand-in
        keeps that claim checked."""

        def _no_payload() -> Any:
            raise RuntimeError(
                "fragment-eligible target touched the request payload"
            )

        if isinstance(target, BoundGroup):
            return self._materialize_group(target, uid, _no_payload, row)
        return self._materialize_single(target, uid, _no_payload, row)

    def _row_cache_key(self, target, blob: bytes) -> tuple | None:
        """(target, packed row bytes) row-tier key for ONE request — the
        host fast path's entry into the key space the device path dedups
        on. None when no schema holds the request (the caller evaluates
        normally). Costs a single-row native encode, so the host path
        consults the blob tier first."""
        try:
            for schema in self.schemas:
                features, status = schema.native.encode_batch(
                    [blob], 1, self.table
                )
                if status[0] == 0:
                    return (
                        self._cache_key_of(target),
                        features[PACKED_KEY][0].tobytes(),
                    )
        except ValueError:
            return None
        return None

    def reset_verdict_cache(self) -> None:
        """Drop every cached verdict row in both tiers (a no-op when caching
        is off). Counters are kept: they are cumulative."""
        for tier in (self._verdict_cache, self._blob_cache):
            if tier is not None:
                tier.clear()

    # -- counters ----------------------------------------------------------

    def _profile_add(self, **deltas: int) -> None:
        with self._stats_lock:
            hp = self._host_profile
            for k, v in deltas.items():
                hp[k] += v

    @property
    def oracle_fallbacks(self) -> int:
        """Rows no schema bucket holds, answered by the host oracle."""
        with self._stats_lock:
            return self._oracle_fallbacks

    @property
    def host_fastpath_requests(self) -> int:
        with self._stats_lock:
            return self._host_fastpath_requests

    @property
    def batch_dedup_hits(self) -> int:
        with self._stats_lock:
            return self._batch_dedup_hits

    @property
    def breaker_short_circuited_requests(self) -> int:
        with self._stats_lock:
            return self._breaker_short_circuited

    @property
    def host_profile(self) -> dict[str, int]:
        """Where the native path's host time goes (ns totals and row
        counts: encode, dedup bookkeeping, fetch wait)."""
        with self._stats_lock:
            return dict(self._host_profile)

    @property
    def pallas_stats(self) -> dict[str, int]:
        """``--kernel pallas`` accounting, as the JAX package's: K1's
        dispatches, the schema buckets armed for it, and ``interpret_mode``
        1 where K1 runs its plain version (an environment on the CPU, as
        the JAX package's kernel runs in interpret mode there)."""
        with self._stats_lock:
            return {
                "dispatches": self._pallas_dispatches,
                "buckets_armed": len(self._pallas_armed),
                "interpret_mode": int(
                    self.kernel == "pallas" and self.kernel_runs_plain
                ),
            }

    @property
    def plane_program_compiles(self) -> int:
        """Dispatch forms seen so far: each new (form, shapes) combination
        is one program compile in the JAX package. The batcher snapshots
        this around a dispatch and drops the RTT sample of a window that
        saw a new one."""
        with self._stats_lock:
            return self._plane_compiles

    @property
    def optimizer_stats(self) -> dict[str, int]:
        """The predicate optimizer's work on this set, as the JAX
        package's: CSE subtrees shared, policies and rules folded to
        constants, and (against the unoptimized schema) the fields pruned
        from the widest bucket and the packed-row bytes saved over every
        bucket. Zeros with the optimizer off."""
        if self.optimization is None:
            return dict.fromkeys(
                ("subtrees_shared", "policies_folded", "rules_folded",
                 "fields_pruned", "row_bytes_saved"), 0,
            )
        fields_pruned, row_bytes_saved = self._opt_accounting_get()
        return {
            "subtrees_shared": self.optimization.subtrees_shared,
            "policies_folded": self.optimization.policies_folded,
            "rules_folded": self.optimization.rules_folded,
            "fields_pruned": fields_pruned,
            "row_bytes_saved": row_bytes_saved,
        }

    def _opt_accounting_get(self) -> tuple[int, int]:
        """(fields pruned, row bytes saved): the naive schema is rebuilt
        per cap bucket once, on the first read (a benign race: the
        computation is pure)."""
        if self._opt_accounting is not None:
            return self._opt_accounting

        def keyset(schema: FeatureSchema) -> set:
            keys = set(schema.specs)
            keys.update(
                mask_key_for(s.key) for s in schema.specs.values() if s.has_mask
            )
            return keys

        fields_pruned = row_bytes_saved = 0
        for i, (a, n) in enumerate(self._opt_cap_buckets):
            base = FeatureSchema.build(
                self._opt_base_exprs, axis_cap=a, nested_axis_cap=n
            )
            saved = base.packed_layout().width - self.schemas[i].packed_layout().width
            row_bytes_saved += max(0, saved)
            if i == len(self._opt_cap_buckets) - 1:
                fields_pruned = len(keyset(base) - keyset(self.schemas[i]))
        self._opt_accounting = (fields_pruned, row_bytes_saved)
        return self._opt_accounting

    @property
    def kernel_runs_plain(self) -> bool:
        """True where the device backend runs K1's plain PyTorch version
        (an environment on the CPU), as the JAX package's Pallas path runs
        in interpret mode; False where it launches the CUDA kernel, and on
        the oracle backend, which runs neither."""
        return (
            self.backend == "torch"
            and self.device is not None
            and self.device.type != "cuda"
        )

    @property
    def warmup_dispatches(self) -> int:
        """Device dispatches the next ``warmup((b,))`` call issues: per
        schema bucket one, two on the columnar path (the all-zero and the
        dense batch), and under ``pallas`` then one more for each dispatch
        the bucket still lacks to arm, at least one (the loop's pass that
        finds it armed). Exact for the bucket's current count, where the
        JAX package's formula (``PALLAS_HOT_DISPATCHES`` more per bucket)
        is an upper bound; the batcher divides its RTT seed by this."""
        base = 2 if self.columnar and self._columnar_mesh_ok() else 1
        if self.kernel != "pallas":
            return max(1, len(self.schemas) * base)
        with self._stats_lock:
            counts = [self._bucket_dispatches.get(i, 0)
                      for i in range(len(self.schemas))]
        return max(1, sum(
            base + max(1, PALLAS_HOT_DISPATCHES - n - base) for n in counts
        ))

    @property
    def dedup_stats(self) -> dict[str, int]:
        """Verdict-cache and in-batch dedup counters: ``cache_*`` keys are
        the row tier, ``blob_*`` keys the blob tier."""
        stats = (
            self._verdict_cache.stats()
            if self._verdict_cache is not None
            else dict(_NO_CACHE_STATS)
        )
        blob = (
            self._blob_cache.stats()
            if self._blob_cache is not None
            else dict(_NO_CACHE_STATS)
        )
        for k, v in blob.items():
            stats["blob_" + k] = v
        with self._stats_lock:
            stats["batch_dup_hits"] = self._batch_dedup_hits
            stats["fragment_hits"] = self._frag_hits
        return stats

    # -- the device step ---------------------------------------------------

    def _layout_for_buffer(self, width: int) -> tuple[int, Any, bool, bool]:
        """→ (schema index, layout, is_transport, is_narrow) for a packed
        buffer width (unique by construction)."""
        for i, s in enumerate(self.schemas):
            lo = s.packed_layout()
            if lo.transport16_width == width:
                return i, lo, True, True
            if lo.transport_width == width:
                return i, lo, True, False
            if lo.width == width:
                return i, lo, False, False
        raise ValueError(f"no schema matches packed buffer width {width}")

    def _transport(self, features: Mapping[str, Any]) -> Mapping[str, Any]:
        """Wide packed batch → bit-packed transport form (narrow while the
        intern vocabulary fits uint16)."""
        width = np.asarray(features[PACKED_KEY]).shape[1]
        for s in self.schemas:
            if s.packed_layout().width == width:
                return s.to_transport(features, vocab_size=len(self.table))
        return features  # already a transport width

    def _combine_outputs(
        self,
        a_mat: torch.Tensor,
        r_mat: torch.Tensor,
        column_of: Mapping[str, int],
        wasm_bits: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Policy verdict matrix → the one packed output tensor
        ``(B, P + P + G + G*Mmax)``: policy verdicts, rule indices, group
        verdicts and group member-evaluated masks, uint8 when every rule
        index fits a byte (-1 wraps to 255). ``wasm_bits`` (B, n_wasm),
        on the same device, are the wasm group members' host verdicts:
        they replace those members' columns (rule index 0) before the
        group combine reads them."""
        batch = a_mat.shape[0]
        device = a_mat.device
        key = (device, tuple(column_of[p] for p in self._policy_order))
        cols = self._combine_cols.get(key)
        if cols is None:
            cols = self._combine_cols[key] = torch.tensor(
                key[1], dtype=torch.long, device=device
            )
        p_allowed = a_mat.index_select(1, cols)
        p_rule = r_mat.index_select(1, cols)
        if self._wasm_member_order:
            wkey = (device, "wasm")
            wcols = self._combine_cols.get(wkey)
            if wcols is None:
                wcols = self._combine_cols[wkey] = torch.tensor(
                    [self._policy_index[p] for p in self._wasm_member_order],
                    dtype=torch.long, device=device,
                )
            if wasm_bits is None:
                wasm_bits = torch.zeros(
                    (batch, len(self._wasm_member_order)),
                    dtype=torch.bool, device=device,
                )
            p_allowed = p_allowed.index_copy(1, wcols, wasm_bits.to(torch.bool))
            p_rule = p_rule.index_fill(1, wcols, 0)
        g_allowed_cols = []
        g_eval_cols = []
        for name in self._group_order:
            group = self._groups[name]
            member_allowed = {
                m: p_allowed[:, self._policy_index[f"{name}/{m}"]]
                for m in group.members
            }
            verdict, evaluated = groups_mod.lower_group(group.ast, member_allowed)
            verdict = torch.broadcast_to(verdict.to(device), (batch,))
            g_allowed_cols.append(verdict)
            # a member the expression never references is never evaluated
            masks = [
                evaluated.get(m, torch.zeros_like(verdict))
                for m in group.members
            ]
            pad = self._max_group_members - len(masks)
            masks.extend([torch.zeros_like(verdict)] * pad)
            g_eval_cols.append(torch.stack(masks, dim=-1))  # (B, Mmax)
        g_allowed = (
            torch.stack(g_allowed_cols, dim=-1)
            if g_allowed_cols
            else torch.zeros((batch, 0), dtype=torch.bool, device=device)
        )
        g_eval = (
            torch.stack(g_eval_cols, dim=1)  # (B, G, Mmax)
            if g_eval_cols
            else torch.zeros((batch, 0, 0), dtype=torch.bool, device=device)
        )
        if self._compact_outputs:
            out_dtype = torch.uint8
            p_rule = p_rule & 0xFF
        else:
            out_dtype = torch.int32
        return torch.cat(
            [
                p_allowed.to(out_dtype),
                p_rule.to(out_dtype),
                g_allowed.to(out_dtype),
                g_eval.reshape(batch, -1).to(out_dtype),
            ],
            dim=1,
        )

    def _unpack(self, packed: np.ndarray) -> dict[str, np.ndarray]:
        """Packed output → the per-key dict the materializers use."""
        n_p = len(self._policy_order)
        n_g = len(self._group_order)
        m = self._max_group_members
        p_allowed = packed[:, :n_p] != 0
        p_rule = packed[:, n_p : 2 * n_p].astype(np.int32)
        if self._compact_outputs:
            # the -1 "allowed" sentinel wrapped to 255 (rule indices < 255)
            p_rule = np.where(p_rule == 255, -1, p_rule)
        g_allowed = packed[:, 2 * n_p : 2 * n_p + n_g] != 0
        g_eval = (
            packed[:, 2 * n_p + n_g :].reshape(packed.shape[0], n_g, m) != 0
            if n_g
            else np.zeros((packed.shape[0], 0, 0), np.bool_)
        )
        out: dict[str, np.ndarray] = {}
        for j, pid in enumerate(self._policy_order):
            out[f"p:{pid}:allowed"] = p_allowed[..., j]
            out[f"p:{pid}:rule"] = p_rule[..., j]
        for gi, name in enumerate(self._group_order):
            out[f"g:{name}:allowed"] = g_allowed[..., gi]
            for mi, mname in enumerate(self._groups[name].members):
                out[f"g:{name}:eval:{mname}"] = g_eval[..., gi, mi]
        return out

    def enqueue_packed(
        self, buf: np.ndarray, wasm_bits: np.ndarray | None = None
    ) -> InflightStep:
        """Start the device step of one packed ``uint8`` batch (any of the
        three forms): the copy to the card from a page-locked buffer, one
        ``policy_matrix`` launch, the combine, and the copy back into a
        page-locked buffer, all queued on the card's current stream, then
        a CUDA event. ``wasm_bits`` (B, n_wasm) bool, the wasm group
        members' host verdicts, ride in the same page-locked copy behind
        the rows (all False when not given). Returns without waiting;
        ``InflightStep.wait`` is the fetch. On the CPU the step runs at
        once."""
        self._enter()
        try:
            return self._enqueue_open(buf, wasm_bits)
        finally:
            self._leave()

    def _enqueue_open(
        self, buf: np.ndarray, wasm_bits: np.ndarray | None = None
    ) -> InflightStep:
        """K1 over packed rows: each position launches its policy shard's
        program (the whole program without a policy axis) on its data
        shard's rows, the JAX package's ``_mesh_block_local_pallas``."""
        idx, _layout, transport, narrow = self._layout_for_buffer(buf.shape[1])
        if self._mesh_buckets:
            programs = [
                self.program_for(idx, transport, narrow, p)
                for p in range(len(self._mesh_buckets))
            ]
            column_of = self._mesh_policy_col
        else:
            programs = [self.program_for(idx, transport, narrow)]
            column_of = programs[0].column_of

        def block(p: int, rows: torch.Tensor):
            return cuda_kernels.policy_matrix(rows, programs[p])

        return self._rows_step(buf, wasm_bits, lambda rows: rows, block, column_of)

    def _enqueue_unpacked(
        self, buf: np.ndarray, wasm_bits: np.ndarray | None = None
    ) -> InflightStep:
        """The non-Pallas program over a packed buffer, the JAX package's
        ``_forward``: ``unpack_rows`` and ``_eval_features`` as PyTorch
        ops, in the device step of ``enqueue_packed``."""
        _idx, layout, transport, narrow = self._layout_for_buffer(buf.shape[1])
        return self._rows_step(
            buf,
            wasm_bits,
            lambda rows: unpack_rows(rows, layout, transport, narrow),
            self._eval_features,
            self._mesh_policy_col or self._policy_index,
        )

    def _rows_step(
        self,
        buf: np.ndarray,
        wasm_bits: np.ndarray | None,
        prepare: Callable[[torch.Tensor], Any],
        block: Callable[[int, Any], tuple[torch.Tensor, torch.Tensor]],
        column_of: Mapping[str, int],
    ) -> InflightStep:
        """The device step over packed rows: each data shard ships its rows
        and then its wasm bits (all False when not given); ``prepare``
        turns the rows on a device into what ``block`` reads."""
        arrays = {PACKED_KEY: buf}
        n_wasm = len(self._wasm_member_order)
        if n_wasm:
            arrays[WASM_BITS_KEY] = (
                np.zeros((buf.shape[0], n_wasm), np.bool_)
                if wasm_bits is None
                else np.asarray(wasm_bits, dtype=np.bool_)
            )
        return self._device_step(
            mesh_mod.shard_features(arrays, len(self._mesh_shards)),
            lambda _dev, views: (
                prepare(views[PACKED_KEY]), views.get(WASM_BITS_KEY)
            ),
            block,
            column_of,
        )

    def _device_step(
        self,
        parts: Sequence[Mapping[str, np.ndarray]],
        stage: Callable[[torch.device, dict[str, torch.Tensor]], tuple[Any, Any]],
        block: Callable[[int, Any], tuple[torch.Tensor, torch.Tensor]],
        column_of: Mapping[str, int],
        hold_inputs: bool = False,
    ) -> InflightStep:
        """The one device step, with a mesh or without (one data shard on
        one device). ``parts`` holds each of this process's data shards'
        host arrays: all of them laid out in one buffer, each array
        16-byte aligned and each shard's region in turn, page-locked on
        the card. Each shard's region is copied once to each distinct
        device of the shard and its arrays viewed out of it there;
        ``stage(device, views)`` → (inputs, wasm bits) on that device.
        Position (p, d) computes ``block(p, inputs)``, policy shard p's
        (allowed, rule) block (the whole policy set without a policy
        axis); a data shard's blocks gather shard-major on its first
        device — the JAX package's ``all_gather`` over the policy axis
        then ``transpose(1, 0, 2).reshape(batch, -1)`` — for the combine
        there. ``hold_inputs`` keeps the device copies until the fetch
        (``--donate-buffers off``). On the CPU the step runs at once."""
        regions = []
        end = 0
        for part in parts:
            end = r0 = (end + 15) & ~15
            places = []
            for k, a in part.items():
                a = np.ascontiguousarray(a)
                start = (end + 15) & ~15
                places.append((k, start - r0, a))
                end = start + a.nbytes
            regions.append((r0, end, places))
        on_card = self.device.type == "cuda"
        if on_card:
            host_in = self._pinned.take((bucket_size(max(end, 1)),), torch.uint8)
        else:
            host_in = torch.empty((end,), dtype=torch.uint8)
        flat = host_in.numpy()
        for r0, _r1, places in regions:
            for _k, start, a in places:
                flat[r0 + start : r0 + start + a.nbytes] = a.view(np.uint8).reshape(-1)
        device_in: list[torch.Tensor] = []
        outs = [
            self._shard_step(
                devices, host_in[r0:r1], places, stage, block, column_of,
                device_in if on_card else None,
            )
            for devices, (r0, r1, places) in zip(self._mesh_shards, regions)
        ]
        if not on_card:
            out = outs[0] if len(outs) == 1 else torch.cat(outs)
            return InflightStep(ready=out.numpy())
        return self._finish_step(
            outs, host_in, device_in if hold_inputs else None
        )

    def _shard_step(
        self,
        devices: list[torch.device],
        region: torch.Tensor,
        places: list,
        stage: Callable[[torch.device, dict[str, torch.Tensor]], tuple[Any, Any]],
        block: Callable[[int, Any], tuple[torch.Tensor, torch.Tensor]],
        column_of: Mapping[str, int],
        device_in: list[torch.Tensor] | None,
    ) -> torch.Tensor:
        """One data shard of ``_device_step``: its region staged on each
        distinct device of ``devices`` (copied there when ``device_in``,
        the step's list of device copies, is given), position p's block
        on ``devices[p]``, and the gather and combine on ``devices[0]``."""
        staged: dict[torch.device, tuple[Any, Any]] = {}
        blocks = []
        for p, dev in enumerate(devices):
            with _on(dev):
                hit = staged.get(dev)
                if hit is None:
                    buf = region
                    if device_in is not None:
                        buf = region.to(dev, non_blocking=True)
                        device_in.append(buf)
                    views = {
                        k: buf[start : start + a.nbytes]
                        .view(_PLANE_DTYPES[a.dtype])
                        .view(a.shape)
                        for k, start, a in places
                    }
                    hit = staged[dev] = stage(dev, views)
                blocks.append(block(p, hit[0]))
        home = devices[0]
        with _on(home):
            if len(blocks) == 1:
                a_mat, r_mat = blocks[0]
            else:
                a_mat = torch.cat([a.to(home) for a, _r in blocks], dim=1)
                r_mat = torch.cat([r.to(home) for _a, r in blocks], dim=1)
            return self._combine_outputs(a_mat, r_mat, column_of, staged[home][1])

    def _finish_step(
        self,
        outs: list[torch.Tensor],
        host_in: torch.Tensor,
        device_in: list[torch.Tensor] | None = None,
    ) -> InflightStep:
        """The tail of a device step: each data shard's output copied into
        its rows of one page-locked buffer, in order, on its device's
        current stream, and a CUDA event there for the fetch to wait on."""
        rows = sum(o.shape[0] for o in outs)
        host_out = self._pinned.take((rows, outs[0].shape[1]), outs[0].dtype)
        events = []
        start = 0
        for out in outs:
            with torch.cuda.device(out.device):
                host_out[start : start + out.shape[0]].copy_(out, non_blocking=True)
                stream = torch.cuda.current_stream()
                event = torch.cuda.Event()
                event.record(stream)
            events.append(event)
            with self._gate:
                # keyed by card as well: each card's default stream has
                # the same handle
                self._last_events[(stream.device_index, stream.cuda_stream)] = event
            start += out.shape[0]
        return InflightStep(
            tuple(events), host_in, host_out, self._pinned, device_in=device_in
        )

    def _eval_features(
        self, p: int, features: Mapping[str, torch.Tensor]
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Position p's block of the non-Pallas program, the JAX package's
        ``_eval_features`` before its combine: every policy's compiled
        function over the feature dict with one CSE table, or under a
        policy axis policy shard p's, padded to the shard block's width
        (``_mesh_bucket_block``)."""
        if self._mesh_buckets:
            return self._eval_block(
                features, self._mesh_buckets[p], self._mesh_block_width
            )
        return self._eval_block(
            features, self._policy_order, len(self._policy_order)
        )

    def evaluate_packed(self, buf: np.ndarray) -> np.ndarray:
        """One packed ``uint8`` batch → the packed output array: the
        enqueue followed by its fetch."""
        return self.enqueue_packed(buf).wait()

    # -- the dispatch funnel and the non-Pallas program --------------------

    def _enqueue_features(self, features: Mapping[str, Any]) -> InflightStep:
        """The one dispatch funnel for an encoded (wide packed) batch, as
        the JAX package's ``_dispatch_features``: a bucket armed for K1
        (``--kernel pallas``, ``_pallas_route``) ships its transport form
        to ``enqueue_packed``; otherwise, with ``columnar`` on, the delta
        planes go to the plane step; otherwise the transport form goes to
        the non-Pallas program. A K1 error fails the batch: no other form
        answers it."""
        wasm_bits = features.get(WASM_BITS_KEY)
        schema_idx = self._schema_index_for(features)
        if schema_idx is not None and self._pallas_route(schema_idx):
            buf = np.asarray(self._transport(features)[PACKED_KEY])
            combo = ("pallas", schema_idx, buf.shape)
            with self._stats_lock:
                self._pallas_dispatches += 1
                if combo not in self._plane_combos:
                    self._plane_combos.add(combo)
                    self._plane_compiles += 1
            return self.enqueue_packed(buf, wasm_bits)
        if self.columnar and self._columnar_mesh_ok() and schema_idx is not None:
            return self._enqueue_planes(schema_idx, features)
        return self._enqueue_unpacked(
            np.asarray(self._transport(features)[PACKED_KEY]), wasm_bits
        )

    def _pallas_route(self, schema_idx: int) -> bool:
        """True when this dispatch goes to K1: ``--kernel pallas`` and the
        bucket is armed, which it becomes at its
        ``PALLAS_HOT_DISPATCHES``-th dispatch (counted here)."""
        if self.kernel != "pallas":
            return False
        with self._stats_lock:
            n = self._bucket_dispatches.get(schema_idx, 0) + 1
            self._bucket_dispatches[schema_idx] = n
            if n >= PALLAS_HOT_DISPATCHES:
                self._pallas_armed.add(schema_idx)
            return schema_idx in self._pallas_armed

    def _schema_index_for(self, features: Mapping[str, Any]) -> int | None:
        """The schema bucket of a WIDE packed buffer; None for a buffer
        already in a transport width."""
        width = np.asarray(features[PACKED_KEY]).shape[1]
        for i, s in enumerate(self.schemas):
            if s.packed_layout().width == width:
                return i
        return None

    def _eval_block(
        self,
        features: Mapping[str, torch.Tensor],
        bucket: Sequence[str],
        width: int,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``bucket``'s compiled functions over the feature dict, one CSE
        table for the bucket → ``(allowed, rule)`` of shape
        ``(B, width)``, columns past the bucket's padded with (False, 0)."""
        cse: dict | None = {} if self.optimization is not None else None
        batch = features[BATCH_KEY].shape[0]
        device = features[BATCH_KEY].device
        outs = [self._compiled[pid](features, cse) for pid in bucket]
        a_cols = [a.to(torch.bool) for a, _r in outs]
        r_cols = [r.to(torch.int32) for _a, r in outs]
        pad = width - len(outs)
        if pad:
            a_cols += [torch.zeros(batch, dtype=torch.bool, device=device)] * pad
            r_cols += [torch.zeros(batch, dtype=torch.int32, device=device)] * pad
        if not a_cols:
            return (
                torch.zeros((batch, 0), dtype=torch.bool, device=device),
                torch.zeros((batch, 0), dtype=torch.int32, device=device),
            )
        return torch.stack(a_cols, dim=-1), torch.stack(r_cols, dim=-1)

    # -- the columnar delta planes ------------------------------------------

    # Ship a delta plane whole when the shipped-column bucket would be at
    # least this fraction of the plane: the scatter then buys nothing.
    _DELTA_FULL_FRACTION = 0.75

    @staticmethod
    def _select_delta_cols(
        live: np.ndarray, n_cols: int, full_frac: float
    ) -> np.ndarray | None:
        """The one column-selection rule every plane uses: given the
        indices of the columns with any nonzero value, the shipped column
        vector, padded to a power-of-two count by repeating the last real
        column (the duplicate scatter writes carry the same value), or
        None when the padded count is dense enough that shipping the whole
        plane beats the scatter."""
        k = int(live.size)
        kb = bucket_size(k)
        if kb >= full_frac * n_cols:
            return None
        if kb == k:
            return live
        return np.concatenate(
            [live, np.full(kb - k, live[-1], dtype=live.dtype)]
        )

    @classmethod
    def _delta_plane(
        cls, delta: dict, name: str, mat: np.ndarray, full_frac: float
    ) -> None:
        """Add one 32-bit plane to the delta dict: left out when all-zero,
        shipped whole when dense, otherwise only the selected columns and
        their index vector."""
        nz = np.flatnonzero(mat.any(axis=0))
        if not nz.size:
            return
        cols = cls._select_delta_cols(nz, mat.shape[1], full_frac)
        if cols is None:
            delta[name + "_full"] = np.ascontiguousarray(mat)
            return
        delta[name + "_cols"] = cols.astype(np.int32)
        delta[name] = np.ascontiguousarray(mat[:, cols])

    def _build_delta(
        self, schema_idx: int, features: Mapping[str, Any]
    ) -> tuple[tuple, dict]:
        """Wide packed batch (and its wasm bits) → (spec, delta planes),
        the JAX package's arrays key for key: the byte region bit-packed
        at lane granularity (``bits`` with ``bits_cols``, or
        ``bits_full``), the intern-id lanes as a uint16 plane (``ids``)
        while the table fits, the other 32-bit lanes as an int32 plane
        (``i32``); all-zero planes are left out. Pure numpy."""
        schema = self.schemas[schema_idx]
        layout = schema.packed_layout()
        buf = np.asarray(features[PACKED_KEY])
        batch = buf.shape[0]
        narrow = layout.u16_count > 0 and len(self.table) <= 65536
        delta: dict[str, np.ndarray] = {}
        byte_region = buf[:, : layout.total8]
        live_lanes = np.flatnonzero(byte_region.any(axis=0))
        if live_lanes.size:
            cols = self._select_delta_cols(
                live_lanes, layout.total8, self._DELTA_FULL_FRACTION
            )
            if cols is None:
                delta["bits_full"] = np.packbits(
                    byte_region != 0, axis=1, bitorder="little"
                )
            else:
                delta["bits_cols"] = cols.astype(np.int32)
                delta["bits"] = np.packbits(
                    byte_region[:, cols] != 0, axis=1, bitorder="little"
                )
        if layout.total32:
            region32 = np.ascontiguousarray(
                buf[
                    :,
                    layout.off32_bytes : layout.off32_bytes
                    + layout.total32 * 4,
                ]
            ).view(np.int32)
            if narrow:
                id_cols, other_cols = schema._transport_col_split()
                self._delta_plane(
                    delta, "ids",
                    region32[:, id_cols].astype(np.uint16),
                    self._DELTA_FULL_FRACTION,
                )
                if other_cols:
                    self._delta_plane(
                        delta, "i32", region32[:, other_cols],
                        self._DELTA_FULL_FRACTION,
                    )
            else:
                self._delta_plane(
                    delta, "i32", region32, self._DELTA_FULL_FRACTION
                )
        # wasm member bits always ship when present: leaving out the
        # all-zero case would make the warmup's structure (zero bits) the
        # only one it visits
        wb = features.get(WASM_BITS_KEY)
        if wb is not None:
            delta[WASM_BITS_KEY] = np.asarray(wb)
        return (schema_idx, batch, narrow), delta

    def _account_planes(self, spec: tuple, delta: Mapping[str, np.ndarray]) -> None:
        """The columnar transport's counters, as the JAX package's
        ``_plane_dispatch``: bytes shipped against the transport form's,
        delta columns, donation, and per new (spec, structure, shapes)
        combination one compile and its resident zero bytes, counted in
        device lane units (a uint8 lane per bool column)."""
        schema_idx, batch, narrow = spec
        layout = self.schemas[schema_idx].packed_layout()
        shipped = sum(int(a.nbytes) for a in delta.values())
        packed_equiv = batch * (
            layout.transport16_width if narrow else layout.transport_width
        )
        cols_shipped = sum(
            a.shape[1]
            for k, a in delta.items()
            if k in ("ids", "i32", "ids_full", "i32_full")
        )
        combo = (spec, tuple(sorted((k, a.shape) for k, a in delta.items())))
        with self._stats_lock:
            hp = self._host_profile
            hp["wire_bytes_shipped"] += shipped
            hp["wire_bytes_packed_equiv"] += packed_equiv
            hp["wire_rows"] += batch
            hp["delta_cols_shipped"] += cols_shipped
            hp["delta_cols_total"] += layout.total32
            if self.donate_buffers:
                hp["donated_dispatches"] += 1
            if combo not in self._plane_combos:
                self._plane_combos.add(combo)
                self._plane_compiles += 1
                if "bits_full" in delta:
                    elided_lanes = 0
                elif "bits_cols" in delta:
                    elided_lanes = layout.total8 - delta["bits_cols"].shape[0]
                else:
                    elided_lanes = layout.total8
                resident = batch * max(0, elided_lanes)
                resident += batch * 4 * max(0, layout.total32 - cols_shipped)
                hp["resident_const_bytes"] += resident

    def _enqueue_planes(
        self, schema_idx: int, features: Mapping[str, Any]
    ) -> InflightStep:
        """The plane step: build and account the delta planes (the whole
        batch's, as the JAX package's), split them over the data shards
        (``shard_delta_planes``: batch planes split, column vectors whole
        to every shard), ship them in ``_device_step``'s one page-locked
        copy, rebuild the features on each device
        (``_features_from_planes``, resident zeros per device) and run the
        non-Pallas program. With ``donate_buffers`` the step drops its
        device planes once the rebuild is enqueued, so the caching
        allocator can hand their blocks, stream-ordered, to the next
        enqueue; without it the step holds them until its fetch."""
        spec, delta = self._build_delta(schema_idx, features)
        self._account_planes(spec, delta)
        n_shards = len(self._mesh_shards)
        parts = mesh_mod.shard_delta_planes(delta, n_shards)
        local_spec = (spec[0], spec[1] // n_shards, spec[2])
        return self._device_step(
            parts,
            lambda dev, planes: self._features_from_planes(local_spec, planes, dev),
            self._eval_features,
            self._mesh_policy_col or self._policy_index,
            hold_inputs=not self.donate_buffers,
        )

    def _resident_zeros(
        self, shape: tuple, dtype: torch.dtype, device: torch.device
    ) -> torch.Tensor:
        """A zero tensor standing in for a plane the dispatch did not
        ship, kept across dispatches. Read only: a scatter never writes
        into one (``_features_from_planes``)."""
        key = (shape, dtype, device)
        z = self._resident.get(key)
        if z is None:
            z = torch.zeros(shape, dtype=dtype, device=device)
            with self._lock:
                z = self._resident.setdefault(key, z)
        return z

    def _features_from_planes(
        self,
        spec: tuple,
        delta: Mapping[str, torch.Tensor],
        device: torch.device | None = None,
    ) -> tuple[dict[str, torch.Tensor], torch.Tensor | None]:
        """The JAX package's ``_features_from_planes`` on the card: the
        per-key feature dict (and the wasm bits) from the shipped planes.
        A plane that was not shipped is a resident zero tensor; delta
        columns scatter into a zero buffer of this step's own (padded
        index slots repeat a column with its value). uint16 ids widen to
        int32 without the sign, f32 lanes are a bitcast of their int32
        bits, and the bits plane expands little-endian, cut to its
        shipped lanes before the scatter."""
        schema_idx, batch, narrow = spec
        layout = self.schemas[schema_idx].packed_layout()
        if device is None:
            device = next(iter(delta.values())).device if delta else self.device

        def zeros(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
            return self._resident_zeros(shape, dtype, device)

        def scatter(n_cols: int, dtype: torch.dtype, cols, vals) -> torch.Tensor:
            base = torch.zeros((batch, n_cols), dtype=dtype, device=device)
            base[:, cols.long()] = vals
            return base

        def plane(name: str, n_cols: int, widen=None) -> torch.Tensor:
            full = delta.get(name + "_full")
            if full is not None:
                return widen(full) if widen else full
            vals = delta.get(name)
            if vals is None:
                return zeros((batch, n_cols), torch.int32)
            vals = widen(vals) if widen else vals
            return scatter(n_cols, torch.int32, delta[name + "_cols"], vals)

        out: dict[str, torch.Tensor] = {BATCH_KEY: zeros((batch,), torch.bool)}
        lanes = None
        if "bits_full" in delta or "bits" in delta:
            bits = delta.get("bits_full", delta.get("bits"))
            shifts = torch.arange(8, dtype=torch.uint8, device=device)
            expanded = ((bits[:, :, None] >> shifts) & 1).reshape(batch, -1)
            if "bits_full" in delta:
                lanes = expanded
            else:
                cols = delta["bits_cols"]
                lanes = scatter(
                    layout.total8, torch.uint8, cols,
                    expanded[:, : cols.shape[0]],
                )
        for e in layout.entries8:
            if e.key == BATCH_KEY:
                continue
            if lanes is None:
                out[e.key] = zeros((batch, *e.caps), torch.bool)
            else:
                block = lanes[:, e.offset : e.offset + e.elems]
                out[e.key] = block.reshape((batch, *e.caps)) != 0
        n_id = layout.u16_count if narrow else 0
        n_other = layout.total32 - n_id
        if n_id:
            # the uint16 plane arrives as int16: widen without the sign
            ids = plane("ids", n_id, lambda t: t.to(torch.int32) & 0xFFFF)
        if n_other:
            other = plane("i32", n_other)
        id_off = other_off = 0
        for e in layout.entries32:
            if narrow and e.is_id:
                block = ids[:, id_off : id_off + e.elems]
                id_off += e.elems
            else:
                block = other[:, other_off : other_off + e.elems]
                other_off += e.elems
            block = block.reshape((batch, *e.caps))
            if e.is_f32:
                block = block.contiguous().view(torch.float32)
            out[e.key] = block
        wasm_bits = None
        if self._wasm_member_order:
            wasm_bits = delta.get(WASM_BITS_KEY)
            if wasm_bits is None:
                wasm_bits = zeros(
                    (batch, len(self._wasm_member_order)), torch.bool
                )
        return out, wasm_bits

    def _device_call(self, fn: Callable, *args: Any) -> Any:
        """Run the enqueue half of a device step; a raise is reported
        (``_device_raised``) and re-raised."""
        try:
            return fn(*args)
        except Exception as e:
            self._device_raised(e)
            raise

    def _device_fetch(
        self, step: InflightStep, rec_rows: int = 0, rec_batch: int = -1
    ) -> np.ndarray:
        """The choke point every device result fetch goes through: fires
        the ``device.fetch`` failpoint and reports the outcome — a fetch
        that raises is a fault (``_device_raised``), one that returns is
        the success that closes a half-open breaker. A fetch that HANGS is
        invisible here; the batcher's watchdog reports it through
        record_dispatch_failure. The wait on the step's CUDA event is the
        recorder's ``device_execute`` (``rec_rows`` rows of batch
        ``rec_batch``): it nests inside the caller's ``fetch``, so the
        attribution never adds it."""
        rec = flightrec.recorder()
        try:
            failpoints.fire("device.fetch")
            t0 = time.perf_counter_ns()
            c0 = time.thread_time_ns() if rec is not None else 0
            out = step.wait()
            t1 = time.perf_counter_ns()
            c1 = time.thread_time_ns() if rec is not None else 0
        except Exception as e:
            self._device_raised(e)
            raise
        # outside the try: a recorder fault fails the batch, it is never
        # a device fault that could trip the breaker onto the host
        if rec is not None:
            rec.record_phase(
                flightrec.PH_DEVICE_EXECUTE, t0, t1, rows=rec_rows,
                batch=rec_batch, cpu_ns=c1 - c0,
            )
        if self.breaker is not None:
            self.breaker.record_success()
        return out

    def _device_raised(self, e: Exception) -> None:
        """A raise at dispatch or fetch. An error the CUDA runtime reported
        is logged and counted, and stays out of the breaker, so it fails
        the batch's requests rather than turning into host answers (a
        sticky one would otherwise trip the breaker for good); any other
        raise, an injected fault among them, is a breaker failure."""
        if cuda_kernels.is_cuda_error(e):
            with self._stats_lock:
                self._device_errors += 1
            logger.error("device error, the batch's requests fail: %s", e)
        elif self.breaker is not None:
            self.breaker.record_failure()

    def record_dispatch_failure(self, policy_ids: Any = None) -> None:
        """Report a device-path failure the environment cannot observe
        itself: the batcher's watchdog abandoning a hung batch."""
        if self.breaker is not None:
            self.breaker.record_failure()

    @property
    def breaker_all_open(self) -> bool:
        """True while the device path is tripped AND still blocking (the
        --degraded-mode gate). ``blocking_device``, not ``is_open``: once
        the cooldown makes a probe due this flips False, so the batch goes
        to the dispatch path whose allow_device() runs the probe."""
        return self.breaker is not None and self.breaker.blocking_device

    @property
    def breaker_stats(self) -> dict[str, int]:
        """Breaker counters, in the JAX package's schema."""
        if self.breaker is None:
            return {}
        stats = self.breaker.stats()
        stats.pop("state_code", None)
        stats["open_shards"] = stats.pop("open")
        stats["total_shards"] = 1
        with self._stats_lock:
            stats["short_circuited_requests"] = self._breaker_short_circuited
        return stats

    @property
    def device_errors(self) -> int:
        """Kernel and CUDA errors at dispatch or fetch (each failed its
        batch's requests; none fed the breaker)."""
        with self._stats_lock:
            return self._device_errors

    def run_batch(self, features: Mapping[str, Any]) -> dict[str, np.ndarray]:
        """Dispatch one encoded (wide packed) batch and fetch its verdicts,
        through the breaker and the ``device.fetch`` failpoint."""
        if self.backend != "torch":
            raise RuntimeError("run_batch needs the torch backend")
        self._enter()
        try:
            step = self._device_call(self._enqueue_features, features)
            return self._unpack(self._device_fetch(step))
        finally:
            self._leave()

    def warmup(self, batch_sizes: tuple[int, ...] = (1,)) -> None:
        """Run each batch size through every schema bucket, as the JAX
        package's warmup: an all-missing batch; on the columnar path also
        a dense one (every plane shipped whole); under ``pallas`` more
        all-missing batches until the bucket arms, so the default warmup
        leaves every bucket on K1."""
        for idx, schema in enumerate(self.schemas):
            for b in sorted({self.bucket_for(n) for n in batch_sizes}):
                batch = schema.empty_batch_packed(b)
                self._add_wasm_bits(batch, b)
                self.run_batch(batch)
                if self.columnar and self._columnar_mesh_ok():
                    full = {PACKED_KEY: np.ones_like(batch[PACKED_KEY])}
                    self._add_wasm_bits(full, b)
                    self.run_batch(full)
                if self.kernel != "pallas":
                    continue
                for _ in range(PALLAS_HOT_DISPATCHES):
                    pbatch = schema.empty_batch_packed(b)
                    self._add_wasm_bits(pbatch, b)
                    self.run_batch(pbatch)
                    with self._stats_lock:
                        if idx in self._pallas_armed:
                            break

    def encode_bucketed(self, payload: Any) -> tuple[int, dict[str, np.ndarray]]:
        """Encode with the Python trie (the native encoder's plain version)
        into the smallest shape bucket that fits; raises SchemaOverflow
        when even the widest schema cannot hold the request."""
        last_error: SchemaOverflow | None = None
        for i, schema in enumerate(self.schemas):
            try:
                return i, schema.encode(payload, self.table)
            except SchemaOverflow as e:
                last_error = e
        assert last_error is not None
        raise last_error

    # -- evaluation --------------------------------------------------------

    def validate(self, policy_id: str, request: ValidateRequest) -> AdmissionResponse:
        """One request (a batch of one)."""
        result = self.validate_batch([(policy_id, request)])[0]
        if isinstance(result, Exception):
            raise result
        return result

    def _run_pre_eval_hooks(self, target: Any, payload: Any) -> None:
        for hook in pre_eval_hooks_of(target):
            hook(payload)

    # -- wasm group members (host verdicts as device inputs) ---------------

    @staticmethod
    def _wasm_verdict_triple(verdict: Mapping[str, Any]) -> tuple[bool, Any, bool]:
        """Host-evaluator verdict dict → (allowed, message, would_mutate);
        the single decode point for every path that reads wasm member
        verdicts."""
        return (
            bool(verdict.get("accepted")),
            verdict.get("message"),
            verdict.get("mutated_object") is not None,
        )

    def _wasm_member_outputs(
        self, bp: BoundPolicy, payload: Any, out: dict[str, Any]
    ) -> bool:
        """Evaluate one wasm member host-side and write its output keys
        (both oracle paths); returns the allowed bit."""
        verdict = bp.precompiled.program.host_evaluator(payload)
        allowed, msg, mutated = self._wasm_verdict_triple(verdict)
        out[f"p:{bp.policy_id}:allowed"] = allowed
        out[f"p:{bp.policy_id}:rule"] = -1
        out[f"wm:{bp.policy_id}:msg"] = msg
        out[f"wm:{bp.policy_id}:mutated"] = mutated
        return allowed

    def _eval_wasm_members(
        self, target: "BoundPolicy | BoundGroup", payload: Any
    ) -> dict[str, tuple[bool, Any, bool]]:
        """Host-evaluate a group target's wasm members on one payload →
        {member pid: (allowed, message, would_mutate)}. Members the group
        expression never references are skipped: their verdicts are
        masked out anyway. Host evaluators never raise (wasm errors map
        to in-band rejections, evaluation/wasm_policy.py)."""
        if not isinstance(target, BoundGroup) or (
            target.name not in self._groups_with_wasm
        ):
            return {}
        referenced = groups_mod.referenced_members(target.ast)
        out: dict[str, tuple[bool, Any, bool]] = {}
        for member_name, bp in target.members.items():
            he = bp.precompiled.program.host_evaluator
            if he is None or member_name not in referenced:
                continue
            out[bp.policy_id] = self._wasm_verdict_triple(he(payload))
        return out

    def _add_wasm_bits(
        self,
        batch_features: dict,
        bucket: int,
        row_infos: "list[tuple[int, dict]] | None" = None,
    ) -> dict[str, list]:
        """Attach the WASM_BITS_KEY device input for a batch and return
        the host-side stash (per-row member messages and mutation flags)
        to merge into the outputs dict. ``row_infos``: (row, info) pairs
        from _eval_wasm_members. A no-op returning {} when no wasm members
        are loaded."""
        if not self._wasm_member_order:
            return {}
        bits = np.zeros((bucket, len(self._wasm_member_order)), np.bool_)
        stash: dict[str, list] = {}
        for row, info in row_infos or []:
            for pid, (allowed, msg, mutated) in info.items():
                bits[row, self._wasm_member_col[pid]] = allowed
                stash.setdefault(f"wm:{pid}:msg", [None] * bucket)[row] = msg
                stash.setdefault(f"wm:{pid}:mutated", [False] * bucket)[
                    row
                ] = mutated
        batch_features[WASM_BITS_KEY] = bits
        return stash

    def _oracle_outputs(
        self, payload: Any, target: "BoundPolicy | BoundGroup | None" = None
    ) -> dict[str, Any]:
        """Host-interpreter evaluation of every policy and group (scalar
        outputs, the same keys as the device path). The wasm engine runs
        ONLY for the members the target's materializer reads (referenced
        members of the target group); every other wasm entry is inert."""
        needed: set[str] = set()
        if (
            isinstance(target, BoundGroup)
            and target.name in self._groups_with_wasm
        ):
            referenced = groups_mod.referenced_members(target.ast)
            needed = {
                bp.policy_id
                for m, bp in target.members.items()
                if m in referenced
                and bp.precompiled.program.host_evaluator is not None
            }
        out: dict[str, Any] = {}
        for pid, bp in self._bound.items():
            if bp.precompiled.program.host_evaluator is not None:
                if pid in needed:
                    self._wasm_member_outputs(bp, payload, out)
                else:
                    # unread (standalone wasm routes via _host_executed;
                    # other groups' members are not this target's)
                    out[f"p:{pid}:allowed"] = False
                    out[f"p:{pid}:rule"] = -1
                continue
            allowed, rule_idx = oracle_mod.evaluate_program(
                bp.precompiled.program, payload
            )
            out[f"p:{pid}:allowed"] = allowed
            out[f"p:{pid}:rule"] = rule_idx
        for name, group in self._groups.items():
            member_allowed = {
                m: bool(out[f"p:{name}/{m}:allowed"]) for m in group.members
            }
            verdict, evaluated = groups_mod.evaluate_group_host(
                group.ast, member_allowed
            )
            out[f"g:{name}:allowed"] = verdict
            for m in group.members:
                out[f"g:{name}:eval:{m}"] = evaluated.get(m, False)
        return out

    def _oracle_outputs_for(
        self, target: BoundPolicy | BoundGroup, payload: Any
    ) -> dict[str, Any]:
        """Targeted host-oracle evaluation: only the programs the target's
        materializer reads (one policy, or a group's members and its
        expression) — the host fast path's cost is the addressed policy's,
        not the whole set's."""
        out: dict[str, Any] = {}
        if isinstance(target, BoundGroup):
            member_allowed: dict[str, bool] = {}
            referenced = groups_mod.referenced_members(target.ast)
            for m, bp in target.members.items():
                if bp.precompiled.program.host_evaluator is not None:
                    if m in referenced:
                        member_allowed[m] = self._wasm_member_outputs(
                            bp, payload, out
                        )
                    else:
                        # unreferenced wasm member: masked out, so the
                        # engine is skipped and the verdict is inert (the
                        # materializer indexes every member's keys)
                        out[f"p:{bp.policy_id}:allowed"] = False
                        out[f"p:{bp.policy_id}:rule"] = -1
                        member_allowed[m] = False
                    continue
                allowed, rule_idx = oracle_mod.evaluate_program(
                    bp.precompiled.program, payload
                )
                out[f"p:{bp.policy_id}:allowed"] = allowed
                out[f"p:{bp.policy_id}:rule"] = rule_idx
                member_allowed[m] = bool(allowed)
            verdict, evaluated = groups_mod.evaluate_group_host(
                target.ast, member_allowed
            )
            out[f"g:{target.name}:allowed"] = verdict
            for m in target.members:
                out[f"g:{target.name}:eval:{m}"] = evaluated.get(m, False)
            return out
        allowed, rule_idx = oracle_mod.evaluate_program(
            target.precompiled.program, payload
        )
        out[f"p:{target.policy_id}:allowed"] = allowed
        out[f"p:{target.policy_id}:rule"] = rule_idx
        return out

    @property
    def supports_host_fastpath(self) -> bool:
        """True when validate_batch(prefer_host=True) answers on the host:
        the batcher may route small or late batches there. The oracle
        backend is host-side already."""
        return self.backend == "torch"

    def validate_batch(
        self,
        items: list[tuple[str, ValidateRequest]],
        run_hooks: bool = True,
        prefer_host: bool = False,
    ) -> list[AdmissionResponse | Exception]:
        """Evaluate many (policy_id, request) pairs; on the torch backend
        through the native pipeline, one device dispatch per schema bucket
        and chunk of unique, uncached rows.

        Per-item failures (unknown id, initialization error) come back as
        Exception entries; rows no schema holds fall back to the host
        oracle. ``prefer_host=True`` (the batcher's latency fast path)
        answers with the targeted host oracle instead of the device; while
        the breaker is open, every batch does. Raises once the environment
        is closed."""
        self._enter()
        try:
            if self.backend == "oracle":
                return self._validate_batch_oracle(items, run_hooks)
            if prefer_host:
                return self._validate_batch_hostpath(items, run_hooks)
            if not self.breaker.allow_device():
                # tripped: the bit-exact host oracle serves until a
                # half-open probe (admitted by allow_device after the
                # cooldown) closes it
                with self._stats_lock:
                    self._breaker_short_circuited += len(items)
                return self._validate_batch_hostpath(items, run_hooks)
            return self._validate_batch_native(items, run_hooks)
        finally:
            self._leave()

    def _validate_batch_oracle(
        self, items: list[tuple[str, ValidateRequest]], run_hooks: bool
    ) -> list[AdmissionResponse | Exception]:
        """The oracle backend: every row through the host interpreter."""
        results: list[AdmissionResponse | Exception] = []
        for policy_id, request in items:
            try:
                target = self._lookup_top_level(PolicyID.parse(policy_id))
                payload = self.payload_for(target, request)
                if run_hooks and pre_eval_hooks_of(target):
                    self._run_pre_eval_hooks(target, payload)
                    # rebuild: providers must observe hook results
                    payload = self.payload_for(target, request)
                if self._host_executed(target):
                    results.append(
                        self._materialize_single(target, request.uid(), payload, {})
                    )
                    continue
                results.append(
                    self._materialize(
                        target, request, self._oracle_outputs(payload, target)
                    )
                )
            except Exception as e:  # noqa: BLE001 — per-item error channel
                results.append(e)
        return results

    def _validate_batch_hostpath(
        self,
        items: list[tuple[str, ValidateRequest]],
        run_hooks: bool,
    ) -> list[AdmissionResponse | Exception]:
        """The latency fast path: per-item semantics of the device path
        (lookup, hooks, payload), but verdicts from the targeted host
        oracle — no transfer, no device round trip. The verdict cache
        serves here too: blob tier first (its key is in hand), the row
        tier (a single-row encode for its key) only on a blob miss. The
        loop is the recorder's ``host_eval``."""
        results: list[AdmissionResponse | Exception | None] = [None] * len(items)
        n_host = 0
        rec = flightrec.recorder()
        if rec is not None:
            t0, c0 = time.perf_counter_ns(), time.thread_time_ns()
        for i, (policy_id, request) in enumerate(items):
            try:
                target = self._fast_target(policy_id)
                payload = self.payload_for(target, request)
                if run_hooks and self._hooks_of(target):
                    self._run_pre_eval_hooks(target, payload)
                    payload = self.payload_for(target, request)
                if self._host_executed(target):
                    results[i] = self._materialize_single(
                        target, request.uid(), payload, {}
                    )
                    continue
                key = bkey = None
                if self._verdict_cache is not None and self._cacheable(target):
                    blob = self._blob_of(target, request, payload)
                    bkey = (self._cache_key_of(target), blob)
                    row = self._blob_cache.get(bkey)
                    if row is not None:
                        results[i] = self._materialize(target, request, row)
                        n_host += 1
                        continue
                    key = self._row_cache_key(target, blob)
                    if key is not None:
                        row = self._verdict_cache.get(key)
                        if row is not None:
                            # no blob-tier backfill: on uid-varying traffic
                            # each hit's blob never recurs, and inserting
                            # it would churn the blob tier's real replays
                            results[i] = self._materialize(target, request, row)
                            n_host += 1
                            continue
                outputs = self._oracle_outputs_for(target, payload)
                if key is not None:
                    self._verdict_cache.put(key, outputs)
                if bkey is not None:
                    self._blob_cache.put(bkey, outputs)
                results[i] = self._materialize(target, request, outputs)
                n_host += 1
            except Exception as e:  # noqa: BLE001 — per-item error channel
                results[i] = e
        if rec is not None:
            rec.record_phase(
                flightrec.PH_HOST_EVAL, t0, time.perf_counter_ns(),
                rows=len(items), batch=flightrec.current_batch(),
                cpu_ns=time.thread_time_ns() - c0,
            )
        if n_host:
            with self._stats_lock:
                self._host_fastpath_requests += n_host
        return results  # type: ignore[return-value]

    def _validate_batch_native(
        self,
        items: list[tuple[str, ValidateRequest]],
        run_hooks: bool,
        defer_sink: list | None = None,
    ) -> list[AdmissionResponse | Exception]:
        """The native path: each item's payload blob is built once, ONE
        locked blob-tier lookup answers exact replays before any encode,
        and the rest go through one native encode per schema bucket
        (``_native_schema_pass``); rows that overflow a bucket cascade to
        the next, rows beyond the widest to the host oracle.
        ``defer_sink``: see validate_batch_begin. ``wasm_infos`` holds the
        wasm member verdicts of the rows whose group has wasm members
        (``_eval_wasm_members``)."""
        results: list[AdmissionResponse | Exception | None] = [None] * len(items)
        targets: list[Any] = [None] * len(items)
        blobs: list[bytes | None] = [None] * len(items)
        pending: list[int] = []
        wasm_infos: dict[int, dict] = {}
        uniform_tid: int | None = None
        uniform_target = True
        # the target-resolution and payload-blob loop is the recorder's
        # ``prepare``
        rec = flightrec.recorder()
        t_prep = time.perf_counter_ns()
        c_prep = time.thread_time_ns() if rec is not None else 0
        for i, (policy_id, request) in enumerate(items):
            try:
                target = self._fast_target(policy_id)
                targets[i] = target
                if run_hooks and self._hooks_of(target):
                    self._run_pre_eval_hooks(
                        target, self.payload_for(target, request)
                    )
                if self._host_executed(target):
                    # wasm-backed rows never enter the device batch
                    results[i] = self._materialize_single(
                        target,
                        request.uid(),
                        self.payload_for(target, request),
                        {},
                    )
                    continue
                if (
                    isinstance(target, BoundGroup)
                    and target.name in self._groups_with_wasm
                ):
                    # groups with wasm members: the wasm engine runs NOW
                    # on the host; the bits join the device batch
                    wasm_infos[i] = self._eval_wasm_members(
                        target, self.payload_for(target, request)
                    )
                blobs[i] = self._payload_blob(target, request)
                if uniform_tid is None:
                    uniform_tid = id(target)
                elif id(target) != uniform_tid:
                    uniform_target = False
                pending.append(i)
            except Exception as e:  # noqa: BLE001 — per-item error channel
                results[i] = e
        if rec is not None:
            rec.record_phase(
                flightrec.PH_PREPARE, t_prep, time.perf_counter_ns(),
                rows=len(items), batch=flightrec.current_batch(),
                cpu_ns=time.thread_time_ns() - c_prep,
            )

        # tier 1, the blob tier: exact payload replays never reach the
        # encoder (one locked batch lookup)
        bcache = self._blob_cache
        if bcache is not None and pending:
            t0 = time.perf_counter_ns()
            c0 = time.thread_time_ns() if rec is not None else 0
            keys = [
                (self._cache_key_of(targets[i]), blobs[i])
                if self._cacheable(targets[i])
                else None
                for i in pending
            ]
            rows = bcache.get_many(keys)
            still: list[int] = []
            # under the batcher's fragment scope a hit answers as uid plus
            # a pre-built template, built once per cached row and target
            frag_on = _fragments_enabled()
            n_frag = 0
            for i, row in zip(pending, rows):
                if row is None:
                    still.append(i)
                    continue
                tmpl = self._frag_of(targets[i], row) if frag_on else None
                if tmpl is not None:
                    results[i] = FragVerdict(items[i][1].uid(), tmpl)
                    n_frag += 1
                else:
                    results[i] = self._materialize(targets[i], items[i][1], row)
            t1 = time.perf_counter_ns()
            self._profile_add(
                bookkeeping_ns=t1 - t0, bookkeeping_rows=len(pending)
            )
            if rec is not None:
                rec.record_phase(
                    flightrec.PH_BLOB_DEDUP, t0, t1,
                    rows=len(pending), batch=flightrec.current_batch(),
                    cpu_ns=time.thread_time_ns() - c0,
                )
            if n_frag:
                with self._stats_lock:
                    self._frag_hits += n_frag
            pending = still

        for schema in self.schemas:
            if not pending:
                break
            pending = self._native_schema_pass(
                schema, items, targets, results, pending, wasm_infos,
                blobs=blobs, uniform_target=uniform_target,
                defer_sink=defer_sink,
            )

        for i in pending:  # beyond the widest schema → the oracle
            with self._stats_lock:
                self._oracle_fallbacks += 1
            request = items[i][1]
            results[i] = self._materialize(
                targets[i], request,
                self._oracle_outputs(
                    self.payload_for(targets[i], request), targets[i]
                ),
            )
        return results  # type: ignore[return-value]

    # -- split host/device halves (the batcher's pipeline) -----------------

    def validate_batch_begin(
        self,
        items: list[tuple[str, ValidateRequest]],
        run_hooks: bool = True,
    ) -> tuple | None:
        """Host half of the native pipeline: lookup, hooks, blob dedup,
        native encode, row dedup and the device enqueue — everything but
        waiting for device results. Returns a handle for
        validate_batch_finish, or None when the pipeline is unavailable
        (the oracle backend, or a tripped breaker); the caller then uses
        validate_batch. Raises once the environment is closed; a returned
        handle keeps the dispatch open until its finish."""
        self._enter()
        try:
            if self.backend != "torch" or not self.breaker.allow_device():
                self._leave()
                return None
            deferred: list = []
            results = self._validate_batch_native(
                items, run_hooks, defer_sink=deferred
            )
        except BaseException:
            self._leave()
            raise
        return (results, deferred)

    def validate_batch_finish(
        self, handle: tuple
    ) -> list[AdmissionResponse | Exception]:
        """Device half: wait for each chunk's fetch and materialize the
        responses. All blocking happens here (watchdog-safe)."""
        results, deferred = handle
        try:
            for materialize_fn, entry in deferred:
                materialize_fn(entry)
        finally:
            self._leave()
        return results  # type: ignore[return-value]

    def _native_schema_pass(
        self,
        schema: FeatureSchema,
        items: list[tuple[str, ValidateRequest]],
        targets: list[Any],
        results: list[AdmissionResponse | Exception | None],
        pending: list[int],
        wasm_infos: dict[int, dict] | None = None,
        blobs: list[bytes | None] | None = None,
        uniform_target: bool = False,
        defer_sink: list | None = None,
    ) -> list[int]:
        """Encode and dispatch all ``pending`` rows against one schema, in
        chunks of at most ``max_dispatch_batch``; returns the rows that
        overflowed it.

        The ROW tier sits between encode and dispatch: the device step is
        a pure function of the encoded row, so rows with identical packed
        bytes have identical outputs. One ``np.unique`` over a void view of
        the packed rows gives row identity; cross-batch repeats are
        answered from the cache, in-chunk duplicates collapse onto one
        dispatched slot, and only unique rows are copied to the card. Each
        tier pays one locked batch call per chunk. With ``defer_sink`` set
        the materialize closures are appended instead of run, so
        validate_batch_finish can wait for the device on another call than
        the one that encodes. Rows carrying wasm member bits are not a
        pure function of their bytes: they are never deduped or cached,
        and take the first slots of a compacted dispatch."""
        chunk_size = min(self.bucket_for(len(pending)), self.max_dispatch_batch)
        chunks = [
            pending[c : c + chunk_size]
            for c in range(0, len(pending), chunk_size)
        ]
        # the recorder's batch id rides this thread's scope; the closures
        # below capture it for the fetch, which may run later
        rec = flightrec.recorder()
        bid = flightrec.current_batch() if rec is not None else -1
        overflowed: list[int] = []
        # (in-flight step, slot rows, wasm stash, row-tier insertions,
        # blob-tier insertions) per chunk
        drains: list[tuple] = []
        cache = self._verdict_cache
        bcache = self._blob_cache
        # mixed-target batches: a small int id per distinct target
        tid_of: dict[int, int] = {}
        ckey_of_tid: list[tuple] = []

        def encode(chunk: list[int]):
            failpoints.fire("encode.batch")
            t0 = time.perf_counter_ns()
            c0 = time.thread_time_ns() if rec is not None else 0
            bl = [blobs[i] for i in chunk]
            out = schema.native.encode_batch(bl, self.bucket_for(len(bl)), self.table)
            t1 = time.perf_counter_ns()
            cpu = time.thread_time_ns() - c0 if rec is not None else 0
            self._profile_add(encode_ns=t1 - t0, encode_rows=len(chunk))
            return bl, out, t0, t1, cpu

        def materialize(entry) -> None:
            step, slot_rows, stash, lru_inserts, blob_inserts = entry
            t0 = time.perf_counter_ns()
            c0 = time.thread_time_ns() if rec is not None else 0
            raw = self._device_fetch(step, len(slot_rows), bid)
            t1 = time.perf_counter_ns()
            c1 = time.thread_time_ns() if rec is not None else 0
            self._profile_add(dispatch_wait_ns=t1 - t0)
            outputs = self._unpack(raw)
            outputs.update(stash)
            if lru_inserts or blob_inserts:
                row_of_slot: dict[int, dict] = {}

                def row_for(slot: int) -> dict:
                    row_out = row_of_slot.get(slot)
                    if row_out is None:
                        row_out = row_of_slot[slot] = extract_row(outputs, slot)
                    return row_out

                if lru_inserts:
                    cache.put_many(
                        (key, row_for(slot))
                        for slot, keys in lru_inserts.items()
                        for key in keys
                    )
                if blob_inserts:
                    bcache.put_many(
                        (key, row_for(slot))
                        for slot, keys in blob_inserts.items()
                        for key in keys
                    )
            for slot, i in slot_rows:
                results[i] = self._materialize(
                    targets[i], items[i][1], _RowView(outputs, slot)
                )
            if rec is not None:
                rec.record_phase(
                    flightrec.PH_FETCH, t0, t1, rows=len(slot_rows), batch=bid,
                    cpu_ns=c1 - c0,
                )
                rec.record_phase(
                    flightrec.PH_MATERIALIZE, t1, time.perf_counter_ns(),
                    rows=len(slot_rows), batch=bid,
                    cpu_ns=time.thread_time_ns() - c1,
                )

        window = self.max_inflight_dispatches
        drained = 0
        for chunk in chunks:
            try:
                chunk_blobs, (features, status), t0, t1, cpu = encode(chunk)
            except ValueError:
                # arena or records overflow on a pathological chunk: keep
                # per-item isolation — the whole chunk goes to the next
                # schema or the oracle
                overflowed.extend(chunk)
                continue
            if rec is not None:
                rec.record_phase(
                    flightrec.PH_ENCODE, t0, t1, rows=len(chunk), batch=bid,
                    cpu_ns=cpu,
                )
            n_chunk = len(chunk)
            status = np.asarray(status)[:n_chunk]
            ok_mask = status == 0
            all_ok = bool(ok_mask.all())
            if not all_ok:
                overflowed.extend(chunk[int(p)] for p in np.flatnonzero(~ok_mask))
            lru_inserts: dict[int, set] = {}
            blob_inserts: dict[int, list] = {}
            if cache is None:
                slot_rows = [
                    (pos, i) for pos, i in enumerate(chunk) if ok_mask[pos]
                ]
                wasm_rows = [
                    (pos, wasm_infos[i])
                    for pos, i in enumerate(chunk)
                    if wasm_infos and i in wasm_infos
                ]
                if not slot_rows:
                    continue
                n_dispatched = len(slot_rows)
            else:
                t_book = time.perf_counter_ns()
                c_book = time.thread_time_ns() if rec is not None else 0
                packed = features[PACKED_KEY]
                item_arr = np.asarray(chunk, dtype=np.intp)
                if wasm_infos:
                    # wasm verdict bits ride beside the row: not a pure
                    # function of the row bytes, never deduped or cached
                    wasm_pos = [
                        pos
                        for pos, i in enumerate(chunk)
                        if i in wasm_infos and ok_mask[pos]
                    ]
                    wset = set(wasm_pos)
                    dedup_pos = np.asarray(
                        [
                            int(p)
                            for p in np.flatnonzero(ok_mask)
                            if int(p) not in wset
                        ],
                        dtype=np.intp,
                    )
                else:
                    wasm_pos = []
                    dedup_pos = np.flatnonzero(ok_mask)
                slot_rows = []
                n_d = int(dedup_pos.size)
                keep_uncompacted = False
                keep_rows = np.empty(0, dtype=np.intp)
                rows_arr = None
                if n_d:
                    # ROW IDENTITY in one vectorized pass: a void view makes
                    # each packed row one comparable scalar
                    rows_arr = np.ascontiguousarray(packed[dedup_pos])
                    void = rows_arr.view(
                        np.dtype((np.void, rows_arr.shape[1] * rows_arr.itemsize))
                    ).ravel()
                    uniq, first, inverse = np.unique(
                        void, return_index=True, return_inverse=True
                    )
                    inverse = np.asarray(inverse).ravel()
                    m = int(uniq.size)
                    if uniform_target:
                        # one target: the combo space IS the row space
                        ckey = self._cache_key_of(
                            targets[int(item_arr[dedup_pos[0]])]
                        )
                        combo_first = first
                        combo_inverse = inverse
                        keys = [(ckey, rows_arr[int(ri)].tobytes()) for ri in first]
                    else:
                        # distinct (target, row) combos: the same row bytes
                        # under different targets share a dispatch slot but
                        # carry separate cache keys
                        def tid(t) -> int:
                            k = tid_of.get(id(t))
                            if k is None:
                                k = len(ckey_of_tid)
                                tid_of[id(t)] = k
                                ckey_of_tid.append(self._cache_key_of(t))
                            return k

                        tids = np.fromiter(
                            (tid(targets[int(p)]) for p in item_arr[dedup_pos]),
                            dtype=np.int64,
                            count=n_d,
                        )
                        combos = tids * m + inverse
                        uc, combo_first, combo_inverse = np.unique(
                            combos, return_index=True, return_inverse=True
                        )
                        combo_inverse = np.asarray(combo_inverse).ravel()
                        keys = [
                            (
                                ckey_of_tid[int(uc[k] // m)],
                                rows_arr[int(combo_first[k])].tobytes(),
                            )
                            for k in range(len(uc))
                        ]
                    # ONE locked lookup per chunk for the whole row tier
                    cached = cache.get_many(keys)
                    hit_flags = np.fromiter(
                        (c is not None for c in cached),
                        dtype=bool,
                        count=len(cached),
                    )
                    row_hit = hit_flags[combo_inverse]
                    hit_rows = np.flatnonzero(row_hit)
                    # get_many counted one hit or miss per combo KEY; rescale
                    # to rows (rows served from / missed by the row tier)
                    n_hit_keys = int(hit_flags.sum())
                    cache.adjust_counts(
                        hits=int(hit_rows.size) - n_hit_keys,
                        misses=(n_d - int(hit_rows.size))
                        - (len(cached) - n_hit_keys),
                    )
                    if hit_rows.size:
                        hit_items = item_arr[dedup_pos[hit_rows]].tolist()
                        hit_combos = combo_inverse[hit_rows].tolist()
                        frag_on = _fragments_enabled()
                        n_frag = 0
                        for i, k in zip(hit_items, hit_combos):
                            tmpl = (
                                self._frag_of(targets[i], cached[k])
                                if frag_on else None
                            )
                            if tmpl is not None:
                                results[i] = FragVerdict(items[i][1].uid(), tmpl)
                                n_frag += 1
                            else:
                                results[i] = self._materialize(
                                    targets[i], items[i][1], cached[k]
                                )
                        if n_frag:
                            with self._stats_lock:
                                self._frag_hits += n_frag
                        if bcache is not None:
                            # backfill the blob tier so the NEXT identical
                            # payload skips the encode: ONE representative
                            # per hit combo per chunk, or uid-varying
                            # traffic (every blob new) would churn the blob
                            # tier's real replays out
                            seen_combos: set[int] = set()
                            bput = []
                            for pos, k in zip(
                                dedup_pos[hit_rows].tolist(), hit_combos
                            ):
                                if k in seen_combos:
                                    continue
                                seen_combos.add(k)
                                bput.append(
                                    ((keys[k][0], chunk_blobs[pos]), cached[k])
                                )
                            bcache.put_many(bput)
                    miss_rows = np.flatnonzero(~row_hit)
                    if miss_rows.size:
                        miss_inv = inverse[miss_rows]
                        uniq_miss, miss_first, slot_inv = np.unique(
                            miss_inv, return_index=True, return_inverse=True
                        )
                        slot_inv = np.asarray(slot_inv).ravel()
                        dup_hits = int(miss_rows.size - uniq_miss.size)
                        if dup_hits:
                            with self._stats_lock:
                                self._batch_dedup_hits += dup_hits
                        keep_rows = miss_rows[miss_first]
                        keep_uncompacted = (
                            not wasm_pos
                            and all_ok
                            and hit_rows.size == 0
                            and dup_hits == 0
                        )
                        if keep_uncompacted:
                            # nothing collapsed: ship the encoded buffer as
                            # is — slots are the encode positions
                            slots = dedup_pos[miss_rows]
                        else:
                            slots = slot_inv + len(wasm_pos)
                        miss_items = item_arr[dedup_pos[miss_rows]]
                        slot_rows = list(zip(slots.tolist(), miss_items.tolist()))
                        # per-combo cache keys onto their dispatch slot
                        miss_combos = np.flatnonzero(~hit_flags).tolist()
                        combo_rowuniq = np.arange(m) if uniform_target else uc % m
                        for k in miss_combos:
                            u = int(combo_rowuniq[k])
                            if keep_uncompacted:
                                slot = int(dedup_pos[int(combo_first[k])])
                            else:
                                slot = int(
                                    np.searchsorted(uniq_miss, u)
                                ) + len(wasm_pos)
                            lru_inserts.setdefault(slot, set()).add(keys[k])
                        if bcache is not None:
                            # blob-to-row learning: ONE representative blob
                            # per dispatched slot (collapsed duplicates'
                            # blobs vary by uid and never recur)
                            for j, pos in enumerate(dedup_pos[keep_rows].tolist()):
                                slot = pos if keep_uncompacted else j + len(wasm_pos)
                                i = chunk[pos]
                                blob_inserts.setdefault(slot, []).append(
                                    (self._cache_key_of(targets[i]), chunk_blobs[pos])
                                )
                wasm_rows = []
                n_keep = len(wasm_pos) + int(keep_rows.size)
                for j, pos in enumerate(wasm_pos):
                    i = chunk[pos]
                    wasm_rows.append((j, wasm_infos[i]))
                    slot_rows.append((j, i))
                # ns only: the blob-tier pre-pass already counted these rows
                t_book_end = time.perf_counter_ns()
                self._profile_add(bookkeeping_ns=t_book_end - t_book)
                if rec is not None:
                    rec.record_phase(
                        flightrec.PH_BOOKKEEPING, t_book, t_book_end,
                        rows=len(chunk), batch=bid,
                        cpu_ns=time.thread_time_ns() - c_book,
                    )
                if not slot_rows:
                    continue  # the whole chunk came from the caches
                if not keep_uncompacted:
                    # compact: only unique rows (after the wasm rows) go to
                    # the card
                    compact = np.zeros(
                        (self.bucket_for(n_keep), packed.shape[1]), packed.dtype
                    )
                    if wasm_pos:
                        compact[: len(wasm_pos)] = packed[
                            np.asarray(wasm_pos, dtype=np.intp)
                        ]
                    if keep_rows.size:
                        compact[len(wasm_pos) : n_keep] = rows_arr[keep_rows]
                    features = {PACKED_KEY: compact}
                n_dispatched = n_keep
            if rec is not None:
                t_sub, c_sub = time.perf_counter_ns(), time.thread_time_ns()
            stash = self._add_wasm_bits(
                features, features[PACKED_KEY].shape[0], wasm_rows
            )
            step = self._device_call(self._enqueue_features, features)
            if rec is not None:
                rec.record_phase(
                    flightrec.PH_SUBMIT, t_sub, time.perf_counter_ns(),
                    rows=len(slot_rows), batch=bid,
                    cpu_ns=time.thread_time_ns() - c_sub,
                )
            self._profile_add(dispatched_rows=n_dispatched, dispatched_chunks=1)
            entry = (step, slot_rows, stash, lru_inserts, blob_inserts)
            if defer_sink is not None:
                defer_sink.append((materialize, entry))
                continue
            drains.append(entry)
            if len(drains) - drained >= window:
                materialize(drains[drained])
                drained += 1
        for entry in drains[drained:]:
            materialize(entry)
        return overflowed

    # -- response materialization (host side) ------------------------------

    def _materialize(
        self,
        target: BoundPolicy | BoundGroup,
        request: ValidateRequest,
        outputs: Mapping[str, Any],
    ) -> AdmissionResponse:
        uid = request.uid()
        if isinstance(target, BoundGroup):
            return self._materialize_group(target, uid, request.payload, outputs)
        return self._materialize_single(target, uid, request.payload, outputs)

    def _materialize_single(
        self,
        bp: BoundPolicy,
        uid: str,
        payload_fn: Any,  # zero-arg callable OR a pre-built payload value
        outputs: Mapping[str, Any],
    ) -> AdmissionResponse:
        payload_of = payload_fn if callable(payload_fn) else (lambda: payload_fn)
        host_eval = bp.precompiled.program.host_evaluator
        if host_eval is not None:
            # wasm-backed policy: the verdict comes from host-side wasm
            # execution (evaluation/wasm_policy.py); device outputs are
            # inert for these rows
            verdict = host_eval(payload_of())
            if bool(verdict.get("accepted")):
                response = AdmissionResponse(uid=uid, allowed=True)
                mutated = verdict.get("mutated_object")
                if mutated is not None:
                    # whole-object replacement patch (waPC mutation shape)
                    response.patch = base64.b64encode(
                        json.dumps(
                            [{"op": "replace", "path": "", "value": mutated}]
                        ).encode()
                    ).decode()
                    response.patch_type = JSON_PATCH
                return response
            return AdmissionResponse(
                uid=uid,
                allowed=False,
                status=ValidationStatus(
                    message=str(verdict.get("message") or "rejected by policy"),
                    code=int(verdict.get("code") or 400),
                ),
            )
        allowed_key, rule_key = self._single_mat[bp.policy_id]
        if not bool(outputs[allowed_key]):
            rule = bp.precompiled.program.rules[int(outputs[rule_key])]
            message = (
                rule.message
                if isinstance(rule.message, str)
                else rule.message(payload_of())
            )
            return AdmissionResponse(
                uid=uid,
                allowed=False,
                status=ValidationStatus(message=message, code=400),
            )
        response = AdmissionResponse(uid=uid, allowed=True)
        mutator = bp.precompiled.program.mutator
        if mutator is not None:
            ops = mutator(payload_of())
            if ops:
                response.patch = base64.b64encode(json.dumps(ops).encode()).decode()
                response.patch_type = JSON_PATCH
        return response

    def _materialize_group(
        self,
        group: BoundGroup,
        uid: str,
        payload_fn: Any,  # zero-arg callable OR a pre-built payload value
        outputs: Mapping[str, Any],
    ) -> AdmissionResponse:
        payload_of = payload_fn if callable(payload_fn) else (lambda: payload_fn)
        allowed_key, members, risky = self._group_mat[group.name]
        allowed = bool(outputs[allowed_key])
        # group-member mutation ban: an evaluated, allowed member that
        # would mutate rejects the whole group; wasm members report
        # would-mutate from their host verdict (wm:<pid>:mutated)
        for (
            _m, _bp, eval_key, allowed_key_m, _rule_key,
            wm_mut_key, _wm_msg_key, is_wasm, mutator,
        ) in risky:
            if not (
                bool(outputs.get(eval_key, False)) and bool(outputs[allowed_key_m])
            ):
                continue
            if is_wasm:
                would_mutate = bool(outputs.get(wm_mut_key, False))
            else:
                would_mutate = bool(mutator(payload_of()))
            if would_mutate:
                return AdmissionResponse(
                    uid=uid,
                    allowed=False,
                    status=ValidationStatus(
                        message=GROUP_MUTATION_MESSAGE, code=500
                    ),
                )
        if allowed:
            return AdmissionResponse(uid=uid, allowed=True)
        causes: list[StatusCause] = []
        for (
            member_name, bp, eval_key, allowed_key_m, rule_key,
            _wm_mut_key, wm_msg_key, is_wasm, _mutator,
        ) in members:
            if bool(outputs.get(eval_key, False)) and not bool(
                outputs[allowed_key_m]
            ):
                if is_wasm:
                    message = outputs.get(wm_msg_key) or "rejected by policy"
                else:
                    rule = bp.precompiled.program.rules[int(outputs[rule_key])]
                    message = (
                        rule.message
                        if isinstance(rule.message, str)
                        else rule.message(payload_of())
                    )
                causes.append(
                    StatusCause(
                        field=f"spec.policies.{member_name}", message=message
                    )
                )
        return AdmissionResponse(
            uid=uid,
            allowed=False,
            status=ValidationStatus(
                message=group.message,
                code=400,
                details=StatusDetails(causes=tuple(causes)),
            ),
        )


def _plain(value: Any) -> Any:
    """Tuples → lists, recursively (layouts compare as plain data)."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value
