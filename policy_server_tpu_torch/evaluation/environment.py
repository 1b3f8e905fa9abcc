"""EvaluationEnvironment — the policy registry and the batched evaluator.

Counterpart of ``policy_server_tpu/evaluation/environment.py`` for PyTorch
on an NVIDIA card. The registry is built once (builder → environment):
module dedup by digest, per-policy settings validated at boot, group
expressions type-checked at boot, ``policy_initialization_errors`` under
``continue_on_errors``. ``validate(policy_id, request)`` dispatches single
vs group targets.

The batched path: every request of a micro-batch is encoded on the host
into one packed ``uint8`` row per request (``ops/codec.py``), the batch is
narrowed to its transport form, copied to the card once, and one launch of
the ``policy_matrix`` kernel (``ops/cuda_kernels.py``) computes every
policy's verdict for every row. The group combine and the output packing
run as plain PyTorch on the card, and one copy brings the packed verdicts
back. Requests that overflow the feature schema fall back to the host
oracle (``evaluation/oracle.py``) and are counted.

Backends: ``torch`` (the device path; ``device="cpu"`` runs the kernels'
plain PyTorch versions) and ``oracle`` (the host interpreter).
"""

from __future__ import annotations

import base64
import dataclasses
import json
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

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
from policy_server_tpu_torch.models import (
    AdmissionResponse,
    StatusCause,
    StatusDetails,
    ValidateRequest,
    ValidationStatus,
)
from policy_server_tpu_torch.models.admission import JSON_PATCH
from policy_server_tpu_torch.models.policy import (
    Policy,
    PolicyGroup,
    PolicyMode,
    PolicyOrPolicyGroup,
)
from policy_server_tpu_torch.ops import cuda_kernels
from policy_server_tpu_torch.ops.codec import (
    DEFAULT_AXIS_CAP,
    DEFAULT_NESTED_AXIS_CAP,
    PACKED_KEY,
    FeatureSchema,
    SchemaOverflow,
    ensure_unique_packed_widths,
)
from policy_server_tpu_torch.ops.compiler import compile_constant, compile_program
from policy_server_tpu_torch.ops.optimizer import (
    PolicyOptimization,
    optimize_policy_set,
)
from policy_server_tpu_torch.policies import resolve_builtin
from policy_server_tpu_torch.utils.interning import InternTable

GROUP_MUTATION_MESSAGE = "mutation is not allowed inside of policy group"

# payload key under which program context providers' output is merged
CONTEXT_KEY = "__context__"

# element-axis caps of the small schema bucket (the large bucket uses the
# codec's defaults, 64 and 32); the JAX package's defaults
SMALL_AXIS_CAP = 8
SMALL_NESTED_AXIS_CAP = 4


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


@dataclass
class BoundGroup:
    name: str
    expression: str
    ast: Any
    message: str
    policy_mode: PolicyMode
    members: dict[str, BoundPolicy] = field(default_factory=dict)


def resolve_module(url: str) -> PolicyModule:
    builtin = resolve_builtin(url)
    if builtin is None:
        raise BootstrapFailure(
            f"module {url!r} is not a builtin (only builtin:// modules are "
            "served by this package)"
        )
    return builtin


class EvaluationEnvironmentBuilder:
    """Boot-time assembly of an :class:`EvaluationEnvironment`.

    ``device`` defaults to the card; with no card the builder raises
    unless the caller asks for ``device="cpu"``. The ``oracle`` backend
    needs no device."""

    def __init__(
        self,
        backend: str = "torch",
        device: "str | torch.device | None" = None,
        continue_on_errors: bool = False,
        always_accept_admission_reviews_on_namespace: str | None = None,
        predicate_opt: bool = True,
    ) -> None:
        if backend not in ("torch", "oracle"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.device = resolve_device(device) if backend == "torch" else None
        self.continue_on_errors = continue_on_errors
        self.always_accept_namespace = always_accept_admission_reviews_on_namespace
        self.predicate_opt = predicate_opt

    def build(
        self, policies: Mapping[str, PolicyOrPolicyGroup]
    ) -> "EvaluationEnvironment":
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
        ) -> BoundPolicy:
            module = resolve_module(module_url)
            validation = module.validate_settings(dict(settings or {}))
            if not validation.valid:
                raise PolicyInitializationError(
                    pid, f"Policy settings are invalid: {validation.message or ''}"
                )
            pre = cache.get_or_build(module, settings or {})
            if pre.program.host_evaluator is not None:
                raise BootstrapFailure(
                    f"policy {pid!r}: host-executed policies are not served "
                    "by this package"
                )
            return BoundPolicy(
                policy_id=pid,
                module_url=module_url,
                precompiled=pre,
                eval_settings=PolicyEvaluationSettings(
                    policy_mode=policy_mode,
                    allowed_to_mutate=allowed_to_mutate,
                    settings=dict(settings or {}),
                ),
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
                    for member_name, member in entry.policies.items():
                        group.members[member_name] = bootstrap_policy(
                            f"{name}/{member_name}",
                            member.module,
                            member.settings,
                            entry.policy_mode,
                            False,  # group members never mutate
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

        return EvaluationEnvironment(
            backend=self.backend,
            device=self.device,
            bound=bound,
            groups=groups,
            init_errors=init_errors,
            always_accept_namespace=self.always_accept_namespace,
            predicate_opt=self.predicate_opt,
        )


class EvaluationEnvironment:
    """Immutable post-boot registry + the batched evaluator. All state is
    read-only after construction, apart from the fallback counter and the
    lazily built kernel programs (guarded by ``_lock``)."""

    # largest batch one dispatch takes; bigger batches are chunked
    max_dispatch_batch = 1024

    def __init__(
        self,
        backend: str,
        device: torch.device | None,
        bound: dict[str, BoundPolicy],
        groups: dict[str, BoundGroup],
        init_errors: dict[str, str],
        always_accept_namespace: str | None = None,
        predicate_opt: bool = True,
    ) -> None:
        self.backend = backend
        self.device = device
        self.always_accept_namespace = always_accept_namespace
        self._bound = bound
        self._groups = groups
        self._init_errors = init_errors
        self._lock = threading.Lock()
        self._oracle_fallbacks = 0  # guarded-by: _lock
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
        # the device selects a layout by row width, so widths must be
        # unique across schemas and buffer forms
        ensure_unique_packed_widths(self.schemas)
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
                    bp.precompiled.program.mutator,
                )
                for m, bp in group.members.items()
            ]
            risky = [e for e in members if e[5] is not None]
            self._group_mat[name] = (f"g:{name}:allowed", members, risky)
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
        self._programs: dict[tuple[int, bool, bool], Any] = {}
        self._combine_cols: dict[tuple, torch.Tensor] = {}
        if self.backend != "torch":
            return
        for idx, schema in enumerate(self.schemas):
            if schema.packed_layout().u16_count:
                self.program_for(idx, True, True)
            self.program_for(idx, True, False)

    def program_for(
        self, schema_idx: int, transport: bool, narrow: bool
    ) -> "cuda_kernels.PolicyMatrixProgram":
        """The ``policy_matrix`` program of one schema bucket and buffer
        form (built on first use)."""
        key = (schema_idx, transport, narrow)
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
                )
        return program

    def _probe_device(self) -> None:
        """Build the kernel library and launch the probe kernel once: a
        failed build or launch raises with the compiler's or the CUDA
        runtime's text."""
        cuda_kernels.build_library()
        x = torch.arange(8 * 128, dtype=torch.float32, device=self.device)
        x = x.reshape(8, 128)
        y = cuda_kernels.probe(x)
        torch.cuda.synchronize(self.device)
        if not torch.equal(y, x + 1.0):
            raise RuntimeError("probe kernel returned a wrong result")

    def install_reference_state(
        self, strings: Sequence[str], layouts: Sequence[Mapping[str, Any]]
    ) -> None:
        """Install another environment's intern table and check its packed
        layouts, given as plain data: ``strings`` are the table's strings
        in id order from id 1 (id 0 is the reserved MISSING id), and
        ``layouts`` each schema's ``PackedLayout`` fields
        (``dataclasses.asdict``). Afterwards a packed buffer encoded by
        that environment evaluates unchanged here. Raises ValueError when
        a layout differs."""
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

    @property
    def oracle_fallbacks(self) -> int:
        with self._lock:
            return self._oracle_fallbacks

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
        """The evaluation payload: the request document, plus the program
        context providers' output under ``__context__``."""
        payload = request.payload()
        providers = self._providers_of(target)
        if not providers:
            return payload
        payload = dict(payload)
        ctx: dict = {}
        for provider in providers:
            ctx.update(provider(payload))
        payload[CONTEXT_KEY] = ctx
        return payload

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
    ) -> torch.Tensor:
        """Policy verdict matrix → the one packed output tensor
        ``(B, P + P + G + G*Mmax)``: policy verdicts, rule indices, group
        verdicts and group member-evaluated masks, uint8 when every rule
        index fits a byte (-1 wraps to 255)."""
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

    def evaluate_packed(self, buf: np.ndarray) -> np.ndarray:
        """One packed ``uint8`` batch (any of the three forms) → the packed
        output array: one host-to-device copy, one ``policy_matrix``
        launch, the combine, one copy back."""
        idx, _layout, transport, narrow = self._layout_for_buffer(buf.shape[1])
        program = self.program_for(idx, transport, narrow)
        dev_buf = torch.from_numpy(np.ascontiguousarray(buf)).to(self.device)
        a_mat, r_mat = cuda_kernels.policy_matrix(dev_buf, program)
        out = self._combine_outputs(a_mat, r_mat, program.column_of)
        return out.cpu().numpy()

    def run_batch(self, features: Mapping[str, Any]) -> dict[str, np.ndarray]:
        """Dispatch one encoded (wide packed) batch: narrow it to the
        transport form, evaluate it on the device, unpack the verdicts."""
        if self.backend != "torch":
            raise RuntimeError("run_batch needs the torch backend")
        buf = np.asarray(self._transport(features)[PACKED_KEY])
        return self._unpack(self.evaluate_packed(buf))

    def warmup(self, batch_sizes: tuple[int, ...] = (1,)) -> None:
        """Run an all-missing batch of each size through every schema
        bucket, so the first request pays no first-launch costs."""
        for schema in self.schemas:
            for b in sorted({bucket_size(n) for n in batch_sizes}):
                self.run_batch(schema.empty_batch_packed(b))

    def encode_bucketed(self, payload: Any) -> tuple[int, dict[str, np.ndarray]]:
        """Encode into the smallest shape bucket that fits; raises
        SchemaOverflow when even the widest schema cannot hold the
        request (→ oracle fallback)."""
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

    def _oracle_outputs(self, payload: Any) -> dict[str, Any]:
        """Host-interpreter evaluation of every policy and group (scalar
        outputs, the same keys as the device path)."""
        out: dict[str, Any] = {}
        for pid, bp in self._bound.items():
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

    def validate_batch(
        self,
        items: list[tuple[str, ValidateRequest]],
        run_hooks: bool = True,
    ) -> list[AdmissionResponse | Exception]:
        """Evaluate many (policy_id, request) pairs; on the torch backend
        each schema bucket of the batch is one device dispatch.

        Per-item failures (unknown id, initialization error) come back as
        Exception entries; SchemaOverflow rows fall back to the host
        oracle."""
        if len(items) > self.max_dispatch_batch:
            out: list[AdmissionResponse | Exception] = []
            for c in range(0, len(items), self.max_dispatch_batch):
                out.extend(
                    self.validate_batch(
                        items[c : c + self.max_dispatch_batch],
                        run_hooks=run_hooks,
                    )
                )
            return out
        results: list[AdmissionResponse | Exception | None] = [None] * len(items)
        targets: list[Any] = [None] * len(items)
        encodable: dict[int, list[int]] = {}
        encoded: dict[int, list[dict[str, np.ndarray]]] = {}
        for i, (policy_id, request) in enumerate(items):
            try:
                target = self._lookup_top_level(PolicyID.parse(policy_id))
                targets[i] = target
                payload = self.payload_for(target, request)
                if run_hooks and pre_eval_hooks_of(target):
                    self._run_pre_eval_hooks(target, payload)
                    # rebuild: providers must observe hook results
                    payload = self.payload_for(target, request)
                if self.backend == "oracle":
                    results[i] = self._materialize(
                        target, request, self._oracle_outputs(payload)
                    )
                    continue
                bucket_idx, enc = self.encode_bucketed(payload)
                encodable.setdefault(bucket_idx, []).append(i)
                encoded.setdefault(bucket_idx, []).append(enc)
            except SchemaOverflow:
                with self._lock:
                    self._oracle_fallbacks += 1
                results[i] = self._materialize(
                    target, request, self._oracle_outputs(payload)
                )
            except Exception as e:  # noqa: BLE001 — per-item error channel
                results[i] = e
        for bucket_idx, indices in encodable.items():
            bucket = bucket_size(len(indices))
            schema = self.schemas[bucket_idx]
            batch = schema.pack(
                schema.stack(encoded[bucket_idx], batch_size=bucket)
            )
            outputs = self.run_batch(batch)
            for row, i in enumerate(indices):
                results[i] = self._materialize(
                    targets[i], items[i][1], _RowView(outputs, row)
                )
        return results  # type: ignore[return-value]

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
        payload_of: Callable[[], Any],
        outputs: Mapping[str, Any],
    ) -> AdmissionResponse:
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
        payload_of: Callable[[], Any],
        outputs: Mapping[str, Any],
    ) -> AdmissionResponse:
        allowed_key, members, risky = self._group_mat[group.name]
        allowed = bool(outputs[allowed_key])
        # group-member mutation ban: an evaluated, allowed member that
        # would mutate rejects the whole group
        for _m, _bp, eval_key, allowed_key_m, _rule_key, mutator in risky:
            if not (
                bool(outputs.get(eval_key, False)) and bool(outputs[allowed_key_m])
            ):
                continue
            if mutator(payload_of()):
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
        for member_name, bp, eval_key, allowed_key_m, rule_key, _mut in members:
            if bool(outputs.get(eval_key, False)) and not bool(
                outputs[allowed_key_m]
            ):
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
