"""Request evaluation service — policy-server semantics around the raw
verdict.

* ``pre_evaluate``: policy-id parse and the always-accept-namespace
  short-circuit (counted as an accepted evaluation);
* policy-initialization errors become in-band 500 rejections and count in
  ``kubewarden_policy_initialization_errors_total``;
* ``post_evaluate``: mode and mutation constraints apply for the Validate
  origin but not for Audit — protect mode strips the patch of a policy not
  allowed to mutate and rejects; monitor mode always accepts, dropping
  patch and status. A ``FragVerdict`` (a verdict-cache hit answered from a
  pre-built template) passes unchanged: its eligibility — protect mode, no
  mutator, static messages — makes the constraints the identity on it.
  The evaluation metric records the VANILLA verdict, before constraints,
  with the latency from ``start_time`` (the request's enqueue): one
  ``PolicyEvaluation`` (or ``RawPolicyEvaluation``) per answered request.

``evaluate`` is the synchronous single-request path; the micro-batcher
(runtime/batcher.py) runs the same halves around one batched dispatch and
flushes a batch's metrics in one ``record_evaluations_batch`` call
(``metrics_sink``).
"""

from __future__ import annotations

import enum
import logging
import time
from typing import Any

from policy_server_tpu_torch.evaluation.environment import EvaluationEnvironment
from policy_server_tpu_torch.evaluation.errors import PolicyInitializationError
from policy_server_tpu_torch.evaluation.policy_id import PolicyID
from policy_server_tpu_torch.models import (
    AdmissionResponse,
    ValidateRequest,
    ValidationStatus,
)
from policy_server_tpu_torch.models.admission import FragVerdict
from policy_server_tpu_torch.models.policy import PolicyMode
from policy_server_tpu_torch.telemetry import metrics as metrics_mod

logger = logging.getLogger("kubewarden-policy-server")


class RequestOrigin(str, enum.Enum):
    """Validate applies the mode and mutation constraints; Audit reports
    the raw verdict."""

    VALIDATE = "validate"
    AUDIT = "audit"

    def __str__(self) -> str:
        return self.value


def _registry() -> metrics_mod.MetricsRegistry:
    return metrics_mod.default_registry()


def evaluation_metric(
    env: EvaluationEnvironment,
    policy_id: str,
    request: ValidateRequest,
    origin: RequestOrigin,
    accepted: bool,
    mutated: bool,
    error_code: int | None,
) -> metrics_mod.PolicyEvaluation | metrics_mod.RawPolicyEvaluation:
    mode = env.get_policy_mode(policy_id).value
    if request.is_raw:
        return metrics_mod.RawPolicyEvaluation(
            policy_name=policy_id,
            policy_mode=mode,
            accepted=accepted,
            mutated=mutated,
            error_code=error_code,
        )
    adm = request.admission_request
    return metrics_mod.PolicyEvaluation(
        policy_name=policy_id,
        policy_mode=mode,
        resource_kind=adm.request_kind.kind if adm.request_kind else "",
        resource_namespace=adm.namespace,
        resource_request_operation=adm.operation or "",
        accepted=accepted,
        mutated=mutated,
        request_origin=str(origin),
        error_code=error_code,
    )


def pre_evaluate(
    env: EvaluationEnvironment,
    policy_id: str,
    request: ValidateRequest,
    origin: RequestOrigin,
    start_time: float,
) -> AdmissionResponse | None:
    """Returns a final response, or None to proceed to evaluation. Raises
    EvaluationError for invalid ids."""
    PolicyID.parse(policy_id)
    if not request.is_raw:
        ns = request.admission_request.namespace
        if ns and env.should_always_accept_requests_made_inside_of_namespace(ns):
            m = evaluation_metric(
                env, policy_id, request, origin,
                accepted=True, mutated=False, error_code=None,
            )
            reg = _registry()
            reg.record_policy_latency((time.perf_counter() - start_time) * 1e3, m)
            reg.add_policy_evaluation(m)
            return AdmissionResponse(uid=request.uid(), allowed=True)
    return None


def handle_initialization_error(
    request: ValidateRequest, error: PolicyInitializationError
) -> AdmissionResponse:
    """The in-band 500 rejection of a request that reached a policy which
    failed to initialize (``--continue-on-errors``), counted."""
    _registry().add_policy_initialization_error(
        metrics_mod.PolicyInitializationError(
            policy_name=error.policy_id, initialization_error=str(error)
        )
    )
    return AdmissionResponse.reject(request.uid(), str(error), 500)


def validation_response_with_constraints(
    policy_id: str,
    policy_mode: PolicyMode,
    allowed_to_mutate: bool,
    response: AdmissionResponse,
) -> AdmissionResponse:
    if policy_mode is PolicyMode.PROTECT:
        if response.patch is not None and not allowed_to_mutate:
            out = response.copy()
            out.allowed = False
            out.status = _mutation_denied_status(policy_id)
            # validating webhooks must not carry a patch
            out.patch = None
            out.patch_type = None
            return out
        return response
    logger.info(
        "policy evaluation (monitor mode): policy_id=%s allowed_to_mutate=%s "
        "response=%r",
        policy_id, allowed_to_mutate, response.to_dict(),
    )
    out = response.copy()
    out.allowed = True
    out.patch = None
    out.patch_type = None
    out.status = None
    return out


def _mutation_denied_status(policy_id: str) -> Any:
    return ValidationStatus(
        message=(
            f"Request rejected by policy {policy_id}. The policy attempted to "
            "mutate the request, but it is currently configured to not allow "
            "mutations."
        ),
        code=None,
    )


def post_evaluate(
    env: EvaluationEnvironment,
    policy_id: str,
    request: ValidateRequest,
    origin: RequestOrigin,
    vanilla: AdmissionResponse | FragVerdict,
    start_time: float,
    metrics_sink: list | None = None,
    now: float | None = None,
) -> AdmissionResponse | FragVerdict:
    """Constraints and the evaluation metric. ``metrics_sink`` (the
    batcher's phase 3) collects ``(latency_ms, metric)`` pairs for one
    ``record_evaluations_batch`` flush; ``now`` shares one clock read
    across a batch."""
    if type(vanilla) is FragVerdict:
        tmpl = vanilla.tmpl
        accepted, mutated, error_code = tmpl.allowed, False, tmpl.code
        response = vanilla
    else:
        accepted = vanilla.allowed
        mutated = vanilla.patch is not None
        error_code = vanilla.status.code if vanilla.status else None
        response = (
            validation_response_with_constraints(
                policy_id,
                env.get_policy_mode(policy_id),
                env.get_policy_allowed_to_mutate(policy_id),
                vanilla,
            )
            if origin is RequestOrigin.VALIDATE
            else vanilla
        )
    m = evaluation_metric(
        env, policy_id, request, origin,
        accepted=accepted, mutated=mutated, error_code=error_code,
    )
    latency_ms = ((time.perf_counter() if now is None else now) - start_time) * 1e3
    if metrics_sink is not None:
        metrics_sink.append((latency_ms, m))
    else:
        reg = _registry()
        reg.record_policy_latency(latency_ms, m)
        reg.add_policy_evaluation(m)
    return response


def evaluate(
    env: EvaluationEnvironment,
    policy_id: str,
    request: ValidateRequest,
    origin: RequestOrigin,
) -> AdmissionResponse:
    """Synchronous single-request evaluation. Raises EvaluationError for
    invalid or unknown policy ids."""
    start = time.perf_counter()
    short = pre_evaluate(env, policy_id, request, origin, start)
    if short is not None:
        return short
    try:
        vanilla = env.validate(policy_id, request)
    except PolicyInitializationError as e:
        return handle_initialization_error(request, e)
    return post_evaluate(env, policy_id, request, origin, vanilla, start)
