"""Request evaluation service — policy-server semantics around the raw
verdict.

* ``pre_evaluate``: policy-id parse and the always-accept-namespace
  short-circuit;
* policy-initialization errors become in-band 500 rejections;
* ``post_evaluate``: mode and mutation constraints apply for the Validate
  origin but not for Audit — protect mode strips the patch of a policy not
  allowed to mutate and rejects; monitor mode always accepts, dropping
  patch and status.

``evaluate`` is the synchronous single-request path; the micro-batcher
(runtime/batcher.py) runs the same halves around one batched dispatch.
"""

from __future__ import annotations

import enum
import logging
from typing import Any

from policy_server_tpu_torch.evaluation.environment import EvaluationEnvironment
from policy_server_tpu_torch.evaluation.errors import PolicyInitializationError
from policy_server_tpu_torch.evaluation.policy_id import PolicyID
from policy_server_tpu_torch.models import (
    AdmissionResponse,
    ValidateRequest,
    ValidationStatus,
)
from policy_server_tpu_torch.models.policy import PolicyMode

logger = logging.getLogger("kubewarden-policy-server")


class RequestOrigin(str, enum.Enum):
    """Validate applies the mode and mutation constraints; Audit reports
    the raw verdict."""

    VALIDATE = "validate"
    AUDIT = "audit"

    def __str__(self) -> str:
        return self.value


def pre_evaluate(
    env: EvaluationEnvironment,
    policy_id: str,
    request: ValidateRequest,
) -> AdmissionResponse | None:
    """Returns a final response, or None to proceed to evaluation. Raises
    EvaluationError for invalid ids."""
    PolicyID.parse(policy_id)
    if not request.is_raw:
        ns = request.admission_request.namespace
        if ns and env.should_always_accept_requests_made_inside_of_namespace(ns):
            return AdmissionResponse(uid=request.uid(), allowed=True)
    return None


def handle_initialization_error(
    request: ValidateRequest, error: PolicyInitializationError
) -> AdmissionResponse:
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
    origin: RequestOrigin,
    vanilla: AdmissionResponse,
) -> AdmissionResponse:
    if origin is RequestOrigin.VALIDATE:
        return validation_response_with_constraints(
            policy_id,
            env.get_policy_mode(policy_id),
            env.get_policy_allowed_to_mutate(policy_id),
            vanilla,
        )
    return vanilla


def evaluate(
    env: EvaluationEnvironment,
    policy_id: str,
    request: ValidateRequest,
    origin: RequestOrigin,
) -> AdmissionResponse:
    """Synchronous single-request evaluation. Raises EvaluationError for
    invalid or unknown policy ids."""
    short = pre_evaluate(env, policy_id, request)
    if short is not None:
        return short
    try:
        vanilla = env.validate(policy_id, request)
    except PolicyInitializationError as e:
        return handle_initialization_error(request, e)
    return post_evaluate(env, policy_id, origin, vanilla)
