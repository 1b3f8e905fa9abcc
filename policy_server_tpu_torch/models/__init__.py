"""Data models: AdmissionReview request/response types and policy configs.

Reference parity: src/api/admission_review.rs, src/api/raw_review.rs and the
``admission_request``/``admission_response`` types of the policy-evaluator
crate (see SURVEY.md §2.2).
"""

from policy_server_tpu_torch.models.admission import (
    AdmissionRequest,
    AdmissionResponse,
    AdmissionReviewRequest,
    AdmissionReviewResponse,
    FragTemplate,
    FragVerdict,
    GroupVersionKind,
    GroupVersionResource,
    RawReviewRequest,
    RawReviewResponse,
    StatusCause,
    StatusDetails,
    ValidationStatus,
    ValidateRequest,
)

__all__ = [
    "AdmissionRequest",
    "AdmissionResponse",
    "AdmissionReviewRequest",
    "AdmissionReviewResponse",
    "FragTemplate",
    "FragVerdict",
    "GroupVersionKind",
    "GroupVersionResource",
    "RawReviewRequest",
    "RawReviewResponse",
    "StatusCause",
    "StatusDetails",
    "ValidationStatus",
    "ValidateRequest",
]
