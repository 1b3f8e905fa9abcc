"""Observability: metrics (a Prometheus pull endpoint), structured logs
and request spans, and the flight recorder (``flightrec``)."""

from policy_server_tpu_torch.telemetry.metrics import (
    EVALUATIONS_TOTAL,
    INIT_ERRORS_TOTAL,
    LATENCY_MILLISECONDS,
    MetricsRegistry,
    PolicyEvaluation,
    PolicyInitializationError,
    RawPolicyEvaluation,
    add_policy_evaluation,
    add_policy_initialization_error,
    default_registry,
    record_policy_latency,
    reset_metrics_for_tests,
    setup_metrics,
)
from policy_server_tpu_torch.telemetry.tracing import (
    SERVICE_NAME,
    setup_tracing,
    span,
)

__all__ = [
    "EVALUATIONS_TOTAL",
    "INIT_ERRORS_TOTAL",
    "LATENCY_MILLISECONDS",
    "MetricsRegistry",
    "PolicyEvaluation",
    "PolicyInitializationError",
    "RawPolicyEvaluation",
    "SERVICE_NAME",
    "add_policy_evaluation",
    "add_policy_initialization_error",
    "default_registry",
    "record_policy_latency",
    "reset_metrics_for_tests",
    "setup_metrics",
    "setup_tracing",
    "span",
]
