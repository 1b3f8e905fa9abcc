"""CEL execution mode (SURVEY.md §2.2 PolicyExecutionMode::Cel).

Parser → IR lowering (device fast path) → host interpreter (fallback);
policy module in cel/policy.py, registered as ``builtin://cel-policy``.
"""

from policy_server_tpu_torch.cel.interp import CelEvalError, evaluate
from policy_server_tpu_torch.cel.lower import CelLoweringError, lower
from policy_server_tpu_torch.cel.parser import CelParseError, parse
from policy_server_tpu_torch.cel.policy import CelPolicy

__all__ = [
    "CelEvalError",
    "CelLoweringError",
    "CelParseError",
    "CelPolicy",
    "evaluate",
    "lower",
    "parse",
]
