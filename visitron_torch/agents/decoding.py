"""Action selection for rollouts (visitron_tpu/agents/decoding.py).

Ported: ``teacher`` and ``argmax``.  The sampling strategies (sample, topk,
nucleus, temperature, penalty) are not ported yet and raise.
"""

from __future__ import annotations

import torch

FEEDBACK_OPTIONS = (
    "teacher", "argmax", "sample", "topk", "nucleus", "temperature", "penalty",
)


def select_action(feedback: str, logit: torch.Tensor, target=None) -> torch.Tensor:
    """Select the next action per batch row (first maximum on ties)."""
    if feedback == "teacher":
        if target is None:
            raise ValueError("teacher feedback needs a target")
        return target
    if feedback == "argmax":
        return torch.argmax(logit.float(), dim=-1)
    if feedback in FEEDBACK_OPTIONS:
        raise NotImplementedError(f"feedback {feedback!r} is not ported yet")
    raise ValueError(f"invalid feedback option {feedback!r}")
