"""Action selection (feedback) strategies for rollouts
(visitron_tpu/agents/decoding.py; reference next_decoder_input,
tasks/viewpoint_select/utils.py:381-427).

teacher / argmax / sample, and the extended strategies: temperature,
topk (k 3), the nucleus-style mixture (with probability p a uniform draw
over all K+1 slots, masked ones included, else a categorical draw) and
penalty (the logits of actions already taken multiplied back by the
temperature).  Every categorical draw goes through :func:`categorical`, a
Gumbel-max draw on the logits' device from an explicit ``torch.Generator``
that reads nothing back to the host (``torch.multinomial`` checks its
probabilities with a read-back, a synchronisation on CUDA).  torch cannot reproduce JAX's random
streams, so the strategies match the JAX package in distribution only;
``teacher`` and ``argmax`` match it exactly.
"""

from __future__ import annotations

import torch

FEEDBACK_OPTIONS = (
    "teacher", "argmax", "sample", "topk", "nucleus", "temperature", "penalty",
)


def categorical(logit: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """One index per row drawn from softmax(logit) (fp32 logits (B, A)):
    argmax of logit + Gumbel noise, the noise from ``generator`` on the
    logits' device (None: torch's default generator there)."""
    u = torch.rand(logit.shape, generator=generator, device=logit.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logit + gumbel, dim=-1)


def select_action(feedback: str, logit: torch.Tensor,
                  generator: torch.Generator | None = None, target=None,
                  temperature: float = 1.0, taken_mask=None, topk: int = 3,
                  nucleus_p: float = 0.4) -> torch.Tensor:
    """The next action per batch row, (B,) int64.  ``logit``: (B, A) masked
    logits; ``target``: the teacher's actions (``teacher``); ``taken_mask``:
    (B, A) bool of actions already taken (``penalty``)."""
    if feedback not in FEEDBACK_OPTIONS:
        raise ValueError(f"invalid feedback option {feedback!r}")
    logit = logit.float()
    if feedback in ("temperature", "penalty"):
        logit = logit / temperature
    if feedback == "penalty" and taken_mask is not None:
        # utils.py:390-396: the taken actions' logits times the temperature.
        logit = torch.where(taken_mask, logit * temperature, logit)
    if feedback == "teacher":
        if target is None:
            raise ValueError("teacher feedback needs a target")
        return target
    if feedback == "argmax":
        return torch.argmax(logit, dim=-1)  # first maximum on ties, as jnp.argmax
    if feedback in ("sample", "temperature", "penalty"):
        return categorical(logit, generator)
    if feedback == "topk":
        vals, idx = torch.topk(logit, topk, dim=-1)
        return torch.gather(idx, 1, categorical(vals, generator)[:, None])[:, 0]
    # nucleus (utils.py:413-424): with probability p a uniform draw over all
    # slots, masked ones included (a masked slot then acts as stop).
    b, a = logit.shape
    flip = torch.rand(b, generator=generator, device=logit.device) < nucleus_p
    uniform = torch.randint(0, a, (b,), generator=generator, device=logit.device)
    return torch.where(flip, uniform, categorical(logit, generator))
