"""Mask utilities shared by models and agents (visitron_tpu/ops/masking.py)."""

from __future__ import annotations

import torch

NEG_INF = -1e9  # large-negative bias; reference uses -10000.0 (encoder.py:241)


def length2mask(lengths: torch.Tensor, size: int) -> torch.Tensor:
    """Boolean (B, size) mask that is True at PADDED positions.

    Parity: tasks/viewpoint_select/utils.py:340-347 (True == masked).
    """
    ar = torch.arange(size, device=lengths.device, dtype=lengths.dtype)
    return ar[None, :] > (lengths - 1)[:, None]


def make_attention_bias(attention_mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(B, K) 1/0 keep-mask -> (B, 1, 1, K) additive bias (0 keep, -1e9 drop).

    Parity with the reference extended attention mask (encoder.py:226-241),
    with -1e9 instead of -10000 for bf16 safety.
    """
    m = attention_mask
    if m.ndim == 2:
        m = m[:, None, None, :]
    elif m.ndim == 3:
        m = m[:, None, :, :]
    else:
        raise ValueError(f"attention_mask must be 2-D or 3-D, got {m.ndim}-D")
    return ((1.0 - m.to(dtype)) * NEG_INF).to(dtype)
