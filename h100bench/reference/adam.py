"""The configurations' optimizer in plain PyTorch: clip the gradients to a
global norm (scaled by max_norm / norm only where the norm reaches
max_norm), then Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments),
decoupled weight decay, and the learning rate, constant or of a linear schedule read
at the step count before the step (:func:`lr_at`).  Float32 on
every leaf of a flat {name: tensor} dict.
"""

from __future__ import annotations

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def clip(grads: dict, max_norm: float) -> dict:
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
    factor = 1.0 if float(norm) < max_norm else max_norm / float(norm)
    return {k: g * factor for k, g in grads.items()}


def lr_at(opt: dict, count: int) -> float:
    """The rate of the step taken at ``count``: constant without a
    ``schedule``; "linear": from 0 over max(warmup_steps, 1) counts, then
    down to 0 over total_steps - warmup_steps."""
    lr = opt["learning_rate"]
    if opt.get("schedule") is None:
        return lr
    warmup = opt.get("warmup_steps", 0)
    warm = max(warmup, 1)
    if count < warm:
        return lr * count / warm
    return lr * max(0.0, 1.0 - (count - warm) / max(opt["total_steps"] - warmup, 1))


class Adam:
    def __init__(self, params: dict, opt: dict):
        self.opt, self.count = opt, 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict) -> tuple:
        """(new params, the clipped gradients)."""
        g = clip(grads, self.opt["max_grad_norm"])
        lr = lr_at(self.opt, self.count)
        self.count += 1
        c1, c2 = 1.0 - B1 ** self.count, 1.0 - B2 ** self.count
        wd = self.opt.get("weight_decay", 0.0)
        out = {}
        for k, p in params.items():
            self.mu[k] = B1 * self.mu[k] + (1 - B1) * g[k]
            self.nu[k] = B2 * self.nu[k] + (1 - B2) * g[k] * g[k]
            upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + EPS) + wd * p
            out[k] = p - lr * upd
        return out, g
