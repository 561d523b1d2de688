"""The numbers that decide ``correct``: each a reading of the program's
output against the reference's, held to a limit from the cell's file.

Training (the first three steps of the object the window drives): the
loss of each step, the first gradient as the optimizer got it, and the
parameters' change after the three steps.  Gradients and changes are taken
by the worst leaf: the gap between the program's norm of a leaf and the
reference's, over the reference's norm of that leaf or of the median leaf,
whichever is larger.  The change leaves out the leaves whose reference
gradient is under a thousandth of the median leaf's (they move by round-off
alone under Adam).

Serving (argmax evaluation): for each sampled episode and step, how far the
reference's logit of the action the program took lies below the
reference's best; the widest gap counts.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SKIP_BELOW = 1e-3


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def _worst(prog: dict, ref: dict, keys) -> float:
    r = _norms({k: ref[k] for k in keys})
    p = _norms({k: prog[k] for k in keys})
    med = float(np.median(list(r.values())))
    return max(abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in keys)


def training(prog_losses, ref_losses, prog_grad: dict, ref_grad: dict,
             prog_change: dict, ref_change: dict) -> dict:
    """{"loss_gap", "grad_gap", "change_gap"} of the first three steps, and
    "leaves_left_out" of the change."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog_losses, ref_losses))
    if not all(math.isfinite(p) for p in prog_losses):
        loss_gap = math.inf
    g = _norms(ref_grad)
    med = float(np.median(list(g.values())))
    moving = [k for k in ref_grad if g[k] >= SKIP_BELOW * med]
    return {"loss_gap": loss_gap,
            "grad_gap": _worst(prog_grad, ref_grad, list(ref_grad)),
            "change_gap": _worst(prog_change, ref_change, moving),
            "leaves_left_out": len(ref_grad) - len(moving)}


def served(records) -> dict:
    """{"logit_gap", "bad_actions"} over (logits, served slot) records: the
    widest gap of a served action's logit below the best, and the actions
    that name no candidate (counted, and the gap then infinite)."""
    worst, bad = 0.0, 0
    for logits, slot in records:
        if slot < 0 or slot >= len(logits):
            bad += 1
            continue
        worst = max(worst, float(np.max(logits) - logits[slot]))
    return {"logit_gap": math.inf if bad else worst, "bad_actions": bad}


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every reading within its limit."""
    rows = [(k, readings[k], limits[k]) for k in limits]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
