"""Initial weights made from the seed on the device, in a few large calls.

The rule follows the published initialisers: BERT's matrices and embedding
tables N(0, 0.02) (``initializer_range``), LSTM weights and biases
U(-1/sqrt(H), 1/sqrt(H)), every other matrix N(0, 1/fan_in) (lecun normal
without the truncation), LayerNorm scales one, every other bias zero.  The
program and the reference are handed the same tensors: the reference draws
them again from the same seed, which gives the same bits on the same device.
"""

from __future__ import annotations

import math

import torch

BERT_STD = 0.02
BERT_PARTS = ("bert.", "mlm_transform.", "next_action.", "token_head.")


def rule(name: str, shape: tuple):
    """("normal", std) | ("uniform", bound) | ("const", value) for one leaf
    (``name`` may carry a "part/" prefix)."""
    name = name.split("/")[-1]
    leaf = name.rsplit(".", 1)[-1]
    if "layer_norm" in name:
        return ("const", 1.0 if leaf == "weight" else 0.0)
    if ".lstm." in f".{name}" and leaf in ("wi", "wh", "bi", "bh"):
        return ("uniform", 1.0 / math.sqrt(shape[0] // 4))
    if len(shape) == 1:
        return ("const", 0.0)
    if name.startswith(BERT_PARTS):
        return ("normal", BERT_STD)
    return ("normal", 1.0 / math.sqrt(shape[1]))


def make(shapes: dict, seed: int, device) -> dict:
    """{name: fp32 tensor of shapes[name]} drawn by :func:`rule` from one
    normal and one uniform call on ``device``."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    kinds = {name: rule(name, tuple(shape)) for name, shape in shapes.items()}
    sizes = {name: math.prod(shape) for name, shape in shapes.items()}
    out = {}
    for kind, draw in (("normal", torch.randn), ("uniform", torch.rand)):
        names = [n for n in shapes if kinds[n][0] == kind]
        buf = draw(sum(sizes[n] for n in names), generator=g, device=device)
        at = 0
        for n in names:
            view = buf[at:at + sizes[n]].view(tuple(shapes[n]))
            at += sizes[n]
            scale = kinds[n][1]
            out[n] = view.mul_(scale) if kind == "normal" else view.mul_(2 * scale).sub_(scale)
    for n in shapes:
        if kinds[n][0] == "const":
            out[n] = torch.full(tuple(shapes[n]), kinds[n][1], device=device)
    return {n: out[n] for n in shapes}


def nested(flat: dict) -> dict:
    """{"part/name": t} -> {"part": {"name": t}}."""
    out: dict = {}
    for key, t in flat.items():
        part, name = key.split("/", 1)
        out.setdefault(part, {})[name] = t
    return out


def flatten(tree: dict) -> dict:
    """The inverse of :func:`nested` for a two-level tree; a flat tree as it is."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update({f"{key}/{k}": v for k, v in value.items()})
        else:
            out[key] = value
    return out
