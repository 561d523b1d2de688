"""Carry parameters of the JAX package's agent and pretraining model into
the port.

The JAX ``ViewpointAgent`` keeps ``{"encoder": {"params": ...}, "decoder":
{"params": ...}}`` flax trees (and ``"critic"`` for RL), the
``PretrainTrainer`` one ``PretrainModel`` tree.  The port's modules use the same names, so a flax path maps to a
state-dict key by joining it with dots, with these leaf renames:

  Dense ``kernel`` (in, out)      -> ``weight`` (out, in), transposed
  LayerNorm ``scale`` / ``bias``  -> ``weight`` / ``bias``
  Embed ``embedding``             -> ``weight``
  LSTM ``wi/wh/bi/bh``            -> the same (already in torch layout)
  ``mlm_bias`` (PretrainModel)    -> the same

The trees arrive as numpy arrays (``np.asarray`` of each leaf); nothing here
imports JAX.  A key missing on either side, or a shape that differs, raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_RENAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
            "bias": "bias", "wi": "wi", "wh": "wh", "bi": "bi", "bh": "bh",
            "mlm_bias": "mlm_bias"}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict):
            yield from _flatten(value, path)
        else:
            yield path, value


def flax_to_state_dict(tree: dict, module: nn.Module, device=None) -> dict:
    """{state-dict key: tensor} for ``module`` from one flax parameter tree
    (with or without its top-level ``"params"`` collection)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    expected = {k: v for k, v in module.state_dict().items()}
    out = {}
    for path, leaf in _flatten(tree):
        if path[-1] not in _RENAMES:
            raise KeyError(f"unknown flax parameter leaf {'/'.join(path)}")
        name = ".".join(path[:-1] + (_RENAMES[path[-1]],))
        arr = np.asarray(leaf)
        if path[-1] == "kernel":
            arr = arr.T
        if name not in expected:
            raise KeyError(f"flax parameter {'/'.join(path)} has no counterpart "
                           f"{name!r} in {type(module).__name__}")
        if tuple(arr.shape) != tuple(expected[name].shape):
            raise ValueError(f"{name}: flax shape {arr.shape} != port shape "
                             f"{tuple(expected[name].shape)}")
        out[name] = torch.tensor(np.ascontiguousarray(arr),
                                 dtype=expected[name].dtype, device=device)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"port parameters missing from the flax tree: {missing}")
    return out


def convert_agent_params(jax_params: dict, agent) -> dict:
    """The JAX agent's ``{"encoder", "decoder"}`` parameters, and its RL
    ``"critic"`` where the tree has one, as the port agent's parameters, on
    the agent's device."""
    parts = set(jax_params)
    if not {"encoder", "decoder"} <= parts <= {"encoder", "decoder", "critic"}:
        raise KeyError(f"expected encoder, decoder and optionally critic trees, "
                       f"got {sorted(jax_params)}")
    return {part: flax_to_state_dict(jax_params[part], getattr(agent, part),
                                     agent.device)
            for part in sorted(parts)}


def convert_pretrain_params(jax_params: dict, model: nn.Module, device=None) -> dict:
    """The JAX ``PretrainModel`` parameters (with or without the ``params``
    collection) as the flat parameters of the port's ``PretrainModel``
    (``PretrainTrainer.model``), on ``device``."""
    return flax_to_state_dict(jax_params, model, device)
