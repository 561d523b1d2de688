"""Carry parameters of the JAX package's agent, pretraining model and feature
extractors (ResNet, Faster R-CNN) into the port.

The JAX ``ViewpointAgent`` keeps ``{"encoder": {"params": ...}, "decoder":
{"params": ...}}`` flax trees (and ``"critic"`` for RL), the
``PretrainTrainer`` one ``PretrainModel`` tree.  The port's modules use the same names, so a flax path maps to a
state-dict key by joining it with dots, with these leaf renames:

  Dense ``kernel`` (in, out)      -> ``weight`` (out, in), transposed
  LayerNorm ``scale`` / ``bias``  -> ``weight`` / ``bias``
  Embed ``embedding``             -> ``weight``
  LSTM ``wi/wh/bi/bh``            -> the same (already in torch layout)
  ``mlm_bias`` (PretrainModel)    -> the same
  Conv ``kernel`` (H, W, in, out) -> ``weight`` (out, in, H, W)
  FrozenBatchNorm ``scale/bias/mean/var`` -> ``weight/bias/running_mean/
                                     running_var``

and, for the ResNet and Faster R-CNN trees (models/resnet.py,
models/detector.py, whose modules carry torchvision's names), the blocks
``layer{s}_{b}`` -> ``layer{s}.{b}`` and ``downsample_conv`` /
``downsample_bn`` -> ``downsample.0`` / ``downsample.1``.

The trees arrive as numpy arrays (``np.asarray`` of each leaf); nothing here
imports JAX.  A key missing on either side, or a shape that differs, raises.

:func:`convert_opt_state` carries an optax optimizer state across the same
way, so a JAX training state can continue in the port: the chain's states
are namedtuples (``EmptyState``, ``ScaleByAdamState(count, mu, nu)``,
``ScaleByRmsState(nu)``, ``ScaleByScheduleState(count)``, ...), read by
their field names; the port's are dicts with the same keys.  An
``optax.multi_transform`` state (``PartitionState(inner_states={label:
MaskedState(inner_state)})``, the classifier's) becomes the port's
``{"inner_states": {label: state}}``; its moment trees hold ``MaskedNode``
leaves for the other labels' parameters, which carry nothing.

:func:`convert_pipeline_state` carries a JAX ``PipelinePretrainTrainer``
state (``{"rest", "stages"}`` trees, the stages stacked on a leading layer
axis) into the port's pipeline trainer, for one rank's stage block.

The turn-based, classifier and speaker agents keep the viewpoint agent's
``{"encoder", "decoder"}`` layout, so :func:`convert_agent_params` takes
theirs too; the speaker's ``optax.adam`` state (``ScaleByAdamState``, then
the learning rate's ``EmptyState``) converts into its
``chain(scale_by_adam(), scale_by_learning_rate(lr))``.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

_RENAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
            "bias": "bias", "wi": "wi", "wh": "wh", "bi": "bi", "bh": "bh",
            "mlm_bias": "mlm_bias", "mean": "running_mean", "var": "running_var"}
_SEGMENTS = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}
_BLOCK = re.compile(r"layer(\d+)_(\d+)")


def _segment(name: str) -> str:
    """A flax module name as the port's (torchvision's, for ResNet blocks)."""
    m = _BLOCK.fullmatch(name)
    return f"layer{m[1]}.{m[2]}" if m else _SEGMENTS.get(name, name)


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
    return _flax_to_named(tree, dict(module.state_dict()), type(module).__name__, device)


def _float_array(leaf) -> np.ndarray:
    """A numpy leaf as an array torch can take: bfloat16 (ml_dtypes) through
    float32, which holds every bf16 value exactly."""
    arr = np.asarray(leaf)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def _flax_to_named(tree: dict, expected: dict, owner: str, device=None) -> dict:
    """{name: tensor} in ``expected``'s names, shapes and dtypes from one
    flax tree."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for path, leaf in _flatten(tree):
        if path[-1] not in _RENAMES:
            raise KeyError(f"unknown flax parameter leaf {'/'.join(path)}")
        name = ".".join(tuple(map(_segment, path[:-1])) + (_RENAMES[path[-1]],))
        arr = _float_array(leaf)
        if path[-1] == "kernel":
            # A Dense kernel's last two axes swap (a pipeline's stacked
            # layers keep their leading L axis first).
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else np.swapaxes(arr, -1, -2)
        if name not in expected:
            raise KeyError(f"flax parameter {'/'.join(path)} has no counterpart "
                           f"{name!r} in {owner}")
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
    the agent's device (any agent of the port with those modules: the
    viewpoint, turn-based, classifier and speaker agents)."""
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


def convert_pipeline_state(jax_state: dict, trainer) -> dict:
    """A JAX ``PipelinePretrainTrainer`` state (``{"params": {"rest",
    "stages"}, "opt_state"}`` as numpy, the stages' every layer) as this
    rank's state of the port's ``parallel.pipeline.PipelinePretrainTrainer``
    ``trainer``: the parameters in the port's ``{"rest", "stages"}`` layout
    (the stacked kernels transposed on their last two axes), the optimizer
    state through :func:`convert_opt_state`, both cut to this rank's stage
    block; ``rng`` the trainer's dropout generators."""
    from visitron_torch.parallel.pipeline import (map_stage_moments, split_pretrain_params,
                                                  stage_block)

    rest, stages = split_pretrain_params(dict(trainer.model.named_parameters()))
    jax_params = jax_state["params"]
    full = {"rest": _flax_to_named(jax_params["rest"], rest, "the pipeline's rest",
                                   trainer.device),
            "stages": _flax_to_named(jax_params["stages"], stages, "the pipeline's stages",
                                     trainer.device)}
    opt_state = convert_opt_state(jax_state["opt_state"], trainer.optimizer, full)
    opt_state = map_stage_moments(opt_state, full, lambda s: stage_block(s, trainer.mesh))
    return {"params": {"rest": full["rest"], "stages": stage_block(full["stages"],
                                                                   trainer.mesh)},
            "opt_state": opt_state, "rng": trainer.dropout_rng()}


def _drop_masked(tree):
    """``tree`` without optax's ``MaskedNode`` leaves (the parameters of
    another label of a multi_transform) and the sub-trees left empty."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            value = _drop_masked(value)
            if value:
                out[key] = value
        elif type(value).__name__ != "MaskedNode":
            out[key] = value
    return out


def _tree_like(jax_tree, like, device):
    """A flax-layout tree (a moment of the agent's or the pretraining
    model's parameters) in the layout of the port's ``like``: a flat
    {name: tensor} dict is one module's, a dict of dicts one per part."""
    jax_tree = _drop_masked(jax_tree)
    if all(isinstance(v, torch.Tensor) for v in like.values()):
        return _flax_to_named(jax_tree, like, "the port's parameters", device)
    if set(jax_tree) != set(like):
        raise KeyError(f"optimizer state parts {sorted(jax_tree)} != port parts {sorted(like)}")
    return {k: _tree_like(jax_tree[k], like[k], device) for k in like}


def _states(node) -> list:
    """The optax states of a chain in order: namedtuples (their own
    ``_fields``) found by walking the nested tuples."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [node]
    if isinstance(node, (tuple, list)):
        return [s for child in node for s in _states(child)]
    raise TypeError(f"unexpected optimizer state node {type(node).__name__}")


def convert_opt_state(jax_opt_state, optimizer, params):
    """The JAX optimizer state of a ``visitron_tpu.train.optim`` chain
    (``agent_optimizer`` or ``adamw_with_warmup``; numpy leaves), or of an
    ``optax.multi_transform`` over such chains, as the port ``optimizer``'s
    state for ``params`` (the port's parameters, which give the names,
    devices and, with the port's initial state, the moments' dtypes).

    The states that hold something are matched in order, each by its field
    names: ``count`` becomes an int, ``mu`` / ``nu`` trees of the port's
    layout (kernels transposed as for the parameters).  States with no
    fields (the clip, a constant learning rate, a zero weight decay) carry
    nothing.  A state or leaf that finds no place raises."""
    return _convert_states(jax_opt_state, optimizer.init(params))


def _convert_states(jax_state, template):
    """``jax_state`` in the port's ``template`` state: a chain's list of
    dicts, one transformation's dict, or multi_transform's
    ``{"inner_states": ...}``."""
    if hasattr(jax_state, "inner_states"):  # optax.multi_transform
        inner = jax_state.inner_states
        ours = template.get("inner_states") if isinstance(template, dict) else None
        if ours is None or set(inner) != set(ours):
            raise KeyError(f"the JAX multi_transform has labels {sorted(inner)}, the "
                           f"port's optimizer {sorted(ours or {})}")
        return {"inner_states": {k: _convert_states(inner[k].inner_state, ours[k])
                                 for k in inner}}
    single = isinstance(template, dict)
    slots = [template] if single else list(template)
    jax_states = [s for s in _states(jax_state) if s._fields]
    port_slots = [i for i, s in enumerate(slots) if s]
    if len(jax_states) != len(port_slots):
        raise ValueError(
            f"the JAX chain holds {[type(s).__name__ for s in jax_states]}, the port's "
            f"{[sorted(slots[i]) for i in port_slots]}")
    out = list(slots)
    for state, slot in zip(jax_states, port_slots):
        fields, want = set(state._fields), set(slots[slot])
        if fields != want:
            raise KeyError(f"{type(state).__name__} fields {sorted(fields)} do not match "
                           f"the port state's {sorted(want)}")
        new = {}
        for name in state._fields:
            value, like = getattr(state, name), slots[slot][name]
            if name == "count":
                new[name] = int(np.asarray(value))
            else:
                device = _first_leaf(like).device
                new[name] = _tree_like(value, like, device)
        out[slot] = new
    return out[0] if single else out


def _first_leaf(tree) -> torch.Tensor:
    """The first tensor of a nested dict (its device is the tree's)."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree
