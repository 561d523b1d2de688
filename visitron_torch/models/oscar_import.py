"""Initialise BERT weights from published Oscar / HuggingFace checkpoints or
from the port's own pretraining checkpoints
(visitron_tpu/models/oscar_import.py).

Two sources feed the dialog encoder's BERT at the start of a fine-tune
(reference train.py:40 + agent.py:110-117, model_utils.py:36-111):

  * a torch ``pytorch_model.bin`` in the HF / pytorch_transformers layout
    (the published Oscar weights): :func:`graft_bert_into_encoder`, or
    :func:`load_oscar_weights` for a whole ``PretrainModel``.  The
    converters (:func:`convert_bert_state_dict`,
    :func:`convert_pretrain_state_dict`) map HF names to the port's: the
    per-layer query / key / value projections become one QKV projection
    whose rows are [q; k; v] (the flax kernel's column order, transposed),
    and the embedding tables are resized to the model's sizes by
    :func:`resize_rows` (+3 special tokens, 4 token types, longer
    position tables), whose new rows are numpy draws from
    ``np.random.default_rng(seed)`` in the JAX package's order, so they
    equal its rows bit for bit;
  * one of the port's pretraining outputs (the ablation chain, ``run
    pretrain`` then ``model_name_or_path .../checkpoint-30000``):
    :func:`graft_pretrain_checkpoint_into_encoder`, which reads the
    parameters of ``PretrainModel`` (train/checkpoint.py) as a flat state
    dict whose ``bert.*`` entries are the multimodal BERT; the encoder's
    text BERT sits under ``bert.bert.*``.

:func:`is_pretrain_checkpoint` tells the two apart.  Grafts replace a
tensor wherever a name exists on both sides, keep the target's device and
dtype, and raise when shapes differ; the LSTM and the projections keep
their init.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from visitron_torch.models.bert import BertConfig
from visitron_torch.train.checkpoint import CheckpointManager

PRETRAIN_PREFIX = "bert."  # PretrainModel.bert (VisitronBert)
ENCODER_PREFIX = "bert.bert."  # OscarEncoder.bert (BertTextModel).bert


def load_torch_state_dict(path: str) -> dict:
    """{name: CPU tensor} of ``path`` (a file, or a directory holding
    ``pytorch_model.bin``)."""
    if os.path.isdir(path):
        path = os.path.join(path, "pytorch_model.bin")
    return dict(torch.load(path, map_location="cpu", weights_only=True))


def _strip_prefix(state: dict, prefix: str) -> dict:
    if any(k.startswith(prefix) for k in state):
        return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    return state


def resize_rows(arr: torch.Tensor, new_rows: int, rng: np.random.Generator,
                init_range: float = 0.02) -> torch.Tensor:
    """Grow (or truncate) the leading dim; new rows ~ N(0, init_range)
    drawn by numpy (HF _get_resized_embeddings parity, used via
    model_utils.py:101-109)."""
    old = arr.shape[0]
    if new_rows == old:
        return arr
    if new_rows < old:
        return arr[:new_rows]
    extra = rng.normal(0.0, init_range, (new_rows - old,) + tuple(arr.shape[1:]))
    return torch.cat([arr, torch.from_numpy(extra).to(arr.dtype)], dim=0)


def convert_bert_state_dict(state: dict, cfg: BertConfig, seed: int = 0) -> dict:
    """HF / pytorch_transformers BERT tensors (names without any ``bert.``
    prefix: strip it with ``_strip_prefix`` first) -> {VisitronBert name:
    tensor} (convert_bert_to_flax in the JAX package).  Embedding tables are
    resized to ``cfg``'s sizes; the image projections are taken where the
    checkpoint has them."""
    rng = np.random.default_rng(seed)
    g = state.__getitem__
    p = {
        "word_embeddings.weight": resize_rows(
            g("embeddings.word_embeddings.weight"), cfg.vocab_size, rng,
            cfg.initializer_range),
        "embeddings.position_embeddings.weight": resize_rows(
            g("embeddings.position_embeddings.weight"), cfg.max_position_embeddings,
            rng, cfg.initializer_range),
        "embeddings.token_type_embeddings.weight": resize_rows(
            g("embeddings.token_type_embeddings.weight"), cfg.type_vocab_size, rng,
            cfg.initializer_range),
        "embeddings.layer_norm.weight": g("embeddings.LayerNorm.weight"),
        "embeddings.layer_norm.bias": g("embeddings.LayerNorm.bias"),
        "pooler.dense.weight": g("pooler.dense.weight"),
        "pooler.dense.bias": g("pooler.dense.bias"),
    }
    for i in range(cfg.num_hidden_layers):
        src, dst = f"encoder.layer.{i}.", f"encoder.layer_{i}."
        for part in ("weight", "bias"):
            # One QKV projection, output rows [q; k; v]: the attention reads
            # q, k and v as its three column blocks.
            p[dst + f"attention.qkv.{part}"] = torch.cat(
                [g(src + f"attention.self.{name}.{part}")
                 for name in ("query", "key", "value")], dim=0)
            for theirs, ours in (("attention.output.dense", "attention_output"),
                                 ("attention.output.LayerNorm", "attention_layer_norm"),
                                 ("intermediate.dense", "intermediate"),
                                 ("output.dense", "output"),
                                 ("output.LayerNorm", "output_layer_norm")):
                p[dst + f"{ours}.{part}"] = g(src + f"{theirs}.{part}")
    for name in ("img_embedding", "location_embeds"):
        if name + ".weight" in state:
            p[name + ".weight"] = g(name + ".weight")
            p[name + ".bias"] = g(name + ".bias")
    return p


def convert_pretrain_state_dict(state: dict, cfg: BertConfig, seed: int = 0) -> dict:
    """A whole PreTrainOscar checkpoint -> {PretrainModel name: tensor}
    (convert_pretrain_to_flax in the JAX package): the BERT under
    ``bert.``, and the heads the checkpoint has (mlmhead -> mlm_transform,
    mlm_layer_norm, mlm_bias resized to the vocabulary with zeros;
    next_action.linear; token_head.0; encoder.py:317-335)."""
    rng = np.random.default_rng(seed)
    bert = convert_bert_state_dict(_strip_prefix(state, "bert."), cfg, seed)
    out = {PRETRAIN_PREFIX + k: v for k, v in bert.items()}
    g = state.__getitem__
    heads = {"mlm_transform": "mlmhead.predictions.transform.dense",
             "mlm_layer_norm": "mlmhead.predictions.transform.LayerNorm",
             "next_action": "next_action.linear", "token_head": "token_head.0"}
    if "mlmhead.predictions.transform.dense.weight" in state:
        out["mlm_bias"] = resize_rows(g("mlmhead.predictions.bias"), cfg.vocab_size,
                                      rng, 0.0)
    for ours, theirs in heads.items():
        if theirs + ".weight" in state:
            out[ours + ".weight"] = g(theirs + ".weight")
            out[ours + ".bias"] = g(theirs + ".bias")
    return out


def _replace(target: dict, source: dict, prefix: str = "") -> tuple[dict, int]:
    """``target`` ({name: tensor}) with ``source[name]`` wherever ``prefix +
    name`` is in ``target``, on the target's device and dtype; shapes must
    agree.  Returns (new dict, how many were replaced)."""
    out = dict(target)
    replaced = 0
    for name, v in source.items():
        tgt = target.get(prefix + name)
        if tgt is None:
            continue
        if tuple(v.shape) != tuple(tgt.shape):
            raise ValueError(f"{prefix + name}: checkpoint shape {tuple(v.shape)} != "
                             f"model shape {tuple(tgt.shape)}")
        out[prefix + name] = v.to(device=tgt.device, dtype=tgt.dtype)
        replaced += 1
    return out, replaced


def graft_bert_into_encoder(encoder_params: dict, model_path: str, cfg: BertConfig,
                            seed: int = 0) -> dict:
    """``encoder_params`` (the OscarEncoder's {name: tensor}) with its BERT
    replaced by the torch Oscar / BERT checkpoint at ``model_path`` (the
    fine-tune initialisation, train.py:40 + agent.py:110-117); the LSTM and
    the projections keep their init."""
    state = _strip_prefix(load_torch_state_dict(model_path), "module.")
    state = _strip_prefix(state, "bert.")
    return _replace(encoder_params, convert_bert_state_dict(state, cfg, seed),
                    ENCODER_PREFIX)[0]


def load_oscar_weights(model_path: str, cfg: BertConfig, template_params: dict,
                       seed: int = 0) -> dict:
    """A ``PretrainModel``'s {name: tensor} from the torch Oscar / BERT
    checkpoint at ``model_path``, keeping ``template_params``' values for
    the heads the checkpoint lacks (fresh init backfill)."""
    state = _strip_prefix(load_torch_state_dict(model_path), "module.")  # DDP-saved
    return _replace(template_params, convert_pretrain_state_dict(state, cfg, seed))[0]


def is_pretrain_checkpoint(model_path: str) -> bool:
    """True when ``model_path`` is one of the port's pretraining outputs: a
    ``checkpoint-N`` directory holding ``params.pt``, or a run directory
    holding ``checkpoint-*`` directories, rather than a torch
    ``pytorch_model.bin`` checkpoint."""
    if not os.path.isdir(model_path):
        return False
    if os.path.exists(os.path.join(model_path, "pytorch_model.bin")):
        return False
    if os.path.isfile(os.path.join(model_path, "params.pt")):
        return True
    return any(e.startswith("checkpoint-") for e in os.listdir(model_path))


def graft_pretrain_checkpoint_into_encoder(encoder_params: dict, model_path: str) -> dict:
    """``encoder_params`` (the OscarEncoder's {name: tensor}) with its BERT
    replaced, wherever a name exists on both sides, by the pretraining
    checkpoint's; the LSTM and the projections keep their init.
    ``model_path`` names a ``.../checkpoint-N`` directory or a pretraining
    output directory (the latest completed checkpoint wins).  Each tensor
    keeps the encoder's device and dtype; shapes must agree."""
    base = os.path.basename(os.path.normpath(model_path))
    m = re.fullmatch(r"checkpoint-(\d+)", base)
    if m:
        mgr = CheckpointManager(os.path.dirname(os.path.normpath(model_path)))
        step = int(m.group(1))
    else:
        mgr = CheckpointManager(model_path)
        step = mgr.latest()
        if step is None:
            raise FileNotFoundError(
                f"no completed pretraining checkpoint under {model_path}")
    src = {k[len(PRETRAIN_PREFIX):]: v for k, v in mgr.restore_raw(step).items()
           if k.startswith(PRETRAIN_PREFIX)}
    out, replaced = _replace(encoder_params, src, ENCODER_PREFIX)
    if not replaced:
        raise ValueError(f"checkpoint at {model_path} shares no BERT "
                         "parameters with the encoder (wrong dims?)")
    return out
