"""Initialise the dialog encoder's BERT from a pretraining checkpoint
(visitron_tpu/models/oscar_import.py: ``is_pretrain_checkpoint`` and
``graft_pretrain_checkpoint_into_encoder``).

The ablation chain pretrains (``run pretrain``), then fine-tunes from the
pretraining output (``model_name_or_path .../checkpoint-30000`` in
run_configs/ablations/*-finetune_ndh.json; reference train.py:40).  The
port reads its own pretraining checkpoints (train/checkpoint.py): the
parameters of ``PretrainModel`` as a flat state dict whose ``bert.*``
entries are the multimodal BERT; the encoder's text BERT sits under
``bert.bert.*``.

The import of published Oscar / HuggingFace ``pytorch_model.bin`` weights
(``graft_bert_into_encoder``, ``load_oscar_weights``, with the embedding
resize and backfill rules) is not ported (ROADMAP item 4): a path that is
not one of the port's pretraining checkpoints raises.
"""

from __future__ import annotations

import os
import re

from visitron_torch.train.checkpoint import CheckpointManager

PRETRAIN_PREFIX = "bert."  # PretrainModel.bert (VisitronBert)
ENCODER_PREFIX = "bert.bert."  # OscarEncoder.bert (BertTextModel).bert


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
    out = dict(encoder_params)
    replaced = 0
    for name, tgt in encoder_params.items():
        if not name.startswith(ENCODER_PREFIX):
            continue
        v = src.get(name[len(ENCODER_PREFIX):])
        if v is None:
            continue
        if tuple(v.shape) != tuple(tgt.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(v.shape)} != encoder "
                             f"shape {tuple(tgt.shape)}")
        out[name] = v.to(device=tgt.device, dtype=tgt.dtype)
        replaced += 1
    if not replaced:
        raise ValueError(f"checkpoint at {model_path} shares no BERT "
                         "parameters with the encoder (wrong dims?)")
    return out
