"""Multi-objective pretraining model: MLM + next-action + region-token heads
(visitron_tpu/models/pretrain.py).

PreTrainOscar parity (tasks/viewpoint_select/encoder.py:306-441):
  * MLM head: dense + exact gelu + LayerNorm (K2 without a residual), decoder
    tied to the word embeddings plus a free fp32 bias (encoder.py:322,332-335);
  * next-action: Linear([CLS] pooled) over the 36-view action space
    (encoder.py:142-158,317-319);
  * region-token head: Linear over the detector classes (encoder.py:323-326).

The JAX package's documented deviations hold here too: standard softmax CE
on the logits of the action and token heads, ignore label -1, each loss the
mean over its non-ignored entries.  With ``use_fused_mlm_ce`` (the default)
the MLM logits are cast to ``cfg.dtype`` (bf16 product + fp32 bias -> fp32
-> cast) and the MLM loss runs through the fused masked softmax-CE kernel
(K3, ops/crossentropy.py), whose per-row CE is summed and divided by the
count of labels != -1; otherwise the logits stay fp32 and the plain
``masked_cross_entropy`` runs.

The tied decoder and the region-token head run at their output widths
rounded up to a multiple of 8 (``layers.aligned_linear``, whose rule,
``layers.pad_to_8``, also pads the MLM bias: Oscar's vocabulary
of 30,525 and the detector's 1,601 classes would put their products, forward
and backward, on unaligned GEMM kernels).  The pad lives only inside the
step: the parameters keep their shapes, ``mlm_logits`` is a view of the
first vocab columns, ``token_logits`` a cast of the first classes columns,
and the MLM bias is padded with -inf, so the padded MLM buffer that K3 reads
(``mlm_logits_padded``) gives the same CE, lse and (zero-padded) dlogits as
the logits alone.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from visitron_torch.models.bert import (BertConfig, VisitronBert, _dense,
                                        _layer_norm)
from visitron_torch.models.layers import DropoutRng, aligned_linear, pad_to_8
from visitron_torch.ops.crossentropy import fused_masked_softmax_ce


def masked_cross_entropy(logits, labels, ignore_id: int = -1, count=None):
    """Mean softmax CE over labels != ignore_id (CrossEntropyLoss parity);
    returns (loss, valid mask).  ``count``: the count to divide by (the
    global batch's, under data parallelism; None: this batch's)."""
    valid = labels != ignore_id
    safe = torch.where(valid, labels, 0).long()
    ce = F.cross_entropy(logits.float().flatten(0, -2), safe.flatten(),
                         reduction="none").reshape(labels.shape)
    total = torch.sum(ce * valid)
    count = torch.clamp(torch.sum(valid) if count is None else count, min=1)
    return total / count, valid


def masked_accuracy(logits, labels, ignore_id: int = -1, count=None):
    valid = labels != ignore_id
    pred = torch.argmax(logits, dim=-1)
    correct = torch.sum((pred == labels) & valid)
    return correct / torch.clamp(torch.sum(valid) if count is None else count, min=1)


class PretrainModel(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.bert = VisitronBert(cfg)
        self.mlm_transform = _dense(cfg.hidden_size, cfg.hidden_size, cfg)
        self.mlm_layer_norm = _layer_norm(cfg, cfg.hidden_size)
        self.next_action = _dense(cfg.hidden_size, cfg.action_space, cfg)
        self.token_head = _dense(cfg.hidden_size, cfg.detector_classes, cfg)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def initial_params(self, g: torch.Generator) -> dict:
        return {"mlm_bias": torch.zeros(self.mlm_bias.shape)}

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                img_feats=None, img_location_embeddings=None,
                rng: DropoutRng | None = None, text_only: bool = False):
        seq, pooled = self.bert(input_ids, token_type_ids=token_type_ids,
                                attention_mask=attention_mask, img_feats=img_feats,
                                img_location_embeddings=img_location_embeddings,
                                rng=rng)
        if text_only:
            return seq, pooled
        return self.heads(seq, pooled)

    def heads(self, seq, pooled=None) -> dict:
        """The three pretraining heads over an encoded sequence (this rank's
        tokens under an sp or cp mesh: the MLM and token logits stay
        token-sharded, as the JAX package's constraints keep them).
        ``pooled`` None: the next-action logits are None (a rank of an sp or
        cp mesh without the [CLS] token).

        The decoder and the token head compute at their widths rounded up to
        a multiple of 8 (``aligned_linear``), so that their products and
        those of the backward run on aligned GEMMs: ``mlm_logits_padded`` is
        the contiguous (B, S, vocab8) buffer, its pad columns -inf (the
        decoder's zero columns plus the MLM bias padded with -inf), which K3
        reads whole; ``mlm_logits`` (B, S, vocab) is a view of it, and
        ``token_logits`` (B, S, classes) is cast from a view of the padded
        product, so the loss's gradient reaches the token head zero-padded."""
        cfg = self.cfg
        x = F.gelu(self.mlm_transform(seq), approximate="none")
        x = self.mlm_layer_norm(x)
        # The MLM bias padded with -inf to the decoder's width: exp(-inf - lse)
        # = 0, so the pad columns leave every softmax alone.
        logits = self.bert.attend_vocab(x).float() + pad_to_8(self.mlm_bias, -math.inf)
        if cfg.use_fused_mlm_ce:
            # The logits stay in the compute dtype for the fused CE kernel.
            logits = logits.to(cfg.dtype)
        head = self.token_head
        tokens = aligned_linear(seq.to(cfg.dtype), head.weight, head.bias)
        return {
            "sequence_output": seq,
            "pooled_output": pooled,
            "mlm_logits": logits[..., :cfg.vocab_size],
            "mlm_logits_padded": logits,
            "action_logits": None if pooled is None else self.next_action(pooled).float(),
            "token_logits": tokens[..., :cfg.detector_classes].float(),
        }


def pretrain_loss(outputs: dict, labels, next_action=None, token_labels=None,
                  cfg: BertConfig | None = None, counts: dict | None = None) -> dict:
    """Loss/metric bundle parity (encoder.py:379-441): loss, mask/next/token
    losses and word/action/token accuracies, as 0-d tensors.  ``counts``
    ({"mlm", "next", "token"}: label counts of the global batch) makes each
    value this rank's share of the global batch's, to be summed over the
    ranks (visitron_tpu/models/pretrain.py:147 divides by the global
    count); None divides by this batch's counts.  Under an sp or cp mesh
    ``labels`` and ``token_labels`` are this rank's columns of the joint
    sequence (the logits' tokens).  The fused MLM loss reads the padded
    buffer ``outputs["mlm_logits_padded"]`` (MLM labels lie in [0, vocab)
    or are -1)."""
    counts = counts or {}
    mlm_logits = outputs["mlm_logits"]
    seq_len = mlm_logits.shape[1]
    mlm_labels = labels[:, :seq_len]
    if cfg is not None and cfg.use_fused_mlm_ce:
        flat = mlm_labels.reshape(-1)
        padded = outputs["mlm_logits_padded"]
        ce = fused_masked_softmax_ce(padded.reshape(-1, padded.shape[-1]), flat)
        n = counts.get("mlm")
        mask_loss = ce.sum() / torch.clamp(torch.sum(flat != -1) if n is None else n,
                                           min=1)
    else:
        mask_loss, _ = masked_cross_entropy(mlm_logits, mlm_labels, count=counts.get("mlm"))
    loss = mask_loss
    out = {"mask_loss": mask_loss,
           "words_accuracy": masked_accuracy(mlm_logits, mlm_labels,
                                             count=counts.get("mlm"))}
    if next_action is not None and outputs["action_logits"] is None:
        # A rank without the [CLS] token: its share of the next-action terms
        # is nothing (the rank that holds it counts the rows once).
        zero = torch.zeros((), device=mask_loss.device)
        out["next_loss"], out["action_accuracy"] = zero, zero
    elif next_action is not None:
        next_loss, _ = masked_cross_entropy(outputs["action_logits"], next_action,
                                            count=counts.get("next"))
        loss = loss + next_loss
        out["next_loss"] = next_loss
        out["action_accuracy"] = masked_accuracy(outputs["action_logits"], next_action,
                                                 count=counts.get("next"))
    if token_labels is not None:
        tok = token_labels[:, :seq_len]
        token_loss, _ = masked_cross_entropy(outputs["token_logits"], tok,
                                             count=counts.get("token"))
        loss = loss + token_loss
        out["token_loss"] = token_loss
        out["token_accuracy"] = masked_accuracy(outputs["token_logits"], tok,
                                                count=counts.get("token"))
    out["loss"] = loss
    return out
