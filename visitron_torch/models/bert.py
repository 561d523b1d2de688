"""Oscar-style BERT text encoder in PyTorch (visitron_tpu/models/bert.py).

Same structure and parameter names as the flax modules, so a converted
checkpoint (visitron_torch/convert.py) loads one to one:

  * one fused QKV projection per layer; q, k and v are strided views of its
    (B, S, 3*H) output and go straight into the packed attention kernel (K1,
    ops/attention.py) with no split or transpose copies;
  * every LayerNorm is the fused add+LayerNorm kernel (K2,
    ops/layernorm.py): the embedding LayerNorm without a residual, two
    residual LayerNorms per layer;
  * activations in ``BertConfig.dtype`` (bf16 on the card), parameters in
    fp32: each Dense casts its input and its fp32 parameters to that dtype
    (flax ``Dense(dtype=...)``), explicitly rather than through autocast;
  * exact (erf) gelu.

There is no backend gate: the kernels' wrappers run the CUDA kernels for
tensors on the card and their plain twins for tensors on the CPU.  Only the
text path of ``VisitronBert`` is ported; history states and image-region
fusion raise ``NotImplementedError``.  Dropout is not applied: this is the
serving (eval-mode) model.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from visitron_torch.models.layers import Dense, Embed
from visitron_torch.ops.attention import fused_attention_packed
from visitron_torch.ops.layernorm import fused_add_layernorm
from visitron_torch.ops.masking import make_attention_bias


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.float32  # activation dtype (bfloat16 on the card)

    def replace(self, **kw) -> "BertConfig":
        return dataclasses.replace(self, **kw)


def _dense(in_features: int, out_features: int, cfg: BertConfig) -> Dense:
    return Dense(in_features, out_features, dtype=cfg.dtype,
                 init_std=cfg.initializer_range)


def _embed(num: int, cfg: BertConfig) -> Embed:
    return Embed(num, cfg.hidden_size, dtype=cfg.dtype,
                 init_std=cfg.initializer_range)


class FusedResidualLayerNorm(nn.Module):
    """``LayerNorm(x [+ residual])`` through the K2 kernel; output in x's
    dtype (the kernel's semantics: residual added in fp32)."""

    def __init__(self, cfg: BertConfig, hidden: int):
        super().__init__()
        self.eps = cfg.layer_norm_eps
        self.weight = nn.Parameter(torch.ones(hidden))
        self.bias = nn.Parameter(torch.zeros(hidden))

    def forward(self, x, residual=None):
        return fused_add_layernorm(x, residual, self.weight, self.bias, self.eps)

    def initial_params(self, g: torch.Generator) -> dict:
        return {"weight": torch.ones(self.weight.shape),
                "bias": torch.zeros(self.bias.shape)}


class BertEmbeddings(nn.Module):
    """Position + token-type embeddings added to the (shared) word
    embeddings, then the embedding LayerNorm (no residual)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.position_embeddings = _embed(cfg.max_position_embeddings, cfg)
        self.token_type_embeddings = _embed(cfg.type_vocab_size, cfg)
        self.layer_norm = FusedResidualLayerNorm(cfg, cfg.hidden_size)

    def forward(self, word_emb, position_ids, token_type_ids):
        emb = word_emb + self.position_embeddings(position_ids)
        emb = emb + self.token_type_embeddings(token_type_ids)
        return self.layer_norm(emb)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.qkv = _dense(cfg.hidden_size, 3 * cfg.hidden_size, cfg)

    def forward(self, hidden, key_bias, history_state=None):
        if history_state is not None:
            raise NotImplementedError("history_state is not ported yet")
        qkv = self.qkv(hidden)
        q, k, v = qkv.split(self.cfg.hidden_size, dim=-1)
        return fused_attention_packed(q, k, v, key_bias,
                                      self.cfg.num_attention_heads).to(self.cfg.dtype)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.attention = BertSelfAttention(cfg)
        self.attention_output = _dense(h, h, cfg)
        self.attention_layer_norm = FusedResidualLayerNorm(cfg, h)
        self.intermediate = _dense(h, cfg.intermediate_size, cfg)
        self.output = _dense(cfg.intermediate_size, h, cfg)
        self.output_layer_norm = FusedResidualLayerNorm(cfg, h)

    def forward(self, hidden, key_bias, history_state=None):
        dt = self.cfg.dtype
        attn = self.attention_output(self.attention(hidden, key_bias, history_state))
        hidden = self.attention_layer_norm(attn, hidden).to(dt)
        inter = F.gelu(self.intermediate(hidden), approximate="none")
        out = self.output(inter)
        return self.output_layer_norm(out, hidden).to(dt)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.num_layers = cfg.num_hidden_layers
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"layer_{i}", BertLayer(cfg))

    def forward(self, hidden, key_bias, history_states=None):
        if history_states is not None:
            raise NotImplementedError("history_states are not ported yet")
        for i in range(self.num_layers):
            hidden = getattr(self, f"layer_{i}")(hidden, key_bias)
        return hidden


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = _dense(cfg.hidden_size, cfg.hidden_size, cfg)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class VisitronBert(nn.Module):
    """Text path of BertImgModelwithLocationEmbeds (encoder.py:161-303);
    returns (sequence_output, pooled_output)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = _embed(cfg.vocab_size, cfg)
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)
        self.pooler = BertPooler(cfg)

    def attend_vocab(self, x):
        raise NotImplementedError("the tied MLM decoder is not ported yet")

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None, img_feats=None, img_location_embeddings=None,
                history_states=None):
        if img_feats is not None or img_location_embeddings is not None:
            raise NotImplementedError("image-region fusion is not ported yet")
        if history_states is not None:
            raise NotImplementedError("history_states are not ported yet")
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        emb = self.embeddings(self.word_embeddings(input_ids), position_ids,
                              token_type_ids).to(self.cfg.dtype)
        key_bias = make_attention_bias(attention_mask)[:, 0, 0, :].contiguous()
        seq = self.encoder(emb, key_bias)
        return seq, self.pooler(seq)


class BertTextModel(nn.Module):
    """Text-only view of VisitronBert (used by OscarEncoder); same parameter
    structure (``bert.*``)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.bert = VisitronBert(cfg)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None):
        return self.bert(input_ids, token_type_ids=token_type_ids,
                         attention_mask=attention_mask, position_ids=position_ids)
