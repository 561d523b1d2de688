"""Navigation decoder: SoftDot attention + the single-step LSTM decoder cell
(visitron_tpu/models/decoder.py; parity targets
tasks/viewpoint_select/agent_models.py:313-428).

The decoder's Dense layers have no computation dtype, so bf16 inputs (the
runtime's feature tables on the card) are promoted to the fp32 parameters,
as in the flax modules.  The classifier and turn-based decoders are not
ported yet.  Dropout is not applied (serving).
"""

from __future__ import annotations

import torch
from torch import nn

from visitron_torch.models.layers import Dense
from visitron_torch.models.lstm import LSTMCellParams, lstm_cell_step
from visitron_torch.ops.masking import NEG_INF


class SoftDotAttention(nn.Module):
    """``with_tilde``: the layer is called with ``output_tilde=True`` and so
    owns ``linear_out`` (flax creates it lazily on that call)."""

    def __init__(self, query_dim: int, ctx_dim: int, with_tilde: bool = True):
        super().__init__()
        self.linear_in = Dense(query_dim, ctx_dim, bias=False)
        if with_tilde:
            self.linear_out = Dense(ctx_dim + query_dim, query_dim, bias=False)

    def forward(self, h, context, mask=None, output_tilde=True, output_prob=True):
        """h: (B, Q); context: (B, S, C); mask: (B, S) True at masked slots."""
        target = self.linear_in(h)
        context = context.to(torch.promote_types(context.dtype, target.dtype))
        logit = torch.bmm(context, target[:, :, None])[:, :, 0]
        attn_in = logit
        if mask is not None:
            attn_in = attn_in.masked_fill(mask, NEG_INF)
        attn = torch.softmax(attn_in, dim=-1)
        weighted = torch.bmm(attn[:, None, :], context)[:, 0]
        # output_prob=False returns the MASKED logits (agent_models.py:338-349).
        score = attn if output_prob else attn_in
        if output_tilde:
            h_tilde = torch.tanh(self.linear_out(torch.cat([weighted, h], dim=-1)))
            return h_tilde, score
        return weighted, score


class AttnDecoderLSTM(nn.Module):
    def __init__(self, angle_feat_size: int = 4, embedding_size: int = 64,
                 hidden_size: int = 512, feature_size: int = 2048 + 4,
                 ctx_size: int = 512):
        super().__init__()
        self.embedding = Dense(angle_feat_size, embedding_size)
        self.feat_att_layer = SoftDotAttention(hidden_size, feature_size, with_tilde=False)
        self.lstm = LSTMCellParams(embedding_size + feature_size, hidden_size)
        self.attention_layer = SoftDotAttention(hidden_size, ctx_size)
        self.candidate_att_layer = SoftDotAttention(hidden_size, feature_size,
                                                    with_tilde=False)

    def forward(self, action, feature, cand_feat, prev_h1, c_0, ctx, ctx_mask=None):
        """One decode step.

        action: (B, angle_feat) previous-action angle feature
        feature: (B, 36, F) panorama; cand_feat: (B, K, F) candidates
        prev_h1: (B, H) previous h_tilde; c_0: (B, H) cell state
        ctx: (B, T, C) dialog context; ctx_mask: (B, T) True at pads
        Returns (h_1, c_1, logit (B, K), h_tilde).
        """
        a = torch.tanh(self.embedding(action))
        attn_feat, _ = self.feat_att_layer(prev_h1, feature, output_tilde=False)
        x = torch.cat([a, attn_feat], dim=-1)
        h_1, c_1 = lstm_cell_step(self.lstm(), x, prev_h1, c_0)
        h_tilde, _ = self.attention_layer(h_1, ctx, mask=ctx_mask)
        _, logit = self.candidate_att_layer(h_tilde, cand_feat, output_tilde=False,
                                            output_prob=False)
        return h_1, c_1, logit, h_tilde
