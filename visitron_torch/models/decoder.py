"""Navigation decoders: SoftDot attention + single-step LSTM decoder cells
(visitron_tpu/models/decoder.py; parity targets
tasks/viewpoint_select/agent_models.py:313-509 and
tasks/turn_based/agent_models.py:277-319):

  * ``AttnDecoderLSTM``: angle-embed the previous action, attend the 36-view
    panorama, LSTM cell, attend the dialog context, SoftDot candidate
    logits;
  * ``AttnDecoderLSTMwithClassifier``: the same with a two-layer
    question-asking head on h_tilde;
  * ``TurnBasedDecoderLSTM``: an 8-id action embedding, a single-view
    feature, LSTM cell, dialog attention, 6-way action logits.

The decoders' Dense layers have no computation dtype, so bf16 inputs (the
runtime's feature tables on the card) are promoted to the fp32 parameters,
as in the flax modules.  In a training pass (``rng`` given) the dropouts at
``dropout_ratio`` apply as in the flax modules.  AttnDecoderLSTM has four:
on the action embedding, on the previous h_tilde fed to the panorama
attention (the LSTM cell still gets it undropped), on h_1 fed to the dialog
attention and on h_tilde fed to the candidate scorer and the question head
(the returned h_tilde is undropped).  TurnBasedDecoderLSTM has two: on the
LSTM input and on h_1 fed to the dialog attention.
"""

from __future__ import annotations

import torch
from torch import nn

from visitron_torch.models.layers import Dense, DropoutRng, Embed, maybe_drop
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
                 ctx_size: int = 512, dropout_ratio: float = 0.5):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        self.embedding = Dense(angle_feat_size, embedding_size)
        self.feat_att_layer = SoftDotAttention(hidden_size, feature_size, with_tilde=False)
        self.lstm = LSTMCellParams(embedding_size + feature_size, hidden_size)
        self.attention_layer = SoftDotAttention(hidden_size, ctx_size)
        self.candidate_att_layer = SoftDotAttention(hidden_size, feature_size,
                                                    with_tilde=False)

    def recurrent(self, action, feature, prev_h1, c_0, ctx, ctx_mask=None,
                  rng: DropoutRng | None = None):
        """The step up to the dialog attention: (h_1, c_1, h_tilde, h_tilde
        as the heads read it, dropped out in a training pass)."""
        p = self.dropout_ratio
        a = maybe_drop(torch.tanh(self.embedding(action)), p, rng)
        attn_feat, _ = self.feat_att_layer(maybe_drop(prev_h1, p, rng), feature,
                                           output_tilde=False)
        x = torch.cat([a, attn_feat], dim=-1)
        h_1, c_1 = lstm_cell_step(self.lstm(), x, prev_h1, c_0)
        h_tilde, _ = self.attention_layer(maybe_drop(h_1, p, rng), ctx, mask=ctx_mask)
        return h_1, c_1, h_tilde, maybe_drop(h_tilde, p, rng)

    def forward(self, action, feature, cand_feat, prev_h1, c_0, ctx, ctx_mask=None,
                rng: DropoutRng | None = None):
        """One decode step.

        action: (B, angle_feat) previous-action angle feature
        feature: (B, 36, F) panorama; cand_feat: (B, K, F) candidates
        prev_h1: (B, H) previous h_tilde; c_0: (B, H) cell state
        ctx: (B, T, C) dialog context; ctx_mask: (B, T) True at pads
        Returns (h_1, c_1, logit (B, K), h_tilde).
        """
        h_1, c_1, h_tilde, heads_in = self.recurrent(action, feature, prev_h1, c_0, ctx,
                                                     ctx_mask, rng)
        _, logit = self.candidate_att_layer(heads_in, cand_feat, output_tilde=False,
                                            output_prob=False)
        return h_1, c_1, logit, h_tilde


class AttnDecoderLSTMwithClassifier(AttnDecoderLSTM):
    """AttnDecoderLSTM plus the question-asking head
    (classifier/agent_models.py:431-509): Dense(H, H/2), tanh, Dense(H/2, 1)
    on the dropped-out h_tilde that the candidate scorer reads."""

    def __init__(self, angle_feat_size: int = 4, embedding_size: int = 64,
                 hidden_size: int = 512, feature_size: int = 2048 + 4,
                 ctx_size: int = 512, dropout_ratio: float = 0.5):
        super().__init__(angle_feat_size, embedding_size, hidden_size, feature_size,
                         ctx_size, dropout_ratio)
        self.question_linear_0 = Dense(hidden_size, hidden_size // 2)
        self.question_linear_1 = Dense(hidden_size // 2, 1)

    def forward(self, action, feature, cand_feat, prev_h1, c_0, ctx, ctx_mask=None,
                rng: DropoutRng | None = None):
        """Returns (h_1, c_1, nav_logit (B, K), qa_logit (B, 1), h_tilde)."""
        h_1, c_1, h_tilde, heads_in = self.recurrent(action, feature, prev_h1, c_0, ctx,
                                                     ctx_mask, rng)
        qa_logit = self.question_linear_1(torch.tanh(self.question_linear_0(heads_in)))
        _, nav_logit = self.candidate_att_layer(heads_in, cand_feat, output_tilde=False,
                                                output_prob=False)
        return h_1, c_1, nav_logit, qa_logit, h_tilde


class TurnBasedDecoderLSTM(nn.Module):
    """Low-level 6-action decoder (turn_based/agent_models.py:277-319)."""

    def __init__(self, input_action_size: int = 8, output_action_size: int = 6,
                 embedding_size: int = 32, hidden_size: int = 512,
                 feature_size: int = 2048, ctx_size: int = 512,
                 dropout_ratio: float = 0.5):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        # flax nn.Embed's default init: normal with variance 1 / features.
        self.embedding = Embed(input_action_size, embedding_size,
                               init_std=embedding_size ** -0.5)
        self.lstm = LSTMCellParams(embedding_size + feature_size, hidden_size)
        self.attention_layer = SoftDotAttention(hidden_size, ctx_size)
        self.decoder2action = Dense(hidden_size, output_action_size)

    def forward(self, action, feature, h_0, c_0, ctx, ctx_mask=None,
                rng: DropoutRng | None = None):
        """action: (B,) int ids; feature: (B, F) single view; h_0, c_0:
        (B, H); ctx: (B, T, C); ctx_mask: (B, T) True at pads.
        Returns (h_1, c_1, alpha (B, T), logit (B, 6))."""
        p = self.dropout_ratio
        a = self.embedding(action)
        x = maybe_drop(torch.cat([a, feature.to(a.dtype)], dim=-1), p, rng)
        h_1, c_1 = lstm_cell_step(self.lstm(), x, h_0, c_0)
        h_tilde, alpha = self.attention_layer(maybe_drop(h_1, p, rng), ctx, mask=ctx_mask)
        return h_1, c_1, alpha, self.decoder2action(h_tilde)
