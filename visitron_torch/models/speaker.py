"""Speaker encoder and decoder, and the value head of RL fine-tuning
(visitron_tpu/models/speaker.py; the reference's present-but-unwired
modules, agent_models.py:512-643).

  * ``SpeakerEncoder``: an LSTM over the trajectory's action features, a
    SoftDot attention of each step over its 36-view panorama, and a second
    LSTM over the attended steps;
  * ``SpeakerDecoder``: word embedding, an LSTM cell run over the words, a
    SoftDot attention of each word's state over the encoded trajectory, and
    the vocabulary projection;
  * ``Critic``: a decoder state to a value estimate.

The decoder takes the input projection of all L words in one product before
its per-word loop, and its attention reads the (B, T, C) trajectory context
once for the L queries of an item (the flax module repeats the context L
times); both are the same math.  In a training pass (``rng`` given) the
dropouts at ``dropout_ratio`` apply as in the flax modules: three in the
encoder (after the first LSTM, after the attention, after the second LSTM)
and three in the decoder (on the embeddings, on the LSTM states, on the
attended states).

Parameters come from the blocks' ``initial_params`` through
``layers.init_module_params``, as for the other modules.
"""

from __future__ import annotations

import torch
from torch import nn

from visitron_torch.models.decoder import SoftDotAttention
from visitron_torch.models.layers import Dense, DropoutRng, Embed, maybe_drop
from visitron_torch.models.lstm import LSTM, LSTMCellParams
from visitron_torch.ops.masking import NEG_INF


class SpeakerEncoder(nn.Module):
    def __init__(self, feature_size: int, hidden_size: int, dropout_ratio: float = 0.5):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        self.lstm = LSTM(feature_size, hidden_size)
        self.attention_layer = SoftDotAttention(hidden_size, feature_size)
        self.post_lstm = LSTM(hidden_size, hidden_size)

    def forward(self, action_embeds, feature, lengths, rng: DropoutRng | None = None):
        """action_embeds: (B, T, F); feature: (B, T, 36, F); lengths: (B,)
        -> ctx (B, T, H), zero at the steps past each length."""
        p = self.dropout_ratio
        ctx, _ = self.lstm(action_embeds, lengths)
        ctx = maybe_drop(ctx, p, rng)
        b, t, h = ctx.shape
        x, _ = self.attention_layer(ctx.reshape(b * t, h),
                                    feature.reshape(b * t, feature.shape[2], feature.shape[3]))
        x = maybe_drop(x.reshape(b, t, h), p, rng)
        x, _ = self.post_lstm(x, lengths)
        return maybe_drop(x, p, rng)


class SpeakerDecoder(nn.Module):
    def __init__(self, vocab_size: int, embedding_size: int, hidden_size: int,
                 dropout_ratio: float = 0.5):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        # flax nn.Embed's default init: normal with variance 1 / features.
        self.embedding = Embed(vocab_size, embedding_size, init_std=embedding_size ** -0.5)
        self.lstm = LSTMCellParams(embedding_size, hidden_size)
        # The context is the encoder's output, of the same hidden size.
        self.attention_layer = SoftDotAttention(hidden_size, hidden_size)
        self.projection = Dense(hidden_size, vocab_size)

    def forward(self, words, ctx, ctx_mask, h0, c0, rng: DropoutRng | None = None):
        """words: (B, L) ids; ctx: (B, T, C); ctx_mask: (B, T) True at the
        padded steps; h0, c0: (B, H) -> (logits (B, L, V), h1, c1)."""
        p = self.dropout_ratio
        emb = maybe_drop(self.embedding(words), p, rng)
        cell = self.lstm()
        steps_x = (emb @ cell["wi"].T + cell["bi"] + cell["bh"]).unbind(1)
        wh_t = cell["wh"].T
        h, c, hs = h0, c0, []
        for gates_x in steps_x:
            i, f, g, o = (gates_x + h @ wh_t).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        x = maybe_drop(torch.stack(hs, dim=1), p, rng)
        x = maybe_drop(self._attend(x, ctx, ctx_mask), p, rng)
        return self.projection(x), h, c

    def _attend(self, x, ctx, ctx_mask):
        """SoftDot attention of every word state x (B, L, H) over its item's
        context (B, T, C): ``attention_layer`` with the L queries of an item
        in one product against the context, which is not repeated."""
        att = self.attention_layer
        target = att.linear_in(x)  # (B, L, C)
        logit = torch.bmm(target, ctx.transpose(1, 2))  # (B, L, T)
        logit = logit.masked_fill(ctx_mask[:, None, :], NEG_INF)
        weighted = torch.bmm(torch.softmax(logit, dim=-1), ctx)  # (B, L, C)
        return torch.tanh(att.linear_out(torch.cat([weighted, x], dim=-1)))


class Critic(nn.Module):
    def __init__(self, hidden_size: int = 512, dropout_ratio: float = 0.5):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        self.dense_0 = Dense(hidden_size, hidden_size)
        self.dense_1 = Dense(hidden_size, 1)

    def forward(self, state: torch.Tensor, rng: DropoutRng | None = None) -> torch.Tensor:
        """state: (B, hidden) -> value (B,).  ``rng`` turns the dropout on."""
        x = torch.relu(self.dense_0(state))
        x = maybe_drop(x, self.dropout_ratio, rng)
        return self.dense_1(x)[..., 0]
