"""Dialog encoder: BERT over the dialog sequence, LSTM on top
(visitron_tpu/models/encoder.py; OscarEncoder parity with
tasks/viewpoint_select/agent_models.py:192-310):

  ctx (B, T, enc_hidden)    LSTM outputs, zero at pads
  h0 = tanh(Linear(h_T))    decoder initial hidden
  c0 = Linear(c_T) if enc_hidden*dirs != dec_hidden else c_T

The LSTM and the projections run in fp32 whatever the BERT dtype.  In a
training pass (``rng`` given) ctx takes dropout at ``dropout_ratio`` after
the projections, as in the flax module; BERT applies its own.
"""

from __future__ import annotations

import torch
from torch import nn

from visitron_torch.models.bert import BertConfig, BertTextModel
from visitron_torch.models.layers import Dense, DropoutRng, maybe_drop
from visitron_torch.models.lstm import LSTM


class OscarEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, hidden_size: int = 512,
                 decoder_hidden_size: int = 512, dropout_ratio: float = 0.5,
                 bidirectional: bool = False):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        self.bert = BertTextModel(cfg)
        self.lstm = LSTM(cfg.hidden_size, hidden_size, bidirectional=bidirectional)
        enc_out = hidden_size * (2 if bidirectional else 1)
        self.encoder_lstm2decoder_ht = Dense(enc_out, decoder_hidden_size)
        self.project_c = enc_out != decoder_hidden_size
        if self.project_c:
            self.encoder_lstm2decoder_ct = Dense(enc_out, decoder_hidden_size)

    def forward(self, input_ids, lengths, token_type_ids=None, attention_mask=None,
                rng: DropoutRng | None = None):
        if attention_mask is None:
            t = input_ids.shape[1]
            attention_mask = (torch.arange(t, device=input_ids.device)[None, :]
                              < lengths[:, None]).to(torch.int32)
        seq, _ = self.bert(input_ids, token_type_ids=token_type_ids,
                           attention_mask=attention_mask, rng=rng)
        ctx, (h_t, c_t) = self.lstm(seq.float(), lengths)
        decoder_init = torch.tanh(self.encoder_lstm2decoder_ht(h_t))
        if self.project_c:
            c_t = self.encoder_lstm2decoder_ct(c_t)
        return maybe_drop(ctx, self.dropout_ratio, rng), decoder_init, c_t
