from visitron_torch.models.bert import (BertConfig, BertTextModel,
                                        VisitronBert)
from visitron_torch.models.decoder import AttnDecoderLSTM, SoftDotAttention
from visitron_torch.models.encoder import OscarEncoder
from visitron_torch.models.lstm import LSTM, lstm_cell_step, masked_lstm_scan

__all__ = [
    "BertConfig",
    "VisitronBert",
    "BertTextModel",
    "OscarEncoder",
    "SoftDotAttention",
    "AttnDecoderLSTM",
    "LSTM",
    "lstm_cell_step",
    "masked_lstm_scan",
]
