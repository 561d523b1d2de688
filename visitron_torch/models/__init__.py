from visitron_torch.models.bert import (BertConfig, BertTextModel,
                                        VisitronBert, config_for_mesh)
from visitron_torch.models.classification import ImageBertForActionPrediction
from visitron_torch.models.decoder import (AttnDecoderLSTM, AttnDecoderLSTMwithClassifier,
                                           SoftDotAttention, TurnBasedDecoderLSTM)
from visitron_torch.models.encoder import OscarEncoder
from visitron_torch.models.lstm import LSTM, lstm_cell_step, masked_lstm_scan
from visitron_torch.models.pretrain import (PretrainModel, masked_accuracy,
                                            masked_cross_entropy, pretrain_loss)
from visitron_torch.models.speaker import Critic, SpeakerDecoder, SpeakerEncoder

__all__ = [
    "BertConfig",
    "config_for_mesh",
    "VisitronBert",
    "BertTextModel",
    "OscarEncoder",
    "SoftDotAttention",
    "AttnDecoderLSTM",
    "AttnDecoderLSTMwithClassifier",
    "TurnBasedDecoderLSTM",
    "ImageBertForActionPrediction",
    "LSTM",
    "lstm_cell_step",
    "masked_lstm_scan",
    "PretrainModel",
    "masked_cross_entropy",
    "masked_accuracy",
    "pretrain_loss",
    "Critic",
    "SpeakerEncoder",
    "SpeakerDecoder",
]
