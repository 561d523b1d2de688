"""ImageBertForSequenceClassificationwithAction parity model
(visitron_tpu/models/classification.py).

The reference's alternative fine-tune architecture (encoder.py:73-139,
registered in MODEL_CLASS, model_utils.py:15-26): the multimodal BERT's
pooled [CLS] output scores navigation candidates directly through a SoftDot
layer (no recurrent decoder).  ``image=False`` builds it without the image
projections, as the flax module is when it is never called with region
features.
"""

from __future__ import annotations

from torch import nn

from visitron_torch.models.bert import BertConfig, VisitronBert
from visitron_torch.models.decoder import SoftDotAttention
from visitron_torch.models.layers import DropoutRng, maybe_drop


class ImageBertForActionPrediction(nn.Module):
    def __init__(self, cfg: BertConfig, candidate_dim: int = 2048, image: bool = True):
        super().__init__()
        self.cfg = cfg
        self.bert = VisitronBert(cfg, image=image)
        self.candidate_att_layer = SoftDotAttention(cfg.hidden_size, candidate_dim,
                                                    with_tilde=False)

    def forward(self, input_ids, candidate_feats, token_type_ids=None, attention_mask=None,
                img_feats=None, img_location_embeddings=None,
                rng: DropoutRng | None = None, text_only: bool = False):
        """candidate_feats: (B, K, candidate_dim) -> logits (B, K); with
        ``text_only`` (sequence, pooled) of the BERT."""
        seq, pooled = self.bert(input_ids, token_type_ids=token_type_ids,
                                attention_mask=attention_mask, img_feats=img_feats,
                                img_location_embeddings=img_location_embeddings, rng=rng)
        if text_only:
            return seq, pooled
        pooled = maybe_drop(pooled, self.cfg.hidden_dropout_prob, rng)
        _, logits = self.candidate_att_layer(pooled.float(), candidate_feats.float(),
                                             output_tilde=False, output_prob=False)
        return logits
