from visitron_torch.ops.attention import (attention_supports_flash,
                                          attention_supports_fused, fused_attention,
                                          fused_attention_bwd,
                                          fused_attention_bwd_reference,
                                          fused_attention_packed,
                                          fused_attention_packed_bwd,
                                          fused_attention_packed_bwd_reference,
                                          fused_attention_packed_reference,
                                          fused_attention_reference,
                                          multi_head_attention)
from visitron_torch.ops.crossentropy import (fused_masked_softmax_ce,
                                             fused_masked_softmax_ce_bwd,
                                             masked_softmax_ce_bwd_reference,
                                             masked_softmax_ce_reference)
from visitron_torch.ops.layernorm import (fused_add_layernorm, fused_add_layernorm_bwd,
                                          layernorm_bwd_reference, layernorm_reference)
from visitron_torch.ops.masking import NEG_INF, length2mask, make_attention_bias

__all__ = ["attention_supports_flash", "attention_supports_fused", "fused_attention",
           "fused_attention_bwd", "fused_attention_bwd_reference",
           "fused_attention_packed", "fused_attention_packed_bwd",
           "fused_attention_packed_bwd_reference", "fused_attention_packed_reference",
           "fused_attention_reference", "multi_head_attention",
           "fused_masked_softmax_ce", "fused_masked_softmax_ce_bwd",
           "masked_softmax_ce_bwd_reference", "masked_softmax_ce_reference",
           "fused_add_layernorm", "fused_add_layernorm_bwd",
           "layernorm_bwd_reference", "layernorm_reference", "NEG_INF", "length2mask",
           "make_attention_bias"]
