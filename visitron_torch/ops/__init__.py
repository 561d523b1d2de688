from visitron_torch.ops.attention import (fused_attention_packed,
                                          fused_attention_packed_reference,
                                          multi_head_attention)
from visitron_torch.ops.layernorm import fused_add_layernorm, layernorm_reference
from visitron_torch.ops.masking import NEG_INF, length2mask, make_attention_bias

__all__ = ["fused_attention_packed", "fused_attention_packed_reference",
           "multi_head_attention", "fused_add_layernorm", "layernorm_reference",
           "NEG_INF", "length2mask", "make_attention_bias"]
