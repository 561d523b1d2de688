"""attn_roofline.pretrain: multimodal pretraining: the fused attention
launches' least time over their device time, %."""

from h100bench.metrics.readers import roofline


def read(rec):
    return roofline(rec, "pretrain", "attn")
