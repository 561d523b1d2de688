"""attn_roofline.ndh_eval: NDH argmax evaluation: the fused attention launches'
least time over their device time, %."""

from h100bench.metrics.readers import roofline


def read(rec):
    return roofline(rec, "ndh_eval", "attn")
