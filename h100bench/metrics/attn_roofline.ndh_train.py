"""attn_roofline.ndh_train: NDH teacher-forced training: the fused attention
launches' least time over their device time, %."""

from h100bench.metrics.readers import roofline


def read(rec):
    return roofline(rec, "ndh_train", "attn")
