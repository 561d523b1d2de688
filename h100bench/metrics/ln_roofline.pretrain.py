"""ln_roofline.pretrain: multimodal pretraining: the add+LayerNorm launches'
least time over their device time, %."""

from h100bench.metrics.readers import roofline


def read(rec):
    return roofline(rec, "pretrain", "ln")
