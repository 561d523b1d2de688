"""idle_share.pretrain: multimodal pretraining: the share of a step's
unprofiled wall in which no kernel ran, %."""

from h100bench.metrics.readers import idle_share


def read(rec):
    return idle_share(rec, "pretrain")
