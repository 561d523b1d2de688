"""pretrain_tokens_per_s: Completed (batch x S) pretraining tokens over the
window's seconds."""

from h100bench.metrics.readers import rate


def read(rec):
    return rate(rec, "tokens")
