"""optimizer_ms.pretrain: multimodal pretraining: device ms a step in the
optimizer's foreach kernels."""

from h100bench.metrics.readers import OPTIMIZER, kind_ms


def read(rec):
    return kind_ms(rec, "pretrain", OPTIMIZER)
