"""elementwise_ms.pretrain: multimodal pretraining: device ms a step in other
elementwise kernels and reductions."""

from h100bench.metrics.readers import ELEMENTWISE, kind_ms


def read(rec):
    return kind_ms(rec, "pretrain", ELEMENTWISE)
