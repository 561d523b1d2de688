"""elementwise_ms.ndh_train: NDH teacher-forced training: device ms a step in
other elementwise kernels and reductions."""

from h100bench.metrics.readers import ELEMENTWISE, kind_ms


def read(rec):
    return kind_ms(rec, "ndh_train", ELEMENTWISE)
