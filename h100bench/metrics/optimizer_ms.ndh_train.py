"""optimizer_ms.ndh_train: NDH teacher-forced training: device ms a step in the
optimizer's foreach kernels."""

from h100bench.metrics.readers import OPTIMIZER, kind_ms


def read(rec):
    return kind_ms(rec, "ndh_train", OPTIMIZER)
