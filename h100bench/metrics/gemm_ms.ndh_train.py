"""gemm_ms.ndh_train: NDH teacher-forced training: device ms a step in GEMM
kernels."""

from h100bench.metrics.readers import GEMM, kind_ms


def read(rec):
    return kind_ms(rec, "ndh_train", GEMM)
