"""gemm_ms.ndh_eval: NDH argmax evaluation: device ms a step in GEMM kernels."""

from h100bench.metrics.readers import GEMM, kind_ms


def read(rec):
    return kind_ms(rec, "ndh_eval", GEMM)
