"""mfu.ndh_eval: NDH argmax evaluation: model FLOPs a step over its unprofiled
wall x 989 TFLOP/s, %."""

from h100bench.metrics.readers import mfu


def read(rec):
    return mfu(rec, "ndh_eval")
