"""busy_ms.ndh_train: NDH teacher-forced training: device busy a step (the
union of kernel intervals under the profiler), ms: the step's device time
without the host's share."""

from h100bench.metrics.readers import busy_ms


def read(rec):
    return busy_ms(rec, "ndh_train")
