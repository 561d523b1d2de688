"""kernels_per_step.ndh_train: NDH teacher-forced training: device kernels a
step, host-to-device copies left out."""

from h100bench.metrics.readers import kernels_per_step


def read(rec):
    return kernels_per_step(rec, "ndh_train")
