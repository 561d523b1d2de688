"""kernels_per_step.ndh_eval: NDH argmax evaluation: device kernels a step,
host-to-device copies left out."""

from h100bench.metrics.readers import kernels_per_step


def read(rec):
    return kernels_per_step(rec, "ndh_eval")
