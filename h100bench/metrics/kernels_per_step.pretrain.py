"""kernels_per_step.pretrain: multimodal pretraining: device kernels a step,
host-to-device copies left out."""

from h100bench.metrics.readers import kernels_per_step


def read(rec):
    return kernels_per_step(rec, "pretrain")
