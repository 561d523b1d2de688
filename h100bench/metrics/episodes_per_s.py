"""episodes_per_s: Argmax evaluation episodes completed, trajectories read
back, over the window's seconds."""

from h100bench.metrics.readers import rate


def read(rec):
    return rate(rec, "episodes")
