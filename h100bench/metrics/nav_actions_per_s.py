"""nav_actions_per_s: Completed (batch x T) decoder actions of NDH training
over the window's seconds."""

from h100bench.metrics.readers import rate


def read(rec):
    return rate(rec, "actions")
