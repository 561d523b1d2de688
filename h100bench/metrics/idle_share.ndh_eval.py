"""idle_share.ndh_eval: NDH argmax evaluation: the share of a step's unprofiled
wall in which no kernel ran, %."""

from h100bench.metrics.readers import idle_share


def read(rec):
    return idle_share(rec, "ndh_eval")
