"""setup_s: Seconds from process start to the first timed step."""

from h100bench.metrics.readers import setup_s


def read(rec):
    return setup_s(rec)
