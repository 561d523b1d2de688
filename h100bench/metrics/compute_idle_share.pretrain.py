"""compute_idle_share.pretrain: multimodal pretraining: the share of a step's
device idle that lies inside the program's forward, backward and optimizer
spans (``vt.forward``, ``vt.backward``, ``vt.optimizer``, taken as one
union), the median step's (h100bench/spans.py), %."""

from h100bench.spans import idle_share


def read(rec):
    return idle_share(rec, "pretrain", ("vt.forward", "vt.backward", "vt.optimizer"))
